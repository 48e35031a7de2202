"""Per-step health guardrail: detect a poisoned update, roll it back,
recover — the JAX package's ``resilience/guardrail.py``.

A NaN'd gradient in the reference walked straight into the sparse table,
and every later pull served it to every worker. Here the TrainLoop
snapshots the state before the step, checks the step's outcome, and on a
trip restores the snapshot, so **no non-finite value ever reaches the
tables**.

Semantics (the JAX package's, ``docs/RESILIENCE.md``):

* **trip conditions** — non-finite loss, non-finite update (NaN/Inf
  anywhere in the new state's float tensors shows up as a non-finite update
  norm), or an update-norm spike above ``guard_max_update_norm`` (0
  disables the spike check; non-finiteness is always checked);
* **on trip** — roll back to the pre-step snapshot, skip the batch, halve
  the *trust factor*;
* **trust factor** — after a trip, later clean updates are applied scaled
  (``snap + trust * (new - snap)`` in float32, cast back to the tensor's
  dtype) and trust doubles a clean step back to 1.0;
* **give-up** — ``guard_max_consecutive`` consecutive trips raise
  :class:`GuardrailExhausted`: a persistently sick run dies loudly.

How the port differs: the JAX step runs without buffer donation, so its
input state *is* the snapshot. The port's tables are updated in place (the
row kernels, the fused kernels), so :meth:`StepGuardrail.snapshot` copies
every tensor of the state, float and integer, into buffers allocated once,
and a rollback copies them back into the new state's tensors key by key —
which holds whether a step wrote in place (tables) or returned new tensors
(the CTR dense parameters). That is one copy of the state in device memory,
as the JAX package's un-donated inputs are. The update norm and the blend
walk each tensor in chunks of rows, so no full-size float32 temporary is
made. A step costs the snapshot copy, the norm (a read of both copies) and
one host sync for its result.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterator, List, Tuple

import numpy as np
import torch

from swiftsnails_tpu_torch.utils.tree import map_tensors, tensor_items

# elements of a tensor handled at a time by the norm and the blend: at most
# 128 MiB of float32 temporaries for any table
_CHUNK_ELEMS = 1 << 25


class GuardrailExhausted(RuntimeError):
    """``guard_max_consecutive`` consecutive unhealthy steps: giving up."""


def _chunks(a: torch.Tensor, b: torch.Tensor) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """Matching chunks of rows of two tensors of one shape."""
    if a.dim() == 0 or a.shape[0] == 0:
        yield a, b
        return
    rows = max(_CHUNK_ELEMS // max(a[0].numel(), 1), 1)
    for i in range(0, a.shape[0], rows):
        yield a[i:i + rows], b[i:i + rows]


class StepGuardrail:
    """Snapshot / health-check / rollback state machine."""

    def __init__(
        self,
        max_update_norm: float = 0.0,
        max_consecutive: int = 3,
        min_trust: float = 0.05,
        recovery: float = 2.0,
    ):
        self.max_update_norm = float(max_update_norm)
        self.max_consecutive = max(int(max_consecutive), 1)
        self.min_trust = float(min_trust)
        self.recovery = float(recovery)
        self.trust = 1.0
        self.consecutive = 0
        self.trips_total = 0
        self.steps_skipped = 0
        self.last_update_norm = None
        self.last_trip_reason = None
        self._buffers: Dict[str, torch.Tensor] = {}

    # -- per-step API (driven by TrainLoop._resilient_step) -----------------

    def snapshot(self, state: Any) -> Any:
        """Copy every tensor of ``state`` into the guardrail's buffers
        (allocated at the first call, like each tensor) and return them in
        ``state``'s structure. Take it before the step, and before any
        injected fault."""
        def copy(key: str, t: torch.Tensor) -> torch.Tensor:
            buf = self._buffers.get(key)
            if buf is None or buf.shape != t.shape or buf.dtype != t.dtype \
                    or buf.device != t.device:
                buf = self._buffers[key] = torch.empty_like(
                    t, memory_format=torch.contiguous_format)
            return buf.copy_(t)

        with torch.no_grad():
            return map_tensors(state, copy)

    @staticmethod
    def _pairs(snap: Any, new_state: Any) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        a, b = tensor_items(snap), tensor_items(new_state)
        if [k for k, _ in a] != [k for k, _ in b]:
            raise ValueError("the step changed the state's structure: "
                             f"{[k for k, _ in a]} -> {[k for k, _ in b]}")
        return [(x, y) for (_, x), (_, y) in zip(a, b)]

    @staticmethod
    def _update_sq(pairs) -> float:
        """Squared norm of the update over the float tensors, in float32."""
        total = None
        for a, b in pairs:
            if not a.is_floating_point():
                continue
            for ac, bc in _chunks(a, b):
                part = torch.linalg.vector_norm(bc.float() - ac.float()).square()
                total = part if total is None else total + part
        return 0.0 if total is None else float(total)  # the host sync point

    @staticmethod
    def _blend(pairs, trust: float) -> None:
        """``new = snap + trust * (new - snap)`` in float32 over the float
        tensors, written into ``new``."""
        for a, b in pairs:
            if not a.is_floating_point():
                continue
            for ac, bc in _chunks(a, b):
                af = ac.float()
                bc.copy_(af + trust * (bc.float() - af))

    def commit(
        self, snap: Any, new_state: Any, metrics: Dict
    ) -> Tuple[Any, Dict, bool, bool]:
        """Accept or roll back one step's outcome.

        Returns ``(state, metrics, tripped, exhausted)``: ``state`` is
        ``new_state``, blended while trust is below 1 and holding the
        snapshot's values after a trip. ``exhausted`` means the
        consecutive-trip budget is spent — the caller raises
        :class:`GuardrailExhausted`.
        """
        with torch.no_grad():
            pairs = self._pairs(snap, new_state)
            norm_sq = self._update_sq(pairs)
            loss = metrics.get("loss")
            loss_f = float(loss) if loss is not None else 0.0
            if math.isfinite(norm_sq) and norm_sq >= 0:
                norm = math.sqrt(norm_sq)
            else:
                norm = float("nan")
            self.last_update_norm = norm

            reason = None
            if not math.isfinite(loss_f):
                reason = f"non-finite loss ({loss_f})"
            elif not math.isfinite(norm):
                reason = "non-finite update (NaN/Inf in the new tables)"
            elif self.max_update_norm > 0 and norm > self.max_update_norm:
                reason = (
                    f"update-norm spike ({norm:.4g} > "
                    f"guard_max_update_norm={self.max_update_norm:.4g})"
                )

            if reason is None:
                self.consecutive = 0
                if self.trust < 1.0:
                    self._blend(pairs, self.trust)
                    metrics = dict(metrics)
                    metrics["guard_trust"] = np.float32(self.trust)
                    self.trust = min(1.0, self.trust * self.recovery)
                return new_state, metrics, False, False

            # trip: roll back, skip the batch, shrink trust
            for a, b in pairs:
                b.copy_(a)
        self.last_trip_reason = reason
        self.consecutive += 1
        self.trips_total += 1
        self.steps_skipped += 1
        self.trust = max(self.trust * 0.5, self.min_trust)
        exhausted = self.consecutive >= self.max_consecutive
        trip_metrics = {
            "guard_tripped": np.float32(1.0),
            "guard_trust": np.float32(self.trust),
            "guard_consecutive": np.float32(self.consecutive),
        }
        # keep any finite metrics for the window log; drop the poisoned ones
        for k, v in metrics.items():
            try:
                fv = float(v)
            except (TypeError, ValueError):
                continue
            if math.isfinite(fv):
                trip_metrics.setdefault(k, v)
        return new_state, trip_metrics, True, exhausted

    def summary(self) -> Dict:
        """Run-level accounting."""
        return {
            "trips_total": self.trips_total,
            "steps_skipped": self.steps_skipped,
            "trust": round(self.trust, 6),
            "last_update_norm": (
                round(self.last_update_norm, 6)
                if isinstance(self.last_update_norm, float)
                and math.isfinite(self.last_update_norm)
                else None
            ),
            "last_trip_reason": self.last_trip_reason,
            "max_update_norm": self.max_update_norm or None,
            "max_consecutive": self.max_consecutive,
        }
