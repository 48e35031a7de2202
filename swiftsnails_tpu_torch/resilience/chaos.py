"""Deterministic fault injection: every failure mode the resilience stack
claims to survive is drillable, on demand, reproducibly — the JAX
package's ``resilience/chaos.py``, every kind.

A :class:`ChaosPlan` is parsed from two config keys:

* ``chaos_spec`` — comma-separated ``kind@step`` / ``kind@first-last``
  entries, e.g. ``nan_grad@5-7,ckpt_corrupt@12,preempt@17``;
* ``chaos_seed`` — seeds the numpy generator that picks poisoned rows and
  corrupted byte offsets, so a drill replays bit-identically (and picks the
  rows and offsets the JAX package's does for the same seed).

Fault kinds of training, all injected from the host between kernels:

================  ==========================================================
``nan_grad``      the step's update arrives with a NaN row (post-step poison
                  of the new state's first float tensor + a NaN loss)
``inf_grad``      the same with +inf
``row_poison``    a row of the first float tensor is NaN *before* the step,
                  written into the live state after the guardrail's
                  snapshot, so a rollback restores it
``io_error``      the data stream raises :class:`TransientDataError` once
``ckpt_corrupt``  flips bytes mid-file in every payload file of the newest
                  checkpoint under ``param_backup_root``, after joining
                  the checkpoint writer
``preempt``       requests a drain at the step boundary, as SIGTERM does
``slow_step``     the host sleeps ``chaos_slow_step_ms`` before the step
``tier_bitflip``  XORs one seeded bit in a host master plane of the tiered
                  store (``table_tier: host``), bypassing its write path,
                  so only the integrity digests can catch it
================  ==========================================================

Serving kinds, consulted by the serve and fleet lanes through a
``Servant``'s ``fault_hook`` (:meth:`ChaosPlan.serve_fault`, whose "step"
is the request index) and before a live reload
(:meth:`ChaosPlan.wants_reload_corrupt`):

==================  ========================================================
``serve_io_error``  a kernel dispatch raises ``OSError`` (drives the
                    circuit breakers)
``serve_slow``      a kernel dispatch stalls past its latency budget
``reload_corrupt``  the newest checkpoint is corrupted right before a live
                    reload; the shadow-verify swap must reject it
==================  ========================================================

Cluster kinds, consulted by the simulated fleet (``cluster/sim.py``)
through :meth:`ChaosPlan.cluster_fault`, whose "step" is the cluster-wide
applied-batch tick:

================  ==========================================================
``worker_dead``   a worker stops heartbeating forever; its lease must expire
                  and its range re-lease to survivors
``worker_slow``   a worker's step time inflates while scheduled; the EWMA
                  straggler policy must flag it
``partition``     a worker computes on but cannot reach the supervisor; its
                  stale buffered commits must be refused
================  ==========================================================

Transport kinds, consulted by the net drills (``net/bench_lane.py``) through
:meth:`ChaosPlan.net_fault`, whose "step" is the storm tick:

================  ==========================================================
``proc_kill``     SIGKILL a replica process mid-load
``net_partition`` black-hole a replica's socket for a window
``net_slow``      inject RTT into every reply of a replica
================  ==========================================================

Each injection is kept in :attr:`ChaosPlan.events` and, with a ledger, is
one ``chaos`` ledger event.
"""

from __future__ import annotations

import os
import re
import time
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from swiftsnails_tpu_torch.utils.tree import tensor_items

TRAINING_KINDS = ("nan_grad", "inf_grad", "row_poison", "io_error", "ckpt_corrupt",
                  "preempt", "slow_step", "tier_bitflip")
SERVE_KINDS = ("serve_io_error", "serve_slow", "reload_corrupt")
CLUSTER_KINDS = ("worker_dead", "worker_slow", "partition")
NET_KINDS = ("proc_kill", "net_partition", "net_slow")
FAULT_KINDS = TRAINING_KINDS + SERVE_KINDS + CLUSTER_KINDS + NET_KINDS

_ENTRY_RE = re.compile(r"^(?P<kind>[a-z_]+)@(?P<first>\d+)(?:-(?P<last>\d+))?$")


class ChaosSpecError(ValueError):
    """Malformed ``chaos_spec`` value."""


class TransientDataError(OSError):
    """The injected transient data-stream failure (an OSError so the
    TrainLoop's retry path treats it exactly like a real I/O hiccup)."""


def parse_chaos_spec(spec: str) -> List[Tuple[str, int]]:
    """``"nan_grad@5-7,preempt@17"`` -> ``[("nan_grad", 5), ("nan_grad", 6),
    ("nan_grad", 7), ("preempt", 17)]``."""
    faults: List[Tuple[str, int]] = []
    for raw in spec.split(","):
        entry = raw.strip()
        if not entry:
            continue
        m = _ENTRY_RE.match(entry)
        if not m:
            raise ChaosSpecError(
                f"chaos_spec entry {entry!r} is not kind@step or kind@a-b"
            )
        kind = m.group("kind")
        if kind not in FAULT_KINDS:
            raise ChaosSpecError(
                f"unknown chaos fault {kind!r}; known: {', '.join(FAULT_KINDS)}"
            )
        first = int(m.group("first"))
        last = int(m.group("last") or first)
        if last < first:
            raise ChaosSpecError(f"chaos_spec entry {entry!r}: empty range")
        faults.extend((kind, s) for s in range(first, last + 1))
    return faults


def corrupt_checkpoint_dir(
    root: str,
    step: Optional[int] = None,
    rng: Optional[np.random.Generator] = None,
    n_bytes: int = 16,
    ledger=None,
) -> Optional[str]:
    """Flip bytes mid-file in every payload file of the newest (or given)
    ``step_*`` dir under ``root``; returns the largest such file's path.

    The files stay readable; only the manifest CRC exposes the rot (the
    case verified restore exists for). Joins the checkpoint writer first.
    Deterministic under a seeded ``rng``. With a ``ledger``, one
    ``ckpt_corrupt`` chaos event.
    """
    from swiftsnails_tpu_torch.framework.checkpoint import (
        MANIFEST_NAME, _step_dir, all_steps, wait_for_checkpoints,
    )

    wait_for_checkpoints()  # never race the writer we are about to sabotage
    steps = all_steps(root)
    if not steps:
        return None
    step = steps[-1] if step is None else step
    target_dir = _step_dir(root, step)
    candidates = []
    for dirpath, _, files in os.walk(target_dir):
        for name in files:
            if name == MANIFEST_NAME:
                continue
            p = os.path.join(dirpath, name)
            try:
                candidates.append((os.path.getsize(p), p))
            except OSError:
                continue
    if not candidates:
        return None
    _, path = max(candidates)
    rng = rng or np.random.default_rng(0)
    for fsize, fpath in candidates:
        span = max(n_bytes, fsize // 4)
        lo = fsize // 4
        hi = max(fsize - span, lo + 1)
        off = int(rng.integers(lo, hi)) if hi > lo else 0
        with open(fpath, "r+b") as f:
            f.seek(off)
            chunk = bytearray(f.read(span))
            for i in range(len(chunk)):
                chunk[i] ^= 0xFF
            f.seek(off)
            f.write(bytes(chunk))
            f.flush()
            os.fsync(f.fileno())
    if ledger is not None:
        try:
            ledger.append("chaos", {
                "fault": "ckpt_corrupt", "step": step, "path": path,
                "offset": off, "bytes": n_bytes,
            })
        except Exception:
            pass
    return path


class _ChaosStream:
    """Iterator adapter that raises the plan's ``io_error`` faults in front
    of the real batch — the batch is NOT consumed, so a retrying consumer
    loses nothing."""

    def __init__(self, inner: Iterator, plan: "ChaosPlan"):
        self._inner = inner
        self._plan = plan
        self._fetches = 0

    def __iter__(self):
        return self

    def __next__(self):
        step = self._fetches
        if self._plan._take("io_error", step):
            self._plan._log("io_error", step, {"detail": "injected stream error"})
            raise TransientDataError(
                f"chaos: injected transient data-stream error at fetch {step}"
            )
        self._fetches += 1
        return next(self._inner)


class ChaosPlan:
    """Seeded, scripted fault schedule consulted by the TrainLoop."""

    def __init__(self, faults: List[Tuple[str, int]], seed: int = 0, ledger=None,
                 slow_step_ms: float = 50.0):
        self._pending: Dict[Tuple[str, int], bool] = {
            (kind, step): True for kind, step in faults
        }
        self.seed = int(seed)
        self.rng = np.random.default_rng(self.seed)
        self.ledger = ledger
        self.slow_step_ms = float(slow_step_ms)
        self.events: List[Dict] = []

    @classmethod
    def from_config(cls, cfg, ledger=None) -> Optional["ChaosPlan"]:
        spec = cfg.get_str("chaos_spec", "")
        if not spec.strip():
            return None
        return cls(parse_chaos_spec(spec), seed=cfg.get_int("chaos_seed", 0),
                   ledger=ledger, slow_step_ms=cfg.get_float("chaos_slow_step_ms", 50.0))

    # -- bookkeeping --------------------------------------------------------

    def _take(self, kind: str, step: int) -> bool:
        """True exactly once per scheduled (kind, step)."""
        key = (kind, step)
        if self._pending.get(key):
            self._pending[key] = False
            return True
        return False

    def _log(self, kind: str, step: int, detail: Dict) -> None:
        event = {"fault": kind, "step": int(step), "seed": self.seed, **detail}
        self.events.append(event)
        if self.ledger is not None:
            try:
                self.ledger.append("chaos", event)
            except Exception:
                pass

    def pending(self) -> List[Tuple[str, int]]:
        return sorted(k for k, live in self._pending.items() if live)

    def scheduled(self, kind: str, step: int) -> bool:
        """True when ``kind`` is still pending at ``step`` (peek — does not
        consume). Lets the TrainLoop skip span bookkeeping on unaffected
        steps."""
        return bool(self._pending.get((kind, step)))

    # -- injection hooks (called by TrainLoop._resilient_step) --------------

    def wrap_stream(self, it: Iterator) -> Iterator:
        if any(kind == "io_error" for kind, _ in self._pending):
            return _ChaosStream(it, self)
        return it

    def _poison_first_table(self, state, value: float):
        """Set one whole row of the first float tensor of ``state`` to
        ``value``, in place; returns ``(state, key, row)``."""
        for key, t in tensor_items(state):
            if t.is_floating_point() and t.dim() >= 1 and t.shape[0] > 0:
                row = int(self.rng.integers(0, t.shape[0]))
                with torch.no_grad():
                    t[row] = value
                return state, key, row
        return state, None, None

    def pre_step(self, state, step: int):
        """Pre-step faults: ``row_poison`` (a corrupt pulled row)."""
        if self._take("row_poison", step):
            state, leaf, row = self._poison_first_table(state, float("nan"))
            self._log("row_poison", step, {"leaf": leaf, "row": row})
        return state

    def post_step(self, state, metrics: Dict, step: int):
        """Post-step faults: ``nan_grad`` / ``inf_grad`` (the update that
        arrives at the commit point carries non-finite values)."""
        for kind, value in (("nan_grad", float("nan")),
                            ("inf_grad", float("inf"))):
            if self._take(kind, step):
                state, leaf, row = self._poison_first_table(state, value)
                metrics = dict(metrics)
                metrics["loss"] = np.float32(value)
                self._log(kind, step, {"leaf": leaf, "row": row})
        return state, metrics

    def maybe_slow_step(self, step: int) -> float:
        """``slow_step``: sleep ``chaos_slow_step_ms`` on the host before the
        step; returns the slept milliseconds (0.0 when unscheduled)."""
        if not self._take("slow_step", step):
            return 0.0
        ms = self.slow_step_ms
        self._log("slow_step", step, {"sleep_ms": ms})
        if ms > 0:
            time.sleep(ms / 1e3)
        return ms

    def wants_preempt(self, step: int) -> Optional[str]:
        if self._take("preempt", step):
            self._log("preempt", step, {"detail": "simulated SIGTERM"})
            return f"chaos preempt@{step}"
        return None

    def maybe_corrupt_checkpoint(self, root: str, step: int) -> Optional[str]:
        if not self._take("ckpt_corrupt", step):
            return None
        if not root:
            self._log("ckpt_corrupt", step,
                      {"detail": "skipped: no param_backup_root"})
            return None
        path = corrupt_checkpoint_dir(root, rng=self.rng)
        self._log("ckpt_corrupt", step, {"path": path})
        return path

    def maybe_flip_tier(self, tier, step: int) -> Optional[str]:
        """``tier_bitflip``: XOR one seeded-random bit directly in a host
        master plane's memory — deliberately bypassing
        :meth:`HostMaster.scatter` so only the integrity digests
        (:meth:`HostMaster.verify`) can catch it. Returns the hit table."""
        if not self._take("tier_bitflip", step):
            return None
        names = sorted(tier.tables)
        if not names:
            self._log("tier_bitflip", step, {"detail": "skipped: no tier"})
            return None
        name = names[int(self.rng.integers(0, len(names)))]
        # barrier the async flush queue: a landing that read the row before
        # the flip would scatter over it and erase the injected corruption
        # before the integrity sweep ever sees it
        drain = getattr(tier, "_drain", None)
        if drain is not None:
            drain()
        # any master plane is fair game — including a quantized master's
        # scale sidebands ("<plane>/scale"), where one flipped bit corrupts
        # every element of its unit on dequant
        planes = list(tier.tables[name].master._planes())
        plane, arr = planes[int(self.rng.integers(0, len(planes)))]
        flat = arr.view(np.uint8).reshape(-1)  # aliases the live plane
        off = int(self.rng.integers(0, flat.size))
        bit = int(self.rng.integers(0, 8))
        flat[off] ^= np.uint8(1 << bit)
        self._log("tier_bitflip", step,
                  {"table": name, "plane": plane, "byte": off, "bit": bit})
        return name

    # -- serving-surface faults (consulted by the Servant's fault hook / the
    # chaos-serve lane; "step" is the request index) -------------------------

    def serve_fault(self, index: int) -> Optional[str]:
        """The scheduled serving fault for request ``index`` (at most one:
        ``serve_io_error`` outranks ``serve_slow``), or None."""
        for kind in ("serve_io_error", "serve_slow"):
            if self._take(kind, index):
                self._log(kind, index, {"surface": "serve"})
                return kind
        return None

    def wants_reload_corrupt(self, index: int) -> bool:
        """True when a ``reload_corrupt`` drill is scheduled at ``index`` —
        the caller corrupts the newest checkpoint *before* asking the live
        Servant to reload it (the shadow-verify swap must reject it)."""
        if self._take("reload_corrupt", index):
            self._log("reload_corrupt", index, {"surface": "serve"})
            return True
        return False

    # -- cluster-membership faults (consulted by the cluster simulator;
    # "step" is the cluster-wide applied-batch tick) --------------------------

    def cluster_fault(self, tick: int) -> List[str]:
        """The cluster faults scheduled at global tick ``tick``, in fire
        order. The caller picks the victim and ``_log``s the detail (the
        plan can't know worker identities)."""
        return [kind for kind in CLUSTER_KINDS if self._take(kind, tick)]

    # -- process-level transport faults (consulted by the net drills;
    # "step" is the storm tick) ----------------------------------------------

    def net_fault(self, tick: int) -> List[str]:
        """The transport faults scheduled at storm tick ``tick``, in fire
        order. The caller picks the victim replica/socket and ``_log``s the
        detail (the plan can't know process identities)."""
        return [kind for kind in NET_KINDS if self._take(kind, tick)]

    def summary(self) -> Dict:
        return {
            "seed": self.seed,
            "injected": len(self.events),
            "by_fault": {
                k: sum(1 for e in self.events if e["fault"] == k)
                for k in FAULT_KINDS
                if any(e["fault"] == k for e in self.events)
            },
            "unfired": [f"{k}@{s}" for k, s in self.pending()],
        }
