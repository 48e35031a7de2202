"""Placement policy: the head/tail cut and the hybrid split's lifecycle —
the JAX package's ``parallel/placement.py``.

The auto-partitioner (``placement: auto``) follows Parallax: the decision
input is the vocabulary's frequency CDF (``data/vocab.py`` cumulative
coverage: vocab ids are frequency ranks, so a prefix cut is the zipf head)
plus a wire-cost model, optionally calibrated against a measured uniform
byte count. For each aligned candidate cut ``k`` it predicts the exchange
bytes a step of a hybrid split at ``k`` and takes the argmin; ``k = 0``
(stay uniform) always competes, so a flat distribution resolves to uniform.

Cost model (a train substep, a data shard):

* uniform: the pull and the push move about the local batch's rows:
  ``U = 2 * local_slots * row_bytes``, rescaled to
  ``measured_uniform_bytes`` where given (``placement_calib_bytes``);
* hybrid(k): the tail rides the dedup collectives at a static unique
  capacity ``tail_cap(k) = align8(slack * (1 - cov(k)) * local_slots)``, so
  the tail's bytes shrink by ``tail_cap / local_slots``; the head adds one
  dense reduce of ``k`` rows (``data`` received copies for a narrow wire,
  which gathers every rank's codes).

:class:`PlacementManager` (``adopt`` / ``master_state`` / ``summary``) runs
over the trainer's ``tier_tables`` / ``tier_with_tables`` hooks, so the
loop, checkpoints and resume integrate it as they do the tiered store.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional

import numpy as np

from swiftsnails_tpu_torch.parallel.comm import row_wire_bytes

log = logging.getLogger(__name__)

PLACEMENT_MODES = ("uniform", "hybrid", "auto")


def resolve_placement(name: Optional[str]) -> str:
    name = (name or "uniform").lower()
    if name not in PLACEMENT_MODES:
        raise ValueError(f"unknown placement {name!r}; expected one of {PLACEMENT_MODES}")
    return name


def align_down(k: int, align: int) -> int:
    return (int(k) // max(align, 1)) * max(align, 1)


def cap8(n: float, lo: int = 8) -> int:
    """A slot-count estimate rounded up to a multiple of 8, at least ``lo``."""
    return max(-(-int(np.ceil(n)) // 8) * 8, lo)


def tail_cap(local_slots: int, coverage: float, slack: float = 2.0) -> int:
    """The static unique capacity of the hybrid tail's dedup collectives."""
    want = slack * max(1.0 - float(coverage), 0.0) * max(local_slots, 1)
    return min(cap8(want), cap8(local_slots, lo=8))


def candidate_cuts(capacity: int, align: int, vocab_rows: int,
                   max_head_frac: float = 0.5):
    """Aligned candidate cuts: 0 (uniform) and a power-of-two ladder of
    ``align``, up to ``max_head_frac`` of the capacity, plus the vocabulary's
    own size where it fits."""
    limit = int(capacity * max_head_frac)
    cuts = [0]
    k = max(align, 1)
    while k <= limit:
        cuts.append(k)
        k *= 2
    tip = align_down(min(vocab_rows, limit), align)
    if tip and tip not in cuts:
        cuts.append(tip)
    return sorted(set(cuts))


def choose_cut(
    counts: np.ndarray,
    capacity: int,
    *,
    align: int,
    local_slots: int,
    row_elems: int,
    data: int = 1,
    slack: float = 2.0,
    comm_dtype: str = "float32",
    measured_uniform_bytes: Optional[float] = None,
    max_head_frac: float = 0.5,
) -> Dict:
    """The head/tail cut from the frequency CDF and the cost model.

    ``counts`` must be in frequency-rank order (descending), as
    ``Vocab.from_counter`` builds them: row id = rank, so a prefix cut's
    coverage is the CDF at that rank. Returns the decision that the run
    record carries (``cut``, ``coverage``, ``predicted_exchange_bytes``,
    ``predicted_uniform_bytes``, ``measured_uniform_bytes``)."""
    counts = np.asarray(counts, dtype=np.float64)
    total = float(counts.sum()) or 1.0
    cdf = np.concatenate([[0.0], np.cumsum(counts) / total])

    def cov(k: int) -> float:
        return float(cdf[min(k, len(counts))])

    rb = row_wire_bytes(row_elems, comm_dtype)
    uniform_pred = 2.0 * max(local_slots, 1) * rb
    scale = 1.0
    if measured_uniform_bytes:
        scale = float(measured_uniform_bytes) / uniform_pred
    head_copies = 1 if comm_dtype == "float32" else max(data, 1)

    best_k, best_cost = 0, uniform_pred * scale
    for k in candidate_cuts(capacity, align, len(counts), max_head_frac):
        if k == 0:
            continue
        t_cap = tail_cap(local_slots, cov(k), slack)
        tail_bytes = uniform_pred * scale * (t_cap / max(local_slots, 1))
        cost = tail_bytes + k * rb * head_copies
        if cost < best_cost:
            best_k, best_cost = k, cost
    return {
        "cut": int(best_k),
        "coverage": cov(best_k),
        "predicted_exchange_bytes": float(best_cost),
        "predicted_uniform_bytes": float(uniform_pred * scale),
        "measured_uniform_bytes": (
            float(measured_uniform_bytes) if measured_uniform_bytes else None),
    }


class PlacementManager:
    """The hybrid split's lifecycle over the trainer's table hooks.

    ``adopt`` splits a uniform-layout state into head and tail after init or
    restore; ``master_state`` merges it back to the uniform layout, the only
    layout checkpoints, export and the caller of ``TrainLoop.run`` see
    (:func:`~swiftsnails_tpu_torch.parallel.hybrid.split_table`,
    :func:`~swiftsnails_tpu_torch.parallel.hybrid.merge_table`). Under a
    mesh of more than one model shard both are collectives: every rank
    calls them."""

    def __init__(self, trainer, mesh=None):
        self.trainer = trainer
        self.mesh = mesh if mesh is not None else getattr(trainer, "mesh", None)
        self.spec = trainer.placement_spec() or {}

    @property
    def active(self) -> bool:
        return any(sp.get("cut", 0) > 0 for sp in self.spec.values())

    def adopt(self, state):
        from swiftsnails_tpu_torch.parallel.hybrid import is_hybrid, split_table

        if not self.active:
            return state
        tables = self.trainer.tier_tables(state)
        new = {}
        for name, sp in self.spec.items():
            cut = sp.get("cut", 0)
            ts = tables.get(name)
            if ts is None or cut <= 0 or is_hybrid(ts):
                continue
            new[name] = split_table(ts, cut, self.mesh, sp.get("group", 1))
        if new:
            log.info("placement: adopted hybrid split for %s",
                     {k: self.spec[k]["cut"] for k in new})
            state = self.trainer.tier_with_tables(state, new)
        return state

    def master_state(self, state):
        from swiftsnails_tpu_torch.parallel.hybrid import is_hybrid, merge_table

        tables = self.trainer.tier_tables(state)
        new = {name: merge_table(ts, self.mesh)
               for name, ts in tables.items() if is_hybrid(ts)}
        if new:
            state = self.trainer.tier_with_tables(state, new)
        return state

    def summary(self) -> Dict:
        return dict(getattr(self.trainer, "placement_decision", None) or {})
