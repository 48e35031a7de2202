"""Query-only serving runtime: the read path of the parameter server — the
JAX package's ``serving/`` on the card.

Load a verified checkpoint (:func:`~swiftsnails_tpu_torch.framework.checkpoint.load_tables`)
into read-only tables on the card and serve three query kernels — row pull
(the port's ``gather_rows`` kernel where a row is whole 16-byte words),
top-k nearest-neighbor, CTR score — behind a micro-batcher with a hot-row
LRU cache and bounded-queue admission control. Availability hardening:
per-kernel circuit breakers with degraded-mode (stale-LRU) reads and typed
:class:`Unavailable` sheds. Horizontal scale: a :class:`Fleet` of replicas
sharing the loaded planes behind a consistent-hash affinity router with
bounded spill, tail-latency hedging, and elastic add/drain. Tiered tables
(``table_tier: host``): host-RAM masters behind a fixed-budget cache on the
card (:mod:`swiftsnails_tpu_torch.tiered`).

The bench lanes: ``bench_lane`` (latency SLOs), ``fleet_lane`` (max QPS at
the p99 SLO, 1 vs N, affinity, hedging, and the fleet drill) and
``chaos_lane`` (availability under injected faults). The freshness
subscriber lives in :mod:`swiftsnails_tpu_torch.freshness`. Every wire of
``comm_dtype`` is ported, and serving under a ``(data, model)`` mesh
(``mesh=`` on :func:`pull_rows`, :func:`topk_tiled`, :class:`Servant` and
:class:`Fleet`) with one leader rank and the others following it
(:mod:`~swiftsnails_tpu_torch.serving.mesh_serve`).
"""

from swiftsnails_tpu_torch.serving.breaker import CircuitBreaker, Unavailable
from swiftsnails_tpu_torch.serving.cache import HotRowCache
from swiftsnails_tpu_torch.serving.engine import (
    MicroBatcher,
    Overloaded,
    Servant,
    bucket_for,
    normalize_table,
)
from swiftsnails_tpu_torch.serving.fleet import Fleet, Replica
from swiftsnails_tpu_torch.serving.loadgen import run_open_loop
from swiftsnails_tpu_torch.serving.router import (
    EwmaQuantile,
    HashRing,
    HedgeGovernor,
    route_hash,
    spill_order,
)
from swiftsnails_tpu_torch.serving.kernels import (
    ctr_logits,
    ctr_scores,
    pull_rows,
    topk_tiled,
)

__all__ = [
    "CircuitBreaker",
    "EwmaQuantile",
    "Fleet",
    "HashRing",
    "HedgeGovernor",
    "HotRowCache",
    "MicroBatcher",
    "Overloaded",
    "Replica",
    "Servant",
    "Unavailable",
    "bucket_for",
    "ctr_logits",
    "ctr_scores",
    "normalize_table",
    "pull_rows",
    "route_hash",
    "run_open_loop",
    "spill_order",
    "topk_tiled",
]
