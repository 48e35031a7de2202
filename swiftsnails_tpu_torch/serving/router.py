"""Routing policy for the serving fleet: affinity ring, spill, hedge budget.

The JAX package's ``serving/router.py``, copied; ring points use the
port's own :mod:`swiftsnails_tpu_torch.ops.hashing`, so a ring gives every
key the owner the JAX package's ring gives it.

The reference deployment put a consistent-hash layer in front of its servant
pool so a key's pull traffic always lands on the same replica (the agent-side
``hashfrag`` routing, ``src/core/parameter/hashfrag.h:48-53``, applied here to
*replicas* instead of shards). That affinity is what makes a per-replica
hot-row LRU pay: under zipf skew, N replicas that each
see a 1/N slice of the anchor space keep their slice's head rows warm, where
random spraying makes all N caches fight over the same global head and
cold-miss the rest.

This module is the pure-policy half of the fleet (no threads, no Servants):

* :class:`HashRing` — consistent-hash ring with virtual nodes. Ring points
  use the same murmur fmix64 mixer as key->row placement
  (:mod:`swiftsnails_tpu_torch.ops.hashing`) so ownership is reproducible across
  processes and restarts; adding or removing one replica only moves the keys
  adjacent to its vnode points (elastic add/drain).
* :func:`spill_order` — bounded-load-factor spill (Mirrokni et al.'s
  "consistent hashing with bounded loads"): the owner serves a key unless its
  load exceeds ``spill x fleet-mean``, in which case the request walks the
  ring to the next under-cap node. Affinity is preserved in the common case;
  a hot replica sheds overflow instead of queueing it.
* :class:`EwmaQuantile` — EWMA-smoothed windowed quantile; tracks the
  per-kernel p95 the hedge timer arms against.
* :class:`HedgeGovernor` — caps the hedge rate at ``serve_hedge_budget_pct``
  of observed requests so hedges cannot storm a fleet that is slow because it
  is overloaded (hedging an overload makes it worse; hedging a straggler
  fixes it — the cap keeps the former bounded while allowing the latter).
"""

from __future__ import annotations

import bisect
import math
import threading
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from swiftsnails_tpu_torch.ops.hashing import murmur_fmix64_int

DEFAULT_VNODES = 64
DEFAULT_SPILL = 1.5
DEFAULT_HEDGE_BUDGET_PCT = 10.0
DEFAULT_HEDGE_P95_MS = 25.0

_GOLDEN = 0x9E3779B97F4A7C15  # vnode index mixer (Fibonacci hashing constant)
_MASK64 = (1 << 64) - 1


def _str64(s: str) -> int:
    """Fold a node/replica id into 64 bits, order-sensitively."""
    h = len(s) & _MASK64
    for ch in s.encode("utf-8"):
        h = ((h * 131) + ch) & _MASK64  # the reference's BKDR string fold
    return h


def route_hash(key) -> int:
    """Request key (row id, anchor int, or string) -> 64-bit ring position.

    Ints go straight through the murmur finalizer — the same mixer that
    places the key's row — so replica affinity and row placement share one
    hash family end to end.
    """
    if isinstance(key, str):
        return murmur_fmix64_int(_str64(key))
    return murmur_fmix64_int(int(key))


class HashRing:
    """Consistent-hash ring over replica ids with ``vnodes`` points each.

    Deterministic: two rings built from the same member set (in any insertion
    order) place every key identically — ownership tests and cross-process
    routing rely on it. Not thread-safe by itself; the Fleet mutates it under
    its own lock.
    """

    def __init__(self, vnodes: int = DEFAULT_VNODES):
        self.vnodes = max(1, int(vnodes))
        self._points: List[int] = []       # sorted ring positions
        self._owner_at: Dict[int, str] = {}  # position -> node id
        self._nodes: set = set()

    def _node_points(self, node: str) -> List[int]:
        base = _str64(node)
        return [
            murmur_fmix64_int((base + i * _GOLDEN) & _MASK64)
            for i in range(self.vnodes)
        ]

    def add(self, node: str) -> None:
        if node in self._nodes:
            return
        self._nodes.add(node)
        for p in self._node_points(node):
            # collisions across nodes are ~2^-64; keep first owner if one hits
            if p in self._owner_at:
                continue
            bisect.insort(self._points, p)
            self._owner_at[p] = node

    def remove(self, node: str) -> None:
        if node not in self._nodes:
            return
        self._nodes.discard(node)
        for p in self._node_points(node):
            if self._owner_at.get(p) == node:
                del self._owner_at[p]
                i = bisect.bisect_left(self._points, p)
                if i < len(self._points) and self._points[i] == p:
                    self._points.pop(i)

    def members(self) -> List[str]:
        return sorted(self._nodes)

    def __len__(self) -> int:
        return len(self._nodes)

    def __contains__(self, node: str) -> bool:
        return node in self._nodes

    def owner(self, key_hash: int) -> Optional[str]:
        order = self.successors(key_hash)
        return order[0] if order else None

    def successors(self, key_hash: int) -> List[str]:
        """All member nodes in ring order starting at the key's owner.

        Position 0 is the affinity owner; position 1 is "the next ring
        replica" that spill and hedging escalate to; and so on — one
        deterministic escalation order per key.
        """
        if not self._points:
            return []
        i = bisect.bisect_right(self._points, key_hash & _MASK64)
        seen: List[str] = []
        n = len(self._points)
        for j in range(n):
            node = self._owner_at[self._points[(i + j) % n]]
            if node not in seen:
                seen.append(node)
                if len(seen) == len(self._nodes):
                    break
        return seen


def spill_order(
    ordered: Sequence,
    load_of: Callable[[object], int],
    *,
    spill: float = DEFAULT_SPILL,
    active: Optional[int] = None,
) -> Tuple[List, bool, int]:
    """Bounded-load-factor spill over a ring-ordered candidate list.

    A node may carry at most ``cap = ceil(spill x (total_load + 1) / active)``
    in-flight/queued requests; the first candidate under cap leads the
    returned order (affinity owner in the common case). When every candidate
    is at cap the owner keeps the request — the fleet is uniformly loaded and
    moving the key elsewhere would only shed affinity, not queueing; the
    engine's bounded admission queue is the real backstop.

    Returns ``(reordered, spilled, cap)``.
    """
    ordered = list(ordered)
    if len(ordered) <= 1:
        return ordered, False, max(1, int(math.ceil(spill)))
    n = active if active is not None else len(ordered)
    total = sum(load_of(r) for r in ordered) + 1  # +1: the request being placed
    cap = max(1, int(math.ceil(spill * total / max(n, 1))))
    for idx, r in enumerate(ordered):
        if load_of(r) < cap:
            return ordered[idx:] + ordered[:idx], idx > 0, cap
    return ordered, False, cap


def route_annotation(
    ordered: Sequence[str],
    picked: Sequence[str],
    *,
    affinity: bool,
    last_resort: bool = False,
) -> Dict:
    """The owner-vs-spill routing decision, as flat trace-annotation facts.

    ``ordered`` is the pre-spill candidate order (ring successors or the
    least-loaded spray), ``picked`` the post-spill order actually used.
    Pure policy-to-telemetry glue: the fleet attaches the returned dict to
    the request's trace so a re-read of one anomaly trace answers "did the
    owner serve this, or did it spill — and to whom?".
    """
    owner = ordered[0] if ordered else None
    target = picked[0] if picked else None
    return {
        "route_owner": owner,
        "route_target": target,
        "route_spilled": bool(affinity and owner is not None
                              and target != owner),
        "route_affinity": bool(affinity),
        "route_last_resort": bool(last_resort),
    }


class EwmaQuantile:
    """EWMA-smoothed windowed quantile — the hedge timer's p95 estimate.

    A plain EWMA of latencies tracks the *mean*; hedging needs the tail, so
    each observation recomputes the quantile over a sliding window and folds
    it into an EWMA (``alpha``) for stability. Until ``min_samples`` have
    arrived the estimate stays at ``initial`` (the ``serve_hedge_p95_ms``
    floor) so a cold fleet doesn't hedge off two lucky samples.
    """

    def __init__(
        self,
        q: float = 0.95,
        initial: float = DEFAULT_HEDGE_P95_MS,
        alpha: float = 0.25,
        window: int = 64,
        min_samples: int = 8,
    ):
        self.q = float(q)
        self.alpha = float(alpha)
        self.min_samples = int(min_samples)
        self._win: "deque[float]" = deque(maxlen=int(window))
        self._est = float(initial)
        self._warm = False
        self._lock = threading.Lock()

    def observe(self, x: float) -> None:
        with self._lock:
            self._win.append(float(x))
            if len(self._win) < self.min_samples:
                return
            s = sorted(self._win)
            wq = s[min(int(self.q * (len(s) - 1)), len(s) - 1)]
            if not self._warm:
                self._est = wq  # first full estimate replaces the floor
                self._warm = True
            else:
                self._est = (1.0 - self.alpha) * self._est + self.alpha * wq

    @property
    def value(self) -> float:
        with self._lock:
            return self._est

    @property
    def samples(self) -> int:
        with self._lock:
            return len(self._win)


class HedgeGovernor:
    """Caps hedges at ``budget_pct`` of observed requests (0 disables).

    The check is cumulative and race-tolerant: a hedge is allowed while
    ``hedged + 1 <= budget_pct/100 x requests``, so early in a run (few
    requests observed) no hedge fires at all — a deliberate cold-start bias
    toward not amplifying load before the fleet's latency profile is known.
    """

    def __init__(self, budget_pct: float = DEFAULT_HEDGE_BUDGET_PCT):
        self.budget_pct = float(budget_pct)
        self.requests = 0
        self.hedged = 0
        self._lock = threading.Lock()

    def note_request(self) -> None:
        with self._lock:
            self.requests += 1

    def allow(self) -> bool:
        if self.budget_pct <= 0:
            return False
        with self._lock:
            return (self.hedged + 1) <= self.budget_pct / 100.0 * self.requests

    def note_hedge(self) -> None:
        with self._lock:
            self.hedged += 1

    @property
    def rate_pct(self) -> float:
        with self._lock:
            return 100.0 * self.hedged / self.requests if self.requests else 0.0

    def snapshot(self) -> Dict:
        with self._lock:
            rate = 100.0 * self.hedged / self.requests if self.requests else 0.0
            return {
                "budget_pct": self.budget_pct,
                "requests": self.requests,
                "hedged": self.hedged,
                "rate_pct": round(rate, 3),
            }
