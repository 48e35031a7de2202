"""The cluster supervisor: the reference Master role, reproduced — the JAX
package's ``cluster/supervisor.py``, kept as the port's own copy. The
cluster worker (``worker.py``), the loop's ``cluster_workers`` and the
simulated fleet (``sim.py``) run on it, and ``net/fleet.py`` runs its
replica liveness on its leases.

Owns three concerns, each auditable from the run ledger (``membership``
events, rendered by ``ledger-report --failures``):

* **lease-based membership** — a worker's registration is a lease against a
  monotonic deadline (the same injectable-clock idiom as
  :class:`~swiftsnails_tpu_torch.resilience.retry.RetryPolicy`, so fake-clock
  tests drill expiry without sleeping). A heartbeat renews the lease; an
  expired lease declares the worker lost (typed :class:`WorkerLost` for the
  stale worker that heartbeats after the verdict — the partitioned-worker
  case) and hands its stream range to the survivors.
* **straggler mitigation** — per-worker step-latency EWMA vs the fleet
  median. A flagged straggler gets its data share shrunk (smaller grants)
  and, with ``backup_substeps > 0``, its next pending batches duplicated to
  the fastest worker as a *backup* lease; the
  :class:`~swiftsnails_tpu_torch.cluster.accounting.BatchAccountant`'s
  first-writer-wins claim keeps the duplicate from double-applying.
* **elastic data-shard reassignment** — batch spans are granted as range
  leases from a single global frontier; a dead worker's uncommitted
  remainder is re-leased to the least-loaded survivor, and a joiner pulls
  from the reassignment pool before the frontier. ``cursor()`` /
  ``restore()`` ride the checkpoint data-cursor machinery so
  ``resume: auto`` restores the committed watermarks bit-exactly.

Config keys: ``cluster_workers``, ``lease_ms``, ``heartbeat_ms``,
``straggler_ewma``, ``backup_substeps`` (see docs/CONFIG_KEYS.md).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from swiftsnails_tpu_torch.cluster.accounting import (
    BatchAccountant, RangeLease, compress_ranges, expand_ranges,
)

# a straggler is this many times slower than the fleet median EWMA
STRAGGLER_FACTOR = 2.0
# default data-share multiplier applied to a flagged straggler's grants
STRAGGLER_SHARE = 0.5


class WorkerLost(RuntimeError):
    """Raised at a worker whose membership lease has expired — the stale
    side of a partition heartbeating after the supervisor's verdict."""

    def __init__(self, worker: str, detail: str = ""):
        self.worker = worker
        super().__init__(
            f"worker {worker!r} lost its membership lease"
            + (f": {detail}" if detail else "")
        )


@dataclass
class _Member:
    worker: str
    deadline: float                      # monotonic lease expiry
    joined_at: float
    share: float = 1.0                   # grant-size multiplier
    ewma_ms: Optional[float] = None
    steps: int = 0
    straggler: bool = False
    lost: bool = False
    adoption: List[RangeLease] = field(default_factory=list)


class Supervisor:
    """Lease-based membership + straggler policy + elastic range leasing."""

    def __init__(
        self,
        total_batches: Optional[int] = None,
        lease_ms: float = 15000.0,
        heartbeat_ms: Optional[float] = None,
        straggler_ewma: float = 0.3,
        straggler_factor: float = STRAGGLER_FACTOR,
        backup_substeps: int = 0,
        grant_batches: int = 8,
        ledger=None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.total = None if total_batches is None else int(total_batches)
        self.lease_ms = float(lease_ms)
        self.heartbeat_ms = float(heartbeat_ms if heartbeat_ms is not None
                                  else lease_ms / 3.0)
        self.alpha = float(straggler_ewma)
        self.factor = float(straggler_factor)
        self.backup_substeps = int(backup_substeps)
        self.grant_batches = max(1, int(grant_batches))
        self.ledger = ledger
        self.clock = clock
        self.accountant = BatchAccountant()
        self._members: Dict[str, _Member] = {}
        self._frontier = 0                    # next never-leased batch index
        self._free: List[List[int]] = []      # reassignable [lo, hi) spans
        self.reassignments = 0
        self.stragglers_flagged = 0
        self.workers_lost = 0

    @classmethod
    def from_config(cls, cfg, total_batches: Optional[int] = None,
                    ledger=None, clock: Callable[[], float] = time.monotonic):
        return cls(
            total_batches=total_batches,
            lease_ms=cfg.get_float("lease_ms", 15000.0),
            heartbeat_ms=(cfg.get_float("heartbeat_ms", 0.0) or None),
            straggler_ewma=cfg.get_float("straggler_ewma", 0.3),
            backup_substeps=cfg.get_int("backup_substeps", 0),
            grant_batches=cfg.get_int("cluster_grant_batches", 8),
            ledger=ledger,
            clock=clock,
        )

    # -- ledger -------------------------------------------------------------

    def _event(self, action: str, worker: str, **extra) -> None:
        if self.ledger is None:
            return
        try:
            self.ledger.append("membership",
                               {"action": action, "worker": worker, **extra})
        except Exception:
            pass

    # -- membership ---------------------------------------------------------

    def register(self, worker: str) -> _Member:
        now = self.clock()
        prior = self._members.get(worker)
        action = "rejoin" if prior is not None else "join"
        m = _Member(worker=worker, deadline=now + self.lease_ms / 1e3,
                    joined_at=now)
        self._members[worker] = m
        self._event(action, worker, lease_ms=self.lease_ms)
        return m

    def alive(self) -> List[str]:
        return sorted(w for w, m in self._members.items() if not m.lost)

    def heartbeat(self, worker: str, step: Optional[int] = None,
                  step_ms: Optional[float] = None) -> Dict:
        """Renew ``worker``'s lease; returns directives: newly adopted
        leases (reassignment/backup), the current share, straggler flag.

        Raises :class:`WorkerLost` when the lease already expired — the
        caller must re-:meth:`register` (its uncommitted range has been
        re-leased; first-writer-wins rejects any in-flight stale commits).
        """
        self.poll()
        m = self._members.get(worker)
        if m is None or m.lost:
            raise WorkerLost(worker, "lease expired before heartbeat")
        m.deadline = self.clock() + self.lease_ms / 1e3
        if step is not None:
            m.steps = int(step)
        if step_ms is not None and step_ms >= 0:
            m.ewma_ms = (float(step_ms) if m.ewma_ms is None
                         else self.alpha * float(step_ms)
                         + (1.0 - self.alpha) * m.ewma_ms)
            self._update_straggler(m)
        adopted, m.adoption = m.adoption, []
        return {
            "adopted": adopted,
            "share": m.share,
            "straggler": m.straggler,
        }

    def poll(self) -> List[str]:
        """Sweep expired leases; returns the newly lost workers."""
        now = self.clock()
        lost = [m for m in self._members.values()
                if not m.lost and m.deadline < now]
        for m in lost:
            self._declare_lost(m, reason="lease expired "
                               f"({(now - m.deadline) * 1e3:.0f} ms ago)")
        return [m.worker for m in lost]

    def mark_dead(self, worker: str, reason: str = "killed") -> None:
        """Immediately declare ``worker`` lost (chaos ``worker_dead``)."""
        m = self._members.get(worker)
        if m is not None and not m.lost:
            self._declare_lost(m, reason=reason)

    def _declare_lost(self, m: _Member, reason: str) -> None:
        m.lost = True
        self.workers_lost += 1
        self._event("worker-lost", m.worker, reason=reason,
                    steps=m.steps, lease_ms=self.lease_ms)
        # elastic reassignment: every uncommitted index the dead worker held
        # goes back into circulation — to the least-loaded survivor now, or
        # to the free pool for the next joiner
        spans: List[List[int]] = []
        for lease in self.accountant.leases_of(m.worker):
            spans.extend(self.accountant.revoke(lease.lease_id))
        if not spans:
            return
        target = self._least_loaded(exclude=m.worker)
        if target is None:
            self._free.extend(spans)
            self._event("reassigned", m.worker, to="<pool>", ranges=spans)
            return
        for lo, hi in spans:
            lease = self.accountant.grant(target.worker, lo, hi)
            target.adoption.append(lease)
        self.reassignments += 1
        self._event("reassigned", m.worker, to=target.worker, ranges=spans)

    def _least_loaded(self, exclude: str) -> Optional[_Member]:
        best = None
        best_key = None
        for m in self._members.values():
            if m.lost or m.worker == exclude:
                continue
            outstanding = sum(
                l.hi - l.watermark for l in self.accountant.leases_of(m.worker)
            )
            key = (outstanding, m.ewma_ms or 0.0, m.worker)
            if best is None or key < best_key:
                best, best_key = m, key
        return best

    # -- straggler policy ---------------------------------------------------

    def _fleet_median(self, exclude: Optional[str] = None) -> Optional[float]:
        """Median step-latency EWMA of the live fleet. ``exclude`` drops the
        worker under test — in a small fleet its own blown-up EWMA would
        drag the median toward itself and mask the very lag being probed."""
        xs = sorted(m.ewma_ms for m in self._members.values()
                    if not m.lost and m.ewma_ms is not None
                    and m.worker != exclude)
        if not xs or (exclude is None and len(xs) < 2):
            return None
        n = len(xs)
        return xs[n // 2] if n % 2 else 0.5 * (xs[n // 2 - 1] + xs[n // 2])

    def _update_straggler(self, m: _Member) -> None:
        median = self._fleet_median(exclude=m.worker)
        if median is None or median <= 0:
            return
        if not m.straggler and m.ewma_ms > self.factor * median:
            m.straggler = True
            m.share = STRAGGLER_SHARE
            self.stragglers_flagged += 1
            self._event("straggler", m.worker, ewma_ms=round(m.ewma_ms, 3),
                        median_ms=round(median, 3), share=m.share)
            if self.backup_substeps > 0:
                self._duplicate_to_backup(m)
        elif m.straggler and m.ewma_ms <= median * max(1.0, self.factor / 2):
            m.straggler = False
            m.share = 1.0
            self._event("straggler-clear", m.worker,
                        ewma_ms=round(m.ewma_ms, 3),
                        median_ms=round(median, 3))

    def _duplicate_to_backup(self, straggler: _Member) -> None:
        """Duplicate the straggler's next pending batches to the fastest
        worker as a *backup* lease. Whichever replica commits first wins;
        the accountant discards the loser's claim."""
        fastest = None
        for m in self._members.values():
            if m.lost or m.worker == straggler.worker:
                continue
            if fastest is None or (m.ewma_ms or 0) < (fastest.ewma_ms or 0):
                fastest = m
        if fastest is None:
            return
        for lease in self.accountant.leases_of(straggler.worker):
            lo = lease.watermark
            hi = min(lease.hi, lo + self.backup_substeps)
            if hi <= lo:
                continue
            backup = self.accountant.grant(fastest.worker, lo, hi, backup=True)
            fastest.adoption.append(backup)
            self._event("backup", fastest.worker, of=straggler.worker,
                        ranges=[[lo, hi]])
            return

    # -- range leasing ------------------------------------------------------

    def next_range(self, worker: str) -> Optional[RangeLease]:
        """Grant ``worker`` its next batch span: reassignment pool first,
        then the global frontier (scaled by the worker's share)."""
        m = self._members.get(worker)
        if m is None or m.lost:
            raise WorkerLost(worker, "range request after lease expiry")
        if self._free:
            lo, hi = self._free.pop(0)
            return self.accountant.grant(worker, lo, hi)
        if self.total is not None and self._frontier >= self.total:
            return None
        size = max(1, int(round(self.grant_batches * m.share)))
        lo = self._frontier
        hi = lo + size if self.total is None else min(self.total, lo + size)
        self._frontier = hi
        return self.accountant.grant(worker, lo, hi)

    # -- checkpoint cursor ---------------------------------------------------

    def cursor(self) -> Dict:
        """The checkpoint-cursor payload: committed watermarks + frontier."""
        snap = self.accountant.snapshot()
        snap["frontier"] = self._frontier
        snap["free"] = list(self._free)
        return snap

    def restore(self, snap: Dict) -> None:
        """Elastic restore from a checkpoint cursor: committed spans come
        back verbatim; every *uncommitted* previously-leased index returns
        to the reassignment pool for the current membership to re-lease —
        the same path a worker loss takes."""
        if not snap:
            return
        self.accountant.restore(snap)
        self._frontier = int(snap.get("frontier", 0))
        committed = set(expand_ranges(snap.get("committed", [])))
        pending = [i for i in range(self._frontier) if i not in committed]
        self._free = compress_ranges(pending)
        self._event("restore", "<supervisor>", frontier=self._frontier,
                    pool=self._free, committed=len(committed))

    # -- status --------------------------------------------------------------

    def status(self) -> Dict:
        now = self.clock()
        workers = {}
        for w, m in sorted(self._members.items()):
            leases = self.accountant.leases_of(w)
            workers[w] = {
                "alive": not m.lost,
                "lease_remaining_ms": round((m.deadline - now) * 1e3, 1),
                "steps": m.steps,
                "ewma_ms": None if m.ewma_ms is None else round(m.ewma_ms, 3),
                "straggler": m.straggler,
                "share": m.share,
                "leases": len(leases),
                "outstanding": sum(l.hi - l.watermark for l in leases),
            }
        return {
            "workers": workers,
            "alive": len(self.alive()),
            "frontier": self._frontier,
            "free_pool": list(self._free),
            "total_batches": self.total,
            "committed": self.accountant.committed_count(),
            "dup_discarded": self.accountant.dup_discarded,
            "workers_lost": self.workers_lost,
            "reassignments": self.reassignments,
            "stragglers_flagged": self.stragglers_flagged,
            "lease_ms": self.lease_ms,
            "heartbeat_ms": self.heartbeat_ms,
        }
