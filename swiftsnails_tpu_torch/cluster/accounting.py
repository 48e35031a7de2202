"""Exactly-once batch accounting: range leases + committed watermarks — the
JAX package's ``cluster/accounting.py``, kept as the port's own copy.

The global training stream is an append-only sequence of batch indices
``0, 1, 2, …`` (the same index the checkpoint data-cursor machinery skips on
``resume: auto`` — batch generators are seed-deterministic, so an index IS a
batch). The :class:`BatchAccountant` owns the authoritative map from index to
fate:

* a :class:`RangeLease` grants a worker a half-open span ``[lo, hi)``;
* :meth:`try_claim` is the first-writer-wins gate — an index already
  committed (by a backup substep, a faster replica, or a previous
  incarnation restored from a checkpoint) claims ``False`` and the caller
  skips it without touching model state;
* :meth:`commit` marks an index applied and advances the lease's contiguous
  ``watermark``;
* :meth:`revoke` (worker lost) returns the *uncommitted* remainder as
  compressed ranges, ready to re-lease to survivors;
* :meth:`verify` proves the exactly-once invariant: for a stream of
  ``total`` batches, zero lost, zero double-applied.

:meth:`snapshot` / :meth:`restore` ride in the checkpoint cursor, so the
invariant survives preemption + ``resume: auto`` exactly like the
single-process data cursor already does.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


def compress_ranges(indices) -> List[List[int]]:
    """Sorted ints -> minimal half-open ``[[lo, hi), …]`` spans."""
    out: List[List[int]] = []
    for i in sorted(set(int(x) for x in indices)):
        if out and out[-1][1] == i:
            out[-1][1] = i + 1
        else:
            out.append([i, i + 1])
    return out


def expand_ranges(ranges) -> List[int]:
    out: List[int] = []
    for lo, hi in ranges or ():
        out.extend(range(int(lo), int(hi)))
    return out


@dataclass
class RangeLease:
    """A worker's grant over the half-open batch span ``[lo, hi)``."""

    lease_id: int
    worker: str
    lo: int
    hi: int
    watermark: int = field(default=-1)  # first uncommitted index >= lo
    backup: bool = False                # duplicate of a straggler's span
    revoked: bool = False

    def __post_init__(self):
        if self.watermark < 0:
            self.watermark = self.lo

    def to_dict(self) -> Dict:
        return {
            "lease_id": self.lease_id, "worker": self.worker,
            "lo": self.lo, "hi": self.hi, "watermark": self.watermark,
            "backup": self.backup, "revoked": self.revoked,
        }


class BatchAccountant:
    """Authoritative exactly-once ledger of batch-index fates.

    Thread-safe: the TrainLoop's prefetch producer claims indices while the
    main thread commits them at step boundaries.
    """

    def __init__(self):
        self._lock = threading.RLock()
        self._leases: Dict[int, RangeLease] = {}
        self._committed: Dict[int, int] = {}   # index -> committing lease_id
        self._double_applied: List[int] = []   # invariant breaches (stay [])
        self.dup_discarded = 0                 # first-writer-wins saves
        self._next_lease_id = 0

    # -- leases -------------------------------------------------------------

    def grant(self, worker: str, lo: int, hi: int,
              backup: bool = False) -> RangeLease:
        with self._lock:
            lease = RangeLease(self._next_lease_id, worker, int(lo), int(hi),
                               backup=backup)
            self._next_lease_id += 1
            self._leases[lease.lease_id] = lease
            return lease

    def lease(self, lease_id: int) -> Optional[RangeLease]:
        return self._leases.get(lease_id)

    def leases_of(self, worker: str) -> List[RangeLease]:
        with self._lock:
            return [l for l in self._leases.values()
                    if l.worker == worker and not l.revoked]

    def revoke(self, lease_id: int) -> List[List[int]]:
        """Revoke a lease; returns its uncommitted remainder as ranges."""
        with self._lock:
            lease = self._leases[lease_id]
            lease.revoked = True
            rest = [i for i in range(lease.lo, lease.hi)
                    if i not in self._committed]
            return compress_ranges(rest)

    def reassign(self, lease_id: int, worker: str) -> Optional[RangeLease]:
        """Revoke ``lease_id`` and grant its uncommitted remainder to
        ``worker``; returns the new lease (None when nothing remains)."""
        with self._lock:
            remainder = self.revoke(lease_id)
            new: Optional[RangeLease] = None
            for lo, hi in remainder:
                new = self.grant(worker, lo, hi)
            # a dead worker's remainder is almost always one contiguous span
            # ([watermark, hi)); if commits were punched out of the middle by
            # a backup replica we granted one lease per hole above and return
            # the last — callers that need them all use leases_of()
            return new

    # -- the exactly-once gate ---------------------------------------------

    def try_claim(self, lease_id: int, index: int) -> bool:
        """First-writer-wins: True iff ``index`` is inside the live lease and
        nobody has committed it yet. A refused claim bumps
        ``dup_discarded`` — the duplicate application that did NOT happen."""
        with self._lock:
            lease = self._leases.get(lease_id)
            if lease is None or lease.revoked:
                return False
            if not (lease.lo <= index < lease.hi):
                return False
            if index in self._committed:
                self.dup_discarded += 1
                return False
            return True

    def commit(self, lease_id: int, index: int) -> bool:
        """Mark ``index`` applied under ``lease_id``; advances the lease
        watermark past the contiguous committed prefix."""
        with self._lock:
            if index in self._committed:
                # a second application reached the commit point: the
                # invariant is broken and verify() will say so loudly
                self._double_applied.append(int(index))
                self.dup_discarded += 1
                return False
            self._committed[int(index)] = lease_id
            lease = self._leases.get(lease_id)
            if lease is not None:
                while lease.watermark in self._committed and \
                        lease.watermark < lease.hi:
                    lease.watermark += 1
            return True

    def committed_count(self) -> int:
        return len(self._committed)

    def is_committed(self, index: int) -> bool:
        return index in self._committed

    # -- proof + persistence -------------------------------------------------

    def verify(self, total: int) -> Dict:
        """The exactly-once proof for a stream of ``total`` batches."""
        with self._lock:
            lost = [i for i in range(int(total)) if i not in self._committed]
            return {
                "total": int(total),
                "committed": len(self._committed),
                "lost": compress_ranges(lost),
                "lost_count": len(lost),
                "duplicated": sorted(self._double_applied),
                "duplicated_count": len(self._double_applied),
                "dup_discarded": self.dup_discarded,
                "exact": not lost and not self._double_applied,
            }

    def snapshot(self) -> Dict:
        """Checkpoint-cursor payload: committed spans + live leases."""
        with self._lock:
            return {
                "committed": compress_ranges(self._committed),
                "dup_discarded": self.dup_discarded,
                "leases": [l.to_dict() for l in self._leases.values()],
                "next_lease_id": self._next_lease_id,
            }

    def restore(self, snap: Dict) -> None:
        """Rebuild committed state from a checkpoint cursor. Leases are NOT
        resurrected as live grants — the supervisor re-leases every
        uncommitted span to the current membership (elastic restore), which
        is exactly the reassignment path a worker loss takes."""
        with self._lock:
            self._leases.clear()
            self._committed = {i: -1 for i in
                               expand_ranges(snap.get("committed", []))}
            self._double_applied = []
            self.dup_discarded = int(snap.get("dup_discarded", 0))
            self._next_lease_id = int(snap.get("next_lease_id", 0))
