"""The worker side of the cluster protocol: leased batch streams.

A :class:`WorkerClient` registers with the :class:`Supervisor`, pulls range
leases, and exposes the union of its leased spans as an ordinary batch
iterator (:class:`LeasedStream`) the TrainLoop can consume in place of
``trainer.batches()``. Every yielded index passes the accountant's
first-writer-wins claim; every applied index is committed at the step
boundary (:meth:`WorkerClient.on_step`), which also renews the membership
lease and adopts any spans the supervisor reassigned this way.

Indices are always served smallest-first across all held leases. That makes
the global application order a pure function of the committed set — the
property the resume-under-reassignment parity drill relies on: restore the
watermarks and the replay is bit-identical.

:class:`IndexedBatchSource` maps an index back to a batch by replaying the
seed-deterministic generator — the same trick ``resume: auto``'s data
cursor uses, generalized to random access (a backward seek restarts the
generator; adopted spans can sit behind the consumer's own frontier). The
JAX package's ``cluster/worker.py``; in the port a restart (and
:meth:`IndexedBatchSource.close`) closes the generator it replaces, whose
``finally`` stops the native producer's threads and frees their buffers.
"""

from __future__ import annotations

import heapq
from collections import deque
from typing import Callable, Dict, Iterator, Optional

from swiftsnails_tpu_torch.cluster.supervisor import Supervisor, WorkerLost


class IndexedBatchSource:
    """Random access over a seed-deterministic batch generator."""

    def __init__(self, factory: Callable[[], Iterator]):
        self._factory = factory
        self._it: Optional[Iterator] = None
        self._pos = 0
        self.restarts = 0

    def get(self, index: int):
        """The batch at stream position ``index``; raises StopIteration past
        the end. Backward seeks replay the generator from scratch."""
        if self._it is None or index < self._pos:
            if self._it is not None:
                self.restarts += 1
                self.close()
            self._it = iter(self._factory())
            self._pos = 0
        batch = None
        while self._pos <= index:
            batch = next(self._it)  # StopIteration: stream exhausted
            self._pos += 1
        return batch

    def close(self) -> None:
        """Close the current generator (its producer threads and buffers);
        the next :meth:`get` starts a new one."""
        it, self._it = self._it, None
        self._pos = 0
        close = getattr(it, "close", None)
        if close is not None:
            close()


class LeasedStream:
    """Iterator over a client's leased spans, claim-gated per index."""

    def __init__(self, client: "WorkerClient", source: IndexedBatchSource):
        self._client = client
        self._source = source

    def __iter__(self):
        return self

    def __next__(self):
        return self._client._next_batch(self._source)

    def close(self) -> None:
        self._source.close()


class WorkerClient:
    """One worker's membership + data-lease session with a supervisor."""

    def __init__(self, supervisor: Supervisor, worker_id: str,
                 clock: Optional[Callable[[], float]] = None):
        self.supervisor = supervisor
        self.worker_id = worker_id
        self.clock = clock if clock is not None else supervisor.clock
        self._heap: list = []             # (index, lease_id), smallest first
        self._inflight: deque = deque()   # yielded, not yet committed
        self._exhausted = False
        self._last_step_t: Optional[float] = None
        self._last_hb_t: Optional[float] = None
        self.rejoins = 0
        supervisor.register(worker_id)

    # -- stream -------------------------------------------------------------

    def leased_stream(self, batch_factory: Callable[[], Iterator]) -> LeasedStream:
        return LeasedStream(self, IndexedBatchSource(batch_factory))

    def _adopt(self, lease) -> None:
        for i in range(lease.watermark, lease.hi):
            heapq.heappush(self._heap, (i, lease.lease_id))

    def _next_batch(self, source: IndexedBatchSource):
        acct = self.supervisor.accountant
        while True:
            if not self._heap:
                if self._exhausted:
                    raise StopIteration
                try:
                    lease = self.supervisor.next_range(self.worker_id)
                except WorkerLost:
                    self._rejoin()
                    lease = self.supervisor.next_range(self.worker_id)
                if lease is None:
                    raise StopIteration
                self._adopt(lease)
                continue
            index, lease_id = heapq.heappop(self._heap)
            if not acct.try_claim(lease_id, index):
                continue  # committed already (backup/restore) or revoked
            try:
                batch = source.get(index)
            except StopIteration:
                self._exhausted = True
                raise
            self._inflight.append((lease_id, index))
            return batch

    # -- step boundary -------------------------------------------------------

    def on_step(self, step: int) -> Dict:
        """Commit the just-applied batch, renew the membership lease, adopt
        reassigned spans. Call once per completed train step."""
        if self._inflight:
            lease_id, index = self._inflight.popleft()
            self.supervisor.accountant.commit(lease_id, index)
        now = self.clock()
        step_ms = None
        if self._last_step_t is not None:
            step_ms = (now - self._last_step_t) * 1e3
        self._last_step_t = now
        hb_period = self.supervisor.heartbeat_ms / 1e3
        if self._last_hb_t is not None and (now - self._last_hb_t) < hb_period:
            return {}
        self._last_hb_t = now
        try:
            directives = self.supervisor.heartbeat(
                self.worker_id, step=step, step_ms=step_ms)
        except WorkerLost:
            self._rejoin()
            directives = self.supervisor.heartbeat(
                self.worker_id, step=step, step_ms=step_ms)
        for lease in directives.get("adopted", ()):
            self._adopt(lease)
        return directives

    def _rejoin(self) -> None:
        # our lease expired and the span was re-leased elsewhere; drop the
        # stale claims (their leases are revoked — claims would refuse
        # anyway) and start fresh from the pool/frontier
        self.rejoins += 1
        self._heap.clear()
        self._inflight.clear()
        self.supervisor.register(self.worker_id)

    # -- checkpoint cursor ---------------------------------------------------

    def cursor(self) -> Dict:
        return self.supervisor.cursor()

    def restore(self, snap: Dict) -> None:
        self.supervisor.restore(snap)
