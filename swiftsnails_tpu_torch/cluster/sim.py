"""A deterministic simulated N-worker async-SGD cluster.

The chaos-cluster drills need a *fleet* to hurt — workers that die
mid-stream, straggle, or partition away from the supervisor — and CPU CI
can't spawn a real multi-host mesh. This module runs N logical workers
against ONE shared model state (the parameter-server view: every committed
batch's update lands in the shared tables) under a **virtual clock**: each
worker owns a per-step duration in virtual seconds, the scheduler always
runs the worker with the earliest free time, and the supervisor's
membership leases measure the same virtual clock — so lease expiry,
heartbeat cadence, and EWMA straggler detection all drill deterministically
with zero wall-clock sleeping.

Each batch's update draws from the generator of its **global batch index**
(``step_generator(seed, index, device)``, not by worker or arrival order),
so a batch applies identically no matter who runs it or when — application *order* is the only thing chaos can perturb, which
is exactly the asynchrony the paper's async-SGD already tolerates (loss
parity, not bit equality, is the cross-leg bar; bit equality is proved
separately by the resume-under-reassignment drill where the committed set
pins the order).

Chaos kinds consulted here (scheduled by global tick = cluster-wide batches
applied): ``worker_dead`` (victim stops heartbeating forever),
``worker_slow`` (victim's virtual step time inflates while scheduled),
``partition`` (victim computes but can't reach the supervisor: heartbeats
drop, its updates buffer; on heal every buffered update re-claims — the
committed ones are refused by first-writer-wins and discarded, the stale
worker rejoins as a fresh member).

The JAX package's ``cluster/sim.py``, with its constants. The port's steps
update the tables in place: a leg's ``trainer.init_state()`` lives until
the caller drops the returned state, so a caller that runs legs back to
back frees one before the next allocates. The partition's buffered updates
are ``(index, lease_id)`` pairs, applied at heal, so no state is copied.
The result also carries ``order``, the indices in the order their updates
landed: :func:`make_step_fn` replays it.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from swiftsnails_tpu_torch.cluster.accounting import compress_ranges
from swiftsnails_tpu_torch.cluster.supervisor import Supervisor, WorkerLost
from swiftsnails_tpu_torch.cluster.worker import IndexedBatchSource, WorkerClient

SLOW_FACTOR = 6.0          # worker_slow: virtual step-time multiplier
BASE_STEP_S = 1.0          # healthy worker virtual step duration
IDLE_TICK_S = 0.5          # drained worker's heartbeat-poll cadence
# a partition outlasts the default membership lease (9 virtual s), so the
# supervisor reassigns the victim's span and the heal-time re-claims are
# refused — the exactly-once gate this fault exists to drill
PARTITION_S = 14.0


class _VClock:
    def __init__(self):
        self.now = 0.0

    def __call__(self) -> float:
        return self.now


def make_step_fn(trainer, seed: int = 0):
    """One batch apply, ``step(state, batch, index) -> state``: the batch's
    arrays go to the trainer's device (scalars such as ``progress`` stay on
    the host, as in the loop) and the update draws from
    ``step_generator(seed, index, device)``, so the update for index ``i``
    is the same whoever applies it."""
    from swiftsnails_tpu_torch.framework.trainer import step_generator

    device = trainer.device

    def _step(state, batch, index: int):
        dev = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
               if np.ndim(v) else v for k, v in batch.items()}
        state, _ = trainer.train_step(state, dev, step_generator(seed, int(index), device))
        return state

    return _step


class _SimWorker:
    def __init__(self, idx: int, worker_id: str, batch_factory,
                 client: Optional[WorkerClient]):
        self.idx = idx
        self.worker_id = worker_id
        self.client = client                       # None on the control leg
        self.source = IndexedBatchSource(batch_factory)
        self.speed = BASE_STEP_S
        self.next_free = 0.0
        self.alive = True
        self.idle = False
        self.steps = 0
        self.applied = 0
        # partition bookkeeping
        self.partitioned_until: Optional[float] = None
        self.buffered: List = []                   # (index, lease_id) pairs
        # control-leg static shard
        self.own: List[int] = []


def simulate_cluster(
    trainer,
    total_batches: int,
    workers: int = 3,
    chaos=None,
    supervised: bool = True,
    lease_ms: float = 9000.0,
    heartbeat_ms: float = 2000.0,
    straggler_ewma: float = 0.4,
    backup_substeps: int = 2,
    grant_batches: int = 6,
    seed: int = 0,
    ledger=None,
) -> Dict:
    """Run ``total_batches`` through ``workers`` simulated workers; returns
    the final shared state plus the accounting proof and fleet stats."""
    clock = _VClock()
    step_fn = make_step_fn(trainer, seed)
    state = trainer.init_state()
    order: List[int] = []  # indices in the order their updates landed

    sup: Optional[Supervisor] = None
    if supervised:
        sup = Supervisor(
            total_batches=total_batches, lease_ms=lease_ms,
            heartbeat_ms=heartbeat_ms, straggler_ewma=straggler_ewma,
            backup_substeps=backup_substeps, grant_batches=grant_batches,
            ledger=ledger, clock=clock,
        )

    fleet: List[_SimWorker] = []
    for i in range(workers):
        wid = f"w{i}"
        sw = _SimWorker(i, wid, trainer.batches, None)
        if sup is not None:
            # the client's clock is the WORKER's own timeline (next_free =
            # its latest completion), so on_step's measured step latency is
            # the worker's true per-step duration — the global clock only
            # ratchets to the fleet-wide max and would alias peers' progress
            # into this worker's EWMA
            sw.client = WorkerClient(sup, wid,
                                     clock=lambda sw=sw: sw.next_free)
        fleet.append(sw)
    if sup is None:
        # control leg: static contiguous block shards, no reassignment
        block = -(-total_batches // workers)
        for w in fleet:
            w.own = list(range(w.idx * block,
                               min(total_batches, (w.idx + 1) * block)))

    applied_control: Dict[int, int] = {}     # control leg: index -> worker
    stale_rejected = 0
    chaos_rng = np.random.default_rng(getattr(chaos, "seed", seed) + 1)
    slow_victim: Optional[_SimWorker] = None
    last_slow_tick = -1
    tick = 0        # global batches applied — the chaos schedule's axis
    iters = 0       # scheduler iterations — the runaway bound
    max_iters = total_batches * 40 + 400

    def _victim() -> Optional[_SimWorker]:
        live = [w for w in fleet
                if w.alive and (w.partitioned_until is None)]
        if len(live) <= 1:
            return None  # never orphan the whole fleet
        return live[int(chaos_rng.integers(0, len(live)))]

    def _done() -> bool:
        if sup is not None:
            return sup.accountant.committed_count() >= total_batches
        return len(applied_control) >= total_batches or \
            all(not w.alive or w.idle for w in fleet)

    # discrete-event scheduling: workers run CONCURRENTLY in virtual time —
    # each batch occupies [next_free, next_free + speed) on its own worker's
    # timeline, and the global clock (what membership leases measure) only
    # ratchets to the latest completion seen. Serializing here instead would
    # inflate every worker's measured step latency by the fleet width and
    # blind the EWMA straggler detector.
    while not _done() and iters < max_iters:
        iters += 1
        runnable = [w for w in fleet if w.alive]
        if not runnable:
            break
        w = min(runnable, key=lambda x: (x.next_free, x.idx))

        # -- heal a partition whose window elapsed -------------------------
        if w.partitioned_until is not None:
            if w.next_free < w.partitioned_until:
                w.next_free = w.partitioned_until
                continue
            clock.now = max(clock.now, w.next_free)
            w.partitioned_until = None
            if sup is not None:
                # the buffered (computed-but-unpushed) updates try to land:
                # first-writer-wins refuses every index a survivor already
                # committed — the exactly-once gate under partition
                for index, lease_id in w.buffered:
                    if sup.accountant.try_claim(lease_id, index):
                        batch = w.source.get(index)
                        state = step_fn(state, batch, index)
                        order.append(index)
                        sup.accountant.commit(lease_id, index)
                        w.applied += 1
                    else:
                        stale_rejected += 1
                w.buffered = []
                try:
                    sup.heartbeat(w.worker_id, step=w.steps)
                except WorkerLost:
                    w.client._rejoin()
            w.idle = False

        # -- scheduled chaos at this global tick ---------------------------
        if chaos is not None:
            for kind in chaos.cluster_fault(tick):
                if kind == "worker_dead":
                    v = _victim()
                    if v is not None:
                        v.alive = False  # silent death: lease must expire
                        chaos._log("worker_dead", tick,
                                   {"worker": v.worker_id})
                elif kind == "worker_slow":
                    if slow_victim is None or not slow_victim.alive:
                        slow_victim = _victim()
                        if slow_victim is not None:
                            chaos._log("worker_slow", tick,
                                       {"worker": slow_victim.worker_id,
                                        "factor": SLOW_FACTOR})
                    if slow_victim is not None:
                        slow_victim.speed = BASE_STEP_S * SLOW_FACTOR
                    last_slow_tick = tick
                elif kind == "partition":
                    v = _victim()
                    if v is not None:
                        v.partitioned_until = clock.now + PARTITION_S
                        if v.client is not None:
                            v.buffered = [(i, lid) for i, lid in
                                          v.client._heap]
                            v.client._heap.clear()
                            v.client._inflight.clear()
                        chaos._log("partition", tick,
                                   {"worker": v.worker_id,
                                    "heal_s": PARTITION_S})
        if slow_victim is not None and tick > last_slow_tick:
            slow_victim.speed = BASE_STEP_S
            slow_victim = None
        if not w.alive or w.partitioned_until is not None:
            continue

        # -- one batch ------------------------------------------------------
        if sup is not None:
            clock.now = max(clock.now, w.next_free)
            try:
                batch = w.client._next_batch(w.source)
            except StopIteration:
                # drained: keep heartbeating so reassignments can revive us
                w.idle = True
                w.next_free = max(w.next_free, clock.now) + IDLE_TICK_S
                try:
                    d = sup.heartbeat(w.worker_id, step=w.steps)
                except WorkerLost:
                    w.client._rejoin()
                    continue
                if d.get("adopted"):
                    for lease in d["adopted"]:
                        w.client._adopt(lease)
                    w.client._exhausted = False
                    w.idle = False
                continue
            index = w.client._inflight[-1][1]
            state = step_fn(state, batch, index)
            order.append(index)
            w.steps += 1
            w.applied += 1
            # the batch spans [next_free, next_free + speed) on THIS
            # worker's timeline; commit + heartbeat fire at its completion
            w.next_free = w.next_free + w.speed
            clock.now = max(clock.now, w.next_free)
            w.client.on_step(w.steps)
        else:
            nxt = next((i for i in w.own if i not in applied_control), None)
            if nxt is None:
                w.idle = True
                w.next_free = max(w.next_free, clock.now) + IDLE_TICK_S
                continue
            batch = w.source.get(nxt)
            state = step_fn(state, batch, nxt)
            order.append(nxt)
            applied_control[nxt] = w.idx
            w.steps += 1
            w.applied += 1
            w.next_free = w.next_free + w.speed
            clock.now = max(clock.now, w.next_free)
        tick += 1

    for w in fleet:
        w.source.close()  # the producers of every worker's generator
    out: Dict = {
        "state": state,
        "workers": {
            w.worker_id: {"alive": w.alive, "applied": w.applied,
                          "steps": w.steps}
            for w in fleet
        },
        "ticks": tick,
        "virtual_s": round(clock.now, 3),
        "stale_rejected": stale_rejected,
        "order": order,
    }
    if sup is not None:
        out["accounting"] = sup.accountant.verify(total_batches)
        out["status"] = sup.status()
    else:
        lost = [i for i in range(total_batches) if i not in applied_control]
        out["accounting"] = {
            "total": total_batches,
            "committed": len(applied_control),
            "lost": compress_ranges(lost),
            "lost_count": len(lost),
            "duplicated": [],
            "duplicated_count": 0,
            "dup_discarded": 0,
            "exact": not lost,
        }
    return out


def run_inorder_control(trainer, total_batches: int, seed: int = 0):
    """The undisturbed single-worker control: every batch applied in index
    order — the loss-parity reference for the chaos legs."""
    step_fn = make_step_fn(trainer, seed)
    state = trainer.init_state()
    src = IndexedBatchSource(trainer.batches)
    try:
        for i in range(total_batches):
            state = step_fn(state, src.get(i), i)
    finally:
        src.close()
    return state
