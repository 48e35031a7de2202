"""The worker side of the cluster protocol, in the port, against the JAX
package's on the CPU: the indexed batch source, the leased stream and the
worker client on the same supervisor scripts (fake clocks, no sleeps), and
the loop's cluster hook (``TrainLoop(cluster=...)``, ``cluster_workers``,
the checkpoint cursor's watermarks and their restore on resume)."""

import os

import pytest
import torch

from swiftsnails_tpu.cluster import Supervisor as JSupervisor
from swiftsnails_tpu.cluster import WorkerClient as JWorkerClient
from swiftsnails_tpu.cluster.worker import IndexedBatchSource as JIndexedBatchSource

from swiftsnails_tpu_torch.cluster import (
    IndexedBatchSource,
    LeasedStream,
    Supervisor,
    WorkerClient,
    WorkerLost,
    expand_ranges,
)
from swiftsnails_tpu_torch.framework.checkpoint import intact_steps, read_manifest
from swiftsnails_tpu_torch.framework.trainer import TrainLoop
from swiftsnails_tpu_torch.resilience.drill import make_trainer
from swiftsnails_tpu_torch.telemetry.ledger import Ledger


class FakeClock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now

    def advance(self, s):
        self.now += s


def _closing_factory(log):
    """A generator factory whose generators record when they are closed (a
    stand-in for the native producer's threads, stopped in ``finally``)."""

    def factory():
        n = len(log)
        log.append("open")
        try:
            for i in range(10):
                yield i
        finally:
            log[n] = "closed"

    return factory


# -------------------------------------------------------- indexed source ---


@pytest.mark.parametrize("seq", [[2, 0, 3, 9], [0, 1, 1, 5, 4, 4, 2]])
def test_indexed_batch_source_matches_jax(seq):
    mine = IndexedBatchSource(lambda: iter([10, 11, 12, 13, 14, 15]))
    theirs = JIndexedBatchSource(lambda: iter([10, 11, 12, 13, 14, 15]))
    for i in seq:
        got = want = StopIteration
        try:
            got = mine.get(i)
        except StopIteration:
            pass
        try:
            want = theirs.get(i)
        except StopIteration:
            pass
        assert got == want
    assert mine.restarts == theirs.restarts


def test_indexed_batch_source_closes_the_generator_it_replaces():
    """A backward seek restarts the stream: the old generator is closed (its
    ``finally`` runs, as the native producer's does), not left to the
    collector; ``close()`` releases the current one."""
    log = []
    src = IndexedBatchSource(_closing_factory(log))
    assert src.get(5) == 5 and log == ["open"]
    assert src.get(1) == 1 and log == ["closed", "open"]
    assert src.restarts == 1
    src.close()
    assert log == ["closed", "closed"]
    assert src.get(0) == 0 and src.restarts == 1  # a new stream, not a restart


def test_leased_stream_close_releases_its_source():
    log = []
    sup = Supervisor(total_batches=6, lease_ms=1e6, grant_batches=3, clock=FakeClock())
    stream = WorkerClient(sup, "w0").leased_stream(_closing_factory(log))
    assert isinstance(stream, LeasedStream)
    assert next(stream) == 0
    stream.close()
    assert log == ["closed"]


# ------------------------------------------------- supervisor scripts ------


def _script_smallest_first(pkg):
    sup_cls, client_cls = pkg
    sup = sup_cls(total_batches=6, lease_ms=1e6, grant_batches=3, clock=FakeClock())
    client = client_cls(sup, "w0")
    seen = []
    for batch in client.leased_stream(lambda: iter(range(100))):
        seen.append(batch)
        client.on_step(len(seen))
    return seen, sup.accountant.verify(6), sup.status()


def _script_kill_and_reassign(pkg):
    """Two workers; w1 goes silent after two batches, its lease expires on
    the fake clock, and w0 adopts the span at a step boundary."""
    sup_cls, client_cls = pkg
    clock = FakeClock()
    sup = sup_cls(total_batches=12, lease_ms=3000.0, heartbeat_ms=500.0,
                  grant_batches=4, clock=clock)
    w0, w1 = client_cls(sup, "w0"), client_cls(sup, "w1")
    s0 = w0.leased_stream(lambda: iter(range(100)))
    s1 = w1.leased_stream(lambda: iter(range(100)))
    trace = []
    for step in (1, 2):
        trace.append(("w1", next(s1)))
        w1.on_step(step)
    step = 0
    for batch in s0:
        step += 1
        trace.append(("w0", batch))
        clock.advance(1.0)
        d = w0.on_step(step)
        trace.append(("adopted", [(lease.lo, lease.hi) for lease in d.get("adopted", ())]))
    return trace, sup.accountant.verify(12), sup.status()


def _script_rejoin(pkg):
    """A worker declared lost heartbeats again: it is refused, rejoins as a
    fresh member and drops its stale claims."""
    sup_cls, client_cls = pkg
    clock = FakeClock()
    sup = sup_cls(total_batches=8, lease_ms=1000.0, heartbeat_ms=100.0,
                  grant_batches=4, clock=clock)
    w0, w1 = client_cls(sup, "w0"), client_cls(sup, "w1")
    s0 = w0.leased_stream(lambda: iter(range(100)))
    s1 = w1.leased_stream(lambda: iter(range(100)))
    trace = [next(s0), next(s1)]
    w0.on_step(1)
    clock.advance(5.0)  # both leases lapse
    w1.on_step(1)       # w1 is refused, rejoins
    trace.append(w1.rejoins)
    for batch in s1:
        trace.append(batch)
        clock.advance(0.05)
        w1.on_step(len(trace))
    return trace, sup.accountant.verify(8), sup.status()


@pytest.mark.parametrize("script", [_script_smallest_first, _script_kill_and_reassign,
                                    _script_rejoin])
def test_worker_client_matches_jax_on_a_supervisor_script(script):
    """The same supervisor script through both packages' worker clients:
    the batches each worker draws, the spans adopted at step boundaries,
    the accountant's proof and the supervisor's status are equal."""
    mine = script((Supervisor, WorkerClient))
    theirs = script((JSupervisor, JWorkerClient))
    assert mine == theirs
    assert mine[1]["exact"] or script is _script_rejoin


def test_worker_lost_is_the_ports_own_type():
    sup = Supervisor(total_batches=4, lease_ms=10.0, clock=FakeClock())
    sup.register("w0")
    sup.mark_dead("w0", reason="drill")
    with pytest.raises(WorkerLost):
        sup.heartbeat("w0")


# ------------------------------------------------------ the loop's hook ----


def _tables(state):
    return [t.clone() for t in (state.in_table.table, state.out_table.table)]


@pytest.fixture(autouse=True)
def _one_thread():
    """The dense push (``index_put_`` with accumulate) is serial, so run to
    run equal, with one intra-op thread on the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_cluster_workers_trains_every_batch_exactly_once(tmp_path):
    """``cluster_workers: 1`` self-hosts a supervisor: the run commits every
    batch it applies, in index order, and trains the tables the plain loop
    does, bit for bit (one worker leases the stream in order)."""
    plain = make_trainer(str(tmp_path / "a"), device="cpu")
    ref = TrainLoop(plain, log_every=0).run(max_steps=10)
    os.makedirs(tmp_path / "b")
    tr = make_trainer(str(tmp_path / "b"), device="cpu", cluster_workers=1,
                      cluster_grant_batches=4)
    loop = TrainLoop(tr, log_every=0)
    state = loop.run(max_steps=10)
    acct = loop.cluster.supervisor.accountant
    assert acct.committed_count() == 10
    assert [torch.equal(a, b) for a, b in zip(_tables(state), _tables(ref))] == [True, True]
    joins = Ledger(str(tmp_path / "b" / "LEDGER.jsonl")).records("membership")
    assert [(r["action"], r["worker"]) for r in joins] == [("join", "w0")]


def test_explicit_cluster_client_shared_by_two_loops(tmp_path):
    """``TrainLoop(cluster=client)``: two loops on one in-process supervisor
    split the stream; together they commit each batch once."""
    clock = FakeClock()
    sup = Supervisor(total_batches=12, lease_ms=1e6, grant_batches=3, clock=clock)
    states = []
    for wid in ("w0", "w1"):
        tr = make_trainer(str(tmp_path / wid), device="cpu")
        loop = TrainLoop(tr, log_every=0, cluster=WorkerClient(sup, wid))
        states.append(loop.run(max_steps=6))
    proof = sup.accountant.verify(12)
    assert proof["exact"] and proof["committed"] == 12


def test_cluster_cursor_rides_the_checkpoint_and_resume_restores_it(tmp_path):
    """The checkpoint cursor carries the committed watermarks; ``resume:
    auto`` restores them in place of a flat skip, and the resumed run ends
    bit-equal to a straight one."""
    base = dict(device="cpu", cluster_workers=1, cluster_grant_batches=4)
    straight = TrainLoop(make_trainer(str(tmp_path / "s"), **base), log_every=0).run(
        max_steps=12)
    root = str(tmp_path / "ck")
    first = TrainLoop(make_trainer(str(tmp_path / "r"), param_backup_period=5,
                                   param_backup_root=root, **base), log_every=0)
    first.run(max_steps=7)
    newest = intact_steps(root)[0]
    cursor = read_manifest(root, newest)["data_cursor"]
    assert newest == 5
    assert expand_ranges(cursor["cluster"]["committed"]) == list(range(5))
    resumed = TrainLoop(make_trainer(str(tmp_path / "r"), param_backup_period=5,
                                     param_backup_root=root, resume="auto", **base),
                        log_every=0)
    state = resumed.run(max_steps=12)
    assert resumed._restored_step == 5
    assert [torch.equal(a, b) for a, b in zip(_tables(state), _tables(straight))] == [
        True, True]
