"""The tier's flush worker ends with the run: ``TrainLoop.run`` stops it on
every way out (a normal end, a ``preempt@N`` chaos stop, an exception), so
no ``tier-flush-worker`` thread outlives the run that started it, and what
it flushed is what the run returns. ``_FlushQueue.stop`` lands the queue
first, and a ``put`` after it starts a new worker."""

import threading

import numpy as np
import pytest
import torch

from swiftsnails_tpu_torch.parallel.store import TableState
from swiftsnails_tpu_torch.resilience.drill import make_trainer, run_loop
from swiftsnails_tpu_torch.tiered import HostMaster, TieredTable
from swiftsnails_tpu_torch.tiered.store import _FlushQueue

WORKER = "tier-flush-worker"
STEPS = 16
# 100 of the drill corpus' 128 words a table at dim 16, batches of 32:
# every step fits the budget and the run evicts
TIER = {"table_tier": "host", "tier_hbm_budget_mb": 2 * 100 * 16 * 4 / float(1 << 20),
        "tier_async_flush": 1, "batch_size": 32}

torch.set_num_threads(1)


def _workers() -> set:
    return {t for t in threading.enumerate() if t.name == WORKER and t.is_alive()}


class _Boom(RuntimeError):
    pass


@pytest.mark.parametrize("end", ["normal", "preempt", "exception"])
def test_no_flush_worker_outlives_the_run(tmp_path, end):
    before = _workers()  # other tests' queues in this process, if any
    over = dict(TIER)
    if end == "preempt":
        over.update(param_backup_period=5, param_backup_root=str(tmp_path / "ck"),
                    chaos_spec="preempt@9", chaos_seed=11)
    trainer = make_trainer(str(tmp_path), device="cpu", **over)
    seen = []
    if end != "preempt":
        step = trainer.train_step
        n = [0]

        def watched(*args, **kwargs):
            n[0] += 1
            seen.append(bool(_workers() - before))
            if end == "exception" and n[0] == 10:
                raise _Boom("step 10")
            return step(*args, **kwargs)

        trainer.train_step = watched
    if end == "exception":
        from swiftsnails_tpu_torch.framework.trainer import TrainLoop

        loop = TrainLoop(trainer, log_every=0)
        with pytest.raises(_Boom):
            loop.run(max_steps=STEPS)
    else:
        loop, _, steps = run_loop(trainer, max_steps=STEPS)
        assert loop.preempted is (end == "preempt")
        assert steps < STEPS if end == "preempt" else steps == STEPS
    summary = loop.tier.summary()
    assert summary["async_flush"] and summary["evictions"] > 0
    assert summary["flushed_rows"] > 0  # the worker landed rows in this run
    if seen:
        assert any(seen)  # and it was alive during the steps
    assert not (_workers() - before)
    assert loop.tier.flusher._thread is None


def test_stopped_run_returns_what_a_sync_flush_returns(tmp_path):
    """Stopping the worker at the end changes nothing the run returns: the
    async run's tables equal the synchronous-flush run's."""
    _, sync, _ = run_loop(make_trainer(str(tmp_path), device="cpu",
                                       **{**TIER, "tier_async_flush": 0}), max_steps=STEPS)
    _, asyn, _ = run_loop(make_trainer(str(tmp_path), device="cpu", **TIER), max_steps=STEPS)
    for a, b in zip(sync, asyn):
        assert torch.equal(a.table, b.table)


def test_flush_queue_stop_lands_the_queue_and_restarts_on_put():
    master = HostMaster(TableState(table=torch.zeros(8, 2), slots={}), "dense")
    fq = _FlushQueue()
    tt = TieredTable(master, 2, name="t", flusher=fq, device="cpu")
    fq.stop()  # no worker yet: nothing to do
    assert fq._thread is None
    cache = tt.make_cache()
    cache.table[:] = 1.0
    cache = tt.ensure(cache, np.array([0, 1]))
    cache.table[:] = 2.0  # both slots dirty
    fq.pause()  # the worker holds what it takes until stop
    cache = tt.ensure(cache, np.array([2, 3]))  # evicts both: queued
    first = fq._thread
    assert first is not None and first.is_alive()
    fq.stop()
    assert not first.is_alive() and fq._thread is None
    assert (master.table[:2] == 2.0).all()  # landed before the worker ended
    cache.table[:] = 3.0
    tt.ensure(cache, np.array([4, 5]))  # a put after the stop: a new worker
    assert fq._thread is not None and fq._thread is not first
    fq.drain()
    assert (master.table[2:4] == 3.0).all()
    fq.stop()
    assert fq._thread is None
