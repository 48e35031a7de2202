"""The port's tiered parameter store (``table_tier: host``) against itself and
the JAX package's, on the CPU.

The tier's contract is exactness: at f32 a tiered run equals the resident
one bit for bit, through forced tiny budgets (constant eviction + dirty
write-back, with the async flusher on and off), checkpoints and a
preempted + resumed run. Against the JAX package: the same sequence of
``ensure`` / ``prewarm`` / ``flush`` calls on both packages' ``TieredTable``
leaves the same slot map, CLOCK state, write-back generations and counters
(native and numpy routes); the CTR families trained tiered in both packages
from one start state count the same faults and evictions, with tables
within ``tests/test_torch_ctr.py``'s tolerance; the tiered servant answers
as JAX's does.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from swiftsnails_tpu.framework.trainer import TrainLoop as JaxTrainLoop
from swiftsnails_tpu.models.registry import get_model as jax_get_model
from swiftsnails_tpu.parallel.store import PackedTableState as JPacked
from swiftsnails_tpu.parallel.store import TableState as JTableState
from swiftsnails_tpu.serving.engine import Servant as JServant
from swiftsnails_tpu.tiered import store as jax_store
from swiftsnails_tpu.utils.config import Config as JaxConfig
from swiftsnails_tpu_torch import convert
from swiftsnails_tpu_torch.data import ctr
from swiftsnails_tpu_torch.framework.checkpoint import load_tables
from swiftsnails_tpu_torch.framework.quality import paired_corpus
from swiftsnails_tpu_torch.framework.trainer import TrainLoop
from swiftsnails_tpu_torch.models.registry import get_model
from swiftsnails_tpu_torch.models.word2vec import Word2VecTrainer
from swiftsnails_tpu_torch.parallel.store import TableState
from swiftsnails_tpu_torch.serving import Fleet, Servant
from swiftsnails_tpu_torch.telemetry.ledger import Ledger
from swiftsnails_tpu_torch.tiered import HostMaster, TieredTable
from swiftsnails_tpu_torch.tiered.store import _FlushQueue
from swiftsnails_tpu_torch.utils.config import Config

CPU = "cpu"
DELTA_RTOL = 1e-4  # tests/test_torch_ctr.py's: f32 order differs across frameworks
# one intra-op thread: the shapes are small and the suite's workers share cores
torch.set_num_threads(1)


def _budget_mb(slots: int, row_bytes: int, tables: int = 2) -> float:
    """Total budget sized to ``slots`` cache units of ``row_bytes`` a table."""
    return tables * slots * row_bytes / float(1 << 20)


# word2vec path -> (config keys, bytes a cache unit at dim 8)
PATHS = {
    "dense": ({"packed": 0}, 8 * 4),
    "packed": ({"packed": 1, "pool_size": 1, "pool_block": 1}, 128 * 4),
    "perpair": ({"packed": 1, "neg_mode": "per_pair"}, 128 * 4),
}


def _make(path="dense", slots=None, corpus=None, **over):
    ids, vocab = corpus if corpus is not None else paired_corpus(
        n_pairs=8, reps=400, seed=0)
    keys, row_bytes = PATHS[path]
    cfg = Config({
        "dim": "8", "window": "1", "negatives": "1",
        "learning_rate": "0.5", "num_iters": "4", "batch_size": "1",
        "subsample": "0", "seed": "0", "steps_per_call": "1",
        **{k: str(v) for k, v in keys.items()},
    })
    for k, v in over.items():
        cfg.set(k, str(v))
    if slots is not None:
        cfg.set("table_tier", "host")
        cfg.set("tier_hbm_budget_mb", str(_budget_mb(slots, row_bytes)))
    return Word2VecTrainer(cfg, corpus_ids=ids, vocab=vocab, device=CPU)


def _tables_equal(a, b) -> bool:
    return (torch.equal(a.in_table.table, b.in_table.table)
            and torch.equal(a.out_table.table, b.out_table.table))


# ------------------------------------------------ CLOCK against the JAX one ---


def _planes(layout, rng):
    if layout == "dense":
        table = rng.normal(size=(48, 8)).astype(np.float32)
        return table, {"accum": rng.random((48, 8)).astype(np.float32)}, 1
    return rng.normal(size=(24, 2, 128)).astype(np.float32), {}, 4


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("layout", ["dense", "packed_small"])
def test_clock_state_machine_equals_jax(monkeypatch, layout, native):
    """One scripted sequence — prewarm, faults with and without dirty
    marking, writes to the touched slots, periodic flushes — on both
    packages' ``TieredTable``: after every call the slot maps, CLOCK
    counters and hand, dirty bits, write-back generations and counters are
    equal, and so are the caches and (after each flush) the masters."""
    rng = np.random.default_rng(11)
    table, slots, group = _planes(layout, rng)
    if not native:
        monkeypatch.setattr(jax_store, "_native_mod", False)
    kind = JTableState if table.ndim == 2 else JPacked
    jm = jax_store.HostMaster(kind(table=jnp.asarray(table),
                                   slots={k: jnp.asarray(v) for k, v in slots.items()}),
                              layout, group=group)
    pm = convert.host_master_from_numpy(table, slots, layout=layout, group=group)
    jt = jax_store.TieredTable(jm, 9, name="t")
    pt = TieredTable(pm, 9, name="t", device=CPU, use_native=native)
    jc, pc = jt.make_cache(), pt.make_cache()
    units = table.shape[0]
    warm = rng.permutation(units)[:5]
    jc, pc = jt.prewarm(jc, warm), pt.prewarm(pc, warm)
    for i in range(48):
        u = rng.choice(units, size=int(rng.integers(1, 8)), replace=False)
        mark = bool(rng.integers(0, 4))
        jc = jt.ensure(jc, u, mark_dirty=mark)
        pc = pt.ensure(pc, u, mark_dirty=mark)
        if mark:  # the step writes the rows it touched
            s = pt.slot_of[u]
            delta = rng.normal(size=(len(u),) + table.shape[1:]).astype(np.float32)
            jc = jc._replace(table=jc.table.at[jnp.asarray(s)].add(jnp.asarray(delta)))
            pc.table[torch.from_numpy(s)] += torch.from_numpy(delta)
        if i % 12 == 11:
            jt.flush(jc)
            pt.flush(pc)
            np.testing.assert_array_equal(jm.table, pm.table)
        j, p = convert.tier_state_numpy(jt), convert.tier_state_numpy(pt)
        for key in convert.TIER_STATE_FIELDS:
            np.testing.assert_array_equal(j[key], p[key], err_msg=f"{key} at call {i}")
        assert (j["hand"], j["used"], j["stats"]) == (p["hand"], p["used"], p["stats"])
        np.testing.assert_array_equal(np.asarray(jc.table), pc.table.numpy())
    assert p["stats"]["evictions"] > 0 and p["stats"]["flushed_rows"] > 0


def test_native_and_numpy_routes_are_bit_exact():
    """``use_native`` on and off give the same remap and the same CLOCK
    victims, hand and aged counters on one random state."""
    rng = np.random.default_rng(5)
    master = HostMaster(TableState(table=torch.zeros(200, 4), slots={}), "dense",
                        checksums=False)
    out = []
    for native in (True, False):
        tt = TieredTable(master, 64, device=CPU, use_native=native)
        tt.slot_of[:] = -1
        units = rng.permutation(200)[:64]
        tt.slot_of[units] = np.arange(64)
        tt.unit_of[:] = units
        tt.used = 64
        tt.ref[:] = rng.integers(0, 6, 64).astype(np.uint8)
        tt.hand = 17
        rows = units[rng.integers(0, 64, 300)].astype(np.int32)
        remapped = tt.remap(rows)
        victims = tt._allocate(np.arange(0, 64, 7), tt.make_cache(), 20)
        out.append((remapped, victims, tt.hand, tt.ref.copy()))
        rng = np.random.default_rng(5)
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)


# -------------------------------------------- word2vec: tiered == resident ---


@pytest.mark.parametrize("async_flush", [0, 1], ids=["sync", "async"])
@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("slots", [2, 3, 4])
def test_tiny_budget_bit_parity(slots, path, async_flush):
    """Budgets of 2-4 slots a table against a 16-word vocab force an
    eviction (and so a dirty flush and a later refault) on almost every
    step; the final tables equal the resident run's bit for bit, and no
    slot is left dirty after the end-of-run write-back."""
    steps = 24
    resident = TrainLoop(_make(path), log_every=0).run(seed=0, max_steps=steps)
    loop = TrainLoop(_make(path, slots=slots, tier_async_flush=async_flush),
                     log_every=0)
    tiered = loop.run(seed=0, max_steps=steps)
    s = loop.tier.summary()
    assert s["evictions"] > 0 and s["flushed_rows"] > 0, s
    assert s["async_flush"] is bool(async_flush)
    assert _tables_equal(resident, tiered)
    assert tiered.in_table.table.device.type == "cpu"
    for t in s["tables"].values():
        assert t["budget_slots"] == slots and t["dirty"] == 0


def test_transparent_full_budget_passthrough():
    """A budget that covers the whole vocab enters pass-through mode: the
    identity-mapped plane IS the cache, no step faults or evicts, and parity
    holds through the end-of-run wholesale flush."""
    steps = 16
    resident = TrainLoop(_make(), log_every=0).run(seed=0, max_steps=steps)
    loop = TrainLoop(_make(slots=16), log_every=0)  # 16-word vocab
    tiered = loop.run(seed=0, max_steps=steps)
    s = loop.tier.summary()
    assert s["transparent"] is True and s["transparent_steps"] >= steps
    assert s["faulted_rows"] == 0 and s["evictions"] == 0
    assert s["flushed_rows"] > 0
    assert _tables_equal(resident, tiered)


def test_auto_prefetch_depth_and_hash_keys_parity():
    """``tier_prefetch_depth: auto`` with hashed keys: the plan hashes on
    the host as the step hashes on its device, and the run stays bit-equal."""
    over = {"hash_keys": 1, "capacity": 64, "tier_prefetch_depth": "auto"}
    resident = TrainLoop(_make(**{k: v for k, v in over.items()
                                  if k != "tier_prefetch_depth"}),
                         log_every=0).run(seed=0, max_steps=20)
    loop = TrainLoop(_make(slots=4, **over), log_every=0)
    tiered = loop.run(seed=0, max_steps=20)
    assert loop.tier.summary()["prefetch_auto"] is True
    assert _tables_equal(resident, tiered)


def test_working_set_over_budget_raises():
    """A step touching more distinct units than the budget holds fails
    loudly, never silently dropping rows."""
    loop = TrainLoop(_make(slots=2, batch_size=16, negatives=4), log_every=0)
    with pytest.raises(RuntimeError, match="distinct cache units"):
        loop.run(seed=0, max_steps=2)


def test_fused_paths_refuse_the_tier():
    with pytest.raises(ValueError, match="does not compose with fused"):
        _make("packed", slots=4, fused=1)


def test_mesh_and_the_freshness_tee_raise():
    """The meshed cache plane (Queue 1 item 6) is not ported: it raises
    naming its item. The freshness tee is ported since this test was
    written: ``delta_tap`` records every landed write-back's units and
    ``flush_dirty`` is the barrier that lands them
    (``tests/test_torch_freshness.py`` holds the tee against JAX's)."""
    master = HostMaster(TableState(table=torch.zeros(8, 4), slots={}), "dense")
    with pytest.raises(NotImplementedError, match="item 6"):
        TieredTable(master, 4, mesh=object(), device=CPU)
    tt = TieredTable(master, 4, device=CPU)
    assert tt.delta_tap is None
    tapped = []
    tt.delta_tap = lambda name, units: tapped.append((name, units.tolist()))
    cache = tt.ensure(tt.make_cache(), np.array([1, 5]), mark_dirty=True)
    tt.flush(cache)
    assert tapped == [("table", [1, 5])]
    loop = TrainLoop(_make(slots=4), log_every=0)
    state = loop.tier.adopt(loop.trainer.init_state())
    loop.tier.flush_dirty(state)  # nothing dirty yet: lands nothing, raises nothing


def test_stale_staged_row_is_discarded():
    """A staged master row whose unit was written back after the stage
    gathered it must be re-gathered at install, not scattered stale."""
    master = HostMaster(TableState(table=torch.arange(16.0).reshape(8, 2), slots={}),
                        "dense")
    tt = TieredTable(master, 4, name="t", device=CPU)
    cache = tt.make_cache()
    vers = tt.master_ver[np.array([1])].copy()
    t_rows, _ = master.gather(np.array([1]))
    staged = (np.array([1]), vers, torch.from_numpy(t_rows.copy()), {}, None)
    # ...then the unit is flushed with a NEWER value before the install
    master.scatter(np.array([1]), np.full((1, 2), 99.0, np.float32), {})
    tt.master_ver[1] += 1
    cache = tt.ensure(cache, np.array([1]), staged=staged)
    assert torch.equal(cache.table[tt.slot_of[1]], torch.full((2,), 99.0))
    # a current staged row installs from the payload, not from the master
    vers = tt.master_ver[np.array([2])].copy()
    staged = (np.array([2]), vers, torch.full((1, 2), -5.0), {}, None)
    cache = tt.ensure(cache, np.array([2]), staged=staged)
    assert torch.equal(cache.table[tt.slot_of[2]], torch.full((2,), -5.0))


def test_async_refault_waits_for_inflight_flush():
    """Refaulting a unit whose eviction flush is still queued blocks on the
    drain barrier, then re-gathers the flushed (updated) value."""
    import threading

    master = HostMaster(TableState(table=torch.arange(16.0).reshape(8, 2), slots={}),
                        "dense")
    fq = _FlushQueue(depth=8, batch=8)
    tt = TieredTable(master, 2, name="t", flusher=fq, device=CPU)
    try:
        cache = tt.ensure(tt.make_cache(), np.array([0, 1]))  # both dirty
        cache.table[tt.slot_of[0]] = 7.0  # the step trained unit 0
        fq.pause()  # freeze the worker: the next flush stays queued
        cache = tt.ensure(cache, np.array([2]))  # evicts unit 0 -> enqueue
        assert tt.slot_of[0] < 0 and tt._pending[0] == 1
        out, done = {}, threading.Event()

        def refault():
            out["cache"] = tt.ensure(cache, np.array([0]))
            done.set()

        t = threading.Thread(target=refault, daemon=True)
        t.start()
        assert not done.wait(0.25)  # blocked on the drain barrier
        fq.resume()
        assert done.wait(5.0), "the refault never unblocked"
        t.join(5.0)
        assert torch.equal(out["cache"].table[tt.slot_of[0]], torch.full((2,), 7.0))
        np.testing.assert_array_equal(master.table[0], np.full(2, 7.0, np.float32))
    finally:
        fq.resume()
        fq.close()


def test_flush_worker_error_reraises_at_drain():
    """A failure on the flush worker is never swallowed: it re-raises at the
    next drain."""
    master = HostMaster(TableState(table=torch.zeros(8, 2), slots={}), "dense")
    fq = _FlushQueue()
    tt = TieredTable(master, 2, name="t", flusher=fq, device=CPU)
    try:
        cache = tt.ensure(tt.make_cache(), np.array([0, 1]))

        def broken(*a, **k):
            raise OSError("disk gone")

        master.scatter = broken
        tt.ensure(cache, np.array([2]))  # evicts a dirty unit -> the worker fails
        with pytest.raises(OSError, match="disk gone"):
            tt.drain()
    finally:
        fq.close()


def test_install_matches_master_rows_with_slots():
    """Faulted rows of a packed ``[C, S, 128]`` master and its slot plane
    land in the cache through ``scatter_write_rows`` (its plain version on
    the CPU) equal to the master's rows; a second fault reuses the path."""
    rng = np.random.default_rng(9)
    table = rng.normal(size=(32, 2, 128)).astype(np.float32)
    accum = rng.normal(size=(32, 2, 128)).astype(np.float32)
    master = convert.host_master_from_numpy(table, {"accum": accum}, layout="packed")
    tt = TieredTable(master, 8, name="t", device=CPU)
    units = np.array([3, 11, 20, 31])
    cache = tt.ensure(tt.make_cache(), units)
    s = tt.slot_of[units]
    np.testing.assert_array_equal(cache.table.numpy()[s], table[units])
    np.testing.assert_array_equal(cache.slots["accum"].numpy()[s], accum[units])
    more = np.array([0, 7])
    cache = tt.ensure(cache, more)
    np.testing.assert_array_equal(cache.table.numpy()[tt.slot_of[more]], table[more])


# -------------------------------------------------- checkpoints, resume ----


def test_checkpoint_matches_resident_checkpoint_bytes(tmp_path):
    """A tiered save is a resident save: the same arrays under the same
    keys, written through the flush-before-manifest barrier."""
    steps = 8
    roots = {}
    for tag, slots in (("res", None), ("tier", 4)):
        root = str(tmp_path / tag)
        TrainLoop(_make(slots=slots, param_backup_root=root,
                        param_backup_period=steps // 2),
                  log_every=0).run(seed=0, max_steps=steps)
        roots[tag] = root
    for step in (steps // 2, steps):
        a, ma = load_tables(roots["res"], step=step, device=CPU)
        b, mb = load_tables(roots["tier"], step=step, device=CPU)
        assert ma["arrays"] == mb["arrays"]  # the same CRCs, shapes, dtypes
        for name in a:
            assert torch.equal(a[name]["table"], b[name]["table"])


def test_async_flush_checkpoint_bytes_match_sync_control(tmp_path):
    """With the background flusher live, a mid-run save and the final save
    are byte-identical to a synchronous-flush run's."""
    steps = 12
    roots = {}
    for tag, async_flush in (("sync", 0), ("async", 1)):
        root = str(tmp_path / tag)
        loop = TrainLoop(_make(slots=3, tier_async_flush=async_flush,
                               param_backup_root=root,
                               param_backup_period=steps // 2), log_every=0)
        loop.run(seed=0, max_steps=steps)
        roots[tag] = root
    for step in (steps // 2, steps):
        _, ma = load_tables(roots["sync"], step=step, device=CPU)
        _, mb = load_tables(roots["async"], step=step, device=CPU)
        assert ma["arrays"] == mb["arrays"]


def test_preempt_and_resume_with_host_tier_parity_zero(tmp_path):
    """Preempt mid-run (drain + final tier-flushed save), then
    ``resume: auto``: the resumed run lands bit-exactly on the undisturbed
    run's tables, which equal the resident run's too."""
    from swiftsnails_tpu_torch.resilience.drill import make_trainer, run_loop

    workdir = str(tmp_path)
    steps, preempt_at, period = 24, 14, 5
    # 100 of the drill corpus' 128 words a table, batches of 32: every step
    # fits the budget and the run evicts
    tier = {"table_tier": "host", "tier_hbm_budget_mb": _budget_mb(100, 16 * 4),
            "tier_async_flush": 1, "batch_size": 32}
    _, control, _ = run_loop(make_trainer(workdir, device=CPU, **tier), max_steps=steps)
    root = os.path.join(workdir, "ck")
    loop1, _, _ = run_loop(make_trainer(
        workdir, device=CPU, param_backup_period=period, param_backup_root=root,
        chaos_spec=f"preempt@{preempt_at}", chaos_seed=11, **tier), max_steps=steps)
    assert loop1.preempted
    loop2, resumed, _ = run_loop(make_trainer(
        workdir, device=CPU, param_backup_period=period, param_backup_root=root,
        resume="auto", **tier), max_steps=steps)
    assert loop2._restored_step == preempt_at + 1
    assert loop2.tier.summary()["evictions"] > 0
    assert _tables_equal(control, resumed)
    _, plain, _ = run_loop(make_trainer(workdir, device=CPU, batch_size=32),
                           max_steps=steps)
    assert _tables_equal(plain, resumed)


@pytest.mark.parametrize("master_dtype", ["float32", "int8"])
def test_bitflip_drill_heals_from_the_newest_verified_checkpoint(tmp_path, master_dtype):
    """``tier_bitflip@7`` with ``tier_verify_period: 5`` and saves every 5
    steps: the sweep after the flip (step index 9) finds a corrupt plane and
    rebuilds it from the step-5 checkpoint, one ``cache_error`` ledger event
    with ``source: "tier"`` records it, and the run ends finite with clean
    digests."""
    ledger_path = str(tmp_path / "l.jsonl")
    loop = TrainLoop(_make(slots=4, param_backup_root=str(tmp_path / "ck"),
                           param_backup_period=5, tier_verify_period=5,
                           chaos_spec="tier_bitflip@7", chaos_seed=3,
                           tier_master_dtype=master_dtype, ledger_path=ledger_path),
                     log_every=0)
    state = loop.run(seed=0, max_steps=12)
    events = Ledger(ledger_path).records("cache_error")
    tier_events = [e for e in events if e.get("source") == "tier"]
    assert len(tier_events) == 1, events
    assert tier_events[0]["step"] == 9 and tier_events[0]["rebuilt_from_step"] == 5
    assert loop.tier.verify() == {}
    assert torch.isfinite(state.in_table.table).all()
    assert loop.tier.summary()["master_dtype"] == master_dtype


def test_run_record_carries_the_tiered_block(tmp_path):
    """With telemetry on, the ledger's run record carries the tier summary
    and the trace holds a ``tier-fault`` span a step."""
    ledger_path = str(tmp_path / "l.jsonl")
    loop = TrainLoop(_make(slots=4, telemetry=1, ledger_path=ledger_path,
                           trace_path=str(tmp_path / "t.json")), log_every=0)
    loop.run(seed=0, max_steps=6)
    rec = Ledger(ledger_path).latest("run")
    assert rec["tiered"]["faults"] > 0 and rec["tiered"]["tables"]["in_table"]["budget_slots"] == 4
    spans = [e for e in loop.tracer.events() if e.get("name") == "tier-fault"]
    assert len(spans) == 6


# ------------------------------------------------ CTR against the JAX one ---

CTR_CASES = {"logreg": ({}, 1), "fm": ({"factor_dim": 4}, 5),
             "widedeep": ({"embed_dim": 8, "hidden_dims": "32,16"}, 9)}


@pytest.mark.parametrize("packed", [1, 0], ids=["packed_small", "2d"])
@pytest.mark.parametrize("model", sorted(CTR_CASES))
def test_ctr_tiered_against_jax_tiered(model, packed):
    """Each package trains the model tiered from one start state (JAX's,
    carried over) on the same batches: the tier counters are EQUAL (the id
    stream is the same), and each table's change agrees within
    ``DELTA_RTOL`` of its largest change, as in ``tests/test_torch_ctr.py``."""
    over, dim = CTR_CASES[model]
    units = 100 if dim == 1 and packed else 200
    unit_bytes = 1024 if packed else 2 * dim * 4  # AdaGrad: param + accumulator
    labels, feats, _ = ctr.synth_ctr(2048, 6, 50, seed=3)
    feats[::5, 2] = ctr.PAD
    conf = {"num_fields": "6", "capacity": str(1 << 14), "learning_rate": "0.2",
            "optimizer": "adagrad", "batch_size": "32", "num_iters": "1", "seed": "0",
            "packed": str(packed), "table_tier": "host",
            "tier_hbm_budget_mb": str(units * unit_bytes / (1 << 20)),
            **{k: str(v) for k, v in over.items()}}
    jt = jax_get_model(model)(JaxConfig(conf), data=(labels, feats))
    tt = get_model(model)(Config(conf), data=(labels, feats), device=CPU)
    js = jt.init_state()
    sums = ({k: np.asarray(v) for k, v in js.opt[0].sum_of_squares.items()}
            if js.dense else None)
    extra = ({"table_slots": {k: np.asarray(v) for k, v in js.table.slots.items()}}
             if js.table.slots else {})
    start = convert.ctr_state_from_numpy(
        np.asarray(js.table.table), {k: np.asarray(v) for k, v in js.dense.items()},
        sums, device=CPU, **extra)
    jt.init_state = lambda: js
    tt.init_state = lambda: start
    t0 = np.asarray(js.table.table).copy()
    jl, tl = JaxTrainLoop(jt, log_every=0), TrainLoop(tt, log_every=0)
    jend, tend = jl.run(seed=0, max_steps=6), tl.run(seed=0, max_steps=6)
    keys = ("lookups", "hits", "faults", "faulted_rows", "evictions", "flushed_rows")
    js_, ts_ = jl.tier.summary(), tl.tier.summary()
    assert [js_[k] for k in keys] == [ts_[k] for k in keys]
    assert ts_["evictions"] > 0
    want = np.asarray(jend.table.table) - t0
    got = tend.table.table.numpy() - t0
    assert np.abs(got - want).max() <= DELTA_RTOL * np.abs(want).max()
    assert tend.table.table.device.type == "cpu"
    # eval takes the host-resident master state
    assert 0.0 <= tt.eval_auc(tend, limit=256) <= 1.0


# ---------------------------------------------------- the tiered servant ---


def _serve_tables(v=512, d=16, seed=3):
    rng = np.random.default_rng(seed)
    return {"in_table": rng.normal(size=(v, d)).astype(np.float32)}


def test_serving_tier_pull_and_topk_equal_jax():
    """A 128-slot tier over a 512-row master: pulls equal the JAX tiered
    servant's and the resident ones bit for bit across enough rounds to
    evict, with equal tier counters; the master-streaming topk returns the
    JAX servant's ids and scores."""
    tabs = _serve_tables()
    budget = 128 * 16 * 4 / float(1 << 20)
    jsv = JServant(dict(tabs), cache_rows=0, tier_hbm_budget_mb=budget)
    psv = Servant(dict(tabs), cache_rows=0, tier_hbm_budget_mb=budget, device=CPU)
    res = Servant(dict(tabs), cache_rows=0, device=CPU)
    rng = np.random.default_rng(4)
    try:
        assert psv.tier["in_table"].budget == 128
        for _ in range(8):
            ids = rng.integers(0, 512, size=64)
            got = psv.pull(ids)
            np.testing.assert_array_equal(got, jsv.pull(ids))
            np.testing.assert_array_equal(got, res.pull(ids))
        js, ps = jsv.stats()["tiered"], psv.stats()["tiered"]
        for key in ("lookups", "hits", "faults", "faulted_rows", "evictions"):
            assert js[key] == ps[key], key
        assert ps["evictions"] > 0 and ps["flushed_rows"] == 0
        assert psv.health()["tier"]["in_table"]["resident"] == 128
        for _ in range(3):
            q = rng.normal(size=16).astype(np.float32)
            a, b = jsv.topk(q, k=8), psv.topk(q, k=8)
            assert [i for i, _ in a] == [i for i, _ in b]
            np.testing.assert_allclose([s for _, s in a], [s for _, s in b],
                                       rtol=0, atol=1e-6)
            assert [i for i, _ in b] == [i for i, _ in res.topk(q, k=8)]
    finally:
        jsv.close()
        psv.close()
        res.close()


def test_serving_tier_topk_keeps_the_tie_order():
    """Tied scores across master tiles come back lower id first, as the
    resident scan gives them."""
    tabs = {"t": np.zeros((40, 8), np.float32)}
    with Servant(dict(tabs), cache_rows=0, tier_hbm_budget_mb=8 * 32 / (1 << 20),
                 topk_tile_rows=16, device=CPU) as sv:
        got = sv.topk(np.ones(8, np.float32), k=10, table="t", normalize=False)
    assert [i for i, _ in got] == list(range(10))


def test_serving_tier_apply_rows_refaults():
    """A delta lands in the host master (digests kept true), bumps the
    generation, drops the resident slots, and the next pull refaults the
    fresh rows bit for bit."""
    tabs = _serve_tables()
    with Servant(dict(tabs), cache_rows=0, device=CPU,
                 tier_hbm_budget_mb=64 * 16 * 4 / float(1 << 20)) as sv:
        ids = np.arange(0, 40, dtype=np.int64)
        sv.pull(ids)  # resident now
        tt = sv.tier["in_table"]
        assert (tt.slot_of[ids] >= 0).all()
        vals = np.random.default_rng(6).normal(size=(40, 16)).astype(np.float32)
        v0 = sv.version
        assert sv.apply_rows({"in_table": (ids, vals)}) == v0 + 1
        assert (tt.slot_of[ids] < 0).all() and (tt.master_ver[ids] == 1).all()
        faults = sv.stats()["tiered"]["faulted_rows"]
        np.testing.assert_array_equal(sv.pull(ids), vals)
        assert sv.stats()["tiered"]["faulted_rows"] == faults + 40
        assert tt.master.verify() == []


def test_fleet_passes_the_tier_and_applies_rows_to_each_replica(tmp_path):
    """``Fleet.from_checkpoint`` passes the tier keys to every replica (each
    owns its host master and cache); a fleet delta lands in each replica's
    master at one epoch and every replica then serves the new rows."""
    root = str(tmp_path / "ck")
    tr = _make(slots=4, param_backup_root=root, param_backup_period=4)
    TrainLoop(tr, log_every=0).run(seed=0, max_steps=4)
    fleet = Fleet.from_checkpoint(root, tr.config, replicas=2, device=CPU, cache_rows=0)
    try:
        reps = fleet.replicas()
        assert len(reps) == 2
        masters = [r.servant.tier["in_table"].master for r in reps]
        assert all(r.servant.tier["in_table"].budget == 4 for r in reps)
        assert masters[0] is not masters[1]
        ids = np.array([1, 2, 3], np.int64)
        vals = np.full((3, 8), 0.25, np.float32)
        epoch = fleet.apply_rows({"in_table": (ids, vals)})
        for r in reps:
            assert r.servant.version == epoch
            np.testing.assert_array_equal(r.servant.pull(ids), vals)
    finally:
        fleet.close()


def test_from_checkpoint_serves_a_tiered_run(tmp_path):
    """``Servant.from_checkpoint`` with ``table_tier: host`` serves a tiered
    run's checkpoint from a host master through the cache: pulls equal the
    trained rows, with faults."""
    root = str(tmp_path / "ck")
    tr = _make(slots=4, param_backup_root=root, param_backup_period=8)
    state = TrainLoop(tr, log_every=0).run(seed=0, max_steps=8)
    with Servant.from_checkpoint(root, tr.config, cache_rows=0, device=CPU) as sv:
        assert sv.tier["in_table"].budget == 4 and sv.step == 8
        ids = np.array([3, 0, 1, 2], np.int32)
        np.testing.assert_array_equal(sv.pull(ids), state.in_table.table.numpy()[ids])
        ids = np.array([9, 10, 0, 11], np.int32)  # the pads read row 0: 4 units
        np.testing.assert_array_equal(sv.pull(ids), state.in_table.table.numpy()[ids])
        assert sv.stats()["tiered"]["faults"] > 0
