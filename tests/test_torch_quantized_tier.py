"""Quantized host masters (``tier_master_dtype: int8``) and the masters'
integrity digests: the port against the JAX package's ``tiered/store.py``,
on the CPU.

The int8 helpers are numpy in both packages, so codes, scales and dither
must be bit-equal; the keyed digests are seeded with ``hash(plane)``, which
Python salts per process, so the two packages' digests are compared in one
process. The storage contract then as in ``tests/test_quantized_tier.py``:
masters live as int8 code planes + per-unit f32 scale sidebands (>= 2x rows
per host GB), the digests cover both planes incrementally through scatter,
re-quantization is deterministic given the unit's write generation, and
everything outside the host store stays f32 — the cache, ``state()`` and
every checkpoint.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from swiftsnails_tpu.parallel.store import TableState as JTableState
from swiftsnails_tpu.tiered import store as jax_store
from swiftsnails_tpu_torch import convert
from swiftsnails_tpu_torch.framework.checkpoint import load_tables
from swiftsnails_tpu_torch.framework.quality import paired_corpus
from swiftsnails_tpu_torch.framework.trainer import TrainLoop
from swiftsnails_tpu_torch.models.word2vec import Word2VecTrainer
from swiftsnails_tpu_torch.parallel.store import TableState
from swiftsnails_tpu_torch.serving.engine import Servant
from swiftsnails_tpu_torch.tiered.store import (
    HostMaster,
    _hash_weights,
    _np_dequant_unit_rows,
    _np_hash_uniform,
    _np_quant_unit_rows,
    _rows_hash,
    resolve_master_dtype,
)
from swiftsnails_tpu_torch.utils.config import Config

CPU = "cpu"
torch.set_num_threads(1)


def _planes(n=32, d=8, seed=0, with_slots=True):
    rng = np.random.default_rng(seed)
    slots = {"m": rng.normal(size=(n, d)).astype(np.float32)} if with_slots else {}
    return rng.normal(size=(n, d)).astype(np.float32), slots


def _pair(seed=0, master_dtype="float32", **kw):
    """Both packages' masters over the same numpy planes."""
    table, slots = _planes(seed=seed, **kw)
    j = jax_store.HostMaster(
        JTableState(table=jnp.asarray(table), slots={k: jnp.asarray(v) for k, v in slots.items()}),
        "dense", master_dtype=master_dtype)
    p = convert.host_master_from_numpy(table, slots, layout="dense",
                                       master_dtype=master_dtype)
    return j, p


def _master(seed=0, master_dtype="int8", **kw):
    table, slots = _planes(seed=seed, **kw)
    return convert.host_master_from_numpy(table, slots, layout="dense",
                                          master_dtype=master_dtype)


def test_resolve_master_dtype():
    for name in (None, "float32", "f32", "int8", "s8", "INT8 "):
        assert resolve_master_dtype(name) == jax_store.resolve_master_dtype(name)
    assert resolve_master_dtype("s8") == "int8"
    with pytest.raises(ValueError):
        resolve_master_dtype("int4")


@pytest.mark.parametrize("shape", [(6, 16), (5, 2, 128), (9, 1), (3, 4)])
@pytest.mark.parametrize("dither", [False, True])
def test_int8_helpers_bit_equal_to_jax(shape, dither):
    """Codes, scales, the hash dither and the dequantized rows equal the
    JAX helpers' bit for bit (zero units, single-lane units)."""
    rng = np.random.default_rng(sum(shape) + dither)
    rows = (rng.normal(size=shape) * 3).astype(np.float32)
    if shape[0] > 2:
        rows[2] = 0.0
    n, per = shape[0], int(np.prod(shape[1:]))
    units = rng.integers(0, 1 << 20, n)
    gens = rng.integers(0, 50, n).astype(np.uint32)
    u = _np_hash_uniform(units, gens, per) if dither else None
    if dither:
        np.testing.assert_array_equal(u, jax_store._np_hash_uniform(units, gens, per))
    codes, scales = _np_quant_unit_rows(rows, u)
    jcodes, jscales = jax_store._np_quant_unit_rows(rows, u)
    np.testing.assert_array_equal(codes, jcodes)
    np.testing.assert_array_equal(scales, jscales)
    assert codes.dtype == np.int8 and scales.dtype == np.float32
    np.testing.assert_array_equal(
        _np_dequant_unit_rows(codes, scales, np.float32),
        jax_store._np_dequant_unit_rows(jcodes, jscales, np.float32))


def test_rows_hash_equals_jax_and_weights_are_odd():
    """The regrouped hash (per-position byte sums dotted with the weights)
    equals the JAX package's per-element sum mod 2^64."""
    rng = np.random.default_rng(4)
    w = _hash_weights(64, 12345)
    np.testing.assert_array_equal(w, jax_store._hash_weights(64, 12345))
    assert (w & np.uint64(1)).all()
    for n in (1, 7, 300):
        rows = rng.normal(size=(n, 16)).astype(np.float32)
        assert _rows_hash(rows, w) == jax_store._rows_hash(rows, w)
    assert _rows_hash(rows[:0], w) == 0


@pytest.mark.parametrize("master_dtype", ["float32", "int8"])
def test_digests_equal_jax_through_scatters(master_dtype):
    """Both packages' masters over the same planes hold equal stored planes
    and equal per-plane digests (in one process: the weights are seeded with
    ``hash(plane)``), after construction and after the same scatters."""
    j, p = _pair(seed=3, master_dtype=master_dtype)
    assert j._digests == p._digests
    rng = np.random.default_rng(8)
    for _ in range(4):
        units = np.unique(rng.integers(0, 32, 6))
        t = rng.normal(size=(len(units), 8)).astype(np.float32)
        s = {"m": rng.normal(size=(len(units), 8)).astype(np.float32)}
        j.scatter(units, t, s)
        p.scatter(units, t, s)
    assert j._digests == p._digests
    np.testing.assert_array_equal(j.table, p.table)
    for k in p.scales:
        np.testing.assert_array_equal(j.scales[k], p.scales[k])
    assert j.verify() == p.verify() == []


def test_capacity_at_least_2x_and_budget_math_unchanged():
    f32 = _master(master_dtype="float32")
    q = _master()
    assert q.unit_nbytes == f32.unit_nbytes
    assert f32.host_unit_nbytes >= 2 * q.host_unit_nbytes
    assert q.table.dtype == np.int8
    _, jq = _pair(master_dtype="int8")
    assert (q.unit_nbytes, q.host_unit_nbytes) == (jq.unit_nbytes, jq.host_unit_nbytes)


def test_gather_dequant_error_bound():
    want, _ = _planes(seed=1)
    q = _master(seed=1)
    t_rows, _ = q.gather(np.arange(want.shape[0]))
    step = np.abs(want).max(axis=1, keepdims=True) / 127.0
    assert t_rows.dtype == want.dtype
    assert np.all(np.abs(t_rows - want) <= 0.5 * step + 1e-7)


def test_digest_detects_code_and_scale_flips():
    """A single bit flip in the int8 code plane or in a scale sideband is
    named by verify()."""
    m = _master(seed=2)
    assert m.verify() == []
    m.table.view(np.uint8).reshape(-1)[7] ^= 1 << 2
    assert "table" in m.verify()
    m2 = _master(seed=2)
    m2.scales["table"].view(np.uint8)[9] ^= 1 << 4
    assert "table/scale" in m2.verify()
    m3 = _master(seed=2)
    m3.scales["slots/m"].view(np.uint8)[3] ^= 1 << 1
    assert "slots/m/scale" in m3.verify()
    m4 = _master(seed=2, master_dtype="float32")
    m4.slots["m"].view(np.uint8).reshape(-1)[100] ^= 1
    assert m4.verify() == ["slots/m"]


def test_scatter_keeps_incremental_digests_consistent():
    m = _master(seed=3)
    rng = np.random.default_rng(4)
    for _ in range(5):
        units = np.unique(rng.integers(0, 32, 6))
        m.scatter(units, rng.normal(size=(len(units), 8)).astype(np.float32),
                  {"m": rng.normal(size=(len(units), 8)).astype(np.float32)})
    assert m.verify() == []
    t_rows, _ = m.gather(np.arange(8))
    assert np.all(np.isfinite(t_rows))


def test_scatter_requant_deterministic_given_generation():
    def replay():
        m = _master(seed=5)
        rng = np.random.default_rng(6)
        for _ in range(4):
            units = np.unique(rng.integers(0, 32, 8))
            m.scatter(units, rng.normal(size=(len(units), 8)).astype(np.float32),
                      {"m": rng.normal(size=(len(units), 8)).astype(np.float32)})
        return m

    a, b = replay(), replay()
    np.testing.assert_array_equal(a.table, b.table)
    np.testing.assert_array_equal(a.scales["table"], b.scales["table"])
    for k in a.slots:
        np.testing.assert_array_equal(a.slots[k], b.slots[k])
    assert np.array_equal(a._qgen, b._qgen) and a._qgen.max() > 0


def test_state_dequantizes_to_f32_and_reload_requants():
    m = _master(seed=7)
    out = m.state()
    assert out.table.dtype == torch.float32
    assert all(v.dtype == torch.float32 for v in out.slots.values())
    m2 = _master(seed=8)
    m2.reload(out)
    assert m2.verify() == []
    step = out.table.abs().amax(dim=1, keepdim=True) / 127.0
    assert ((m2.state().table - out.table).abs() <= step + 1e-7).all()


def test_np_quant_helpers_round_trip_and_zero_rows():
    rows = np.random.default_rng(9).normal(size=(6, 16)).astype(np.float32)
    rows[2] = 0.0
    codes, scales = _np_quant_unit_rows(rows)
    assert codes.dtype == np.int8 and scales[2] == 0.0 and np.all(codes[2] == 0)
    back = _np_dequant_unit_rows(codes, scales, np.float32)
    step = np.abs(rows).max(axis=1, keepdims=True) / 127.0
    assert np.all(np.abs(back - rows) <= 0.5 * step + 1e-7)


def test_bf16_masters_keep_their_bits():
    """numpy has no bfloat16: a bf16 plane is stored as its int16 bits and
    comes back bit for bit through gather, scatter and state; an int8
    master of a bf16 plane hands out bf16 rows."""
    t = torch.randn(16, 2, 128).to(torch.bfloat16)
    m = HostMaster(TableState(table=t, slots={}), "packed")
    rows, _ = m.gather(np.array([3, 5]))
    assert torch.equal(torch.from_numpy(rows).view(torch.bfloat16), t[[3, 5]])
    new = torch.full((2, 2, 128), 0.5, dtype=torch.bfloat16)
    m.scatter(np.array([3, 5]), new.view(torch.int16).numpy(), {})
    want = t.clone()
    want[[3, 5]] = new
    assert m.state().table.dtype == torch.bfloat16
    assert torch.equal(m.state().table, want) and m.verify() == []
    q = HostMaster(TableState(table=t, slots={}), "packed", master_dtype="int8")
    assert q.state().table.dtype == torch.bfloat16
    assert q.unit_nbytes == 2 * 128 * 2


# ------------------------------------------------ training + checkpoints ---


def _make(slots=None, corpus=None, master_dtype=None, **over):
    ids, vocab = corpus if corpus is not None else paired_corpus(n_pairs=8, reps=400, seed=0)
    cfg = Config({"dim": "8", "window": "1", "negatives": "1", "learning_rate": "0.5",
                  "num_iters": "4", "batch_size": "1", "subsample": "0", "seed": "0",
                  "packed": "0", "steps_per_call": "1"})
    for k, v in over.items():
        cfg.set(k, str(v))
    if slots is not None:
        cfg.set("table_tier", "host")
        cfg.set("tier_hbm_budget_mb", str(2 * slots * 8 * 4 / float(1 << 20)))
    if master_dtype is not None:
        cfg.set("tier_master_dtype", master_dtype)
    return Word2VecTrainer(cfg, corpus_ids=ids, vocab=vocab, device=CPU)


def test_quantized_run_trains_with_async_flush_and_clean_digests():
    steps = 24
    f32 = TrainLoop(_make(slots=4, tier_async_flush=1), log_every=0)
    a = f32.run(seed=0, max_steps=steps)
    q = TrainLoop(_make(slots=4, tier_async_flush=1, master_dtype="int8"), log_every=0)
    b = q.run(seed=0, max_steps=steps)
    s = q.tier.summary()
    assert s["master_dtype"] == "int8" and s["async_flush"] is True
    assert q.tier.verify() == {}
    at, bt = a.in_table.table.numpy(), b.in_table.table.numpy()
    rel = np.abs(at - bt).mean() / max(np.abs(at).mean(), 1e-12)
    assert np.all(np.isfinite(bt)) and rel < 0.05, rel


def test_quantized_checkpoint_is_format_identical_f32(tmp_path):
    steps = 8
    roots, states = {}, {}
    for tag, md in (("f32", None), ("int8", "int8")):
        root = str(tmp_path / tag)
        states[tag] = TrainLoop(
            _make(slots=4, master_dtype=md, param_backup_root=root,
                  param_backup_period=steps // 2), log_every=0).run(seed=0, max_steps=steps)
        roots[tag] = root
    a, _ = load_tables(roots["f32"], step=steps, device=CPU)
    b, _ = load_tables(roots["int8"], step=steps, device=CPU)
    assert set(a) == set(b)
    for name in a:
        x, y = a[name]["table"], b[name]["table"]
        assert x.shape == y.shape and x.dtype == y.dtype == torch.float32
    assert torch.equal(b["in_table"]["table"], states["int8"].in_table.table)


def test_f32_ckpt_int8_tier_f32_ckpt_round_trip(tmp_path):
    root = str(tmp_path / "ck")
    steps = 8
    f32_state = TrainLoop(_make(param_backup_root=root, param_backup_period=steps // 2),
                          log_every=0).run(seed=0, max_steps=steps)
    want = f32_state.in_table.table.numpy()
    m = convert.host_master_from_numpy(want, layout="dense", master_dtype="int8")
    trip1 = m.state().table.numpy()
    step = np.abs(want).max(axis=1, keepdims=True) / 127.0
    assert np.all(np.abs(trip1 - want) <= 0.5 * step + 1e-7)
    m2 = convert.host_master_from_numpy(trip1, layout="dense", master_dtype="int8")
    assert np.all(np.abs(m2.state().table.numpy() - trip1) <= step + 1e-7)


def test_quantized_serving_pull_matches_requant(tmp_path):
    """Serve a quantized-tier checkpoint through the tiered read path: the
    pulls equal the requant->dequant of the checkpointed f32 rows bit for
    bit (the JAX lane's ``serve_requant_exact``)."""
    root = str(tmp_path / "ck")
    steps = 8
    tr = _make(slots=4, master_dtype="int8", param_backup_root=root,
               param_backup_period=steps // 2)
    state = TrainLoop(tr, log_every=0).run(seed=0, max_steps=steps)
    probe = np.arange(4, dtype=np.int64)
    with Servant.from_checkpoint(root, tr.config, cache_rows=0, device=CPU) as served:
        pulled = served.pull(probe, table="in_table")
    want = state.in_table.table.numpy()[probe]
    codes, scales = _np_quant_unit_rows(want)
    np.testing.assert_array_equal(pulled, _np_dequant_unit_rows(codes, scales, want.dtype))
