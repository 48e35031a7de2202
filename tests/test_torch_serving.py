"""The port's serving read path against the JAX package's, on the CPU.

The same numpy tables, made from a seed, go to the JAX ``Servant`` and to
the port's (``device="cpu"``, where ``pull_rows`` runs ``gather_rows``'
plain version): pulls bit-equal with the same row / pad / cache counters,
``topk_tiled`` within rtol 1e-5 with the ids in JAX's tie order, CTR scores
within rtol 1e-5 on both table planes, ``normalize_table`` bit-equal,
``apply_rows`` bit-equal, and ``stats()`` / ``health()`` with JAX's keys.
Then the port alone: ``load_tables`` over its own checkpoints (bf16, a
corrupt step walked past), the availability ladder, sheds, reloads, the
serve lane and the serving gate.
"""

import threading
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from swiftsnails_tpu.models.registry import get_model as jax_get_model
from swiftsnails_tpu.serving import Servant as JServant
from swiftsnails_tpu.serving import normalize_table as jax_normalize_table
from swiftsnails_tpu.serving import topk_tiled as jax_topk_tiled
from swiftsnails_tpu.utils.config import Config as JConfig

from swiftsnails_tpu_torch import convert
from swiftsnails_tpu_torch.framework.checkpoint import (
    CheckpointError,
    load_tables,
    save_checkpoint,
)
from swiftsnails_tpu_torch.models.registry import get_model
from swiftsnails_tpu_torch.ops import rowdma
from swiftsnails_tpu_torch.serving import (
    Overloaded,
    Servant,
    Unavailable,
    normalize_table,
    pull_rows,
    topk_tiled,
)
from swiftsnails_tpu_torch.serving.bench_lane import serve_bench
from swiftsnails_tpu_torch.serving.breaker import CLOSED, OPEN
from swiftsnails_tpu_torch.serving.kernels import resolve_comm_dtype, whole_words
from swiftsnails_tpu_torch.telemetry.ledger import (
    Ledger,
    check_regression,
    render_failures,
)
from swiftsnails_tpu_torch.utils.config import Config

CPU = "cpu"


def _table(cap, dim, seed=0):
    return np.random.default_rng(seed).standard_normal((cap, dim)).astype(np.float32)


def _pair(tables, **kw):
    """The JAX servant and the port's over the same numpy tables."""
    return JServant(tables, **kw), Servant(tables, device=CPU, **kw)


def _counters(sv):
    reg = sv.registry
    return {
        "rows": reg.counter("serve.pull.rows").value,
        "pad_rows": reg.counter("serve.pull.pad_rows").value,
        "hits": sv.cache.hits, "misses": sv.cache.misses, "cached": len(sv.cache),
        "requests": reg.counter("serve.pull.requests").value,
    }


# ------------------------------------------------------------------ pulls ---


@pytest.mark.parametrize("buckets", [(4,), (8, 64)])
@pytest.mark.parametrize("dim", [16, 64])
def test_pulls_bit_equal_with_jax_counters(buckets, dim):
    table = _table(4096, dim)
    rng = np.random.default_rng(1)
    requests = [rng.integers(0, 4096, n).astype(np.int32) for n in (1, 3, 7, 64, 150)]
    requests.append(requests[2])  # a repeat: served from the cache
    jsv, sv = _pair({"t": table}, batch_buckets=buckets, cache_rows=128)
    with jsv, sv:
        for ids in requests:
            want = jsv.pull(ids)
            got = sv.pull(ids)
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(got, table[ids])
        assert _counters(sv) == _counters(jsv)
        assert sv.stats()["pad_rows"] == jsv.stats()["pad_rows"]


def test_pad_rows_never_cached_or_counted():
    table = _table(16, 4, seed=1)
    with Servant({"t": table}, batch_buckets=(4,), cache_rows=64, device=CPU) as sv:
        got = sv.pull(np.array([5, 6, 7], np.int32))  # pads 3 -> 4
        np.testing.assert_array_equal(got, table[[5, 6, 7]])
        assert sv.registry.counter("serve.pull.rows").value == 3
        assert sv.registry.counter("serve.pull.pad_rows").value == 1
        assert ("t", 0) not in sv.cache._rows and len(sv.cache) == 3


def test_pull_rows_routes_by_row_width(monkeypatch):
    """Whole 16-byte words -> ``gather_rows`` (its plain version on the CPU),
    else ``index_select``; decided by the shape, before any launch."""
    calls = []
    real = rowdma.gather_rows
    monkeypatch.setattr(rowdma, "gather_rows",
                        lambda t, r: calls.append(tuple(t.shape)) or real(t, r))
    rows = torch.tensor([3, 1, 3], dtype=torch.int32)
    for dim, routed in ((200, True), (16, True), (17, False), (1, False), (4, True)):
        t = torch.from_numpy(_table(8, dim))
        assert whole_words(t) == routed
        torch.testing.assert_close(pull_rows(t, rows), t[rows.long()], rtol=0, atol=0)
        assert (calls[-1:] == [(8, dim)]) == routed
        calls.clear()
    assert not whole_words(torch.zeros((8, 4), dtype=torch.float16))


def test_bf16_wire_is_bit_equal_to_jax():
    table = _table(64, 16) * 3.3
    rows = np.array([0, 5, 63, 5], np.int32)
    got = pull_rows(torch.from_numpy(table), torch.from_numpy(rows), comm_dtype="bf16")
    want = np.asarray(jnp.asarray(table[rows]).astype(jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(got.numpy(), want)
    assert not np.array_equal(want, table[rows])  # the wire did round


@pytest.mark.parametrize("comm,raises", [
    ("int8", NotImplementedError), ("int4", NotImplementedError),
    ("int4/16", NotImplementedError), ("bogus", ValueError)])
def test_unported_wire_and_mesh_raise(comm, raises):
    with pytest.raises(raises, match="comm_dtype|unknown"):
        resolve_comm_dtype(comm)
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        pull_rows(torch.zeros((4, 4)), torch.zeros(1, dtype=torch.int32), mesh=object())


# ------------------------------------------------------------------- topk ---


def _topk_pair(table, queries, k, tile_rows, normalize=True):
    js, ji = jax_topk_tiled(jnp.asarray(table), jnp.asarray(queries), k=k,
                            tile_rows=tile_rows, normalize=normalize)
    ps, pi = topk_tiled(torch.from_numpy(table), torch.from_numpy(queries), k=k,
                        tile_rows=tile_rows, normalize=normalize)
    return (np.asarray(js), np.asarray(ji)), (ps.numpy(), pi.numpy())


@pytest.mark.parametrize("cap,tile,k", [
    (256, 64, 10),     # tiles divide the capacity
    (250, 64, 10),     # a padded last tile
    (1000, 4096, 7),   # one tile (tile_rows above the capacity)
    (12, 5, 40),       # k above the capacity: k = C
])
@pytest.mark.parametrize("normalize", [True, False])
def test_topk_tiled_matches_jax(cap, tile, k, normalize):
    table = _table(cap, 24, seed=cap)
    queries = np.random.default_rng(7).standard_normal((5, 24)).astype(np.float32)
    (js, ji), (ps, pi) = _topk_pair(table, queries, k, tile, normalize)
    assert ps.shape == js.shape == (5, min(k, cap))
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_allclose(ps, js, rtol=1e-5, atol=1e-6)
    assert ps.dtype == np.float32 and pi.dtype == np.int32


@pytest.mark.parametrize("normalize", [True, False])
def test_topk_ties_take_jax_order(normalize):
    """Zero rows (as in a fresh word2vec ``out_table``) tie at 0 and, raw,
    duplicated integer rows tie exactly: the ids come in JAX's order, the
    lower id first, across tile borders too."""
    cap, dim = 70, 8
    table = np.zeros((cap, dim), np.float32)
    rng = np.random.default_rng(3)
    dup = rng.integers(-2, 3, dim).astype(np.float32)
    for i in (5, 17, 33, 34, 61):
        table[i] = dup
    table[40] = -dup
    queries = np.stack([dup, np.zeros(dim, np.float32), -dup])
    (js, ji), (ps, pi) = _topk_pair(table, queries, 9, 16, normalize)
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_allclose(ps, js, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(pi[0, :5], [5, 17, 33, 34, 61])
    np.testing.assert_array_equal(pi[1], np.arange(9))  # every score is 0


def test_servant_topk_matches_jax_and_excludes():
    table = _table(300, 16, seed=4)
    jsv, sv = _pair({"t": table}, batch_buckets=(4, 8), topk_tile_rows=64)
    with jsv, sv:
        for row in (0, 7, 299):
            q = table[row]
            want = jsv.topk(q, k=5, exclude=(row,))
            got = sv.topk(q, k=5, exclude=(row,))
            assert [i for i, _ in got] == [i for i, _ in want]
            np.testing.assert_allclose([s for _, s in got], [s for _, s in want], rtol=1e-5)
            assert row not in [i for i, _ in got] and len(got) == 5
        assert sv.stats()["pad_rows"] == jsv.stats()["pad_rows"]


# ---------------------------------------------------------- normalization ---


def _jax_ctr(model, packed, **extra):
    keys = {"model": model, "num_fields": "5", "capacity": "512", "packed": str(packed),
            "seed": "3", "init_scale": "1.0", "factor_dim": "3", "embed_dim": "4",
            "hidden_dims": "8,4", **{k: str(v) for k, v in extra.items()}}
    data = (np.zeros(0, np.float32), np.zeros((0, 5), np.int32))
    jtr = jax_get_model(model)(JConfig(dict(keys)), mesh=None, data=data)
    ptr = get_model(model)(Config(dict(keys)), data=data, device=CPU)
    return keys, jtr, ptr


@pytest.mark.parametrize("layout", ["dense", "packed", "packed_small"])
def test_normalize_table_bit_equal(layout):
    rng = np.random.default_rng(5)
    if layout == "dense":
        plane, dim, cap = rng.standard_normal((40, 24)).astype(np.float32), 24, None
    elif layout == "packed":
        plane, dim, cap = rng.standard_normal((40, 2, 128)).astype(np.float32), 200, None
    else:
        plane, dim, cap = rng.standard_normal((13, 2, 128)).astype(np.float32), 17, 100
    want = np.asarray(jax_normalize_table(plane, dim, layout, capacity=cap))
    got = normalize_table(torch.from_numpy(plane), dim, layout, capacity=cap)
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------------------ score ---


@pytest.mark.parametrize("packed", [1, 0])
@pytest.mark.parametrize("model", ["logreg", "fm", "widedeep"])
def test_score_matches_jax_through_a_port_checkpoint(tmp_path, model, packed):
    """The JAX trainer's initial state goes to the JAX servant directly and
    to the port's through ``convert`` -> the port's checkpoint ->
    ``Servant.from_checkpoint`` on the CPU: scores within rtol 1e-5."""
    keys, jtr, ptr = _jax_ctr(model, packed)
    jstate = jtr.init_state()
    plane = np.asarray(jstate.table.table)
    jdense = dict(jstate.dense)
    if "bias" in jdense:
        jdense["bias"] = jnp.asarray(0.25, jnp.float32)
    dense = {k: np.asarray(v) for k, v in jdense.items()}
    layout = "packed_small" if jtr.packed else "dense"
    assert ptr.packed == jtr.packed
    jtables = {"table": np.asarray(jax_normalize_table(
        plane, jtr.table_dim, layout, capacity=jtr.capacity))}
    slots = ({k: np.asarray(v) for k, v in jstate.table.slots.items()}
             if plane.ndim == 2 else None)
    state = convert.ctr_state_from_numpy(plane, dense, device=CPU, table_slots=slots)
    root = str(tmp_path / "ck")
    save_checkpoint(root, state, step=4)
    rng = np.random.default_rng(9)
    feats = rng.integers(0, 1 << 20, size=(11, 5)).astype(np.int32)
    feats[0, 3] = feats[4, 0] = -1  # PAD fields: masked as in training
    with JServant(jtables, scorer=jtr, dense=jdense, default_table="table",
                  batch_buckets=(4, 8)) as jsv, \
            Servant.from_checkpoint(root, Config(dict(keys)), device=CPU,
                                    batch_buckets=(4, 8)) as sv:
        want = jsv.score(feats)
        got = sv.score(feats)
        assert sv.step == 4 and sv.stats()["tables"] == jsv.stats()["tables"]
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
        assert sv.stats()["pad_rows"] == jsv.stats()["pad_rows"]


def test_score_without_scorer_raises():
    with Servant({"t": _table(8, 4)}, device=CPU) as sv, \
            pytest.raises(RuntimeError, match="no CTR scorer"):
        sv.score([1, 2])


# ------------------------------------------------------------- apply_rows ---


def test_apply_rows_bit_equal_to_jax_on_distinct_ids():
    table = _table(512, 16, seed=6)
    ids = np.random.default_rng(2).choice(512, 37, replace=False).astype(np.int32)
    vals = _table(37, 16, seed=8)
    jsv, sv = _pair({"t": table, "u": table + 1}, batch_buckets=(8, 64))
    with jsv, sv:
        sv.pull(ids)
        v_j = jsv.apply_rows({"t": (ids, vals), "other": (ids, vals)}, step=9)
        v_p = sv.apply_rows({"t": (ids, vals), "other": (ids, vals)}, step=9)
        assert v_p == v_j == 1 and sv.step == jsv.step == 9
        probe = np.arange(512, dtype=np.int32)
        np.testing.assert_array_equal(sv.pull(probe), jsv.pull(probe))
        np.testing.assert_array_equal(sv.pull(ids), vals)
        np.testing.assert_array_equal(sv.pull(probe, table="u"), table + 1)


def test_apply_rows_last_occurrence_wins_and_drops_out_of_range():
    """Port only: where an id repeats the last value wins (JAX and torch
    leave duplicates unspecified); an id outside [0, C) is dropped."""
    table = _table(64, 8, seed=1)
    ids = np.array([3, 9, 3, 70, -1, 9, 3], np.int64)
    vals = np.arange(7 * 8, dtype=np.float32).reshape(7, 8)
    with Servant({"t": table}, device=CPU) as sv:
        live = sv._tables["t"]
        sv.apply_rows({"t": (ids, vals)})
        got = sv.pull(np.arange(64, dtype=np.int32))
        want = table.copy()
        want[3], want[9] = vals[6], vals[5]
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(live.numpy(), table)  # the old plane is untouched


# ---------------------------------------------------------- stats, health ---


def test_stats_and_health_keys_equal_jax():
    table = _table(32, 8)
    from swiftsnails_tpu.telemetry.request_trace import RequestTracer as JTracer
    from swiftsnails_tpu.telemetry.slo import SloTracker as JSlo

    from swiftsnails_tpu_torch.telemetry.request_trace import RequestTracer
    from swiftsnails_tpu_torch.telemetry.slo import SloTracker

    def keys(d, prefix=""):
        out = set()
        for k, v in d.items():
            out.add(prefix + k)
            if isinstance(v, dict):
                out |= keys(v, prefix + k + ".")
        return out

    for traced in (False, True):
        extra = ({"request_tracer": (JTracer(1.0), RequestTracer(1.0)),
                  "slo": (JSlo({"pull": 5.0}), SloTracker({"pull": 5.0}))}
                 if traced else {})
        with JServant({"t": table}, **{k: v[0] for k, v in extra.items()}) as jsv, \
                Servant({"t": table}, device=CPU,
                        **{k: v[1] for k, v in extra.items()}) as sv:
            for s in (jsv, sv):
                s.pull([1, 2, 3])
                s.topk(table[0], k=3)
            assert keys(sv.stats()) == keys(jsv.stats())
            assert keys(sv.health()) == keys(jsv.health())


# --------------------------------------------------------------- load_tables


def _w2v_state(cap, dim, dtype=torch.float32, seed=0):
    rng = np.random.default_rng(seed)
    shape = rowdma.packed_shape(cap, dim)
    a, b = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    return convert.w2v_state_from_numpy(a, b, device=CPU, dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_load_tables_round_trips_a_port_checkpoint(tmp_path, dtype):
    state = _w2v_state(64, 24, dtype)
    root = str(tmp_path / "ck")
    save_checkpoint(root, state, step=3, cursor={"step": 3, "items": 7})
    tree, manifest = load_tables(root, device=CPU)
    assert manifest["step"] == 3 and set(tree) == {"in_table", "out_table"}
    for name in ("in_table", "out_table"):
        got = tree[name]["table"]
        assert got.dtype == dtype and got.shape == getattr(state, name).table.shape
        assert torch.equal(got, getattr(state, name).table)


def test_load_tables_nests_a_ctr_tree(tmp_path):
    keys, jtr, _ = _jax_ctr("widedeep", 1, optimizer="adagrad")
    jstate = jtr.init_state()
    state = convert.ctr_state_from_numpy(
        np.asarray(jstate.table.table), {k: np.asarray(v) for k, v in jstate.dense.items()},
        {k: np.asarray(v) for k, v in jstate.opt[0].sum_of_squares.items()}, device=CPU)
    root = str(tmp_path / "ck")
    save_checkpoint(root, state, step=1)
    tree, _ = load_tables(root, device=CPU)
    assert set(tree) == {"table", "dense", "opt"}
    assert set(tree["dense"]) == set(jstate.dense)
    assert set(tree["opt"]["sum_of_squares"]) == set(jstate.dense)
    np.testing.assert_array_equal(tree["dense"]["w0"].numpy(), np.asarray(jstate.dense["w0"]))
    assert tuple(tree["dense"]["bias"].shape) == (1,)  # a 0-d tensor's manifest shape


def _corrupt_biggest(root, step):
    import pathlib

    victim = max((p for p in pathlib.Path(root, f"step_{step}").iterdir()
                  if p.name != "manifest.json"), key=lambda p: p.stat().st_size)
    blob = bytearray(victim.read_bytes())
    blob[len(blob) // 2] ^= 0xFF
    victim.write_bytes(bytes(blob))


def test_load_tables_walks_back_past_corrupt_and_torn_steps(tmp_path):
    root = str(tmp_path / "ck")
    save_checkpoint(root, _w2v_state(32, 8, seed=1), step=1)
    save_checkpoint(root, _w2v_state(32, 8, seed=2), step=2)
    _corrupt_biggest(root, 2)
    (tmp_path / "ck" / "step_3").mkdir()  # torn: no manifest
    tree, manifest = load_tables(root, device=CPU)
    assert manifest["step"] == 1
    assert torch.equal(tree["in_table"]["table"], _w2v_state(32, 8, seed=1).in_table.table)
    with pytest.raises(CheckpointError, match="crc mismatch"):
        load_tables(root, step=2, device=CPU)
    # verify=False reads the corrupt bytes as they are
    assert load_tables(root, step=2, verify=False, device=CPU)[1]["step"] == 2
    _corrupt_biggest(root, 1)
    with pytest.raises(CheckpointError) as e:
        load_tables(root, device=CPU)
    assert "step_2" in str(e.value) and "step_1" in str(e.value) and "step_3" in str(e.value)
    with pytest.raises(FileNotFoundError):
        load_tables(str(tmp_path / "empty"), device=CPU)


def test_load_tables_retries_transient_reads(tmp_path, monkeypatch):
    from swiftsnails_tpu_torch.framework import checkpoint as ckpt
    from swiftsnails_tpu_torch.resilience.retry import RetryPolicy

    root = str(tmp_path / "ck")
    save_checkpoint(root, _w2v_state(16, 8), step=5)
    real, fails = ckpt._read_step, [2]

    def flaky(*a):
        if fails[0]:
            fails[0] -= 1
            raise OSError("transient")
        return real(*a)

    monkeypatch.setattr(ckpt, "_read_step", flaky)
    policy = RetryPolicy(max_attempts=4, base_ms=0.0, cap_ms=0.0, sleep=lambda s: None)
    assert load_tables(root, retry=policy, device=CPU)[1]["step"] == 5
    assert fails == [0]


def test_load_tables_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the default device is then valid")
    root = str(tmp_path / "ck")
    save_checkpoint(root, _w2v_state(16, 8), step=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        load_tables(root)
    with pytest.raises(RuntimeError, match="CUDA"):
        Servant.from_checkpoint(root, Config({"dim": "8"}))


# ------------------------------------------------- from_checkpoint, reload --


def _w2v_ckpt(root, cap=64, dim=24, steps=(1,)):
    for s in steps:
        save_checkpoint(root, _w2v_state(cap, dim, seed=s), step=s)
    return Config({"dim": str(dim), "capacity": str(cap), "packed": "1"})


def test_from_checkpoint_serves_the_trained_rows(tmp_path):
    root = str(tmp_path / "ck")
    cfg = _w2v_ckpt(root, steps=(1, 2))
    want = _w2v_state(64, 24, seed=2)
    with Servant.from_checkpoint(root, cfg, device=CPU) as sv:
        assert sv.step == 2 and sv.stats()["tables"] == {
            "in_table": [64, 24], "out_table": [64, 24]}
        ids = np.array([0, 5, 63, 5], np.int32)
        np.testing.assert_array_equal(
            sv.pull(ids), rowdma.unpack_rows(want.in_table.table, 24).numpy()[ids])
        np.testing.assert_array_equal(
            sv.pull(ids, table="out_table"),
            rowdma.unpack_rows(want.out_table.table, 24).numpy()[ids])


def test_from_checkpoint_reads_the_serve_keys(tmp_path):
    root = str(tmp_path / "ck")
    cfg = _w2v_ckpt(root)
    for k, v in {"serve_batch_buckets": "4,16", "serve_cache_rows": "7",
                 "serve_queue_depth": "3", "serve_topk": "4", "comm_dtype": "bf16",
                 "breaker_threshold": "9", "breaker_cooldown_ms": "12",
                 "breaker_halfopen_probes": "2", "serve_degraded": "0",
                 "trace_sample_rate": "1.0", "slo_latency_ms": "50"}.items():
        cfg.set(k, v)
    with Servant.from_checkpoint(root, cfg, device=CPU) as sv:
        assert sv.buckets == (4, 16) and sv.cache.capacity == 7
        assert sv._batchers["pull"].queue_depth == 3 and sv.topk_default == 4
        assert sv.comm_dtype == "bfloat16" and not sv.degraded_enabled
        br = sv.breakers["pull"]
        assert (br.threshold, br.cooldown_s, br.halfopen_probes) == (9, 0.012, 2)
        assert sv.request_tracer is not None and sv.slo is not None
        assert len(sv.topk(np.ones(24, np.float32))) == 4


@pytest.mark.parametrize("key,value,item", [
    ("table_tier", "host", "item 4"), ("comm_dtype", "int8", "item 6")])
def test_unported_serving_keys_raise(tmp_path, key, value, item):
    """``table_tier: host`` (item 4) is ported since this test was written:
    for it the test holds that the servant serves the checkpoint through a
    tier; ``comm_dtype: int8`` still raises."""
    root = str(tmp_path / "ck")
    cfg = _w2v_ckpt(root)
    cfg.set(key, value)
    if key == "table_tier":
        cfg.set("tier_hbm_budget_mb", str(2 * 16 * 24 * 4 / (1 << 20)))
        with Servant.from_checkpoint(root, cfg, device=CPU) as sv:
            assert sorted(sv.tier) == ["in_table", "out_table"]
            assert sv.tier["in_table"].budget == 16
            ids = np.arange(40, dtype=np.int32)
            want = rowdma.unpack_rows(_w2v_state(64, 24, seed=1).in_table.table, 24)
            np.testing.assert_array_equal(sv.pull(ids[:16]), want.numpy()[:16])
        return
    with pytest.raises(NotImplementedError, match=item):
        Servant.from_checkpoint(root, cfg, device=CPU)


def test_unported_servant_options_raise():
    """``tier_hbm_budget_mb`` is ported since this test was written: the
    servant then builds a tier (its budget in rows of the table); so is
    ``attach_freshness``: ``health()`` then carries the subscriber's status;
    ``mesh=`` still raises."""
    with Servant({"t": _table(4, 4)}, tier_hbm_budget_mb=8.0, device=CPU) as sv:
        assert sv.tier["t"].budget == 4 and sv.stats()["tiered"]["prewarmed_rows"] == 4
    with pytest.raises(NotImplementedError, match="item 6"):
        Servant({"t": _table(4, 4)}, mesh=object(), device=CPU)
    class _Sub:
        def status(self):
            return {"applied_seq": 3}

    with Servant({"t": _table(4, 4)}, device=CPU) as sv:
        sv.attach_freshness(_Sub())
        assert sv.health()["freshness"] == {"applied_seq": 3}


def test_reload_from_checkpoint_rejects_corrupt_then_swaps(tmp_path):
    root = str(tmp_path / "ck")
    cfg = _w2v_ckpt(root, steps=(1,))
    ledger = Ledger(str(tmp_path / "l.jsonl"))
    ids = np.arange(16, dtype=np.int32)
    with Servant.from_checkpoint(root, cfg, device=CPU, ledger=ledger) as sv:
        before = sv.pull(ids)
        save_checkpoint(root, _w2v_state(64, 24, seed=2), step=2)
        _corrupt_biggest(root, 2)
        with pytest.raises(CheckpointError):
            sv.reload_from_checkpoint(root, cfg, step=2)
        assert sv.version == 0 and sv.step == 1
        np.testing.assert_array_equal(sv.pull(ids), before)  # the live bytes
        assert sv.registry.counter("serve.reload_rejected").value == 1
        ev = ledger.latest("cache_error")
        assert ev["source"] == "serve_reload" and ev["kept_version"] == 0
        save_checkpoint(root, _w2v_state(64, 24, seed=3), step=3)
        assert sv.reload_from_checkpoint(root, cfg) == 1 and sv.step == 3
        want = rowdma.unpack_rows(_w2v_state(64, 24, seed=3).in_table.table, 24)
        np.testing.assert_array_equal(sv.pull(ids), want.numpy()[ids])


def test_reload_bumps_the_version_and_misses_the_cache():
    t1 = _table(32, 4)
    t2 = t1 + 1.0
    with Servant({"t": t1}, batch_buckets=(8,), cache_rows=64, device=CPU) as sv:
        ids = np.arange(8, dtype=np.int32)
        np.testing.assert_array_equal(sv.pull(ids), t1[ids])
        np.testing.assert_array_equal(sv.pull(ids), t1[ids])
        assert sv.cache.hits == len(ids)
        assert sv.reload({"t": t2}) == 1
        np.testing.assert_array_equal(sv.pull(ids), t2[ids])
        assert sv.cache.misses == 2 * len(ids)
        assert sv.reload({"t": t1}, version=7) == 7


# ---------------------------------------------------------- availability ---


def _raise(kernel, idx):
    raise OSError(f"chaos {kernel}@{idx}")


def test_breaker_and_degraded_ladder_as_jax(tmp_path):
    """The JAX availability drill on both servants: warmed rows survive a
    reload, a fault storm trips the pull breaker, degraded serves come from
    the stale LRU, the half-open probe recovers; the counters, breaker
    states and ledger events agree."""
    t1 = _table(32, 4)
    t2 = t1 + 1.0
    ids = np.arange(8, dtype=np.int32)
    seen = []
    for make in (JServant, lambda *a, **k: Servant(*a, device=CPU, **k)):
        led = Ledger(str(tmp_path / f"l{len(seen)}.jsonl"))
        with make({"t": t1}, batch_buckets=(8,), cache_rows=64, breaker_threshold=2,
                  breaker_cooldown_ms=50.0, ledger=led) as sv:
            br = sv.breakers["pull"]
            sv.pull(ids)
            sv.reload({"t": t2})
            sv.fault_hook = _raise
            states = []
            for _ in range(4):
                np.testing.assert_array_equal(sv.pull(ids), t1[ids])
                states.append(br.state)
            health = sv.health()["status"]
            sv.fault_hook = None
            time.sleep(0.08)
            np.testing.assert_array_equal(sv.pull(ids), t2[ids])
            seen.append((states, health, br.state, br.trips, br.recoveries,
                         sv.stats()["degraded"], sv.stats()["unavailable"],
                         sv.health()["status"],
                         [e["kind"] for e in led.records() if e["kind"] != "run"]))
    assert seen[0] == seen[1]
    assert seen[1][0][-1] == OPEN and seen[1][2] == CLOSED and seen[1][1] == "degraded"
    assert "DEGRADED" in render_failures(Ledger(str(tmp_path / "l1.jsonl")))


def test_topk_sheds_unavailable_and_strict_freshness():
    with Servant({"t": _table(16, 4)}, batch_buckets=(4,), cache_rows=0,
                 breaker_threshold=2, breaker_cooldown_ms=1e4, device=CPU) as sv:
        sv.fault_hook = _raise
        for _ in range(2):
            with pytest.raises(OSError):
                sv.topk(np.ones(4, np.float32), k=3)
        with pytest.raises(Unavailable):
            sv.topk(np.ones(4, np.float32), k=3)
        assert sv.stats()["unavailable"]["topk"] == 1
    t = _table(16, 4)
    with Servant({"t": t}, batch_buckets=(4,), cache_rows=64, breaker_threshold=1,
                 breaker_cooldown_ms=1e4, degraded=False, device=CPU) as sv:
        ids = np.arange(4, dtype=np.int32)
        sv.pull(ids)
        sv.reload({"t": t})
        sv.fault_hook = _raise
        with pytest.raises(OSError):
            sv.pull(ids)
        with pytest.raises(Unavailable):
            sv.pull(ids)


def test_backpressure_sheds_typed_error_and_ledger_event(tmp_path):
    ledger_path = str(tmp_path / "ledger.jsonl")
    sv = Servant({"t": _table(16, 4, seed=2)}, batch_buckets=(4,), cache_rows=0,
                 queue_depth=1, ledger=Ledger(ledger_path), device=CPU)
    try:
        gate, entered = threading.Event(), threading.Event()
        orig = sv._pull_fn

        def slow_pull(tbl, rows):
            entered.set()
            assert gate.wait(10)
            return orig(tbl, rows)

        sv._pull_fn = slow_pull
        t1 = threading.Thread(target=sv.pull, args=([1],), daemon=True)
        t1.start()
        assert entered.wait(10)
        t2 = threading.Thread(target=sv.pull, args=([2],), daemon=True)
        t2.start()
        for _ in range(1000):
            if sv._batchers["pull"].depth >= 1:
                break
            time.sleep(0.005)
        with pytest.raises(Overloaded):
            sv.pull([3])
        gate.set()
        t1.join(10)
        t2.join(10)
        assert not t1.is_alive() and not t2.is_alive()
        assert sv.shed_count() == 1 and sv.stats()["shed"]["pull"] == 1
    finally:
        sv.close()
    led = Ledger(ledger_path)
    ev = led.latest("overload")
    assert ev["kernel"] == "pull" and ev["queue_depth"] == 1 and ev["shed_total"] == 1
    assert "OVERLOAD kernel=pull" in render_failures(led)


def test_concurrent_pulls_topk_and_apply_rows_stay_consistent():
    """Threads pulling and scanning while deltas install: every answer is
    one whole version's rows (all old or all new), never a torn mix."""
    cap, dim = 256, 8
    base = np.zeros((cap, dim), np.float32)
    ids = np.arange(0, cap, 4, dtype=np.int32)
    errors = []
    with Servant({"t": base}, batch_buckets=(8, 64), cache_rows=32, device=CPU) as sv:
        def reader():
            try:
                for _ in range(40):
                    rows = sv.pull(ids)
                    assert len(np.unique(rows)) == 1, np.unique(rows)
                    sv.topk(np.ones(dim, np.float32), k=3)
            except Exception as e:  # noqa: BLE001 — collected for the assert
                errors.append(e)

        threads = [threading.Thread(target=reader) for _ in range(6)]
        for th in threads:
            th.start()
        for v in range(1, 21):
            sv.apply_rows({"t": (np.arange(cap), np.full((cap, dim), v, np.float32))})
        for th in threads:
            th.join(60)
        assert not any(th.is_alive() for th in threads) and not errors, errors
        np.testing.assert_array_equal(sv.pull(ids), np.full((len(ids), dim), 20.0))


# -------------------------------------------------------------- the lane ---


def test_serve_bench_small_on_the_cpu(tmp_path):
    block = serve_bench(small=True, workdir=str(tmp_path), device=CPU)
    assert block["checkpoint_step"] == 1 and block["buckets"] == [8, 64]
    assert set(block["kernels"]) == {"pull", "topk", "ctr_score"}
    for kernel in block["kernels"].values():
        for leg in kernel.values():
            assert leg["qps"] > 0 and leg["p99_ms"] >= leg["p95_ms"] >= leg["p50_ms"] >= 0
    assert block["qps"] == block["kernels"]["pull"]["b64"]["qps"]
    assert block["cache_hit_rate"] > 0.5 and block["shed_count"] == 0


# ------------------------------------------------------------- the gate ---


def _bench_record(value, serving=None, platform="gpu"):
    payload = {"metric": "word2vec_words_per_sec_per_chip", "value": value,
               "unit": "words/sec/chip", "platform": platform, "config": {}}
    if serving is not None:
        payload["serving"] = serving
    return {"payload": payload}


@pytest.mark.parametrize("second,rc,needle", [
    ({"qps": 1000.0, "p99_ms": 2.0}, 1, "pull qps"),
    ({"qps": 5100.0, "p99_ms": 9.0}, 1, "pull p99"),
    ({"qps": 5200.0, "p99_ms": 1.9}, 0, "serving ok"),
])
def test_check_regression_gates_serving_as_jax(tmp_path, second, rc, needle):
    from swiftsnails_tpu.telemetry.ledger import Ledger as JLedger
    from swiftsnails_tpu.telemetry.ledger import check_regression as jax_check

    for led, check in ((Ledger(str(tmp_path / "p.jsonl")), check_regression),
                       (JLedger(str(tmp_path / "j.jsonl")), jax_check)):
        led.append("bench", _bench_record(100_000.0, {"qps": 5000.0, "p99_ms": 2.0}))
        led.append("bench", _bench_record(101_000.0, second))
        got_rc, msg = check(led, 10.0)
        assert got_rc == rc and needle in msg, msg
        assert len([ln for ln in msg.splitlines() if "serving" in ln]) == 1


def test_serving_gate_is_platform_scoped(tmp_path):
    led = Ledger(str(tmp_path / "l.jsonl"))
    led.append("bench", _bench_record(100_000.0, {"qps": 50_000.0, "p99_ms": 0.1}))
    led.append("bench", _bench_record(101_000.0, {"qps": 200.0, "p99_ms": 8.0},
                                      platform="cpu"))
    rc, msg = check_regression(led, 10.0)
    assert rc == 0 and "single cpu record" in msg


@pytest.mark.parametrize("model", ["word2vec", "widedeep"])
def test_a_jax_checkpoint_serves_alike_through_convert(tmp_path, model):
    """A JAX checkpoint: the JAX ``Servant.from_checkpoint`` against the
    port's servant over ``convert.tree_from_numpy`` of the JAX
    ``load_tables`` tree, which equals the port's own ``load_tables`` of the
    same state saved by the port."""
    from swiftsnails_tpu.framework.checkpoint import load_tables as jax_load_tables
    from swiftsnails_tpu.framework.checkpoint import save_checkpoint as jax_save
    from swiftsnails_tpu.framework.quality import paired_corpus
    from swiftsnails_tpu.models.word2vec import Word2VecTrainer as JW2V

    from swiftsnails_tpu_torch.serving.engine import _normalize_state_tables, _scorer_for

    if model == "word2vec":
        keys = {"dim": "24", "capacity": "128", "packed": "1", "seed": "2"}
        ids, vocab = paired_corpus(n_pairs=16, reps=4, seed=2)
        jstate = JW2V(JConfig(dict(keys)), mesh=None, corpus_ids=ids, vocab=vocab).init_state()
        jstate = jstate._replace(out_table=jstate.out_table._replace(
            table=jnp.asarray(_table(128, 128, seed=5).reshape(128, 1, 128))))
        port_state = convert.w2v_state_from_numpy(
            np.asarray(jstate.in_table.table), np.asarray(jstate.out_table.table), device=CPU)
    else:
        keys, jtr, _ = _jax_ctr("widedeep", 1, optimizer="adagrad")
        jstate = jtr.init_state()
        port_state = convert.ctr_state_from_numpy(
            np.asarray(jstate.table.table), {k: np.asarray(v) for k, v in jstate.dense.items()},
            {k: np.asarray(v) for k, v in jstate.opt[0].sum_of_squares.items()}, device=CPU)
    jroot, proot = str(tmp_path / "j"), str(tmp_path / "p")
    jax_save(jroot, jstate, step=3, wait=True)
    save_checkpoint(proot, port_state, step=3)
    tree = convert.tree_from_numpy(jax_load_tables(jroot)[0], device=CPU)
    own, _ = load_tables(proot, device=CPU)
    flat = lambda t, p="": [x for k in sorted(t) for x in (  # noqa: E731
        flat(t[k], f"{p}/{k}") if isinstance(t[k], dict) else [(f"{p}/{k}", t[k])])]
    assert [k for k, _ in flat(tree)] == [k for k, _ in flat(own)]
    for (_, a), (_, b) in zip(flat(tree), flat(own)):
        assert torch.equal(a.reshape(-1), b.reshape(-1))
    cfg = Config(dict(keys))
    scorer = _scorer_for(cfg, torch.device(CPU)) if model != "word2vec" else None
    tables, dense, default = _normalize_state_tables(tree, cfg, scorer, None)
    with JServant.from_checkpoint(jroot, JConfig(dict(keys)), batch_buckets=(8,)) as jsv, \
            Servant(tables, scorer=scorer, dense=dense, default_table=default,
                    batch_buckets=(8,), device=CPU) as sv:
        rows = np.arange(0, 100, 7, dtype=np.int32)
        np.testing.assert_array_equal(sv.pull(rows), jsv.pull(rows))
        if model == "word2vec":
            for table in ("in_table", "out_table"):
                np.testing.assert_array_equal(sv.pull(rows, table=table),
                                              jsv.pull(rows, table=table))
            q = jsv.pull([3], table="out_table")[0]
            got, want = sv.topk(q, k=6, table="out_table"), jsv.topk(q, k=6, table="out_table")
            assert [i for i, _ in got] == [i for i, _ in want]
        else:
            feats = np.random.default_rng(1).integers(0, 1 << 20, (9, 5)).astype(np.int32)
            np.testing.assert_allclose(sv.score(feats), jsv.score(feats), rtol=1e-5, atol=1e-7)
