"""The port's freshness pipeline against the JAX package's, on the CPU.

The delta log is one format for both packages: segments and base records
are byte-equal, and each package's subscriber applies the other's log. The
publisher's gathers (``gather_normalized_rows`` on the dense, packed and
small-row planes, ``normalize_units`` on master units) equal JAX's at
tolerance 0; the int8 wire is JAX's quantizer bit for bit; a port
``Servant`` and a JAX ``Servant`` that take the same delta batches serve
equal rows; the freshness gate gives JAX's verdicts on the same records;
and the tiered tee publishes the units JAX's does. Then the port alone: the
subscriber's ordering, gap / restart / CRC fallbacks, the fleet cutover,
the loop's publisher (bit-exact to the next checkpoint on the resident
path and on each fused path, training unchanged by it) and
the chaos drill. Inputs are made from numpy seeds; no test reads a clock.
"""

import os

import numpy as np
import pytest
import torch

from swiftsnails_tpu.freshness import log as jax_log
from swiftsnails_tpu.freshness import publisher as jax_pub
from swiftsnails_tpu.freshness.subscriber import DeltaSubscriber as JSubscriber
from swiftsnails_tpu.framework.trainer import TrainLoop as JaxTrainLoop
from swiftsnails_tpu.models.registry import get_model as jax_get_model
from swiftsnails_tpu.serving import Servant as JServant
from swiftsnails_tpu.telemetry import ledger as jax_ledger
from swiftsnails_tpu.tiered import store as jax_store
from swiftsnails_tpu.utils.config import Config as JaxConfig

from swiftsnails_tpu_torch import convert
from swiftsnails_tpu_torch.data import ctr
from swiftsnails_tpu_torch.framework.quality import paired_corpus
from swiftsnails_tpu_torch.framework.trainer import TrainLoop
from swiftsnails_tpu_torch.freshness import log as port_log
from swiftsnails_tpu_torch.freshness.bench_lane import freshness_chaos_drill
from swiftsnails_tpu_torch.freshness.log import (
    DeltaCorrupt,
    list_seqs,
    prune,
    read_base,
    read_batch,
    seg_path,
    write_batch,
)
from swiftsnails_tpu_torch.freshness.publisher import (
    DeltaPublisher,
    TouchedRowCollector,
    gather_normalized_rows,
    normalize_units,
)
from swiftsnails_tpu_torch.freshness.subscriber import DeltaSubscriber
from swiftsnails_tpu_torch.models.registry import get_model
from swiftsnails_tpu_torch.models.word2vec import Word2VecTrainer
from swiftsnails_tpu_torch.serving import Servant
from swiftsnails_tpu_torch.serving.fleet import Fleet
from swiftsnails_tpu_torch.telemetry import ledger as port_ledger
from swiftsnails_tpu_torch.telemetry.ledger import Ledger, check_regression, render_failures
from swiftsnails_tpu_torch.tiered.store import _np_dequant_unit_rows, _np_quant_unit_rows
from swiftsnails_tpu_torch.utils.config import Config

CPU = "cpu"
DIM = 8
CAP = 64
# one intra-op thread: the shapes are small and the suite's workers share cores
torch.set_num_threads(1)


def _vals(rows, seed, dim=DIM):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((len(rows), dim)).astype(np.float32)


class FakeTarget:
    """Minimal serving target: the apply_rows / reload_from_checkpoint /
    step / version surface the subscriber drives."""

    def __init__(self, cap=CAP, dim=DIM):
        self.tables = {"t": np.zeros((cap, dim), np.float32)}
        self.step = 0
        self.version = 0
        self.applies = 0
        self.reloads = 0

    def apply_rows(self, updates, *, version=None, step=None):
        for name, (rows, vals) in updates.items():
            self.tables[name][np.asarray(rows, np.int64)] = np.asarray(vals, np.float32)
        if step is not None:
            self.step = max(self.step, int(step))
        self.version = int(version) if version is not None else self.version + 1
        self.applies += 1
        return self.version

    def reload_from_checkpoint(self, root, config, **kw):
        self.reloads += 1
        self.version += 1
        return self.version


# ------------------------------------------------- the format, both ways ---


def _tables(dtype, seed=1):
    rows = {"a": np.array([3, 0, 17, CAP - 1], np.int64), "b": np.arange(5, dtype=np.int64)}
    out = {}
    for i, (name, r) in enumerate(sorted(rows.items())):
        vals = _vals(r, seed + i)
        if dtype == "int8":
            codes, scales = _np_quant_unit_rows(vals)
            out[name] = {"rows": r, "values": codes, "scales": scales}
        else:
            out[name] = {"rows": r, "values": vals}
    return out


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_log_segments_byte_equal_both_ways(tmp_path, dtype):
    """The same header and tables give the same segment bytes from either
    package, and each package decodes the other's segment to equal arrays."""
    header = {"seq": 3, "publisher": "p0", "base_step": 4, "step": 5,
              "ts_ns": 123, "dtype": dtype}
    tables = _tables(dtype)
    for sub in ("port", "jax"):
        os.makedirs(tmp_path / sub)
    p = port_log.write_batch(str(tmp_path / "port"), header, tables)
    j = jax_log.write_batch(str(tmp_path / "jax"), header, tables)
    assert open(p, "rb").read() == open(j, "rb").read()
    port_log.write_base(str(tmp_path / "port"), {"publisher": "p0", "base_step": 4})
    jax_log.write_base(str(tmp_path / "jax"), {"publisher": "p0", "base_step": 4})
    assert (open(tmp_path / "port" / "BASE.json", "rb").read()
            == open(tmp_path / "jax" / "BASE.json", "rb").read())
    for reader, path in ((port_log.read_batch, j), (jax_log.read_batch, p)):
        hdr, got = reader(path)
        assert hdr["seq"] == 3 and hdr["dtype"] == dtype
        for name, t in tables.items():
            for key, want in t.items():
                np.testing.assert_array_equal(got[name][key], want)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_package_subscribes_to_the_others_log(tmp_path, writer):
    d = str(tmp_path / "log")
    pub_cls = DeltaPublisher if writer == "port" else jax_pub.DeltaPublisher
    sub_cls = JSubscriber if writer == "port" else DeltaSubscriber
    pub = pub_cls(d, base_step=0)
    rows = np.array([2, 7, 11, 40], np.int64)
    batches = [_vals(rows, s) for s in (1, 2, 3)]
    for step, vals in enumerate(batches, start=1):
        pub.publish({"t": (rows[:step + 1], vals[:step + 1])}, step)
    tgt = FakeTarget()
    sub = sub_cls(tgt, d)
    assert sub.poll() == 3 and sub.applied_step == 3 and sub.publisher == pub.id
    want = np.zeros((CAP, DIM), np.float32)
    for step, vals in enumerate(batches, start=1):
        want[rows[:step + 1]] = vals[:step + 1]
    np.testing.assert_array_equal(tgt.tables["t"], want)


def test_batch_round_trip_bit_identical(tmp_path):
    d = str(tmp_path)
    rows = np.array([3, 0, 17, CAP - 1], np.int64)
    vals = _vals(rows, 1)
    header = {"seq": 1, "publisher": "p0", "base_step": 4, "step": 5,
              "ts_ns": 123, "dtype": "float32"}
    write_batch(d, header, {"t": {"rows": rows, "values": vals}})
    got_header, got_tables = read_batch(seg_path(d, 1))
    assert got_header["publisher"] == "p0"
    assert (got_header["seq"], got_header["step"]) == (1, 5)
    np.testing.assert_array_equal(got_tables["t"]["rows"], rows)
    np.testing.assert_array_equal(got_tables["t"]["values"], vals)


def test_crc_rejects_bitflip_and_truncation(tmp_path):
    d = str(tmp_path)
    rows = np.arange(8, dtype=np.int64)
    write_batch(d, {"seq": 1, "publisher": "p0", "dtype": "float32"},
                {"t": {"rows": rows, "values": _vals(rows, 2)}})
    path = seg_path(d, 1)
    blob = bytearray(open(path, "rb").read())
    blob[len(blob) // 2] ^= 0x40
    open(path, "wb").write(bytes(blob))
    with pytest.raises(DeltaCorrupt):
        read_batch(path)
    open(path, "wb").write(bytes(blob[:10]))
    with pytest.raises(DeltaCorrupt):
        read_batch(path)


def test_prune_deletes_oldest_first_and_keeps_newest(tmp_path):
    d = str(tmp_path)
    rows = np.arange(16, dtype=np.int64)
    for seq in range(1, 6):
        write_batch(d, {"seq": seq, "publisher": "p0", "dtype": "float32"},
                    {"t": {"rows": rows, "values": _vals(rows, seq)}})
    one = os.path.getsize(seg_path(d, 1))
    assert prune(d, max_bytes=2 * one + one // 2) == 3
    assert list_seqs(d) == [4, 5] == jax_log.list_seqs(d)
    prune(d, max_bytes=0)  # never deletes the newest batch
    assert list_seqs(d) == [5]


def test_new_publisher_incarnation_owns_the_directory(tmp_path):
    d = str(tmp_path / "log")
    rows = np.arange(4, dtype=np.int64)
    a = DeltaPublisher(d, base_step=1)
    for step in (2, 3, 4):
        a.publish({"t": (rows, _vals(rows, step))}, step)
    assert list_seqs(d) == [1, 2, 3]
    b = DeltaPublisher(d, base_step=4)
    assert b.id != a.id and list_seqs(d) == []
    assert read_base(d)["publisher"] == b.id
    b.publish({"t": (rows, _vals(rows, 9))}, 5)
    assert list_seqs(d) == [1]
    assert b.stats()["published_batches"] == 1 and b.stats()["write_ms"] > 0


# ------------------------------------------------------------ subscriber ---


def test_duplicate_redelivery_is_a_counted_noop(tmp_path):
    d = str(tmp_path / "log")
    pub = DeltaPublisher(d, base_step=0)
    rows = np.array([2, 7, 11], np.int64)
    vals = _vals(rows, 3)
    pub.publish({"t": (rows, vals)}, 1)
    tgt = FakeTarget()
    sub = DeltaSubscriber(tgt, d)
    assert sub.poll() == 1
    snapshot = tgt.tables["t"].copy()
    header, tables = read_batch(seg_path(d, 1))
    assert sub.apply_batch(header, tables) is False
    assert sub.duplicate_batches == 1 and sub.applied_batches == 1 and tgt.applies == 1
    np.testing.assert_array_equal(tgt.tables["t"], snapshot)


def test_out_of_order_within_window_buffers_then_drains_in_order(tmp_path):
    d = str(tmp_path / "log")
    pub = DeltaPublisher(d, base_step=0)
    rows = np.array([5, 9], np.int64)
    batches = {}
    for seq in (1, 2, 3):
        pub.publish({"t": (rows, _vals(rows, 10 + seq))}, seq)
        batches[seq] = read_batch(seg_path(d, seq))
    tgt = FakeTarget()
    sub = DeltaSubscriber(tgt, d, window=8)
    assert sub.apply_batch(*batches[3]) is False
    assert sub.apply_batch(*batches[2]) is False
    assert sub.status()["pending"] == 2 and sub.applied_batches == 0
    assert sub.apply_batch(*batches[1]) is True
    assert sub.applied_seq == 3 and sub.applied_step == 3
    assert sub.status()["pending"] == 0 and sub.applied_batches == 3
    np.testing.assert_array_equal(tgt.tables["t"][rows], batches[3][1]["t"]["values"])


def test_gap_falls_back_and_resumes_past_the_dead_batch(tmp_path):
    d = str(tmp_path / "log")
    pub = DeltaPublisher(d, base_step=4)
    rows = {s: np.array([2 * s - 1, 2 * s], np.int64) for s in (1, 2, 3)}
    vals = {s: _vals(rows[s], 20 + s) for s in rows}
    pub.publish({"t": (rows[1], vals[1])}, 5)
    tgt = FakeTarget()
    sub = DeltaSubscriber(tgt, d, config=object(), checkpoint_root="ck")
    assert sub.poll() == 1 and tgt.step == 5
    pub.publish({"t": (rows[2], vals[2])}, 6)
    pub.publish({"t": (rows[3], vals[3])}, 7)
    os.remove(seg_path(d, 2))  # retention outran us: a real, permanent gap
    assert sub.poll() == 0
    assert sub.fallbacks == 1 and tgt.reloads == 1 and sub.next_seq == 3
    assert sub.poll() == 1
    assert sub.applied_seq == 3 and sub.fallbacks == 1
    np.testing.assert_array_equal(tgt.tables["t"][rows[3]], vals[3])


def test_publisher_restart_falls_back_then_adopts_the_new_stream(tmp_path):
    d = str(tmp_path / "log")
    rows = np.arange(4, dtype=np.int64)
    a = DeltaPublisher(d, base_step=1)
    a.publish({"t": (rows, _vals(rows, 1))}, 2)
    tgt = FakeTarget()
    sub = DeltaSubscriber(tgt, d, config=object(), checkpoint_root="ck")
    assert sub.poll() == 1 and sub.publisher == a.id
    b = DeltaPublisher(d, base_step=2)
    new_vals = _vals(rows, 2)
    b.publish({"t": (rows, new_vals)}, 3)
    assert sub.poll() == 0
    assert sub.fallbacks == 1 and tgt.reloads == 1 and sub.publisher == b.id
    assert sub.poll() == 1
    np.testing.assert_array_equal(tgt.tables["t"][rows], new_vals)


def test_subscriber_counters_equal_jax(tmp_path):
    """One scripted delivery — in order, a duplicate, out of order, a gap
    past the window — gives both packages' subscribers the same counters
    and the same target."""
    d = str(tmp_path / "log")
    pub = DeltaPublisher(d, base_step=0)
    rows = np.array([1, 4, 9], np.int64)
    for seq in range(1, 8):
        pub.publish({"t": (rows, _vals(rows, 30 + seq))}, seq)
    batches = {s: read_batch(seg_path(d, s)) for s in range(1, 8)}
    order = [1, 1, 3, 2, 7, 4, 5]
    out = []
    for cls in (DeltaSubscriber, JSubscriber):
        tgt = FakeTarget()
        sub = cls(tgt, d, config=object(), checkpoint_root="ck", window=3)
        sub.subscribe()
        results = [sub.apply_batch(*batches[s]) for s in order]
        st = sub.status()
        out.append((results, {k: st[k] for k in (
            "applied_seq", "applied_step", "next_seq", "pending", "applied_batches",
            "applied_rows", "skipped_batches", "duplicate_batches", "fallbacks", "gaps")},
            tgt.tables["t"].copy(), tgt.reloads))
    assert out[0][:2] == out[1][:2] and out[0][3] == out[1][3]
    np.testing.assert_array_equal(out[0][2], out[1][2])


def test_int8_delta_round_trip_matches_flush_requantized_rows(tmp_path):
    """The int8 wire carries JAX's codes and scales bit for bit, and the
    subscriber serves exactly their dequantized rows."""
    d = str(tmp_path / "log")
    rows = np.array([0, 3, 31, CAP - 1], np.int64)
    vals = _vals(rows, 7) * np.array([[1e-3], [1.0], [40.0], [0.2]], np.float32)
    pub = DeltaPublisher(d, base_step=0, dtype="int8")
    pub.publish({"t": (rows, vals)}, 1)
    header, tables = read_batch(seg_path(d, 1))
    assert header["dtype"] == "int8"
    codes, scales = jax_store._np_quant_unit_rows(vals)
    np.testing.assert_array_equal(tables["t"]["values"], codes)
    assert tables["t"]["scales"].tobytes() == scales.tobytes()
    expect = jax_store._np_dequant_unit_rows(codes, scales, np.float32)
    np.testing.assert_array_equal(_np_dequant_unit_rows(codes, scales, np.float32), expect)
    tgt = FakeTarget()
    assert DeltaSubscriber(tgt, d).poll() == 1
    np.testing.assert_array_equal(tgt.tables["t"][rows], expect)


def test_fleet_apply_lands_every_replica_on_one_version(tmp_path):
    table = _vals(range(CAP), 0)
    fleet = Fleet(lambda rid: Servant({"t": table}, batch_buckets=(8,), cache_rows=32,
                                      device=CPU), replicas=3)
    try:
        d = str(tmp_path / "log")
        pub = DeltaPublisher(d, base_step=0)
        rows = np.array([4, 8, 15], np.int64)
        vals = _vals(rows, 5)
        pub.publish({"t": (rows, vals)}, 2)
        sub = DeltaSubscriber(fleet, d)
        fleet.attach_freshness(sub)
        before = max(rep.servant.version for rep in fleet.replicas())
        assert sub.poll() == 1
        versions = {rep.servant.version for rep in fleet.replicas()}
        assert len(versions) == 1 and versions.pop() > before
        assert {rep.servant.step for rep in fleet.replicas()} == {2}
        for rep in fleet.replicas():
            np.testing.assert_array_equal(rep.servant.pull(rows), vals)
        health = fleet.health()
        assert health["freshness"]["applied_seq"] == 1
        assert set(health["freshness"]["replica_versions"]) == {"r0", "r1", "r2"}
    finally:
        fleet.close()


def test_servant_health_carries_the_watermark(tmp_path):
    d = str(tmp_path / "log")
    DeltaPublisher(d, base_step=0).publish({"t": (np.array([1]), _vals([1], 1))}, 3)
    with Servant({"t": _vals(range(CAP), 0)}, device=CPU) as sv:
        assert "freshness" not in sv.health()
        sub = DeltaSubscriber(sv, d, max_lag_ms=1e9)
        sv.attach_freshness(sub)
        sub.poll()
        fr = sv.health()["freshness"]
        assert fr["applied_step"] == 3 and fr["applied_seq"] == 1 and not fr["stale"]


# ------------------------------------------------ the gathers, against JAX ---


def _plane(layout, rng):
    if layout == "dense":
        return rng.standard_normal((40, 12)).astype(np.float32), 12, 40
    if layout == "packed":  # dim 200: a row spans two sublanes
        return rng.standard_normal((40, 2, 128)).astype(np.float32), 200, 40
    # small rows: 8 rows of dim 12 a tile, sublane 1 the accumulator
    return rng.standard_normal((6, 2, 128)).astype(np.float32), 12, 45


@pytest.mark.parametrize("layout", ["dense", "packed", "packed_small"])
def test_gather_normalized_rows_equals_jax(layout):
    rng = np.random.default_rng(4)
    plane, dim, cap = _plane(layout, rng)
    rows = np.sort(rng.choice(cap, size=17, replace=False)).astype(np.int64)
    want = jax_pub.gather_normalized_rows(plane, rows, layout=layout, dim=dim)
    got = gather_normalized_rows(torch.from_numpy(plane), rows, layout=layout, dim=dim)
    assert got.dtype == np.float32 and got.shape == (17, dim)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("layout", ["dense", "packed", "packed_small"])
def test_normalize_units_equals_jax(layout):
    rng = np.random.default_rng(5)
    plane, dim, cap = _plane(layout, rng)
    group = 8 if layout == "packed_small" else 1
    units = np.sort(rng.choice(plane.shape[0], size=5, replace=False)).astype(np.int64)
    want = jax_pub.normalize_units(plane[units], units, layout=layout, dim=dim,
                                   group=group, capacity=cap)
    got = normalize_units(torch.from_numpy(plane[units]), units, layout=layout, dim=dim,
                          group=group, capacity=cap)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_port_and_jax_servants_serve_equal_rows_after_the_same_deltas(tmp_path, dtype):
    rng = np.random.default_rng(6)
    table = rng.standard_normal((CAP, 16)).astype(np.float32)
    d = str(tmp_path / "log")
    pub = DeltaPublisher(d, base_step=0, dtype=dtype)
    for step in range(1, 5):
        rows = rng.choice(CAP, size=9, replace=False).astype(np.int64)
        pub.publish({"in_table": (rows, rng.standard_normal((9, 16)).astype(np.float32))}, step)
    jsv = JServant({"in_table": table}, batch_buckets=(8, 64))
    with Servant({"in_table": table}, batch_buckets=(8, 64), device=CPU) as psv:
        assert JSubscriber(jsv, d).poll() == 4 and DeltaSubscriber(psv, d).poll() == 4
        ids = np.arange(CAP)
        got = psv.pull(ids)
        assert not np.array_equal(got, table)
        np.testing.assert_array_equal(got, np.asarray(jsv.pull(ids)))
        assert psv.step == jsv.step == 4
    jsv.close()


# --------------------------------------------------- ledger and the gate ---


def test_failure_report_renders_delta_gap_and_fallback_lines(tmp_path):
    led = Ledger(str(tmp_path / "l.jsonl"))
    d = str(tmp_path / "log")
    pub = DeltaPublisher(d, base_step=0)
    rows = np.arange(2, dtype=np.int64)
    pub.publish({"t": (rows, _vals(rows, 1))}, 1)
    pub.publish({"t": (rows, _vals(rows, 2))}, 2)
    sub = DeltaSubscriber(FakeTarget(), d, config=object(), checkpoint_root="ck", ledger=led)
    sub.poll()
    os.remove(seg_path(d, 1))
    sub._fallback("gap", failed_seq=1)
    out = render_failures(led)
    assert "DELTA-GAP" in out and "reason=gap" in out
    assert "FRESHNESS-FALLBACK" in out and "recovered=True" in out
    assert out.splitlines()[1:] == jax_ledger.render_failures(
        jax_ledger.Ledger(str(tmp_path / "l.jsonl"))).splitlines()[1:]


def _fresh_block(parity=0.0, gap_recovered=True, gap_parity=0.0, lag=150.0, serve=5.0):
    return {"bit_parity": parity, "lag_p99_ms": lag, "lag_ceiling_ms": 2500.0,
            "serve_p99_ms": serve, "slo_p99_ms": 60.0,
            "gap_drill": {"recovered": gap_recovered, "parity": gap_parity}}


@pytest.mark.parametrize("block", [
    _fresh_block(), _fresh_block(parity=0.01, lag=9000.0),
    _fresh_block(gap_recovered=False, gap_parity=0.5), _fresh_block(serve=80.0)],
    ids=["ok", "parity_lag", "gap", "serve_p99"])
def test_freshness_gate_verdicts_equal_jax(tmp_path, block):
    rec = {"payload": {"metric": "word2vec_words_per_sec_per_chip", "value": 1e5,
                       "unit": "words/sec/chip", "platform": "tpu", "config": {},
                       "freshness": block}}
    path = str(tmp_path / "l.jsonl")
    Ledger(path).append("bench", rec)
    got = port_ledger._check_freshness_regression(Ledger(path))
    assert got == jax_ledger._check_freshness_regression(jax_ledger.Ledger(path))
    rc, msg = check_regression(Ledger(path), 10.0)
    assert got[1] in msg and rc == got[0]
    assert (got[0] == 0) == (block == _fresh_block())


# ------------------------------------------------------- the loop's hooks ---


def _w2v_cfg(**over):
    cfg = Config({"dim": "8", "window": "1", "negatives": "2", "learning_rate": "0.5",
                  "num_iters": "4", "batch_size": "16", "subsample": "0", "seed": "0",
                  "pool_size": "4", "pool_block": "8", "log_every": "0"})
    for k, v in over.items():
        cfg.set(k, str(v))
    return cfg


def _w2v(cfg, n_pairs=16):
    ids, vocab = paired_corpus(n_pairs=n_pairs, reps=60, seed=0)
    return Word2VecTrainer(cfg, corpus_ids=ids, vocab=vocab, device=CPU)


def _serve_cfg(cfg):
    return Config({k: cfg.get_str(k) for k in ("dim", "packed") if k in cfg})


@pytest.mark.parametrize("packed", [1, 0], ids=["packed_pool", "dense"])
def test_resident_publish_is_bit_exact_to_the_next_checkpoint(tmp_path, packed):
    """Resume 4 -> 12 publishing every step: a servant of step 4 that applies
    the deltas serves step 12's checkpoint bit for bit, over whole planes
    (the plan's rows are every row the steps touched)."""
    root, d = str(tmp_path / "ck"), str(tmp_path / "log")
    base = {"packed": packed, "param_backup_root": root}
    TrainLoop(_w2v(_w2v_cfg(**base, param_backup_period=4)), log_every=0).run(max_steps=4)
    sv = Servant.from_checkpoint(root, _w2v_cfg(packed=packed), device=CPU)
    loop = TrainLoop(_w2v(_w2v_cfg(**base, param_backup_period=12, resume="auto",
                                   freshness_publish=1, freshness_dir=d)), log_every=0)
    loop.run(max_steps=12)
    st = loop.freshness.stats()
    assert st["source"] == "collector" and st["published_batches"] == 8
    assert st["base_step"] == 4 and st["gather_ms"] >= 0 and st["d2h_ms"] >= 0
    before = dict(sv._tables)
    sub = DeltaSubscriber(sv, d)
    assert sub.poll() == 8 and sub.applied_step == 12 and sv.step == 12
    with Servant.from_checkpoint(root, _w2v_cfg(packed=packed), step=12, device=CPU) as ref:
        for name in ("in_table", "out_table"):
            assert not torch.equal(before[name], ref._tables[name])
            assert torch.equal(sv._tables[name], ref._tables[name]), name
    sv.close()


def test_publishing_leaves_the_training_bit_identical(tmp_path):
    """The collector's plan draws from a generator of its own: the trained
    tables with publishing on equal those with it off."""
    off = TrainLoop(_w2v(_w2v_cfg()), log_every=0).run(max_steps=6)
    on = TrainLoop(_w2v(_w2v_cfg(freshness_publish=2, freshness_dir=str(tmp_path / "d"))),
                   log_every=0).run(max_steps=6)
    assert torch.equal(off.in_table.table, on.in_table.table)
    assert torch.equal(off.out_table.table, on.out_table.table)
    assert list_seqs(str(tmp_path / "d")) == [1, 2, 3]


FUSED_PATHS = {
    "fused-hogwild": {"fused": 1, "pool_block": 8},
    "fused-grouped": {"fused": 1, "grouped": 1, "centers_per_block": 4},
    "fused-resident": {"fused": 1, "grouped": 1, "centers_per_block": 4, "resident": 1,
                       "hot_rows": 8},
    "fused-dedup": {"fused": 1, "grouped": 1, "centers_per_block": 4, "dedup": 1, "u_cap": 8},
    "fused-dedup-res": {"fused": 1, "grouped": 1, "centers_per_block": 4, "dedup": 1,
                        "resident": 1, "u_cap": 16, "hot_rows": 8},
}


def _normalized(state):
    from swiftsnails_tpu_torch.serving.engine import normalize_table

    return {name: normalize_table(getattr(state, name).table, DIM, "packed")
            for name in ("in_table", "out_table")}


@pytest.mark.parametrize("path", sorted(FUSED_PATHS))
def test_fused_path_publishes_every_row_it_draws(tmp_path, path):
    """Each fused path publishing every step: a servant of the start state
    that applies the deltas holds the trained planes bit for bit (the plan's
    rows are the batch's and the pools the step draws at the path's own
    geometry), and the tables trained with publishing on equal those
    trained with it off."""
    over = dict(FUSED_PATHS[path], steps_per_call=2)
    # 512 words: the pools draw rows that no batch of the run holds
    off = TrainLoop(_w2v(_w2v_cfg(**over), 256), log_every=0).run(max_steps=5)
    d = str(tmp_path / "log")
    tr = _w2v(_w2v_cfg(**over, freshness_publish=1, freshness_dir=d), 256)
    start = tr.init_state()
    tr.init_state = lambda: start
    sv = Servant({k: v.clone() for k, v in _normalized(start).items()}, device=CPU)
    before = {k: v.clone() for k, v in sv._tables.items()}
    loop = TrainLoop(tr, log_every=0)
    on = loop.run(max_steps=5)
    st = loop.freshness.stats()
    assert st["source"] == "collector" and st["published_batches"] == 5
    assert loop.freshness.errors == 0
    sub = DeltaSubscriber(sv, d)
    assert sub.poll() == 5 and sub.applied_step == 5
    want = _normalized(on)
    for name in ("in_table", "out_table"):
        assert torch.equal(off._asdict()[name].table, on._asdict()[name].table), name
        assert not torch.equal(before[name], want[name]), name
        assert torch.equal(sv._tables[name], want[name]), name
    sv.close()


def test_fused_plan_draws_the_pools_at_the_path_geometry():
    """The fused plans' pools are the step's own draws: a flat substep's
    ``b // pool_block`` pools, a grouped one's ``b // centers_per_block``;
    a grouped window's pads are left out."""
    for path, n_pools in (("fused-hogwild", 16 // 8), ("fused-grouped", 16 // 4)):
        tr = _w2v(_w2v_cfg(**FUSED_PATHS[path]))
        batch = next(iter(tr.batches()))
        ids, aug, remap = tr.tier_plan(batch, 0, 0)
        assert aug == {} and remap == {}
        np.testing.assert_array_equal(ids["in_table"], batch["centers"])
        ctx = batch["contexts"]
        n_ctx = int((ctx >= 0).sum())
        assert ids["out_table"].size == n_ctx + n_pools * 4, path
        np.testing.assert_array_equal(ids["out_table"][:n_ctx], ctx[ctx >= 0])


@pytest.mark.parametrize("packed", [1, 0], ids=["packed_small", "2d"])
def test_tiered_tee_publishes_jax_units(tmp_path, packed):
    """Both packages train logreg tiered (a budget that evicts) from one
    start state with ``freshness_publish: 2``: every batch carries the same
    rows in both logs (the flush tee's units, expanded to rows), with values
    within the CTR tests' tolerance."""
    units = 100 if packed else 200
    unit_bytes = 1024 if packed else 2 * 4  # AdaGrad: param + accumulator
    labels, feats, _ = ctr.synth_ctr(1024, 6, 50, seed=3)
    conf = {"num_fields": "6", "capacity": str(1 << 14), "learning_rate": "0.2",
            "optimizer": "adagrad", "batch_size": "32", "num_iters": "1", "seed": "0",
            "packed": str(packed), "table_tier": "host",
            "tier_hbm_budget_mb": str(units * unit_bytes / (1 << 20)),
            "freshness_publish": "2", "freshness_log_mb": "64"}
    jt = jax_get_model("logreg")(JaxConfig({**conf, "freshness_dir": str(tmp_path / "j")}),
                                 data=(labels, feats))
    tt = get_model("logreg")(Config({**conf, "freshness_dir": str(tmp_path / "p")}),
                             data=(labels, feats), device=CPU)
    js = jt.init_state()
    sums = ({k: np.asarray(v) for k, v in js.opt[0].sum_of_squares.items()}
            if js.dense else None)
    start = convert.ctr_state_from_numpy(
        np.asarray(js.table.table), {k: np.asarray(v) for k, v in js.dense.items()},
        sums, device=CPU,
        **({"table_slots": {k: np.asarray(v) for k, v in js.table.slots.items()}}
           if js.table.slots else {}))
    jt.init_state = lambda: js
    tt.init_state = lambda: start
    jl, tl = JaxTrainLoop(jt, log_every=0), TrainLoop(tt, log_every=0)
    jl.run(seed=0, max_steps=8)
    tl.run(seed=0, max_steps=8)
    assert tl.tier.summary()["evictions"] > 0
    assert tl.freshness.stats()["source"] == "flush_tee"
    seqs = list_seqs(str(tmp_path / "p"))
    assert seqs == jax_log.list_seqs(str(tmp_path / "j")) and len(seqs) == 4
    for s in seqs:
        ph, pt = read_batch(seg_path(str(tmp_path / "p"), s))
        jh, jt_ = jax_log.read_batch(seg_path(str(tmp_path / "j"), s))
        assert ph["step"] == jh["step"]
        np.testing.assert_array_equal(pt["table"]["rows"], jt_["table"]["rows"])
        want = jt_["table"]["values"]
        assert np.abs(pt["table"]["values"] - want).max() <= 1e-4 * max(np.abs(want).max(), 1)


# -------------------------------------------------------------- the drill ---


def test_freshness_chaos_drill_matrix_recovers(tmp_path):
    out = freshness_chaos_drill(small=True, workdir=str(tmp_path), device=CPU)
    assert out["recovered_all"]
    for name in ("publisher_kill", "corrupt_delta", "forced_gap"):
        res = out[name]
        assert res["recovered"], name
        assert res["fallbacks"] >= 1 and res["parity"] == 0.0


def test_freshness_lane_small_on_the_cpu(tmp_path):
    """The lane end to end at its small size: a run publishing to a
    2-replica fleet under an open loop of pulls ends bit-identical to the
    watermark's checkpoint on every applied row, on one version, and the
    gap drill recovers to whole-plane parity. Its latencies are reported,
    not asserted."""
    from swiftsnails_tpu_torch.freshness.bench_lane import freshness_bench

    out = freshness_bench(small=True, workdir=str(tmp_path), device=CPU)
    assert out["bit_parity"] == 0.0 and out["cutover_atomic"]
    assert out["applied_step"] == out["steps"]["watermark"] == 48
    assert out["published_batches"] == out["applied_batches"] == 40
    assert out["gap_drill"]["recovered"] and out["gap_drill"]["parity"] == 0.0
    for key in ("lag_p99_ms", "serve_p99_ms", "slo_p99_ms", "lag_ceiling_ms"):
        assert out[key] >= 0
