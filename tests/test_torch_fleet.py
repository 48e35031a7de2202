"""The port's fleet and router against the JAX package's, on the CPU.

The router is pure policy: the ring's owners and successor orders, the
bounded spill, the hedge timer's EWMA quantile and the hedge governor
decide the same for one seed in both packages. The fleet over the port's
servants (``device="cpu"``) answers as one servant does, hedges, reroutes,
drains, adds replicas, applies a delta at one epoch, reloads from a
checkpoint, and reports ``stats()`` / ``health()`` with JAX's keys.
"""

import threading
import time

import numpy as np
import pytest
import torch

from swiftsnails_tpu.serving import Servant as JServant
from swiftsnails_tpu.serving.fleet import Fleet as JFleet
from swiftsnails_tpu.serving.loadgen import anchor_ids as jax_anchor_ids
from swiftsnails_tpu.serving.loadgen import run_open_loop as jax_run_open_loop
from swiftsnails_tpu.serving.loadgen import zipf_weights as jax_zipf_weights
from swiftsnails_tpu.serving import router as jrouter

from swiftsnails_tpu_torch import convert
from swiftsnails_tpu_torch.framework.checkpoint import CheckpointError, save_checkpoint
from swiftsnails_tpu_torch.ops import rowdma
from swiftsnails_tpu_torch.serving import Fleet, Overloaded, Servant, run_open_loop
from swiftsnails_tpu_torch.serving import router
from swiftsnails_tpu_torch.serving.loadgen import anchor_ids, zipf_weights
from swiftsnails_tpu_torch.telemetry.ledger import Ledger, render_failures
from swiftsnails_tpu_torch.utils.config import Config

DIM = 8
CAP = 64


def _table(cap=CAP, seed=0):
    return np.random.default_rng(seed).standard_normal((cap, DIM)).astype(np.float32)


def _mk_fleet(n=2, *, cap=CAP, buckets=(8,), cache_rows=64, breaker_threshold=0,
              ledger=None, jax=False, **fleet_kw):
    table = _table(cap)

    def factory(rid):
        if jax:
            return JServant({"t": table}, batch_buckets=buckets, cache_rows=cache_rows,
                            breaker_threshold=breaker_threshold)
        return Servant({"t": table}, batch_buckets=buckets, cache_rows=cache_rows,
                       breaker_threshold=breaker_threshold, device="cpu")

    cls = JFleet if jax else Fleet
    return table, cls(factory, replicas=n, ledger=ledger, **fleet_kw)


def _owned_key(fleet, rid, lo=0, hi=CAP):
    for k in range(lo, hi):
        if fleet._ring.successors(router.route_hash(k))[0] == rid:
            return k
    raise AssertionError(f"no key in [{lo}, {hi}) owned by {rid}")


# ---------------------------------------------------------------- router ---


@pytest.mark.parametrize("n_nodes,vnodes", [(1, 64), (3, 64), (5, 16), (8, 1)])
def test_ring_owners_and_successors_equal_jax(n_nodes, vnodes):
    nodes = [f"r{i}" for i in range(n_nodes)]
    ring, jring = router.HashRing(vnodes), jrouter.HashRing(vnodes)
    for n in nodes:
        ring.add(n)
    for n in reversed(nodes):
        jring.add(n)
    rng = np.random.default_rng(n_nodes)
    keys = [int(k) for k in rng.integers(0, 1 << 40, 500)] + ["user:7", "", "ß"]
    for key in keys:
        h = router.route_hash(key)
        assert h == jrouter.route_hash(key)
        assert ring.successors(h) == jring.successors(h)
        assert ring.owner(h) == jring.owner(h)
    if n_nodes > 1:
        ring.remove("r0")
        jring.remove("r0")
        assert all(ring.successors(router.route_hash(k)) ==
                   jring.successors(jrouter.route_hash(k)) for k in keys)
    assert ring.members() == jring.members() and len(ring) == len(jring)


@pytest.mark.parametrize("loads,spill", [
    ([0, 0, 0], 1.5), ([9, 0, 0], 1.5), ([9, 9, 0], 1.2), ([5, 5, 5], 1.5),
    ([3], 2.0), ([4, 1, 0, 7], 1.0)])
def test_spill_order_equal_jax(loads, spill):
    ordered = [f"r{i}" for i in range(len(loads))]
    load_of = dict(zip(ordered, loads)).__getitem__
    assert router.spill_order(ordered, load_of, spill=spill) == \
        jrouter.spill_order(ordered, load_of, spill=spill)
    assert router.route_annotation(ordered, ordered[::-1], affinity=True) == \
        jrouter.route_annotation(ordered, ordered[::-1], affinity=True)


def test_ewma_quantile_and_hedge_governor_equal_jax():
    rng = np.random.default_rng(11)
    samples = rng.exponential(4.0, 300)
    ours, theirs = router.EwmaQuantile(initial=25.0), jrouter.EwmaQuantile(initial=25.0)
    for x in samples:
        ours.observe(float(x))
        theirs.observe(float(x))
        assert ours.value == theirs.value and ours.samples == theirs.samples
    gov, jgov = router.HedgeGovernor(7.5), jrouter.HedgeGovernor(7.5)
    for i in range(200):
        for g in (gov, jgov):
            g.note_request()
        if i % 3 == 0:
            allowed = gov.allow()
            assert allowed == jgov.allow()
            if allowed:
                gov.note_hedge()
                jgov.note_hedge()
    assert gov.snapshot() == jgov.snapshot() and gov.rate_pct == jgov.rate_pct
    assert router.HedgeGovernor(0.0).allow() is False


def test_loadgen_schedule_equal_jax():
    np.testing.assert_array_equal(zipf_weights(50, 1.2), jax_zipf_weights(50, 1.2))
    np.testing.assert_array_equal(anchor_ids(7, 8, 100), jax_anchor_ids(7, 8, 100))
    seen = {}
    for name, run in (("port", run_open_loop), ("jax", jax_run_open_loop)):
        calls = []
        lock = threading.Lock()

        def submit(anchor, ids, calls=calls, lock=lock):
            with lock:
                calls.append((anchor, tuple(ids)))

        out = run(submit, qps=400.0, duration_s=0.25, seed=5, id_space=256, batch=4)
        seen[name] = (sorted(calls), out["requests"], out["errors"])
    assert seen["port"] == seen["jax"] and seen["port"][2] == 0


# ----------------------------------------------------------------- fleet ---


def test_fleet_answers_as_one_servant():
    table, fleet = _mk_fleet(3, hedge_budget_pct=0.0)
    rng = np.random.default_rng(2)
    with fleet, Servant({"t": table}, batch_buckets=(8,), device="cpu") as one:
        for _ in range(20):
            ids = rng.integers(0, CAP, 5).astype(np.int32)
            np.testing.assert_array_equal(fleet.pull(ids), one.pull(ids))
        q = table[3]
        assert fleet.topk(q, k=4, exclude=(3,)) == one.topk(q, k=4, exclude=(3,))
        served = [r.requests for r in fleet.replicas()]
        assert sum(served) == 21 and sum(1 for n in served if n) >= 2


def test_fleet_routes_as_jax():
    """Which replica serves each keyed pull: the same in both fleets."""
    rng = np.random.default_rng(4)
    keys = [int(k) for k in rng.integers(0, CAP, 40)]
    served = {}
    for jax in (False, True):
        _, fleet = _mk_fleet(3, hedge_budget_pct=0.0, jax=jax)
        with fleet:
            for k in keys:
                fleet.pull([k])
            served[jax] = {r.id: r.requests for r in fleet.replicas()}
    assert served[False] == served[True]


def test_hedge_first_writer_wins(tmp_path):
    ledger = Ledger(str(tmp_path / "l.jsonl"))
    table, fleet = _mk_fleet(2, ledger=ledger, hedge_budget_pct=100.0, hedge_p95_ms=15.0)
    with fleet:
        reps = {r.id: r for r in fleet.replicas()}
        key = _owned_key(fleet, "r0")
        release = threading.Event()
        reps["r0"].request_hook = lambda kernel: release.wait(10)
        got = fleet.pull([key], key=key)
        release.set()
        np.testing.assert_array_equal(got, table[[key]])
        assert fleet.registry.counter("serve.hedged").value == 1
        assert fleet.registry.counter("serve.hedge_won").value == 1
    ev = ledger.latest("hedge")
    assert ev["primary"] == "r0" and ev["hedge"] == "r1"
    assert "r0->r1" in render_failures(ledger)


def test_open_breaker_demotes_and_typed_failure_reroutes():
    table, fleet = _mk_fleet(2, breaker_threshold=1, hedge_budget_pct=0.0)
    with fleet:
        reps = {r.id: r for r in fleet.replicas()}
        key = _owned_key(fleet, "r0")
        reps["r0"].servant.breakers["pull"].record_failure()
        np.testing.assert_array_equal(fleet.pull([key], key=key), table[[key]])
        assert reps["r0"].requests == 0 and reps["r1"].requests == 1
        assert fleet.health()["status"] == "degraded"
    table, fleet = _mk_fleet(2, hedge_budget_pct=0.0)
    with fleet:
        reps = {r.id: r for r in fleet.replicas()}
        key = _owned_key(fleet, "r0")

        def sick(kernel):
            raise Overloaded("synthetic queue-full")

        reps["r0"].request_hook = sick
        np.testing.assert_array_equal(fleet.pull([key], key=key), table[[key]])
        assert fleet.stats()["reroutes"] == 1


def test_drain_completes_inflight_then_add_replica(tmp_path):
    ledger = Ledger(str(tmp_path / "l.jsonl"))
    table, fleet = _mk_fleet(2, ledger=ledger, hedge_budget_pct=0.0)
    with fleet:
        reps = {r.id: r for r in fleet.replicas()}
        key = _owned_key(fleet, "r0")
        gate, entered = threading.Event(), threading.Event()

        def parked(kernel):
            entered.set()
            assert gate.wait(10)

        reps["r0"].request_hook = parked
        result, records = {}, {}
        puller = threading.Thread(
            target=lambda: result.update(rows=fleet.pull([key], key=key)), daemon=True)
        puller.start()
        assert entered.wait(10)
        drainer = threading.Thread(
            target=lambda: records.update(drain=fleet.drain("r0")), daemon=True)
        drainer.start()
        time.sleep(0.1)
        assert drainer.is_alive() and "drain" not in records
        gate.set()
        puller.join(10)
        drainer.join(10)
        assert not puller.is_alive() and not drainer.is_alive()
        np.testing.assert_array_equal(result["rows"], table[[key]])
        assert records["drain"]["clean"] and records["drain"]["inflight_at_start"] == 1
        assert [r.id for r in fleet.replicas()] == ["r1"]
        np.testing.assert_array_equal(fleet.pull([key], key=key), table[[key]])
        assert fleet.add_replica() == "r2" and len(fleet._ring) == 2
        with pytest.raises(KeyError):
            fleet.drain("r0")
    out = render_failures(ledger)
    assert "DRAIN    r0 start" in out and "DRAIN    r0 complete" in out


def _w2v_ckpt(root, steps, cap=CAP, dim=16):
    for s in steps:
        rng = np.random.default_rng(s)
        shape = rowdma.packed_shape(cap, dim)
        state = convert.w2v_state_from_numpy(
            rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32), device="cpu")
        save_checkpoint(root, state, step=s)
    return Config({"dim": str(dim), "capacity": str(cap), "serve_batch_buckets": "4,16"})


def _rows(root, step, dim=16):
    from swiftsnails_tpu_torch.framework.checkpoint import load_tables

    tree, _ = load_tables(root, step=step, device="cpu")
    return rowdma.unpack_rows(tree["in_table"]["table"], dim).numpy()


def test_from_checkpoint_shares_planes_and_cuts_over_at_one_epoch(tmp_path):
    root = str(tmp_path / "ck")
    cfg = _w2v_ckpt(root, (1,))
    ids = np.arange(0, CAP, 3, dtype=np.int32)
    with Fleet.from_checkpoint(root, cfg, device="cpu", replicas=3) as fleet:
        reps = fleet.replicas()
        assert len({id(r.servant._tables["in_table"]) for r in reps}) == 1
        np.testing.assert_array_equal(fleet.pull(ids), _rows(root, 1)[ids])
        vals = np.full((4, 16), 2.5, np.float32)
        epoch = fleet.apply_rows({"in_table": (np.array([0, 3, 6, 9]), vals)}, step=5)
        assert epoch == 1 and fleet.version == 1 and fleet.step == 5
        assert {r.servant.version for r in fleet.replicas()} == {1}
        assert len({id(r.servant._tables["in_table"]) for r in fleet.replicas()}) == 1
        want = _rows(root, 1)
        want[[0, 3, 6, 9]] = 2.5
        for _ in range(3):  # every replica, cache or not, serves the delta
            np.testing.assert_array_equal(fleet.pull(ids), want[ids])
        _w2v_ckpt(root, (2,))
        _corrupt(root, 2)
        with pytest.raises(CheckpointError):
            fleet.reload_from_checkpoint(root, cfg, step=2)
        assert fleet.version == 1
        assert fleet.registry.counter("fleet.reload_rejected").value == 1
        _w2v_ckpt(root, (3,))
        assert fleet.reload_from_checkpoint(root, cfg) == 2 and fleet.step == 3
        np.testing.assert_array_equal(fleet.pull(ids), _rows(root, 3)[ids])
        # attach_freshness is ported since this test was written: the
        # fleet's health rolls the subscriber's status up with every
        # replica's version
        class _Sub:
            def status(self):
                return {"applied_seq": 7}

        fleet.attach_freshness(_Sub())
        assert fleet.health()["freshness"] == {
            "applied_seq": 7, "replica_versions": {r.id: 2 for r in fleet.replicas()}}


def _corrupt(root, step):
    import pathlib

    victim = max((p for p in pathlib.Path(root, f"step_{step}").iterdir()
                  if p.name != "manifest.json"), key=lambda p: p.stat().st_size)
    blob = bytearray(victim.read_bytes())
    blob[len(blob) // 2] ^= 0xFF
    victim.write_bytes(bytes(blob))


def test_fleet_stats_and_health_keys_equal_jax():
    def keys(d, prefix=""):
        out = set()
        for k, v in d.items():
            if prefix.startswith("replicas.") and prefix.count(".") == 1:
                k = "<rid>"
            out.add(prefix + k)
            if isinstance(v, dict):
                out |= keys(v, prefix + k + ".")
        return out

    got = {}
    for jax in (False, True):
        table, fleet = _mk_fleet(2, hedge_budget_pct=0.0, jax=jax)
        with fleet:
            fleet.pull([1, 2])
            fleet.topk(table[0], k=3)
            got[jax] = (keys(fleet.stats()), keys(fleet.health()))
    assert got[False] == got[True]


def test_fleet_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the default device is then valid")
    root = str(tmp_path / "ck")
    cfg = _w2v_ckpt(root, (1,))
    with pytest.raises(RuntimeError, match="CUDA"):
        Fleet.from_checkpoint(root, cfg, replicas=2)
