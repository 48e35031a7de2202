"""TCP replicas on the port's fleet ring, on the CPU: RemoteServant parity
behind the unchanged router, the shared-epoch apply, stale-epoch refusal,
lease-driven drain + respawn under an injectable clock, spawned
``replica_server`` processes (``--device cpu``, killed in a ``finally``),
the transport chaos kinds, and the net plane's ledger / ops / gate
surfaces — held against the JAX package where both compute the same
thing (the supervisor's leases and verdicts, the chaos plan, the gate).

No test depends on timing: healthy calls get read deadlines far above any
stall a loaded box can cause (a write retried after a spurious timeout
would meet its own epoch and be refused ``StaleEpoch``), fault cases use a
dead or black-holed peer, and lease expiry runs on a fake clock.
"""

import numpy as np
import pytest
import torch

from swiftsnails_tpu.cluster import accounting as jax_acct
from swiftsnails_tpu.cluster import supervisor as jax_sup
from swiftsnails_tpu.resilience import chaos as jax_chaos
from swiftsnails_tpu.telemetry import ledger as jax_ledger

from swiftsnails_tpu_torch.cluster import BatchAccountant, Supervisor, WorkerLost
from swiftsnails_tpu_torch.cluster.accounting import compress_ranges, expand_ranges
from swiftsnails_tpu_torch.framework.checkpoint import save_checkpoint
from swiftsnails_tpu_torch.framework.quality import paired_corpus
from swiftsnails_tpu_torch.models.word2vec import Word2VecTrainer
from swiftsnails_tpu_torch.net.fleet import NetFleet, ReplicaManager, ReplicaSpawner
from swiftsnails_tpu_torch.net.remote import StaleEpoch
from swiftsnails_tpu_torch.net.replica_server import ServantRpcServer
from swiftsnails_tpu_torch.resilience.chaos import ChaosPlan, ChaosSpecError, parse_chaos_spec
from swiftsnails_tpu_torch.serving import Servant
from swiftsnails_tpu_torch.serving.breaker import OPEN
from swiftsnails_tpu_torch.telemetry import ledger as port_ledger
from swiftsnails_tpu_torch.telemetry.ledger import Ledger, check_regression, render_failures
from swiftsnails_tpu_torch.telemetry.ops import render_ops
from swiftsnails_tpu_torch.utils.config import Config

CPU = "cpu"
DIM = 8
CAP = 64
torch.set_num_threads(1)


def _table(seed=0):
    return np.random.default_rng(seed).standard_normal((CAP, DIM)).astype(np.float32)


def _servant(table=None):
    t = _table() if table is None else table
    return Servant({"t": t.copy()}, batch_buckets=(8,), cache_rows=32, device=CPU)


def _cfg(read_ms=30_000):
    return Config({
        "net_connect_timeout_ms": "5000", "net_read_timeout_ms": str(read_ms),
        "retry_max_attempts": "2", "retry_deadline_ms": "60000",
        "retry_base_ms": "2", "retry_cap_ms": "10",
    })


def _serve(n=2, ledger=None):
    servers = [ServantRpcServer(_servant(), ledger=ledger).start() for _ in range(n)]
    fleet = NetFleet.connect([s.address for s in servers], _cfg(), ledger=ledger)
    return servers, fleet


def _close(fleet, servers, *more):
    fleet.close()
    for s in list(servers) + list(more):
        s.stop()
        s.servant.close()


# -------------------------------------------------- serving over the wire ---


def test_tcp_pull_is_bit_identical_to_in_process():
    servers, fleet = _serve()
    try:
        ids = np.array([3, 0, 17, CAP - 1], np.int64)
        reference = servers[0].servant.pull(ids)
        np.testing.assert_array_equal(fleet.pull(ids), reference)
        np.testing.assert_array_equal(reference, _table()[ids])
        st = fleet.stats()
        for rs in st["replicas"].values():
            assert rs["transport"] == "connected" and rs["peer"] and rs["incarnation"]
        q = _table()[5]
        assert fleet.topk(q, k=4) == servers[0].servant.topk(q, k=4)
    finally:
        _close(fleet, servers)


def test_fleet_apply_lands_every_tcp_replica_on_one_epoch():
    servers, fleet = _serve()
    try:
        rows = np.array([4, 8, 15], np.int64)
        vals = np.random.default_rng(5).standard_normal((3, DIM)).astype(np.float32)
        epoch = fleet.apply_rows({"t": (rows, vals)}, step=2)
        assert {s.servant.version for s in servers} == {epoch}
        for s in servers:
            np.testing.assert_array_equal(s.servant.pull(rows), vals)
        np.testing.assert_array_equal(fleet.pull(rows), vals)
        assert {r.servant.step for r in fleet.replicas()} == {2}
    finally:
        _close(fleet, servers)


def test_stale_epoch_refused_after_heal():
    servers, fleet = _serve(n=1)
    try:
        rep = fleet.replicas()[0]
        rows = np.array([1], np.int64)
        vals = np.ones((1, DIM), np.float32)
        assert rep.servant.apply_rows({"t": (rows, vals)}, version=5, step=1) == 5
        with pytest.raises(StaleEpoch):
            rep.servant.apply_rows({"t": (rows, vals)}, version=5, step=1)
        with pytest.raises(StaleEpoch):
            rep.servant.apply_rows({"t": (rows, vals)}, version=3, step=1)
        assert rep.servant.apply_rows({"t": (rows, vals)}, version=6, step=2) == 6
    finally:
        _close(fleet, servers)


def test_int8_rows_cross_the_wire_and_dequantize_like_the_log():
    from swiftsnails_tpu_torch.tiered.store import _np_dequant_unit_rows, _np_quant_unit_rows

    servers, fleet = _serve(n=1)
    try:
        rows = np.array([2, 9], np.int64)
        vals = np.random.default_rng(8).standard_normal((2, DIM)).astype(np.float32)
        codes, scales = _np_quant_unit_rows(vals)
        fleet.replicas()[0].servant.apply_rows(
            {"t": {"rows": rows, "values": codes, "scales": scales}}, version=2)
        np.testing.assert_array_equal(fleet.pull(rows),
                                      _np_dequant_unit_rows(codes, scales, np.float32))
    finally:
        _close(fleet, servers)


def test_partitioned_replica_misses_the_write_and_refuses_it_stale_on_heal():
    """``net_partition``: the black-holed replica's write times out
    (typed), the connected one advances; on heal the stale epoch is refused
    and the replica resyncs at the real one. Only the cut replica's client
    has a short read deadline, and its resync goes through a fresh client
    with a long one."""
    from swiftsnails_tpu_torch.net.remote import RemoteServant
    from swiftsnails_tpu_torch.serving.breaker import Unavailable

    servers = [ServantRpcServer(_servant()).start() for _ in range(2)]
    healthy = RemoteServant(*servers[0].address, config=_cfg())
    cut = RemoteServant(*servers[1].address, config=_cfg(read_ms=2_000))
    resync = RemoteServant(*servers[1].address, config=_cfg())
    try:
        rows = np.array([6], np.int64)
        batch = {"t": (rows, np.full((1, DIM), 2.0, np.float32))}
        pre = int(cut.health()["version"])
        cut.chaos(partition_ms=60_000.0)
        epoch = pre + 1
        assert healthy.apply_rows(batch, version=epoch) == epoch
        with pytest.raises(Unavailable):
            cut.apply_rows(batch, version=epoch)
        cut.chaos(partition_ms=0.0)
        with pytest.raises(StaleEpoch):
            resync.apply_rows(batch, version=pre)
        assert resync.apply_rows(batch, version=epoch) == epoch
        assert {s.servant.version for s in servers} == {epoch}
        np.testing.assert_array_equal(servers[1].servant.pull(rows), batch["t"][1])
    finally:
        for c in (healthy, cut, resync):
            c.close()
        for s in servers:
            s.stop()
            s.servant.close()


def test_breakers_read_open_while_transport_down_and_pull_survives():
    servers, fleet = _serve()
    try:
        ids = np.array([2, 9], np.int64)
        reference = servers[0].servant.pull(ids)
        victim = fleet.replicas()[1]
        servers[1].stop()
        h = victim.servant.health(read_timeout_ms=500.0)
        assert h["status"] == "unreachable"
        assert victim.servant.transport == "reconnecting"
        assert victim.servant.breakers.get("pull").state == OPEN
        for _ in range(4):
            np.testing.assert_array_equal(fleet.pull(ids), reference)
    finally:
        _close(fleet, servers)


# ------------------------------------------------- lease-driven membership ---


class _FakeProc:
    """Stands in for a spawned replica process: points at an in-process
    server."""

    def __init__(self, server):
        self.host, self.port = server.address
        self.incarnation = server.incarnation
        self.pid = 4242
        self.closed = 0

    def close(self):
        self.closed += 1


class _FakeSpawner:
    def __init__(self, server):
        self.server = server
        self.spawned = 0

    def spawn(self):
        self.spawned += 1
        return _FakeProc(self.server)


def test_lease_expiry_drains_ring_and_respawns_with_fresh_incarnation(tmp_path):
    led = Ledger(str(tmp_path / "l.jsonl"))
    servers, fleet = _serve(ledger=led)
    standby = ServantRpcServer(_servant(), ledger=led).start()
    clock = [0.0]
    mgr = ReplicaManager(fleet, spawner=_FakeSpawner(standby), ledger=led,
                         lease_ms=1_000.0, probe_timeout_ms=500.0, clock=lambda: clock[0])
    try:
        assert mgr.tick() == []
        victim = fleet.replicas()[1]
        old = victim.servant.incarnation
        servers[1].stop()
        clock[0] = 2.0  # past the 1000 ms lease
        lost = mgr.tick()
        assert lost == [victim.id] and mgr.respawns == 1
        rids = {r.id for r in fleet.replicas()}
        assert victim.id not in rids and len(rids) == 2
        joined = next(r for r in fleet.replicas()
                      if r.servant.incarnation == standby.incarnation)
        assert joined.servant.incarnation != old
        ids = np.array([7, 30], np.int64)
        np.testing.assert_array_equal(fleet.pull(ids), servers[0].servant.pull(ids))
        events = [r["event"] for r in led.records("transport")]
        assert "drained" in events and "respawn" in events
        assert any(r.get("action") == "worker-lost" for r in led.records("membership"))
    finally:
        mgr.close()
        _close(fleet, servers, standby)


def test_answered_probe_rejoins_instead_of_replacing():
    servers, fleet = _serve()
    clock = [0.0]
    mgr = ReplicaManager(fleet, lease_ms=1_000.0, probe_timeout_ms=500.0,
                         clock=lambda: clock[0])
    try:
        clock[0] = 5.0  # the liveness loop paused, not the replicas
        assert mgr.tick() == []
        assert len(fleet.replicas()) == 2 and mgr.respawns == 0
    finally:
        mgr.close()
        _close(fleet, servers)


# ------------------------------------------ spawned replica processes ---


def _checkpoint(root):
    ids, vocab = paired_corpus(n_pairs=16, reps=4, seed=23)
    cfg = Config({"dim": str(DIM), "packed": "1", "seed": "23", "subsample": "0"})
    tr = Word2VecTrainer(cfg, corpus_ids=ids, vocab=vocab, device=CPU)
    save_checkpoint(root, tr.init_state(), step=1, wait=True)
    return cfg


def test_spawned_replicas_serve_the_checkpoint_and_respawn_after_kill(tmp_path):
    """Two ``replica_server`` processes (``--device cpu``) behind a
    NetFleet: pulls equal the in-process servant's, ``stats`` carries the
    process's row-kernel launch counts, and a SIGKILL'd replica is
    declared lost on lease expiry (a fake clock), drained and replaced by a
    fresh process with a new incarnation that serves the same rows."""
    root = str(tmp_path / "ck")
    cfg = _checkpoint(root)
    net_cfg = Config({**cfg.as_dict(), **_cfg().as_dict()})
    spawner = ReplicaSpawner(root, cfg, device=CPU, startup_timeout_s=120.0)
    procs, fleet, mgr = [], None, None
    try:
        procs = [spawner.spawn(), spawner.spawn()]
        fleet = NetFleet.connect([(p.host, p.port) for p in procs], net_cfg,
                                 checkpoint_root=root)
        clock = [0.0]
        mgr = ReplicaManager(fleet, spawner=spawner, lease_ms=1_000.0,
                             probe_timeout_ms=5_000.0, clock=lambda: clock[0])
        for rep, proc in zip(fleet.replicas(), procs):
            mgr.attach_process(rep.id, proc)
        ids = np.arange(32, dtype=np.int64)
        with Servant.from_checkpoint(root, cfg, device=CPU) as local:
            want = local.pull(ids)
        for rep in fleet.replicas():
            np.testing.assert_array_equal(rep.servant.pull(ids), want)
            st = rep.servant.stats()
            assert set(st["launches"]) == {"gather_rows", "scatter_write_rows"}
            assert rep.servant.health()["status"] == "ok"
        victim = fleet.replicas()[0]
        old = victim.servant.incarnation
        mgr.process_of(victim.id).kill()
        assert mgr.process_of(victim.id).wait(timeout=30.0) is not None
        clock[0] = 5.0
        assert mgr.tick() == [victim.id] and mgr.respawns == 1
        reps = fleet.replicas()
        assert len(reps) == 2 and victim.id not in {r.id for r in reps}
        assert old not in {r.servant.incarnation for r in reps}
        np.testing.assert_array_equal(fleet.pull(ids), want)
    finally:
        if mgr is not None:
            mgr.close()
        if fleet is not None:
            fleet.close()
        for p in procs:
            p.close()


def test_net_serve_cli_prints_the_ready_line_and_serves(tmp_path):
    """``python -m swiftsnails_tpu_torch net-serve --root R --device cpu``:
    one JSON ready line (port, incarnation, step, device), then pulls over
    TCP equal the checkpoint's rows; killed in a ``finally``."""
    import json
    import os
    import subprocess
    import sys

    from swiftsnails_tpu_torch.net.remote import RemoteServant

    root = str(tmp_path / "ck")
    cfg = _checkpoint(root)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (repo, os.environ.get("PYTHONPATH", "")) if p))
    cmd = [sys.executable, "-m", "swiftsnails_tpu_torch", "net-serve", "--root", root,
           "--listen", "127.0.0.1:0", "--device", "cpu",
           *[a for k, v in cfg.as_dict().items() for a in ("--config", f"{k}={v}")]]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                            text=True, env=env)
    client = None
    try:
        from swiftsnails_tpu_torch.net.fleet import _read_ready_line

        ready = _read_ready_line(proc, 120.0)
        assert ready["step"] == 1 and ready["device"] == "cpu" and ready["incarnation"]
        client = RemoteServant(ready["host"], ready["port"], config=_cfg())
        ids = np.arange(16, dtype=np.int64)
        with Servant.from_checkpoint(root, cfg, device=CPU) as local:
            np.testing.assert_array_equal(client.pull(ids), local.pull(ids))
        assert client.health()["incarnation"] == ready["incarnation"]
        json.dumps(client.stats())
    finally:
        if client is not None:
            client.close()
        proc.kill()
        proc.wait(timeout=30)
        proc.stdout.close()


def test_replica_process_without_a_ready_line_is_killed_and_named(tmp_path):
    spawner = ReplicaSpawner(str(tmp_path / "missing"), Config({"dim": "8"}), device=CPU,
                             startup_timeout_s=60.0)
    with pytest.raises(RuntimeError, match="failed to start") as ei:
        spawner.spawn()
    assert "stderr" in str(ei.value)


# ------------------------------------------------------------ the chaos plan ---


def test_chaos_spec_parses_and_fires_the_net_kinds():
    spec = "proc_kill@1,net_partition@2,net_slow@3"
    plan, jplan = ChaosPlan(parse_chaos_spec(spec)), jax_chaos.ChaosPlan(
        jax_chaos.parse_chaos_spec(spec))
    for tick, want in ((0, []), (1, ["proc_kill"]), (1, []), (2, ["net_partition"]),
                       (3, ["net_slow"])):
        assert plan.net_fault(tick) == want == jplan.net_fault(tick)
    with pytest.raises(ChaosSpecError):
        parse_chaos_spec("net_meteor@1")


# -------------------------------------------------- ledger / ops / the gate ---


def test_failures_report_renders_the_transport_timeline(tmp_path):
    led = Ledger(str(tmp_path / "l.jsonl"))
    for rec in ({"event": "proc_kill", "replica": "r1", "pid": 999},
                {"event": "conn_lost", "peer": "127.0.0.1:9", "replica": "r1",
                 "error": "OSError: gone"},
                {"event": "drained", "replica": "r1", "pid": 999},
                {"event": "respawn", "replica": "r1", "replacement": "r2",
                 "incarnation": "abc123", "pid": 1000},
                {"event": "partition", "replica": "r2", "duration_ms": 30000.0},
                {"event": "reconnect", "peer": "127.0.0.1:9", "reconnects": 3}):
        led.append("transport", rec)
    out = render_failures(led)
    for line in ("PROC-KILL", "CONN-LOST", "DRAINED", "RESPAWN", "PARTITION", "RECONNECT"):
        assert line in out
    assert out.splitlines()[1:] == jax_ledger.render_failures(
        jax_ledger.Ledger(str(tmp_path / "l.jsonl"))).splitlines()[1:]


def _net_block(**overrides):
    block = {"availability_pct": 99.6, "availability_floor_pct": 99.0,
             "proc_kill": {"recovered": True}, "partition": {"stale_write_refused": True},
             "tcp_parity": 0.0, "delta": {"parity": 0.0},
             "envelope_x": 12.0, "envelope_limit_x": 60.0}
    block.update(overrides)
    return block


@pytest.mark.parametrize("block", [
    _net_block(), _net_block(availability_pct=95.0, proc_kill={"recovered": False}),
    _net_block(partition={"stale_write_refused": False}, tcp_parity=0.01),
    _net_block(delta={"parity": 0.5}, envelope_x=100.0)],
    ids=["ok", "availability", "stale_parity", "delta_envelope"])
def test_net_gate_verdicts_equal_jax(tmp_path, block):
    path = str(tmp_path / "l.jsonl")
    assert port_ledger._check_net_regression(Ledger(path)) == (0, None)
    Ledger(path).append("bench", {"payload": {
        "metric": "word2vec_words_per_sec_per_chip", "value": 1e5,
        "unit": "words/sec/chip", "platform": "tpu", "config": {}, "net": block}})
    got = port_ledger._check_net_regression(Ledger(path))
    assert got == jax_ledger._check_net_regression(jax_ledger.Ledger(path))
    rc, msg = check_regression(Ledger(path), 10.0)
    assert got[1] in msg and rc == got[0] and (rc == 0) == (block == _net_block())


def test_ops_dashboard_shows_per_replica_transport_state():
    servers, fleet = _serve()
    try:
        out = render_ops(fleet.stats(), health=fleet.health())
        assert "transport" in out and "connected" in out
    finally:
        _close(fleet, servers)


# ---------------------------------------- the supervisor's leases vs JAX ---


class FakeClock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now

    def advance(self, s):
        self.now += s


def test_compress_and_expand_ranges_roundtrip():
    idx = [0, 1, 2, 5, 7, 8, 9]
    assert compress_ranges(idx) == [[0, 3], [5, 6], [7, 10]] == jax_acct.compress_ranges(idx)
    assert expand_ranges(compress_ranges(idx)) == idx
    assert compress_ranges([]) == []


def _acct_script(mod):
    acct = mod.BatchAccountant()
    a = acct.grant("w0", 0, 6)
    b = acct.grant("w1", 0, 4, backup=True)
    out = [acct.try_claim(a.lease_id, 2), acct.commit(a.lease_id, 2),
           acct.try_claim(b.lease_id, 2), acct.try_claim(a.lease_id, 7),
           acct.try_claim(999, 1), acct.commit(a.lease_id, 0), acct.commit(a.lease_id, 0),
           a.watermark, acct.revoke(a.lease_id), acct.try_claim(a.lease_id, 3)]
    for i in (1, 3):
        acct.commit(b.lease_id, i)
    snap = acct.snapshot()
    fresh = mod.BatchAccountant()
    fresh.restore(snap)
    return out, acct.verify(6), snap, [fresh.is_committed(i) for i in range(6)], \
        fresh.leases_of("w0")


def test_accountant_script_equals_jax():
    """Claims, first-writer-wins refusals, the double-commit breach, lease
    bounds, revocation, the exactly-once proof and snapshot / restore."""
    got, want = _acct_script(__import__(
        "swiftsnails_tpu_torch.cluster.accounting", fromlist=["x"])), _acct_script(jax_acct)
    assert got == want
    assert got[1]["duplicated"] == [0] and not got[1]["exact"] and got[4] == []


def _lease_script(mod, clock, ledger):
    sup = mod.Supervisor(total_batches=32, lease_ms=1000.0, ledger=ledger, clock=clock)
    sup.register("w0")
    sup.register("w1")
    dead = sup.next_range("w0")
    sup.accountant.commit(dead.lease_id, dead.lo)
    clock.advance(0.5)
    sup.heartbeat("w1")
    clock.advance(0.8)
    lost = sup.poll()
    try:
        sup.heartbeat("w0")
        stale = None
    except mod.WorkerLost as e:
        stale = e.worker
    adopted = [(lease.lo, lease.hi) for lease in sup.heartbeat("w1")["adopted"]]
    sup.register("w0")  # a rejoin is a fresh member
    return lost, stale, adopted, (dead.lo, dead.hi), sup.status(), sup.alive()


def test_lease_expiry_declares_worker_lost_and_reassigns_as_jax(tmp_path):
    p_led, j_led = Ledger(str(tmp_path / "p.jsonl")), jax_ledger.Ledger(str(tmp_path / "j.jsonl"))
    got = _lease_script(__import__("swiftsnails_tpu_torch.cluster.supervisor",
                                   fromlist=["x"]), FakeClock(), p_led)
    want = _lease_script(jax_sup, FakeClock(), j_led)
    assert got == want
    lost, stale, adopted, dead, _, alive = got
    assert lost == ["w0"] and stale == "w0" and adopted == [(dead[0] + 1, dead[1])]
    assert alive == ["w0", "w1"]
    strip = lambda recs: [{k: v for k, v in r.items() if k not in ("ts", "env")}
                          for r in recs]
    assert strip(p_led.records("membership")) == strip(j_led.records("membership"))


def _straggler_script(mod, backup):
    clock = FakeClock()
    sup = mod.Supervisor(total_batches=1000, lease_ms=1e6, grant_batches=8,
                         straggler_ewma=1.0, backup_substeps=backup, clock=clock)
    for w in ("w0", "w1", "w2"):
        sup.register(w)
    slow = sup.next_range("w2")
    for _ in range(3):
        sup.heartbeat("w0", step_ms=100.0)
        sup.heartbeat("w1", step_ms=100.0)
    d = sup.heartbeat("w2", step_ms=1000.0)
    shrunk = sup.next_range("w2")
    backups = [(lease.worker, lease.lo, lease.hi) for w in ("w0", "w1")
               for lease in sup.accountant.leases_of(w) if lease.backup]
    sup.heartbeat("w2", step_ms=90.0)
    return d, (slow.lo, slow.hi), (shrunk.lo, shrunk.hi), backups, sup.status()


@pytest.mark.parametrize("backup", [0, 2])
def test_straggler_share_and_backup_substeps_as_jax(backup):
    got = _straggler_script(__import__("swiftsnails_tpu_torch.cluster.supervisor",
                                       fromlist=["x"]), backup)
    assert got == _straggler_script(jax_sup, backup)
    d, slow, shrunk, backups, status = got
    assert d["straggler"] and d["share"] == 0.5 and shrunk[1] - shrunk[0] == 4
    assert backups == ([("w0", slow[0], slow[0] + 2)] if backup else [])
    assert not status["workers"]["w2"]["straggler"]  # cleared after recovery


def test_elastic_restore_returns_uncommitted_spans_to_pool():
    clock = FakeClock()
    sup = Supervisor(total_batches=32, lease_ms=1e6, grant_batches=8, clock=clock)
    sup.register("w0")
    lease = sup.next_range("w0")
    for i in range(lease.lo, lease.lo + 3):
        sup.accountant.commit(lease.lease_id, i)
    fresh = Supervisor(total_batches=32, lease_ms=1e6, clock=clock)
    fresh.register("wX")
    fresh.restore(sup.cursor())
    assert fresh._frontier == lease.hi and fresh._free == [[lease.lo + 3, lease.hi]]
    regrant = fresh.next_range("wX")
    assert (regrant.lo, regrant.hi) == (lease.lo + 3, lease.hi)
    with pytest.raises(WorkerLost):
        fresh.next_range("nobody")
    acct = BatchAccountant()
    assert acct.verify(0)["exact"]
