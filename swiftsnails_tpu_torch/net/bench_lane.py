"""The ``net`` lane: TCP serving + liveness + delta streaming — the JAX
package's ``net/bench_lane.py``, with the port's fleet. The in-process
fleet and every spawned replica run on ``device`` (default: the card;
``device="cpu"`` runs the plain versions). The port has no bench script
that writes its block into the ledger yet (``ROADMAP.md``). Three legs,
all on real sockets and real processes:

- **local control**: the same checkpoint served by an in-process
  2-replica :class:`Fleet` under the open-loop load generator — the
  in-process p99 the TCP leg is enveloped against;
- **TCP fleet**: two spawned ``replica_server`` processes behind a
  :class:`NetFleet`; rows pulled over the wire must be bit-identical to
  the reference checkpoint (``tcp_parity`` = 0.0 required), and the TCP
  p99 must land within ``envelope_limit_x`` of the in-process p99
  measured in the same run (same-platform by construction);
- **fault storm**: ``proc_kill`` — a replica is SIGKILL'd mid-load and
  must be declared lost by lease expiry, drained from the ring,
  respawned, and serving again with a fresh incarnation, with
  availability ≥ ``availability_floor_pct`` through the whole storm;
  ``net_partition`` — a black-holed replica misses an epoch, and on heal
  a stale write (epoch at/below its own) must be REFUSED typed
  (:class:`StaleEpoch`) before the replica resyncs; publisher kill — the
  delta stream's publisher dies mid-stream and a new incarnation takes
  over, and the TCP-fed subscriber must fall back and reconverge to
  whole-plane bit parity 0.0.

Correctness (availability, stale-write refusal, parity) gates on any
platform; the envelope is a ratio of two latencies measured back-to-back
in one process, so it is same-platform wherever it runs. The block is the
one the ``ledger-report --check-regression`` gate reads (see
``_check_net_regression``).
"""

from __future__ import annotations

import os
import tempfile
import threading
import time
from typing import Dict, List, Optional

import numpy as np

NET_SEED = 23
# TCP p99 vs in-process p99, same run: loopback TCP adds syscalls, the
# frame codec, and — because a RemoteServant multiplexes its requests over
# ONE connection — queueing in the tail under concurrent load. Generous
# because CI boxes stall, but a pathological transport (per-call
# reconnects, hundreds-of-ms stalls) must fail the gate
ENVELOPE_LIMIT_X = 60.0
AVAILABILITY_FLOOR_PCT = 99.0
# fast lease for drills: a SIGKILL'd replica must be declared lost, drained
# and respawned within a couple of liveness rounds, not 15s of wall clock
DRILL_LEASE_MS = 600.0
DRILL_PROBE_TIMEOUT_MS = 250.0


def _emit_transport(ledger, event: str, **extra) -> None:
    """Drill-side transport timeline marks (PROC-KILL / PARTITION) so the
    ``ledger-report --failures`` view shows the injection next to the
    CONN-LOST / RESPAWN lines the clients and manager emit in response."""
    if ledger is None:
        return
    try:
        ledger.append("transport", {"event": event, **extra})
    except Exception:
        pass


def _serve_cfg(extra: Optional[Dict] = None):
    from swiftsnails_tpu_torch.utils.config import Config

    base = {
        "dim": "16", "capacity": str(1 << 9), "packed": "0",
        "seed": str(NET_SEED), "subsample": "0",
        # snappy transport for drills: a dead peer costs ~0.5s, not 3s
        "net_connect_timeout_ms": "500", "net_read_timeout_ms": "1000",
        "net_lease_ms": str(DRILL_LEASE_MS),
    }
    base.update({k: str(v) for k, v in (extra or {}).items()})
    return Config(base)


def _build_checkpoint(workdir: str, device=None):
    """Train-free checkpoint build (the freshness drill idiom): init a
    small word2vec state and save it — the lane measures serving and
    transport, not training."""
    from swiftsnails_tpu_torch.framework.checkpoint import save_checkpoint
    from swiftsnails_tpu_torch.framework.quality import paired_corpus
    from swiftsnails_tpu_torch.models.word2vec import Word2VecTrainer
    from swiftsnails_tpu_torch.serving.engine import Servant

    cfg = _serve_cfg()
    ids, vocab = paired_corpus(n_pairs=32, reps=4, seed=NET_SEED)
    trainer = Word2VecTrainer(cfg, corpus_ids=ids, vocab=vocab, device=device)
    state = trainer.init_state()
    ck_root = os.path.join(workdir, "ckpt")
    save_checkpoint(ck_root, state, step=1, wait=True)
    reference = Servant.from_checkpoint(ck_root, cfg, device=device)
    return ck_root, cfg, reference


def _spawn_n(spawner, n: int) -> List:
    """Spawn ``n`` replica processes concurrently (each pays a Python +
    torch import and its own CUDA context on startup; serialized spawns
    would double the lane)."""
    procs: List = [None] * n
    errs: List[BaseException] = []

    def _one(i: int) -> None:
        try:
            procs[i] = spawner.spawn()
        except BaseException as e:  # surfaced after join
            errs.append(e)

    threads = [threading.Thread(target=_one, args=(i,), daemon=True)
               for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errs:
        for p in procs:
            if p is not None:
                p.close()
        raise errs[0]
    return procs


def _tcp_parity(reference, fleet) -> float:
    """Whole-plane mismatch fraction, pulled over the wire: every row of
    every table, from every replica, must be bit-identical to the
    reference checkpoint's planes."""
    bad = total = 0
    for rep in fleet.replicas():
        for name, want in reference._tables.items():
            want = want.cpu().numpy()
            got = np.asarray(rep.servant.pull(
                np.arange(want.shape[0], dtype=np.int64), table=name))
            bad += int(np.sum(want.astype(got.dtype, copy=False) != got))
            total += int(want.size)
    return float(bad) / float(total) if total else 1.0


def _load(fleet, *, qps: float, duration_s: float, seed: int,
          id_space: int) -> Dict:
    from swiftsnails_tpu_torch.serving.loadgen import run_open_loop

    return run_open_loop(
        lambda anchor, ids: fleet.pull(ids),
        qps=qps, duration_s=duration_s, seed=seed,
        id_space=id_space, batch=16, zipf_a=1.2)


def net_bench(small: bool = False, workdir: Optional[str] = None,
              ledger=None, device=None) -> Dict:
    """Run the net lane; returns the ``net`` block for the bench JSON.

    Gated fields (``ledger-report --check-regression``): ``tcp_parity``
    (0.0, any platform), ``proc_kill.availability_pct`` vs
    ``availability_floor_pct`` and ``proc_kill.recovered`` (any
    platform), ``partition.stale_write_refused`` (any platform),
    ``delta.parity`` (0.0, any platform), and ``envelope_x`` vs
    ``envelope_limit_x`` (same-run ratio).
    """
    from swiftsnails_tpu_torch.net.fleet import (
        NetFleet,
        ReplicaManager,
        ReplicaSpawner,
    )
    from swiftsnails_tpu_torch.serving.fleet import Fleet

    qps, load_s = (40.0, 1.5) if small else (80.0, 3.0)
    own_tmp = None
    if workdir is None:
        own_tmp = tempfile.TemporaryDirectory(prefix="ssn-net-")
        workdir = own_tmp.name
    try:
        ck_root, cfg, reference = _build_checkpoint(workdir, device)
        id_space = int(reference._tables["in_table"].shape[0])

        # -- leg 1: in-process control --------------------------------------
        local = Fleet.from_checkpoint(ck_root, cfg, replicas=2,
                                      ledger=ledger, device=device)
        try:
            _load(local, qps=qps, duration_s=load_s / 2,
                  seed=NET_SEED - 1, id_space=id_space)  # warmup compiles
            res_local = _load(local, qps=qps, duration_s=load_s,
                              seed=NET_SEED, id_space=id_space)
        finally:
            local.close()

        # -- leg 2: TCP fleet over spawned replica processes ----------------
        ledger_path = getattr(ledger, "path", "") or ""
        spawner = ReplicaSpawner(ck_root, cfg, ledger_path=str(ledger_path),
                                 device=device)
        procs = _spawn_n(spawner, 2)
        fleet = NetFleet.connect([(p.host, p.port) for p in procs], cfg,
                                 checkpoint_root=ck_root, ledger=ledger)
        manager = ReplicaManager(
            fleet, spawner=spawner, config=cfg, ledger=ledger,
            probe_timeout_ms=DRILL_PROBE_TIMEOUT_MS)
        for rep, proc in zip(fleet.replicas(), procs):
            manager.attach_process(rep.id, proc)
        try:
            tcp_parity = _tcp_parity(reference, fleet)
            _load(fleet, qps=qps, duration_s=load_s / 2,
                  seed=NET_SEED - 1, id_space=id_space)
            res_tcp = _load(fleet, qps=qps, duration_s=load_s,
                            seed=NET_SEED, id_space=id_space)
            envelope_x = (res_tcp["p99_ms"]
                          / max(res_local["p99_ms"], 1.0))

            # -- leg 3: fault storm -----------------------------------------
            partition = _partition_drill(fleet, reference, ledger=ledger)
            proc_kill = _proc_kill_drill(
                fleet, manager, qps=qps, duration_s=max(load_s, 2.0),
                id_space=id_space, ledger=ledger)
            delta = _publisher_kill_drill(
                fleet, reference, cfg, ck_root,
                os.path.join(workdir, "deltas"), ledger=ledger)

            return {
                "small": bool(small),
                "replicas": len(fleet.replicas()),
                "qps_local": res_local["achieved_qps"],
                "qps_tcp": res_tcp["achieved_qps"],
                "p99_local_ms": res_local["p99_ms"],
                "p99_tcp_ms": res_tcp["p99_ms"],
                "p50_tcp_ms": res_tcp["p50_ms"],
                "envelope_x": envelope_x,
                "envelope_limit_x": ENVELOPE_LIMIT_X,
                "tcp_parity": tcp_parity,
                "availability_pct": proc_kill["availability_pct"],
                "availability_floor_pct": AVAILABILITY_FLOOR_PCT,
                "respawns": manager.respawns,
                "proc_kill": proc_kill,
                "partition": partition,
                "delta": delta,
            }
        finally:
            manager.close()
            fleet.close()
    finally:
        if own_tmp is not None:
            own_tmp.cleanup()


def _proc_kill_drill(fleet, manager, *, qps: float, duration_s: float,
                     id_space: int, ledger=None) -> Dict:
    """SIGKILL a replica process mid-load. The lease protocol must declare
    it lost, drain it from the ring, respawn a replacement, and have it
    rejoin and serve — fully automatically — while availability through
    the storm stays over the floor (the router demotes the dead replica
    via OPEN breakers and re-routes its in-flight misses)."""
    from swiftsnails_tpu_torch.net.fleet import kill_pid

    victim = fleet.replicas()[0]
    proc = manager.process_of(victim.id)
    before = len(fleet.replicas())
    manager.start(interval_s=0.1)

    def _kill() -> None:
        if proc is None:
            return
        _emit_transport(ledger, "proc_kill", replica=victim.id, pid=proc.pid)
        kill_pid(proc.pid)

    try:
        timer = threading.Timer(duration_s * 0.3, _kill)
        timer.start()
        res = _load(fleet, qps=qps, duration_s=duration_s,
                    seed=NET_SEED + 1, id_space=id_space)
        timer.cancel()
        # the storm is over; give the liveness loop time to finish the
        # lost -> drain -> respawn -> rejoin arc it started mid-load
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            if (manager.respawns >= 1
                    and len(fleet.replicas()) >= before
                    and victim.id not in
                    [r.id for r in fleet.replicas()]):
                break
            time.sleep(0.05)
    finally:
        manager.stop()
    reps = fleet.replicas()
    sup_workers = manager.supervisor.status().get("workers", {})
    lost_detected = (not sup_workers.get(victim.id, {}).get("alive", True)
                     or manager.respawns >= 1)
    rejoined = len(reps) >= before and victim.id not in [r.id for r in reps]
    incarnations = {r.id: r.servant.incarnation for r in reps}
    try:
        rows = fleet.pull(np.arange(8, dtype=np.int64))
        serves = int(np.asarray(rows).shape[0]) == 8
    except Exception:
        serves = False
    availability = 100.0 - float(res["error_rate_pct"])
    return {
        "killed": victim.id,
        "killed_pid": proc.pid if proc is not None else None,
        "requests": res["requests"],
        "errors": res["errors"],
        "availability_pct": availability,
        "p99_ms": res["p99_ms"],
        "lost_detected": bool(lost_detected),
        "respawned": manager.respawns >= 1,
        "rejoined": bool(rejoined),
        "serves": bool(serves),
        "incarnations": incarnations,
        "recovered": bool(lost_detected and manager.respawns >= 1
                          and rejoined and serves
                          and availability >= AVAILABILITY_FLOOR_PCT),
    }


def _partition_drill(fleet, reference, ledger=None) -> Dict:
    """Black-hole one replica, advance the epoch on the other side, heal,
    and prove the healed replica REFUSES the stale epoch (typed
    :class:`StaleEpoch`) before resyncing at the current one."""
    from swiftsnails_tpu_torch.net.remote import StaleEpoch
    from swiftsnails_tpu_torch.serving.breaker import Unavailable
    from swiftsnails_tpu_torch.serving.engine import Overloaded

    reps = fleet.replicas()
    healthy, cut = reps[0].servant, reps[1].servant
    plane = reference._tables["in_table"].cpu().numpy()
    rng = np.random.default_rng(NET_SEED + 2)
    rows = np.sort(rng.choice(plane.shape[0], size=8, replace=False))
    batch = {"in_table": (rows.astype(np.int64), plane[rows])}

    pre_version = int(cut.version)
    _emit_transport(ledger, "partition", replica=reps[1].id,
                    duration_ms=30_000.0)
    cut.chaos(partition_ms=30_000.0)
    epoch = fleet._next_epoch()
    healthy.apply_rows(batch, version=epoch)  # the connected side advances
    missed = False
    try:
        cut.apply_rows(batch, version=epoch)  # black-holed: must NOT land
    except (Unavailable, Overloaded):
        missed = True
    cut.chaos(partition_ms=0.0)  # heal
    cut.health()  # resync the cached snapshot off the healed transport
    stale_refused = False
    try:
        # the write that was stuck behind the partition: epoch at/below
        # the replica's own version — refusing it is the heal-side gate
        cut.apply_rows(batch, version=pre_version)
    except StaleEpoch:
        stale_refused = True
    cut.apply_rows(batch, version=epoch)  # the resync, at the real epoch
    versions = {r.id: int(r.servant.version) for r in fleet.replicas()}
    resynced = len(set(versions.values())) == 1 and \
        int(cut.version) == epoch
    return {
        "missed_write_during_partition": bool(missed),
        "stale_write_refused": bool(stale_refused),
        "resynced": bool(resynced),
        "versions": versions,
        "recovered": bool(missed and stale_refused and resynced),
    }


def _publisher_kill_drill(fleet, reference, cfg, ck_root: str,
                          delta_dir: str, ledger=None) -> Dict:
    """Stream deltas to the fleet over TCP, kill the publisher mid-stream
    (a NEW incarnation takes over the directory), and require the
    subscriber to fall back, resubscribe, and reconverge to whole-plane
    bit parity 0.0 — the file poll's recovery ladder, over a socket."""
    from swiftsnails_tpu_torch.freshness.publisher import DeltaPublisher
    from swiftsnails_tpu_torch.freshness.subscriber import DeltaSubscriber
    from swiftsnails_tpu_torch.net.delta_stream import (
        DeltaStreamServer,
        TcpDeltaSource,
    )

    plane = reference._tables["in_table"].cpu().numpy()
    rng = np.random.default_rng(NET_SEED + 3)

    def _batch():
        rows = np.sort(rng.choice(plane.shape[0], size=8, replace=False))
        return {"in_table": (rows.astype(np.int64), plane[rows])}

    pub = DeltaPublisher(delta_dir, base_step=1, ledger=ledger)
    pub.publish(_batch(), step=2)
    pub.publish(_batch(), step=3)

    sub = DeltaSubscriber(fleet, delta_dir, config=cfg,
                          checkpoint_root=ck_root, ledger=ledger)
    with DeltaStreamServer(delta_dir, ledger=ledger).start() as server:
        src = TcpDeltaSource(sub, *server.address, config=cfg,
                             ledger=ledger).start()
        try:
            _wait(lambda: sub.status()["applied_seq"] >= 2, 20.0)
            # mid-stream publisher kill: a fresh incarnation reopens the
            # directory — the stream re-sends its base, the subscriber
            # must detect the restart and fall back
            pub2 = DeltaPublisher(delta_dir, base_step=3, ledger=ledger)
            pub2.publish(_batch(), step=4)
            converged = _wait(
                lambda: (sub.status()["fallbacks"] >= 1
                         and sub.status()["applied_step"] >= 4), 30.0)
        finally:
            src.stop()
    st = sub.status()
    parity = _tcp_parity(reference, fleet)
    return {
        "parity": parity,
        "fallbacks": st["fallbacks"],
        "applied_seq": st["applied_seq"],
        "applied_step": st["applied_step"],
        "frames": src.frames,
        "reconnects": src.reconnects,
        "recovered": bool(converged and parity == 0.0),
    }


def _wait(cond, timeout_s: float) -> bool:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return bool(cond())


def net_chaos_drill(small: bool = True, workdir: Optional[str] = None,
                    ledger=None, device=None) -> Dict:
    """The chaos matrix of the network plane (the JAX package's
    ``tools/chaos_drill.py --net``): the three transport
    chaos kinds fired from a :class:`ChaosPlan` spec against REAL spawned
    replica processes, each required to recover:

    - ``proc_kill``: SIGKILL -> lease expiry -> drain -> respawn ->
      rejoin with a fresh incarnation -> serves;
    - ``net_partition``: black-hole -> missed epoch -> heal -> stale
      write refused typed -> resync;
    - ``net_slow``: injected server-side delay above the read timeout ->
      client deadlines fire (never a hang) -> recovers to fast serving
      when the slowness clears.
    """
    from swiftsnails_tpu_torch.net.fleet import (
        NetFleet,
        ReplicaManager,
        ReplicaSpawner,
    )
    from swiftsnails_tpu_torch.net.remote import StaleEpoch
    from swiftsnails_tpu_torch.resilience.chaos import ChaosPlan, parse_chaos_spec
    from swiftsnails_tpu_torch.serving.breaker import Unavailable
    from swiftsnails_tpu_torch.serving.engine import Overloaded

    own_tmp = None
    if workdir is None:
        own_tmp = tempfile.TemporaryDirectory(prefix="ssn-net-drill-")
        workdir = own_tmp.name
    try:
        ck_root, cfg, reference = _build_checkpoint(workdir, device)
        plane = reference._tables["in_table"].cpu().numpy()
        rng = np.random.default_rng(NET_SEED)
        ledger_path = getattr(ledger, "path", "") or ""
        spawner = ReplicaSpawner(ck_root, cfg, ledger_path=str(ledger_path),
                                 device=device)
        procs = _spawn_n(spawner, 2)
        fleet = NetFleet.connect([(p.host, p.port) for p in procs], cfg,
                                 checkpoint_root=ck_root, ledger=ledger)
        manager = ReplicaManager(
            fleet, spawner=spawner, config=cfg, ledger=ledger,
            probe_timeout_ms=DRILL_PROBE_TIMEOUT_MS)
        for rep, proc in zip(fleet.replicas(), procs):
            manager.attach_process(rep.id, proc)

        # the storm schedule comes from the chaos-spec syntax — the same
        # plan ticks bench/train storms use, now with transport kinds
        plan = ChaosPlan(parse_chaos_spec(
            "proc_kill@1,net_partition@2,net_slow@3"), seed=NET_SEED,
            ledger=ledger)
        drills: Dict[str, Dict] = {}
        try:
            for tick in (1, 2, 3):
                for kind in plan.net_fault(tick):
                    if kind == "proc_kill":
                        drills[kind] = _drill_kill(fleet, manager)
                    elif kind == "net_partition":
                        drills[kind] = _drill_partition(
                            fleet, plane, rng, StaleEpoch,
                            (Unavailable, Overloaded))
                    else:
                        drills[kind] = _drill_slow(fleet)
        finally:
            manager.close()
            fleet.close()
        drills["recovered_all"] = all(
            v.get("recovered") for v in drills.values()
            if isinstance(v, dict))
        return drills
    finally:
        if own_tmp is not None:
            own_tmp.cleanup()


def _drill_kill(fleet, manager) -> Dict:
    """SIGKILL one replica, then tick the liveness loop until the lease
    expires and the replacement rejoins."""
    victim = fleet.replicas()[0]
    proc = manager.process_of(victim.id)
    proc.kill()
    proc.wait(timeout=5.0)
    recovered = False
    deadline = time.monotonic() + 30.0
    while time.monotonic() < deadline:
        manager.tick()
        reps = fleet.replicas()
        if (manager.respawns >= 1 and len(reps) >= 2
                and victim.id not in [r.id for r in reps]):
            recovered = True
            break
        time.sleep(0.1)
    try:
        serves = np.asarray(
            fleet.pull(np.arange(4, dtype=np.int64))).shape[0] == 4
    except Exception:
        serves = False
    return {
        "killed": victim.id,
        "respawns": manager.respawns,
        "replicas": [r.id for r in fleet.replicas()],
        "serves": bool(serves),
        "recovered": bool(recovered and serves),
    }


def _drill_partition(fleet, plane, rng, stale_exc, transport_excs) -> Dict:
    reps = fleet.replicas()
    healthy, cut = reps[0].servant, reps[1].servant
    rows = np.sort(rng.choice(plane.shape[0], size=8, replace=False))
    batch = {"in_table": (rows.astype(np.int64), plane[rows])}
    pre = int(cut.version)
    cut.chaos(partition_ms=30_000.0)
    epoch = fleet._next_epoch()
    healthy.apply_rows(batch, version=epoch)
    missed = False
    try:
        cut.apply_rows(batch, version=epoch)
    except transport_excs:
        missed = True
    cut.chaos(partition_ms=0.0)
    cut.health()
    refused = False
    try:
        cut.apply_rows(batch, version=pre)
    except stale_exc:
        refused = True
    cut.apply_rows(batch, version=epoch)
    return {
        "missed_write_during_partition": bool(missed),
        "stale_write_refused": bool(refused),
        "resynced": int(cut.version) == epoch,
        "recovered": bool(missed and refused
                          and int(cut.version) == epoch),
    }


def _drill_slow(fleet) -> Dict:
    """Inject server-side delay above the read timeout: the client's
    deadline must fire (typed, never a hang) and serving must recover to
    sub-timeout latency once the slowness clears."""
    from swiftsnails_tpu_torch.serving.breaker import Unavailable
    from swiftsnails_tpu_torch.serving.engine import Overloaded

    victim = fleet.replicas()[0].servant
    read_timeout_ms = victim.client.read_timeout_ms
    victim.chaos(slow_ms=read_timeout_ms * 3.0)
    t0 = time.monotonic()
    timed_out = False
    try:
        victim.pull(np.arange(4, dtype=np.int64))
    except (Unavailable, Overloaded):
        timed_out = True
    stall_ms = (time.monotonic() - t0) * 1e3
    # the deadline must bound the stall: attempts x read timeout plus the
    # policy's backoff budget, nowhere near the injected 3x delay x tries
    bounded = stall_ms < read_timeout_ms * 6.0
    victim.chaos(slow_ms=0.0)
    victim.health()
    t0 = time.monotonic()
    try:
        ok = np.asarray(victim.pull(
            np.arange(4, dtype=np.int64))).shape[0] == 4
    except Exception:
        ok = False
    fast_ms = (time.monotonic() - t0) * 1e3
    return {
        "timed_out_typed": bool(timed_out),
        "stall_ms": stall_ms,
        "stall_bounded": bool(bounded),
        "recovered_ms": fast_ms,
        "recovered": bool(timed_out and bounded and ok),
    }
