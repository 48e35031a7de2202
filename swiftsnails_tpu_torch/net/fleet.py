"""Remote replicas on the fleet ring + lease-driven membership — the JAX
package's ``net/fleet.py``, in the port.

Three pieces compose what the in-process fleet already does into a
multi-process deployment (docs/NETWORK.md):

* :class:`ReplicaProcess` / :class:`ReplicaSpawner` — spawn
  ``python -m swiftsnails_tpu_torch.net.replica_server`` over a checkpoint root
  and read its one-line JSON ready handshake (port + incarnation). Each
  replica is a new interpreter (``subprocess.Popen``, never a ``fork`` of a
  process that may hold a CUDA context) that opens its own context on the
  card, or runs on the CPU when the spawner is given ``device="cpu"``;
* :class:`NetFleet` — a :class:`~swiftsnails_tpu_torch.serving.fleet.Fleet`
  whose replicas are :class:`~swiftsnails_tpu_torch.net.remote.RemoteServant`\\ s.
  The router/breaker/hedge machinery is inherited UNCHANGED — remote
  replicas satisfy the same servant surface. Freshness reload fans out as
  ``reload_checkpoint`` RPCs (the wire ships a path, not planes);
* :class:`ReplicaManager` — replica liveness on the
  :class:`~swiftsnails_tpu_torch.cluster.supervisor.Supervisor` lease protocol:
  a background loop health-probes every replica and renews its lease on
  success; an expired lease (SIGKILL'd process, black-holed host) emits
  the ``membership`` worker-lost event, drains the replica from the ring,
  SIGKILLs any still-running process, and — when a spawner is attached —
  respawns a replacement that rejoins with a fresh incarnation. The same
  loop runs the autoscale hook: a p95 above the measured knee or a stale
  freshness watermark spawns one more replica (``net_autoscale``).
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from swiftsnails_tpu_torch.cluster.supervisor import Supervisor, WorkerLost
from swiftsnails_tpu_torch.net.remote import RemoteServant
from swiftsnails_tpu_torch.serving.fleet import Fleet

DEFAULT_LEASE_MS = 3_000.0
DEFAULT_PROBE_TIMEOUT_MS = 500.0
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class ReplicaProcess:
    """One spawned replica_server process and its ready handshake."""

    def __init__(self, proc: subprocess.Popen, host: str, port: int,
                 incarnation: str, stderr=None):
        self.proc = proc
        self.host = host
        self.port = int(port)
        self.incarnation = incarnation
        self._stderr = stderr  # the process's stderr file, closed with it

    @property
    def pid(self) -> int:
        return self.proc.pid

    @property
    def alive(self) -> bool:
        return self.proc.poll() is None

    def kill(self) -> None:
        """SIGKILL — the ``proc_kill`` chaos kind and the manager's
        cleanup both use the no-goodbyes signal on purpose."""
        try:
            self.proc.kill()
        except OSError:
            pass

    def terminate(self) -> None:
        try:
            self.proc.terminate()
        except OSError:
            pass

    def wait(self, timeout: Optional[float] = None) -> Optional[int]:
        try:
            return self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            return None

    def close(self) -> None:
        self.kill()
        self.wait(timeout=5.0)
        if self.proc.stdout is not None:
            self.proc.stdout.close()
        if self._stderr is not None:
            self._stderr.close()
            self._stderr = None


class ReplicaSpawner:
    """Spawn replica processes over one checkpoint root + config, on the
    card unless ``device="cpu"``. ``startup_timeout_s`` bounds the ready
    line: interpreter start, the CUDA context and the checkpoint load (two
    ``[1,048,576, 200]`` f32 tables take seconds)."""

    def __init__(
        self,
        root: str,
        config=None,
        *,
        host: str = "127.0.0.1",
        ledger_path: str = "",
        env: Optional[Dict[str, str]] = None,
        startup_timeout_s: float = 180.0,
        device: Optional[str] = None,
    ):
        self.root = root
        self.config = config
        self.host = host
        self.ledger_path = ledger_path
        self.env = env
        self.startup_timeout_s = float(startup_timeout_s)
        self.device = device

    def spawn(self) -> ReplicaProcess:
        cmd = [sys.executable, "-m", "swiftsnails_tpu_torch.net.replica_server",
               "--root", self.root, "--listen", f"{self.host}:0"]
        if self.config is not None:
            for k, v in sorted(self.config.as_dict().items()):
                cmd += ["--config", f"{k}={v}"]
        if self.ledger_path:
            cmd += ["--ledger", self.ledger_path]
        if self.device:
            cmd += ["--device", str(self.device)]
        env = dict(os.environ)
        # the package's own checkout first, whatever the caller's cwd
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (_REPO_ROOT, env.get("PYTHONPATH", "")) if p)
        if self.env:
            env.update(self.env)
        err = tempfile.TemporaryFile(mode="w+")
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=err, env=env, text=True)
        try:
            ready = _read_ready_line(proc, self.startup_timeout_s, err)
        except BaseException:
            err.close()
            raise
        return ReplicaProcess(proc, ready.get("host", self.host),
                              ready["port"], ready.get("incarnation", ""), stderr=err)


def _read_ready_line(proc: subprocess.Popen, timeout_s: float, err=None) -> Dict:
    """Read the one-line JSON handshake with a hard deadline (a replica
    that never comes up is killed, not waited on forever); the error names
    the tail of the process's stderr."""
    result: Dict = {}
    errs: List[BaseException] = []

    def _reader():
        try:
            line = proc.stdout.readline()
            result.update(json.loads(line))
        except BaseException as e:  # noqa: BLE001 — reported below
            errs.append(e)

    t = threading.Thread(target=_reader, daemon=True)
    t.start()
    t.join(timeout=timeout_s)
    if t.is_alive() or errs or "port" not in result:
        try:
            proc.kill()
        except OSError:
            pass
        proc.wait(timeout=5.0)
        proc.stdout.close()
        detail = errs[0] if errs else "no ready line"
        tail = ""
        if err is not None:
            err.seek(0)
            tail = err.read()[-2000:]
        raise RuntimeError(
            f"replica_server failed to start within {timeout_s:.0f}s "
            f"({detail}); stderr: {tail}")
    return result


class NetFleet(Fleet):
    """A Fleet of RemoteServants. Construction takes endpoints instead of
    a checkpoint (the replicas already loaded their own planes)."""

    @classmethod
    def connect(
        cls,
        endpoints: Sequence[Tuple[str, int]],
        config,
        *,
        checkpoint_root: Optional[str] = None,
        ledger=None,
        registry=None,
        **fleet_kwargs,
    ) -> "NetFleet":
        eps = list(endpoints)
        if not eps:
            raise ValueError("NetFleet.connect: no endpoints")

        def factory(rid: str) -> RemoteServant:
            if not eps:
                raise RuntimeError(
                    "NetFleet: out of endpoints (use add_remote to grow)")
            host, port = eps.pop(0)
            return RemoteServant(host, port, config=config, ledger=ledger,
                                 replica=rid)

        fleet = cls(factory, replicas=len(eps), ledger=ledger,
                    registry=registry, **fleet_kwargs)
        fleet._net_config = config
        fleet._checkpoint_root = checkpoint_root
        # adopt the servers' current state before the first health poll
        for rep in fleet.replicas():
            rep.servant.health()
        return fleet

    def add_remote(self, host: str, port: int,
                   incarnation: str = "") -> str:
        """Ring-add a remote replica (elastic scale-up / respawn rejoin)."""
        rid_holder: List[str] = []

        def factory(rid: str) -> RemoteServant:
            rid_holder.append(rid)
            return RemoteServant(host, port, config=self._net_config,
                                 ledger=self.ledger, replica=rid)

        old_factory, self._factory = self._factory, factory
        try:
            rep = self._add()
        finally:
            self._factory = old_factory
        rep.servant.health()  # adopt version/step/breakers before traffic
        self.registry.counter("fleet.replicas_added").inc()
        return rep.id

    def reload_from_checkpoint(self, root: str, config=None, *,
                               step: Optional[int] = None,
                               retry=None) -> int:
        """Fan the reload out as RPCs — each replica shadow-loads from its
        own disk and swaps at its own bumped version; the fleet version is
        the max (remote replicas own their planes like tiered ones do)."""
        version = 0
        for rep in self.replicas():
            version = max(version, rep.servant.reload_checkpoint(
                root, step=step))
        return version

    def stats(self) -> Dict:
        st = super().stats()
        per = st.get("replicas")
        if isinstance(per, dict):
            for rid, rs in per.items():
                rep = self._replicas.get(rid)
                if rep is not None and hasattr(rep.servant, "transport"):
                    rs["transport"] = rep.servant.transport
                    rs["peer"] = rep.servant.client.peer
                    rs["incarnation"] = rep.servant.incarnation
        return st


class ReplicaManager:
    """Lease-driven liveness + respawn + autoscale over a NetFleet."""

    def __init__(
        self,
        fleet: NetFleet,
        *,
        spawner: Optional[ReplicaSpawner] = None,
        config=None,
        ledger=None,
        lease_ms: float = DEFAULT_LEASE_MS,
        probe_timeout_ms: float = DEFAULT_PROBE_TIMEOUT_MS,
        autoscale: Optional[bool] = None,
        max_replicas: int = 8,
        knee_p95_ms: float = 60.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        if config is not None:
            lease_ms = config.get_float("net_lease_ms", lease_ms)
            if autoscale is None:
                autoscale = config.get_bool("net_autoscale", False)
            max_replicas = config.get_int("net_max_replicas", max_replicas)
            knee_p95_ms = config.get_float("net_knee_p95_ms", knee_p95_ms)
        self.fleet = fleet
        self.spawner = spawner
        self.ledger = ledger
        self.autoscale = bool(autoscale)
        self.max_replicas = int(max_replicas)
        self.knee_p95_ms = float(knee_p95_ms)
        self.probe_timeout_ms = float(probe_timeout_ms)
        self.supervisor = Supervisor(lease_ms=lease_ms, ledger=ledger,
                                     clock=clock)
        self._procs: Dict[str, ReplicaProcess] = {}
        self.respawns = 0
        self.scaleups = 0
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._lock = threading.RLock()
        for rep in fleet.replicas():
            self.supervisor.register(rep.id)

    def attach_process(self, rid: str, proc: ReplicaProcess) -> None:
        with self._lock:
            self._procs[rid] = proc

    def process_of(self, rid: str) -> Optional[ReplicaProcess]:
        return self._procs.get(rid)

    # -- the liveness loop ---------------------------------------------------

    def tick(self) -> List[str]:
        """One liveness round: probe + heartbeat every replica, sweep
        expired leases, replace the lost, run the autoscale hook. Returns
        the replicas declared lost this round."""
        for rep in self.fleet.replicas():
            h = rep.servant.health(read_timeout_ms=self.probe_timeout_ms)
            if h.get("status") != "unreachable":
                try:
                    self.supervisor.heartbeat(rep.id, step=h.get("step"))
                except WorkerLost:
                    # the lease lapsed but the replica ANSWERED the probe —
                    # the liveness loop was paused, not the replica dead.
                    # Rejoin it; replacement is for replicas that stay dark.
                    self.supervisor.register(rep.id)
        self.supervisor.poll()
        # a heartbeat's internal sweep may have declared the loss already
        # (poll() only reports NEWLY lost workers), so the authoritative
        # question is membership state: ring replicas whose lease is gone
        workers = self.supervisor.status().get("workers", {})
        lost = [rep.id for rep in self.fleet.replicas()
                if not workers.get(rep.id, {}).get("alive", True)]
        for rid in lost:
            self._replace(rid)
        if self.autoscale:
            self.maybe_autoscale()
        return lost

    def _replace(self, rid: str) -> None:
        proc = self._procs.pop(rid, None)
        self._transport_event("drained", replica=rid,
                              pid=proc.pid if proc else None)
        try:
            self.fleet.drain(rid, timeout_s=2.0)
        except KeyError:
            pass  # already gone (double sweep)
        if proc is not None:
            proc.close()  # SIGKILL any half-dead process, reap it
        if self.spawner is None:
            return
        replacement = self.spawner.spawn()
        new_rid = self.fleet.add_remote(replacement.host, replacement.port,
                                        incarnation=replacement.incarnation)
        self.attach_process(new_rid, replacement)
        self.supervisor.register(new_rid)
        self.respawns += 1
        self._transport_event(
            "respawn", replica=rid, replacement=new_rid,
            incarnation=replacement.incarnation, pid=replacement.pid)

    def maybe_autoscale(self) -> Optional[str]:
        """Spawn one replica when the serving knee or the freshness lag
        watermark degrades; returns the new replica id (or None)."""
        if self.spawner is None or \
                len(self.fleet.replicas()) >= self.max_replicas:
            return None
        reason = None
        p95 = self.fleet.hedge_budget("pull")
        if p95 > self.knee_p95_ms:
            reason = f"pull p95 {p95:.1f}ms > knee {self.knee_p95_ms:.0f}ms"
        fr = self.fleet._freshness
        if reason is None and fr is not None:
            try:
                if fr.status().get("stale"):
                    reason = "freshness lag watermark degraded"
            except Exception:
                pass
        if reason is None:
            return None
        proc = self.spawner.spawn()
        rid = self.fleet.add_remote(proc.host, proc.port,
                                    incarnation=proc.incarnation)
        self.attach_process(rid, proc)
        self.supervisor.register(rid)
        self.scaleups += 1
        if self.ledger is not None:
            try:
                self.ledger.append("scale_hint", {
                    "source": "net", "action": "scale_up",
                    "replica": rid, "reason": reason,
                    "replicas": len(self.fleet.replicas()),
                })
            except Exception:
                pass
        return rid

    # -- background ----------------------------------------------------------

    def start(self, interval_s: float = 0.2) -> "ReplicaManager":
        if self._thread is not None:
            return self

        def loop():
            while not self._stop.wait(interval_s):
                try:
                    self.tick()
                except Exception:
                    pass  # liveness must outlive any single bad round

        t = threading.Thread(target=loop, name="ssn-net-liveness",
                             daemon=True)
        t.start()
        self._thread = t
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None

    def close(self) -> None:
        """Stop the loop and SIGKILL every tracked process."""
        self.stop()
        with self._lock:
            procs, self._procs = list(self._procs.values()), {}
        for p in procs:
            p.close()

    def status(self) -> Dict:
        return {
            "replicas": [r.id for r in self.fleet.replicas()],
            "respawns": self.respawns,
            "scaleups": self.scaleups,
            "supervisor": self.supervisor.status(),
        }

    def _transport_event(self, event: str, **extra) -> None:
        if self.ledger is None:
            return
        try:
            self.ledger.append("transport", {"event": event, **extra})
        except Exception:
            pass


def kill_pid(pid: int) -> None:
    """SIGKILL by pid (the chaos drill's victim switch)."""
    try:
        os.kill(pid, signal.SIGKILL)
    except OSError:
        pass
