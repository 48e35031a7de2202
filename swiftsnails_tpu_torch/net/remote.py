"""RemoteServant: an out-of-process replica behind the in-process surface —
the JAX package's ``net/remote.py``, in the port.

The fleet router, breaker demotion, hedging, drain, and freshness cutover
all talk to ``rep.servant`` (``serving/fleet.py``); this class implements
exactly that surface over :class:`~swiftsnails_tpu_torch.net.rpc.RpcClient`, so
a remote replica rides the ring with ZERO router changes:

* kernel ops (``pull``/``topk``/``score``) are RPCs under the retry
  policy; a transport failure (connection lost, partition, exhausted
  budget) raises :class:`~swiftsnails_tpu_torch.serving.breaker.Unavailable` —
  the router's native re-route/hedge food — so a dead replica costs
  affinity, not availability;
* hot-path introspection (``queue_depths()``, ``breakers.get(k).state``)
  is served from a locally cached snapshot — the router reads these on
  EVERY routing decision, and a routing decision must never block on the
  network. The snapshot refreshes on each :meth:`health` poll (the
  liveness loop's heartbeat probe); while the transport is down the
  breakers read OPEN, which is precisely the demotion the router wants;
* ``apply_rows`` carries the fleet's shared epoch; the server refuses
  epochs at/below its own (``StaleEpoch``) — a healed partition cannot
  accept a stale write (``tier_budget_mb = 1`` keeps the fleet on the
  per-replica apply path, matching tiered replicas that own their
  masters).
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from swiftsnails_tpu_torch.net.rpc import (
    CONNECTED,
    RpcClient,
    RpcRemoteError,
    net_retry_policy,
)
from swiftsnails_tpu_torch.net.wire import pack_arrays, unpack_arrays
from swiftsnails_tpu_torch.resilience.retry import RetryExhausted
from swiftsnails_tpu_torch.serving.breaker import OPEN, Unavailable
from swiftsnails_tpu_torch.serving.engine import Overloaded


class StaleEpoch(RuntimeError):
    """A write carried a cache epoch at/below the replica's current one —
    refused (first-writer-wins: a healed partition must resync, not
    regress)."""


class _RemoteBreaker:
    """The router only reads ``.state``; this mirrors the server's breaker
    when connected and reads OPEN while the transport is down."""

    __slots__ = ("_servant", "_kernel")

    def __init__(self, servant: "RemoteServant", kernel: str):
        self._servant = servant
        self._kernel = kernel

    @property
    def state(self) -> str:
        return self._servant._breaker_state(self._kernel)


class _RemoteBreakers:
    def __init__(self, servant: "RemoteServant"):
        self._servant = servant
        self._cache: Dict[str, _RemoteBreaker] = {}

    def get(self, kernel: str) -> _RemoteBreaker:
        br = self._cache.get(kernel)
        if br is None:
            br = self._cache[kernel] = _RemoteBreaker(self._servant, kernel)
        return br

    def items(self):
        for k in ("pull", "topk", "score"):
            yield k, self.get(k)


class RemoteServant:
    """The client half of a :mod:`~swiftsnails_tpu_torch.net.replica_server`."""

    # truthy -> Fleet.apply_rows takes the per-replica path (remote
    # replicas own their planes exactly like tiered replicas do)
    tier_budget_mb = 1

    def __init__(
        self,
        host: str,
        port: int,
        *,
        config=None,
        ledger=None,
        replica: Optional[str] = None,
        connect_timeout_ms: Optional[float] = None,
        read_timeout_ms: Optional[float] = None,
    ):
        if config is not None:
            connect_timeout_ms = connect_timeout_ms if connect_timeout_ms \
                is not None else config.get_float(
                    "net_connect_timeout_ms", 1_000.0)
            read_timeout_ms = read_timeout_ms if read_timeout_ms \
                is not None else config.get_float(
                    "net_read_timeout_ms", 2_000.0)
        # kernel ops re-route fast: two tries against one peer, then let
        # the router take the request elsewhere — the retry policy's job
        # here is the reconnect jitter, not heroics against a dead host
        policy = net_retry_policy(
            config, ledger=ledger, max_attempts=2,
            deadline_ms=2.5 * (read_timeout_ms or 2_000.0))
        self.client = RpcClient(
            host, port, policy=policy,
            connect_timeout_ms=connect_timeout_ms or 1_000.0,
            read_timeout_ms=read_timeout_ms or 2_000.0,
            ledger=ledger, replica=replica)
        self.ledger = ledger
        self.replica = replica
        self.incarnation: Optional[str] = None
        self._version = 0
        self._step = 0
        self._queue_depths: Dict[str, int] = {}
        self._breakers_snapshot: Dict[str, str] = {}
        self._last_health: Dict = {}
        self.breakers = _RemoteBreakers(self)
        self.request_tracer = None  # fleet-level tracing owns the spans

    # -- cached introspection (hot path: NEVER an RPC) -----------------------

    @property
    def transport(self) -> str:
        return self.client.transport_state

    @property
    def version(self) -> int:
        return self._version

    @property
    def step(self) -> int:
        return self._step

    def queue_depths(self) -> Dict[str, int]:
        return dict(self._queue_depths)

    def _breaker_state(self, kernel: str) -> str:
        if self.client.transport_state != CONNECTED:
            return OPEN
        return self._breakers_snapshot.get(kernel, "closed")

    # -- kernel RPCs ---------------------------------------------------------

    def pull(self, ids, table: Optional[str] = None) -> np.ndarray:
        ids = np.ascontiguousarray(np.asarray(ids, np.int64).reshape(-1))
        index, payload = pack_arrays({"ids": ids})
        hdr, data = self._call("pull", {"table": table, "arrays": index},
                               payload)
        return unpack_arrays(hdr["arrays"], data)["rows"]

    def topk(self, query, k: Optional[int] = None,
             table: Optional[str] = None, exclude: Sequence[int] = (),
             normalize: bool = True) -> List[Tuple[int, float]]:
        q = np.ascontiguousarray(np.asarray(query, np.float32).reshape(-1))
        index, payload = pack_arrays({"query": q})
        hdr, _ = self._call("topk", {
            "k": k, "table": table, "exclude": [int(i) for i in exclude],
            "normalize": bool(normalize), "arrays": index,
        }, payload)
        return [(int(i), float(s)) for i, s in hdr["topk"]]

    def score(self, feats) -> np.ndarray:
        feats = np.ascontiguousarray(np.asarray(feats, np.int32))
        index, payload = pack_arrays({"feats": feats})
        hdr, data = self._call("score", {"arrays": index}, payload)
        return unpack_arrays(hdr["arrays"], data)["scores"]

    # -- control RPCs --------------------------------------------------------

    def health(self, read_timeout_ms: Optional[float] = None) -> Dict:
        """Liveness probe + snapshot refresh. Transport failure returns
        ``status: "unreachable"`` instead of raising — the liveness loop
        (and the fleet health rollup) needs the answer, not the traceback."""
        try:
            hdr, _ = self._call("health", {},
                                read_timeout_ms=read_timeout_ms)
        except (Unavailable, Overloaded):
            return {"status": "unreachable",
                    "transport": self.client.transport_state,
                    "peer": self.client.peer}
        h = hdr["health"]
        self._adopt_snapshot(hdr)
        h["transport"] = self.client.transport_state
        h["incarnation"] = self.incarnation
        self._last_health = h
        return h

    def stats(self) -> Dict:
        try:
            hdr, _ = self._call("stats", {})
        except (Unavailable, Overloaded):
            return {"kernels": {}, "cache": {"hit_rate": 0.0},
                    "breakers": {}, "tables": [],
                    "transport": self.client.transport_state,
                    "peer": self.client.peer}
        self._adopt_snapshot(hdr)
        st = hdr["stats"]
        st["transport"] = self.client.transport_state
        st["peer"] = self.client.peer
        return st

    def apply_rows(self, updates: Dict, *, version: Optional[int] = None,
                   step: Optional[int] = None) -> int:
        """Apply absolute row values at the fleet's shared epoch. The
        server refuses stale epochs typed (:class:`StaleEpoch`)."""
        arrays: Dict[str, np.ndarray] = {}
        tables_meta = {}
        for name, t in updates.items():
            if isinstance(t, dict):
                rows, values = t["rows"], t["values"]
                scales = t.get("scales")
            else:
                rows, values = t
                scales = None
            arrays[f"{name}/rows"] = np.asarray(rows, np.int64).reshape(-1)
            arrays[f"{name}/values"] = np.asarray(values)
            tables_meta[name] = {"scales": scales is not None}
            if scales is not None:
                arrays[f"{name}/scales"] = np.asarray(scales, np.float32)
        index, payload = pack_arrays(arrays)
        hdr, _ = self._call("apply_rows", {
            "version": version, "step": step,
            "tables": tables_meta, "arrays": index,
        }, payload)
        self._version = int(hdr.get("version", self._version))
        if step is not None:
            self._step = max(self._step, int(step))
        return self._version

    def reload_checkpoint(self, root: str, *, step: Optional[int] = None,
                          version: Optional[int] = None) -> int:
        """Ask the replica process to reload from its checkpoint root at
        the fleet's shared epoch (the wire ships a path, not the planes)."""
        hdr, _ = self._call("reload_checkpoint", {
            "root": root, "step": step, "version": version,
        })
        self._version = int(hdr.get("version", self._version))
        self._step = int(hdr.get("step", self._step))
        return self._version

    def chaos(self, *, slow_ms: Optional[float] = None,
              partition_ms: Optional[float] = None) -> Dict:
        """Drill control: arm ``net_slow`` / ``net_partition`` on the
        server (out-of-band of the data ops)."""
        req = {}
        if slow_ms is not None:
            req["slow_ms"] = float(slow_ms)
        if partition_ms is not None:
            req["partition_ms"] = float(partition_ms)
        hdr, _ = self._call("chaos", req)
        return hdr

    def close(self) -> None:
        self.client.close()

    # -- plumbing ------------------------------------------------------------

    def _adopt_snapshot(self, hdr: Dict) -> None:
        snap = hdr.get("snapshot") or {}
        self._version = int(snap.get("version", self._version))
        self._step = int(snap.get("step", self._step))
        self._queue_depths = {
            k: int(v) for k, v in (snap.get("queue_depths") or {}).items()}
        self._breakers_snapshot = {
            k: str(v) for k, v in (snap.get("breakers") or {}).items()}
        inc = snap.get("incarnation")
        if inc is not None:
            self.incarnation = str(inc)

    def _call(self, op: str, header: Dict, payload: bytes = b"",
              read_timeout_ms: Optional[float] = None) -> Tuple[Dict, bytes]:
        try:
            return self.client.call(op, header, payload,
                                    read_timeout_ms=read_timeout_ms)
        except RpcRemoteError as e:
            raise _map_remote_error(e) from e
        except (RetryExhausted, OSError) as e:
            raise Unavailable(
                f"replica {self.replica or self.client.peer} unreachable "
                f"({type(e).__name__})") from e

    def __repr__(self) -> str:
        return (f"RemoteServant({self.client.peer}, "
                f"transport={self.client.transport_state}, "
                f"incarnation={self.incarnation})")


def _map_remote_error(e: RpcRemoteError) -> Exception:
    """Known remote exception types come back as their local classes, so
    the router's shed/re-route logic treats a remote replica exactly like
    an in-process one."""
    if e.kind == "Overloaded":
        return Overloaded(e.message)
    if e.kind == "Unavailable":
        return Unavailable(e.message)
    if e.kind == "StaleEpoch":
        return StaleEpoch(e.message)
    return RuntimeError(f"remote {e.kind}: {e.message}")


def jsonable(obj):
    """Best-effort JSON sanitizer for health/stats dicts crossing the wire
    (numpy scalars -> Python scalars)."""
    return json.loads(json.dumps(obj, default=_np_default))


def _np_default(o):
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    return str(o)
