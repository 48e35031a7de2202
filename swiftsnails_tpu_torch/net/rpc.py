"""Threaded RPC over SSD1 stream frames (docs/NETWORK.md) — the JAX
package's ``net/rpc.py``, kept as the port's own copy.

Request and reply are each one :mod:`~swiftsnails_tpu_torch.net.wire` frame. The
request header carries ``op`` (handler name) + ``id`` (echo-checked); the
reply header carries ``ok`` and — on handler failure — the error type and
message, so application errors (``Overloaded``, ``Unavailable``,
``StaleEpoch``) cross the wire typed instead of as connection resets.

Server: one accept thread + one thread per connection. A malformed frame
(truncated, CRC-flipped, oversize prefix) is a *connection* problem, not a
server problem — the connection closes, the accept loop and every other
connection keep serving. Handler exceptions become error replies.

Client: one socket, lazily connected, one request in flight on it at a
time (callers on several threads queue for it; the JAX client lets their
sends and reads interleave on the one socket, so concurrent callers can
read each other's bytes). EVERY connect/send/recv runs under a
:class:`~swiftsnails_tpu_torch.resilience.retry.RetryPolicy` — connect and read
both carry socket timeouts (``net_connect_timeout_ms`` /
``net_read_timeout_ms``; there is never a bare ``recv`` without a
deadline), failures tear the socket down and reconnect with the policy's
decorrelated-jitter backoff, and an exhausted budget raises typed and
lands a ``retry_exhausted`` ledger event carrying the peer address.

Chaos (drill control, out-of-band of the data ops): the server honors a
``chaos`` op that injects ``net_slow`` (per-reply RTT) or ``net_partition``
(black-hole: requests are read and dropped unanswered for a window, the
client sees only timeouts until the window heals).
"""

from __future__ import annotations

import socket
import threading
import time
from typing import Callable, Dict, Optional, Tuple

from swiftsnails_tpu_torch.net.wire import (
    FrameError,
    encode_frame,
    read_frame,
    sock_recv,
)
from swiftsnails_tpu_torch.resilience.retry import RetryPolicy

# transport states a RemoteServant reports through ops (docs/NETWORK.md)
CONNECTED = "connected"
RECONNECTING = "reconnecting"
CLOSED = "drained"  # closed on purpose (ring drain), not lost

Handler = Callable[[Dict, bytes], Tuple[Dict, bytes]]


class RpcRemoteError(Exception):
    """The remote handler failed; ``kind`` names the remote exception type
    (the client maps known kinds back to their local classes)."""

    def __init__(self, kind: str, message: str):
        super().__init__(f"{kind}: {message}")
        self.kind = kind
        self.message = message


def net_retry_policy(config=None, ledger=None, **overrides) -> RetryPolicy:
    """The transport's retry policy: the shared ``retry_*`` knobs plus
    :class:`FrameError` as retryable (a torn frame is a connection loss)."""
    overrides.setdefault("retry_on", (OSError, FrameError))
    if config is not None:
        return RetryPolicy.from_config(config, ledger=ledger, **overrides)
    pol = RetryPolicy(**overrides)
    pol.ledger = ledger
    return pol


class RpcServer:
    """Serve ``handlers[op](header, payload) -> (reply_header, payload)``
    over TCP. ``port=0`` binds an ephemeral port (read :attr:`address`)."""

    def __init__(
        self,
        handlers: Dict[str, Handler],
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        ledger=None,
        name: str = "rpc",
    ):
        self.handlers = dict(handlers)
        self.ledger = ledger
        self.name = name
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, int(port)))
        self._sock.listen(16)
        self.address: Tuple[str, int] = self._sock.getsockname()[:2]
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._conns: list = []
        self._threads: list = []
        self._accept_thread: Optional[threading.Thread] = None
        # chaos injection (drill control): RTT + black-hole window
        self.slow_ms = 0.0
        self._partition_until = 0.0
        self.frame_errors = 0  # malformed frames survived (hardening gauge)

    # -- chaos ---------------------------------------------------------------

    def inject_slow(self, ms: float) -> None:
        self.slow_ms = max(0.0, float(ms))

    def inject_partition(self, ms: float) -> None:
        """Black-hole the data ops for ``ms``: requests are read and
        dropped unanswered (the network "ate" them); heals automatically."""
        self._partition_until = time.monotonic() + max(0.0, float(ms)) / 1e3

    @property
    def partitioned(self) -> bool:
        return time.monotonic() < self._partition_until

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "RpcServer":
        t = threading.Thread(target=self._accept_loop,
                             name=f"ssn-net-{self.name}-accept", daemon=True)
        t.start()
        self._accept_thread = t
        return self

    def stop(self) -> None:
        with self._lock:
            self._stop.set()
        try:
            # a bare close does not wake the accept loop's blocked accept,
            # and the kernel would go on accepting (``delta_stream.py``)
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        with self._lock:
            conns, self._conns = self._conns, []
        for c in conns:
            try:
                c.close()
            except OSError:
                pass

    def __enter__(self) -> "RpcServer":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- loops ---------------------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _addr = self._sock.accept()
            except OSError:
                return  # listener closed
            conn.settimeout(300.0)  # idle-connection backstop, never infinite
            with self._lock:
                if self._stop.is_set():
                    conn.close()  # accepted in stop()'s window
                    return
                self._conns.append(conn)
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 name=f"ssn-net-{self.name}-conn", daemon=True)
            t.start()
            self._threads.append(t)

    def _serve_conn(self, conn) -> None:
        recv = sock_recv(conn)
        try:
            while not self._stop.is_set():
                try:
                    header, payload = read_frame(recv)
                except FrameError:
                    # malformed/torn frame: this CONNECTION is done, the
                    # server is not (hardening contract, tests/test_torch_net)
                    self.frame_errors += 1
                    return
                except OSError:
                    return  # peer closed / idle timeout
                op = header.get("op", "")
                if op == "chaos":
                    self._handle_chaos(conn, header)
                    continue
                if self.partitioned:
                    continue  # black-hole: read and drop, no reply
                if self.slow_ms > 0:
                    time.sleep(self.slow_ms / 1e3)
                reply_hdr, reply_payload = self._dispatch(header, payload)
                reply_hdr["id"] = header.get("id")
                try:
                    conn.sendall(encode_frame(reply_hdr, reply_payload))
                except OSError:
                    return
        finally:
            try:
                conn.close()
            except OSError:
                pass
            with self._lock:
                if conn in self._conns:
                    self._conns.remove(conn)

    def _handle_chaos(self, conn, header: Dict) -> None:
        """Drill control is out-of-band: it always answers, even mid-
        partition (it is the drill harness's heal/arm switch, not traffic)."""
        if "slow_ms" in header:
            self.inject_slow(float(header["slow_ms"]))
        if "partition_ms" in header:
            self.inject_partition(float(header["partition_ms"]))
        try:
            conn.sendall(encode_frame({
                "ok": True, "id": header.get("id"),
                "slow_ms": self.slow_ms,
                "partitioned": self.partitioned,
            }))
        except OSError:
            pass

    def _dispatch(self, header: Dict, payload: bytes) -> Tuple[Dict, bytes]:
        op = header.get("op", "")
        fn = self.handlers.get(op)
        if fn is None:
            return {"ok": False, "error": "UnknownOp",
                    "message": f"no handler for op {op!r}"}, b""
        try:
            reply_hdr, reply_payload = fn(header, payload)
        except Exception as e:  # noqa: BLE001 — typed across the wire
            return {"ok": False, "error": type(e).__name__,
                    "message": str(e)}, b""
        out = dict(reply_hdr or {})
        out.setdefault("ok", True)
        return out, reply_payload


class RpcClient:
    """One reconnecting connection to an :class:`RpcServer`.

    Every call runs under ``policy`` (attempt budget + wall-clock deadline +
    decorrelated-jitter backoff); socket timeouts bound each connect and
    each read. Transport transitions land in the ledger as ``transport``
    events (CONN-LOST / RECONNECT) tagged with the peer and — when set —
    the owning replica id.
    """

    def __init__(
        self,
        host: str,
        port: int,
        *,
        policy: Optional[RetryPolicy] = None,
        connect_timeout_ms: float = 1_000.0,
        read_timeout_ms: float = 2_000.0,
        ledger=None,
        replica: Optional[str] = None,
    ):
        self.host = host
        self.port = int(port)
        self.policy = policy if policy is not None else net_retry_policy(
            ledger=ledger)
        self.connect_timeout_ms = float(connect_timeout_ms)
        self.read_timeout_ms = float(read_timeout_ms)
        self.ledger = ledger
        self.replica = replica
        self.peer = f"{host}:{int(port)}"
        self._sock: Optional[socket.socket] = None
        self._lock = threading.RLock()
        # one request/reply on the socket at a time (waited for with the
        # read deadline, never forever)
        self._io = threading.Lock()
        self._state = RECONNECTING  # no socket yet
        self._id = 0
        self.reconnects = 0

    # -- state ---------------------------------------------------------------

    @property
    def transport_state(self) -> str:
        return self._state

    def _transport_event(self, event: str, **extra) -> None:
        if self.ledger is None:
            return
        try:
            rec = {"event": event, "peer": self.peer}
            if self.replica is not None:
                rec["replica"] = self.replica
            rec.update(extra)
            self.ledger.append("transport", rec)
        except Exception:
            pass  # bookkeeping never fails the transport

    # -- connection ----------------------------------------------------------

    def _ensure_conn(self) -> socket.socket:
        with self._lock:
            if self._sock is not None:
                return self._sock
            was_down = self._state == RECONNECTING
            sock = socket.create_connection(
                (self.host, self.port),
                timeout=self.connect_timeout_ms / 1e3)
            sock.settimeout(self.read_timeout_ms / 1e3)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._sock = sock
            self._state = CONNECTED
            if was_down and self.reconnects > 0:
                self._transport_event("reconnect",
                                      reconnects=self.reconnects)
            return sock

    def _drop_conn(self, err: BaseException) -> None:
        with self._lock:
            sock, self._sock = self._sock, None
            if self._state == CONNECTED:
                self._transport_event(
                    "conn_lost", error=f"{type(err).__name__}: {err}")
            self._state = RECONNECTING
            self.reconnects += 1
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

    def close(self) -> None:
        with self._lock:
            sock, self._sock = self._sock, None
            self._state = CLOSED
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

    # -- calls ---------------------------------------------------------------

    def call(self, op: str, header: Optional[Dict] = None,
             payload: bytes = b"",
             read_timeout_ms: Optional[float] = None) -> Tuple[Dict, bytes]:
        """One RPC under the retry policy -> ``(reply_header, payload)``.
        Remote application errors raise :class:`RpcRemoteError` (never
        retried — they are answers, not outages)."""
        with self._lock:
            self._id += 1
            req_id = self._id
        req = dict(header or {})
        req["op"] = op
        req["id"] = req_id
        frame = encode_frame(req, payload)

        timeout_s = (read_timeout_ms if read_timeout_ms is not None
                     else self.read_timeout_ms) / 1e3

        def _attempt() -> Tuple[Dict, bytes]:
            if self._state == CLOSED:
                raise RpcRemoteError("Closed", f"client to {self.peer} closed")
            if not self._io.acquire(timeout=timeout_s):
                raise socket.timeout(
                    f"{self.peer}: no turn on the connection within {timeout_s} s")
            try:
                sock = self._ensure_conn()
                sock.settimeout(timeout_s)
                sock.sendall(frame)
                hdr, data = read_frame(sock_recv(sock))
                # replies are strictly in-order on one socket; an id skew
                # means the stream desynced (e.g. a stale reply surfacing
                # after a partial failure) — resync by reconnecting
                if hdr.get("id") != req_id:
                    raise FrameError(
                        f"reply id {hdr.get('id')} != request id {req_id}")
            except (OSError, FrameError) as e:
                self._drop_conn(e)
                raise
            finally:
                self._io.release()
            if hdr.get("ok") is False:
                raise RpcRemoteError(str(hdr.get("error", "RemoteError")),
                                     str(hdr.get("message", "")))
            return hdr, data

        return self.policy.call(
            _attempt, op=f"net.{op}",
            extra={"peer": self.peer,
                   **({"replica": self.replica} if self.replica else {})})
