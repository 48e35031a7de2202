"""Freshness delta subscription over TCP (docs/NETWORK.md) — the JAX
package's ``net/delta_stream.py``, in the port.

``DeltaSubscriber.apply_batch`` is transport-agnostic by design
(``freshness/subscriber.py``); this module replaces the file poll in front
of it with a TCP stream, keeping EVERY semantics the file path has — seq
ordering, duplicate drop, gap window, publisher-restart detection, CRC
fallback — because the bytes on the wire ARE the bytes on disk:

* :class:`DeltaStreamServer` tails a delta-log directory and pushes each
  batch file verbatim as one frame payload (``op: "delta"``). A new
  connection — and any publisher incarnation change — first gets a
  ``base`` frame (the ``BASE.json`` record plus the oldest seq the server
  can still deliver). :meth:`~DeltaStreamServer.stop` drains: each
  connected subscriber is sent the batches the directory holds at that
  moment before its connection closes (within ``_DRAIN_S``), so the
  final publish of a run (``freshness_listen`` closes the server right
  after it) reaches TCP subscribers. The JAX server closes at once and a
  subscriber a frame behind loses the run's tail.
* :class:`TcpDeltaSource` runs a background receive loop: connect under
  the retry policy (decorrelated-jitter reconnect, read timeouts — never
  a bare ``recv``), decode each batch with the SAME
  :func:`~swiftsnails_tpu_torch.freshness.log.decode_batch` codec the file
  reader uses, and feed :meth:`DeltaSubscriber.apply_batch`. A corrupt
  batch triggers :meth:`corrupt_fallback`; a changed publisher id
  triggers :meth:`restart_fallback` — bit-for-bit the file poll's
  recovery ladder, now reachable over a killed-and-respawned publisher.
"""

from __future__ import annotations

import os
import socket
import threading
import time
from typing import Dict, List, Optional

from swiftsnails_tpu_torch.freshness.log import (
    DeltaCorrupt,
    decode_batch,
    list_seqs,
    read_base,
    seg_path,
)
from swiftsnails_tpu_torch.net.rpc import net_retry_policy
from swiftsnails_tpu_torch.net.wire import FrameError, encode_frame, read_frame, \
    sock_recv
from swiftsnails_tpu_torch.resilience.retry import RetryExhausted

# how long stop() lets connections send the directory's tail: a few
# 30 MB batches over loopback to a subscriber that applies between reads
_DRAIN_S = 10.0


class DeltaStreamServer:
    """Push a delta-log directory to TCP subscribers."""

    def __init__(self, dirpath: str, *, host: str = "127.0.0.1",
                 port: int = 0, poll_interval_s: float = 0.02,
                 ledger=None):
        self.dir = os.path.abspath(dirpath)
        self.poll_interval_s = float(poll_interval_s)
        self.ledger = ledger
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, int(port)))
        self._sock.listen(8)
        self.address = self._sock.getsockname()[:2]
        self._stop = threading.Event()
        self._conns: List[socket.socket] = []
        self._threads: List[threading.Thread] = []
        self._lock = threading.Lock()
        self._accept_thread: Optional[threading.Thread] = None

    def start(self) -> "DeltaStreamServer":
        t = threading.Thread(target=self._accept_loop,
                             name="ssn-delta-stream-accept", daemon=True)
        t.start()
        self._accept_thread = t
        return self

    def stop(self) -> None:
        """Stop accepting, let every connection send the directory's
        remaining batches (within ``_DRAIN_S`` in all), then close.

        The flag is set under the lock the accept loop registers under, so
        every connection is either registered (and drained here) or refused
        by the loop. ``shutdown`` ends the listener: a bare ``close`` from
        this thread does not wake an ``accept`` blocked in the loop's, and
        the kernel would go on accepting (a subscriber's redial after the
        drain would land on a server that has stopped)."""
        with self._lock:
            self._stop.set()
            threads = list(self._threads)
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        deadline = time.monotonic() + _DRAIN_S
        for t in threads:
            t.join(max(deadline - time.monotonic(), 0.0))
        with self._lock:
            conns, self._conns = self._conns, []
        for c in conns:
            try:
                c.close()
            except OSError:
                pass

    def __enter__(self) -> "DeltaStreamServer":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    def _accept_loop(self) -> None:
        while True:
            try:
                conn, _addr = self._sock.accept()
            except OSError:
                return
            with self._lock:
                if self._stop.is_set():
                    # accepted in stop()'s window: stop() has taken its
                    # snapshot, so no stream is started for it
                    try:
                        conn.close()
                    except OSError:
                        pass
                    return
                t = threading.Thread(target=self._stream_to, args=(conn,),
                                     name="ssn-delta-stream-conn", daemon=True)
                self._conns.append(conn)
                self._threads = [x for x in self._threads if x.is_alive()] + [t]
                # started under the lock: stop() never joins a thread that
                # has not started
                t.start()

    def _stream_to(self, conn: socket.socket) -> None:
        """One subscriber: base frame, every available batch, then tail the
        directory. A publisher restart (changed id in BASE.json) re-sends
        the base — the subscriber's restart signal, same as the file poll's
        ``read_base`` check. After :meth:`stop` one last pass sends what
        the directory holds, then the connection closes."""
        publisher: Optional[str] = None
        next_send = 1
        try:
            while True:
                stopping = self._stop.is_set()
                base = read_base(self.dir)
                if base is None:
                    if stopping:
                        return
                    time.sleep(self.poll_interval_s)
                    continue
                if base.get("publisher") != publisher:
                    publisher = base.get("publisher")
                    seqs = list_seqs(self.dir)
                    next_send = seqs[0] if seqs else int(
                        base.get("first_seq", 1) or 1)
                    conn.sendall(encode_frame({
                        "frame": "base", **base, "first_seq": next_send,
                    }))
                sent_any = False
                for seq in list_seqs(self.dir):
                    if seq < next_send:
                        continue
                    try:
                        with open(seg_path(self.dir, seq), "rb") as f:
                            blob = f.read()
                    except OSError:
                        continue  # pruned under us: subscriber sees a gap
                    conn.sendall(encode_frame(
                        {"frame": "delta", "seq": int(seq)}, blob))
                    next_send = seq + 1
                    sent_any = True
                if stopping:
                    return  # the tail as of stop() is sent
                if not sent_any:
                    time.sleep(self.poll_interval_s)
        except OSError:
            pass  # subscriber went away
        finally:
            try:
                conn.close()
            except OSError:
                pass
            with self._lock:
                if conn in self._conns:
                    self._conns.remove(conn)


class TcpDeltaSource:
    """Feed a :class:`DeltaSubscriber` from a :class:`DeltaStreamServer`."""

    def __init__(self, subscriber, host: str, port: int, *,
                 config=None, ledger=None):
        self.sub = subscriber
        self.host = host
        self.port = int(port)
        self.peer = f"{host}:{int(port)}"
        self.ledger = ledger
        self.policy = net_retry_policy(config, ledger=ledger)
        self.connect_timeout_ms = config.get_float(
            "net_connect_timeout_ms", 1_000.0) if config is not None \
            else 1_000.0
        self.read_timeout_ms = config.get_float(
            "net_read_timeout_ms", 2_000.0) if config is not None else \
            2_000.0
        self.frames = 0
        self.batches = 0
        self.reconnects = 0
        self.state = "reconnecting"
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------------

    def start(self, *_args, **_kwargs) -> "TcpDeltaSource":
        if self._thread is not None:
            return self
        self._stop.clear()
        t = threading.Thread(target=self._loop, name="ssn-delta-source",
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

    def status(self) -> Dict:
        return {"peer": self.peer, "state": self.state,
                "frames": self.frames, "batches": self.batches,
                "reconnects": self.reconnects}

    # -- the receive loop ----------------------------------------------------

    def _connect(self) -> socket.socket:
        sock = socket.create_connection(
            (self.host, self.port), timeout=self.connect_timeout_ms / 1e3)
        sock.settimeout(self.read_timeout_ms / 1e3)
        return sock

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                sock = self.policy.call(self._connect,
                                        op="net.delta_subscribe",
                                        extra={"peer": self.peer})
            except RetryExhausted:
                # budget spent (event already ledgered with the peer);
                # a stream source outlives one budget — try again unless
                # the drill/caller stopped us
                if self._stop.wait(0.05):
                    return
                continue
            if self.reconnects > 0:
                self._transport_event("reconnect",
                                      reconnects=self.reconnects)
            self.state = "connected"
            try:
                self._pump(sock)
            except (OSError, FrameError) as e:
                self._transport_event(
                    "conn_lost", error=f"{type(e).__name__}: {e}")
            finally:
                self.state = "reconnecting"
                self.reconnects += 1
                try:
                    sock.close()
                except OSError:
                    pass

    def _pump(self, sock: socket.socket) -> None:
        raw = sock_recv(sock)
        while not self._stop.is_set():
            got = [0]

            def recv(n: int) -> bytes:
                chunk = raw(n)
                got[0] += len(chunk)
                return chunk

            try:
                header, payload = read_frame(recv)
            except socket.timeout:
                if self._stop.is_set():
                    return
                if got[0] == 0:
                    continue  # idle at a frame boundary: keep listening
                raise  # deadline fired MID-frame: a real stall, reconnect
            self.frames += 1
            kind = header.get("frame")
            if kind == "base":
                self._on_base(header)
            elif kind == "delta":
                self._on_delta(header, payload)

    def _on_base(self, base: Dict) -> None:
        sub = self.sub
        if sub.publisher is not None and \
                base.get("publisher") != sub.publisher:
            # the publisher restarted while we were connected (or across a
            # reconnect): the file poll's read_base check, as a frame
            sub.restart_fallback()
        if sub.publisher is None:
            # dir-less resubscribe (or first subscribe): adopt the stream's
            # own base — first_seq is the oldest batch it will deliver
            sub.adopt_base(base, first_seq=base.get("first_seq"))

    def _on_delta(self, header: Dict, payload: bytes) -> None:
        sub = self.sub
        try:
            bheader, tables = decode_batch(
                payload, label=f"tcp:{self.peer}:seq{header.get('seq')}")
        except DeltaCorrupt:
            sub.corrupt_fallback(failed_seq=header.get("seq"))
            return
        self.batches += 1
        sub.apply_batch(bheader, tables)

    def _transport_event(self, event: str, **extra) -> None:
        if self.ledger is None:
            return
        try:
            self.ledger.append("transport", {
                "event": event, "peer": self.peer,
                "source": "delta_stream", **extra})
        except Exception:
            pass
