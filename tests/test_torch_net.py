"""The port's TCP transport against the JAX package's, on the CPU: the SSD1
stream frames, the threaded RPC, and freshness delta subscription over TCP.

Frames and packed arrays are byte-equal to JAX's in both directions, and a
client of either package talks to a server of the other. The wire's
hardening contract (typed truncation / CRC / oversize errors, the oversize
prefix refused before any buffer is sized from it, partial reads), the
RPC's typed remote errors, retry exhaustion and ``conn_lost`` /
``reconnect`` ledger trail, the out-of-band chaos channel, and the delta
stream's parity, restart and corrupt-batch fallbacks follow the JAX
package's tests. Sockets bind port 0; every wait has a deadline; no test
asserts a latency.
"""

import json
import os
import socket
import threading
import time
import zlib

import numpy as np
import pytest

from swiftsnails_tpu.freshness.publisher import DeltaPublisher as JPublisher
from swiftsnails_tpu.net import delta_stream as jax_stream
from swiftsnails_tpu.net import rpc as jax_rpc
from swiftsnails_tpu.net import wire as jax_wire

from swiftsnails_tpu_torch.freshness.log import MAGIC, seg_path
from swiftsnails_tpu_torch.freshness.publisher import (
    DeltaPublisher,
    HybridFreshnessError,
    TrainPublisher,
)
from swiftsnails_tpu_torch.freshness.subscriber import DeltaSubscriber
from swiftsnails_tpu_torch.net.delta_stream import DeltaStreamServer, TcpDeltaSource
from swiftsnails_tpu_torch.net.rpc import RpcClient, RpcRemoteError, RpcServer, net_retry_policy
from swiftsnails_tpu_torch.net.wire import (
    MAX_HEADER_BYTES,
    MAX_PAYLOAD_BYTES,
    FrameError,
    FrameTooLarge,
    FrameTruncated,
    decode_frame,
    encode_frame,
    pack_arrays,
    read_frame,
    unpack_arrays,
)
from swiftsnails_tpu_torch.resilience.retry import RetryExhausted
from swiftsnails_tpu_torch.telemetry.ledger import Ledger, render_failures
from swiftsnails_tpu_torch.utils.config import Config, ConfigError

DIM = 8
CAP = 64
WAIT_S = 20.0  # a deadline on every wait; generous for a loaded test box


def _blob_reader(blob, chunk=None, asks=None):
    """A ``recv(n)``-shaped callable over a byte blob; ``chunk`` caps each
    read (partial-read simulation), ``asks`` records every requested n."""
    pos = [0]

    def recv(n):
        if asks is not None:
            asks.append(n)
        take = n if chunk is None else min(n, chunk)
        out = bytes(blob[pos[0]: pos[0] + take])
        pos[0] += len(out)
        return out

    return recv


def _wait(cond, timeout=WAIT_S, interval=0.01):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(interval)
    return bool(cond())


HEADER = {"op": "pull", "id": 7, "table": "t"}
PAYLOAD = bytes(range(256)) * 3


# ---------------------------------------------------------------- frames ---


@pytest.mark.parametrize("header,payload", [
    (HEADER, PAYLOAD), ({"frame": "base", "publisher": "p", "first_seq": 3}, b""),
    ({"op": "apply_rows", "tables": {"in": {"scales": True}}, "version": None}, b"\x00" * 17)],
    ids=["pull", "base", "apply"])
def test_frames_byte_equal_jax_both_ways(header, payload):
    blob = encode_frame(header, payload)
    assert blob == jax_wire.encode_frame(header, payload)
    assert jax_wire.decode_frame(blob) == decode_frame(blob)
    assert decode_frame(blob) == ({**header, "payload_len": len(payload)}, payload)


def test_packed_arrays_byte_equal_jax():
    arrays = {"ids": np.array([3, 0, 17], np.int64),
              "rows": np.arange(12, dtype=np.float32).reshape(3, 4),
              "codes": np.array([[1, -2], [3, 4]], np.int8)}
    index, payload = pack_arrays(arrays)
    assert (index, payload) == jax_wire.pack_arrays(arrays)
    for name, a in jax_wire.unpack_arrays(index, payload).items():
        np.testing.assert_array_equal(unpack_arrays(index, payload)[name], a)


def test_frame_round_trip_bit_identical():
    hdr, payload = decode_frame(encode_frame(HEADER, PAYLOAD))
    assert payload == PAYLOAD
    assert hdr["op"] == "pull" and hdr["id"] == 7 and hdr["payload_len"] == len(PAYLOAD)


@pytest.mark.parametrize("chunk", [1, 2, 3, 7, 64])
def test_interleaved_partial_reads_decode_identically(chunk):
    hdr, payload = read_frame(_blob_reader(encode_frame(HEADER, PAYLOAD), chunk=chunk))
    assert payload == PAYLOAD and hdr["op"] == "pull"


def test_truncated_header_raises_typed():
    blob = encode_frame(HEADER, PAYLOAD)
    with pytest.raises(FrameTruncated):
        read_frame(_blob_reader(blob[:len(MAGIC) + 4 + 3]))


def test_truncated_payload_and_crc_raise_typed():
    blob = encode_frame(HEADER, PAYLOAD)
    with pytest.raises(FrameTruncated):
        read_frame(_blob_reader(blob[: len(blob) - 4 - len(PAYLOAD) // 2]))
    with pytest.raises(FrameTruncated):
        read_frame(_blob_reader(blob[: len(blob) - 2]))


def test_flipped_byte_anywhere_fails_the_crc():
    blob = bytearray(encode_frame(HEADER, PAYLOAD))
    blob[-1] ^= 0x01
    with pytest.raises(FrameError, match="CRC"):
        read_frame(_blob_reader(bytes(blob)))
    blob = bytearray(encode_frame(HEADER, PAYLOAD))
    blob[len(blob) // 2] ^= 0x40
    with pytest.raises(FrameError, match="CRC"):
        read_frame(_blob_reader(bytes(blob)))


def test_bad_magic_is_typed():
    with pytest.raises(FrameError, match="magic"):
        read_frame(_blob_reader(b"XXXX" + encode_frame(HEADER, PAYLOAD)[4:]))


def test_oversize_header_prefix_rejected_before_allocation():
    blob = MAGIC + np.uint32(MAX_HEADER_BYTES + 1).tobytes() + b"\0" * 64
    asks = []
    with pytest.raises(FrameTooLarge, match="header length"):
        read_frame(_blob_reader(blob, asks=asks))
    assert max(asks) <= len(MAGIC) + 4


def test_oversize_payload_len_rejected_before_payload_read():
    hjson = json.dumps({"op": "x", "payload_len": MAX_PAYLOAD_BYTES + 1}).encode()
    blob = (MAGIC + np.uint32(len(hjson)).tobytes() + hjson
            + np.uint32(zlib.crc32(hjson) & 0xFFFFFFFF).tobytes())
    asks = []
    with pytest.raises(FrameTooLarge, match="payload length"):
        read_frame(_blob_reader(blob, asks=asks))
    assert max(asks) <= max(len(MAGIC) + 4, len(hjson))


def test_header_must_be_json_dict_with_payload_len():
    for hjson in (b"[1, 2]", b"not json", b"{\"op\": \"x\"}"):
        blob = (MAGIC + np.uint32(len(hjson)).tobytes() + hjson
                + np.uint32(zlib.crc32(hjson) & 0xFFFFFFFF).tobytes())
        with pytest.raises(FrameError):
            read_frame(_blob_reader(blob))


def test_encode_refuses_oversize_before_building_the_frame():
    with pytest.raises(FrameTooLarge):
        encode_frame({"blob": "x" * (MAX_HEADER_BYTES + 1)})


def test_unpack_arrays_bounds_checked_before_frombuffer():
    index, payload = pack_arrays({"rows": np.arange(8, dtype=np.float32)})
    bad = [dict(index[0], offset=len(payload) - 4)]
    with pytest.raises(FrameError, match="claims"):
        unpack_arrays(bad, payload)
    with pytest.raises(FrameError, match="negative"):
        unpack_arrays([dict(index[0], shape=[-1])], payload)
    with pytest.raises(FrameError, match="bad array index"):
        unpack_arrays([{"name": "x"}], payload)


def test_server_loop_survives_garbage_frames():
    calls = []

    def ping(header, payload):
        calls.append(header.get("id"))
        return {"pong": True}, b""

    with RpcServer({"ping": ping}) as server:
        server.start()
        host, port = server.address
        raw = socket.create_connection((host, port), timeout=5.0)
        raw.sendall(b"GARBAGE-NOT-A-FRAME" * 8)
        raw.close()
        assert _wait(lambda: server.frame_errors >= 1)
        client = RpcClient(host, port, policy=net_retry_policy(
            max_attempts=2, deadline_ms=10_000.0, base_ms=5.0, cap_ms=20.0),
            read_timeout_ms=10_000.0)
        hdr, _ = client.call("ping")
        assert hdr["pong"] is True and calls
        client.close()


# ------------------------------------------------------------------- RPC ---


def _echo(header, payload):
    return {"echo": header.get("x")}, payload[::-1]


def _policy(ledger=None, **kw):
    kw.setdefault("max_attempts", 2)
    kw.setdefault("deadline_ms", 10_000.0)
    kw.setdefault("base_ms", 2.0)
    kw.setdefault("cap_ms", 10.0)
    return net_retry_policy(ledger=ledger, **kw)


def _client(addr, ledger=None, replica=None, read_timeout_ms=10_000.0, cls=RpcClient):
    pol = _policy if cls is RpcClient else (
        lambda ledger=None: jax_rpc.net_retry_policy(
            ledger=ledger, max_attempts=2, deadline_ms=10_000.0, base_ms=2.0, cap_ms=10.0))
    return cls(addr[0], addr[1], policy=pol(ledger=ledger), connect_timeout_ms=5_000.0,
               read_timeout_ms=read_timeout_ms, ledger=ledger, replica=replica)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_echo_round_trip_and_transport_state():
    with RpcServer({"echo": _echo}).start() as server:
        client = _client(server.address)
        assert client.transport_state == "reconnecting"
        hdr, payload = client.call("echo", {"x": 5}, b"abc")
        assert hdr["echo"] == 5 and payload == b"cba"
        assert client.transport_state == "connected"
        client.close()
        assert client.transport_state == "drained"
        with pytest.raises(RpcRemoteError, match="closed"):
            client.call("echo", {"x": 1})


@pytest.mark.parametrize("server_pkg", ["jax", "port"])
def test_rpc_across_the_packages(server_pkg):
    """A port client against a JAX server, and a JAX client against a port
    server: the same frames, so the same answers and typed errors."""
    srv_cls = jax_rpc.RpcServer if server_pkg == "jax" else RpcServer
    cli_cls = RpcClient if server_pkg == "jax" else jax_rpc.RpcClient
    remote_err = RpcRemoteError if server_pkg == "jax" else jax_rpc.RpcRemoteError

    def boom(header, payload):
        raise ValueError("boom")

    server = srv_cls({"echo": _echo, "boom": boom}).start()
    try:
        client = _client(server.address, cls=cli_cls)
        hdr, payload = client.call("echo", {"x": [1, 2]}, b"xyz")
        assert hdr["echo"] == [1, 2] and payload == b"zyx"
        with pytest.raises(remote_err) as ei:
            client.call("boom")
        assert ei.value.kind == "ValueError"
        client.close()
    finally:
        server.stop()


def test_concurrent_calls_on_one_client_each_get_their_own_reply():
    """Many threads share one client (a RemoteServant's router legs do):
    each call gets its own reply, none a neighbour's bytes, and the
    connection is never torn down. The JAX client lets concurrent calls
    interleave their sends and reads on the one socket."""
    import sys
    import threading

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    errors, done = [], []
    try:
        with RpcServer({"echo": _echo}).start() as server:
            client = _client(server.address)

            def worker(w):
                try:
                    for i in range(25):
                        x = w * 1000 + i
                        hdr, payload = client.call("echo", {"x": x}, str(x).encode() * 50)
                        if hdr["echo"] != x or payload != (str(x).encode() * 50)[::-1]:
                            errors.append((x, hdr.get("echo")))
                    done.append(w)
                except Exception as e:  # surfaced below
                    errors.append(repr(e))

            threads = [threading.Thread(target=worker, args=(w,)) for w in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=WAIT_S)
            assert not any(t.is_alive() for t in threads)
            assert not errors and len(done) == 16
            assert client.reconnects == 0 and client.transport_state == "connected"
            client.close()
    finally:
        sys.setswitchinterval(old)


def test_remote_handler_error_is_typed_and_never_retried():
    calls = []

    def boom(header, payload):
        calls.append(1)
        raise ValueError("boom")

    with RpcServer({"boom": boom}).start() as server:
        client = _client(server.address)
        with pytest.raises(RpcRemoteError) as ei:
            client.call("boom")
        assert ei.value.kind == "ValueError" and "boom" in ei.value.message
        assert len(calls) == 1
        with pytest.raises(RpcRemoteError) as ei:
            client.call("nope")
        assert ei.value.kind == "UnknownOp"
        client.close()


def test_retry_exhaustion_lands_a_ledger_event_with_the_peer(tmp_path):
    led = Ledger(str(tmp_path / "l.jsonl"))
    port = _free_port()  # nothing listening: every connect is refused
    client = RpcClient("127.0.0.1", port, policy=_policy(ledger=led),
                       connect_timeout_ms=2_000.0, read_timeout_ms=2_000.0, ledger=led)
    with pytest.raises(RetryExhausted):
        client.call("ping")
    ev = led.records("retry_exhausted")[-1]
    assert ev["peer"] == f"127.0.0.1:{port}"
    assert ev["op"] == "net.ping" and ev["attempts"] >= 2
    client.close()


def test_conn_lost_and_reconnect_transport_events(tmp_path):
    led = Ledger(str(tmp_path / "l.jsonl"))
    server = RpcServer({"echo": _echo}).start()
    addr = server.address
    client = _client(addr, ledger=led, replica="r0")
    assert client.call("echo", {"x": 1})[0]["echo"] == 1
    server.stop()
    with pytest.raises(RetryExhausted):
        client.call("echo", {"x": 2})
    lost = [r for r in led.records("transport") if r["event"] == "conn_lost"]
    assert lost and lost[0]["peer"] == f"{addr[0]}:{addr[1]}" and lost[0]["replica"] == "r0"
    server2 = RpcServer({"echo": _echo}, host=addr[0], port=addr[1]).start()
    try:
        assert client.call("echo", {"x": 3})[0]["echo"] == 3
        recon = [r for r in led.records("transport") if r["event"] == "reconnect"]
        assert recon and recon[0]["reconnects"] >= 1
        out = render_failures(led)
        assert "CONN-LOST" in out and "RECONNECT" in out
    finally:
        client.close()
        server2.stop()


def test_chaos_channel_answers_mid_partition_then_heals():
    with RpcServer({"echo": _echo}).start() as server:
        client = _client(server.address)
        assert client.call("chaos", {"partition_ms": 60_000.0})[0]["partitioned"] is True
        # data ops are read and dropped: the client's deadline fires, typed
        with pytest.raises(RetryExhausted):
            client.call("echo", {"x": 1}, read_timeout_ms=150.0)
        assert client.call("chaos", {})[0]["partitioned"] is True
        assert client.call("chaos", {"partition_ms": 0.0})[0]["partitioned"] is False
        assert client.call("echo", {"x": 2})[0]["echo"] == 2
        client.close()


def test_injected_slow_reply_stays_correct_and_is_bounded_by_the_deadline():
    """``net_slow`` delays every reply: a reply under the read deadline is
    still correct; one over it fails typed instead of hanging. No latency is
    asserted: the server sleeps, the client's deadline decides."""
    with RpcServer({"echo": _echo}).start() as server:
        client = _client(server.address)
        assert client.call("chaos", {"slow_ms": 60.0})[0]["slow_ms"] == 60.0
        assert client.call("echo", {"x": 9})[0]["echo"] == 9
        client.call("chaos", {"slow_ms": 5_000.0})
        with pytest.raises(RetryExhausted):
            client.call("echo", {"x": 1}, read_timeout_ms=100.0)
        client.call("chaos", {"slow_ms": 0.0})
        assert client.call("echo", {"x": 2})[0]["echo"] == 2
        client.close()


# ---------------------------------------------------- deltas over TCP -------


def _vals(rows, seed):
    return np.random.default_rng(seed).standard_normal((len(rows), DIM)).astype(np.float32)


class FakeTarget:
    """The apply_rows / reload_from_checkpoint / step / version surface the
    subscriber drives."""

    def __init__(self):
        self.tables = {"t": np.zeros((CAP, DIM), np.float32)}
        self.step = 0
        self.version = 0
        self.reloads = 0

    def apply_rows(self, updates, *, version=None, step=None):
        for name, (rows, vals) in updates.items():
            self.tables[name][np.asarray(rows, np.int64)] = np.asarray(vals, np.float32)
        if step is not None:
            self.step = max(self.step, int(step))
        self.version = int(version) if version is not None else self.version + 1
        return self.version

    def reload_from_checkpoint(self, root, config, **kw):
        self.reloads += 1
        self.version += 1
        return self.version


def _cfg():
    return Config({
        "net_connect_timeout_ms": "5000", "net_read_timeout_ms": "250",
        "retry_max_attempts": "3", "retry_deadline_ms": "10000",
        "retry_base_ms": "2", "retry_cap_ms": "15",
    })


def _stream(tmp_path, server_cls=DeltaStreamServer, **sub_kw):
    d = str(tmp_path / "log")
    os.makedirs(d, exist_ok=True)
    tgt = FakeTarget()
    sub = DeltaSubscriber(tgt, d, config=_cfg(), **sub_kw)
    srv = server_cls(d).start()
    src = TcpDeltaSource(sub, *srv.address, config=_cfg())
    return d, tgt, sub, srv, src


@pytest.mark.parametrize("server_pkg", ["port", "jax"])
def test_tcp_stream_applies_batches_bit_identically(tmp_path, server_pkg):
    """The port's source against the port's stream server and against
    JAX's (which a JAX publisher feeds): the same frames either way."""
    server_cls = DeltaStreamServer if server_pkg == "port" else jax_stream.DeltaStreamServer
    pub_cls = DeltaPublisher if server_pkg == "port" else JPublisher
    d, tgt, sub, srv, src = _stream(tmp_path, server_cls)
    try:
        pub = pub_cls(d, base_step=0)
        rows = np.array([3, 0, 17, CAP - 1], np.int64)
        vals1, vals2 = _vals(rows, 1), _vals(rows, 2)
        pub.publish({"t": (rows, vals1)}, 1)
        src.start()
        assert _wait(lambda: sub.applied_seq >= 1)
        np.testing.assert_array_equal(tgt.tables["t"][rows], vals1)
        pub.publish({"t": (rows, vals2)}, 2)
        assert _wait(lambda: sub.applied_seq >= 2)
        np.testing.assert_array_equal(tgt.tables["t"][rows], vals2)
        assert sub.publisher == pub.id and sub.fallbacks == 0
        st = src.status()
        assert st["state"] == "connected" and st["batches"] >= 2
    finally:
        src.stop()
        srv.stop()


def test_publisher_restart_mid_stream_falls_back_then_adopts(tmp_path):
    d, tgt, sub, srv, src = _stream(tmp_path, checkpoint_root="ck")
    try:
        a = DeltaPublisher(d, base_step=1)
        rows = np.arange(4, dtype=np.int64)
        a.publish({"t": (rows, _vals(rows, 1))}, 2)
        src.start()
        assert _wait(lambda: sub.applied_seq >= 1)
        assert sub.publisher == a.id
        b = DeltaPublisher(d, base_step=5)
        new_vals = _vals(rows, 9)
        b.publish({"t": (rows, new_vals)}, 6)
        assert _wait(lambda: sub.publisher == b.id and sub.applied_batches >= 2)
        assert sub.fallbacks >= 1 and tgt.reloads >= 1
        assert _wait(lambda: tgt.step >= 6)
        np.testing.assert_array_equal(tgt.tables["t"][rows], new_vals)
    finally:
        src.stop()
        srv.stop()


def test_corrupt_batch_falls_back_past_the_dead_seq(tmp_path):
    d = str(tmp_path / "log")
    pub = DeltaPublisher(d, base_step=0)
    rows = np.arange(4, dtype=np.int64)
    vals3 = _vals(rows, 3)
    pub.publish({"t": (rows, _vals(rows, 1))}, 1)
    pub.publish({"t": (rows, _vals(rows, 2))}, 2)
    pub.publish({"t": (rows, vals3)}, 3)
    path = seg_path(d, 2)
    blob = bytearray(open(path, "rb").read())
    blob[len(blob) // 2] ^= 0x40
    open(path, "wb").write(bytes(blob))
    tgt = FakeTarget()
    sub = DeltaSubscriber(tgt, d, config=_cfg(), checkpoint_root="ck")
    srv = DeltaStreamServer(d).start()
    src = TcpDeltaSource(sub, *srv.address, config=_cfg()).start()
    try:
        assert _wait(lambda: sub.applied_seq >= 3)
        assert sub.fallbacks == 1 and tgt.reloads == 1
        np.testing.assert_array_equal(tgt.tables["t"][rows], vals3)
    finally:
        src.stop()
        srv.stop()


class _FakeTrainer:
    def __init__(self, cfg):
        self.config = cfg

    def table_geometry(self):
        return {"t": {"layout": "dense", "group": 1, "dim": DIM, "capacity": CAP}}


def test_hybrid_plus_tcp_stream_is_a_typed_config_error(tmp_path):
    cfg = Config({"freshness_publish": "10", "freshness_dir": str(tmp_path / "log"),
                  "freshness_listen": "127.0.0.1:0"})
    with pytest.raises(HybridFreshnessError) as ei:
        TrainPublisher(_FakeTrainer(cfg), placement=object())
    assert isinstance(ei.value, ConfigError)
    assert "freshness_listen" in str(ei.value) and "hybrid" in str(ei.value)


def test_hybrid_without_listener_still_disables_with_a_notice(tmp_path, capsys):
    cfg = Config({"freshness_publish": "10", "freshness_dir": str(tmp_path / "log")})
    tp = TrainPublisher(_FakeTrainer(cfg), placement=object())
    assert tp.active is False
    assert "hybrid" in capsys.readouterr().err


def test_freshness_listen_starts_and_stops_a_stream_server(tmp_path):
    cfg = Config({"freshness_publish": "5", "freshness_dir": str(tmp_path / "log"),
                  "freshness_listen": "127.0.0.1:0"})
    tp = TrainPublisher(_FakeTrainer(cfg))
    assert tp.active
    tp.open(base_step=1)
    try:
        assert tp.stream_server is not None
        host, port = tp.stream_server.address
        assert port > 0
        tgt = FakeTarget()
        sub = DeltaSubscriber(tgt, str(tmp_path / "log"), config=_cfg())
        src = TcpDeltaSource(sub, host, port, config=_cfg()).start()
        try:
            rows = np.arange(3, dtype=np.int64)
            vals = _vals(rows, 4)
            tp.pub.publish({"t": (rows, vals)}, 2)
            assert _wait(lambda: sub.applied_seq >= 1)
            np.testing.assert_array_equal(tgt.tables["t"][rows], vals)
        finally:
            src.stop()
    finally:
        tp.close()
    assert tp.stream_server is None


def test_stream_server_drains_the_tail_on_stop(tmp_path):
    """A batch published just before ``stop()`` (as a run's final publish is
    before ``freshness_listen``'s server closes) still reaches a connected
    subscriber: stop sends the directory's tail, then closes."""
    d, tgt, sub, srv, src = _stream(tmp_path)
    try:
        pub = DeltaPublisher(d, base_step=0)
        rows = np.arange(4, dtype=np.int64)
        pub.publish({"t": (rows, _vals(rows, 1))}, 1)
        src.start()
        assert _wait(lambda: sub.applied_seq >= 1)
        last = _vals(rows, 2)
        pub.publish({"t": (rows, last)}, 2)
        srv.stop()  # at once: the server's poll has likely not seen seq 2
        assert _wait(lambda: sub.applied_seq >= 2)
        np.testing.assert_array_equal(tgt.tables["t"][rows], last)
    finally:
        src.stop()
        srv.stop()


@pytest.mark.parametrize("server", ["stream", "rpc"])
def test_stopped_server_refuses_connections(tmp_path, server):
    """After ``stop()`` the listener is gone. A bare ``close`` of the
    listening socket does not wake the accept loop's blocked ``accept``, so
    the kernel went on accepting: a subscriber's redial after the drain
    landed on the stopped server, whose loop then registered a stream
    thread that a second ``stop()`` tried to join before it had started."""
    if server == "stream":
        srv = DeltaStreamServer(str(tmp_path)).start()
    else:
        srv = RpcServer({"echo": _echo}).start()
    # the window: the accept loop's thread blocked in the kernel's accept
    wchan = f"/proc/self/task/{srv._accept_thread.native_id}/wchan"
    assert _wait(lambda: open(wchan).read().strip() == "inet_csk_accept")
    srv.stop()
    with pytest.raises(ConnectionRefusedError):
        socket.create_connection(tuple(srv.address), timeout=WAIT_S).close()
    srv.stop()  # a second stop is a no-op


class _AcceptInStopWindow:
    """A listening socket whose ``accept`` returns only once ``stop()`` has
    set the server's flag: a connection accepted between stop()'s snapshot
    of the stream threads and its close."""

    def __init__(self, real, server):
        self.real = real
        self.server = server
        self.peer = None

    def accept(self):
        if not self.server._stop.wait(WAIT_S):
            raise OSError("stop() never came")
        conn, self.peer = socket.socketpair()
        return conn, ("127.0.0.1", 0)

    def __getattr__(self, name):
        return getattr(self.real, name)


def test_stream_server_closes_a_connection_accepted_in_stops_window(tmp_path):
    """The accept race, injected: the connection is closed unserved (its
    peer reads EOF, no frame) and no stream thread is registered for it,
    so ``stop()`` neither misses a stream nor joins an unstarted thread."""
    srv = DeltaStreamServer(str(tmp_path))
    fake = _AcceptInStopWindow(srv._sock, srv)
    srv._sock = fake
    srv.start()
    srv.stop()
    assert _wait(lambda: fake.peer is not None)
    fake.peer.settimeout(WAIT_S)
    try:
        assert fake.peer.recv(1) == b""
    finally:
        fake.peer.close()
    assert srv._threads == [] and srv._conns == []
    srv.stop()
