"""Multi-host wire: TCP transport under the serving + freshness plane — the
JAX package's ``net/``, in the port.

The reference's entire identity is sockets — a ZeroMQ Master/Server/Worker
cluster exchanging framed binary meta+payload messages — and this package
puts that wire back under the roles we rebuilt in-process (docs/NETWORK.md):

* :mod:`~swiftsnails_tpu_torch.net.wire` — length-prefixed stream frames reusing
  the SSD1 magic + CRC32 discipline from ``freshness/log.py`` (one codec,
  already fuzz-hardened), with oversize prefixes rejected *before*
  allocation and typed :class:`~swiftsnails_tpu_torch.net.wire.FrameError`\\ s;
* :mod:`~swiftsnails_tpu_torch.net.rpc` — a threaded RPC server + reconnecting
  client; every connect/read/write runs under a
  :class:`~swiftsnails_tpu_torch.resilience.retry.RetryPolicy` deadline with
  decorrelated-jitter reconnect, never a bare ``recv``;
* :mod:`~swiftsnails_tpu_torch.net.replica_server` — a spawnable process wrapping
  a :class:`~swiftsnails_tpu_torch.serving.engine.Servant` behind pull/topk/
  score/health RPCs, with a fresh incarnation id per process;
* :mod:`~swiftsnails_tpu_torch.net.remote` — :class:`RemoteServant`, the client
  that plugs into ``serving/fleet.py`` behind the exact same router/
  breaker/hedge interfaces as an in-process replica;
* :mod:`~swiftsnails_tpu_torch.net.fleet` — :class:`NetFleet` (remote replicas on
  the consistent-hash ring) + :class:`ReplicaManager` (supervisor-lease
  liveness: heartbeat-renewed, expiry → ring drain → membership event →
  respawn/rejoin with a fresh incarnation; autoscale hook);
* :mod:`~swiftsnails_tpu_torch.net.delta_stream` — freshness delta subscription
  over TCP: a stream source replaces the file poll in front of
  ``DeltaSubscriber.apply_batch`` with the same seq/gap/fallback semantics.

Drilled by :func:`swiftsnails_tpu_torch.net.bench_lane.net_bench` and
:func:`~swiftsnails_tpu_torch.net.bench_lane.net_chaos_drill` with the
process-level chaos kinds ``proc_kill`` / ``net_partition`` /
``net_slow``; gated in ``ledger-report --check-regression``.
"""

from swiftsnails_tpu_torch.net.wire import (  # noqa: F401
    FrameError,
    FrameTooLarge,
    FrameTruncated,
    decode_frame,
    encode_frame,
    read_frame,
)
