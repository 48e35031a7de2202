"""The serving engine: micro-batched, cached, admission-controlled queries —
the JAX package's ``serving/engine.py``, with PyTorch inside.

:class:`Servant` is the read path of the parameter server. It owns
normalized read-only tables (contiguous ``[capacity, dim]`` tensors on the
card, built by :func:`normalize_table` from any checkpointed plane) and
answers three request kinds through per-kernel micro-batchers:

* ``pull(ids)``    — row lookup (:func:`serving.kernels.pull_rows`: the
  port's ``gather_rows`` kernel where a row is whole 16-byte words)
* ``topk(query)``  — nearest-neighbor scan (:func:`serving.kernels.topk_tiled`)
* ``score(feats)`` — CTR forward over pulled rows (the registry trainer's
  ``_rows`` and ``forward``)

**Micro-batcher.** Concurrent requests coalesce into fixed padded shapes:
request units (rows / queries) are concatenated, chunked at the largest
configured bucket, and each chunk pads up to the smallest bucket that holds
it. Pull padding uses sentinel row id 0 (``PAD_ROW``), CTR padding field
-1 (``PAD_FIELD``); pad rows are sliced off before results return, are
**never** inserted into the hot-row cache, and are counted in
``serve.<k>.pad_rows`` rather than the real-row counters. The buckets keep
the shapes the JAX package compiles for, so both packages count the same
rows and pads.

**Threads and the card.** Each kernel's batcher thread launches on the card
on the current device's default stream, which the three share, and every
result crosses to numpy (``.cpu()``, which waits for the stream) in that
thread before any request sees it. A dispatch holds its own reference to
the table it reads, so a concurrent :meth:`Servant.install_tables` never
frees a tensor a request is answered from.

**Hot-row cache.** An LRU keyed on ``(table, row_id)`` and stamped with the
servant's table *version*; :meth:`Servant.reload` bumps the version so a
table swap invalidates every cached row at once.

**Admission control.** Each batcher's queue is bounded
(``serve_queue_depth``); a submit against a full queue sheds immediately
with a typed :class:`Overloaded` instead of stalling the caller, counts a
shed, and (rate-limited) records an ``overload`` ledger event.

**Availability.** Each kernel sits behind a closed/open/half-open
:class:`~swiftsnails_tpu_torch.serving.breaker.CircuitBreaker`. While a pull
breaker is open — or when a pull dispatch fails outright — the request is
served DEGRADED from the hot-row LRU when every id is present; otherwise it
sheds with a typed :class:`~swiftsnails_tpu_torch.serving.breaker.Unavailable`.
``topk``/``score`` have no row cache to degrade from, so an open breaker
sheds them. ``serve_degraded: 0`` disables the stale fallback.
:meth:`Servant.reload_from_checkpoint` is shadow-load → CRC verify →
atomic version swap: a corrupt newer checkpoint is rejected while the live
tables keep serving.

**Tiered tables** (``table_tier: host``, ``tier_hbm_budget_mb > 0``): the
full normalized tables stay in host RAM (:class:`~swiftsnails_tpu_torch.tiered.HostMaster`)
and the card holds a fixed-budget read cache a table, prewarmed with the
id head (the zipf head: vocabulary ids are frequency-ranked). A pull
faults its cold rows in behind the hot-row LRU, remaps ids to cache slots
and reads the cache through :func:`pull_rows`; ``topk`` streams the host
master through the card one ``topk_tile_rows`` tile at a time; a delta
(:meth:`Servant.apply_rows`) lands in the master and makes its resident
rows refault.

**Freshness.** :meth:`Servant.attach_freshness` surfaces a
:class:`~swiftsnails_tpu_torch.freshness.subscriber.DeltaSubscriber`'s
watermark, lag and fallbacks through :meth:`Servant.health` and stamps the
watermark on each traced pull.

**The wire.** ``comm_dtype`` (f32, bf16, int8, int4) gives every pull the
collective wire's precision loss, bit-equal to the JAX servant's.

**Under a mesh** (``mesh=``, a
:class:`~swiftsnails_tpu_torch.parallel.mesh.Mesh` of one process a rank)
each rank holds its model rows of every resident table (a tiered table's
master stays whole in each rank's host RAM, its cache sharded like a
training tier's); pulls and scores go through the pull over ``model``,
``topk`` through the sharded scan (:mod:`~swiftsnails_tpu_torch.serving.kernels`),
``apply_rows`` writes on each rank the rows it owns, and the dense planes
are written everywhere. The rank at the mesh's origin leads and the others
follow (:mod:`~swiftsnails_tpu_torch.serving.mesh_serve`): only the leader
takes requests, and every dispatch it makes is broadcast first so that the
followers make the same collectives in the same order.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from swiftsnails_tpu_torch.parallel.mesh import MODEL_AXIS
from swiftsnails_tpu_torch.serving import mesh_serve
from swiftsnails_tpu_torch.serving.breaker import CLOSED, CircuitBreaker, Unavailable
from swiftsnails_tpu_torch.serving.cache import HotRowCache
from swiftsnails_tpu_torch.serving.kernels import (
    check_mesh,
    pull_rows,
    resolve_comm_dtype,
    topk_tiled,
    write_rows,
)
from swiftsnails_tpu_torch.telemetry import request_trace
from swiftsnails_tpu_torch.utils.device import DeviceLike, resolve_device

DEFAULT_BUCKETS = (8, 64)
DEFAULT_BREAKER_THRESHOLD = 5
DEFAULT_BREAKER_COOLDOWN_MS = 1_000.0
DEFAULT_BREAKER_PROBES = 1
DEFAULT_CACHE_ROWS = 4096
DEFAULT_QUEUE_DEPTH = 64
DEFAULT_TOPK = 10
PAD_ROW = 0  # pull-pad sentinel: a real row id, sliced off before returning
PAD_FIELD = -1  # CTR pad field (masked out of the forward, as in training)
_LATENCY_WINDOW = 4096
_REQUEST_TIMEOUT_S = 120.0
_KERNELS = ("pull", "topk", "score")


class Overloaded(RuntimeError):
    """The serve queue is full: the request was shed, not queued."""


def bucket_for(n: int, buckets: Sequence[int]) -> int:
    """Smallest configured bucket that holds ``n`` units (callers chunk at
    the largest bucket first, so ``n <= max(buckets)`` here)."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


# ---------------------------------------------------------- normalization ---


def as_tensor(arr, device: torch.device) -> torch.Tensor:
    """A contiguous tensor on ``device`` from a tensor or a numpy array (a
    numpy ``bfloat16`` array, ``ml_dtypes``', keeps its bits)."""
    if not isinstance(arr, torch.Tensor):
        a = np.array(arr, order="C")  # a writable copy; keeps a 0-d array 0-d
        if a.dtype.name == "bfloat16":
            arr = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        else:
            arr = torch.from_numpy(a)
    return arr.to(device).contiguous()


def normalize_table(arr, dim: int, layout: str,
                    capacity: Optional[int] = None) -> torch.Tensor:
    """Any checkpointed table plane -> a contiguous ``[capacity, dim]``
    tensor on the plane's device.

    ``layout``: ``dense`` (2-D ``[C, dim]``, as-is), ``packed`` (word2vec
    ``[C, S, 128]``, one logical row per tile — ``ops/rowdma.unpack_rows``),
    or ``packed_small`` (CTR ``[T, S, 128]``, ``small_group(dim)`` rows per
    tile, sublane 0 = params). Every case is an exact lane select — no
    arithmetic — so normalized rows are bit-identical to the trained ones.
    The result is contiguous so that the row kernels take it.
    """
    a = arr if isinstance(arr, torch.Tensor) else as_tensor(arr, torch.device("cpu"))
    if layout == "dense":
        return a.contiguous()
    if layout == "packed":
        from swiftsnails_tpu_torch.ops.rowdma import unpack_rows

        return unpack_rows(a, dim).contiguous()
    if layout == "packed_small":
        from swiftsnails_tpu_torch.ops.rowdma import ROW_LANES
        from swiftsnails_tpu_torch.parallel.store import small_group

        g = small_group(dim)
        stride = ROW_LANES // g
        t = a.shape[0]
        cap = capacity if capacity is not None else t * g
        # sublane 0 = params (sublane 1, when present, is the fused AdaGrad
        # accumulator); row r lives in tile r//g at lanes (r%g)*stride
        rows = a[:, 0, :].reshape(t * g, stride)
        return rows[:cap, :dim].contiguous()
    raise ValueError(f"unknown table layout {layout!r}")


def own_rows(mesh, table: torch.Tensor) -> torch.Tensor:
    """This rank's model rows of a whole normalized table; the row count
    must split over the model axis."""
    from swiftsnails_tpu_torch.parallel.mesh import model_rows, rows_per_shard

    rows_per_shard(table.shape[0], mesh)
    return model_rows(mesh, table)


def _normalize_state_tables(state, config, scorer, mesh):
    """Checkpoint state tree -> ``(tables, dense, default_table)``: the one
    normalization used by both the cold start (:meth:`Servant.from_checkpoint`)
    and the live shadow reload (:meth:`Servant.reload_from_checkpoint`).
    ``scorer`` carries the CTR geometry (None for word2vec). Under ``mesh``
    each table is then cut to this rank's model rows (:func:`own_rows`)."""
    check_mesh(mesh)
    model_name = config.get_str("model", "word2vec")
    if model_name == "word2vec":
        dim = config.get_int("dim", 100)
        layout = "packed" if config.get_bool("packed", True) else "dense"
        tables = {
            name: normalize_table(state[name]["table"], dim, layout)
            for name in ("in_table", "out_table")
            if name in state
        }
        dense = None
        default_table = "in_table"
    else:
        layout = "packed_small" if scorer.packed else "dense"
        tables = {
            "table": normalize_table(
                state["table"]["table"], scorer.table_dim, layout,
                capacity=scorer.capacity,
            )
        }
        dense = state.get("dense") or {}
        default_table = "table"
    if mesh is not None:
        tables = {k: own_rows(mesh, v) for k, v in tables.items()}
    return tables, dense, default_table


def _scorer_for(config, device: torch.device):
    """The registry trainer of ``config``'s model, as a scorer: it carries
    ``forward`` and the feature hashing; the empty data tuple keeps the
    constructor off the data path. The servant applies ``comm_dtype``
    itself, so the trainer is built without it."""
    from swiftsnails_tpu_torch.models.registry import get_model
    from swiftsnails_tpu_torch.utils.config import Config

    trainer_cls = get_model(config.get_str("model"))
    cfg = Config({k: v for k, v in config.as_dict().items() if k != "comm_dtype"})
    n_fields = cfg.get_int("num_fields")
    return trainer_cls(
        cfg, mesh=None, device=device,
        data=(np.zeros(0, np.float32), np.zeros((0, n_fields), np.int32)),
    )


# ------------------------------------------------------------ micro-batch ---


class _Request:
    __slots__ = ("payload", "n", "event", "result", "error", "t0",
                 "t_dispatch", "kernel_ms", "pad_buckets", "pad_rows", "table_version")

    def __init__(self, payload: Dict, n: int):
        self.payload = payload
        self.n = n
        self.event = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None
        self.t0 = time.perf_counter()
        # dispatcher-thread stamps: when the batch was taken, how long the
        # kernel ran, and the pad buckets it rode in. The *request* thread
        # turns these into retroactive trace spans (queue-wait / kernel)
        # after _wait returns — the dispatcher never touches the context.
        self.t_dispatch = 0.0
        self.kernel_ms = 0.0
        self.pad_buckets: Tuple[int, ...] = ()
        self.pad_rows = 0


class MicroBatcher:
    """Bounded-queue request coalescer with a dispatcher thread.

    ``dispatch(batch)`` receives a list of :class:`_Request` whose total
    units fit the largest bucket; it must set each request's ``result`` (or
    ``error``) and ``event``. Submits against a full queue raise
    :class:`Overloaded` (after invoking ``on_shed``) — callers never stall.
    """

    def __init__(
        self,
        name: str,
        buckets: Sequence[int],
        queue_depth: int,
        dispatch,
        linger_s: float = 0.0,
        on_shed=None,
    ):
        self.name = name
        self.buckets = tuple(sorted(int(b) for b in buckets))
        self.queue_depth = int(queue_depth)
        self.linger_s = float(linger_s)
        self._dispatch = dispatch
        self._on_shed = on_shed
        self._queue: "deque[_Request]" = deque()
        self._cv = threading.Condition()
        self._closed = False
        self.shed = 0
        self._thread = threading.Thread(
            target=self._loop, name=f"ssn-serve-{name}", daemon=True
        )
        self._thread.start()

    def submit(self, payload: Dict, n: int) -> _Request:
        req = _Request(payload, n)
        with self._cv:
            if self._closed:
                raise RuntimeError(f"{self.name} batcher is closed")
            if len(self._queue) >= self.queue_depth:
                self.shed += 1
                if self._on_shed is not None:
                    self._on_shed(self.name)
                raise Overloaded(
                    f"{self.name} queue full "
                    f"({len(self._queue)}/{self.queue_depth}); request shed"
                )
            self._queue.append(req)
            self._cv.notify()
        return req

    @property
    def depth(self) -> int:
        """Requests queued but not yet taken by the dispatcher — the load
        signal the fleet router's bounded spill keys on. A racy snapshot by
        design (len() on a deque is atomic under CPython)."""
        return len(self._queue)

    def _take_batch(self) -> List[_Request]:
        """Drain queued requests up to the largest bucket's unit budget."""
        batch: List[_Request] = []
        units = 0
        cap = self.buckets[-1]
        while self._queue and units + self._queue[0].n <= cap:
            req = self._queue.popleft()
            batch.append(req)
            units += req.n
        if not batch and self._queue:
            # one oversized request: dispatch chunks it internally
            batch.append(self._queue.popleft())
        return batch

    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._closed:
                    self._cv.wait()
                if self._closed and not self._queue:
                    return
                if self.linger_s > 0 and len(self._queue) == 1:
                    self._cv.wait(timeout=self.linger_s)
                batch = self._take_batch()
            if not batch:
                continue
            try:
                self._dispatch(batch)
            except BaseException as e:  # noqa: BLE001 — fail the batch, not the thread
                for req in batch:
                    if not req.event.is_set():
                        req.error = e
                        req.event.set()

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._thread.join(timeout=5.0)


def _wait(req: _Request):
    if not req.event.wait(timeout=_REQUEST_TIMEOUT_S):
        raise TimeoutError("serving request timed out")
    if req.error is not None:
        raise req.error
    return req.result


def _percentile(samples: List[float], p: float) -> float:
    if not samples:
        return 0.0
    s = sorted(samples)
    return s[min(int(p * (len(s) - 1)), len(s) - 1)]


def _host(t: torch.Tensor) -> np.ndarray:
    """A result on the host as numpy; a bf16 one as float32 (exact), since
    numpy has no bfloat16."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


# ---------------------------------------------------------------- servant ---


class Servant:
    """In-process query API over normalized read-only tables.

    ``tables``: name -> ``[capacity, dim]`` tensor or numpy array, moved to
    ``device`` (default: the card) as contiguous tensors. ``scorer``: a
    registry CTR trainer instance (forward + feature hashing) when the
    ``score`` kernel should be live; ``dense`` is its checkpointed dense
    dict. ``registry`` is a telemetry
    :class:`~swiftsnails_tpu_torch.telemetry.registry.MetricRegistry` (a
    private one is created when omitted); ``ledger`` receives ``overload``,
    ``degraded``, ``breaker`` and ``cache_error`` events.

    ``mesh`` (module docstring): ``tables`` are whole, and each rank keeps
    its model rows, or with ``sharded`` they are this rank's rows already
    (a fleet's replicas share replica 0's). Every rank makes the same
    servants in the same order; the leader serves, the others run
    :func:`~swiftsnails_tpu_torch.serving.mesh_serve.follow`.
    """

    def __init__(
        self,
        tables: Dict[str, Any],
        *,
        manifest: Optional[Dict] = None,
        mesh=None,
        scorer=None,
        dense=None,
        registry=None,
        ledger=None,
        batch_buckets: Sequence[int] = DEFAULT_BUCKETS,
        cache_rows: int = DEFAULT_CACHE_ROWS,
        queue_depth: int = DEFAULT_QUEUE_DEPTH,
        linger_s: float = 0.0,
        comm_dtype: str = "float32",
        topk: int = DEFAULT_TOPK,
        topk_tile_rows: int = 4096,
        default_table: Optional[str] = None,
        tier_hbm_budget_mb: float = 0.0,
        breaker_threshold: int = DEFAULT_BREAKER_THRESHOLD,
        breaker_cooldown_ms: float = DEFAULT_BREAKER_COOLDOWN_MS,
        breaker_halfopen_probes: int = DEFAULT_BREAKER_PROBES,
        degraded: bool = True,
        request_tracer=None,
        slo=None,
        device: DeviceLike = None,
        sharded: bool = False,
    ):
        if not tables:
            raise ValueError("Servant needs at least one table")
        check_mesh(mesh)
        self.mesh = mesh
        if mesh is not None and device is None:
            device = mesh.device
        self.device = resolve_device(device)
        self._channel = mesh_serve.channel(mesh) if mesh is not None else None
        # ops plane: a telemetry RequestTracer captures per-request span
        # trees (head-sampled + anomaly tail-keep); an SloTracker burns the
        # error budget. Both optional — None costs one attribute check.
        self.request_tracer = request_tracer
        self.slo = slo
        self._freshness = None  # an attached DeltaSubscriber (health, traces)
        self.comm_dtype = resolve_comm_dtype(comm_dtype)
        self.topk_default = int(topk)
        self.topk_tile_rows = int(topk_tile_rows)
        self.scorer = scorer
        self.ledger = ledger
        self.manifest = manifest or {}
        self.step = int(self.manifest.get("step", 0) or 0)
        self.version = 0  # bumped by every reload; keys the hot-row cache
        # table_tier: host (tier_hbm_budget_mb > 0): the full normalized
        # tables stay in host RAM and the card holds fixed-budget read
        # caches — cold rows fault in batched behind the hot-row LRU
        # (serving vocabularies bigger than device memory). 0 = resident.
        self.tier: Dict[str, Any] = {}
        self._tier_cache: Dict[str, Any] = {}
        self._tier_lock = threading.Lock()
        self.tier_budget_mb = float(tier_hbm_budget_mb)
        self._tier_stats = None
        if self.tier_budget_mb > 0:
            self._tables = {k: as_tensor(v, torch.device("cpu"))
                            for k, v in tables.items()}
            self._build_tier()
        else:
            self._tables = self._on_device(self._own(tables, sharded))
        self._names = sorted(self._tables)
        self._dense = self._on_device(dense) if dense is not None else {}
        self.default_table = default_table or (
            "in_table" if "in_table" in self._tables else
            sorted(self._tables)[0]
        )
        self.buckets = tuple(sorted(int(b) for b in batch_buckets))

        if registry is None:
            from swiftsnails_tpu_torch.telemetry.registry import MetricRegistry

            registry = MetricRegistry()
        self.registry = registry
        self.cache = HotRowCache(cache_rows)
        self._latency: Dict[str, "deque[float]"] = {
            k: deque(maxlen=_LATENCY_WINDOW) for k in _KERNELS
        }
        self._shed_events = 0  # overload ledger events already written
        self._lock = threading.Lock()
        # availability layer: per-kernel breakers (threshold 0 disables) +
        # degraded-mode stale reads. `fault_hook` is the seeded chaos
        # injection point — fn(kernel, dispatch_index) may raise or stall,
        # exactly as a sick device/storage read would.
        self.degraded_enabled = bool(degraded)
        self.fault_hook = None
        self._dispatch_seq = {k: 0 for k in _KERNELS}
        self.breakers: Dict[str, CircuitBreaker] = {}
        if int(breaker_threshold) > 0:
            self.breakers = {
                k: CircuitBreaker(
                    k,
                    threshold=int(breaker_threshold),
                    cooldown_ms=float(breaker_cooldown_ms),
                    halfopen_probes=int(breaker_halfopen_probes),
                    on_transition=self._on_breaker_transition,
                )
                for k in _KERNELS
            }

        # the kernels' seams (tests stall a dispatch by replacing _pull_fn)
        self._pull_fn = lambda table, rows: pull_rows(
            table, rows, mesh=self.mesh, comm_dtype=self.comm_dtype)
        self._score_fn = self._score_impl if scorer is not None else None

        self._batchers = {
            k: MicroBatcher(
                k, self.buckets, queue_depth, fn,
                linger_s=linger_s, on_shed=self._note_shed,
            )
            for k, fn in (("pull", self._dispatch_pull),
                          ("topk", self._dispatch_topk),
                          ("score", self._dispatch_score))
        }
        self._mesh_id = (self._channel.register(self) if self._channel is not None
                         else None)

    def _on_device(self, arrays: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        return {k: as_tensor(v, self.device) for k, v in arrays.items()}

    def _own(self, tables: Dict[str, Any], sharded: bool) -> Dict[str, Any]:
        """Under a mesh, this rank's model rows of whole ``tables`` (as
        given where ``sharded``)."""
        if self.mesh is None or sharded:
            return tables
        return {k: own_rows(self.mesh, as_tensor(v, torch.device("cpu")))
                for k, v in tables.items()}

    # -- the mesh's leader and followers (serving/mesh_serve.py) -------------

    def _mesh_lock(self):
        """The process's dispatch lock on a meshed leader (taken before
        the servant's own locks), else nothing to hold."""
        ch = self._channel
        return ch.lock if ch is not None and ch.leader else contextlib.nullcontext()

    def _lead(self, op: int, ints=(), tensors=()) -> None:
        """On a meshed leader, send the followers ``op`` for this servant
        (under :meth:`_mesh_lock`, which the caller holds). A servant of a
        stopped session raises: its followers are gone."""
        ch = self._channel
        if ch is None or not ch.leader:
            return
        if ch.stopped:
            raise RuntimeError("this servant's serving session on the mesh has stopped")
        ch.send(op, self._mesh_id, ints, tensors)

    def _follow(self, op: int, args, ch) -> None:
        """A follower's side of one op the leader sent (its ``args``, its
        tensors read from ``ch``): the same call on this rank's shard."""
        if op in (mesh_serve.PULL, mesh_serve.TIER_PULL):
            name, n = self._names[args[0]], args[1]
            ids = ch.recv((n,), torch.int32)
            if op == mesh_serve.TIER_PULL:
                self._tier_pull(name, ids.numpy())
            else:
                self._pull_fn(self._tables[name], ids.to(self.device))
        elif op == mesh_serve.TOPK:
            name, n, k, normalize, dim = self._names[args[0]], *args[1:5]
            q = ch.recv((n, dim), torch.float32).to(self.device)
            topk_tiled(self._tables[name], q, k=k, tile_rows=self.topk_tile_rows,
                       normalize=bool(normalize), mesh=self.mesh)
        elif op == mesh_serve.SCORE:
            feats = ch.recv((args[0], args[1]), torch.int32).to(self.device)
            self._score_fn(self._tables[self.default_table], self._dense, feats)
        elif op == mesh_serve.APPLY:
            updates = mesh_serve.recv_updates(ch, args[0], self._names)
            plan = ch.voted("apply_rows", lambda: self._prepare_apply(updates))
            self._commit_apply(plan, version=mesh_serve.opt(args[1]),
                               step=mesh_serve.opt(args[2]))
        elif op == mesh_serve.RELOAD:
            root, step, config, retry = mesh_serve.recv_reload(ch, args)
            tables, manifest, dense = ch.voted(
                "reload_from_checkpoint", lambda: self._shadow_load(root, config, step, retry))
            self.reload(tables, manifest=manifest, dense=dense, sharded=True)
        else:
            raise ValueError(f"servant: unknown mesh op {op}")

    # -- tiered read path (table_tier: host; see tiered/) -------------------

    def _build_tier(self) -> None:
        """Wrap each host table in a read-only :class:`TieredTable` with a
        prewarmed cache on the card. Vocab ids are frequency-ranked (the
        training ordering contract), so the id head IS the zipf head —
        prewarm it. ``_tables`` then holds the masters' own arrays (one host
        copy a table)."""
        from swiftsnails_tpu_torch.parallel.store import TableState
        from swiftsnails_tpu_torch.tiered.store import (
            HostMaster, TieredTable, TierStats, _to_torch,
        )

        if self._tier_stats is None:
            self._tier_stats = TierStats()
        budget_each = self.tier_budget_mb / max(len(self._tables), 1)
        self.tier = {}
        self._tier_cache = {}
        for name, arr in self._tables.items():
            master = HostMaster(TableState(table=arr, slots={}), "dense")
            units = int(budget_each * (1 << 20) // max(master.unit_nbytes, 1))
            tt = TieredTable(master, units, mesh=self.mesh, name=name,
                             stats=self._tier_stats, read_only=True, device=self.device)
            cache = tt.make_cache()
            cache = tt.prewarm(
                cache, np.arange(min(tt.budget, master.units), dtype=np.int64))
            self.tier[name] = tt
            self._tier_cache[name] = cache
            self._tables[name] = _to_torch(master.table, master.table_dtype)

    def _tier_pull(self, name: str, ids: np.ndarray) -> torch.Tensor:
        """Cold-row fault: make ``ids`` resident in the cache plane, remap to
        slots, gather from the cache (:func:`pull_rows`). The lock
        serializes fault + remap + gather across the batcher threads — a
        concurrent eviction must never overwrite a slot between the remap
        and its read. Under a mesh every rank faults the same ids (the
        leader sends them first), so the slot maps stay equal."""
        tt = self.tier[name]
        ids = np.asarray(ids, np.int32)
        with self._mesh_lock(), self._tier_lock:
            if self._channel is not None:
                tt.check(ids)  # what ensure would refuse fails here, before any rank sees it
            self._lead(mesh_serve.TIER_PULL, (self._names.index(name), len(ids)),
                       (torch.from_numpy(ids),))
            cache = tt.ensure(self._tier_cache[name], ids)
            self._tier_cache[name] = cache
            slots = torch.from_numpy(tt.remap(ids)).to(self.device)
            return self._pull_fn(cache.table, slots)

    def _topk_master(self, name: str, queries: np.ndarray, k: int,
                     normalize: bool) -> Tuple[np.ndarray, np.ndarray]:
        """Over-budget topk: stream the host master through the card one
        ``topk_tile_rows`` tile at a time with :func:`topk_tiled` — the full
        table never resides on the card. Scores are per row (cosine or raw
        dot), so the parts merge exactly; a stable sort over the parts in
        row order keeps the resident scan's tie order (lower id first)."""
        master = self._tables[name]
        tile = max(int(self.topk_tile_rows), 1)
        q = torch.from_numpy(np.ascontiguousarray(queries, np.float32)).to(self.device)
        parts_s: List[np.ndarray] = []
        parts_i: List[np.ndarray] = []
        for lo in range(0, master.shape[0], tile):
            chunk = master[lo:lo + tile].to(self.device)
            s, i = topk_tiled(chunk, q, k=min(k, chunk.shape[0]), tile_rows=tile,
                              normalize=normalize)
            parts_s.append(_host(s))
            parts_i.append(_host(i) + lo)
        s = np.concatenate(parts_s, axis=1)
        i = np.concatenate(parts_i, axis=1)
        order = np.argsort(-s, axis=1, kind="stable")[:, :k]
        rows = np.arange(s.shape[0])[:, None]
        return s[rows, order], i[rows, order]

    # -- lifecycle ---------------------------------------------------------

    @classmethod
    def from_checkpoint(
        cls,
        root: str,
        config,
        *,
        step: Optional[int] = None,
        mesh=None,
        device: DeviceLike = None,
        **kwargs,
    ) -> "Servant":
        """Load a verified checkpoint into a query-only servant on
        ``device`` (default: the card).

        ``config`` is the same typed config the training run used — it
        carries the model family and table geometry the checkpointed tensors
        are laid out with (``model``, ``dim``/``num_fields``, ``packed``,
        ``capacity``), plus the ``serve_*`` and ``breaker_*`` knobs.

        Under ``mesh`` every rank calls this with the same arguments: each
        loads the checkpoint on the host and keeps its model rows of the
        resident tables (a tiered servant keeps the whole master).
        """
        from swiftsnails_tpu_torch.framework.checkpoint import load_tables

        check_mesh(mesh)
        dev = resolve_device(mesh.device if mesh is not None and device is None else device)
        tiered = config.get_str("table_tier", "device") == "host"
        if tiered:
            kwargs.setdefault("tier_hbm_budget_mb",
                              config.get_float("tier_hbm_budget_mb", 64.0))
        # a tiered servant's tables stay in host RAM: they never cross to
        # the card whole; under a mesh neither do a rank's other rows
        state, manifest = load_tables(
            root, step=step,
            device=torch.device("cpu") if tiered or mesh is not None else dev)
        scorer = None
        if config.get_str("model", "word2vec") != "word2vec":
            scorer = _scorer_for(config, dev)
        tables, dense, default_table = _normalize_state_tables(
            state, config, scorer, None if tiered else mesh)
        del state  # the packed planes: only the normalized ones are served
        kwargs.setdefault("batch_buckets", _int_list(
            config.get_str("serve_batch_buckets", ""), DEFAULT_BUCKETS))
        kwargs.setdefault("cache_rows",
                          config.get_int("serve_cache_rows", DEFAULT_CACHE_ROWS))
        kwargs.setdefault("queue_depth",
                          config.get_int("serve_queue_depth", DEFAULT_QUEUE_DEPTH))
        kwargs.setdefault("topk", config.get_int("serve_topk", DEFAULT_TOPK))
        kwargs.setdefault("comm_dtype", config.get_str("comm_dtype", "float32"))
        kwargs.setdefault("breaker_threshold", config.get_int(
            "breaker_threshold", DEFAULT_BREAKER_THRESHOLD))
        kwargs.setdefault("breaker_cooldown_ms", config.get_float(
            "breaker_cooldown_ms", DEFAULT_BREAKER_COOLDOWN_MS))
        kwargs.setdefault("breaker_halfopen_probes", config.get_int(
            "breaker_halfopen_probes", DEFAULT_BREAKER_PROBES))
        kwargs.setdefault("degraded", config.get_bool("serve_degraded", True))
        if "request_tracer" not in kwargs:
            from swiftsnails_tpu_torch.telemetry.request_trace import RequestTracer

            kwargs["request_tracer"] = RequestTracer.from_config(
                config, ledger=kwargs.get("ledger"))
        if "slo" not in kwargs:
            from swiftsnails_tpu_torch.telemetry.slo import SloTracker

            kwargs["slo"] = SloTracker.from_config(
                config, ledger=kwargs.get("ledger"))
        servant = cls(
            tables, manifest=manifest, mesh=mesh, scorer=scorer, dense=dense,
            default_table=default_table, device=dev, sharded=True, **kwargs,
        )
        return servant

    def reload(self, tables: Dict[str, Any], manifest: Optional[Dict] = None,
               dense=None, *, version: Optional[int] = None,
               sharded: bool = False) -> int:
        """Swap in new tables; bumps the version so every cached row of the
        old tables misses (stale rows can never be served). ``version`` is
        the fleet-epoch override: replicas sharing one logical swap all cut
        over to the SAME number instead of bumping independently. Under a
        mesh ``tables`` and ``sharded`` are as the constructor takes them,
        and every rank calls this with the same tables (a reload from a
        checkpoint sends itself to the followers)."""
        tiered = self.tier_budget_mb > 0
        new_tables = ({k: as_tensor(v, torch.device("cpu")) for k, v in tables.items()}
                      if tiered else self._on_device(self._own(tables, sharded)))
        new_dense = self._on_device(dense) if dense is not None else None
        with self._lock:
            self._tables = new_tables
            self._names = sorted(new_tables)
            if tiered:
                # new masters + fresh caches and slot maps: a stale slot
                # mapping against the old tables must never serve again (the
                # version bump below already invalidates the hot-row LRU)
                with self._tier_lock:
                    self._build_tier()
            if new_dense is not None:
                self._dense = new_dense
            if manifest is not None:
                self.manifest = manifest
                self.step = int(manifest.get("step", self.step) or 0)
            self.version = int(version) if version is not None \
                else self.version + 1
            return self.version

    # -- delta apply -------------------------------------------------------

    def prepare_rows(self, updates: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """Build the post-delta table planes OFF the serving path (nothing
        is installed). ``updates``: ``{table: (row_ids, [n, dim] values)}``
        of absolute normalized rows. Each plane is a clone of the live one
        with the rows written by :func:`~swiftsnails_tpu_torch.serving.kernels.write_rows`
        (the port's ``scatter_write_rows`` kernel where a row is whole
        16-byte words). Where an id repeats, its last value wins; ids
        outside ``[0, C)`` are dropped. Split from :meth:`install_tables`
        so a fleet computes the new planes once and installs the SAME
        tensors into every replica at one shared epoch. Under a mesh each
        rank writes the rows its shard owns (every rank calls this with the
        same delta)."""
        out: Dict[str, torch.Tensor] = {}
        for name, (ids, vals) in updates.items():
            if name not in self._tables:
                continue  # a delta stream may carry tables we don't serve
            tab = self._tables[name]
            ids = np.asarray(ids, np.int64).reshape(-1)
            vals = np.asarray(vals).reshape((ids.shape[0],) + tuple(tab.shape[1:]))
            # the last occurrence of each id, in range (this rank's rows)
            lo = 0 if self.mesh is None else self.mesh.axis_index(MODEL_AXIS) * tab.shape[0]
            last = ids.shape[0] - 1 - np.unique(ids[::-1], return_index=True)[1]
            last = last[(ids[last] >= lo) & (ids[last] < lo + tab.shape[0])]
            rows = torch.from_numpy((ids[last] - lo).astype(np.int32)).to(self.device)
            values = as_tensor(vals[last], self.device).to(tab.dtype)
            new = tab.clone()
            if rows.numel():
                write_rows(new, rows, values)
            out[name] = new
        return out

    def install_tables(self, new_tables: Dict[str, Any], *,
                       version: Optional[int] = None,
                       step: Optional[int] = None) -> int:
        """Atomic cutover of (some) resident planes: the table dict is
        replaced wholesale under the lock, so a concurrent request sees the
        whole old set or the whole new set — never a torn batch. The version
        bump invalidates every hot-row cache entry of the old planes."""
        placed = self._on_device(new_tables)
        with self._lock:
            self._tables = {**self._tables, **placed}
            if step is not None:
                self.step = max(self.step, int(step))
            self.version = int(version) if version is not None \
                else self.version + 1
            return self.version

    def apply_rows(self, updates: Dict[str, Any], *,
                   version: Optional[int] = None,
                   step: Optional[int] = None) -> int:
        """Apply one delta batch of absolute rows with an atomic version
        cutover; returns the new version. Resident tables go through
        :meth:`prepare_rows` + :meth:`install_tables`; tiered tables scatter
        into the host masters (through ``HostMaster.scatter``, so the
        integrity digests stay true), bump the touched units' write-back
        generation, and drop their resident cache slots so the next pull
        refaults the fresh rows. Where an id repeats, its last value wins.

        Under a mesh the leader sends the delta to the followers first;
        every rank checks it and builds what it would install, and only when
        every rank succeeded (:meth:`ServeChannel.voted
        <swiftsnails_tpu_torch.serving.mesh_serve.ServeChannel.voted>`) does
        each apply it to what it holds, at the same version; else every rank
        keeps its tables and the call raises
        :class:`~swiftsnails_tpu_torch.serving.mesh_serve.Refused`."""
        if self._channel is None:
            return self._commit_apply(self._prepare_apply(updates), version=version,
                                      step=step)
        names = self._names
        with self._mesh_lock():
            updates = mesh_serve.served_updates(updates, names)
            self._lead(mesh_serve.APPLY,
                       (len(updates), -1 if version is None else version,
                        -1 if step is None else step),
                       mesh_serve.updates_tensors(updates, names))
            plan = self._channel.voted("apply_rows", lambda: self._prepare_apply(updates))
            return self._commit_apply(plan, version=version, step=step)

    def _prepare_apply(self, updates: Dict[str, Any]):
        """The half of :meth:`apply_rows` that may fail, changing nothing:
        the new resident planes (:meth:`prepare_rows`), or each tiered
        table's rows, the last of a repeated id, checked against its
        master."""
        if self.tier_budget_mb <= 0:
            return self.prepare_rows(updates)
        out = {}
        for name, (ids, vals) in updates.items():
            if name not in self.tier:
                continue  # a delta table this servant does not serve
            master = self.tier[name].master
            ids = np.asarray(ids, np.int64).reshape(-1)
            vals = np.asarray(vals, np.float32).reshape(
                (ids.shape[0],) + master.table.shape[1:])
            last = ids.shape[0] - 1 - np.unique(ids[::-1], return_index=True)[1]
            ids, vals = ids[last], vals[last]
            if ids.size and (ids.min() < 0 or ids.max() >= master.units):
                raise IndexError(f"apply_rows[{name}]: row ids [{ids.min()}, {ids.max()}] "
                                 f"out of range for {master.units} rows")
            out[name] = (ids, vals.astype(master.table.dtype))
        return out

    def _commit_apply(self, plan, *, version: Optional[int], step: Optional[int]) -> int:
        """Install what :meth:`_prepare_apply` built; returns the version."""
        if self.tier_budget_mb <= 0:
            return self.install_tables(plan, version=version, step=step)
        with self._lock, self._tier_lock:
            for name, (ids, vals) in plan.items():
                tt = self.tier[name]
                # serving masters are dense group-1 f32 planes: unit == row
                tt.master.scatter(ids, vals, {})
                tt.master_ver[ids] += 1
                res = ids[tt.slot_of[ids] >= 0]
                if res.size:
                    slots = tt.slot_of[res]
                    tt.unit_of[slots] = -1
                    tt.ref[slots] = 0
                    tt.slot_of[res] = -1
            if step is not None:
                self.step = max(self.step, int(step))
            self.version = int(version) if version is not None \
                else self.version + 1
            return self.version

    def reload_from_checkpoint(self, root: str, config, *,
                               step: Optional[int] = None,
                               retry=None) -> int:
        """Shadow-load → CRC verify → atomic version swap.

        The candidate checkpoint is fully loaded and manifest-verified OFF
        the serving path (:func:`load_tables` with ``verify=True``), then
        normalized into dense planes, and only then swapped in under the
        servant lock with a version bump — a corrupt newer checkpoint is
        rejected here (``CheckpointError``) while the live tables keep
        serving the old version untouched. ``retry`` (a
        :class:`~swiftsnails_tpu_torch.resilience.retry.RetryPolicy`) absorbs
        transient storage errors during the shadow load.

        Under a mesh every rank loads the checkpoint itself: the leader
        sends the root, the step it verified, ``config`` and ``retry``'s
        knobs to the followers, and no rank swaps unless every rank loaded
        (:class:`~swiftsnails_tpu_torch.serving.mesh_serve.Refused`
        otherwise, every rank serving on)."""
        tables, manifest, dense = self._shadow_load(root, config, step, retry)
        if self._channel is None:
            return self.reload(tables, manifest=manifest, dense=dense)
        with self._mesh_lock():
            self._lead(mesh_serve.RELOAD, *mesh_serve.reload_payload(
                root, int(manifest.get("step", step or 0)), config, retry))
            try:
                self._channel.voted("reload_from_checkpoint", lambda: None)
            except mesh_serve.Refused as e:
                self._reload_rejected(root, step, e)
                raise
            return self.reload(tables, manifest=manifest, dense=dense, sharded=True)

    def _shadow_load(self, root: str, config, step: Optional[int], retry):
        """The checkpoint's verified, normalized ``(tables, manifest,
        dense)`` (this rank's rows under a mesh), nothing swapped; a
        failure is counted and logged, then raised."""
        from swiftsnails_tpu_torch.framework.checkpoint import load_tables

        tiered = self.tier_budget_mb > 0
        try:
            state, manifest = load_tables(
                root, step=step, verify=True, retry=retry,
                device=torch.device("cpu") if self.mesh is not None else self.device)
            tables, dense, _ = _normalize_state_tables(
                state, config, self.scorer, None if tiered else self.mesh)
        except Exception as e:
            self._reload_rejected(root, step, e)
            raise
        return tables, manifest, dense

    def _reload_rejected(self, root: str, step: Optional[int], err: BaseException) -> None:
        self.registry.counter("serve.reload_rejected").inc()
        if self.ledger is not None:
            try:
                self.ledger.append("cache_error", {
                    "source": "serve_reload",
                    "root": root,
                    "step": step,
                    "kept_version": self.version,
                    "error": f"{type(err).__name__}: {err}",
                })
            except Exception:
                pass

    def close(self) -> None:
        for b in self._batchers.values():
            b.close()
        self._flush_overloads(final=True)

    def __enter__(self) -> "Servant":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- request API -------------------------------------------------------

    def pull(self, ids, table: Optional[str] = None) -> np.ndarray:
        """[N] row ids -> [N, dim] rows (cache -> micro-batch -> kernel).

        Availability ladder: fresh cache hits and a healthy dispatch serve
        normally; an open pull breaker — or a dispatch failure — falls back
        to the stale hot-row LRU when every id is present (a DEGRADED serve,
        counted apart from the fresh path); otherwise the typed error
        propagates (:class:`Unavailable` when the breaker shed it)."""
        t0 = time.perf_counter()
        name = table or self.default_table
        ids = np.asarray(ids, np.int32).reshape(-1)
        ctx, owned = self._trace_begin("pull", table=name, n=len(ids))
        try:
            with request_trace.use(ctx):
                out = self._pull_traced(name, ids, t0, ctx)
        except BaseException as e:
            self._trace_end("pull", ctx, owned, t0, error=e)
            raise
        self._trace_end("pull", ctx, owned, t0)
        return out

    def _empty_rows(self, name: str) -> np.ndarray:
        return np.zeros((0,) + tuple(self._tables[name].shape[1:]), np.float32)

    def _pull_traced(self, name: str, ids: np.ndarray, t0: float,
                     ctx) -> np.ndarray:
        version = self.version
        found, missing = self.cache.get_many(name, version, ids)
        if ctx is not None:
            ctx.annotate(table=name, table_version=version,
                         cache_hits=len(found), cache_misses=len(missing))
            self._annotate_freshness(ctx)
        if missing:
            br = self.breakers.get("pull")
            if br is not None and not br.allow():
                if ctx is not None:
                    ctx.annotate(breaker="open")
                return self._pull_degraded(name, ids, t0, reason="open")
            try:
                req = self._batchers["pull"].submit(
                    {"table": name, "ids": np.asarray(missing, np.int32),
                     "version": version},
                    n=len(missing),
                )
                pulled = _wait(req)  # [len(missing), dim]
            except Overloaded:
                raise  # queue pressure, not kernel health
            except Exception:
                if br is not None:
                    br.record_failure()
                if self.degraded_enabled:
                    return self._pull_degraded(
                        name, ids, t0, reason="dispatch_failure")
                raise
            if br is not None:
                br.record_success()
            self._trace_dispatch(ctx, req)
            if found and req.table_version != version:
                # the cache's rows are of `version` and the dispatch read a
                # newer table: answer from one version, starting over
                return self._pull_traced(name, ids, t0, ctx)
            found.update(
                (int(i), pulled[n]) for n, i in enumerate(missing)
            )
        out = np.stack([found[int(i)] for i in ids]) if len(ids) else \
            self._empty_rows(name)
        self._observe("pull", t0, units=len(ids), ctx=ctx)
        return out

    def _pull_degraded(self, name: str, ids: np.ndarray, t0: float,
                       reason: str) -> np.ndarray:
        """Serve a pull from the stale hot-row LRU, or shed. Only complete
        answers are served — a partially-stale response would silently mix
        row generations within one request."""
        if self.degraded_enabled:
            found, missing = self.cache.get_stale(name, ids)
            if not missing:
                self._note_degraded("pull", len(ids), reason)
                self._observe("pull", t0, units=len(ids),
                              ctx=request_trace.current())
                return np.stack([found[int(i)] for i in ids]) if len(ids) \
                    else self._empty_rows(name)
            detail = f"{len(missing)}/{len(ids)} id(s) not in the stale cache"
        else:
            detail = "degraded reads disabled (serve_degraded: 0)"
        self.registry.counter("serve.pull.unavailable").inc()
        raise Unavailable(f"pull[{name}]: breaker {reason}; {detail}")

    def topk(
        self,
        query,
        k: Optional[int] = None,
        table: Optional[str] = None,
        exclude: Sequence[int] = (),
        normalize: bool = True,
    ) -> List[Tuple[int, float]]:
        """Nearest rows to ``query`` ([dim]) by cosine (or raw dot) score.

        ``exclude`` ids are filtered host-side (the kernel scans the full
        table); the request over-fetches by ``len(exclude)`` to compensate.
        """
        t0 = time.perf_counter()
        name = table or self.default_table
        k = int(k or self.topk_default)
        q = np.asarray(query, np.float32).reshape(1, -1)
        ctx, owned = self._trace_begin("topk", table=name, k=k)
        try:
            with request_trace.use(ctx):
                scores, ids = self._guarded_dispatch(
                    "topk",
                    {"table": name, "queries": q, "k": k + len(exclude),
                     "normalize": normalize},
                    n=1,
                )  # ([1, k+x], [1, k+x])
        except BaseException as e:
            self._trace_end("topk", ctx, owned, t0, error=e)
            raise
        excluded = set(int(e) for e in exclude)
        out = [
            (int(i), float(s))
            for i, s in zip(ids[0], scores[0])
            if int(i) not in excluded and int(i) >= 0
        ][:k]
        self._observe("topk", t0, units=1, ctx=ctx)
        self._trace_end("topk", ctx, owned, t0)
        return out

    def score(self, feats) -> np.ndarray:
        """CTR probability scores for ``feats`` [B, F] (or [F])."""
        if self.scorer is None:
            raise RuntimeError("this servant has no CTR scorer model")
        t0 = time.perf_counter()
        feats = np.asarray(feats, np.int32)
        if feats.ndim == 1:
            feats = feats[None, :]
        ctx, owned = self._trace_begin("score", n=len(feats))
        try:
            with request_trace.use(ctx):
                out = self._guarded_dispatch(
                    "score", {"feats": feats}, n=len(feats))
        except BaseException as e:
            self._trace_end("score", ctx, owned, t0, error=e)
            raise
        self._observe("score", t0, units=len(feats), ctx=ctx)
        self._trace_end("score", ctx, owned, t0)
        return out

    def _guarded_dispatch(self, kernel: str, payload: Dict, n: int):
        """Submit + wait under the kernel's breaker. ``topk``/``score`` have
        no row cache to degrade from: an open breaker sheds with a typed
        :class:`Unavailable`; dispatch failures feed the breaker and
        propagate."""
        br = self.breakers.get(kernel)
        if br is not None and not br.allow():
            self.registry.counter(f"serve.{kernel}.unavailable").inc()
            ctx = request_trace.current()
            if ctx is not None:
                ctx.annotate(breaker="open")
            raise Unavailable(f"{kernel}: breaker open; request shed")
        try:
            req = self._batchers[kernel].submit(payload, n=n)
            result = _wait(req)
        except Overloaded:
            raise  # queue pressure, not kernel health
        except Exception:
            if br is not None:
                br.record_failure()
            raise
        if br is not None:
            br.record_success()
        self._trace_dispatch(request_trace.current(), req)
        return result

    # -- dispatch (batcher thread) ----------------------------------------

    def _maybe_fault(self, kernel: str) -> None:
        """Chaos injection point, once per dispatched batch: the hook may
        raise or stall exactly where a sick storage/device read would. No-op
        (one attribute load) when no hook is installed."""
        hook = self.fault_hook
        if hook is None:
            return
        idx = self._dispatch_seq[kernel]
        self._dispatch_seq[kernel] = idx + 1
        hook(kernel, idx)

    def _dispatch_pull(self, batch: List[_Request]) -> None:
        self._maybe_fault("pull")
        by_table: Dict[str, List[_Request]] = {}
        for req in batch:
            by_table.setdefault(req.payload["table"], []).append(req)
        for name, reqs in by_table.items():
            ids = np.concatenate([r.payload["ids"] for r in reqs])
            t_disp = time.perf_counter()
            rows, buckets, pad_rows, table_version = self._pull_version(name, ids)
            kernel_ms = (time.perf_counter() - t_disp) * 1e3
            # split back per request; insert REAL rows into the cache (pad
            # rows never reach here — _pull_padded slices them off), stamped
            # with the version of the table they were read from
            self.cache.put_many(name, table_version, ids, rows)
            off = 0
            for req in reqs:
                req.table_version = table_version
                req.t_dispatch = t_disp
                req.kernel_ms = kernel_ms
                req.pad_buckets = buckets
                req.pad_rows = pad_rows
                req.result = rows[off : off + req.n]
                off += req.n
                req.event.set()

    def _pull_version(self, name: str, ids: np.ndarray):
        """:meth:`_pull_padded` on one version of the table, and that
        version. A tiered table changes in place (``apply_rows``, ``reload``
        under the servant lock), so its pull holds the lock. A meshed
        leader holds its dispatch lock throughout, so that no rank swaps
        its shard between the version read and the pull."""
        with self._mesh_lock():
            if name in self.tier:
                with self._lock:
                    return (*self._pull_padded(name, ids), self.version)
            with self._lock:
                table, version = self._tables[name], self.version
            return (*self._pull_padded(name, ids, table), version)

    def _pull_padded(
        self, name: str, ids: np.ndarray, table: Optional[torch.Tensor] = None,
    ) -> Tuple[np.ndarray, Tuple[int, ...], int]:
        """Chunk at the largest bucket, pad each chunk to its bucket with
        the sentinel row, pull, slice the pads off. Pad rows are excluded
        from the pulled-rows counter (they count as ``pad_rows``) and are
        never cached. Returns ``(rows, buckets_used, pad_rows)`` so the
        dispatcher can stamp pad attribution onto each request's trace."""
        table = self._tables[name] if table is None else table
        cap = self.buckets[-1]
        out: List[np.ndarray] = []
        buckets_used: List[int] = []
        pad_total = 0
        for lo in range(0, len(ids), cap):
            chunk = ids[lo : lo + cap]
            b = bucket_for(len(chunk), self.buckets)
            pad = b - len(chunk)
            padded = np.concatenate(
                [chunk, np.full(pad, PAD_ROW, np.int32)]
            ) if pad else chunk
            if name in self.tier:
                vals = _host(self._tier_pull(name, padded))
            else:
                rows = torch.from_numpy(np.ascontiguousarray(padded, np.int32))
                self._lead(mesh_serve.PULL, (self._names.index(name), len(padded)), (rows,))
                vals = _host(self._pull_fn(table, rows.to(self.device)))
            out.append(vals[: len(chunk)])
            buckets_used.append(b)
            pad_total += pad
            self.registry.counter("serve.pull.rows").inc(len(chunk))
            self.registry.counter("serve.pull.pad_rows").inc(pad)
        rows = np.concatenate(out) if out else self._empty_rows(name)
        return rows, tuple(buckets_used), pad_total

    def _dispatch_topk(self, batch: List[_Request]) -> None:
        self._maybe_fault("topk")
        by_key: Dict[Tuple[str, int, bool], List[_Request]] = {}
        for req in batch:
            p = req.payload
            by_key.setdefault(
                (p["table"], p["k"], p["normalize"]), []
            ).append(req)
        for (name, k, normalize), reqs in by_key.items():
            queries = np.concatenate([r.payload["queries"] for r in reqs])
            t_disp = time.perf_counter()
            pad_total = 0
            buckets_used: List[int] = []
            cap = self.buckets[-1]
            all_s: List[np.ndarray] = []
            all_i: List[np.ndarray] = []
            for lo in range(0, len(queries), cap):
                chunk = queries[lo : lo + cap]
                b = bucket_for(len(chunk), self.buckets)
                pad = b - len(chunk)
                padded = np.concatenate(
                    [chunk, np.zeros((pad, chunk.shape[1]), np.float32)]
                ) if pad else chunk
                if name in self.tier:
                    # exhaustive scans never fault the cache: stream the host
                    # master through the card in tiles instead (every rank
                    # holds the whole master: no collective, nothing sent)
                    s, i = self._topk_master(name, padded, k, normalize)
                else:
                    q = torch.from_numpy(np.ascontiguousarray(padded, np.float32))
                    with self._mesh_lock():
                        table = self._tables[name]
                        self._lead(mesh_serve.TOPK, (self._names.index(name), len(padded), k,
                                                     int(normalize), q.shape[1]), (q,))
                        s, i = topk_tiled(table, q.to(self.device), k=k,
                                          tile_rows=self.topk_tile_rows,
                                          normalize=normalize, mesh=self.mesh)
                    s, i = _host(s), _host(i)
                all_s.append(s[: len(chunk)])
                all_i.append(i[: len(chunk)])
                buckets_used.append(b)
                pad_total += pad
                self.registry.counter("serve.topk.queries").inc(len(chunk))
                self.registry.counter("serve.topk.pad_rows").inc(pad)
            s = np.concatenate(all_s)
            i = np.concatenate(all_i)
            kernel_ms = (time.perf_counter() - t_disp) * 1e3
            off = 0
            for req in reqs:
                req.t_dispatch = t_disp
                req.kernel_ms = kernel_ms
                req.pad_buckets = tuple(buckets_used)
                req.pad_rows = pad_total
                req.result = (s[off : off + req.n], i[off : off + req.n])
                off += req.n
                req.event.set()

    @torch.no_grad()
    def _score_impl(self, table: torch.Tensor, dense, feats: torch.Tensor) -> torch.Tensor:
        b, f = feats.shape
        mask = feats >= 0
        rows = self.scorer._rows(feats).reshape(-1)
        pulled = pull_rows(
            table, rows, mesh=self.mesh, comm_dtype=self.comm_dtype
        ).reshape(b, f, self.scorer.table_dim)
        return torch.sigmoid(self.scorer.forward(pulled, dense, mask))

    @torch.no_grad()
    def _score_tiered(self, feats: np.ndarray) -> np.ndarray:
        """Score through the cache tier: hash the fields on the host, fault
        the rows through the shared pull path, then run the forward pass on
        the gathered rows (padding fields hash like real rows but their
        values are mask-zeroed by ``forward``)."""
        from swiftsnails_tpu_torch.ops.hashing import hash_row_np

        b, f = feats.shape
        rows = hash_row_np(np.maximum(feats, 0), self.scorer.capacity).astype(np.int32)
        pulled = self._tier_pull(self.default_table, rows.reshape(-1)).reshape(
            b, f, self.scorer.table_dim)
        mask = torch.from_numpy(feats >= 0).to(self.device)
        return _host(torch.sigmoid(self.scorer.forward(pulled, self._dense, mask)))

    def _dispatch_score(self, batch: List[_Request]) -> None:
        self._maybe_fault("score")
        feats = np.concatenate([r.payload["feats"] for r in batch])
        t_disp = time.perf_counter()
        pad_total = 0
        buckets_used: List[int] = []
        cap = self.buckets[-1]
        outs: List[np.ndarray] = []
        for lo in range(0, len(feats), cap):
            chunk = feats[lo : lo + cap]
            b = bucket_for(len(chunk), self.buckets)
            pad = b - len(chunk)
            padded = np.concatenate(
                [chunk, np.full((pad, chunk.shape[1]), PAD_FIELD, np.int32)]
            ) if pad else chunk
            if self.default_table in self.tier:
                scores = self._score_tiered(padded)
            else:
                fe = torch.from_numpy(np.ascontiguousarray(padded, np.int32))
                with self._mesh_lock():
                    table, dense = self._tables[self.default_table], self._dense
                    self._lead(mesh_serve.SCORE, tuple(fe.shape), (fe,))
                    scores = _host(self._score_fn(table, dense, fe.to(self.device)))
            outs.append(scores[: len(chunk)])
            buckets_used.append(b)
            pad_total += pad
            self.registry.counter("serve.score.rows").inc(len(chunk))
            self.registry.counter("serve.score.pad_rows").inc(pad)
        scores = np.concatenate(outs)
        kernel_ms = (time.perf_counter() - t_disp) * 1e3
        off = 0
        for req in batch:
            req.t_dispatch = t_disp
            req.kernel_ms = kernel_ms
            req.pad_buckets = tuple(buckets_used)
            req.pad_rows = pad_total
            req.result = scores[off : off + req.n]
            off += req.n
            req.event.set()

    # -- request tracing ---------------------------------------------------

    def _trace_begin(self, kernel: str, **baggage):
        """Join the thread's active request context (a fleet leg carried one
        in), or mint a fresh trace when this servant fronts the request and
        a tracer is attached. Returns ``(ctx, owned)`` — only an owned
        context is finished here."""
        ctx = request_trace.current()
        if ctx is not None:
            return ctx, False
        rt = self.request_tracer
        if rt is None:
            return None, False
        try:
            return rt.start(kernel, **baggage), True
        except Exception:
            return None, False  # tracing never blocks the serve path

    def _trace_end(self, kernel: str, ctx, owned: bool, t0: float,
                   error: Optional[BaseException] = None) -> None:
        ms = (time.perf_counter() - t0) * 1e3
        if self.slo is not None:
            try:
                self.slo.record(kernel, ms, ok=error is None)
            except Exception:
                pass  # record-keeping never blocks the serve path
        if owned and ctx is not None and self.request_tracer is not None:
            try:
                self.request_tracer.finish(ctx, error=error)
            except Exception:
                pass

    @staticmethod
    def _trace_dispatch(ctx, req: _Request) -> None:
        """Turn the dispatcher-thread stamps on ``req`` into retroactive
        child spans: admission-queue wait, then batch kernel time with the
        pad buckets it rode in."""
        if ctx is None or not req.t_dispatch:
            return
        try:
            ctx.add_span("queue-wait", int(req.t0 * 1e9),
                         int((req.t_dispatch - req.t0) * 1e9))
            ctx.add_span("kernel", int(req.t_dispatch * 1e9),
                         int(req.kernel_ms * 1e6),
                         buckets=list(req.pad_buckets),
                         pad_rows=req.pad_rows)
        except Exception:
            pass  # tracing never blocks the serve path

    def _annotate_freshness(self, ctx) -> None:
        """Stamp the freshness the request is served at: the table version
        plus the delta-subscriber watermark (trainer step / age)."""
        fr = self._freshness
        if fr is None:
            return
        try:
            ctx.annotate(watermark_step=fr.applied_step,
                         watermark_age_ms=round(fr.last_lag_ms, 3))
        except Exception:
            pass

    # -- metrics -----------------------------------------------------------

    def _observe(self, kernel: str, t0: float, units: int, ctx=None) -> None:
        ms = (time.perf_counter() - t0) * 1e3
        self._latency[kernel].append(ms)
        # exemplar: only link traces that will actually be kept (sampled or
        # already anomalous) — a dropped trace id would dangle
        tid = ctx.trace_id if ctx is not None and \
            (ctx.sampled or ctx.anomalous) else None
        self.registry.histogram(f"serve.{kernel}.latency_ms").observe(
            ms, trace_id=tid)
        self.registry.counter(f"serve.{kernel}.requests").inc()

    def _on_breaker_transition(self, kernel: str, old: str, new: str,
                               snapshot: Dict) -> None:
        """Every breaker state change is observable: a counter bump plus a
        structured ``breaker`` ledger event (trip AND recovery)."""
        self.registry.counter(f"serve.{kernel}.breaker_{new}").inc()
        if self.ledger is not None:
            try:
                self.ledger.append("breaker", {
                    "source": "serving",
                    "kernel": kernel,
                    "from": old,
                    "to": new,
                    **{k: snapshot[k] for k in
                       ("consecutive_failures", "threshold", "trips",
                        "recoveries", "last_recovery_latency_ms")},
                })
            except Exception:
                pass  # record-keeping never blocks the serve path

    def _note_degraded(self, kernel: str, rows: int, reason: str) -> None:
        """Count a degraded (stale-LRU) serve — a separate ledger/metric
        stream from the fresh counters, rate-limited like overloads."""
        ctx = request_trace.current()
        if ctx is not None:
            ctx.mark_anomaly("degraded")
            ctx.annotate(degraded_reason=reason)
        self.registry.counter(f"serve.{kernel}.degraded").inc()
        self.registry.counter("serve.degraded_hits").inc(rows)
        total = int(self.registry.counter(f"serve.{kernel}.degraded").value)
        if self.ledger is not None and (total == 1 or total % 100 == 0):
            try:
                self.ledger.append("degraded", {
                    "source": "serving",
                    "kernel": kernel,
                    "reason": reason,
                    "rows": rows,
                    "degraded_total": total,
                })
            except Exception:
                pass

    def _note_shed(self, kernel: str) -> None:
        ctx = request_trace.current()
        if ctx is not None:
            ctx.mark_anomaly("shed")
        self.registry.counter(f"serve.{kernel}.shed").inc()
        self.registry.counter("serve.shed").inc()
        total = int(self.registry.counter("serve.shed").value)
        # rate-limited overload events: the first shed and every 100th after
        if self.ledger is not None and (total == 1 or total % 100 == 0):
            self._append_overload(kernel, total)

    def _append_overload(self, kernel: str, total: int) -> None:
        try:
            self.ledger.append("overload", {
                "source": "serving",
                "kernel": kernel,
                "shed_total": total,
                "queue_depth": self._batchers[kernel].queue_depth,
            })
            self._shed_events = total
        except Exception:
            pass  # record-keeping never blocks the serve path

    def _flush_overloads(self, final: bool = False) -> None:
        total = int(self.registry.counter("serve.shed").value)
        if final and self.ledger is not None and total > self._shed_events:
            self._append_overload("all", total)

    def shed_count(self) -> int:
        return int(self.registry.counter("serve.shed").value)

    def queue_depths(self) -> Dict[str, int]:
        """Per-kernel admission-queue depth right now — the introspection
        surface the fleet router (and the serve REPL's ``stats``) reads to
        decide when an owner replica is deep enough to spill past."""
        return {k: b.depth for k, b in self._batchers.items()}

    def reset_metrics(self) -> None:
        for d in self._latency.values():
            d.clear()
        self.cache.hits = 0
        self.cache.misses = 0

    def stats(self) -> Dict:
        kernels = {}
        for name, samples in self._latency.items():
            s = list(samples)
            kernels[name] = {
                "count": len(s),
                "mean_ms": round(float(np.mean(s)), 4) if s else 0.0,
                "p50_ms": round(_percentile(s, 0.50), 4),
                "p95_ms": round(_percentile(s, 0.95), 4),
                "p99_ms": round(_percentile(s, 0.99), 4),
            }
        reg = self.registry
        return {
            "version": self.version,
            "step": self.step,
            "tables": self._table_shapes(),
            "kernels": kernels,
            "cache": {
                "rows": len(self.cache),
                "capacity": self.cache.capacity,
                "hits": self.cache.hits,
                "misses": self.cache.misses,
                "hit_rate": round(self.cache.hit_rate, 4),
            },
            "shed": {
                k: int(reg.counter(f"serve.{k}.shed").value) for k in _KERNELS
            },
            "shed_total": self.shed_count(),
            "pad_rows": {
                k: int(reg.counter(f"serve.{k}.pad_rows").value) for k in _KERNELS
            },
            "breakers": {k: br.snapshot() for k, br in self.breakers.items()},
            "degraded": {
                "enabled": self.degraded_enabled,
                "hits": int(reg.counter("serve.degraded_hits").value),
                **{k: int(reg.counter(f"serve.{k}.degraded").value)
                   for k in _KERNELS},
            },
            "unavailable": {
                k: int(reg.counter(f"serve.{k}.unavailable").value)
                for k in _KERNELS
            },
            **({"tiered": {
                **self._tier_stats.as_dict(),
                "tables": {
                    name: {"budget_slots": tt.budget,
                           "master_units": tt.master.units}
                    for name, tt in self.tier.items()
                },
            }} if self.tier else {}),
            **({"trace": self.request_tracer.stats()}
               if self.request_tracer is not None else {}),
            **({"slo": self.slo.snapshot()} if self.slo is not None else {}),
        }

    def _table_shapes(self) -> Dict[str, List[int]]:
        """Each served table's whole shape (under a mesh, a resident
        table's shards together)."""
        model = 1
        if self.mesh is not None and not self.tier:
            model = self.mesh.axis_size(MODEL_AXIS)
        return {k: [v.shape[0] * model, *v.shape[1:]] for k, v in self._tables.items()}

    def health(self) -> Dict:
        """One-call liveness/availability report: overall ``status`` is
        ``"ok"`` when every breaker is closed, ``"degraded"`` otherwise —
        the Servant keeps answering in both cases, the caller just learns
        whether answers may be stale or shed."""
        reg = self.registry
        states = {k: br.state for k, br in self.breakers.items()}
        status = "ok" if all(s == CLOSED for s in states.values()) else "degraded"
        out = {
            "status": status,
            "version": self.version,
            "step": self.step,
            "tables": self._table_shapes(),
            "breakers": {k: br.snapshot() for k, br in self.breakers.items()},
            "degraded_enabled": self.degraded_enabled,
            "degraded_hits": int(reg.counter("serve.degraded_hits").value),
            "shed_total": self.shed_count(),
        }
        if self.tier:
            out["tier"] = {
                name: {"budget_slots": tt.budget,
                       "master_units": tt.master.units,
                       "resident": int((tt.unit_of >= 0).sum())}
                for name, tt in self.tier.items()
            }
        if self._freshness is not None:
            try:
                out["freshness"] = self._freshness.status()
            except Exception:
                pass  # introspection never blocks the health probe
        return out

    def attach_freshness(self, subscriber) -> None:
        """Surface a :class:`~swiftsnails_tpu_torch.freshness.subscriber.
        DeltaSubscriber`'s watermark/lag/fallback state through
        :meth:`health`."""
        self._freshness = subscriber


def _int_list(raw: str, default: Sequence[int]) -> Tuple[int, ...]:
    """Parse a ``serve_batch_buckets``-style comma list, e.g. ``8,64``."""
    raw = (raw or "").strip()
    if not raw:
        return tuple(default)
    return tuple(int(tok) for tok in raw.replace(",", " ").split())
