"""Trainer contract and the training loop (the JAX package's ``framework/trainer.py``).

Capability parity with the reference's worker framework
(``src/core/framework/SwiftWorker.h``):

* ``BaseAlgorithm`` (``SwiftWorker.h:19-57``) -> :class:`Trainer`:
  subclasses provide ``init_state`` / ``batches`` / ``train_step`` and the
  framework owns the loop;
* ``SwiftWorker::operator()`` (``SwiftWorker.h:88-124``) -> :class:`TrainLoop`:
  host prefetch thread, device feed, a per-step ``torch.Generator``,
  metrics windows; and, as in the JAX package, verified periodic
  checkpoints (``param_backup_period``, ``param_backup_root``,
  ``param_backup_keep``), resume (``resume: 1`` / ``auto``), the step
  guardrail (``guardrail: 1``), fault injection (``chaos_spec``) and the
  SIGTERM drain; and the telemetry: the run ledger (``ledger_path``), the
  span tracer, metric registry, black box, goodput block, continuous
  profiling and drift sentinel (``telemetry: 1`` / ``trace_path``, with
  ``telemetry_stdout``, ``blackbox_steps``, ``blackbox_dir``, ``goodput``,
  ``profile_cadence``, ``profile_window``, ``profile_export``,
  ``incident_dir``, ``drift_detect`` and ``drift_ewma_alpha`` /
  ``drift_cusum_k`` / ``drift_cusum_h`` / ``drift_warmup``), the
  ``torch.profiler`` window (``profile_dir``, ``profile_steps``), and the
  tiered store (``table_tier: host`` with the ``tier_*`` keys of
  :mod:`swiftsnails_tpu_torch.tiered.manager`): adopt after resume, stage
  on the prefetch thread, fault + remap before each step, the integrity
  sweep (``tier_verify_period``), synchronous saves of the masters, and
  the full-size master state at the end; and hot-row delta publishing to
  serving subscribers (``freshness_publish`` steps + ``freshness_dir``,
  with ``freshness_delta_dtype``, ``freshness_log_mb`` and
  ``freshness_listen``; see :mod:`swiftsnails_tpu_torch.freshness`); and
  cluster membership (``TrainLoop(cluster=...)`` or ``cluster_workers``:
  a range-leased batch stream, exactly-once commits at the step boundary
  and the committed watermarks in the checkpoint cursor; see
  :mod:`swiftsnails_tpu_torch.cluster`).

With telemetry on, the ``step`` span ends after the device's current
stream has synchronized, so it holds the step's device time; with it off
the loop never waits for the card inside a step.

Every loop key and table-plane key of the JAX package is ported.

Under a mesh (a trainer whose :attr:`Trainer.mesh` is set) every rank makes
the same global batch and feeds its part (:meth:`Trainer.local_batch`, the
JAX loop's data-sharded ``_device_batch``), so the data cursor is the same
on every rank. Checkpoints and resume work there: every rank saves and
restores its shards together (``framework/checkpoint.py``, synchronous
under a mesh), and a ``chaos_spec`` ``preempt@N`` drains every rank at
step N with a final save; a SIGTERM is each process's own, and only the
ranks it reaches drain. ``table_tier: host`` works there too: the tier
plans, faults and remaps the global batch before the rank's part is cut,
each rank holds the whole master in its host RAM and its model shard of
the cache, saves write the masters' rank rows (a resident save, file for
file), and the run returns this rank's shards of the masters on its
device (``TierManager.shard_state``). Under a mesh the loop adopts three layouts after
the resume and undoes them (``master_state``) before each save and at the
end of the run, so checkpoints and the returned state are an unsharded,
uniform run's: ``dense_tp: 1``'s model slices of the dense tensors
(:meth:`Trainer.dense_tp_manager`), ``placement: hybrid|auto``'s head/tail
split (:mod:`swiftsnails_tpu_torch.parallel.placement`) and
``optimizer_sharding: zero``'s ``1 / data`` slices of the optimizer planes
(:mod:`swiftsnails_tpu_torch.parallel.zero`); the run record carries the
``placement`` decision and the ``zero`` summary.

The loop's guards run under a mesh too, and each agrees over the mesh
before any rank acts (one small vote on the loop's thread,
:func:`~swiftsnails_tpu_torch.parallel.mesh.vote`; none on the prefetch
producer or the tier's flusher): the guardrail's trip and trust come from
the update norm of the global state and the count of non-finite losses,
voted (``resilience/guardrail.py``), so every rank rolls back, blends or
gives up at the same step; the tier's integrity sweep votes the corrupt
planes and every rank heals their union from the same verified save
(``TierManager.verify`` / ``heal``); freshness publishing gathers the
touched rows whole from the model shards and only the leader, the mesh's
origin, writes the delta log (``freshness/publisher.py``); with cluster
membership the leader holds the lease and broadcasts each step's batch
index, a follower rebuilding a batch it did not prefetch
(``cluster/worker.py``; an explicit ``cluster=`` is the leader's). The
guards' ledger events (chaos, heals, deltas and gaps, membership) are the
leader's, written once; each rank keeps its own run record.
"""

from __future__ import annotations

import contextlib
import functools
import queue
import signal
import sys
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from swiftsnails_tpu_torch.framework.checkpoint import save_checkpoint, wait_for_checkpoints
from swiftsnails_tpu_torch.ops.hashing import murmur_fmix64_int
from swiftsnails_tpu_torch.parallel.mesh import DATA_AXIS, broadcast_ints, is_leader
from swiftsnails_tpu_torch.resilience.chaos import ChaosPlan
from swiftsnails_tpu_torch.resilience.guardrail import GuardrailExhausted, StepGuardrail
from swiftsnails_tpu_torch.resilience.resume import resume_mode, resume_state
from swiftsnails_tpu_torch.resilience.retry import RetryingIterator, RetryPolicy
from swiftsnails_tpu_torch.telemetry.audit import audit_step
from swiftsnails_tpu_torch.telemetry.blackbox import BlackBox
from swiftsnails_tpu_torch.telemetry.drift import DriftSentinel, build_incident_bundle
from swiftsnails_tpu_torch.telemetry.goodput import (
    goodput_report,
    peaks_from_config,
    step_time_decomposition,
)
from swiftsnails_tpu_torch.telemetry.ledger import Ledger, config_hash, env_fingerprint
from swiftsnails_tpu_torch.telemetry.registry import MetricRegistry, StdoutSummarySink
from swiftsnails_tpu_torch.telemetry.timeseries import TimeSeriesStore
from swiftsnails_tpu_torch.telemetry.tracer import Tracer
from swiftsnails_tpu_torch.utils.config import Config
from swiftsnails_tpu_torch.utils.device import DeviceLike, resolve_device
from swiftsnails_tpu_torch.utils.metrics import MetricsLogger
from swiftsnails_tpu_torch.utils.profiling import StepProfiler, step_annotation


class Trainer:
    """Pluggable training algorithm (``BaseAlgorithm`` equivalent).

    Subclasses implement:

    * :meth:`init_state`  — build the model state on ``self.device``;
    * :meth:`batches`     — yield host batches (dicts of numpy arrays);
    * :meth:`train_step`  — ``(state, batch, generator) -> (state, metrics)``,
      with the batch's arrays already on the device;
    * :meth:`items_per_batch` — unit count for throughput metrics.

    :attr:`producer` names the batch producer (``native`` or ``python``);
    the loop puts it on its first metrics line.
    """

    name: str = "trainer"
    producer: Optional[str] = None
    # a parallel.mesh.Mesh the trainer trains under, or None: one device
    mesh = None

    def __init__(self, config: Config, device: DeviceLike = None):
        from swiftsnails_tpu_torch.parallel.zero import resolve_optimizer_sharding

        self.config = config
        self.device = resolve_device(device)
        # optimizer_sharding: zero -> the weight update of every plane the
        # data replicas hold alike, sharded over the data axis
        # (parallel/zero.py; a mesh's only)
        self.optimizer_sharding = resolve_optimizer_sharding(
            config.get_str("optimizer_sharding", "none"))

    # -- subclass API ------------------------------------------------------

    def init_state(self) -> Any:
        raise NotImplementedError

    def batches(self) -> Iterator[Dict[str, np.ndarray]]:
        raise NotImplementedError

    def train_step(self, state: Any, batch: Dict[str, Any],
                   generator: torch.Generator) -> Tuple[Any, Dict[str, Any]]:
        raise NotImplementedError

    def items_per_batch(self, batch: Dict[str, np.ndarray]) -> int:
        first = next(iter(batch.values()))
        return int(first.shape[0])

    def substeps_of(self, batch: Dict[str, np.ndarray]) -> int:
        """Substeps a ``train_step`` call makes of ``batch`` (1 unless the
        trainer slices a call into several)."""
        return 1

    def local_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """This rank's part of a host batch under :attr:`mesh` (the JAX
        loop's ``_device_batch``): every rank makes the same global batch,
        and an array whose leading dimension splits over the ``data`` axis
        keeps this rank's contiguous slice of each of the
        :meth:`substeps_of` substeps, in order (as the JAX step's reshape
        of a data-sharded batch gives each substep's shard); scalars and
        arrays that do not split stay whole. The batch itself without a
        data axis."""
        data = self.mesh.axis_size(DATA_AXIS) if self.mesh is not None else 1
        if data == 1:
            return batch
        t = self.substeps_of(batch)
        i = self.mesh.axis_index(DATA_AXIS)

        def part(v):
            if not np.ndim(v) or np.shape(v)[0] % (t * data):
                return v
            v = np.asarray(v)
            return v.reshape(t, data, -1, *v.shape[1:])[:, i].reshape(-1, *v.shape[1:])

        return {k: part(v) for k, v in batch.items()}

    # -- optional hooks ----------------------------------------------------

    def export_text(self, state: Any, path: str) -> None:
        """Final param export (ServerTerminate parity). Optional."""

    def eval_metrics(self, state: Any) -> Dict[str, float]:
        return {}

    # -- tiered-store hooks (table_tier: host; see swiftsnails_tpu_torch/tiered)

    def tier_spec(self) -> Optional[Dict[str, Dict]]:
        """``{table_name: {"layout": dense|packed|packed_small, "group": G}}``
        for trainers that support the host tier; ``None`` (default) means
        ``table_tier: host`` is rejected for this trainer."""
        return None

    def tier_tables(self, state: Any) -> Dict[str, Any]:
        """The tierable table states of ``state``, keyed as
        :meth:`tier_spec`."""
        raise NotImplementedError

    def tier_with_tables(self, state: Any, tables: Dict[str, Any]) -> Any:
        """``state`` with (some) table states replaced."""
        raise NotImplementedError

    def tier_plan(self, batch: Dict[str, np.ndarray], seed: int, step: int):
        """Host-side plan for one step: ``(ids, aug, remap_keys)`` where
        ``ids[name]`` is every master row id the step will touch in that
        table (hashing applied), ``aug`` holds batch keys to add or replace
        (the hashed ids, and the negatives the step would draw: the draws of
        :func:`step_generator` ``(seed, step, self.device)`` in the step's
        order, so the plan is exact, not a guess), and ``remap_keys[name]``
        lists the batch keys to remap into cache-slot space. Runs on the
        prefetch producer thread."""
        raise NotImplementedError

    def tier_warm_rows(self) -> Optional[Dict[str, np.ndarray]]:
        """Hottest-first master row ids per table for the pre-step-0 cache
        prewarm (from corpus frequency ranks); ``None`` to skip."""
        return None

    def table_geometry(self) -> Optional[Dict[str, Dict]]:
        """``{table: {"layout", "group", "dim", "capacity"}}`` for the
        freshness publisher — :meth:`tier_spec`'s layout map WITHOUT the
        ``table_tier`` gate (resident runs publish too) plus the logical
        row geometry. ``None`` (default) disables delta publishing."""
        return None

    # -- hybrid placement (placement: hybrid|auto; parallel/hybrid.py) -----

    def placement_spec(self) -> Optional[Dict[str, Dict]]:
        """``{table_name: {"cut": K, "group": G}}``, the head/tail split of
        each table (names as :meth:`tier_tables`'); ``None`` or empty:
        uniform placement, and the loop pays nothing."""
        return None

    # -- ZeRO (optimizer_sharding: zero; parallel/zero.py) ------------------

    def zero_planes(self, state: Any) -> Any:
        """The dense optimizer planes of ``state`` (a dict of tensors) whose
        shardable ones ``ZeroManager`` shards over the data axis; ``None``
        (default): the trainer has none (a hybrid head's slot planes are
        found through :meth:`tier_tables`)."""
        return None

    def zero_with_planes(self, state: Any, planes: Any) -> Any:
        """``state`` with its optimizer planes replaced."""
        return state

    # -- the tensor-parallel dense side (dense_tp: 1) ---------------------

    def dense_tp_manager(self):
        """An object with ``adopt`` / ``master_state`` that cuts the dense
        tensors into this rank's ``model`` slices after init and restore,
        and gathers them whole for checkpoints and the end of a run;
        ``None`` (default): the dense side is whole on every rank."""
        return None

    def step_cost(self, batch: Dict[str, np.ndarray]) -> Optional[Dict]:
        """One step's work on ``batch`` (a host batch), for the goodput
        block: ``{"cost": {"flops", "bytes_accessed"}, "total_bytes": None,
        "source": "analytic"}`` — the dict the JAX package's HLO audit gives
        ``goodput_report``, counted here from the batch: the least bytes (each
        distinct table row read and written once, the batch read once) and
        the f32 flops. ``None`` where the trainer defines no count: the
        report then carries ``None``, never a guess."""
        return None


def mesh_device(mesh, device: DeviceLike = None) -> torch.device:
    """The device of a trainer under ``mesh``: the mesh's, which ``device``
    (if given) must match in type. Raises ``TypeError`` for a ``mesh`` that
    is not a :class:`~swiftsnails_tpu_torch.parallel.mesh.Mesh`."""
    from swiftsnails_tpu_torch.parallel.mesh import Mesh

    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.mesh.Mesh, got {type(mesh)}")
    if device is not None and resolve_device(device).type != mesh.device.type:
        raise ValueError(f"trainer on {device}, mesh on {mesh.device}")
    return mesh.device


class _Prefetcher:
    """Bounded background-thread batch prefetch (``queue_with_capacity``
    parity, ``src/utils/queue.h:100-108``): the producer thread runs the
    trainer's host-side sampling while the device computes. Producer errors
    re-raise on the consumer side."""

    _DONE = object()

    def __init__(self, it: Iterator, depth: int = 2):
        self._it = it
        self._q: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        self._exhausted = False
        self.last_wait_ns = 0  # consumer block on the last __next__

        def produce():
            try:
                for item in it:
                    while not self._stop.is_set():
                        try:
                            self._q.put(item, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if self._stop.is_set():
                        return
            except BaseException as e:  # surfaced in __next__
                self._err = e
            finally:
                # never strand this thread on a full queue after close()
                while True:
                    try:
                        self._q.put(self._DONE, timeout=0.1)
                        break
                    except queue.Full:
                        if self._stop.is_set():
                            break

        self._thread = threading.Thread(target=produce, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        if self._exhausted:
            if self._err is not None:
                raise self._err
            raise StopIteration
        t0 = time.perf_counter_ns()
        item = self._q.get()
        self.last_wait_ns = time.perf_counter_ns() - t0
        if item is self._DONE:
            self._exhausted = True
            self._thread.join()
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def qsize(self) -> int:
        """Approximate queued-batch count (telemetry gauge: a persistently
        empty queue means the host pipeline is the bottleneck)."""
        return self._q.qsize()

    def set_depth(self, depth: int) -> None:
        """Grow (or shrink) the queue bound in place — the adaptive
        ``tier_prefetch_depth: auto`` control. ``queue.Queue`` guards
        ``maxsize`` with its own mutex; waking ``not_full`` lets a producer
        blocked on the old bound use the new headroom at once."""
        q = self._q
        with q.mutex:
            q.maxsize = max(int(depth), 1)
            q.not_full.notify_all()

    def close(self):
        self._stop.set()
        # drain so the producer's pending put unblocks promptly, then reap it
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)
        if not self._thread.is_alive():
            _close_source(self._it)


def _close_source(it) -> None:
    """Close a batch source that holds producers (a generator's ``finally``
    closes the native prefetcher's threads)."""
    close = getattr(it, "close", None)
    if close is not None:
        close()


def step_generator(seed: int, step: int, device: torch.device) -> torch.Generator:
    """The step's random stream: a generator on ``device`` seeded from
    ``(seed, step)`` through the murmur finalizer — the counterpart of the
    JAX loop's ``fold_in(root_rng, step)``."""
    gen = torch.Generator(device=device)
    mixed = murmur_fmix64_int(((seed & 0xFFFFFFFF) << 32) | (step & 0xFFFFFFFF))
    gen.manual_seed(mixed & ((1 << 63) - 1))
    return gen


_STREAM_END = object()
_NO_ANNOTATION = contextlib.nullcontext()


class TrainLoop:
    """The training loop: prefetch, device feed, per-step generator, metrics,
    checkpoints, resume, guardrail, fault injection, the SIGTERM drain and,
    when asked for, the run ledger and telemetry."""

    def __init__(
        self,
        trainer: Trainer,
        metrics: Optional[MetricsLogger] = None,
        log_every: int = 100,
        device: DeviceLike = None,
        cluster=None,
    ):
        """``device=None`` feeds the trainer's device (itself the card unless
        the trainer was asked for the CPU); a device of another type raises.
        ``cluster``: a :class:`~swiftsnails_tpu_torch.cluster.WorkerClient`
        whose leased stream the loop consumes; under a mesh the leader's
        alone (another rank given one raises ``ValueError``)."""
        cfg = trainer.config
        if device is not None and resolve_device(device).type != trainer.device.type:
            raise ValueError(f"TrainLoop on {device}, trainer on {trainer.device}")
        # under a mesh the origin leads: it writes the ledger and holds the
        # cluster lease (module docstring); without one the loop leads itself
        self.leader = is_leader(trainer.mesh)
        if cluster is not None and not self.leader:
            raise ValueError("cluster= is the leader's (the mesh's origin): another rank "
                             "follows the leader's leased stream and takes none")
        self.trainer = trainer
        self.metrics = metrics or MetricsLogger(echo=False)
        self.log_every = log_every
        self.device = trainer.device
        self.backup_period = cfg.get_int("param_backup_period", 0)
        self.backup_root = cfg.get_str("param_backup_root", "")
        self.backup_keep = cfg.get_int("param_backup_keep", 3)
        self.config_hash = config_hash(cfg.as_dict())
        # the ledger rides with any ledger_path (resilience events need it
        # even when the full telemetry stack is off); tracer/registry/black
        # box stay telemetry-gated below
        ledger_path = cfg.get_str("ledger_path", "")
        self.ledger = Ledger(ledger_path) if ledger_path else None
        # the guards' events (chaos, membership, deltas and gaps, tier
        # heals) are the mesh's, agreed by every rank: the leader writes
        # them, once; a rank's own events (its run record, its retries)
        # stay its own
        guard_ledger = self.ledger if self.leader else None
        self._restored_step: Optional[int] = None  # set by resume; never pruned
        self._items_seen = 0
        # cluster membership: an explicit WorkerClient wins (tests, a shared
        # in-process supervisor); `cluster_workers: N` self-hosts one, so the
        # run still gets range-leased streams, exactly-once accounting and a
        # watermark-carrying checkpoint cursor (see cluster/)
        self.cluster = cluster
        self._followed = None  # a follower's FollowedStream under a mesh (run())
        self._committed: List[int] = []  # a follower's restored committed indices
        if self.cluster is None and self.leader and cfg.get_int("cluster_workers", 0) > 0:
            from swiftsnails_tpu_torch.cluster import Supervisor, WorkerClient

            sup = Supervisor.from_config(cfg, ledger=guard_ledger)
            self.cluster = WorkerClient(sup, cfg.get_str("cluster_worker_id", "w0"))
        self.checkpoint_fn = None
        if self.backup_root:
            # async periodic saves: training continues while the writer
            # thread CRCs and writes; the manifest (step, config hash, CRCs,
            # data cursor) commits when the files are down
            ckpt_retry = RetryPolicy.from_config(cfg, ledger=self.ledger)

            def checkpoint_fn(state, step):
                cursor = {"step": step, "items": self._items_seen}
                if self.cluster is not None:
                    # committed watermarks ride the data cursor, so resume
                    # restores exactly-once accounting across reassignment
                    cursor["cluster"] = self.cluster.cursor()
                save_checkpoint(
                    self.backup_root, state, step, wait=False,
                    cursor=cursor,
                    config_hash=self.config_hash, keep=self.backup_keep,
                    protect=self._restored_step, retry=ckpt_retry, ledger=self.ledger,
                    tier=self.tier, mesh=trainer.mesh, placement=self.placement,
                    zero=self.zero, dense_tp=self.dense_tp)

            self.checkpoint_fn = checkpoint_fn
        # the layouts a meshed state takes between adopt (after resume) and
        # master_state (saves, the end of the run), each None where
        # inactive: dense_tp: 1's model slices of the dense tensors;
        # placement: hybrid|auto's head/tail split (parallel/placement.py:
        # the zipf head replicated, the tail model-sharded; uniform, no mesh,
        # or a zero cut -> None); optimizer_sharding: zero's 1/data slices of
        # the optimizer planes (parallel/zero.py)
        from swiftsnails_tpu_torch.parallel.placement import PlacementManager
        from swiftsnails_tpu_torch.parallel.zero import ZeroManager

        self.dense_tp = trainer.dense_tp_manager()
        pm = PlacementManager(trainer, trainer.mesh)
        self.placement = pm if pm.active else None
        zm = ZeroManager(trainer, trainer.mesh)
        self.zero = zm if zm.active else None
        # the layouts that split tensors besides the table states, for the
        # guardrail's count of the global state under a mesh
        self._layouts = tuple(lay for lay in (self.zero, self.dense_tp) if lay is not None)
        self.profiler = StepProfiler(cfg, self.device)
        # resilience is opt-in per key; off, the step pays flag checks only
        self.guardrail = None
        if cfg.get_bool("guardrail", False):
            self.guardrail = StepGuardrail(
                max_update_norm=cfg.get_float("guard_max_update_norm", 0.0),
                max_consecutive=cfg.get_int("guard_max_consecutive", 3),
                mesh=trainer.mesh)
        self.chaos = ChaosPlan.from_config(cfg, ledger=guard_ledger)
        self._preempt = threading.Event()
        self._preempt_reason: Optional[str] = None
        self.preempted = False
        self._prev_sigterm = None
        # telemetry is opt-in (`telemetry: 1` or a `trace_path`); when off,
        # tracer/registry/black box stay None and run() takes the
        # uninstrumented branch
        self.trace_path = cfg.get_str("trace_path", "")
        self.tracer = self.registry = self.blackbox = None
        self.timeseries = self.drift = None
        self._want_cost = False
        self.profile_cadence = 0
        self.incident_dir = ""
        if cfg.get_bool("telemetry", False) or self.trace_path:
            self._init_telemetry(cfg)
        self.incidents: List[str] = []
        self._incident_reasons: set = set()
        self._profile_event_idx = 0
        self._profile_pending_loss = None
        self._step_cost: Optional[Dict] = None
        # under a mesh, the first step's collective bytes by scope (the JAX
        # loop's audit by_scope), for the run record's comm_by_scope
        self._comm_by_scope: Optional[Dict[str, int]] = None
        self._comm_total: Optional[int] = None
        # table_tier: host -> the tiered parameter store (tiered/): full-size
        # masters in host RAM, fixed-budget cache planes on the card in the
        # state, a per-step fault + id remap before the step. `device`
        # (default) keeps the resident tables and pays nothing.
        table_tier = cfg.get_str("table_tier", "device")
        if table_tier not in ("device", "host"):
            raise ValueError(f"table_tier must be device|host, got {table_tier!r}")
        self.tier = None
        if table_tier == "host":
            from swiftsnails_tpu_torch.tiered import TierManager

            self.tier = TierManager(trainer, registry=self.registry, tracer=self.tracer)
        # tier integrity sweep cadence (steps; 0 = only at heal requests).
        # Runs on the resilient path only — like chaos and the guardrail,
        # arming it costs the plain hot path nothing.
        self.tier_verify_period = cfg.get_int("tier_verify_period", 0)
        # freshness_publish: N steps + freshness_dir -> hot-row delta
        # publishing to serving subscribers (freshness/). Off (the default)
        # => None and the hot path pays one flag check.
        self.freshness = None
        if (cfg.get_int("freshness_publish", 0) > 0
                and cfg.get_str("freshness_dir", "")):
            from swiftsnails_tpu_torch.freshness.publisher import TrainPublisher

            fresh = TrainPublisher(trainer, tier=self.tier, placement=self.placement,
                                   ledger=guard_ledger)
            self.freshness = fresh if fresh.active else None

    def _init_telemetry(self, cfg: Config) -> None:
        """The tracer, registry, black box, continuous profiler and drift
        sentinel, as the JAX loop builds them from its keys."""
        trainer = self.trainer
        context = {"model": trainer.name, "config_hash": self.config_hash}
        self.tracer = Tracer(path=self.trace_path or None,
                             nvtx=self.device.type == "cuda")
        sinks = [self.metrics]
        if cfg.get_bool("telemetry_stdout", False):
            sinks.append(StdoutSummarySink())
        self.registry = MetricRegistry(sinks=sinks)
        bb_steps = cfg.get_int("blackbox_steps", 32)
        if bb_steps > 0:
            self.blackbox = BlackBox(
                capacity=bb_steps, directory=cfg.get_str("blackbox_dir", "blackbox"),
                ledger=self.ledger, context=context)
        # goodput needs the step's FLOP and byte counts (Trainer.step_cost,
        # taken once from the first batch); gateable on its own
        self._want_cost = cfg.get_bool("goodput", True)
        # continuous profiling: a bounded ring of periodic metric samples
        # (`profile_cadence` steps, 0 = off) — the registry snapshot plus the
        # per-window goodput decomposition; exportable as JSONL and
        # summarized into the run record for sparklines
        self.profile_cadence = cfg.get_int("profile_cadence", 0)
        if self.profile_cadence > 0:
            self.timeseries = TimeSeriesStore(window=cfg.get_int("profile_window", 512))
        # drift sentinel: EWMA/CUSUM detectors over the sampled signals; a
        # confirmed drift appends one transition-edged `drift` ledger event
        # and captures an incident bundle under `incident_dir`
        if cfg.get_bool("drift_detect", False):
            self.drift = DriftSentinel(
                alpha=cfg.get_float("drift_ewma_alpha", 0.3),
                k=cfg.get_float("drift_cusum_k", 1.0),
                h=cfg.get_float("drift_cusum_h", 6.0),
                warmup=cfg.get_int("drift_warmup", 8),
                ledger=self.ledger, context=context)
        self.incident_dir = cfg.get_str("incident_dir", "incidents")

    def _device_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, Any]:
        """Arrays go to the device; scalars (e.g. ``progress``) stay on the
        host, where the learning-rate schedule reads them. Under a mesh
        this rank's part goes (:meth:`Trainer.local_batch`)."""
        batch = self.trainer.local_batch(batch)
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                if np.ndim(v) else v for k, v in batch.items()}

    def _resume(self, state, clustered: bool = False) -> Tuple[Any, int, int]:
        """``resume: 1`` / ``auto``: the restored state, its step, and the
        batches to skip (``auto`` only: the manifest's cursor; none for a
        ``clustered`` run, which restores the committed watermarks)."""
        mode = resume_mode(self.trainer.config)
        if mode == "off" or not self.backup_root:
            return state, 0, 0
        t0 = time.perf_counter()
        restored = resume_state(self.backup_root, state, mode=mode, ledger=self.ledger,
                                config_hash=self.config_hash,
                                on_reject=self._on_resume_reject, mesh=self.trainer.mesh)
        seconds = time.perf_counter() - t0
        if restored is None:
            return state, 0, 0
        # continue the step counter so later checkpoints advance and the
        # per-step random stream does not replay
        state, step, cursor = restored
        self._restored_step = step
        skip = 0
        if mode == "auto":
            # the batch generators are seed-deterministic, so skipping the
            # consumed prefix IS the saved cursor
            skip = int(cursor.get("step", step) or 0)
            self._items_seen = int(cursor.get("items", 0) or 0)
            if self.cluster is not None:
                # restore the committed watermarks in place of a flat skip:
                # the leased stream's first-writer-wins claims skip exactly
                # the committed indices, so a run that adopted a reassigned
                # (out-of-order) span replays bit-identically
                self.cluster.restore(cursor.get("cluster") or {})
                skip = 0
            elif clustered:
                # a follower prefetches past the committed indices, as the
                # leader's restored lease will take them
                from swiftsnails_tpu_torch.cluster import expand_ranges

                self._committed = expand_ranges((cursor.get("cluster") or {}).get("committed"))
                skip = 0
        print(f"resume: restored step {step} from {self.backup_root} in {seconds:.4f} s; "
              f"skipping {skip} batches", file=sys.stderr)
        return state, step, skip

    def run(self, seed: int = 0, max_steps: Optional[int] = None) -> Any:
        """Train until the data ends, ``max_steps`` (counted from step 0,
        so a resumed run stops where the uninterrupted one would) or a
        preemption; returns the state. On every way out, a normal end, a
        preemption or an exception, the tier's flush worker is stopped
        (``TierManager.stop``); the JAX loop leaves it running."""
        try:
            return self._run(seed, max_steps)
        finally:
            if self.tier is not None:
                self.tier.stop()

    def _run(self, seed: int, max_steps: Optional[int]) -> Any:
        trainer = self.trainer
        mesh = trainer.mesh
        clustered = self.cluster is not None
        if mesh is not None:
            # the leader's lease (its cluster= or cluster_workers) decides
            # for every rank whether the stream is leased
            clustered = bool(broadcast_ints(mesh, [int(clustered)], 1)[0])
        state, step, skip_batches = self._resume(trainer.init_state(), clustered)
        last_metrics: Dict[str, Any] = {}
        total_items = 0
        tier = self.tier
        if tier is not None:
            # full-size device planes -> host masters + cache planes on the
            # card (prewarmed with the vocab's hottest rows); from here on
            # `state` carries the small cache planes until master_state() at
            # the end, and the full-size planes are freed
            state = tier.adopt(state)
        if self.dense_tp is not None:
            # whole dense tensors -> this rank's model slices
            state = self.dense_tp.adopt(state)
        if self.placement is not None:
            # uniform layout -> head/tail planes; after the resume, so a
            # uniform checkpoint restores into a hybrid run
            state = self.placement.adopt(state)
        if self.zero is not None:
            # whole optimizer planes -> this rank's 1/data slices; after the
            # split, so the head's slot planes exist to shard
            state = self.zero.adopt(state)
        fresh = self.freshness
        if fresh is not None:
            # one publisher incarnation per run, based on the resumed step;
            # under table_tier: host this also installs the flush tee (so it
            # must run AFTER tier.adopt built the tables)
            fresh.open(base_step=step)
        depth = trainer.config.get_int("prefetch_batches", 2)
        cl = self.cluster
        if cl is not None:
            # range-leased stream: indices are claimed (first-writer-wins)
            # as they are yielded and committed at the step boundary below;
            # under a mesh each batch carries its index for the followers
            src = iter(cl.leased_stream(trainer.batches, tag=mesh is not None))
        elif clustered:
            from swiftsnails_tpu_torch.cluster import FollowedStream

            self._followed = src = FollowedStream(trainer.batches, self._committed)
        else:
            src = iter(trainer.batches())
        if tier is not None:
            # stage upcoming steps' plans + missing master rows on the
            # producer thread so the H2D fault traffic overlaps the step. A
            # fully transparent tier stages nothing — keep the trainer's own
            # prefetch setting then
            src = tier.stage_stream(src, seed)
            if not tier.all_transparent:
                depth = tier.prefetch_depth
        batches = _Prefetcher(src, depth=depth) if depth else src
        if tier is not None and isinstance(batches, _Prefetcher):
            tier.attach_prefetcher(batches)  # tier_prefetch_depth: auto
        tel = self.tracer
        reg = self.registry
        bb = self.blackbox
        chaos = self.chaos
        prof = self.profiler
        cuda = self.device.type == "cuda"
        resilient = (self.guardrail is not None or chaos is not None
                     or (tier is not None and self.tier_verify_period > 0))
        # the first metrics line names the producer, so no run hides its route
        first_line = {"producer": trainer.producer} if trainer.producer else {}
        it = iter(batches)
        if chaos is not None:
            it = chaos.wrap_stream(it)
        if resilient:
            # transient OSError (a flaky filesystem, chaos io_error) is
            # retried under the shared policy before it propagates; an
            # exhausted budget is a retry_exhausted ledger event
            it = RetryingIterator(
                it, RetryPolicy.from_config(trainer.config, ledger=self.ledger),
                on_error=self._on_stream_error, op="data_stream")
        if mesh is not None and clustered:
            it = self._agreed(it)
        self._install_sigterm()
        preempted = self._preempt.is_set
        try:
            for _ in range(skip_batches):
                if next(it, _STREAM_END) is _STREAM_END:
                    break
            # hot-path contract: with telemetry off each step pays the flag
            # checks below; the instrumented body never runs
            if tel is None:
                for batch in it:
                    if preempted():
                        break
                    n_items = trainer.items_per_batch(batch)
                    prof.on_step(step)
                    if fresh is not None:
                        # record touched rows BEFORE tier.prepare remaps the
                        # batch ids to slot space (resident/transparent path)
                        fresh.on_batch(batch, seed, step)
                    if chaos is not None:
                        chaos.maybe_slow_step(step)  # a host stall before dispatch
                    with (step_annotation(trainer.name, step) if prof.enabled
                          else _NO_ANNOTATION):
                        if tier is not None:
                            # fault the rows this step touches into the cache
                            # and remap batch ids to slot space; runs BEFORE
                            # any snapshot/injection so a rollback targets a
                            # slot-map-consistent state
                            state, batch = tier.prepare(state, batch, seed, step)
                        dev_batch = self._device_batch(batch)
                        gen = step_generator(seed, step, self.device)
                        if resilient:
                            state, last_metrics = self._resilient_step(
                                state, dev_batch, gen, step)
                        else:
                            state, last_metrics = trainer.train_step(state, dev_batch, gen)
                    step += 1
                    self._items_seen += n_items
                    if cl is not None:
                        # commit the applied batch, renew the membership
                        # lease, adopt reassigned spans: BEFORE a checkpoint
                        # below, so the cursor sees this commit
                        cl.on_step(step)
                    self.metrics.count(n_items)
                    if self.log_every and step % self.log_every == 0:
                        host = {k: float(v) for k, v in last_metrics.items()}
                        self.metrics.flush_window(step=step, **host, **first_line)
                        first_line = {}
                    if self.backup_period and self.checkpoint_fn and step % self.backup_period == 0:
                        self.checkpoint_fn(state, step)
                    if fresh is not None:
                        fresh.maybe_publish(state, step)
                    if max_steps is not None and step >= max_steps:
                        break
            else:
                while True:
                    if preempted():
                        break
                    t_step0 = time.monotonic()
                    with tel.span("prefetch-wait"):
                        try:
                            batch = next(it)
                        except StopIteration:
                            break
                    n_items = trainer.items_per_batch(batch)
                    prof.on_step(step)
                    if isinstance(batches, _Prefetcher):
                        q_depth = batches.qsize()
                        reg.gauge("prefetch_queue_depth").set(q_depth)
                        tel.counter("prefetch_queue_depth", q_depth)
                    if fresh is not None:
                        fresh.on_batch(batch, seed, step)
                    if chaos is not None and chaos.scheduled("slow_step", step):
                        # the injected host stall runs OUTSIDE the step span,
                        # inside its own bucketed span, so the decomposition
                        # attributes it to host_blocked_s like a real stall
                        with tel.span("chaos-slow", step=step):
                            chaos.maybe_slow_step(step)
                    # step_span opens record_function (and NVTX on the
                    # card), so a concurrent profile_dir capture lines the
                    # kernels up with these host spans by step number
                    with tel.step_span(trainer.name, step):
                        if tier is not None:
                            with tel.span("tier-fault", step=step):
                                state, batch = tier.prepare(state, batch, seed, step)
                        with tel.span("h2d"):
                            dev_batch = self._device_batch(batch)
                        if self._want_cost and self._step_cost is None:
                            self._step_cost = self._count_step(batch)
                        with tel.span("step", step=step):
                            gen = step_generator(seed, step, self.device)
                            if resilient:
                                run = functools.partial(self._resilient_step, state,
                                                        dev_batch, gen, step)
                            else:
                                run = functools.partial(trainer.train_step, state,
                                                        dev_batch, gen)
                            if trainer.mesh is not None and self._comm_by_scope is None:
                                report = audit_step(run)
                                self._comm_by_scope = report["by_scope"]
                                self._comm_total = report["total_bytes"]
                                state, last_metrics = report["result"]
                            else:
                                state, last_metrics = run()
                            if cuda:
                                # the span holds the step's device time, not
                                # only its enqueue (the JAX span's "jitted
                                # dispatch + device sync")
                                torch.cuda.current_stream(self.device).synchronize()
                    step += 1
                    total_items += n_items
                    self._items_seen += n_items
                    if cl is not None:
                        cl.on_step(step)
                    reg.counter("steps").inc()
                    reg.counter("items").inc(n_items)
                    step_ms = (time.monotonic() - t_step0) * 1e3
                    reg.histogram("step_ms").observe(step_ms)
                    if bb is not None:
                        bb.record_step(step, step_ms=step_ms, items=n_items)
                    if self.timeseries is not None and step % self.profile_cadence == 0:
                        self._profile_sample(step, step_ms, last_metrics)
                    self.metrics.count(n_items)
                    if self.log_every and step % self.log_every == 0:
                        with tel.span("metrics-flush"):
                            host = {k: float(v) for k, v in last_metrics.items()}
                            self.metrics.flush_window(step=step, **host, **first_line)
                            first_line = {}
                            reg.flush(step=step)
                            if bb is not None:
                                bb.record_metrics(step, host)
                                if bb.nonfinite(host):
                                    bb.dump("nan-loss", tracer=tel)
                                    self._incident("nan-loss")
                    if self.backup_period and self.checkpoint_fn and step % self.backup_period == 0:
                        with tel.span("checkpoint", step=step):
                            self.checkpoint_fn(state, step)
                    if fresh is not None:
                        fresh.maybe_publish(state, step)
                    if max_steps is not None and step >= max_steps:
                        break
        except BaseException as e:
            # the flight-recorder moment: a failing run must leave a
            # post-mortem artifact (ring of recent steps + spans) behind
            if bb is not None:
                bb.dump("exception", exc=e, tracer=tel)
            if fresh is not None:
                fresh.close()  # the TCP stream server must not outlive the run
            raise
        finally:
            # an open capture or trace must be finalized even on error
            prof.close(step)
            if isinstance(batches, _Prefetcher):
                batches.close()
            else:
                _close_source(src)
            if tel is not None:
                tel.close()
            self._uninstall_sigterm()
            # an async save must never be orphaned by an exception
            if self.checkpoint_fn is not None:
                self._join_checkpoints()
        if cuda:
            torch.cuda.synchronize(self.device)
        if self._preempt.is_set():
            # the drain: a final save and a durable outage record, then a
            # normal return; the next run's `resume: auto` continues from it
            self.preempted = True
            if self.checkpoint_fn is not None:
                try:
                    self.checkpoint_fn(state, step)
                except Exception as e:
                    self._ledger_event("cache_error", {
                        "source": "checkpoint",
                        "error": f"preemption final save failed: {e}",
                    })
                self._join_checkpoints()
            self._ledger_event("outage", {
                "probe": "preemption",
                "reason": self._preempt_reason or "SIGTERM",
                "step": step,
                "error": "run preempted; drained with a final checkpoint",
            })
            print(f"preemption ({self._preempt_reason}): drained at step {step}",
                  file=sys.stderr)
        if fresh is not None:
            # last delta before the caller materializes/abandons the state,
            # so subscribers reach the final training watermark without
            # waiting for a full checkpoint cycle
            fresh.maybe_publish(state, step, force=True)
            fresh.close()
        if tier is not None:
            # end-of-run write-back: flush every dirty cache slot and hand
            # the caller the full-size master-backed state (the resident
            # state's type, shapes and dtypes, on the host: export and eval
            # route by the tables' device); under a mesh this rank's shards
            # of it on its device, as a resident meshed run holds them
            state = tier.master_state(state)
            if trainer.mesh is not None:
                state = tier.shard_state(state, device=trainer.device)
        # the layouts undone in reverse: the caller (export, eval, serving)
        # sees the state an unsharded, uniform run returns
        for layout in (self.zero, self.placement, self.dense_tp):
            if layout is not None:
                state = layout.master_state(state)
        host = {}
        if step % max(self.log_every, 1) != 0 or not self.log_every:
            host = {k: float(v) for k, v in last_metrics.items()}
            self.metrics.flush_window(step=step, **host, **first_line)
        elif bb is not None and last_metrics:
            host = {k: float(v) for k, v in last_metrics.items()}
        if bb is not None and host:
            bb.record_metrics(step, host)
            if bb.nonfinite(host):
                bb.dump("nan-loss", tracer=tel)
                self._incident("nan-loss")
        if reg is not None:
            reg.flush(step=step, final=1)
        if tel is not None:
            self._finalize_run_record(step, total_items, host)
        return state

    def _agreed(self, it: Iterator) -> Iterator:
        """Under a mesh with cluster membership: each step's batch, its
        index agreed on the loop's thread. The leader broadcasts the index
        of the batch its lease gave (-1 when its stream ended); a follower
        takes its prefetched batch when that is the index, else builds the
        index's batch itself (a reassigned span)."""
        from swiftsnails_tpu_torch.cluster import INDEX_KEY

        mesh = self.trainer.mesh
        while True:
            if self.leader:
                batch = next(it, _STREAM_END)
                index = -1 if batch is _STREAM_END else int(batch[INDEX_KEY])
                broadcast_ints(mesh, [index], 1)
            else:
                index = broadcast_ints(mesh, [0], 1)[0]
                if index >= 0:
                    batch = next(it, _STREAM_END)
                    if batch is _STREAM_END or batch[INDEX_KEY] != index:
                        batch = self._followed.batch(index)
            if index < 0:
                return
            yield {k: v for k, v in batch.items() if k != INDEX_KEY}

    # -- resilience (guardrail / chaos / preemption) ------------------------

    def _resilient_step(self, state, dev_batch, gen: torch.Generator, step: int):
        """One step under the guardrail and/or the chaos plan.

        The rollback snapshot is taken BEFORE any chaos injection, so the
        guardrail's recovery target is always clean: a poisoned row
        (pre-step fault) or a poisoned update (post-step fault) is detected
        at commit and discarded whole.
        """
        guard = self.guardrail
        chaos = self.chaos
        snap = guard.snapshot(state) if guard is not None else None
        if chaos is not None:
            state = chaos.pre_step(state, step)
        new_state, metrics = self.trainer.train_step(state, dev_batch, gen)
        if chaos is not None:
            new_state, metrics = chaos.post_step(new_state, metrics, step)
        if guard is not None:
            new_state, metrics, tripped, exhausted = guard.commit(
                snap, new_state, metrics, layouts=self._layouts)
            if tripped:
                if self.registry is not None:
                    self.registry.counter("guard_trips").inc()
                print(f"guardrail: step {step} rolled back "
                      f"({guard.last_trip_reason}); trust={guard.trust:.3f}",
                      file=sys.stderr)
            if exhausted:
                if self.blackbox is not None:
                    self.blackbox.dump("guardrail-giveup", tracer=self.tracer)
                raise GuardrailExhausted(
                    f"{guard.consecutive} consecutive unhealthy steps "
                    f"(last: {guard.last_trip_reason}); giving up at step {step}")
        if chaos is not None:
            chaos.maybe_corrupt_checkpoint(self.backup_root, step, leader=self.leader)
            if self.tier is not None:
                chaos.maybe_flip_tier(self.tier, step)
            reason = chaos.wants_preempt(step)
            if reason is not None:
                self.request_preemption(reason)
        if (self.tier is not None and self.tier_verify_period
                and (step + 1) % self.tier_verify_period == 0):
            self._tier_integrity_sweep(new_state, step)
        return new_state, metrics

    def _tier_integrity_sweep(self, state, step: int) -> None:
        """Recompute the host masters' plane digests; on a mismatch,
        quarantine-and-rebuild from the newest verified checkpoint (the cache
        plane — which the corruption cannot reach — is re-asserted on top,
        so only units evicted since that checkpoint roll back). Failing to
        find a trustworthy checkpoint raises: silently training on a corrupt
        master is the one outcome this sweep exists to prevent."""
        bad = self.tier.verify()
        if not bad:
            return
        print(
            f"tier integrity: corrupt master plane(s) at step {step}: "
            + ", ".join(f"{t}[{', '.join(p)}]" for t, p in bad.items())
            + "; rebuilding from newest verified checkpoint",
            file=sys.stderr,
        )
        policy = RetryPolicy.from_config(self.trainer.config, ledger=self.ledger)
        ckpt_step, rebuilt = self.tier.heal(
            state, self.backup_root, corrupt=bad, retry_policy=policy)
        if self.registry is not None:
            self.registry.counter("tier_heals").inc()
        if self.leader:  # every rank healed the same: one event
            self._ledger_event("cache_error", {
                "source": "tier",
                "step": step,
                "planes": {t: list(p) for t, p in bad.items()},
                "rebuilt_from_step": ckpt_step,
                "tables": rebuilt,
            })

    def request_preemption(self, reason: str = "SIGTERM") -> None:
        """Ask the loop to drain at the next step boundary: final save,
        ledger ``outage`` record, then a normal return with
        :attr:`preempted` set."""
        self._preempt_reason = reason
        self._preempt.set()

    def _install_sigterm(self) -> None:
        """SIGTERM dumps the black box (the ring is most valuable at the
        moment of death) and asks for the drain, for the duration of the
        run: the loop's own handler, not the black box's die-after-dump one.
        Main thread only (a signal-module restriction); elsewhere preemption
        is cooperative (:meth:`request_preemption`)."""

        def _on_term(signum, frame):
            if self.blackbox is not None:
                self.blackbox.dump("sigterm", tracer=self.tracer)
            self.request_preemption("SIGTERM")

        try:
            self._prev_sigterm = signal.signal(signal.SIGTERM, _on_term)
        except ValueError:  # not the main thread
            self._prev_sigterm = None

    def _uninstall_sigterm(self) -> None:
        if self._prev_sigterm is not None:
            signal.signal(signal.SIGTERM, self._prev_sigterm)
            self._prev_sigterm = None

    def _ledger_event(self, kind: str, record: Dict) -> None:
        """Best-effort ledger append — resilience bookkeeping never fails
        the run."""
        if self.ledger is None:
            return
        try:
            self.ledger.append(kind, record)
        except Exception as e:
            print(f"resilience: ledger append failed: {e}", file=sys.stderr)

    def _on_resume_reject(self, step: int, err: Exception) -> None:
        print(f"resume: rejected step {step} under {self.backup_root} "
              f"({type(err).__name__}: {err}); walking back", file=sys.stderr)

    def _on_stream_error(self, exc, attempt: int, recovered: bool) -> None:
        print(
            f"data stream error (attempt {attempt + 1}): {exc}"
            + ("; retrying" if recovered else "; giving up"),
            file=sys.stderr,
        )
        if self.registry is not None:
            self.registry.counter("stream_retries").inc()
        if not recovered:
            self._ledger_event("outage", {
                "probe": "data_stream",
                "error": f"{type(exc).__name__}: {exc}",
            })

    def _join_checkpoints(self) -> None:
        """Join the background checkpoint write; report its errors (the
        writer has already recorded each as a ``cache_error`` ledger event)."""
        for err in wait_for_checkpoints():
            print(f"checkpoint: {err}", file=sys.stderr)

    # -- continuous profiling + drift (telemetry-only paths) ----------------

    def _profile_sample(self, step: int, step_ms: float, last_metrics) -> None:
        """One continuous-profiling sample (every ``profile_cadence`` steps):
        the registry snapshot plus the goodput decomposition of the spans
        recorded since the previous sample and the prefetch stall —
        appended to the bounded ring and fed to the drift sentinel.
        Best-effort: profiling never fails the run."""
        try:
            row: Dict[str, float] = {}
            for k, v in self.registry.snapshot().items():
                if isinstance(v, (int, float)):
                    row[k] = float(v)
            row["step_ms"] = float(step_ms)
            # per-window decomposition: only the spans since the last sample,
            # so the ring shows the run's shape over time, not a cumulative
            # average that hides late-run drift
            window = self.tracer.events(self._profile_event_idx)
            self._profile_event_idx += len(window)
            dec = step_time_decomposition(window)
            steps_w = dec.get("steps") or 0
            for key in ("compute_frac", "h2d_frac", "host_blocked_frac",
                        "other_frac", "unaccounted_frac"):
                if key in dec:
                    row[f"win_{key}"] = dec[key]
            if steps_w:
                row["host_blocked_ms"] = dec["host_blocked_s"] / steps_w * 1e3
                stall_us = sum(
                    float(e.get("dur_us", 0.0)) for e in window
                    if e.get("name") == "prefetch-wait")
                row["prefetch_stall_ms"] = stall_us / 1e3 / steps_w
            # the loss is read one sampling interval late: converting the
            # step's own value would wait for the step the JAX loop leaves
            # in flight; the previous sample's is long since materialized
            pending = self._profile_pending_loss
            if last_metrics and "loss" in last_metrics:
                self._profile_pending_loss = last_metrics["loss"]
            if pending is not None:
                row["loss"] = float(pending)
            if "tier_cache_hit_rate" in row:
                # the drift sentinel's canonical signal name
                row["tier_hit_rate"] = row["tier_cache_hit_rate"]
            self.timeseries.sample(step, row)
            if self.drift is not None:
                edges = self.drift.events
                confirmed = self.drift.observe(step, row)
                if confirmed and self.drift.events > edges:
                    print(
                        f"drift: confirmed at step {step} on "
                        f"{', '.join(confirmed)}; capturing incident bundle",
                        file=sys.stderr,
                    )
                    self._incident("drift-" + "-".join(confirmed))
        except Exception as e:
            print(f"telemetry: profile sample failed: {e}", file=sys.stderr)

    def _incident(self, reason: str) -> Optional[str]:
        """Capture an atomic incident bundle (blackbox ring + timeseries
        window + config/env fingerprint + kept spans) under ``incident_dir``,
        once per reason per run. Armed only when continuous profiling or the
        drift sentinel is on — a bare-telemetry run leaves no dirs behind."""
        if self.timeseries is None and self.drift is None:
            return None
        if not self.incident_dir or reason in self._incident_reasons:
            return None
        self._incident_reasons.add(reason)
        try:
            context = {"model": self.trainer.name, "config_hash": self.config_hash}
            if self.drift is not None:
                context["drift"] = self.drift.summary()
            path = build_incident_bundle(
                self.incident_dir, reason,
                blackbox=self.blackbox,
                timeseries=self.timeseries,
                tracer=self.tracer,
                context=context,
            )
            self.incidents.append(path)
            print(f"incident bundle: {path}", file=sys.stderr)
            return path
        except Exception as e:
            print(f"telemetry: incident bundle failed: {e}", file=sys.stderr)
            return None

    # -- goodput + ledger finalization (telemetry-only paths) --------------

    def _count_step(self, batch: Dict[str, np.ndarray]) -> Dict:
        """:meth:`Trainer.step_cost` of the first batch; any failure costs
        only the goodput FLOP numbers, never the run."""
        try:
            return self.trainer.step_cost(batch) or {"error": "no count for this path"}
        except Exception as e:
            return {"error": f"{type(e).__name__}: {e}"}

    def _finalize_run_record(self, steps: int, items: int, final_metrics) -> None:
        """Emit the goodput block to the metrics sink and, when a
        ``ledger_path`` is configured, append the durable run record."""
        try:
            kind = (torch.cuda.get_device_name(self.device)
                    if self.device.type == "cuda" else "cpu")
            cost = self._step_cost
            if cost is not None and "error" in cost:
                cost = None
            report = goodput_report(
                events=self.tracer.events(),
                audit=cost,
                steps=steps,
                items=items,
                peaks=peaks_from_config(self.trainer.config, kind),
                n_chips=1,
            )
            self.metrics.log({"goodput": report, "step": steps})
            if self.timeseries is not None:
                export = self.trainer.config.get_str("profile_export", "")
                if export:
                    self.timeseries.export_jsonl(export)
            if self.ledger is not None:
                record = {
                    "model": self.trainer.name,
                    "config_hash": self.config_hash,
                    "steps": steps,
                    "items": items,
                    "goodput": report,
                    "final_metrics": final_metrics or None,
                }
                if self._comm_by_scope:
                    # the first step's wire bytes by collective scope, so
                    # `ledger-report --diff` can name the collective a
                    # byte delta comes from
                    record["comm_by_scope"] = dict(self._comm_by_scope)
                if self.timeseries is not None:
                    record["timeseries"] = self.timeseries.summary()
                if self.drift is not None:
                    record["drift"] = self.drift.summary()
                if self.incidents:
                    record["incidents"] = list(self.incidents)
                wire = getattr(self.trainer, "comm_dtype", None)
                if wire:
                    # the wire format, so `ledger-report` run lines show what
                    # a quantized run moved
                    record["comm_dtype"] = wire
                if self.guardrail is not None:
                    record["guardrail"] = self.guardrail.summary()
                if self.chaos is not None:
                    record["chaos"] = self.chaos.summary()
                if self.tier is not None:
                    record["tiered"] = self.tier.summary()
                placement_decision = getattr(self.trainer, "placement_decision", None)
                if placement_decision:
                    # the cut decision or the uniform fallback's reason, and
                    # the first step's counted bytes beside the prediction
                    pl = dict(placement_decision)
                    if self._comm_total is not None:
                        pl["measured_exchange_bytes"] = self._comm_total
                    record["placement"] = pl
                if self.zero is not None and self.zero.summary():
                    # planes sharded, replicated against sharded bytes a
                    # replica, the reduction
                    record["zero"] = self.zero.summary()
                if self.preempted:
                    record["preempted"] = True
                self.ledger.append("run", record, env=env_fingerprint(include_devices=True))
        except Exception as e:  # observability must never fail the run
            print(f"telemetry: run-record finalization failed: {e}", file=sys.stderr)
