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
  SIGTERM drain.

The loop features of the JAX package that are not ported yet raise
``NotImplementedError`` when their config keys ask for them (see
:data:`UNPORTED_LOOP_KEYS` and ``ROADMAP.md``); none is silently ignored.
"""

from __future__ import annotations

import queue
import signal
import sys
import threading
import time
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from swiftsnails_tpu_torch.framework.checkpoint import save_checkpoint, wait_for_checkpoints
from swiftsnails_tpu_torch.ops.hashing import murmur_fmix64_int
from swiftsnails_tpu_torch.resilience.chaos import ChaosPlan
from swiftsnails_tpu_torch.resilience.guardrail import GuardrailExhausted, StepGuardrail
from swiftsnails_tpu_torch.resilience.resume import resume_mode, resume_state
from swiftsnails_tpu_torch.resilience.retry import RetryingIterator, RetryPolicy
from swiftsnails_tpu_torch.telemetry.ledger import config_hash
from swiftsnails_tpu_torch.utils.config import Config
from swiftsnails_tpu_torch.utils.device import DeviceLike, resolve_device
from swiftsnails_tpu_torch.utils.metrics import MetricsLogger


class Trainer:
    """Pluggable training algorithm (``BaseAlgorithm`` equivalent).

    Subclasses implement:

    * :meth:`init_state`  — build the model state on ``self.device``;
    * :meth:`batches`     — yield host batches (dicts of numpy arrays);
    * :meth:`train_step`  — ``(state, batch, generator) -> (state, metrics)``,
      with the batch's arrays already on the device;
    * :meth:`items_per_batch` — unit count for throughput metrics.
    """

    name: str = "trainer"

    def __init__(self, config: Config, device: DeviceLike = None):
        self.config = config
        self.device = resolve_device(device)
        sharding = config.get_str("optimizer_sharding", "none")
        if sharding != "none":
            _unported("optimizer_sharding", sharding)

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

    # -- optional hooks ----------------------------------------------------

    def export_text(self, state: Any, path: str) -> None:
        """Final param export (ServerTerminate parity). Optional."""

    def eval_metrics(self, state: Any) -> Dict[str, float]:
        return {}


def _unported(key: str, value) -> None:
    raise NotImplementedError(
        f"config key {key}: {value} selects a path the PyTorch port does not "
        "have yet; see ROADMAP.md for when it is ported")


class _Prefetcher:
    """Bounded background-thread batch prefetch (``queue_with_capacity``
    parity, ``src/utils/queue.h:100-108``): the producer thread runs the
    trainer's host-side sampling while the device computes. Producer errors
    re-raise on the consumer side."""

    _DONE = object()

    def __init__(self, it: Iterator, depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        self._exhausted = False

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
        item = self._q.get()
        if item is self._DONE:
            self._exhausted = True
            self._thread.join()
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def close(self):
        self._stop.set()
        # drain so the producer's pending put unblocks promptly, then reap it
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)


def raise_unported(cfg: Config, keys: Dict[str, Any]) -> None:
    """Raise ``NotImplementedError`` for the first key of ``keys`` (key ->
    "is it asked for") that ``cfg`` asks for."""
    for key, asked in keys.items():
        if key in cfg and asked(cfg, key):
            _unported(key, cfg.get_str(key))


def truthy(cfg: Config, key: str) -> bool:
    return cfg.get_bool(key, False)


# Table-plane keys that the JAX package's trainers read and the port does not
# have yet, read as the JAX trainers read them: key -> "is it asked for".
UNPORTED_PLANE_KEYS = {
    "packed": lambda cfg, key: not cfg.get_bool(key, True),
    "stream": truthy,
    "table_tier": lambda cfg, key: cfg.get_str(key, "device") != "device",
    "comm_dtype": lambda cfg, key: cfg.get_str(key, "float32") not in (
        "float32", "f32", "fp32"),
    "placement": lambda cfg, key: cfg.get_str(key, "uniform") != "uniform",
}


def _positive(cfg: Config, key: str) -> bool:
    return cfg.get_int(key, 0) > 0


def _non_empty(cfg: Config, key: str) -> bool:
    return cfg.get_str(key, "").strip() != ""


# Loop features of the JAX package not ported yet: key -> "is it asked for"
# (read as the JAX loop reads it).
UNPORTED_LOOP_KEYS = {
    "telemetry": truthy,
    "trace_path": _non_empty,
    "ledger_path": _non_empty,
    "profile_dir": _non_empty,
    "cluster_workers": _positive,
    "freshness_publish": _positive,
}


def step_generator(seed: int, step: int, device: torch.device) -> torch.Generator:
    """The step's random stream: a generator on ``device`` seeded from
    ``(seed, step)`` through the murmur finalizer — the counterpart of the
    JAX loop's ``fold_in(root_rng, step)``."""
    gen = torch.Generator(device=device)
    mixed = murmur_fmix64_int(((seed & 0xFFFFFFFF) << 32) | (step & 0xFFFFFFFF))
    gen.manual_seed(mixed & ((1 << 63) - 1))
    return gen


_STREAM_END = object()


class TrainLoop:
    """The training loop: prefetch, device feed, per-step generator, metrics,
    checkpoints, resume, guardrail, fault injection and the SIGTERM drain."""

    def __init__(
        self,
        trainer: Trainer,
        metrics: Optional[MetricsLogger] = None,
        log_every: int = 100,
        device: DeviceLike = None,
    ):
        """``device=None`` feeds the trainer's device (itself the card unless
        the trainer was asked for the CPU); a device of another type raises."""
        cfg = trainer.config
        raise_unported(cfg, UNPORTED_LOOP_KEYS)
        if device is not None and resolve_device(device).type != trainer.device.type:
            raise ValueError(f"TrainLoop on {device}, trainer on {trainer.device}")
        self.trainer = trainer
        self.metrics = metrics or MetricsLogger(echo=False)
        self.log_every = log_every
        self.device = trainer.device
        self.backup_period = cfg.get_int("param_backup_period", 0)
        self.backup_root = cfg.get_str("param_backup_root", "")
        self.backup_keep = cfg.get_int("param_backup_keep", 3)
        self.config_hash = config_hash(cfg.as_dict())
        self._restored_step: Optional[int] = None  # set by resume; never pruned
        self._items_seen = 0
        self.checkpoint_fn = None
        if self.backup_root:
            # async periodic saves: training continues while the writer
            # thread CRCs and writes; the manifest (step, config hash, CRCs,
            # data cursor) commits when the files are down
            ckpt_retry = RetryPolicy.from_config(cfg)

            def checkpoint_fn(state, step):
                save_checkpoint(
                    self.backup_root, state, step, wait=False,
                    cursor={"step": step, "items": self._items_seen},
                    config_hash=self.config_hash, keep=self.backup_keep,
                    protect=self._restored_step, retry=ckpt_retry)

            self.checkpoint_fn = checkpoint_fn
        # resilience is opt-in per key; off, the step pays flag checks only
        self.guardrail = None
        if cfg.get_bool("guardrail", False):
            self.guardrail = StepGuardrail(
                max_update_norm=cfg.get_float("guard_max_update_norm", 0.0),
                max_consecutive=cfg.get_int("guard_max_consecutive", 3))
        self.chaos = ChaosPlan.from_config(cfg)
        self._preempt = threading.Event()
        self._preempt_reason: Optional[str] = None
        self.preempted = False
        self._prev_sigterm = None

    def _device_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, Any]:
        """Arrays go to the device; scalars (e.g. ``progress``) stay on the
        host, where the learning-rate schedule reads them."""
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                if np.ndim(v) else v for k, v in batch.items()}

    def _resume(self, state) -> Tuple[Any, int, int]:
        """``resume: 1`` / ``auto``: the restored state, its step, and the
        batches to skip (``auto`` only: the manifest's cursor)."""
        mode = resume_mode(self.trainer.config)
        if mode == "off" or not self.backup_root:
            return state, 0, 0
        t0 = time.perf_counter()
        restored = resume_state(self.backup_root, state, on_reject=self._on_resume_reject)
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
        print(f"resume: restored step {step} from {self.backup_root} in {seconds:.4f} s; "
              f"skipping {skip} batches", file=sys.stderr)
        return state, step, skip

    def run(self, seed: int = 0, max_steps: Optional[int] = None) -> Any:
        """Train until the data ends, ``max_steps`` (counted from step 0,
        so a resumed run stops where the uninterrupted one would) or a
        preemption; returns the state."""
        trainer = self.trainer
        state, step, skip_batches = self._resume(trainer.init_state())
        last_metrics: Dict[str, Any] = {}
        depth = trainer.config.get_int("prefetch_batches", 2)
        src = iter(trainer.batches())
        batches = _Prefetcher(src, depth=depth) if depth else src
        chaos = self.chaos
        resilient = self.guardrail is not None or chaos is not None
        it = iter(batches)
        if chaos is not None:
            it = chaos.wrap_stream(it)
        if resilient:
            # transient OSError (a flaky filesystem, chaos io_error) is
            # retried under the shared policy before it propagates
            it = RetryingIterator(it, RetryPolicy.from_config(trainer.config),
                                  on_error=self._on_stream_error, op="data_stream")
        self._install_sigterm()
        try:
            for _ in range(skip_batches):
                if next(it, _STREAM_END) is _STREAM_END:
                    break
            for batch in it:
                if self._preempt.is_set():
                    break
                n_items = trainer.items_per_batch(batch)
                if chaos is not None:
                    chaos.maybe_slow_step(step)  # a host stall before dispatch
                dev_batch = self._device_batch(batch)
                gen = step_generator(seed, step, self.device)
                if resilient:
                    state, last_metrics = self._resilient_step(state, dev_batch, gen, step)
                else:
                    state, last_metrics = trainer.train_step(state, dev_batch, gen)
                step += 1
                self._items_seen += n_items
                self.metrics.count(n_items)
                if self.log_every and step % self.log_every == 0:
                    host = {k: float(v) for k, v in last_metrics.items()}
                    self.metrics.flush_window(step=step, **host)
                if self.backup_period and self.checkpoint_fn and step % self.backup_period == 0:
                    self.checkpoint_fn(state, step)
                if max_steps is not None and step >= max_steps:
                    break
        finally:
            if isinstance(batches, _Prefetcher):
                batches.close()
            self._uninstall_sigterm()
            # an async save must never be orphaned by an exception
            if self.checkpoint_fn is not None:
                self._join_checkpoints()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        if self._preempt.is_set():
            # the drain: a final save, then a normal return; the next run's
            # `resume: auto` continues from this state
            self.preempted = True
            if self.checkpoint_fn is not None:
                self.checkpoint_fn(state, step)
                self._join_checkpoints()
            print(f"preemption ({self._preempt_reason}): drained at step {step}",
                  file=sys.stderr)
        if step % max(self.log_every, 1) != 0 or not self.log_every:
            host = {k: float(v) for k, v in last_metrics.items()}
            self.metrics.flush_window(step=step, **host)
        return state

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
            new_state, metrics, tripped, exhausted = guard.commit(snap, new_state, metrics)
            if tripped:
                print(f"guardrail: step {step} rolled back "
                      f"({guard.last_trip_reason}); trust={guard.trust:.3f}",
                      file=sys.stderr)
            if exhausted:
                raise GuardrailExhausted(
                    f"{guard.consecutive} consecutive unhealthy steps "
                    f"(last: {guard.last_trip_reason}); giving up at step {step}")
        if chaos is not None:
            chaos.maybe_corrupt_checkpoint(self.backup_root, step)
            reason = chaos.wants_preempt(step)
            if reason is not None:
                self.request_preemption(reason)
        return new_state, metrics

    def request_preemption(self, reason: str = "SIGTERM") -> None:
        """Ask the loop to drain at the next step boundary: final save, then
        a normal return with :attr:`preempted` set."""
        self._preempt_reason = reason
        self._preempt.set()

    def _install_sigterm(self) -> None:
        """SIGTERM asks for the drain for the duration of the run; main
        thread only (a signal-module restriction), elsewhere preemption is
        cooperative (:meth:`request_preemption`)."""

        def _on_term(signum, frame):
            self.request_preemption("SIGTERM")

        try:
            self._prev_sigterm = signal.signal(signal.SIGTERM, _on_term)
        except ValueError:  # not the main thread
            self._prev_sigterm = None

    def _uninstall_sigterm(self) -> None:
        if self._prev_sigterm is not None:
            signal.signal(signal.SIGTERM, self._prev_sigterm)
            self._prev_sigterm = None

    def _on_resume_reject(self, step: int, err: Exception) -> None:
        print(f"resume: rejected step {step} under {self.backup_root} "
              f"({type(err).__name__}: {err}); walking back", file=sys.stderr)

    def _on_stream_error(self, exc, attempt: int, recovered: bool) -> None:
        print(
            f"data stream error (attempt {attempt + 1}): {exc}"
            + ("; retrying" if recovered else "; giving up"),
            file=sys.stderr,
        )

    def _join_checkpoints(self) -> None:
        """Join the background checkpoint write; report its errors."""
        for err in wait_for_checkpoints():
            print(f"checkpoint: {err}", file=sys.stderr)
