"""Trainer contract and the training loop (the JAX package's ``framework/trainer.py``).

Capability parity with the reference's worker framework
(``src/core/framework/SwiftWorker.h``):

* ``BaseAlgorithm`` (``SwiftWorker.h:19-57``) -> :class:`Trainer`:
  subclasses provide ``init_state`` / ``batches`` / ``train_step`` and the
  framework owns the loop;
* ``SwiftWorker::operator()`` (``SwiftWorker.h:88-124``) -> :class:`TrainLoop`:
  host prefetch thread, device feed, a per-step ``torch.Generator``,
  metrics windows.

The port has the core loop only. The loop features of the JAX package that
are not ported yet raise ``NotImplementedError`` when their config keys ask
for them (see :data:`UNPORTED_LOOP_KEYS` and ``ROADMAP.md``); none is
silently ignored.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from swiftsnails_tpu_torch.ops.hashing import murmur_fmix64_int
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
    "param_backup_period": _positive,
    "resume": lambda cfg, key: cfg.get_str(key, "0").strip().lower() in (
        "auto", "1", "true", "yes", "on"),
    "guardrail": truthy,
    "telemetry": truthy,
    "chaos_spec": _non_empty,
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


class TrainLoop:
    """The training loop: prefetch, device feed, per-step generator, metrics."""

    def __init__(
        self,
        trainer: Trainer,
        metrics: Optional[MetricsLogger] = None,
        log_every: int = 100,
        device: DeviceLike = None,
    ):
        """``device=None`` feeds the trainer's device (itself the card unless
        the trainer was asked for the CPU); a device of another type raises."""
        raise_unported(trainer.config, UNPORTED_LOOP_KEYS)
        if device is not None and resolve_device(device).type != trainer.device.type:
            raise ValueError(f"TrainLoop on {device}, trainer on {trainer.device}")
        self.trainer = trainer
        self.metrics = metrics or MetricsLogger(echo=False)
        self.log_every = log_every
        self.device = trainer.device

    def _device_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, Any]:
        """Arrays go to the device; scalars (e.g. ``progress``) stay on the
        host, where the learning-rate schedule reads them."""
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                if np.ndim(v) else v for k, v in batch.items()}

    def run(self, seed: int = 0, max_steps: Optional[int] = None) -> Any:
        trainer = self.trainer
        state = trainer.init_state()
        step = 0
        last_metrics: Dict[str, Any] = {}
        depth = trainer.config.get_int("prefetch_batches", 2)
        src = iter(trainer.batches())
        batches = _Prefetcher(src, depth=depth) if depth else src
        try:
            for batch in batches:
                n_items = trainer.items_per_batch(batch)
                dev_batch = self._device_batch(batch)
                gen = step_generator(seed, step, self.device)
                state, last_metrics = trainer.train_step(state, dev_batch, gen)
                step += 1
                self.metrics.count(n_items)
                if self.log_every and step % self.log_every == 0:
                    host = {k: float(v) for k, v in last_metrics.items()}
                    self.metrics.flush_window(step=step, **host)
                if max_steps is not None and step >= max_steps:
                    break
        finally:
            if isinstance(batches, _Prefetcher):
                batches.close()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        if step % max(self.log_every, 1) != 0 or not self.log_every:
            host = {k: float(v) for k, v in last_metrics.items()}
            self.metrics.flush_window(step=step, **host)
        return state
