"""Serving-side delta subscription — the JAX package's
``freshness/subscriber.py`` over the port's serving targets.

:class:`DeltaSubscriber` sits between a delta-log directory and a serving
target (a :class:`~swiftsnails_tpu_torch.serving.engine.Servant` or a whole
:class:`~swiftsnails_tpu_torch.serving.fleet.Fleet` — both expose the same
``apply_rows`` / ``reload_from_checkpoint`` / ``step`` / ``version``
surface). ``poll()`` scans the directory, decodes batches, and applies
them strictly in sequence order with one atomic version cutover per
batch; apply is idempotent and out-of-order-safe, keyed on
``(table, row, seq)`` — a re-delivered or older batch can never regress
a row a newer batch already wrote.

Fallback contract (the only recovery path — deltas are an optimization,
checkpoints are the truth):

* **gap** — the next expected batch is missing but a later one exists
  (retention outran us, or the publisher lost a write), or an
  out-of-order direct ``apply_batch`` ran past the reorder ``window``;
* **restart** — the ``publisher`` id in ``BASE.json`` (or a batch
  header) changed: a new incarnation's seq numbering is unrelated;
* **crc** — a batch failed its CRC/framing check.

All three trigger the same sequence: a ``freshness_gap`` ledger event,
``reload_from_checkpoint`` (the existing shadow-load + verify + atomic
swap — the NEWEST verified checkpoint, not the stream's base), then
re-subscribe: batches whose ``step`` watermark is at or below the
reloaded checkpoint's step are skipped-but-acknowledged (their rows are
already in the reloaded planes or superseded), and the row-seq memory is
cleared because the reload re-based every row.

The freshness watermark is ``applied_step`` (the trainer step the newest
applied batch was current as of); the staleness gauge is the wall-clock
lag between publish and apply, with ``freshness_max_lag_ms`` bounding
when ``status()`` reports the target stale.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np

from swiftsnails_tpu_torch.freshness.log import (
    DeltaCorrupt, list_seqs, read_base, read_batch, seg_path,
)

_LAG_WINDOW = 512  # lag samples kept for the p50/p99 gauge
_ROW_SEQ_CAP = 1 << 20  # bound the (table,row)->seq memory


def _percentile(samples: List[float], q: float) -> float:
    if not samples:
        return 0.0
    s = sorted(samples)
    idx = min(int(q * len(s)), len(s) - 1)
    return s[idx]


class DeltaSubscriber:
    """Apply a delta stream to a serving target with bounded staleness."""

    def __init__(
        self,
        target,
        dirpath: str,
        *,
        config=None,
        checkpoint_root: Optional[str] = None,
        max_lag_ms: float = 0.0,
        window: int = 64,
        ledger=None,
        request_tracer=None,
    ):
        self.target = target
        self.dir = os.path.abspath(dirpath)
        self.config = config
        self.checkpoint_root = checkpoint_root
        self.max_lag_ms = float(max_lag_ms)
        self.window = max(int(window), 1)
        self.ledger = ledger
        if request_tracer is None and config is not None:
            try:
                from swiftsnails_tpu_torch.telemetry.request_trace import (
                    RequestTracer,
                )
                request_tracer = RequestTracer.from_config(
                    config, ledger=ledger, source="freshness")
            except Exception:
                request_tracer = None
        self.request_tracer = request_tracer
        self._lock = threading.RLock()
        # stream position
        self.publisher: Optional[str] = None
        self.base_step: Optional[int] = None
        self.next_seq = 1
        self.applied_seq = 0
        self.applied_step = 0  # the freshness watermark
        self.floor_step = 0  # batches at/below this step are already served
        # out-of-order buffer for direct apply_batch deliveries
        self._pending: Dict[int, tuple] = {}
        # (table, row) -> seq of the newest applied write
        self._row_seq: Dict[tuple, int] = {}
        # counters / gauges
        self.applied_batches = 0
        self.applied_rows = 0
        self.skipped_batches = 0  # at/below the reload floor
        self.duplicate_batches = 0
        self.fallbacks = 0
        self.gaps = 0
        self._lag_ms: "deque[float]" = deque(maxlen=_LAG_WINDOW)
        self.last_lag_ms = 0.0
        self._gap_events = 0
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- subscription --------------------------------------------------------

    def subscribe(self) -> bool:
        """Adopt the directory's current base; returns False when no
        publisher has opened the stream yet (poll again later)."""
        with self._lock:
            base = read_base(self.dir)
            if base is None:
                return False
            seqs = list_seqs(self.dir)
            self.adopt_base(base, first_seq=seqs[0] if seqs else None)
            return True

    def adopt_base(self, base: Dict,
                   first_seq: Optional[int] = None) -> None:
        """Adopt a publisher base record — the transport-agnostic half of
        :meth:`subscribe` (a TCP stream source delivers the base as a frame
        instead of a ``BASE.json`` read). ``first_seq`` overrides the base's
        own ``first_seq`` when the transport knows the oldest batch it can
        still deliver."""
        with self._lock:
            self.publisher = base.get("publisher")
            self.base_step = int(base.get("base_step", 0) or 0)
            self.next_seq = int(first_seq if first_seq is not None
                                else base.get("first_seq", 1) or 1)
            # everything the target already serves needs no replay
            self.floor_step = max(self.floor_step,
                                  int(getattr(self.target, "step", 0) or 0))

    def corrupt_fallback(self, failed_seq: Optional[int] = None) -> None:
        """Public CRC-failure entry for alternate transports: a stream
        source that decodes a corrupt batch falls back exactly like the
        file poll does."""
        with self._lock:
            self._fallback("crc", failed_seq=failed_seq)

    def restart_fallback(self) -> None:
        """Public restart entry for alternate transports: a stream source
        that observes a new publisher incarnation (its base frame changed
        under it) falls back exactly like the file poll does."""
        with self._lock:
            self._fallback("restart")

    # -- polling -------------------------------------------------------------

    def poll(self, max_batches: Optional[int] = None) -> int:
        """Scan + apply every ready batch in order; returns how many were
        applied (skipped-but-acknowledged batches count too — they advance
        the sequence). Detection of gap/restart/crc falls back inline."""
        with self._lock:
            if self.publisher is None and not self.subscribe():
                return 0
            base = read_base(self.dir)
            if base is not None and base.get("publisher") != self.publisher:
                self._fallback("restart")
                return 0
            applied = 0
            while max_batches is None or applied < max_batches:
                path = seg_path(self.dir, self.next_seq)
                if not os.path.exists(path):
                    later = [s for s in list_seqs(self.dir)
                             if s > self.next_seq]
                    if later:
                        # atomic sequential writes: a visible later batch
                        # means this one existed and is gone (retention
                        # outran us) — a real gap, not a race
                        self._fallback("gap", failed_seq=self.next_seq)
                    return applied
                try:
                    header, tables = read_batch(path)
                except DeltaCorrupt:
                    self._fallback("crc", failed_seq=self.next_seq)
                    return applied
                if not self.apply_batch(header, tables):
                    return applied
                applied += 1
            return applied

    # -- apply ---------------------------------------------------------------

    def apply_batch(self, header: Dict, tables: Dict) -> bool:
        """Deliver one decoded batch; public so tests (and alternate
        transports) can push batches directly. Returns True when the stream
        advanced (applied, skipped past the floor, or buffered+drained),
        False when the batch was a duplicate, was buffered for later, or
        triggered a fallback."""
        with self._lock:
            if self.publisher is not None and \
                    header.get("publisher") != self.publisher:
                self._fallback("restart")
                return False
            seq = int(header["seq"])
            if seq < self.next_seq:
                self.duplicate_batches += 1  # idempotent: already applied
                return False
            if seq > self.next_seq:
                if seq - self.next_seq >= self.window:
                    self.gaps += 1
                    # resume AT the far-ahead batch: its re-delivery (or its
                    # successor) must apply on the reloaded planes
                    self._fallback("gap", failed_seq=seq - 1)
                    return False
                self._pending[seq] = (header, tables)
                return False
            self._apply_now(header, tables)
            # drain any buffered successors that are now contiguous
            while self.next_seq in self._pending:
                h, t = self._pending.pop(self.next_seq)
                self._apply_now(h, t)
            return True

    def _apply_now(self, header: Dict, tables: Dict) -> None:
        seq = int(header["seq"])
        step = int(header.get("step", 0) or 0)
        rt = self.request_tracer
        ctx = None
        if rt is not None:
            try:
                # continue the publisher's trace (same id -> same sampling
                # decision on both sides, no coordination needed)
                ctx = rt.resume(header.get("trace"), "delta_apply",
                                publisher=header.get("publisher"))
                ctx.annotate(seq=seq, step=step)
            except Exception:
                ctx = None  # tracing never blocks the apply path
        if step <= self.floor_step:
            # the fallback reload already serves rows at/after this step
            self.skipped_batches += 1
            self.next_seq = seq + 1
            self.applied_seq = seq
            if ctx is not None:
                try:
                    ctx.annotate(skipped=True, floor_step=self.floor_step)
                    rt.finish(ctx)
                except Exception:
                    pass
            return
        dtype = header.get("dtype", "float32")
        updates = {}
        n_rows = 0
        t_apply = time.perf_counter_ns()
        for name, t in tables.items():
            rows = np.asarray(t["rows"], np.int64)
            if dtype == "int8":
                from swiftsnails_tpu_torch.tiered.store import _np_dequant_unit_rows

                values = _np_dequant_unit_rows(
                    np.asarray(t["values"]), np.asarray(t["scales"]),
                    np.float32)
            else:
                values = np.asarray(t["values"], np.float32)
            # (table, row, seq) keying: drop rows a newer seq already wrote
            # (can only happen through direct out-of-order apply paths)
            keep = np.fromiter(
                (self._row_seq.get((name, int(r)), 0) <= seq for r in rows),
                bool, count=rows.size)
            rows, values = rows[keep], values[keep]
            if rows.size == 0:
                continue
            for r in rows:
                self._row_seq[(name, int(r))] = seq
            updates[name] = (rows, values)
            n_rows += int(rows.size)
        if len(self._row_seq) > _ROW_SEQ_CAP:
            self._row_seq.clear()  # cheap reset: absolute values stay safe
        apply_dur = time.perf_counter_ns() - t_apply
        t_cutover = cutover_dur = 0
        if updates:
            # atomic version cutover inside; the step kwarg advances the
            # target's serving watermark to what the batch was current as of
            t_cutover = time.perf_counter_ns()
            self.target.apply_rows(updates, step=step)
            cutover_dur = time.perf_counter_ns() - t_cutover
        self.applied_seq = seq
        self.applied_step = max(self.applied_step, step)
        self.next_seq = seq + 1
        self.applied_batches += 1
        self.applied_rows += n_rows
        ts_ns = int(header.get("ts_ns", 0) or 0)
        if ts_ns:
            self.last_lag_ms = max((time.time_ns() - ts_ns) / 1e6, 0.0)
            self._lag_ms.append(self.last_lag_ms)
        if ctx is not None:
            try:
                ctx.add_span("apply", t_apply, apply_dur,
                             rows=n_rows, tables=len(updates))
                if updates:
                    ctx.add_span("cutover", t_cutover, cutover_dur)
                ctx.annotate(rows=n_rows,
                             target_version=getattr(
                                 self.target, "version", None))
                if ts_ns:
                    ctx.annotate(lag_ms=round(self.last_lag_ms, 3))
                rt.finish(ctx)
            except Exception:
                pass

    # -- fallback ------------------------------------------------------------

    def _fallback(self, reason: str,
                  failed_seq: Optional[int] = None) -> None:
        """Gap/restart/crc -> full reload of the newest verified checkpoint,
        then re-subscribe from the stream's current base. ``failed_seq``
        (gap/crc only — a restart's new incarnation renumbers from scratch)
        pins the resume point PAST the offending batch: the missing or
        corrupt segment is permanent, so resuming at or before it would
        re-trigger the same fallback forever. The reload already re-based
        every row, so skipping the dead batch loses nothing durable."""
        self.fallbacks += 1
        rt = self.request_tracer
        ctx = None
        if rt is not None:
            try:
                ctx = rt.start("delta_fallback")
                ctx.mark_anomaly("fallback")  # tail-keep: always retrievable
                ctx.annotate(reason=reason, failed_seq=failed_seq,
                             next_seq=self.next_seq,
                             applied_seq=self.applied_seq)
            except Exception:
                ctx = None
        t_detect = time.perf_counter_ns()
        self._ledger_event({
            "phase": "detect",
            "reason": reason,
            "next_seq": self.next_seq,
            "applied_seq": self.applied_seq,
            "fallbacks": self.fallbacks,
        })
        detect_dur = time.perf_counter_ns() - t_detect
        version = None
        t_reload = reload_dur = 0
        if self.checkpoint_root and self.config is not None:
            t_reload = time.perf_counter_ns()
            version = self.target.reload_from_checkpoint(
                self.checkpoint_root, self.config)
            reload_dur = time.perf_counter_ns() - t_reload
            # a batch current as of a step the reload already covers must
            # not re-apply on top of the newer planes
            self.floor_step = int(getattr(self.target, "step", 0) or 0)
        self._pending.clear()
        self._row_seq.clear()  # the reload re-based every row
        prev = self.publisher
        self.publisher = None
        t_resub = time.perf_counter_ns()
        self.subscribe()
        if (failed_seq is not None and self.publisher is not None
                and self.publisher == prev):
            # same incarnation: its numbering still holds, so skip the dead
            # batch (a NEW incarnation renumbers — subscribe() already set
            # the right position from its base)
            later = [s for s in list_seqs(self.dir) if s > failed_seq]
            self.next_seq = max(
                self.next_seq, later[0] if later else failed_seq + 1)
        resub_dur = time.perf_counter_ns() - t_resub
        self._ledger_event({
            "phase": "fallback",
            "reason": reason,
            "recovered": True,
            "version": version,
            "resubscribed_seq": self.next_seq,
            "floor_step": self.floor_step,
        })
        if ctx is not None:
            try:
                ctx.add_span("detect", t_detect, detect_dur, reason=reason)
                if t_reload:
                    ctx.add_span("reload", t_reload, reload_dur,
                                 version=version)
                ctx.add_span("resubscribe", t_resub, resub_dur,
                             resubscribed_seq=self.next_seq)
                ctx.annotate(recovered=True, version=version,
                             resubscribed_seq=self.next_seq,
                             floor_step=self.floor_step)
                rt.finish(ctx)
            except Exception:
                pass

    def _ledger_event(self, record: Dict) -> None:
        if self.ledger is None:
            return
        try:
            self.ledger.append("freshness_gap",
                               {"source": "subscriber", **record})
        except Exception:
            pass  # record-keeping never blocks the serve path

    # -- background poll (the CLI's `subscribe <dir>`) -----------------------

    def start(self, interval_s: float = 0.05) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.wait(interval_s):
                try:
                    self.poll()
                except Exception:
                    pass  # the poller must survive transient I/O errors

        self._thread = threading.Thread(
            target=loop, name="ssn-freshness-poll", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=5.0)
        self._thread = None

    # -- introspection -------------------------------------------------------

    def status(self) -> Dict:
        with self._lock:
            lag = list(self._lag_ms)
            return {
                "dir": self.dir,
                "publisher": self.publisher,
                "base_step": self.base_step,
                "applied_seq": self.applied_seq,
                "applied_step": self.applied_step,
                "next_seq": self.next_seq,
                "pending": len(self._pending),
                "applied_batches": self.applied_batches,
                "applied_rows": self.applied_rows,
                "skipped_batches": self.skipped_batches,
                "duplicate_batches": self.duplicate_batches,
                "fallbacks": self.fallbacks,
                "gaps": self.gaps,
                "last_lag_ms": round(self.last_lag_ms, 3),
                "lag_p50_ms": round(_percentile(lag, 0.50), 3),
                "lag_p99_ms": round(_percentile(lag, 0.99), 3),
                "max_lag_ms": self.max_lag_ms,
                "stale": bool(self.max_lag_ms > 0
                              and self.last_lag_ms > self.max_lag_ms),
                "polling": self._thread is not None,
                **({"trace": self.request_tracer.stats()}
                   if self.request_tracer is not None else {}),
            }
