"""Named counters / gauges / histograms behind pluggable sinks — the JAX
package's ``telemetry/registry.py``.

Replaces ad-hoc dict plumbing with one registry surface: any component takes
a :class:`MetricRegistry` (or reaches a shared one) and records against named
instruments; the owner decides when to :meth:`~MetricRegistry.flush` and to
which sinks. A sink is anything with ``log(record: dict)`` and ``close()`` —
:class:`swiftsnails_tpu_torch.utils.metrics.MetricsLogger` is the JSONL sink
unchanged, and :class:`StdoutSummarySink` renders the same records for a
terminal.
"""

from __future__ import annotations

import sys
import threading
import time
from collections import deque
from typing import Deque, Dict, IO, List, Optional


class Counter:
    """Monotonic count (steps, items, drops)."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """Last-set value (queue depth, learning rate).

    ``updated_at`` is the wall-clock of the last :meth:`set` (``None``
    until first set) — the timeseries sampler and the ``ops`` dashboard
    both read it to tell a live gauge from a stale one.
    """

    __slots__ = ("name", "_value", "_updated_at")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0
        self._updated_at: Optional[float] = None

    def set(self, value: float) -> None:
        self._value = float(value)
        self._updated_at = time.time()

    @property
    def value(self) -> float:
        return self._value

    @property
    def updated_at(self) -> Optional[float]:
        return self._updated_at


class Histogram:
    """Summary stats over observed samples (step latencies).

    Keeps exact count/sum/min/max plus a bounded window of recent samples for
    percentiles — enough for per-window records without unbounded memory.

    **Exemplars.** ``observe(value, trace_id=...)`` remembers a small window
    of traced observations; :meth:`summary` reports the slowest of them as
    ``exemplar_value`` / ``exemplar_trace_id``, so the ``p99`` in any report
    links to one concrete request trace instead of an anonymous aggregate.
    Only pass ids of traces that will actually be *kept* (head-sampled or
    anomalous), or the link dangles.
    """

    __slots__ = ("name", "count", "total", "min", "max", "_recent",
                 "_traced", "_lock")

    def __init__(self, name: str, window: int = 512):
        self.name = name
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self._recent: Deque[float] = deque(maxlen=window)
        self._traced: Deque = deque(maxlen=8)  # (value, trace_id) exemplars
        self._lock = threading.Lock()

    def observe(self, value: float, trace_id: Optional[str] = None) -> None:
        value = float(value)
        with self._lock:
            self.count += 1
            self.total += value
            if value < self.min:
                self.min = value
            if value > self.max:
                self.max = value
            self._recent.append(value)
            if trace_id is not None:
                self._traced.append((value, trace_id))

    def exemplar(self) -> Optional[Dict[str, float]]:
        """The slowest recent traced observation (tail exemplar), if any."""
        with self._lock:
            if not self._traced:
                return None
            value, trace_id = max(self._traced, key=lambda vt: vt[0])
        return {"value": value, "trace_id": trace_id}

    def summary(self) -> Dict[str, float]:
        with self._lock:
            if not self.count:
                return {"count": 0}
            recent = sorted(self._recent)
            q = lambda p: recent[min(int(p * (len(recent) - 1)), len(recent) - 1)]
            out = {
                "count": self.count,
                "sum": self.total,
                "mean": self.total / self.count,
                "min": self.min,
                "max": self.max,
                "p50": q(0.50),
                "p95": q(0.95),
                "p99": q(0.99),
            }
            if self._traced:
                value, trace_id = max(self._traced, key=lambda vt: vt[0])
                out["exemplar_value"] = value
                out["exemplar_trace_id"] = trace_id
            return out


class StdoutSummarySink:
    """Human-readable one-line rendering of each flushed record."""

    def __init__(self, stream: Optional[IO[str]] = None, prefix: str = "metrics"):
        self._stream = stream if stream is not None else sys.stdout
        self._prefix = prefix

    @staticmethod
    def _fmt(v) -> str:
        if isinstance(v, float):
            return f"{v:.6g}"
        return str(v)

    def log(self, record: Dict) -> None:
        body = "  ".join(
            f"{k}={self._fmt(v)}" for k, v in sorted(record.items()) if k != "ts"
        )
        self._stream.write(f"{self._prefix}: {body}\n")
        self._stream.flush()

    def close(self) -> None:
        pass


class MetricRegistry:
    """Get-or-create named instruments; flush snapshots to sinks."""

    def __init__(self, sinks: Optional[List] = None):
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}
        self._sinks: List = list(sinks or [])
        self._lock = threading.Lock()

    def add_sink(self, sink) -> None:
        self._sinks.append(sink)

    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter(name)
            return c

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge(name)
            return g

    def histogram(self, name: str) -> Histogram:
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram(name)
            return h

    def snapshot(self) -> Dict[str, float]:
        """Flat ``name -> value`` view (histograms expand to name.stat)."""
        out: Dict[str, float] = {}
        with self._lock:
            counters = list(self._counters.values())
            gauges = list(self._gauges.values())
            hists = list(self._histograms.values())
        for c in counters:
            out[c.name] = c.value
        for g in gauges:
            out[g.name] = g.value
        for h in hists:
            for stat, v in h.summary().items():
                out[f"{h.name}.{stat}"] = v
        return out

    def flush(self, **extra) -> Dict[str, float]:
        """Emit the current snapshot (+``extra`` fields) to every sink."""
        rec = self.snapshot()
        rec.update(extra)
        for sink in self._sinks:
            sink.log(rec)
        return rec

    def close(self) -> None:
        for sink in self._sinks:
            sink.close()
