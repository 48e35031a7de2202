"""Bounded ring time-series store: continuous profiling off the hot path —
the JAX package's ``telemetry/timeseries.py``.

The bench and ledger capture *point-in-time* records; the blackbox captures
the *last N steps* for post-mortems. What neither gives is the shape of a
run while it happens — did the host-blocked fraction creep up over the last
thousand steps, did the flush queue start backing up at step 40k? This
module is that middle layer: a :class:`TimeSeriesStore` holds a bounded
ring of periodic samples (every registry metric via
``MetricRegistry.snapshot()``, the per-step goodput decomposition, the
tiered breakdown, comm-audit bytes per scope), the TrainLoop feeds it at a
configurable cadence (``profile_cadence`` steps, ``0`` = off), and the
store renders three ways:

* ``export_jsonl(path)`` — one JSON object per sample, for offline tools;
* ``summary(max_points=...)`` — a bounded, downsampled block embedded in
  the run record so ``ledger-report`` / ``ops`` can draw sparklines from
  the ledger alone;
* :func:`sparkline` — the terminal rendering primitive both use.

Everything is plain host-side Python over already-recorded numbers: the
only hot-path cost is the cadence check the loop already pays, and a dict
copy every ``profile_cadence`` steps. The ring is bounded
(``profile_window`` samples), so a week-long run holds a sliding window,
not an unbounded log.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

_SPARK_CHARS = "▁▂▃▄▅▆▇█"


def sparkline(values: Sequence[float], width: int = 32) -> str:
    """Render a numeric sequence as a unicode sparkline.

    Non-finite values render as ``·``; a flat series renders as all-low
    bars rather than dividing by zero. ``width`` caps the output by
    piecewise-averaging (not truncating) so the whole window stays visible.
    The scale is clamped to the p5..p95 band (values outside clamp to the
    extreme bars): one outlier — the jit-compile first step — must not
    flatten the rest of the series into invisibility.
    """
    vals = [float(v) for v in values]
    if not vals:
        return ""
    if width and len(vals) > width:
        vals = downsample(vals, width)
    finite = [v for v in vals if v == v and v not in (float("inf"), float("-inf"))]
    if not finite:
        return "·" * len(vals)
    ranked = sorted(finite)
    lo = ranked[int(0.05 * (len(ranked) - 1))]
    hi = ranked[int(0.95 * (len(ranked) - 1) + 0.5)]
    span = hi - lo
    out = []
    for v in vals:
        if not (v == v) or v in (float("inf"), float("-inf")):
            out.append("·")
            continue
        if span <= 0:
            out.append(_SPARK_CHARS[0])
            continue
        idx = int((v - lo) / span * (len(_SPARK_CHARS) - 1) + 0.5)
        out.append(_SPARK_CHARS[max(0, min(idx, len(_SPARK_CHARS) - 1))])
    return "".join(out)


def downsample(values: Sequence[float], n: int) -> List[float]:
    """Piecewise-mean downsample to at most ``n`` points (order-preserving)."""
    vals = [float(v) for v in values]
    if n <= 0 or len(vals) <= n:
        return vals
    out: List[float] = []
    for i in range(n):
        lo = i * len(vals) // n
        hi = max((i + 1) * len(vals) // n, lo + 1)
        chunk = [v for v in vals[lo:hi] if v == v]
        out.append(sum(chunk) / len(chunk) if chunk else float("nan"))
    return out


class TimeSeriesStore:
    """Bounded ring of periodic metric samples.

    Each sample is a flat ``name -> float`` dict plus ``step`` and ``ts``.
    Thread-safe: the sampler runs on the training thread, readers
    (``ops``, export) may run elsewhere.
    """

    def __init__(self, window: int = 512):
        self.window = int(window)
        self._ring: Deque[Dict] = deque(maxlen=max(self.window, 1))
        self._lock = threading.Lock()

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def sample(self, step: int, metrics: Dict, ts: Optional[float] = None) -> None:
        """Record one sample. Non-numeric values are dropped (a registry
        snapshot can carry exemplar trace-id strings)."""
        rec: Dict = {"step": int(step), "ts": float(ts if ts is not None else time.time())}
        for k, v in metrics.items():
            if isinstance(v, bool):
                rec[k] = float(v)
            elif isinstance(v, (int, float)):
                rec[k] = float(v)
        with self._lock:
            self._ring.append(rec)

    def snapshot(self) -> List[Dict]:
        """The current window, oldest first (copies — safe to mutate)."""
        with self._lock:
            return [dict(r) for r in self._ring]

    def latest(self) -> Optional[Dict]:
        with self._lock:
            return dict(self._ring[-1]) if self._ring else None

    def series(self, name: str) -> Tuple[List[int], List[float]]:
        """(steps, values) for one metric across the window (samples that
        lack the metric are skipped, not zero-filled)."""
        steps: List[int] = []
        vals: List[float] = []
        with self._lock:
            for r in self._ring:
                if name in r:
                    steps.append(r["step"])
                    vals.append(r[name])
        return steps, vals

    def names(self) -> List[str]:
        """All metric names seen anywhere in the window, sorted."""
        seen = set()
        with self._lock:
            for r in self._ring:
                seen.update(r)
        seen.discard("step")
        seen.discard("ts")
        return sorted(seen)

    def export_jsonl(self, path) -> int:
        """Write the window as JSONL (atomic via the ledger helper).

        Returns the number of samples written.
        """
        from .ledger import atomic_write_bytes

        rows = self.snapshot()
        body = "".join(json.dumps(r, sort_keys=True) + "\n" for r in rows)
        atomic_write_bytes(path, body.encode("utf-8"))
        return len(rows)

    def summary(self, max_points: int = 40,
                names: Optional[Sequence[str]] = None) -> Dict:
        """Bounded block for embedding in a run record.

        ``{"window": N, "first_step": s0, "last_step": s1,
        "series": {name: [<=max_points floats]}}`` — enough for sparklines
        from the ledger alone, small enough to live in every run record.
        """
        # shallow refs, not snapshot(): samples are write-once, and this
        # runs in run finalization where a 512-row deep copy is real cost
        with self._lock:
            rows = list(self._ring)
        if not rows:
            return {"window": 0, "series": {}}
        if names is not None:
            wanted = list(names)
        else:
            seen: set = set()
            for r in rows:
                seen.update(r)
            seen.discard("step")
            seen.discard("ts")
            wanted = sorted(seen)
        series: Dict[str, List[float]] = {}
        for name in wanted:
            vals = [r[name] for r in rows if name in r]
            if vals:
                series[name] = [round(v, 6) for v in downsample(vals, max_points)]
        return {
            "window": len(rows),
            "first_step": rows[0]["step"],
            "last_step": rows[-1]["step"],
            "series": series,
        }


def render_sparklines(summary: Dict, names: Optional[Sequence[str]] = None,
                      width: int = 32, indent: str = "  ") -> List[str]:
    """Terminal lines for a :meth:`TimeSeriesStore.summary` block (also
    accepts the block re-read from a ledger record). Shared by
    ``ledger-report`` and the ``ops`` dashboard training section."""
    if not summary or not summary.get("series"):
        return []
    series = summary["series"]
    wanted = [n for n in (names or sorted(series))]
    label_w = max((len(n) for n in wanted if n in series), default=0)
    lines: List[str] = []
    for name in wanted:
        vals = series.get(name)
        if not vals:
            continue
        last = vals[-1]
        lines.append(
            f"{indent}{name:<{label_w}}  {sparkline(vals, width)}  "
            f"last={last:.6g}")
    return lines
