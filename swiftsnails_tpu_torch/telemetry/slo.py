"""Windowed SLO tracking: availability + latency objectives per kernel,

The JAX package's ``telemetry/slo.py``, copied: it is pure Python.
multi-window burn-rate alerting, and the error budget the future
autoscaler will spend.

One :class:`SloTracker` watches the serving plane. Every request is
recorded as *good* or *bad* — bad means it raised a typed failure **or**
came back over the kernel's latency objective, the unified treatment: both
spend the same error budget. Two sliding windows are kept per kernel:

* the **long** window (``slo_window_s``) — the budget horizon;
* the **short** window (``slo_window_s / 12``) — the classic fast-burn
  companion (5m against 1h), so a sudden fire alerts in seconds while a
  slow leak still needs sustained evidence.

The *burn rate* is ``bad_fraction / (1 - availability)``: 1.0 spends the
budget exactly by the end of the window; the tracker alerts when **both**
windows burn at ``alert_burn`` or faster (two windows is what keeps a
single stray request from paging). Entering the alerting state emits one
structured ``slo_burn`` ledger event (transition-edged, so a sustained
burn is one line, not a line per request), and :meth:`should_scale` is
the hook the autoscaler will poll: it fires while any kernel is alerting
or has exhausted its budget.

The clock is injectable (``clock=``) so burn-rate math is testable with a
fake clock; recording is lock-guarded and O(1) amortized — record-keeping
never blocks the serve path.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Optional

__all__ = ["SloObjective", "SloTracker"]

# Short window = long window / 12, the 5m-vs-1h ratio scaled to whatever
# horizon the config picks.
_SHORT_DIV = 12.0
_DEFAULT_WINDOW_S = 60.0
_DEFAULT_ALERT_BURN = 2.0


class SloObjective:
    """One kernel's objectives: latency bound and availability target."""

    __slots__ = ("latency_ms", "availability")

    def __init__(self, latency_ms: float, availability: float = 0.999):
        if not 0.0 < availability < 1.0:
            raise ValueError(f"availability must be in (0, 1): {availability}")
        self.latency_ms = float(latency_ms)
        self.availability = float(availability)

    @property
    def budget(self) -> float:
        """The error budget: the tolerated bad fraction."""
        return 1.0 - self.availability


class SloTracker:
    """Sliding-window burn-rate tracker over per-kernel objectives.

    ``objectives`` maps kernel name to an :class:`SloObjective` (or a
    ``(latency_ms, availability)`` tuple, or a bare latency float with the
    default availability). Unknown kernels recorded later are tracked
    against ``default`` when given, else ignored.
    """

    def __init__(
        self,
        objectives: Dict[str, Any],
        *,
        window_s: float = _DEFAULT_WINDOW_S,
        alert_burn: float = _DEFAULT_ALERT_BURN,
        default: Optional[SloObjective] = None,
        ledger=None,
        source: str = "serving",
        clock: Callable[[], float] = time.monotonic,
    ):
        self.window_s = float(window_s)
        self.short_s = self.window_s / _SHORT_DIV
        self.alert_burn = float(alert_burn)
        self.default = default
        self.ledger = ledger
        self.source = source
        self._clock = clock
        self._lock = threading.Lock()
        self.objectives: Dict[str, SloObjective] = {}
        for k, v in objectives.items():
            self.objectives[k] = self._coerce(v)
        # per-kernel: deque of (ts, bad) pairs, pruned past the long window
        self._events: Dict[str, deque] = {k: deque() for k in self.objectives}
        self._alerting: Dict[str, bool] = {k: False for k in self.objectives}
        self._burn_events = 0
        self._recorded = 0
        self._scale_hinted = False
        self._scale_hints = 0

    @classmethod
    def from_config(cls, config, *, ledger=None,
                    clock: Callable[[], float] = time.monotonic,
                    kernels=("pull", "topk", "score"),
                    source: str = "serving") -> Optional["SloTracker"]:
        """Build from typed config keys, or ``None`` when no latency
        objective is set (``slo_latency_ms`` <= 0 disables tracking)."""
        lat = config.get_float("slo_latency_ms", 0.0)
        if lat <= 0:
            return None
        obj = SloObjective(lat, config.get_float("slo_availability", 0.999))
        return cls(
            {k: obj for k in kernels},
            window_s=config.get_float("slo_window_s", _DEFAULT_WINDOW_S),
            default=obj, ledger=ledger, source=source, clock=clock,
        )

    @staticmethod
    def _coerce(v: Any) -> SloObjective:
        if isinstance(v, SloObjective):
            return v
        if isinstance(v, (tuple, list)):
            return SloObjective(*v)
        return SloObjective(float(v))

    # -- recording -------------------------------------------------------

    def record(self, kernel: str, latency_ms: float, ok: bool = True) -> None:
        """Record one request outcome; bad = failed or over latency SLO."""
        obj = self.objectives.get(kernel)
        if obj is None:
            if self.default is None:
                return
            obj = self.default
            with self._lock:
                self.objectives.setdefault(kernel, obj)
                self._events.setdefault(kernel, deque())
                self._alerting.setdefault(kernel, False)
        now = self._clock()
        bad = (not ok) or (float(latency_ms) > obj.latency_ms)
        with self._lock:
            ev = self._events[kernel]
            ev.append((now, bad))
            self._prune(ev, now)
            self._recorded += 1
            burn_s, burn_l = self._burns(kernel, now)
            alerting = (burn_s >= self.alert_burn
                        and burn_l >= self.alert_burn)
            entered = alerting and not self._alerting[kernel]
            self._alerting[kernel] = alerting
        if entered:
            self._note_burn(kernel, burn_s, burn_l, now)

    def _prune(self, ev: deque, now: float) -> None:
        horizon = now - self.window_s
        while ev and ev[0][0] < horizon:
            ev.popleft()

    # -- burn math (callers hold no lock; internal helpers assume it) ----

    def _window_counts(self, kernel: str, now: float, span_s: float):
        horizon = now - span_s
        total = bad = 0
        for ts, b in self._events.get(kernel, ()):
            if ts >= horizon:
                total += 1
                if b:
                    bad += 1
        return total, bad

    def _burns(self, kernel: str, now: float):
        obj = self.objectives[kernel]
        out = []
        for span in (self.short_s, self.window_s):
            total, bad = self._window_counts(kernel, now, span)
            out.append((bad / total) / obj.budget if total else 0.0)
        return out[0], out[1]

    def burn_rates(self, kernel: str) -> Dict[str, float]:
        """Current short/long burn rates (1.0 = budget gone by window end)."""
        now = self._clock()
        with self._lock:
            if kernel not in self.objectives:
                return {"short": 0.0, "long": 0.0}
            s, l = self._burns(kernel, now)
        return {"short": round(s, 4), "long": round(l, 4)}

    def error_budget_remaining(self, kernel: str) -> float:
        """Fraction of the long-window error budget left, in [0, 1]."""
        now = self._clock()
        with self._lock:
            obj = self.objectives.get(kernel)
            if obj is None:
                return 1.0
            total, bad = self._window_counts(kernel, now, self.window_s)
        if not total:
            return 1.0
        allowed = obj.budget * total
        if allowed <= 0:
            return 0.0 if bad else 1.0
        return max(0.0, min(1.0, 1.0 - bad / allowed))

    # -- surfaces --------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """Per-kernel state for the ops dashboard."""
        now = self._clock()
        out: Dict[str, Any] = {}
        with self._lock:
            kernels = list(self.objectives)
        for k in kernels:
            with self._lock:
                obj = self.objectives[k]
                total, bad = self._window_counts(k, now, self.window_s)
                s, l = self._burns(k, now)
                alerting = self._alerting[k]
            allowed = obj.budget * total
            remaining = (1.0 if not total else
                         max(0.0, min(1.0, 1.0 - bad / allowed))
                         if allowed > 0 else (0.0 if bad else 1.0))
            out[k] = {
                "slo_latency_ms": obj.latency_ms,
                "slo_availability": obj.availability,
                "window_s": self.window_s,
                "total": total,
                "bad": bad,
                "burn_short": round(s, 4),
                "burn_long": round(l, 4),
                "budget_remaining_pct": round(remaining * 100.0, 2),
                "alerting": alerting,
            }
        return out

    def should_scale(self) -> bool:
        """The autoscaler hook: True while any kernel is alerting or has
        spent its whole long-window budget.

        Transition-edged like the burn alert: the False->True crossing
        appends one ``scale_hint`` ledger event naming the kernels that
        want capacity (the ``ops`` dashboard's ``SCALE-UP?`` advisory and
        the future autoscaler both read it); sustained pressure is one
        line, and the edge re-arms once the pressure clears."""
        now = self._clock()
        wanting = []
        with self._lock:
            for k in self.objectives:
                if self._alerting.get(k):
                    wanting.append(k)
                    continue
                obj = self.objectives[k]
                total, bad = self._window_counts(k, now, self.window_s)
                # budget fully spent counts even after the burn cooled off
                if total and obj.budget > 0 and bad >= obj.budget * total:
                    wanting.append(k)
            entered = bool(wanting) and not self._scale_hinted
            self._scale_hinted = bool(wanting)
            if entered:
                self._scale_hints += 1
        if entered:
            self._note_scale_hint(wanting)
        return bool(wanting)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"recorded": self._recorded,
                    "burn_events": self._burn_events,
                    "scale_hints": self._scale_hints}

    # -- ledger ----------------------------------------------------------

    def _note_burn(self, kernel: str, burn_s: float, burn_l: float,
                   now: float) -> None:
        with self._lock:
            self._burn_events += 1
        led = self.ledger
        if led is None:
            return
        obj = self.objectives[kernel]
        try:
            led.append("slo_burn", {
                "source": self.source,
                "kernel": kernel,
                "burn_short": round(burn_s, 3),
                "burn_long": round(burn_l, 3),
                "alert_burn": self.alert_burn,
                "budget_remaining_pct": round(
                    self.error_budget_remaining(kernel) * 100.0, 2),
                "slo_latency_ms": obj.latency_ms,
                "slo_availability": obj.availability,
                "window_s": self.window_s,
            })
        except Exception:
            pass  # record-keeping never blocks the serve path

    def _note_scale_hint(self, kernels) -> None:
        led = self.ledger
        if led is None:
            return
        try:
            led.append("scale_hint", {
                "source": self.source,
                "kernels": sorted(kernels),
                "burns": {k: self.burn_rates(k) for k in kernels},
                "budget_remaining_pct": {
                    k: round(self.error_budget_remaining(k) * 100.0, 2)
                    for k in kernels
                },
                "window_s": self.window_s,
            })
        except Exception:
            pass  # advisory only — never blocks the serve path
