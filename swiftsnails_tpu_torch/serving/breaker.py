"""Per-kernel circuit breakers for the serving read path.

The JAX package's ``serving/breaker.py``, copied: it is pure Python.

The reference parameter server stays up by *failing fast*: a worker whose
RPC target is sick stops hammering it and retries elsewhere. The serving
engine's equivalent is a classic closed / open / half-open breaker per
kernel (``pull`` / ``topk`` / ``score``):

* **closed** — healthy. Dispatch failures increment a consecutive-failure
  count; ``threshold`` of them in a row trips the breaker open.
* **open** — the kernel is presumed sick; no dispatch is attempted until
  ``cooldown_ms`` elapses. Pull traffic is served DEGRADED from the hot-row
  LRU (counted separately, never mixed into fresh counters); anything that
  cannot be degraded sheds with a typed :class:`Unavailable` instead of
  queuing up behind a dead kernel.
* **half-open** — cooldown expired; up to ``halfopen_probes`` in-flight
  requests are let through as probes. A probe success closes the breaker
  (recovery — the trip→close latency is recorded), a probe failure re-opens
  it for another cooldown.

``clock`` is injectable so tests drive the cooldown without sleeping. Every
state transition can be observed via ``on_transition(name, old, new,
snapshot)`` — the Servant turns these into structured ``breaker`` ledger
events.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional

__all__ = ["CircuitBreaker", "Unavailable", "CLOSED", "OPEN", "HALF_OPEN"]

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class Unavailable(RuntimeError):
    """The kernel's breaker is open and the request could not be served
    degraded: shed immediately, do not retry against the sick kernel."""


class CircuitBreaker:
    """Thread-safe closed/open/half-open breaker (see module docstring)."""

    def __init__(
        self,
        name: str,
        threshold: int = 5,
        cooldown_ms: float = 1_000.0,
        halfopen_probes: int = 1,
        clock: Callable[[], float] = time.monotonic,
        on_transition: Optional[Callable] = None,
    ):
        self.name = name
        self.threshold = max(int(threshold), 1)
        self.cooldown_s = float(cooldown_ms) / 1000.0
        self.halfopen_probes = max(int(halfopen_probes), 1)
        self.clock = clock
        self.on_transition = on_transition
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive = 0
        self._opened_at: Optional[float] = None
        self._tripped_at: Optional[float] = None  # first trip of this episode
        self._probes_inflight = 0
        self.trips = 0
        self.recoveries = 0
        self.open_sheds = 0  # allow() == False while open
        self.last_recovery_latency_ms: Optional[float] = None

    # -- state machine -------------------------------------------------------

    def _transition(self, new: str) -> None:
        old = self._state
        if old == new:
            return
        self._state = new
        if self.on_transition is not None:
            try:
                self.on_transition(self.name, old, new, self.snapshot())
            except Exception:
                pass  # observers never break the serve path

    def allow(self) -> bool:
        """May a dispatch be attempted right now? Open→half-open happens
        here once the cooldown has elapsed; half-open admits at most
        ``halfopen_probes`` concurrent probes."""
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._state == OPEN:
                if self.clock() - self._opened_at >= self.cooldown_s:
                    self._transition(HALF_OPEN)
                    self._probes_inflight = 1
                    return True
                self.open_sheds += 1
                return False
            # HALF_OPEN
            if self._probes_inflight < self.halfopen_probes:
                self._probes_inflight += 1
                return True
            self.open_sheds += 1
            return False

    def record_success(self) -> None:
        with self._lock:
            self._consecutive = 0
            if self._state == HALF_OPEN:
                self._probes_inflight = max(self._probes_inflight - 1, 0)
                if self._tripped_at is not None:
                    self.last_recovery_latency_ms = (
                        (self.clock() - self._tripped_at) * 1e3)
                self.recoveries += 1
                self._opened_at = None
                self._tripped_at = None
                self._transition(CLOSED)

    def record_failure(self) -> None:
        with self._lock:
            if self._state == HALF_OPEN:
                # the probe found the kernel still sick: re-open, new cooldown
                self._probes_inflight = max(self._probes_inflight - 1, 0)
                self._opened_at = self.clock()
                self._transition(OPEN)
                return
            self._consecutive += 1
            if self._state == CLOSED and self._consecutive >= self.threshold:
                self.trips += 1
                now = self.clock()
                self._opened_at = now
                self._tripped_at = now
                self._transition(OPEN)

    # -- introspection -------------------------------------------------------

    @property
    def state(self) -> str:
        """Current state; open→half-open promotion happens lazily in
        :meth:`allow`, so a cooled-down breaker still reads ``open`` here
        until the next request probes it."""
        with self._lock:
            return self._state

    def snapshot(self) -> Dict:
        # called with or without the lock held (on_transition fires inside
        # it) — reads of ints/strs are atomic enough for a status report
        open_for_ms = None
        if self._opened_at is not None:
            open_for_ms = round((self.clock() - self._opened_at) * 1e3, 3)
        return {
            "state": self._state,
            "consecutive_failures": self._consecutive,
            "threshold": self.threshold,
            "cooldown_ms": round(self.cooldown_s * 1e3, 3),
            "trips": self.trips,
            "recoveries": self.recoveries,
            "open_sheds": self.open_sheds,
            "open_for_ms": open_for_ms,
            "last_recovery_latency_ms": (
                round(self.last_recovery_latency_ms, 3)
                if self.last_recovery_latency_ms is not None else None),
        }
