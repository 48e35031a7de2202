"""Monotonic stopwatch (reference ``src/utils/Timer.h``: chrono stopwatch
with timeout) — the JAX package's ``utils/timer.py``, kept as the port's
own copy."""

from __future__ import annotations

import time


class Timer:
    def __init__(self, timeout_s: float = 0.0) -> None:
        self._timeout = timeout_s
        self._start = time.monotonic()

    def restart(self) -> None:
        self._start = time.monotonic()

    def elapsed(self) -> float:
        return time.monotonic() - self._start

    def timeout(self) -> bool:
        return self._timeout > 0 and self.elapsed() >= self._timeout
