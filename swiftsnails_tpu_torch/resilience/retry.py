"""Unified retry/deadline layer for every fallible host-side I/O path — the
JAX package's ``resilience/retry.py``, pure Python.

One policy object replaces the ad-hoc per-site loops (the old
``_RetryingStream`` 3x loop, the checkpoint restore try/except, the tier
flush fail-fast): exponential backoff with *decorrelated jitter* (each
sleep is drawn from ``uniform(base, prev * 3)`` capped at ``cap`` — the
AWS-style schedule that avoids retry synchronization across workers),
bounded by both an attempt budget and a wall-clock deadline, whichever
runs out first.

Everything that can tick or sleep is injectable (``clock`` / ``sleep`` /
seeded ``rng``) so tests drive the schedule with a fake clock and assert
exact backoff bounds without real sleeping. Every exhausted budget is a
structured ``retry_exhausted`` ledger event when a ledger is attached — a
retry loop that gives up silently is an outage with no black box. In the
port the data stream of the resilient training path and the checkpoint
writes use it.

Config keys (all optional):

* ``retry_max_attempts`` — total tries per operation (default 4, i.e. one
  initial try + three retries, matching the old stream loop);
* ``retry_deadline_ms``  — wall-clock budget per operation (default 30000);
* ``retry_base_ms``      — first backoff draw lower bound (default 25);
* ``retry_cap_ms``       — backoff upper clamp (default 2000).
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass, field
from typing import Callable, Iterator, Optional, Tuple, Type

__all__ = [
    "Deadline",
    "DeadlineExceeded",
    "RetryBudget",
    "RetryExhausted",
    "RetryPolicy",
    "RetryingIterator",
    "retry_call",
]


class RetryExhausted(RuntimeError):
    """Raised when an operation's retry budget (attempts or deadline) is
    spent. Chains from the last underlying error via ``__cause__``."""

    def __init__(self, op: str, attempts: int, elapsed_ms: float,
                 reason: str, last_error: Optional[BaseException] = None):
        msg = (f"{op}: retry budget exhausted after {attempts} attempt(s) "
               f"in {elapsed_ms:.0f} ms ({reason})")
        if last_error is not None:
            msg += f"; last error: {type(last_error).__name__}: {last_error}"
        super().__init__(msg)
        self.op = op
        self.attempts = attempts
        self.elapsed_ms = elapsed_ms
        self.reason = reason
        self.last_error = last_error


class DeadlineExceeded(RetryExhausted):
    """The wall-clock deadline ran out (possibly before the attempt budget)."""


@dataclass
class Deadline:
    """A wall-clock budget pinned at creation. ``clock`` is injectable and
    must be monotonic-like (seconds as float)."""

    expires_at: float
    clock: Callable[[], float] = time.monotonic

    @classmethod
    def after_ms(cls, ms: float,
                 clock: Callable[[], float] = time.monotonic) -> "Deadline":
        return cls(expires_at=clock() + ms / 1000.0, clock=clock)

    def remaining(self) -> float:
        """Seconds left, clamped at zero."""
        return max(0.0, self.expires_at - self.clock())

    @property
    def expired(self) -> bool:
        return self.clock() >= self.expires_at

    def check(self, op: str = "operation", attempts: int = 0,
              started: Optional[float] = None) -> None:
        if self.expired:
            elapsed = 0.0 if started is None else (self.clock() - started) * 1e3
            raise DeadlineExceeded(op, attempts, elapsed, "deadline")


@dataclass
class RetryBudget:
    """Attempt counter: ``max_attempts`` total tries (first try included)."""

    max_attempts: int
    used: int = 0

    def spend(self) -> bool:
        """Consume one attempt; True while tries remain."""
        self.used += 1
        return self.used <= self.max_attempts

    @property
    def exhausted(self) -> bool:
        return self.used >= self.max_attempts

    @property
    def remaining(self) -> int:
        return max(0, self.max_attempts - self.used)


@dataclass
class RetryPolicy:
    """The reusable knob bundle. One policy serves many operations; each
    :meth:`call` gets a fresh :class:`RetryBudget` + :class:`Deadline`."""

    max_attempts: int = 4
    deadline_ms: float = 30_000.0
    base_ms: float = 25.0
    cap_ms: float = 2_000.0
    retry_on: Tuple[Type[BaseException], ...] = (OSError,)
    clock: Callable[[], float] = time.monotonic
    sleep: Callable[[float], None] = time.sleep
    rng: random.Random = field(default_factory=lambda: random.Random(0))
    ledger = None  # duck-typed: needs .append(kind, record)

    @classmethod
    def from_config(cls, cfg, ledger=None, **overrides) -> "RetryPolicy":
        kw = dict(
            max_attempts=cfg.get_int("retry_max_attempts", 4),
            deadline_ms=cfg.get_float("retry_deadline_ms", 30_000.0),
            base_ms=cfg.get_float("retry_base_ms", 25.0),
            cap_ms=cfg.get_float("retry_cap_ms", 2_000.0),
        )
        kw.update(overrides)
        pol = cls(**kw)
        pol.ledger = ledger
        return pol

    def deadline(self) -> Deadline:
        return Deadline.after_ms(self.deadline_ms, clock=self.clock)

    def budget(self) -> RetryBudget:
        return RetryBudget(max_attempts=self.max_attempts)

    def next_backoff_s(self, prev_s: Optional[float]) -> float:
        """Decorrelated jitter: uniform(base, prev*3) clamped to [base, cap].
        The first draw uses ``prev = base``."""
        base = self.base_ms / 1000.0
        cap = self.cap_ms / 1000.0
        prev = base if prev_s is None else prev_s
        hi = max(base, min(cap, prev * 3.0))
        return self.rng.uniform(base, hi)

    # -- the loop -------------------------------------------------------------

    def call(self, fn: Callable, *args, op: str = "operation",
             on_retry: Optional[Callable] = None,
             extra: Optional[dict] = None, **kwargs):
        """Run ``fn(*args, **kwargs)`` under this policy. Exceptions matching
        ``retry_on`` are retried with backoff until the attempt budget or the
        deadline runs out; anything else propagates immediately. Exhaustion
        raises :class:`RetryExhausted` (or :class:`DeadlineExceeded`) and —
        when a ledger is attached — appends a ``retry_exhausted`` event
        (``extra`` fields merge into that record)."""
        budget = self.budget()
        deadline = self.deadline()
        started = self.clock()
        backoff: Optional[float] = None
        last: Optional[BaseException] = None
        while True:
            budget.spend()
            try:
                return fn(*args, **kwargs)
            except self.retry_on as e:  # noqa: PERF203 — the whole point
                last = e
                elapsed_ms = (self.clock() - started) * 1e3
                if budget.exhausted:
                    self._give_up(op, budget.used, elapsed_ms, "attempts", e,
                                  extra)
                backoff = self.next_backoff_s(backoff)
                if deadline.remaining() < backoff:
                    self._give_up(op, budget.used, elapsed_ms, "deadline", e,
                                  extra)
                if on_retry is not None:
                    on_retry(e, budget.used, backoff)
                self.sleep(backoff)

    def _give_up(self, op: str, attempts: int, elapsed_ms: float,
                 reason: str, err: BaseException,
                 extra: Optional[dict] = None) -> None:
        exc_cls = DeadlineExceeded if reason == "deadline" else RetryExhausted
        exc = exc_cls(op, attempts, elapsed_ms, reason, err)
        if self.ledger is not None:
            try:
                record = {
                    "op": op,
                    "attempts": attempts,
                    "elapsed_ms": round(elapsed_ms, 3),
                    "reason": reason,
                    "error": f"{type(err).__name__}: {err}",
                }
                if extra:
                    record.update(extra)
                self.ledger.append("retry_exhausted", record)
            except Exception:
                pass  # bookkeeping never fails the failure path
        raise exc from err


def retry_call(fn: Callable, *args, policy: Optional[RetryPolicy] = None,
               op: str = "operation", **kwargs):
    """Module-level convenience: ``retry_call(f, x, policy=p, op="load")``."""
    return (policy or RetryPolicy()).call(fn, *args, op=op, **kwargs)


class RetryingIterator:
    """Iterator adapter built on :class:`RetryPolicy` — replaces the old
    ``_RetryingStream`` hardcoded 3x loop. Each fetch gets a fresh attempt
    budget + deadline; ``StopIteration`` always passes through untouched.
    ``on_error(exc, attempt, recovered)`` keeps the old callback shape so
    existing counters/ledger hooks plug straight in."""

    def __init__(self, inner: Iterator, policy: RetryPolicy,
                 on_error: Optional[Callable] = None, op: str = "data_stream"):
        self._inner = inner
        self.policy = policy
        self._on_error = on_error
        self.op = op
        self.retried = 0

    def __iter__(self) -> "RetryingIterator":
        return self

    def __next__(self):
        def _fetch():
            return next(self._inner)

        def _note(exc, attempt, backoff):
            self.retried += 1
            if self._on_error is not None:
                self._on_error(exc, attempt - 1, True)

        try:
            return self.policy.call(_fetch, op=self.op, on_retry=_note)
        except RetryExhausted as e:
            self.retried += 1
            if self._on_error is not None and e.last_error is not None:
                self._on_error(e.last_error, e.attempts - 1, False)
            if e.last_error is not None:
                raise e.last_error from e
            raise
