"""Structured per-step metrics.

The reference's only observability is glog text lines (SURVEY §5); this module
gives the new framework a real metrics surface: JSONL records to a file and/or
stdout, with per-window throughput derived from monotonic time.
"""

from __future__ import annotations

import json
import statistics
import sys
import time
from typing import Callable, Dict, IO, Optional

import torch


class MetricsLogger:
    """Append-only JSONL metrics writer with throughput windows."""

    def __init__(
        self,
        path: Optional[str] = None,
        stream: Optional[IO[str]] = None,
        echo: bool = False,
    ) -> None:
        self._file: Optional[IO[str]] = open(path, "a", encoding="utf-8") if path else None
        self._stream = stream
        self._echo = echo
        self._window_start = time.monotonic()
        self._window_items = 0

    def log(self, record: Dict) -> None:
        record = dict(record)
        record.setdefault("ts", time.time())
        line = json.dumps(record, sort_keys=True)
        if self._file is not None:
            self._file.write(line + "\n")
            self._file.flush()
        if self._stream is not None:
            self._stream.write(line + "\n")
        if self._echo:
            sys.stdout.write(line + "\n")
            sys.stdout.flush()

    # -- throughput windows ------------------------------------------------

    def count(self, n: int) -> None:
        """Add ``n`` processed items (words, examples) to the current window."""
        self._window_items += n

    def flush_window(self, **extra) -> Dict:
        """Emit a throughput record for the window and start a new one."""
        now = time.monotonic()
        dt = max(now - self._window_start, 1e-9)
        rec = {
            "items": self._window_items,
            "seconds": dt,
            "items_per_sec": self._window_items / dt,
        }
        rec.update(extra)
        self.log(rec)
        self._window_start = now
        self._window_items = 0
        return rec

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None

    def __enter__(self) -> "MetricsLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def time_ms(fn: Callable[[int], object], runs: int = 25, device="cuda") -> float:
    """Median time in ms of ``fn(i)`` for ``i`` in ``range(runs)``, after
    three warm-up runs. On a card (``device`` of type cuda): device time by CUDA
    events, a sleep kernel ahead of each run keeping the card busy while the
    host enqueues, so host launch latency is not counted. On the CPU: host
    time, which is no device number."""
    cuda = torch.device(device).type == "cuda"
    for i in range(3):
        fn(i)
    if cuda:
        torch.cuda.synchronize()
    times = []
    for i in range(runs):
        if not cuda:
            t0 = time.perf_counter()
            fn(i)
            times.append((time.perf_counter() - t0) * 1e3)
            continue
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)
        start.record()
        fn(i)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)
