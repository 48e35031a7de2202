"""Structured per-step metrics.

The reference's only observability is glog text lines (SURVEY §5); this module
gives the new framework a real metrics surface: JSONL records to a file and/or
stdout, with per-window throughput derived from monotonic time.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Dict, IO, Optional


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
