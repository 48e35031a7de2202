"""LRU hot-row cache keyed on table version.

The JAX package's ``serving/cache.py``, copied: it is pure Python and numpy.

Zipf traffic concentrates on head keys; serving them from a host-side LRU
short-circuits the device pull (and, under a mesh, the collective) entirely.
Correctness rules:

* Entries are keyed ``(table_name, row_id)`` and stamped with the table
  **version** the row was pulled at. A version bump (table reload) makes
  every older entry a miss — stale rows can never be served *fresh* after a
  reload. They stay in the LRU though (overwritten by the next fresh pull or
  aged out by capacity): :meth:`HotRowCache.get_stale` reads them for
  DEGRADED serves when the pull kernel's circuit breaker is open.
* The micro-batcher's pad sentinel (row id 0 in the pad tail) must never be
  inserted: the engine only inserts the rows of *real* requests, and
  ``put`` additionally drops rows explicitly flagged as padding.

Thread-safe: the servant's dispatcher inserts while request threads read.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np


class HotRowCache:
    """Bounded LRU of ``(table, row) -> (version, row_values)``."""

    def __init__(self, capacity_rows: int):
        self.capacity = int(capacity_rows)
        self._rows: "OrderedDict[Tuple[str, int], Tuple[int, np.ndarray]]" = (
            OrderedDict()
        )
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._rows)

    def get_many(
        self, table: str, version: int, ids: np.ndarray
    ) -> Tuple[Dict[int, np.ndarray], List[int]]:
        """(found id -> row, missing ids). Counts one hit/miss per id."""
        if self.capacity <= 0:
            self.misses += len(ids)
            return {}, [int(i) for i in ids]
        found: Dict[int, np.ndarray] = {}
        missing: List[int] = []
        with self._lock:
            for i in ids:
                i = int(i)
                entry = self._rows.get((table, i))
                if entry is not None and entry[0] == version:
                    self._rows.move_to_end((table, i))
                    found[i] = entry[1]
                    self.hits += 1
                else:
                    # A version-stale entry is a miss but is NOT evicted: it
                    # is the inventory for degraded reads (breaker open after
                    # a reload). The fresh put overwrites it; otherwise plain
                    # LRU pressure ages it out.
                    missing.append(i)
                    self.misses += 1
        return found, missing

    def put_many(
        self,
        table: str,
        version: int,
        ids: np.ndarray,
        rows: np.ndarray,
        pad_mask: Optional[np.ndarray] = None,
    ) -> int:
        """Insert pulled rows; returns how many were admitted.

        ``pad_mask`` marks micro-batch padding rows (sentinel id 0) — those
        are dropped here as a second line of defense even if a caller hands
        the full padded batch over.
        """
        if self.capacity <= 0:
            return 0
        admitted = 0
        with self._lock:
            for n, i in enumerate(ids):
                if pad_mask is not None and pad_mask[n]:
                    continue
                key = (table, int(i))
                self._rows[key] = (int(version), np.asarray(rows[n]))
                self._rows.move_to_end(key)
                admitted += 1
            while len(self._rows) > self.capacity:
                self._rows.popitem(last=False)
        return admitted

    def get_stale(
        self, table: str, ids: np.ndarray
    ) -> Tuple[Dict[int, np.ndarray], List[int]]:
        """Version-agnostic, side-effect-free peek for DEGRADED reads only
        (circuit breaker open / kernel dispatch failed): returns whatever the
        LRU still holds for ``ids`` regardless of the version stamp.

        Deliberately touches nothing — no hit/miss counters (degraded serves
        are accounted separately and never mixed into the fresh-path stats),
        no eviction, no LRU reordering (the fresh traffic alone decides what
        stays hot)."""
        found: Dict[int, np.ndarray] = {}
        missing: List[int] = []
        with self._lock:
            for i in ids:
                i = int(i)
                entry = self._rows.get((table, i))
                if entry is not None:
                    found[i] = entry[1]
                else:
                    missing.append(i)
        return found, missing

    def clear(self) -> None:
        with self._lock:
            self._rows.clear()

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0
