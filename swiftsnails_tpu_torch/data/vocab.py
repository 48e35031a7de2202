"""Vocabulary: token -> id with frequency counts.

The reference keeps its vocab in a host-side hashmap (``src/utils/hashmap.h``
wrappers over google sparsehash) and its word2vec data as whitespace-separated
int features (``src/tools/gen-word2vec-data.py``). Here the vocab is a plain
dict built once on the host; the hot encode path is vectorized through numpy
(and later the C++ pipeline extension).
"""

from __future__ import annotations

import collections
from typing import Dict, Iterable, List, Optional

import numpy as np


class Vocab:
    """Frequency-ranked vocabulary with min-count filtering."""

    def __init__(self, words: List[str], counts: np.ndarray):
        assert len(words) == len(counts)
        self.words = words
        self.counts = np.asarray(counts, dtype=np.int64)
        self.index: Dict[str, int] = {w: i for i, w in enumerate(words)}

    @classmethod
    def from_counter(
        cls,
        counter: Dict[str, int],
        min_count: int = 5,
        max_size: Optional[int] = None,
    ) -> "Vocab":
        """The single source of the ordering contract (also mirrored by the
        native vocab build): frequency desc, then lexicographic, min-count
        filtered, truncated to max_size."""
        items = [(w, c) for w, c in counter.items() if c >= min_count]
        items.sort(key=lambda wc: (-wc[1], wc[0]))
        if max_size is not None:
            items = items[:max_size]
        words = [w for w, _ in items]
        counts = np.array([c for _, c in items], dtype=np.int64)
        return cls(words, counts)

    @classmethod
    def build(
        cls,
        tokens: Iterable[str],
        min_count: int = 5,
        max_size: Optional[int] = None,
    ) -> "Vocab":
        return cls.from_counter(collections.Counter(tokens), min_count, max_size)

    def __len__(self) -> int:
        return len(self.words)

    def __contains__(self, word: str) -> bool:
        return word in self.index

    def frequency_ranks(self) -> np.ndarray:
        """Per-id frequency rank (0 = most frequent; ties broken by id, which
        is already lexicographic under the ordering contract). Vocab ids are
        frequency-ranked at build time, so for a freshly built vocab this is
        ``arange``; a loaded/merged vocab may not be sorted, hence the
        explicit double argsort. Consumers: the tiered store pre-warms its
        HBM cache with the hottest rows before step 0."""
        order = np.argsort(-self.counts, kind="stable")
        ranks = np.empty(len(self.counts), dtype=np.int64)
        ranks[order] = np.arange(len(self.counts), dtype=np.int64)
        return ranks

    def hottest_rows(self, k: Optional[int] = None) -> np.ndarray:
        """Vocab ids ordered hottest-first (inverse of frequency_ranks).
        Consumers: tiered prewarm (`tier_warm_rows`) and the placement
        auto-partitioner's head candidates."""
        order = np.argsort(self.frequency_ranks(), kind="stable")
        return order if k is None else order[:k]

    def cumulative_coverage(self) -> np.ndarray:
        """CDF over frequency ranks: ``out[k]`` is the fraction of token
        accesses covered by the ``k`` hottest rows (``out[0] == 0``,
        ``out[len(vocab)] == 1``). The placement cost model reads the
        coverage of a candidate head cut straight off this curve."""
        hot = self.counts[self.hottest_rows()].astype(np.float64)
        total = hot.sum()
        cdf = np.cumsum(hot) / (total if total > 0 else 1.0)
        return np.concatenate([[0.0], cdf])

    def coverage_at(self, k: int) -> float:
        """Fraction of accesses the ``k`` hottest rows cover."""
        cdf = self.cumulative_coverage()
        return float(cdf[min(max(int(k), 0), len(cdf) - 1)])

    def encode(self, tokens: Iterable[str]) -> np.ndarray:
        """Token stream -> int32 ids, dropping OOV (word2vec convention)."""
        idx = self.index
        return np.fromiter(
            (idx[t] for t in tokens if t in idx), dtype=np.int32
        )

    # -- persistence (text format: "word<TAB>count" per line, rank order) ----

    def save(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            for w, c in zip(self.words, self.counts):
                f.write(f"{w}\t{int(c)}\n")

    @classmethod
    def load(cls, path: str) -> "Vocab":
        words: List[str] = []
        counts: List[int] = []
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.rstrip("\n")
                if not line:
                    continue
                w, c = line.split("\t")
                words.append(w)
                counts.append(int(c))
        return cls(words, np.array(counts, dtype=np.int64))
