"""Skip-gram pair generation and negative sampling (the JAX package's ``data/sampler.py``).

Dynamic-window skip-gram pairs (flat, or grouped into windows by center),
frequent-word subsampling and unigram^0.75 negative sampling. Pair generation and batching stay numpy on the host, copied
as they are, so the same numpy seed gives the same batches in both packages.
Negative sampling runs on the device through the alias method: the two
O(vocab) tables are built once with numpy and moved to the device, and
:func:`alias_sample` draws from an explicit ``torch.Generator``. It cannot
reproduce JAX's threefry bits; tests that need equal negatives make them with
numpy and inject them into both packages.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch


class AliasTable(NamedTuple):
    """Walker alias table for a discrete distribution over [0, n)."""

    prob: torch.Tensor  # f32[n] — acceptance probability of the home bucket
    alias: torch.Tensor  # i32[n] — fallback outcome per bucket

    @property
    def n(self) -> int:
        return self.prob.shape[0]


def build_alias(weights: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Vose's alias construction (host, O(n))."""
    w = np.asarray(weights, dtype=np.float64)
    if w.ndim != 1 or len(w) == 0 or np.any(w < 0) or w.sum() == 0:
        raise ValueError("weights must be a nonempty 1-D nonnegative array with positive sum")
    n = len(w)
    p = w * (n / w.sum())
    prob = np.zeros(n, dtype=np.float32)
    alias = np.zeros(n, dtype=np.int32)
    small = [i for i in range(n) if p[i] < 1.0]
    large = [i for i in range(n) if p[i] >= 1.0]
    while small and large:
        s = small.pop()
        l = large.pop()
        prob[s] = p[s]
        alias[s] = l
        p[l] = (p[l] + p[s]) - 1.0
        (small if p[l] < 1.0 else large).append(l)
    for i in large:
        prob[i] = 1.0
        alias[i] = i
    for i in small:  # numerical leftovers
        prob[i] = 1.0
        alias[i] = i
    return prob, alias


def build_unigram_alias(counts: np.ndarray, device: torch.device,
                        power: float = 0.75) -> AliasTable:
    """word2vec negative-sampling distribution freq^0.75, on ``device``."""
    weights = np.asarray(counts, dtype=np.float64) ** power
    prob, alias = build_alias(weights)
    return AliasTable(prob=torch.from_numpy(prob).to(device),
                      alias=torch.from_numpy(alias).to(device))


def alias_sample(table: AliasTable, generator: torch.Generator,
                 shape) -> torch.Tensor:
    """Draw int32 ids from the alias table on its device, O(1) per draw.

    ``generator`` must live on the table's device; the draws advance it.
    """
    dev = table.prob.device
    bucket = torch.randint(0, table.n, tuple(shape), generator=generator,
                           device=dev)
    coin = torch.rand(tuple(shape), generator=generator, device=dev)
    keep = coin < table.prob[bucket]
    return torch.where(keep, bucket.to(torch.int32), table.alias[bucket])


def subsample_mask(
    ids: np.ndarray, counts: np.ndarray, threshold: float, rng: np.random.Generator
) -> np.ndarray:
    """Frequent-word subsampling (word2vec): keep word w with probability
    ``min(1, sqrt(t/f(w)) + t/f(w))`` where f is the corpus frequency."""
    if threshold <= 0:
        return np.ones(len(ids), dtype=bool)
    freqs = counts / counts.sum()
    f = freqs[ids]
    keep_p = np.minimum(1.0, np.sqrt(threshold / f) + threshold / f)
    return rng.random(len(ids)) < keep_p


def skipgram_pairs(
    ids: np.ndarray,
    window: int,
    rng: np.random.Generator,
    dynamic: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized (center, context) pair generation over an id stream.

    For each position, a per-position window ``b ~ U(1, window)`` (word2vec's
    dynamic window) selects neighbors at offsets ``-b..-1, 1..b``. Returns
    int32 arrays (centers, contexts).
    """
    pos, valid = _dynamic_window_valid(ids, window, rng, dynamic)
    if pos is None:
        return np.empty(0, np.int32), np.empty(0, np.int32)
    n = len(ids)
    centers = np.repeat(np.arange(n), valid.sum(axis=1))
    contexts = pos[valid]
    return ids[centers].astype(np.int32), ids[contexts].astype(np.int32)


def _dynamic_window_valid(ids, window, rng, dynamic):
    """Shared dynamic-window geometry: (pos [n, 2w], valid [n, 2w]); the one
    source of the draw, so pairs and windows hold the same pair set."""
    n = len(ids)
    if n < 2:
        return None, None
    b = rng.integers(1, window + 1, size=n) if dynamic else np.full(n, window)
    offsets = np.arange(-window, window + 1)
    offsets = offsets[offsets != 0]  # [2w]
    pos = np.arange(n)[:, None] + offsets[None, :]  # [n, 2w]
    valid = (pos >= 0) & (pos < n) & (np.abs(offsets)[None, :] <= b[:, None])
    return pos, valid


def skipgram_windows(
    ids: np.ndarray,
    window: int,
    rng: np.random.Generator,
    dynamic: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """Center-major skip-gram: ``(centers [n], contexts [n, 2*window])``.

    The same pair set as :func:`skipgram_pairs` (the same dynamic-window
    draw), grouped by center position with ``-1`` in unused context slots:
    the layout of word2vec.c's inner loop, and what the grouped fused kernel
    consumes (one center row for its whole window).
    """
    n = len(ids)
    cw = 2 * window
    pos, valid = _dynamic_window_valid(ids, window, rng, dynamic)
    if pos is None:
        return np.empty(0, np.int32), np.empty((0, cw), np.int32)
    ctxs = np.where(valid, ids[np.clip(pos, 0, n - 1)], -1).astype(np.int32)
    return ids.astype(np.int32, copy=True), ctxs


def batch_stream(
    centers: np.ndarray,
    contexts: np.ndarray,
    batch_size: int,
    rng: np.random.Generator,
    shuffle: bool = True,
    drop_remainder: bool = True,
):
    """Yield {'centers', 'contexts'} batches of exactly ``batch_size``.

    ``contexts`` may be 2-D (the window schema [N, 2w] from
    :func:`skipgram_windows`): rows shuffle whole, so a window moves with its
    center and keeps its pair order.
    """
    n = len(centers)
    order = rng.permutation(n) if shuffle else np.arange(n)
    end = (n // batch_size) * batch_size if drop_remainder else n
    for start in range(0, end, batch_size):
        sel = order[start : start + batch_size]
        yield {"centers": centers[sel], "contexts": contexts[sel]}
