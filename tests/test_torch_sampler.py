"""The port's sampler against the JAX package's.

Pair generation, subsampling and batching are numpy in both packages and
must give identical arrays from one numpy seed. Negative sampling draws
from a ``torch.Generator``, which cannot reproduce JAX's threefry bits, so
it is held to the unigram^0.75 distribution instead.
"""

import numpy as np
import pytest
import torch

from swiftsnails_tpu.data import sampler as jax_sampler
from swiftsnails_tpu_torch.data import sampler

# One intra-op thread: the shapes are small, and the suite's workers share
# the cores with the JAX mesh tests, which abort under CPU contention.
torch.set_num_threads(1)


def _counts(v, seed=0):
    return np.maximum(np.random.default_rng(seed).zipf(1.3, v), 1).astype(np.int64)


@pytest.mark.parametrize("v", [1, 7, 256])
def test_alias_tables_equal_numpy(v):
    counts = _counts(v)
    want = jax_sampler.build_unigram_alias(counts)
    got = sampler.build_unigram_alias(counts, torch.device("cpu"))
    np.testing.assert_array_equal(got.prob.numpy(), np.asarray(want.prob))
    np.testing.assert_array_equal(got.alias.numpy(), np.asarray(want.alias))
    assert got.prob.dtype == torch.float32 and got.alias.dtype == torch.int32


def test_alias_tables_are_built_once_a_vocabulary(monkeypatch):
    """A second trainer on one vocabulary reuses its alias tables: equal
    tensors, not Vose's loop again, and not the cached arrays themselves;
    another vocabulary or power builds anew."""
    counts = _counts(300, 3)
    first = sampler.build_unigram_alias(counts, torch.device("cpu"))
    first.prob.fill_(0.0)  # a caller's tensor: the cache keeps its own copy

    def refuse(weights):
        raise AssertionError("rebuilt")

    build = sampler.build_alias
    monkeypatch.setattr(sampler, "build_alias", refuse)
    again = sampler.build_unigram_alias(counts.copy(), torch.device("cpu"))
    want = jax_sampler.build_unigram_alias(counts)
    np.testing.assert_array_equal(again.prob.numpy(), np.asarray(want.prob))
    np.testing.assert_array_equal(again.alias.numpy(), np.asarray(want.alias))
    for other in ((_counts(300, 4), 0.75), (counts, 0.5)):
        with pytest.raises(AssertionError, match="rebuilt"):
            sampler.build_unigram_alias(other[0], torch.device("cpu"), power=other[1])
    monkeypatch.setattr(sampler, "build_alias", build)
    for v in range(sampler._ALIAS_CACHE_SIZE + 1):  # the oldest goes
        sampler.build_unigram_alias(_counts(10 + v, 5), torch.device("cpu"))
    assert len(sampler._ALIAS_CACHE) == sampler._ALIAS_CACHE_SIZE


def test_alias_sample_matches_unigram_075():
    """Chi-square goodness of fit over 200,000 draws, 63 degrees of freedom.
    The bound 140 is far in the tail (p < 1e-6) for a right sampler."""
    v, n = 64, 200_000
    counts = _counts(v, 1)
    table = sampler.build_unigram_alias(counts, torch.device("cpu"))
    gen = torch.Generator().manual_seed(0)
    draws = sampler.alias_sample(table, gen, (n // 100, 100))
    assert draws.dtype == torch.int32 and draws.shape == (n // 100, 100)
    observed = np.bincount(draws.numpy().ravel(), minlength=v)
    p = counts.astype(np.float64) ** 0.75
    expected = n * p / p.sum()
    chi2 = float(((observed - expected) ** 2 / expected).sum())
    assert chi2 < 140.0, chi2
    again = sampler.alias_sample(table, torch.Generator().manual_seed(0),
                                 (n // 100, 100))
    assert torch.equal(again, draws)


@pytest.mark.parametrize("window", [1, 2, 5])
@pytest.mark.parametrize("dynamic", [True, False])
def test_skipgram_pairs_identical(window, dynamic):
    ids = np.random.default_rng(2).integers(0, 50, 300).astype(np.int32)
    want = jax_sampler.skipgram_pairs(ids, window, np.random.default_rng(9), dynamic)
    got = sampler.skipgram_pairs(ids, window, np.random.default_rng(9), dynamic)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("threshold", [0.0, 1e-4, 1e-2])
def test_subsample_mask_identical(threshold):
    counts = _counts(40, 3)
    ids = np.random.default_rng(4).integers(0, 40, 500)
    want = jax_sampler.subsample_mask(ids, counts, threshold, np.random.default_rng(5))
    got = sampler.subsample_mask(ids, counts, threshold, np.random.default_rng(5))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("drop_remainder", [True, False])
def test_batch_stream_identical(drop_remainder):
    rng = np.random.default_rng(6)
    centers = rng.integers(0, 50, 1000).astype(np.int32)
    contexts = rng.integers(0, 50, 1000).astype(np.int32)
    want = list(jax_sampler.batch_stream(centers, contexts, 96,
                                         np.random.default_rng(7),
                                         drop_remainder=drop_remainder))
    got = list(sampler.batch_stream(centers, contexts, 96,
                                    np.random.default_rng(7),
                                    drop_remainder=drop_remainder))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])
