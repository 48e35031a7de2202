"""The port's key hashing, bit for bit against the JAX package's."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from swiftsnails_tpu.ops import hashing as jax_hashing
from swiftsnails_tpu_torch.ops import hashing

_EDGE = np.array([0, 1, -1, np.iinfo(np.int32).min, np.iinfo(np.int32).max,
                  12345, -12345], dtype=np.int32)
_RANDOM = np.random.default_rng(0).integers(
    np.iinfo(np.int32).min, np.iinfo(np.int32).max, 4096, dtype=np.int64,
    endpoint=True).astype(np.int32)
_KEYS = np.concatenate([_EDGE, _RANDOM])


@pytest.mark.parametrize("reference", ["jax_hash_row", "hash_row_np"])
@pytest.mark.parametrize("capacity", [1, 64, 1 << 20, 1 << 31, 1 << 32])
def test_hash_row_bit_exact(reference, capacity):
    """Device hash == JAX ``hash_row`` on every int32 key, negative ones
    included (both zero-extend), and == ``hash_row_np`` on non-negative keys
    only: the numpy version sign-extends a negative key."""
    got = hashing.hash_row(torch.from_numpy(_KEYS), capacity).numpy()
    assert got.dtype == np.int32
    if reference == "jax_hash_row":
        want = np.asarray(jax_hashing.hash_row(jnp.asarray(_KEYS), capacity))
        np.testing.assert_array_equal(got, want)
    else:
        keep = _KEYS >= 0
        want = jax_hashing.hash_row_np(_KEYS[keep].astype(np.int64), capacity)
        np.testing.assert_array_equal(got[keep].astype(np.int64) & (capacity - 1),
                                      want)


def test_fmix64_host_versions_match_jax():
    x = np.random.default_rng(1).integers(0, 2**63, 256, dtype=np.uint64)
    np.testing.assert_array_equal(hashing.murmur_fmix64_np(x),
                                  jax_hashing.murmur_fmix64_np(x))
    for v in [0, 1, 2**32 - 1, 2**63, 2**64 - 1]:
        assert hashing.murmur_fmix64_int(v) == jax_hashing.murmur_fmix64_int(v)


@pytest.mark.parametrize("capacity", [0, 3, 100])
def test_hash_row_rejects_non_power_of_two(capacity):
    with pytest.raises(ValueError, match="power of two"):
        hashing.hash_row(torch.zeros(4, dtype=torch.int32), capacity)
