"""Key hashing for parameter placement (the JAX package's ``ops/hashing.py``).

The reference places every key with the MurmurHash3 64-bit finalizer
(``src/utils/HashFunction.h:17-25``)::

    x ^= x >> 33; x *= 0xff51afd7ed558ccd;
    x ^= x >> 33; x *= 0xc4ceb9fe1a85ec53;
    x ^= x >> 33;

* :func:`murmur_fmix64_int` / :func:`murmur_fmix64_np` — exact host versions
  (Python ints, numpy uint64), copied as they are;
* :func:`murmur_fmix64` / :func:`hash_row` — the device version, in torch
  int64. PyTorch has no uint64 arithmetic, but a 64-bit multiply wraps to the
  same bits whether the operands are read as signed or unsigned, so only the
  shifts need care: ``>>`` on int64 is arithmetic, so each xorshift masks the
  sign-extended bits away. Keys are zero-extended from their uint32 bit
  pattern, as the JAX package's jittable version does.
"""

from __future__ import annotations

import numpy as np
import torch

_C1 = 0xFF51AFD7ED558CCD
_C2 = 0xC4CEB9FE1A85EC53

_MASK64 = (1 << 64) - 1
_MASK32 = 0xFFFFFFFF


def _as_int64(c: int) -> int:
    """The int64 whose two's-complement bits are the uint64 ``c``."""
    return c - (1 << 64) if c >= (1 << 63) else c


_C1_I64 = _as_int64(_C1)
_C2_I64 = _as_int64(_C2)


def murmur_fmix64_int(x: int) -> int:
    """Exact scalar finalizer on Python ints (host-side use)."""
    x &= _MASK64
    x ^= x >> 33
    x = (x * _C1) & _MASK64
    x ^= x >> 33
    x = (x * _C2) & _MASK64
    x ^= x >> 33
    return x


def murmur_fmix64_np(x: np.ndarray) -> np.ndarray:
    """Exact vectorized finalizer on ``uint64`` numpy arrays."""
    x = np.asarray(x, dtype=np.uint64)
    with np.errstate(over="ignore"):
        x = x ^ (x >> np.uint64(33))
        x = x * np.uint64(_C1)
        x = x ^ (x >> np.uint64(33))
        x = x * np.uint64(_C2)
        x = x ^ (x >> np.uint64(33))
    return x


def _xorshift33(x: torch.Tensor) -> torch.Tensor:
    # logical x >> 33 keeps 31 bits; the arithmetic shift's sign copies go
    return x ^ ((x >> 33) & ((1 << 31) - 1))


def murmur_fmix64(keys: torch.Tensor) -> torch.Tensor:
    """Finalize 32-bit keys (zero-extended to 64 bits) -> int64 hash bits.

    Negative int32 keys are read as their uint32 bit pattern (a C++
    ``uint64_t`` widening of ``uint32_t``). The result holds the uint64 hash
    as int64 bits.
    """
    x = keys.to(torch.int64) & _MASK32
    x = _xorshift33(x)
    x = x * _C1_I64
    x = _xorshift33(x)
    x = x * _C2_I64
    return _xorshift33(x)


def hash_row(keys: torch.Tensor, capacity: int) -> torch.Tensor:
    """key -> table row: ``murmur(key) % capacity`` for a power-of-two capacity.

    Power-of-two capacity makes the modulo a mask on the low hash word.
    Returns int32 rows on the keys' device.
    """
    if capacity <= 0 or (capacity & (capacity - 1)) != 0:
        raise ValueError(f"capacity must be a positive power of two, got {capacity}")
    if capacity > (1 << 32):
        raise ValueError("on-device hash_row supports capacity <= 2**32")
    lo = murmur_fmix64(keys) & _MASK32
    return (lo & (capacity - 1)).to(torch.int32)


def hash_row_np(keys: np.ndarray, capacity: int) -> np.ndarray:
    """Host-side equivalent of :func:`hash_row` (exact for any capacity).

    It widens a negative key by sign extension, where :func:`hash_row`
    zero-extends it: the two agree on non-negative keys.
    """
    h = murmur_fmix64_np(np.asarray(keys, dtype=np.uint64))
    return (h % np.uint64(capacity)).astype(np.int64)
