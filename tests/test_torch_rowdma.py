"""The port's row kernels against the JAX package's Pallas kernels.

On the CPU the port's wrappers run their plain versions; the Pallas kernels
run in interpret mode, as ``tests/test_rowdma.py`` runs them. Both are one
copy or one add per element, so they must agree bit for bit. The CUDA
kernels are held against the plain versions on the card by
``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from swiftsnails_tpu.ops import rowdma as jax_rowdma
from swiftsnails_tpu_torch.ops import rowdma

# One intra-op thread: the shapes are small, and the suite's workers share
# the cores with the JAX mesh tests, which abort under CPU contention.
torch.set_num_threads(1)

_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _jnp(arr, dtype):
    return jnp.asarray(arr, dtype=jnp.dtype(dtype))


def _torch(arr, dtype):
    return torch.from_numpy(np.asarray(arr, np.float32)).to(_TORCH_DTYPES[dtype])


def _np(t):
    return t.float().numpy()


def _table(c, s, seed):
    return np.random.default_rng(seed).standard_normal((c, s, 128)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [1, 2])
def test_gather_rows_plain_matches_pallas(dtype, s):
    table = _table(64, s, 0)
    rows = np.random.default_rng(1).integers(0, 64, 32).astype(np.int32)
    want = jax_rowdma.gather_rows(_jnp(table, dtype), jnp.asarray(rows),
                                  block_rows=8, interpret=True)
    got = rowdma.gather_rows(_torch(table, dtype), torch.from_numpy(rows))
    np.testing.assert_array_equal(_np(got), np.asarray(want, np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [1, 2])
def test_scatter_add_rows_plain_matches_pallas(dtype, s):
    """Unique rows and padding rows (>= C), which both skip."""
    table = _table(64, s, 2)
    rows = np.array([3, 1, 7, 64, 64, 9, 2, 70], dtype=np.int32)
    deltas = np.random.default_rng(3).standard_normal((8, s, 128)).astype(np.float32)
    want = jax_rowdma.scatter_add_rows(
        _jnp(table, dtype), jnp.asarray(rows), _jnp(deltas, dtype),
        block_rows=4, interpret=True)
    t = _torch(table, dtype)
    got = rowdma.scatter_add_rows(t, torch.from_numpy(rows), _torch(deltas, dtype))
    assert got is t  # in place
    np.testing.assert_array_equal(_np(got), np.asarray(want, np.float32))


def test_pack_unpack_match_jax():
    x = np.random.default_rng(0).random((10, 200)).astype(np.float32)
    packed = rowdma.pack_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jax_rowdma.pack_rows(jnp.asarray(x))))
    assert rowdma.packed_shape(7, 200) == jax_rowdma.packed_shape(7, 200)
    np.testing.assert_array_equal(rowdma.unpack_rows(packed, 200).numpy(), x)


def test_plain_versions_do_not_count_launches():
    before = (rowdma.gather_rows.launches, rowdma.scatter_add_rows.launches)
    table = torch.zeros(8, 1, 128)
    rows = torch.arange(4, dtype=torch.int32)
    rowdma.gather_rows(table, rows)
    rowdma.scatter_add_rows(table, rows, torch.ones(4, 1, 128))
    assert (rowdma.gather_rows.launches, rowdma.scatter_add_rows.launches) == before


@pytest.mark.parametrize("case", ["rows_int64", "rows_2d", "table_f16",
                                  "table_strided", "deltas_shape",
                                  "deltas_dtype"])
def test_wrappers_reject_what_the_kernels_do_not_take(case):
    table = torch.zeros(8, 2, 128)
    rows = torch.arange(4, dtype=torch.int32)
    deltas = torch.zeros(4, 2, 128)
    if case == "rows_int64":
        rows = rows.long()
    elif case == "rows_2d":
        rows = rows.reshape(2, 2)
    elif case == "table_f16":
        table = table.half()
    elif case == "table_strided":
        table = table.transpose(0, 1)
    elif case == "deltas_shape":
        deltas = deltas[:, :1]
    else:
        deltas = deltas.double()
    with pytest.raises((TypeError, ValueError)):
        if case.startswith("deltas"):
            rowdma.scatter_add_rows(table, rows, deltas)
        else:
            rowdma.gather_rows(table, rows)
