"""The port's packed store against the JAX package's, on the CPU.

Duplicate rows are merged before the push; the two packages may add a
row's gradients in another order, so the merged sums and the tables after a
push agree within rtol 1e-6 / atol 1e-7 rather than bit for bit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from swiftsnails_tpu.parallel import access as jax_access
from swiftsnails_tpu.parallel import store as jax_store
from swiftsnails_tpu_torch.ops import rowdma
from swiftsnails_tpu_torch.parallel import store
from swiftsnails_tpu_torch.parallel.access import SgdAccess

RTOL, ATOL = 1e-6, 1e-7
# One intra-op thread: the shapes are small, and the suite's workers share
# the cores with the JAX mesh tests, which abort under CPU contention.
torch.set_num_threads(1)


def _rows_with_duplicates(n, c, seed):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, c, n).astype(np.int32)
    rows[: n // 4] = rows[0]  # a hot row, many times over
    return rng.permutation(rows).astype(np.int32)


@pytest.mark.parametrize("n", [1, 17, 128])
def test_merge_duplicate_rows_matches_jax(n):
    c = 64
    rows = _rows_with_duplicates(n, c, n)
    grads = np.random.default_rng(1).standard_normal((n, 2, 128)).astype(np.float32)
    ju, jm = jax_store.merge_duplicate_rows(jnp.asarray(rows), jnp.asarray(grads), c)
    tu, tm = store.merge_duplicate_rows(torch.from_numpy(rows),
                                        torch.from_numpy(grads), c)
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=RTOL, atol=ATOL)
    n_unique = len(np.unique(rows))
    assert (tu.numpy()[n_unique:] == c).all()
    assert not tm.numpy()[n_unique:].any()


def _jax_and_torch_tables(c, dim, seed):
    j = jax_store.create_packed_table(c, dim, jax_access.SgdAccess(), seed=seed)
    t = store.PackedTableState(table=torch.from_numpy(np.array(j.table)), slots={})
    return j, t


@pytest.mark.parametrize("dim", [16, 200])
def test_pull_and_push_packed_match_jax(dim):
    c = 64
    j, t = _jax_and_torch_tables(c, dim, seed=3)
    s = t.table.shape[1]
    rows = _rows_with_duplicates(96, c, 4)
    g2d = np.random.default_rng(5).standard_normal((96, dim)).astype(np.float32)
    grads = np.asarray(rowdma.pack_rows(torch.from_numpy(g2d)))
    assert grads.shape == (96, s, 128)

    np.testing.assert_array_equal(
        store.pull_packed(t, torch.from_numpy(rows)).numpy(),
        np.asarray(jax_store.pull_packed(j, jnp.asarray(rows))))

    lr = 0.1
    j2 = jax_store.push_packed(j, jnp.asarray(rows), jnp.asarray(grads),
                               jax_access.SgdAccess(), lr)
    t2 = store.push_packed(t, torch.from_numpy(rows), torch.from_numpy(grads),
                           SgdAccess(), lr)
    assert t2.table is t.table  # in place
    np.testing.assert_allclose(t2.table.numpy(), np.asarray(j2.table),
                               rtol=RTOL, atol=ATOL)
    assert not t2.table.reshape(c, -1)[:, dim:].any()  # padding lanes stay zero


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_create_packed_table_invariants(dtype):
    dim, c = 200, 256
    st = store.create_packed_table(c, dim, SgdAccess(), dtype=dtype, seed=7,
                                   device="cpu")
    assert st.table.shape == (c, 2, 128) and st.table.dtype == dtype
    flat = st.table.reshape(c, -1).float()
    assert not flat[:, dim:].any()
    # U(-0.5, 0.5)/dim, drawn in float32 and rounded once to the table dtype
    assert float(flat[:, :dim].abs().max()) <= 0.5 / dim * (1 + torch.finfo(dtype).eps)
    assert float(flat[:, :dim].std()) > 0.2 / dim  # U(-0.5, 0.5)/dim: std 0.29/dim
    zero = store.create_packed_table(c, dim, SgdAccess(), dtype=dtype,
                                     init_scale=0.0, device="cpu")
    assert not zero.table.any()
    again = store.create_packed_table(c, dim, SgdAccess(), dtype=dtype, seed=7,
                                      device="cpu")
    assert torch.equal(again.table, st.table)


def test_create_packed_table_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the default is then valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        store.create_packed_table(8, 16, SgdAccess())


def test_push_packed_rejects_unported_access():
    from swiftsnails_tpu_torch.parallel.access import AccessMethod

    st = store.create_packed_table(8, 16, SgdAccess(), device="cpu")
    with pytest.raises(NotImplementedError, match="scatter_write_rows"):
        store.push_packed(st, torch.zeros(2, dtype=torch.int32),
                          torch.zeros(2, 1, 128), AccessMethod(), 0.1)
