"""The port's 2-D table plane against the JAX package's ``parallel/store.py``, on the CPU.

Both packages get the same ``[C, dim]`` table, slots, row ids (duplicate
heavy, with ids outside ``[0, C)`` mixed into the pushes) and gradients,
made with numpy. The pull and the export are exact. SGD pushes agree within
rtol 1e-6 (the port adds duplicates in batch order, as XLA's CPU scatter
does). AdaGrad agrees within ``ADAGRAD_ULPS`` f32 ulps: XLA's CPU compiler
contracts ``lr * g * rsqrt(accum + eps)`` and the table add into fused
multiply-adds and computes ``rsqrt`` by its own approximation, where the port
rounds each operation. The sort-free AdaGrad (the per-sample accumulator,
``accum += Σ g²``) and the exact one (merged, ``accum += (Σ g)²``) give
different tables on duplicate ids, and each is pinned to its JAX
counterpart.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from swiftsnails_tpu.parallel import access as jax_access
from swiftsnails_tpu.parallel import store as jax_store
from swiftsnails_tpu_torch.parallel import store
from swiftsnails_tpu_torch.parallel.access import AdaGradAccess, SgdAccess

SGD_RTOL = 1e-6
ADAGRAD_ULPS = 8
C, DIM, N = 64, 17, 512
torch.set_num_threads(1)

_ACCESS = {"sgd": (SgdAccess, jax_access.SgdAccess),
           "adagrad": (AdaGradAccess, jax_access.AdaGradAccess)}


def _ulps(a: np.ndarray, b: np.ndarray, before: np.ndarray) -> float:
    """The largest ``|a - b|`` in f32 ulps of the values' scale (the larger of
    the value and the one it was updated from), so a result that cancels to
    near zero counts its error against the operands' ulp, not its own."""
    scale = np.maximum(np.maximum(np.abs(a), np.abs(b)), np.abs(before))
    return float((np.abs(a - b) / np.spacing(scale.astype(np.float32))).max())


def _case(seed, oob=True):
    """A table, its AdaGrad accumulator, ``N`` zipf-ish rows (most of them
    repeats; with ``oob`` some at ``C`` and ``C + 3``) and their gradients."""
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(C, DIM)).astype(np.float32)
    accum = (rng.random((C, DIM)) * 0.1).astype(np.float32)
    rows = np.minimum(rng.zipf(1.4, N) - 1, C - 1).astype(np.int32)
    if oob:
        rows[rng.choice(N, 9, replace=False)] = C
        rows[rng.choice(N, 4, replace=False)] = C + 3
    grads = rng.normal(size=(N, DIM)).astype(np.float32)
    return table, accum, rows, grads


def _states(name, table, accum):
    t_state = store.TableState(torch.tensor(table),
                               {"accum": torch.tensor(accum)} if name == "adagrad" else {})
    j_state = jax_store.TableState(jnp.asarray(table),
                                   {"accum": jnp.asarray(accum)} if name == "adagrad" else {})
    return t_state, j_state


def _assert_state(got, want, name, what, before):
    """``before``: ``{"table": ..., "accum": ...}`` the arrays pushed into."""
    arrays = [("table", got.table.numpy(), np.asarray(want.table))]
    arrays += [(k, v.numpy(), np.asarray(want.slots[k])) for k, v in got.slots.items()]
    assert set(got.slots) == set(want.slots)
    for key, g, w in arrays:
        if name == "sgd":
            np.testing.assert_allclose(g, w, rtol=SGD_RTOL, atol=0, err_msg=f"{what} {key}")
        else:
            ulps = _ulps(g, w, before[key])
            assert ulps <= ADAGRAD_ULPS, (what, key, ulps)


@pytest.mark.parametrize("name", ["sgd", "adagrad"])
@pytest.mark.parametrize("exact", [False, True], ids=["sort_free", "exact"])
def test_push_matches_jax(name, exact):
    table, accum, rows, grads = _case(1)
    lr = 0.3
    t_state, j_state = _states(name, table, accum)
    got = store.push(t_state, torch.tensor(rows), torch.tensor(grads),
                     _ACCESS[name][0](), lr, exact=exact)
    want = jax_store.push(j_state, jnp.asarray(rows), jnp.asarray(grads),
                          _ACCESS[name][1](), lr, exact=exact)
    assert got.table is t_state.table  # in place
    assert not np.array_equal(got.table.numpy(), table)
    _assert_state(got, want, name, f"push exact={exact}", {"table": table, "accum": accum})


def test_adagrad_rules_differ_on_duplicates_and_each_matches_jax():
    """Per-sample (sort-free) and merged (exact) AdaGrad give different
    accumulators on a duplicate-heavy batch: ``Σ g²`` against ``(Σ g)²``."""
    table, accum, rows, grads = _case(2, oob=False)
    out = {}
    for exact in (False, True):
        t_state, _ = _states("adagrad", table, accum)
        out[exact] = store.push(t_state, torch.tensor(rows), torch.tensor(grads),
                                AdaGradAccess(), 0.1, exact=exact)
    dup = np.bincount(rows, minlength=C) > 1
    r = int(np.flatnonzero(dup)[0])
    g = grads[rows == r]
    np.testing.assert_allclose(out[False].slots["accum"][r].numpy(),
                               accum[r] + (g * g).sum(0), rtol=1e-5)
    np.testing.assert_allclose(out[True].slots["accum"][r].numpy(),
                               accum[r] + g.sum(0) ** 2, rtol=1e-5)
    assert not np.allclose(out[False].slots["accum"].numpy()[dup],
                           out[True].slots["accum"].numpy()[dup])


def test_adagrad_duplicates_read_the_accumulator_after_every_square():
    """Each sample's step reads its row's accumulator once all the batch's
    squares have landed: duplicates of a row step by the same scale."""
    rows = np.array([3, 3, 3, 5], dtype=np.int32)
    grads = np.ones((4, DIM), np.float32) * np.array([1.0, 2.0, 3.0, 1.0],
                                                      np.float32)[:, None]
    table = np.zeros((C, DIM), np.float32)
    t_state, j_state = _states("adagrad", table, np.zeros((C, DIM), np.float32))
    store.push(t_state, torch.tensor(rows), torch.tensor(grads), AdaGradAccess(), 1.0)
    want = jax_store.push(j_state, jnp.asarray(rows), jnp.asarray(grads),
                          jax_access.AdaGradAccess(), 1.0)
    acc = 1.0 + 4.0 + 9.0
    np.testing.assert_allclose(t_state.table[3].numpy(), -6.0 / np.sqrt(acc), rtol=1e-6)
    np.testing.assert_allclose(t_state.table[5].numpy(), -1.0, rtol=1e-6)
    _assert_state(t_state, want, "adagrad", "duplicates",
                  {"table": table, "accum": np.zeros_like(table)})


def test_pull_and_export_match_jax():
    table, _, rows, _ = _case(3)
    t_state, j_state = _states("sgd", table, None)
    inb = rows[rows < C]
    np.testing.assert_array_equal(store.pull(t_state, torch.tensor(inb)).numpy(),
                                  np.asarray(jax_store.pull(j_state, jnp.asarray(inb))))
    np.testing.assert_array_equal(
        store.export_rows(t_state, torch.tensor(rows)).numpy(),
        np.asarray(jax_store.export_rows(j_state, jnp.asarray(rows))))


def test_merge_duplicate_rows_2d_matches_jax():
    _, _, rows, grads = _case(4)
    uniq, merged = store.merge_duplicate_rows(torch.tensor(rows), torch.tensor(grads),
                                              invalid_row=C + 7)
    j_uniq, j_merged = jax_store.merge_duplicate_rows(jnp.asarray(rows), jnp.asarray(grads),
                                                      invalid_row=C + 7)
    np.testing.assert_array_equal(uniq.numpy(), np.asarray(j_uniq))
    np.testing.assert_allclose(merged.numpy(), np.asarray(j_merged), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["sgd", "adagrad"])
def test_apply_rows_matches_jax(name):
    table, accum, rows, grads = _case(5)
    j_uniq, j_merged = jax_store.merge_duplicate_rows(jnp.asarray(rows), jnp.asarray(grads),
                                                      invalid_row=C)
    t_state, j_state = _states(name, table, accum)
    store.apply_rows(t_state.table, t_state.slots, torch.tensor(np.asarray(j_uniq)),
                     torch.tensor(np.asarray(j_merged)), _ACCESS[name][0](), 0.2)
    j_table, j_slots = jax_store.apply_rows(j_state.table, j_state.slots, j_uniq, j_merged,
                                            _ACCESS[name][1](), 0.2)
    _assert_state(t_state, jax_store.TableState(j_table, j_slots), name, "apply_rows",
                  {"table": table, "accum": accum})


@pytest.mark.parametrize("name", ["sgd", "adagrad"])
def test_create_table(name):
    state = store.create_table(C, DIM, _ACCESS[name][0](), seed=3, device="cpu")
    assert state.table.shape == (C, DIM) and (state.capacity, state.dim) == (C, DIM)
    assert float(state.table.abs().max()) <= 0.5 / DIM
    assert set(state.slots) == ({"accum"} if name == "adagrad" else set())
    again = store.create_table(C, DIM, _ACCESS[name][0](), seed=3, device="cpu")
    assert torch.equal(state.table, again.table)
    zero = store.create_table(C, DIM, SgdAccess(), seed=3, init_scale=0.0, device="cpu")
    assert not zero.table.any()


def test_sort_free_sgd_is_the_merged_push():
    """SGD's scatter-add is the exact push's math (the JAX docstring's
    claim), within the f32 order of the sums."""
    table, _, rows, grads = _case(6)
    a, _ = _states("sgd", table, None)
    b, _ = _states("sgd", table, None)
    store.push(a, torch.tensor(rows), torch.tensor(grads), SgdAccess(), 0.5)
    store.push(b, torch.tensor(rows), torch.tensor(grads), SgdAccess(), 0.5, exact=True)
    np.testing.assert_allclose(a.table.numpy(), b.table.numpy(), rtol=1e-5, atol=1e-6)
