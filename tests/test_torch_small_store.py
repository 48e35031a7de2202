"""The port's AdaGrad and write row kernels and its small-row store against the JAX package's, on the CPU.

The port's wrappers run their plain versions on the CPU; the Pallas kernels
run in interpret mode, as ``tests/test_small_packed.py`` runs them.
``scatter_write_rows`` copies, so the two agree bit for bit. The AdaGrad
kernels agree in f32 within ``KERNEL_RTOL`` / ``KERNEL_ATOL`` (a few ulps of
values of order 1): XLA's CPU compiler contracts ``accum + g * g`` and
``param - step * r`` into fused multiply-adds and computes ``rsqrt`` by its
own approximation, where the port rounds each operation, as its CUDA kernels
must to equal the plain versions on the card (``tests/test_torch_cuda.py``).
In bf16 that last-bit f32 difference flips a rounding now and then: the
values agree bit for bit but for at most one element in a thousand, which
differs by one bf16 ulp. The stores merge duplicates in
another order than the JAX package does, so tables after a push agree
within rtol 1e-5 / atol 1e-6.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from swiftsnails_tpu.ops import rowdma as jax_rowdma
from swiftsnails_tpu.parallel import access as jax_access
from swiftsnails_tpu.parallel import store as jax_store
from swiftsnails_tpu_torch.ops import rowdma
from swiftsnails_tpu_torch.parallel import store
from swiftsnails_tpu_torch.parallel.access import AdaGradAccess, SgdAccess

KERNEL_RTOL, KERNEL_ATOL = 1e-6, 1e-6
RTOL, ATOL = 1e-5, 1e-6
# One intra-op thread: the shapes are small, and the suite's workers share
# the cores with the JAX mesh tests, which abort under CPU contention.
torch.set_num_threads(1)

_DTYPES = {"float32": (torch.float32, jnp.float32),
           "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _t(arr, dtype=torch.float32):
    """A copy of ``arr`` as a tensor of ``dtype`` (the pushes are in place)."""
    return torch.tensor(np.asarray(arr, np.float32)).to(dtype)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


def _rows(c, n, seed):
    """``n`` unique rows in ``[0, c)`` with padding ids (``c``) mixed in."""
    rng = np.random.default_rng(seed)
    rows = np.concatenate([rng.permutation(c)[: n - 5], np.full(5, c)])
    return rng.permutation(rows).astype(np.int32)


def _case(c, s, n, seed):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(c, s, 128)).astype(np.float32)
    accum = (rng.random((c, s, 128)) * 0.1).astype(np.float32)
    grads = rng.normal(size=(n, s, 128)).astype(np.float32)
    return table, accum, _rows(c, n, seed + 1), grads


def _assert_kernel_close(got, want, dtype):
    got, want = _np(got), _np(want)
    if dtype == "bfloat16":
        differ = got != want
        assert differ.mean() <= 1e-3, differ.sum()
        ulp = np.abs(want[differ]) * 2.0**-7  # one bf16 ulp at most
        assert (np.abs(got[differ] - want[differ]) <= ulp).all()
    else:
        np.testing.assert_allclose(got, want, rtol=KERNEL_RTOL, atol=KERNEL_ATOL)


# ------------------------------------------------------------- kernels ---


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [1, 2])
def test_scatter_write_rows_plain_matches_pallas(dtype, s):
    tdt, jdt = _DTYPES[dtype]
    table, _, rows, values = _case(64, s, 24, 0)
    want = jax_rowdma.scatter_write_rows(
        jnp.asarray(table, jdt), jnp.asarray(rows), jnp.asarray(values, jdt),
        block_rows=8, interpret=True)
    t = _t(table, tdt)
    got = rowdma.scatter_write_rows(t, torch.from_numpy(rows), _t(values, tdt))
    assert got is t  # in place
    np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [1, 2])
def test_scatter_adagrad_rows_plain_matches_pallas(dtype, s):
    """Padding rows skip; f32 gradients are rounded to a bf16 table's dtype
    first, as the TPU wrapper casts them."""
    tdt, jdt = _DTYPES[dtype]
    table, accum, rows, grads = _case(64, s, 24, 2)
    want_t, want_a = jax_rowdma.scatter_adagrad_rows(
        jnp.asarray(table, jdt), jnp.asarray(accum, jdt), jnp.asarray(rows),
        jnp.asarray(grads), 0.3, block_rows=8, interpret=True)
    t, a = _t(table, tdt), _t(accum, tdt)
    got_t, got_a = rowdma.scatter_adagrad_rows(t, a, torch.from_numpy(rows), _t(grads), 0.3)
    assert got_t is t and got_a is a  # in place
    _assert_kernel_close(got_t, want_t, dtype)
    _assert_kernel_close(got_a, want_a, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scatter_adagrad_fused_rows_plain_matches_pallas(dtype):
    """Sublane 0 is the param, sublane 1 its accumulator; the gradient has
    one sublane; padding rows skip."""
    tdt, jdt = _DTYPES[dtype]
    param, accum, rows, grads = _case(64, 1, 24, 4)
    table = np.concatenate([param, accum], axis=1)
    want = jax_rowdma.scatter_adagrad_fused_rows(
        jnp.asarray(table, jdt), jnp.asarray(rows), jnp.asarray(grads), 0.3,
        eps=1e-8, block_rows=8, interpret=True)
    t = _t(table, tdt)
    got = rowdma.scatter_adagrad_fused_rows(t, torch.from_numpy(rows), _t(grads), 0.3)
    assert got is t
    _assert_kernel_close(got, want, dtype)
    # the accumulator sublane moved on every pushed row
    valid = rows[rows < 64]
    assert (_np(got)[valid, 1] != _np(_t(table, tdt))[valid, 1]).any(axis=-1).all()


def test_zero_gradient_lanes_stay_put():
    """A padding lane holds a zero gradient: its accumulator stays 0 and its
    param moves by 0 * rsqrt(eps)."""
    table = torch.zeros(4, 2, 128)
    table[:, 0, :17] = 1.0
    grads = torch.zeros(2, 1, 128)
    grads[:, 0, :17] = 0.5
    rowdma.scatter_adagrad_fused_rows(table, torch.tensor([1, 3], dtype=torch.int32),
                                      grads, 0.1)
    assert not table[:, :, 17:].any()
    assert (table[[1, 3], 1, :17] == 0.25).all() and (table[[0, 2], 0, :17] == 1).all()


def test_plain_versions_do_not_count_launches():
    counters = (rowdma.scatter_write_rows, rowdma.scatter_adagrad_rows,
                rowdma.scatter_adagrad_fused_rows)
    before = [f.launches for f in counters]
    rows = torch.arange(4, dtype=torch.int32)
    t = torch.zeros(8, 1, 128)
    rowdma.scatter_write_rows(t, rows, torch.ones(4, 1, 128))
    rowdma.scatter_adagrad_rows(t, torch.zeros_like(t), rows, torch.ones(4, 1, 128), 0.1)
    rowdma.scatter_adagrad_fused_rows(torch.zeros(8, 2, 128), rows,
                                      torch.ones(4, 1, 128), 0.1)
    assert [f.launches for f in counters] == before


@pytest.mark.parametrize("case", ["accum_dtype", "accum_shape", "fused_shape",
                                  "grads_shape", "grads_int", "values_dtype",
                                  "grads_strided"])
def test_push_wrappers_reject_what_the_kernels_do_not_take(case):
    table = torch.zeros(8, 1, 128)
    accum = torch.zeros(8, 1, 128)
    rows = torch.arange(4, dtype=torch.int32)
    grads = torch.zeros(4, 1, 128)
    with pytest.raises((TypeError, ValueError)):
        if case == "accum_dtype":
            rowdma.scatter_adagrad_rows(table, accum.bfloat16(), rows, grads, 0.1)
        elif case == "accum_shape":
            rowdma.scatter_adagrad_rows(table, accum[:4], rows, grads, 0.1)
        elif case == "fused_shape":
            rowdma.scatter_adagrad_fused_rows(table, rows, grads, 0.1)
        elif case == "grads_shape":
            rowdma.scatter_adagrad_rows(table, accum, rows, grads[:3], 0.1)
        elif case == "grads_int":
            rowdma.scatter_adagrad_rows(table, accum, rows, grads.int(), 0.1)
        elif case == "values_dtype":
            rowdma.scatter_write_rows(table, rows, grads.double())
        else:
            rowdma.scatter_adagrad_fused_rows(
                torch.zeros(8, 2, 128), rows, torch.zeros(4, 2, 128)[:, :1], 0.1)


# ------------------------------------------------------- small-row plane ---


@pytest.mark.parametrize("dim", [1, 9, 17, 33, 128])
def test_small_group_matches_jax(dim):
    assert store.small_group(dim) == jax_store.small_group(dim)


def _accesses(name):
    return {"sgd": (jax_access.SgdAccess(), SgdAccess()),
            "adagrad": (jax_access.AdaGradAccess(), AdaGradAccess()),
            "adagrad_bf16_slots": (jax_access.AdaGradAccess(slot_dtype=jnp.bfloat16),
                                   AdaGradAccess(slot_dtype=torch.bfloat16))}[name]


@pytest.mark.parametrize("access", ["sgd", "adagrad", "adagrad_bf16_slots"])
@pytest.mark.parametrize("dim", [1, 9, 17, 33])
def test_create_packed_small_table_matches_jax_layout(access, dim):
    ja, ta = _accesses(access)
    cap = 200  # not a multiple of the group: the last tile's spare groups are dead
    j = jax_store.create_packed_small_table(cap, dim, ja, seed=3)
    t = store.create_packed_small_table(cap, dim, ta, seed=3, device="cpu")
    assert t.table.shape == j.table.shape and t.table.dtype == torch.float32
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in t.slots.items()} \
        == {k: (tuple(v.shape), str(v.dtype)) for k, v in j.slots.items()}
    stride = 128 // store.small_group(dim)
    dead = (np.arange(128) % stride) >= dim
    assert not t.table[:, 0, dead].any() and not t.table[:, 1:].any()
    live = t.table[:, 0, ~dead]
    assert float(live.abs().max()) <= 0.5 / dim and float(live.std()) > 0.2 / dim
    again = store.create_packed_small_table(cap, dim, ta, seed=3, device="cpu")
    assert torch.equal(again.table, t.table)


def _carry_small(j):
    """The port's copy of a JAX small-row state (slots in their dtype)."""
    def carry(x):
        dtype = torch.bfloat16 if x.dtype == jnp.bfloat16 else torch.float32
        return _t(np.asarray(x, np.float32), dtype)
    return store.PackedTableState(table=carry(j.table),
                                  slots={k: carry(v) for k, v in j.slots.items()})


def _dup_rows(n, cap, seed):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, cap, n).astype(np.int32)
    rows[: n // 5] = rows[0]  # a hot row, many times over
    return rng.permutation(rows).astype(np.int32)


@pytest.mark.parametrize("dim", [1, 9, 17, 33])
def test_pull_packed_small_matches_jax(dim):
    j = jax_store.create_packed_small_table(200, dim, jax_access.AdaGradAccess(), seed=5)
    rows = _dup_rows(150, 200, dim)
    want = jax_store.pull_packed_small(j, jnp.asarray(rows), dim)
    got = store.pull_packed_small(_carry_small(j), torch.from_numpy(rows), dim)
    assert got.shape == (150, dim)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _split_adagrad(cap, dim, seed):
    """A JAX small-row state with a separate f32 accumulator (the split
    layout, which ``push_packed_small`` routes to ``scatter_adagrad_rows``)."""
    j = jax_store.create_packed_small_table(cap, dim, jax_access.SgdAccess(), seed=seed)
    accum = jnp.asarray(np.random.default_rng(seed).random(j.table.shape) * 0.1,
                        jnp.float32)
    lanes = (np.arange(128) % (128 // jax_store.small_group(dim))) < dim
    return j._replace(slots={"accum": accum * lanes})


@pytest.mark.parametrize("dim", [1, 9, 17, 33])
@pytest.mark.parametrize("access", ["sgd", "adagrad", "adagrad_split",
                                    "adagrad_bf16_slots"])
def test_push_packed_small_matches_jax(access, dim):
    """Three pushes of duplicate-heavy rows through both stores."""
    cap = 200
    if access == "adagrad_split":
        ja, ta = _accesses("adagrad")
        j = _split_adagrad(cap, dim, 7)
    else:
        ja, ta = _accesses(access)
        j = jax_store.create_packed_small_table(cap, dim, ja, seed=7)
    t = _carry_small(j)
    rng = np.random.default_rng(dim)
    for step in range(3):
        rows = _dup_rows(160, cap, 10 * dim + step)
        grads = rng.normal(size=(160, dim)).astype(np.float32)
        j = jax_store.push_packed_small(j, jnp.asarray(rows), jnp.asarray(grads), ja, 0.1, dim)
        t2 = store.push_packed_small(t, torch.from_numpy(rows), torch.from_numpy(grads),
                                     ta, 0.1, dim)
        assert t2.table is t.table  # in place
    np.testing.assert_allclose(_np(t.table), _np(j.table), rtol=RTOL, atol=ATOL)
    for k in j.slots:
        np.testing.assert_allclose(_np(t.slots[k]), _np(j.slots[k]), rtol=RTOL, atol=ATOL)
    dead = (np.arange(128) % (128 // store.small_group(dim))) >= dim
    assert not t.table[:, :, dead].any()


def test_push_packed_small_routes_to_one_kernel(monkeypatch):
    """Each access rule reaches the row kernel of the JAX kernel branch."""
    calls = []
    for name in ("scatter_add_rows", "scatter_adagrad_rows", "scatter_adagrad_fused_rows",
                 "scatter_write_rows", "gather_rows"):
        orig = getattr(rowdma, name)

        def spy(*a, _name=name, _orig=orig, **k):
            calls.append(_name)
            return _orig(*a, **k)

        monkeypatch.setattr(rowdma, name, spy)
    rows = torch.tensor([3, 5, 3], dtype=torch.int32)
    grads = torch.ones(3, 17)
    cases = {
        "sgd": (store.create_packed_small_table(64, 17, SgdAccess(), device="cpu"),
                SgdAccess(), ["scatter_add_rows"]),
        "adagrad": (store.create_packed_small_table(64, 17, AdaGradAccess(), device="cpu"),
                    AdaGradAccess(), ["scatter_adagrad_fused_rows"]),
        "split": (store.PackedTableState(torch.zeros(16, 1, 128),
                                         {"accum": torch.zeros(16, 1, 128)}),
                  AdaGradAccess(), ["scatter_adagrad_rows"]),
        "bf16_slots": (store.create_packed_small_table(
            64, 17, AdaGradAccess(slot_dtype=torch.bfloat16), device="cpu"),
            AdaGradAccess(slot_dtype=torch.bfloat16),
            ["gather_rows", "gather_rows", "scatter_write_rows", "scatter_write_rows"]),
    }
    for name, (state, access, want) in cases.items():
        calls.clear()
        store.push_packed_small(state, rows, grads, access, 0.1, 17)
        assert calls == want, name


def test_fused_table_refuses_a_non_adagrad_push():
    state = store.create_packed_small_table(64, 17, AdaGradAccess(), device="cpu")
    with pytest.raises(ValueError, match="non-AdaGrad"):
        store.push_packed_small(state, torch.zeros(2, dtype=torch.int32),
                                torch.zeros(2, 17), SgdAccess(), 0.1, 17)


@pytest.mark.parametrize("dim", [16, 200])
def test_push_packed_adagrad_matches_jax(dim):
    """The wide-row plane's AdaGrad push: gather the rows and the
    accumulator, apply, write both back."""
    c = 64
    j = jax_store.create_packed_table(c, dim, jax_access.AdaGradAccess(), seed=3)
    t = store.PackedTableState(table=_t(np.asarray(j.table)),
                               slots={"accum": _t(np.asarray(j.slots["accum"]))})
    created = store.create_packed_table(c, dim, AdaGradAccess(), seed=3, device="cpu")
    assert set(created.slots) == {"accum"} and created.slots["accum"].shape == t.table.shape
    rng = np.random.default_rng(4)
    s = t.table.shape[1]
    for step in range(3):
        rows = _dup_rows(96, c, step)
        grads = rowdma.pack_rows(torch.from_numpy(
            rng.normal(size=(96, dim)).astype(np.float32))).numpy()
        j = jax_store.push_packed(j, jnp.asarray(rows), jnp.asarray(grads),
                                  jax_access.AdaGradAccess(), 0.1)
        store.push_packed(t, torch.from_numpy(rows), torch.from_numpy(grads),
                          AdaGradAccess(), 0.1)
    assert t.table.shape == (c, s, 128)
    np.testing.assert_allclose(t.table.numpy(), np.asarray(j.table), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(t.slots["accum"].numpy(), np.asarray(j.slots["accum"]),
                               rtol=RTOL, atol=ATOL)
    assert not t.table.reshape(c, -1)[:, dim:].any()


def test_access_rules_match_jax():
    rng = np.random.default_rng(8)
    param, grad = rng.normal(size=(2, 32, 128)).astype(np.float32)
    accum = (rng.random((32, 128)) * 0.1).astype(np.float32)
    for ja, ta, slots in (
            (jax_access.SgdAccess(), SgdAccess(), {}),
            (jax_access.AdaGradAccess(), AdaGradAccess(), {"accum": accum})):
        jp, js = ja.apply_push_value(jnp.asarray(param), {k: jnp.asarray(v) for k, v in slots.items()},
                                     jnp.asarray(grad), 0.1)
        tp, ts = ta.apply_push_value(_t(param), {k: _t(v) for k, v in slots.items()},
                                     _t(grad), 0.1)
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=KERNEL_RTOL,
                                   atol=KERNEL_ATOL)
        for k in js:
            np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]), rtol=KERNEL_RTOL,
                                       atol=KERNEL_ATOL)
    slots = AdaGradAccess(slot_dtype=torch.bfloat16).init_slots((4, 128), torch.float32, "cpu")
    assert slots["accum"].dtype == torch.bfloat16 and not slots["accum"].any()
