"""The port's wire codecs (``swiftsnails_tpu_torch.parallel.comm``) and the
transfer collectives under ``comm_dtype``, against the JAX package's
``parallel/comm.py`` and ``parallel/transfer.py``, on the CPU.

The codecs, resolvers and dither hash are held bit for bit on the same
inputs, dithered and not. The collectives run on gloo meshes of spawned
processes (one spawn of eight ranks, ``torch_comm_ranks.comm_worker``:
the ``(2, 4)`` mesh of all and the ``(2, 2)`` mesh of ranks 0-3) and the
JAX side on the 8-device virtual CPU mesh:

* the four quantized collectives, every wire: bit-exact, and
  ``reduce_scatter_quantized``'s slice bit-equal to
  ``reduce_sum_quantized``'s (``swiftsnails_tpu/parallel/comm.py:360-372``);
* every pull bit-exact; the plain pushes, on distinct ids (one gradient
  a row) or rows merged in one order, within 1e-6 of JAX's jitted step
  (which fuses the update's multiply-add; one quantization step would
  move an element 1e-4 or more), so every code equal; within
  rtol 1e-5 where a row's gradients merge in another order; the
  spread pushes (a codec reduce-scatters their partial sums before
  quantizing) within one quantization step an element of JAX's, the count
  of differing elements printed; overflow and dropped counts equal to the
  f32 run's;
* serving's ``pull_rows`` under int8 and int4 bit-equal to JAX's.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from swiftsnails_tpu.parallel import access as jax_access
from swiftsnails_tpu.parallel import comm as J
from swiftsnails_tpu.parallel import mesh as jax_mesh
from swiftsnails_tpu.parallel import store as jax_store
from swiftsnails_tpu.parallel import transfer as jax_transfer
from swiftsnails_tpu.parallel.placement import row_wire_bytes as jax_row_wire_bytes
from swiftsnails_tpu.serving import kernels as jax_kernels
from swiftsnails_tpu.utils.compat import shard_map
from swiftsnails_tpu_torch.parallel import comm as T
from swiftsnails_tpu_torch.serving.kernels import pull_rows
import torch_comm_ranks as cr
from test_torch_seqlm import spawn_ranks

RTOL, ATOL = 1e-5, 1e-6
SEEDS = (0, 12345, 0xFFFFFFF0)
torch.set_num_threads(1)


def _bits(x) -> np.ndarray:
    """The bytes of an array (a bf16 tensor through its int16 words), for
    bit-for-bit comparison."""
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        x = x.numpy()
    return np.ascontiguousarray(np.asarray(x)).view(np.uint8)


def _same(a, b) -> bool:
    return _bits(a).shape == _bits(b).shape and np.array_equal(_bits(a), _bits(b))


def _rows(shape, seed=0):
    """Rows of widely varying magnitude, an all-zero row and ``-0.0``s."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) * np.exp(2 * rng.standard_normal((shape[0],) + (1,) * (len(shape) - 1)))
    x = x.astype(np.float32)
    if shape[0] > 3:
        x[3] = 0.0
        x.reshape(shape[0], -1)[1, :2] = -0.0
    return x


# ------------------------------------------------------------ resolvers ---

ALIASES = [None, "", "float32", "f32", "FP32", "bf16", "BFloat16", "s8", " int8 ", "int4",
           "s4", "int4/32", "int4/16", "s4/64", "int4/2"]
BAD = ["fp32", "fp8", "int4/3", "int4/0", "int4/x", "int16", "float16", "int4/-2"]


@pytest.mark.parametrize("name", ALIASES)
def test_resolve_comm_dtype_matches_jax(name):
    if str(name).strip().lower() == "fp32":
        with pytest.raises(ValueError):
            T.resolve_comm_dtype(name)
        with pytest.raises(ValueError):
            J.resolve_comm_dtype(name)
        return
    got = T.resolve_comm_dtype(name)
    assert got == J.resolve_comm_dtype(name)
    assert T.is_int4(got) == J.is_int4(got)
    assert T.stochastic_wire(got) == J.stochastic_wire(got)
    if T.is_int4(got):
        assert T.int4_block(got) == J.int4_block(got)


@pytest.mark.parametrize("name", BAD)
def test_bad_comm_dtypes_raise_as_in_jax(name):
    with pytest.raises(ValueError) as want:
        J.resolve_comm_dtype(name)
    with pytest.raises(ValueError) as got:
        T.resolve_comm_dtype(name)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("wire,block", [("int4", 0), ("int4", 16), ("int4/16", 64),
                                        ("int4", 32), ("int8", 16), ("bfloat16", 8),
                                        ("float32", 4)])
def test_apply_int4_block_matches_jax(wire, block):
    assert T.apply_int4_block(wire, block) == J.apply_int4_block(wire, block)


def test_apply_int4_block_rejects_an_odd_block():
    for mod in (T, J):
        with pytest.raises(ValueError):
            mod.apply_int4_block("int4", 3)


@pytest.mark.parametrize("wire", ["float32", "bfloat16", "int8", "int4", "int4/16", "int4/64"])
@pytest.mark.parametrize("elems", [17, 200, 256])
def test_row_wire_bytes_is_the_placement_modules(wire, elems):
    assert T.row_wire_bytes(elems, wire) == jax_row_wire_bytes(elems, wire)


# --------------------------------------------------------------- codecs ---


def test_hash_uniform_is_jax_bit_for_bit():
    """2^20 positions at three seeds; the uniform reaches 1.0 where the
    u32 rounds up, as JAX's does."""
    for seed in SEEDS:
        want = np.asarray(J._hash_uniform((1 << 20,), jnp.uint32(seed)))
        got = T._row_noise(1 << 20, 1, seed, "cpu").reshape(-1)
        assert _same(got, want), seed
    # a position whose hash is 2^32 - 1 or near it maps to 1.0 in both
    idx = torch.arange(1 << 22, dtype=torch.int64)
    u = T._hash_uniform_at(idx, T._seed_tensor(7, "cpu"))
    assert float(u.max()) <= 1.0
    top = int(torch.argmax(u))
    want = np.asarray(J._hash_uniform((top + 1,), jnp.uint32(7)))[top]
    assert np.float32(want) == np.float32(float(u[top]))


def test_salted_matches_jax():
    for seed in SEEDS:
        for idx in range(4):
            want = int(seed + np.uint64(idx) * np.uint64(0x9E3779B9)) & 0xFFFFFFFF
            assert T.salted(seed, idx) == want
            assert int(T.salted(torch.tensor(seed), idx)) == want


SHAPES = [(64, 2, 128), (33, 17), (5, 200), (1, 3), (0, 17)]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("stochastic", [False, True])
def test_int8_codec_is_jax_bit_for_bit(shape, stochastic):
    x = _rows(shape)
    for seed in SEEDS:
        jq, js = J.quantize_int8(jnp.asarray(x), stochastic=stochastic, seed=jnp.uint32(seed))
        tq, ts = T.quantize_int8(torch.from_numpy(x), stochastic=stochastic, seed=seed)
        assert _same(tq, jq) and _same(ts, js), seed
        assert _same(T.dequantize_int8(tq, ts), J.dequantize_int8(jq, js))
        if shape[0] > 3:
            assert float(ts[3]) == 0.0 and not tq[3].any()  # a zero row stays zero


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("block", [16, 32])
def test_int4_codec_is_jax_bit_for_bit(shape, stochastic, block):
    """Blocks of 16 and 32 on packed ``[N, 2, 128]`` and small ``[N, 17]``
    rows (the padded ``[N, Tp/block, block]`` shape the dither indexes)."""
    x = _rows(shape, seed=1)
    for seed in SEEDS:
        jp, jw = J.quantize_int4(jnp.asarray(x), stochastic=stochastic, seed=jnp.uint32(seed),
                                 block=block)
        tp, tw = T.quantize_int4(torch.from_numpy(x), stochastic=stochastic, seed=seed,
                                 block=block)
        assert _same(tp, jp) and _same(tw, jw), seed
        assert _same(T.dequantize_int4(tp, tw, shape, block=block),
                     J.dequantize_int4(jp, jw, shape, block=block))


def test_dither_at_a_place_is_the_senders():
    """Rows quantized at ``place`` (their offsets in the sender's array and
    its salted seed) take the codes the sender's whole-array codec gives
    them: the plain push of rows that are not a ``P(data)`` slice."""
    x = _rows((24, 2, 128), seed=4)
    for wire in ("int8", "int4"):
        for sender in range(3):
            seed = T.salted(SEEDS[2], sender)
            q = (functools.partial(T.quantize_int8) if wire == "int8"
                 else functools.partial(T.quantize_int4, block=32))
            want = q(torch.from_numpy(x), stochastic=True, seed=seed)
            pick = torch.tensor([5, 0, 23, 11])
            place = (pick, torch.full((4,), seed, dtype=torch.int64))
            got = q(torch.from_numpy(x)[pick], stochastic=True, place=place)
            assert _same(got[0], want[0][pick]) and _same(got[1], want[1][pick])


@pytest.mark.parametrize("wire", ["bfloat16", "int8", "int4", "int4/16"])
@pytest.mark.parametrize("dim", [17, 24, 200])
def test_serving_pull_rows_is_jax_bit_for_bit(wire, dim):
    """``pull_rows`` under a wire: deterministic, bit-equal to JAX's."""
    table = _rows((64, dim), seed=dim)
    rows = np.array([0, 5, 63, 5, 3, 1], np.int32)
    got = pull_rows(torch.from_numpy(table), torch.from_numpy(rows), comm_dtype=wire)
    want = jax_kernels.pull_rows(jnp.asarray(table), jnp.asarray(rows), comm_dtype=wire)
    assert _same(got, want)
    assert not np.array_equal(got.numpy(), table[rows])  # the wire did round


# ------------------------------------------------- the meshes, spawned ---


@pytest.fixture(scope="module")
def comm_run(tmp_path_factory):
    results = spawn_ranks(cr.comm_worker, 8, tmp_path_factory.mktemp("comm"))
    by = {}
    for res in results:
        for name, part in res.items():
            by.setdefault(name, {})[(part["coords"]["data"], part["coords"]["model"])] = part
    return by


@functools.lru_cache(maxsize=None)
def _jm(name):
    shape = cr.SHAPES[name]
    return jax_mesh.make_mesh(shape, devices=jax.devices()[:shape["data"] * shape["model"]])


def _per_device(name, fn, *arrays):
    """``fn`` on each device's ``[D, M, ...]`` slice of ``arrays`` inside
    ``shard_map`` over the JAX mesh; ``[D, M, ...]`` of its results."""
    spec = P("data", "model")
    body = lambda *xs: fn(*[x[0, 0] for x in xs])[None, None]  # noqa: E731
    f = shard_map(body, mesh=_jm(name), in_specs=(spec,) * len(arrays), out_specs=spec,
                  check_vma=False)
    return np.asarray(jax.jit(f)(*[jnp.asarray(a) for a in arrays]))


@functools.lru_cache(maxsize=None)
def _jax_collective(name, wire, kind, op, axis=None):
    inp = cr.collective_inputs(cr.SHAPES[name])
    seed = jnp.uint32(cr.SEED)
    size = cr.SHAPES[name][axis] if axis else None
    fns = {
        "psum": lambda x: J.psum_quantized(x, "model", wire),
        "gather": lambda x: J.all_gather_quantized(x, "data", wire, stochastic=True, seed=seed),
        "gather_det": lambda x: J.all_gather_quantized(x, "data", wire),
        "sum": lambda x: J.reduce_sum_quantized(x, axis, wire, size, stochastic=True,
                                                seed=seed).astype(jnp.float32),
        "scatter": lambda x: J.reduce_scatter_quantized(x, axis, wire, size, stochastic=True,
                                                        seed=seed).astype(jnp.float32),
    }
    return _per_device(name, fns[op], inp[("excl_" if op == "psum" else "") + kind])


COLLECTIVE_KEYS = [(w, k, op) for w in cr.WIRES for k in ("packed", "small")
                   for op in ("psum", "gather", "gather_det")] + [
    (w, k, op, ax) for w in cr.WIRES for k in ("packed", "small")
    for op in ("sum", "scatter") for ax in ("data", "model")]


@pytest.mark.parametrize("name", list(cr.SHAPES))
@pytest.mark.parametrize("key", COLLECTIVE_KEYS, ids=lambda k: "-".join(k))
def test_collectives_are_jax_bit_for_bit(comm_run, name, key):
    """Bit for bit, but f32's dense sum over four ranks: XLA's psum adds
    them in an order of its own, so there the sum is held within 1e-6."""
    want = _jax_collective(name, *key)
    for (d, j), part in comm_run[name].items():
        got = part["collectives"][key].float()
        if key[0] == "float32" and key[2] in ("sum", "scatter") and cr.SHAPES[name][key[3]] > 2:
            np.testing.assert_allclose(got.numpy(), want[d, j], rtol=1e-6, atol=1e-6)
        else:
            assert _same(got, want[d, j].astype(np.float32)), (name, key, d, j)


@pytest.mark.parametrize("name", list(cr.SHAPES))
@pytest.mark.parametrize("wire", cr.WIRES)
@pytest.mark.parametrize("axis", ["data", "model"])
def test_reduce_scatter_is_the_slice_of_reduce_sum(comm_run, name, wire, axis):
    for (d, j), part in comm_run[name].items():
        idx = {"data": d, "model": j}[axis]
        for kind in ("packed", "small"):
            whole = part["collectives"][(wire, kind, "sum", axis)]
            own = whole.shape[0] // cr.SHAPES[name][axis]
            got = part["collectives"][(wire, kind, "scatter", axis)]
            assert _same(got, whole[idx * own:(idx + 1) * own]), (name, wire, kind, d, j)


def test_owner_minus_zero_survives_the_bf16_pull(comm_run):
    """The bf16 pull's integer sum keeps an owner's ``-0.0``, as JAX's u16
    sum does (a float sum adds a non-owner's ``+0.0`` and gives ``+0.0``,
    which the f32 wire does in both packages)."""
    for wire, negative in (("bfloat16", True), ("float32", False)):
        for part in comm_run["2x2"].values():
            got = part["collectives"][(wire, "packed", "psum")]
            v = got.float().reshape(cr.ROWS, -1)[1, 7]
            assert float(v) == 0.0 and bool(torch.signbit(v)) == negative


# ------------------------------------------------------ transfer level ---


def _put(jm, a, *spec):
    return jax.device_put(jnp.asarray(a), NamedSharding(jm, P(*spec)))


@functools.lru_cache(maxsize=None)
def _jax_transfer(name, wire, case):
    """The JAX transfer functions on the same whole inputs, under one
    ``jit``: pull (or None), the table after the push, the overflow or
    dropped count. The spread cases' reference is the plain dedup /
    bucketed function, whose chunks are the same."""
    jm = _jm(name)
    inp = cr.transfer_inputs()
    sgd = jax_access.SgdAccess()
    kw = {"comm_dtype": wire, "seed": jnp.uint32(cr.SEED)}
    zero = jnp.int32(0)
    if case == "small":
        table, grads, tspec = inp["small"], inp["small_grads"], ("model", None, None)

        def run(t, ids, g):
            st = jax_store.PackedTableState(table=t, slots={})
            pulled = jax_transfer.pull_collective_packed_small(jm, st, ids, cr.SMALL_DIM,
                                                               comm_dtype=wire)
            st = jax_transfer.push_collective_packed_small(jm, st, ids, g, sgd, cr.LR,
                                                           cr.SMALL_DIM, **kw)
            return pulled, st.table, zero
    elif case in ("2d", "bucketed_2d"):
        table, grads, tspec = inp["table"], inp["grads2d"], ("model", None)

        def run(t, ids, g):
            st = jax_store.TableState(table=t, slots={})
            if case == "2d":
                pulled = jax_transfer.pull_collective(jm, st, ids, comm_dtype=wire)
                st = jax_transfer.push_collective(jm, st, ids, g, sgd, cr.LR, exact=True, **kw)
                return pulled, st.table, zero
            st, count = jax_transfer.push_collective_bucketed(jm, st, ids, g, sgd, cr.LR,
                                                              slack=cr.SLACK, **kw)
            return None, st.table, count
    else:
        table, grads, tspec = inp["packed"], inp["packed_grads"], ("model", None, None)

        def run(t, ids, g):
            st = jax_store.PackedTableState(table=t, slots={})
            if case in ("packed", "packed_dup"):
                pulled = jax_transfer.pull_collective_packed(jm, st, ids, comm_dtype=wire)
                st = jax_transfer.push_collective_packed(jm, st, ids, g, sgd, cr.LR, **kw)
                return pulled, st.table, zero
            if case in ("dedup", "spread_dedup"):
                pulled, index, count = jax_transfer.pull_collective_packed_dedup(
                    jm, st, ids, cr.U_CAP, comm_dtype=wire)
                st, _ = jax_transfer.push_collective_packed_dedup(
                    jm, st, ids, g, sgd, cr.LR, cr.U_CAP, index=index, **kw)
                return pulled, st.table, count
            st, count = jax_transfer.push_collective_packed_bucketed(
                jm, st, ids, g, sgd, cr.LR, slack=cr.SLACK, **kw)
            return None, st.table, count
    pulled, table, count = jax.jit(run)(
        _put(jm, table, *tspec), _put(jm, inp[cr.TRANSFER_CASES[case]], "data"),
        _put(jm, grads, "data", *([None] * (grads.ndim - 1))))
    return (None if pulled is None else np.asarray(pulled), np.asarray(table), int(count))


def _port_transfer(comm_run, name, wire, case):
    """The port's whole table (model shards of data replica 0; the
    replicas equal), its pulls by data shard, its count (equal on every
    rank)."""
    by = comm_run[name]
    d_n, m_n = cr.SHAPES[name]["data"], cr.SHAPES[name]["model"]
    for (d, j), part in by.items():
        assert torch.equal(part["transfer"][(wire, case)]["table"],
                           by[(0, j)]["transfer"][(wire, case)]["table"])
        assert part["transfer"][(wire, case)]["count"] == by[(0, 0)]["transfer"][(wire, case)]["count"]
    table = torch.cat([by[(0, j)]["transfer"][(wire, case)]["table"] for j in range(m_n)])
    pulls = [by[(d, 0)]["transfer"][(wire, case)]["pull"] for d in range(d_n)]
    return pulls, table.numpy(), by[(0, 0)]["transfer"][(wire, case)]["count"]


TRANSFER_WIRES = ("float32", "bfloat16", "int8", "int4")
EXACT = ("packed", "small", "2d", "bucketed", "bucketed_2d")  # one gradient a row, or
# rows merged before the wire in the same order


@pytest.mark.parametrize("name", list(cr.SHAPES))
@pytest.mark.parametrize("wire", TRANSFER_WIRES)
@pytest.mark.parametrize("case", list(cr.TRANSFER_CASES))
def test_transfer_collectives_match_jax(comm_run, name, wire, case):
    pulls, table, count = _port_transfer(comm_run, name, wire, case)
    j_pull, j_table, j_count = _jax_transfer(name, wire, case)
    if j_pull is not None:
        got = torch.cat([p.float() for p in pulls]).numpy()
        assert _same(got, j_pull.astype(np.float32)), "pull"
    assert count == j_count
    f32_count = _port_transfer(comm_run, name, "float32", case)[2]
    assert count == f32_count  # the wire drops nothing more or less
    if case in EXACT:
        # the JAX step's update fuses into a multiply-add under jit: within
        # 1e-6, where one quantization step moves an element by lr * step,
        # 1e-4 and more here, so every code is JAX's
        np.testing.assert_allclose(table, j_table, rtol=1e-6, atol=1e-6)
    elif case.startswith("spread"):
        _within_one_step(name, wire, case, table, j_table)
    else:
        np.testing.assert_allclose(table, j_table, rtol=RTOL, atol=ATOL)


def _within_one_step(name, wire, case, table, j_table):
    """The spread pushes sum each chunk's rows in another f32 order than
    JAX's merge, so a code may round the other way: each element within
    ``lr`` times one quantization step of each chunk's sum for its row."""
    inp = cr.transfer_inputs()
    d_n = cr.SHAPES[name]["data"]
    rows, grads = inp["dup"], inp["packed_grads"].reshape(cr.N_IDS, -1)
    bound = np.zeros((cr.CAP, grads.shape[1]), np.float64)
    for chunk in range(d_n):
        sl = slice(chunk * cr.N_IDS // d_n, (chunk + 1) * cr.N_IDS // d_n)
        for r in np.unique(rows[sl]):
            merged = grads[sl][rows[sl] == r].sum(axis=0)
            if wire == "bfloat16":
                step = np.abs(merged) * 2.0 ** -7
            elif wire == "int8":
                step = np.full_like(merged, np.abs(merged).max() / 127.0)
            elif wire == "int4":
                blocks = np.abs(merged).reshape(-1, 32).max(axis=1) / 7.0 * 1.01
                step = np.repeat(blocks, 32)
            else:
                step = np.abs(merged) * 1e-6
            bound[r] += cr.LR * step
    diff = np.abs(table - j_table).reshape(cr.CAP, -1)
    assert np.all(diff <= bound + ATOL), float((diff - bound).max())
    print(f"{name} {wire} {case}: {int((diff > 0).sum())} of {diff.size} elements "
          f"differ from JAX's, the largest by {diff.max():.3g}")
