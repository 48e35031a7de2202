"""The port's bulk-copy probes against the JAX package's DMA-semaphore probes.

The oracle is the kernel bodies of ``tools/sem_probe.py``, restated here
because the tool nests them inside ``main()``, run as Pallas kernels under
``interpret=pltpu.InterpretParams()`` on the CPU: ``chunk_kernel``'s one-shot
branch (64 row copies retired by one ``[64, S, 128]`` descriptor wait) and
``pipe_kernel`` (per-copy and chunked waits). On the CPU the port's wrappers
run their plain versions; the CUDA kernels are held against those on the
card by ``tests/test_torch_cuda.py``.

``unit_kernel``'s observed count has no CPU oracle: ``pltpu.semaphore_read``
has no CPU lowering (``NotImplementedError: MLIR translation rule for
primitive 'semaphore_read' not found for platform cpu``). The unit probe's
plain version is therefore held to the PTX ISA's accounting of a bulk copy,
whose ``complete_tx`` takes the bytes it wrote off the barrier's
transaction count: one copy of ``rows`` rows accounts for ``rows * S * 128 *
itemsize`` bytes.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from swiftsnails_tpu.utils.compat import install_pallas_compat
from swiftsnails_tpu_torch.ops import rowdma, sem_probe
from swiftsnails_tpu_torch.tools import sem_probe as tool

install_pallas_compat()
torch.set_num_threads(1)

CH = 64


# ----------------------------------------------------- the JAX oracle ---


def _chunk_kernel(rows_ref, x_ref, o_ref, buf, sem):
    """``chunk_kernel``'s one-shot branch (``tools/sem_probe.py:129-159``,
    the poll left out: it needs ``semaphore_read``)."""
    def issue(k, _):
        pltpu.make_async_copy(x_ref.at[rows_ref[k]], buf.at[k], sem).start()
        return 0

    jax.lax.fori_loop(0, CH, issue, 0)
    pltpu.make_async_copy(x_ref.at[:CH], buf, sem).wait()
    o_ref[...] = buf[...]


def _jax_chunk(x, rows):
    s = x.shape[1]
    return np.asarray(pl.pallas_call(
        _chunk_kernel,
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=1, grid=(1,),
            in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
            out_specs=pl.BlockSpec((CH, s, 128), lambda i, *_: (0, 0, 0)),
            scratch_shapes=[pltpu.VMEM((CH, s, 128), jnp.float32),
                            pltpu.SemaphoreType.DMA]),
        out_shape=jax.ShapeDtypeStruct((CH, s, 128), jnp.float32),
        interpret=pltpu.InterpretParams(),
    )(jnp.asarray(rows), jnp.asarray(x)))


def _pipe_kernel(rows_ref, x_ref, o_ref, buf, sem, *, chunked, k_rows):
    """``pipe_kernel`` (``tools/sem_probe.py:200-228``) with K an argument."""
    i = pl.program_id(0)

    def issue(k, _):
        pltpu.make_async_copy(x_ref.at[rows_ref[i * k_rows + k]], buf.at[k],
                              sem).start()
        return 0

    jax.lax.fori_loop(0, k_rows, issue, 0)
    if chunked:
        nch, rem = divmod(k_rows, CH)

        def wch(c, _):
            pltpu.make_async_copy(x_ref.at[:CH], buf.at[:CH], sem).wait()
            return 0

        jax.lax.fori_loop(0, nch, wch, 0)
        for _ in range(rem):
            pltpu.make_async_copy(x_ref.at[0], buf.at[0], sem).wait()
    else:
        def w(k, _):
            pltpu.make_async_copy(x_ref.at[0], buf.at[0], sem).wait()
            return 0

        jax.lax.fori_loop(0, k_rows, w, 0)
    o_ref[...] = jnp.full(o_ref.shape, buf[0, 0, 0], jnp.float32)


def _jax_pipe(x, rows, blocks, chunked):
    k_rows = rows.size // blocks
    return np.asarray(pl.pallas_call(
        functools.partial(_pipe_kernel, chunked=chunked, k_rows=k_rows),
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=1, grid=(blocks,),
            in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
            out_specs=pl.BlockSpec((8, 128), lambda i, *_: (0, 0)),
            scratch_shapes=[pltpu.VMEM((k_rows, x.shape[1], 128), jnp.float32),
                            pltpu.SemaphoreType.DMA]),
        out_shape=jax.ShapeDtypeStruct((8, 128), jnp.float32),
        interpret=pltpu.InterpretParams(),
    )(jnp.asarray(rows), jnp.asarray(x)))


@pytest.mark.parametrize("s", [1, 2])
def test_chunk_plain_matches_the_one_shot_wait(s):
    rng = np.random.default_rng(0)
    x = rng.random((4096, s, 128), dtype=np.float32)
    rows = rng.integers(0, 4096, CH).astype(np.int32)
    want = _jax_chunk(x, rows)
    got, stats = sem_probe.chunk_probe(torch.from_numpy(x), torch.from_numpy(rows))
    np.testing.assert_array_equal(got.numpy(), want)
    assert stats.tolist() == [CH * s * 128 * 4, -1, -1, -1]


@pytest.mark.parametrize("chunked", [False, True], ids=["per_copy", "chunked"])
def test_pipe_plain_matches_the_tpu_kernel(chunked):
    blocks, k_rows, v = 2, 128, 1000
    rng = np.random.default_rng(0)
    x = rng.random((v, 2, 128), dtype=np.float32)
    rows = rng.integers(0, v, (blocks, k_rows)).astype(np.int32).reshape(-1)
    tpu = _jax_pipe(x, rows, blocks, chunked)
    got = sem_probe.pipe_probe(torch.from_numpy(x), torch.from_numpy(rows), blocks,
                               chunked).numpy()
    # slot 0 of the last block is what the TPU kernel wrote, bit for bit
    assert got[blocks - 1, 0] == tpu[0, 0].view(np.int32)
    words = x[rows].view(np.uint32).reshape(blocks, -1)
    np.testing.assert_array_equal(got[:, 1].view(np.uint32),
                                  np.bitwise_xor.reduce(words, axis=1))
    np.testing.assert_array_equal(got[:, 0].view(np.uint32), words[:, 0])


# -------------------------------------------------------- unit probe ---


@pytest.mark.parametrize("rows,s,dtype,tag", tool.TAGS, ids=[t[3] for t in tool.TAGS])
def test_unit_plain_accounts_the_bytes_of_a_copy(rows, s, dtype, tag):
    x = torch.ones((max(rows, 8), s, 128), dtype=dtype)
    f = sem_probe.unit_fields(sem_probe.unit_probe(x, rows))
    assert f["unit"] == rows * s * 128 * x.element_size()
    assert (f["exact_done"], f["over_done"], f["over_drained"]) == (1, 0, 1)
    additive = (1, 0, 1) if rows > 1 else (-1, -1, -1)
    assert (f["singles_done"], f["partial_done"], f["last_drained"]) == additive
    assert all(f[k] == -1 for k in sem_probe.UNIT_TIMES)


def test_unit_rows_are_row_additive():
    """The tool's test: the 8-row copy accounts for 8 single rows."""
    one = sem_probe.unit_probe(torch.ones(8, 2, 128), 1)[0]
    eight = sem_probe.unit_probe(torch.ones(8, 2, 128), 8)[0]
    assert eight == 8 * one == 8192


# ------------------------------------------------------------- the tool ---


def _json_lines(out: str) -> dict:
    lines = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    return {ln["experiment"]: ln for ln in lines}


def test_tool_quick_on_the_cpu(capsys):
    res = tool.main(["--device", "cpu", "--quick"])
    out = capsys.readouterr().out
    assert res["ok"] and "pipe" not in res
    assert "=> row-additive increments: True" in out
    assert "row unit f32[2,128]: 1024" in out
    assert "chunk wait: observed=65536 expected=65536 one-shot=YES gather max err=0.0" in out
    lines = _json_lines(out)
    assert set(lines) == {"unit", "chunk"}
    assert lines["chunk"]["flag"] == 65536 and lines["chunk"]["bit_equal"]
    assert lines["unit"]["tags"]["bf16[2,128]"]["unit"] == 512


def _small_pipe(monkeypatch, blocks, copies, vocab):
    monkeypatch.setattr(tool, "B", blocks)
    monkeypatch.setattr(tool, "K", copies)
    monkeypatch.setattr(tool, "VB", vocab)


def test_tool_runs_every_experiment_at_a_small_dim(capsys, monkeypatch):
    _small_pipe(monkeypatch, 2, 128, 1000)
    res = tool.main(["--device", "cpu", "--dim", "64"])
    out = capsys.readouterr().out
    assert res["ok"]
    assert "row unit f32[1,128]: 512" in out
    for line in ("per-copy wait:", "chunked wait:", "chunked-wait speedup on DMA pipeline:"):
        assert line in out
    pipe = _json_lines(out)["pipe"]
    assert pipe["slot0_matches_tpu_output"] and pipe["stages"] == 2  # 2 chunks a block
    assert pipe["per_copy"]["bit_equal"] and pipe["chunked"]["repeatable"]
    assert pipe["max_abs_err"] == 0 and pipe["copy_bytes"] == 2 * 128 * 512
    assert res["unit"]["bytes"] == 2 * 512 + 16 + 8 * len(sem_probe.UNIT_FIELDS)


def test_tool_dim_above_the_tags_probes_its_own_row():
    res = tool.main(["--device", "cpu", "--dim", "300", "--quick"])
    assert res["unit"]["row_tag"] == "f32[3,128]" and res["unit"]["row_unit"] == 1536
    assert res["chunk"]["flag"] == 64 * 1536


def test_tool_asks_for_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the default device is then valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        tool.main(["--quick"])


# ----------------------------------------------------------- wrappers ---


def _fake_cuda(*shapes_dtypes):
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        return [torch.zeros(shape, dtype=dtype, device="cuda")
                for shape, dtype in shapes_dtypes]


@pytest.mark.filterwarnings("ignore:Accessing the data pointer of FakeTensor")
@pytest.mark.parametrize("probe", ["unit", "chunk", "pipe"])
def test_wrappers_launch_or_raise_on_a_cuda_tensor(probe):
    """Without a card (and without nvcc) a CUDA tensor gets no plain
    version: the wrapper goes for the kernel and raises."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the kernels run there")
    x, ids = _fake_cuda(((4096, 2, 128), torch.float32), ((128,), torch.int32))
    call = {"unit": lambda: sem_probe.unit_probe(x, 1),
            "chunk": lambda: sem_probe.chunk_probe(x, ids[:CH]),
            "pipe": lambda: sem_probe.pipe_probe(x, ids, 2, True)}[probe]
    with pytest.raises(RuntimeError):
        call()


@pytest.mark.parametrize("case", ["rows_24_bytes", "base_off_words", "f16", "f64",
                                  "ids_int64", "ids_2d", "chunk_too_large",
                                  "pipe_ragged", "pipe_stage_too_large",
                                  "unit_rows", "arm_extra"])
def test_wrappers_reject_what_the_kernels_do_not_take(case):
    x = torch.zeros(4096, 2, 128)
    ids = torch.zeros(128, dtype=torch.int32)
    err = ValueError
    if case == "rows_24_bytes":
        call = lambda: sem_probe.unit_probe(torch.zeros(16, 6), 1)  # noqa: E731
    elif case == "base_off_words":
        shifted = torch.zeros(17 * 256)[1:-255].view(16, 2, 128)  # 4 B off
        call = lambda: sem_probe.chunk_probe(shifted, ids[:4])  # noqa: E731
    elif case in ("f16", "f64"):
        err = TypeError
        y = x.half() if case == "f16" else x.double()
        call = lambda: sem_probe.pipe_probe(y, ids, 2, True)  # noqa: E731
    elif case == "ids_int64":
        err = TypeError
        call = lambda: sem_probe.chunk_probe(x, ids.long())  # noqa: E731
    elif case == "ids_2d":
        call = lambda: sem_probe.chunk_probe(x, ids.view(2, 64))  # noqa: E731
    elif case == "chunk_too_large":  # 64 rows of 4 KB: 256 KB of shared memory
        call = lambda: sem_probe.chunk_probe(torch.zeros(64, 8, 128), ids[:64])  # noqa: E731
    elif case == "pipe_ragged":
        call = lambda: sem_probe.pipe_probe(x, ids[:100], 2, False)  # noqa: E731
    elif case == "pipe_stage_too_large":
        call = lambda: sem_probe.pipe_probe(torch.zeros(64, 8, 128), ids, 2, True)  # noqa: E731
    elif case == "unit_rows":
        call = lambda: sem_probe.unit_probe(x[:8], 9)  # noqa: E731
    else:
        call = lambda: sem_probe.chunk_probe(x, ids[:4], arm_extra=8)  # noqa: E731
    with pytest.raises(err):
        call()


def test_plain_chunk_refuses_a_phase_that_never_completes():
    with pytest.raises(ValueError, match="never completes"):
        sem_probe.chunk_probe(torch.zeros(64, 2, 128), torch.zeros(4, dtype=torch.int32),
                              arm_extra=16)


@pytest.mark.parametrize("s,stages", [(1, 3), (2, 3), (3, 2), (4, 1), (8, 0)])
def test_pipe_ring_fits_in_shared_memory(s, stages):
    assert sem_probe.pipe_stages(s * 128 * 4) == stages


def test_plain_versions_do_not_count_launches(monkeypatch):
    counters = (sem_probe.unit_probe, sem_probe.chunk_probe, sem_probe.pipe_probe,
                rowdma.gather_rows)
    before = [f.launches for f in counters]
    _small_pipe(monkeypatch, 2, 64, 500)
    tool.main(["--device", "cpu", "--dim", "64"])
    assert [f.launches for f in counters] == before


# ------------------------------------------- the pipe kernel's schedule ---


def _dealt_chunks(nch: int, g: int) -> list:
    """The chunks each CTA rank of a cluster of g takes in
    ``csrc/sem_probe.cu``'s ``pipe_probe_kernel``, by its own arithmetic:
    ``mine = rank < nch ? (nch - rank + g - 1) / g : 0`` chunks, the i-th
    being chunk ``rank + i * g``."""
    return [[rank + i * g for i in range((nch - rank + g - 1) // g if rank < nch else 0)]
            for rank in range(g)]


@pytest.mark.parametrize("g,chunks", [(4, 3), (2, 7), (2, 29)])
def test_cluster_schedule_equals_plain(g, chunks):
    """The kernel's dealing covers each chunk of a block exactly once (a
    rank with no chunk when G exceeds the chunks, unequal shares otherwise),
    rank 0's first chunk is chunk 0, whose first word is ``first``, and the
    ranks' XORs combined equal :func:`pipe_probe_plain`."""
    dealt = _dealt_chunks(chunks, g)
    assert sorted(c for mine in dealt for c in mine) == list(range(chunks))
    assert dealt[0][0] == 0
    blocks, v = 2, 500
    rng = np.random.default_rng(10 * g + chunks)
    x = rng.random((v, 1, 128), dtype=np.float32)
    ids = rng.integers(0, v, blocks * chunks * CH).astype(np.int32)
    words = x.view(np.uint32).reshape(v, -1)
    out = np.zeros((blocks, 2), np.uint32)
    for b in range(blocks):
        chunk_ids = ids[b * chunks * CH:(b + 1) * chunks * CH].reshape(chunks, CH)
        ranks = [np.bitwise_xor.reduce(words[chunk_ids[mine]].ravel(), initial=np.uint32(0))
                 for mine in dealt]
        out[b] = words[chunk_ids[dealt[0][0], 0], 0], np.bitwise_xor.reduce(ranks)
    want = sem_probe.pipe_probe_plain(torch.from_numpy(x), torch.from_numpy(ids), blocks)
    np.testing.assert_array_equal(out.view(np.int32), want.numpy())


def test_pipe_plan_on_the_cpu_names_only_the_stages():
    """On the CPU the plain versions run: no cluster, CTA or lane to name."""
    x, ids = torch.zeros(500, 2, 128), torch.zeros(2 * 29 * CH, dtype=torch.int32)
    plan = sem_probe.pipe_plan(x, ids, 2, True)
    assert plan["stages"] == 3
    assert all(v is None for k, v in plan.items() if k != "stages"), plan
    assert set(sem_probe.chunk_plan(x).values()) == {None}
