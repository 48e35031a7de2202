"""The mesh's collectives, meshed word2vec and its grouped plane, meshed
Wide & Deep and its checkpoint, and the wire codecs (``comm_dtype``) on
the card, under a ``(1, 1)`` mesh of a one-rank NCCL group (NCCL puts no two
ranks on one card; the multi-rank meshes are the gloo tests on the CPU and
``chip_smoke.py``'s ``mesh`` phase).

Every test here needs an NVIDIA GPU and skips without one. The file imports
neither JAX nor the JAX package, so on a machine with a card it runs
without the suite's conftest:

    python -m pytest tests/test_torch_cuda_mesh.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from swiftsnails_tpu_torch import convert
from swiftsnails_tpu_torch.data.vocab import Vocab
from swiftsnails_tpu_torch.framework.trainer import TrainLoop
from swiftsnails_tpu_torch.models.word2vec import Word2VecTrainer
from swiftsnails_tpu_torch.ops import rowdma
from swiftsnails_tpu_torch.parallel import store, transfer
from swiftsnails_tpu_torch.parallel.access import SgdAccess
from swiftsnails_tpu_torch.utils.config import Config

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def nccl_mesh(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch.distributed as dist

    from swiftsnails_tpu_torch.parallel.mesh import make_mesh

    init = f"file://{tmp_path_factory.mktemp('nccl')}/rendezvous"
    dist.init_process_group("nccl", init_method=init, rank=0, world_size=1,
                            device_id=torch.device("cuda", torch.cuda.current_device()))
    try:
        yield make_mesh({"data": 1, "model": 1})
    finally:
        dist.destroy_process_group()


def test_packed_collectives_launch_the_row_kernels(nccl_mesh):
    """Pull and push over the one-rank mesh: bit-equal to the one-device
    ``pull_packed`` / ``push_packed``, one ``gather_rows`` and one
    ``scatter_add_rows`` launch each, the collectives counted."""
    rng = np.random.default_rng(0)
    whole = np.zeros((4096, 2, 128), np.float32)
    whole.reshape(4096, -1)[:, :200] = rng.standard_normal((4096, 200))
    rows = torch.from_numpy(rng.integers(0, 4096, 1024).astype(np.int32)).cuda()
    grads = torch.zeros((1024, 2, 128), device="cuda")
    grads.reshape(1024, -1)[:, :200] = torch.randn(1024, 200, device="cuda")
    meshed = convert.table_shard_from_numpy(whole, nccl_mesh, device="cuda")
    one = convert.packed_table_from_numpy(whole, device="cuda")
    transfer.reset_comm()
    g0, s0 = rowdma.gather_rows.launches, rowdma.scatter_add_rows.launches
    pulled = transfer.pull_collective_packed(nccl_mesh, meshed, rows)
    transfer.push_collective_packed(nccl_mesh, meshed, rows, grads, SgdAccess(), 0.1)
    torch.cuda.synchronize()
    assert (rowdma.gather_rows.launches - g0, rowdma.scatter_add_rows.launches - s0) == (1, 1)
    assert torch.equal(pulled, store.pull_packed(one, rows))
    store.push_packed(one, rows, grads, SgdAccess(), 0.1)
    assert torch.equal(meshed.table, one.table)
    assert transfer.COMM["all_reduce_calls"] == 1 and transfer.COMM["all_gather_calls"] == 2
    assert transfer.comm_bytes() == 1024 * 1024 + 1024 * (4 + 1024)


@pytest.mark.parametrize("over", [{}, {"packed": "0"}], ids=["packed", "dense"])
def test_meshed_word2vec_is_the_unmeshed_run(nccl_mesh, over):
    """``TrainLoop`` under the one-rank mesh, 4 steps: tables bit-equal to
    the unmeshed run on the card."""
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 512, 20_000).astype(np.int32)
    vocab = Vocab([f"w{i}" for i in range(512)],
                  np.maximum(np.bincount(ids, minlength=512), 1))
    conf = Config({"dim": "200", "window": "3", "negatives": "4", "learning_rate": "0.5",
                   "batch_size": "1024", "subsample": "0", "pool_size": "16",
                   "pool_block": "256", "use_native": "0", **over})
    states = [TrainLoop(Word2VecTrainer(conf, mesh=m, corpus_ids=ids, vocab=vocab),
                        log_every=0).run(max_steps=4) for m in (None, nccl_mesh)]
    for a, b in zip(*states):
        assert torch.equal(a.table, b.table)


@pytest.mark.parametrize("route", ["grouped", "dedup", "overlap1"])
def test_grouped_plane_is_the_cpu_port(nccl_mesh, route):
    """The grouped collective plane (plain, dedup, ``overlap: 1``) on the
    one-rank NCCL mesh at the CPU tests' size (``torch_mesh_ranks``'s
    grouped routes: 3 calls from one start, windows with ``-1`` pads, the
    same pools) against the port on a one-rank gloo mesh on the CPU: tables
    and losses within rtol 1e-5 / atol 1e-6, the same dropped counts;
    ``gather_rows`` and ``scatter_add_rows`` launched once a pull and once a
    push (2 a substep each; ``overlap`` adds one pull a call)."""
    import torch.distributed as dist

    import torch_mesh_ranks as ranks
    from swiftsnails_tpu_torch.parallel.mesh import Mesh

    group = dist.new_group([0], backend="gloo")
    cpu_mesh = Mesh(shape={"data": 1, "model": 1}, coords={"data": 0, "model": 0},
                    groups={"data": group, "model": group}, device=torch.device("cpu"))
    want = ranks.grouped_route(cpu_mesh, route)
    g0, s0 = rowdma.gather_rows.launches, rowdma.scatter_add_rows.launches
    got = ranks.grouped_route(nccl_mesh, route)
    torch.cuda.synchronize()
    t = int(ranks.GROUPED_ROUTES[route].get("steps_per_call", "1"))
    pulls = ranks.GROUPED_STEPS * (t + int(ranks.GROUPED_ROUTES[route].get("overlap", "0")))
    assert rowdma.gather_rows.launches - g0 == 2 * pulls
    assert rowdma.scatter_add_rows.launches - s0 == 2 * ranks.GROUPED_STEPS * t
    for a, b in zip(got["tables"], want["tables"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5, atol=1e-6)
    assert got["dropped"] == want["dropped"]
    assert all(c == p for c, p in got["counted"])


def _cpu_mesh():
    """A (1, 1) mesh of a one-rank gloo group on the CPU, beside the NCCL
    one."""
    import torch.distributed as dist

    from swiftsnails_tpu_torch.parallel.mesh import Mesh

    group = dist.new_group([0], backend="gloo")
    return Mesh(shape={"data": 1, "model": 1}, coords={"data": 0, "model": 0},
                groups={"data": group, "model": group}, device=torch.device("cpu"))


def test_meshed_widedeep_and_its_checkpoint_are_the_cpu_port(nccl_mesh, tmp_path):
    """Wide & Deep on the small-row plane (``torch_mesh_ranks``'s case: 3
    steps from one start, padding fields, AdaGrad) on the one-rank NCCL
    mesh against the port on a one-rank gloo mesh on the CPU: arrays,
    losses and predictions within rtol 1e-5 / atol 1e-6; one
    ``gather_rows`` a pull (3 steps and the prediction) and one
    ``scatter_adagrad_fused_rows`` a push. Its mesh checkpoint restores onto
    the NCCL mesh and onto one CPU device bit for bit."""
    import torch_mesh_ranks as ranks
    from swiftsnails_tpu_torch.framework import checkpoint as ckpt
    from swiftsnails_tpu_torch.utils.tree import tensor_items

    want = ranks.ctr_run(_cpu_mesh(), "widedeep")
    g0, a0 = rowdma.gather_rows.launches, rowdma.scatter_adagrad_fused_rows.launches
    got = ranks.ctr_run(nccl_mesh, "widedeep", keep=True)
    torch.cuda.synchronize()
    assert rowdma.gather_rows.launches - g0 == ranks.CTR_STEPS + 1
    assert rowdma.scatter_adagrad_fused_rows.launches - a0 == ranks.CTR_STEPS
    for name, w in want["arrays"].items():
        np.testing.assert_allclose(got["arrays"][name].numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["predict"].numpy(), want["predict"].numpy(),
                               rtol=1e-5, atol=1e-6)
    assert all(c == p for c, p in got["counted"])
    state, root = got["state"], str(tmp_path / "ck")
    ckpt.save_checkpoint(root, state, step=ranks.CTR_STEPS, mesh=nccl_mesh)
    for template, m in ((got["trainer"].init_state(), nccl_mesh),
                        (ranks.ctr_solo("widedeep").init_state(), None)):
        restored = dict(tensor_items(ckpt.restore_checkpoint(root, template, mesh=m)))
        for key, t in tensor_items(state):
            assert torch.equal(restored[key].cpu(), t.cpu()), key


# ------------------------------------------------------ the wire codecs ---

WIRES = ["bfloat16", "int8", "int4", "int4/16"]


@pytest.mark.parametrize("wire", WIRES)
def test_codecs_on_the_card_are_the_cpus(wire):
    """Each codec on the card bit-equal to the CPU's, deterministic and
    dithered (a seed tensor, and rows at a place), on packed and small
    rows with a zero row."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from swiftsnails_tpu_torch.parallel import comm

    rng = np.random.default_rng(5)
    for shape in ((2048, 2, 128), (4096, 17)):
        x = (rng.standard_normal(shape) * np.exp(rng.standard_normal((shape[0],) + (1,) * (len(shape) - 1)))).astype(np.float32)
        x[7] = 0.0
        cpu = torch.from_numpy(x)
        seed = torch.tensor(0xFFFFFFF0, dtype=torch.int64)
        place = (torch.arange(shape[0]) * 3 % 5000, torch.full((shape[0],), 12345))
        for kw in ({}, {"stochastic": True, "seed": seed},
                   {"stochastic": True, "place": place}):
            card = {k: (tuple(t.cuda() for t in v) if k == "place" else
                        v.cuda() if isinstance(v, torch.Tensor) else v) for k, v in kw.items()}
            if wire == "bfloat16":
                got, want = cpu.cuda().to(torch.bfloat16).cpu(), cpu.to(torch.bfloat16)
                assert torch.equal(got.view(torch.int16), want.view(torch.int16))
                continue
            if wire == "int8":
                q, s = comm.quantize_int8(cpu.cuda(), **card)
                wq, ws = comm.quantize_int8(cpu, **kw)
                deq, wdeq = comm.dequantize_int8(q, s), comm.dequantize_int8(wq, ws)
            else:
                blk = comm.int4_block(wire)
                q, s = comm.quantize_int4(cpu.cuda(), block=blk, **card)
                wq, ws = comm.quantize_int4(cpu, block=blk, **kw)
                deq = comm.dequantize_int4(q, s, shape, block=blk)
                wdeq = comm.dequantize_int4(wq, ws, shape, block=blk)
                s, ws = s.view(torch.int16), ws.view(torch.int16)
            assert torch.equal(q.cpu(), wq) and torch.equal(s.cpu(), ws), kw
            assert torch.equal(deq.cpu(), wdeq)


@pytest.mark.parametrize("wire", WIRES)
def test_quantized_pulls_are_the_wire_cast(nccl_mesh, wire):
    """Over one rank the owner-exclusive sum passes the codes through: the
    meshed pull (packed, and small rows of dim 17) is the unmeshed pull
    through serving's ``_wire_cast``, bit for bit."""
    from swiftsnails_tpu_torch.serving.kernels import _wire_cast

    rng = np.random.default_rng(2)
    whole = np.zeros((4096, 2, 128), np.float32)
    whole.reshape(4096, -1)[:, :200] = rng.standard_normal((4096, 200))
    rows = torch.from_numpy(rng.integers(0, 4096, 1024).astype(np.int32)).cuda()
    meshed = convert.table_shard_from_numpy(whole, nccl_mesh, device="cuda")
    got = transfer.pull_collective_packed(nccl_mesh, meshed, rows, comm_dtype=wire)
    want = _wire_cast(store.pull_packed(meshed, rows), wire)
    assert torch.equal(got, want)
    live = (np.arange(128) % 32) < 17
    small = (rng.standard_normal((1024, 1, 128)) * live).astype(np.float32)
    st = convert.table_shard_from_numpy(small, nccl_mesh, device="cuda")
    got = transfer.pull_collective_packed_small(nccl_mesh, st, rows, 17, comm_dtype=wire)
    assert torch.equal(got, _wire_cast(store.pull_packed_small(st, rows, 17), wire))


@pytest.mark.parametrize("wire", ["bfloat16", "int8", "int4"])
def test_grouped_plane_under_a_wire_is_the_cpu_port(nccl_mesh, wire):
    """The grouped plane under a wire on the one-rank NCCL mesh against
    the port on a one-rank gloo mesh on the CPU, the same dither seeds:
    every table element within one quantization step of the most its row
    moved, summed over the pushes (the card's gradients differ in f32
    rounding, so a code may round the other way); the counted bytes equal
    ``step_cost``'s; the row kernels launched as at f32."""
    import torch_comm_ranks as cr
    import torch_mesh_ranks as ranks

    seeds = [[1000 + i] for i in range(ranks.GROUPED_STEPS)]
    want = cr.grouped_wire_route(_cpu_mesh(), "grouped", wire, seeds)
    g0, s0 = rowdma.gather_rows.launches, rowdma.scatter_add_rows.launches
    got = cr.grouped_wire_route(nccl_mesh, "grouped", wire, seeds)
    torch.cuda.synchronize()
    assert rowdma.gather_rows.launches - g0 == 2 * ranks.GROUPED_STEPS
    assert rowdma.scatter_add_rows.launches - s0 == 2 * ranks.GROUPED_STEPS
    starts, _, _ = ranks.grouped_inputs("grouped")
    share = {"bfloat16": 2.0 ** -7, "int8": 1 / 127, "int4": 1 / 7}[wire]
    for a, b, s in zip(got["tables"], want["tables"], starts):
        a, b, s = a.cpu().numpy(), b.numpy(), s
        moved = np.maximum(np.abs(a - s), np.abs(b - s)).reshape(len(s), -1).max(axis=1)
        bound = 2 * ranks.GROUPED_STEPS * share * moved[:, None] + 1e-6
        assert np.all(np.abs(a - b).reshape(len(s), -1) <= bound)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-3)
    assert all(c == p for c, p in got["counted"])


# ------------------------------------------- hybrid placement, ZeRO, dense_tp ---


@pytest.mark.parametrize("route", ["grouped", "tight", "overlap2"])
def test_grouped_hybrid_is_the_cpu_port(nccl_mesh, route):
    """The grouped plane with ``placement: hybrid`` (``torch_placement_ranks``'s
    routes: a head of 64 rows; ``tight`` a tail cap that overflows) on the
    one-rank NCCL mesh against the port on a one-rank gloo mesh on the CPU:
    tables and losses within rtol 1e-5 / atol 1e-6, the same
    ``hybrid_dropped`` counts, the counted bytes ``step_cost``'s, the tail's
    row kernels launched as the uniform plane's (the head is plain torch)."""
    import torch_placement_ranks as pr

    want = pr.grouped_run(_cpu_mesh(), route)
    g0, s0 = rowdma.gather_rows.launches, rowdma.scatter_add_rows.launches
    got = pr.grouped_run(nccl_mesh, route)
    torch.cuda.synchronize()
    tables, calls, _ = pr.grouped_inputs(route)
    t = pr.GROUPED_HYBRID[route].get("steps_per_call", "1")
    pulls = len(calls) * (int(t) + int(pr.GROUPED_HYBRID[route].get("overlap", "0")))
    assert rowdma.gather_rows.launches - g0 == 2 * pulls
    assert rowdma.scatter_add_rows.launches - s0 == 2 * len(calls) * int(t)
    for a, b in zip(got["tables"], want["tables"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5, atol=1e-6)
    assert got["dropped"] == want["dropped"]
    assert all(c == p for c, p in got["counted"])


@pytest.mark.parametrize("over", [{"packed": "0", "optimizer_sharding": "zero"},
                                  {"optimizer_sharding": "zero"},
                                  {"placement": "uniform", "dense_tp": "1"}],
                         ids=["2d_hybrid_zero", "small_hybrid_zero", "dense_tp"])
def test_widedeep_layouts_are_the_cpu_port(nccl_mesh, over):
    """W&D (the JAX zero tests' shape, a hybrid head of 128 rows) through the
    layouts the loop adopts, 3 steps, on the one-rank NCCL mesh against
    the one-rank gloo mesh on the CPU: arrays within rtol 1e-5 / atol 1e-6,
    the counted bytes ``step_cost``'s; on the small-row plane one
    ``gather_rows`` and one ``scatter_adagrad_fused_rows`` a step (the
    tail's)."""
    import torch_placement_ranks as pr

    want = pr.wd_steps(_cpu_mesh(), **over)
    g0, a0 = rowdma.gather_rows.launches, rowdma.scatter_adagrad_fused_rows.launches
    got = pr.wd_steps(nccl_mesh, **over)
    torch.cuda.synchronize()
    if over.get("packed") != "0":
        assert rowdma.gather_rows.launches - g0 == 3
        assert rowdma.scatter_adagrad_fused_rows.launches - a0 == 3
    assert sorted(got["state"]) == sorted(want["state"])
    for k, w in want["state"].items():
        np.testing.assert_allclose(got["state"][k].numpy(), w.numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5, atol=1e-6)
    assert all(c == p for c, p in got["counted"])
