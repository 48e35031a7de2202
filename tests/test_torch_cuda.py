"""The port's CUDA kernels and its slice on the card.

Every test here needs an NVIDIA GPU and skips without one. The file imports
neither JAX nor the JAX package, so on a machine with a card and no JAX it
runs without the suite's conftest:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from swiftsnails_tpu_torch.ops import rowdma

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA C++ with no "
                    "CPU build")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [1, 2])
def test_kernels_bit_equal_to_plain(cuda_device, dtype, s):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    c = 4096
    table = torch.randn(c, s, 128, generator=gen, device=cuda_device).to(dtype)
    rows = torch.randint(0, c, (1001,), generator=gen, device=cuda_device,
                         dtype=torch.int32)
    n0 = rowdma.gather_rows.launches
    got = rowdma.gather_rows(table, rows)
    assert rowdma.gather_rows.launches == n0 + 1
    assert torch.equal(got, rowdma.gather_rows_plain(table, rows))

    uniq = torch.unique(rows)
    pad = torch.full((37,), c, dtype=torch.int32, device=cuda_device)
    srows = torch.cat([uniq, pad])
    deltas = torch.randn(srows.shape[0], s, 128, generator=gen,
                         device=cuda_device).to(dtype)
    want = rowdma.scatter_add_rows_plain(table.clone(), srows, deltas)
    n0 = rowdma.scatter_add_rows.launches
    got = rowdma.scatter_add_rows(table, srows, deltas)
    torch.cuda.synchronize()
    assert rowdma.scatter_add_rows.launches == n0 + 1
    assert torch.equal(got, want)


def test_gather_out_of_range_ids_read_nothing(cuda_device):
    table = torch.ones(16, 1, 128, device=cuda_device)
    rows = torch.tensor([0, 16, -1, 15], dtype=torch.int32, device=cuda_device)
    got = rowdma.gather_rows(table, rows)
    torch.cuda.synchronize()
    assert got[[0, 3]].eq(1).all() and not got[[1, 2]].any()


def test_wrapper_rejects_rows_not_in_16_byte_words(cuda_device):
    rows = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    narrow = torch.zeros(16, 6, device=cuda_device)  # 24-byte rows
    with pytest.raises(ValueError, match="16-byte words"):
        rowdma.gather_rows(narrow, rows)
    shifted = torch.zeros(16 * 128 + 1, device=cuda_device)[1:].view(16, 128)
    with pytest.raises(ValueError, match="16-byte words"):
        rowdma.scatter_add_rows(shifted, rows, torch.zeros(2, 128, device=cuda_device))
    assert rowdma.gather_rows(shifted[:, :124].contiguous(), rows).shape == (2, 124)


def test_wrapper_rejects_a_cpu_rows_tensor(cuda_device):
    with pytest.raises(ValueError, match="rows on cpu"):
        rowdma.gather_rows(torch.zeros(4, 1, 128, device=cuda_device),
                           torch.zeros(2, dtype=torch.int32))


def test_train_loop_launches_both_kernels(cuda_device):
    from swiftsnails_tpu_torch.data.vocab import Vocab
    from swiftsnails_tpu_torch.framework.trainer import TrainLoop
    from swiftsnails_tpu_torch.models.word2vec import Word2VecTrainer
    from swiftsnails_tpu_torch.utils.config import Config

    rng = np.random.default_rng(0)
    ids = rng.integers(0, 300, 20_000).astype(np.int32)
    vocab = Vocab([f"w{i}" for i in range(300)], np.bincount(ids, minlength=300) + 1)
    cfg = Config({"dim": "200", "window": "3", "negatives": "5",
                  "batch_size": "1024", "subsample": "0", "steps_per_call": "2",
                  "pool_size": "16", "pool_block": "128"})
    trainer = Word2VecTrainer(cfg, corpus_ids=ids, vocab=vocab)
    assert trainer.device.type == "cuda"
    before = (rowdma.gather_rows.launches, rowdma.scatter_add_rows.launches)
    state = TrainLoop(trainer, log_every=0).run(max_steps=3)
    after = (rowdma.gather_rows.launches, rowdma.scatter_add_rows.launches)
    assert [a - b for a, b in zip(after, before)] == [12, 12]  # 3 calls x 2 substeps x 2
    assert all(torch.isfinite(t.table).all() for t in state)


# ------------------------------------------------------- fused SGNS ---


def _block_local(rng, nblocks, per_block, span):
    """[nblocks * per_block] int32 ids, block b's drawn from its own range
    [b * span, (b + 1) * span): duplicates within blocks, none across."""
    ids = rng.integers(0, span, (nblocks, per_block)) + span * np.arange(nblocks)[:, None]
    return ids.reshape(-1).astype(np.int32)


def _fused_case(kind, dev, dtype, seed=0, nblocks=6, span=48):
    """Tables and block-local ids for one step of ``kind`` (flat or grouped),
    with contexts sharing rows with the pool and pads in the windows."""
    from swiftsnails_tpu_torch.ops import fused_sgns

    rng = np.random.default_rng(seed)
    cap = nblocks * span
    lanes = np.arange(256).reshape(2, 128) < 200  # dim 200: zero padding lanes
    tables = [torch.from_numpy((rng.normal(size=(cap, 2, 128)) * 0.1 * lanes)
                               .astype(np.float32)).to(dev, dtype) for _ in range(2)]
    pool = _block_local(rng, nblocks, 16, span)
    if kind == "flat":
        p = 64
        ids = [_block_local(rng, nblocks, p, span) for _ in range(2)]
        args = dict(in_rows=ids[0], pos_rows=ids[1], pool_rows=pool)
        fn, kw = fused_sgns.fused_sgns_step, dict(lr=0.05 * p * nblocks, lam=0.3,
                                                   pairs_per_block=p, pool_size=16)
    else:
        pc, window = 32, 3
        ctxs = _block_local(rng, nblocks, pc * 2 * window, span).reshape(-1, 2 * window)
        ctxs[rng.random(ctxs.shape) < 0.3] = -1
        ctxs[5] = -1
        args = dict(centers=_block_local(rng, nblocks, pc, span), ctxs=ctxs, pool_rows=pool)
        fn, kw = fused_sgns.fused_sgns_grouped_step, dict(
            lr=0.05 * pc * nblocks * (window + 1), lam=0.3, window=window,
            centers_per_block=pc, pool_size=16)
    args = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in args.items()}
    return fn, tables, args, kw


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["flat", "grouped"])
def test_fused_kernels_match_plain_on_block_local_inputs(cuda_device, kind, dtype):
    from swiftsnails_tpu_torch.ops import fused_sgns

    fn, tables, args, kw = _fused_case(kind, cuda_device, dtype)
    plain = getattr(fused_sgns, fn.__name__ + "_plain")
    want = plain(*[t.clone() for t in tables], *args.values(), **kw)
    n0 = fn.launches
    got = [fn(*[t.clone() for t in tables], *args.values(), **kw) for _ in range(2)]
    torch.cuda.synchronize()
    assert fn.launches == n0 + 2
    rtol, atol = (1e-5, 1e-6) if dtype == torch.float32 else (2.0**-7, 1e-6)
    for g, w in zip(got[0], want):
        torch.testing.assert_close(g.float(), w.float(), rtol=rtol, atol=atol)
    assert all(torch.equal(a, b) for a, b in zip(got[0], got[1]))  # bit-identical
    for t in got[0][:2]:
        assert not t.reshape(t.shape[0], -1)[:, 200:].any()


def test_grouped_kernel_never_reads_a_pad(cuda_device):
    """Row 0 of the out-table is NaN and only the pads (-1) would reach it."""
    fn, tables, args, kw = _fused_case("grouped", cuda_device, torch.float32)
    for ids in args.values():
        ids[ids == 0] = 1
    tables[1][0] = float("nan")
    a, b, loss = fn(*tables, *args.values(), **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(a).all() and torch.isfinite(b[1:]).all()
    assert torch.isfinite(loss)


@pytest.mark.parametrize("grouped", [0, 1])
def test_train_loop_launches_the_fused_kernel(cuda_device, grouped):
    from swiftsnails_tpu_torch.data.vocab import Vocab
    from swiftsnails_tpu_torch.framework.trainer import TrainLoop
    from swiftsnails_tpu_torch.models.word2vec import Word2VecTrainer
    from swiftsnails_tpu_torch.ops import fused_sgns
    from swiftsnails_tpu_torch.utils.config import Config

    rng = np.random.default_rng(0)
    ids = rng.integers(0, 300, 20_000).astype(np.int32)
    vocab = Vocab([f"w{i}" for i in range(300)], np.bincount(ids, minlength=300) + 1)
    cfg = Config({"dim": "200", "window": "3", "negatives": "5",
                  "batch_size": "1024", "subsample": "0", "steps_per_call": "2",
                  "pool_size": "16", "pool_block": "128", "centers_per_block": "128",
                  "fused": "1", "grouped": str(grouped)})
    trainer = Word2VecTrainer(cfg, corpus_ids=ids, vocab=vocab)
    kernel = (fused_sgns.fused_sgns_grouped_step if grouped
              else fused_sgns.fused_sgns_step)
    counters = (kernel, rowdma.gather_rows, rowdma.scatter_add_rows)
    before = [f.launches for f in counters]
    state = TrainLoop(trainer, log_every=0).run(max_steps=3)
    assert [f.launches - b for f, b in zip(counters, before)] == [6, 0, 0]
    assert all(torch.isfinite(t.table).all() for t in state)
