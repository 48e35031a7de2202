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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("row_bytes", [16, 272, 1024, 2048])
def test_gather_rows_bit_equal_to_index_select(cuda_device, dtype, row_bytes):
    """Any row width in 16-byte words, an N that is no multiple of the
    kernel's rows a warp, duplicates, and pads (-1 and ids at or past C) that
    read as zero rows."""
    gen = torch.Generator(device=cuda_device).manual_seed(row_bytes)
    c, n = 3000, 4 * 2503 + 3
    width = row_bytes * 8 // torch.finfo(dtype).bits
    table = torch.randn(c, width, generator=gen, device=cuda_device).to(dtype)
    rows = torch.randint(0, c, (n,), generator=gen, device=cuda_device, dtype=torch.int32)
    rows[::7] = rows[0]  # duplicates
    rows[5::11] = -1
    rows[9::13] = c
    pads = (rows < 0) | (rows >= c)
    want = table.index_select(0, rows.clamp(0, c - 1)).masked_fill_(pads[:, None], 0)
    got = rowdma.gather_rows(table, rows)
    torch.cuda.synchronize()
    assert got.shape == (n, width)
    assert torch.equal(got, want)
    assert torch.equal(rowdma.gather_rows(table, rows[:1]), want[:1])


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


# ------------------------------------------------- merged fused SGNS ---

_MERGED = {"resident": ("fused_sgns_resident_step", dict(hot_rows=256)),
           "dedup": ("fused_sgns_dedup_step", dict(u_cap=64)),
           "dedup_resident": ("fused_sgns_dedup_resident_step", dict(u_cap=64, hot_rows=64))}


def _zipf(rng, n, v):
    w = 1.0 / np.arange(1, v + 1) ** 1.05
    cdf = np.cumsum(w) / w.sum()
    return np.minimum(np.searchsorted(cdf, rng.random(n)), v - 1).astype(np.int32)


def _merged_case(kind, dev, dtype, seed=0, nblocks=6, cap=4096, local=False, pc=32,
                 step=0.05):
    """Tables and ids for one merged step, zipf over the whole table (rows
    shared within and across blocks, by contexts and pools) or with
    ``local`` block-local (no row in two blocks); pads in the windows; a
    step of ``step`` a pair."""
    from swiftsnails_tpu_torch.ops import fused_sgns

    rng = np.random.default_rng(seed)
    window, pool = 3, 16
    lanes = np.arange(256).reshape(2, 128) < 200
    tables = [torch.from_numpy((rng.normal(size=(cap, 2, 128)) * 0.1 * lanes)
                               .astype(np.float32)).to(dev, dtype) for _ in range(2)]
    span = cap // nblocks

    def ids(per_block):
        if local:
            return _block_local(rng, nblocks, per_block, span)
        return _zipf(rng, nblocks * per_block, cap)

    ctxs = ids(pc * 2 * window).reshape(-1, 2 * window)
    ctxs[rng.random(ctxs.shape) < 0.3] = -1
    ctxs[5] = -1
    args = dict(centers=ids(pc), ctxs=ctxs, pool_rows=ids(pool))
    args = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in args.items()}
    name, extra = _MERGED[kind]
    kw = dict(lr=step * pc * nblocks * (window + 1), lam=0.3, window=window,
              centers_per_block=pc, pool_size=pool, **extra)
    return getattr(fused_sgns, name), tables, args, kw


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", list(_MERGED))
def test_merged_kernels_match_plain(cuda_device, kind, dtype):
    """The blocks of a substep run in order on the card too, so the kernel
    equals its plain version on zipf ids in f32 and repeats bit for bit. In
    bf16 a row written by several blocks passes through several roundings,
    where a last-bit difference can flip one and carry on, so one bf16
    rounding is held where each row is written by one block."""
    from swiftsnails_tpu_torch.ops import fused_sgns

    fn, tables, args, kw = _merged_case(kind, cuda_device, dtype,
                                        local=dtype == torch.bfloat16)
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


_MAIN = {"resident": dict(hot_rows=2048), "dedup": dict(u_cap=384),
         "dedup_resident": dict(u_cap=384, hot_rows=256)}


def _zipf_ids(rng, shape, v):
    """Zipf ids over [0, v), drawn by inverse cdf."""
    cdf = np.cumsum(1.0 / np.arange(1, v + 1) ** 1.05)
    cdf /= cdf[-1]
    return np.minimum(np.searchsorted(cdf, rng.random(shape)), v - 1).astype(np.int32)


def _assert_merged_runs_like_plain(fn, tables, args, kw):
    """Two kernel runs bit-identical, within rtol 1e-5 / atol 1e-6 of the
    plain version (f32), padding lanes untouched, one launch each."""
    from swiftsnails_tpu_torch.ops import fused_sgns

    plain = getattr(fused_sgns, fn.__name__ + "_plain")
    want = plain(*[t.clone() for t in tables], *args.values(), **kw)
    n0 = fn.launches
    got = [fn(*[t.clone() for t in tables], *args.values(), **kw) for _ in range(2)]
    torch.cuda.synchronize()
    assert fn.launches == n0 + 2
    for g, w in zip(got[0], want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
    assert all(torch.equal(a, b) for a, b in zip(got[0], got[1]))
    for t in got[0][:2]:
        assert not t.reshape(t.shape[0], -1)[:, 200:].any()


@pytest.mark.parametrize("kind", list(_MAIN))
def test_merged_kernel_at_the_main_shape(cuda_device, kind):
    """32 kernel blocks of 256 centers, windows of 10 slots, pools of 64, f32
    rows of 256 lanes (dim 200) over 2^20 rows, ids zipf over all of them:
    the persistent launch walks the blocks as the plain version does."""
    from swiftsnails_tpu_torch.ops import fused_sgns

    rng = np.random.default_rng(11)
    cap, pc, window, pool, nb = 1 << 20, 256, 5, 64, 32
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    lanes = (torch.arange(256, device=cuda_device) < 200).view(2, 128)
    tables = [torch.randn(cap, 2, 128, generator=gen, device=cuda_device).mul_(0.1)
              .mul_(lanes) for _ in range(2)]
    ctxs = _zipf_ids(rng, (pc * nb, 2 * window), cap)
    ctxs[rng.random(ctxs.shape) < 0.3] = -1
    args = {k: torch.from_numpy(v).to(cuda_device) for k, v in (
        ("centers", _zipf_ids(rng, pc * nb, cap)), ("ctxs", ctxs),
        ("pool_rows", _zipf_ids(rng, pool * nb, cap)))}
    fn = getattr(fused_sgns, _MERGED[kind][0])
    kw = dict(lr=100.0, lam=5 / pool, window=window, centers_per_block=pc, pool_size=pool,
              **_MAIN[kind])
    _assert_merged_runs_like_plain(fn, tables, args, kw)


@pytest.mark.parametrize("kind", list(_MERGED))
def test_merged_kernel_splits_a_run_longer_than_a_cta_of_chunks(cuda_device, kind):
    """Block 1 names row 0 in every slot: its run (hot, or listed) has more
    slots than the chunks of all the warps of a CTA, so the CTA's warps sum
    it in pieces."""
    from swiftsnails_tpu_torch.ops import fused_sgns

    fn, tables, args, kw = _merged_case(kind, cuda_device, torch.float32, seed=3,
                                        nblocks=3, local=False, pc=96, step=0.005)
    pc = kw["centers_per_block"]
    for name, per in (("centers", pc), ("ctxs", pc), ("pool_rows", kw["pool_size"])):
        args[name][per:2 * per] = 0
    cap = tables[0].shape[0]
    hot_n = fused_sgns.effective_hot_rows(kw.get("hot_rows", 0), cap)[0]
    runs = fused_sgns.merged_prep(*args.values(), pc, kw["pool_size"], hot_n,
                                  kw.get("u_cap", 0), cap)
    longest = int((runs[1][:, 1:] - runs[1][:, :-1]).max())
    assert longest > fused_sgns.RUN_CHUNK * fused_sgns.MERGED_CTA_WARPS
    _assert_merged_runs_like_plain(fn, tables, args, kw)


@pytest.mark.parametrize("dtype,width", [(torch.float32, 6), (torch.float32, 200),
                                         (torch.float32, 512), (torch.bfloat16, 12),
                                         (torch.bfloat16, 136)])
@pytest.mark.parametrize("kind", list(_MERGED))
def test_merged_kernel_at_other_row_widths(cuda_device, kind, dtype, width):
    """Rows the kernel moves element by element (24 B), in 16-byte words
    (800 B, 272 B) and at its widest (512 lanes): within rtol 1e-5 / atol
    1e-6 of the plain version in f32, one bf16 rounding on block-local ids
    in bf16, and bit-identical run to run."""
    from swiftsnails_tpu_torch.ops import fused_sgns

    fn, tables, args, kw = _merged_case(kind, cuda_device, dtype,
                                        local=dtype == torch.bfloat16)
    gen = torch.Generator(device=cuda_device).manual_seed(width)
    tables = [torch.randn(t.shape[0], width, generator=gen, device=cuda_device).mul_(0.1)
              .to(dtype) for t in tables]
    plain = getattr(fused_sgns, fn.__name__ + "_plain")
    want = plain(*[t.clone() for t in tables], *args.values(), **kw)
    got = [fn(*[t.clone() for t in tables], *args.values(), **kw) for _ in range(2)]
    torch.cuda.synchronize()
    rtol, atol = (1e-5, 1e-6) if dtype == torch.float32 else (2.0**-7, 1e-6)
    for g, w in zip(got[0], want):
        torch.testing.assert_close(g.float(), w.float(), rtol=rtol, atol=atol)
    assert all(torch.equal(a, b) for a, b in zip(got[0], got[1]))


_BARRIER_MISSED = """
import torch
from swiftsnails_tpu_torch.ops import fused_sgns
tables = [torch.zeros(4096, 2, 128, device="cuda") for _ in range(2)]
centers = torch.arange(64, dtype=torch.int32, device="cuda")
ctxs = torch.arange(64 * 6, dtype=torch.int32, device="cuda").view(64, 6)
pool = torch.arange(2 * 16, dtype=torch.int32, device="cuda")
try:
    fused_sgns._merged_step(fused_sgns.fused_sgns_resident_step, *tables, centers, ctxs,
                            pool, 0.1, 0.3, 3, 32, 16, 64, 0, miss_barrier=2)
    torch.cuda.synchronize()
except RuntimeError as e:
    print("launch failed:", e)
print("status", fused_sgns.merged_deadline_status())
"""


def test_a_merged_barrier_past_its_deadline_traps(cuda_device):
    """In a subprocess (the trap leaves the CUDA context unusable): the first
    CTA skips the grid barrier after C(0), the others wait out the deadline,
    and the kernel traps with that barrier's code instead of hanging."""
    import pathlib
    import subprocess
    import sys

    root = pathlib.Path(__file__).resolve().parent.parent
    out = subprocess.run([sys.executable, "-c", _BARRIER_MISSED], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert "launch failed:" in out.stdout, out.stdout + out.stderr
    assert "status 2" in out.stdout, out.stdout + out.stderr


@pytest.mark.parametrize("kind", list(_MERGED))
def test_merged_kernel_never_reads_a_pad(cuda_device, kind):
    """Row 0 of the out-table is NaN and only the pads (-1) would reach it."""
    fn, tables, args, kw = _merged_case(kind, cuda_device, torch.float32)
    for ids in args.values():
        ids[ids == 0] = 1
    tables[1][0] = float("nan")
    a, b, loss = fn(*tables, *args.values(), **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(a).all() and torch.isfinite(b[1:]).all()
    assert torch.isfinite(loss)


@pytest.mark.parametrize("kind,keys", [
    ("resident", {"resident": "1", "hot_rows": "64"}),
    ("dedup", {"dedup": "1", "u_cap": "128"}),
    ("dedup_resident", {"dedup": "1", "u_cap": "128", "resident": "1", "hot_rows": "64"})])
def test_train_loop_launches_the_merged_kernel(cuda_device, kind, keys):
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
                  "pool_size": "16", "centers_per_block": "128", "fused": "1",
                  "grouped": "1", **keys})
    trainer = Word2VecTrainer(cfg, corpus_ids=ids, vocab=vocab)
    counters = [getattr(fused_sgns, _MERGED[k][0]) for k in _MERGED] + [
        fused_sgns.fused_sgns_grouped_step, fused_sgns.fused_sgns_step]
    before = [f.launches for f in counters]
    state = TrainLoop(trainer, log_every=0).run(max_steps=3)
    want = [6 if f.__name__ == _MERGED[kind][0] else 0 for f in counters]
    assert [f.launches - b for f, b in zip(counters, before)] == want
    assert all(torch.isfinite(t.table).all() for t in state)


# ------------------------------------------- scatter-write and AdaGrad ---


def _push_case(dev, dtype, s, seed=0, c=4096, n=1501):
    """A table and accumulator of ``s`` sublanes, unique rows with padding
    ids (at and past capacity, and -1) mixed in, and f32 gradients."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    table = torch.randn(c, s, 128, generator=gen, device=dev).to(dtype)
    accum = torch.rand(c, s, 128, generator=gen, device=dev).mul_(0.1).to(dtype)
    uniq = torch.randperm(c, generator=gen, device=dev)[:n].to(torch.int32)
    pad = torch.tensor([c, c + 5, -1] * 13, dtype=torch.int32, device=dev)
    rows = torch.cat([uniq, pad])[torch.randperm(n + 39, generator=gen, device=dev)]
    grads = torch.randn(rows.shape[0], s, 128, generator=gen, device=dev)
    return table, accum, rows.contiguous(), grads


def _ulps(got, want):
    """Largest distance in units in the last place of ``want``'s dtype."""
    eps = torch.finfo(want.dtype).eps
    scale = want.float().abs().clamp_min(torch.finfo(want.dtype).tiny)
    return float(((got.float() - want.float()).abs() / (scale * eps)).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [1, 2])
def test_scatter_write_and_adagrad_bit_equal_to_plain(cuda_device, dtype, s):
    table, accum, rows, grads = _push_case(cuda_device, dtype, s)
    values = grads.to(dtype)
    want = rowdma.scatter_write_rows_plain(table.clone(), rows, values)
    n0 = rowdma.scatter_write_rows.launches
    got = rowdma.scatter_write_rows(table.clone(), rows, values)
    torch.cuda.synchronize()
    assert rowdma.scatter_write_rows.launches == n0 + 1
    assert torch.equal(got, want)

    want_t, want_a = rowdma.scatter_adagrad_rows_plain(
        table.clone(), accum.clone(), rows, grads, 0.05)
    n0 = rowdma.scatter_adagrad_rows.launches
    runs = [rowdma.scatter_adagrad_rows(table.clone(), accum.clone(), rows, grads, 0.05)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert rowdma.scatter_adagrad_rows.launches == n0 + 2
    for got, want in zip(runs[0], (want_t, want_a)):
        assert torch.equal(got, want), _ulps(got, want)
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scatter_adagrad_fused_bit_equal_to_plain(cuda_device, dtype):
    param, accum, rows, grads = _push_case(cuda_device, dtype, 1, seed=1)
    table = torch.cat([param, accum], dim=1)  # sublane 0 param, 1 accum
    want = rowdma.scatter_adagrad_fused_rows_plain(table.clone(), rows, grads, 0.05)
    n0 = rowdma.scatter_adagrad_fused_rows.launches
    runs = [rowdma.scatter_adagrad_fused_rows(table.clone(), rows, grads, 0.05)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert rowdma.scatter_adagrad_fused_rows.launches == n0 + 2
    assert torch.equal(runs[0], want), _ulps(runs[0], want)
    assert torch.equal(runs[0], runs[1])
    # the accumulator sublane moved where a row was pushed, and only there
    valid = rows[(rows >= 0) & (rows < table.shape[0])].long()
    assert not torch.equal(runs[0][valid, 1], table[valid, 1])


def test_pushes_never_touch_padding_ids(cuda_device):
    """Ids at or past capacity, and negative ones, are skipped: every row
    that no valid id names is left as it was, and the gradients, values of
    the padding slots (NaN here) are never read."""
    table, accum, rows, grads = _push_case(cuda_device, torch.float32, 2, seed=2)
    is_pad = (rows < 0) | (rows >= table.shape[0])
    grads[is_pad] = float("nan")
    untouched = torch.ones(table.shape[0], dtype=torch.bool, device=cuda_device)
    untouched[rows[~is_pad].long()] = False
    fused = torch.cat([table[:, :1], accum[:, :1]], dim=1)
    t, a = rowdma.scatter_adagrad_rows(table.clone(), accum.clone(), rows, grads, 0.05)
    f = rowdma.scatter_adagrad_fused_rows(fused.clone(), rows, grads[:, :1].contiguous(), 0.05)
    w = rowdma.scatter_write_rows(table.clone(), rows, grads)
    torch.cuda.synchronize()
    for got, start in ((t, table), (a, accum), (f, fused), (w, table)):
        assert torch.equal(got[untouched], start[untouched])
        assert torch.isfinite(got).all()


def test_push_wrappers_refuse_cpu_ids_and_a_mismatched_accumulator(cuda_device):
    table, accum, rows, grads = _push_case(cuda_device, torch.float32, 1)
    with pytest.raises(ValueError, match="rows on cpu"):
        rowdma.scatter_adagrad_rows(table, accum, rows.cpu(), grads, 0.1)
    with pytest.raises(ValueError, match="rows on cpu"):
        rowdma.scatter_write_rows(table, rows.cpu(), grads)
    fused = torch.cat([table, accum], dim=1)
    with pytest.raises(ValueError, match="rows on cpu"):
        rowdma.scatter_adagrad_fused_rows(fused, rows.cpu(), grads, 0.1)
    with pytest.raises(TypeError, match="accum"):
        rowdma.scatter_adagrad_rows(table, accum.to(torch.bfloat16), rows, grads, 0.1)


def test_widedeep_train_loop_launches_the_fused_adagrad_kernel(cuda_device):
    from swiftsnails_tpu_torch.data.ctr import synth_ctr
    from swiftsnails_tpu_torch.framework.trainer import TrainLoop
    from swiftsnails_tpu_torch.models.registry import get_model
    from swiftsnails_tpu_torch.utils.config import Config

    labels, feats, _ = synth_ctr(4096, 8, 500, seed=0)
    cfg = Config({"num_fields": "8", "capacity": str(1 << 14), "embed_dim": "16",
                  "hidden_dims": "64,32", "optimizer": "adagrad",
                  "learning_rate": "0.05", "batch_size": "512", "seed": "0"})
    trainer = get_model("widedeep")(cfg, data=(labels, feats))
    assert trainer.device.type == "cuda"
    counters = [rowdma.gather_rows, rowdma.scatter_adagrad_fused_rows,
                rowdma.scatter_add_rows, rowdma.scatter_adagrad_rows,
                rowdma.scatter_write_rows]
    before = [f.launches for f in counters]
    state = TrainLoop(trainer, log_every=0).run(max_steps=5)
    assert [f.launches - b for f, b in zip(counters, before)] == [5, 5, 0, 0, 0]
    assert torch.isfinite(state.table.table).all()
    assert 0.0 <= trainer.eval_auc(state, limit=2048) <= 1.0


# ----------------------------------------------------- bulk-copy probes ---

_UNIT_TAGS = [(1, 1, torch.float32), (1, 2, torch.float32), (1, 4, torch.float32),
              (8, 2, torch.float32), (1, 2, torch.bfloat16)]


@pytest.mark.parametrize("rows,s,dtype", _UNIT_TAGS)
def test_unit_probe_accounts_bytes_and_over_arming_stays_pending(cuda_device, rows, s,
                                                                 dtype):
    from swiftsnails_tpu_torch.ops import sem_probe

    x = torch.ones((max(rows, 8), s, 128), dtype=dtype, device=cuda_device)
    n0 = sem_probe.unit_probe.launches
    got = sem_probe.unit_fields(sem_probe.unit_probe(x, rows))
    assert sem_probe.unit_probe.launches == n0 + 1
    want = sem_probe.unit_fields(sem_probe.unit_probe_plain(x, rows))
    assert got["unit"] == rows * s * 128 * x.element_size()
    assert got["over_done"] == 0  # 16 B above the copy: pending within the bound
    assert {k: v for k, v in got.items() if k not in sem_probe.UNIT_TIMES} == \
        {k: v for k, v in want.items() if k not in sem_probe.UNIT_TIMES}
    assert 0 < got["exact_polls"] < sem_probe.UNIT_POLLS and got["exact_cycles"] > 0


@pytest.mark.parametrize("s", [1, 2])
def test_chunk_probe_bit_equal_to_plain(cuda_device, s):
    from swiftsnails_tpu_torch.ops import sem_probe

    gen = torch.Generator(device=cuda_device).manual_seed(s)
    x = torch.randn(4096, s, 128, generator=gen, device=cuda_device)
    ids = torch.randint(0, 4096, (64,), generator=gen, device=cuda_device,
                        dtype=torch.int32)
    got, stats = sem_probe.chunk_probe(x, ids)
    want, want_stats = sem_probe.chunk_probe_plain(x, ids)
    assert torch.equal(got, want)
    assert int(stats[0]) == int(want_stats[0]) == 64 * s * 512


@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("s", [1, 2, 4])
def test_pipe_probe_bit_equal_and_repeatable(cuda_device, chunked, s):
    from swiftsnails_tpu_torch.ops import sem_probe

    gen = torch.Generator(device=cuda_device).manual_seed(s)
    x = torch.randn(20_000, s, 128, generator=gen, device=cuda_device)
    ids = torch.randint(0, 20_000, (8 * 640,), generator=gen, device=cuda_device,
                        dtype=torch.int32)
    n0 = sem_probe.pipe_probe.launches
    got = [sem_probe.pipe_probe(x, ids, 8, chunked) for _ in range(2)]
    assert sem_probe.pipe_probe.launches == n0 + 2
    assert torch.equal(got[0], sem_probe.pipe_probe_plain(x, ids, 8))
    assert torch.equal(got[0], got[1])


_DEADLINE = """
import torch
from swiftsnails_tpu_torch.ops import sem_probe
x = torch.ones(64, 2, 128, device="cuda")
ids = torch.arange(8, dtype=torch.int32, device="cuda")
try:
    sem_probe.chunk_probe(x, ids, arm_extra=16)  # a phase that never completes
    torch.cuda.synchronize()
except RuntimeError as e:
    print("launch failed:", e)
print("status", sem_probe.deadline_status())
"""


def test_a_wait_past_its_deadline_traps_instead_of_hanging(cuda_device):
    """In a subprocess: the trap leaves the CUDA context unusable."""
    import pathlib
    import subprocess
    import sys

    root = pathlib.Path(__file__).resolve().parent.parent
    out = subprocess.run([sys.executable, "-c", _DEADLINE], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert "launch failed:" in out.stdout, out.stdout + out.stderr
    assert "status 5" in out.stdout, out.stdout + out.stderr
