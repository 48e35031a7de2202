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


def _fused_case(kind, dev, dtype, seed=0, nblocks=6, span=48, per_block=None, pool=16,
                width=256):
    """Tables and block-local ids for one step of ``kind`` (flat or grouped),
    with contexts sharing rows with the pool and pads in the windows.
    ``per_block``: pairs (flat, default 64) or centers (grouped, default 32)
    a kernel block; rows of ``width`` lanes, the last 7/32 of them padding
    (dim 200 at 256). Block 0's last context slot names its first pool row,
    so the pool write must win over a context write from another tile."""
    from swiftsnails_tpu_torch.ops import fused_sgns

    rng = np.random.default_rng(seed)
    cap = nblocks * span
    lanes = (np.arange(width) < width * 25 // 32).reshape(-1, 128)
    tables = [torch.from_numpy((rng.normal(size=(cap, width // 128, 128)) * 0.1 * lanes)
                               .astype(np.float32)).to(dev, dtype) for _ in range(2)]
    pool_rows = _block_local(rng, nblocks, pool, span)
    if kind == "flat":
        p = per_block or 64
        ids = [_block_local(rng, nblocks, p, span) for _ in range(2)]
        ids[1][p - 1] = pool_rows[0]
        args = dict(in_rows=ids[0], pos_rows=ids[1], pool_rows=pool_rows)
        fn, kw = fused_sgns.fused_sgns_step, dict(lr=0.05 * p * nblocks, lam=0.3,
                                                   pairs_per_block=p, pool_size=pool)
    else:
        pc, window = per_block or 32, 3
        ctxs = _block_local(rng, nblocks, pc * 2 * window, span).reshape(-1, 2 * window)
        ctxs[rng.random(ctxs.shape) < 0.3] = -1
        ctxs[5] = -1
        ctxs[pc - 1, 0] = pool_rows[0]
        args = dict(centers=_block_local(rng, nblocks, pc, span), ctxs=ctxs,
                    pool_rows=pool_rows)
        fn, kw = fused_sgns.fused_sgns_grouped_step, dict(
            lr=0.05 * pc * nblocks * (window + 1), lam=0.3, window=window,
            centers_per_block=pc, pool_size=pool)
    args = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in args.items()}
    return fn, tables, args, kw


def _assert_fused_like_plain(fn, tables, args, kw, dtype, dim):
    """Two kernel runs (one launch each) within rtol 1e-5 / atol 1e-6 of the
    plain version in f32, one bf16 rounding in bf16, bit-identical, with the
    padding lanes (from ``dim``) still zero."""
    from swiftsnails_tpu_torch.ops import fused_sgns

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
        assert not t.reshape(t.shape[0], -1)[:, dim:].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["flat", "grouped"])
def test_fused_kernels_match_plain_on_block_local_inputs(cuda_device, kind, dtype):
    fn, tables, args, kw = _fused_case(kind, cuda_device, dtype)
    _assert_fused_like_plain(fn, tables, args, kw, dtype, 200)


def _balanced_tile(per_block, k, largest=32):
    """The kernels' tile at cluster size k: the smallest that keeps the
    rounds of tiles of the largest that fits, ceil(ntiles / k)."""
    rounds = -(-(-(-per_block // largest)) // k)
    return min(largest, -(-per_block // (rounds * k)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("per_block", ["full", "ragged"])
@pytest.mark.parametrize("k", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("kind", ["flat", "grouped"])
def test_fused_kernels_at_each_cluster_size(cuda_device, kind, k, per_block, dtype):
    """Clusters of K CTAs a kernel block, reached through the shape: 6
    kernel blocks (one wave at every K) of K tiles of 32 pairs (flat) or
    centers (grouped) take K, one tile a CTA; ragged: 5 fewer, so the last
    CTA's tile is short. The pool row that a context slot of the block's
    last tile names is written by the pool."""
    from swiftsnails_tpu_torch.ops import fused_sgns

    grouped = kind == "grouped"
    n = 32 * k - (5 if per_block == "ragged" else 0)
    fn, tables, args, kw = _fused_case(kind, cuda_device, dtype, seed=k, per_block=n)
    plan = fused_sgns.cluster_plan(grouped, 6, n, 6 if grouped else 0, 16, tables[0])
    assert (plan["cluster"], plan["ctas"], plan["tile"]) == (k, 6 * k, _balanced_tile(n, k))
    _assert_fused_like_plain(fn, tables, args, kw, dtype, 200)


@pytest.mark.parametrize("nblocks", [200, 66, 33, 6])
@pytest.mark.parametrize("kind", ["flat", "grouped"])
def test_cluster_rule_minimises_rounds_times_waves(cuda_device, kind, nblocks):
    """The rule's K is the size with the fewest rounds a CTA times waves of
    clusters (the smaller K on a tie), from the clusters the card holds at
    once at each size; the step at that K equals its plain version."""
    from swiftsnails_tpu_torch.ops import fused_sgns

    grouped = kind == "grouped"
    per_block = 64 if grouped else 128
    fn, tables, args, kw = _fused_case(kind, cuda_device, torch.float32, nblocks=nblocks,
                                       span=32, per_block=per_block)
    rule = fused_sgns.cluster_plan(grouped, nblocks, per_block, 6 if grouped else 0, 16,
                                   tables[0])
    ntiles = -(-per_block // 32)  # at the largest tile, before balancing
    costs = {k: -(-ntiles // k) * -(-nblocks // active)
             for k, active in rule["active_by_cluster"].items() if active > 0}
    assert rule["cluster"] == min(costs, key=lambda k: (costs[k], k)), (rule, costs)
    assert rule["max_active_clusters"] == rule["active_by_cluster"][rule["cluster"]]
    assert rule["ctas"] == nblocks * rule["cluster"]
    assert rule["tile"] == _balanced_tile(per_block, rule["cluster"])
    _assert_fused_like_plain(fn, tables, args, kw, torch.float32, 200)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["flat", "grouped"])
def test_fused_kernel_at_the_main_shape(cuda_device, kind, dtype):
    """32 kernel blocks (512 pairs, or 256 centers of 10 slots), pools of 64,
    rows of 256 lanes (dim 200) over 2^20 rows, block-local ids."""
    from swiftsnails_tpu_torch.ops import fused_sgns

    rng = np.random.default_rng(5)
    cap, nb, pool = 1 << 20, 32, 64
    span = cap // nb
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    lanes = (torch.arange(256, device=cuda_device) < 200).view(2, 128)
    tables = [torch.randn(cap, 2, 128, generator=gen, device=cuda_device).mul_(0.1)
              .mul_(lanes).to(dtype) for _ in range(2)]

    def local(per_block):
        return _block_local(rng, nb, per_block, span)

    if kind == "flat":
        p = 512
        args = dict(in_rows=local(p), pos_rows=local(p), pool_rows=local(pool))
        fn, kw = fused_sgns.fused_sgns_step, dict(lr=100.0, lam=5 / pool, pairs_per_block=p,
                                                   pool_size=pool)
    else:
        pc, window = 256, 5
        ctxs = local(pc * 2 * window).reshape(-1, 2 * window)
        ctxs[rng.random(ctxs.shape) < 0.3] = -1
        args = dict(centers=local(pc), ctxs=ctxs, pool_rows=local(pool))
        fn, kw = fused_sgns.fused_sgns_grouped_step, dict(
            lr=100.0, lam=5 / pool, window=window, centers_per_block=pc, pool_size=pool)
    args = {k: torch.from_numpy(np.ascontiguousarray(v)).to(cuda_device)
            for k, v in args.items()}
    _assert_fused_like_plain(fn, tables, args, kw, dtype, 200)


@pytest.mark.parametrize("width,pool", [(128, 16), (256, 16), (512, 16), (512, 40)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["flat", "grouped"])
def test_fused_kernels_at_other_row_widths(cuda_device, kind, dtype, width, pool):
    """Rows of 128, 256 and 512 lanes (dims 100, 200, 400), pools of 16; and
    a pool of 40 rows of 512 lanes, whose dQ partial (5 x 128 micro-tiles)
    does not fit in the registers of 512 threads and lives in shared
    memory."""
    from swiftsnails_tpu_torch.ops import fused_sgns

    fn, tables, args, kw = _fused_case(kind, cuda_device, dtype, width=width, pool=pool)
    grouped = kind == "grouped"
    plan = fused_sgns.cluster_plan(grouped, 6, 32 if grouped else 64, 6 if grouped else 0,
                                   pool, tables[0])
    assert plan["dq_in_smem"] == (pool == 40)
    _assert_fused_like_plain(fn, tables, args, kw, dtype, width * 25 // 32)


@pytest.mark.parametrize("dtype,width", [(torch.float32, 6), (torch.bfloat16, 12),
                                         (torch.float32, 200)])
@pytest.mark.parametrize("kind", ["flat", "grouped"])
def test_fused_kernels_on_rows_not_in_16_byte_words(cuda_device, kind, dtype, width):
    """Rows the kernels move element by element (24 B), or in words (800 B)."""
    fn, tables, args, kw = _fused_case(kind, cuda_device, dtype)
    gen = torch.Generator(device=cuda_device).manual_seed(width)
    tables = [torch.randn(t.shape[0], width, generator=gen, device=cuda_device).mul_(0.1)
              .to(dtype) for t in tables]
    _assert_fused_like_plain(fn, tables, args, kw, dtype, width)


@pytest.mark.parametrize("kind", ["flat", "grouped"])
def test_fused_kernels_refuse_a_pool_too_large_before_any_launch(cuda_device, kind):
    """64 pool rows of 512 f32 lanes do not fit in shared memory beside the
    pool gradient: the wrapper raises and launches nothing."""
    fn, tables, args, kw = _fused_case(kind, cuda_device, torch.float32, pool=64,
                                       width=512)
    n0 = fn.launches
    with pytest.raises(ValueError, match="does not fit"):
        fn(*tables, *args.values(), **kw)
    assert fn.launches == n0


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
@pytest.mark.parametrize("chunks,blocks", [(10, 8), (1, 8), (3, 40), (29, 64)])
def test_pipe_probe_bit_equal_and_repeatable(cuda_device, chunked, s, chunks, blocks):
    """Blocks of 10, 1, 3 and 29 chunks: one CTA a block, or a cluster whose
    ranks take unequal shares (29 chunks over G = 2 at the JAX tool's
    shape, 128 CTAs); the ranks' XORs combine to the plain version's. The
    library picks G as the hogwild kernels pick theirs."""
    from swiftsnails_tpu_torch.ops import sem_probe

    gen = torch.Generator(device=cuda_device).manual_seed(s)
    x = torch.randn(20_000, s, 128, generator=gen, device=cuda_device)
    ids = torch.randint(0, 20_000, (blocks * chunks * 64,), generator=gen,
                        device=cuda_device, dtype=torch.int32)
    plan = sem_probe.pipe_plan(x, ids, blocks, chunked)
    # the hogwild kernels' rule: the fewest rounds of chunks a CTA times
    # waves of clusters, the smaller G on a tie
    costs = {g: -(-chunks // g) * -(-blocks // active)
             for g, active in plan["active_by_cluster"].items() if active > 0}
    assert plan["cluster"] == min(costs, key=lambda g: (costs[g], g)), (plan, costs)
    assert plan["ctas"] == blocks * plan["cluster"]
    assert plan["max_active_clusters"] == plan["active_by_cluster"][plan["cluster"]]
    if (chunks, blocks, s) == (29, 64, 2):
        assert (plan["cluster"], plan["ctas"], plan["stages"]) == (2, 128, 3)
    n0 = sem_probe.pipe_probe.launches
    got = [sem_probe.pipe_probe(x, ids, blocks, chunked) for _ in range(2)]
    assert sem_probe.pipe_probe.launches == n0 + 2
    assert torch.equal(got[0], sem_probe.pipe_probe_plain(x, ids, blocks)), plan
    assert torch.equal(got[0], got[1])


def test_probe_plans_name_the_launch_geometry(cuda_device):
    """The geometry the library launches the probes with: one CTA of 256
    threads whose warp 0 issues the chunk's copies; the pipe's CTAs of a
    producer warp and four consumer warps."""
    from swiftsnails_tpu_torch.ops import sem_probe

    x = torch.zeros(4096, 2, 128, device=cuda_device)
    assert sem_probe.chunk_plan(x) == {"ctas": 1, "threads": 256, "issuing_lanes": 32}
    ids = torch.zeros(64 * 1856, dtype=torch.int32, device=cuda_device)
    plan = sem_probe.pipe_plan(x, ids, 64, True)
    assert (plan["threads"], plan["issuing_lanes"], plan["consumer_warps"]) == (160, 32, 4)


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



_TRAP = """
import torch
from swiftsnails_tpu_torch.ops import sem_probe
x = torch.ones(4096, 2, 128, device="cuda")
ids = torch.arange(64 * 1856, dtype=torch.int32, device="cuda") % 4096  # the tool's K, B
{setup}
try:
    {call}
    torch.cuda.synchronize()
except RuntimeError as e:
    print("launch failed:", e)
print("status", sem_probe.deadline_status())
"""


def _trap_status(setup: str, call: str) -> str:
    """The probe's call in a subprocess (a trap leaves the CUDA context
    unusable); returns its output, which must name a failed launch."""
    import pathlib
    import subprocess
    import sys

    root = pathlib.Path(__file__).resolve().parent.parent
    out = subprocess.run([sys.executable, "-c", _TRAP.format(setup=setup, call=call)],
                         cwd=root, capture_output=True, text=True, timeout=300)
    assert "launch failed:" in out.stdout, out.stdout + out.stderr
    return out.stdout


@pytest.mark.parametrize("probe", ["chunk", "pipe_per_copy", "pipe_chunked"])
def test_an_id_outside_the_table_traps_with_its_code(cuda_device, probe):
    """One id past the table's last row, among the chunk probe's 64 or in
    chunk 8 of the pipe's last block (rank 0's fifth chunk of a cluster of
    2, a refill of its three-stage ring): the warp's vote traps with code 7
    before any copy of it."""
    from swiftsnails_tpu_torch.ops import sem_probe

    call = {"chunk": "sem_probe.chunk_probe(x, ids[:64])",
            "pipe_per_copy": "sem_probe.pipe_probe(x, ids, 64, False)",
            "pipe_chunked": "sem_probe.pipe_probe(x, ids, 64, True)"}[probe]
    where = 37 if probe == "chunk" else 63 * 1856 + 8 * 64 + 5
    out = _trap_status(f"ids[{where}] = 4096", call)
    assert "status 7" in out, out
    assert sem_probe.DEADLINE_CODES[7] == "an id outside [0, C)"


@pytest.mark.parametrize("chunked", [False, True])
def test_a_stage_never_released_traps_with_the_producers_code(cuda_device, chunked):
    """The consumers keep their first stage (a test's fault): the producer's
    wait to refill it passes its deadline, code 8, reported by
    ``deadline_status``, instead of hanging."""
    from swiftsnails_tpu_torch.ops import sem_probe

    out = _trap_status("", f"sem_probe._pipe_launch(x, ids, 64, {chunked}, "
                           "hold_first_stage=True)")
    assert "status 8" in out, out
    assert sem_probe.DEADLINE_CODES[8] == "pipe: the producer's wait for a released stage"

# ------------------------------------------ checkpoints and the guardrail ---


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_packed_table_checkpoint_round_trip_on_the_card(cuda_device, dtype, tmp_path):
    """A packed table saved from the card and restored onto it: bit-equal,
    with the CRC the same state has on the CPU."""
    from swiftsnails_tpu_torch.framework import checkpoint as ckpt

    gen = torch.Generator(device=cuda_device).manual_seed(3)
    state = {"table": torch.randn(50_000, 2, 128, generator=gen, device=cuda_device).to(dtype),
             "count": torch.arange(7, dtype=torch.int32, device=cuda_device)}
    root = str(tmp_path / "ck")
    ckpt.save_checkpoint(root, state, 4)
    on_cpu = ckpt.build_manifest({k: v.cpu() for k, v in state.items()}, 4)["arrays"]
    assert ckpt.read_manifest(root, 4)["arrays"] == on_cpu
    template = {k: torch.zeros_like(v) for k, v in state.items()}
    got = ckpt.restore_checkpoint(root, template)
    assert got["table"].device.type == "cuda"
    for k in state:
        assert torch.equal(got[k], state[k]), k


def test_guardrail_rolls_back_a_nan_written_by_scatter_add_rows(cuda_device):
    from swiftsnails_tpu_torch.resilience.guardrail import StepGuardrail

    gen = torch.Generator(device=cuda_device).manual_seed(4)
    state = {"table": torch.randn(4096, 2, 128, generator=gen, device=cuda_device)}
    before = state["table"].clone()
    g = StepGuardrail()
    snap = g.snapshot(state)
    rows = torch.tensor([3, 17, 4000], dtype=torch.int32, device=cuda_device)
    deltas = torch.zeros(3, 2, 128, device=cuda_device)
    deltas[1, 0, 5] = float("nan")
    n0 = rowdma.scatter_add_rows.launches
    rowdma.scatter_add_rows(state["table"], rows, deltas)  # in place, on the card
    assert rowdma.scatter_add_rows.launches == n0 + 1
    assert not torch.isfinite(state["table"]).all()
    got, _, tripped, _ = g.commit(snap, state, {"loss": torch.tensor(0.5, device=cuda_device)})
    assert tripped and "non-finite update" in g.last_trip_reason
    assert torch.equal(got["table"], before)


def test_async_save_is_not_torn_by_the_next_steps_write(cuda_device, tmp_path):
    """The step right after an async save writes the table in place with
    ``scatter_add_rows``; the save still holds the bytes from before it."""
    from swiftsnails_tpu_torch.framework import checkpoint as ckpt

    gen = torch.Generator(device=cuda_device).manual_seed(5)
    table = torch.randn(262_144, 2, 128, generator=gen, device=cuda_device)  # 256 MiB
    want = ckpt.build_manifest({"table": table}, 1)["arrays"]
    root = str(tmp_path / "ck")
    ckpt.save_checkpoint(root, {"table": table}, 1, wait=False)
    rows = torch.arange(0, 262_144, 7, dtype=torch.int32, device=cuda_device)
    rowdma.scatter_add_rows(table, rows, torch.ones(rows.shape[0], 2, 128, device=cuda_device))
    assert ckpt.wait_for_checkpoints() == []
    assert ckpt.read_manifest(root, 1)["arrays"] == want
    got = ckpt.restore_checkpoint(root, {"table": torch.zeros_like(table)})
    assert not torch.equal(got["table"], table)
    assert ckpt.verify_state(got, ckpt.read_manifest(root, 1)) == []


def test_step_span_opens_and_closes_nvtx_and_record_function_ranges(cuda_device, monkeypatch):
    """On the card a step span pushes an NVTX range and opens a
    ``record_function`` range, ``<name>#<step>``, around the step's work and
    closes both. (Without an NVTX tool attached ``range_push`` returns no
    depth, so the calls themselves are recorded.)"""
    from torch.profiler import ProfilerActivity, profile

    from swiftsnails_tpu_torch.telemetry.tracer import Tracer

    calls = []
    push, pop = torch.cuda.nvtx.range_push, torch.cuda.nvtx.range_pop
    monkeypatch.setattr(torch.cuda.nvtx, "range_push",
                        lambda msg: calls.append(("push", msg)) or push(msg))
    monkeypatch.setattr(torch.cuda.nvtx, "range_pop",
                        lambda: calls.append(("pop",)) or pop())
    tr = Tracer(nvtx=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with tr.step_span("toy", 3):
            calls.append(("work",))
            torch.ones(1024, device=cuda_device).sum().item()
    assert calls == [("push", "toy#3"), ("work",), ("pop",)]
    assert "toy#3" in {e.key for e in prof.key_averages()}
    assert [e["name"] for e in tr.events()] == ["toy"]


def test_profile_dir_capture_lists_the_hand_kernels(cuda_device, tmp_path):
    """A short packed+pool run with ``profile_dir``: the capture is a Chrome
    trace of the window's steps that lists ``gather_rows_kernel`` and
    ``scatter_add_rows_kernel`` with device time."""
    import json

    from swiftsnails_tpu_torch.data.vocab import Vocab
    from swiftsnails_tpu_torch.framework.trainer import TrainLoop
    from swiftsnails_tpu_torch.models.word2vec import Word2VecTrainer
    from swiftsnails_tpu_torch.utils.config import Config

    rng = np.random.default_rng(0)
    ids = rng.integers(0, 4096, 200_000).astype(np.int32)
    vocab = Vocab([f"w{i}" for i in range(4096)], np.maximum(np.bincount(ids, minlength=4096), 1))
    cfg = Config({"dim": "64", "batch_size": "2048", "subsample": "0", "use_native": "0",
                  "telemetry": "1", "profile_dir": str(tmp_path / "prof"),
                  "profile_steps": "2,5", "ledger_path": str(tmp_path / "l.jsonl")})
    loop = TrainLoop(Word2VecTrainer(cfg, corpus_ids=ids, vocab=vocab), log_every=1)
    loop.run(max_steps=6)
    events = json.load(open(loop.profiler.trace_path))["traceEvents"]
    kernels = {}
    for e in events:
        if e.get("cat") == "kernel":
            kernels[e["name"]] = kernels.get(e["name"], 0.0) + e["dur"]
    for want in ("gather_rows_kernel", "scatter_add_rows_kernel"):
        assert sum(us for name, us in kernels.items() if want in name) > 0, sorted(kernels)
    steps = {e["name"] for e in events if str(e.get("name", "")).startswith("word2vec#")}
    assert steps == {"word2vec#2", "word2vec#3", "word2vec#4"}


# ---------------------------------------------------------------- serving ---


@pytest.mark.parametrize("dim,kernel", [(200, True), (16, True), (17, False)])
def test_serving_pull_on_the_card_against_plain(cuda_device, dim, kernel):
    """``pull_rows`` launches ``gather_rows`` where a row is whole 16-byte
    words (and ``index_select`` where not), equal to the plain version."""
    from swiftsnails_tpu_torch.serving import pull_rows

    gen = torch.Generator(device=cuda_device).manual_seed(dim)
    table = torch.randn(5000, dim, generator=gen, device=cuda_device)
    rows = torch.randint(0, 5000, (64,), generator=gen, device=cuda_device,
                         dtype=torch.int32)
    n0 = rowdma.gather_rows.launches
    got = pull_rows(table, rows)
    assert rowdma.gather_rows.launches == n0 + int(kernel)
    assert torch.equal(got, rowdma.gather_rows_plain(table, rows))
    bf = pull_rows(table, rows, comm_dtype="bfloat16")
    assert torch.equal(bf, table.index_select(0, rows).bfloat16().float())


def test_serving_apply_rows_on_the_card_against_plain(cuda_device):
    """``Servant.apply_rows`` writes the delta with one ``scatter_write_rows``
    launch, last occurrence winning, bit-equal to the CPU servant's."""
    from swiftsnails_tpu_torch.serving import Servant

    rng = np.random.default_rng(1)
    table = rng.standard_normal((4096, 200)).astype(np.float32)
    ids = np.concatenate([rng.choice(4096, 1000, replace=False), [7, 7]])
    vals = rng.standard_normal((ids.shape[0], 200)).astype(np.float32)
    probe = np.arange(4096, dtype=np.int32)
    with Servant({"t": table}, device="cuda") as card, \
            Servant({"t": table}, device="cpu") as cpu:
        n0 = rowdma.scatter_write_rows.launches
        card.apply_rows({"t": (ids, vals)})
        assert rowdma.scatter_write_rows.launches == n0 + 1
        cpu.apply_rows({"t": (ids, vals)})
        np.testing.assert_array_equal(card.pull(probe), cpu.pull(probe))
        np.testing.assert_array_equal(card.pull([7]), vals[-1:])


def test_serving_topk_and_score_on_the_card_against_the_cpu(cuda_device):
    from swiftsnails_tpu_torch.models.registry import get_model
    from swiftsnails_tpu_torch.serving import Servant, topk_tiled
    from swiftsnails_tpu_torch.utils.config import Config

    rng = np.random.default_rng(2)
    table = rng.standard_normal((10_000, 200)).astype(np.float32)
    table[5000:5100] = 0.0  # tied rows
    q = rng.standard_normal((8, 200)).astype(np.float32)
    q[7] = 0.0
    s_card, i_card = topk_tiled(torch.from_numpy(table).cuda(), torch.from_numpy(q).cuda(),
                                k=10, tile_rows=4096)
    s_cpu, i_cpu = topk_tiled(torch.from_numpy(table), torch.from_numpy(q), k=10,
                              tile_rows=4096)
    assert torch.equal(i_card.cpu(), i_cpu)
    torch.testing.assert_close(s_card.cpu(), s_cpu, rtol=1e-5, atol=1e-6)
    assert i_card[7].tolist() == list(range(10))
    cfg = Config({"model": "widedeep", "num_fields": "6", "capacity": "4096",
                  "embed_dim": "4", "hidden_dims": "16,8"})
    data = (np.zeros(0, np.float32), np.zeros((0, 6), np.int32))
    feats = rng.integers(0, 1 << 20, (100, 6)).astype(np.int32)
    dense = {k: v.cpu().numpy() for k, v in
             get_model("widedeep")(cfg, data=data, device="cpu").init_state().dense.items()}
    wtable = rng.standard_normal((4096, 5)).astype(np.float32)
    out = []
    for dev in ("cuda", "cpu"):
        scorer = get_model("widedeep")(cfg, data=data, device=dev)
        with Servant({"table": wtable}, scorer=scorer, dense=dense, device=dev) as sv:
            out.append(sv.score(feats))
    np.testing.assert_allclose(out[0], out[1], rtol=1e-5, atol=1e-7)


# ----------------------------------------------------------- tiered store ---


def _tiered_w2v(device, budget_mb=None, **over):
    from swiftsnails_tpu_torch.data.vocab import Vocab
    from swiftsnails_tpu_torch.models.word2vec import Word2VecTrainer
    from swiftsnails_tpu_torch.utils.config import Config

    rng = np.random.default_rng(0)
    w = 1.0 / np.arange(1, 4097) ** 1.05
    ids = np.searchsorted(np.cumsum(w) / w.sum(), rng.random(60_000)).astype(np.int32)
    vocab = Vocab([f"w{i}" for i in range(4096)], np.maximum(np.bincount(ids, minlength=4096), 1))
    cfg = Config({"dim": "200", "window": "2", "negatives": "5", "pool_size": "64",
                  "pool_block": "512", "batch_size": "1024", "learning_rate": "10",
                  "subsample": "0", "seed": "0", "num_iters": "1",
                  **{k: str(v) for k, v in over.items()}})
    if budget_mb is not None:
        cfg.set("table_tier", "host")
        cfg.set("tier_hbm_budget_mb", str(budget_mb))
    return Word2VecTrainer(cfg, corpus_ids=ids, vocab=vocab, device=device)


@pytest.mark.parametrize("async_flush", [0, 1])
def test_tiered_packed_pool_bit_equal_to_resident_on_the_card(cuda_device, async_flush):
    """packed+pool at dim 200 over a 4,096-word zipf vocab with a 1,536-slot
    cache a table (3 MB): every step faults and evicts; losses and tables
    equal the resident run on the card bit for bit; the installs launch
    ``scatter_write_rows`` and the flush snapshots ``gather_rows``."""
    from swiftsnails_tpu_torch.framework.trainer import TrainLoop
    from swiftsnails_tpu_torch.utils.metrics import MetricsLogger

    def run(tr):
        records = []

        class Recorder(MetricsLogger):
            def log(self, record):
                records.append(record)

        state = TrainLoop(tr, metrics=Recorder(), log_every=1).run(seed=0, max_steps=20)
        return state, [r["loss"] for r in records]

    resident, losses = run(_tiered_w2v(cuda_device))
    tr = _tiered_w2v(cuda_device, budget_mb=3.0, tier_async_flush=async_flush)
    w0, g0 = rowdma.scatter_write_rows.launches, rowdma.gather_rows.launches
    loop_state, tier_losses = run(tr)
    assert tier_losses == losses
    assert torch.equal(resident.in_table.table.cpu(), loop_state.in_table.table)
    assert torch.equal(resident.out_table.table.cpu(), loop_state.out_table.table)
    assert rowdma.scatter_write_rows.launches > w0
    assert rowdma.gather_rows.launches > g0 + 2 * 20  # the pulls + the snapshots


def test_tiered_install_and_snapshot_against_plain_on_the_card(cuda_device):
    """A fault install into a ``[64, 2, 128]`` cache writes the master's rows
    through ``scatter_write_rows`` (one launch a plane), bit-equal to its
    plain version; the eviction's snapshot lands in the master bit for bit."""
    from swiftsnails_tpu_torch.parallel.store import PackedTableState
    from swiftsnails_tpu_torch.tiered import HostMaster, TieredTable

    rng = np.random.default_rng(3)
    table = rng.standard_normal((512, 2, 128)).astype(np.float32)
    accum = rng.random((512, 2, 128)).astype(np.float32)
    master = HostMaster(PackedTableState(table=torch.from_numpy(table),
                                         slots={"accum": torch.from_numpy(accum)}), "packed")
    tt = TieredTable(master, 64, device=cuda_device)
    cache = tt.make_cache()
    units = rng.choice(512, 64, replace=False)
    n0 = rowdma.scatter_write_rows.launches
    cache = tt.ensure(cache, units)
    assert rowdma.scatter_write_rows.launches == n0 + 2
    slots = tt.slot_of[units]
    want = rowdma.scatter_write_rows_plain(
        torch.zeros(64, 2, 128), torch.from_numpy(slots.astype(np.int32)),
        torch.from_numpy(table[units]))
    assert torch.equal(cache.table.cpu(), want)
    assert torch.equal(cache.slots["accum"].cpu()[slots], torch.from_numpy(accum[units]))
    cache.table.add_(1.0)  # the step trains every resident row
    g0 = rowdma.gather_rows.launches
    cache = tt.ensure(cache, rng.choice(np.setdiff1d(np.arange(512), units), 8,
                                        replace=False))
    assert rowdma.gather_rows.launches == g0 + 2  # table + accum snapshot
    gone = units[tt.slot_of[units] < 0]
    assert gone.size == 8
    np.testing.assert_array_equal(master.table[gone], table[gone] + 1.0)
    assert master.verify() == []


def test_tiered_widedeep_bit_equal_to_resident_on_the_card(cuda_device):
    """Wide & Deep on the small-row plane with a cache of 3/4 of the tiles:
    table, dense parameters and optimizer state equal the resident run's."""
    from swiftsnails_tpu_torch.data.ctr import synth_ctr
    from swiftsnails_tpu_torch.framework.trainer import TrainLoop
    from swiftsnails_tpu_torch.models.registry import get_model
    from swiftsnails_tpu_torch.utils.config import Config

    labels, feats, _ = synth_ctr(1024 * 8, 26, 2000, seed=0)
    conf = {"model": "widedeep", "num_fields": "26", "capacity": str(1 << 17),
            "embed_dim": "16", "hidden_dims": "64,32", "batch_size": "1024", "num_iters": "1"}
    states, loops = [], []
    for tier in (None, 24.0):  # 32,768 tiles of 1 KB: 3/4 of them
        cfg = Config(conf)
        if tier:
            cfg.set("table_tier", "host")
            cfg.set("tier_hbm_budget_mb", str(tier))
        loop = TrainLoop(get_model("widedeep")(cfg, data=(labels, feats), device="cuda"),
                         log_every=0)
        states.append(loop.run(seed=0, max_steps=8))
        loops.append(loop)
    a, b = states
    assert loops[1].tier.summary()["evictions"] > 0
    assert torch.equal(a.table.table.cpu(), b.table.table)
    for k in a.dense:
        assert torch.equal(a.dense[k], b.dense[k])
        assert torch.equal(a.opt["sum_of_squares"][k], b.opt["sum_of_squares"][k])


def test_tiered_serving_on_the_card_against_the_cpu(cuda_device):
    """The tiered servant on the card pulls through ``gather_rows`` from its
    cache and answers as the CPU one; topk streams the master."""
    from swiftsnails_tpu_torch.serving import Servant

    rng = np.random.default_rng(4)
    table = rng.standard_normal((8192, 200)).astype(np.float32)
    budget = 1024 * 800 / float(1 << 20)
    with Servant({"t": table}, cache_rows=0, tier_hbm_budget_mb=budget,
                 device="cuda") as card, \
            Servant({"t": table}, cache_rows=0, tier_hbm_budget_mb=budget,
                    device="cpu") as cpu:
        g0 = rowdma.gather_rows.launches
        for _ in range(6):
            ids = rng.integers(0, 8192, 300)
            np.testing.assert_array_equal(card.pull(ids), cpu.pull(ids))
            np.testing.assert_array_equal(card.pull(ids), table[ids])
        assert rowdma.gather_rows.launches > g0
        assert card.stats()["tiered"]["evictions"] > 0
        q = rng.standard_normal(200).astype(np.float32)
        assert [i for i, _ in card.topk(q, k=10)] == [i for i, _ in cpu.topk(q, k=10)]
