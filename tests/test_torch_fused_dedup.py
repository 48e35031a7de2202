"""The port's merged fused SGNS substeps (``fused-resident``, ``fused-dedup``,
``fused-dedup-res``) against the JAX package's, on the CPU.

The JAX kernels run in interpret mode, as ``tests/test_fused_sgns.py`` runs
them: their grid is sequential there, and so is the meaning of the merged
forms (``swiftsnails_tpu_torch/ops/fused_sgns.py``, "merged"). The parameter
sets are the JAX tests': mixed hot and cold rows, every row hot, unique lists
that overflow, and a ``u_cap`` of 24. Inputs are made with numpy and plant a
context row shared with the pool (cold, so that the unique write must follow
the pool's) and rows shared by neighbouring blocks. The tolerances are those
of ``tests/test_torch_fused_sgns.py``. Each planted fault of the merged
semantics fails that comparison, and the runs that the card's kernel takes
from ``merged_prep``, applied in the kernel's schedule, give the plain
version's result on zipf ids.
"""

import logging

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

import test_torch_fused_sgns as tfs
from swiftsnails_tpu.data import sampler as jax_sampler
from swiftsnails_tpu.ops import fused_sgns as jax_fused
from swiftsnails_tpu.utils.config import Config as JaxConfig
from swiftsnails_tpu.models import word2vec as jax_w2v
from swiftsnails_tpu.data.vocab import Vocab as JaxVocab
from swiftsnails_tpu_torch import convert
from swiftsnails_tpu_torch.data import sampler
from swiftsnails_tpu_torch.data.vocab import Vocab
from swiftsnails_tpu_torch.framework.trainer import TrainLoop
from swiftsnails_tpu_torch.models import word2vec
from swiftsnails_tpu_torch.ops import fused_sgns, rowdma
from swiftsnails_tpu_torch.utils.config import Config
from swiftsnails_tpu_torch.utils.metrics import MetricsLogger

torch.set_num_threads(1)

C, S, L = tfs.C, tfs.S, tfs.L
N, PC, PN, W, CW = tfs.N, tfs.PC, tfs.PN, tfs.W, tfs.CW
LAM, LR = tfs.LAM, tfs.LR_GROUPED
SHARED = 50  # a cold row in block 1's contexts and its pool

# kind -> (port wrapper, JAX kernel, parameter sets of the JAX tests)
KINDS = {
    "resident": (fused_sgns.fused_sgns_resident_step, jax_fused.fused_sgns_resident_step,
                 [dict(seed=0, hot_rows=32), dict(seed=1, hot_rows=32),
                  dict(seed=0, hot_rows=64)]),
    "dedup": (fused_sgns.fused_sgns_dedup_step, jax_fused.fused_sgns_dedup_step,
              [dict(seed=0, u_cap=64), dict(seed=1, u_cap=64), dict(seed=0, u_cap=16),
               dict(seed=0, u_cap=24)]),
    "dedup_resident": (
        fused_sgns.fused_sgns_dedup_resident_step, jax_fused.fused_sgns_dedup_resident_step,
        [dict(seed=0, u_cap=64, hot_rows=32), dict(seed=1, u_cap=64, hot_rows=32),
         dict(seed=0, u_cap=16, hot_rows=8), dict(seed=0, u_cap=64, hot_rows=64)]),
}
CASES = [(kind, params) for kind, (_, _, sets) in KINDS.items() for params in sets]


def _inputs(kind, seed):
    """The JAX tests' inputs (random windows for resident, overlapping ones
    for the dedup forms), with the planted rows."""
    rng = np.random.default_rng(seed)
    in_t, out_t = tfs._tables(rng)
    centers = rng.integers(0, C, N).astype(np.int32)
    if kind == "resident":
        ctxs = rng.integers(0, C, (N, CW)).astype(np.int32)
    else:
        ctxs = ((centers[:, None] + rng.integers(-3, 4, (N, CW))) % C).astype(np.int32)
    ctxs[rng.random((N, CW)) < 0.4] = -1
    ctxs[3] = -1
    pool_rows = rng.integers(0, C, (N // PC) * PN).astype(np.int32)
    ctxs[PC + 2, 0] = ctxs[PC + 5, 1] = pool_rows[PN + 3] = SHARED
    ctxs[PC + 4, 2] = ctxs[2 * PC + 5, 3] = 45
    centers[PC + 1] = centers[2 * PC + 6]
    return in_t, out_t, centers, ctxs, pool_rows


def _extra(params):
    return {k: v for k, v in params.items() if k != "seed"}


_JAX_CACHE = {}


def _want(kind, dtype, params):
    key = (kind, dtype, tuple(sorted(params.items())))
    if key not in _JAX_CACHE:
        cast = tfs._bf16 if dtype == "bfloat16" else jnp.asarray
        in_t, out_t, centers, ctxs, pool_rows = _inputs(kind, params["seed"])
        got = KINDS[kind][1](
            cast(in_t), cast(out_t), jnp.asarray(centers), jnp.asarray(ctxs),
            jnp.asarray(pool_rows), lr=LR, lam=LAM, window=W, centers_per_block=PC,
            pool_size=PN, interpret=True, **_extra(params))
        _JAX_CACHE[key] = ([np.asarray(x.astype(jnp.float32)) for x in got[:2]],
                           float(got[2]))
    return _JAX_CACHE[key]


def _port(kind, dtype, params, inputs=None):
    in_t, out_t, centers, ctxs, pool_rows = inputs or _inputs(kind, params["seed"])
    ti, to = tfs._torch_tables(dtype, in_t, out_t)
    a, b, loss = KINDS[kind][0](
        ti, to, torch.from_numpy(centers), torch.from_numpy(ctxs),
        torch.from_numpy(pool_rows), LR, LAM, W, PC, PN, **_extra(params))
    assert a is ti and b is to  # in place
    return [t.float().numpy() for t in (a, b)], float(loss)


def _compare(kind, dtype, params):
    before = _inputs(kind, params["seed"])[:2]
    tfs._assert_same_step(before, _port(kind, dtype, params),
                          _want(kind, dtype, params), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind,params", CASES,
                         ids=[f"{k}-" + "-".join(map(str, p.values())) for k, p in CASES])
def test_plain_matches_jax_interpret(kind, params, dtype):
    _compare(kind, dtype, params)


def test_wrapper_and_plain_version_agree():
    for kind, (fn, _, sets) in KINDS.items():
        plain = getattr(fused_sgns, fn.__name__ + "_plain")
        in_t, out_t, centers, ctxs, pool_rows = _inputs(kind, 0)
        got = []
        for f in (fn, plain):
            ti, to = tfs._torch_tables("float32", in_t, out_t)
            got.append(f(ti, to, torch.from_numpy(centers), torch.from_numpy(ctxs),
                         torch.from_numpy(pool_rows), LR, LAM, W, PC, PN,
                         **_extra(sets[0])))
        for a, b in zip(*got):
            assert torch.equal(a, b), kind


# ------------------------------------------------------- planted faults ---


def _hot_read_at_substep_start():
    start = {}

    def read(table, rows):
        return fused_sgns._rows_f32(start.setdefault(id(table), table.clone()), rows)

    return read


def _pool_left_out_of_hot_sums(parts):
    return _HOT_SUMS(parts[:1])


def _unique_written_before_pool(writes):
    _APPLY_WRITES(writes[:2] + [writes[3], writes[2]] + writes[4:])


def _unique_base_refreshed(nblocks, read, update):
    _DOUBLE_BUFFERED(nblocks, read, lambda b, r: update(b, r._replace(uniq=read(b).uniq)))


_HOT_SUMS = fused_sgns._hot_sums
_APPLY_WRITES = fused_sgns._apply_writes
_DOUBLE_BUFFERED = fused_sgns._double_buffered
FAULTS = {
    "hot_read_at_substep_start": ("_live_rows", _hot_read_at_substep_start),
    "pool_left_out_of_hot_sum": ("_hot_sums", lambda: _pool_left_out_of_hot_sums),
    "unique_written_before_pool": ("_apply_writes", lambda: _unique_written_before_pool),
    "unique_base_refreshed": ("_double_buffered", lambda: _unique_base_refreshed),
}


@pytest.mark.parametrize("kind,fault", [
    ("resident", "hot_read_at_substep_start"), ("dedup_resident", "hot_read_at_substep_start"),
    ("resident", "pool_left_out_of_hot_sum"), ("dedup_resident", "pool_left_out_of_hot_sum"),
    ("dedup", "unique_written_before_pool"), ("dedup_resident", "unique_written_before_pool"),
    ("dedup", "unique_base_refreshed"), ("dedup_resident", "unique_base_refreshed")])
def test_planted_faults_fail_the_comparison(monkeypatch, kind, fault):
    target, make = FAULTS[fault]
    monkeypatch.setattr(fused_sgns, target, make())
    with pytest.raises(AssertionError):
        _compare(kind, "float32", KINDS[kind][2][0])


def test_pads_are_never_read():
    """A NaN in row 0 reaches nothing through the pads (-1) of any merged
    form, and the tables stay finite where row 0 is not used."""
    for kind, (_, _, sets) in KINDS.items():
        in_t, out_t, centers, ctxs, pool_rows = _inputs(kind, 1)
        for ids in (centers, ctxs, pool_rows):
            ids[ids == 0] = 1
        out_t[0] = np.nan
        (a, b), loss = _port(kind, "float32", sets[0],
                             (in_t, out_t, centers, ctxs, pool_rows))
        assert np.isfinite(a).all() and np.isfinite(b[1:]).all() and np.isfinite(loss), kind


@pytest.mark.parametrize("kind,bad,match", [
    ("resident", dict(ctxs=np.zeros((N - 1, CW), np.int32)), "centers_per_block"),
    ("dedup", dict(pool_rows=np.zeros(PN, np.int32)), "pool_rows"),
    ("dedup", dict(u_cap=12), "positive multiple of 8"),
    ("dedup_resident", dict(u_cap=0, hot_rows=8), "positive multiple of 8"),
    ("resident", dict(hot_rows=7), "hot_rows too small; use fused_sgns_grouped_step"),
    ("dedup_resident", dict(u_cap=16, hot_rows=4), "hot_rows too small; use fused_sgns_dedup_step"),
    ("dedup_resident", dict(u_cap=16, hot_rows=32), r"u_cap \(16\) >= effective hot_rows \(32\)"),
    ("resident", dict(out_t=np.zeros((C, 1, L), np.float32)), "row shape and dtype"),
])
def test_validation_errors(kind, bad, match):
    in_t, out_t, centers, ctxs, pool_rows = _inputs(kind, 0)
    args = dict(in_t=in_t, out_t=out_t, centers=centers, ctxs=ctxs, pool_rows=pool_rows)
    params = dict(_extra(KINDS[kind][2][0]))
    for k, v in bad.items():
        (args if k in args else params)[k] = v
    with pytest.raises(ValueError, match=match):
        KINDS[kind][0](*(torch.from_numpy(v) for v in args.values()), LR, LAM, W, PC, PN,
                       **params)


@pytest.mark.parametrize("hot_rows", [0, 5, 8, 12, 100, 255, 256, 300, 511, 1024, 2048, 5000])
@pytest.mark.parametrize("capacity", [64, 1000, 4096])
def test_effective_hot_rows_matches_jax(hot_rows, capacity):
    assert (fused_sgns.effective_hot_rows(hot_rows, capacity, capacity)
            == jax_fused.effective_hot_rows(hot_rows, capacity, capacity))


@pytest.mark.parametrize("batch,block", [(64, 8), (60, 8), (64, 64), (7, 3)])
def test_batch_stream_blocks_identical(batch, block):
    rng = np.random.default_rng(4)
    centers = rng.integers(0, 50, 700).astype(np.int32)
    ctxs = rng.integers(-1, 50, (700, 6)).astype(np.int32)
    got = list(sampler.batch_stream_blocks(centers, ctxs, batch, np.random.default_rng(2),
                                           block))
    want = list(jax_sampler.batch_stream_blocks(centers, ctxs, batch,
                                                np.random.default_rng(2), block))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g["centers"].shape == (batch,)
        np.testing.assert_array_equal(g["centers"], w["centers"])
        np.testing.assert_array_equal(g["contexts"], w["contexts"])


# ------------------------------------------------ the kernel's schedule ---


def _zipf(n, v, rng):
    w = 1.0 / np.arange(1, v + 1) ** 1.05
    cdf = np.cumsum(w) / w.sum()
    return np.minimum(np.searchsorted(cdf, rng.random(n)), v - 1).astype(np.int32)


def _sum_in_order(rows):
    """The rows of ``rows`` [K, D] added one after the other from zero, as a
    warp or the combine of a CTA adds them."""
    acc = torch.zeros(rows.shape[1:], dtype=torch.float32)
    for r in rows:
        acc = acc + r
    return acc


def emulate_kernel(in_t, out_t, centers, ctxs, pool, lr, lam, window, pc, pn, hot_n, u_cap):
    """``csrc/fused_sgns_merged.cu``'s schedule in torch, a kernel block at a
    time, as its persistent launch walks them between grid barriers:

    * C(b): block b + 1's cold rows are staged after W(b - 1); block b reads
      them, and hot rows live, and scores each center.
    * dQ(b), output-stationary: ``MERGED_CTA_WARPS`` warps each sum g_neg^T V
      over a contiguous span of the block's centers, and the spans' partials
      are added in warp order.
    * W(b): each run of :func:`merged_prep` is written once, base less lr
      times its slots' gradients: a run of at most ``RUN_CHUNK`` slots summed
      in slot order by one warp, a longer one (the prep's ``long_runs``) cut
      into ``MERGED_CTA_WARPS`` contiguous pieces whose sums are added in
      warp order.

    Returns ``(in_t, out_t, loss, longest)``, ``longest`` the most slots of
    one run."""
    n, cw = ctxs.shape
    nb, cap, c, d = n // pc, pc * cw, in_t.shape[0], in_t.stride(0)
    warps, chunk = fused_sgns.MERGED_CTA_WARPS, fused_sgns.RUN_CHUNK
    it, ot = in_t.view(c, d), out_t.view(c, d)
    ent, run_start, n_runs, long_runs, n_long = fused_sgns.merged_prep(
        centers, ctxs, pool, pc, pn, hot_n, u_cap, c)
    cb, xb, qb = centers.view(nb, pc), ctxs.view(nb, cap), pool.view(nb, pn)

    def stage(b):
        def cold(t, r):
            out = torch.zeros(len(r), d, dtype=t.dtype)
            m = (r >= hot_n) & (r < c)
            out[m] = t[r[m].long()]
            return out
        return cold(it, cb[b]), cold(ot, xb[b]), cold(ot, qb[b])

    def value(t, r, staged):
        out = staged.float()
        hot = (r >= 0) & (r < hot_n)
        out[hot] = t[r[hot].long()].float()
        return out

    def split_sum(parts):
        """A CTA's sum of a long run's slot gradients [K, D]."""
        piece = -(-len(parts) // warps)
        return _sum_in_order(torch.stack([_sum_in_order(parts[w * piece:(w + 1) * piece])
                                          if w * piece < len(parts) else
                                          torch.zeros(d) for w in range(warps)]))

    staged, loss, inv_b, longest = stage(0), 0.0, 1.0 / (n * (window + 1)), 0
    span = -(-pc // warps)
    for b in range(nb):
        sv, su, sq = staged
        v, q = value(it, cb[b], sv), value(ot, qb[b], sq)
        u = value(ot, xb[b], su).view(pc, cw, d)
        mask = (xb[b] >= 0).view(pc, cw).float()
        pos, n_real, neg = (u * v[:, None]).sum(-1), mask.sum(1), v @ q.T
        g_pos = (torch.sigmoid(pos) - 1) * inv_b * mask
        g_neg = lam * inv_b * torch.sigmoid(neg) * n_real[:, None]
        dv = (g_pos[:, :, None] * u).sum(1) + g_neg @ q
        dq = _sum_in_order(torch.stack([g_neg[w * span:(w + 1) * span].T @ v[w * span:(w + 1) * span]
                                        for w in range(warps)]))
        loss += float(-((F.logsigmoid(pos) * mask).sum()
                        + lam * (F.logsigmoid(-neg) * n_real[:, None]).sum()) * inv_b)
        if b + 1 < nb:
            staged = stage(b + 1)
        lengths = run_start[b, 1:] - run_start[b, :-1]
        assert long_runs[b, :n_long[b]].tolist() == torch.nonzero(lengths > chunk).view(-1).tolist()
        assert (long_runs[b, n_long[b]:] == -1).all()
        writes = []
        for j in range(int(n_runs[b])):
            e = ent[b, run_start[b, j]:run_start[b, j + 1]].tolist()
            longest = max(longest, len(e))
            total = split_sum if len(e) > chunk else _sum_in_order
            if e[0] >= cap + pn:  # centers: the in-table
                p = [k - cap - pn for k in e]
                writes.append((it, int(cb[b, p[0]]), v[p[0]] - lr * total(dv[p])))
                continue
            r = int(xb[b, e[0]]) if e[0] < cap else int(qb[b, e[0] - cap])
            base = (ot[r] if r < hot_n else su[e[0]] if e[0] < cap else sq[e[0] - cap]).float()
            grads = torch.stack([g_pos.view(-1)[k] * v[k // cw] if k < cap else dq[k - cap]
                                 for k in e])
            writes.append((ot, r, base - lr * total(grads)))
        rows = [(id(t), r) for t, r, _ in writes]
        assert len(set(rows)) == len(rows), "two runs write one row"
        for t, r, val in writes:
            t[r] = val.to(t.dtype)
    return in_t, out_t, loss, longest


def _schedule_case(rng, c, pc, pn, window, nb, hot_n, u_cap, ids, step=0.05):
    """The plain version and the kernel's schedule on one step, at ``step`` a
    pair; returns the longest run."""
    n = pc * nb
    tables = [torch.from_numpy((rng.normal(size=(c, S, L)) * 0.1).astype(np.float32))
              for _ in range(2)]
    lr = step * n * (window + 1)
    want = fused_sgns._merged_plain(*[t.clone() for t in tables], *ids, lr, 0.3, window,
                                    pc, pn, hot_n, u_cap)
    got = emulate_kernel(*[t.clone() for t in tables], *ids, lr, 0.3, window, pc, pn,
                         hot_n, u_cap)
    tfs._assert_same_step([t.numpy() for t in tables], ([t.numpy() for t in got[:2]], got[2]),
                          ([t.numpy() for t in want[:2]], float(want[2])), "float32")
    return got[3]


@pytest.mark.parametrize("hot_n,u_cap", [(64, 0), (0, 24), (32, 40), (512, 512)])
def test_kernel_schedule_matches_the_plain_version_on_zipf_ids(hot_n, u_cap):
    """Heavy duplication within and across blocks: ids zipf over 512 rows."""
    rng = np.random.default_rng(hot_n + u_cap)
    c, pc, pn, window, nb = 512, 16, 8, 3, 6
    n, cw = pc * nb, 2 * window
    ctxs = _zipf(n * cw, c, rng).reshape(n, cw)
    ctxs[rng.random((n, cw)) < 0.3] = -1
    ids = [torch.from_numpy(x) for x in (_zipf(n, c, rng), ctxs, _zipf(nb * pn, c, rng))]
    _schedule_case(rng, c, pc, pn, window, nb, hot_n, u_cap, ids)


@pytest.mark.parametrize("hot_n,u_cap", [(64, 0), (0, 24), (64, 64)])
def test_kernel_schedule_with_a_hot_row_in_every_slot(hot_n, u_cap):
    """Block 1 names row 0 in every center, context and pool slot: one run
    of hundreds of slots, more than a chunk for each warp of a CTA, split
    across the CTA's warps (hot or listed; a cold center row keeps its last
    slot). Blocks 0 and 2 are zipf ids around it. The step a pair is 0.005:
    at 0.05 the row's hundreds of merged slots move it to ~10, and block 2's
    scores of it amplify f32 rounding past the tolerance."""
    rng = np.random.default_rng(7 + hot_n + u_cap)
    c, pc, pn, window, nb = 512, 64, 8, 3, 3
    n, cw = pc * nb, 2 * window
    centers, pool = _zipf(n, c, rng), _zipf(nb * pn, c, rng)
    ctxs = _zipf(n * cw, c, rng).reshape(n, cw)
    ctxs[rng.random((n, cw)) < 0.3] = -1
    centers[pc:2 * pc] = ctxs[pc:2 * pc] = pool[pn:2 * pn] = 0
    ids = [torch.from_numpy(x) for x in (centers, ctxs, pool)]
    longest = _schedule_case(rng, c, pc, pn, window, nb, hot_n, u_cap, ids, step=0.005)
    assert longest > fused_sgns.RUN_CHUNK * fused_sgns.MERGED_CTA_WARPS


def test_merge_runs_on_a_small_case():
    """One block, slots in rank order: row 5 (hot) twice and in the pool, row
    7 (cold, listed) twice, row 9 (cold, past u_cap) twice and in the pool,
    whose slot wins. Then row 5 in ten slots: a run longer than a warp's
    chunk, listed for a CTA."""
    rows = torch.tensor([[5, 9, 7, 5, 9, 7, -1, 9, 5]], dtype=torch.int32)
    keys = torch.where(rows >= 0, rows * 2, fused_sgns._INT32_MAX)  # out-table keys
    codes = torch.arange(9, dtype=torch.int32)
    is_ctx = torch.arange(9) < 7
    ent, run_start, n_runs, long_runs, n_long = fused_sgns.merge_runs(
        keys, codes, is_ctx, hot_n=6, u_cap=2)
    assert n_runs.tolist() == [3]
    runs = [ent[0, run_start[0, j]:run_start[0, j + 1]].tolist() for j in range(3)]
    assert runs == [[0, 3, 8], [2, 5], [7]]
    assert n_long.tolist() == [0] and (long_runs == -1).all()

    rows = torch.tensor([[5, 9, 7, 5, 9, 7, -1, 5, 5, 5, 5, 5, 5, 9, 5, 5]], dtype=torch.int32)
    keys = torch.where(rows >= 0, rows * 2, fused_sgns._INT32_MAX).repeat(2, 1)
    codes = torch.arange(16, dtype=torch.int32)
    is_ctx = torch.arange(16) < 13
    out = fused_sgns.merge_runs(keys, codes, is_ctx, hot_n=6, u_cap=2)
    ent, run_start, n_runs, long_runs, n_long = out
    assert fused_sgns.RUN_CHUNK < 10
    for b in range(2):
        runs = [ent[b, run_start[b, j]:run_start[b, j + 1]].tolist() for j in range(3)]
        assert runs == [[0, 3, 7, 8, 9, 10, 11, 12, 14, 15], [2, 5], [13]]
    assert n_long.tolist() == [1, 1] and long_runs[:, 0].tolist() == [0, 0]
    assert (long_runs[:, 1:] == -1).all()
    # the kernel reads them through raw pointers, rows of K (+ 1) entries
    assert all(t.is_contiguous() for t in out)
    assert [tuple(t.shape) for t in out] == [(2, 16), (2, 17), (2,), (2, 16), (2,)]


# ------------------------------------------------------------ the slice ---


_PATHS = {"resident": dict(resident=1, hot_rows=32),
          "dedup": dict(dedup=1, u_cap=16),
          "dedup_resident": dict(dedup=1, u_cap=16, resident=1, hot_rows=32)}


@pytest.mark.parametrize("hash_keys", [0, 1])
@pytest.mark.parametrize("path", list(_PATHS))
def test_four_substeps_match_jax(path, hash_keys):
    lr = 0.05 * tfs.G_BATCH * (tfs.T_WINDOW + 1)
    jt, tt = tfs._trainers(grouped=1, hash_keys=hash_keys, learning_rate=lr,
                           batch_size=tfs.G_BATCH, **_PATHS[path])
    assert tt.grouped_step[0] is KINDS[path][0]
    rng = np.random.default_rng(22)
    shape = (tt.capacity, S, L)
    lanes = np.arange(S * L).reshape(S, L) < tt.dim
    before = [(rng.normal(0, 0.1, shape) * lanes).astype(np.float32) for _ in range(2)]
    jtables = [jnp.asarray(t) for t in before]
    tstate = convert.w2v_state_from_numpy(*before, device="cpu")
    batches = list(tt.batches())[:4]
    assert len(batches) == 4
    nb = tfs.G_BATCH // tfs.G_PC
    for batch in batches:
        pool = rng.integers(0, tfs.VOCAB, (nb, tfs.T_POOL)).astype(np.int32)
        *jtables, jloss = tfs._jax_substep(jt, jtables, batch, pool, lr)
        tstate, tloss = tt._substep_grouped(
            tstate, torch.from_numpy(batch["centers"]), torch.from_numpy(batch["contexts"]),
            torch.Generator(), tt.lr, negs=torch.from_numpy(pool))
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5, atol=1e-6)
    got = [t.table.numpy() for t in tstate]
    tfs._assert_same_step(before, (got, 0.0), ([np.asarray(t) for t in jtables], 0.0),
                          "float32")


@pytest.mark.parametrize("key", ["resident", "dedup"])
def test_merged_keys_require_grouped_in_both_packages(key):
    words, counts, ids = tfs._corpus(200)
    conf = tfs._conf(**{key: 1})
    with pytest.raises(ValueError, match=f"{key}: 1 requires grouped: 1"):
        jax_w2v.Word2VecTrainer(JaxConfig(conf), mesh=None, corpus_ids=ids,
                                vocab=JaxVocab(words, counts))
    with pytest.raises(ValueError, match=f"{key}: 1 requires grouped: 1"):
        word2vec.Word2VecTrainer(Config(conf), corpus_ids=ids, vocab=Vocab(words, counts),
                                 device="cpu")


@pytest.mark.parametrize("keys,kernel,extra", [
    (dict(dedup=1, resident=1, u_cap=16, hot_rows=32), "fused_sgns_dedup_resident_step",
     {"u_cap": 16, "hot_rows": 16}),
    (dict(dedup=1, resident=1, u_cap=384, hot_rows=256), "fused_sgns_dedup_resident_step",
     {"u_cap": 384, "hot_rows": 128}),
    (dict(dedup=1, resident=1, u_cap=16, hot_rows=4), "fused_sgns_dedup_step", {"u_cap": 16}),
    (dict(resident=1, hot_rows=4), "fused_sgns_grouped_step", {}),
    (dict(resident=1, hot_rows=300), "fused_sgns_resident_step", {"hot_rows": 128}),
])
def test_grouped_dispatch_and_head_clamp(caplog, keys, kernel, extra):
    """The composed head clamps to ``u_cap`` (with the JAX warning), and a
    head of fewer than 8 rows drops the resident part; ``hot_rows`` passes
    clipped to the capacity (128 here)."""
    with caplog.at_level(logging.WARNING, logger=word2vec.__name__):
        _, tt = tfs._trainers(grouped=1, **keys)
    fn, got = tt.grouped_step
    assert fn.__name__ == kernel and got == extra
    clamped = "u_cap" in extra and keys.get("hot_rows", 0) > keys["u_cap"]
    assert ("clamping the resident head" in caplog.text) == clamped


def test_dedup_batches_block_ordered_as_in_jax():
    jt, tt = tfs._trainers(n=20000, grouped=1, dedup=1, centers_per_block=12,
                           steps_per_call=2, num_iters=2, chunk_tokens=7000)
    assert tt._effective_pc() == jt._effective_pc() == 8
    want, got = list(jt.batches()), list(tt.batches())
    assert len(got) == len(want) > 2
    for g, w in zip(got, want):
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])
    first = got[0]["centers"]
    assert first.shape == (2 * tfs.T_BATCH,)


@pytest.mark.parametrize("path", list(_PATHS))
def test_loss_decreases_and_launches_no_kernel_on_the_cpu(path):
    rng = np.random.default_rng(0)
    vocab_size = 50
    counts = np.maximum(rng.integers(1, 50, vocab_size), 1).astype(np.int64)
    vocab = Vocab([f"w{i}" for i in range(vocab_size)], counts)
    base = np.repeat(np.arange(10), 40) % vocab_size
    corpus = ((base + rng.integers(0, 2, base.size)) % vocab_size).astype(np.int32)
    keys = {k: str(v) for k, v in _PATHS[path].items()}
    cfg = Config({
        "dim": "16", "window": "2", "negatives": "3", "learning_rate": "3.2",
        "batch_size": "64", "subsample": "0", "num_iters": "30", "pool_size": "8",
        "centers_per_block": "16", "steps_per_call": "2", "fused": "1", "grouped": "1",
        "use_native": "0", **keys})
    tr = word2vec.Word2VecTrainer(cfg, corpus_ids=corpus, vocab=vocab, device="cpu")
    records = []

    class Recorder(MetricsLogger):
        def log(self, record):
            records.append(record)

    counters = (fused_sgns.fused_sgns_resident_step, fused_sgns.fused_sgns_dedup_step,
                fused_sgns.fused_sgns_dedup_resident_step,
                fused_sgns.fused_sgns_grouped_step, rowdma.gather_rows)
    before = [f.launches for f in counters]
    TrainLoop(tr, metrics=Recorder(), log_every=1).run(max_steps=40)
    assert [f.launches for f in counters] == before
    losses = [r["loss"] for r in records]
    assert len(losses) >= 10 and all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]), losses
