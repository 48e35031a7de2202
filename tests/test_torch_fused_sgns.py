"""The port's fused SGNS substeps against the JAX package's, on the CPU.

The JAX kernels run in interpret mode, as ``tests/test_fused_sgns.py`` runs
them: their grid is sequential there, which is the deterministic meaning of
the hogwild kernels (``swiftsnails_tpu_torch/ops/fused_sgns.py``, rules 1-3).
The port's plain versions implement that meaning as a loop over blocks.
Inputs are made with numpy and plant what the rules are about: duplicate
rows within a block and across neighbouring blocks, rows shared by context
and pool slots, pads and fully padded centers. Tables agree within rtol 2e-5
/ atol 2e-6 in f32 (reduction order), each table's change within 1e-4 of its
largest change, and within one bf16 rounding in bf16.
``test_planted_faults_fail_the_comparison`` shows that the comparison fails
when the port breaks a rule.
"""

from unittest import mock

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from swiftsnails_tpu.data import sampler as jax_sampler
from swiftsnails_tpu.data.vocab import Vocab as JaxVocab
from swiftsnails_tpu.models import word2vec as jax_w2v
from swiftsnails_tpu.ops import fused_sgns as jax_fused
from swiftsnails_tpu.utils.config import Config as JaxConfig
from swiftsnails_tpu_torch import convert
from swiftsnails_tpu_torch.data import sampler
from swiftsnails_tpu_torch.data.vocab import Vocab
from swiftsnails_tpu_torch.framework.trainer import TrainLoop
from swiftsnails_tpu_torch.models import word2vec
from swiftsnails_tpu_torch.ops import fused_sgns, rowdma
from swiftsnails_tpu_torch.utils.config import Config
from swiftsnails_tpu_torch.utils.metrics import MetricsLogger

RTOL, ATOL = 2e-5, 2e-6
DELTA_RTOL = 1e-4  # a table's change agrees within this share of its largest
BF16_RTOL = 2.0**-7  # one bf16 rounding: the step between bf16 neighbours
# One intra-op thread: the shapes are small, and the suite's workers share
# the cores with the JAX mesh tests, which abort under CPU contention.
torch.set_num_threads(1)

C, S, L = 64, 2, 128
B, P, PN = 32, 8, 4  # flat: 4 blocks of 8 pairs, 4 pool rows each
N, PC, W = 32, 8, 3  # grouped: 4 blocks of 8 centers, windows of 2 * 3 slots
CW = 2 * W
LAM = 0.625
LR_FLAT = 0.05 * B  # the loss is a mean over pairs: 0.05 a pair
LR_GROUPED = 0.05 * N * (W + 1)  # ... over N * (window + 1) expected pairs


def _tables(rng):
    return [(rng.normal(size=(C, S, L)) * 0.1).astype(np.float32) for _ in range(2)]


def _flat_inputs(seed):
    """Random ids over a small vocabulary (duplicates everywhere), plus a
    planted U/pool collision in block 1 and a row shared by blocks 1 and 2."""
    rng = np.random.default_rng(seed)
    in_t, out_t = _tables(rng)
    in_rows = rng.integers(0, C, B).astype(np.int32)
    pos_rows = rng.integers(0, C, B).astype(np.int32)
    pool_rows = rng.integers(0, C, (B // P) * PN).astype(np.int32)
    pos_rows[P + 2] = pos_rows[P + 5] = pool_rows[PN + 1]
    in_rows[P + 3] = in_rows[2 * P + 4]
    pos_rows[P + 6] = pos_rows[2 * P + 1]
    return in_t, out_t, in_rows, pos_rows, pool_rows


def _grouped_inputs(seed):
    """Windows with random pads, a fully padded center, a row at (p=0, c=1)
    and (p=1, c=0) of block 0 (c-major and p-major last-wins differ), a
    context/pool collision in block 1 and rows shared by blocks 1 and 2."""
    rng = np.random.default_rng(seed)
    in_t, out_t = _tables(rng)
    centers = rng.integers(0, C, N).astype(np.int32)
    ctxs = rng.integers(0, C, (N, CW)).astype(np.int32)
    ctxs[rng.random((N, CW)) < 0.4] = -1
    ctxs[3] = -1
    pool_rows = rng.integers(0, C, (N // PC) * PN).astype(np.int32)
    ctxs[0, 1] = ctxs[1, 0] = 7
    ctxs[0, 0] = ctxs[1, 1] = -1
    ctxs[PC + 2, 0] = pool_rows[PN + 3]
    ctxs[PC + 4, 2] = ctxs[2 * PC + 5, 3]
    centers[PC + 1] = centers[2 * PC + 6]
    return in_t, out_t, centers, ctxs, pool_rows


def _bf16(x):
    return jnp.asarray(x).astype(jnp.bfloat16)


def _jax_flat(dtype, in_t, out_t, in_rows, pos_rows, pool_rows):
    cast = _bf16 if dtype == "bfloat16" else jnp.asarray
    got = jax_fused.fused_sgns_step(
        cast(in_t), cast(out_t), jnp.asarray(in_rows), jnp.asarray(pos_rows),
        jnp.asarray(pool_rows), lr=LR_FLAT, lam=LAM, pairs_per_block=P,
        pool_size=PN, interpret=True)
    return [np.asarray(x.astype(jnp.float32)) for x in got[:2]], float(got[2])


def _jax_grouped(dtype, in_t, out_t, centers, ctxs, pool_rows):
    cast = _bf16 if dtype == "bfloat16" else jnp.asarray
    got = jax_fused.fused_sgns_grouped_step(
        cast(in_t), cast(out_t), jnp.asarray(centers), jnp.asarray(ctxs),
        jnp.asarray(pool_rows), lr=LR_GROUPED, lam=LAM, window=W,
        centers_per_block=PC, pool_size=PN, interpret=True)
    return [np.asarray(x.astype(jnp.float32)) for x in got[:2]], float(got[2])


def _torch_tables(dtype, in_t, out_t):
    tdt = getattr(torch, dtype)
    return [torch.from_numpy(t.copy()).to(tdt) for t in (in_t, out_t)]


def _port_flat(dtype, in_t, out_t, in_rows, pos_rows, pool_rows):
    ti, to = _torch_tables(dtype, in_t, out_t)
    a, b, loss = fused_sgns.fused_sgns_step(
        ti, to, torch.from_numpy(in_rows), torch.from_numpy(pos_rows),
        torch.from_numpy(pool_rows), LR_FLAT, LAM, P, PN)
    assert a is ti and b is to  # in place
    return [t.float().numpy() for t in (a, b)], float(loss)


def _port_grouped(dtype, in_t, out_t, centers, ctxs, pool_rows):
    ti, to = _torch_tables(dtype, in_t, out_t)
    a, b, loss = fused_sgns.fused_sgns_grouped_step(
        ti, to, torch.from_numpy(centers), torch.from_numpy(ctxs),
        torch.from_numpy(pool_rows), LR_GROUPED, LAM, W, PC, PN)
    assert a is ti and b is to
    return [t.float().numpy() for t in (a, b)], float(loss)


_KINDS = {"flat": (_flat_inputs, _jax_flat, _port_flat),
          "grouped": (_grouped_inputs, _jax_grouped, _port_grouped)}
_JAX_CACHE = {}


def _want(kind, dtype, seed):
    key = (kind, dtype, seed)
    if key not in _JAX_CACHE:
        make, run_jax, _ = _KINDS[kind]
        _JAX_CACHE[key] = run_jax(dtype, *make(seed))
    return _JAX_CACHE[key]


def _assert_same_step(before, got, want, dtype):
    (tables, loss), (want_tables, want_loss) = got, want
    for name, start, g, w in zip(("in_table", "out_table"), before, tables, want_tables):
        if dtype == "bfloat16":
            np.testing.assert_allclose(g, w, rtol=BF16_RTOL, atol=1e-6, err_msg=name)
            continue
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=name)
        scale = float(np.abs(w - start).max())
        assert scale > 100 * ATOL, (name, scale)
        np.testing.assert_allclose(g - start, w - start, rtol=0,
                                   atol=DELTA_RTOL * scale, err_msg=name)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-4)


def _compare(kind, dtype, seed):
    make, _, run_port = _KINDS[kind]
    inputs = make(seed)
    _assert_same_step(inputs[:2], run_port(dtype, *inputs), _want(kind, dtype, seed), dtype)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["flat", "grouped"])
def test_plain_matches_jax_interpret(kind, dtype, seed):
    _compare(kind, dtype, seed)


def _p_major_flags(ctxs, pc):
    n, cw = ctxs.shape
    blocks = ctxs.view(n // pc, pc * cw)
    return fused_sgns.last_occurrence(blocks, blocks >= 0).view(n, cw)


def _no_staleness(nblocks, read, update):
    for b in range(nblocks):
        update(b, read(b))


_apply_writes = fused_sgns._apply_writes


def _u_after_pool(writes):
    _apply_writes(writes[:1] + writes[2:] + writes[1:2])


def test_c_major_and_p_major_differ_on_the_planted_case():
    _, _, _, ctxs, _ = _grouped_inputs(0)
    t = torch.from_numpy(ctxs)
    c_major, p_major = fused_sgns.context_flags(t, PC), _p_major_flags(t, PC)
    assert c_major[0, 1] and not c_major[1, 0]  # k = 1 * PC + 0 > 0 * PC + 1
    assert p_major[1, 0] and not p_major[0, 1]


@pytest.mark.parametrize("kind,fault", [
    ("grouped", "p_major"), ("flat", "no_staleness"), ("grouped", "no_staleness"),
    ("flat", "u_after_pool"), ("grouped", "u_after_pool")])
def test_planted_faults_fail_the_comparison(monkeypatch, kind, fault):
    target, replacement = {
        "p_major": ("context_flags", _p_major_flags),
        "no_staleness": ("_double_buffered", _no_staleness),
        "u_after_pool": ("_apply_writes", _u_after_pool)}[fault]
    monkeypatch.setattr(fused_sgns, target, replacement)
    with pytest.raises(AssertionError):
        _compare(kind, "float32", 0)


def test_pads_are_never_read():
    """A NaN in row 0 reaches nothing through the pads (-1) of the grouped
    step, and the tables stay finite where row 0 is not used."""
    in_t, out_t, centers, ctxs, pool_rows = _grouped_inputs(1)
    for ids in (centers, ctxs, pool_rows):
        ids[ids == 0] = 1
    out_t[0] = np.nan
    (a, b), loss = _port_grouped("float32", in_t, out_t, centers, ctxs, pool_rows)
    assert np.isfinite(a).all() and np.isfinite(b[1:]).all() and np.isfinite(loss)


@pytest.mark.parametrize("bad,match", [
    (dict(in_rows=np.zeros(B - 1, np.int32)), "pairs_per_block"),
    (dict(pool_rows=np.zeros(PN, np.int32)), "pool_rows"),
    (dict(out_t=np.zeros((C, 1, L), np.float32)), "row shape"),
    (dict(in_rows=np.zeros(B, np.int64)), "int32"),
])
def test_flat_validation_errors(bad, match):
    in_t, out_t, in_rows, pos_rows, pool_rows = _flat_inputs(0)
    args = dict(in_t=in_t, out_t=out_t, in_rows=in_rows, pos_rows=pos_rows,
                pool_rows=pool_rows)
    args.update(bad)
    with pytest.raises((ValueError, TypeError), match=match):
        fused_sgns.fused_sgns_step(
            torch.from_numpy(args["in_t"]), torch.from_numpy(args["out_t"]),
            torch.from_numpy(args["in_rows"]), torch.from_numpy(args["pos_rows"]),
            torch.from_numpy(args["pool_rows"]), 0.1, LAM, P, PN)


@pytest.mark.parametrize("bad,match", [
    (dict(ctxs=np.zeros((N - 1, CW), np.int32)), "centers_per_block"),
    (dict(pool_rows=np.zeros(PN, np.int32)), "pool_rows"),
    (dict(ctxs=np.zeros(N * CW, np.int32)), r"\[N, CW\]"),
    (dict(out_t=np.zeros((C // 2, S, L), np.float32)), "capacity"),
])
def test_grouped_validation_errors(bad, match):
    in_t, out_t, centers, ctxs, pool_rows = _grouped_inputs(0)
    args = dict(in_t=in_t, out_t=out_t, centers=centers, ctxs=ctxs,
                pool_rows=pool_rows)
    args.update(bad)
    with pytest.raises(ValueError, match=match):
        fused_sgns.fused_sgns_grouped_step(
            torch.from_numpy(args["in_t"]), torch.from_numpy(args["out_t"]),
            torch.from_numpy(args["centers"]), torch.from_numpy(args["ctxs"]),
            torch.from_numpy(args["pool_rows"]), 0.1, LAM, W, PC, PN)


# ------------------------------------------------------------ the slice ---

VOCAB = 96
T_BATCH, T_POOL_BLOCK, T_POOL = 64, 16, 8  # flat: 4 kernel blocks a substep
G_BATCH, G_PC = 32, 8  # grouped: 4 kernel blocks a substep
T_WINDOW = 3


def _conf(**over):
    conf = {"dim": "200", "window": str(T_WINDOW), "negatives": "4",
            "learning_rate": "0.1", "batch_size": str(T_BATCH), "subsample": "0",
            "num_iters": "1", "pool_size": str(T_POOL),
            "pool_block": str(T_POOL_BLOCK), "centers_per_block": str(G_PC),
            "use_native": "0", "seed": "5", "fused": "1"}
    conf.update({k: str(v) for k, v in over.items()})
    return conf


def _corpus(n=2000, seed=0):
    rng = np.random.default_rng(seed)
    counts = np.maximum(rng.zipf(1.2, VOCAB), 1).astype(np.int64)
    p = counts / counts.sum()
    return [f"w{i}" for i in range(VOCAB)], counts, rng.choice(VOCAB, size=n, p=p).astype(np.int32)


def _trainers(n=2000, **over):
    words, counts, ids = _corpus(n)
    conf = _conf(**over)
    jt = jax_w2v.Word2VecTrainer(JaxConfig(conf), mesh=None, corpus_ids=ids,
                                 vocab=JaxVocab(words, counts))
    tt = word2vec.Word2VecTrainer(Config(conf), corpus_ids=ids,
                                  vocab=Vocab(words, counts), device="cpu")
    return jt, tt


def _jax_substep(jt, tables, batch, pool, lr):
    """One JAX substep with the pool given: the trainer's own
    ``_substep_grouped`` (its choice of kernel included) for the window
    schema, else the kernel call as ``_substep_fused`` makes it."""
    centers, ctxs = jnp.asarray(batch["centers"]), jnp.asarray(batch["contexts"])
    if jt.grouped:
        state = jax_w2v.W2VState(*(t._replace(table=x)
                                   for t, x in zip(jt.init_state(), tables)))
        with mock.patch.object(jax_w2v, "alias_sample", lambda *_: jnp.asarray(pool)):
            state, loss, _ = jt._substep_grouped(state, centers, ctxs, None, lr)
        return state.in_table.table, state.out_table.table, loss
    b = centers.shape[0]
    pb = min(jt.pool_block, b)
    while b % pb:
        pb -= 1
    return jax_fused.fused_sgns_step(
        *tables, jt._rows(centers), jt._rows(ctxs),
        jt._rows(jnp.asarray(pool).reshape(-1)), lr=lr,
        lam=jt.negatives / jt.pool_size, pairs_per_block=pb,
        pool_size=jt.pool_size, interpret=True)


@pytest.mark.parametrize("hash_keys", [0, 1])
@pytest.mark.parametrize("grouped", [0, 1])
def test_four_substeps_match_jax(grouped, hash_keys):
    batch_size = G_BATCH if grouped else T_BATCH
    lr = 0.05 * (G_BATCH * (T_WINDOW + 1) if grouped else T_BATCH)
    jt, tt = _trainers(grouped=grouped, hash_keys=hash_keys, learning_rate=lr,
                       batch_size=batch_size)
    assert (tt.fused, tt.grouped, jt.fused, jt.grouped) == (True, bool(grouped)) * 2
    rng = np.random.default_rng(21)
    shape = (tt.capacity, S, L)
    lanes = np.arange(S * L).reshape(S, L) < tt.dim
    before = [(rng.normal(0, 0.1, shape) * lanes).astype(np.float32) for _ in range(2)]
    jtables = [jnp.asarray(t) for t in before]
    tstate = convert.w2v_state_from_numpy(*before, device="cpu")
    batches = list(tt.batches())[:4]
    assert len(batches) == 4
    substep = tt._substep_grouped if grouped else tt._substep_fused
    nb = batch_size // (G_PC if grouped else T_POOL_BLOCK)
    for i, batch in enumerate(batches):
        pool = rng.integers(0, VOCAB, (nb, T_POOL)).astype(np.int32)
        *jtables, jloss = _jax_substep(jt, jtables, batch, pool, lr)
        tstate, tloss = substep(
            tstate, torch.from_numpy(batch["centers"]),
            torch.from_numpy(batch["contexts"]), torch.Generator(), tt.lr,
            negs=torch.from_numpy(pool))
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5, atol=1e-6)
    got = [t.table.numpy() for t in tstate]
    _assert_same_step(before, (got, 0.0), ([np.asarray(t) for t in jtables], 0.0),
                      "float32")
    for t in got:
        assert not t.reshape(tt.capacity, -1)[:, tt.dim:].any()


def test_skipgram_windows_match_jax_and_hold_the_pair_set():
    ids = np.random.default_rng(3).integers(0, 50, 500).astype(np.int32)
    c, x = sampler.skipgram_windows(ids, 4, np.random.default_rng(9))
    jc, jx = jax_sampler.skipgram_windows(ids, 4, np.random.default_rng(9))
    np.testing.assert_array_equal(c, jc)
    np.testing.assert_array_equal(x, jx)
    assert x.shape == (500, 8) and x.dtype == np.int32
    pc, px = sampler.skipgram_pairs(ids, 4, np.random.default_rng(9))
    real = x >= 0
    np.testing.assert_array_equal(np.repeat(c, real.sum(1)), pc)
    np.testing.assert_array_equal(x[real], px)


@pytest.mark.parametrize("subsample", [0, 1e-4])
@pytest.mark.parametrize("steps_per_call", [1, 2])
def test_grouped_batches_identical(subsample, steps_per_call):
    jt, tt = _trainers(n=20000, grouped=1, subsample=subsample,
                       steps_per_call=steps_per_call, num_iters=2,
                       chunk_tokens=7000)
    want, got = list(jt.batches()), list(tt.batches())
    assert len(got) == len(want) > 2
    for g, w in zip(got, want):
        assert g.keys() == w.keys() == {"centers", "contexts", "progress"}
        assert g["contexts"].shape == (T_BATCH * steps_per_call, 2 * T_WINDOW)
        for k in g:
            assert np.asarray(g[k]).dtype == np.asarray(w[k]).dtype, k
            np.testing.assert_array_equal(g[k], w[k])


def test_grouped_requires_fused_in_both_packages():
    words, counts, ids = _corpus(200)
    conf = _conf(fused=0, grouped=1)
    with pytest.raises(ValueError, match="requires fused"):
        jax_w2v.Word2VecTrainer(JaxConfig(conf), mesh=None, corpus_ids=ids,
                                vocab=JaxVocab(words, counts))
    with pytest.raises(ValueError, match="requires fused"):
        word2vec.Word2VecTrainer(Config(conf), corpus_ids=ids,
                                 vocab=Vocab(words, counts), device="cpu")


def test_keys_read_as_the_jax_trainer_reads_them():
    jt, tt = _trainers(grouped=1, hot_rows=2048, u_cap=256, centers_per_block=12)
    for key in ("fused", "grouped", "hot_rows", "u_cap", "centers_per_block"):
        assert getattr(tt, key) == getattr(jt, key), key
    for n in (32, 36, 64, 7):
        assert tt._effective_pc(n) == jt._effective_pc(n)
    _, plain = _trainers(fused=0)
    assert not plain.fused and not plain.grouped and plain.centers_per_block == G_PC


@pytest.mark.parametrize("key,kernel", [
    ("resident", fused_sgns.fused_sgns_resident_step),
    ("dedup", fused_sgns.fused_sgns_dedup_step)])
def test_resident_and_dedup_dispatch_to_their_kernels(key, kernel):
    words, counts, ids = _corpus(200)
    tr = word2vec.Word2VecTrainer(Config(_conf(grouped=1, **{key: 1})), corpus_ids=ids,
                                  vocab=Vocab(words, counts), device="cpu")
    assert tr.grouped_step[0] is kernel


@pytest.mark.parametrize("grouped", [0, 1])
def test_fused_loss_decreases_and_launches_no_kernel_on_the_cpu(grouped):
    rng = np.random.default_rng(0)
    vocab_size = 50
    counts = np.maximum(rng.integers(1, 50, vocab_size), 1).astype(np.int64)
    vocab = Vocab([f"w{i}" for i in range(vocab_size)], counts)
    base = np.repeat(np.arange(10), 40) % vocab_size
    corpus = ((base + rng.integers(0, 2, base.size)) % vocab_size).astype(np.int32)
    cfg = Config({
        "dim": "16", "window": "2", "negatives": "3", "learning_rate": "3.2",
        "batch_size": "64", "subsample": "0", "num_iters": "30",
        "pool_size": "8", "pool_block": "16", "centers_per_block": "16",
        "steps_per_call": "2", "fused": "1", "grouped": str(grouped),
        "use_native": "0",
    })
    tr = word2vec.Word2VecTrainer(cfg, corpus_ids=corpus, vocab=vocab, device="cpu")
    records = []

    class Recorder(MetricsLogger):
        def log(self, record):
            records.append(record)

    counters = (fused_sgns.fused_sgns_step, fused_sgns.fused_sgns_grouped_step,
                rowdma.gather_rows, rowdma.scatter_add_rows)
    before = [f.launches for f in counters]
    TrainLoop(tr, metrics=Recorder(), log_every=1).run(max_steps=40)
    assert [f.launches for f in counters] == before
    losses = [r["loss"] for r in records]
    assert len(losses) >= 10 and all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]), losses
    if grouped:  # a grouped batch counts words (corpus positions)
        assert records[0]["items"] == 2 * 64


# ------------------------------------------------ the kernels' schedule ---
#
# csrc/fused_sgns.cu runs a kernel block as a cluster of K CTAs: tile T (of
# pairs, or centers) goes to CTA T mod K, in rounds of K tiles; in a round
# every CTA reads its tile and computes, the cluster syncs, and every CTA
# writes its flagged center and context rows, each the row as it then
# stands less its step; dQ is summed per CTA and then over the CTAs in rank
# order, and the pool (its snapshot less its step) is written after the
# last round; the grouped form's context steps go to scratch and are
# applied after the pool's write, but for the block's pool rows (the pool's
# write wins). The emulation below runs a block's schedule as a generator
# that yields at each round's barrier, with its CTAs in the worst order the
# barriers allow (the last CTA's writes of round r landing after the other
# CTAs' reads of round r + 1). Run one block after another on ids whose
# rows are disjoint between blocks, it must equal the plain version; run in
# lockstep on center and context rows that blocks share, every block's
# step of a shared row must survive. A planted fault must fail it: a round
# without its barrier, or a context write of a pool row landing after the
# pool's.

SCHED_SPAN, SCHED_NB = 32, 2  # C = 64 rows
SCHED_P, SCHED_PC, SCHED_PN, SCHED_TILE = 14, 10, 4, 2  # 7 and 5 tiles a block


def _rounds(ntiles, k, compute, apply, fault, before_last_writes):
    """Tile T read by CTA T mod K in round T // K; ``compute(cta, T)`` reads
    the tables and returns that tile's writes, ``apply`` lands them. Yields
    at each round's barrier, after its reads; ``before_last_writes()`` runs
    at the last round's barrier, ahead of its writes. ``fault="no_barrier"``:
    a CTA writes as soon as it has computed, the last CTA first."""
    rounds = -(-ntiles // k)
    late = None  # the last CTA's writes, landing after the others' next reads
    for r in range(rounds):
        mine = {cta: r * k + cta for cta in range(k) if r * k + cta < ntiles}
        if fault == "no_barrier":
            for cta in sorted(mine, reverse=True):
                apply(compute(cta, mine[cta]))
            if r == rounds - 1:
                before_last_writes()
            yield
            continue
        writes = {}
        for cta in sorted(mine):
            if cta == k - 1 and late is not None:  # its own earlier writes first
                apply(late)
                late = None
            writes[cta] = compute(cta, mine[cta])
        if late is not None:  # the barrier: every CTA's writes of round r - 1 landed
            apply(late)
            late = None
        if r == rounds - 1:
            before_last_writes()
        yield
        for cta in sorted(writes):
            if cta == k - 1 and r < rounds - 1:
                late = writes[cta]
            else:
                apply(writes[cta])


def _rank_sum(parts):
    acc = torch.zeros_like(parts[0])
    for part in parts:
        acc = acc + part
    return acc


def _stepper(fault):
    """Lands ``(table, rows, snapshot [K, D], steps [K, D], flags)`` center
    and context writes: each flagged row becomes the row as it stands less
    its step (one rounding); ``fault="stale_write"``: the snapshot less the
    step."""
    def apply(writes):
        for table, rows, snap, steps, flags in writes:
            idx = rows[flags].long()
            base = snap[flags] if fault == "stale_write" else table[idx].float()
            table[idx] = (base - steps[flags]).to(table.dtype)
    return apply


def _pool_write(ot, prow, q, step, keep):
    """The pool's write: its flagged rows become the snapshot less the step."""
    ot[prow[keep]] = (q - step)[keep].to(ot.dtype)


def _block_flat(it, ot, b, in_rows, pos_rows, pool_rows, flags, lr, lam, p, pn, k, tile,
                inv_b, losses, fault):
    """``fused_sgns_kernel``'s schedule for kernel block ``b`` (a generator)."""
    v_last, u_last, q_last = flags
    d = it.shape[1]
    prow = pool_rows[b * pn:(b + 1) * pn].long()
    q = ot[prow].float()  # every CTA loads the pool before its first barrier
    parts, loss = [torch.zeros(pn, d) for _ in range(k)], [0.0] * k
    apply = _stepper(fault)

    def compute(cta, tix):
        slots = torch.arange(b * p + tix * tile, b * p + min((tix + 1) * tile, p))
        vr, ur = in_rows[slots].long(), pos_rows[slots].long()
        v, u = it[vr].float(), ot[ur].float()
        pos, neg = (v * u).sum(1), v @ q.T
        g_pos = (torch.sigmoid(pos) - 1) * inv_b
        g_neg = lam * inv_b * torch.sigmoid(neg)
        parts[cta] += g_neg.T @ v
        loss[cta] += float(F.logsigmoid(pos).sum() + lam * F.logsigmoid(-neg).sum())
        return [(it, vr, v, lr * (g_pos[:, None] * u + g_neg @ q), v_last[slots]),
                (ot, ur, u, lr * g_pos[:, None] * v, u_last[slots])]

    keep = q_last[b * pn:(b + 1) * pn]

    def pool_write():
        _pool_write(ot, prow, q, lr * _rank_sum(parts), keep)

    yield from _rounds(-(-p // tile), k, compute, apply, fault,
                       pool_write if fault == "context_over_pool" else lambda: None)
    if fault != "context_over_pool":
        pool_write()
    losses.append(-sum(loss) * inv_b)


def _block_grouped(it, ot, b, centers, ctxs, pool_rows, flags, lr, lam, pc, pn, k, tile,
                   inv_b, losses, fault):
    """``fused_sgns_grouped_kernel``'s schedule for kernel block ``b`` (a
    generator)."""
    c_last, x_last, q_last = flags
    d, cw = it.shape[1], ctxs.shape[1]
    prow = pool_rows[b * pn:(b + 1) * pn].long()
    q = ot[prow].float()
    parts, loss, scratch = [torch.zeros(pn, d) for _ in range(k)], [0.0] * k, {}
    apply = _stepper(fault)
    flat_ctx = ctxs.reshape(-1)

    def compute(cta, tix):
        cs = torch.arange(b * pc + tix * tile, b * pc + min((tix + 1) * tile, pc))
        v = it[centers[cs].long()].float()
        x = ctxs[cs]  # [t, cw]
        real = x >= 0
        u = torch.zeros(len(cs), cw, d)
        u[real] = ot[x[real].long()].float()  # pads are never read
        mask, n_real = real.float(), real.float().sum(1)
        pos, neg = (u * v[:, None]).sum(-1), v @ q.T
        g_pos = (torch.sigmoid(pos) - 1) * inv_b * mask
        g_neg = lam * inv_b * torch.sigmoid(neg) * n_real[:, None]
        parts[cta] += g_neg.T @ v
        loss[cta] += float((F.logsigmoid(pos) * mask).sum()
                           + lam * (F.logsigmoid(-neg) * n_real[:, None]).sum())
        steps = lr * g_pos[:, :, None] * v[:, None]
        for j, cj in enumerate(cs.tolist()):
            for s in range(cw):
                slot = cj * cw + s
                if x_last[slot]:
                    scratch[slot] = (u[j, s], steps[j, s])
        dv = (g_pos[:, :, None] * u).sum(1) + g_neg @ q
        return [(it, centers[cs].long(), v, lr * dv, c_last[cs])]

    yield from _rounds(-(-pc // tile), k, compute, apply, fault, lambda: None)
    keep = q_last[b * pn:(b + 1) * pn]
    _pool_write(ot, prow, q, lr * _rank_sum(parts), keep)
    for slot, (snap, step) in scratch.items():  # the deferred context writes
        row = flat_ctx[slot:slot + 1]
        if fault == "context_over_pool" or not torch.isin(row.long(), prow)[0]:
            apply([(ot, row, snap[None], step[None], torch.ones(1, dtype=bool))])
    losses.append(-sum(loss) * inv_b)


def _drive(blocks, lockstep):
    """Run the blocks' schedules one after another, or in lockstep: each
    block to its next barrier in turn, so that every block's reads of a
    round come before any block's writes of it."""
    if not lockstep:
        for g in blocks:
            for _ in g:
                pass
        return
    live = list(blocks)
    while live:
        for g in list(live):
            try:
                next(g)
            except StopIteration:
                live.remove(g)


def emulate_flat(in_t, out_t, in_rows, pos_rows, pool_rows, lr, lam, p, pn, k, tile,
                 fault=None, lockstep=False):
    """``fused_sgns_kernel``'s schedule; returns ``(in_t, out_t, loss)``."""
    c, d = in_t.shape[0], in_t.stride(0)
    it, ot = in_t.view(c, d), out_t.view(c, d)
    flags = [f.reshape(-1) for f in fused_sgns.flat_flags(in_rows, pos_rows, pool_rows, p, pn)]
    losses = []
    _drive([_block_flat(it, ot, b, in_rows, pos_rows, pool_rows, flags, lr, lam, p, pn, k,
                        tile, 1.0 / in_rows.numel(), losses, fault)
            for b in range(in_rows.numel() // p)], lockstep)
    return in_t, out_t, sum(losses)


def emulate_grouped(in_t, out_t, centers, ctxs, pool_rows, lr, lam, window, pc, pn, k,
                    tile, fault=None, lockstep=False):
    """``fused_sgns_grouped_kernel``'s schedule; returns ``(in_t, out_t,
    loss)``."""
    c, d = in_t.shape[0], in_t.stride(0)
    it, ot = in_t.view(c, d), out_t.view(c, d)
    n = ctxs.shape[0]
    flags = [f.reshape(-1) for f in fused_sgns.grouped_flags(centers, ctxs, pool_rows, pc, pn)]
    losses = []
    _drive([_block_grouped(it, ot, b, centers, ctxs, pool_rows, flags, lr, lam, pc, pn, k,
                           tile, 1.0 / (n * (window + 1)), losses, fault)
            for b in range(n // pc)], lockstep)
    return in_t, out_t, sum(losses)


def _sched_ids(rng, per_block, shared=False, pool=False):
    """Block-local ids, block b's drawn from [b * SPAN, b * SPAN + 24):
    duplicates within a block; the 8 ids above are left for planted rows.
    ``shared``: every block's from [0, 24), so blocks share rows, except
    the pool's (block b's from [SPAN + 12 b, SPAN + 12 b + 12))."""
    if shared and pool:
        return rng.integers(0, 12, (SCHED_NB, per_block)) + SCHED_SPAN + 12 * np.arange(
            SCHED_NB)[:, None]
    ids = rng.integers(0, SCHED_SPAN - 8, (SCHED_NB, per_block))
    return ids if shared else ids + SCHED_SPAN * np.arange(SCHED_NB)[:, None]


def _sched_flat(seed, shared=False):
    """Flat inputs, with in block 0: a V row at slots 1 and TILE + 1 (its
    last slot in CTA 1's first tile, read by CTA 0 in the same round), and
    the last U slot's row also its first pool row (the pool write wins)."""
    rng = np.random.default_rng(seed)
    in_t, out_t = _tables(rng)  # C = SCHED_NB * SCHED_SPAN rows
    in_rows = _sched_ids(rng, SCHED_P, shared)
    pos_rows = _sched_ids(rng, SCHED_P, shared)
    pool = _sched_ids(rng, SCHED_PN, shared, pool=True)
    y = SCHED_SPAN - 1
    in_rows[0, 1] = in_rows[0, SCHED_TILE + 1] = y
    pos_rows[0, -1] = pool[0, 0] = y - 1
    return (in_t, out_t, *(a.reshape(-1).astype(np.int32) for a in (in_rows, pos_rows, pool)))


def _sched_grouped(seed, shared=False):
    """Grouped inputs (pads, a fully padded center), with in block 0: a
    center row at centers 1 and TILE + 1, and a context row that is also the
    first pool row (its only context slot, in the block's last tile)."""
    rng = np.random.default_rng(seed)
    in_t, out_t = _tables(rng)  # C = SCHED_NB * SCHED_SPAN rows
    centers = _sched_ids(rng, SCHED_PC, shared)
    ctxs = _sched_ids(rng, SCHED_PC * CW, shared).reshape(SCHED_NB * SCHED_PC, CW)
    ctxs[rng.random(ctxs.shape) < 0.3] = -1
    ctxs[6] = -1
    pool = _sched_ids(rng, SCHED_PN, shared, pool=True)
    y = SCHED_SPAN - 1
    centers[0, 1] = centers[0, SCHED_TILE + 1] = y
    ctxs[SCHED_PC - 1, 2] = pool[0, 0] = y - 1
    return (in_t, out_t, centers.reshape(-1).astype(np.int32), ctxs.astype(np.int32),
            pool.reshape(-1).astype(np.int32))


def _sched_case(kind, shared=False, seed=0):
    """(tables as numpy, ids as numpy, lr, emulate(tables, ids, lr, k, ...),
    plain(tables, ids, lr)) for one step of ``kind``."""
    if kind == "flat":
        in_t, out_t, *ids = _sched_flat(seed, shared)
        lr = 0.05 * SCHED_P * SCHED_NB

        def emulate(tabs, tids, lr, k, fault=None, lockstep=False):
            return emulate_flat(*tabs, *tids, lr, LAM, SCHED_P, SCHED_PN, k, SCHED_TILE,
                                fault, lockstep)

        def plain(tabs, tids, lr):
            return fused_sgns.fused_sgns_step_plain(*tabs, *tids, lr, LAM, SCHED_P, SCHED_PN)
    else:
        in_t, out_t, *ids = _sched_grouped(seed, shared)
        lr = 0.05 * SCHED_PC * SCHED_NB * (W + 1)

        def emulate(tabs, tids, lr, k, fault=None, lockstep=False):
            return emulate_grouped(*tabs, *tids, lr, LAM, W, SCHED_PC, SCHED_PN, k,
                                   SCHED_TILE, fault, lockstep)

        def plain(tabs, tids, lr):
            return fused_sgns.fused_sgns_grouped_step_plain(*tabs, *tids, lr, LAM, W,
                                                            SCHED_PC, SCHED_PN)
    return [in_t, out_t], ids, lr, emulate, plain


def _sched_run(kind, k, fault=None, seed=0):
    """(before, emulated, plain, jax) for one step: tables as numpy, losses."""
    before, ids, lr, emulate, plain = _sched_case(kind, seed=seed)
    tids = [torch.from_numpy(a) for a in ids]
    tabs = lambda: [torch.from_numpy(t.copy()) for t in before]  # noqa: E731
    got, want = emulate(tabs(), tids, lr, k, fault), plain(tabs(), tids, lr)
    jtabs = [jnp.asarray(t) for t in before]
    jids = [jnp.asarray(a) for a in ids]
    if kind == "flat":
        jgot = jax_fused.fused_sgns_step(*jtabs, *jids, lr=lr, lam=LAM,
                                         pairs_per_block=SCHED_P, pool_size=SCHED_PN,
                                         interpret=True)
    else:
        jgot = jax_fused.fused_sgns_grouped_step(*jtabs, *jids, lr=lr, lam=LAM, window=W,
                                                 centers_per_block=SCHED_PC,
                                                 pool_size=SCHED_PN, interpret=True)
    as_np = lambda r: ([t.numpy() for t in r[:2]], float(r[2]))  # noqa: E731
    jax_np = ([np.asarray(x) for x in jgot[:2]], float(jgot[2]))
    return before, as_np(got), as_np(want), jax_np


def _assert_schedule_equal(before, got, want):
    for name, start, g, w in zip(("in_table", "out_table"), before, got[0], want[0]):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6, err_msg=name)
        assert float(np.abs(w - start).max()) > 100 * 1e-6, name  # the step moved rows
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5)


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("kind", ["flat", "grouped"])
def test_cluster_schedule_matches_plain_and_jax(kind, k):
    """K CTAs a kernel block, 7 (flat) or 5 (grouped) tiles of 2: a round
    that K does not fill, duplicates within a block, a row read by one CTA
    and last written by another in the same round, a context row that is
    also a pool row."""
    before, got, want, jax_want = _sched_run(kind, k)
    _assert_schedule_equal(before, got, want)
    _assert_schedule_equal(before, got, jax_want)


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("fault", ["no_barrier", "context_over_pool"])
@pytest.mark.parametrize("kind", ["flat", "grouped"])
def test_cluster_schedule_planted_faults_fail(kind, fault, k):
    before, got, want, _ = _sched_run(kind, k, fault)
    with pytest.raises(AssertionError):
        _assert_schedule_equal(before, got, want)


def _blocks_alone(kind):
    """Both blocks in lockstep, one round each (K = 8), on center and
    context rows they share (their pools apart), against the start tables
    plus each block's own step, the plain version run on that block alone
    from the start tables: (before, emulated, summed)."""
    before, ids, lr, emulate, plain = _sched_case(kind, shared=True)
    tabs = lambda: [torch.from_numpy(t.copy()) for t in before]  # noqa: E731
    per = (SCHED_P if kind == "flat" else SCHED_PC)
    summed = [torch.from_numpy(t.copy()) for t in before]
    loss = 0.0
    for b in range(SCHED_NB):
        mine = [a.reshape(SCHED_NB, -1, *a.shape[1:])[b].copy() for a in ids]
        if kind == "grouped":
            mine[1] = mine[1].reshape(per, CW)
        # a block alone is a batch of 1 / SCHED_NB of the pairs: the same step
        # at lr / SCHED_NB
        got = plain(tabs(), [torch.from_numpy(a) for a in mine], lr / SCHED_NB)
        for acc, start, new in zip(summed, before, got[:2]):
            acc += new - torch.from_numpy(start)
        loss += float(got[2]) / SCHED_NB
    tids = [torch.from_numpy(a) for a in ids]
    return before, tabs, tids, lr, emulate, ([t.numpy() for t in summed], loss)


@pytest.mark.parametrize("kind", ["flat", "grouped"])
def test_cluster_schedule_keeps_every_blocks_step_of_a_shared_row(kind):
    """Blocks that share center and context rows and read them all before
    any writes them, as concurrent clusters do: each row ends as the start
    less every block's step, since such a write applies its step to the row
    as it stands. A write of the snapshot less the step (the planted fault)
    keeps one block's."""
    before, tabs, tids, lr, emulate, summed = _blocks_alone(kind)
    got = emulate(tabs(), tids, lr, 8, lockstep=True)
    _assert_schedule_equal(before, ([t.numpy() for t in got[:2]], float(got[2])), summed)
    stale = emulate(tabs(), tids, lr, 8, fault="stale_write", lockstep=True)
    with pytest.raises(AssertionError):
        _assert_schedule_equal(before, ([t.numpy() for t in stale[:2]], float(stale[2])),
                               summed)
