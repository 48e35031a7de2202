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
