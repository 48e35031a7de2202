"""The port's word2vec packed+pool slice against the JAX package's, on the CPU.

Both trainers get the same config, corpus and vocab; the JAX trainer's
initial tables are carried into the port with ``convert.py``, and the
negative pools are made with numpy and injected into both, since
``torch.Generator`` cannot reproduce JAX's threefry bits. Losses and tables
agree within rtol 1e-5 / atol 1e-6: the two frameworks reduce in another
order in the score products (einsum / bmm), in ``log_sigmoid`` and its
mean, and in the duplicate-row merge.

The substep comparisons start both packages from the same random non-zero
tables and take a per-pair step of 0.05 (``LR`` over the batch), so both
tables move by far more than that tolerance; each table's change is then
held to JAX's at ``DELTA_RTOL`` of the change's own scale.
``test_substep_comparison_catches_planted_faults`` shows that a wrong
gradient push fails the comparison.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from swiftsnails_tpu.data.vocab import Vocab as JaxVocab
from swiftsnails_tpu.models import word2vec as jax_w2v
from swiftsnails_tpu.utils.config import Config as JaxConfig
from swiftsnails_tpu_torch import convert
from swiftsnails_tpu_torch.data.vocab import Vocab
from swiftsnails_tpu_torch.framework.trainer import TrainLoop
from swiftsnails_tpu_torch.models import word2vec
from swiftsnails_tpu_torch.ops import rowdma
from swiftsnails_tpu_torch.resilience.resume import resume_mode
from swiftsnails_tpu_torch.utils.config import Config
from swiftsnails_tpu_torch.utils.metrics import MetricsLogger

RTOL, ATOL = 1e-5, 1e-6
# A table's change (after - before) agrees with JAX's elementwise within
# DELTA_RTOL times the largest change in that table.
DELTA_RTOL = 1e-4
# One intra-op thread: the shapes are small, and the suite's workers share
# the cores with the JAX mesh tests, which abort under CPU contention.
torch.set_num_threads(1)
VOCAB = 96
BATCH = 128
LR = 0.05 * BATCH  # the loss is a mean over the batch: 0.05 per pair
TABLE_SCALE = 0.1  # std of the random starting tables


def _conf(**over):
    conf = {"dim": "200", "window": "3", "negatives": "4",
            "learning_rate": "0.1", "batch_size": "128", "subsample": "0",
            "num_iters": "1", "pool_size": "8", "pool_block": "32",
            "use_native": "0", "seed": "5"}
    conf.update({k: str(v) for k, v in over.items()})
    return conf


def _corpus(n=2000, seed=0):
    rng = np.random.default_rng(seed)
    counts = np.maximum(rng.zipf(1.2, VOCAB), 1).astype(np.int64)
    words = [f"w{i}" for i in range(VOCAB)]
    p = counts / counts.sum()
    ids = rng.choice(VOCAB, size=n, p=p).astype(np.int32)
    return words, counts, ids


def _trainers(n=2000, **over):
    words, counts, ids = _corpus(n)
    conf = _conf(**over)
    jt = jax_w2v.Word2VecTrainer(JaxConfig(conf), mesh=None, corpus_ids=ids,
                                 vocab=JaxVocab(words, counts))
    tt = word2vec.Word2VecTrainer(Config(conf), corpus_ids=ids,
                                  vocab=Vocab(words, counts), device="cpu")
    return jt, tt


def _carry(jstate):
    return convert.w2v_state_from_numpy(np.asarray(jstate.in_table.table),
                                        np.asarray(jstate.out_table.table),
                                        device="cpu")


def _assert_tables_close(tstate, jstate):
    for name in ("in_table", "out_table"):
        np.testing.assert_allclose(
            getattr(tstate, name).table.numpy(),
            np.asarray(getattr(jstate, name).table), rtol=RTOL, atol=ATOL,
            err_msg=name)


def _random_start(jt, jstate, seed=21):
    """The JAX state and the port's, both holding the same random tables
    (``TABLE_SCALE`` on the ``dim`` lanes, zero padding lanes)."""
    rng = np.random.default_rng(seed)
    shape = jstate.in_table.table.shape
    lanes = np.arange(shape[1] * shape[2]).reshape(shape[1:]) < jt.dim
    tables = [(rng.normal(0.0, TABLE_SCALE, shape) * lanes).astype(np.float32)
              for _ in range(2)]
    jstate = jax_w2v.W2VState(
        jstate.in_table._replace(table=jnp.asarray(tables[0])),
        jstate.out_table._replace(table=jnp.asarray(tables[1])))
    return jstate, convert.w2v_state_from_numpy(*tables, device="cpu"), tables


def _assert_moves_match(before, tstate, jstate):
    """Each table's change agrees with JAX's within ``DELTA_RTOL`` of the
    change's scale, and that change is far above the table tolerance."""
    for name, start in zip(("in_table", "out_table"), before):
        want = np.asarray(getattr(jstate, name).table) - start
        got = getattr(tstate, name).table.numpy() - start
        scale = float(np.abs(want).max())
        assert scale > 100 * ATOL, (name, scale)
        np.testing.assert_allclose(got, want, rtol=0, atol=DELTA_RTOL * scale,
                                   err_msg=name)


def _four_substeps(hash_keys, check_loss=True):
    """4 substeps with injected pools through both packages, from the same
    random tables; asserts after each that the losses agree."""
    jt, tt = _trainers(hash_keys=hash_keys, learning_rate=LR)
    jstate, tstate, before = _random_start(jt, jt.init_state())
    _assert_tables_close(tstate, jstate)
    batches = list(tt.batches())[:4]
    assert len(batches) == 4
    pools = _pools(tt, BATCH, 4)
    gen = torch.Generator()  # unused: the pools are injected
    for i, (batch, pool) in enumerate(zip(batches, pools)):
        jstate, jloss, _ = jt._substep_packed(
            jstate, jnp.asarray(batch["centers"]), jnp.asarray(batch["contexts"]),
            jax.random.PRNGKey(i), jt.lr, negs=jnp.asarray(pool))
        tstate, tloss = tt._substep_packed(
            tstate, torch.from_numpy(batch["centers"]),
            torch.from_numpy(batch["contexts"]), gen, tt.lr,
            negs=torch.from_numpy(pool))
        if check_loss:
            np.testing.assert_allclose(float(tloss), float(jloss),
                                       rtol=RTOL, atol=ATOL)
    return tt, before, tstate, jstate


@pytest.mark.parametrize("subsample", [0, 1e-4])
@pytest.mark.parametrize("steps_per_call", [1, 2])
def test_batches_identical(subsample, steps_per_call):
    jt, tt = _trainers(n=20000, subsample=subsample,
                       steps_per_call=steps_per_call, num_iters=2,
                       chunk_tokens=7000)
    want, got = list(jt.batches()), list(tt.batches())
    assert len(got) == len(want) > 2
    for g, w in zip(got, want):
        assert g.keys() == w.keys() == {"centers", "contexts", "progress"}
        for k in g:
            assert np.asarray(g[k]).dtype == np.asarray(w[k]).dtype, k
            np.testing.assert_array_equal(g[k], w[k])


def _pools(tt, b, n, seed=11):
    _, nb = tt.pool_geometry(b)
    rng = np.random.default_rng(seed)
    return [rng.integers(0, VOCAB, (nb, tt.pool_size)).astype(np.int32)
            for _ in range(n)]


@pytest.mark.parametrize("hash_keys", [0, 1])
def test_four_substeps_match_jax(hash_keys):
    tt, before, tstate, jstate = _four_substeps(hash_keys)
    _assert_tables_close(tstate, jstate)
    _assert_moves_match(before, tstate, jstate)
    dim = tt.dim
    for tbl in tstate:
        assert not tbl.table.reshape(tbl.capacity, -1)[:, dim:].any()


@pytest.mark.parametrize("fault", ["drop_in", "negate_in", "double_in",
                                   "drop_out"])
def test_substep_comparison_catches_planted_faults(monkeypatch, fault):
    """The table comparison above fails on its own, without the loss check,
    when the port pushes a wrong gradient: one table's push dropped, negated
    or doubled."""
    push = word2vec.push_packed
    which, scale = {"drop_in": ("in", 0.0), "negate_in": ("in", -1.0),
                    "double_in": ("in", 2.0), "drop_out": ("out", 0.0)}[fault]

    def faulty(state, rows, grads, access, lr):
        hit = (rows.shape[0] == BATCH) == (which == "in")
        return push(state, rows, grads * scale if hit else grads, access, lr)

    monkeypatch.setattr(word2vec, "push_packed", faulty)
    _, before, tstate, jstate = _four_substeps(0, check_loss=False)
    with pytest.raises(AssertionError):
        _assert_moves_match(before, tstate, jstate)


def test_train_step_two_substeps_with_lr_decay_matches_jax(monkeypatch):
    """``steps_per_call: 2``, ``lr_decay: 1``: one call runs two substeps on
    the two halves of the batch at the decayed rate. Both packages draw
    their pools through their module's ``alias_sample``; the test replaces
    it in both with one that returns the injected pools, keyed in JAX by
    the substep's random key (the scan traces the substep once)."""
    jt, tt = _trainers(steps_per_call=2, lr_decay=1, num_iters=3,
                       learning_rate=LR)
    batches = list(tt.batches())
    batch = batches[len(batches) // 2]
    assert batch["centers"].shape == (2 * BATCH,) and 0.2 < batch["progress"] < 0.8
    pools = _pools(tt, BATCH, 2, seed=12)
    rng = jax.random.PRNGKey(3)
    keys = jax.random.split(rng, 2)

    def jax_pools(table, key, shape):
        first = jnp.all(jax.random.key_data(key) == jax.random.key_data(keys[0]))
        return jnp.where(first, jnp.asarray(pools[0]), jnp.asarray(pools[1]))

    queue = [torch.from_numpy(p) for p in pools]
    monkeypatch.setattr(jax_w2v, "alias_sample", jax_pools)
    monkeypatch.setattr(word2vec, "alias_sample",
                        lambda table, gen, shape: queue.pop(0))

    jstate, tstate, before = _random_start(jt, jt.init_state())
    jstate, jm = jt.train_step(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()}, rng)
    tstate, tm = tt.train_step(
        tstate, {k: torch.from_numpy(v) if np.ndim(v) else v
                 for k, v in batch.items()}, torch.Generator())
    assert not queue
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=RTOL, atol=ATOL)
    _assert_tables_close(tstate, jstate)
    _assert_moves_match(before, tstate, jstate)
    assert tt.step_lr(batch) < tt.lr


@pytest.mark.parametrize("extra", [1, 127])
def test_train_step_refuses_a_batch_that_does_not_split_as_jax_does(extra):
    """``steps_per_call: 2`` at batch 128: a batch of 256 + ``extra`` items
    is 2 substeps of 128 and a tail. The JAX package's reshape to (2, 128)
    refuses it, and so does the port, instead of dropping the tail; the
    whole batch runs in both."""
    jt, tt = _trainers(steps_per_call=2, dim=16)
    batch = next(iter(tt.batches()))
    assert batch["centers"].shape == (2 * BATCH,)
    ragged = {k: np.concatenate([v, v[:extra]]) if np.ndim(v) else v
              for k, v in batch.items()}
    for b, want_ok in ((ragged, False), (batch, True)):
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        tb = {k: torch.from_numpy(v) if np.ndim(v) else v for k, v in b.items()}
        if want_ok:
            _, jm = jt.train_step(jt.init_state(), jb, jax.random.PRNGKey(0))
            _, tm = tt.train_step(tt.init_state(), tb, torch.Generator())
            assert np.isfinite(float(jm["loss"])) and np.isfinite(float(tm["loss"]))
            continue
        with pytest.raises(TypeError, match="cannot reshape"):
            jt.train_step(jt.init_state(), jb, jax.random.PRNGKey(0))
        with pytest.raises(ValueError, match="does not split into 2 substeps"):
            tt.train_step(tt.init_state(), tb, torch.Generator())


@pytest.mark.parametrize("hash_keys", [0, 1])
def test_export_text_matches_jax(tmp_path, hash_keys):
    jt, tt = _trainers(dim=16, hash_keys=hash_keys)
    jstate = jt.init_state()
    tstate = _carry(jstate)
    jt.export_text(jstate, str(tmp_path / "jax.txt"))
    tt.export_text(tstate, str(tmp_path / "torch.txt"))

    def parse(path):
        lines = path.read_text().strip().split("\n")
        words = [ln.split(" ", 1)[0] for ln in lines[1:]]
        vals = np.array([[float(x) for x in ln.split()[1:]] for ln in lines[1:]])
        return lines[0], words, vals

    jh, jw, jv = parse(tmp_path / "jax.txt")
    th, tw, tv = parse(tmp_path / "torch.txt")
    assert th == jh == f"{VOCAB} 16" and tw == jw
    assert tv.shape == (VOCAB, 16)
    np.testing.assert_array_equal(tv, jv)
    assert [w for w, _ in tt.neighbors(tstate, "w0", topn=3)] == \
        [w for w, _ in jt.neighbors(jstate, "w0", topn=3)]


@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16"])
def test_init_state_invariants(table_dtype):
    _, tt = _trainers(table_dtype=table_dtype)
    st = tt.init_state()
    dim = tt.dim
    inp = st.in_table.table.reshape(tt.capacity, -1).float()
    assert st.in_table.table.shape == (tt.capacity, 2, 128)
    assert st.in_table.table.dtype == getattr(torch, table_dtype)
    assert float(inp[:, :dim].abs().max()) <= 0.5 / dim * (1 + 2**-7)
    assert float(inp[:, :dim].abs().mean()) > 0.2 / dim  # U(-0.5, 0.5)/dim: 0.25/dim
    assert not inp[:, dim:].any()
    assert not st.out_table.table.any()


def test_packed_pool_loss_decreases():
    """Twin of ``tests/test_rowdma.py::test_word2vec_packed_pool_loss_decreases``,
    driven through the port's TrainLoop."""
    rng = np.random.default_rng(0)
    vocab_size = 50
    counts = np.maximum(rng.integers(1, 50, vocab_size), 1).astype(np.int64)
    vocab = Vocab([f"w{i}" for i in range(vocab_size)], counts)
    base = np.repeat(np.arange(10), 40) % vocab_size
    corpus = ((base + rng.integers(0, 2, base.size)) % vocab_size).astype(np.int32)
    cfg = Config({
        "dim": "16", "window": "2", "negatives": "3", "learning_rate": "0.1",
        "batch_size": "64", "subsample": "0", "num_iters": "30",
        "pool_size": "8", "pool_block": "32", "steps_per_call": "2",
        "packed": "1", "use_native": "0",
    })
    tr = word2vec.Word2VecTrainer(cfg, corpus_ids=corpus, vocab=vocab,
                                  device="cpu")
    records = []

    class Recorder(MetricsLogger):
        def log(self, record):
            records.append(record)

    TrainLoop(tr, metrics=Recorder(), log_every=1).run(max_steps=40)
    losses = [r["loss"] for r in records]
    assert len(losses) >= 10
    assert np.mean(losses[-5:]) < np.mean(losses[:5]), losses


# (key, value, other keys of the case). Every key here is ported since this
# test was written (``placement`` and ``optimizer_sharding`` the last): for
# each case the test holds that the trainer takes the keys (see
# ``_PORTED``).
_UNPORTED_CASES = [
    ("packed", 0, {}), ("neg_mode", "per_pair", {}),
    ("fused", 1, {"grouped": 1, "resident": 1, "comm_dtype": "int8"}),
    ("grouped", 1, {"fused": 1, "dedup": 1, "comm_dtype": "bfloat16"}),
    ("resident", 1, {"fused": 1, "grouped": 1, "placement": "hybrid"}),
    ("dedup", 1, {"fused": 1, "grouped": 1, "placement": "hybrid"}),
    ("table_tier", "host", {}),
    ("comm_dtype", "bfloat16", {}), ("placement", "hybrid", {}),
    ("overlap", 1, {"fused": 1, "grouped": 1}),
    ("push_mode", "bucketed", {}), ("stream", 1, {}),
    ("optimizer_sharding", "zero", {}),
]


# key -> "the trainer took it"
_PORTED = {
    "packed": lambda tr: not tr.packed and tr.neg_mode == "per_pair",
    "neg_mode": lambda tr: tr.packed and tr.neg_mode == "per_pair",
    "stream": lambda tr: tr.stream,
    "table_tier": lambda tr: tr.tiered and tr.tier_spec() is not None,
    "overlap": lambda tr: tr.overlap == 1 and tr.grouped,
    "push_mode": lambda tr: tr.push_mode == "bucketed",
    # comm_dtype is ported: these cases' trainers take it with the rest
    "comm_dtype": lambda tr: tr.comm_dtype == "bfloat16",
    # placement and optimizer_sharding are ported: on one device the first
    # resolves to uniform with its reason, the second changes nothing
    "placement": lambda tr: tr.placement_cut == 0 and tr.placement_decision["mode"] == "uniform",
    "optimizer_sharding": lambda tr: tr.optimizer_sharding == "zero" and not tr.zero,
    "resident": lambda tr: tr.resident and tr.placement_decision["reason"] == "no mesh",
    "dedup": lambda tr: tr.dedup and tr.placement_decision["reason"] == "no mesh",
    "fused": lambda tr: tr.fused and tr.resident and tr.comm_dtype == "int8",
    "grouped": lambda tr: tr.grouped and tr.dedup and tr.comm_dtype == "bfloat16",
}


@pytest.mark.parametrize("key,value,extra", _UNPORTED_CASES,
                         ids=[f"{k}-{v}" for k, v, _ in _UNPORTED_CASES])
def test_unported_trainer_keys_raise(key, value, extra):
    words, counts, ids = _corpus(200)
    if key in _PORTED:
        tr = word2vec.Word2VecTrainer(Config(_conf(**{key: value}, **extra)),
                                      corpus_ids=ids, vocab=Vocab(words, counts),
                                      device="cpu")
        assert _PORTED[key](tr)
        return
    with pytest.raises(NotImplementedError, match="|".join([key, *extra])):
        word2vec.Word2VecTrainer(Config(_conf(**{key: value}, **extra)),
                                 corpus_ids=ids, vocab=Vocab(words, counts),
                                 device="cpu")


@pytest.mark.parametrize("key,value", [
    ("param_backup_period", 10), ("resume", "auto"), ("guardrail", 1),
    ("chaos_spec", "nan_grad@5"), ("cluster_workers", 2),
    ("freshness_publish", 1), ("telemetry", 1), ("trace_path", "t.json"),
])
def test_unported_loop_keys_raise(key, value):
    """The loop keys the port lacked when this test was written. The first
    four came with the port's checkpoints and resilience layer, ``telemetry``
    and ``trace_path`` with its telemetry, ``freshness_publish`` with its
    freshness pipeline: for them the test holds that the loop now takes the
    key and arms its feature (``tests/test_torch_resilience.py``,
    ``tests/test_torch_checkpoint.py``, ``tests/test_torch_telemetry_loop.py``
    and ``tests/test_torch_freshness.py`` hold the features;
    ``freshness_publish`` without ``freshness_dir`` publishes nothing, as in
    the JAX loop; ``cluster_workers`` with the cluster plane: the loop
    self-hosts a worker client, ``tests/test_torch_cluster_worker.py``
    holds it); every other key still raises."""
    words, counts, ids = _corpus(200)
    tr = word2vec.Word2VecTrainer(Config(_conf(**{key: value})), corpus_ids=ids,
                                  vocab=Vocab(words, counts), device="cpu")
    armed = {
        "param_backup_period": lambda loop: loop.backup_period == 10,
        "resume": lambda loop: resume_mode(loop.trainer.config) == "auto",
        "guardrail": lambda loop: loop.guardrail is not None,
        "chaos_spec": lambda loop: loop.chaos.pending() == [("nan_grad", 5)],
        "telemetry": lambda loop: loop.tracer is not None and loop.tracer.path is None,
        "trace_path": lambda loop: loop.tracer is not None and loop.tracer.path == "t.json",
        "freshness_publish": lambda loop: loop.freshness is None,
        "cluster_workers": lambda loop: loop.cluster is not None,
    }
    if key in armed:
        assert armed[key](TrainLoop(tr))
        return
    with pytest.raises(NotImplementedError, match=key):
        TrainLoop(tr)


def test_mesh_raises():
    """A mesh trains the flat paths (``tests/test_torch_word2vec_mesh.py``)
    and the grouped family (``tests/test_torch_grouped_mesh.py``); the tier
    under a mesh is ported since this test was written (the trainer takes
    it; ``tests/test_torch_tier_mesh.py`` trains it), and a mesh must be a
    ``parallel.mesh.Mesh``."""
    from swiftsnails_tpu_torch.parallel.mesh import Mesh

    words, counts, ids = _corpus(200)
    mesh = Mesh(shape={"data": 1, "model": 1}, coords={"data": 0, "model": 0},
                groups={}, device=torch.device("cpu"))
    tr = word2vec.Word2VecTrainer(Config(_conf(fused="1", grouped="1")), mesh=mesh,
                                  corpus_ids=ids, vocab=Vocab(words, counts), device="cpu")
    assert tr.grouped and tr.mesh is mesh
    tiered = word2vec.Word2VecTrainer(Config(_conf(table_tier="host")), mesh=mesh,
                                      corpus_ids=ids, vocab=Vocab(words, counts), device="cpu")
    assert tiered.tiered and tiered.mesh is mesh
    with pytest.raises(TypeError, match="mesh"):
        word2vec.Word2VecTrainer(Config(_conf()), mesh=object(), corpus_ids=ids,
                                 vocab=Vocab(words, counts), device="cpu")


def test_cpu_run_launches_no_kernel():
    _, tt = _trainers()
    before = (rowdma.gather_rows.launches, rowdma.scatter_add_rows.launches)
    TrainLoop(tt, log_every=0).run(max_steps=2)
    assert (rowdma.gather_rows.launches, rowdma.scatter_add_rows.launches) == before


def test_train_loop_device_follows_the_trainer():
    _, tt = _trainers()
    assert TrainLoop(tt, device="cpu").device == torch.device("cpu")
    with pytest.raises((RuntimeError, ValueError)):  # no card, or not the trainer's
        TrainLoop(tt, device="cuda")
