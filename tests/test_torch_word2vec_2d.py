"""The port's ``packed: 0`` (``_substep_dense``) and ``neg_mode: per_pair``
(``_substep_packed_perpair``) word2vec substeps against the JAX package's, on the CPU.

Both trainers get the same config, corpus and vocab, the same random
starting tables and the same per-pair negatives (``[b, K]`` word ids made
with numpy and injected into both, since ``torch.Generator`` cannot
reproduce JAX's threefry bits). After each of 3 substeps the losses agree
within rtol 1e-5 and each table's change from the start within
``DELTA_RTOL`` of its largest change (the frameworks sum the products and
the duplicate rows in another order). The plain ``train_step`` dispatch and
``neg_mode``'s default and errors follow the JAX trainer.
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
from swiftsnails_tpu_torch.utils.config import Config

LOSS_RTOL = 1e-5
DELTA_RTOL = 1e-4
VOCAB, BATCH, K = 80, 96, 3
LR = 0.05 * BATCH  # the loss is a mean over the batch: 0.05 per pair
torch.set_num_threads(1)

# path -> (config keys, substep method)
PATHS = {
    "dense": ({"packed": 0, "dim": 24}, "_substep_dense"),
    "dense_dim40": ({"packed": 0, "dim": 40, "hash_keys": 1, "capacity": 64},
                    "_substep_dense"),
    "packed_perpair": ({"neg_mode": "per_pair", "dim": 16}, "_substep_packed_perpair"),
    "packed_perpair_dim40": ({"neg_mode": "per_pair", "dim": 40, "hash_keys": 1,
                              "capacity": 64}, "_substep_packed_perpair"),
}


def _conf(**over):
    conf = {"window": "2", "negatives": str(K), "learning_rate": str(LR),
            "batch_size": str(BATCH), "subsample": "0", "num_iters": "1", "seed": "3"}
    conf.update({k: str(v) for k, v in over.items()})
    return conf


def _corpus(n=1500, seed=0):
    rng = np.random.default_rng(seed)
    counts = np.maximum(rng.zipf(1.2, VOCAB), 1).astype(np.int64)
    ids = rng.choice(VOCAB, size=n, p=counts / counts.sum()).astype(np.int32)
    return [f"w{i}" for i in range(VOCAB)], counts, ids


def _trainers(**over):
    words, counts, ids = _corpus()
    conf = _conf(**over)
    jt = jax_w2v.Word2VecTrainer(JaxConfig(conf), mesh=None, corpus_ids=ids,
                                 vocab=JaxVocab(words, counts))
    tt = word2vec.Word2VecTrainer(Config(conf), corpus_ids=ids, vocab=Vocab(words, counts),
                                  device="cpu")
    return jt, tt


def _random_start(jt, seed=21):
    """The same random tables for both packages (zero padding lanes on the
    packed plane)."""
    jstate = jt.init_state()
    shape = jstate.in_table.table.shape
    rng = np.random.default_rng(seed)
    tables = [rng.normal(0.0, 0.1, shape).astype(np.float32) for _ in range(2)]
    if len(shape) == 3:
        lanes = np.arange(shape[1] * shape[2]).reshape(shape[1:]) < jt.dim
        tables = [t * lanes for t in tables]
    jstate = jax_w2v.W2VState(jstate.in_table._replace(table=jnp.asarray(tables[0])),
                              jstate.out_table._replace(table=jnp.asarray(tables[1])))
    return jstate, convert.w2v_state_from_numpy(*tables, device="cpu"), tables


@pytest.mark.parametrize("path", list(PATHS))
def test_three_substeps_match_jax(path):
    over, method = PATHS[path]
    jt, tt = _trainers(**over)
    jstate, tstate, before = _random_start(jt)
    batches = list(tt.batches())[:3]
    assert len(batches) == 3
    rng = np.random.default_rng(5)
    gen = torch.Generator()  # unused: the negatives are injected
    for i, batch in enumerate(batches):
        negs = rng.integers(0, VOCAB, (BATCH, K)).astype(np.int32)
        jstate, jloss, _ = getattr(jt, method)(
            jstate, jnp.asarray(batch["centers"]), jnp.asarray(batch["contexts"]),
            jax.random.PRNGKey(i), jt.lr, negs=jnp.asarray(negs))
        tstate, tloss = getattr(tt, method)(
            tstate, torch.from_numpy(batch["centers"]), torch.from_numpy(batch["contexts"]),
            gen, tt.lr, negs=torch.from_numpy(negs))
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOSS_RTOL)
    for name, start in zip(("in_table", "out_table"), before):
        want = np.asarray(getattr(jstate, name).table) - start
        got = getattr(tstate, name).table.numpy() - start
        scale = float(np.abs(want).max())
        assert scale > 1e-3, (name, scale)
        np.testing.assert_allclose(got, want, rtol=0, atol=DELTA_RTOL * scale, err_msg=name)


@pytest.mark.parametrize("fault", ["drop_out_push", "negate_negatives"])
def test_substep_comparison_catches_planted_faults(monkeypatch, fault):
    """A dropped push or negatives pushed with the wrong sign fail the
    comparison of ``test_three_substeps_match_jax``."""
    if fault == "drop_out_push":
        real = word2vec.push

        def faulty(state, rows, grads, *a, **k):
            return state if grads.shape[0] > BATCH else real(state, rows, grads, *a, **k)

        monkeypatch.setattr(word2vec, "push", faulty)
    else:
        real_loss = word2vec.sgns_loss
        monkeypatch.setattr(word2vec, "sgns_loss",
                            lambda v, u_pos, u_neg: real_loss(v, u_pos, -u_neg))
    with pytest.raises(AssertionError):
        test_three_substeps_match_jax("dense")


def test_neg_mode_defaults_and_errors():
    _, tt = _trainers(packed=0)
    assert (tt.packed, tt.neg_mode) == (False, "per_pair")
    _, tt = _trainers()
    assert (tt.packed, tt.neg_mode) == (True, "pool")
    words, counts, ids = _corpus(200)
    for pkg, cfg_cls, vocab_cls, kw in (
            (word2vec, Config, Vocab, {"device": "cpu"}),
            (jax_w2v, JaxConfig, JaxVocab, {"mesh": None})):
        with pytest.raises(ValueError, match="pool requires packed"):
            pkg.Word2VecTrainer(cfg_cls(_conf(packed=0, neg_mode="pool")), corpus_ids=ids,
                                vocab=vocab_cls(words, counts), **kw)
    # fused takes effect only on packed+pool tables, as in the JAX trainer
    _, tt = _trainers(neg_mode="per_pair", fused=1)
    assert not tt.fused


@pytest.mark.parametrize("path", ["dense", "packed_perpair"])
def test_train_step_dispatch_and_lr_decay_match_jax(path):
    """``train_step`` (two substeps a call, ``lr_decay`` on) picks the
    path's substep, as the JAX ``train_step`` does: with the negatives of
    each substep drawn by the substep, both packages are fed the same ones
    through the substep method they dispatch to."""
    over, method = PATHS[path]
    jt, tt = _trainers(**over, steps_per_call=2, lr_decay=1)
    jstate, tstate, _ = _random_start(jt)
    batch = list(tt.batches())[1]  # the first has progress 0
    assert batch["centers"].shape[0] == 2 * BATCH and batch["progress"] > 0
    negs = [np.random.default_rng(i).integers(0, VOCAB, (BATCH, K)).astype(np.int32)
            for i in range(2)]
    calls = []
    real = getattr(tt, method)

    def fed(state, c, x, gen, lr, negs_=None):
        calls.append(lr)
        return real(state, c, x, gen, lr, negs=torch.from_numpy(negs[len(calls) - 1]))

    tt.__dict__[method] = fed
    tstate, metrics = tt.train_step(tstate, {k: torch.from_numpy(v) if np.ndim(v) else v
                                             for k, v in batch.items()}, torch.Generator())
    assert len(calls) == 2 and calls[0] == tt.step_lr(batch) < tt.lr
    lr = jt.lr * max(1.0 - float(batch["progress"]), 1e-4)
    jl = []
    for i in range(2):
        sl = slice(i * BATCH, (i + 1) * BATCH)
        jstate, loss, _ = getattr(jt, method)(
            jstate, jnp.asarray(batch["centers"][sl]), jnp.asarray(batch["contexts"][sl]),
            jax.random.PRNGKey(0), jnp.float32(lr), negs=jnp.asarray(negs[i]))
        jl.append(float(loss))
    np.testing.assert_allclose(float(metrics["loss"]), np.mean(jl), rtol=LOSS_RTOL)
    np.testing.assert_allclose(tstate.in_table.table.numpy(),
                               np.asarray(jstate.in_table.table), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("path", ["dense", "packed_perpair"])
def test_train_loop_runs_and_loss_falls(path):
    over, _ = PATHS[path]
    _, tt = _trainers(**over, learning_rate=2.0, num_iters=4)
    records = []

    class Rec:
        def count(self, n):
            pass

        def flush_window(self, **kw):
            records.append(kw)

    before = [rowdma.gather_rows.launches, rowdma.scatter_add_rows.launches]
    state = TrainLoop(tt, metrics=Rec(), log_every=1).run(seed=1)
    assert [rowdma.gather_rows.launches, rowdma.scatter_add_rows.launches] == before
    losses = [r["loss"] for r in records]
    assert records[0]["producer"] == "native" and "producer" not in records[1]
    assert len(losses) >= 20 and np.mean(losses[-5:]) < np.mean(losses[:5])
    assert torch.isfinite(state.in_table.table).all()
    if not tt.packed:
        assert isinstance(state.in_table, word2vec.TableState)
        assert state.in_table.table.shape == (tt.capacity, tt.dim)


@pytest.mark.parametrize("hash_keys", [0, 1])
def test_export_text_matches_jax(tmp_path, hash_keys):
    jt, tt = _trainers(packed=0, dim=8, hash_keys=hash_keys, capacity=128)
    jstate, tstate, _ = _random_start(jt)
    jt.export_text(jstate, str(tmp_path / "j.txt"))
    tt.export_text(tstate, str(tmp_path / "t.txt"))
    assert (tmp_path / "t.txt").read_text() == (tmp_path / "j.txt").read_text()
    assert tt.table_geometry() == jt.table_geometry()
