"""Checkpoints of 2-D table states against the JAX package's, on the CPU.

A word2vec state at ``packed: 0`` (two ``[C, dim]`` tables) and a Wide &
Deep state at ``packed: 0`` (a ``[C, dim]`` table with its AdaGrad
``accum`` slot, the dense dict and its optax accumulators): the same
canonical keys, shapes, dtypes and CRCs in both packages' manifests (the CTR
optimizer keys through ``convert.port_checkpoint_key``); a JAX checkpoint
carried into the port restores bit-equal; a port run saved, restored and
exported equals the run it saved; and each trainer's ``table_geometry`` is
the JAX trainer's. Exact throughout.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from swiftsnails_tpu.data.vocab import Vocab as JaxVocab
from swiftsnails_tpu.framework import checkpoint as jax_ckpt
from swiftsnails_tpu.models import word2vec as jax_w2v
from swiftsnails_tpu.models.registry import get_model as jax_get_model
from swiftsnails_tpu.utils.config import Config as JaxConfig
from swiftsnails_tpu_torch import convert
from swiftsnails_tpu_torch.data import ctr
from swiftsnails_tpu_torch.data.vocab import Vocab
from swiftsnails_tpu_torch.framework import checkpoint as ckpt
from swiftsnails_tpu_torch.framework.trainer import TrainLoop
from swiftsnails_tpu_torch.models import word2vec
from swiftsnails_tpu_torch.models.registry import get_model
from swiftsnails_tpu_torch.utils.config import Config
from swiftsnails_tpu_torch.utils.tree import tensor_items

torch.set_num_threads(1)


def _w2v_pair():
    rng = np.random.default_rng(0)
    counts = np.maximum(rng.zipf(1.3, 40), 1).astype(np.int64)
    ids = rng.choice(40, size=1500, p=counts / counts.sum()).astype(np.int32)
    words = [f"w{i}" for i in range(40)]
    conf = {"dim": "12", "window": "2", "negatives": "2", "learning_rate": "0.2",
            "batch_size": "64", "subsample": "0", "num_iters": "1", "seed": "3",
            "packed": "0", "prefetch_batches": "0"}
    return (jax_w2v.Word2VecTrainer(JaxConfig(conf), mesh=None, corpus_ids=ids,
                                    vocab=JaxVocab(words, counts)),
            word2vec.Word2VecTrainer(Config(conf), corpus_ids=ids,
                                     vocab=Vocab(words, counts), device="cpu"))


def _ctr_pair():
    conf = {"num_fields": "4", "capacity": "512", "learning_rate": "0.2",
            "optimizer": "adagrad", "batch_size": "128", "num_iters": "1", "seed": "0",
            "embed_dim": "4", "hidden_dims": "8", "packed": "0", "prefetch_batches": "0"}
    labels, feats, _ = ctr.synth_ctr(512, 4, 30, seed=2)
    return (jax_get_model("widedeep")(JaxConfig(conf), data=(labels, feats)),
            get_model("widedeep")(Config(conf), data=(labels, feats), device="cpu"))


def _trained_jax(model, steps=2):
    jt, tt = _w2v_pair() if model == "word2vec" else _ctr_pair()
    js = jt.init_state()
    step = jax.jit(jt.train_step)
    for i, batch in zip(range(steps), jt.batches()):
        js, _ = step(js, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(i))
    return jt, tt, js


def _carry(model, js):
    if model == "word2vec":
        return convert.w2v_state_from_numpy(np.asarray(js.in_table.table),
                                            np.asarray(js.out_table.table), device="cpu")
    return convert.ctr_state_from_numpy(
        np.asarray(js.table.table), {k: np.asarray(v) for k, v in js.dense.items()},
        {k: np.asarray(v) for k, v in js.opt[0].sum_of_squares.items()}, device="cpu",
        table_slots={k: np.asarray(v) for k, v in js.table.slots.items()})


def _records(manifest, key_map=lambda k: k):
    return {key_map(jax_ckpt.canonical_key(k)): (v["crc"], v["algo"], v["shape"], v["dtype"])
            for k, v in manifest["arrays"].items()}


@pytest.mark.parametrize("model", ["word2vec", "widedeep"])
def test_manifest_matches_jax(model):
    jt, tt, js = _trained_jax(model)
    ts = _carry(model, js)
    assert tt.table_geometry() == jt.table_geometry()
    jm = jax_ckpt.build_manifest(js, 2, cursor={"step": 2, "items": 128})
    tm = ckpt.build_manifest(ts, 2, cursor={"step": 2, "items": 128})
    assert _records(tm) == _records(jm, convert.port_checkpoint_key)
    keys = set(_records(tm))
    if model == "word2vec":
        assert keys == {"in_table/table", "out_table/table"}
        assert tm["arrays"]["in_table/table"]["shape"] == [tt.capacity, tt.dim]
    else:
        assert {"table/table", "table/slots/accum"} <= keys
    assert ckpt.verify_state(ts, dict(jm, arrays={
        convert.port_checkpoint_key(jax_ckpt.canonical_key(k)): v
        for k, v in jm["arrays"].items()})) == []


@pytest.mark.parametrize("model", ["word2vec", "widedeep"])
def test_jax_checkpoint_into_the_port(tmp_path, model):
    jt, tt, js = _trained_jax(model)
    jax_ckpt.save_checkpoint(str(tmp_path / "jax"), js, 4, cursor={"step": 4, "items": 256})
    restored = jax_ckpt.restore_checkpoint(str(tmp_path / "jax"), jt.init_state())
    root = str(tmp_path / "port")
    ckpt.save_checkpoint(root, _carry(model, restored), 4, cursor={"step": 4, "items": 256})
    got = ckpt.restore_checkpoint(root, tt.init_state())
    want = {convert.port_checkpoint_key(jax_ckpt.canonical_key(jax.tree_util.keystr(p))):
            np.asarray(x) for p, x in jax.tree_util.tree_flatten_with_path(js)[0]}
    items = dict(tensor_items(got))
    assert set(items) == set(want)
    for key, t in items.items():
        np.testing.assert_array_equal(t.numpy(), want[key], err_msg=key)
    assert (_records(ckpt.read_manifest(root, 4))
            == _records(jax_ckpt.read_manifest(str(tmp_path / "jax"), 4),
                        convert.port_checkpoint_key))


@pytest.mark.parametrize("model", ["word2vec", "widedeep"])
def test_port_run_saves_restores_and_exports(tmp_path, model):
    _, tt = _w2v_pair() if model == "word2vec" else _ctr_pair()
    state = TrainLoop(tt, log_every=0).run(max_steps=3)
    root = str(tmp_path / "ck")
    ckpt.save_checkpoint(root, state, 3)
    back = ckpt.restore_checkpoint(root, tt.init_state())
    for (k, a), (_, b) in zip(tensor_items(state), tensor_items(back), strict=True):
        assert torch.equal(a, b), k
    tt.export_text(state, str(tmp_path / "a.txt"))
    tt.export_text(back, str(tmp_path / "b.txt"))
    assert (tmp_path / "a.txt").read_bytes() == (tmp_path / "b.txt").read_bytes()
