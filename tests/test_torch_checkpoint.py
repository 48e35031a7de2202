"""The port's verified checkpoints against the JAX package's, on the CPU.

* Manifest parity: one state gives the same canonical keys, shapes, dtypes
  and CRCs in both packages (f32 and bf16 word2vec tables; Wide & Deep with
  AdaGrad, whose optimizer keys differ by ``convert.port_checkpoint_key``),
  and each package's ``verify_state`` accepts the other's manifest.
* Checkpoints each way: a JAX (orbax) checkpoint, restored by the JAX
  package, goes through numpy and ``convert.py`` into a port checkpoint
  that the port restores bit-equal; a port checkpoint goes into ``jnp``
  arrays that the JAX ``save_checkpoint`` / ``restore_checkpoint`` write
  and verify. Exact: the CRC covers the same bytes in both.
* The single-device cases of ``tests/test_checkpoint.py`` and
  ``tests/test_resilience.py:153-241`` in the port, and the retained steps
  and data cursors of the JAX ``TrainLoop`` for one config and seed. Left
  out: the mesh cases (the port runs on one device), the tiered and ledger
  cases (not ported), and the dense-plane (``packed: 0``) trainers of the
  JAX tests, which the port does not have; the port's tests use the packed
  plane.
"""

import json
import os

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from swiftsnails_tpu.data.vocab import Vocab as JaxVocab
from swiftsnails_tpu.framework import checkpoint as jax_ckpt
from swiftsnails_tpu.framework.trainer import TrainLoop as JaxTrainLoop
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
from swiftsnails_tpu_torch.resilience import corrupt_checkpoint_dir, resume_state
from swiftsnails_tpu_torch.utils.config import Config
from swiftsnails_tpu_torch.utils.tree import tensor_items

torch.set_num_threads(1)
VOCAB = 40


def _corpus(n=1500, seed=0):
    rng = np.random.default_rng(seed)
    counts = np.maximum(rng.zipf(1.3, VOCAB), 1).astype(np.int64)
    ids = rng.choice(VOCAB, size=n, p=counts / counts.sum()).astype(np.int32)
    return [f"w{i}" for i in range(VOCAB)], counts, ids


def _w2v_conf(**over):
    conf = {"dim": "16", "window": "2", "negatives": "2", "learning_rate": "0.2",
            "batch_size": "64", "subsample": "0", "num_iters": "1", "pool_size": "8",
            "pool_block": "32", "seed": "3", "prefetch_batches": "0"}
    conf.update({k: str(v) for k, v in over.items()})
    return conf


def _w2v_pair(**over):
    words, counts, ids = _corpus()
    conf = _w2v_conf(**over)
    jt = jax_w2v.Word2VecTrainer(JaxConfig(conf), mesh=None, corpus_ids=ids,
                                 vocab=JaxVocab(words, counts))
    tt = word2vec.Word2VecTrainer(Config(conf), corpus_ids=ids, vocab=Vocab(words, counts),
                                  device="cpu")
    return jt, tt


def _ctr_pair():
    conf = {"num_fields": "4", "capacity": "512", "learning_rate": "0.2",
            "optimizer": "adagrad", "batch_size": "128", "num_iters": "1", "seed": "0",
            "embed_dim": "4", "hidden_dims": "8"}
    labels, feats, _ = ctr.synth_ctr(512, 4, 30, seed=2)
    jt = jax_get_model("widedeep")(JaxConfig(conf), data=(labels, feats))
    tt = get_model("widedeep")(Config(conf), data=(labels, feats), device="cpu")
    return jt, tt


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _jax_state_w2v(dtype=jnp.float32):
    jt, tt = _w2v_pair()
    js = jt.init_state()
    rng = np.random.default_rng(7)  # random out table too (init is zeros)
    out = rng.normal(0, 0.1, js.out_table.table.shape).astype(np.float32)
    js = jax_w2v.W2VState(js.in_table._replace(table=js.in_table.table.astype(dtype)),
                          js.out_table._replace(table=jnp.asarray(out).astype(dtype)))
    return jt, tt, js


def _carry_w2v(js):
    return convert.w2v_state_from_numpy(np.asarray(js.in_table.table),
                                        np.asarray(js.out_table.table), device="cpu")


def _trained_ctr_jax(steps=2):
    jt, tt = _ctr_pair()
    js = jt.init_state()
    step = jax.jit(jt.train_step)
    for i, batch in zip(range(steps), jt.batches()):
        js, _ = step(js, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(i))
    return jt, tt, js


def _carry_ctr(js):
    return convert.ctr_state_from_numpy(
        np.asarray(js.table.table), {k: np.asarray(v) for k, v in js.dense.items()},
        {k: np.asarray(v) for k, v in js.opt[0].sum_of_squares.items()}, device="cpu")


def _records(manifest, key_map=lambda k: k):
    return {key_map(jax_ckpt.canonical_key(k)): (v["crc"], v["algo"], v["shape"], v["dtype"])
            for k, v in manifest["arrays"].items()}


# ----------------------------------------------------------- manifests ---


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
def test_word2vec_manifest_matches_jax(dtype):
    _, _, js = _jax_state_w2v(dtype)
    ts = _carry_w2v(js)
    jm = jax_ckpt.build_manifest(js, 5, cursor={"step": 5, "items": 320})
    tm = ckpt.build_manifest(ts, 5, cursor={"step": 5, "items": 320})
    assert _records(tm) == _records(jm)
    assert set(_records(tm)) == {"in_table/table", "out_table/table"}
    assert tm["schema"] == jm["schema"] and tm["data_cursor"] == jm["data_cursor"]
    assert jax_ckpt.verify_state(js, tm) == []
    assert ckpt.verify_state(ts, jm) == []


def test_ctr_adagrad_manifest_matches_jax_through_the_key_map():
    _, _, js = _trained_ctr_jax()
    ts = _carry_ctr(js)
    jm = jax_ckpt.build_manifest(js, 2)
    tm = ckpt.build_manifest(ts, 2)
    assert _records(tm) == _records(jm, convert.port_checkpoint_key)
    assert any(k.startswith("opt/sum_of_squares/") for k in _records(tm))
    # the map is the whole difference, and it inverts
    assert {convert.jax_checkpoint_key(k) for k in _records(tm)} == set(_records(jm))
    jax_view = dict(tm, arrays={convert.jax_checkpoint_key(k): v for k, v in tm["arrays"].items()})
    assert jax_ckpt.verify_state(js, jax_view) == []
    port_view = dict(jm, arrays={convert.port_checkpoint_key(jax_ckpt.canonical_key(k)): v
                                 for k, v in jm["arrays"].items()})
    assert ckpt.verify_state(ts, port_view) == []


# ------------------------------------------------ checkpoints each way ---


def _save_restore_jax(root, js, template):
    jax_ckpt.save_checkpoint(root, js, 4, cursor={"step": 4, "items": 256})
    return jax_ckpt.restore_checkpoint(root, template)


@pytest.mark.parametrize("model", ["word2vec", "widedeep"])
def test_jax_checkpoint_into_the_port(tmp_path, model):
    if model == "word2vec":
        jt, tt, js = _jax_state_w2v()
        carry = _carry_w2v
    else:
        jt, tt, js = _trained_ctr_jax()
        carry = _carry_ctr
    restored = _save_restore_jax(str(tmp_path / "jax"), js, jt.init_state())
    ts = carry(restored)
    root = str(tmp_path / "port")
    ckpt.save_checkpoint(root, ts, 4, cursor={"step": 4, "items": 256})
    got = ckpt.restore_checkpoint(root, tt.init_state())
    want = {convert.port_checkpoint_key(jax_ckpt.canonical_key(jax.tree_util.keystr(p))):
            np.asarray(x) for p, x in jax.tree_util.tree_flatten_with_path(js)[0]}
    items = dict(tensor_items(got))
    assert set(items) == set(want)
    for key, t in items.items():
        np.testing.assert_array_equal(_to_numpy(t), want[key], err_msg=key)
    jm = jax_ckpt.read_manifest(str(tmp_path / "jax"), 4)
    tm = ckpt.read_manifest(root, 4)
    assert _records(tm) == _records(jm, convert.port_checkpoint_key)
    assert tm["data_cursor"] == jm["data_cursor"] == {"step": 4, "items": 256}


@pytest.mark.parametrize("model", ["word2vec", "widedeep"])
def test_port_checkpoint_into_jax(tmp_path, model):
    if model == "word2vec":
        jt, tt = _w2v_pair()
    else:
        jt, tt = _ctr_pair()
    loop = TrainLoop(tt, log_every=0)
    ts = loop.run(max_steps=3)
    root = str(tmp_path / "port")
    ckpt.save_checkpoint(root, ts, 3)
    back = dict(tensor_items(ckpt.restore_checkpoint(root, tt.init_state())))
    template = jt.init_state()
    leaves, treedef = jax.tree_util.tree_flatten_with_path(template)
    arrays = []
    for path, leaf in leaves:
        key = convert.port_checkpoint_key(jax_ckpt.canonical_key(jax.tree_util.keystr(path)))
        arrays.append(jnp.asarray(_to_numpy(back[key])))
    js = jax.tree_util.tree_unflatten(treedef, arrays)
    tm = ckpt.read_manifest(root, 3)
    jax_view = dict(tm, arrays={convert.jax_checkpoint_key(k): v for k, v in tm["arrays"].items()})
    assert jax_ckpt.verify_state(js, jax_view) == []
    jroot = str(tmp_path / "jax")
    jax_ckpt.save_checkpoint(jroot, js, 3)
    again = jax_ckpt.restore_checkpoint(jroot, jt.init_state())  # verifies its manifest
    for a, b in zip(jax.tree_util.tree_leaves(again), jax.tree_util.tree_leaves(js)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert _records(jax_ckpt.read_manifest(jroot, 3), convert.port_checkpoint_key) == _records(tm)


# ----------------------------------- the JAX checkpoint tests' cases ------


def _dict_state(val=2.0):
    return {"w": torch.full((8, 4), val), "b": torch.arange(6.0),
            "n": torch.arange(5, dtype=torch.int32),
            "h": torch.full((3, 128), val).to(torch.bfloat16)}


def _trained_w2v(steps=2):
    _, tt = _w2v_pair()
    return tt, TrainLoop(tt, log_every=0).run(max_steps=steps)


@pytest.mark.parametrize("case", ["dict", "word2vec", "word2vec_bf16", "widedeep"])
def test_save_restore_roundtrip(tmp_path, case):
    if case == "dict":
        state, template = _dict_state(2.0), _dict_state(0.0)
    elif case == "widedeep":
        _, tt = _ctr_pair()
        state = TrainLoop(tt, log_every=0).run(max_steps=2)
        template = tt.init_state()
    else:
        over = {"table_dtype": "bfloat16"} if case.endswith("bf16") else {}
        _, tt = _w2v_pair(**over)
        state = TrainLoop(tt, log_every=0).run(max_steps=2)
        template = tt.init_state()
    root = str(tmp_path / "ck")
    ckpt.save_checkpoint(root, state, 5)
    ckpt.save_checkpoint(root, state, 10)
    assert ckpt.latest_step(root) == 10 and ckpt.intact_steps(root) == [10, 5]
    got = ckpt.restore_checkpoint(root, template)
    assert got is template  # restored in place
    want = dict(tensor_items(state))
    for key, t in tensor_items(got):
        assert t.dtype == want[key].dtype
        assert torch.equal(t, want[key]), key


def test_latest_step_empty(tmp_path):
    assert ckpt.latest_step(str(tmp_path / "nope")) is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore_checkpoint(str(tmp_path / "nope"), None)


def test_export_table_text(tmp_path):
    table = torch.arange(32 * 4, dtype=torch.float32).reshape(32, 4) / 7
    path = str(tmp_path / "dump.txt")
    ckpt.export_table_text(table, path, chunk_rows=10)
    lines = open(path).read().splitlines()
    assert len(lines) == 32
    key, vals = lines[3].split("\t")
    assert int(key) == 3
    np.testing.assert_allclose([float(x) for x in vals.split()], table[3].numpy(), atol=1e-6)


def test_manifest_commits_with_crc_and_cursor(tmp_path):
    root = str(tmp_path / "ck")
    ckpt.save_checkpoint(root, _dict_state(), 3, cursor={"step": 3, "items": 99},
                         config_hash="abcd")
    man = ckpt.read_manifest(root, 3)
    assert man["step"] == 3 and man["config_hash"] == "abcd"
    assert man["data_cursor"] == {"step": 3, "items": 99}
    assert set(man["arrays"]) == {"b", "h", "n", "w"}
    assert man["arrays"]["h"]["dtype"] == "bfloat16" and man["arrays"]["n"]["dtype"] == "int32"
    for meta in man["arrays"].values():
        assert isinstance(meta["crc"], int) and meta["algo"] in ("crc32c", "crc32")
    assert ckpt.intact_steps(root) == [3]


def test_async_save_commits_on_wait_and_is_not_torn_by_a_later_write(tmp_path):
    root = str(tmp_path / "ck")
    state = _dict_state(1.0)
    want = ckpt.build_manifest(state, 7)["arrays"]
    ckpt.save_checkpoint(root, state, 7, wait=False)
    state["w"].add_(5.0)  # the next step writes the tensor in place
    assert ckpt.wait_for_checkpoints() == []
    assert ckpt.read_manifest(root, 7)["arrays"] == want
    got = ckpt.restore_checkpoint(root, _dict_state(0.0))
    assert torch.equal(got["w"], torch.full((8, 4), 1.0))


def test_write_errors_come_back_from_wait(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    ckpt.save_checkpoint(str(blocker), _dict_state(), 1, wait=False)
    errors = ckpt.wait_for_checkpoints()
    assert len(errors) == 1 and "checkpoint save failed" in errors[0]
    assert ckpt.wait_for_checkpoints() == []  # collected once


@pytest.mark.parametrize("corrupt", ["flip", "truncate", "no_manifest"])
def test_restore_rejects_and_leaves_the_template(tmp_path, corrupt):
    root = str(tmp_path / "ck")
    ckpt.save_checkpoint(root, _dict_state(2.0), 3)
    step_dir = tmp_path / "ck" / "step_3"
    if corrupt == "flip":
        corrupt_checkpoint_dir(root)
    elif corrupt == "truncate":
        data = (step_dir / "w.bin").read_bytes()
        (step_dir / "w.bin").write_bytes(data[:-4])
    else:
        (step_dir / ckpt.MANIFEST_NAME).unlink()
    template = _dict_state(0.0)
    with pytest.raises(ckpt.CheckpointError):
        ckpt.restore_checkpoint(root, template)
    for key, t in tensor_items(template):  # nothing was written
        assert torch.equal(t, _dict_state(0.0)[key]), key
    if corrupt == "flip":
        got = ckpt.restore_checkpoint(root, _dict_state(0.0), verify=False)
        assert not torch.equal(got["w"], _dict_state(2.0)["w"]) or not torch.equal(
            got["h"], _dict_state(2.0)["h"])


def test_restore_refuses_another_shape_or_dtype(tmp_path):
    root = str(tmp_path / "ck")
    ckpt.save_checkpoint(root, _dict_state(), 3)
    bad = _dict_state()
    bad["w"] = bad["w"].double()
    with pytest.raises(ckpt.CheckpointError, match="template"):
        ckpt.restore_checkpoint(root, bad)
    bad = _dict_state()
    bad["extra"] = torch.zeros(2)
    with pytest.raises(ckpt.CheckpointError, match="keys"):
        ckpt.restore_checkpoint(root, bad)


def test_resume_walks_back_past_corruption(tmp_path):
    root = str(tmp_path / "ck")
    for step, val in ((2, 1.0), (4, 2.0), (6, 3.0)):
        ckpt.save_checkpoint(root, {"w": torch.full((4, 4), val)}, step,
                             cursor={"step": step})
    corrupt_checkpoint_dir(root)  # newest = step 6
    rejected = []
    got = resume_state(root, {"w": torch.zeros(4, 4)},
                       on_reject=lambda s, e: rejected.append((s, type(e).__name__)))
    assert got is not None
    state, step, cursor = got
    assert step == 4 and cursor == {"step": 4}
    assert torch.equal(state["w"], torch.full((4, 4), 2.0))
    assert rejected == [(6, "CheckpointError")]
    assert resume_state(str(tmp_path / "empty"), {"w": torch.zeros(4, 4)}) is None


def test_resume_prefers_intact_over_torn(tmp_path):
    root = str(tmp_path / "ck")
    ckpt.save_checkpoint(root, {"w": torch.ones(2)}, 2)
    ckpt.save_checkpoint(root, {"w": torch.ones(2) * 5}, 5)
    (tmp_path / "ck" / "step_5" / ckpt.MANIFEST_NAME).unlink()  # a torn save
    assert ckpt.candidate_steps(root) == [2, 5]
    state, step, _ = resume_state(root, {"w": torch.zeros(2)})
    assert step == 2 and torch.equal(state["w"], torch.ones(2))


def test_retention_prunes_old_but_never_protected(tmp_path):
    root = str(tmp_path / "ck")
    for step in (1, 2, 3, 4, 5):
        ckpt.save_checkpoint(root, {"w": torch.ones(2, 2) * step}, step)
    pruned = ckpt.prune_checkpoints(root, keep=2, protect=1)
    assert set(pruned) == {2, 3}
    assert ckpt.all_steps(root) == [1, 4, 5]


def test_trainloop_applies_retention(tmp_path):
    _, tt = _w2v_pair(param_backup_period=2, param_backup_root=str(tmp_path / "ck"),
                      param_backup_keep=2)
    TrainLoop(tt, log_every=0).run(max_steps=11)
    assert ckpt.all_steps(str(tmp_path / "ck")) == [8, 10]


def test_resume_continues_step_counter(tmp_path):
    root = str(tmp_path / "bk")
    _, t1 = _w2v_pair(param_backup_period=4, param_backup_root=root)
    TrainLoop(t1, log_every=0).run(max_steps=9)
    assert ckpt.latest_step(root) == 8
    _, t2 = _w2v_pair(param_backup_period=4, param_backup_root=root, resume=1)
    loop = TrainLoop(t2, log_every=0)
    loop.run(max_steps=13)  # absolute steps: 8 -> 13
    assert loop._restored_step == 8
    assert ckpt.latest_step(root) == 12  # continued counter, not step_4 overwritten


def test_retained_steps_and_cursors_match_the_jax_loop(tmp_path):
    """One config and seed through both packages' TrainLoop: the same
    retained steps, each with the same data cursor."""
    over = dict(param_backup_period=3, param_backup_keep=2, num_iters=2)
    jt, _ = _w2v_pair(param_backup_root=str(tmp_path / "jax"), **over)
    _, tt = _w2v_pair(param_backup_root=str(tmp_path / "port"), **over)
    JaxTrainLoop(jt, log_every=0).run(max_steps=10)
    jax_ckpt.wait_for_checkpoints()
    TrainLoop(tt, log_every=0).run(max_steps=10)
    steps = ckpt.all_steps(str(tmp_path / "port"))
    assert steps == jax_ckpt.all_steps(str(tmp_path / "jax")) == [6, 9]
    for s in steps:
        jm = jax_ckpt.read_manifest(str(tmp_path / "jax"), s)
        tm = ckpt.read_manifest(str(tmp_path / "port"), s)
        assert tm["data_cursor"] == jm["data_cursor"] == {"step": s, "items": s * 64}
        assert set(tm["arrays"]) == {jax_ckpt.canonical_key(k) for k in jm["arrays"]}


def test_manifest_is_plain_json(tmp_path):
    root = str(tmp_path / "ck")
    ckpt.save_checkpoint(root, _dict_state(), 1)
    with open(os.path.join(root, "step_1", ckpt.MANIFEST_NAME)) as f:
        doc = json.load(f)
    assert doc["schema"] == ckpt.MANIFEST_SCHEMA == jax_ckpt.MANIFEST_SCHEMA
    assert sorted(os.listdir(os.path.join(root, "step_1"))) == [
        "b.bin", "h.bin", ckpt.MANIFEST_NAME, "n.bin", "w.bin"]
