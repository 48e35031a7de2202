"""The port's CTR families, checkpoints and ``seqlm`` on a mesh of gloo
processes, against the JAX package's meshed step and against the port on
one device, on the CPU.

One spawn of four ranks (``torch_mesh_ranks.ctr_mesh_worker``), shared by
the test processes of a run (the first to need it makes it under a file
lock, the others read its results): each rank makes a ``(data 2, model
2)`` and a ``(data 2, seq 2)`` mesh and runs

* every CTR case of ``CTR_CASES`` (Wide & Deep packed with AdaGrad, logreg
  packed with SGD, FM, FFM at 39 fields on the 2-D plane, Wide & Deep at a
  capacity whose one tile the model axis cannot split) 3 ``train_step``
  calls from one start state, each rank its part of every global batch;
* the small-row and 2-D bucketed transfer functions;
* checkpoints: Wide & Deep and the grouped word2vec plane saved at step 2
  under the mesh and resumed to step 4 beside the straight run, a corrupt
  copy, a one-device checkpoint restored onto the mesh, W&D's export;
* ``seqlm`` with ring and Ulysses attention on the ``(data, seq)`` mesh, 3
  SGD steps, and adam saved at step 3 and resumed to 6.

The JAX side runs ``train_step`` under ``jit`` on a ``(2, 2)`` mesh of
virtual devices, one ``jit`` a family, from the same start state (the
port's, carried across), the batches sharded over ``data``: never through
the JAX ``TrainLoop``.
"""

import fcntl
import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from swiftsnails_tpu.models.registry import get_model as jax_get_model
from swiftsnails_tpu.models.sparse_base import CTRState as JaxCTRState
from swiftsnails_tpu.parallel import mesh as jax_mesh
from swiftsnails_tpu.parallel import store as jax_store
from swiftsnails_tpu.parallel import transfer as jax_transfer
from swiftsnails_tpu.parallel.access import AdaGradAccess as JaxAdaGrad
from swiftsnails_tpu.parallel.access import SgdAccess as JaxSgd
from swiftsnails_tpu.utils.config import Config as JaxConfig
from swiftsnails_tpu_torch import convert
from swiftsnails_tpu_torch.framework import checkpoint as ckpt
from swiftsnails_tpu_torch.parallel import store
from swiftsnails_tpu_torch.parallel.access import AdaGradAccess
from swiftsnails_tpu_torch.parallel.mesh import Mesh
from swiftsnails_tpu_torch.utils.config import Config
import torch_mesh_ranks as ranks
from test_torch_seqlm import SPAWN_TIMEOUT_S, spawn_ranks

RTOL, ATOL = 1e-5, 1e-6
PRED_RTOL, PRED_ATOL = 2e-4, 2e-5  # tests/test_ctr_models.py:119
SEQ_TOL = 2e-4  # tests/test_seqlm.py:92-93
SHAPE = {"data": 2, "model": 2}
CASES = list(ranks.CTR_CASES)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The four ranks' results: made once a run, under a lock in the
    directory every test process of the run shares (each xdist worker
    has its own module scope)."""
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    out = base / "ctr_mesh_spawn"
    out.mkdir(exist_ok=True)
    with open(out / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if (out / "done").exists():
                return [torch.load(out / f"rank{r}.pt") for r in range(4)]
            results = spawn_ranks(ranks.ctr_mesh_worker, 4, out)
            (out / "done").write_text("ok")
            return results
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def _by(results, key=None):
    """(data, model) -> the rank's result (or its ``key``)."""
    return {(r["coords"]["data"], r["coords"]["model"]): (r if key is None else r[key])
            for r in results}


def _jax_mesh(axes=("data", "model")):
    return jax_mesh.make_mesh(dict(zip(axes, (2, 2))), devices=jax.devices()[:4])


def _put(jm, arr, *spec):
    return jax.device_put(jnp.asarray(arr),
                          jax.sharding.NamedSharding(jm, jax.sharding.PartitionSpec(*spec)))


# ------------------------------------------------------------- the CTR cases ---


def _ctr_whole(results, case):
    """A case's whole arrays (tables and slots from the model shards of data
    replica 0, the rest from rank 0) and rank 0's losses."""
    by = _by(results, "ctr")
    arrays = {}
    for name, t in by[(0, 0)][case]["arrays"].items():
        if name == "table" or name.startswith("slot."):
            t = torch.cat([by[(0, j)][case]["arrays"][name] for j in range(2)])
        arrays[name] = t.numpy()
    return arrays, by[(0, 0)][case]


@functools.lru_cache(maxsize=None)
def _jax_ctr(case):
    """The JAX trainer's ``train_step`` under jit on a (2, 2) virtual mesh,
    from the port's start state; its arrays as :func:`_ctr_whole` names
    them, its losses and accuracies, and its plane."""
    name, _ = ranks.CTR_CASES[case]
    jm = _jax_mesh()
    jt = jax_get_model(name)(JaxConfig(ranks.ctr_conf(case)), mesh=jm,
                             data=ranks.ctr_data(case))
    st = ranks.ctr_start(case)
    if jt.packed:
        table = jax_store.PackedTableState(table=_put(jm, st["table"], "model", None, None),
                                           slots={})
    else:
        table = jax_store.TableState(
            table=_put(jm, st["table"], "model", None),
            slots={k: _put(jm, v, "model", None) for k, v in st["slots"].items()})
    dense = {k: _put(jm, v) for k, v in st["dense"].items()}
    opt = jax.device_put(jt.dense_opt.init(dense),
                         jax.sharding.NamedSharding(jm, jax.sharding.PartitionSpec()))
    state = JaxCTRState(table=table, dense=dense, opt=opt)
    fn = jax.jit(jt.train_step)
    losses, accs = [], []
    for b in ranks.ctr_global_batches(case):
        batch = {"labels": _put(jm, b["labels"], "data"), "feats": _put(jm, b["feats"], "data")}
        state, m = fn(state, batch, jax.random.PRNGKey(0))
        losses.append(float(m["loss"]))
        accs.append(float(m["accuracy"]))
    arrays = {"table": np.asarray(state.table.table)}
    arrays.update({f"slot.{k}": np.asarray(v) for k, v in state.table.slots.items()})
    arrays.update({f"dense.{k}": np.asarray(v) for k, v in state.dense.items()})
    if st["sums"] is not None:
        arrays.update({f"opt.{k}": np.asarray(v)
                       for k, v in state.opt[0].sum_of_squares.items()})
    return arrays, losses, accs, jt.packed


@pytest.mark.parametrize("case", CASES)
def test_ctr_matches_jax_meshed(run, case):
    """Tables, slots, dense tensors and AdaGrad sums after 3 steps, and
    each step's loss and accuracy, within rtol 1e-5 / atol 1e-6 of the JAX
    meshed step's; the same plane."""
    got, res = _ctr_whole(run, case)
    want, losses, accs, packed = _jax_ctr(case)
    assert res["packed"] == packed == ranks.CTR_PACKED[case]
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=RTOL, atol=ATOL, err_msg=name)
    np.testing.assert_allclose(res["losses"], losses, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(res["accuracies"], accs, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", CASES)
def test_ctr_replicas_are_bit_equal(run, case):
    """The data replicas of each model shard hold the same bits, and every
    rank the same dense side, losses and predictions."""
    by = _by(run, "ctr")
    ref = by[(0, 0)][case]
    for (i, j), res in by.items():
        for name, t in res[case]["arrays"].items():
            other = by[(0, j) if name == "table" or name.startswith("slot.") else (0, 0)]
            assert torch.equal(t, other[case]["arrays"][name]), (i, j, name)
        assert res[case]["losses"] == ref["losses"]
        assert torch.equal(res[case]["predict"], ref["predict"])


@pytest.mark.parametrize("case", CASES)
def test_ctr_mesh_predicts_as_one_device(run, case):
    """The (2, 2) mesh's predictions after 3 steps against the same steps
    of the port on one device (the JAX test's bound)."""
    tr = ranks.ctr_solo(case)
    st = ranks.ctr_start(case)
    state = convert.ctr_state_from_numpy(st["table"], st["dense"], st["sums"], device="cpu",
                                         table_slots=st["slots"])
    for b in ranks.ctr_global_batches(case):
        state, _ = tr.train_step(state, {k: torch.from_numpy(v) for k, v in b.items()})
    _, feats = ranks.ctr_data(case)
    want = tr.predict(state, feats[:256])
    got = _by(run, "ctr")[(0, 0)][case]["predict"].numpy()
    np.testing.assert_allclose(got, want, rtol=PRED_RTOL, atol=PRED_ATOL)


@pytest.mark.parametrize("case", CASES)
def test_ctr_step_cost_counts_the_collective_bytes(run, case):
    """``step_cost``'s ``total_bytes`` equals the bytes counted at the
    ``torch.distributed`` call sites, every step on every rank."""
    for r in run:
        for counted, predicted in r["ctr"][case]["counted"]:
            assert counted == predicted > 0


@functools.lru_cache(maxsize=None)
def _jax_transfer(case):
    kind, acc, slack = ranks.CTR_TRANSFER_CASES[case]
    inp = ranks.ctr_transfer_inputs(acc)
    jm = _jax_mesh()
    access = JaxAdaGrad() if acc == "adagrad" else JaxSgd()
    pulled, count = None, 0
    if kind == "bucketed":
        slots = {"accum": _put(jm, inp["accum"], "model", None)} if acc == "adagrad" else {}
        st = jax_store.TableState(table=_put(jm, inp["table"], "model", None), slots=slots)
        st, count = jax_transfer.push_collective_bucketed(
            jm, st, _put(jm, inp["rows2d"], "data"), _put(jm, inp["grads2d"], "data", None),
            access, ranks.LR, slack=slack)
    else:
        st = jax_store.PackedTableState(table=_put(jm, inp["small"], "model", None, None),
                                        slots={})
        rows = _put(jm, inp["rows"], "data")
        if kind == "small_pull":
            pulled = np.asarray(jax_transfer.pull_collective_packed_small(
                jm, st, rows, ranks.SMALL_DIM))
        else:
            st = jax_transfer.push_collective_packed_small(
                jm, st, rows, _put(jm, inp["small_grads"], "data", None), access, ranks.LR,
                ranks.SMALL_DIM)
    return (pulled, np.asarray(st.table), {k: np.asarray(v) for k, v in st.slots.items()},
            int(count))


@pytest.mark.parametrize("case", list(ranks.CTR_TRANSFER_CASES))
def test_transfer_matches_jax(run, case):
    """``pull/push_collective_packed_small`` and ``push_collective_bucketed``
    at f32: the pull equal to JAX's, the tables and slots within rtol 1e-5
    / atol 1e-6, the dropped counts equal (a tight bucket drops rows)."""
    by = _by(run, "transfer")
    for (i, j), r in by.items():
        assert torch.equal(r[case]["table"], by[(0, j)][case]["table"])
        assert r[case]["count"] == by[(0, 0)][case]["count"]
    table = torch.cat([by[(0, j)][case]["table"] for j in range(2)]).numpy()
    w_pulled, w_table, w_slots, w_count = _jax_transfer(case)
    assert by[(0, 0)][case]["count"] == w_count
    assert (w_count > 0) == case.endswith("tight")
    np.testing.assert_allclose(table, w_table, rtol=RTOL, atol=ATOL)
    for k, w in w_slots.items():
        got = torch.cat([by[(0, j)][case]["slots"][k] for j in range(2)]).numpy()
        np.testing.assert_allclose(got, w, rtol=RTOL, atol=ATOL)
    if w_pulled is not None:
        pulled = torch.cat([by[(i, 0)][case]["pull"] for i in range(2)]).numpy()
        np.testing.assert_array_equal(pulled, w_pulled)


# -------------------------------------------------------------- checkpoints ---

PLANES = ["widedeep", "grouped"]


def _spawn_dir(results) -> str:
    """The directory the ranks wrote their checkpoints and exports to."""
    return results[0]["checkpoint"]["dir"]


def _one_device_template(plane):
    if plane == "widedeep":
        return ranks.ctr_trainer("widedeep").init_state()
    return ranks.grouped_trainer("grouped", **ranks.GROUPED_LOOP).init_state()


def _sharded_keys(plane):
    from swiftsnails_tpu_torch.utils.tree import keys_under

    return set(keys_under(_one_device_template(plane),
                          (store.TableState, store.PackedTableState)))


def _whole(results, plane, run_name):
    by = {k: r["checkpoint"][plane][run_name] for k, r in _by(results).items()}
    sharded = _sharded_keys(plane)
    tensors, losses = by[(0, 0)]
    return ({k: torch.cat([by[(0, j)][0][k] for j in range(2)]) if k in sharded else t
             for k, t in tensors.items()}, losses)


@pytest.mark.parametrize("plane", PLANES)
def test_mesh_resume_is_bit_equal(run, plane):
    """Saved at step 2 under the (2, 2) mesh and resumed: steps 3 and 4's
    losses and the final tensors equal the straight run's, bit for bit, on
    every rank."""
    for r in run:
        res = r["checkpoint"][plane]
        straight, resumed = res["straight"], res["resumed"]
        assert sorted(resumed[1]) == [3, 4]
        assert all(resumed[1][s] == straight[1][s] for s in (3, 4))
        for key, t in straight[0].items():
            assert torch.equal(resumed[0][key], t), key


@pytest.mark.parametrize("plane", PLANES)
def test_mesh_manifest_is_a_one_device_manifest(run, plane, tmp_path):
    """The mesh's step-2 manifest has the keys, shapes and dtypes of a
    one-device save, and the data cursor of step 2."""
    root = os.path.join(_spawn_dir(run), f"ck_{plane}")
    mesh_man = ckpt.read_manifest(root, ranks.CKPT_SAVE)
    ckpt.save_checkpoint(str(tmp_path), _one_device_template(plane), step=1)
    one_man = ckpt.read_manifest(str(tmp_path), 1)

    def layout(man):
        return {k: (v["shape"], v["dtype"], v["algo"]) for k, v in man["arrays"].items()}

    assert layout(mesh_man) == layout(one_man)
    assert mesh_man["data_cursor"]["step"] == ranks.CKPT_SAVE


@pytest.mark.parametrize("plane", PLANES)
def test_mesh_checkpoint_restores_onto_one_device(run, plane):
    """The mesh's step 2 restored onto one device (CRCs verified) equals the
    gathered shards of the saving run's state, bit for bit."""
    root = os.path.join(_spawn_dir(run), f"ck_{plane}")
    restored = ckpt.restore_checkpoint(root, _one_device_template(plane), step=ranks.CKPT_SAVE)
    want, _ = _whole(run, plane, "saved")
    from swiftsnails_tpu_torch.utils.tree import tensor_items

    got = dict(tensor_items(restored))
    assert sorted(got) == sorted(want)
    for key, t in want.items():
        assert torch.equal(got[key], t), key


def test_one_device_checkpoint_restores_onto_the_mesh(run):
    """A checkpoint one device wrote, restored onto the (2, 2) mesh: each
    rank holds its rows of the tables and the whole dense side."""
    saved = _by(run)[(0, 0)]["checkpoint"]["one_saved"]
    sharded = _sharded_keys("widedeep")
    for r in run:
        got = r["checkpoint"]["one_restored"]
        assert sorted(got) == sorted(saved)
        j = r["coords"]["model"]
        for key, t in saved.items():
            want = t.chunk(2)[j] if key in sharded else t
            assert torch.equal(got[key], want), key


def test_a_corrupt_shard_is_rejected_on_every_rank(run):
    """A flipped byte in model shard 1's rows: the combined CRC rejects the
    step on every rank, the ranks of shard 0 too."""
    for r in run:
        err = r["checkpoint"]["bad_error"]
        assert err is not None and "verification failed" in err
        if r["coords"]["model"] == 1:
            assert "table/table: crc mismatch" in err


def test_cli_export_of_a_mesh_checkpoint(run, tmp_path):
    """``export`` on one process reads the mesh's newest checkpoint (step
    4) and writes what rank 0's ``export_text`` wrote of that state."""
    out = _spawn_dir(run)
    labels, feats = ranks.ctr_data("widedeep")
    data = tmp_path / "ctr.txt"
    data.write_text("".join(f"{int(lab)} " + " ".join(map(str, row)) + "\n"
                            for lab, row in zip(labels, feats)))
    conf = tmp_path / "wd.conf"
    conf.write_text("model: widedeep\n" + "".join(
        f"{k}: {v}\n" for k, v in {**ranks.ctr_conf("widedeep"), "data": data,
                                   "use_native": 0}.items()))
    dest = tmp_path / "export.txt"
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "swiftsnails_tpu_torch", "export", "-config", str(conf),
         "-device", "cpu", "-checkpoint", os.path.join(out, "ck_widedeep"), "-out", str(dest)],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=SPAWN_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-2000:]
    want = open(os.path.join(out, "widedeep_export.txt")).read()
    assert dest.read_text() == want and want.count("\n") == 1024


# -------------------------------------------------------------------- seqlm ---


@functools.lru_cache(maxsize=None)
def _jax_seqlm(attention):
    """The JAX ``SeqLMTrainer`` on a (data 2, seq 2) virtual mesh, 3 SGD
    steps under jit from the port's start parameters, the batch sharded
    over ``data``."""
    from swiftsnails_tpu.models.seqlm import SeqLMTrainer as JaxSeqLM

    jm = _jax_mesh(("data", "seq"))
    jt = JaxSeqLM(JaxConfig(ranks.seqlm_conf(attention=attention)), mesh=jm,
                  corpus_ids=ranks.seqlm_corpus(), vocab_size=ranks.SEQLM_VOCAB)
    start = ranks.seqlm_trainer().init_state()["params"]
    params = jax.tree_util.tree_map(lambda t: _put(jm, t.numpy()), start)
    state = {"params": params, "opt": jt.opt.init(params)}
    fn = jax.jit(jt.train_step)
    losses = []
    for _, b in zip(range(ranks.SEQLM_STEPS), jt.batches()):
        state, m = fn(state, {"tokens": _put(jm, b["tokens"], "data")}, None)
        losses.append(float(m["loss"]))
    p = state["params"]
    leaves = [p["embed"], p["pos"]] + [blk[k] for blk in p["blocks"]
                                        for k in ("wqkv", "wo", "w1", "w2")]
    return [np.asarray(x) for x in leaves], losses


def _seqlm_dense():
    res = ranks.seqlm_steps(ranks.seqlm_trainer(attention="dense"))
    return [p.numpy() for p in res["params"]], res["losses"]


@pytest.mark.parametrize("attention", ["ring", "ulysses"])
def test_seqlm_mesh_matches_jax(run, attention):
    """Ring or Ulysses on the (data 2, seq 2) mesh, 3 SGD steps: every
    rank's parameters and losses within 2e-4 of the JAX trainer's on its
    (2, 2) mesh."""
    want, losses = _jax_seqlm(attention)
    for r in run:
        res = r["seqlm"][attention]
        np.testing.assert_allclose(res["losses"], losses, rtol=SEQ_TOL, atol=SEQ_TOL)
        for got, w in zip(res["params"], want):
            np.testing.assert_allclose(got.numpy(), w, rtol=SEQ_TOL, atol=SEQ_TOL)
    assert run[0]["seqlm"]["calls"]["ring_shift"] > 0
    assert run[0]["seqlm"]["calls"]["all_to_all"] > 0


@pytest.mark.parametrize("attention", ["ring", "ulysses"])
def test_seqlm_mesh_matches_one_dense_device(run, attention):
    """The same run against one device's dense attention on the whole
    batch, within 2e-4; the data replicas' parameters bit-equal."""
    want, losses = _seqlm_dense()
    by = {(r["seq_coords"]["data"], r["seq_coords"]["seq"]): r["seqlm"][attention] for r in run}
    for (i, j), res in by.items():
        np.testing.assert_allclose(res["losses"], losses, rtol=SEQ_TOL, atol=SEQ_TOL)
        for got, w, other in zip(res["params"], want, by[(0, j)]["params"]):
            np.testing.assert_allclose(got.numpy(), w, rtol=SEQ_TOL, atol=SEQ_TOL)
            assert torch.equal(got, other)


def test_seqlm_mesh_adam_resume(run):
    """Adam under ring attention on the (data, seq) mesh, saved at step 3
    and resumed: steps 4-6's losses within rtol 1e-5 of the straight run's
    (tests/test_seqlm.py:97-130)."""
    for r in run:
        straight, resumed = r["seqlm"]["adam"]["straight"], r["seqlm"]["adam"]["resumed"]
        assert sorted(resumed) == [4, 5, 6]
        np.testing.assert_allclose([resumed[s] for s in (4, 5, 6)],
                                   [straight[s] for s in (4, 5, 6)], rtol=1e-5)


# ------------------------------------------------- no spawn: the pieces alone ---


@pytest.mark.parametrize("algo", ["crc32", "crc32c"])
def test_crc_combine_is_the_crc_of_the_concatenation(algo):
    import zlib

    if algo == "crc32c":
        google_crc32c = pytest.importorskip("google_crc32c")
        crc = google_crc32c.value
    else:
        crc = zlib.crc32
    rng = np.random.default_rng(0)
    for n1, n2 in [(0, 5), (5, 0), (1, 1), (1000, 37), (4096, 4096), (12345, 100000)]:
        a, b = (rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in (n1, n2))
        assert ckpt.crc_combine(crc(a), crc(b), len(b), algo) == crc(a + b)


def _hand_mesh(data=2, model=2):
    return Mesh(shape={"data": data, "model": model}, coords={"data": 0, "model": 1},
                groups={}, device=torch.device("cpu"))


def test_small_table_shard_is_the_whole_tables_tiles():
    """``create_packed_small_table(mesh=)`` cuts the table the same call
    draws without a mesh (model shard 1 of 2: the second half of the
    tiles); a tile count the axis cannot divide raises."""
    access = AdaGradAccess()
    whole = store.create_packed_small_table(1024, 17, access, seed=3, device="cpu")
    shard = store.create_packed_small_table(1024, 17, access, seed=3, device="cpu",
                                            mesh=_hand_mesh())
    assert torch.equal(shard.table, whole.table[128:])
    with pytest.raises(ValueError, match="tile count 1 not divisible by model axis 2"):
        store.create_packed_small_table(4, 17, access, device="cpu", mesh=_hand_mesh())


def test_indivisible_tiles_fall_back_to_the_2d_plane(caplog):
    """The JAX trainer's fallback and its warning (``sparse_base.py:97-114``)."""
    tr = ranks.ctr_trainer("widedeep_fallback", _hand_mesh())
    assert not tr.packed and "using the 2-D collective plane" in caplog.text
    assert ranks.ctr_trainer("widedeep", _hand_mesh()).packed


@pytest.mark.parametrize("over", [
    {"dense_tp": "1"}, {"placement": "hybrid"}, {"comm_dtype": "int8"},
    {"optimizer_sharding": "zero"}], ids=lambda o: next(iter(o)))
def test_other_plane_keys_still_raise_on_a_meshed_ctr_trainer(over):
    """Every key of this test is ported since it was written: it holds that
    the meshed trainer takes each (the wire; the tensor-parallel MLP's
    layout; the hybrid cut; the sharded optimizer planes)."""
    tr = ranks.ctr_trainer("widedeep", _hand_mesh(), **over)
    assert tr.packed and tr.mesh is not None
    took = {"comm_dtype": lambda: tr.comm_dtype == "int8",
            "dense_tp": lambda: tr.dense_tp_manager() is not None,
            "placement": lambda: tr.placement_cut > 0 and tr.placement_spec() is not None,
            "optimizer_sharding": lambda: tr.zero}
    assert took[next(iter(over))]()


@pytest.mark.parametrize("over", [{"guardrail": "1"}, {"table_tier": "host"},
                                  {"freshness_publish": "4", "freshness_dir": "d"}],
                         ids=lambda o: next(iter(o)))
def test_loop_keys_build_under_a_meshed_ctr_trainer(over):
    """Every key of this test is ported under a mesh since it was written:
    it holds that the loop builds the tier, the guardrail (voting over the
    mesh) and the publisher on the meshed trainer."""
    from swiftsnails_tpu_torch.framework.trainer import TrainLoop

    tr = ranks.ctr_trainer("widedeep", _hand_mesh(), **over)
    loop = TrainLoop(tr)
    if "table_tier" in over:
        assert loop.tier is not None and loop.tier.mesh is tr.mesh and tr.tiered
    elif "guardrail" in over:
        assert loop.guardrail is not None and loop.guardrail.mesh is tr.mesh
    else:
        assert loop.freshness is not None and loop.freshness.mesh is tr.mesh


def test_seqlm_takes_a_mesh_or_a_group():
    """The seq axis of a mesh is the attention's group (``ring`` by
    default); a data-only mesh keeps dense attention; not both a group and
    a mesh."""
    seq = Mesh(shape={"data": 2, "seq": 2}, coords={"data": 0, "seq": 1},
               groups={"seq": "g"}, device=torch.device("cpu"))
    tr = ranks.seqlm_trainer(seq, attention="ring")
    assert tr.seq_group == "g" and tr.mesh is seq
    assert ranks.seqlm_trainer(_hand_mesh()).attention == "dense"
    with pytest.raises(ValueError, match="not both"):
        from swiftsnails_tpu_torch.models.seqlm import SeqLMTrainer

        SeqLMTrainer(Config(ranks.seqlm_conf()), corpus_ids=ranks.seqlm_corpus(),
                     vocab_size=ranks.SEQLM_VOCAB, seq_group="g", mesh=seq)


@pytest.mark.parametrize("model", ["widedeep", "seqlm"])
def test_cli_trains_on_a_cluster_and_resumes(tmp_path, model):
    """``python -m swiftsnails_tpu_torch train`` as two processes (a (2, 1)
    mesh) with checkpoints: the same losses on both ranks; a second pair
    with ``resume: auto`` restores the newest step and goes on."""
    import json

    rng = np.random.default_rng(0)
    if model == "widedeep":
        labels, feats = ranks.ctr_data("widedeep")
        (tmp_path / "data.txt").write_text("".join(
            f"{int(lab)} " + " ".join(map(str, row)) + "\n" for lab, row in zip(labels, feats)))
        keys = {**ranks.ctr_conf("widedeep"), "num_iters": 1, "use_native": 0}
    else:
        words = [f"t{i}" for i in range(40)]
        (tmp_path / "data.txt").write_text(" ".join(rng.choice(words, 2400)))
        keys = {**ranks.seqlm_conf(optimizer="adam", learning_rate="0.003"), "num_iters": 1,
                "use_native": 0}
    conf = tmp_path / "c.conf"
    conf.write_text(f"model: {model}\ndata: data.txt\n" + "".join(
        f"{k}: {v}\n" for k, v in keys.items()))

    def pair(*extra):
        procs = []
        for r in range(2):
            env = dict(os.environ, RANK=str(r), OMP_NUM_THREADS="1", PYTHONPATH=REPO)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "swiftsnails_tpu_torch", "train", "-config", str(conf),
                 "-device", "cpu", "-expected_node_num", "2", "-init_timeout", "120",
                 "-master_addr", f"file://{tmp_path}/rendezvous{len(extra)}",
                 "-param_backup_root", str(tmp_path / "ck"), "-param_backup_period", "3",
                 "-log_every", "1", *extra],
                cwd=tmp_path, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True))
        outs = []
        try:
            for p in procs:
                out, err = p.communicate(timeout=SPAWN_TIMEOUT_S)
                assert p.returncode == 0, err[-2000:]
                outs.append(([json.loads(ln) for ln in out.splitlines()
                              if ln.startswith("{")], err))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        return outs

    first = pair()
    losses = [[r["loss"] for r in recs if "loss" in r] for recs, _ in first]
    assert losses[0] and losses[0] == losses[1]
    newest = ckpt.intact_steps(str(tmp_path / "ck"))[0]
    assert newest % 3 == 0 and newest <= len(losses[0])
    second = pair("-resume", "auto")
    for _, err in second:
        assert f"resume: restored step {newest}" in err
