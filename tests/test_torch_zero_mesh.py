"""The port's ZeRO optimizer sharding (``parallel/zero.py``) and Wide &
Deep's ``dense_tp`` on a ``(2, 2)`` mesh of gloo processes, against the JAX
package and against the port's replicated runs, on the CPU.

The spawn is the one ``tests/test_torch_hybrid_mesh.py`` makes
(``torch_placement_ranks.placement_worker``), shared through its file
lock. The holds (``tests/test_zero_sharding.py:152-323`` of the JAX
package):

* the hybrid head push under zero bit-identical to the replicated one on
  every plane, each rank holding its ``1 / data`` slice of the slot planes;
* the cut aligned to ``lcm(model, data)`` (tiles of it on the small-row
  plane), as the JAX trainers align it;
* Wide & Deep's dense AdaGrad sums sharded over ``data`` (each rank its
  ``1 / data`` leading slice) and the run bit-identical to the replicated
  one, on the 2-D and small-row planes; the manager's summary the JAX
  manager's; ``master_state`` giving whole planes back;
* a checkpoint's per-array CRCs equal to an unsharded uniform save's, and
  ``resume: auto`` bit-identical to the straight run (and into the uniform
  unsharded layout, within the hybrid bound);
* ``overlap: 2`` composed with zero bit-identical to it without zero;
* ``dense_tp: 1``: each rank holding its column slice of ``w0`` (its row
  slice of ``w1``), the run against the JAX package's unmeshed step fed
  the same weights (the same math; rtol 1e-4 / atol 1e-5, the sums' order
  differs) and against ``dense_tp: 0`` on the mesh (rtol 1e-5 / atol
  1e-6); hidden widths that do not divide by ``model`` raise;
* ``step_cost``'s bytes equal to the counted ones under zero and
  ``dense_tp``; the run record carrying ``placement`` and ``zero``.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from swiftsnails_tpu.framework.quality import paired_corpus as jax_paired_corpus
from swiftsnails_tpu.models.registry import get_model as jax_get_model
from swiftsnails_tpu.models.word2vec import Word2VecTrainer as JaxW2V
from swiftsnails_tpu.models.sparse_base import CTRState as JaxCTRState
from swiftsnails_tpu.parallel import mesh as jax_mesh
from swiftsnails_tpu.parallel.placement import PlacementManager as JaxPlacementManager
from swiftsnails_tpu.parallel.zero import ZeroManager as JaxZeroManager
from swiftsnails_tpu.parallel.zero import resolve_optimizer_sharding as jax_resolve
from swiftsnails_tpu.parallel.zero import zero_plane_spec as jax_zero_plane_spec
from swiftsnails_tpu.utils.config import Config as JaxConfig
from swiftsnails_tpu_torch.parallel.mesh import Mesh
from swiftsnails_tpu_torch.parallel.zero import resolve_optimizer_sharding, zero_plane_spec
from swiftsnails_tpu_torch.utils.config import Config
import torch_mesh_ranks as ranks
import torch_placement_ranks as pr
from test_torch_hybrid_mesh import HYB_ATOL, HYB_RTOL, by_coords, placement_run  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6
torch.set_num_threads(1)


def _hand_mesh(data=2, model=2):
    return Mesh(shape={"data": data, "model": model}, coords={"data": 0, "model": 0},
                groups={}, device=torch.device("cpu"))


def test_resolve_optimizer_sharding_matches_jax():
    for name in (None, "none", "zero", "ZERO"):
        assert resolve_optimizer_sharding(name) == jax_resolve(name)
    for bad in ("stage3", "fsdp"):
        with pytest.raises(ValueError, match="optimizer_sharding"):
            resolve_optimizer_sharding(bad)


@pytest.mark.parametrize("shape,data", [((8, 4), 4), ((6, 4), 4), ((2,), 4), ((), 4),
                                        ((4,), 4), ((16, 1), 2), ((1,), 2)])
def test_zero_plane_spec_matches_jax(shape, data):
    assert zero_plane_spec(shape, data) == (
        jax_zero_plane_spec(np.zeros(shape, np.float32), data) is not None)


# ------------------------------------------------------------- head push ---


@pytest.mark.parametrize("case", ["dense_adagrad", "packed", "small"])
def test_zero_head_push_bit_identical(placement_run, case):
    """The head push under zero (reduce-scatter, own slice updated, params
    gathered) equals the replicated push bit for bit: head, slots, tail and
    pull; each rank's slot planes are its ``1 / data`` slice."""
    by = by_coords(placement_run, "hybrid")
    for (i, _), res in by.items():
        rep, zero = res[case], res[f"{case}_zero"]
        for key in ("head", "tail"):
            assert torch.equal(zero[key], rep[key]), key
        if rep["pull"] is not None:
            assert torch.equal(zero["pull"], rep["pull"])
        for k, whole in rep["head_slots"].items():
            assert torch.equal(zero["head_slots"][k], whole)
            own = whole.shape[0] // 2
            assert torch.equal(zero["head_slots_own"][k], whole[i * own:(i + 1) * own])


def test_zero_aligns_the_cut_to_the_data_axis_too():
    """With ``optimizer_sharding: zero`` the cut divides by ``lcm(model,
    data)`` (the JAX trainers' rule): on a (data 3, model 2) mesh a head of
    64 rows becomes 60; the small-row plane aligns tiles the same way."""
    m = _hand_mesh(data=3, model=2)
    jm = jax_mesh.make_mesh({"data": 3, "model": 2}, devices=jax.devices()[:6])
    for over in ({}, {"optimizer_sharding": "zero"}):
        tr = ranks.grouped_trainer("grouped", m, placement="hybrid", placement_head_rows="64",
                                   batch_size="384", **over)
        ids, vocab = jax_paired_corpus(n_pairs=ranks.GROUPED_CAP // 2,
                                       reps=ranks.GROUPED_REPS, seed=0)
        conf = ranks.grouped_conf(placement="hybrid", placement_head_rows="64",
                                  batch_size="384", **over)
        conf.pop("use_native")
        jt = JaxW2V(JaxConfig(conf), mesh=jm, corpus_ids=ids, vocab=vocab)
        assert tr.placement_cut == jt.placement_cut == (60 if over else 64)
        assert tr.placement_decision == jt.placement_decision
    for over in ({}, {"optimizer_sharding": "zero"}):
        # 16 rows a tile: 32-row steps on 2 model shards, 96 under zero
        tr = pr.wd_trainer(m, placement_head_rows="130", **over)
        jt = jax_get_model("widedeep")(
            JaxConfig({**pr.WD_KEYS, "placement_head_rows": "130", **over}), mesh=jm,
            data=pr.wd_data())
        assert tr.placement_cut == jt.placement_cut == (96 if over else 128)
        assert tr.placement_decision == jt.placement_decision


# --------------------------------------------------------- the CTR planes ---


@pytest.mark.parametrize("zero,rep", [("zero", "replicated"), ("small_zero", "small")])
def test_ctr_zero_planes_sharded_and_bit_identical(placement_run, zero, rep):
    """W&D under zero: every shardable AdaGrad sum (and the head's slot
    plane) held as the rank's ``1 / data`` slice mid-run, the summary's
    census (reduction 2, replicated = 2 x sharded bytes), and the merged
    state and losses bit-identical to the replicated run's."""
    for res in by_coords(placement_run, "wd").values():
        z, r = res[zero], res[rep]
        assert z["losses"] == r["losses"]
        assert sorted(z["state"]) == sorted(r["state"])
        for k, t in r["state"].items():
            assert torch.equal(z["state"][k], t), k
            assert list(t.shape) == list(z["state"][k].shape)
        summary = z["zero"]
        assert summary["planes"] >= 1 and summary["reduction"] == 2.0
        assert summary["replicated_bytes"] == 2 * summary["sharded_bytes_per_replica"]
        sharded = 0
        for k, shape in z["held"].items():
            whole = r["held"][k]
            if k.startswith("opt/") or k.startswith("table/head_slots"):
                if whole and whole[0] >= 2 and whole[0] % 2 == 0:
                    assert shape == [whole[0] // 2, *whole[1:]], k
                    sharded += 1
                else:
                    assert shape == whole, k
        assert sharded == summary["planes"]


def _jax_zero_summary(**over):
    """The JAX managers' adopt on the same W&D config on a (2, 2) virtual
    mesh: the zero summary."""
    jm = jax_mesh.make_mesh({"data": 2, "model": 2}, devices=jax.devices()[:4])
    conf = {**pr.WD_KEYS, **over}
    jt = jax_get_model("widedeep")(JaxConfig(conf), mesh=jm, data=pr.wd_data())
    state = jt.init_state()
    state = JaxPlacementManager(jt, jm).adopt(state)
    zm = JaxZeroManager(jt, jm)
    zm.adopt(state)
    return zm.summary()


@pytest.mark.parametrize("name,over", [("zero", {"packed": "0"}), ("small_zero", {})])
def test_zero_summary_matches_jax(placement_run, name, over):
    got = by_coords(placement_run, "wd")[(0, 0)][name]["zero"]
    want = _jax_zero_summary(optimizer_sharding="zero", **over)
    assert got == want


def test_zero_master_state_unshards(placement_run):
    """The state a zero run returns holds whole planes: the replicated
    run's shapes, with the slices held mid-run gathered."""
    for res in by_coords(placement_run, "wd").values():
        for k, t in res["replicated"]["state"].items():
            assert res["zero"]["state"][k].shape == t.shape


@pytest.mark.parametrize("name", ["replicated", "zero", "small_zero", "small"])
def test_step_cost_counts_the_zero_bytes(placement_run, name):
    for res in by_coords(placement_run, "wd").values():
        for counted, predicted in res[name]["counted"]:
            assert counted == predicted > 0


# ----------------------------------------------------------- checkpoints ---


def test_checkpoint_crcs_equal_the_unsharded_uniform_save(placement_run):
    """One state saved uniform and unsharded, and again through the hybrid
    split and zero's slices: the same arrays and CRCs; after 2 steps, the
    zero run's save and the replicated run's (both hybrid) the same."""
    for res in by_coords(placement_run, "checkpoint").values():
        assert res["layouts"]["split"] == res["layouts"]["uniform"]
        assert res["steps"]["zero"] == res["steps"]["replicated"]
        assert len(res["layouts"]["uniform"]) >= 9


def test_resume_under_hybrid_and_zero(placement_run):
    """A hybrid + zero run saved at step 2 and resumed (``resume: auto``)
    to 4 is the straight run bit for bit; resumed into the uniform
    unsharded layout it is within the hybrid bound of it."""
    for res in by_coords(placement_run, "checkpoint").values():
        r = res["resume"]
        assert sorted(r["resumed"]) == sorted(r["straight"])
        for k, t in r["straight"].items():
            assert torch.equal(r["resumed"][k], t), k
            np.testing.assert_allclose(r["uniform"][k].numpy(), t.numpy(), rtol=HYB_RTOL,
                                       atol=HYB_ATOL, err_msg=k)
        tail = {s: v for s, v in r["straight_losses"].items() if s > ranks.CKPT_SAVE}
        assert r["resumed_losses"] == tail
        np.testing.assert_allclose(list(r["uniform_losses"].values()), list(tail.values()),
                                   rtol=HYB_RTOL, atol=HYB_ATOL)


# ------------------------------------------------------- the grouped plane ---


@pytest.mark.parametrize("route", ["grouped", "overlap2"])
def test_zero_on_the_grouped_plane_is_bit_identical(placement_run, route):
    """word2vec trains SGD, so zero is the head push's wire: the tables,
    losses and dropped counts of a hybrid run with zero equal the run
    without, ``overlap: 2`` included (``tests/test_zero_sharding.py:323``)."""
    by, byz = by_coords(placement_run, "grouped"), by_coords(placement_run, "grouped_zero")
    for key, res in by.items():
        z = byz[key][route]
        assert all(torch.equal(a, b) for a, b in zip(z["tables"], res[route]["tables"]))
        assert z["losses"] == res[route]["losses"] and z["dropped"] == res[route]["dropped"]
        assert all(np.isfinite(z["losses"]))
        assert "ssn_zero_head_push" in z["scopes"]


# -------------------------------------------------------------- dense_tp ---


def test_dense_tp_holds_the_column_slice_of_w0(placement_run):
    """Each model rank holds its column slice of ``w0`` and ``b0``, its row
    slice of ``w1``, and ``b1`` and the last layer whole."""
    start = ranks.ctr_start("widedeep")["dense"]
    for (_, j), res in by_coords(placement_run, "tp").items():
        held = res[True]["held"]
        half = start["w0"].shape[1] // 2
        np.testing.assert_array_equal(held["w0"].numpy(), start["w0"][:, j * half:(j + 1) * half])
        np.testing.assert_array_equal(held["b0"].numpy(), start["b0"][j * half:(j + 1) * half])
        rows = start["w1"].shape[0] // 2
        np.testing.assert_array_equal(held["w1"].numpy(), start["w1"][j * rows:(j + 1) * rows])
        for k in ("b1", "w2", "b2", "bias"):
            np.testing.assert_array_equal(held[k].numpy(), start[k])
        assert held["w0"].shape != res[False]["held"]["w0"].shape


def _jax_unmeshed_widedeep():
    """The JAX W&D step without a mesh, fed the shared start state and the
    3 global batches (the oracle: column/row parallelism is the same math)."""
    from swiftsnails_tpu.parallel.store import PackedTableState as JaxPacked

    jt = jax_get_model("widedeep")(JaxConfig(ranks.ctr_conf("widedeep")),
                                   data=ranks.ctr_data("widedeep"))
    st = ranks.ctr_start("widedeep")
    dense = {k: jnp.asarray(v) for k, v in st["dense"].items()}
    opt = jt.dense_opt.init(dense)
    opt = (opt[0]._replace(sum_of_squares={k: jnp.asarray(v) for k, v in st["sums"].items()}),
           *opt[1:])
    state = JaxCTRState(table=JaxPacked(table=jnp.asarray(st["table"]), slots={}),
                        dense=dense, opt=opt)
    fn = jax.jit(jt.train_step)
    losses = []
    for b in ranks.ctr_global_batches("widedeep"):
        state, met = fn(state, {k: jnp.asarray(v) for k, v in b.items()},
                        jax.random.PRNGKey(0))
        losses.append(float(met["loss"]))
    arrays = {"table": np.asarray(state.table.table)}
    arrays.update({f"dense.{k}": np.asarray(v) for k, v in state.dense.items()})
    arrays.update({f"opt.{k}": np.asarray(v) for k, v in state.opt[0].sum_of_squares.items()})
    return arrays, losses


def _tp_whole(results, tp):
    by = by_coords(results, "tp")
    arrays = {}
    for name, t in by[(0, 0)][tp]["arrays"].items():
        if name == "table":
            t = torch.cat([by[(0, j)][tp]["arrays"][name] for j in range(2)])
        arrays[name] = t.numpy()
    return arrays, by[(0, 0)][tp]["losses"]


def test_dense_tp_matches_the_jax_unmeshed_step(placement_run):
    got, losses = _tp_whole(placement_run, True)
    want, want_losses = _jax_unmeshed_widedeep()
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=HYB_RTOL, atol=HYB_ATOL, err_msg=k)
    np.testing.assert_allclose(losses, want_losses, rtol=HYB_RTOL, atol=HYB_ATOL)


def test_dense_tp_matches_dense_tp_0_on_the_mesh(placement_run):
    got, losses = _tp_whole(placement_run, True)
    want, want_losses = _tp_whole(placement_run, False)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=RTOL, atol=ATOL, err_msg=k)
    np.testing.assert_allclose(losses, want_losses, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("tp", [False, True])
def test_step_cost_counts_the_dense_tp_bytes(placement_run, tp):
    for res in by_coords(placement_run, "tp").values():
        for counted, predicted in res[tp]["counted"]:
            assert counted == predicted > 0


def test_dense_tp_needs_hidden_widths_that_divide():
    with pytest.raises(ValueError, match=r"hidden_dims.*\[16, 8\]"):
        ranks.ctr_trainer("widedeep", _hand_mesh(model=3), dense_tp="1", capacity="1536")
    assert ranks.ctr_trainer("widedeep", _hand_mesh(model=2), dense_tp="1").dense_tp_manager()
    assert ranks.ctr_trainer("widedeep", dense_tp="1").dense_tp_manager() is None


# -------------------------------------------------------- the run record ---


def test_the_run_record_carries_placement_and_zero(placement_run):
    """``TrainLoop``'s run record under hybrid + zero: the cut decision with
    the first step's counted bytes, and the zero summary; ``ledger-report``
    renders the placement line."""
    from swiftsnails_tpu_torch.telemetry.ledger import Ledger, render_report

    for res in placement_run:
        with open(res["ledger"]) as f:
            runs = [r for r in map(json.loads, f) if r.get("kind") == "run"]
        rec = runs[-1]
        assert rec["placement"]["mode"] == "hybrid" and rec["placement"]["cut"] == 128
        assert rec["placement"]["measured_exchange_bytes"] > 0
        assert rec["zero"]["mode"] == "zero" and rec["zero"]["reduction"] == 2.0
        report = render_report(Ledger(res["ledger"]))
        assert "hybrid placement" in report and "cut=128" in report
