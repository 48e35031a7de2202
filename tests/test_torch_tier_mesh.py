"""The port's tiered store (``table_tier: host``) under a ``(2, 2)`` mesh of
gloo processes, against the JAX package's slot collectives and meshed
steps and against the port's own resident meshed runs, on the CPU.

One spawn of four ranks (``torch_tier_ranks.tier_worker``) holds every
case. The claims:

* the slot collectives equal JAX's (``pull_collective_slots``,
  ``push_collective_slots``, ``scatter_slots_collective``) on a 4-device mesh
  bit for bit at f32, with the same cache planes, slot ids and rows (the
  port's pull and push over a cache shard are the plane's own
  ``pull_collective`` / ``push_collective``); the flush's read of
  evicted slots (``gather_slots_collective``) is the whole plane's rows;
* JAX's ``test_async_flush_eviction_parity_matrix``
  (``tests/test_tiered.py:161-193``) held on the port: word2vec ``packed:
  0`` and packed+pool behind a budget that evicts, the async flush off and
  on, bit-equal to the resident meshed run, evictions counted, the slot map
  and CLOCK hand the same on every rank; the same for Wide & Deep's
  small-row plane;
* the tiered meshed tables within rtol 1e-5 / atol 1e-6 of the JAX
  trainer's meshed step (its ``table_tier: host`` substep, the identity
  slot map) fed the same global batches and the tier's planned negatives
  (the injected-pool convention of ``ROADMAP.md``);
* a meshed tiered save's CRCs equal a resident meshed save's and a
  one-device tiered save's; it resumes bit-equal; a one-device tiered save
  restored onto the mesh steps to a finite loss
  (``tests/test_tiered.py:248-277``);
* no rank made a collective off its main thread (the loop's): the tier's
  flusher and the prefetch producer make none;
* ``placement: auto`` with the tier resolves uniform with JAX's reason, and
  the loop builds each guard of slice 6 beside the tier under a mesh
  (``tests/test_torch_guards_mesh.py`` runs them).
"""

import fcntl
import multiprocessing as mp
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from swiftsnails_tpu.framework.quality import paired_corpus as jax_paired_corpus
from swiftsnails_tpu.models import word2vec as jax_w2v
from swiftsnails_tpu.parallel import mesh as jax_mesh
from swiftsnails_tpu.parallel import store as jax_store
from swiftsnails_tpu.parallel import transfer as jax_transfer
from swiftsnails_tpu.parallel.access import AdaGradAccess as JaxAdaGrad
from swiftsnails_tpu.parallel.access import SgdAccess as JaxSgd
from swiftsnails_tpu.utils.config import Config as JaxConfig
from swiftsnails_tpu_torch.framework.trainer import TrainLoop
from swiftsnails_tpu_torch.parallel.mesh import Mesh
import torch_tier_ranks as tr_ranks

RTOL, ATOL = 1e-5, 1e-6
SPAWN_TIMEOUT_S = 300
torch.set_num_threads(1)


def _spawn(out):
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=tr_ranks.tier_worker, args=(r, 4, f"file://{out}/rdv", str(out)))
             for r in range(4)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(SPAWN_TIMEOUT_S)
            assert not p.is_alive(), f"a rank outlived {SPAWN_TIMEOUT_S} s"
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    results = [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(4)]
    for r, res in enumerate(results):
        assert "error" not in res, f"rank {r}:\n{res['error']}"
    return results


@pytest.fixture(scope="module")
def tier_run(tmp_path_factory):
    """The spawn's results, made once a run under a lock in the directory
    every test process of the run shares."""
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    out = base / "tier_mesh_spawn"
    out.mkdir(exist_ok=True)
    with open(out / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not (out / "done").exists():
                _spawn(out)
                (out / "done").write_text("ok")
            return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(4)]
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def by_coords(results, key):
    return {(r["coords"]["data"], r["coords"]["model"]): r[key] for r in results}


def _whole(by, get):
    """The model shards of data replica 0 concatenated; every data replica
    holds the same shards."""
    for (i, j), res in by.items():
        assert torch.equal(get(res), get(by[(0, j)])), (i, j)
    return torch.cat([get(by[(0, j)]) for j in range(2)]).numpy()


def _jax_mesh():
    return jax_mesh.make_mesh({"data": 2, "model": 2}, devices=jax.devices()[:4])


def _put(jm, arr, *spec):
    return jax.device_put(jnp.asarray(arr),
                          jax.sharding.NamedSharding(jm, jax.sharding.PartitionSpec(*spec)))


# ------------------------------------------------------ slot collectives ---


def test_slot_pull_matches_jax(tier_run):
    inp = tr_ranks.slot_inputs()
    jm = _jax_mesh()
    st = jax_store.TableState(table=_put(jm, inp["table"], "model", None), slots={})
    want = np.asarray(jax_transfer.pull_collective_slots(jm, st, _put(jm, inp["slots"], "data")))
    by = by_coords(tier_run, "slots")
    got = np.concatenate([by[(i, 0)]["pull"].numpy() for i in range(2)])
    for (i, j), res in by.items():
        assert torch.equal(res["pull"], by[(i, 0)]["pull"])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("access", ["sgd", "adagrad"])
def test_slot_push_matches_jax(tier_run, access):
    inp = tr_ranks.slot_inputs()
    jm = _jax_mesh()
    slots = {} if access == "sgd" else {"accum": _put(jm, inp["accum"], "model", None)}
    st = jax_store.TableState(table=_put(jm, inp["table"], "model", None), slots=slots)
    new = jax_transfer.push_collective_slots(
        jm, st, _put(jm, inp["slots"], "data"), _put(jm, inp["grads"], "data", None),
        JaxSgd() if access == "sgd" else JaxAdaGrad(), tr_ranks.LR)
    by = by_coords(tier_run, "slots")
    if access == "sgd":
        np.testing.assert_array_equal(_whole(by, lambda r: r["push_sgd"]), np.asarray(new.table))
        return
    # the per-sample AdaGrad adds a repeated slot's squares in another
    # order than XLA's scatter: tests/test_torch_mesh.py's bound
    np.testing.assert_allclose(_whole(by, lambda r: r["push_adagrad"]["table"]),
                               np.asarray(new.table), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(_whole(by, lambda r: r["push_adagrad"]["accum"]),
                               np.asarray(new.slots["accum"]), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("plane", ["table", "packed"])
def test_slot_install_matches_jax_and_moves_nothing(tier_run, plane):
    """The shard-local install equals JAX's ``scatter_slots_collective``;
    the flush's read of the installed slots is their rows, on every rank."""
    inp = tr_ranks.slot_inputs()
    jm = _jax_mesh()
    rows = inp["rows" if plane == "table" else "packed_rows"]
    spec = ("model",) + (None,) * (inp[plane].ndim - 1)
    want = np.asarray(jax_transfer.scatter_slots_collective(
        jm, _put(jm, inp[plane], *spec), inp["install"], rows))
    by = by_coords(tier_run, "slots")
    np.testing.assert_array_equal(_whole(by, lambda r: r[f"install_{plane}"]), want)
    for res in by.values():
        np.testing.assert_array_equal(res[f"read_{plane}"].numpy(), rows)


# -------------------------------------------------- tiered against resident ---


@pytest.mark.parametrize("route", ["dense", "packed"])
@pytest.mark.parametrize("flush", [0, 1])
def test_tiered_mesh_equals_resident_mesh(tier_run, route, flush):
    """JAX's eviction parity matrix on the port's ``(2, 2)`` mesh: the
    tiered tables bit-equal to the resident meshed run's on every rank, the
    losses equal, evictions and flushes counted, the slot map and CLOCK
    hand the same everywhere."""
    first = None
    for r in tier_run:
        runs = r["w2v"]
        res, tiered = runs[(route, None)], runs[(route, flush)]
        assert all(torch.equal(a, b) for a, b in zip(res["tables"], tiered["tables"]))
        assert res["losses"] == tiered["losses"]
        s = tiered["summary"]
        assert s["evictions"] > 0 and s["flushed_rows"] > 0, s
        assert s["async_flush"] is bool(flush)
        if first is None:
            first = tiered
        for k in first["slot_of"]:
            np.testing.assert_array_equal(tiered["slot_of"][k], first["slot_of"][k])
        assert tiered["hand"] == first["hand"] and s["evictions"] == first["summary"]["evictions"]


def test_tiered_widedeep_mesh_equals_resident_mesh(tier_run):
    """Wide & Deep's small-row plane behind a cache of 160 of its 256 tiles:
    every array bit-equal to the resident meshed run's, the losses equal,
    evictions, the same slot map on every rank."""
    first = None
    for r in tier_run:
        res, tiered = r["wd"][False]["arrays"], r["wd"][True]["arrays"]
        assert res.keys() == tiered.keys()
        for k in res:
            assert torch.equal(res[k], tiered[k]), k
        assert r["wd"][False]["losses"] == r["wd"][True]["losses"]
        s = r["wd"][True]["summary"]
        assert s["evictions"] > 0, s
        assert s["tables"]["table"]["budget_slots"] == tr_ranks.WD_BUDGET_TILES
        first = first or r["wd"][True]
        np.testing.assert_array_equal(r["wd"][True]["slot_of"]["table"],
                                      first["slot_of"]["table"])


def test_no_flush_worker_outlives_a_meshed_run(tier_run):
    """The meshed loop stops the tier's flush worker as the unmeshed one
    does: after each tiered run, async flush on, no worker is alive."""
    for r in tier_run:
        runs = [r["w2v"][(route, 1)] for route in ("dense", "packed")] + [r["wd"][True]]
        assert all(run["summary"]["async_flush"] for run in runs)
        assert [run["flush_workers"] for run in runs] == [0, 0, 0]


def test_no_collective_off_the_loops_thread(tier_run):
    for r in tier_run:
        assert r["threads"]["main"] > 0
        assert r["threads"]["off"] == 0, r["threads"]["off_threads"][:5]


# ------------------------------------------------------------- JAX-fed ---


def _jax_fed(route, feed):
    """The JAX trainer's meshed substep in tier mode (rows as given: the
    identity slot map over whole tables) under jit on a (2, 2) virtual
    mesh, fed the port's global batches and planned negatives."""
    jm = _jax_mesh()
    ids, vocab = jax_paired_corpus(n_pairs=8 if route == "dense" else 32, reps=200, seed=0)
    conf = tr_ranks.w2v_conf(route)
    conf.pop("use_native")
    conf["table_tier"] = "host"
    jt = jax_w2v.Word2VecTrainer(JaxConfig(conf), mesh=jm, corpus_ids=ids, vocab=vocab)
    assert jt.tiered
    tables = tr_ranks.w2v_start(route)
    spec = jax.sharding.PartitionSpec("model", *([None] * (tables[0].ndim - 1)))
    put = lambda a: jax.device_put(jnp.asarray(a), jax.sharding.NamedSharding(jm, spec))  # noqa: E731
    kind = jax_store.TableState if route == "dense" else jax_store.PackedTableState
    state = jax_w2v.W2VState(kind(table=put(tables[0]), slots={}),
                             kind(table=put(tables[1]), slots={}))
    substep = jt._substep_dense if route == "dense" else jt._substep_packed
    fn = jax.jit(substep)
    bs = jax_mesh.batch_sharding(jm)
    losses = []
    for s in feed:
        state, loss, _ = fn(state, jax.device_put(s["centers"].astype(np.int32), bs),
                            jax.device_put(s["contexts"].astype(np.int32), bs),
                            jax.random.PRNGKey(0), jt.lr, negs=jnp.asarray(s["negs"]))
        losses.append(float(loss))
    return [np.asarray(t.table) for t in state], losses


@pytest.mark.parametrize("route", ["dense", "packed"])
def test_tiered_mesh_matches_jax_meshed_tier_step(tier_run, route):
    by = by_coords(tier_run, "fed")
    feed = by[(0, 0)][route]["feed"]
    for res in by.values():  # every rank planned the same global steps
        for a, b in zip(res[route]["feed"], feed):
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
    assert by[(0, 0)][route]["evictions"] > 0
    want, want_losses = _jax_fed(route, feed)
    for k, w in enumerate(want):
        got = _whole(by, lambda r, k=k: r[route]["tables"][k])
        np.testing.assert_allclose(got, w, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(by[(0, 0)][route]["losses"], want_losses, rtol=RTOL, atol=ATOL)


# ----------------------------------------------------------- checkpoints ---


def test_tiered_mesh_save_is_a_resident_save(tier_run):
    """The tiered meshed save's manifest CRCs equal the resident meshed
    save's on the ``(2, 2)`` mesh; on a ``(1, 4)`` mesh (no data axis, so
    the steps are one device's) the tiered save's equal an unmeshed
    resident save's and an unmeshed tiered save's: the files are a resident
    save's, whatever wrote them."""
    for r in tier_run:
        ck = r["checkpoint"]
        assert ck["tiered"] == ck["resident"]
        assert ck["wide"] == ck["one"] == ck["one_tiered"]
        assert set(ck["tiered"]) == {"in_table/table", "out_table/table"}


def test_tiered_mesh_resumes_bit_equal(tier_run):
    for r in tier_run:
        ck = r["checkpoint"]["resume"]
        assert all(torch.equal(a, b) for a, b in zip(ck["resumed"], ck["straight"]))
        assert ck["resumed_losses"] == ck["straight_losses"][tr_ranks.CKPT_SAVE:]


def test_tiered_save_restores_onto_the_mesh(tier_run):
    """A one-device tiered save restored onto the ``(2, 2)`` mesh: each
    rank holds its model shard of the saved tables, and a step of the
    restored state has a finite loss."""
    for r in tier_run:
        ck = r["checkpoint"]
        assert ck["restored_equal"] and np.isfinite(ck["restored_loss"])


# --------------------------------------------------------- no spawn needed ---


def _hand_mesh(data=2, model=2):
    return Mesh(shape={"data": data, "model": model}, coords={"data": 0, "model": 0},
                groups={}, device=torch.device("cpu"))


def test_auto_placement_with_the_tier_resolves_uniform():
    """``tests/test_hybrid_placement.py:286-294`` on the port: ``placement:
    auto`` with ``table_tier: host`` under a mesh resolves uniform with the
    JAX trainer's reason."""
    tr = tr_ranks.w2v_trainer("packed", _hand_mesh(), 1, placement="auto")
    assert tr.placement_cut == 0
    assert tr.placement_decision["mode"] == "uniform"
    assert tr.placement_decision["reason"] == "table_tier: host already caches the hot head"
    jm = jax_mesh.make_mesh({"data": 2, "model": 2}, devices=jax.devices()[:4])
    ids, vocab = jax_paired_corpus(n_pairs=32, reps=200, seed=0)
    conf = tr_ranks.w2v_conf("packed", 1, placement="auto")
    conf.pop("use_native")
    jt = jax_w2v.Word2VecTrainer(JaxConfig(conf), mesh=jm, corpus_ids=ids, vocab=vocab)
    assert jt.placement_cut == 0
    assert tr.placement_decision["reason"] == jt.placement_decision["reason"]


@pytest.mark.parametrize("over", [{"guardrail": "1"},
                                  {"freshness_publish": "4", "freshness_dir": "d"},
                                  {"cluster_workers": "1"}, {"tier_verify_period": "5"}],
                         ids=lambda o: next(iter(o)))
def test_slice_6_keys_build_their_guard_with_the_tier_under_a_mesh(over):
    """The loop's guards are ported under a mesh since this test was
    written: it holds that ``TrainLoop`` builds each beside the tier on
    the meshed trainer (``tests/test_torch_guards_mesh.py`` runs them)."""
    tr = tr_ranks.w2v_trainer("packed", _hand_mesh(), 1, **over)
    loop = TrainLoop(tr)
    assert loop.tier is not None and loop.tier.mesh is tr.mesh
    built = {"guardrail": lambda: loop.guardrail is not None and loop.guardrail.mesh is tr.mesh,
             "freshness_publish": lambda: loop.freshness is not None
             and loop.freshness.tier is loop.tier and loop.freshness.mesh is tr.mesh,
             "cluster_workers": lambda: loop.cluster is not None and loop.leader,
             "tier_verify_period": lambda: loop.tier_verify_period == 5}
    assert built[next(iter(over))]()


def test_tiered_table_budget_rounds_to_the_model_axis():
    """JAX ``tiered/store.py:641-645``: the budget rounds up to a multiple
    of ``model``; the cache is this rank's ``budget / model`` slots; the
    master's units must split over the axis."""
    from swiftsnails_tpu.tiered.store import HostMaster as JHostMaster
    from swiftsnails_tpu.tiered.store import TieredTable as JTieredTable
    from swiftsnails_tpu_torch.parallel.store import TableState
    from swiftsnails_tpu_torch.tiered import HostMaster, TieredTable

    for budget in (1, 5, 8, 9, 40):
        master = HostMaster(TableState(table=torch.zeros(24, 4), slots={}), "dense")
        tt = TieredTable(master, budget, mesh=_hand_mesh(model=4), device="cpu")
        jt = JTieredTable(JHostMaster(jax_store.TableState(table=jnp.zeros((24, 4)), slots={}),
                                      "dense"), budget,
                          mesh=jax_mesh.make_mesh({"data": 1, "model": 4},
                                                  devices=jax.devices()[:4]))
        assert tt.budget == jt.budget
        assert tt.make_cache().table.shape == (tt.budget // 4, 4)
    odd = HostMaster(TableState(table=torch.zeros(10, 4), slots={}), "dense")
    with pytest.raises(ValueError, match="split over model axis"):
        TieredTable(odd, 4, mesh=_hand_mesh(model=4), device="cpu")
