"""The port's hybrid head/tail placement (``parallel/hybrid.py``) on a
``(2, 2)`` mesh of gloo processes, against the JAX package's hybrid
functions and trainers on a ``(2, 2)`` mesh of virtual devices, and
against the port's own uniform runs, on the CPU.

One spawn of four ranks (``torch_placement_ranks.placement_worker``) is
shared by this module, ``tests/test_torch_zero_mesh.py`` and
``tests/test_torch_placement.py`` (the first test process of a run to need
it makes it under a file lock, the others read its results). The holds:

* split and merge bit-exact on the 2-D, packed and small-row planes;
* every hybrid route (the 2-D plane's per-sample AdaGrad and SGD, the
  packed dedup tail, the bucketed tail, the small-row fused AdaGrad; with
  and without ``zero``) against the JAX route on the same inputs: at f32
  within rtol 1e-5 / atol 1e-6 (the JAX transfer tests' bound), the
  dropped counts equal; under int8 and int4 every element within one
  quantization step of the JAX result (the codec's one-step bound: the
  rounding of the f32 sums may move a dithered code by one step);
* the head push billed to the JAX scope names;
* the grouped word2vec plane with ``placement: hybrid`` (plain, dedup,
  bucketed, ``overlap: 2`` and a tail cap that overflows) against the JAX
  hybrid trainer's meshed step (rtol 1e-5 / atol 1e-6, the dropped counts
  equal) and against the port's uniform plane (rtol 1e-4 / atol 1e-5,
  ``tests/test_hybrid_placement.py``'s bound), ``step_cost``'s bytes
  equal to the counted ones;
* the 2-D plane under ``TrainLoop`` on ``(2, 2)`` and ``(1, 1)``, and the
  CTR small-row plane, hybrid against uniform (rtol 1e-4 / atol 1e-5).
"""

import fcntl
import functools
import multiprocessing as mp
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from swiftsnails_tpu.framework.quality import paired_corpus as jax_paired_corpus
from swiftsnails_tpu.models import word2vec as jax_w2v
from swiftsnails_tpu.parallel import hybrid as jax_hybrid
from swiftsnails_tpu.parallel import mesh as jax_mesh
from swiftsnails_tpu.parallel import store as jax_store
from swiftsnails_tpu.parallel.access import AdaGradAccess as JaxAdaGrad
from swiftsnails_tpu.parallel.access import SgdAccess as JaxSgd
from swiftsnails_tpu.parallel.placement import PlacementManager as JaxPlacementManager
from swiftsnails_tpu.utils.config import Config as JaxConfig
import torch_mesh_ranks as ranks
import torch_placement_ranks as pr

RTOL, ATOL = 1e-5, 1e-6
HYB_RTOL, HYB_ATOL = 1e-4, 1e-5  # tests/test_hybrid_placement.py: hybrid against uniform
STEP_SHARE = {"int8": 1 / 127, "int4": 1 / 7}  # a code step, as a share of its scale's amax
SPAWN_TIMEOUT_S = 300
torch.set_num_threads(1)


def _spawn(out):
    """The four ranks, each saving its results under ``out``."""
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=pr.placement_worker, args=(r, 4, f"file://{out}/rdv", str(out)))
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
def placement_run(tmp_path_factory):
    """The shared spawn's results, made once a run under a lock in the
    directory every test process of the run shares."""
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    out = base / "placement_spawn"
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


def _jax_mesh():
    return jax_mesh.make_mesh({"data": 2, "model": 2}, devices=jax.devices()[:4])


def _put(jm, arr, *spec):
    return jax.device_put(jnp.asarray(arr),
                          jax.sharding.NamedSharding(jm, jax.sharding.PartitionSpec(*spec)))


# ---------------------------------------------------------- split / merge ---


@pytest.mark.parametrize("plane", ["dense", "packed", "small"])
def test_split_merge_is_bit_exact(placement_run, plane):
    """Split at the cut and merged back, each rank's shard is the one it
    held, bit for bit; the head has ``cut`` rows (tiles), each tail shard
    its part of the rest."""
    whole = {"dense": pr.DENSE_CAP, "packed": pr.PACKED_CAP, "small": pr.SMALL_CAP // 4}[plane]
    cut_t = pr.CUT // (4 if plane == "small" else 1)
    for res in by_coords(placement_run, "split_merge").values():
        case = res[plane]
        assert all(torch.equal(a, b) for a, b in zip(case["before"], case["after"]))
        assert case["head_rows"] == cut_t and case["tail_rows"] == (whole - cut_t) // 2


# --------------------------------------------------- the transfer routes ---


def _jax_state(jm, plane, table, slots):
    if plane == "dense":
        return jax_store.TableState(
            table=_put(jm, table, "model", None),
            slots={k: _put(jm, v, "model", None) for k, v in slots.items()})
    return jax_store.PackedTableState(table=_put(jm, table, "model", None, None), slots={})


@functools.lru_cache(maxsize=None)
def _jax_case(case):
    """The JAX hybrid route of a transfer case on a (2, 2) virtual mesh:
    its pull, head, head slots, tail, tail slots and dropped count."""
    plane, acc, wire, zero = pr.HYBRID_CASES[case]
    table, slots, rows, grads = pr.hybrid_inputs(plane)
    slots = slots if acc == "adagrad" else {}
    jm = _jax_mesh()
    st = _jax_state(jm, plane, table, slots)
    hs = jax_hybrid.split_table(st, pr.CUT, jm, 4 if plane == "small" else 1)
    r, g = _put(jm, rows, "data"), _put(jm, grads, "data", *([None] * (grads.ndim - 1)))
    access = JaxSgd() if acc == "sgd" else JaxAdaGrad()
    seed = jnp.uint32(pr.SEED) if wire != "float32" else None

    def route(hs, r, g):
        pulled, dropped = None, jnp.int32(0)
        if plane == "dense":
            pulled = jax_hybrid.pull_hybrid(jm, hs, r, comm_dtype=wire)
            hs = jax_hybrid.push_hybrid(jm, hs, r, g, access, pr.LR, comm_dtype=wire,
                                        seed=seed, zero=zero)
        elif plane == "packed":
            pulled, index, over = jax_hybrid.pull_hybrid_packed(jm, hs, r, pr.TAIL_CAP,
                                                                comm_dtype=wire)
            hs, d = jax_hybrid.push_hybrid_packed(jm, hs, r, g, access, pr.LR, pr.TAIL_CAP,
                                                  index=index, comm_dtype=wire, seed=seed,
                                                  zero=zero)
            dropped = over + d
        elif plane == "bucketed":
            hs, dropped = jax_hybrid.push_hybrid_packed_bucketed(
                jm, hs, r, g, access, pr.LR, slack=2.0, comm_dtype=wire, seed=seed, zero=zero)
        else:
            pulled = jax_hybrid.pull_hybrid_packed_small(jm, hs, r, pr.SMALL_DIM,
                                                         comm_dtype=wire)
            hs = jax_hybrid.push_hybrid_packed_small(jm, hs, r, g, access, pr.LR, pr.SMALL_DIM,
                                                     comm_dtype=wire, seed=seed, zero=zero)
        return pulled, hs, dropped

    # one jit a case: the eager shard_maps would compile op by op
    pulled, hs, dropped = jax.jit(route)(hs, r, g)
    dropped = int(dropped)
    return {"pull": None if pulled is None else np.asarray(pulled),
            "head": np.asarray(hs.head), "tail": np.asarray(hs.tail.table),
            "head_slots": {k: np.asarray(v) for k, v in hs.head_slots.items()},
            "tail_slots": {k: np.asarray(v) for k, v in hs.tail.slots.items()},
            "dropped": dropped}


def _port_case(results, case):
    """A case's pull over the data shards, its head and head slots, its tail
    and tail slots over the model shards (data replica 0), its dropped
    count; every rank's dropped count and head the same."""
    by = by_coords(results, "hybrid")
    for res in by.values():
        assert res[case]["dropped"] == by[(0, 0)][case]["dropped"]
        assert torch.equal(res[case]["head"], by[(0, 0)][case]["head"])
    mine = by[(0, 0)][case]
    pull = (None if mine["pull"] is None
            else torch.cat([by[(i, 0)][case]["pull"] for i in range(2)]).numpy())
    return {"pull": pull, "head": mine["head"].numpy(),
            "tail": torch.cat([by[(0, j)][case]["tail"] for j in range(2)]).numpy(),
            "head_slots": {k: v.numpy() for k, v in mine["head_slots"].items()},
            "tail_slots": {k: torch.cat([by[(0, j)][case]["tail_slots"][k]
                                         for j in range(2)]).numpy()
                           for k in mine["tail_slots"]},
            "dropped": mine["dropped"]}


def _one_step_bound(wire, plane, want, start):
    """Each element's bound under a codec: SGD moves an element by ``lr``
    times its gradient's code, so one code step off moves it by at most
    ``lr`` times a step of its row's scale, which is at most the share of
    the most the row moved (twice that, for terms that cancel); the fused
    AdaGrad tile's values move at most ``lr`` a push either way and its
    accumulator by at most ``(2 + s) s`` times the most it grew."""
    share = STEP_SHARE[wire]
    rows = want.shape[0]
    if plane == "small":
        grown = np.abs(want[:, 1] - start[:, 1]).max(axis=1)
        acc = (2 + share) * share * grown[:, None] + ATOL
        val = np.full((rows, 128), 2 * pr.LR + ATOL)
        return np.stack([val, np.broadcast_to(acc, (rows, 128))], axis=1)
    moved = np.abs(want - start).reshape(rows, -1).max(axis=1)
    return np.broadcast_to((2 * share * moved + ATOL).reshape((rows,) + (1,) * (want.ndim - 1)),
                           want.shape)


@pytest.mark.parametrize("case", list(pr.HYBRID_CASES))
def test_hybrid_routes_match_jax(placement_run, case):
    plane, _, wire, _ = pr.HYBRID_CASES[case]
    got, want = _port_case(placement_run, case), _jax_case(case)
    assert got["dropped"] == want["dropped"]
    if wire == "float32":
        for key in ("pull", "head", "tail"):
            if want[key] is not None:
                np.testing.assert_allclose(got[key], want[key], rtol=RTOL, atol=ATOL,
                                           err_msg=key)
        for key in ("head_slots", "tail_slots"):
            assert sorted(got[key]) == sorted(want[key])
            for k in want[key]:
                np.testing.assert_allclose(got[key][k], want[key][k], rtol=RTOL, atol=ATOL)
        return
    table, _, _, _ = pr.hybrid_inputs(plane)
    whole_got = np.concatenate([got["head"], got["tail"]])
    whole_want = np.concatenate([want["head"], want["tail"]])
    bound = _one_step_bound(wire, plane, whole_want, table)
    excess = np.abs(whole_got - whole_want) - bound
    assert excess.max() <= 0, f"{case}: past one quantization step by {excess.max()}"
    assert np.isfinite(got["pull"]).all()


@pytest.mark.parametrize("case", [c for c, v in pr.HYBRID_CASES.items() if v[0] != "bucketed"])
def test_hybrid_pulls_read_head_plus_tail(placement_run, case):
    """The pull before any push reads the start table's rows: the head's
    gather and the tail's collective add to each row's value (at f32 bit
    for bit; a narrow wire rounds the tail rows only). On the packed plane
    a tail row past its data shard's unique capacity reads zeros."""
    plane, _, wire, _ = pr.HYBRID_CASES[case]
    table, _, rows, _ = pr.hybrid_inputs(plane)
    got = _port_case(placement_run, case)["pull"]
    if plane == "small":
        lanes = table[:, 0].reshape(-1, 4, 32)
        want = lanes[rows // 4, rows % 4, :pr.SMALL_DIM]
    else:
        want = table[rows]
    head = rows < pr.CUT
    np.testing.assert_array_equal(got[head], want[head])
    if wire != "float32":
        return
    flat = got.reshape(len(rows), -1)
    read = (flat == want.reshape(len(rows), -1)).all(axis=1)
    zeros = (flat == 0).all(axis=1) & ~head
    assert (read | (zeros if plane == "packed" else False)).all()
    assert read.sum() > len(rows) // 2


@pytest.mark.parametrize("case", list(pr.HYBRID_CASES))
def test_head_push_billed_to_the_jax_scope(placement_run, case):
    """The head's reduce is counted under ``ssn_hybrid_head_push``, or
    ``ssn_zero_head_push`` under zero, on every rank; its bytes are
    ``head_push_bytes``'."""
    from swiftsnails_tpu_torch.parallel.hybrid import head_push_bytes

    plane, acc, wire, zero = pr.HYBRID_CASES[case]
    name = "ssn_zero_head_push" if zero else "ssn_hybrid_head_push"
    cut_t = pr.CUT // (4 if plane == "small" else 1)
    row = {"dense": pr.DENSE_DIM, "small": 128}.get(plane, 256)  # the buffer's row
    param = {"dense": pr.DENSE_DIM}.get(plane, 256)  # the head's stored row
    reduces = 2 if (plane == "dense" and acc == "adagrad") else 1
    want = head_push_bytes(cut_t, row, param, 2, wire, zero=zero, reduces=reduces)
    for res in by_coords(placement_run, "hybrid").values():
        assert res[case]["scopes"][name] == want


# ------------------------------------------------------ the grouped plane ---


@functools.lru_cache(maxsize=None)
def _jax_grouped(route):
    """The JAX hybrid trainer's ``train_step`` under jit on a (2, 2) virtual
    mesh from the shared start tables, the split adopted and merged back
    as the port's run does, every substep drawing the route's pools."""
    tables, calls, pools = pr.grouped_inputs(route)
    jm = _jax_mesh()
    ids, vocab = jax_paired_corpus(n_pairs=ranks.GROUPED_CAP // 2, reps=ranks.GROUPED_REPS,
                                   seed=0)
    conf = ranks.grouped_conf(**pr.grouped_hybrid_conf(route))
    conf.pop("use_native")
    jt = jax_w2v.Word2VecTrainer(JaxConfig(conf), mesh=jm, corpus_ids=ids, vocab=vocab)
    sharding = jax.sharding.NamedSharding(jm, jax.sharding.PartitionSpec("model", None, None))
    state = jax_w2v.W2VState(
        *(jax_store.PackedTableState(table=jax.device_put(jnp.asarray(t), sharding), slots={})
          for t in tables))
    pm = JaxPlacementManager(jt, jm)
    state = pm.adopt(state)
    losses, dropped = [], []
    with pytest.MonkeyPatch.context() as mpatch:
        mpatch.setattr(jax_w2v, "alias_sample", lambda alias, key, shape: jnp.asarray(pools))
        fn = jax.jit(jt.train_step)
        for c in calls:
            state, met = fn(state, {k: jnp.asarray(v) for k, v in c.items()},
                            jax.random.PRNGKey(0))
            losses.append(float(met["loss"]))
            dropped.append({k: int(v) for k, v in met.items() if k.endswith("_dropped")})
    state = pm.master_state(state)
    return [np.asarray(t.table) for t in state], losses, dropped, jt.placement_cut


def _grouped(results, key, route):
    """A route's merged tables (the model shards of data replica 0; every
    replica equal), losses and dropped counts (every rank's equal)."""
    by = by_coords(results, key)
    for (i, j), res in by.items():
        for a, b in zip(res[route]["tables"], by[(0, j)][route]["tables"]):
            assert torch.equal(a, b), (route, i, j)
        assert res[route]["losses"] == by[(0, 0)][route]["losses"]
        assert res[route]["dropped"] == by[(0, 0)][route]["dropped"]
    tables = [torch.cat([by[(0, j)][route]["tables"][k] for j in range(2)]).numpy()
              for k in range(2)]
    return tables, by[(0, 0)][route]


@pytest.mark.parametrize("route", list(pr.GROUPED_HYBRID))
def test_grouped_hybrid_matches_jax(placement_run, route):
    got, res = _grouped(placement_run, "grouped", route)
    want, losses, dropped, cut = _jax_grouped(route)
    assert res["cut"] == cut == pr.HYBRID_HEAD
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(res["losses"], losses, rtol=RTOL, atol=ATOL)
    assert res["dropped"] == dropped


def test_a_tight_tail_cap_overflows(placement_run):
    """``placement_tail_cap`` below a substep's distinct tail rows drops
    some, counted in ``hybrid_dropped`` (as the JAX trainer counts them,
    above); at the auto cap nothing drops."""
    _, tight = _grouped(placement_run, "grouped", "tight")
    _, plain = _grouped(placement_run, "grouped", "grouped")
    assert all(d["hybrid_dropped"] > 0 for d in tight["dropped"])
    assert all(d == {"hybrid_dropped": 0} for d in plain["dropped"])


@pytest.mark.parametrize("route", ["grouped", "overlap2"])
def test_grouped_hybrid_matches_uniform(placement_run, route):
    got, res = _grouped(placement_run, "grouped", route)
    want, uni = _grouped(placement_run, "grouped_uniform", route)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=HYB_RTOL, atol=HYB_ATOL)
    np.testing.assert_allclose(res["losses"], uni["losses"], rtol=HYB_RTOL, atol=HYB_ATOL)


def test_grouped_hybrid_on_one_rank_matches_the_mesh(placement_run):
    """The hybrid grouped plane on a (1, 1) mesh (one rank's head is the
    whole reduce) against the (2, 2) one."""
    got, res = _grouped(placement_run, "grouped", "grouped")
    solo = [r["solo"]["grouped"] for r in placement_run if "grouped" in r["solo"]][0]
    for g, w in zip(got, solo["tables"]):
        np.testing.assert_allclose(g, w.numpy(), rtol=HYB_RTOL, atol=HYB_ATOL)
    assert solo["dropped"] == res["dropped"]


@pytest.mark.parametrize("key,route", [("grouped", r) for r in pr.GROUPED_HYBRID]
                         + [("grouped_zero", "grouped"), ("grouped_zero", "overlap2")])
def test_step_cost_counts_the_hybrid_bytes(placement_run, key, route):
    """``step_cost``'s ``total_bytes`` equals the bytes counted at the
    ``torch.distributed`` call sites, every call on every rank."""
    for res in by_coords(placement_run, key).values():
        for counted, predicted in res[route]["counted"]:
            assert counted == predicted > 0


# ---------------------------------------------------------- the flat routes ---


@functools.lru_cache(maxsize=None)
def _jax_flat(route):
    """The JAX hybrid trainer's substep of a flat route under jit on a (2, 2)
    virtual mesh, the split adopted and merged back, the injected
    negatives (``tests/test_torch_word2vec_mesh.py``'s reference)."""
    jm = _jax_mesh()
    ids, vocab = jax_paired_corpus(n_pairs=8, reps=600, seed=0)
    conf = ranks.w2v_conf(**ranks.W2V_ROUTES[route], placement="hybrid",
                          placement_head_rows=str(pr.FLAT_HEAD))
    conf.pop("use_native")
    jt = jax_w2v.Word2VecTrainer(JaxConfig(conf), mesh=jm, corpus_ids=ids, vocab=vocab)
    tables, steps = ranks.w2v_inputs(route)
    spec = ("model",) + (None,) * (tables[0].ndim - 1)
    kind = jax_store.TableState if route == "dense" else jax_store.PackedTableState
    state = jax_w2v.W2VState(*(kind(table=_put(jm, t, *spec), slots={}) for t in tables))
    pm = JaxPlacementManager(jt, jm)
    state = pm.adopt(state)
    substep = {"dense": jt._substep_dense, "perpair": jt._substep_packed_perpair}.get(
        route, jt._substep_packed)
    fn = jax.jit(substep)
    bs = jax_mesh.batch_sharding(jm)
    losses, dropped = [], []
    for st in steps:
        state, loss, d = fn(state, jax.device_put(st["centers"], bs),
                            jax.device_put(st["contexts"], bs), jax.random.PRNGKey(0),
                            jt.lr, negs=jnp.asarray(st["negs"]))
        losses.append(float(loss))
        dropped.append(int(d))
    state = pm.master_state(state)
    return [np.asarray(t.table) for t in state], losses, dropped


def _flat(results, route, hybrid_on):
    by = {(r["coords"]["data"], r["coords"]["model"]): r["flat"][(route, hybrid_on)]
          for r in results}
    for (i, j), res in by.items():
        assert all(torch.equal(a, b) for a, b in zip(res["tables"], by[(0, j)]["tables"]))
        assert res["losses"] == by[(0, 0)]["losses"]
        for counted, predicted in res["counted"]:
            assert counted == predicted > 0
    tables = [torch.cat([by[(0, j)]["tables"][k] for j in range(2)]).numpy()
              for k in range(2)]
    return tables, by[(0, 0)]


@pytest.mark.parametrize("route", ["dense", "packed", "perpair"])
def test_flat_hybrid_routes_match_jax(placement_run, route):
    """The 2-D plane's ``pull_hybrid`` / ``push_hybrid``, packed+pool's and
    per-pair's packed routes (the out rows' tail over the JAX chunks) with a
    head of 8 of the 16 rows, 3 substeps, against the JAX hybrid substep
    (rtol 1e-5 / atol 1e-6; nothing dropped in either), and against the
    port's uniform route (the hybrid bound); ``step_cost`` counts every
    call's bytes."""
    got, res = _flat(placement_run, route, True)
    want, losses, dropped = _jax_flat(route)
    assert res["cut"] == pr.FLAT_HEAD
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(res["losses"], losses, rtol=RTOL, atol=ATOL)
    assert dropped == [0] * len(losses)
    uni, ures = _flat(placement_run, route, False)
    for g, u in zip(got, uni):
        np.testing.assert_allclose(g, u, rtol=HYB_RTOL, atol=HYB_ATOL)
    np.testing.assert_allclose(res["losses"], ures["losses"], rtol=HYB_RTOL, atol=HYB_ATOL)


# ------------------------------------------------- the 2-D plane, the CTR ---


def _dense_tables(loop):
    return [t.numpy() for t in loop["tables"]]


def test_dense_plane_hybrid_matches_uniform_trainloop(placement_run):
    """``TrainLoop`` merges at the run's end: the (2, 2) hybrid run's
    tables have the uniform layout, within the JAX test's bound of the
    uniform run's (``tests/test_hybrid_placement.py:227-243``)."""
    by = by_coords(placement_run, "dense_loop")
    for res in by.values():
        for h, u in zip(res[True]["tables"], res[False]["tables"]):
            assert h.shape == u.shape
            np.testing.assert_allclose(h.numpy(), u.numpy(), rtol=HYB_RTOL, atol=HYB_ATOL)
        np.testing.assert_allclose(res[True]["losses"], res[False]["losses"],
                                   rtol=HYB_RTOL, atol=HYB_ATOL)


def test_dense_plane_hybrid_matches_uniform_on_one_rank(placement_run):
    solo = [r["solo"]["dense_loop"] for r in placement_run if "dense_loop" in r["solo"]][0]
    for h, u in zip(solo[True]["tables"], solo[False]["tables"]):
        np.testing.assert_allclose(h.numpy(), u.numpy(), rtol=HYB_RTOL, atol=HYB_ATOL)


def test_ctr_small_row_hybrid_matches_uniform(placement_run):
    """logreg on the small-row plane with a head of 1,024 hash slots
    against the uniform run (``tests/test_hybrid_placement.py:246-275``)."""
    by = by_coords(placement_run, "ctr")
    for res in by.values():
        assert res["hybrid"]["cut"] == 1024 and res["uniform"]["cut"] == 0
        for k, u in res["uniform"]["state"].items():
            h = res["hybrid"]["state"][k]
            assert h.shape == u.shape, k
            np.testing.assert_allclose(h.numpy(), u.numpy(), rtol=HYB_RTOL, atol=HYB_ATOL,
                                       err_msg=k)
        assert len(res["hybrid"]["losses"]) == len(res["uniform"]["losses"]) == 4
