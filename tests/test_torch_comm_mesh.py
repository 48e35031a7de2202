"""The port's trainers under ``comm_dtype`` on a ``(2, 2)`` mesh of gloo
processes, against the JAX package's meshed trainers and against their own
f32 runs, on the CPU.

One module-scope spawn of four ranks (``torch_comm_ranks.wire_worker``)
trains, under f32, bf16, int8 and int4: the grouped plane's plain, dedup,
bucketed (slack 0.05) and ``overlap: 1`` routes, the flat packed+pool,
``neg_mode: per_pair`` and ``packed: 0`` routes, and Wide & Deep, each
from the same start tables, batches and pools as
``tests/test_torch_grouped_mesh.py``, ``tests/test_torch_word2vec_mesh.py``
and ``tests/test_torch_ctr_mesh.py``, with the JAX trainer's own dither
seeds injected (the low word of each substep's key; the CTR push has no
seed, in both packages). The holds:

* against JAX, at f32 within rtol 1e-5 / atol 1e-6 (those tests' bound);
  under a codec the gradients differ from JAX's in f32 rounding, so a rare
  code lands one step away: every table element within ``lr`` times one
  quantization step of the largest row a step moves, summed over the
  steps, the count of differing elements printed; dropped counts equal
  JAX's and the f32 run's;
* word2vec's losses against the f32 run's: bf16 within 1%, int8 2%, int4
  1% (``tests/test_comm_dtype.py:239-249``, ``tests/test_int4_wire.py:304-313``,
  bars the JAX package sets on its grouped mesh plane); W&D's gap to f32
  equal to the JAX trainer's own (it sets no CTR bar);
* the grouped exchange's bytes by scope at least 1.9x (bf16), 3.0x (int8)
  and 6.0x (int4) below f32's, and ``step_cost``'s ``total_bytes`` equal
  to the counted bytes under every wire;
* ``comm_dtype: float32`` bit-identical to the key unset, the 2-D plane
  (``packed: 0``) bit-identical to f32 under any wire (the JAX trainer's
  2-D pull and push take no codec), and on one device any wire
  bit-identical to none;
* ``TrainLoop``'s run record naming the wire and its bytes by scope.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from swiftsnails_tpu.framework.quality import paired_corpus as jax_paired_corpus
from swiftsnails_tpu.models import word2vec as jax_w2v
from swiftsnails_tpu.models.registry import get_model as jax_get_model
from swiftsnails_tpu.models.sparse_base import CTRState as JaxCTRState
from swiftsnails_tpu.parallel import mesh as jax_mesh
from swiftsnails_tpu.parallel import store as jax_store
from swiftsnails_tpu.parallel.comm import seed_from_key
from swiftsnails_tpu.utils.config import Config as JaxConfig
from swiftsnails_tpu_torch import convert
import torch_comm_ranks as cr
import torch_mesh_ranks as ranks
from test_torch_seqlm import spawn_ranks

RTOL, ATOL = 1e-5, 1e-6
SHAPE = {"data": 2, "model": 2}
CODECS = ("bfloat16", "int8", "int4")
LOSS_BARS = {"bfloat16": 0.01, "int8": 0.02, "int4": 0.01}
BYTE_FLOORS = {"bfloat16": 1.9, "int8": 3.0, "int4": 6.0}
torch.set_num_threads(1)


def _grouped_keys(route):
    """The JAX train_step key of each call of a grouped route."""
    return [jax.random.PRNGKey(100 + i) for i in range(ranks.GROUPED_STEPS)]


def _flat_keys():
    return [jax.random.PRNGKey(200 + i) for i in range(ranks.W2V_STEPS)]


def _substep_seeds(key, t):
    """The dither seeds the JAX train_step takes for ``t`` substeps."""
    keys = [key] if t == 1 else list(jax.random.split(key, t))
    return [int(seed_from_key(k)) for k in keys]


def _seeds():
    out = {}
    for route in cr.WIRE_GROUPED:
        t = int(ranks.GROUPED_ROUTES[route].get("steps_per_call", "1"))
        out[("grouped", route)] = [_substep_seeds(k, t) for k in _grouped_keys(route)]
    for route in cr.WIRE_FLAT:
        out[("flat", route)] = [_substep_seeds(k, 1) for k in _flat_keys()]
    return out


@pytest.fixture(scope="module")
def wire_run(tmp_path_factory):
    results = spawn_ranks(cr.wire_worker, 4, tmp_path_factory.mktemp("wire_mesh"), _seeds())
    return {(r["coords"]["data"], r["coords"]["model"]): r for r in results}


def _whole(run, key):
    """A run's tables from the model shards (the data replicas bit-equal),
    and rank (0, 0)'s record (every rank's losses and counts equal)."""
    for (i, j), r in run.items():
        for a, b in zip(r[key]["tables"], run[(0, j)][key]["tables"]):
            assert torch.equal(a, b), (key, i, j)
        assert r[key]["losses"] == run[(0, 0)][key]["losses"]
    tables = [torch.cat([run[(0, j)][key]["tables"][k] for j in range(2)]).numpy()
              for k in range(2)]
    return tables, run[(0, 0)][key]


# ------------------------------------------------------------ JAX side ---


@functools.lru_cache(maxsize=None)
def _jax_grouped(route, wire):
    """The JAX trainer's ``train_step`` under jit on a (2, 2) virtual mesh,
    every substep drawing the route's pools (``alias_sample`` patched, as
    ``tests/test_torch_grouped_mesh.py`` does)."""
    tables, calls, pools = ranks.grouped_inputs(route)
    jm = jax_mesh.make_mesh(SHAPE, devices=jax.devices()[:4])
    ids, vocab = jax_paired_corpus(n_pairs=ranks.GROUPED_CAP // 2, reps=ranks.GROUPED_REPS,
                                   seed=0)
    conf = ranks.grouped_conf(**ranks.GROUPED_ROUTES[route], comm_dtype=wire)
    conf.pop("use_native")
    jt = jax_w2v.Word2VecTrainer(JaxConfig(conf), mesh=jm, corpus_ids=ids, vocab=vocab)
    sharding = jax.sharding.NamedSharding(jm, jax.sharding.PartitionSpec("model", None, None))
    state = jax_w2v.W2VState(
        *(jax_store.PackedTableState(table=jax.device_put(jnp.asarray(t), sharding), slots={})
          for t in tables))
    losses, dropped = [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_w2v, "alias_sample", lambda alias, key, shape: jnp.asarray(pools))
        fn = jax.jit(jt.train_step)
        for c, key in zip(calls, _grouped_keys(route)):
            state, m = fn(state, {k: jnp.asarray(v) for k, v in c.items()}, key)
            losses.append(float(m["loss"]))
            dropped.append({k: int(v) for k, v in m.items() if k.endswith("_dropped")})
    return [np.asarray(t.table) for t in state], losses, dropped


@functools.lru_cache(maxsize=None)
def _jax_flat(route, wire):
    """The JAX trainer's substep under jit on a (2, 2) virtual mesh with the
    step's ``negs`` (``tests/test_torch_word2vec_mesh.py``'s harness)."""
    jm = jax_mesh.make_mesh(SHAPE, devices=jax.devices()[:4])
    ids, vocab = jax_paired_corpus(n_pairs=8, reps=600, seed=0)
    conf = ranks.w2v_conf(**ranks.W2V_ROUTES[route], comm_dtype=wire)
    conf.pop("use_native")
    jt = jax_w2v.Word2VecTrainer(JaxConfig(conf), mesh=jm, corpus_ids=ids, vocab=vocab)
    tables, steps = ranks.w2v_inputs(route)
    spec = jax.sharding.PartitionSpec("model", *([None] * (tables[0].ndim - 1)))
    put = lambda a: jax.device_put(jnp.asarray(a), jax.sharding.NamedSharding(jm, spec))  # noqa: E731
    kind = jax_store.TableState if route == "dense" else jax_store.PackedTableState
    state = jax_w2v.W2VState(kind(table=put(tables[0]), slots={}),
                             kind(table=put(tables[1]), slots={}))
    substep = {"dense": jt._substep_dense, "perpair": jt._substep_packed_perpair}.get(
        route, jt._substep_packed)
    fn = jax.jit(substep)
    bs = jax_mesh.batch_sharding(jm)
    losses = []
    for s, key in zip(steps, _flat_keys()):
        state, loss, _ = fn(state, jax.device_put(s["centers"], bs),
                            jax.device_put(s["contexts"], bs), key, jt.lr,
                            negs=jnp.asarray(s["negs"]))
        losses.append(float(loss))
    return [np.asarray(t.table) for t in state], losses


def _put(jm, a, *spec):
    return jax.device_put(jnp.asarray(a),
                          jax.sharding.NamedSharding(jm, jax.sharding.PartitionSpec(*spec)))


@functools.lru_cache(maxsize=None)
def _jax_widedeep(wire):
    """Wide & Deep's ``train_step`` under jit on a (2, 2) virtual mesh from
    the port's start state (``tests/test_torch_ctr_mesh.py``'s harness)."""
    jm = jax_mesh.make_mesh(SHAPE, devices=jax.devices()[:4])
    jt = jax_get_model("widedeep")(JaxConfig(ranks.ctr_conf("widedeep", comm_dtype=wire)),
                                   mesh=jm, data=ranks.ctr_data("widedeep"))
    st = ranks.ctr_start("widedeep")
    table = jax_store.PackedTableState(table=_put(jm, st["table"], "model", None, None),
                                       slots={})
    dense = {k: _put(jm, v) for k, v in st["dense"].items()}
    opt = jax.device_put(jt.dense_opt.init(dense),
                         jax.sharding.NamedSharding(jm, jax.sharding.PartitionSpec()))
    state = JaxCTRState(table=table, dense=dense, opt=opt)
    fn = jax.jit(jt.train_step)
    losses = []
    for b in ranks.ctr_global_batches("widedeep"):
        batch = {"labels": _put(jm, b["labels"], "data"), "feats": _put(jm, b["feats"], "data")}
        state, m = fn(state, batch, jax.random.PRNGKey(0))
        losses.append(float(m["loss"]))
    arrays = {"table": np.asarray(state.table.table)}
    arrays.update({f"dense.{k}": np.asarray(v) for k, v in state.dense.items()})
    arrays.update({f"opt.{k}": np.asarray(v) for k, v in state.opt[0].sum_of_squares.items()})
    return arrays, losses


# ------------------------------------------------------------- the holds ---


def _step_bound(wire: str, tables: list, starts: list, steps: int) -> float:
    """``lr`` times one quantization step of the largest row update, summed
    over ``steps``, as an absolute bound: the largest element a table moved
    in the run over ``steps`` is a step's ``lr * g`` at most ``steps``
    times over; one code off moves an element by that over 127 (int8), 7
    (int4) or 2^8 (bf16), once a step."""
    moved = max(float(np.abs(t - s).max()) for t, s in zip(tables, starts))
    per = {"bfloat16": 2.0 ** -7, "int8": 1 / 127, "int4": 1 / 7}[wire]
    return 2.0 * per * moved + ATOL


def _report(what, got, want):
    n = sum(int((np.abs(g - w) > ATOL).sum()) for g, w in zip(got, want))
    size = sum(g.size for g in got)
    diff = max(float(np.abs(g - w).max()) for g, w in zip(got, want))
    print(f"{what}: {n} of {size} elements differ from JAX's past {ATOL}, "
          f"the largest by {diff:.3g}")
    return diff


@pytest.mark.parametrize("wire", ("float32",) + CODECS)
@pytest.mark.parametrize("route", cr.WIRE_GROUPED)
def test_grouped_routes_match_jax(wire_run, route, wire):
    got, rec = _whole(wire_run, ("grouped", route, wire))
    want, losses, dropped = _jax_grouped(route, wire)
    starts, _, _ = ranks.grouped_inputs(route)
    if wire == "float32":
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(rec["losses"], losses, rtol=RTOL, atol=ATOL)
    else:
        diff = _report(f"grouped {route} {wire}", got, want)
        assert diff <= _step_bound(wire, want, starts, ranks.GROUPED_STEPS)
        np.testing.assert_allclose(rec["losses"], losses, rtol=1e-3)
    assert rec["dropped"] == dropped
    f32 = wire_run[(0, 0)][("grouped", route, "float32")]
    assert rec["dropped"] == f32["dropped"]


@pytest.mark.parametrize("wire", ("float32",) + CODECS)
@pytest.mark.parametrize("route", cr.WIRE_FLAT)
def test_flat_routes_match_jax(wire_run, route, wire):
    got, rec = _whole(wire_run, ("flat", route, wire))
    want, losses = _jax_flat(route, wire)
    starts, _ = ranks.w2v_inputs(route)
    if wire == "float32" or route == "dense":
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(rec["losses"], losses, rtol=RTOL, atol=ATOL)
    else:
        diff = _report(f"flat {route} {wire}", got, want)
        assert diff <= _step_bound(wire, want, starts, ranks.W2V_STEPS)
        np.testing.assert_allclose(rec["losses"], losses, rtol=1e-3)


@pytest.mark.parametrize("wire", ("float32",) + CODECS)
def test_widedeep_matches_jax(wire_run, wire):
    rec = wire_run[(0, 0)][("ctr", "widedeep", wire)]
    got = {k: (torch.cat([wire_run[(0, j)][("ctr", "widedeep", wire)]["arrays"][k]
                          for j in range(2)]) if k in ("table", "slot.accum") else v).numpy()
           for k, v in rec["arrays"].items()}
    want, losses = _jax_widedeep(wire)
    start = ranks.ctr_start("widedeep")
    for name, w in want.items():
        if wire == "float32" or name != "table":
            tol = RTOL if wire == "float32" else 1e-3
            np.testing.assert_allclose(got[name], w, rtol=tol, atol=ATOL if wire == "float32"
                                       else 1e-4, err_msg=name)
        else:
            diff = _report(f"widedeep {wire}", [got[name]], [w])
            assert diff <= _step_bound(wire, [w], [start["table"]], ranks.CTR_STEPS)
    np.testing.assert_allclose(rec["losses"], losses, rtol=RTOL if wire == "float32" else 1e-3)


@pytest.mark.parametrize("wire", CODECS)
@pytest.mark.parametrize("kind,route", [("grouped", r) for r in cr.WIRE_GROUPED]
                         + [("flat", "packed"), ("flat", "perpair")])
def test_losses_within_the_wires_bars_of_f32(wire_run, kind, route, wire):
    """The last step's loss under the wire against the f32 run's, within
    the JAX package's bars for word2vec's mesh planes."""
    f32 = wire_run[(0, 0)][(kind, route, "float32")]["losses"][-1]
    got = wire_run[(0, 0)][(kind, route, wire)]["losses"][-1]
    assert abs(got - f32) / abs(f32) < LOSS_BARS[wire], (got, f32)


@pytest.mark.parametrize("wire", CODECS)
def test_widedeep_loss_gap_is_jaxs(wire_run, wire):
    """The JAX package sets no loss bar for the CTR plane, and its own W&D
    misses the word2vec bar at int4 here (dim 17 rows in 32-lane blocks):
    the port's gap to f32 is held to the JAX trainer's gap and printed."""
    f32 = wire_run[(0, 0)][("ctr", "widedeep", "float32")]["losses"][-1]
    got = wire_run[(0, 0)][("ctr", "widedeep", wire)]["losses"][-1]
    j32, jgot = _jax_widedeep("float32")[1][-1], _jax_widedeep(wire)[1][-1]
    gap, jgap = (got - f32) / abs(f32), (jgot - j32) / abs(j32)
    print(f"widedeep {wire}: loss {gap:+.4%} from f32 (JAX {jgap:+.4%})")
    assert abs(gap - jgap) < 1e-3, (gap, jgap)


@pytest.mark.parametrize("wire", CODECS)
def test_grouped_exchange_bytes_fall_past_the_floors(wire_run, wire):
    """The grouped plane's exchange, the collectives in ``ssn_*`` scopes of
    a step, on every rank."""
    for r in wire_run.values():
        for f32, narrow in zip(r[("grouped", "grouped", "float32")]["scopes"],
                               r[("grouped", "grouped", wire)]["scopes"]):
            ratio = sum(f32.values()) / sum(narrow.values())
            assert ratio >= BYTE_FLOORS[wire], (wire, ratio, narrow)
            assert sorted(f32) == sorted(narrow) == [
                "ssn_pull_collective_packed", "ssn_push_collective_packed"]


@pytest.mark.parametrize("wire", cr.MESH_WIRES + (None,))
def test_step_cost_counts_the_wire_bytes(wire_run, wire):
    """``step_cost``'s ``total_bytes`` equals the bytes counted at the
    ``torch.distributed`` call sites, every call of every route on every
    rank."""
    n = 0
    for r in wire_run.values():
        for key, rec in r.items():
            if isinstance(key, tuple) and key[2] == wire:
                for counted, predicted in rec["counted"]:
                    assert counted == predicted > 0, key
                    n += 1
    assert n > 0


def test_spread_routes_move_more_bytes_under_a_codec(wire_run):
    """The spread pushes of the out rows reduce-scatter the f32 partial
    sums (``ssn_spread_reduce_scatter``), as many bytes as f32's one
    all-reduce of them, before the narrow gather: that push moves more
    under a codec than under f32 (ROADMAP.md, Queue 3)."""
    from swiftsnails_tpu_torch.parallel.transfer import bucket_capacity

    r = wire_run[(0, 0)]
    slack = float(ranks.GROUPED_ROUTES["bucketed_tight"]["bucket_slack"])
    n_out = 256 // 2 * 4 + (256 // 2 // 64) * 8  # a rank's window slots and pools
    f32_out = {"dedup": r[("grouped", "dedup", "float32")]["scopes"][0][
                   "ssn_push_collective_packed_dedup"],
               "bucketed_tight": 2 * bucket_capacity(n_out, 2, slack) * 128 * 4}
    for route, f32 in f32_out.items():
        assert "ssn_spread_reduce_scatter" not in r[("grouped", route, "float32")]["scopes"][0]
        for wire in CODECS:
            narrow = r[("grouped", route, wire)]["scopes"][0]
            assert narrow["ssn_spread_reduce_scatter"] == f32 > 0, (route, wire)


@pytest.mark.parametrize("kind,route", [("grouped", "grouped"), ("flat", "packed")])
def test_float32_is_the_key_unset(wire_run, kind, route):
    for r in wire_run.values():
        unset, f32 = r[(kind, route, None)], r[(kind, route, "float32")]
        assert all(torch.equal(a, b) for a, b in zip(unset["tables"], f32["tables"]))
        assert unset["losses"] == f32["losses"]


@pytest.mark.parametrize("wire", CODECS)
def test_the_2d_plane_keeps_f32(wire_run, wire):
    for r in wire_run.values():
        a, b = r[("flat", "dense", wire)], r[("flat", "dense", "float32")]
        assert all(torch.equal(x, y) for x, y in zip(a["tables"], b["tables"]))
        assert a["losses"] == b["losses"] and a["counted"] == b["counted"]


@pytest.mark.parametrize("wire", CODECS + ("int4/16",))
@pytest.mark.parametrize("route", ["grouped", "packed", "widedeep"])
def test_one_device_ignores_the_wire(wire, route):
    """Without a mesh there are no collectives: a run with the key is a
    run without it, bit for bit."""
    def run(**over):
        if route == "widedeep":
            tr = ranks.ctr_trainer("widedeep", **over)
            batches = ranks.ctr_global_batches("widedeep")
        elif route == "grouped":
            tr = ranks.grouped_trainer("grouped", **over)
            _, batches, pools = ranks.grouped_inputs("grouped")
        else:
            tr = ranks.w2v_trainer("packed", **over)
            _, batches = ranks.w2v_inputs("packed")
        state, losses = tr.init_state(), []
        for b in batches[:2]:
            batch = {k: torch.from_numpy(v) for k, v in b.items()}
            if route == "grouped":
                batch["negs"] = torch.from_numpy(pools)
            args = (torch.Generator().manual_seed(3),) if route != "widedeep" else ()
            state, m = tr.train_step(state, batch, *args)
            losses.append(float(m["loss"]))
        return state, losses

    (a, la), (b, lb) = run(), run(comm_dtype=wire)
    assert la == lb
    for x, y in zip(convert_leaves(a), convert_leaves(b)):
        assert torch.equal(x, y)


def convert_leaves(state):
    from swiftsnails_tpu_torch.utils.tree import tensor_items

    return [t for _, t in tensor_items(state)]


def test_the_loop_records_the_wire_and_its_bytes_by_scope(wire_run):
    for r in wire_run.values():
        rec = r["loop"]
        assert rec["comm_dtype"] == "int8"
        scopes = rec["comm_by_scope"]
        assert sorted(scopes) == ["ssn_out_layout", "ssn_pull_collective_packed",
                                  "ssn_pull_collective_packed_dedup",
                                  "ssn_push_collective_packed",
                                  "ssn_push_collective_packed_dedup",
                                  "ssn_spread_reduce_scatter"]
        assert all(v > 0 for v in scopes.values())
