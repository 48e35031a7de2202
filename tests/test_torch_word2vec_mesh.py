"""The port's word2vec under a ``(2, 2)`` mesh of gloo processes against
its one-device trainer and against the JAX trainer's meshed step, on the
CPU.

Four routes (``packed: 0`` through the 2-D collectives; ``packed+pool``,
``neg_mode: per_pair`` and flat ``fused: 1`` through the packed ones) train
3 steps from the same start tables, batches and injected negatives (the
batch's ``negs``: the step's whole draw, of which each data shard takes
its part). The JAX side calls its substep with the same ``negs`` under
``jit`` on a ``(2, 2)`` mesh of virtual devices, the setup of
``tests/test_word2vec.py``'s sharded-mesh test, since its ``train_step``
draws by threefry; its ``fused: 1`` under a mesh is that substep too, so
the port's flat fused route is held against the one-device packed+pool
step. Tables and losses within rtol 1e-5 / atol 1e-6. Then ``TrainLoop``
with two substeps a call against the one-device loop, ``export_text``
written once, ``step_cost``'s collective bytes against the counted ones,
and the keys that still raise under a mesh (the grouped plane, the
bucketed push and ``overlap``: ``tests/test_torch_grouped_mesh.py``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from swiftsnails_tpu.framework.quality import paired_corpus as jax_paired_corpus
from swiftsnails_tpu.models import word2vec as jax_w2v
from swiftsnails_tpu.parallel import mesh as jax_mesh
from swiftsnails_tpu.parallel import store as jax_store
from swiftsnails_tpu.utils.config import Config as JaxConfig
from swiftsnails_tpu_torch import convert
from swiftsnails_tpu_torch.framework.trainer import TrainLoop
from swiftsnails_tpu_torch.parallel.mesh import Mesh
import torch_mesh_ranks as ranks
from test_torch_seqlm import spawn_ranks

RTOL, ATOL = 1e-5, 1e-6
SHAPE = {"data": 2, "model": 2}
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("w2v_mesh")
    return tmp, spawn_ranks(ranks.w2v_worker, 4, tmp, SHAPE)


def _whole(results, key):
    """A route's tables from the model shards (data replicas equal)."""
    by = {(r["coords"]["data"], r["coords"]["model"]): r[key] for r in results}
    for (i, j), res in by.items():
        for a, b in zip(res["tables"], by[(0, j)]["tables"]):
            assert torch.equal(a, b), (key, i, j)
        assert res["losses"] == by[(0, 0)]["losses"]
    tables = [torch.cat([by[(0, j)]["tables"][k] for j in range(2)]).numpy()
              for k in range(2)]
    return tables, by[(0, 0)]["losses"]


def _single_device(route):
    """The port on one device; the flat fused route's reference is the
    packed+pool step (its route under a mesh)."""
    tr = ranks.w2v_trainer("packed" if route == "fused" else route)
    tables, _ = ranks.w2v_inputs(route)
    state = convert.w2v_state_from_numpy(*tables, device="cpu")
    state, losses, _ = ranks.w2v_steps(tr, route, state)
    return [t.table.numpy() for t in state], losses


def _jax_meshed(route):
    """The JAX trainer's substep under jit on a (2, 2) virtual mesh."""
    jm = jax_mesh.make_mesh(SHAPE, devices=jax.devices()[:4])
    ids, vocab = jax_paired_corpus(n_pairs=8, reps=600, seed=0)
    conf = ranks.w2v_conf(**ranks.W2V_ROUTES[route])
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
    for s in steps:
        state, loss, _ = fn(state, jax.device_put(s["centers"], bs),
                            jax.device_put(s["contexts"], bs), jax.random.PRNGKey(0),
                            jt.lr, negs=jnp.asarray(s["negs"]))
        losses.append(float(loss))
    return [np.asarray(t.table) for t in state], losses


@pytest.mark.parametrize("route", list(ranks.W2V_ROUTES))
def test_meshed_steps_match_single_device(mesh_run, route):
    _, results = mesh_run
    got, losses = _whole(results, route)
    want, want_losses = _single_device(route)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(losses, want_losses, rtol=RTOL, atol=ATOL)
    if route != "dense":  # the padding lanes stay zero
        assert not any(g.reshape(16, -1)[:, 16:].any() for g in got)


@pytest.mark.parametrize("route", list(ranks.W2V_ROUTES))
def test_meshed_steps_match_jax_meshed(mesh_run, route):
    _, results = mesh_run
    got, losses = _whole(results, route)
    want, want_losses = _jax_meshed(route)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(losses, want_losses, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("route", list(ranks.W2V_ROUTES))
def test_step_cost_counts_the_collective_bytes(mesh_run, route):
    """``step_cost``'s ``total_bytes`` equals the bytes counted at the
    ``torch.distributed`` call sites, every step on every rank."""
    _, results = mesh_run
    for r in results:
        for counted, predicted in r[route]["counted"]:
            assert counted == predicted > 0


def test_train_loop_matches_single_device(mesh_run):
    """``TrainLoop`` (3 calls of 2 substeps, pools drawn from the step's
    generator on every rank) against the one-device loop; ``export_text``
    written once, by rank 0, with the one-device rows."""
    tmp, results = mesh_run
    got, losses = _whole(results, "loop")
    tr = ranks.w2v_trainer("packed", **ranks.W2V_LOOP)
    state, want_losses = ranks.w2v_loop(tr)
    for g, w in zip(got, state):
        np.testing.assert_allclose(g, w.table.numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(losses, want_losses, rtol=RTOL, atol=ATOL)
    one = tmp / "one.txt"
    tr.export_text(state, str(one))
    lines, want = (tmp / "vectors.txt").read_text().splitlines(), one.read_text().splitlines()
    assert len(lines) == len(want) == 17 and lines[0] == want[0]
    for a, b in zip(lines[1:], want[1:]):
        assert a.split()[0] == b.split()[0]
        np.testing.assert_allclose(np.array(a.split()[1:], float),
                                   np.array(b.split()[1:], float), atol=2e-6)


def _hand_mesh(data=2, model=2):
    return Mesh(shape={"data": data, "model": model}, coords={"data": 0, "model": 0},
                groups={}, device=torch.device("cpu"))


@pytest.mark.parametrize("over", [
    {"comm_dtype": "bfloat16"}, {"comm_dtype": "int8"}, {"placement": "hybrid"},
    {"table_tier": "host"},
], ids=lambda o: ",".join(f"{k}={v}" for k, v in o.items()))
def test_unported_keys_raise_under_a_mesh(over):
    """``comm_dtype``, ``placement`` and ``table_tier: host`` are ported
    since this test was written: for them the test holds that the meshed
    trainer takes the key (``tests/test_torch_tier_mesh.py`` trains the
    tier under a mesh)."""
    if "comm_dtype" in over:
        tr = ranks.w2v_trainer("packed", _hand_mesh(), **over)
        assert tr.comm_dtype == over["comm_dtype"] and tr.mesh is not None
        return
    if "placement" in over:
        tr = ranks.w2v_trainer("packed", _hand_mesh(), **over)
        assert tr.placement_cut > 0 and tr.placement_spec() is not None
        return
    tr = ranks.w2v_trainer("packed", _hand_mesh(), **over)
    assert tr.tiered and tr.mesh is not None and tr.tier_spec() is not None


@pytest.mark.parametrize("over", [
    {"guardrail": "1"},
    {"freshness_publish": "4", "freshness_dir": "d"}, {"cluster_workers": "1"},
], ids=lambda o: next(iter(o)))
def test_loop_keys_build_their_guard_under_a_mesh(over):
    """The loop's guards are ported under a mesh since this test was
    written: it holds that ``TrainLoop`` builds each on the meshed trainer
    (``tests/test_torch_guards_mesh.py`` runs them on a ``(2, 2)`` mesh)."""
    tr = ranks.w2v_trainer("packed", _hand_mesh(), **over)
    loop = TrainLoop(tr)
    built = {"guardrail": lambda: loop.guardrail is not None and loop.guardrail.mesh is tr.mesh,
             "freshness_publish": lambda: loop.freshness is not None
             and loop.freshness.mesh is tr.mesh,
             "cluster_workers": lambda: loop.cluster is not None and loop.leader}
    assert built[next(iter(over))]()


def test_a_pool_block_may_not_straddle_data_shards():
    tr = ranks.w2v_trainer("packed", _hand_mesh(data=8, model=1))
    batch = {"centers": torch.zeros(32, dtype=torch.int32),
             "contexts": torch.zeros(32, dtype=torch.int32)}
    with pytest.raises(ValueError, match="pool block"):
        tr.train_step(tr.init_state(), batch, torch.Generator())


def test_local_batch_takes_each_substeps_part():
    tr = ranks.w2v_trainer("packed", Mesh(shape=SHAPE, coords={"data": 1, "model": 0},
                                          groups={}, device=torch.device("cpu")),
                           **ranks.W2V_LOOP)
    batch = {"centers": np.arange(256), "contexts": np.arange(256) + 1000,
             "progress": np.float32(0.5), "pools": np.zeros((3, 8))}
    got = tr.local_batch(batch)
    np.testing.assert_array_equal(got["centers"], np.r_[64:128, 192:256])
    np.testing.assert_array_equal(got["contexts"], np.r_[64:128, 192:256] + 1000)
    assert got["progress"] == batch["progress"] and got["pools"] is batch["pools"]
