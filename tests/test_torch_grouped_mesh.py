"""The port's grouped word2vec plane under a ``(2, 2)`` mesh of gloo
processes, its dedup and owner-bucketed collectives and the overlap
macro-step, against the JAX package's meshed step and against a ``(1, 1)``
mesh of the port, on the CPU.

One module-scope spawn of four ranks (``torch_mesh_ranks.grouped_worker``)
runs every route of ``GROUPED_ROUTES`` from the same start tables, batches
(windows with ``-1`` pads) and pools, 3 calls each; the transfer-level
cases; ``TrainLoop`` on the plane; and, on a ``(1, 1)`` mesh of each rank
alone, the routes that drop nothing and the loop.

The JAX side runs ``train_step`` under ``jit`` on a ``(2, 2)`` mesh of
virtual devices, one ``jit`` a route. It draws its pools inside the step,
so the test patches the name ``alias_sample`` in
``swiftsnails_tpu.models.word2vec`` with ``pytest.MonkeyPatch`` (no file
changes) to return the route's pools: under ``lax.scan`` that constant is
every substep's pool set, and the port is given the same in the batch's
``negs``. Tables and losses within rtol 1e-5 / atol 1e-6, the
``dedup_dropped`` / ``push_dropped`` integers equal. The JAX word2vec
trainer splits its out rows over ``data`` as chunks of one concatenation
(every shard's windows, then the pools), which the port's ``*_spread``
collectives follow: the dropped counts only match where the chunks do.
"""

import functools
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
from swiftsnails_tpu.parallel.access import SgdAccess as JaxSgd
from swiftsnails_tpu.utils.config import Config as JaxConfig
from swiftsnails_tpu_torch.framework.quality import paired_corpus
from swiftsnails_tpu_torch.models.word2vec import Word2VecTrainer
from swiftsnails_tpu_torch.parallel.mesh import Mesh
from swiftsnails_tpu_torch.utils.config import Config
import torch_mesh_ranks as ranks
from test_torch_seqlm import SPAWN_TIMEOUT_S, spawn_ranks

RTOL, ATOL = 1e-5, 1e-6
SHAPE = {"data": 2, "model": 2}
ROUTES = list(ranks.GROUPED_ROUTES)
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def grouped_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("grouped_mesh")
    return spawn_ranks(ranks.grouped_worker, 4, tmp, SHAPE)


def _whole(results, key):
    """A route's tables from the model shards (the data replicas equal),
    its losses and dropped counts (every rank's equal)."""
    by = {(r["coords"]["data"], r["coords"]["model"]): r[key] for r in results}
    for (i, j), res in by.items():
        for a, b in zip(res["tables"], by[(0, j)]["tables"]):
            assert torch.equal(a, b), (key, i, j)
        assert res["losses"] == by[(0, 0)]["losses"]
        assert res["dropped"] == by[(0, 0)]["dropped"]
    tables = [torch.cat([by[(0, j)]["tables"][k] for j in range(2)]).numpy()
              for k in range(2)]
    return tables, by[(0, 0)]["losses"], by[(0, 0)]["dropped"]


def _solo(results, key):
    """A route's run on the (1, 1) mesh of the rank that made it."""
    found = [r["solo"][key] for r in results if key in r["solo"]]
    assert len(found) == 1, key
    return found[0]


@functools.lru_cache(maxsize=None)
def _jax_meshed(route):
    """The JAX trainer's ``train_step`` under jit on a (2, 2) virtual
    mesh, every substep drawing the route's pools."""
    tables, calls, pools = ranks.grouped_inputs(route)
    jm = jax_mesh.make_mesh(SHAPE, devices=jax.devices()[:4])
    ids, vocab = jax_paired_corpus(n_pairs=ranks.GROUPED_CAP // 2, reps=ranks.GROUPED_REPS, seed=0)
    conf = ranks.grouped_conf(**ranks.GROUPED_ROUTES[route])
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
        for c in calls:
            state, m = fn(state, {k: jnp.asarray(v) for k, v in c.items()},
                          jax.random.PRNGKey(0))
            losses.append(float(m["loss"]))
            dropped.append({k: int(v) for k, v in m.items() if k.endswith("_dropped")})
    return [np.asarray(t.table) for t in state], losses, dropped


@pytest.mark.parametrize("route", ROUTES)
def test_routes_match_jax_meshed(grouped_run, route):
    got, losses, dropped = _whole(grouped_run, route)
    want, want_losses, want_dropped = _jax_meshed(route)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(losses, want_losses, rtol=RTOL, atol=ATOL)
    assert dropped == want_dropped


@pytest.mark.parametrize("route", ranks.GROUPED_EXACT)
def test_routes_match_the_solo_mesh(grouped_run, route):
    """A route that drops nothing gives on the (2, 2) mesh what it gives on
    a (1, 1) one (JAX's own test holds 2e-4 / 2e-6 across shapes)."""
    got, losses, dropped = _whole(grouped_run, route)
    solo = _solo(grouped_run, route)
    for g, w in zip(got, solo["tables"]):
        np.testing.assert_allclose(g, w.numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(losses, solo["losses"], rtol=RTOL, atol=ATOL)
    assert dropped == solo["dropped"]
    assert all(v == 0 for step in dropped for v in step.values())


@pytest.mark.parametrize("route", ROUTES)
def test_step_cost_counts_the_collective_bytes(grouped_run, route):
    """``step_cost``'s ``total_bytes`` equals the bytes counted at the
    ``torch.distributed`` call sites, every call on every rank."""
    for r in grouped_run:
        for counted, predicted in r[route]["counted"]:
            assert counted == predicted > 0
    for counted, predicted in _solo(grouped_run, "grouped")["counted"]:
        assert counted == predicted > 0


def test_dedup_at_the_auto_cap_matches_the_plain_plane(grouped_run):
    """The dedup plane at its auto cap drops nothing and float-matches the
    plain plane (the JAX test ``test_grouped_mesh_dedup_matches_plain``)."""
    plain, plain_losses, _ = _whole(grouped_run, "grouped")
    dedup, losses, dropped = _whole(grouped_run, "dedup")
    assert dropped == [{"dedup_dropped": 0}] * ranks.GROUPED_STEPS
    for g, w in zip(dedup, plain):
        np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-6)
    np.testing.assert_allclose(losses, plain_losses, rtol=2e-4, atol=2e-6)


@pytest.mark.parametrize("route,key,dropping", [
    ("dedup_cap8", "dedup_dropped", True), ("bucketed_tight", "push_dropped", True),
    ("dedup_bucketed", "push_dropped", True), ("packed_bucketed", "push_dropped", True),
    ("bucketed_loose", "push_dropped", False), ("grouped", None, False)])
def test_dropped_metrics(grouped_run, route, key, dropping):
    """The overflow metric a route reports: a cap too small counts its
    dropped rows every call; a loose one, none; no metric without dedup or
    the bucketed push."""
    _, _, dropped = _whole(grouped_run, route)
    for step in dropped:
        assert list(step) == ([key] if key else [])
        assert (step[key] > 0 if dropping else not any(step.values()))


def _transfer_whole(results, case):
    by = {(r["coords"]["data"], r["coords"]["model"]): r["transfer"][case] for r in results}
    res = by[(0, 0)]
    for (i, j), r in by.items():
        assert r["count"] == res["count"]
        assert torch.equal(r["table"], by[(0, j)]["table"])
    table = torch.cat([by[(0, j)]["table"] for j in range(2)]).numpy()
    pulled = index = None
    if res.get("pull") is not None:
        pulled = torch.cat([by[(i, 0)]["pull"] for i in range(2)]).numpy()
    if res.get("index") is not None:
        index = [torch.cat([by[(i, 0)]["index"][k] for i in range(2)]).numpy() for k in range(2)]
    return pulled, table, index, res["count"]


@functools.lru_cache(maxsize=None)
def _jax_transfer(case):
    """JAX's collective of the case on its (2, 2) mesh of virtual devices."""
    kind, arg = ranks.TRANSFER_CASES[case]
    table, rows, grads = ranks.transfer_inputs()
    jm = jax_mesh.make_mesh(SHAPE, devices=jax.devices()[:4])
    spec = jax.sharding.PartitionSpec
    put = lambda a, s: jax.device_put(jnp.asarray(a), jax.sharding.NamedSharding(jm, s))  # noqa: E731
    st = jax_store.PackedTableState(table=put(table, spec("model", None, None)), slots={})
    r, g = put(rows, spec("data")), put(grads, spec("data", None, None))
    pulled = index = None
    if kind in ("pull", "push_index"):
        pulled, index, count = jax_transfer.pull_collective_packed_dedup(jm, st, r, arg)
    if kind in ("push", "push_index"):
        st, dropped = jax_transfer.push_collective_packed_dedup(
            jm, st, r, g, JaxSgd(), ranks.LR, arg, index=index)
        count = dropped if kind == "push" else count
    if kind == "bucketed":
        st, count = jax_transfer.push_collective_packed_bucketed(
            jm, st, r, g, JaxSgd(), ranks.LR, slack=arg)
    return (None if pulled is None else np.asarray(pulled), np.asarray(st.table),
            None if index is None else [np.asarray(x) for x in index], int(count))


@pytest.mark.parametrize("case", list(ranks.TRANSFER_CASES))
def test_transfer_matches_jax(grouped_run, case):
    """``pull/push_collective_packed_dedup`` (with and without ``index=``)
    and ``push_collective_packed_bucketed`` at f32: the pull, its unique
    index and the counts equal JAX's, the tables within rtol 1e-5 / atol
    1e-6."""
    pulled, table, index, count = _transfer_whole(grouped_run, case)
    w_pulled, w_table, w_index, w_count = _jax_transfer(case)
    assert count == w_count
    assert count > 0 if case.endswith(("overflow", "index", "tight")) else count == 0
    np.testing.assert_allclose(table, w_table, rtol=RTOL, atol=ATOL)
    if w_pulled is not None:
        np.testing.assert_array_equal(pulled, w_pulled)
    if w_index is not None:
        for a, b in zip(index, w_index):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("spread,case", [("spread_dedup", "dedup_push_index"),
                                         ("spread_bucketed", "bucketed_tight")])
def test_spread_collectives_match_the_per_shard_ones(grouped_run, spread, case):
    """Over a layout of each rank's own slice, the ``*_spread`` collectives
    give the per-shard ones' pull, table and count."""
    pulled, table, _, count = _transfer_whole(grouped_run, case)
    s_pulled, s_table, _, s_count = _transfer_whole(grouped_run, spread)
    assert s_count == count > 0
    np.testing.assert_allclose(s_table, table, rtol=RTOL, atol=ATOL)
    if s_pulled is not None:
        np.testing.assert_array_equal(s_pulled, pulled)


def test_train_loop_matches_the_solo_mesh(grouped_run):
    """``TrainLoop`` on the dedup plane (3 calls of 2 substeps, pools drawn
    from each step's generator on every rank) against the (1, 1) mesh's
    loop; the records carry ``dedup_dropped`` as the JAX loop's do."""
    by = {(r["coords"]["data"], r["coords"]["model"]): r["loop"] for r in grouped_run}
    solo = _solo(grouped_run, "loop")
    got = [torch.cat([by[(0, j)]["tables"][k] for j in range(2)]).numpy() for k in range(2)]
    for g, w in zip(got, solo["tables"]):
        np.testing.assert_allclose(g, w.numpy(), rtol=RTOL, atol=ATOL)
    records = by[(0, 0)]["records"]
    assert len(records) == 3
    np.testing.assert_allclose([r["loss"] for r in records],
                               [r["loss"] for r in solo["records"]], rtol=RTOL, atol=ATOL)
    assert [r["dedup_dropped"] for r in records] == [0.0] * 3
    for r in grouped_run:
        assert [x["loss"] for x in r["loop"]["records"]] == [x["loss"] for x in records]


def _hand_mesh(data=2, model=2):
    return Mesh(shape={"data": data, "model": model}, coords={"data": 0, "model": 0},
                groups={}, device=torch.device("cpu"))


@pytest.mark.parametrize("over,match", [
    ({"push_mode": "scatter"}, "push_mode must be gather"),
    ({"push_mode": "bucketed", "packed": "0", "fused": "0", "grouped": "0"},
     "bucketed requires packed"),
    ({"push_mode": "bucketed"}, "only with a mesh"),
    ({"overlap": "3"}, "overlap must be 0, 1 or 2"),
    ({"overlap": "1", "grouped": "0"}, r"overlap: 1\|2 requires fused: 1, grouped: 1"),
], ids=["push_mode", "bucketed_2d", "bucketed_fused_one_device", "overlap_depth",
        "overlap_flat"])
def test_validation_errors(over, match):
    """The JAX trainer's checks and messages (``word2vec.py:186-204, 236-247``)."""
    with pytest.raises(ValueError, match=match):
        ranks.grouped_trainer("grouped", **over)


@pytest.mark.parametrize("over", [{"overlap": "true"}, {"overlap": "2"},
                                  {"push_mode": "bucketed", "fused": "0", "grouped": "0"}],
                         ids=["overlap_bool", "overlap_2", "bucketed_packed_one_device"])
def test_accepted_spellings(over):
    tr = ranks.grouped_trainer("grouped", **over)
    assert tr.overlap == int(over.get("overlap", "0").replace("true", "1"))
    assert tr.push_mode == over.get("push_mode", "gather")


def test_one_device_bucketed_reports_nothing_dropped():
    """One device has no push collective: packed+pool with ``push_mode:
    bucketed`` pushes exactly and reports ``push_dropped`` 0, as JAX does."""
    tr = ranks.grouped_trainer("packed_bucketed")
    tables, calls, pools = ranks.grouped_inputs("packed_bucketed")
    from swiftsnails_tpu_torch import convert

    state = convert.w2v_state_from_numpy(*tables, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in calls[0].items()}
    batch["negs"] = torch.from_numpy(pools)
    _, m = tr.train_step(state, batch, torch.Generator())
    assert int(m["push_dropped"]) == 0 and m["push_dropped"].dtype == torch.int32


@pytest.mark.parametrize("over", [
    {"comm_dtype": "int8"}, {"placement": "hybrid"}, {"optimizer_sharding": "zero"},
    {"table_tier": "host", "fused": "0", "grouped": "0"}],
    ids=lambda o: next(iter(o)))
def test_other_plane_keys_still_raise_on_the_grouped_plane(over):
    """``comm_dtype``, ``placement``, ``optimizer_sharding`` and (on the
    flat packed plane: the tier refuses the fused ones) ``table_tier: host``
    are ported since this test was written: for them the test holds that
    the meshed trainer takes the key."""
    if "table_tier" in over:
        tr = ranks.grouped_trainer("grouped", _hand_mesh(), **over)
        assert tr.tiered and not tr.grouped and tr.mesh is not None
        assert tr.tier_spec() == {"in_table": {"layout": "packed", "group": 1},
                                  "out_table": {"layout": "packed", "group": 1}}
        return
    if "table_tier" not in over:
        tr = ranks.grouped_trainer("grouped", _hand_mesh(), **over)
        assert tr.grouped and tr.mesh is not None
        took = {"comm_dtype": lambda: tr.comm_dtype == "int8",
                "placement": lambda: tr.placement_cut > 0,
                "optimizer_sharding": lambda: tr.zero}
        assert took[next(iter(over))]()
        return
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        ranks.grouped_trainer("grouped", _hand_mesh(), **over)


def test_a_pool_block_may_not_straddle_data_shards():
    tr = ranks.grouped_trainer("grouped", _hand_mesh(data=8, model=1))
    batch = {"centers": torch.zeros(32, dtype=torch.int32),
             "contexts": torch.zeros((32, 4), dtype=torch.int32)}
    with pytest.raises(ValueError, match="pool block"):
        tr.train_step(tr.init_state(), batch, torch.Generator())


def test_mesh_u_cap_matches_jax():
    """``_mesh_u_cap``: the auto cap and the ``mesh_u_cap`` override, as
    the JAX trainer computes them on the same mesh shape."""
    jm = jax_mesh.make_mesh(SHAPE, devices=jax.devices()[:4])
    ids, vocab = jax_paired_corpus(n_pairs=ranks.GROUPED_CAP // 2, reps=ranks.GROUPED_REPS, seed=0)
    for over in ({"dedup": "1"}, {"dedup": "1", "u_cap": "24"}, {"dedup": "1", "mesh_u_cap": "8"}):
        conf = ranks.grouped_conf(**over)
        conf.pop("use_native")
        jt = jax_w2v.Word2VecTrainer(JaxConfig(conf), mesh=jm, corpus_ids=ids, vocab=vocab)
        tr = ranks.grouped_trainer("grouped", _hand_mesh(), **over)
        for n in (256, 512, 192):
            assert tr._mesh_u_cap(n) == jt._mesh_u_cap(n), (over, n)


def test_dedup_batches_under_a_mesh_are_the_jax_trainers():
    """Under a mesh the dedup plane's windows shuffle one at a time (no
    kernel blocks): the port's host batches equal the JAX trainer's."""
    jm = jax_mesh.make_mesh(SHAPE, devices=jax.devices()[:4])
    ids, vocab = jax_paired_corpus(n_pairs=ranks.GROUPED_CAP // 2, reps=ranks.GROUPED_REPS, seed=0)
    conf = ranks.grouped_conf(dedup="1")
    conf.pop("use_native")
    jt = jax_w2v.Word2VecTrainer(JaxConfig({**conf, "use_native": "0"}), mesh=jm,
                                 corpus_ids=ids, vocab=vocab)
    tr = ranks.grouped_trainer("dedup", _hand_mesh())
    for a, b, _ in zip(tr.batches(), jt.batches(), range(3)):
        for k in ("centers", "contexts"):
            np.testing.assert_array_equal(a[k], b[k])


def test_cli_trains_the_grouped_plane_on_a_cluster(tmp_path):
    """``python -m swiftsnails_tpu_torch train`` as two processes on a
    grouped conf with ``dedup``, the bucketed push and ``overlap: 1``:
    a (2, 1) mesh, the same losses on both ranks, ``push_dropped`` on every
    metrics line."""
    import json
    import subprocess
    import sys

    rng = np.random.default_rng(0)
    (tmp_path / "corpus.txt").write_text("\n".join(
        " ".join(f"w{i}" for i in rng.integers(0, 50, 20)) for _ in range(80)) + "\n")
    conf = tmp_path / "w.conf"
    conf.write_text("model: word2vec\ndata: corpus.txt\ndim: 8\nwindow: 2\nnegatives: 2\n"
                    "batch_size: 64\npool_size: 8\ncenters_per_block: 16\nnum_iters: 1\n"
                    "subsample: 0\nmin_count: 1\nuse_native: 0\nlog_every: 1\nfused: 1\n"
                    "grouped: 1\ndedup: 1\npush_mode: bucketed\nbucket_slack: 0.5\n"
                    "overlap: 1\nsteps_per_call: 2\ncapacity: 64\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = []
    for r in range(2):
        env = {**os.environ, "RANK": str(r), "OMP_NUM_THREADS": "1",
               "PYTHONPATH": os.pathsep.join([repo, os.environ.get("PYTHONPATH", "")])}
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "swiftsnails_tpu_torch", "train", "-config", str(conf),
             "-device", "cpu", "-expected_node_num", "2", "-init_timeout", "120",
             "-master_addr", f"file://{tmp_path}/rendezvous"],
            cwd=tmp_path, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=SPAWN_TIMEOUT_S)
            assert p.returncode == 0, err
            outs.append([json.loads(ln) for ln in out.splitlines()])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    steps = [r for r in outs[0] if "loss" in r]
    assert steps and [r["loss"] for r in steps] == [r["loss"] for r in outs[1] if "loss" in r]
    assert all("push_dropped" in r and "dedup_dropped" not in r for r in steps)


def test_grouped_trainer_config_keys():
    """The plane's keys reach the trainer: ``bucket_slack``, ``mesh_u_cap``."""
    ids, vocab = paired_corpus(n_pairs=8, reps=10, seed=0)
    tr = Word2VecTrainer(Config(ranks.grouped_conf(push_mode="bucketed", bucket_slack="0.5",
                                                   mesh_u_cap="40", dedup="1")),
                         mesh=_hand_mesh(), corpus_ids=ids, vocab=vocab, device="cpu")
    assert tr.bucket_slack == 0.5 and tr._out_u_cap(256) == 40 and tr.dedup
