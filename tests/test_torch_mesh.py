"""The port's mesh, cluster runtime and f32 collectives against the JAX
package's, on the CPU.

The JAX side runs on the 8-device virtual CPU mesh; the port's meshes are
gloo groups of spawned processes (``spawn_ranks`` of
``tests/test_torch_seqlm.py``: a ``file://`` rendezvous under
``tmp_path``, a time limit a spawn, a rank's error re-raised), one spawn a
mesh shape, ``(2, 2)`` and ``(2, 4)``. Every rank starts from its shard of
the same whole tables (``convert.table_shard_from_numpy``) and its data
shard of the same ids and gradients. The pulls are bit-equal to JAX's and
to the port's single-device ``pull``; the tables after a push agree within
rtol 1e-5 / atol 1e-6 (the JAX test's tolerance), since the gathered
batch adds a row's gradients in another order.
"""

import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from swiftsnails_tpu.parallel import access as jax_access
from swiftsnails_tpu.parallel import cluster as jax_cluster
from swiftsnails_tpu.parallel import mesh as jax_mesh
from swiftsnails_tpu.parallel import store as jax_store
from swiftsnails_tpu.parallel import transfer as jax_transfer
from swiftsnails_tpu_torch import convert
from swiftsnails_tpu_torch.parallel import cluster, mesh, store, transfer
from swiftsnails_tpu_torch.parallel.access import AdaGradAccess, SgdAccess
from swiftsnails_tpu_torch.utils.config import Config
import torch_mesh_ranks as ranks
from test_torch_seqlm import SPAWN_TIMEOUT_S, spawn_ranks

RTOL, ATOL = 1e-5, 1e-6
torch.set_num_threads(1)
CASES, CAP, DIM, LR, N, PACKED_DIM = (ranks.CASES, ranks.CAP, ranks.DIM, ranks.LR, ranks.N,
                                      ranks.PACKED_DIM)


@pytest.fixture(scope="module")
def inputs():
    return ranks.inputs()


@pytest.fixture(scope="module", params=[(2, 2), (2, 4)], ids=["2x2", "2x4"])
def port_run(request, tmp_path_factory):
    d, m = request.param
    shape = {mesh.DATA_AXIS: d, mesh.MODEL_AXIS: m}
    tmp = tmp_path_factory.mktemp(f"mesh_{d}x{m}")
    results = spawn_ranks(ranks.mesh_worker, d * m, tmp, shape, (d, m) == (2, 2))
    return shape, results


def _assemble(shape, results, case):
    """The global pull (data shards in order, every model shard alike) and
    the whole table after the push (model shards in order, every data
    replica alike)."""
    d, m = shape[mesh.DATA_AXIS], shape[mesh.MODEL_AXIS]
    by = {(r["coords"]["data"], r["coords"]["model"]): r["cases"][case] for r in results}
    for (i, j), res in by.items():
        assert torch.equal(res["pull"], by[(i, 0)]["pull"]), (case, i, j)
        assert torch.equal(res["table"], by[(0, j)]["table"]), (case, i, j)
        for k in res["slots"]:
            assert torch.equal(res["slots"][k], by[(0, j)]["slots"][k])
    pulled = torch.cat([by[(i, 0)]["pull"] for i in range(d)]).numpy()
    table = torch.cat([by[(0, j)]["table"] for j in range(m)]).numpy()
    slots = {k: torch.cat([by[(0, j)]["slots"][k] for j in range(m)]).numpy()
             for k in by[(0, 0)]["slots"]}
    return pulled, table, slots


@pytest.fixture(scope="module")
def jax_ref(inputs):
    """JAX's collectives on its (2, 4) mesh of virtual devices."""
    jm = jax_mesh.make_mesh({jax_mesh.DATA_AXIS: 2, jax_mesh.MODEL_AXIS: 4})
    ts, bs = jax_mesh.table_sharding(jm), jax_mesh.batch_sharding(jm)
    put = lambda a, s: jax.device_put(jnp.asarray(a), s)  # noqa: E731
    rows = put(inputs["rows"], bs)
    out = {}
    for case, (plane, acc, exact) in CASES.items():
        access = jax_access.SgdAccess() if acc == "sgd" else jax_access.AdaGradAccess()
        if plane == "2d":
            slots = {"accum": put(inputs["accum"], ts)} if acc == "adagrad" else {}
            st = jax_store.TableState(table=put(inputs["table"], ts), slots=slots)
            pulled = jax_transfer.pull_collective(jm, st, rows)
            new = jax_transfer.push_collective(jm, st, rows, put(inputs["grads"], bs),
                                               access, LR, exact=exact)
        else:
            st = jax_store.PackedTableState(
                table=jax.device_put(jnp.asarray(inputs["packed"]),
                                     jax.sharding.NamedSharding(
                                         jm, jax.sharding.PartitionSpec("model", None, None))),
                slots={})
            pulled = jax_transfer.pull_collective_packed(jm, st, rows)
            new = jax_transfer.push_collective_packed(
                jm, st, rows, put(inputs["packed_grads"], bs), access, LR)
        out[case] = (np.asarray(pulled), np.asarray(new.table),
                     {k: np.asarray(v) for k, v in new.slots.items()})
    return out


def _single_device(inputs, case):
    """The port's one-device pull and push of the same case."""
    plane, acc, exact = CASES[case]
    access = ranks.port_access(acc)
    rows = torch.from_numpy(inputs["rows"])
    if plane == "2d":
        slots = {"accum": inputs["accum"]} if acc == "adagrad" else None
        st = convert.table_state_from_numpy(inputs["table"], slots, device="cpu")
        pulled = store.pull(st, rows)
        store.push(st, rows, torch.from_numpy(inputs["grads"]), access, LR, exact=exact)
    else:
        st = convert.packed_table_from_numpy(inputs["packed"], device="cpu")
        pulled = store.pull_packed(st, rows)
        store.push_packed(st, rows, torch.from_numpy(inputs["packed_grads"]), access, LR)
    return pulled.numpy(), st.table.numpy(), {k: v.numpy() for k, v in st.slots.items()}


@pytest.mark.parametrize("case", list(CASES))
def test_collectives_match_jax(port_run, jax_ref, case):
    """Each collective on the port's gloo mesh against JAX's on its (2, 4)
    virtual mesh: the pull bit-equal, the pushed table and slots within
    rtol 1e-5 / atol 1e-6."""
    shape, results = port_run
    pulled, table, slots = _assemble(shape, results, case)
    j_pull, j_table, j_slots = jax_ref[case]
    np.testing.assert_array_equal(pulled, j_pull)
    np.testing.assert_allclose(table, j_table, rtol=RTOL, atol=ATOL)
    assert sorted(slots) == sorted(j_slots)
    for k in slots:
        np.testing.assert_allclose(slots[k], j_slots[k], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", list(CASES))
def test_collectives_match_single_device(port_run, inputs, case):
    """The same collectives against the port's one-device pull and push."""
    shape, results = port_run
    pulled, table, slots = _assemble(shape, results, case)
    s_pull, s_table, s_slots = _single_device(inputs, case)
    np.testing.assert_array_equal(pulled, s_pull)
    np.testing.assert_allclose(table, s_table, rtol=RTOL, atol=ATOL)
    for k in s_slots:
        np.testing.assert_allclose(slots[k], s_slots[k], rtol=RTOL, atol=ATOL)
    # the padding lanes of a packed row stay zero
    if CASES[case][0] == "packed":
        assert not table.reshape(CAP, -1)[:, PACKED_DIM:].any()


def test_ranks_joined_with_their_groups(port_run):
    """``initialize_cluster`` (a ``file://`` rendezvous; ``RANK`` from the
    environment on 2x2, ``process_id`` on 2x4), the mesh's coordinates and
    axis groups, the collectives counted, and the barrier."""
    shape, results = port_run
    size = len(results)
    lines = mesh.axis_groups(shape)
    grid = mesh.rank_grid(shape)
    for r, res in enumerate(results):
        assert res["joined"] is True and res["info"] == [r, size]
        assert grid[res["coords"]["data"], res["coords"]["model"]] == r
        for axis, members in res["groups"].items():
            assert r in members and members in lines[axis]
        assert res["backend"] == "gloo"
        # 5 pulls (one all-reduce each) and 5 pushes (two all-gathers each)
        assert res["comm"]["all_reduce_calls"] == 5
        assert res["comm"]["all_gather_calls"] == 10
        # their result bytes: [n, 16] and [n, 2, 128] f32 rows pulled; the
        # data shards' int32 ids and f32 gradients gathered
        n, d = N // shape["data"], shape["data"]
        assert res["comm"]["all_reduce_bytes"] == (4 * n * DIM + n * 256) * 4
        assert res["comm"]["all_gather_bytes"] == (4 * d * n * (4 + 4 * DIM)
                                                   + d * n * (4 + 4 * 256))
    assert results[1]["barrier_wait_s"] >= 0.3  # held until rank 0 arrived


@pytest.mark.parametrize("shape", [
    {"data": 2, "model": 4}, {"data": -1, "model": 2}, {"data": 8},
    {"data": 1, "model": -1}, {"model": 4, "data": 2}, None,
    {"data": -1, "model": -1}, {"data": 3, "model": -1}, {"data": 3, "model": 2},
], ids=lambda s: str(s))
def test_mesh_layout_matches_jax(shape):
    """Sizes, errors, the row-major rank layout and each axis' lines against
    JAX ``make_mesh`` over the 8 virtual devices."""
    try:
        jm = jax_mesh.make_mesh(shape)
    except ValueError as e:
        with pytest.raises(ValueError, match=re.escape(str(e))):
            mesh.mesh_sizes(shape, 8)
        return
    sizes = mesh.mesh_sizes(shape, 8)
    assert sizes == dict(jm.shape)
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    np.testing.assert_array_equal(mesh.rank_grid(sizes), ids)
    for a, name in enumerate(jm.axis_names):
        moved = np.moveaxis(ids, a, -1).reshape(-1, ids.shape[a])
        assert mesh.axis_groups(sizes)[name] == moved.tolist()


def test_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="default group"):
        mesh.make_mesh({"data": 1, "model": 1}, device="cpu")


def test_sharding_helpers():
    m = mesh.Mesh(shape={"data": 2, "model": 4}, coords={"data": 1, "model": 2},
                  groups={}, device=torch.device("cpu"))
    assert (m.axis_size("data"), m.axis_index("model"), m.axis_size("seq")) == (2, 2, 1)
    assert mesh.table_sharding(m, 64) == (32, 48)
    assert mesh.batch_sharding(m, 16) == slice(8, 16)
    assert mesh.replicated(m) == slice(None)
    with pytest.raises(ValueError, match="not divisible by model axis 4"):
        mesh.table_sharding(m, 30)
    with pytest.raises(ValueError, match="does not split"):
        mesh.batch_sharding(m, 15)
    full = np.arange(64 * 3).reshape(64, 3)
    np.testing.assert_array_equal(convert.model_shard(full, m), full[32:48])


@pytest.mark.parametrize("count", [1, 2, 3, 5])
def test_local_data_shard_and_shard_rows_match_jax(count, monkeypatch):
    paths = [f"part-{i}" for i in range(7)]
    a, b = np.arange(11), np.arange(22).reshape(11, 2)
    for idx in range(count):
        monkeypatch.setattr(jax_cluster, "process_info", lambda: (idx, count))
        assert cluster.local_data_shard(paths, idx, count) == jax_cluster.local_data_shard(paths)
        got = cluster.shard_rows(a, b, process_index=idx, process_count=count)
        want = jax_cluster.shard_rows(a, b, process_index=idx, process_count=count)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    # no process group: one process, which owns everything
    assert cluster.local_data_shard(paths) == paths
    assert cluster.shard_rows(a)[0] is a


def test_initialize_cluster_single_process_and_missing_rank(monkeypatch):
    """One process is single-process mode in both packages (no group, a
    barrier that returns at once); a cluster needs a rank."""
    from swiftsnails_tpu.utils.config import Config as JaxConfig

    assert cluster.initialize_cluster(None) is False
    assert cluster.initialize_cluster(Config({"expected_node_num": "1"})) is False
    assert jax_cluster.initialize_cluster(None) is None
    assert jax_cluster.initialize_cluster(JaxConfig({"expected_node_num": "1"})) is None
    jax_cluster.barrier("alone")
    monkeypatch.delenv("RANK", raising=False)
    with pytest.raises(ValueError, match="RANK"):
        cluster.initialize_cluster(Config({"expected_node_num": "2",
                                           "master_addr": "127.0.0.1:1", "device": "cpu"}))
    cluster.barrier("alone")  # one process: returns at once
    assert cluster._init_method("10.0.0.1:29500") == "tcp://10.0.0.1:29500"
    assert cluster._init_method("file:///x/y") == "file:///x/y"


def test_non_f32_wire_raises():
    """The codecs are ported since this test was written (bf16, int8 and
    int4 run in ``tests/test_torch_comm.py``); a wire the JAX package
    refuses, ``fp32`` or ``fp8``, raises ``ValueError`` before any
    collective."""
    m = mesh.Mesh(shape={"data": 1, "model": 1}, coords={"data": 0, "model": 0},
                  groups={}, device=torch.device("cpu"))
    st = store.create_table(8, 4, SgdAccess(), device="cpu")
    rows = torch.zeros(2, dtype=torch.int32)
    for call in (lambda: transfer.pull_collective(m, st, rows, comm_dtype="fp32"),
                 lambda: transfer.push_collective(m, st, rows, torch.zeros(2, 4), SgdAccess(),
                                                  LR, comm_dtype="fp8")):
        with pytest.raises(ValueError, match="comm_dtype must be one of"):
            call()


@pytest.mark.parametrize("packed", [False, True])
def test_create_table_shards_are_rows_of_the_whole(packed):
    """Each model shard is its rows of the table made without a mesh, so
    every mesh shape starts from the same table."""
    make = store.create_packed_table if packed else store.create_table
    whole = make(CAP, 20, AdaGradAccess(), seed=3, device="cpu")
    for j in range(4):
        m = mesh.Mesh(shape={"data": 2, "model": 4}, coords={"data": 1, "model": j},
                      groups={}, device=torch.device("cpu"))
        part = make(CAP, 20, AdaGradAccess(), seed=3, device="cpu", mesh=m)
        assert torch.equal(part.table, whole.table[16 * j:16 * (j + 1)])
        assert part.slots["accum"].shape == part.table.shape
    with pytest.raises(ValueError, match="not divisible"):
        make(62, 20, SgdAccess(), device="cpu", mesh=m)


def test_cluster_test_tool_passes():
    """``python -m swiftsnails_tpu_torch.tools.cluster_test --nproc 2``: two
    CPU processes rendezvous over TCP, train under a (1, 2) mesh and meet at
    the barrier, within the tool's 300 s deadline."""
    import subprocess
    import sys

    from swiftsnails_tpu_torch.tools import cluster_test

    proc = subprocess.run([sys.executable, "-m", "swiftsnails_tpu_torch.tools.cluster_test",
                           "--nproc", "2"], capture_output=True, text=True,
                          timeout=cluster_test.DEADLINE_S + 30)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "cluster smoke test: PASS" in proc.stdout


def test_cli_train_joins_the_cluster(tmp_path):
    """``python -m swiftsnails_tpu_torch train`` as two processes (the rank
    from ``RANK``, ``master_addr`` a ``file://`` rendezvous of this test):
    they train word2vec under a (1, 2) mesh, log the same losses, meet at
    the barrier, and rank 0 alone writes the vectors."""
    import json
    import subprocess
    import sys

    rng = np.random.default_rng(0)
    (tmp_path / "corpus.txt").write_text("\n".join(
        " ".join(f"w{i}" for i in rng.integers(0, 50, 20)) for _ in range(50)) + "\n")
    conf = tmp_path / "w.conf"
    conf.write_text("model: word2vec\ndata: corpus.txt\ndim: 8\nwindow: 2\nnegatives: 2\n"
                    "batch_size: 64\npool_size: 8\npool_block: 16\nnum_iters: 1\n"
                    "subsample: 0\nmin_count: 1\nuse_native: 0\nlog_every: 5\n")
    procs = []
    for r in range(2):
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env = {**os.environ, "RANK": str(r), "OMP_NUM_THREADS": "1",
               "PYTHONPATH": os.pathsep.join([repo, os.environ.get("PYTHONPATH", "")])}
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "swiftsnails_tpu_torch", "train", "-config", str(conf),
             "-device", "cpu", "-expected_node_num", "2", "-init_timeout", "120",
             "-master_addr", f"file://{tmp_path}/rendezvous", "-output", f"vec{r}.txt"],
            cwd=tmp_path, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=SPAWN_TIMEOUT_S)
            assert p.returncode == 0, err
            outs.append(([json.loads(ln)["loss"] for ln in out.splitlines()], err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert outs[0][0] and outs[0][0] == outs[1][0]
    assert "exported parameters to vec0.txt" in outs[0][1]
    assert "exported" not in outs[1][1]
    assert (tmp_path / "vec0.txt").read_text().startswith("50 8\n")
    assert not (tmp_path / "vec1.txt").exists()
