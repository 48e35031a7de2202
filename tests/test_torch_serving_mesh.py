"""The port's serving under a ``(1, 4)`` mesh of gloo processes
(``Servant(mesh=)``, ``Fleet(mesh=)``, ``serve`` across processes) against
the JAX package's ``Servant`` on a 4-device mesh and against the port's
unmeshed servant, on the CPU.

One spawn of four ranks (``torch_serve_ranks.serve_worker``): every rank
makes the same servants, rank 0 leads the cases and the others follow it
(``serving/mesh_serve.py``). The holds:

* pulls bit-equal to JAX's meshed servant and to the unmeshed port at f32,
  and under int8 and int4 bit-equal to JAX's ``_wire_cast`` of the rows;
* topk ids equal to JAX's and the unmeshed port's, scores within 1e-6,
  ties (equal rows on two shards) in the unmeshed scan's order;
* CTR ``score`` within 1e-6 of JAX's servant and equal to the unmeshed
  port's;
* ``apply_rows`` pulled back bit for bit (the last of a repeated id, an
  out-of-range id dropped), one version on every rank; a reload from a
  checkpoint on every rank;
* the tiered read path under the mesh (its slot map the same on every
  rank), a 2-replica ``Fleet(mesh=)`` with a delta, ``add_replica``,
  ``drain`` and a reload;
* a failure planted on one follower refuses a delta, a reload and a
  fleet's delta and reload on every rank: the leader raises ``Refused``
  naming that rank, and every rank serves its old rows at its old version;
  an op that fails on a follower alone outside a vote ends that follower
  with ``FollowerError``;
* the followers exit on the leader's stop, and on its error as an error;
* ``python -m swiftsnails_tpu_torch serve`` across two processes answers as
  one process does.
"""

import fcntl
import json
import multiprocessing as mp
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from swiftsnails_tpu.models.registry import get_model as jax_get_model
from swiftsnails_tpu.parallel import mesh as jax_mesh
from swiftsnails_tpu.serving import Servant as JServant
from swiftsnails_tpu.serving import kernels as jax_kernels
from swiftsnails_tpu.serving import normalize_table as jax_normalize_table
from swiftsnails_tpu.utils.config import Config as JConfig
from swiftsnails_tpu_torch.framework.checkpoint import load_tables
from swiftsnails_tpu_torch.serving import Servant
from swiftsnails_tpu_torch.serving.kernels import pull_rows, topk_tiled
import torch_serve_ranks as sr

SPAWN_TIMEOUT_S = 300
SCORE_TOL = 1e-6
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(1)


def _spawn(out):
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=sr.serve_worker, args=(r, 4, f"file://{out}/rdv", str(out)))
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
def serve_run(tmp_path_factory):
    """The spawn's results and its directory (the checkpoints), made once
    a run under a lock in the directory every test process shares."""
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    out = base / "serve_mesh_spawn"
    out.mkdir(exist_ok=True)
    with open(out / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not (out / "done").exists():
                _spawn(out)
                (out / "done").write_text("ok")
            return out, [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(4)]
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def _cases(serve_run):
    _, results = serve_run
    leaders = [r for r in results if r["leader"]]
    assert len(leaders) == 1 and leaders[0]["coords"] == {"data": 0, "model": 0}
    return leaders[0]["cases"]


def _jax_servant(**kw):
    jm = jax_mesh.make_mesh({"data": 1, "model": 4}, devices=jax.devices()[:4])
    return JServant(sr.tables(), mesh=jm, topk_tile_rows=sr.TILE, **kw)


# ------------------------------------------------------------------- pull ---


def test_meshed_pull_is_bit_equal_to_jax_and_unmeshed(serve_run):
    got = _cases(serve_run)["pull"]
    with _jax_servant() as jsv:
        want = jsv.pull(sr.ids())
        np.testing.assert_array_equal(got["float32"], want)
        np.testing.assert_array_equal(got["out_table"], jsv.pull(sr.ids(), table="out_table"))
    np.testing.assert_array_equal(got["float32"], got["ref"])
    np.testing.assert_array_equal(got["ref"], sr.tables()["in_table"][sr.ids()])


@pytest.mark.parametrize("wire", ["int8", "int4"])
def test_meshed_pull_under_a_codec_is_jax_wire_cast(serve_run, wire):
    got = _cases(serve_run)["pull"][wire]
    rows = sr.tables()["in_table"][sr.ids()]
    want = np.asarray(jax_kernels._wire_cast(jnp.asarray(rows), wire))
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, rows)  # the wire did round


# ------------------------------------------------------------------- topk ---


def test_meshed_topk_matches_jax_and_unmeshed(serve_run):
    got = _cases(serve_run)["topk"]
    qs, _ = sr.queries()
    with _jax_servant() as jsv:
        for q, mine, ref in zip(qs, got["mesh"], got["ref"]):
            want = jsv.topk(sr.tables()["in_table"][q], k=10)
            assert [i for i, _ in mine] == [i for i, _ in want] == [i for i, _ in ref]
            np.testing.assert_allclose([s for _, s in mine], [s for _, s in want], atol=1e-6)


def test_meshed_topk_ties_take_the_unmeshed_order(serve_run):
    """Rows 10-13 (the same row, on two model shards) tie at the top of
    the raw scores against a vector of ones: they lead the list in id
    order, as the unmeshed scan and JAX's rank ties."""
    got = _cases(serve_run)["topk"]
    _, axis = sr.queries()
    mine = [i for i, _ in got["ties_mesh"]]
    assert mine == [i for i, _ in got["ties_ref"]]
    assert mine[:4] == list(sr.TIES)
    with _jax_servant() as jsv:
        assert mine == [i for i, _ in jsv.topk(axis, k=12, normalize=False)]


def test_topk_tiled_under_a_hand_mesh_merges_in_scan_order(monkeypatch):
    """The merge of :func:`topk_tiled` under a mesh, each shard's scan
    stood in for by a hand gather (four shards of 16 rows): equal to the
    unmeshed scan, ties included."""
    from swiftsnails_tpu_torch.parallel import comm
    from swiftsnails_tpu_torch.parallel.mesh import Mesh

    table = torch.from_numpy(sr.tables()["in_table"])
    _, axis = sr.queries()
    q = torch.from_numpy(np.stack([axis, sr.tables()["in_table"][3]]))
    shards = table.chunk(4)
    parts = [topk_tiled(s, q, 12, tile_rows=sr.TILE, normalize=False) for s in shards]

    def gather(mesh, t, axis_name):
        k = 0 if t.dtype == torch.float32 else 1
        return torch.cat([torch.where(p[1] >= 0, p[1] + 16 * j, p[1]) if k else p[0]
                          for j, p in enumerate(parts)])

    monkeypatch.setattr(comm, "all_gather", gather)
    hand = Mesh(shape={"data": 1, "model": 4}, coords={"data": 0, "model": 0},
                groups={}, device=torch.device("cpu"))
    s, i = topk_tiled(shards[0], q, 12, tile_rows=sr.TILE, normalize=False, mesh=hand)
    ws, wi = topk_tiled(table, q, 12, tile_rows=sr.TILE, normalize=False)
    assert torch.equal(i, wi) and torch.equal(s, ws)


# ------------------------------------------------------------------ score ---


def test_meshed_score_matches_jax_and_unmeshed(serve_run):
    out, _ = serve_run
    got = _cases(serve_run)["score"]
    np.testing.assert_array_equal(got["mesh"], got["ref"])
    state, _ = load_tables(str(out / "ck_ctr"), device="cpu")
    keys = dict(sr.CTR_KEYS)
    data = (np.zeros(0, np.float32), np.zeros((0, 5), np.int32))
    jtr = jax_get_model("widedeep")(JConfig(keys), mesh=None, data=data)
    layout = "packed_small" if jtr.packed else "dense"
    jtables = {"table": np.asarray(jax_normalize_table(
        state["table"]["table"].numpy(), jtr.table_dim, layout, capacity=jtr.capacity))}
    jdense = {k: jnp.asarray(v.numpy()) for k, v in state["dense"].items()}
    with JServant(jtables, scorer=jtr, dense=jdense, default_table="table") as jsv:
        np.testing.assert_allclose(got["mesh"], jsv.score(sr.ctr_feats()), rtol=0,
                                   atol=SCORE_TOL)


# ---------------------------------------------------- deltas, reload, tier ---


def test_meshed_apply_rows_pulled_back(serve_run):
    got = _cases(serve_run)["apply"]
    rows, vals = sr.deltas()
    want = sr.tables()["in_table"].copy()
    for r, v in zip(rows, vals):  # the last of a repeated id; 70 is dropped
        if r < sr.CAP:
            want[r] = v
    np.testing.assert_array_equal(got["mesh"], want)
    np.testing.assert_array_equal(got["ref"], want)
    assert got["version"] == 1


def test_every_rank_holds_its_rows_and_one_version(serve_run):
    """Each rank's shard is its model rows of the (applied) table, and
    every servant has the same version on every rank."""
    _, results = serve_run
    want = _cases(serve_run)["apply"]["mesh"]
    versions = {tuple(r["versions"]) for r in results}
    assert len(versions) == 1
    for r in results:
        m = r["coords"]["model"]
        np.testing.assert_array_equal(r["shards"]["in_table"].numpy(),
                                      want[16 * m:16 * (m + 1)])


def test_meshed_reload_from_checkpoint(serve_run):
    got = _cases(serve_run)["ck"]
    np.testing.assert_array_equal(got["step1"], sr.step_tables(1)["in_table"][sr.ids()])
    np.testing.assert_array_equal(got["step2"], sr.step_tables(2)["in_table"][sr.ids()])
    assert got["version"] == 1


def test_meshed_tiered_read_path(serve_run):
    _, results = serve_run
    got = _cases(serve_run)["tiered"]
    np.testing.assert_array_equal(got["pull"], sr.tables()["in_table"][sr.ids()])
    assert got["stats"]["faults"] > 0 and got["stats"]["evictions"] > 0
    apply = _cases(serve_run)["apply"]["mesh"]
    np.testing.assert_array_equal(got["apply"], apply)
    with Servant(sr.tables(), device="cpu") as one:
        assert [i for i, _ in got["topk"]] == [
            i for i, _ in one.topk(sr.tables()["in_table"][3], k=10)]
    for r in results:  # every rank faulted the same ids
        np.testing.assert_array_equal(r["slot_of"], results[0]["slot_of"])


def test_meshed_fleet(serve_run):
    got = _cases(serve_run)["fleet"]
    step1 = sr.step_tables(1)["in_table"]
    np.testing.assert_array_equal(got["pull"], step1[sr.ids()])
    rows, vals = sr.deltas()
    want = step1.copy()
    for r, v in zip(rows, vals):
        if r < sr.CAP:
            want[r] = v
    np.testing.assert_array_equal(got["apply"], want)
    np.testing.assert_array_equal(got["after_drain"], want)
    assert got["added"] == "r2" and got["epoch"] == 1 and got["reload"] == 2
    np.testing.assert_array_equal(got["reloaded"], sr.step_tables(2)["in_table"][sr.ids()])
    with Servant(sr.step_tables(1), device="cpu") as one:
        assert [i for i, _ in got["topk"]] == [i for i, _ in one.topk(step1[3], k=10)]


def test_a_follower_failure_refuses_the_op_on_every_rank(serve_run):
    """A failure planted on one follower (its checkpoint load, its new
    delta planes) refuses the op on every rank: the leader raises naming
    that rank, and a pull through every rank's shard then reads the old
    rows at the old version, so no rank swapped alone."""
    got = _cases(serve_run)["refused"]
    step1 = sr.step_tables(1)["in_table"]
    for what in ("apply", "reload", "fleet_reload", "fleet_apply"):
        assert got[what] is not None, what
        assert f"rank(s) [{sr.PLANT_RANK}] failed" in got[what], got[what]
    version, rows = got["apply_kept"]
    assert version == 0
    np.testing.assert_array_equal(rows, sr.tables()["in_table"])
    version, rows = got["reload_kept"]
    assert version == 0
    np.testing.assert_array_equal(rows, step1[sr.ids()])
    version, rows = got["fleet_kept"]
    assert version == 1  # the delta's epoch, before either refusal
    np.testing.assert_array_equal(rows, _cases(serve_run)["fleet"]["after_drain"])


def test_a_follower_leaves_the_session_when_an_op_fails_there_alone(monkeypatch):
    """Outside a vote an op that raises on a follower raised there alone,
    so its collectives no longer pair with the leader's: ``follow`` raises
    ``FollowerError`` and closes the session. A refused voted op is logged
    and the loop goes on to the stop."""
    from types import SimpleNamespace

    from swiftsnails_tpu_torch.serving import mesh_serve

    class Target:
        def __init__(self):
            self.ops = []

        def _follow(self, op, args, ch):
            self.ops.append(op)
            if op == mesh_serve.APPLY:
                raise mesh_serve.Refused("apply_rows: rank(s) [2] failed their half")
            if op == mesh_serve.PULL:
                raise RuntimeError("a fault on this rank")

    def run(headers):
        monkeypatch.setattr(mesh_serve.dist, "get_backend", lambda: "gloo")
        ch = mesh_serve.ServeChannel(SimpleNamespace(coords={"data": 0, "model": 1},
                                                     device=torch.device("cpu")))
        target = Target()
        ch.register(target)
        feed = iter(torch.tensor(h + [0] * (mesh_serve.HEADER - len(h))) for h in headers)
        monkeypatch.setattr(ch, "recv", lambda shape, dtype: next(feed))
        return ch, target

    ch, target = run([[mesh_serve.APPLY, 0], [mesh_serve.PULL, 0], [mesh_serve.STOP, 0]])
    with pytest.raises(mesh_serve.FollowerError, match="op 2 on target 0"):
        ch.follow()
    assert target.ops == [mesh_serve.APPLY, mesh_serve.PULL] and ch.stopped
    ch, target = run([[mesh_serve.APPLY, 0], [mesh_serve.NOP, 0], [mesh_serve.STOP, 0]])
    ch.follow()
    assert target.ops == [mesh_serve.APPLY] and ch.stopped


def test_followers_end_on_stop_and_on_a_leader_error(serve_run):
    _, results = serve_run
    for r in results:
        assert r["stopped"]
        if r["leader"]:
            assert r["leader_failed"]
            assert "session on the mesh has stopped" in r["stale_session"]
        else:
            assert r["followed"] and r["saw_leader_error"]


# ---------------------------------------------------------------- no mesh ---


def test_pull_rows_and_servant_take_only_a_mesh():
    with pytest.raises(TypeError, match="mesh"):
        pull_rows(torch.zeros((4, 4)), torch.zeros(1, dtype=torch.int32), mesh=object())
    with pytest.raises(TypeError, match="mesh"):
        Servant({"t": np.zeros((4, 4), np.float32)}, mesh=object(), device="cpu")


# --------------------------------------------------------------- the CLI ---


def _serve_procs(tmp_path, root, n):
    """``serve`` on ``n`` processes (a gloo cluster through a ``file://``
    rendezvous) with rank 0's stdin; rank 0's stdout lines."""
    conf = tmp_path / "serve.conf"
    conf.write_text(f"dim: {sr.DIM}\ncapacity: {sr.CAP}\npacked: 1\n")
    args = [sys.executable, "-m", "swiftsnails_tpu_torch", "serve", "-config", str(conf),
            "-checkpoint", root, "-device", "cpu", "-serve_topk", "5"]
    if n > 1:
        args += ["-expected_node_num", str(n), "-master_addr", f"file://{tmp_path}/rdv{n}"]
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(args, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True,
                              env={**env, "RANK": str(r)}) for r in range(n)]
    try:
        outs = [p.communicate(input="pull 3 40 63\ntopk 17\nquit\n" if r == 0 else "",
                              timeout=120) for r, p in enumerate(procs)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
    return outs[0][0].splitlines(), [o for o, _ in outs[1:]]


def test_cli_serve_across_processes_answers_as_one(serve_run, tmp_path):
    out, _ = serve_run
    root = str(out / "ck_w2v")
    one, _ = _serve_procs(tmp_path, root, 1)
    two, followers = _serve_procs(tmp_path, root, 2)
    assert one[:2] == two[:2]
    assert json.loads(two[0])["rows"][0][:3] == [round(float(v), 6) for v in
                                                  sr.step_tables(2)["in_table"][3][:3]]
    assert len(json.loads(two[1])["topk"]) == 5
    assert "final_stats" in two[-1] and followers == [""]
