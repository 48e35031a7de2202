"""The port's loop guards under a ``(2, 2)`` mesh of gloo processes —
the guardrail, the tier's integrity sweep and heal, freshness publishing
and cluster leases — against the JAX package and against the port's own
unmeshed runs, on the CPU.

One spawn of four ranks (``torch_guards_ranks.guards_worker``) holds every
case. The claims:

* the guardrail's commit on each rank's part of a global state (a
  model-sharded table, a replicated dense tensor, a hybrid head and tail,
  a ZeRO slice) gives JAX's ``StepGuardrail.commit`` on the whole arrays:
  the norm (bit-equal on every rank), the trip, the trust, the blend and
  the give-up, with a NaN in a replica no rank counts and a NaN loss on
  one rank moving every rank;
* a guarded meshed run with ``nan_grad`` equals the unmeshed port run with
  the same plan; the NaN on one rank alone trips all four at the same
  step, bit-equal to the NaN on all; the give-up raises on all four at the
  same step; Wide & Deep with ``dense_tp`` and ZeRO trips the same way;
* a bit flipped in one rank's master heals every rank from the same save,
  bit-equal to the flip on all, and the tables equal the unmeshed drill's;
  the leader alone writes the ledger event;
* the leader alone writes the delta log, whose rows are the meshed tables'
  whole rows bit for bit and an unmeshed publish's rows; a publish failing
  on one rank is one ``freshness_gap`` event, and every rank trains on;
* hybrid placement with freshness raises or disables as JAX's
  ``TrainPublisher`` does;
* leases: the order of applied indices and the watermarks equal the
  unmeshed run's under a reassignment; a preempted and resumed meshed run
  applies each index once and ends bit-equal to the straight one;
* no rank made a collective off its main thread.

Tolerance: rtol 1e-5 / atol 1e-6 where a case does not say bit-equal.
"""

import fcntl
import math
import multiprocessing as mp
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from swiftsnails_tpu.framework.quality import paired_corpus as jax_paired_corpus
from swiftsnails_tpu.freshness.publisher import HybridFreshnessError as JaxHybridError
from swiftsnails_tpu.freshness.publisher import TrainPublisher as JaxTrainPublisher
from swiftsnails_tpu.models import word2vec as jax_w2v
from swiftsnails_tpu.parallel import mesh as jax_mesh
from swiftsnails_tpu.parallel.placement import PlacementManager as JaxPlacementManager
from swiftsnails_tpu.resilience.guardrail import StepGuardrail as JaxStepGuardrail
from swiftsnails_tpu.utils.config import Config as JaxConfig
from swiftsnails_tpu_torch.cluster import Supervisor, WorkerClient
from swiftsnails_tpu_torch.freshness.log import list_seqs, read_batch, seg_path
from swiftsnails_tpu_torch.freshness.publisher import HybridFreshnessError
from swiftsnails_tpu_torch.framework.trainer import TrainLoop
from swiftsnails_tpu_torch.parallel.mesh import Mesh
import torch_guards_ranks as g_ranks
import torch_tier_ranks as tr_ranks

RTOL, ATOL = 1e-5, 1e-6
SPAWN_TIMEOUT_S = 300
torch.set_num_threads(1)


def _spawn(out):
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=g_ranks.guards_worker, args=(r, 4, f"file://{out}/rdv", str(out)))
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
def guards_run(tmp_path_factory):
    """The spawn's results, made once a run under a lock in the directory
    every test process of the run shares."""
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    out = base / "guards_mesh_spawn"
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


def by_coords(results):
    return {(r["coords"]["data"], r["coords"]["model"]): r for r in results}


def _whole(by, get, axis="model"):
    """The shards over ``axis`` of the other axis' index 0 concatenated;
    every replica on the other axis holds the same."""
    for (i, j), res in by.items():
        twin = by[(0, j)] if axis == "model" else by[(i, 0)]
        assert torch.equal(get(res), get(twin)), (i, j)
    if axis == "model":
        return torch.cat([get(by[(0, j)]) for j in range(2)]).numpy()
    return torch.cat([get(by[(i, 0)]) for i in range(2)]).numpy()


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL)


def _tables_equal(a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


# ------------------------------------------------- the guardrail's commit ---


def _jax_commits():
    """JAX's ``StepGuardrail.commit`` over the whole arrays of the rank
    helper's steps, as a list of ``(norm, tripped, exhausted, trust,
    state)``."""
    start, steps = g_ranks.commit_inputs()
    guard = JaxStepGuardrail(max_update_norm=g_ranks.SPIKE, max_consecutive=3)
    state = {k: jnp.asarray(v) for k, v in start.items()}
    out = []
    for s in steps:
        new = {k: np.array(v) for k, v in s["new"].items()}
        if s["kind"] == "nan_rank":
            # the NaN row of the poisoned rank's model shard, local row 1
            model = g_ranks.NAN_RANK % 2
            new["table"][model * g_ranks.TABLE // 2 + 1] = np.nan
        loss = np.float32(np.nan if s["kind"] == "nan_loss" else 1.0)
        snap = guard.snapshot(state)
        state, _, tripped, exhausted = guard.commit(
            snap, {k: jnp.asarray(v) for k, v in new.items()}, {"loss": loss})
        out.append((guard.last_update_norm, tripped, exhausted, guard.trust,
                    {k: np.asarray(v) for k, v in state.items()}))
    return out


@pytest.fixture(scope="module")
def jax_commits():
    return _jax_commits()


@pytest.mark.parametrize("k", range(6))
def test_commit_matches_jax_step_guardrail(guards_run, jax_commits, k):
    """Step ``k`` of the case (clean, spike, blend, a NaN in a replica no
    rank counts, a NaN loss on one rank, the give-up): every rank's voted
    norm bit-equal to every other's and JAX's within the tolerance, the
    trip, the give-up and the trust JAX's, and the state's parts the JAX
    state's whole arrays."""
    norm, tripped, exhausted, trust, state = jax_commits[k]
    mine = [r["commit"][k] for r in guards_run]
    norms = {m["norm"] for m in mine if not math.isnan(m["norm"])}
    assert len(norms) <= 1 and (len(norms) == 1) == (not math.isnan(norm))
    if norms:
        assert next(iter(norms)) == pytest.approx(norm, rel=RTOL)
    for m in mine:
        assert (m["tripped"], m["exhausted"], m["trust"]) == (tripped, exhausted, trust)
    by = {c: {"commit": r["commit"][k]} for c, r in by_coords(guards_run).items()}
    parts = lambda key: lambda res: res["commit"]["parts"][key]  # noqa: E731
    _close(_whole(by, parts("table/table")), state["table"])
    _close(_whole(by, parts("hybrid/tail/table")), state["tail"])
    _close(_whole(by, parts("hybrid/head_slots/accum"), axis="data"), state["accum"])
    for res in by.values():
        _close(res["commit"]["parts"]["hybrid/head"], state["head"])
        _close(res["commit"]["parts"]["dense/w"], state["w"])


def test_commit_case_trips_on_each_fault(jax_commits):
    """The case holds every verdict: a clean commit, a spike, a blend, a
    NaN update, a NaN loss and the give-up."""
    assert [c[1] for c in jax_commits] == [False, True, False, True, True, True]
    assert [c[2] for c in jax_commits] == [False] * 5 + [True]
    assert jax_commits[2][3] == 1.0 and jax_commits[1][3] == 0.5


# ------------------------------------------------------ guarded meshed runs ---


def _w2v_tables(res):
    return [res["arrays"][f"{t}/table"] for t in ("in_table", "out_table")]


def test_guarded_mesh_run_matches_the_unmeshed_run(guards_run):
    """``nan_grad@3`` on every rank of the ``(2, 2)`` mesh against the
    unmeshed port run with the same plan: the tables, the trips and the
    skipped steps."""
    loop = TrainLoop(tr_ranks.w2v_trainer("packed", None, guardrail=1, chaos_seed=5,
                                          chaos_spec=f"nan_grad@{g_ranks.NAN_AT}"), log_every=0)
    want = loop.run(seed=0, max_steps=g_ranks.STEPS)
    by = by_coords(guards_run)
    for k, ts in enumerate(want):
        got = _whole({c: r["guarded"]["all"] for c, r in by.items()},
                     lambda res, k=k: _w2v_tables(res)[k])
        _close(got, ts.table.numpy())
    summary = loop.guardrail.summary()
    for r in guards_run:
        mine = r["guarded"]["all"]["guard"]
        assert (mine["trips_total"], mine["steps_skipped"], mine["trust"]) == (
            summary["trips_total"], summary["steps_skipped"], summary["trust"])


def test_nan_on_one_rank_trips_every_rank(guards_run):
    """``nan_grad`` on the faulty rank alone: every rank trips once at the
    same step with the same voted norm, and the tables are the NaN-on-all
    run's, bit for bit."""
    first = guards_run[0]["guarded"]["one"]["guard"]
    assert first["trips_total"] == 1
    for r in guards_run:
        one, every = r["guarded"]["one"], r["guarded"]["all"]
        assert one["guard"] == first
        assert _tables_equal(_w2v_tables(one), _w2v_tables(every))


def test_exhaustion_raises_on_every_rank_at_the_same_step(guards_run):
    said = {r["guarded"]["exhausted"] for r in guards_run}
    assert len(said) == 1
    msg = said.pop()
    assert msg is not None and "3 consecutive unhealthy steps" in msg and "at step 4" in msg


def test_widedeep_guarded_step_counts_every_layout(guards_run):
    """Wide & Deep with ``dense_tp: 1`` and ZeRO: the guardrail counts both
    layouts; the NaN on one rank trips every rank, bit-equal to the NaN on
    all, with the same voted norm everywhere."""
    first = guards_run[0]["guarded"]["wd_one"]["guard"]
    assert first["trips_total"] == 1 and first["last_update_norm"] is not None
    for r in guards_run:
        one, every = r["guarded"]["wd_one"], r["guarded"]["wd_all"]
        assert one["layouts"] == ["ZeroManager", "DenseTP"]
        assert one["guard"] == first
        assert one["arrays"].keys() == every["arrays"].keys()
        assert all(torch.equal(one["arrays"][k], every["arrays"][k]) for k in one["arrays"])


# ------------------------------------------------------------- the sweep ---


@pytest.mark.parametrize("case", ["one", "all"])
def test_sweep_heals_every_rank_from_the_same_save(guards_run, case):
    """The flip at step 7 (on one rank's master, or on every rank's): the
    sweep after it (step index 9) finds the plane corrupt on every rank,
    every rank rebuilds the same table from the step-5 save, the digests
    are clean after, and the leader alone writes the one ledger event."""
    heals = {repr(r["sweep"][case]["heals"]) for r in guards_run}
    assert len(heals) == 1
    (step, names), = guards_run[0]["sweep"][case]["heals"]
    assert step == g_ranks.SWEEP["period"] and len(names) == 1
    for r in guards_run:
        res = r["sweep"][case]
        assert res["verify_after"] == {} and res["evictions"] > 0
        leader = r["coords"] == {"data": 0, "model": 0}
        assert res["ledger_written"] is leader
        if leader:
            assert res["events"] == [{"source": "tier", "step": 9, "rebuilt_from_step": 5,
                                      "tables": names}]


def test_sweep_tables_equal_the_unmeshed_drill(guards_run, tmp_path):
    """A flip on one rank heals to the flip-on-all tables, bit for bit,
    which equal the unmeshed drill's."""
    for r in guards_run:
        assert _tables_equal(r["sweep"]["one"]["tables"], r["sweep"]["all"]["tables"])
    tr = tr_ranks.w2v_trainer("dense", None, 1, **g_ranks.sweep_keys(
        str(tmp_path / "ck"), chaos_spec=f"tier_bitflip@{g_ranks.SWEEP['flip']}"))
    loop = TrainLoop(tr, log_every=0)
    want = loop.run(seed=0, max_steps=g_ranks.SWEEP["steps"])
    by = by_coords(guards_run)
    for k, ts in enumerate(want):
        got = _whole({c: r["sweep"]["all"] for c, r in by.items()},
                     lambda res, k=k: res["tables"][k])
        _close(got, ts.table.numpy())


# --------------------------------------------------------------- freshness ---


def _decoded(d):
    """``{table: {row: values}}`` of a delta directory, later batches over
    earlier ones, and the batches' ``(step, {table: rows})``."""
    latest, batches = {}, []
    for s in list_seqs(d):
        header, tables = read_batch(seg_path(d, s))
        batches.append((header["step"], {n: t["rows"].tolist() for n, t in tables.items()}))
        for name, t in tables.items():
            rows = latest.setdefault(name, {})
            for i, row in enumerate(t["rows"]):
                rows[int(row)] = np.array(t["values"][i])
    return latest, batches


def _rows_of(table: np.ndarray) -> np.ndarray:
    """A table's rows normalized to ``[n, 8]`` (a packed table's lanes)."""
    return table.reshape(table.shape[0], -1)[:, :8]


@pytest.mark.parametrize("case", ["resident", "tier"])
def test_leader_alone_writes_deltas_of_the_whole_rows(guards_run, case):
    """The leader's delta log holds the meshed run's whole rows, bit for
    bit (the last value published of every row is its final value); the
    other ranks write no directory and no ledger."""
    by = by_coords(guards_run)
    lead = by[(0, 0)]["fresh"][case]
    latest, batches = _decoded(lead["dir"])
    assert len(batches) == g_ranks.STEPS // g_ranks.FRESH_EVERY
    for k, name in enumerate(("in_table", "out_table")):
        whole = _rows_of(_whole({c: r["fresh"][case] for c, r in by.items()},
                                lambda res, k=k: res["tables"][k]))
        rows = sorted(latest[name])
        assert rows
        np.testing.assert_array_equal(np.stack([latest[name][i] for i in rows]), whole[rows])
    for c, r in by.items():
        res = r["fresh"][case]
        assert res["errors"] == 0
        if c != (0, 0):
            assert not os.path.exists(res["dir"]) and res["gaps"] is None


@pytest.mark.parametrize("case", ["resident", "tier"])
def test_deltas_equal_an_unmeshed_publish(guards_run, tmp_path, case):
    """The same batches published by the unmeshed port: the same rows at
    the same steps, the values within the tolerance."""
    route, tier = ("packed", None) if case == "resident" else ("dense", 1)
    keys = g_ranks.fresh_keys(str(tmp_path), case, 0)
    TrainLoop(tr_ranks.w2v_trainer(route, None, tier, **keys), log_every=0).run(
        seed=0, max_steps=g_ranks.STEPS)
    want_latest, want = _decoded(keys["freshness_dir"])
    got_latest, got = _decoded(by_coords(guards_run)[(0, 0)]["fresh"][case]["dir"])
    assert got == want
    for name, rows in want_latest.items():
        for row, values in rows.items():
            _close(got_latest[name][row], values)


def test_publish_error_on_one_rank_is_one_gap(guards_run):
    """The faulty rank's second drain fails: every rank counts one error
    and trains every step, the leader's ledger holds one
    ``freshness_gap``, and the later publishes land."""
    for r in guards_run:
        res = r["fresh"]["error"]
        assert res["errors"] == 1 and len(res["losses"]) == g_ranks.STEPS
    lead = by_coords(guards_run)[(0, 0)]["fresh"]["error"]
    assert lead["gaps"] == 1
    _, batches = _decoded(lead["dir"])
    assert [s for s, _ in batches] == [2, 6, 8]


def _hand_mesh(data=2, model=2, coords=None):
    return Mesh(shape={"data": data, "model": model},
                coords=coords or {"data": 0, "model": 0},
                groups={}, device=torch.device("cpu"))


@pytest.mark.parametrize("listen", ["", "127.0.0.1:0"], ids=["file", "listen"])
def test_hybrid_placement_with_freshness_matches_jax(tmp_path, capsys, listen):
    """``placement: hybrid`` with ``freshness_publish``: with
    ``freshness_listen`` both packages raise ``HybridFreshnessError`` with
    the same message; without it both disable publishing with the same
    notice."""
    over = {"placement": "hybrid", "freshness_publish": 2,
            "freshness_dir": str(tmp_path / "d")}
    if listen:
        over["freshness_listen"] = listen
    tr = tr_ranks.w2v_trainer("packed", _hand_mesh(), **over)
    jm = jax_mesh.make_mesh({"data": 2, "model": 2}, devices=jax.devices()[:4])
    ids, vocab = jax_paired_corpus(n_pairs=32, reps=200, seed=0)
    conf = tr_ranks.w2v_conf("packed", **over)
    conf.pop("use_native")
    jt = jax_w2v.Word2VecTrainer(JaxConfig(conf), mesh=jm, corpus_ids=ids, vocab=vocab)
    pm = JaxPlacementManager(jt, jm)
    assert pm.active
    if listen:
        with pytest.raises(JaxHybridError) as want:
            JaxTrainPublisher(jt, placement=pm)
        with pytest.raises(HybridFreshnessError) as got:
            TrainLoop(tr)
        assert str(got.value) == str(want.value)
        return
    capsys.readouterr()
    assert not JaxTrainPublisher(jt, placement=pm).active
    want = capsys.readouterr().err
    loop = TrainLoop(tr)
    assert loop.freshness is None and loop.placement is not None
    assert capsys.readouterr().err == want and "disabled under hybrid" in want


# ---------------------------------------------------------------- cluster ---


def test_leases_agree_and_equal_the_unmeshed_order(guards_run):
    """The kill-and-reassign script with the leader holding the lease:
    every rank applied the indices the leader committed, in its order
    (``w0`` adopts ``w1``'s span out of order), which is the unmeshed
    run's, with the same watermarks, exactly once."""
    lead = by_coords(guards_run)[(0, 0)]["cluster"]["reassign"]
    mine = [i for i in lead["commits"] if i not in (0, 1)]  # w1's two, before the loop
    assert lead["agreed"] == mine + [-1] and mine != sorted(mine)
    for r in guards_run:
        assert r["cluster"]["reassign"]["agreed"] == lead["agreed"]
        assert r["cluster"]["reassign"]["clustered"] == 1
    assert lead["exact"]["exact"] and lead["exact"]["committed"] == g_ranks.CLUSTER["total"]
    commits, undo = g_ranks.record_commits()
    try:
        client = g_ranks.reassign_client(g_ranks.FakeClock())
        loop = TrainLoop(tr_ranks.w2v_trainer("packed", None, prefetch_batches=0),
                         log_every=0, cluster=client)
        want = loop.run(seed=0, max_steps=g_ranks.CLUSTER["total"])
    finally:
        undo()
    assert commits == lead["commits"]
    assert loop.cluster.cursor() == lead["cursor"]
    by = by_coords(guards_run)
    for k, ts in enumerate(want):
        got = _whole({c: r["cluster"]["reassign"] for c, r in by.items()},
                     lambda res, k=k: res["tables"][k])
        _close(got, ts.table.numpy())


def test_preempt_and_resume_under_the_mesh_is_exactly_once(guards_run):
    """``cluster_workers: 1`` preempted at step 4 (drained at step 5 with a
    final save) and resumed: the two runs commit every index once, every
    rank agreed on each, and the resumed tables equal the straight run's,
    bit for bit."""
    lead = by_coords(guards_run)[(0, 0)]["cluster"]
    steps = g_ranks.RESUME["steps"]
    assert lead["preempted"]["preempted"] and not lead["resumed"]["preempted"]
    assert lead["preempted"]["commits"] + lead["resumed"]["commits"] == list(range(steps))
    assert lead["straight"]["commits"] == list(range(steps))
    for r in guards_run:
        c = r["cluster"]
        assert c["resumed"]["agreed"] == lead["resumed"]["commits"]
        assert c["preempted"]["agreed"][:-1] == lead["preempted"]["commits"]
        assert _tables_equal(c["resumed"]["tables"], c["straight"]["tables"])


def test_a_follower_given_a_cluster_raises():
    tr = tr_ranks.w2v_trainer("packed", _hand_mesh(coords={"data": 1, "model": 0}))
    with pytest.raises(ValueError, match="leader"):
        TrainLoop(tr, cluster=WorkerClient(Supervisor(total_batches=4), "w0"))


def test_loop_builds_every_guard_under_a_mesh(tmp_path):
    """All four guards on one meshed trainer: the guardrail votes over the
    mesh, the tier sweeps, the publisher opens, the leader holds the
    lease (the origin of a hand-made mesh)."""
    tr = tr_ranks.w2v_trainer("packed", _hand_mesh(), 1, guardrail=1, tier_verify_period=5,
                              freshness_publish=4, freshness_dir=str(tmp_path / "d"),
                              cluster_workers=1)
    loop = TrainLoop(tr)
    assert loop.guardrail.mesh is tr.mesh and loop.tier.mesh is tr.mesh
    assert loop.tier_verify_period == 5 and loop.freshness.mesh is tr.mesh
    assert loop.cluster is not None and loop.leader


def test_no_collective_off_the_loops_thread(guards_run):
    for r in guards_run:
        assert r["threads"]["main"] > 0
        assert r["threads"]["off"] == 0, r["threads"]["off_threads"][:5]
