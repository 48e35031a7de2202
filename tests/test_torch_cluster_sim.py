"""The simulated N-worker async-SGD cluster, its chaos lane, the drills,
``supervisor-status`` and the chaos-cluster gate, in the port, against the
JAX package's on the CPU.

The fleet runs under a virtual clock, so the scheduling (who ran which
batch, the ticks, the virtual seconds, the refused stale commits, the
accountant's proof, the supervisor's status) is a pure function of the
clock, the supervisor and the chaos plan, not of the RNG: both packages'
must be equal field for field. Only the losses differ (the port's step
draws from ``step_generator``, the JAX step from ``fold_in``)."""

import json

import pytest
import torch

from swiftsnails_tpu.cluster import chaos_lane as jax_lane
from swiftsnails_tpu.cluster import sim as jax_sim
from swiftsnails_tpu.cluster.status import render_supervisor_status as jax_render
from swiftsnails_tpu.resilience import chaos as jax_chaos
from swiftsnails_tpu.resilience import drill as jax_drill
from swiftsnails_tpu.telemetry import ledger as jax_ledger

from swiftsnails_tpu_torch import cli
from swiftsnails_tpu_torch.cluster import IndexedBatchSource, Supervisor, chaos_lane, sim
from swiftsnails_tpu_torch.cluster.status import (
    render_supervisor_status,
    supervisor_status_view,
)
from swiftsnails_tpu_torch.resilience.chaos import ChaosPlan, parse_chaos_spec
from swiftsnails_tpu_torch.resilience.drill import LOSS_PARITY_BAR, make_trainer
from swiftsnails_tpu_torch.telemetry.ledger import (
    Ledger,
    _check_chaos_cluster_regression,
    check_regression,
)
from swiftsnails_tpu_torch.tools import chaos_drill

SPECS = {
    "worker_kill": "worker_dead@10",
    "straggler": "worker_slow@12-24",
    "partition": "partition@10",
    "storm": chaos_lane.STORM_SPEC,
}
SCHEDULING = ("workers", "ticks", "virtual_s", "stale_rejected", "accounting", "status")
TOTAL = 48


class FakeClock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


@pytest.fixture(autouse=True)
def _one_thread():
    """The dense push (``index_put_`` with accumulate) is serial, so run to
    run equal, with one intra-op thread on the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trainers(tmp_path_factory):
    wd = str(tmp_path_factory.mktemp("cluster-sim"))
    return make_trainer(wd, device="cpu"), jax_drill.make_trainer(wd)


def test_constants_are_the_jax_lanes():
    assert (sim.SLOW_FACTOR, sim.BASE_STEP_S, sim.IDLE_TICK_S, sim.PARTITION_S) == (
        jax_sim.SLOW_FACTOR, jax_sim.BASE_STEP_S, jax_sim.IDLE_TICK_S, jax_sim.PARTITION_S)
    assert chaos_lane.STORM_SPEC == jax_lane.STORM_SPEC
    assert chaos_lane.CLUSTER_DRILLS == jax_lane.CLUSTER_DRILLS
    assert LOSS_PARITY_BAR == jax_drill.LOSS_PARITY_BAR


@pytest.mark.parametrize("drill", list(SPECS))
@pytest.mark.parametrize("supervised", [True, False])
def test_simulate_cluster_schedules_as_jax_does(trainers, drill, supervised, tmp_path):
    """For each cluster drill, supervised and not: the scheduling fields of
    both packages' results are equal, and so are the ledgers' membership
    and chaos events."""
    mine_tr, jax_tr = trainers
    led, jled = Ledger(str(tmp_path / "p.jsonl")), jax_ledger.Ledger(str(tmp_path / "j.jsonl"))
    mine = sim.simulate_cluster(
        mine_tr, TOTAL, workers=3, supervised=supervised, ledger=led,
        chaos=ChaosPlan(parse_chaos_spec(SPECS[drill]), seed=7, ledger=led))
    theirs = jax_sim.simulate_cluster(
        jax_tr, TOTAL, workers=3, supervised=supervised, ledger=jled,
        chaos=jax_chaos.ChaosPlan(jax_chaos.parse_chaos_spec(SPECS[drill]), seed=7,
                                  ledger=jled))
    for field in SCHEDULING:
        assert (field in mine) == (field in theirs)
        if field in theirs:
            assert mine[field] == theirs[field], field

    def events(ledger):
        return [{k: v for k, v in r.items() if k not in ("ts", "env")}
                for r in ledger.records() if r["kind"] in ("membership", "chaos")]

    assert events(led) == events(jled)
    assert len(mine["order"]) == sum(w["applied"] for w in mine["workers"].values())


def test_protected_order_replays_bit_equal(trainers):
    """Replaying the protected storm leg's committed order through
    ``run_inorder_control``'s step gives tables bit-equal to the leg's: a
    batch applies identically whoever runs it and whenever."""
    mine_tr, _ = trainers
    res = sim.simulate_cluster(
        mine_tr, TOTAL, workers=3, supervised=True,
        chaos=ChaosPlan(parse_chaos_spec(chaos_lane.STORM_SPEC), seed=7))
    assert sorted(res["order"]) == list(range(TOTAL))
    assert res["order"] != list(range(TOTAL))  # the storm reordered the stream
    step = sim.make_step_fn(mine_tr)
    src = IndexedBatchSource(mine_tr.batches)
    replay = mine_tr.init_state()
    for i in res["order"]:
        replay = step(replay, src.get(i), i)
    src.close()
    for a, b in ((res["state"].in_table.table, replay.in_table.table),
                 (res["state"].out_table.table, replay.out_table.table)):
        assert torch.equal(a, b)
    control = sim.run_inorder_control(mine_tr, TOTAL)
    assert not torch.equal(control.out_table.table, res["state"].out_table.table)


@pytest.fixture(scope="module")
def blocks(tmp_path_factory):
    """Each package's ``chaos_cluster_bench`` block for each cluster drill."""
    out = {}
    for name, spec in SPECS.items():
        d = tmp_path_factory.mktemp(name)
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            mine = chaos_lane.chaos_cluster_bench(small=True, workdir=str(d / "p"),
                                                  spec=spec, device="cpu")
        finally:
            torch.set_num_threads(n)
        out[name] = (mine, jax_lane.chaos_cluster_bench(small=True, workdir=str(d / "j"),
                                                        spec=spec))
    return out


@pytest.mark.parametrize("drill", list(SPECS))
def test_chaos_cluster_bench_matches_jax_but_the_losses(blocks, drill):
    mine, theirs = blocks[drill]
    assert set(mine) == set(theirs)
    loss = ("loss", "control_loss", "loss_parity")
    assert {k: v for k, v in mine.items() if k not in loss} == {
        k: v for k, v in theirs.items() if k not in loss}
    checks = chaos_lane._drill_checks(drill, mine)
    assert checks == jax_lane._drill_checks(drill, theirs)
    assert all(checks.values()), checks
    assert all(jax_lane._drill_checks(drill, theirs).values())


def test_run_cluster_drills_all_recover(tmp_path):
    results = chaos_lane.run_cluster_drills(workdir=str(tmp_path), device="cpu")
    assert list(results) == list(chaos_lane.CLUSTER_DRILLS)
    failed = {k: v["checks"] for k, v in results.items() if not v["recovered"]}
    assert not failed, failed
    assert results["storm"]["workers_lost"] >= 1 and results["storm"]["stragglers_flagged"] >= 1


def test_chaos_cluster_bench_legs_free_their_state(tmp_path):
    """The legs' raw results come back without their tables (each leg's
    state is dropped once its loss is read)."""
    legs = {}
    block = chaos_lane.chaos_cluster_bench(small=True, workdir=str(tmp_path), device="cpu",
                                           legs=legs)
    assert set(legs) == {"control", "protected", "unprotected"}
    assert "state" not in legs["protected"] and "state" not in legs["unprotected"]
    assert legs["protected"]["accounting"]["exact"] and block["accounting_exact"]


# ------------------------------------------- status, CLI, tool and gate ----


def _cluster_block(**over):
    block = {
        "workers": 3, "total_batches": 48, "committed": 48, "lost_count": 0,
        "duplicated_count": 0, "dup_discarded": 2, "stale_rejected": 1,
        "workers_lost": 1, "reassignments": 1, "stragglers_flagged": 1,
        "accounting_exact": True, "finite": True, "loss_parity": 0.001,
        "parity_bar": 0.05, "unprotected_lost_count": 13,
        "unprotected_hard_failure": True, "recovered": True,
    }
    block.update(over)
    return block


def _membership_ledger(path):
    led = Ledger(path)
    sup = Supervisor(total_batches=8, lease_ms=1000.0, ledger=led, clock=FakeClock())
    sup.register("w0")
    sup.register("w1")
    sup.next_range("w0")
    sup.mark_dead("w0", reason="killed")
    led.append("bench", {"payload": {"chaos_cluster": _cluster_block()}})
    return led


def test_supervisor_status_renders_as_jax_does(tmp_path):
    path = str(tmp_path / "led.jsonl")
    _membership_ledger(path)
    assert render_supervisor_status(Ledger(path)) == jax_render(jax_ledger.Ledger(path))
    view = supervisor_status_view(Ledger(path))
    assert view["workers"]["w0"]["state"] == "lost"
    assert view["counts"]["worker-lost"] == 1 and view["chaos_cluster"]["committed"] == 48


def test_supervisor_status_cli(tmp_path, capsys):
    path = str(tmp_path / "led.jsonl")
    _membership_ledger(path)
    assert cli.main(["supervisor-status", path]) == 0
    out = capsys.readouterr().out
    assert "w0" in out and "lost" in out and "killed" in out
    assert "w1" in out and "alive" in out
    assert "accounting: 48/48" in out
    assert cli.main(["supervisor-status", str(tmp_path / "nope.jsonl")]) == 1


@pytest.mark.parametrize("name,over", [
    ("ok", {}),
    ("lost", {"lost_count": 3, "accounting_exact": False}),
    ("dup", {"duplicated_count": 1}),
    ("parity", {"loss_parity": 0.2}),
    ("storm", {"unprotected_hard_failure": False}),
    ("no-loss", {"workers_lost": 0, "reassignments": 0}),
])
def test_check_regression_gates_cluster_accounting(tmp_path, name, over):
    """The chaos-cluster gate over crafted ledgers: the port's verdict and
    message equal the JAX gate's, and ``check_regression`` carries them."""
    path = str(tmp_path / f"{name}.jsonl")
    led = Ledger(path)
    led.append("bench", {"payload": {"value": 1000.0, "platform": "gpu",
                                     "chaos_cluster": _cluster_block(**over)}})
    mine = _check_chaos_cluster_regression(led)
    assert mine == jax_ledger._check_chaos_cluster_regression(jax_ledger.Ledger(path))
    rc, msg = check_regression(led, 10.0)
    if name == "ok":
        assert rc == 0 and "chaos-cluster ok" in msg, msg
    else:
        assert rc == 1 and "chaos-cluster REGRESSION" in msg, msg


def test_chaos_drill_cluster_flag(tmp_path, capsys, monkeypatch):
    """``--cluster`` surfaces per-drill verdicts and the exit code reflects
    recovery (the JAX tool's case, with a stubbed matrix)."""
    fake = {
        "worker_kill": {
            "recovered": True, "checks": {"accounting_exact": True},
            "lost": 0, "duplicated": 0, "dup_discarded": 1,
            "stale_rejected": 0, "loss_parity": 0.0,
            "workers_lost": 1, "reassignments": 1, "stragglers_flagged": 0,
        },
        "partition": {
            "recovered": False, "checks": {"accounting_exact": False},
            "lost": 2, "duplicated": 0, "dup_discarded": 0,
            "stale_rejected": 0, "loss_parity": 0.0,
            "workers_lost": 1, "reassignments": 0, "stragglers_flagged": 0,
        },
    }
    monkeypatch.setattr(chaos_lane, "run_cluster_drills",
                        lambda workdir=None, small=True, device=None: fake)
    rc = chaos_drill.main(["--cluster", "--json"])
    out = json.loads(capsys.readouterr().out)
    assert rc == 1 and out["failed"] == ["partition"]
    rc = chaos_drill.main(["--cluster"])
    text = capsys.readouterr().out
    assert rc == 1
    assert "UNRECOVERED" in text and "FAILED-CHECKS: accounting_exact" in text


def test_chaos_drill_cluster_matrix_on_the_cpu(tmp_path, capsys):
    rc = chaos_drill.main(["--cluster", "--device", "cpu", "--workdir", str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "4/4 drills recovered" in out
