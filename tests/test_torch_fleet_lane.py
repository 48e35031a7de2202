"""The fleet lane of the port (``serving/fleet_lane.py``) on the CPU: its
constants and its ladder (the sweep's rungs, the bisection and the
confirmation pass) against the JAX lane's, driven by the same stubbed load
generator so no wall clock decides them; the fleet gate over crafted
ledgers against the JAX gate; and both lanes end to end, held to their
structure (their latencies are the host's, not gated here).

The JAX ``test_fleet_lane_smoke`` asserts a sustained rate above zero at a
60 ms p99 on a loaded test machine, and fails under ``-n 6``; the port's
tests inject the load generator or check only what the schedule decides."""

import pytest

from swiftsnails_tpu.serving import fleet_lane as jax_lane
from swiftsnails_tpu.telemetry import ledger as jax_ledger

from swiftsnails_tpu_torch.serving import fleet_lane
from swiftsnails_tpu_torch.serving.fleet_lane import fleet_bench, fleet_chaos_drill
from swiftsnails_tpu_torch.telemetry.ledger import (
    Ledger,
    _check_fleet_regression,
    check_regression,
)
from swiftsnails_tpu_torch.tools import chaos_drill


def test_constants_are_the_jax_lanes():
    for name in ("FLEET_SEED", "SLO_P99_MS", "SERVICE_FLOOR_MS", "BATCH", "ZIPF_A",
                 "SCALING_FLOOR", "AVAILABILITY_FLOOR_PCT", "TRACE_OVERHEAD_CEIL_PCT",
                 "TRACE_SAMPLE_RATE", "_BASE_QPS", "_LADDER_GROWTH", "_MAX_POINTS",
                 "_REFINE_RATIO"):
        assert getattr(fleet_lane, name) == getattr(jax_lane, name), name
    assert (fleet_lane.SLO_P99_MS, fleet_lane.SERVICE_FLOOR_MS, fleet_lane.SCALING_FLOOR,
            fleet_lane.AVAILABILITY_FLOOR_PCT) == (60.0, 6.0, 1.6, 99.0)


class _NoFleet:
    def replicas(self):
        return []


def _stub_loadgen(knee_qps, calls):
    """A load generator whose p99 is a step at ``knee_qps``, with no clock."""

    def run(submit, *, qps, duration_s, seed, id_space, batch, zipf_a, **_):
        calls.append((round(qps, 6), seed))
        p99 = 20.0 if qps <= knee_qps else 90.0
        return {"offered_qps": qps, "achieved_qps": qps, "p50_ms": 5.0, "p95_ms": 10.0,
                "p99_ms": p99, "error_rate_pct": 0.0, "requests": 1,
                "duration_s": duration_s}

    return run


@pytest.mark.parametrize("knee", [0.0, 45.0, 200.0, 1e9])
@pytest.mark.parametrize("max_points", [3, 12])
def test_sweep_and_confirm_match_jax(monkeypatch, knee, max_points):
    """The same stubbed traffic through both lanes' ladder: the same rungs
    in the same order with the same seeds, the same bisection, the same
    sustained rate; then the confirmation pass at it."""
    monkeypatch.setattr(fleet_lane.time, "sleep", lambda s: None)
    monkeypatch.setattr(jax_lane.time, "sleep", lambda s: None)
    mine_calls, jax_calls = [], []
    monkeypatch.setattr(fleet_lane, "run_open_loop", _stub_loadgen(knee, mine_calls))
    monkeypatch.setattr(jax_lane, "run_open_loop", _stub_loadgen(knee, jax_calls))
    monkeypatch.setattr(fleet_lane, "_MAX_POINTS", max_points)
    monkeypatch.setattr(jax_lane, "_MAX_POINTS", max_points)
    kw = dict(capacity=2048, duration_s=0.7, slo_ms=60.0, seed=13)
    mine = fleet_lane._sweep(_NoFleet(), **kw)
    theirs = jax_lane._sweep(_NoFleet(), **kw)
    assert mine == theirs and mine_calls == jax_calls
    if mine["max_qps"] > 0:
        got = fleet_lane._confirm(_NoFleet(), qps=mine["max_qps"], **kw)
        want = jax_lane._confirm(_NoFleet(), qps=theirs["max_qps"], **kw)
        assert got == want and mine_calls == jax_calls


def test_hooks_model_the_service_floor(monkeypatch):
    slept = []
    monkeypatch.setattr(fleet_lane.time, "sleep", slept.append)
    fleet_lane._floor_hook(6.0)("pull", 0)
    stall = fleet_lane._stall_hook(6.0, 80.0, every=5)
    for i in range(5):
        stall("pull", i)
    assert slept == [0.006] + [0.006] * 5 + [0.08]


@pytest.fixture(scope="module")
def bench_block(tmp_path_factory):
    """The lane with its ladder cut to 4 rungs (the structure is the
    point here, and each rung is 0.7 s of open-loop traffic)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(fleet_lane, "_MAX_POINTS", 4)
    try:
        return fleet_bench(small=True, workdir=str(tmp_path_factory.mktemp("fleet")),
                           device="cpu")
    finally:
        mp.undo()


def test_fleet_bench_block_has_the_jax_lanes_fields(bench_block):
    block = bench_block
    assert block["replicas"] == 2 and block["scaling_floor"] == 1.6
    assert block["slo_p99_ms"] == 60.0 and block["service_floor_ms"] == 6.0
    assert block["qps"] == block["fleet"]["max_qps"]
    assert set(block) == {"seed", "small", "replicas", "slo_p99_ms", "service_floor_ms",
                          "batch", "zipf_a", "duration_s", "single", "fleet",
                          "scaling_x", "scaling_floor", "affinity", "hedge",
                          "trace_overhead", "qps", "p99_ms", "elapsed_s"}
    assert 1 <= len(block["single"]["points"]) and 1 <= len(block["fleet"]["points"])
    aff = block["affinity"]
    assert 0.0 <= aff["random_hit_rate"] <= 1.0 and 0.0 <= aff["affinity_hit_rate"] <= 1.0
    hedge = block["hedge"]
    assert hedge["p99_ms"] > 0 and hedge["nohedge_p99_ms"] > 0 and hedge["budget_pct"] == 30.0
    assert block["trace_overhead"]["reps"] == 3


def test_fleet_chaos_drill_reroutes_around_the_killed_replica(tmp_path):
    results = fleet_chaos_drill(small=True, workdir=str(tmp_path), device="cpu")
    assert set(results) == {"kill_replica", "slow_replica"}
    kill = results["kill_replica"]
    assert kill["victim"] == "r1" and kill["reroutes"] > 0
    assert kill["victim_breaker_trips"] >= 1 and kill["trace_trees_complete"]
    for res in results.values():
        assert res["floor_pct"] == 99.0 and res["requests"] > 0


def _fleet_block(qps=300.0, p99=30.0, slo=60.0, scaling=1.8, replicas=2,
                 affinity=(0.44, 0.35), hedge=(40.0, 90.0)):
    return {
        "qps": qps, "p99_ms": p99, "slo_p99_ms": slo,
        "scaling_x": scaling, "scaling_floor": 1.6, "replicas": replicas,
        "affinity": {"affinity_hit_rate": affinity[0],
                     "random_hit_rate": affinity[1]},
        "hedge": {"p99_ms": hedge[0], "nohedge_p99_ms": hedge[1]},
    }


def _bench_record(value, fleet=None, platform="gpu"):
    payload = {
        "metric": "word2vec_words_per_sec_per_chip", "value": value,
        "unit": "words/sec/chip", "platform": platform, "config": {},
    }
    if fleet is not None:
        payload["fleet"] = fleet
    return {"payload": payload}


@pytest.mark.parametrize("blocks", [
    [_fleet_block()],
    [_fleet_block(p99=75.0, slo=60.0)],
    [_fleet_block(scaling=1.3)],
    [_fleet_block(affinity=(0.30, 0.35), hedge=(95.0, 90.0))],
    [_fleet_block(qps=300.0), _fleet_block(qps=100.0)],
    [_fleet_block(qps=300.0), _fleet_block(qps=100.0), _fleet_block(qps=310.0)],
])
def test_fleet_gate_matches_jax(tmp_path, blocks):
    path = str(tmp_path / "l.jsonl")
    led = Ledger(path)
    for i, b in enumerate(blocks):
        led.append("bench", _bench_record(100_000.0 + i, fleet=b))
    assert _check_fleet_regression(led, 10.0) == jax_ledger._check_fleet_regression(
        jax_ledger.Ledger(path), 10.0)


def test_fleet_gate_trips_on_slo_breach(tmp_path):
    led = Ledger(str(tmp_path / "l.jsonl"))
    led.append("bench", _bench_record(
        100_000.0, fleet=_fleet_block(p99=75.0, slo=60.0)))
    rc, msg = check_regression(led, 10.0)
    assert rc == 1 and "fleet REGRESSION" in msg and "SLO" in msg


def test_fleet_gate_trips_on_scaling_floor(tmp_path):
    led = Ledger(str(tmp_path / "l.jsonl"))
    led.append("bench", _bench_record(100_000.0, fleet=_fleet_block(scaling=1.3)))
    rc, msg = check_regression(led, 10.0)
    assert rc == 1 and "fleet REGRESSION" in msg
    assert "below the 1.6x floor" in msg


def test_fleet_gate_qps_floor_and_recovery(tmp_path):
    led = Ledger(str(tmp_path / "l.jsonl"))
    led.append("bench", _bench_record(100_000.0, fleet=_fleet_block(qps=300.0)))
    led.append("bench", _bench_record(101_000.0, fleet=_fleet_block(qps=100.0)))
    rc, msg = check_regression(led, 10.0)
    assert rc == 1 and "fleet REGRESSION" in msg and "fleet qps" in msg
    assert msg.splitlines()[0].startswith("ok:")  # headline itself was fine
    led.append("bench", _bench_record(102_000.0, fleet=_fleet_block(qps=310.0)))
    rc, msg = check_regression(led, 10.0)
    assert rc == 0 and "fleet ok" in msg


def test_fleet_gate_qps_is_platform_scoped(tmp_path):
    led = Ledger(str(tmp_path / "l.jsonl"))
    led.append("bench", _bench_record(100_000.0, fleet=_fleet_block(qps=50_000.0)))
    led.append("bench", _bench_record(101_000.0, fleet=_fleet_block(qps=200.0),
                                      platform="cpu"))
    rc, msg = check_regression(led, 10.0)
    assert rc == 0 and "single cpu record" in msg


def test_chaos_drill_fleet_flag(capsys, monkeypatch):
    res = {"availability_pct": 100.0, "floor_pct": 99.0, "p99_ms": 10.0, "reroutes": 3,
           "hedged": 1, "hedge_won": 1, "victim": "r1", "victim_breaker_trips": 1,
           "anomaly_traces": 2, "trace_trees_complete": True, "trace_id": "t",
           "trace_export": None}
    fake = {"kill_replica": {**res, "recovered": True},
            "slow_replica": {**res, "recovered": False}}
    monkeypatch.setattr(fleet_lane, "fleet_chaos_drill",
                        lambda small=True, workdir=None, device=None: fake)
    assert chaos_drill.main(["--fleet", "--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert "1/2 drills recovered; FAILED: slow_replica" in out
