"""The chaos-serve lane of the port (``serving/chaos_lane.py``) on the CPU:
the protected and unprotected legs, ``reload_corrupt`` on the port's
checkpoints, the ``tier_bitflip`` drill on the port's tier, the fault hook
against the JAX plan's schedule, the chaos-serve gate over crafted ledgers
against the JAX gate, and ``chaos_drill --serve``.

The lane's deterministic fields are held (each request is one dispatch, so
the fault schedule decides which fail); its latencies are not."""

import pytest

from swiftsnails_tpu.resilience import chaos as jax_chaos
from swiftsnails_tpu.serving import chaos_lane as jax_lane
from swiftsnails_tpu.telemetry import ledger as jax_ledger

from swiftsnails_tpu_torch.resilience.chaos import ChaosPlan, parse_chaos_spec
from swiftsnails_tpu_torch.serving import chaos_lane
from swiftsnails_tpu_torch.serving.chaos_lane import chaos_serve_bench
from swiftsnails_tpu_torch.telemetry.ledger import (
    Ledger,
    _check_chaos_serve_regression,
    check_regression,
)
from swiftsnails_tpu_torch.tools import chaos_drill


def test_constants_are_the_jax_lanes():
    assert chaos_lane.AVAILABILITY_FLOOR_PCT == jax_lane.AVAILABILITY_FLOOR_PCT
    assert chaos_lane._SLOW_MS == jax_lane._SLOW_MS


@pytest.fixture(scope="module")
def lane(tmp_path_factory):
    d = tmp_path_factory.mktemp("chaos-serve")
    path = str(d / "l.jsonl")
    block = chaos_serve_bench(small=True, workdir=str(d / "w"), ledger=Ledger(path),
                              device="cpu")
    return block, Ledger(path)


def test_chaos_serve_lane_holds_its_gates(lane):
    block, _ = lane
    assert block["unprotected_hard_failure"]
    assert "OSError" in block["control_first_error"]
    assert block["control_availability_pct"] < block["availability_pct"]
    assert block["availability_pct"] >= block["floor_pct"]
    assert block["reload_corrupt_rejected"]
    assert "CheckpointError" in block["reload_corrupt_error"]
    assert block["tier_bitflip"]["recovered"], block["tier_bitflip"]
    assert block["tier_bitflip"]["rebuilt_tables"] == ["in_table"]


def test_chaos_serve_lane_trips_and_records(lane):
    block, led = lane
    assert block["degraded_share_pct"] > 0  # stale reads carried the storm
    assert block["breaker"]["trips"] >= 1
    assert led.latest("breaker") is not None and led.latest("degraded") is not None
    faults = [r["fault"] for r in led.records("chaos")]
    # the breaker's threshold is 3 failures; later faults fire as its
    # cooldown lets dispatches through, which the wall clock decides
    assert faults.count("serve_io_error") >= 3 and faults.count("reload_corrupt") == 1
    assert "ckpt_corrupt" in faults
    assert led.latest("cache_error")["source"] == "serve_reload"


def test_fault_hook_fires_the_jax_plans_schedule():
    """The lane's hook over the port's plan raises and stalls at the
    request indices the JAX plan's ``serve_fault`` names."""
    spec = "serve_io_error@0-2,serve_slow@4,serve_io_error@6"
    hook = chaos_lane._fault_hook(ChaosPlan(parse_chaos_spec(spec), seed=11), slow_ms=0.0)
    jplan = jax_chaos.ChaosPlan(jax_chaos.parse_chaos_spec(spec), seed=11)
    for i in range(8):
        want = jplan.serve_fault(i)
        try:
            hook("pull", i)
            got = None if want != "serve_slow" else "serve_slow"
        except OSError:
            got = "serve_io_error"
        assert got == want, i


_GOOD_BLOCK = {
    "floor_pct": 99.0, "availability_pct": 100.0,
    "unprotected_hard_failure": True, "reload_corrupt_rejected": True,
    "tier_bitflip": {"recovered": True},
}


def _bench_record(value, chaos_serve=None, platform="gpu"):
    payload = {
        "metric": "word2vec_words_per_sec_per_chip", "value": value,
        "unit": "words/sec/chip", "platform": platform, "config": {},
    }
    if chaos_serve is not None:
        payload["chaos_serve"] = chaos_serve
    return {"payload": payload}


@pytest.mark.parametrize("name,over", [
    ("ok", {}),
    ("floor", {"availability_pct": 92.0}),
    ("control", {"unprotected_hard_failure": False}),
    ("reload", {"reload_corrupt_rejected": False}),
    ("tier", {"tier_bitflip": {"recovered": False}}),
])
def test_chaos_serve_gate_matches_jax(tmp_path, name, over):
    path = str(tmp_path / "l.jsonl")
    led = Ledger(path)
    led.append("bench", _bench_record(100_000.0, chaos_serve={**_GOOD_BLOCK, **over}))
    mine = _check_chaos_serve_regression(led)
    assert mine == jax_ledger._check_chaos_serve_regression(jax_ledger.Ledger(path))
    assert (mine[0] == 0) == (name == "ok")


def test_check_regression_gates_availability_floor(tmp_path):
    led = Ledger(str(tmp_path / "l.jsonl"))
    led.append("bench", _bench_record(100_000.0, chaos_serve=_GOOD_BLOCK))
    led.append("bench", _bench_record(
        101_000.0, chaos_serve={**_GOOD_BLOCK, "availability_pct": 92.0}))
    rc, msg = check_regression(led, 10.0)
    assert rc != 0 and "chaos-serve REGRESSION" in msg and "92.0%" in msg


def test_check_regression_gates_control_and_drills(tmp_path):
    led = Ledger(str(tmp_path / "l.jsonl"))
    led.append("bench", _bench_record(100_000.0, chaos_serve=_GOOD_BLOCK))
    led.append("bench", _bench_record(101_000.0, chaos_serve={
        **_GOOD_BLOCK, "unprotected_hard_failure": False}))
    rc, msg = check_regression(led, 10.0)
    assert rc != 0 and "chaos-serve REGRESSION" in msg
    led.append("bench", _bench_record(102_000.0, chaos_serve={
        **_GOOD_BLOCK, "tier_bitflip": {"recovered": False}}))
    rc, msg = check_regression(led, 10.0)
    assert rc != 0 and "chaos-serve REGRESSION" in msg
    led.append("bench", _bench_record(103_000.0, chaos_serve=_GOOD_BLOCK))
    rc, msg = check_regression(led, 10.0)
    assert rc == 0 and "chaos-serve ok" in msg


def test_chaos_drill_serve_flag(tmp_path, capsys, monkeypatch):
    """``--serve``'s checks and exit code, the JAX tool's, over a stubbed
    lane (the real one runs in the fixture above)."""
    blocks = {"ok": {**_GOOD_BLOCK, "degraded_share_pct": 50.0, "p99_under_fault_ms": 1.0,
                     "trip_ms": 0.1, "recover_ms": 60.0, "control_availability_pct": 75.0,
                     "control_first_error": "OSError: x"}}
    blocks["bad"] = {**blocks["ok"], "reload_corrupt_rejected": False}
    for name, want_rc in (("ok", 0), ("bad", 1)):
        monkeypatch.setattr(chaos_lane, "chaos_serve_bench",
                            lambda small=True, workdir=None, device=None, b=blocks[name]: b)
        assert chaos_drill.main(["--serve", "--device", "cpu"]) == want_rc
        out = capsys.readouterr().out
        assert ("serve matrix PASSED" in out) == (want_rc == 0)
