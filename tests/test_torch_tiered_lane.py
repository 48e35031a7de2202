"""The port's ``tiered`` lane and the tiered CI gate, on the CPU.

``tiered_bench(small=True, device="cpu")`` must give the block the JAX lane
gives: equal-vocab words/sec against the resident store, the bit-parity
verdict, the over-budget (vocab 4x the budget) train -> checkpoint -> serve
round trip and the int8-master leg. ``ledger-report --check-regression``
must gate the tiered words/sec floor and hard-fail any record whose parity
or round trip broke — with the JAX gate's codes and messages
(``tests/test_tiered_lane.py``'s cases, each ledger read by both packages'
``_check_tiered_regression``).
"""

import torch

from swiftsnails_tpu.telemetry import ledger as jax_ledger
from swiftsnails_tpu_torch.telemetry.ledger import (
    Ledger,
    _check_tiered_regression,
    check_regression,
    main as ledger_main,
)
from swiftsnails_tpu_torch.tiered.bench_lane import tiered_bench

# one intra-op thread: the CPU scatter-add of the resident dense push is
# serial (so deterministic) only then
torch.set_num_threads(1)


def test_tiered_lane_smoke(tmp_path):
    led = Ledger(str(tmp_path / "ledger.jsonl"))
    block = tiered_bench(small=True, workdir=str(tmp_path), ledger=led, device="cpu")
    assert block["words_per_sec"] > 0 and block["resident_words_per_sec"] > 0
    assert block["tiered_over_resident"] > 0
    assert block["parity_bit_identical"] is True
    ob = block["over_budget"]
    assert ob["vocab_units"] >= 4 * ob["budget_slots"]
    assert ob["evictions"] > 0 and ob["flushed_rows"] > 0
    assert ob["parity_bit_identical"] and ob["serve_pull_ok"] and ob["round_trip_ok"]
    assert block["round_trip_ok"] is True
    q = block["quantized"]
    assert q["ok"] and block["quantized_ok"] is True
    assert q["capacity_ratio_vs_f32"] >= 2.0 and q["digests_clean"]
    bd = block["breakdown"]
    for key in ("plan_ns", "fault_ns", "flush_ns", "remap_ns", "h2d_ns",
                "flush_wait_ns", "flush_queue_depth"):
        assert key in bd, bd
    rec = led.latest("tiered_lane")
    assert rec is not None and rec["words_per_sec"] == block["words_per_sec"]


# ------------------------------------------------- tiered CI gate ----------


def _bench_record(value, tiered=None, platform="tpu"):
    payload = {"metric": "word2vec_words_per_sec_per_chip", "value": value,
               "unit": "words/sec/chip", "platform": platform, "config": {}}
    if tiered is not None:
        payload["tiered"] = tiered
    return {"payload": payload}


def _tiered_block(wps, parity=True, round_trip=True, ratio=None, quantized=None):
    block = {"words_per_sec": wps, "parity_bit_identical": parity,
             "round_trip_ok": round_trip}
    if ratio is not None:
        block["tiered_over_resident"] = ratio
    if quantized is not None:
        block["quantized"] = quantized
    return block


def _same_as_jax(path):
    """Both packages' sub-check on one ledger file: equal code and message."""
    got = _check_tiered_regression(Ledger(path), 10.0)
    want = jax_ledger._check_tiered_regression(jax_ledger.Ledger(path), 10.0)
    assert got == want
    return got


def test_check_regression_gates_tiered_words_per_sec(tmp_path):
    path = str(tmp_path / "l.jsonl")
    led = Ledger(path)
    led.append("bench", _bench_record(100_000.0, _tiered_block(50_000.0)))
    led.append("bench", _bench_record(101_000.0, _tiered_block(20_000.0)))
    rc, msg = check_regression(led, 10.0)
    assert rc == 1 and "tiered REGRESSION" in msg
    assert msg.splitlines()[0].startswith("ok:")
    assert _same_as_jax(path)[0] == 1


def test_check_regression_tiered_parity_failure_is_fatal_any_platform(tmp_path):
    path = str(tmp_path / "l.jsonl")
    led = Ledger(path)
    led.append("bench", _bench_record(100_000.0, _tiered_block(50_000.0, parity=False)))
    rc, msg = check_regression(led, 10.0)
    assert rc == 1 and "correctness gate" in msg
    assert _same_as_jax(path)[0] == 1
    path2 = str(tmp_path / "l2.jsonl")
    led2 = Ledger(path2)
    led2.append("bench", _bench_record(
        100_000.0, _tiered_block(50_000.0, round_trip=False), platform="cpu"))
    rc, msg = check_regression(led2, 10.0)
    assert rc != 0 and "tiered REGRESSION" in msg
    assert _same_as_jax(path2)[0] == 1


def test_check_regression_tiered_ok_and_single_record(tmp_path):
    path = str(tmp_path / "l.jsonl")
    led = Ledger(path)
    led.append("bench", _bench_record(100_000.0, _tiered_block(50_000.0)))
    rc, msg = check_regression(led, 10.0)
    assert rc == 0 and "tiered: single" in msg
    led.append("bench", _bench_record(99_000.0, _tiered_block(48_000.0)))
    rc, msg = check_regression(led, 10.0)
    assert rc == 0 and "tiered ok" in msg
    assert _same_as_jax(path)[0] == 0
    led.append("bench", _bench_record(10_000.0, _tiered_block(49_000.0)))
    rc, msg = check_regression(led, 10.0)
    assert rc == 1 and "REGRESSION" in msg.splitlines()[0]


def test_check_regression_gates_tiered_resident_ratio(tmp_path):
    path = str(tmp_path / "l.jsonl")
    led = Ledger(path)
    led.append("bench", _bench_record(100_000.0, _tiered_block(50_000.0, ratio=1.01)))
    led.append("bench", _bench_record(101_000.0, _tiered_block(51_000.0, ratio=0.88)))
    rc, msg = check_regression(led, 10.0)
    assert rc == 1 and "resident speed" in msg
    assert _same_as_jax(path)[0] == 1
    led.append("bench", _bench_record(102_000.0, _tiered_block(52_000.0, ratio=0.96)))
    rc, msg = check_regression(led, 10.0)
    assert rc == 0 and "tiered ok" in msg
    path2 = str(tmp_path / "l2.jsonl")
    led2 = Ledger(path2)
    led2.append("bench", _bench_record(100_000.0, _tiered_block(50_000.0)))
    led2.append("bench", _bench_record(99_000.0, _tiered_block(49_000.0)))
    rc, msg = check_regression(led2, 10.0)
    assert rc == 0 and "tiered ok" in msg


def test_check_regression_gates_the_int8_leg(tmp_path):
    """A failed quantized-master leg fails the gate, naming what failed."""
    path = str(tmp_path / "l.jsonl")
    led = Ledger(path)
    led.append("bench", _bench_record(100_000.0, _tiered_block(50_000.0, quantized={
        "ok": False, "digests_clean": True, "serve_requant_exact": True,
        "checkpoint_dtype_f32": True, "capacity_ratio_vs_f32": 1.5,
        "master_rel_err_vs_f32": 0.2, "rel_err_budget": 0.05})))
    rc, msg = _same_as_jax(path)
    assert rc == 1 and "capacity_ratio_vs_f32=1.5" in msg and "0.2" in msg


def test_check_regression_without_tiered_blocks_is_headline_only(tmp_path):
    path = str(tmp_path / "l.jsonl")
    led = Ledger(path)
    led.append("bench", _bench_record(100_000.0))
    led.append("bench", _bench_record(99_000.0))
    rc, msg = check_regression(led, 10.0)
    assert rc == 0 and "tiered" not in msg
    assert _same_as_jax(path) == (0, None)


def test_ledger_report_cli_gates_the_tiered_lane(tmp_path, capsys):
    path = str(tmp_path / "l.jsonl")
    Ledger(path).append("bench", _bench_record(
        100_000.0, _tiered_block(50_000.0, round_trip=False)))
    rc = ledger_main([path, "--check-regression", "10"])
    assert rc == 1 and "tiered REGRESSION" in capsys.readouterr().out
