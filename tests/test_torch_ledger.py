"""The port's run ledger against the JAX package's: a ledger written by
either package renders the same text in both (``render_report``,
``render_failures``, ``render_diff``), the ported ``check_regression``
checks give the same exit codes and messages, ``ledger-report``'s ``main``
the same output, and a torn tail heals on the next append."""

import json
import os
import sys

import pytest

from swiftsnails_tpu.telemetry import ledger as jax_ledger

from swiftsnails_tpu_torch.telemetry import ledger


def _goodput(wall_s, host_blocked_s, steps=30, items=30_000):
    return {
        "peaks": {"flops_per_s": 989e12, "hbm_bytes_per_s": 3.35e12,
                  "ici_bytes_per_s": 450e9, "source": "builtin table (h100)"},
        "decomposition": {"wall_s": wall_s, "compute_s": 0.6 * wall_s, "h2d_s": 0.01,
                          "host_blocked_s": host_blocked_s, "other_s": 0.05,
                          "steps": steps, "compute_frac": 0.6},
        "steps": steps, "items": items, "step_seconds": 0.6 * wall_s / steps,
        "mfu": 0.000123, "flops_per_step": 1.2e9, "hbm_bytes_per_step": 4.5e7,
    }


RECORDS = [
    ("checkpoint", {"root": "/r/ck", "step": 10, "config_hash": "abc",
                    "data_cursor": {"step": 10, "items": 163840}}),
    ("chaos", {"fault": "nan_grad", "step": 5, "seed": 0, "leaf": "in_table/table",
               "row": 17}),
    ("chaos", {"fault": "ckpt_corrupt", "step": 12, "seed": 0, "path": "/r/ck/x.bin"}),
    ("cache_error", {"source": "checkpoint", "path": "/r/ck/step_12",
                     "error": "CheckpointError: crc mismatch",
                     "action": "walking back to an older checkpoint"}),
    ("retry_exhausted", {"op": "data_stream", "attempts": 4, "elapsed_ms": 81.25,
                         "reason": "attempts", "error": "OSError: flaky"}),
    ("outage", {"probe": "preemption", "reason": "SIGTERM", "step": 18,
                "error": "run preempted; drained with a final checkpoint"}),
    ("blackbox", {"reason": "sigterm", "dump_path": "/r/bb/blackbox-x.json",
                  "first_step": 3, "last_step": 18, "exception": None}),
    ("drift", {"step": 21, "signals": ["step_ms"], "model": "word2vec",
               "detectors": [{"signal": "step_ms", "peak": 7.5}]}),
    ("run", {"model": "word2vec", "config_hash": "abc", "steps": 30, "items": 30_000,
             "goodput": _goodput(1.2, 0.05), "final_metrics": {"loss": 4.1},
             "guardrail": {"trips_total": 3, "steps_skipped": 3},
             "chaos": {"seed": 0, "injected": 4}, "preempted": True,
             "timeseries": {"window": 5, "first_step": 4, "last_step": 20,
                            "series": {"step_ms": [4.0, 4.2, 9.0, 4.1, 4.0],
                                       "loss": [4.2, 4.1, 4.0, 3.9, 3.8]}},
             "drift": {"drifted": True, "events": 1, "tripped": ["step_ms"]}}),
    ("run", {"model": "word2vec", "config_hash": "abc", "steps": 30, "items": 30_000,
             "goodput": _goodput(2.4, 1.2), "final_metrics": None}),
    ("bench", {"payload": {"chaos": {"recovered_all": True, "guard_overhead_pct": 2.5,
                                     "loss_parity": 0.01, "drills": {}}}}),
    # kinds of planes the port does not have yet render the same too
    ("breaker", {"kernel": "pull", "from": "closed", "to": "open", "trips": 1}),
    ("transport", {"event": "conn_lost", "replica": "r1", "peer": "p", "error": "eof"}),
]


def _write(mod, path):
    led = mod.Ledger(str(path))
    for kind, rec in RECORDS:
        led.append(kind, dict(rec), env={"git_sha": "0" * 40} if kind == "run" else None)
    return path


@pytest.fixture(params=["port", "jax"])
def written(request, tmp_path):
    """The same records appended by one package or the other."""
    mod = ledger if request.param == "port" else jax_ledger
    return _write(mod, tmp_path / f"{request.param}.jsonl")


def test_records_keep_the_jax_schema(written):
    port = ledger.Ledger(str(written)).records()
    ref = jax_ledger.Ledger(str(written)).records()
    assert port == ref and len(port) == len(RECORDS)
    for rec, (kind, body) in zip(port, RECORDS):
        assert rec["schema"] == ledger.SCHEMA_VERSION == jax_ledger.SCHEMA_VERSION
        assert rec["kind"] == kind and set(body) <= set(rec)
    assert ledger.Ledger(str(written)).latest("run") == jax_ledger.Ledger(str(written)).latest("run")
    assert (ledger.outage_summary(ledger.Ledger(str(written)))
            == jax_ledger.outage_summary(jax_ledger.Ledger(str(written))))


def test_report_and_failures_render_the_same(written):
    port, ref = ledger.Ledger(str(written)), jax_ledger.Ledger(str(written))
    assert ledger.render_report(port) == jax_ledger.render_report(ref)
    assert ledger.render_failures(port) == jax_ledger.render_failures(ref)
    text = ledger.render_failures(port)
    for needle in ("CHAOS    fault=nan_grad", "CKPT/CACHE-ERROR", "RETRY-EXHAUSTED",
                   "OUTAGE", "BLACKBOX", "DRIFT", "[preempted]", "guard: 3 trips"):
        assert needle in text
    assert "profile: 5 samples" in ledger.render_report(port)


def test_diff_renders_the_same(written):
    port, ref = ledger.Ledger(str(written)), jax_ledger.Ledger(str(written))
    for spec_a, spec_b in (("-2", "-1"), ("0", "1"), ("-1", "-2")):
        a, la = ledger._resolve_diff_record(port, spec_a)
        b, lb = ledger._resolve_diff_record(port, spec_b)
        ja, jla = jax_ledger._resolve_diff_record(ref, spec_a)
        jb, jlb = jax_ledger._resolve_diff_record(ref, spec_b)
        assert (a, la, b, lb) == (ja, jla, jb, jlb)
        assert ledger.render_diff(a, b, la, lb) == jax_ledger.render_diff(ja, jb, jla, jlb)
    a, _ = ledger._resolve_diff_record(port, "-2")
    b, _ = ledger._resolve_diff_record(port, "-1")
    assert "dominant contributor: host_blocked" in ledger.render_diff(a, b)
    for bad in ("9", "no-such-file.json"):
        with pytest.raises(ValueError) as e1:
            ledger._resolve_diff_record(port, bad)
        with pytest.raises(ValueError) as e2:
            jax_ledger._resolve_diff_record(ref, bad)
        assert str(e1.value) == str(e2.value)


def _bench(value=None, platform="tpu", **blocks):
    payload = {"metric": "word2vec_words_per_sec_per_chip", "unit": "words/sec/chip",
               "platform": platform, "config": {}, **blocks}
    if value is not None:
        payload["value"] = value
    return ("bench", {"payload": payload})


_DRIFT_OK = {"detected": True, "detect_step": 17, "inject_step": 16, "drift_events": 1,
             "bundle_complete": True, "attribution": {"dominant": "host_blocked"}}
_TRACE = {"overhead_qps_pct": 1.0, "overhead_p99_pct": 0.5, "p99_off_ms": 10.0,
          "p99_on_ms": 10.4, "sample_rate": 0.1, "overhead_ceil_pct": 3.0}

GATE_CASES = {
    "empty": [],
    "cpu_only": [_bench(1000.0, platform="cpu")],
    "single": [_bench(1000.0)],
    "ok": [_bench(1000.0), _bench(990.0)],
    "regression": [_bench(1000.0), _bench(800.0)],
    "cached_ignored": [_bench(1000.0), _bench(10.0, cached=True)],
    "chaos_bad": [_bench(1000.0), _bench(1000.0, chaos={
        "recovered_all": False, "loss_parity": 0.2,
        "drills": {"nan_burst": {"recovered": False}}})],
    "chaos_only": [_bench(chaos={"recovered_all": True, "loss_parity": 0.0,
                                 "guard_overhead_pct": 1.0})],
    "drift_ok": [_bench(1000.0), _bench(1000.0, drift=_DRIFT_OK)],
    "drift_bad": [_bench(1000.0), _bench(1000.0, drift={
        **_DRIFT_OK, "detected": False, "drift_events": 3, "bundle_complete": False,
        "attribution": {"dominant": "h2d"}})],
    "profile_ok": [_bench(1000.0), _bench(1000.0, profile_overhead={
        "overhead_pct": 1.2, "noise_pct": 0.5, "overhead_ceil_pct": 3.0, "cadence": 4})],
    "profile_bad": [_bench(1000.0), _bench(1000.0, profile_overhead={
        "overhead_pct": 6.0, "noise_pct": 0.5, "overhead_ceil_pct": 3.0, "cadence": 4})],
    "profile_noise": [_bench(1000.0), _bench(1000.0, profile_overhead={
        "overhead_pct": 6.0, "noise_pct": 10.0, "overhead_ceil_pct": 3.0})],
    "profile_unmeasured": [_bench(profile_overhead={"overhead_ceil_pct": 3.0})],
    "trace_ok": [_bench(1000.0), _bench(1000.0, fleet={"trace_overhead": _TRACE})],
    "trace_bad": [_bench(1000.0), _bench(1000.0, fleet={"trace_overhead": {
        **_TRACE, "overhead_qps_pct": 9.0, "p99_on_ms": 30.0}})],
    "int4_ok": [_bench(1000.0), _bench(1000.0, scaling={"per_dtype": {"int4": {
        "payload_reduction_vs_f32": 6.0, "loss_parity_vs_f32": 0.0}}})],
    "int4_bad": [_bench(1000.0), _bench(1000.0, scaling={"per_dtype": {"int4": {
        "payload_reduction_vs_f32": 5.9, "loss_parity_vs_f32": 0.02}}})],
    "everything": [_bench(1000.0), _bench(700.0, drift=_DRIFT_OK, chaos={
        "recovered_all": True, "loss_parity": 0.0}, profile_overhead={
        "overhead_pct": 0.1, "noise_pct": 1.0})],
}


@pytest.mark.parametrize("case", sorted(GATE_CASES))
@pytest.mark.parametrize("baseline", [None, 1200.0])
def test_check_regression_matches(tmp_path, case, baseline):
    path = str(tmp_path / "gate.jsonl")
    led = ledger.Ledger(path)
    for kind, rec in GATE_CASES[case]:
        led.append(kind, rec)
    got = ledger.check_regression(led, 10.0, baseline)
    want = jax_ledger.check_regression(jax_ledger.Ledger(path), 10.0, baseline)
    assert got == want


@pytest.mark.parametrize("records,rc,said", [
    ([], 0, None),
    ([_bench(1000.0, scaling={"per_dtype": {"int8": {"payload_reduction_vs_f32": 3.5}}})],
     0, None),
    ([_bench(scaling={"per_dtype": {"int4": {"payload_reduction_vs_f32": 5.9,
                                             "loss_parity_vs_f32": 0.0}}})],
     1, "int4-wire REGRESSION: audited exchange-byte reduction 5.9 vs f32 is below"),
    ([_bench(scaling={"per_dtype": {"int4": {"payload_reduction_vs_f32": 6.0,
                                             "loss_parity_vs_f32": 0.004}}})],
     0, "int4-wire ok: exchange bytes 6.00x below f32"),
    ([_bench(scaling={"per_dtype": {"int4": {"payload_reduction_vs_f32": 7.1,
                                             "loss_parity_vs_f32": 0.011}}})],
     1, "int4-wire REGRESSION: loss parity 0.011 vs f32 exceeds the 0.01 bar"),
], ids=["empty", "no_int4", "5.9x", "6.0x", "parity"])
def test_quantized_wire_gate(tmp_path, records, rc, said):
    """The int4 wire's gate on hand-written bench records: no int4 history
    gates nothing, 5.9x fails, 6.0x passes, a loss parity past 1% fails;
    the JAX gate's code and message on each."""
    path = str(tmp_path / "int4.jsonl")
    led = ledger.Ledger(path)
    for kind, rec in records:
        led.append(kind, rec)
    got = ledger._check_quantized_wire_regression(led)
    assert got == jax_ledger._check_quantized_wire_regression(jax_ledger.Ledger(path))
    assert got[0] == rc
    assert (got[1] is None) if said is None else got[1].startswith(said)
    assert ledger._check_quantized_wire_regression in ledger._plane_checks(10.0)


def _scaled(value, aggregate):
    return _bench(value, scaling={"aggregate_words_per_sec": aggregate})


SCALING_CASES = {
    "none": [_bench(1000.0), _bench(1000.0)],
    "one": [_bench(1000.0), _scaled(1000.0, 4000.0)],
    "drop": [_scaled(1000.0, 4000.0), _scaled(1000.0, 3000.0)],
    "hold": [_scaled(1000.0, 4000.0), _scaled(1000.0, 3900.0)],
    "newest_without": [_scaled(1000.0, 4000.0), _bench(1000.0)],
}


@pytest.mark.parametrize("case", sorted(SCALING_CASES))
@pytest.mark.parametrize("baseline", [None, 1200.0])
def test_scaling_gate_matches(tmp_path, case, baseline):
    """The scale-out lane's gate (JAX ``_check_scaling_regression``) on the
    same synthetic records in both packages: no scaling block, one, a drop
    past the allowance, a hold, a newest record without one; the same code
    and message from ``check_regression`` and from the gate alone."""
    path = str(tmp_path / "scaling.jsonl")
    led = ledger.Ledger(path)
    for kind, rec in SCALING_CASES[case]:
        led.append(kind, rec)
    ref = jax_ledger.Ledger(path)
    assert ledger.check_regression(led, 10.0, baseline) == jax_ledger.check_regression(
        ref, 10.0, baseline)
    measured = [r for r in led.records("bench")]
    got = ledger._check_scaling_regression(measured, 10.0)
    assert got == jax_ledger._check_scaling_regression(ref.records("bench"), 10.0)
    said = {"none": None, "one": "scaling: single measured record",
            "drop": "scaling REGRESSION", "hold": "scaling ok",
            "newest_without": "scaling: newest measured record has no scaling block"}[case]
    assert got[0] == (1 if case == "drop" else 0)
    assert (got[1] is None) if said is None else got[1].startswith(said)


@pytest.mark.parametrize("argv", [
    [], ["--failures"], ["--diff", "-2", "-1"], ["--diff", "0", "7"],
    ["--check-regression", "5"], ["--check-regression", "5", "--baseline", "2000"]])
def test_main_matches(written, argv, capsys):
    rc = ledger.main([str(written), *argv])
    out = capsys.readouterr().out
    want_rc = jax_ledger.main([str(written), *argv])
    assert (rc, out) == (want_rc, capsys.readouterr().out)


def test_torn_tail_heals(tmp_path):
    path = tmp_path / "torn.jsonl"
    path.write_text(json.dumps({"schema": 1, "kind": "run", "model": "a"}) + "\n"
                    + '{"schema": 1, "kind": "ru')  # a writer died mid-line
    led = ledger.Ledger(str(path))
    full = led.append("outage", {"error": "after the tear"})
    assert full["kind"] == "outage" and full["schema"] == 1
    records, bad = led.replay()
    assert [r["kind"] for r in records] == ["run", "outage"]
    assert len(bad) == 1 and ":2: unparseable" in bad[0]
    assert path.read_bytes().endswith(b"\n")
    # the JAX package reads the healed file the same way
    assert jax_ledger.Ledger(str(path)).replay() == (records, bad)
    assert "WARNING" in ledger.render_report(led)
    missing = ledger.Ledger(str(tmp_path / "none.jsonl"))
    assert missing.records() == [] and missing.latest("run") is None
    assert ledger.render_report(missing) == jax_ledger.render_report(
        jax_ledger.Ledger(str(tmp_path / "none.jsonl")))


def test_append_is_atomic_under_threads(tmp_path):
    """The checkpoint writer thread appends beside the training thread: no
    record is lost to a concurrent rewrite."""
    import threading

    led = ledger.Ledger(str(tmp_path / "t.jsonl"))
    sw = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=lambda i=i: [
            led.append("checkpoint", {"step": i * 100 + j}) for j in range(10)])
            for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(sw)
    steps = sorted(r["step"] for r in led.records("checkpoint"))
    assert steps == sorted(i * 100 + j for i in range(6) for j in range(10))


def test_env_fingerprint_names_the_device():
    fp = ledger.env_fingerprint(include_devices=True)
    assert set(fp) >= {"git_sha", "python", "host", "torch", "cuda", "devices"}
    dev = fp["devices"]
    assert dev["platform"] in ("gpu", "cpu") and dev["count"] >= 1
    if dev["platform"] == "gpu":
        assert dev["kind"] and "power_limit" in dev
    else:
        assert dev == {"platform": "cpu", "count": 1, "kind": "cpu", "process_count": 1}
    assert "devices" not in ledger.env_fingerprint()
    assert ledger.config_hash({"a": 1, "b": "x"}) == jax_ledger.config_hash({"b": "x", "a": 1})


# ------------------------------------------------ the bench cache helpers ---

_GOOD = {"metric": "word2vec_words_per_sec_per_chip", "value": 1234.5,
         "unit": "words/sec/chip", "config": {"dim": 200}}

PAYLOADS = {
    "good": _GOOD,
    "int_value": {**_GOOD, "value": 7},
    "not_a_dict": [1, 2],
    "none": None,
    **{f"missing_{k}": {key: v for key, v in _GOOD.items() if key != k} for k in _GOOD},
    "metric_int": {**_GOOD, "metric": 3},
    "value_str": {**_GOOD, "value": "1234.5"},
    "unit_none": {**_GOOD, "unit": None},
    "config_list": {**_GOOD, "config": []},
    "value_bool": {**_GOOD, "value": True},  # isinstance(True, int): passes the type check
    "value_false": {**_GOOD, "value": False},
    "value_zero": {**_GOOD, "value": 0},
    "value_negative": {**_GOOD, "value": -1},
    "everything_wrong": {"value": -2.0, "unit": 5},
}


@pytest.mark.parametrize("case", sorted(PAYLOADS))
def test_validate_bench_payload_matches(case):
    got = ledger.validate_bench_payload(PAYLOADS[case])
    assert got == jax_ledger.validate_bench_payload(PAYLOADS[case])
    assert bool(got) == (case not in ("good", "int_value", "value_bool"))


def _cache_file(tmp_path, case):
    path = tmp_path / f"{case}.json"
    if case == "good":
        path.write_text(json.dumps(_GOOD))
    elif case == "truncated":
        path.write_text(json.dumps(_GOOD)[:25])
    elif case == "schema":
        path.write_text(json.dumps({**_GOOD, "value": 0, "unit": 1}))
    elif case == "not_an_object":
        path.write_text("[1, 2, 3]")
    elif case == "directory":
        path.mkdir()
    return str(path)


@pytest.mark.parametrize("case", ["good", "missing", "truncated", "schema", "not_an_object",
                                  "directory"])
def test_load_bench_cache_matches(tmp_path, case):
    path = _cache_file(tmp_path, case)
    got = ledger.load_bench_cache(path)
    want = jax_ledger.load_bench_cache(path)
    assert got == want
    payload, reason = got
    assert (payload == _GOOD) if case == "good" else (payload is None and reason)
    if case in ("missing", "directory"):
        assert reason.startswith("cache unreadable: ") and path in reason
    if case == "truncated":
        assert reason.startswith("cache unparseable (partial write?): ")


def _bench_ledger(mod, path, records):
    led = mod.Ledger(str(path))
    for rec in records:
        led.append("bench", rec)
    return led


LAST_GOOD_CASES = {
    # cacheable, uncacheable and invalid records: the newest valid cacheable wins
    "mixed": [{"payload": {**_GOOD, "value": 100.0}, "cacheable": True},
              {"payload": {**_GOOD, "value": 200.0, "measured_at": "then"},
               "cacheable": True},
              {"payload": {**_GOOD, "value": 300.0}, "cacheable": False},
              {"payload": {**_GOOD, "value": 400.0}},
              {"payload": {**_GOOD, "value": 0}, "cacheable": True},
              {"payload": {"metric": "m", "value": 500.0}, "cacheable": True},
              {"payload": "not a dict", "cacheable": True}],
    "measured_at_from_ts": [{"payload": dict(_GOOD), "cacheable": True},
                            {"payload": {**_GOOD, "unit": 3}, "cacheable": True}],
    "none_cacheable": [{"payload": dict(_GOOD)},
                       {"payload": {**_GOOD, "value": -1}, "cacheable": True}],
    "empty": [],
}


@pytest.mark.parametrize("case", sorted(LAST_GOOD_CASES))
def test_derive_last_good_matches(tmp_path, case):
    """One ledger, written once, derived by each package into its own file:
    the same chosen payload and the same file bytes."""
    path = tmp_path / "bench.jsonl"
    _bench_ledger(ledger, path, LAST_GOOD_CASES[case])
    out, jax_out = tmp_path / "port.json", tmp_path / "jax.json"
    got = ledger.derive_last_good(ledger.Ledger(str(path)), str(out))
    want = jax_ledger.derive_last_good(jax_ledger.Ledger(str(path)), str(jax_out))
    assert got == want
    payload, reason = got
    if case in ("none_cacheable", "empty"):
        assert payload is None and reason == "no cacheable bench record in ledger"
        assert not out.exists() and not jax_out.exists()
        return
    assert reason is None and out.read_bytes() == jax_out.read_bytes()
    assert json.loads(out.read_text()) == payload
    assert ledger.load_bench_cache(str(out)) == (payload, None)
    if case == "mixed":
        assert payload["value"] == 200.0 and payload["measured_at"] == "then"
    else:
        ts = ledger.Ledger(str(path)).records("bench")[0]["ts"]
        assert payload["measured_at"] == ts


@pytest.mark.parametrize("cache", ["good", "missing", "truncated", "schema", "low"])
@pytest.mark.parametrize("explicit", [False, True])
def test_main_baseline_file_matches(tmp_path, capsys, cache, explicit):
    """``ledger-report --check-regression 5 --baseline-file F``: the pinned
    baseline read from a good file gates the newest measured value (a low
    pin passes it, the good one fails it), a bad file returns 2 with the
    reason, and ``--baseline`` wins over the file; the JAX ``main``'s code
    and output on each."""
    path = tmp_path / "gate.jsonl"
    _bench_ledger(ledger, path, [_bench(1000.0)[1], _bench(1100.0)[1]])
    if cache == "low":
        f = tmp_path / "low.json"
        f.write_text(json.dumps({**_GOOD, "value": 1000}))
        f = str(f)
    else:
        f = _cache_file(tmp_path, cache)
    argv = [str(path), "--check-regression", "5", "--baseline-file", f]
    if explicit:
        argv += ["--baseline", "1050"]
    rc = ledger.main(argv)
    out = capsys.readouterr().out
    want_rc = jax_ledger.main(argv)
    assert (rc, out) == (want_rc, capsys.readouterr().out)
    if explicit:
        assert rc == 0
    elif cache in ("missing", "truncated", "schema"):
        assert rc == 2 and out.startswith("ledger_report: --baseline-file: cache ")
    else:
        assert rc == (1 if cache == "good" else 0)
