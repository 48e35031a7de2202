"""The port's request tracer against the JAX package's, on the CPU: one seed
mints the same trace ids and makes the same head-sampling calls; the tail
keep, the wire resume, the span bound and the exports behave alike; the
port's servant and fleet hang the same spans off a request (``device="cpu"``).
"""

import itertools
import json

import numpy as np
import pytest

from swiftsnails_tpu.telemetry import request_trace as jrt
from swiftsnails_tpu.utils.config import Config as JConfig

from swiftsnails_tpu_torch.serving import Fleet, Overloaded, Servant
from swiftsnails_tpu_torch.serving.router import route_hash
from swiftsnails_tpu_torch.telemetry import request_trace as rt
from swiftsnails_tpu_torch.telemetry.ledger import Ledger
from swiftsnails_tpu_torch.utils.config import Config

DIM = 8
CAP = 64


@pytest.mark.parametrize("seed", [0, 7, 12345])
@pytest.mark.parametrize("rate", [0.0, 0.1, 0.5, 1.0])
def test_trace_ids_and_head_sampling_equal_jax(seed, rate):
    ours, theirs = rt.RequestTracer(rate, seed=seed), jrt.RequestTracer(rate, seed=seed)
    ids = [ours._mint_id() for _ in range(300)]
    assert ids == [theirs._mint_id() for _ in range(300)]
    assert [ours.head_sampled(i) for i in ids] == [theirs.head_sampled(i) for i in ids]


def test_start_finish_keep_and_stats_equal_jax():
    """The same request sequence through both tracers: the same contexts
    kept, the same anomaly marks, the same counters."""
    out = []
    for mod in (rt, jrt):
        tr = mod.RequestTracer(0.2, seed=3, slo_ms={"pull": 5.0})
        clock = itertools.count(0, 1_000_000)  # 1 ms a reading
        tr._clock_ns = lambda: next(clock)
        kept = []
        for n in range(40):
            ctx = tr.start("pull" if n % 2 else "topk", n=n)
            with ctx.span("kernel", n=n):
                pass
            if n % 7 == 0:
                ctx.mark_anomaly("hedge")
            tr.finish(ctx, error=Overloaded("x") if n % 11 == 0 else None)
        for ctx in tr.traces():
            d = ctx.to_dict()
            kept.append((d["trace_id"], d["kernel"], d["sampled"],
                         sorted(d["anomalies"]), [s["name"] for s in d["spans"]]))
        out.append((kept, tr.stats()))
    assert out[0] == out[1]
    assert out[0][1]["kept"] > 0 and out[0][1]["anomalies"] > 0


def test_wire_resume_agrees_with_jax():
    ours, theirs = rt.RequestTracer(0.5, seed=9), jrt.RequestTracer(0.5, seed=9)
    a, b = ours.start("pull"), theirs.start("pull")
    assert a.wire() == b.wire()
    ra, rb = ours.resume(a.wire(), "apply"), theirs.resume(b.wire(), "apply")
    assert (ra.trace_id, ra.sampled) == (rb.trace_id, rb.sampled)


def test_from_config_equal_jax():
    for keys in ({}, {"trace_sample_rate": "0.3"}, {"trace_anomaly_keep": "1"},
                 {"trace_sample_rate": "0.3", "slo_latency_ms": "12", "seed": "4"}):
        ours = rt.RequestTracer.from_config(Config(dict(keys)))
        theirs = jrt.RequestTracer.from_config(JConfig(dict(keys)))
        assert (ours is None) == (theirs is None)
        if ours is not None:
            assert (ours.sample_rate, ours.anomaly_keep, ours.slo_ms, ours.seed) == \
                (theirs.sample_rate, theirs.anomaly_keep, theirs.slo_ms, theirs.seed)


def test_span_capture_is_bounded_and_exports_round_trip(tmp_path):
    tr = rt.RequestTracer(1.0, seed=1, max_spans=4)
    ctx = tr.start("pull")
    for i in range(10):
        ctx.add_span(f"s{i}", i * 1000, 500)
    tr.finish(ctx)
    assert len(ctx.to_dict()["spans"]) <= 4
    assert tr.export_jsonl(str(tmp_path / "t.jsonl")) == 1
    line = json.loads((tmp_path / "t.jsonl").read_text().splitlines()[0])
    assert line["trace_id"] == ctx.trace_id
    chrome = tr.chrome_trace()
    assert all(ev["ph"] == "X" for ev in chrome["traceEvents"] if ev.get("ph") != "M")


def _table(seed=0):
    return np.random.default_rng(seed).standard_normal((CAP, DIM)).astype(np.float32)


def test_servant_request_spans(tmp_path):
    tr = rt.RequestTracer(1.0, seed=2)
    with Servant({"t": _table()}, batch_buckets=(4, 8), request_tracer=tr,
                 device="cpu") as sv:
        sv.pull([1, 2, 3])
        sv.topk(_table()[0], k=3)
    traces = tr.traces()
    assert [t.kernel for t in traces] == ["pull", "topk"]
    for t in traces:
        names = [s["name"] for s in t.to_dict()["spans"]]
        assert "queue-wait" in names and "kernel" in names
        assert rt.tree_complete(t.to_dict(), ("request", "queue-wait", "kernel"))
    kernel = next(s for s in traces[0].to_dict()["spans"] if s["name"] == "kernel")
    assert kernel["args"]["buckets"] == [4] and kernel["args"]["pad_rows"] == 1


def test_fleet_reroute_yields_a_complete_anomaly_trace():
    table = _table()
    tr = rt.RequestTracer(0.0, seed=5, anomaly_keep=True)

    def factory(rid):
        return Servant({"t": table}, batch_buckets=(8,), cache_rows=64, device="cpu")

    with Fleet(factory, replicas=2, hedge_budget_pct=0.0, request_tracer=tr) as fleet:
        key = next(k for k in range(CAP)
                   if fleet._ring.successors(route_hash(k))[0] == "r0")
        reps = {r.id: r for r in fleet.replicas()}

        def sick(kernel):
            raise Overloaded("synthetic")

        reps["r0"].request_hook = sick
        np.testing.assert_array_equal(fleet.pull([key], key=key), table[[key]])
        reps["r0"].request_hook = None
        fleet.pull([key], key=key)  # a plain request: sampled away at rate 0
    traces = tr.anomaly_traces()
    assert len(traces) == 1
    d = traces[0].to_dict()
    assert "reroute" in d["anomalies"] and d["annotations"]["rerouted"] is True
    assert rt.tree_complete(d, ("request", "attempt", "reroute"))
    assert d["annotations"]["route_owner"] == "r0" and d["annotations"]["winner"] == "r1"


def test_trace_anomaly_ledger_events(tmp_path):
    led = Ledger(str(tmp_path / "l.jsonl"))
    tr = rt.RequestTracer(0.0, seed=1, anomaly_keep=True, ledger=led)
    for _ in range(3):
        ctx = tr.start("pull")
        ctx.mark_anomaly("shed")
        tr.finish(ctx)
    assert led.latest("trace_anomaly") is not None
