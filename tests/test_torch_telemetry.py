"""The port's telemetry modules against the JAX package's, on the same
inputs: the tracer's events and Chrome trace, the metric registry, the
goodput arithmetic (``peaks_for``, ``step_time_decomposition``,
``goodput_report``, ``throughput_attribution``), the time-series store and
the ``trace-summary`` reader; the H100 rows of the peak table; the
``torch.profiler`` step window; and ``step_cost``'s counts held to a count
made by hand from the batch's shapes (packed+pool and Wide & Deep)."""

import io
import json
import os

import numpy as np
import pytest
import torch

from swiftsnails_tpu.telemetry import goodput as jax_goodput
from swiftsnails_tpu.telemetry import registry as jax_registry
from swiftsnails_tpu.telemetry import summary as jax_summary
from swiftsnails_tpu.telemetry import timeseries as jax_timeseries
from swiftsnails_tpu.telemetry import tracer as jax_tracer
from swiftsnails_tpu.utils.config import Config as JaxConfig

from swiftsnails_tpu_torch.data.vocab import Vocab
from swiftsnails_tpu_torch.models.registry import get_model
from swiftsnails_tpu_torch.models.word2vec import Word2VecTrainer
from swiftsnails_tpu_torch.telemetry import goodput, registry, summary, timeseries, tracer
from swiftsnails_tpu_torch.utils.config import Config
from swiftsnails_tpu_torch.utils.profiling import StepProfiler, step_annotation

SPAN_NAMES = ("prefetch-wait", "h2d", "step", "metrics-flush", "checkpoint",
              "chaos-slow", "tier-fault", "word2vec", "other")


def _raw_events(seed, n=60):
    """Span tuples ``(name, t0_ns, dur_ns, tid, depth, args)`` from a seed."""
    rng = np.random.default_rng(seed)
    t, out = 1_000_000, []
    for i in range(n):
        name = SPAN_NAMES[int(rng.integers(len(SPAN_NAMES)))]
        dur = int(rng.integers(1_000, 5_000_000))
        args = {"step": i} if name in ("step", "word2vec") else None
        out.append((name, t, dur, 7 + int(rng.integers(2)), int(rng.integers(3)), args))
        t += dur + int(rng.integers(0, 200_000))
    return out


def _tracers(seed):
    """A tracer of each package holding the same spans and counters."""
    pair = (tracer.Tracer(process_name="p"), jax_tracer.Tracer(process_name="p"))
    for tr in pair:
        tr._epoch_ns = 500_000
        for ev in _raw_events(seed):
            tr._record(ev)
        tr._counters.append(("prefetch_queue_depth", 2_000_000, 2.0, 7))
    return pair


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tracer_events_and_chrome_trace_match(seed):
    port, ref = _tracers(seed)
    assert port.events() == ref.events()
    assert port.events(17) == ref.events(17)
    assert port.chrome_trace() == ref.chrome_trace()


def test_tracer_nesting_matches(tmp_path):
    """Real spans, nested and on two threads: names, depths and args agree."""
    import threading

    def drive(tr):
        with tr.span("outer", k=1):
            with tr.span("inner"):
                pass
            th = threading.Thread(target=lambda: tr.span("thread").__enter__().__exit__())
            th.start()
            th.join()
        with tr.step_span("toy", 3):
            with tr.span("step", step=3):
                pass
        tr.counter("q", 4)
        return [(e["name"], e["depth"], e["args"]) for e in tr.events()]

    assert drive(tracer.Tracer()) == drive(jax_tracer.Tracer())
    path = tmp_path / "t.json"
    tr = tracer.Tracer(path=str(path))
    drive(tr)
    tr.close()
    doc = json.loads(path.read_text())
    assert {e["name"] for e in doc["traceEvents"] if e["ph"] == "X"} >= {
        "outer", "inner", "toy", "step"}


def test_step_span_opens_a_record_function_range():
    """A step span is a ``record_function`` range the profiler sees, named
    ``<name>#<step>`` (on the card also an NVTX range)."""
    from torch.profiler import ProfilerActivity, profile

    tr = tracer.Tracer()
    assert not tr.nvtx
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tr.step_span("toy", 5):
            torch.ones(4).sum()
    names = {e.key for e in prof.key_averages()}
    assert "toy#5" in names
    assert [e["name"] for e in tr.events()] == ["toy"]


def test_registry_matches():
    def drive(mod):
        reg = mod.MetricRegistry()
        rng = np.random.default_rng(3)
        for i in range(700):  # past the histogram's 512-sample window
            reg.counter("steps").inc()
            reg.counter("items").inc(int(rng.integers(1, 9)))
            reg.histogram("step_ms").observe(float(rng.gamma(2.0, 3.0)),
                                             trace_id=f"t{i}" if i % 97 == 0 else None)
        reg.gauge("prefetch_queue_depth").set(3)
        buf = io.StringIO()
        reg.add_sink(mod.StdoutSummarySink(stream=buf))
        rec = reg.flush(step=700, final=1)
        return reg.snapshot(), rec, buf.getvalue(), reg.histogram("step_ms").exemplar()

    assert drive(registry) == drive(jax_registry)


def test_peaks_table():
    h100 = goodput.peaks_for("NVIDIA H100 80GB HBM3")
    assert h100 == {"flops_per_s": 989e12, "hbm_bytes_per_s": 3350e9,
                    "ici_bytes_per_s": 450e9, "source": "builtin table (h100)"}
    pcie = goodput.peaks_for("NVIDIA H100 PCIe")
    assert pcie == {"flops_per_s": 756e12, "hbm_bytes_per_s": 2000e9,
                    "ici_bytes_per_s": 300e9, "source": "builtin table (h100 pcie)"}
    for kind in ("cpu", None, ""):
        assert goodput.peaks_for(kind)["flops_per_s"] is None
        assert goodput.peaks_for(kind) == jax_goodput.peaks_for(kind)
    # the TPU rows read the same in both packages
    for kind in ("TPU v5 lite", "TPU v5p", "TPU v4", "TPU v6e", "TPU v3", "TPU v2"):
        assert goodput.peaks_for(kind) == jax_goodput.peaks_for(kind)
    cfg = {"peak_flops": "1e15", "peak_hbm_gbps": "100", "peak_ici_gbps": "7"}
    assert (goodput.peaks_from_config(Config(cfg), "NVIDIA H100 PCIe")
            == jax_goodput.peaks_from_config(JaxConfig(cfg), "NVIDIA H100 PCIe"))


def _audit(seed):
    rng = np.random.default_rng(seed)
    return {"cost": {"flops": float(rng.integers(1e9, 1e12)),
                     "bytes_accessed": float(rng.integers(1e6, 1e10))},
            "total_bytes": None, "source": "analytic"}


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("kind", ["NVIDIA H100 80GB HBM3", "NVIDIA H100 PCIe", "cpu"])
def test_goodput_report_matches(seed, kind):
    events, _ = _tracers(seed)
    events = events.events()
    assert (goodput.step_time_decomposition(events)
            == jax_goodput.step_time_decomposition(events))
    kw = dict(events=events, audit=_audit(seed), steps=None, items=123_456,
              n_chips=1)
    got = goodput.goodput_report(peaks=goodput.peaks_for(kind), **kw)
    want = jax_goodput.goodput_report(peaks=goodput.peaks_for(kind), **kw)
    assert got == want
    if kind != "cpu":
        assert 0 < got["mfu"] and got["vs_roofline"] > 0
    # an audit-less (uncounted) run carries None, never a guess
    bare = goodput.goodput_report(events=events, audit=None, items=10,
                                  peaks=goodput.peaks_for(kind))
    assert bare["mfu"] is None and "flops_per_step" not in bare


@pytest.mark.parametrize("seed", [0, 1])
def test_throughput_attribution_matches(seed):
    a_ev, _ = _tracers(seed)
    b_ev, _ = _tracers(seed + 10)
    rec_a = {"goodput": goodput.goodput_report(events=a_ev.events(), items=5000),
             "comm_by_scope": {"pull": {"bytes": 10.0}}}
    rec_b = {"goodput": goodput.goodput_report(events=b_ev.events(), items=5000),
             "comm_by_scope": {"pull": {"bytes": 30.0}, "push": 4.0}}
    for a, b in ((rec_a, rec_b), (rec_b, rec_a), ({}, rec_a), ({}, {})):
        assert goodput.throughput_attribution(a, b) == jax_goodput.throughput_attribution(a, b)
        assert goodput._record_rate(a) == jax_goodput._record_rate(a)
        assert goodput._per_step_components(b) == jax_goodput._per_step_components(b)


def test_timeseries_matches(tmp_path):
    rng = np.random.default_rng(4)
    stores = (timeseries.TimeSeriesStore(window=50), jax_timeseries.TimeSeriesStore(window=50))
    for step in range(80):
        row = {"step_ms": float(rng.gamma(2, 2)), "loss": float(rng.random()),
               "flag": True, "trace": "x"}
        if step % 3:
            row["prefetch_stall_ms"] = float(rng.random())
        if step == 40:
            row["loss"] = float("nan")
        for st in stores:
            st.sample(step, row, ts=1000.0 + step)
    port, ref = stores
    assert port.snapshot() == ref.snapshot() or _nan_equal(port.snapshot(), ref.snapshot())
    assert port.names() == ref.names() and port.latest() == ref.latest()
    assert port.series("prefetch_stall_ms") == ref.series("prefetch_stall_ms")
    assert json.dumps(port.summary(max_points=12)) == json.dumps(ref.summary(max_points=12))
    assert (timeseries.render_sparklines(port.summary())
            == jax_timeseries.render_sparklines(ref.summary()))
    vals = [float(v) for v in rng.normal(size=70)] + [float("inf")]
    assert timeseries.sparkline(vals, 20) == jax_timeseries.sparkline(vals, 20)
    assert port.export_jsonl(str(tmp_path / "a.jsonl")) == ref.export_jsonl(str(tmp_path / "b.jsonl"))
    assert (tmp_path / "a.jsonl").read_bytes() == (tmp_path / "b.jsonl").read_bytes()


def _nan_equal(a, b):
    return json.dumps(a) == json.dumps(b)


def test_trace_summary_matches(tmp_path, capsys):
    port, _ = _tracers(5)
    trace = tmp_path / "trace.json"
    port.export(str(trace))
    metrics = tmp_path / "m.jsonl"
    metrics.write_text("".join(json.dumps({"step": i, "loss": 1.0 / (i + 1), "ok": True,
                                           "ts": i}) + "\n" for i in range(9)) + "bad\n")
    for path in (trace, metrics):
        assert summary.summarize_file(str(path)) == jax_summary.summarize_file(str(path))
    assert "prefetch-wait" in summary.summarize_file(str(trace))
    empty = tmp_path / "empty.json"
    empty.write_text("neither a trace nor JSON lines\n")
    assert summary.main([str(empty)]) == jax_summary.main([str(empty)]) == 1
    assert summary.main([str(trace)]) == 0


def test_step_profiler_window(tmp_path):
    """The window opens at its start (or past it, on a resumed run), closes
    at its stop or in ``close``, once, and writes a Chrome trace holding the
    step's ``record_function`` ranges."""
    cfg = Config({"profile_dir": str(tmp_path / "p"), "profile_steps": "2,4"})
    prof = StepProfiler(cfg, torch.device("cpu"))
    assert prof.enabled and not prof.cuda
    for step in range(6):
        prof.on_step(step)
        with step_annotation("toy", step):
            torch.ones(8).sum()
    assert prof.trace_path and prof.trace_path.endswith("-steps2-4.json")
    names = {e.get("name") for e in json.load(open(prof.trace_path))["traceEvents"]}
    assert {"toy#2", "toy#3"} <= names and "toy#4" not in names
    prof.on_step(3)  # one-shot
    assert len(os.listdir(tmp_path / "p")) == 1
    late = StepProfiler(Config({"profile_dir": str(tmp_path / "q"),
                                "profile_steps": "2,100"}))
    late.on_step(7)  # a resumed run entering mid-window
    late.close(9)
    assert late.trace_path.endswith("-steps7-9.json")
    late.close()
    off = StepProfiler(Config({}))
    off.on_step(3)
    off.close()
    assert not off.enabled and off.trace_path is None
    for bad in ("10", "20,10", "a,b"):
        with pytest.raises(ValueError):
            StepProfiler(Config({"profile_dir": "x", "profile_steps": bad}))


# ------------------------------------------------------------ step_cost ----


def _w2v(**over):
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 300, 6000).astype(np.int32)
    vocab = Vocab([f"w{i}" for i in range(300)], np.maximum(np.bincount(ids, minlength=300), 1))
    conf = {"dim": "24", "window": "2", "negatives": "3", "batch_size": "256",
            "subsample": "0", "pool_size": "16", "pool_block": "64", "use_native": "0"}
    conf.update({k: str(v) for k, v in over.items()})
    return Word2VecTrainer(Config(conf), corpus_ids=ids, vocab=vocab, device="cpu")


def test_step_cost_packed_pool_by_hand():
    tr = _w2v(steps_per_call=2)
    batch = next(iter(tr.batches()))
    cost = tr.step_cost(batch)
    b, d, pn, k = 256, 24, 16, 3
    nb = b // 64
    want_bytes = want_flops = 0
    for i in range(2):
        cs = batch["centers"][i * b:(i + 1) * b]
        xs = batch["contexts"][i * b:(i + 1) * b]
        rows = len(set(cs.tolist())) + len(set(xs.tolist())) + nb * pn
        want_bytes += 2 * rows * d * 4
        want_flops += 6 * b * pn * d + 8 * b * d
    want_bytes += batch["centers"].nbytes + batch["contexts"].nbytes
    assert cost == {"cost": {"flops": want_flops, "bytes_accessed": want_bytes},
                    "total_bytes": None, "source": "analytic"}
    # per-pair negatives (the 2-D plane): K drawn a pair
    dense = _w2v(packed=0)
    batch = next(iter(dense.batches()))
    cs, xs = batch["centers"], batch["contexts"]
    rows = len(set(cs.tolist())) + len(set(xs.tolist())) + b * k
    assert dense.step_cost(batch)["cost"] == {
        "flops": 6 * b * k * d + 8 * b * d,
        "bytes_accessed": 2 * rows * d * 4 + cs.nbytes + xs.nbytes}


def test_step_cost_grouped_counts_real_pairs():
    tr = _w2v(fused=1, grouped=1, centers_per_block=32, batch_size=128)
    batch = next(iter(tr.batches()))
    cs, xs = batch["centers"], batch["contexts"]
    real = xs[xs >= 0]
    rows = len(set(cs.tolist())) + len(set(real.tolist())) + (128 // 32) * 16
    assert tr.step_cost(batch)["cost"] == {
        "flops": 6 * 128 * 16 * 24 + 8 * real.size * 24,
        "bytes_accessed": 2 * rows * 24 * 4 + cs.nbytes + xs.nbytes}


def test_step_cost_widedeep_by_hand():
    from swiftsnails_tpu_torch.data.ctr import synth_ctr
    from swiftsnails_tpu_torch.ops.hashing import hash_row_np

    f, k, hidden = 6, 4, (16, 8)
    labels, feats, _ = synth_ctr(512, f, vocab_per_field=50, seed=1)
    feats[::7, 2] = -1  # padding
    cfg = Config({"num_fields": str(f), "capacity": "4096", "embed_dim": str(k),
                  "hidden_dims": ",".join(map(str, hidden)), "batch_size": "128"})
    tr = get_model("widedeep")(cfg, data=(labels, feats), device="cpu")
    batch = next(iter(tr.batches()))
    fb = batch["feats"]
    distinct = len(set(hash_row_np(fb[fb >= 0], 4096).tolist()))
    dims = [f * k, *hidden, 1]
    macs = sum(a * c for a, c in zip(dims[:-1], dims[1:]))
    n_dense = 1 + sum(a * c + c for a, c in zip(dims[:-1], dims[1:]))
    state = tr.init_state()
    assert n_dense == sum(t.numel() for t in state.dense.values())
    values = distinct * (1 + k) + n_dense
    assert tr.step_cost(batch) == {
        "cost": {"flops": 3 * (128 * f + 2 * 128 * macs) + 5 * values,
                 "bytes_accessed": 2 * 4 * 2 * values + fb.nbytes + batch["labels"].nbytes},
        "total_bytes": None, "source": "analytic"}


@pytest.mark.parametrize("model,extra", [
    ("logreg", {"optimizer": "sgd"}), ("fm", {"factor_dim": 4}),
    ("ffm", {"factor_dim": 2}), ("widedeep", {"packed": 0})])
def test_step_cost_every_ctr_family(model, extra):
    from swiftsnails_tpu_torch.data.ctr import synth_ctr

    labels, feats, _ = synth_ctr(256, 5, vocab_per_field=40, seed=2)
    cfg = Config({"num_fields": "5", "capacity": "2048", "batch_size": "64",
                  **{k: str(v) for k, v in extra.items()}})
    tr = get_model(model)(cfg, data=(labels, feats), device="cpu")
    cost = tr.step_cost(next(iter(tr.batches())))["cost"]
    assert cost["flops"] > 0 and cost["bytes_accessed"] > 0
    assert sum(t.numel() for t in tr.init_state().dense.values()) == tr.dense_size()


@pytest.mark.parametrize("path", [
    {}, {"packed": 0}, {"neg_mode": "per_pair"}, {"fused": 1},
    {"fused": 1, "grouped": 1, "centers_per_block": 32, "batch_size": 128},
    {"fused": 1, "grouped": 1, "resident": 1, "hot_rows": 64, "centers_per_block": 32,
     "batch_size": 128},
    {"fused": 1, "grouped": 1, "dedup": 1, "u_cap": 64, "centers_per_block": 32,
     "batch_size": 128},
    {"fused": 1, "grouped": 1, "dedup": 1, "resident": 1, "u_cap": 64, "hot_rows": 32,
     "centers_per_block": 32, "batch_size": 128}])
def test_step_cost_every_word2vec_path(path):
    tr = _w2v(**path)
    cost = tr.step_cost(next(iter(tr.batches())))
    assert cost["cost"]["flops"] > 0 and cost["cost"]["bytes_accessed"] > 0
    assert cost["total_bytes"] is None
