"""The port's drift sentinel against the JAX package's on the same seeded
series (the detectors' edges, states and ledger events), incident bundles,
the TrainLoop's wiring under a ``slow_step`` injection with the loop's
clock injected (no timed sleeps: the step times are fed in), and the drift
drill on the CPU with a ``slow_step`` far longer than the step, and
``tools.drift_rate``'s counts of its verdicts."""

import json
import os

import numpy as np
import pytest
import torch

from swiftsnails_tpu.telemetry import drift as jax_drift
from swiftsnails_tpu.telemetry import ledger as jax_ledger

from swiftsnails_tpu_torch.framework import trainer as trainer_mod
from swiftsnails_tpu_torch.framework.trainer import Trainer, TrainLoop
from swiftsnails_tpu_torch.resilience import chaos as chaos_mod
from swiftsnails_tpu_torch.telemetry import drift, ledger
from swiftsnails_tpu_torch.telemetry import tracer as tracer_mod
from swiftsnails_tpu_torch.telemetry.drift_lane import INJECT_FIRST, INJECT_LAST, drift_drill
from swiftsnails_tpu_torch.tools import drift_rate
from swiftsnails_tpu_torch.utils.config import Config
from swiftsnails_tpu_torch.utils.metrics import MetricsLogger


def _series(seed, n=120):
    """A noisy level with a shift, a spike, a NaN and a slow ramp."""
    rng = np.random.default_rng(seed)
    x = 10.0 + rng.normal(0, 0.3, n)
    x[0] = 2000.0  # the cold first step
    x[30] = 60.0  # one slow step: decays away
    x[45] = float("nan")
    x[60:] += 8.0 * (1 + seed % 3)  # a sustained shift
    x[90:] += np.linspace(0, 20, n - 90)
    return [float(v) for v in x]


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("params", [{}, {"alpha": 0.1, "k": 0.5, "h": 4.0, "warmup": 4}])
def test_ewma_cusum_matches(seed, params):
    port = drift.EwmaCusum("step_ms", **params)
    ref = jax_drift.EwmaCusum("step_ms", **params)
    for i, v in enumerate(_series(seed)):
        assert port.update(v, step=i) == ref.update(v, step=i)
        assert port.state() == ref.state()
        if port.drifted and i % 17 == 0:
            port.reset()
            ref.reset()


@pytest.mark.parametrize("seed", range(4))
def test_sentinel_matches(seed, tmp_path):
    rng = np.random.default_rng(seed)
    led = ledger.Ledger(str(tmp_path / "port.jsonl"))
    jled = jax_ledger.Ledger(str(tmp_path / "jax.jsonl"))
    port = drift.DriftSentinel(warmup=6, ledger=led, context={"model": "toy"})
    ref = jax_drift.DriftSentinel(warmup=6, ledger=jled, context={"model": "toy"})
    a, b = _series(seed), _series(seed + 1)
    for i in range(len(a)):
        row = {"step_ms": a[i], "loss": b[i] / 10, "prefetch_stall_ms": float(rng.random())}
        if i % 5 == 0:
            row["exchange_bytes"] = 1e6
        assert port.observe(i, row) == ref.observe(i, row)
        if i == 100:
            port.reset()
            ref.reset()
    assert port.summary() == ref.summary()
    strip = lambda recs: [{k: v for k, v in r.items() if k != "ts"} for r in recs]  # noqa: E731
    assert strip(led.records("drift")) == strip(jled.records("drift"))
    assert port.events == len(led.records("drift")) >= 1


def test_bundles(tmp_path):
    from swiftsnails_tpu_torch.telemetry.blackbox import BlackBox
    from swiftsnails_tpu_torch.telemetry.timeseries import TimeSeriesStore
    from swiftsnails_tpu_torch.telemetry.tracer import Tracer

    bb = BlackBox(capacity=4, directory=str(tmp_path / "bb"))
    for s in range(6):
        bb.record_step(s, step_ms=1.0)
    ts = TimeSeriesStore()
    ts.sample(3, {"step_ms": 1.0})
    tr = Tracer()
    with tr.span("step"):
        pass
    paths = [drift.build_incident_bundle(tmp_path / "inc", "drift-step_ms", blackbox=bb,
                                         timeseries=ts, tracer=tr, context={"m": 1})
             for _ in range(2)]
    assert len(set(paths)) == 2  # the same second: two distinct bundles
    for p in paths:
        assert drift.bundle_complete(p)
        assert jax_drift.bundle_complete(p)
        man = json.load(open(os.path.join(p, "manifest.json")))
        assert man["first_step"] == 2 and man["last_step"] == 5
        assert sorted(man["files"]) == ["blackbox.json", "fingerprint.json",
                                        "timeseries.jsonl", "traces.json"]
    bare = drift.build_incident_bundle(tmp_path / "inc", "bare")
    assert not drift.bundle_complete(bare) and not jax_drift.bundle_complete(bare)


class _Clock:
    """The loop's clock, advanced by the steps themselves: a step takes
    1 ms +- 10 us, an injected slow step ``chaos_slow_step_ms`` more."""

    def __init__(self):
        self.t = 1000.0

    def monotonic(self):
        return self.t

    def perf_counter(self):
        return self.t

    def perf_counter_ns(self):
        return int(self.t * 1e9)

    def sleep(self, s):
        self.t += s


@pytest.fixture
def clock(monkeypatch):
    clk = _Clock()
    for mod in (trainer_mod, chaos_mod, tracer_mod):
        monkeypatch.setattr(mod, "time", clk)
    return clk


class ToyTrainer(Trainer):
    name = "toy"

    def __init__(self, config, clock, nan=False):
        super().__init__(config, device="cpu")
        self.clock, self.nan, self.n = clock, nan, 0

    def init_state(self):
        return {"w": torch.zeros(4)}

    def batches(self):
        for _ in range(64):
            yield {"x": np.ones((8, 4), np.float32)}

    def train_step(self, state, batch, generator):
        self.n += 1
        self.clock.sleep(1e-3 + 1e-5 * (-1) ** self.n)
        w = state["w"] + batch["x"].mean(0)
        loss = torch.tensor(float("nan") if self.nan else 1.0)
        return {"w": w}, {"loss": loss}


def _drift_loop(tmp_path, clock, **kw):
    cfg = Config({
        "telemetry": "1", "profile_cadence": "1", "profile_window": "64",
        "drift_detect": "1", "drift_warmup": "6", "prefetch_batches": "0",
        "blackbox_dir": str(tmp_path / "bb"), "incident_dir": str(tmp_path / "incidents"),
        "ledger_path": str(tmp_path / "ledger.jsonl"),
        "chaos_spec": "slow_step@16-40", "chaos_slow_step_ms": "25"})
    return TrainLoop(ToyTrainer(cfg, clock, **kw), metrics=MetricsLogger(echo=False),
                     log_every=1)


def test_trainloop_detects_slow_step_drift_and_bundles(tmp_path, clock):
    loop = _drift_loop(tmp_path, clock)
    loop.run(max_steps=48)
    det = loop.drift.detectors["step_ms"]
    assert loop.drift.events == 1 and det.drifted and 16 <= det.drift_step <= 18
    led = ledger.Ledger(str(tmp_path / "ledger.jsonl"))
    assert [e["signals"] for e in led.records("drift")] == [["step_ms"]]
    assert len(loop.incidents) == 1 and drift.bundle_complete(loop.incidents[0])
    run = led.latest("run")
    assert run["drift"]["events"] == 1 and run["drift"]["drifted"]
    # the injected stall lands in host_blocked, not in the step
    dec = run["goodput"]["decomposition"]
    assert dec["host_blocked_s"] == pytest.approx(25 * 25e-3, rel=1e-6)
    assert dec["compute_s"] == pytest.approx(48e-3, rel=1e-3)
    assert [r["fault"] for r in led.records("chaos")] == ["slow_step"] * 25


def test_drift_and_nan_in_same_window_make_two_distinct_bundles(tmp_path, clock):
    loop = _drift_loop(tmp_path, clock, nan=True)
    loop.run(max_steps=48)
    assert loop.drift.events == 1  # a NaN loss is non-finite: the CUSUM skips it
    assert len(loop.incidents) == 2 and len(set(loop.incidents)) == 2
    reasons = {json.load(open(os.path.join(p, "manifest.json")))["reason"]
               for p in loop.incidents}
    assert reasons == {"nan-loss", "drift-step_ms"}
    assert all(drift.bundle_complete(p) for p in loop.incidents)
    boxes = ledger.Ledger(str(tmp_path / "ledger.jsonl")).records("blackbox")
    assert [b["reason"] for b in boxes] == ["nan-loss"]


def test_incident_dir_untouched_without_profiler_or_sentinel(tmp_path, clock):
    cfg = Config({"telemetry": "1", "blackbox_dir": str(tmp_path / "bb"),
                  "incident_dir": str(tmp_path / "incidents")})
    loop = TrainLoop(ToyTrainer(cfg, clock, nan=True), metrics=MetricsLogger(echo=False),
                     log_every=1)
    loop.run(max_steps=4)
    assert loop.incidents == [] and not os.path.exists(tmp_path / "incidents")
    assert len(os.listdir(tmp_path / "bb")) == 1  # the black box still dumps


def test_drift_drill_on_the_cpu(tmp_path):
    """The drill's 80 ms slow steps against dense dim-16 steps of a few ms:
    detected inside the injected band, one drift event, a complete bundle,
    and ``--diff`` naming host_blocked; the gate passes on its block. One
    intra-op thread: on a host shared with other test processes, torch's
    default thread count makes a few-ms step's jitter as large as the
    injected stall, which then goes undetected."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = drift_drill(str(tmp_path), device="cpu")
    finally:
        torch.set_num_threads(n)
    assert out["detected"], out
    assert out["inject_step"] < out["detect_step"] <= out["inject_last"] + 1
    assert out["drift_events"] == 1 and out["bundle_complete"]
    assert out["attribution"]["dominant"] == "host_blocked"
    led = ledger.Ledger(str(tmp_path / "gate.jsonl"))
    led.append("bench", {"payload": {"drift": out}})
    rc, msg = ledger.check_regression(led, 10.0)
    assert rc == 2 and "drift ok" in msg  # 2: no measured bench value to gate


def test_drift_rate_counts_the_drills_verdicts(capsys):
    """``tools.drift_rate`` on the CPU with one intra-op thread: a line a
    run, then the summary, in which every run held the gate."""
    n = torch.get_num_threads()
    try:
        assert drift_rate.main(["--runs", "2", "--device", "cpu", "--threads", "1"]) == 0
    finally:
        torch.set_num_threads(n)
    lines = capsys.readouterr().out.strip().splitlines()
    runs, summary = [json.loads(line) for line in lines[:-1]], json.loads(lines[-1])
    assert [r["run"] for r in runs] == [0, 1]
    assert summary["band"] == [INJECT_FIRST + 1, INJECT_LAST + 1]
    assert (summary["runs"], summary["held"], summary["early"], summary["missed"]) == \
        (2, 2, 0, 0)
    assert summary["threads"] == 1 and summary["device"] == "cpu"
