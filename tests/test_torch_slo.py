"""The port's SLO tracker against the JAX package's, on the CPU: the same
request outcomes under one fake clock give the same burn rates, budget,
alert edges, ``slo_burn`` and ``scale_hint`` events and snapshot; the
servant and the fleet feed it one record a request (``device="cpu"``).
"""

import numpy as np
import pytest

from swiftsnails_tpu.telemetry import slo as jslo
from swiftsnails_tpu.telemetry.ledger import Ledger as JLedger
from swiftsnails_tpu.utils.config import Config as JConfig

from swiftsnails_tpu_torch.serving import Fleet, Servant
from swiftsnails_tpu_torch.telemetry import slo
from swiftsnails_tpu_torch.telemetry.ledger import Ledger, render_failures
from swiftsnails_tpu_torch.utils.config import Config


def _drive(mod, led, seed):
    """A seeded trace of outcomes through one tracker; its readings after
    every step."""
    t = [0.0]
    trk = mod.SloTracker({"pull": mod.SloObjective(10.0, availability=0.95),
                          "topk": (20.0, 0.99)}, window_s=60.0, ledger=led,
                         clock=lambda: t[0], default=mod.SloObjective(15.0))
    rng = np.random.default_rng(seed)
    readings = []
    for n in range(400):
        t[0] += float(rng.exponential(0.4))
        kernel = ("pull", "topk", "score")[n % 3]
        burst = 150 <= n < 220  # an incident: slow and failing
        lat = float(rng.exponential(30.0 if burst else 3.0))
        trk.record(kernel, lat, ok=not (burst and n % 4 == 0))
        if n % 10 == 0:
            readings.append((trk.burn_rates("pull"), trk.burn_rates("topk"),
                             trk.error_budget_remaining("pull"), trk.should_scale()))
    return trk, readings


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_burn_math_equals_jax(tmp_path, seed):
    led, jled = Ledger(str(tmp_path / "p.jsonl")), JLedger(str(tmp_path / "j.jsonl"))
    ours, r_ours = _drive(slo, led, seed)
    theirs, r_theirs = _drive(jslo, jled, seed)
    assert r_ours == r_theirs
    assert ours.snapshot() == theirs.snapshot() and ours.stats() == theirs.stats()
    strip = lambda recs: [{k: v for k, v in r.items() if k not in ("ts", "env")}  # noqa: E731
                          for r in recs]
    for kind in ("slo_burn", "scale_hint"):
        assert strip(led.records(kind)) == strip(jled.records(kind))
    assert ours.stats()["burn_events"] >= 1
    assert "SLO-BURN" in render_failures(led)


@pytest.mark.parametrize("keys", [
    {}, {"slo_latency_ms": "0"}, {"slo_latency_ms": "25"},
    {"slo_latency_ms": "25", "slo_availability": "0.99", "slo_window_s": "120"}])
def test_from_config_equals_jax(keys):
    ours = slo.SloTracker.from_config(Config(dict(keys)))
    theirs = jslo.SloTracker.from_config(JConfig(dict(keys)))
    assert (ours is None) == (theirs is None)
    if ours is not None:
        assert ours.window_s == theirs.window_s
        assert {k: (o.latency_ms, o.availability) for k, o in ours.objectives.items()} == \
            {k: (o.latency_ms, o.availability) for k, o in theirs.objectives.items()}


def test_servant_and_fleet_record_every_request():
    table = np.random.default_rng(0).standard_normal((32, 8)).astype(np.float32)
    trk = slo.SloTracker({"pull": 1e6, "topk": 1e6})
    with Servant({"t": table}, batch_buckets=(8,), slo=trk, device="cpu") as sv:
        for _ in range(5):
            sv.pull([1, 2])
        sv.topk(table[0], k=2)
        assert sv.stats()["slo"]["pull"]["total"] == 5
        assert sv.stats()["slo"]["topk"]["total"] == 1
    fleet_trk = slo.SloTracker({"pull": 1e-9})  # every request is over its SLO

    def factory(rid):
        return Servant({"t": table}, batch_buckets=(8,), device="cpu")

    with Fleet(factory, replicas=2, hedge_budget_pct=0.0, slo=fleet_trk) as fleet:
        for k in range(6):
            fleet.pull([k])
        snap = fleet.stats()["slo"]["pull"]
        assert snap["total"] == 6 and snap["bad"] == 6 and snap["alerting"]
        assert fleet_trk.should_scale()


def test_ops_dashboard_renders_as_jax(tmp_path):
    """``render_ops`` over a live servant's snapshot and
    ``render_ops_from_ledger`` over one ledger: the JAX package's text."""
    from swiftsnails_tpu.telemetry import ops as jops
    from swiftsnails_tpu.telemetry.ledger import Ledger as JL

    from swiftsnails_tpu_torch.telemetry import ops

    table = np.random.default_rng(0).standard_normal((32, 8)).astype(np.float32)
    with Servant({"t": table}, batch_buckets=(8,), device="cpu",
                 slo=slo.SloTracker({"pull": 1e-9})) as sv:
        sv.pull([1, 2])
        stats, health = sv.stats(), sv.health()
    assert ops.render_ops(stats, health=health) == jops.render_ops(stats, health=health)
    path = str(tmp_path / "l.jsonl")
    trk = slo.SloTracker({"pull": 1.0}, ledger=Ledger(path))
    for _ in range(30):
        trk.record("pull", 5.0)
    trk.should_scale()
    assert ops.render_ops_from_ledger(Ledger(path)) == jops.render_ops_from_ledger(JL(path))
    assert "pull" in ops.render_ops_from_ledger(Ledger(path))
