"""The ``drift`` lane: the scripted slow-step drift drill + the continuous
profiler's own-overhead measurement — the JAX package's
``telemetry/drift_lane.py``.

One implementation used by ``chip_smoke.py``'s ``telemetry`` phase (on the
card) and the CPU tests, so the drill and its gate cannot drift apart. Each
function takes ``device`` (``None``: the card); ``profiler_overhead`` also
takes the trainer to measure (default: the drill's small dense trainer), so
the card run measures it at full width.

Two measurements, one JSON-ready block each:

* :func:`drift_drill` — a control run and a ``slow_step@A-B`` chaos run
  share one ledger; the chaos run must *detect* the injected drift
  within the run (step-time EWMA/CUSUM), emit exactly one
  transition-edged ``drift`` ledger event, leave a complete incident
  bundle behind, and the before/after run records' ``--diff``
  attribution must name host-blocked as the dominant contributor.
* :func:`profiler_overhead` — words/sec with the sampler + sentinel on
  vs off at equal work, warm-then-best-of-3 per leg (the chaos lane's
  guardrail-overhead recipe), with the off leg's own spread as the
  noise floor. ``ledger-report --check-regression`` fails the lane when
  the overhead clears both the 3% ceiling and the noise floor.

Everything is deterministic (fixed seeds, fixed fault schedule); the
drill is CPU-sized and runs in seconds on either device.
"""

from __future__ import annotations

import os
import tempfile
import time
from typing import Callable, Dict, Optional

from swiftsnails_tpu_torch.utils.device import DeviceLike

# the drill's fault schedule: slow_step on a contiguous band, long enough
# that host-blocked dominates the A->B delta over compile jitter. Step ``s``
# is sampled as ``s + 1``, so the band's first sample is INJECT_FIRST + 1 =
# 12. The sentinel's default warmup of 8 seeds its location and scale from
# samples 2-9 and scores from sample 10, so two clean samples are scored
# before the band. No more: one host stall of a few-ms step, scored
# against a quiet warmup, trips the sentinel, and the longer the scored
# stretch before the band, the likelier such a stall lands in it first.
DRILL_STEPS = 48
INJECT_FIRST = 11
INJECT_LAST = 43
SLOW_STEP_MS = 80.0
PROFILE_CADENCE = 4        # the overhead legs' realistic sampling cadence
OVERHEAD_CEIL_PCT = 3.0    # the acceptance bar the gate enforces


def _workdir(workdir: Optional[str]) -> str:
    if workdir:
        os.makedirs(workdir, exist_ok=True)
        return workdir
    return tempfile.mkdtemp(prefix="ssn-drift-")


def drift_drill(workdir: Optional[str] = None,
                small: bool = True, device: DeviceLike = None,
                inject_first: int = INJECT_FIRST) -> Dict:
    """Run the before/after drift drill on ``device``, the slow_step band
    opening at step ``inject_first``; returns the gateable ``drift`` block
    (detection, event count, bundle, attribution)."""
    from swiftsnails_tpu_torch.resilience.drill import make_trainer, run_loop
    from swiftsnails_tpu_torch.telemetry.drift import bundle_complete
    from swiftsnails_tpu_torch.telemetry.goodput import throughput_attribution
    from swiftsnails_tpu_torch.telemetry.ledger import Ledger

    t0 = time.monotonic()
    base = _workdir(workdir)
    ledger_path = os.path.join(base, "DRILL_LEDGER.jsonl")
    incident_dir = os.path.join(base, "incidents")
    common = {
        "telemetry": 1,
        "profile_cadence": 1,
        "profile_window": 256,
        "num_iters": 8,
        "ledger_path": ledger_path,
        "incident_dir": incident_dir,
    }

    # before: the undisturbed control run (drift sentinel off — its run
    # record is the --diff baseline, not a detection subject)
    ctrl_dir = os.path.join(base, "before")
    os.makedirs(ctrl_dir, exist_ok=True)
    tr = make_trainer(ctrl_dir, device=device, **dict(
        common, blackbox_dir=os.path.join(ctrl_dir, "blackbox")))
    run_loop(tr, max_steps=DRILL_STEPS)

    # after: same work + slow_step@A-B chaos, sentinel armed
    drift_dir = os.path.join(base, "after")
    os.makedirs(drift_dir, exist_ok=True)
    tr2 = make_trainer(drift_dir, device=device, **dict(
        common,
        blackbox_dir=os.path.join(drift_dir, "blackbox"),
        drift_detect=1,
        chaos_spec=f"slow_step@{inject_first}-{INJECT_LAST}",
        chaos_slow_step_ms=SLOW_STEP_MS,
    ))
    loop, _state, _steps = run_loop(tr2, max_steps=DRILL_STEPS)

    ledger = Ledger(ledger_path)
    runs = ledger.records("run")
    drift_events = ledger.records("drift")
    det = (loop.drift.detectors.get("step_ms")
           if loop.drift is not None else None)
    detect_step = det.drift_step if det is not None else None
    detected = (detect_step is not None
                and inject_first < detect_step <= INJECT_LAST + 1)
    bundle = loop.incidents[0] if loop.incidents else None
    attribution = (throughput_attribution(runs[-2], runs[-1])
                   if len(runs) >= 2 else {"dominant": "insufficient-data"})
    return {
        "detected": bool(detected),
        "detect_step": detect_step,
        "inject_step": inject_first,
        "inject_last": INJECT_LAST,
        "slow_step_ms": SLOW_STEP_MS,
        "window_steps": DRILL_STEPS,
        "drift_events": len(drift_events),
        "signals": list(loop.drift.tripped) if loop.drift else [],
        "bundle": bundle,
        "bundle_complete": bool(bundle and bundle_complete(bundle)),
        "attribution": attribution,
        "ledger": ledger_path,
        "small": small,
        "elapsed_s": round(time.monotonic() - t0, 1),
    }


def profiler_overhead(workdir: Optional[str] = None,
                      small: bool = True, device: DeviceLike = None,
                      make: Optional[Callable[[Dict], object]] = None,
                      steps: Optional[int] = None) -> Dict:
    """Words/sec with continuous profiling (sampler + drift sentinel at
    ``PROFILE_CADENCE``) on vs off, equal work; returns the gateable
    ``profile_overhead`` block. ``make(extra_config)`` builds the trainer of
    each leg (default: the drill's dense trainer at the lane's size);
    ``steps`` overrides the steps a repetition."""
    from swiftsnails_tpu_torch.framework.trainer import TrainLoop
    from swiftsnails_tpu_torch.resilience.drill import make_trainer

    t0 = time.monotonic()
    base = _workdir(workdir)
    over = {
        "telemetry": 1,
        "dim": 16 if small else 64,
        "batch_size": 512 if small else 2048,
        "window": 2,
        "num_iters": 60,
    }
    # reps long enough (hundreds of ms) to average over machine-load
    # bursts — sub-100ms reps made the ratio pure scheduler noise
    warm, reps = 3, 3
    if steps is None:
        steps = 768 if small else 1024

    def make_loop(extra: Dict):
        d = tempfile.mkdtemp(dir=base)
        extra = dict(extra, blackbox_dir=os.path.join(d, "blackbox"),
                     incident_dir=os.path.join(d, "incidents"))
        if make is not None:
            tr = make(dict(extra, telemetry=1))
        else:
            tr = make_trainer(d, device=device, **dict(over, **extra))
        loop = TrainLoop(tr, log_every=0)
        loop.run(max_steps=warm)  # pays the first calls (allocations, builds)
        return loop

    def timed(loop) -> float:
        i0 = loop._items_seen
        t1 = time.monotonic()
        loop.run(max_steps=steps)
        dt = max(time.monotonic() - t1, 1e-9)
        # rate from items actually trained, not the requested step count —
        # a short epoch silently capping the run must not skew one leg
        return (loop._items_seen - i0) / dt

    # the legs are interleaved rep-by-rep so machine-load drift hits both
    # equally; per-leg MEDIAN is the robust estimator under bursty load.
    # The on leg pays the sampler + the sentinel's full detector
    # arithmetic; the trip threshold is parked out of reach because
    # incident-response I/O (bundle build on a spurious trip) is not
    # steady-state profiling cost.
    loop_off = make_loop({"profile_cadence": 0})
    loop_on = make_loop({"profile_cadence": PROFILE_CADENCE,
                         "drift_detect": 1, "drift_cusum_h": 1e6})
    off, on = [], []
    for _ in range(reps):
        off.append(timed(loop_off))
        on.append(timed(loop_on))
    off_s, on_s = sorted(off), sorted(on)
    wps_off, wps_on = off_s[len(off) // 2], on_s[len(on) // 2]
    overhead_pct = ((wps_off - wps_on) / wps_off * 100.0
                    if wps_off else None)
    noise_pct = ((max(off) - min(off)) / wps_off * 100.0
                 if wps_off else 0.0)
    return {
        "words_per_sec_off": round(wps_off, 1),
        "words_per_sec_on": round(wps_on, 1),
        "overhead_pct": (round(overhead_pct, 2)
                         if overhead_pct is not None else None),
        "noise_pct": round(noise_pct, 2),
        "overhead_ceil_pct": OVERHEAD_CEIL_PCT,
        "cadence": PROFILE_CADENCE,
        "small": small,
        "elapsed_s": round(time.monotonic() - t0, 1),
    }


def drift_bench(workdir: Optional[str] = None, small: bool = True,
                device: DeviceLike = None) -> Dict:
    """The full lane: drill + overhead, as one JSON-ready block (for a
    bench line or a ledger record, and the ``--check-regression`` gate)."""
    base = _workdir(workdir)
    drill = drift_drill(os.path.join(base, "drill"), small=small, device=device)
    overhead = profiler_overhead(os.path.join(base, "overhead"), small=small,
                                 device=device)
    ok = (drill["detected"] and drill["drift_events"] == 1
          and drill["bundle_complete"]
          and (drill["attribution"] or {}).get("dominant") == "host_blocked"
          and overhead["overhead_pct"] is not None
          and overhead["overhead_pct"] <= max(
              OVERHEAD_CEIL_PCT, overhead["noise_pct"]))
    return {"drift": drill, "profile_overhead": overhead, "ok": ok}
