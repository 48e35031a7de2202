"""The bench ``fleet`` lane: max sustainable QPS at a fixed p99 SLO, 1 vs N —
the JAX package's ``serving/fleet_lane.py``, with its constants, over the
port's checkpoints and ``Fleet`` on ``device`` (default: the card).

The headline question a replica pool must answer is not "how fast is one
request" but "how much offered load can the fleet absorb before the tail
blows through the SLO" — the metric that decides how many replicas a
deployment needs. This lane sweeps an open-loop zipf workload
(:mod:`swiftsnails_tpu_torch.serving.loadgen`) up a geometric QPS ladder against
one servant and against an N-replica :class:`~swiftsnails_tpu_torch.serving.fleet.Fleet`,
and reports the highest offered rate each sustains with ``p99 <= SLO`` and
a clean error rate; ``scaling_x`` is the fleet/single ratio the
``ledger-report --check-regression`` gate floors at 1.6x for 2 replicas.

**Why this is CPU-valid.** What the lane measures is the *routing
machinery* — queueing, affinity, spill, hedging — not device kernel speed.
Per-dispatch device service time is modeled with an injectable
``service_floor_ms`` stall on each replica's dispatch hook (the same seam
the chaos drill uses), which sleeps without holding the GIL exactly as an
accelerator kernel would run without holding the host. That makes each
replica an honest single-server queue with a known service rate on any
host, so 1-vs-N scaling reflects the router's ability to spread load — the
thing this lane exists to gate — rather than how many idle cores the CI
box happens to have. The floor is recorded in the bench block.

Two controlled comparisons ride along, both at equal offered load:

* **affinity vs random**: the same zipf traffic through ring-affinity
  routing and through round-robin spray, with per-replica LRUs much
  smaller than the working set — affinity's aggregate hit rate must win.
* **hedge vs no-hedge**: one replica intermittently stalled, hedging on
  (budget-capped) vs off — hedging must cut the measured p99.

On the card the modeled floor stands in for the device time as it does on
the TPU: the lane gates the router, and each dispatch still runs the
port's pull (``gather_rows``) on the card.
"""

from __future__ import annotations

import os
import statistics
import tempfile
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from swiftsnails_tpu_torch.serving.bench_lane import _build_word2vec_checkpoint
from swiftsnails_tpu_torch.serving.fleet import Fleet
from swiftsnails_tpu_torch.serving.loadgen import run_open_loop
from swiftsnails_tpu_torch.telemetry.request_trace import (
    RequestTracer,
    tree_complete,
)
from swiftsnails_tpu_torch.utils.device import DeviceLike

FLEET_SEED = 13
SLO_P99_MS = 60.0
SERVICE_FLOOR_MS = 6.0
BATCH = 8
ZIPF_A = 1.1
SCALING_FLOOR = 1.6
AVAILABILITY_FLOOR_PCT = 99.0
TRACE_OVERHEAD_CEIL_PCT = 3.0
TRACE_SAMPLE_RATE = 0.1
_BASE_QPS = 30.0
_LADDER_GROWTH = 1.35
_MAX_POINTS = 12
_REFINE_RATIO = 1.15  # stop bisecting when fail/pass is this tight


def _floor_hook(floor_ms: float) -> Callable[[str, int], None]:
    """Model per-dispatch device service time: a GIL-free stall on the
    dispatcher thread, where a real kernel would be executing."""
    floor_s = floor_ms / 1e3

    def hook(kernel: str, index: int) -> None:
        time.sleep(floor_s)

    return hook


def _install_floor(fleet: Fleet, floor_ms: float) -> None:
    for rep in fleet.replicas():
        rep.servant.fault_hook = _floor_hook(floor_ms)


def _prewarm(fleet: Fleet, capacity: int) -> None:
    """Compile each replica's pull kernel off the measured path."""
    ids = np.arange(BATCH, dtype=np.int32) % capacity
    for rep in fleet.replicas():
        rep.servant.pull(ids)


def _quiesce(fleet: Fleet, timeout_s: float = 10.0) -> None:
    """Wait for every queue to empty between sweep points so one
    overloaded point cannot poison the next measurement."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        busy = any(
            rep.inflight > 0 or any(rep.servant.queue_depths().values())
            for rep in fleet.replicas()
        )
        if not busy:
            break
        time.sleep(0.05)
    time.sleep(0.05)


def _point_ok(point: Dict, slo_ms: float) -> bool:
    return point["p99_ms"] <= slo_ms and point["error_rate_pct"] <= 1.0


def _sweep(
    fleet: Fleet,
    *,
    capacity: int,
    duration_s: float,
    slo_ms: float,
    seed: int,
) -> Dict:
    """Ascend the offered-QPS ladder until the SLO breaks, then bisect
    between the last passing and first failing rung — max sustainable must
    not be quantized by the geometric ladder spacing, or the 1-vs-N ratio
    inherits up to a full ladder step of error."""
    points: List[Dict] = []
    step = [0]

    def probe(qps: float) -> bool:
        res = run_open_loop(
            lambda anchor, ids: fleet.pull(ids),
            qps=qps, duration_s=duration_s, seed=seed + step[0],
            id_space=capacity, batch=BATCH, zipf_a=ZIPF_A,
        )
        step[0] += 1
        points.append({k: res[k] for k in (
            "offered_qps", "achieved_qps", "p50_ms", "p95_ms", "p99_ms",
            "error_rate_pct")})
        _quiesce(fleet)
        return _point_ok(res, slo_ms)

    max_qps, fail_qps = 0.0, 0.0
    qps = _BASE_QPS
    for _ in range(_MAX_POINTS):
        if probe(qps):
            max_qps = qps
            qps *= _LADDER_GROWTH
        else:
            fail_qps = qps
            break
    while (max_qps > 0 and fail_qps > 0
           and fail_qps / max_qps > _REFINE_RATIO):
        mid = (max_qps * fail_qps) ** 0.5
        if probe(mid):
            max_qps = mid
        else:
            fail_qps = mid
    return {"max_qps": round(max_qps, 2), "points": points}


def _confirm(
    fleet: Fleet,
    *,
    qps: float,
    capacity: int,
    duration_s: float,
    slo_ms: float,
    seed: int,
) -> tuple:
    """Reproduce the claimed max before reporting it: re-run at the rate
    the sweep found, retry once on failure (knee-region runs are noisy at
    these durations), then demote geometrically. The operating point the
    lane reports is one that actually held the SLO when re-measured — both
    the single and fleet maxes go through this, so the scaling ratio
    compares two confirmed rates, not two lucky rungs."""
    rate, res = qps, None
    for attempt in range(5):
        for rep in fleet.replicas():
            rep.servant.reset_metrics()
            rep.requests = 0  # per-replica split describes this pass only
        res = run_open_loop(
            lambda anchor, ids: fleet.pull(ids),
            qps=rate, duration_s=duration_s, seed=seed + attempt,
            id_space=capacity, batch=BATCH, zipf_a=ZIPF_A,
        )
        _quiesce(fleet)
        if _point_ok(res, slo_ms):
            break
        if attempt % 2 == 1:
            rate /= _REFINE_RATIO
    return round(rate, 2), res


def _aggregate_hit_rate(fleet: Fleet) -> float:
    hits = sum(r.servant.cache.hits for r in fleet.replicas())
    misses = sum(r.servant.cache.misses for r in fleet.replicas())
    return hits / (hits + misses) if (hits + misses) else 0.0


def _affinity_leg(
    mk_fleet: Callable[..., Fleet],
    *,
    capacity: int,
    qps: float,
    duration_s: float,
    affinity: bool,
    seed: int,
) -> Dict:
    """Steady-state aggregate LRU hit rate under one routing policy: warm
    pass first, then counters reset, then the measured pass."""
    with mk_fleet(affinity=affinity, cache_rows=16 * BATCH) as fleet:
        _install_floor(fleet, SERVICE_FLOOR_MS)
        _prewarm(fleet, capacity)
        submit = lambda anchor, ids: fleet.pull(ids)  # noqa: E731
        run_open_loop(submit, qps=qps, duration_s=duration_s / 2,
                      seed=seed, id_space=capacity, batch=BATCH,
                      zipf_a=ZIPF_A)
        _quiesce(fleet)
        for rep in fleet.replicas():
            rep.servant.reset_metrics()
        res = run_open_loop(submit, qps=qps, duration_s=duration_s,
                            seed=seed + 1, id_space=capacity, batch=BATCH,
                            zipf_a=ZIPF_A)
        _quiesce(fleet)
        return {"hit_rate": round(_aggregate_hit_rate(fleet), 4),
                "requests": res["requests"], "p99_ms": res["p99_ms"]}


def _stall_hook(floor_ms: float, stall_ms: float,
                every: int) -> Callable[[str, int], None]:
    """An intermittently sick replica: every ``every``-th dispatch stalls
    ``stall_ms`` on top of the service floor."""
    def hook(kernel: str, index: int) -> None:
        time.sleep(floor_ms / 1e3)
        if index % every == every - 1:
            time.sleep(stall_ms / 1e3)

    return hook


def _hedge_leg(
    mk_fleet: Callable[..., Fleet],
    *,
    capacity: int,
    qps: float,
    duration_s: float,
    budget_pct: float,
    stall_ms: float,
    seed: int,
) -> Dict:
    """p99 at equal offered load with one stalling replica; ``budget_pct``
    0 is the no-hedge control."""
    with mk_fleet(hedge_budget_pct=budget_pct) as fleet:
        reps = fleet.replicas()
        for rep in reps[:-1]:
            rep.servant.fault_hook = _floor_hook(SERVICE_FLOOR_MS)
        reps[-1].servant.fault_hook = _stall_hook(
            SERVICE_FLOOR_MS, stall_ms, every=5)
        _prewarm(fleet, capacity)
        res = run_open_loop(
            lambda anchor, ids: fleet.pull(ids),
            qps=qps, duration_s=duration_s, seed=seed,
            id_space=capacity, batch=BATCH, zipf_a=ZIPF_A,
        )
        _quiesce(fleet)
        reg = fleet.registry
        return {
            "p99_ms": res["p99_ms"],
            "p50_ms": res["p50_ms"],
            "error_rate_pct": res["error_rate_pct"],
            "hedged": int(reg.counter("serve.hedged").value),
            "hedge_won": int(reg.counter("serve.hedge_won").value),
            "hedge_rate_pct": round(fleet._gov.rate_pct, 3),
        }


def _trace_overhead_leg(
    mk_fleet: Callable[..., Fleet],
    *,
    capacity: int,
    qps: float,
    duration_s: float,
    seed: int,
    reps: int = 3,
) -> Dict:
    """Tracing on vs off at equal offered load — the ride-along that keeps
    the observability plane honest: head sampling at ``TRACE_SAMPLE_RATE``
    plus tail-keep must cost no more than ``TRACE_OVERHEAD_CEIL_PCT`` of
    throughput or p99 (the ``ledger-report --check-regression`` gate).

    A single on/off pair at these durations measures scheduler jitter, not
    tracing cost, so the legs run interleaved ``reps`` times and report
    medians plus ``p99_noise_ms`` — the off leg's own max-min spread. The
    gate only trips when the on-vs-off delta exceeds that spread: tracing
    has to cost more than the baseline disagrees with itself."""
    samples: Dict[str, List[Dict]] = {"off": [], "on": []}
    kept = 0
    for rep in range(max(1, reps)):
        for label, tracer in (
            ("off", None),
            ("on", RequestTracer(TRACE_SAMPLE_RATE, anomaly_keep=True,
                                 seed=FLEET_SEED + rep)),
        ):
            with mk_fleet(cache_rows=BATCH, hedge_budget_pct=0.0,
                          request_tracer=tracer) as fleet:
                _install_floor(fleet, SERVICE_FLOOR_MS)
                _prewarm(fleet, capacity)
                res = run_open_loop(
                    lambda anchor, ids: fleet.pull(ids),
                    qps=qps, duration_s=duration_s, seed=seed + rep,
                    id_space=capacity, batch=BATCH, zipf_a=ZIPF_A,
                )
                _quiesce(fleet)
                samples[label].append(res)
                if tracer is not None:
                    kept += tracer.stats()["kept"]

    def med(label: str, key: str) -> float:
        return float(statistics.median(s[key] for s in samples[label]))

    qps_off, qps_on = med("off", "achieved_qps"), med("on", "achieved_qps")
    p99_off, p99_on = med("off", "p99_ms"), med("on", "p99_ms")
    off_p99s = [s["p99_ms"] for s in samples["off"]]
    return {
        "offered_qps": round(qps, 1),
        "sample_rate": TRACE_SAMPLE_RATE,
        "reps": max(1, reps),
        "qps_off": qps_off,
        "qps_on": qps_on,
        "p99_off_ms": p99_off,
        "p99_on_ms": p99_on,
        "p99_off_reps": off_p99s,
        "p99_on_reps": [s["p99_ms"] for s in samples["on"]],
        "p99_noise_ms": round(max(off_p99s) - min(off_p99s), 3),
        "overhead_qps_pct": round(
            100.0 * (qps_off - qps_on) / qps_off if qps_off else 0.0, 3),
        "overhead_p99_pct": round(
            100.0 * (p99_on - p99_off) / p99_off if p99_off else 0.0, 3),
        "overhead_ceil_pct": TRACE_OVERHEAD_CEIL_PCT,
        "kept_traces": int(kept),
    }


def fleet_bench(
    small: bool = False,
    workdir: Optional[str] = None,
    ledger=None,
    replicas: int = 2,
    device: DeviceLike = None,
) -> Dict:
    """Run the fleet lane; returns the ``fleet`` block for the bench JSON.

    Headline fields (gated by ``ledger-report --check-regression``):
    ``qps`` (fleet max sustainable at the p99 SLO), ``scaling_x``
    (fleet/single), ``affinity`` hit rates, and the ``hedge`` comparison.
    """
    t_start = time.monotonic()
    dim = 16
    capacity = 1 << 11
    duration_s = 0.7 if small else 1.5
    rng_seed = FLEET_SEED

    own_tmp = None
    if workdir is None:
        own_tmp = tempfile.TemporaryDirectory(prefix="ssn-fleet-bench-")
        workdir = own_tmp.name
    try:
        root = os.path.join(workdir, "ckpt-w2v")
        cfg = _build_word2vec_checkpoint(root, dim, capacity, device=device)

        def mk_fleet(n: int = replicas, affinity: bool = True,
                     hedge_budget_pct: float = 10.0,
                     cache_rows: int = 1024, **extra) -> Fleet:
            return Fleet.from_checkpoint(
                root, cfg, replicas=n, ledger=ledger, device=device,
                batch_buckets=(BATCH,), cache_rows=cache_rows,
                queue_depth=64, **extra,
            ).configure(affinity=affinity,
                         hedge_budget_pct=hedge_budget_pct)

        # -- 1 vs N: max sustainable QPS at the p99 SLO --------------------
        # sweep legs pin the LRU to one batch so every request dispatches
        # and pays the modeled device service time — the sweep measures
        # dispatch/queueing capacity; cache economics are the affinity
        # leg's controlled comparison, not a confound here. Hedging is off
        # for the same reason: across homogeneous replicas at the knee
        # every hedge is pure work amplification (the duplicate steals a
        # service slot and then loses the race); its tail-rescue value is
        # measured in the dedicated stalled-replica leg below
        with mk_fleet(n=1, cache_rows=BATCH,
                      hedge_budget_pct=0.0) as single_fleet:
            _install_floor(single_fleet, SERVICE_FLOOR_MS)
            _prewarm(single_fleet, capacity)
            single = _sweep(single_fleet, capacity=capacity,
                            duration_s=duration_s, slo_ms=SLO_P99_MS,
                            seed=rng_seed)
            if single["max_qps"] > 0:
                single["max_qps"], _ = _confirm(
                    single_fleet, qps=single["max_qps"],
                    capacity=capacity, duration_s=duration_s,
                    slo_ms=SLO_P99_MS, seed=rng_seed + 50)

        with mk_fleet(cache_rows=BATCH, hedge_budget_pct=0.0) as fleet:
            _install_floor(fleet, SERVICE_FLOOR_MS)
            _prewarm(fleet, capacity)
            swept = _sweep(fleet, capacity=capacity, duration_s=duration_s,
                           slo_ms=SLO_P99_MS, seed=rng_seed + 100)
            # confirmation pass at the sustained rate with fresh counters:
            # the per-replica numbers describe the SLO-compliant operating
            # point, not the overloaded rungs above it
            at_max = None
            per_replica: Dict[str, Dict] = {}
            if swept["max_qps"] > 0:
                swept["max_qps"], at_max = _confirm(
                    fleet, qps=swept["max_qps"], capacity=capacity,
                    duration_s=duration_s, slo_ms=SLO_P99_MS,
                    seed=rng_seed + 200)
            fstats = fleet.stats()
            dur = (at_max or {}).get("duration_s") or 0.0
            for rid, rs in fstats["replicas"].items():
                per_replica[rid] = {
                    "requests": rs["requests"],
                    "qps": round(rs["requests"] / dur, 1) if dur else None,
                    "p50_ms": rs["kernels"]["pull"]["p50_ms"],
                    "p99_ms": rs["kernels"]["pull"]["p99_ms"],
                    "cache_hit_rate": rs["cache_hit_rate"],
                }
            hedge_info = fstats["hedge"]

        scaling = (swept["max_qps"] / single["max_qps"]
                   if single["max_qps"] > 0 else 0.0)

        # -- affinity vs random at equal offered load ----------------------
        probe_qps = max(min(0.6 * swept["max_qps"], 250.0), 60.0)
        aff = _affinity_leg(mk_fleet, capacity=capacity, qps=probe_qps,
                            duration_s=duration_s, affinity=True,
                            seed=rng_seed + 300)
        rnd = _affinity_leg(mk_fleet, capacity=capacity, qps=probe_qps,
                            duration_s=duration_s, affinity=False,
                            seed=rng_seed + 300)  # identical traffic

        # -- hedge vs no-hedge with one stalling replica -------------------
        hedge_qps = max(min(0.4 * swept["max_qps"], 120.0), 50.0)
        stall_ms = 80.0
        hedged = _hedge_leg(mk_fleet, capacity=capacity, qps=hedge_qps,
                            duration_s=1.5, budget_pct=30.0,
                            stall_ms=stall_ms, seed=rng_seed + 400)
        control = _hedge_leg(mk_fleet, capacity=capacity, qps=hedge_qps,
                             duration_s=1.5, budget_pct=0.0,
                             stall_ms=stall_ms, seed=rng_seed + 400)

        # -- tracing overhead at equal offered load ------------------------
        # 0.6x the knee: at saturation p99 measures queueing instability,
        # not tracing cost, and the comparison drowns in its own noise
        trace_qps = max(min(0.6 * swept["max_qps"], 150.0), 50.0)
        trace_overhead = _trace_overhead_leg(
            mk_fleet, capacity=capacity, qps=trace_qps,
            duration_s=duration_s, seed=rng_seed + 500)

        return {
            "seed": FLEET_SEED,
            "small": bool(small),
            "replicas": int(replicas),
            "slo_p99_ms": SLO_P99_MS,
            "service_floor_ms": SERVICE_FLOOR_MS,
            "batch": BATCH,
            "zipf_a": ZIPF_A,
            "duration_s": duration_s,
            "single": single,
            "fleet": {
                "max_qps": swept["max_qps"],
                "points": swept["points"],
                "at_max": {k: at_max[k] for k in (
                    "offered_qps", "achieved_qps", "p50_ms", "p95_ms",
                    "p99_ms", "error_rate_pct")} if at_max else None,
                "per_replica": per_replica,
                "hedge": hedge_info,
            },
            "scaling_x": round(scaling, 3),
            "scaling_floor": SCALING_FLOOR,
            "affinity": {
                "offered_qps": round(probe_qps, 1),
                "affinity_hit_rate": aff["hit_rate"],
                "random_hit_rate": rnd["hit_rate"],
                "affinity_p99_ms": aff["p99_ms"],
                "random_p99_ms": rnd["p99_ms"],
            },
            "hedge": {
                "offered_qps": round(hedge_qps, 1),
                "stall_ms": stall_ms,
                "budget_pct": 30.0,
                "p99_ms": hedged["p99_ms"],
                "nohedge_p99_ms": control["p99_ms"],
                "hedged": hedged["hedged"],
                "hedge_won": hedged["hedge_won"],
                "hedge_rate_pct": hedged["hedge_rate_pct"],
            },
            "trace_overhead": trace_overhead,
            "qps": swept["max_qps"],
            "p99_ms": (at_max or {}).get("p99_ms", 0.0),
            "elapsed_s": round(time.monotonic() - t_start, 2),
        }
    finally:
        if own_tmp is not None:
            own_tmp.cleanup()


# ------------------------------------------------------------ chaos drill ---


def fleet_chaos_drill(
    small: bool = True,
    workdir: Optional[str] = None,
    ledger=None,
    floor_pct: float = AVAILABILITY_FLOOR_PCT,
    device: DeviceLike = None,
) -> Dict[str, Dict]:
    """``chaos_drill --fleet``: one replica gets sick mid-storm;
    the fleet must hold the availability floor via re-route + hedging.

    Two drills, reusing the serving chaos kinds against exactly one
    replica: ``kill_replica`` storms it with ``serve_io_error`` dispatch
    faults (breaker trips, routing walks around it), ``slow_replica``
    storms it with ``serve_slow`` stalls (hedges rescue the stragglers).
    """
    from swiftsnails_tpu_torch.resilience.chaos import ChaosPlan, parse_chaos_spec

    dim, capacity = 16, 1 << 11
    duration_s = 1.2 if small else 2.5
    qps = 80.0

    own_tmp = None
    if workdir is None:
        own_tmp = tempfile.TemporaryDirectory(prefix="ssn-fleet-chaos-")
        workdir = own_tmp.name
    try:
        root = os.path.join(workdir, "ckpt-w2v")
        cfg = _build_word2vec_checkpoint(root, dim, capacity, device=device)
        results: Dict[str, Dict] = {}
        for drill, kind, stall_ms in (
            ("kill_replica", "serve_io_error", 0.0),
            ("slow_replica", "serve_slow", 90.0),
        ):
            # storm the victim's first ~60 dispatches (the whole run, at
            # this rate, is ~100 dispatches on that replica)
            spec = ",".join(f"{kind}@{i}" for i in range(0, 60))
            plan = ChaosPlan(parse_chaos_spec(spec), seed=FLEET_SEED,
                             ledger=ledger)
            # tail-keep only (rate 0): every hedged / re-routed / degraded
            # request must still land in the ring as a complete span tree
            tracer = RequestTracer(0.0, anomaly_keep=True, seed=FLEET_SEED)
            with Fleet.from_checkpoint(
                root, cfg, replicas=2, ledger=ledger, device=device,
                batch_buckets=(BATCH,), cache_rows=256, queue_depth=64,
                breaker_threshold=3, breaker_cooldown_ms=400.0,
                request_tracer=tracer,
            ).configure(hedge_budget_pct=30.0) as fleet:
                reps = fleet.replicas()
                for rep in reps[:-1]:
                    rep.servant.fault_hook = _floor_hook(SERVICE_FLOOR_MS)
                victim = reps[-1]

                def sick_hook(kernel: str, index: int,
                              _plan=plan) -> None:
                    time.sleep(SERVICE_FLOOR_MS / 1e3)
                    k = _plan.serve_fault(index)
                    if k == "serve_io_error":
                        raise OSError("chaos: injected serve I/O error")
                    if k == "serve_slow":
                        time.sleep(stall_ms / 1e3)

                victim.servant.fault_hook = sick_hook
                _prewarm_healthy(fleet, capacity, exclude=victim.id)
                res = run_open_loop(
                    lambda anchor, ids: fleet.pull(ids),
                    qps=qps, duration_s=duration_s, seed=FLEET_SEED,
                    id_space=capacity, batch=BATCH, zipf_a=ZIPF_A,
                )
                _quiesce(fleet)
                reg = fleet.registry
                availability = 100.0 - res["error_rate_pct"]
                victim_breaker = \
                    victim.servant.breakers["pull"].snapshot()
                # every anomaly trace must be a complete tree, and the
                # drill's signature anomaly must be drillable end to end:
                # a re-route hop (kill) / both hedge attempts (slow)
                anomalies = [c.to_dict() for c in tracer.anomaly_traces()]
                trees_ok = bool(anomalies) and all(
                    tree_complete(t, require=("attempt", "request"))
                    for t in anomalies)
                if drill == "kill_replica":
                    sig = [t for t in anomalies
                           if "reroute" in t["anomalies"]
                           and tree_complete(t, require=(
                               "attempt", "reroute", "request"))]
                else:
                    sig = [t for t in anomalies
                           if "hedge" in t["anomalies"]
                           and sum(1 for s in t["spans"]
                                   if s["name"] == "attempt") >= 2
                           and tree_complete(t, require=(
                               "attempt", "request"))]
                trace_ok = trees_ok and bool(sig)
                trace_path = os.path.join(
                    workdir, f"fleet-{drill}-traces.json")
                try:
                    tracer.export_chrome(trace_path)
                except OSError:
                    trace_path = None
                results[drill] = {
                    "anomaly_traces": len(anomalies),
                    "trace_trees_complete": trace_ok,
                    "trace_id": sig[0]["trace_id"] if sig else None,
                    "trace_export": trace_path,
                    "availability_pct": round(availability, 3),
                    "floor_pct": float(floor_pct),
                    "p99_ms": res["p99_ms"],
                    "requests": res["requests"],
                    "errors": res["error_types"],
                    "reroutes": int(reg.counter("fleet.reroute").value),
                    "hedged": int(reg.counter("serve.hedged").value),
                    "hedge_won": int(reg.counter("serve.hedge_won").value),
                    "victim": victim.id,
                    "victim_breaker_trips": victim_breaker["trips"],
                    "recovered": availability >= floor_pct and trace_ok,
                }
        return results
    finally:
        if own_tmp is not None:
            own_tmp.cleanup()


def _prewarm_healthy(fleet: Fleet, capacity: int, exclude: str) -> None:
    ids = np.arange(BATCH, dtype=np.int32) % capacity
    for rep in fleet.replicas():
        if rep.id != exclude:
            rep.servant.pull(ids)
