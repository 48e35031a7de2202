"""Run the canned chaos drill matrix; exit nonzero on any unrecovered fault —
the JAX package's ``tools/chaos_drill.py``, over the port, with its return
codes.

The drills (``swiftsnails_tpu_torch/resilience/drill.py``) inject every fault the
resilience stack claims to survive — NaN/Inf gradient bursts, a poisoned
parameter row, a transient data-stream I/O error, checkpoint bit rot, a
simulated preemption, and tiered-master bit rot over both f32 and int8
(quantized) host masters, where the flip may land in a code plane or a
scale sideband — and assert the run *recovers*: guardrail rollback with
zero non-finite values reaching the master tables, retry instead of crash,
manifest-verified walk-back, digest-detected quarantine-and-heal, and a
resumed run whose final loss matches an undisturbed one.

    python -m swiftsnails_tpu_torch.tools.chaos_drill            # the full matrix
    python -m swiftsnails_tpu_torch.tools.chaos_drill --fast     # the fast subset
    python -m swiftsnails_tpu_torch.tools.chaos_drill --json     # machine-readable results
    python -m swiftsnails_tpu_torch.tools.chaos_drill --serve    # the serving availability matrix
    python -m swiftsnails_tpu_torch.tools.chaos_drill --cluster  # the membership drill matrix
    python -m swiftsnails_tpu_torch.tools.chaos_drill --fleet    # the replica-fleet drill matrix
    python -m swiftsnails_tpu_torch.tools.chaos_drill --freshness  # the delta-pipeline drill matrix
    python -m swiftsnails_tpu_torch.tools.chaos_drill --drift    # the training-plane drift drill
    python -m swiftsnails_tpu_torch.tools.chaos_drill --net      # the TCP transport drill matrix

Each runs on the card unless ``--device cpu`` asks for the CPU (where every
kernel wrapper runs its plain version); without a card and without
``--device cpu`` it fails.

``--serve`` runs the CPU-valid availability drill instead (the bench
``chaos-serve`` lane): a seeded fault matrix against a live Servant with
circuit breakers + degraded stale-LRU reads must hold the availability
floor while the unprotected control leg hard-fails, a corrupt checkpoint
must be rejected by the shadow-verify reload, and the tiered bit-flip
drill must detect + rebuild with loss parity. Exit is nonzero on a missed
floor or any failed drill.

``--fleet`` runs the CPU-valid replica-fleet drill matrix instead: one
replica of a 2-replica :class:`Fleet` gets sick mid-storm — killed with
``serve_io_error`` dispatch faults (its breakers trip and the router walks
around it) or slowed with ``serve_slow`` stalls (tail hedges rescue the
stragglers) — and the fleet must hold the availability floor through
breaker-aware re-routing + hedging. Each drill also runs with the request
tracer in anomaly-keep mode and asserts a *complete trace tree* for the
signature anomaly (re-routed requests must show attempt→reroute→attempt
under one root; hedged requests both racing attempts) — a recovery whose
causality can't be reconstructed counts as unrecovered. Exit is nonzero
on a missed floor or a broken trace tree.

``--freshness`` runs the CPU-valid delta-pipeline drill matrix instead: a
live 2-replica fleet subscribed to a hot-row delta log loses its publisher
mid-stream (a new incarnation takes over), reads a bit-flipped delta batch
(CRC), and hits a deleted segment (sequence gap) — each drill must fall
back to a full checkpoint reload, resubscribe past the fault, and end with
every replica on one shared version and parity 0.0 against the reference
planes — plus a complete ``delta_fallback`` anomaly trace
(detect→reload→resubscribe timeline) proving the recovery is
reconstructable by trace id. Exit is nonzero on any unrecovered drill.

``--drift`` runs the training-plane drift drill instead (the bench
``drift`` lane): a control run and a ``slow_step@A-B`` chaos run share one
ledger; the run's own drift sentinel must confirm the injected slow-step
within the window, emit exactly one transition-edged ``drift`` ledger
event, leave a complete incident bundle (blackbox + timeseries window +
config/env fingerprint + kept traces), and the before/after ``--diff``
attribution must name host-blocked as the dominant contributor — plus the
continuous profiler's own overhead vs words/sec must clear the 3% gate
(or the off leg's measured noise floor). Exit is nonzero on any miss.

``--net`` runs the CPU-valid TCP transport drill matrix instead: the three
transport chaos kinds (``proc_kill`` / ``net_partition`` / ``net_slow``,
scheduled through the chaos-spec syntax) fired against REAL spawned
``replica_server`` processes behind a :class:`NetFleet`. A SIGKILL'd
replica must be declared lost by lease expiry, drained from the ring, and
replaced by a respawn that rejoins with a fresh incarnation and serves; a
black-holed replica must miss the partition-window epoch and, on heal,
REFUSE the stale write typed (``StaleEpoch``) before resyncing; injected
server-side slowness must surface as a bounded typed client deadline —
never a hang — and clear on heal. Exit is nonzero on any unrecovered
fault.

``--cluster`` runs the CPU-valid membership drill matrix instead (the bench
``chaos-cluster`` lane, one fault kind per drill): a simulated virtual-clock
fleet under worker kill, straggler, and partition faults — plus the composed
storm — must keep the exactly-once batch-accounting ledger *exact* (zero
lost, zero double-applied), detect every loss and reassign its range, flag
the straggler, and hold loss parity with an undisturbed control. Exit is
nonzero on any lost/duplicated batch or missed recovery.

Every injection and every recovery event lands in the drill's own ledger
(``<workdir>/<drill>/LEDGER.jsonl``); inspect one with
``python -m swiftsnails_tpu_torch ledger-report --failures <ledger>``.
"""

import argparse
import json


def _serve_matrix(args) -> int:
    from swiftsnails_tpu_torch.serving.chaos_lane import chaos_serve_bench

    res = chaos_serve_bench(small=True, workdir=args.workdir, device=args.device)
    tier = res.get("tier_bitflip") or {}
    checks = {
        "availability_floor": res["availability_pct"] >= res["floor_pct"],
        "unprotected_hard_failure": bool(res["unprotected_hard_failure"]),
        "reload_corrupt_rejected": bool(res["reload_corrupt_rejected"]),
        "tier_bitflip_recovered": bool(tier.get("recovered", True)),
    }
    failed = [k for k, ok in checks.items() if not ok]
    if args.json:
        print(json.dumps({"chaos_serve": res, "checks": checks,
                          "failed": failed}))
    else:
        print(f"availability        {res['availability_pct']:.1f}% "
              f"(floor {res['floor_pct']:.1f}%, "
              f"degraded share {res['degraded_share_pct']:.1f}%)")
        print(f"p99 under fault     {res['p99_under_fault_ms']} ms "
              f"(trip {res['trip_ms']} ms, recover {res['recover_ms']} ms)")
        print(f"control leg         {res['control_availability_pct']:.1f}% "
              f"hard_failure={res['unprotected_hard_failure']} "
              f"({res['control_first_error']})")
        print(f"reload_corrupt      rejected={res['reload_corrupt_rejected']}")
        if tier:
            print(f"tier_bitflip        recovered={tier.get('recovered')} "
                  f"parity={tier.get('loss_parity')}")
        for name, ok in checks.items():
            print(f"{name:<26}  {'PASS' if ok else 'FAIL'}")
        print("serve matrix "
              + ("PASSED" if not failed else f"FAILED: {', '.join(failed)}"))
    return 1 if failed else 0


def _fleet_matrix(args) -> int:
    from swiftsnails_tpu_torch.serving.fleet_lane import fleet_chaos_drill

    results = fleet_chaos_drill(small=True, workdir=args.workdir, device=args.device)
    failed = [k for k, v in results.items() if not v.get("recovered")]
    if args.json:
        print(json.dumps({"results": results, "failed": failed}))
    else:
        width = max(len(k) for k in results)
        for name, res in results.items():
            status = "RECOVERED" if res.get("recovered") else "UNRECOVERED"
            detail = (
                f"availability={res['availability_pct']:.1f}% "
                f"(floor {res['floor_pct']:.1f}%) "
                f"p99={res['p99_ms']}ms "
                f"reroutes={res['reroutes']} "
                f"hedged={res['hedged']} hedge_won={res['hedge_won']} "
                f"victim={res['victim']} "
                f"breaker_trips={res['victim_breaker_trips']} "
                f"anomaly_traces={res.get('anomaly_traces')} "
                f"trees_complete={res.get('trace_trees_complete')}"
            )
            print(f"{name:<{width}}  {status:<11}  {detail}")
            if res.get("trace_id"):
                print(f"{'':<{width}}  {'':<11}  "
                      f"drill trace: {res['trace_id']} "
                      f"({res.get('trace_export')})")
        print(
            f"{len(results) - len(failed)}/{len(results)} drills recovered"
            + (f"; FAILED: {', '.join(failed)}" if failed else "")
        )
    return 1 if failed else 0


def _freshness_matrix(args) -> int:
    from swiftsnails_tpu_torch.freshness.bench_lane import freshness_chaos_drill

    out = freshness_chaos_drill(small=True, workdir=args.workdir, device=args.device)
    results = {k: v for k, v in out.items() if isinstance(v, dict)}
    failed = [k for k, v in results.items() if not v.get("recovered")]
    if args.json:
        print(json.dumps({"results": results, "failed": failed}))
    else:
        width = max(len(k) for k in results)
        for name, res in results.items():
            status = "RECOVERED" if res.get("recovered") else "UNRECOVERED"
            detail = (
                f"fallbacks={res['fallbacks']} "
                f"parity={res['parity']} "
                f"applied_seq={res['applied_seq']} "
                f"fallback_traces={res.get('fallback_traces')}"
            )
            print(f"{name:<{width}}  {status:<11}  {detail}")
            if res.get("trace_id"):
                print(f"{'':<{width}}  {'':<11}  "
                      f"fallback trace: {res['trace_id']}")
        print(
            f"{len(results) - len(failed)}/{len(results)} drills recovered"
            + (f"; FAILED: {', '.join(failed)}" if failed else "")
        )
    return 1 if failed else 0


def _drift_matrix(args) -> int:
    from swiftsnails_tpu_torch.telemetry.drift_lane import drift_bench

    res = drift_bench(workdir=args.workdir, small=True, device=args.device)
    d, po = res["drift"], res["profile_overhead"]
    checks = {
        "detected_in_window": bool(d["detected"]),
        "single_drift_event": d["drift_events"] == 1,
        "bundle_complete": bool(d["bundle_complete"]),
        "attribution_host_blocked": (
            (d.get("attribution") or {}).get("dominant") == "host_blocked"),
        "profiler_overhead_ok": (
            isinstance(po.get("overhead_pct"), (int, float))
            and po["overhead_pct"] <= max(po["overhead_ceil_pct"],
                                          po.get("noise_pct") or 0.0)),
    }
    failed = [k for k, ok in checks.items() if not ok]
    if args.json:
        print(json.dumps({"drift": d, "profile_overhead": po,
                          "checks": checks, "failed": failed}))
    else:
        attr = d.get("attribution") or {}
        print(f"slow_step injected  steps {d['inject_step']}-"
              f"{d['inject_last']} (+{d['slow_step_ms']:.0f} ms), "
              f"sentinel confirmed at step {d['detect_step']}")
        print(f"drift events        {d['drift_events']} "
              f"(signals: {', '.join(d['signals']) or '-'})")
        print(f"incident bundle     {d['bundle']} "
              f"complete={d['bundle_complete']}")
        print(f"--diff attribution  dominant={attr.get('dominant')} "
              f"({attr.get('dominant_delta_s', 0) * 1e3:+.1f} ms/step, "
              f"share {100 * (attr.get('dominant_share') or 0):.0f}%)")
        print(f"profiler overhead   {po.get('overhead_pct')}% of words/sec "
              f"(ceiling {po['overhead_ceil_pct']}%, noise "
              f"{po.get('noise_pct')}%, cadence {po['cadence']})")
        for name, ok in checks.items():
            print(f"{name:<26}  {'PASS' if ok else 'FAIL'}")
        print("drift drill "
              + ("PASSED" if not failed else f"FAILED: {', '.join(failed)}"))
    return 1 if failed else 0


def _net_matrix(args) -> int:
    from swiftsnails_tpu_torch.net.bench_lane import net_chaos_drill

    out = net_chaos_drill(small=True, workdir=args.workdir, device=args.device)
    results = {k: v for k, v in out.items() if isinstance(v, dict)}
    failed = [k for k, v in results.items() if not v.get("recovered")]
    if args.json:
        print(json.dumps({"results": results, "failed": failed}))
    else:
        width = max(len(k) for k in results)
        for name, res in results.items():
            status = "RECOVERED" if res.get("recovered") else "UNRECOVERED"
            detail = ", ".join(
                f"{k}={v}" for k, v in res.items()
                if k != "recovered" and not isinstance(v, dict))
            print(f"{name:<{width}}  {status:<11}  {detail}")
        print(
            f"{len(results) - len(failed)}/{len(results)} drills recovered"
            + (f"; FAILED: {', '.join(failed)}" if failed else "")
        )
    return 1 if failed else 0


def _cluster_matrix(args) -> int:
    from swiftsnails_tpu_torch.cluster import chaos_lane

    results = chaos_lane.run_cluster_drills(workdir=args.workdir, small=True,
                                            device=args.device)
    failed = [k for k, v in results.items() if not v.get("recovered")]
    if args.json:
        print(json.dumps({"results": results, "failed": failed}))
    else:
        width = max(len(k) for k in results)
        for name, res in results.items():
            status = "RECOVERED" if res.get("recovered") else "UNRECOVERED"
            bad = [c for c, ok in res["checks"].items() if not ok]
            detail = (
                f"lost={res['lost']} dup={res['duplicated']} "
                f"dup_discarded={res['dup_discarded']} "
                f"stale_rejected={res['stale_rejected']} "
                f"reassigned={res['reassignments']} "
                f"stragglers={res['stragglers_flagged']} "
                f"parity={res['loss_parity']}"
            ) + (f"  FAILED-CHECKS: {', '.join(bad)}" if bad else "")
            print(f"{name:<{width}}  {status:<11}  {detail}")
        print(
            f"{len(results) - len(failed)}/{len(results)} drills recovered"
            + (f"; FAILED: {', '.join(failed)}" if failed else "")
        )
    return 1 if failed else 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="chaos_drill",
        description="deterministic fault-injection drill matrix",
    )
    p.add_argument("--device", default=None,
                   help="cpu to run on the CPU (default: the card)")
    p.add_argument("--fast", action="store_true",
                   help="run the tier-1 fast subset only")
    p.add_argument("--json", action="store_true",
                   help="emit one JSON object instead of the table")
    p.add_argument("--workdir", default=None,
                   help="keep drill artifacts (ledgers, checkpoints) here")
    p.add_argument("--serve", action="store_true",
                   help="run the serving availability matrix instead "
                        "(breakers + degraded reads vs the fault schedule; "
                        "nonzero exit on a missed availability floor)")
    p.add_argument("--cluster", action="store_true",
                   help="run the cluster membership drill matrix instead "
                        "(kill/straggle/partition vs the supervisor; nonzero "
                        "exit on lost/duplicated batches or missed recovery)")
    p.add_argument("--fleet", action="store_true",
                   help="run the replica-fleet drill matrix instead (kill/"
                        "slow one replica mid-storm; the fleet must hold the "
                        "availability floor via re-route + hedging)")
    p.add_argument("--drift", action="store_true",
                   help="run the training-plane drift drill instead "
                        "(slow_step injection vs the online sentinel: "
                        "detection + one drift event + complete incident "
                        "bundle + host-blocked --diff attribution + the "
                        "profiler-overhead gate)")
    p.add_argument("--freshness", action="store_true",
                   help="run the delta-pipeline drill matrix instead "
                        "(publisher kill / corrupt delta / forced gap vs a "
                        "subscribed fleet; each must fall back to a full "
                        "checkpoint reload and converge to parity 0.0)")
    p.add_argument("--net", action="store_true",
                   help="run the TCP transport drill matrix instead "
                        "(proc_kill / net_partition / net_slow against real "
                        "spawned replica processes: lease-expiry respawn + "
                        "rejoin, stale-write refusal on heal, bounded typed "
                        "timeouts; nonzero exit on any unrecovered fault)")
    args = p.parse_args(argv)

    if args.serve:
        return _serve_matrix(args)
    if args.cluster:
        return _cluster_matrix(args)
    if args.fleet:
        return _fleet_matrix(args)
    if args.drift:
        return _drift_matrix(args)
    if args.freshness:
        return _freshness_matrix(args)
    if args.net:
        return _net_matrix(args)

    from swiftsnails_tpu_torch.resilience.drill import run_drill_matrix

    results = run_drill_matrix(fast=args.fast, workdir=args.workdir, device=args.device)
    failed = [k for k, v in results.items() if not v.get("recovered")]
    if args.json:
        print(json.dumps({"results": results, "failed": failed}))
    else:
        width = max(len(k) for k in results)
        for name, res in results.items():
            status = "RECOVERED" if res.get("recovered") else "UNRECOVERED"
            detail = res.get("error") or ", ".join(
                f"{k}={v}" for k, v in res.items()
                if k not in ("recovered", "error") and not isinstance(v, dict)
            )
            print(f"{name:<{width}}  {status:<11}  {detail}")
        print(
            f"{len(results) - len(failed)}/{len(results)} drills recovered"
            + (f"; FAILED: {', '.join(failed)}" if failed else "")
        )
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
