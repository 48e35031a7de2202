"""The one-screen ops dashboard: what an operator checks before paging.

The JAX package's ``telemetry/ops.py``, over the port's ledger, goodput
and time-series modules. The port writes no fleet, freshness or net bench
block yet (``ROADMAP.md``): the offline view renders them as absent.

Two renderers over the same layout, one per vantage point:

* :func:`render_ops` — a **live** serving surface (a
  :class:`~swiftsnails_tpu_torch.serving.engine.Servant` or
  :class:`~swiftsnails_tpu_torch.serving.fleet.Fleet` ``stats()``/``health()``
  snapshot): per-replica traffic split, p50/p99, cache hit rate, breaker
  and degraded state — plus, for a TCP ``NetFleet``, each replica's
  transport state (connected / reconnecting / drained) — the SLO
  tracker's burn rates and error budget, the
  freshness watermark/lag, and the most recent anomaly traces (each line
  names a ``trace_id`` the request tracer can still produce in full). The
  serve REPL's ``ops`` op prints this.
* :func:`render_ops_from_ledger` — the **offline** view reconstructed
  from a run ledger: the newest fleet bench block's per-replica numbers
  and tracing-overhead leg, the newest freshness and net lanes, and the
  recent ``slo_burn`` / ``trace_anomaly`` / ``freshness_gap`` event tail.
  ``python -m swiftsnails_tpu_torch ops`` prints
  this.

Both stay within one terminal screen on a healthy system — the point is
that *nothing to see here* fits at a glance, and anything worth drilling
names the trace_id / kernel / replica to drill into.
"""

from __future__ import annotations

import sys
from typing import Any, Dict, List, Optional

__all__ = ["render_ops", "render_ops_from_ledger", "main"]


def _fmt(v: Any, nd: int = 2) -> str:
    if isinstance(v, bool):
        return "yes" if v else "no"
    if isinstance(v, float):
        return f"{v:.{nd}f}"
    return str(v) if v is not None else "-"


def _replica_rows(per_replica: Dict[str, Dict]) -> List[str]:
    # a NetFleet's rows carry the TCP client state per replica
    # (connected / reconnecting / drained) — show the column only then,
    # so in-process fleets keep their narrow table
    net = any(isinstance(rs, dict) and "transport" in rs
              for rs in per_replica.values())
    lines = [
        "  replica  state    requests  p50_ms   p99_ms   hit     "
        + ("transport     " if net else "") + "breakers"
    ]
    for rid, rs in sorted(per_replica.items()):
        # live fleet.stats() nests latencies under kernels.pull; the bench
        # ledger block flattens them — accept either
        kern = rs.get("kernels", {}).get("pull", rs)
        breakers = rs.get("breakers")
        if isinstance(breakers, dict):
            open_b = [k for k, s in breakers.items() if s != "closed"]
            btxt = ",".join(f"{k}:{breakers[k]}" for k in open_b) or "closed"
        else:
            btxt = "-"
        hit = rs.get("cache_hit_rate")
        qps = rs.get("qps")
        ttxt = f"{str(rs.get('transport', '-')):<13} " if net else ""
        lines.append(
            f"  {rid:<8} {str(rs.get('state', '-')):<8} "
            f"{_fmt(qps, 1) + '/s' if qps is not None else _fmt(rs.get('requests')):<9} "
            f"{_fmt(kern.get('p50_ms')):<8} {_fmt(kern.get('p99_ms')):<8} "
            f"{_fmt(hit, 3):<7} {ttxt}{btxt}"
        )
    return lines


def _slo_rows(slo: Dict[str, Dict]) -> List[str]:
    lines = ["  kernel  slo_ms  avail    burn(s/l)    budget  alerting"]
    for kernel, s in sorted(slo.items()):
        lines.append(
            f"  {kernel:<7} {_fmt(s.get('slo_latency_ms'), 1):<7} "
            f"{_fmt(s.get('slo_availability'), 4):<8} "
            f"{_fmt(s.get('burn_short'))}/{_fmt(s.get('burn_long')):<7} "
            f"{_fmt(s.get('budget_remaining_pct'), 1):>5}%  "
            f"{'ALERTING' if s.get('alerting') else 'ok'}"
        )
    return lines


def _anomaly_rows(anomalies: List[Dict]) -> List[str]:
    lines = []
    for t in anomalies:
        kinds = ",".join(t.get("anomalies") or [])
        lines.append(
            f"  {t.get('trace_id')}  {str(t.get('kernel', '?')):<14} "
            f"{_fmt(t.get('dur_ms')):>8}ms  {kinds}"
        )
    return lines


def render_ops(
    stats: Dict,
    *,
    health: Optional[Dict] = None,
    anomalies: Optional[List[Dict]] = None,
) -> str:
    """Live dashboard from a ``stats()`` snapshot (Fleet or Servant shape),
    optionally a ``health()`` snapshot and recent anomaly trace dicts."""
    lines: List[str] = []
    per_replica = stats.get("replicas")
    fleet_mode = isinstance(per_replica, dict)
    status = (health or {}).get("status", "?")
    if fleet_mode:
        head = (
            f"fleet: status={status} replicas={len(per_replica)} "
            f"reroutes={stats.get('reroutes', 0)} "
            f"spills={stats.get('spills', 0)}"
        )
        hedge = stats.get("hedge")
        if isinstance(hedge, dict):
            head += (f" hedged={hedge.get('hedged', 0)}"
                     f" ({_fmt(hedge.get('rate_pct'), 1)}%"
                     f" of {_fmt(hedge.get('budget_pct'), 0)}% budget)")
        lines.append(head)
        lines.extend(_replica_rows(per_replica))
    else:
        kern = stats.get("kernels", {}).get("pull", {})
        cache = stats.get("cache", {})
        lines.append(
            f"servant: status={status} "
            f"requests={stats.get('requests', kern.get('count', '-'))} "
            f"p99={_fmt(kern.get('p99_ms'))}ms "
            f"hit={_fmt(cache.get('hit_rate'), 3)} "
            f"degraded={stats.get('degraded_served', 0)} "
            f"shed={stats.get('shed', 0)}"
        )
    slo = stats.get("slo")
    if isinstance(slo, dict) and slo:
        lines.append("slo:")
        lines.extend(_slo_rows(slo))
        # the should_scale() advisory, derived from the same snapshot rows:
        # any kernel alerting or out of error budget wants capacity
        wanting = sorted(
            k for k, s in slo.items()
            if s.get("alerting")
            or (s.get("budget_remaining_pct") is not None
                and s["budget_remaining_pct"] <= 0.0)
        )
        if wanting:
            lines.append(
                f"SCALE-UP? yes — {', '.join(wanting)} alerting or out of "
                "error budget (advisory; scale_hint ledgered on the edge)"
            )
    else:
        lines.append("slo: (not configured — set slo_latency_ms)")
    fresh = (health or {}).get("freshness")
    if isinstance(fresh, dict):
        lines.append(
            f"freshness: applied_seq={fresh.get('applied_seq')} "
            f"step={fresh.get('applied_step')} "
            f"lag={_fmt(fresh.get('last_lag_ms'))}ms "
            f"(p99 {_fmt(fresh.get('lag_p99_ms'))}ms) "
            f"fallbacks={fresh.get('fallbacks')} "
            f"stale={_fmt(fresh.get('stale'))}"
        )
    else:
        lines.append("freshness: (not subscribed)")
    trace = stats.get("trace")
    if isinstance(trace, dict):
        lines.append(
            f"traces: started={trace.get('started')} "
            f"kept={trace.get('kept')} "
            f"anomalies={trace.get('anomalies')} "
            f"ring={trace.get('ring')} "
            f"sample_rate={trace.get('sample_rate')}"
        )
        if anomalies:
            lines.append("recent anomaly traces (drill with trace-summary):")
            lines.extend(_anomaly_rows(anomalies[-5:]))
    else:
        lines.append("traces: (tracing off — set trace_sample_rate "
                     "or trace_anomaly_keep)")
    return "\n".join(lines)


# -- the ledger-backed offline view -------------------------------------------


def render_ops_from_ledger(ledger) -> str:
    """Offline dashboard reconstructed from a run ledger (see module doc)."""
    lines = [f"ops report: {ledger.path}"]
    benches = [r for r in ledger.records("bench")
               if isinstance(r.get("payload"), dict)]
    fleet_recs = [r for r in benches
                  if isinstance(r["payload"].get("fleet"), dict)]
    if fleet_recs:
        rec = fleet_recs[-1]
        fb = rec["payload"]["fleet"]
        inner = fb.get("fleet") if isinstance(fb.get("fleet"), dict) else {}
        lines.append(
            f"fleet lane ({rec.get('ts', '?')}): "
            f"max_qps={fb.get('qps')} p99={fb.get('p99_ms')}ms "
            f"scaling={fb.get('scaling_x')}x "
            f"(floor {fb.get('scaling_floor')}x)"
        )
        per_replica = inner.get("per_replica")
        if isinstance(per_replica, dict) and per_replica:
            lines.extend(_replica_rows(per_replica))
        to = fb.get("trace_overhead")
        if isinstance(to, dict):
            lines.append(
                f"  trace overhead: qps {_fmt(to.get('overhead_qps_pct'))}% "
                f"p99 {_fmt(to.get('overhead_p99_pct'))}% "
                f"(ceiling {_fmt(to.get('overhead_ceil_pct'), 0)}%, "
                f"sample rate {to.get('sample_rate')})"
            )
    else:
        lines.append("fleet lane: (no fleet bench record)")
    fresh_recs = [r for r in benches
                  if isinstance(r["payload"].get("freshness"), dict)]
    if fresh_recs:
        fr = fresh_recs[-1]["payload"]["freshness"]
        gap = fr.get("gap_drill") or {}
        lines.append(
            f"freshness lane: lag_p99={fr.get('lag_p99_ms')}ms "
            f"(ceiling {fr.get('lag_ceiling_ms')}ms) "
            f"parity={fr.get('bit_parity')} "
            f"gap_recovered={gap.get('recovered')}"
        )
    else:
        lines.append("freshness lane: (no freshness bench record)")
    net_recs = [r for r in benches
                if isinstance(r["payload"].get("net"), dict)]
    if net_recs:
        nb = net_recs[-1]["payload"]["net"]
        pk = nb.get("proc_kill") or {}
        dl = nb.get("delta") or {}
        lines.append(
            f"net lane: availability={nb.get('availability_pct')}% "
            f"(floor {nb.get('availability_floor_pct')}%) "
            f"tcp_p99={nb.get('p99_tcp_ms')}ms "
            f"({_fmt(nb.get('envelope_x'))}x in-process, "
            f"limit {_fmt(nb.get('envelope_limit_x'), 0)}x) "
            f"respawns={nb.get('respawns')} "
            f"kill_recovered={_fmt(pk.get('recovered'))} "
            f"delta_parity={dl.get('parity')}"
        )
        transports = ledger.records("transport")
        if transports:
            lines.append(
                f"  transport events: {len(transports)} "
                f"(newest {transports[-1].get('ts', '?')} "
                f"{transports[-1].get('event')}; "
                "drill with ledger-report --failures)"
            )
    else:
        lines.append("net lane: (no net bench record)")
    burns = ledger.records("slo_burn")
    if burns:
        newest = burns[-1]
        lines.append(
            f"error budget: {_fmt(newest.get('budget_remaining_pct'), 1)}% "
            f"left on {newest.get('kernel')} "
            f"({len(burns)} slo_burn events, newest {newest.get('ts', '?')})"
        )
        for r in burns[-3:]:
            lines.append(
                f"  {r.get('ts', '?')}  {r.get('source')}/{r.get('kernel')} "
                f"burn={r.get('burn_short')}/{r.get('burn_long')} "
                f"budget_left={r.get('budget_remaining_pct')}%"
            )
    else:
        lines.append("error budget: (no slo_burn events)")
    anomalies = ledger.records("trace_anomaly")
    if anomalies:
        lines.append(f"anomaly traces ({len(anomalies)} ledgered, "
                     "newest last; drill with trace-summary):")
        for r in anomalies[-5:]:
            kinds = r.get("anomalies")
            lines.append(
                f"  {r.get('ts', '?')}  {r.get('trace_id')}  "
                f"{str(r.get('kernel', '?')):<14} "
                f"{_fmt(r.get('dur_ms'))}ms  "
                f"{','.join(kinds) if isinstance(kinds, list) else kinds}"
            )
    else:
        lines.append("anomaly traces: (none ledgered)")
    gaps = ledger.records("freshness_gap")
    if gaps:
        newest = gaps[-1]
        lines.append(
            f"freshness gaps: {len(gaps)} events, newest "
            f"{newest.get('ts', '?')} reason={newest.get('reason')} "
            f"phase={newest.get('phase', 'publish')}"
        )
    lines.extend(_training_rows(ledger))
    return "\n".join(lines)


# canonical sparkline set for the training section (whatever subset the
# run's timeseries summary actually carries is drawn)
_TRAINING_SPARKS = (
    "step_ms", "loss", "win_host_blocked_frac", "win_compute_frac",
    "prefetch_stall_ms", "tier_hit_rate", "tier_flush_queue_depth",
)


def _training_rows(ledger) -> List[str]:
    """The training-plane section: the newest run record's goodput
    decomposition + continuous-profiling sparklines, the drift sentinel
    state, and the recent ``drift`` / ``scale_hint`` event tail."""
    lines: List[str] = []
    runs = ledger.records("run")
    if not runs:
        lines.append("training: (no run records)")
    else:
        run = runs[-1]
        gp = run.get("goodput") if isinstance(run.get("goodput"), dict) else {}
        head = (f"training ({run.get('ts', '?')}): model={run.get('model')} "
                f"steps={run.get('steps')}")
        from swiftsnails_tpu_torch.telemetry.goodput import _record_rate

        rate = _record_rate(run)  # wall-based, same rate `--diff` headlines
        if isinstance(rate, (int, float)):
            head += f" items/s={rate:,.0f}"
        lines.append(head)
        dec = gp.get("decomposition")
        if isinstance(dec, dict) and dec.get("wall_s"):
            lines.append(
                "  step time: "
                f"compute {_fmt(100 * dec.get('compute_frac', 0), 1)}% | "
                f"h2d {_fmt(100 * dec.get('h2d_frac', 0), 1)}% | "
                f"host-blocked {_fmt(100 * dec.get('host_blocked_frac', 0), 1)}% | "
                f"other {_fmt(100 * dec.get('other_frac', 0), 1)}% | "
                f"unaccounted {_fmt(100 * dec.get('unaccounted_frac', 0), 1)}%"
            )
        ts_block = run.get("timeseries")
        if isinstance(ts_block, dict) and ts_block.get("series"):
            from swiftsnails_tpu_torch.telemetry.timeseries import render_sparklines

            names = [n for n in _TRAINING_SPARKS if n in ts_block["series"]]
            lines.append(
                f"  profile window: {ts_block.get('window')} samples, steps "
                f"{ts_block.get('first_step')}..{ts_block.get('last_step')}"
            )
            lines.extend(render_sparklines(ts_block, names=names,
                                           indent="    "))
        drift = run.get("drift")
        if isinstance(drift, dict):
            tripped = drift.get("tripped") or []
            lines.append(
                f"  drift sentinel: "
                f"{'DRIFTED on ' + ', '.join(tripped) if drift.get('drifted') else 'ok'}"
                f" ({drift.get('events', 0)} event(s))"
            )
        incidents = run.get("incidents")
        if isinstance(incidents, list) and incidents:
            lines.append(f"  incident bundles: {len(incidents)}, newest "
                         f"{incidents[-1]}")
    drifts = ledger.records("drift")
    if drifts:
        lines.append(f"drift events: {len(drifts)}, newest last:")
        for r in drifts[-3:]:
            sigs = r.get("signals")
            lines.append(
                f"  {r.get('ts', '?')}  step={r.get('step')}  "
                f"{','.join(sigs) if isinstance(sigs, list) else sigs}"
            )
    else:
        lines.append("drift events: (none ledgered)")
    hints = ledger.records("scale_hint")
    if hints:
        newest = hints[-1]
        kerns = newest.get("kernels")
        lines.append(
            f"scale hints: {len(hints)} events, newest {newest.get('ts', '?')} "
            f"({','.join(kerns) if isinstance(kerns, list) else kerns})"
        )
    return lines


def main(argv: Optional[List[str]] = None) -> int:
    """``python -m swiftsnails_tpu_torch ops [LEDGER.jsonl]``."""
    import os

    from swiftsnails_tpu_torch.telemetry.ledger import DEFAULT_LEDGER, Ledger

    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in ("-h", "--help"):
        print("usage: ops [LEDGER.jsonl]   # one-screen fleet dashboard "
              "from a run ledger")
        return 0
    path = argv[0] if argv else os.environ.get("SSN_LEDGER_PATH",
                                               DEFAULT_LEDGER)
    ledger = Ledger(path)
    if not os.path.exists(ledger.path):
        print(f"ops: no ledger at {ledger.path}", file=sys.stderr)
        return 1
    print(render_ops_from_ledger(ledger))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
