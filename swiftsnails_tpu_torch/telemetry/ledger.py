"""Durable run ledger: append-only, atomically-written JSONL run records —
the run-side half of the JAX package's ``telemetry/ledger.py``.

Every training run, checkpoint commit, outage, chaos injection, rejected
checkpoint and black-box dump appends one self-describing record. The
records keep the JAX schema (:data:`SCHEMA_VERSION`, the record kinds and
their key names), so a ledger written by either package renders the same
in both.

Durability contract: every append rewrites the file via write-tmp + fsync +
rename (+ directory fsync), so the ledger on disk is *always* a complete,
parseable JSONL file — a crash mid-append leaves the previous version, never
a torn line; a torn tail left by another writer is healed on the next
append. Appends are rare (one per run/outage/save), so the O(file) rewrite is
irrelevant; single-writer per path is assumed.

Record envelope::

    {"schema": 1, "kind": "run"|"outage"|"blackbox"|"chaos"|"checkpoint"
                          |"cache_error"|"retry_exhausted"|"drift"|...,
     "ts": "<UTC ISO8601>", "env": {...fingerprint...}, ...kind fields...}

``python -m swiftsnails_tpu_torch ledger-report`` renders the ledger
(:func:`main`): the report, ``--failures`` (the failure timeline),
``--diff A B`` (regression attribution between two run records) and
``--check-regression PCT`` (the bench gate plus the training plane's
correctness gates: chaos recovery, the drift drill, the continuous
profiler's and the tracer's own cost; the serve lane's pull qps and p99;
the fleet lane's SLO, scaling, affinity, hedging and qps; the tiered lane's
parity, round trip, int8 masters and words/sec; the chaos-serve lane's
availability floor, control and drills; the chaos-cluster lane's
exactly-once accounting, reassignment and loss parity; the freshness
lane's bit parity, gap drill, lag and serve p99; and the net lane's
availability, stale-write refusal, parities and TCP envelope).

Not ported yet (``ROADMAP.md``): the regression checks of the scaling,
placement, quantized-wire and zero planes (the multi-device planes), and
the bench-cache helpers
(``validate_bench_payload``, ``load_bench_cache``, ``derive_last_good``,
hence ``--baseline-file``); each comes with the plane or the port bench
that writes its records.
"""

from __future__ import annotations

import functools
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

SCHEMA_VERSION = 1

# default ledger location: the repository root, overridable per call (config
# `ledger_path`)
DEFAULT_LEDGER = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "RUN_LEDGER.jsonl",
)


def _utc_now() -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())


# ------------------------------------------------------- env fingerprint ---


def _git_sha(cwd: Optional[str] = None) -> Optional[str]:
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"],
            cwd=cwd or os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=5,
        )
        sha = out.stdout.strip()
        return sha if out.returncode == 0 and sha else None
    except (OSError, subprocess.SubprocessError):
        return None


def nvidia_smi_line() -> Optional[str]:
    """The first card's ``name, power.limit`` as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints it, or None
    where the tool is missing, fails or takes over 10 s (best effort)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=10,
        )
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def env_fingerprint(include_devices: bool = False) -> Dict:
    """Environment identity of a run: git sha, python, host, the torch and
    CUDA versions — and with ``include_devices`` the devices:
    ``{"platform": "gpu", "count", "kind": torch.cuda.get_device_name(0),
    "process_count": 1, "nvidia_smi", "power_limit"}`` on a card (the last
    two from ``nvidia-smi``, best effort), ``{"platform": "cpu", "count": 1,
    "kind": "cpu", "process_count": 1}`` without one."""
    fp: Dict = {
        "git_sha": _git_sha(),
        "python": sys.version.split()[0],
        "host": os.uname().nodename if hasattr(os, "uname") else None,
    }
    try:
        import torch

        fp["torch"] = torch.__version__
        fp["cuda"] = torch.version.cuda
        if include_devices:
            if torch.cuda.is_available():
                devices = {"platform": "gpu", "count": torch.cuda.device_count(),
                           "kind": torch.cuda.get_device_name(0), "process_count": 1}
                smi = nvidia_smi_line()
                devices["nvidia_smi"] = smi
                devices["power_limit"] = (
                    smi.rsplit(",", 1)[-1].strip() if smi and "," in smi else None)
            else:
                devices = {"platform": "cpu", "count": 1, "kind": "cpu",
                           "process_count": 1}
            fp["devices"] = devices
    except Exception as e:  # a broken torch must not kill record-keeping
        fp["torch_error"] = f"{type(e).__name__}: {e}"
    return fp


def config_hash(conf: Dict) -> str:
    """Stable short hash of a flat config mapping (order-independent)."""
    blob = json.dumps(
        {str(k): str(v) for k, v in conf.items()}, sort_keys=True
    ).encode("utf-8")
    return hashlib.sha256(blob).hexdigest()[:16]


# ---------------------------------------------------------- atomic write ---

def atomic_write_bytes(path: str, data: bytes) -> None:
    """Write ``data`` to ``path`` via tmp + fsync + rename (+ dir fsync):
    readers only ever see the old or the new complete file."""
    path = os.path.abspath(path)
    d = os.path.dirname(path)
    fd, tmp = tempfile.mkstemp(prefix=os.path.basename(path) + ".", dir=d)
    try:
        try:
            os.write(fd, data)
            os.fsync(fd)
        finally:
            os.close(fd)
        os.rename(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    try:  # persist the rename itself
        dfd = os.open(d, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:
        pass  # e.g. directories that reject O_RDONLY open; data is renamed


def atomic_write_json(path: str, obj) -> None:
    atomic_write_bytes(path, (json.dumps(obj) + "\n").encode("utf-8"))


# ----------------------------------------------------------------- ledger ---


class Ledger:
    """Append-only JSONL run ledger with atomic rewrites.

    ``append`` returns the full record written (envelope included) so call
    sites can echo/forward it. All read paths tolerate a corrupt line
    (reported, never raised) — a half-written legacy file or a foreign line
    must not take down the bench.
    """

    def __init__(self, path: str = DEFAULT_LEDGER):
        self.path = os.path.abspath(path)
        # the checkpoint writer thread appends beside the training thread
        self._lock = threading.Lock()

    # -- write -------------------------------------------------------------

    def append(self, kind: str, record: Dict, env: Optional[Dict] = None) -> Dict:
        full = {"schema": SCHEMA_VERSION, "kind": kind, "ts": _utc_now()}
        if env is not None:
            full["env"] = env
        full.update(record)
        line = json.dumps(full) + "\n"
        with self._lock:
            try:
                with open(self.path, "rb") as f:
                    existing = f.read()
                if existing and not existing.endswith(b"\n"):
                    existing += b"\n"  # heal a torn legacy tail
            except OSError:
                existing = b""
            atomic_write_bytes(self.path, existing + line.encode("utf-8"))
        return full

    # -- read --------------------------------------------------------------

    def replay(self) -> Tuple[List[Dict], List[str]]:
        """All parseable records plus a list of corrupt-line descriptions."""
        records: List[Dict] = []
        bad: List[str] = []
        try:
            with open(self.path, "r", encoding="utf-8") as f:
                lines = f.readlines()
        except OSError:
            return records, bad
        for lineno, line in enumerate(lines, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                bad.append(f"{self.path}:{lineno}: unparseable line skipped")
                continue
            if isinstance(rec, dict):
                records.append(rec)
            else:
                bad.append(f"{self.path}:{lineno}: non-object record skipped")
        return records, bad

    def records(self, kind: Optional[str] = None) -> List[Dict]:
        recs, _ = self.replay()
        if kind is None:
            return recs
        return [r for r in recs if r.get("kind") == kind]

    def latest(self, kind: str) -> Optional[Dict]:
        recs = self.records(kind)
        return recs[-1] if recs else None



def outage_summary(ledger: Ledger) -> Optional[Dict]:
    """Structured summary of the most recent outage: the line that used to be
    hand-written into ``docs/OUTAGE_*.txt``."""
    outages = ledger.records("outage")
    if not outages:
        return None
    last = outages[-1]
    return {
        "at": last.get("ts"),
        "probe_duration_s": last.get("probe_duration_s"),
        "rc": last.get("rc"),
        "error": last.get("error"),
        "outages_recorded": len(outages),
    }


# -------------------------------------------------------------- reporting ---


def _fmt_num(v) -> str:
    if isinstance(v, float):
        return f"{v:,.3f}" if abs(v) < 10 else f"{v:,.1f}"
    return str(v)


def render_report(ledger: Ledger) -> str:
    """Terminal rendering of the ledger: run/bench/outage/black-box history."""
    records, bad = ledger.replay()
    if not records and not bad:
        return f"{ledger.path}: empty or missing ledger"
    lines = [f"ledger: {ledger.path}  ({len(records)} records)"]
    counts: Dict[str, int] = {}
    for r in records:
        counts[r.get("kind", "?")] = counts.get(r.get("kind", "?"), 0) + 1
    lines.append(
        "  " + "  ".join(f"{k}={n}" for k, n in sorted(counts.items()))
    )
    for warn in bad:
        lines.append(f"  WARNING: {warn}")

    bench = ledger.records("bench")
    if bench:
        lines.append("")
        lines.append("bench records (newest last):")
        for r in bench[-5:]:
            p = r.get("payload", {}) if isinstance(r.get("payload"), dict) else {}
            env = r.get("env", {}) or {}
            flags = []
            if r.get("cacheable"):
                flags.append("cacheable")
            if p.get("cached"):
                flags.append("cached")
            if p.get("reconstructed"):
                flags.append("reconstructed")
            lines.append(
                f"  {r.get('ts', '?')}  value={_fmt_num(p.get('value', 0))} "
                f"{p.get('unit', '')}  path={p.get('path')}  "
                f"platform={p.get('platform')}  git={str(env.get('git_sha'))[:9]}"
                f"  config_hash={r.get('config_hash', '?')}"
                + (f"  [{','.join(flags)}]" if flags else "")
            )

    runs = ledger.records("run")
    if runs:
        lines.append("")
        lines.append("training runs (newest last):")
        for r in runs[-5:]:
            g = r.get("goodput", {}) or {}
            mfu = g.get("mfu")
            dec = g.get("decomposition", {}) or {}
            # active quantization knobs, when the run recorded them: the
            # wire format and (for tiered runs) the host-master storage dtype
            dtypes = ""
            if r.get("comm_dtype"):
                dtypes += f"  wire={r['comm_dtype']}"
            t = r.get("tiered")
            if isinstance(t, dict) and t.get("master_dtype"):
                dtypes += f"  tier_master={t['master_dtype']}"
            lines.append(
                f"  {r.get('ts', '?')}  model={r.get('model')}  "
                f"steps={r.get('steps')}  items={r.get('items')}  "
                f"config_hash={r.get('config_hash', '?')}  "
                f"mfu={'%.3g' % mfu if isinstance(mfu, (int, float)) else 'n/a'}"
                + dtypes
            )
            if dec:
                lines.append(
                    "    step-time: "
                    + "  ".join(
                        f"{k}={dec[k] * 100:.1f}%"
                        for k in ("compute_frac", "h2d_frac",
                                  "host_blocked_frac", "other_frac")
                        if isinstance(dec.get(k), (int, float))
                    )
                )
            # continuous-profiling sparklines, when the run carried a
            # timeseries summary (profile_cadence > 0)
            ts_block = r.get("timeseries")
            if isinstance(ts_block, dict) and ts_block.get("series"):
                from swiftsnails_tpu_torch.telemetry.timeseries import (
                    render_sparklines,
                )

                names = [n for n in ("step_ms", "loss",
                                     "win_host_blocked_frac",
                                     "win_compute_frac", "prefetch_stall_ms",
                                     "tier_hit_rate")
                         if n in ts_block["series"]]
                lines.append(
                    f"    profile: {ts_block.get('window')} samples, steps "
                    f"{ts_block.get('first_step')}.."
                    f"{ts_block.get('last_step')}"
                )
                lines.extend(render_sparklines(ts_block, names=names,
                                               indent="      "))
            drift = r.get("drift")
            if isinstance(drift, dict) and (drift.get("drifted")
                                            or drift.get("events")):
                tripped = drift.get("tripped") or []
                lines.append(
                    f"    drift: {drift.get('events', 0)} event(s) on "
                    + (", ".join(tripped) if tripped else "-")
                )

    # tiered parameter store: run records carry a `tiered` summary when
    # table_tier: host was on; bench records carry the `tiered` lane block
    tiered_rows = []
    for r in runs:
        t = r.get("tiered")
        if isinstance(t, dict):
            tiered_rows.append((r.get("ts", "?"), "run  ", t))
    for r in ledger.records("bench"):
        p = r.get("payload") if isinstance(r.get("payload"), dict) else {}
        t = (p or {}).get("tiered")
        if isinstance(t, dict):
            tiered_rows.append((r.get("ts", "?"), "bench", t))
    if tiered_rows:
        lines.append("")
        lines.append("tiered parameter store (newest last):")
        for ts, kind, t in tiered_rows[-5:]:
            cache = t.get("cache") if isinstance(t.get("cache"), dict) else t
            lines.append(
                f"  {ts}  {kind}  hit_rate={cache.get('hit_rate')}  "
                f"faulted_rows={cache.get('faulted_rows')}  "
                f"evictions={cache.get('evictions')}  "
                f"h2d={_fmt_num(cache.get('h2d_bytes', 0))}B  "
                f"d2h={_fmt_num(cache.get('d2h_bytes', 0))}B"
            )
            if kind == "bench":
                lines.append(
                    f"    lane: {_fmt_num(t.get('words_per_sec', 0))} words/s "
                    f"({t.get('tiered_over_resident')}x resident)  "
                    f"parity={t.get('parity_bit_identical')}  "
                    f"over_budget_round_trip={t.get('round_trip_ok')}"
                )
                q = t.get("quantized")
                if isinstance(q, dict):
                    lines.append(
                        f"    quantized[{q.get('master_dtype')}]: "
                        f"capacity={q.get('capacity_ratio_vs_f32')}x f32  "
                        f"rel_err={q.get('master_rel_err_vs_f32')}  "
                        f"digests_clean={q.get('digests_clean')}  "
                        f"serve_requant_exact={q.get('serve_requant_exact')}  "
                        f"ok={q.get('ok')}"
                    )
            elif t.get("master_dtype"):
                lines.append(f"    master_dtype={t['master_dtype']}")
            bd = t.get("breakdown")
            if isinstance(bd, dict) and any(
                    bd.get(k) for k in ("plan_ns", "fault_ns", "flush_ns",
                                        "remap_ns", "h2d_ns")):
                lines.append(
                    "    step-time: "
                    + "  ".join(
                        f"{k[:-3]}={bd[k] / 1e6:.1f}ms"
                        for k in ("plan_ns", "fault_ns", "flush_ns",
                                  "remap_ns", "h2d_ns", "flush_wait_ns")
                        if isinstance(bd.get(k), (int, float)) and bd[k]
                    )
                    + (f"  flush_q={bd.get('flush_queue_depth', 0)}"
                       if "flush_queue_depth" in bd else "")
                )

    # serving fleet: bench records carry the `fleet` lane block (replica
    # pool QPS at the p99 SLO, per-replica split, hedge + affinity legs)
    fleet_rows = []
    for r in ledger.records("bench"):
        p = r.get("payload") if isinstance(r.get("payload"), dict) else {}
        fb = (p or {}).get("fleet")
        if isinstance(fb, dict):
            fleet_rows.append((r.get("ts", "?"), fb))
    if fleet_rows:
        lines.append("")
        lines.append("serving fleet (newest last):")
        for ts, fb in fleet_rows[-5:]:
            single = fb.get("single") or {}
            lines.append(
                f"  {ts}  fleet={_fmt_num(fb.get('qps', 0))} qps "
                f"(single={_fmt_num(single.get('max_qps', 0))}, "
                f"scaling={fb.get('scaling_x')}x, "
                f"floor {fb.get('scaling_floor')}x)  "
                f"p99={fb.get('p99_ms')}ms @ SLO {fb.get('slo_p99_ms')}ms  "
                f"replicas={fb.get('replicas')}"
            )
            per = fb.get("fleet", {}).get("per_replica") \
                if isinstance(fb.get("fleet"), dict) else None
            if isinstance(per, dict):
                for rid, row in sorted(per.items()):
                    lines.append(
                        f"    {rid}: {_fmt_num(row.get('qps', 0))} qps  "
                        f"p99={row.get('p99_ms')}ms  "
                        f"requests={row.get('requests')}  "
                        f"cache_hit_rate={row.get('cache_hit_rate')}"
                    )
            aff = fb.get("affinity")
            if isinstance(aff, dict):
                lines.append(
                    f"    affinity: hit_rate={aff.get('affinity_hit_rate')} "
                    f"vs random={aff.get('random_hit_rate')} "
                    f"@ {_fmt_num(aff.get('offered_qps', 0))} qps"
                )
            hg = fb.get("hedge")
            if isinstance(hg, dict):
                lines.append(
                    f"    hedge: p99={hg.get('p99_ms')}ms vs "
                    f"no-hedge={hg.get('nohedge_p99_ms')}ms  "
                    f"rate={hg.get('hedge_rate_pct')}% "
                    f"(budget {hg.get('budget_pct')}%)  "
                    f"won={hg.get('hedge_won')}/{hg.get('hedged')}"
                )

    # hybrid placement: run records carry a `placement` decision when the
    # mode was hybrid/auto (including auto runs that resolved back to
    # uniform, with the reason); bench records carry the skewed scaling
    # leg's uniform-vs-hybrid exchange comparison
    placement_rows = []
    for r in runs:
        pl = r.get("placement")
        if isinstance(pl, dict):
            if r.get("comm_dtype"):
                pl = {**pl, "comm_dtype": r["comm_dtype"]}
            placement_rows.append((r.get("ts", "?"), "run  ", pl, None))
    for r in ledger.records("bench"):
        p = r.get("payload") if isinstance(r.get("payload"), dict) else {}
        scal = (p or {}).get("scaling")
        sk = scal.get("skewed") if isinstance(scal, dict) else None
        if isinstance(sk, dict):
            placement_rows.append(
                (r.get("ts", "?"), "bench", sk.get("decision") or {}, sk))
    if placement_rows:
        lines.append("")
        lines.append("hybrid placement (newest last):")
        for ts, kind, pl, sk in placement_rows[-5:]:
            cov = pl.get("coverage")
            lines.append(
                f"  {ts}  {kind}  mode={pl.get('mode', 'hybrid')}  "
                f"cut={pl.get('cut')}  "
                f"replicated_rows={pl.get('replicated_rows', pl.get('cut'))}  "
                f"coverage="
                + (f"{cov:.3f}" if isinstance(cov, (int, float)) else "n/a")
                + (f"  wire={pl['comm_dtype']}" if pl.get("comm_dtype")
                   else "")
            )
            if pl.get("reason"):
                lines.append(f"    reason: {pl['reason']}")
            pred = pl.get("predicted_exchange_bytes")
            meas = pl.get("measured_exchange_bytes")
            if pred is not None or meas is not None:
                lines.append(
                    f"    exchange bytes: predicted={_fmt_num(pred or 0)}B  "
                    f"uniform={_fmt_num(pl.get('predicted_uniform_bytes', 0))}B"
                    f"  measured={_fmt_num(meas or 0)}B"
                )
            if sk is not None and isinstance(sk.get("per_dtype"), dict):
                for dt, row in sorted(sk["per_dtype"].items()):
                    red = row.get("exchange_reduction")
                    lines.append(
                        f"    skewed[{dt}]: "
                        f"uniform={_fmt_num(row.get('uniform_exchange_bytes', 0))}B  "
                        f"hybrid={_fmt_num(row.get('hybrid_exchange_bytes', 0))}B  "
                        "reduction="
                        + (f"{red:.2f}x" if isinstance(red, (int, float))
                           else "n/a")
                        + f"  loss_delta={row.get('loss_delta')}"
                    )

    # sharded optimizer state: bench records carrying the zero lane's HBM
    # census + grad-reduce exchange + parity block
    zero_rows = [
        (r.get("ts", "?"), r["payload"]["zero"])
        for r in ledger.records("bench")
        if isinstance(r.get("payload"), dict)
        and isinstance(r["payload"].get("zero"), dict)
        and not r["payload"]["zero"].get("skipped")
    ]
    if zero_rows:
        lines.append("")
        lines.append("sharded optimizer state (zero; newest last):")
        for ts, z in zero_rows[-5:]:
            hbm = z.get("hbm") or {}
            gr = z.get("grad_reduce") or {}
            red = hbm.get("reduction")
            lines.append(
                f"  {ts}  devices={z.get('n_devices')} "
                f"(data={(z.get('mesh') or {}).get('data')})  "
                f"hbm/replica={_fmt_num(hbm.get('replicated_bytes', 0))}B"
                f"->{_fmt_num(hbm.get('sharded_bytes_per_replica', 0))}B  "
                "reduction="
                + (f"{red:.2f}x" if isinstance(red, (int, float)) else "n/a")
            )
            lines.append(
                f"    grad reduce: psum={_fmt_num(gr.get('baseline_bytes', 0))}B"
                f"  zero={_fmt_num(gr.get('zero_bytes', 0))}B  "
                f"loss_parity={z.get('loss_parity_f32')}  "
                f"ckpt_identical={z.get('checkpoint_identical')}"
            )
            ov = z.get("overlap")
            if isinstance(ov, dict):
                split = ov.get("step_split_est") or {}
                lines.append(
                    f"    overlap2: {_fmt_num(ov.get('aggregate_words_per_sec', 0))} words/s "
                    f"({ov.get('speedup_vs_sequential')}x vs sequential)  "
                    f"collective_frac={split.get('collective_frac')}"
                )

    outages = ledger.records("outage")
    if outages:
        lines.append("")
        lines.append(f"outages ({len(outages)} recorded, newest last):")
        for r in outages[-5:]:
            lines.append(
                f"  {r.get('ts', '?')}  probe={_fmt_num(r.get('probe_duration_s', 0))}s"
                f"  rc={r.get('rc')}  {r.get('error', '')[:90]}"
            )

    boxes = ledger.records("blackbox")
    if boxes:
        lines.append("")
        lines.append("black-box dumps (newest last):")
        for r in boxes[-5:]:
            lines.append(
                f"  {r.get('ts', '?')}  reason={r.get('reason')}  "
                f"steps={r.get('first_step')}..{r.get('last_step')}  "
                f"file={r.get('dump_path')}"
            )
    return "\n".join(lines)


# failure-timeline view: every kind that marks something going wrong (or a
# chaos drill making it go wrong on purpose), interleaved with run records
# for context — `ledger-report --failures`
FAILURE_KINDS = ("outage", "chaos", "blackbox", "cache_error", "overload",
                 "retry_exhausted", "breaker", "degraded", "membership",
                 "hedge", "drain", "freshness_gap", "slo_burn",
                 "trace_anomaly", "drift", "scale_hint", "transport")


def _failure_line(r: Dict) -> str:
    kind = r.get("kind", "?")
    ts = r.get("ts", "?")
    if kind == "outage":
        what = r.get("error") or r.get("reason") or ""
        probe = r.get("probe")
        extra = f" probe={probe}" if probe else ""
        step = r.get("step")
        extra += f" step={step}" if step is not None else ""
        return f"  {ts}  OUTAGE   {extra.strip()}  {str(what)[:90]}"
    if kind == "chaos":
        return (
            f"  {ts}  CHAOS    fault={r.get('fault')} step={r.get('step')}"
            f" seed={r.get('seed')}"
            + (f"  {r.get('detail')}" if r.get("detail") else "")
        )
    if kind == "blackbox":
        return (
            f"  {ts}  BLACKBOX reason={r.get('reason')} "
            f"steps={r.get('first_step')}..{r.get('last_step')}  "
            f"{r.get('dump_path')}"
        )
    if kind == "cache_error":
        return (
            f"  {ts}  CKPT/CACHE-ERROR source={r.get('source', 'bench-cache')}"
            f"  {str(r.get('error', ''))[:90]}"
        )
    if kind == "overload":
        return (
            f"  {ts}  OVERLOAD kernel={r.get('kernel')} "
            f"shed_total={r.get('shed_total')} "
            f"queue_depth={r.get('queue_depth')}"
        )
    if kind == "retry_exhausted":
        return (
            f"  {ts}  RETRY-EXHAUSTED op={r.get('op')} "
            f"attempts={r.get('attempts')} "
            f"elapsed={_fmt_num(r.get('elapsed_ms', 0))}ms "
            f"reason={r.get('reason')}  {str(r.get('error', ''))[:70]}"
        )
    if kind == "breaker":
        snap = ""
        if r.get("to") == "closed" and r.get("last_recovery_latency_ms"):
            snap = f"  recovered_in={r['last_recovery_latency_ms']}ms"
        return (
            f"  {ts}  BREAKER  kernel={r.get('kernel')} "
            f"{r.get('from')}->{r.get('to')} "
            f"trips={r.get('trips')}{snap}"
        )
    if kind == "degraded":
        return (
            f"  {ts}  DEGRADED kernel={r.get('kernel')} "
            f"reason={r.get('reason')} rows={r.get('rows')} "
            f"total={r.get('degraded_total')}"
        )
    if kind == "hedge":
        # the fleet router's rate-limited tail-hedge stream (first + every
        # 100th, like the engine's overload/degraded streams)
        return (
            f"  {ts}  HEDGE    kernel={r.get('kernel')} "
            f"{r.get('primary')}->{r.get('hedge')} "
            f"budget={_fmt_num(r.get('budget_ms', 0))}ms "
            f"total={r.get('hedged_total')} "
            f"rate={r.get('hedge_rate_pct')}%"
        )
    if kind == "drain":
        if r.get("phase") == "complete":
            return (
                f"  {ts}  DRAIN    {r.get('replica')} complete "
                f"waited={_fmt_num(r.get('waited_ms', 0))}ms "
                f"clean={r.get('clean')} "
                f"remaining={r.get('remaining_replicas')}"
            )
        return (
            f"  {ts}  DRAIN    {r.get('replica')} start "
            f"inflight={r.get('inflight')} "
            f"remaining={r.get('remaining_replicas')}"
        )
    if kind == "freshness_gap":
        # delta-subscriber breakpoints (freshness/subscriber.py): phase
        # "detect" is the gap/crc/restart trigger; phase "fallback" is the
        # full-reload recovery that follows it
        if r.get("phase") == "fallback":
            return (
                f"  {ts}  FRESHNESS-FALLBACK reason={r.get('reason')} "
                f"recovered={r.get('recovered')} "
                f"version={r.get('version')} "
                f"reseq={r.get('resubscribed_seq')} "
                f"floor_step={r.get('floor_step')}"
            )
        return (
            f"  {ts}  DELTA-GAP  source={r.get('source')} "
            f"reason={r.get('reason')} "
            f"next_seq={r.get('next_seq')} "
            f"applied_seq={r.get('applied_seq')} "
            f"fallbacks={r.get('fallbacks')}"
            + (f"  {str(r.get('error', ''))[:70]}" if r.get("error") else "")
        )
    if kind == "slo_burn":
        # the SLO tracker's transition-edged burn alerts (telemetry/slo.py):
        # one line when a kernel ENTERS the alerting state, not per request
        return (
            f"  {ts}  SLO-BURN kernel={r.get('kernel')} "
            f"source={r.get('source')} "
            f"burn={r.get('burn_short')}/{r.get('burn_long')} "
            f"(alert>={r.get('alert_burn')}) "
            f"budget_left={r.get('budget_remaining_pct')}% "
            f"slo={r.get('slo_latency_ms')}ms@{r.get('slo_availability')}"
        )
    if kind == "trace_anomaly":
        # the request tracer's rate-limited anomaly stream (first + every
        # 100th kept anomaly trace) — each line names a drillable trace_id
        kinds = r.get("anomalies")
        return (
            f"  {ts}  TRACE-ANOMALY kernel={r.get('kernel')} "
            f"trace={r.get('trace_id')} "
            f"kinds={','.join(kinds) if isinstance(kinds, list) else kinds} "
            f"dur={_fmt_num(r.get('dur_ms', 0))}ms "
            f"total={r.get('anomalies_total')}"
        )
    if kind == "drift":
        # the drift sentinel's transition-edged confirmations (telemetry/
        # drift.py): one line per incident, naming every tripped signal
        sigs = r.get("signals")
        return (
            f"  {ts}  DRIFT    step={r.get('step')} "
            f"signals={','.join(sigs) if isinstance(sigs, list) else sigs} "
            f"model={r.get('model', '?')}"
        )
    if kind == "scale_hint":
        # the SLO tracker's should_scale() advisory edge (telemetry/slo.py)
        kerns = r.get("kernels")
        return (
            f"  {ts}  SCALE-HINT source={r.get('source')} "
            f"kernels={','.join(kerns) if isinstance(kerns, list) else kerns}"
        )
    if kind == "transport":
        # the TCP layer's connection timeline (net/rpc.py clients, the
        # delta stream source, and the replica manager's drain/respawn) —
        # interleaves with membership/breaker lines so one read shows a
        # replica die, get declared lost, drained, and rejoin
        event = r.get("event", "?")
        who = r.get("replica") or r.get("peer", "?")
        if event == "conn_lost":
            return (f"  {ts}  CONN-LOST    {who}  peer={r.get('peer')}  "
                    f"{str(r.get('error', ''))[:70]}")
        if event == "reconnect":
            return (f"  {ts}  RECONNECT    {who}  peer={r.get('peer')}  "
                    f"reconnects={r.get('reconnects')}")
        if event == "drained":
            return (f"  {ts}  DRAINED      {r.get('replica')}  "
                    f"pid={r.get('pid')}")
        if event == "respawn":
            return (f"  {ts}  RESPAWN      {r.get('replica')} -> "
                    f"{r.get('replacement')}  "
                    f"incarnation={r.get('incarnation')}  "
                    f"pid={r.get('pid')}")
        if event == "proc_kill":
            return (f"  {ts}  PROC-KILL    {who}  pid={r.get('pid')}")
        if event == "partition":
            return (f"  {ts}  PARTITION    {who}  "
                    f"duration={_fmt_num(r.get('duration_ms', 0))}ms")
        extra = f"  source={r.get('source')}" if r.get("source") else ""
        return f"  {ts}  TRANSPORT    {event} {who}{extra}"
    if kind == "membership":
        # the cluster supervisor's lifecycle timeline (cluster/supervisor.py)
        action = r.get("action", "?")
        w = r.get("worker")
        if action == "worker-lost":
            return (f"  {ts}  WORKER-LOST  {w}  {r.get('reason', '')}"
                    f"  steps={r.get('steps')}")
        if action == "reassigned":
            return (f"  {ts}  REASSIGNED   {w} -> {r.get('to')}  "
                    f"ranges={r.get('ranges')}")
        if action == "straggler":
            return (f"  {ts}  STRAGGLER    {w}  "
                    f"ewma={r.get('ewma_ms')}ms vs median="
                    f"{r.get('median_ms')}ms  share->{r.get('share')}")
        if action == "straggler-clear":
            return (f"  {ts}  STRAGGLER    {w}  cleared "
                    f"(ewma={r.get('ewma_ms')}ms)")
        if action == "backup":
            return (f"  {ts}  BACKUP       {w} duplicates "
                    f"{r.get('of')} ranges={r.get('ranges')}")
        if action == "restore":
            return (f"  {ts}  MEMBERSHIP   restore frontier="
                    f"{r.get('frontier')} pool={r.get('pool')}")
        return f"  {ts}  MEMBERSHIP   {action} {w}"
    return f"  {ts}  {kind}"


def render_failures(ledger: Ledger) -> str:
    """Timeline of failure / chaos / black-box events next to run records —
    the drill-audit view: what was injected, what broke, what recovered."""
    records, bad = ledger.replay()
    lines = [f"failure timeline: {ledger.path}"]
    for warn in bad:
        lines.append(f"  WARNING: {warn}")
    shown = 0
    for r in records:
        kind = r.get("kind")
        if kind in FAILURE_KINDS:
            lines.append(_failure_line(r))
            shown += 1
        elif kind == "run":
            g = r.get("guardrail") or {}
            extra = ""
            if g.get("trips_total"):
                extra = (f"  guard: {g['trips_total']} trips, "
                         f"{g['steps_skipped']} skipped")
            if r.get("preempted"):
                extra += "  [preempted]"
            lines.append(
                f"  {r.get('ts', '?')}  run      model={r.get('model')} "
                f"steps={r.get('steps')}{extra}"
            )
        elif kind == "bench" and isinstance(r.get("payload"), dict) \
                and isinstance(r["payload"].get("chaos"), dict):
            c = r["payload"]["chaos"]
            lines.append(
                f"  {r.get('ts', '?')}  bench    chaos lane: "
                f"recovered_all={c.get('recovered_all')} "
                f"guard_overhead={c.get('guard_overhead_pct')}% "
                f"loss_parity={c.get('loss_parity')}"
            )
        elif kind == "bench" and isinstance(r.get("payload"), dict) \
                and isinstance(r["payload"].get("chaos_serve"), dict):
            c = r["payload"]["chaos_serve"]
            lines.append(
                f"  {r.get('ts', '?')}  bench    chaos-serve lane: "
                f"availability={c.get('availability_pct')}% "
                f"degraded_share={c.get('degraded_share_pct')}% "
                f"p99_under_fault={c.get('p99_under_fault_ms')}ms"
            )
        elif kind == "bench" and isinstance(r.get("payload"), dict) \
                and isinstance(r["payload"].get("chaos_cluster"), dict):
            c = r["payload"]["chaos_cluster"]
            lines.append(
                f"  {r.get('ts', '?')}  bench    chaos-cluster lane: "
                f"exact={c.get('accounting_exact')} "
                f"lost={c.get('lost_count')} dup={c.get('duplicated_count')} "
                f"reassigned={c.get('reassignments')} "
                f"loss_parity={c.get('loss_parity')}"
            )
        elif kind == "bench" and isinstance(r.get("payload"), dict) \
                and isinstance(r["payload"].get("freshness"), dict):
            c = r["payload"]["freshness"]
            gap = c.get("gap_drill") or {}
            lines.append(
                f"  {r.get('ts', '?')}  bench    freshness lane: "
                f"bit_parity={c.get('bit_parity')} "
                f"lag_p99={c.get('lag_p99_ms')}ms "
                f"serve_p99={c.get('serve_p99_ms')}ms "
                f"gap_recovered={gap.get('recovered')}"
            )
        elif kind == "bench" and isinstance(r.get("payload"), dict) \
                and isinstance(r["payload"].get("net"), dict):
            c = r["payload"]["net"]
            pk = c.get("proc_kill") or {}
            dl = c.get("delta") or {}
            lines.append(
                f"  {r.get('ts', '?')}  bench    net lane: "
                f"availability={c.get('availability_pct')}% "
                f"tcp_parity={c.get('tcp_parity')} "
                f"delta_parity={dl.get('parity')} "
                f"envelope={c.get('envelope_x')}x "
                f"respawns={c.get('respawns')} "
                f"kill_recovered={pk.get('recovered')}"
            )
    if shown == 0:
        lines.append("  (no failure events recorded)")
    return "\n".join(lines)




def check_regression(
    ledger: Ledger,
    max_drop_pct: float,
    baseline: Optional[float] = None,
) -> Tuple[int, str]:
    """Bench gate: newest *measured* bench value vs the pinned baseline.

    ``baseline``: explicit pinned words/sec value; default is the best value
    among all earlier measured (non-cached, non-reconstructed, on-chip —
    CPU smoke runs never count) bench records. Returns ``(exit_code,
    message)`` — nonzero when the newest run is more than ``max_drop_pct``
    percent below the baseline (or nothing to gate on). The planes' gates
    (:func:`_plane_checks`: the training plane's correctness and the serve
    lane's qps and p99 against the same platform's) run in every case, and
    their lines follow the headline's.
    """
    measured = [
        r for r in ledger.records("bench")
        if isinstance(r.get("payload"), dict)
        and not r["payload"].get("cached")
        and not r["payload"].get("reconstructed")
        and r["payload"].get("platform") != "cpu"
        and isinstance(r["payload"].get("value"), (int, float))
        and r["payload"]["value"] > 0
    ]
    if not measured:
        rc, msg = 2, "check-regression: no measured bench record in ledger"
    else:
        newest = measured[-1]["payload"]["value"]
        earlier = [r["payload"]["value"] for r in measured[:-1]]
        if baseline is None and not earlier:
            rc, msg = 0, (
                f"check-regression: single measured record "
                f"(value={newest:,.1f}); nothing to compare against"
            )
        else:
            if baseline is None:
                baseline = max(earlier)
            floor = baseline * (1.0 - max_drop_pct / 100.0)
            if newest < floor:
                rc, msg = 1, (
                    f"REGRESSION: newest value {newest:,.1f} is "
                    f"{(1 - newest / baseline) * 100:.1f}% below baseline "
                    f"{baseline:,.1f} (allowed {max_drop_pct:.1f}%)"
                )
            else:
                rc, msg = 0, (
                    f"ok: newest value {newest:,.1f} vs baseline {baseline:,.1f} "
                    f"({(newest / baseline - 1) * 100:+.1f}%, floor {floor:,.1f})"
                )
    for check in _plane_checks(max_drop_pct):
        c_rc, c_msg = check(ledger)
        if c_msg:
            msg = f"{msg}\n{c_msg}"
        rc = max(rc, c_rc)
    return rc, msg


def _check_chaos_regression(ledger: Ledger) -> Tuple[int, Optional[str]]:
    """Gate the chaos lane's *recovery* alongside the perf headline: the
    newest bench record carrying a ``chaos`` block (any platform — recovery
    is correctness, so CPU lane runs count) must have recovered every drill
    and held resume loss parity. No chaos history gates nothing."""
    with_chaos = [
        r for r in ledger.records("bench")
        if isinstance(r.get("payload"), dict)
        and isinstance(r["payload"].get("chaos"), dict)
    ]
    if not with_chaos:
        return 0, None
    c = with_chaos[-1]["payload"]["chaos"]
    problems = []
    if not c.get("recovered_all"):
        bad = [k for k, v in (c.get("drills") or {}).items()
               if not v.get("recovered")]
        problems.append(
            "unrecovered chaos drill(s): " + (", ".join(bad) or "unknown"))
    parity = c.get("loss_parity")
    if isinstance(parity, (int, float)) and parity > 0.05:
        problems.append(f"resume loss parity {parity:.4f} > 0.05")
    if problems:
        return 1, "chaos REGRESSION: " + "; ".join(problems)
    return 0, (
        f"chaos ok: all drills recovered, guard overhead "
        f"{c.get('guard_overhead_pct')}%, resume loss parity {parity}"
    )



def _check_chaos_serve_regression(ledger: Ledger) -> Tuple[int, Optional[str]]:
    """Gate the chaos-serve lane's *availability* alongside the perf
    headline: the newest bench record carrying a ``chaos_serve`` block (any
    platform — availability under fault is correctness, so CPU lane runs
    count) must hold the lane's availability floor, prove the unprotected
    control actually hard-fails, and reject the corrupt-reload drill. No
    chaos-serve history gates nothing."""
    with_cs = [
        r for r in ledger.records("bench")
        if isinstance(r.get("payload"), dict)
        and isinstance(r["payload"].get("chaos_serve"), dict)
    ]
    if not with_cs:
        return 0, None
    c = with_cs[-1]["payload"]["chaos_serve"]
    avail = c.get("availability_pct")
    floor = c.get("floor_pct", 99.0)
    problems = []
    if not (isinstance(avail, (int, float)) and avail >= floor):
        problems.append(
            f"availability {avail}% under fault is below the "
            f"{floor}% floor")
    if not c.get("unprotected_hard_failure", True):
        problems.append(
            "breakers-off control leg did NOT hard-fail (fault matrix "
            "is not exercising the serve path)")
    if not c.get("reload_corrupt_rejected", True):
        problems.append("corrupt-reload drill was not rejected")
    if c.get("tier_bitflip") is not None and not (
            c["tier_bitflip"] or {}).get("recovered"):
        problems.append("tier_bitflip drill did not recover")
    if problems:
        return 1, "chaos-serve REGRESSION: " + "; ".join(problems)
    return 0, (
        f"chaos-serve ok: availability {avail:.2f}% (floor {floor}%), "
        f"degraded share {c.get('degraded_share_pct')}%, "
        f"p99 under fault {c.get('p99_under_fault_ms')}ms"
    )


def _check_chaos_cluster_regression(
    ledger: Ledger,
) -> Tuple[int, Optional[str]]:
    """Gate the chaos-cluster lane's exactly-once proof alongside the perf
    headline: the newest bench record carrying a ``chaos_cluster`` block
    (any platform — batch accounting is correctness, so CPU lane runs
    count) must show zero lost and zero double-applied batches under the
    kill/slow/partition storm, a detected + reassigned worker loss, loss
    parity within the lane's bar, and an unprotected control leg that
    demonstrably lost its dead worker's range. No chaos-cluster history
    gates nothing."""
    with_cc = [
        r for r in ledger.records("bench")
        if isinstance(r.get("payload"), dict)
        and isinstance(r["payload"].get("chaos_cluster"), dict)
    ]
    if not with_cc:
        return 0, None
    c = with_cc[-1]["payload"]["chaos_cluster"]
    problems = []
    if c.get("lost_count", 0) or not c.get("accounting_exact", False):
        problems.append(
            f"batch accounting is not exact: lost={c.get('lost_count')} "
            f"({c.get('committed')}/{c.get('total_batches')} committed)")
    if c.get("duplicated_count", 0):
        problems.append(
            f"{c.get('duplicated_count')} batches double-applied "
            "(first-writer-wins dedup is broken)")
    if not c.get("workers_lost"):
        problems.append("no worker loss was detected under the storm")
    if not c.get("reassignments"):
        problems.append("the dead worker's range was never reassigned")
    parity = c.get("loss_parity")
    bar = c.get("parity_bar", 0.05)
    if not (isinstance(parity, (int, float)) and parity <= bar):
        problems.append(
            f"loss parity {parity} vs the undisturbed control exceeds "
            f"the {bar} bar")
    if not c.get("unprotected_hard_failure", True):
        problems.append(
            "supervisor-off control leg did NOT lose the dead worker's "
            "range (the storm is not exercising reassignment)")
    if problems:
        return 1, "chaos-cluster REGRESSION: " + "; ".join(problems)
    return 0, (
        f"chaos-cluster ok: {c.get('committed')}/{c.get('total_batches')} "
        f"exactly-once (dup_discarded={c.get('dup_discarded')}, "
        f"stale_rejected={c.get('stale_rejected')}), "
        f"{c.get('reassignments')} reassignments, "
        f"loss parity {parity}"
    )


def _fleet_values(record: Dict) -> Optional[Tuple[float, Optional[float]]]:
    """(fleet qps, p99_ms) from a bench payload's ``fleet`` block, or None
    when the fleet lane didn't run in that record."""
    f = record.get("payload", {}).get("fleet")
    if not isinstance(f, dict):
        return None
    qps = f.get("qps")
    if not (isinstance(qps, (int, float)) and qps > 0):
        return None
    p99 = f.get("p99_ms")
    p99 = float(p99) if isinstance(p99, (int, float)) and p99 > 0 else None
    return float(qps), p99


def _check_fleet_regression(
    ledger: Ledger, max_drop_pct: float
) -> Tuple[int, Optional[str]]:
    """Gate the fleet lane alongside the perf headline. Four checks on the
    newest bench record carrying a ``fleet`` block:

    * p99 at the reported max must be inside the lane's SLO and the
      scaling ratio at/above the lane's floor (1.6x for 2 replicas) — the
      router's whole job, platform-independent, so CPU lane runs gate;
    * affinity routing's aggregate LRU hit rate must beat random spray on
      the same zipf traffic (the warm-cache win the ring exists for);
    * hedging must not make the stalled-replica leg's p99 worse than its
      no-hedge control at equal offered load;
    * fleet qps must hold its floor vs the best earlier record of the
      *same platform* (absolute qps is machine-bound, like the serve gate).

    No fleet history gates nothing."""
    with_fleet = [
        r for r in ledger.records("bench")
        if isinstance(r.get("payload"), dict) and _fleet_values(r)
    ]
    if not with_fleet:
        return 0, None
    newest_rec = with_fleet[-1]
    fb = newest_rec["payload"]["fleet"]
    qps, p99 = _fleet_values(newest_rec)
    problems = []
    slo = fb.get("slo_p99_ms")
    if isinstance(slo, (int, float)) and p99 is not None and p99 > slo:
        problems.append(
            f"p99 {p99:.2f}ms at the reported max exceeds the "
            f"{slo}ms SLO")
    scaling = fb.get("scaling_x")
    floor_x = fb.get("scaling_floor", 1.6)
    if int(fb.get("replicas") or 0) >= 2 and not (
            isinstance(scaling, (int, float)) and scaling >= floor_x):
        problems.append(
            f"scaling {scaling}x for {fb.get('replicas')} replicas is "
            f"below the {floor_x}x floor")
    aff = fb.get("affinity")
    if isinstance(aff, dict):
        a, rnd = aff.get("affinity_hit_rate"), aff.get("random_hit_rate")
        if not (isinstance(a, (int, float)) and isinstance(rnd, (int, float))
                and a > rnd):
            problems.append(
                f"affinity hit rate {a} does not beat random routing {rnd}")
    hg = fb.get("hedge")
    if isinstance(hg, dict):
        hp, cp = hg.get("p99_ms"), hg.get("nohedge_p99_ms")
        if not (isinstance(hp, (int, float)) and isinstance(cp, (int, float))
                and hp <= cp):
            problems.append(
                f"hedged p99 {hp}ms is worse than the no-hedge control "
                f"{cp}ms")
    platform = newest_rec["payload"].get("platform")
    same = [r for r in with_fleet
            if r["payload"].get("platform") == platform]
    earlier = [_fleet_values(r)[0] for r in same[:-1]]
    if earlier:
        base = max(earlier)
        qps_floor = base * (1.0 - max_drop_pct / 100.0)
        if qps < qps_floor:
            problems.append(
                f"fleet qps {qps:,.1f} is {(1 - qps / base) * 100:.1f}% "
                f"below baseline {base:,.1f} (allowed {max_drop_pct:.1f}%)")
    if problems:
        return 1, "fleet REGRESSION: " + "; ".join(problems)
    if not earlier:
        return 0, (
            f"fleet: single {platform or '?'} record ({qps:,.1f} qps, "
            f"scaling {scaling}x, p99 {p99}ms <= SLO {slo}ms); "
            "qps floor has nothing to compare against"
        )
    return 0, (
        f"fleet ok: {qps:,.1f} qps (scaling {scaling}x >= {floor_x}x, "
        f"p99 {p99}ms <= SLO {slo}ms) vs qps baseline {max(earlier):,.1f} "
        f"({platform or '?'})"
    )


def _trace_overhead_values(record: Dict) -> Optional[Dict]:
    """The ``trace_overhead`` block from a bench payload's ``fleet`` block
    (the fleet lane's tracing on-vs-off ride-along), or None when the leg
    didn't run in that record."""
    fb = record.get("payload", {}).get("fleet")
    if not isinstance(fb, dict):
        return None
    to = fb.get("trace_overhead")
    if not isinstance(to, dict):
        return None
    q, p = to.get("overhead_qps_pct"), to.get("overhead_p99_pct")
    if not (isinstance(q, (int, float)) and isinstance(p, (int, float))):
        return None
    return to


def _check_trace_overhead_regression(
    ledger: Ledger,
) -> Tuple[int, Optional[str]]:
    """Gate the observability plane's own cost: in the newest bench record
    carrying the fleet lane's ``trace_overhead`` leg, tracing on (head
    sampling + tail-keep) vs off at equal offered load must cost no more
    than the leg's ceiling (3%) of throughput or p99. The p99 comparison
    carries a noise floor: 1ms, widened to the off leg's own max-min
    spread across its repetitions (``p99_noise_ms``) when the leg ships
    one — a delta inside the baseline's self-disagreement is scheduler
    jitter, not tracing cost. Same-platform comparison is free here (both
    legs run in the same process); no history gates nothing."""
    with_to = [
        r for r in ledger.records("bench")
        if isinstance(r.get("payload"), dict) and _trace_overhead_values(r)
    ]
    if not with_to:
        return 0, None
    to = _trace_overhead_values(with_to[-1])
    ceil = float(to.get("overhead_ceil_pct", 3.0) or 3.0)
    q = float(to["overhead_qps_pct"])
    p99_off = float(to.get("p99_off_ms") or 0.0)
    p99_on = float(to.get("p99_on_ms") or 0.0)
    problems = []
    if q > ceil:
        problems.append(
            f"tracing costs {q:.2f}% of throughput at equal offered load "
            f"(ceiling {ceil}%)")
    noise = float(to.get("p99_noise_ms") or 0.0)
    if (p99_on - p99_off) > max(ceil / 100.0 * p99_off, 1.0, noise):
        problems.append(
            f"tracing p99 {p99_on}ms vs {p99_off}ms off exceeds the "
            f"{ceil}% ceiling (noise floor {max(1.0, noise):.1f}ms)")
    if problems:
        return 1, "trace-overhead REGRESSION: " + "; ".join(problems)
    return 0, (
        f"trace-overhead ok: qps {q:+.2f}%, p99 {p99_off}->{p99_on}ms "
        f"at sample rate {to.get('sample_rate')} (ceiling {ceil}%)"
    )


def _drift_block(record: Dict) -> Optional[Dict]:
    d = record.get("payload", {}).get("drift")
    return d if isinstance(d, dict) else None


def _check_drift_regression(ledger: Ledger) -> Tuple[int, Optional[str]]:
    """Gate the drift drill: the newest bench record carrying a ``drift``
    block (the ``--lane drift`` / ``tools/chaos_drill.py --drift`` leg) must
    show the injected ``slow_step`` chaos *detected* within the configured
    window, exactly one transition-edged ``drift`` ledger event, a complete
    incident bundle (timeseries window + blackbox + fingerprint), and the
    before/after ``--diff`` attribution naming host-blocked as dominant.
    Correctness, not perf — gated on any platform; no history gates
    nothing."""
    with_drift = [
        r for r in ledger.records("bench")
        if isinstance(r.get("payload"), dict) and _drift_block(r)
    ]
    if not with_drift:
        return 0, None
    d = _drift_block(with_drift[-1])
    problems = []
    if not d.get("detected"):
        problems.append(
            "injected slow_step drift was NOT detected within the window")
    ev = d.get("drift_events")
    if ev != 1:
        problems.append(
            f"expected exactly one transition-edged drift event, got {ev}")
    if not d.get("bundle_complete"):
        problems.append(
            "incident bundle incomplete (needs timeseries + blackbox + "
            "fingerprint)")
    dom = (d.get("attribution") or {}).get("dominant")
    if dom != "host_blocked":
        problems.append(
            f"--diff attribution named {dom!r} dominant, expected "
            "host_blocked")
    if problems:
        return 1, "drift REGRESSION: " + "; ".join(problems)
    return 0, (
        f"drift ok: detected at step {d.get('detect_step')} "
        f"(injected at {d.get('inject_step')}), 1 transition-edged event, "
        "bundle complete, --diff dominant=host_blocked"
    )


def _profile_overhead_block(record: Dict) -> Optional[Dict]:
    po = record.get("payload", {}).get("profile_overhead")
    return po if isinstance(po, dict) else None


def _check_profiler_overhead_regression(
    ledger: Ledger,
) -> Tuple[int, Optional[str]]:
    """Gate the continuous profiler's own cost, mirroring the fleet lane's
    trace-overhead leg: in the newest bench record carrying a
    ``profile_overhead`` block, profiling on (sampler + sentinel at the
    drill cadence) vs off at equal work must cost no more than the block's
    ceiling (3%) of words/sec. The comparison carries a noise floor — the
    off leg's own best-vs-worst spread across repetitions (``noise_pct``)
    when the block ships one; a delta inside the baseline's
    self-disagreement is scheduler jitter, not profiler cost. Same-process
    comparison, so same-platform is free; no history gates nothing."""
    with_po = [
        r for r in ledger.records("bench")
        if isinstance(r.get("payload"), dict) and _profile_overhead_block(r)
    ]
    if not with_po:
        return 0, None
    po = _profile_overhead_block(with_po[-1])
    ceil = float(po.get("overhead_ceil_pct", 3.0) or 3.0)
    pct = po.get("overhead_pct")
    if not isinstance(pct, (int, float)):
        return 1, ("profiler-overhead REGRESSION: block carries no "
                   "overhead_pct")
    noise = float(po.get("noise_pct") or 0.0)
    if pct > max(ceil, noise):
        return 1, (
            f"profiler-overhead REGRESSION: continuous profiling costs "
            f"{pct:.2f}% of words/sec (ceiling {ceil}%, noise floor "
            f"{noise:.2f}%)")
    return 0, (
        f"profiler-overhead ok: {pct:+.2f}% of words/sec at cadence "
        f"{po.get('cadence')} (ceiling {ceil}%, noise floor {noise:.2f}%)"
    )



def _serving_values(record: Dict) -> Optional[Tuple[float, Optional[float]]]:
    """(qps, p99_ms) from a bench payload's ``serving`` block, or None when
    the serve lane didn't run in that record."""
    s = record.get("payload", {}).get("serving")
    if not isinstance(s, dict):
        return None
    qps = s.get("qps")
    if not (isinstance(qps, (int, float)) and qps > 0):
        return None
    p99 = s.get("p99_ms")
    p99 = float(p99) if isinstance(p99, (int, float)) and p99 > 0 else None
    return float(qps), p99


def _check_serving_regression(
    ledger: Ledger, max_drop_pct: float
) -> Tuple[int, Optional[str]]:
    """Gate the serve lane's headline (pull qps + p99 latency) alongside the
    training headline: the newest bench record carrying a ``serving`` block
    must hold the qps floor AND the p99 ceiling against the best earlier
    record of the *same platform* (absolute latency is platform-bound, so a
    CPU record never gates a TPU one — but CPU-vs-CPU CI runs do gate).
    No serving history (or a single record) gates nothing."""
    with_serving = [
        r for r in ledger.records("bench")
        if isinstance(r.get("payload"), dict) and _serving_values(r)
    ]
    if not with_serving:
        return 0, None
    newest_rec = with_serving[-1]
    platform = newest_rec["payload"].get("platform")
    same = [r for r in with_serving
            if r["payload"].get("platform") == platform]
    qps, p99 = _serving_values(newest_rec)
    earlier = [_serving_values(r) for r in same[:-1]]
    if not earlier:
        return 0, (
            f"serving: single {platform or '?'} record (pull {qps:,.1f} qps)"
            "; nothing to compare against"
        )
    base_qps = max(q for q, _ in earlier)
    qps_floor = base_qps * (1.0 - max_drop_pct / 100.0)
    problems = []
    if qps < qps_floor:
        problems.append(
            f"pull qps {qps:,.1f} is {(1 - qps / base_qps) * 100:.1f}% below "
            f"baseline {base_qps:,.1f} (allowed {max_drop_pct:.1f}%)"
        )
    earlier_p99 = [p for _, p in earlier if p]
    if p99 is not None and earlier_p99:
        base_p99 = min(earlier_p99)
        p99_ceiling = base_p99 * (1.0 + max_drop_pct / 100.0)
        if p99 > p99_ceiling:
            problems.append(
                f"pull p99 {p99:.2f}ms is {(p99 / base_p99 - 1) * 100:.1f}% "
                f"above baseline {base_p99:.2f}ms "
                f"(allowed {max_drop_pct:.1f}%)"
            )
    if problems:
        return 1, "serving REGRESSION: " + "; ".join(problems)
    return 0, (
        f"serving ok: pull {qps:,.1f} qps / p99 {p99}ms vs "
        f"qps baseline {base_qps:,.1f} ({platform or '?'})"
    )


def _tiered_values(record: Dict) -> Optional[Tuple[float, bool]]:
    """(words_per_sec, parity_ok) from a bench payload's ``tiered`` block, or
    None when the tiered lane didn't run in that record. ``parity_ok``
    collapses the lane's correctness flags: equal-vocab bit-parity AND the
    over-budget train->checkpoint->serve round trip."""
    t = record.get("payload", {}).get("tiered")
    if not isinstance(t, dict):
        return None
    wps = t.get("words_per_sec")
    if not (isinstance(wps, (int, float)) and wps > 0):
        return None
    parity = bool(t.get("parity_bit_identical")) and bool(t.get("round_trip_ok"))
    return float(wps), parity


_TIERED_RESIDENT_FLOOR = 0.95  # equal-vocab leg: tiered words/sec vs resident


def _check_tiered_regression(
    ledger: Ledger, max_drop_pct: float
) -> Tuple[int, Optional[str]]:
    """Gate the tiered lane: the newest bench record carrying a ``tiered``
    block must hold bit-parity + the over-budget round trip (correctness —
    gated on ANY platform, like chaos recovery), keep the equal-vocab leg at
    >= ``_TIERED_RESIDENT_FLOOR`` of resident speed (any platform; older
    records without the ratio are not gated on it), and hold its words/sec
    floor against the best earlier record of the same platform. No tiered
    history gates nothing."""
    with_tiered = [
        r for r in ledger.records("bench")
        if isinstance(r.get("payload"), dict) and _tiered_values(r)
    ]
    if not with_tiered:
        return 0, None
    newest_rec = with_tiered[-1]
    wps, parity = _tiered_values(newest_rec)
    if not parity:
        return 1, (
            "tiered REGRESSION: newest lane record failed bit-parity or the "
            "over-budget round trip (correctness gate)")
    # quantized-master (int8) leg: correctness + capacity, any platform.
    # Older records without the block are not gated on it.
    q = newest_rec["payload"]["tiered"].get("quantized")
    if isinstance(q, dict) and not q.get("ok"):
        bad = [k for k in ("digests_clean", "serve_requant_exact",
                           "checkpoint_dtype_f32") if not q.get(k)]
        cap = q.get("capacity_ratio_vs_f32")
        if not (isinstance(cap, (int, float)) and cap >= 2.0):
            bad.append(f"capacity_ratio_vs_f32={cap} (floor 2.0x)")
        err = q.get("master_rel_err_vs_f32")
        budget = q.get("rel_err_budget", 0.05)
        if not (isinstance(err, (int, float)) and err <= budget):
            bad.append(f"master_rel_err_vs_f32={err} (budget {budget})")
        return 1, (
            "tiered REGRESSION: quantized-master (int8) leg failed: "
            + ", ".join(bad or ["ok flag unset"]))
    ratio = newest_rec["payload"]["tiered"].get("tiered_over_resident")
    if isinstance(ratio, (int, float)) and ratio < _TIERED_RESIDENT_FLOOR:
        return 1, (
            f"tiered REGRESSION: equal-vocab leg ran at {ratio:.4f}x "
            f"resident speed (floor {_TIERED_RESIDENT_FLOOR:.2f}x) — the "
            "tier's hot path is paying per-step cost it shouldn't")
    platform = newest_rec["payload"].get("platform")
    same = [r for r in with_tiered
            if r["payload"].get("platform") == platform]
    earlier = [_tiered_values(r)[0] for r in same[:-1]]
    if not earlier:
        return 0, (
            f"tiered: single {platform or '?'} record ({wps:,.1f} words/s, "
            "parity ok); nothing to compare against"
        )
    base = max(earlier)
    floor = base * (1.0 - max_drop_pct / 100.0)
    if wps < floor:
        return 1, (
            f"tiered REGRESSION: {wps:,.1f} words/s is "
            f"{(1 - wps / base) * 100:.1f}% below baseline {base:,.1f} "
            f"(allowed {max_drop_pct:.1f}%)"
        )
    return 0, (
        f"tiered ok: {wps:,.1f} words/s vs baseline {base:,.1f} "
        f"({(wps / base - 1) * 100:+.1f}%), parity ok ({platform or '?'})"
        + (f", int8 masters {q.get('capacity_ratio_vs_f32')}x capacity"
           if isinstance(q, dict) else "")
    )


def _check_freshness_regression(ledger: Ledger) -> Tuple[int, Optional[str]]:
    """Gate the freshness lane: the newest bench record carrying a
    ``freshness`` block must show bit-identical delta-applied rows vs the
    same-watermark checkpoint (correctness — any platform gates), a
    recovered gap drill, delta lag p99 under the lane's ceiling, and serve
    p99 within the SLO while deltas were applying. No freshness history
    gates nothing."""
    with_fresh = [
        r for r in ledger.records("bench")
        if isinstance(r.get("payload"), dict)
        and isinstance(r["payload"].get("freshness"), dict)
    ]
    if not with_fresh:
        return 0, None
    f = with_fresh[-1]["payload"]["freshness"]
    problems = []
    parity = f.get("bit_parity")
    if not (isinstance(parity, (int, float)) and parity == 0.0):
        problems.append(
            f"delta-applied rows are not bit-identical to the "
            f"same-watermark checkpoint (parity={parity})")
    gap = f.get("gap_drill") or {}
    if not gap.get("recovered"):
        problems.append("gap drill did not recover via full reload")
    gap_parity = gap.get("parity")
    if isinstance(gap_parity, (int, float)) and gap_parity != 0.0:
        problems.append(f"post-fallback parity {gap_parity} != 0.0")
    lag = f.get("lag_p99_ms")
    ceiling = f.get("lag_ceiling_ms")
    if (isinstance(lag, (int, float)) and isinstance(ceiling, (int, float))
            and ceiling > 0 and lag > ceiling):
        problems.append(
            f"freshness lag p99 {lag:.1f}ms above the "
            f"{ceiling:.0f}ms ceiling")
    p99 = f.get("serve_p99_ms")
    slo = f.get("slo_p99_ms")
    if (isinstance(p99, (int, float)) and isinstance(slo, (int, float))
            and slo > 0 and p99 > slo):
        problems.append(
            f"serve p99 {p99:.1f}ms above the {slo:.0f}ms SLO while "
            f"applying deltas")
    if problems:
        return 1, "freshness REGRESSION: " + "; ".join(problems)
    return 0, (
        f"freshness ok: bit parity {parity}, lag p99 "
        f"{_fmt_num(lag)}ms (ceiling {_fmt_num(ceiling)}ms), serve p99 "
        f"{_fmt_num(p99)}ms (SLO {_fmt_num(slo)}ms), gap drill recovered"
    )


def _check_net_regression(ledger: Ledger) -> Tuple[int, Optional[str]]:
    """Gate the net lane: the newest bench record carrying a ``net`` block
    must show availability at/over the floor through a SIGKILL'd replica
    with the lost -> drain -> respawn -> rejoin arc completing, a refused
    stale write on partition heal, bit parity 0.0 for both the TCP read
    path and the post-publisher-kill delta stream (correctness — any
    platform gates), and TCP serving p99 within the recorded envelope of
    the same run's in-process p99 (same platform by construction, so it
    gates anywhere too). No net history gates nothing."""
    with_net = [
        r for r in ledger.records("bench")
        if isinstance(r.get("payload"), dict)
        and isinstance(r["payload"].get("net"), dict)
    ]
    if not with_net:
        return 0, None
    n = with_net[-1]["payload"]["net"]
    problems = []
    avail = n.get("availability_pct")
    floor = n.get("availability_floor_pct", 99.0)
    if not (isinstance(avail, (int, float)) and avail >= floor):
        problems.append(
            f"availability {avail}% under proc_kill is below the "
            f"{floor}% floor")
    pk = n.get("proc_kill") or {}
    if not pk.get("recovered"):
        problems.append(
            "proc_kill drill did not recover (lost -> drain -> respawn "
            "-> rejoin arc incomplete)")
    pt = n.get("partition") or {}
    if not pt.get("stale_write_refused"):
        problems.append(
            "partitioned replica ACCEPTED a stale write on heal")
    tcp_parity = n.get("tcp_parity")
    if not (isinstance(tcp_parity, (int, float)) and tcp_parity == 0.0):
        problems.append(
            f"TCP-pulled rows are not bit-identical to the reference "
            f"(parity={tcp_parity})")
    dl = n.get("delta") or {}
    d_parity = dl.get("parity")
    if not (isinstance(d_parity, (int, float)) and d_parity == 0.0):
        problems.append(
            f"post-publisher-kill delta parity {d_parity} != 0.0")
    env = n.get("envelope_x")
    limit = n.get("envelope_limit_x")
    if (isinstance(env, (int, float)) and isinstance(limit, (int, float))
            and limit > 0 and env > limit):
        problems.append(
            f"TCP serving p99 is {env:.1f}x in-process "
            f"(envelope {limit:.0f}x)")
    if problems:
        return 1, "net REGRESSION: " + "; ".join(problems)
    return 0, (
        f"net ok: availability {_fmt_num(avail)}% through proc_kill "
        f"(floor {_fmt_num(floor)}%), stale write refused on heal, TCP "
        f"parity {tcp_parity}, delta parity {d_parity}, envelope "
        f"{_fmt_num(env)}x (limit {_fmt_num(limit)}x)"
    )


def _plane_checks(max_drop_pct: float):
    """The planes' sub-checks, in the JAX gate's order, each ``ledger ->
    (rc, message or None)``."""
    return (
        _check_chaos_regression,
        functools.partial(_check_serving_regression, max_drop_pct=max_drop_pct),
        functools.partial(_check_fleet_regression, max_drop_pct=max_drop_pct),
        functools.partial(_check_tiered_regression, max_drop_pct=max_drop_pct),
        _check_chaos_serve_regression,
        _check_chaos_cluster_regression,
        _check_freshness_regression,
        _check_trace_overhead_regression,
        _check_drift_regression,
        _check_profiler_overhead_regression,
        _check_net_regression,
    )


def _resolve_diff_record(ledger: Ledger, spec: str) -> Tuple[Dict, str]:
    """One side of ``--diff``: an integer indexes the ledger's run records
    (negative from the end, so ``-2 -1`` is before/after the newest pair);
    anything else is a path to a JSON record/bench-payload file. Raises
    ``ValueError`` with a usable message on a bad spec."""
    try:
        idx = int(spec)
    except ValueError:
        if not os.path.exists(spec):
            raise ValueError(
                f"--diff: {spec!r} is neither a run-record index nor a file")
        with open(spec, "r", encoding="utf-8") as f:
            try:
                rec = json.load(f)
            except ValueError:
                # a one-record-per-line file: take the last parseable line
                f.seek(0)
                rec = None
                for line in f:
                    line = line.strip()
                    if line:
                        try:
                            rec = json.loads(line)
                        except ValueError:
                            continue
                if rec is None:
                    raise ValueError(f"--diff: no JSON object in {spec!r}")
        if not isinstance(rec, dict):
            raise ValueError(f"--diff: {spec!r} is not a JSON object")
        return rec, spec
    runs = ledger.records("run")
    if not runs:
        raise ValueError("--diff: ledger has no run records")
    try:
        rec = runs[idx]
    except IndexError:
        raise ValueError(
            f"--diff: run index {idx} out of range ({len(runs)} run records)")
    return rec, f"run[{idx}] {rec.get('ts', '?')} {rec.get('model', '')}"


def render_diff(rec_a: Dict, rec_b: Dict,
                label_a: str = "A", label_b: str = "B") -> str:
    """``ledger-report --diff A B``: decompose the words/sec delta between
    two run/bench records into goodput components and per-scope comm bytes,
    and name the dominant contributor (telemetry/goodput.py does the
    arithmetic; this renders it)."""
    from swiftsnails_tpu_torch.telemetry.goodput import throughput_attribution

    att = throughput_attribution(rec_a, rec_b)
    lines = [f"perf diff: A = {label_a}", f"           B = {label_b}"]
    ra, rb = att["items_per_sec_a"], att["items_per_sec_b"]
    dp = att["delta_pct"]
    lines.append(
        "items/sec: "
        f"{_fmt_num(ra) if ra else 'n/a'} -> {_fmt_num(rb) if rb else 'n/a'}"
        + (f"  ({dp:+.2f}%)" if isinstance(dp, (int, float)) else "")
    )
    lines.append("per-step seconds by component (B - A):")
    for name in ("compute", "h2d", "host_blocked", "other", "unaccounted"):
        c = att["components"].get(name) or {}
        a_s, b_s, d_s = c.get("a_s"), c.get("b_s"), c.get("delta_s")
        if a_s is None and b_s is None:
            continue
        fmt = lambda v: f"{v * 1e3:8.3f}ms" if isinstance(v, (int, float)) \
            else "     n/a"
        mark = "  <-- dominant" if name == att.get("dominant") else ""
        lines.append(
            f"  {name:<12} {fmt(a_s)} -> {fmt(b_s)}  "
            f"delta={fmt(d_s)}{mark}")
    if att["comm_bytes"]:
        lines.append("comm bytes by scope (per audited step, B - A):")
        for scope, row in sorted(att["comm_bytes"].items()):
            lines.append(
                f"  {scope:<24} {_fmt_num(row.get('a_bytes') or 0)}B -> "
                f"{_fmt_num(row.get('b_bytes') or 0)}B  "
                f"delta={_fmt_num(row.get('delta_bytes') or 0)}B")
    dom = att.get("dominant")
    share = att.get("dominant_share")
    lines.append(
        f"dominant contributor: {dom}"
        + (f" ({share * 100:.0f}% of the per-step delta)"
           if isinstance(share, (int, float)) else "")
    )
    return "\n".join(lines)



def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        prog="ledger_report",
        description="Render the run ledger; optionally gate on bench regression.",
    )
    p.add_argument(
        "path", nargs="?", default=DEFAULT_LEDGER,
        help=f"ledger JSONL (default: {DEFAULT_LEDGER})",
    )
    p.add_argument(
        "--check-regression", type=float, metavar="PCT", default=None,
        help="exit nonzero if the newest measured bench value is more than "
             "PCT%% below the pinned baseline (bench gate mode); also "
             "gates the training plane's correctness lanes on any platform "
             "— chaos recovery, the drift drill, and the tracer's and the "
             "continuous profiler's own cost",
    )
    p.add_argument(
        "--baseline", type=float, default=None,
        help="explicit pinned baseline value for --check-regression "
             "(default: best earlier measured record in the ledger)",
    )
    p.add_argument(
        "--failures", action="store_true",
        help="render the failure timeline (outage/chaos/blackbox/"
             "cache_error/retry_exhausted/drift events next to run records) "
             "instead of the full report",
    )
    p.add_argument(
        "--diff", nargs=2, metavar=("A", "B"), default=None,
        help="regression attribution between two records: each side is a "
             "run-record index into the ledger (negative ok; e.g. -2 -1) "
             "or a JSON record file; decomposes the words/sec delta into "
             "goodput components + per-scope comm bytes and names the "
             "dominant contributor",
    )
    args = p.parse_args(argv)
    ledger = Ledger(args.path)
    if args.diff:
        try:
            rec_a, label_a = _resolve_diff_record(ledger, args.diff[0])
            rec_b, label_b = _resolve_diff_record(ledger, args.diff[1])
        except ValueError as e:
            print(f"ledger_report: {e}")
            return 2
        print(render_diff(rec_a, rec_b, label_a, label_b))
        return 0
    if args.failures:
        print(render_failures(ledger))
        return 0
    if args.check_regression is not None:
        rc, msg = check_regression(ledger, args.check_regression, args.baseline)
        print(msg)
        return rc
    print(render_report(ledger))
    return 0
