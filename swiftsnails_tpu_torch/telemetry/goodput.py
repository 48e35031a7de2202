"""Goodput / MFU accounting: hardware-utilization numbers for a run — the
JAX package's ``telemetry/goodput.py``.

Combines two raw signal sources —

* the host span tracer (prefetch-wait / h2d / step spans per step; on the
  card the ``step`` span ends after the device's stream has synchronized,
  so it holds the step's device time, not only its enqueue), and
* the step's FLOP and byte counts: in the JAX package a compiled-HLO audit,
  in the port :meth:`Trainer.step_cost`, counted from the batch's shapes
  (least bytes, f32 flops) with ``collective_bytes`` ``None`` on one card

— into the metrics accelerator training stacks report as first-class: **MFU**
(model FLOP utilization: achieved FLOP/s over the chip's peak), a
**step-time decomposition** (compute vs collective vs host-blocked vs h2d),
**goodput** (fraction of wall-clock spent inside productive steps), and a
**words/sec-vs-roofline ratio** (measured throughput over the
compute/memory-roofline bound for the compiled step).

Everything here is pure host-side arithmetic over already-recorded data:
no device work, no extra hot-path cost. Peaks come from a per-device-kind
table (published chip specs) overridable via the ``peak_flops`` /
``peak_hbm_gbps`` / ``peak_ici_gbps`` config keys — on CPU (tier-1 tests,
smoke runs) there is no meaningful peak, so MFU degrades to ``None``
rather than inventing a number. The port's kinds are
``torch.cuda.get_device_name()``; the TPU rows stay so that a JAX run
record and its peaks read the same in both packages.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence

# Published per-chip peaks: (bf16 TFLOP/s, HBM GB/s, ICI GB/s per link-set).
# Keyed by lower-case substrings of the device kind (the JAX package's
# ``device_kind``, the port's ``torch.cuda.get_device_name()``); first match
# wins. These anchor MFU the way the pjit-at-scale reports do (arXiv:
# 2204.06514 reports hardware FLOP/s utilization against the chip peak).
# The H100 rows are NVIDIA's H100 datasheet: dense bf16 tensor-core FLOP/s
# (no sparsity), HBM rate, and NVLink bandwidth a direction (900 / 600 GB/s
# bidirectional); "h100 pcie" goes first so that the SXM row's substring
# does not take it. As in the TPU rows the FLOP peak is bf16, though the
# port's steps compute in f32 (67 TFLOP/s on an H100 SXM outside the tensor
# cores, which PERF.md keeps beside this one).
_PEAKS = (
    ("h100 pcie", (756.0, 2000.0, 300.0)),
    ("h100", (989.0, 3350.0, 450.0)),     # "NVIDIA H100 80GB HBM3" (SXM5)
    ("v6", (918.0, 1640.0, 448.0)),       # Trillium / v6e
    ("v5p", (459.0, 2765.0, 600.0)),
    ("v5 lite", (197.0, 819.0, 200.0)),   # v5e device_kind is "TPU v5 lite"
    ("v5e", (197.0, 819.0, 200.0)),
    ("v5", (459.0, 2765.0, 600.0)),
    ("v4", (275.0, 1228.0, 300.0)),
    ("v3", (123.0, 900.0, 100.0)),
    ("v2", (46.0, 700.0, 62.0)),
)


def peaks_for(device_kind: Optional[str]) -> Dict[str, Optional[float]]:
    """Peak FLOP/s, HBM B/s, ICI B/s for a device kind (None when unknown,
    e.g. CPU — never invent a utilization denominator)."""
    if device_kind:
        kind = device_kind.lower()
        for key, (tf, hbm, ici) in _PEAKS:
            if key in kind:
                return {
                    "flops_per_s": tf * 1e12,
                    "hbm_bytes_per_s": hbm * 1e9,
                    "ici_bytes_per_s": ici * 1e9,
                    "source": f"builtin table ({key})",
                }
    return {
        "flops_per_s": None,
        "hbm_bytes_per_s": None,
        "ici_bytes_per_s": None,
        "source": "unknown device kind",
    }


def peaks_from_config(cfg, device_kind: Optional[str]) -> Dict:
    """Table peaks with config-key overrides (``peak_flops`` in FLOP/s,
    ``peak_hbm_gbps`` / ``peak_ici_gbps`` in GB/s)."""
    peaks = peaks_for(device_kind)
    if cfg is not None:
        pf = cfg.get_float("peak_flops", 0.0)
        if pf > 0:
            peaks["flops_per_s"] = pf
            peaks["source"] = "config"
        hbm = cfg.get_float("peak_hbm_gbps", 0.0)
        if hbm > 0:
            peaks["hbm_bytes_per_s"] = hbm * 1e9
        ici = cfg.get_float("peak_ici_gbps", 0.0)
        if ici > 0:
            peaks["ici_bytes_per_s"] = ici * 1e9
    return peaks


# ------------------------------------------------------ span decomposition ---

# spans the TrainLoop emits, bucketed for the decomposition
_SPAN_BUCKETS = {
    "step": "compute_s",          # the step's launches + device sync
    "h2d": "h2d_s",
    "prefetch-wait": "host_blocked_s",
    "tier-fault": "host_blocked_s",       # tiered residency work on the step
    "tier-flush-wait": "host_blocked_s",  # async write-back drain barriers
    "chaos-slow": "host_blocked_s",       # injected slow_step host sleep
    "metrics-flush": "other_s",
    "checkpoint": "other_s",
}


def step_time_decomposition(events: Iterable[Dict]) -> Dict:
    """Bucketed wall-clock split from tracer span events.

    ``events`` is ``Tracer.events()`` output (dicts with ``name``/``ts_us``/
    ``dur_us``). Top-level spans only (depth<=1 buckets; the per-step outer
    ``step_span`` carries the trainer name and is skipped so nothing is
    counted twice). Fractions are of the traced wall-clock between the first
    span start and the last span end.
    """
    out = {
        "wall_s": 0.0, "compute_s": 0.0, "h2d_s": 0.0,
        "host_blocked_s": 0.0, "other_s": 0.0, "steps": 0,
    }
    t0, t1 = float("inf"), float("-inf")
    for e in events:
        ts = float(e.get("ts_us", 0.0))
        dur = float(e.get("dur_us", 0.0))
        t0 = min(t0, ts)
        t1 = max(t1, ts + dur)
        bucket = _SPAN_BUCKETS.get(e.get("name"))
        if bucket is not None:
            out[bucket] += dur / 1e6
            if e.get("name") == "step":
                out["steps"] += 1
    if t1 > t0:
        out["wall_s"] = (t1 - t0) / 1e6
    wall = out["wall_s"]
    if wall > 0:
        accounted = (
            out["compute_s"] + out["h2d_s"] + out["host_blocked_s"] + out["other_s"]
        )
        out["compute_frac"] = out["compute_s"] / wall
        out["h2d_frac"] = out["h2d_s"] / wall
        out["host_blocked_frac"] = out["host_blocked_s"] / wall
        out["other_frac"] = out["other_s"] / wall
        out["unaccounted_frac"] = max(1.0 - accounted / wall, 0.0)
    return out


# ------------------------------------------------------------- roofline ---


def roofline_step_seconds(
    flops: Optional[float],
    hbm_bytes: Optional[float],
    collective_bytes: Optional[float],
    peaks: Dict,
) -> Optional[float]:
    """Lower bound on one step's duration from the compiled cost analysis:
    max over the compute, HBM, and interconnect rooflines (each skipped when
    its peak or numerator is unknown)."""
    bounds = []
    if flops and peaks.get("flops_per_s"):
        bounds.append(flops / peaks["flops_per_s"])
    if hbm_bytes and peaks.get("hbm_bytes_per_s"):
        bounds.append(hbm_bytes / peaks["hbm_bytes_per_s"])
    if collective_bytes and peaks.get("ici_bytes_per_s"):
        bounds.append(collective_bytes / peaks["ici_bytes_per_s"])
    return max(bounds) if bounds else None


def goodput_report(
    *,
    events: Optional[Sequence[Dict]] = None,
    audit: Optional[Dict] = None,
    steps: Optional[int] = None,
    items: Optional[int] = None,
    step_seconds: Optional[float] = None,
    peaks: Optional[Dict] = None,
    n_chips: int = 1,
) -> Dict:
    """The per-run goodput block.

    Inputs are all optional — the report states what it could compute and
    carries ``None`` for the rest (a CPU smoke run has spans but no peak;
    an audit-less run has timings but no FLOPs).

    * ``events``: tracer span dicts (gives the decomposition + step timing);
    * ``audit``: a ``{"cost": {"flops", "bytes_accessed"}, "total_bytes"}``
      report for ONE step (the JAX package's HLO audit; the port's
      :meth:`Trainer.step_cost`);
    * ``steps`` / ``items``: loop totals (items = words/examples);
    * ``step_seconds``: measured per-step seconds — derived from the spans
      when absent;
    * ``peaks``: :func:`peaks_for` / :func:`peaks_from_config` output;
    * ``n_chips``: devices sharing the audited step's FLOPs (per-chip MFU).
    """
    peaks = peaks or peaks_for(None)
    report: Dict = {"peaks": {k: v for k, v in peaks.items()}}

    dec = None
    if events:
        dec = step_time_decomposition(events)
        report["decomposition"] = dec
        if steps is None:
            steps = dec["steps"] or None
    if steps:
        report["steps"] = int(steps)
    if items is not None:
        report["items"] = int(items)

    if step_seconds is None and dec and dec["steps"]:
        step_seconds = dec["compute_s"] / dec["steps"]
    report["step_seconds"] = step_seconds

    # goodput: productive (in-step) fraction of the traced wall-clock
    if dec and dec["wall_s"] > 0:
        report["goodput"] = dec["compute_s"] / dec["wall_s"]

    flops = hbm_bytes = coll_bytes = None
    if audit:
        cost = audit.get("cost", {}) or {}
        flops = cost.get("flops")
        hbm_bytes = cost.get("bytes_accessed")
        coll_bytes = audit.get("total_bytes", audit.get("collective_bytes"))
        report["flops_per_step"] = flops
        report["hbm_bytes_per_step"] = hbm_bytes
        report["collective_bytes_per_step"] = coll_bytes

    # MFU: achieved FLOP/s over peak, per chip
    mfu = None
    if flops and step_seconds and peaks.get("flops_per_s"):
        mfu = (flops / n_chips) / step_seconds / peaks["flops_per_s"]
    report["mfu"] = mfu

    # model-based split of the measured step time into compute vs collective
    # (roofline estimates normalized onto the measured step — labeled est)
    if step_seconds and step_seconds > 0:
        comp_est = (
            flops / n_chips / peaks["flops_per_s"]
            if flops and peaks.get("flops_per_s") else None
        )
        coll_est = (
            coll_bytes / n_chips / peaks["ici_bytes_per_s"]
            if coll_bytes and peaks.get("ici_bytes_per_s") else None
        )
        if comp_est is not None or coll_est is not None:
            # the seconds estimates are kept alongside the fractions so the
            # collective share can be cross-checked directly against the
            # audited bytes / ICI peak (the scale-out lane records both and
            # attributes an overlap/quantization win to the right term)
            report["step_split_est"] = {
                "compute_frac": (comp_est or 0.0) / step_seconds,
                "collective_frac": (coll_est or 0.0) / step_seconds,
                "compute_seconds_est": comp_est,
                "collective_seconds_est": coll_est,
            }

    # words/sec vs roofline: measured items/s over the bound the compiled
    # step admits on this chip
    ideal_s = roofline_step_seconds(
        flops / n_chips if flops else None,
        hbm_bytes / n_chips if hbm_bytes else None,
        coll_bytes / n_chips if coll_bytes else None,
        peaks,
    )
    report["roofline_step_seconds"] = ideal_s
    if ideal_s and steps and items and step_seconds:
        items_per_step = items / steps
        measured_rate = items_per_step / step_seconds
        roofline_rate = items_per_step / ideal_s
        report["items_per_sec"] = measured_rate
        report["roofline_items_per_sec"] = roofline_rate
        report["vs_roofline"] = measured_rate / roofline_rate
    elif steps and items and step_seconds:
        report["items_per_sec"] = (items / steps) / step_seconds
    return report


# -------------------------------------------------- regression attribution ---

_ATTR_COMPONENTS = ("compute", "h2d", "host_blocked", "other", "unaccounted")


def _per_step_components(rec: Dict) -> Dict[str, Optional[float]]:
    """Per-step seconds for each decomposition component of one run/bench
    record (``None`` when the record carries no decomposition)."""
    gp = rec.get("goodput") or rec
    dec = gp.get("decomposition") or {}
    steps = dec.get("steps") or gp.get("steps") or 0
    out: Dict[str, Optional[float]] = {}
    if not steps:
        return {c: None for c in _ATTR_COMPONENTS}
    wall = dec.get("wall_s") or 0.0
    accounted = 0.0
    for comp in ("compute", "h2d", "host_blocked", "other"):
        sec = dec.get(f"{comp}_s")
        out[comp] = (sec / steps) if sec is not None else None
        accounted += sec or 0.0
    out["unaccounted"] = max(wall - accounted, 0.0) / steps if wall else None
    return out


def _record_rate(rec: Dict) -> Optional[float]:
    """items/sec (words/sec) of a run/bench record, from whichever field
    the record carries.

    A record with a span decomposition is rated as items over traced
    *wall-clock*: ``goodput.items_per_sec`` divides by the mean ``step``
    span instead, which excludes exactly the host-blocked time a ``--diff``
    exists to attribute (a run slowed by sleeps would look *faster*)."""
    gp = rec.get("goodput") or {}
    for probe in (
        rec.get("words_per_sec"),
        rec.get("items_per_sec"),
        rec.get("best"),
    ):
        if isinstance(probe, (int, float)) and probe > 0:
            return float(probe)
    items = gp.get("items") or rec.get("items")
    dec = gp.get("decomposition") or rec.get("decomposition") or {}
    wall = dec.get("wall_s")
    if items and isinstance(wall, (int, float)) and wall > 0:
        return float(items) / wall
    probe = gp.get("items_per_sec")
    if isinstance(probe, (int, float)) and probe > 0:
        return float(probe)
    steps = gp.get("steps") or rec.get("steps")
    step_s = gp.get("step_seconds")
    if steps and items and step_s:
        return (items / steps) / step_s
    return None


def throughput_attribution(rec_a: Dict, rec_b: Dict) -> Dict:
    """Decompose the words/sec delta between two run/bench records.

    The core of ``ledger-report --diff A B`` / ``tools/perf_diff.py`` in the JAX package:
    per-step seconds for each goodput component (compute / h2d /
    host-blocked / other / unaccounted) are differenced A→B, per-scope
    comm-audit bytes likewise, and the **dominant contributor** is the
    component with the largest absolute per-step delta — the one a
    regression (or a win) should be attributed to. Pure host arithmetic
    over the records; tolerant of partial records (an un-decomposed side
    yields ``None`` deltas and an ``insufficient-data`` dominant).
    """
    comp_a = _per_step_components(rec_a)
    comp_b = _per_step_components(rec_b)
    rate_a = _record_rate(rec_a)
    rate_b = _record_rate(rec_b)

    components: Dict[str, Dict] = {}
    best_name, best_delta = None, 0.0
    for name in _ATTR_COMPONENTS:
        a, b = comp_a.get(name), comp_b.get(name)
        delta = (b - a) if (a is not None and b is not None) else None
        components[name] = {"a_s": a, "b_s": b, "delta_s": delta}
        if delta is not None and abs(delta) > abs(best_delta):
            best_name, best_delta = name, delta

    total_delta = sum(
        c["delta_s"] for c in components.values() if c["delta_s"] is not None
    )
    dominant_share = (
        abs(best_delta) / abs(total_delta)
        if best_name is not None and total_delta else None
    )

    # per-scope comm bytes (the audit's by_scope map, carried on run
    # records as comm_by_scope and on bench payloads inside the audit)
    def _by_scope(rec: Dict) -> Dict[str, float]:
        scopes = rec.get("comm_by_scope")
        if not scopes:
            scopes = (rec.get("audit") or {}).get("by_scope")
        out = {}
        for scope, v in (scopes or {}).items():
            bytes_ = v.get("bytes") if isinstance(v, dict) else v
            if isinstance(bytes_, (int, float)):
                out[scope] = float(bytes_)
        return out

    scopes_a, scopes_b = _by_scope(rec_a), _by_scope(rec_b)
    comm: Dict[str, Dict] = {}
    for scope in sorted(set(scopes_a) | set(scopes_b)):
        a = scopes_a.get(scope)
        b = scopes_b.get(scope)
        comm[scope] = {
            "a_bytes": a,
            "b_bytes": b,
            "delta_bytes": (b or 0.0) - (a or 0.0),
        }

    delta_pct = None
    if rate_a and rate_b:
        delta_pct = (rate_b - rate_a) / rate_a * 100.0
    return {
        "items_per_sec_a": rate_a,
        "items_per_sec_b": rate_b,
        "delta_pct": delta_pct,
        "components": components,
        "comm_bytes": comm,
        "dominant": best_name or "insufficient-data",
        "dominant_delta_s": best_delta if best_name else None,
        "dominant_share": dominant_share,
    }
