"""Render a trace / metrics file into a per-span time breakdown — the JAX
package's ``telemetry/summary.py``.

Input formats (auto-detected):

* Chrome trace-event JSON (``Tracer.export`` / ``trace_path``) — aggregates
  the complete ("X") events per span name: count, total/mean/min/max ms, and
  share of the traced wall-clock (first span start to last span end);
* metrics JSONL (``MetricsLogger`` / ``metrics_path``) — aggregates every
  numeric field across records: count, mean, min, max, last.

Used by the ``trace-summary`` CLI command
(``python -m swiftsnails_tpu_torch trace-summary FILE``).
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence


def load_events(path: str) -> Optional[List[Dict]]:
    """Chrome trace "X" events from ``path``, or None if not a trace file."""
    try:
        with open(path, "r", encoding="utf-8") as f:
            doc = json.load(f)
    except (ValueError, UnicodeDecodeError):
        return None
    if isinstance(doc, dict):
        events = doc.get("traceEvents")
    elif isinstance(doc, list):  # bare event-array form is also valid
        events = doc
    else:
        return None
    if not isinstance(events, list):
        return None
    return [e for e in events if isinstance(e, dict) and e.get("ph") == "X"]


def summarize_events(events: Sequence[Dict]) -> List[Dict]:
    """Per-name aggregate rows, sorted by total time descending."""
    agg: Dict[str, Dict] = {}
    t_min, t_max = float("inf"), float("-inf")
    for e in events:
        name = e.get("name", "?")
        dur = float(e.get("dur", 0.0))
        ts = float(e.get("ts", 0.0))
        t_min = min(t_min, ts)
        t_max = max(t_max, ts + dur)
        row = agg.setdefault(
            name, {"name": name, "count": 0, "total_us": 0.0,
                   "min_us": float("inf"), "max_us": 0.0}
        )
        row["count"] += 1
        row["total_us"] += dur
        row["min_us"] = min(row["min_us"], dur)
        row["max_us"] = max(row["max_us"], dur)
    wall_us = max(t_max - t_min, 1e-9)
    rows = sorted(agg.values(), key=lambda r: -r["total_us"])
    for row in rows:
        row["mean_us"] = row["total_us"] / row["count"]
        row["wall_pct"] = 100.0 * row["total_us"] / wall_us
    return rows


def render_events(rows: Sequence[Dict], wall_note: str = "") -> str:
    """Terminal table for :func:`summarize_events` rows."""
    if not rows:
        return "no spans recorded"
    name_w = max(len(r["name"]) for r in rows)
    name_w = max(name_w, len("span"))
    head = (f"{'span'.ljust(name_w)}  {'count':>6}  {'total ms':>10}  "
            f"{'mean ms':>9}  {'min ms':>8}  {'max ms':>8}  {'% wall':>6}")
    lines = [head, "-" * len(head)]
    for r in rows:
        lines.append(
            f"{r['name'].ljust(name_w)}  {r['count']:>6}  "
            f"{r['total_us'] / 1e3:>10.3f}  {r['mean_us'] / 1e3:>9.3f}  "
            f"{r['min_us'] / 1e3:>8.3f}  {r['max_us'] / 1e3:>8.3f}  "
            f"{r['wall_pct']:>6.1f}"
        )
    if wall_note:
        lines.append(wall_note)
    return "\n".join(lines)


def load_jsonl(path: str) -> List[Dict]:
    """Records of a metrics JSONL file (bad lines skipped)."""
    records = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if isinstance(rec, dict):
                records.append(rec)
    return records


def summarize_jsonl(records: Sequence[Dict]) -> List[Dict]:
    """Per-field aggregate rows over numeric JSONL fields."""
    agg: Dict[str, Dict] = {}
    for rec in records:
        for k, v in rec.items():
            if k == "ts" or isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            row = agg.setdefault(
                k, {"field": k, "count": 0, "sum": 0.0,
                    "min": float("inf"), "max": float("-inf"), "last": v}
            )
            row["count"] += 1
            row["sum"] += v
            row["min"] = min(row["min"], v)
            row["max"] = max(row["max"], v)
            row["last"] = v
    rows = sorted(agg.values(), key=lambda r: r["field"])
    for row in rows:
        row["mean"] = row["sum"] / row["count"]
    return rows


def render_jsonl(rows: Sequence[Dict], n_records: int) -> str:
    if not rows:
        return "no numeric fields found"
    field_w = max(max(len(r["field"]) for r in rows), len("field"))
    head = (f"{'field'.ljust(field_w)}  {'count':>6}  {'mean':>12}  "
            f"{'min':>12}  {'max':>12}  {'last':>12}")
    lines = [f"{n_records} records", head, "-" * len(head)]
    for r in rows:
        lines.append(
            f"{r['field'].ljust(field_w)}  {r['count']:>6}  {r['mean']:>12.6g}  "
            f"{r['min']:>12.6g}  {r['max']:>12.6g}  {r['last']:>12.6g}"
        )
    return "\n".join(lines)


def summarize_file(path: str) -> str:
    """Auto-detect trace vs JSONL and render the breakdown."""
    events = load_events(path)
    if events is not None:
        return render_events(summarize_events(events))
    records = load_jsonl(path)
    if records:
        return render_jsonl(summarize_jsonl(records), len(records))
    raise ValueError(
        f"{path}: neither a Chrome trace (traceEvents) nor a metrics JSONL file"
    )


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        prog="trace_summary",
        description="Per-span time breakdown of a trace_path / metrics_path file.",
    )
    p.add_argument("path", help="Chrome trace JSON or metrics JSONL file")
    args = p.parse_args(argv)
    try:
        print(summarize_file(args.path))
    except BrokenPipeError:  # `trace-summary ... | head` is a normal use
        import os
        import sys

        # point stdout at devnull so the interpreter's exit-time flush
        # doesn't raise the same error again
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        return 0
    except (OSError, ValueError) as e:
        print(f"trace_summary: {e}")
        return 1
    return 0
