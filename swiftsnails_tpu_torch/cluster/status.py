"""``supervisor-status``: the membership view reconstructed from a ledger.

A live in-process :class:`Supervisor` answers :meth:`status` directly; a
finished (or remote) run leaves its whole membership lifecycle in the run
ledger as ``membership`` events. This module replays those events into the
supervisor's-eye view — who joined, who was lost and why, where every
reassigned range went, which workers were flagged stragglers — plus the
newest ``chaos_cluster`` bench block's exactly-once verdict when one is
present. The JAX package's ``cluster/status.py``.
"""

from __future__ import annotations

from typing import Dict


def supervisor_status_view(ledger) -> Dict:
    """Replay a ledger's ``membership`` events into a status snapshot."""
    workers: Dict[str, Dict] = {}
    counts = {"worker-lost": 0, "reassigned": 0, "straggler": 0, "backup": 0,
              "restore": 0}

    def _w(name):
        return workers.setdefault(name, {
            "state": "unknown", "joins": 0, "straggler": False,
            "lost_reason": None, "reassigned_to": None,
        })

    for r in ledger.records("membership"):
        action = r.get("action")
        w = r.get("worker", "?")
        if action in ("join", "rejoin"):
            m = _w(w)
            m["state"] = "alive"
            m["joins"] += 1
            m["lost_reason"] = None
        elif action == "worker-lost":
            m = _w(w)
            m["state"] = "lost"
            m["lost_reason"] = r.get("reason")
            counts["worker-lost"] += 1
        elif action == "reassigned":
            _w(w)["reassigned_to"] = r.get("to")
            counts["reassigned"] += 1
        elif action == "straggler":
            _w(w)["straggler"] = True
            counts["straggler"] += 1
        elif action == "straggler-clear":
            _w(w)["straggler"] = False
        elif action in counts:
            counts[action] += 1
    view = {"workers": workers, "counts": counts, "events": sum(
        1 for _ in ledger.records("membership"))}
    for r in ledger.records("bench"):
        payload = r.get("payload")
        if isinstance(payload, dict) and \
                isinstance(payload.get("chaos_cluster"), dict):
            view["chaos_cluster"] = payload["chaos_cluster"]
    return view


def render_supervisor_status(ledger) -> str:
    view = supervisor_status_view(ledger)
    lines = [f"supervisor status: {ledger.path}"]
    if not view["workers"]:
        lines.append("  (no membership events recorded)")
        return "\n".join(lines)
    for w, m in sorted(view["workers"].items()):
        flags = []
        if m["straggler"]:
            flags.append("straggler")
        if m["reassigned_to"]:
            flags.append(f"range->{m['reassigned_to']}")
        if m["lost_reason"]:
            flags.append(str(m["lost_reason"]))
        lines.append(
            f"  {w:<12} {m['state']:<8} joins={m['joins']}"
            + (f"  [{', '.join(flags)}]" if flags else "")
        )
    c = view["counts"]
    lines.append(
        f"  lifecycle: {c['worker-lost']} lost, {c['reassigned']} "
        f"reassigned, {c['straggler']} straggler flags, "
        f"{c['backup']} backup grants, {c['restore']} restores"
    )
    cc = view.get("chaos_cluster")
    if cc:
        lines.append(
            f"  accounting: {cc.get('committed')}/{cc.get('total_batches')} "
            f"committed, lost={cc.get('lost_count')} "
            f"dup={cc.get('duplicated_count')} "
            f"dup_discarded={cc.get('dup_discarded')} "
            f"exact={cc.get('accounting_exact')}"
        )
    return "\n".join(lines)
