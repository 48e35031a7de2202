"""Auto-resume: find the run's last *good* checkpoint and continue the run —
tables **and** data-stream cursor — never crashing on a corrupt save. The
JAX package's ``resilience/resume.py``.

``resume: 1`` restores the newest checkpoint that verifies and restarts the
data stream. ``resume: auto`` goes further: it consults the run ledger
(``ledger_path``; its ``checkpoint`` events are written at every verified
save) for the run's known-good steps, walks back to the newest intact
checkpoint when anything is corrupt (each rejection is a ``cache_error``
ledger event and a call of the caller's ``on_reject``, never a crash), and
returns the manifest's ``data_cursor`` so the TrainLoop skips the batches
already consumed, and a resumed loss curve continues the interrupted one.
Without a ledger both walk :func:`candidate_steps` alone.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, List, Optional, Tuple

from swiftsnails_tpu_torch.framework.checkpoint import (
    CheckpointError,
    _step_dir,
    candidate_steps,
    read_manifest,
    restore_checkpoint,
)


def _ledger_known_steps(ledger, root: str, config_hash: Optional[str]) -> List[int]:
    """Steps the ledger records as good saves under ``root`` (newest first).
    A config-hash mismatch does not disqualify a record — resuming across a
    benign config tweak is legal; shapes are enforced by the restore itself."""
    if ledger is None:
        return []
    root = os.path.abspath(root)
    try:
        records = ledger.records("checkpoint")
    except Exception:
        return []
    mine = [
        rec for rec in records
        if rec.get("root") == root and isinstance(rec.get("step"), int)
    ]
    # prefer records of this exact config, then the rest, each newest-first
    same = [r["step"] for r in mine
            if config_hash and r.get("config_hash") == config_hash]
    rest = [r["step"] for r in mine if r["step"] not in same]
    ordered = list(reversed(same)) + list(reversed(rest))
    seen: set = set()
    return [s for s in ordered if not (s in seen or seen.add(s))]


def resume_state(
    root: str,
    template: Any,
    mode: str = "latest",
    ledger=None,
    config_hash: Optional[str] = None,
    on_reject: Optional[Callable[[int, Exception], None]] = None,
    mesh=None,
) -> Optional[Tuple[Any, int, Dict]]:
    """Restore the newest intact checkpoint under ``root`` into ``template``.

    Returns ``(state, step, data_cursor)`` or ``None`` when nothing under
    ``root`` is restorable (a fresh run; ``template`` is then untouched).
    Candidates are tried best first — the ledger's known-good steps seed
    the walk in ``auto`` mode; a corrupt, torn or unreadable one is
    recorded as a ``cache_error`` ledger event, passed to
    ``on_reject(step, error)`` and skipped, so a flipped bit in the newest
    save costs one backup period, not the run. ``mesh``: ``template`` is
    this rank's part of a state sharded over it; every rank calls this,
    and all of them walk back together
    (:func:`~swiftsnails_tpu_torch.framework.checkpoint.restore_checkpoint`).
    """
    preferred: List[int] = []
    if mode == "auto":
        preferred = _ledger_known_steps(ledger, root, config_hash)
    for step in candidate_steps(root, preferred=preferred):
        try:
            state = restore_checkpoint(root, template, step=step, verify=True, mesh=mesh)
        except (CheckpointError, OSError) as e:
            if ledger is not None:
                try:
                    ledger.append("cache_error", {
                        "source": "checkpoint",
                        "path": _step_dir(root, step),
                        "error": f"{type(e).__name__}: {e}",
                        "action": "walking back to an older checkpoint",
                    })
                except Exception:
                    pass  # record-keeping never fails the resume
            if on_reject is not None:
                on_reject(step, e)
            continue
        manifest = read_manifest(root, step) or {}
        cursor = manifest.get("data_cursor") or {"step": step}
        return state, step, cursor
    return None


def resume_mode(cfg) -> str:
    """The ``resume`` config key, normalized: ``off`` / ``latest`` /
    ``auto``. (``resume`` predates auto mode as a bool, so truthy words map
    to ``latest``.)"""
    raw = cfg.get_str("resume", "0").strip().lower()
    if raw == "auto":
        return "auto"
    if raw in ("1", "true", "yes", "on"):
        return "latest"
    return "off"
