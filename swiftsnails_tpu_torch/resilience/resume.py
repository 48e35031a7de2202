"""Auto-resume: find the run's last *good* checkpoint and continue the run —
tables **and** data-stream cursor — never crashing on a corrupt save. The
JAX package's ``resilience/resume.py``.

``resume: 1`` restores the newest checkpoint that verifies and restarts the
data stream; ``resume: auto`` also returns the manifest's ``data_cursor`` so
the TrainLoop skips the batches already consumed, and a resumed loss curve
continues the interrupted one. The port has no run ledger yet
(``ROADMAP.md``), so both walk :func:`candidate_steps` alone — as the JAX
package does without a ledger — and every rejected step is reported to the
caller's ``on_reject``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

from swiftsnails_tpu_torch.framework.checkpoint import (
    CheckpointError,
    candidate_steps,
    read_manifest,
    restore_checkpoint,
)


def resume_state(
    root: str,
    template: Any,
    on_reject: Optional[Callable[[int, Exception], None]] = None,
) -> Optional[Tuple[Any, int, Dict]]:
    """Restore the newest intact checkpoint under ``root`` into ``template``.

    Returns ``(state, step, data_cursor)`` or ``None`` when nothing under
    ``root`` is restorable (a fresh run; ``template`` is then untouched).
    Candidates are tried best first; a corrupt, torn or unreadable one is
    passed to ``on_reject(step, error)`` and skipped, so a flipped bit in
    the newest save costs one backup period, not the run.
    """
    for step in candidate_steps(root):
        try:
            state = restore_checkpoint(root, template, step=step, verify=True)
        except (CheckpointError, OSError) as e:
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
