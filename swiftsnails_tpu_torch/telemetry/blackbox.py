"""Failure black-box: a flight-recorder ring for the last N training steps —
the JAX package's ``telemetry/blackbox.py``.

A mid-run failure used to leave *nothing* — the round-5 outage produced only
a hand-typed text file, and a crashed run's spans/metrics died with the
process. The black-box keeps a bounded in-memory ring of per-step snapshots
(step number, wall time, host metrics like loss/grad-norm when available,
prefetch queue depth) and, on a trigger, dumps the ring plus the tracer's
recent spans and the environment fingerprint to disk atomically — the
post-mortem artifact the next ``docs/OUTAGE_*.txt`` writes itself from.

Triggers (wired in :class:`~swiftsnails_tpu_torch.framework.trainer.TrainLoop`):

* an exception escaping the training loop;
* a NaN/Inf loss observed at a metrics window (the host already has the
  value there — no extra device sync is added to the hot path);
* SIGTERM (preemption): the TrainLoop's own drain handler dumps the ring
  (:meth:`BlackBox.install_signal_handler` serves a caller without one);
* a guardrail give-up (``guardrail-giveup``).

Cost contract: recording one step is one small dict append into a
``deque(maxlen=N)``; the black-box only exists when telemetry is enabled
(``blackbox_steps > 0``), mirroring the tracer's off-by-default stance.
"""

from __future__ import annotations

import os
import signal
import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional

from swiftsnails_tpu_torch.telemetry.ledger import (
    Ledger, atomic_write_json, env_fingerprint,
)


class BlackBox:
    """Bounded ring of step snapshots with atomic crash dumps.

    ``capacity``: steps retained; ``directory``: where dumps land
    (``blackbox-<utc>-<reason>.json``); ``ledger``: optional
    :class:`Ledger` that receives a ``blackbox`` event per dump, so
    ``ledger-report`` can point at the artifact.
    """

    def __init__(
        self,
        capacity: int = 32,
        directory: str = "blackbox",
        ledger: Optional[Ledger] = None,
        context: Optional[Dict] = None,
        max_spans: int = 512,
    ):
        self.capacity = max(int(capacity), 1)
        self.directory = directory
        self.ledger = ledger
        self.context = dict(context or {})
        self.max_spans = max_spans
        self._ring: Deque[Dict] = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._dumped_reasons: set = set()
        self._prev_sigterm = None

    # -- recording ---------------------------------------------------------

    def record_step(self, step: int, **fields) -> None:
        """Append one step snapshot (cheap: one dict + deque append)."""
        snap = {"step": int(step), "t": time.time()}
        snap.update(fields)
        with self._lock:
            self._ring.append(snap)

    def record_metrics(self, step: int, metrics: Dict) -> None:
        """Attach host metric values (loss, grad norms) to the ring entry for
        ``step`` — called at flush windows where the values are already on
        the host."""
        with self._lock:
            for snap in reversed(self._ring):
                if snap["step"] == step:
                    snap["metrics"] = dict(metrics)
                    return
            self._ring.append(
                {"step": int(step), "t": time.time(), "metrics": dict(metrics)}
            )

    @staticmethod
    def nonfinite(metrics: Dict) -> List[str]:
        """Metric names whose host value is NaN/Inf (the NaN-loss trigger)."""
        bad = []
        for k, v in metrics.items():
            if isinstance(v, float) and (v != v or v in (float("inf"), float("-inf"))):
                bad.append(k)
        return bad

    # -- dumping -----------------------------------------------------------

    def snapshot(self) -> List[Dict]:
        with self._lock:
            return list(self._ring)

    def dump(
        self,
        reason: str,
        exc: Optional[BaseException] = None,
        tracer=None,
        once: bool = True,
    ) -> Optional[str]:
        """Write the post-mortem artifact; returns its path (None when this
        reason already dumped and ``once`` is set — a NaN loss that persists
        for thousands of steps must not write thousands of files)."""
        if once and reason in self._dumped_reasons:
            return None
        self._dumped_reasons.add(reason)
        steps = self.snapshot()
        doc: Dict = {
            "reason": reason,
            "ts": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
            "env": env_fingerprint(include_devices=True),
            "context": self.context,
            "steps": steps,
        }
        if exc is not None:
            doc["exception"] = {"type": type(exc).__name__, "message": str(exc)}
        if tracer is not None:
            try:
                doc["spans"] = tracer.events()[-self.max_spans:]
            except Exception:
                doc["spans"] = []
        os.makedirs(self.directory, exist_ok=True)
        fname = "blackbox-{}-{}.json".format(
            time.strftime("%Y%m%dT%H%M%SZ", time.gmtime()),
            "".join(c if c.isalnum() else "-" for c in reason),
        )
        path = os.path.join(self.directory, fname)
        atomic_write_json(path, doc)
        if self.ledger is not None:
            try:
                self.ledger.append(
                    "blackbox",
                    {
                        "reason": reason,
                        "dump_path": os.path.abspath(path),
                        "first_step": steps[0]["step"] if steps else None,
                        "last_step": steps[-1]["step"] if steps else None,
                        "exception": doc.get("exception"),
                    },
                )
            except OSError:
                pass  # the dump itself is the priority artifact
        return path

    # -- signals -----------------------------------------------------------

    def install_signal_handler(self, tracer=None) -> bool:
        """Dump on SIGTERM (preemption), then hand control back to whatever
        handler was installed before (default: process death). Main-thread
        only; returns False (and stays uninstalled) elsewhere."""

        def _on_term(signum, frame):
            self.dump("sigterm", tracer=tracer)
            prev = self._prev_sigterm
            if callable(prev):
                prev(signum, frame)
            else:
                signal.signal(signal.SIGTERM, signal.SIG_DFL)
                os.kill(os.getpid(), signal.SIGTERM)

        try:
            self._prev_sigterm = signal.signal(signal.SIGTERM, _on_term)
            return True
        except ValueError:  # not the main thread
            return False

    def uninstall_signal_handler(self) -> None:
        if self._prev_sigterm is not None:
            try:
                signal.signal(signal.SIGTERM, self._prev_sigterm)
            except ValueError:
                pass
            self._prev_sigterm = None
