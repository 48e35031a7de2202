"""Tracing / profiling hooks — the JAX package's ``utils/profiling.py`` on
``torch.profiler``.

The reference has no tracing at all (survey §5: glog timestamps and a chrono
``Timer`` only). Here: step-scoped ``record_function`` labels plus an
on-demand trace window, driven by two config keys:

* ``profile_dir``   — where to write the trace (enables profiling);
* ``profile_steps`` — "start,stop" step numbers for the capture window
  (default "10,20": skips the first steps' warm-up, captures 10 steady-state
  steps).

The window opens ``torch.profiler.profile`` with the CPU activity, and the
CUDA activity when the run is on the card, so the capture lists the step's
kernels (the port's hand kernels by their names, e.g. ``gather_rows_kernel``)
beside the host's ``record_function`` ranges; it stops at the window's end,
or in :meth:`StepProfiler.close` on any exit, and writes the Chrome trace
(``export_chrome_trace``) into ``profile_dir``.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import torch

from swiftsnails_tpu_torch.utils.config import Config


class StepProfiler:
    """Start/stop a ``torch.profiler`` capture around a configured step
    window. ``device``: the run's device (a ``cuda`` one adds the CUDA
    activity). After the window, :attr:`trace_path` is the written trace."""

    def __init__(self, config: Config, device: Optional[torch.device] = None):
        self.trace_dir = config.get_str("profile_dir", "")
        window = config.get_str("profile_steps", "10,20")
        try:
            start_s, stop_s = window.replace(";", ",").split(",")
            self.start_step, self.stop_step = int(start_s), int(stop_s)
        except ValueError:
            raise ValueError(
                f"profile_steps must be 'start,stop', got {window!r}"
            ) from None
        if self.start_step >= self.stop_step:
            raise ValueError(
                f"profile_steps start must be < stop, got {window!r}"
            )
        self.cuda = device is not None and torch.device(device).type == "cuda"
        self.trace_path: Optional[str] = None
        self._prof = None
        self._first_step: Optional[int] = None
        self._finished = False

    @property
    def enabled(self) -> bool:
        return bool(self.trace_dir)

    def on_step(self, step: int) -> None:
        if not self.enabled or self._finished:
            return
        # >= not ==: a resumed run may enter past the window start
        if self._prof is None and self.start_step <= step < self.stop_step:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if self.cuda:
                activities.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=activities)
            self._prof.start()
            self._first_step = step
        elif self._prof is not None and step >= self.stop_step:
            self._stop(step)

    def _stop(self, step: int) -> None:
        prof, self._prof = self._prof, None
        self._finished = True
        if self.cuda:
            torch.cuda.synchronize()  # the window's kernels land in the capture
        prof.stop()
        os.makedirs(self.trace_dir, exist_ok=True)
        path = os.path.join(
            self.trace_dir,
            "trace-{}-steps{}-{}.json".format(
                time.strftime("%Y%m%dT%H%M%SZ", time.gmtime()), self._first_step, step))
        prof.export_chrome_trace(path)
        self.trace_path = path

    def close(self, step: Optional[int] = None) -> None:
        """Stop an open window (an early end of the run, or an error) and
        write what it captured; ``step`` is the run's step count."""
        if self._prof is not None:
            self._stop(self.stop_step if step is None else step)


def step_annotation(name: str, step: int) -> torch.profiler.record_function:
    """Label host-side work for the profiler timeline (``<name>#<step>``)."""
    return torch.profiler.record_function(f"{name}#{step}")
