"""Host-side span tracer with Chrome trace-event export — the JAX
package's ``telemetry/tracer.py``.

The reference's only timeline instrumentation was glog timestamps and a
chrono ``Timer`` (SURVEY §5). This tracer answers "where did this step's
time go" on the host side: nestable spans (per-thread stacks), thread-safe
recording, and export to the Chrome/Perfetto trace-event JSON format, so a
``trace_path`` file drops straight into ``chrome://tracing`` / ui.perfetto.dev
— or into ``python -m swiftsnails_tpu_torch trace-summary`` for a terminal
breakdown.

Device-side alignment: :meth:`Tracer.step_span` opens the host span inside
a ``torch.profiler.record_function("<name>#<step>")`` range and, with
``nvtx`` (a run on the card), an NVTX range of the same name, so when a
``profile_dir`` capture runs concurrently (``utils/profiling.py``), the host
spans and the CUDA kernels carry the same step numbers and line up in the
combined view.

Cost contract: a Tracer only exists when telemetry is enabled (the TrainLoop
holds ``None`` otherwise and branches once per step). Recording one span is
one ``perf_counter_ns`` pair, one small tuple, and one lock-guarded append;
a step span adds the ``record_function`` range (and the NVTX push/pop).
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch

# event tuples: (name, ts_ns, dur_ns, tid, depth, args_or_None) for "X"
# spans; counters are recorded separately as (name, ts_ns, value, tid).
_Event = Tuple[str, int, int, int, int, Optional[Dict]]


class _SpanCtx:
    """Reusable-shape context manager recording one complete ("X") event."""

    __slots__ = ("_tracer", "_name", "_args", "_t0", "_depth")

    def __init__(self, tracer: "Tracer", name: str, args: Optional[Dict]):
        self._tracer = tracer
        self._name = name
        self._args = args

    def __enter__(self) -> "_SpanCtx":
        tls = self._tracer._tls
        self._depth = getattr(tls, "depth", 0)
        tls.depth = self._depth + 1
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        t1 = time.perf_counter_ns()
        self._tracer._tls.depth = self._depth
        self._tracer._record(
            (self._name, self._t0, t1 - self._t0, threading.get_ident(),
             self._depth, self._args)
        )


class _StepSpanCtx:
    """Host span + ``record_function("<name>#<step>")`` (+ an NVTX range of
    the same name with ``nvtx``) for device alignment."""

    __slots__ = ("_span", "_ann", "_nvtx_name")

    def __init__(self, tracer: "Tracer", name: str, step: int):
        self._span = _SpanCtx(tracer, name, {"step": step})
        label = f"{name}#{step}"
        self._ann = torch.profiler.record_function(label)
        self._nvtx_name = label if tracer.nvtx else None

    def __enter__(self) -> "_StepSpanCtx":
        if self._nvtx_name is not None:
            torch.cuda.nvtx.range_push(self._nvtx_name)
        self._ann.__enter__()
        self._span.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self._span.__exit__(*exc)
        self._ann.__exit__(*exc)
        if self._nvtx_name is not None:
            torch.cuda.nvtx.range_pop()


class Tracer:
    """Thread-safe span recorder with Chrome trace-event JSON export.

    ``path`` (optional): where :meth:`close` writes the trace. Spans nest per
    thread; concurrent threads (e.g. the prefetcher) record independently and
    render as separate tracks. ``nvtx``: step spans also push an NVTX range
    (a run on the card only: the CPU build of torch has no NVTX).
    """

    def __init__(self, path: Optional[str] = None,
                 process_name: str = "swiftsnails_tpu_torch", nvtx: bool = False):
        self.path = path
        self.process_name = process_name
        self.nvtx = bool(nvtx)
        self._events: List[_Event] = []
        self._counters: List[Tuple[str, int, float, int]] = []
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._epoch_ns = time.perf_counter_ns()
        self._closed = False

    # -- recording ---------------------------------------------------------

    def span(self, name: str, **args) -> _SpanCtx:
        """Open a nestable span: ``with tracer.span("h2d"): ...``"""
        return _SpanCtx(self, name, args or None)

    def step_span(self, name: str, step: int) -> _StepSpanCtx:
        """A span that also labels the device timeline with the step number."""
        return _StepSpanCtx(self, name, step)

    def counter(self, name: str, value: float) -> None:
        """Record an instantaneous counter sample (Chrome "C" event)."""
        with self._lock:
            self._counters.append(
                (name, time.perf_counter_ns(), float(value), threading.get_ident())
            )

    def _record(self, event: _Event) -> None:
        with self._lock:
            self._events.append(event)

    # -- export ------------------------------------------------------------

    def events(self, start: int = 0) -> List[Dict]:
        """The recorded spans as dicts (name, ts_us, dur_us, tid, depth,
        args), from index ``start`` on — the continuous profiler reads only
        its window this way, instead of re-converting the whole run's spans
        every sample."""
        with self._lock:
            snap = self._events[start:]
        return [
            {
                "name": name,
                "ts_us": (t0 - self._epoch_ns) / 1e3,
                "dur_us": dur / 1e3,
                "tid": tid,
                "depth": depth,
                "args": args or {},
            }
            for name, t0, dur, tid, depth, args in snap
        ]

    def chrome_trace(self) -> Dict:
        """The trace as a Chrome trace-event object (``traceEvents`` list)."""
        pid = os.getpid()
        with self._lock:
            spans = list(self._events)
            counters = list(self._counters)
        events: List[Dict] = [
            {
                "ph": "M",
                "pid": pid,
                "name": "process_name",
                "args": {"name": self.process_name},
            }
        ]
        for name, t0, dur, tid, depth, args in spans:
            ev = {
                "ph": "X",
                "pid": pid,
                "tid": tid,
                "name": name,
                "cat": "host",
                "ts": (t0 - self._epoch_ns) / 1e3,  # microseconds
                "dur": dur / 1e3,
            }
            if args:
                ev["args"] = args
            events.append(ev)
        for name, t0, value, tid in counters:
            events.append(
                {
                    "ph": "C",
                    "pid": pid,
                    "tid": tid,
                    "name": name,
                    "ts": (t0 - self._epoch_ns) / 1e3,
                    "args": {"value": value},
                }
            )
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def export(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.chrome_trace(), f)

    def close(self) -> None:
        """Finalize: write the trace to ``path`` (idempotent, keeps events)."""
        if self._closed:
            return
        if self.path:
            self.export(self.path)
        self._closed = True
