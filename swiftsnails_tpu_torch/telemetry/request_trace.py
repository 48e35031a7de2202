"""Request-scoped distributed tracing: per-request span trees with

The JAX package's ``telemetry/request_trace.py``, copied: it is pure
Python, and one ``seed`` mints the same trace ids in both packages.
deterministic head sampling and always-keep tail sampling for anomalies.

The aggregate gauges (``telemetry/registry.py``) say *how often*; a request
trace says *why this one*. Each request gets a :class:`RequestContext` —
a ``trace_id`` / per-span ids / parent links plus propagable baggage — and
the read path hangs bounded child spans off it (queue wait, kernel time,
hedge attempts, re-route hops, delta apply/cutover). Capture is decided
twice:

* **head sampling** — deterministic from the trace id alone
  (``trace_sample_rate``), so the publish side and the apply side of a
  delta batch, or any two processes a trace id travels between, make the
  same keep/drop call with no coordination;
* **tail keep** — a request that turned out *interesting* (typed failure,
  hedge fired, re-route hop, degraded hit, latency over SLO, freshness
  fallback) is kept regardless (``trace_anomaly_keep``), so the traces
  you actually want to read are never sampled away.

Kept traces land in a bounded ring (oldest evicted first) and export as
JSONL (one trace per line) or as a Chrome trace — ``ph:"X"`` complete
events with the ``trace_id`` in ``args`` — that the existing
``trace-summary`` CLI (:mod:`swiftsnails_tpu_torch.telemetry.summary`) renders
unchanged.

Tracing never blocks or fails the serve path: span capture is a few list
appends under a lock, everything else is ``try/except`` best-effort, and
with no tracer attached the instrumentation reduces to one ``None`` check
per request.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

__all__ = [
    "ANOMALY_KINDS",
    "RequestContext",
    "RequestTracer",
    "current",
    "use",
]

# Every way a request can turn out interesting enough for tail-keep.
ANOMALY_KINDS = (
    "typed_failure",   # Unavailable / Overloaded / dispatch exception
    "hedge",           # a hedge leg was fired
    "reroute",         # the request walked to another replica
    "degraded",        # served stale from the degraded LRU
    "slo_violation",   # latency over the kernel's SLO
    "fallback",        # freshness gap -> full checkpoint reload
    "shed",            # load-shed / queue-full rejection
)

_DEFAULT_MAX_SPANS = 64
_DEFAULT_CAPACITY = 256
_SAMPLE_DENOM = 1 << 24


def _mix64(x: int) -> int:
    """splitmix64 finalizer: cheap, well-distributed 64-bit mixing."""
    x = (x + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return x ^ (x >> 31)


# -- thread-local context propagation ----------------------------------------

_tls = threading.local()


def current() -> Optional["RequestContext"]:
    """The request context active on this thread, if any."""
    return getattr(_tls, "ctx", None)


class use:
    """Activate ``ctx`` on this thread for the ``with`` body (restores the
    previous context on exit). How the fleet carries a request's context
    onto its worker-pool legs."""

    __slots__ = ("_ctx", "_prev")

    def __init__(self, ctx: Optional["RequestContext"]):
        self._ctx = ctx
        self._prev = None

    def __enter__(self) -> Optional["RequestContext"]:
        self._prev = getattr(_tls, "ctx", None)
        _tls.ctx = self._ctx
        return self._ctx

    def __exit__(self, *exc) -> None:
        _tls.ctx = self._prev


# -- the per-request context --------------------------------------------------


class _SpanHandle:
    """Context manager for one live span inside a :class:`RequestContext`."""

    __slots__ = ("_ctx", "_name", "_args", "_t0", "_sid", "_parent")

    def __init__(self, ctx: "RequestContext", name: str, args: Dict):
        self._ctx = ctx
        self._name = name
        self._args = args
        self._t0 = 0
        self._sid = 0
        self._parent = 0

    def __enter__(self) -> "_SpanHandle":
        ctx = self._ctx
        self._parent = ctx._thread_parent()
        self._sid = ctx._new_span_id()
        ctx._push(self._sid)
        self._t0 = ctx._clock_ns()
        return self

    def set(self, **kv) -> None:
        """Attach args to the live span (outcome fields, counts)."""
        self._args.update(kv)

    def __exit__(self, exc_type, exc, tb) -> None:
        ctx = self._ctx
        dur = ctx._clock_ns() - self._t0
        ctx._pop(self._sid)
        if exc_type is not None:
            self._args.setdefault("error", exc_type.__name__)
        ctx._record(self._name, self._t0, dur, self._sid, self._parent,
                    self._args)


class RequestContext:
    """One request's trace: a bounded span tree plus baggage/annotations.

    Thread-safe — fleet hedge legs append spans from pool threads while the
    request thread owns the root. Parent linkage is per-thread: a span
    opened on a thread nests under that thread's innermost open span, or
    under the root when the thread has none (a fresh hedge leg).
    """

    __slots__ = (
        "trace_id", "kernel", "sampled", "resumed", "baggage",
        "annotations", "anomalies", "spans", "dropped_spans",
        "t0_ns", "dur_ns", "ts_unix_ns", "root_span_id",
        "_max_spans", "_clock_ns", "_next_sid", "_lock", "_stacks",
    )

    def __init__(
        self,
        trace_id: str,
        kernel: str,
        *,
        sampled: bool = False,
        resumed: bool = False,
        parent_span_id: int = 0,
        baggage: Optional[Dict[str, Any]] = None,
        max_spans: int = _DEFAULT_MAX_SPANS,
        clock_ns: Callable[[], int] = time.perf_counter_ns,
    ):
        self.trace_id = trace_id
        self.kernel = kernel
        self.sampled = bool(sampled)
        self.resumed = bool(resumed)
        self.baggage: Dict[str, Any] = dict(baggage or {})
        self.annotations: Dict[str, Any] = {}
        self.anomalies: List[str] = []
        # recorded spans: (name, t0_ns, dur_ns, span_id, parent_id, args)
        self.spans: List[Tuple[str, int, int, int, int, Dict]] = []
        self.dropped_spans = 0
        self.ts_unix_ns = time.time_ns()
        self._max_spans = int(max_spans)
        self._clock_ns = clock_ns
        self._lock = threading.Lock()
        self._stacks = threading.local()
        self._next_sid = 1
        # Root span: id 1 locally, or the remote parent when resumed so the
        # tree stitches together across the wire.
        self.root_span_id = self._new_span_id()
        if resumed and parent_span_id:
            self.root_span_id = int(parent_span_id)
        self.t0_ns = clock_ns()
        self.dur_ns = 0

    # -- span recording -------------------------------------------------

    def _new_span_id(self) -> int:
        with self._lock:
            sid = self._next_sid
            self._next_sid += 1
        return sid

    def _stack(self) -> List[int]:
        st = getattr(self._stacks, "stack", None)
        if st is None:
            st = self._stacks.stack = []
        return st

    def _thread_parent(self) -> int:
        st = self._stack()
        return st[-1] if st else self.root_span_id

    def _push(self, sid: int) -> None:
        self._stack().append(sid)

    def _pop(self, sid: int) -> None:
        st = self._stack()
        if st and st[-1] == sid:
            st.pop()

    def _record(self, name, t0_ns, dur_ns, sid, parent, args) -> None:
        with self._lock:
            if len(self.spans) >= self._max_spans:
                self.dropped_spans += 1
                return
            self.spans.append((name, int(t0_ns), int(dur_ns), sid, parent,
                               args))

    def span(self, name: str, **args) -> _SpanHandle:
        """Open a child span; nests under this thread's innermost span."""
        return _SpanHandle(self, name, args)

    def add_span(self, name: str, t0_ns: int, dur_ns: int,
                 parent: Optional[int] = None, **args) -> None:
        """Record a span retroactively from explicit timestamps — how the
        engine attributes queue-wait and batch kernel time measured on the
        dispatcher thread without touching the context from it."""
        if parent is None:
            parent = self._thread_parent()
        self._record(name, t0_ns, max(0, int(dur_ns)), self._new_span_id(),
                     parent, args)

    # -- annotation ------------------------------------------------------

    def annotate(self, **kv) -> None:
        """Attach request-level facts (cache hits, table version, winner)."""
        with self._lock:
            self.annotations.update(kv)

    def mark_anomaly(self, kind: str) -> None:
        """Flag the request for tail-keep; idempotent per kind."""
        with self._lock:
            if kind not in self.anomalies:
                self.anomalies.append(kind)

    @property
    def anomalous(self) -> bool:
        return bool(self.anomalies)

    # -- wire propagation ------------------------------------------------

    def wire(self) -> Dict[str, Any]:
        """The propagable form: what travels in a delta-batch header (or,
        later, an RPC header) so the far side continues this trace."""
        out: Dict[str, Any] = {
            "trace_id": self.trace_id,
            "span_id": self._thread_parent(),
        }
        if self.baggage:
            out["baggage"] = dict(self.baggage)
        return out

    # -- export ----------------------------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        with self._lock:
            spans = [
                {"name": n, "t0_us": t0 // 1000, "dur_us": d // 1000,
                 "span_id": sid, "parent": par, "args": dict(a)}
                for n, t0, d, sid, par, a in self.spans
            ]
            return {
                "trace_id": self.trace_id,
                "kernel": self.kernel,
                "ts_unix_ns": self.ts_unix_ns,
                "dur_ms": round(self.dur_ns / 1e6, 3),
                "sampled": self.sampled,
                "resumed": self.resumed,
                "anomalies": list(self.anomalies),
                "baggage": dict(self.baggage),
                "annotations": dict(self.annotations),
                "dropped_spans": self.dropped_spans,
                "spans": spans,
            }


# -- the capture engine -------------------------------------------------------


class RequestTracer:
    """Per-process trace capture: mints contexts, applies the sampling
    policy at :meth:`finish`, and ring-buffers kept traces.

    ``sample_rate`` is the head-sampling probability; the decision is a
    pure function of the trace id, so every process that sees the same id
    agrees. ``anomaly_keep`` retains any trace that marked an anomaly.
    ``slo_ms`` (scalar or per-kernel dict) auto-marks ``slo_violation``
    on finish. ``seed`` makes the minted id sequence — and therefore the
    head-sampling pattern — deterministic for drills and tests.
    """

    def __init__(
        self,
        sample_rate: float = 0.0,
        *,
        anomaly_keep: bool = True,
        capacity: int = _DEFAULT_CAPACITY,
        slo_ms: Any = None,
        seed: int = 0,
        max_spans: int = _DEFAULT_MAX_SPANS,
        clock_ns: Callable[[], int] = time.perf_counter_ns,
        ledger=None,
        source: str = "serving",
    ):
        self.sample_rate = max(0.0, min(1.0, float(sample_rate)))
        self.anomaly_keep = bool(anomaly_keep)
        self.slo_ms = slo_ms
        self.seed = int(seed)
        self.ledger = ledger
        self.source = source
        self.max_spans = int(max_spans)
        self._clock_ns = clock_ns
        self._lock = threading.Lock()
        self._counter = 0
        self._kept: deque = deque(maxlen=max(1, int(capacity)))
        self._stats = {
            "started": 0, "finished": 0, "sampled": 0, "kept": 0,
            "anomalies": 0, "dropped": 0, "resumed": 0,
        }

    @classmethod
    def from_config(cls, config, *, seed: Optional[int] = None,
                    slo_ms: Any = None, ledger=None,
                    source: str = "serving") -> Optional["RequestTracer"]:
        """Build from typed config keys, or ``None`` when tracing is off.

        ``trace_sample_rate`` > 0 enables head sampling;
        ``trace_anomaly_keep`` (default: on whenever sampling is on)
        enables tail-keep alone even at rate 0. Both absent/zero -> no
        tracer, and the serve path pays one ``None`` check."""
        rate = config.get_float("trace_sample_rate", 0.0)
        keep = config.get_bool("trace_anomaly_keep", rate > 0)
        if rate <= 0 and not keep:
            return None
        if slo_ms is None:
            lat = config.get_float("slo_latency_ms", 0.0)
            slo_ms = lat if lat > 0 else None
        return cls(
            rate, anomaly_keep=keep, slo_ms=slo_ms,
            seed=config.get_int("seed", 0) if seed is None else seed,
            ledger=ledger, source=source,
        )

    # -- minting / sampling ---------------------------------------------

    def _mint_id(self) -> str:
        with self._lock:
            self._counter += 1
            n = self._counter
        return f"{_mix64((self.seed << 32) ^ n):016x}"

    def head_sampled(self, trace_id: str) -> bool:
        """Deterministic head-sampling decision from the id alone."""
        if self.sample_rate >= 1.0:
            return True
        if self.sample_rate <= 0.0:
            return False
        try:
            h = _mix64(int(trace_id, 16))
        except (TypeError, ValueError):
            return False
        return (h % _SAMPLE_DENOM) < int(self.sample_rate * _SAMPLE_DENOM)

    def start(self, kernel: str, **baggage) -> RequestContext:
        """Mint a fresh trace for a request entering the plane here."""
        trace_id = self._mint_id()
        ctx = RequestContext(
            trace_id, kernel,
            sampled=self.head_sampled(trace_id),
            baggage=baggage or None,
            max_spans=self.max_spans, clock_ns=self._clock_ns,
        )
        with self._lock:
            self._stats["started"] += 1
            if ctx.sampled:
                self._stats["sampled"] += 1
        return ctx

    def resume(self, wire: Optional[Dict[str, Any]], kernel: str,
               **baggage) -> RequestContext:
        """Continue a trace that arrived over a wire (delta-batch header).
        Falls back to :meth:`start` when the wire form is absent/garbled,
        so a pre-tracing publisher still yields usable apply traces."""
        trace_id = None
        parent = 0
        if isinstance(wire, dict):
            trace_id = wire.get("trace_id")
            try:
                parent = int(wire.get("span_id") or 0)
            except (TypeError, ValueError):
                parent = 0
            inherited = wire.get("baggage")
            if isinstance(inherited, dict):
                merged = dict(inherited)
                merged.update(baggage)
                baggage = merged
        if not isinstance(trace_id, str) or not trace_id:
            return self.start(kernel, **baggage)
        ctx = RequestContext(
            trace_id, kernel,
            sampled=self.head_sampled(trace_id),
            resumed=True, parent_span_id=parent,
            baggage=baggage or None,
            max_spans=self.max_spans, clock_ns=self._clock_ns,
        )
        with self._lock:
            self._stats["started"] += 1
            self._stats["resumed"] += 1
            if ctx.sampled:
                self._stats["sampled"] += 1
        return ctx

    # -- finish / keep ---------------------------------------------------

    def _slo_for(self, kernel: str) -> Optional[float]:
        slo = self.slo_ms
        if slo is None:
            return None
        if isinstance(slo, dict):
            v = slo.get(kernel)
            return float(v) if v is not None else None
        return float(slo)

    def finish(self, ctx: RequestContext,
               error: Optional[BaseException] = None) -> bool:
        """Close the trace; returns True when it was kept."""
        ctx.dur_ns = max(0, self._clock_ns() - ctx.t0_ns)
        if error is not None:
            ctx.mark_anomaly("typed_failure")
            ctx.annotate(error=type(error).__name__)
        slo = self._slo_for(ctx.kernel)
        if slo is not None and ctx.dur_ns / 1e6 > slo:
            ctx.mark_anomaly("slo_violation")
        ctx._record("request", ctx.t0_ns, ctx.dur_ns, ctx.root_span_id, 0,
                    {"kernel": ctx.kernel})
        keep = ctx.sampled or (self.anomaly_keep and ctx.anomalous)
        n_anom = 0
        with self._lock:
            self._stats["finished"] += 1
            if ctx.anomalous:
                self._stats["anomalies"] += 1
                n_anom = self._stats["anomalies"]
            if keep:
                self._stats["kept"] += 1
                self._kept.append(ctx)
            else:
                self._stats["dropped"] += 1
        # rate-limited trace_anomaly ledger stream (first + every 100th),
        # each line naming a trace_id still retrievable from the ring
        if (keep and n_anom and self.ledger is not None
                and (n_anom == 1 or n_anom % 100 == 0)):
            try:
                self.ledger.append("trace_anomaly", {
                    "source": self.source,
                    "trace_id": ctx.trace_id,
                    "kernel": ctx.kernel,
                    "anomalies": list(ctx.anomalies),
                    "dur_ms": round(ctx.dur_ns / 1e6, 3),
                    "anomalies_total": n_anom,
                })
            except Exception:
                pass  # record-keeping never blocks the serve path
        return keep

    # -- retrieval -------------------------------------------------------

    def traces(self) -> List[RequestContext]:
        with self._lock:
            return list(self._kept)

    def get(self, trace_id: str) -> Optional[RequestContext]:
        with self._lock:
            for ctx in reversed(self._kept):
                if ctx.trace_id == trace_id:
                    return ctx
        return None

    def anomaly_traces(self, n: Optional[int] = None) -> List[RequestContext]:
        """Most-recent-last anomaly traces (the ops-report feed)."""
        out = [c for c in self.traces() if c.anomalous]
        return out[-n:] if n else out

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            out = dict(self._stats)
        out["ring"] = len(self._kept)
        out["sample_rate"] = self.sample_rate
        out["anomaly_keep"] = self.anomaly_keep
        return out

    # -- export ----------------------------------------------------------

    def export_jsonl(self, path: str) -> int:
        """One kept trace per line; returns the count written. The
        ``trace-summary`` CLI renders this file directly (it treats each
        line's ``dur_ms`` like any JSONL record stream)."""
        traces = self.traces()
        with open(path, "w", encoding="utf-8") as f:
            for ctx in traces:
                f.write(json.dumps(ctx.to_dict()) + "\n")
        return len(traces)

    def chrome_trace(self, trace_id: Optional[str] = None) -> Dict[str, Any]:
        """Chrome trace-event JSON of the kept ring (or one trace).
        Same shape :class:`~swiftsnails_tpu_torch.telemetry.tracer.Tracer`
        emits, so ``trace-summary`` and chrome://tracing both read it;
        every span carries its ``trace_id`` in ``args``."""
        traces = self.traces()
        if trace_id is not None:
            traces = [c for c in traces if c.trace_id == trace_id]
        events: List[Dict[str, Any]] = [{
            "name": "process_name", "ph": "M", "pid": 0, "tid": 0,
            "args": {"name": "swiftsnails-requests"},
        }]
        base = min((c.t0_ns for c in traces), default=0)
        for tid, ctx in enumerate(traces, start=1):
            snap = ctx.to_dict()
            for s in snap["spans"]:
                args = dict(s["args"])
                args["trace_id"] = ctx.trace_id
                if s["name"] == "request":
                    args["kernel"] = ctx.kernel
                    if snap["anomalies"]:
                        args["anomalies"] = snap["anomalies"]
                events.append({
                    "name": s["name"], "ph": "X", "pid": 0, "tid": tid,
                    "ts": s["t0_us"] - base // 1000, "dur": s["dur_us"],
                    "args": args,
                })
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def export_chrome(self, path: str,
                      trace_id: Optional[str] = None) -> None:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.chrome_trace(trace_id), f)


# -- trace-tree verification --------------------------------------------------


def tree_complete(trace: Dict[str, Any],
                  require: Tuple[str, ...] = ()) -> bool:
    """True when a trace dict (``RequestContext.to_dict()`` shape) is a
    *complete* tree: has a root ``request`` span, every span's parent
    resolves, and every span name in ``require`` appears. The chaos drills
    use this to assert causality is drillable, not just counted."""
    spans = trace.get("spans") or []
    ids = {s.get("span_id") for s in spans}
    roots = [s for s in spans if s.get("name") == "request"]
    if not roots:
        return False
    root_ids = {s.get("span_id") for s in roots}
    for s in spans:
        par = s.get("parent", 0)
        if par and par not in ids and par not in root_ids:
            return False
    names = {s.get("name") for s in spans}
    return all(r in names for r in require)
