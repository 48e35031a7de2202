"""Telemetry of a training run — the run-side half of the JAX package's
``telemetry/`` (docs/OBSERVABILITY.md there):

* :mod:`~swiftsnails_tpu_torch.telemetry.tracer` — host-side nestable spans
  with Chrome trace-event export; step spans open ``record_function`` (and
  NVTX on the card) ranges that a ``profile_dir`` capture lines up with the
  kernels;
* :mod:`~swiftsnails_tpu_torch.telemetry.registry` — named counters /
  gauges / histograms flushed through pluggable sinks
  (:class:`~swiftsnails_tpu_torch.utils.metrics.MetricsLogger` is the JSONL
  sink; :class:`StdoutSummarySink` the terminal one);
* :mod:`~swiftsnails_tpu_torch.telemetry.ledger` — the durable append-only
  JSONL run ledger, its report, failure timeline, ``--diff`` and regression
  gate (``ledger-report``);
* :mod:`~swiftsnails_tpu_torch.telemetry.goodput` — MFU, step-time
  decomposition, words/sec-vs-roofline, with H100 rows in its peak table;
  the FLOP and byte counts come from :meth:`Trainer.step_cost`;
* :mod:`~swiftsnails_tpu_torch.telemetry.blackbox` — bounded ring of the
  last N steps, dumped on exception, NaN/Inf loss, SIGTERM and a guardrail
  give-up;
* :mod:`~swiftsnails_tpu_torch.telemetry.timeseries` — continuous
  profiling (``profile_cadence``);
* :mod:`~swiftsnails_tpu_torch.telemetry.drift` — the drift sentinel and
  incident bundles (``drift_detect``), with its drill in
  :mod:`~swiftsnails_tpu_torch.telemetry.drift_lane`;
* :mod:`~swiftsnails_tpu_torch.telemetry.summary` — the ``trace-summary``
  reader;
* the serving plane's request traces
  (:mod:`~swiftsnails_tpu_torch.telemetry.request_trace`), SLO tracker
  (:mod:`~swiftsnails_tpu_torch.telemetry.slo`) and ops dashboard
  (:mod:`~swiftsnails_tpu_torch.telemetry.ops`).

Not ported (``ROADMAP.md``): ``audit.py`` (XLA's HLO audit has no torch
counterpart; ``step_cost`` counts instead).

Off by default: the TrainLoop only constructs these when the ``telemetry``
or ``trace_path`` config keys are set (the ledger with ``ledger_path``), and
its hot path pays one enabled-flag check otherwise.
"""

from swiftsnails_tpu_torch.telemetry.blackbox import BlackBox
from swiftsnails_tpu_torch.telemetry.drift import (
    DriftSentinel,
    EwmaCusum,
    build_incident_bundle,
    bundle_complete,
)
from swiftsnails_tpu_torch.telemetry.goodput import (
    goodput_report,
    peaks_for,
    step_time_decomposition,
    throughput_attribution,
)
from swiftsnails_tpu_torch.telemetry.ledger import Ledger, config_hash, env_fingerprint
from swiftsnails_tpu_torch.telemetry.registry import (
    Counter,
    Gauge,
    Histogram,
    MetricRegistry,
    StdoutSummarySink,
)
from swiftsnails_tpu_torch.telemetry.summary import summarize_file
from swiftsnails_tpu_torch.telemetry.timeseries import (
    TimeSeriesStore,
    render_sparklines,
    sparkline,
)
from swiftsnails_tpu_torch.telemetry.tracer import Tracer

# the JSONL sink IS the existing MetricsLogger (same ``log``/``close``
# surface) — imported under the sink name so call sites read as intended
from swiftsnails_tpu_torch.utils.metrics import MetricsLogger as JsonlSink

__all__ = [
    "Tracer",
    "MetricRegistry",
    "Counter",
    "Gauge",
    "Histogram",
    "JsonlSink",
    "StdoutSummarySink",
    "BlackBox",
    "Ledger",
    "TimeSeriesStore",
    "DriftSentinel",
    "EwmaCusum",
    "build_incident_bundle",
    "bundle_complete",
    "render_sparklines",
    "sparkline",
    "throughput_attribution",
    "config_hash",
    "env_fingerprint",
    "goodput_report",
    "peaks_for",
    "step_time_decomposition",
    "summarize_file",
]
