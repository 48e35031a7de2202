"""Online drift sentinel: EWMA/CUSUM detectors + atomic incident bundles —
the JAX package's ``telemetry/drift.py``.

``ledger-report --check-regression`` catches a regression *between* bench
snapshots; nothing watches a live run for the slow-burn kind — step time
creeping 10% over an hour, tier hit rate sagging as the zipf head drifts,
exchange bytes growing after a placement change. This module is that
watcher:

* :class:`EwmaCusum` — one detector per signal. An EWMA tracks the
  signal's location and an EWMA of squared residuals its scale; each new
  sample's standardized residual feeds a two-sided CUSUM
  (``s = max(0, s + |z| - k)``); the drift is *confirmed* when the CUSUM
  statistic exceeds ``h``. The EWMA pair adapts to slow legitimate trends
  (warmup, LR decay) while the CUSUM accumulates only persistent
  excursions — a single slow step decays away, a sustained shift trips.
* :class:`DriftSentinel` — detectors over the five signals the training
  plane actually regresses on (step time, loss, exchange bytes, tier hit
  rate, prefetch stall), fed from the same samples the
  :class:`~swiftsnails_tpu_torch.telemetry.timeseries.TimeSeriesStore` takes.
  Confirmation is **transition-edged**: crossing from healthy to drifted
  emits exactly one ``drift`` ledger event (naming every tripped signal)
  and stays silent until :meth:`DriftSentinel.reset` — no event storm
  while the condition persists.
* :func:`build_incident_bundle` — capture-while-it-happens: one atomic
  directory holding the blackbox ring, the timeseries window, the
  config/env fingerprint, and the kept trace spans. Built in a staging
  dir and ``os.rename``\\ d into place, with collision-safe naming so a
  drift trigger and a NaN trip in the same second land as two distinct
  bundles, never one clobbered dir.

Everything is pure host arithmetic on already-sampled numbers; the hot
path pays nothing beyond the profiling cadence it already opted into.
"""

from __future__ import annotations

import json
import math
import os
import time
from typing import Dict, List, Optional, Sequence

# signal name -> metric key in the sampler's flat dict (the canonical five;
# the sentinel accepts any subset — a run without tiering simply never
# feeds tier_hit_rate)
DEFAULT_SIGNALS = (
    "step_ms",
    "loss",
    "exchange_bytes",
    "tier_hit_rate",
    "prefetch_stall_ms",
)


class EwmaCusum:
    """Two-sided CUSUM over EWMA-standardized residuals for one signal.

    ``alpha``   EWMA smoothing for mean/variance (higher adapts faster);
    ``k``       CUSUM slack in sigmas (excursions below ``k`` don't
                accumulate — absorbs ordinary noise);
    ``h``       decision threshold in accumulated sigmas;
    ``warmup``  samples used to seed mean/variance before the CUSUM arms
                (a cold detector would trip on the jit-compile step).
    """

    def __init__(self, name: str, alpha: float = 0.3, k: float = 1.0,
                 h: float = 6.0, warmup: int = 8):
        self.name = name
        self.alpha = float(alpha)
        self.k = float(k)
        self.h = float(h)
        self.warmup = max(int(warmup), 1)
        self.n = 0
        self.mean = 0.0
        self.var = 0.0
        self.stat = 0.0          # current CUSUM statistic (sigmas)
        self.peak = 0.0          # high-water mark (kept for the event)
        self.drifted = False
        self.drift_step: Optional[int] = None
        self.last = None

    def update(self, x: float, step: int = 0) -> bool:
        """Feed one sample; returns True on the sample that *confirms* a
        drift (the False->True edge only)."""
        x = float(x)
        if not math.isfinite(x):
            return False
        self.last = x
        self.n += 1
        if self.n <= 2:
            # the first sample is the cold-start/jit-compile step — an
            # outlier that would inflate the seeded variance by orders of
            # magnitude (and push real detections out by dozens of steps),
            # so it is discarded outright; the second sample seeds location
            self.mean = x
            return False
        resid = x - self.mean
        if self.n <= self.warmup + 1:
            # seed location/scale; CUSUM not armed yet
            self.mean += self.alpha * resid
            self.var += self.alpha * (resid * resid - self.var)
            return False
        sigma = math.sqrt(self.var) if self.var > 0 else 0.0
        if sigma <= 0:
            # flat warmup (e.g. constant gauge): any change is a unit shock
            sigma = abs(resid) or 1.0
        z = abs(resid) / sigma
        self.stat = max(0.0, self.stat + z - self.k)
        if self.stat > self.peak:
            self.peak = self.stat
        # adapt location/scale AFTER scoring, so a persistent shift keeps
        # accumulating for a few samples before the EWMA absorbs it
        self.mean += self.alpha * resid
        self.var += self.alpha * (resid * resid - self.var)
        if not self.drifted and self.stat >= self.h:
            self.drifted = True
            self.drift_step = int(step)
            return True
        return False

    def reset(self) -> None:
        """Re-arm after an incident (keeps the learned mean/variance)."""
        self.stat = 0.0
        self.peak = 0.0
        self.drifted = False
        self.drift_step = None

    def state(self) -> Dict:
        return {
            "signal": self.name,
            "n": self.n,
            "mean": self.mean,
            "sigma": math.sqrt(self.var) if self.var > 0 else 0.0,
            "stat": round(self.stat, 3),
            "peak": round(self.peak, 3),
            "last": self.last,
            "drifted": self.drifted,
            "drift_step": self.drift_step,
        }


class DriftSentinel:
    """Detectors over the training-plane signals, transition-edged.

    ``observe(step, signals)`` feeds every detector whose key appears in
    ``signals``. The sentinel-level state machine mirrors
    ``SloTracker._note_burn``: the healthy->drifted crossing appends one
    ``drift`` ledger event (best-effort, never raises into the loop) and
    returns the list of tripped signal names; while drifted, further
    confirmations accumulate into the same incident until :meth:`reset`.
    """

    def __init__(self, signals: Sequence[str] = DEFAULT_SIGNALS, *,
                 alpha: float = 0.3, k: float = 1.0, h: float = 6.0,
                 warmup: int = 8, ledger=None, context: Optional[Dict] = None):
        self.detectors: Dict[str, EwmaCusum] = {
            name: EwmaCusum(name, alpha=alpha, k=k, h=h, warmup=warmup)
            for name in signals
        }
        self._ledger = ledger
        self._context = dict(context or {})
        self.drifted = False
        self.events = 0           # drift ledger events emitted (edges)
        self.tripped: List[str] = []
        self.incidents: List[Dict] = []

    def observe(self, step: int, signals: Dict) -> List[str]:
        """Feed one sample row; returns newly-confirmed signal names
        (non-empty exactly when this call crossed the healthy->drifted
        edge or widened an open incident)."""
        confirmed = []
        for name, det in self.detectors.items():
            v = signals.get(name)
            if v is None:
                continue
            if det.update(v, step=step):
                confirmed.append(name)
        if not confirmed:
            return []
        newly = [n for n in confirmed if n not in self.tripped]
        self.tripped.extend(newly)
        if not self.drifted:
            # the transition edge: exactly one ledger event per incident
            self.drifted = True
            detail = {
                "step": int(step),
                "signals": list(confirmed),
                "detectors": [self.detectors[n].state() for n in confirmed],
            }
            detail.update(self._context)
            self.incidents.append(detail)
            self.events += 1
            if self._ledger is not None:
                try:
                    self._ledger.append("drift", detail)
                except Exception:
                    pass
        return confirmed

    def reset(self) -> None:
        """Close the incident and re-arm every detector."""
        self.drifted = False
        self.tripped = []
        for det in self.detectors.values():
            det.reset()

    def summary(self) -> Dict:
        return {
            "drifted": self.drifted,
            "events": self.events,
            "tripped": list(self.tripped),
            "detectors": {n: d.state() for n, d in self.detectors.items()},
        }


# ---------------------------------------------------------- incident bundle ---


BUNDLE_PREFIX = "incident"


def build_incident_bundle(directory, reason: str, *, blackbox=None,
                          timeseries=None, tracer=None,
                          context: Optional[Dict] = None,
                          extra: Optional[Dict] = None) -> str:
    """Capture one atomic incident directory; returns its path.

    Contents (each best-effort — a missing source is recorded as absent in
    the manifest, not an exception):

    * ``blackbox.json``    — the last-N-steps flight ring;
    * ``timeseries.jsonl`` — the profiling window, one sample per line;
    * ``fingerprint.json`` — config/env fingerprint + caller context;
    * ``traces.json``      — kept tracer spans (tail of the span ring);
    * ``manifest.json``    — reason, step range, file inventory.

    The bundle is staged under a hidden temp dir and ``os.rename``\\ d to
    ``incident-<UTCstamp>-<reason>``; on collision (two incidents in the
    same second — the drift + NaN interplay) a ``-2``/``-3``... suffix is
    tried, so bundles are always distinct directories.
    """
    from .ledger import env_fingerprint

    directory = os.fspath(directory)
    os.makedirs(directory, exist_ok=True)
    slug = "".join(c if (c.isalnum() or c in "-_") else "-" for c in reason)
    stamp = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
    staging = os.path.join(
        directory, f".{BUNDLE_PREFIX}-tmp-{os.getpid()}-{stamp}-{slug}")
    n = 2
    while os.path.exists(staging):
        staging = os.path.join(
            directory,
            f".{BUNDLE_PREFIX}-tmp-{os.getpid()}-{stamp}-{slug}-{n}")
        n += 1
    os.makedirs(staging)

    manifest: Dict = {
        "reason": reason,
        "created_utc": stamp,
        "files": [],
    }

    def _write(name: str, payload) -> None:
        path = os.path.join(staging, name)
        try:
            if name.endswith(".jsonl"):
                body = "".join(
                    json.dumps(r, sort_keys=True, default=str) + "\n"
                    for r in payload)
            else:
                body = json.dumps(payload, indent=2, sort_keys=True,
                                  default=str)
            with open(path, "w", encoding="utf-8") as f:
                f.write(body)
            manifest["files"].append(name)
        except Exception as e:  # pragma: no cover - defensive
            manifest.setdefault("errors", []).append(f"{name}: {e}")

    if blackbox is not None:
        try:
            ring = blackbox.snapshot()
        except Exception:
            ring = []
        _write("blackbox.json", ring)
        if ring:
            manifest["first_step"] = ring[0].get("step")
            manifest["last_step"] = ring[-1].get("step")
    if timeseries is not None:
        try:
            rows = timeseries.snapshot()
        except Exception:
            rows = []
        _write("timeseries.jsonl", rows)
        manifest["timeseries_samples"] = len(rows)
    fp: Dict = {"env": None, "context": dict(context or {})}
    try:
        fp["env"] = env_fingerprint(include_devices=True)
    except Exception:
        pass
    _write("fingerprint.json", fp)
    if tracer is not None:
        try:
            spans = tracer.events()[-256:]
        except Exception:
            spans = []
        _write("traces.json", spans)
    if extra:
        _write("extra.json", extra)
    _write("manifest.json", manifest)

    # atomic publish with collision-safe naming
    final = os.path.join(directory, f"{BUNDLE_PREFIX}-{stamp}-{slug}")
    n = 2
    while True:
        try:
            os.rename(staging, final)
            return final
        except OSError:
            if not os.path.exists(final):
                raise
            final = os.path.join(
                directory, f"{BUNDLE_PREFIX}-{stamp}-{slug}-{n}")
            n += 1


def bundle_complete(path) -> bool:
    """True when a bundle directory has the three load-bearing artifacts
    (timeseries window + blackbox + fingerprint) the drill gates on."""
    path = os.fspath(path)
    required = ("blackbox.json", "timeseries.jsonl", "fingerprint.json",
                "manifest.json")
    return all(os.path.exists(os.path.join(path, f)) for f in required)
