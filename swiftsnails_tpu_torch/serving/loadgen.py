"""Open-loop load generator: Poisson arrivals, zipf keys, honest queueing.

The JAX package's ``serving/loadgen.py``, copied: it is numpy only.

A closed-loop client (fire, wait, fire again) can never offer more load
than the system absorbs — when the servant slows down, the client slows
down with it and the measured latency silently excludes the queueing that
real, independent clients would have experienced (the "coordinated
omission" trap). This generator is **open-loop**: the arrival times are a
Poisson process drawn up front from the offered rate — closed-form offered
load ``E[arrivals] = qps x duration`` — and every request's latency is
measured from its *scheduled arrival*, not from when a worker got around
to sending it. An overloaded fleet therefore shows its queueing delay in
p99 instead of masking it as a lower achieved rate.

Keys follow a bounded zipf distribution (the skew every production trace
in PAPERS.md shows, and the one the JAX package's placement audit
measured): each
request samples an *anchor* rank and pulls that anchor's fixed id slice,
so a repeated anchor re-touches exactly the same rows — what makes
affinity routing's warm-LRU effect observable.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional

import numpy as np


def zipf_weights(n: int, a: float) -> np.ndarray:
    """Normalized zipf pmf over ranks ``0..n-1``: ``p(r) ~ 1/(r+1)^a``."""
    w = 1.0 / np.power(np.arange(1, n + 1, dtype=np.float64), a)
    return w / w.sum()


def anchor_ids(anchor: int, batch: int, id_space: int) -> np.ndarray:
    """The fixed id slice owned by ``anchor``: ``batch`` consecutive rows.

    Disjoint across anchors (for ``anchor < id_space // batch``), so each
    replica's hot-row LRU warms a clean per-anchor working set.
    """
    return (np.int64(anchor) * batch + np.arange(batch)) % id_space


def run_open_loop(
    submit: Callable[[int, np.ndarray], None],
    *,
    qps: float,
    duration_s: float,
    seed: int,
    id_space: int,
    batch: int = 8,
    zipf_a: float = 1.2,
    anchors: Optional[int] = None,
    workers: int = 64,
    clock: Callable[[], float] = time.monotonic,
) -> Dict:
    """Drive ``submit(anchor, ids)`` at ``qps`` for ``duration_s``.

    Deterministic given ``seed``: the arrival schedule and key sequence are
    drawn up front. ``workers`` bounds concurrency only — when all workers
    are busy a request starts late and its lateness is *charged to its
    latency* (open-loop accounting), never dropped.

    Returns offered/achieved QPS, scheduled-arrival latency percentiles,
    error counts by type, and late-start count.
    """
    rng = np.random.default_rng(seed)
    n_anchors = anchors if anchors is not None else max(id_space // batch, 1)
    n_req = max(int(rng.poisson(qps * duration_s)), 1)
    arrivals = np.sort(rng.uniform(0.0, duration_s, size=n_req))
    keys = rng.choice(n_anchors, size=n_req, p=zipf_weights(n_anchors, zipf_a))

    latencies = np.zeros(n_req, np.float64)
    ok = np.zeros(n_req, bool)
    errors: Dict[str, int] = {}
    late = [0]
    cursor = [0]
    lock = threading.Lock()
    t_start = clock()

    def worker() -> None:
        while True:
            with lock:
                i = cursor[0]
                if i >= n_req:
                    return
                cursor[0] = i + 1
            sched = t_start + arrivals[i]
            now = clock()
            if now < sched:
                time.sleep(sched - now)
            elif now - sched > 1e-3:
                with lock:
                    late[0] += 1
            anchor = int(keys[i])
            try:
                submit(anchor, anchor_ids(anchor, batch, id_space))
                done = clock()
                latencies[i] = (done - sched) * 1e3
                ok[i] = True
            except Exception as e:  # noqa: BLE001 — loadgen counts, never dies
                with lock:
                    name = type(e).__name__
                    errors[name] = errors.get(name, 0) + 1

    threads = [
        threading.Thread(target=worker, name=f"ssn-loadgen-{w}", daemon=True)
        for w in range(min(int(workers), n_req))
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=duration_s + 120.0)
    elapsed = max(clock() - t_start, 1e-9)

    lat = latencies[ok]
    n_ok = int(ok.sum())
    n_err = n_req - n_ok

    def pct(p: float) -> float:
        return round(float(np.percentile(lat, p)), 3) if n_ok else 0.0

    return {
        "offered_qps": round(float(qps), 3),
        "achieved_qps": round(n_ok / elapsed, 3),
        "requests": n_req,
        "completed": n_ok,
        "errors": n_err,
        "error_rate_pct": round(100.0 * n_err / n_req, 3),
        "error_types": dict(sorted(errors.items())),
        "late_starts": late[0],
        "duration_s": round(elapsed, 3),
        "mean_ms": round(float(lat.mean()), 3) if n_ok else 0.0,
        "p50_ms": pct(50.0),
        "p95_ms": pct(95.0),
        "p99_ms": pct(99.0),
        "max_ms": round(float(lat.max()), 3) if n_ok else 0.0,
    }
