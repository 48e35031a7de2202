"""The bench ``chaos-serve`` lane: an availability drill on the read path —
the JAX package's ``serving/chaos_lane.py``, with the port's trainer,
checkpoints, ``Servant`` and tier, on ``device`` (default: the card).

One implementation used by ``python -m swiftsnails_tpu_torch.tools.chaos_drill
--serve``, ``chip_smoke.py``'s ``cluster`` phase and the port's tests. It loads a
tiny verified word2vec checkpoint into a live :class:`Servant` and runs a
seeded :class:`~swiftsnails_tpu_torch.resilience.chaos.ChaosPlan` fault matrix
(``serve_io_error`` storms + ``serve_slow`` stalls via the Servant's
``fault_hook``) against it twice:

* **protected leg** — circuit breakers + degraded stale-LRU reads on. The
  lane measures availability % (fresh + degraded serves over all requests),
  degraded-hit share, p99 latency under fault, and the breaker trip /
  recover latencies.
* **unprotected control leg** — breakers and degraded mode disabled; the
  same fault schedule must produce a *hard failure* (an unhandled dispatch
  error reaching the caller). A control that survives means the matrix is
  not actually exercising the serve path, so the gate fails it.

Two more drills ride along: ``reload_corrupt`` (the newest checkpoint is
corrupted on disk, then a live reload is requested — the shadow-verify swap
must reject it and keep the old version serving) and, when requested, the
``tier_bitflip`` recovery drill from :mod:`swiftsnails_tpu_torch.resilience.drill`.

Availability under fault is correctness, not device speed, so the lane is
valid on CPU; the block lands in the bench JSON (``chaos_serve``), the run
ledger, and the ``ledger-report --check-regression`` gate on ANY platform.
"""

from __future__ import annotations

import os
import tempfile
import time
from typing import Dict, Optional

import numpy as np

from swiftsnails_tpu_torch.serving.bench_lane import SERVE_SEED
from swiftsnails_tpu_torch.utils.device import DeviceLike

AVAILABILITY_FLOOR_PCT = 99.0
_SLOW_MS = 25.0


def _build_checkpoint(root: str, dim: int, capacity: int, device: DeviceLike = None):
    """Init and save a verified packed word2vec checkpoint; returns the
    serving config AND the trainer/state (the reload drill needs to write a
    second, newer checkpoint into the same root)."""
    from swiftsnails_tpu_torch.framework.checkpoint import save_checkpoint
    from swiftsnails_tpu_torch.framework.quality import paired_corpus
    from swiftsnails_tpu_torch.models.word2vec import Word2VecTrainer
    from swiftsnails_tpu_torch.utils.config import Config

    ids, vocab = paired_corpus(n_pairs=32, reps=4, seed=SERVE_SEED)
    cfg = Config({
        "dim": str(dim), "capacity": str(capacity), "packed": "1",
        "seed": str(SERVE_SEED), "subsample": "0",
    })
    trainer = Word2VecTrainer(cfg, corpus_ids=ids, vocab=vocab, device=device)
    state = trainer.init_state()
    save_checkpoint(root, state, step=1, wait=True)
    return cfg, state


def _fault_hook(plan, slow_ms: float = _SLOW_MS):
    """Servant ``fault_hook`` driven by the plan's serve schedule: the hook
    fires once per dispatched batch, indexed per kernel."""

    def hook(kernel: str, index: int) -> None:
        kind = plan.serve_fault(index)
        if kind == "serve_io_error":
            raise OSError(f"chaos: injected {kernel} read error @{index}")
        if kind == "serve_slow":
            time.sleep(slow_ms / 1e3)

    return hook


def _drive_leg(servant, plan, hot: np.ndarray, requests: int,
               cooldown_ms: float, slow_ms: float = _SLOW_MS) -> Dict:
    """Fire ``requests`` pulls over the ``hot`` id set under the plan's
    fault schedule; every request is tallied as fresh, degraded, or failed.
    The stale-LRU inventory was warmed (and version-bumped) by the caller,
    so each pull goes through dispatch — and through the fault hook —
    unless the breaker short-circuits it to a degraded serve."""
    from swiftsnails_tpu_torch.serving.breaker import Unavailable

    servant.fault_hook = _fault_hook(plan, slow_ms=slow_ms)
    reg = servant.registry
    degraded0 = int(reg.counter("serve.degraded_hits").value)
    served = failed = 0
    first_error: Optional[str] = None
    t_first_fault = None
    t_trip = None
    br = servant.breakers.get("pull")
    for n in range(requests):
        trips_before = br.trips if br is not None else 0
        deg_before = int(reg.counter("serve.pull.degraded").value)
        try:
            servant.pull(hot)
            served += 1
        except (Unavailable, OSError, RuntimeError) as e:
            failed += 1
            if first_error is None:
                first_error = f"{type(e).__name__}: {e}"
        now = time.perf_counter()
        if t_first_fault is None and (
                failed
                or int(reg.counter("serve.pull.degraded").value) > deg_before):
            # first visible fault effect — a shed OR a degraded fallback
            # (the dispatch failed even though the caller was served)
            t_first_fault = now
        if br is not None and br.trips > trips_before and t_trip is None:
            t_trip = now
            if t_first_fault is None:
                t_first_fault = now
    # recovery phase: faults exhausted — wait out the cooldown and keep
    # pulling until the half-open probe closes the breaker again
    recovered = br is None or br.state == "closed"
    if br is not None and not recovered:
        deadline = time.perf_counter() + 50 * (cooldown_ms / 1e3)
        while time.perf_counter() < deadline:
            time.sleep(cooldown_ms / 1e3 / 4)
            try:
                servant.pull(hot)
                served += 1
            except (Unavailable, OSError, RuntimeError):
                failed += 1
            if br.state == "closed":
                recovered = True
                break
    servant.fault_hook = None
    total = served + failed
    stats = servant.stats()
    degraded_hits = int(reg.counter("serve.degraded_hits").value) - degraded0
    return {
        "requests": total,
        "served": served,
        "failed": failed,
        "availability_pct": round(100.0 * served / max(total, 1), 3),
        "degraded_share_pct": round(
            100.0 * degraded_hits / max(total * len(hot), 1), 3),
        "p99_under_fault_ms": stats["kernels"]["pull"]["p99_ms"],
        "first_error": first_error,
        "recovered": bool(recovered),
        "trip_ms": (
            round((t_trip - t_first_fault) * 1e3, 3)
            if t_trip is not None and t_first_fault is not None else None),
        "breaker": br.snapshot() if br is not None else None,
    }


def chaos_serve_bench(
    small: bool = False,
    workdir: Optional[str] = None,
    ledger=None,
    floor_pct: float = AVAILABILITY_FLOOR_PCT,
    include_tier_drill: bool = True,
    device: DeviceLike = None,
) -> Dict:
    """Run the availability drill; returns the ``chaos_serve`` block for the
    bench JSON. Gated fields (``ledger-report --check-regression``, any
    platform): ``availability_pct`` >= ``floor_pct``,
    ``unprotected_hard_failure``, ``reload_corrupt_rejected``, and (when the
    tier drill ran) ``tier_bitflip.recovered``."""
    from swiftsnails_tpu_torch.framework.checkpoint import save_checkpoint
    from swiftsnails_tpu_torch.resilience.chaos import (
        ChaosPlan, corrupt_checkpoint_dir, parse_chaos_spec,
    )
    from swiftsnails_tpu_torch.serving.engine import Servant

    dim = 16 if small else 32
    capacity = 1 << (9 if small else 11)
    requests = 24 if small else 80
    cooldown_ms = 60.0
    hot = np.arange(32, dtype=np.int32)
    # storm of read errors early (trips the breaker), a second burst after
    # the first recovery window, and a couple of stalls in between
    spec = ("serve_io_error@0-5,serve_slow@8-9,"
            f"serve_io_error@{requests // 2}-{requests // 2 + 3}")

    own_tmp = None
    if workdir is None:
        own_tmp = tempfile.TemporaryDirectory(prefix="ssn-chaos-serve-")
        workdir = own_tmp.name
    try:
        root = os.path.join(workdir, "ckpt")
        cfg, state = _build_checkpoint(root, dim, capacity, device=device)

        def _open(protected: bool) -> Servant:
            sv = Servant.from_checkpoint(
                root, cfg, ledger=ledger if protected else None,
                cache_rows=max(len(hot) * 2, 128),
                breaker_threshold=3 if protected else 0,
                breaker_cooldown_ms=cooldown_ms,
                degraded=protected,
                device=device,
            )
            # warm the stale-LRU inventory, then bump the version so every
            # drill pull goes through dispatch (where the faults live) while
            # the warmed rows stay available for degraded serves
            sv.pull(hot)
            sv.reload(dict(sv._tables), manifest=sv.manifest)
            return sv

        with _open(protected=True) as served:
            protected = _drive_leg(
                served, ChaosPlan(parse_chaos_spec(spec), seed=SERVE_SEED,
                                  ledger=ledger),
                hot, requests, cooldown_ms)
            health = served.health()

            # reload_corrupt drill against the SAME live servant: write a
            # newer checkpoint, corrupt it on disk, ask for a live reload —
            # the shadow verify must reject it and keep the version serving
            plan = ChaosPlan(parse_chaos_spec("reload_corrupt@0"),
                             seed=SERVE_SEED, ledger=ledger)
            save_checkpoint(root, state, step=2, wait=True)
            if plan.wants_reload_corrupt(0):
                corrupt_checkpoint_dir(root, step=2, rng=plan.rng,
                                       ledger=ledger)
            kept = served.version
            reload_rejected = False
            reload_error = None
            try:
                served.reload_from_checkpoint(root, cfg, step=2)
            except Exception as e:  # noqa: BLE001 — the rejection IS the pass
                reload_rejected = True
                reload_error = f"{type(e).__name__}: {str(e)[:90]}"
            still_serving = bool(
                served.version == kept
                and len(served.pull(hot[:4])) == 4)

        with _open(protected=False) as bare:
            control = _drive_leg(
                bare, ChaosPlan(parse_chaos_spec(spec), seed=SERVE_SEED),
                hot, requests, cooldown_ms)

        out = {
            "spec": spec,
            "seed": SERVE_SEED,
            "small": bool(small),
            "floor_pct": float(floor_pct),
            "availability_pct": protected["availability_pct"],
            "degraded_share_pct": protected["degraded_share_pct"],
            "p99_under_fault_ms": protected["p99_under_fault_ms"],
            "trip_ms": protected["trip_ms"],
            "recover_ms": (protected["breaker"] or {}).get(
                "last_recovery_latency_ms"),
            "breaker": protected["breaker"],
            "recovered": protected["recovered"],
            "health": {"status": health["status"],
                       "degraded_hits": health["degraded_hits"]},
            "unprotected_hard_failure": control["failed"] > 0,
            "control_availability_pct": control["availability_pct"],
            "control_first_error": control["first_error"],
            "reload_corrupt_rejected": bool(
                reload_rejected and still_serving),
            "reload_corrupt_error": reload_error,
        }
        if include_tier_drill:
            from swiftsnails_tpu_torch.resilience.drill import drill_tier_bitflip

            try:
                out["tier_bitflip"] = drill_tier_bitflip(
                    os.path.join(workdir, "tier-drill"), device=device)
            except Exception as e:  # noqa: BLE001 — an unrecovered drill
                out["tier_bitflip"] = {
                    "recovered": False, "error": f"{type(e).__name__}: {e}"}
        return out
    finally:
        if own_tmp is not None:
            own_tmp.cleanup()
