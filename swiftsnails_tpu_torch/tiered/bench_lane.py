"""The ``tiered`` lane: the host-tier parameter store under load — the JAX
package's ``tiered/bench_lane.py``, with PyTorch inside.

Three legs:

- **equal-vocab**: the same zipf corpus and config trained twice — resident
  (``table_tier: device``) vs tiered (``table_tier: host``) with a budget
  that covers the vocab, so the tier cost under measurement is the host
  bookkeeping, not faulting. Reports words/sec both ways plus the ratio,
  and checks the final tables are **bit-identical** at f32 (the tier's
  contract).

- **over-budget**: the configuration the tier exists for — master units are
  4x the cache budget, so every step faults and evicts. A full
  train -> verified checkpoint -> ``Servant`` round trip, gated on
  bit-parity of the checkpointed masters against a resident control run and
  on served pulls matching the masters exactly.

- **quantized-master**: the over-budget schedule again with
  ``tier_master_dtype: int8``. Readouts: capacity-per-GB vs the logical f32
  layout (>= 2x), digest integrity through the async flush queue, master
  drift vs the f32-master control, and the f32-checkpoint round trip.

The block goes to the run ledger (``tiered_lane``) and the
``ledger-report --check-regression`` gate reads it from a bench record.
``tiered_bench(device=...)`` runs on the card by default; the tests pass
``device="cpu"``.
"""

from __future__ import annotations

import os
import tempfile
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from swiftsnails_tpu_torch.utils.device import DeviceLike, resolve_device

TIERED_SEED = 13
OVER_BUDGET_FACTOR = 4  # master units per cache slot in the over-budget leg
# run-end master drift budget for the int8-master leg vs the f32-master
# control: per-row int8 steps are ~amax/127, so the accumulated requant
# dither stays a small fraction of the table scale
QUANTIZED_REL_ERR_MAX = 0.05


def _corpus(small: bool, vocab_n: int) -> Tuple[np.ndarray, "object"]:
    """Zipf corpus over ``vocab_n`` words, frequency-ranked ids (the vocab
    ordering contract the prewarm relies on)."""
    from swiftsnails_tpu_torch.data.vocab import Vocab

    n_tokens = 30_000 if small else 150_000
    rng = np.random.default_rng(TIERED_SEED)
    ranks = np.arange(1, vocab_n + 1, dtype=np.float64)
    w = 1.0 / ranks ** 1.1
    cdf = np.cumsum(w) / w.sum()
    ids = np.searchsorted(cdf, rng.random(n_tokens)).astype(np.int32)
    counts = np.maximum(np.bincount(ids, minlength=vocab_n), 1).astype(np.int64)
    return ids, Vocab([f"w{i}" for i in range(vocab_n)], counts)


def _make_trainer(corpus, workdir: str, device, **overrides):
    from swiftsnails_tpu_torch.models.word2vec import Word2VecTrainer
    from swiftsnails_tpu_torch.utils.config import Config

    ids, vocab = corpus
    base = {
        "dim": "16", "window": "1", "negatives": "4", "learning_rate": "0.3",
        "num_iters": "40", "batch_size": "256", "subsample": "0", "seed": "0",
        "packed": "0", "prefetch_batches": "0",
        "ledger_path": os.path.join(workdir, "LEDGER.jsonl"),
    }
    base.update({k: str(v) for k, v in overrides.items()})
    cfg = Config(base)
    return Word2VecTrainer(cfg, corpus_ids=ids, vocab=vocab, device=device), cfg


def _budget_mb(vocab_n: int, dim: int, slots_per_table: int) -> float:
    """Total cache budget (both tables) sized to ``slots_per_table`` dense
    f32 rows each — the synthetic-budget knob that makes the lane valid at
    any vocab size."""
    return 2 * slots_per_table * dim * 4 / float(1 << 20)


def _tables_equal(a, b) -> bool:
    return bool(torch.equal(a.in_table.table.cpu(), b.in_table.table.cpu())
                and torch.equal(a.out_table.table.cpu(), b.out_table.table.cpu()))


def tiered_bench(small: bool = False, workdir: Optional[str] = None,
                 ledger=None, device: DeviceLike = None) -> Dict:
    """Run the tiered lane on ``device`` (default: the card); returns the
    ``tiered`` block.

    Headline fields (gated by ``ledger-report --check-regression``):
    ``words_per_sec`` (tiered, equal-vocab leg), ``parity_bit_identical``,
    ``round_trip_ok`` and ``quantized_ok``.
    """
    from swiftsnails_tpu_torch.framework.trainer import TrainLoop

    dev = resolve_device(device)
    t_lane0 = time.monotonic()
    vocab_n = 512 if small else 2048
    dim = 16 if small else 64
    batch = 256 if small else 1024
    # enough timed steps that the per-run fixed cost (tier adopt + end-of-run
    # master write-back) amortizes and the steady-state rate dominates
    warm, steps = (2, 96) if small else (3, 48)
    corpus = _corpus(small, vocab_n)
    over = {"dim": dim, "batch_size": batch, "num_iters": 8}

    own_tmp = None
    if workdir is None:
        own_tmp = tempfile.TemporaryDirectory(prefix="ssn-tiered-bench-")
        workdir = own_tmp.name
    try:
        # -- equal-vocab leg: words/sec + steady-state tier cost ------------
        tier_cfg = {
            "table_tier": "host",
            # budget covers the vocab: measures bookkeeping, not faulting
            "tier_hbm_budget_mb": _budget_mb(vocab_n, dim, vocab_n),
            # the hot-path defaults under test: background write-back and
            # wait-driven staging depth
            "tier_async_flush": 1,
            "tier_prefetch_depth": "auto",
        }
        # Steady-state pair rates, measured INTERLEAVED: one warm run per
        # config, then 3 rounds alternating resident/tiered timed runs — a
        # load spike lands on both sides of the ratio instead of biasing
        # whichever config ran last. Noise only ever slows a run, so
        # best-of (max) is the estimator.
        loops: Dict[str, "TrainLoop"] = {}
        for key, extra in (("resident", over),
                           ("tiered", {**over, **tier_cfg})):
            tr, _ = _make_trainer(corpus, tempfile.mkdtemp(dir=workdir), dev, **extra)
            loops[key] = TrainLoop(tr, log_every=0)
            loops[key].run(max_steps=warm)
        best = {"resident": 0.0, "tiered": 0.0}
        for _ in range(3):
            for key, loop in loops.items():
                t0 = time.monotonic()
                loop.run(max_steps=steps)
                dt = max(time.monotonic() - t0, 1e-9)
                best[key] = max(best[key], steps * batch / dt)
        resident_wps, tiered_wps = best["resident"], best["tiered"]
        cache = loops["tiered"].tier.summary()
        breakdown = dict(cache.get("breakdown") or {})
        breakdown["flush_queue_depth"] = cache.get("flush_queue_depth", 0)

        # parity on fresh loops with an identical step budget
        p_steps = 12
        ra = TrainLoop(_make_trainer(
            corpus, tempfile.mkdtemp(dir=workdir), dev, **over)[0],
            log_every=0).run(seed=0, max_steps=p_steps)
        rb = TrainLoop(_make_trainer(
            corpus, tempfile.mkdtemp(dir=workdir), dev, **over, **tier_cfg)[0],
            log_every=0).run(seed=0, max_steps=p_steps)
        parity = _tables_equal(ra, rb)

        ob = _over_budget_leg(corpus, workdir, over, vocab_n, dim, dev)
        qb = _quantized_master_leg(corpus, workdir, over, vocab_n, dim, dev)

        block = {
            "small": bool(small),
            "vocab": vocab_n,
            "dim": dim,
            "device": str(dev),
            "words_per_sec": round(tiered_wps, 1),
            "resident_words_per_sec": round(resident_wps, 1),
            "tiered_over_resident": (
                round(tiered_wps / resident_wps, 4) if resident_wps else None
            ),
            "parity_bit_identical": parity,
            "cache": cache,
            "breakdown": breakdown,
            "over_budget": ob,
            "round_trip_ok": bool(ob.get("round_trip_ok")),
            "quantized": qb,
            "quantized_ok": bool(qb.get("ok")),
            "elapsed_s": round(time.monotonic() - t_lane0, 1),
        }
        if ledger is not None:
            try:
                ledger.append("tiered_lane", block)
            except Exception:
                pass  # record-keeping never kills the lane
        return block
    finally:
        if own_tmp is not None:
            own_tmp.cleanup()


def _over_budget_leg(corpus, workdir: str, over: Dict, vocab_n: int,
                     dim: int, dev) -> Dict:
    """Train with masters 4x the cache budget, checkpoint through the tier
    flush path, serve the checkpoint through the tiered read path — the
    whole lifecycle the subsystem promises."""
    from swiftsnails_tpu_torch.framework.trainer import TrainLoop
    from swiftsnails_tpu_torch.serving.engine import Servant

    slots = max(vocab_n // OVER_BUDGET_FACTOR, 1)
    budget = _budget_mb(vocab_n, dim, slots)
    steps = 16
    ck_root = os.path.join(workdir, "ckpt-tiered")
    # the per-step working set (contexts + negatives) must fit the budget:
    # batch 32 touches at most 32 + 64 out_table units < vocab/4 slots
    over = {**over, "batch_size": 32 if vocab_n <= 512 else 64,
            "negatives": 2}
    tier_over = {
        **over, "table_tier": "host", "tier_hbm_budget_mb": budget,
        "param_backup_root": ck_root, "param_backup_period": steps // 2,
    }

    t0 = time.monotonic()
    tr, cfg = _make_trainer(corpus, workdir, dev, **tier_over)
    loop = TrainLoop(tr, log_every=0)
    state = loop.run(seed=0, max_steps=steps)
    train_s = time.monotonic() - t0
    summary = loop.tier.summary()

    # resident control: identical schedule, no tier
    control = TrainLoop(_make_trainer(
        corpus, tempfile.mkdtemp(dir=workdir), dev, **over)[0],
        log_every=0).run(seed=0, max_steps=steps)
    parity = _tables_equal(control, state)

    # serve the checkpoint through the tiered read path; pulls must match
    # the checkpointed master rows exactly even past the cache budget
    rng = np.random.default_rng(TIERED_SEED)
    probe = rng.integers(0, vocab_n, size=256).astype(np.int64)
    with Servant.from_checkpoint(ck_root, cfg, cache_rows=0, device=dev) as served:
        ck_step = served.step
        pulled = served.pull(probe, table="in_table")
        serve_stats = served.stats().get("tiered", {})
    want = state.in_table.table.cpu().numpy()[probe]
    serve_ok = bool(np.array_equal(pulled, want))

    return {
        "vocab_units": vocab_n,
        "budget_slots": slots,
        "budget_mb": round(budget, 6),
        "steps": steps,
        "train_s": round(train_s, 2),
        "checkpoint_step": ck_step,
        "hit_rate": summary.get("hit_rate"),
        "faulted_rows": summary.get("faulted_rows"),
        "evictions": summary.get("evictions"),
        "flushed_rows": summary.get("flushed_rows"),
        "h2d_bytes": summary.get("h2d_bytes"),
        "d2h_bytes": summary.get("d2h_bytes"),
        "parity_bit_identical": parity,
        "serve_pull_ok": serve_ok,
        "serve_hit_rate": serve_stats.get("hit_rate"),
        "round_trip_ok": bool(parity and serve_ok and ck_step > 0),
    }


def _quantized_master_leg(corpus, workdir: str, over: Dict, vocab_n: int,
                          dim: int, dev) -> Dict:
    """Over-budget leg with ``tier_master_dtype: int8``: same schedule, but
    the host masters live as int8 code planes + per-row f32 scales, so the
    same host RAM holds >= 2x the rows. The checkpoint stays plain f32
    (dequantized before the manifest); a served pull must equal the
    requant->dequant of the checkpointed rows bit-exactly."""
    from swiftsnails_tpu_torch.framework.trainer import TrainLoop
    from swiftsnails_tpu_torch.serving.engine import Servant
    from swiftsnails_tpu_torch.tiered.store import (
        _np_dequant_unit_rows, _np_quant_unit_rows,
    )

    slots = max(vocab_n // OVER_BUDGET_FACTOR, 1)
    budget = _budget_mb(vocab_n, dim, slots)
    steps = 16
    over = {**over, "batch_size": 32 if vocab_n <= 512 else 64,
            "negatives": 2}
    tier_base = {
        **over, "table_tier": "host", "tier_hbm_budget_mb": budget,
        "tier_async_flush": 1,
    }

    # f32-master control on the identical schedule: the drift reference
    f32_state = TrainLoop(_make_trainer(
        corpus, tempfile.mkdtemp(dir=workdir), dev, **tier_base)[0],
        log_every=0).run(seed=0, max_steps=steps)

    ck_root = os.path.join(workdir, "ckpt-q8")
    q_tr, q_cfg = _make_trainer(
        corpus, tempfile.mkdtemp(dir=workdir), dev, **tier_base,
        tier_master_dtype="int8", param_backup_root=ck_root,
        param_backup_period=steps // 2)
    q_loop = TrainLoop(q_tr, log_every=0)
    q_state = q_loop.run(seed=0, max_steps=steps)
    summary = q_loop.tier.summary()
    # digest sweep AFTER the async flush queue drained: the incremental
    # keyed digests must cover code planes and scale sidebands through
    # every coalesced scatter
    digests_clean = not q_loop.tier.verify()

    # capacity: stored bytes per unit (codes + scales) vs the logical f32
    # layout the budget math still sizes the cache with
    tables = summary.get("tables") or {}
    ratios = [
        t["unit_bytes"] / t["host_unit_bytes"]
        for t in tables.values() if t.get("host_unit_bytes")
    ]
    capacity_ratio = round(min(ratios), 3) if ratios else None
    rows_per_gb = {
        name: int((1 << 30) // t["host_unit_bytes"])
        for name, t in tables.items() if t.get("host_unit_bytes")
    }

    a = q_state.in_table.table.cpu().numpy().astype(np.float64)
    b = f32_state.in_table.table.cpu().numpy().astype(np.float64)
    rel_err = float(np.abs(a - b).mean() / max(np.abs(b).mean(), 1e-12))

    rng = np.random.default_rng(TIERED_SEED)
    probe = rng.integers(0, vocab_n, size=256).astype(np.int64)
    with Servant.from_checkpoint(ck_root, q_cfg, cache_rows=0, device=dev) as served:
        ck_step = served.step
        pulled = served.pull(probe, table="in_table")
    want = q_state.in_table.table.cpu().numpy()[probe]
    codes, scales = _np_quant_unit_rows(want)
    expect = _np_dequant_unit_rows(codes, scales, want.dtype)
    serve_ok = bool(np.array_equal(pulled, expect))
    ckpt_f32 = q_state.in_table.table.dtype == torch.float32

    ok = bool(
        digests_clean and serve_ok and ckpt_f32 and ck_step > 0
        and capacity_ratio is not None and capacity_ratio >= 2.0
        and rel_err <= QUANTIZED_REL_ERR_MAX
    )
    return {
        "master_dtype": summary.get("master_dtype"),
        "steps": steps,
        "checkpoint_step": ck_step,
        "capacity_ratio_vs_f32": capacity_ratio,
        "rows_per_gb": rows_per_gb,
        "hit_rate": summary.get("hit_rate"),
        "async_flush": summary.get("async_flush"),
        "digests_clean": digests_clean,
        "master_rel_err_vs_f32": round(rel_err, 6),
        "rel_err_budget": QUANTIZED_REL_ERR_MAX,
        "serve_requant_exact": serve_ok,
        "checkpoint_dtype_f32": ckpt_f32,
        "ok": ok,
    }
