"""The ``serve`` lane: latency-SLO numbers for the read path — the JAX
package's ``serving/bench_lane.py``, with the port's trainers.

It builds two tiny *verified* checkpoints with the port's trainers and
``save_checkpoint`` (a packed word2vec table and a packed-small logreg
table), loads each through the real :meth:`Servant.from_checkpoint` path on
``device`` (default: the card), and drives all three query kernels — pull,
top-k, CTR score — at two batch buckets, reporting qps and p50/p95/p99
latency per (kernel, bucket) plus cache hit rate and shed count, the block
that ``ledger-report --check-regression`` gates (``serving``). On the card
``chip_smoke.py``'s ``serve`` phase runs it; the port has no bench script
that writes it into the ledger yet (``ROADMAP.md``).
"""

from __future__ import annotations

import os
import tempfile
import time
from typing import Dict, Optional, Sequence

import numpy as np

SERVE_SEED = 11


def _build_word2vec_checkpoint(root: str, dim: int, capacity: int,
                               device=None):
    """Init (no training needed — serving is layout + lookup) and save a
    verified packed word2vec checkpoint; returns its serving config."""
    from swiftsnails_tpu_torch.framework.checkpoint import save_checkpoint
    from swiftsnails_tpu_torch.framework.quality import paired_corpus
    from swiftsnails_tpu_torch.models.word2vec import Word2VecTrainer
    from swiftsnails_tpu_torch.utils.config import Config

    ids, vocab = paired_corpus(n_pairs=32, reps=4, seed=SERVE_SEED)
    cfg = Config({
        "dim": str(dim), "capacity": str(capacity), "packed": "1",
        "seed": str(SERVE_SEED), "subsample": "0",
    })
    trainer = Word2VecTrainer(cfg, mesh=None, corpus_ids=ids, vocab=vocab,
                              device=device)
    state = trainer.init_state()
    save_checkpoint(root, state, step=1, wait=True)
    return cfg


def _build_logreg_checkpoint(root: str, num_fields: int, capacity: int,
                             device=None):
    """Init and save a verified packed-small logreg checkpoint."""
    from swiftsnails_tpu_torch.framework.checkpoint import save_checkpoint
    from swiftsnails_tpu_torch.models.registry import get_model
    from swiftsnails_tpu_torch.utils.config import Config

    cfg = Config({
        "model": "logreg", "num_fields": str(num_fields),
        "capacity": str(capacity), "packed": "1", "seed": str(SERVE_SEED),
        "init_scale": "1.0",
    })
    trainer = get_model("logreg")(
        cfg, mesh=None,
        data=(np.zeros(0, np.float32), np.zeros((0, num_fields), np.int32)),
        device=device,
    )
    state = trainer.init_state()
    save_checkpoint(root, state, step=1, wait=True)
    return cfg


def _drive(servant, kernel: str, bucket: int, requests: int,
           rng: np.random.Generator, capacity: int,
           num_fields: int = 0) -> Dict:
    """Fire ``requests`` back-to-back requests of ``bucket`` units each and
    report qps + the latency percentiles the servant observed."""
    servant.reset_metrics()
    zipf = rng.zipf(1.3, size=(requests, max(bucket, 1)))  # head-heavy ids
    t0 = time.perf_counter()
    for n in range(requests):
        if kernel == "pull":
            ids = np.minimum(zipf[n], capacity - 1).astype(np.int32)
            servant.pull(ids[:bucket])
        elif kernel == "topk":
            q = rng.standard_normal(
                servant._tables[servant.default_table].shape[1]
            ).astype(np.float32)
            servant.topk(q)
        else:  # score
            feats = np.minimum(zipf[n, :num_fields], capacity - 1)
            servant.score(
                np.broadcast_to(feats, (bucket, num_fields)).astype(np.int32))
    dt = max(time.perf_counter() - t0, 1e-9)
    stats = servant.stats()["kernels"][kernel]
    return {
        "requests": requests,
        "bucket": bucket,
        "qps": round(requests / dt, 2),
        "p50_ms": stats["p50_ms"],
        "p95_ms": stats["p95_ms"],
        "p99_ms": stats["p99_ms"],
    }


def serve_bench(
    small: bool = False,
    workdir: Optional[str] = None,
    ledger=None,
    buckets: Sequence[int] = (8, 64),
    device=None,
) -> Dict:
    """Run the serve lane; returns the ``serving`` block for the bench JSON.

    Headline fields (gated by ``ledger-report --check-regression``):
    ``qps`` (pull at the largest bucket) and ``p99_ms`` (same leg).
    ``device``: where the checkpoints are built and served (default: the
    card).
    """
    from swiftsnails_tpu_torch.serving.engine import Servant

    dim = 16 if small else 64
    capacity = 1 << (9 if small else 12)
    requests = 8 if small else 40
    rng = np.random.default_rng(SERVE_SEED)
    buckets = tuple(sorted(int(b) for b in buckets))

    own_tmp = None
    if workdir is None:
        own_tmp = tempfile.TemporaryDirectory(prefix="ssn-serve-bench-")
        workdir = own_tmp.name
    try:
        w2v_root = os.path.join(workdir, "ckpt-w2v")
        ctr_root = os.path.join(workdir, "ckpt-ctr")
        w2v_cfg = _build_word2vec_checkpoint(w2v_root, dim, capacity, device)
        num_fields = 8
        ctr_cfg = _build_logreg_checkpoint(ctr_root, num_fields, capacity, device)

        kernels: Dict[str, Dict] = {"pull": {}, "topk": {}, "ctr_score": {}}
        with Servant.from_checkpoint(
            w2v_root, w2v_cfg, batch_buckets=buckets, ledger=ledger,
            device=device,
        ) as served:
            step = served.step
            for b in buckets:
                kernels["pull"][f"b{b}"] = _drive(
                    served, "pull", b, requests, rng, capacity)
                kernels["topk"][f"b{b}"] = _drive(
                    served, "topk", b, max(requests // 4, 2), rng, capacity)
            # cache behavior over the whole pull run (zipf head re-hits)
            cache_stats = served.stats()["cache"]
            # hit rate over a fresh repeated working set: deterministic
            served.reset_metrics()
            hot = np.arange(min(64, capacity), dtype=np.int32)
            for _ in range(4):
                served.pull(hot)
            cache_hit_rate = served.stats()["cache"]["hit_rate"]
            shed = served.shed_count()

        with Servant.from_checkpoint(
            ctr_root, ctr_cfg, batch_buckets=buckets, ledger=ledger,
            device=device,
        ) as scorer:
            for b in buckets:
                kernels["ctr_score"][f"b{b}"] = _drive(
                    scorer, "score", b, requests, rng, capacity,
                    num_fields=num_fields)
            shed += scorer.shed_count()

        head = kernels["pull"][f"b{buckets[-1]}"]
        return {
            "checkpoint_step": step,
            "buckets": list(buckets),
            "small": bool(small),
            "kernels": kernels,
            "qps": head["qps"],
            "p99_ms": head["p99_ms"],
            "cache_hit_rate": round(float(cache_hit_rate), 4),
            "cache_rows": cache_stats.get("rows", 0),
            "shed_count": int(shed),
        }
    finally:
        if own_tmp is not None:
            own_tmp.cleanup()
