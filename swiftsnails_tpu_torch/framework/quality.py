"""The quality probe: does a trained word2vec state know its corpus? — the
JAX package's ``framework/quality.py``.

The probe corpus pairs word ``2i`` with ``2i+1`` only; a trained state ranks
the partner first by in-out logit (``v_in[2i] . u_out[j]``, argmax over
``j``). The JAX package measured 0.84-0.98 across its paths and seeds; an
untrained or mis-scaled state scores about 1/vocab. ``MIN_TOP1`` is the bar
its CI and its bench gate on, and the port's bench gates on the same bar.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from swiftsnails_tpu_torch.data.vocab import Vocab
from swiftsnails_tpu_torch.utils.device import DeviceLike

# Fraction of pairs that must be learned for a path to pass.
MIN_TOP1 = 0.75

N_PAIRS = 64  # 128 words: hogwild within-block collisions stay minor

PROBE_CONFIG = {
    "dim": "16",
    "window": "1",
    "negatives": "4",
    "learning_rate": "0.3",
    "num_iters": "6",
    "batch_size": "256",
    "subsample": "0",
    "seed": "0",
    # probe-scale pool (only read by pool/fused paths)
    "pool_size": "8",
    "pool_block": "64",
}


def paired_corpus(n_pairs: int = N_PAIRS, reps: int = 4000,
                  seed: int = 0) -> Tuple[np.ndarray, Vocab]:
    """Corpus where word 2i and 2i+1 always co-occur: 'a0 b0 a3 b3 ...'."""
    rng = np.random.default_rng(seed)
    vocab_words = [f"w{i}" for i in range(2 * n_pairs)]
    seq = []
    for _ in range(reps):
        pair = rng.integers(0, n_pairs)
        seq += [2 * pair, 2 * pair + 1]
    ids = np.array(seq, dtype=np.int32)
    counts = np.bincount(ids, minlength=2 * n_pairs).astype(np.int64)
    return ids, Vocab(vocab_words, counts)


def pair_top1_hits(trainer, state) -> Tuple[int, int]:
    """``(hits, n_pairs)``: pairs whose partner wins the in-out logit
    argmax, on packed or 2-D tables."""
    from swiftsnails_tpu_torch.ops.rowdma import unpack_rows

    n_words = len(trainer.vocab)
    rows = trainer._rows(torch.arange(n_words, dtype=torch.int32,
                                      device=state.in_table.table.device))
    v = state.in_table.table.index_select(0, rows)
    u = state.out_table.table.index_select(0, rows)
    if trainer.packed:
        v, u = unpack_rows(v, trainer.dim), unpack_rows(u, trainer.dim)
    v = v.float().cpu().numpy()
    u = u.float().cpu().numpy()
    scores = v @ u.T
    hits = sum(int(np.argmax(scores[2 * p]) == 2 * p + 1) for p in range(n_words // 2))
    return hits, n_words // 2


def probe_top1(path_overrides: dict, device: DeviceLike = None) -> float:
    """Train the probe corpus under ``path_overrides`` on ``device`` (default:
    the card, where the fused paths run their real racy kernels) and score
    it. The loop is the JAX probe's: one ``train_step`` a batch, the step's
    generator from :func:`~swiftsnails_tpu_torch.framework.trainer.step_generator`."""
    from swiftsnails_tpu_torch.framework.trainer import step_generator
    from swiftsnails_tpu_torch.models.word2vec import Word2VecTrainer
    from swiftsnails_tpu_torch.utils.config import Config

    ids, vocab = paired_corpus()
    cfg = dict(PROBE_CONFIG)
    cfg.update(path_overrides)
    cfg["pool_size"] = PROBE_CONFIG["pool_size"]
    cfg["pool_block"] = PROBE_CONFIG["pool_block"]
    trainer = Word2VecTrainer(Config(cfg), corpus_ids=ids, vocab=vocab, device=device)
    state = trainer.init_state()
    dev = trainer.device
    for i, batch in enumerate(trainer.batches()):
        on_dev = {k: torch.from_numpy(v).to(dev) if np.ndim(v) else v
                  for k, v in batch.items()}
        state, _ = trainer.train_step(state, on_dev, step_generator(0, i, dev))
    hits, n = pair_top1_hits(trainer, state)
    return hits / n
