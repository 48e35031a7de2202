"""The drill harness's trainer and loop — ``make_trainer`` and ``run_loop``
of the JAX package's ``resilience/drill.py``, which the drift lane
(``telemetry/drift_lane.py``) runs. The drill matrix itself and its tool
(``tools/chaos_drill.py``) are not ported yet (``ROADMAP.md``).
"""

from __future__ import annotations

import os

from swiftsnails_tpu_torch.utils.device import DeviceLike


def _drill_corpus():
    """The shared 128-word paired probe corpus (``framework/quality.py``) —
    small enough that every drill runs in seconds."""
    from swiftsnails_tpu_torch.framework.quality import paired_corpus

    return paired_corpus(n_pairs=64, reps=1500, seed=0)


def make_trainer(workdir: str, corpus=None, device: DeviceLike = None, **overrides):
    """A dense-path word2vec trainer wired for drills (ledger under
    ``workdir``) on ``device`` (``None``: the card); overrides land on top
    of the base config."""
    from swiftsnails_tpu_torch.models.word2vec import Word2VecTrainer
    from swiftsnails_tpu_torch.utils.config import Config

    ids, vocab = corpus if corpus is not None else _drill_corpus()
    base = {
        "dim": "16", "window": "1", "negatives": "4", "learning_rate": "0.3",
        "num_iters": "40", "batch_size": "256", "subsample": "0", "seed": "0",
        "packed": "0", "prefetch_batches": "0",
        "ledger_path": os.path.join(workdir, "LEDGER.jsonl"),
    }
    base.update({k: str(v) for k, v in overrides.items()})
    return Word2VecTrainer(Config(base), corpus_ids=ids, vocab=vocab, device=device)


def run_loop(trainer, max_steps: int):
    """Build + run a TrainLoop; returns ``(loop, state, steps_done)``."""
    from swiftsnails_tpu_torch.framework.trainer import TrainLoop

    loop = TrainLoop(trainer, log_every=0)
    state = loop.run(max_steps=max_steps)
    steps_done = loop._items_seen // trainer.batch_size
    return loop, state, steps_done
