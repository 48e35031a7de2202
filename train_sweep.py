"""Learning-rate sweep of the port's word2vec paths on one NVIDIA GPU.

    python3 train_sweep.py [--seed N] [--steps 30] [--paths resident,dedup,...]

Trains each path through ``Word2VecTrainer`` -> ``TrainLoop.run`` at the
shapes of ``chip_smoke.py`` (vocab 1,048,576, dim 200, window 5, 5
negatives, pool 64; packed+pool and fused-hogwild at 16,384 pairs a
substep, fused-grouped and the merged paths at 8,192 centers) on each of its two corpora (zipf
ids, and zipf-distributed word pairs (2p, 2p + 1)), over a grid of learning
rates and substeps a step, and prints one JSON line a run: the mean loss of
the first and of the last 5 steps, and for fused-grouped the same for the
loss per real pair (its loss is normalized by the expected pair count
N * (window + 1), so each batch's real pair count moves it by ~1%). The
``sequential`` rows run fused-hogwild with its kernel replaced by the plain
version, whose blocks run in order as the TPU kernel's do. The
``mesh_grouped`` rows run fused-grouped's config under a ``(1, 1)`` mesh of
a one-rank NCCL group, which is the grouped collective plane (the merged
update, no kernel of its own). Run from the root of the repository on a
machine with a card; it is what chose ``chip_smoke.py``'s ``FUSED_LR``,
``MERGED_LR``, ``MESH_GROUPED_LR`` and corpus for the fused paths.
"""

from __future__ import annotations

import argparse
import json
import tempfile

import numpy as np
import torch

import chip_smoke as cs

# (path, corpus is paired) -> [(lr, steps_per_call), ...]
GRID = {
    "packed": [(100.0, 1), (410.0, 1)],
    "fused": [(lr, spc) for lr in (100.0, 410.0, 1600.0, 3200.0) for spc in (1, 8)],
    "grouped": [(lr, spc) for lr in (100.0, 410.0, 1600.0, 4800.0) for spc in (1, 8)],
    "sequential": [(100.0, 1), (410.0, 1)],
    **{path: [(lr, 8) for lr in (100.0, 410.0, 1600.0)]
       for path in ("resident", "dedup", "dedup_res", "mesh_grouped")},
}
_GROUPED = {"fused": 1, "grouped": 1, "batch_size": cs.GROUPED_BATCH,
            "centers_per_block": cs.CENTERS_PER_BLOCK}
CONFIG = {
    "packed": {"batch_size": cs.BATCH},
    "fused": {"fused": 1, "batch_size": cs.BATCH},
    "sequential": {"fused": 1, "batch_size": cs.BATCH},
    "grouped": _GROUPED,
    "mesh_grouped": _GROUPED,
    "resident": {**_GROUPED, "resident": 1, "hot_rows": cs.HOT_ROWS},
    "dedup": {**_GROUPED, "dedup": 1, "u_cap": cs.U_CAP},
    "dedup_res": {**_GROUPED, "dedup": 1, "u_cap": cs.U_CAP, "resident": 1,
                  "hot_rows": cs.COMPOSED_HOT_ROWS},
}


_MESH = []  # the (1, 1) NCCL mesh of the mesh_grouped rows, made at first use


def _mesh():
    if not _MESH:
        import torch.distributed as dist

        from swiftsnails_tpu_torch.parallel.mesh import make_mesh

        init = f"file://{tempfile.mkdtemp(prefix='ssn-sweep-')}/rendezvous"
        dist.init_process_group("nccl", init_method=init, rank=0, world_size=1,
                                device_id=torch.device("cuda", torch.cuda.current_device()))
        _MESH.append(make_mesh({"data": 1, "model": 1}))
    return _MESH[0]


def run(path: str, lr: float, spc: int, corpus, seed: int, steps: int) -> dict:
    from swiftsnails_tpu_torch.framework.trainer import TrainLoop
    from swiftsnails_tpu_torch.models import word2vec
    from swiftsnails_tpu_torch.ops import fused_sgns
    from swiftsnails_tpu_torch.utils.config import Config
    from swiftsnails_tpu_torch.utils.metrics import MetricsLogger

    ids, vocab, _ = corpus
    cfg = Config({"dim": str(cs.DIM), "window": str(cs.WINDOW),
                  "negatives": str(cs.NEGATIVES), "pool_size": str(cs.POOL_SIZE),
                  "pool_block": str(cs.POOL_BLOCK), "subsample": "0",
                  "num_iters": "1", "seed": str(seed), "learning_rate": str(lr),
                  "steps_per_call": str(spc),
                  **{k: str(v) for k, v in CONFIG[path].items()}})
    trainer = word2vec.Word2VecTrainer(cfg, mesh=_mesh() if path == "mesh_grouped" else None,
                                       corpus_ids=ids, vocab=vocab)
    records = []

    class Recorder(MetricsLogger):
        def log(self, record):
            records.append(record)

    kernel = word2vec.fused_sgns_step
    if path == "sequential":
        word2vec.fused_sgns_step = fused_sgns.fused_sgns_step_plain
    try:
        TrainLoop(trainer, metrics=Recorder(), log_every=1).run(seed=seed, max_steps=steps)
    finally:
        word2vec.fused_sgns_step = kernel
    loss = np.array([r["loss"] for r in records])
    out = {"loss_first5": float(loss[:5].mean()), "loss_last5": float(loss[-5:].mean())}
    if trainer.grouped:
        real = [(b["contexts"] >= 0).sum() / b["contexts"].size * cs.CW / (cs.WINDOW + 1)
                for _, b in zip(range(steps), trainer.batches())]
        per = loss / np.array(real)
        out.update(per_pair_first5=float(per[:5].mean()), per_pair_last5=float(per[-5:].mean()))
    out["falls"] = out["loss_last5"] < out["loss_first5"]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=cs.STEPS)
    ap.add_argument("--paths", default=",".join(GRID),
                    help="comma-separated paths to sweep (default: all)")
    args = ap.parse_args()
    paths = args.paths.split(",")
    if not torch.cuda.is_available():
        raise SystemExit("train_sweep: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    for paired in (False, True):
        corpus = cs._corpus(args.seed, paired=paired)
        for path in paths:
            grid = GRID[path]
            if path == "sequential" and paired:
                continue
            for lr, spc in grid:
                res = run(path, lr, spc, corpus, args.seed, args.steps)
                print(json.dumps({"corpus": "paired" if paired else "zipf", "path": path,
                                  "lr": lr, "steps_per_call": spc, **res}), flush=True)
                torch.cuda.empty_cache()
    print(cs.phase_env()["nvidia_smi"])
    if _MESH:
        import torch.distributed as dist

        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
