"""The cluster plane on the card: the simulated fleet at full width (a
reduced batch count), its schedule against the CPU's, and the cluster
drills.

Every test here needs an NVIDIA GPU and skips without one. The file imports
neither JAX nor the JAX package, so on a machine with a card it runs
without the suite's conftest:

    python -m pytest tests/test_torch_cuda_cluster.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from swiftsnails_tpu_torch.cluster import chaos_lane, sim
from swiftsnails_tpu_torch.data.vocab import Vocab
from swiftsnails_tpu_torch.models.word2vec import Word2VecTrainer
from swiftsnails_tpu_torch.ops import rowdma
from swiftsnails_tpu_torch.resilience.chaos import ChaosPlan, parse_chaos_spec
from swiftsnails_tpu_torch.resilience.drill import eval_loss, make_trainer, tables_finite
from swiftsnails_tpu_torch.utils.config import Config

pytestmark = pytest.mark.cuda

VOCAB = 1 << 20
STORM = "worker_dead@5,worker_slow@8-12,partition@14"
SCHEDULING = ("workers", "ticks", "virtual_s", "stale_rejected", "accounting", "status")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA C++ with no "
                    "CPU build")
    return torch.device("cuda")


def _full_width_trainer():
    """packed+pool at ``chip_smoke.py``'s ``train`` shape (vocab 2^20, dim
    200, window 5, 5 negatives, pool 64, batch 16,384, lr 100) on a 300,000
    token zipf corpus."""
    rng = np.random.default_rng(0)
    w = 1.0 / np.arange(1, VOCAB + 1, dtype=np.float64) ** 1.05
    cdf = np.cumsum(w) / w.sum()
    ids = np.minimum(np.searchsorted(cdf, rng.random(300_000)), VOCAB - 1).astype(np.int32)
    counts = np.maximum(np.bincount(ids, minlength=VOCAB), 1)
    cfg = Config({"dim": "200", "window": "5", "negatives": "5", "subsample": "0",
                  "num_iters": "1", "pool_size": "64", "pool_block": "512",
                  "table_dtype": "float32", "seed": "0", "learning_rate": "100",
                  "batch_size": "16384"})
    return Word2VecTrainer(cfg, corpus_ids=ids, vocab=Vocab([f"w{i}" for i in range(VOCAB)],
                                                            counts))


def test_full_width_sim_under_a_storm_is_exact(cuda_device):
    """24 batches, 3 workers, a kill, a straggler and a partition at full
    width: every batch applied once, 2 ``gather_rows`` and 2
    ``scatter_add_rows`` a batch applied, finite tables, and a replay of
    the leg's order in the loss's neighbourhood."""
    trainer = _full_width_trainer()
    for f in (rowdma.gather_rows, rowdma.scatter_add_rows):
        f.launches = 0
    res = sim.simulate_cluster(trainer, 24, workers=3,
                               chaos=ChaosPlan(parse_chaos_spec(STORM), seed=7))
    torch.cuda.synchronize()
    applied = len(res["order"])
    assert res["accounting"]["exact"] and res["accounting"]["duplicated_count"] == 0
    assert res["status"]["workers_lost"] >= 1 and applied == 24
    assert rowdma.gather_rows.launches == rowdma.scatter_add_rows.launches == 2 * applied
    assert tables_finite(res["state"])
    loss = eval_loss(trainer, res["state"])
    del res
    replay = sim.run_inorder_control(trainer, 24)
    control = eval_loss(trainer, replay)
    assert abs(loss - control) / abs(control) <= chaos_lane.LOSS_PARITY_BAR


@pytest.mark.parametrize("spec", [chaos_lane.STORM_SPEC, "partition@10"])
def test_sim_schedule_on_the_card_equals_the_cpus(cuda_device, tmp_path, spec):
    results = []
    for device in ("cuda", "cpu"):
        tr = make_trainer(str(tmp_path), device=device)
        results.append(sim.simulate_cluster(
            tr, 48, workers=3, chaos=ChaosPlan(parse_chaos_spec(spec), seed=7)))
    for field in SCHEDULING:
        assert results[0][field] == results[1][field], field
    assert results[0]["order"] == results[1]["order"]


def test_cluster_drills_recover_on_the_card(cuda_device, tmp_path):
    results = chaos_lane.run_cluster_drills(workdir=str(tmp_path), device="cuda")
    failed = {k: v["checks"] for k, v in results.items() if not v["recovered"]}
    assert not failed, failed
