"""The freshness pipeline and the network plane on the card.

Every test here needs an NVIDIA GPU and skips without one. The file imports
neither JAX nor the JAX package, so on a machine with a card it runs
without the suite's conftest:

    python -m pytest tests/test_torch_cuda_freshness.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from swiftsnails_tpu_torch.framework.checkpoint import save_checkpoint
from swiftsnails_tpu_torch.framework.quality import paired_corpus
from swiftsnails_tpu_torch.framework.trainer import TrainLoop
from swiftsnails_tpu_torch.freshness.publisher import gather_normalized_rows
from swiftsnails_tpu_torch.freshness.subscriber import DeltaSubscriber
from swiftsnails_tpu_torch.models.word2vec import Word2VecTrainer
from swiftsnails_tpu_torch.net.fleet import NetFleet, ReplicaSpawner
from swiftsnails_tpu_torch.ops import rowdma
from swiftsnails_tpu_torch.serving import Servant
from swiftsnails_tpu_torch.utils.config import Config

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA C++ with no "
                    "CPU build")
    return torch.device("cuda")


@pytest.mark.parametrize("layout,shape,dim", [
    ("packed", (4096, 2, 128), 200), ("packed_small", (512, 2, 128), 12),
    ("dense", (4096, 200), 200)])
def test_publisher_gather_on_the_card_equals_the_cpu(cuda_device, layout, shape, dim):
    """The publisher's gather of touched rows on the card (``gather_rows``
    for the packed layouts, one launch a call) equals its CPU run."""
    rng = np.random.default_rng(1)
    plane = rng.standard_normal(shape).astype(np.float32)
    cap = shape[0] * (8 if layout == "packed_small" else 1)
    rows = np.sort(rng.choice(cap, size=1001, replace=False)).astype(np.int64)
    n0 = rowdma.gather_rows.launches
    got = gather_normalized_rows(torch.from_numpy(plane).to(cuda_device), rows,
                                 layout=layout, dim=dim)
    want = gather_normalized_rows(torch.from_numpy(plane), rows, layout=layout, dim=dim)
    np.testing.assert_array_equal(got, want)
    assert rowdma.gather_rows.launches == n0 + (layout != "dense")


def _cfg(**over):
    cfg = Config({"dim": "200", "window": "2", "negatives": "2", "learning_rate": "0.5",
                  "num_iters": "4", "batch_size": "256", "subsample": "0", "seed": "0",
                  "pool_size": "8", "pool_block": "64"})
    for k, v in over.items():
        cfg.set(k, str(v))
    return cfg


def _trainer(cfg):
    ids, vocab = paired_corpus(n_pairs=512, reps=20000, seed=0)
    return Word2VecTrainer(cfg, corpus_ids=ids, vocab=vocab)


def test_resident_publish_on_the_card_is_bit_exact_to_the_next_checkpoint(cuda_device,
                                                                         tmp_path):
    root, d = str(tmp_path / "ck"), str(tmp_path / "log")
    TrainLoop(_trainer(_cfg(param_backup_root=root, param_backup_period=2)),
              log_every=0).run(max_steps=2)
    sv = Servant.from_checkpoint(root, _cfg())
    writes = rowdma.scatter_write_rows.launches
    loop = TrainLoop(_trainer(_cfg(param_backup_root=root, param_backup_period=8,
                                   resume="auto", freshness_publish=1, freshness_dir=d)),
                     log_every=0)
    loop.run(max_steps=8)
    assert DeltaSubscriber(sv, d).poll() == 6 and sv.step == 8
    assert rowdma.scatter_write_rows.launches - writes == 2 * 6  # a table a batch
    with Servant.from_checkpoint(root, _cfg(), step=8) as ref:
        for name in ("in_table", "out_table"):
            assert torch.equal(sv._tables[name], ref._tables[name]), name
    sv.close()


def test_a_replica_process_on_the_card_serves_the_checkpoint(cuda_device, tmp_path):
    """``python -m swiftsnails_tpu_torch.net.replica_server`` with no
    ``--device``: the card; its pulls equal the in-process servant's and its
    ``stats`` RPC counts its ``gather_rows`` launches."""
    root = str(tmp_path / "ck")
    save_checkpoint(root, _trainer(_cfg()).init_state(), step=1, wait=True)
    proc, fleet = None, None
    try:
        proc = ReplicaSpawner(root, _cfg(), startup_timeout_s=240.0).spawn()
        fleet = NetFleet.connect([(proc.host, proc.port)], _cfg())
        ids = np.arange(0, 1024, 7, dtype=np.int64)
        with Servant.from_checkpoint(root, _cfg()) as local:
            np.testing.assert_array_equal(fleet.pull(ids), local.pull(ids))
        st = fleet.replicas()[0].servant.stats()
        assert st["launches"]["gather_rows"] > 0
        assert fleet.replicas()[0].servant.health()["status"] == "ok"
    finally:
        if fleet is not None:
            fleet.close()
        if proc is not None:
            proc.close()
