"""The port's CUDA kernels and its slice on the card.

Every test here needs an NVIDIA GPU and skips without one. The file imports
neither JAX nor the JAX package, so on a machine with a card and no JAX it
runs without the suite's conftest:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from swiftsnails_tpu_torch.ops import rowdma

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA C++ with no "
                    "CPU build")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [1, 2])
def test_kernels_bit_equal_to_plain(cuda_device, dtype, s):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    c = 4096
    table = torch.randn(c, s, 128, generator=gen, device=cuda_device).to(dtype)
    rows = torch.randint(0, c, (1001,), generator=gen, device=cuda_device,
                         dtype=torch.int32)
    n0 = rowdma.gather_rows.launches
    got = rowdma.gather_rows(table, rows)
    assert rowdma.gather_rows.launches == n0 + 1
    assert torch.equal(got, rowdma.gather_rows_plain(table, rows))

    uniq = torch.unique(rows)
    pad = torch.full((37,), c, dtype=torch.int32, device=cuda_device)
    srows = torch.cat([uniq, pad])
    deltas = torch.randn(srows.shape[0], s, 128, generator=gen,
                         device=cuda_device).to(dtype)
    want = rowdma.scatter_add_rows_plain(table.clone(), srows, deltas)
    n0 = rowdma.scatter_add_rows.launches
    got = rowdma.scatter_add_rows(table, srows, deltas)
    torch.cuda.synchronize()
    assert rowdma.scatter_add_rows.launches == n0 + 1
    assert torch.equal(got, want)


def test_gather_out_of_range_ids_read_nothing(cuda_device):
    table = torch.ones(16, 1, 128, device=cuda_device)
    rows = torch.tensor([0, 16, -1, 15], dtype=torch.int32, device=cuda_device)
    got = rowdma.gather_rows(table, rows)
    torch.cuda.synchronize()
    assert got[[0, 3]].eq(1).all() and not got[[1, 2]].any()


def test_wrapper_rejects_rows_not_in_16_byte_words(cuda_device):
    rows = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    narrow = torch.zeros(16, 6, device=cuda_device)  # 24-byte rows
    with pytest.raises(ValueError, match="16-byte words"):
        rowdma.gather_rows(narrow, rows)
    shifted = torch.zeros(16 * 128 + 1, device=cuda_device)[1:].view(16, 128)
    with pytest.raises(ValueError, match="16-byte words"):
        rowdma.scatter_add_rows(shifted, rows, torch.zeros(2, 128, device=cuda_device))
    assert rowdma.gather_rows(shifted[:, :124].contiguous(), rows).shape == (2, 124)


def test_wrapper_rejects_a_cpu_rows_tensor(cuda_device):
    with pytest.raises(ValueError, match="rows on cpu"):
        rowdma.gather_rows(torch.zeros(4, 1, 128, device=cuda_device),
                           torch.zeros(2, dtype=torch.int32))


def test_train_loop_launches_both_kernels(cuda_device):
    from swiftsnails_tpu_torch.data.vocab import Vocab
    from swiftsnails_tpu_torch.framework.trainer import TrainLoop
    from swiftsnails_tpu_torch.models.word2vec import Word2VecTrainer
    from swiftsnails_tpu_torch.utils.config import Config

    rng = np.random.default_rng(0)
    ids = rng.integers(0, 300, 20_000).astype(np.int32)
    vocab = Vocab([f"w{i}" for i in range(300)], np.bincount(ids, minlength=300) + 1)
    cfg = Config({"dim": "200", "window": "3", "negatives": "5",
                  "batch_size": "1024", "subsample": "0", "steps_per_call": "2",
                  "pool_size": "16", "pool_block": "128"})
    trainer = Word2VecTrainer(cfg, corpus_ids=ids, vocab=vocab)
    assert trainer.device.type == "cuda"
    before = (rowdma.gather_rows.launches, rowdma.scatter_add_rows.launches)
    state = TrainLoop(trainer, log_every=0).run(max_steps=3)
    after = (rowdma.gather_rows.launches, rowdma.scatter_add_rows.launches)
    assert [a - b for a, b in zip(after, before)] == [12, 12]  # 3 calls x 2 substeps x 2
    assert all(torch.isfinite(t.table).all() for t in state)
