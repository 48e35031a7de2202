"""``seqlm`` on the card against the CPU, at the JAX tests' size (seq_len 32,
1 layer, 2 heads, d_model 32, vocab 32).

Every test here needs an NVIDIA GPU and skips without one. The file imports
neither JAX nor the JAX package, so on a machine with a card it runs
without the suite's conftest:

    python -m pytest tests/test_torch_cuda_seqlm.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from swiftsnails_tpu_torch.framework.trainer import TrainLoop
from swiftsnails_tpu_torch.models.seqlm import SeqLMTrainer, param_leaves
from swiftsnails_tpu_torch.utils.config import Config
from swiftsnails_tpu_torch.utils.tree import map_tensors, tensor_items

pytestmark = pytest.mark.cuda

RATES = {"sgd": "0.1", "momentum": "0.05", "adam": "0.003", "adamw": "0.003"}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _trainer(device, **kw):
    rng = np.random.default_rng(0)
    ids = (np.cumsum(rng.random(6000) < 0.95) % 32).astype(np.int32)
    conf = {"seq_len": "32", "n_layers": "1", "n_heads": "2", "d_model": "32",
            "batch_size": "8", "num_iters": "2", **{k: str(v) for k, v in kw.items()}}
    return SeqLMTrainer(Config(conf), device=device, corpus_ids=ids, vocab_size=32)


@pytest.mark.parametrize("optimizer", sorted(RATES))
def test_three_steps_on_the_card_match_the_cpu(cuda_device, optimizer):
    """From one state, 3 steps on each device: losses within rtol 1e-5, the
    parameters (and an adam's moments) within rtol 1e-4 / atol 1e-5."""
    kw = {"optimizer": optimizer, "learning_rate": RATES[optimizer]}
    card, host = _trainer(cuda_device, **kw), _trainer("cpu", **kw)
    state = card.init_state()
    cpu_state = map_tensors(state, lambda _, t: t.cpu().clone())
    for b in list(card.batches())[:3]:
        toks = torch.from_numpy(b["tokens"])
        state, m = card.train_step(state, {"tokens": toks.to(cuda_device)})
        cpu_state, cm = host.train_step(cpu_state, {"tokens": toks})
        np.testing.assert_allclose(float(m["loss"]), float(cm["loss"]), rtol=1e-5)
    for (key, a), (_, b) in zip(tensor_items(state), tensor_items(cpu_state)):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-5, msg=key)


def test_train_loop_resumes_bit_for_bit_on_the_card(cuda_device, tmp_path):
    kw = {"optimizer": "adam", "learning_rate": "0.003"}
    straight = TrainLoop(_trainer(cuda_device, **kw), log_every=0).run(max_steps=8)
    ck = dict(kw, param_backup_root=str(tmp_path / "ck"), param_backup_period=4,
              resume="auto")
    TrainLoop(_trainer(cuda_device, **ck), log_every=0).run(max_steps=4)
    resumed = TrainLoop(_trainer(cuda_device, **ck), log_every=0).run(max_steps=8)
    assert resumed["params"]["embed"].is_cuda
    for (key, a), (_, b) in zip(tensor_items(straight), tensor_items(resumed)):
        assert torch.equal(a, b), key
    assert len(param_leaves(resumed["params"])) == 6
