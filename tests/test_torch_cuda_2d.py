"""Card tests of the 2-D table plane and the per-pair substeps.

Every test here needs an NVIDIA GPU and skips without one. The file imports
nothing of JAX, so it runs on the card's machine with

    python -m pytest tests/test_torch_cuda_2d.py --noconftest -q

The 2-D push is ``index_put_`` with ``accumulate=True``, a sort-based kernel
on the card: two runs give the same bits, and the card agrees with the CPU
within the order of the f32 sums: on a row with thousands of duplicates
the card's sums differ from the CPU's serial ones beyond 1e-5.
"""

import numpy as np
import pytest
import torch

from swiftsnails_tpu_torch.parallel import store
from swiftsnails_tpu_torch.parallel.access import AdaGradAccess, SgdAccess

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _case(seed, c=4096, dim=17, n=50_000):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(c, dim)).astype(np.float32)
    accum = (rng.random((c, dim)) * 0.1).astype(np.float32)
    rows = np.minimum(rng.zipf(1.2, n) - 1, c + 2).astype(np.int32)  # some past C
    grads = rng.normal(size=(n, dim)).astype(np.float32)
    return table, accum, rows, grads


@pytest.mark.parametrize("rule", ["sgd", "adagrad", "adagrad_exact"])
def test_push_card_repeatable_and_equal_to_cpu(cuda_device, rule):
    table, accum, rows, grads = _case(1)
    access = SgdAccess() if rule == "sgd" else AdaGradAccess()

    def run(device):
        slots = {} if rule == "sgd" else {"accum": torch.tensor(accum, device=device)}
        st = store.TableState(torch.tensor(table, device=device), slots)
        store.push(st, torch.tensor(rows, device=device), torch.tensor(grads, device=device),
                   access, 0.1, exact=rule == "adagrad_exact")
        return st

    a, b, cpu = run(cuda_device), run(cuda_device), run("cpu")
    assert torch.equal(a.table, b.table)
    for k in a.slots:
        assert torch.equal(a.slots[k], b.slots[k])
    # a hot row's ~10,000 duplicates add up in another order than the CPU's
    # serial loop: the change agrees within 1e-4 of its largest element
    moved = cpu.table.numpy() - table
    np.testing.assert_allclose(a.table.cpu().numpy() - table, moved, rtol=0,
                               atol=1e-4 * float(np.abs(moved).max()))


def test_dense_and_perpair_substeps_card_equal_cpu(cuda_device):
    from swiftsnails_tpu_torch import convert
    from swiftsnails_tpu_torch.data.vocab import Vocab
    from swiftsnails_tpu_torch.models.word2vec import Word2VecTrainer
    from swiftsnails_tpu_torch.ops import rowdma
    from swiftsnails_tpu_torch.utils.config import Config

    rng = np.random.default_rng(0)
    v = 2048
    ids = rng.integers(0, v, 40_000).astype(np.int32)
    vocab = Vocab([f"w{i}" for i in range(v)], np.bincount(ids, minlength=v))
    for over, method, kernels in (({"packed": "0"}, "_substep_dense", 0),
                                  ({"neg_mode": "per_pair"}, "_substep_packed_perpair", 2)):
        conf = Config({"dim": "200", "window": "3", "negatives": "5", "batch_size": "1024",
                       "learning_rate": "50", "subsample": "0", **over})
        trainers = {d: Word2VecTrainer(conf, corpus_ids=ids, vocab=vocab, device=d)
                    for d in ("cpu", "cuda")}
        init = trainers["cpu"].init_state()
        tables = [t.table.numpy() for t in init]
        batches = [b for _, b in zip(range(3), trainers["cpu"].batches())]
        negs = [rng.integers(0, v, (1024, 5)).astype(np.int32) for _ in batches]
        out = {}
        for d, tr in trainers.items():
            state = convert.w2v_state_from_numpy(*tables, device=d)
            before = rowdma.gather_rows.launches
            for b, ng in zip(batches, negs):
                state, loss = getattr(tr, method)(
                    state, torch.from_numpy(b["centers"]).to(d),
                    torch.from_numpy(b["contexts"]).to(d), None, tr.lr,
                    negs=torch.from_numpy(ng).to(d))
            if d == "cuda":
                assert rowdma.gather_rows.launches - before == kernels * len(batches)
            out[d] = (state, float(loss))
        np.testing.assert_allclose(out["cuda"][1], out["cpu"][1], rtol=1e-5)
        for a, b in zip(out["cuda"][0], out["cpu"][0]):
            np.testing.assert_allclose(a.table.cpu().numpy(), b.table.numpy(),
                                       rtol=1e-5, atol=1e-6)
