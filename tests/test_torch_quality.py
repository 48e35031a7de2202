"""The port's quality probe (``framework/quality.py``) against the JAX package's, on the CPU.

``pair_top1_hits`` scores a state carried over from the JAX package exactly
as the JAX function scores it, on packed and 2-D tables; the probe corpus
and config are the JAX module's. ``probe_top1`` trains the probe on the CPU
(the kernels' plain versions) and must clear ``MIN_TOP1`` on the paths the
JAX CI gates with the same bar (``tests/test_path_quality.py``): ``dense``,
``packed_perpair`` and ``packed_pool``. The fused paths' scores on the card
are ``chip_smoke.py``'s ``quality`` phase.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from swiftsnails_tpu.framework import quality as jax_quality
from swiftsnails_tpu.models import word2vec as jax_w2v
from swiftsnails_tpu.utils.config import Config as JaxConfig
from swiftsnails_tpu_torch import convert
from swiftsnails_tpu_torch.framework import quality
from swiftsnails_tpu_torch.models import word2vec
from swiftsnails_tpu_torch.utils.config import Config

# the JAX test's paths that its CI gates at MIN_TOP1 with the plain math
GATED = {
    "dense": {"packed": "0"},
    "packed_perpair": {"packed": "1", "neg_mode": "per_pair"},
    "packed_pool": {"packed": "1", "neg_mode": "pool"},
}


def test_constants_and_corpus_match_jax():
    assert quality.MIN_TOP1 == jax_quality.MIN_TOP1 == 0.75
    assert quality.PROBE_CONFIG == jax_quality.PROBE_CONFIG
    ids, vocab = quality.paired_corpus()
    jids, jvocab = jax_quality.paired_corpus()
    np.testing.assert_array_equal(ids, jids)
    assert vocab.words == jvocab.words
    np.testing.assert_array_equal(vocab.counts, jvocab.counts)


@pytest.mark.parametrize("path", ["dense", "packed_pool", "hashed"])
def test_pair_top1_hits_on_a_carried_state_equals_jax(path):
    """A JAX state trained a few steps on the probe corpus, carried into the
    port, scores the same hits in both packages."""
    over = {"hashed": {"hash_keys": "1", "capacity": "256"}}.get(path, GATED.get(path))
    ids, vocab = jax_quality.paired_corpus()
    cfg = {**jax_quality.PROBE_CONFIG, **over, "use_native": "0", "num_iters": "1"}
    jt = jax_w2v.Word2VecTrainer(JaxConfig(cfg), mesh=None, corpus_ids=ids, vocab=vocab)
    state = jt.init_state()
    step = jax.jit(jt.train_step)
    for i, batch in zip(range(12), jt.batches()):
        state, _ = step(state, {k: jnp.asarray(v) for k, v in batch.items()},
                        jax.random.PRNGKey(i))
    want = jax_quality.pair_top1_hits(jt, state)
    tv, _ = quality.paired_corpus()
    tt = word2vec.Word2VecTrainer(Config(cfg), corpus_ids=tv, vocab=quality.paired_corpus()[1],
                                  device="cpu")
    carried = convert.w2v_state_from_numpy(np.asarray(state.in_table.table),
                                           np.asarray(state.out_table.table), device="cpu")
    got = quality.pair_top1_hits(tt, carried)
    assert got == want and 0 < want[0] < want[1] == 64


@pytest.mark.parametrize("name", list(GATED))
def test_probe_passes_min_top1_on_the_cpu(name):
    top1 = quality.probe_top1(GATED[name], device="cpu")
    assert top1 >= quality.MIN_TOP1, f"{name}: pair top-1 {top1:.3f} < {quality.MIN_TOP1}"


def test_probe_defaults_to_the_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the default is then valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        quality.probe_top1(GATED["dense"])
