"""The port's placement policy (``parallel/placement.py``), the trainers'
placement decisions and the ledger's placement and zero gates, against the
JAX package, on the CPU.

* ``choose_cut`` returns the JAX decision dict on a zipf count vector and
  on a flat one, calibrated or not (``tests/test_hybrid_placement.py:
  113-140``); so do ``tail_cap``, ``candidate_cuts``, ``cap8`` and
  ``align_down`` on a grid, and ``resolve_placement``;
* the trainers' decisions on a ``(2, 2)`` mesh: ``hybrid``'s cut, ``auto``
  from the vocabulary's CDF (``tests/test_hybrid_placement.py:295``), the
  uniform fallback without a mesh with its ``reason``, and ``auto`` on the
  hashed CTR table; the ``placement_spec`` each hands ``PlacementManager``;
* ``PlacementManager`` inactive under uniform placement;
* the two ledger gates on the same records as the JAX ones: a clean lane
  passes, each broken leg trips, no history gates nothing.

The trainers are made on a hand-built ``Mesh`` (no process group: making
one runs no collective).
"""

import numpy as np
import pytest
import torch

import jax

from swiftsnails_tpu.framework.quality import paired_corpus as jax_paired_corpus
from swiftsnails_tpu.models.registry import get_model as jax_get_model
from swiftsnails_tpu.models.word2vec import Word2VecTrainer as JaxW2V
from swiftsnails_tpu.parallel import mesh as jax_mesh
from swiftsnails_tpu.parallel import placement as jax_placement
from swiftsnails_tpu.telemetry import ledger as jax_ledger
from swiftsnails_tpu.utils.config import Config as JaxConfig
from swiftsnails_tpu_torch.parallel import placement
from swiftsnails_tpu_torch.parallel.mesh import Mesh
from swiftsnails_tpu_torch.parallel.placement import PlacementManager
from swiftsnails_tpu_torch.telemetry import ledger
import torch_mesh_ranks as ranks
import torch_placement_ranks as pr

ZIPF = (1e6 / np.arange(1, 4097) ** 1.4).astype(np.int64) + 1
FLAT = np.full(4096, 100, np.int64)


def _hand_mesh(data=2, model=2):
    return Mesh(shape={"data": data, "model": model}, coords={"data": 0, "model": 0},
                groups={}, device=torch.device("cpu"))


def _jax_mesh(data=2, model=2):
    return jax_mesh.make_mesh({"data": data, "model": model},
                              devices=jax.devices()[:data * model])


# ------------------------------------------------------ the pure functions ---


@pytest.mark.parametrize("counts", [ZIPF, FLAT], ids=["zipf", "flat"])
@pytest.mark.parametrize("kw", [
    {"align": 4, "local_slots": 2048, "row_elems": 128, "data": 2},
    {"align": 4, "local_slots": 2048, "row_elems": 128, "data": 2,
     "measured_uniform_bytes": 1_000_000.0},
    {"align": 8, "local_slots": 512, "row_elems": 256, "data": 4, "comm_dtype": "int8"},
    {"align": 2, "local_slots": 4096, "row_elems": 200, "data": 2, "comm_dtype": "int4",
     "slack": 1.5},
    {"align": 2, "local_slots": 1024, "row_elems": 16, "data": 8, "comm_dtype": "bfloat16",
     "max_head_frac": 0.25},
], ids=["f32", "calibrated", "int8", "int4", "bf16"])
def test_choose_cut_matches_jax(counts, kw):
    got = placement.choose_cut(counts, 4096, **kw)
    assert got == jax_placement.choose_cut(counts, 4096, **kw)


def test_choose_cut_zipf_picks_a_head_and_flat_stays_uniform():
    kw = {"align": 4, "local_slots": 2048, "row_elems": 128, "data": 2}
    d = placement.choose_cut(ZIPF, 4096, **kw)
    assert d["cut"] > 0 and d["cut"] % 4 == 0 and d["coverage"] > 0.5
    assert d["predicted_exchange_bytes"] < d["predicted_uniform_bytes"] / 2
    assert placement.choose_cut(FLAT, 4096, **kw)["cut"] == 0


@pytest.mark.parametrize("slots", [1, 7, 64, 1000, 4096])
@pytest.mark.parametrize("coverage", [0.0, 0.3, 0.9, 0.999, 1.0])
@pytest.mark.parametrize("slack", [1.0, 2.0, 8.0])
def test_tail_cap_matches_jax(slots, coverage, slack):
    assert placement.tail_cap(slots, coverage, slack) == jax_placement.tail_cap(
        slots, coverage, slack)


@pytest.mark.parametrize("capacity,align,vocab", [(4096, 4, 4096), (4096, 8, 300),
                                                  (1024, 2, 1000), (64, 16, 64), (16, 32, 8)])
def test_candidate_cuts_and_helpers_match_jax(capacity, align, vocab):
    assert placement.candidate_cuts(capacity, align, vocab) == jax_placement.candidate_cuts(
        capacity, align, vocab)
    for n in (0, 1, 7.5, 8, 100):
        assert placement.cap8(n) == jax_placement.cap8(n)
        assert placement.align_down(int(n), align) == jax_placement.align_down(int(n), align)


def test_resolve_placement_matches_jax():
    for name in (None, "uniform", "hybrid", "AUTO"):
        assert placement.resolve_placement(name) == jax_placement.resolve_placement(name)
    with pytest.raises(ValueError, match="unknown placement"):
        placement.resolve_placement("zipf")


# ------------------------------------------------------ trainer decisions ---


def _w2v_pair(data, model, **over):
    """The grouped word2vec trainer of ``torch_mesh_ranks`` with ``over``,
    in both packages, on a (data, model) mesh (None: one device)."""
    m = None if data is None else _hand_mesh(data, model)
    tr = ranks.grouped_trainer("grouped", m, **over)
    ids, vocab = jax_paired_corpus(n_pairs=ranks.GROUPED_CAP // 2, reps=ranks.GROUPED_REPS,
                                   seed=0)
    conf = ranks.grouped_conf(**over)
    conf.pop("use_native")
    jm = None if data is None else _jax_mesh(data, model)
    return tr, JaxW2V(JaxConfig(conf), mesh=jm, corpus_ids=ids, vocab=vocab)


@pytest.mark.parametrize("over", [
    {"placement": "hybrid"},
    {"placement": "hybrid", "placement_head_rows": "33"},
    {"placement": "hybrid", "placement_head_rows": "1"},  # rounds to 0: uniform
    {"placement": "auto"},
    {"placement": "auto", "placement_calib_bytes": "4000000"},
    {"placement": "auto", "comm_dtype": "int8"},
    {"placement": "auto", "hash_keys": "1"},
    {"placement": "hybrid", "packed": "0", "fused": "0", "grouped": "0"},
    {"placement": "auto", "packed": "0", "fused": "0", "grouped": "0"},
], ids=["hybrid", "head33", "head1", "auto", "auto_calib", "auto_int8", "auto_hashed",
        "hybrid_2d", "auto_2d"])
def test_word2vec_decision_matches_jax(over):
    """The cut, its coverage and the decision dict the run record carries,
    as the JAX trainer makes them on the same mesh shape."""
    tr, jt = _w2v_pair(2, 2, **over)
    assert tr.placement_cut == jt.placement_cut
    assert tr.placement_cov == jt.placement_cov
    assert tr.placement_decision == jt.placement_decision
    assert tr.placement_spec() == jt.placement_spec()


def test_auto_uses_the_vocab_cdf():
    """``placement: auto`` on a zipf vocabulary picks a head from its CDF
    (the corpus' counts, frequency-ranked): the decision carries the cost
    model's numbers and the coverage at the cut."""
    tr, jt = _w2v_pair(2, 2, placement="auto")
    d = tr.placement_decision
    assert d["requested"] == "auto" and "predicted_uniform_bytes" in d
    if d["mode"] == "hybrid":
        assert d["coverage"] == pytest.approx(tr.vocab.coverage_at(d["cut"]))
    assert d == jt.placement_decision


def test_auto_on_a_zipf_vocab_picks_a_head():
    """On a zipf vocabulary of 4,096 words ``auto`` cuts a head (the
    decision the JAX trainer makes from the same counts)."""
    from swiftsnails_tpu.data.vocab import Vocab as JaxVocab
    from swiftsnails_tpu_torch.data.vocab import Vocab
    from swiftsnails_tpu_torch.models.word2vec import Word2VecTrainer

    words = [f"w{i}" for i in range(len(ZIPF))]
    ids = np.random.default_rng(0).integers(0, len(ZIPF), 20_000).astype(np.int32)
    conf = ranks.grouped_conf(placement="auto", capacity="4096")
    tr = Word2VecTrainer(ranks.Config(conf), mesh=_hand_mesh(), corpus_ids=ids,
                         vocab=Vocab(words, ZIPF), device="cpu")
    conf.pop("use_native")
    jt = JaxW2V(JaxConfig(conf), mesh=_jax_mesh(), corpus_ids=ids, vocab=JaxVocab(words, ZIPF))
    d = tr.placement_decision
    assert d["mode"] == "hybrid" and d["cut"] > 0 and d["coverage"] > 0.5
    assert d["predicted_exchange_bytes"] < d["predicted_uniform_bytes"]
    assert d == jt.placement_decision


def test_uniform_fallback_without_a_mesh():
    tr, jt = _w2v_pair(None, None, placement="hybrid")
    assert tr.placement_cut == 0 and tr.placement_spec() is None
    assert tr.placement_decision == jt.placement_decision
    assert tr.placement_decision["mode"] == "uniform"
    assert "mesh" in tr.placement_decision["reason"]
    assert not PlacementManager(tr).active


@pytest.mark.parametrize("over", [
    {"placement": "hybrid"}, {"placement": "hybrid", "placement_head_rows": "100"},
    {"placement": "auto"}, {"placement": "hybrid", "packed": "0"},
    {"placement": "hybrid", "optimizer_sharding": "zero"}], ids=lambda o: "-".join(o.values()))
def test_ctr_decision_matches_jax(over):
    """W&D's hashed table: ``hybrid`` aligned to a tile a model shard (the
    model axis on the 2-D plane), ``auto`` uniform with its reason."""
    tr = pr.wd_trainer(_hand_mesh(), **{"placement_head_rows": "0", **over})
    conf = {**pr.WD_KEYS, "placement_head_rows": "0", **over}
    jt = jax_get_model("widedeep")(JaxConfig(conf), mesh=_jax_mesh(), data=pr.wd_data())
    assert tr.placement_cut == jt.placement_cut
    assert tr.placement_decision == jt.placement_decision
    assert tr.placement_spec() == jt.placement_spec()


def test_ctr_uniform_fallback_without_a_mesh():
    tr = pr.wd_trainer(None)
    jt = jax_get_model("widedeep")(JaxConfig(pr.WD_KEYS), data=pr.wd_data())
    assert tr.placement_cut == 0 and not PlacementManager(tr).active
    assert tr.placement_decision == jt.placement_decision
    assert "no mesh" in tr.placement_decision["reason"]


def test_placement_manager_is_inactive_under_uniform_placement():
    tr, _ = _w2v_pair(2, 2)
    pm = PlacementManager(tr)
    assert not pm.active and pm.summary() == {}
    state = tr.init_state()
    assert pm.adopt(state) is state and pm.master_state(state) is state


# ------------------------------------------------------- the ledger gates ---


def _bench(**payload):
    return ("bench", {"payload": {"metric": "word2vec_words_per_sec_per_chip",
                                  "value": 1000.0, "unit": "words/sec/chip",
                                  "platform": "tpu", "config": {}, **payload}})


def _skewed(reduction, per=True):
    block = {"zipf_s": 1.4, "vocab": 4096,
             "decision": {"mode": "hybrid", "cut": 512, "replicated_rows": 1024,
                          "coverage": 0.96}}
    if per:
        block["per_dtype"] = {"float32": {"exchange_reduction": reduction},
                              "int8": {"exchange_reduction": reduction + 1}}
    return {"aggregate_words_per_sec": 1e6, "skewed": block}


def _zero(reduction=4.0, parity=0.0, identical=True, zero_bytes=1 << 20,
          baseline_bytes=1 << 20, data=4, skipped=False):
    return {"n_devices": 8, "mesh": {"data": data, "model": 2}, "skipped": skipped,
            "hbm": {"planes": 6, "replicated_bytes": 4 << 20,
                    "sharded_bytes_per_replica": int((4 << 20) / reduction),
                    "reduction": reduction},
            "grad_reduce": {"baseline_bytes": baseline_bytes, "zero_bytes": zero_bytes},
            "loss_parity_f32": parity, "checkpoint_identical": identical}


GATES = {
    "empty": ("placement", []),
    "no_skew": ("placement", [_bench(), _bench(scaling={"aggregate_words_per_sec": 1e6})]),
    "skew_ok": ("placement", [_bench(), _bench(scaling=_skewed(2.6))]),
    "skew_floor": ("placement", [_bench(), _bench(scaling=_skewed(2.0))]),
    "skew_low": ("placement", [_bench(), _bench(scaling=_skewed(1.4))]),
    "skew_no_rows": ("placement", [_bench(scaling=_skewed(3.0, per=False))]),
    "skew_na": ("placement", [_bench(scaling={"skewed": {"per_dtype": {
        "float32": {"exchange_reduction": None}}}})]),
    "zero_empty": ("zero", [_bench()]),
    "zero_skipped": ("zero", [_bench(zero=_zero(reduction=1.0, skipped=True))]),
    "zero_ok": ("zero", [_bench(), _bench(zero=_zero())]),
    "zero_hbm": ("zero", [_bench(zero=_zero(reduction=1.2))]),
    "zero_hbm_one_shard": ("zero", [_bench(zero=_zero(reduction=1.0, data=1))]),
    "zero_parity": ("zero", [_bench(zero=_zero(parity=0.05))]),
    "zero_ckpt": ("zero", [_bench(zero=_zero(identical=False))]),
    "zero_bytes": ("zero", [_bench(zero=_zero(zero_bytes=1 << 21))]),
    "zero_all": ("zero", [_bench(zero=_zero(reduction=1.5, parity=0.2, identical=None,
                                            zero_bytes=1 << 22))]),
}


@pytest.mark.parametrize("case", sorted(GATES))
def test_gate_matches_jax(tmp_path, case):
    """Each gate's code and message on the same records as the JAX gate's;
    a clean lane passes, each broken leg trips, no history says nothing;
    both gates are among the port's plane checks, in the JAX order."""
    which, records = GATES[case]
    path = str(tmp_path / "gate.jsonl")
    led = ledger.Ledger(path)
    for kind, rec in records:
        led.append(kind, rec)
    name = f"_check_{which}_regression"
    got = getattr(ledger, name)(led)
    assert got == getattr(jax_ledger, name)(jax_ledger.Ledger(path))
    if case.endswith("empty") or case in ("no_skew", "zero_skipped"):
        assert got == (0, None)
    elif case.endswith("ok") or case in ("skew_floor", "zero_hbm_one_shard"):
        assert got[0] == 0 and "ok" in got[1]
    else:
        assert got[0] == 1 and "REGRESSION" in got[1]
    checks = ledger._plane_checks(10.0)
    order = [ledger._check_chaos_cluster_regression, ledger._check_placement_regression,
             ledger._check_quantized_wire_regression]
    assert [c for c in checks if c in order] == order
    assert checks[-2] is ledger._check_zero_regression


@pytest.mark.parametrize("case", ["skew_low", "zero_ckpt", "zero_ok"])
def test_check_regression_carries_the_gates(tmp_path, case):
    """``check_regression`` (``ledger-report --check-regression``) fails on
    a tripped gate and names it, as the JAX package's does."""
    path = str(tmp_path / "gate.jsonl")
    led = ledger.Ledger(path)
    for kind, rec in GATES[case][1]:
        led.append(kind, rec)
    got = ledger.check_regression(led, 10.0)
    rc, msg = got
    assert rc == (0 if case == "zero_ok" else 1)
    assert ("REGRESSION" in msg) == (rc == 1)
