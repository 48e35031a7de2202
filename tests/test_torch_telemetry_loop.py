"""The loop's telemetry as a whole, in both packages: a small word2vec run
(dim 16, ``dense`` and ``packed+pool``, on the CPU) with every telemetry
key — ``telemetry``, ``trace_path``, ``ledger_path``, ``profile_dir``,
``profile_cadence``, ``drift_detect``, checkpoints — writes the same ledger
event kinds in the same order, the same run-record and goodput keys, and the
same span names and counts a step. Then: ``resume: auto`` prefers a
ledger-known step, the CPU ``profile_dir`` capture is a Chrome trace of the
window's steps, telemetry off builds nothing, and the loop keys of planes
still to port raise."""

import json
import os
from collections import Counter

import jax
import numpy as np
import pytest

from swiftsnails_tpu.data.vocab import Vocab as JaxVocab
from swiftsnails_tpu.framework.trainer import TrainLoop as JaxTrainLoop
from swiftsnails_tpu.models.word2vec import Word2VecTrainer as JaxWord2Vec
from swiftsnails_tpu.utils.config import Config as JaxConfig

from swiftsnails_tpu_torch.data.vocab import Vocab
from swiftsnails_tpu_torch.framework import checkpoint as ckpt
from swiftsnails_tpu_torch.framework.trainer import TrainLoop
from swiftsnails_tpu_torch.models.word2vec import Word2VecTrainer
from swiftsnails_tpu_torch.telemetry.ledger import Ledger
from swiftsnails_tpu_torch.utils.config import Config
from swiftsnails_tpu_torch.utils.metrics import MetricsLogger

STEPS = 12
PATHS = {"dense": {"packed": 0}, "packed_pool": {}}


def _corpus():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 120, 20_000).astype(np.int32)
    counts = np.maximum(np.bincount(ids, minlength=120), 1)
    return ids, [f"w{i}" for i in range(120)], counts


def _conf(d, **over):
    conf = {"dim": "16", "window": "2", "negatives": "2", "learning_rate": "0.3",
            "batch_size": "128", "subsample": "0", "num_iters": "1", "pool_size": "8",
            "pool_block": "32", "use_native": "0", "seed": "3",
            "telemetry": "1", "trace_path": os.path.join(d, "trace.json"),
            "ledger_path": os.path.join(d, "ledger.jsonl"),
            "profile_dir": os.path.join(d, "prof"), "profile_steps": "3,6",
            "profile_cadence": "2", "drift_detect": "1", "drift_cusum_h": "1e6",
            "param_backup_period": "4", "param_backup_root": os.path.join(d, "ck"),
            "blackbox_dir": os.path.join(d, "bb"), "incident_dir": os.path.join(d, "inc"),
            "profile_export": os.path.join(d, "ts.jsonl")}
    conf.update({k: str(v) for k, v in over.items()})
    return conf


def _port_run(d, **over):
    ids, words, counts = _corpus()
    tr = Word2VecTrainer(Config(_conf(d, **over)), corpus_ids=ids,
                         vocab=Vocab(words, counts), device="cpu")
    loop = TrainLoop(tr, metrics=MetricsLogger(echo=False), log_every=1)
    loop.run(seed=1, max_steps=STEPS)
    return loop


def _jax_run(d, monkeypatch, **over):
    # the JAX package's own profiling tests stub the XLA trace calls
    monkeypatch.setattr(jax.profiler, "start_trace", lambda _d: None)
    monkeypatch.setattr(jax.profiler, "stop_trace", lambda: None)
    ids, words, counts = _corpus()
    tr = JaxWord2Vec(JaxConfig(_conf(d, **over)), mesh=None, corpus_ids=ids,
                     vocab=JaxVocab(words, counts))
    loop = JaxTrainLoop(tr, metrics=MetricsLogger(echo=False), log_every=1)
    loop.run(seed=1, max_steps=STEPS)
    return loop


def _spans(d):
    doc = json.load(open(os.path.join(d, "trace.json")))
    return Counter(e["name"] for e in doc["traceEvents"] if e["ph"] == "X")


@pytest.fixture(scope="module", params=sorted(PATHS))
def runs(request, tmp_path_factory):
    mp = pytest.MonkeyPatch()
    try:
        port_d = str(tmp_path_factory.mktemp("port"))
        jax_d = str(tmp_path_factory.mktemp("jax"))
        _port_run(port_d, **PATHS[request.param])
        _jax_run(jax_d, mp, **PATHS[request.param])
    finally:
        mp.undo()
    return request.param, port_d, jax_d


def test_same_ledger_event_kinds_in_order(runs):
    _, port_d, jax_d = runs
    port = [r["kind"] for r in Ledger(os.path.join(port_d, "ledger.jsonl")).records()]
    ref = [r["kind"] for r in Ledger(os.path.join(jax_d, "ledger.jsonl")).records()]
    assert port == ref == ["checkpoint"] * (STEPS // 4) + ["run"]
    steps = [r["step"] for r in Ledger(os.path.join(port_d, "ledger.jsonl")).records("checkpoint")]
    assert steps == [4, 8, 12]


def test_same_run_record_and_goodput_keys(runs):
    _, port_d, jax_d = runs
    port = Ledger(os.path.join(port_d, "ledger.jsonl")).latest("run")
    ref = Ledger(os.path.join(jax_d, "ledger.jsonl")).latest("run")
    # both trainers name their wire format (comm_dtype)
    assert port["comm_dtype"] == ref["comm_dtype"] == "float32"
    assert sorted(port) == sorted(ref)
    assert sorted(port["goodput"]) == sorted(ref["goodput"])
    assert sorted(port["goodput"]["decomposition"]) == sorted(ref["goodput"]["decomposition"])
    assert (port["steps"], port["items"]) == (ref["steps"], ref["items"]) == (STEPS, STEPS * 128)
    assert port["goodput"]["flops_per_step"] > 0 and port["goodput"]["hbm_bytes_per_step"] > 0
    assert port["goodput"]["mfu"] is None is ref["goodput"]["mfu"]  # no CPU peak
    assert port["goodput"]["peaks"] == ref["goodput"]["peaks"]
    assert port["env"]["devices"]["platform"] == "cpu"
    # the time series: the same signals, except the collective bytes a JAX
    # audit counts (0 on one device); the port counts none on one card
    # (step_cost's total_bytes is None)
    names = set(port["timeseries"]["series"])
    assert names == set(ref["timeseries"]["series"]) - {"exchange_bytes"}
    assert port["drift"]["detectors"].keys() == ref["drift"]["detectors"].keys()


def test_same_span_names_and_counts_a_step(runs):
    path, port_d, jax_d = runs
    port, ref = _spans(port_d), _spans(jax_d)
    assert port == ref
    assert port["word2vec"] == port["step"] == port["h2d"] == STEPS
    assert port["metrics-flush"] == STEPS and port["checkpoint"] == STEPS // 4
    assert port["prefetch-wait"] == STEPS
    rows = [json.loads(ln) for ln in open(os.path.join(port_d, "ts.jsonl"))]
    assert [r["step"] for r in rows] == list(range(2, STEPS + 1, 2))


def test_cpu_profile_capture_is_written(runs):
    _, port_d, _ = runs
    (name,) = os.listdir(os.path.join(port_d, "prof"))
    assert name.endswith("-steps3-6.json")
    events = json.load(open(os.path.join(port_d, "prof", name)))["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"word2vec#3", "word2vec#4", "word2vec#5"} <= names
    assert "word2vec#6" not in names


def test_resume_auto_prefers_a_ledger_known_step(tmp_path):
    """A run writes ledger-known saves; a newer step directory the ledger
    lacks (a torn save) is passed over for the newest step the ledger
    knows, and the resumed run says so in the same ledger."""
    d = str(tmp_path)
    _port_run(d, packed=0, telemetry=0, trace_path="", profile_dir="")
    root = os.path.join(d, "ck")
    led = Ledger(os.path.join(d, "ledger.jsonl"))
    known = [r["step"] for r in led.records("checkpoint")]
    assert known == [4, 8, 12] and ckpt.intact_steps(root) == [12, 8, 4]
    torn = os.path.join(root, "step_20")
    os.makedirs(torn)
    open(os.path.join(torn, "in_table.table.bin"), "wb").write(b"\0" * 64)
    from swiftsnails_tpu_torch.resilience.resume import _ledger_known_steps

    loop = TrainLoop(Word2VecTrainer(
        Config(_conf(d, packed=0, resume="auto", telemetry=0, trace_path="",
                     profile_dir="")),
        corpus_ids=_corpus()[0], vocab=Vocab(*_corpus()[1:]), device="cpu"), log_every=0)
    assert _ledger_known_steps(led, root, loop.config_hash) == [12, 8, 4]
    loop.run(seed=1, max_steps=STEPS + 4)
    assert loop._restored_step == 12
    kinds = [r["kind"] for r in led.records()]
    assert kinds[:3] == ["checkpoint"] * 3 and kinds.count("checkpoint") == 4


def test_resume_auto_walks_back_with_a_cache_error(tmp_path):
    from swiftsnails_tpu_torch.resilience.chaos import corrupt_checkpoint_dir

    d = str(tmp_path)
    _port_run(d, packed=0, telemetry=0, trace_path="", profile_dir="")
    corrupt_checkpoint_dir(os.path.join(d, "ck"))  # the newest, step 12
    loop = TrainLoop(Word2VecTrainer(
        Config(_conf(d, packed=0, resume="auto", telemetry=0, trace_path="",
                     profile_dir="")),
        corpus_ids=_corpus()[0], vocab=Vocab(*_corpus()[1:]), device="cpu"), log_every=0)
    loop.run(seed=1, max_steps=STEPS)
    assert loop._restored_step == 8
    errors = Ledger(os.path.join(d, "ledger.jsonl")).records("cache_error")
    assert len(errors) == 1 and errors[0]["path"].endswith("step_12")
    assert "CheckpointError" in errors[0]["error"]


def test_telemetry_off_builds_nothing(tmp_path):
    ids, words, counts = _corpus()
    cfg = Config({"dim": "8", "batch_size": "64", "subsample": "0", "use_native": "0",
                  "pool_block": "32", "pool_size": "8"})
    loop = TrainLoop(Word2VecTrainer(cfg, corpus_ids=ids, vocab=Vocab(words, counts),
                                     device="cpu"), log_every=0)
    assert loop.tracer is None and loop.registry is None and loop.blackbox is None
    assert loop.timeseries is None and loop.drift is None and loop.ledger is None
    assert not loop.profiler.enabled
    loop.run(max_steps=3)
    assert loop._step_cost is None and os.listdir(tmp_path) == []
    # a ledger alone records the resilience events, with no tracer
    cfg = Config({**cfg.as_dict(), "ledger_path": str(tmp_path / "l.jsonl"),
                  "chaos_spec": "preempt@1"})
    loop = TrainLoop(Word2VecTrainer(cfg, corpus_ids=ids, vocab=Vocab(words, counts),
                                     device="cpu"), log_every=0)
    loop.run(max_steps=5)
    assert loop.tracer is None and loop.preempted
    assert [r["kind"] for r in Ledger(str(tmp_path / "l.jsonl")).records()] == [
        "chaos", "outage"]


@pytest.mark.parametrize("key,value", [("cluster_workers", 2), ("freshness_publish", 1)])
def test_unported_loop_keys_still_raise(key, value, tmp_path):
    """Both keys are ported since this test was written: the loop takes
    ``freshness_publish`` and, with a ``freshness_dir``, arms its publisher;
    it takes ``cluster_workers`` and self-hosts a supervisor and a worker
    client (``cluster_worker_id``, default ``w0``)."""
    ids, words, counts = _corpus()
    if key == "freshness_publish":
        tr = Word2VecTrainer(Config({"dim": "8", key: str(value),
                                     "freshness_dir": str(tmp_path / "d")}),
                             corpus_ids=ids, vocab=Vocab(words, counts), device="cpu")
        assert TrainLoop(tr).freshness.period == value
        return
    tr = Word2VecTrainer(Config({"dim": "8", key: str(value)}), corpus_ids=ids,
                         vocab=Vocab(words, counts), device="cpu")
    loop = TrainLoop(tr)
    assert loop.cluster.worker_id == "w0"
    assert "w0" in loop.cluster.supervisor.status()["workers"]


def test_blackbox_dumps_on_guardrail_giveup_and_exception(tmp_path):
    from swiftsnails_tpu_torch.resilience.guardrail import GuardrailExhausted

    ids, words, counts = _corpus()
    cfg = Config({"dim": "8", "batch_size": "64", "subsample": "0", "use_native": "0",
                  "pool_block": "32", "pool_size": "8", "telemetry": "1",
                  "guardrail": "1", "guard_max_consecutive": "2",
                  "chaos_spec": "nan_grad@1-4", "blackbox_dir": str(tmp_path / "bb"),
                  "ledger_path": str(tmp_path / "l.jsonl")})
    loop = TrainLoop(Word2VecTrainer(cfg, corpus_ids=ids, vocab=Vocab(words, counts),
                                     device="cpu"), log_every=1)
    with pytest.raises(GuardrailExhausted):
        loop.run(max_steps=8)
    led = Ledger(str(tmp_path / "l.jsonl"))
    assert [b["reason"] for b in led.records("blackbox")] == ["guardrail-giveup", "exception"]
    assert [r["fault"] for r in led.records("chaos")] == ["nan_grad"] * 2
    assert len(os.listdir(tmp_path / "bb")) == 2
