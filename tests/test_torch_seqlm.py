"""The port's ``seqlm`` against the JAX package's ``SeqLMTrainer``, on the
CPU, at the JAX tests' size (seq_len 32, 1 layer, 2 heads, d_model 32,
vocab 32).

threefry cannot be matched, so every comparison starts both packages from
the JAX state carried across (``convert.seqlm_state_from_numpy``): the
forward logits, the batches, and each optimizer's parameters after 3 steps.
Then the port alone: the loss falls, ``TrainLoop`` runs it, a checkpoint
resumes bit for bit, and under a two-rank gloo ``seq`` group (spawned
processes, ``init_method`` a file under ``tmp_path``) ring and Ulysses
attention give the dense logits and the dense step, and an adam checkpoint
saved after 3 steps resumes to the uninterrupted losses.
"""

import multiprocessing as mp
import os
import pathlib
import traceback

import numpy as np
import pytest
import torch

from swiftsnails_tpu_torch import convert
from swiftsnails_tpu_torch.framework.trainer import TrainLoop
from swiftsnails_tpu_torch.models.registry import available_models, get_model
from swiftsnails_tpu_torch.models.seqlm import SeqLMTrainer, param_leaves
from swiftsnails_tpu_torch.utils.config import Config
from swiftsnails_tpu_torch.utils.tree import tensor_items

CPU = "cpu"
VOCAB = 32
SPAWN_TIMEOUT_S = 180
torch.set_num_threads(1)

# the JAX tests' learning rates (tests/test_seqlm.py)
RATES = {"sgd": "0.1", "momentum": "0.05", "adam": "0.003", "adamw": "0.003"}


def _corpus(n=6000, vocab=VOCAB, seed=0):
    """The JAX tests' corpus: x_{t+1} = x_t + 1 mod vocab, with noise."""
    rng = np.random.default_rng(seed)
    ids = np.cumsum(rng.random(n) < 0.95).astype(np.int64) % vocab
    return ids.astype(np.int32)


def _conf(**kw):
    base = {"seq_len": "32", "n_layers": "1", "n_heads": "2", "d_model": "32",
            "learning_rate": "0.1", "batch_size": "8", "num_iters": "8",
            "attention": "dense"}
    base.update({k: str(v) for k, v in kw.items()})
    return base


def _port(corpus=None, seq_group=None, **kw):
    corpus = _corpus() if corpus is None else corpus
    return SeqLMTrainer(Config(_conf(**kw)), device=CPU, corpus_ids=corpus,
                        vocab_size=VOCAB, seq_group=seq_group)


def _jax(corpus=None, **kw):
    from swiftsnails_tpu.models.seqlm import SeqLMTrainer as JaxSeqLM
    from swiftsnails_tpu.utils.config import Config as JaxConfig

    corpus = _corpus() if corpus is None else corpus
    return JaxSeqLM(JaxConfig(_conf(**kw)), corpus_ids=corpus, vocab_size=VOCAB)


def _np_tree(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, tree)


def _carried(jstate, optimizer):
    """The JAX state's params and optax slots, carried into the port."""
    opt0 = jstate["opt"][0]
    slots = {}
    if optimizer in ("adam", "adamw"):
        slots = {"count": np.asarray(opt0.count), "mu": _np_tree(opt0.mu),
                 "nu": _np_tree(opt0.nu)}
    elif optimizer == "momentum":
        slots = {"trace": _np_tree(opt0.trace)}
    return convert.seqlm_state_from_numpy(_np_tree(jstate["params"]), slots, device=CPU)


def _leaves_np(params):
    return [p.detach().numpy() for p in param_leaves(params)]


def _jax_leaves(params):
    out = [np.asarray(params["embed"]), np.asarray(params["pos"])]
    for blk in params["blocks"]:
        out.extend(np.asarray(blk[k]) for k in ("wqkv", "wo", "w1", "w2"))
    return out


# ------------------------------------------------------- against the JAX package ---


def test_forward_logits_match_jax():
    import jax.numpy as jnp

    jt, pt = _jax(), _port()
    jstate = jt.init_state()
    state = _carried(jstate, "sgd")
    toks = next(iter(jt.batches()))["tokens"][:, :-1]
    want = np.asarray(jt.forward(jstate["params"], jnp.asarray(toks)))
    got = pt.forward(state["params"], torch.from_numpy(toks)).detach().numpy()
    assert got.shape == (8, 32, VOCAB)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    loss_j = float(jt.loss_fn(jstate["params"], jnp.asarray(next(iter(jt.batches()))["tokens"])))
    loss_p = float(pt.loss_fn(state["params"],
                              torch.from_numpy(next(iter(jt.batches()))["tokens"])))
    np.testing.assert_allclose(loss_p, loss_j, rtol=1e-5)


def test_batches_equal_jax():
    jt, pt = _jax(num_iters=2), _port(num_iters=2)
    jb, pb = list(jt.batches()), list(pt.batches())
    assert len(jb) == len(pb) > 0
    for a, b in zip(jb, pb):
        assert a["tokens"].dtype == b["tokens"].dtype == np.int32
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert pt.items_per_batch(pb[0]) == jt.items_per_batch(jb[0]) == 8 * 32


@pytest.mark.parametrize("optimizer", ["sgd", "momentum", "adam", "adamw"])
def test_three_steps_match_jax(optimizer):
    import jax

    kw = {"optimizer": optimizer, "learning_rate": RATES[optimizer]}
    jt, pt = _jax(**kw), _port(**kw)
    jstate = jt.init_state()
    state = _carried(jstate, optimizer)
    step = jax.jit(jt.train_step)
    batches = list(jt.batches())[:3]
    for b in batches:
        jstate, jm = step(jstate, {"tokens": jax.numpy.asarray(b["tokens"])}, None)
        state, pm = pt.train_step(state, {"tokens": torch.from_numpy(b["tokens"])}, None)
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=1e-5)
    for got, want in zip(_leaves_np(state["params"]), _jax_leaves(jstate["params"])):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    if optimizer in ("adam", "adamw"):
        assert int(state["opt"]["count"]) == int(jstate["opt"][0].count) == 3


@pytest.mark.parametrize("optimizer", ["sgd", "momentum", "adam", "adamw"])
def test_loss_decreases(optimizer):
    """``test_seqlm_loss_decreases`` and ``test_seqlm_optimizer_choice_trains``
    of the JAX package: the mean of the last 5 of 60 to 80 losses below 0.7x
    the first 5's."""
    tr = _port(optimizer=optimizer, learning_rate=RATES[optimizer])
    state = tr.init_state()
    assert (state["opt"] != {}) == (optimizer != "sgd")
    losses = []
    for b in tr.batches():
        state, m = tr.train_step(state, {"tokens": torch.from_numpy(b["tokens"])}, None)
        losses.append(float(m["loss"]))
        if len(losses) >= (80 if optimizer == "sgd" else 60):
            break
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) * 0.7, losses[:3] + losses[-3:]


def test_unknown_optimizer_and_attention_rejected():
    with pytest.raises(ValueError, match="optimizer"):
        _port(_corpus(400), optimizer="rmsprop")
    with pytest.raises(ValueError, match="attention"):
        _port(_corpus(400), attention="flash")


def test_runs_under_train_loop():
    tr = _port(_corpus(4000), num_iters=2)
    state = TrainLoop(tr, log_every=0).run()
    assert sorted(state.keys()) == ["opt", "params"]
    assert get_model("seqlm") is SeqLMTrainer


def test_available_models_equal_jax():
    from swiftsnails_tpu.models.registry import available_models as jax_models

    assert available_models() == jax_models()
    assert "seqlm" in available_models()


def test_resumed_run_equals_the_straight_run(tmp_path):
    """``param_backup_period`` + ``resume: auto``: the adam slots and the
    parameters survive a save; the resumed losses equal the straight run's
    bit for bit."""
    from swiftsnails_tpu_torch.utils.metrics import MetricsLogger

    class Losses(MetricsLogger):
        def __init__(self):
            super().__init__()
            self.seen = {}

        def log(self, record):
            self.seen[record["step"]] = record["loss"]

    kw = dict(optimizer="adam", learning_rate="0.003", num_iters=1)
    straight = Losses()
    end = TrainLoop(_port(**kw), metrics=straight, log_every=1).run(max_steps=8)
    root = str(tmp_path / "ck")
    ck = dict(kw, param_backup_root=root, param_backup_period=4, resume="auto")
    TrainLoop(_port(**ck), metrics=Losses(), log_every=1).run(max_steps=4)
    resumed = Losses()
    again = TrainLoop(_port(**ck), metrics=resumed, log_every=1).run(max_steps=8)
    assert sorted(resumed.seen) == [5, 6, 7, 8]
    assert all(resumed.seen[s] == straight.seen[s] for s in resumed.seen)
    for (key, a), (_, b) in zip(tensor_items(end), tensor_items(again)):
        assert torch.equal(a, b), key


def test_convert_carries_every_slot():
    jt = _jax(optimizer="adamw", learning_rate="0.003")
    jstate = jt.init_state()
    state = _carried(jstate, "adamw")
    keys = [k for k, _ in tensor_items(state)]
    assert keys == [k for k, _ in tensor_items(_port(optimizer="adamw").init_state())]
    assert state["opt"]["count"].dtype == torch.int32 and state["opt"]["count"].dim() == 0
    with pytest.raises(ValueError, match="slot"):
        convert.seqlm_state_from_numpy(_np_tree(jstate["params"]), {"v": 0}, device=CPU)


# ------------------------------------------------ under a gloo seq group of 2 ---


def _group_worker(rank, size, init, out_dir, corpus):
    """One rank: ring and Ulysses logits, one step of each beside the dense
    step, and an adam checkpoint saved after 3 steps and resumed."""
    import torch.distributed as dist

    from swiftsnails_tpu_torch.framework.checkpoint import (
        restore_checkpoint,
        save_checkpoint,
    )
    from swiftsnails_tpu_torch.parallel import sequence

    torch.set_num_threads(1)
    out = {}
    try:
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")  # the ranks share one host
        dist.init_process_group("gloo", init_method=init, rank=rank, world_size=size)
        group = dist.new_group(list(range(size)))
        dense = _port(corpus)
        batch = next(iter(dense.batches()))
        toks = torch.from_numpy(batch["tokens"])
        start = dense.init_state()
        for attention in ("ring", "ulysses"):
            par = _port(corpus, seq_group=group, attention=attention)
            out[f"logits_{attention}"] = par.forward(start["params"], toks[:, :-1]).detach()
            state = par.init_state()
            state, m = par.train_step(state, {"tokens": toks}, None)
            out[f"step_{attention}"] = [p.clone() for p in param_leaves(state["params"])]
            out[f"loss_{attention}"] = float(m["loss"])
        out["calls"] = dict(sequence.CALLS)
        tr = _port(corpus, seq_group=group, attention="ring", optimizer="adam",
                   learning_rate="0.003")
        batches = [{"tokens": torch.from_numpy(b["tokens"])} for b in tr.batches()][:6]
        state = tr.init_state()
        for b in batches[:3]:
            state, _ = tr.train_step(state, b, None)
        root = os.path.join(out_dir, f"ck{rank}")
        save_checkpoint(root, state, step=3)
        cont = [float(tr.train_step(state, b, None)[1]["loss"]) for b in batches[3:]]
        restored = restore_checkpoint(root, tr.init_state())
        resumed = [float(tr.train_step(restored, b, None)[1]["loss"]) for b in batches[3:]]
        out.update(cont=cont, resumed=resumed)
        dist.destroy_process_group()
    except Exception:
        out = {"error": traceback.format_exc()}
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


def spawn_ranks(fn, size, tmp_path, *args):
    """Run ``fn(rank, size, init, out_dir, *args)`` in ``size`` spawned
    processes; returns each rank's saved result. Fails on a rank's error or
    past ``SPAWN_TIMEOUT_S``, and kills what is left."""
    ctx = mp.get_context("spawn")
    init = f"file://{tmp_path}/rendezvous"
    procs = [ctx.Process(target=fn, args=(r, size, init, str(tmp_path), *args))
             for r in range(size)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(SPAWN_TIMEOUT_S)
            assert not p.is_alive(), f"a rank outlived {SPAWN_TIMEOUT_S} s"
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    results = [torch.load(os.path.join(tmp_path, f"rank{r}.pt")) for r in range(size)]
    for r, res in enumerate(results):
        assert "error" not in res, f"rank {r}:\n{res['error']}"
    return results


@pytest.fixture(scope="module")
def group_run(tmp_path_factory):
    corpus = _corpus(3000)
    return corpus, spawn_ranks(_group_worker, 2, tmp_path_factory.mktemp("seqlm_group"),
                               corpus)


@pytest.mark.parametrize("attention", ["ring", "ulysses"])
def test_group_logits_match_dense(group_run, attention):
    """Each rank's logits are its half of the dense ones, within 2e-4."""
    corpus, results = group_run
    dense = _port(corpus)
    toks = torch.from_numpy(next(iter(dense.batches()))["tokens"])[:, :-1]
    want = dense.forward(dense.init_state()["params"], toks).detach().numpy()
    got = np.concatenate([r[f"logits_{attention}"].numpy() for r in results], axis=1)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    calls = results[0]["calls"]
    assert calls["ring_shift"] > 0 and calls["all_to_all"] > 0


@pytest.mark.parametrize("attention", ["ring", "ulysses"])
def test_group_step_matches_dense(group_run, attention):
    """One step under the group: the global loss, and on every rank the
    dense step's parameters within 1e-4."""
    corpus, results = group_run
    dense = _port(corpus)
    state = dense.init_state()
    batch = {"tokens": torch.from_numpy(next(iter(dense.batches()))["tokens"])}
    state, m = dense.train_step(state, batch, None)
    want = _leaves_np(state["params"])
    for r in results:
        np.testing.assert_allclose(r[f"loss_{attention}"], float(m["loss"]), rtol=1e-5)
        for got, w in zip(r[f"step_{attention}"], want):
            np.testing.assert_allclose(got.numpy(), w, rtol=1e-4, atol=1e-4)


def test_group_checkpoint_roundtrip(group_run):
    """``test_seqlm_checkpoint_roundtrip_under_seq_mesh``: adam under ring
    attention, saved after 3 steps and restored; the resumed losses equal
    the uninterrupted run's within rtol 1e-5, on both ranks alike."""
    _, results = group_run
    for r in results:
        np.testing.assert_allclose(r["resumed"], r["cont"], rtol=1e-5)
    np.testing.assert_allclose(results[0]["cont"], results[1]["cont"], rtol=1e-6)


# ------------------------------------------------------------------ the CLI ---


def test_cli_trains_and_resumes_seqlm(tmp_path):
    """``python -m swiftsnails_tpu_torch train -config`` with ``model:
    seqlm`` on a text corpus through ``data``: it trains, saves, and a
    second run with ``resume: auto`` restores the newest step and goes on
    to the end of the data."""
    import json
    import subprocess
    import sys

    rng = np.random.default_rng(0)
    words = [f"t{i}" for i in range(40)]
    corpus = tmp_path / "corpus.txt"
    corpus.write_text(" ".join(rng.choice(words, 2400)))
    conf = tmp_path / "seqlm.conf"
    conf.write_text("model: seqlm\n" + "".join(
        f"{k}: {v}\n" for k, v in _conf(optimizer="adam", learning_rate="0.003",
                                        num_iters=1, data=corpus).items()))
    root = tmp_path / "ck"
    env = dict(os.environ, PYTHONPATH=str(pathlib.Path(__file__).resolve().parent.parent))

    def run(*extra):
        return subprocess.run(
            [sys.executable, "-m", "swiftsnails_tpu_torch", "train", "-config", str(conf),
             "-device", "cpu", "-param_backup_root", str(root), "-param_backup_period", "3",
             "-log_every", "1", *extra],
            capture_output=True, text=True, env=env, cwd=tmp_path, timeout=120)

    first = run()
    assert first.returncode == 0, first.stderr
    lines = [json.loads(x) for x in first.stdout.splitlines() if x.startswith("{")]
    assert [r["step"] for r in lines] == list(range(1, 10))
    assert all(np.isfinite(r["loss"]) for r in lines)
    second = run("-resume", "auto")
    assert second.returncode == 0, second.stderr
    assert "resume: restored step 9" in second.stderr
