"""The port's CTR families (logreg, FM, FFM, Wide & Deep) against the JAX package's, on the CPU.

Both trainers get the same config and data; the JAX trainer's initial state
(table, dense dict, optax accumulators) is carried into the port with
``convert.ctr_state_from_numpy``, and both take 4 steps on the same batches,
the JAX one through ``jax.jit(train_step)`` on one device. Each step's loss
agrees within ``LOSS_RTOL``; each table's and dense tensor's change from the
start agrees with JAX's elementwise within ``DELTA_RTOL`` of its largest
change. The two frameworks reduce in another order (the field sums, the
MLP's products, the duplicate merge), and XLA's CPU compiler contracts
multiply-adds and approximates ``rsqrt`` (``tests/test_torch_small_store.py``),
so the comparison is not bit for bit. ``test_comparison_catches_planted_faults``
shows that it catches padding left unmasked, torch's Adagrad rule on the
dense side and an AdaGrad push that does not write its accumulator.
"""

import functools

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from swiftsnails_tpu.data import ctr as jax_ctr
from swiftsnails_tpu.models.registry import get_model as jax_get_model
from swiftsnails_tpu.utils.config import Config as JaxConfig
from swiftsnails_tpu_torch import convert
from swiftsnails_tpu_torch.data import ctr
from swiftsnails_tpu_torch.framework.trainer import TrainLoop
from swiftsnails_tpu_torch.models import sparse_base
from swiftsnails_tpu_torch.models.registry import available_models, get_model
from swiftsnails_tpu_torch.ops import rowdma
from swiftsnails_tpu_torch.utils.config import Config

LOSS_RTOL = 1e-5
DELTA_RTOL = 1e-4
STEPS = 4
NUM_FIELDS = 6
# One intra-op thread: the shapes are small, and the suite's workers share
# the cores with the JAX mesh tests, which abort under CPU contention.
torch.set_num_threads(1)

# case -> (model, config keys): table dims 1 (logreg), 5 (fm), 25 (ffm), 9
# (widedeep), so 128, 16, 4 and 8 logical rows a tile
CASES = {
    "logreg_sgd": ("logreg", {"optimizer": "sgd"}),
    "logreg_adagrad": ("logreg", {}),
    "fm": ("fm", {"factor_dim": 4}),
    "ffm": ("ffm", {"factor_dim": 4}),
    "widedeep": ("widedeep", {"embed_dim": 8, "hidden_dims": "32,16"}),
}


def _conf(**over):
    conf = {"num_fields": str(NUM_FIELDS), "capacity": str(1 << 12),
            "learning_rate": "0.2", "optimizer": "adagrad", "batch_size": "256",
            "num_iters": "1", "seed": "0"}
    conf.update({k: str(v) for k, v in over.items()})
    return conf


@functools.lru_cache(maxsize=None)
def _data():
    labels, feats, _ = ctr.synth_ctr(2048, NUM_FIELDS, 50, seed=3)
    feats[::5, 2] = ctr.PAD  # padding fields, masked out of forward and push
    feats[::9, 4:] = ctr.PAD
    return labels, feats


def _pair(case, **extra):
    name, over = CASES[case]
    conf = _conf(**over, **extra)
    data = _data()
    jt = jax_get_model(name)(JaxConfig(conf), data=data)
    tt = get_model(name)(Config(conf), data=data, device="cpu")
    return jt, tt


def _carry(jstate, adagrad):
    sums = None
    if adagrad:
        sums = {k: np.asarray(v) for k, v in jstate.opt[0].sum_of_squares.items()}
    return convert.ctr_state_from_numpy(
        np.asarray(jstate.table.table), {k: np.asarray(v) for k, v in jstate.dense.items()},
        sums, device="cpu")


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.fixture(scope="module")
def oracle():
    """case -> the JAX run: the carried start state, per-step losses, end
    arrays and the logits of 512 records. Computed once per case and module
    (and worker)."""
    cache = {}

    def run(case):
        if case not in cache:
            jt, tt = _pair(case)
            jstate = jt.init_state()
            start = _carry(jstate, CASES[case][1].get("optimizer", "adagrad") == "adagrad")
            step = jax.jit(jt.train_step)
            losses = []
            for i, batch in zip(range(STEPS), jt.batches()):
                jstate, m = step(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                                 jax.random.PRNGKey(i))
                losses.append(float(m["loss"]))
            end = {"table": np.asarray(jstate.table.table),
                   **{f"dense.{k}": np.asarray(v) for k, v in jstate.dense.items()}}
            logits = jt.predict(jstate, _data()[1][:512])
            cache[case] = (start, losses, end, logits)
        return cache[case]

    return run


def _arrays(state):
    return {"table": state.table.table.numpy(),
            **{f"dense.{k}": v.numpy() for k, v in state.dense.items()}}


def _port_run(case, start):
    """4 port steps from a copy of the carried start state."""
    _, tt = _pair(case)
    state = sparse_base.CTRState(
        table=start.table._replace(table=start.table.table.clone()),
        dense={k: v.clone() for k, v in start.dense.items()},
        opt={k: {n: t.clone() for n, t in d.items()} for k, d in start.opt.items()})
    losses = []
    for _, batch in zip(range(STEPS), tt.batches()):
        state, m = tt.train_step(state, _torch_batch(batch))
        losses.append(float(m["loss"]))
    return tt, state, losses


def _assert_moves_match(start, got, want):
    """Each array's change agrees with JAX's within ``DELTA_RTOL`` of the
    change's largest element, and that change is not negligible."""
    for k in want:
        moved = want[k] - start[k]
        scale = float(np.abs(moved).max())
        assert scale > 1e-4, (k, scale)
        np.testing.assert_allclose(got[k] - start[k], moved, rtol=0,
                                   atol=DELTA_RTOL * scale, err_msg=k)


@pytest.mark.parametrize("case", list(CASES))
def test_four_steps_match_jax(oracle, case):
    start, want_losses, want, want_logits = oracle(case)
    tt, state, losses = _port_run(case, start)
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL)
    _assert_moves_match(_arrays(start), _arrays(state), want)
    stride = 128 // tt.table_geometry()["table"]["group"]
    dead = (np.arange(128) % stride) >= tt.table_dim
    assert not state.table.table[:, :, dead].any()  # dead lanes stay zero
    got_logits = tt.predict(state, _data()[1][:512])
    np.testing.assert_allclose(got_logits, want_logits, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("fault", ["unmasked_padding", "torch_adagrad_dense",
                                   "accum_sublane_unwritten"])
def test_comparison_catches_planted_faults(oracle, monkeypatch, fault):
    """The comparison of ``test_four_steps_match_jax`` fails when the port
    reads and pushes padding fields as feature 0, when its dense side runs
    torch's Adagrad rule (accumulator from 0, eps outside the square root),
    or when the slot-fused AdaGrad push leaves the accumulator sublane
    unwritten."""
    case = "widedeep"
    start, _, want, _ = oracle(case)
    if fault == "unmasked_padding":
        step = sparse_base.SparseCTRTrainer.train_step

        def unmasked(self, state, batch, generator=None):
            return step(self, state, {**batch, "feats": batch["feats"].clamp_min(0)})

        monkeypatch.setattr(sparse_base.SparseCTRTrainer, "train_step", unmasked)
    elif fault == "torch_adagrad_dense":
        class TorchAdagrad:
            """The dense update by ``torch.optim.Adagrad`` itself."""

            def __init__(self, lr):
                self.lr, self.params, self.opt = lr, None, None

            def update(self, grads, opt, dense):
                if self.opt is None:
                    self.params = {k: v.detach().clone() for k, v in dense.items()}
                    self.opt = torch.optim.Adagrad(list(self.params.values()), lr=self.lr)
                for k, p in self.params.items():
                    p.grad = grads[k]
                self.opt.step()
                return {k: p.detach().clone() for k, p in self.params.items()}, opt

        monkeypatch.setattr(sparse_base, "DenseAdaGrad", TorchAdagrad)
    else:
        fused = rowdma.scatter_adagrad_fused_rows

        def param_only(table, rows, grads, lr, eps=1e-8):
            accum = table[:, 1].clone()
            fused(table, rows, grads, lr, eps)
            table[:, 1] = accum
            return table

        monkeypatch.setattr(rowdma, "scatter_adagrad_fused_rows", param_only)
    _, state, _ = _port_run(case, start)
    with pytest.raises(AssertionError):
        _assert_moves_match(_arrays(start), _arrays(state), want)


def test_export_text_matches_jax(tmp_path):
    jt, tt = _pair("fm", capacity=256)
    jstate = jt.init_state()
    state = _carry(jstate, True)
    jt.export_text(jstate, str(tmp_path / "jax.txt"))
    tt.export_text(state, str(tmp_path / "port.txt"))
    jax_text = (tmp_path / "jax.txt").read_text()
    assert (tmp_path / "port.txt").read_text() == jax_text
    assert len(jax_text.splitlines()) == 256


def test_batches_identical():
    jt, tt = _pair("logreg_sgd", num_iters=2)
    want, got = list(jt.batches()), list(tt.batches())
    assert len(got) == len(want) == 2 * (2048 // 256)
    for g, w in zip(got, want):
        assert g.keys() == w.keys() == {"labels", "feats"}
        for k in g:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])


# ---------------------------------------------------------------- data ---


@pytest.mark.parametrize("interaction", [False, True])
def test_synth_ctr_identical(interaction):
    want = jax_ctr.synth_ctr(500, 5, 30, seed=7, interaction=interaction)
    got = ctr.synth_ctr(500, 5, 30, seed=7, interaction=interaction)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_records_identical(tmp_path):
    lines = ["1 3 5 7", "0 1:4 2:9", "label 1 2", "", "1 4 x 6", "0 8 9junk 1",
             "1 -3 2 2 2 2 2", "0.5 10"]
    path = tmp_path / "ctr.txt"
    path.write_text("\n".join(lines) + "\n")
    for line in lines:
        want, got = jax_ctr.parse_record(line, 4), ctr.parse_record(line, 4)
        assert (want is None) == (got is None), line
        if want is not None:
            assert got[0] == want[0]
            np.testing.assert_array_equal(got[1], want[1])
    for g, w in zip(ctr.read_ctr_file(str(path), 4), jax_ctr.read_ctr_file(str(path), 4)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    size = path.stat().st_size
    for span in ((0, 0), (0, size // 2), (size // 2, size)):
        want = list(jax_ctr.read_ctr_stream(str(path), 4, 2, *span))
        got = list(ctr.read_ctr_stream(str(path), 4, 2, *span))
        assert len(got) == len(want)
        for (gl, gf), (wl, wf) in zip(got, want):
            np.testing.assert_array_equal(gl, wl)
            np.testing.assert_array_equal(gf, wf)


@pytest.mark.parametrize("shuffle", [True, False])
def test_ctr_batches_identical(shuffle):
    labels, feats = _data()
    want = jax_ctr.ctr_batches(labels, feats, 300, np.random.default_rng(1),
                               shuffle=shuffle, epochs=2)
    got = ctr.ctr_batches(labels, feats, 300, np.random.default_rng(1),
                          shuffle=shuffle, epochs=2)
    pairs = list(zip(got, want, strict=True))
    assert len(pairs) == 2 * (2048 // 300)
    for g, w in pairs:
        np.testing.assert_array_equal(g["feats"], w["feats"])
        np.testing.assert_array_equal(g["labels"], w["labels"])


# ------------------------------------------------------ dense optimizer ---


@pytest.mark.parametrize("name", ["sgd", "adagrad"])
def test_dense_optimizer_matches_optax(name):
    """A few steps on a dense dict with a zero-gradient entry (optax's
    adagrad gives 0 where the sum of squares is 0: here it starts at 0.1)."""
    rng = np.random.default_rng(2)
    params = {"w": rng.normal(size=(8, 4)).astype(np.float32),
              "bias": np.float32(0.3), "z": np.zeros(3, np.float32)}
    jopt = optax.adagrad(0.05) if name == "adagrad" else optax.sgd(0.05)
    topt = (sparse_base.DenseAdaGrad(0.05) if name == "adagrad"
            else sparse_base.DenseSGD(0.05))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.tensor(v) for k, v in params.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    for _ in range(4):
        g = {k: rng.normal(size=np.shape(v)).astype(np.float32) * (k != "z")
             for k, v in params.items()}
        upd, js = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, upd)
        tp, ts = topt.update({k: torch.tensor(v) for k, v in g.items()}, ts, tp)
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)
    if name == "adagrad":
        for k in params:
            np.testing.assert_allclose(ts["sum_of_squares"][k].numpy(),
                                       np.asarray(js[0].sum_of_squares[k]), rtol=1e-6)


# ------------------------------------------------------------ trainers ---


def test_registry_lists_the_ctr_families():
    assert available_models() == ["ffm", "fm", "logreg", "seqlm", "widedeep", "word2vec"]


@pytest.mark.parametrize("case", ["logreg_sgd", "widedeep"])
def test_train_loop_runs_on_the_cpu(case):
    """``get_model(...)(cfg, data=...)`` -> ``TrainLoop.run``: the loss is
    finite, and on the CPU no kernel is launched."""
    _, tt = _pair(case, num_iters=3)
    counters = [rowdma.gather_rows, rowdma.scatter_add_rows, rowdma.scatter_write_rows,
                rowdma.scatter_adagrad_rows, rowdma.scatter_adagrad_fused_rows]
    before = [f.launches for f in counters]
    state = TrainLoop(tt, log_every=0).run()
    assert [f.launches for f in counters] == before
    assert torch.isfinite(state.table.table).all()
    assert 0.5 < tt.eval_auc(state, limit=2048) <= 1.0


@pytest.mark.parametrize("key,value", [
    ("packed", "0"), ("stream", "1"), ("table_tier", "host"), ("comm_dtype", "bf16"),
    ("placement", "hybrid"), ("dense_tp", "1"), ("optimizer_sharding", "zero")])
def test_unported_keys_raise(key, value):
    """``packed: 0``, ``stream: 1`` and ``table_tier: host`` are ported
    since this test was written: for them it holds that the trainer takes
    the key (``stream`` reads only a ``data`` file, as in the JAX package,
    so records given in hand keep it off); every other key still raises."""
    if key in ("packed", "stream", "table_tier"):
        tr = get_model("widedeep")(Config(_conf(**{key: value})), data=_data(),
                                   device="cpu")
        took = {"packed": lambda: not tr.packed, "stream": lambda: not tr.stream,
                "table_tier": lambda: tr.tiered and tr.tier_spec() is not None}
        assert took[key]()
        return
    with pytest.raises(NotImplementedError, match=key):
        get_model("widedeep")(Config(_conf(**{key: value})), data=_data(), device="cpu")


def test_wide_ffm_and_mesh_raise():
    """FFM above a table dim of 128 is ported since this test was written:
    it takes the 2-D plane, as in the JAX package. A mesh still raises."""
    wide = get_model("ffm")(Config(_conf(factor_dim=40)), data=_data(), device="cpu")
    assert wide.table_dim > 128 and not wide.packed
    with pytest.raises(NotImplementedError, match="mesh"):
        get_model("logreg")(Config(_conf()), mesh=object(), data=_data(), device="cpu")


def test_trainer_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the default is then valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        get_model("widedeep")(Config(_conf()), data=_data())
