"""The port's resilience layer against the JAX package's, on the CPU.

* Retry: the same failures through both packages' ``RetryPolicy`` (fake
  clock, seeded jitter) give the same backoffs, attempts and outcomes.
* Chaos: ``parse_chaos_spec`` agrees with the JAX parser on the cases of
  ``tests/test_resilience.py:47-60``; each training kind fires once at its
  step (row faults hit the row the JAX plan picks for the same seed); a
  kind of an unported plane raises ``NotImplementedError``.
* Guardrail: one sequence of clean, non-finite, spiking and clean steps
  goes through the JAX ``StepGuardrail`` and the port's on the same arrays.
  Trip flags, reasons, ``trust``, ``consecutive`` and the states agree; the
  blended float32 values within 2 ulps and bfloat16 ones within 1 (XLA's
  CPU compiler may contract the blend into a multiply-add; ``ROADMAP.md``
  "AdaGrad against the JAX kernels"), the update norm within rtol 1e-5
  (another summation order). A guarded run without faults equals an
  unguarded one bit for bit; ``GuardrailExhausted`` after
  ``guard_max_consecutive`` trips; a rollback undoes an in-place write.
* Resume: N + M steps straight equal N steps, a preemption (a real SIGTERM
  to this process, ``request_preemption``, or ``chaos_spec: preempt@N``)
  and M resumed steps, bit for bit, on ``packed+pool``, ``fused-dedup-res``
  and ``widedeep`` (AdaGrad, dense optimizer state included); ``resume: 1``
  restarts the stream and continues the counter.
"""

import os
import random
import signal

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from swiftsnails_tpu.resilience import chaos as jax_chaos
from swiftsnails_tpu.resilience import retry as jax_retry
from swiftsnails_tpu.resilience.guardrail import StepGuardrail as JaxGuardrail
from swiftsnails_tpu_torch.data import ctr
from swiftsnails_tpu_torch.data.vocab import Vocab
from swiftsnails_tpu_torch.framework import checkpoint as ckpt
from swiftsnails_tpu_torch.framework.trainer import TrainLoop, step_generator
from swiftsnails_tpu_torch.models import word2vec
from swiftsnails_tpu_torch.models.registry import get_model
from swiftsnails_tpu_torch.resilience import retry as port_retry
from swiftsnails_tpu_torch.resilience import (
    ChaosPlan,
    ChaosSpecError,
    GuardrailExhausted,
    RetryExhausted,
    RetryingIterator,
    RetryPolicy,
    StepGuardrail,
    TransientDataError,
    parse_chaos_spec,
)
from swiftsnails_tpu_torch.utils.config import Config
from swiftsnails_tpu_torch.utils.metrics import MetricsLogger
from swiftsnails_tpu_torch.utils.tree import tensor_items

torch.set_num_threads(1)
VOCAB = 40


# ------------------------------------------------------------------ retry ---


class FakeClock:
    def __init__(self):
        self.t = 0.0
        self.slept = []

    def __call__(self):
        return self.t

    def sleep(self, s):
        self.slept.append(s)
        self.t += s


def _retry_trace(module, fail_first, **kw):
    """Sleeps, calls and the outcome of one failing operation."""
    clk = FakeClock()
    pol = module.RetryPolicy(clock=clk, sleep=clk.sleep, rng=random.Random(7), **kw)
    calls = []

    def op():
        calls.append(clk.t)
        if len(calls) <= fail_first:
            raise OSError("transient")
        return "ok"

    try:
        out = pol.call(op, op="probe")
    except module.RetryExhausted as e:
        out = (type(e).__name__, e.attempts, e.reason)
    return out, clk.slept, calls


@pytest.mark.parametrize("fail_first,kw", [
    (2, dict(max_attempts=4)),
    (9, dict(max_attempts=3)),
    (9, dict(max_attempts=10, deadline_ms=50.0, base_ms=60.0)),
    (6, dict(max_attempts=8, base_ms=25.0, cap_ms=100.0)),
])
def test_retry_schedule_matches_jax(fail_first, kw):
    assert _retry_trace(jax_retry, fail_first, **kw) == _retry_trace(port_retry, fail_first, **kw)


def test_retrying_iterator_recovers_and_exhausts():
    clk = FakeClock()
    pol = RetryPolicy(clock=clk, sleep=clk.sleep, rng=random.Random(7), max_attempts=2)
    plan = ChaosPlan(parse_chaos_spec("io_error@1"), seed=0)
    notes = []
    it = RetryingIterator(plan.wrap_stream(iter([10, 11, 12])), pol,
                          on_error=lambda e, a, rec: notes.append(rec))
    assert list(it) == [10, 11, 12] and notes == [True] and it.retried == 1

    class Dead:
        def __next__(self):
            raise OSError("down")

    it = RetryingIterator(Dead(), pol, on_error=lambda e, a, rec: notes.append(rec))
    with pytest.raises(OSError, match="down"):
        next(it)
    assert notes[-1] is False
    with pytest.raises(RetryExhausted):
        pol.call(Dead().__next__)


# ------------------------------------------------------------------ chaos ---


@pytest.mark.parametrize("spec", ["nan_grad@5-7, preempt@17,io_error@2", "", " ckpt_corrupt@3 ,",
                                  "serve_slow@1-2,worker_dead@4"])
def test_parse_chaos_spec_matches_jax(spec):
    assert parse_chaos_spec(spec) == jax_chaos.parse_chaos_spec(spec)


@pytest.mark.parametrize("bad", ["nonsense@3", "nan_grad@", "nan_grad@7-5", "nan_grad"])
def test_parse_chaos_spec_rejects_malformed(bad):
    with pytest.raises(ChaosSpecError):
        parse_chaos_spec(bad)
    with pytest.raises(jax_chaos.ChaosSpecError):
        jax_chaos.parse_chaos_spec(bad)


@pytest.mark.parametrize("kind", ["serve_io_error", "serve_slow", "tier_bitflip", "reload_corrupt",
                                  "worker_dead", "worker_slow", "partition", "proc_kill",
                                  "net_partition", "net_slow"])
def test_unported_chaos_kinds_raise(kind):
    """Every kind is ported since this test was written: ``tier_bitflip``
    with the tiered store, the transport kinds with the network plane, the
    serving and cluster kinds with the cluster plane. The test holds that
    the plan schedules each and fires it once through its consulting hook,
    as the JAX plan does (``net_fault``, ``serve_fault``,
    ``wants_reload_corrupt``, ``cluster_fault``)."""
    plan = ChaosPlan.from_config(Config({"chaos_spec": f"nan_grad@1,{kind}@3"}))
    jplan = jax_chaos.ChaosPlan(jax_chaos.parse_chaos_spec(f"nan_grad@1,{kind}@3"))
    assert plan.scheduled(kind, 3)
    if kind == "tier_bitflip":
        return
    fire = {"proc_kill": "net_fault", "net_partition": "net_fault", "net_slow": "net_fault",
            "serve_io_error": "serve_fault", "serve_slow": "serve_fault",
            "reload_corrupt": "wants_reload_corrupt", "worker_dead": "cluster_fault",
            "worker_slow": "cluster_fault", "partition": "cluster_fault"}[kind]
    for tick in (2, 3, 3):
        assert getattr(plan, fire)(tick) == getattr(jplan, fire)(tick)
    assert not plan.scheduled(kind, 3)
    assert [(e["fault"], e["step"]) for e in plan.events] == [
        (e["fault"], e["step"]) for e in jplan.events]


@pytest.mark.parametrize("kind", ["nan_grad", "inf_grad", "row_poison"])
def test_row_faults_fire_once_on_the_jax_row(kind):
    value = {"inf_grad": np.inf}.get(kind, np.nan)
    plan = ChaosPlan(parse_chaos_spec(f"{kind}@2"), seed=3)
    jplan = jax_chaos.ChaosPlan(jax_chaos.parse_chaos_spec(f"{kind}@2"), seed=3)
    state = {"t": torch.ones(64, 3), "i": torch.zeros(4, dtype=torch.int32)}
    jstate = {"t": jnp.ones((64, 3)), "i": jnp.zeros(4, jnp.int32)}
    hook = (lambda p, s, st: p.pre_step(s, st)) if kind == "row_poison" else (
        lambda p, s, st: p.post_step(s, {"loss": np.float32(1)}, st)[0])
    assert hook(plan, state, 1) is state and torch.isfinite(state["t"]).all()  # not its step
    hook(plan, state, 2)
    jstate = hook(jplan, jstate, 2)
    hit = ~torch.isfinite(state["t"]).all(dim=1)
    row = state["t"][hit]
    assert hit.sum() == 1 and bool((row.isnan() if np.isnan(value) else row == value).all())
    np.testing.assert_array_equal(state["t"].numpy(), np.asarray(jstate["t"]))
    hook(plan, state, 2)  # fired once only
    assert (~torch.isfinite(state["t"]).all(dim=1)).sum() == 1
    assert plan.summary()["injected"] == 1 and not plan.pending()
    if kind != "row_poison":
        _, metrics = plan.post_step(state, {"loss": np.float32(1)}, 2)
        assert metrics["loss"] == 1  # and not again


def test_other_training_faults_fire_once(tmp_path):
    plan = ChaosPlan(parse_chaos_spec("io_error@1,preempt@4,slow_step@2,ckpt_corrupt@3"),
                     seed=0, slow_step_ms=1.0)
    it = plan.wrap_stream(iter([10, 11, 12]))
    assert next(it) == 10
    with pytest.raises(TransientDataError):
        next(it)
    assert next(it) == 11 and next(it) == 12  # the failed fetch consumed nothing
    assert plan.wants_preempt(3) is None and plan.wants_preempt(4) == "chaos preempt@4"
    assert plan.wants_preempt(4) is None
    assert plan.maybe_slow_step(2) == 1.0 and plan.maybe_slow_step(2) == 0.0
    root = str(tmp_path / "ck")
    ckpt.save_checkpoint(root, {"w": torch.ones(64)}, 3, wait=False)
    assert plan.maybe_corrupt_checkpoint(root, 3) is not None  # joins the writer first
    with pytest.raises(ckpt.CheckpointError):
        ckpt.restore_checkpoint(root, {"w": torch.zeros(64)})
    assert plan.maybe_corrupt_checkpoint(root, 3) is None
    assert plan.summary()["by_fault"] == {"io_error": 1, "ckpt_corrupt": 1, "preempt": 1,
                                          "slow_step": 1}


# -------------------------------------------------------------- guardrail ---


def _guard_states(rng):
    w = rng.normal(0, 1, (16, 8)).astype(np.float32)
    h = rng.normal(0, 1, (8, 128)).astype(np.float32)
    n = np.arange(5, dtype=np.int32)
    return w, h, n


def _torch_state(w, h, n):
    return {"w": torch.from_numpy(w.copy()),
            "h": torch.from_numpy(h.copy()).to(torch.bfloat16),
            "n": torch.from_numpy(n.copy())}


def _jax_state(w, h, n):
    return {"w": jnp.asarray(w), "h": jnp.asarray(h).astype(jnp.bfloat16), "n": jnp.asarray(n)}


def _ulps(a: np.ndarray, b: np.ndarray) -> int:
    ia, ib = a.view(np.int32).astype(np.int64), b.view(np.int32).astype(np.int64)
    return int(np.abs(ia - ib).max())


def test_guardrail_matches_jax_over_a_sequence():
    rng = np.random.default_rng(0)
    g, jg = StepGuardrail(max_update_norm=50.0), JaxGuardrail(max_update_norm=50.0)
    w, h, n = _guard_states(rng)
    state, jstate = _torch_state(w, h, n), _jax_state(w, h, n)
    # clean, NaN update, non-finite loss, norm spike, clean (blend at 1/8),
    # clean (1/4), clean (1/2), clean
    plan = ["clean", "nan", "loss_inf", "spike", "clean", "clean", "clean", "clean"]
    for i, what in enumerate(plan):
        dw = rng.normal(0, 0.05, w.shape).astype(np.float32)
        dh = rng.normal(0, 0.05, h.shape).astype(np.float32)
        if what == "spike":
            dw += 100.0
        snap, jsnap = g.snapshot(state), jg.snapshot(jstate)
        state["w"] += torch.from_numpy(dw)  # the step writes in place
        state["h"] += torch.from_numpy(dh).to(torch.bfloat16)
        state["n"] += 1
        jnew = {"w": jstate["w"] + dw, "h": jstate["h"] + jnp.asarray(dh).astype(jnp.bfloat16),
                "n": jstate["n"] + 1}
        loss = np.float32(np.inf if what == "loss_inf" else 0.5)
        if what == "nan":
            state["w"][3, 1] = float("nan")
            jnew["w"] = jnew["w"].at[3, 1].set(jnp.nan)
        got, m, tripped, exhausted = g.commit(snap, state, {"loss": torch.tensor(loss)})
        jstate, jm, jtripped, jexhausted = jg.commit(jsnap, jnew, {"loss": jnp.float32(loss)})
        assert got is state
        assert (tripped, exhausted) == (jtripped, jexhausted), (i, what)
        assert (g.trust, g.consecutive, g.trips_total, g.last_trip_reason) == (
            jg.trust, jg.consecutive, jg.trips_total, jg.last_trip_reason), (i, what)
        assert sorted(m) == sorted(jm) and all(float(m[k]) == float(jm[k]) for k in m
                                               if k != "loss"), (i, what)
        if np.isfinite(jg.last_update_norm):
            assert g.last_update_norm == pytest.approx(jg.last_update_norm, rel=1e-5)
        else:
            assert not np.isfinite(g.last_update_norm)
        assert _ulps(state["w"].numpy(), np.asarray(jstate["w"])) <= 2, (i, what)
        hb = state["h"].view(torch.int16).numpy().astype(np.int64)
        jb = np.asarray(jstate["h"]).view(np.int16).astype(np.int64)
        assert np.abs(hb - jb).max() <= 1, (i, what)
        np.testing.assert_array_equal(state["n"].numpy(), np.asarray(jstate["n"]))
    assert g.trust == 1.0 and g.trips_total == 3
    summary, jsummary = g.summary(), jg.summary()
    assert summary.pop("last_update_norm") == pytest.approx(jsummary.pop("last_update_norm"),
                                                            rel=1e-5)
    assert summary == jsummary


def test_guardrail_rollback_restores_in_place_writes():
    g = StepGuardrail(max_consecutive=3)
    state = {"t": torch.ones(4, 3), "k": torch.arange(3)}
    snap = g.snapshot(state)
    state["t"][0, 0] = float("nan")
    state["k"] += 7
    got, metrics, tripped, exhausted = g.commit(snap, state, {"loss": np.float32(0.5)})
    assert tripped and not exhausted and got is state
    assert torch.equal(state["t"], torch.ones(4, 3)) and torch.equal(state["k"], torch.arange(3))
    assert float(metrics["guard_tripped"]) == 1.0 and g.trust == 0.5 and g.steps_skipped == 1
    snap2 = g.snapshot(state)
    assert snap2["t"] is snap["t"]  # buffers allocated once


def test_guardrail_exhaustion_flag():
    g = StepGuardrail(max_consecutive=2)
    state = {"w": torch.zeros(4, 3)}
    for want in (False, True):
        snap = g.snapshot(state)
        state["w"][0, 0] = float("inf")
        _, _, tripped, exhausted = g.commit(snap, state, {})
        assert tripped and exhausted is want
    assert g.trips_total == 2


# -------------------------------------------------------- the loop, resume ---


def _corpus():
    rng = np.random.default_rng(0)
    counts = np.maximum(rng.zipf(1.3, VOCAB), 1).astype(np.int64)
    ids = rng.choice(VOCAB, size=1500, p=counts / counts.sum()).astype(np.int32)
    return [f"w{i}" for i in range(VOCAB)], counts, ids


PATHS = {
    "packed": {},
    "dedup_res": {"fused": 1, "grouped": 1, "dedup": 1, "resident": 1, "hot_rows": 16,
                  "u_cap": 32, "centers_per_block": 16, "steps_per_call": 2, "batch_size": 32},
}


def _trainer(path, **over):
    if path == "widedeep":
        conf = {"num_fields": "4", "capacity": "512", "learning_rate": "0.2",
                "optimizer": "adagrad", "batch_size": "64", "num_iters": "2", "seed": "0",
                "embed_dim": "4", "hidden_dims": "8", "prefetch_batches": "0"}
        conf.update({k: str(v) for k, v in over.items()})
        labels, feats, _ = ctr.synth_ctr(512, 4, 30, seed=2)
        return get_model("widedeep")(Config(conf), data=(labels, feats), device="cpu")
    words, counts, ids = _corpus()
    conf = {"dim": "16", "window": "2", "negatives": "2", "learning_rate": "0.2",
            "batch_size": "64", "subsample": "1e-2", "num_iters": "2", "pool_size": "8",
            "pool_block": "32", "seed": "3", "lr_decay": "1", **PATHS[path]}
    conf.update({k: str(v) for k, v in over.items()})
    return word2vec.Word2VecTrainer(Config(conf), corpus_ids=ids, vocab=Vocab(words, counts),
                                    device="cpu")


def _assert_states_equal(a, b):
    ia, ib = tensor_items(a), tensor_items(b)
    assert [k for k, _ in ia] == [k for k, _ in ib]
    for (key, x), (_, y) in zip(ia, ib):
        assert torch.equal(x, y), key


class _AtStep(MetricsLogger):
    """Runs ``fn`` when the loop logs step ``step`` (``log_every: 1``)."""

    def __init__(self, step, fn):
        super().__init__()
        self.step, self.fn = step, fn

    def log(self, record):
        if record.get("step") == self.step:
            self.fn()


N, M = 5, 4


@pytest.mark.parametrize("path", ["packed", "dedup_res", "widedeep"])
@pytest.mark.parametrize("how", ["sigterm", "request", "chaos"])
def test_preempted_and_resumed_run_equals_the_straight_run(tmp_path, path, how):
    straight = TrainLoop(_trainer(path), log_every=0).run(seed=1, max_steps=N + M)
    root = str(tmp_path / "ck")
    over = dict(param_backup_root=root, param_backup_period=2, resume="auto")
    if how == "chaos":
        loop = TrainLoop(_trainer(path, chaos_spec=f"preempt@{N - 1}", **over), log_every=0)
    else:
        before = signal.getsignal(signal.SIGTERM)

        def sigterm():
            # only into the loop's handler: the default one would end this process
            assert signal.getsignal(signal.SIGTERM) not in (before, signal.SIG_DFL, None)
            os.kill(os.getpid(), signal.SIGTERM)

        kill = sigterm if how == "sigterm" else (lambda: loop.request_preemption("test"))
        loop = TrainLoop(_trainer(path, **over), metrics=_AtStep(N, kill), log_every=1)
    first = loop.run(seed=1, max_steps=N + M)
    assert loop.preempted and ckpt.latest_step(root) == N
    if how == "sigterm":
        assert signal.getsignal(signal.SIGTERM) is before  # the handler was put back
    man = ckpt.read_manifest(root, N)
    assert man["data_cursor"]["step"] == N
    resumed_loop = TrainLoop(_trainer(path, **over), log_every=0)
    resumed = resumed_loop.run(seed=1, max_steps=N + M)
    assert resumed_loop._restored_step == N and not resumed_loop.preempted
    assert resumed_loop._items_seen == loop._items_seen + (
        resumed_loop._items_seen - man["data_cursor"]["items"])
    _assert_states_equal(resumed, straight)
    assert not all(torch.equal(x, y) for (_, x), (_, y) in zip(
        tensor_items(first), tensor_items(straight)))  # the first leg really stopped early


def test_resume_latest_restarts_the_stream_and_continues_the_counter(tmp_path):
    root = str(tmp_path / "ck")
    TrainLoop(_trainer("packed", param_backup_root=root, param_backup_period=N),
              log_every=0).run(seed=1, max_steps=N)
    loop = TrainLoop(_trainer("packed", param_backup_root=root, param_backup_period=100,
                              resume=1), log_every=0)
    got = loop.run(seed=1, max_steps=N + M)
    assert loop._restored_step == N and loop._items_seen == M * 64
    trainer = _trainer("packed")
    want = ckpt.restore_checkpoint(root, trainer.init_state(), step=N)
    for i, batch in zip(range(M), trainer.batches()):  # the stream from its start
        dev = {k: torch.from_numpy(v) if np.ndim(v) else v for k, v in batch.items()}
        want, _ = trainer.train_step(want, dev, step_generator(1, N + i, trainer.device))
    _assert_states_equal(got, want)


@pytest.mark.parametrize("path", ["packed", "widedeep"])
def test_guarded_run_without_faults_equals_unguarded(path):
    plain = TrainLoop(_trainer(path), log_every=0).run(seed=2, max_steps=6)
    loop = TrainLoop(_trainer(path, guardrail=1), log_every=0)
    guarded = loop.run(seed=2, max_steps=6)
    assert loop.guardrail.trips_total == 0 and loop.guardrail.trust == 1.0
    _assert_states_equal(guarded, plain)


def test_trainloop_guardrail_rolls_back_chaos_and_gives_up(capsys):
    loop = TrainLoop(_trainer("packed", guardrail=1, chaos_spec="nan_grad@2-3,row_poison@5"),
                     log_every=0)
    state = loop.run(max_steps=8)
    assert loop.guardrail.trips_total == 3
    assert all(torch.isfinite(t).all() for _, t in tensor_items(state))
    err = capsys.readouterr().err
    assert [f"guardrail: step {s} rolled back" in err for s in (2, 3, 5)] == [True] * 3
    with pytest.raises(GuardrailExhausted):
        TrainLoop(_trainer("packed", guardrail=1, guard_max_consecutive=2,
                           chaos_spec="nan_grad@1-6", chaos_seed=1), log_every=0).run(max_steps=8)


def test_preemption_drains_with_final_save(tmp_path):
    root = str(tmp_path / "ck")
    loop = TrainLoop(_trainer("packed", param_backup_period=4, param_backup_root=root,
                              chaos_spec="preempt@5"), log_every=0)
    loop.run(max_steps=50)
    assert loop.preempted
    assert ckpt.intact_steps(root) == [6, 4]  # the drain's save past the last periodic one


def test_stream_io_error_is_retried_by_the_loop(capsys):
    got = TrainLoop(_trainer("packed", chaos_spec="io_error@2", retry_base_ms=1,
                             retry_cap_ms=2), log_every=0).run(seed=1, max_steps=5)
    want = TrainLoop(_trainer("packed"), log_every=0).run(seed=1, max_steps=5)
    _assert_states_equal(got, want)
    assert "data stream error (attempt 1)" in capsys.readouterr().err
