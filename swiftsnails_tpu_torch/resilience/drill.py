"""Canned chaos drills + the bench ``chaos`` lane's recovery measurement —
the JAX package's ``resilience/drill.py``.

One implementation used by ``python -m swiftsnails_tpu_torch.tools.chaos_drill``
(the drill runner), the port's tests, ``chip_smoke.py`` on the card and the
drift lane (``telemetry/drift_lane.py``: :func:`make_trainer`,
:func:`run_loop`), so the drill matrix and its lanes cannot drift apart.
Every entry point takes ``device`` (``None``: the card).

Every drill is deterministic: fixed ``chaos_seed``, fixed data seed, fixed
fault schedule — a failure reproduces bit-identically. A drill *passes* when
the run **recovers**: it finishes its step budget (or resumes and finishes),
no non-finite value is left in the master tables, and — for the
corruption+preemption drill — the resumed run's final eval loss lands within
``LOSS_PARITY_BAR`` of an undisturbed control run.
"""

from __future__ import annotations

import os
import tempfile
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from swiftsnails_tpu_torch.utils.device import DeviceLike

LOSS_PARITY_BAR = 0.05  # resumed-vs-undisturbed relative eval-loss bound

DRILLS = (
    "nan_burst",
    "inf_update",
    "row_poison",
    "io_error",
    "ckpt_walkback",
    "preempt_resume",
    "tier_bitflip",
    "tier_bitflip_int8",
)


# ------------------------------------------------------------ harness bits ---


def _drill_corpus():
    """The shared 128-word paired probe corpus (``framework/quality.py``) —
    small enough that every drill runs in seconds."""
    from swiftsnails_tpu_torch.framework.quality import paired_corpus

    return paired_corpus(n_pairs=64, reps=1500, seed=0)


def make_trainer(workdir: str, corpus=None, device: DeviceLike = None, **overrides):
    """A dense-path word2vec trainer wired for drills (ledger + backups under
    ``workdir``) on ``device`` (``None``: the card); overrides land on top
    of the base config."""
    from swiftsnails_tpu_torch.models.word2vec import Word2VecTrainer
    from swiftsnails_tpu_torch.utils.config import Config

    ids, vocab = corpus if corpus is not None else _drill_corpus()
    base = {
        "dim": "16", "window": "1", "negatives": "4", "learning_rate": "0.3",
        "num_iters": "40", "batch_size": "256", "subsample": "0", "seed": "0",
        "packed": "0", "prefetch_batches": "0",
        "ledger_path": os.path.join(workdir, "LEDGER.jsonl"),
    }
    base.update({k: str(v) for k, v in overrides.items()})
    return Word2VecTrainer(Config(base), corpus_ids=ids, vocab=vocab, device=device)


def run_loop(trainer, max_steps: int):
    """Build + run a TrainLoop; returns ``(loop, state, steps_done)``."""
    from swiftsnails_tpu_torch.framework.trainer import TrainLoop

    loop = TrainLoop(trainer, log_every=0)
    state = loop.run(max_steps=max_steps)
    steps_done = loop._items_seen // trainer.batch_size
    return loop, state, steps_done


def tables_finite(state) -> bool:
    from swiftsnails_tpu_torch.utils.tree import tensor_items

    return all(bool(torch.isfinite(t).all()) for _, t in tensor_items(state)
               if t.is_floating_point())


def eval_loss(trainer, state, n: int = 512) -> float:
    """Deterministic held-out SGNS eval loss of a word2vec state: the dense
    path's as in the JAX package, and on the packed plane over a row's
    whole ``[S, 128]`` width, as its step computes it. Reads rows by
    ``index_select`` (no kernel of the port), on the tables' device."""
    from swiftsnails_tpu_torch.models.word2vec import sgns_loss

    ids = trainer.corpus_ids
    n = min(n, len(ids) // 2 - 1)
    c = np.asarray(ids[0:2 * n:2], np.int64)
    x = np.asarray(ids[1:2 * n:2], np.int64)
    rng = np.random.default_rng(99)
    negs = rng.integers(0, len(trainer.vocab),
                        (len(c), trainer.negatives)).astype(np.int64)

    def rows(table, idx):
        t = table.table
        return t.index_select(0, torch.from_numpy(idx).to(t.device)).float().reshape(
            len(idx), -1)

    v = rows(state.in_table, c)
    u_pos = rows(state.out_table, x)
    u_neg = rows(state.out_table, negs.reshape(-1)).reshape(len(c), trainer.negatives, -1)
    return float(sgns_loss(v, u_pos, u_neg))


def _workdir(workdir: Optional[str]) -> str:
    return workdir or tempfile.mkdtemp(prefix="chaos-drill-")


# ----------------------------------------------------------------- drills ---


def _poison_drill(workdir: str, spec: str, steps: int = 16,
                  device: DeviceLike = None) -> Dict:
    trainer = make_trainer(workdir, device=device, guardrail=1, guard_max_consecutive=5,
                           chaos_spec=spec, chaos_seed=11)
    loop, state, steps_done = run_loop(trainer, max_steps=steps)
    guard = loop.guardrail.summary()
    finite = tables_finite(state)
    return {
        "recovered": bool(finite and steps_done == steps
                          and guard["trips_total"] > 0
                          and loop.guardrail.trust == 1.0),
        "spec": spec,
        "steps": steps_done,
        "trips": guard["trips_total"],
        "steps_skipped": guard["steps_skipped"],
        "tables_finite": finite,
        "final_loss": round(eval_loss(trainer, state), 6),
    }


def drill_nan_burst(workdir: Optional[str] = None, device: DeviceLike = None) -> Dict:
    """A 3-step NaN-gradient burst must be rolled back step by step, with
    zero non-finite values reaching the master tables, and trust recovering
    to 1.0 within the run."""
    return _poison_drill(_workdir(workdir), "nan_grad@4-6", device=device)


def drill_inf_update(workdir: Optional[str] = None, device: DeviceLike = None) -> Dict:
    """An overflowed (+inf) update — the quantized-collective failure mode —
    must trip and roll back exactly like NaN."""
    return _poison_drill(_workdir(workdir), "inf_grad@5", device=device)


def drill_row_poison(workdir: Optional[str] = None, device: DeviceLike = None) -> Dict:
    """A parameter row corrupted BEFORE the step (bad pull) must be detected
    at commit and the clean pre-poison snapshot restored."""
    return _poison_drill(_workdir(workdir), "row_poison@5", device=device)


def drill_io_error(workdir: Optional[str] = None, steps: int = 12,
                   device: DeviceLike = None) -> Dict:
    """A transient data-stream error must cost a retry, not the run."""
    workdir = _workdir(workdir)
    trainer = make_trainer(workdir, device=device, chaos_spec="io_error@3,io_error@7",
                           chaos_seed=11)
    loop, state, steps_done = run_loop(trainer, max_steps=steps)
    injected = [e for e in loop.chaos.events if e["fault"] == "io_error"]
    return {
        "recovered": bool(steps_done == steps and len(injected) == 2),
        "steps": steps_done,
        "injected": len(injected),
        "tables_finite": tables_finite(state),
    }


def drill_ckpt_walkback(workdir: Optional[str] = None, device: DeviceLike = None) -> Dict:
    """Bit rot in the newest checkpoint must be caught by the manifest CRC
    and resume must walk back to the newest intact generation — recorded as
    a ``cache_error`` ledger event, never a crash."""
    from swiftsnails_tpu_torch.framework.checkpoint import intact_steps
    from swiftsnails_tpu_torch.resilience.chaos import corrupt_checkpoint_dir
    from swiftsnails_tpu_torch.resilience.resume import resume_state
    from swiftsnails_tpu_torch.telemetry.ledger import Ledger

    workdir = _workdir(workdir)
    root = os.path.join(workdir, "ck")
    ledger = Ledger(os.path.join(workdir, "LEDGER.jsonl"))
    trainer = make_trainer(workdir, device=device, param_backup_period=4,
                           param_backup_root=root)
    run_loop(trainer, max_steps=13)  # saves at 4, 8, 12
    newest = intact_steps(root)[0]
    corrupted = corrupt_checkpoint_dir(root, rng=np.random.default_rng(11),
                                       ledger=ledger)
    template = make_trainer(workdir, device=device, param_backup_root=root).init_state()
    restored = resume_state(root, template, mode="auto", ledger=ledger)
    ok = restored is not None and restored[1] < newest
    return {
        "recovered": bool(ok and ledger.latest("cache_error") is not None),
        "corrupted_step": newest,
        "corrupted_file": corrupted,
        "restored_step": restored[1] if restored else None,
        "cursor": restored[2] if restored else None,
    }


def drill_preempt_resume(workdir: Optional[str] = None, steps: int = 24,
                         preempt_at: int = 14, period: int = 5,
                         device: DeviceLike = None) -> Dict:
    """The full outage script: preemption mid-run (drain + final save),
    post-mortem corruption of that final save, then ``resume: auto`` walking
    back to the newest intact checkpoint, restoring the data cursor, and
    finishing the run with final loss at parity with an undisturbed one."""
    from swiftsnails_tpu_torch.framework.checkpoint import intact_steps
    from swiftsnails_tpu_torch.resilience.chaos import corrupt_checkpoint_dir
    from swiftsnails_tpu_torch.resilience.resume import resume_state
    from swiftsnails_tpu_torch.telemetry.ledger import Ledger

    workdir = _workdir(workdir)
    ledger = Ledger(os.path.join(workdir, "LEDGER.jsonl"))

    # undisturbed control
    control_tr = make_trainer(workdir, device=device)
    _, control_state, _ = run_loop(control_tr, max_steps=steps)
    loss_control = eval_loss(control_tr, control_state)

    # disturbed: preempt mid-run -> drain writes a final checkpoint
    root = os.path.join(workdir, "ck")
    tr1 = make_trainer(workdir, device=device, param_backup_period=period,
                       param_backup_root=root,
                       chaos_spec=f"preempt@{preempt_at}", chaos_seed=11)
    loop1, _, died_steps = run_loop(tr1, max_steps=steps)
    final_step = intact_steps(root)[0]

    # the final save rots on disk before the restart
    corrupt_checkpoint_dir(root, rng=np.random.default_rng(11), ledger=ledger)

    # measure the restore (walk-back) cost on a throwaway template, then
    # resume for real through the TrainLoop
    t0 = time.monotonic()
    probe = resume_state(root, make_trainer(workdir, device=device).init_state(),
                         mode="auto", ledger=ledger)
    restore_s = time.monotonic() - t0
    tr2 = make_trainer(workdir, device=device, param_backup_period=period,
                       param_backup_root=root, resume="auto")
    loop2, resumed_state, _ = run_loop(tr2, max_steps=steps)
    loss_resumed = eval_loss(tr2, resumed_state)
    parity = abs(loss_resumed - loss_control) / max(abs(loss_control), 1e-9)
    restored_step = loop2._restored_step
    return {
        "recovered": bool(
            loop1.preempted
            and probe is not None
            and restored_step is not None
            and restored_step < final_step
            and parity <= LOSS_PARITY_BAR
        ),
        "preempted": loop1.preempted,
        "died_at_step": died_steps,
        "final_save_step": final_step,
        "restored_step": restored_step,
        "steps_lost": (final_step - restored_step)
        if restored_step is not None else None,
        "time_to_recover_s": round(restore_s, 4),
        "loss_control": round(loss_control, 6),
        "loss_resumed": round(loss_resumed, 6),
        "loss_parity": round(parity, 6),
        "parity_bar": LOSS_PARITY_BAR,
    }


def drill_tier_bitflip(workdir: Optional[str] = None, steps: int = 12,
                       flip_at: int = 6, master_dtype: str = "float32",
                       device: DeviceLike = None, **_ignored) -> Dict:
    """Silent host-RAM corruption of a tiered master plane: a seeded bit is
    XOR'd directly into a :class:`HostMaster` plane (bypassing ``scatter``,
    so only the integrity digests can see it). The per-step verify sweep
    must detect the corrupt plane, rebuild it from the newest verified
    checkpoint with the resident cache re-asserted on top, and the run must
    finish with eval loss at parity with an unfaulted tiered control.

    ``master_dtype: int8`` runs the same drill over quantized host masters
    (code planes + scale sidebands); on top of the in-run flip, the result
    carries a direct detection probe that flips one code byte AND one scale
    byte on a throwaway quantized master and checks ``verify()`` names both
    planes — the in-run rng picks only one plane, the probe pins coverage of
    both kinds deterministically."""
    from swiftsnails_tpu_torch.telemetry.ledger import Ledger

    workdir = _workdir(workdir)
    tier_cfg = {
        "table_tier": "host",
        "tier_verify_period": 1,
        "steps_per_call": 1,
        "param_backup_period": 2,
        "tier_master_dtype": master_dtype,
    }

    # unfaulted tiered control (same step semantics, no chaos)
    ctl_dir = os.path.join(workdir, "control")
    os.makedirs(ctl_dir, exist_ok=True)
    ctl_tr = make_trainer(ctl_dir, device=device,
                          param_backup_root=os.path.join(ctl_dir, "ck"), **tier_cfg)
    _, ctl_state, _ = run_loop(ctl_tr, max_steps=steps)
    loss_control = eval_loss(ctl_tr, ctl_state)

    # faulted leg: the flip lands at `flip_at`, after checkpoints exist
    flt_dir = os.path.join(workdir, "faulted")
    os.makedirs(flt_dir, exist_ok=True)
    trainer = make_trainer(
        flt_dir, device=device, param_backup_root=os.path.join(flt_dir, "ck"),
        chaos_spec=f"tier_bitflip@{flip_at}", chaos_seed=11, **tier_cfg)
    loop, state, steps_done = run_loop(trainer, max_steps=steps)
    loss_faulted = eval_loss(trainer, state)
    parity = abs(loss_faulted - loss_control) / max(abs(loss_control), 1e-9)

    flips = [e for e in loop.chaos.events if e["fault"] == "tier_bitflip"]
    heal = None
    ledger = Ledger(os.path.join(flt_dir, "LEDGER.jsonl"))
    for r in ledger.records("cache_error"):
        if r.get("source") == "tier":
            heal = r
    detected = heal is not None and heal.get("rebuilt_from_step") is not None
    probe_ok = True
    probe: Optional[Dict] = None
    if master_dtype != "float32":
        probe = _quantized_plane_probe(master_dtype)
        probe_ok = probe["code_detected"] and probe["scale_detected"]
    out = {
        "recovered": bool(
            steps_done == steps
            and len(flips) == 1
            and detected
            and probe_ok
            and tables_finite(state)
            and parity <= LOSS_PARITY_BAR
        ),
        "steps": steps_done,
        "flip": flips[0] if flips else None,
        "detected_planes": (heal or {}).get("planes"),
        "rebuilt_from_step": (heal or {}).get("rebuilt_from_step"),
        "rebuilt_tables": (heal or {}).get("tables"),
        "master_dtype": master_dtype,
        "loss_control": round(loss_control, 6),
        "loss_faulted": round(loss_faulted, 6),
        "loss_parity": round(parity, 6),
        "parity_bar": LOSS_PARITY_BAR,
    }
    if probe is not None:
        out["plane_probe"] = probe
    return out


def _quantized_plane_probe(master_dtype: str) -> Dict:
    """Deterministic digest-coverage probe for quantized masters: flip one
    byte in the code plane and one in the scale sideband of a throwaway
    int8 :class:`HostMaster`; both flips must surface in ``verify()``."""
    from swiftsnails_tpu_torch.parallel.store import TableState
    from swiftsnails_tpu_torch.tiered.store import HostMaster

    rng = np.random.default_rng(3)
    state = TableState(
        table=torch.from_numpy(rng.normal(size=(32, 8)).astype(np.float32)), slots={})
    m = HostMaster(state, "dense", master_dtype=master_dtype)
    m.table.view(np.uint8).reshape(-1)[5] ^= np.uint8(1 << 3)
    code_detected = "table" in m.verify()
    m2 = HostMaster(state, "dense", master_dtype=master_dtype)
    m2.scales["table"].view(np.uint8)[9] ^= np.uint8(1 << 2)
    scale_detected = "table/scale" in m2.verify()
    return {"code_detected": bool(code_detected),
            "scale_detected": bool(scale_detected)}


def drill_tier_bitflip_int8(workdir: Optional[str] = None, **kw) -> Dict:
    """The tier bitflip drill over int8 (quantized) host masters."""
    kw.pop("master_dtype", None)
    return drill_tier_bitflip(workdir, master_dtype="int8", **kw)


_DRILL_FNS: Dict[str, Callable[..., Dict]] = {
    "nan_burst": drill_nan_burst,
    "inf_update": drill_inf_update,
    "row_poison": drill_row_poison,
    "io_error": drill_io_error,
    "ckpt_walkback": drill_ckpt_walkback,
    "preempt_resume": drill_preempt_resume,
    "tier_bitflip": drill_tier_bitflip,
    "tier_bitflip_int8": drill_tier_bitflip_int8,
}

FAST_DRILLS = ("nan_burst", "io_error", "ckpt_walkback")


def run_drill_matrix(fast: bool = False, workdir: Optional[str] = None,
                     device: DeviceLike = None) -> Dict[str, Dict]:
    """Run the drill matrix; each drill gets its own subdirectory so ledgers
    and checkpoints never cross-contaminate. A drill that *raises* is an
    unrecovered fault by definition."""
    base = _workdir(workdir)
    names = FAST_DRILLS if fast else DRILLS
    results: Dict[str, Dict] = {}
    for name in names:
        d = os.path.join(base, name)
        os.makedirs(d, exist_ok=True)
        t0 = time.monotonic()
        try:
            res = _DRILL_FNS[name](d, device=device)
        except Exception as e:
            res = {"recovered": False,
                   "error": f"{type(e).__name__}: {e}"}
        res["elapsed_s"] = round(time.monotonic() - t0, 2)
        results[name] = res
    return results


# ------------------------------------------------- bench `chaos` lane -------


def _bench_corpus(small: bool):
    """Zipf corpus big enough that the guardrail's per-step cost is measured
    against real step work (the paired probe corpus is too small for an
    honest overhead number)."""
    from swiftsnails_tpu_torch.data.vocab import Vocab

    vocab_n = 512 if small else 4096
    n_tokens = 20_000 if small else 120_000
    rng = np.random.default_rng(5)
    ranks = np.arange(1, vocab_n + 1, dtype=np.float64)
    w = 1.0 / ranks ** 1.05
    cdf = np.cumsum(w) / w.sum()
    ids = np.searchsorted(cdf, rng.random(n_tokens)).astype(np.int32)
    counts = np.maximum(np.bincount(ids, minlength=vocab_n), 1).astype(np.int64)
    return ids, Vocab([f"w{i}" for i in range(vocab_n)], counts)


def chaos_bench(workdir: Optional[str] = None, small: bool = False,
                device: DeviceLike = None) -> Dict:
    """The bench ``chaos`` lane: guardrail overhead on the no-fault control
    leg + the scripted fault drills' recovery numbers, as one JSON-ready
    block (lands in the bench line, the run ledger, and the
    ``ledger-report --check-regression`` gate)."""
    t_lane0 = time.monotonic()
    base = _workdir(workdir)
    corpus = _bench_corpus(small)
    over = {
        "dim": 16 if small else 64,
        "batch_size": 512 if small else 2048,
        "window": 2,
        "num_iters": 8,
    }
    warm, steps = (2, 12) if small else (3, 32)

    def wps(extra: Dict) -> float:
        """Steady-state pair rate of the control leg: one TrainLoop, a warm
        run that pays the first-use costs (the kernels' builds, the
        allocator), then best-of-3 timed runs (machine-load noise only ever slows a run,
        so max is the robust estimator — the headline bench's lesson). A
        rate for the overhead ratio, NOT comparable to words/sec/chip."""
        from swiftsnails_tpu_torch.framework.trainer import TrainLoop

        d = tempfile.mkdtemp(dir=base)
        tr = make_trainer(d, corpus=corpus, device=device, **{**over, **extra})
        loop = TrainLoop(tr, log_every=0)
        loop.run(max_steps=warm)
        best = 0.0
        for _ in range(3):
            t0 = time.monotonic()
            loop.run(max_steps=steps)
            dt = max(time.monotonic() - t0, 1e-9)
            best = max(best, steps * over["batch_size"] / dt)
        return best

    control = wps({})
    guarded = wps({"guardrail": 1})
    overhead_pct = (control - guarded) / control * 100.0 if control else None

    drills = run_drill_matrix(fast=small, workdir=os.path.join(base, "drills"),
                              device=device)
    resume_drill = drills.get("preempt_resume") or drills.get("ckpt_walkback")
    block = {
        "control_words_per_sec": round(control, 1),
        "guard_words_per_sec": round(guarded, 1),
        "guard_overhead_pct": (
            round(overhead_pct, 2) if overhead_pct is not None else None
        ),
        "nan_drill": drills.get("nan_burst"),
        "resume_drill": resume_drill,
        "drills": {k: {"recovered": v.get("recovered"),
                       "elapsed_s": v.get("elapsed_s")}
                   for k, v in drills.items()},
        "recovered_all": all(v.get("recovered") for v in drills.values()),
        "loss_parity": (resume_drill or {}).get("loss_parity"),
        "small": small,
        "elapsed_s": round(time.monotonic() - t_lane0, 1),
    }
    return block
