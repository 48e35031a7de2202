"""The ``freshness`` lane: hot-row delta shipping trainer -> fleet — the JAX
package's ``freshness/bench_lane.py``, with the port's trainer and fleet on
``device`` (default: the card; ``device="cpu"`` runs the plain versions).

The port has no bench script that writes its block into the ledger yet
(``ROADMAP.md``); ``tests/test_torch_freshness.py`` runs it small on the
CPU. The main leg runs the real pipeline end to end:

- train a dense word2vec model to a checkpoint at step S1 and load it into
  a 2-replica :class:`Fleet`;
- resume training S1 -> S2 with ``freshness_publish: 1`` on a background
  thread while a :class:`DeltaSubscriber` poll thread applies every delta
  batch to the fleet and an open-loop load generator drives pulls against
  it — delta lag and serve p99 are measured *under* concurrent apply;
- at the S2 watermark, delta-applied fleet rows must be **bit-identical**
  to a fresh ``Servant.from_checkpoint`` of the step-S2 checkpoint
  (``bit_parity`` = mismatched-element fraction, 0.0 required);
- a gap drill deletes a delta segment mid-stream: the subscriber must fall
  back to a full checkpoint reload, resubscribe past the gap, and converge
  back to parity 0.0.

Correctness (parity, gap recovery) gates on any platform; the latency
numbers are serving-machinery latencies of the device the lane ran on. The
block is the one the ``ledger-report --check-regression`` gate reads (see
``_check_freshness_regression``).
"""

from __future__ import annotations

import os
import tempfile
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

FRESHNESS_SEED = 17
# the fleet lane's serve p99 SLO (the JAX package's serving/fleet_lane.py:52,
# SLO_P99_MS); the port has no fleet lane yet, so it keeps its own copy
SLO_P99_MS = 60.0
# delta lag ceiling (publish ts -> applied ts, p99): file tail + poll loop on
# the same host — generous because CI boxes stall, but a wedged subscriber
# (seconds behind) must fail the gate
LAG_CEILING_MS = 2500.0


def _corpus(small: bool, vocab_n: int):
    """Zipf corpus over ``vocab_n`` words, frequency-ranked ids."""
    from swiftsnails_tpu_torch.data.vocab import Vocab

    n_tokens = 20_000 if small else 80_000
    rng = np.random.default_rng(FRESHNESS_SEED)
    ranks = np.arange(1, vocab_n + 1, dtype=np.float64)
    w = 1.0 / ranks ** 1.1
    cdf = np.cumsum(w) / w.sum()
    ids = np.searchsorted(cdf, rng.random(n_tokens)).astype(np.int32)
    counts = np.maximum(
        np.bincount(ids, minlength=vocab_n), 1).astype(np.int64)
    return ids, Vocab([f"w{i}" for i in range(vocab_n)], counts)


def _make_trainer(corpus, workdir: str, device=None, **overrides):
    from swiftsnails_tpu_torch.models.word2vec import Word2VecTrainer
    from swiftsnails_tpu_torch.utils.config import Config

    ids, vocab = corpus
    base = {
        "dim": "16", "window": "1", "negatives": "4",
        "learning_rate": "0.3", "num_iters": "40", "batch_size": "128",
        "subsample": "0", "seed": "0", "packed": "0",
        "prefetch_batches": "0",
    }
    base.update({k: str(v) for k, v in overrides.items()})
    cfg = Config(base)
    return Word2VecTrainer(cfg, corpus_ids=ids, vocab=vocab, device=device), cfg


class _RecordingTarget:
    """Forwarding wrapper that remembers which rows deltas touched, so the
    parity check compares exactly the delta-applied set (public subscriber
    surface only — no reaching into its internals)."""

    def __init__(self, inner):
        self._inner = inner
        self.rows: Dict[str, set] = {}

    @property
    def step(self) -> int:
        return self._inner.step

    def apply_rows(self, updates, **kw):
        for name, (ids, _vals) in updates.items():
            self.rows.setdefault(name, set()).update(
                int(r) for r in np.asarray(ids))
        return self._inner.apply_rows(updates, **kw)

    def reload_from_checkpoint(self, root, config, **kw):
        return self._inner.reload_from_checkpoint(root, config, **kw)


def _parity(reference, served, rows: Dict[str, set]) -> float:
    """Mismatched-element fraction over the delta-applied rows: 0.0 means
    every applied row serves bit-identically to the reference planes."""
    bad = total = 0
    for name, rowset in rows.items():
        if not rowset or name not in reference._tables:
            continue
        want = reference._tables[name]
        ids = torch.from_numpy(np.fromiter(sorted(rowset), np.int64)).to(want.device)
        want = want.index_select(0, ids)
        got = served._tables[name].to(want.device).index_select(0, ids)
        bad += int((want != got).sum())
        total += int(want.numel())
    return float(bad) / float(total) if total else 1.0


def _full_parity(reference, served) -> float:
    """Whole-plane mismatch fraction (post-fallback: a full reload must
    leave every row equal to the reference checkpoint)."""
    bad = total = 0
    for name, want in reference._tables.items():
        got = served._tables[name].to(want.device)
        bad += int((want != got).sum())
        total += int(want.numel())
    return float(bad) / float(total) if total else 1.0


def freshness_bench(small: bool = False, workdir: Optional[str] = None,
                    ledger=None, device=None) -> Dict:
    """Run the freshness lane; returns the ``freshness`` block for the
    bench JSON.

    Gated fields (``ledger-report --check-regression``): ``bit_parity``
    (0.0 required, any platform), ``gap_drill.recovered`` +
    ``gap_drill.parity``, ``lag_p99_ms`` vs ``lag_ceiling_ms``, and
    ``serve_p99_ms`` vs ``slo_p99_ms`` while deltas were applying.
    """
    from swiftsnails_tpu_torch.framework.trainer import TrainLoop
    from swiftsnails_tpu_torch.freshness.subscriber import DeltaSubscriber
    from swiftsnails_tpu_torch.serving.engine import Servant
    from swiftsnails_tpu_torch.serving.fleet import Fleet
    from swiftsnails_tpu_torch.serving.loadgen import run_open_loop
    from swiftsnails_tpu_torch.utils.config import Config

    vocab_n = 512 if small else 1024
    s1, s2 = (8, 48) if small else (16, 96)
    load_qps, load_s = (40.0, 2.0) if small else (80.0, 4.0)
    corpus = _corpus(small, vocab_n)

    own_tmp = None
    if workdir is None:
        own_tmp = tempfile.TemporaryDirectory(prefix="ssn-freshness-")
        workdir = own_tmp.name
    try:
        ck_root = os.path.join(workdir, "ckpt")
        delta_dir = os.path.join(workdir, "deltas")
        common = {
            "param_backup_root": ck_root,
            "param_backup_period": s1,
            "ledger_path": os.path.join(workdir, "LEDGER.jsonl"),
        }
        # -- phase A: train to S1, checkpoint, serve it ---------------------
        tr_a, _ = _make_trainer(corpus, workdir, device, **common)
        TrainLoop(tr_a, log_every=0).run(max_steps=s1)

        serve_cfg = Config({
            "dim": "16", "packed": "0", "seed": str(FRESHNESS_SEED),
        })
        fleet = Fleet.from_checkpoint(
            ck_root, serve_cfg, replicas=2, ledger=ledger, device=device)
        try:
            # warm the delta-apply scatter compiles at the power-of-two
            # shapes prepare_rows pads to, with the planes' own values —
            # value-level no-ops, so the lag/p99 measurement below sees the
            # steady-state apply cost, not first-compile stalls
            first_servant = next(iter(fleet._replicas.values())).servant
            for m in (64, 256, min(1024, vocab_n)):
                warm_ids = np.arange(min(m, vocab_n), dtype=np.int64)
                fleet.apply_rows({
                    name: (warm_ids, plane[torch.from_numpy(warm_ids).to(plane.device)]
                           .cpu().numpy())
                    for name, plane in first_servant._tables.items()})
            target = _RecordingTarget(fleet)
            sub = DeltaSubscriber(
                target, delta_dir, config=serve_cfg,
                checkpoint_root=ck_root, max_lag_ms=LAG_CEILING_MS,
                ledger=ledger)

            # -- phase B: resume S1 -> S2 publishing deltas, under load -----
            tr_b, _ = _make_trainer(
                corpus, workdir, device, **common, resume="auto",
                freshness_publish=1, freshness_dir=delta_dir,
                freshness_delta_dtype="float32")
            loop_b = TrainLoop(tr_b, log_every=0)
            trainer_err: List[BaseException] = []

            def _train():
                try:
                    loop_b.run(max_steps=s2)
                except BaseException as e:  # surfaced after join
                    trainer_err.append(e)

            th = threading.Thread(
                target=_train, name="ssn-freshness-train", daemon=True)
            th.start()
            # publisher BASE appears when the resumed run opens; subscribe
            # as soon as it does so lag is measured from the start
            deadline = time.monotonic() + 60.0
            while not sub.subscribe() and time.monotonic() < deadline:
                time.sleep(0.02)
            sub.start(interval_s=0.02)

            # warmup half (pull-path compiles + batcher fill), then measure
            # — the fleet lane's probe discipline
            run_open_loop(
                lambda anchor, ids: fleet.pull(ids),
                qps=load_qps, duration_s=load_s / 2, seed=FRESHNESS_SEED - 1,
                id_space=vocab_n, batch=16, zipf_a=1.2,
            )
            res = run_open_loop(
                lambda anchor, ids: fleet.pull(ids),
                qps=load_qps, duration_s=load_s, seed=FRESHNESS_SEED,
                id_space=vocab_n, batch=16, zipf_a=1.2,
            )
            th.join(timeout=300.0)
            if trainer_err:
                raise trainer_err[0]
            # drain the tail of the stream (final force-publish included)
            deadline = time.monotonic() + 30.0
            while (sub.status()["applied_step"] < s2
                   and time.monotonic() < deadline):
                time.sleep(0.02)
            sub.stop()
            st = sub.status()

            # -- parity at the watermark ------------------------------------
            reference = Servant.from_checkpoint(ck_root, serve_cfg, step=s2,
                                                device=device)
            first = next(iter(fleet._replicas.values())).servant
            bit_parity = _parity(reference, first, target.rows)
            versions = {rid: rep.servant.version
                        for rid, rep in fleet._replicas.items()}
            cutover_atomic = len(set(versions.values())) == 1

            # -- gap drill: missing segment -> full reload -> reconverge ----
            gap = _gap_drill(
                fleet, reference, serve_cfg, ck_root,
                os.path.join(workdir, "deltas-gap"), s2, ledger=ledger)

            return {
                "small": bool(small),
                "steps": {"base": s1, "watermark": s2},
                "published_batches": st["applied_seq"],
                "applied_batches": st["applied_batches"],
                "applied_rows": st["applied_rows"],
                "applied_step": st["applied_step"],
                "lag_p50_ms": st["lag_p50_ms"],
                "lag_p99_ms": st["lag_p99_ms"],
                "lag_ceiling_ms": LAG_CEILING_MS,
                "serve_p99_ms": res["p99_ms"],
                "serve_qps": res["achieved_qps"],
                "slo_p99_ms": SLO_P99_MS,
                "bit_parity": bit_parity,
                "cutover_atomic": cutover_atomic,
                "replica_versions": versions,
                "gap_drill": gap,
            }
        finally:
            fleet.close()
    finally:
        if own_tmp is not None:
            own_tmp.cleanup()


def _gap_drill(fleet, reference, serve_cfg, ck_root: str, drill_dir: str,
               watermark: int, ledger=None) -> Dict:
    """Delete a delta segment mid-stream; the subscriber must detect the
    gap, fall back to a full checkpoint reload, resubscribe past it, and
    end bit-identical to the reference planes."""
    from swiftsnails_tpu_torch.freshness.log import seg_path
    from swiftsnails_tpu_torch.freshness.publisher import DeltaPublisher
    from swiftsnails_tpu_torch.freshness.subscriber import DeltaSubscriber

    # real rows from the reference planes, so post-gap re-apply is
    # value-identical to the fallback reload they land on
    name = next(iter(reference._tables))
    plane = reference._tables[name].cpu().numpy()
    rng = np.random.default_rng(FRESHNESS_SEED + 1)
    pub = DeltaPublisher(drill_dir, base_step=watermark, ledger=ledger)
    sub = DeltaSubscriber(
        fleet, drill_dir, config=serve_cfg, checkpoint_root=ck_root,
        ledger=ledger)

    def _batch(step):
        rows = np.sort(rng.choice(plane.shape[0], size=8, replace=False))
        return {name: (rows.astype(np.int64), plane[rows])}

    pub.publish(_batch(watermark + 1), step=watermark + 1)
    pub.publish(_batch(watermark + 2), step=watermark + 2)
    sub.subscribe()
    sub.poll()
    before = sub.status()["applied_seq"]
    # write 3..5, then destroy 3 before the subscriber sees it
    for k in (3, 4, 5):
        pub.publish(_batch(watermark + k), step=watermark + k)
    os.remove(seg_path(drill_dir, 3))
    sub.poll()  # gap at seq 3 -> fallback reload -> resubscribe at 4
    sub.poll()  # apply 4..5 on the reloaded planes
    st = sub.status()
    first = next(iter(fleet._replicas.values())).servant
    parity = _full_parity(reference, first)
    return {
        "recovered": bool(st["fallbacks"] >= 1 and st["applied_seq"] == 5),
        "fallbacks": st["fallbacks"],
        "applied_seq_before": before,
        "applied_seq": st["applied_seq"],
        "parity": parity,
    }


def freshness_chaos_drill(small: bool = True,
                          workdir: Optional[str] = None,
                          ledger=None, device=None) -> Dict:
    """The chaos matrix of the freshness plane (the JAX package's
    ``tools/chaos_drill.py --freshness``): three induced
    freshness failures against a live fleet, each required to fall back to
    a full checkpoint reload and converge to parity 0.0.

    - ``publisher_kill``: the publisher dies mid-stream and a NEW
      incarnation takes over the same directory (restart detection);
    - ``corrupt_delta``: one delta batch is bit-flipped on disk (CRC);
    - ``forced_gap``: a published segment is deleted before the subscriber
      reads it (sequence gap).
    """
    from swiftsnails_tpu_torch.freshness.log import seg_path
    from swiftsnails_tpu_torch.freshness.publisher import DeltaPublisher
    from swiftsnails_tpu_torch.freshness.subscriber import DeltaSubscriber
    from swiftsnails_tpu_torch.serving.engine import Servant
    from swiftsnails_tpu_torch.serving.fleet import Fleet
    from swiftsnails_tpu_torch.utils.config import Config

    own_tmp = None
    if workdir is None:
        own_tmp = tempfile.TemporaryDirectory(prefix="ssn-freshness-drill-")
        workdir = own_tmp.name
    try:
        from swiftsnails_tpu_torch.framework.checkpoint import save_checkpoint
        from swiftsnails_tpu_torch.models.word2vec import Word2VecTrainer
        from swiftsnails_tpu_torch.framework.quality import paired_corpus

        dim, capacity = (16, 1 << 9) if small else (32, 1 << 11)
        ids, vocab = paired_corpus(n_pairs=32, reps=4, seed=FRESHNESS_SEED)
        cfg = Config({
            "dim": str(dim), "capacity": str(capacity), "packed": "0",
            "seed": str(FRESHNESS_SEED), "subsample": "0",
        })
        trainer = Word2VecTrainer(cfg, corpus_ids=ids, vocab=vocab, device=device)
        state = trainer.init_state()
        ck_root = os.path.join(workdir, "ckpt")
        save_checkpoint(ck_root, state, step=1, wait=True)
        reference = Servant.from_checkpoint(ck_root, cfg, device=device)
        rng = np.random.default_rng(FRESHNESS_SEED)
        plane = reference._tables["in_table"].cpu().numpy()

        def _batch():
            rows = np.sort(
                rng.choice(plane.shape[0], size=8, replace=False))
            return {"in_table": (rows.astype(np.int64), plane[rows])}

        from swiftsnails_tpu_torch.telemetry.request_trace import (
            RequestTracer,
            tree_complete,
        )

        drills: Dict[str, Dict] = {}
        for drill in ("publisher_kill", "corrupt_delta", "forced_gap"):
            fleet = Fleet.from_checkpoint(
                ck_root, cfg, replicas=2, ledger=ledger, device=device)
            # tail-keep only: the gap->fallback must land as a complete,
            # drillable span tree even at sample rate 0
            tracer = RequestTracer(
                0.0, anomaly_keep=True, seed=FRESHNESS_SEED)
            try:
                d = os.path.join(workdir, drill)
                pub = DeltaPublisher(d, base_step=1, ledger=ledger,
                                     request_tracer=tracer)
                sub = DeltaSubscriber(
                    fleet, d, config=cfg, checkpoint_root=ck_root,
                    ledger=ledger, request_tracer=tracer)
                pub.publish(_batch(), step=2)
                pub.publish(_batch(), step=3)
                sub.subscribe()
                sub.poll()
                if drill == "publisher_kill":
                    # the old incarnation dies; a new one reopens the dir
                    pub2 = DeltaPublisher(d, base_step=3, ledger=ledger)
                    pub2.publish(_batch(), step=4)
                    sub.poll()  # detects the restart -> fallback
                    sub.poll()  # applies the new incarnation's stream
                elif drill == "corrupt_delta":
                    p = pub.publish(_batch(), step=4)
                    path = seg_path(d, p)
                    blob = bytearray(open(path, "rb").read())
                    blob[len(blob) // 2] ^= 0xFF
                    open(path, "wb").write(bytes(blob))
                    sub.poll()
                else:  # forced_gap
                    gone = pub.publish(_batch(), step=4)
                    pub.publish(_batch(), step=5)
                    os.remove(seg_path(d, gone))
                    sub.poll()
                    sub.poll()  # re-apply past the gap after the reload
                st = sub.status()
                first = next(iter(fleet._replicas.values())).servant
                parity = _full_parity(reference, first)
                versions = {rid: rep.servant.version
                            for rid, rep in fleet._replicas.items()}
                # the fallback must be drillable: a kept anomaly trace with
                # the full detect -> reload -> resubscribe timeline
                fb_traces = [
                    t for t in (c.to_dict()
                                for c in tracer.anomaly_traces())
                    if "fallback" in t["anomalies"] and tree_complete(
                        t, require=("detect", "reload", "resubscribe",
                                    "request"))]
                drills[drill] = {
                    "recovered": bool(st["fallbacks"] >= 1
                                      and parity == 0.0
                                      and len(set(versions.values())) == 1
                                      and fb_traces),
                    "fallbacks": st["fallbacks"],
                    "parity": parity,
                    "applied_seq": st["applied_seq"],
                    "fallback_traces": len(fb_traces),
                    "trace_id": (fb_traces[-1]["trace_id"]
                                 if fb_traces else None),
                }
            finally:
                fleet.close()
        drills["recovered_all"] = all(
            v["recovered"] for k, v in drills.items() if isinstance(v, dict))
        return drills
    finally:
        if own_tmp is not None:
            own_tmp.cleanup()
