"""Chip smoke test of the PyTorch port: builds its CUDA kernels, holds each
against its plain PyTorch version, and trains word2vec at full width on one
NVIDIA GPU through the port's normal entry points, on each of its six
paths: packed+pool, fused-hogwild (``fused: 1``), fused-grouped
(``fused: 1, grouped: 1``), and on top of fused-grouped fused-resident
(``resident: 1``), fused-dedup (``dedup: 1``) and fused-dedup-res (both),
and the per-pair rungs ``packed: 0`` (the 2-D plane) and ``neg_mode:
per_pair``, all on the native batch producer; then the CTR families on the
small-row plane with AdaGrad, and Wide & Deep at ``examples/widedeep.conf``'s
full width, on the small-row plane and at ``packed: 0``, and FFM over 39
fields (table dim 157, the 2-D plane); then the native producer against the
numpy one, ``stream: 1``, and the quality probe on every path; then the
bulk-copy completion
probes through ``python -m swiftsnails_tpu_torch.tools.sem_probe``'s ``main``;
then ``python -m swiftsnails_tpu_torch train`` on ``examples/word2vec.conf``
and ``examples/word2vec_fast.conf``, stopped by a real SIGTERM and resumed,
the training fault drill, and the guardrail's cost.

    python3 chip_smoke.py [--seed N]

Run from the root of the repository on a machine with a CUDA card, ``nvcc``
(``$CUDA_HOME`` or ``/usr/local/cuda``) and PyTorch built for CUDA. The
kernels build at first use into ``swiftsnails_tpu_torch/build/``. Each phase
prints one JSON line; any failure exits non-zero. The last line is
``{"ok": true, "device": {...}}``. Without a card, or outside the repository,
it exits non-zero and prints no result.

Phases:

1. ``env``: the card, its power limit, TF32 off for matmul and cuDNN.
2. ``build``: compile ``csrc/rowdma.cu``, ``csrc/fused_sgns.cu``,
   ``csrc/fused_sgns_merged.cu`` and ``csrc/sem_probe.cu``, one ``nvcc``
   each, started together; their ptxas register and spill lines.
3. ``kernel``: each row kernel at the main path's shapes (f32 and bf16; the
   in-table pull and push of 16,384 rows, the out-table ones of 18,432),
   bit-equal to its plain version, timed beside the plain version, one
   PyTorch library call and its bound (least bytes / the card's memory
   rate); ``gather_rows`` and ``index_select`` timed in turns (kernel,
   library, library, kernel). Each fused kernel (f32 and bf16; flat: 16,384
   pairs in 32 blocks of 512 sharing 64 pool rows; grouped: 8,192 centers
   in 32 blocks of 256, windows of 10 slots): on block-local ids (each
   block's rows drawn zipf-wise from its own range) within rtol 1e-5 /
   atol 1e-6 of its plain version in f32, one bf16 rounding in bf16, and
   bit-identical across two runs; on zipf ids over the whole vocabulary
   (hogwild) finite, with a loss within 1e-2 of the plain version's; timed
   beside the plain version and the unfused packed substep on the same
   pairs and pool (no PyTorch call computes a fused SGNS step), against its
   bound (the larger of least bytes / memory rate and f32 flops / the f32
   rate); one launch a substep on the card (the profiler's count, held),
   its host time a call, its cluster size, CTAs, and the clusters of each
   size 1..8 that the card holds at once, from which its rule picked the
   size. Each merged kernel
   (f32 and bf16; the grouped shape, ``hot_rows`` 2,048 resident, ``u_cap``
   384 dedup, both 384 and 256 composed): on zipf ids over the whole
   vocabulary within rtol 1e-5 / atol 1e-6 of its plain version in f32; in
   bf16 within one bf16 rounding on block-local ids, and on zipf ids the
   elements beyond it counted (see ``_merged_case``); bit-identical across
   two runs; timed and bounded as the fused ones; one launch a substep on
   the card (the profiler's count, held), its time alone put beside the
   grouped kernel's alone from the same call.
   Then ``gather_rows`` and ``scatter_add_rows`` at the ``neg_mode:
   per_pair`` out-table shape (98,304 zipf ids, 16,384 contexts and 81,920
   negatives; the push's ids merged first), f32, the same checks and times.
4. ``slice_parity``: 4 substeps of a small config of each path with injected
   negative pools (per-pair negatives, ``[b, 5]``, on ``dense`` and
   ``perpair``) on the card and on the CPU (one kernel block a substep on
   the hogwild fused paths, where the card runs blocks concurrently and the
   CPU in order; 8 on the merged paths, whose blocks run in order on both);
   the tables agree within rtol 1e-5 / atol 1e-6 (reduction order),
   and two runs on the card are bit-identical.
5. ``train``, ``train_fused``, ``train_grouped``: ``Word2VecTrainer`` ->
   ``TrainLoop.run`` at vocab 1,048,576, dim 200, window 5, negatives 5,
   pool 64, f32 tables, 30 steps: packed+pool at batch 16,384 pairs and
   512 pairs a pool on the zipf corpus, lr 100 (see ``LR``), one substep a
   step; fused-hogwild at the same batch and fused-grouped at 8,192 centers
   and 256 centers a block on the paired corpus, lr 1,600, 8 substeps a
   step (see ``FUSED_LR``), each held to the plain version's blocks run in
   order at the same lr (``HOGWILD_FALL_SHARE``); ``train_resident``,
   ``train_dedup``,
   ``train_dedup_res`` as fused-grouped with their keys, at ``MERGED_LR``
   (410, 100, 410); ``train_dense`` (``packed: 0``: two ``[1,048,576,
   200]`` f32 tables, 1.68 GB, no kernel of the port) and ``train_perpair``
   (``neg_mode: per_pair``: two ``[1,048,576, 2, 128]``, 2.15 GB) as
   packed+pool, K = 5 independent negatives a pair.
   Every kernel's launch counter
   is set to 0 just before each run and read just after: the path's kernels
   must read 2 (row kernels) or 1 (a fused kernel) per substep, every other
   kernel 0; the loss must be finite and falling.
6. ``profile``: after each train phase, device time by kernel over 5 more
   train steps (``torch.profiler``) and the card's busy share of their wall
   time.
7. ``kernel`` (CTR): the pull's ``gather_rows`` of a batch's 212,992 tile
   ids from the slot-fused ``[262,144, 2, 128]`` table, then
   ``scatter_adagrad_fused_rows`` on that table, ``scatter_adagrad_rows``
   and ``scatter_write_rows`` on ``[262,144, 1, 128]`` and its accumulator,
   at the Wide & Deep push shape (the same ids merged by tile, the tail
   padding kept; ~136,700 unique tiles), f32 and bf16: bit-equal to the
   plain version and bit-identical across two runs, timed beside the plain
   version and, for the gather and the write, ``index_select`` and
   ``index_copy_``, against the bound (unique tiles' bytes read and
   written, the gradients and ids read, over the memory rate).
8. ``ctr_parity``: 4 steps of ``logreg`` (SGD, and AdaGrad), ``fm``, ``ffm``
   (8 fields, table dim 33) and ``widedeep`` at capacity 16,384 on the card
   against the port on the CPU from one state: losses within rtol 1e-5,
   each array's change within 1e-4 of the CPU's largest change, and a step
   launching one ``gather_rows`` and one ``scatter_adagrad_fused_rows``
   (AdaGrad) or ``scatter_add_rows`` (SGD), nothing else. Then one push of
   each store route no family takes, within rtol 1e-5 / atol 1e-6 of the
   CPU: ``push_packed`` with AdaGrad (2 ``gather_rows``, 2
   ``scatter_write_rows``), ``push_packed_small`` with a split accumulator
   (1 ``scatter_adagrad_rows``) and with bf16 slots (2 and 2).
9. ``train_widedeep``: ``examples/widedeep.conf`` through ``get_model`` ->
   ``TrainLoop.run`` for 30 steps of 8,192 ``synth_ctr`` records (26
   fields, 40,000 ids a field, from ``--seed``): one ``gather_rows`` and
   one ``scatter_adagrad_fused_rows`` a step and nothing else, a finite
   loss whose last 5 steps average below its first 5, examples/sec over
   steps 6–30, and ``eval_auc`` on 20,000 held-out records; then its
   ``profile`` line. ``ctr_parity`` also runs Wide & Deep at ``packed: 0``
   and FFM at ``factor_dim`` 20 (table dim 161), both on the 2-D plane (no
   kernel of the port), the accumulator slot compared too.
   ``train_widedeep_2d`` (the conf at ``packed: 0``: ``[1,048,576, 17]`` and
   its accumulator) and ``train_ffm_wide`` (FFM, 39 fields, ``factor_dim``
   4: ``[1,048,576, 157]`` and its accumulator, 1.32 GB, on ``synth_ctr``
   with 39 fields) the same way, no launch of the port's kernels, their AUC
   beside the packed phase's; each with its ``profile`` line.
   ``native_producer``: ``batches()`` alone on the host, the native
   producer against the numpy one, on the zipf corpus (2,000,000 tokens,
   window 5, batch 16,384, flat and grouped): words/sec of a whole pass;
   gate: a second native run of the seed gives the same first 8 batches.
   Then ``train`` and ``train_grouped`` end to end on each producer, in
   turns (native, python, python, native): words/sec over steps 6–30.
   ``stream``: ``stream: 1`` for ``examples/word2vec.conf`` (capacity
   1,048,576) on a written 300,000-token corpus and for
   ``examples/widedeep.conf`` on a written file of 98,304 ``synth_ctr``
   records; gates: the first 8 batches equal the whole-file run's (one
   chunk), the producer is native, 10 steps train with finite losses.
   ``quality``: ``framework/quality.probe_top1`` on the card for each path
   of the JAX package's ``tests/test_path_quality.py`` (the fused ones
   through their kernels); hard gate at ``MIN_TOP1`` (0.75) on ``dense``,
   ``packed_perpair`` and ``packed_pool``, the fused scores printed.
10. ``sem_probe``: the probe tool's ``main`` at ``--dim 200`` (not
    ``--quick``), its three kernels' counters set to 0 just before and read
    just after. Unit: each of the five tags accounts exactly its copy's
    bytes, exact arming completes, arming 16 bytes above stays pending
    within the poll bound, and for ``f32[8,2,128]`` eight single-row copies
    complete one 8-row phase and seven do not. Chunk: the 64 gathered rows
    bit-equal to ``x[rows]`` (``max_abs_err`` 0) and the flag 65,536. Pipe
    (64 blocks of 1,856 ids into ``[100,000, 2, 128]`` f32): per-copy and
    chunked both bit-equal to the plain version and bit-identical across
    two runs; ms a call, µs a block and ns a copy of each, the speedup, and
    beside them ``index_select``, ``gather_rows`` and the byte bound.
11. ``cli_resume``: ``examples/word2vec.conf`` as it stands (dim 200,
    window 5, 5 negatives, batch 16,384, ``guardrail: 1``, ``resume:
    auto``) over a zipf text corpus from ``--seed`` (300,000 tokens over
    65,536 ids), with ``-capacity 1048576`` (two 1 GiB tables),
    ``-num_iters 1``, ``-min_count 1``, ``-param_backup_period 8``,
    ``-param_backup_root``/``-output`` in a temporary directory, ``-log_every
    1`` and ``-seed``, each listed in the phase's line. First an
    uninterrupted control through ``cli.main`` in this process, every launch
    counter set to 0 just before and read just after (``gather_rows`` and
    ``scatter_add_rows`` 2 a substep, every other kernel 0). Then
    ``python -m swiftsnails_tpu_torch train`` in a subprocess, sent a real
    SIGTERM after its second periodic manifest, mid-period: it must exit 0,
    say it was preempted and leave a final step past the last periodic one.
    Then the same command again: it must say it restored that step and run
    to the end of the data. Every step both runs committed must carry the
    control's CRCs and data cursor (bit-equal tables; every kernel of the
    path is bit-identical run to run), and ``vectors.txt`` must be the
    control's byte for byte. The line gives each run's save time split into
    the enqueue, the wait for the copy to the host, the CRC and the write,
    their GB/s, the restore time, the bytes of a step on disk and the
    words/sec of each run. Needs ``CLI_DISK_BYTES`` free; deletes its files.
12. ``cli_fast``: the same with ``examples/word2vec_fast.conf``
    (fused-dedup-res: 8 substeps a step), a paired corpus (5,000,000 tokens
    over 32,768 pairs), ``-param_backup_period 3`` and ``-learning_rate
    410`` (``MERGED_LR``; the conf's 0.025 moves no loss in 19 steps);
    ``fused_sgns_dedup_resident_step`` launches 1 a substep, every other
    kernel 0.
13. ``chaos``: ``examples/word2vec.conf`` in this process at its width with
    a 65,536-row table, ``chaos_spec: nan_grad@5-6,row_poison@9,
    ckpt_corrupt@12,preempt@17``, ``guard_max_consecutive: 3``,
    ``param_backup_period: 4``: trips rolled back and reported at steps 5,
    6 and 9, every table finite, the run preempted and drained at step 18,
    step 12 rejected by ``restore_checkpoint``; then the drain's save is
    corrupted and a run with ``resume: auto`` must reject it, report it,
    restore the newest step that verifies and finish; then
    ``chaos_spec: nan_grad@1-6`` with ``guard_max_consecutive: 2`` must
    raise ``GuardrailExhausted``.
14. ``guardrail_cost``: packed+pool at ``cli_resume``'s shape, 30 steps with
    ``guardrail: 1`` and without: step ms (median of steps 6-30), the
    overhead in ms and percent, the tables of the two runs bit-equal (no
    fault, so trust stays 1.0), and the guardrail's own device time a step
    by ``torch.profiler`` (snapshot copy, norm).
15. ``kernels``: one line for every ported kernel, with its launches in the
    run of its path (``path``) and its f32 numbers from phases 3, 7 and 10
    (``gather_rows`` and ``scatter_add_rows`` also at ``train_perpair``'s
    shape and launches); then ``total``, the script's seconds.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import io
import json
import math
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

# Peak device-memory rate, and f32 rate without tensor cores, by card
# (NVIDIA data sheets), bytes/s and flop/s. The H100 SXM figures are the
# default for an H100 that names no other form factor.
_MEM_RATE = (("H100 PCIe", 2.0e12), ("H100", 3.35e12))
_F32_RATE = (("H100 PCIe", 51.2e12), ("H100", 67e12))

# The main path's shapes (bench.py's north-star word2vec rung, packed+pool).
VOCAB = 1 << 20
DIM = 200
BATCH = 16_384
WINDOW = 5
NEGATIVES = 5
POOL_SIZE = 64
POOL_BLOCK = 512
# The loss is a mean over the batch's pairs, so each pair's step is lr / B.
# At bench.py's 0.025 and B = 16,384 that is 1.5e-6: after 30 steps the f32
# loss has not moved from its zero-table value 6 ln 2 (in the JAX package's
# math as in the port's). 100 moves it within 30 steps; word2vec.c's own
# per-pair step (lr = 0.025 B) diverges on the merged updates of the zipf head.
LR = 100.0
# The fused paths are hogwild: within a kernel block the last slot's write
# of a row wins and the blocks of a substep race, so a row keeps about one
# update a substep where the merged push sums them all (~1,100 for the head
# of the zipf corpus). On the zipf corpus, whose ids are drawn independently
# and so hold nothing to learn but the head's frequency, their loss does not
# fall at any lr (PERF.md, Findings). Their train phases use the paired corpus
# instead (word 2p always beside 2p + 1, as in the JAX package's quality
# probe; pairs zipf-distributed), bench.py's 8 substeps a call, and this lr
# (a sweep on the card, train_sweep.py: it falls at 410-3200, diverges at
# 4,800 grouped).
FUSED_LR = 1600.0
FUSED_STEPS_PER_CALL = 8
# The hogwild kernels race where blocks share a row; the plain version runs
# the blocks in order, as the TPU kernel does. Over the 30 steps the
# kernel's loss must fall (mean of the first 5 steps less the mean of the
# last 5) by at least this share of the plain version's fall at the same
# lr, seed and batches: a schedule that keeps fewer of the blocks' steps of
# a shared row learns less a step, and fails it.
HOGWILD_FALL_SHARE = 0.75
# The merged paths sum a hot or unique row's updates in a block, as the
# packed push does, so they take a smaller lr than the hogwild paths.
# train_sweep.py on the card (PERF.md, Findings) chose, on the paired corpus
# with 8 substeps a step: fused-resident and fused-dedup-res fall at 100-1,600
# and diverge at 1,600 on the zipf corpus, so 410; fused-dedup falls at
# 100-410, barely at 410, and rises at 1,600, so 100.
MERGED_LR = {"train_resident": 410.0, "train_dedup": 100.0, "train_dedup_res": 410.0}
HOT_ROWS = 2048  # fused-resident (bench.py:70-72)
U_CAP = 384  # fused-dedup (bench.py:73-75), and fused-dedup-res
COMPOSED_HOT_ROWS = 256  # fused-dedup-res (examples/word2vec_fast.conf)
# merged kernel -> its keys
MERGED = {"fused_sgns_resident_step": {"hot_rows": HOT_ROWS},
          "fused_sgns_dedup_step": {"u_cap": U_CAP},
          "fused_sgns_dedup_resident_step": {"u_cap": U_CAP, "hot_rows": COMPOSED_HOT_ROWS}}
N_TOKENS = 2_000_000
STEPS = 30
GROUPED_BATCH = 8_192  # centers a substep (bench.py's grouped rung)
CENTERS_PER_BLOCK = 256
CW = 2 * WINDOW
GATHER_ROWS = (BATCH, BATCH + (BATCH // POOL_BLOCK) * POOL_SIZE)  # in, out pulls
ROW_SETS = 8  # rotated between timed runs so most rows come from HBM, not L2

# Wide & Deep at examples/widedeep.conf's full width (26 fields, capacity
# 2^20, embed_dim 16 so table dim 17, hidden 256,128, AdaGrad at lr 0.05,
# batch 8,192): the small-row table is [262,144, 2, 128] f32, its accumulator
# fused in, and a step pulls and pushes 212,992 ids. The data: synth_ctr
# with 40,000 ids a field, 30 batches to train on and 20,000 records held
# out for eval_auc.
WIDEDEEP_CONF = "examples/widedeep.conf"  # from the root of the repository
CTR_IDS_PER_FIELD = 40_000
CTR_STEPS = 30
CTR_EVAL = 20_000
CTR_ROW_SETS = 4  # push id sets rotated between timed runs (~150k tiles each)
# ctr_parity: each family at small capacity, card against CPU. ffm at 8
# fields and factor_dim 4 has table dim 33.
CTR_PARITY = {
    "logreg_sgd": ("logreg", {"optimizer": "sgd"}),
    "logreg_adagrad": ("logreg", {}),
    "fm": ("fm", {"factor_dim": 8}),
    "ffm": ("ffm", {"factor_dim": 4}),
    "widedeep": ("widedeep", {"embed_dim": 16, "hidden_dims": "64,32"}),
    # the 2-D plane: packed: 0, and ffm at factor_dim 20 (table dim 161)
    "widedeep_2d": ("widedeep", {"embed_dim": 16, "hidden_dims": "64,32", "packed": 0}),
    "ffm_wide": ("ffm", {"factor_dim": 20}),
}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def _rate(table, name: str, what: str) -> float:
    for key, rate in table:
        if key in name:
            return rate
    raise RuntimeError(f"no {what} rate on record for {name!r}")


def mem_rate(name: str) -> float:
    return _rate(_MEM_RATE, name, "memory")


def f32_rate(name: str) -> float:
    return _rate(_F32_RATE, name, "f32")


def zipf_ids(n: int, vocab: int, rng: np.random.Generator, s: float = 1.05) -> np.ndarray:
    """Zipf-ish ids over [0, vocab), as bench.py's synth_corpus draws them."""
    w = 1.0 / np.arange(1, vocab + 1, dtype=np.float64) ** s
    cdf = np.cumsum(w) / w.sum()
    return np.minimum(np.searchsorted(cdf, rng.random(n)), vocab - 1).astype(np.int32)


# ---------------------------------------------------------------- phases ---


def phase_env() -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    smi_line = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else ""
    name = torch.cuda.get_device_name(0)
    env = {"device": name, "count": torch.cuda.device_count(),
           "nvidia_smi": smi_line, "torch": torch.__version__,
           "cuda": torch.version.cuda, "mem_rate_Bps": mem_rate(name),
           "f32_rate_flops": f32_rate(name),
           "tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
           "tf32_cudnn": torch.backends.cudnn.allow_tf32}
    emit("env", **env)
    return env


def phase_build() -> None:
    from swiftsnails_tpu_torch.ops import _build

    t0 = time.monotonic()
    results = _build.build_all(["rowdma", "fused_sgns", "fused_sgns_merged", "sem_probe"])
    for name, result in results.items():
        ptxas = [ln.strip() for ln in result["log"].splitlines()
                 if "registers" in ln or "spill" in ln]
        emit("build", seconds=result["seconds"], source=f"{name}.cu",
             cached=result["cached"], ptxas=ptxas)
    emit("build", seconds=time.monotonic() - t0, source="all")


def _gather_case(table, rows_sets, rate):
    from swiftsnails_tpu_torch.ops import rowdma
    from swiftsnails_tpu_torch.utils.metrics import time_ms

    rows = rows_sets[0]
    got = rowdma.gather_rows(table, rows)
    want = rowdma.gather_rows_plain(table, rows)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"gather_rows differs from its plain version: {err}")
    row_bytes = table.stride(0) * table.element_size()
    distinct = int(torch.unique(rows).numel())
    nbytes = distinct * row_bytes + rows.numel() * (row_bytes + 4)
    pick = lambda i: rows_sets[i % len(rows_sets)]  # noqa: E731
    kernel = lambda: time_ms(lambda i: rowdma.gather_rows(table, pick(i)))  # noqa: E731
    library = lambda: time_ms(lambda i: torch.index_select(table, 0, pick(i)))  # noqa: E731
    # in turns (kernel, index_select, index_select, kernel): the two are close
    turns = [kernel(), library(), library(), kernel()]
    kernel_ms, library_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    return {
        "kernel_ms": kernel_ms,
        "plain_ms": time_ms(lambda i: rowdma.gather_rows_plain(table, pick(i))),
        "library_ms": library_ms, "turns_ms": turns,
        "over_index_select": kernel_ms / library_ms,
        "bytes": nbytes, "distinct_rows": distinct,
        "bound_ms": nbytes / rate * 1e3, "max_abs_err": err,
    }


def _scatter_case(table, rows_sets, deltas_sets, n_valid, rate):
    from swiftsnails_tpu_torch.ops import rowdma
    from swiftsnails_tpu_torch.utils.metrics import time_ms

    rows, deltas = rows_sets[0], deltas_sets[0]
    want = rowdma.scatter_add_rows_plain(table.clone(), rows, deltas)
    got = rowdma.scatter_add_rows(table.clone(), rows, deltas)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"scatter_add_rows differs from its plain version: {err}")
    del got, want
    row_bytes = table.stride(0) * table.element_size()
    nbytes = n_valid[0] * 3 * row_bytes + rows.numel() * 4
    k = len(rows_sets)
    return {
        "kernel_ms": time_ms(lambda i: rowdma.scatter_add_rows(
            table, rows_sets[i % k], deltas_sets[i % k])),
        "plain_ms": time_ms(lambda i: rowdma.scatter_add_rows_plain(
            table, rows_sets[i % k], deltas_sets[i % k])),
        "library_ms": time_ms(lambda i: table.index_add_(
            0, rows_sets[i % k][: n_valid[i % k]],
            deltas_sets[i % k][: n_valid[i % k]])),
        "bytes": nbytes, "unique_rows": n_valid[0],
        "bound_ms": nbytes / rate * 1e3, "max_abs_err": err,
    }


def phase_kernels(seed: int, rate: float) -> dict:
    """Each kernel at the main path's shapes; returns the f32 out-table
    numbers per kernel for the summary line."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    shape = (VOCAB, -(-DIM // 128), 128)
    base = torch.randn(shape, generator=gen, device=dev)
    n_out = GATHER_ROWS[1]
    scatter = {}  # pushed rows: the unique rows of a zipf draw, padded to n
    for n in GATHER_ROWS:
        sets, n_valid = [], []
        for _ in range(ROW_SETS):
            uniq = torch.unique(torch.from_numpy(zipf_ids(n, VOCAB, rng)).to(dev))
            n_valid.append(int(uniq.numel()))
            pad = torch.full((n - uniq.numel(),), VOCAB, dtype=torch.int32, device=dev)
            sets.append(torch.cat([uniq.to(torch.int32), pad]))
        scatter[n] = (sets, n_valid)
    summary = {}
    for dtype in (torch.float32, torch.bfloat16):
        table = base.to(dtype)
        for n in GATHER_ROWS:
            sets = [torch.from_numpy(zipf_ids(n, VOCAB, rng)).to(dev)
                    for _ in range(ROW_SETS)]
            case = _gather_case(table, sets, rate)
            emit("kernel", name="gather_rows", dtype=str(dtype), rows=n, **case)
            if dtype == torch.float32 and n == n_out:
                summary["gather_rows"] = {"shape": [n, *shape[1:]], **case}
        for n, (sets, n_valid) in scatter.items():
            deltas = [torch.randn((n, *shape[1:]), generator=gen, device=dev)
                      .mul_(1e-3).to(dtype) for _ in range(ROW_SETS)]
            case = _scatter_case(table, sets, deltas, n_valid, rate)
            emit("kernel", name="scatter_add_rows", dtype=str(dtype), rows=n, **case)
            if dtype == torch.float32 and n == n_out:
                summary["scatter_add_rows"] = {"shape": [n, *shape[1:]], **case}
            del deltas
        del table
        torch.cuda.synchronize()
    del base
    torch.cuda.empty_cache()
    return summary


# ---------------------------------------------------------- fused kernels ---


def _block_local(nblocks: int, per_block: int, rng) -> np.ndarray:
    """Ids for ``nblocks`` kernel blocks, block b's drawn zipf-wise from its
    own range of VOCAB / nblocks ids: duplicates within a block (and the
    same head ids in its context and pool slots), none across blocks."""
    span = VOCAB // nblocks
    ids = zipf_ids(nblocks * per_block, span, rng).reshape(nblocks, per_block)
    return (ids + span * np.arange(nblocks)[:, None]).reshape(-1).astype(np.int32)


def _window_mask(n: int, rng) -> np.ndarray:
    """Real slots of ``n`` windows as skipgram_windows draws them (b ~ U(1,
    WINDOW), offsets -b..-1, 1..b), without the corpus edges."""
    offsets = np.concatenate([np.arange(-WINDOW, 0), np.arange(1, WINDOW + 1)])
    b = rng.integers(1, WINDOW + 1, size=n)
    return np.abs(offsets)[None, :] <= b[:, None]


def _fused_ids(kind: str, block_local: bool, rng) -> dict:
    """One step's ids at the main path's shapes, on the card."""
    if kind == "flat":
        nb = BATCH // POOL_BLOCK
        if block_local:
            ids = dict(in_rows=_block_local(nb, POOL_BLOCK, rng),
                       pos_rows=_block_local(nb, POOL_BLOCK, rng))
        else:
            ids = dict(in_rows=zipf_ids(BATCH, VOCAB, rng),
                       pos_rows=zipf_ids(BATCH, VOCAB, rng))
    else:
        nb = GROUPED_BATCH // CENTERS_PER_BLOCK
        if block_local:
            centers = _block_local(nb, CENTERS_PER_BLOCK, rng)
            ctxs = _block_local(nb, CENTERS_PER_BLOCK * CW, rng).reshape(-1, CW)
        else:
            centers = zipf_ids(GROUPED_BATCH, VOCAB, rng)
            ctxs = zipf_ids(GROUPED_BATCH * CW, VOCAB, rng).reshape(-1, CW)
        ctxs[~_window_mask(GROUPED_BATCH, rng)] = -1
        ids = dict(centers=centers, ctxs=ctxs)
    pool = (_block_local(nb, POOL_SIZE, rng) if block_local
            else zipf_ids(nb * POOL_SIZE, VOCAB, rng))
    ids["pool_rows"] = pool
    return {k: torch.from_numpy(np.ascontiguousarray(v)).cuda() for k, v in ids.items()}


def _fused_call(kind: str):
    from swiftsnails_tpu_torch.ops import fused_sgns

    lam = NEGATIVES / POOL_SIZE
    if kind == "flat":
        kw = dict(lr=LR, lam=lam, pairs_per_block=POOL_BLOCK, pool_size=POOL_SIZE)
        return fused_sgns.fused_sgns_step, fused_sgns.fused_sgns_step_plain, kw
    kw = dict(lr=LR, lam=lam, window=WINDOW, centers_per_block=CENTERS_PER_BLOCK,
              pool_size=POOL_SIZE)
    return fused_sgns.fused_sgns_grouped_step, fused_sgns.fused_sgns_grouped_step_plain, kw


def _fused_work(kind: str, ids: dict, row_bytes: int, d: int):
    """Least bytes (each distinct row read once and written once, the ids
    read once) and f32 flops of one step on these ids."""
    if kind == "flat":
        rows_in = ids["in_rows"]
        rows_out = torch.cat([ids["pos_rows"], ids["pool_rows"]])
        pairs, units = BATCH, BATCH  # units: rows that meet the pool
    else:
        real = ids["ctxs"] >= 0
        rows_in = ids["centers"]
        rows_out = torch.cat([ids["ctxs"][real], ids["pool_rows"]])
        pairs, units = int(real.sum()), GROUPED_BATCH
    distinct = int(torch.unique(rows_in).numel()) + int(torch.unique(rows_out).numel())
    id_bytes = 4 * sum(v.numel() for v in ids.values())
    nbytes = 2 * distinct * row_bytes + id_bytes
    # scores, dV and dQ against the pool: 3 products of 2 * PN * d flops a
    # row that meets the pool; the positive term, its two gradients and the
    # updates: ~8 d a real pair
    flops = 6 * units * POOL_SIZE * d + 8 * pairs * d
    return nbytes, flops, distinct, pairs


def _yardstick(kind: str, id_sets, tables):
    """``_substep_packed`` (pull, autograd, merged push) on the same pairs
    and pool: the unfused path that the fused kernel replaces. For grouped,
    the windows' real pairs, cut to a multiple of the 32 pool blocks."""
    from swiftsnails_tpu_torch.data.vocab import Vocab
    from swiftsnails_tpu_torch.models.word2vec import W2VState, Word2VecTrainer
    from swiftsnails_tpu_torch.parallel.store import PackedTableState
    from swiftsnails_tpu_torch.utils.config import Config
    from swiftsnails_tpu_torch.utils.metrics import time_ms

    sets = []
    for ids in id_sets:
        pools = ids["pool_rows"].view(-1, POOL_SIZE)
        if kind == "flat":
            sets.append((ids["in_rows"], ids["pos_rows"], pools))
            continue
        real = ids["ctxs"] >= 0
        centers = ids["centers"].repeat_interleave(real.sum(1))
        sets.append((centers, ids["ctxs"][real], pools))
    nb = sets[0][2].shape[0]
    n = min(s[0].numel() for s in sets) // nb * nb
    sets = [(c[:n].contiguous(), x[:n].contiguous(), p) for c, x, p in sets]
    cfg = Config({"dim": str(DIM), "window": str(WINDOW), "negatives": str(NEGATIVES),
                  "learning_rate": str(LR), "batch_size": str(n),
                  "pool_size": str(POOL_SIZE), "pool_block": str(n // nb),
                  "capacity": str(VOCAB), "subsample": "0"})
    tr = Word2VecTrainer(cfg, corpus_ids=np.zeros(4, np.int32),
                         vocab=Vocab(["a", "b"], np.array([2, 2])))
    state = W2VState(PackedTableState(tables[0], {}), PackedTableState(tables[1], {}))
    gen = torch.Generator(device="cuda")

    def run(i):
        c, x, p = sets[i % len(sets)]
        tr._substep_packed(state, c, x, gen, LR, negs=p)

    return time_ms(run), n


def _host_ms(fn, runs: int = 10) -> float:
    """Median host time of ``fn(i)``: the enqueue, without waiting for the
    card (which is synchronised between runs)."""
    times = []
    for i in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(i)
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def _kernel_only(fn, id_sets, tables, kw, name: str, calls: int = 5) -> tuple:
    """Device time of the CUDA kernel alone (no prep) a call, by
    torch.profiler, and its launches on the card a call (events named
    ``name``). The profiler must see every launch the wrapper's counter
    made, each of which returned success: a window with records lost fails
    the run, since its time would be short too."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    made = fn.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # ~1 ms of spinning first, so that no measured launch starts at the
        # window's edge (the profiler now and then lost the first record of
        # a window that began with one)
        torch.cuda._sleep(2_000_000)
        for i in range(calls):
            fn(*tables, *id_sets[i % len(id_sets)].values(), **kw)
        torch.cuda.synchronize()
    made = fn.launches - made
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and name in e.key]
    seen = sum(e.count for e in events)
    if seen < made:
        raise AssertionError(f"the profiler saw {seen} {name} launches of the {made} that "
                             f"{fn.__name__} made: records lost")
    us = sum(e.self_device_time_total for e in events)
    return us / 1e3 / calls, seen / calls


def _max_err(got, want) -> float:
    return max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))


def _fused_case(kind: str, dtype, base, rng, env) -> dict:
    from swiftsnails_tpu_torch.ops import fused_sgns
    from swiftsnails_tpu_torch.utils.metrics import time_ms

    fn, plain, kw = _fused_call(kind)
    tables = [t.to(dtype, copy=True) for t in base]  # timing updates them
    # block-local ids: the kernel equals its plain version and repeats exactly
    ids = _fused_ids(kind, True, rng)
    want = plain(*[t.clone() for t in tables], *ids.values(), **kw)
    got = [fn(*[t.clone() for t in tables], *ids.values(), **kw) for _ in range(2)]
    torch.cuda.synchronize()
    err = _max_err(got[0], want)
    rtol, atol = (1e-5, 1e-6) if dtype == torch.float32 else (2.0**-7, 1e-6)
    for g, w in zip(got[0], want):
        torch.testing.assert_close(g.float(), w.float(), rtol=rtol, atol=atol)
    if not all(torch.equal(a, b) for a, b in zip(got[0], got[1])):
        raise AssertionError(f"{fn.__name__}: two runs on the card differ")
    if any(t.reshape(t.shape[0], -1)[:, DIM:].any() for t in got[0][:2]):
        raise AssertionError(f"{fn.__name__}: padding lanes changed")
    del want, got
    # zipf ids over the whole vocabulary: blocks share rows and race (hogwild)
    id_sets = [_fused_ids(kind, False, rng) for _ in range(ROW_SETS)]
    want = plain(*[t.clone() for t in tables], *id_sets[0].values(), **kw)
    got = fn(*[t.clone() for t in tables], *id_sets[0].values(), **kw)
    torch.cuda.synchronize()
    if not all(torch.isfinite(t).all() for t in got):
        raise AssertionError(f"{fn.__name__}: non-finite result on zipf ids")
    loss_gap = abs(float(got[2]) - float(want[2])) / abs(float(want[2]))
    if loss_gap > 1e-2:
        raise AssertionError(f"{fn.__name__}: loss {float(got[2])} vs plain "
                             f"{float(want[2])} on zipf ids")
    zipf_err = _max_err(got[:2], want[:2])
    del want, got
    row_bytes = tables[0].stride(0) * tables[0].element_size()
    nbytes, flops, distinct, pairs = _fused_work(kind, id_sets[0], row_bytes,
                                                 tables[0].stride(0))
    bytes_ms = nbytes / env["mem_rate_Bps"] * 1e3
    flops_ms = flops / env["f32_rate_flops"] * 1e3
    pick = lambda i: id_sets[i % len(id_sets)].values()  # noqa: E731
    kernel = "fused_sgns_kernel" if kind == "flat" else "fused_sgns_grouped_kernel"
    grouped = kind == "grouped"
    nb = (GROUPED_BATCH // CENTERS_PER_BLOCK) if grouped else BATCH // POOL_BLOCK
    plan = fused_sgns.cluster_plan(grouped, nb, CENTERS_PER_BLOCK if grouped else POOL_BLOCK,
                                   CW if grouped else 0, POOL_SIZE, tables[0])
    case = {
        "ms": time_ms(lambda i: fn(*tables, *pick(i), **kw)),
        **dict(zip(("kernel_only_ms", "card_launches_per_substep"), _kernel_only(
            fn, id_sets, tables, kw, kernel))),
        "host_ms": _host_ms(lambda i: fn(*tables, *pick(i), **kw)),
        "plain_ms": time_ms(lambda i: plain(*tables, *pick(i), **kw), runs=5),
        "cluster": plan["cluster"], "ctas": plan["ctas"],
        "max_active_clusters": plan["max_active_clusters"],
        "active_by_cluster": plan["active_by_cluster"], "tile": plan["tile"],
        "ring": plan["ring"], "smem_bytes": plan["smem_bytes"],
        "max_abs_err": err, "zipf_loss_gap": loss_gap, "zipf_max_abs_diff": zipf_err,
        "bytes": nbytes, "flops": flops, "distinct_rows": distinct, "real_pairs": pairs,
        "bytes_ms": bytes_ms, "flops_ms": flops_ms, "bound_ms": max(bytes_ms, flops_ms),
        "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
    }
    if case["card_launches_per_substep"] != 1:
        raise AssertionError(f"{fn.__name__}: {case['card_launches_per_substep']} launches "
                             "a substep on the card, want 1")
    if dtype == torch.float32:
        case["yardstick_ms"], case["yardstick_pairs"] = _yardstick(kind, id_sets, tables)
    return case


def _merged_run(fn, plain, tables, ids, kw, rtol, atol):
    """Two kernel runs and the plain version on ``ids``: raises unless the
    runs are bit-identical and keep the padding lanes zero; returns the
    largest difference from the plain version, the count of elements
    outside ``rtol`` / ``atol`` of it, and the two losses."""
    want = plain(*[t.clone() for t in tables], *ids.values(), **kw)
    got = [fn(*[t.clone() for t in tables], *ids.values(), **kw) for _ in range(2)]
    torch.cuda.synchronize()
    name = fn.__name__
    if not all(torch.equal(a, b) for a, b in zip(got[0], got[1])):
        raise AssertionError(f"{name}: two runs on the card differ")
    if any(t.reshape(t.shape[0], -1)[:, DIM:].any() for t in got[0][:2]):
        raise AssertionError(f"{name}: padding lanes changed")
    if not all(torch.isfinite(t).all() for t in got[0]):
        raise AssertionError(f"{name}: non-finite result")
    outside = sum(int((g.float() - w.float()).abs().gt(atol + rtol * w.float().abs()).sum())
                  for g, w in zip(got[0][:2], want[:2]))
    return _max_err(got[0], want), outside, float(got[0][2]), float(want[2])


def _merged_case(name: str, dtype, base, rng, env, grouped: dict) -> dict:
    """A merged kernel at the main shape. Its blocks run in order, so on zipf
    ids over the whole vocabulary it equals its plain version in f32 within
    rtol 1e-5 / atol 1e-6 and repeats bit for bit. In bf16 a row that several
    blocks write passes through one bf16 rounding a block, and the kernel's
    f32 values differ from the plain version's in the last bits, so a
    rounding can flip and the flip carries into the next block: one bf16
    rounding is held on block-local ids (each row written by one block), and
    on zipf ids the elements beyond it are counted. One launch a substep on
    the card (the profiler's count); its time alone is put beside the
    grouped kernel's alone, ``grouped`` (this call, same dtype)."""
    from swiftsnails_tpu_torch.ops import fused_sgns
    from swiftsnails_tpu_torch.utils.metrics import time_ms

    fn, plain = getattr(fused_sgns, name), getattr(fused_sgns, name + "_plain")
    kw = {**_fused_call("grouped")[2], **MERGED[name]}
    tables = [t.to(dtype, copy=True) for t in base]  # timing updates them
    id_sets = [_fused_ids("grouped", False, rng) for _ in range(ROW_SETS)]
    f32 = dtype == torch.float32
    rtol, atol = (1e-5, 1e-6) if f32 else (2.0**-7, 1e-6)
    exact_ids = id_sets[0] if f32 else _fused_ids("grouped", True, rng)
    err, outside, _, _ = _merged_run(fn, plain, tables, exact_ids, kw, rtol, atol)
    if outside:
        raise AssertionError(f"{name} ({dtype}): {outside} elements outside rtol {rtol} / "
                             f"atol {atol} of the plain version (largest {err})")
    case = {"max_abs_err": err, "exact_ids": "zipf" if f32 else "block-local"}
    if not f32:
        zerr, zout, loss, want_loss = _merged_run(fn, plain, tables, id_sets[0], kw, rtol, atol)
        case.update(zipf_max_abs_diff=zerr, zipf_beyond_one_rounding=zout,
                    zipf_loss_gap=abs(loss - want_loss) / abs(want_loss))
    row_bytes = tables[0].stride(0) * tables[0].element_size()
    nbytes, flops, distinct, pairs = _fused_work("grouped", id_sets[0], row_bytes,
                                                 tables[0].stride(0))
    bytes_ms = nbytes / env["mem_rate_Bps"] * 1e3
    flops_ms = flops / env["f32_rate_flops"] * 1e3
    pick = lambda i: id_sets[i % len(id_sets)].values()  # noqa: E731
    hot_n = fused_sgns.effective_hot_rows(kw.get("hot_rows", 0), VOCAB)[0]
    prep = lambda i: fused_sgns.merged_prep(  # noqa: E731
        *pick(i), CENTERS_PER_BLOCK, POOL_SIZE, hot_n, kw.get("u_cap", 0), VOCAB)
    case.update({
        "ms": time_ms(lambda i: fn(*tables, *pick(i), **kw)),
        **dict(zip(("kernel_only_ms", "card_launches_per_substep"),
                   _kernel_only(fn, id_sets, tables, kw, "merged_"))),
        "prep_ms": time_ms(prep),
        "host_ms": _host_ms(lambda i: fn(*tables, *pick(i), **kw)),
        "plain_ms": time_ms(lambda i: plain(*tables, *pick(i), **kw), runs=5),
        "bytes": nbytes, "flops": flops, "distinct_rows": distinct,
        "real_pairs": pairs, "bytes_ms": bytes_ms, "flops_ms": flops_ms,
        "bound_ms": max(bytes_ms, flops_ms),
        "bound_by": "bytes" if bytes_ms >= flops_ms else "operations", **MERGED[name],
    })
    if case["card_launches_per_substep"] != 1:
        raise AssertionError(f"{name}: {case['card_launches_per_substep']} launches a "
                             "substep on the card, want 1")
    case["grouped_kernel_only_ms"] = grouped["kernel_only_ms"]
    case["kernel_only_over_grouped"] = case["kernel_only_ms"] / grouped["kernel_only_ms"]
    if f32:
        case["yardstick_ms"], case["yardstick_pairs"] = _yardstick("grouped", id_sets, tables)
    return case


def phase_fused_kernels(seed: int, env: dict) -> dict:
    """Each fused kernel at the main path's shapes; returns the f32 numbers
    per kernel for the summary line."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed + 7)
    gen = torch.Generator(device=dev).manual_seed(seed + 7)
    shape = (VOCAB, -(-DIM // 128), 128)
    lanes = (torch.arange(shape[1] * 128, device=dev) < DIM).view(shape[1:])
    base = [torch.randn(shape, generator=gen, device=dev).mul_(0.1).mul_(lanes)
            for _ in range(2)]
    summary, grouped = {}, {}
    for kind, name in (("flat", "fused_sgns_step"), ("grouped", "fused_sgns_grouped_step")):
        for dtype in (torch.float32, torch.bfloat16):
            case = _fused_case(kind, dtype, base, rng, env)
            emit("kernel", name=name, dtype=str(dtype), **case)
            if dtype == torch.float32:
                summary[name] = case
            if kind == "grouped":
                grouped[dtype] = case
            torch.cuda.empty_cache()
    for name in MERGED:
        for dtype in (torch.float32, torch.bfloat16):
            case = _merged_case(name, dtype, base, rng, env, grouped[dtype])
            emit("kernel", name=name, dtype=str(dtype), **case)
            if dtype == torch.float32:
                summary[name] = case
            torch.cuda.empty_cache()
    del base
    torch.cuda.empty_cache()
    return summary


def _small_trainer(device, seed, **over):
    from swiftsnails_tpu_torch.data.vocab import Vocab
    from swiftsnails_tpu_torch.models.word2vec import Word2VecTrainer
    from swiftsnails_tpu_torch.utils.config import Config

    v = 4096
    rng = np.random.default_rng(seed)
    ids = zipf_ids(60_000, v, rng)
    counts = np.maximum(np.bincount(ids, minlength=v), 1)
    cfg = Config({"dim": str(DIM), "window": str(WINDOW),
                  "negatives": str(NEGATIVES), "learning_rate": str(LR),
                  "batch_size": "2048", "subsample": "0", "pool_size": str(POOL_SIZE),
                  "pool_block": str(POOL_BLOCK), "seed": str(seed),
                  **{k: str(v) for k, v in over.items()}})
    return Word2VecTrainer(cfg, corpus_ids=ids, vocab=Vocab(
        [f"w{i}" for i in range(v)], counts), device=device)


# path -> (config keys, substep method). The hogwild paths run one kernel
# block a substep here: the card runs their blocks concurrently, the CPU in
# order, and the two agree only where no block races another. The merged
# paths run their blocks in order on both: 8 kernel blocks a substep.
_GROUPED = {"fused": 1, "grouped": 1, "centers_per_block": CENTERS_PER_BLOCK}
PATHS = {
    "packed": ({}, "_substep_packed"),
    "fused": ({"fused": 1, "batch_size": POOL_BLOCK}, "_substep_fused"),
    "grouped": ({**_GROUPED, "batch_size": CENTERS_PER_BLOCK}, "_substep_grouped"),
    "resident": ({**_GROUPED, "resident": 1, "hot_rows": COMPOSED_HOT_ROWS},
                 "_substep_grouped"),
    "dedup": ({**_GROUPED, "dedup": 1, "u_cap": U_CAP}, "_substep_grouped"),
    "dedup_res": ({**_GROUPED, "dedup": 1, "u_cap": U_CAP, "resident": 1,
                   "hot_rows": COMPOSED_HOT_ROWS}, "_substep_grouped"),
    # per-pair negatives ([b, K] word ids injected): the 2-D plane, and the
    # packed tables through gather_rows / scatter_add_rows
    "dense": ({"packed": 0}, "_substep_dense"),
    "perpair": ({"neg_mode": "per_pair"}, "_substep_packed_perpair"),
}
PER_PAIR = ("dense", "perpair")


def phase_slice_parity(seed: int, path: str) -> None:
    from swiftsnails_tpu_torch import convert

    over, method = PATHS[path]
    cpu = _small_trainer("cpu", seed, **over)
    cuda = _small_trainer("cuda", seed, **over)
    init = cpu.init_state()
    tables = [t.table.numpy().copy() for t in init]
    batches = [b for _, b in zip(range(4), cpu.batches())]
    rng = np.random.default_rng(seed + 1)
    n = batches[0]["centers"].shape[0]
    nb = n // cpu._effective_pc(n) if cpu.grouped else cpu.pool_geometry(n)[1]
    shape = (n, NEGATIVES) if path in PER_PAIR else (nb, POOL_SIZE)
    pools = [rng.integers(0, 4096, shape).astype(np.int32) for _ in batches]

    def run(tr, device):
        state = convert.w2v_state_from_numpy(*tables, device=device)
        gen = torch.Generator(device=device)
        losses = []
        for batch, pool in zip(batches, pools):
            state, loss = getattr(tr, method)(
                state, torch.from_numpy(batch["centers"]).to(device),
                torch.from_numpy(batch["contexts"]).to(device), gen, tr.lr,
                negs=torch.from_numpy(pool).to(device))
            losses.append(float(loss))
        return state, losses

    s_cpu, l_cpu = run(cpu, "cpu")
    s_gpu, l_gpu = run(cuda, "cuda")
    s_gpu2, l_gpu2 = run(cuda, "cuda")
    worst = 0.0
    for a, b, c in zip(s_cpu, s_gpu, s_gpu2):
        ga, gb = a.table.numpy(), b.table.cpu().numpy()
        np.testing.assert_allclose(gb, ga, rtol=1e-5, atol=1e-6)
        worst = max(worst, float(np.abs(gb - ga).max()))
        if not torch.equal(b.table, c.table):
            raise AssertionError("two runs on the card differ")
        if b.table.reshape(b.capacity, -1)[:, DIM:].any():
            raise AssertionError("padding lanes changed")
    np.testing.assert_allclose(l_gpu, l_cpu, rtol=1e-5, atol=1e-6)
    if l_gpu != l_gpu2:
        raise AssertionError("losses of two runs on the card differ")
    emit("slice_parity", path=path, substeps=len(batches), batch=n,
         kernel_blocks=None if path in PER_PAIR else nb,
         table=list(s_gpu[0].table.shape), max_abs_err_vs_cpu=worst, losses_cuda=l_gpu, losses_cpu=l_cpu,
         repeat_bit_identical=True)


def _corpus(seed: int, paired: bool = False):
    """A train phase's corpus: N_TOKENS ids over VOCAB, its vocab, and
    skip-gram pairs per token (6.00 at window 5) counted on its first 2^20
    by the native producer, which makes the phases' batches. Zipf ids, or
    with ``paired`` zipf-distributed pairs (2p, 2p + 1)."""
    from swiftsnails_tpu_torch.data import native
    from swiftsnails_tpu_torch.data.vocab import Vocab

    rng = np.random.default_rng(seed)
    if paired:
        p = zipf_ids(N_TOKENS // 2, VOCAB // 2, rng)
        ids = np.stack([2 * p, 2 * p + 1], 1).reshape(-1).astype(np.int32)
    else:
        ids = zipf_ids(N_TOKENS, VOCAB, rng)
    counts = np.maximum(np.bincount(ids, minlength=VOCAB), 1)
    vocab = Vocab([f"w{i}" for i in range(VOCAB)], counts)
    pairs, _ = native.skipgram_pairs(ids[: 1 << 20], WINDOW, seed=seed)
    return ids, vocab, len(pairs) / (1 << 20)


def _counters() -> dict:
    from swiftsnails_tpu_torch.ops import fused_sgns, rowdma, sem_probe

    return {f.__name__: f for f in (rowdma.gather_rows, rowdma.scatter_add_rows,
                                     rowdma.scatter_write_rows, rowdma.scatter_adagrad_rows,
                                     rowdma.scatter_adagrad_fused_rows,
                                     fused_sgns.fused_sgns_step,
                                     fused_sgns.fused_sgns_grouped_step,
                                     *(getattr(fused_sgns, name) for name in MERGED),
                                     sem_probe.unit_probe, sem_probe.chunk_probe,
                                     sem_probe.pipe_probe)}


# train phase -> (config keys, launches a substep of each kernel, paired
# corpus); every phase at vocab 2^20, dim 200, window 5, 5 negatives, pool 64
_FUSED = {"learning_rate": FUSED_LR, "steps_per_call": FUSED_STEPS_PER_CALL,
          "fused": 1}
HOGWILD_TRAIN = ("train_fused", "train_grouped")
TRAIN = {
    "train": ({"learning_rate": LR, "batch_size": BATCH},
              {"gather_rows": 2, "scatter_add_rows": 2}, False),
    "train_fused": ({**_FUSED, "batch_size": BATCH}, {"fused_sgns_step": 1}, True),
    "train_grouped": ({**_FUSED, "grouped": 1, "batch_size": GROUPED_BATCH,
                       "centers_per_block": CENTERS_PER_BLOCK},
                      {"fused_sgns_grouped_step": 1}, True),
}
# packed: 0 (two [1,048,576, 200] f32 tables, 1.68 GB) and neg_mode:
# per_pair (two [1,048,576, 2, 128], 2.15 GB): K = 5 independent negatives
# a pair, the packed+pool phase's batch, lr and corpus
TRAIN["train_dense"] = ({"learning_rate": LR, "batch_size": BATCH, "packed": 0}, {}, False)
TRAIN["train_perpair"] = ({"learning_rate": LR, "batch_size": BATCH, "neg_mode": "per_pair"},
                          {"gather_rows": 2, "scatter_add_rows": 2}, False)
_MERGED_TRAIN = {**_FUSED, "grouped": 1, "batch_size": GROUPED_BATCH,
                 "centers_per_block": CENTERS_PER_BLOCK}
for _phase, _keys, _kernel in (
        ("train_resident", {"resident": 1, "hot_rows": HOT_ROWS}, "fused_sgns_resident_step"),
        ("train_dedup", {"dedup": 1, "u_cap": U_CAP}, "fused_sgns_dedup_step"),
        ("train_dedup_res", {"dedup": 1, "u_cap": U_CAP, "resident": 1,
                             "hot_rows": COMPOSED_HOT_ROWS}, "fused_sgns_dedup_resident_step")):
    TRAIN[_phase] = ({**_MERGED_TRAIN, **_keys, "learning_rate": MERGED_LR[_phase]},
                     {_kernel: 1}, True)


def _train_loop(phase: str, seed: int, corpora, **extra):
    """A train phase's trainer and loop (``extra`` config keys on top), and
    the list its records go to."""
    from swiftsnails_tpu_torch.framework.trainer import TrainLoop
    from swiftsnails_tpu_torch.models.word2vec import Word2VecTrainer
    from swiftsnails_tpu_torch.utils.config import Config
    from swiftsnails_tpu_torch.utils.metrics import MetricsLogger

    over, _, paired = TRAIN[phase]
    ids, vocab, _ = corpora[paired]
    cfg = Config({"dim": str(DIM), "window": str(WINDOW),
                  "negatives": str(NEGATIVES), "subsample": "0", "num_iters": "1",
                  "pool_size": str(POOL_SIZE), "pool_block": str(POOL_BLOCK),
                  "table_dtype": "float32", "seed": str(seed),
                  **{k: str(v) for k, v in {**over, **extra}.items()}})
    trainer = Word2VecTrainer(cfg, corpus_ids=ids, vocab=vocab)
    records = []

    class Recorder(MetricsLogger):
        def log(self, record):
            records.append(record)

    return trainer, TrainLoop(trainer, metrics=Recorder(), log_every=1), records


def _plain_in_order_losses(phase: str, seed: int, corpora) -> list:
    """The losses of ``phase`` (fused-hogwild or fused-grouped) with its
    kernel replaced by the plain version, whose blocks run in order as the
    TPU kernel's do: the same seed, batches and lr."""
    from swiftsnails_tpu_torch.models import word2vec
    from swiftsnails_tpu_torch.ops import fused_sgns

    trainer, loop, records = _train_loop(phase, seed, corpora)
    kernel = word2vec.fused_sgns_step
    word2vec.fused_sgns_step = fused_sgns.fused_sgns_step_plain
    if trainer.grouped:
        trainer.grouped_step = (fused_sgns.fused_sgns_grouped_step_plain, {})
    try:
        loop.run(seed=seed, max_steps=STEPS)
    finally:
        word2vec.fused_sgns_step = kernel
    return [r["loss"] for r in records]


def _fall(losses) -> float:
    return float(np.mean(losses[:5]) - np.mean(losses[-5:]))


def phase_train(phase: str, seed: int, corpora, device_name: str, smi: str):
    _, per_substep, paired = TRAIN[phase]
    pairs_per_token = corpora[paired][2]
    t0 = time.monotonic()
    trainer, loop, records = _train_loop(phase, seed, corpora)
    setup_s = time.monotonic() - t0
    torch.cuda.reset_peak_memory_stats()
    state, launches = _run_counted(lambda: loop.run(seed=seed, max_steps=STEPS))
    substeps = len(records) * trainer.steps_per_call
    _check_launches(phase, launches, {k: n * substeps for k, n in per_substep.items()})
    losses = [r["loss"] for r in records]
    if len(losses) != STEPS or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"losses: {losses}")
    if not np.mean(losses[-5:]) < np.mean(losses[:5]):
        raise AssertionError(f"loss did not fall: {losses}")
    for t in state:
        if not torch.isfinite(t.table).all():
            raise AssertionError("non-finite table")
    steady = records[5:]  # past the first chunk's pair generation and warm-up
    items = sum(r["items"] for r in steady)
    seconds = sum(r["seconds"] for r in steady)
    step_ms = [r["seconds"] * 1e3 for r in steady]
    # a flat batch counts pairs, a grouped one words (corpus positions)
    words = items if trainer.grouped else items / pairs_per_token
    out = {"steps": len(records), "substeps": substeps,
           "producer": records[0].get("producer"),
           "table": list(state.in_table.table.shape),
           "batch": trainer.batch_size, "steps_per_call": trainer.steps_per_call,
           "lr": trainer.lr, "corpus": "paired" if paired else "zipf",
           "launches": launches, "setup_s": setup_s,
           "first_step_ms": records[0]["seconds"] * 1e3,
           "step_ms_median": statistics.median(step_ms),
           "items_per_sec": items / seconds, "words_per_sec": words / seconds,
           "pairs_per_token": pairs_per_token,
           "loss_first5": losses[:5], "loss_last5": losses[-5:],
           "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           "device": device_name, "nvidia_smi": smi}
    if phase in HOGWILD_TRAIN:
        plain = _plain_in_order_losses(phase, seed, corpora)
        fall, plain_fall = _fall(losses), _fall(plain)
        out["plain_in_order"] = {"loss_first5": plain[:5], "loss_last5": plain[-5:],
                                 "fall": plain_fall, "kernel_fall": fall,
                                 "fall_share": fall / plain_fall if plain_fall else None,
                                 "limit": HOGWILD_FALL_SHARE}
    emit(phase, **out)
    if phase in HOGWILD_TRAIN:
        ref = out["plain_in_order"]
        if not ref["fall"] > 0 or ref["fall_share"] < HOGWILD_FALL_SHARE:
            raise AssertionError(f"{phase}: the loss fell {ref['kernel_fall']}, "
                                 f"{ref['fall_share']} of the plain version's {ref['fall']} "
                                 f"(blocks in order), below {HOGWILD_FALL_SHARE}")
    return out, trainer, state


def phase_profile(path: str, trainer, state, seed: int, steps: int = 5) -> None:
    """Device time by kernel over ``steps`` more train steps, by
    ``torch.profiler``, and the card's busy share of their wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from swiftsnails_tpu_torch.framework.trainer import step_generator

    dev = torch.device("cuda")
    it = iter(trainer.batches())
    batches = [{k: torch.from_numpy(v).to(dev) if np.ndim(v) else v
                for k, v in next(it).items()} for _ in range(steps + 1)]
    it.close()  # stops the native producer's threads
    trainer.train_step(state, batches[0], step_generator(seed, 0, dev))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i, batch in enumerate(batches[1:]):
            trainer.train_step(state, batch, step_generator(seed, i + 1, dev))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = sorted(((e.key, e.self_device_time_total / 1e3 / steps, e.count // steps)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                     key=lambda k: -k[1])
    busy_ms = sum(ms for _, ms, _ in kernels)
    emit("profile", path=path, steps=steps,
         substeps_per_step=getattr(trainer, "steps_per_call", 1),
         wall_ms_per_step=wall_ms / steps,
         device_ms_per_step=busy_ms, device_busy_share=busy_ms * steps / wall_ms,
         kernels_per_step=sum(n for _, _, n in kernels),
         top=[{"kernel": k[:90], "ms_per_step": ms, "launches_per_step": n}
              for k, ms, n in kernels[:14]])


# ------------------------------------------------------------------ CTR ---


def _widedeep_config(seed: int):
    from swiftsnails_tpu_torch.utils.config import load_config

    cfg = load_config(Path(__file__).resolve().parent / WIDEDEEP_CONF)
    cfg.set("seed", str(seed))
    return cfg


def _ctr_data(seed: int, fields: int = 0):
    """synth_ctr records at Wide & Deep's width (or ``fields`` fields):
    ``CTR_STEPS`` batches to train on, then ``CTR_EVAL`` held out (the same
    planted weights)."""
    from swiftsnails_tpu_torch.data.ctr import synth_ctr

    cfg = _widedeep_config(seed)
    n = CTR_STEPS * cfg.get_int("batch_size")
    labels, feats, _ = synth_ctr(n + CTR_EVAL, fields or cfg.get_int("num_fields"),
                                 CTR_IDS_PER_FIELD, seed=seed)
    return (labels[:n], feats[:n]), (labels[n:], feats[n:])


def _push_case(kernel, plain, buffers, sets, library, nbytes, n_valid, rate):
    """``kernel`` and ``plain`` (each ``(buffers, uniq, values) -> updated
    buffers``) on the first id set: bit-equal, and two kernel runs
    bit-identical; then both timed on the sets in rotation, beside
    ``library`` where one torch call computes the same function."""
    from swiftsnails_tpu_torch.utils.metrics import time_ms

    uniq, vals = sets[0][:2]
    want = plain([b.clone() for b in buffers], uniq, vals)
    got = [kernel([b.clone() for b in buffers], uniq, vals) for _ in range(2)]
    torch.cuda.synchronize()
    err = _max_err(got[0], want)
    for g, w in zip(got[0], want):
        if not torch.equal(g, w):
            ulps = float(((g.float() - w.float()).abs()
                          / (w.float().abs() * torch.finfo(w.dtype).eps)).nan_to_num().max())
            raise AssertionError(f"differs from its plain version: {err} ({ulps} ulps)")
    if not all(torch.equal(a, b) for a, b in zip(*got)):
        raise AssertionError("two runs on the card differ")
    del want, got
    pick = lambda i: sets[i % len(sets)]  # noqa: E731
    return {
        "ms": time_ms(lambda i: kernel(buffers, *pick(i)[:2])),
        "plain_ms": time_ms(lambda i: plain(buffers, *pick(i)[:2])),
        "library_ms": time_ms(lambda i: library(buffers, pick(i))) if library else None,
        "bytes": nbytes, "unique_rows": n_valid, "ids": int(uniq.numel()),
        "bound_ms": nbytes / rate * 1e3, "max_abs_err": err,
    }


def phase_ctr_kernels(seed: int, rate: float) -> dict:
    """The Wide & Deep step's row kernels at its shapes, from the trainer's
    first batches (212,992 ids each, hashed): the pull's ``gather_rows`` of
    every id's tile from the ``[262,144, 2, 128]`` slot-fused table, and the
    three push kernels on the same ids merged by tile (the tail padding
    kept) with merged random gradients, on the slot-fused table
    (``scatter_adagrad_fused_rows``) and on ``[262,144, 1, 128]`` and its
    accumulator (``scatter_adagrad_rows``, ``scatter_write_rows``), in f32
    and bf16. Returns the f32 numbers per kernel for the summary line, the
    pull's under ``gather_rows_widedeep``."""
    from swiftsnails_tpu_torch.data.ctr import ctr_batches
    from swiftsnails_tpu_torch.ops import rowdma
    from swiftsnails_tpu_torch.ops.hashing import hash_row
    from swiftsnails_tpu_torch.parallel.store import merge_small_rows, small_group

    dev = torch.device("cuda")
    cfg = _widedeep_config(seed)
    dim, cap = 1 + cfg.get_int("embed_dim"), cfg.get_int("capacity")
    lr = cfg.get_float("learning_rate")
    g = small_group(dim)
    tiles = cap // g
    (labels, feats), _ = _ctr_data(seed)
    gen = torch.Generator(device=dev).manual_seed(seed + 11)
    batches = ctr_batches(labels, feats, cfg.get_int("batch_size"),
                          np.random.default_rng(seed))  # the trainer's first batches
    merged_sets, tile_sets = [], []
    for _, b in zip(range(CTR_ROW_SETS), batches):
        rows = hash_row(torch.from_numpy(b["feats"]).to(dev).clamp_min(0), cap).reshape(-1)
        tile_sets.append(rows // g)  # the pull's ids, as pull_packed_small makes them
        grads = torch.randn(rows.shape[0], dim, generator=gen, device=dev).mul_(0.01)
        uniq, merged = merge_small_rows(rows, grads, dim, tiles)
        n_valid = int((uniq < tiles).sum())
        merged_sets.append((uniq, merged, uniq[:n_valid].long(), n_valid))
    live = (torch.arange(128, device=dev) % (128 // g)) < dim
    param = torch.randn(tiles, 1, 128, generator=gen, device=dev).mul_(0.01).mul_(live)
    accum = torch.rand(tiles, 1, 128, generator=gen, device=dev).mul_(0.1).mul_(live)
    n_valid, n_ids = merged_sets[0][3], merged_sets[0][0].numel()
    summary = {}
    for dtype in (torch.float32, torch.bfloat16):
        half = 128 * torch.finfo(dtype).bits // 8  # bytes of one sublane
        sets = [(u, m.to(dtype), idx, nv) for u, m, idx, nv in merged_sets]
        # param and accum read and written, the gradient read: 5 sublanes a
        # unique tile; the write: a value read and a row written
        adagrad_bytes = n_valid * 5 * half + n_ids * 4
        write_bytes = n_valid * 2 * half + n_ids * 4
        fused = torch.cat([param, accum], dim=1).to(dtype)
        pull = _gather_case(fused, tile_sets, rate)
        if not torch.equal(*(rowdma.gather_rows(fused, tile_sets[0]) for _ in range(2))):
            raise AssertionError("gather_rows: two runs on the card differ")
        emit("kernel", name="gather_rows", dtype=str(dtype), path="train_widedeep",
             rows=int(tile_sets[0].numel()), **pull)
        if dtype == torch.float32:
            summary["gather_rows_widedeep"] = {"shape": [int(tile_sets[0].numel()),
                                                         *fused.shape[1:]], **pull}
        cases = {
            "scatter_adagrad_fused_rows": (
                lambda b, u, v: (rowdma.scatter_adagrad_fused_rows(b[0], u, v, lr),),
                lambda b, u, v: (rowdma.scatter_adagrad_fused_rows_plain(b[0], u, v, lr),),
                [fused], None, adagrad_bytes),
            "scatter_adagrad_rows": (
                lambda b, u, v: rowdma.scatter_adagrad_rows(b[0], b[1], u, v, lr),
                lambda b, u, v: rowdma.scatter_adagrad_rows_plain(b[0], b[1], u, v, lr),
                [param.to(dtype), accum.to(dtype)], None, adagrad_bytes),
            "scatter_write_rows": (
                lambda b, u, v: (rowdma.scatter_write_rows(b[0], u, v),),
                lambda b, u, v: (rowdma.scatter_write_rows_plain(b[0], u, v),),
                [param.to(dtype)],
                lambda b, st: b[0].index_copy_(0, st[2], st[1][: st[3]]), write_bytes),
        }
        for name, (kernel, plain, buffers, library, nbytes) in cases.items():
            case = _push_case(kernel, plain, buffers, sets, library, nbytes, n_valid, rate)
            emit("kernel", name=name, dtype=str(dtype), **case)
            if dtype == torch.float32:
                summary[name] = {"shape": list(buffers[0].shape), **case}
            del buffers
        del fused, sets
        torch.cuda.empty_cache()
    return summary


def _ctr_trainer(case: str, device: str, seed: int):
    from swiftsnails_tpu_torch.data.ctr import PAD, synth_ctr
    from swiftsnails_tpu_torch.models.registry import get_model
    from swiftsnails_tpu_torch.utils.config import Config

    name, over = CTR_PARITY[case]
    labels, feats, _ = synth_ctr(4 * 1024, 8, 1000, seed=seed)
    feats[::5, 3] = PAD  # padding fields, masked out of forward and push
    conf = {"num_fields": "8", "capacity": str(1 << 14), "learning_rate": "0.2",
            "optimizer": "adagrad", "batch_size": "1024", "seed": str(seed),
            **{k: str(v) for k, v in over.items()}}
    return get_model(name)(Config(conf), data=(labels, feats), device=device)


def _assert_moves_close(start: dict, got: dict, want: dict) -> float:
    """Each array's change on the card within 1e-4 of the largest change of
    the CPU's (the CPU tests' tolerance); returns the largest gap. A change
    must be above 1e-4, but a slot's (an AdaGrad accumulator of the 2-D
    plane adds squares of gradients of order 1e-3) only above 0."""
    worst = 0.0
    for k, w in want.items():
        moved = w - start[k]
        scale = float(np.abs(moved).max())
        if not scale > (0.0 if k.startswith("slot.") else 1e-4):
            raise AssertionError(f"{k} barely moved: {scale}")
        np.testing.assert_allclose(got[k] - start[k], moved, rtol=0, atol=1e-4 * scale,
                                   err_msg=k)
        worst = max(worst, float(np.abs(got[k] - w).max()))
    return worst


def _run_counted(fn) -> tuple:
    """``fn()`` with every launch counter set to 0 just before and read just
    after; returns its result and the counts."""
    counters = _counters()
    for f in counters.values():
        f.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {name: f.launches for name, f in counters.items()}


def _check_launches(what: str, launches: dict, want: dict) -> None:
    for name, n in launches.items():
        if n != want.get(name, 0):
            raise AssertionError(f"{what}: {name}: {n} launches, want {want.get(name, 0)}")


def phase_ctr_parity(seed: int) -> None:
    """4 steps of each CTR family on the card against the port on the CPU
    from one state."""
    from swiftsnails_tpu_torch import convert

    for case in CTR_PARITY:
        cpu = _ctr_trainer(case, "cpu", seed)
        gpu = _ctr_trainer(case, "cuda", seed)
        init = cpu.init_state()
        table = init.table.table.numpy().copy()
        slots = {k: v.numpy().copy() for k, v in init.table.slots.items()}
        dense = {k: v.numpy().copy() for k, v in init.dense.items()}
        sums = ({k: v.numpy().copy() for k, v in init.opt["sum_of_squares"].items()}
                if init.opt else None)
        batches = [b for _, b in zip(range(4), cpu.batches())]

        def run(tr, device):
            state = convert.ctr_state_from_numpy(table, dense, sums, device=device,
                                                 table_slots=slots)
            losses = []
            for b in batches:
                state, m = tr.train_step(state, {k: torch.from_numpy(v).to(device)
                                                 for k, v in b.items()})
                losses.append(float(m["loss"]))
            return state, losses

        s_cpu, l_cpu = run(cpu, "cpu")
        (s_gpu, l_gpu), launches = _run_counted(lambda: run(gpu, "cuda"))
        push = ("scatter_adagrad_fused_rows" if sums is not None else "scatter_add_rows")
        # the 2-D plane is index_select and index_put_: no kernel of the port
        _check_launches(case, launches, {"gather_rows": 4, push: 4} if cpu.packed else {})
        np.testing.assert_allclose(l_gpu, l_cpu, rtol=1e-5)
        start = {"table": table, **{f"slot.{k}": v for k, v in slots.items()},
                 **{f"dense.{k}": v for k, v in dense.items()}}

        def arrays(state):
            return {"table": state.table.table.cpu().numpy(),
                    **{f"slot.{k}": v.cpu().numpy() for k, v in state.table.slots.items()},
                    **{f"dense.{k}": v.cpu().numpy() for k, v in state.dense.items()}}

        worst = _assert_moves_close(start, arrays(s_gpu), arrays(s_cpu))
        emit("ctr_parity", case=case, table=list(table.shape), table_dim=cpu.table_dim,
             plane="packed_small" if cpu.packed else "2-D",
             steps=len(batches), launches={k: n for k, n in launches.items() if n},
             losses_cuda=l_gpu, losses_cpu=l_cpu, max_abs_diff_vs_cpu=worst)


def phase_store_routes(seed: int) -> dict:
    """One push of each store route that no CTR family takes, on the card
    against the CPU: ``push_packed`` with AdaGrad on word2vec-width rows
    (gather, apply, ``scatter_write_rows``), and ``push_packed_small`` with a
    split accumulator of the table's dtype (``scatter_adagrad_rows``) and
    with bf16 slots on an f32 table (gather, apply, ``scatter_write_rows``).
    Returns the launches of each route's push kernel (its ``ctr_parity``
    line)."""
    from swiftsnails_tpu_torch.ops.rowdma import pack_rows
    from swiftsnails_tpu_torch.parallel import store
    from swiftsnails_tpu_torch.parallel.access import AdaGradAccess, SgdAccess

    rng = np.random.default_rng(seed + 3)
    rows = rng.integers(0, 4096, 3000).astype(np.int32)
    rows[:600] = rows[0]  # a hot row
    split = store.create_packed_small_table(4096, 17, SgdAccess(), seed=seed,
                                            device="cpu")
    split = split._replace(slots={"accum": torch.zeros_like(split.table)})
    bf16 = AdaGradAccess(slot_dtype=torch.bfloat16)
    routes = {
        "push_packed_adagrad": (
            store.create_packed_table(4096, DIM, AdaGradAccess(), seed=seed, device="cpu"),
            lambda st, r, g: store.push_packed(st, r, pack_rows(g), AdaGradAccess(), 0.05),
            DIM, {"gather_rows": 2, "scatter_write_rows": 2}),
        "push_packed_small_split": (
            split, lambda st, r, g: store.push_packed_small(st, r, g, AdaGradAccess(), 0.05, 17),
            17, {"scatter_adagrad_rows": 1}),
        "push_packed_small_bf16_slots": (
            store.create_packed_small_table(4096, 17, bf16, seed=seed, device="cpu"),
            lambda st, r, g: store.push_packed_small(st, r, g, bf16, 0.05, 17),
            17, {"gather_rows": 2, "scatter_write_rows": 2}),
    }
    launches = {}
    for route, (state, push, dim, want) in routes.items():
        grads = torch.from_numpy(rng.normal(size=(rows.shape[0], dim)).astype(np.float32))

        def on(device, st=state):
            return store.PackedTableState(
                st.table.clone().to(device), {k: v.clone().to(device) for k, v in st.slots.items()})

        want_state = push(on("cpu"), torch.from_numpy(rows), grads)
        got, counts = _run_counted(lambda: push(on("cuda"), torch.from_numpy(rows).cuda(),
                                                 grads.cuda()))
        _check_launches(route, counts, want)
        worst = 0.0
        for w, g in zip((want_state.table, *want_state.slots.values()),
                        (got.table, *got.slots.values())):
            g = g.cpu()
            np.testing.assert_allclose(g.float().numpy(), w.float().numpy(),
                                       rtol=1e-5, atol=1e-6)
            worst = max(worst, float((g.float() - w.float()).abs().max()))
        emit("ctr_parity", route=route, ids=int(rows.shape[0]),
             launches={k: n for k, n in counts.items() if n}, max_abs_diff_vs_cpu=worst)
        for name, n in counts.items():
            if n and name != "gather_rows":
                launches.setdefault(name, n)
    return launches


# CTR train phases -> (config keys over examples/widedeep.conf, launches a
# step of each kernel). train_widedeep is the conf as it stands (the
# small-row plane); train_widedeep_2d the conf at packed: 0, a [1,048,576,
# 17] table and its accumulator; train_ffm_wide FFM over Criteo's 39 fields
# (13 integer, 26 categorical) at libffm's Criteo factor_dim 4 (Juan et al.,
# RecSys 2016): table dim 1 + 39 * 4 = 157, above a 128-lane tile, so the
# 2-D plane, [1,048,576, 157] and its accumulator. The 2-D plane launches no
# kernel of the port (index_select, index_put_).
CTR_TRAIN = {
    "train_widedeep": ({}, {"gather_rows": 1, "scatter_adagrad_fused_rows": 1}),
    "train_widedeep_2d": ({"packed": 0}, {}),
    "train_ffm_wide": ({"model": "ffm", "num_fields": 39, "factor_dim": 4}, {}),
}


def phase_train_widedeep(seed: int, env: dict, phase: str = "train_widedeep",
                         packed_auc=None):
    """A ``CTR_TRAIN`` phase through ``get_model`` -> ``TrainLoop.run`` for
    ``CTR_STEPS`` steps on synth_ctr data, then ``eval_auc`` on the
    held-out records (beside the packed phase's, ``packed_auc``)."""
    from swiftsnails_tpu_torch.framework.trainer import TrainLoop
    from swiftsnails_tpu_torch.models.registry import get_model
    from swiftsnails_tpu_torch.utils.metrics import MetricsLogger

    over, per_step = CTR_TRAIN[phase]
    t0 = time.monotonic()
    cfg = _widedeep_config(seed)
    for k, v in over.items():
        cfg.set(k, str(v))
    (labels, feats), (eval_labels, eval_feats) = _ctr_data(seed, cfg.get_int("num_fields"))
    trainer = get_model(cfg.get_str("model"))(cfg, data=(labels, feats))
    records = []

    class Recorder(MetricsLogger):
        def log(self, record):
            records.append(record)

    loop = TrainLoop(trainer, metrics=Recorder(), log_every=1)
    setup_s = time.monotonic() - t0
    torch.cuda.reset_peak_memory_stats()
    state, launches = _run_counted(lambda: loop.run(seed=seed, max_steps=CTR_STEPS))
    _check_launches(phase, launches, {k: n * CTR_STEPS for k, n in per_step.items()})
    losses = [r["loss"] for r in records]
    if len(losses) != CTR_STEPS or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"losses: {losses}")
    if not np.mean(losses[-5:]) < np.mean(losses[:5]):
        raise AssertionError(f"loss did not fall: {losses}")
    if not torch.isfinite(state.table.table).all():
        raise AssertionError("non-finite table")
    steady = records[5:]
    seconds = sum(r["seconds"] for r in steady)
    step_ms = [r["seconds"] * 1e3 for r in steady]
    t_eval = time.perf_counter()
    auc = trainer.eval_auc(state, labels=eval_labels, feats=eval_feats)
    eval_s = time.perf_counter() - t_eval
    out = {"config": WIDEDEEP_CONF, "over": over, "model": trainer.name,
           "plane": "packed_small" if trainer.packed else "2-D",
           "steps": len(records), "batch": trainer.batch_size,
           "num_fields": trainer.num_fields, "capacity": trainer.capacity,
           "table": list(state.table.table.shape), "table_dim": trainer.table_dim,
           "table_bytes": sum(t.numel() * t.element_size()
                              for t in (state.table.table, *state.table.slots.values())),
           "hidden_dims": getattr(trainer, "hidden_dims", None), "lr": trainer.lr,
           "ids_per_field": CTR_IDS_PER_FIELD, "launches": launches, "setup_s": setup_s,
           "first_step_ms": records[0]["seconds"] * 1e3,
           "step_ms_median": statistics.median(step_ms),
           "examples_per_sec": sum(r["items"] for r in steady) / seconds,
           "loss_first5": losses[:5], "loss_last5": losses[-5:],
           "loss_first5_mean": float(np.mean(losses[:5])),
           "loss_last5_mean": float(np.mean(losses[-5:])),
           "eval_auc": auc, "eval_auc_packed_phase": packed_auc,
           "eval_records": len(eval_labels), "eval_s": eval_s,
           "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           "device": env["device"], "nvidia_smi": env["nvidia_smi"]}
    emit(phase, **out)
    return out, trainer, state


# ------------------------------------------ per_pair shapes, producer ---


def phase_perpair_kernels(seed: int, rate: float) -> dict:
    """``gather_rows`` and ``scatter_add_rows`` at the ``neg_mode: per_pair``
    substep's out-table shape: 16,384 contexts and 81,920 negatives, 98,304
    zipf ids of 1 KB rows from ``[1,048,576, 2, 128]`` f32 (the in-table pull
    is the packed+pool phase's 16,384), the push merged first. Returns the
    numbers for the summary line."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed + 9)
    gen = torch.Generator(device=dev).manual_seed(seed + 9)
    shape = (VOCAB, -(-DIM // 128), 128)
    table = torch.randn(shape, generator=gen, device=dev)
    n = PERPAIR_OUT_ROWS
    sets = [torch.from_numpy(zipf_ids(n, VOCAB, rng)).to(dev) for _ in range(ROW_SETS)]
    gather = _gather_case(table, sets, rate)
    emit("kernel", name="gather_rows", dtype="torch.float32", rows=n, path="train_perpair",
         **gather)
    scatter_sets, n_valid = [], []
    for ids in sets:
        uniq = torch.unique(ids).to(torch.int32)
        n_valid.append(int(uniq.numel()))
        pad = torch.full((n - uniq.numel(),), VOCAB, dtype=torch.int32, device=dev)
        scatter_sets.append(torch.cat([uniq, pad]))
    deltas = [torch.randn((n, *shape[1:]), generator=gen, device=dev).mul_(1e-3)
              for _ in range(ROW_SETS)]
    scatter = _scatter_case(table, scatter_sets, deltas, n_valid, rate)
    emit("kernel", name="scatter_add_rows", dtype="torch.float32", rows=n,
         path="train_perpair", **scatter)
    del table, deltas
    torch.cuda.empty_cache()
    return {"gather_rows_perpair": {"shape": [n, *shape[1:]], **gather},
            "scatter_add_rows_perpair": {"shape": [n, *shape[1:]], **scatter}}


PERPAIR_OUT_ROWS = BATCH * (1 + NEGATIVES)  # 98,304
PRODUCER_BATCHES_HELD = 8
PRODUCER_TRAIN = ("train", "train_grouped")  # trained on each producer in turns


def _producer_trainer(ids, vocab, use_native: int, grouped: bool, **over):
    from swiftsnails_tpu_torch.models.word2vec import Word2VecTrainer
    from swiftsnails_tpu_torch.utils.config import Config

    keys = {"dim": str(DIM), "window": str(WINDOW), "negatives": str(NEGATIVES),
            "batch_size": str(BATCH), "subsample": "0", "num_iters": "1",
            "use_native": str(use_native), **{k: str(v) for k, v in over.items()}}
    if grouped:
        keys.update({"fused": "1", "grouped": "1", "centers_per_block": str(CENTERS_PER_BLOCK)})
    return Word2VecTrainer(Config(keys), corpus_ids=ids, vocab=vocab)


def _first_batches(trainer, n: int = PRODUCER_BATCHES_HELD) -> list:
    it = iter(trainer.batches())
    out = [b for _, b in zip(range(n), it)]
    it.close()
    return out


def _same_batches(a: list, b: list) -> bool:
    return len(a) == len(b) and all(
        set(x) == set(y) and all(np.array_equal(x[k], y[k]) for k in x) for x, y in zip(a, b))


def phase_native_producer(seed: int, corpora, env: dict) -> dict:
    """``batches()`` alone on the card machine's host, the native producer
    against the numpy one, over the zipf corpus (2,000,000 tokens, window 5,
    batch 16,384, flat and grouped): words/sec of one whole pass. Gate: a
    second native run of the seed gives the same first 8 batches. Then the
    ``PRODUCER_TRAIN`` phases end to end on each producer, in turns."""
    ids, vocab, _ = corpora[False]
    out = {}
    for path, grouped in (("flat", False), ("grouped", True)):
        row = {}
        for producer, use_native in (("native", 1), ("python", 0)):
            trainer = _producer_trainer(ids, vocab, use_native, grouped)
            t0 = time.perf_counter()
            n_batches = sum(1 for _ in trainer.batches())
            seconds = time.perf_counter() - t0
            row[producer] = {"batches": n_batches, "seconds": seconds,
                             "words_per_sec": len(ids) / seconds}
        again = [_first_batches(_producer_trainer(ids, vocab, 1, grouped)) for _ in range(2)]
        if not _same_batches(*again):
            raise AssertionError(f"native_producer {path}: two runs of one seed differ")
        row["native_over_python"] = (row["native"]["words_per_sec"]
                                     / row["python"]["words_per_sec"])
        out[path] = row
    # end to end: the train phase on each producer, in turns (native,
    # python, python, native), words/sec over steps 6-30 as phase_train
    for phase in PRODUCER_TRAIN:
        runs = {"native": [], "python": []}
        for producer in ("native", "python", "python", "native"):
            trainer, loop, records = _train_loop(phase, seed, corpora,
                                                 use_native=int(producer == "native"))
            loop.run(seed=seed, max_steps=STEPS)
            steady = records[5:]
            items = sum(r["items"] for r in steady)
            words = items if trainer.grouped else items / corpora[TRAIN[phase][2]][2]
            runs[producer].append(words / sum(r["seconds"] for r in steady))
            del trainer, loop
            torch.cuda.empty_cache()
        out[f"{phase}_words_per_sec"] = runs
        out[f"{phase}_native_over_python"] = (statistics.mean(runs["native"])
                                              / statistics.mean(runs["python"]))
    emit("native_producer", tokens=len(ids), window=WINDOW, batch=BATCH, subsample=0,
         repeat_batches_equal=PRODUCER_BATCHES_HELD, **out,
         host_cpus=os.cpu_count(), device=env["device"], nvidia_smi=env["nvidia_smi"])
    return out


STREAM_STEPS = 10
STREAM_W2V = {"tokens": 300_000, "ids": 1 << 16}  # cli_resume's corpus
STREAM_CTR_RECORDS = 12 * 8192


def _loop_records(trainer, steps: int, seed: int) -> list:
    from swiftsnails_tpu_torch.framework.trainer import TrainLoop
    from swiftsnails_tpu_torch.utils.metrics import MetricsLogger

    records = []

    class Recorder(MetricsLogger):
        def log(self, record):
            records.append(record)

    state = TrainLoop(trainer, metrics=Recorder(), log_every=1).run(seed=seed,
                                                                    max_steps=steps)
    if not _finite(state):
        raise AssertionError("non-finite state")
    return records


def phase_stream(seed: int, env: dict) -> None:
    """``stream: 1`` for word2vec (``examples/word2vec.conf`` at capacity
    1,048,576 on a written zipf corpus) and for Wide & Deep
    (``examples/widedeep.conf`` on a written ``synth_ctr`` file), both on
    the native producer: the first 8 batches equal the whole-file run's (one
    chunk), and the streamed run trains 10 steps on the card."""
    from swiftsnails_tpu_torch.data.ctr import synth_ctr
    from swiftsnails_tpu_torch.models.registry import get_model
    from swiftsnails_tpu_torch.utils.config import load_config

    tmp = tempfile.mkdtemp(prefix="ssn_stream_")
    try:
        corpus = os.path.join(tmp, "corpus.txt")
        tokens = _write_text_corpus(corpus, STREAM_W2V["tokens"], STREAM_W2V["ids"], False,
                                    seed)
        records_path = os.path.join(tmp, "ctr.txt")
        labels, feats, _ = synth_ctr(STREAM_CTR_RECORDS, 26, CTR_IDS_PER_FIELD, seed=seed)
        with open(records_path, "w") as f:
            f.write("\n".join(f"{int(y)} " + " ".join(map(str, row))
                              for y, row in zip(labels, feats.tolist())) + "\n")
        cases = (
            ("word2vec", W2V_CONF, {"data": corpus, "capacity": CLI_CAPACITY, "min_count": 1,
                                    "num_iters": 1, "param_backup_root": "", "seed": seed}),
            ("widedeep", WIDEDEEP_CONF, {"data": records_path, "seed": seed}))
        for model, conf, over in cases:
            def make(stream: int):
                cfg = load_config(REPO / conf)
                for k, v in {**over, "stream": stream}.items():
                    cfg.set(k, str(v))
                return get_model(model)(cfg)

            t0 = time.perf_counter()
            whole = _first_batches(make(0))
            streamed_trainer = make(1)
            streamed = _first_batches(streamed_trainer)
            compare_s = time.perf_counter() - t0
            if not _same_batches(streamed, whole):
                raise AssertionError(f"stream {model}: the streamed batches differ from "
                                     "the whole file's")
            if streamed_trainer.producer != "native":
                raise AssertionError(f"stream {model}: producer {streamed_trainer.producer}")
            records = _loop_records(streamed_trainer, STREAM_STEPS, seed)
            losses = [r["loss"] for r in records]
            if len(losses) != STREAM_STEPS or not all(math.isfinite(x) for x in losses):
                raise AssertionError(f"stream {model}: losses {losses}")
            emit("stream", model=model, config=conf, over={k: str(v) for k, v in over.items()},
                 data_bytes=os.path.getsize(over["data"]),
                 tokens=tokens if model == "word2vec" else None,
                 records=STREAM_CTR_RECORDS if model == "widedeep" else None,
                 batches_equal_whole_file=len(whole), compare_s=compare_s,
                 producer=records[0].get("producer"), steps=len(records), losses=losses,
                 step_ms_median=statistics.median(r["seconds"] * 1e3 for r in records[1:]),
                 device=env["device"], nvidia_smi=env["nvidia_smi"])
            del streamed_trainer
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# the JAX package's tests/test_path_quality.py PATHS; the first three gated
QUALITY_PATHS = {
    "dense": {"packed": "0"},
    "packed_perpair": {"packed": "1", "neg_mode": "per_pair"},
    "packed_pool": {"packed": "1", "neg_mode": "pool"},
    "fused": {"packed": "1", "neg_mode": "pool", "fused": "1"},
    "fused_grouped": {"packed": "1", "neg_mode": "pool", "fused": "1", "grouped": "1"},
    "fused_resident": {"packed": "1", "neg_mode": "pool", "fused": "1", "grouped": "1",
                       "resident": "1"},
    "fused_dedup": {"packed": "1", "neg_mode": "pool", "fused": "1", "grouped": "1",
                    "dedup": "1"},
    "fused_dedup_res": {"packed": "1", "neg_mode": "pool", "fused": "1", "grouped": "1",
                        "dedup": "1", "resident": "1"},
}
QUALITY_GATED = ("dense", "packed_perpair", "packed_pool")


def phase_quality(env: dict) -> dict:
    """``probe_top1`` on the card for each path of the JAX package's quality
    test, the fused ones through their real kernels: hard gate at
    ``MIN_TOP1`` on the three gated paths, the fused scores printed."""
    from swiftsnails_tpu_torch.framework.quality import MIN_TOP1, probe_top1

    scores, seconds = {}, {}
    for name, over in QUALITY_PATHS.items():
        t0 = time.perf_counter()
        scores[name] = probe_top1(over)
        seconds[name] = time.perf_counter() - t0
    below = [n for n in QUALITY_GATED if not scores[n] >= MIN_TOP1]
    emit("quality", min_top1=MIN_TOP1, top1=scores, seconds=seconds, gated=list(QUALITY_GATED),
         fused_below=[n for n in scores if n not in QUALITY_GATED and scores[n] < MIN_TOP1],
         device=env["device"], nvidia_smi=env["nvidia_smi"])
    if below:
        raise AssertionError(f"quality: {below} below MIN_TOP1 {MIN_TOP1}: {scores}")
    return scores


SEM_PROBE_DIM = 200  # a row of [2, 128] f32: 1,024 B
SEM_PROBES = ("unit_probe", "chunk_probe", "pipe_probe")


def phase_sem_probe(rate: float) -> dict:
    """The probe tool's ``main`` at ``--dim 200``, held to what each probe
    must observe; returns the kernels line's entries of its three kernels."""
    from swiftsnails_tpu_torch.tools import sem_probe as tool

    res, launches = _run_counted(lambda: tool.main(["--dim", str(SEM_PROBE_DIM)]))
    unit, chunk, pipe = res["unit"], res.get("chunk"), res.get("pipe")
    for tag, f in unit["tags"].items():
        # held: every verdict as the plain version states it (the unit its
        # bytes, exact arming complete, over-arming pending, additivity)
        if not f["held"]:
            raise AssertionError(f"unit probe {tag}: {f}")
    if not unit["linear"] or chunk is None:
        raise AssertionError(f"unit probe: not row-additive: {unit}")
    row_bytes = unit["row_unit"]
    if not (chunk["bit_equal"] and chunk["max_abs_err"] == 0.0
            and chunk["flag"] == 64 * row_bytes == 65_536):
        raise AssertionError(f"chunk probe: {chunk}")
    if pipe is None or not pipe["ok"]:
        raise AssertionError(f"pipe probe: {pipe}")
    for name in SEM_PROBES:
        if not launches[name]:
            raise AssertionError(f"sem_probe: {name} was not launched")
    row = unit["tags"][unit["row_tag"]]
    bound = lambda nbytes: nbytes / rate * 1e3  # noqa: E731
    # The unit and chunk probes move a few KB: their bytes bound is far below
    # one copy's issue-to-complete latency, which limits them (bound_by).
    out = {
        "unit_probe": {
            "launches": launches["unit_probe"], "ms": unit["ms"],
            "plain_ms": unit["plain_ms"], "bound_ms": bound(unit["bytes"]),
            "bound_by": "latency", "library_ms": None,
            "max_abs_err": max(abs(f["unit"] - f["plain_unit"])
                               for f in unit["tags"].values()),
            "shape": [8, 2, 128], "copy_ns": row["exact_ns"],
            "copy_cycles": row["exact_cycles"], "copy_polls": row["exact_polls"]},
        "chunk_probe": {
            "launches": launches["chunk_probe"], "ms": chunk["ms"],
            "plain_ms": chunk["plain_ms"], "bound_ms": bound(chunk["bytes"]),
            "bound_by": "latency", "library_ms": chunk["library_ms"],
            "max_abs_err": chunk["max_abs_err"],
            "shape": chunk["shape"], "ids": chunk["rows"], "flag": chunk["flag"],
            "issue_to_complete_ns": chunk["ns"],
            "issue_to_complete_cycles": chunk["cycles"]},
        "pipe_probe": {
            "launches": launches["pipe_probe"], "ms": pipe["chunked"]["ms"],
            "per_copy_ms": pipe["per_copy"]["ms"], "speedup": pipe["speedup"],
            "plain_ms": pipe["plain_ms"], "bound_ms": bound(pipe["bytes"]),
            "bound_by": "bytes", "copy_bound_ms": bound(pipe["copy_bytes"]),
            "library_ms": pipe["index_select_ms"],
            "gather_rows_ms": pipe["gather_rows_ms"], "max_abs_err": pipe["max_abs_err"],
            "shape": pipe["shape"], "ids": pipe["blocks"] * pipe["copies"],
            "stages": pipe["stages"]},
    }
    emit("sem_probe", launches={k: launches[k] for k in SEM_PROBES}, **out)
    return out


# ------------------------------------------ the CLI, checkpoints, chaos ---

REPO = Path(__file__).resolve().parent
W2V_CONF = "examples/word2vec.conf"  # from the root of the repository
W2V_FAST_CONF = "examples/word2vec_fast.conf"
CLI_CAPACITY = 1 << 20  # bench.py's table size: two [1,048,576, 2, 128] f32 tables, 1 GiB each
# Free space a CLI phase needs under the temporary directory: one root at a
# time (the control's is deleted before the interrupted run), up to 5 step
# directories of 2 GiB (3 kept, the protected one, the one being written).
CLI_DISK_BYTES = 12 << 30
# phase -> its config, corpus (tokens, zipf id range, paired), backup period,
# overrides beyond the common ones, and launches a substep of each kernel.
# The id ranges keep the vocabularies at ~31k and ~65k words, so that the
# text export of `output` takes seconds; the tables stay at CLI_CAPACITY.
CLI = {
    "cli_resume": {"conf": W2V_CONF, "tokens": 300_000, "ids": 1 << 16, "paired": False,
                   "period": 8, "over": {},
                   "per_substep": {"gather_rows": 2, "scatter_add_rows": 2}},
    # word2vec_fast.conf's lr 0.025 moves no loss in 19 steps: the merged
    # phases' lr and a paired corpus, as train_dedup_res
    "cli_fast": {"conf": W2V_FAST_CONF, "tokens": 5_000_000, "ids": 1 << 15, "paired": True,
                 "period": 3, "over": {"learning_rate": MERGED_LR["train_dedup_res"]},
                 "per_substep": {"fused_sgns_dedup_resident_step": 1}},
}
CHAOS_SPEC = "nan_grad@5-6,row_poison@9,ckpt_corrupt@12,preempt@17"
# the chaos drill's table rows: the corpus's ~31k words, at 128 MiB a save
# instead of the 2 GiB of CLI_CAPACITY (whose saves cli_resume times)
CHAOS_CAPACITY = 1 << 16
GUARD_STEPS = 30
_COMMIT_RE = re.compile(r"checkpoint: committed step_(\d+) \((\d+) bytes: snapshot ([\d.]+) s, "
                        r"d2h wait ([\d.]+) s, crc ([\d.]+) s, write ([\d.]+) s\)")
_RESTORE_RE = re.compile(r"resume: restored step (\d+) from \S+ in ([\d.]+) s")
_DRAIN_RE = re.compile(r"preemption \((.*)\): drained at step (\d+)")


def _write_text_corpus(path: str, tokens: int, ids: int, paired: bool, seed: int) -> int:
    """A whitespace-separated corpus of zipf ids as words ``w<id>``, or with
    ``paired`` zipf-distributed pairs (``w<2p> w<2p+1>``); returns its length."""
    rng = np.random.default_rng(seed)
    if paired:
        p = zipf_ids(tokens // 2, ids, rng)
        x = np.stack([2 * p, 2 * p + 1], 1).reshape(-1)
    else:
        x = zipf_ids(tokens, ids, rng)
    with open(path, "w", encoding="utf-8") as f:
        f.write(" ".join(np.char.add("w", x.astype(str)).tolist()))
    return len(x)


class _ManifestWatch:
    """Every manifest committed under ``root`` while it runs, by step, read
    as it appears: retention prunes older steps before a run ends."""

    def __init__(self, root: str):
        self.root, self.manifests = root, {}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._poll, daemon=True)
        self._thread.start()

    def _scan(self) -> None:
        from swiftsnails_tpu_torch.framework import checkpoint as ckpt

        for s in ckpt.all_steps(self.root):
            if s not in self.manifests:
                m = ckpt.read_manifest(self.root, s)
                if m is not None:
                    self.manifests[s] = m

    def _poll(self) -> None:
        while not self._stop.wait(0.02):
            self._scan()

    def stop(self) -> dict:
        self._stop.set()
        self._thread.join()
        self._scan()
        return self.manifests


def _crcs(manifest: dict) -> dict:
    return {k: (v["crc"], v["algo"]) for k, v in manifest["arrays"].items()}


def _metric_records(text: str) -> list:
    out = []
    for line in text.splitlines():
        if line.startswith("{") and '"items"' in line:
            out.append(json.loads(line))
    return out


def _last_logged_step(path: str):
    """The step of the last metrics line a run has written to ``path``."""
    with open(path) as f:
        records = _metric_records(f.read().rsplit("\n", 1)[0])
    return records[-1]["step"] if records else None


def _rates(records: list, words_per_item: float) -> dict:
    """Items/sec, words/sec and step ms over the records past the first 5."""
    steady = records[5:] or records
    items = sum(r["items"] for r in steady)
    seconds = sum(r["seconds"] for r in steady)
    return {"steps": len(records), "items_per_sec": items / seconds,
            "words_per_sec": items * words_per_item / seconds,
            "step_ms_median": statistics.median(r["seconds"] * 1e3 for r in steady)}


def _save_stats(stderr: str) -> dict:
    saves = [tuple(float(x) for x in m) for m in _COMMIT_RE.findall(stderr)]
    if not saves:
        return {"saves": 0}
    nbytes = saves[0][1]
    med = {name: statistics.median(s[i] for s in saves)
           for i, name in ((2, "snapshot_s"), (3, "d2h_wait_s"), (4, "crc_s"), (5, "write_s"))}
    busy = med["d2h_wait_s"] + med["crc_s"] + med["write_s"]
    return {"saves": len(saves), "bytes": int(nbytes), **med,
            "writer_s": busy, "writer_GBps": nbytes / busy / 1e9,
            "crc_GBps": nbytes / med["crc_s"] / 1e9, "write_GBps": nbytes / med["write_s"] / 1e9}


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 24), b""):
            h.update(block)
    return h.hexdigest()


def _cli_args(spec: dict, corpus: str, root: str, out: str, seed: int) -> list:
    over = {"data": corpus, "capacity": CLI_CAPACITY, "num_iters": 1, "min_count": 1,
            "param_backup_period": spec["period"], "param_backup_root": root,
            "output": out, "log_every": 1, "seed": seed, **spec["over"]}
    return ["train", "-config", str(REPO / spec["conf"]),
            *(x for k, v in over.items() for x in (f"-{k}", str(v)))]


def _in_process_cli(args: list) -> tuple:
    """``cli.main(args)`` in this process, its output captured, every launch
    counter set to 0 just before and read just after."""
    from swiftsnails_tpu_torch import cli

    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc, launches = _run_counted(lambda: cli.main(args))
    seconds = time.perf_counter() - t0
    torch.cuda.empty_cache()
    if rc != 0:
        raise AssertionError(f"cli {args[0]} exited {rc}: {err.getvalue()[-3000:]}")
    return out.getvalue(), err.getvalue(), launches, seconds


def _subprocess_cli(args: list, workdir: str, tag: str, until=None) -> tuple:
    """``python -m swiftsnails_tpu_torch`` with ``args``; with ``until``, a
    SIGTERM once ``until()`` holds. Returns its exit code, stdout, stderr
    and seconds; never leaves the process behind."""
    paths = [os.path.join(workdir, f"{tag}.{s}") for s in ("out", "err")]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(REPO), os.environ.get("PYTHONPATH", "")) if p))
    t0 = time.perf_counter()
    with open(paths[0], "w") as fo, open(paths[1], "w") as fe:
        proc = subprocess.Popen([sys.executable, "-m", "swiftsnails_tpu_torch", *args],
                                stdout=fo, stderr=fe, cwd=str(REPO), env=env)
        try:
            if until is not None:
                deadline = time.monotonic() + 600
                while not until():
                    if proc.poll() is not None or time.monotonic() > deadline:
                        raise AssertionError(f"{tag}: exited ({proc.returncode}) or timed out "
                                             "before the SIGTERM was due")
                    time.sleep(0.02)
                proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    out, err = (Path(p).read_text() for p in paths)
    return rc, out, err, time.perf_counter() - t0


def phase_cli(name: str, seed: int, env: dict) -> dict:
    """``python -m swiftsnails_tpu_torch train`` at full width: an
    uninterrupted control in this process, then a run in a subprocess
    stopped by a real SIGTERM after its second periodic manifest, then the
    same command again, which resumes. The resumed run's periodic
    checkpoints must carry the control's CRCs (bit-equal tables) and its
    ``vectors.txt`` must be the control's, byte for byte."""
    from swiftsnails_tpu_torch.framework import checkpoint as ckpt
    from swiftsnails_tpu_torch.utils.config import load_config

    spec = CLI[name]
    tmp = tempfile.mkdtemp(prefix=f"chip_smoke_{name}_")
    try:
        free = shutil.disk_usage(tmp).free
        if free < CLI_DISK_BYTES:
            raise AssertionError(f"{name}: {free} bytes free under {tmp}, need {CLI_DISK_BYTES}")
        corpus = os.path.join(tmp, "corpus.txt")
        n_tokens = _write_text_corpus(corpus, spec["tokens"], spec["ids"], spec["paired"], seed)
        period = spec["period"]

        # the control, in process: its launches and every manifest it commits
        ctl_root, ctl_out = os.path.join(tmp, "control"), os.path.join(tmp, "control.txt")
        watch = _ManifestWatch(ctl_root)
        out, err, launches, ctl_s = _in_process_cli(_cli_args(spec, corpus, ctl_root, ctl_out, seed))
        control = watch.stop()
        records = _metric_records(out)
        steps = records[-1]["step"]
        spc = load_config(REPO / spec["conf"]).get_int("steps_per_call", 1)
        _check_launches(name, launches, {k: n * steps * spc for k, n in spec["per_substep"].items()})
        words_per_item = n_tokens / sum(r["items"] for r in records)
        ctl_rates = _rates(records, words_per_item)
        ctl_saves = _save_stats(err)
        ctl_sha = _sha256(ctl_out)
        periodic = sorted(s for s in control if s % period == 0)
        if periodic != list(range(period, steps + 1, period)):
            raise AssertionError(f"{name}: control committed {sorted(control)} in {steps} steps")
        shutil.rmtree(ctl_root)

        # the run a real SIGTERM stops after its second periodic manifest
        root, vec = os.path.join(tmp, "run"), os.path.join(tmp, "run.txt")
        args = _cli_args(spec, corpus, root, vec, seed)
        watch = _ManifestWatch(root)
        log = os.path.join(tmp, "first.out")

        def sigterm_due() -> bool:
            # after two periodic manifests, and mid-period: a step logged
            # at k*P - 1 or k*P means the loop is about to wait, or waits,
            # for the writer at a periodic save, and would drain there
            last = _last_logged_step(log)
            return len(watch.manifests) >= 2 and last is not None and 0 < last % period < period - 1

        rc, out1, err1, first_s = _subprocess_cli(args, tmp, "first", until=sigterm_due)
        if rc != 0 or "preempted (SIGTERM)" not in err1:
            raise AssertionError(f"{name}: SIGTERM run exited {rc}: {err1[-3000:]}")
        drain = _DRAIN_RE.findall(err1)
        if len(drain) != 1:
            raise AssertionError(f"{name}: drain lines {drain}: {err1[-3000:]}")
        final = int(drain[0][1])
        before = sorted(s for s in ckpt.intact_steps(root) if s % period == 0)
        if ckpt.intact_steps(root)[0] != final or final <= before[-1] or final <= 2 * period:
            raise AssertionError(f"{name}: drained at {final}, intact {ckpt.intact_steps(root)}")

        # the same command again: it resumes from the drain's save
        rc, out2, err2, resumed_s = _subprocess_cli(args, tmp, "resumed")
        run = watch.stop()
        restored = _RESTORE_RE.findall(err2)
        if rc != 0 or not restored or int(restored[0][0]) != final or "preempted" in err2:
            raise AssertionError(f"{name}: resumed run exited {rc}, restored {restored}: "
                                 f"{err2[-3000:]}")
        after = sorted(s for s in run if s > final and s % period == 0)
        if len(after) < 2 or after[-1] != periodic[-1]:
            raise AssertionError(f"{name}: periodic saves after the resume {after}, "
                                 f"control {periodic}")
        # bit-equal: every kernel of the path is bit-identical run to run
        differ = [s for s in sorted(run) if s in control and (
            _crcs(run[s]) != _crcs(control[s])
            or run[s]["data_cursor"] != control[s]["data_cursor"])]
        vectors_equal = _sha256(vec) == ctl_sha
        out = {"config": spec["conf"],
               "overrides": {k: v for k, v in zip(args[3::2], args[4::2])},
               "corpus": {"tokens": n_tokens, "zipf_ids": spec["ids"], "paired": spec["paired"]},
               "steps": steps, "substeps_per_step": spc, "launches": launches,
               "control": {"s": ctl_s, **ctl_rates, "save": ctl_saves},
               "sigterm_after": sorted(watch.manifests)[:2], "drained_at": final,
               "periodic_before": before, "periodic_after_resume": after,
               "compared_steps": sorted(s for s in run if s in control),
               "differing_steps": differ, "vectors_equal": vectors_equal,
               "first": {"s": first_s, **_rates(_metric_records(out1), words_per_item),
                         "save": _save_stats(err1)},
               "resumed": {"s": resumed_s, **_rates(_metric_records(out2), words_per_item),
                           "save": _save_stats(err2), "restore_s": float(restored[0][1])},
               "step_dir_bytes": _dir_bytes(os.path.join(root, f"step_{after[-1]}")),
               "disk_free_bytes": free, "device": env["device"], "nvidia_smi": env["nvidia_smi"]}
        emit(name, **out)
        if differ or not vectors_equal:
            raise AssertionError(f"{name}: the resumed run differs from the control at steps "
                                 f"{differ}; vectors.txt equal: {vectors_equal}")
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _chaos_loop(args: list, **over):
    """A trainer and loop of ``python -m swiftsnails_tpu_torch train args``,
    built in this process, with ``over`` set after the command line."""
    from swiftsnails_tpu_torch import cli
    from swiftsnails_tpu_torch.framework.trainer import TrainLoop
    from swiftsnails_tpu_torch.utils.flags import parse_role_argv

    cfg = parse_role_argv(args[1:])
    for k, v in over.items():
        cfg.set(k, str(v))
    trainer = cli._build_trainer(cfg)
    return trainer, TrainLoop(trainer, log_every=0)


def _finite(state) -> bool:
    from swiftsnails_tpu_torch.utils.tree import tensor_items

    return all(bool(torch.isfinite(t).all()) for _, t in tensor_items(state))


def phase_chaos(seed: int, env: dict) -> dict:
    """The training drill at ``examples/word2vec.conf``'s width, in process:
    NaN updates and a poisoned row rolled back, a corrupted checkpoint
    rejected, a preemption drained; then a resumed run that walks back past
    a corrupted final save; then a run that gives up."""
    from swiftsnails_tpu_torch.framework import checkpoint as ckpt
    from swiftsnails_tpu_torch.resilience import GuardrailExhausted, corrupt_checkpoint_dir

    spec = CLI["cli_resume"]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_chaos_")
    try:
        corpus = os.path.join(tmp, "corpus.txt")
        _write_text_corpus(corpus, spec["tokens"], spec["ids"], spec["paired"], seed)
        root = os.path.join(tmp, "ck")
        args = _cli_args({**spec, "period": 4}, corpus, root, os.path.join(tmp, "v.txt"), seed)
        args[args.index("-capacity") + 1] = str(CHAOS_CAPACITY)
        trainer, loop = _chaos_loop(args, chaos_spec=CHAOS_SPEC, guard_max_consecutive=3,
                                    chaos_seed=seed)
        err = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(err):
            state = loop.run(seed=seed)
        run_s = time.perf_counter() - t0
        err = err.getvalue()
        trips = [int(s) for s in re.findall(r"guardrail: step (\d+) rolled back", err)]
        finite = _finite(state)
        events = loop.chaos.events
        corrupted = [e["step"] for e in events if e["fault"] == "ckpt_corrupt"]
        intact = ckpt.intact_steps(root)
        final = intact[0]
        try:
            ckpt.restore_checkpoint(root, trainer.init_state(), step=12)
            hit_rejected = False
        except ckpt.CheckpointError:
            hit_rejected = True
        ckpt.restore_checkpoint(root, trainer.init_state(), step=final)  # the drain's save verifies
        preempted = loop.preempted
        del state, trainer, loop
        torch.cuda.empty_cache()
        corrupt_checkpoint_dir(root, step=final, rng=np.random.default_rng(seed))

        trainer2, loop2 = _chaos_loop(args, resume="auto")
        err2 = io.StringIO()
        with contextlib.redirect_stderr(err2):
            state2 = loop2.run(seed=seed, max_steps=final + 8)
        err2 = err2.getvalue()
        rejected = [int(s) for s in re.findall(r"resume: rejected step (\d+)", err2)]
        finite2 = _finite(state2)
        want_restored = max(s for s in intact if s not in (12, final))
        restored, preempted2 = loop2._restored_step, loop2.preempted
        del state2, trainer2, loop2
        torch.cuda.empty_cache()

        trainer3, loop3 = _chaos_loop(args, chaos_spec="nan_grad@1-6", guard_max_consecutive=2,
                                      param_backup_root="", chaos_seed=seed)
        try:
            with contextlib.redirect_stderr(io.StringIO()):
                loop3.run(seed=seed, max_steps=8)
            gave_up = None
        except GuardrailExhausted as e:
            gave_up = str(e)
        del trainer3, loop3
        torch.cuda.empty_cache()
        out = {"config": W2V_CONF, "chaos_spec": CHAOS_SPEC, "param_backup_period": 4,
               "guard_max_consecutive": 3, "capacity": CHAOS_CAPACITY, "run_s": run_s,
               "trips": trips, "finite": finite, "preempted": preempted,
               "corrupted_by_chaos": corrupted, "intact_after_run": intact,
               "corrupt_step_rejected": hit_rejected, "drained_at": final,
               "second_run": {"rejected": rejected, "restored": restored,
                              "want_restored": want_restored, "finite": finite2},
               "give_up": gave_up, "device": env["device"], "nvidia_smi": env["nvidia_smi"]}
        emit("chaos", **out)
        problems = []
        if trips != [5, 6, 9]:
            problems.append(f"trips {trips}, want [5, 6, 9]")
        if not (finite and finite2):
            problems.append("a non-finite table")
        if not preempted or final != 18:
            problems.append(f"preempted {preempted}, drained at {final}")
        if corrupted != [12] or not hit_rejected:
            problems.append(f"ckpt_corrupt at {corrupted}, rejected on restore: {hit_rejected}")
        if rejected != [final] or restored != want_restored or preempted2:
            problems.append(f"second run rejected {rejected}, restored {restored}")
        if gave_up is None:
            problems.append("nan_grad@1-6 with guard_max_consecutive 2 did not give up")
        if problems:
            raise AssertionError("chaos: " + "; ".join(problems))
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_guardrail_cost(seed: int, env: dict) -> dict:
    """Step ms of packed+pool at the ``cli_resume`` shape with
    ``guardrail: 1`` and without (median of steps 6-30), the tables of the
    two runs bit-equal (trust stays 1.0), and the guardrail's own device time
    a step by ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from swiftsnails_tpu_torch.utils.metrics import MetricsLogger

    spec = CLI["cli_resume"]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_guard_")
    runs = {}
    try:
        corpus = os.path.join(tmp, "corpus.txt")
        _write_text_corpus(corpus, spec["tokens"], spec["ids"], spec["paired"], seed)
        args = _cli_args({**spec, "period": 0}, corpus, "", os.path.join(tmp, "v.txt"), seed)
        for guard in (0, 1):
            _, loop = _chaos_loop(args, guardrail=guard, resume=0, param_backup_root="")
            records = []

            class Recorder(MetricsLogger):
                def log(self, record):
                    records.append(record)

            loop.metrics, loop.log_every = Recorder(), 1
            state = loop.run(seed=seed, max_steps=GUARD_STEPS)
            runs[guard] = (statistics.median(r["seconds"] * 1e3 for r in records[5:]),
                           state, loop)
        equal = all(torch.equal(a.table, b.table) for a, b in zip(runs[0][1], runs[1][1]))
        g = runs[1][2].guardrail
        state = runs[1][1]
        dev = state.in_table.table.device
        metrics = {"loss": torch.tensor(0.5, device=dev)}
        g.commit(g.snapshot(state), state, metrics)  # warm
        calls = 5
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(calls):
                g.commit(g.snapshot(state), state, metrics)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            wall_ms = (time.perf_counter() - t0) * 1e3 / calls
        kernels = sorted(((e.key, e.self_device_time_total / 1e3 / calls)
                          for e in prof.key_averages()
                          if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                         key=lambda k: -k[1])
        off, on = runs[0][0], runs[1][0]
        state_bytes = sum(t.table.numel() * t.table.element_size() for t in state)
        out = {"path": "packed+pool", "config": W2V_CONF, "capacity": CLI_CAPACITY,
               "steps": GUARD_STEPS, "step_ms_median_off": off, "step_ms_median_on": on,
               "overhead_ms": on - off, "overhead_pct": 100.0 * (on - off) / off,
               "tables_bit_equal": equal, "trips": g.trips_total,
               "guard_device_ms": sum(ms for _, ms in kernels), "guard_wall_ms": wall_ms,
               "state_bytes": state_bytes,
               "top": [{"kernel": k[:90], "ms": ms} for k, ms in kernels[:6]],
               "device": env["device"], "nvidia_smi": env["nvidia_smi"]}
        emit("guardrail_cost", **out)
        if not equal or g.trips_total:
            raise AssertionError("guardrail_cost: the guarded run's tables differ from the "
                                 f"unguarded run's (trips {g.trips_total})")
        return out
    finally:
        del runs
        torch.cuda.empty_cache()
        shutil.rmtree(tmp, ignore_errors=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test needs "
              "a CUDA card", file=sys.stderr)
        return 2
    import swiftsnails_tpu_torch  # noqa: F401  fails outside the repository

    t_start = time.monotonic()
    env = phase_env()
    phase_build()
    summary = phase_kernels(args.seed, env["mem_rate_Bps"])
    summary.update(phase_fused_kernels(args.seed, env))
    for path in PATHS:
        phase_slice_parity(args.seed, path)
    corpora = {False: _corpus(args.seed), True: _corpus(args.seed, paired=True)}
    summary.update(phase_perpair_kernels(args.seed, env["mem_rate_Bps"]))
    launches = {}
    for phase, path in (("train", "packed"), ("train_fused", "fused"),
                        ("train_grouped", "grouped"), ("train_resident", "resident"),
                        ("train_dedup", "dedup"), ("train_dedup_res", "dedup_res"),
                        ("train_dense", "dense"), ("train_perpair", "perpair")):
        train, trainer, state = phase_train(phase, args.seed, corpora, env["device"],
                                            env["nvidia_smi"])
        suffix = "_perpair" if phase == "train_perpair" else ""
        launches.update({k + suffix: n for k, n in train["launches"].items()
                         if TRAIN[phase][1].get(k)})
        phase_profile(path, trainer, state, args.seed)
        del trainer, state
        torch.cuda.empty_cache()
    summary.update(phase_ctr_kernels(args.seed, env["mem_rate_Bps"]))
    paths = {name: "train" for name in ("gather_rows", "scatter_add_rows")}
    paths.update({f"{name}_perpair": "train_perpair"
                  for name in ("gather_rows", "scatter_add_rows")})
    phase_ctr_parity(args.seed)
    for name, n in phase_store_routes(args.seed).items():
        launches[name], paths[name] = n, "ctr_parity store route"
    train, trainer, state = phase_train_widedeep(args.seed, env)
    launches["scatter_adagrad_fused_rows"] = train["launches"]["scatter_adagrad_fused_rows"]
    paths["scatter_adagrad_fused_rows"] = "train_widedeep"
    phase_profile("widedeep", trainer, state, args.seed)
    del trainer, state
    torch.cuda.empty_cache()
    launches["gather_rows_widedeep"] = train["launches"]["gather_rows"]
    paths["gather_rows_widedeep"] = "train_widedeep"
    for phase, path in (("train_widedeep_2d", "widedeep_2d"), ("train_ffm_wide", "ffm_wide")):
        _, trainer, state = phase_train_widedeep(args.seed, env, phase,
                                                 packed_auc=train["eval_auc"])
        phase_profile(path, trainer, state, args.seed)
        del trainer, state
        torch.cuda.empty_cache()
    phase_native_producer(args.seed, corpora, env)
    phase_stream(args.seed, env)
    phase_quality(env)
    probes = phase_sem_probe(env["mem_rate_Bps"])
    for name in CLI:
        phase_cli(name, args.seed, env)
    phase_chaos(args.seed, env)
    phase_guardrail_cost(args.seed, env)
    kernels = []
    for key, name, replaces in (
            ("gather_rows", "gather_rows", "swiftsnails_tpu/ops/rowdma.py:114"),
            ("gather_rows_widedeep", "gather_rows", "swiftsnails_tpu/ops/rowdma.py:114"),
            ("gather_rows_perpair", "gather_rows", "swiftsnails_tpu/ops/rowdma.py:114"),
            ("scatter_add_rows", "scatter_add_rows", "swiftsnails_tpu/ops/rowdma.py:213"),
            ("scatter_add_rows_perpair", "scatter_add_rows",
             "swiftsnails_tpu/ops/rowdma.py:213")):
        s = summary[key]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "swiftsnails_tpu_torch/csrc/rowdma.cu",
            "replaces": replaces, "launches": launches[key],
            "max_abs_err": s["max_abs_err"], "ms": s["kernel_ms"],
            "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
            "bound_by": "bytes", "library_ms": s["library_ms"],
            "shape": s["shape"], "dtype": "float32", "path": paths[key]})
    for name, replaces in (
            ("scatter_write_rows", "swiftsnails_tpu/ops/rowdma.py:289"),
            ("scatter_adagrad_rows", "swiftsnails_tpu/ops/rowdma.py:418"),
            ("scatter_adagrad_fused_rows", "swiftsnails_tpu/ops/rowdma.py:552")):
        s = summary[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "swiftsnails_tpu_torch/csrc/rowdma.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": s["max_abs_err"], "ms": s["ms"],
            "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
            "bound_by": "bytes", "library_ms": s["library_ms"],
            "shape": s["shape"], "ids": s["ids"], "unique_rows": s["unique_rows"],
            "dtype": "float32", "path": paths[name]})
    grouped_shape = {"centers": GROUPED_BATCH, "centers_per_block": CENTERS_PER_BLOCK,
                     "window_slots": CW, "pool": POOL_SIZE}
    for name, replaces, source, shape in (
            ("fused_sgns_step", "swiftsnails_tpu/ops/fused_sgns.py:1832", "fused_sgns.cu",
             {"pairs": BATCH, "pairs_per_block": POOL_BLOCK, "pool": POOL_SIZE}),
            ("fused_sgns_grouped_step", "swiftsnails_tpu/ops/fused_sgns.py:347",
             "fused_sgns.cu", grouped_shape),
            ("fused_sgns_resident_step", "swiftsnails_tpu/ops/fused_sgns.py:1002",
             "fused_sgns_merged.cu", {**grouped_shape, **MERGED["fused_sgns_resident_step"]}),
            ("fused_sgns_dedup_step", "swiftsnails_tpu/ops/fused_sgns.py:1315",
             "fused_sgns_merged.cu", {**grouped_shape, **MERGED["fused_sgns_dedup_step"]}),
            ("fused_sgns_dedup_resident_step", "swiftsnails_tpu/ops/fused_sgns.py:1681",
             "fused_sgns_merged.cu",
             {**grouped_shape, **MERGED["fused_sgns_dedup_resident_step"]})):
        s = summary[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"swiftsnails_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": s["max_abs_err"], "ms": s["ms"],
            "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
            "bound_by": s["bound_by"], "library_ms": None,
            "kernel_only_ms": s["kernel_only_ms"], "yardstick_ms": s["yardstick_ms"],
            "card_launches_per_substep": s["card_launches_per_substep"],
            **{k: s[k] for k in ("host_ms", "cluster", "ctas", "max_active_clusters")
               if k in s},
            "shape": {**shape, "table": [VOCAB, -(-DIM // 128), 128]},
            "dtype": "float32"})
    for name, replaces in (("unit_probe", "tools/sem_probe.py:80"),
                           ("chunk_probe", "tools/sem_probe.py:164"),
                           ("pipe_probe", "tools/sem_probe.py:233")):
        kernels.append({"name": name, "route": "cuda",
                        "source": "swiftsnails_tpu_torch/csrc/sem_probe.cu",
                        "replaces": replaces, **probes[name],
                        "dtype": "float32", "path": "sem_probe"})
    emit("kernels", kernels=kernels)
    emit("total", seconds=time.monotonic() - t_start)
    print(json.dumps({"kernels": kernels}))
    print(env["nvidia_smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
