"""Chip smoke test of the PyTorch port: builds its CUDA kernels, holds each
against its plain PyTorch version, and trains word2vec (packed+pool) at full
width on one NVIDIA GPU through the port's normal entry points.

    python3 chip_smoke.py [--seed N]

Run from the root of the repository on a machine with a CUDA card, ``nvcc``
(``$CUDA_HOME`` or ``/usr/local/cuda``) and PyTorch built for CUDA. The
kernels build at first use into ``swiftsnails_tpu_torch/build/``. Each phase
prints one JSON line; any failure exits non-zero. The last line is
``{"ok": true, "device": {...}}``. Without a card, or outside the repository,
it exits non-zero and prints no result.

Phases:

1. ``env``: the card, its power limit, TF32 off for matmul and cuDNN.
2. ``build``: compile ``csrc/rowdma.cu`` with ``nvcc``.
3. ``kernel``: each kernel at the main path's shapes (f32 and bf16; the
   in-table pull and push of 16,384 rows, the out-table ones of 18,432),
   bit-equal to its plain version, timed beside the plain version, one
   PyTorch library call and its bound (least bytes / the card's memory
   rate).
4. ``slice_parity``: 4 substeps of a small config with injected negative
   pools on the card and on the CPU; the tables agree within rtol 1e-5 /
   atol 1e-6 (reduction order), and two runs on the card are bit-identical.
5. ``train``: ``Word2VecTrainer`` -> ``TrainLoop.run`` at vocab 1,048,576,
   dim 200, batch 16,384, pool 64 per 512 pairs, f32 tables, lr 100 (see
   ``LR``); both kernels' launch counters, set to 0 just before, must read
   2 per substep after, and the loss must be finite and falling.
6. ``profile``: device time by kernel over 5 more train steps
   (``torch.profiler``) and the card's busy share of their wall time.
7. ``kernels``: one line for every ported kernel, with its launches in the
   ``train`` run and its numbers from phase 3.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# Peak device-memory rate by card (NVIDIA data sheets), bytes/s. The H100
# SXM figure is the default for an H100 that names no other form factor.
_MEM_RATE = (("H100 PCIe", 2.0e12), ("H100", 3.35e12))

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
N_TOKENS = 2_000_000
STEPS = 30
GATHER_ROWS = (BATCH, BATCH + (BATCH // POOL_BLOCK) * POOL_SIZE)  # in, out pulls
TIMED_RUNS = 25
ROW_SETS = 8  # rotated between timed runs so most rows come from HBM, not L2


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def mem_rate(name: str) -> float:
    for key, rate in _MEM_RATE:
        if key in name:
            return rate
    raise RuntimeError(f"no memory rate on record for {name!r}")


def zipf_ids(n: int, vocab: int, rng: np.random.Generator, s: float = 1.05) -> np.ndarray:
    """Zipf-ish ids over [0, vocab), as bench.py's synth_corpus draws them."""
    w = 1.0 / np.arange(1, vocab + 1, dtype=np.float64) ** s
    cdf = np.cumsum(w) / w.sum()
    return np.minimum(np.searchsorted(cdf, rng.random(n)), vocab - 1).astype(np.int32)


def time_ms(fn, runs: int = TIMED_RUNS) -> float:
    """Median device time of ``fn(i)`` over ``runs`` runs after a warm-up,
    by CUDA events. A sleep kernel ahead of each run keeps the card busy
    while the host enqueues, so host launch latency is not counted."""
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    times = []
    for i in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)
        start.record()
        fn(i)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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
           "tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
           "tf32_cudnn": torch.backends.cudnn.allow_tf32}
    emit("env", **env)
    return env


def phase_build() -> None:
    from swiftsnails_tpu_torch.ops import _build

    t0 = time.monotonic()
    result = _build.build("rowdma")
    ptxas = [ln.strip() for ln in result["log"].splitlines()
             if "registers" in ln or "spill" in ln]
    emit("build", seconds=time.monotonic() - t0, source="rowdma.cu",
         cached=result["cached"], ptxas=ptxas)


def _gather_case(table, rows_sets, rate):
    from swiftsnails_tpu_torch.ops import rowdma

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
    return {
        "kernel_ms": time_ms(lambda i: rowdma.gather_rows(table, pick(i))),
        "plain_ms": time_ms(lambda i: rowdma.gather_rows_plain(table, pick(i))),
        "library_ms": time_ms(lambda i: torch.index_select(table, 0, pick(i))),
        "bytes": nbytes, "distinct_rows": distinct,
        "bound_ms": nbytes / rate * 1e3, "max_abs_err": err,
    }


def _scatter_case(table, rows_sets, deltas_sets, n_valid, rate):
    from swiftsnails_tpu_torch.ops import rowdma

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


def _small_trainer(device, seed):
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
                  "pool_block": str(POOL_BLOCK), "seed": str(seed)})
    return Word2VecTrainer(cfg, corpus_ids=ids, vocab=Vocab(
        [f"w{i}" for i in range(v)], counts), device=device)


def phase_slice_parity(seed: int) -> None:
    from swiftsnails_tpu_torch import convert

    cpu = _small_trainer("cpu", seed)
    cuda = _small_trainer("cuda", seed)
    init = cpu.init_state()
    tables = [t.table.numpy().copy() for t in init]
    batches = [b for _, b in zip(range(4), cpu.batches())]
    rng = np.random.default_rng(seed + 1)
    _, nb = cpu.pool_geometry(2048)
    pools = [rng.integers(0, 4096, (nb, POOL_SIZE)).astype(np.int32) for _ in batches]

    def run(tr, device):
        state = convert.w2v_state_from_numpy(*tables, device=device)
        gen = torch.Generator(device=device)
        losses = []
        for batch, pool in zip(batches, pools):
            state, loss = tr._substep_packed(
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
    emit("slice_parity", substeps=len(batches), max_abs_err_vs_cpu=worst,
         losses_cuda=l_gpu, losses_cpu=l_cpu, repeat_bit_identical=True)


def phase_train(seed: int, device_name: str, smi: str):
    from swiftsnails_tpu_torch.data import sampler
    from swiftsnails_tpu_torch.data.vocab import Vocab
    from swiftsnails_tpu_torch.framework.trainer import TrainLoop
    from swiftsnails_tpu_torch.models.word2vec import Word2VecTrainer
    from swiftsnails_tpu_torch.ops import rowdma
    from swiftsnails_tpu_torch.utils.config import Config
    from swiftsnails_tpu_torch.utils.metrics import MetricsLogger

    t0 = time.monotonic()
    rng = np.random.default_rng(seed)
    ids = zipf_ids(N_TOKENS, VOCAB, rng)
    counts = np.maximum(np.bincount(ids, minlength=VOCAB), 1)
    vocab = Vocab([f"w{i}" for i in range(VOCAB)], counts)
    pairs, _ = sampler.skipgram_pairs(ids[: 1 << 20], WINDOW, np.random.default_rng(seed))
    pairs_per_token = len(pairs) / (1 << 20)
    cfg = Config({"dim": str(DIM), "window": str(WINDOW),
                  "negatives": str(NEGATIVES), "learning_rate": str(LR),
                  "batch_size": str(BATCH), "subsample": "0", "num_iters": "1",
                  "pool_size": str(POOL_SIZE), "pool_block": str(POOL_BLOCK),
                  "table_dtype": "float32", "seed": str(seed)})
    trainer = Word2VecTrainer(cfg, corpus_ids=ids, vocab=vocab)
    records = []

    class Recorder(MetricsLogger):
        def log(self, record):
            records.append(record)

    loop = TrainLoop(trainer, metrics=Recorder(), log_every=1)
    setup_s = time.monotonic() - t0
    rowdma.gather_rows.launches = 0
    rowdma.scatter_add_rows.launches = 0
    state = loop.run(seed=seed, max_steps=STEPS)
    launches = {"gather_rows": rowdma.gather_rows.launches,
                "scatter_add_rows": rowdma.scatter_add_rows.launches}
    substeps = len(records) * trainer.steps_per_call
    for name, n in launches.items():
        if n != 2 * substeps:
            raise AssertionError(f"{name}: {n} launches for {substeps} substeps")
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
    out = {"steps": len(records), "substeps": substeps, "launches": launches,
           "setup_s": setup_s, "first_step_ms": records[0]["seconds"] * 1e3,
           "step_ms_median": statistics.median(step_ms),
           "pairs_per_sec": items / seconds,
           "words_per_sec": items / seconds / pairs_per_token,
           "pairs_per_token": pairs_per_token,
           "loss_first5": losses[:5], "loss_last5": losses[-5:],
           "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           "device": device_name, "nvidia_smi": smi}
    emit("train", **out)
    return out, trainer, state


def phase_profile(trainer, state, seed: int, steps: int = 5) -> None:
    """Device time by kernel over ``steps`` more train steps, by
    ``torch.profiler``, and the card's busy share of their wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from swiftsnails_tpu_torch.framework.trainer import step_generator

    dev = torch.device("cuda")
    it = iter(trainer.batches())
    batches = [{k: torch.from_numpy(v).to(dev) if np.ndim(v) else v
                for k, v in next(it).items()} for _ in range(steps + 1)]
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
    emit("profile", steps=steps, wall_ms_per_step=wall_ms / steps,
         device_ms_per_step=busy_ms, device_busy_share=busy_ms * steps / wall_ms,
         kernels_per_step=sum(n for _, _, n in kernels),
         top=[{"kernel": k[:90], "ms_per_step": ms, "launches_per_step": n}
              for k, ms, n in kernels[:14]])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test needs "
              "a CUDA card", file=sys.stderr)
        return 2
    import swiftsnails_tpu_torch  # noqa: F401  fails outside the repository

    env = phase_env()
    phase_build()
    summary = phase_kernels(args.seed, env["mem_rate_Bps"])
    phase_slice_parity(args.seed)
    train, trainer, state = phase_train(args.seed, env["device"], env["nvidia_smi"])
    phase_profile(trainer, state, args.seed)
    del trainer, state
    kernels = []
    for name, replaces in (
            ("gather_rows", "swiftsnails_tpu/ops/rowdma.py:114"),
            ("scatter_add_rows", "swiftsnails_tpu/ops/rowdma.py:213")):
        s = summary[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "swiftsnails_tpu_torch/csrc/rowdma.cu",
            "replaces": replaces, "launches": train["launches"][name],
            "max_abs_err": s["max_abs_err"], "ms": s["kernel_ms"],
            "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
            "bound_by": "bytes", "library_ms": s["library_ms"],
            "shape": s["shape"], "dtype": "float32"})
    emit("kernels", kernels=kernels)
    print(json.dumps({"kernels": kernels}))
    print(env["nvidia_smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
