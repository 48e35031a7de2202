"""Bulk-copy completion probes on the card: how many bytes a copy accounts
for on an ``mbarrier``, whether one armed phase retires a chunk of scattered
row copies, and what waiting once a chunk saves over waiting once a copy.

The port's counterpart of the JAX package's ``tools/sem_probe.py``, which
asks the same of the TPU's DMA semaphores. Experiments, in its order
(``ops/sem_probe.py`` says how each kernel shows what it shows):

  1. unit: for each of ``f32[1,128]``, ``f32[2,128]``, ``f32[4,128]``,
     ``f32[8,2,128]`` and ``bf16[2,128]``, the bytes one copy accounts for,
     with the exact, over-armed and (8 rows) additivity verdicts, held
     against the plain version's. Stops here unless the 8-row copy
     accounts for 8 single rows.
  2. chunk: 64 scattered rows of ``x[4096, S, 128]`` f32 (``S = ceil(dim /
     128)``) gathered through one phase armed with their bytes; the rows
     must equal ``x[rows]`` and the flag the armed bytes. Stops here on
     ``--quick``, a failed flag or a gather error.
  3. pipe: ``x[100,000, S, 128]`` f32, 64 blocks of 1,856 ids, per-copy
     against chunked (64 rows) waits; both must equal the plain version and
     repeat bit for bit. Timed beside ``index_select`` and the port's
     ``gather_rows`` on the same ids. Reports the launch geometry as the
     library gives it (``pipe_plan``; ``chunk_plan`` for experiment 2): the
     cluster of G CTAs a block, the CTAs, the ring's stages, the threads a
     CTA and the lanes that issue, and ns a copy a CTA over the K / G
     copies each CTA of a block takes.

    python -m swiftsnails_tpu_torch.tools.sem_probe [--quick] [--dim 200] [--device cpu]

Without ``--device`` it runs on the card and raises if there is none;
``--device cpu`` runs the plain versions, whose times are host times. It
prints the JAX tool's lines, then one JSON line per experiment
(``{"experiment": ...}``), and exits 1 if a check failed. :func:`main`
returns the results. Data comes from numpy's generator at seed 0, as in the
JAX tool; the pipe's table is drawn once for both variants.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from swiftsnails_tpu_torch.ops import rowdma, sem_probe
from swiftsnails_tpu_torch.utils.device import resolve_device
from swiftsnails_tpu_torch.utils.metrics import time_ms

TAGS = ((1, 1, torch.float32, "f32[1,128]"), (1, 2, torch.float32, "f32[2,128]"),
        (1, 4, torch.float32, "f32[4,128]"), (8, 2, torch.float32, "f32[8,2,128]"),
        (1, 2, torch.bfloat16, "bf16[2,128]"))
CH = sem_probe.CHUNK_ROWS
V = 4096  # the chunk's table rows
# The pipe's shape (the JAX tool's); read when the pipe runs, so a test can
# shrink it.
K = 1856  # copies a block (the bench shape's, docs/ARCHITECTURE.md)
B = 64  # blocks
VB = 100_000  # the pipe's table rows


def _emit(experiment: str, **fields) -> None:
    print(json.dumps({"experiment": experiment, **fields}), flush=True)


def _unit(rows: int, s: int, dtype, dev) -> dict:
    """One tag's fields from the card and from the plain version, and
    whether every verdict agrees."""
    x = torch.ones((max(rows, 8), s, 128), dtype=dtype, device=dev)
    got = sem_probe.unit_fields(sem_probe.unit_probe(x, rows))
    want = sem_probe.unit_fields(sem_probe.unit_probe_plain(x, rows))
    held = all(got[k] == want[k] for k in sem_probe.UNIT_FIELDS
               if k not in sem_probe.UNIT_TIMES)
    return {**got, "plain_unit": want["unit"], "held": held}


def _bytes(x: torch.Tensor, ids: torch.Tensor, out_bytes: int) -> int:
    """Least bytes of a gather-like probe: each distinct row read once, the
    ids read once, the output written once."""
    row_bytes = x.stride(0) * x.element_size()
    return int(torch.unique(ids).numel()) * row_bytes + 4 * ids.numel() + out_bytes


def experiment_unit(dim: int, dev) -> dict:
    units, tags = {}, {}
    for rows, s, dtype, tag in TAGS:
        f = tags[tag] = _unit(rows, s, dtype, dev)
        units[tag] = f["unit"]
        add = ("" if rows == 1 else
               f"; {rows} single rows complete: {bool(f['singles_done'])}, "
               f"{rows - 1} pending: {not f['partial_done']}")
        print(f"unit probe {tag:>12}: bytes accounted = {f['unit']} (exact arming "
              f"complete in {f['exact_polls']} polls, {f['exact_cycles']} cycles, "
              f"{f['exact_ns']} ns; +16 B pending: {not f['over_done']}{add})",
              flush=True)
    if len(set(units.values())) == 1:
        print("=> every copy accounts the same whatever its size; chunked "
              "waits would retire too much — NOT usable", flush=True)
    linear = units["f32[8,2,128]"] > 0 and \
        units["f32[8,2,128]"] == 8 * units["f32[2,128]"] and \
        tags["f32[8,2,128]"]["held"]
    print(f"=> row-additive increments: {linear}", flush=True)
    s = -(-dim // 128)
    row_tag = f"f32[{s},128]"
    if row_tag not in tags:
        tags[row_tag] = _unit(1, s, torch.float32, dev)
    u_row = tags[row_tag]["unit"]
    print(f"row unit {row_tag}: {u_row}", flush=True)
    x = torch.ones((8, s, 128), device=dev)
    row_bytes = x.stride(0) * x.element_size()
    res = {"tags": tags, "linear": linear, "row_tag": row_tag, "row_unit": u_row,
           "ok": linear and all(t["held"] for t in tags.values()),
           "ms": time_ms(lambda i: sem_probe.unit_probe(x, 1), device=dev),
           "plain_ms": time_ms(lambda i: sem_probe.unit_probe_plain(x, 1), device=dev),
           # what the timed one-row probe moves: row 0 copied exactly and
           # over-armed, the 16-byte drain, and the fields written
           "bytes": 2 * row_bytes + 16 + 8 * len(sem_probe.UNIT_FIELDS)}
    _emit("unit", **res)
    return res


def experiment_chunk(s: int, rng, dev) -> dict:
    x = torch.from_numpy(rng.random((V, s, 128), dtype=np.float32)).to(dev)
    ids = torch.from_numpy(rng.integers(0, V, CH).astype(np.int32)).to(dev)
    out, stats = sem_probe.chunk_probe(x, ids)
    want, want_stats = sem_probe.chunk_probe_plain(x, ids)
    flag, polls, cycles, ns = (int(v) for v in stats.cpu())
    expected = int(want_stats[0])
    err = float((out - want).abs().max())
    equal = bool(torch.equal(out, want))
    print(f"chunk wait: observed={abs(flag)} expected={expected} "
          f"one-shot={'YES' if flag > 0 else 'NO (not complete within the poll bound)'} "
          f"gather max err={err}", flush=True)
    res = {"flag": flag, "expected": expected, "polls": polls, "cycles": cycles,
           "ns": ns, "max_abs_err": err, "bit_equal": equal,
           "ok": flag == expected and equal,
           "ms": time_ms(lambda i: sem_probe.chunk_probe(x, ids), device=dev),
           "plain_ms": time_ms(lambda i: sem_probe.chunk_probe_plain(x, ids), device=dev),
           "library_ms": time_ms(lambda i: x.index_select(0, ids), device=dev),
           "bytes": _bytes(x, ids, out.numel() * out.element_size() + stats.numel() * 8),
           "shape": list(x.shape), "rows": CH, **sem_probe.chunk_plan(x)}
    _emit("chunk", **res)
    return res


def experiment_pipe(s: int, rng, dev) -> dict:
    blocks, copies, vocab = B, K, VB
    ids = torch.from_numpy(
        rng.integers(0, vocab, (blocks, copies)).astype(np.int32).reshape(-1)).to(dev)
    x = torch.from_numpy(rng.random((vocab, s, 128), dtype=np.float32)).to(dev)
    want = sem_probe.pipe_probe_plain(x, ids, blocks)
    slot0 = x[int(ids[(blocks - 1) * copies]), 0, 0].view(torch.int32)
    plan = sem_probe.pipe_plan(x, ids, blocks, True)
    res = {"blocks": blocks, "copies": copies, "shape": list(x.shape),
           "stages": plan["stages"], "threads": plan["threads"],
           "issuing_lanes": plan["issuing_lanes"], "consumer_warps": plan["consumer_warps"],
           "slot0_matches_tpu_output": bool(want[blocks - 1, 0] == slot0)}
    n = blocks * copies
    for chunked, name in ((False, "per_copy"), (True, "chunked")):
        plan = sem_probe.pipe_plan(x, ids, blocks, chunked)
        # the plain version runs no cluster: one "CTA" a block
        g = plan["cluster"] or 1
        got = [sem_probe.pipe_probe(x, ids, blocks, chunked) for _ in range(2)]
        ms = time_ms(lambda i: sem_probe.pipe_probe(x, ids, blocks, chunked), device=dev)
        # over the int32 slots, as int64 so that no difference wraps
        err = int((got[0].long() - want.long()).abs().max())
        res[name] = {"ms": ms, "us_per_block": ms * 1e3 / blocks, "ns_per_copy": ms * 1e6 / n,
                     "ns_per_copy_per_cta": ms * 1e6 * g / copies, "max_abs_err": err,
                     "cluster": plan["cluster"], "ctas": plan["ctas"],
                     "active_by_cluster": plan["active_by_cluster"],
                     "bit_equal": bool(torch.equal(got[0], want)),
                     "repeatable": bool(torch.equal(got[0], got[1]))}
        print(f"{'chunked' if chunked else 'per-copy'} wait: {ms:.4f} ms/call  "
              f"{ms * 1e3 / blocks:.3f} us/block  {ms * 1e6 / n:.3f} ns/copy  "
              f"(a cluster of {g} CTAs a block, {blocks * g} CTAs, {plan['stages']} "
              f"stages: {ms * 1e6 * g / copies:.1f} ns/copy a CTA)", flush=True)
    speedup = res["per_copy"]["ms"] / res["chunked"]["ms"]
    print(f"chunked-wait speedup on DMA pipeline: {speedup:.2f}x", flush=True)
    row_bytes = x.stride(0) * x.element_size()
    res.update(
        speedup=speedup,
        max_abs_err=max(res[v]["max_abs_err"] for v in ("per_copy", "chunked")),
        ok=res["slot0_matches_tpu_output"] and all(
            res[v]["bit_equal"] and res[v]["repeatable"] for v in ("per_copy", "chunked")),
        plain_ms=time_ms(lambda i: sem_probe.pipe_probe_plain(x, ids, blocks), device=dev),
        index_select_ms=time_ms(lambda i: x.index_select(0, ids), device=dev),
        gather_rows_ms=time_ms(lambda i: rowdma.gather_rows(x, ids), device=dev),
        bytes=_bytes(x, ids, 8 * blocks), copy_bytes=n * row_bytes)
    _emit("pipe", **res)
    return res


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--quick", action="store_true", help="stop after the chunk wait")
    p.add_argument("--dim", type=int, default=200)
    p.add_argument("--device", default=None, help="default: the card; cpu: plain")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"devices: {name}", flush=True)
    res = {"device": name}
    try:
        res["unit"] = experiment_unit(args.dim, dev)
        res["ok"] = res["unit"]["ok"]
        if not res["unit"]["linear"]:
            print("=> completions are not row-additive; chunked waits are unsound "
                  "on this card — stopping before experiment 2", flush=True)
            return res
        rng = np.random.default_rng(0)
        s = -(-args.dim // 128)
        res["chunk"] = chunk = experiment_chunk(s, rng, dev)
        res["ok"] = res["ok"] and chunk["ok"]
        if args.quick or chunk["flag"] <= 0 or chunk["max_abs_err"] != 0.0:
            return res
        res["pipe"] = experiment_pipe(s, rng, dev)
        res["ok"] = res["ok"] and res["pipe"]["ok"]
        return res
    except RuntimeError as e:
        code = sem_probe.deadline_status() if dev.type == "cuda" else 0
        if code:
            raise RuntimeError(f"a probe's wait passed its deadline (code {code}: "
                               f"{sem_probe.DEADLINE_CODES.get(code)})") from e
        raise


if __name__ == "__main__":
    sys.exit(0 if main()["ok"] else 1)
