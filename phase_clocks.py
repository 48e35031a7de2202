"""Where a CTA of the two hogwild SGNS kernels spends its time, on one NVIDIA GPU.

    python3 phase_clocks.py [--seed N] [--calls 5]

Builds ``swiftsnails_tpu_torch/csrc/fused_sgns.cu`` a second time with
``-DSSN_PHASE_CLOCKS`` (thread 0 of each CTA adds the clock64 cycles since
its last mark to its phase's total; the marks add no barrier, see the
source's note), points the port's wrappers at that build for the run, and
drives ``fused_sgns_step`` and ``fused_sgns_grouped_step`` at the main shape
of ``chip_smoke.py`` on zipf ids (f32 tables of 2^20 rows of 256 lanes, dim
200, pools of 64; 16,384 pairs in blocks of 512, or 8,192 centers of 10
slots in blocks of 256). Prints one JSON line a kernel: the cycles a CTA a
call and each phase's share of them, the products' share (scores, dQ and
dV) among them, then the card's name and power limit. The clocked build is
a measurement of its own: ``chip_smoke.py`` and the package never load it.
Run from the root of the repository on a machine with a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import tempfile
from pathlib import Path
from unittest import mock

import numpy as np
import torch

import chip_smoke as cs

# enum Phase of csrc/fused_sgns.cu, in order
PHASES = ("fill", "scores", "grad", "pos", "dq", "dv", "round_barrier", "write", "finish")
PRODUCTS = ("scores", "dq", "dv")
_ENTRY_POINTS = ("ssn_fused_sgns_tile", "ssn_fused_sgns_step", "ssn_fused_sgns_grouped_step",
                 "ssn_fused_sgns_plan", "ssn_fused_sgns_error_string")


def clocked_library(out_dir: Path) -> ctypes.CDLL:
    """``fused_sgns.cu`` built with SSN_PHASE_CLOCKS, with the entry points
    bound as the package binds its own build (which this builds too)."""
    from swiftsnails_tpu_torch.ops import _build, fused_sgns

    lib_path = out_dir / "libfused_sgns_phase_clocks.so"
    proc = subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-DSSN_PHASE_CLOCKS", "-o", str(lib_path),
         str(_build.CSRC_DIR / "fused_sgns.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    plain = fused_sgns._lib()  # the package's build, compiled meanwhile if need be
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc rc={proc.returncode}:\n{log}")
    lib = ctypes.CDLL(str(lib_path))
    for name in _ENTRY_POINTS:
        mine, theirs = getattr(lib, name), getattr(plain, name)
        mine.argtypes, mine.restype = theirs.argtypes, theirs.restype
    lib.ssn_fused_sgns_phase_clocks.argtypes = [ctypes.POINTER(ctypes.c_ulonglong),
                                                ctypes.c_int]
    lib.ssn_fused_sgns_phase_clocks.restype = ctypes.c_int
    return lib


def read_clocks(lib) -> dict:
    """The phase totals since the last read (synchronises the card), zeroed."""
    out = (ctypes.c_ulonglong * len(PHASES))()
    rc = lib.ssn_fused_sgns_phase_clocks(out, 0)
    if rc != 0:
        raise RuntimeError(f"ssn_fused_sgns_phase_clocks: CUDA error {rc}")
    return dict(zip(PHASES, out))


def measure(lib, kind: str, tables, rng, calls: int) -> dict:
    from swiftsnails_tpu_torch.ops import fused_sgns

    fn, _, kw = cs._fused_call(kind)
    id_sets = [cs._fused_ids(kind, False, rng) for _ in range(cs.ROW_SETS)]
    grouped = kind == "grouped"
    nb = cs.GROUPED_BATCH // cs.CENTERS_PER_BLOCK if grouped else cs.BATCH // cs.POOL_BLOCK
    with mock.patch.object(fused_sgns, "_lib", lambda: lib):
        plan = fused_sgns.cluster_plan(grouped, nb,
                                       cs.CENTERS_PER_BLOCK if grouped else cs.POOL_BLOCK,
                                       cs.CW if grouped else 0, cs.POOL_SIZE, tables[0])
        fn(*tables, *id_sets[0].values(), **kw)  # warm-up
        read_clocks(lib)
        for i in range(calls):
            fn(*tables, *id_sets[i % len(id_sets)].values(), **kw)
        clocks = read_clocks(lib)
    total = sum(clocks.values())
    share = {k: v / total for k, v in clocks.items()}
    return {"kernel": fn.__name__, "calls": calls, "cluster": plan["cluster"],
            "ctas": plan["ctas"], "cycles_per_cta_call": total / calls / plan["ctas"],
            "share": share, "products_share": sum(share[k] for k in PRODUCTS)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--calls", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("phase_clocks: needs a CUDA card")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    shape = (cs.VOCAB, -(-cs.DIM // 128), 128)
    lanes = (torch.arange(shape[1] * 128, device=dev) < cs.DIM).view(shape[1:])
    tables = [torch.randn(shape, generator=gen, device=dev).mul_(0.1).mul_(lanes)
              for _ in range(2)]
    rng = np.random.default_rng(args.seed)
    with tempfile.TemporaryDirectory() as tmp:
        lib = clocked_library(Path(tmp))
        for kind in ("flat", "grouped"):
            print(json.dumps(measure(lib, kind, tables, rng, args.calls)), flush=True)
    print(cs.phase_env()["nvidia_smi"])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
