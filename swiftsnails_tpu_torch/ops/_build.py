"""Build the port's CUDA C++ kernels at first use, from the package's sources.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface, loaded with ``ctypes``; the sources may include the
shared headers ``csrc/*.cuh``. The library lives in
``swiftsnails_tpu_torch/build/`` under a name that carries a hash of the
source, the headers and the flags, so an edited source or header builds anew
and an unchanged one is reused. A missing ``nvcc`` or a failed build raises: there is no
fallback.

Nothing here runs at import time; the tests on a CPU-only machine import
this module without a CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills, kept in the log
)


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else the default
    toolkit location; raise if none exists."""
    candidates = [os.environ.get(k) for k in ("CUDA_HOME", "CUDA_PATH")]
    for root in candidates:
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.is_file():
        return str(default)
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the port's kernels are CUDA C++ "
        "built at first use and have no fallback")


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> Dict:
    """Compile ``csrc/<name>.cu`` unless it is built already.

    Returns ``{"seconds", "cached", "log"}``; ``log`` is nvcc's output
    (ptxas register and spill lines). Raises on any failure.
    """
    return build_all([name])[name]


def build_all(names) -> Dict[str, Dict]:
    """:func:`build` for several sources at once: one ``nvcc`` for each
    source not built yet, all started together. Returns ``{name: result}``
    and raises on the first failure, after every compiler has ended."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.monotonic()
    procs, results = {}, {}
    for name in names:
        lib = library_path(name)
        if lib.is_file():
            results[name] = {"seconds": 0.0, "cached": True, "log": ""}
            continue
        tmp = lib.with_name(f".{lib.name}.{os.getpid()}.tmp")
        procs[name] = (lib, tmp, subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (lib, tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{name}.cu (nvcc rc={proc.returncode}):\n{log}")
            continue
        os.replace(tmp, lib)  # atomic: a concurrent build sees all or none
        results[name] = {"seconds": time.monotonic() - t0, "cached": False, "log": log}
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return results


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``, building it if needed."""
    lib = library_path(name)
    if not lib.is_file():
        build(name)
    return ctypes.CDLL(str(lib))
