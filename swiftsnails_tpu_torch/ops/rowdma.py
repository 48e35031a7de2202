"""Row gather and row scatter-add on packed tables — the parameter server's pull and push.

Counterpart of the JAX package's ``ops/rowdma.py``. Layout: a packed table
of shape ``[capacity, S, 128]`` (``S = ceil(dim / 128)``), one row per key,
with zero padding lanes. The layout is kept so that the port's tables and
pulled rows compare like with like against the JAX package's and carry over
by a plain copy; the kernels take the row width as an argument and assume
no 128 (any contiguous ``[C, ...]`` table whose rows and base addresses are
multiples of 16 bytes works; the wrappers raise on others), so a later
change may drop the padding without touching them.

Each kernel has, beside it here:

* a wrapper that checks device, dtype, shape and contiguity, and raises on
  anything else. For a tensor on the CPU it runs the plain PyTorch version;
  for a CUDA tensor it launches the CUDA C++ kernel
  (``csrc/rowdma.cu``, built at first use by :mod:`._build`) on the current
  stream, or raises. There is no fallback from a failed build or launch.
* a launch counter, a plain integer on the wrapper (``gather_rows.launches``,
  ``scatter_add_rows.launches``), raised by one where the kernel is launched
  and nowhere else;
* the plain version (``*_plain``), which the CPU path and the tests use and
  which ``chip_smoke.py`` holds the kernel against on the card.

:func:`gather_rows` replaces the TPU kernel ``gather_rows`` /
``_gather_kernel`` of the JAX package's ``ops/rowdma.py``: one row DMA per id,
double-buffered across blocks. :func:`scatter_add_rows` replaces
``scatter_add_rows`` / ``_scatter_kernel`` there: a read-modify-write of each
row, two blocks deep, in place on the donated table. Both are bound by
device-memory bytes on the H100 (a row read and written, or read, added and
written, with no arithmetic to speak of); the kernels put one warp on each
row and move it in 16-byte words so that many independent random rows are in
flight at once. ``csrc/rowdma.cu`` says more.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from swiftsnails_tpu_torch.ops import _build

ROW_LANES = 128
_DTYPES = (torch.float32, torch.bfloat16)
_WORD_BYTES = 16  # the kernels' unit of movement


def packed_shape(capacity: int, dim: int):
    """[capacity, S, 128] shape for a logical [capacity, dim] table."""
    s = -(-dim // ROW_LANES)
    return (capacity, s, ROW_LANES)


def pack_rows(rows2d: torch.Tensor) -> torch.Tensor:
    """[N, dim] -> [N, S, 128] with zero padding lanes."""
    n, dim = rows2d.shape
    s = -(-dim // ROW_LANES)
    pad = s * ROW_LANES - dim
    if pad:
        rows2d = F.pad(rows2d, (0, pad))
    return rows2d.reshape(n, s, ROW_LANES)


def unpack_rows(rows3d: torch.Tensor, dim: int) -> torch.Tensor:
    """[N, S, 128] -> [N, dim]."""
    n = rows3d.shape[0]
    return rows3d.reshape(n, -1)[:, :dim]


# ------------------------------------------------------------- checks ---


def _check_table(name: str, table: torch.Tensor) -> None:
    if table.dtype not in _DTYPES:
        raise TypeError(f"{name}: table dtype {table.dtype} not in {_DTYPES}")
    if table.dim() < 2:
        raise ValueError(f"{name}: table must be [C, ...], got {tuple(table.shape)}")
    if not table.is_contiguous():
        raise ValueError(f"{name}: table must be contiguous")
    if table.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {table.device}")


def _check_rows(name: str, rows: torch.Tensor, table: torch.Tensor) -> None:
    if rows.dtype != torch.int32:
        raise TypeError(f"{name}: rows must be int32, got {rows.dtype}")
    if rows.dim() != 1 or not rows.is_contiguous():
        raise ValueError(f"{name}: rows must be a contiguous 1-D tensor")
    if rows.device != table.device:
        raise ValueError(
            f"{name}: rows on {rows.device}, table on {table.device}")


def _check_words(name: str, table: torch.Tensor, other: torch.Tensor) -> int:
    """Row bytes of ``table``; the kernels move 16-byte words, so the row
    and both base addresses must be multiples of 16 bytes."""
    row_bytes = table.stride(0) * table.element_size()
    if (row_bytes | table.data_ptr() | other.data_ptr()) % _WORD_BYTES:
        raise ValueError(
            f"{name}: rows of {row_bytes} B at 0x{table.data_ptr():x} / "
            f"0x{other.data_ptr():x} are not in {_WORD_BYTES}-byte words")
    return row_bytes


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("rowdma")
    vp, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.ssn_gather_rows.argtypes = [vp, vp, vp, ll, ll, ll, i32, vp]
    lib.ssn_gather_rows.restype = i32
    lib.ssn_scatter_add_rows.argtypes = [vp, vp, vp, ll, ll, ll, i32, i32, vp]
    lib.ssn_scatter_add_rows.restype = i32
    lib.ssn_error_string.argtypes = [i32]
    lib.ssn_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(name: str, rc: int) -> None:
    if rc != 0:
        msg = _lib().ssn_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} ({msg})")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# ------------------------------------------------------------- gather ---


def gather_rows_plain(table: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``table[rows]``: the plain version of :func:`gather_rows`."""
    return table.index_select(0, rows)


def gather_rows(table: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``table[rows]`` for a table ``[C, ...]`` -> ``[N, ...]``.

    ``rows`` are int32 ids in ``[0, C)``; any ``N`` works. On the card an id
    outside ``[0, C)`` reads nothing and yields a row of zeros; the plain
    version raises on one.
    """
    _check_table("gather_rows", table)
    _check_rows("gather_rows", rows, table)
    if table.device.type == "cpu":
        return gather_rows_plain(table, rows)
    n, c = rows.shape[0], table.shape[0]
    out = torch.empty((n,) + tuple(table.shape[1:]), dtype=table.dtype,
                      device=table.device)
    row_bytes = _check_words("gather_rows", table, out)
    rc = _lib().ssn_gather_rows(
        table.data_ptr(), rows.data_ptr(), out.data_ptr(), n, c, row_bytes,
        table.device.index or 0, _stream(table))
    _raise_on("gather_rows", rc)
    if n:
        gather_rows.launches += 1
    return out


gather_rows.launches = 0


# -------------------------------------------------------- scatter-add ---


def scatter_add_rows_plain(table: torch.Tensor, rows: torch.Tensor,
                           deltas: torch.Tensor) -> torch.Tensor:
    """The plain version of :func:`scatter_add_rows` (in place)."""
    valid = (rows >= 0) & (rows < table.shape[0])
    idx = rows[valid]
    table.index_put_((idx,), table.index_select(0, idx) + deltas[valid])
    return table


def scatter_add_rows(table: torch.Tensor, rows: torch.Tensor,
                     deltas: torch.Tensor) -> torch.Tensor:
    """``table[rows] += deltas`` in place for UNIQUE rows; returns ``table``.

    Rows outside ``[0, C)`` are padding: skipped, their deltas not read.
    Uniqueness is the caller's contract (``store.push_packed`` merges
    duplicates first); the kernel uses no atomics. The add is in f32 with
    one rounding to the table's dtype. In place where the JAX package
    donated the table buffer.
    """
    _check_table("scatter_add_rows", table)
    _check_rows("scatter_add_rows", rows, table)
    want = (rows.shape[0],) + tuple(table.shape[1:])
    if tuple(deltas.shape) != want:
        raise ValueError(
            f"scatter_add_rows: deltas {tuple(deltas.shape)} != {want}")
    if deltas.dtype != table.dtype or deltas.device != table.device:
        raise TypeError(
            f"scatter_add_rows: deltas {deltas.dtype} on {deltas.device}, "
            f"table {table.dtype} on {table.device}")
    if not deltas.is_contiguous():
        raise ValueError("scatter_add_rows: deltas must be contiguous")
    if table.device.type == "cpu":
        return scatter_add_rows_plain(table, rows, deltas)
    n, c = rows.shape[0], table.shape[0]
    row_bytes = _check_words("scatter_add_rows", table, deltas)
    rc = _lib().ssn_scatter_add_rows(
        table.data_ptr(), rows.data_ptr(), deltas.data_ptr(), n, c, row_bytes,
        table.element_size(), table.device.index or 0, _stream(table))
    _raise_on("scatter_add_rows", rc)
    if n:
        scatter_add_rows.launches += 1
    return table


scatter_add_rows.launches = 0
