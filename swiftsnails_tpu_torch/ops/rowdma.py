"""The row kernels of packed tables — the parameter server's pull and pushes.

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
  ``scatter_add_rows.launches``, ...), raised by one where the kernel is
  launched and nowhere else;
* the plain version (``*_plain``), which the CPU path and the tests use and
  which ``chip_smoke.py`` holds the kernel against on the card.

:func:`gather_rows` replaces the TPU kernel ``gather_rows`` /
``_gather_kernel`` of the JAX package's ``ops/rowdma.py``: one row DMA per id,
double-buffered across blocks. :func:`scatter_add_rows` replaces
``scatter_add_rows`` / ``_scatter_kernel`` there: a read-modify-write of each
row, two blocks deep, in place on the donated table. Both are bound by
device-memory bytes on the H100 (a row read and written, or read, added and
written, with no arithmetic to speak of); the kernels move rows in 16-byte
words, four rows a warp in the gather and one in the scatter, so that many
independent random rows are in flight at once. ``csrc/rowdma.cu`` says more.

The pushes of the other access rules: :func:`scatter_write_rows` replaces
``scatter_write_rows`` / ``_write_kernel`` (the write half of gather ->
access rule -> write), :func:`scatter_adagrad_rows` replaces
``scatter_adagrad_rows`` / ``_adagrad_kernel`` (AdaGrad on a table and its
accumulator, two buffers of one layout) and
:func:`scatter_adagrad_fused_rows` replaces ``scatter_adagrad_fused_rows`` /
``_adagrad_fused_kernel`` (AdaGrad on ``[C, 2, 128]`` tiles, sublane 0 the
param and sublane 1 the accumulator). All three take unique rows, skip ids
outside ``[0, C)`` and update in place where the JAX package donated the
buffers. The AdaGrad pair rounds the gradient to the table's dtype first, as
the TPU wrappers do, then computes in f32, one rounding an operation
(``accum + g * g``, then ``param - lr * g * rsqrt(accum + eps)``), and
rounds param and accumulator once each: the plain versions and the kernels
agree bit for bit.
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


def _check_rows_of(name: str, what: str, table: torch.Tensor, t: torch.Tensor,
                   shape) -> None:
    """``t`` (values or gradients) is ``shape``, of the table's dtype and
    device, and contiguous."""
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: {what} {tuple(t.shape)} != {tuple(shape)}")
    if t.dtype != table.dtype or t.device != table.device:
        raise TypeError(f"{name}: {what} {t.dtype} on {t.device}, "
                        f"table {table.dtype} on {table.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: {what} must be contiguous")


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("rowdma")
    vp, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.ssn_gather_rows.argtypes = [vp, vp, vp, ll, ll, ll, i32, vp]
    lib.ssn_gather_rows.restype = i32
    lib.ssn_scatter_add_rows.argtypes = [vp, vp, vp, ll, ll, ll, i32, i32, vp]
    lib.ssn_scatter_add_rows.restype = i32
    lib.ssn_scatter_write_rows.argtypes = [vp, vp, vp, ll, ll, ll, i32, vp]
    lib.ssn_scatter_write_rows.restype = i32
    f32 = ctypes.c_float
    lib.ssn_scatter_adagrad_rows.argtypes = [vp, vp, vp, vp, ll, ll, ll, i32, f32, f32,
                                             i32, vp]
    lib.ssn_scatter_adagrad_rows.restype = i32
    lib.ssn_scatter_adagrad_fused_rows.argtypes = [vp, vp, vp, ll, ll, ll, i32, f32, f32,
                                                   i32, vp]
    lib.ssn_scatter_adagrad_fused_rows.restype = i32
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
    _check_rows_of("scatter_add_rows", "deltas", table, deltas,
                   (rows.shape[0],) + tuple(table.shape[1:]))
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


def _as_table_dtype(name: str, grads: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """The gradient in the table's dtype, as the TPU wrappers cast it (in
    bf16 that rounds it once, before the update)."""
    if grads.dtype not in _DTYPES:
        raise TypeError(f"{name}: grads dtype {grads.dtype} not in {_DTYPES}")
    return grads.to(table.dtype)


# ------------------------------------------------------- scatter-write ---


def scatter_write_rows_plain(table: torch.Tensor, rows: torch.Tensor,
                             values: torch.Tensor) -> torch.Tensor:
    """The plain version of :func:`scatter_write_rows` (in place)."""
    valid = (rows >= 0) & (rows < table.shape[0])
    table.index_put_((rows[valid],), values[valid])
    return table


def scatter_write_rows(table: torch.Tensor, rows: torch.Tensor,
                       values: torch.Tensor) -> torch.Tensor:
    """``table[rows] = values`` in place for UNIQUE rows; returns ``table``.

    The write half of a gather -> access rule -> write push. Rows outside
    ``[0, C)`` are padding: skipped, their values not read. ``values`` has
    the table's dtype and row shape.
    """
    _check_table("scatter_write_rows", table)
    _check_rows("scatter_write_rows", rows, table)
    _check_rows_of("scatter_write_rows", "values", table, values,
                   (rows.shape[0],) + tuple(table.shape[1:]))
    if table.device.type == "cpu":
        return scatter_write_rows_plain(table, rows, values)
    n, c = rows.shape[0], table.shape[0]
    row_bytes = _check_words("scatter_write_rows", table, values)
    rc = _lib().ssn_scatter_write_rows(
        table.data_ptr(), rows.data_ptr(), values.data_ptr(), n, c, row_bytes,
        table.device.index or 0, _stream(table))
    _raise_on("scatter_write_rows", rc)
    if n:
        scatter_write_rows.launches += 1
    return table


scatter_write_rows.launches = 0


# ------------------------------------------------------------- AdaGrad ---


def adagrad_step(accum: torch.Tensor, g: torch.Tensor, lr, eps: float):
    """The one AdaGrad rule of the port, on f32 tensors, one rounding an
    operation: ``accum + g * g``, then ``lr * g * rsqrt(accum + eps)``.
    Returns ``(step, accum)``; the row kernels compute the same."""
    accum = accum + g * g
    return lr * g * torch.rsqrt(accum + eps), accum


def adagrad_rule(param: torch.Tensor, accum: torch.Tensor, g: torch.Tensor,
                 lr, eps: float):
    """:func:`adagrad_step` applied to f32 ``param``; returns
    ``(param, accum)``."""
    step, accum = adagrad_step(accum, g, lr, eps)
    return param - step, accum


def scatter_adagrad_rows_plain(table: torch.Tensor, accum: torch.Tensor,
                               rows: torch.Tensor, grads: torch.Tensor, lr,
                               eps: float = 1e-8):
    """The plain version of :func:`scatter_adagrad_rows` (in place)."""
    valid = (rows >= 0) & (rows < table.shape[0])
    idx = rows[valid]
    g = grads[valid].to(table.dtype).float()
    p, a = adagrad_rule(table.index_select(0, idx).float(),
                        accum.index_select(0, idx).float(), g, lr, eps)
    table.index_put_((idx,), p.to(table.dtype))
    accum.index_put_((idx,), a.to(accum.dtype))
    return table, accum


def scatter_adagrad_rows(table: torch.Tensor, accum: torch.Tensor,
                         rows: torch.Tensor, grads: torch.Tensor, lr,
                         eps: float = 1e-8):
    """AdaGrad on UNIQUE rows, in place on both buffers; returns
    ``(table, accum)``.

    ``accum += g * g; table -= lr * g * rsqrt(accum + eps)``, where ``g`` is
    ``grads`` cast to the table's dtype. ``accum`` has the table's shape and
    dtype. Rows outside ``[0, C)`` are padding: skipped, their gradients not
    read. One launch for the table and its accumulator.
    """
    name = "scatter_adagrad_rows"
    _check_table(name, table)
    _check_rows(name, rows, table)
    _check_rows_of(name, "accum", table, accum, table.shape)
    grads = _as_table_dtype(name, grads, table)
    _check_rows_of(name, "grads", table, grads,
                   (rows.shape[0],) + tuple(table.shape[1:]))
    if table.device.type == "cpu":
        return scatter_adagrad_rows_plain(table, accum, rows, grads, lr, eps)
    n, c = rows.shape[0], table.shape[0]
    row_bytes = _check_words(name, table, accum)
    _check_words(name, table, grads)
    rc = _lib().ssn_scatter_adagrad_rows(
        table.data_ptr(), accum.data_ptr(), rows.data_ptr(), grads.data_ptr(), n, c,
        row_bytes, table.element_size(), float(lr), float(eps),
        table.device.index or 0, _stream(table))
    _raise_on(name, rc)
    if n:
        scatter_adagrad_rows.launches += 1
    return table, accum


scatter_adagrad_rows.launches = 0


def scatter_adagrad_fused_rows_plain(table: torch.Tensor, rows: torch.Tensor,
                                     grads: torch.Tensor, lr,
                                     eps: float = 1e-8) -> torch.Tensor:
    """The plain version of :func:`scatter_adagrad_fused_rows` (in place)."""
    valid = (rows >= 0) & (rows < table.shape[0])
    idx = rows[valid]
    g = grads[valid].to(table.dtype).float()
    cur = table.index_select(0, idx).float()
    p, a = adagrad_rule(cur[:, 0:1], cur[:, 1:2], g, lr, eps)
    table.index_put_((idx,), torch.cat([p, a], dim=1).to(table.dtype))
    return table


def scatter_adagrad_fused_rows(table: torch.Tensor, rows: torch.Tensor,
                               grads: torch.Tensor, lr,
                               eps: float = 1e-8) -> torch.Tensor:
    """Slot-fused AdaGrad on UNIQUE rows, in place; returns ``table``.

    ``table`` is ``[C, 2, L]``: sublane 0 the param, sublane 1 its
    accumulator, moved together. ``grads`` is ``[N, 1, L]``, cast to the
    table's dtype. The rule is :func:`scatter_adagrad_rows`'s. A padding
    lane holds a zero gradient, so its accumulator stays 0 and its param
    moves by ``0 * rsqrt(eps) = 0``.
    """
    name = "scatter_adagrad_fused_rows"
    _check_table(name, table)
    _check_rows(name, rows, table)
    if table.dim() != 3 or table.shape[1] != 2:
        raise ValueError(f"{name}: slot-fused table must be [C, 2, L], "
                         f"got {tuple(table.shape)}")
    grads = _as_table_dtype(name, grads, table)
    _check_rows_of(name, "grads", table, grads,
                   (rows.shape[0], 1, table.shape[2]))
    if table.device.type == "cpu":
        return scatter_adagrad_fused_rows_plain(table, rows, grads, lr, eps)
    n, c = rows.shape[0], table.shape[0]
    _check_words(name, table, grads)
    half_bytes = table.shape[2] * table.element_size()
    if half_bytes % _WORD_BYTES:
        raise ValueError(f"{name}: half rows of {half_bytes} B are not in "
                         f"{_WORD_BYTES}-byte words")
    rc = _lib().ssn_scatter_adagrad_fused_rows(
        table.data_ptr(), rows.data_ptr(), grads.data_ptr(), n, c, half_bytes,
        table.element_size(), float(lr), float(eps), table.device.index or 0,
        _stream(table))
    _raise_on(name, rc)
    if n:
        scatter_adagrad_fused_rows.launches += 1
    return table


scatter_adagrad_fused_rows.launches = 0
