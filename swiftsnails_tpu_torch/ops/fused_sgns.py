"""Fused SGNS substeps: gather -> pooled-SGNS gradient -> SGD write, one kernel.

Counterpart of the JAX package's ``ops/fused_sgns.py`` for its two plain
fused forms:

* :func:`fused_sgns_step` (the ``fused-hogwild`` path) replaces the TPU
  kernel ``fused_sgns_step`` / ``_kernel``: blocks of ``pairs_per_block``
  (center, context) pairs, each block sharing ``pool_size`` negatives.
* :func:`fused_sgns_grouped_step` (``fused-grouped``) replaces
  ``fused_sgns_grouped_step`` / ``_grouped_kernel``: blocks of
  ``centers_per_block`` centers, each with ``2 * window`` context slots
  (``-1`` = pad) and a shared pool.

**Semantics: hogwild.** Rows duplicated within a block, shared between pool
and context slots, or touched by two blocks in flight race. The
deterministic meaning, the one the JAX package's interpret mode gives and its
tests pin down, is this:

1. Staleness across blocks: block ``b`` reads the tables as the writes of
   blocks ``<= b - 2`` left them (the TPU's double-buffered schedule issues
   block ``b + 1``'s reads before block ``b``'s writes: R0, R1, W0, R2, W1,
   ...).
2. Within a block all reads come first, then the writes: center rows to the
   in-table, then context rows, then pool rows to the out-table, and the
   later slot wins. The grouped form ranks its context slots c-major (flat
   slot ``k = c * PC + p``). Pool writes overwrite context writes of the
   same row.
3. Grouped only: pad slots are never read; the pool term is weighted by each
   center's count of real contexts; loss and gradients are normalized by
   ``N * (window + 1)``.

The plain versions (``*_plain``) implement 1-3 as a loop over blocks. On the
card the kernel keeps rule 2 exactly, through last-occurrence flags computed
here before the launch (:func:`last_occurrence`), and runs the blocks
concurrently, so rule 1 becomes true hogwild there, as on the TPU. On inputs
whose rows are disjoint between blocks the kernel equals its plain version
within f32 reduction order and is bit-identical from run to run.

Each kernel has, as in :mod:`.rowdma`, a wrapper that checks its inputs and
raises on what the kernel does not take, runs the plain version for tables
on the CPU and launches the CUDA C++ kernel (``csrc/fused_sgns.cu``) for
tables on the card, with no fallback; a launch counter on the wrapper
(``fused_sgns_step.launches``); and the plain version. Both kernels are
bound by f32 arithmetic (the pair x pool products) at the main path's
shapes; ``csrc/fused_sgns.cu`` says what the design does about that. Tables
are updated in place (the JAX package donated them).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from swiftsnails_tpu_torch.ops import _build
from swiftsnails_tpu_torch.ops.rowdma import _check_table

_INT32_MAX = 2**31 - 1


# --------------------------------------------------------------- prep ---


def last_occurrence(rows: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Per block-row: True where ``rows[b, k]`` is the last valid occurrence
    of its value in row ``b`` (``rows`` [NB, K] int32, ``valid`` [NB, K]
    bool). A stable sort groups equal ids in slot order, so each run's last
    element is the last occurrence."""
    keyed = torch.where(valid, rows, _INT32_MAX)
    srt, order = torch.sort(keyed, dim=1, stable=True)
    last = torch.ones_like(srt, dtype=torch.bool)
    last[:, :-1] = srt[:, :-1] != srt[:, 1:]
    last &= srt != _INT32_MAX
    return torch.zeros_like(last).scatter_(1, order, last)


def _all(rows: torch.Tensor) -> torch.Tensor:
    return torch.ones_like(rows, dtype=torch.bool)


def flat_flags(in_rows: torch.Tensor, pos_rows: torch.Tensor,
               pool_rows: torch.Tensor, p: int, pn: int) -> Tuple[torch.Tensor, ...]:
    """Write flags of the flat step: ``(v_last, u_last, q_last)``, shaped
    ``[NB, P]``, ``[NB, P]``, ``[NB, PN]``."""
    blocks = (in_rows.view(-1, p), pos_rows.view(-1, p), pool_rows.view(-1, pn))
    return tuple(last_occurrence(r, _all(r)) for r in blocks)


def context_flags(ctxs: torch.Tensor, pc: int) -> torch.Tensor:
    """Write flags of the grouped step's context slots, ``[N, CW]`` like
    ``ctxs``: the last valid occurrence of each row within its block, slots
    ranked c-major (``k = c * PC + p``, as the TPU kernel's copy list)."""
    n, cw = ctxs.shape
    cmajor = ctxs.view(n // pc, pc, cw).transpose(1, 2).reshape(n // pc, cw * pc)
    last = last_occurrence(cmajor, cmajor >= 0)
    return last.view(n // pc, cw, pc).transpose(1, 2).reshape(n, cw).contiguous()


def grouped_flags(centers: torch.Tensor, ctxs: torch.Tensor,
                  pool_rows: torch.Tensor, pc: int, pn: int) -> Tuple[torch.Tensor, ...]:
    """Write flags of the grouped step: ``(c_last [NB, PC], x_last [N, CW],
    q_last [NB, PN])``."""
    c, q = centers.view(-1, pc), pool_rows.view(-1, pn)
    return (last_occurrence(c, _all(c)), context_flags(ctxs, pc),
            last_occurrence(q, _all(q)))


# ------------------------------------------------ the plain versions' parts ---


def _double_buffered(nblocks: int, read, update) -> None:
    """Run ``update(b, read(b))`` for each block in the TPU kernel's order:
    block ``b + 1`` is read before block ``b``'s writes land (R0, R1, W0,
    R2, W1, ...)."""
    if nblocks == 0:
        return
    nxt = read(0)
    for b in range(nblocks):
        cur = nxt
        if b + 1 < nblocks:
            nxt = read(b + 1)
        update(b, cur)


def _apply_writes(writes) -> None:
    """Apply one block's row writes in order; each is ``(table, rows, values
    [K, D] f32, flags [K])`` and only flagged slots (distinct rows) write."""
    for table, rows, values, flags in writes:
        idx = rows[flags].long()
        table.index_copy_(0, idx, values[flags].to(table.dtype).view(-1, *table.shape[1:]))


def _rows_f32(table: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    return table.index_select(0, rows).reshape(rows.shape[0], -1).float()


# --------------------------------------------------------------- checks ---


def _check_ids(name: str, ids: torch.Tensor, ndim: int, table: torch.Tensor) -> None:
    if ids.dtype != torch.int32:
        raise TypeError(f"{name}: row ids must be int32, got {ids.dtype}")
    if ids.dim() != ndim or not ids.is_contiguous():
        raise ValueError(f"{name}: row ids must be a contiguous {ndim}-D tensor")
    if ids.device != table.device:
        raise ValueError(f"{name}: row ids on {ids.device}, table on {table.device}")


def _check_tables(name: str, in_table: torch.Tensor, out_table: torch.Tensor) -> None:
    _check_table(name, in_table)
    _check_table(name, out_table)
    if in_table.shape[1:] != out_table.shape[1:] or in_table.dtype != out_table.dtype:
        raise ValueError("in/out tables must share row shape and dtype")
    # the kernels take one capacity and one device for both tables
    if in_table.shape[0] != out_table.shape[0] or in_table.device != out_table.device:
        raise ValueError("in/out tables must share capacity and device")
    if in_table.shape[0] > _INT32_MAX:
        raise ValueError("table capacity exceeds int32 row ids")


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_sgns")
    vp, ll, i32, f32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
    lib.ssn_fused_sgns_tile.argtypes = [i32, i32, i32, i32]
    lib.ssn_fused_sgns_tile.restype = i32
    lib.ssn_fused_sgns_step.argtypes = (
        [vp] * 9 + [ll, i32, i32, ll, i32, i32, f32, f32, f32, i32, vp])
    lib.ssn_fused_sgns_step.restype = i32
    lib.ssn_fused_sgns_grouped_step.argtypes = (
        [vp] * 10 + [ll, i32, i32, i32, ll, i32, i32, f32, f32, f32, i32, vp])
    lib.ssn_fused_sgns_grouped_step.restype = i32
    lib.ssn_fused_sgns_error_string.argtypes = [i32]
    lib.ssn_fused_sgns_error_string.restype = ctypes.c_char_p
    return lib


def _tile(name: str, grouped: bool, cw: int, pn: int, row_elems: int) -> None:
    if _lib().ssn_fused_sgns_tile(int(grouped), cw, pn, row_elems) == 0:
        raise ValueError(
            f"{name}: a pool of {pn} rows of {row_elems} lanes does not fit in "
            "the kernel's shared memory")


def _raise_on(name: str, rc: int) -> None:
    if rc != 0:
        msg = _lib().ssn_fused_sgns_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} ({msg})")


def _ptrs(*tensors: torch.Tensor):
    return [t.data_ptr() for t in tensors]


def _device_args(table: torch.Tensor):
    """``(device index, stream)`` for a launch on ``table``'s card."""
    return table.device.index or 0, torch.cuda.current_stream(table.device).cuda_stream


def _total(losses, like: torch.Tensor) -> torch.Tensor:
    """The sum of the blocks' losses (0 for no block)."""
    if not losses:
        return torch.zeros((), dtype=torch.float32, device=like.device)
    return torch.stack(losses).sum()


# ---------------------------------------------------------------- flat ---


def fused_sgns_step_plain(in_table, out_table, in_rows, pos_rows, pool_rows,
                          lr: float, lam: float, pairs_per_block: int = 512,
                          pool_size: int = 64):
    """The plain version of :func:`fused_sgns_step` (rules 1-2, in place)."""
    p, pn = pairs_per_block, pool_size
    b = in_rows.shape[0]
    inv_b = 1.0 / b
    ir, pr, qr = in_rows.view(-1, p), pos_rows.view(-1, p), pool_rows.view(-1, pn)
    v_last, u_last, q_last = flat_flags(in_rows, pos_rows, pool_rows, p, pn)
    losses = []

    def read(blk):
        return (_rows_f32(in_table, ir[blk]), _rows_f32(out_table, pr[blk]),
                _rows_f32(out_table, qr[blk]))

    def update(blk, rows):
        v, u, q = rows
        pos = (v * u).sum(1)
        neg = v @ q.T
        g_pos = (torch.sigmoid(pos) - 1.0) * inv_b
        g_neg = (lam * inv_b) * torch.sigmoid(neg)
        dv = g_pos[:, None] * u + g_neg @ q
        du = g_pos[:, None] * v
        dq = g_neg.T @ v
        _apply_writes([(in_table, ir[blk], v - lr * dv, v_last[blk]),
                       (out_table, pr[blk], u - lr * du, u_last[blk]),
                       (out_table, qr[blk], q - lr * dq, q_last[blk])])
        losses.append(-(F.logsigmoid(pos).sum() + lam * F.logsigmoid(-neg).sum()) * inv_b)

    _double_buffered(b // p, read, update)
    return in_table, out_table, _total(losses, in_table)


def fused_sgns_step(in_table: torch.Tensor, out_table: torch.Tensor,
                    in_rows: torch.Tensor, pos_rows: torch.Tensor,
                    pool_rows: torch.Tensor, lr: float, lam: float,
                    pairs_per_block: int = 512, pool_size: int = 64):
    """One SGD substep over B pairs; returns ``(in_table, out_table, loss)``.

    ``in_rows`` / ``pos_rows``: [B] int32; ``pool_rows``: [B / pairs_per_block
    * pool_size] int32, ids in ``[0, C)`` (on the card an id outside reads
    zeros and is never written; the plain version raises on one). ``lam`` is
    the negative term's weight (``negatives / pool_size``); loss and gradients
    are means over B. Both tables are updated in place.
    """
    b = in_rows.shape[0]
    p, pn = pairs_per_block, pool_size
    if b % p:
        raise ValueError(f"batch {b} not a multiple of pairs_per_block {p}")
    nblocks = b // p
    if pool_rows.shape[0] != nblocks * pn:
        raise ValueError(f"pool_rows {pool_rows.shape[0]} != nblocks*pool {nblocks * pn}")
    _check_tables("fused_sgns_step", in_table, out_table)
    for ids in (in_rows, pos_rows, pool_rows):
        _check_ids("fused_sgns_step", ids, 1, in_table)
    if pos_rows.shape[0] != b:
        raise ValueError(f"pos_rows {pos_rows.shape[0]} != in_rows {b}")
    if in_table.device.type == "cpu":
        return fused_sgns_step_plain(in_table, out_table, in_rows, pos_rows,
                                     pool_rows, lr, lam, p, pn)
    row_elems = in_table.stride(0)
    _tile("fused_sgns_step", False, 0, pn, row_elems)
    flags = flat_flags(in_rows, pos_rows, pool_rows, p, pn)
    loss_parts = torch.zeros(nblocks, dtype=torch.float32, device=in_table.device)
    rc = _lib().ssn_fused_sgns_step(
        *_ptrs(in_table, out_table, in_rows, pos_rows, pool_rows, *flags, loss_parts),
        nblocks, p, pn, in_table.shape[0], row_elems, in_table.element_size(),
        float(lr), float(lam), 1.0 / b, *_device_args(in_table))
    _raise_on("fused_sgns_step", rc)
    if nblocks:
        fused_sgns_step.launches += 1
    return in_table, out_table, loss_parts.sum()


fused_sgns_step.launches = 0


# ------------------------------------------------------------- grouped ---


def fused_sgns_grouped_step_plain(in_table, out_table, centers, ctxs, pool_rows,
                                  lr: float, lam: float, window: int,
                                  centers_per_block: int = 128, pool_size: int = 64):
    """The plain version of :func:`fused_sgns_grouped_step` (rules 1-3, in
    place). Pad slots are never read: their rows stay zero."""
    pc, pn = centers_per_block, pool_size
    n, cw = ctxs.shape
    inv_b = 1.0 / (n * (window + 1))
    cr, xr, qr = centers.view(-1, pc), ctxs.view(-1, pc, cw), pool_rows.view(-1, pn)
    c_last, x_last, q_last = grouped_flags(centers, ctxs, pool_rows, pc, pn)
    x_last = x_last.view(-1, pc, cw)
    losses = []

    def read(blk):
        valid = xr[blk] >= 0  # [PC, CW]
        d = in_table.stride(0)
        u = torch.zeros(pc, cw, d, dtype=torch.float32, device=in_table.device)
        u[valid] = _rows_f32(out_table, xr[blk][valid])
        return _rows_f32(in_table, cr[blk]), u, _rows_f32(out_table, qr[blk]), valid

    def update(blk, rows):
        v, u, q, valid = rows
        mask = valid.float()  # [PC, CW]
        pos = (u * v[:, None, :]).sum(-1)  # [PC, CW]
        n_real = mask.sum(1)  # [PC]
        neg = v @ q.T  # [PC, PN]
        g_pos = (torch.sigmoid(pos) - 1.0) * inv_b * mask
        # the pool is shared center-wide: each real pair adds the same
        # negative term, so a center's weight is its count of real contexts
        g_neg = (lam * inv_b) * torch.sigmoid(neg) * n_real[:, None]
        dv = (g_pos[:, :, None] * u).sum(1) + g_neg @ q
        du = g_pos[:, :, None] * v[:, None, :]
        dq = g_neg.T @ v
        _apply_writes([(in_table, cr[blk], v - lr * dv, c_last[blk]),
                       (out_table, xr[blk].reshape(-1), (u - lr * du).view(pc * cw, -1),
                        x_last[blk].reshape(-1)),
                       (out_table, qr[blk], q - lr * dq, q_last[blk])])
        losses.append(-((F.logsigmoid(pos) * mask).sum()
                        + lam * (F.logsigmoid(-neg) * n_real[:, None]).sum()) * inv_b)

    _double_buffered(n // pc, read, update)
    return in_table, out_table, _total(losses, in_table)


def fused_sgns_grouped_step(in_table: torch.Tensor, out_table: torch.Tensor,
                            centers: torch.Tensor, ctxs: torch.Tensor,
                            pool_rows: torch.Tensor, lr: float, lam: float,
                            window: int, centers_per_block: int = 128,
                            pool_size: int = 64):
    """Center-major substep; returns ``(in_table, out_table, loss)``.

    ``centers``: [N] int32; ``ctxs``: [N, CW] int32 row ids, ``-1`` = pad;
    ``pool_rows``: [N / centers_per_block * pool_size] int32. Loss and
    gradients are normalized by the expected pair count ``N * (window + 1)``
    (a dynamic window b ~ U(1, window) gives 2 E[b] = window + 1 pairs a
    center). Both tables are updated in place.
    """
    if ctxs.dim() != 2:
        raise ValueError(f"ctxs must be [N, CW], got {tuple(ctxs.shape)}")
    n, cw = ctxs.shape
    pc, pn = centers_per_block, pool_size
    if n % pc:
        raise ValueError(f"centers {n} not a multiple of centers_per_block {pc}")
    nblocks = n // pc
    if pool_rows.shape[0] != nblocks * pn:
        raise ValueError(f"pool_rows {pool_rows.shape[0]} != {nblocks * pn}")
    _check_tables("fused_sgns_grouped_step", in_table, out_table)
    _check_ids("fused_sgns_grouped_step", centers, 1, in_table)
    _check_ids("fused_sgns_grouped_step", ctxs, 2, in_table)
    _check_ids("fused_sgns_grouped_step", pool_rows, 1, in_table)
    if centers.shape[0] != n:
        raise ValueError(f"centers {centers.shape[0]} != ctxs rows {n}")
    if in_table.device.type == "cpu":
        return fused_sgns_grouped_step_plain(in_table, out_table, centers, ctxs,
                                             pool_rows, lr, lam, window, pc, pn)
    row_elems = in_table.stride(0)
    _tile("fused_sgns_grouped_step", True, cw, pn, row_elems)
    flags = grouped_flags(centers, ctxs, pool_rows, pc, pn)
    scratch = torch.empty((n * cw, row_elems), dtype=out_table.dtype,
                          device=out_table.device)
    loss_parts = torch.zeros(nblocks, dtype=torch.float32, device=in_table.device)
    rc = _lib().ssn_fused_sgns_grouped_step(
        *_ptrs(in_table, out_table, centers, ctxs, pool_rows, *flags, scratch,
               loss_parts),
        nblocks, pc, cw, pn, in_table.shape[0], row_elems, in_table.element_size(),
        float(lr), float(lam), 1.0 / (n * (window + 1)), *_device_args(in_table))
    _raise_on("fused_sgns_grouped_step", rc)
    if nblocks:
        fused_sgns_grouped_step.launches += 1
    return in_table, out_table, loss_parts.sum()


fused_sgns_grouped_step.launches = 0
