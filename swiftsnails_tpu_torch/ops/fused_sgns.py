"""Fused SGNS substeps: gather -> pooled-SGNS gradient -> SGD write, one kernel.

Counterpart of the JAX package's ``ops/fused_sgns.py``: its two hogwild
fused forms, and (section "merged" below) the three whose kernel blocks run
in order with some rows' updates merged.

* :func:`fused_sgns_step` (the ``fused-hogwild`` path) replaces the TPU
  kernel ``fused_sgns_step`` / ``_kernel``: blocks of ``pairs_per_block``
  (center, context) pairs, each block sharing ``pool_size`` negatives.
* :func:`fused_sgns_grouped_step` (``fused-grouped``) replaces
  ``fused_sgns_grouped_step`` / ``_grouped_kernel``: blocks of
  ``centers_per_block`` centers, each with ``2 * window`` context slots
  (``-1`` = pad) and a shared pool.
* :func:`fused_sgns_resident_step` (``fused-resident``),
  :func:`fused_sgns_dedup_step` (``fused-dedup``) and
  :func:`fused_sgns_dedup_resident_step` (``fused-dedup-res``) replace
  ``_resident_kernel``, ``_dedup_kernel`` and ``_dedup_resident_kernel``
  with one CUDA C++ kernel (``csrc/fused_sgns_merged.cu``).

**Semantics of the two hogwild forms.** Rows duplicated within a block,
shared between pool and context slots, or touched by two blocks in flight
race. The
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
on the CPU and launches the CUDA C++ kernel for tables on the card, with no
fallback; a launch counter on the wrapper (``fused_sgns_step.launches``);
and the plain version. The kernels are bound by f32 arithmetic (the pair x
pool products) at the main path's shapes; each source says what its design
does about that. Tables are updated in place (the JAX package donated
them).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

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


def _c_major(x: torch.Tensor, pc: int) -> torch.Tensor:
    """``[N, CW]`` slots as ``[N / PC, CW * PC]`` rows, ranked c-major
    (``k = c * PC + p``, as the TPU kernels' copy lists)."""
    n, cw = x.shape
    return x.view(n // pc, pc, cw).transpose(1, 2).reshape(n // pc, cw * pc)


def context_flags(ctxs: torch.Tensor, pc: int,
                  valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Write flags of the grouped step's context slots, ``[N, CW]`` like
    ``ctxs``: the last occurrence of each row among its block's ``valid``
    slots (default: the real ones, ``ctxs >= 0``), slots ranked c-major."""
    n, cw = ctxs.shape
    valid = ctxs >= 0 if valid is None else valid
    last = last_occurrence(_c_major(ctxs, pc), _c_major(valid, pc))
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
    return table.index_select(0, rows).reshape(rows.shape[0], table.stride(0)).float()


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


def _check_grouped(name: str, in_table, out_table, centers, ctxs, pool_rows,
                   pc: int, pn: int) -> Tuple[int, int, int]:
    """The grouped forms' input checks; returns ``(N, CW, blocks)``."""
    if ctxs.dim() != 2:
        raise ValueError(f"ctxs must be [N, CW], got {tuple(ctxs.shape)}")
    n, cw = ctxs.shape
    if n % pc:
        raise ValueError(f"centers {n} not a multiple of centers_per_block {pc}")
    nblocks = n // pc
    if pool_rows.shape[0] != nblocks * pn:
        raise ValueError(f"pool_rows {pool_rows.shape[0]} != {nblocks * pn}")
    _check_tables(name, in_table, out_table)
    _check_ids(name, centers, 1, in_table)
    _check_ids(name, ctxs, 2, in_table)
    _check_ids(name, pool_rows, 1, in_table)
    if centers.shape[0] != n:
        raise ValueError(f"centers {centers.shape[0]} != ctxs rows {n}")
    return n, cw, nblocks


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
    pc, pn = centers_per_block, pool_size
    n, cw, nblocks = _check_grouped("fused_sgns_grouped_step", in_table, out_table,
                                    centers, ctxs, pool_rows, pc, pn)
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


# -------------------------------------------------------------- merged ---
#
# The grouped step with some rows' updates merged, its kernel blocks in
# order (rule 1 as the TPU's sequential grid gives it, on the card too):
#
# * hot rows (id < hot_n, both tables) are read as blocks <= b - 1 left
#   them, and each gets its base less lr times the sum of the gradients of
#   all its slots in the block: centers for the in-table; contexts and pool
#   for the out-table;
# * a context row in its block's unique list (the block's distinct real
#   context rows ranked ascending, which puts hot rows first; the first
#   u_cap of them) is merged too: base as read (cold: blocks <= b - 2) less
#   lr times its context slots' gradients, written after the pool's writes,
#   so it overwrites them;
# * cold centers, cold pool rows and the other ("direct") context slots keep
#   the grouped step's last-write-wins (rules 1-2 above).
#
# fused_sgns_resident_step merges the hot rows (no unique list),
# fused_sgns_dedup_step the unique lists (no hot rows), and
# fused_sgns_dedup_resident_step both.


def effective_hot_rows(hot_rows: int, *capacities: int) -> Tuple[int, int]:
    """``(hot_n, ch)``: the head rows the resident forms merge. ``hot_rows``
    is clipped to the capacities and rounded down to a multiple of 256 (or
    of 8 below 256), the JAX kernel's one-hot chunk ``ch``; ``(0, 0)`` where
    no row is left. The rounding decides which rows are hot, so it is part
    of the result."""
    hot_n = min(hot_rows, *capacities)
    if hot_n >= 256:
        hot_n -= hot_n % 256
        ch = 256
    else:
        hot_n -= hot_n % 8
        ch = hot_n
    return (hot_n, ch) if hot_n > 0 else (0, 0)


# The merged kernel's split of its writes (csrc/fused_sgns_merged.cu): a run
# of at most RUN_CHUNK slots is summed by one warp, a longer one by the
# MERGED_CTA_WARPS warps of one CTA, in as many contiguous pieces.
RUN_CHUNK = 8
MERGED_CTA_WARPS = 16


def merge_runs(keys: torch.Tensor, codes: torch.Tensor, is_ctx: torch.Tensor,
               hot_n: int, u_cap: int) -> Tuple[torch.Tensor, ...]:
    """The writes of a merged step, one run a written row.

    ``keys`` [NB, K] int32: each block's slots in write-rank order (a later
    slot wins a last-write-wins row), one key a table row (``2 * row`` in
    the out-table, ``2 * row + 1`` in the in-table), ``_INT32_MAX`` where a
    slot writes nothing; context slots (``is_ctx`` [K]) rank before the pool
    slots; ``codes`` [K] int32 names each slot to the kernel. Returns
    ``(ent [NB, K], run_start [NB, K + 1], n_runs [NB], long_runs [NB, K],
    n_long [NB])``, int32: run ``j`` of block ``b`` is the slots ``ent[b,
    run_start[b, j]:run_start[b, j + 1]]`` of one row, sorted by key: every
    slot of a hot row, the context slots of a row in the unique list, or the
    last slot of any other row. ``long_runs[b, :n_long[b]]`` are the runs of
    more than :data:`RUN_CHUNK` slots, in order, ``-1`` after them.
    """
    nb, k = keys.shape
    srt, order = torch.sort(keys, dim=1, stable=True)
    ok = srt != _INT32_MAX
    head = torch.ones_like(ok)
    head[:, 1:] = srt[:, 1:] != srt[:, :-1]
    last = torch.ones_like(ok)
    last[:, :-1] = head[:, 1:]
    ctx = is_ctx[order]
    pos = _positions(k, keys.device).expand(nb, k)
    # a row's slots keep their rank order, context slots first: the row has a
    # context slot iff its first slot is one, and counting such first slots
    # ranks the distinct context rows ascending
    first = torch.cummax(torch.where(head, pos, 0), dim=1).values.long()
    rank = torch.cumsum(head & ctx & ok, dim=1) - 1
    listed = ctx.gather(1, first) & (rank < u_cap)
    keep = ok & (((srt >> 1) < hot_n) | (listed & ctx) | (~listed & last))

    def compact(values, mask):
        """``values[b][mask[b]]`` first in each row, -1 after them."""
        dest = torch.where(mask, torch.cumsum(mask, 1) - 1, k)
        out = torch.full((nb, k + 1), -1, dtype=torch.int32, device=keys.device)
        return out.scatter_(1, dest, values)[:, :k]

    ent, ckey = compact(codes[order], keep), compact(srt, keep)
    chead = ckey >= 0
    chead[:, 1:] &= ckey[:, 1:] != ckey[:, :-1]
    run_start = keep.sum(1, dtype=torch.int32)[:, None].expand(nb, k + 2).clone()
    run_start.scatter_(1, torch.where(chead, torch.cumsum(chead, 1) - 1, k + 1), pos)
    run_start = run_start[:, : k + 1]
    # runs past n_runs start at the count of kept slots: length 0
    is_long = (run_start[:, 1:] - run_start[:, :-1]) > RUN_CHUNK
    return (ent.contiguous(), run_start.contiguous(), chead.sum(1, dtype=torch.int32),
            compact(pos, is_long).contiguous(), is_long.sum(1, dtype=torch.int32))


@functools.lru_cache(maxsize=None)
def _positions(k: int, device: torch.device) -> torch.Tensor:
    return torch.arange(k, dtype=torch.int32, device=device)


@functools.lru_cache(maxsize=None)
def _slot_codes(pc: int, cw: int, pn: int, device: torch.device):
    """A block's write list, in rank order: context slots c-major (code
    ``p * CW + c``), pool slots (``PC * CW + c``), centers (``PC * CW + PN +
    p``). Returns ``(codes, is_ctx, in_table)``: int32, bool, int32 [K]."""
    cap = pc * cw
    k = torch.arange(cap, dtype=torch.int32)
    codes = torch.cat([(k % pc) * cw + k // pc, cap + torch.arange(pn + pc, dtype=torch.int32)])
    slot = torch.arange(cap + pn + pc)
    return codes.to(device), (slot < cap).to(device), (slot >= cap + pn).int().to(device)


def merged_prep(centers: torch.Tensor, ctxs: torch.Tensor, pool_rows: torch.Tensor,
                pc: int, pn: int, hot_n: int, u_cap: int,
                capacity: int) -> Tuple[torch.Tensor, ...]:
    """:func:`merge_runs` of a step's context, pool and center slots (codes
    of :func:`_slot_codes`). Ids outside ``[0, capacity)`` are written by no
    run."""
    n, cw = ctxs.shape
    codes, is_ctx, in_table = _slot_codes(pc, cw, pn, ctxs.device)
    rows = torch.cat([_c_major(ctxs, pc), pool_rows.view(-1, pn), centers.view(-1, pc)], 1)
    keys = torch.where((rows >= 0) & (rows < capacity), rows * 2 + in_table, _INT32_MAX)
    return merge_runs(keys, codes, is_ctx, hot_n, u_cap)


class _BlockRead(NamedTuple):
    v: torch.Tensor  # [PC, D] f32 center rows
    u: torch.Tensor  # [PC, CW, D] context rows, zeros on pads
    q: torch.Tensor  # [PN, D] pool rows
    uniq: torch.Tensor  # [U, D] the block's cold unique rows


def _live_rows(table: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Hot rows as the writes of blocks <= b - 1 left them: the table now."""
    return _rows_f32(table, rows)


def _hot_sums(parts) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(rows, sums)``: the distinct hot rows among ``parts``, a list of
    ``(rows [K], grads [K, D])``, and the sum of each one's gradients."""
    rows = torch.cat([r for r, _ in parts])
    grads = torch.cat([g for _, g in parts])
    uniq, inv = torch.unique(rows, return_inverse=True)
    return uniq, grads.new_zeros(uniq.shape[0], grads.shape[1]).index_add_(0, inv, grads)


def _merged_plain(in_table, out_table, centers, ctxs, pool_rows, lr: float,
                  lam: float, window: int, pc: int, pn: int, hot_n: int, u_cap: int):
    """The plain version of the merged forms (in place): rules 1-3 of the
    grouped step for cold rows, merged updates for hot and unique rows."""
    n, cw = ctxs.shape
    nb = n // pc
    inv_b = 1.0 / (n * (window + 1))
    d = in_table.stride(0)
    cr, xr, qr = centers.view(-1, pc), ctxs.view(-1, pc, cw), pool_rows.view(-1, pn)
    valid = xr >= 0
    hot_c, hot_x, hot_q = cr < hot_n, valid & (xr < hot_n), qr < hot_n
    listed = torch.zeros_like(valid)
    uniq = []
    for b in range(nb):
        rows = torch.unique(xr[b][valid[b]])[:u_cap]  # ascending: hot rows first
        listed[b] = valid[b] & torch.isin(xr[b], rows)
        uniq.append(rows[rows >= hot_n])
    cold_listed = listed & ~hot_x
    c_last = last_occurrence(cr, ~hot_c)
    x_last = context_flags(ctxs, pc, (valid & ~listed & ~hot_x).view(n, cw)).view(-1, pc, cw)
    q_last = last_occurrence(qr, ~hot_q)
    losses = []

    def read(b):
        u = torch.zeros(pc, cw, d, dtype=torch.float32, device=in_table.device)
        u[valid[b]] = _rows_f32(out_table, xr[b][valid[b]])
        return _BlockRead(_rows_f32(in_table, cr[b]), u, _rows_f32(out_table, qr[b]),
                          _rows_f32(out_table, uniq[b]))

    def update(b, r: _BlockRead):
        v, u, q = r.v, r.u, r.q
        hc, hx, hq = hot_c[b], hot_x[b], hot_q[b]
        v[hc] = _live_rows(in_table, cr[b][hc])
        u[hx] = _live_rows(out_table, xr[b][hx])
        q[hq] = _live_rows(out_table, qr[b][hq])
        mask = valid[b].float()
        pos = (u * v[:, None, :]).sum(-1)
        n_real = mask.sum(1)
        neg = v @ q.T
        g_pos = (torch.sigmoid(pos) - 1.0) * inv_b * mask
        g_neg = (lam * inv_b) * torch.sigmoid(neg) * n_real[:, None]
        dv = (g_pos[:, :, None] * u).sum(1) + g_neg @ q
        du = g_pos[:, :, None] * v[:, None, :]
        dq = g_neg.T @ v
        cl = cold_listed[b]
        du_uniq = torch.zeros_like(r.uniq).index_add_(
            0, torch.searchsorted(uniq[b], xr[b][cl]), du[cl])
        writes = [(in_table, cr[b], v - lr * dv, c_last[b]),
                  (out_table, xr[b].reshape(-1), (u - lr * du).view(pc * cw, -1),
                   x_last[b].reshape(-1)),
                  (out_table, qr[b], q - lr * dq, q_last[b]),
                  (out_table, uniq[b], r.uniq - lr * du_uniq, _all(uniq[b]))]
        for table, (rows, sums) in (
                (in_table, _hot_sums([(cr[b][hc], dv[hc])])),
                (out_table, _hot_sums([(xr[b][hx], du[hx]), (qr[b][hq], dq[hq])]))):
            writes.append((table, rows, _live_rows(table, rows) - lr * sums, _all(rows)))
        _apply_writes(writes)
        losses.append(-((F.logsigmoid(pos) * mask).sum()
                        + lam * (F.logsigmoid(-neg) * n_real[:, None]).sum()) * inv_b)

    _double_buffered(nb, read, update)
    return in_table, out_table, _total(losses, in_table)


@functools.lru_cache(maxsize=None)
def _merged_lib() -> ctypes.CDLL:
    lib = _build.load("fused_sgns_merged")
    vp, ll, i32, f32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
    lib.ssn_fused_sgns_merged_grid.argtypes = [i32] * 5
    lib.ssn_fused_sgns_merged_grid.restype = i32
    lib.ssn_fused_sgns_merged_workspace.argtypes = [i32] * 5
    lib.ssn_fused_sgns_merged_workspace.restype = ll
    lib.ssn_fused_sgns_merged_step.argtypes = (
        [vp] * 12 + [i32, ll, i32, i32, i32, ll, i32, i32, i32, i32, f32, f32, f32, i32,
                     i32, vp])
    lib.ssn_fused_sgns_merged_step.restype = i32
    lib.ssn_fused_sgns_merged_status.argtypes = []
    lib.ssn_fused_sgns_merged_status.restype = i32
    lib.ssn_fused_sgns_merged_error_string.argtypes = [i32]
    lib.ssn_fused_sgns_merged_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _merged_grid(cw: int, pn: int, row_elems: int, elem_bytes: int, device: int) -> int:
    """CTAs of the merged kernel's persistent grid on this card, or 0 where
    a center's rows and the pool do not fit in its shared memory."""
    lib = _merged_lib()
    grid = lib.ssn_fused_sgns_merged_grid(cw, pn, row_elems, elem_bytes, device)
    if grid < 0:
        raise RuntimeError(f"merged kernel: the card's occupancy query failed: CUDA error "
                           f"{-grid} ({lib.ssn_fused_sgns_merged_error_string(-grid).decode()})")
    return grid


def merged_deadline_status() -> int:
    """The code of the merged kernel's grid barrier that passed its deadline
    in the last launch: 0 none, 1 the one after staging block 0, 2, 3 and 4
    those after C(b), dQ(b) and W(b). Kept in host memory, so it can be read
    after the trap has ended the CUDA context."""
    return int(_merged_lib().ssn_fused_sgns_merged_status())


def _merged_step(fn, in_table, out_table, centers, ctxs, pool_rows, lr, lam, window,
                 pc: int, pn: int, hot_n: int, u_cap: int, miss_barrier: int = -1):
    """Run the plain version for CPU tables, or launch the merged kernel
    (``csrc/fused_sgns_merged.cu``) and count it on ``fn``.
    ``miss_barrier`` (k >= 1) makes the kernel's first CTA skip its k-th grid
    barrier, which then traps at its deadline: a test of the deadline."""
    if in_table.device.type == "cpu":
        return _merged_plain(in_table, out_table, centers, ctxs, pool_rows, lr, lam,
                             window, pc, pn, hot_n, u_cap)
    n, cw = ctxs.shape
    nblocks = n // pc
    row_elems = in_table.stride(0)
    if in_table.shape[0] >= 2**30:
        raise ValueError("table capacity exceeds 2^30 rows (the prep's row keys)")
    device, stream = _device_args(in_table)
    grid = _merged_grid(cw, pn, row_elems, in_table.element_size(), device)
    if grid == 0:
        raise ValueError(
            f"{fn.__name__}: a pool of {pn} rows of {row_elems} lanes does not fit in "
            "the kernel's shared memory (or rows exceed its 512 lanes)")
    lib = _merged_lib()
    runs = merged_prep(centers, ctxs, pool_rows, pc, pn, hot_n, u_cap, in_table.shape[0])
    work = torch.empty(lib.ssn_fused_sgns_merged_workspace(
        pc, cw, pn, row_elems, in_table.element_size()), dtype=torch.uint8,
        device=in_table.device)
    # each CTA's loss terms, then the grid barrier's counter (0 bits)
    state = torch.zeros(grid + 1, dtype=torch.float32, device=in_table.device)
    rc = lib.ssn_fused_sgns_merged_step(
        *_ptrs(in_table, out_table, centers, ctxs, pool_rows, *runs, work, state),
        grid, nblocks, pc, cw, pn, in_table.shape[0], row_elems, in_table.element_size(),
        hot_n, RUN_CHUNK, float(lr), float(lam), 1.0 / (n * (window + 1)), miss_barrier,
        device, stream)
    if rc != 0:
        msg = lib.ssn_fused_sgns_merged_error_string(rc).decode()
        raise RuntimeError(f"{fn.__name__} kernel launch failed: CUDA error {rc} ({msg})")
    if nblocks:
        fn.launches += 1
    return in_table, out_table, state[:grid].sum()


def _hot_n(hot_rows: int, in_table, out_table, instead: str) -> int:
    hot_n, _ = effective_hot_rows(hot_rows, in_table.shape[0], out_table.shape[0])
    if hot_n <= 0:
        raise ValueError(f"hot_rows too small; use {instead}")
    return hot_n


def _check_u_cap(u_cap: int) -> None:
    if u_cap % 8 or u_cap <= 0:
        raise ValueError(f"u_cap must be a positive multiple of 8, got {u_cap}")


def _composed_hot_n(hot_rows: int, u_cap: int, in_table, out_table) -> int:
    hot_n = _hot_n(hot_rows, in_table, out_table, "fused_sgns_dedup_step")
    if u_cap < hot_n:
        raise ValueError(
            f"composed kernel requires u_cap ({u_cap}) >= effective hot_rows "
            f"({hot_n}); raise u_cap or lower hot_rows")
    return hot_n


def fused_sgns_resident_step(in_table: torch.Tensor, out_table: torch.Tensor,
                             centers: torch.Tensor, ctxs: torch.Tensor,
                             pool_rows: torch.Tensor, lr: float, lam: float, window: int,
                             centers_per_block: int = 256, pool_size: int = 64,
                             hot_rows: int = 1024):
    """The grouped substep with the head merged (``fused-resident``); returns
    ``(in_table, out_table, loss)``, tables updated in place.

    Rows below ``effective_hot_rows(hot_rows, C)`` of both tables are read
    as the blocks before left them and get merged updates; every other row
    is as in :func:`fused_sgns_grouped_step`. The win needs frequency-ranked
    ids (the vocabulary's order); the result never does.
    """
    pc, pn = centers_per_block, pool_size
    _check_grouped("fused_sgns_resident_step", in_table, out_table, centers, ctxs,
                   pool_rows, pc, pn)
    hot_n = _hot_n(hot_rows, in_table, out_table, "fused_sgns_grouped_step")
    return _merged_step(fused_sgns_resident_step, in_table, out_table, centers, ctxs,
                        pool_rows, lr, lam, window, pc, pn, hot_n, 0)


def fused_sgns_resident_step_plain(in_table, out_table, centers, ctxs, pool_rows,
                                   lr: float, lam: float, window: int,
                                   centers_per_block: int = 256, pool_size: int = 64,
                                   hot_rows: int = 1024):
    """The plain version of :func:`fused_sgns_resident_step`."""
    hot_n = _hot_n(hot_rows, in_table, out_table, "fused_sgns_grouped_step")
    return _merged_plain(in_table, out_table, centers, ctxs, pool_rows, lr, lam, window,
                         centers_per_block, pool_size, hot_n, 0)


fused_sgns_resident_step.launches = 0


def fused_sgns_dedup_step(in_table: torch.Tensor, out_table: torch.Tensor,
                          centers: torch.Tensor, ctxs: torch.Tensor,
                          pool_rows: torch.Tensor, lr: float, lam: float, window: int,
                          centers_per_block: int = 256, pool_size: int = 64,
                          u_cap: int = 512):
    """The grouped substep with each block's first ``u_cap`` distinct context
    rows merged (``fused-dedup``); returns ``(in_table, out_table, loss)``,
    tables updated in place. Made for block-ordered batches
    (:func:`~swiftsnails_tpu_torch.data.sampler.batch_stream_blocks`), whose
    overlapping windows give a block few distinct context rows."""
    pc, pn = centers_per_block, pool_size
    _check_grouped("fused_sgns_dedup_step", in_table, out_table, centers, ctxs,
                   pool_rows, pc, pn)
    _check_u_cap(u_cap)
    return _merged_step(fused_sgns_dedup_step, in_table, out_table, centers, ctxs,
                        pool_rows, lr, lam, window, pc, pn, 0, u_cap)


def fused_sgns_dedup_step_plain(in_table, out_table, centers, ctxs, pool_rows,
                                lr: float, lam: float, window: int,
                                centers_per_block: int = 256, pool_size: int = 64,
                                u_cap: int = 512):
    """The plain version of :func:`fused_sgns_dedup_step`."""
    _check_u_cap(u_cap)
    return _merged_plain(in_table, out_table, centers, ctxs, pool_rows, lr, lam, window,
                         centers_per_block, pool_size, 0, u_cap)


fused_sgns_dedup_step.launches = 0


def fused_sgns_dedup_resident_step(in_table: torch.Tensor, out_table: torch.Tensor,
                                   centers: torch.Tensor, ctxs: torch.Tensor,
                                   pool_rows: torch.Tensor, lr: float, lam: float,
                                   window: int, centers_per_block: int = 256,
                                   pool_size: int = 64, u_cap: int = 512,
                                   hot_rows: int = 512):
    """Both merges composed (``fused-dedup-res``); returns ``(in_table,
    out_table, loss)``, tables updated in place. Needs ``u_cap`` >= the
    effective hot rows, so that every hot context row is in its block's
    unique list."""
    pc, pn = centers_per_block, pool_size
    _check_grouped("fused_sgns_dedup_resident_step", in_table, out_table, centers, ctxs,
                   pool_rows, pc, pn)
    _check_u_cap(u_cap)
    hot_n = _composed_hot_n(hot_rows, u_cap, in_table, out_table)
    return _merged_step(fused_sgns_dedup_resident_step, in_table, out_table, centers,
                        ctxs, pool_rows, lr, lam, window, pc, pn, hot_n, u_cap)


def fused_sgns_dedup_resident_step_plain(in_table, out_table, centers, ctxs, pool_rows,
                                         lr: float, lam: float, window: int,
                                         centers_per_block: int = 256, pool_size: int = 64,
                                         u_cap: int = 512, hot_rows: int = 512):
    """The plain version of :func:`fused_sgns_dedup_resident_step`."""
    _check_u_cap(u_cap)
    hot_n = _composed_hot_n(hot_rows, u_cap, in_table, out_table)
    return _merged_plain(in_table, out_table, centers, ctxs, pool_rows, lr, lam, window,
                         centers_per_block, pool_size, hot_n, u_cap)


fused_sgns_dedup_resident_step.launches = 0
