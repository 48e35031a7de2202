"""The parameter store on one device — the JAX package's ``parallel/store.py``.

The 2-D plane (:class:`TableState`, :func:`create_table`, :func:`pull`,
:func:`push`, :func:`apply_rows`, :func:`export_rows`) keeps a ``[capacity,
dim]`` table and row-aligned slots. The JAX package lowers it through XLA
gathers and scatters, with no Pallas kernel, so here it is plain torch: the
pull is ``index_select``, the sort-free push the access rule's
:meth:`~swiftsnails_tpu_torch.parallel.access.AccessMethod.scatter_update`
(``index_put_`` with ``accumulate=True``, deterministic on the card), the
exact push :func:`merge_duplicate_rows` then :func:`apply_rows`. The row
kernels serve only rows of a multiple of 16 bytes, which a CTR row (dim 17,
68 bytes) is not.

The packed plane replaces the reference's parameter layer (SURVEY §2.5): one pre-initialized
dense table of shape ``[capacity, S, 128]`` on the device (the hashing trick
places keys, :func:`swiftsnails_tpu_torch.ops.hashing.hash_row`), pulled and
pushed through the row kernels of :mod:`swiftsnails_tpu_torch.ops.rowdma`:

* ``GlobalPullAccess::pull_with_barrier`` -> :func:`pull_packed`, one row
  gather;
* ``merge_push_value`` (``sparsetable.h:176-179``) ->
  :func:`merge_duplicate_rows`, a sort and a deterministic segment sum;
* ``GlobalPushAccess::push_with_barrier`` + the server's
  ``apply_push_value`` -> :func:`push_packed`: merge, then one row
  scatter-add of the unique rows (SGD), or for another access rule a gather
  of the rows and their slots, the rule, and one row write of each.

The small-row plane (:func:`create_packed_small_table`,
:func:`pull_packed_small`, :func:`push_packed_small`) packs the narrow rows
of the CTR families several to a 128-lane tile, and keeps AdaGrad's
accumulator in the same tile as the param (``[T, 2, 128]``).

Pull and push route by the tensor's device: the kernel wrappers launch the
CUDA kernels for a CUDA tensor and run their plain versions for a CPU one.
Tables are updated in place where the JAX package donated the buffer.
Trainers differentiate with respect to the *pulled rows* and push explicitly,
so every per-step tensor is batch-sized, as in the reference's wire protocol.

Not ported yet (``ROADMAP.md``): meshes. The tiered store's cache plane
(:mod:`swiftsnails_tpu_torch.tiered`) is a smaller table of these layouts.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from swiftsnails_tpu_torch.ops import rowdma
from swiftsnails_tpu_torch.parallel.access import (
    AccessMethod,
    AdaGradAccess,
    SgdAccess,
    Slots,
)
from swiftsnails_tpu_torch.utils.device import DeviceLike, resolve_device


class TableState(NamedTuple):
    """A 2-D ``[capacity, dim]`` table and its row-aligned slots."""

    table: torch.Tensor
    slots: Slots

    @property
    def capacity(self) -> int:
        return self.table.shape[0]

    @property
    def dim(self) -> int:
        return self.table.shape[1]


def create_table(
    capacity: int,
    dim: int,
    access: AccessMethod,
    dtype: torch.dtype = torch.float32,
    seed: int = 0,
    init_scale: Optional[float] = None,
    device: DeviceLike = None,
) -> TableState:
    """A fully initialized ``[capacity, dim]`` table on ``device`` (default:
    the card), values from a ``torch.Generator`` seeded with ``seed``
    (:mod:`swiftsnails_tpu_torch.convert` carries a JAX table across where
    equal values are needed)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    param = access.init_param(gen, (capacity, dim), dtype)
    if init_scale is not None:
        param = param * init_scale
    return TableState(table=param.contiguous(),
                      slots=access.init_slots((capacity, dim), dtype, dev))


def pull(state: TableState, rows: torch.Tensor) -> torch.Tensor:
    """Gather rows -> ``[N, dim]`` (``index_select``; ids must be in range)."""
    return state.table.index_select(0, rows)


def export_rows(state: TableState, rows: torch.Tensor) -> torch.Tensor:
    """Raw rows for export; ids outside ``[0, C)`` read zeros."""
    valid = (rows >= 0) & (rows < state.capacity)
    vals = state.table.index_select(0, rows.long().masked_fill(~valid, 0))
    return vals.masked_fill(~valid[:, None], 0)


def apply_rows(table: torch.Tensor, slots: Slots, uniq: torch.Tensor,
               merged: torch.Tensor, access: AccessMethod, lr) -> None:
    """Gather the rows ``uniq`` and their slots, apply
    ``access.apply_push_value``, write each back, in place. ``uniq`` holds
    each row at most once, the ids at or past capacity last (as
    :func:`merge_duplicate_rows` leaves them); those read nothing and are
    not written."""
    n = int((uniq < table.shape[0]).sum())  # one host sync: the exact path
    idx = uniq[:n].long()
    cur_slots = {k: v.index_select(0, idx) for k, v in slots.items()}
    new_param, new_slots = access.apply_push_value(
        table.index_select(0, idx), cur_slots, merged[:n], lr)
    table.index_copy_(0, idx, new_param.to(table.dtype))
    for k, v in slots.items():
        v.index_copy_(0, idx, new_slots[k].to(v.dtype))


def push(state: TableState, rows: torch.Tensor, grads: torch.Tensor,
         access: AccessMethod, lr, exact: bool = False) -> TableState:
    """Apply ``[N, dim]`` gradients of rows that may repeat, in place.

    The default is the access rule's sort-free ``scatter_update`` (SGD: the
    merged push's math; AdaGrad: the per-sample accumulator). ``exact=True``,
    or a rule without one, merges duplicates (:func:`merge_duplicate_rows`)
    and applies the rule to each unique row once (:func:`apply_rows`).
    Returns the state, whose tensors were updated in place.
    """
    if not exact and access.scatter_update(
            state.table, state.slots, rows, grads, lr) is not None:
        return state
    uniq, merged = merge_duplicate_rows(rows, grads, invalid_row=state.capacity)
    apply_rows(state.table, state.slots, uniq, merged, access, lr)
    return state


class PackedTableState(NamedTuple):
    """Packed table [capacity, S, 128] + row-aligned slots.

    The logical row width (dim) is not part of the state — trainers own it;
    padding lanes are zero by construction and stay zero.
    """

    table: torch.Tensor
    slots: Slots

    @property
    def capacity(self) -> int:
        return self.table.shape[0]


def create_packed_table(
    capacity: int,
    dim: int,
    access: AccessMethod,
    dtype: torch.dtype = torch.float32,
    seed: int = 0,
    init_scale: Optional[float] = None,
    device: DeviceLike = None,
) -> PackedTableState:
    """A fully initialized packed table on ``device`` (default: the card).

    Initialized as if it were ``[capacity, dim]`` (``fan_in=dim``), with the
    padding lanes zero. The values come from a ``torch.Generator`` seeded
    with ``seed`` on the device, so they differ from the JAX package's
    threefry draws; :mod:`swiftsnails_tpu_torch.convert` carries a JAX
    table across where equal values are needed.
    """
    dev = resolve_device(device)
    shape = rowdma.packed_shape(capacity, dim)
    s = shape[1]
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    param = access.init_param(gen, (capacity, s * rowdma.ROW_LANES), dtype,
                              fan_in=dim)
    if init_scale is not None:
        param = param * init_scale
    param[:, dim:] = 0
    slots = {k: v.reshape(shape) for k, v in access.init_slots(
        (capacity, s * rowdma.ROW_LANES), dtype, dev).items()}
    return PackedTableState(table=param.reshape(shape), slots=slots)


def merge_duplicate_rows(
    rows: torch.Tensor, grads: torch.Tensor, invalid_row: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Combine gradients of duplicate rows (``merge_push_value`` parity).

    Returns ``(uniq_rows, merged)`` of the same length as the input: slot
    ``i < n_unique`` holds a distinct row id (ascending) and the sum of its
    gradients; the remaining slots hold ``invalid_row`` and a zero gradient,
    so the scatter that follows skips them. Static shapes, no host sync.

    Deterministic on both devices: a stable sort, then a segment sum that
    adds each row's gradients in batch order. On the card that sum is
    ``index_put_`` with ``accumulate=True`` (a sort-based kernel, not
    atomics); on the CPU it is ``index_add_``, which is serial there.
    """
    n = rows.shape[0]
    order = torch.argsort(rows, stable=True)
    r = rows[order]
    g = grads[order]
    head = torch.ones(n, dtype=torch.bool, device=rows.device)
    head[1:] = r[1:] != r[:-1]
    seg = torch.cumsum(head, 0) - 1  # [n] int64, segment id per sorted slot
    merged = torch.zeros_like(grads)
    if grads.device.type == "cuda":
        merged.index_put_((seg,), g, accumulate=True)
    else:
        merged.index_add_(0, seg, g)
    uniq = torch.full((n,), invalid_row, dtype=rows.dtype, device=rows.device)
    uniq.scatter_(0, seg, r)  # duplicate writes carry equal values
    return uniq, merged


def pull_packed(state: PackedTableState, rows: torch.Tensor) -> torch.Tensor:
    """Gather packed rows -> [N, S, 128] (the pull: one row-gather launch)."""
    return rowdma.gather_rows(state.table, rows)


def _apply_and_write(table: torch.Tensor, slots: Slots, uniq: torch.Tensor,
                     merged: torch.Tensor, access: AccessMethod, lr) -> None:
    """The push of any access rule, in place: gather the unique rows and
    their slots, apply ``access.apply_push_value``, write each back with
    ``scatter_write_rows``. Padding slots (``uniq`` at or past capacity)
    read row 0 and are not written."""
    safe = torch.where(uniq < table.shape[0], uniq, torch.zeros_like(uniq))
    cur = rowdma.gather_rows(table, safe)
    cur_slots = {k: rowdma.gather_rows(v, safe) for k, v in slots.items()}
    new_param, new_slots = access.apply_push_value(cur, cur_slots, merged, lr)
    rowdma.scatter_write_rows(table, uniq, new_param.to(table.dtype).contiguous())
    for k, v in slots.items():
        rowdma.scatter_write_rows(v, uniq, new_slots[k].to(v.dtype).contiguous())


def push_packed(
    state: PackedTableState,
    rows: torch.Tensor,
    grads: torch.Tensor,
    access: AccessMethod,
    lr,
) -> PackedTableState:
    """Merge duplicates -> apply the access rule -> row writeback, in place.

    ``grads`` is [N, S, 128]. The merge implements ``merge_push_value``
    exactly; unique rows make the writes race-free. SGD on a table without
    slots is one row scatter-add of ``-lr * grad``; any other rule gathers
    the rows and their slots, applies ``access.apply_push_value`` and
    writes each back (two gathers and two writes for AdaGrad). Returns the
    state, whose tensors were updated in place.
    """
    uniq, merged = merge_duplicate_rows(rows, grads, invalid_row=state.capacity)
    if isinstance(access, SgdAccess) and not state.slots:
        deltas = (-lr * merged).to(state.table.dtype)
        rowdma.scatter_add_rows(state.table, uniq, deltas)
        return state
    _apply_and_write(state.table, state.slots, uniq, merged, access, lr)
    return state


# ------------------------------------------------ small-row packed plane ---
#
# CTR tables are narrow (Criteo Wide & Deep: table_dim 17). A packed row a
# key would spend a whole [1, 128] tile on 17 values, so this plane packs
# G = 128 // stride logical rows into a tile (stride: the smallest power of
# two >= dim): row r lives in tile r // G at lanes (r % G) * stride. The
# lane groups are disjoint, so merging duplicates by tile is merging by row,
# and a lanewise rule on a tile is the per-row rule. With AdaGrad (slot dtype
# the table's) the accumulator shares the tile: [T, 2, 128], sublane 0 the
# params, sublane 1 their accumulators, moved together by one row kernel.


def small_group(dim: int) -> int:
    """Logical rows per 128-lane tile for a width-``dim`` table."""
    if dim > rowdma.ROW_LANES:
        raise ValueError(f"small-row plane requires dim <= 128, got {dim}")
    g = 1
    while g < rowdma.ROW_LANES and rowdma.ROW_LANES // (2 * g) >= dim:
        g *= 2
    return g


def _fuse_small_slots(access: AccessMethod, dtype: torch.dtype) -> bool:
    """Slot-fused storage: AdaGrad whose slot dtype is the table's."""
    return isinstance(access, AdaGradAccess) and (
        access.slot_dtype is None or access.slot_dtype == dtype)


def create_packed_small_table(
    capacity: int,
    dim: int,
    access: AccessMethod,
    dtype: torch.dtype = torch.float32,
    seed: int = 0,
    init_scale: Optional[float] = None,
    device: DeviceLike = None,
) -> PackedTableState:
    """A ``[T, S, 128]`` table of ``capacity`` logical ``dim``-rows, G a tile
    (``T = ceil(capacity / G)``), on ``device`` (default: the card).

    ``S = 2`` with the AdaGrad accumulator fused in (see
    :func:`_fuse_small_slots`), else ``S = 1`` with separate slot tensors.
    Initialized as if ``[capacity, dim]`` (``fan_in=dim``), with the lanes
    at or past ``dim`` of each stride group zero. The values come from a
    ``torch.Generator`` seeded with ``seed``; :mod:`swiftsnails_tpu_torch.convert`
    carries a JAX table across where equal values are needed.
    """
    dev = resolve_device(device)
    lanes = rowdma.ROW_LANES
    g = small_group(dim)
    stride = lanes // g
    t = -(-capacity // g)  # rounded up: the last tile's spare groups are dead
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    param = access.init_param(gen, (t, lanes), dtype, fan_in=dim)
    if init_scale is not None:
        param = param * init_scale
    live = (torch.arange(lanes, device=dev) % stride) < dim
    param = param.masked_fill(~live, 0).reshape(t, 1, lanes)
    if _fuse_small_slots(access, dtype):
        table = torch.cat([param, torch.zeros_like(param)], dim=1)
        return PackedTableState(table=table, slots={})
    slots = {k: v.reshape(t, 1, lanes)
             for k, v in access.init_slots((t, lanes), dtype, dev).items()}
    return PackedTableState(table=param.contiguous(), slots=slots)


def pull_packed_small(state: PackedTableState, rows: torch.Tensor,
                      dim: int) -> torch.Tensor:
    """Gather logical rows -> ``[N, dim]``: one tile gather (the row-gather
    kernel), then each row's lane group. Sublane 1, where it holds the fused
    accumulator, rides along and is dropped."""
    g = small_group(dim)
    stride = rowdma.ROW_LANES // g
    n = rows.shape[0]
    tiles = rowdma.gather_rows(state.table, rows // g)
    groups = tiles[:, 0, :].reshape(n, g, stride)
    return groups[torch.arange(n, device=rows.device), (rows % g).long(), :dim]


def merge_small_rows(rows: torch.Tensor, grads: torch.Tensor, dim: int,
                     n_tiles: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Logical rows and their ``[N, dim]`` gradients -> ``(uniq_tiles,
    merged)``: each gradient placed in its lane group of a 128-lane tile
    gradient, then duplicates merged by tile (:func:`merge_duplicate_rows`);
    ``merged`` is ``[N, 1, 128]`` and the padding slots hold tile
    ``n_tiles`` and a zero gradient."""
    lanes = rowdma.ROW_LANES
    g = small_group(dim)
    stride = lanes // g
    n = rows.shape[0]
    grads_s = F.pad(grads, (0, stride - dim)) if stride > dim else grads
    tile_grads = grads_s.new_zeros(n, g, stride)
    tile_grads[torch.arange(n, device=rows.device), (rows % g).long()] = grads_s
    uniq, merged = merge_duplicate_rows(rows // g, tile_grads.reshape(n, lanes),
                                        invalid_row=n_tiles)
    return uniq, merged.reshape(n, 1, lanes)


def push_packed_small(
    state: PackedTableState,
    rows: torch.Tensor,
    grads: torch.Tensor,
    access: AccessMethod,
    lr,
    dim: int,
) -> PackedTableState:
    """Merge by tile -> one row kernel, in place; ``grads`` is ``[N, dim]``.

    Each gradient goes to its lane group of a ``[N, 128]`` tile gradient;
    duplicates merge by tile, padding slots carry tile ``T`` and a zero
    gradient. Then, as the JAX package's kernel branch routes them: the
    slot-fused AdaGrad table -> ``scatter_adagrad_fused_rows``; SGD without
    slots -> ``scatter_add_rows`` of ``-lr * grad``; AdaGrad with an
    accumulator of the table's dtype -> ``scatter_adagrad_rows``; anything
    else (bf16 slots on an f32 table) -> gather, ``apply_push_value``,
    ``scatter_write_rows`` for the table and each slot. Returns the state.
    """
    uniq, merged3 = merge_small_rows(rows, grads, dim, state.table.shape[0])
    if state.table.shape[1] == 2 and not state.slots:
        if not _fuse_small_slots(access, state.table.dtype):
            raise ValueError("slot-fused table pushed with a non-AdaGrad access method")
        rowdma.scatter_adagrad_fused_rows(state.table, uniq, merged3, lr, eps=access.eps)
        return state
    if isinstance(access, SgdAccess) and not state.slots:
        rowdma.scatter_add_rows(state.table, uniq, (-lr * merged3).to(state.table.dtype))
        return state
    accum = state.slots.get("accum")
    if (isinstance(access, AdaGradAccess) and set(state.slots) == {"accum"}
            and accum.dtype == state.table.dtype):
        rowdma.scatter_adagrad_rows(state.table, accum, uniq, merged3, lr, eps=access.eps)
        return state
    _apply_and_write(state.table, state.slots, uniq, merged3, access, lr)
    return state
