"""Hybrid head/tail placement: the zipf head replicated, the tail sharded —
the JAX package's ``parallel/hybrid.py``.

Uniform sharding treats every row alike, so the zipf head of a skewed
vocabulary pays the collectives' indirection every substep although a few
rows take most of the traffic. Parallax's observation (PAPERS.md): rows
accessed densely want replication and a dense gradient reduce, rows
accessed sparsely want the sharded pull and push. The split, on top of the
port's store and transfer planes:

* **head**: the first ``cut`` logical rows, whole on every rank. A pull is
  a rank-local gather (no collective, no bytes); a push adds the batch's
  gradients into a dense ``[cut, ...]`` f32 buffer (a deterministic
  segment sum, duplicates merged before the update) and reduces it once
  over ``data`` through :func:`~swiftsnails_tpu_torch.parallel.comm.reduce_sum_quantized`,
  the wire options of the sharded push (``comm_dtype``, the dither seed;
  the 2-D plane's per-sample AdaGrad reduces the squares too, with seed
  ``+ 1``). With ``zero=True`` the buffer is reduce-scattered instead,
  each data rank updates its own ``cut / data`` rows (its slot planes are
  that slice alone, :mod:`swiftsnails_tpu_torch.parallel.zero`) and only
  the parameter slice is all-gathered back: bit for bit the replicated
  update at f32.
* **tail**: the rows past the cut, model-sharded as before: each rank
  holds ``(capacity - cut) / model`` of them. Row ids map to tail space
  (``row - cut``; head rows and padding to the tail's sentinel, its whole
  row count, which no shard owns) and go through the unchanged collectives
  of :mod:`~swiftsnails_tpu_torch.parallel.transfer`; on the packed plane
  through the dedup collectives at a static unique capacity ``tail_cap``
  sized from the head's coverage: the wire payload shrinks with it.

The head's gather and buffer are plain torch, as the JAX package's are XLA
code; the tail's pulls and pushes launch the row kernels
(``gather_rows``, ``scatter_add_rows``, ``scatter_adagrad_fused_rows``)
through the transfer routes. Updates are in place; the routes return the
state as well.

Checkpoints, export and serving never see :class:`HybridTableState`:
:func:`merge_table` rebuilds the uniform layout bit for bit, so a hybrid
run's files are a uniform run's (``framework/checkpoint.py``).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Union

import torch
import torch.nn.functional as F

from swiftsnails_tpu_torch.parallel.access import AccessMethod
from swiftsnails_tpu_torch.parallel.comm import (
    all_gather,
    reduce_scatter_quantized,
    reduce_sum_quantized,
    resolve_comm_dtype,
    scope,
    stochastic_wire,
    wire_bytes,
)
from swiftsnails_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    gather_model,
    model_rows,
)
from swiftsnails_tpu_torch.parallel.store import PackedTableState, TableState, small_group
from swiftsnails_tpu_torch.parallel.transfer import (
    DataLayout,
    _merge_into,
    pull_collective,
    pull_collective_packed_dedup,
    pull_collective_packed_dedup_spread,
    pull_collective_packed_small,
    push_collective,
    push_collective_packed_bucketed,
    push_collective_packed_bucketed_spread,
    push_collective_packed_dedup,
    push_collective_packed_dedup_spread,
    push_collective_packed_small,
)

ROW_LANES = 128
_U32 = 0xFFFFFFFF


class HybridTableState(NamedTuple):
    """A split table: the head whole on every rank, the tail model-sharded.

    ``head`` is the stored layout's prefix (``[cut, dim]`` 2-D, ``[cut, S,
    128]`` packed, ``[cut / G, S, 128]`` small-row); ``head_slots`` the
    matching slot prefixes (under ZeRO this rank's ``1 / data`` slice of
    each); ``tail`` a :class:`TableState` / :class:`PackedTableState` of
    this rank's tail rows."""

    head: torch.Tensor
    head_slots: Dict[str, torch.Tensor]
    tail: Union[TableState, PackedTableState]


def is_hybrid(state) -> bool:
    return isinstance(state, HybridTableState)


# ------------------------------------------------------------ split/merge ---


def _model(mesh) -> int:
    return 1 if mesh is None else mesh.axis_size(MODEL_AXIS)


def split_table(state, cut: int, mesh=None, group: int = 1) -> HybridTableState:
    """Uniform layout -> hybrid, value-preserving.

    ``cut`` counts logical rows; on the small-row plane it must be a
    multiple of ``group`` (the split lands on a tile boundary, ``cut //
    group`` stored tiles), and the tail's rows must split over ``model``.
    On a model axis of 1 the tail is a view of the table (no copy); above,
    the whole table is gathered once and cut (a collective: every rank
    calls this)."""
    if cut % group:
        raise ValueError(f"cut {cut} not aligned to small-row group {group}")
    row_cut = cut // group
    model = _model(mesh)

    def parts(t):
        whole = gather_model(mesh, t)
        if (whole.shape[0] - row_cut) % model:
            raise ValueError(f"tail of {whole.shape[0] - row_cut} rows does not split "
                             f"over model axis {model}")
        return whole[:row_cut].clone(), model_rows(mesh, whole[row_cut:])

    head, tail_table = parts(state.table)
    head_slots, tail_slots = {}, {}
    for k, v in state.slots.items():
        head_slots[k], tail_slots[k] = parts(v)
    tail = type(state)(table=tail_table, slots=tail_slots)
    return HybridTableState(head=head, head_slots=head_slots, tail=tail)


def merge_table(hs: HybridTableState, mesh=None):
    """Hybrid -> uniform layout (this rank's model shard of it), the bit-exact
    inverse of :func:`split_table`, into new tensors. ``head_slots`` must be
    whole (``ZeroManager.master_state`` first). A collective above a model
    axis of 1."""

    def cat(head, tail):
        return model_rows(mesh, torch.cat([head, gather_model(mesh, tail)]))

    table = cat(hs.head, hs.tail.table)
    slots = {k: cat(hs.head_slots[k], v) for k, v in hs.tail.slots.items()}
    return type(hs.tail)(table=table, slots=slots)


# ------------------------------------------------------------- tail remap ---


def tail_ids(rows: torch.Tensor, cut: int, tail_sentinel: int) -> torch.Tensor:
    """Row ids -> tail space: ``row - cut`` for a tail row, the tail's
    sentinel for a head row (which the collectives treat as padding). A
    uniform-space padding id (``capacity``) lands on the sentinel by
    construction: ``capacity - cut`` is the tail's row count."""
    return torch.where(rows >= cut, rows - cut, torch.full_like(rows, tail_sentinel))


def tail_rows(mesh: Mesh, hs: HybridTableState, group: int = 1) -> int:
    """The whole tail's logical rows (its sentinel)."""
    return hs.tail.table.shape[0] * mesh.axis_size(MODEL_AXIS) * group


# -------------------------------------------------------------- head pull ---


def head_pull(head: torch.Tensor, rows: torch.Tensor, layout: str, dim: int = 0,
              group: int = 1) -> torch.Tensor:
    """The head's values of ``rows`` (a rank-local gather, no collective);
    rows at or past the cut (tail rows, padding) and negative ones read
    zero, so that head + tail is each row's value."""
    cut_t = head.shape[0]
    if layout == "small":
        tiles = torch.div(rows, group, rounding_mode="floor")
        ok = (rows >= 0) & (tiles < cut_t)
        gathered = head.index_select(0, tiles.clamp(0, cut_t - 1).long())
        stride = ROW_LANES // group
        groups = gathered[:, 0, :].reshape(-1, group, stride)
        n = rows.shape[0]
        vals = groups[torch.arange(n, device=rows.device), (rows % group).long(), :dim]
        return vals.masked_fill(~ok[:, None], 0)
    ok = (rows >= 0) & (rows < cut_t)
    vals = head.index_select(0, rows.clamp(0, cut_t - 1).long())
    return vals.masked_fill(~ok.reshape(-1, *[1] * (head.dim() - 1)), 0)


# -------------------------------------------------------------- head push ---


def _head_buffer(rows: torch.Tensor, grads: torch.Tensor, cut_t: int, layout: str,
                 dim: int, group: int) -> torch.Tensor:
    """``[cut_t, ...]`` f32: the gradients of the rows below the cut added
    by row (tile, on the small-row plane; each gradient in its lane group),
    duplicates in batch order; the rest dropped."""
    if layout == "small":
        stride = ROW_LANES // group
        g_s = F.pad(grads, (0, stride - dim)) if stride > dim else grads
        n = rows.shape[0]
        flat = g_s.new_zeros(n, group, stride)
        flat[torch.arange(n, device=rows.device), (rows % group).long()] = g_s
        vals = flat.reshape(n, ROW_LANES).float()
        idx = torch.where(rows >= 0, torch.div(rows, group, rounding_mode="floor"),
                          torch.full_like(rows, cut_t))
    else:
        vals = grads.float()
        idx = torch.where(rows >= 0, rows, torch.full_like(rows, cut_t))
    return _merge_into(vals, idx, cut_t, idx >= cut_t)


def _squares_seed(seed):
    """The squares' dither seed: the gradients' ``+ 1`` (mod 2^32), from 0
    where none is given."""
    return 1 if seed is None else (seed + 1) & _U32


def head_push(mesh: Mesh, head: torch.Tensor, head_slots: Dict[str, torch.Tensor],
              rows: torch.Tensor, grads: torch.Tensor, access: AccessMethod, lr,
              layout: str, dim: int = 0, group: int = 1, comm_dtype: str = "float32",
              seed=None, zero: bool = False):
    """The head's push of this rank's ``rows`` and ``grads`` (all of them:
    tail rows and padding fall out of the buffer), in place. Returns
    ``(head, head_slots)``.

    Duplicates merge before the update, as the tail's plane does it: the
    packed and small-row planes apply the access rule to the summed
    gradient (the fused small-row AdaGrad tile: sublane 1 the accumulator),
    and the 2-D plane's AdaGrad adds the sum of the squares to the
    accumulator, the per-sample rule of its tail. ``zero``: the reduce is a
    reduce-scatter, this rank updates rows ``[i * cut / data, (i + 1) * cut
    / data)`` (``head_slots`` hold that slice), and the parameter slices
    are all-gathered."""
    comm_dtype = resolve_comm_dtype(comm_dtype)
    data = mesh.axis_size(DATA_AXIS)
    cut_t = head.shape[0]
    slot_keys = sorted(head_slots)
    fused_small = (layout == "small" and head.dim() == 3 and head.shape[1] == 2
                   and not head_slots)
    per_sample = layout == "dense" and "accum" in slot_keys
    if zero and cut_t % data:
        raise ValueError(
            f"optimizer_sharding: zero needs head rows ({cut_t}) aligned to the data "
            f"axis ({data}); widen placement alignment")
    stochastic = stochastic_wire(comm_dtype)
    if zero:
        own = cut_t // data
        i = mesh.axis_index(DATA_AXIS)
        p = head[i * own:(i + 1) * own]
        reduce = reduce_scatter_quantized
    else:
        p = head
        reduce = reduce_sum_quantized
    with scope("ssn_zero_head_push" if zero else "ssn_hybrid_head_push"):
        buf = _head_buffer(rows, grads, cut_t, layout, dim, group)
        tot = reduce(mesh, buf, DATA_AXIS, comm_dtype, stochastic=True,
                     seed=seed if stochastic else None)
        new_s = {}
        if per_sample:
            buf2 = _head_buffer(rows, grads.float().square(), cut_t, layout, dim, group)
            tot2 = reduce(mesh, buf2, DATA_AXIS, comm_dtype, stochastic=True,
                          seed=_squares_seed(seed) if stochastic else None)
            accum = head_slots["accum"].float() + tot2
            step = lr * tot * torch.rsqrt(accum + access.eps)
            new_p = p - step.to(p.dtype)
            new_s["accum"] = accum.to(head_slots["accum"].dtype)
        elif fused_small:
            cur = p.float()
            accum = cur[:, 1, :] + tot * tot
            param = cur[:, 0, :] - lr * tot * torch.rsqrt(accum + access.eps)
            new_p = torch.stack([param, accum], dim=1).to(p.dtype)
        else:
            merged = tot.reshape(p.shape[0], 1, ROW_LANES) if layout == "small" else tot
            new_p, ns = access.apply_push_value(p, dict(head_slots), merged, lr)
            new_s = {k: ns[k] for k in slot_keys}
        if zero:
            new_p = all_gather(mesh, new_p.contiguous(), DATA_AXIS)
    head.copy_(new_p)
    for k, v in new_s.items():
        head_slots[k].copy_(v)
    return head, head_slots


def head_push_bytes(cut_t: int, row_elems: int, param_elems: int, data: int,
                    comm_dtype: str, zero: bool = False, reduces: int = 1) -> int:
    """Wire bytes of one :func:`head_push` as ``COMM`` counts them: ``reduces``
    reduces of a ``[cut_t, row_elems]`` buffer (two for the 2-D plane's
    per-sample AdaGrad) and, under ``zero``, the gather of the parameter
    slices (``param_elems`` values a row)."""
    if zero:  # the reduce-scatter's all-to-all, at its operand
        one = wire_bytes("gather", cut_t, row_elems, comm_dtype)
        return reduces * one + cut_t * param_elems * 4
    if comm_dtype == "float32":  # a reduce-scatter and a gather, or one all-reduce
        f32 = cut_t * row_elems * 4
        return reduces * (2 * f32 if cut_t % data == 0 else f32)
    return reduces * wire_bytes("gather", data * cut_t, row_elems, comm_dtype)


# ------------------------------------------------------------ dense plane ---


def pull_hybrid(mesh: Mesh, hs: HybridTableState, rows: torch.Tensor,
                comm_dtype: str = "float32") -> torch.Tensor:
    """The hybrid twin of :func:`~swiftsnails_tpu_torch.parallel.transfer.pull_collective`
    on the 2-D plane."""
    cut = hs.head.shape[0]
    head_vals = head_pull(hs.head, rows, "dense")
    t_ids = tail_ids(rows, cut, tail_rows(mesh, hs))
    return head_vals + pull_collective(mesh, hs.tail, t_ids, comm_dtype=comm_dtype)


def push_hybrid(mesh: Mesh, hs: HybridTableState, rows: torch.Tensor,
                grads: torch.Tensor, access: AccessMethod, lr, exact: bool = False,
                comm_dtype: str = "float32", seed=None,
                zero: bool = False) -> HybridTableState:
    cut = hs.head.shape[0]
    t_ids = tail_ids(rows, cut, tail_rows(mesh, hs))
    push_collective(mesh, hs.tail, t_ids, grads, access, lr, exact=exact,
                    comm_dtype=comm_dtype, seed=seed)
    head_push(mesh, hs.head, hs.head_slots, rows, grads, access, lr, layout="dense",
              comm_dtype=comm_dtype, seed=seed, zero=zero)
    return hs


# ----------------------------------------------------------- packed plane ---
#
# The packed tail rides the dedup collectives at ``tail_cap`` unique rows
# (placement.tail_cap): the pull's sum and the push's gather shrink from the
# batch's slots to ``tail_cap`` rows. Rows past the cap overflow (a zero
# pull, a dropped gradient), counted, as on the dedup plane.


def pull_hybrid_packed(mesh: Mesh, hs: HybridTableState, rows: torch.Tensor,
                       tail_cap: int, comm_dtype: str = "float32"):
    """-> ``(vals [N, S, 128], the tail's (uniq, inv), overflow)``."""
    cut = hs.head.shape[0]
    head_vals = head_pull(hs.head, rows, "packed")
    t_ids = tail_ids(rows, cut, tail_rows(mesh, hs))
    tail_vals, index, overflow = pull_collective_packed_dedup(
        mesh, hs.tail, t_ids, tail_cap, comm_dtype=comm_dtype)
    return head_vals + tail_vals, index, overflow


def push_hybrid_packed(mesh: Mesh, hs: HybridTableState, rows: torch.Tensor,
                       grads: torch.Tensor, access: AccessMethod, lr, tail_cap: int,
                       index=None, comm_dtype: str = "float32", seed=None,
                       zero: bool = False):
    """-> ``(state, dropped)``; ``index`` is a pull's ``(uniq, inv)``."""
    cut = hs.head.shape[0]
    t_ids = tail_ids(rows, cut, tail_rows(mesh, hs))
    _, dropped = push_collective_packed_dedup(
        mesh, hs.tail, t_ids, grads, access, lr, tail_cap, index=index,
        comm_dtype=comm_dtype, seed=seed)
    head_push(mesh, hs.head, hs.head_slots, rows, grads, access, lr, layout="packed",
              comm_dtype=comm_dtype, seed=seed, zero=zero)
    return hs, dropped


def push_hybrid_packed_bucketed(mesh: Mesh, hs: HybridTableState, rows: torch.Tensor,
                                grads: torch.Tensor, access: AccessMethod, lr,
                                slack: float = 2.0, comm_dtype: str = "float32",
                                seed=None, zero: bool = False):
    """-> ``(state, dropped)``: the tail through the owner-bucketed push."""
    cut = hs.head.shape[0]
    t_ids = tail_ids(rows, cut, tail_rows(mesh, hs))
    _, dropped = push_collective_packed_bucketed(
        mesh, hs.tail, t_ids, grads, access, lr, slack=slack, comm_dtype=comm_dtype,
        seed=seed)
    head_push(mesh, hs.head, hs.head_slots, rows, grads, access, lr, layout="packed",
              comm_dtype=comm_dtype, seed=seed, zero=zero)
    return hs, dropped


# The word2vec trainer's out rows are not a ``P(data)`` operand (the JAX
# trainer splits one concatenation over ``data``): the ``*_spread`` twins
# take a :class:`~swiftsnails_tpu_torch.parallel.transfer.DataLayout` for
# the tail's unique lists and buckets, as the uniform plane does. The head's
# buffer is this rank's slots' sum; its total over ``data`` is the same.


def _tail_layout(mesh: Mesh, hs: HybridTableState, layout: DataLayout) -> DataLayout:
    cut = hs.head.shape[0]
    return DataLayout(rows=tail_ids(layout.rows, cut, tail_rows(mesh, hs)),
                      mine=layout.mine)


def pull_hybrid_packed_spread(mesh: Mesh, hs: HybridTableState, layout: DataLayout,
                              tail_cap: int, comm_dtype: str = "float32"):
    """:func:`pull_hybrid_packed` of this rank's slots of ``layout`` ->
    ``(vals, index, overflow)``, each chunk's tail list as the JAX shard
    makes it."""
    head_vals = head_pull(hs.head, layout.rows[layout.mine], "packed")
    tail_vals, index, overflow = pull_collective_packed_dedup_spread(
        mesh, hs.tail, _tail_layout(mesh, hs, layout), tail_cap, comm_dtype=comm_dtype)
    return head_vals + tail_vals, index, overflow


def push_hybrid_packed_spread(mesh: Mesh, hs: HybridTableState, layout: DataLayout,
                              grads: torch.Tensor, access: AccessMethod, lr, index,
                              comm_dtype: str = "float32", seed=None,
                              zero: bool = False) -> HybridTableState:
    """The push of :func:`pull_hybrid_packed_spread`'s slots (its ``index``)."""
    push_collective_packed_dedup_spread(mesh, hs.tail, grads, access, lr, index,
                                        comm_dtype=comm_dtype, seed=seed)
    head_push(mesh, hs.head, hs.head_slots, layout.rows[layout.mine], grads, access, lr,
              layout="packed", comm_dtype=comm_dtype, seed=seed, zero=zero)
    return hs


def push_hybrid_packed_bucketed_spread(mesh: Mesh, hs: HybridTableState,
                                       layout: DataLayout, grads: torch.Tensor,
                                       access: AccessMethod, lr, slack: float = 2.0,
                                       comm_dtype: str = "float32", seed=None,
                                       zero: bool = False):
    """:func:`push_hybrid_packed_bucketed` over ``layout`` -> ``(state,
    dropped)``."""
    _, dropped = push_collective_packed_bucketed_spread(
        mesh, hs.tail, _tail_layout(mesh, hs, layout), grads, access, lr, slack=slack,
        comm_dtype=comm_dtype, seed=seed)
    head_push(mesh, hs.head, hs.head_slots, layout.rows[layout.mine], grads, access, lr,
              layout="packed", comm_dtype=comm_dtype, seed=seed, zero=zero)
    return hs, dropped


# -------------------------------------------------------- small-row plane ---


def pull_hybrid_packed_small(mesh: Mesh, hs: HybridTableState, rows: torch.Tensor,
                             dim: int, comm_dtype: str = "float32") -> torch.Tensor:
    g = small_group(dim)
    cut = hs.head.shape[0] * g
    head_vals = head_pull(hs.head, rows, "small", dim=dim, group=g)
    t_ids = tail_ids(rows, cut, tail_rows(mesh, hs, g))
    return head_vals + pull_collective_packed_small(mesh, hs.tail, t_ids, dim,
                                                    comm_dtype=comm_dtype)


def push_hybrid_packed_small(mesh: Mesh, hs: HybridTableState, rows: torch.Tensor,
                             grads: torch.Tensor, access: AccessMethod, lr, dim: int,
                             comm_dtype: str = "float32", seed=None,
                             zero: bool = False) -> HybridTableState:
    g = small_group(dim)
    cut = hs.head.shape[0] * g
    t_ids = tail_ids(rows, cut, tail_rows(mesh, hs, g))
    push_collective_packed_small(mesh, hs.tail, t_ids, grads, access, lr, dim,
                                 comm_dtype=comm_dtype, seed=seed)
    head_push(mesh, hs.head, hs.head_slots, rows, grads, access, lr, layout="small",
              dim=dim, group=g, comm_dtype=comm_dtype, seed=seed, zero=zero)
    return hs
