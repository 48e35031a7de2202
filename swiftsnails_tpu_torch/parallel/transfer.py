"""Explicit-collective pull/push over a ``(data, model)`` mesh — the JAX
package's ``parallel/transfer.py``, f32 wire only.

The reference's substrate is an async RPC round trip fanned out per server
and joined on a ``StateBarrier`` (``src/core/transfer/transfer.h:55-268``,
``global_pull_access.h:40-55``, ``global_push_access.h:36-53``). Here, as
in the JAX package, the two protocols are collectives over the mesh's
process groups (:mod:`swiftsnails_tpu_torch.parallel.mesh`); each rank holds
one model shard of a table (``[per, ...]``, its rows ``[m * per, (m + 1) *
per)``) and one data shard of the batch:

* **pull** (WORKER_PULL_REQUEST): each model shard reads the rows it owns
  for its data shard's ids and writes zeros for the rest; one
  ``all_reduce(SUM)`` over ``model`` assembles full rows on every rank.
  Each element is ``x + 0``: the pull is exact.
* **push** (WORKER_PUSH_REQUEST): the ids and gradients are
  ``all_gather``\\ ed over ``data`` in data-rank order (the workers send
  their gradients); rows this shard does not own go to the padding row
  ``per``, and the shard-local push applies the rest. Every replica along
  ``data`` sees the same gathered batch and makes the same update.

The 2-D plane's shard-local work is :func:`~swiftsnails_tpu_torch.parallel.store.pull`
/ :func:`~swiftsnails_tpu_torch.parallel.store.push` (fast or ``exact``);
the packed plane's is ``pull_packed`` / ``push_packed``, which launch
``gather_rows`` and ``scatter_add_rows`` on the card; the small-row
plane's (:func:`pull_collective_packed_small`,
:func:`push_collective_packed_small`, the CTR tables) is
``pull_packed_small`` / ``push_packed_small``, which launch
``gather_rows`` and the AdaGrad or SGD row kernel. There ownership is
tile-granular: logical row ``r`` lives in tile ``r // G``, which model
shard ``(r // G) // per_t`` owns, so a shard owns ``per_t * G``
contiguous logical rows.

Every collective takes ``comm_dtype`` (:mod:`swiftsnails_tpu_torch.parallel.comm`)
and the pushes a dither ``seed``, as in the JAX package: the pulls
quantize deterministically (``psum_quantized``), the pushes' gradients
dither (``all_gather_quantized(..., stochastic=True)``, the seed salted
with the sender's data index), the ids move as int32, and ``float32``
takes the plain collectives.

The static-capacity planes of the packed tables, as in the JAX package:

* **dedup** (:func:`pull_collective_packed_dedup`,
  :func:`push_collective_packed_dedup`): a data shard moves each distinct
  row once, through a sorted unique list of ``u_cap`` entries
  (:func:`_unique_static`); the push merges into that list before the
  gather;
* **owner-bucketed push** (:func:`push_collective_packed_bucketed`, and
  :func:`push_collective_bucketed` on the 2-D plane): merge locally, keep
  the rows the model shard owns in a static bucket of
  :func:`bucket_capacity` entries (:func:`_compact_owned`), gather the
  buckets over ``data``.

Rows beyond a cap overflow (a zero pull, a dropped gradient for the step);
the count comes back as a device scalar, summed over the mesh. The merges
are the deterministic segment sum of :func:`~swiftsnails_tpu_torch.parallel.store.segment_sum`.

Those functions take this rank's part of the JAX package's ``P(data)``
operand, which is what a data shard holds of an array sharded row-wise.
The JAX word2vec trainer's out rows are not such an array: it concatenates
the whole batch's context rows and then the pools (``_id_cat``), and the
``shard_map`` splits that concatenation into contiguous chunks over
``data``, so a chunk holds other shards' windows. The ``*_spread``
variants take the whole array on every rank (:class:`DataLayout`: the
ids are small) and this rank's slots in it: each rank computes every
chunk's unique list or buckets from the ids, and adds its own slots'
gradients into them, which one all-reduce over ``data`` sums. The chunks,
caps and overflow counts are the JAX package's.

The plain push of rows that are not a ``P(data)`` operand (the out rows
above) dithers each row as the JAX sender of its chunk does: ``place`` (see
:func:`layout_place`) gives a row its offset in its chunk and the chunk's
salted seed. The spread pushes under a codec first reduce-scatter the
partial sums in f32 (one all-to-all over ``data``, rank ``j`` keeping
chunk ``j``, under the scope ``ssn_spread_reduce_scatter``), so that rank
``j`` quantizes chunk ``j``'s whole sum with salt ``j``, as the JAX shard
does; then the narrow gather.

:data:`COMM` counts each collective and the bytes it moves on the wire on
this rank (codes, scales and ids), at the call site, and by the JAX
package's ``ssn_*`` scope names: ``Trainer.step_cost`` reports the same
count for a step as ``total_bytes``.

The tiered cache plane (``table_tier: host`` under a mesh, the JAX
package's slot collectives): the JAX ``pull_collective_slots`` and
``push_collective_slots`` are the pulls and pushes above run on a cache
shard in slot space (a shard's rows, and so the padding id, come from
the cache); :func:`scatter_slots_collective` installs
faulted rows shard-local with ``scatter_write_rows`` and moves nothing;
:func:`gather_slots_collective` reads evicted slots whole on every rank
(an owned gather and an all-reduce over ``model``, billed to
``ssn_tier_flush_gather``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from swiftsnails_tpu_torch.parallel.access import AccessMethod
from swiftsnails_tpu_torch.parallel.comm import (  # noqa: F401  (COMM, reset_comm, comm_bytes: this module's API)
    COMM,
    all_gather,
    all_gather_quantized,
    all_reduce,
    all_to_all,
    comm_bytes,
    ordered_sum,
    psum_quantized,
    reset_comm,
    resolve_comm_dtype,
    salted,
    scope,
    wire_bytes,
)
from swiftsnails_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh
from swiftsnails_tpu_torch.parallel.store import (
    PackedTableState,
    TableState,
    merge_duplicate_rows,
    pull,
    pull_packed,
    pull_packed_small,
    push,
    push_packed,
    push_packed_small,
    segment_sum,
    small_group,
    sort_segments,
)


def pull_bytes(n: int, row_elems: int, elem_size: int, comm_dtype: str = "float32") -> int:
    """Wire bytes of a pull of ``n`` ids (the all-reduce of the rows)."""
    return wire_bytes("sum", n, row_elems, comm_dtype, elem_size)


def push_bytes(n: int, row_elems: int, data: int, id_size: int = 4,
               comm_dtype: str = "float32") -> int:
    """Wire bytes of a push of ``n`` ids and their gradients (two
    all-gathers over ``data`` ranks)."""
    return data * n * id_size + wire_bytes("gather", data * n, row_elems, comm_dtype)


def _owned(mesh: Mesh, rows: torch.Tensor, per: int):
    """``(rows - m * per, owned)`` for this rank's model shard ``m``."""
    local = rows - mesh.axis_index(MODEL_AXIS) * per
    return local, (local >= 0) & (local < per)


def _mask_owned(mesh: Mesh, rows_all: torch.Tensor, grads_all: torch.Tensor, per: int,
                stride: int = 1):
    """Shard-local ids of ``rows_all``, the unowned ones sent past the
    shard's rows with a zero gradient: each to an id of its own (``per +
    stride * i``), so that the push's merge, a sort-based segment sum on
    the card, meets no long run of them (a grouped window's pads are ~40%
    of its slots, and half a ``(2, 2)`` mesh's gathered CTR rows are
    another shard's). ``stride``: logical rows a tile, so that each spare
    id has a tile of its own. The push skips every id at or past ``per``."""
    local, owned = _owned(mesh, rows_all, per)
    spare = per + stride * torch.arange(local.shape[0], dtype=local.dtype,
                                        device=local.device)
    local = torch.where(owned, local, spare)
    mask = owned.reshape(owned.shape + (1,) * (grads_all.dim() - 1))
    return local, grads_all.masked_fill(~mask, 0)


def _gather_grads(mesh: Mesh, grads: torch.Tensor, comm_dtype: str, seed=None,
                  place=None) -> torch.Tensor:
    """A push's gradients of every data shard, in data-rank order, over
    the wire ``comm_dtype`` (dithered with ``seed``, or at ``place``)."""
    return all_gather_quantized(mesh, grads, DATA_AXIS, comm_dtype, stochastic=True,
                                seed=seed, place=place)


def _gather_owned(mesh: Mesh, rows: torch.Tensor, grads: torch.Tensor, per: int,
                  comm_dtype: str = "float32", seed=None, place=None):
    """The push's exchange: ids and gradients of every data shard, the
    unowned ids sent to the padding row ``per`` with a zero gradient."""
    rows_all = all_gather(mesh, rows, DATA_AXIS)
    grads_all = _gather_grads(mesh, grads, comm_dtype, seed, place)
    return _mask_owned(mesh, rows_all, grads_all, per)


def layout_place(mesh: Mesh, n_sharded: int, n_whole: int, seed):
    """``place`` for a push of this rank's slots of ``cat([S, whole])`` (the
    layout of :func:`data_layout`, ``n_sharded`` rows of ``S`` a rank and
    ``n_whole`` rows of ``whole`` in all): each slot's offset in its JAX
    chunk (``D`` contiguous chunks of the concatenation) and that chunk's
    seed, ``seed`` salted with the chunk's index. Quantizing each row there
    makes the JAX shard's codes: int8 scales a row and int4's blocks lie in
    one."""
    d = mesh.axis_size(DATA_AXIS)
    pos = _mine(mesh, n_sharded, n_whole, mesh.device)
    chunk = (d * n_sharded + n_whole) // d
    return pos % chunk, salted(seed, pos // chunk)


def pull_collective(mesh: Mesh, state: TableState, rows: torch.Tensor,
                    comm_dtype: str = "float32") -> torch.Tensor:
    """Sharded 2-D gather ``[N, dim]`` of this data shard's ``rows``
    (global ids): owned rows read, the rest zeros, summed over ``model``."""
    comm_dtype = resolve_comm_dtype(comm_dtype)
    with scope("ssn_pull_collective"):
        local, owned = _owned(mesh, rows, state.capacity)
        vals = pull(state, torch.where(owned, local, 0))
        return psum_quantized(mesh, vals.masked_fill(~owned[:, None], 0), MODEL_AXIS,
                              comm_dtype)


def push_collective(mesh: Mesh, state: TableState, rows: torch.Tensor,
                    grads: torch.Tensor, access: AccessMethod, lr,
                    exact: bool = False, comm_dtype: str = "float32",
                    seed=None) -> TableState:
    """Sharded 2-D push of this data shard's ``[N, dim]`` gradients: the
    data shards' batches gathered, then :func:`store.push` (fast or
    ``exact``) of the owned rows on this shard, in place."""
    comm_dtype = resolve_comm_dtype(comm_dtype)
    with scope("ssn_push_collective"):
        local, grads_all = _gather_owned(mesh, rows, grads, state.capacity, comm_dtype, seed)
    return push(state, local, grads_all, access, lr, exact=exact)


def pull_collective_packed(mesh: Mesh, state: PackedTableState, rows: torch.Tensor,
                           comm_dtype: str = "float32") -> torch.Tensor:
    """Sharded packed gather ``[N, S, 128]``: ``gather_rows`` of the owned
    rows on this shard, zeros for the rest, summed over ``model``."""
    comm_dtype = resolve_comm_dtype(comm_dtype)
    with scope("ssn_pull_collective_packed"):
        return _pull_packed_rows(mesh, state, rows, comm_dtype)


def push_collective_packed(mesh: Mesh, state: PackedTableState, rows: torch.Tensor,
                           grads: torch.Tensor, access: AccessMethod, lr,
                           comm_dtype: str = "float32", seed=None,
                           place=None) -> PackedTableState:
    """Sharded packed push of ``[N, S, 128]`` gradients: the data shards'
    batches gathered, then ``push_packed`` (merge, ``scatter_add_rows``)
    of the owned rows on this shard, in place. ``place``
    (:func:`layout_place`): where each row's dither comes from, for rows
    that are not this rank's ``P(data)`` slice."""
    comm_dtype = resolve_comm_dtype(comm_dtype)
    with scope("ssn_push_collective_packed"):
        local, grads_all = _gather_owned(mesh, rows, grads, state.capacity, comm_dtype,
                                         seed, place)
    return push_packed(state, local, grads_all, access, lr)


# ------------------------------------------------ the small-row plane ---


def small_rows_per_shard(state: PackedTableState, dim: int) -> int:
    """Logical rows a model shard of a small-row table owns: its tiles
    (this rank's ``[per_t, S, 128]``) times ``G`` (the JAX
    ``_tiles_per_shard``; the tile count's divisibility by the model axis
    is checked where the shard is made,
    :func:`~swiftsnails_tpu_torch.parallel.store.create_packed_small_table`)."""
    return state.table.shape[0] * small_group(dim)


def pull_collective_packed_small(mesh: Mesh, state: PackedTableState, rows: torch.Tensor,
                                 dim: int, comm_dtype: str = "float32") -> torch.Tensor:
    """Sharded small-row gather ``[N, dim]`` of this data shard's logical
    ``rows``: ``pull_packed_small`` of the owned rows on this shard (one
    ``gather_rows`` launch), zeros for the rest, summed over ``model``."""
    comm_dtype = resolve_comm_dtype(comm_dtype)
    with scope("ssn_pull_collective_packed_small"):
        local, owned = _owned(mesh, rows, small_rows_per_shard(state, dim))
        vals = pull_packed_small(PackedTableState(table=state.table, slots={}),
                                 torch.where(owned, local, 0), dim)
        return psum_quantized(mesh, vals.masked_fill(~owned[:, None], 0), MODEL_AXIS,
                              comm_dtype)


def push_collective_packed_small(mesh: Mesh, state: PackedTableState, rows: torch.Tensor,
                                 grads: torch.Tensor, access: AccessMethod, lr, dim: int,
                                 comm_dtype: str = "float32", seed=None) -> PackedTableState:
    """Sharded small-row push of this data shard's ``[N, dim]``
    gradients: ids and gradients gathered over ``data`` in data-rank
    order, the unowned ones masked (each to a spare tile of its own, past
    the shard's, with a zero gradient: no hot padding tile), then
    ``push_packed_small`` of the rest on this shard (one row-kernel
    launch), in place."""
    comm_dtype = resolve_comm_dtype(comm_dtype)
    with scope("ssn_push_collective_packed_small"):
        rows_all = all_gather(mesh, rows, DATA_AXIS)
        grads_all = _gather_grads(mesh, grads, comm_dtype, seed)
    local, grads_all = _mask_owned(mesh, rows_all, grads_all,
                                   small_rows_per_shard(state, dim), stride=small_group(dim))
    return push_packed_small(state, local, grads_all, access, lr, dim)


def gather_table(mesh: Mesh, table: torch.Tensor) -> torch.Tensor:
    """The whole table from its model shards (export and eval)."""
    return all_gather(mesh, table, MODEL_AXIS)


# ------------------------------------------- dedup and bucketed planes ---


def _invalid_row(mesh: Mesh, state: PackedTableState) -> int:
    """The padding id: the whole table's capacity, which no shard owns."""
    return state.capacity * mesh.axis_size(MODEL_AXIS)


def _scalar(t: torch.Tensor) -> torch.Tensor:
    """A count as the metrics carry it: an int32 device scalar."""
    return t.to(torch.int32).reshape(())


def _count_over(mesh: Mesh, count: torch.Tensor, *axes: str) -> torch.Tensor:
    """``count`` summed over each of ``axes`` in turn (one all-reduce of
    an int32 each)."""
    count = count.to(torch.int32).reshape(1)
    for axis in axes:
        count = all_reduce(mesh, count, axis)
    return _scalar(count)


def bucket_capacity(local_n: int, model: int, slack: float) -> int:
    """Static bucket size a sender a model shard for the owner-bucketed push.

    Under hashed (uniform) placement a shard owns about ``local_n / model``
    of a sender's distinct rows; the cap is ``slack`` times that, rounded up
    to a multiple of 8 (at least 8) and clamped to ``local_n``, where the
    bucketed push is the exact gather push. One model shard: ``local_n``."""
    if model <= 1:
        return local_n
    cap = -(-int(slack * local_n) // model)
    cap = max(-(-cap // 8) * 8, 8)
    return min(cap, local_n)


def _owned_first(uniq: torch.Tensor, m: int, per: int):
    """``(owned, order)``: which ids of ``uniq`` model shard ``m`` owns, and
    the positions of ``uniq`` with the owned ones first, each group in its
    order (a stable sort)."""
    local = uniq - m * per
    owned = (local >= 0) & (local < per)
    order = torch.argsort((~owned).to(torch.uint8), stable=True)
    return owned, order


def _owned_overflow(uniq: torch.Tensor, per: int, model: int, cap: int) -> torch.Tensor:
    """The distinct rows of ``uniq`` past each model shard's cap, summed
    over the shards (ids at or past ``per * model`` are padding)."""
    owner = torch.where(uniq < per * model, uniq // per, model).long()
    counts = torch.zeros(model + 1, dtype=torch.int64, device=uniq.device)
    counts.scatter_add_(0, owner, torch.ones_like(owner))
    return (counts[:model] - cap).clamp(min=0).sum()


def _compact_owned(uniq: torch.Tensor, merged: torch.Tensor, m: int, per: int,
                   cap: int, invalid: int):
    """The rows of a merged batch (``uniq``, ``merged``) that model shard
    ``m`` owns, owned first in order, in a static ``[cap]`` bucket padded
    with ``invalid`` and zero gradients. Returns ``(rows, grads,
    overflow)``: the owned rows that did not fit are dropped."""
    owned, order = _owned_first(uniq, m, per)
    take = order[:cap]
    ok = owned[take]
    rows = torch.where(ok, uniq[take], invalid)
    grads = merged[take].masked_fill(~ok.reshape(-1, *[1] * (merged.dim() - 1)), 0)
    return rows, grads, (owned.sum() - cap).clamp(min=0)


def _unique_static(rows: torch.Tensor, cap: int, invalid: int):
    """Static-size dedup: ``(uniq [cap], inv [n], overflow)``. ``uniq``
    holds the distinct ids ascending, ``invalid`` past their count;
    ``inv[i]`` is the position of ``rows[i]`` in ``uniq``, or ``cap`` where
    its id did not fit; ``overflow`` counts the distinct ids that did not."""
    n = rows.shape[0]
    order, r, grp = sort_segments(rows)
    slot = grp.clamp(max=cap)
    uniq = torch.full((cap + 1,), invalid, dtype=rows.dtype, device=rows.device)
    uniq.scatter_(0, slot, r)  # a group's writes carry equal ids; slot cap is cut
    inv = torch.empty(n, dtype=torch.int32, device=rows.device)
    inv[order] = slot.to(torch.int32)
    return uniq[:cap], inv, (grp[-1] + 1 - cap).clamp(min=0)


def _merge_into(grads: torch.Tensor, idx: torch.Tensor, n: int,
                junk: torch.Tensor) -> torch.Tensor:
    """``[n, ...]``: the rows of ``grads`` summed by ``idx`` (each in ``[0,
    n)`` where not ``junk``). A junk slot (an overflowed or dropped one,
    or a padding id's, whose gradient no shard applies) goes to a discard
    row of its own, so that no long run of them serializes the card's
    sort-based segment sum."""
    pos = torch.arange(idx.shape[0], dtype=torch.int64, device=idx.device)
    k = torch.where(junk, n + pos, idx.long())
    return segment_sum(grads, k, n + idx.shape[0])[:n]


def _junk(uniq: torch.Tensor, inv: torch.Tensor, invalid: int) -> torch.Tensor:
    """The slots whose id overflowed its unique list (``inv == len(uniq)``)
    or is a padding id, which no shard owns."""
    ext = torch.cat([uniq, uniq.new_full((1,), invalid)])
    return ext[inv.long()] >= invalid


def _expand(vals: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """The rows of ``vals`` at ``inv``; ``inv == len(vals)`` reads zeros."""
    ext = torch.cat([vals, vals.new_zeros((1, *vals.shape[1:]))])
    return ext.index_select(0, inv)


def pull_collective_packed_dedup(mesh: Mesh, state: PackedTableState, rows: torch.Tensor,
                                 u_cap: int, comm_dtype: str = "float32"):
    """Dedup'd sharded packed gather of this data shard's ``rows``: the
    unique list's owned rows pulled on this shard, summed over ``model``
    (``u_cap`` rows), expanded back to the slots. Returns ``(vals [N, S,
    128], (uniq, inv), overflow)``: an overflowed slot reads a zero row;
    ``overflow`` is summed over ``data``. Pass ``(uniq, inv)`` to
    :func:`push_collective_packed_dedup` for the same ``rows``."""
    comm_dtype = resolve_comm_dtype(comm_dtype)
    with scope("ssn_pull_collective_packed_dedup"):
        uniq, inv, overflow = _unique_static(rows, u_cap, _invalid_row(mesh, state))
        vals = _pull_packed_rows(mesh, state, uniq, comm_dtype)
        return _expand(vals, inv), (uniq, inv), _count_over(mesh, overflow, DATA_AXIS)


def _pull_packed_rows(mesh: Mesh, state: PackedTableState, rows: torch.Tensor,
                      comm_dtype: str) -> torch.Tensor:
    """:func:`pull_collective_packed`'s work, billed to the caller's scope."""
    local, owned = _owned(mesh, rows, state.capacity)
    vals = pull_packed(PackedTableState(table=state.table, slots={}),
                       torch.where(owned, local, 0))
    return psum_quantized(mesh, vals.masked_fill(~owned[:, None, None], 0), MODEL_AXIS,
                          comm_dtype)


def push_collective_packed_dedup(mesh: Mesh, state: PackedTableState, rows: torch.Tensor,
                                 grads: torch.Tensor, access: AccessMethod, lr, u_cap: int,
                                 index=None, comm_dtype: str = "float32", seed=None):
    """Sender-dedup'd packed push: this data shard's gradients merged into
    its unique list before the gather over ``data``, then the shard-local
    push of the owned rows. Returns ``(state, dropped)``.

    ``index``: the ``(uniq, inv)`` of :func:`pull_collective_packed_dedup`
    over the same ``rows``; the sort is skipped and ``dropped`` is 0, the
    pull having counted the overflow."""
    comm_dtype = resolve_comm_dtype(comm_dtype)
    invalid = _invalid_row(mesh, state)
    with scope("ssn_push_collective_packed_dedup"):
        if index is not None:
            (uniq, inv), dropped = index, torch.zeros((), dtype=torch.int32, device=rows.device)
        else:
            uniq, inv, overflow = _unique_static(rows, u_cap, invalid)
            dropped = _count_over(mesh, overflow, DATA_AXIS)
        merged = _merge_into(grads, inv, u_cap, _junk(uniq, inv, invalid))
        local, grads_all = _gather_owned(mesh, uniq, merged, state.capacity, comm_dtype, seed)
    push_packed(state, local, grads_all, access, lr)
    return state, dropped


def push_collective_packed_bucketed(mesh: Mesh, state: PackedTableState, rows: torch.Tensor,
                                    grads: torch.Tensor, access: AccessMethod, lr,
                                    slack: float = 2.0, comm_dtype: str = "float32",
                                    seed=None):
    """Owner-bucketed packed push of this data shard's ``[N, S, 128]``
    gradients: merged locally, this model shard's owned rows compacted into
    a static bucket (:func:`bucket_capacity` of ``N``), the buckets gathered
    over ``data``, the shard-local push. Returns ``(state, dropped)``, the
    rows past the caps summed over ``data`` and ``model``."""
    comm_dtype = resolve_comm_dtype(comm_dtype)
    model, invalid = mesh.axis_size(MODEL_AXIS), _invalid_row(mesh, state)
    cap = bucket_capacity(rows.shape[0], model, slack)
    with scope("ssn_push_collective_packed_bucketed"):
        uniq, merged = merge_duplicate_rows(rows, grads, invalid_row=invalid)
        b_rows, b_grads, overflow = _compact_owned(
            uniq, merged, mesh.axis_index(MODEL_AXIS), state.capacity, cap, invalid)
        local, grads_all = _gather_owned(mesh, b_rows, b_grads, state.capacity, comm_dtype,
                                         seed)
        push_packed(state, local, grads_all, access, lr)
        return state, _count_over(mesh, overflow, DATA_AXIS, MODEL_AXIS)


def push_collective_bucketed(mesh: Mesh, state: TableState, rows: torch.Tensor,
                             grads: torch.Tensor, access: AccessMethod, lr,
                             slack: float = 2.0, comm_dtype: str = "float32", seed=None):
    """The 2-D plane's owner-bucketed push of this data shard's ``[N,
    dim]`` gradients: merged locally, this model shard's owned rows
    compacted into a static bucket (:func:`bucket_capacity` of ``N``), the
    buckets gathered over ``data``, merged again and the rule applied to
    each unique row once (:func:`~swiftsnails_tpu_torch.parallel.store.apply_rows`),
    in place. Returns ``(state, dropped)``, the rows past the caps summed
    over ``data`` and ``model``."""
    comm_dtype = resolve_comm_dtype(comm_dtype)
    model, per = mesh.axis_size(MODEL_AXIS), state.capacity
    invalid = per * model
    cap = bucket_capacity(rows.shape[0], model, slack)
    with scope("ssn_push_collective_bucketed"):
        uniq, merged = merge_duplicate_rows(rows, grads, invalid_row=invalid)
        b_rows, b_grads, overflow = _compact_owned(
            uniq, merged, mesh.axis_index(MODEL_AXIS), per, cap, invalid)
        local, grads_all = _gather_owned(mesh, b_rows, b_grads, per, comm_dtype, seed)
        push(state, local, grads_all, access, lr, exact=True)
        return state, _count_over(mesh, overflow, DATA_AXIS, MODEL_AXIS)


class DataLayout(NamedTuple):
    """An id array split over ``data`` in contiguous chunks that no rank
    holds alone: ``rows``, the whole array, the same on every rank;
    ``mine``, the positions in it of this rank's slots, in the order of the
    rank's own rows (its pulled values and its gradients)."""

    rows: torch.Tensor
    mine: torch.Tensor


def data_layout(mesh: Mesh, sharded: torch.Tensor, whole: torch.Tensor) -> DataLayout:
    """The layout of ``cat([S, whole])``, where ``S`` is data-sharded and
    ``sharded`` is this rank's contiguous slice of it (gathered here, one
    all-gather of ids over ``data``), and ``whole`` an array every rank
    holds whole whose contiguous data slices are the ranks' own. This rank's
    slots: its slice of ``S``, then its slice of ``whole``."""
    with scope("ssn_out_layout"):
        rows = torch.cat([all_gather(mesh, sharded, DATA_AXIS), whole.to(sharded.dtype)])
    return DataLayout(rows=rows, mine=_mine(mesh, sharded.shape[0], whole.shape[0],
                                            sharded.device))


def _mine(mesh: Mesh, a: int, n_whole: int, device) -> torch.Tensor:
    """This rank's positions in ``cat([S, whole])``: its ``a`` rows of
    ``S``, then its contiguous data slice of ``whole``'s ``n_whole``."""
    d, i = mesh.axis_size(DATA_AXIS), mesh.axis_index(DATA_AXIS)
    b = n_whole // d
    return torch.cat([torch.arange(i * a, (i + 1) * a, device=device),
                      torch.arange(d * a + i * b, d * a + (i + 1) * b, device=device)])


def pull_collective_packed_dedup_spread(mesh: Mesh, state: PackedTableState,
                                        layout: DataLayout, u_cap: int,
                                        comm_dtype: str = "float32"):
    """:func:`pull_collective_packed_dedup` over a :class:`DataLayout`:
    each chunk's unique list as the JAX package's data shard makes it, all
    of them pulled on every rank (their owned rows, one all-reduce over
    ``model`` of ``D * u_cap`` rows), expanded to this rank's slots.
    Returns ``(vals, index, overflow)``, the overflow of every chunk
    summed; ``index`` is for :func:`push_collective_packed_dedup_spread`."""
    comm_dtype = resolve_comm_dtype(comm_dtype)
    d, invalid = mesh.axis_size(DATA_AXIS), _invalid_row(mesh, state)
    uniqs, invs, overflow = [], [], 0
    for j, chunk in enumerate(layout.rows.chunk(d)):
        uniq, inv, over = _unique_static(chunk, u_cap, invalid)
        uniqs.append(uniq)
        invs.append(torch.where(inv < u_cap, inv + j * u_cap, d * u_cap))
        overflow = overflow + over
    uniq = torch.cat(uniqs)
    slots = torch.cat(invs)[layout.mine]
    with scope("ssn_pull_collective_packed_dedup"):
        vals = _pull_packed_rows(mesh, state, uniq, comm_dtype)
    return _expand(vals, slots), (uniq, slots), _scalar(overflow)


def _chunk_sums(mesh: Mesh, partial: torch.Tensor, comm_dtype: str, seed) -> torch.Tensor:
    """Every chunk's sum of the ranks' ``partial`` (``D`` contiguous chunks
    over ``data``), on every rank: f32, one all-reduce; a codec, the
    partials reduce-scattered in f32 (rank ``j`` adding chunk ``j``'s in
    rank order), then chunk ``j``'s sum quantized on rank ``j`` (dither
    salted ``j``) and gathered narrow."""
    if comm_dtype == "float32":
        return all_reduce(mesh, partial, DATA_AXIS)
    d = mesh.axis_size(DATA_AXIS)
    with scope("ssn_spread_reduce_scatter"):
        parts = all_to_all(mesh, partial, DATA_AXIS).reshape((d, -1) + tuple(partial.shape[1:]))
    return _gather_grads(mesh, ordered_sum(parts), comm_dtype, seed)


def push_collective_packed_dedup_spread(mesh: Mesh, state: PackedTableState,
                                        grads: torch.Tensor, access: AccessMethod, lr,
                                        index, comm_dtype: str = "float32",
                                        seed=None) -> PackedTableState:
    """The push of :func:`pull_collective_packed_dedup_spread`'s slots:
    this rank's gradients added into every chunk's unique list, the
    chunks' sums on every rank (:func:`_chunk_sums`: what the JAX
    package's gather of the merged lists yields), the shard-local push of
    the owned rows."""
    comm_dtype = resolve_comm_dtype(comm_dtype)
    uniq, slots = index
    n = uniq.shape[0]
    junk = _junk(uniq, slots, _invalid_row(mesh, state))
    with scope("ssn_push_collective_packed_dedup"):
        merged = _chunk_sums(mesh, _merge_into(grads, slots, n, junk), comm_dtype, seed)
    local, merged = _mask_owned(mesh, uniq, merged, state.capacity)
    return push_packed(state, local, merged, access, lr)


def push_collective_packed_bucketed_spread(mesh: Mesh, state: PackedTableState,
                                           layout: DataLayout, grads: torch.Tensor,
                                           access: AccessMethod, lr, slack: float = 2.0,
                                           comm_dtype: str = "float32", seed=None):
    """:func:`push_collective_packed_bucketed` over a :class:`DataLayout`:
    each chunk merged and bucketed for this model shard as the JAX
    package's data shard does it, this rank's gradients added into the
    buckets, every chunk's sums on every rank (:func:`_chunk_sums`), the
    shard-local push.
    Returns ``(state, dropped)``: every chunk's rows past every model
    shard's cap, counted from the ids on each rank."""
    comm_dtype = resolve_comm_dtype(comm_dtype)
    d, model = mesh.axis_size(DATA_AXIS), mesh.axis_size(MODEL_AXIS)
    m, per, invalid = mesh.axis_index(MODEL_AXIS), state.capacity, _invalid_row(mesh, state)
    n = layout.rows.shape[0] // d
    cap = bucket_capacity(n, model, slack)
    b_rows, b_slots, dropped = [], [], 0
    for j, chunk in enumerate(layout.rows.chunk(d)):
        order, r, seg_sorted = sort_segments(chunk)
        seg = torch.empty_like(seg_sorted)
        seg[order] = seg_sorted  # each slot's distinct id
        uniq = torch.full((n,), invalid, dtype=chunk.dtype, device=chunk.device)
        uniq.scatter_(0, seg_sorted, r)
        owned, first = _owned_first(uniq, m, per)
        rank = torch.empty_like(first)
        rank[first] = torch.arange(n, device=chunk.device)
        take = owned & (rank < cap)  # the distinct ids in this shard's bucket
        slot = torch.where(take, rank, cap)[seg]
        b_slots.append(torch.where(slot < cap, slot + j * cap, d * cap))
        b_rows.append(torch.where(owned[first[:cap]], uniq[first[:cap]], invalid))
        dropped = dropped + _owned_overflow(uniq, per, model, cap)
    slots = torch.cat(b_slots)[layout.mine]
    with scope("ssn_push_collective_packed_bucketed"):
        grads_all = _chunk_sums(mesh, _merge_into(grads, slots, d * cap, slots >= d * cap),
                                comm_dtype, seed)
    local, grads_all = _mask_owned(mesh, torch.cat(b_rows), grads_all, per)
    push_packed(state, local, grads_all, access, lr)
    return state, _scalar(dropped)


# ---------------------------------------------------- the tiered cache plane ---
#
# The host tier (tiered/): under a mesh the card's working-set cache is a
# row-sharded plane like any other table. Capacity and the padding id derive
# from the shard's rows, so the pulls and pushes above already run in
# cache-slot space, with the cache budget as the padding id. The moves the
# tier adds are the install of faulted rows and the read of evicted ones.


def scatter_slots_collective(mesh: Mesh, plane: torch.Tensor, slot_ids: torch.Tensor,
                             values: torch.Tensor) -> torch.Tensor:
    """Install faulted rows into this rank's shard of a row-sharded cache
    plane, in place; returns ``plane``.

    ``slot_ids`` (unique) and ``values`` are the same on every rank (the
    fault batch is small beside the plane): rank ``m`` writes ``slot_ids -
    m * per`` and skips every id outside ``[0, per)``, the JAX shard_map's
    drop scatter. That skip is ``scatter_write_rows``' own rule for rows
    outside the table, so the kernel takes the ids as they are where a row
    is whole 16-byte words; elsewhere the owned ones go to ``index_put_``.
    No table bytes cross ranks, and no collective is made."""
    from swiftsnails_tpu_torch.ops import rowdma
    from swiftsnails_tpu_torch.serving.kernels import whole_words

    local, owned = _owned(mesh, slot_ids, plane.shape[0])
    values = values.to(plane.dtype)
    if whole_words(plane):
        return rowdma.scatter_write_rows(plane, local.to(torch.int32), values.contiguous())
    return plane.index_put_((local[owned].long(),), values[owned])


def gather_slots_collective(mesh: Mesh, plane: torch.Tensor, slot_ids: torch.Tensor
                            ) -> torch.Tensor:
    """The rows of cache slots ``slot_ids`` (the same on every rank) of a
    row-sharded cache plane, whole on every rank: each rank gathers the
    slots it owns (``gather_rows`` where a row is whole 16-byte words, else
    ``index_select``), zeros for the rest, and one f32 all-reduce over
    ``model`` adds them (``x + 0``: exact). The flush's snapshot of evicted
    slots, made on the loop's thread before a slot is reused."""
    from swiftsnails_tpu_torch.ops import rowdma
    from swiftsnails_tpu_torch.serving.kernels import whole_words

    local, owned = _owned(mesh, slot_ids, plane.shape[0])
    idx = torch.where(owned, local, 0).to(torch.int32)
    with scope("ssn_tier_flush_gather"):
        vals = (rowdma.gather_rows(plane, idx) if whole_words(plane)
                else plane.index_select(0, idx))
        mask = owned.reshape(owned.shape + (1,) * (plane.dim() - 1))
        return all_reduce(mesh, vals.masked_fill(~mask, 0), MODEL_AXIS)
