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
``gather_rows`` and ``scatter_add_rows`` on the card. A ``comm_dtype``
other than f32 (the JAX codecs) raises.

:data:`COMM` counts each collective and the bytes of its result on this
rank, at the call site: ``Trainer.step_cost`` reports the same count for a
step as ``total_bytes``.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.distributed as dist

from swiftsnails_tpu_torch.parallel.access import AccessMethod
from swiftsnails_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh
from swiftsnails_tpu_torch.parallel.store import (
    PackedTableState,
    TableState,
    pull,
    pull_packed,
    push,
    push_packed,
)

F32_WIRE = ("float32", "f32", "fp32")

# calls and result bytes on this rank, by collective
COMM: Dict[str, int] = {"all_reduce_calls": 0, "all_reduce_bytes": 0,
                        "all_gather_calls": 0, "all_gather_bytes": 0}


def reset_comm() -> None:
    for k in COMM:
        COMM[k] = 0


def comm_bytes() -> int:
    """Result bytes of every collective counted since :func:`reset_comm`."""
    return COMM["all_reduce_bytes"] + COMM["all_gather_bytes"]


def check_comm_dtype(comm_dtype: str) -> None:
    """Only the f32 wire is ported; the codecs raise."""
    if comm_dtype not in F32_WIRE:
        raise NotImplementedError(
            f"comm_dtype: {comm_dtype} is not ported yet (only float32): "
            "see ROADMAP.md Queue 1 item 6")


def all_reduce(mesh: Mesh, t: torch.Tensor, axis: str) -> torch.Tensor:
    """In-place ``SUM`` of ``t`` over ``axis``' group, counted."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.groups[axis])
    COMM["all_reduce_calls"] += 1
    COMM["all_reduce_bytes"] += t.numel() * t.element_size()
    return t


def all_gather(mesh: Mesh, t: torch.Tensor, axis: str) -> torch.Tensor:
    """``t`` of every rank of ``axis``' group, concatenated along dim 0 in
    the axis' order (the list form of ``dist.all_gather``, which every
    backend has), counted."""
    t = t.contiguous()
    parts: List[torch.Tensor] = [torch.empty_like(t) for _ in range(mesh.axis_size(axis))]
    dist.all_gather(parts, t, group=mesh.groups[axis])
    out = torch.cat(parts)
    COMM["all_gather_calls"] += 1
    COMM["all_gather_bytes"] += out.numel() * out.element_size()
    return out


def pull_bytes(n: int, row_elems: int, elem_size: int) -> int:
    """Result bytes of a pull of ``n`` ids (one all-reduce of the rows)."""
    return n * row_elems * elem_size


def push_bytes(n: int, row_elems: int, data: int, id_size: int = 4) -> int:
    """Result bytes of a push of ``n`` ids and f32 gradients (two
    all-gathers over ``data`` ranks)."""
    return data * n * (id_size + 4 * row_elems)


def _owned(mesh: Mesh, rows: torch.Tensor, per: int):
    """``(rows - m * per, owned)`` for this rank's model shard ``m``."""
    local = rows - mesh.axis_index(MODEL_AXIS) * per
    return local, (local >= 0) & (local < per)


def _gather_owned(mesh: Mesh, rows: torch.Tensor, grads: torch.Tensor, per: int):
    """The push's exchange: ids and gradients of every data shard, the
    unowned ids sent to the padding row ``per`` with a zero gradient."""
    rows_all = all_gather(mesh, rows, DATA_AXIS)
    grads_all = all_gather(mesh, grads, DATA_AXIS)
    local, owned = _owned(mesh, rows_all, per)
    local = torch.where(owned, local, per)
    mask = owned.reshape(owned.shape + (1,) * (grads_all.dim() - 1))
    return local, grads_all.masked_fill(~mask, 0)


def pull_collective(mesh: Mesh, state: TableState, rows: torch.Tensor,
                    comm_dtype: str = "float32") -> torch.Tensor:
    """Sharded 2-D gather ``[N, dim]`` of this data shard's ``rows``
    (global ids): owned rows read, the rest zeros, summed over ``model``."""
    check_comm_dtype(comm_dtype)
    local, owned = _owned(mesh, rows, state.capacity)
    vals = pull(state, torch.where(owned, local, 0))
    return all_reduce(mesh, vals.masked_fill(~owned[:, None], 0), MODEL_AXIS)


def push_collective(mesh: Mesh, state: TableState, rows: torch.Tensor,
                    grads: torch.Tensor, access: AccessMethod, lr,
                    exact: bool = False, comm_dtype: str = "float32") -> TableState:
    """Sharded 2-D push of this data shard's ``[N, dim]`` gradients: the
    data shards' batches gathered, then :func:`store.push` (fast or
    ``exact``) of the owned rows on this shard, in place."""
    check_comm_dtype(comm_dtype)
    local, grads_all = _gather_owned(mesh, rows, grads, state.capacity)
    return push(state, local, grads_all, access, lr, exact=exact)


def pull_collective_packed(mesh: Mesh, state: PackedTableState, rows: torch.Tensor,
                           comm_dtype: str = "float32") -> torch.Tensor:
    """Sharded packed gather ``[N, S, 128]``: ``gather_rows`` of the owned
    rows on this shard, zeros for the rest, summed over ``model``."""
    check_comm_dtype(comm_dtype)
    local, owned = _owned(mesh, rows, state.capacity)
    vals = pull_packed(PackedTableState(table=state.table, slots={}),
                       torch.where(owned, local, 0))
    return all_reduce(mesh, vals.masked_fill(~owned[:, None, None], 0), MODEL_AXIS)


def push_collective_packed(mesh: Mesh, state: PackedTableState, rows: torch.Tensor,
                           grads: torch.Tensor, access: AccessMethod, lr,
                           comm_dtype: str = "float32") -> PackedTableState:
    """Sharded packed push of ``[N, S, 128]`` gradients: the data shards'
    batches gathered, then ``push_packed`` (merge, ``scatter_add_rows``)
    of the owned rows on this shard, in place."""
    check_comm_dtype(comm_dtype)
    local, grads_all = _gather_owned(mesh, rows, grads, state.capacity)
    return push_packed(state, local, grads_all, access, lr)


def gather_table(mesh: Mesh, table: torch.Tensor) -> torch.Tensor:
    """The whole table from its model shards (export and eval)."""
    return all_gather(mesh, table, MODEL_AXIS)
