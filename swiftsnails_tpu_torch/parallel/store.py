"""The packed parameter store on one device — the JAX package's ``parallel/store.py``.

Replaces the reference's parameter layer (SURVEY §2.5): one pre-initialized
dense table of shape ``[capacity, S, 128]`` on the device (the hashing trick
places keys, :func:`swiftsnails_tpu_torch.ops.hashing.hash_row`), pulled and
pushed through the row kernels of :mod:`swiftsnails_tpu_torch.ops.rowdma`:

* ``GlobalPullAccess::pull_with_barrier`` -> :func:`pull_packed`, one row
  gather;
* ``merge_push_value`` (``sparsetable.h:176-179``) ->
  :func:`merge_duplicate_rows`, a sort and a deterministic segment sum;
* ``GlobalPushAccess::push_with_barrier`` + the server's
  ``apply_push_value`` -> :func:`push_packed`: merge, then one row
  scatter-add of the unique rows (SGD).

Pull and push route by the tensor's device: the kernel wrappers launch the
CUDA kernels for a CUDA tensor and run their plain versions for a CPU one.
Tables are updated in place where the JAX package donated the buffer.
Trainers differentiate with respect to the *pulled rows* and push explicitly,
so every per-step tensor is batch-sized, as in the reference's wire protocol.

Not ported yet (``ROADMAP.md``): the 2-D ``TableState`` plane, meshes,
non-SGD access methods (they need ``scatter_write_rows``), the small-row CTR
plane and the tiered cache plane.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from swiftsnails_tpu_torch.ops import rowdma
from swiftsnails_tpu_torch.parallel.access import AccessMethod, SgdAccess, Slots
from swiftsnails_tpu_torch.utils.device import DeviceLike, resolve_device


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


def push_packed(
    state: PackedTableState,
    rows: torch.Tensor,
    grads: torch.Tensor,
    access: AccessMethod,
    lr,
) -> PackedTableState:
    """Merge duplicates -> SGD step -> row scatter-add, in place.

    ``grads`` is [N, S, 128]. The merge implements ``merge_push_value``
    exactly; unique rows make the scatter-add race-free. Returns the state,
    whose table tensor was updated in place.
    """
    if not isinstance(access, SgdAccess) or state.slots:
        raise NotImplementedError(
            f"push_packed with {type(access).__name__}: only SGD without "
            "slots is ported; other access rules need scatter_write_rows "
            "(ROADMAP.md, Queue 2)")
    uniq, merged = merge_duplicate_rows(rows, grads, invalid_row=state.capacity)
    deltas = (-lr * merged).to(state.table.dtype)
    rowdma.scatter_add_rows(state.table, uniq, deltas)
    return state
