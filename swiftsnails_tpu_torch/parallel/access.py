"""Parameter access methods (update rules) — the JAX package's ``parallel/access.py``.

Counterpart of the reference's ``PullAccessMethod`` /
``PushAccessMethod`` interfaces (``src/core/parameter/sparse_access_method.h:10-48``):
``init_param`` (eager, whole table), ``init_slots`` and ``apply_push_value``
(the update of a batch of merged, unique rows). Two rules: plain SGD and
AdaGrad. The stores push each through a row kernel where one fits
(:mod:`swiftsnails_tpu_torch.parallel.store`), else through gather ->
``apply_push_value`` -> write. On the 2-D plane a rule may also push
without a sort (:meth:`AccessMethod.scatter_update`): SGD as one scatter-add,
AdaGrad with a per-sample accumulator.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from swiftsnails_tpu_torch.ops.rowdma import adagrad_step

Slots = Dict[str, torch.Tensor]


class AccessMethod:
    """Base update rule. Subclass and override."""

    def init_param(
        self,
        generator: torch.Generator,
        shape: Tuple[int, ...],
        dtype: torch.dtype,
        fan_in: Optional[int] = None,
    ) -> torch.Tensor:
        """Initial parameter values, on the generator's device.

        Matches the reference's ``Vec::randInit``: U(-0.5, 0.5)/dim
        (``src/utils/vec1.h:223-226``). ``fan_in`` overrides the scaling dim
        when the storage row is wider than the logical row (the packed
        layout pads the last axis). Drawn in float32, then cast.
        """
        dim = fan_in or (shape[-1] if len(shape) > 1 else 1)
        u = torch.rand(shape, generator=generator, device=generator.device,
                       dtype=torch.float32)
        return ((u - 0.5) / dim).to(dtype)

    def init_slots(self, shape: Tuple[int, ...], dtype: torch.dtype,
                   device: torch.device) -> Slots:
        """Zero-initialized optimizer slot tensors, row-aligned with the table."""
        return {}

    def apply_push_value(self, param: torch.Tensor, slots: Slots, grad: torch.Tensor,
                         lr) -> Tuple[torch.Tensor, Slots]:
        """Apply merged gradients to a batch of rows; returns new tensors.

        ``grad`` follows the reference's push convention: workers push raw
        gradients and the server's access method owns the update rule
        (``server/init.h:115-135``). The stores call it on gathered rows and
        write the result back with ``scatter_write_rows``.
        """
        raise NotImplementedError(
            f"{type(self).__name__} has no apply_push_value, which the "
            "gather -> apply -> scatter_write_rows push needs")

    def scatter_update(self, table: torch.Tensor, slots: Slots, rows: torch.Tensor,
                       grads: torch.Tensor, lr) -> Optional[Slots]:
        """The 2-D plane's sort-free push of ``grads`` (``[N, dim]``, rows
        may repeat) into ``table`` and ``slots``, in place; returns the
        slots, or ``None`` where only the exact merge-then-apply push is
        valid (the base rule).

        Rows outside ``[0, C)`` are dropped (the JAX package's
        ``mode="drop"``). Each scatter is ``index_put_`` with
        ``accumulate=True``: serial on the CPU and a sort-based kernel on the
        card, so duplicates add in batch order and two runs give the same
        bits (``index_add_`` on the card adds with float atomics).
        """
        return None


def _scatter_add(dst: torch.Tensor, rows: torch.Tensor, valid: torch.Tensor,
                 vals: torch.Tensor) -> None:
    """``dst[rows] += vals`` in place, duplicates in batch order; rows not
    ``valid`` add -0.0 to row 0, which leaves every value as it was."""
    vals = vals.to(dst.dtype).masked_fill(~valid[:, None], -0.0)
    dst.index_put_((rows,), vals, accumulate=True)


def _in_range(table: torch.Tensor, rows: torch.Tensor):
    """``(row ids with the out-of-range ones set to 0, valid mask)``."""
    valid = (rows >= 0) & (rows < table.shape[0])
    return rows.long().masked_fill(~valid, 0), valid


class SgdAccess(AccessMethod):
    """Plain SGD, ``param -= lr * grad``: the stores apply it as one row
    scatter-add of ``-lr * grad`` where the table has no slots."""

    def apply_push_value(self, param, slots, grad, lr):
        return param - lr * grad.to(param.dtype), slots

    def scatter_update(self, table, slots, rows, grads, lr):
        # scatter-add sums duplicate rows itself: the merged push's math
        idx, valid = _in_range(table, rows)
        _scatter_add(table, idx, valid, -(lr * grads))
        return slots


class AdaGradAccess(AccessMethod):
    """AdaGrad: ``accum += grad**2; param -= lr * grad / sqrt(accum + eps)``.

    The Wide & Deep / CTR update rule. ``accum`` doubles table memory;
    ``slot_dtype`` stores it in another dtype (bf16 for the largest tables).
    The rule runs in float32, in the JAX package's order:
    ``lr * g * rsqrt(accum + eps)``: ``ops.rowdma.adagrad_step``, the rule
    that the row kernels' plain versions share.
    """

    def __init__(self, eps: float = 1e-8, slot_dtype: Optional[torch.dtype] = None):
        self.eps = eps
        self.slot_dtype = slot_dtype

    def init_slots(self, shape, dtype, device):
        return {"accum": torch.zeros(shape, dtype=self.slot_dtype or dtype,
                                     device=device)}

    def apply_push_value(self, param, slots, grad, lr):
        step, accum = adagrad_step(slots["accum"].float(), grad.float(), lr, self.eps)
        new_param = param - step.to(param.dtype)
        return new_param, {"accum": accum.to(slots["accum"].dtype)}

    def scatter_update(self, table, slots, rows, grads, lr):
        """The per-sample-accumulator AdaGrad of the JAX package: every
        sample's ``g²`` is added to its row's accumulator first, then each
        sample reads its row's accumulator after all of them
        (``index_put_`` is ordered on one stream), and the steps
        ``lr * g * rsqrt(accum + eps)`` are scatter-added. A duplicate key
        adds ``Σ g²``, where the merged rule adds ``(Σ g)²``."""
        accum = slots["accum"]
        idx, valid = _in_range(table, rows)
        g = grads.float()
        _scatter_add(accum, idx, valid, g * g)
        acc_rows = accum.index_select(0, idx).float().masked_fill(~valid[:, None], 1.0)
        step = lr * g * torch.rsqrt(acc_rows + self.eps)
        _scatter_add(table, idx, valid, -step)
        return slots
