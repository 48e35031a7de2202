"""Parameter access methods (update rules) — the JAX package's ``parallel/access.py``.

Counterpart of the reference's ``PullAccessMethod`` /
``PushAccessMethod`` interfaces (``src/core/parameter/sparse_access_method.h:10-48``):
``init_param`` (eager, whole table) and ``init_slots``. Only plain SGD is on
the port's path so far, and the store applies it; AdaGrad and the
``apply_push_value`` rule come with the CTR slice (``ROADMAP.md``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

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


class SgdAccess(AccessMethod):
    """Plain SGD, ``param -= lr * grad``: :func:`store.push_packed` applies
    it as one row scatter-add of ``-lr * grad``."""
