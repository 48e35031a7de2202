"""Factorization Machine and Field-aware FM — the JAX package's ``models/fm.py``
(BASELINE.json Avazu configs).

FM (Rendle 2010 — the reference vendors libfm's CMDLine, ``CMDLine.h:1-6``):
``logit = b + Σ_j w_j + ½(‖Σ_j v_j‖² − Σ_j ‖v_j‖²)`` with factor dim k.

FFM: each feature holds one k-vector *per field*; a pair (j1, j2) interacts
through v_{j1,field(j2)} · v_{j2,field(j1)}. Table row layout: feature j's
row is ``[w_j, v_{j,0}, ..., v_{j,F-1}]`` (dim = 1 + F*k).

Config: ``factor_dim`` (k), plus the sparse-base keys.
"""

from __future__ import annotations

import torch

from swiftsnails_tpu_torch.models.registry import register_model
from swiftsnails_tpu_torch.models.sparse_base import SparseCTRTrainer
from swiftsnails_tpu_torch.utils.config import Config


@register_model("fm")
class FMTrainer(SparseCTRTrainer):
    name = "fm"

    def __init__(self, config: Config, mesh=None, data=None, device=None):
        self.k = config.get_int("factor_dim", 8)
        super().__init__(config, mesh=mesh, data=data, device=device)

    @property
    def table_dim(self) -> int:
        return 1 + self.k

    def init_dense(self, generator):
        return {"bias": torch.zeros((), device=self.device)}

    def forward(self, pulled, dense, mask):
        w = torch.where(mask, pulled[..., 0], 0.0)  # [B, F]
        v = torch.where(mask[..., None], pulled[..., 1:], 0.0)  # [B, F, k]
        linear = w.sum(dim=1)
        s = v.sum(dim=1)  # [B, k]
        interactions = 0.5 * ((s * s).sum(-1) - (v * v).sum(dim=(1, 2)))
        return dense["bias"] + linear + interactions


@register_model("ffm")
class FFMTrainer(SparseCTRTrainer):
    name = "ffm"

    def __init__(self, config: Config, mesh=None, data=None, device=None):
        self.k = config.get_int("factor_dim", 4)
        self._num_fields = config.get_int("num_fields")
        super().__init__(config, mesh=mesh, data=data, device=device)

    @property
    def table_dim(self) -> int:
        return 1 + self._num_fields * self.k

    def init_dense(self, generator):
        return {"bias": torch.zeros((), device=self.device)}

    def forward(self, pulled, dense, mask):
        b, f = mask.shape
        w = torch.where(mask, pulled[..., 0], 0.0)
        v = pulled[..., 1:].reshape(b, f, f, self.k)  # [B, j, target_field, k]
        v = torch.where(mask[..., None, None], v, 0.0)
        # pair term: A[b, i, j] = v[b, i, j, :] . v[b, j, i, :]
        pair = torch.einsum("bijk,bjik->bij", v, v)
        upper = torch.triu(torch.ones((f, f), dtype=pair.dtype, device=pair.device),
                           diagonal=1)
        interactions = (pair * upper).sum(dim=(1, 2))
        return dense["bias"] + w.sum(dim=1) + interactions
