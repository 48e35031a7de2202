"""Sparse logistic regression — the JAX package's ``models/logreg.py`` (the
reference's second app, survey §2.7: ``src/apps/logistic_regression`` —
key = feature id, Val = float weight, Grad = float, SGD; the BASELINE.json
Criteo-1M config)."""

from __future__ import annotations

import torch

from swiftsnails_tpu_torch.models.registry import register_model
from swiftsnails_tpu_torch.models.sparse_base import SparseCTRTrainer


@register_model("logreg")
class LogisticRegressionTrainer(SparseCTRTrainer):
    name = "logreg"

    @property
    def table_dim(self) -> int:
        return 1

    def init_dense(self, generator):
        return {"bias": torch.zeros((), device=self.device)}

    def forward_flops(self, b, f):
        return b * f  # the masked sum

    def forward(self, pulled, dense, mask):
        w = pulled[..., 0]  # [B, F]
        return torch.where(mask, w, 0.0).sum(dim=1) + dense["bias"]
