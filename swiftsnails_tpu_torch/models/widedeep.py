"""Wide & Deep CTR — the JAX package's ``models/widedeep.py`` (BASELINE.json
Criteo-1TB config: 1B-row hashed sparse table, AdaGrad).

Wide side: sparse linear weights over hashed feature ids (the reference-style
PS table). Deep side: field embeddings concatenated into an MLP. One shared
table row per feature carries ``[w, e_0..e_{k-1}]`` (dim = 1 + k) so wide
weight and deep embedding move in one pull/push.

The MLP keeps the JAX package's ``x @ w`` layout: ``w{i}`` is
``[d_in, d_out]``, so its weights carry over without a transpose. Its
products are ``torch.matmul`` (the JAX package left them to XLA, outside any
Pallas kernel), in full float32: TF32 stays off.

Config: ``embed_dim`` (k), ``hidden_dims`` (list, e.g. "256,128"), plus the
sparse-base keys. ``dense_tp`` (the tensor-parallel MLP under a mesh) is not
ported and raises.
"""

from __future__ import annotations

import math
from typing import List

import torch

from swiftsnails_tpu_torch.models.registry import register_model
from swiftsnails_tpu_torch.models.sparse_base import Dense, SparseCTRTrainer
from swiftsnails_tpu_torch.utils.config import Config


@register_model("widedeep")
class WideDeepTrainer(SparseCTRTrainer):
    name = "widedeep"

    def __init__(self, config: Config, mesh=None, data=None, device=None):
        self.k = config.get_int("embed_dim", 16)
        hidden = config.get_str("hidden_dims", "128,64")
        self.hidden_dims: List[int] = [
            int(x) for x in hidden.replace(";", ",").split(",") if x]
        super().__init__(config, mesh=mesh, data=data, device=device)

    @property
    def table_dim(self) -> int:
        return 1 + self.k

    def init_dense(self, generator: torch.Generator) -> Dense:
        """He init, ``N(0, 1) * sqrt(2 / d_in)``, drawn from ``generator``
        (seeded from ``seed + 17``); zero biases."""
        dims = [self.num_fields * self.k] + self.hidden_dims + [1]
        dev = self.device
        params: Dense = {"bias": torch.zeros((), device=dev)}
        for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
            w = torch.randn((d_in, d_out), generator=generator, device=dev)
            params[f"w{i}"] = w * math.sqrt(2.0 / d_in)
            params[f"b{i}"] = torch.zeros((d_out,), device=dev)
        return params

    def _mlp(self, dense: Dense, x: torch.Tensor) -> torch.Tensor:
        n_layers = len(self.hidden_dims) + 1
        for i in range(n_layers):
            x = x @ dense[f"w{i}"] + dense[f"b{i}"]
            if i < n_layers - 1:
                x = torch.relu(x)
        return x[..., 0]

    def forward(self, pulled, dense, mask):
        b, f = mask.shape
        wide = torch.where(mask, pulled[..., 0], 0.0).sum(dim=1)
        emb = torch.where(mask[..., None], pulled[..., 1:], 0.0)  # [B, F, k]
        deep = self._mlp(dense, emb.reshape(b, f * self.k))
        return dense["bias"] + wide + deep
