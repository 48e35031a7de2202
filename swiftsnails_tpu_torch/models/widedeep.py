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
sparse-base keys, and ``dense_tp`` (``1``: the tensor-parallel MLP under a
mesh).

``dense_tp: 1`` under a mesh lays the MLP out over ``model`` as Megatron
does, the JAX package's ``_tp_shard_dense``: the even hidden layers split
by column (each rank its ``d_out / model`` columns of ``w{i}`` and of
``b{i}``), the odd ones by row (its ``d_in / model`` rows of ``w{i}``,
``b{i}`` whole), the last projection whole. A column-parallel layer's
input enters through :class:`_CopyToModel` (the identity; its backward
all-reduces the input's gradient over ``model``), a row-parallel layer's
partial products are all-reduced over ``model`` (:class:`_ReduceFromModel`)
before its bias, and a last layer after a column-parallel one gathers the
activations (:class:`_GatherFromModel`). The math is the unsharded MLP's;
only the sums' order differs. The hidden widths must divide by the model
axis. The loop cuts the whole tensors (and their AdaGrad sums) into this
rank's slices after init and restore and gathers them back for saves and
at the end (:class:`DenseTP`), so checkpoints and the returned state hold
the whole weights; ``forward`` takes either.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from swiftsnails_tpu_torch.models.registry import register_model
from swiftsnails_tpu_torch.models.sparse_base import CTRState, Dense, SparseCTRTrainer
from swiftsnails_tpu_torch.parallel.comm import all_gather, all_reduce
from swiftsnails_tpu_torch.parallel.mesh import MODEL_AXIS
from swiftsnails_tpu_torch.utils.config import Config


class _CopyToModel(torch.autograd.Function):
    """The identity; the backward all-reduces the gradient over ``model``
    (a column-parallel layer's input: each rank's columns add their part)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(ctx.mesh, g.contiguous().clone(), MODEL_AXIS), None


class _ReduceFromModel(torch.autograd.Function):
    """The sum over ``model`` of the ranks' partial products (a
    row-parallel layer); the backward passes the gradient through."""

    @staticmethod
    def forward(ctx, x, mesh):
        return all_reduce(mesh, x.contiguous().clone(), MODEL_AXIS)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    """The ranks' column slices of the activations gathered whole along the
    last dim; the backward keeps this rank's columns of the gradient."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        ctx.cols = x.shape[-1]
        parts = all_gather(mesh, x.contiguous().unsqueeze(0), MODEL_AXIS)
        return parts.movedim(0, -2).reshape(*x.shape[:-1], -1)

    @staticmethod
    def backward(ctx, g):
        m = ctx.mesh.axis_index(MODEL_AXIS)
        return g[..., m * ctx.cols:(m + 1) * ctx.cols].contiguous(), None


def _tp_dim(i: int, n_layers: int, name: str) -> Optional[int]:
    """The dim along which ``dense_tp`` cuts layer ``i``'s weight (``w``) or
    bias (``b``): columns of an even layer, rows of an odd one's weight,
    ``None`` for the last layer and an odd layer's bias."""
    if i == n_layers - 1:
        return None
    if i % 2 == 0:
        return 1 if name == "w" else 0
    return 0 if name == "w" else None


class DenseTP:
    """``dense_tp``'s layout of a state (the loop's ``adopt`` /
    ``master_state``): whole dense tensors and AdaGrad sums <-> this rank's
    model slices. ``master_state`` is a collective (every rank calls it; one
    all-gather a sliced tensor, not counted in ``COMM``)."""

    def __init__(self, trainer: "WideDeepTrainer"):
        self.trainer = trainer
        self.mesh = trainer.mesh

    def _cuts(self) -> Dict[str, int]:
        n = len(self.trainer.hidden_dims) + 1
        out = {}
        for i in range(n):
            for name in ("w", "b"):
                dim = _tp_dim(i, n, name)
                if dim is not None:
                    out[f"{name}{i}"] = dim
        return out

    def _map(self, state: CTRState, fn) -> CTRState:
        cuts = self._cuts()
        dense = {k: fn(v, cuts[k]) if k in cuts else v for k, v in state.dense.items()}
        opt = state.opt
        if opt:
            opt = {"sum_of_squares": {k: fn(v, cuts[k]) if k in cuts else v
                                      for k, v in opt["sum_of_squares"].items()}}
        return CTRState(table=state.table, dense=dense, opt=opt)

    def adopt(self, state: CTRState) -> CTRState:
        model, m = self.mesh.axis_size(MODEL_AXIS), self.mesh.axis_index(MODEL_AXIS)
        if model == 1 or self.trainer._sliced(state.dense):
            return state

        def cut(t, dim):
            per = t.shape[dim] // model
            return t.narrow(dim, m * per, per).clone()

        return self._map(state, cut)

    def master_state(self, state: CTRState) -> CTRState:
        model = self.mesh.axis_size(MODEL_AXIS)
        if not self.trainer._sliced(state.dense):
            return state

        def gather(t, dim):
            parts = [torch.empty_like(t) for _ in range(model)]
            dist.all_gather(parts, t.contiguous(), group=self.mesh.groups[MODEL_AXIS])
            return torch.cat(parts, dim=dim)

        return self._map(state, gather)

    def sharded(self, state: CTRState) -> List[Tuple[torch.Tensor, str]]:
        """``(tensor, "model")`` for each dense tensor and AdaGrad sum of
        ``state`` that holds this rank's model slice (the guardrail's count
        of the global state)."""
        if not self.trainer._sliced(state.dense):
            return []
        out = []
        self._map(state, lambda t, dim: out.append((t, MODEL_AXIS)) or t)
        return out


@register_model("widedeep")
class WideDeepTrainer(SparseCTRTrainer):
    name = "widedeep"

    def __init__(self, config: Config, mesh=None, data=None, device=None):
        self.k = config.get_int("embed_dim", 16)
        hidden = config.get_str("hidden_dims", "128,64")
        self.hidden_dims: List[int] = [
            int(x) for x in hidden.replace(";", ",").split(",") if x]
        super().__init__(config, mesh=mesh, data=data, device=device)
        if self._tp():
            model = mesh.axis_size(MODEL_AXIS)
            bad = [h for h in self.hidden_dims if h % model]
            if bad:
                raise ValueError(f"dense_tp: 1 needs hidden_dims divisible by the model "
                                 f"axis {model}; {bad} are not")

    def _tp(self) -> bool:
        """The tensor-parallel deep side (``dense_tp: 1``, under a mesh)."""
        return self.mesh is not None and self.config.get_bool("dense_tp", False)

    def dense_tp_manager(self):
        return DenseTP(self) if self._tp() else None

    def _sliced(self, dense: Dense) -> bool:
        """Whether ``dense`` holds this rank's model slices (:class:`DenseTP`)."""
        return self._tp() and dense["w0"].shape[1] != self._layer_dims()[1]

    @property
    def table_dim(self) -> int:
        return 1 + self.k

    def init_dense(self, generator: torch.Generator) -> Dense:
        """He init, ``N(0, 1) * sqrt(2 / d_in)``, drawn from ``generator``
        (seeded from ``seed + 17``); zero biases."""
        dims = self._layer_dims()
        dev = self.device
        params: Dense = {"bias": torch.zeros((), device=dev)}
        for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
            w = torch.randn((d_in, d_out), generator=generator, device=dev)
            params[f"w{i}"] = w * math.sqrt(2.0 / d_in)
            params[f"b{i}"] = torch.zeros((d_out,), device=dev)
        return params

    def _layer_dims(self) -> List[int]:
        return [self.num_fields * self.k] + self.hidden_dims + [1]

    def dense_size(self) -> int:
        dims = self._layer_dims()
        return 1 + sum(d_in * d_out + d_out for d_in, d_out in zip(dims[:-1], dims[1:]))

    def dense_shapes(self) -> Dict[str, Tuple[int, ...]]:
        """Whole shapes, or under ``dense_tp`` this rank's slices (the loop
        adopts :class:`DenseTP`)."""
        dims = self._layer_dims()
        model = self.mesh.axis_size(MODEL_AXIS) if self._tp() else 1
        n = len(dims) - 1
        out: Dict[str, Tuple[int, ...]] = {"bias": ()}
        for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
            w, b = [d_in, d_out], [d_out]
            if _tp_dim(i, n, "w") is not None:
                w[_tp_dim(i, n, "w")] //= model
            if _tp_dim(i, n, "b") is not None:
                b[0] //= model
            out[f"w{i}"], out[f"b{i}"] = tuple(w), tuple(b)
        return out

    def dense_collective_bytes(self, b: int) -> int:
        """``dense_tp``'s collectives in a step of ``b`` records: a
        column-parallel layer's input gradient all-reduced, a row-parallel
        layer's products all-reduced, and a last layer's input gathered
        after a column-parallel layer (f32)."""
        if not self._tp() or self.mesh.axis_size(MODEL_AXIS) == 1:
            return 0
        dims = self._layer_dims()
        n = len(dims) - 1
        total = 0
        for i in range(n - 1):
            total += 4 * b * (dims[i] if i % 2 == 0 else dims[i + 1])
        if (n - 2) % 2 == 0:  # the layer before the last is column-parallel
            total += 4 * b * dims[n - 1]
        return total

    def forward_flops(self, b, f):
        # the wide sum and the MLP's products (2 flops a multiply-add)
        dims = self._layer_dims()
        return b * f + 2 * b * sum(d_in * d_out for d_in, d_out in zip(dims[:-1], dims[1:]))

    def _mlp(self, dense: Dense, x: torch.Tensor) -> torch.Tensor:
        n_layers = len(self.hidden_dims) + 1
        if self._sliced(dense):
            return self._mlp_tp(dense, x, n_layers)
        for i in range(n_layers):
            x = x @ dense[f"w{i}"] + dense[f"b{i}"]
            if i < n_layers - 1:
                x = torch.relu(x)
        return x[..., 0]

    def _mlp_tp(self, dense: Dense, x: torch.Tensor, n_layers: int) -> torch.Tensor:
        """The MLP on this rank's slices (module docstring)."""
        mesh = self.mesh
        for i in range(n_layers):
            w, b = dense[f"w{i}"], dense[f"b{i}"]
            if i == n_layers - 1:
                if i % 2 == 1:  # after a column-parallel layer: its columns gathered
                    x = _GatherFromModel.apply(x, mesh)
                x = x @ w + b
            elif i % 2 == 0:  # column-parallel: this rank's outputs
                x = _CopyToModel.apply(x, mesh) @ w + b
            else:  # row-parallel: the partial products summed
                x = _ReduceFromModel.apply(x @ w, mesh) + b
            if i < n_layers - 1:
                x = torch.relu(x)
        return x[..., 0]

    def forward(self, pulled, dense, mask):
        b, f = mask.shape
        wide = torch.where(mask, pulled[..., 0], 0.0).sum(dim=1)
        emb = torch.where(mask[..., None], pulled[..., 1:], 0.0)  # [B, F, k]
        deep = self._mlp(dense, emb.reshape(b, f * self.k))
        return dense["bias"] + wide + deep
