"""Small causal transformer LM — the long-context/sequence-parallel trainer
(the JAX package's ``models/seqlm.py``).

The reference has no sequence models (survey §5: "no attention, no notion of
sequence length"); this family exercises the sequence plane
(:mod:`swiftsnails_tpu_torch.parallel.sequence`: ring attention over a
``seq`` process group, Ulysses all-to-all) with a real trainer.

Architecture, as in the JAX package: pre-norm transformer blocks (``_norm``
has no learned scale), tanh-approximated GELU, the output tied to the
embedding (``logits = _norm(x) @ embed.T``), the loss ``log_softmax`` in
f32 averaged over B x L. Everything computes in f32.

Config keys: ``seq_len`` (256), ``n_layers`` (2), ``n_heads`` (4),
``d_model`` (128), ``attention`` (``dense`` | ``ring`` | ``ulysses``;
``ring`` when a ``seq_group`` is given, else ``dense``), ``optimizer``
(``sgd`` | ``momentum`` | ``adam`` | ``adamw``), ``learning_rate``
(3e-3), ``batch_size`` (8), ``num_iters`` (1), ``seed`` (0), ``data``,
``min_count`` (1), ``max_vocab``, ``shard_data`` (1), ``use_native`` (1).

The optimizers are optax's at their defaults, written out: ``sgd`` is
``-lr g``; ``momentum`` optax's trace (``t = g + 0.9 t``, no dampening, not
Nesterov); ``adam`` b1 0.9, b2 0.999, eps 1e-8 outside the square root,
bias correction from count 1; ``adamw`` the same plus ``1e-4 p`` (optax's
``weight_decay`` default, not ``torch.optim.AdamW``'s 1e-2). Their slots
are tensors in the state's ``opt`` (``trace``; ``count``, ``mu``, ``nu``),
so checkpoints and resume carry them.

Under a ``seq_group`` of P ranks (``attention`` ``ring`` or ``ulysses``)
each rank runs positions ``[r L/P, (r+1) L/P)`` of every window through the
whole block stack; attention is the only exchange inside the model. The
loss is the global mean: the ranks' sums of the negative log-likelihood
are all-reduced with the gradients, in one all-reduce a step, and the
gradients of the replicated parameters are summed over the group before
the update. The parameters start the same on every rank (one seed, drawn
on the CPU), and every rank of the group reads the same windows: the
corpus is not sharded under a group, as the JAX trainer, one process,
does not shard it either. With ``attention: dense`` the group is not used.

Under ``mesh=`` (a :class:`~swiftsnails_tpu_torch.parallel.mesh.Mesh`, as
the JAX trainer takes one) the ``seq`` axis, where the mesh has one, is
the group above (``ring`` by default), and a ``data`` axis splits the
batch: each rank trains its
:meth:`~swiftsnails_tpu_torch.framework.trainer.Trainer.local_batch` of
the global batch, and the NLL sum and the gradients are summed over
``data`` as over ``seq``, into one global mean. Any other axis (the CLI's
``model``) holds replicas: nothing is summed over it. Every rank makes the
same global batches, so the corpus is not sharded under a mesh either.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from swiftsnails_tpu_torch.framework.trainer import Trainer, mesh_device
from swiftsnails_tpu_torch.models.registry import register_model
from swiftsnails_tpu_torch.parallel.mesh import DATA_AXIS
from swiftsnails_tpu_torch.parallel.sequence import (
    SEQ_AXIS,
    reference_attention,
    ring_attention,
    ulysses_attention,
)
from swiftsnails_tpu_torch.utils.config import Config
from swiftsnails_tpu_torch.utils.device import DeviceLike

OPTIMIZERS = ("adam", "adamw", "momentum", "sgd")
ATTENTIONS = ("dense", "ring", "ulysses")
# optax's defaults
_B1, _B2, _EPS = 0.9, 0.999, 1e-8
_MOMENTUM = 0.9
_ADAMW_DECAY = 1e-4


def _norm(x: torch.Tensor) -> torch.Tensor:
    x32 = x.float()
    scale = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + 1e-6)
    return (x32 * scale).to(x.dtype)


def param_leaves(params: Dict[str, Any]) -> List[torch.Tensor]:
    """The parameters in a fixed order: ``embed``, ``pos``, then each
    block's ``wqkv``, ``wo``, ``w1``, ``w2``."""
    out = [params["embed"], params["pos"]]
    for blk in params["blocks"]:
        out.extend(blk[k] for k in ("wqkv", "wo", "w1", "w2"))
    return out


def params_from_leaves(leaves: List[torch.Tensor]) -> Dict[str, Any]:
    """The inverse of :func:`param_leaves`."""
    blocks = [dict(zip(("wqkv", "wo", "w1", "w2"), leaves[i:i + 4]))
              for i in range(2, len(leaves), 4)]
    return {"embed": leaves[0], "pos": leaves[1], "blocks": blocks}


def _zeros_like_params(params: Dict[str, Any]) -> Dict[str, Any]:
    return params_from_leaves([torch.zeros_like(p) for p in param_leaves(params)])


@register_model("seqlm")
class SeqLMTrainer(Trainer):
    name = "seqlm"

    def __init__(self, config: Config, device: DeviceLike = None, corpus_ids=None,
                 vocab_size: Optional[int] = None, seq_group=None, mesh=None):
        """``device=None`` means the card, or with ``mesh`` the mesh's
        device. ``seq_group``: a ``torch.distributed`` process group, the
        ``seq`` axis (gloo for CPU tensors, NCCL for the card's). ``mesh``:
        a :class:`~swiftsnails_tpu_torch.parallel.mesh.Mesh` whose ``seq``
        axis, if any, is that group and whose ``data`` axis splits the batch
        (module docstring); not both."""
        if mesh is not None:
            if seq_group is not None:
                raise ValueError("give a seq_group or a mesh, not both")
            device = mesh_device(mesh, device)
            if SEQ_AXIS in mesh.shape:
                seq_group = mesh.groups[SEQ_AXIS]
        super().__init__(config, device)
        self.mesh = mesh
        cfg = config
        self.seq_len = cfg.get_int("seq_len", 256)
        self.n_layers = cfg.get_int("n_layers", 2)
        self.n_heads = cfg.get_int("n_heads", 4)
        self.d_model = cfg.get_int("d_model", 128)
        self.attention = cfg.get_str("attention", "ring" if seq_group is not None else "dense")
        if self.attention not in ATTENTIONS:
            raise ValueError(f"attention must be one of {list(ATTENTIONS)}, "
                             f"got {self.attention}")
        self.lr = cfg.get_float("learning_rate", 3e-3)
        self.batch_size = cfg.get_int("batch_size", 8)
        self.epochs = cfg.get_int("num_iters", 1)
        self.seed = cfg.get_int("seed", 0)
        self.optimizer = cfg.get_str("optimizer", "sgd")
        if self.optimizer not in OPTIMIZERS:
            raise ValueError(
                f"optimizer must be one of {sorted(OPTIMIZERS)}, got {self.optimizer}")
        # the group takes part only in the sequence-parallel attentions
        self.seq_group = seq_group if self.attention != "dense" else None
        if corpus_ids is None:
            from swiftsnails_tpu_torch.data.text import encode_corpus

            corpus_ids, vocab = encode_corpus(
                cfg.get_str("data"), min_count=cfg.get_int("min_count", 1),
                max_vocab=cfg.get_int("max_vocab", 0) or None,
                use_native=cfg.get_bool("use_native", True))
            vocab_size = len(vocab)
            # a process's contiguous corpus span (stdin-split parity); the
            # ranks of a seq group or a mesh share their windows, so no
            # split there
            if cfg.get_bool("shard_data", True) and seq_group is None and mesh is None:
                from swiftsnails_tpu_torch.parallel.cluster import shard_token_stream

                corpus_ids = shard_token_stream(corpus_ids)
        self.corpus_ids = np.asarray(corpus_ids, dtype=np.int32)
        self.vocab_size = int(vocab_size)
        if self.d_model % self.n_heads:
            raise ValueError("d_model must divide by n_heads")

    # -- the sequence plane ----------------------------------------------------

    def _span(self, length: int) -> tuple:
        """This rank's ``[start, stop)`` of ``length`` positions."""
        if self.seq_group is None:
            return 0, length
        rank = dist.get_rank(self.seq_group)
        size = dist.get_world_size(self.seq_group)
        if length % size:
            raise ValueError(f"sequence length {length} does not divide by the "
                             f"seq group's {size} ranks")
        per = length // size
        return rank * per, (rank + 1) * per

    def _attend(self, q, k, v):
        if self.seq_group is None:
            return reference_attention(q, k, v, causal=True)
        if self.attention == "ulysses":
            return ulysses_attention(q, k, v, self.seq_group, causal=True)
        return ring_attention(q, k, v, self.seq_group, causal=True)

    # -- model -------------------------------------------------------------------

    def init_state(self) -> Dict[str, Any]:
        """Parameters drawn from ``seed`` by a CPU ``torch.Generator``, so the
        card and the CPU, and every rank of a group, start alike (JAX's
        threefry draws cannot be matched: parity tests carry the JAX
        parameters in, ``convert.seqlm_state_from_numpy``)."""
        gen = torch.Generator().manual_seed(self.seed)
        d = self.d_model

        def normal(*shape, scale):
            return (torch.randn(*shape, generator=gen) * scale).to(self.device)

        scale = d ** -0.5
        params = {
            "embed": normal(self.vocab_size, d, scale=0.02),
            "pos": normal(self.seq_len, d, scale=0.02),
            "blocks": [],
        }
        for _ in range(self.n_layers):
            params["blocks"].append({
                "wqkv": normal(d, 3 * d, scale=scale),
                "wo": normal(d, d, scale=scale),
                "w1": normal(d, 4 * d, scale=scale),
                "w2": normal(4 * d, d, scale=(4 * d) ** -0.5),
            })
        return {"params": params, "opt": self.init_opt(params)}

    def init_opt(self, params: Dict[str, Any]) -> Dict[str, Any]:
        """The optimizer's slots for ``params``, zero."""
        if self.optimizer == "sgd":
            return {}
        if self.optimizer == "momentum":
            return {"trace": _zeros_like_params(params)}
        return {"count": torch.zeros((), dtype=torch.int32, device=self.device),
                "mu": _zeros_like_params(params), "nu": _zeros_like_params(params)}

    def forward(self, params: Dict[str, Any], tokens: torch.Tensor) -> torch.Tensor:
        """Logits for ``tokens`` ``[B, L]``: ``[B, L, vocab]``; under a seq
        group this rank's positions ``[r L/P, (r+1) L/P)``, ``[B, L/P,
        vocab]``."""
        start, stop = self._span(tokens.shape[1])
        tokens = tokens[:, start:stop].long()
        b, l = tokens.shape
        h, d = self.n_heads, self.d_model
        x = params["embed"][tokens] + params["pos"][start:stop][None]
        for blk in params["blocks"]:
            qkv = _norm(x) @ blk["wqkv"]
            q, k, v = (t.reshape(b, l, h, d // h) for t in qkv.split(d, dim=-1))
            attn = self._attend(q, k, v).reshape(b, l, d)
            x = x + attn @ blk["wo"]
            y = _norm(x)
            x = x + F.gelu(y @ blk["w1"], approximate="tanh") @ blk["w2"]
        return _norm(x) @ params["embed"].T

    def _nll_sum(self, params: Dict[str, Any], tokens: torch.Tensor) -> torch.Tensor:
        """This rank's sum of the negative log-likelihood of the next token."""
        logits = self.forward(params, tokens[:, :-1])
        start, stop = self._span(tokens.shape[1] - 1)
        targets = tokens[:, 1:][:, start:stop].long()
        logp = torch.log_softmax(logits.float(), dim=-1)
        return -logp.gather(-1, targets[..., None]).sum()

    def _groups(self) -> list:
        """The groups a step's sums go over: ``seq`` (the attention's), then
        a mesh's ``data`` axis where it has more than one rank."""
        groups = [self.seq_group] if self.seq_group is not None else []
        if self.mesh is not None and self.mesh.axis_size(DATA_AXIS) > 1:
            groups.append(self.mesh.groups[DATA_AXIS])
        return groups

    def _targets(self, tokens: torch.Tensor) -> int:
        """The global batch's B x L targets (``tokens`` being this data
        shard's)."""
        data = self.mesh.axis_size(DATA_AXIS) if self.mesh is not None else 1
        return data * tokens.shape[0] * (tokens.shape[1] - 1)

    def loss_fn(self, params: Dict[str, Any], tokens: torch.Tensor) -> torch.Tensor:
        """The mean next-token loss over the batch's B x L targets (over the
        whole group and the mesh's data shards)."""
        total = self._nll_sum(params, tokens)
        groups = self._groups()
        if groups:
            total = total.detach().clone()
            for g in groups:
                dist.all_reduce(total, group=g)
        return total / self._targets(tokens)

    # -- trainer contract --------------------------------------------------------

    def batches(self) -> Iterator[Dict[str, np.ndarray]]:
        ids = self.corpus_ids
        # +1 so each window has seq_len inputs and shifted targets
        window = self.seq_len + 1
        n_windows = len(ids) // window
        rng = np.random.default_rng(self.seed)
        for _ in range(self.epochs):
            order = rng.permutation(n_windows)
            for start in range(0, n_windows - self.batch_size + 1, self.batch_size):
                idx = order[start : start + self.batch_size]
                toks = np.stack([ids[i * window : (i + 1) * window] for i in idx])
                yield {"tokens": toks.astype(np.int32)}

    def train_step(self, state, batch, generator: Optional[torch.Generator] = None):
        """One optimizer step on ``batch["tokens"]`` ``[B, L + 1]`` (under a
        mesh this data shard's rows); updates the state's tensors in place
        and returns ``(state, {"loss"})``, the loss a device tensor (no host
        sync)."""
        tokens = batch["tokens"]
        count = self._targets(tokens)
        leaves = param_leaves(state["params"])
        with torch.enable_grad():
            live = [p.detach().requires_grad_() for p in leaves]
            nll = self._nll_sum(params_from_leaves(live), tokens)
            grads = list(torch.autograd.grad(nll / count, live))
        nll = nll.detach()
        groups = self._groups()
        if groups:
            # one all-reduce a group: the NLL sum and every gradient
            flat = torch.cat([nll.reshape(1)] + [g.reshape(-1) for g in grads])
            for g in groups:
                dist.all_reduce(flat, group=g)
            nll = flat[0]
            grads = [part.view_as(g) for part, g in
                     zip(flat[1:].split([g.numel() for g in grads]), grads)]
        with torch.no_grad():
            self._update(leaves, grads, state["opt"])
        return state, {"loss": nll / count}

    def _update(self, leaves: List[torch.Tensor], grads: List[torch.Tensor],
                opt: Dict[str, Any]) -> None:
        """optax's update and ``apply_updates``, in place."""
        lr = self.lr
        if self.optimizer == "sgd":
            for p, g in zip(leaves, grads):
                p.add_(g * -lr)
            return
        if self.optimizer == "momentum":
            for p, g, t in zip(leaves, grads, param_leaves(opt["trace"])):
                t.copy_(g + _MOMENTUM * t)
                p.add_(t * -lr)
            return
        opt["count"].add_(1)
        c = opt["count"].float()
        bc1 = 1 - torch.pow(torch.tensor(_B1, device=c.device), c)
        bc2 = 1 - torch.pow(torch.tensor(_B2, device=c.device), c)
        decay = _ADAMW_DECAY if self.optimizer == "adamw" else 0.0
        for p, g, mu, nu in zip(leaves, grads, param_leaves(opt["mu"]),
                                param_leaves(opt["nu"])):
            mu.copy_((1 - _B1) * g + _B1 * mu)
            nu.copy_((1 - _B2) * (g * g) + _B2 * nu)
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + _EPS)
            if decay:
                u = u + decay * p
            p.add_(u * -lr)

    def items_per_batch(self, batch) -> int:
        return int(batch["tokens"].shape[0] * (batch["tokens"].shape[1] - 1))
