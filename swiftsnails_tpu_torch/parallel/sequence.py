"""Sequence/context parallelism: ring attention and Ulysses all-to-all — the
JAX package's ``parallel/sequence.py``.

The JAX functions run inside ``shard_map`` over the ``seq`` axis of a mesh;
here each rank of a ``torch.distributed`` process group (the ``seq`` group)
calls them on its own shard, and the group takes the mesh axis's place:

* :func:`ring_attention` — blockwise attention with online-softmax
  accumulation (:func:`_block_update`) while the K/V shards rotate around
  the group, one hop a step (``batch_isend_irecv``; the JAX
  ``lax.ppermute``). The rotation is an autograd function whose backward
  sends the gradient the opposite way, so each K/V gradient comes back to
  the rank that owns the shard. Causal masking works on global positions;
  blocks strictly in the future are skipped.
* :func:`ulysses_attention` — two all-to-alls: (seq-sharded, all heads) ->
  (full sequence, heads / P), exact local attention, and back. Requires
  ``heads % P == 0``.

Shapes are the JAX ones: a rank's ``q``, ``k``, ``v`` are ``[B, L/P, H, D]``,
rank ``r`` holding positions ``[r L/P, (r + 1) L/P)``, and the output is the
same shard of the ``[B, L, H, D]`` result. The arithmetic is f32, as in the
JAX ring; the dense path (:func:`reference_attention`) is the same einsum,
scale, ``-1e30`` mask and softmax. Works under any backend whose group
supports point-to-point and all-to-all (gloo on the CPU, NCCL on the card).
:data:`CALLS` counts the group's calls by kind, so a run can show that the
attention exchanged its shards.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist

SEQ_AXIS = "seq"

_NEG_INF = -1e30

# the group's calls made by the functions of this module, by kind
CALLS = {"ring_shift": 0, "all_to_all": 0}


def reset_calls() -> None:
    for key in CALLS:
        CALLS[key] = 0


def _scale(q: torch.Tensor) -> float:
    return 1.0 / math.sqrt(q.shape[-1])


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False) -> torch.Tensor:
    """Dense softmax attention (the single-device ground truth).

    Shapes: q ``[B, Lq, H, D]``, k/v ``[B, Lk, H, D]`` -> ``[B, Lq, H, D]``.
    The causal mask is ``tril(k=Lk - Lq)``, masked scores ``-1e30``.
    """
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * _scale(q)
    if causal:
        lq, lk = s.shape[-2], s.shape[-1]
        mask = torch.ones(lq, lk, dtype=torch.bool, device=s.device).tril(lk - lq)
        s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def _block_update(q, k, v, o, l, m, block_mask: Optional[torch.Tensor]):
    """One online-softmax accumulation step (flash-attention recurrence).

    q ``[B, Lq, H, D]``; k/v ``[B, Lk, H, D]``; o the running output; l the
    running denominator ``[B, H, Lq]``; m the running max ``[B, H, Lq]``;
    block_mask ``[Lq, Lk]`` boolean or ``None``.
    """
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * _scale(q)  # [B, H, Lq, Lk]
    if block_mask is not None:
        s = torch.where(block_mask[None, None], s, torch.full_like(s, _NEG_INF))
    m_new = torch.maximum(m, s.amax(dim=-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l_new = l * alpha + p.sum(dim=-1)
    o_new = o * alpha.transpose(1, 2)[..., None] + torch.einsum("bhqk,bkhd->bqhd", p, v)
    return o_new, l_new, m_new


def _group_shape(group) -> tuple:
    return dist.get_rank(group), dist.get_world_size(group)


def _shift(x: torch.Tensor, group, forward: bool) -> torch.Tensor:
    """``x`` to the next rank of the ring (``forward``) or the previous
    one; returns what the other neighbour sent."""
    rank, size = _group_shape(group)
    to, frm = ((rank + 1) % size, (rank - 1) % size) if forward else \
        ((rank - 1) % size, (rank + 1) % size)
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, dist.get_global_rank(group, to), group),
           dist.P2POp(dist.irecv, out, dist.get_global_rank(group, frm), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    CALLS["ring_shift"] += 1
    return out


class _RingShift(torch.autograd.Function):
    """One hop of the ring: forward sends to rank + 1; backward sends the
    gradient to rank - 1, back toward the shard's owner."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shift(x, group, forward=True)

    @staticmethod
    def backward(ctx, grad):
        return _shift(grad, ctx.group, forward=False), None


class _KeepInGraph(torch.autograd.Function):
    """``x``, with ``y`` kept in the autograd graph at zero gradient: a
    rank whose last ring block is skipped still runs the backward of every
    hop, which its neighbours' backward hops wait for."""

    @staticmethod
    def forward(ctx, x, y):
        ctx.like = (y.shape, y.dtype, y.device)
        return x.clone()

    @staticmethod
    def backward(ctx, grad):
        shape, dtype, device = ctx.like
        return grad, torch.zeros(shape, dtype=dtype, device=device)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group,
                   causal: bool = False) -> torch.Tensor:
    """Ring attention over ``group`` (the ``seq`` axis).

    Each rank passes its ``[B, L/P, H, D]`` shards and gets its shard of
    the output. K and V travel together, one tensor a hop, so the backward
    is one chain of hops that every rank walks in the same order; it
    returns the K/V gradients to their owners.
    """
    rank, size = _group_shape(group)
    b, lb, h, _ = q.shape
    qf = q.float()
    o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    l = torch.zeros(b, h, lb, dtype=torch.float32, device=q.device)
    m = torch.full((b, h, lb), _NEG_INF, dtype=torch.float32, device=q.device)
    pos = torch.arange(lb, device=q.device)
    kv = torch.stack([k, v])
    used = False
    for i in range(size):
        kv_idx = (rank - i) % size  # whose K/V shard this rank holds
        used = not causal or kv_idx <= rank  # blocks in the future are skipped
        if used:
            block_mask = None
            if causal:
                block_mask = (rank * lb + pos)[:, None] >= (kv_idx * lb + pos)[None, :]
            o, l, m = _block_update(qf, kv[0].float(), kv[1].float(), o, l, m, block_mask)
        if i + 1 < size:
            kv = _RingShift.apply(kv, group)
    if not used:
        o = _KeepInGraph.apply(o, kv)
    out = o / torch.clamp(l, min=1e-30).transpose(1, 2)[..., None]
    return out.to(q.dtype)


def _all_to_all(x: torch.Tensor, split_dim: int, concat_dim: int, group) -> torch.Tensor:
    """The JAX ``lax.all_to_all(x, split_axis, concat_axis, tiled=True)``:
    chunk ``j`` of ``x`` along ``split_dim`` goes to rank ``j``; the chunks
    received are joined along ``concat_dim`` in rank order."""
    size = dist.get_world_size(group)
    ins = [c.contiguous() for c in x.chunk(size, dim=split_dim)]
    outs = [torch.empty_like(ins[0]) for _ in range(size)]
    dist.all_to_all(outs, ins, group=group)
    CALLS["all_to_all"] += 1
    return torch.cat(outs, dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    """An all-to-all whose backward is the inverse all-to-all."""

    @staticmethod
    def forward(ctx, x, split_dim, concat_dim, group):
        ctx.dims = (split_dim, concat_dim)
        ctx.group = group
        return _all_to_all(x, split_dim, concat_dim, group)

    @staticmethod
    def backward(ctx, grad):
        split_dim, concat_dim = ctx.dims
        return _all_to_all(grad, concat_dim, split_dim, ctx.group), None, None, None


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group,
                      causal: bool = False) -> torch.Tensor:
    """All-to-all (DeepSpeed-Ulysses style) sequence-parallel attention over
    ``group``: Q, K and V go (seq-sharded, all heads) -> (full sequence,
    heads / P) in one all-to-all, the output comes back in another.
    Requires ``heads % P == 0``."""
    size = dist.get_world_size(group)
    if q.shape[2] % size != 0:
        raise ValueError(f"heads {q.shape[2]} not divisible by {SEQ_AXIS} axis {size}")
    # [3, B, Lb, H, D] -> [3, B, L, H/P, D]
    qh, kh, vh = _AllToAll.apply(torch.stack([q, k, v]), 3, 2, group)
    out = reference_attention(qh, kh, vh, causal=causal)
    return _AllToAll.apply(out, 1, 2, group)  # [B, L, H/P, D] -> [B, Lb, H, D]
