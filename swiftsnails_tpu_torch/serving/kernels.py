"""The query kernels of the serving read path — the JAX package's
``serving/kernels.py``, with PyTorch inside.

Every kernel reads a *normalized* read-only table: a contiguous 2-D
``[capacity, dim]`` tensor that :func:`swiftsnails_tpu_torch.serving.engine.normalize_table`
builds at load time from whatever plane the trainer checkpointed (2-D,
word2vec packed ``[C, S, 128]``, or the CTR small-row packed ``[T, S,
128]``). Normalization is an exact lane select, so the f32 wire keeps
serving pulls bit-identical to the checkpointed rows.

* :func:`pull_rows` — batched embedding lookup. Where a table row is whole
  16-byte words (every word2vec table: 800 B at dim 200) it launches the
  port's row-gather kernel, :func:`swiftsnails_tpu_torch.ops.rowdma.gather_rows`
  (``csrc/rowdma.cu``); where it is not (the CTR small-row plane: 68 B at
  table dim 17) it is ``index_select``, which is what the JAX package's
  XLA gather is. The choice is made by the row's width alone
  (:func:`whole_words`), never on a failure; ``gather_rows.launches``
  shows it. A gather kernel that fails to build or launch raises.
* :func:`write_rows` — the delta install's row overwrite, by the same rule:
  the port's ``scatter_write_rows`` kernel, or ``index_put_``.
* :func:`topk_tiled` — a tiled scan over the full table (the serving twin
  of ``tools/eval_embeddings.py``'s numpy scan): one ``[B, tile_rows]``
  product a tile with ``torch.matmul``, and a running best-k carried from
  tile to tile. The JAX package computes this product outside any kernel
  too.
* :func:`ctr_logits`, :func:`ctr_scores` — the registry CTR models'
  forward pass over pulled rows (mask semantics identical to training:
  PAD=-1 fields contribute nothing).

``comm_dtype`` applies the collective wire's precision loss to a pull on
one device (:func:`_wire_cast`, the codecs of
:mod:`swiftsnails_tpu_torch.parallel.comm`, deterministic): bf16, int8 and
int4 answer as the JAX servant does, bit for bit.

Under ``mesh=`` (a :class:`~swiftsnails_tpu_torch.parallel.mesh.Mesh`)
``table`` is this rank's model shard of the normalized table (its rows
``[m * per, (m + 1) * per)``) and the ids are the same on every rank:
:func:`pull_rows` is the JAX servant's pull over ``model`` (the owned rows
gathered on the shard, zeros for the rest, summed under ``comm_dtype`` by
``comm.psum_quantized``), and :func:`topk_tiled` scans the shard, offsets
its ids by ``m * per``, gathers every shard's best ``k`` over ``model`` and
merges them in the unmeshed scan's order (score descending, id
ascending). Every rank of the mesh calls them together.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Tuple

import torch
import torch.nn.functional as F

from swiftsnails_tpu_torch.ops import rowdma
from swiftsnails_tpu_torch.parallel.comm import (  # noqa: F401  (resolve_comm_dtype: the servant's)
    dequantize_int4,
    dequantize_int8,
    int4_block,
    is_int4,
    quantize_int4,
    quantize_int8,
    resolve_comm_dtype,
)

_WORD_BYTES = 16  # the row kernels' unit of movement


def check_mesh(mesh) -> None:
    """Raise ``TypeError`` for a ``mesh`` that is not ``None`` or a
    :class:`~swiftsnails_tpu_torch.parallel.mesh.Mesh`."""
    from swiftsnails_tpu_torch.parallel.mesh import Mesh

    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.mesh.Mesh, got {type(mesh)}")


def _gather(table: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``table``'s rows ``rows``: ``gather_rows`` where a row is whole
    16-byte words, else ``index_select``."""
    if whole_words(table):
        return rowdma.gather_rows(table, rows)
    return table.index_select(0, rows)


def whole_words(table: torch.Tensor) -> bool:
    """Whether the row kernels take ``table``: f32 or bf16 rows of a whole
    number of 16-byte words. Decided by dtype and shape alone."""
    row_bytes = math.prod(table.shape[1:]) * table.element_size()
    return (table.dtype in (torch.float32, torch.bfloat16) and row_bytes > 0
            and row_bytes % _WORD_BYTES == 0)


def _wire_cast(vals: torch.Tensor, comm_dtype: str) -> torch.Tensor:
    """Single-device twin of the collective wire: the precision loss the
    pull's owner-exclusive sum applies, so that one card answers as a mesh
    would. f32 is a no-op (bit-identical pulls); bf16 rounds to nearest
    even and back; int8 and int4 round deterministically (a pull never
    dithers), bit-equal to the JAX package's round trip."""
    if comm_dtype == "bfloat16":
        return vals.to(torch.bfloat16).to(vals.dtype)
    if comm_dtype == "int8":
        q, scale = quantize_int8(vals)
        return dequantize_int8(q, scale).to(vals.dtype)
    if is_int4(comm_dtype):
        blk = int4_block(comm_dtype)
        packed, scales = quantize_int4(vals, block=blk)
        return dequantize_int4(packed, scales, vals.shape, block=blk).to(vals.dtype)
    return vals


def pull_rows(
    table: torch.Tensor,
    rows: torch.Tensor,
    mesh=None,
    comm_dtype: str = "float32",
) -> torch.Tensor:
    """[N] int32 row ids -> [N, dim] rows of a normalized read-only table:
    ``gather_rows`` where a row is whole 16-byte words, else
    ``index_select``. Under ``mesh`` ``table`` is this rank's shard and
    the rows come from the pull over ``model`` (module docstring)."""
    check_mesh(mesh)
    comm_dtype = resolve_comm_dtype(comm_dtype)
    if mesh is not None:
        from swiftsnails_tpu_torch.parallel.comm import psum_quantized, scope
        from swiftsnails_tpu_torch.parallel.mesh import MODEL_AXIS

        local = rows - mesh.axis_index(MODEL_AXIS) * table.shape[0]
        owned = (local >= 0) & (local < table.shape[0])
        with scope("ssn_pull_collective"):  # the JAX servant pulls through pull_collective
            vals = _gather(table, torch.where(owned, local, 0).to(torch.int32))
            return psum_quantized(mesh, vals.masked_fill(~owned[:, None], 0), MODEL_AXIS,
                                  comm_dtype)
    return _wire_cast(_gather(table, rows), comm_dtype)


def write_rows(table: torch.Tensor, rows: torch.Tensor,
               values: torch.Tensor) -> torch.Tensor:
    """``table[rows] = values`` in place for UNIQUE int32 rows in ``[0, C)``;
    returns ``table``. ``scatter_write_rows`` where a row is whole 16-byte
    words (:func:`whole_words`, the rule :func:`pull_rows` uses), else
    ``index_put_``."""
    if whole_words(table):
        return rowdma.scatter_write_rows(table, rows, values)
    return table.index_put_((rows.long(),), values)


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(1e-9)


@torch.no_grad()
def topk_tiled(
    table: torch.Tensor,
    queries: torch.Tensor,
    k: int,
    tile_rows: int = 4096,
    normalize: bool = True,
    mesh=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k rows of ``table`` by dot-product score against ``queries``.

    ``table`` [C, D], ``queries`` [B, D] -> (scores [B, k] f32, ids [B, k]
    int32), scores descending, ``k = min(k, C)``. With ``normalize`` both
    sides are L2-normalized, the norm floored at 1e-9 (cosine similarity);
    pass False to rank raw inner products. The scan walks
    ``tile_rows``-row tiles (the last one padded, its padded rows scored
    ``-inf``) carrying the running best-k, which starts at ``-inf`` scores
    and ``-1`` ids, so peak memory is one ``[B, tile_rows]`` score block
    whatever the capacity.

    Ties rank as ``jax.lax.top_k`` ranks them over the concatenation
    ``[best, tile]``: the lower position first, so by score descending,
    then by id ascending. ``torch.topk`` promises no order among ties on
    the card, so the merge is a stable descending sort. Ties are real: a
    word2vec ``out_table`` starts at zero, and rows no step touched score
    0 alike. The products run in f32 under the caller's TF32 setting,
    which the port leaves off (PyTorch's default).

    Under ``mesh`` ``table`` is this rank's shard: the scan of the shard,
    its ids offset by ``m * per``, every shard's candidates gathered over
    ``model`` (in model order, so a stable sort by score keeps ties by id)
    and merged to ``k = min(k, per * model)``. With ``tile_rows`` dividing
    ``per`` the shards' tiles are the unmeshed scan's, score for score.
    """
    check_mesh(mesh)
    if mesh is not None:
        return _topk_meshed(table, queries, k, tile_rows, normalize, mesh)
    c, d = table.shape
    b = queries.shape[0]
    k = min(int(k), c)
    q = queries.to(device=table.device, dtype=torch.float32)
    if normalize:
        q = _l2_normalize(q)
    tile_rows = min(int(tile_rows), c)
    best_s = torch.full((b, k), float("-inf"), dtype=torch.float32, device=table.device)
    best_i = torch.full((b, k), -1, dtype=torch.int32, device=table.device)
    arange = torch.arange(tile_rows, dtype=torch.int32, device=table.device)
    for base in range(0, c, tile_rows):
        tile = table[base:base + tile_rows].float()
        pad = tile_rows - tile.shape[0]
        if pad:
            tile = F.pad(tile, (0, 0, 0, pad))
        if normalize:
            tile = _l2_normalize(tile)
        scores = q @ tile.T  # [B, tile_rows]
        ids = base + arange
        if pad:
            scores = scores.masked_fill(ids[None, :] >= c, float("-inf"))
        cat_s = torch.cat([best_s, scores], dim=1)
        cat_i = torch.cat([best_i, ids[None, :].expand(b, -1)], dim=1)
        sel = torch.sort(cat_s, dim=1, descending=True, stable=True).indices[:, :k]
        best_s = torch.gather(cat_s, 1, sel)
        best_i = torch.gather(cat_i, 1, sel)
    return best_s, best_i


def _topk_meshed(shard: torch.Tensor, queries: torch.Tensor, k: int, tile_rows: int,
                 normalize: bool, mesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`topk_tiled` under ``mesh`` (its docstring)."""
    from swiftsnails_tpu_torch.parallel.comm import all_gather, scope
    from swiftsnails_tpu_torch.parallel.mesh import MODEL_AXIS

    per, model = shard.shape[0], mesh.axis_size(MODEL_AXIS)
    s, i = topk_tiled(shard, queries, k, tile_rows=tile_rows, normalize=normalize)
    i = torch.where(i >= 0, i + mesh.axis_index(MODEL_AXIS) * per, i)
    b, kl = s.shape
    with scope("ssn_serve_topk"):
        all_s = all_gather(mesh, s, MODEL_AXIS).reshape(model, b, kl)
        all_i = all_gather(mesh, i, MODEL_AXIS).reshape(model, b, kl)
    all_s = all_s.permute(1, 0, 2).reshape(b, model * kl)
    all_i = all_i.permute(1, 0, 2).reshape(b, model * kl)
    sel = torch.sort(all_s, dim=1, descending=True, stable=True).indices[:, :min(int(k),
                                                                             per * model)]
    return torch.gather(all_s, 1, sel), torch.gather(all_i, 1, sel)


def ctr_logits(
    forward: Callable[[torch.Tensor, Any, torch.Tensor], torch.Tensor],
    pulled: torch.Tensor,
    dense: Any,
    mask: torch.Tensor,
) -> torch.Tensor:
    """Registry-model forward over pulled rows -> logits [B]."""
    return forward(pulled, dense, mask)


def ctr_scores(
    forward: Callable[[torch.Tensor, Any, torch.Tensor], torch.Tensor],
    pulled: torch.Tensor,
    dense: Any,
    mask: torch.Tensor,
) -> torch.Tensor:
    """CTR probability scores: sigmoid of the model logits."""
    return torch.sigmoid(ctr_logits(forward, pulled, dense, mask))
