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

Not ported yet (``ROADMAP.md``): the mesh pull (``mesh=``) and the int8 /
int4 wire codecs (``comm_dtype: int8`` / ``int4``); each raises
``NotImplementedError``.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from swiftsnails_tpu_torch.ops import rowdma

_WORD_BYTES = 16  # the row kernels' unit of movement


def resolve_comm_dtype(name: Optional[str]) -> str:
    """Canonical ``comm_dtype`` (the JAX ``parallel/comm.py`` names):
    ``float32`` or ``bfloat16``. ``int8`` and ``int4`` (``int4/N``) raise
    ``NotImplementedError``: their codecs come with the multi-device
    planes."""
    if not name:
        return "float32"
    s = str(name).strip().lower()
    canon = {"float32": "float32", "f32": "float32", "fp32": "float32",
             "bfloat16": "bfloat16", "bf16": "bfloat16"}.get(s)
    if canon is not None:
        return canon
    if s in ("int8", "s8", "int4", "s4") or s.startswith(("int4/", "s4/")):
        raise NotImplementedError(
            f"config key comm_dtype: {name} selects the int8/int4 wire codecs, "
            "which the PyTorch port does not have yet; see ROADMAP.md, Queue 1 "
            "item 6 (the multi-device planes)")
    raise ValueError(f"unknown comm_dtype {name!r}")


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "mesh= selects the sharded pull, which the PyTorch port does not "
            "have yet; see ROADMAP.md, Queue 1 item 6 (the multi-device planes)")


def whole_words(table: torch.Tensor) -> bool:
    """Whether the row kernels take ``table``: f32 or bf16 rows of a whole
    number of 16-byte words. Decided by dtype and shape alone."""
    row_bytes = math.prod(table.shape[1:]) * table.element_size()
    return (table.dtype in (torch.float32, torch.bfloat16) and row_bytes > 0
            and row_bytes % _WORD_BYTES == 0)


def _wire_cast(vals: torch.Tensor, comm_dtype: str) -> torch.Tensor:
    """Single-device twin of the collective wire: the precision loss the
    psum-over-model applies. f32 is a no-op (bit-identical pulls); bf16
    rounds to nearest even and back, bit-equal to XLA's round trip."""
    if comm_dtype == "bfloat16":
        return vals.to(torch.bfloat16).to(vals.dtype)
    return vals


def pull_rows(
    table: torch.Tensor,
    rows: torch.Tensor,
    mesh=None,
    comm_dtype: str = "float32",
) -> torch.Tensor:
    """[N] int32 row ids -> [N, dim] rows of a normalized read-only table:
    ``gather_rows`` where a row is whole 16-byte words, else
    ``index_select``."""
    _no_mesh(mesh)
    comm_dtype = resolve_comm_dtype(comm_dtype)
    if whole_words(table):
        vals = rowdma.gather_rows(table, rows)
    else:
        vals = table.index_select(0, rows)
    return _wire_cast(vals, comm_dtype)


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
    """
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
