"""Multi-process data sharding — part of the JAX package's
``parallel/cluster.py``.

The JAX module's ``jax.process_index()`` / ``process_count()`` become the
rank and world size of ``torch.distributed``'s default group
(:func:`process_info`), ``(0, 1)`` when none is initialized. Ported here:
:func:`process_info`, :func:`shard_token_stream` (a process's contiguous
span of an encoded token stream, which ``models/seqlm.py`` reads) and
:func:`byte_span` (a process's byte span of a corpus file, for streamed
reading). The rendezvous, barrier and the file and row splits come with the
port's multi-process plane.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch.distributed as dist

from swiftsnails_tpu_torch.data import text


def process_info() -> Tuple[int, int]:
    """``(process_index, process_count)`` — the reference's node id / node
    num: the default group's rank and world size, ``(0, 1)`` without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def shard_token_stream(
    ids: np.ndarray,
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
) -> np.ndarray:
    """This process's contiguous span of an encoded token stream.

    The reference gave each worker a contiguous region of the corpus (its
    Hadoop stdin split, ``run_worker.sh``); contiguity matters for window
    models — a strided split would cut every skip-gram context. Spans come
    from ``np.array_split`` so they are disjoint and cover the corpus.
    """
    if process_count is None:
        process_index, process_count = process_info()
    if process_count <= 1:
        return ids
    return np.array_split(ids, process_count)[process_index]


def byte_span(
    path: str,
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
) -> Tuple[int, int]:
    """This process's contiguous ``[start, end)`` byte span of a corpus file
    (:func:`swiftsnails_tpu_torch.data.text.byte_span`), by default this
    process's: ``(0, 0)``, the whole file, for a single process."""
    if process_count is None:
        process_index, process_count = process_info()
    return text.byte_span(path, process_index, process_count)
