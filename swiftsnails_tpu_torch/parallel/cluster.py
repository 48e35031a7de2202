"""Multi-process runtime: rendezvous, lifecycle, data sharding — the JAX
package's ``parallel/cluster.py``.

Replaces the reference's cluster system (``src/core/system/``, survey
§2.4) with ``torch.distributed``:

* master rendezvous + route broadcast (``MasterTransferInit``,
  ``NodeTransferInit``) -> :func:`initialize_cluster`, one
  ``dist.init_process_group`` against ``master_addr``;
* init barriers with ``init_timeout`` -> the process group's own timeout,
  from the same key;
* end-of-training barrier (``MasterTerminate`` / ``ClientTerminate``) ->
  :func:`barrier`, a named barrier on the default group's key-value store
  (control plane only, so it works on every backend, as the JAX one rides
  the coordination service);
* Hadoop-Streaming stdin splits -> :func:`local_data_shard` (files),
  :func:`shard_rows` (records), :func:`shard_token_stream` (a token
  stream, contiguous) and :func:`byte_span` (a file's byte span).

The JAX module's ``jax.process_index()`` / ``process_count()`` become the
rank and world size of the default group (:func:`process_info`), ``(0, 1)``
when none is initialized: single-process mode (the reference's
``local_train``), where every function is a no-op or the identity.

Config keys: ``master_addr`` (``HOST:PORT``, or an init method such as
``tcp://HOST:PORT`` or ``file:///path``), ``expected_node_num`` (the world
size), ``init_timeout`` (seconds), and ``device`` (``cpu``: the ``gloo``
backend; else ``nccl`` on the card).
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from swiftsnails_tpu_torch.data import text
from swiftsnails_tpu_torch.utils.config import Config

log = logging.getLogger("swiftsnails_tpu_torch.cluster")


def _init_method(addr: str) -> str:
    """``HOST:PORT`` -> ``tcp://HOST:PORT``; a URL passes as it is."""
    return addr if "://" in addr else f"tcp://{addr}"


def initialize_cluster(config: Optional[Config] = None,
                       process_id: Optional[int] = None) -> bool:
    """Join the cluster (``NodeTransferInit`` + ``MasterTransferInit``).

    With ``expected_node_num > 1`` this is ``dist.init_process_group``:
    ``master_addr`` the init method, ``expected_node_num`` the world size,
    ``init_timeout`` (default 300 s) the timeout, the rank ``process_id``,
    else the ``RANK`` that torch's launcher sets, else it raises. The
    backend is ``gloo`` for ``device: cpu`` and ``nccl`` on the card, where
    the process binds the card ``LOCAL_RANK`` (default: rank modulo the
    cards). Without a config or with ``expected_node_num <= 1`` it does
    nothing: single-process mode. Returns whether it joined a cluster.
    """
    if config is None:
        return False
    world = config.get_int("expected_node_num", 1)
    if world <= 1:
        return False
    if process_id is None:
        if "RANK" not in os.environ:
            raise ValueError(
                f"expected_node_num {world}: pass process_id or set RANK "
                "(torchrun sets it)")
        process_id = int(os.environ["RANK"])
    addr = config.get_str("master_addr")
    timeout = datetime.timedelta(seconds=config.get_int("init_timeout", 300))
    kwargs = {}
    if (config.get_str("device", "") or "cuda").startswith("cpu"):
        backend = "gloo"
    else:
        backend = "nccl"
        local = int(os.environ.get("LOCAL_RANK", process_id % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        kwargs["device_id"] = torch.device("cuda", local)
    dist.init_process_group(backend, init_method=_init_method(addr), world_size=world,
                            rank=process_id, timeout=timeout, **kwargs)
    log.info("joined cluster: process %d/%d via %s (%s)", dist.get_rank(),
             dist.get_world_size(), addr, backend)
    return True


def process_info() -> Tuple[int, int]:
    """``(process_index, process_count)`` — the reference's node id / node
    num: the default group's rank and world size, ``(0, 1)`` without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


# a barrier's keys must be new at each use; every process runs the same
# program, so a per-name counter agrees across the cluster
_barrier_seq: Dict[str, int] = {}


def barrier(name: str = "swiftsnails_barrier", timeout_s: float = 120.0) -> None:
    """All-process sync (``MasterTerminate`` / ``ClientTerminate``): each
    process adds one to ``name``'s counter in the default group's store, the
    last sets a done key, and every process waits for it up to
    ``timeout_s`` (a ``DistStoreError`` past it). No-op for one process."""
    _, count = process_info()
    if count <= 1:
        return
    store = dist.distributed_c10d._get_default_store()
    seq = _barrier_seq[name] = _barrier_seq.get(name, -1) + 1
    key = f"ssn_barrier/{name}/{seq}"
    if store.add(key, 1) == count:
        store.set(key + "/done", b"1")
    store.wait([key + "/done"], datetime.timedelta(seconds=timeout_s))


def local_data_shard(
    paths: Sequence[str],
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
) -> List[str]:
    """This process's input files, round-robin by process index (the
    Hadoop stdin split); with fewer files than processes, shard records
    instead (:func:`shard_rows`)."""
    if process_count is None:
        process_index, process_count = process_info()
    return [p for i, p in enumerate(paths) if i % process_count == process_index]


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


def shard_rows(
    *arrays: np.ndarray,
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
) -> Tuple[np.ndarray, ...]:
    """This process's round-robin rows of aligned record arrays: record
    ``i`` belongs to process ``i % count``, as ``iter_line_records`` deals
    lines."""
    if process_count is None:
        process_index, process_count = process_info()
    if process_count <= 1:
        return arrays
    return tuple(a[process_index::process_count] for a in arrays)
