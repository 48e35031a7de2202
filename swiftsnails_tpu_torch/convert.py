"""Carry word2vec, CTR and ``seqlm`` states from the JAX package into the port.

Both packages keep the packed ``[C, S, 128]`` layout (and the small-row
``[T, S, 128]`` one) and the 2-D ``[C, dim]`` one with its row-aligned
slots, so tables carry over by a plain copy; the dense
tensors of the CTR models keep the JAX layout (``w{i}`` is ``[d_in,
d_out]``). The JAX package's arrays arrive as numpy arrays
(``np.asarray(state.in_table.table)``); nothing here imports JAX.

Checkpoints carry over too: both packages record a tensor under its
canonical key and CRC its row-major bytes (``framework/checkpoint.py``).
The keys agree but for the CTR dense optimizer's state, which the JAX
package keeps in optax's tuple (:func:`port_checkpoint_key`).
:func:`tree_from_numpy` carries a JAX ``load_tables`` tree (nested dicts
and sequences of numpy arrays) into the port's (nested dicts of tensors
under the port's keys), which ``serving`` normalizes and serves: both
packages' servants then answer from the same tables, dense parameters
included.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from swiftsnails_tpu_torch.models.sparse_base import CTRState
from swiftsnails_tpu_torch.models.word2vec import W2VState
from swiftsnails_tpu_torch.ops.rowdma import ROW_LANES
from swiftsnails_tpu_torch.parallel.store import PackedTableState, TableState
from swiftsnails_tpu_torch.utils.device import DeviceLike, resolve_device


def _tensor_from_numpy(arr: np.ndarray) -> torch.Tensor:
    arr = np.array(arr, order="C")  # a copy; keeps a 0-d array 0-d
    if arr.dtype.name == "bfloat16":  # ml_dtypes.bfloat16: move the bits
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def packed_table_from_numpy(table: np.ndarray, *, device: DeviceLike,
                            dtype: Optional[torch.dtype] = None) -> PackedTableState:
    """A ``[C, S, 128]`` numpy table -> a slot-free :class:`PackedTableState`."""
    if table.ndim != 3 or table.shape[2] != ROW_LANES:
        raise ValueError(f"expected a packed [C, S, {ROW_LANES}] table, "
                         f"got {table.shape}")
    t = _tensor_from_numpy(table)
    t = t.to(device=resolve_device(device), dtype=dtype or t.dtype)
    return PackedTableState(table=t.contiguous(), slots={})


def table_state_from_numpy(table: np.ndarray,
                           slots: Optional[Mapping[str, np.ndarray]] = None, *,
                           device: DeviceLike,
                           dtype: Optional[torch.dtype] = None) -> TableState:
    """A 2-D ``[C, dim]`` numpy table and its slots (e.g. AdaGrad's
    ``{"accum": [C, dim]}``) -> a :class:`TableState`; ``dtype`` casts the
    table, the slots keep theirs."""
    if table.ndim != 2:
        raise ValueError(f"expected a 2-D [C, dim] table, got {table.shape}")
    dev = resolve_device(device)
    t = _tensor_from_numpy(table)
    t = t.to(device=dev, dtype=dtype or t.dtype)
    carried = {k: _tensor_from_numpy(np.asarray(v)).to(dev).contiguous()
               for k, v in (slots or {}).items()}
    return TableState(table=t.contiguous(), slots=carried)


def _table_from_numpy(table: np.ndarray, slots, device, dtype):
    """A packed (3-D, slot-free) or 2-D table state by the array's rank."""
    if table.ndim == 2:
        return table_state_from_numpy(table, slots, device=device, dtype=dtype)
    if slots:
        raise ValueError("a packed table carries no separate slots here")
    return packed_table_from_numpy(table, device=device, dtype=dtype)


def model_shard(arr: np.ndarray, mesh) -> np.ndarray:
    """This rank's rows of a table given whole: ``[m * per, (m + 1) * per)``
    for model shard ``m`` (the JAX ``P(model, None)`` layout), so a meshed
    JAX state read back with ``np.asarray`` starts every rank of the port's
    mesh from its own shard."""
    from swiftsnails_tpu_torch.parallel.mesh import table_sharding

    start, end = table_sharding(mesh, arr.shape[0])
    return arr[start:end]


def table_shard_from_numpy(table: np.ndarray, mesh,
                           slots: Optional[Mapping[str, np.ndarray]] = None, *,
                           device: DeviceLike,
                           dtype: Optional[torch.dtype] = None):
    """A whole table (packed, slot-free, or 2-D with its slots) -> this
    rank's shard of it under ``mesh``, as a table state."""
    shard = {k: model_shard(np.asarray(v), mesh) for k, v in (slots or {}).items()}
    return _table_from_numpy(model_shard(table, mesh), shard, device, dtype)


def w2v_state_from_numpy(in_table: np.ndarray, out_table: np.ndarray, *,
                         device: DeviceLike,
                         dtype: Optional[torch.dtype] = None,
                         mesh=None) -> W2VState:
    """The port's word2vec state holding copies of the two given tables:
    packed ``[C, S, 128]`` ones, or with ``packed: 0`` 2-D ``[C, dim]`` ones;
    with ``mesh``, this rank's shard of each (:func:`model_shard`).

    ``dtype=None`` keeps the arrays' dtype (float32, or bfloat16 from
    ``ml_dtypes``).
    """
    if in_table.shape != out_table.shape:
        raise ValueError(f"table shapes differ: {in_table.shape} vs "
                         f"{out_table.shape}")
    if mesh is not None:
        in_table, out_table = model_shard(in_table, mesh), model_shard(out_table, mesh)
    return W2VState(
        in_table=_table_from_numpy(in_table, None, device, dtype),
        out_table=_table_from_numpy(out_table, None, device, dtype),
    )


def ctr_state_from_numpy(table: np.ndarray, dense: Mapping[str, np.ndarray],
                         opt_sum_of_squares: Optional[Mapping[str, np.ndarray]] = None,
                         *, device: DeviceLike,
                         dtype: Optional[torch.dtype] = None,
                         table_slots: Optional[Mapping[str, np.ndarray]] = None,
                         mesh=None) -> CTRState:
    """The port's CTR state holding copies of a JAX ``CTRState``'s arrays.

    ``table`` is ``np.asarray(state.table.table)``: on the small-row plane
    ``[T, 2, 128]`` with AdaGrad's accumulator fused in, else ``[T, 1,
    128]``; on the 2-D plane ``[C, dim]``, its slots (AdaGrad's ``accum``)
    in ``table_slots``. ``dtype`` casts the table. ``dense`` is the dense
    dict, and for AdaGrad ``opt_sum_of_squares`` the optax state's
    ``sum_of_squares`` dict; ``None`` gives SGD's empty state. With
    ``mesh``, the table and its slots are this rank's shard
    (:func:`model_shard`: its tiles, or its rows), the dense side whole.
    """
    dev = resolve_device(device)

    def carry(arrays):
        return {k: _tensor_from_numpy(np.asarray(v)).to(dev) for k, v in arrays.items()}

    opt = {} if opt_sum_of_squares is None else {"sum_of_squares": carry(opt_sum_of_squares)}
    if mesh is not None:
        table = table_shard_from_numpy(table, mesh, table_slots, device=dev, dtype=dtype)
    else:
        table = _table_from_numpy(table, table_slots, dev, dtype)
    return CTRState(table=table, dense=carry(dense), opt=opt)


def seqlm_state_from_numpy(params, opt_slots: Optional[Mapping] = None, *,
                           device: DeviceLike) -> dict:
    """The port's ``seqlm`` state holding copies of a JAX ``SeqLMTrainer``
    state's arrays.

    ``params`` is the JAX parameter tree as numpy arrays: ``{"embed",
    "pos", "blocks": [{"wqkv", "wo", "w1", "w2"}, ...]}``. ``opt_slots``
    holds the optax slots, numpy too: for ``adam`` / ``adamw`` the
    ``ScaleByAdamState`` fields ``{"count", "mu", "nu"}`` (``mu`` and
    ``nu`` parameter trees), for ``momentum`` the ``TraceState``'s
    ``{"trace"}``; ``None`` or ``{}`` for ``sgd``, whose state is empty.
    Returns ``{"params", "opt"}`` as
    :meth:`~swiftsnails_tpu_torch.models.seqlm.SeqLMTrainer.init_state`
    lays it out."""
    dev = resolve_device(device)

    def carry(tree):
        if isinstance(tree, Mapping):
            return {str(k): carry(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [carry(v) for v in tree]
        return _tensor_from_numpy(np.asarray(tree)).to(dev)

    opt = {}
    for key, value in (opt_slots or {}).items():
        if key not in ("count", "mu", "nu", "trace"):
            raise ValueError(f"unknown optimizer slot {key!r}")
        opt[key] = carry(value)
    if "count" in opt:
        opt["count"] = opt["count"].to(torch.int32).reshape(())
    return {"params": carry(params), "opt": opt}


# The JAX CTRState's optax AdaGrad state, ``(ScaleByRssState(sum_of_squares),
# EmptyState())``, records its accumulators under ``opt/0/sum_of_squares/``;
# the port's dict under ``opt/sum_of_squares/``.
_CHECKPOINT_KEY_PREFIXES = (("opt/0/sum_of_squares/", "opt/sum_of_squares/"),)


def port_checkpoint_key(jax_key: str) -> str:
    """A canonical checkpoint key of the JAX package -> the port's key of
    the same tensor."""
    for jax_prefix, port_prefix in _CHECKPOINT_KEY_PREFIXES:
        if jax_key.startswith(jax_prefix):
            return port_prefix + jax_key[len(jax_prefix):]
    return jax_key


def jax_checkpoint_key(port_key: str) -> str:
    """The inverse of :func:`port_checkpoint_key`."""
    for jax_prefix, port_prefix in _CHECKPOINT_KEY_PREFIXES:
        if port_key.startswith(port_prefix):
            return jax_prefix + port_key[len(port_prefix):]
    return port_key


def _flat_numpy(tree, prefix: str = ""):
    """``(canonical key, array)`` of every array leaf of nested dicts, lists
    and tuples (NamedTuples by field name)."""
    if isinstance(tree, dict):
        kids = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        kids = list(zip(tree._fields, tree))
    elif isinstance(tree, (list, tuple)):
        kids = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [] if tree is None else [(prefix, tree)]
    out = []
    for key, child in kids:
        out.extend(_flat_numpy(child, f"{prefix}/{key}" if prefix else key))
    return out


def tree_from_numpy(tree, *, device: DeviceLike) -> dict:
    """A JAX state tree of numpy arrays (``load_tables``' nested dicts, or a
    state's NamedTuples) -> the port's ``load_tables`` tree: nested dicts of
    tensors on ``device`` under the port's keys (:func:`port_checkpoint_key`).
    A 0-d array stays 0-d."""
    dev = resolve_device(device)
    out: dict = {}
    for key, arr in _flat_numpy(tree):
        node = out
        *parents, leaf = port_checkpoint_key(key).split("/")
        for name in parents:
            node = node.setdefault(name, {})
        node[leaf] = _tensor_from_numpy(np.asarray(arr)).to(dev)
    return out


# ------------------------------------------------------------ tiered store ---

# the host-side state of a TieredTable in either package, by attribute name
TIER_STATE_FIELDS = ("slot_of", "unit_of", "ref", "dirty", "master_ver")
TIER_STAT_FIELDS = ("lookups", "hits", "faults", "faulted_rows", "evictions",
                    "flushes", "flushed_rows", "h2d_bytes", "d2h_bytes",
                    "prewarmed_rows", "transparent_steps")


def tier_state_numpy(table) -> dict:
    """The slot map, CLOCK state and counters of a ``TieredTable`` of
    either package as numpy arrays and ints (read by attribute, so nothing
    here imports JAX): ``slot_of``, ``unit_of``, ``ref``, ``dirty``,
    ``master_ver``, ``hand``, ``used`` and ``stats`` (the counters of
    :data:`TIER_STAT_FIELDS`; the ``*_ns`` timings are left out)."""
    out = {f: np.array(getattr(table, f)) for f in TIER_STATE_FIELDS}
    out["hand"] = int(table.hand)
    out["used"] = int(table.used)
    out["stats"] = {f: int(getattr(table.stats, f)) for f in TIER_STAT_FIELDS}
    return out


def host_master_from_numpy(table: np.ndarray,
                           slots: Optional[Mapping[str, np.ndarray]] = None, *,
                           layout: str, group: int = 1, checksums: bool = True,
                           master_dtype: str = "float32"):
    """The port's :class:`~swiftsnails_tpu_torch.tiered.HostMaster` over
    numpy planes (a JAX state's ``np.asarray`` leaves): a 2-D table gives a
    :class:`TableState`, any other a :class:`PackedTableState`. The master
    copies the planes; the JAX package's ``HostMaster`` takes the same
    arrays as they are."""
    from swiftsnails_tpu_torch.tiered.store import HostMaster

    kind = TableState if np.ndim(table) == 2 else PackedTableState
    state = kind(table=_tensor_from_numpy(table),
                 slots={k: _tensor_from_numpy(v) for k, v in (slots or {}).items()})
    return HostMaster(state, layout, group=group, checksums=checksums,
                      master_dtype=master_dtype)
