"""Carry word2vec and CTR states from the JAX package into the port.

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


def w2v_state_from_numpy(in_table: np.ndarray, out_table: np.ndarray, *,
                         device: DeviceLike,
                         dtype: Optional[torch.dtype] = None) -> W2VState:
    """The port's word2vec state holding copies of the two given tables:
    packed ``[C, S, 128]`` ones, or with ``packed: 0`` 2-D ``[C, dim]`` ones.

    ``dtype=None`` keeps the arrays' dtype (float32, or bfloat16 from
    ``ml_dtypes``).
    """
    if in_table.shape != out_table.shape:
        raise ValueError(f"table shapes differ: {in_table.shape} vs "
                         f"{out_table.shape}")
    return W2VState(
        in_table=_table_from_numpy(in_table, None, device, dtype),
        out_table=_table_from_numpy(out_table, None, device, dtype),
    )


def ctr_state_from_numpy(table: np.ndarray, dense: Mapping[str, np.ndarray],
                         opt_sum_of_squares: Optional[Mapping[str, np.ndarray]] = None,
                         *, device: DeviceLike,
                         dtype: Optional[torch.dtype] = None,
                         table_slots: Optional[Mapping[str, np.ndarray]] = None) -> CTRState:
    """The port's CTR state holding copies of a JAX ``CTRState``'s arrays.

    ``table`` is ``np.asarray(state.table.table)``: on the small-row plane
    ``[T, 2, 128]`` with AdaGrad's accumulator fused in, else ``[T, 1,
    128]``; on the 2-D plane ``[C, dim]``, its slots (AdaGrad's ``accum``)
    in ``table_slots``. ``dtype`` casts the table. ``dense`` is the dense
    dict, and for AdaGrad ``opt_sum_of_squares`` the optax state's
    ``sum_of_squares`` dict; ``None`` gives SGD's empty state.
    """
    dev = resolve_device(device)

    def carry(arrays):
        return {k: _tensor_from_numpy(np.asarray(v)).to(dev) for k, v in arrays.items()}

    opt = {} if opt_sum_of_squares is None else {"sum_of_squares": carry(opt_sum_of_squares)}
    return CTRState(table=_table_from_numpy(table, table_slots, dev, dtype),
                    dense=carry(dense), opt=opt)


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
