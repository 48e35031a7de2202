"""Carry word2vec and CTR states from the JAX package into the port.

Both packages keep the packed ``[C, S, 128]`` layout (and the small-row
``[T, S, 128]`` one), so tables carry over by a plain copy; the dense
tensors of the CTR models keep the JAX layout (``w{i}`` is ``[d_in,
d_out]``). The JAX package's arrays arrive as numpy arrays
(``np.asarray(state.in_table.table)``); nothing here imports JAX.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from swiftsnails_tpu_torch.models.sparse_base import CTRState
from swiftsnails_tpu_torch.models.word2vec import W2VState
from swiftsnails_tpu_torch.ops.rowdma import ROW_LANES
from swiftsnails_tpu_torch.parallel.store import PackedTableState
from swiftsnails_tpu_torch.utils.device import DeviceLike, resolve_device


def _tensor_from_numpy(arr: np.ndarray) -> torch.Tensor:
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16":  # ml_dtypes.bfloat16: move the bits
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr.copy())


def packed_table_from_numpy(table: np.ndarray, *, device: DeviceLike,
                            dtype: Optional[torch.dtype] = None) -> PackedTableState:
    """A ``[C, S, 128]`` numpy table -> a slot-free :class:`PackedTableState`."""
    if table.ndim != 3 or table.shape[2] != ROW_LANES:
        raise ValueError(f"expected a packed [C, S, {ROW_LANES}] table, "
                         f"got {table.shape}")
    t = _tensor_from_numpy(table)
    t = t.to(device=resolve_device(device), dtype=dtype or t.dtype)
    return PackedTableState(table=t.contiguous(), slots={})


def w2v_state_from_numpy(in_table: np.ndarray, out_table: np.ndarray, *,
                         device: DeviceLike,
                         dtype: Optional[torch.dtype] = None) -> W2VState:
    """The port's word2vec state holding copies of the two given tables.

    ``dtype=None`` keeps the arrays' dtype (float32, or bfloat16 from
    ``ml_dtypes``).
    """
    if in_table.shape != out_table.shape:
        raise ValueError(f"table shapes differ: {in_table.shape} vs "
                         f"{out_table.shape}")
    return W2VState(
        in_table=packed_table_from_numpy(in_table, device=device, dtype=dtype),
        out_table=packed_table_from_numpy(out_table, device=device, dtype=dtype),
    )


def ctr_state_from_numpy(table: np.ndarray, dense: Mapping[str, np.ndarray],
                         opt_sum_of_squares: Optional[Mapping[str, np.ndarray]] = None,
                         *, device: DeviceLike,
                         dtype: Optional[torch.dtype] = None) -> CTRState:
    """The port's CTR state holding copies of a JAX ``CTRState``'s arrays.

    ``table`` is ``np.asarray(state.table.table)`` (``[T, 2, 128]`` with
    AdaGrad's accumulator fused in, else ``[T, 1, 128]``; ``dtype`` casts
    it), ``dense`` the dense dict, and for AdaGrad ``opt_sum_of_squares``
    the optax state's ``sum_of_squares`` dict; ``None`` gives SGD's empty
    state.
    """
    dev = resolve_device(device)

    def carry(arrays):
        return {k: _tensor_from_numpy(np.asarray(v)).to(dev) for k, v in arrays.items()}

    opt = {} if opt_sum_of_squares is None else {"sum_of_squares": carry(opt_sum_of_squares)}
    return CTRState(table=packed_table_from_numpy(table, device=dev, dtype=dtype),
                    dense=carry(dense), opt=opt)
