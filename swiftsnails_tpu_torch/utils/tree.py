"""The tensors of a training state, by key — the role ``jax.tree_util`` plays
in the JAX package's checkpoint, guardrail and chaos code.

A state is built of NamedTuples (``W2VState``, ``PackedTableState``,
``CTRState``), dicts, lists and tuples, with tensors at the leaves. Each
tensor's key is its path in the JAX package's canonical form
(``framework/checkpoint.py`` ``canonical_key``): field names, dict keys and
sequence indices joined by ``/``, e.g. ``in_table/table`` or
``dense/w0``. The walk order is the JAX flattening order: NamedTuple fields
and sequence items in order, dict keys sorted. Leaves that are not tensors
(``None``, numbers) are passed over.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

import torch


def _children(node: Any):
    """``(key, child)`` pairs of a container, or ``None`` for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return list(zip(node._fields, node))
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def _join(prefix: str, key: str) -> str:
    return f"{prefix}/{key}" if prefix else key


def tensor_items(state: Any, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """``(key, tensor)`` for every tensor of ``state``, in walk order."""
    if isinstance(state, torch.Tensor):
        return [(prefix, state)]
    kids = _children(state)
    if kids is None:
        return []
    out: List[Tuple[str, torch.Tensor]] = []
    for key, child in kids:
        out.extend(tensor_items(child, _join(prefix, key)))
    return out


def keys_under(state: Any, types: tuple, prefix: str = "") -> List[str]:
    """The keys of the tensors of ``state`` that lie inside a node of one of
    ``types`` (e.g. the table states of a trainer's state)."""
    if isinstance(state, types):
        return [key for key, _ in tensor_items(state, prefix)]
    kids = _children(state)
    if kids is None:
        return []
    out: List[str] = []
    for key, child in kids:
        out.extend(keys_under(child, types, _join(prefix, key)))
    return out


def map_tensors(state: Any, fn: Callable[[str, torch.Tensor], torch.Tensor],
                prefix: str = "") -> Any:
    """A state of the same structure with each tensor replaced by
    ``fn(key, tensor)``."""
    if isinstance(state, torch.Tensor):
        return fn(prefix, state)
    if isinstance(state, dict):
        return type(state)((k, map_tensors(v, fn, _join(prefix, str(k))))
                           for k, v in state.items())
    if isinstance(state, tuple) and hasattr(state, "_fields"):
        return type(state)(*(map_tensors(v, fn, _join(prefix, f))
                             for f, v in zip(state._fields, state)))
    if isinstance(state, (list, tuple)):
        return type(state)(map_tensors(v, fn, _join(prefix, str(i)))
                           for i, v in enumerate(state))
    return state
