"""Quantized collective payloads — the ``comm_dtype`` codec, the JAX
package's ``parallel/comm.py`` over ``torch.distributed``.

The master tables and every shard-local computation stay full precision;
only what a pull or push collective moves narrows: quantized just before
the ``all_reduce`` / ``all_gather``, dequantized into f32 at the receiver.

Four wire formats (config key ``comm_dtype``, :func:`resolve_comm_dtype`):

* ``float32`` (default): no codec; the collectives are the plain ones,
  bit for bit.
* ``bfloat16``: the payload rounded to bf16 (nearest even), 2 bytes an
  element.
* ``int8``: per-row symmetric codes, ``scale = amax / 127`` over the row's
  trailing axes, the f32 scale beside each row. Gradients are rounded
  stochastically (``floor(y + u)``), so the quantizer is unbiased.
* ``int4``: block-wise symmetric 4-bit codes, two a byte (low nibble
  first), one bf16 scale ``amax / 7`` a block of ``int4_block`` lanes
  (default 32, ``int4/N`` another even width); the row's trailing axes
  are flattened and padded to whole blocks. Codes are quantized against
  the scale after its bf16 round trip, so sender and receiver agree on
  the step.

The dither is a counter-based hash of (element index, seed): ``seed`` is a
uint32 (a Python int or an int64 device tensor), salted with the sender's
index on the collective's axis (``+ index * 0x9E3779B9`` mod 2^32). The
hash is uint32 arithmetic, done here in int64 with every product kept
below 2^63 and masked to 32 bits, so it equals the JAX package's bit for
bit; the uniform ``u32 / 2^32`` reaches 1.0 where the u32 rounds up to
2^32, as in JAX.

How each format moves (NCCL has no 16-bit integer type, and gloo refuses
``int16``):

* the pull's owner-exclusive sum (:func:`psum_quantized`): every row is
  nonzero on one rank of the axis only, so an integer sum of the codes
  and scales passes the owner's through. int8 codes sum as ``int8``, int4
  codes as ``uint8``, int8 scales as f32 (``x + 0``); 16-bit words (bf16
  payloads, int4 scales) are paired into ``int32`` (padded to an even
  count), whose sum is exact because each half has one nonzero
  contributor. A bf16 float sum would turn an owner's ``-0.0`` into
  ``+0.0``.
* gathers and all-to-alls move bits: 16-bit words as bytes (``uint8``),
  int8 codes as ``int8``, packed int4 codes as ``uint8``, f32 scales as
  f32. A dtype the backend refuses raises; nothing falls back to the f32
  wire.

The collectives:

* :func:`psum_quantized`, the pull's sum over ``model``;
* :func:`all_gather_quantized`, the push's gather over ``data``;
* :func:`reduce_sum_quantized`, a dense sum that is not owner-exclusive:
  gather the narrow payloads, add in f32 in rank order;
* :func:`reduce_scatter_quantized`, its owned slice only, through
  ``dist.all_to_all_single``.

Every collective is counted where it is called (:data:`COMM`, by op, and
by the innermost :func:`scope`, the JAX package's ``ssn_*`` names): the
bytes it moves on the wire, codes, scales and ids; a reduce-scatter at its
full operand. :func:`wire_bytes` reckons the same from the shapes.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

COMM_DTYPES = ("float32", "bfloat16", "int8", "int4")

INT4_BLOCK = 32  # default int4 scale-block width (lanes an amax group)

_GOLDEN = 0x9E3779B9  # Weyl increment of the seed stream
_U32 = 0xFFFFFFFF

# calls and wire bytes on this rank, by collective
COMM: Dict[str, int] = {"all_reduce_calls": 0, "all_reduce_bytes": 0,
                        "all_gather_calls": 0, "all_gather_bytes": 0,
                        "all_to_all_calls": 0, "all_to_all_bytes": 0}
# wire bytes by the innermost open scope (collectives outside any scope are
# in COMM only, as the JAX audit leaves unscoped collectives out of by_scope)
SCOPES: Dict[str, int] = {}
_OPEN: List[str] = []


def reset_comm() -> None:
    for k in COMM:
        COMM[k] = 0
    SCOPES.clear()


def comm_bytes() -> int:
    """Wire bytes of every collective counted since :func:`reset_comm`."""
    return COMM["all_reduce_bytes"] + COMM["all_gather_bytes"] + COMM["all_to_all_bytes"]


@contextlib.contextmanager
def scope(name: str):
    """Bill the collectives called inside to ``name`` (the innermost open
    scope wins)."""
    _OPEN.append(name)
    try:
        yield
    finally:
        _OPEN.pop()


def _bill(op: str, nbytes: int) -> None:
    COMM[f"{op}_calls"] += 1
    COMM[f"{op}_bytes"] += nbytes
    if _OPEN:
        SCOPES[_OPEN[-1]] = SCOPES.get(_OPEN[-1], 0) + nbytes


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def all_reduce(mesh, t: torch.Tensor, axis: str) -> torch.Tensor:
    """In-place ``SUM`` of ``t`` over ``axis``' group, counted."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.groups[axis])
    _bill("all_reduce", _nbytes(t))
    return t


def all_gather(mesh, t: torch.Tensor, axis: str) -> torch.Tensor:
    """``t`` of every rank of ``axis``' group, concatenated along dim 0 in
    the axis' order (the list form of ``dist.all_gather``, which every
    backend has), counted at the gathered bytes."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.axis_size(axis))]
    dist.all_gather(parts, t, group=mesh.groups[axis])
    out = torch.cat(parts)
    _bill("all_gather", _nbytes(out))
    return out


def all_to_all(mesh, t: torch.Tensor, axis: str) -> torch.Tensor:
    """Rank ``k`` of ``axis`` receives the ``k``-th of the axis' equal
    leading-dim pieces of every rank's ``t``, in rank order (a tiled
    all-to-all), counted at the operand's bytes."""
    t = t.contiguous()
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t, group=mesh.groups[axis])
    _bill("all_to_all", _nbytes(t))
    return out


# ----------------------------------------------------------- resolvers ---


def resolve_comm_dtype(name: Optional[str]) -> str:
    """Validate and canonicalize a ``comm_dtype`` config value.

    Canonical values are :data:`COMM_DTYPES`; ``int4`` also takes a block
    spec ``int4/N`` (even N >= 2), and ``int4/32`` normalizes to ``int4``.
    Raises ``ValueError`` for anything else (``fp32`` and ``fp8`` too, as
    the JAX package does)."""
    if not name:
        return "float32"
    s = str(name).strip().lower()
    canon = {"float32": "float32", "f32": "float32",
             "bfloat16": "bfloat16", "bf16": "bfloat16",
             "int8": "int8", "s8": "int8",
             "int4": "int4", "s4": "int4"}.get(s)
    if canon is not None:
        return canon
    if s.startswith("int4/") or s.startswith("s4/"):
        spec = s.split("/", 1)[1]
        try:
            blk = int(spec)
        except ValueError:
            raise ValueError(f"bad int4 block spec {name!r}: {spec!r} "
                             "is not an integer")
        if blk < 2 or blk % 2:
            raise ValueError(
                f"int4 block must be an even integer >= 2, got {blk}")
        return "int4" if blk == INT4_BLOCK else f"int4/{blk}"
    raise ValueError(
        f"comm_dtype must be one of {COMM_DTYPES} (int4 takes an optional "
        f"/block spec), got {name!r}")


def is_int4(comm_dtype: str) -> bool:
    """True for ``int4`` and any ``int4/N`` block spec."""
    return comm_dtype == "int4" or comm_dtype.startswith("int4/")


def int4_block(comm_dtype: str) -> int:
    """The scale-block width of a canonical int4 ``comm_dtype``."""
    if comm_dtype == "int4":
        return INT4_BLOCK
    if comm_dtype.startswith("int4/"):
        return int(comm_dtype.split("/", 1)[1])
    raise ValueError(f"not an int4 comm_dtype: {comm_dtype!r}")


def apply_int4_block(comm_dtype: str, block) -> str:
    """A canonical int4 ``comm_dtype`` with the block width ``block`` (the
    ``comm_int4_block`` config key; 0 or None keeps it); other wires as
    they are."""
    if not block or not is_int4(comm_dtype):
        return comm_dtype
    return resolve_comm_dtype(f"int4/{int(block)}")


def stochastic_wire(comm_dtype: str) -> bool:
    """True where the wire rounds to integer codes, so gradients take the
    dithered rounding: int8 and int4."""
    return comm_dtype == "int8" or is_int4(comm_dtype)


def row_wire_bytes(row_elems: int, comm_dtype: str) -> float:
    """Wire bytes of one gathered row of ``row_elems`` elements (the JAX
    package's ``parallel/placement.py`` ``row_wire_bytes``)."""
    if comm_dtype == "bfloat16":
        return 2.0 * row_elems
    if comm_dtype == "int8":
        return 1.0 * row_elems + 4.0  # the row's f32 scale
    if is_int4(comm_dtype):
        blk = int4_block(comm_dtype)
        nblocks = max(-(-int(row_elems) // blk), 1)
        return 0.5 * nblocks * blk + 2.0 * nblocks
    return 4.0 * row_elems


def _pairs(n16: int) -> int:
    """Bytes of ``n16`` 16-bit words summed as int32 pairs (padded even)."""
    return 4 * (-(-n16 // 2))


def wire_bytes(kind: str, n: int, row_elems: int, comm_dtype: str, elem_size: int = 4) -> int:
    """Wire bytes of one collective of ``n`` rows of ``row_elems`` elements
    at ``comm_dtype``, as :data:`COMM` counts it: ``kind`` ``"sum"`` (the
    pull's owner-exclusive all-reduce; ``elem_size`` the rows' dtype on the
    f32 wire) or ``"gather"`` (the gathered result of ``n`` rows, all
    ranks' together)."""
    if comm_dtype == "float32":
        return n * row_elems * (elem_size if kind == "sum" else 4)
    if kind == "gather":
        return int(n * row_wire_bytes(row_elems, comm_dtype))
    if comm_dtype == "bfloat16":
        return _pairs(n * row_elems)
    if comm_dtype == "int8":
        return n * row_elems + 4 * n
    blk = int4_block(comm_dtype)
    nb = max(-(-row_elems // blk), 1)
    return n * nb * blk // 2 + _pairs(n * nb)


# ------------------------------------------------------------- codecs ---


def _mul32(x: torch.Tensor, m: int) -> torch.Tensor:
    """``x * m mod 2^32`` for ``x`` in ``[0, 2^32)`` held in int64, every
    partial product below 2^49."""
    lo = x * (m & 0xFFFF)
    hi = ((x * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def _seed_tensor(seed, device) -> torch.Tensor:
    if seed is None:
        return torch.zeros((), dtype=torch.int64, device=device)
    if isinstance(seed, torch.Tensor):
        return seed.to(device=device, dtype=torch.int64) & _U32
    return torch.tensor(int(seed) & _U32, dtype=torch.int64, device=device)


def _hash_uniform_at(idx: torch.Tensor, seed) -> torch.Tensor:
    """Uniform f32 noise at element indices ``idx`` (int64), ``seed`` a
    uint32 broadcastable to ``idx`` (the JAX ``_hash_uniform``, lowbias32
    over the index stream)."""
    x = (_mul32(idx & _U32, 2654435761) + seed) & _U32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x.to(torch.float32) * np.float32(1.0 / 4294967296.0)


def _row_noise(n: int, per_row: int, seed, device, place=None) -> torch.Tensor:
    """``[n, per_row]`` dither. Without ``place`` the element index runs
    over the whole ``[n, per_row]`` array and ``seed`` is one uint32 (the
    JAX codec on a shard's whole operand). ``place = (offsets, seeds)``:
    row ``r`` is row ``offsets[r]`` of the array its sender quantized, with
    seed ``seeds[r]`` (int64 tensors ``[n]``)."""
    lanes = torch.arange(per_row, dtype=torch.int64, device=device)
    if place is None:
        rows = torch.arange(n, dtype=torch.int64, device=device)
        return _hash_uniform_at(rows[:, None] * per_row + lanes, _seed_tensor(seed, device))
    offsets, seeds = place
    return _hash_uniform_at(offsets.to(torch.int64)[:, None] * per_row + lanes,
                            (seeds.to(torch.int64) & _U32)[:, None])


def salted(seed, index: int):
    """``seed`` mixed with a sender's axis index, so that senders draw
    distinct noise (the JAX ``_salted``): ``(seed + index * 0x9E3779B9) mod
    2^32``. A tensor seed stays a tensor."""
    if seed is None:
        seed = 0
    return (seed + index * _GOLDEN) & _U32


def _f32_const(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(np.float32(x), dtype=torch.float32, device=like.device)


def _round(y: torch.Tensor, stochastic: bool, seed, place) -> torch.Tensor:
    """``y`` ``[n, ...]`` rounded: half to even, or dithered ``floor(y + u)``."""
    if not stochastic:
        return torch.round(y)
    n = y.shape[0]
    per_row = y[0].numel() if n else 0
    u = _row_noise(n, per_row, seed, y.device, place).reshape(y.shape)
    return torch.floor(y + u)


def quantize_int8(x: torch.Tensor, stochastic: bool = False, seed=None,
                  place=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8: ``(q [x.shape] int8, scale [N] f32)``, the
    scale ``amax / 127`` over the trailing axes, 0 for an all-zero row (so
    a zero contribution stays zero through a sum). ``place``: see
    :func:`_row_noise`."""
    xf = x.float()
    n = xf.shape[0]
    per_row = int(np.prod(xf.shape[1:])) if xf.dim() > 1 else 1
    amax = xf.abs().reshape(n, per_row).amax(dim=1) if n and xf.dim() > 1 else xf.abs().reshape(n)
    scale = amax * _f32_const(1.0 / 127.0, xf)
    inv = torch.where(scale > 0, 1.0 / scale, torch.zeros_like(scale))
    y = xf * inv.reshape((-1,) + (1,) * (xf.dim() - 1))
    y = _round(y, stochastic, seed, place)
    return y.clamp(-127.0, 127.0).to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 codes and their row scales -> f32."""
    return q.float() * scale.reshape((-1,) + (1,) * (q.dim() - 1)).float()


def _int4_padded_cols(t: int, block: int) -> int:
    return max(-(-t // block), 1) * block


def quantize_int4(x: torch.Tensor, stochastic: bool = False, seed=None,
                  block: int = INT4_BLOCK, place=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block-wise symmetric int4: ``(packed [N, Tp/2] uint8, scales [N,
    Tp/block] bfloat16)``, ``Tp`` the flattened trailing size padded to
    whole blocks. Codes in ``[-7, 7]``, two's-complement nibbles, element
    ``2k`` in the low nibble of byte ``k``; an all-zero block has scale 0
    and codes 0. The scales are the JAX package's bitcast-uint16 bf16
    words, held as ``bfloat16`` (``.view(torch.int16)`` for the bits)."""
    n = x.shape[0] if x.dim() else 1
    t = int(np.prod(x.shape[1:])) if x.dim() > 1 else 1
    tp = _int4_padded_cols(t, block)
    xf = x.float().reshape(n, t)
    if tp != t:
        xf = torch.nn.functional.pad(xf, (0, tp - t))
    xb = xf.reshape(n, tp // block, block)
    amax = xb.abs().amax(dim=-1)
    scale_w = (amax * _f32_const(1.0 / 7.0, xf)).to(torch.bfloat16)
    scale = scale_w.float()
    inv = torch.where(scale > 0, 1.0 / scale, torch.zeros_like(scale))
    y = _round(xb * inv[:, :, None], stochastic, seed, place)
    q = y.clamp(-7.0, 7.0).to(torch.int32).reshape(n, tp)
    packed = ((q[:, 0::2] & 0xF) | ((q[:, 1::2] & 0xF) << 4)).to(torch.uint8)
    return packed, scale_w


def dequantize_int4(packed: torch.Tensor, scales: torch.Tensor, shape,
                    block: int = INT4_BLOCK) -> torch.Tensor:
    """Packed nibbles and bf16 block scales -> f32 of ``shape`` (the shape
    before padding, which the payload does not carry)."""
    n = packed.shape[0]
    t = int(np.prod(shape[1:])) if len(shape) > 1 else 1
    tp = packed.shape[1] * 2
    b = packed.to(torch.int32)
    q = torch.stack([b & 0xF, (b >> 4) & 0xF], dim=-1).reshape(n, tp)
    q = (q ^ 8) - 8  # sign-extend the nibble
    out = (q.reshape(n, tp // block, block).float() * scales.float()[:, :, None]).reshape(n, tp)
    return out[:, :t].reshape(shape)


# -------------------------------------------------- how the bits move ---


def _sum16(mesh, w: torch.Tensor, axis: str) -> torch.Tensor:
    """Owner-exclusive sum of 16-bit words (any 16-bit dtype) as int32
    pairs, padded to an even count: exact, each half having one nonzero
    contributor."""
    flat = w.contiguous().view(torch.int16).reshape(-1)
    n = flat.numel()
    if n % 2:
        flat = torch.cat([flat, flat.new_zeros(1)])
    pairs = flat.view(torch.int32).clone()
    all_reduce(mesh, pairs, axis)
    return pairs.view(torch.int16)[:n].view(w.dtype).reshape(w.shape)


def _move16(fn, mesh, w: torch.Tensor, axis: str) -> torch.Tensor:
    """A gather or all-to-all (``fn``) of 16-bit words as bytes."""
    shape = w.shape
    row = int(np.prod(shape[1:])) if len(shape) > 1 else 1
    raw = fn(mesh, w.contiguous().reshape(shape[0], row).view(torch.uint8), axis)
    return raw.view(w.dtype).reshape((raw.shape[0],) + tuple(shape[1:]))


def _out_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.float32 if x.dtype == torch.float32 else x.dtype


def psum_quantized(mesh, vals: torch.Tensor, axis: str, comm_dtype: str) -> torch.Tensor:
    """The pull's sum over ``axis`` with a narrow payload. ``vals`` must be
    owner-exclusive (each row nonzero on one rank of the axis at most).
    Quantization is deterministic. f32 is the plain all-reduce."""
    if comm_dtype == "float32":
        return all_reduce(mesh, vals, axis)
    if comm_dtype == "bfloat16":
        return _sum16(mesh, vals.to(torch.bfloat16), axis).to(vals.dtype)
    if is_int4(comm_dtype):
        block = int4_block(comm_dtype)
        packed, scale_w = quantize_int4(vals, block=block)
        p_sum = all_reduce(mesh, packed, axis)
        s_sum = _sum16(mesh, scale_w, axis)
        return dequantize_int4(p_sum, s_sum, vals.shape, block=block).to(vals.dtype)
    q, scale = quantize_int8(vals)
    q_sum = all_reduce(mesh, q, axis)
    s_sum = all_reduce(mesh, scale, axis)
    return dequantize_int8(q_sum, s_sum).to(vals.dtype)


def _quantize_for(mesh, x, axis, comm_dtype, stochastic, seed, place):
    """Codes and scales of ``x`` as this rank sends them over ``axis``:
    dithered (``stochastic``) with ``seed`` salted by the rank's axis index,
    or at ``place`` (whose seeds are the caller's)."""
    s = salted(seed, mesh.axis_index(axis)) if stochastic and place is None else None
    if is_int4(comm_dtype):
        return quantize_int4(x, stochastic=stochastic, seed=s,
                             block=int4_block(comm_dtype), place=place)
    return quantize_int8(x, stochastic=stochastic, seed=s, place=place)


def _dequantize(comm_dtype, codes, scales, shape):
    if is_int4(comm_dtype):
        return dequantize_int4(codes, scales, shape, block=int4_block(comm_dtype))
    return dequantize_int8(codes, scales)


def _move_codes(fn, mesh, codes, scales, axis, comm_dtype):
    """Codes and scales through ``fn`` (gather or all-to-all)."""
    c = fn(mesh, codes, axis)
    s = _move16(fn, mesh, scales, axis) if is_int4(comm_dtype) else fn(mesh, scales, axis)
    return c, s


def all_gather_quantized(mesh, x: torch.Tensor, axis: str, comm_dtype: str,
                         stochastic: bool = False, seed=None, place=None) -> torch.Tensor:
    """The push's tiled gather over ``axis`` with a narrow payload.

    ``stochastic`` dithers the int8 / int4 rounding with ``seed`` (a
    uint32, the same on every rank) salted by this rank's index on
    ``axis``. ``place = (offsets, seeds)`` instead gives each row of ``x``
    its row in the array the JAX package's sender quantizes and that
    sender's salted seed (:func:`_row_noise`)."""
    if comm_dtype == "float32":
        return all_gather(mesh, x, axis)
    if comm_dtype == "bfloat16":
        return _move16(all_gather, mesh, x.to(torch.bfloat16), axis).to(_out_dtype(x))
    codes, scales = _quantize_for(mesh, x, axis, comm_dtype, stochastic, seed, place)
    c_all, s_all = _move_codes(all_gather, mesh, codes, scales, axis, comm_dtype)
    return _dequantize(comm_dtype, c_all, s_all,
                       (c_all.shape[0],) + tuple(x.shape[1:])).to(_out_dtype(x))


def ordered_sum(parts: torch.Tensor) -> torch.Tensor:
    """``((0 + parts[0]) + parts[1]) + ...`` over the leading dim, in rank
    order from +0.0, as XLA's reduce adds (so ``-0.0`` terms sum to
    ``+0.0`` there too)."""
    acc = torch.zeros_like(parts[0])
    for p in parts:
        acc = acc + p
    return acc


def _sum_codes(comm_dtype: str, codes: torch.Tensor, scales: torch.Tensor, size: int,
               tail: tuple) -> torch.Tensor:
    """The f32 sum over ``size`` ranks' received codes and scales (``size``
    equal leading groups, in rank order), as the JAX package's dequantize
    and ``.sum(axis=0)`` computes it on the CPU: bf16 and int4 dequantized,
    then added from +0.0; int8, which XLA fuses into one multiply-add a
    rank, ``acc = fma(q_k, s_k, acc)``, each fma done in float64 (exact:
    ``q * s`` has at most 32 significant bits) and rounded once to f32."""
    n = codes.shape[0]
    own = n // size
    if comm_dtype == "int8":
        q = codes.reshape(size, own, -1).double()
        s = scales.reshape(size, own, 1).double()
        acc = torch.zeros(q.shape[1:], dtype=torch.float32, device=codes.device)
        for k in range(size):
            acc = (q[k] * s[k] + acc.double()).float()
        return acc.reshape((own,) + tail)
    contrib = _dequantize(comm_dtype, codes, scales, (n,) + tail)
    return ordered_sum(contrib.reshape((size, own) + tail).float())


def reduce_sum_quantized(mesh, x: torch.Tensor, axis: str, comm_dtype: str,
                         stochastic: bool = False, seed=None) -> torch.Tensor:
    """A dense sum over ``axis`` that is not owner-exclusive (every rank
    adds to every row), in f32 on every rank. A narrow wire gathers each
    rank's quantized payload and adds them in rank order
    (:func:`_sum_codes`). f32, where the axis divides ``x``'s rows, is
    :func:`reduce_scatter_quantized` and a gather of the slices, so that
    a slice of this sum is the scatter's bit for bit on every backend;
    else the backend's all-reduce."""
    size = mesh.axis_size(axis)
    tail = tuple(x.shape[1:])
    if comm_dtype == "float32":
        if x.shape[0] % size:
            return all_reduce(mesh, x, axis)
        return all_gather(mesh, reduce_scatter_quantized(mesh, x, axis, comm_dtype), axis)
    if comm_dtype == "bfloat16":
        g = _move16(all_gather, mesh, x.to(torch.bfloat16), axis)
        return ordered_sum(g.reshape((size,) + tuple(x.shape)).float())
    codes, scales = _quantize_for(mesh, x, axis, comm_dtype, stochastic, seed, None)
    c_all, s_all = _move_codes(all_gather, mesh, codes, scales, axis, comm_dtype)
    return _sum_codes(comm_dtype, c_all, s_all, size, tail)


def reduce_scatter_quantized(mesh, x: torch.Tensor, axis: str, comm_dtype: str,
                             stochastic: bool = False, seed=None) -> torch.Tensor:
    """This rank's ``1 / axis_size`` leading slice of
    :func:`reduce_sum_quantized`'s sum, bit for bit: each rank quantizes its
    whole ``x`` as the gather would, moves each slice to its owner with one
    all-to-all, and the owner adds the slices in rank order (at f32 too).
    ``x.shape[0]`` must divide by the axis."""
    size = mesh.axis_size(axis)
    if x.shape[0] % size:
        raise ValueError(f"reduce_scatter_quantized: leading dim {x.shape[0]} not "
                         f"divisible by axis size {size}")
    own = x.shape[0] // size
    tail = tuple(x.shape[1:])
    if comm_dtype == "float32":
        return ordered_sum(all_to_all(mesh, x, axis).reshape((size, own) + tail))
    if comm_dtype == "bfloat16":
        contrib = _move16(all_to_all, mesh, x.to(torch.bfloat16), axis).float()
        return ordered_sum(contrib.reshape((size, own) + tail))
    codes, scales = _quantize_for(mesh, x, axis, comm_dtype, stochastic, seed, None)
    c_all, s_all = _move_codes(all_to_all, mesh, codes, scales, axis, comm_dtype)
    return _sum_codes(comm_dtype, c_all, s_all, size, tail)
