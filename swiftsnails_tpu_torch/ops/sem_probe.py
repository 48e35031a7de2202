"""Probes of bulk-copy completion accounting: the port's counterpart of the
three Pallas kernels of the JAX package's ``tools/sem_probe.py``.

On the TPU the probes asked whether completions on one shared DMA semaphore
add up by rows, so that one ``[64, S, 128]`` descriptor wait retires 64
single-row copies. On Hopper the same question is whether bulk copies
(``cp.async.bulk``, the TMA engine) onto one ``mbarrier`` are accounted by
bytes, so that one armed phase retires a chunk of scattered row copies. The
kernels are CUDA C++ in ``csrc/sem_probe.cu``, built at first use by
:mod:`._build`; each moves a row as one bulk copy.

Each kernel has, beside it here:

* a wrapper that checks device, dtype, shape, contiguity and 16-byte
  alignment, and raises on anything else. For a tensor on the CPU it runs
  the plain version; for a CUDA tensor it launches the kernel on the current
  stream, or raises. There is no fallback from a failed build or launch.
* a launch counter, ``<wrapper>.launches``, raised by one where the kernel
  is launched and nowhere else;
* the plain version (``*_plain``), which states what the probe must
  observe, and which the CPU path, the tests and ``chip_smoke.py`` use.

:func:`unit_probe` replaces ``unit_kernel`` (``tools/sem_probe.py:63``,
``pallas_call`` at ``:80``), which polled the semaphore's count after one
copy. The barrier word's layout is not documented, so the kernel does not
read it: it arms a phase with exactly the copy's bytes (it must complete),
then with 16 bytes more (it must not, within the poll bound, until one more
16-byte copy drains it), and for an 8-row copy also shows that eight
single-row copies complete one 8-row phase and seven do not. Its plain
version gives the PTX ISA's byte accounting: ``unit = rows * S * 128 *
itemsize``. Its time is the over-armed phase's 100,000 polls, which the JAX
tool's semantics fix.

:func:`chunk_probe` replaces ``chunk_kernel`` (``:129``, ``pallas_call`` at
``:164``): 64 scattered row copies retired by one armed phase, the rows
copied out, and a flag of +armed bytes when the phase completed within the
poll bound. It is bound by latency (the launch, one load of the ids, the
copies' landing): lane 0 arms the phase, then warp 0 loads the ids in one
coalesced load, checks them with one vote and issues two copies a lane, so
no id load waits behind a copy's issue, as it did when one thread issued
all 64. Its time from the arming covers the loads, the issue and the
landing. :func:`chunk_plan` reports its launch geometry.

:func:`pipe_probe` replaces ``pipe_kernel`` (``:200``, ``pallas_call`` at
``:233``): per block, K row copies in chunks of 64, retired by one barrier a
copy or one a chunk, each chunk XOR-reduced. It is bound by device-memory
bytes once enough rows are in flight on enough SMs. A block is one
thread-block cluster of G CTAs that deals the block's chunks round-robin;
the library picks G once a shape by the hogwild kernels' rule
(``csrc/cluster_launch.cuh``: G = 2, 128 CTAs, at the JAX tool's shape) and
:func:`pipe_plan` reports it. Each CTA runs a ring of :func:`pipe_stages`
stages with a producer warp (two ids and two copies a lane), four consumer
warps, and a full and an empty barrier a stage, so issue, landing and
reduction overlap with no CTA-wide barrier; the ranks' XORs meet in rank 0
through distributed shared memory.

Every wait has a deadline of about 100 ms; past it the kernel traps, the
launch fails, and :func:`deadline_status` names the wait.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from swiftsnails_tpu_torch.ops import _build

_DTYPES = (torch.float32, torch.bfloat16)
_WORD_BYTES = 16  # a bulk copy's unit of size and alignment
SMEM_BYTES = 232_448  # shared memory a block may use on an H100
_BARRIER_BYTES = 128  # the kernels' room for barriers ahead of a row buffer
MAX_TX_BYTES = (1 << 20) - 1  # the bytes one mbarrier phase can wait for
# csrc/sem_probe.cu's constants: the JAX tool's poll bound for one copy
# (kUnitPolls; 200,000 for a chunk), the pipe's rows a stage (kChunkRows)
UNIT_POLLS = 100_000
CHUNK_ROWS = 64
PIPE_STAGES = 3

# unit_probe's output, in this order (csrc/sem_probe.cu)
UNIT_FIELDS = ("unit", "exact_done", "exact_polls", "exact_cycles", "exact_ns",
               "over_done", "over_drained", "singles_done", "partial_done",
               "last_drained")
# what a run on the card measures and the plain version cannot state
UNIT_TIMES = ("exact_polls", "exact_cycles", "exact_ns")
CHUNK_STATS = ("flag", "polls", "cycles", "ns")

# which wait passed its deadline (ssn_probe_status)
DEADLINE_CODES = {1: "unit: exact arming", 2: "unit: over-armed drain",
                  3: "unit: single-row copies", 4: "unit: last-copy drain",
                  5: "chunk wait", 6: "pipe wait", 7: "an id outside [0, C)",
                  8: "pipe: the producer's wait for a released stage"}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("sem_probe")
    vp, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.ssn_unit_probe.argtypes = [vp, ll, i32, vp, i32, vp]
    lib.ssn_unit_probe.restype = i32
    lib.ssn_chunk_probe.argtypes = [vp, vp, ll, ll, ll, ll, vp, vp, i32, vp]
    lib.ssn_chunk_probe.restype = i32
    lib.ssn_pipe_probe.argtypes = [vp, vp, ll, ll, ll, ll, ll, i32, i32, vp, i32, vp]
    lib.ssn_pipe_probe.restype = i32
    lib.ssn_pipe_plan.argtypes = [ll, ll, ll, ll, i32, i32, vp]
    lib.ssn_pipe_plan.restype = i32
    lib.ssn_chunk_plan.argtypes = [vp]
    lib.ssn_chunk_plan.restype = i32
    lib.ssn_probe_status.argtypes = []
    lib.ssn_probe_status.restype = i32
    lib.ssn_error_string.argtypes = [i32]
    lib.ssn_error_string.restype = ctypes.c_char_p
    return lib


def _launched(name: str, rc: int) -> None:
    if rc != 0:
        msg = _lib().ssn_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} ({msg})")


def deadline_status() -> int:
    """The code of the wait that passed its deadline in the last probe
    launched (0: none; :data:`DEADLINE_CODES`). Kept in host memory, so it
    can be read after the trap has ended the CUDA context."""
    return int(_lib().ssn_probe_status())


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# ------------------------------------------------------------- checks ---


def _check_rows_tensor(name: str, x: torch.Tensor) -> int:
    """``x`` is ``[C, ...]`` of a supported dtype, contiguous, on the CPU or
    a card, with rows and base address in 16-byte words; returns its row
    bytes."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {x.dtype} not in {_DTYPES}")
    if x.dim() < 2 or not x.is_contiguous():
        raise ValueError(f"{name}: x must be a contiguous [C, ...] tensor, got "
                         f"{tuple(x.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")
    row_bytes = x.stride(0) * x.element_size()
    if (row_bytes | x.data_ptr()) % _WORD_BYTES:
        raise ValueError(f"{name}: rows of {row_bytes} B at 0x{x.data_ptr():x} are "
                         f"not in {_WORD_BYTES}-byte words, as a bulk copy needs")
    return row_bytes


def _check_ids(name: str, ids: torch.Tensor, x: torch.Tensor) -> None:
    if ids.dtype != torch.int32:
        raise TypeError(f"{name}: ids must be int32, got {ids.dtype}")
    if ids.dim() != 1 or not ids.is_contiguous():
        raise ValueError(f"{name}: ids must be a contiguous 1-D tensor")
    if ids.device != x.device:
        raise ValueError(f"{name}: ids on {ids.device}, x on {x.device}")


def _check_smem(name: str, nbytes: int) -> None:
    if _BARRIER_BYTES + nbytes > SMEM_BYTES:
        raise ValueError(f"{name}: {nbytes} B of rows do not fit in a block's "
                         f"{SMEM_BYTES} B of shared memory")


def _check_tx(name: str, nbytes: int) -> None:
    if nbytes > MAX_TX_BYTES:
        raise ValueError(f"{name}: one phase cannot wait for {nbytes} B "
                         f"(at most {MAX_TX_BYTES})")


# ------------------------------------------------------------ unit probe ---


def unit_probe_plain(x: torch.Tensor, rows: int) -> torch.Tensor:
    """What :func:`unit_probe` must observe: a copy accounts for its bytes
    (``rows * row bytes``), exact arming completes, over-arming does not
    until drained, and (``rows > 1``) ``rows`` single-row copies complete
    one phase armed with all their bytes, one fewer does not. Times are -1:
    only the card measures them."""
    bytes_ = rows * x.stride(0) * x.element_size()
    add = (1, 0, 1) if rows > 1 else (-1, -1, -1)
    return torch.tensor([bytes_, 1, -1, -1, -1, 0, 1, *add], dtype=torch.int64)


def unit_probe(x: torch.Tensor, rows: int) -> torch.Tensor:
    """Copy ``x[0:rows]`` (one bulk copy) onto barriers armed exactly and
    16 bytes above its size, and for ``rows > 1`` as single-row copies;
    returns the int64 fields :data:`UNIT_FIELDS`, on ``x``'s device.

    A phase that must complete and does not within :data:`UNIT_POLLS` polls
    is waited for up to the deadline, then the kernel traps.
    """
    name = "unit_probe"
    row_bytes = _check_rows_tensor(name, x)
    if not 1 <= rows <= x.shape[0]:
        raise ValueError(f"{name}: rows {rows} not in [1, {x.shape[0]}]")
    _check_tx(name, rows * row_bytes + _WORD_BYTES)
    _check_smem(name, rows * row_bytes)
    if x.device.type == "cpu":
        return unit_probe_plain(x, rows)
    lib = _lib()
    out = torch.empty(len(UNIT_FIELDS), dtype=torch.int64, device=x.device)
    _launched(name, lib.ssn_unit_probe(x.data_ptr(), row_bytes, rows, out.data_ptr(),
                                       x.device.index or 0, _stream(x)))
    unit_probe.launches += 1
    return out


unit_probe.launches = 0


def unit_fields(out: torch.Tensor) -> dict:
    """:func:`unit_probe`'s output as ``{field: int}``."""
    return dict(zip(UNIT_FIELDS, (int(v) for v in out.cpu())))


# ----------------------------------------------------------- chunk probe ---


def chunk_probe_plain(x: torch.Tensor, ids: torch.Tensor, arm_extra: int = 0):
    """``(x[ids], stats)``: the rows, and the flag +armed bytes (``len(ids)``
    rows, the one-shot wait completing); polls and times -1."""
    if arm_extra:
        raise ValueError("chunk_probe_plain: a phase armed beyond its copies "
                         "never completes; the kernel traps at its deadline")
    armed = ids.numel() * x.stride(0) * x.element_size()
    stats = torch.tensor([armed, -1, -1, -1], dtype=torch.int64)
    return x.index_select(0, ids), stats


def chunk_probe(x: torch.Tensor, ids: torch.Tensor, arm_extra: int = 0):
    """Gather ``x[ids]`` through one barrier: all ``len(ids)`` scattered row
    copies complete one phase armed with their bytes (plus ``arm_extra``, a
    multiple of 16, which a test uses to make a phase that never completes).
    Returns ``(rows, stats)``, stats the int64 :data:`CHUNK_STATS`: the flag
    (+armed bytes if the phase completed within the poll bound, else
    -armed), the polls, and the cycles and ns from the first issue to the
    completion. Ids outside ``[0, C)`` trap on the card and raise here.
    """
    name = "chunk_probe"
    row_bytes = _check_rows_tensor(name, x)
    _check_ids(name, ids, x)
    n = ids.numel()
    if n < 1 or arm_extra < 0 or arm_extra % _WORD_BYTES:
        raise ValueError(f"{name}: need ids and a non-negative arm_extra in "
                         f"{_WORD_BYTES}-byte words, got {n} ids, {arm_extra}")
    _check_tx(name, n * row_bytes + arm_extra)
    _check_smem(name, n * row_bytes)
    if x.device.type == "cpu":
        return chunk_probe_plain(x, ids, arm_extra)
    lib = _lib()
    out = torch.empty((n,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    stats = torch.empty(len(CHUNK_STATS), dtype=torch.int64, device=x.device)
    _launched(name, lib.ssn_chunk_probe(
        x.data_ptr(), ids.data_ptr(), n, x.shape[0], row_bytes, arm_extra, out.data_ptr(),
        stats.data_ptr(), x.device.index or 0, _stream(x)))
    chunk_probe.launches += 1
    return out, stats


chunk_probe.launches = 0

_CHUNK_PLAN_KEYS = ("ctas", "threads", "issuing_lanes")


def chunk_plan(x: torch.Tensor) -> dict:
    """How :func:`chunk_probe` launches on ``x``'s card, as the library
    reports it (``ssn_chunk_plan``): ``ctas``, ``threads`` a CTA and
    ``issuing_lanes``, the lanes that issue the copies. On the CPU, where the
    plain version runs, each is None."""
    if x.device.type != "cuda":
        return dict.fromkeys(_CHUNK_PLAN_KEYS)
    out = (ctypes.c_longlong * len(_CHUNK_PLAN_KEYS))()
    _launched("chunk_plan", _lib().ssn_chunk_plan(out))
    return dict(zip(_CHUNK_PLAN_KEYS, out))


# ------------------------------------------------------------ pipe probe ---


def _xor_rows(words: torch.Tensor) -> torch.Tensor:
    """XOR of each row of an int32 ``[B, N]``, by halving."""
    while words.shape[1] > 1:
        if words.shape[1] % 2:
            words = torch.nn.functional.pad(words, (0, 1))
        half = words.shape[1] // 2
        words = words[:, :half] ^ words[:, half:]
    return words[:, 0]


def pipe_probe_plain(x: torch.Tensor, ids: torch.Tensor, blocks: int) -> torch.Tensor:
    """``[blocks, 2]`` int32: for block i of ``len(ids) / blocks`` ids, the
    bits of the first element of its first row (what the TPU kernel wrote,
    for the last block), and the XOR of every 32-bit word of its rows."""
    rows = x.index_select(0, ids).view(torch.int32).reshape(blocks, -1)
    return torch.stack([rows[:, 0], _xor_rows(rows)], dim=1)


def pipe_stages(row_bytes: int) -> int:
    """Ring stages of :data:`CHUNK_ROWS` rows that fit in shared memory, at
    most :data:`PIPE_STAGES` (and, in :func:`pipe_probe`, at most a block's
    chunks), beside the per-copy variant's barriers: 64 full ones and one
    empty one a stage."""
    stage = CHUNK_ROWS * row_bytes
    barriers = -(-PIPE_STAGES * (CHUNK_ROWS + 1) * 8 // 128) * 128
    return min(PIPE_STAGES, (SMEM_BYTES - barriers) // stage)


def _pipe_shape(name: str, x: torch.Tensor, ids: torch.Tensor, blocks: int) -> tuple:
    """``(row bytes, K, stages)``, or raise for what the kernel does not take."""
    row_bytes = _check_rows_tensor(name, x)
    _check_ids(name, ids, x)
    k = ids.numel() // max(blocks, 1)
    if blocks < 1 or k * blocks != ids.numel() or k < CHUNK_ROWS or k % CHUNK_ROWS:
        raise ValueError(f"{name}: {ids.numel()} ids are not {blocks} blocks of a "
                         f"multiple of {CHUNK_ROWS}")
    _check_tx(name, CHUNK_ROWS * row_bytes)
    stages = min(pipe_stages(row_bytes), k // CHUNK_ROWS)
    if stages < 1:
        raise ValueError(f"{name}: a stage of {CHUNK_ROWS} rows of {row_bytes} B does "
                         f"not fit in {SMEM_BYTES} B of shared memory")
    return row_bytes, k, stages


_PIPE_PLAN_KEYS = ("cluster", "ctas", "threads", "issuing_lanes", "consumer_warps",
                   "max_active_clusters")
_MAX_CLUSTER = 8  # the library reports the clusters of 1..8 CTAs held at once


def pipe_plan(x: torch.Tensor, ids: torch.Tensor, blocks: int, chunked: bool) -> dict:
    """How :func:`pipe_probe` launches on ``x``'s card, as the library
    reports it (``ssn_pipe_plan``, which picks the cluster once a shape):
    ``stages``, ``cluster`` (G, the CTAs a block), ``ctas``, ``threads`` a
    CTA, ``issuing_lanes`` (the producer warp's), ``consumer_warps``,
    ``max_active_clusters`` (clusters of G held at once) and
    ``active_by_cluster`` (the clusters of each size 1..8 the card holds at
    once, from which G was picked). On the CPU, where the plain version
    runs, only ``stages``; the rest is None."""
    row_bytes, k, stages = _pipe_shape("pipe_plan", x, ids, blocks)
    plan = {"stages": stages, **dict.fromkeys(_PIPE_PLAN_KEYS), "active_by_cluster": None}
    if x.device.type == "cuda":
        out = (ctypes.c_longlong * (len(_PIPE_PLAN_KEYS) + _MAX_CLUSTER))()
        _launched("pipe_plan", _lib().ssn_pipe_plan(blocks, k, stages, row_bytes, int(chunked),
                                                    x.device.index or 0, out))
        plan.update(zip(_PIPE_PLAN_KEYS, out))
        plan["active_by_cluster"] = {g + 1: out[len(_PIPE_PLAN_KEYS) + g]
                                     for g in range(_MAX_CLUSTER)}
    return plan


def pipe_probe(x: torch.Tensor, ids: torch.Tensor, blocks: int,
               chunked: bool) -> torch.Tensor:
    """One cluster of G CTAs (:func:`pipe_plan`) a block of ``K = len(ids) /
    blocks`` ids; K row copies in chunks of :data:`CHUNK_ROWS` rows through
    each CTA's ring, each chunk retired by one barrier (``chunked``) or one a
    copy, then XOR-reduced. Returns :func:`pipe_probe_plain`'s ``[blocks, 2]``
    int32."""
    return _pipe_launch(x, ids, blocks, chunked)


def _pipe_launch(x: torch.Tensor, ids: torch.Tensor, blocks: int, chunked: bool,
                 hold_first_stage: bool = False) -> torch.Tensor:
    """:func:`pipe_probe`; ``hold_first_stage`` is a test's fault: the
    consumers never release their first stage, so the producer's wait for it
    passes its deadline (code 8)."""
    name = "pipe_probe"
    row_bytes, k, stages = _pipe_shape(name, x, ids, blocks)
    if x.device.type == "cpu":
        return pipe_probe_plain(x, ids, blocks)
    lib = _lib()
    out = torch.empty((blocks, 2), dtype=torch.int32, device=x.device)
    _launched(name, lib.ssn_pipe_probe(
        x.data_ptr(), ids.data_ptr(), blocks, k, stages, x.shape[0], row_bytes,
        int(chunked), int(hold_first_stage), out.data_ptr(), x.device.index or 0,
        _stream(x)))
    pipe_probe.launches += 1
    return out


pipe_probe.launches = 0
