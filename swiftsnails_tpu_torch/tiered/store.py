"""Host-RAM master tables with a device working-set cache — the JAX
package's ``tiered/store.py``, with PyTorch inside.

The resident store (``parallel/store.py``) caps a table at device memory.
This module adds the tier: the full-size **master** planes live in host RAM
as numpy arrays (the leaves and layouts of the device state: 2-D ``[C,
dim]``, word2vec packed ``[C, S, 128]``, CTR small-row ``[T, S, 128]``), and
the card holds only a fixed-budget **cache** plane plus a host-side slot map.

The cache plane is a smaller table of the same layout. Every pull and push
derives its capacity and its invalid-row sentinel from ``table.shape[0]``,
so once a batch's ids are remapped on the host from master units to cache
slots, the data plane (the row kernels, the merge, the access rules) runs
unchanged in slot space. The remap is injective, so the duplicate groups
and the order inside each group survive ``merge_duplicate_rows``' stable
sort and its in-order segment sum: at f32 a tiered run equals the resident
one bit for bit.

Write-back invariant: a cache slot is the one authoritative copy of its
unit from fault until flush. Dirty slots are flushed card -> host on
eviction, on checkpoint (before the manifest is built) and at the end of
the run, never dropped, so ``master ∪ dirty-cache`` always equals the
resident table.

Eviction is frequency CLOCK: each slot carries a saturating reference
counter bumped on every hit (and seeded by the vocabulary prewarm); the
hand halves counters as it sweeps, so hot rows survive many passes and
cold rows age out in O(log ref) sweeps. Slots the current batch touches
are pinned for the fault.

The cache is updated in place (the JAX package's was a value), so the
card-side order matters where JAX relied on fresh buffers:

* a dirty victim's snapshot (``gather_rows`` into a new tensor) is enqueued
  on the current stream before the slot's next install; the D2H waits on a
  CUDA event recorded after the gather, on a stream of its own;
* host rows reach the card through a pinned staging buffer a plane, and
  the buffer is rewritten only after the event of its previous copy;
* a staged (prefetched) payload is copied on the producer's side stream;
  the install makes the current stream wait for its event first.

No power-of-two padding: the kernels launch on the real row count.

Under a ``(data, model)`` mesh (``TieredTable(mesh=)``, the JAX package's
sharded cache plane) every rank holds the whole master in its own host RAM
(one a process, where the JAX package holds one a job) and its model shard
of the cache: ``budget / model`` slots, the budget rounded up to a multiple
of ``model``. Every rank makes the same host decisions (the plan runs on
the global batch), so the slot maps, CLOCK hands, counters and dirty bits
are the same everywhere. A fault installs the same rows on every rank,
each keeping its own slots (``transfer.scatter_slots_collective``: no
collective); an eviction reads the dirty victims whole with
``transfer.gather_slots_collective`` (an all-reduce over ``model``) on
the loop's thread, before the slots are reused, and only the D2H and the
master scatter go to the flusher thread. Neither the flusher nor the
prefetch producer makes a collective.
"""

from __future__ import annotations

import functools
import queue
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from swiftsnails_tpu_torch.ops import rowdma
from swiftsnails_tpu_torch.serving.kernels import whole_words, write_rows
from swiftsnails_tpu_torch.utils.device import DeviceLike, resolve_device


@dataclass
class TierStats:
    """Shared counters for the telemetry surface (goodput block, ledger run
    record, the ``tiered`` lane). ``lookups``/``hits`` count unique units
    per fault batch; ``faulted_rows``/``evictions`` count cache units (rows
    for the dense/packed layouts, tiles for packed-small).

    The ``*_ns`` fields are the step-time breakdown: host nanoseconds spent
    planning (the step's negatives drawn ahead, mostly on the prefetch
    producer thread), faulting (``ensure``: residency check + allocation +
    install dispatch, including any flush-queue wait), flushing (synchronous
    write-back + async landings on the flush worker), remapping ids to slot
    space, and staging H2D copies of row payloads. Updated from several
    threads without locks — a rare lost sample costs telemetry only."""

    lookups: int = 0
    hits: int = 0
    faults: int = 0  # batched fault events (one per table per faulting step)
    faulted_rows: int = 0  # units moved host -> device
    evictions: int = 0
    flushes: int = 0  # batched write-back events
    flushed_rows: int = 0  # dirty units written device -> host
    h2d_bytes: int = 0
    d2h_bytes: int = 0
    prewarmed_rows: int = 0
    plan_ns: int = 0
    fault_ns: int = 0
    flush_ns: int = 0
    remap_ns: int = 0
    h2d_ns: int = 0
    flush_wait_ns: int = 0  # consumer blocked on the flush queue (drain/full)
    transparent_steps: int = 0  # steps served by the pass-through fast path

    @property
    def hit_rate(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0

    def breakdown(self) -> Dict:
        """The tiered step-time breakdown block (lane JSON + ledger)."""
        return {
            "plan_ns": self.plan_ns,
            "fault_ns": self.fault_ns,
            "flush_ns": self.flush_ns,
            "remap_ns": self.remap_ns,
            "h2d_ns": self.h2d_ns,
            "flush_wait_ns": self.flush_wait_ns,
            "h2d_bytes": self.h2d_bytes,
            "d2h_bytes": self.d2h_bytes,
        }

    def as_dict(self) -> Dict:
        return {
            "hit_rate": round(self.hit_rate, 4),
            "lookups": self.lookups,
            "hits": self.hits,
            "faults": self.faults,
            "faulted_rows": self.faulted_rows,
            "evictions": self.evictions,
            "flushes": self.flushes,
            "flushed_rows": self.flushed_rows,
            "h2d_bytes": self.h2d_bytes,
            "d2h_bytes": self.d2h_bytes,
            "prewarmed_rows": self.prewarmed_rows,
            "transparent_steps": self.transparent_steps,
            "breakdown": self.breakdown(),
        }


_MASK64 = (1 << 64) - 1
_HASH_SEED = 0x5EED5A11  # fixed: digests are process-local, any constant works


def _hash_weights(nbytes: int, seed: int) -> np.ndarray:
    """Fixed pseudo-random odd uint64 weight per byte position — the key of
    the per-unit hash. Odd weights make every byte position full-rank mod
    2^64, so any single flipped bit flips the unit hash."""
    rng = np.random.default_rng(seed)
    lo = rng.integers(0, 1 << 32, size=nbytes, dtype=np.uint64)
    hi = rng.integers(0, 1 << 32, size=nbytes, dtype=np.uint64)
    return (hi << np.uint64(32)) | lo | np.uint64(1)


def _rows_hash(rows: np.ndarray, weights: np.ndarray) -> int:
    """Wraparound-sum keyed hash of a block of units: each unit's bytes as
    uint8, weighted by position, everything summed mod 2^64. Per-unit
    hashes are summed (not chained), so a plane digest updates
    incrementally — subtract the old units' hashes, add the new ones.

    Computed as the per-position byte sums (exact: at most 255 a unit)
    dotted with the weights mod 2^64 — the JAX package's
    ``sum(bytes * weights)`` regrouped, equal to it, without its 8x uint64
    intermediate."""
    n = rows.shape[0]
    if n == 0:
        return 0
    flat = np.ascontiguousarray(rows).view(np.uint8).reshape(n, -1)
    col = flat.sum(axis=0, dtype=np.uint64)
    return int((col * weights).sum(dtype=np.uint64))


MASTER_DTYPES = ("float32", "int8")


def resolve_master_dtype(name: Optional[str]) -> str:
    """Validate / canonicalize a ``tier_master_dtype`` config value."""
    if not name:
        return "float32"
    canon = {"float32": "float32", "f32": "float32",
             "int8": "int8", "s8": "int8"}.get(str(name).strip().lower())
    if canon is None:
        raise ValueError(
            f"tier_master_dtype must be one of {MASTER_DTYPES}, got {name!r}")
    return canon


def _np_hash_uniform(units: np.ndarray, gens: np.ndarray, per: int) -> np.ndarray:
    """Deterministic uniform[0,1) dither [n, per] keyed by (unit id,
    quantization generation, element position), so master re-quantization
    is reproducible given the scatter history yet unbiased over positions
    and generations."""
    u = np.asarray(units, np.uint64).astype(np.uint32)
    g = np.asarray(gens, np.uint64).astype(np.uint32)
    seed = (u * np.uint32(2654435761) + g * np.uint32(0x9E3779B9))
    x = np.arange(per, dtype=np.uint32)[None, :] * np.uint32(2654435761)
    x = x + seed[:, None]
    x = x ^ (x >> np.uint32(16))
    x = x * np.uint32(0x7FEB352D)
    x = x ^ (x >> np.uint32(15))
    x = x * np.uint32(0x846CA68B)
    x = x ^ (x >> np.uint32(16))
    return x.astype(np.float64) * (1.0 / 4294967296.0)


def _np_quant_unit_rows(rows: np.ndarray, dither: Optional[np.ndarray] = None
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-unit symmetric int8 of ``[n, ...]`` f32 rows -> (codes int8 of
    ``rows.shape``, scales f32 [n] = unit_amax/127; all-zero units get zero
    scale). ``dither`` switches round-to-nearest to unbiased floor(y + u)."""
    n = rows.shape[0]
    flat = np.asarray(rows, np.float32).reshape(n, -1)
    amax = np.abs(flat).max(axis=1) if flat.size else np.zeros(n, np.float32)
    scale = (amax / np.float32(127.0)).astype(np.float32)
    inv = np.divide(np.float32(1.0), scale, where=scale > 0,
                    out=np.zeros_like(scale))
    y = flat * inv[:, None]
    y = np.rint(y) if dither is None else np.floor(y + dither)
    codes = np.clip(y, -127, 127).astype(np.int8).reshape(rows.shape)
    return codes, scale


def _np_dequant_unit_rows(codes: np.ndarray, scales: np.ndarray,
                          dtype) -> np.ndarray:
    """int8 codes + per-unit scales -> rows of the logical dtype."""
    n = codes.shape[0]
    shape = (n,) + (1,) * (codes.ndim - 1)
    return (codes.astype(np.float32)
            * np.asarray(scales, np.float32).reshape(shape)).astype(dtype)


# ---------------------------------------------------- numpy <-> torch ---
#
# numpy has no bfloat16: a bf16 plane is stored as its int16 bits, and the
# logical dtype rides beside it as a torch dtype.


def _owned_numpy(x) -> Tuple[np.ndarray, torch.dtype]:
    """An owned, writable, contiguous host copy of a tensor (any device) or
    numpy array, and its logical torch dtype."""
    if isinstance(x, torch.Tensor):
        t = x.detach()
        dtype = t.dtype
        if dtype == torch.bfloat16:
            t = t.view(torch.int16)
        arr = t.numpy().copy() if t.device.type == "cpu" else t.cpu().numpy()
        return np.ascontiguousarray(arr), dtype
    arr = np.array(x, order="C")  # a copy
    if arr.dtype.name == "bfloat16":
        return arr.view(np.int16), torch.bfloat16
    return arr, torch.from_numpy(arr[:0]).dtype


def _to_torch(arr: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """A CPU tensor of the logical dtype over ``arr``'s memory."""
    t = torch.from_numpy(arr)
    return t.view(torch.bfloat16) if dtype == torch.bfloat16 else t


def _as_f32(arr: np.ndarray, dtype: torch.dtype) -> np.ndarray:
    if dtype == torch.bfloat16:
        return _to_torch(np.ascontiguousarray(arr), dtype).float().numpy()
    return np.asarray(arr, np.float32)


def _from_f32(arr: np.ndarray, dtype: torch.dtype) -> np.ndarray:
    """f32 rows in the storage form of the logical ``dtype``."""
    if dtype == torch.bfloat16:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(
            torch.bfloat16).view(torch.int16).numpy()
    return arr.astype(torch.empty((), dtype=dtype).numpy().dtype, copy=False)


def _fields(state):
    if isinstance(state, dict):
        return state["table"], state["slots"]
    return state.table, state.slots


def whole_state(mesh, state):
    """A table state (its table and slot planes) whole: under a mesh of
    ``model`` > 1 its shards gathered over ``model`` (a collective: every
    rank calls it), else ``state`` itself."""
    from swiftsnails_tpu_torch.parallel.mesh import gather_model

    tab, slots = _fields(state)
    whole = gather_model(mesh, tab)
    if whole is tab:
        return state
    return type(state)(table=whole, slots={k: gather_model(mesh, v) for k, v in slots.items()})


class HostMaster:
    """numpy master plane for one table: the same (table, slots) leaves as
    the device state, full size, host-resident. ``group`` is the number of
    logical rows per cache unit (1 except the packed-small plane, where one
    unit is a ``[S, 128]`` tile holding G rows).

    ``master_dtype: int8`` stores every float plane as int8 codes plus one
    f32 scale per unit (``amax/127`` over the unit's elements), roughly
    quadrupling the vocab a host holds at fixed RAM. The quantization is
    invisible outside this class: :meth:`gather` dequantizes into the
    logical dtype the cache uses, :meth:`scatter` re-quantizes with a
    deterministic hash dither keyed by (unit, per-unit quantization
    generation) so repeated flush round trips stay unbiased, and
    :meth:`state` / :meth:`reload` speak full-precision states — a
    checkpoint is byte-identical in format to an f32-master run's.
    Integrity digests cover the code planes AND the scale sidebands
    (``<plane>/scale``), both maintained incrementally through scatter.

    Rows cross the interface as numpy arrays in storage form: f32 as f32,
    bf16 as its int16 bits.
    """

    def __init__(self, state, layout: str, group: int = 1,
                 checksums: bool = True, master_dtype: str = "float32"):
        self.kind = type(state)  # TableState | PackedTableState | dict
        self.layout = layout
        self.group = int(group)
        self.master_dtype = resolve_master_dtype(master_dtype)
        tab, slot_src = _fields(state)
        # owned, writable copies: the masters are mutated in place by every
        # write-back
        table, self.table_dtype = _owned_numpy(tab)
        slots, self.slot_dtypes = {}, {}
        for k, v in slot_src.items():
            slots[k], self.slot_dtypes[k] = _owned_numpy(v)
        self.quantized = self.master_dtype == "int8"
        # per-plane per-unit f32 scale sidebands (quantized masters only),
        # keyed by plane name; a per-unit quantization-generation counter
        # salts the scatter-path dither so every re-quantization of a unit
        # draws fresh (but replayable) noise
        self.scales: Dict[str, np.ndarray] = {}
        self._qgen: Optional[np.ndarray] = None
        if self.quantized:
            self._qgen = np.zeros(table.shape[0], np.uint32)
            self._quantize_all(table, slots)
        else:
            self.table = table
            self.slots = slots
        # per-plane integrity digests: a keyed wraparound sum of per-unit
        # hashes, maintained incrementally through scatter() so a direct
        # memory corruption (bit rot, a stray write bypassing scatter) is
        # detectable by verify() at any time
        self._weights: Optional[Dict[str, np.ndarray]] = None
        self._digests: Optional[Dict[str, int]] = None
        if checksums:
            self._init_digests()

    def _quantize_all(self, table: np.ndarray, slots: Dict[str, np.ndarray]) -> None:
        self.table, self.scales["table"] = _np_quant_unit_rows(
            _as_f32(table, self.table_dtype))
        self.slots = {}
        for k, v in slots.items():
            self.slots[k], self.scales[f"slots/{k}"] = _np_quant_unit_rows(
                _as_f32(v, self.slot_dtypes[k]))

    # -- integrity ----------------------------------------------------------

    def _planes(self):
        yield "table", self.table
        for k in sorted(self.slots):
            yield f"slots/{k}", self.slots[k]
        # the scale sidebands are part of the master's content: a flipped
        # scale bit corrupts every element of its unit on dequant, so the
        # digests (and the bitflip chaos drill) must cover them too
        for p in sorted(self.scales):
            yield f"{p}/scale", self.scales[p][:, None]

    def _plane_weights(self, plane: str, arr: np.ndarray) -> np.ndarray:
        per = int(np.prod(arr.shape[1:], dtype=np.int64)) * arr.dtype.itemsize
        w = self._weights.get(plane)
        if w is None or w.shape[0] != per:
            seed = (_HASH_SEED + hash(plane)) & _MASK64
            w = self._weights[plane] = _hash_weights(max(per, 1), seed)
        return w

    def _plane_digest(self, plane: str, arr: np.ndarray) -> int:
        return _rows_hash(arr, self._plane_weights(plane, arr))

    def _init_digests(self) -> None:
        self._weights = {}
        self._digests = {
            plane: self._plane_digest(plane, arr)
            for plane, arr in self._planes()
        }

    @property
    def checksummed(self) -> bool:
        return self._digests is not None

    def _digest_swap(self, plane: str, arr: np.ndarray,
                     old_rows: np.ndarray, new_rows: np.ndarray) -> None:
        w = self._plane_weights(plane, arr)
        d = self._digests[plane]
        d = (d - _rows_hash(old_rows, w)) & _MASK64
        d = (d + _rows_hash(np.asarray(new_rows, dtype=arr.dtype), w)) & _MASK64
        self._digests[plane] = d

    def verify(self) -> list:
        """Recompute every plane digest and compare with the incrementally
        tracked one; returns the names of corrupt planes (``table`` /
        ``slots/<name>`` / ``<plane>/scale``), empty when the masters are
        intact. Any content change that did not flow through
        :meth:`scatter` — a flipped bit, a torn write — shows up here."""
        if self._digests is None:
            return []
        return [
            plane for plane, arr in self._planes()
            if self._plane_digest(plane, arr) != self._digests[plane]
        ]

    def reload(self, state) -> None:
        """Replace the master content wholesale (the quarantine-and-rebuild
        path: the caller restored a verified checkpoint) and re-seed the
        digests. Quantized masters re-quantize deterministically
        (round-to-nearest): the heal path must be reproducible."""
        tab, slot_src = _fields(state)
        table, _ = _owned_numpy(tab)
        slots = {k: _owned_numpy(v)[0] for k, v in slot_src.items()}
        if self.quantized:
            self._quantize_all(table, slots)
        else:
            self.table = table
            self.slots = slots
        if self._digests is not None:
            self._init_digests()

    @property
    def units(self) -> int:
        return self.table.shape[0]

    def _logical_itemsize(self, dtype: torch.dtype) -> int:
        return torch.empty((), dtype=dtype).element_size()

    @property
    def unit_nbytes(self) -> int:
        """LOGICAL bytes per unit — the size of the full-precision rows this
        master hands the cache. The manager sizes the device budget off
        this, so it must not shrink when the host storage narrows."""
        per = int(np.prod(self.table.shape[1:], dtype=np.int64)) or 1
        n = per * self._logical_itemsize(self.table_dtype)
        for k, v in self.slots.items():
            sper = int(np.prod(v.shape[1:], dtype=np.int64)) or 1
            n += sper * self._logical_itemsize(self.slot_dtypes[k])
        return n

    @property
    def host_unit_nbytes(self) -> int:
        """STORED bytes per unit in host RAM (codes + scale sidebands for a
        quantized master). Equals :attr:`unit_nbytes` for f32 masters."""
        per = int(np.prod(self.table.shape[1:], dtype=np.int64)) or 1
        n = per * self.table.dtype.itemsize
        for v in self.slots.values():
            sper = int(np.prod(v.shape[1:], dtype=np.int64)) or 1
            n += sper * v.dtype.itemsize
        for s in self.scales.values():
            n += s.dtype.itemsize
        return n

    def gather(self, units: np.ndarray) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
        """The units' rows in storage form of their logical dtypes."""
        if not self.quantized:
            return self.table[units], {k: v[units] for k, v in self.slots.items()}
        t = _from_f32(_np_dequant_unit_rows(
            self.table[units], self.scales["table"][units], np.float32),
            self.table_dtype)
        s = {
            k: _from_f32(_np_dequant_unit_rows(
                v[units], self.scales[f"slots/{k}"][units], np.float32),
                self.slot_dtypes[k])
            for k, v in self.slots.items()
        }
        return t, s

    def scatter(self, units: np.ndarray, table_rows: np.ndarray,
                slot_rows: Dict[str, np.ndarray]) -> None:
        """Write units back into the masters. ``units`` must be unique (every
        call site flushes a slot map, which is injective) — the incremental
        digest update assumes each unit's old bytes are replaced once.

        Quantized masters re-quantize here with a hash dither keyed by
        (unit, generation): unbiased over repeated flush round trips, yet
        deterministic given the scatter history — and independent of how
        the async flush coalesces, because each unit's generation advances
        exactly once per landing."""
        units = np.asarray(units)
        if self.quantized and units.size:
            gens = self._qgen[units]
            per = int(np.prod(self.table.shape[1:], dtype=np.int64)) or 1
            codes, scales = _np_quant_unit_rows(
                _as_f32(table_rows, self.table_dtype),
                _np_hash_uniform(units, gens, per))
            new_slot: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
            for k, v in slot_rows.items():
                sper = int(np.prod(self.slots[k].shape[1:],
                                   dtype=np.int64)) or 1
                # salt the generation per plane so planes draw distinct noise
                new_slot[k] = _np_quant_unit_rows(
                    _as_f32(v, self.slot_dtypes[k]),
                    _np_hash_uniform(units, gens + np.uint32(0x85EBCA6B), sper))
            if self._digests is not None:
                self._digest_swap("table", self.table, self.table[units], codes)
                self._digest_swap("table/scale", self.scales["table"][:, None],
                                  self.scales["table"][units, None],
                                  scales[:, None])
                for k, (c, s) in new_slot.items():
                    self._digest_swap(f"slots/{k}", self.slots[k],
                                      self.slots[k][units], c)
                    self._digest_swap(f"slots/{k}/scale",
                                      self.scales[f"slots/{k}"][:, None],
                                      self.scales[f"slots/{k}"][units, None],
                                      s[:, None])
            self.table[units] = codes
            self.scales["table"][units] = scales
            for k, (c, s) in new_slot.items():
                self.slots[k][units] = c
                self.scales[f"slots/{k}"][units] = s
            self._qgen[units] += 1
            return
        if self._digests is not None and units.size:
            self._digest_swap("table", self.table, self.table[units], table_rows)
            for k, v in slot_rows.items():
                self._digest_swap(f"slots/{k}", self.slots[k],
                                  self.slots[k][units], v)
        self.table[units] = table_rows
        for k, v in slot_rows.items():
            self.slots[k][units] = v

    def state(self):
        """The full-size state (CPU tensors) — what checkpoints save and
        what the trainer gets back at the end of a run. Same NamedTuple
        type, shapes and dtypes as the resident state, so the on-disk
        checkpoint format is unchanged: quantized masters dequantize BEFORE
        the manifest ever sees a plane (f32 in, f32 out). An f32 master's
        tensors share its arrays' memory, as the JAX package's numpy leaves
        do."""
        if not self.quantized:
            table = _to_torch(self.table, self.table_dtype)
            slots = {k: _to_torch(v, self.slot_dtypes[k])
                     for k, v in self.slots.items()}
        else:
            table = _to_torch(_from_f32(_np_dequant_unit_rows(
                self.table, self.scales["table"], np.float32),
                self.table_dtype), self.table_dtype)
            slots = {
                k: _to_torch(_from_f32(_np_dequant_unit_rows(
                    v, self.scales[f"slots/{k}"], np.float32),
                    self.slot_dtypes[k]), self.slot_dtypes[k])
                for k, v in self.slots.items()
            }
        return self.kind(table=table, slots=slots)


# ------------------------------------------------------- card transfers ---


def _to_host_numpy(t: torch.Tensor, event, stream) -> np.ndarray:
    """A device snapshot's rows on the host, in storage form. On the card
    the copy runs on ``stream`` after ``event`` (recorded after the gather
    that made the snapshot), and the snapshot is marked as used there, so
    the caching allocator cannot hand its memory to a later install first."""
    if t.device.type == "cuda":
        with torch.cuda.stream(stream):
            stream.wait_event(event)
            t.record_stream(stream)
            host = t.to("cpu")  # synchronous on `stream`
    else:
        host = t
    if host.dtype == torch.bfloat16:
        host = host.view(torch.int16)
    return host.numpy()


class _PinnedStage:
    """One reusable pinned host buffer for one plane's fault payloads. A
    payload is written into it only after the event of its previous H2D
    copy, so a non-blocking copy in flight is never overwritten."""

    def __init__(self):
        self.buf: Optional[torch.Tensor] = None
        self.event = None

    def to_device(self, rows: np.ndarray, dtype: torch.dtype,
                  device: torch.device) -> torch.Tensor:
        n = rows.shape[0]
        if self.event is not None:
            self.event.synchronize()
        if (self.buf is None or self.buf.shape[0] < n
                or tuple(self.buf.shape[1:]) != tuple(rows.shape[1:])
                or self.buf.dtype != dtype):
            cap = 1 << max(n - 1, 0).bit_length()
            self.buf = torch.empty((cap,) + tuple(rows.shape[1:]), dtype=dtype,
                                   pin_memory=True)
        view = self.buf.view(torch.int16) if dtype == torch.bfloat16 else self.buf
        view.numpy()[:n] = rows
        dev = self.buf[:n].to(device, non_blocking=True)
        self.event = torch.cuda.Event()
        self.event.record()
        return dev


def _gather_plane(plane: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """A new tensor of ``plane``'s rows ``idx``: the row-gather kernel
    where a row is whole 16-byte words, else ``index_select`` (the shape
    rule of the serving pull)."""
    if whole_words(plane):
        return rowdma.gather_rows(plane, idx)
    return plane.index_select(0, idx)


class _FlushQueue:
    """Bounded background write-back drain (``tier_async_flush``).

    The eviction path hands each dirty-victim batch over as snapshots
    already enqueued on the card (taken before the slot is reused) with the
    event recorded after them; the worker thread waits for the D2H off the
    step path, coalesces up to ``batch`` queued entries per table, and lands
    them in the host masters with one ``scatter`` per table. Correctness
    rides the generation protocol: ``master_ver`` bumps only at landing
    (after the master scatter), so a staged install racing an in-flight
    flush either sees the bumped version (flush landed -> mismatch ->
    discard) or finds the unit still pending (the consumer drains before
    gathering it — see ``TieredTable.ensure``). At most one in-flight entry
    ever holds a given unit, because refaulting a pending unit forces that
    drain first — which is what lets the worker concatenate entries and
    scatter them in one call.

    ``drain()`` is the barrier ``master_state``, checkpoint save, ``heal``,
    ``verify`` and the end of a run use: it returns only when every queued
    entry has landed. Worker errors re-raise at the next ``drain()`` or
    ``put()``. The worker thread starts lazily on the first ``put`` — a run
    that never evicts (or a serving tier, which is read-only) never spawns
    it — and ``stop()`` ends it; a ``put`` after that starts a new one.
    """

    def __init__(self, depth: int = 8, batch: int = 8, registry=None):
        self._q: "queue.Queue" = queue.Queue(maxsize=max(int(depth), 1))
        self._batch = max(int(batch), 1)
        self._registry = registry
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        self._gate = threading.Event()  # test hook: cleared => worker pauses
        self._gate.set()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    def qsize(self) -> int:
        return self._q.qsize()

    def put(self, table: "TieredTable", units: np.ndarray, n: int,
            t_dev, s_dev: Dict, event) -> None:
        """Enqueue one eviction's dirty victims; blocks when the queue is
        full (bounded backpressure — the step path waits rather than letting
        unlanded device snapshots grow without bound)."""
        self._raise_pending()
        if self._thread is None:
            with self._lock:
                if self._thread is None:
                    self._thread = threading.Thread(
                        target=self._work, daemon=True,
                        name="tier-flush-worker")
                    self._thread.start()
        self._q.put((table, units, n, t_dev, s_dev, event))

    def drain(self) -> None:
        """Block until every queued entry has landed in its master; re-raise
        any worker error. This is the flush-before-manifest barrier."""
        self._q.join()
        self._raise_pending()

    def _raise_pending(self) -> None:
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    # test hooks: freeze/unfreeze the worker to force gather/flush
    # interleavings deterministically
    def pause(self) -> None:
        self._gate.clear()

    def resume(self) -> None:
        self._gate.set()

    def close(self) -> None:
        self._stop.set()
        self._gate.set()

    def stop(self) -> None:
        """Land every queued entry, then end the worker and join it. A
        worker error stays pending for the next ``drain()`` or ``put()``."""
        with self._lock:
            thread, self._thread = self._thread, None
            if thread is None:
                return
            self._gate.set()
            self._q.join()
            self.close()
            thread.join()
            self._stop.clear()

    def _work(self) -> None:
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            entries = [first]
            while len(entries) < self._batch:
                try:
                    entries.append(self._q.get_nowait())
                except queue.Empty:
                    break
            self._gate.wait()
            try:
                self._land(entries)
            except BaseException as e:  # surfaced at the next drain/put
                self._err = e
            finally:
                for _ in entries:
                    self._q.task_done()
            if self._registry is not None:
                self._registry.gauge("tier_flush_queue_depth").set(
                    self._q.qsize())

    def _land(self, entries: List[Tuple]) -> None:
        t0 = time.monotonic_ns()
        by_table: Dict[int, Tuple["TieredTable", List[Tuple]]] = {}
        for table, *chunk in entries:
            by_table.setdefault(id(table), (table, []))[1].append(tuple(chunk))
        for table, chunks in by_table.values():
            table._land_flush(chunks)
        if self._registry is not None:
            self._registry.histogram("tier_flush_ms").observe(
                (time.monotonic_ns() - t0) / 1e6)


class TieredTable:
    """Fixed-budget cache + slot map over one :class:`HostMaster`.

    Holds *no* device tensors: the cache plane flows through the trainer's
    state, and every method that moves data takes the current cache state
    (whose tensors it updates in place) and returns it.

    ``use_native`` (the trainers' ``use_native`` key, on by default) takes
    the remap and the CLOCK sweep through the native library, which must
    build (a failed ``g++`` build raises); off, the numpy and Python paths,
    which give the same slot maps bit for bit.

    ``mesh``: the cache plane is row-sharded over the mesh's ``model``
    axis (module docstring); the methods that move data take and return
    this rank's shard.
    """

    def __init__(
        self,
        master: HostMaster,
        budget_units: int,
        *,
        mesh=None,
        name: str = "",
        stats: Optional[TierStats] = None,
        read_only: bool = False,
        flusher: Optional[_FlushQueue] = None,
        device: DeviceLike = None,
        use_native: bool = True,
    ):
        self.master = master
        self.mesh = mesh
        self.device = resolve_device(device)
        self._native = None
        if use_native:
            from swiftsnails_tpu_torch.data import native

            native.require()
            self._native = native
        # async write-back: eviction flushes enqueue here instead of blocking
        # the step on the D2H + master scatter; None = synchronous (serving,
        # direct constructions, tier_async_flush: 0)
        self.flusher = flusher
        # units with an enqueued-but-unlanded flush (at most one in-flight
        # entry per unit — refaulting a pending unit drains first). Allocated
        # lazily: a run that never evicts pays nothing.
        self._pending: Optional[np.ndarray] = None
        self._stages: Dict[str, _PinnedStage] = {}
        self._d2h_stream = None
        self.name = name or "table"
        self.stats = stats if stats is not None else TierStats()
        self.read_only = read_only
        budget = max(int(budget_units), 1)
        self.model = 1
        if mesh is not None:
            from swiftsnails_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh

            if not isinstance(mesh, Mesh):
                raise TypeError(f"mesh must be a parallel.mesh.Mesh, got {type(mesh)}")
            self.model = mesh.axis_size(MODEL_AXIS)
            if master.units % self.model:
                raise ValueError(f"tiered[{name or 'table'}]: {master.units} master units "
                                 f"do not split over model axis {self.model}")
            budget = -(-budget // self.model) * self.model  # rows-per-shard divisibility
        self.budget = min(budget, master.units)
        self.group = master.group
        # host slot map: unit -> cache slot (and inverse), CLOCK state
        self.slot_of = np.full(master.units, -1, np.int64)
        self.unit_of = np.full(self.budget, -1, np.int64)
        self.ref = np.zeros(self.budget, np.uint8)  # saturating frequency
        self.dirty = np.zeros(self.budget, bool)
        self.hand = 0
        self.used = 0  # slots handed out before the clock ever has to evict
        # transparent (pass-through) mode: the budget covers EVERY master
        # unit and the slot map is the identity, so no step can ever fault,
        # evict, or need a remap — the per-step plan/ensure bookkeeping is
        # skipped and the tiered run moves at resident speed. Write-back
        # shifts from per-step dirty marking to "every used slot is dirty"
        # at flush time (see flush()).
        self.transparent = False
        # per-unit write-back generation: bumped after every master write, so
        # a staged (prefetched) row whose unit was fault->update->evict-flushed
        # between stage and install is detected as stale and re-gathered —
        # installing it would silently resurrect the pre-update value
        self.master_ver = np.zeros(master.units, np.uint32)
        # freshness tee: fn(name, units) invoked after every landed master
        # write-back (the dirty-flush stream IS the delta-publish signal),
        # on whichever thread landed it — the async flush worker included;
        # None = no subscriber, zero cost
        self.delta_tap = None

    # -- cache plane construction ------------------------------------------

    def make_cache(self):
        """Zero-filled cache plane of the master's layout on the card (or
        the table's device); under a mesh this rank's ``budget / model``
        slots of it. Unassigned slots are never read (pulls only see slots
        the fault path installed), so zeros are safe."""
        m = self.master
        rows = self.budget // self.model
        table = torch.zeros((rows,) + m.table.shape[1:],
                            dtype=m.table_dtype, device=self.device)
        slots = {
            k: torch.zeros((rows,) + v.shape[1:],
                           dtype=m.slot_dtypes[k], device=self.device)
            for k, v in m.slots.items()
        }
        return m.kind(table=table, slots=slots)

    # -- id space ----------------------------------------------------------

    def units_for(self, rows: np.ndarray) -> np.ndarray:
        rows = np.asarray(rows)
        return rows // self.group if self.group > 1 else rows

    def remap(self, rows: np.ndarray) -> np.ndarray:
        """Master row ids -> cache-slot-space row ids (shape and dtype
        kept). Every unit must be resident (call :meth:`ensure` first).

        int32 ids take the native (GIL-releasing) path with ``use_native``;
        the numpy expression below is the same mapping."""
        rows = np.asarray(rows)
        t0 = time.monotonic_ns()
        nat = self._native
        if nat is not None and rows.dtype == np.int32:
            out, bad = nat.tier_remap(self.slot_of, rows.ravel(), self.group)
            if bad:
                raise RuntimeError(
                    f"tiered[{self.name}]: remap hit a non-resident unit — "
                    "ensure() must cover every id the step touches")
            self.stats.remap_ns += time.monotonic_ns() - t0
            return out.reshape(rows.shape)
        if self.group > 1:
            units = rows // self.group
            slots = self.slot_of[units]
            out = slots * self.group + rows % self.group
        else:
            out = self.slot_of[rows]
        if out.size and int(out.min()) < 0:
            raise RuntimeError(
                f"tiered[{self.name}]: remap hit a non-resident unit — "
                "ensure() must cover every id the step touches")
        self.stats.remap_ns += time.monotonic_ns() - t0
        return out.astype(rows.dtype)

    def peek_missing(self, units: np.ndarray) -> np.ndarray:
        """Sorted unique units not currently resident. Safe to call from the
        staging thread — a stale answer only costs prefetch efficiency."""
        uniq = np.unique(np.asarray(units).ravel())
        return uniq[self.slot_of[uniq] < 0]

    # -- fault path ---------------------------------------------------------

    def check(self, units: np.ndarray) -> np.ndarray:
        """The sorted distinct ``units``, once :meth:`ensure`'s checks
        pass, with nothing changed: every id in range, and no more distinct
        units than the cache holds. Raises as :meth:`ensure` does."""
        uniq = np.unique(np.asarray(units).ravel())
        if uniq.size and (int(uniq[0]) < 0 or int(uniq[-1]) >= self.master.units):
            raise ValueError(
                f"tiered[{self.name}]: unit ids out of range "
                f"[{uniq[0]}, {uniq[-1]}] for {self.master.units} units")
        if int(uniq.size) > self.budget:
            raise RuntimeError(
                f"tiered[{self.name}]: the step touches {int(uniq.size)} distinct "
                f"cache units but the HBM budget holds only {self.budget}; "
                "raise tier_hbm_budget_mb (or shrink the batch)")
        return uniq

    def ensure(self, cache, units: np.ndarray, *, staged=None,
               mark_dirty: Optional[bool] = None):
        """Make every unit resident; returns the (updated) cache state.

        ``staged`` is an optional ``(sorted_units, unit_versions,
        device_table_rows, {slot: device_rows}, event)`` payload from the
        prefetch thread — units found there at their staged write-back
        generation skip the host gather + H2D copy on the critical path.
        ``mark_dirty`` defaults to the table's write mode (training marks
        every touched slot dirty — the push *will* write it; serving never
        does).
        """
        t_ensure0 = time.monotonic_ns()
        if mark_dirty is None:
            mark_dirty = not self.read_only
        uniq = self.check(units)
        self.stats.lookups += int(uniq.size)
        slots = self.slot_of[uniq]
        resident = slots >= 0
        hit_slots = slots[resident]
        self.stats.hits += int(hit_slots.size)
        self.ref[hit_slots] = np.minimum(
            self.ref[hit_slots].astype(np.int64) + 1, 255
        ).astype(np.uint8)
        miss = uniq[~resident]
        if miss.size:
            if self._pending is not None and self._pending[miss].any():
                # refault of a unit whose eviction flush is still in flight:
                # the master copy is stale until that entry lands, and the
                # staged version check alone cannot catch a gather taken at
                # the still-current generation — wait the queue out first
                t0 = time.monotonic_ns()
                self.flusher.drain()
                self.stats.flush_wait_ns += time.monotonic_ns() - t0
            new_slots = self._allocate(hit_slots, cache, int(miss.size))
            self.unit_of[new_slots] = miss
            self.slot_of[miss] = new_slots
            self.ref[new_slots] = 1
            self.dirty[new_slots] = False
            self.stats.faults += 1
            self.stats.faulted_rows += int(miss.size)
            cache = self._install(cache, miss, new_slots, staged)
        if mark_dirty and uniq.size:
            self.dirty[self.slot_of[uniq]] = True
        self.stats.fault_ns += time.monotonic_ns() - t_ensure0
        return cache

    def _allocate(self, pinned_slots: np.ndarray, cache, n: int) -> np.ndarray:
        """Grab ``n`` cache slots: unassigned first, then CLOCK eviction
        (dirty victims are flushed to the master before reuse). With
        ``use_native`` the sweep runs in libsnails (it releases the GIL, so
        the prefetch producer keeps moving); the Python loop below is the
        same sweep."""
        out = np.empty(n, np.int64)
        k = 0
        while k < n and self.used < self.budget:
            out[k] = self.used
            self.used += 1
            k += 1
        if k < n:
            pinned = np.zeros(self.budget, bool)
            pinned[pinned_slots] = True
            pinned[out[:k]] = True
            if self._native is not None:
                victims, self.hand = self._native.tier_clock_sweep(
                    self.ref, pinned, self.hand, n - k)
                out[k:] = victims
                k = n
            while k < n:
                h = self.hand
                self.hand = (self.hand + 1) % self.budget
                if pinned[h]:
                    continue
                if self.ref[h] > 0:
                    self.ref[h] >>= 1  # age; hot slots survive O(log) sweeps
                    continue
                out[k] = h
                pinned[h] = True
                k += 1
            victims = out[self.unit_of[out] >= 0]
            if victims.size:
                self.stats.evictions += int(victims.size)
                vd = victims[self.dirty[victims]]
                if vd.size:
                    self._flush_slots(cache, vd)
                self.slot_of[self.unit_of[victims]] = -1
                self.unit_of[victims] = -1
        return out

    def _idx(self, slots: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(slots, np.int32)).to(self.device)

    def _install(self, cache, miss: np.ndarray, slots: np.ndarray, staged):
        """Write the faulted units' rows into the cache plane — from the
        staged device payload where it is current, from a host master gather
        for the rest — with ONE ``scatter_write_rows`` a plane: the two
        sources are joined on the card first."""
        parts = []  # (cache slots, table rows, {slot plane: rows})
        host_miss, host_slots = miss, slots
        if staged is not None:
            s_units, s_vers, s_table, s_slots, event = staged
            pos = np.searchsorted(s_units, miss)
            pos_c = np.minimum(pos, max(len(s_units) - 1, 0))
            ok = (
                (len(s_units) > 0)
                & (pos < len(s_units))
                & (s_units[pos_c] == miss)
                # stale staged row: the unit was flushed (fault -> update ->
                # evict) after the stage gathered it — re-gather from master
                & (s_vers[pos_c] == self.master_ver[miss])
            )
            if np.any(ok):
                if event is not None:
                    # no install reads a staged tensor before its copy landed;
                    # the tensors were made on the producer's stream, so mark
                    # their use here for the caching allocator
                    cur = torch.cuda.current_stream(self.device)
                    cur.wait_event(event)
                    s_table.record_stream(cur)
                    for v in s_slots.values():
                        v.record_stream(cur)
                take = self._idx(pos_c[ok])
                parts.append((slots[ok], s_table.index_select(0, take),
                              {k: v.index_select(0, take) for k, v in s_slots.items()}))
                host_miss, host_slots = miss[~ok], slots[~ok]
        if host_miss.size:
            t_rows, s_rows = self.master.gather(host_miss)
            self.stats.h2d_bytes += t_rows.nbytes + sum(
                v.nbytes for v in s_rows.values())
            t0 = time.monotonic_ns()
            parts.append((host_slots,
                          self._stage("table", t_rows, self.master.table_dtype),
                          {k: self._stage(f"slots/{k}", v, self.master.slot_dtypes[k])
                           for k, v in s_rows.items()}))
            self.stats.h2d_ns += time.monotonic_ns() - t0
        if len(parts) == 1:
            return self._write_state(cache, *parts[0])
        return self._write_state(
            cache, np.concatenate([p[0] for p in parts]),
            torch.cat([p[1] for p in parts]),
            {k: torch.cat([p[2][k] for p in parts]) for k in parts[0][2]})

    def _stage(self, plane: str, rows: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
        """Host rows -> the cache's device: through the plane's pinned
        staging buffer on the card, as a tensor over the rows on the CPU."""
        if self.device.type != "cuda":
            return _to_torch(rows, dtype)
        stage = self._stages.get(plane)
        if stage is None:
            stage = self._stages[plane] = _PinnedStage()
        return stage.to_device(rows, dtype, self.device)

    def _write_state(self, cache, slots: np.ndarray, t_rows: torch.Tensor,
                     s_rows: Dict[str, torch.Tensor]):
        """Overwrite cache slots ``slots`` (unique) with device rows, in
        place: ``scatter_write_rows`` where a row is whole 16-byte words,
        else ``index_put_``; under a mesh each rank writes the slots its
        shard owns (``transfer.scatter_slots_collective``)."""
        tab, cslots = _fields(cache)
        idx = self._idx(slots)
        if self.mesh is not None:
            from swiftsnails_tpu_torch.parallel.transfer import scatter_slots_collective

            write = functools.partial(scatter_slots_collective, self.mesh)
        else:
            write = write_rows
        write(tab, idx, t_rows.contiguous())
        for k, plane in cslots.items():
            write(plane, idx, s_rows[k].contiguous())
        return cache

    def _read_slots(self, plane: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """A new tensor of cache slots ``idx``' rows: :func:`_gather_plane`,
        or under a mesh the owned gather summed over ``model``
        (``transfer.gather_slots_collective``), whole on every rank."""
        if self.mesh is None:
            return _gather_plane(plane, idx)
        from swiftsnails_tpu_torch.parallel.transfer import gather_slots_collective

        return gather_slots_collective(self.mesh, plane, idx)


    # -- write-back ----------------------------------------------------------

    def _flush_slots(self, cache, slots: np.ndarray, *,
                     sync: bool = False) -> None:
        """Device -> host write-back of specific cache slots into the master.

        The snapshot gather is enqueued here, before the slot can be reused:
        later installs into these slots run after it on the same stream, and
        the gather writes a new tensor, so the snapshot survives them
        whenever it is read back. With a flusher attached (and ``sync`` not
        forced), the D2H + master scatter defer to the background worker;
        otherwise they happen inline."""
        tab, cslots = _fields(cache)
        n = int(slots.size)
        idx = self._idx(slots)
        t_dev = self._read_slots(tab, idx)
        s_dev = {k: self._read_slots(v, idx) for k, v in cslots.items()}
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        units = self.unit_of[slots].copy()
        self.dirty[slots] = False
        if self.flusher is not None and not sync:
            if self._pending is None:
                self._pending = np.zeros(self.master.units, np.uint8)
            self._pending[units] = 1
            t0 = time.monotonic_ns()
            self.flusher.put(self, units, n, t_dev, s_dev, event)
            self.stats.flush_wait_ns += time.monotonic_ns() - t0
            return
        self._land_flush([(units, n, t_dev, s_dev, event)])

    def _d2h(self):
        if self._d2h_stream is None and self.device.type == "cuda":
            self._d2h_stream = torch.cuda.Stream(self.device)
        return self._d2h_stream

    def _land_flush(self, chunks: List[Tuple]) -> None:
        """Land flush chunks in the master: D2H the device snapshots,
        scatter once per table (chunk units are disjoint — at most one
        in-flight entry per unit — so the concatenation satisfies
        ``scatter``'s unique-units contract), then bump generations and
        clear the pending marks, in that order: a concurrent stage either
        reads the pre-bump version (discarded at install) or sees the
        post-scatter master."""
        t0 = time.monotonic_ns()
        stream = self._d2h()
        units = np.concatenate([c[0] for c in chunks])
        t_rows = np.concatenate(
            [_to_host_numpy(c[2], c[4], stream)[:c[1]] for c in chunks])
        s_rows = {
            k: np.concatenate(
                [_to_host_numpy(c[3][k], c[4], stream)[:c[1]] for c in chunks])
            for k in chunks[0][3]
        }
        self.master.scatter(units, t_rows, s_rows)
        # bump AFTER the scatter: a staging-thread version read that races the
        # write-back sees the old generation and the install discards its row
        self.master_ver[units] += 1
        if self._pending is not None:
            self._pending[units] = 0
        if self.delta_tap is not None:
            try:
                self.delta_tap(self.name, units)
            except Exception:
                pass  # the freshness tee never blocks the write-back
        self.stats.d2h_bytes += t_rows.nbytes + sum(
            v.nbytes for v in s_rows.values())
        self.stats.flushes += 1
        self.stats.flushed_rows += int(units.size)
        self.stats.flush_ns += time.monotonic_ns() - t0

    def drain(self) -> None:
        """Barrier: wait out every queued async flush (no-op when sync)."""
        if self.flusher is not None:
            t0 = time.monotonic_ns()
            self.flusher.drain()
            self.stats.flush_wait_ns += time.monotonic_ns() - t0

    def flush(self, cache) -> None:
        """Write every dirty slot back to the master. After this the master
        holds the exact resident-table content (the write-back invariant);
        the cache stays mapped, so training continues without refaulting.
        Queued async flushes are drained first, then the remaining dirty
        slots go back synchronously — a barrier, not an enqueue."""
        self.drain()
        if self.transparent:
            # pass-through mode never marks dirty per step (prepare() skips
            # ensure entirely), and the identity-mapped cache in unit order
            # IS the whole table: replace the master planes wholesale (one
            # D2H per plane, digests re-seeded; under a mesh the shards
            # gathered first)
            t0 = time.monotonic_ns()
            self.master.reload(whole_state(self.mesh, cache))
            self.stats.flushes += 1
            self.stats.flushed_rows += self.used
            # what moved D2H is the logical cache plane, not the (possibly
            # narrower) stored master bytes
            self.stats.d2h_bytes += self.master.units * self.master.unit_nbytes
            self.stats.flush_ns += time.monotonic_ns() - t0
            return
        d = np.nonzero(self.dirty)[0]
        if d.size:
            self._flush_slots(cache, d, sync=True)

    def writeback_resident(self, cache) -> int:
        """Write EVERY resident slot back to the master, dirty or not — the
        quarantine-and-rebuild path: after the master plane is reloaded from
        an (older) verified checkpoint, the cache is the authoritative copy
        of everything currently resident, so re-asserting it narrows the
        rollback to units evicted since that checkpoint. Returns the number
        of units written."""
        self.drain()
        r = np.nonzero(self.unit_of >= 0)[0]
        if r.size:
            self._flush_slots(cache, r, sync=True)
        return int(r.size)

    # -- admission seeding ----------------------------------------------------

    def adopt_resident(self, state):
        """Full-coverage adoption: the budget holds every master unit, so
        the trainer's device plane IS the cache — install the identity slot
        map over it and return it unchanged. No zero-fill, no master gather,
        no H2D: the fast twin of ``make_cache`` + a full :meth:`prewarm`,
        and the entry into transparent (pass-through) mode. Under a mesh
        ``state`` is this rank's shard, which is then its shard of the
        cache."""
        if self.budget < self.master.units:
            raise ValueError(
                f"tiered[{self.name}]: adopt_resident needs the budget "
                f"({self.budget}) to cover every master unit "
                f"({self.master.units})")
        n = self.master.units
        self.slot_of[:] = np.arange(n, dtype=np.int64)
        self.unit_of[:n] = np.arange(n, dtype=np.int64)
        self.used = n
        self.ref[:n] = 3
        self.stats.prewarmed_rows += n
        if not self.read_only:
            self.transparent = True
        return state

    def prewarm(self, cache, units: np.ndarray):
        """Fault the given units (hottest-first) before step 0, clean. Takes
        at most ``budget`` units; seeds their CLOCK counters so the zipf head
        outlives the first eviction sweeps."""
        units = np.asarray(units).ravel()
        if units.size == 0:
            return cache
        # stable unique: keep hottest-first order, drop later duplicates
        _, first = np.unique(units, return_index=True)
        units = units[np.sort(first)][: self.budget]
        cache = self.ensure(cache, units, mark_dirty=False)
        self.ref[self.slot_of[units]] = 3  # survive the first sweeps
        self.stats.prewarmed_rows += int(units.size)
        if (not self.read_only and self.used == self.master.units
                and self.budget == self.master.units
                and np.array_equal(self.unit_of,
                                   np.arange(self.budget, dtype=np.int64))):
            # full coverage with the identity slot map: nothing can ever
            # miss, so the tier degrades to a pass-through (see flush())
            self.transparent = True
        return cache
