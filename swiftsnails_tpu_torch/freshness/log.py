"""File-backed delta log: the wire format between trainer and fleet — the
JAX package's ``freshness/log.py``, kept as the port's own copy (it imports
no JAX): both packages write and read the same bytes.

One directory per stream. ``BASE.json`` names the current publisher
incarnation and the checkpoint step it publishes on top of; each batch is
one ``delta-<seq:010d>`` file::

    b"SSD1" | uint32 header_len | header JSON | payload | uint32 CRC32

The CRC covers header + payload, so a torn or bit-flipped batch is
detected at read time (:class:`DeltaCorrupt`) — the subscriber treats it
exactly like a gap. Every write is atomic (tmp + ``os.replace``): a
reader either sees a whole batch or no batch, never a partial one.

The header carries ``seq`` (monotonic, per publisher incarnation),
``publisher`` (a fresh id per open — a changed id IS the restart
signal), ``base_step`` (the checkpoint the stream builds on), ``step``
(the trainer step this batch's rows are current as of — the freshness
watermark), ``ts_ns`` (publish wall clock, for the lag gauge), ``dtype``
(``float32`` or ``int8``), and per-table row counts/dims/offsets into
the payload. Payload values are *absolute* row values (not diffs), so
re-applying a batch is idempotent by construction; ``int8`` payloads add
one f32 scale per row (symmetric ``amax/127``, round-to-nearest — the
same quantizer :func:`~swiftsnails_tpu_torch.tiered.store._np_quant_unit_rows`
uses for a master reload).

Retention: :func:`prune` deletes oldest-first once the directory exceeds
the ``freshness_log_mb`` budget. A subscriber that lagged past retention
sees a real gap and full-reloads — bounded disk beats unbounded replay.
"""

from __future__ import annotations

import json
import os
import tempfile
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

MAGIC = b"SSD1"
BASE_NAME = "BASE.json"
SEG_PREFIX = "delta-"
_ROW_DTYPE = np.dtype("<i8")
_VAL_DTYPES = {"float32": np.dtype("<f4"), "int8": np.dtype("int8")}
_SCALE_DTYPE = np.dtype("<f4")


class DeltaCorrupt(Exception):
    """A delta batch failed its magic/length/CRC check."""


def seg_name(seq: int) -> str:
    return f"{SEG_PREFIX}{int(seq):010d}"


def seg_path(dirpath: str, seq: int) -> str:
    return os.path.join(dirpath, seg_name(seq))


def _atomic_write(path: str, data: bytes) -> None:
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".delta-tmp-")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


# -- base record -------------------------------------------------------------


def write_base(dirpath: str, base: Dict) -> None:
    """Publisher-open record (atomic): a new incarnation rewrites it, and
    the changed ``publisher`` id is how subscribers detect the restart."""
    os.makedirs(dirpath, exist_ok=True)
    _atomic_write(os.path.join(dirpath, BASE_NAME),
                  (json.dumps(base) + "\n").encode("utf-8"))


def read_base(dirpath: str) -> Optional[Dict]:
    try:
        with open(os.path.join(dirpath, BASE_NAME), "r",
                  encoding="utf-8") as f:
            rec = json.load(f)
    except (OSError, ValueError):
        return None
    return rec if isinstance(rec, dict) else None


# -- batch encode/decode -----------------------------------------------------


def write_batch(
    dirpath: str,
    header: Dict,
    tables: Dict[str, Dict[str, np.ndarray]],
) -> str:
    """Write one delta batch; returns the file path.

    ``tables``: name -> ``{"rows": [n] int64, "values": [n, dim]}`` plus
    ``"scales": [n] f32`` when ``header["dtype"] == "int8"``.
    """
    dtype = header.get("dtype", "float32")
    val_dt = _VAL_DTYPES[dtype]
    entries = []
    chunks: List[bytes] = []
    off = 0
    for name in sorted(tables):
        t = tables[name]
        rows = np.ascontiguousarray(np.asarray(t["rows"], _ROW_DTYPE))
        values = np.ascontiguousarray(np.asarray(t["values"], val_dt))
        n = int(rows.size)
        dim = int(values.shape[1]) if values.ndim == 2 else 0
        if values.shape[0] != n:
            raise ValueError(
                f"{name}: {n} rows but {values.shape[0]} value rows")
        entry = {"name": name, "n": n, "dim": dim, "offset": off}
        chunks.append(rows.tobytes())
        chunks.append(values.tobytes())
        off += rows.nbytes + values.nbytes
        if dtype == "int8":
            scales = np.ascontiguousarray(
                np.asarray(t["scales"], _SCALE_DTYPE))
            if scales.size != n:
                raise ValueError(f"{name}: {n} rows but {scales.size} scales")
            chunks.append(scales.tobytes())
            off += scales.nbytes
        entries.append(entry)
    hdr = dict(header)
    hdr["tables"] = entries
    hjson = json.dumps(hdr).encode("utf-8")
    payload = b"".join(chunks)
    crc = zlib.crc32(hjson + payload) & 0xFFFFFFFF
    blob = (MAGIC + np.uint32(len(hjson)).tobytes() + hjson + payload
            + np.uint32(crc).tobytes())
    path = seg_path(dirpath, int(hdr["seq"]))
    _atomic_write(path, blob)
    return path


def read_batch(path: str) -> Tuple[Dict, Dict[str, Dict[str, np.ndarray]]]:
    """Decode one batch file -> ``(header, tables)``; :class:`DeltaCorrupt`
    on any framing or CRC failure (the subscriber's fallback trigger)."""
    try:
        with open(path, "rb") as f:
            blob = f.read()
    except OSError as e:
        raise DeltaCorrupt(f"{path}: unreadable ({e})") from e
    return decode_batch(blob, label=path)


def decode_batch(
    blob: bytes, label: str = "<stream>",
) -> Tuple[Dict, Dict[str, Dict[str, np.ndarray]]]:
    """Decode one batch blob (file contents or a TCP frame payload) ->
    ``(header, tables)``; :class:`DeltaCorrupt` on any framing/CRC failure.
    ``label`` names the source in error messages."""
    if len(blob) < len(MAGIC) + 8 or not blob.startswith(MAGIC):
        raise DeltaCorrupt(f"{label}: bad magic/short file")
    hlen = int(np.frombuffer(blob[4:8], np.uint32)[0])
    body_end = len(blob) - 4
    if 8 + hlen > body_end:
        raise DeltaCorrupt(f"{label}: truncated header")
    stored = int(np.frombuffer(blob[body_end:], np.uint32)[0])
    if (zlib.crc32(blob[8:body_end]) & 0xFFFFFFFF) != stored:
        raise DeltaCorrupt(f"{label}: CRC mismatch")
    try:
        header = json.loads(blob[8 : 8 + hlen].decode("utf-8"))
    except ValueError as e:
        raise DeltaCorrupt(f"{label}: unparseable header") from e
    dtype = header.get("dtype", "float32")
    val_dt = _VAL_DTYPES.get(dtype)
    if val_dt is None:
        raise DeltaCorrupt(f"{label}: unknown dtype {dtype!r}")
    payload = blob[8 + hlen : body_end]
    tables: Dict[str, Dict[str, np.ndarray]] = {}
    for entry in header.get("tables", []):
        n, dim, off = int(entry["n"]), int(entry["dim"]), int(entry["offset"])
        rows_nb = n * _ROW_DTYPE.itemsize
        vals_nb = n * dim * val_dt.itemsize
        need = off + rows_nb + vals_nb + (
            n * _SCALE_DTYPE.itemsize if dtype == "int8" else 0)
        if need > len(payload):
            raise DeltaCorrupt(f"{label}: payload shorter than header claims")
        rows = np.frombuffer(payload, _ROW_DTYPE, count=n, offset=off)
        values = np.frombuffer(
            payload, val_dt, count=n * dim, offset=off + rows_nb,
        ).reshape(n, dim)
        t = {"rows": rows, "values": values}
        if dtype == "int8":
            t["scales"] = np.frombuffer(
                payload, _SCALE_DTYPE, count=n, offset=off + rows_nb + vals_nb)
        tables[entry["name"]] = t
    return header, tables


# -- directory scan / retention ----------------------------------------------


def list_seqs(dirpath: str) -> List[int]:
    """Sorted sequence numbers present (atomic writes: present = whole)."""
    try:
        names = os.listdir(dirpath)
    except OSError:
        return []
    out = []
    for name in names:
        if name.startswith(SEG_PREFIX):
            try:
                out.append(int(name[len(SEG_PREFIX):]))
            except ValueError:
                continue
    out.sort()
    return out


def prune(dirpath: str, max_bytes: int) -> int:
    """Delete oldest batches until the directory fits ``max_bytes`` (the
    newest batch always survives). Returns how many were deleted."""
    seqs = list_seqs(dirpath)
    sizes = {}
    for s in seqs:
        try:
            sizes[s] = os.path.getsize(seg_path(dirpath, s))
        except OSError:
            sizes[s] = 0
    total = sum(sizes.values())
    deleted = 0
    for s in seqs[:-1]:  # never delete the newest
        if total <= max_bytes:
            break
        try:
            os.unlink(seg_path(dirpath, s))
        except OSError:
            continue
        total -= sizes[s]
        deleted += 1
    return deleted
