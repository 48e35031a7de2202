"""Length-prefixed stream frames over the SSD1 codec (docs/NETWORK.md) — the
JAX package's ``net/wire.py``, kept as the port's own copy: both packages
encode the same frames byte for byte.

One frame, the same byte discipline as a delta batch on disk
(``freshness/log.py`` — one codec for file and wire)::

    b"SSD1" | uint32 header_len | header JSON | payload | uint32 CRC32

The CRC covers header JSON + payload. The only stream-specific addition is
``header["payload_len"]`` — a file's payload length is implied by file
size; a stream must be told it up front so a reader can budget the read
*before* touching the payload.

Hardening contract (drilled by ``tests/test_torch_net.py``):

* oversize length prefixes are rejected BEFORE any allocation — a hostile
  or corrupt 4-byte prefix can never balloon memory;
* truncation anywhere (header, payload, CRC) raises a typed
  :class:`FrameTruncated`, never hangs and never returns a partial frame;
* a CRC mismatch or bad magic raises :class:`FrameError`;
* :func:`read_frame` consumes a ``recv(n)``-shaped callable and loops over
  arbitrary partial reads, so frames survive any ``recv`` boundary.

Typed arrays ride in the payload via :func:`pack_arrays` /
:func:`unpack_arrays` — the header carries an index of dtype/shape/offset
entries, bounds-checked against ``payload_len`` before slicing.
"""

from __future__ import annotations

import json
import zlib
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from swiftsnails_tpu_torch.freshness.log import MAGIC

# Pre-allocation caps: a length prefix beyond these is rejected before any
# buffer is sized from it. Generous enough for a full delta batch or a
# batched pull reply; far below anything that could hurt a host.
MAX_HEADER_BYTES = 1 << 20  # 1 MiB of header JSON
MAX_PAYLOAD_BYTES = 1 << 28  # 256 MiB of payload

_PREFIX_LEN = len(MAGIC) + 4  # magic + uint32 header_len
_CRC_LEN = 4


class FrameError(Exception):
    """A frame failed its magic/length/CRC/shape check (typed; the server
    loop and the reconnecting client both survive it)."""


class FrameTruncated(FrameError):
    """The stream ended (or the blob ran out) mid-frame."""


class FrameTooLarge(FrameError):
    """A length prefix exceeded the pre-allocation cap — rejected before
    any buffer was sized from it."""


def encode_frame(header: Dict, payload: bytes = b"") -> bytes:
    """One wire frame. ``header`` is JSON-serializable; ``payload_len`` is
    stamped in automatically (the stream reader's read budget)."""
    hdr = dict(header)
    hdr["payload_len"] = len(payload)
    hjson = json.dumps(hdr).encode("utf-8")
    if len(hjson) > MAX_HEADER_BYTES:
        raise FrameTooLarge(
            f"header JSON {len(hjson)} bytes exceeds cap {MAX_HEADER_BYTES}")
    if len(payload) > MAX_PAYLOAD_BYTES:
        raise FrameTooLarge(
            f"payload {len(payload)} bytes exceeds cap {MAX_PAYLOAD_BYTES}")
    crc = zlib.crc32(hjson + payload) & 0xFFFFFFFF
    return (MAGIC + np.uint32(len(hjson)).tobytes() + hjson + payload
            + np.uint32(crc).tobytes())


def decode_frame(blob: bytes) -> Tuple[Dict, bytes]:
    """Decode one complete frame blob -> ``(header, payload)``."""

    view = memoryview(blob)
    pos = [0]

    def _take(n: int) -> bytes:
        chunk = bytes(view[pos[0]: pos[0] + n])
        pos[0] += len(chunk)
        return chunk

    return read_frame(_take)


def read_frame(
    recv: Callable[[int], bytes],
    *,
    max_header: int = MAX_HEADER_BYTES,
    max_payload: int = MAX_PAYLOAD_BYTES,
) -> Tuple[Dict, bytes]:
    """Incrementally read one frame from ``recv(n)`` (returns <= n bytes;
    empty = EOF) -> ``(header, payload)``.

    Reads exactly one frame's bytes and no more. Every length is validated
    against its cap before the corresponding buffer is read, and every
    partial-read boundary is handled by looping — a frame split into 1-byte
    chunks decodes identically to one arriving whole.
    """
    prefix = _read_exact(recv, _PREFIX_LEN, "frame prefix")
    if prefix[: len(MAGIC)] != MAGIC:
        raise FrameError(f"bad magic {prefix[:len(MAGIC)]!r}")
    hlen = int(np.frombuffer(prefix[len(MAGIC):], np.uint32)[0])
    if hlen > max_header:
        raise FrameTooLarge(
            f"header length prefix {hlen} exceeds cap {max_header}")
    hjson = _read_exact(recv, hlen, "frame header")
    try:
        header = json.loads(hjson.decode("utf-8"))
    except ValueError as e:
        raise FrameError(f"unparseable frame header: {e}") from e
    if not isinstance(header, dict):
        raise FrameError(f"frame header is {type(header).__name__}, not dict")
    try:
        plen = int(header["payload_len"])
    except (KeyError, TypeError, ValueError) as e:
        raise FrameError(f"frame header missing payload_len: {e}") from e
    if plen < 0 or plen > max_payload:
        raise FrameTooLarge(
            f"payload length {plen} outside [0, {max_payload}]")
    payload = _read_exact(recv, plen, "frame payload")
    stored = int(np.frombuffer(
        _read_exact(recv, _CRC_LEN, "frame CRC"), np.uint32)[0])
    if (zlib.crc32(hjson + payload) & 0xFFFFFFFF) != stored:
        raise FrameError("frame CRC mismatch")
    return header, payload


def _read_exact(recv: Callable[[int], bytes], n: int, what: str) -> bytes:
    """Loop ``recv`` until exactly ``n`` bytes arrive; :class:`FrameTruncated`
    on EOF mid-read. The chunks list keeps per-read allocation bounded by
    what the peer actually sent."""
    if n == 0:
        return b""
    chunks: List[bytes] = []
    got = 0
    while got < n:
        chunk = recv(n - got)
        if not chunk:
            raise FrameTruncated(f"{what}: stream ended {got}/{n} bytes in")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def sock_recv(sock) -> Callable[[int], bytes]:
    """Adapt a socket to :func:`read_frame`'s ``recv(n)`` shape. Socket
    timeouts surface as ``socket.timeout`` (an ``OSError`` — the retry
    policy's native food); a closed peer surfaces as EOF."""

    def _recv(n: int) -> bytes:
        return sock.recv(min(n, 1 << 16))

    return _recv


# -- typed arrays in the payload ---------------------------------------------


def pack_arrays(
    arrays: Dict[str, np.ndarray],
) -> Tuple[List[Dict], bytes]:
    """``{name: ndarray}`` -> (header index, payload bytes). Order is
    name-sorted so identical inputs produce identical bytes."""
    index: List[Dict] = []
    chunks: List[bytes] = []
    off = 0
    for name in sorted(arrays):
        a = np.ascontiguousarray(arrays[name])
        index.append({
            "name": name,
            "dtype": a.dtype.str,
            "shape": list(a.shape),
            "offset": off,
        })
        chunks.append(a.tobytes())
        off += a.nbytes
    return index, b"".join(chunks)


def unpack_arrays(index: List[Dict], payload: bytes) -> Dict[str, np.ndarray]:
    """Invert :func:`pack_arrays`; every slice is bounds-checked against the
    payload before :func:`np.frombuffer` touches it."""
    out: Dict[str, np.ndarray] = {}
    for entry in index or []:
        try:
            name = entry["name"]
            dt = np.dtype(entry["dtype"])
            shape = tuple(int(s) for s in entry["shape"])
            off = int(entry["offset"])
        except (KeyError, TypeError, ValueError) as e:
            raise FrameError(f"bad array index entry {entry!r}: {e}") from e
        count = 1
        for s in shape:
            if s < 0:
                raise FrameError(f"{name}: negative dim in shape {shape}")
            count *= s
        nbytes = count * dt.itemsize
        if off < 0 or off + nbytes > len(payload):
            raise FrameError(
                f"{name}: claims [{off}, {off + nbytes}) of a "
                f"{len(payload)}-byte payload")
        out[name] = np.frombuffer(
            payload, dt, count=count, offset=off).reshape(shape)
    return out
