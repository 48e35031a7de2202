"""ctypes bindings of the native batch producer — the JAX package's ``data/native``.

``libsnails.cpp`` is the port's own copy of the JAX package's source, word
for word, so one seed gives the same vocab, ids, subsampling, skip-gram
pairs, windows and batches in both packages. It is compiled with ``g++`` at
first use into ``swiftsnails_tpu_torch/build/``, under a name that carries a
hash of the source and the flags (as :mod:`swiftsnails_tpu_torch.ops._build`
names the kernels' libraries), and loaded with ``ctypes``: a plain C ABI.

``SSN_NATIVE_SO``, as in the JAX package, names another build to load in
its place (the sanitized builds of ``tools/native_sanitize.sh``): then
nothing is built or hashed, and a missing file is the build's error, naming
the path. The variable is read at each load, so unsetting it gives back the
default build.

There is no quiet fallback. A trainer with ``use_native: 1`` (the default)
calls :func:`require`, which raises with ``g++``'s error when the build
fails; ``use_native: 0`` asks for the numpy producer instead, which yields
other batches than the JAX package's native one for the same seed.

Nothing is built at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

_SRC = Path(__file__).resolve().parent / "libsnails.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

ENV_SO = "SSN_NATIVE_SO"

_lib = None
_lib_lock = threading.Lock()
_build_error: Optional[str] = None
_UNSET = object()
_loaded_for = _UNSET  # the SSN_NATIVE_SO value (None: unset) _lib or _build_error is for


def library_path() -> Path:
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libsnails-{h.hexdigest()[:16]}.so"


def _build(lib: Path) -> Optional[str]:
    """Compile into ``lib`` unless it exists; returns the error or None."""
    if lib.is_file():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f".{lib.name}.{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, "-o", str(tmp), str(_SRC)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"g++ invocation failed: {e}"
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        return f"g++ failed (rc={proc.returncode}):\n{proc.stderr}"
    os.replace(tmp, lib)  # atomic: a concurrent build sees all or none
    return None


def _load():
    global _lib, _build_error, _loaded_for
    want = os.environ.get(ENV_SO) or None
    if _loaded_for == want and (_lib is not None or _build_error is not None):
        return _lib
    with _lib_lock:
        if _loaded_for == want and (_lib is not None or _build_error is not None):
            return _lib
        _lib, _build_error, _loaded_for = None, None, want
        if want is not None:
            path = Path(want)
            if not path.is_file():
                _build_error = f"{ENV_SO} not found: {want}"
                return None
        else:
            path = library_path()
            err = _build(path)
            if err is not None:
                _build_error = err
                return None
        lib = ctypes.CDLL(str(path))
        _bind(lib, ctypes)
        _lib = lib
        return _lib


def _bind(lib, c):
    lib.ssn_murmur64.argtypes = [c.c_void_p, c.c_void_p, c.c_int64]
    lib.ssn_hash_row.argtypes = [c.c_void_p, c.c_int64, c.c_uint64, c.c_void_p]
    lib.ssn_vocab_build.restype = c.c_void_p
    lib.ssn_vocab_build.argtypes = [c.c_char_p, c.c_int, c.c_int]
    lib.ssn_vocab_size.restype = c.c_int64
    lib.ssn_vocab_size.argtypes = [c.c_void_p]
    lib.ssn_vocab_counts.argtypes = [c.c_void_p, c.c_void_p]
    lib.ssn_vocab_word.restype = c.c_int
    lib.ssn_vocab_word.argtypes = [c.c_void_p, c.c_int64, c.c_char_p, c.c_int]
    lib.ssn_vocab_free.argtypes = [c.c_void_p]
    lib.ssn_encode.restype = c.c_int64
    lib.ssn_encode.argtypes = [c.c_void_p, c.c_char_p, c.c_void_p, c.c_int64]
    lib.ssn_skipgram_pairs.restype = c.c_int64
    lib.ssn_skipgram_pairs.argtypes = [
        c.c_void_p, c.c_int64, c.c_int, c.c_uint64, c.c_int,
        c.c_void_p, c.c_void_p, c.c_int64,
    ]
    lib.ssn_skipgram_windows.restype = c.c_int64
    lib.ssn_skipgram_windows.argtypes = [
        c.c_void_p, c.c_int64, c.c_int, c.c_uint64, c.c_int, c.c_void_p,
    ]
    lib.ssn_subsample.restype = c.c_int64
    lib.ssn_subsample.argtypes = [
        c.c_void_p, c.c_int64, c.c_void_p, c.c_int64,
        c.c_double, c.c_double, c.c_uint64, c.c_void_p,
    ]
    lib.ssn_read_ctr.restype = c.c_int64
    lib.ssn_read_ctr.argtypes = [c.c_char_p, c.c_int, c.c_void_p, c.c_void_p, c.c_int64]
    lib.ssn_neg_table_build.restype = c.c_void_p
    lib.ssn_neg_table_build.argtypes = [c.c_void_p, c.c_int64, c.c_int64]
    lib.ssn_neg_table_free.argtypes = [c.c_void_p]
    lib.ssn_sgns_train.restype = c.c_double
    lib.ssn_sgns_train.argtypes = [
        c.c_void_p, c.c_void_p, c.c_int, c.c_void_p, c.c_void_p,
        c.c_int64, c.c_int, c.c_float, c.c_void_p, c.c_uint64,
    ]
    lib.ssn_prefetch_open.restype = c.c_void_p
    lib.ssn_prefetch_open.argtypes = [
        c.c_void_p, c.c_void_p, c.c_int64, c.c_int64, c.c_int, c.c_int, c.c_uint64,
    ]
    lib.ssn_prefetch_next.restype = c.c_int
    lib.ssn_prefetch_next.argtypes = [c.c_void_p, c.c_void_p, c.c_void_p]
    lib.ssn_prefetch_close.argtypes = [c.c_void_p]
    lib.ssn_win_prefetch_open.restype = c.c_void_p
    lib.ssn_win_prefetch_open.argtypes = [
        c.c_void_p, c.c_void_p, c.c_int64, c.c_int, c.c_int64, c.c_int64,
        c.c_int, c.c_int, c.c_int, c.c_uint64,
    ]
    lib.ssn_win_prefetch_next.restype = c.c_int
    lib.ssn_win_prefetch_next.argtypes = [c.c_void_p, c.c_void_p, c.c_void_p]
    lib.ssn_win_prefetch_close.argtypes = [c.c_void_p]
    lib.ssn_vocab_build_stream.restype = c.c_void_p
    lib.ssn_vocab_build_stream.argtypes = [c.c_char_p, c.c_int, c.c_int]
    lib.ssn_stream_open.restype = c.c_void_p
    lib.ssn_stream_open.argtypes = [c.c_void_p, c.c_char_p, c.c_int64, c.c_int64]
    lib.ssn_stream_next.restype = c.c_int64
    lib.ssn_stream_next.argtypes = [c.c_void_p, c.c_void_p, c.c_int64]
    lib.ssn_stream_close.argtypes = [c.c_void_p]
    lib.ssn_ctr_stream_open.restype = c.c_void_p
    lib.ssn_ctr_stream_open.argtypes = [c.c_char_p, c.c_int, c.c_int64, c.c_int64]
    lib.ssn_ctr_stream_next.restype = c.c_int64
    lib.ssn_ctr_stream_next.argtypes = [c.c_void_p, c.c_void_p, c.c_void_p, c.c_int64]
    lib.ssn_ctr_stream_close.argtypes = [c.c_void_p]
    lib.ssn_tier_remap.restype = c.c_int64
    lib.ssn_tier_remap.argtypes = [
        c.c_void_p, c.c_void_p, c.c_int64, c.c_int64, c.c_void_p,
    ]
    lib.ssn_tier_clock_sweep.restype = c.c_int64
    lib.ssn_tier_clock_sweep.argtypes = [
        c.c_void_p, c.c_void_p, c.c_int64, c.c_int64, c.c_int64, c.c_void_p,
    ]


def available() -> bool:
    """Whether the library is built (building it now if needed)."""
    return _load() is not None


def build_error() -> Optional[str]:
    _load()
    return _build_error


def require():
    """The loaded library; raises ``RuntimeError`` with ``g++``'s error and
    the ``use_native: 0`` escape when it cannot be built."""
    lib = _load()
    if lib is None:
        raise RuntimeError(
            f"the native batch producer did not build: {_build_error}\n"
            "set use_native: 0 for the numpy producer (other batches than the "
            "JAX package's native ones for the same seed)")
    return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def murmur64(x: np.ndarray) -> np.ndarray:
    """The murmur fmix64 finalizer of each uint64 (``ops.hashing.murmur_fmix64_np``)."""
    lib = require()
    x = np.ascontiguousarray(x, dtype=np.uint64)
    out = np.empty_like(x)
    lib.ssn_murmur64(_ptr(x), _ptr(out), x.size)
    return out


def hash_row(keys: np.ndarray, capacity: int) -> np.ndarray:
    """Key -> table row, ``fmix64(key) % capacity`` (``ops.hashing.hash_row_np``)."""
    lib = require()
    keys = np.ascontiguousarray(keys, dtype=np.uint32)
    out = np.empty(keys.size, dtype=np.int64)
    lib.ssn_hash_row(_ptr(keys), keys.size, capacity, _ptr(out))
    return out


class NativeVocab:
    """The C++ vocab build: frequency descending, then lexicographic,
    ``min_count`` filtered, truncated to ``max_size`` — the order of
    :meth:`~swiftsnails_tpu_torch.data.vocab.Vocab.from_counter`.

    ``stream=True`` (default) reads through a fixed buffer: memory O(vocab)
    whatever the corpus size.
    """

    def __init__(self, path: str, min_count: int = 5, max_size: int = 0,
                 stream: bool = True):
        lib = require()
        self._lib = lib
        build = lib.ssn_vocab_build_stream if stream else lib.ssn_vocab_build
        self._h = build(path.encode(), min_count, max_size)
        if not self._h:
            raise OSError(f"cannot read {path}")

    def __len__(self) -> int:
        return int(self._lib.ssn_vocab_size(self._h))

    def counts(self) -> np.ndarray:
        out = np.empty(len(self), dtype=np.int64)
        self._lib.ssn_vocab_counts(self._h, _ptr(out))
        return out

    def words(self) -> List[str]:
        buf = ctypes.create_string_buffer(65536)
        out = []
        for i in range(len(self)):
            n = self._lib.ssn_vocab_word(self._h, i, buf, len(buf))
            if n < 0:
                raise ValueError(f"word {i} too long")
            out.append(buf.value.decode("utf-8", "replace"))
        return out

    def encode_file(self, path: str) -> np.ndarray:
        """The whole file's kept ids. The buffer is sized from the counts
        (exact for the vocab's own file); a longer file makes
        ``ssn_encode`` return its true count negated, and the call is made
        again at that size."""
        guess = int(self.counts().sum()) if len(self) else 0
        out = np.empty(max(guess, 1), dtype=np.int32)
        got = self._lib.ssn_encode(self._h, path.encode(), _ptr(out), out.size)
        if got == -1:
            # -1 is an IO error: an overflow returns -(total), and a 1-token
            # corpus always fits the buffer of at least 1
            raise OSError(f"cannot read {path}")
        if got < 0:
            out = np.empty(-got, dtype=np.int32)
            got = self._lib.ssn_encode(self._h, path.encode(), _ptr(out), out.size)
            if got < 0:
                raise RuntimeError("corpus changed size during encode")
        return out[:got]

    def encode_stream(self, path: str, chunk_tokens: int,
                      byte_start: int = 0, byte_end: int = 0):
        """Yield encoded int32 chunks of ``chunk_tokens`` ids (the last
        shorter; OOV dropped), in bounded memory. A nonzero ``(byte_start,
        byte_end)`` reads that span: a token belongs to the span its first
        byte falls in."""
        lib = self._lib
        h = lib.ssn_stream_open(self._h, path.encode(), byte_start, byte_end)
        if not h:
            raise OSError(f"cannot read {path}")
        try:
            while True:
                out = np.empty(chunk_tokens, dtype=np.int32)
                got = lib.ssn_stream_next(h, _ptr(out), chunk_tokens)
                if got <= 0:
                    return
                yield out[:got]
        finally:
            lib.ssn_stream_close(h)

    def to_python(self):
        from swiftsnails_tpu_torch.data.vocab import Vocab

        return Vocab(self.words(), self.counts())

    def close(self):
        if self._h:
            self._lib.ssn_vocab_free(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def skipgram_pairs(ids: np.ndarray, window: int, seed: int = 0,
                   dynamic: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """Flat skip-gram pairs ``(centers, contexts)``, word2vec.c's dynamic
    window drawn from ``seed``."""
    lib = require()
    ids = np.ascontiguousarray(ids, dtype=np.int32)
    n = lib.ssn_skipgram_pairs(_ptr(ids), ids.size, window, seed, int(dynamic),
                               None, None, 0)
    centers = np.empty(n, dtype=np.int32)
    contexts = np.empty(n, dtype=np.int32)
    got = lib.ssn_skipgram_pairs(_ptr(ids), ids.size, window, seed, int(dynamic),
                                 _ptr(centers), _ptr(contexts), n)
    if got != n:
        raise RuntimeError(f"skipgram_pairs wrote {got} pairs, sized {n}")
    return centers, contexts


def skipgram_windows(ids: np.ndarray, window: int, seed: int = 0,
                     dynamic: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """The window schema (``centers`` [n], ``contexts`` [n, 2w], -1 pads):
    the same draws as :func:`skipgram_pairs` for one seed, so the two give
    the same pair set."""
    lib = require()
    ids = np.ascontiguousarray(ids, dtype=np.int32)
    ctxs = np.empty((ids.size, 2 * window), dtype=np.int32)
    got = lib.ssn_skipgram_windows(_ptr(ids), ids.size, window, seed, int(dynamic),
                                   _ptr(ctxs))
    if got != ids.size:
        raise RuntimeError(f"skipgram_windows wrote {got} windows of {ids.size}")
    return ids.copy(), ctxs


def subsample(ids: np.ndarray, counts: np.ndarray, threshold: float,
              seed: int = 0) -> np.ndarray:
    """word2vec.c's frequent-word subsampling, drawn from ``seed``."""
    lib = require()
    ids = np.ascontiguousarray(ids, dtype=np.int32)
    counts = np.ascontiguousarray(counts, dtype=np.int64)
    out = np.empty(ids.size, dtype=np.int32)
    k = lib.ssn_subsample(_ptr(ids), ids.size, _ptr(counts), counts.size,
                          float(counts.sum()), threshold, seed, _ptr(out))
    return out[:k]


def read_ctr(path: str, num_fields: int) -> Tuple[np.ndarray, np.ndarray]:
    """``(labels f32[n], feats i32[n, num_fields])`` of a CTR file, the
    records of :func:`~swiftsnails_tpu_torch.data.ctr.read_ctr_file`."""
    lib = require()
    n = lib.ssn_read_ctr(path.encode(), num_fields, None, None, 0)
    if n < 0:
        raise OSError(f"cannot read {path}")
    labels = np.empty(n, dtype=np.float32)
    feats = np.empty((n, num_fields), dtype=np.int32)
    got = lib.ssn_read_ctr(path.encode(), num_fields, _ptr(labels), _ptr(feats), n)
    if got < 0:
        raise RuntimeError("file changed size during read")
    return labels[:got], feats[:got]


def read_ctr_stream(path: str, num_fields: int, rows_per_chunk: int = 1 << 20,
                    byte_start: int = 0, byte_end: int = 0):
    """Yield ``(labels, feats)`` chunks of ``rows_per_chunk`` records in
    bounded memory; a nonzero byte span reads that shard (a line belongs to
    the span its first byte falls in)."""
    lib = require()
    h = lib.ssn_ctr_stream_open(path.encode(), num_fields, byte_start, byte_end)
    if not h:
        raise OSError(f"cannot read {path}")
    try:
        while True:
            labels = np.empty(rows_per_chunk, dtype=np.float32)
            feats = np.empty((rows_per_chunk, num_fields), dtype=np.int32)
            got = lib.ssn_ctr_stream_next(h, _ptr(labels), _ptr(feats), rows_per_chunk)
            if got <= 0:
                return
            yield labels[:got], feats[:got]
    finally:
        lib.ssn_ctr_stream_close(h)


def sgns_train(syn0: np.ndarray, syn1: np.ndarray, centers: np.ndarray,
               contexts: np.ndarray, counts: np.ndarray, negatives: int = 5,
               lr: float = 0.025, table_size: int = 1 << 22, seed: int = 0) -> float:
    """The compiled single-node SGNS loop, on ``syn0`` / ``syn1`` in place;
    returns the loop's seconds (the negative table's build excluded). The C
    loop trusts its pointers, so every bound is checked here first."""
    lib = require()
    for name, a in (("syn0", syn0), ("syn1", syn1)):
        if a.dtype != np.float32 or not a.flags.c_contiguous or a.ndim != 2:
            raise ValueError(f"{name} must be a C-contiguous float32 matrix")
    if syn0.shape[1] != syn1.shape[1]:
        raise ValueError(f"dim mismatch: {syn0.shape} vs {syn1.shape}")
    centers = np.ascontiguousarray(centers, dtype=np.int32)
    contexts = np.ascontiguousarray(contexts, dtype=np.int32)
    counts = np.ascontiguousarray(counts, dtype=np.int64)
    if centers.shape != contexts.shape:
        raise ValueError("centers/contexts length mismatch")
    if centers.size and (centers.min() < 0 or centers.max() >= syn0.shape[0]):
        raise ValueError("center id out of range for syn0")
    if contexts.size and (contexts.min() < 0 or contexts.max() >= syn1.shape[0]):
        raise ValueError("context id out of range for syn1")
    if counts.size > syn1.shape[0]:  # negatives index syn1 rows [0, counts.size)
        raise ValueError("counts longer than syn1 rows")
    table = lib.ssn_neg_table_build(_ptr(counts), counts.size, table_size)
    if not table:
        raise ValueError("empty vocab for negative table")
    try:
        return float(lib.ssn_sgns_train(
            _ptr(syn0), _ptr(syn1), syn0.shape[1], _ptr(centers), _ptr(contexts),
            centers.size, negatives, lr, table, seed))
    finally:
        lib.ssn_neg_table_free(table)


class PairPrefetcher:
    """Shuffled flat batches ``{"centers", "contexts"}`` from a C++ producer
    thread behind a bounded queue (``queue_with_capacity`` parity); the
    sequence is fixed by ``seed``. :meth:`close` stops the producer, also
    one blocked on a full queue."""

    def __init__(self, centers: np.ndarray, contexts: np.ndarray, batch_size: int,
                 epochs: int = 1, capacity: int = 8, seed: int = 0):
        lib = require()
        self._lib = lib
        self.batch_size = batch_size
        c = np.ascontiguousarray(centers, dtype=np.int32)
        x = np.ascontiguousarray(contexts, dtype=np.int32)
        self._h = lib.ssn_prefetch_open(_ptr(c), _ptr(x), c.size, batch_size, epochs,
                                        capacity, seed)
        if not self._h:
            raise ValueError("bad prefetcher arguments (empty data or batch > n)")

    def __iter__(self):
        while self._h:  # after close() the iteration ends
            centers = np.empty(self.batch_size, dtype=np.int32)
            contexts = np.empty(self.batch_size, dtype=np.int32)
            if not self._lib.ssn_prefetch_next(self._h, _ptr(centers), _ptr(contexts)):
                return
            yield {"centers": centers, "contexts": contexts}

    def close(self):
        if self._h:
            self._lib.ssn_prefetch_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class WindowPrefetcher:
    """Window batches ``{"centers" [B], "contexts" [B, cw]}`` from C++
    worker threads that shuffle blocks of ``block`` consecutive windows
    (``block=1``: single windows), behind an order-preserving ticket ring:
    the sequence is fixed by ``seed`` and ``epochs`` whatever the worker
    count. The producer borrows ``centers`` and ``contexts`` (kept alive
    here); they must not change while it runs."""

    def __init__(self, centers: np.ndarray, contexts: np.ndarray, batch_size: int,
                 block: int = 1, epochs: int = 1, capacity: int = 8, workers: int = 0,
                 seed: int = 0):
        lib = require()
        self._lib = lib
        self.batch_size = batch_size
        self._c = np.ascontiguousarray(centers, dtype=np.int32)
        self._x = np.ascontiguousarray(contexts, dtype=np.int32)
        if self._x.ndim != 2 or self._x.shape[0] != self._c.size:
            raise ValueError(f"contexts must be [n, cw], got {self._x.shape}")
        self.cw = self._x.shape[1]
        self._h = lib.ssn_win_prefetch_open(
            _ptr(self._c), _ptr(self._x), self._c.size, self.cw, batch_size,
            block, epochs, capacity, workers, seed)
        if not self._h:
            raise ValueError("bad window-prefetcher arguments (empty data, batch > n, "
                             "or batch not a multiple of block)")

    def __iter__(self):
        while self._h:  # after close() the iteration ends
            centers = np.empty(self.batch_size, dtype=np.int32)
            contexts = np.empty((self.batch_size, self.cw), dtype=np.int32)
            if not self._lib.ssn_win_prefetch_next(self._h, _ptr(centers), _ptr(contexts)):
                return
            yield {"centers": centers, "contexts": contexts}

    def close(self):
        if self._h:
            self._lib.ssn_win_prefetch_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


# ------------------------------------------------------------------ tiered ---


def tier_remap(slot_of: np.ndarray, rows: np.ndarray,
               group: int = 1) -> Tuple[np.ndarray, int]:
    """Master row ids -> cache slot ids (the tiered store's remap, unit =
    ``row // group``, lane kept). Returns ``(slots, n_nonresident)``."""
    lib = require()
    slot_of = np.ascontiguousarray(slot_of, dtype=np.int64)
    rows = np.ascontiguousarray(rows, dtype=np.int32)
    out = np.empty(rows.size, dtype=np.int32)
    bad = lib.ssn_tier_remap(_ptr(slot_of), _ptr(rows), rows.size, int(group), _ptr(out))
    return out, int(bad)


def tier_clock_sweep(ref: np.ndarray, pinned: np.ndarray, hand: int,
                     n: int) -> Tuple[np.ndarray, int]:
    """CLOCK victim selection of ``n`` slots: ages ``ref`` and pins the
    victims in place (``ref`` writable contiguous uint8, ``pinned`` bool or
    uint8 of the same length, ``n`` unpinned slots guaranteed by the
    caller). Returns ``(victim_slots, new_hand)``."""
    lib = require()
    pin8 = pinned.view(np.uint8)
    if not (ref.dtype == np.uint8 and ref.flags.c_contiguous and ref.flags.writeable
            and pin8.flags.c_contiguous and pin8.flags.writeable
            and ref.size == pin8.size):
        raise ValueError("ref and pinned must be writable contiguous byte arrays "
                         "of one length")
    out = np.empty(max(int(n), 0), dtype=np.int64)
    new_hand = lib.ssn_tier_clock_sweep(_ptr(ref), _ptr(pin8), ref.size, int(hand),
                                        int(n), _ptr(out))
    return out, int(new_hand)
