"""Corpus reading and encoding — the JAX package's ``data/text.py``.

Host-side whitespace tokenization — the role of the reference's
``TextBuffer``/``LineFileReader``/``scan_file_by_line``
(``src/utils/Buffer.h:240-324``, ``file.h:11-33``). With ``use_native`` the
vocab build and the encode run in the native producer
(:mod:`swiftsnails_tpu_torch.data.native`), which gives the same vocab and
ids as the Python path here (tested), as in the JAX package.
:func:`encode_corpus_stream` is ``stream: 1``'s bounded-memory ingestion.
"""

from __future__ import annotations

import os
from typing import Iterator, List, Optional, Tuple

import numpy as np

from swiftsnails_tpu_torch.data.vocab import Vocab


def read_tokens(path: str, limit_bytes: Optional[int] = None) -> List[str]:
    """Whitespace-tokenize a corpus file (text8-style: one giant line is fine).

    Splits at the *byte* level on ASCII whitespace, then decodes each token
    (errors='replace'), as the native tokenizer does.
    """
    with open(path, "rb") as f:
        data = f.read(limit_bytes) if limit_bytes else f.read()
    return [t.decode("utf-8", "replace") for t in data.split()]


def encode_corpus(
    path: str,
    min_count: int = 5,
    max_vocab: Optional[int] = None,
    limit_bytes: Optional[int] = None,
    vocab: Optional[Vocab] = None,
    use_native: bool = True,
) -> Tuple[np.ndarray, Vocab]:
    """Read, build (or reuse) a vocab, and encode to an int32 id stream.

    ``use_native`` builds the vocab and encodes in one native pass where no
    byte limit or given vocab asks for the Python path; the two give the
    same ids. A native producer that does not build raises
    (:func:`~swiftsnails_tpu_torch.data.native.require`).
    """
    from swiftsnails_tpu_torch.data import native

    if use_native and vocab is None and limit_bytes is None:
        native.require()
        nv = native.NativeVocab(path, min_count=min_count, max_size=max_vocab or 0)
        ids = nv.encode_file(path)
        py_vocab = nv.to_python()
        nv.close()
        return ids, py_vocab
    tokens = read_tokens(path, limit_bytes=limit_bytes)
    if vocab is None:
        vocab = Vocab.build(tokens, min_count=min_count, max_size=max_vocab)
    ids = vocab.encode(tokens)
    return ids, vocab


def byte_span(path: str, process_index: int = 0, process_count: int = 1) -> Tuple[int, int]:
    """This process's contiguous ``[start, end)`` byte span of a corpus file
    (the JAX package's ``parallel/cluster.py`` rule): ``(0, 0)``, the whole
    file, for one process; else an even split, the last span to the end, and
    an empty ``[size, size)`` span for a process beyond the file's bytes. The
    stream readers move each boundary to a token's or a line's first byte.
    The port runs one process; the split waits for its multi-process plane."""
    if process_count <= 1:
        return 0, 0
    size = os.path.getsize(path)
    per = max(size // process_count, 1)
    start = min(process_index * per, size)
    end = size if process_index == process_count - 1 else min(start + per, size)
    return start, end


_SPACE = b" \t\n\r\v\f"  # the native tokenizer's is_space set


def iter_encoded_chunks(
    path: str,
    vocab: Vocab,
    chunk_tokens: int,
    byte_start: int = 0,
    byte_end: int = 0,
    buf_size: int = 1 << 20,
) -> Iterator[np.ndarray]:
    """Stream the corpus as encoded int32 chunks of <= chunk_tokens ids.

    Bounded-memory ingestion (``scan_file_by_line`` parity,
    ``src/utils/file.h:11-33``): RSS is O(read buffer + chunk) regardless of
    file size; the token straddling a read-buffer edge is carried. A nonzero
    ``(byte_start, byte_end)`` span applies Hadoop split semantics — a token
    belongs to the span its FIRST byte falls in (the token straddling
    ``byte_start`` is the previous shard's; one starting before ``byte_end``
    is read to completion). Pure-Python twin of the native
    ``NativeVocab.encode_stream`` (identical id stream, tested).
    """
    index = vocab.index
    chunk: List[int] = []

    def emit(tok: bytes):
        i = index.get(tok.decode("utf-8", "replace"))
        if i is not None:
            chunk.append(i)

    with open(path, "rb") as f:
        skipping = False
        if byte_start > 0:
            f.seek(byte_start - 1)
            prev = f.read(1)
            skipping = bool(prev) and prev[0] not in _SPACE
        abs_base = byte_start
        carry = b""
        stop = False
        while not stop:
            block = f.read(buf_size)
            if not block:
                break
            pos, n = 0, len(block)
            while pos < n:
                if block[pos] in _SPACE:
                    skipping = False
                    if carry:
                        emit(carry)
                        carry = b""
                        if len(chunk) >= chunk_tokens:
                            yield np.asarray(chunk[:chunk_tokens], dtype=np.int32)
                            chunk = chunk[chunk_tokens:]
                    pos += 1
                    continue
                start = pos
                while pos < n and block[pos] not in _SPACE:
                    pos += 1
                if skipping:
                    continue  # discarding the pre-byte_start partial token
                if carry:
                    carry += block[start:pos]
                    if pos < n:
                        emit(carry)
                        carry = b""
                else:
                    if byte_end > 0 and abs_base + start >= byte_end:
                        stop = True
                        break
                    if pos < n:
                        emit(block[start:pos])
                    else:
                        carry = block[start:pos]
                if len(chunk) >= chunk_tokens:
                    yield np.asarray(chunk[:chunk_tokens], dtype=np.int32)
                    chunk = chunk[chunk_tokens:]
            abs_base += n
        if carry and not skipping:
            emit(carry)
    while chunk:
        yield np.asarray(chunk[:chunk_tokens], dtype=np.int32)
        chunk = chunk[chunk_tokens:]


def encode_corpus_stream(
    path: str,
    chunk_tokens: int,
    min_count: int = 5,
    max_vocab: Optional[int] = None,
    use_native: bool = True,
    byte_start: int = 0,
    byte_end: int = 0,
) -> Tuple[Vocab, "object"]:
    """(vocab, chunk_factory) for bounded-memory training.

    The vocab build streams the WHOLE file once (O(vocab) memory — the vocab
    must be global so ids and row placement agree across hosts); the
    returned zero-arg factory opens a fresh encoded-chunk iterator over
    ``[byte_start, byte_end)`` (0,0 = whole file) — call it once per epoch.
    Global total tokens for lr-decay progress = ``vocab.counts.sum()``.
    """
    from swiftsnails_tpu_torch.data import native

    if use_native:
        native.require()
        nv = native.NativeVocab(path, min_count=min_count, max_size=max_vocab or 0)
        py_vocab = nv.to_python()

        def factory():
            return nv.encode_stream(path, chunk_tokens, byte_start, byte_end)

        return py_vocab, factory
    # the Python path: one streaming pass to count, then stream-encode
    from collections import Counter

    counter: Counter = Counter()
    buf_size = 1 << 20
    carry = b""
    with open(path, "rb") as f:
        while True:
            block = f.read(buf_size)
            if not block:
                break
            block = carry + block
            if block[-1:].isspace():
                carry = b""
                parts = block.split()
            else:
                parts = block.split()
                carry = parts.pop() if parts else b""
            counter.update(t.decode("utf-8", "replace") for t in parts)
    if carry:
        counter.update([carry.decode("utf-8", "replace")])
    vocab = Vocab.from_counter(counter, min_count=min_count, max_size=max_vocab)

    def factory():
        return iter_encoded_chunks(path, vocab, chunk_tokens, byte_start, byte_end)

    return vocab, factory


def iter_line_records(path: str, process_index: int = 0, process_count: int = 1) -> Iterator[str]:
    """Line records, round-robin sharded by process.

    Replaces the reference's Hadoop-Streaming data split (each worker's stdin
    was its split: ``src/tools/run_worker.sh`` ``cat > ./data.txt``) with
    deterministic sharding by process index.
    """
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        for i, line in enumerate(f):
            if i % process_count == process_index:
                yield line.rstrip("\n")
