"""Sparse CTR-style record parsing and batching — the JAX package's ``data/ctr.py``.

The port keeps its own copy (the JAX module imports no JAX, but the port
imports nothing of the JAX package); the numpy calls are the same, so one
seed gives the same records and batches in both packages.

The reference's app layer parsed records worker-side via
``BaseAlgorithm::parse_record(line)`` (``src/core/framework/SwiftWorker.h:19-57``).
This module is the equivalent for the CTR model families (LR, Wide&Deep,
FM/FFM — the BASELINE.json Criteo/Avazu configs):

* record format: ``label f0 f1 ... f{F-1}`` — one categorical feature id per
  field (Criteo/Avazu shape). ``field:value`` tokens are accepted and the
  field index is taken from position; missing fields pad with ``-1``;
* batches are fixed-shape ``{"labels": f32[B], "feats": i32[B, F]}`` with
  ``-1`` padding (masked out in the models);
* feature ids are *global* (already field-offset or hashed upstream); models
  apply the hashing trick (``hash_row``) for table placement.
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

PAD = -1
_INT_PREFIX = re.compile(r"[+-]?\d+")


def parse_record(line: str, num_fields: int) -> Optional[Tuple[float, np.ndarray]]:
    """``label f0 f1 ...`` -> (label, i32[num_fields] with PAD fill).

    Malformed-input semantics match the native parser (``ssn_read_ctr``):
    a non-numeric label (e.g. a header line) skips the whole row (returns
    None); a non-numeric feature token stops feature parsing for that row,
    leaving the remaining fields PAD. Same file, same rows, either path.
    """
    parts = line.split()
    if not parts:
        return None
    try:
        label = float(parts[0])
    except ValueError:
        return None  # header/garbage row — skipped, like strtod failure
    feats = np.full(num_fields, PAD, dtype=np.int32)
    for i, tok in enumerate(parts[1 : num_fields + 1]):
        if ":" in tok:  # "field:id" or "id:value" — take the id portion
            tok = tok.split(":", 1)[1]
        m = _INT_PREFIX.match(tok)
        if not m:
            break  # stop at first bad token, like strtol failure
        feats[i] = int(m.group(0))
        if len(m.group(0)) != len(tok):
            break  # trailing junk halts the row, like strtol leaving a cursor
    return label, feats


def read_ctr_file(path: str, num_fields: int) -> Tuple[np.ndarray, np.ndarray]:
    labels: List[float] = []
    rows: List[np.ndarray] = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            rec = parse_record(line, num_fields)
            if rec is None:
                continue
            labels.append(rec[0])
            rows.append(rec[1])
    return (
        np.asarray(labels, dtype=np.float32),
        np.stack(rows) if rows else np.empty((0, num_fields), np.int32),
    )


def read_ctr_stream(
    path: str,
    num_fields: int,
    rows_per_chunk: int = 1 << 20,
    byte_start: int = 0,
    byte_end: int = 0,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield (labels, feats) chunks of <= rows_per_chunk records — pure-Python
    twin of the native streaming reader (bounded memory; Hadoop line-split
    semantics for a nonzero byte span: a line belongs to the span its first
    byte falls in)."""
    labels: List[float] = []
    rows: List[np.ndarray] = []

    def flush():
        out = (
            np.asarray(labels, dtype=np.float32),
            np.stack(rows) if rows else np.empty((0, num_fields), np.int32),
        )
        labels.clear()
        rows.clear()
        return out

    with open(path, "rb") as f:
        if byte_start > 0:
            f.seek(byte_start - 1)
            if f.read(1) != b"\n":
                f.readline()  # partial first line: previous shard's
        pos = f.tell()
        while True:
            if byte_end > 0 and pos >= byte_end:
                break
            line = f.readline()
            if not line:
                break
            pos += len(line)
            rec = parse_record(line.decode("utf-8", "replace"), num_fields)
            if rec is None:
                continue
            labels.append(rec[0])
            rows.append(rec[1])
            if len(labels) >= rows_per_chunk:
                yield flush()
    if labels:
        yield flush()


def read_ctr(path: str, num_fields: int,
             use_native: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """The whole file's records: the native reader with ``use_native`` (it
    raises if it does not build), else :func:`read_ctr_file`; the same rows
    either way."""
    if use_native:
        from swiftsnails_tpu_torch.data import native

        return native.read_ctr(path, num_fields)
    return read_ctr_file(path, num_fields)


def iter_ctr_chunks(path: str, num_fields: int, rows_per_chunk: int = 1 << 20,
                    byte_start: int = 0, byte_end: int = 0,
                    use_native: bool = True) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """``stream: 1``'s chunks: the native streaming reader with
    ``use_native``, else :func:`read_ctr_stream`; the same chunks either
    way."""
    if use_native:
        from swiftsnails_tpu_torch.data import native

        return native.read_ctr_stream(path, num_fields, rows_per_chunk,
                                      byte_start, byte_end)
    return read_ctr_stream(path, num_fields, rows_per_chunk, byte_start, byte_end)


def ctr_batches(
    labels: np.ndarray,
    feats: np.ndarray,
    batch_size: int,
    rng: np.random.Generator,
    shuffle: bool = True,
    epochs: int = 1,
) -> Iterator[Dict[str, np.ndarray]]:
    n = len(labels)
    usable = (n // batch_size) * batch_size
    for _ in range(epochs):
        order = rng.permutation(n) if shuffle else np.arange(n)
        for start in range(0, usable, batch_size):
            sel = order[start : start + batch_size]
            yield {"labels": labels[sel], "feats": feats[sel]}


def synth_ctr(
    n: int,
    num_fields: int,
    vocab_per_field: int,
    seed: int = 0,
    noise: float = 0.25,
    interaction: bool = False,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Synthetic CTR data with planted weights (and optional pairwise
    interactions, for FM tests). Returns (labels, feats, true_weights).

    Feature ids are field-offset: field i draws from
    ``[i*vocab_per_field, (i+1)*vocab_per_field)``.
    """
    rng = np.random.default_rng(seed)
    total_vocab = num_fields * vocab_per_field
    w = rng.normal(0, 1.0, size=total_vocab).astype(np.float32)
    feats = np.stack(
        [
            rng.integers(0, vocab_per_field, size=n) + i * vocab_per_field
            for i in range(num_fields)
        ],
        axis=1,
    ).astype(np.int32)
    logits = w[feats].sum(axis=1)
    if interaction:
        v = rng.normal(0, 0.5, size=(total_vocab, 4)).astype(np.float32)
        emb = v[feats]  # [n, F, 4]
        s = emb.sum(axis=1)
        inter = 0.5 * ((s**2).sum(-1) - (emb**2).sum(axis=(1, 2)))
        logits = logits + inter
    logits = logits + rng.normal(0, noise, size=n)
    labels = (rng.random(n) < 1.0 / (1.0 + np.exp(-logits))).astype(np.float32)
    return labels, feats, w
