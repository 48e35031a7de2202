"""Corpus reading and encoding (the JAX package's ``data/text.py``, Python path).

Host-side whitespace tokenization — the role of the reference's
``TextBuffer``/``LineFileReader`` (``src/utils/Buffer.h:240-324``). The JAX
package can hand this to its C++ pipeline (``data/native``), which gives the
same ids; that pipeline is not ported yet (``ROADMAP.md``), so the port always
takes this path.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from swiftsnails_tpu_torch.data.vocab import Vocab


def read_tokens(path: str, limit_bytes: Optional[int] = None) -> List[str]:
    """Whitespace-tokenize a corpus file (text8-style: one giant line is fine).

    Splits at the *byte* level on ASCII whitespace, then decodes each token
    (errors='replace'), as the JAX package's tokenizers do.
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
) -> Tuple[np.ndarray, Vocab]:
    """Read, build (or reuse) a vocab, and encode to an int32 id stream."""
    tokens = read_tokens(path, limit_bytes=limit_bytes)
    if vocab is None:
        vocab = Vocab.build(tokens, min_count=min_count, max_size=max_vocab)
    ids = vocab.encode(tokens)
    return ids, vocab
