"""Evaluate an exported embedding file: neighbors, similarity, analogies —
the JAX package's ``tools/eval_embeddings.py``, over the port.

Works on the word2vec text format both packages export (``<vocab> <dim>``
header then ``word v0 v1 ...`` lines), so either package's output can be
inspected::

    python -m swiftsnails_tpu_torch.tools.eval_embeddings vec.txt --neighbors king --topn 10
    python -m swiftsnails_tpu_torch.tools.eval_embeddings vec.txt --sim cat dog
    python -m swiftsnails_tpu_torch.tools.eval_embeddings vec.txt --analogy king man woman

Ranking runs through the serving top-k scan
(:func:`swiftsnails_tpu_torch.serving.kernels.topk_tiled`, the tiled scan a
``serve`` replica answers ``topk`` with, ties by id ascending as in the JAX
kernel), on the card unless ``--device cpu`` asks for the CPU; without a
card and without ``--device cpu`` it fails. Vectors are pre-normalized, so
the scan ranks by the same cosine a NumPy ``argsort(-vecs @ q)`` would.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from swiftsnails_tpu_torch.utils.device import resolve_device


def load_embeddings(path):
    """``(words, index, vecs)``: the words in file order, word -> row, and
    the rows L2-normalized (the norm floored at 1e-9), float32."""
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        header = f.readline().split()
        n, dim = int(header[0]), int(header[1])
        words, vecs = [], np.empty((n, dim), dtype=np.float32)
        for i, line in enumerate(f):
            parts = line.rstrip("\n").split(" ")
            words.append(parts[0])
            vecs[i] = np.asarray(parts[1 : dim + 1], dtype=np.float32)
    norms = np.linalg.norm(vecs, axis=1, keepdims=True)
    vecs /= np.maximum(norms, 1e-9)
    return words, {w: i for i, w in enumerate(words)}, vecs


def nearest(vecs, q, topn, exclude=(), device=None):
    """Top-``topn`` rows by cosine, via the serving scan; over-fetches by
    ``len(exclude)`` so filtering can't come up short."""
    from swiftsnails_tpu_torch.serving.kernels import topk_tiled

    dev = resolve_device(device)
    k = min(topn + len(exclude), len(vecs))
    scores, ids = topk_tiled(
        torch.from_numpy(np.ascontiguousarray(vecs)).to(dev),
        torch.as_tensor(np.asarray(q, np.float32)[None, :], device=dev), k=k)
    out = []
    for i, s in zip(ids[0].cpu().numpy(), scores[0].cpu().numpy()):
        if int(i) in exclude or int(i) < 0:
            continue
        out.append((int(i), float(s)))
        if len(out) >= topn:
            break
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("path")
    p.add_argument("--neighbors", metavar="WORD")
    p.add_argument("--sim", nargs=2, metavar=("W1", "W2"))
    p.add_argument("--analogy", nargs=3, metavar=("A", "B", "C"),
                   help="a : b :: c : ?  (b - a + c)")
    p.add_argument("--topn", type=int, default=10)
    p.add_argument("--device", default=None,
                   help="cpu, or the card (the default: cuda)")
    args = p.parse_args(argv)

    words, index, vecs = load_embeddings(args.path)
    if args.neighbors:
        i = index[args.neighbors]
        for j, s in nearest(vecs, vecs[i], args.topn, exclude={i}, device=args.device):
            print(f"{words[j]}\t{s:.4f}")
    elif args.sim:
        a, b = (index[w] for w in args.sim)
        print(f"{float(vecs[a] @ vecs[b]):.4f}")
    elif args.analogy:
        a, b, c = (index[w] for w in args.analogy)
        q = vecs[b] - vecs[a] + vecs[c]
        q /= max(np.linalg.norm(q), 1e-9)
        for j, s in nearest(vecs, q, args.topn, exclude={a, b, c}, device=args.device):
            print(f"{words[j]}\t{s:.4f}")
    else:
        print(f"{len(words)} words, dim {vecs.shape[1]}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
