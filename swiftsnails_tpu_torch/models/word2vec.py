"""Word2Vec skip-gram with negative sampling — the JAX package's ``models/word2vec.py``.

The flagship trainer of the parameter server: workers pull embedding rows
for the words of their batch, compute SGNS gradients with respect to the
pulled rows, and push them back to the tables (SURVEY §3.3).

The port runs the ``packed+pool`` path of the JAX trainer on one device:

* two packed ``[capacity, S, 128]`` tables (input ``syn0``, output
  ``syn1neg``) held in :class:`~swiftsnails_tpu_torch.parallel.store.PackedTableState`;
* each substep pulls the centers' rows and the contexts' plus a shared pool
  of negatives' rows with the row-gather kernel, computes the pooled SGNS
  loss and its gradient with ``torch.autograd``, and pushes merged
  gradients back with the row scatter-add kernel (SGD, in place: the JAX
  package donated the table buffers here);
* every ``pool_block`` consecutive pairs share ``pool_size`` negatives drawn
  from the unigram^0.75 alias table; the negative term is weighted by
  ``negatives / pool_size`` so the expected gradient matches ``negatives``
  independent draws.

Batches come from the numpy pipeline, the same code as the JAX package's
when its C++ batch producer (``data/native``) is unavailable: the port does
not have that producer yet, so ``use_native`` is read and has no effect.

Config keys: ``dim``, ``window``, ``negatives``, ``learning_rate``,
``lr_decay``, ``num_iters``, ``batch_size``, ``min_count``, ``max_vocab``,
``subsample``, ``hash_keys``, ``capacity``, ``chunk_tokens``, ``seed``,
``data``, ``table_dtype``, ``pool_size``, ``pool_block``, ``steps_per_call``.
Keys that select a path the port does not have yet raise
``NotImplementedError`` (see :data:`UNPORTED`); ``ROADMAP.md`` says when
each is ported.
"""

from __future__ import annotations

from typing import Dict, Iterator, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from swiftsnails_tpu_torch.data.sampler import (
    alias_sample,
    batch_stream,
    build_unigram_alias,
    skipgram_pairs,
    subsample_mask,
)
from swiftsnails_tpu_torch.data.text import encode_corpus
from swiftsnails_tpu_torch.data.vocab import Vocab
from swiftsnails_tpu_torch.framework.trainer import Trainer, _unported
from swiftsnails_tpu_torch.models.registry import register_model
from swiftsnails_tpu_torch.ops.hashing import hash_row
from swiftsnails_tpu_torch.ops.rowdma import unpack_rows
from swiftsnails_tpu_torch.parallel.access import SgdAccess
from swiftsnails_tpu_torch.parallel.store import (
    PackedTableState,
    create_packed_table,
    pull_packed,
    push_packed,
)
from swiftsnails_tpu_torch.utils.config import Config
from swiftsnails_tpu_torch.utils.device import DeviceLike

_TABLE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class W2VState(NamedTuple):
    in_table: PackedTableState  # syn0: center-word embeddings
    out_table: PackedTableState  # syn1neg: context/negative embeddings


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def _truthy(cfg: Config, key: str) -> bool:
    return cfg.get_bool(key, False)


# Keys of the JAX trainer that select a path the port does not have yet:
# key -> "is it asked for". Each raises NotImplementedError when asked for.
UNPORTED = {
    "packed": lambda cfg, key: not cfg.get_bool(key, True),
    "neg_mode": lambda cfg, key: cfg.get_str(key, "pool") != "pool",
    "fused": _truthy,
    "grouped": _truthy,
    "resident": _truthy,
    "dedup": _truthy,
    "stream": _truthy,
    "table_tier": lambda cfg, key: cfg.get_str(key, "device") != "device",
    "comm_dtype": lambda cfg, key: cfg.get_str(key, "float32") not in (
        "float32", "f32", "fp32"),
    "placement": lambda cfg, key: cfg.get_str(key, "uniform") != "uniform",
    "push_mode": lambda cfg, key: cfg.get_str(key, "gather") != "gather",
    "overlap": lambda cfg, key: cfg.get_str(key, "0").strip().lower() not in (
        "0", "false", "no", "off", ""),
}


def sgns_pool_loss(v: torch.Tensor, u_pos: torch.Tensor, pool: torch.Tensor,
                   lam: float) -> torch.Tensor:
    """Pooled SGNS loss over packed rows, in float32.

    ``v``, ``u_pos``: ``[B, S, 128]`` center and context rows; ``pool``:
    ``[NB, PN, S, 128]`` negatives shared by each block of ``B / NB``
    consecutive pairs. Returns the mean over pairs of
    ``-log σ(v·u_pos) - lam · Σ_q log σ(-v·pool_q)``.
    """
    nb, pn = pool.shape[:2]
    b = v.shape[0]
    pos = torch.einsum("bsl,bsl->b", v, u_pos)
    vb = v.reshape(nb, b // nb, -1)
    neg = torch.bmm(vb, pool.reshape(nb, pn, -1).transpose(1, 2))  # [NB, PB, PN]
    return -(F.logsigmoid(pos).mean()
             + lam * F.logsigmoid(-neg).sum(dim=-1).mean())


@register_model("word2vec")
class Word2VecTrainer(Trainer):
    name = "word2vec"

    def __init__(
        self,
        config: Config,
        mesh=None,
        corpus_ids: Optional[np.ndarray] = None,
        vocab: Optional[Vocab] = None,
        device: DeviceLike = None,
    ):
        """``device=None`` means the card; ``device="cpu"`` runs the kernels'
        plain versions. ``mesh`` exists for the JAX call's shape and must be
        ``None``: the port runs on one device."""
        super().__init__(config, device)
        cfg = config
        if mesh is not None:
            _unported("mesh", mesh)
        for key, asked in UNPORTED.items():
            if key in cfg and asked(cfg, key):
                _unported(key, cfg.get_str(key))
        self.dim = cfg.get_int("dim", 100)
        self.window = cfg.get_int("window", 5)
        self.negatives = cfg.get_int("negatives", 5)
        self.lr = cfg.get_float("learning_rate", 0.025)
        # word2vec.c convention: alpha decays linearly over the run (words
        # consumed / total words), floored at 1e-4 x the start rate
        self.lr_decay = cfg.get_bool("lr_decay", False)
        self.epochs = cfg.get_int("num_iters", 1)
        self.batch_size = cfg.get_int("batch_size", 1024)
        self.subsample = cfg.get_float("subsample", 1e-4)
        self.hash_keys = cfg.get_bool("hash_keys", False)
        self.chunk_tokens = cfg.get_int("chunk_tokens", 1 << 20)
        self.seed = cfg.get_int("seed", 0)
        self.table_dtype = _TABLE_DTYPES[cfg.get_str("table_dtype", "float32")]
        self.pool_size = cfg.get_int("pool_size", 64)
        self.pool_block = cfg.get_int("pool_block", 512)
        # substeps per train_step call; TrainLoop counts calls, so substeps
        # scale throughput, not the step counter
        self.steps_per_call = max(cfg.get_int("steps_per_call", 1), 1)
        if corpus_ids is None:
            # one process: the JAX package's shard_token_stream is the
            # identity here, so shard_data has nothing to do
            corpus_ids, vocab = encode_corpus(
                cfg.get_str("data"),
                min_count=cfg.get_int("min_count", 5),
                max_vocab=cfg.get_int("max_vocab", 0) or None,
            )
        if vocab is None:
            raise ValueError("vocab required when corpus_ids is given")
        self.corpus_ids = np.asarray(corpus_ids, dtype=np.int32)
        self.vocab = vocab
        cap = cfg.get_int("capacity", 0) or _next_pow2(max(len(vocab), 2))
        self.capacity = cap
        if not self.hash_keys and len(vocab) > cap:
            raise ValueError(
                f"vocab {len(vocab)} exceeds capacity {cap}; set hash_keys: 1")
        self.access = SgdAccess()
        self.neg_alias = build_unigram_alias(vocab.counts, self.device)

    # -- state -------------------------------------------------------------

    def init_state(self) -> W2VState:
        in_table = create_packed_table(
            self.capacity, self.dim, self.access, dtype=self.table_dtype,
            seed=self.seed, device=self.device)
        # reference word2vec inits syn1neg to zeros; init_scale=0 keeps that
        out_table = create_packed_table(
            self.capacity, self.dim, self.access, dtype=self.table_dtype,
            seed=self.seed + 1, init_scale=0.0, device=self.device)
        return W2VState(in_table=in_table, out_table=out_table)

    def _rows(self, keys: torch.Tensor) -> torch.Tensor:
        if self.hash_keys:
            return hash_row(keys, self.capacity)
        return keys

    # -- data --------------------------------------------------------------

    def batches(self) -> Iterator[Dict[str, np.ndarray]]:
        """Host batches ``{"centers", "contexts", "progress"}``, numpy.

        The JAX package's numpy path, line for line, so one seed gives the
        same batches in both packages. ``progress`` is the fraction of the
        corpus consumed (raw tokens x epochs), which drives ``lr_decay``.
        """
        rng = np.random.default_rng(self.seed)
        counts = self.vocab.counts
        ids = self.corpus_ids
        local_total = max(len(ids), 1)
        total_tokens = max(self.epochs * local_total, 1)
        macro = self.batch_size * self.steps_per_call
        for epoch in range(self.epochs):
            consumed = 0  # tokens before this chunk
            for start in range(0, len(ids), self.chunk_tokens):
                chunk = ids[start : start + self.chunk_tokens]
                chunk_base = epoch * local_total + consumed
                chunk_len = len(chunk)
                consumed += chunk_len
                if self.subsample > 0:
                    chunk = chunk[subsample_mask(chunk, counts, self.subsample, rng)]
                centers, contexts = skipgram_pairs(chunk, self.window, rng)
                n_batches = max(len(centers) // macro, 1)
                for bi, b in enumerate(batch_stream(centers, contexts, macro, rng)):
                    p = (chunk_base + (bi / n_batches) * chunk_len) / total_tokens
                    yield {**b, "progress": np.float32(min(p, 1.0))}

    # -- step --------------------------------------------------------------

    def pool_geometry(self, b: int) -> Tuple[int, int]:
        """``(pairs per pool block, pool blocks)`` for a substep of ``b``
        pairs: the block is the largest divisor of ``b`` not above
        ``pool_block``."""
        pb = min(self.pool_block, b)
        while b % pb:
            pb -= 1
        return pb, b // pb

    def _substep_packed(self, state: W2VState, centers: torch.Tensor,
                        contexts: torch.Tensor, generator: torch.Generator,
                        lr: float, negs: Optional[torch.Tensor] = None):
        """One substep: pull, pooled SGNS loss and gradient, push.

        ``negs`` (``[NB, PN]`` word ids) replaces the pool drawn from
        ``generator``; tests inject the same pools into both packages.
        Updates both tables in place and returns ``(state, loss)``. The loss
        and its gradient are computed in float32 from the pulled rows
        whatever the table dtype; the pushed deltas are rounded once to it.
        """
        b = centers.shape[0]
        _, nb = self.pool_geometry(b)
        pn = self.pool_size
        lam = self.negatives / pn
        pools = alias_sample(self.neg_alias, generator, (nb, pn)) if negs is None else negs
        in_rows = self._rows(centers)
        out_rows = self._rows(torch.cat([contexts, pools.reshape(-1)]))

        v = pull_packed(state.in_table, in_rows).float().requires_grad_()
        u = pull_packed(state.out_table, out_rows).float()
        u_pos = u[:b].requires_grad_()
        pool = u[b:].reshape(nb, pn, *u.shape[1:]).requires_grad_()
        loss = sgns_pool_loss(v, u_pos, pool, lam)
        dv, du_pos, dpool = torch.autograd.grad(loss, (v, u_pos, pool))
        du = torch.cat([du_pos, dpool.reshape(-1, *dpool.shape[2:])])
        push_packed(state.in_table, in_rows, dv, self.access, lr)
        push_packed(state.out_table, out_rows, du, self.access, lr)
        return state, loss.detach()

    def step_lr(self, batch: Dict) -> float:
        """The call's learning rate, in float32 as the JAX step computes it:
        ``lr * max(1 - progress, 1e-4)`` under ``lr_decay``, else ``lr``."""
        if self.lr_decay and "progress" in batch:
            decay = np.maximum(np.float32(1.0) - np.float32(batch["progress"]),
                               np.float32(1e-4))
            return float(np.float32(self.lr) * decay)
        return self.lr

    def train_step(self, state: W2VState, batch: Dict, generator: torch.Generator):
        """One call = ``steps_per_call`` substeps over slices of the batch.

        The JAX package scans the substeps under one dispatch; here they run
        as a Python loop, each drawing its pool from ``generator``. Returns
        ``(state, {"loss": mean substep loss})``, the loss as a device
        tensor (no host sync).
        """
        centers, contexts = batch["centers"], batch["contexts"]
        n = centers.shape[0]
        t = max(n // self.batch_size, 1)
        b = n // t
        lr = self.step_lr(batch)
        losses = []
        for i in range(t):
            sl = slice(i * b, (i + 1) * b)
            state, loss = self._substep_packed(
                state, centers[sl], contexts[sl], generator, lr)
            losses.append(loss)
        return state, {"loss": torch.stack(losses).mean()}

    # -- export (ServerTerminate parity: text dump of the table) -----------

    def _all_vocab_rows(self, state: W2VState) -> np.ndarray:
        ids = self._rows(torch.arange(len(self.vocab), dtype=torch.int32,
                                      device=state.in_table.table.device))
        vals = unpack_rows(state.in_table.table.index_select(0, ids), self.dim)
        return vals.float().cpu().numpy()

    def export_text(self, state: W2VState, path: str) -> None:
        rows = self._all_vocab_rows(state)
        with open(path, "w", encoding="utf-8") as f:
            f.write(f"{len(self.vocab)} {self.dim}\n")
            for i, word in enumerate(self.vocab.words):
                vec = " ".join(f"{x:.6f}" for x in rows[i])
                f.write(f"{word} {vec}\n")

    # -- eval: nearest neighbors for sanity checks --------------------------

    def neighbors(self, state: W2VState, word: str, topn: int = 10):
        emb = self._all_vocab_rows(state)
        norms = np.linalg.norm(emb, axis=1, keepdims=True) + 1e-9
        emb = emb / norms
        q = emb[self.vocab.index[word]]
        sims = emb @ q
        order = np.argsort(-sims)
        return [(self.vocab.words[i], float(sims[i])) for i in order[1 : topn + 1]]
