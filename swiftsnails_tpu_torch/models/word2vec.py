"""Word2Vec skip-gram with negative sampling — the JAX package's ``models/word2vec.py``.

The flagship trainer of the parameter server: workers pull embedding rows
for the words of their batch, compute SGNS gradients with respect to the
pulled rows, and push them back to the tables (SURVEY §3.3).

The port runs the single-device paths of the JAX trainer. ``packed: 0``
(``dense``, the reference-faithful rung) keeps two ``[capacity, dim]``
tables on the 2-D plane (:class:`~swiftsnails_tpu_torch.parallel.store.TableState`)
and trains with ``negatives`` independent draws a pair: pull by
``index_select``, the SGNS loss and its gradient with ``torch.autograd``,
push by a deterministic scatter-add. The default, ``packed+pool``:

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
  independent draws. ``neg_mode: per_pair`` draws those independently
  instead, on the same packed tables and row kernels.

``fused: 1`` (``fused-hogwild``) replaces the pull, the autograd step and
the push with one fused kernel a substep
(:mod:`swiftsnails_tpu_torch.ops.fused_sgns`), whose
blocks of ``pool_block`` pairs race as hogwild SGD workers do. ``fused: 1,
grouped: 1`` (``fused-grouped``) switches the batches to the window schema
(``centers`` [N], ``contexts`` [N, 2 * window], ``-1`` pads) and runs the
center-major fused kernel over blocks of ``centers_per_block`` centers.
On top of ``grouped: 1``, ``resident: 1`` (``fused-resident``) merges the
updates of the head rows (ids below ``hot_rows``), ``dedup: 1``
(``fused-dedup``) those of each block's first ``u_cap`` distinct context
rows and switches the batches to shuffled blocks of consecutive windows, and
both together (``fused-dedup-res``, ``examples/word2vec_fast.conf``) compose
the two; a substep's kernel blocks then run in order. As in the JAX
package, ``fused`` takes effect only with packed tables and pooled
negatives.

Batches come from the native producer (:mod:`swiftsnails_tpu_torch.data.native`)
with ``use_native: 1``, the default, as in the JAX package: the same seed
gives the JAX trainer's batches. ``use_native: 0`` takes the numpy path, the
JAX package's path where its producer is not built. ``stream: 1`` reads the
corpus in chunks and never holds it whole.

Config keys: ``dim``, ``window``, ``negatives``, ``learning_rate``,
``lr_decay``, ``num_iters``, ``batch_size``, ``min_count``, ``max_vocab``,
``subsample``, ``hash_keys``, ``capacity``, ``chunk_tokens``, ``seed``,
``data``, ``table_dtype``, ``pool_size``, ``pool_block``, ``steps_per_call``,
``fused``, ``grouped``, ``centers_per_block``, ``resident``, ``hot_rows``,
``dedup``, ``u_cap``, ``packed``, ``neg_mode``, ``use_native``, ``stream``.
Keys that select a path the port does not have yet raise
``NotImplementedError`` (see :data:`UNPORTED`); ``ROADMAP.md`` says when
each is ported.
"""

from __future__ import annotations

import logging
from typing import Dict, Iterator, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from swiftsnails_tpu_torch.data.sampler import (
    alias_sample,
    batch_stream,
    batch_stream_blocks,
    build_unigram_alias,
    skipgram_pairs,
    skipgram_windows,
    subsample_mask,
)
from swiftsnails_tpu_torch.data import native
from swiftsnails_tpu_torch.data.text import byte_span, encode_corpus, encode_corpus_stream
from swiftsnails_tpu_torch.data.vocab import Vocab
from swiftsnails_tpu_torch.framework.trainer import (
    UNPORTED_PLANE_KEYS,
    Trainer,
    _unported,
    raise_unported,
)
from swiftsnails_tpu_torch.models.registry import register_model
from swiftsnails_tpu_torch.ops.fused_sgns import (
    effective_hot_rows,
    fused_sgns_dedup_resident_step,
    fused_sgns_dedup_step,
    fused_sgns_grouped_step,
    fused_sgns_resident_step,
    fused_sgns_step,
)
from swiftsnails_tpu_torch.ops.hashing import hash_row
from swiftsnails_tpu_torch.ops.rowdma import unpack_rows
from swiftsnails_tpu_torch.parallel.access import SgdAccess
from swiftsnails_tpu_torch.parallel.store import (
    PackedTableState,
    TableState,
    create_packed_table,
    create_table,
    pull,
    pull_packed,
    push,
    push_packed,
)
from swiftsnails_tpu_torch.utils.config import Config
from swiftsnails_tpu_torch.utils.device import DeviceLike

_TABLE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class W2VState(NamedTuple):
    # PackedTableState, or TableState with packed: 0
    in_table: PackedTableState  # syn0: center-word embeddings
    out_table: PackedTableState  # syn1neg: context/negative embeddings


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


# Keys of the JAX trainer that select a path the port does not have yet:
# key -> "is it asked for". Each raises NotImplementedError when asked for.
UNPORTED = {
    **UNPORTED_PLANE_KEYS,
    "push_mode": lambda cfg, key: cfg.get_str(key, "gather") != "gather",
    "overlap": lambda cfg, key: cfg.get_str(key, "0").strip().lower() not in (
        "0", "false", "no", "off", ""),
}


def sgns_loss(v: torch.Tensor, u_pos: torch.Tensor, u_neg: torch.Tensor) -> torch.Tensor:
    """Skip-gram negative-sampling loss in float32: ``v``, ``u_pos``
    ``[B, D]`` center and context rows, ``u_neg`` ``[B, K, D]`` negatives.
    Returns the mean over pairs of ``-log σ(v·u_pos) - Σ_k log σ(-v·u_neg_k)``."""
    pos = torch.einsum("bd,bd->b", v, u_pos)
    neg = torch.bmm(u_neg, v.unsqueeze(-1)).squeeze(-1)  # [B, K]
    return -(F.logsigmoid(pos) + F.logsigmoid(-neg).sum(dim=-1)).mean()


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
        raise_unported(cfg, UNPORTED)
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
        # packed: 0 -> the 2-D plane; neg_mode: per_pair -> K independent
        # negatives a pair (the dense path always trains per pair)
        self.packed = cfg.get_bool("packed", True)
        self.neg_mode = cfg.get_str("neg_mode", "pool" if self.packed else "per_pair")
        if self.neg_mode == "pool" and not self.packed:
            raise ValueError("neg_mode: pool requires packed tables (packed: 1)")
        # fused: 1 -> one hogwild kernel a substep, on packed+pool tables
        # only (elsewhere the key has no effect, as in the JAX package);
        # grouped: 1 -> its center-major form over the window schema
        self.fused = (cfg.get_bool("fused", False) and self.packed
                      and self.neg_mode == "pool")
        self.grouped = cfg.get_bool("grouped", False) and self.fused
        if cfg.get_bool("grouped", False) and not cfg.get_bool("fused", False):
            raise ValueError("grouped: 1 requires fused: 1")
        # resident: 1 -> the head rows (ids < hot_rows, frequency-ranked by
        # the vocabulary) get merged updates; dedup: 1 -> so do each kernel
        # block's first u_cap distinct context rows, over block-ordered
        # batches. Both compose (fused_sgns_dedup_resident_step).
        for key in ("resident", "dedup"):
            if cfg.get_bool(key, False) and not cfg.get_bool("grouped", False):
                raise ValueError(f"{key}: 1 requires grouped: 1")
        self.resident = cfg.get_bool("resident", False) and self.grouped
        self.dedup = cfg.get_bool("dedup", False) and self.grouped
        self.hot_rows = cfg.get_int("hot_rows", 1024)
        self.u_cap = cfg.get_int("u_cap", 512)
        # centers per kernel block; the per-substep center count is batch_size
        self.centers_per_block = cfg.get_int("centers_per_block", 256)
        # use_native: 1 -> the native batch producer, which must build (no
        # quiet fallback to batches that differ from the JAX package's)
        self.use_native = cfg.get_bool("use_native", True)
        if self.use_native:
            native.require()
        self.producer = "native" if self.use_native else "python"
        # stream: 1 -> bounded-memory ingestion: the corpus is never held
        # whole; batches() opens a chunk stream each epoch
        self.stream = cfg.get_bool("stream", False)
        self._chunk_factory = None
        self._local_total = None  # local tokens an epoch (progress denominator)
        if corpus_ids is None:
            # one process: its byte span is the whole file and the JAX
            # package's shard_token_stream the identity, so shard_data
            # changes nothing
            data_path = cfg.get_str("data")
            kw = {"min_count": cfg.get_int("min_count", 5),
                  "max_vocab": cfg.get_int("max_vocab", 0) or None,
                  "use_native": self.use_native}
            if self.stream:
                start, end = byte_span(data_path)
                vocab, self._chunk_factory = encode_corpus_stream(
                    data_path, self.chunk_tokens, byte_start=start, byte_end=end, **kw)
                self._local_total = max(int(vocab.counts.sum()), 1)
            else:
                corpus_ids, vocab = encode_corpus(data_path, **kw)
        if vocab is None:
            raise ValueError("vocab required when corpus_ids is given")
        if corpus_ids is not None:
            self.corpus_ids = np.asarray(corpus_ids, dtype=np.int32)
            self._local_total = len(self.corpus_ids)
        else:
            self.corpus_ids = None
        self.vocab = vocab
        cap = cfg.get_int("capacity", 0) or _next_pow2(max(len(vocab), 2))
        self.capacity = cap
        if not self.hash_keys and len(vocab) > cap:
            raise ValueError(
                f"vocab {len(vocab)} exceeds capacity {cap}; set hash_keys: 1")
        self.access = SgdAccess()
        self.neg_alias = build_unigram_alias(vocab.counts, self.device)
        if self.resident:
            # say what runs: hot_rows clips to capacity and rounds down, and
            # fewer than 8 rows fall back to the kernel without a head
            eff, _ = effective_hot_rows(self.hot_rows, self.capacity)
            log = logging.getLogger(__name__)
            if eff < 8:
                log.warning(
                    "resident: 1 with hot_rows=%d (capacity %d) leaves <8 "
                    "resident rows; falling back to the grouped kernel",
                    self.hot_rows, self.capacity)
            elif eff != self.hot_rows:
                log.info(
                    "resident hot_rows=%d rounds to %d effective resident "
                    "rows (clipped to capacity, rounded down to a multiple of "
                    "256, or of 8 below 256)", self.hot_rows, eff)
        self.grouped_step = self._grouped_step_fn() if self.grouped else None

    # -- state -------------------------------------------------------------

    def init_state(self) -> W2VState:
        make = create_packed_table if self.packed else create_table
        in_table = make(
            self.capacity, self.dim, self.access, dtype=self.table_dtype,
            seed=self.seed, device=self.device)
        # reference word2vec inits syn1neg to zeros; init_scale=0 keeps that
        out_table = make(
            self.capacity, self.dim, self.access, dtype=self.table_dtype,
            seed=self.seed + 1, init_scale=0.0, device=self.device)
        return W2VState(in_table=in_table, out_table=out_table)

    def _rows(self, keys: torch.Tensor) -> torch.Tensor:
        if self.hash_keys:
            return hash_row(keys, self.capacity)
        return keys

    # -- data --------------------------------------------------------------

    def _epoch_chunks(self) -> Iterator[np.ndarray]:
        """One epoch's token chunks: slices of the corpus, or with
        ``stream: 1`` a chunk stream opened anew."""
        if self.corpus_ids is not None:
            ids = self.corpus_ids
            for start in range(0, len(ids), self.chunk_tokens):
                yield ids[start : start + self.chunk_tokens]
        else:
            yield from self._chunk_factory()

    def batches(self) -> Iterator[Dict[str, np.ndarray]]:
        """Host batches ``{"centers", "contexts", "progress"}``, numpy.

        The JAX package's ``batches``, line for line, so one seed gives the
        same batches in both packages: with ``use_native`` each chunk's
        subsampling, pairs or windows and its shuffled batches come from the
        native producer, seeded per chunk; else from numpy with one
        generator. ``progress`` is the fraction of the corpus consumed (raw
        tokens x epochs; in stream mode over the vocab's token count), which
        drives ``lr_decay``. With ``grouped: 1`` a batch row is one corpus
        position and its window (``contexts`` [N, 2 * window], ``-1``
        pads), and whole windows shuffle together; with ``dedup: 1`` blocks
        of ``_effective_pc()`` consecutive windows do.
        """
        use_native = self.use_native
        rng = np.random.default_rng(self.seed)
        counts = self.vocab.counts
        local_total = max(self._local_total or 1, 1)
        total_tokens = max(self.epochs * local_total, 1)
        macro = self.batch_size * self.steps_per_call
        for epoch in range(self.epochs):
            consumed = 0  # tokens before this chunk
            for chunk in self._epoch_chunks():
                seed = (self.seed * 1_000_003 + epoch * 7919 + consumed) & 0xFFFFFFFF
                chunk_base = epoch * local_total + consumed
                chunk_len = len(chunk)
                consumed += chunk_len
                if use_native:
                    if self.subsample > 0:
                        chunk = native.subsample(chunk, counts, self.subsample, seed=seed)
                elif self.subsample > 0:
                    chunk = chunk[subsample_mask(chunk, counts, self.subsample, rng)]
                if self.grouped:
                    if use_native:
                        centers, contexts = native.skipgram_windows(chunk, self.window,
                                                                    seed=seed)
                    else:
                        centers, contexts = skipgram_windows(chunk, self.window, rng)
                    # dedup shuffles blocks of consecutive windows, one kernel
                    # block each, so that a block's windows overlap
                    block = self._effective_pc() if self.dedup else 1
                    if use_native and len(centers) >= macro:
                        stream = native.WindowPrefetcher(
                            centers, contexts, macro, block=block, epochs=1,
                            capacity=4, seed=seed)
                    elif block > 1:
                        stream = batch_stream_blocks(centers, contexts, macro, rng,
                                                     block=block)
                    else:
                        stream = batch_stream(centers, contexts, macro, rng)
                else:
                    if use_native:
                        centers, contexts = native.skipgram_pairs(chunk, self.window,
                                                                  seed=seed)
                    else:
                        centers, contexts = skipgram_pairs(chunk, self.window, rng)
                    if use_native and len(centers) >= macro:
                        stream = native.PairPrefetcher(centers, contexts, macro,
                                                       epochs=1, capacity=4, seed=seed)
                    else:
                        stream = batch_stream(centers, contexts, macro, rng)
                n_batches = max(len(centers) // macro, 1)
                try:
                    for bi, b in enumerate(stream):
                        p = (chunk_base + (bi / n_batches) * chunk_len) / total_tokens
                        yield {**b, "progress": np.float32(min(p, 1.0))}
                finally:
                    if hasattr(stream, "close"):
                        stream.close()

    # -- step --------------------------------------------------------------

    def pool_geometry(self, b: int) -> Tuple[int, int]:
        """``(pairs per pool block, pool blocks)`` for a substep of ``b``
        pairs: the block is the largest divisor of ``b`` not above
        ``pool_block``."""
        pb = min(self.pool_block, b)
        while b % pb:
            pb -= 1
        return pb, b // pb

    def _effective_pc(self, n: Optional[int] = None) -> int:
        """The grouped kernel's centers per block: the largest divisor of the
        substep's center count ``n`` (default ``batch_size``) not above
        ``centers_per_block``."""
        n = self.batch_size if n is None else n
        pc = min(self.centers_per_block, n)
        while n % pc:
            pc -= 1
        return pc

    def _pools(self, generator: torch.Generator, nb: int,
               negs: Optional[torch.Tensor]) -> torch.Tensor:
        """``[nb, pool_size]`` negative word ids: ``negs``, else drawn."""
        if negs is not None:
            return negs
        return alias_sample(self.neg_alias, generator, (nb, self.pool_size))

    def _negs(self, generator: torch.Generator, b: int,
              negs: Optional[torch.Tensor]) -> torch.Tensor:
        """``[b, negatives]`` word ids a pair: ``negs``, else drawn."""
        if negs is not None:
            return negs
        return alias_sample(self.neg_alias, generator, (b, self.negatives))

    def _substep_dense(self, state: W2VState, centers: torch.Tensor,
                       contexts: torch.Tensor, generator: torch.Generator,
                       lr: float, negs: Optional[torch.Tensor] = None):
        """One reference-faithful substep on the 2-D plane: ``negatives``
        independent draws a pair (``negs``, ``[b, K]`` word ids, replaces
        them, as in the JAX package), pull, SGNS loss and its gradient with
        respect to the pulled rows, push. Updates both tables in place and
        returns ``(state, loss)``."""
        b, k = centers.shape[0], self.negatives
        negs = self._negs(generator, b, negs)
        in_rows = self._rows(centers)
        out_rows = self._rows(torch.cat([contexts, negs.reshape(-1)]))
        v = pull(state.in_table, in_rows).float().requires_grad_()
        u = pull(state.out_table, out_rows).float().requires_grad_()
        loss = sgns_loss(v, u[:b], u[b:].reshape(b, k, -1))
        dv, du = torch.autograd.grad(loss, (v, u))
        push(state.in_table, in_rows, dv, self.access, lr)
        push(state.out_table, out_rows, du, self.access, lr)
        return state, loss.detach()

    def _substep_packed_perpair(self, state: W2VState, centers: torch.Tensor,
                                contexts: torch.Tensor, generator: torch.Generator,
                                lr: float, negs: Optional[torch.Tensor] = None):
        """Packed tables with ``negatives`` independent draws a pair: the
        pulls and pushes of :meth:`_substep_packed` (two ``gather_rows``,
        two ``scatter_add_rows``) over ``b`` centers and ``b (1 + K)`` out
        rows; ``negs`` as in :meth:`_substep_dense`."""
        b, k = centers.shape[0], self.negatives
        negs = self._negs(generator, b, negs)
        in_rows = self._rows(centers)
        out_rows = self._rows(torch.cat([contexts, negs.reshape(-1)]))
        v = pull_packed(state.in_table, in_rows).float().requires_grad_()
        u = pull_packed(state.out_table, out_rows).float().requires_grad_()
        flat = v.reshape(b, -1)
        loss = sgns_loss(flat, u[:b].reshape(b, -1), u[b:].reshape(b, k, -1))
        dv, du = torch.autograd.grad(loss, (v, u))
        push_packed(state.in_table, in_rows, dv, self.access, lr)
        push_packed(state.out_table, out_rows, du, self.access, lr)
        return state, loss.detach()

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
        pools = self._pools(generator, nb, negs)
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

    def _substep_fused(self, state: W2VState, centers: torch.Tensor,
                       contexts: torch.Tensor, generator: torch.Generator,
                       lr: float, negs: Optional[torch.Tensor] = None):
        """One hogwild substep in one kernel (:func:`fused_sgns_step`):
        ``pool_block`` pairs a kernel block share a pool. ``negs`` as in
        :meth:`_substep_packed`. Updates both tables in place and returns
        ``(state, loss)``."""
        pb, nb = self.pool_geometry(centers.shape[0])
        pools = self._pools(generator, nb, negs)
        _, _, loss = fused_sgns_step(
            state.in_table.table, state.out_table.table, self._rows(centers),
            self._rows(contexts), self._rows(pools.reshape(-1)), lr=lr,
            lam=self.negatives / self.pool_size, pairs_per_block=pb,
            pool_size=self.pool_size)
        return state, loss

    def _grouped_step_fn(self):
        """The kernel of a grouped substep and its extra arguments
        (:attr:`grouped_step`), as the JAX trainer picks them: the composed form where ``dedup`` and
        ``resident`` are both set (its head clamped to ``u_cap``), else the
        dedup or resident form, else the plain grouped one; a head of fewer
        than 8 rows drops the resident part."""
        hot_n = min(self.hot_rows, self.capacity)
        if self.dedup and self.resident and hot_n >= 8:
            # the composed form needs u_cap >= the effective head: clamp the
            # head to what the unique list holds instead of raising
            eff, _ = effective_hot_rows(hot_n, self.capacity)
            if self.u_cap < eff:
                clamped, _ = effective_hot_rows(min(hot_n, self.u_cap), self.capacity)
                logging.getLogger(__name__).warning(
                    "dedup+resident with u_cap=%d < effective hot_rows=%d: "
                    "clamping the resident head to %d rows (raise u_cap to "
                    "keep the full head)", self.u_cap, eff, clamped)
                hot_n = clamped
        if self.dedup and self.resident and hot_n >= 8:
            return fused_sgns_dedup_resident_step, {"u_cap": self.u_cap, "hot_rows": hot_n}
        if self.dedup:
            return fused_sgns_dedup_step, {"u_cap": self.u_cap}
        if self.resident and hot_n >= 8:
            return fused_sgns_resident_step, {"hot_rows": hot_n}
        return fused_sgns_grouped_step, {}

    def _substep_grouped(self, state: W2VState, centers: torch.Tensor,
                         ctxs: torch.Tensor, generator: torch.Generator,
                         lr: float, negs: Optional[torch.Tensor] = None):
        """One center-major substep over windows ``ctxs`` [N, 2 * window]
        (``-1`` pads) in the kernel of :attr:`grouped_step`; ``negs``
        as in :meth:`_substep_packed`. Updates both tables in place."""
        n = centers.shape[0]
        pc = self._effective_pc(n)
        pools = self._pools(generator, n // pc, negs)
        # hash real ids only; pads stay -1
        ctx_rows = self._rows(ctxs.clamp_min(0)).masked_fill(ctxs < 0, -1)
        step_fn, extra = self.grouped_step
        _, _, loss = step_fn(
            state.in_table.table, state.out_table.table, self._rows(centers),
            ctx_rows, self._rows(pools.reshape(-1)), lr=lr,
            lam=self.negatives / self.pool_size, window=self.window,
            centers_per_block=pc, pool_size=self.pool_size, **extra)
        return state, loss

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
        tensor (no host sync). Raises ``ValueError`` for a batch of more than
        one substep whose length is not a multiple of the substeps.
        """
        centers, contexts = batch["centers"], batch["contexts"]
        n = centers.shape[0]
        t = max(n // self.batch_size, 1)
        b = n // t
        if t > 1 and t * b != n:
            # the JAX package's reshape to (t, b) refuses such a batch too
            raise ValueError(f"a batch of {n} items does not split into {t} substeps "
                             f"of {b} (batch_size {self.batch_size})")
        lr = self.step_lr(batch)
        if self.grouped:
            substep = self._substep_grouped
        elif self.fused:
            substep = self._substep_fused
        elif self.packed:
            substep = (self._substep_packed if self.neg_mode == "pool"
                       else self._substep_packed_perpair)
        else:
            substep = self._substep_dense
        losses = []
        for i in range(t):
            sl = slice(i * b, (i + 1) * b)
            state, loss = substep(state, centers[sl], contexts[sl], generator, lr)
            losses.append(loss)
        return state, {"loss": torch.stack(losses).mean()}

    # -- export (ServerTerminate parity: text dump of the table) -----------

    def _all_vocab_rows(self, state: W2VState) -> np.ndarray:
        ids = self._rows(torch.arange(len(self.vocab), dtype=torch.int32,
                                      device=state.in_table.table.device))
        vals = state.in_table.table.index_select(0, ids)
        if self.packed:
            vals = unpack_rows(vals, self.dim)
        return vals.float().cpu().numpy()

    def table_geometry(self) -> Dict[str, Dict]:
        """Each table's layout, as the JAX trainer gives it."""
        layout = "packed" if self.packed else "dense"
        geo = {"layout": layout, "group": 1, "dim": self.dim, "capacity": self.capacity}
        return {"in_table": dict(geo), "out_table": dict(geo)}

    def export_text(self, state: W2VState, path: str) -> None:
        rows = self._all_vocab_rows(state).astype(np.float64).tolist()
        fmt = " ".join(["%.6f"] * self.dim)  # one format a row: f"{x:.6f}" each
        with open(path, "w", encoding="utf-8") as f:
            f.write(f"{len(self.vocab)} {self.dim}\n")
            for word, row in zip(self.vocab.words, rows):
                f.write(f"{word} {fmt % tuple(row)}\n")

    # -- eval: nearest neighbors for sanity checks --------------------------

    def neighbors(self, state: W2VState, word: str, topn: int = 10):
        emb = self._all_vocab_rows(state)
        norms = np.linalg.norm(emb, axis=1, keepdims=True) + 1e-9
        emb = emb / norms
        q = emb[self.vocab.index[word]]
        sims = emb @ q
        order = np.argsort(-sims)
        return [(self.vocab.words[i], float(sims[i])) for i in order[1 : topn + 1]]
