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
``dedup``, ``u_cap``, ``packed``, ``neg_mode``, ``use_native``, ``stream``,
``table_tier`` (``host``: the tiered store, :mod:`swiftsnails_tpu_torch.tiered`,
on the ``dense``, ``packed`` pool and ``per_pair`` paths).
Keys that select a path the port does not have yet raise
``NotImplementedError`` (see :data:`UNPORTED`); ``ROADMAP.md`` says when
each is ported.
"""

from __future__ import annotations

import contextlib
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
    step_generator,
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
from swiftsnails_tpu_torch.ops.hashing import hash_row, hash_row_np
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
        # table_tier: host -> the tiered parameter store (tiered/): host-RAM
        # master tables, a device working-set cache, batch ids remapped to
        # cache slots before the step. Supported on the dense and packed
        # (pool/per_pair) substeps — the fused/grouped kernels address whole
        # tables and have no slot-space meaning. The negatives are drawn on
        # the host side of the step (tier_plan makes the step's own draws),
        # so the fault path knows every row before the step.
        self.tiered = cfg.get_str("table_tier", "device") == "host"
        if self.tiered and self.fused:
            raise ValueError(
                "table_tier: host does not compose with fused/grouped "
                "kernels (they take whole-table VMEM references); use "
                "packed: 1 with neg_mode pool/per_pair, or packed: 0")
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

    def _step_rows(self, keys: torch.Tensor, planned: bool) -> torch.Tensor:
        """In-substep id resolution: on the host tier a planned batch (one
        that carries the plan's ``negs``) arrives hashed AND remapped to
        cache slots, so it is not hashed again; a transparent tier's batch
        is raw, as a resident one. Export and eval keep :meth:`_rows`
        against the full table."""
        return keys if planned else self._rows(keys)

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
        planned = self.tiered and negs is not None
        negs = self._negs(generator, b, negs)
        in_rows = self._step_rows(centers, planned)
        out_rows = self._step_rows(torch.cat([contexts, negs.reshape(-1)]), planned)
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
        planned = self.tiered and negs is not None
        negs = self._negs(generator, b, negs)
        in_rows = self._step_rows(centers, planned)
        out_rows = self._step_rows(torch.cat([contexts, negs.reshape(-1)]), planned)
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
        planned = self.tiered and negs is not None
        pools = self._pools(generator, nb, negs)
        in_rows = self._step_rows(centers, planned)
        out_rows = self._step_rows(torch.cat([contexts, pools.reshape(-1)]), planned)

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
        # the tier's plan: each substep's negatives, drawn ahead in order and
        # remapped (rows of [t * r, ...], r a substep's)
        negs = batch.get("negs")
        r = negs.shape[0] // t if negs is not None else 0
        losses = []
        for i in range(t):
            sl = slice(i * b, (i + 1) * b)
            planned = {} if negs is None else {"negs": negs[i * r:(i + 1) * r]}
            state, loss = substep(state, centers[sl], contexts[sl], generator, lr,
                                  **planned)
            losses.append(loss)
        return state, {"loss": torch.stack(losses).mean()}

    def step_cost(self, batch: Dict[str, np.ndarray]) -> Dict:
        """One step's least bytes and f32 flops on ``batch`` (the goodput
        block's numerators; see :meth:`Trainer.step_cost`), counted per
        substep as ``train_step`` slices the batch:

        * bytes: each distinct row a substep touches, read once and written
          once at the table's logical width (``dim`` elements of the table
          dtype; in-table rows from the centers, out-table rows from the
          contexts — a grouped window's pads excluded — plus the negatives
          drawn inside the step, counted at their number), and the batch's
          arrays read once;
        * flops: against a shared pool, scores, dV and dQ are 3 products of
          ``2 d`` flops for each (row, pool entry), ``6 U PN d`` for the
          ``U`` rows that meet the pool (a flat substep's pairs, a grouped
          one's centers), and the positive term, its two gradients and the
          updates ``8 d`` a real pair; with per-pair negatives (``dense``,
          ``neg_mode: per_pair``) ``6 b K d + 8 b d``.
        """
        centers = np.asarray(batch["centers"])
        contexts = np.asarray(batch["contexts"])
        n = centers.shape[0]
        t = max(n // self.batch_size, 1)
        b = n // t
        d = self.dim
        row_bytes = d * torch.empty((), dtype=self.table_dtype).element_size()
        rows = ((lambda x: hash_row_np(x, self.capacity)) if self.hash_keys
                else (lambda x: x))
        per_pair = not self.fused and not (self.packed and self.neg_mode == "pool")
        distinct = flops = 0
        for i in range(t):
            cs, xs = centers[i * b:(i + 1) * b], contexts[i * b:(i + 1) * b]
            if self.grouped:
                ctx = xs[xs >= 0]
                units, pairs = b, ctx.size
                drawn = (b // self._effective_pc(b)) * self.pool_size
            elif per_pair:
                ctx, units, pairs = xs, b, b
                drawn = b * self.negatives
            else:
                ctx, units, pairs = xs, b, b
                drawn = self.pool_geometry(b)[1] * self.pool_size
            distinct += (np.unique(rows(cs)).size + np.unique(rows(ctx)).size + drawn)
            if per_pair:
                flops += 6 * b * self.negatives * d + 8 * b * d
            else:
                flops += 6 * units * self.pool_size * d + 8 * pairs * d
        nbytes = 2 * distinct * row_bytes + centers.nbytes + contexts.nbytes
        return {"cost": {"flops": float(flops), "bytes_accessed": float(nbytes)},
                "total_bytes": None, "source": "analytic"}

    # -- export (ServerTerminate parity: text dump of the table) -----------

    def _all_vocab_rows(self, state: W2VState) -> np.ndarray:
        ids = self._rows(torch.arange(len(self.vocab), dtype=torch.int32,
                                      device=state.in_table.table.device))
        vals = state.in_table.table.index_select(0, ids)
        if self.packed:
            vals = unpack_rows(vals, self.dim)
        return vals.float().cpu().numpy()

    # -- tiered parameter store (table_tier: host; see tiered/) -------------

    def _plan_rows(self, keys: np.ndarray) -> np.ndarray:
        """Host-side twin of :meth:`_rows` (``hash_row_np`` equals
        ``hash_row`` on non-negative keys): the row ids the resident substep
        would use, as int32."""
        keys = np.asarray(keys)
        if self.hash_keys:
            return hash_row_np(keys, self.capacity).astype(np.int32)
        return keys.astype(np.int32, copy=False)

    def tier_spec(self):
        if not self.tiered:
            return None
        layout = "packed" if self.packed else "dense"
        return {"in_table": {"layout": layout, "group": 1},
                "out_table": {"layout": layout, "group": 1}}

    def tier_tables(self, state: W2VState):
        return {"in_table": state.in_table, "out_table": state.out_table}

    def tier_with_tables(self, state: W2VState, tables):
        return W2VState(in_table=tables.get("in_table", state.in_table),
                        out_table=tables.get("out_table", state.out_table))

    def _plan_stream(self):
        """The side stream the plan's draws run on, so reading them back
        waits for the plan alone, not for the steps queued on the card."""
        if self.device.type != "cuda":
            return None
        stream = getattr(self, "_tier_stream", None)
        if stream is None:
            stream = self._tier_stream = torch.cuda.Stream(self.device)
        return stream

    def tier_plan(self, batch, seed: int, step: int):
        """Host-side step plan: the step's generator
        (``step_generator(seed, step, device)``, as the loop makes it) and
        its ``alias_sample`` draws, one a substep in order at the substep's
        shape — the calls the resident substeps make — then every id
        hashed. The draws run on the trainer's device, so they equal the
        resident step's bit for bit.

        Returns ``(ids, aug, remap_keys)``: per-table touched row ids, batch
        augmentations (hashed centers/contexts + the drawn negatives), and
        which batch keys each table's remap applies to.

        The fused paths draw their pools inside the step at their own block
        geometry (``b // pool_block`` pools a flat substep, ``b //
        centers_per_block`` a grouped one, which the merged forms share);
        their plan makes the same draws at that geometry, so ``ids`` holds
        every row the step reads or writes (the pads of a grouped window
        left out). The tier refuses the fused paths, so their plan carries
        no augmentation or remap: only the freshness collector reads it."""
        centers = np.asarray(batch["centers"])
        contexts = np.asarray(batch["contexts"])
        n = centers.shape[0]
        t = max(n // self.batch_size, 1)
        b = n // t
        if self.grouped:
            shape = (b // self._effective_pc(b), self.pool_size)
        elif self.packed and self.neg_mode == "pool":
            shape = (self.pool_geometry(b)[1], self.pool_size)
        else:
            shape = (b, self.negatives)
        stream = self._plan_stream()
        with (torch.cuda.stream(stream) if stream is not None
              else contextlib.nullcontext()):
            gen = step_generator(seed, step, self.device)
            draws = torch.cat([alias_sample(self.neg_alias, gen, shape)
                               for _ in range(t)])
            negs = draws.cpu().numpy()
        c_r = self._plan_rows(centers)
        n_r = self._plan_rows(negs)
        if self.fused:
            x_r = self._plan_rows(contexts[contexts >= 0])
            ids = {"in_table": c_r.ravel(),
                   "out_table": np.concatenate([x_r.ravel(), n_r.ravel()])}
            return ids, {}, {}
        x_r = self._plan_rows(contexts)
        ids = {"in_table": c_r.ravel(),
               "out_table": np.concatenate([x_r.ravel(), n_r.ravel()])}
        aug = {"centers": c_r, "contexts": x_r, "negs": n_r}
        remap = {"in_table": ["centers"], "out_table": ["contexts", "negs"]}
        return ids, aug, remap

    def tier_warm_rows(self):
        """Hottest-first row ids for the cache prewarm (vocab frequency
        order; both tables share the unigram distribution)."""
        rows = self._plan_rows(self.vocab.hottest_rows().astype(np.int64))
        return {"in_table": rows, "out_table": rows}

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
