"""Word2Vec skip-gram with negative sampling — the JAX package's ``models/word2vec.py``.

The flagship trainer of the parameter server: workers pull embedding rows
for the words of their batch, compute SGNS gradients with respect to the
pulled rows, and push them back to the tables (SURVEY §3.3).

The port runs the JAX trainer's single-device paths and its flat paths
under a ``(data, model)`` mesh (below). ``packed: 0``
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

Under ``mesh=`` (a :class:`~swiftsnails_tpu_torch.parallel.mesh.Mesh`,
one rank a device) each rank holds one model shard of both tables and
trains on its data shard of the batch (``b / D`` pairs of a substep of
``b``), through the collectives of :mod:`swiftsnails_tpu_torch.parallel.transfer`,
as the JAX trainer routes them (its ``_ppull`` / ``_ppush``, ``_dpull`` /
``_dpush``): ``packed: 0`` through the 2-D pull and push, ``packed+pool``
and ``neg_mode: per_pair`` through the packed ones, and ``fused: 1,
grouped: 0`` through the packed+pool substep (the JAX trainer's choice: the
flat fused kernel has no collective plane). Each rank draws the step's
whole set of negatives from the step's generator and takes its own part, so
a pool block must not straddle two data shards. The loss is summed locally
over the global batch size, so a pair's gradient is the one-device one;
the reported loss is its sum over ``data``, one all-reduce a call.
``export_text`` gathers the table and writes from rank 0. ``table_tier:
host`` under a mesh (``packed: 0``, packed+pool and per-pair) trains on
this rank's shard of each table's cache plane in slot space, through the
same pull and push collectives (a shard's rows are the cache's); the loop's
``TierManager`` plans the global batch and the tier's negatives
(``negs``) stay whole in :meth:`local_batch`, each data shard taking its
part in the substep, as the drawn ones do.

``fused: 1, grouped: 1`` under a mesh (with ``resident``, which has no
meaning there, ``dedup`` or both) is the grouped collective plane
(:meth:`_substep_grouped_mesh`): each center row pulled once a window, the
window and the block's pool scored against it, one merged center gradient
pushed, through the packed collectives; the deterministic merged update,
not the kernels' hogwild. ``dedup: 1`` there pulls and pushes the out
table through a unique list a data shard (``mesh_u_cap``, default
:meth:`_mesh_u_cap`), whose overflow the ``dedup_dropped`` metric counts.
``push_mode: bucketed`` (``bucket_slack``) pushes through the
owner-bucketed collective on the packed paths under a mesh, its overflow
in ``push_dropped``. ``overlap: 1|2`` pipelines the plane's substeps
(:meth:`_overlap_macro`): substep ``i + depth``'s pull reads the tables
before substep ``i``'s push.

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
``push_mode``, ``bucket_slack``, ``overlap``, ``mesh_u_cap``, ``comm_dtype``,
``comm_int4_block`` (the mesh collectives' wire, :mod:`swiftsnails_tpu_torch.parallel.comm`:
under a mesh the packed planes quantize their pulls and pushes, the
pushes dithered with one uint32 a substep from the step's generator, or
``batch["comm_seeds"]``; the 2-D plane keeps f32, as the JAX trainer's
does; one device ignores the key),
``table_tier`` (``host``: the tiered store, :mod:`swiftsnails_tpu_torch.tiered`,
on the ``dense``, ``packed`` pool and ``per_pair`` paths), ``placement``
(``uniform``, ``hybrid``, ``auto``) with ``placement_head_rows``,
``placement_tail_slack``, ``placement_tail_cap`` and
``placement_calib_bytes``, and ``optimizer_sharding`` (``zero``).

``placement: hybrid|auto`` under a mesh splits both tables at a cut
(:meth:`_init_placement`; ``auto`` from the vocabulary's CDF): the head
rows whole on every rank, pulled locally and pushed through one dense
reduce over ``data``, the tail model-sharded through the dedup collectives
at :meth:`_hybrid_cap` (:mod:`swiftsnails_tpu_torch.parallel.hybrid`), on
every plane: the 2-D one (``pull_hybrid``), packed+pool and per-pair, and
the grouped plane with dedup, bucketed and overlap. Its overflow is the
``hybrid_dropped`` metric (``dedup_dropped`` / ``push_dropped`` where
those are on). The loop adopts the split and merges it back
(``PlacementManager``). ``optimizer_sharding: zero`` makes the head's push
a reduce-scatter of ``1 / data`` rows a rank and a gather of the updated
rows (word2vec has no slot planes), bit for bit the replicated update.
"""

from __future__ import annotations

import contextlib
import logging
import math
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
    Trainer,
    mesh_device,
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
from swiftsnails_tpu_torch.parallel import hybrid, transfer
from swiftsnails_tpu_torch.parallel.comm import (
    apply_int4_block,
    resolve_comm_dtype,
    stochastic_wire,
    wire_bytes,
)
from swiftsnails_tpu_torch.parallel.access import SgdAccess
from swiftsnails_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, rows_per_shard
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
from swiftsnails_tpu_torch.utils.config import Config, ConfigError
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


class GroupedPull(NamedTuple):
    """The pull half of a grouped collective substep, which the push half
    consumes (at once, or ``overlap`` substeps later)."""

    center_rows: torch.Tensor  # [n] in-table rows of this shard's centers
    out_rows: torch.Tensor  # [n * cw + nb * pn] its window slots, then its pools
    mask: torch.Tensor  # [n, cw] 1.0 on a real context slot
    v: torch.Tensor  # [n, S, 128] the centers' pulled rows
    u: torch.Tensor  # [n * cw + nb * pn, S, 128] the out rows' pulled rows
    layout: Optional[transfer.DataLayout]  # the out rows' chunks (dedup, bucketed)
    index: Optional[tuple]  # the dedup pull's unique index
    dropped: torch.Tensor  # the dedup pull's overflow
    pools: torch.Tensor  # the substep's whole pool set
    seed: Optional[torch.Tensor]  # the pushes' dither seed (a stochastic wire)


def sgns_loss(v: torch.Tensor, u_pos: torch.Tensor, u_neg: torch.Tensor,
              total: Optional[int] = None) -> torch.Tensor:
    """Skip-gram negative-sampling loss in float32: ``v``, ``u_pos``
    ``[B, D]`` center and context rows, ``u_neg`` ``[B, K, D]`` negatives.
    Returns the mean over pairs of ``-log σ(v·u_pos) - Σ_k log σ(-v·u_neg_k)``;
    with ``total``, the sum over these pairs divided by ``total`` (a data
    shard's part of the mean over a batch of ``total`` pairs)."""
    pos = torch.einsum("bd,bd->b", v, u_pos)
    neg = torch.bmm(u_neg, v.unsqueeze(-1)).squeeze(-1)  # [B, K]
    terms = F.logsigmoid(pos) + F.logsigmoid(-neg).sum(dim=-1)
    return -(terms.mean() if total is None else terms.sum() / total)


def sgns_pool_loss(v: torch.Tensor, u_pos: torch.Tensor, pool: torch.Tensor,
                   lam: float, total: Optional[int] = None) -> torch.Tensor:
    """Pooled SGNS loss over packed rows, in float32.

    ``v``, ``u_pos``: ``[B, S, 128]`` center and context rows; ``pool``:
    ``[NB, PN, S, 128]`` negatives shared by each block of ``B / NB``
    consecutive pairs. Returns the mean over pairs of
    ``-log σ(v·u_pos) - lam · Σ_q log σ(-v·pool_q)``; with ``total``, each
    term's sum divided by ``total`` instead, as :func:`sgns_loss`.
    """
    nb, pn = pool.shape[:2]
    b = v.shape[0]
    pos = F.logsigmoid(torch.einsum("bsl,bsl->b", v, u_pos))
    vb = v.reshape(nb, b // nb, -1)
    neg = torch.bmm(vb, pool.reshape(nb, pn, -1).transpose(1, 2))  # [NB, PB, PN]
    negs = F.logsigmoid(-neg)
    if total is None:
        return -(pos.mean() + lam * negs.sum(dim=-1).mean())
    return -(pos.sum() / total + lam * (negs.sum() / total))


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
        """``device=None`` means the card, or with ``mesh`` the mesh's
        device; ``device="cpu"`` runs the kernels' plain versions. ``mesh``:
        a :class:`~swiftsnails_tpu_torch.parallel.mesh.Mesh` to train under
        (module docstring), or ``None`` for one device."""
        if mesh is not None:
            device = mesh_device(mesh, device)
        super().__init__(config, device)
        self.mesh = mesh
        cfg = config
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
        # push_mode: bucketed -> the owner-bucketed push (static buckets,
        # overflow in push_dropped) where a push collective runs: the packed
        # paths, and the fused ones only under a mesh (one device: the exact
        # push, push_dropped 0)
        self.push_mode = cfg.get_str("push_mode", "gather")
        if self.push_mode not in ("gather", "bucketed"):
            raise ValueError(f"push_mode must be gather|bucketed, got {self.push_mode}")
        if self.push_mode == "bucketed" and (not self.packed or (self.fused and mesh is None)):
            raise ValueError(
                "push_mode: bucketed requires packed: 1, and fused: 1 only "
                "with a mesh (single-device fused has no push collective)")
        self.bucket_slack = cfg.get_float("bucket_slack", 2.0)
        # comm_dtype: the wire format of the mesh collectives (f32, bf16,
        # int8, int4; comm_int4_block sets int4's scale block), as the JAX
        # trainer reads it; without a mesh there are no collectives and the
        # key changes nothing (parallel/comm.py)
        self.comm_dtype = apply_int4_block(
            resolve_comm_dtype(cfg.get_str("comm_dtype", "float32")),
            cfg.get_int("comm_int4_block", 0))
        # overlap: 1|2 -> the grouped collective plane's pipelined macro-step
        # (stale-by-depth pulls); only under a mesh with steps_per_call > 1
        try:
            self.overlap = cfg.get_int("overlap", 0)
        except ConfigError:  # the bool spellings (overlap: true), which the
            # JAX trainer means to take but refuses (it catches ValueError)
            self.overlap = int(cfg.get_bool("overlap", False))
        if self.overlap not in (0, 1, 2):
            raise ValueError(f"overlap must be 0, 1 or 2, got {self.overlap}")
        if self.overlap and not (cfg.get_bool("fused", False)
                                 and cfg.get_bool("grouped", False)):
            raise ValueError(
                "overlap: 1|2 requires fused: 1, grouped: 1 (the grouped "
                "collective plane is the only overlap-scheduled path)")
        self.hot_rows = cfg.get_int("hot_rows", 1024)
        self.u_cap = cfg.get_int("u_cap", 512)
        self.mesh_u_cap = cfg.get_int("mesh_u_cap", 0)  # 0: _mesh_u_cap's auto cap
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
        if mesh is not None:
            rows_per_shard(cap, mesh)  # the model axis must divide the tables
            if self.batch_size % self._data():
                raise ValueError(f"batch_size {self.batch_size} does not split over "
                                 f"data axis {self._data()}")
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
        # optimizer_sharding: zero -> word2vec trains SGD (no slot planes),
        # so zero is a wire change here: the hybrid head's push
        # reduce-scatters, updates its rows and all-gathers them back (bit
        # for bit the replicated update at f32)
        self.zero = self.optimizer_sharding == "zero" and mesh is not None
        # placement: uniform|hybrid|auto -> the head/tail split of both
        # tables under a mesh (parallel/hybrid.py); auto picks the cut from
        # the vocabulary's CDF (parallel/placement.py)
        self._init_placement(cfg)
        self.grouped_step = self._grouped_step_fn() if self.grouped else None
        self._drops = None  # the dropped counts of a train_step call

    # -- state -------------------------------------------------------------

    def init_state(self) -> W2VState:
        make = create_packed_table if self.packed else create_table
        in_table = make(
            self.capacity, self.dim, self.access, dtype=self.table_dtype,
            seed=self.seed, device=self.device, mesh=self.mesh)
        # reference word2vec inits syn1neg to zeros; init_scale=0 keeps that
        out_table = make(
            self.capacity, self.dim, self.access, dtype=self.table_dtype,
            seed=self.seed + 1, init_scale=0.0, device=self.device, mesh=self.mesh)
        return W2VState(in_table=in_table, out_table=out_table)

    def _rows(self, keys: torch.Tensor) -> torch.Tensor:
        if self.hash_keys:
            return hash_row(keys, self.capacity)
        return keys

    # -- placement (the hybrid head/tail split; parallel/hybrid.py) ---------

    def _init_placement(self, cfg) -> None:
        """The JAX trainer's ``_init_placement``: ``placement_cut`` (0 for
        uniform), ``placement_cov`` and the decision the run record carries.
        Keys: ``placement_head_rows`` (hybrid's cut; default ``min(1024,
        capacity / 2)``), ``placement_tail_slack``, ``placement_calib_bytes``
        (auto's measured uniform bytes). The cut is at most half the
        capacity and aligned down to the model axis (to ``lcm(model,
        data)`` under zero); no mesh, ``hash_keys`` under auto and a cut
        of 0 resolve to uniform with a ``reason``."""
        from swiftsnails_tpu_torch.parallel.placement import choose_cut, resolve_placement

        requested = resolve_placement(cfg.get_str("placement", "uniform"))
        self.placement = requested
        self.placement_head_rows = cfg.get_int("placement_head_rows", 0)
        self.placement_slack = cfg.get_float("placement_tail_slack", 2.0)
        self.placement_cut = 0
        self.placement_cov = 0.0
        self.placement_decision = None
        if requested == "uniform":
            return
        log = logging.getLogger(__name__)

        def resolve_uniform(reason: str) -> None:
            log.warning("placement: %s requested but %s; running uniform", requested, reason)
            self.placement = "uniform"
            self.placement_decision = {"mode": "uniform", "requested": requested, "cut": 0,
                                       "replicated_rows": 0, "reason": reason}

        if self.mesh is None:
            return resolve_uniform("no mesh")
        if self.tiered:
            return resolve_uniform("table_tier: host already caches the hot head")
        model, data = self.mesh.axis_size(MODEL_AXIS), self._data()
        calib = cfg.get_float("placement_calib_bytes", 0.0)
        decision = {"requested": requested, "measured_uniform_bytes": calib or None}
        if requested == "auto":
            if self.hash_keys:
                return resolve_uniform("hash_keys scrambles frequency ranks (explicit "
                                       "placement: hybrid still works)")
            n = self.batch_size
            if self.packed:
                pc = self._effective_pc(n)
                local_slots = max((n * 2 * self.window + (n // pc) * self.pool_size) // data, 1)
                row_elems = -(-self.dim // 128) * 128
            else:
                local_slots = max(n * (1 + self.negatives) // data, 1)
                row_elems = self.dim
            decision.update(choose_cut(
                self.vocab.counts, self.capacity, align=model, local_slots=local_slots,
                row_elems=row_elems, data=data, slack=self.placement_slack,
                comm_dtype=self.comm_dtype, measured_uniform_bytes=calib or None))
            cut = decision["cut"]
        else:
            cut = self.placement_head_rows or min(1024, self.capacity // 2)
        cut = min(int(cut), self.capacity // 2)
        # under zero the head push updates a 1/data row slice a replica, so
        # the cut divides by the data axis too
        align = math.lcm(model, data) if self.zero else model
        cut -= cut % align
        if cut <= 0:
            resolve_uniform("cut resolved to 0 (flat distribution or head smaller than "
                            "the model axis)")
            self.placement_decision.update(
                {k: v for k, v in decision.items() if k != "requested"})
            return
        self.placement_cut = cut
        self.placement_cov = 0.0 if self.hash_keys else self.vocab.coverage_at(cut)
        decision.update({"mode": "hybrid", "cut": cut,
                         "replicated_rows": 2 * cut,  # both tables split at the cut
                         "coverage": self.placement_cov})
        self.placement_decision = decision
        log.info("placement: hybrid cut=%d (coverage %.3f, requested %s)",
                 cut, self.placement_cov, requested)

    def placement_spec(self):
        """Each table's split for ``PlacementManager`` (``None``: uniform)."""
        if not self.placement_cut:
            return None
        return {"in_table": {"cut": self.placement_cut, "group": 1},
                "out_table": {"cut": self.placement_cut, "group": 1}}

    def _hybrid_cap(self, n_rows: int) -> int:
        """The tail's static unique capacity a data shard for a pull or push
        of ``n_rows`` rows over the whole mesh: ``slack * (1 - coverage)``
        of the shard's slots (:func:`~swiftsnails_tpu_torch.parallel.placement.tail_cap`),
        or ``placement_tail_cap``."""
        from swiftsnails_tpu_torch.parallel.placement import tail_cap

        override = self.config.get_int("placement_tail_cap", 0)
        if override:
            return override
        return tail_cap(max(n_rows // self._data(), 1), self.placement_cov,
                        self.placement_slack)

    # -- the planes: one device, or the mesh's collectives over the same
    # shard-local pulls and pushes (the JAX trainer's _ppull / _ppush and
    # _dpull / _dpush)

    def _ppull(self, table_state, rows):
        if self.mesh is None:
            return pull_packed(table_state, rows)
        if hybrid.is_hybrid(table_state):
            # the unique index and overflow go: the push recomputes the same
            # list and counts the overflow once, as the JAX trainer's does
            vals, _, _ = hybrid.pull_hybrid_packed(
                self.mesh, table_state, rows, self._hybrid_cap(rows.shape[0] * self._data()),
                comm_dtype=self.comm_dtype)
            return vals
        return transfer.pull_collective_packed(self.mesh, table_state, rows,
                                               comm_dtype=self.comm_dtype)

    def _ppush(self, table_state, rows, grads, lr, seed=None, place=None):
        """The packed push; ``push_mode: bucketed`` under a mesh through the
        owner-bucketed collective, whose overflow :meth:`_dropped` keeps.
        ``rows`` is this rank's contiguous data slice of the batch's, or
        with ``place`` its slots of a layout (:meth:`_out_place`); ``seed``
        the substep's dither (:meth:`_comm_seed`)."""
        if self.mesh is None:
            return push_packed(table_state, rows, grads, self.access, lr)
        if hybrid.is_hybrid(table_state):
            if self.push_mode == "bucketed":
                table_state, dropped = hybrid.push_hybrid_packed_bucketed(
                    self.mesh, table_state, rows, grads, self.access, lr,
                    slack=self.bucket_slack, comm_dtype=self.comm_dtype, seed=seed,
                    zero=self.zero)
            else:
                table_state, dropped = hybrid.push_hybrid_packed(
                    self.mesh, table_state, rows, grads, self.access, lr,
                    self._hybrid_cap(rows.shape[0] * self._data()),
                    comm_dtype=self.comm_dtype, seed=seed, zero=self.zero)
            self._dropped(dropped)
            return table_state
        if self.push_mode == "bucketed":
            table_state, dropped = transfer.push_collective_packed_bucketed(
                self.mesh, table_state, rows, grads, self.access, lr,
                slack=self.bucket_slack, comm_dtype=self.comm_dtype, seed=seed)
            self._dropped(dropped)
            return table_state
        return transfer.push_collective_packed(self.mesh, table_state, rows, grads, self.access,
                                               lr, comm_dtype=self.comm_dtype, seed=seed,
                                               place=place)

    def _comm_seed(self, generator: torch.Generator, seed=None):
        """A substep's dither seed: ``None`` unless the wire is int8 or int4
        under a mesh; else ``seed`` where given (tests pass the JAX
        trainer's), else one uint32 drawn from the step's generator (the
        JAX trainer takes its key's low word, which torch cannot make), as
        an int64 device tensor: no host sync."""
        if self.mesh is None or not stochastic_wire(self.comm_dtype):
            return None
        if seed is not None:
            return torch.as_tensor(seed, dtype=torch.int64, device=self.device)
        return torch.randint(0, 1 << 32, (), generator=generator, dtype=torch.int64,
                             device=generator.device).to(self.device)

    def _out_place(self, n_sharded: int, n_whole: int, seed):
        """Under a stochastic wire on a mesh, where each of this rank's out
        rows (its ``n_sharded`` own slots, then its part of the ``n_whole``
        pool or negative slots) lies in the JAX trainer's concatenation
        split over ``data``, for its dither (:func:`transfer.layout_place`)."""
        if seed is None:
            return None
        return transfer.layout_place(self.mesh, n_sharded, n_whole, seed)

    def _out_layout(self, ctx_rows, pools, out_table=None):
        """Under a mesh with dedup, the bucketed push or a hybrid
        ``out_table``: the out rows as the JAX trainer splits them over
        ``data`` (every shard's context rows, then the whole pool set's
        rows; ``pools`` holds all of them), for the ``*_spread``
        collectives. ``None`` where no collective needs it."""
        if self.mesh is None or not (self.dedup or self.push_mode == "bucketed"
                                     or hybrid.is_hybrid(out_table)):
            return None
        return transfer.data_layout(self.mesh, ctx_rows, self._rows(pools.reshape(-1)))

    def _pull_out(self, table_state, rows, layout):
        """The out table's pull of this rank's ``rows``: a hybrid table's
        over ``layout`` (its tail at :meth:`_hybrid_cap`) -> ``(vals,
        index, overflow)``, else :meth:`_ppull` -> ``(vals, None, None)``."""
        if hybrid.is_hybrid(table_state):
            return hybrid.pull_hybrid_packed_spread(
                self.mesh, table_state, layout, self._hybrid_cap(layout.rows.shape[0]),
                comm_dtype=self.comm_dtype)
        return self._ppull(table_state, rows), None, None

    def _push_out(self, table_state, rows, grads, lr, layout, seed=None, place=None,
                  index=None):
        """The out table's push of this rank's ``rows`` (its window or pair
        slots, then its pools): bucketed over ``layout``, else :meth:`_ppush`
        at ``place``; a hybrid table's tail over ``layout`` too (``index``:
        its pull's unique lists, where not bucketed)."""
        if hybrid.is_hybrid(table_state):
            if self.push_mode == "bucketed":
                table_state, dropped = hybrid.push_hybrid_packed_bucketed_spread(
                    self.mesh, table_state, layout, grads, self.access, lr,
                    slack=self.bucket_slack, comm_dtype=self.comm_dtype, seed=seed,
                    zero=self.zero)
                self._dropped(dropped)
                return table_state
            return hybrid.push_hybrid_packed_spread(
                self.mesh, table_state, layout, grads, self.access, lr, index,
                comm_dtype=self.comm_dtype, seed=seed, zero=self.zero)
        if layout is not None and self.push_mode == "bucketed":
            table_state, dropped = transfer.push_collective_packed_bucketed_spread(
                self.mesh, table_state, layout, grads, self.access, lr,
                slack=self.bucket_slack, comm_dtype=self.comm_dtype, seed=seed)
            self._dropped(dropped)
            return table_state
        return self._ppush(table_state, rows, grads, lr, seed=seed, place=place)

    def _out_overflow(self, over) -> None:
        """A hybrid out pull's overflow, counted once, where the JAX
        trainer's push recounts it; not with the bucketed push, whose own
        count is the metric."""
        if over is not None and self.push_mode != "bucketed":
            self._dropped(over)

    def _dropped(self, count: torch.Tensor) -> None:
        """Keep a push's or a consumed pull's overflow for the call's metric
        (:meth:`train_step`); outside a call it is not kept."""
        if self._drops is not None:
            self._drops.append(count)

    # the 2-D plane's collectives keep the f32 wire under any comm_dtype: the
    # JAX trainer's packed: 0 routes run the pjit store pull and push there,
    # which take no codec
    def _dpull(self, table_state, rows):
        if self.mesh is None:
            return pull(table_state, rows)
        if hybrid.is_hybrid(table_state):  # the JAX hybrid twin takes the wire
            return hybrid.pull_hybrid(self.mesh, table_state, rows, comm_dtype=self.comm_dtype)
        return transfer.pull_collective(self.mesh, table_state, rows)

    def _dpush(self, table_state, rows, grads, lr, seed=None):
        if self.mesh is None:
            return push(table_state, rows, grads, self.access, lr)
        if hybrid.is_hybrid(table_state):
            return hybrid.push_hybrid(self.mesh, table_state, rows, grads, self.access, lr,
                                      comm_dtype=self.comm_dtype, seed=seed)
        return transfer.push_collective(self.mesh, table_state, rows, grads, self.access, lr)

    def _data(self) -> int:
        """Data shards: the mesh's data axis, 1 on one device."""
        return 1 if self.mesh is None else self.mesh.axis_size(DATA_AXIS)

    def local_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """:meth:`Trainer.local_batch`, the tier's planned negatives
        (``negs``: every substep's whole draw, which the substeps split
        with :meth:`_data_part`) kept whole."""
        if "negs" not in batch:
            return super().local_batch(batch)
        out = super().local_batch({k: v for k, v in batch.items() if k != "negs"})
        out["negs"] = batch["negs"]
        return out

    def _data_part(self, draws: torch.Tensor) -> torch.Tensor:
        """This data shard's rows of a substep-wide draw (all of it on one
        device)."""
        d = self._data()
        if d == 1:
            return draws
        per = draws.shape[0] // d
        i = self.mesh.axis_index(DATA_AXIS)
        return draws[i * per:(i + 1) * per]

    def _loss_kw(self, b: int) -> Dict[str, int]:
        """Under a mesh, the global pair count a data shard of ``b`` pairs
        sums its loss over (``total``); on one device none, the mean."""
        return {} if self.mesh is None else {"total": b * self._data()}

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
                    # block each, so that a block's windows overlap; under a
                    # mesh the plane dedups a whole substep, so windows
                    # shuffle alone
                    block = self._effective_pc() if self.dedup and self.mesh is None else 1
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
                       lr: float, negs: Optional[torch.Tensor] = None, seed=None):
        """One reference-faithful substep on the 2-D plane: ``negatives``
        independent draws a pair (``negs``, ``[b, K]`` word ids, replaces
        them, as in the JAX package), pull, SGNS loss and its gradient with
        respect to the pulled rows, push. Updates both tables in place and
        returns ``(state, loss)``. This plane moves f32 but for its hybrid
        twins, which take the wire and ``seed``, as the JAX trainer's do."""
        b, k = centers.shape[0], self.negatives
        planned = self.tiered and negs is not None
        negs = self._data_part(self._negs(generator, b * self._data(), negs))
        in_rows = self._step_rows(centers, planned)
        out_rows = self._step_rows(torch.cat([contexts, negs.reshape(-1)]), planned)
        v = self._dpull(state.in_table, in_rows).float().requires_grad_()
        u = self._dpull(state.out_table, out_rows).float().requires_grad_()
        loss = sgns_loss(v, u[:b], u[b:].reshape(b, k, -1), **self._loss_kw(b))
        dv, du = torch.autograd.grad(loss, (v, u))
        # the hybrid twin's wire dithers: its seed, drawn only there
        seed = (self._comm_seed(generator, seed) if hybrid.is_hybrid(state.in_table)
                else None)
        self._dpush(state.in_table, in_rows, dv, lr, seed=seed)
        self._dpush(state.out_table, out_rows, du, lr, seed=seed)
        return state, loss.detach()

    def _substep_packed_perpair(self, state: W2VState, centers: torch.Tensor,
                                contexts: torch.Tensor, generator: torch.Generator,
                                lr: float, negs: Optional[torch.Tensor] = None, seed=None):
        """Packed tables with ``negatives`` independent draws a pair: the
        pulls and pushes of :meth:`_substep_packed` (two ``gather_rows``,
        two ``scatter_add_rows``) over ``b`` centers and ``b (1 + K)`` out
        rows; ``negs`` and ``seed`` as in :meth:`_substep_packed`."""
        b, k = centers.shape[0], self.negatives
        planned = self.tiered and negs is not None
        negs_all = self._negs(generator, b * self._data(), negs)
        negs = self._data_part(negs_all)
        in_rows = self._step_rows(centers, planned)
        out_rows = self._step_rows(torch.cat([contexts, negs.reshape(-1)]), planned)
        layout = self._out_layout(out_rows[:b], negs_all, state.out_table)
        v = self._ppull(state.in_table, in_rows).float().requires_grad_()
        u, index, over = self._pull_out(state.out_table, out_rows, layout)
        u = u.float().requires_grad_()
        flat = v.reshape(b, -1)
        loss = sgns_loss(flat, u[:b].reshape(b, -1), u[b:].reshape(b, k, -1),
                         **self._loss_kw(b))
        dv, du = torch.autograd.grad(loss, (v, u))
        seed = self._comm_seed(generator, seed)
        self._ppush(state.in_table, in_rows, dv, lr, seed=seed)
        self._push_out(state.out_table, out_rows, du, lr, layout, seed,
                       self._out_place(b, negs_all.numel(), seed), index)
        self._out_overflow(over)
        return state, loss.detach()

    def _substep_packed(self, state: W2VState, centers: torch.Tensor,
                        contexts: torch.Tensor, generator: torch.Generator,
                        lr: float, negs: Optional[torch.Tensor] = None, seed=None):
        """One substep: pull, pooled SGNS loss and gradient, push.

        ``negs`` (``[NB, PN]`` word ids) replaces the pool drawn from
        ``generator``; tests inject the same pools into both packages.
        Updates both tables in place and returns ``(state, loss)``. The loss
        and its gradient are computed in float32 from the pulled rows
        whatever the table dtype; the pushed deltas are rounded once to it.
        Under a mesh ``centers`` and ``contexts`` are this data shard's and
        ``negs`` the substep's whole pool set. ``seed`` replaces the
        dither seed drawn after the pools (:meth:`_comm_seed`).
        """
        b = centers.shape[0]
        pb, nb = self.pool_geometry(b * self._data())
        if b % pb:
            raise ValueError(f"a data shard of {b} pairs splits a pool block of {pb} "
                             f"(batch_size {self.batch_size} over {self._data()} data "
                             "shards): make batch_size / data a multiple of pool_block")
        nb = b // pb
        pn = self.pool_size
        lam = self.negatives / pn
        planned = self.tiered and negs is not None
        pools_all = self._pools(generator, nb * self._data(), negs)
        pools = self._data_part(pools_all)
        in_rows = self._step_rows(centers, planned)
        out_rows = self._step_rows(torch.cat([contexts, pools.reshape(-1)]), planned)

        layout = self._out_layout(out_rows[:b], pools_all, state.out_table)
        v = self._ppull(state.in_table, in_rows).float().requires_grad_()
        u, index, over = self._pull_out(state.out_table, out_rows, layout)
        u = u.float()
        u_pos = u[:b].requires_grad_()
        pool = u[b:].reshape(nb, pn, *u.shape[1:]).requires_grad_()
        loss = sgns_pool_loss(v, u_pos, pool, lam, **self._loss_kw(b))
        dv, du_pos, dpool = torch.autograd.grad(loss, (v, u_pos, pool))
        du = torch.cat([du_pos, dpool.reshape(-1, *dpool.shape[2:])])
        seed = self._comm_seed(generator, seed)
        self._ppush(state.in_table, in_rows, dv, lr, seed=seed)
        self._push_out(state.out_table, out_rows, du, lr, layout, seed,
                       self._out_place(b, pools_all.numel(), seed), index)
        self._out_overflow(over)
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

    # -- the grouped collective plane (a mesh) ------------------------------

    def _mesh_u_cap(self, n: int) -> int:
        """The dedup plane's unique-list capacity a data shard, for a
        substep of ``n`` centers: ``u_cap`` a kernel block scaled to the
        shard's blocks (the plane dedups a substep, not a block), clamped to
        the shard's slots and rounded up to a multiple of 8 (at least 8).
        ``mesh_u_cap`` overrides it."""
        if self.mesh_u_cap:
            return self.mesh_u_cap
        d = self._data()
        pc = self._effective_pc(n)
        local_slots = (n * 2 * self.window + (n // pc) * self.pool_size) // d
        blocks = max((n // d) // pc, 1)
        cap = min(self.u_cap * blocks, local_slots)
        return max(-(-cap // 8) * 8, 8)

    def _out_u_cap(self, n: int, out_rows: int = 0, hybrid_out: bool = False) -> int:
        """The grouped plane's out-table unique capacity for a substep of
        ``n`` centers and ``out_rows`` out rows over the mesh (the JAX
        trainer's ``_out_u_cap``): dedup's slot-scaled cap, the hybrid
        tail's coverage cap (``hybrid_out``), or the smaller where both
        hold."""
        caps = []
        if self.dedup:
            caps.append(self._mesh_u_cap(n))
        if hybrid_out:
            caps.append(self._hybrid_cap(out_rows))
        return min(caps)

    def _grouped_pools(self, generator: torch.Generator, n: int,
                       negs: Optional[torch.Tensor]) -> torch.Tensor:
        """A grouped substep's whole pool set, ``[n // pc, pool_size]`` for
        ``n`` centers over all data shards: ``negs``, else drawn."""
        return self._pools(generator, n // self._effective_pc(n), negs)

    def _pull_grouped_mesh(self, state: W2VState, centers: torch.Tensor,
                           ctxs: torch.Tensor, pools: torch.Tensor,
                           seed: Optional[torch.Tensor] = None) -> GroupedPull:
        """The pull half of :meth:`_substep_grouped_mesh`: this data shard's
        centers and windows, ``pools`` the substep's whole set (this shard's
        blocks take their part), ``seed`` the pushes' dither. A window slot
        ``-1`` becomes row ``capacity``, which no shard owns: it pulls zeros
        and its (masked) gradient is dropped."""
        n, cw = ctxs.shape
        pc = self._effective_pc(n * self._data())
        if n % pc:
            raise ValueError(
                f"a data shard of {n} centers splits a pool block of {pc} (batch_size "
                f"{self.batch_size} over {self._data()} data shards): make "
                "batch_size / data a multiple of centers_per_block")
        center_rows = self._rows(centers)
        ctx_rows = torch.where(ctxs >= 0, self._rows(ctxs.clamp_min(0)),
                               self.capacity).reshape(-1)
        out_rows = torch.cat([ctx_rows, self._rows(self._data_part(pools).reshape(-1))])
        v = self._ppull(state.in_table, center_rows)
        hybrid_out = hybrid.is_hybrid(state.out_table)
        layout = self._out_layout(ctx_rows, pools, state.out_table)
        if hybrid_out:
            # the tail rides the unique-list plane at its coverage cap (with
            # dedup's where both are on); the index serves the push
            u, index, dropped = hybrid.pull_hybrid_packed_spread(
                self.mesh, state.out_table, layout,
                self._out_u_cap(n * self._data(), layout.rows.shape[0], True),
                comm_dtype=self.comm_dtype)
        elif self.dedup:
            u, index, dropped = transfer.pull_collective_packed_dedup_spread(
                self.mesh, state.out_table, layout,
                self._out_u_cap(n * self._data(), layout.rows.shape[0], False),
                comm_dtype=self.comm_dtype)
        else:
            u, index = self._ppull(state.out_table, out_rows), None
            dropped = torch.zeros((), dtype=torch.int32, device=self.device)
        return GroupedPull(center_rows, out_rows, (ctxs >= 0).float(), v, u, layout,
                           index, dropped, pools, seed)

    def _push_grouped_mesh(self, state: W2VState, pulled: GroupedPull, lr: float):
        """The push half: the SGNS loss of the pulled rows and its gradient
        (autograd), the merged pushes of both tables. The loss is
        ``-1 / (N (window + 1))`` over the global ``N`` centers times the
        window terms and the pool terms, each center's weighted by its real
        slots; this shard's part of it. Returns ``(state, loss)``."""
        n, cw = pulled.mask.shape
        d = self._data()
        pc = self._effective_pc(n * d)
        nb, pn = n // pc, self.pool_size
        v = pulled.v.float().requires_grad_()
        u_all = pulled.u.float().requires_grad_()
        u = u_all[:n * cw].reshape(n, cw, -1)
        q = u_all[n * cw:].reshape(nb, pn, -1)
        pos = torch.bmm(u, v.reshape(n, -1, 1)).squeeze(-1)  # [n, cw]
        neg = torch.bmm(v.reshape(nb, pc, -1), q.transpose(1, 2))  # [nb, pc, pn]
        n_real = pulled.mask.sum(dim=1).reshape(nb, pc, 1)
        lam = self.negatives / pn
        inv_b = 1.0 / (n * d * (self.window + 1))
        loss = -inv_b * ((F.logsigmoid(pos) * pulled.mask).sum()
                         + lam * (F.logsigmoid(-neg) * n_real).sum())
        dv, du = torch.autograd.grad(loss, (v, u_all))
        seed = pulled.seed
        self._ppush(state.in_table, pulled.center_rows, dv, lr, seed=seed)
        if hybrid.is_hybrid(state.out_table) or self.push_mode == "bucketed":
            self._push_out(state.out_table, pulled.out_rows, du, lr, pulled.layout, seed,
                           self._out_place(n * cw, pulled.pools.numel(), seed),
                           pulled.index)
        elif self.dedup:
            # the pull's unique index: no second sort, the overflow counted once
            transfer.push_collective_packed_dedup_spread(
                self.mesh, state.out_table, du, self.access, lr, pulled.index,
                comm_dtype=self.comm_dtype, seed=seed)
        else:
            self._push_out(state.out_table, pulled.out_rows, du, lr, pulled.layout, seed,
                           self._out_place(n * cw, pulled.pools.numel(), seed))
        self._dropped(pulled.dropped)
        return state, loss.detach()

    def _substep_grouped_mesh(self, state: W2VState, centers: torch.Tensor,
                              ctxs: torch.Tensor, generator: torch.Generator,
                              lr: float, negs: Optional[torch.Tensor] = None, seed=None):
        """One substep of the grouped collective plane (the JAX trainer's
        ``_substep_grouped_mesh``): the center-major traffic cut of the
        grouped kernels through the collectives, as :meth:`_pull_grouped_mesh`
        then :meth:`_push_grouped_mesh`. Row movement in a shard is the row
        kernels' (``gather_rows`` a pull, ``scatter_add_rows`` a push), the
        collectives one all-reduce over ``model`` a pull and the gathers over
        ``data`` a push. ``negs`` and ``seed`` as in :meth:`_substep_packed`.
        Updates both tables in place and returns ``(state, loss)``."""
        pools = self._grouped_pools(generator, centers.shape[0] * self._data(), negs)
        pulled = self._pull_grouped_mesh(state, centers, ctxs, pools,
                                         self._comm_seed(generator, seed))
        return self._push_grouped_mesh(state, pulled, lr)

    def _overlap_macro(self, state: W2VState, parts, lr: float):
        """The pipelined macro-step over the grouped plane's substeps
        ``parts`` (``(centers, windows, pools, seed)`` each): the ``depth`` =
        ``min(overlap, t)`` first pulls, then substep ``i + depth``'s pull
        against the tables before substep ``i``'s push, so substep ``i``
        reads rows that miss the last ``depth`` substeps' updates
        (stale-by-depth async SGD, the reference worker's outstanding pulls,
        ``transfer.h:55-268``). The last ``depth`` pulls wrap around to the
        first substeps and are discarded; their collectives still run, as
        the JAX schedule's do. Returns ``(state, losses)``."""
        t = len(parts)
        depth = min(self.overlap, t)
        inflight = [self._pull_grouped_mesh(state, *parts[i]) for i in range(depth)]
        losses = []
        for i in range(t):
            inflight.append(self._pull_grouped_mesh(state, *parts[(i + depth) % t]))
            state, loss = self._push_grouped_mesh(state, inflight.pop(0), lr)
            losses.append(loss)
        return state, losses

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
        one substep whose length is not a multiple of the substeps. Under a
        mesh the batch is this data shard's (:meth:`local_batch`: its part
        of each substep, in order) and the loss is summed over ``data``.
        With ``push_mode: bucketed`` the metrics carry ``push_dropped``,
        else under a mesh with ``dedup: 1`` ``dedup_dropped``: the call's
        overflowed rows, an int32 device scalar, the same on every rank.
        The grouped plane under a mesh with ``overlap`` and more than one
        substep runs :meth:`_overlap_macro`.
        """
        centers, contexts = batch["centers"], batch["contexts"]
        d = self._data()
        n = centers.shape[0] * d
        t = max(n // self.batch_size, 1)
        b = n // t
        if (t > 1 and t * b != n) or b % d:
            # the JAX package's reshape to (t, b) refuses such a batch too
            raise ValueError(f"a batch of {n} items does not split into {t} substeps "
                             f"of {b} over {d} data shards (batch_size {self.batch_size})")
        b //= d
        lr = self.step_lr(batch)
        if self.grouped and self.mesh is not None:
            # the grouped collective plane (resident: 1 has no mesh meaning)
            substep = self._substep_grouped_mesh
        elif self.grouped:
            substep = self._substep_grouped
        elif self.fused and self.mesh is not None:
            # flat fused has no collective plane; under a mesh the pooled
            # packed substep is its equivalent (the JAX trainer's route)
            substep = self._substep_packed
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
        given = [None if negs is None else negs[i * r:(i + 1) * r] for i in range(t)]
        # injected dither seeds, one a substep (tests pass the JAX trainer's)
        seeds = batch.get("comm_seeds")
        seeds = [None if seeds is None else seeds[i] for i in range(t)]
        self._drops = []
        try:
            if substep == self._substep_grouped_mesh and self.overlap and t > 1:
                # each substep's pools (and dither seed) drawn in order, as
                # the substeps would
                parts = []
                for i in range(t):
                    pools = self._grouped_pools(generator, n // t, given[i])
                    parts.append((centers[i * b:(i + 1) * b], contexts[i * b:(i + 1) * b],
                                  pools, self._comm_seed(generator, seeds[i])))
                state, losses = self._overlap_macro(state, parts, lr)
            else:
                losses = []
                for i in range(t):
                    sl = slice(i * b, (i + 1) * b)
                    planned = {} if given[i] is None else {"negs": given[i]}
                    if self.mesh is not None:
                        planned["seed"] = seeds[i]
                    state, loss = substep(state, centers[sl], contexts[sl], generator,
                                          lr, **planned)
                    losses.append(loss)
            drops = self._drops
        finally:
            self._drops = None
        loss = torch.stack(losses).mean()
        if self.mesh is not None:  # each shard's part of the global mean
            loss = transfer.all_reduce(self.mesh, loss.reshape(1), DATA_AXIS)[0]
        metrics = {"loss": loss}
        meshed = self.mesh is not None
        if self.push_mode == "bucketed" or (meshed and (self.dedup or self.placement_cut)):
            dropped = (torch.stack(drops).sum().to(torch.int32) if drops
                       else torch.zeros((), dtype=torch.int32, device=loss.device))
            key = ("push_dropped" if self.push_mode == "bucketed" else
                   "dedup_dropped" if self.dedup else "hybrid_dropped")
            metrics[key] = dropped
        return state, metrics

    def substeps_of(self, batch: Dict) -> int:
        return max(batch["centers"].shape[0] // self.batch_size, 1)

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
          ``neg_mode: per_pair``) ``6 b K d + 8 b d``;
        * ``total_bytes``, under a mesh: the wire bytes of this rank's
          collectives in the step at ``comm_dtype``'s widths (the 2-D
          plane's at f32; :data:`~swiftsnails_tpu_torch.parallel.transfer.COMM`
          counts the same): a substep's two pulls and two pushes over its
          data shard's ids, and the loss's all-reduce; the dedup pull's and
          push's unique lists, the bucketed pushes' buckets and dropped
          counts, the spread pushes' f32 reduce-scatter under a codec, the
          gather of the out rows' layout, and ``overlap``'s wrapped pulls
          where those run; ``None`` on one device.
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
                "total_bytes": self._collective_bytes(t, b), "source": "analytic"}

    def _collective_bytes(self, t: int, b: int) -> Optional[int]:
        """Result bytes of a step's collectives on this rank (see
        :meth:`step_cost`): ``t`` substeps of ``b`` items (pairs, or the
        grouped plane's centers) over all data shards."""
        if self.mesh is None:
            return None
        d, model = self._data(), self.mesh.axis_size(MODEL_AXIS)
        bl = b // d
        row = -(-self.dim // 128) * 128 if self.packed else self.dim
        elem = torch.empty((), dtype=self.table_dtype).element_size()
        hyb = bool(self.placement_cut)
        # the 2-D plane's uniform collectives are f32; its hybrid twins
        # take the wire, as the JAX trainer's do
        wire = self.comm_dtype if (self.packed or hyb) else "float32"
        ids = 4
        bucketed = self.push_mode == "bucketed"

        def gathered(n):  # gradients of n rows in all, gathered over data
            return wire_bytes("gather", n, row, wire)

        def chunk_sums(n):  # the spread pushes' sums of n rows (transfer._chunk_sums)
            if wire == "float32":
                return n * row * 4
            return n * row * 4 + gathered(n)  # the f32 reduce-scatter, the narrow gather

        def head():  # a hybrid head's push (the 2-D plane's without zero, as in JAX)
            return hybrid.head_push_bytes(self.placement_cut, row, row, d, wire,
                                          zero=self.zero and self.packed)

        def push(n):  # a push of this rank's n rows, its data slice
            if bucketed:  # buckets' ids and gradients gathered; the dropped count
                cap = transfer.bucket_capacity(n, model, self.bucket_slack)
                return d * cap * ids + gathered(d * cap) + 2 * ids + (head() if hyb else 0)
            if hyb and self.packed:  # the tail's unique list: overflow count, ids, rows
                cap = self._hybrid_cap(n * d)
                return ids + d * cap * ids + gathered(d * cap) + head()
            return transfer.push_bytes(n, row, d, comm_dtype=wire) + (head() if hyb else 0)

        def pull(n):
            return transfer.pull_bytes(n, row, elem, wire)

        def pull_in(n):  # the in table's pull; a hybrid tail's is a dedup pull
            if hyb and self.packed:
                return pull(self._hybrid_cap(n * d)) + ids  # + its overflow count
            return pull(n)

        def out_bytes(out, cap):  # a hybrid out table's spread pull and push
            pushed = (chunk_sums(d * transfer.bucket_capacity(out, model, self.bucket_slack))
                      if bucketed else chunk_sums(d * cap))
            return pull(d * cap), pushed + head()

        if self.grouped:
            cw = 2 * self.window
            out = bl * cw + (bl // self._effective_pc(b)) * self.pool_size
            # the layout's gather of every shard's window slots
            layout = d * bl * cw * ids if (self.dedup or bucketed or hyb) else 0
            pull_b = pull_in(bl) + layout
            if hyb:
                pull_o, push_o = out_bytes(out, self._out_u_cap(b, d * out, True))
                pull_b += pull_o
            elif self.dedup:
                cap = self._out_u_cap(b, d * out, False)
                pull_b += pull(d * cap)
                push_o = (chunk_sums(d * transfer.bucket_capacity(out, model, self.bucket_slack))
                          if bucketed else chunk_sums(d * cap))
            else:
                pull_b += pull(out)
                push_o = (chunk_sums(d * transfer.bucket_capacity(out, model, self.bucket_slack))
                          if bucketed else transfer.push_bytes(out, row, d, comm_dtype=wire))
            # overlap: the first depth pulls and t in the loop
            pulls = t + (min(self.overlap, t) if self.overlap and t > 1 else 0)
            return pulls * pull_b + t * (push(bl) + push_o) + 4  # + the loss's all-reduce
        if self.packed and self.neg_mode == "pool":
            out = bl + (bl // self.pool_geometry(b)[0]) * self.pool_size
        else:
            out = bl * (1 + self.negatives)
        if hyb and self.packed:
            pull_o, push_o = out_bytes(out, self._hybrid_cap(d * out))
        else:
            pull_o = pull(out)
            push_o = (chunk_sums(d * transfer.bucket_capacity(out, model, self.bucket_slack))
                      if bucketed else transfer.push_bytes(out, row, d, comm_dtype=wire)
                      + (head() if hyb else 0))
        # the contexts' gather for the layout
        layout = d * bl * ids if (bucketed or (hyb and self.packed)) else 0
        per = pull_in(bl) + pull_o + push(bl) + push_o + layout
        return t * per + 4  # the loss's all-reduce

    # -- export (ServerTerminate parity: text dump of the table) -----------

    def _all_vocab_rows(self, state: W2VState) -> np.ndarray:
        """The vocabulary's input rows; under a mesh every rank gathers the
        table from its model shards (a collective: every rank calls it)."""
        table = state.in_table.table
        if self.mesh is not None:
            table = transfer.gather_table(self.mesh, table)
        ids = self._rows(torch.arange(len(self.vocab), dtype=torch.int32,
                                      device=table.device))
        vals = table.index_select(0, ids)
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
        """The text vectors (``ServerTerminate``); under a mesh every rank
        gathers the rows and rank 0 alone writes the file."""
        rows = self._all_vocab_rows(state)
        if self.mesh is not None and torch.distributed.get_rank() != 0:
            return
        rows = rows.astype(np.float64).tolist()
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
