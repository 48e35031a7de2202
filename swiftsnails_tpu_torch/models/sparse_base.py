"""Shared machinery for the sparse CTR model families (LR, FM, FFM, W&D) — the JAX package's ``models/sparse_base.py``.

Each model is a :class:`~swiftsnails_tpu_torch.framework.trainer.Trainer`
over one hashed parameter table (the reference's ``SparseTable`` with
app-specific ``Val``/``Grad`` types, survey §2.7) plus a dict of *dense*
tensors (the bias; the MLP weights for Wide & Deep) trained by a dense
optimizer. The sparse side keeps the pull -> gradient with respect to the
pulled rows -> push contract, on one of two planes, as in the JAX package:

* ``packed: 1`` (default) with a table dim of at most 128: the small-row
  packed plane (:func:`~swiftsnails_tpu_torch.parallel.store.pull_packed_small`,
  :func:`~swiftsnails_tpu_torch.parallel.store.push_packed_small`): one
  row-gather launch pulls a step's rows, and one row-kernel launch pushes
  them (``scatter_adagrad_fused_rows`` for AdaGrad, ``scatter_add_rows`` for
  SGD); duplicate keys merge their gradients before AdaGrad's accumulator
  adds the square;
* ``packed: 0``, or a table dim above 128 (FFM with many fields): the 2-D
  plane (:func:`~swiftsnails_tpu_torch.parallel.store.pull`,
  :func:`~swiftsnails_tpu_torch.parallel.store.push`), whose AdaGrad adds
  each sample's square (the per-sample accumulator).

Padding fields (``PAD = -1``) are masked out of both the forward pass and
the pushed gradients.

Under ``mesh=`` (a :class:`~swiftsnails_tpu_torch.parallel.mesh.Mesh`, as
the JAX trainer takes a ``jax.sharding.Mesh``) the table is sharded over
``model`` and the batch over ``data``: each rank trains its
:meth:`~swiftsnails_tpu_torch.framework.trainer.Trainer.local_batch` of the
global batch, and the planes are the collectives of
:mod:`swiftsnails_tpu_torch.parallel.transfer`. The packed plane stays on
(:func:`~swiftsnails_tpu_torch.parallel.transfer.pull_collective_packed_small`,
:func:`~swiftsnails_tpu_torch.parallel.transfer.push_collective_packed_small`:
the same row kernels, shard-local, tile-granular ownership) unless the
tile count does not divide the ``model`` axis, where it falls back to the
2-D collective plane with the JAX trainer's warning. The loss is the global
mean, as GSPMD computes it in the JAX step: each data shard's mean times
``1 / data``, summed over ``data`` with the dense gradients in one
all-reduce (the ``model`` replicas hold the same batch, so nothing is
summed over ``model``); every rank then applies the dense optimizer to the
same sum, so the replicas stay equal bit for bit. ``predict``,
``eval_auc`` and ``export_text`` pull through the collectives too: under a
mesh every rank calls them, with the same records.

The dense optimizers are ``optax.sgd`` and ``optax.adagrad`` written out on
tensors (:class:`DenseSGD`, :class:`DenseAdaGrad`); ``torch.optim.Adagrad``
is another rule (see :class:`DenseAdaGrad`).

Config keys: ``num_fields``, ``capacity``, ``learning_rate``, ``optimizer``
(``sgd`` | ``adagrad``), ``batch_size``, ``num_iters``, ``data``,
``dense_learning_rate``, ``init_scale``, ``seed``, ``packed``,
``use_native`` (the native CTR reader, default on, as in the JAX package),
``stream`` and ``rows_per_chunk`` (bounded-memory reading of ``data``),
``table_tier`` (``host``: the tiered store, :mod:`swiftsnails_tpu_torch.tiered`,
on either plane; under a mesh on this rank's shard of the cache plane, its
tiles or rows, in slot space through the plane's own collectives, and
``placement`` then resolves uniform), ``comm_dtype`` and ``comm_int4_block`` (the wire of the
small-row plane's collectives under a mesh, :mod:`swiftsnails_tpu_torch.parallel.comm`;
the push dithers with seed 0 salted by the data index, the same every
step, as the JAX trainer's does; the 2-D plane and one device keep f32).
``shard_data`` changes nothing on one process, and under a mesh every rank
reads the whole data (every rank makes the same global batch).

``placement: hybrid`` under a mesh splits the table at
``placement_head_rows`` (:meth:`_init_placement`): the head whole on every
rank (a local pull, a dense reduce over ``data`` a push: the fused
small-row AdaGrad on the packed plane, the per-sample one on the 2-D
plane), the tail model-sharded through the plane's collectives
(:mod:`swiftsnails_tpu_torch.parallel.hybrid`); ``auto`` stays uniform
(hashed ids carry no frequency order). ``optimizer_sharding: zero`` under
a mesh keeps a ``1 / data`` slice of each dense tensor's AdaGrad sums (and
of the head's slot planes) on each rank: the step reduce-scatters those
tensors' gradients, updates its slice and all-gathers the parameters
(:meth:`_zero_update`), bit for bit the replicated update on a data axis
of 2, where the two sums add the same two terms. ``dense_tp`` is Wide &
Deep's (``models/widedeep.py``).
"""

from __future__ import annotations

import contextlib
import logging
import math
from typing import Dict, Iterator, NamedTuple, Optional, Tuple

import numpy as np
import torch

from swiftsnails_tpu_torch.data.ctr import ctr_batches, iter_ctr_chunks, read_ctr
from swiftsnails_tpu_torch.data.text import byte_span
from swiftsnails_tpu_torch.framework.trainer import (
    Trainer,
    mesh_device,
)
from swiftsnails_tpu_torch.ops.hashing import hash_row, hash_row_np
from swiftsnails_tpu_torch.ops.rowdma import ROW_LANES
from swiftsnails_tpu_torch.parallel import hybrid, transfer
from swiftsnails_tpu_torch.parallel.comm import (
    all_gather,
    apply_int4_block,
    reduce_scatter_quantized,
    resolve_comm_dtype,
    scope,
)
from swiftsnails_tpu_torch.parallel.access import AdaGradAccess, SgdAccess
from swiftsnails_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, rows_per_shard
from swiftsnails_tpu_torch.parallel.zero import zero_plane_spec
from swiftsnails_tpu_torch.parallel.store import (
    PackedTableState,
    create_packed_small_table,
    create_table,
    pull,
    push,
    pull_packed_small,
    push_packed_small,
    small_group,
)
from swiftsnails_tpu_torch.utils.config import Config
from swiftsnails_tpu_torch.utils.device import DeviceLike

Dense = Dict[str, torch.Tensor]


class CTRState(NamedTuple):
    table: PackedTableState  # or TableState on the 2-D plane
    dense: Dense  # dense parameters ({} when the model has none)
    opt: Dict[str, Dense]  # the dense optimizer's state ({} for SGD)


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Numerically stable binary cross-entropy on logits (the JAX form:
    ``torch.maximum`` splits the gradient of a tie as ``jnp.maximum`` does)."""
    return (torch.maximum(logits, torch.zeros_like(logits)) - logits * labels
            + torch.log1p(torch.exp(-logits.abs())))


def auc_score(labels: np.ndarray, scores: np.ndarray) -> float:
    """Rank-based AUC (Mann-Whitney), host-side eval."""
    order = np.argsort(scores)
    ranks = np.empty_like(order, dtype=np.float64)
    ranks[order] = np.arange(1, len(scores) + 1)
    pos = labels > 0.5
    n_pos, n_neg = pos.sum(), (~pos).sum()
    if n_pos == 0 or n_neg == 0:
        return 0.5
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


class DenseSGD:
    """``optax.sgd(lr)`` on a dict of tensors: ``p + g * -lr``."""

    def __init__(self, lr: float):
        self.lr = lr

    def init(self, dense: Dense) -> Dict[str, Dense]:
        return {}

    def update(self, grads: Dense, opt: Dict[str, Dense],
               dense: Dense) -> Tuple[Dense, Dict[str, Dense]]:
        return {k: dense[k] + grads[k] * -self.lr for k in dense}, opt


class DenseAdaGrad:
    """``optax.adagrad(lr)`` on a dict of tensors (optax 0.2.6's
    ``scale_by_rss``, then the learning rate).

    The accumulator starts at ``initial_accumulator_value`` (0.1), the step
    is ``g * rsqrt(s + eps)`` with ``eps`` 1e-7 *inside* the rsqrt, and 0
    where the sum ``s`` is 0. ``torch.optim.Adagrad`` starts at 0 and adds
    its eps after the square root: another rule, not used here.
    """

    def __init__(self, lr: float, initial_accumulator_value: float = 0.1,
                 eps: float = 1e-7):
        self.lr = lr
        self.initial_accumulator_value = initial_accumulator_value
        self.eps = eps

    def init(self, dense: Dense) -> Dict[str, Dense]:
        return {"sum_of_squares": {
            k: torch.full_like(v, self.initial_accumulator_value)
            for k, v in dense.items()}}

    def update(self, grads: Dense, opt: Dict[str, Dense],
               dense: Dense) -> Tuple[Dense, Dict[str, Dense]]:
        new_dense, sums = {}, {}
        for k, p in dense.items():
            g = grads[k]
            s = g * g + opt["sum_of_squares"][k]
            inv = torch.where(s > 0, torch.rsqrt(s + self.eps), 0.0)
            new_dense[k] = p + (inv * g) * -self.lr
            sums[k] = s
        return new_dense, {"sum_of_squares": sums}




class SparseCTRTrainer(Trainer):
    """Base: one hashed table + a dict of dense tensors. Subclasses define
    ``table_dim``, ``forward(pulled, dense, mask)`` and optionally
    ``init_dense``."""

    def __init__(
        self,
        config: Config,
        mesh=None,
        data: Optional[Tuple[np.ndarray, np.ndarray]] = None,
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
        self.num_fields = cfg.get_int("num_fields")
        self.capacity = cfg.get_int("capacity", 1 << 20)
        # the small-row packed plane holds rows of at most one 128-lane tile;
        # wider ones (FFM with many fields) and packed: 0 take the 2-D plane
        self.packed = cfg.get_bool("packed", True) and self.table_dim <= ROW_LANES
        if self.packed and mesh is not None:
            # tile-granular ownership needs the tile count to divide the model
            # axis; the JAX trainer falls back to the 2-D collective plane
            g = small_group(self.table_dim)
            tiles, model = -(-self.capacity // g), mesh.axis_size(MODEL_AXIS)
            if tiles % model:
                logging.getLogger(__name__).warning(
                    "small-row tile count %d (capacity %d, %d rows/tile) not "
                    "divisible by model axis %d; using the 2-D collective "
                    "plane (pad capacity to a multiple of %d to stay packed)",
                    tiles, self.capacity, g, model, g * model)
                self.packed = False
        if mesh is not None and not self.packed:
            rows_per_shard(self.capacity, mesh)  # the model axis must divide the table
        # comm_dtype: the wire of the mesh collectives, as the JAX trainer
        # reads it; the 2-D plane's collectives keep f32 (the JAX trainer's
        # pjit pull and push there take no codec)
        self.comm_dtype = apply_int4_block(
            resolve_comm_dtype(cfg.get_str("comm_dtype", "float32")),
            cfg.get_int("comm_int4_block", 0))
        # optimizer_sharding: zero -> the dense AdaGrad sums (ZeroManager's
        # planes) and the hybrid head's slot planes sharded over data; the
        # step reduce-scatters their gradients (parallel/zero.py)
        self.zero = self.optimizer_sharding == "zero" and mesh is not None
        self.lr = cfg.get_float("learning_rate", 0.05)
        self.dense_lr = cfg.get_float("dense_learning_rate", self.lr)
        self.epochs = cfg.get_int("num_iters", 1)
        self.batch_size = cfg.get_int("batch_size", 1024)
        self.seed = cfg.get_int("seed", 0)
        # table_tier: host -> the tiered parameter store: the step's rows
        # are hashed on the host and remapped to cache slots before it
        self.tiered = cfg.get_str("table_tier", "device") == "host"
        # placement: uniform|hybrid|auto -> the head/tail split of the
        # hashed table (parallel/hybrid.py); hashed ids carry no frequency
        # order, so auto resolves to uniform
        self._init_placement(cfg)
        opt_name = cfg.get_str("optimizer", "adagrad")
        self.access = {"sgd": SgdAccess(), "adagrad": AdaGradAccess()}[opt_name]
        self.dense_opt = (DenseAdaGrad(self.dense_lr) if opt_name == "adagrad"
                          else DenseSGD(self.dense_lr))
        # stream: 1 -> bounded-memory reading: the records are never held
        # whole; batches() opens a chunked reader each epoch
        self.stream = cfg.get_bool("stream", False) and data is None
        self.use_native = cfg.get_bool("use_native", True)
        self.producer = "python"  # numpy batches of records given or parsed
        if data is not None:
            self.labels, self.feats = data
            return
        if self.use_native:
            from swiftsnails_tpu_torch.data import native

            native.require()
            self.producer = "native"
        self._data_path = cfg.get_str("data")
        if self.stream:
            self.labels = self.feats = None
        else:
            self.labels, self.feats = read_ctr(self._data_path, self.num_fields,
                                               use_native=self.use_native)

    # -- placement (the hybrid head/tail split; parallel/hybrid.py) ---------

    def _init_placement(self, cfg: Config) -> None:
        """The JAX trainer's ``_init_placement``: ``placement: hybrid`` under
        a mesh replicates the first ``placement_head_rows`` hash slots
        (default ``min(1024, capacity / 2)``), aligned down to a tile a model
        shard on the small-row plane (to the model axis on the 2-D one), and
        to the data axis too under zero; no mesh, the tier, ``auto`` and a
        cut of 0 resolve to uniform with a ``reason``."""
        from swiftsnails_tpu_torch.parallel.placement import resolve_placement

        mode = resolve_placement(cfg.get_str("placement", "uniform"))
        self.placement_cut = 0
        self.placement_decision = None
        if mode == "uniform":
            return
        log = logging.getLogger(__name__)

        def resolve_uniform(reason: str) -> None:
            log.warning("placement: %s requested but %s; staying uniform", mode, reason)
            self.placement_decision = {"mode": "uniform", "requested": mode, "cut": 0,
                                       "replicated_rows": 0, "reason": reason}

        if self.mesh is None:
            return resolve_uniform("no mesh (single device is already local)")
        if self.tiered:
            return resolve_uniform("table_tier: host already caches the hot head")
        if mode == "auto":
            return resolve_uniform("hashed row ids carry no frequency order")
        model = self.mesh.axis_size(MODEL_AXIS)
        g = small_group(self.table_dim) if self.packed else 1
        align = g * model  # head tiles on tile-granular model ownership
        if self.zero:
            # the ZeRO head push updates a 1/data slice a replica
            align = math.lcm(align, g * self._data())
        cut = cfg.get_int("placement_head_rows", 0) or min(1024, self.capacity // 2)
        cut = min(int(cut), self.capacity // 2)
        cut -= cut % align
        if cut <= 0:
            return resolve_uniform(f"head cut rounds to 0 at alignment {align}")
        self.placement_cut = cut
        self.placement_decision = {"mode": "hybrid", "requested": mode, "cut": cut,
                                   "replicated_rows": cut, "coverage": 0.0}
        log.info("placement: hybrid head cut=%d (align %d) on hashed table", cut, align)

    def placement_spec(self):
        """The table's split for ``PlacementManager`` (``None``: uniform)."""
        if not self.placement_cut:
            return None
        g = small_group(self.table_dim) if self.packed else 1
        return {"table": {"cut": self.placement_cut, "group": g}}

    # -- ZeRO (optimizer_sharding: zero; parallel/zero.py) -------------------

    def zero_planes(self, state: CTRState):
        return state.opt

    def zero_with_planes(self, state: CTRState, planes):
        return CTRState(table=state.table, dense=state.dense, opt=planes)

    def _zero_keys(self, state: CTRState):
        """The dense tensors whose AdaGrad sums this rank holds a ``1 /
        data`` slice of (``ZeroManager.adopt``): their leading dims differ."""
        if not self.zero or not state.opt:
            return []
        sums = state.opt["sum_of_squares"]
        return [k for k, p in state.dense.items()
                if p.dim() and sums[k].shape[0] != p.shape[0]]

    def _zero_update(self, state: CTRState, keys, grads: Dense) -> Tuple[Dense, Dict]:
        """ZeRO's dense update of ``keys``: their gradients reduce-scattered
        over ``data`` (each tensor's leading rows, one all-to-all for all of
        them, added in rank order), this rank's slice of each updated with
        its slice of the AdaGrad sums, the parameter slices all-gathered
        (one gather). Returns the new whole tensors and the sums' slices."""
        d, i = self._data(), self.mesh.axis_index(DATA_AXIS)
        with scope("ssn_zero_dense_update"):
            flat = torch.cat([grads[k].reshape(d, -1) for k in keys], dim=1)
            own = reduce_scatter_quantized(self.mesh, flat, DATA_AXIS, "float32")[0]
            sizes = [grads[k].numel() // d for k in keys]
            g = {k: part.reshape((-1,) + tuple(grads[k].shape[1:]))
                 for k, part in zip(keys, own.split(sizes))}
            p = {k: state.dense[k].reshape(d, -1)[i].reshape(g[k].shape) for k in keys}
            sums = {"sum_of_squares": {k: state.opt["sum_of_squares"][k] for k in keys}}
            new_p, new_sums = self.dense_opt.update(g, sums, p)
            whole = all_gather(self.mesh, torch.cat([new_p[k].reshape(1, -1) for k in keys],
                                                    dim=1), DATA_AXIS)
        out = {k: part.reshape(state.dense[k].shape)
               for k, part in zip(keys, whole.split(sizes, dim=1))}
        return out, new_sums["sum_of_squares"]

    # -- subclass API ------------------------------------------------------

    @property
    def table_dim(self) -> int:
        raise NotImplementedError

    def forward(self, pulled: torch.Tensor, dense: Dense, mask: torch.Tensor) -> torch.Tensor:
        """(pulled [B, F, dim], dense dict, mask [B, F]) -> logits [B]."""
        raise NotImplementedError

    def init_dense(self, generator: torch.Generator) -> Dense:
        return {}

    def forward_flops(self, b: int, f: int) -> int:
        """f32 flops of :meth:`forward` on ``b`` records of ``f`` fields."""
        raise NotImplementedError

    def dense_size(self) -> int:
        """Values in the dense tensors (:meth:`init_dense`): the bias."""
        return 1

    def dense_shapes(self) -> Dict[str, Tuple[int, ...]]:
        """Each dense tensor's shape as this rank holds it in a step (under
        ``dense_tp`` its model slice): the bias."""
        return {"bias": ()}

    def dense_collective_bytes(self, b: int) -> int:
        """Wire bytes of the dense side's own collectives in a step of ``b``
        records on this rank (``dense_tp``'s): none."""
        return 0

    # -- framework ---------------------------------------------------------

    def init_state(self) -> CTRState:
        """The table (under a mesh this rank's shard of it), the dense
        tensors and their optimizer state (whole on every rank)."""
        make = create_packed_small_table if self.packed else create_table
        table = make(
            self.capacity, self.table_dim, self.access, seed=self.seed,
            init_scale=self.config.get_float("init_scale", 1.0), device=self.device,
            mesh=self.mesh)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed + 17)
        dense = self.init_dense(gen)
        return CTRState(table=table, dense=dense, opt=self.dense_opt.init(dense))

    def _rows(self, feats: torch.Tensor) -> torch.Tensor:
        return hash_row(feats.clamp_min(0), self.capacity)

    def _data(self) -> int:
        """Data shards: the mesh's data axis, 1 on one device."""
        return 1 if self.mesh is None else self.mesh.axis_size(DATA_AXIS)

    def _pull_rows(self, table: PackedTableState, rows: torch.Tensor) -> torch.Tensor:
        """[N] row ids -> [N, table_dim] values (packed: one row-gather
        launch; 2-D: ``index_select``), under a mesh through the plane's
        pull collective (a collective over ``model``)."""
        if self.mesh is not None:
            if hybrid.is_hybrid(table):  # the JAX hybrid twins take the wire
                if self.packed:
                    return hybrid.pull_hybrid_packed_small(self.mesh, table, rows,
                                                           self.table_dim,
                                                           comm_dtype=self.comm_dtype)
                return hybrid.pull_hybrid(self.mesh, table, rows, comm_dtype=self.comm_dtype)
            if self.packed:
                return transfer.pull_collective_packed_small(self.mesh, table, rows,
                                                             self.table_dim,
                                                             comm_dtype=self.comm_dtype)
            return transfer.pull_collective(self.mesh, table, rows)
        if self.packed:
            return pull_packed_small(table, rows, self.table_dim)
        return pull(table, rows)

    def _push_rows(self, table: PackedTableState, rows: torch.Tensor,
                   grads: torch.Tensor, lr) -> PackedTableState:
        """Push of [N, table_dim] gradients, in place (packed: merged, one
        row-kernel launch; 2-D: the rule's sort-free ``scatter_update``),
        under a mesh through the plane's push collective."""
        if self.mesh is not None:
            if hybrid.is_hybrid(table):
                if self.packed:
                    return hybrid.push_hybrid_packed_small(
                        self.mesh, table, rows, grads, self.access, lr, self.table_dim,
                        comm_dtype=self.comm_dtype, zero=self.zero)
                return hybrid.push_hybrid(self.mesh, table, rows, grads, self.access, lr,
                                          comm_dtype=self.comm_dtype, zero=self.zero)
            if self.packed:
                # no seed: the JAX trainer's push dithers with seed 0 salted
                # by the data index, the same every step
                return transfer.push_collective_packed_small(
                    self.mesh, table, rows, grads, self.access, lr, self.table_dim,
                    comm_dtype=self.comm_dtype)
            return transfer.push_collective(self.mesh, table, rows, grads, self.access, lr)
        if self.packed:
            return push_packed_small(table, rows, grads, self.access, lr, self.table_dim)
        return push(table, rows, grads, self.access, lr)

    def _sum_over_data(self, loss: torch.Tensor, acc: torch.Tensor, grads):
        """The global loss and accuracy (each data shard's part, ``1 /
        data`` of its mean) and the dense gradients, summed over ``data`` in
        one all-reduce, so that every rank updates the dense side alike."""
        flat = torch.cat([loss.reshape(1), acc.reshape(1)] + [g.reshape(-1) for g in grads])
        transfer.all_reduce(self.mesh, flat, DATA_AXIS)
        parts = flat[2:].split([g.numel() for g in grads])
        return flat[0], flat[1], [p.view_as(g) for p, g in zip(parts, grads)]

    def batches(self) -> Iterator[Dict[str, np.ndarray]]:
        """Shuffled ``{"labels", "feats"}`` batches, as the JAX package makes
        them: over all records, or with ``stream: 1`` within each chunk of
        ``rows_per_chunk`` records (a bounded shuffle window), one generator
        for the run."""
        rng = np.random.default_rng(self.seed)
        if not self.stream:
            yield from ctr_batches(self.labels, self.feats, self.batch_size, rng,
                                   epochs=self.epochs)
            return
        rows_per_chunk = self.config.get_int("rows_per_chunk", 1 << 20)
        start, end = byte_span(self._data_path)  # one process: the whole file
        for _ in range(self.epochs):
            chunks = iter_ctr_chunks(self._data_path, self.num_fields, rows_per_chunk,
                                     start, end, use_native=self.use_native)
            try:
                for labels, feats in chunks:
                    yield from ctr_batches(labels, feats, self.batch_size, rng, epochs=1)
            finally:
                chunks.close()

    def train_step(self, state: CTRState, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None):
        """Pull, forward and backward with respect to the pulled rows and the
        dense tensors, push the masked row gradients, update the dense side.
        The table is updated in place; returns ``(state, {"loss",
        "accuracy"})`` as device tensors (no host sync). ``generator`` is
        unused: the CTR step draws nothing.

        Under a mesh the batch is this data shard's, and the step makes the
        same collectives in the same order on every rank: the pull's
        all-reduce over ``model``, the push's two all-gathers over
        ``data``, then the loss's, accuracy's and dense gradients'
        all-reduce over ``data``. Each shard's mean is scaled by ``1 /
        data`` (exact for a power of two, and 1 on a data axis of 1, where
        the step is the one-device step bit for bit), so its sum over the
        shards is the global mean and the pulled rows' gradients carry the
        global ``1 / B``."""
        feats, labels = batch["feats"], batch["labels"]
        b, f = feats.shape
        mask = feats >= 0
        # tier mode: rows were hashed on the host and remapped to cache slots
        # (padding fields hash to hash_row(0) on both paths and push only
        # mask-zeroed gradients, so parity holds bit for bit); a transparent
        # tier's batch is raw, as a resident one
        if "rows" in batch:
            rows = batch["rows"].reshape(-1)
        else:
            rows = self._rows(feats).reshape(-1)
        pulled = self._pull_rows(state.table, rows).reshape(b, f, self.table_dim)
        pulled.requires_grad_()
        dense = {k: v.detach().requires_grad_() for k, v in state.dense.items()}
        logits = self.forward(pulled, dense, mask)
        loss = bce_with_logits(logits, labels).mean()
        data = self._data()
        if data > 1:
            loss = loss * (1.0 / data)  # this data shard's part of the global mean
        dp, *dd = torch.autograd.grad(loss, [pulled, *dense.values()])
        dp = dp.masked_fill(~mask[..., None], 0)  # no pushes from padding
        self._push_rows(state.table, rows, dp.reshape(-1, self.table_dim), self.lr)
        logits, loss = logits.detach(), loss.detach()
        acc = ((logits > 0) == (labels > 0.5)).float().mean()
        grads = dict(zip(dense, dd))
        sharded = self._zero_keys(state)
        if self.mesh is not None:
            if data > 1:
                acc = acc * (1.0 / data)
            # ZeRO's tensors reduce-scatter their gradients (_zero_update);
            # the rest sum with the loss and the accuracy in one all-reduce
            rest = [k for k in grads if k not in sharded]
            loss, acc, summed = self._sum_over_data(loss, acc, [grads[k] for k in rest])
            grads.update(zip(rest, summed))
        if sharded:
            rest = [k for k in grads if k not in sharded]
            new_dense, sums = self._zero_update(state, sharded, grads)
            part, opt = self.dense_opt.update(
                {k: grads[k] for k in rest},
                {"sum_of_squares": {k: state.opt["sum_of_squares"][k] for k in rest}},
                {k: state.dense[k] for k in rest})
            new_dense.update(part)
            sums.update(opt["sum_of_squares"])
            new_dense = {k: new_dense[k] for k in state.dense}
            opt = {"sum_of_squares": {k: sums[k] for k in state.dense}}
        elif state.dense:
            new_dense, opt = self.dense_opt.update(grads, state.opt, state.dense)
        else:
            new_dense, opt = state.dense, state.opt
        return CTRState(state.table, new_dense, opt), {"loss": loss, "accuracy": acc}

    def step_cost(self, batch: Dict[str, np.ndarray]) -> Dict:
        """One step's least bytes and f32 flops on ``batch`` (the goodput
        block's numerators; see :meth:`Trainer.step_cost`):

        * bytes: each distinct row of the batch's real (non-pad) features
          read once and written once at ``table_dim`` f32 values, with as
          many accumulator values under AdaGrad; every dense tensor (and
          its AdaGrad sum) read and written once; ``labels`` and ``feats``
          read once;
        * flops: the forward pass (:meth:`forward_flops`), a backward of
          twice that, and the updates: 2 flops an element for SGD, 5 for
          AdaGrad (square, add, rsqrt, scale, add), on each distinct row's
          ``table_dim`` values and on every dense value;
        * ``total_bytes``, under a mesh: the wire bytes of this rank's
          collectives in the step, at ``comm_dtype``'s widths on the
          small-row plane (:data:`~swiftsnails_tpu_torch.parallel.transfer.COMM`
          counts the same): the pull of its data shard's ``B / data x F``
          rows, their push (ids and f32 gradients gathered over ``data``),
          and the all-reduce of the loss, the accuracy and the dense
          gradients; ``None`` on one device.
        """
        feats = np.asarray(batch["feats"])
        labels = np.asarray(batch["labels"])
        b, f = feats.shape
        distinct = np.unique(hash_row_np(feats[feats >= 0], self.capacity)).size
        adagrad = isinstance(self.access, AdaGradAccess)
        planes = 2 if adagrad else 1  # the values, and the accumulator
        per_value = 5 if adagrad else 2
        n_dense = self.dense_size()
        nbytes = (2 * 4 * planes * (distinct * self.table_dim + n_dense)
                  + feats.nbytes + labels.nbytes)
        flops = (3 * self.forward_flops(b, f)
                 + per_value * (distinct * self.table_dim + n_dense))
        total = None
        if self.mesh is not None:
            d = self._data()
            n = b // d * f
            hyb = bool(self.placement_cut)
            # the 2-D plane's uniform collectives are f32; its hybrid twins
            # take the wire, as the JAX trainer's do
            wire = self.comm_dtype if (self.packed or hyb) else "float32"
            total = (transfer.pull_bytes(n, self.table_dim, 4, wire)
                     + transfer.push_bytes(n, self.table_dim, d, comm_dtype=wire)
                     + self.dense_collective_bytes(b // d))
            if hyb:  # the head's push
                g = small_group(self.table_dim) if self.packed else 1
                row = ROW_LANES if self.packed else self.table_dim
                fused = self.packed and adagrad  # the tile's sublane 1 its sums
                per_sample = adagrad and not self.packed
                total += hybrid.head_push_bytes(
                    self.placement_cut // g, row, row * (2 if fused else 1), d, wire,
                    zero=self.zero, reduces=2 if per_sample else 1)
            # the dense gradients: the ZeRO tensors reduce-scattered and their
            # parameters gathered, the rest summed with the loss and accuracy
            shapes = self.dense_shapes()
            zeroed = {k: int(np.prod(s)) for k, s in shapes.items()
                      if self.zero and adagrad and d > 1 and zero_plane_spec(s, d)}
            rest = sum(int(np.prod(s)) for k, s in shapes.items() if k not in zeroed)
            total += 4 * (2 + rest) + 8 * sum(zeroed.values())
        return {"cost": {"flops": float(flops), "bytes_accessed": float(nbytes)},
                "total_bytes": total, "source": "analytic"}

    def table_geometry(self) -> Dict[str, Dict]:
        if self.packed:
            group, layout = small_group(self.table_dim), "packed_small"
        else:
            group, layout = 1, "dense"
        return {"table": {"layout": layout, "group": group,
                          "dim": self.table_dim, "capacity": self.capacity}}

    # -- tiered parameter store (table_tier: host; see tiered/) -------------

    def tier_spec(self):
        if not self.tiered:
            return None
        if self.packed:
            return {"table": {"layout": "packed_small",
                              "group": small_group(self.table_dim)}}
        return {"table": {"layout": "dense", "group": 1}}

    def tier_tables(self, state: CTRState):
        return {"table": state.table}

    def tier_with_tables(self, state: CTRState, tables):
        return CTRState(table=tables.get("table", state.table),
                        dense=state.dense, opt=state.opt)

    def tier_plan(self, batch, seed: int, step: int):
        """The host twin of the step's ``self._rows(feats)``
        (``hash_row_np`` equals ``hash_row`` on the clamped, non-negative
        fields). ``seed`` and ``step`` are unused — the CTR step draws
        nothing."""
        feats = np.asarray(batch["feats"])
        rows = hash_row_np(np.maximum(feats, 0), self.capacity).astype(np.int32)
        return {"table": rows.ravel()}, {"rows": rows}, {"table": ["rows"]}

    # -- eval --------------------------------------------------------------

    @torch.no_grad()
    def predict(self, state: CTRState, feats: np.ndarray) -> np.ndarray:
        """Scores of ``feats``. The rows are pulled where the table lies —
        on the host for the master state a tiered run returns — and the
        forward pass runs where the dense tensors lie. Under a mesh the pull
        is a collective: every rank calls this with the same ``feats``, or
        the others wait for ever."""
        feats = torch.from_numpy(np.ascontiguousarray(feats, dtype=np.int32))
        b, f = feats.shape
        table = state.table.head if hybrid.is_hybrid(state.table) else state.table.table
        rows = self._rows(feats.to(table.device)).reshape(-1)
        pulled = self._pull_rows(state.table, rows).reshape(b, f, self.table_dim)
        dev = next(iter(state.dense.values())).device if state.dense else self.device
        return self.forward(pulled.to(dev), state.dense,
                            feats.to(dev) >= 0).cpu().numpy()

    def eval_auc(self, state: CTRState, labels=None, feats=None, limit: int = 20000) -> float:
        """AUC of :meth:`predict` on ``labels`` / ``feats`` (default: the
        first ``limit`` records); under a mesh every rank calls it with the
        same records."""
        if labels is None:
            labels, feats = self.labels[:limit], self.feats[:limit]
        return auc_score(labels, self.predict(state, feats))

    def export_text(self, state: CTRState, path: str) -> None:
        """Dump the LOGICAL rows (G a stored tile) as ``key<TAB>v0 v1 ...``
        lines, in chunks, as the JAX package's ``export_table_text`` does.
        Under a mesh each chunk is pulled through the collective (every rank
        calls this) and the rank at the mesh's origin writes the file."""
        chunk = 65536
        dev = state.table.table.device
        writes = self.mesh is None or not any(self.mesh.coords.values())
        with open(path, "w", encoding="utf-8") if writes else contextlib.nullcontext() as f:
            for start in range(0, self.capacity, chunk):
                stop = min(start + chunk, self.capacity)
                ids = torch.arange(start, stop, dtype=torch.int32, device=dev)
                vals = self._pull_rows(state.table, ids).float().cpu().numpy()
                if not writes:
                    continue
                for key, row in zip(range(start, stop), vals):
                    f.write(f"{key}\t{' '.join(f'{x:.6f}' for x in row)}\n")
