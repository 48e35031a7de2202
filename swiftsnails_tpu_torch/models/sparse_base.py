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

The dense optimizers are ``optax.sgd`` and ``optax.adagrad`` written out on
tensors (:class:`DenseSGD`, :class:`DenseAdaGrad`); ``torch.optim.Adagrad``
is another rule (see :class:`DenseAdaGrad`).

Config keys: ``num_fields``, ``capacity``, ``learning_rate``, ``optimizer``
(``sgd`` | ``adagrad``), ``batch_size``, ``num_iters``, ``data``,
``dense_learning_rate``, ``init_scale``, ``seed``, ``packed``,
``use_native`` (the native CTR reader, default on, as in the JAX package),
``stream`` and ``rows_per_chunk`` (bounded-memory reading of ``data``).
``shard_data`` changes nothing on one process. Keys that select a path the
port does not have yet raise ``NotImplementedError`` (see :data:`UNPORTED`);
``ROADMAP.md`` says when each is ported.
"""

from __future__ import annotations

from typing import Dict, Iterator, NamedTuple, Optional, Tuple

import numpy as np
import torch

from swiftsnails_tpu_torch.data.ctr import ctr_batches, iter_ctr_chunks, read_ctr
from swiftsnails_tpu_torch.data.text import byte_span
from swiftsnails_tpu_torch.framework.trainer import (
    UNPORTED_PLANE_KEYS,
    Trainer,
    _unported,
    raise_unported,
    truthy,
)
from swiftsnails_tpu_torch.ops.hashing import hash_row
from swiftsnails_tpu_torch.ops.rowdma import ROW_LANES
from swiftsnails_tpu_torch.parallel.access import AdaGradAccess, SgdAccess
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


# Keys of the JAX trainers that select a path the port does not have yet:
# key -> "is it asked for". Each raises NotImplementedError when asked for.
UNPORTED = {**UNPORTED_PLANE_KEYS, "dense_tp": truthy}


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
        """``device=None`` means the card; ``device="cpu"`` runs the kernels'
        plain versions. ``mesh`` exists for the JAX call's shape and must be
        ``None``: the port runs on one device."""
        super().__init__(config, device)
        cfg = config
        if mesh is not None:
            _unported("mesh", mesh)
        raise_unported(cfg, UNPORTED)
        # the small-row packed plane holds rows of at most one 128-lane tile;
        # wider ones (FFM with many fields) and packed: 0 take the 2-D plane
        self.packed = cfg.get_bool("packed", True) and self.table_dim <= ROW_LANES
        self.num_fields = cfg.get_int("num_fields")
        self.capacity = cfg.get_int("capacity", 1 << 20)
        self.lr = cfg.get_float("learning_rate", 0.05)
        self.dense_lr = cfg.get_float("dense_learning_rate", self.lr)
        self.epochs = cfg.get_int("num_iters", 1)
        self.batch_size = cfg.get_int("batch_size", 1024)
        self.seed = cfg.get_int("seed", 0)
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

    # -- subclass API ------------------------------------------------------

    @property
    def table_dim(self) -> int:
        raise NotImplementedError

    def forward(self, pulled: torch.Tensor, dense: Dense, mask: torch.Tensor) -> torch.Tensor:
        """(pulled [B, F, dim], dense dict, mask [B, F]) -> logits [B]."""
        raise NotImplementedError

    def init_dense(self, generator: torch.Generator) -> Dense:
        return {}

    # -- framework ---------------------------------------------------------

    def init_state(self) -> CTRState:
        make = create_packed_small_table if self.packed else create_table
        table = make(
            self.capacity, self.table_dim, self.access, seed=self.seed,
            init_scale=self.config.get_float("init_scale", 1.0), device=self.device)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed + 17)
        dense = self.init_dense(gen)
        return CTRState(table=table, dense=dense, opt=self.dense_opt.init(dense))

    def _rows(self, feats: torch.Tensor) -> torch.Tensor:
        return hash_row(feats.clamp_min(0), self.capacity)

    def _pull_rows(self, table: PackedTableState, rows: torch.Tensor) -> torch.Tensor:
        """[N] row ids -> [N, table_dim] values (packed: one row-gather
        launch; 2-D: ``index_select``)."""
        if self.packed:
            return pull_packed_small(table, rows, self.table_dim)
        return pull(table, rows)

    def _push_rows(self, table: PackedTableState, rows: torch.Tensor,
                   grads: torch.Tensor, lr) -> PackedTableState:
        """Push of [N, table_dim] gradients, in place (packed: merged, one
        row-kernel launch; 2-D: the rule's sort-free ``scatter_update``)."""
        if self.packed:
            return push_packed_small(table, rows, grads, self.access, lr, self.table_dim)
        return push(table, rows, grads, self.access, lr)

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
        unused: the CTR step draws nothing."""
        feats, labels = batch["feats"], batch["labels"]
        b, f = feats.shape
        mask = feats >= 0
        rows = self._rows(feats).reshape(-1)
        pulled = self._pull_rows(state.table, rows).reshape(b, f, self.table_dim)
        pulled.requires_grad_()
        dense = {k: v.detach().requires_grad_() for k, v in state.dense.items()}
        logits = self.forward(pulled, dense, mask)
        loss = bce_with_logits(logits, labels).mean()
        dp, *dd = torch.autograd.grad(loss, [pulled, *dense.values()])
        dp = dp.masked_fill(~mask[..., None], 0)  # no pushes from padding
        self._push_rows(state.table, rows, dp.reshape(-1, self.table_dim), self.lr)
        if state.dense:
            new_dense, opt = self.dense_opt.update(dict(zip(dense, dd)), state.opt,
                                                   state.dense)
        else:
            new_dense, opt = state.dense, state.opt
        logits = logits.detach()
        acc = ((logits > 0) == (labels > 0.5)).float().mean()
        return CTRState(state.table, new_dense, opt), {"loss": loss.detach(),
                                                       "accuracy": acc}

    def table_geometry(self) -> Dict[str, Dict]:
        if self.packed:
            group, layout = small_group(self.table_dim), "packed_small"
        else:
            group, layout = 1, "dense"
        return {"table": {"layout": layout, "group": group,
                          "dim": self.table_dim, "capacity": self.capacity}}

    # -- eval --------------------------------------------------------------

    @torch.no_grad()
    def predict(self, state: CTRState, feats: np.ndarray) -> np.ndarray:
        feats = torch.from_numpy(np.ascontiguousarray(feats, dtype=np.int32)).to(self.device)
        mask = feats >= 0
        b, f = feats.shape
        rows = self._rows(feats).reshape(-1)
        pulled = self._pull_rows(state.table, rows).reshape(b, f, self.table_dim)
        return self.forward(pulled, state.dense, mask).cpu().numpy()

    def eval_auc(self, state: CTRState, labels=None, feats=None, limit: int = 20000) -> float:
        if labels is None:
            labels, feats = self.labels[:limit], self.feats[:limit]
        return auc_score(labels, self.predict(state, feats))

    def export_text(self, state: CTRState, path: str) -> None:
        """Dump the LOGICAL rows (G a stored tile) as ``key<TAB>v0 v1 ...``
        lines, in chunks, as the JAX package's ``export_table_text`` does."""
        chunk = 65536
        dev = state.table.table.device
        with open(path, "w", encoding="utf-8") as f:
            for start in range(0, self.capacity, chunk):
                stop = min(start + chunk, self.capacity)
                ids = torch.arange(start, stop, dtype=torch.int32, device=dev)
                vals = self._pull_rows(state.table, ids).float().cpu().numpy()
                for key, row in zip(range(start, stop), vals):
                    f.write(f"{key}\t{' '.join(f'{x:.6f}' for x in row)}\n")
