"""ZeRO-style optimizer-state sharding over the data axis — the JAX
package's ``parallel/zero.py``.

``optimizer_sharding: zero`` shards the weight update (*Automatic
Cross-Replica Sharding of Weight Update Computation*, arXiv 2004.13336) of
every plane the data replicas otherwise hold and update alike:

* the dense optimizer state of the CTR trainers (the AdaGrad
  ``sum_of_squares`` of each dense tensor);
* the hybrid head's slot planes (``HybridTableState.head_slots``, the 2-D
  plane's AdaGrad ``accum`` prefix).

In the JAX package sharding is placement: a plane keeps its logical shape
and is put at ``P("data")``. Here a sharded plane is the rank's own
``1 / data`` leading slice (rows ``[i * n / data, (i + 1) * n / data)`` on
data rank ``i``), a tensor of its own. The update then runs on that slice:
the head push reduce-scatters the summed gradient, updates its rows and
all-gathers the parameter slices (``parallel/hybrid.py``); the CTR dense
update reduce-scatters the gradients of the sharded tensors, updates each
slice and all-gathers the parameters (``models/sparse_base.py``). The
values are the replicated run's: :meth:`ZeroManager.master_state` gathers
the slices back into whole planes before a checkpoint's manifest is built
and at the end of a run, so the files are an unsharded run's.

:class:`ZeroManager` has the surface of
:class:`~swiftsnails_tpu_torch.parallel.placement.PlacementManager`
(``active`` / ``adopt`` / ``master_state`` / ``summary``), and the loop,
checkpoints and resume integrate it the same way.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from swiftsnails_tpu_torch.parallel.mesh import DATA_AXIS
from swiftsnails_tpu_torch.utils.tree import map_tensors, tensor_items

log = logging.getLogger(__name__)

OPTIMIZER_SHARDING_MODES = ("none", "zero")


def resolve_optimizer_sharding(name: Optional[str]) -> str:
    name = (name or "none").lower()
    if name not in OPTIMIZER_SHARDING_MODES:
        raise ValueError(f"unknown optimizer_sharding {name!r}; expected one of "
                         f"{OPTIMIZER_SHARDING_MODES}")
    return name


def zero_plane_spec(shape: Tuple[int, ...], data: int) -> bool:
    """Whether a plane of ``shape`` shards over ``data``: its leading dim
    splits evenly (and is at least ``data``); scalars and ragged planes stay
    whole. The one predicate the manager and the trainers' updates share
    (the JAX ``zero_plane_spec``: ``P("data")`` or ``None``)."""
    shape = tuple(shape)
    if not shape:
        return False
    return shape[0] >= data and shape[0] % data == 0


def data_slice(t: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's ``1 / data`` leading slice of ``t`` (a copy)."""
    d, i = mesh.axis_size(DATA_AXIS), mesh.axis_index(DATA_AXIS)
    own = t.shape[0] // d
    return t[i * own:(i + 1) * own].clone()


def gather_data(t: torch.Tensor, mesh) -> torch.Tensor:
    """The whole plane of the data ranks' slices ``t`` (one all-gather over
    ``data``, not counted in ``COMM``: a boundary op, outside the steps)."""
    parts = [torch.empty_like(t) for _ in range(mesh.axis_size(DATA_AXIS))]
    dist.all_gather(parts, t.contiguous(), group=mesh.groups[DATA_AXIS])
    return torch.cat(parts)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class ZeroManager:
    """The ZeRO planes' lifecycle over the trainer's hooks.

    ``adopt`` replaces every shardable plane of ``trainer.zero_planes`` (and
    of each hybrid table's ``head_slots``) with this rank's slice, after
    init, restore and the placement split; ``master_state`` gathers them
    back. Both are collectives only in ``master_state`` (every rank calls
    it)."""

    def __init__(self, trainer, mesh=None):
        self.trainer = trainer
        self.mesh = mesh if mesh is not None else getattr(trainer, "mesh", None)
        self.mode = resolve_optimizer_sharding(getattr(trainer, "optimizer_sharding", "none"))
        self.decision: Dict = {}
        # key -> the whole plane's leading dim, for the planes adopt sharded
        self._whole: Dict[str, int] = {}

    @property
    def data(self) -> int:
        return self.mesh.axis_size(DATA_AXIS) if self.mesh is not None else 1

    @property
    def active(self) -> bool:
        return self.mode == "zero" and self.mesh is not None

    def _planes(self, state):
        """``(key prefix, planes)`` of every plane group: the trainer's
        optimizer planes and each hybrid table's slot planes."""
        from swiftsnails_tpu_torch.parallel.hybrid import is_hybrid

        out = []
        opt = self.trainer.zero_planes(state)
        if opt is not None:
            out.append(("opt", opt))
        for name, ts in self.trainer.tier_tables(state).items():
            if is_hybrid(ts) and ts.head_slots:
                out.append((f"table:{name}", ts.head_slots))
        return out

    def _replace(self, state, prefix: str, planes):
        if prefix == "opt":
            return self.trainer.zero_with_planes(state, planes)
        name = prefix.split(":", 1)[1]
        ts = self.trainer.tier_tables(state)[name]
        return self.trainer.tier_with_tables(state, {name: ts._replace(head_slots=planes)})

    def adopt(self, state):
        """Shard every eligible plane: this rank keeps its leading slice."""
        if not self.active:
            return state
        data = self.data
        stats = {"planes": 0, "replicated": 0, "sharded": 0}

        for prefix, planes in self._planes(state):
            def reshard(key, leaf, prefix=prefix):
                if not zero_plane_spec(leaf.shape, data):
                    return leaf
                stats["planes"] += 1
                stats["replicated"] += _nbytes(leaf)
                stats["sharded"] += _nbytes(leaf) // data
                self._whole[f"{prefix}/{key}"] = leaf.shape[0]
                return data_slice(leaf, self.mesh)

            state = self._replace(state, prefix, map_tensors(planes, reshard))
        rep, sh = stats["replicated"], stats["sharded"]
        self.decision = {
            "mode": self.mode, "devices": data, "planes": stats["planes"],
            "replicated_bytes": int(rep), "sharded_bytes_per_replica": int(sh),
            "reduction": float(rep) / float(sh) if sh else 1.0,
        }
        if stats["planes"]:
            log.info("zero: sharded %d optimizer plane(s) across data=%d "
                     "(%d -> %d bytes/replica)", stats["planes"], data, rep, sh)
        return state

    def master_state(self, state):
        """Gather the sharded planes back into whole ones (the layout an
        unsharded run has), into new tensors; the running state keeps its
        slices."""
        if not self.active:
            return state
        for prefix, planes in self._planes(state):
            def unshard(key, leaf, prefix=prefix):
                whole = self._whole.get(f"{prefix}/{key}")
                if whole is None or leaf.shape[0] == whole:
                    return leaf
                return gather_data(leaf, self.mesh)

            state = self._replace(state, prefix, map_tensors(planes, unshard))
        return state

    def sharded(self, state) -> List[Tuple[torch.Tensor, str]]:
        """``(tensor, "data")`` for each plane of ``state`` that holds this
        rank's ``1 / data`` slice (the guardrail's count of the global
        state)."""
        if not self.active:
            return []
        out = []
        for prefix, planes in self._planes(state):
            for key, leaf in tensor_items(planes):
                whole = self._whole.get(f"{prefix}/{key}")
                if whole is not None and leaf.shape[0] != whole:
                    out.append((leaf, DATA_AXIS))
        return out

    def summary(self) -> Dict:
        return dict(self.decision)
