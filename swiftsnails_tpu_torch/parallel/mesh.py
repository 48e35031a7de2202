"""A ``(data, model)`` mesh of ``torch.distributed`` process groups — the
JAX package's ``parallel/mesh.py``.

The reference's topology is a peer table of master, server and worker
processes (``src/core/system/ServerWorkerRoute.h:14-84``). Here, as in the
JAX package, the roles dissolve into one SPMD mesh with named axes, one
rank a device:

* ``data``  — batch parallelism (the reference's M workers);
* ``model`` — table-row sharding (the reference's N servers / ``frag_num``
  hash fragments, ``src/core/parameter/hashfrag.h:30-53``): contiguous row
  ranges a rank.

The world's ranks are laid out row-major over the axes, as the JAX package
reshapes its devices, and each axis has one process group a line of the
mesh: the ranks that differ only on that axis. :class:`Mesh` holds this
rank's coordinates, its groups and its device.

The JAX package runs one controller, so a decision taken on the host is
taken once. Here each rank decides for itself, so a decision that must be
the same everywhere (the loop's guards: a guardrail trip, a corrupt tier
plane, a failed publish, the step's leased batch) is a vote first:
:func:`vote` gathers a few numbers from every rank of the mesh, one small
all-gather an axis on the loop's thread, and every rank reads the same
rows in rank order; :func:`vote_sum` and :func:`vote_any` reduce them
there. The rank at the mesh's origin (:func:`is_leader`) is the one that
writes what must be written once.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from swiftsnails_tpu_torch.utils.device import DeviceLike, resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"


@dataclass
class Mesh:
    """This rank's view of the mesh.

    ``shape``: axis name -> size, in order; ``coords``: this rank's index on
    each axis; ``groups``: axis name -> the process group of this rank's
    line along that axis; ``device``: where this rank's tensors live.
    """

    shape: Dict[str, int]
    coords: Dict[str, int]
    groups: Dict[str, object] = field(repr=False)
    device: torch.device

    def axis_size(self, axis: str) -> int:
        """The size of ``axis``, 1 for an axis the mesh does not have."""
        return self.shape.get(axis, 1)

    def axis_index(self, axis: str) -> int:
        """This rank's index on ``axis`` (``lax.axis_index``), 0 for an
        axis the mesh does not have."""
        return self.coords.get(axis, 0)


def mesh_sizes(shape: Optional[Dict[str, int]], n: int) -> Dict[str, int]:
    """Resolve ``shape`` over ``n`` ranks, with the JAX checks: at most one
    axis ``-1`` (inferred so that the product covers every rank), and the
    product must equal ``n``. Default: all ranks on ``data``, ``model`` 1."""
    if shape is None:
        shape = {DATA_AXIS: n, MODEL_AXIS: 1}
    names = list(shape.keys())
    sizes = list(shape.values())
    if sizes.count(-1) > 1:
        raise ValueError(f"at most one mesh axis may be -1, got {shape}")
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        if known == 0 or n % known != 0:
            raise ValueError(f"cannot infer -1 axis: {n} devices, shape {shape}")
        sizes[sizes.index(-1)] = n // known
    total = int(np.prod(sizes))
    if total != n:
        raise ValueError(f"mesh shape {dict(zip(names, sizes))} does not cover {n} devices")
    return dict(zip(names, sizes))


def rank_grid(sizes: Dict[str, int]) -> np.ndarray:
    """The ranks laid out row-major over the axes (``np.asarray(devices)
    .reshape(sizes)`` of the JAX package)."""
    return np.arange(int(np.prod(list(sizes.values())))).reshape(list(sizes.values()))


def axis_groups(sizes: Dict[str, int]) -> Dict[str, List[List[int]]]:
    """Axis -> its lines: each a list of the ranks that differ only on that
    axis, in the axis' order; lines in row-major order of the other axes.
    Every rank creates every group in this order."""
    grid = rank_grid(sizes)
    out = {}
    for a, name in enumerate(sizes):
        moved = np.moveaxis(grid, a, -1)
        out[name] = [list(map(int, line)) for line in moved.reshape(-1, grid.shape[a])]
    return out


def make_mesh(shape: Optional[Dict[str, int]] = None,
              device: DeviceLike = None) -> Mesh:
    """The mesh over the world of ``torch.distributed``'s default group.

    ``shape`` as :func:`mesh_sizes`. Every rank must call this, in the same
    order as its other group creations: each axis' groups are made with
    ``dist.new_group`` on every rank, line by line. ``device`` is this
    rank's device (default: the card); a rank on the card uses the current
    CUDA device. Raises without an initialized default group
    (:func:`~swiftsnails_tpu_torch.parallel.cluster.initialize_cluster`).
    """
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_mesh needs torch.distributed's default group: call "
            "parallel.cluster.initialize_cluster or dist.init_process_group first")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    rank, world = dist.get_rank(), dist.get_world_size()
    sizes = mesh_sizes(shape, world)
    where = np.argwhere(rank_grid(sizes) == rank)[0]
    coords = {name: int(i) for name, i in zip(sizes, where)}
    groups = {}
    for name, lines in axis_groups(sizes).items():
        for line in lines:
            g = dist.new_group(line)
            if rank in line:
                groups[name] = g
    return Mesh(shape=sizes, coords=coords, groups=groups, device=dev)


def table_sharding(mesh: Mesh, capacity: int, axis: str = MODEL_AXIS) -> Tuple[int, int]:
    """This rank's ``[start, end)`` rows of a ``capacity``-row table sharded
    over ``axis`` in contiguous ranges (the JAX ``P(model, None)``): the
    reference's hash fragments a server (``hashfrag.h:30-46``)."""
    per = rows_per_shard(capacity, mesh, axis)
    m = mesh.axis_index(axis)
    return m * per, (m + 1) * per


def rows_per_shard(capacity: int, mesh: Mesh, axis: str = MODEL_AXIS) -> int:
    """Rows a shard; ``capacity`` must divide by the axis (the JAX
    ``_rows_per_shard``)."""
    model = mesh.axis_size(axis)
    if capacity % model != 0:
        raise ValueError(f"capacity {capacity} not divisible by model axis {model}")
    return capacity // model


def batch_sharding(mesh: Mesh, n: int, axis: str = DATA_AXIS) -> slice:
    """This rank's slice of a batch of ``n`` items sharded over ``axis``
    (the JAX ``P(data)``); ``n`` must divide."""
    d = mesh.axis_size(axis)
    if n % d:
        raise ValueError(f"a batch of {n} does not split over data axis {d}")
    per = n // d
    i = mesh.axis_index(axis)
    return slice(i * per, (i + 1) * per)


def replicated(mesh: Mesh) -> slice:
    """A replicated array (the JAX ``P()``): every rank holds all of it."""
    return slice(None)


def gather_model(mesh: Optional[Mesh], t: torch.Tensor) -> torch.Tensor:
    """The whole table of ``t``'s model shards (one all-gather over
    ``model``, not counted in ``COMM``: a boundary op, outside the steps);
    ``t`` itself without a mesh or on a model axis of 1."""
    model = 1 if mesh is None else mesh.axis_size(MODEL_AXIS)
    if model == 1:
        return t
    parts = [torch.empty_like(t) for _ in range(model)]
    dist.all_gather(parts, t.contiguous(), group=mesh.groups[MODEL_AXIS])
    return torch.cat(parts)


def model_rows(mesh: Optional[Mesh], whole: torch.Tensor) -> torch.Tensor:
    """This rank's contiguous model shard of ``whole`` (a copy, so the
    whole table can go); ``whole`` itself without a mesh or on a model
    axis of 1."""
    model = 1 if mesh is None else mesh.axis_size(MODEL_AXIS)
    if model == 1:
        return whole
    per = whole.shape[0] // model
    m = mesh.axis_index(MODEL_AXIS)
    return whole[m * per:(m + 1) * per].clone()


def is_leader(mesh: Optional[Mesh]) -> bool:
    """Whether this rank is the mesh's origin (every coordinate 0, world
    rank 0): the one that writes the ledger, the delta log and the
    checkpoint manifest, and holds the cluster lease. True without a
    mesh."""
    return mesh is None or not any(mesh.coords.values())


def _vote_device(mesh: Mesh) -> torch.device:
    group = next(iter(mesh.groups.values()))
    return torch.device("cpu") if dist.get_backend(group) == "gloo" else mesh.device


def vote(mesh: Mesh, values) -> np.ndarray:
    """Every rank's ``values`` (a few numbers, the same count on each), as
    a ``[ranks, n]`` float64 array in the mesh's rank order (row-major over
    its axes), the same on every rank of ``mesh``: one small all-gather an
    axis, over the mesh's own groups (a mesh may cover only some of the
    world's ranks). Every rank must call it at the same point of its
    sequence of collectives, on the loop's thread."""
    rows = np.asarray(values, np.float64).reshape(1, -1)
    axes = [a for a in reversed(list(mesh.shape)) if mesh.axis_size(a) > 1]
    if not axes:  # a gather over groups of one is the identity
        return rows
    x = torch.as_tensor(rows, device=_vote_device(mesh))
    for axis in axes:
        parts = [torch.empty_like(x) for _ in range(mesh.axis_size(axis))]
        dist.all_gather(parts, x.contiguous(), group=mesh.groups[axis])
        x = torch.cat(parts)
    return x.cpu().numpy()


def vote_sum(mesh: Optional[Mesh], values) -> np.ndarray:
    """``values`` summed over every rank in rank order (float64), bit-equal
    on every rank; ``values`` itself without a mesh."""
    if mesh is None:
        return np.asarray(values, np.float64).reshape(-1)
    rows = vote(mesh, values)
    total = rows[0].copy()
    for row in rows[1:]:
        total += row
    return total


def vote_any(mesh: Optional[Mesh], flags) -> np.ndarray:
    """Each of ``flags`` true on any rank (a bool array, the same on every
    rank); ``flags`` itself without a mesh."""
    return vote_sum(mesh, np.asarray(flags, bool).astype(np.float64)) > 0


def broadcast_ints(mesh: Mesh, values, n: int) -> List[int]:
    """The leader's ``n`` integers (``values``; ignored on the other ranks)
    on every rank of ``mesh``: its row of a :func:`vote` (exact in float64
    below 2 ** 53)."""
    mine = np.asarray(values, np.float64).reshape(n) if is_leader(mesh) else np.zeros(n)
    return [int(v) for v in vote(mesh, mine)[0]] if n else []
