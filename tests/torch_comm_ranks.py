"""Rank-side code of ``tests/test_torch_comm.py``: what each spawned gloo
rank runs. One spawn of 8 ranks holds both meshes: the ``(2, 4)`` mesh of
all of them and a ``(2, 2)`` mesh of ranks 0-3 (every rank makes every
group, in order). It imports no JAX, so that a spawned rank starts
quickly; the test holds its results against the JAX package."""

import os
import traceback

import numpy as np
import torch

from swiftsnails_tpu_torch import convert
from swiftsnails_tpu_torch.parallel import comm, mesh, transfer
from swiftsnails_tpu_torch.parallel.access import SgdAccess

import torch_mesh_ranks as ranks

SHAPES = {"2x2": {"data": 2, "model": 2}, "2x4": {"data": 2, "model": 4}}
WIRES = ("float32", "bfloat16", "int8", "int4", "int4/16")
SEED = 0xFFFFFFF0  # the dither seed of the pushes (a uint32 near the top)
ROWS = 8  # rows a rank of the collectives' operands
LR = 0.1
CAP, PACKED_DIM, SMALL_DIM = 64, 200, 17
N_IDS = 32  # ids of a transfer case, over the data axis
U_CAP, SLACK = 16, 0.5


def collective_inputs(shape: dict) -> dict:
    """Per-rank operands, ``[D, M, ROWS, ...]`` each, made from a seed: a
    packed ``[.., 2, 128]`` payload (dim 200, its padding lanes zero) and a
    small ``[.., 17]`` one, with an all-zero row and ``-0.0`` entries; the
    pull's owner-exclusive forms (row ``r`` nonzero on model rank ``r % M``
    only)."""
    d, m = shape["data"], shape["model"]
    rng = np.random.default_rng(3)
    packed = np.zeros((d, m, ROWS, 2, 128), np.float32)
    packed.reshape(d, m, ROWS, -1)[..., :PACKED_DIM] = (
        rng.standard_normal((d, m, ROWS, PACKED_DIM))
        * np.exp(rng.standard_normal((d, m, ROWS, 1))))
    small = (rng.standard_normal((d, m, ROWS, SMALL_DIM))
             * np.exp(rng.standard_normal((d, m, ROWS, 1)))).astype(np.float32)
    for x in (packed, small):
        x[:, :, 2] = 0.0
        x.reshape(d, m, ROWS, -1)[:, :, 5, :3] = -0.0
    owner = (np.arange(ROWS)[None, :] % m) == np.arange(m)[:, None]  # [M, ROWS]
    excl = {k: np.where(owner.reshape((1, m, ROWS) + (1,) * (x.ndim - 3)), x, 0.0)
            .astype(np.float32) for k, x in (("packed", packed), ("small", small))}
    # an owner's -0.0 stays -0.0 through the pull's sum
    excl["packed"].reshape(d, m, ROWS, -1)[:, 1 % m, 1, 7] = -0.0
    return {"packed": packed, "small": small, "excl_packed": excl["packed"],
            "excl_small": excl["small"]}


def collective_cases(m) -> dict:
    """Every quantized collective on this rank, at every wire: the pull's
    sum over ``model``, the push's gather over ``data`` (dithered and
    deterministic), and the dense sum and its scattered slice over each
    axis (dithered)."""
    inp = collective_inputs(m.shape)
    d, j = m.axis_index("data"), m.axis_index("model")
    out = {}
    for wire in WIRES:
        for kind in ("packed", "small"):
            x = torch.from_numpy(inp[kind][d, j])
            excl = torch.from_numpy(inp["excl_" + kind][d, j])
            out[(wire, kind, "psum")] = comm.psum_quantized(m, excl.clone(), "model", wire)
            out[(wire, kind, "gather")] = comm.all_gather_quantized(
                m, x, "data", wire, stochastic=True, seed=SEED)
            out[(wire, kind, "gather_det")] = comm.all_gather_quantized(m, x, "data", wire)
            for axis in ("data", "model"):
                out[(wire, kind, "sum", axis)] = comm.reduce_sum_quantized(
                    m, x.clone(), axis, wire, stochastic=True, seed=SEED)
                out[(wire, kind, "scatter", axis)] = comm.reduce_scatter_quantized(
                    m, x.clone(), axis, wire, stochastic=True, seed=SEED)
    return out


def transfer_inputs() -> dict:
    """A packed ``[64, 2, 128]`` table (dim 200), a small-row one (64 rows
    of dim 17, 4 a tile) and a 2-D ``[64, 16]`` one; 32 distinct ids
    (every push adds one gradient a row: bit for bit) and 32 with repeats;
    their gradients, a packed one's padding lanes zero."""
    rng = np.random.default_rng(7)
    packed = np.zeros((CAP, 2, 128), np.float32)
    packed.reshape(CAP, -1)[:, :PACKED_DIM] = rng.standard_normal((CAP, PACKED_DIM))
    live = (np.arange(128) % 32) < SMALL_DIM
    small = (rng.standard_normal((CAP // 4, 1, 128)) * live).astype(np.float32)
    grads = np.zeros((N_IDS, 2, 128), np.float32)
    grads.reshape(N_IDS, -1)[:, :PACKED_DIM] = (
        rng.standard_normal((N_IDS, PACKED_DIM)) * np.exp(rng.standard_normal((N_IDS, 1))))
    dup = rng.integers(0, CAP, N_IDS).astype(np.int32)
    dup[4:12] = dup[2]
    return {"packed": packed, "small": small,
            "table": rng.standard_normal((CAP, 16)).astype(np.float32),
            "distinct": rng.permutation(CAP)[:N_IDS].astype(np.int32), "dup": dup,
            "packed_grads": grads,
            "small_grads": rng.standard_normal((N_IDS, SMALL_DIM)).astype(np.float32),
            "grads2d": rng.standard_normal((N_IDS, 16)).astype(np.float32)}


# transfer case -> the ids it takes
TRANSFER_CASES = {
    "packed": "distinct", "packed_dup": "dup", "small": "distinct", "2d": "distinct",
    "dedup": "dup", "bucketed": "dup", "bucketed_2d": "dup",
    "spread_dedup": "dup", "spread_bucketed": "dup",
}


def transfer_cases(m) -> dict:
    """Every transfer collective on this rank at the int8, int4 and bf16
    wires and at f32: its pull (or ``None``), its shard after the push and
    its overflow or dropped count. The spread variants run over a layout
    of this rank's own slice, whose chunks are the ``P(data)`` operand's."""
    inp = transfer_inputs()
    sl = mesh.batch_sharding(m, N_IDS)
    g = torch.from_numpy(inp["packed_grads"][sl])
    out = {}
    for wire in ("float32", "bfloat16", "int8", "int4"):
        for case, ids in TRANSFER_CASES.items():
            r = torch.from_numpy(inp[ids][sl])
            pulled, count = None, 0
            kw = {"comm_dtype": wire}
            if case == "small":
                st = convert.table_shard_from_numpy(inp["small"], m, device="cpu")
                pulled = transfer.pull_collective_packed_small(m, st, r, SMALL_DIM, **kw)
                transfer.push_collective_packed_small(
                    m, st, r, torch.from_numpy(inp["small_grads"][sl]), SgdAccess(), LR,
                    SMALL_DIM, seed=SEED, **kw)
            elif case in ("2d", "bucketed_2d"):
                st = convert.table_shard_from_numpy(inp["table"], m, device="cpu")
                g2 = torch.from_numpy(inp["grads2d"][sl])
                if case == "2d":
                    pulled = transfer.pull_collective(m, st, r, **kw)
                    transfer.push_collective(m, st, r, g2, SgdAccess(), LR, exact=True,
                                             seed=SEED, **kw)
                else:
                    _, count = transfer.push_collective_bucketed(
                        m, st, r, g2, SgdAccess(), LR, slack=SLACK, seed=SEED, **kw)
            else:
                st = convert.table_shard_from_numpy(inp["packed"], m, device="cpu")
                if case in ("packed", "packed_dup"):
                    pulled = transfer.pull_collective_packed(m, st, r, **kw)
                    transfer.push_collective_packed(m, st, r, g, SgdAccess(), LR, seed=SEED,
                                                    **kw)
                elif case == "dedup":
                    pulled, index, count = transfer.pull_collective_packed_dedup(
                        m, st, r, U_CAP, **kw)
                    transfer.push_collective_packed_dedup(
                        m, st, r, g, SgdAccess(), LR, U_CAP, index=index, seed=SEED, **kw)
                elif case == "bucketed":
                    _, count = transfer.push_collective_packed_bucketed(
                        m, st, r, g, SgdAccess(), LR, slack=SLACK, seed=SEED, **kw)
                else:
                    layout = transfer.data_layout(m, r, torch.zeros(0, dtype=torch.int32))
                    if case == "spread_dedup":
                        pulled, index, count = transfer.pull_collective_packed_dedup_spread(
                            m, st, layout, U_CAP, **kw)
                        transfer.push_collective_packed_dedup_spread(
                            m, st, g, SgdAccess(), LR, index, seed=SEED, **kw)
                    else:
                        _, count = transfer.push_collective_packed_bucketed_spread(
                            m, st, layout, g, SgdAccess(), LR, slack=SLACK, seed=SEED, **kw)
            out[(wire, case)] = {"pull": pulled, "table": st.table.clone(),
                                 "count": int(count)}
    return out


def sub_mesh(shape: dict, rank: int, device="cpu"):
    """The mesh of ``shape`` over ranks ``[0, n)`` of the world (``n`` the
    shape's size), or ``None`` for a rank past them: every rank makes every
    line's group, in :func:`mesh.axis_groups`' order."""
    import torch.distributed as dist

    sizes = mesh.mesh_sizes(shape, int(np.prod(list(shape.values()))))
    groups = {}
    for name, lines in mesh.axis_groups(sizes).items():
        for line in lines:
            grp = dist.new_group(line)
            if rank in line:
                groups[name] = grp
    if not groups:
        return None
    where = np.argwhere(mesh.rank_grid(sizes) == rank)[0]
    return mesh.Mesh(shape=sizes, coords={k: int(i) for k, i in zip(sizes, where)},
                     groups=groups, device=torch.device(device))


def comm_worker(rank, size, init, out_dir):
    """One rank: the (2, 4) mesh of all eight, then the (2, 2) mesh of
    ranks 0-3; on each, every collective case and every transfer case."""
    import torch.distributed as dist

    out = {}
    try:
        ranks.join(rank, size, init)
        for name, shape in (("2x4", SHAPES["2x4"]), ("2x2", SHAPES["2x2"])):
            m = sub_mesh(shape, rank)
            if m is None:
                continue
            out[name] = {"coords": dict(m.coords), "collectives": collective_cases(m),
                         "transfer": transfer_cases(m)}
        dist.destroy_process_group()
    except Exception:
        out = {"error": traceback.format_exc()}
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


# -------------------------------------------- the trainers under a wire ---

MESH_WIRES = ("float32", "bfloat16", "int8", "int4")
# grouped-plane routes of torch_mesh_ranks.GROUPED_ROUTES run under each wire:
# the plain plane, the spread dedup push, the spread bucketed push (slack
# 0.05: rows dropped) and the overlap macro-step
WIRE_GROUPED = ("grouped", "dedup", "bucketed_tight", "overlap1")
WIRE_FLAT = ("packed", "perpair", "dense")  # torch_mesh_ranks.W2V_ROUTES


def _seed_batch(batch: dict, seeds, device) -> dict:
    if seeds is not None:
        batch["comm_seeds"] = torch.tensor(seeds, dtype=torch.int64, device=device)
    return batch


def _stepped(tr, state, batch):
    """One ``train_step`` audited: the state, the metrics, the audit."""
    from swiftsnails_tpu_torch.telemetry.audit import audit_step

    rep = audit_step(tr.train_step, state, batch, torch.Generator())
    state, met = rep.pop("result")
    return state, met, rep


def grouped_wire_route(m, route, wire, seeds):
    """A grouped route's calls under ``wire`` (``None``: the key unset),
    the JAX trainer's dither seeds injected (``seeds[call]``, one a
    substep): tables, losses, dropped counts, each call's counted bytes
    against ``step_cost``'s and its bytes by scope."""
    over = {} if wire is None else {"comm_dtype": wire}
    tr = ranks.grouped_trainer(route, m, **over)
    tables, calls, pools = ranks.grouped_inputs(route)
    state = convert.w2v_state_from_numpy(*tables, device=m.device, mesh=m)
    out = {"losses": [], "dropped": [], "counted": [], "scopes": []}
    for c, s in zip(calls, seeds):
        t = tr.substeps_of(c)
        batch = {k: torch.from_numpy(v).to(m.device) for k, v in tr.local_batch(c).items()}
        batch["negs"] = torch.from_numpy(np.tile(pools, (t, 1))).to(m.device)
        state, met, rep = _stepped(tr, state, _seed_batch(batch, s, m.device))
        out["losses"].append(float(met["loss"]))
        out["dropped"].append({k: int(v) for k, v in met.items() if k.endswith("_dropped")})
        out["counted"].append([rep["total_bytes"], tr.step_cost(c)["total_bytes"]])
        out["scopes"].append(rep["by_scope"])
    out["tables"] = [t.table.clone() for t in state]
    return out


def flat_wire_route(m, route, wire, seeds):
    """A flat route's steps (``torch_mesh_ranks.w2v_inputs``) under
    ``wire``, one substep a step, the JAX seeds injected."""
    over = {} if wire is None else {"comm_dtype": wire}
    tr = ranks.w2v_trainer(route, m, **over)
    tables, steps = ranks.w2v_inputs(route)
    state = convert.w2v_state_from_numpy(*tables, device=m.device, mesh=m)
    out = {"losses": [], "counted": [], "scopes": []}
    for s, seed in zip(steps, seeds):
        batch = {k: torch.from_numpy(v).to(m.device) for k, v in tr.local_batch(
            {"centers": s["centers"], "contexts": s["contexts"]}).items()}
        batch["negs"] = torch.from_numpy(s["negs"]).to(m.device)
        state, met, rep = _stepped(tr, state, _seed_batch(batch, seed, m.device))
        out["losses"].append(float(met["loss"]))
        out["counted"].append([rep["total_bytes"], tr.step_cost(s)["total_bytes"]])
        out["scopes"].append(rep["by_scope"])
    out["tables"] = [t.table.clone() for t in state]
    return out


def ctr_wire_run(m, wire):
    """Wide & Deep's steps (``torch_mesh_ranks.ctr_run``'s) under ``wire``:
    its arrays, losses and counted bytes against ``step_cost``'s."""
    tr = ranks.ctr_trainer("widedeep", m, comm_dtype=wire)
    st = ranks.ctr_start("widedeep")
    state = convert.ctr_state_from_numpy(st["table"], st["dense"], st["sums"],
                                         device=m.device, table_slots=st["slots"], mesh=m)
    losses, counted = [], []
    for b in ranks.ctr_global_batches("widedeep"):
        batch = {k: torch.from_numpy(v).to(m.device) for k, v in tr.local_batch(b).items()}
        transfer.reset_comm()
        state, met = tr.train_step(state, batch)
        losses.append(float(met["loss"]))
        counted.append([transfer.comm_bytes(), tr.step_cost(b)["total_bytes"]])
    return {"arrays": ranks.ctr_arrays(state), "losses": losses, "counted": counted}


def wire_loop(m, out_dir, rank):
    """2 steps of ``TrainLoop`` with telemetry and a ledger under int8: the
    run record's ``comm_dtype`` and ``comm_by_scope``."""
    from swiftsnails_tpu_torch.framework.trainer import TrainLoop
    from swiftsnails_tpu_torch.telemetry.ledger import Ledger

    path = os.path.join(out_dir, f"ledger{rank}.jsonl")
    tr = ranks.grouped_trainer("grouped", m, comm_dtype="int8", telemetry="1",
                               ledger_path=path, **ranks.GROUPED_LOOP)
    TrainLoop(tr, log_every=0).run(seed=0, max_steps=2)
    rec = Ledger(path).latest("run")
    return {"comm_dtype": rec.get("comm_dtype"), "comm_by_scope": rec.get("comm_by_scope")}


def wire_worker(rank, size, init, out_dir, seeds):
    """One rank of ``tests/test_torch_comm_mesh.py``: the (2, 2) mesh; every
    wired route under every wire (and the grouped and packed routes with
    the key unset), W&D under every wire, the loop's record."""
    import torch.distributed as dist

    out = {}
    try:
        ranks.join(rank, size, init)
        m = mesh.make_mesh({"data": 2, "model": 2}, device="cpu")
        out["coords"] = dict(m.coords)
        for wire in MESH_WIRES + (None,):
            for route in WIRE_GROUPED:
                if wire is None and route != "grouped":
                    continue
                out[("grouped", route, wire)] = grouped_wire_route(
                    m, route, wire, seeds[("grouped", route)])
            for route in WIRE_FLAT:
                if wire is None and route != "packed":
                    continue
                out[("flat", route, wire)] = flat_wire_route(
                    m, route, wire, seeds[("flat", route)])
            if wire is not None:
                out[("ctr", "widedeep", wire)] = ctr_wire_run(m, wire)
        out["loop"] = wire_loop(m, out_dir, rank)
        dist.destroy_process_group()
    except Exception:
        out = {"error": traceback.format_exc()}
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
