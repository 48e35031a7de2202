"""Rank-side code of the port's mesh tests (``tests/test_torch_mesh.py``,
``tests/test_torch_word2vec_mesh.py``, ``tests/test_torch_grouped_mesh.py``):
what each spawned gloo rank runs.
It imports no JAX, so that a spawned rank starts quickly; the tests hold
its results against the JAX package."""

import os
import time
import traceback

import numpy as np
import torch

from swiftsnails_tpu_torch import convert
from swiftsnails_tpu_torch.parallel import cluster, mesh, transfer
from swiftsnails_tpu_torch.parallel.access import AdaGradAccess, SgdAccess
from swiftsnails_tpu_torch.utils.config import Config

CAP, DIM, PACKED_DIM, N, LR = 64, 16, 200, 16, 0.1

# case -> (plane, access, exact)
CASES = {
    "2d_sgd": ("2d", "sgd", False),
    "2d_sgd_exact": ("2d", "sgd", True),
    "2d_adagrad": ("2d", "adagrad", False),
    "2d_adagrad_exact": ("2d", "adagrad", True),
    "packed_sgd": ("packed", "sgd", False),
}


def join(rank, size, init, via_env=False):
    """``initialize_cluster`` over the spawn's ``file://`` rendezvous (the
    rank from ``RANK``, as torch's launcher gives it, with ``via_env``)."""
    torch.set_num_threads(1)
    cfg = Config({"master_addr": init, "expected_node_num": str(size),
                  "init_timeout": "120", "device": "cpu"})
    if via_env:
        os.environ["RANK"] = str(rank)
        return cluster.initialize_cluster(cfg)
    return cluster.initialize_cluster(cfg, process_id=rank)


def inputs():
    """Whole tables (2-D with an AdaGrad accumulator, packed ``[64, 2,
    128]`` at dim 200), ids with repeats, gradients (a packed one's
    padding lanes zero)."""
    rng = np.random.default_rng(0)
    packed = np.zeros((CAP, 2, 128), np.float32)
    packed.reshape(CAP, -1)[:, :PACKED_DIM] = rng.standard_normal((CAP, PACKED_DIM))
    rows = rng.integers(0, CAP, N).astype(np.int32)
    rows[:4] = rows[4]  # a row four times over, in both data shards' ids
    grads = np.zeros((N, 2, 128), np.float32)  # zero padding lanes, as SGNS's
    grads.reshape(N, -1)[:, :PACKED_DIM] = rng.standard_normal((N, PACKED_DIM))
    return {
        "table": rng.standard_normal((CAP, DIM)).astype(np.float32),
        "accum": rng.random((CAP, DIM)).astype(np.float32),
        "packed": packed,
        "rows": rows,
        "grads": rng.standard_normal((N, DIM)).astype(np.float32),
        "packed_grads": grads,
    }


def port_access(name):
    return SgdAccess() if name == "sgd" else AdaGradAccess()


def run_cases(m, inp, device="cpu"):
    """Every case on this rank: its pull and its shard after the push."""
    out = {}
    sl = mesh.batch_sharding(m, N)
    rows = torch.from_numpy(inp["rows"][sl]).to(device)
    for case, (plane, acc, exact) in CASES.items():
        access = port_access(acc)
        if plane == "2d":
            slots = {"accum": inp["accum"]} if acc == "adagrad" else None
            st = convert.table_shard_from_numpy(inp["table"], m, slots, device=device)
            pulled = transfer.pull_collective(m, st, rows)
            grads = torch.from_numpy(inp["grads"][sl]).to(device)
            transfer.push_collective(m, st, rows, grads, access, LR, exact=exact)
        else:
            st = convert.table_shard_from_numpy(inp["packed"], m, device=device)
            pulled = transfer.pull_collective_packed(m, st, rows)
            grads = torch.from_numpy(inp["packed_grads"][sl]).to(device)
            transfer.push_collective_packed(m, st, rows, grads, access, LR)
        out[case] = {"pull": pulled.cpu(), "table": st.table.cpu(),
                     "slots": {k: v.cpu() for k, v in st.slots.items()}}
    return out


def mesh_worker(rank, size, init, out_dir, shape, via_env):
    """One rank of a mesh test: join, make the mesh, run every case on
    :func:`inputs` (made here: a spawn's arguments pass through a pipe
    that holds 64 KiB, and a larger one makes each rank wait for the one
    before it to start), the barrier twice."""
    import torch.distributed as dist

    out = {}
    try:
        joined = join(rank, size, init, via_env)
        m = mesh.make_mesh(shape, device="cpu")
        out["joined"] = joined
        out["info"] = list(cluster.process_info())
        out["coords"] = dict(m.coords)
        out["groups"] = {a: dist.get_process_group_ranks(g) for a, g in m.groups.items()}
        out["backend"] = dist.get_backend(m.groups["model"])
        transfer.reset_comm()
        out["cases"] = run_cases(m, inputs())
        out["comm"] = dict(transfer.COMM)
        # the barrier holds every rank until the last arrives
        if rank == 0:
            time.sleep(0.5)
        t0 = time.monotonic()
        cluster.barrier("test", timeout_s=60)
        out["barrier_wait_s"] = time.monotonic() - t0
        cluster.barrier("test", timeout_s=60)  # a second use of the name
        dist.destroy_process_group()
    except Exception:
        out = {"error": traceback.format_exc()}
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


# ------------------------------------------------------------- word2vec ---

W2V_STEPS = 3
# route -> config keys; the JAX tests' word2vec (tests/test_word2vec.py)
W2V_ROUTES = {
    "dense": {"packed": "0"},
    "packed": {},
    "perpair": {"neg_mode": "per_pair"},
    "fused": {"fused": "1"},
}
W2V_LOOP = {"steps_per_call": "2", "batch_size": "128"}  # two substeps a call


def w2v_conf(**over):
    conf = {"dim": "16", "window": "1", "negatives": "4", "learning_rate": "0.5",
            "num_iters": "2", "batch_size": "256", "subsample": "0", "seed": "0",
            "use_native": "0", "pool_size": "8", "pool_block": "64"}
    conf.update({k: str(v) for k, v in over.items()})
    return conf


def w2v_trainer(route, mesh_=None, **over):
    from swiftsnails_tpu_torch.framework.quality import paired_corpus
    from swiftsnails_tpu_torch.models.word2vec import Word2VecTrainer

    ids, vocab = paired_corpus(n_pairs=8, reps=600, seed=0)
    return Word2VecTrainer(Config(w2v_conf(**W2V_ROUTES[route], **over)), mesh=mesh_,
                           corpus_ids=ids, vocab=vocab, device="cpu")


def w2v_inputs(route):
    """A route's start tables (whole, packed or 2-D; the out table not zero,
    so that the in table moves at the first step) and its steps' global
    batches and injected negatives (pools ``[4, 8]``, or ``[256, 4]`` a
    pair)."""
    rng = np.random.default_rng(7)
    cap, dim = 16, 16
    tables = []
    for _ in range(2):
        t = (0.1 * rng.standard_normal((cap, dim))).astype(np.float32)
        if route != "dense":
            t = np.pad(t, ((0, 0), (0, 128 - dim)))[:, None, :]
        tables.append(t)
    per_pair = route in ("dense", "perpair")
    steps = []
    for _ in range(W2V_STEPS):
        steps.append({
            "centers": rng.integers(0, cap, 256).astype(np.int32),
            "contexts": rng.integers(0, cap, 256).astype(np.int32),
            "negs": rng.integers(0, cap, (256, 4) if per_pair else (4, 8)).astype(np.int32)})
    return tables, steps


def w2v_steps(tr, route, state):
    """The route's steps through ``train_step`` (each rank its part of the
    batch, the negatives whole); the losses, and for each step the
    collective bytes counted against ``step_cost``'s."""
    _, steps = w2v_inputs(route)
    losses, counted = [], []
    for s in steps:
        batch = {k: torch.from_numpy(v) for k, v in tr.local_batch(
            {"centers": s["centers"], "contexts": s["contexts"]}).items()}
        batch["negs"] = torch.from_numpy(s["negs"])
        transfer.reset_comm()
        state, m = tr.train_step(state, batch, torch.Generator())
        losses.append(float(m["loss"]))
        if tr.mesh is not None:
            counted.append([transfer.comm_bytes(), tr.step_cost(s)["total_bytes"]])
    return state, losses, counted


def w2v_loop(tr):
    """3 calls of ``TrainLoop.run`` (seed 0); the state and the losses."""
    from swiftsnails_tpu_torch.framework.trainer import TrainLoop
    from swiftsnails_tpu_torch.utils.metrics import MetricsLogger

    losses = []

    class Recorder(MetricsLogger):
        def log(self, record):
            losses.append(record["loss"])

    state = TrainLoop(tr, metrics=Recorder(), log_every=1).run(seed=0, max_steps=3)
    return state, losses


def w2v_worker(rank, size, init, out_dir, shape):
    """One rank of the meshed word2vec test: each route's steps from its
    shard of the start tables, then ``TrainLoop`` (two substeps a call) and
    ``export_text``."""
    import torch.distributed as dist

    out = {}
    try:
        join(rank, size, init)
        m = mesh.make_mesh(shape, device="cpu")
        out["coords"] = dict(m.coords)
        for route in W2V_ROUTES:
            tr = w2v_trainer(route, m)
            tables, _ = w2v_inputs(route)
            state = convert.w2v_state_from_numpy(*tables, device="cpu", mesh=m)
            state, losses, counted = w2v_steps(tr, route, state)
            out[route] = {"tables": [t.table for t in state], "losses": losses,
                          "counted": counted}
        tr = w2v_trainer("packed", m, **W2V_LOOP)
        state, losses = w2v_loop(tr)
        tr.export_text(state, os.path.join(out_dir, "vectors.txt"))
        out["loop"] = {"tables": [t.table for t in state], "losses": losses}
        dist.destroy_process_group()
    except Exception:
        out = {"error": traceback.format_exc()}
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


# ------------------------------------------------- the grouped plane ---

GROUPED_STEPS = 3
GROUPED_CAP = 1024  # capacity; the mesh's model shards hold 512 rows each
GROUPED_REPS = 1000  # pairs of the paired corpus: 2,000 tokens, 7 calls of 256
# route -> config keys on top of grouped_conf()
GROUPED_ROUTES = {
    "grouped": {},
    "dedup": {"dedup": "1"},
    "dedup_cap8": {"dedup": "1", "mesh_u_cap": "8"},
    "bucketed_tight": {"push_mode": "bucketed", "bucket_slack": "0.05"},
    "bucketed_loose": {"push_mode": "bucketed", "bucket_slack": "8.0"},
    "dedup_bucketed": {"dedup": "1", "push_mode": "bucketed", "bucket_slack": "0.05"},
    "packed_bucketed": {"fused": "0", "grouped": "0", "push_mode": "bucketed",
                        "bucket_slack": "0.25"},
    "resident": {"resident": "1", "hot_rows": "32"},
    "dedup_resident": {"dedup": "1", "resident": "1", "hot_rows": "32"},
    "overlap1": {"overlap": "1", "steps_per_call": "4"},
    "overlap2": {"overlap": "2", "steps_per_call": "4"},
}
# routes whose (2, 2) run drops nothing, so that a (1, 1) mesh gives the same
GROUPED_EXACT = ("grouped", "dedup", "bucketed_loose", "resident", "dedup_resident",
                 "overlap1", "overlap2")
GROUPED_LOOP = {"steps_per_call": "2", "batch_size": "128", "dedup": "1"}


def grouped_conf(**over):
    """The JAX grouped-mesh tests' config (``tests/test_grouped_mesh.py``),
    at window 2 and 64 centers a block, so that a data shard of a 256-center
    substep holds whole pool blocks."""
    conf = {"dim": "16", "window": "2", "negatives": "4", "learning_rate": "0.3",
            "num_iters": "2", "batch_size": "256", "subsample": "0", "seed": "0",
            "pool_size": "8", "pool_block": "64", "centers_per_block": "64",
            "fused": "1", "grouped": "1", "use_native": "0",
            "capacity": str(GROUPED_CAP)}
    conf.update({k: str(v) for k, v in over.items()})
    return conf


def grouped_trainer(route, mesh_=None, **over):
    from swiftsnails_tpu_torch.framework.quality import paired_corpus
    from swiftsnails_tpu_torch.models.word2vec import Word2VecTrainer

    ids, vocab = paired_corpus(n_pairs=GROUPED_CAP // 2, reps=GROUPED_REPS, seed=0)
    conf = grouped_conf(**{**GROUPED_ROUTES.get(route, {}), **over})
    return Word2VecTrainer(Config(conf), mesh=mesh_, corpus_ids=ids, vocab=vocab,
                           device="cpu" if mesh_ is None else mesh_.device)


def grouped_inputs(route):
    """A route's start tables (packed ``[1024, 1, 128]``, dim 16, the out
    table not zero), its calls' global batches (``t`` substeps of 256
    centers, windows of 4 slots with ``-1`` pads; pairs for
    ``packed_bucketed``) and the pools ``[4, 8]`` every substep uses."""
    rng = np.random.default_rng(11)
    tables = [np.pad((0.1 * rng.standard_normal((GROUPED_CAP, 16))).astype(np.float32),
                     ((0, 0), (0, 112)))[:, None, :] for _ in range(2)]
    t = int(GROUPED_ROUTES[route].get("steps_per_call", "1"))
    pools = rng.integers(0, GROUPED_CAP, (4, 8)).astype(np.int32)
    calls = []
    for _ in range(GROUPED_STEPS):
        n = 256 * t
        centers = rng.integers(0, GROUPED_CAP, n).astype(np.int32)
        if route == "packed_bucketed":
            contexts = rng.integers(0, GROUPED_CAP, n).astype(np.int32)
        else:
            contexts = rng.integers(0, GROUPED_CAP, (n, 4)).astype(np.int32)
            contexts[rng.random((n, 4)) < 0.25] = -1
        calls.append({"centers": centers, "contexts": contexts})
    return tables, calls, pools


def grouped_steps(tr, route, state):
    """The route's calls through ``train_step``, each rank its part of the
    batch and every substep the route's pools; the losses, the dropped
    counts, and each call's counted collective bytes against
    ``step_cost``'s."""
    _, calls, pools = grouped_inputs(route)
    losses, dropped, counted = [], [], []
    for c in calls:
        t = tr.substeps_of(c)
        batch = {k: torch.from_numpy(v).to(tr.device) for k, v in tr.local_batch(c).items()}
        batch["negs"] = torch.from_numpy(np.tile(pools, (t, 1))).to(tr.device)
        transfer.reset_comm()
        state, m = tr.train_step(state, batch, torch.Generator())
        losses.append(float(m["loss"]))
        dropped.append({k: int(v) for k, v in m.items() if k.endswith("_dropped")})
        counted.append([transfer.comm_bytes(), tr.step_cost(c)["total_bytes"]])
    return state, losses, dropped, counted


def solo_mesh(m):
    """A ``(1, 1)`` mesh of this rank alone inside the spawn's world: every
    rank makes every rank's one-rank group, in order, and keeps its own."""
    import torch.distributed as dist

    own = None
    for r in range(dist.get_world_size()):
        g = dist.new_group([r])
        if r == dist.get_rank():
            own = g
    return mesh.Mesh(shape={"data": 1, "model": 1}, coords={"data": 0, "model": 0},
                     groups={"data": own, "model": own}, device=m.device)


def grouped_route(m, route):
    tr = grouped_trainer(route, m)
    tables, _, _ = grouped_inputs(route)
    state = convert.w2v_state_from_numpy(*tables, device=m.device, mesh=m)
    state, losses, dropped, counted = grouped_steps(tr, route, state)
    return {"tables": [t.table.cpu() for t in state], "losses": losses, "dropped": dropped,
            "counted": counted}


def grouped_loop(tr):
    """3 calls of ``TrainLoop.run`` (seed 0, pools drawn from each step's
    generator); the state and the records."""
    from swiftsnails_tpu_torch.framework.trainer import TrainLoop
    from swiftsnails_tpu_torch.utils.metrics import MetricsLogger

    records = []

    class Recorder(MetricsLogger):
        def log(self, record):
            records.append(record)

    state = TrainLoop(tr, metrics=Recorder(), log_every=1).run(seed=0, max_steps=3)
    return state, records


# transfer-level cases: name -> (kind, cap or slack)
TRANSFER_CASES = {
    "dedup_pull": ("pull", 64),
    "dedup_pull_overflow": ("pull", 8),
    "dedup_push": ("push", 64),
    "dedup_push_overflow": ("push", 8),
    "dedup_push_index": ("push_index", 8),
    "bucketed_tight": ("bucketed", 0.05),
    "bucketed_loose": ("bucketed", 2.0),
}


def transfer_inputs():
    """A packed ``[1024, 2, 128]`` table (dim 200), 96 ids with repeats and
    their gradients, both split over the data axis."""
    rng = np.random.default_rng(5)
    table = np.zeros((GROUPED_CAP, 2, 128), np.float32)
    table.reshape(GROUPED_CAP, -1)[:, :200] = rng.standard_normal((GROUPED_CAP, 200))
    rows = rng.integers(0, GROUPED_CAP, 96).astype(np.int32)
    rows[10:20] = rows[3]
    grads = np.zeros((96, 2, 128), np.float32)
    grads.reshape(96, -1)[:, :200] = rng.standard_normal((96, 200))
    return table, rows, grads


def transfer_cases(m):
    """Every transfer-level case on this rank: its pull (or ``None``), its
    shard after the push, its overflow or dropped count; and the spread
    variants over this rank's own slice, which must give the same."""
    table, rows, grads = transfer_inputs()
    sl = mesh.batch_sharding(m, len(rows))
    r, g = torch.from_numpy(rows[sl]), torch.from_numpy(grads[sl])
    out = {}
    for case, (kind, arg) in TRANSFER_CASES.items():
        st = convert.table_shard_from_numpy(table, m, device="cpu")
        pulled, index = None, None
        if kind in ("pull", "push_index"):
            pulled, index, count = transfer.pull_collective_packed_dedup(m, st, r, arg)
        if kind in ("push", "push_index"):
            _, dropped = transfer.push_collective_packed_dedup(
                m, st, r, g, SgdAccess(), LR, arg, index=index)
            count = dropped if kind == "push" else count
        if kind == "bucketed":
            _, count = transfer.push_collective_packed_bucketed(
                m, st, r, g, SgdAccess(), LR, slack=arg)
        out[case] = {"pull": pulled, "table": st.table.clone(), "count": int(count),
                     "index": None if index is None else [x.clone() for x in index]}
    # the spread variants over a layout of this rank's own slice
    layout = transfer.data_layout(m, r, torch.zeros(0, dtype=torch.int32))
    st = convert.table_shard_from_numpy(table, m, device="cpu")
    vals, index, over = transfer.pull_collective_packed_dedup_spread(m, st, layout, 8)
    transfer.push_collective_packed_dedup_spread(m, st, g, SgdAccess(), LR, index)
    out["spread_dedup"] = {"pull": vals, "table": st.table.clone(), "count": int(over)}
    st = convert.table_shard_from_numpy(table, m, device="cpu")
    _, dropped = transfer.push_collective_packed_bucketed_spread(
        m, st, layout, g, SgdAccess(), LR, slack=0.05)
    out["spread_bucketed"] = {"table": st.table.clone(), "count": int(dropped)}
    return out


def grouped_worker(rank, size, init, out_dir, shape):
    """One rank of the grouped-plane test: the transfer-level cases, every
    route from its shard of the start tables, ``TrainLoop`` on the plane;
    then on a ``(1, 1)`` mesh of its own the loop and its share of the
    routes that drop nothing (route ``k`` on rank ``k % size``)."""
    import torch.distributed as dist

    out = {}
    try:
        join(rank, size, init)
        m = mesh.make_mesh(shape, device="cpu")
        out["coords"] = dict(m.coords)
        out["transfer"] = transfer_cases(m)
        for route in GROUPED_ROUTES:
            out[route] = grouped_route(m, route)
        state, records = grouped_loop(grouped_trainer("grouped", m, **GROUPED_LOOP))
        out["loop"] = {"tables": [t.table for t in state], "records": records}
        solo = solo_mesh(m)
        out["solo"] = {route: grouped_route(solo, route)
                       for k, route in enumerate(GROUPED_EXACT) if k % size == rank}
        if rank == 0:
            state, records = grouped_loop(grouped_trainer("grouped", solo, **GROUPED_LOOP))
            out["solo"]["loop"] = {"tables": [t.table for t in state], "records": records}
        dist.destroy_process_group()
    except Exception:
        out = {"error": traceback.format_exc()}
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
