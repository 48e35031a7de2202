"""Rank-side code of the port's mesh tests (``tests/test_torch_mesh.py``,
``tests/test_torch_word2vec_mesh.py``, ``tests/test_torch_grouped_mesh.py``,
``tests/test_torch_ctr_mesh.py``):
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
from swiftsnails_tpu_torch.utils.tree import tensor_items

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


# ------------------------------------------------------- CTR on a mesh ---

CTR_STEPS = 3
CTR_BATCH = 128
CTR_RECORDS = 1024  # 8 batches an epoch
# case -> (model, config keys on top of ctr_conf's)
CTR_CASES = {
    "widedeep": ("widedeep", {"embed_dim": "16", "hidden_dims": "16,8"}),
    "logreg": ("logreg", {"optimizer": "sgd", "learning_rate": "0.5"}),
    "fm": ("fm", {"factor_dim": "8"}),
    "ffm39": ("ffm", {"num_fields": "39", "factor_dim": "4"}),
    # 4 rows of dim 17 are one tile, which a model axis of 2 cannot split
    "widedeep_fallback": ("widedeep", {"embed_dim": "16", "hidden_dims": "16,8",
                                       "capacity": "4"}),
}
# the planes the JAX trainer picks for the cases on a (2, 2) mesh
CTR_PACKED = {"widedeep": True, "logreg": True, "fm": True, "ffm39": False,
              "widedeep_fallback": False}


def ctr_conf(case, **over):
    conf = {"num_fields": "6", "capacity": "1024", "learning_rate": "0.2",
            "optimizer": "adagrad", "batch_size": str(CTR_BATCH), "seed": "0",
            "num_iters": "4"}
    conf.update(CTR_CASES[case][1])
    conf.update({k: str(v) for k, v in over.items()})
    return conf


def ctr_data(case):
    """synth_ctr records at the case's field count, every fifth record's
    field 3 a padding field."""
    from swiftsnails_tpu_torch.data.ctr import PAD, synth_ctr

    labels, feats, _ = synth_ctr(CTR_RECORDS, int(ctr_conf(case)["num_fields"]), 50, seed=3)
    feats[::5, 3] = PAD
    return labels, feats


def ctr_trainer(case, mesh_=None, **over):
    from swiftsnails_tpu_torch.models.registry import get_model

    return get_model(CTR_CASES[case][0])(
        Config(ctr_conf(case, **over)), mesh=mesh_, data=ctr_data(case),
        device=None if mesh_ is not None else "cpu")


def ctr_global_batches(case):
    """The case's steps' global batches: consecutive records."""
    labels, feats = ctr_data(case)
    return [{"labels": labels[i * CTR_BATCH:(i + 1) * CTR_BATCH],
             "feats": feats[i * CTR_BATCH:(i + 1) * CTR_BATCH]} for i in range(CTR_STEPS)]


def ctr_solo(case):
    """The case's one-device trainer, on the plane the meshed one picks."""
    return ctr_trainer(case, packed=int(CTR_PACKED[case]))


def ctr_start(case):
    """The case's start state as whole numpy arrays: the one-device port's
    ``init_state`` (table, slots, dense, AdaGrad sums) on the plane the
    meshed trainer picks."""
    state = ctr_solo(case).init_state()
    return {"table": state.table.table.numpy(),
            "slots": {k: v.numpy() for k, v in state.table.slots.items()},
            "dense": {k: v.numpy() for k, v in state.dense.items()},
            "sums": ({k: v.numpy() for k, v in state.opt["sum_of_squares"].items()}
                     if state.opt else None)}


def ctr_arrays(state):
    """A CTR state's tensors on the host, by name (``table``, ``slot.*``,
    ``dense.*``, ``opt.*``)."""
    out = {"table": state.table.table.cpu()}
    out.update({f"slot.{k}": v.cpu() for k, v in state.table.slots.items()})
    out.update({f"dense.{k}": v.cpu() for k, v in state.dense.items()})
    if state.opt:
        out.update({f"opt.{k}": v.cpu() for k, v in state.opt["sum_of_squares"].items()})
    return out


def ctr_run(m, case, keep=False):
    """The case's steps through ``train_step`` under ``m`` from the shared
    start state (each rank its part of every global batch): its arrays,
    losses, accuracies, each step's collective bytes against
    ``step_cost``'s, and the predictions of 256 records; the trainer and
    the state too where ``keep``."""
    tr = ctr_trainer(case, m)
    st = ctr_start(case)
    state = convert.ctr_state_from_numpy(st["table"], st["dense"], st["sums"],
                                         device=m.device, table_slots=st["slots"], mesh=m)
    losses, accs, counted = [], [], []
    for b in ctr_global_batches(case):
        batch = {k: torch.from_numpy(v).to(m.device) for k, v in tr.local_batch(b).items()}
        transfer.reset_comm()
        state, met = tr.train_step(state, batch)
        losses.append(float(met["loss"]))
        accs.append(float(met["accuracy"]))
        counted.append([transfer.comm_bytes(), tr.step_cost(b)["total_bytes"]])
    _, feats = ctr_data(case)
    out = {"packed": tr.packed, "arrays": ctr_arrays(state), "losses": losses,
           "accuracies": accs, "counted": counted,
           "predict": torch.from_numpy(tr.predict(state, feats[:256]))}
    if keep:
        out.update(trainer=tr, state=state)
    return out


# small-row and 2-D transfer cases: name -> (kind, access, slack)
CTR_TRANSFER_CASES = {
    "small_pull": ("small_pull", "adagrad", None),
    "small_push_adagrad": ("small_push", "adagrad", None),
    "small_push_sgd": ("small_push", "sgd", None),
    "bucketed_sgd": ("bucketed", "sgd", 2.0),
    "bucketed_adagrad_tight": ("bucketed", "adagrad", 0.05),
}
SMALL_CAP, SMALL_DIM, CTR_IDS = 1024, 17, 96


def ctr_transfer_inputs(access):
    """A small-row table of 1,024 rows of dim 17 (4 a tile; AdaGrad's
    accumulator in the tile's sublane 1, positive), a 2-D ``[64, 8]`` table
    with a positive accumulator, 96 ids with repeats (a run of one id, as a
    padding field gives) and their gradients."""
    rng = np.random.default_rng(9)
    tiles = SMALL_CAP // 4
    live = (np.arange(128) % 32) < SMALL_DIM
    small = np.zeros((tiles, 2 if access == "adagrad" else 1, 128), np.float32)
    small[:, 0] = rng.standard_normal((tiles, 128)) * live
    if access == "adagrad":
        small[:, 1] = rng.random((tiles, 128)) * live
    rows = rng.integers(0, SMALL_CAP, CTR_IDS).astype(np.int32)
    rows[20:30] = rows[7]
    return {"small": small, "rows": rows,
            "small_grads": rng.standard_normal((CTR_IDS, SMALL_DIM)).astype(np.float32),
            "table": rng.standard_normal((CAP, 8)).astype(np.float32),
            "accum": rng.random((CAP, 8)).astype(np.float32),
            "rows2d": rng.integers(0, CAP, CTR_IDS).astype(np.int32),
            "grads2d": rng.standard_normal((CTR_IDS, 8)).astype(np.float32)}


def ctr_transfer_cases(m):
    """Every small-row and 2-D bucketed transfer case on this rank: the pull
    (or ``None``), the shard after the push, the dropped count."""
    out = {}
    sl = mesh.batch_sharding(m, CTR_IDS)
    for case, (kind, acc, slack) in CTR_TRANSFER_CASES.items():
        inp = ctr_transfer_inputs(acc)
        access = port_access(acc)
        pulled, count = None, 0
        if kind == "bucketed":
            slots = {"accum": inp["accum"]} if acc == "adagrad" else None
            st = convert.table_shard_from_numpy(inp["table"], m, slots, device="cpu")
            _, count = transfer.push_collective_bucketed(
                m, st, torch.from_numpy(inp["rows2d"][sl]),
                torch.from_numpy(inp["grads2d"][sl]), access, LR, slack=slack)
        else:
            st = convert.table_shard_from_numpy(inp["small"], m, device="cpu")
            rows = torch.from_numpy(inp["rows"][sl])
            if kind == "small_pull":
                pulled = transfer.pull_collective_packed_small(m, st, rows, SMALL_DIM)
            else:
                transfer.push_collective_packed_small(
                    m, st, rows, torch.from_numpy(inp["small_grads"][sl]), access, LR,
                    SMALL_DIM)
        out[case] = {"pull": pulled, "table": st.table.clone(), "count": int(count),
                     "slots": {k: v.clone() for k, v in st.slots.items()}}
    return out


# ------------------------------------------------ checkpoints on a mesh ---

CKPT_STEPS, CKPT_SAVE = 4, 2


def _records_loop(tr, steps, seed=0):
    """``TrainLoop.run`` to ``steps`` logging every step; the state and the
    losses by step."""
    from swiftsnails_tpu_torch.framework.trainer import TrainLoop
    from swiftsnails_tpu_torch.utils.metrics import MetricsLogger

    losses = {}

    class Recorder(MetricsLogger):
        def log(self, record):
            losses[record["step"]] = record["loss"]

    state = TrainLoop(tr, metrics=Recorder(), log_every=1).run(seed=seed, max_steps=steps)
    return state, losses


def resume_runs(make, root, steps=CKPT_STEPS, save=CKPT_SAVE):
    """``make(**keys)``'s trainer straight to ``steps``; to ``save`` with
    a checkpoint there under ``root``; then resumed (``resume: auto``) to
    ``steps``. Returns ``(straight, saved, resumed)``, each ``(state,
    losses by step)``."""
    keys = {"param_backup_root": root, "param_backup_period": save}
    straight = _records_loop(make(), steps)
    saved = _records_loop(make(**keys), save)
    resumed = _records_loop(make(resume="auto", **keys), steps)
    return straight, saved, resumed


def _tensors(state):
    return {k: t.detach().cpu().clone() for k, t in tensor_items(state)}


def checkpoint_cases(m, out_dir):
    """The checkpoint cases on this rank (every rank calls each save and
    restore): W&D and the grouped word2vec plane saved at step 2 and
    resumed to 4 beside the straight run; W&D's export after the resume; a
    corrupt copy of W&D's step 2, which every rank must reject; and a
    checkpoint written by one device (rank 0), restored onto the mesh."""
    import shutil

    import torch.distributed as dist

    from swiftsnails_tpu_torch.framework import checkpoint as ckpt

    out = {"dir": out_dir}
    wd_root = os.path.join(out_dir, "ck_widedeep")
    straight, saved, resumed = resume_runs(
        lambda **k: ctr_trainer("widedeep", m, **k), wd_root)
    out["widedeep"] = {"straight": (_tensors(straight[0]), straight[1]),
                       "saved": (_tensors(saved[0]), saved[1]),
                       "resumed": (_tensors(resumed[0]), resumed[1])}
    tr = ctr_trainer("widedeep", m)
    tr.export_text(resumed[0], os.path.join(out_dir, "widedeep_export.txt"))
    w2v_root = os.path.join(out_dir, "ck_grouped")
    straight, saved, resumed = resume_runs(
        lambda **k: grouped_trainer("grouped", m, **GROUPED_LOOP, **k), w2v_root)
    out["grouped"] = {"straight": (_tensors(straight[0]), straight[1]),
                      "saved": (_tensors(saved[0]), saved[1]),
                      "resumed": (_tensors(resumed[0]), resumed[1])}
    # a flipped byte in model shard 1's rows of the table: every rank raises
    bad = os.path.join(out_dir, "ck_bad")
    if dist.get_rank() == 0:
        shutil.copytree(os.path.join(wd_root, f"step_{CKPT_SAVE}"),
                        os.path.join(bad, f"step_{CKPT_SAVE}"))
        path = os.path.join(bad, f"step_{CKPT_SAVE}", "table.table.bin")
        with open(path, "r+b") as f:
            f.seek(os.path.getsize(path) * 3 // 4)
            byte = f.read(1)
            f.seek(-1, 1)
            f.write(bytes([byte[0] ^ 0xFF]))
    dist.barrier()
    try:
        ckpt.restore_checkpoint(bad, tr.init_state(), mesh=m)
        out["bad_error"] = None
    except ckpt.CheckpointError as e:
        out["bad_error"] = str(e)
    # one device's checkpoint onto the mesh
    one_root = os.path.join(out_dir, "ck_one")
    if dist.get_rank() == 0:
        one = ctr_trainer("widedeep").init_state()
        with torch.no_grad():
            for _, t in tensor_items(one):
                t.add_(1.0)
        ckpt.save_checkpoint(one_root, one, step=7)
        out["one_saved"] = _tensors(one)
    dist.barrier()
    out["one_restored"] = _tensors(ckpt.restore_checkpoint(one_root, tr.init_state(), mesh=m))
    return out


# ------------------------------------------------------ seqlm on a mesh ---

SEQLM_STEPS = 3
SEQLM_VOCAB = 32


def seqlm_corpus(n=3000):
    """The JAX seqlm tests' corpus: x_{t+1} = x_t + 1 mod vocab, with noise."""
    rng = np.random.default_rng(0)
    return (np.cumsum(rng.random(n) < 0.95).astype(np.int64) % SEQLM_VOCAB).astype(np.int32)


def seqlm_conf(**over):
    conf = {"seq_len": "32", "n_layers": "1", "n_heads": "2", "d_model": "32",
            "learning_rate": "0.1", "batch_size": "8", "num_iters": "8"}
    conf.update({k: str(v) for k, v in over.items()})
    return conf


def seqlm_trainer(mesh_=None, **over):
    from swiftsnails_tpu_torch.models.seqlm import SeqLMTrainer

    return SeqLMTrainer(Config(seqlm_conf(**over)), corpus_ids=seqlm_corpus(),
                        vocab_size=SEQLM_VOCAB, mesh=mesh_,
                        device=None if mesh_ is not None else "cpu")


def seqlm_steps(tr):
    """``SEQLM_STEPS`` SGD steps from the trainer's start state (each rank
    its part of every global batch): the parameters and the losses."""
    from swiftsnails_tpu_torch.models.seqlm import param_leaves

    state = tr.init_state()
    losses = []
    for _, b in zip(range(SEQLM_STEPS), tr.batches()):
        batch = {"tokens": torch.from_numpy(tr.local_batch(b)["tokens"])}
        state, met = tr.train_step(state, batch, None)
        losses.append(float(met["loss"]))
    return {"params": [p.detach().clone() for p in param_leaves(state["params"])],
            "losses": losses}


def seqlm_cases(mds, out_dir):
    """Ring and Ulysses on the (data, seq) mesh, ``SEQLM_STEPS`` SGD steps;
    adam under ring saved at step 3 and resumed to 6 beside the straight
    run."""
    from swiftsnails_tpu_torch.parallel import sequence

    sequence.reset_calls()
    out = {a: seqlm_steps(seqlm_trainer(mds, attention=a)) for a in ("ring", "ulysses")}
    out["calls"] = dict(sequence.CALLS)
    straight, _, resumed = resume_runs(
        lambda **k: seqlm_trainer(mds, attention="ring", optimizer="adam",
                                  learning_rate="0.003", **k),
        os.path.join(out_dir, "ck_seqlm"), steps=6, save=3)
    out["adam"] = {"straight": straight[1], "resumed": resumed[1]}
    return out


def ctr_mesh_worker(rank, size, init, out_dir):
    """One rank of ``tests/test_torch_ctr_mesh.py``: a ``(data 2, model 2)``
    and a ``(data 2, seq 2)`` mesh; every CTR case, the transfer cases,
    the checkpoint cases and the seqlm cases."""
    import torch.distributed as dist

    out = {}
    try:
        join(rank, size, init)
        m = mesh.make_mesh({"data": 2, "model": 2}, device="cpu")
        mds = mesh.make_mesh({"data": 2, "seq": 2}, device="cpu")
        out["coords"] = dict(m.coords)
        out["seq_coords"] = dict(mds.coords)
        out["ctr"] = {case: ctr_run(m, case) for case in CTR_CASES}
        out["transfer"] = ctr_transfer_cases(m)
        out["checkpoint"] = checkpoint_cases(m, out_dir)
        out["seqlm"] = seqlm_cases(mds, out_dir)
        dist.destroy_process_group()
    except Exception:
        out = {"error": traceback.format_exc()}
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
