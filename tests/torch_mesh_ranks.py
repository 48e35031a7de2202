"""Rank-side code of the port's mesh tests (``tests/test_torch_mesh.py``,
``tests/test_torch_word2vec_mesh.py``): what each spawned gloo rank runs.
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
