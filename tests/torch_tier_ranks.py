"""Rank-side code of the port's tier-under-a-mesh tests
(``tests/test_torch_tier_mesh.py``): what each spawned gloo rank of the
file's one spawn runs on a ``(data 2, model 2)`` mesh. It imports no JAX;
the tests hold its results against the JAX package and against the port's
resident meshed runs.

Every rank records which thread called each ``torch.distributed``
collective: the loop's (the main thread) must make them all, never the
tier's flusher or the prefetch producer."""

import os
import threading
import traceback

import numpy as np
import torch

import torch_mesh_ranks as ranks
from swiftsnails_tpu_torch import convert
from swiftsnails_tpu_torch.parallel import mesh, transfer
from swiftsnails_tpu_torch.parallel.access import AdaGradAccess, SgdAccess
from swiftsnails_tpu_torch.utils.config import Config
from swiftsnails_tpu_torch.utils.tree import tensor_items

LR = 0.1
STEPS = 16  # TrainLoop steps of the parity runs (the JAX matrix test's)
FEED_STEPS = 4  # steps of the JAX-fed runs
CKPT_STEPS, CKPT_SAVE = 4, 2

# the slot collectives' case: a 2-D cache plane of 16 slots (8 a model
# shard), a packed one, slot ids with repeats, gradients
SLOT_CAP, SLOT_DIM, SLOT_N = 16, 8, 12


# --------------------------------------------------------- the collectives ---

COLLECTIVES = ("all_reduce", "all_gather", "all_to_all_single", "broadcast",
               "reduce_scatter_tensor", "all_gather_into_tensor")


def watch_collectives():
    """Wrap ``torch.distributed``'s collectives to count the calls made
    off the main thread; returns the counter dict."""
    import torch.distributed as dist

    seen = {"main": 0, "off": 0, "off_threads": []}
    main = threading.main_thread()
    for name in COLLECTIVES:
        fn = getattr(dist, name, None)
        if fn is None:
            continue

        def wrapped(*a, _fn=fn, **k):
            if threading.current_thread() is main:
                seen["main"] += 1
            else:
                seen["off"] += 1
                seen["off_threads"].append(threading.current_thread().name)
            return _fn(*a, **k)

        setattr(dist, name, wrapped)
    return seen


def slot_inputs():
    """The slot collectives' whole planes, slot ids (with repeats) and
    gradients, and an install's slots and rows."""
    rng = np.random.default_rng(5)
    packed = np.zeros((SLOT_CAP, 2, 128), np.float32)
    packed.reshape(SLOT_CAP, -1)[:, :200] = rng.standard_normal((SLOT_CAP, 200))
    slots = rng.integers(0, SLOT_CAP, SLOT_N).astype(np.int32)
    slots[:3] = slots[3]
    install = rng.permutation(SLOT_CAP)[:6].astype(np.int32)
    return {"table": rng.standard_normal((SLOT_CAP, SLOT_DIM)).astype(np.float32),
            "accum": rng.random((SLOT_CAP, SLOT_DIM)).astype(np.float32),
            "packed": packed, "slots": slots,
            "grads": rng.standard_normal((SLOT_N, SLOT_DIM)).astype(np.float32),
            "install": install,
            "rows": rng.standard_normal((6, SLOT_DIM)).astype(np.float32),
            "packed_rows": rng.standard_normal((6, 2, 128)).astype(np.float32)}


def slot_cases(m):
    """The slot collectives on this rank: the pull of this data shard's
    slots and the SGD and AdaGrad pushes (the shards after), which are the
    plane's own collectives over a cache shard in slot space, the installs
    into a 2-D and a packed shard, and the flush's read of the installed
    slots (whole on every rank)."""
    inp = slot_inputs()
    sl = mesh.batch_sharding(m, SLOT_N)
    s, g = torch.from_numpy(inp["slots"][sl]), torch.from_numpy(inp["grads"][sl])
    out = {}
    st = convert.table_shard_from_numpy(inp["table"], m, None, device="cpu")
    out["pull"] = transfer.pull_collective(m, st, s)
    transfer.push_collective(m, st, s, g, SgdAccess(), LR)
    out["push_sgd"] = st.table.clone()
    st = convert.table_shard_from_numpy(inp["table"], m, {"accum": inp["accum"]}, device="cpu")
    transfer.push_collective(m, st, s, g, AdaGradAccess(), LR)
    out["push_adagrad"] = {"table": st.table.clone(), "accum": st.slots["accum"].clone()}
    ids = torch.from_numpy(inp["install"])
    for plane, rows in (("table", "rows"), ("packed", "packed_rows")):
        shard = convert.table_shard_from_numpy(inp[plane], m, None, device="cpu").table
        transfer.scatter_slots_collective(m, shard, ids, torch.from_numpy(inp[rows]))
        out[f"install_{plane}"] = shard.clone()
        out[f"read_{plane}"] = transfer.gather_slots_collective(m, shard, ids)
    return out


# --------------------------------------------------------- word2vec runs ---

def w2v_conf(route, tier=None, **over):
    """The JAX matrix test's word2vec (``tests/test_tiered.py:161-193``)
    at sizes a data shard may split: ``packed: 0`` (16 words, dim 8,
    batch 4, 12 cache units a table) and packed+pool (64 words, pools of
    16 every 4 pairs, batch 8, 48 units a table); ``tier``: the async
    flush (0 or 1) of a tiered run, ``None`` resident."""
    c = {"dim": "8", "window": "1", "negatives": "1", "learning_rate": "0.5",
         "num_iters": "4", "subsample": "0", "seed": "0", "steps_per_call": "1",
         "use_native": "0", "lr_decay": "0"}
    if route == "dense":
        c.update(packed="0", batch_size="4")
        row, units = 8 * 4, 12
    else:
        c.update(packed="1", pool_size="16", pool_block="4", batch_size="8")
        row, units = 128 * 4, 48
    if tier is not None:
        c.update(table_tier="host", tier_async_flush=str(tier),
                 tier_hbm_budget_mb=str(2 * units * row / float(1 << 20)))
    c.update({k: str(v) for k, v in over.items()})
    return c


def w2v_corpus(route):
    from swiftsnails_tpu_torch.framework.quality import paired_corpus

    return paired_corpus(n_pairs=8 if route == "dense" else 32, reps=200, seed=0)


def w2v_trainer(route, m=None, tier=None, **over):
    from swiftsnails_tpu_torch.models.word2vec import Word2VecTrainer

    ids, vocab = w2v_corpus(route)
    return Word2VecTrainer(Config(w2v_conf(route, tier, **over)), mesh=m, corpus_ids=ids,
                           vocab=vocab, device="cpu")


def loop_run(tr, steps=STEPS):
    """``TrainLoop.run`` to ``steps``: every array (this rank's shards;
    word2vec's two tables as ``tables``), the losses, and on a tier its
    summary and slot maps; the tier flush workers it left alive."""
    from swiftsnails_tpu_torch.framework.trainer import TrainLoop
    from swiftsnails_tpu_torch.utils.metrics import MetricsLogger

    losses = []

    class Recorder(MetricsLogger):
        def log(self, record):
            losses.append(record["loss"])

    def flush_workers():
        return {t for t in threading.enumerate() if t.name == "tier-flush-worker"}

    before = flush_workers()  # fed_run's hand-made managers keep theirs
    loop = TrainLoop(tr, metrics=Recorder(), log_every=1)
    state = loop.run(seed=0, max_steps=steps)
    out = {"arrays": {k: t.clone() for k, t in tensor_items(state)}, "losses": losses,
           "flush_workers": len(flush_workers() - before)}
    if hasattr(state, "in_table"):
        out["tables"] = [t.table.clone() for t in state]
    if loop.tier is not None:
        out["summary"] = loop.tier.summary()
        out["slot_of"] = {k: t.slot_of.copy() for k, t in loop.tier.tables.items()}
        out["hand"] = {k: t.hand for k, t in loop.tier.tables.items()}
    return out


def w2v_runs(m):
    """Each word2vec plane resident and tiered (async flush off and on)."""
    return {(route, tier): loop_run(w2v_trainer(route, m, tier))
            for route in ("dense", "packed") for tier in (None, 0, 1)}


def w2v_start(route):
    """A route's whole start tables (the out table not zero)."""
    rng = np.random.default_rng(11)
    n = 16 if route == "dense" else 64
    out = []
    for _ in range(2):
        t = (0.1 * rng.standard_normal((n, 8))).astype(np.float32)
        out.append(t if route == "dense" else np.pad(t, ((0, 0), (0, 120)))[:, None, :])
    return out


def fed_run(m, route):
    """A tiered meshed run by hand (the loop's adopt, plan and remap, then
    ``train_step`` on this rank's part) from :func:`w2v_start`'s tables:
    the global batches and the plan's negatives each step (for the JAX
    step), this rank's shards after, and the losses."""
    from swiftsnails_tpu_torch.framework.trainer import step_generator
    from swiftsnails_tpu_torch.tiered import TierManager

    tr = w2v_trainer(route, m, 1)
    tm = TierManager(tr)
    state = tm.adopt(convert.w2v_state_from_numpy(*w2v_start(route), device="cpu", mesh=m))
    feed, losses = [], []
    for step, batch in zip(range(FEED_STEPS), tr.batches()):
        _, aug, _ = tr.tier_plan(batch, 0, step)
        feed.append({"centers": batch["centers"], "contexts": batch["contexts"],
                     "negs": aug["negs"]})
        state, planned = tm.prepare(state, batch, 0, step)
        dev = {k: torch.from_numpy(np.ascontiguousarray(v)) if np.ndim(v) else v
               for k, v in tr.local_batch(planned).items()}
        state, met = tr.train_step(state, dev, step_generator(0, step, tr.device))
        losses.append(float(met["loss"]))
    state = tm.shard_state(tm.master_state(state))
    return {"feed": feed, "tables": [t.table.clone() for t in state], "losses": losses,
            "evictions": tm.summary()["evictions"]}


# ---------------------------------------------------------------- W&D ---

WD_KEYS = {"num_fields": "4", "capacity": "4096", "batch_size": "64", "learning_rate": "0.1",
           "num_iters": "1", "seed": "0", "hidden_dims": "32,16", "embed_dim": "4",
           "optimizer": "adagrad"}
# of the table's 256 tiles (16 rows of table dim 5 a tile): a step of
# wd_data's touches at most 155, the 8 steps 239
WD_BUDGET_TILES = 160


def wd_data():
    """512 records of 4 fields, 200 ids a field."""
    from swiftsnails_tpu_torch.data.ctr import synth_ctr

    labels, feats, _ = synth_ctr(512, 4, 200, seed=1)
    return labels, feats


def wd_trainer(m, tiered=False):
    from swiftsnails_tpu_torch.models.registry import get_model

    keys = dict(WD_KEYS)
    if tiered:
        keys.update(table_tier="host", tier_async_flush="1",
                    tier_hbm_budget_mb=str(WD_BUDGET_TILES * 2 * 128 * 4 / float(1 << 20)))
    return get_model("widedeep")(Config(keys), mesh=m, data=wd_data())


def wd_runs(m):
    """W&D's small-row plane resident and tiered, 8 steps: every array
    (this rank's shards), the losses, the tier's summary and slot maps."""
    return {tiered: loop_run(wd_trainer(m, tiered), steps=8) for tiered in (False, True)}


# ----------------------------------------------------------- checkpoints ---

def _crcs(manifest):
    return {k: v["crc"] for k, v in manifest["arrays"].items()}


def checkpoint_cases(m, out_dir):
    """Packed+pool saved at ``CKPT_SAVE``: tiered and resident on the
    ``(2, 2)`` mesh, tiered on a ``(1, 4)`` mesh of the same ranks (no data
    axis: a one-device run's steps) and resident on one device (rank 0's):
    the manifests' CRCs; the ``(2, 2)`` tiered run resumed to
    ``CKPT_STEPS`` beside the straight one; a tiered one-device save
    (rank 0's) restored onto the ``(2, 2)`` mesh, one step."""
    import torch.distributed as dist

    from swiftsnails_tpu_torch.framework import checkpoint as ckpt

    out = {}
    wide = mesh.make_mesh({"data": 1, "model": 4}, device="cpu")
    for name, mm, tier in (("tiered", m, 1), ("resident", m, None), ("wide", wide, 1),
                           ("one", None, None), ("one_tiered", None, 1)):
        root = os.path.join(out_dir, f"ck_{name}")
        if mm is not None or dist.get_rank() == 0:
            loop_run(w2v_trainer("packed", mm, tier, param_backup_root=root,
                                 param_backup_period=CKPT_SAVE), CKPT_SAVE)
        dist.barrier()
        out[name] = _crcs(ckpt.read_manifest(root, CKPT_SAVE))
    root = os.path.join(out_dir, "ck_tiered")
    keys = {"param_backup_root": root, "param_backup_period": CKPT_SAVE}
    straight = loop_run(w2v_trainer("packed", m, 1), CKPT_STEPS)
    resumed = loop_run(w2v_trainer("packed", m, 1, resume="auto", **keys), CKPT_STEPS)
    out["resume"] = {"straight": straight["tables"], "straight_losses": straight["losses"],
                     "resumed": resumed["tables"], "resumed_losses": resumed["losses"]}
    one = os.path.join(out_dir, "ck_one_tiered")
    tr = w2v_trainer("packed", m)
    restored = ckpt.restore_checkpoint(one, tr.init_state(), step=CKPT_SAVE, mesh=m)
    saved, _ = ckpt.load_tables(one, step=CKPT_SAVE, device="cpu")
    out["restored_equal"] = all(
        torch.equal(getattr(restored, name).table,
                    convert.model_shard(saved[name]["table"], m))
        for name in ("in_table", "out_table"))
    batch = next(iter(tr.batches()))
    dev = {k: torch.from_numpy(v) if np.ndim(v) else v for k, v in tr.local_batch(batch).items()}
    _, met = tr.train_step(restored, dev, torch.Generator())
    out["restored_loss"] = float(met["loss"])
    return out


def tier_worker(rank, size, init, out_dir):
    """One rank of the shared spawn: every case above on a ``(2, 2)``
    mesh, the collectives watched."""
    import torch.distributed as dist

    out = {}
    try:
        ranks.join(rank, size, init)
        seen = watch_collectives()
        m = mesh.make_mesh({"data": 2, "model": 2}, device="cpu")
        out["coords"] = dict(m.coords)
        out["slots"] = slot_cases(m)
        out["w2v"] = w2v_runs(m)
        out["fed"] = {route: fed_run(m, route) for route in ("dense", "packed")}
        out["wd"] = wd_runs(m)
        out["checkpoint"] = checkpoint_cases(m, out_dir)
        out["threads"] = {k: v for k, v in seen.items()}
        dist.destroy_process_group()
    except Exception:
        out = {"error": traceback.format_exc()}
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))

