"""Rank-side code of the port's placement, hybrid and ZeRO tests
(``tests/test_torch_placement.py``, ``tests/test_torch_hybrid_mesh.py``,
``tests/test_torch_zero_mesh.py``): what each spawned gloo rank of their one
shared spawn runs on a ``(data 2, model 2)`` mesh. It imports no JAX; the
tests hold its results against the JAX package."""

import os
import traceback

import numpy as np
import torch

import torch_mesh_ranks as ranks
from swiftsnails_tpu_torch import convert
from swiftsnails_tpu_torch.parallel import comm, hybrid, mesh, transfer
from swiftsnails_tpu_torch.parallel.access import AdaGradAccess, SgdAccess
from swiftsnails_tpu_torch.parallel.placement import PlacementManager
from swiftsnails_tpu_torch.parallel.zero import ZeroManager, data_slice, gather_data
from swiftsnails_tpu_torch.utils.tree import tensor_items

LR = 0.1
CUT = 64  # the transfer cases' head rows (logical)
N_IDS = 96
SEED = 12345  # the codec cases' dither seed
PACKED_CAP, PACKED_DIM = 1024, 200
DENSE_CAP, DENSE_DIM = 256, 16
SMALL_CAP, SMALL_DIM = 1024, 17  # 4 rows a tile
TAIL_CAP = 24  # the packed tail's unique capacity a data shard (some overflow)

# transfer case -> (plane, access, wire, zero)
HYBRID_CASES = {
    "dense_sgd": ("dense", "sgd", "float32", False),
    "dense_sgd_int8": ("dense", "sgd", "int8", False),
    "dense_adagrad": ("dense", "adagrad", "float32", False),
    "dense_adagrad_zero": ("dense", "adagrad", "float32", True),
    "packed": ("packed", "sgd", "float32", False),
    "packed_int8": ("packed", "sgd", "int8", False),
    "packed_int4": ("packed", "sgd", "int4", False),
    "packed_zero": ("packed", "sgd", "float32", True),
    "packed_bucketed": ("bucketed", "sgd", "float32", False),
    "small": ("small", "adagrad", "float32", False),
    "small_int8": ("small", "adagrad", "int8", False),
    "small_zero": ("small", "adagrad", "float32", True),
}


def hybrid_inputs(plane):
    """A plane's whole start table (and slots), its ``N_IDS`` ids (a third
    of them head rows, with repeats) and their gradients."""
    rng = np.random.default_rng({"dense": 1, "packed": 2, "bucketed": 2, "small": 3}[plane])
    if plane in ("packed", "bucketed"):
        table = np.zeros((PACKED_CAP, 2, 128), np.float32)
        table.reshape(PACKED_CAP, -1)[:, :PACKED_DIM] = rng.standard_normal(
            (PACKED_CAP, PACKED_DIM))
        cap = PACKED_CAP
        grads = np.zeros((N_IDS, 2, 128), np.float32)
        grads.reshape(N_IDS, -1)[:, :PACKED_DIM] = rng.standard_normal((N_IDS, PACKED_DIM))
        slots = {}
    elif plane == "dense":
        table = rng.standard_normal((DENSE_CAP, DENSE_DIM)).astype(np.float32)
        slots = {"accum": rng.random((DENSE_CAP, DENSE_DIM)).astype(np.float32)}
        cap = DENSE_CAP
        grads = rng.standard_normal((N_IDS, DENSE_DIM)).astype(np.float32)
    else:
        tiles = SMALL_CAP // 4
        live = (np.arange(128) % 32) < SMALL_DIM
        table = np.zeros((tiles, 2, 128), np.float32)
        table[:, 0] = rng.standard_normal((tiles, 128)) * live
        table[:, 1] = rng.random((tiles, 128)) * live
        slots = {}
        cap = SMALL_CAP
        grads = rng.standard_normal((N_IDS, SMALL_DIM)).astype(np.float32)
    rows = rng.integers(0, cap, N_IDS).astype(np.int32)
    rows[::3] = rng.integers(0, CUT, len(rows[::3]))
    rows[10:16] = rows[4]  # a head row six times over
    rows[40:44] = rows[50]  # a tail row four times over
    return table, slots, rows, grads


def _access(name):
    return SgdAccess() if name == "sgd" else AdaGradAccess()


def hybrid_case(m, case):
    """One transfer case on this rank: split, pull, push (the head's slot
    planes cut to this rank's ``1 / data`` under zero), then the whole head,
    this rank's tail shard, its pull and the dropped count."""
    plane, acc, wire, zero = HYBRID_CASES[case]
    table, slots, rows, grads = hybrid_inputs(plane)
    slots = slots if acc == "adagrad" else {}
    sl = mesh.batch_sharding(m, N_IDS)
    r, g = torch.from_numpy(rows[sl]), torch.from_numpy(grads[sl])
    st = convert.table_shard_from_numpy(table, m, slots or None, device="cpu")
    group = 4 if plane == "small" else 1
    hs = hybrid.split_table(st, CUT, m, group)
    if zero:
        hs = hs._replace(head_slots={k: data_slice(v, m) for k, v in hs.head_slots.items()})
    access = _access(acc)
    seed = SEED if wire != "float32" else None
    dropped = 0
    transfer.reset_comm()
    if plane == "dense":
        pulled = hybrid.pull_hybrid(m, hs, r, comm_dtype=wire)
        hybrid.push_hybrid(m, hs, r, g, access, LR, comm_dtype=wire, seed=seed, zero=zero)
    elif plane == "packed":
        pulled, index, over = hybrid.pull_hybrid_packed(m, hs, r, TAIL_CAP, comm_dtype=wire)
        _, d = hybrid.push_hybrid_packed(m, hs, r, g, access, LR, TAIL_CAP, index=index,
                                         comm_dtype=wire, seed=seed, zero=zero)
        dropped = int(over) + int(d)
    elif plane == "bucketed":
        pulled = None
        _, d = hybrid.push_hybrid_packed_bucketed(m, hs, r, g, access, LR, slack=2.0,
                                                  comm_dtype=wire, seed=seed, zero=zero)
        dropped = int(d)
    else:
        pulled = hybrid.pull_hybrid_packed_small(m, hs, r, SMALL_DIM, comm_dtype=wire)
        hybrid.push_hybrid_packed_small(m, hs, r, g, access, LR, SMALL_DIM, comm_dtype=wire,
                                        seed=seed, zero=zero)
    scopes = dict(comm.SCOPES)
    out = {"pull": pulled, "head": hs.head.clone(), "tail": hs.tail.table.clone(),
           "tail_slots": {k: v.clone() for k, v in hs.tail.slots.items()},
           "head_slots_own": {k: v.clone() for k, v in hs.head_slots.items()},
           "dropped": dropped, "scopes": scopes}
    if zero:
        hs = hs._replace(head_slots={k: gather_data(v, m) for k, v in hs.head_slots.items()})
    out["head_slots"] = {k: v.clone() for k, v in hs.head_slots.items()}
    merged = hybrid.merge_table(hs, m)
    out["merged"] = {"table": merged.table.clone(),
                     "slots": {k: v.clone() for k, v in merged.slots.items()}}
    return out


def split_merge_cases(m):
    """Each plane's start table split at ``CUT`` and merged back: this
    rank's shard of both, which must be bit-equal."""
    out = {}
    for plane in ("dense", "packed", "small"):
        table, slots, _, _ = hybrid_inputs(plane)
        st = convert.table_shard_from_numpy(table, m, slots or None, device="cpu")
        before = [t.clone() for _, t in tensor_items(st)]
        hs = hybrid.split_table(st, CUT, m, 4 if plane == "small" else 1)
        merged = hybrid.merge_table(hs, m)
        out[plane] = {"before": before, "after": [t for _, t in tensor_items(merged)],
                      "head_rows": hs.head.shape[0], "tail_rows": hs.tail.table.shape[0]}
    return out


# ---------------------------------------------------- the grouped plane ---

# route -> config keys on top of torch_mesh_ranks.grouped_conf's
HYBRID_HEAD = 64
GROUPED_HYBRID = {
    "grouped": {},
    "dedup": {"dedup": "1"},
    "bucketed": {"push_mode": "bucketed", "bucket_slack": "8.0"},
    "overlap2": {"overlap": "2", "steps_per_call": "4"},
    "tight": {"placement_tail_cap": "48"},  # the tail overflows
}


def grouped_hybrid_conf(route, hybrid_on=True, **over):
    keys = dict(GROUPED_HYBRID[route])
    if hybrid_on:
        keys.update(placement="hybrid", placement_head_rows=str(HYBRID_HEAD))
    keys.update(over)
    return keys


def grouped_inputs(route):
    """The grouped routes' start tables, calls and pools
    (``torch_mesh_ranks.grouped_inputs``), ``overlap2`` at 4 substeps a
    call."""
    base = "overlap2" if route == "overlap2" else "grouped"
    return ranks.grouped_inputs(base)


def grouped_run(m, route, hybrid_on=True, **over):
    """A grouped route from the shared start tables through ``train_step``
    (the split adopted and merged back around the calls, as the loop does):
    the merged tables, the losses, the dropped counts, the collective
    bytes against ``step_cost``'s."""
    tr = ranks.grouped_trainer("grouped", m, **grouped_hybrid_conf(route, hybrid_on, **over))
    tables, calls, pools = grouped_inputs(route)
    state = convert.w2v_state_from_numpy(*tables, device=m.device, mesh=m)
    pm, zm = PlacementManager(tr, m), ZeroManager(tr, m)
    state = zm.adopt(pm.adopt(state))
    losses, dropped, counted = [], [], []
    for c in calls:
        t = tr.substeps_of(c)
        batch = {k: torch.from_numpy(v).to(m.device) for k, v in tr.local_batch(c).items()}
        batch["negs"] = torch.from_numpy(np.tile(pools, (t, 1))).to(m.device)
        transfer.reset_comm()
        state, met = tr.train_step(state, batch, torch.Generator())
        losses.append(float(met["loss"]))
        dropped.append({k: int(v) for k, v in met.items() if k.endswith("_dropped")})
        counted.append([transfer.comm_bytes(), tr.step_cost(c)["total_bytes"]])
    state = pm.master_state(zm.master_state(state))
    return {"tables": [t.table.cpu().clone() for t in state], "losses": losses,
            "dropped": dropped, "counted": counted, "cut": tr.placement_cut,
            "scopes": dict(comm.SCOPES)}


FLAT_HEAD = 8  # of the flat routes' 16 rows


def flat_run(m, route, hybrid_on=True):
    """A flat word2vec route of ``torch_mesh_ranks`` (``dense``, ``packed``,
    ``perpair``) from its start tables through ``train_step`` with the
    injected negatives, the split adopted and merged back: the merged
    tables, the losses, the collective bytes against ``step_cost``'s."""
    over = ({"placement": "hybrid", "placement_head_rows": str(FLAT_HEAD)} if hybrid_on
            else {})
    tr = ranks.w2v_trainer(route, m, **over)
    tables, _ = ranks.w2v_inputs(route)
    state = convert.w2v_state_from_numpy(*tables, device=m.device, mesh=m)
    pm = PlacementManager(tr, m)
    state, losses, counted = ranks.w2v_steps(tr, route, pm.adopt(state))
    state = pm.master_state(state)
    return {"tables": [t.table.cpu().clone() for t in state], "losses": losses,
            "counted": counted, "cut": tr.placement_cut}


def dense_loop(m, hybrid_on):
    """word2vec's 2-D plane (``packed: 0``) under ``TrainLoop``, 3 calls:
    the returned (merged) tables and losses."""
    over = {"placement": "hybrid", "placement_head_rows": "8"} if hybrid_on else {}
    state, losses = ranks.w2v_loop(ranks.w2v_trainer("dense", m, **over))
    return {"tables": [t.table.clone() for t in state], "losses": losses}


# ------------------------------------------------------------------ CTR ---

CTR_RECORDS = 1024


def ctr_conf(**over):
    """The JAX hybrid test's logreg (``tests/test_hybrid_placement.py:
    246-275``) at a cut size: 4 fields, capacity 4,096, AdaGrad."""
    conf = {"num_fields": "4", "capacity": "4096", "learning_rate": "0.2",
            "optimizer": "adagrad", "batch_size": "256", "num_iters": "1", "seed": "0"}
    conf.update({k: str(v) for k, v in over.items()})
    return conf


def ctr_data():
    from swiftsnails_tpu_torch.data.ctr import synth_ctr

    labels, feats, _ = synth_ctr(CTR_RECORDS, 4, 40, seed=3)
    return labels, feats


def ctr_loop(m, **over):
    """logreg under ``TrainLoop`` on ``m``, one epoch (4 steps): the
    returned state's tensors and the losses."""
    from swiftsnails_tpu_torch.models.registry import get_model
    from swiftsnails_tpu_torch.utils.config import Config

    tr = get_model("logreg")(Config(ctr_conf(**over)), mesh=m, data=ctr_data())
    state, losses = ranks._records_loop(tr, 10)
    return {"state": {k: t.clone() for k, t in tensor_items(state)}, "losses": losses,
            "cut": tr.placement_cut}


# W&D under zero (the JAX zero tests' shape, tests/test_zero_sharding.py:168-185)
WD_KEYS = {"num_fields": "4", "capacity": "1024", "batch_size": "64", "learning_rate": "0.1",
           "num_iters": "1", "seed": "0", "hidden_dims": "32,16", "embed_dim": "4",
           "optimizer": "adagrad", "placement": "hybrid", "placement_head_rows": "128"}


def wd_data():
    """The JAX zero tests' records: 256 of 4 fields."""
    from swiftsnails_tpu_torch.data.ctr import synth_ctr

    labels, feats, _ = synth_ctr(256, 4, 20, seed=1)
    return labels, feats


def wd_trainer(m, **over):
    from swiftsnails_tpu_torch.models.registry import get_model
    from swiftsnails_tpu_torch.utils.config import Config

    conf = {**WD_KEYS, **{k: str(v) for k, v in over.items()}}
    return get_model("widedeep")(Config(conf), mesh=m, data=wd_data(),
                                 device=None if m is not None else "cpu")


def wd_start(m, **over):
    """W&D's start state drawn on the CPU (one device's ``init_state``: a
    card's generator draws other numbers), as ``m``'s rank holds it."""
    one = wd_trainer(None, **over).init_state()
    sums = one.opt["sum_of_squares"] if one.opt else None
    return convert.ctr_state_from_numpy(
        one.table.table.numpy(), {k: v.numpy() for k, v in one.dense.items()},
        None if sums is None else {k: v.numpy() for k, v in sums.items()},
        table_slots={k: v.numpy() for k, v in one.table.slots.items()}, device=m.device,
        mesh=m)


def wd_steps(m, steps=3, **over):
    """W&D from its init state through the layouts the loop adopts, ``steps``
    calls of ``train_step``: each rank's planes as held mid-run, the
    merged state, the losses, the collective bytes against ``step_cost``'s
    and the zero summary."""
    tr = wd_trainer(m, **over)
    state = wd_start(m, **over)
    tp, pm, zm = tr.dense_tp_manager(), PlacementManager(tr, m), ZeroManager(tr, m)
    if tp is not None:
        state = tp.adopt(state)
    state = zm.adopt(pm.adopt(state))
    held = {k: list(t.shape) for k, t in tensor_items(state)}
    losses, counted = [], []
    for _, b in zip(range(steps), tr.batches()):
        batch = {k: torch.from_numpy(v).to(m.device) for k, v in tr.local_batch(b).items()}
        transfer.reset_comm()
        state, met = tr.train_step(state, batch)
        losses.append(float(met["loss"]))
        counted.append([transfer.comm_bytes(), tr.step_cost(b)["total_bytes"]])
    live = state
    state = pm.master_state(zm.master_state(state))
    if tp is not None:
        state = tp.master_state(state)
    return {"held": held, "state": {k: t.cpu().clone() for k, t in tensor_items(state)},
            "losses": losses, "counted": counted, "zero": zm.summary(),
            "cut": tr.placement_cut, "trainer": tr, "live": live, "pm": pm, "zm": zm}


def _crcs(manifest):
    return {k: v["crc"] for k, v in manifest["arrays"].items()}


def checkpoint_cases(m, out_dir):
    """(a) one W&D state saved uniform and unsharded, then through the
    hybrid split and zero's slices: equal CRCs; (b) after 2 steps, zero
    and replicated saves (both hybrid): equal CRCs; (c) a hybrid + zero
    ``TrainLoop`` saved at step 2 and resumed to 4 (both layouts again, and
    uniform without zero) beside the straight run."""
    from swiftsnails_tpu_torch.framework import checkpoint as ckpt

    out = {}
    tr = wd_trainer(m, packed="0", optimizer_sharding="zero")
    state = tr.init_state()
    root = os.path.join(out_dir, "ck_layouts")
    ckpt.save_checkpoint(os.path.join(root, "uniform"), state, 1, mesh=m)
    pm, zm = PlacementManager(tr, m), ZeroManager(tr, m)
    split = zm.adopt(pm.adopt(state))
    ckpt.save_checkpoint(os.path.join(root, "split"), split, 1, mesh=m, placement=pm, zero=zm)
    out["layouts"] = {name: _crcs(ckpt.read_manifest(os.path.join(root, name), 1))
                      for name in ("uniform", "split")}
    saved = {}
    for name, over in (("zero", {"optimizer_sharding": "zero"}), ("replicated", {})):
        run = wd_steps(m, steps=2, packed="0", **over)
        path = os.path.join(root, name)
        ckpt.save_checkpoint(path, run["live"], 2, mesh=m, placement=run["pm"],
                             zero=run["zm"] if name == "zero" else None)
        saved[name] = _crcs(ckpt.read_manifest(path, 2))
    out["steps"] = saved
    keys = {"packed": "0", "optimizer_sharding": "zero"}
    ck = {"param_backup_root": os.path.join(out_dir, "ck_resume")}
    steps, save = ranks.CKPT_STEPS, ranks.CKPT_SAVE
    straight = ranks._records_loop(wd_trainer(m, **keys), steps)
    ranks._records_loop(wd_trainer(m, **keys, **ck, param_backup_period=save), save)
    # the uniform, unsharded resume first: it saves nothing, so the hybrid
    # + zero resume after it starts from the same step
    uniform = ranks._records_loop(
        wd_trainer(m, packed="0", placement="uniform", resume="auto", **ck,
                   param_backup_period=100), steps)
    resumed = ranks._records_loop(
        wd_trainer(m, **keys, **ck, resume="auto", param_backup_period=save), steps)
    out["resume"] = {"straight": ranks._tensors(straight[0]), "straight_losses": straight[1],
                     "resumed": ranks._tensors(resumed[0]), "resumed_losses": resumed[1],
                     "uniform": ranks._tensors(uniform[0]), "uniform_losses": uniform[1]}
    return out


def run_record(m, out_dir):
    """W&D (2-D plane) with ``placement: hybrid`` and ``optimizer_sharding:
    zero`` under ``TrainLoop`` with a run ledger, 2 steps: the path of
    this rank's ledger."""
    path = os.path.join(out_dir, f"ledger{m.coords['data']}{m.coords['model']}.jsonl")
    from swiftsnails_tpu_torch.framework.trainer import TrainLoop

    tr = wd_trainer(m, packed="0", optimizer_sharding="zero", telemetry="1",
                    ledger_path=path, blackbox_dir=os.path.join(out_dir, "blackbox"))
    TrainLoop(tr, log_every=0).run(max_steps=2)
    return path


def wd_tp_run(m, tp):
    """W&D (packed, ``torch_mesh_ranks.CTR_CASES["widedeep"]``) from the
    shared start state, 3 steps of its global batches, with or without
    ``dense_tp``: the dense tensors as held mid-run, the merged arrays, the
    losses, the collective bytes against ``step_cost``'s."""
    tr = ranks.ctr_trainer("widedeep", m, dense_tp=int(tp))
    st = ranks.ctr_start("widedeep")
    state = convert.ctr_state_from_numpy(st["table"], st["dense"], st["sums"], device="cpu",
                                         table_slots=st["slots"], mesh=m)
    manager = tr.dense_tp_manager()
    if manager is not None:
        state = manager.adopt(state)
    held = {k: v.clone() for k, v in state.dense.items()}
    losses, counted = [], []
    for b in ranks.ctr_global_batches("widedeep"):
        batch = {k: torch.from_numpy(v) for k, v in tr.local_batch(b).items()}
        transfer.reset_comm()
        state, met = tr.train_step(state, batch)
        losses.append(float(met["loss"]))
        counted.append([transfer.comm_bytes(), tr.step_cost(b)["total_bytes"]])
    if manager is not None:
        state = manager.master_state(state)
    return {"held": held, "arrays": ranks.ctr_arrays(state), "losses": losses,
            "counted": counted}


def placement_worker(rank, size, init, out_dir):
    """One rank of the shared spawn: every case above on a ``(2, 2)`` mesh,
    and the grouped routes and the 2-D loop on a ``(1, 1)`` mesh of its own
    (each route on one rank)."""
    import torch.distributed as dist

    out = {}
    try:
        ranks.join(rank, size, init)
        m = mesh.make_mesh({"data": 2, "model": 2}, device="cpu")
        out["coords"] = dict(m.coords)
        out["split_merge"] = split_merge_cases(m)
        out["hybrid"] = {case: hybrid_case(m, case) for case in HYBRID_CASES}
        out["grouped"] = {route: grouped_run(m, route) for route in GROUPED_HYBRID}
        out["grouped_uniform"] = {route: grouped_run(m, route, hybrid_on=False)
                                  for route in ("grouped", "overlap2")}
        out["grouped_zero"] = {route: grouped_run(m, route, optimizer_sharding="zero")
                               for route in ("grouped", "overlap2")}
        out["dense_loop"] = {h: dense_loop(m, h) for h in (False, True)}
        out["flat"] = {(route, h): flat_run(m, route, h)
                       for route in ("dense", "packed", "perpair") for h in (False, True)}
        out["ctr"] = {"uniform": ctr_loop(m),
                      "hybrid": ctr_loop(m, placement="hybrid", placement_head_rows="1024")}
        wd = {}
        for name, over in (("replicated", {"packed": "0"}),
                           ("zero", {"packed": "0", "optimizer_sharding": "zero"}),
                           ("small_zero", {"optimizer_sharding": "zero"}),
                           ("small", {})):
            run = wd_steps(m, **over)
            wd[name] = {k: run[k] for k in ("held", "state", "losses", "counted", "zero",
                                             "cut")}
        out["wd"] = wd
        out["checkpoint"] = checkpoint_cases(m, out_dir)
        out["tp"] = {tp: wd_tp_run(m, tp) for tp in (False, True)}
        out["ledger"] = run_record(m, out_dir)
        solo = ranks.solo_mesh(m)
        out["solo"] = {}
        if rank == 0:
            out["solo"]["dense_loop"] = {h: dense_loop(solo, h) for h in (False, True)}
        elif rank == 1:
            out["solo"]["grouped"] = grouped_run(solo, "grouped")
        dist.destroy_process_group()
    except Exception:
        out = {"error": traceback.format_exc()}
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
