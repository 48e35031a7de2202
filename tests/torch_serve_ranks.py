"""Rank-side code of the port's serving-under-a-mesh tests
(``tests/test_torch_serving_mesh.py``): what each spawned gloo rank runs on
a ``(data 1, model 4)`` mesh. Rank 0 leads and serves, the others follow
(``serving/mesh_serve.py``). It imports no JAX; the tests hold the
leader's answers against the JAX package and the port's unmeshed servant."""

import os
import traceback

import numpy as np
import torch

import torch_mesh_ranks as ranks
from swiftsnails_tpu_torch import convert
from swiftsnails_tpu_torch.parallel import mesh
from swiftsnails_tpu_torch.utils.config import Config

CAP, DIM = 64, 24
TIES = range(10, 14)  # in_table rows that are the same: equal scores
TILE = 8  # topk_tile_rows: divides a shard's 16 rows
TIER_ROWS = 48  # of 64: a bucket of 64 ids faults, and the cache evicts
PLANT_RANK = 2  # the follower whose planted failures the leader asks for
CTR_KEYS = {"model": "widedeep", "num_fields": "5", "capacity": "1024", "embed_dim": "4",
            "hidden_dims": "16,8", "seed": "0"}


def tables():
    """The served tables, whole (in_table's rows ``TIES`` all ones)."""
    rng = np.random.default_rng(3)
    t = rng.standard_normal((CAP, DIM)).astype(np.float32)
    t[list(TIES)] = 1
    return {"in_table": t, "out_table": rng.standard_normal((CAP, DIM)).astype(np.float32)}


def step_tables(step):
    """The word2vec checkpoint's tables at ``step`` (step 2 doubles step 1's)."""
    return {k: v * step for k, v in tables().items()}


def w2v_config():
    return Config({"dim": str(DIM), "capacity": str(CAP), "packed": "1"})


def ids():
    rng = np.random.default_rng(4)
    out = rng.integers(0, CAP, 70).astype(np.int32)
    out[:5] = out[5]
    return out


def queries():
    """Rows of in_table to query (cosine), and a vector of ones scored
    raw, on which the ``TIES`` rows tie at the top."""
    return [int(q) for q in (3, 17, 40, 63)], np.ones(DIM, np.float32)


def deltas():
    rng = np.random.default_rng(5)
    rows = np.array([1, 20, 20, 33, 70, 50], np.int64)  # a repeat, one out of range
    return rows, rng.standard_normal((len(rows), DIM)).astype(np.float32)


def ctr_feats():
    rng = np.random.default_rng(9)
    feats = rng.integers(0, 1 << 20, size=(11, 5)).astype(np.int32)
    feats[0, 3] = feats[4, 0] = -1
    return feats


def write_checkpoints(out_dir):
    """Rank 0's: the word2vec checkpoint (steps 1 and 2, packed planes)
    and a widedeep one (its one-device init state)."""
    from swiftsnails_tpu_torch.framework.checkpoint import save_checkpoint
    from swiftsnails_tpu_torch.models.registry import get_model

    root = os.path.join(out_dir, "ck_w2v")
    for step in (1, 2):
        t = step_tables(step)
        packed = [np.pad(t[k], ((0, 0), (0, 128 - DIM)))[:, None, :]
                  for k in ("in_table", "out_table")]
        save_checkpoint(root, convert.w2v_state_from_numpy(*packed, device="cpu"), step=step)
    tr = get_model("widedeep")(Config(dict(CTR_KEYS)), device="cpu",
                               data=(np.zeros(0, np.float32), np.zeros((0, 5), np.int32)))
    save_checkpoint(os.path.join(out_dir, "ck_ctr"), tr.init_state(), step=4)


def plant(out_dir, what):
    """Make ``PLANT_RANK``'s next ``what`` (``load``: a checkpoint load,
    ``apply``: a delta's new planes) fail, once. The leader plants it
    before it sends the op, so the follower meets it in that op."""
    open(os.path.join(out_dir, f"plant_{what}"), "w").close()


def _planted(out_dir, what):
    path = os.path.join(out_dir, f"plant_{what}")
    if os.path.exists(path):
        os.remove(path)
        raise RuntimeError(f"planted {what} failure on rank {PLANT_RANK}")


def install_plants(out_dir):
    """On ``PLANT_RANK``: checkpoint loads and resident delta planes
    that fail where :func:`plant` asks."""
    from swiftsnails_tpu_torch.framework import checkpoint
    from swiftsnails_tpu_torch.serving.engine import Servant

    load, prepare = checkpoint.load_tables, Servant.prepare_rows

    def load_tables(*args, **kwargs):
        _planted(out_dir, "load")
        return load(*args, **kwargs)

    def prepare_rows(self, updates):
        _planted(out_dir, "apply")
        return prepare(self, updates)

    checkpoint.load_tables = load_tables
    Servant.prepare_rows = prepare_rows


def refused(out_dir, what, op):
    """Plant ``what`` on ``PLANT_RANK``, make ``op``; the refusal's text
    (None: it was not refused)."""
    from swiftsnails_tpu_torch.serving.mesh_serve import Refused

    plant(out_dir, what)
    try:
        op()
    except Refused as err:
        return str(err)
    return None


def uncached_pull(server, ids):
    """``server.pull(ids)`` through every rank's shard: the hot-row
    caches emptied first."""
    for sv in ([r.servant for r in server.replicas()] if hasattr(server, "replicas")
               else [server]):
        sv.cache.clear()
    return server.pull(ids)


def lead(m, out_dir, targets):
    """The leader's cases over ``targets`` (the servants every rank made,
    in order), against the port's unmeshed servants."""
    from swiftsnails_tpu_torch.serving import Servant

    sv32, sv8, sv4, ck, tiered, fleet, ctr = targets
    whole = tables()
    out = {}
    with Servant(whole, device="cpu", topk_tile_rows=TILE) as ref:
        i = ids()
        out["pull"] = {"float32": sv32.pull(i), "int8": sv8.pull(i), "int4": sv4.pull(i),
                       "ref": ref.pull(i), "out_table": sv32.pull(i, table="out_table")}
        qs, axis = queries()
        out["topk"] = {"mesh": [sv32.topk(whole["in_table"][q], k=10) for q in qs],
                       "ref": [ref.topk(whole["in_table"][q], k=10) for q in qs],
                       "ties_mesh": sv32.topk(axis, k=12, normalize=False),
                       "ties_ref": ref.topk(axis, k=12, normalize=False)}
        rows, vals = deltas()
        out["refused"] = {"apply": refused(out_dir, "apply", lambda: sv32.apply_rows(
            {"in_table": (rows, vals)}))}
        out["refused"]["apply_kept"] = (sv32.version, uncached_pull(sv32, np.arange(CAP)))
        version = sv32.apply_rows({"in_table": (rows, vals), "other": (rows, vals)})
        ref.apply_rows({"in_table": (rows, vals)})
        out["apply"] = {"version": version, "mesh": sv32.pull(np.arange(CAP, dtype=np.int32)),
                        "ref": ref.pull(np.arange(CAP, dtype=np.int32))}
        out["tiered"] = {"pull": tiered.pull(i), "topk": tiered.topk(whole["in_table"][3], k=10)}
        ok = rows < CAP  # a tiered table's delta must be in range
        tiered.apply_rows({"in_table": (rows[ok], vals[ok])})
        # in halves: a request's distinct rows must fit the cache
        out["tiered"]["apply"] = np.concatenate(
            [tiered.pull(np.arange(h, h + CAP // 2, dtype=np.int32)) for h in (0, CAP // 2)])
        out["tiered"]["stats"] = tiered.stats()["tiered"]
    root = os.path.join(out_dir, "ck_w2v")
    out["ck"] = {"step1": ck.pull(i)}
    out["refused"]["reload"] = refused(
        out_dir, "load", lambda: ck.reload_from_checkpoint(root, w2v_config(), step=2))
    out["refused"]["reload_kept"] = (ck.version, uncached_pull(ck, i))
    out["ck"]["version"] = ck.reload_from_checkpoint(root, w2v_config(), step=2)
    out["ck"]["step2"] = ck.pull(i)
    out["fleet"] = {"pull": fleet.pull(i), "topk": fleet.topk(step_tables(1)["in_table"][3], k=10)}
    out["fleet"]["epoch"] = fleet.apply_rows({"in_table": (rows, vals)})
    out["fleet"]["apply"] = fleet.pull(np.arange(CAP, dtype=np.int32))
    added = fleet.add_replica()
    out["fleet"]["added"] = added
    fleet.drain("r0")
    out["fleet"]["after_drain"] = fleet.pull(np.arange(CAP, dtype=np.int32))
    out["refused"]["fleet_reload"] = refused(
        out_dir, "load", lambda: fleet.reload_from_checkpoint(root, w2v_config(), step=2))
    out["refused"]["fleet_apply"] = refused(out_dir, "apply", lambda: fleet.apply_rows(
        {"in_table": (rows, vals)}))
    out["refused"]["fleet_kept"] = (fleet.version, uncached_pull(fleet, np.arange(CAP)))
    out["fleet"]["reload"] = fleet.reload_from_checkpoint(root, w2v_config(), step=2)
    out["fleet"]["reloaded"] = fleet.pull(i)
    with Servant.from_checkpoint(os.path.join(out_dir, "ck_ctr"), Config(dict(CTR_KEYS)),
                                 device="cpu") as one:
        out["score"] = {"mesh": ctr.score(ctr_feats()), "ref": one.score(ctr_feats())}
    return out


def serve_worker(rank, size, init, out_dir):
    """One rank of the spawn: every servant made in the same order, rank 0
    leading the cases and the others following to the stop; then a second
    session whose leader fails, which its followers see as an error stop."""
    import torch.distributed as dist

    from swiftsnails_tpu_torch.serving import Fleet, Servant, mesh_serve
    from swiftsnails_tpu_torch.serving.mesh_serve import LeaderError

    out = {}
    try:
        ranks.join(rank, size, init)
        m = mesh.make_mesh({"data": 1, "model": 4}, device="cpu")
        out["coords"] = dict(m.coords)
        if rank == 0:
            write_checkpoints(out_dir)
        dist.barrier()
        whole = tables()
        root = os.path.join(out_dir, "ck_w2v")
        targets = [
            Servant(whole, mesh=m, topk_tile_rows=TILE),
            Servant(whole, mesh=m, comm_dtype="int8"),
            Servant(whole, mesh=m, comm_dtype="int4"),
            Servant.from_checkpoint(root, w2v_config(), step=1, mesh=m, device="cpu"),
            Servant(whole, mesh=m, tier_hbm_budget_mb=2 * TIER_ROWS * DIM * 4 / float(1 << 20)),
            Fleet.from_checkpoint(root, w2v_config(), step=1, mesh=m, device="cpu", replicas=2),
            Servant.from_checkpoint(os.path.join(out_dir, "ck_ctr"), Config(dict(CTR_KEYS)),
                                    mesh=m, device="cpu"),
        ]
        ch = mesh_serve.channel(m)
        out["leader"] = ch.leader
        if rank == PLANT_RANK:
            install_plants(out_dir)
        if ch.leader:
            with mesh_serve.leading(m):
                out["cases"] = lead(m, out_dir, targets)
        else:
            mesh_serve.follow(m)
            out["followed"] = True
        out["stopped"] = ch.stopped
        if ch.leader:  # its followers are gone: a servant of the session refuses
            try:
                targets[0].topk(whole["in_table"][3], k=3)
            except RuntimeError as err:
                out["stale_session"] = str(err)
        tt = targets[4].tier["in_table"]
        out["slot_of"] = tt.slot_of.copy()
        out["versions"] = [t.version for t in targets if isinstance(t, Servant)]
        out["shards"] = {k: v.clone() for k, v in targets[0]._tables.items()}
        for t in targets:
            t.close()
        # a second session: the leader fails mid-way
        sv = Servant(whole, mesh=m)
        if mesh_serve.channel(m).leader:
            try:
                with mesh_serve.leading(m):
                    sv.pull(ids())
                    raise RuntimeError("the leader fails")
            except RuntimeError:
                out["leader_failed"] = True
        else:
            try:
                mesh_serve.follow(m)
            except LeaderError:
                out["saw_leader_error"] = True
        sv.close()
        dist.destroy_process_group()
    except Exception:
        out = {"error": traceback.format_exc()}
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
