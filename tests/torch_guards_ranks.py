"""Rank-side code of the port's loop-guards-under-a-mesh tests
(``tests/test_torch_guards_mesh.py``): what each spawned gloo rank of the
file's one spawn runs on a ``(data 2, model 2)`` mesh. It imports no JAX;
the tests hold its results against the JAX package and against the port's
unmeshed runs, which the test process makes itself.

A fault on one rank only is that rank's own plan (``chaos_spec`` given to
rank :data:`FAULTY` alone) or a failure planted in that rank's process.
Every rank records which thread called each ``torch.distributed``
collective: the loop's (the main thread) must make them all."""

import os
import traceback

import numpy as np
import torch

import torch_mesh_ranks as ranks
import torch_tier_ranks as tr_ranks
from swiftsnails_tpu_torch.parallel import mesh
from swiftsnails_tpu_torch.utils.config import Config
from swiftsnails_tpu_torch.utils.tree import tensor_items

FAULTY = 2  # the rank a one-rank fault hits: data 1, model 0
NAN_RANK = 3  # the commit case's NaN row: data 1, model 1, a replica no rank counts
STEPS = 8  # TrainLoop steps of the guarded and freshness runs
NAN_AT = 3
SWEEP = {"steps": 12, "period": 5, "flip": 7}  # tests/test_torch_tiered.py's drill
FRESH_EVERY = 2
CLUSTER = {"total": 12, "lease_ms": 3000.0, "heartbeat_ms": 500.0, "grant": 4}
RESUME = {"steps": 10, "period": 3, "preempt": 4}

# the guardrail's commit case: whole arrays, each rank's part as the
# meshed state holds it
SPIKE = 5.0
TABLE, TAIL, HEAD, DIM = 16, 12, 4, 8


# ------------------------------------------------------ the commit case ---

def commit_inputs():
    """The global start state and each step's new state (whole arrays) and
    loss; ``nan_rank``: the rank whose own part of the table holds a NaN
    row (the JAX tree holds it at that rank's model rows), ``nan_loss``:
    the rank whose loss is NaN (JAX's loss then is)."""
    rng = np.random.default_rng(7)

    def tree(base=None, scale=0.0):
        shapes = {"table": (TABLE, DIM), "tail": (TAIL, DIM), "head": (HEAD, DIM),
                  "accum": (HEAD, DIM), "w": (5,)}
        return {k: (base[k] if base is not None else 0)
                + (scale if base is not None else 1.0)
                * rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}

    start = {k: v.astype(np.float32) for k, v in tree().items()}
    steps = []
    for kind, scale in (("clean", 0.01), ("spike", 10.0), ("blend", 0.01), ("nan_rank", 0.01),
                        ("nan_loss", 0.01), ("nan_rank", 0.01)):
        new = {k: v.astype(np.float32) for k, v in tree(start, scale).items()}
        steps.append({"kind": kind, "new": new})
    return start, steps


def commit_part(whole, coords, poison=False):
    """This rank's part of a whole tree: the table and the hybrid tail
    model-sharded, the head and the dense ``w`` whole, the head's AdaGrad
    plane this rank's ``1 / data`` slice (ZeRO); ``poison``: a NaN row in
    its table shard."""
    from swiftsnails_tpu_torch.parallel.hybrid import HybridTableState
    from swiftsnails_tpu_torch.parallel.store import TableState

    d, m = coords["data"], coords["model"]
    t = lambda a: torch.from_numpy(np.array(a, np.float32))  # noqa: E731
    table = t(whole["table"][m * TABLE // 2:(m + 1) * TABLE // 2])
    if poison:
        table[1] = float("nan")
    return {"dense": {"w": t(whole["w"])},
            "table": TableState(table=table, slots={}),
            "hybrid": HybridTableState(
                head=t(whole["head"]),
                head_slots={"accum": t(whole["accum"][d * HEAD // 2:(d + 1) * HEAD // 2])},
                tail=TableState(table=t(whole["tail"][m * TAIL // 2:(m + 1) * TAIL // 2]),
                                slots={}))}


class ZeroSlices:
    """The commit case's one layout: the head's AdaGrad plane is a ZeRO
    slice over ``data``."""

    def sharded(self, state):
        return [(state["hybrid"].head_slots["accum"], mesh.DATA_AXIS)]


def commit_cases(m):
    """The guardrail's commit on this rank's parts, step by step: the
    voted norm, the verdicts, the trust and the state's parts after."""
    from swiftsnails_tpu_torch.resilience.guardrail import StepGuardrail

    start, steps = commit_inputs()
    rank = torch.distributed.get_rank()
    guard = StepGuardrail(max_update_norm=SPIKE, max_consecutive=3, mesh=m)
    cur = commit_part(start, m.coords)
    out = []
    for s in steps:
        snap = guard.snapshot(cur)
        new = commit_part(s["new"], m.coords, poison=s["kind"] == "nan_rank" and rank == NAN_RANK)
        loss = float("nan") if s["kind"] == "nan_loss" and rank == FAULTY else 1.0
        cur, _, tripped, exhausted = guard.commit(snap, new, {"loss": np.float32(loss)},
                                                  layouts=(ZeroSlices(),))
        out.append({"norm": guard.last_update_norm, "tripped": tripped,
                    "exhausted": exhausted, "trust": guard.trust,
                    "parts": {k: v.clone() for k, v in tensor_items(cur)}})
    return out


# --------------------------------------------------------- loop runs ---

def _run(tr, steps, **loop_kw):
    """``TrainLoop.run`` to ``steps``: the state's arrays (this rank's
    parts), the losses and the loop."""
    from swiftsnails_tpu_torch.framework.trainer import TrainLoop
    from swiftsnails_tpu_torch.utils.metrics import MetricsLogger

    losses = []

    class Recorder(MetricsLogger):
        def log(self, record):
            losses.append(record.get("loss"))

    loop = TrainLoop(tr, metrics=Recorder(), log_every=1, **loop_kw)
    state = loop.run(seed=0, max_steps=steps)
    return {"arrays": {k: t.clone() for k, t in tensor_items(state)}, "losses": losses,
            "loop": loop}


def _mine(rank, spec):
    """``chaos_spec`` for the faulty rank alone."""
    return {"chaos_spec": spec} if rank == FAULTY else {}


def wd_guard_trainer(m, **over):
    """Wide & Deep with ``dense_tp: 1`` and ZeRO (every layout the
    guardrail counts) and the guardrail."""
    from swiftsnails_tpu_torch.models.registry import get_model

    keys = dict(tr_ranks.WD_KEYS, guardrail="1", dense_tp="1", optimizer_sharding="zero",
                chaos_seed="5")
    keys.update({k: str(v) for k, v in over.items()})
    return get_model("widedeep")(Config(keys), mesh=m, data=tr_ranks.wd_data())


def guarded_runs(m, rank):
    """packed+pool with the guardrail and ``nan_grad@NAN_AT`` on every
    rank and on the faulty rank alone; ``nan_grad`` three steps running on
    the faulty rank alone with ``guard_max_consecutive: 3`` (the give-up);
    Wide & Deep's guarded step with the NaN on every rank and on one."""
    from swiftsnails_tpu_torch.resilience.guardrail import GuardrailExhausted

    out = {}
    spec = f"nan_grad@{NAN_AT}"
    for name, over in (("all", {"chaos_spec": spec}), ("one", _mine(rank, spec))):
        run = _run(tr_ranks.w2v_trainer("packed", m, guardrail=1, chaos_seed=5, **over), STEPS)
        out[name] = {"arrays": run["arrays"], "losses": run["losses"],
                     "guard": run["loop"].guardrail.summary()}
    try:
        _run(tr_ranks.w2v_trainer("packed", m, guardrail=1, guard_max_consecutive=3,
                                  **_mine(rank, "nan_grad@2-4")), STEPS)
        out["exhausted"] = None
    except GuardrailExhausted as e:
        out["exhausted"] = str(e)
    for name, over in (("wd_all", {"chaos_spec": "nan_grad@2"}),
                       ("wd_one", _mine(rank, "nan_grad@2"))):
        run = _run(wd_guard_trainer(m, **over), 5)
        out[name] = {"arrays": run["arrays"], "guard": run["loop"].guardrail.summary(),
                     "layouts": [type(lay).__name__ for lay in run["loop"]._layouts]}
    return out


def sweep_keys(root, **over):
    """The drill's keys: saves and sweeps every ``SWEEP["period"]`` steps
    under ``root``, a seeded plan."""
    return dict(param_backup_root=root, param_backup_period=SWEEP["period"],
                tier_verify_period=SWEEP["period"], chaos_seed=3, **over)


def sweep_runs(m, rank, out_dir):
    """The tier's bitflip drill (``tests/test_torch_tiered.py``'s) on the
    dense plane behind an evicting budget: the flip on the faulty rank's
    master alone, and on every rank's; each rank's heals (the step each
    rebuilt from, the tables), its digests after, and the ledger events
    (the leader's; no other rank writes its ledger)."""
    from swiftsnails_tpu_torch.telemetry.ledger import Ledger
    from swiftsnails_tpu_torch.tiered.manager import TierManager

    out = {}
    spec = f"tier_bitflip@{SWEEP['flip']}"
    heal = TierManager.heal
    for name, over in (("one", _mine(rank, spec)), ("all", {"chaos_spec": spec})):
        ledger = os.path.join(out_dir, f"sweep_{name}_{rank}.jsonl")
        tr = tr_ranks.w2v_trainer("dense", m, 1, ledger_path=ledger,
                                  **sweep_keys(os.path.join(out_dir, f"sweep_{name}"), **over))
        heals = []

        def spy(self, *a, **k):
            heals.append(heal(self, *a, **k))
            return heals[-1]

        TierManager.heal = spy
        try:
            run = _run(tr, SWEEP["steps"])
        finally:
            TierManager.heal = heal
        events = Ledger(ledger).records("cache_error") if os.path.exists(ledger) else []
        out[name] = {"tables": [t for k, t in run["arrays"].items() if k.endswith("/table")],
                     "losses": run["losses"], "heals": heals,
                     "verify_after": run["loop"].tier.verify(),
                     "evictions": run["loop"].tier.summary()["evictions"],
                     "events": [{k: e.get(k) for k in ("source", "step", "rebuilt_from_step",
                                                       "tables")} for e in events],
                     "ledger_written": os.path.exists(ledger)}
    return out


def fresh_keys(out_dir, name, rank, **over):
    """Publishing every ``FRESH_EVERY`` steps into a directory and a ledger
    of this rank's own (only the leader's may be written)."""
    return dict(freshness_publish=FRESH_EVERY,
                freshness_dir=os.path.join(out_dir, f"fresh_{name}_{rank}"),
                ledger_path=os.path.join(out_dir, f"fresh_{name}_{rank}.jsonl"), **over)


def fail_once(drain):
    """``drain`` that raises at its second call (a publish failing on this
    rank alone)."""
    calls = []

    def failing(collector, geometry):
        calls.append(1)
        if len(calls) == 2:
            raise OSError("planted drain failure")
        return drain(collector, geometry)

    return failing


def fresh_runs(m, rank, out_dir):
    """packed+pool publishing from the resident shards, the dense plane
    publishing through the tier's flush tee, and packed+pool with the
    faulty rank's second drain failing: the tables, the publisher's stats
    and errors, the steps trained, and the ledger's gap events."""
    from swiftsnails_tpu_torch.freshness.publisher import TouchedRowCollector
    from swiftsnails_tpu_torch.telemetry.ledger import Ledger

    out = {}
    for name, route, tier in (("resident", "packed", None), ("tier", "dense", 1),
                              ("error", "packed", None)):
        keys = fresh_keys(out_dir, name, rank)
        drain = TouchedRowCollector.drain
        if name == "error" and rank == FAULTY:
            TouchedRowCollector.drain = fail_once(drain)
        try:
            run = _run(tr_ranks.w2v_trainer(route, m, tier, **keys), STEPS)
        finally:
            TouchedRowCollector.drain = drain
        ledger = keys["ledger_path"]
        fresh = run["loop"].freshness
        out[name] = {"tables": [t for k, t in run["arrays"].items() if k.endswith("/table")],
                     "losses": run["losses"], "errors": fresh.errors,
                     "stats": fresh.stats(), "dir": keys["freshness_dir"],
                     "gaps": len(Ledger(ledger).records("freshness_gap"))
                     if os.path.exists(ledger) else None}
    return out


# ------------------------------------------------------------- cluster ---

class FakeClock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


def reassign_client(clock):
    """``tests/test_torch_cluster_worker.py``'s kill-and-reassign script:
    ``w1`` takes the first lease, applies two batches and goes silent; the
    returned ``w0`` advances the clock a second a step, so ``w1``'s lease
    lapses and ``w0`` adopts the rest of its span out of order."""
    from swiftsnails_tpu_torch.cluster import Supervisor, WorkerClient

    sup = Supervisor(total_batches=CLUSTER["total"], lease_ms=CLUSTER["lease_ms"],
                     heartbeat_ms=CLUSTER["heartbeat_ms"], grant_batches=CLUSTER["grant"],
                     clock=clock)
    w1 = WorkerClient(sup, "w1")
    s1 = w1.leased_stream(lambda: iter(range(100)))
    for step in (1, 2):
        next(s1)
        w1.on_step(step)
    w0 = WorkerClient(sup, "w0")
    on_step = w0.on_step

    def tick(step):
        clock.now += 1.0
        return on_step(step)

    w0.on_step = tick
    return w0


def record_commits():
    """Wrap the accountant's commit: the indices committed, in order."""
    from swiftsnails_tpu_torch.cluster.accounting import BatchAccountant

    seen = []
    commit = BatchAccountant.commit

    def spy(self, lease_id, index, *a, **k):
        seen.append(int(index))
        return commit(self, lease_id, index, *a, **k)

    BatchAccountant.commit = spy
    return seen, lambda: setattr(BatchAccountant, "commit", commit)


def record_indices():
    """Wrap the loop's broadcast: every rank's agreed indices, in order."""
    from swiftsnails_tpu_torch.framework import trainer as tmod

    seen = []
    bcast = tmod.broadcast_ints

    def spy(mesh_, values, n):
        got = bcast(mesh_, values, n)
        seen.append(got[0])
        return got

    tmod.broadcast_ints = spy
    return seen, lambda: setattr(tmod, "broadcast_ints", bcast)


def cluster_runs(m, rank, out_dir):
    """The kill-and-reassign script with the leader holding ``w0``
    (``cluster=``) and no prefetch thread, so the run is a pure function of
    the script; then ``cluster_workers: 1`` stopped by ``preempt`` and
    resumed, beside the straight run. Each run's agreed indices (every
    rank), commits and cursor (the leader)."""
    out = {}
    for name in ("reassign", "straight", "preempted", "resumed"):
        commits, undo_c = record_commits()
        agreed, undo_a = record_indices()
        try:
            if name == "reassign":
                tr = tr_ranks.w2v_trainer("packed", m, prefetch_batches=0)
                kw = {"cluster": reassign_client(FakeClock())} if rank == 0 else {}
                run = _run(tr, CLUSTER["total"], **kw)
            else:
                root = os.path.join(out_dir, "cluster_ck")
                keys = dict(cluster_workers=1, cluster_grant_batches=CLUSTER["grant"])
                if name != "straight":
                    keys.update(param_backup_root=root, param_backup_period=RESUME["period"])
                if name == "preempted":
                    keys["chaos_spec"] = f"preempt@{RESUME['preempt']}"
                if name == "resumed":
                    keys["resume"] = "auto"
                run = _run(tr_ranks.w2v_trainer("packed", m, **keys), RESUME["steps"])
        finally:
            undo_c()
            undo_a()
        cl = run["loop"].cluster
        out[name] = {"tables": [t for k, t in run["arrays"].items() if k.endswith("/table")],
                     "agreed": agreed[1:], "clustered": agreed[0] if agreed else None,
                     "commits": commits, "preempted": run["loop"].preempted,
                     "cursor": cl.cursor() if cl is not None else None,
                     "exact": (cl.supervisor.accountant.verify(CLUSTER["total"])
                               if cl is not None and name == "reassign" else None)}
    return out


def guards_worker(rank, size, init, out_dir):
    """One rank of the shared spawn: every case above on a ``(2, 2)`` mesh,
    the collectives watched."""
    import torch.distributed as dist

    out = {}
    try:
        ranks.join(rank, size, init)
        seen = tr_ranks.watch_collectives()
        m = mesh.make_mesh({"data": 2, "model": 2}, device="cpu")
        out["coords"] = dict(m.coords)
        out["commit"] = commit_cases(m)
        out["guarded"] = guarded_runs(m, rank)
        out["sweep"] = sweep_runs(m, rank, out_dir)
        out["fresh"] = fresh_runs(m, rank, out_dir)
        out["cluster"] = cluster_runs(m, rank, out_dir)
        out["threads"] = {k: v for k, v in seen.items()}
        dist.destroy_process_group()
    except Exception:
        out = {"error": traceback.format_exc()}
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
