"""The bench ``chaos-cluster`` lane: a kill/slow/partition storm against a
simulated N-worker fleet, gated on exactly-once accounting + loss parity.

Three legs, same trainer, same seeded fault schedule:

* an **undisturbed control** applies every batch in index order on one
  worker — the loss-parity reference;
* the **protected leg** runs the fleet under the supervisor: the storm
  kills a worker (lease expiry → reassignment), slows one (EWMA straggler →
  shrunk share + backup substeps), and partitions one (stale re-claims
  refused). It must finish with the accountant's proof *exact* — zero lost,
  zero double-applied — and eval loss within ``LOSS_PARITY_BAR`` of the
  control;
* the **unprotected control leg** runs the same storm with static shards
  and no supervisor: the dead worker's range is demonstrably lost. If it
  weren't, the storm is too weak to prove anything and the lane fails
  itself.

CPU-valid (the fleet is simulated under a virtual clock), so
``ledger-report --check-regression`` hard-fails accounting or recovery
breakage on any platform. The JAX package's ``cluster/chaos_lane.py``; each
leg's state is dropped once its loss is read, so the legs' tables never
live on the card at once, and :func:`chaos_cluster_bench` takes any
trainer (``chip_smoke.py`` passes one at full width).
"""

from __future__ import annotations

import os
import tempfile
import time
from typing import Dict, Optional

from swiftsnails_tpu_torch.resilience.drill import (
    LOSS_PARITY_BAR, eval_loss, make_trainer, tables_finite,
)
from swiftsnails_tpu_torch.utils.device import DeviceLike

# the storm: one silent death, a straggler window, one partition — scheduled
# by cluster-wide applied-batch tick (deterministic under the virtual clock)
STORM_SPEC = "worker_dead@10,worker_slow@16-26,partition@30"

CLUSTER_DRILLS = ("worker_kill", "straggler", "partition", "storm")


def _run_leg(trainer, total: int, spec: str, supervised: bool,
             workers: int, ledger=None, seed: int = 0,
             backup_substeps: int = 2) -> Dict:
    from swiftsnails_tpu_torch.cluster.sim import simulate_cluster
    from swiftsnails_tpu_torch.resilience.chaos import ChaosPlan, parse_chaos_spec

    chaos = None
    if spec:
        chaos = ChaosPlan(parse_chaos_spec(spec), seed=7, ledger=ledger)
    res = simulate_cluster(
        trainer, total, workers=workers, chaos=chaos,
        supervised=supervised, seed=seed, ledger=ledger,
        backup_substeps=backup_substeps,
    )
    state = res.pop("state")
    res["loss"] = eval_loss(trainer, state)
    res["finite"] = tables_finite(state)
    return res


def chaos_cluster_bench(
    small: bool = True,
    workdir: Optional[str] = None,
    ledger=None,
    workers: int = 3,
    spec: str = STORM_SPEC,
    parity_bar: float = LOSS_PARITY_BAR,
    device: DeviceLike = None,
    trainer=None,
    legs: Optional[Dict] = None,
) -> Dict:
    """Run the three legs; returns the gated ``chaos_cluster`` block.
    ``trainer`` replaces the drill trainer (made under ``workdir`` on
    ``device``); ``legs``, a dict, receives each leg's raw result
    (``control``: its wall s; ``protected`` / ``unprotected``: the sim's
    result without the state, and its wall s)."""
    from swiftsnails_tpu_torch.cluster.sim import run_inorder_control

    owned = workdir is None
    if owned:
        tmp = tempfile.TemporaryDirectory(prefix="chaos-cluster-")
        workdir = tmp.name
    else:
        os.makedirs(workdir, exist_ok=True)
    total = 48 if small else 96
    if trainer is None:
        trainer = make_trainer(workdir, device=device)
    legs = {} if legs is None else legs

    t0 = time.perf_counter()
    control_state = run_inorder_control(trainer, total)
    control_loss = eval_loss(trainer, control_state)
    del control_state  # freed before the next leg allocates its tables
    legs["control"] = {"wall_s": time.perf_counter() - t0}

    t0 = time.perf_counter()
    protected = _run_leg(trainer, total, spec, supervised=True,
                         workers=workers, ledger=ledger)
    legs["protected"] = {**protected, "wall_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    unprotected = _run_leg(trainer, total, spec, supervised=False,
                           workers=workers, ledger=None)
    legs["unprotected"] = {**unprotected, "wall_s": time.perf_counter() - t0}

    acct = protected["accounting"]
    status = protected.get("status", {})
    parity = abs(protected["loss"] - control_loss) / max(abs(control_loss),
                                                         1e-9)
    unprotected_lost = unprotected["accounting"]["lost_count"] > 0
    block = {
        "workers": workers,
        "spec": spec,
        "total_batches": total,
        "committed": acct["committed"],
        "lost_count": acct["lost_count"],
        "duplicated_count": acct["duplicated_count"],
        "dup_discarded": acct["dup_discarded"],
        "stale_rejected": protected["stale_rejected"],
        "workers_lost": status.get("workers_lost", 0),
        "reassignments": status.get("reassignments", 0),
        "stragglers_flagged": status.get("stragglers_flagged", 0),
        "accounting_exact": bool(acct["exact"]),
        "finite": bool(protected["finite"]),
        "loss": round(float(protected["loss"]), 6),
        "control_loss": round(float(control_loss), 6),
        "loss_parity": round(float(parity), 6),
        "parity_bar": parity_bar,
        "unprotected_lost_count": unprotected["accounting"]["lost_count"],
        "unprotected_lost": unprotected["accounting"]["lost"],
        "unprotected_hard_failure": bool(unprotected_lost),
        "virtual_s": protected["virtual_s"],
    }
    # the lane's own verdict: exactly-once held, the fleet survived the
    # storm with parity, AND the storm was strong enough that the
    # unsupervised control demonstrably lost the dead worker's range
    block["recovered"] = bool(
        block["accounting_exact"]
        and block["finite"]
        and block["workers_lost"] >= 1
        and block["reassignments"] >= 1
        and parity <= parity_bar
        and unprotected_lost
    )
    if owned:
        tmp.cleanup()
    return block


# ------------------------------------------------------------ drill matrix --


def _drill_checks(name: str, block: Dict) -> Dict[str, bool]:
    checks = {
        "accounting_exact": block["accounting_exact"],
        "finite": block["finite"],
        "loss_parity": block["loss_parity"] <= block["parity_bar"],
    }
    if name in ("worker_kill", "storm"):
        checks["worker_lost_detected"] = block["workers_lost"] >= 1
        checks["range_reassigned"] = block["reassignments"] >= 1
        checks["unprotected_loses_range"] = block["unprotected_hard_failure"]
    if name in ("straggler", "storm"):
        checks["straggler_flagged"] = block["stragglers_flagged"] >= 1
    if name == "partition":
        checks["worker_lost_detected"] = block["workers_lost"] >= 1
        checks["range_reassigned"] = block["reassignments"] >= 1
    return checks


def run_cluster_drills(workdir: Optional[str] = None,
                       small: bool = True,
                       device: DeviceLike = None) -> Dict[str, Dict]:
    """The kill/slow/partition drill matrix (``chaos_drill.py --cluster``).

    Each drill isolates one fault kind; ``storm`` composes all three. A
    drill *recovers* when every check in its row holds — lost or duplicated
    batches, a missed detection, or a blown parity all fail it."""
    specs = {
        "worker_kill": "worker_dead@10",
        "straggler": "worker_slow@12-24",
        "partition": "partition@10",
        "storm": STORM_SPEC,
    }
    results: Dict[str, Dict] = {}
    for name in CLUSTER_DRILLS:
        sub = os.path.join(workdir, name) if workdir else None
        block = chaos_cluster_bench(small=small, workdir=sub, spec=specs[name],
                                    device=device)
        checks = _drill_checks(name, block)
        results[name] = {
            "recovered": all(checks.values()),
            "checks": checks,
            "lost": block["lost_count"],
            "duplicated": block["duplicated_count"],
            "dup_discarded": block["dup_discarded"],
            "stale_rejected": block["stale_rejected"],
            "loss_parity": block["loss_parity"],
            "workers_lost": block["workers_lost"],
            "reassignments": block["reassignments"],
            "stragglers_flagged": block["stragglers_flagged"],
        }
    return results
