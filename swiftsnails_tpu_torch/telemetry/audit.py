"""The collective audit of a step — the JAX package's ``telemetry/audit.py``
``audit_step``, counted where the collectives are called.

The JAX audit compiles the step and parses the optimized HLO for its
collectives. The port has no compiled program to read: its collectives are
``torch.distributed`` calls, and :mod:`swiftsnails_tpu_torch.parallel.comm`
counts each one where it is made, the bytes it moves on the wire (codes,
scales and ids), by op and by the JAX package's ``ssn_*`` scope names.
:func:`audit_step` runs one step and reports what those counters moved in
it, in the JAX report's keys. So, unlike the JAX audit, it executes the
step: pass arguments it may update (on every rank of the mesh, which all
run the step's collectives).

A collective the port adds where the JAX step has none in its scopes (the
spread pushes' f32 reduce-scatter under a codec, the out rows' id gather)
has a scope of its own (``ssn_spread_reduce_scatter``, ``ssn_out_layout``):
reported, not folded into the JAX scope around it. A reduce-scatter is
billed at its full operand, as the JAX audit bills one
(``swiftsnails_tpu/telemetry/audit.py:76``).
"""

from __future__ import annotations

from typing import Dict

from swiftsnails_tpu_torch.parallel import comm

_OPS = ("all_reduce", "all_gather", "all_to_all")


def _snapshot() -> tuple:
    return dict(comm.COMM), dict(comm.SCOPES)


def audit_step(fn, *args, **kwargs) -> Dict:
    """Run ``fn(*args, **kwargs)`` once and return the collectives it made
    on this rank: ``{"by_op": {op: {"count", "bytes"}}, "by_scope":
    {scope: bytes}, "total_bytes", "result"}``, ``result`` being what
    ``fn`` returned. ``by_op`` names the ``torch.distributed`` calls
    (``all_reduce``, ``all_gather``, ``all_to_all``); ``total_bytes``
    counts every collective, scoped or not."""
    ops0, scopes0 = _snapshot()
    result = fn(*args, **kwargs)
    ops1, scopes1 = _snapshot()
    by_op = {}
    for op in _OPS:
        count = ops1[f"{op}_calls"] - ops0[f"{op}_calls"]
        if count:
            by_op[op] = {"count": count,
                         "bytes": ops1[f"{op}_bytes"] - ops0[f"{op}_bytes"]}
    by_scope = {k: v - scopes0.get(k, 0) for k, v in scopes1.items()
                if v != scopes0.get(k, 0)}
    return {"by_op": by_op, "by_scope": by_scope,
            "total_bytes": sum(e["bytes"] for e in by_op.values()), "result": result}
