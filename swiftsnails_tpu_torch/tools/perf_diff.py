"""Attribute a words/sec delta between two run records to its components —
the JAX package's ``tools/perf_diff.py``, over the port's ledger.

A thin wrapper over ``ledger-report --diff``
(:func:`swiftsnails_tpu_torch.telemetry.ledger.render_diff`): given two
run/bench records, it decomposes the throughput delta into the goodput
components (compute, h2d, host-blocked, other, unaccounted seconds a step)
and the per-scope comm bytes, and names the dominant contributor::

    # newest vs previous run record in the repo's RUN_LEDGER.jsonl
    python -m swiftsnails_tpu_torch.tools.perf_diff -2 -1

    # any two records: ledger indexes or record files (JSON, or JSONL —
    # the last parseable line is used)
    python -m swiftsnails_tpu_torch.tools.perf_diff before.json after.json
    python -m swiftsnails_tpu_torch.tools.perf_diff --ledger run.jsonl -2 -1

    # the same engine through the CLI
    python -m swiftsnails_tpu_torch ledger-report run.jsonl --diff -2 -1

Indexes address the ledger's ``run`` records (``-1`` newest, ``0`` first).
No card needed. Exit 2 on a spec that names no record.
"""

from __future__ import annotations

import argparse
import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    from swiftsnails_tpu_torch.telemetry import ledger as led

    p = argparse.ArgumentParser(
        prog="perf_diff",
        description="decompose a words/sec delta between two run records",
    )
    p.add_argument("a", help="baseline: ledger index (e.g. -2) or record file")
    p.add_argument("b", help="candidate: ledger index (e.g. -1) or record file")
    p.add_argument("--ledger", default=None,
                   help="ledger path for index specs (default: the repo's "
                        "RUN_LEDGER.jsonl)")
    args = p.parse_args(argv)

    ledger = led.Ledger(args.ledger or os.path.join(_REPO, "RUN_LEDGER.jsonl"))
    try:
        rec_a, label_a = led._resolve_diff_record(ledger, args.a)
        rec_b, label_b = led._resolve_diff_record(ledger, args.b)
    except ValueError as e:
        print(f"perf_diff: {e}", file=sys.stderr)
        return 2
    print(led.render_diff(rec_a, rec_b, label_a=label_a, label_b=label_b))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
