"""How often the drift drill holds its gate on one device.

Runs :func:`~swiftsnails_tpu_torch.telemetry.drift_lane.drift_drill`
``--runs`` times in one process and counts the runs that held the gate
(detected inside the injected band, one drift event, a complete bundle,
``--diff`` naming host_blocked), the runs whose sentinel tripped before the
band, and the runs that missed it::

    # on the card: the drill's band, then the band opening at step 16
    python -m swiftsnails_tpu_torch.tools.drift_rate --runs 20
    python -m swiftsnails_tpu_torch.tools.drift_rate --runs 20 --inject-first 16

    # on the CPU, one intra-op thread, eight spinning processes beside it
    python -m swiftsnails_tpu_torch.tools.drift_rate --device cpu --threads 1 --busy 8

``--busy N`` keeps N processes spinning while the drills run (a host shared
with other work). One JSON line a run, then the summary as the last line.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import tempfile


def main(argv=None) -> int:
    import torch

    from swiftsnails_tpu_torch.telemetry.drift_lane import (
        INJECT_FIRST, INJECT_LAST, drift_drill)
    from swiftsnails_tpu_torch.utils.device import resolve_device

    p = argparse.ArgumentParser(prog="drift_rate",
                                description="count the drift drill's verdicts")
    p.add_argument("--runs", type=int, default=20)
    p.add_argument("--device", default=None, help="default: the card")
    p.add_argument("--inject-first", type=int, default=INJECT_FIRST,
                   help="the first step of the slow_step band")
    p.add_argument("--threads", type=int, default=0,
                   help="intra-op threads (0: leave torch's default)")
    p.add_argument("--busy", type=int, default=0,
                   help="spinning processes kept alive beside the drills")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    if args.threads:
        torch.set_num_threads(args.threads)
    first, last = args.inject_first + 1, INJECT_LAST + 1  # the band's samples
    spinners = [subprocess.Popen([sys.executable, "-c", "while True: pass"])
                for _ in range(args.busy)]
    steps = []
    held = 0
    try:
        with tempfile.TemporaryDirectory(prefix="ssn-drift-rate-") as tmp:
            for i in range(args.runs):
                out = drift_drill(os.path.join(tmp, str(i)), device=device,
                                  inject_first=args.inject_first)
                ok = bool(out["detected"] and out["drift_events"] == 1
                          and out["bundle_complete"]
                          and out["attribution"].get("dominant") == "host_blocked")
                held += ok
                steps.append(out["detect_step"])
                print(json.dumps({"run": i, "detect_step": out["detect_step"],
                                  "signals": out["signals"], "held": ok}), flush=True)
    finally:
        for s in spinners:
            s.kill()
            s.wait()
    print(json.dumps({
        "runs": args.runs, "held": held,
        "early": sum(1 for s in steps if s is not None and s < first),
        "missed": sum(1 for s in steps if s is None or s > last),
        "band": [first, last],
        "detect_steps": dict(sorted(collections.Counter(map(str, steps)).items())),
        "device": (torch.cuda.get_device_name(device) if device.type == "cuda"
                   else "cpu"),
        "threads": torch.get_num_threads(), "busy": args.busy}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
