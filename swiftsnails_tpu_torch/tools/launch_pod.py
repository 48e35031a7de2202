"""Multi-host launcher of the port: one ``train`` process a line of a hosts
file, the twin of the JAX package's ``tools/launch_pod.sh``::

    python -m swiftsnails_tpu_torch.tools.launch_pod <hosts-file> <config> [-key value ...]

``hosts-file`` holds one hostname a line; blank lines and ``#`` comments are
skipped, and the first host is the coordinator, at port
``SNAILS_COORD_PORT`` (default 29500). Line ``i`` runs::

    cd <repo> && RANK=i LOCAL_RANK=j exec <python> -m swiftsnails_tpu_torch train \\
        -config <config> -master_addr HOST0:PORT -expected_node_num N [-key value ...]

where ``N`` is the number of lines and ``j`` the line's order among the
lines that name the same host: the port runs one process a card, so a host
listed k times runs k processes, on its cards 0..k-1
(``parallel.cluster.initialize_cluster`` reads ``RANK`` and ``LOCAL_RANK``).
``localhost`` and ``127.0.0.1`` run here; every other host runs through
``ssh -o BatchMode=yes``, and needs this repository and this interpreter at
the same paths, and passwordless ssh. ``<config>`` is read from the
repository's root, as the JAX script reads it. Every argument that reaches a
shell is quoted (``shlex.quote``, the script's ``printf %q``). The exit code
is 0 when every process exits 0, else 1. A launcher stopped by SIGTERM or
Ctrl-C sends SIGTERM to the processes it started (a training process drains
with a final checkpoint, as on any SIGTERM; ``ssh`` closes its connection).

The same cluster through ``torchrun``, on host ``h`` of ``H`` hosts with
``k`` cards each (torchrun sets ``RANK``, ``LOCAL_RANK`` and the ``env://``
variables)::

    torchrun --nnodes H --node-rank h --nproc-per-node k \\
        --master-addr HOST0 --master-port PORT -m swiftsnails_tpu_torch train \\
        -config <config> -master_addr env:// -expected_node_num H*k
"""

from __future__ import annotations

import os
import shlex
import signal
import subprocess
import sys
from typing import List, Optional, Sequence, Tuple

DEFAULT_PORT = 29500
LOCAL_HOSTS = ("localhost", "127.0.0.1")
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def read_hosts(path: str) -> List[str]:
    """The hosts file's hosts, in order: blank lines and ``#`` comments
    skipped, each line stripped."""
    with open(path, encoding="utf-8") as f:
        lines = [ln.strip() for ln in f]
    return [ln for ln in lines if ln and not ln.startswith("#")]


def commands(hosts: Sequence[str], config: str, overrides: Sequence[str] = (),
             port: int = DEFAULT_PORT, repo: str = REPO,
             python: str = sys.executable) -> List[Tuple[str, List[str]]]:
    """``(host, argv)`` a process, in rank order: ``argv`` runs the host's
    shell line through ``bash -c`` here or ``ssh -o BatchMode=yes`` there."""
    if not hosts:
        raise ValueError("the hosts file names no host")
    coord = f"{hosts[0]}:{port}"
    out = []
    for rank, host in enumerate(hosts):
        local_rank = list(hosts[:rank]).count(host)
        line = " ".join([
            "cd", shlex.quote(repo), "&&", f"RANK={rank}", f"LOCAL_RANK={local_rank}",
            "exec", shlex.quote(python), "-m", "swiftsnails_tpu_torch", "train",
            "-config", shlex.quote(config), "-master_addr", shlex.quote(coord),
            "-expected_node_num", str(len(hosts)), *map(shlex.quote, overrides)])
        if host in LOCAL_HOSTS:
            out.append((host, ["bash", "-c", line]))
        else:
            out.append((host, ["ssh", "-o", "BatchMode=yes", host, line]))
    return out


def launch(hosts: Sequence[str], config: str, overrides: Sequence[str] = ()) -> int:
    """Start every process, wait for all; 0 when each exited 0, else 1."""
    port = int(os.environ.get("SNAILS_COORD_PORT", DEFAULT_PORT))
    cmds = commands(hosts, config, overrides, port=port)
    print(f"launching {len(cmds)} processes; coordinator {hosts[0]}:{port}", file=sys.stderr)
    procs: List[subprocess.Popen] = []
    rc = 0
    try:
        for _, argv in cmds:
            procs.append(subprocess.Popen(argv))
        for rank, ((host, _), proc) in enumerate(zip(cmds, procs)):
            code = proc.wait()
            if code != 0:
                rc = 1
                print(f"rank {rank} on {host} exited {code}", file=sys.stderr)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.terminate()
        for proc in procs:
            if proc.poll() is None:
                try:
                    proc.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
    return rc


def _on_term(signum, frame):
    raise SystemExit(128 + signum)


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) < 2 or argv[0] in ("-h", "--help"):
        print(__doc__, file=sys.stderr)
        return 2
    return launch(read_hosts(argv[0]), argv[1], argv[2:])


if __name__ == "__main__":
    signal.signal(signal.SIGTERM, _on_term)  # launch's finally stops the ranks
    sys.exit(main())
