"""Single-host multi-process smoke test (``src/tools/cluster_test.sh``
parity) — the JAX package's ``tools/cluster_test.py``.

The reference launched master, server and worker on one box and watched
``master.log``. Here the three roles are one SPMD ``train`` role: the test
spawns N CPU processes that rendezvous over TCP on a free port
(:func:`~swiftsnails_tpu_torch.parallel.cluster.initialize_cluster`, the
``gloo`` backend), check their ``shard_token_stream`` span, train a tiny
word2vec for 5 steps under an ``(N / 2, 2)`` ``(data, model)`` mesh, meet
at the end-of-training barrier and exit 0. The JAX tool trains each process
alone; the port's processes form a mesh because they can. Any process that
fails, or a run past 300 s, fails the test::

    python -m swiftsnails_tpu_torch.tools.cluster_test --nproc 2

Each process's output goes to ``proc<i>.log`` under ``--logdir`` (default:
a new temporary directory, removed when the test passes), printed when it
fails.
"""

from __future__ import annotations

import argparse
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time

DEADLINE_S = 300
STEPS = 5


def _child(rank: int, nproc: int, port: int) -> int:
    import numpy as np
    import torch

    torch.set_num_threads(1)  # N processes share the host's cores

    from swiftsnails_tpu_torch.data.vocab import Vocab
    from swiftsnails_tpu_torch.framework.trainer import TrainLoop
    from swiftsnails_tpu_torch.models.word2vec import Word2VecTrainer
    from swiftsnails_tpu_torch.parallel.cluster import (
        barrier, initialize_cluster, process_info, shard_token_stream)
    from swiftsnails_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, make_mesh
    from swiftsnails_tpu_torch.utils.config import Config

    initialize_cluster(Config({"master_addr": f"127.0.0.1:{port}",
                               "expected_node_num": str(nproc),
                               "init_timeout": "60", "device": "cpu"}), process_id=rank)
    idx, count = process_info()
    assert (idx, count) == (rank, nproc), (idx, count)
    print(f"process {idx}/{count} joined", flush=True)

    # every process sees the same corpus (seed 0); its contiguous span is
    # the reference's Hadoop stdin split (run_worker.sh)
    rng = np.random.default_rng(0)
    vocab = Vocab([f"w{i}" for i in range(32)],
                  np.maximum(rng.integers(1, 9, 32), 1).astype(np.int64))
    full = rng.integers(0, 32, 2000).astype(np.int32)
    span = shard_token_stream(full)
    parts = np.array_split(full, nproc)
    assert np.array_equal(span, parts[idx]), "wrong shard for this process"
    start = sum(len(p) for p in parts[:idx])
    print(f"process {idx} shard: tokens [{start}, +{len(span)})", flush=True)

    # under the mesh the data axis splits each batch, so every process
    # reads the whole corpus and keeps its part of each batch
    mesh = make_mesh({DATA_AXIS: nproc // 2, MODEL_AXIS: 2}, device="cpu")
    cfg = Config({"dim": "8", "window": "2", "negatives": "2", "learning_rate": "0.1",
                  "batch_size": "64", "subsample": "0", "num_iters": "1",
                  "pool_size": "8", "pool_block": "16", "use_native": "0"})
    tr = Word2VecTrainer(cfg, mesh=mesh, corpus_ids=full, vocab=vocab)
    state = TrainLoop(tr, log_every=0).run(max_steps=STEPS)
    assert all(torch.isfinite(t.table).all() for t in state), "non-finite table"
    print(f"process {idx} trained {STEPS} steps on mesh {mesh.shape} at {mesh.coords}",
          flush=True)
    barrier("end_of_training")
    print(f"process {idx} done", flush=True)
    import torch.distributed as dist

    dist.destroy_process_group()
    return 0


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--nproc", type=int, default=2)
    p.add_argument("--logdir", default=None)
    p.add_argument("--child", type=int, nargs=3, metavar=("RANK", "NPROC", "PORT"),
                   help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.child:
        return _child(*args.child)
    if args.nproc < 2 or args.nproc % 2:
        p.error("--nproc must be even and at least 2: the mesh is (nproc / 2, 2)")

    logdir = args.logdir or tempfile.mkdtemp(prefix="snails_cluster_test_")
    os.makedirs(logdir, exist_ok=True)
    port = _free_port()
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    procs, logs = [], []
    for i in range(args.nproc):
        log = open(os.path.join(logdir, f"proc{i}.log"), "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "swiftsnails_tpu_torch.tools.cluster_test",
             "--child", str(i), str(args.nproc), str(port)],
            stdout=log, stderr=subprocess.STDOUT, env=env, cwd=repo))
    deadline = time.time() + DEADLINE_S
    rc = 0
    try:
        for i, proc in enumerate(procs):
            try:
                code = proc.wait(timeout=max(1.0, deadline - time.time()))
            except subprocess.TimeoutExpired:
                code = f"killed past the {DEADLINE_S} s deadline"
            if code != 0:
                rc = 1
                print(f"process {i} FAILED (exit {code})", file=sys.stderr)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for log in logs:
            log.close()
    if rc:
        for i in range(args.nproc):
            print(f"--- proc{i}.log:", file=sys.stderr)
            with open(os.path.join(logdir, f"proc{i}.log")) as f:
                sys.stderr.write(f.read())
    if rc == 0 and args.logdir is None:
        shutil.rmtree(logdir, ignore_errors=True)
    print("cluster smoke test:", "PASS" if rc == 0 else f"FAIL (logs: {logdir})")
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
