"""``python -m swiftsnails_tpu_torch.tools.launch_pod``, the port's twin of
``tools/launch_pod.sh``, on the CPU: two ``localhost`` lines start two gloo
ranks of ``tests/test_torch_mesh.py::test_cli_train_joins_the_cluster``'s
config, and rank 0's vectors equal those of the same two ranks started by
hand with ``RANK`` and by the module docstring's ``torchrun`` line; a
config every rank refuses exits non-zero; the command list carries
``RANK``, ``LOCAL_RANK`` and the ``ssh`` form."""

import os
import shlex
import socket
import subprocess
import sys

import numpy as np
import pytest

from swiftsnails_tpu_torch.tools import launch_pod

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 180


def _env(**extra):
    return {**os.environ, "OMP_NUM_THREADS": "1",
            "PYTHONPATH": os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")]),
            **extra}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _config(tmp_path, model="word2vec"):
    """test_cli_train_joins_the_cluster's corpus and config, the data by its
    absolute path (the launcher runs from the repository's root)."""
    rng = np.random.default_rng(0)
    corpus = tmp_path / "corpus.txt"
    corpus.write_text("\n".join(
        " ".join(f"w{i}" for i in rng.integers(0, 50, 20)) for _ in range(50)) + "\n")
    conf = tmp_path / "w.conf"
    conf.write_text(f"model: {model}\ndata: {corpus}\ndim: 8\nwindow: 2\nnegatives: 2\n"
                    "batch_size: 64\npool_size: 8\npool_block: 16\nnum_iters: 1\n"
                    "subsample: 0\nmin_count: 1\nuse_native: 0\nlog_every: 5\n")
    return conf


def _launch(tmp_path, conf, *overrides):
    hosts = tmp_path / "hosts"
    hosts.write_text("# two ranks on this host\nlocalhost\n\n  localhost  \n")
    return subprocess.run(
        [sys.executable, "-m", "swiftsnails_tpu_torch.tools.launch_pod", str(hosts),
         str(conf), "-device", "cpu", "-init_timeout", "120", *overrides],
        env=_env(SNAILS_COORD_PORT=str(_free_port())), cwd=tmp_path,
        capture_output=True, text=True, timeout=TIMEOUT_S)


def test_two_localhost_ranks_equal_the_hand_started_run(tmp_path):
    conf = _config(tmp_path)
    # by hand, as test_cli_train_joins_the_cluster starts them
    procs = [subprocess.Popen(
        [sys.executable, "-m", "swiftsnails_tpu_torch", "train", "-config", str(conf),
         "-device", "cpu", "-expected_node_num", "2", "-init_timeout", "120",
         "-master_addr", f"file://{tmp_path}/rendezvous", "-output", f"hand{r}.txt"],
        cwd=tmp_path, env=_env(RANK=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=TIMEOUT_S)
            assert p.returncode == 0, err
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    out = tmp_path / "launched.txt"
    proc = _launch(tmp_path, conf, "-output", str(out))
    assert proc.returncode == 0, proc.stderr
    assert "launching 2 processes; coordinator localhost:" in proc.stderr
    for r in range(2):
        assert f"joined cluster: process {r}/2 via localhost:" in proc.stderr
    assert proc.stderr.count(f"exported parameters to {out}") == 1  # rank 0 alone
    assert out.read_text().startswith("50 8\n")
    assert out.read_text() == (tmp_path / "hand0.txt").read_text()
    # the documented alternative: torchrun sets RANK and the env:// variables
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1", "--node-rank", "0",
         "--nproc-per-node", "2", "--master-addr", "127.0.0.1",
         "--master-port", str(_free_port()), "-m", "swiftsnails_tpu_torch", "train",
         "-config", str(conf), "-device", "cpu", "-master_addr", "env://",
         "-expected_node_num", "2", "-output", "torchrun.txt"],
        cwd=tmp_path, env=_env(), capture_output=True, text=True, timeout=TIMEOUT_S)
    assert run.returncode == 0, run.stderr
    assert (tmp_path / "torchrun.txt").read_text() == out.read_text()


def test_a_config_every_rank_refuses_exits_nonzero(tmp_path):
    proc = _launch(tmp_path, _config(tmp_path, model="no_such_model"))
    assert proc.returncode != 0
    assert "unknown model 'no_such_model'" in proc.stderr
    assert "rank 0 on localhost exited" in proc.stderr
    assert "rank 1 on localhost exited" in proc.stderr


def test_the_command_list_carries_rank_local_rank_and_ssh():
    cmds = launch_pod.commands(["hostA", "hostB", "hostA"], "conf dir/w.conf",
                               ["-output", "my vec.txt"], port=29511,
                               repo="/srv/snails", python="/usr/bin/python3")
    assert [h for h, _ in cmds] == ["hostA", "hostB", "hostA"]
    for rank, ((host, argv), local) in enumerate(zip(cmds, [0, 0, 1])):
        assert argv[:4] == ["ssh", "-o", "BatchMode=yes", host] and len(argv) == 5
        words = shlex.split(argv[4])
        assert words[:3] == ["cd", "/srv/snails", "&&"]
        assert words[3:6] == [f"RANK={rank}", f"LOCAL_RANK={local}", "exec"]
        assert words[6:] == ["/usr/bin/python3", "-m", "swiftsnails_tpu_torch", "train",
                             "-config", "conf dir/w.conf", "-master_addr", "hostA:29511",
                             "-expected_node_num", "3", "-output", "my vec.txt"]
    local = launch_pod.commands(["127.0.0.1", "localhost"], "w.conf")
    assert [argv[:2] for _, argv in local] == [["bash", "-c"]] * 2
    assert "-master_addr 127.0.0.1:29500 " in local[1][1][2]
    with pytest.raises(ValueError, match="no host"):
        launch_pod.commands([], "w.conf")


def test_the_hosts_file_skips_blank_lines_and_comments(tmp_path):
    hosts = tmp_path / "hosts"
    hosts.write_text("# the pod\nhost0\n\n   \n  host1 \n#host2\nhost0\n")
    assert launch_pod.read_hosts(str(hosts)) == ["host0", "host1", "host0"]


def test_usage_without_a_config(capsys):
    assert launch_pod.main(["hosts-only"]) == 2
    assert "launch_pod <hosts-file> <config>" in capsys.readouterr().err
