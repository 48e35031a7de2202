"""``python -m swiftsnails_tpu_torch`` end to end in subprocesses, on the CPU
(``-device cpu``): the cases of ``tests/test_cli.py`` for the port, plus a
real SIGTERM to a training process, which drains with a committed final
checkpoint, and the run without ``-device`` on a machine without a card,
which fails and names the missing card. ``models`` lists the families the
port has, the JAX package's six.
"""

import os
import re
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from swiftsnails_tpu_torch import cli
from swiftsnails_tpu_torch.framework import checkpoint as ckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return env


def _run_cli(args, cwd):
    return subprocess.run([sys.executable, "-m", "swiftsnails_tpu_torch", *args],
                          capture_output=True, text=True, env=_env(), cwd=cwd, timeout=120)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    path = tmp_path_factory.mktemp("cli") / "corpus.txt"
    rng = np.random.default_rng(0)
    words = [f"tok{i}" for i in range(30)]
    path.write_text(" ".join(rng.choice(words, 3000)))
    return path


def _conf(tmp_path, corpus, **over):
    keys = {"model": "word2vec", "data": corpus, "dim": 8, "window": 2, "negatives": 2,
            "learning_rate": 0.1, "batch_size": 128, "num_iters": 2, "min_count": 1,
            "subsample": 0, "param_backup_root": tmp_path / "ckpt",
            "param_backup_period": 3, "output": tmp_path / "vec.txt", "log_every": 0}
    keys.update(over)
    conf = tmp_path / "train.conf"
    conf.write_text("# word2vec training config (reference key: value syntax)\n"
                    + "".join(f"{k}: {v}\n" for k, v in keys.items()))
    return conf


def test_cli_train_export_resume(tmp_path, corpus):
    conf = _conf(tmp_path, corpus)
    ckpt_root, out = tmp_path / "ckpt", tmp_path / "vec.txt"
    proc = _run_cli(["train", "-config", str(conf), "-device", "cpu"], cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-2000:]
    header = out.read_text().split("\n", 1)[0].split()
    assert header == ["30", "8"]  # vocab size, dim
    steps = ckpt.intact_steps(str(ckpt_root))
    assert len(steps) == 3 and steps[0] % 3 == 0  # param_backup_keep's default

    # export reads the newest checkpoint back, verified
    out2 = tmp_path / "vec2.txt"
    proc = _run_cli(["export", "-config", str(conf), "-device", "cpu",
                     "-checkpoint", str(ckpt_root), "-out", str(out2)], cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert out2.read_text().split("\n", 1)[0] == "30 8"

    # resume: 1 continues the counter from the newest checkpoint
    proc = _run_cli(["train", "-config", str(conf), "-device", "cpu", "-resume", "1"],
                    cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert f"resume: restored step {steps[0]}" in proc.stderr
    assert ckpt.intact_steps(str(ckpt_root))[0] > steps[0]

    # a corrupt newest checkpoint is never exported
    from swiftsnails_tpu_torch.resilience import corrupt_checkpoint_dir

    corrupt_checkpoint_dir(str(ckpt_root))
    proc = _run_cli(["export", "-config", str(conf), "-device", "cpu",
                     "-checkpoint", str(ckpt_root), "-out", str(tmp_path / "bad.txt")],
                    cwd=tmp_path)
    assert proc.returncode != 0 and "CheckpointError" in proc.stderr


def test_cli_models_and_role_notes(tmp_path):
    proc = _run_cli(["models"], cwd=tmp_path)
    assert proc.returncode == 0
    assert proc.stdout.split() == ["ffm", "fm", "logreg", "seqlm", "widedeep", "word2vec"]
    proc = _run_cli(["master"], cwd=tmp_path)
    assert proc.returncode == 0
    assert "no separate master role" in proc.stderr


def test_cli_bad_config_is_fatal(tmp_path):
    conf = tmp_path / "bad.conf"
    conf.write_text("model word2vec\n")  # missing colon -> parse error
    proc = _run_cli(["train", "-config", str(conf), "-device", "cpu"], cwd=tmp_path)
    assert proc.returncode != 0 and "config error" in proc.stderr


@pytest.mark.parametrize("cmd", ["net-serve", "supervisor-status", "bogus"])
def test_cli_unported_commands_exit_2(cmd, capsys, tmp_path):
    """``net-serve`` and ``supervisor-status`` are ported since this test
    was written: without ``--root`` the replica server's argument parser
    exits 2 naming the flag; ``supervisor-status`` over a missing ledger
    exits 1 naming it, as the JAX command does
    (``tests/test_torch_cluster_sim.py`` drives it over a real one); an
    unknown command still exits 2 and names the commands there are."""
    if cmd == "net-serve":
        with pytest.raises(SystemExit) as ei:
            cli.main([cmd])
        assert ei.value.code == 2 and "--root" in capsys.readouterr().err
        return
    if cmd == "supervisor-status":
        missing = str(tmp_path / "nope.jsonl")
        assert cli.main([cmd, missing]) == 1
        assert missing in capsys.readouterr().err
        return
    assert cli.main([cmd]) == 2
    err = capsys.readouterr().err
    assert "supervisor-status" in err and "ROADMAP.md" not in err


def _serve_checkpoint(tmp_path, cap=64, dim=8):
    """A port checkpoint of a packed word2vec state (2 steps) and its conf."""
    from swiftsnails_tpu_torch import convert
    from swiftsnails_tpu_torch.ops import rowdma

    root = tmp_path / "ck"
    for step in (1, 2):
        rng = np.random.default_rng(step)
        shape = rowdma.packed_shape(cap, dim)
        state = convert.w2v_state_from_numpy(
            rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32), device="cpu")
        ckpt.save_checkpoint(str(root), state, step=step)
    conf = tmp_path / "serve.conf"
    conf.write_text(f"model: word2vec\ndim: {dim}\ncapacity: {cap}\npacked: 1\n"
                    "serve_batch_buckets: 4,16\n")
    return conf, root, rowdma.unpack_rows(state.in_table.table, dim).numpy()


def _serve(args, script, cwd):
    return subprocess.run([sys.executable, "-m", "swiftsnails_tpu_torch", "serve", *args],
                          input=script, capture_output=True, text=True, env=_env(),
                          cwd=cwd, timeout=120)


@pytest.mark.parametrize("replicas", [1, 2])
def test_cli_serve_repl_on_the_cpu(tmp_path, replicas):
    import json

    conf, root, rows = _serve_checkpoint(tmp_path)
    fleet_ops = "add\ndrain r0\npull 5\n" if replicas > 1 else ""
    deltas = tmp_path / "deltas"  # no publisher has opened it yet
    script = (f"pull 3 5 63\ntopk 3 4\nstats\nhealth\nops\nsubscribe {deltas}\n"
              f"freshness\nbogus\n{fleet_ops}\nquit\npull 1\n")
    proc = _serve(["-config", str(conf), "-checkpoint", str(root), "-device", "cpu",
                   "-replicas", str(replicas)], script, tmp_path)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = [json.loads(line) for line in proc.stdout.splitlines()]
    np.testing.assert_allclose(out[0]["rows"], rows[[3, 5, 63]], rtol=0, atol=1e-6)
    topk = out[1]["topk"]
    assert len(topk) == 4 and 3 not in [i for i, _ in topk]
    assert "kernels" in out[2] and out[3]["status"] == "ok"
    assert out[4] == {"ops": "printed"}
    # subscribe and freshness are ported since this test was written
    assert out[5] == {"subscribed": str(deltas), "stream_open": False}
    assert out[6]["applied_seq"] == 0 and out[6]["polling"] and out[6]["publisher"] is None
    assert "unknown op" in out[7]["error"]
    if replicas > 1:
        assert out[8] == {"added": "r2"} and out[9]["drained"]["clean"]
        np.testing.assert_allclose(out[10]["rows"], rows[[5]], rtol=0, atol=1e-6)
    assert "final_stats" in out[-1] and len(out) == (12 if replicas > 1 else 9)
    assert "serving" in proc.stderr


def test_cli_serve_without_a_card_names_it(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the default device is then valid")
    conf, root, _ = _serve_checkpoint(tmp_path)
    proc = _serve(["-config", str(conf), "-checkpoint", str(root)], "pull 1\n", tmp_path)
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr
    assert not proc.stdout.strip()  # nothing was served on the CPU instead


def test_cli_ops_renders_a_ledger(tmp_path, capsys):
    from swiftsnails_tpu_torch.telemetry.ledger import Ledger

    assert cli.main(["ops", str(tmp_path / "missing.jsonl")]) == 1
    led = Ledger(str(tmp_path / "l.jsonl"))
    led.append("slo_burn", {"source": "serving", "kernel": "pull", "burn_short": 3.0,
                            "burn_long": 2.5, "alert_burn": 2.0,
                            "budget_remaining_pct": 10.0, "slo_latency_ms": 5.0,
                            "slo_availability": 0.999, "window_s": 60.0})
    capsys.readouterr()
    assert cli.main(["ops", str(tmp_path / "l.jsonl")]) == 0
    assert "pull" in capsys.readouterr().out


def test_cli_sigterm_drains_with_a_final_checkpoint(tmp_path, corpus):
    """A SIGTERM after the first periodic save drains: exit 0, and the
    drain's own save, committed last, at the step where the loop stopped
    (which may be a periodic step: the signal can land just after one's
    save, and the step is then committed twice), its cursor that step."""
    conf = _conf(tmp_path, corpus, num_iters=400, param_backup_period=20)
    root = str(tmp_path / "ckpt")
    proc = subprocess.Popen(
        [sys.executable, "-m", "swiftsnails_tpu_torch", "train", "-config", str(conf),
         "-device", "cpu"], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env(), cwd=tmp_path)
    try:
        deadline = time.monotonic() + 180  # a loaded host starts slowly
        while not ckpt.intact_steps(root) and time.monotonic() < deadline:
            assert proc.poll() is None, proc.communicate()[1][-2000:]
            time.sleep(0.05)
        periodic = ckpt.intact_steps(root)
        assert periodic, "no checkpoint within 180 s"
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=180)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-2000:]
    assert "preempted (SIGTERM): drained with a final checkpoint" in err
    drained = int(re.search(r"preemption \(SIGTERM\): drained at step (\d+)", err).group(1))
    commits = [int(s) for s in re.findall(r"checkpoint: committed step_(\d+)", err)]
    # the periodic saves, each once, then the drain's own save
    assert commits == list(range(20, drained + 1, 20)) + [drained], commits
    assert drained >= periodic[0]
    final = ckpt.intact_steps(root)[0]
    assert final == drained
    man = ckpt.read_manifest(root, final)
    assert man["data_cursor"]["step"] == final


def test_cli_train_without_a_card_names_it(tmp_path, corpus):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the default device is then valid")
    proc = _run_cli(["train", "-config", str(_conf(tmp_path, corpus))], cwd=tmp_path)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert not (tmp_path / "ckpt").exists()  # nothing ran on the CPU instead


def test_cli_train_with_telemetry_then_ledger_report_and_trace_summary(tmp_path, corpus):
    """A CLI run with ``-telemetry 1``, ``-trace_path`` and ``-ledger_path``,
    then ``ledger-report`` (the report, ``--failures``, ``--diff``,
    ``--check-regression``) and ``trace-summary`` on its files, in
    subprocesses, as the JAX package's ``tests/test_cli.py`` drives them."""
    conf = _conf(tmp_path, corpus, log_every=1)
    ledger, trace = tmp_path / "ledger.jsonl", tmp_path / "trace.json"
    for _ in range(2):
        proc = _run_cli(["train", "-config", str(conf), "-device", "cpu", "-telemetry", "1",
                         "-trace_path", str(trace), "-ledger_path", str(ledger)], cwd=tmp_path)
        assert proc.returncode == 0, proc.stderr[-2000:]
    assert '"goodput"' in proc.stdout
    proc = _run_cli(["ledger-report", str(ledger)], cwd=tmp_path)
    assert proc.returncode == 0 and "training runs" in proc.stdout
    assert "model=word2vec" in proc.stdout and "checkpoint=" in proc.stdout
    proc = _run_cli(["ledger-report", str(ledger), "--failures"], cwd=tmp_path)
    assert proc.returncode == 0 and "run      model=word2vec" in proc.stdout
    proc = _run_cli(["ledger-report", str(ledger), "--diff", "-2", "-1"], cwd=tmp_path)
    assert proc.returncode == 0 and "dominant contributor" in proc.stdout
    proc = _run_cli(["ledger-report", str(ledger), "--check-regression", "5"], cwd=tmp_path)
    assert proc.returncode == 2 and "no measured bench record" in proc.stdout
    proc = _run_cli(["trace-summary", str(trace)], cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr
    for span in ("prefetch-wait", "h2d", "step", "metrics-flush", "checkpoint"):
        assert span in proc.stdout


@pytest.mark.parametrize("cmd,args,rc", [
    ("ledger-report", ["--diff", "0", "5"], 2), ("trace-summary", [], 1)])
def test_cli_ledger_report_and_trace_summary_errors(tmp_path, cmd, args, rc, capsys):
    """A run index past the ledger's runs exits 2; a file that is neither a
    trace nor metrics exits 1."""
    bad = tmp_path / "bad.txt"
    bad.write_text("not a trace\n")
    assert cli.main([cmd, str(bad), *args]) == rc
    assert capsys.readouterr().out.strip()
