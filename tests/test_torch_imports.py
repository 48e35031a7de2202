"""The port stands alone: no JAX, nothing of the JAX package, and its entry
points ask for the card unless the caller asks for the CPU."""

import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "swiftsnails_tpu_torch"

_PORT_MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
    for p in PKG.rglob("*.py"))


def test_port_imports_without_jax():
    """In a fresh interpreter: this test process already holds jax, which
    ``tests/conftest.py`` imports."""
    code = (
        "import importlib, sys\n"
        f"for m in {_PORT_MODULES!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'swiftsnails_tpu' or m.startswith('swiftsnails_tpu.'))\n"
        "print(len(sys.modules)); assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert len(_PORT_MODULES) >= 15


@pytest.mark.parametrize("module", [
    "swiftsnails_tpu_torch.__main__", "swiftsnails_tpu_torch.cli",
    "swiftsnails_tpu_torch.framework.checkpoint", "swiftsnails_tpu_torch.resilience",
    "swiftsnails_tpu_torch.resilience.chaos", "swiftsnails_tpu_torch.resilience.guardrail",
    "swiftsnails_tpu_torch.resilience.resume", "swiftsnails_tpu_torch.resilience.retry",
    "swiftsnails_tpu_torch.telemetry.ledger", "swiftsnails_tpu_torch.utils.flags",
    "swiftsnails_tpu_torch.utils.tree"])
def test_checkpoint_resilience_and_cli_modules_are_held(module):
    """The modules of the checkpoint, resilience and CLI slice are among the
    ones imported without JAX above and read for its names below."""
    assert module in _PORT_MODULES


@pytest.mark.parametrize("module", [
    "swiftsnails_tpu_torch.telemetry", "swiftsnails_tpu_torch.telemetry.blackbox",
    "swiftsnails_tpu_torch.telemetry.drift", "swiftsnails_tpu_torch.telemetry.drift_lane",
    "swiftsnails_tpu_torch.telemetry.goodput", "swiftsnails_tpu_torch.telemetry.registry",
    "swiftsnails_tpu_torch.telemetry.summary", "swiftsnails_tpu_torch.telemetry.timeseries",
    "swiftsnails_tpu_torch.telemetry.tracer", "swiftsnails_tpu_torch.utils.profiling",
    "swiftsnails_tpu_torch.resilience.drill"])
def test_telemetry_modules_are_held(module):
    """The modules of the telemetry slice are among the ones imported
    without JAX above and read for its names below."""
    assert module in _PORT_MODULES


@pytest.mark.parametrize("module", [
    "swiftsnails_tpu_torch.serving", "swiftsnails_tpu_torch.serving.bench_lane",
    "swiftsnails_tpu_torch.serving.breaker", "swiftsnails_tpu_torch.serving.cache",
    "swiftsnails_tpu_torch.serving.engine", "swiftsnails_tpu_torch.serving.fleet",
    "swiftsnails_tpu_torch.serving.kernels", "swiftsnails_tpu_torch.serving.loadgen",
    "swiftsnails_tpu_torch.serving.router", "swiftsnails_tpu_torch.telemetry.ops",
    "swiftsnails_tpu_torch.telemetry.request_trace", "swiftsnails_tpu_torch.telemetry.slo"])
def test_serving_modules_are_held(module):
    """The modules of the serving slice are among the ones imported without
    JAX above and read for its names below."""
    assert module in _PORT_MODULES


@pytest.mark.parametrize("module", [
    "swiftsnails_tpu_torch.tiered", "swiftsnails_tpu_torch.tiered.store",
    "swiftsnails_tpu_torch.tiered.manager", "swiftsnails_tpu_torch.tiered.bench_lane"])
def test_tiered_modules_are_held(module):
    """The modules of the tiered slice are among the ones imported without
    JAX above and read for its names below."""
    assert module in _PORT_MODULES


@pytest.mark.parametrize("module", [
    "swiftsnails_tpu_torch.freshness", "swiftsnails_tpu_torch.freshness.log",
    "swiftsnails_tpu_torch.freshness.publisher", "swiftsnails_tpu_torch.freshness.subscriber",
    "swiftsnails_tpu_torch.freshness.bench_lane", "swiftsnails_tpu_torch.net",
    "swiftsnails_tpu_torch.net.wire", "swiftsnails_tpu_torch.net.rpc",
    "swiftsnails_tpu_torch.net.delta_stream", "swiftsnails_tpu_torch.net.remote",
    "swiftsnails_tpu_torch.net.replica_server", "swiftsnails_tpu_torch.net.fleet",
    "swiftsnails_tpu_torch.net.bench_lane", "swiftsnails_tpu_torch.cluster",
    "swiftsnails_tpu_torch.cluster.accounting", "swiftsnails_tpu_torch.cluster.supervisor"])
def test_freshness_and_net_modules_are_held(module):
    """The modules of the freshness and network slice are among the ones
    imported without JAX above and read for its names below."""
    assert module in _PORT_MODULES


@pytest.mark.parametrize("module", [
    "swiftsnails_tpu_torch.cluster.worker", "swiftsnails_tpu_torch.cluster.sim",
    "swiftsnails_tpu_torch.cluster.chaos_lane", "swiftsnails_tpu_torch.cluster.status",
    "swiftsnails_tpu_torch.serving.chaos_lane", "swiftsnails_tpu_torch.serving.fleet_lane",
    "swiftsnails_tpu_torch.tools.chaos_drill", "swiftsnails_tpu_torch.utils.shell",
    "swiftsnails_tpu_torch.utils.timer"])
def test_cluster_and_chaos_modules_are_held(module):
    """The modules of the cluster and chaos slice are among the ones
    imported without JAX above and read for its names below."""
    assert module in _PORT_MODULES


@pytest.mark.parametrize("module", [
    "swiftsnails_tpu_torch.models.seqlm", "swiftsnails_tpu_torch.parallel.sequence",
    "swiftsnails_tpu_torch.parallel.cluster", "swiftsnails_tpu_torch.tools.eval_embeddings",
    "swiftsnails_tpu_torch.tools.perf_diff", "swiftsnails_tpu_torch.tools.drift_rate"])
def test_sequence_modules_are_held(module):
    """The modules of the sequence-model slice are among the ones imported
    without JAX above and read for its names below."""
    assert module in _PORT_MODULES


def test_seqlm_defaults_to_the_card():
    """``SeqLMTrainer`` resolves ``device=None`` to the card and raises
    without one."""
    from swiftsnails_tpu_torch.models.seqlm import SeqLMTrainer
    from swiftsnails_tpu_torch.utils.config import Config

    _no_card()
    with pytest.raises(RuntimeError, match="CUDA"):
        SeqLMTrainer(Config({"seq_len": "8"}), corpus_ids=np.zeros(64, np.int32),
                     vocab_size=4)


def test_cluster_and_chaos_entry_points_default_to_the_card(tmp_path):
    """The drills, the cluster, serve and fleet lanes and the drill tool
    resolve ``device=None`` to the card and raise without one."""
    from swiftsnails_tpu_torch.cluster.chaos_lane import (
        chaos_cluster_bench, run_cluster_drills)
    from swiftsnails_tpu_torch.resilience.drill import chaos_bench, run_drill_matrix
    from swiftsnails_tpu_torch.serving.chaos_lane import chaos_serve_bench
    from swiftsnails_tpu_torch.serving.fleet_lane import fleet_bench, fleet_chaos_drill
    from swiftsnails_tpu_torch.tools.chaos_drill import main as drill_main

    _no_card()
    for lane in (chaos_cluster_bench, run_cluster_drills, chaos_serve_bench, fleet_bench,
                 fleet_chaos_drill):
        with pytest.raises(RuntimeError, match="CUDA"):
            lane(small=True, workdir=str(tmp_path / lane.__name__))
    with pytest.raises(RuntimeError, match="CUDA"):
        chaos_bench(workdir=str(tmp_path), small=True)
    # the matrix records a drill that raises as unrecovered, naming the card
    res = run_drill_matrix(fast=True, workdir=str(tmp_path / "matrix"))
    assert all("CUDA" in r["error"] for r in res.values())
    assert drill_main(["--fast", "--workdir", str(tmp_path / "tool")]) == 1


def test_freshness_and_net_entry_points_default_to_the_card(tmp_path):
    """The freshness and net lanes and the replica process resolve
    ``device=None`` to the card and raise without one."""
    from swiftsnails_tpu_torch.freshness.bench_lane import freshness_bench, freshness_chaos_drill
    from swiftsnails_tpu_torch.net.bench_lane import net_bench, net_chaos_drill
    from swiftsnails_tpu_torch.net.replica_server import main as replica_main

    _no_card()
    for lane in (freshness_bench, freshness_chaos_drill, net_bench, net_chaos_drill):
        with pytest.raises(RuntimeError, match="CUDA"):
            lane(small=True, workdir=str(tmp_path / lane.__name__))
    with pytest.raises(RuntimeError, match="CUDA"):
        replica_main(["--root", str(tmp_path)])


def test_tiered_entry_points_default_to_the_card(tmp_path):
    """``TieredTable``, the tiered ``Servant`` and ``tiered_bench`` resolve
    ``device=None`` to the card and raise without one."""
    from swiftsnails_tpu_torch.parallel.store import TableState
    from swiftsnails_tpu_torch.serving import Servant
    from swiftsnails_tpu_torch.tiered import HostMaster, TieredTable
    from swiftsnails_tpu_torch.tiered.bench_lane import tiered_bench

    _no_card()
    master = HostMaster(TableState(table=torch.zeros(8, 4), slots={}), "dense")
    with pytest.raises(RuntimeError, match="CUDA"):
        TieredTable(master, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        Servant({"t": np.zeros((8, 4), np.float32)}, tier_hbm_budget_mb=1.0)
    with pytest.raises(RuntimeError, match="CUDA"):
        tiered_bench(small=True, workdir=str(tmp_path))


def test_serving_entry_points_default_to_the_card(tmp_path):
    """``Servant``, ``Fleet.from_checkpoint`` and ``serve_bench`` resolve
    ``device=None`` to the card and raise without one."""
    from swiftsnails_tpu_torch.serving import Fleet, Servant
    from swiftsnails_tpu_torch.serving.bench_lane import serve_bench
    from swiftsnails_tpu_torch.utils.config import Config

    _no_card()
    with pytest.raises(RuntimeError, match="CUDA"):
        Servant({"t": np.zeros((4, 4), np.float32)})
    with pytest.raises(RuntimeError, match="CUDA"):
        Fleet.from_checkpoint(str(tmp_path), Config({}), replicas=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_bench(small=True, workdir=str(tmp_path))


def test_cli_run_loads_no_jax():
    code = (
        "import runpy, sys\n"
        "sys.argv = ['swiftsnails_tpu_torch', 'models']\n"
        "try:\n"
        "    runpy.run_module('swiftsnails_tpu_torch', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'swiftsnails_tpu' or m.startswith('swiftsnails_tpu.'))\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["ffm", "fm", "logreg", "seqlm", "widedeep", "word2vec"]


# ``import jax`` / ``from jax``, and the JAX package's name anywhere except
# in ``swiftsnails_tpu_torch`` and in a file path (``swiftsnails_tpu/...``,
# as chip_smoke.py names the TPU kernel each kernel replaces).
_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b)|swiftsnails_tpu(?!_torch|/)", re.M)


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")]
    + ["chip_smoke.py", "phase_clocks.py", "train_sweep.py"]))
def test_source_names_no_jax(path):
    text = (ROOT / path).read_text()
    assert not _FORBIDDEN.findall(text), path


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the default device is then valid")


def test_trainer_without_device_raises_here():
    from swiftsnails_tpu_torch.data.vocab import Vocab
    from swiftsnails_tpu_torch.models.word2vec import Word2VecTrainer
    from swiftsnails_tpu_torch.utils.config import Config

    _no_card()
    vocab = Vocab(["a", "b", "c"], np.array([3, 2, 1]))
    with pytest.raises(RuntimeError, match="CUDA"):
        Word2VecTrainer(Config({"dim": "8"}), corpus_ids=np.zeros(4, np.int32),
                        vocab=vocab)


def test_resolve_device():
    from swiftsnails_tpu_torch.utils.device import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported"):
        resolve_device("meta")
    _no_card()
    for dev in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device(dev)


def test_registry_finds_the_port_trainer():
    from swiftsnails_tpu_torch.models.registry import get_model
    from swiftsnails_tpu_torch.models.word2vec import Word2VecTrainer

    assert get_model("word2vec") is Word2VecTrainer
