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


# ``import jax`` / ``from jax``, and the JAX package's name anywhere except
# in ``swiftsnails_tpu_torch`` and in a file path (``swiftsnails_tpu/...``,
# as chip_smoke.py names the TPU kernel each kernel replaces).
_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b)|swiftsnails_tpu(?!_torch|/)", re.M)


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")] + ["chip_smoke.py"]))
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
