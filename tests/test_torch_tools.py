"""The port's ``tools.eval_embeddings`` and ``tools.perf_diff`` against the
JAX package's ``tools/eval_embeddings.py`` and ``tools/perf_diff.py``, on
the CPU: the same ``vectors.txt`` (made from a numpy seed, with tied rows)
or the same ledger gives the same printed output and exit code."""

import importlib.util
import pathlib

import numpy as np
import pytest

from swiftsnails_tpu_torch.tools import eval_embeddings, perf_diff

from test_torch_ledger import _write

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}",
                                                  ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def vectors(tmp_path_factory):
    """300 words of dim 12, three rows repeated so the ranking meets ties."""
    rng = np.random.default_rng(7)
    vecs = rng.normal(size=(300, 12)).astype(np.float32)
    vecs[[40, 41, 42]] = vecs[5]
    path = tmp_path_factory.mktemp("emb") / "vectors.txt"
    with open(path, "w", encoding="utf-8") as f:
        f.write(f"{len(vecs)} {vecs.shape[1]}\n")
        for i, row in enumerate(vecs):
            f.write(f"w{i} " + " ".join(f"{x:.6f}" for x in row) + "\n")
    return str(path)


@pytest.mark.parametrize("args", [
    ["--neighbors", "w5", "--topn", "6"],
    ["--neighbors", "w0"],
    ["--sim", "w3", "w9"],
    ["--analogy", "w1", "w2", "w3", "--topn", "5"],
    [],
], ids=["neighbors_ties", "neighbors", "sim", "analogy", "summary"])
def test_eval_embeddings_prints_what_the_jax_tool_prints(vectors, args, capsys):
    jax_tool = _jax_tool("eval_embeddings")
    assert jax_tool.main([vectors, *args]) == 0
    want = capsys.readouterr()
    assert eval_embeddings.main([vectors, *args, "--device", "cpu"]) == 0
    got = capsys.readouterr()
    assert (got.out, got.err) == (want.out, want.err)
    if args[:2] == ["--neighbors", "w5"]:
        assert got.out.split()[:6:2] == ["w40", "w41", "w42"]


def test_eval_embeddings_loads_what_the_jax_tool_loads(vectors):
    words, index, vecs = eval_embeddings.load_embeddings(vectors)
    jw, ji, jv = _jax_tool("eval_embeddings").load_embeddings(vectors)
    assert words == jw and index == ji
    np.testing.assert_array_equal(vecs, jv)


@pytest.mark.parametrize("specs", [["-2", "-1"], ["0", "1"], ["-1", "-2"], ["9", "-1"],
                                   ["no-such-file.json", "-1"]])
def test_perf_diff_prints_what_the_jax_tool_prints(tmp_path, specs, capsys):
    from swiftsnails_tpu_torch.telemetry import ledger

    path = str(_write(ledger, tmp_path / "run.jsonl"))
    rc_jax = _jax_tool("perf_diff").main(["--ledger", path, *specs])
    want = capsys.readouterr()
    rc = perf_diff.main(["--ledger", path, *specs])
    got = capsys.readouterr()
    assert rc == rc_jax == (2 if specs[0] in ("9", "no-such-file.json") else 0)
    assert (got.out, got.err.replace("perf_diff", "")) == \
        (want.out, want.err.replace("perf_diff", ""))
    if rc == 0:
        assert "perf diff: A = " in got.out
