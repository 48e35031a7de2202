"""``stream: 1``, the bounded-memory ingestion, against the whole-file path and
the JAX package's, on the CPU: the port's Python and native corpus and CTR
streams equal the whole file, chunk for chunk, and a byte span's readers
partition it; the trainers' streamed batches equal the whole-file ones at
one chunk and the JAX trainers' streamed batches; and a streamed, natively
fed CLI run stopped by a real SIGTERM and resumed commits the uninterrupted
run's checkpoints and writes its vectors byte for byte. Every comparison is
exact.
"""

import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from swiftsnails_tpu.data import text as jax_text
from swiftsnails_tpu.models import word2vec as jax_w2v
from swiftsnails_tpu.models.registry import get_model as jax_get_model
from swiftsnails_tpu.utils.config import Config as JaxConfig
from swiftsnails_tpu_torch.data import ctr, native, text
from swiftsnails_tpu_torch.framework import checkpoint as ckpt
from swiftsnails_tpu_torch.models import word2vec
from swiftsnails_tpu_torch.models.registry import get_model
from swiftsnails_tpu_torch.utils.config import Config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def corpus_file(tmp_path_factory):
    rng = np.random.default_rng(0)
    words = [f"w{i}" for i in range(200)] + ["ünï", "café"]
    lines = [" ".join(rng.choice(words, rng.integers(1, 40))) for _ in range(600)]
    path = tmp_path_factory.mktemp("stream") / "corpus.txt"
    path.write_text("\n".join(lines) + "\n", encoding="utf-8")
    return str(path)


@pytest.fixture(scope="module")
def ctr_file(tmp_path_factory):
    labels, feats, _ = ctr.synth_ctr(3000, 5, 30, seed=2)
    path = tmp_path_factory.mktemp("stream") / "ctr.txt"
    with open(path, "w") as f:
        f.write("label header line\n")
        for y, row in zip(labels, feats):
            f.write(f"{int(y)} " + " ".join(str(x) for x in row) + "\n")
    return str(path)


def _cat(chunks):
    chunks = list(chunks)
    return np.concatenate(chunks) if chunks else np.empty(0, np.int32)


@pytest.mark.parametrize("use_native", [False, True], ids=["python", "native"])
def test_text_stream_equals_whole_file(corpus_file, use_native):
    ids, vocab = text.encode_corpus(corpus_file, min_count=2, use_native=use_native)
    v2, factory = text.encode_corpus_stream(corpus_file, 1000, min_count=2,
                                            use_native=use_native)
    assert v2.words == vocab.words
    np.testing.assert_array_equal(v2.counts, vocab.counts)
    chunks = list(factory())
    assert all(len(c) == 1000 for c in chunks[:-1])
    np.testing.assert_array_equal(_cat(chunks), ids)
    jids, jvocab = jax_text.encode_corpus(corpus_file, min_count=2, use_native=use_native)
    np.testing.assert_array_equal(ids, jids)
    assert jvocab.words == vocab.words


def test_python_stream_small_buffer_carry(corpus_file):
    ids, vocab = text.encode_corpus(corpus_file, min_count=1, use_native=False)
    got = _cat(text.iter_encoded_chunks(corpus_file, vocab, 777, buf_size=64))
    np.testing.assert_array_equal(got, ids)


@pytest.mark.parametrize("use_native", [False, True], ids=["python", "native"])
def test_byte_spans_partition(corpus_file, use_native):
    ids, vocab = text.encode_corpus(corpus_file, min_count=1, use_native=False)
    parts = []
    for i in range(3):
        start, end = text.byte_span(corpus_file, i, 3)
        if use_native:
            nv = native.NativeVocab(corpus_file, min_count=1)
            parts.append(_cat(nv.encode_stream(corpus_file, 512, start, end)))
        else:
            parts.append(_cat(text.iter_encoded_chunks(corpus_file, vocab, 512, start, end)))
    np.testing.assert_array_equal(np.concatenate(parts), ids)
    assert text.byte_span(corpus_file) == (0, 0)  # one process: the whole file


def test_iter_line_records(tmp_path):
    p = tmp_path / "l.txt"
    p.write_text("a\nb\nc\nd\ne\n")
    assert list(text.iter_line_records(str(p))) == list("abcde")
    assert list(text.iter_line_records(str(p), 1, 2)) == ["b", "d"]
    assert list(text.iter_line_records(str(p), 1, 2)) == list(
        jax_text.iter_line_records(str(p), 1, 2))


@pytest.mark.parametrize("use_native", [False, True], ids=["python", "native"])
def test_ctr_stream_equals_whole_file(ctr_file, use_native):
    labels, feats = ctr.read_ctr(ctr_file, 5, use_native=use_native)
    wl, wf = ctr.read_ctr_file(ctr_file, 5)
    np.testing.assert_array_equal(labels, wl)
    np.testing.assert_array_equal(feats, wf)
    chunks = list(ctr.iter_ctr_chunks(ctr_file, 5, 700, use_native=use_native))
    assert [len(c[0]) for c in chunks[:-1]] == [700] * (len(chunks) - 1)
    np.testing.assert_array_equal(np.concatenate([c[0] for c in chunks]), labels)
    np.testing.assert_array_equal(np.concatenate([c[1] for c in chunks]), feats)
    size = os.path.getsize(ctr_file)
    spans = [(0, size // 3), (size // 3, 2 * size // 3), (2 * size // 3, size)]
    parts = [np.concatenate([c[1] for c in ctr.iter_ctr_chunks(
        ctr_file, 5, 500, s, e, use_native=use_native)]) for s, e in spans]
    np.testing.assert_array_equal(np.concatenate(parts), feats)


def _w2v_conf(corpus_file, **over):
    conf = {"data": corpus_file, "dim": "8", "window": "2", "negatives": "2",
            "batch_size": "64", "min_count": "1", "subsample": "1e-3", "num_iters": "2",
            "chunk_tokens": "4000", "seed": "3"}
    conf.update({k: str(v) for k, v in over.items()})
    return conf


@pytest.mark.parametrize("use_native", [0, 1], ids=["python", "native"])
@pytest.mark.parametrize("grouped", [0, 1], ids=["flat", "grouped"])
def test_word2vec_stream_equals_whole_file_and_jax(corpus_file, use_native, grouped):
    over = {"use_native": use_native, "fused": grouped, "grouped": grouped,
            "centers_per_block": 16}
    whole = word2vec.Word2VecTrainer(Config(_w2v_conf(corpus_file, **over)), device="cpu")
    streamed = word2vec.Word2VecTrainer(
        Config(_w2v_conf(corpus_file, stream=1, **over)), device="cpu")
    jstreamed = jax_w2v.Word2VecTrainer(JaxConfig(_w2v_conf(corpus_file, stream=1, **over)))
    assert streamed.corpus_ids is None and streamed._local_total == whole._local_total
    got = list(streamed.batches())
    assert len(got) > 10
    for a, b, c in zip(got, whole.batches(), jstreamed.batches(), strict=True):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            np.testing.assert_array_equal(a[k], c[k], err_msg=k)


@pytest.mark.parametrize("use_native", [0, 1], ids=["python", "native"])
def test_ctr_trainer_stream_equals_whole_file_and_jax(ctr_file, use_native):
    conf = {"data": ctr_file, "num_fields": "5", "capacity": "4096", "batch_size": "128",
            "num_iters": "2", "use_native": str(use_native), "embed_dim": "4",
            "hidden_dims": "8", "rows_per_chunk": str(1 << 20)}
    whole = get_model("widedeep")(Config(conf), device="cpu")
    streamed = get_model("widedeep")(Config({**conf, "stream": "1"}), device="cpu")
    jstreamed = jax_get_model("widedeep")(JaxConfig({**conf, "stream": "1"}))
    assert streamed.labels is None
    assert streamed.producer == whole.producer == ("native" if use_native else "python")
    for a, b, c in zip(streamed.batches(), whole.batches(), jstreamed.batches(), strict=True):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
            np.testing.assert_array_equal(a[k], c[k])
    # smaller chunks shuffle within each chunk, as the JAX trainer does
    small = {**conf, "stream": "1", "rows_per_chunk": "1000"}
    for a, c in zip(get_model("widedeep")(Config(small), device="cpu").batches(),
                    jax_get_model("widedeep")(JaxConfig(small)).batches(), strict=True):
        np.testing.assert_array_equal(a["feats"], c["feats"])


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return env


def _train_cmd(conf, **over):
    args = [sys.executable, "-m", "swiftsnails_tpu_torch", "train", "-config", str(conf),
            "-device", "cpu"]
    for k, v in over.items():
        args += [f"-{k}", str(v)]
    return args


def test_streamed_native_cli_run_stopped_and_resumed_equals_straight(tmp_path, corpus_file):
    keys = {"model": "word2vec", "data": corpus_file, "dim": 32, "window": 2, "negatives": 2,
            "learning_rate": 0.5, "batch_size": 256, "num_iters": 4, "min_count": 1,
            "subsample": 0, "stream": 1, "chunk_tokens": 3000, "resume": "auto",
            "param_backup_period": 40, "param_backup_keep": 1000, "log_every": 0}
    conf = tmp_path / "train.conf"
    conf.write_text("".join(f"{k}: {v}\n" for k, v in keys.items()))
    straight, stopped = tmp_path / "straight", tmp_path / "stopped"
    proc = subprocess.run(_train_cmd(conf, param_backup_root=straight / "ck",
                                     output=straight / "v.txt"),
                          capture_output=True, text=True, env=_env(), timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert '"producer": "native"' in proc.stdout
    cmd = _train_cmd(conf, param_backup_root=stopped / "ck", output=stopped / "v.txt")
    run = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                           env=_env())
    try:
        deadline = time.monotonic() + 120
        while not ckpt.intact_steps(str(stopped / "ck")):
            assert run.poll() is None and time.monotonic() < deadline, run.communicate()[1]
            time.sleep(0.02)
        run.send_signal(signal.SIGTERM)
        _, err = run.communicate(timeout=120)
    finally:
        if run.poll() is None:
            run.kill()
            run.communicate()
    assert run.returncode == 0, err[-2000:]
    assert "preempted (SIGTERM)" in err
    drained = ckpt.intact_steps(str(stopped / "ck"))[0]
    proc = subprocess.run(cmd, capture_output=True, text=True, env=_env(), timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert f"resume: restored step {drained}" in proc.stderr
    steps = set(ckpt.intact_steps(str(straight / "ck")))
    common = steps & set(ckpt.intact_steps(str(stopped / "ck")))
    assert len(common) >= 3 and max(common) == max(steps)
    for step in common:
        a = ckpt.read_manifest(str(straight / "ck"), step)
        b = ckpt.read_manifest(str(stopped / "ck"), step)
        assert {k: v["crc"] for k, v in a["arrays"].items()} == \
            {k: v["crc"] for k, v in b["arrays"].items()}, step
        assert a["data_cursor"] == b["data_cursor"]
    assert (straight / "v.txt").read_bytes() == (stopped / "v.txt").read_bytes()
