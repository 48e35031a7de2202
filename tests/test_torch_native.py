"""The port's native batch producer against the JAX package's, on the CPU.

Both packages build their own copy of ``libsnails.cpp`` with ``g++``: the
JAX package next to its source, the port into ``swiftsnails_tpu_torch/build/``.
``test_batches_equal_jax_native`` holds the port's ``Word2VecTrainer.batches()``
with the default ``use_native`` to the JAX trainer's, array for array, on the
flat, grouped and dedup-block paths (before the port had its producer, it
read ``use_native`` and made numpy batches, which differ). The rest are the
JAX package's ``tests/test_native.py`` cases on the port's bindings, each
also held to the JAX binding where both compute the same thing; every
comparison is exact.
"""

import subprocess
import sys
import textwrap

import numpy as np
import pytest

from swiftsnails_tpu.data import native as jax_native
from swiftsnails_tpu.data.vocab import Vocab as JaxVocab
from swiftsnails_tpu.models import word2vec as jax_w2v
from swiftsnails_tpu.utils.config import Config as JaxConfig
from swiftsnails_tpu_torch.data import ctr, native, sampler
from swiftsnails_tpu_torch.data.vocab import Vocab
from swiftsnails_tpu_torch.models import word2vec
from swiftsnails_tpu_torch.utils.config import Config


def test_the_port_builds_its_own_library():
    assert native.available(), native.build_error()
    path = native.library_path()
    assert path.is_file() and path.parent == native.BUILD_DIR
    assert path.parent.name == "build" and path.parent.parent.name == "swiftsnails_tpu_torch"
    assert (native._SRC.read_bytes()
            == open(jax_native._SRC, "rb").read())  # a verbatim copy


# path -> config keys; chunk_tokens below the corpus, so several chunks each
# with its own seed, and subsampling on
_BATCH_PATHS = {
    "flat": {},
    "grouped": {"fused": 1, "grouped": 1, "centers_per_block": 16},
    "dedup_block": {"fused": 1, "grouped": 1, "dedup": 1, "centers_per_block": 16},
}


def _w2v_conf(**over):
    conf = {"dim": "16", "window": "3", "negatives": "2", "batch_size": "128",
            "subsample": "1e-2", "num_iters": "2", "chunk_tokens": "3000",
            "pool_size": "8", "pool_block": "32", "seed": "7", "steps_per_call": "2"}
    conf.update({k: str(v) for k, v in over.items()})
    return conf


def _w2v_corpus(n=9000, vocab=512, seed=0):
    rng = np.random.default_rng(seed)
    counts = np.maximum(rng.zipf(1.3, vocab), 1).astype(np.int64)
    ids = rng.choice(vocab, size=n, p=counts / counts.sum()).astype(np.int32)
    return [f"w{i}" for i in range(vocab)], counts, ids


@pytest.mark.parametrize("path", list(_BATCH_PATHS))
def test_batches_equal_jax_native(path):
    assert jax_native.available(), jax_native.build_error()
    words, counts, ids = _w2v_corpus()
    conf = _w2v_conf(**_BATCH_PATHS[path])
    jt = jax_w2v.Word2VecTrainer(JaxConfig(conf), mesh=None, corpus_ids=ids,
                                 vocab=JaxVocab(words, counts))
    tt = word2vec.Word2VecTrainer(Config(conf), corpus_ids=ids,
                                  vocab=Vocab(words, counts), device="cpu")
    assert tt.producer == "native"
    want, got = list(jt.batches()), list(tt.batches())
    assert len(want) == len(got) > 4
    for w, g in zip(want, got):
        assert set(w) == set(g) == {"centers", "contexts", "progress"}
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    # and not the numpy path's batches, which the port made before
    numpy_path = list(word2vec.Word2VecTrainer(
        Config({**conf, "use_native": "0"}), corpus_ids=ids, vocab=Vocab(words, counts),
        device="cpu").batches())
    assert any(not np.array_equal(a["centers"], b["centers"])
               for a, b in zip(numpy_path, got))


def test_numpy_path_equals_jax_numpy_path():
    words, counts, ids = _w2v_corpus()
    conf = _w2v_conf(use_native=0)
    jt = jax_w2v.Word2VecTrainer(JaxConfig(conf), mesh=None, corpus_ids=ids,
                                 vocab=JaxVocab(words, counts))
    tt = word2vec.Word2VecTrainer(Config(conf), corpus_ids=ids,
                                  vocab=Vocab(words, counts), device="cpu")
    assert tt.producer == "python"
    for w, g in zip(jt.batches(), tt.batches(), strict=True):
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_failed_build_raises_naming_gxx_and_the_escape(monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_error", None)
    monkeypatch.setattr(native, "_build", lambda lib: "g++ failed (rc=1):\nboom")
    words, counts, ids = _w2v_corpus()
    with pytest.raises(RuntimeError, match=r"(?s)g\+\+ failed.*boom.*use_native: 0"):
        word2vec.Word2VecTrainer(Config(_w2v_conf()), corpus_ids=ids,
                                 vocab=Vocab(words, counts), device="cpu")
    with pytest.raises(RuntimeError, match="use_native: 0"):  # the CTR reader too
        ctr.read_ctr(__file__, 2)
    tr = word2vec.Word2VecTrainer(Config(_w2v_conf(use_native=0)), corpus_ids=ids,
                                  vocab=Vocab(words, counts), device="cpu")
    assert tr.producer == "python" and next(iter(tr.batches()))


# ----------------------------------------- the JAX tests/test_native.py cases


def test_murmur_matches_python_and_jax():
    from swiftsnails_tpu_torch.ops.hashing import murmur_fmix64_np

    xs = np.random.default_rng(0).integers(0, 1 << 64, size=4096, dtype=np.uint64)
    got = native.murmur64(xs)
    np.testing.assert_array_equal(got, murmur_fmix64_np(xs))
    np.testing.assert_array_equal(got, jax_native.murmur64(xs))


@pytest.mark.parametrize("capacity", [1 << 20, 1000])
def test_hash_row_matches_python_and_jax(capacity):
    from swiftsnails_tpu_torch.ops.hashing import hash_row_np

    keys = np.random.default_rng(1).integers(0, 1 << 32, size=4096, dtype=np.uint32)
    got = native.hash_row(keys, capacity)
    assert got.dtype == np.int64 and int(got.min()) >= 0 and int(got.max()) < capacity
    np.testing.assert_array_equal(got, jax_native.hash_row(keys, capacity))
    np.testing.assert_array_equal(got, hash_row_np(keys, capacity))


def test_vocab_matches_python(tmp_path):
    text = "the cat sat on the mat the cat ran\n" * 7
    p = tmp_path / "c.txt"
    p.write_text(text)
    nv = native.NativeVocab(str(p), min_count=2)
    pv = Vocab.build(text.split(), min_count=2)
    assert nv.words() == pv.words
    np.testing.assert_array_equal(nv.counts(), pv.counts)
    ids = nv.encode_file(str(p))
    np.testing.assert_array_equal(ids, pv.encode(text.split()))
    nv.close()


def test_skipgram_pairs_full_window_matches_python():
    ids = np.arange(50, dtype=np.int32)
    c_native, x_native = native.skipgram_pairs(ids, window=3, dynamic=False)
    c_py, x_py = sampler.skipgram_pairs(ids, window=3, rng=np.random.default_rng(0),
                                        dynamic=False)
    assert (sorted(zip(c_native.tolist(), x_native.tolist()))
            == sorted(zip(c_py.tolist(), x_py.tolist())))


def test_skipgram_dynamic_within_bounds_and_equals_jax():
    ids = np.arange(200, dtype=np.int32)
    c, x = native.skipgram_pairs(ids, window=5, seed=7, dynamic=True)
    assert len(c) == len(x) > 0
    assert np.all(np.abs(c - x) <= 5) and np.all(c != x)
    c2, x2 = native.skipgram_pairs(ids, window=5, seed=7, dynamic=True)
    np.testing.assert_array_equal(c, c2)
    jc, jx = jax_native.skipgram_pairs(ids, window=5, seed=7, dynamic=True)
    np.testing.assert_array_equal(c, jc)
    np.testing.assert_array_equal(x, jx)


def test_skipgram_windows_matches_python_full_window():
    ids = np.arange(40, dtype=np.int32)
    c_n, x_n = native.skipgram_windows(ids, window=3, dynamic=False)
    c_p, x_p = sampler.skipgram_windows(ids, window=3, rng=np.random.default_rng(0),
                                        dynamic=False)
    np.testing.assert_array_equal(c_n, c_p)
    np.testing.assert_array_equal(x_n, x_p)


def test_skipgram_windows_same_pair_set_as_pairs():
    ids = (np.arange(300, dtype=np.int32) * 7) % 50
    c_f, x_f = native.skipgram_pairs(ids, window=4, seed=9, dynamic=True)
    c_w, x_w = native.skipgram_windows(ids, window=4, seed=9, dynamic=True)
    flat = [(int(c_w[i]), int(r)) for i in range(len(c_w)) for r in x_w[i] if r >= 0]
    assert sorted(flat) == sorted(zip(c_f.tolist(), x_f.tolist()))
    np.testing.assert_array_equal(x_w, jax_native.skipgram_windows(ids, 4, seed=9)[1])


def test_subsample_keeps_rare_and_equals_jax():
    counts = np.array([1_000_000, 10], dtype=np.int64)
    ids = np.array([0] * 1000 + [1] * 1000, dtype=np.int32)
    kept = native.subsample(ids, counts, threshold=1e-4, seed=1)
    assert np.all(np.isin(kept, [0, 1]))
    assert (kept == 1).sum() == 1000 and (kept == 0).sum() < 500
    np.testing.assert_array_equal(kept, jax_native.subsample(ids, counts, 1e-4, seed=1))


def test_read_ctr_matches_python(tmp_path):
    p = tmp_path / "ctr.txt"
    p.write_text("1 3 17 29\n0 0:5 1:9\n\n1 7\n")
    nl, nf = native.read_ctr(str(p), num_fields=4)
    pl, pf = ctr.read_ctr_file(str(p), num_fields=4)
    np.testing.assert_array_equal(nl, pl)
    np.testing.assert_array_equal(nf, pf)


def test_read_ctr_trailing_blank_lines(tmp_path):
    p = tmp_path / "t.txt"
    p.write_text("1 2 3\n0 4 5\n\n  \n# junk\n")
    labels, feats = native.read_ctr(str(p), 2)
    assert labels.shape == (2,)
    np.testing.assert_array_equal(feats, [[2, 3], [4, 5]])


def test_prefetcher_delivers_all_pairs():
    n = 1000
    centers = np.arange(n, dtype=np.int32)
    contexts = np.arange(n, dtype=np.int32) + 10_000
    pf = native.PairPrefetcher(centers, contexts, batch_size=100, epochs=2, seed=3)
    batches = list(pf)
    pf.close()
    assert len(batches) == 20
    for b in batches:
        np.testing.assert_array_equal(b["contexts"] - b["centers"], 10_000)
    seen = np.sort(np.concatenate([b["centers"] for b in batches[:10]]))
    np.testing.assert_array_equal(seen, centers)
    jpf = jax_native.PairPrefetcher(centers, contexts, batch_size=100, epochs=2, seed=3)
    for a, b in zip(batches, jpf, strict=True):
        np.testing.assert_array_equal(a["centers"], b["centers"])
    jpf.close()


def test_prefetcher_early_close_no_hang():
    pf = native.PairPrefetcher(np.arange(10_000, dtype=np.int32),
                               np.arange(10_000, dtype=np.int32),
                               batch_size=64, epochs=100, capacity=2)
    it = iter(pf)
    next(it)
    pf.close()  # a producer blocked on the full queue must exit
    assert list(it) == []


def test_empty_inputs_no_crash():
    c, x = native.skipgram_pairs(np.empty(0, np.int32), 5)
    assert c.size == 0 and x.size == 0
    kept = native.subsample(np.empty(0, np.int32), np.array([10, 10], np.int64), 1e-3)
    assert kept.size == 0


def test_window_prefetcher_delivers_aligned_blocks():
    n, cw, bs, block = 10_240, 6, 1_024, 256
    g_c = np.arange(n, dtype=np.int32)
    g_x = (g_c[:, None] * 10 + np.arange(cw, dtype=np.int32)[None, :]).astype(np.int32)
    wp = native.WindowPrefetcher(g_c, g_x, bs, block=block, seed=3)
    seen = []
    for b in wp:
        c, x = b["centers"], b["contexts"]
        assert c.shape == (bs,) and x.shape == (bs, cw)
        np.testing.assert_array_equal(x, c[:, None] * 10 + np.arange(cw))
        for lo in range(0, bs, block):
            blk = c[lo:lo + block]
            np.testing.assert_array_equal(blk, np.arange(blk[0], blk[0] + block))
        seen.append(c)
    wp.close()
    np.testing.assert_array_equal(np.sort(np.concatenate(seen)), g_c)


def test_window_prefetcher_deterministic_across_workers():
    n, cw = 8_192, 4
    g_c = np.arange(n, dtype=np.int32)
    g_x = np.repeat(g_c[:, None], cw, axis=1)

    def run(workers, mod=native):
        wp = mod.WindowPrefetcher(g_c, g_x, 1_024, block=128, seed=7, workers=workers)
        out = [b["centers"].copy() for b in wp]
        wp.close()
        return out

    for a, b, c in zip(run(1), run(4), run(2, jax_native), strict=True):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_window_prefetcher_multi_epoch_full_coverage():
    n, cw, bs = 4_096, 4, 512
    g_c = np.arange(n, dtype=np.int32)
    g_x = np.repeat(g_c[:, None], cw, axis=1)
    wp = native.WindowPrefetcher(g_c, g_x, bs, block=128, epochs=2, seed=5)
    seen = [b["centers"] for b in wp]
    wp.close()
    per_epoch = n // bs
    assert len(seen) == 2 * per_epoch
    np.testing.assert_array_equal(np.sort(np.concatenate(seen[:per_epoch])), g_c)
    np.testing.assert_array_equal(np.sort(np.concatenate(seen[per_epoch:])), g_c)
    assert any(not np.array_equal(a, b)
               for a, b in zip(seen[:per_epoch], seen[per_epoch:]))


def test_window_prefetcher_early_close_no_hang():
    n = 65_536
    g_c = np.arange(n, dtype=np.int32)
    g_x = np.repeat(g_c[:, None], 4, axis=1)
    wp = native.WindowPrefetcher(g_c, g_x, 512, block=1, epochs=50, capacity=2,
                                 workers=2)
    it = iter(wp)
    next(it)
    wp.close()  # workers blocked on the full ticket ring must exit


def test_sgns_train_learns_structure():
    rng = np.random.default_rng(0)
    V, D, n = 200, 16, 60_000
    half = V // 2
    centers = np.concatenate([rng.integers(0, half, size=n // 2),
                              rng.integers(half, V, size=n // 2)]).astype(np.int32)
    contexts = np.concatenate([rng.integers(0, half, size=n // 2),
                               rng.integers(half, V, size=n // 2)]).astype(np.int32)
    perm = rng.permutation(n)
    centers, contexts = centers[perm], contexts[perm]
    counts = np.bincount(np.concatenate([centers, contexts]), minlength=V).astype(np.int64)
    syn0 = ((rng.random((V, D)) - 0.5) / D).astype(np.float32)
    syn1 = np.zeros((V, D), dtype=np.float32)
    j0, j1 = syn0.copy(), syn1.copy()
    assert native.sgns_train(syn0, syn1, centers, contexts, counts, negatives=5,
                             lr=0.05, seed=1) > 0
    logits = syn0 @ syn1.T
    within = (logits[:half, :half].mean() + logits[half:, half:].mean()) / 2
    cross = (logits[:half, half:].mean() + logits[half:, :half].mean()) / 2
    assert within > cross + 0.5, (within, cross)
    jax_native.sgns_train(j0, j1, centers, contexts, counts, negatives=5, lr=0.05, seed=1)
    np.testing.assert_array_equal(syn0, j0)  # one loop, one thread: the same bits
    with pytest.raises(ValueError, match="out of range"):
        native.sgns_train(syn0, syn1, centers + V, contexts, counts)


def test_trainer_batches_use_pair_prefetcher(monkeypatch):
    made = []
    real = native.PairPrefetcher

    class Spy(real):
        def __init__(self, *a, **k):
            made.append(a)
            super().__init__(*a, **k)

    monkeypatch.setattr(native, "PairPrefetcher", Spy)
    rng = np.random.default_rng(0)
    vocab = Vocab([f"w{i}" for i in range(32)],
                  np.maximum(rng.integers(1, 9, 32), 1).astype(np.int64))
    corpus = rng.integers(0, 32, 4000).astype(np.int32)
    tr = word2vec.Word2VecTrainer(
        Config({"dim": "8", "window": "2", "negatives": "2", "learning_rate": "0.1",
                "batch_size": "64", "subsample": "0", "num_iters": "1"}),
        corpus_ids=corpus, vocab=vocab, device="cpu")
    batches = list(tr.batches())
    assert made, "PairPrefetcher was not used by batches()"
    assert all(b["centers"].shape[0] == 64 for b in batches)


def _py_clock_sweep(ref, pinned, hand, n):
    budget = ref.shape[0]
    victims = np.empty(n, np.int64)
    k = 0
    while k < n:
        h = hand
        hand = (hand + 1) % budget
        if pinned[h]:
            continue
        if ref[h] > 0:
            ref[h] >>= 1
            continue
        victims[k] = h
        pinned[h] = True
        k += 1
    return victims, hand


def test_tier_remap_matches_python():
    rng = np.random.default_rng(5)
    units, budget = 256, 64
    slot_of = np.full(units, -1, np.int64)
    resident = rng.choice(units, size=budget, replace=False)
    slot_of[resident] = rng.permutation(budget)
    rows = rng.choice(resident, size=1000).astype(np.int32)
    out, bad = native.tier_remap(slot_of, rows)
    assert bad == 0
    np.testing.assert_array_equal(out, slot_of[rows].astype(np.int32))
    g = 4
    g_rows = (resident[rng.integers(0, budget, size=500)] * g
              + rng.integers(0, g, size=500)).astype(np.int32)
    out_g, bad_g = native.tier_remap(slot_of, g_rows, group=g)
    assert bad_g == 0
    np.testing.assert_array_equal(out_g, (slot_of[g_rows // g] * g + g_rows % g)
                                  .astype(np.int32))
    missing = np.setdiff1d(np.arange(units), resident)[:8].astype(np.int32)
    assert native.tier_remap(slot_of, missing)[1] == len(missing)


def test_tier_clock_sweep_matches_python():
    rng = np.random.default_rng(6)
    for _ in range(5):
        budget = int(rng.integers(8, 128))
        ref_n = rng.integers(0, 8, size=budget).astype(np.uint8)
        pin_n = rng.random(budget) < 0.25
        pin_n[: budget // 2] = False
        ref_p, pin_p, pin0 = ref_n.copy(), pin_n.copy(), pin_n.copy()
        hand = int(rng.integers(0, budget))
        n = int(rng.integers(1, max(budget // 4, 2)))
        v_n, h_n = native.tier_clock_sweep(ref_n, pin_n, hand, n)
        v_p, h_p = _py_clock_sweep(ref_p, pin_p, hand, n)
        np.testing.assert_array_equal(v_n, v_p)
        assert h_n == h_p
        np.testing.assert_array_equal(ref_n, ref_p)
        np.testing.assert_array_equal(pin_n, pin_p)
        assert not pin0[v_n].any() and np.all(ref_n[v_n] == 0)


def test_sigterm_drain_closes_the_producer_and_exits(tmp_path):
    """A process that stops its loop with a real SIGTERM mid-run, while the
    native prefetcher's threads fill their queue, drains and exits."""
    script = textwrap.dedent(f"""
        import os, signal, threading
        import numpy as np
        from swiftsnails_tpu_torch.data.vocab import Vocab
        from swiftsnails_tpu_torch.framework.trainer import TrainLoop
        from swiftsnails_tpu_torch.models.word2vec import Word2VecTrainer
        from swiftsnails_tpu_torch.utils.config import Config
        rng = np.random.default_rng(0)
        ids = rng.integers(0, 64, 200_000).astype(np.int32)
        tr = Word2VecTrainer(Config({{"dim": "8", "window": "2", "negatives": "2",
            "batch_size": "64", "subsample": "0", "num_iters": "50",
            "param_backup_root": {str(tmp_path / "ck")!r}, "param_backup_period": "1000"}}),
            corpus_ids=ids, vocab=Vocab([f"w{{i}}" for i in range(64)],
            np.bincount(ids, minlength=64)), device="cpu")
        loop = TrainLoop(tr, log_every=0)
        threading.Timer(1.0, os.kill, (os.getpid(), signal.SIGTERM)).start()
        loop.run()
        assert loop.preempted
        print("drained")
    """)
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "drained" in proc.stdout
