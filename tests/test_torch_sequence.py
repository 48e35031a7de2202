"""The port's sequence plane (``parallel/sequence.py``) against the JAX
package's, on the CPU.

``reference_attention`` against JAX's, causal and not, with Lq != Lk too.
Ring and Ulysses attention run under a gloo ``seq`` group of P = 2 and 4
spawned processes (``init_method`` a file under ``tmp_path``), each rank on
its shard of the JAX tests' inputs (B, L, H, D = 2, 64, 8, 16, from a numpy
seed), against the JAX ``ring_attention`` / ``ulysses_attention`` on the
8-device CPU mesh: forward within rtol 2e-4 / atol 2e-5, the causal
backward of ``sum(out ** 2)`` within rtol 5e-3 / atol 5e-4; Ulysses refuses
3 heads. Every case of one P runs in one spawn. ``parallel/cluster.py``'s
data sharding against the JAX module's.
"""

import os

import numpy as np
import pytest
import torch

from swiftsnails_tpu_torch.parallel import cluster, sequence
from swiftsnails_tpu_torch.parallel.sequence import (
    SEQ_AXIS,
    reference_attention,
    ring_attention,
    ulysses_attention,
)

from test_torch_seqlm import spawn_ranks

B, L, H, D = 2, 64, 8, 16
torch.set_num_threads(1)


def _qkv(seed=0, lq=L, lk=L):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, lq, H, D)).astype(np.float32),
            rng.normal(size=(B, lk, H, D)).astype(np.float32),
            rng.normal(size=(B, lk, H, D)).astype(np.float32))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("lq,lk", [(L, L), (16, L), (L, 16)])
def test_reference_attention_matches_jax(causal, lq, lk):
    import jax.numpy as jnp

    from swiftsnails_tpu.parallel.sequence import reference_attention as jax_ref

    q, k, v = _qkv(1, lq, lk)
    want = np.asarray(jax_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal))
    got = reference_attention(*map(torch.from_numpy, (q, k, v)), causal=causal).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _attention_worker(rank, size, init, out_dir):
    """One rank's forward outputs, causal backward grads and errors."""
    import traceback

    import torch.distributed as dist

    torch.set_num_threads(1)
    out = {}
    try:
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")  # the ranks share one host
        dist.init_process_group("gloo", init_method=init, rank=rank, world_size=size)
        group = dist.new_group(list(range(size)))
        assert dist.get_world_size(group) == size
        per = L // size
        shard = slice(rank * per, (rank + 1) * per)
        q, k, v = (torch.from_numpy(x[:, shard].copy()) for x in _qkv())
        sequence.reset_calls()
        for name, fn in (("ring", ring_attention), ("ulysses", ulysses_attention)):
            for causal in (False, True):
                out[f"{name}_{causal}"] = fn(q, k, v, group, causal=causal)
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            (fn(*leaves, group, causal=True) ** 2).sum().backward()
            out[f"{name}_grads"] = [t.grad for t in leaves]
        out["calls"] = dict(sequence.CALLS)
        try:
            ulysses_attention(q[:, :, :3], k[:, :, :3], v[:, :, :3], group)
        except ValueError as e:
            out["bad_heads"] = str(e)
        dist.destroy_process_group()
    except Exception:
        out = {"error": traceback.format_exc()}
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


@pytest.fixture(scope="module")
def jax_side():
    """The JAX ring / Ulysses outputs and the ring's causal gradients on the
    8-device CPU mesh."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from swiftsnails_tpu.parallel.mesh import make_mesh
    from swiftsnails_tpu.parallel.sequence import ring_attention as jring
    from swiftsnails_tpu.parallel.sequence import ulysses_attention as julysses

    mesh = make_mesh({SEQ_AXIS: 8})
    spec = NamedSharding(mesh, P(None, SEQ_AXIS, None, None))
    q, k, v = (jax.device_put(jnp.asarray(x), spec) for x in _qkv())
    out = {}
    for name, fn in (("ring", jring), ("ulysses", julysses)):
        for causal in (False, True):
            out[f"{name}_{causal}"] = np.asarray(fn(mesh, q, k, v, causal=causal))
        grads = jax.grad(lambda q, k, v: (fn(mesh, q, k, v, causal=True) ** 2).sum(),
                         argnums=(0, 1, 2))(q, k, v)
        out[f"{name}_grads"] = [np.asarray(g) for g in grads]
    return out


_RUNS = {}


@pytest.fixture(params=[2, 4], ids=["P2", "P4"])
def port_side(request, tmp_path_factory):
    """Each rank's results, the shards joined along the sequence, for P
    ranks (one spawn a P, kept for the module)."""
    size = request.param
    if size not in _RUNS:
        results = spawn_ranks(_attention_worker, size,
                              tmp_path_factory.mktemp(f"seq_p{size}"))
        joined = {}
        for key in results[0]:
            if key.endswith("_grads"):
                joined[key] = [torch.cat([r[key][i] for r in results], 1).numpy()
                               for i in range(3)]
            elif key not in ("calls", "bad_heads"):
                joined[key] = torch.cat([r[key] for r in results], 1).numpy()
        _RUNS[size] = (size, results, joined)
    return _RUNS[size]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("name", ["ring", "ulysses"])
def test_forward_matches_jax(port_side, jax_side, name, causal):
    _, _, got = port_side
    key = f"{name}_{causal}"
    np.testing.assert_allclose(got[key], jax_side[key], rtol=2e-4, atol=2e-5)
    want = reference_attention(*map(torch.from_numpy, _qkv()), causal=causal).numpy()
    np.testing.assert_allclose(got[key], want, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("name", ["ring", "ulysses"])
def test_causal_backward_matches_jax(port_side, jax_side, name):
    """``test_ring_backward``: the gradients of ``sum(out ** 2)`` with
    respect to each rank's q, k and v shards, joined, equal JAX's; the
    ring's K/V gradients come back to their owners."""
    _, _, got = port_side
    for g, w in zip(got[f"{name}_grads"], jax_side[f"{name}_grads"]):
        np.testing.assert_allclose(g, w, rtol=5e-3, atol=5e-4)


def test_group_calls_and_bad_heads(port_side):
    """Per rank: P - 1 hops a ring forward and as many back, one all-to-all
    each way a Ulysses call and its inverse in the backward; Ulysses
    refuses 3 heads."""
    size, results, _ = port_side
    for r in results:
        # 3 ring calls (2 forward, 1 with its backward); 3 Ulysses calls
        assert r["calls"] == {"ring_shift": 4 * (size - 1), "all_to_all": 8}
        assert "heads 3 not divisible" in r["bad_heads"]


@pytest.mark.parametrize("count", [1, 2, 3, 5])
def test_cluster_sharding_matches_jax(tmp_path, count):
    from swiftsnails_tpu.parallel import cluster as jax_cluster

    ids = np.arange(101, dtype=np.int32)
    path = tmp_path / "c.txt"
    path.write_text("a bb ccc " * 7)
    for index in range(count):
        np.testing.assert_array_equal(
            cluster.shard_token_stream(ids, index, count),
            jax_cluster.shard_token_stream(ids, index, count))
        assert cluster.byte_span(str(path), index, count) == \
            jax_cluster.byte_span(str(path), index, count)
    assert cluster.process_info() == (0, 1)
    np.testing.assert_array_equal(cluster.shard_token_stream(ids), ids)
    assert cluster.byte_span(str(path)) == (0, 0)
