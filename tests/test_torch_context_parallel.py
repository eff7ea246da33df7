"""The context-parallel cross-attention on 1, 2 and 4 gloo ranks of one pool
(spawned once for the module, free of JAX) against dense attention and the
JAX package's ``context_parallel_cross_attention`` under ``shard_map`` on the
virtual CPU devices; its backward against dense autograd; the shared
host-staged collectives; and the rank launcher's failure path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

import torch_rank_workers as workers
from crossscore_tpu.ops.context_parallel import context_parallel_cross_attention as jax_cp
from crossscore_tpu_torch.ops.attention import attention_with_stats
from crossscore_tpu_torch.ops.flash_attention import flash_attention_head_major
from crossscore_tpu_torch.parallel.launch import RankPool

# fp32: the shards' partial sums add in another order than one dense pass
TOL = 5e-5


@pytest.fixture(scope="module")
def pool():
    # one intra-op thread per rank: the ranks' work is small, and the test
    # run's other workers share the cores
    with RankPool(4, env={"OMP_NUM_THREADS": "1"}) as p:
        yield p


def _jax(q, k, v, n):
    fn = shard_map(lambda q, k, v: jax_cp(q, k, v, axis_name="ctx"),
                   mesh=Mesh(np.asarray(jax.devices()[:n]), ("ctx",)),
                   in_specs=(P(), P(None, None, "ctx", None), P(None, None, "ctx", None)),
                   out_specs=P(), check_vma=False)
    return np.asarray(fn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))


def _dense(q, k, v):
    o, _, l, m = attention_with_stats(*(torch.from_numpy(x) for x in (q, k, v)))
    return o.numpy(), l.numpy(), m.numpy()


@pytest.mark.parametrize("n,nk,scale", [(2, 300, 1.0), (4, 512, 1.0), (4, 256, 20.0)],
                         ids=["2way-150-per-rank", "4way", "4way-extreme-logits"])
def test_cp_matches_dense_and_jax(pool, n, nk, scale):
    """2 ranks at 150 KV tokens each (no 64-row tile multiple), 4 ranks, and
    logits scaled 20x (row maxima far apart across shards) staying finite."""
    rng = np.random.default_rng(n + nk)
    q = rng.standard_normal((2, 2, 64, 48)).astype(np.float32) * scale
    k = rng.standard_normal((2, 2, nk, 48)).astype(np.float32) * scale
    v = rng.standard_normal((2, 2, nk, 48)).astype(np.float32)
    got = pool.run(workers.cp_attention, n, q, k, v, timeout=300)
    assert all(r is None for r in got[n:])
    o, l, m = got[0]
    for other in got[1:n]:  # every rank holds the same result
        for a, b in zip(other, got[0]):
            np.testing.assert_array_equal(a, b)
    assert np.isfinite(o).all()
    want_o, want_l, want_m = _dense(q, k, v)
    np.testing.assert_allclose(o, want_o, atol=TOL * (2 if scale > 1 else 1))
    np.testing.assert_allclose(m, want_m, rtol=1e-6)  # the global max, exact
    np.testing.assert_allclose(l, want_l, rtol=1e-5)
    np.testing.assert_allclose(o, _jax(q, k, v, n), atol=TOL * (2 if scale > 1 else 1))


def test_cp_over_one_rank_is_local_k7(pool):
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((1, 2, n, 16)).astype(np.float32) for n in (20, 70, 70))
    o, l, m = pool.run(workers.cp_attention, 1, q, k, v, timeout=300)[0]
    o_k, l_k, m_k = flash_attention_head_major(*(torch.from_numpy(x) for x in (q, k, v)))
    np.testing.assert_allclose(o, o_k.numpy(), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(l, l_k.numpy())
    np.testing.assert_array_equal(m, m_k.numpy())


def _dense_grads(q, k, v, do):
    qt, kt, vt = (torch.from_numpy(x).double().requires_grad_() for x in (q, k, v))
    o = torch.softmax(qt @ kt.transpose(-1, -2) / q.shape[-1] ** 0.5, -1) @ vt
    o.backward(torch.from_numpy(do).double())
    return qt.grad.numpy(), kt.grad.numpy(), vt.grad.numpy()


@pytest.mark.parametrize("n,nk,scale", [(2, 300, 1.0), (4, 512, 1.0), (2, 256, 20.0), (4, 256, 20.0)],
                         ids=["2way", "4way", "2way-extreme-logits", "4way-extreme-logits"])
def test_cp_backward_matches_dense_autograd(pool, n, nk, scale):
    """K8/K9 per shard fed the global (o, l, m), dq summed over the ranks, dk
    and dv local: against dense autograd in fp64, with unit and x20 logits.
    Every rank is given the whole ``do``: the port has no counterpart of the
    JAX VJP's ``psum(do)`` (its ranks run the replicated downstream), and
    with it the gradients would come out n times too large."""
    rng = np.random.default_rng(10 * n + nk)
    q = rng.standard_normal((2, 2, 48, 16)).astype(np.float32) * scale  # the logits x scale
    k = rng.standard_normal((2, 2, nk, 16)).astype(np.float32)
    v, do = rng.standard_normal((2, 2, nk, 16)).astype(np.float32), rng.standard_normal((2, 2, 48, 16)).astype(np.float32)
    got = pool.run(workers.cp_backward, n, q, k, v, do, timeout=300)
    assert all(r is None for r in got[n:])
    for other in got[1:n]:  # every rank holds the same dq
        np.testing.assert_array_equal(other[0], got[0][0])
    dq, dk, dv = _dense_grads(q, k, v, do)
    tol = TOL  # relative to the largest entry: x20 logits make dq and dk 20 times larger
    np.testing.assert_allclose(got[0][0], dq, atol=tol * max(1.0, np.abs(dq).max()))
    np.testing.assert_allclose(np.concatenate([r[1] for r in got[:n]], axis=2), dk,
                               atol=tol * max(1.0, np.abs(dk).max()))
    np.testing.assert_allclose(np.concatenate([r[2] for r in got[:n]], axis=2), dv, atol=tol)


def test_cp_backward_raises_naming_the_roadmap_item(pool):
    """The backward, once forward only and raising (naming ROADMAP queue 1
    item 13), is ported: on 2 ranks it returns the dense gradients."""
    rng = np.random.default_rng(12)
    q, do = (rng.standard_normal((1, 1, 4, 16)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((1, 1, 8, 16)).astype(np.float32) for _ in range(2))
    got = pool.run(workers.cp_backward, 2, q, k, v, do, timeout=300)
    for g, w in zip((got[0][0], np.concatenate([got[0][1], got[1][1]], 2)), _dense_grads(q, k, v, do)):
        np.testing.assert_allclose(g, w, atol=TOL)


def test_rank_pool_environment_is_in_place_when_a_rank_starts():
    """A rank imports torch before it runs a task, and torch reads
    OMP_NUM_THREADS once: the pool's environment must be there from the
    start (ranks sharing the cores, one thread each, compute the same bits
    run after run)."""
    with RankPool(2, env={"OMP_NUM_THREADS": "1"}) as p:
        assert p.run(workers.intra_op_threads, timeout=60) == [1, 1]


def test_rank_failure_is_reported_with_its_traceback():
    with RankPool(2) as p:
        with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
            p.run(workers.fail_on_rank, 1, timeout=60)
        with pytest.raises(RuntimeError, match="closed"):  # a failed run stops the pool
            p.run(workers.fail_on_rank, 1, timeout=60)


@pytest.mark.parametrize("backend,staged", [("gloo", True), ("nccl", False)])
def test_collectives_stage_cuda_tensors_through_the_host_on_gloo_only(monkeypatch, backend, staged):
    """A CUDA tensor on gloo is reduced and gathered as a host copy that is
    copied back; on NCCL the tensor itself goes to the collective (the
    backend name and the CUDA tensor are stood in on the CPU)."""
    import torch.distributed as dist

    from crossscore_tpu_torch.parallel import collectives

    seen = []

    class FakeCuda:
        is_cuda = True
        device = "cuda:0"

        def __init__(self):
            self.host, self.copied = torch.ones(3), None

        def cpu(self):
            return self.host

        def contiguous(self):
            return self

        def copy_(self, src):
            self.copied = src

    monkeypatch.setattr(dist, "get_backend", lambda group=None: backend)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)
    monkeypatch.setattr(dist, "all_reduce", lambda t, op=None, group=None: seen.append(("reduce", t)))
    monkeypatch.setattr(dist, "all_gather", lambda parts, t, group=None: seen.append(("gather", t)))
    t = FakeCuda()
    assert collectives.all_reduce(t) is t
    assert seen[-1][1] is (t.host if staged else t)
    assert (t.copied is t.host) == staged
    if staged:  # the gather's host copy goes back to the card
        monkeypatch.setattr(torch.Tensor, "to", lambda self, device: ("moved", device))
        assert collectives.all_gather(t) == ("moved", "cuda:0")
        assert seen[-1] == ("gather", t.host)
