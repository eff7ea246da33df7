"""The context-parallel cross-attention on 1, 2 and 4 gloo ranks of one pool
(spawned once for the module, free of JAX) against dense attention and the
JAX package's ``context_parallel_cross_attention`` under ``shard_map`` on the
virtual CPU devices; and the rank launcher's failure path."""

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


def test_cp_backward_raises_naming_the_roadmap_item(pool):
    msg = pool.run(workers.cp_backward_raises, timeout=300)
    assert all("item 13" in m for m in msg), msg


def test_rank_failure_is_reported_with_its_traceback():
    with RankPool(2) as p:
        with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
            p.run(workers.fail_on_rank, 1, timeout=60)
        with pytest.raises(RuntimeError, match="closed"):  # a failed run stops the pool
            p.run(workers.fail_on_rank, 1, timeout=60)
