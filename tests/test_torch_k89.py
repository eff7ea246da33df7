"""K8/K9, the head-major attention backward, against the JAX package on the
CPU: the plain version against ``_bwd_pallas_single`` (up to 2048 KV tokens)
and ``_bwd_pallas_multi`` (beyond; called with a small ``block_k``), their
Pallas kernels in interpret mode as the JAX tests run them; against
``_bwd_xla`` fed the global statistics (the context-parallel backward); and
the differentiable head-major attention (K7 forward, K8/K9 backward) against
``jax.grad`` through the JAX ``flash_cross_attention`` at 2048 and 2049 KV
tokens, the dispatch landing on K8, then K9. On the CPU the wrappers run
their plain versions. Inputs come from a numpy seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crossscore_tpu.ops.flash_attention import (
    _bwd_pallas_multi, _bwd_pallas_single, _bwd_xla, _flash_fwd, flash_cross_attention,
)
from crossscore_tpu_torch.ops import flash_attention as fa

# fp32 on both sides: summation order and exp vs exp2 differ
TOL = 1e-5


def _close(got, want, tol=TOL):
    """max |got - want| over the largest |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.abs(got - want).max() / np.abs(want).max())
    assert err <= tol, f"error {err} > {tol}"


def _inputs(seed, b, h, nq, nk, hd):
    rng = np.random.default_rng(seed)
    q, do = (rng.standard_normal((b, h, nq, hd)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((b, h, nk, hd)).astype(np.float32) for _ in range(2))
    return q, k, v, do


def _fwd(q, k, v):
    """The JAX forward's (o, l, m) as numpy."""
    return tuple(np.asarray(t) for t in _flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                                   block_q=64, block_k=128))


def _port_bwd(q, k, v, o, do, l, m):
    return [t.numpy() for t in fa.flash_attention_head_major_bwd(
        *(torch.from_numpy(np.array(x)) for x in (q, k, v, o, do, l, m)))]


# (nq, nk, hd): a ragged single block at the decoder's hd 48 and at hd 16
@pytest.mark.parametrize("nq,nk,hd", [(40, 100, 48), (24, 200, 16)])
def test_plain_matches_jax_bwd_pallas_single(nq, nk, hd):
    q, k, v, do = _inputs(1, 2, 3, nq, nk, hd)
    o, l, m = _fwd(q, k, v)
    want = jax.jit(_bwd_pallas_single, static_argnames="block_q")(
        *(jnp.asarray(x) for x in (q, k, v, o, do, l, m)), block_q=64)
    for g, w in zip(_port_bwd(q, k, v, o, do, l, m), want):
        _close(g, w)


# three KV blocks of 128 with a ragged tail, and one block
@pytest.mark.parametrize("nk,block_k", [(300, 128), (100, 128)])
def test_plain_matches_jax_bwd_pallas_multi(nk, block_k):
    q, k, v, do = _inputs(2, 2, 2, 37, nk, 48)
    o, l, m = _fwd(q, k, v)
    want = jax.jit(_bwd_pallas_multi, static_argnames="block_k")(
        *(jnp.asarray(x) for x in (q, k, v, o, do, l, m)), block_k=block_k)
    for g, w in zip(_port_bwd(q, k, v, o, do, l, m), want):
        _close(g, w)


def test_plain_matches_jax_bwd_xla_fed_global_statistics():
    """The context-parallel backward per shard: the global (o, l, m) with one
    shard of the KV rows -> dk, dv of those rows and the shard's partial dq,
    whose sum over the shards is the whole dq."""
    q, k, v, do = _inputs(3, 1, 2, 30, 260, 16)
    o, l, m = _fwd(q, k, v)
    bounds = [(0, 130), (130, 260)]
    dq_sum = 0
    for lo, hi in bounds:
        ks, vs = k[:, :, lo:hi], v[:, :, lo:hi]
        want = _bwd_xla(tuple(jnp.asarray(x) for x in (q, ks, vs, o, l, m)), jnp.asarray(do), block_k=64)
        got = _port_bwd(q, ks, vs, o, do, l, m)
        for g, w in zip(got, want):
            _close(g, w)
        dq_sum = dq_sum + got[0]
    _close(dq_sum, _port_bwd(q, k, v, o, do, l, m)[0])


def test_views_equal_contiguous():
    """Head-major views of token-major projections, read in place, give what
    the contiguous copies give; the gradients come back as head-major views
    of token-major buffers."""
    b, h, nq, nk, hd = 2, 4, 33, 70, 16
    rng = np.random.default_rng(4)
    xs = [torch.from_numpy(rng.standard_normal((b, n, h * hd)).astype(np.float32)) for n in (nq, nk, nk, nq)]
    views = [fa._split_heads(x, h) for x in xs]  # views: no copy
    q, k, v, do = views
    o, l, m = fa.flash_attention_head_major(q, k, v)
    got = fa.flash_attention_head_major_bwd(q, k, v, o, do, l, m)
    want = fa.flash_attention_head_major_bwd(*(t.contiguous() for t in (q, k, v, o, do)), l, m)
    for g, w, n in zip(got, want, (nq, nk, nk)):
        assert g.shape == (b, h, n, hd) and g.stride() == (n * h * hd, hd, h * hd, 1)
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("nk,kernel", [(2048, "K8"), (2049, "K9")])
def test_autograd_matches_jax_grad_and_dispatch(monkeypatch, nk, kernel):
    """Gradients of the head-major attention against ``jax.grad`` through the
    JAX ``custom_vjp``; the backward counts K8 up to 2048 KV tokens and K9
    beyond, as the JAX ``_dispatch_bwd`` picks its kernels (the launch is
    stood in by the plain version)."""
    q, k, v, g = _inputs(5, 1, 2, 24, nk, 16)
    want = jax.jit(jax.grad(lambda q, k, v: jnp.sum(flash_cross_attention(q, k, v) * g), argnums=(0, 1, 2)))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = fa.head_major_flash_attention(qt, kt, vt)
    monkeypatch.setattr(fa._build, "device_type", lambda t: "cuda")
    monkeypatch.setattr(fa, "_launch_head_major_bwd",
                        lambda what, *args: fa.flash_attention_head_major_bwd_plain(*args))
    counts = (fa.flash_attention_bwd_single.launches, fa.flash_attention_bwd_multi.launches)
    out.backward(torch.from_numpy(g))
    launched = (fa.flash_attention_bwd_single.launches - counts[0], fa.flash_attention_bwd_multi.launches - counts[1])
    assert launched == ((1, 0) if kernel == "K8" else (0, 1))
    for t, w in zip((qt, kt, vt), want):
        _close(t.grad.numpy(), w)


def test_rejects_mismatched_shapes():
    q, k = torch.zeros(1, 2, 4, 16), torch.zeros(1, 2, 8, 16)
    l = torch.zeros(1, 2, 4)
    with pytest.raises(ValueError, match=r"q/o/do \(B, H, Nq, hd\)"):
        fa.flash_attention_head_major_bwd(q, k, k[:, :1], q, q, l, l)
    with pytest.raises(ValueError, match=r"l/m \(B, H, Nq\)"):
        fa.flash_attention_head_major_bwd(q, k, k, q, q, l[..., :3], l)
