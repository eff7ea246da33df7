"""The kernels' hd 8 route (``ops/flash_attention.py::narrow_head_route``):
each operand zero-padded from 8 to 16 lanes a head, the hd 16 body launched
at the true scale 1/sqrt(8), o / dq / dk / dv sliced back. On the CPU the
plain version at the padded width stands in for the kernel, so the pad, the
scale and the slice are what is held here: K3 and K4 against the JAX
package's Pallas functions (interpreted on the CPU) on the JAX decoder's own
hd 8 route (64 lanes a head, the scale folded into q), K3, K4 and K6
against the port's plain versions at hd 8, K7 and K8/K9 against the JAX
head-major functions. Inputs come from a numpy seed;
fp32, ATOL 1e-5 (summation order)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crossscore_tpu.ops.flash_attention import (
    _bwd_cross_ln_pallas, _bwd_pallas_multi, _bwd_pallas_single, _flash_cross_ln_fwd, _flash_fwd,
)
from crossscore_tpu_torch.ops import flash_attention as fa

ATOL = 1e-5
H = 8  # the decoder's heads at every preset; dinov2-test's width 64 gives hd 8
HD, HD_JAX = 8, 64  # the JAX decoder pads hd 8 to 64 lanes (models/decoder.py:173)


def _inputs(seed: int, b: int, nq: int, nk: int, d: int):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, n, d)).astype(np.float32) for n in (nq, nk, nk, nq))


def _jax_pad(x, s=1.0):
    b, n, _ = x.shape
    x = np.pad((x * s).reshape(b, n, H, HD), ((0, 0), (0, 0), (0, 0), (0, HD_JAX - HD)))
    return jnp.asarray(x.reshape(b, n, H * HD_JAX).astype(np.float32))


def _jax_unpad(x):
    b, n, _ = x.shape
    return np.asarray(x).reshape(b, n, H, HD_JAX)[..., :HD].reshape(b, n, H * HD)


def _fwd_route(q, k, v, kv_bias=None):
    """K3 (K6 with a bias) at hd 8 through the route, the plain version at
    hd 16 in the kernel's place."""
    return fa.narrow_head_route(
        lambda q, k, v, scale: fa.flash_cross_attention_plain(q, k, v, H, kv_bias, scale=scale), (q, k, v), 1)


def _bwd_route(q, k, v, o, do, l, m):
    return fa.narrow_head_route(
        lambda q, k, v, o, do, scale: fa.flash_cross_attention_bwd_plain(q, k, v, o, do, l, m, H, scale=scale),
        (q, k, v, o, do), 3)


@pytest.mark.parametrize("b,nq,nk", [(4, 36, 72), (1, 37, 300)])  # the tiny preset's decoder (crop 84, K=2); ragged
def test_k3_k4_route_matches_jax_decoder_route(b, nq, nk):
    """The JAX decoder at hd 8: heads padded to 64 lanes, q prescaled by
    sqrt(64/8) so that the kernel's 1/sqrt(64) gives 1/sqrt(8); dq carries
    the prescale. Both give the same o, l, m and gradients."""
    prescale = math.sqrt(HD_JAX / HD)
    q, k, v, do = _inputs(b * 100 + nk, b, nq, nk, H * HD)
    qp, kp, vp, dop = _jax_pad(q, prescale), _jax_pad(k), _jax_pad(v), _jax_pad(do)
    o_j, l_j, m_j = _flash_cross_ln_fwd(qp, kp, vp, H, HD_JAX, block_q=40, block_k=128)
    dq_j, dk_j, dv_j = _bwd_cross_ln_pallas(qp, kp, vp, o_j, dop, l_j, m_j, H, HD_JAX)

    qt, kt, vt, dot = (torch.from_numpy(a) for a in (q, k, v, do))
    o, l, m = _fwd_route(qt, kt, vt)
    assert o.shape == qt.shape and o.is_contiguous() and l.shape == m.shape == (b, H, nq)
    np.testing.assert_allclose(o.numpy(), _jax_unpad(o_j), atol=ATOL, rtol=0)
    np.testing.assert_allclose(m.numpy(), np.asarray(m_j), atol=ATOL, rtol=0)
    np.testing.assert_allclose(l.numpy() / np.asarray(l_j), 1.0, atol=ATOL, rtol=0)
    dq, dk, dv = _bwd_route(qt, kt, vt, o, dot, l, m)
    np.testing.assert_allclose(dq.numpy(), _jax_unpad(dq_j) * prescale, atol=ATOL, rtol=0)
    np.testing.assert_allclose(dk.numpy(), _jax_unpad(dk_j), atol=ATOL, rtol=0)
    np.testing.assert_allclose(dv.numpy(), _jax_unpad(dv_j), atol=ATOL, rtol=0)


def test_route_equals_the_plain_versions_at_hd8():
    """K3, K4 and K6 (a per-item bias that masks a third of the keys:
    per key, so the pad leaves it as it is) through the route against the
    plain versions at hd 8 itself."""
    q, k, v, do = (torch.from_numpy(a).double() for a in _inputs(7, 2, 37, 65, H * HD))
    bias = torch.zeros(2, 65)
    bias[:, ::3] = -1e30
    for kv_bias in (None, bias):
        got = _fwd_route(q, k, v, kv_bias)
        for g, w in zip(got, fa.flash_cross_attention_plain(q, k, v, H, kv_bias)):
            torch.testing.assert_close(g, w, atol=1e-12, rtol=0)
    o, l, m = fa.flash_cross_attention_plain(q, k, v, H)
    for g, w in zip(_bwd_route(q, k, v, o, do, l, m), fa.flash_cross_attention_bwd_plain(q, k, v, o, do, l, m, H)):
        torch.testing.assert_close(g, w, atol=1e-12, rtol=0)


@pytest.mark.parametrize("nk", [72, 2100])  # K8 (one KV block on the TPU), K9 beyond 2048
def test_k7_k89_route_matches_jax_head_major(nk):
    """K7 and K8/K9 on head-major views through the route against the JAX
    head-major functions at hd 8 (the JAX kernels take it as it is)."""
    q, k, v, do = _inputs(nk, 2, 36, nk, H * HD)
    hm = [torch.from_numpy(a).view(2, -1, H, HD).transpose(1, 2) for a in (q, k, v, do)]
    o, l, m = fa.narrow_head_route(
        lambda q, k, v, scale: fa.flash_attention_head_major_plain(q, k, v, scale=scale), hm[:3], 1)
    assert o.shape == hm[0].shape and o.is_contiguous()
    jq, jk, jv, jdo = (jnp.asarray(t.contiguous().numpy()) for t in hm)
    o_j, l_j, m_j = _flash_fwd(jq, jk, jv, block_q=40, block_k=128)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_j), atol=ATOL, rtol=0)
    np.testing.assert_allclose(m.numpy(), np.asarray(m_j), atol=ATOL, rtol=0)
    np.testing.assert_allclose(l.numpy() / np.asarray(l_j), 1.0, atol=ATOL, rtol=0)
    got = fa.narrow_head_route(
        lambda q, k, v, o, do, scale: fa.flash_attention_head_major_bwd_plain(q, k, v, o, do, l, m, scale=scale),
        (*hm[:3], o, hm[3]), 3)
    bwd = _bwd_pallas_single if nk <= fa.BWD_SINGLE_MAX_NK else _bwd_pallas_multi
    want = bwd(jq, jk, jv, jnp.asarray(o.numpy()), jdo, jnp.asarray(l.numpy()), jnp.asarray(m.numpy()))
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.shape == hm[0].shape[:2] + (g.shape[2], HD), name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=0, err_msg=name)


def test_a_wrong_scale_is_caught():
    """The padded width's scale 1/sqrt(16) in place of 1/sqrt(8) scales every
    logit by 0.71: the route's check against the plain version at hd 8 must
    see it."""
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(3, 4, 36, 72, H * HD))
    wrong = fa.narrow_head_route(lambda q, k, v, scale: fa.flash_cross_attention_plain(q, k, v, H), (q, k, v), 1)
    want = fa.flash_cross_attention_plain(q, k, v, H)
    assert float((wrong[0] - want[0]).abs().max()) > 100 * ATOL
    assert float((wrong[2] - want[2]).abs().max()) > 100 * ATOL


def test_pad_and_unpad_are_inverse_and_zero_filled():
    x = torch.arange(2 * 3 * 24, dtype=torch.float32).reshape(2, 3, 24)
    p = fa.pad_head_dim(x)
    assert p.shape == (2, 3, 48) and torch.equal(p.view(2, 3, 3, 16)[..., 8:], torch.zeros(2, 3, 3, 8))
    assert torch.equal(fa.unpad_head_dim(p), x)
    hm = x.view(2, 3, 3, 8).transpose(1, 2)  # a head-major view
    ph = fa.pad_head_dim(hm)
    assert ph.shape == (2, 3, 3, 16) and ph.is_contiguous() and torch.equal(fa.unpad_head_dim(ph), hm)
