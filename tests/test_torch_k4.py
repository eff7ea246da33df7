"""K4, the decoder attention backward, against the JAX package's Pallas
backward (``_bwd_cross_ln_pallas``, interpreted on the CPU); the port's
wrapper takes its plain PyTorch version on CPU tensors. Inputs come from a
numpy seed."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crossscore_tpu.ops.flash_attention import _bwd_cross_ln_pallas, _flash_cross_ln_fwd
from crossscore_tpu_torch.ops import flash_attention as fa
from crossscore_tpu_torch.ops.attention import attention_with_stats


def _inputs(seed: int, b: int, nq: int, nk: int, d: int):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, n, d)).astype(np.float32) for n in (nq, nk, nk, nq))


def _port_bwd(q, k, v, do, h):
    """The port's forward stats (K3 plain) and K4 through the CPU wrapper."""
    qt, kt, vt, dot = (torch.from_numpy(a) for a in (q, k, v, do))
    o, l, m = fa.flash_cross_attention(qt, kt, vt, h)
    return o, l, m, fa.flash_cross_attention_bwd(qt, kt, vt, o, dot, l, m, h)


@pytest.mark.parametrize("nq,nk", [(37, 300), (64, 2100)])  # ragged on both axes
def test_k4_plain_matches_jax_kernel_hd64(nq, nk):
    """hd 64 needs no padding in the JAX kernel (two heads per 128 lanes);
    both sides get the same (o, l, m)."""
    h, hd = 2, 64
    q, k, v, do = _inputs(20 + nq, 1, nq, nk, h * hd)
    o, l, m, got = _port_bwd(q, k, v, do, h)
    want = _bwd_cross_ln_pallas(*(jnp.asarray(a) for a in (q, k, v, o.numpy(), do, l.numpy(), m.numpy())),
                                h, hd)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=0, err_msg=name)


def test_k4_plain_matches_jax_padded_prescaled_route_hd48():
    """At hd 48 the JAX decoder pads heads to 64 lanes and folds the scale
    correction sqrt(64/48) into q. The weights' gradients agree; the kernels'
    dq differ by that prescale and the zero pad lanes, so dq_true =
    dq_pad[..., :48] * prescale, and dk, dv drop their pad lanes."""
    h, hd, hd_pad = 2, 48, 64
    prescale = (hd_pad ** 0.5) / (hd ** 0.5)
    q, k, v, do = _inputs(30, 2, 37, 150, h * hd)

    def pad(x, s=1.0):
        b, n, _ = x.shape
        x = np.pad((x * s).reshape(b, n, h, hd), ((0, 0), (0, 0), (0, 0), (0, hd_pad - hd)))
        return jnp.asarray(x.reshape(b, n, h * hd_pad).astype(np.float32))

    def unpad(x):
        b, n, _ = x.shape
        return np.asarray(x).reshape(b, n, h, hd_pad)[..., :hd].reshape(b, n, h * hd)

    qp, kp, vp, dop = pad(q, prescale), pad(k), pad(v), pad(do)
    o_p, l_j, m_j = _flash_cross_ln_fwd(qp, kp, vp, h, hd_pad, block_q=40, block_k=256)
    dq_p, dk_p, dv_p = _bwd_cross_ln_pallas(qp, kp, vp, o_p, dop, l_j, m_j, h, hd_pad)
    o, l, m, (dq, dk, dv) = _port_bwd(q, k, v, do, h)
    np.testing.assert_allclose(o.numpy(), unpad(o_p), atol=1e-5, rtol=0)
    np.testing.assert_allclose(dq.numpy(), unpad(dq_p) * prescale, atol=1e-5, rtol=0)
    np.testing.assert_allclose(dk.numpy(), unpad(dk_p), atol=1e-5, rtol=0)
    np.testing.assert_allclose(dv.numpy(), unpad(dv_p), atol=1e-5, rtol=0)


def test_k4_autograd_function_gradcheck():
    gen = torch.Generator().manual_seed(0)
    h = 2
    q, k, v = (torch.randn(2, n, h * 4, generator=gen, dtype=torch.float64, requires_grad=True)
               for n in (5, 7, 7))
    assert torch.autograd.gradcheck(lambda q, k, v: fa.flash_cross_attention_ln(q, k, v, h), (q, k, v))


def test_k4_autograd_function_matches_autograd_through_dense():
    gen = torch.Generator().manual_seed(1)
    h = 4
    q, k, v = (torch.randn(2, n, h * 16, generator=gen, requires_grad=True) for n in (9, 33, 33))
    do = torch.randn(2, 9, h * 16, generator=gen)
    o = fa.flash_cross_attention_ln(q, k, v, h)
    got = torch.autograd.grad(o, (q, k, v), do)
    o_ref = fa._merge_heads(attention_with_stats(*(fa._split_heads(t, h) for t in (q, k, v)))[0])
    want = torch.autograd.grad(o_ref, (q, k, v), do)
    torch.testing.assert_close(o, o_ref, atol=1e-6, rtol=0)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-6, rtol=0)


def test_k4_bf16_rounds_p_and_ds_before_the_products():
    """The bf16 plain version keeps the kernel's roundings: p and ds in bf16,
    fp32 sums; it stays within bf16 resolution of the fp32 recipe."""
    q, k, v, do = _inputs(40, 1, 20, 50, 2 * 16)
    o, l, m, want = _port_bwd(q, k, v, do, 2)
    bf = [torch.from_numpy(a).bfloat16() for a in (q, k, v)] + [o.bfloat16(), torch.from_numpy(do).bfloat16()]
    got = fa.flash_cross_attention_bwd(*bf, l, m, 2)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        err = float(((g.float() - w).abs() / (1 + w.abs())).max())
        assert err < 2e-2, err


def test_k4_wrapper_on_cpu_counts_nothing_and_checks_shapes():
    q = torch.randn(1, 5, 32)
    o, l, m = fa.flash_cross_attention(q, q, q, 2)
    before = fa.flash_cross_attention_bwd.launches
    fa.flash_cross_attention_bwd(q, q, q, o, torch.randn_like(o), l, m, 2)
    assert fa.flash_cross_attention_bwd.launches == before
    with pytest.raises(ValueError, match="l/m"):
        fa.flash_cross_attention_bwd(q, q, q, o, o, l[:, :1], m, 2)
    with pytest.raises(ValueError, match="unsupported device"):
        z = torch.zeros(1, 5, 32, device="meta")
        fa.flash_cross_attention_bwd(z, z, z, z, z, torch.zeros(1, 2, 5, device="meta"),
                                     torch.zeros(1, 2, 5, device="meta"), 2)
