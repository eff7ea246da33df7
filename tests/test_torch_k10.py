"""K10, the fused LN -> MLP half of a ViT block with the attention half's
LayerScale residual folded in, against the JAX package's ``fused_res_ln_mlp``
(its Pallas kernel in interpret mode on the CPU): the forward in fp32 and
bf16 and the ten gradients of its custom VJP. On the CPU the port's op runs
its plain version. Inputs come from a numpy seed; the JAX weights are (D, F)
and (F, D), the port's the torch ``Linear`` layout."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crossscore_tpu.ops.fused_mlp import fused_res_ln_mlp as jax_frlm
from crossscore_tpu_torch.ops import fused_mlp as fm


def _args(seed, b=2, n=37, d=64, f=256):
    """The JAX test's ``_make_args`` sizes, with attn and ls1 (numpy fp32)."""
    rng = np.random.default_rng(seed)
    r = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    x = r(b, n, d) * 0.5
    attn = r(b, n, d) * 0.3
    ls1 = 1.0 + 0.05 * r(d)
    return [x, attn, ls1, 1.0 + 0.1 * r(d), 0.1 * r(d), r(d, f) * d ** -0.5, 0.1 * r(f), r(f, d) * f ** -0.5,
            0.1 * r(d), 1.0 + 0.05 * r(d)]


def _torch_args(args, dtype=torch.float32):
    """The port's layout: w1 (F, D), w2 (D, F)."""
    t = [torch.from_numpy(a.copy()) for a in args]
    t[5], t[7] = t[5].t().contiguous(), t[7].t().contiguous()
    return [a.to(dtype) for a in t]


@pytest.mark.parametrize("dtype,atol", [
    # fp32: the plain version's casts are the kernel's; summation order only
    ("float32", 1e-5),
    # bf16: both round LN(x2) and the hidden layer to bf16 and the output once;
    # a rounding that flips on one side moves an output by one bf16 ulp (2^-6
    # at |out| < 4); these inputs read bit-equal
    ("bfloat16", 1.6e-2)])
@pytest.mark.parametrize("n", [37, 13, 1, 63])
def test_k10_forward_matches_jax(dtype, atol, n):
    args = _args(0, n=n)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = np.asarray(jax_frlm(*(jnp.asarray(a, jdt) for a in args)).astype(jnp.float32))
    launches = fm.fused_res_ln_mlp.launches
    got = fm.fused_res_ln_mlp(*_torch_args(args, getattr(torch, dtype)))
    assert fm.fused_res_ln_mlp.launches == launches  # the plain version on the CPU
    assert got.dtype == getattr(torch, dtype) and got.shape == (2, n, 64)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=atol)


def test_k10_gradients_match_jax():
    """All ten gradients of sum(out^2) against ``jax.grad`` of the JAX op at
    b=1, n=16, d=32, f=64 (the JAX test's sizes), within 1e-4."""
    args = _args(1, b=1, n=16, d=32, f=64)
    g_j = jax.grad(lambda *a: jnp.sum(jnp.square(jax_frlm(*a))), argnums=tuple(range(10)))(
        *(jnp.asarray(a) for a in args))
    t = [a.requires_grad_() for a in _torch_args(args)]
    fm.fused_res_ln_mlp(*t).square().sum().backward()
    for i, (a, gj) in enumerate(zip(t, g_j)):
        gj = np.asarray(gj)
        got = a.grad.numpy()
        if i in (5, 7):  # w1, w2: the port's layout is the transpose
            got = got.T
        np.testing.assert_allclose(got, gj, rtol=1e-4, atol=1e-4, err_msg=f"gradient {i}")


def test_k10_reference_is_the_jax_reference_and_k2_on_the_sum():
    """``_reference_res`` (the backward's recompute) matches the JAX
    ``_reference_res_xla``, and in fp32 the plain K10 is K2 on x + attn * ls1."""
    from crossscore_tpu.ops.fused_mlp import _reference_res_xla

    args = _args(2)
    want = np.asarray(_reference_res_xla(*(jnp.asarray(a) for a in args), 1e-6))
    t = _torch_args(args)
    np.testing.assert_allclose(fm._reference_res(*t).numpy(), want, rtol=0, atol=1e-5)
    k2 = fm.fused_ln_mlp_plain(t[0] + t[1] * t[2], *t[3:], 1e-6, "exact")
    torch.testing.assert_close(fm.fused_res_ln_mlp_plain(*t), k2, rtol=0, atol=1e-6)
