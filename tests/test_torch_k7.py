"""K7, the head-major flash forward, against the JAX package's ``_flash_fwd``
(its Pallas kernels in interpret mode on the CPU): v1 without a bias and v2
with a shared (Nk,) bias row, over one KV block, several blocks with a ragged
tail, and a strided head-major view of a token-major projection. On the CPU
the port's wrapper runs its plain version. Inputs come from a numpy seed."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crossscore_tpu.ops.flash_attention import _flash_fwd
from crossscore_tpu_torch.ops import flash_attention as fa

# fp32 on both sides; summation order and exp vs exp2 differ
TOL = 1e-5


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.max(np.abs(got - want) / (1.0 + np.abs(want))))
    assert err <= tol, f"error {err} > {tol}"


def _inputs(seed, b, h, nq, nk, hd, scale=1.0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, h, n, hd)).astype(np.float32) * s
               for n, s in ((nq, scale), (nk, scale), (nk, 1.0)))
    return q, k, v


def _bias(seed, nk):
    """A shared bias row: small natural-unit offsets, a fifth of the columns masked."""
    rng = np.random.default_rng(seed)
    bias = -rng.random(nk).astype(np.float32)
    bias[rng.random(nk) < 0.2] = -1e30
    return bias


# (nq, nk, block_q, block_k): one KV block; three blocks with a ragged tail;
# a single block wider than Nk (the JAX single-block body), at hd 48 and 16
CASES = [(40, 100, 64, 128, 48), (40, 300, 32, 128, 48), (24, 200, 24, 256, 16)]


@pytest.mark.parametrize("nq,nk,bq,bk,hd", CASES)
@pytest.mark.parametrize("variant", ["v1", "v2"])
def test_k7_matches_jax_flash_fwd(nq, nk, bq, bk, hd, variant):
    q, k, v = _inputs(1, 2, 3, nq, nk, hd)
    bias = _bias(2, nk) if variant == "v2" else None
    o_j, l_j, m_j = _flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=bq, block_k=bk,
                               variant=variant, kv_bias=None if bias is None else jnp.asarray(bias))
    launches = fa.flash_attention_head_major.launches
    o_t, l_t, m_t = fa.flash_attention_head_major(
        *(torch.from_numpy(x) for x in (q, k, v)), None if bias is None else torch.from_numpy(bias))
    assert fa.flash_attention_head_major.launches == launches  # the plain version on the CPU
    assert o_t.shape == (2, 3, nq, hd) and o_t.dtype == torch.float32
    assert l_t.shape == m_t.shape == (2, 3, nq) and l_t.dtype == m_t.dtype == torch.float32
    _close(o_t.numpy(), np.asarray(o_j))
    _close(m_t.numpy(), np.asarray(m_j))  # natural units, the bias included
    _close(l_t.numpy() / np.asarray(l_j), np.ones(l_t.shape))


def test_k7_strided_view_equals_contiguous_and_jax():
    """The head-major view of token-major (B, N, H*hd) projections, read in
    place, gives what the contiguous (B, H, N, hd) copy gives."""
    b, h, nq, nk, hd = 2, 8, 37, 150, 48
    rng = np.random.default_rng(3)
    xq, xk, xv = (rng.standard_normal((b, n, h * hd)).astype(np.float32) for n in (nq, nk, nk))

    def heads(x):
        return torch.from_numpy(x).view(b, -1, h, hd).transpose(1, 2)

    views = [heads(x) for x in (xq, xk, xv)]
    assert not views[0].is_contiguous() and views[0].stride() == (nq * h * hd, hd, h * hd, 1)
    got = fa.flash_attention_head_major(*views)
    want = fa.flash_attention_head_major(*(t.contiguous() for t in views))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)
    o_j, l_j, m_j = _flash_fwd(*(jnp.asarray(t.contiguous().numpy()) for t in views), block_q=64,
                               block_k=128)
    _close(got[0].numpy(), np.asarray(o_j))
    _close(got[2].numpy(), np.asarray(m_j))
    _close(got[1].numpy() / np.asarray(l_j), np.ones(got[1].shape))


def test_k7_rejects_what_the_kernel_does_not_take():
    q, k, v = (torch.zeros(1, 2, n, 16) for n in (4, 8, 8))
    with pytest.raises(ValueError, match="kv_bias must be float32"):
        fa.flash_attention_head_major(q, k, v, torch.zeros(1, 8))  # per-item rows: not K7's
    with pytest.raises(ValueError, match="kv_bias must be float32"):
        fa.flash_attention_head_major(q, k, v, torch.zeros(8, dtype=torch.float64))
    with pytest.raises(ValueError, match=r"q \(B, H, Nq, hd\)"):
        fa.flash_attention_head_major(q, k, v[:, :1])
    with pytest.raises(RuntimeError, match="forward only"):
        fa.flash_attention_head_major(q.requires_grad_(), k, v)
