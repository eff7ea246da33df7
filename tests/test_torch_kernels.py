"""The port's kernel modules (K1, K2, K3) against the JAX package's Pallas
kernels, run on the CPU (Pallas in interpret mode; the port's wrappers take
their plain PyTorch versions on CPU tensors). Inputs come from a numpy seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crossscore_tpu.models.decoder import TorchStyleMHA as JaxMHA
from crossscore_tpu.ops.flash_attention import _flash_qkv_fwd
from crossscore_tpu.ops.fused_mlp import fused_ln_mlp as jax_fused_ln_mlp
from crossscore_tpu_torch.io.convert import mha_state_from_jax
from crossscore_tpu_torch.models.decoder import TorchStyleMHA
from crossscore_tpu_torch.ops import flash_attention as fa
from crossscore_tpu_torch.ops.fused_mlp import fused_ln_mlp

TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _close(got, want, tol: float) -> None:
    """max |got - want| / (1 + |want|) <= tol."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = float(np.max(np.abs(got - want) / (1.0 + np.abs(want))))
    assert err <= tol, f"error {err} > {tol}"


# fp32: both sides fp32, summation order and exp vs exp2 differ.
# bf16: inputs identical; the JAX kernels round p to bf16 before P.V where the
# plain version rounds the normalised probabilities, and every output is
# rounded to bf16 once: two bf16 ulps (2^-7) relative.
TOL = {"float32": 1e-5, "bfloat16": 1.6e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k1_flash_qkv_matches_jax(dtype):
    rng = np.random.default_rng(1)
    b, n, h, hd = 2, 26, 6, 64  # 70x70 px + CLS at dinov2-small width
    qkv = rng.standard_normal((b, n, 3 * h * hd)).astype(np.float32)
    qkv_j = jnp.asarray(qkv).astype(JAX_DT[dtype])
    o_j, l_j, m_j = _flash_qkv_fwd(qkv_j, h)
    qkv_t = torch.from_numpy(qkv).to(TORCH_DT[dtype])
    o_t, l_t, m_t = fa.flash_qkv_self_attention(qkv_t, h)
    assert o_t.shape == (b, n, h * hd) and o_t.dtype == qkv_t.dtype
    assert l_t.shape == m_t.shape == (b, h, n) and l_t.dtype == torch.float32
    _close(_np(o_t), np.asarray(o_j, np.float32), TOL[dtype])
    _close(_np(m_t), np.asarray(m_j), 1e-5)
    _close(_np(l_t) / np.asarray(l_j), np.ones_like(np.asarray(l_j)), TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gelu", ["tanh", "exact"])
# (2, 20) as before; one row, a row short of a 64-row tile, and rows that
# leave a ragged last tile
@pytest.mark.parametrize("b,n", [(2, 20), (1, 1), (1, 63), (3, 43)])
def test_k2_fused_ln_mlp_matches_jax(dtype, gelu, b, n):
    rng = np.random.default_rng(2)
    d, f = 64, 256
    x = rng.standard_normal((b, n, d)).astype(np.float32)
    lns = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    lnb = (0.1 * rng.standard_normal(d)).astype(np.float32)
    w1 = (rng.standard_normal((d, f)) / np.sqrt(d)).astype(np.float32)  # flax (in, out)
    b1 = (0.1 * rng.standard_normal(f)).astype(np.float32)
    w2 = (rng.standard_normal((f, d)) / np.sqrt(f)).astype(np.float32)
    b2 = (0.1 * rng.standard_normal(d)).astype(np.float32)
    ls2 = (1 + 0.5 * rng.standard_normal(d)).astype(np.float32)
    want = jax_fused_ln_mlp(jnp.asarray(x).astype(JAX_DT[dtype]), *map(jnp.asarray, (lns, lnb, w1, b1, w2, b2, ls2)),
                            1e-6, gelu)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    got = fused_ln_mlp(t(x).to(TORCH_DT[dtype]), t(lns), t(lnb), t(w1.T), t(b1), t(w2.T), t(b2), t(ls2),
                       1e-6, gelu)
    assert got.shape == (b, n, d) and got.dtype == TORCH_DT[dtype]
    _close(_np(got), np.asarray(want, np.float32), TOL[dtype])


@pytest.fixture(scope="module")
def mha_pair():
    """JAX TorchStyleMHA at d_model 384, 8 heads (hd 48: the JAX pallas route
    pads it to 64 and prescales q) and the port's MHA with the same weights."""
    d, h = 384, 8
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.standard_normal((1, 5, d)).astype(np.float32))
    params = jax.device_get(JaxMHA(d, h, jnp.float32, "pallas").init(jax.random.PRNGKey(0), x, x, x))["params"]
    sd = {}
    mha_state_from_jax(params, sd, "m")
    port = TorchStyleMHA(d, h, "flash", device="cpu")
    port.load_state_dict({k[2:]: torch.from_numpy(np.array(v)) for k, v in sd.items()})
    return params, port


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nq,nk", [(37, 37), (37, 111)])  # self, cross; Nk not a multiple of 128
def test_k3_decoder_attention_matches_jax_padded_route(mha_pair, dtype, nq, nk):
    params, port = mha_pair
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, nq, 384)).astype(np.float32)
    kv = q if nk == nq else rng.standard_normal((2, nk, 384)).astype(np.float32)
    jd = JAX_DT[dtype]
    want, _ = JaxMHA(384, 8, jd, "pallas").apply({"params": params}, jnp.asarray(q).astype(jd),
                                                jnp.asarray(kv).astype(jd), jnp.asarray(kv).astype(jd))
    qt, kvt = (torch.from_numpy(a).to(TORCH_DT[dtype]) for a in (q, kv))
    got, probs = port(qt, kvt, kvt)
    assert probs is None and got.shape == (2, nq, 384)
    # bf16: the projections around the kernel also round (q/k/v, out)
    _close(_np(got), np.asarray(want, np.float32), TOL[dtype] if dtype == "float32" else 3e-2)


def test_k3_need_weights_dense_path(mha_pair):
    params, port = mha_pair
    rng = np.random.default_rng(5)
    q = rng.standard_normal((1, 9, 384)).astype(np.float32)
    kv = rng.standard_normal((1, 30, 384)).astype(np.float32)
    want, wprobs = JaxMHA(384, 8, jnp.float32, "pallas").apply(
        {"params": params}, jnp.asarray(q), jnp.asarray(kv), jnp.asarray(kv), need_weights=True
    )
    got, probs = port(torch.from_numpy(q), torch.from_numpy(kv), torch.from_numpy(kv), need_weights=True)
    assert probs.shape == (1, 8, 9, 30) and probs.dtype == torch.float32
    _close(_np(got), np.asarray(want), 1e-5)
    _close(probs.detach().numpy(), np.asarray(wprobs), 1e-6)


def test_k3_flash_cross_attention_stats_match_jax_kernel():
    """(o, l, m) of K3's plain version vs the JAX kernel at a head dim that
    needs no padding there (hd 64, two heads per 128 lanes)."""
    from crossscore_tpu.ops.flash_attention import _flash_cross_ln_fwd

    rng = np.random.default_rng(6)
    q = rng.standard_normal((2, 37, 128)).astype(np.float32)
    k = rng.standard_normal((2, 150, 128)).astype(np.float32)
    v = rng.standard_normal((2, 150, 128)).astype(np.float32)
    o_j, l_j, m_j = _flash_cross_ln_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 2, 64,
                                        block_q=40, block_k=128)
    o_t, l_t, m_t = fa.flash_cross_attention(*(torch.from_numpy(a) for a in (q, k, v)), 2)
    _close(o_t.numpy(), np.asarray(o_j), 1e-5)
    _close(m_t.numpy(), np.asarray(m_j), 1e-5)
    _close(l_t.numpy() / np.asarray(l_j), np.ones((2, 2, 37), np.float32), 1e-5)


def test_wrappers_on_cpu_use_plain_versions_and_count_nothing():
    qkv = torch.randn(1, 5, 3 * 32, generator=torch.Generator().manual_seed(0))
    before = (fa.flash_qkv_self_attention.launches, fa.flash_cross_attention.launches,
              fused_ln_mlp.launches)
    o, l, m = fa.flash_qkv_self_attention(qkv, 2)
    o_p, l_p, m_p = fa.flash_qkv_self_attention_plain(qkv, 2)
    assert torch.equal(o, o_p) and torch.equal(l, l_p) and torch.equal(m, m_p)
    q = qkv[..., :32].contiguous()
    fa.flash_cross_attention(q, q, q, 2)
    d = 32
    fused_ln_mlp(q, torch.ones(d), torch.zeros(d), torch.zeros(128, d), torch.zeros(128),
                 torch.zeros(d, 128), torch.zeros(d), torch.ones(d))
    assert (fa.flash_qkv_self_attention.launches, fa.flash_cross_attention.launches,
            fused_ln_mlp.launches) == before


@pytest.mark.parametrize("hd", [8, 24, 144])
def test_cuda_head_dim_rule(hd):
    with pytest.raises(ValueError, match=f"head dim {hd}"):
        fa._check_head_dim("k", hd)


def test_wrappers_reject_bad_shapes_and_devices():
    with pytest.raises(ValueError, match="3\\*H\\*hd"):
        fa.flash_qkv_self_attention(torch.zeros(1, 4, 10), 3)
    with pytest.raises(ValueError, match="q \\(B, Nq"):
        fa.flash_cross_attention(torch.zeros(1, 4, 8), torch.zeros(1, 5, 8), torch.zeros(1, 6, 8), 2)
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_qkv_self_attention(torch.zeros(1, 4, 12, device="meta"), 2)
    with pytest.raises(ValueError, match="gelu"):
        fused_ln_mlp(torch.zeros(1, 2, 4), torch.ones(4), torch.zeros(4), torch.zeros(8, 4),
                     torch.zeros(8), torch.zeros(4, 8), torch.zeros(4), torch.ones(4), gelu="fast")
