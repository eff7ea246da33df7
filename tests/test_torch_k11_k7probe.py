"""K11 (K1's timing probes and its chunked schedule) and K7' (K7's timing
variants) against the JAX package's ``_flash_qkv_fwd`` with ``probe`` /
``chunks`` and ``_flash_fwd`` with ``variant`` (their Pallas kernels in
interpret mode on the CPU). On the CPU the port's wrappers run their plain
versions, which repeat the TPU bodies' casts. The probes compute wrong math
on purpose (unnormalised, large outputs): they are held by the relative L2
error of each output. Inputs come from a numpy seed, fp32."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crossscore_tpu.ops.flash_attention import _flash_fwd, _flash_qkv_fwd
from crossscore_tpu_torch.ops import flash_attention as fa

# K11's exact modes (chunks): fp32 on both sides, summation order and exp2
# ulps; the probes and K7': relative L2 of each output
ATOL = 2e-5
REL_L2 = 1e-5


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    norm = np.linalg.norm(want)
    return float(np.linalg.norm(got - want) / norm) if norm else float(np.abs(got).max())


def _qkv(seed, b, n, h, hd):
    return np.random.default_rng(seed).standard_normal((b, n, 3 * h * hd)).astype(np.float32)


@pytest.mark.parametrize("hd", [64, 16])
@pytest.mark.parametrize("probe", sorted(fa.QKV_PROBES))
def test_k11_probe_matches_jax(probe, hd):
    qkv = _qkv(1, 2, 70, 2, hd)
    want = _flash_qkv_fwd(jnp.asarray(qkv), 2, block_q=32, hpack=2, probe=probe)
    launches = fa.flash_qkv_self_attention_probe.launches
    got = fa.flash_qkv_self_attention_probe(torch.from_numpy(qkv), 2, probe)
    assert fa.flash_qkv_self_attention_probe.launches == launches  # the plain version on the CPU
    assert got[0].shape == (2, 70, 2 * hd) and got[1].shape == got[2].shape == (2, 2, 70)
    for name, g, w in zip("olm", got, want):
        if probe == "mxu" and name != "o":
            assert not g.any() and not np.asarray(w).any(), name  # l = m = 0
        else:
            assert _rel_l2(g.numpy(), w) <= REL_L2, (name, _rel_l2(g.numpy(), w))


# n 70: one 128-aligned chunk, whatever is asked (the TPU's bounds); n 300:
# two chunks ([0, 256), [256, 300)) and three ([0, 128), [128, 256), [256, 300))
@pytest.mark.parametrize("n,hd", [(70, 64), (70, 16), (300, 16)])
@pytest.mark.parametrize("chunks", [2, 3])
def test_k11_chunks_matches_jax_and_k1(chunks, n, hd):
    qkv = _qkv(2, 2, n, 2, hd)
    want = _flash_qkv_fwd(jnp.asarray(qkv), 2, block_q=32, hpack=2, chunks=chunks)
    got = fa.flash_qkv_self_attention_chunked(torch.from_numpy(qkv), 2, chunks)
    k1 = fa.flash_qkv_self_attention(torch.from_numpy(qkv), 2)
    for name, g, w, k in zip("olm", got, want, k1):
        if name == "l":  # a sum of up to n terms of order 1: against its own scale, as K7's tests hold it
            g, w, k = g / torch.from_numpy(np.array(w)), np.ones(g.shape, np.float32), g / k
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=ATOL, err_msg=name)
        np.testing.assert_allclose(g.numpy(), k.numpy() if name != "l" else np.ones(g.shape), rtol=0,
                                   atol=ATOL, err_msg=f"{name} against K1")
    assert len(fa.chunk_bounds(n, chunks)) - 1 == (1 if n == 70 else chunks)


# mxuprobe: nk 256 over 128-key blocks, so the TPU runs its multi-KV body (the
# probe's home); noexp and bf16exp: nk == block_k, so its single-KV body runs
# with no padded key (where a padded key would enter p as bf16(-0.7 FLT_MAX))
@pytest.mark.parametrize("variant,nk,hd", [("mxuprobe", 256, 48), ("mxuprobe", 200, 64), ("noexp", 128, 48),
                                           ("noexp", 128, 64), ("bf16exp", 128, 48), ("bf16exp", 128, 64)])
def test_k7_variant_matches_jax(variant, nk, hd):
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((2, 3, n, hd)).astype(np.float32) for n in (40, nk, nk))
    tpu_variant = {"mxuprobe": "v2_mxuprobe", "noexp": "v2_noexp", "bf16exp": "v2_bf16"}[variant]
    want = _flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=40, block_k=128,
                      variant=tpu_variant)
    launches = fa.flash_attention_head_major_variant.launches
    got = fa.flash_attention_head_major_variant(*(torch.from_numpy(x) for x in (q, k, v)), variant)
    assert fa.flash_attention_head_major_variant.launches == launches
    assert got[0].shape == (2, 3, 40, hd) and got[1].shape == got[2].shape == (2, 3, 40)
    for name, g, w in zip("olm", got, want):
        if variant == "mxuprobe" and name == "m":
            assert not g.any() and not np.asarray(w).any()  # m = 0
        else:
            assert _rel_l2(g.numpy(), w) <= REL_L2, (name, _rel_l2(g.numpy(), w))


def test_timing_modes_refuse_bad_arguments():
    qkv = torch.zeros(1, 8, 3 * 2 * 16)
    with pytest.raises(ValueError, match="probe"):
        fa.flash_qkv_self_attention_probe(qkv, 2, "nosoftmax")
    with pytest.raises(ValueError, match="chunks"):
        fa.flash_qkv_self_attention_chunked(qkv, 2, 0)
    q = torch.zeros(1, 2, 8, 16)
    with pytest.raises(ValueError, match="variant"):
        fa.flash_attention_head_major_variant(q, q, q, "v2_mxuprobe")
    with pytest.raises(RuntimeError, match="forward only"):
        fa.flash_attention_head_major_variant(q.requires_grad_(), q, q, "noexp")
