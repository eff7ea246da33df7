"""K12, the decoder backward's five matrix products without transcendentals
(the inline kernel of the TPU tool ``tools/lane_pad_probe.py``). The tool's
kernel is a closure inside its ``main`` and cannot be called, so this test
restates its body in ``jnp`` (highest precision, the same bf16 casts of pb
and dsb, its KV-block grid and q chunks, fp32 accumulation) at the tool's
``--cpu`` shapes and holds the port's plain version to it on the lanes the
geometry writes. Inputs come from a numpy seed, bf16."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crossscore_tpu_torch.ops import lane_pad_probe as lpp

# the tool's --cpu shapes: b 1, nq 64 (one q chunk), nk 2 x 128-key blocks
B, NQ_P, NK_P, BLOCK_K = 1, 64, 256, 128


def _jax_probe(qp, dop, kp, vp, hd_s, stride, c1=0.1442695):
    """The TPU body (``probe_kernel``) over its grid (b, KV blocks): dq
    accumulated in fp32 over the KV blocks, dk and dv per block, each output
    cast to bf16 once; the lanes outside the slices stay zero."""
    dq = jnp.zeros(qp.shape, jnp.float32)
    dk = jnp.zeros(kp.shape, kp.dtype)
    dv = jnp.zeros(vp.shape, vp.dtype)
    for j in range(1 if hd_s == 128 else 2):
        lane = slice(j * stride, j * stride + hd_s)
        q, do = qp[:, :, lane], dop[:, :, lane]
        for k0 in range(0, kp.shape[1], BLOCK_K):
            k, v = kp[:, k0:k0 + BLOCK_K, lane], vp[:, k0:k0 + BLOCK_K, lane]
            s = jnp.einsum("bqd,bkd->bqk", q, k, precision="highest", preferred_element_type=jnp.float32)
            dp = jnp.einsum("bqd,bkd->bqk", do, v, precision="highest", preferred_element_type=jnp.float32)
            pb = (s * c1).astype(k.dtype)
            dsb = (dp * c1).astype(k.dtype)
            dq = dq.at[:, :, lane].add(jnp.einsum("bqk,bkd->bqd", dsb, k, precision="highest",
                                                  preferred_element_type=jnp.float32))
            dk_c = jnp.einsum("bqk,bqd->bkd", dsb, q, precision="highest", preferred_element_type=jnp.float32)
            dv_c = jnp.einsum("bqk,bqd->bkd", pb, do, precision="highest", preferred_element_type=jnp.float32)
            dk = dk.at[:, k0:k0 + BLOCK_K, lane].set(dk_c.astype(dk.dtype))
            dv = dv.at[:, k0:k0 + BLOCK_K, lane].set(dv_c.astype(dv.dtype))
    return dq.astype(qp.dtype), dk, dv


@pytest.mark.parametrize("geometry", list(lpp.GEOMETRIES))
def test_k12_plain_matches_the_tool_body(geometry):
    assert lpp.probe_shapes(1, 1, cpu=True) == (NQ_P, NK_P)
    rng = np.random.default_rng(4)
    arrs = [rng.standard_normal((B, n, lpp.LANES)).astype(np.float32) for n in (NQ_P, NQ_P, NK_P, NK_P)]
    want = _jax_probe(*(jnp.asarray(a, jnp.bfloat16) for a in arrs), *lpp.GEOMETRIES[geometry])
    launches = lpp.lane_pad_probe.launches
    got = lpp.lane_pad_probe(*(torch.from_numpy(a).to(torch.bfloat16) for a in arrs), geometry)
    assert lpp.lane_pad_probe.launches == launches  # the plain version on the CPU
    lanes = np.concatenate([np.arange(lo, hi) for lo, hi in lpp.slices(geometry)])
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        g = g.float().numpy()[..., lanes]
        w = np.asarray(w.astype(jnp.float32))[..., lanes]
        # both take fp32 products and round pb and dsb to bf16: where the two
        # summation orders of s or dp straddle a bf16 rounding boundary, one
        # p moves by a bf16 ulp (2^-8 relative) and the outputs it feeds with
        # it. Held at the output's scale: every |d| within one bf16 ulp of the
        # largest output, and the relative L2 error (two seeds at the four
        # geometries read at most 8.1e-5)
        scale = np.abs(w).max()
        assert scale > 0 and np.abs(g - w).max() <= 2 ** -8 * scale, name
        assert np.linalg.norm(g - w) <= 2e-4 * np.linalg.norm(w), name


def test_k12_geometries_are_the_tools():
    assert lpp.probe_shapes(24, 5) == (1392, 7168)
    assert lpp.slices("hd48_nopad") == [(0, 48), (48, 96)]
    assert lpp.slices("hd48_off64") == [(0, 48), (64, 112)]
    assert lpp.slices("hd128_fused") == [(0, 128)]
    # the useful work at the bench point: hd 48 slices 0.232 ms and hd 64 / 128
    # 0.310 ms at 989 TFLOP/s
    assert lpp.useful_flops(24, 1392, 7168, "hd48_nopad") / 989e12 * 1e3 == pytest.approx(0.2324, abs=1e-4)
    assert lpp.useful_flops(24, 1392, 7168, "hd128_fused") / 989e12 * 1e3 == pytest.approx(0.3099, abs=1e-4)
    with pytest.raises(ValueError, match="geometry"):
        lpp.lane_pad_probe_plain(*(torch.zeros(1, 8, 128) for _ in range(4)), "hd32")
