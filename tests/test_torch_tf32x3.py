"""The fp32 attention forward's 3xTF32 arithmetic on the CPU: the split
(``tf32_split``) against a numpy bit-level reference, the pre-pass's tile
layout (``f32_kv_tiles_plain``) against the CUDA pre-pass's address
arithmetic, and a CPU emulation of the 3xTF32 attention against the JAX
package's K1 and K5 (Pallas in interpret mode) and the port's plain
versions, at ``chip_smoke.py``'s fp32 tolerances; one TF32 product instead of
three misses them. Inputs come from numpy seeds."""

import importlib.util
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crossscore_tpu.ops.flash_attention import _flash_qkv_fwd
from crossscore_tpu_torch.ops import flash_attention as fa

ROOT = Path(__file__).resolve().parent.parent


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_constants", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_CS = _chip_smoke()
# the card's fp32 bounds, unchanged from the CUDA-core kernel's: max |d| /
# (1 + |plain|) and the relative L2 of each of o, l, m
TOL, TOL_L2 = _CS.TOL["float32"], _CS.TOL_L2["float32"]


# --- the split ---------------------------------------------------------------


def _np_rna(x: np.ndarray) -> np.ndarray:
    """numpy reference of cvt.rna.tf32.f32: the fp32 bits' magnitude rounded
    at bit 13, half away from zero; non-finite values as they are."""
    bits = x.astype(np.float32).view(np.uint32).astype(np.uint64)
    finite = (bits & 0x7F800000) != 0x7F800000
    sign, mag = bits & 0x80000000, bits & 0x7FFFFFFF
    rounded = sign | (((mag + 0x1000) >> 13) << 13)
    return np.where(finite, rounded, bits).astype(np.uint32).view(np.float32)


def _values(case: str) -> np.ndarray:
    rng = np.random.default_rng(7)
    if case == "random":  # magnitudes over 2^-100 .. 2^100, both signs
        return (rng.standard_normal(4096) * np.exp2(rng.uniform(-100, 100, 4096))).astype(np.float32)
    if case == "ties":  # the dropped 13 bits exactly half: ties, which go away from zero (|x| >= 2^-103,
        # where lo stays a normal number: TF32 has fp32's exponent range, so a subnormal lo rounds coarser)
        bits = (rng.integers(0x0C000000, 0x7F000000, 2048, dtype=np.uint64) & ~np.uint64(0x1FFF)) | 0x1000
        bits = np.concatenate([bits, bits | 0x80000000])
        return bits.astype(np.uint32).view(np.float32)
    if case == "zeros":
        return np.array([0.0, -0.0], np.float32)
    if case == "subnormals":
        bits = rng.integers(1, 0x00800000, 1024, dtype=np.uint64)
        return np.concatenate([bits, bits | 0x80000000]).astype(np.uint32).view(np.float32)
    if case == "infinities":
        return np.array([np.inf, -np.inf], np.float32)
    return np.array([np.nan, -np.nan], np.float32)


@pytest.mark.parametrize("case", ["random", "ties", "zeros", "subnormals", "infinities", "nan"])
def test_tf32_split_matches_the_bit_reference(case):
    x = _values(case)
    hi, lo = (t.numpy() for t in fa.tf32_split(torch.from_numpy(x)))
    want_hi = _np_rna(x)
    np.testing.assert_array_equal(hi.view(np.uint32), want_hi.view(np.uint32))
    finite = np.isfinite(want_hi)
    with np.errstate(invalid="ignore"):  # inf - inf, not taken
        want_lo = np.where(finite, _np_rna(np.where(finite, x - want_hi, 0).astype(np.float32)), 0)
    np.testing.assert_array_equal(lo.view(np.uint32), want_lo.view(np.uint32))
    for t in (hi, lo):  # at most 10 mantissa bits: the low 13 of a finite value are zero
        assert not np.any(t[np.isfinite(t)].view(np.uint32) & 0x1FFF)
    if case == "ties":
        away = np.abs(hi.astype(np.float64)) > np.abs(x.astype(np.float64))
        assert away.all()
    if case in ("random", "ties", "zeros"):
        err = np.abs(x.astype(np.float64) - hi.astype(np.float64) - lo.astype(np.float64))
        assert np.all(err <= 2.0 ** -22 * np.abs(x.astype(np.float64)))
    if case == "subnormals":  # rounded on the same grid as normal values: within 2^12 subnormal ulps
        err = np.abs(x.astype(np.float64) - hi.astype(np.float64) - lo.astype(np.float64))
        assert np.all(err <= 2.0 ** 12 * 2.0 ** -149) and np.all(np.isfinite(hi) & np.isfinite(lo))
    if case == "zeros":
        assert np.all(hi == 0) and np.all(lo == 0)
    if case == "infinities":
        np.testing.assert_array_equal(hi, x)
        assert np.all(lo == 0)
    if case == "nan":
        assert np.all(np.isnan(hi)) and np.all(lo == 0)


# --- the pre-pass's layout ---------------------------------------------------


def _prepass_reference(k: np.ndarray, v: np.ndarray, block_k: int) -> np.ndarray:
    """The CUDA pre-pass (``attn_fwd_split_kv``) transcribed: each 16-byte
    chunk of a tile from its byte offset, as the kernel computes it."""
    b, h, nk, hd = k.shape
    cb, nt = -(-hd // 32), -(-nk // block_k)
    kt, vt = cb * block_k * 128, hd * block_k * 4
    tile = 2 * kt + 2 * vt
    out = np.zeros((b, h, nt, tile // 4), np.float32)
    kp = np.zeros((b, h, nt * block_k, hd), np.float32)
    vp = np.zeros_like(kp)
    kp[:, :, :nk], vp[:, :, :nk] = k, v
    pair = [0, 2, 4, 6, 1, 3, 5, 7]
    for t in range(nt):
        sk, sv = kp[:, :, t * block_k:(t + 1) * block_k], vp[:, :, t * block_k:(t + 1) * block_k]
        for i in range(tile // 16):
            byte = 16 * i
            if byte < 2 * kt:
                low = byte >= kt
                o = byte - (kt if low else 0)
                blk, r, ch = o // (block_k * 128), (o // 128) % block_k, (o // 16) % 8
                c0 = blk * 32 + ((ch ^ (r & 7)) << 2)
                x = sk[:, :, r, c0:c0 + 4] if c0 < hd else np.zeros((b, h, 4), np.float32)
            else:
                ov = byte - 2 * kt
                low = ov >= vt
                o = ov - (vt if low else 0)
                blk, n, ch = o // (hd * 128), (o // 128) % hd, (o // 16) % 8
                p0 = (ch ^ (n & 7)) << 2
                keys = [blk * 32 + ((p0 + e) & ~7) + pair[(p0 + e) & 7] for e in range(4)]
                x = sv[:, :, keys, n]
            hi, lo = (a.numpy() for a in fa.tf32_split(torch.from_numpy(np.ascontiguousarray(x))))
            out[:, :, t, 4 * i:4 * i + 4] = lo if low else hi
    return out


@pytest.mark.parametrize("hd,block_k,nk", [(16, 64, 70), (48, 64, 64), (64, 64, 129), (96, 32, 33), (128, 32, 40)])
def test_kv_tiles_plain_matches_the_prepass_arithmetic(hd, block_k, nk):
    rng = np.random.default_rng(hd + nk)
    k, v = (rng.standard_normal((2, 3, nk, hd)).astype(np.float32) for _ in range(2))
    got = fa.f32_kv_tiles_plain(torch.from_numpy(k), torch.from_numpy(v), block_k).numpy()
    want = _prepass_reference(k, v, block_k)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_pair_keys_follow_the_tf32_a_registers():
    """A tf32 k8 step's A registers hold columns q and q + 4 (wgmma's
    fragment); the body fills them from the accumulators of columns 2q and 2q
    + 1, so column c takes key 2c (c < 4) or 2(c - 4) + 1."""
    assert fa.TF32_PAIR_KEYS == tuple(2 * c if c < 4 else 2 * (c - 4) + 1 for c in range(8))
    assert sorted(fa.TF32_PAIR_KEYS) == list(range(8))


# --- the 3xTF32 attention, emulated ------------------------------------------


def _mm(a: torch.Tensor, b: torch.Tensor, products: int) -> torch.Tensor:
    """a @ b as the body computes it: each fp32 operand split into TF32 hi
    and lo and lo b_hi + a_hi lo + hi hi accumulated in fp32 (products=3), or
    the single TF32 product hi hi (products=1). Each product of two TF32
    values is exact in fp32, so the fp32 matmul adds only the accumulation's
    rounding."""
    a_hi, a_lo = fa.tf32_split(a)
    b_hi, b_lo = fa.tf32_split(b)
    if products == 1:
        return a_hi @ b_hi
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def _attention_tf32(q, k, v, kv_bias=None, products: int = 3):
    """The body's function on head-major (B, H, N, hd) fp32: scores and P V
    in 3xTF32 (or one TF32 product), the softmax in fp32 with exp2 and the
    scale folded in -> (o, l, m) in the port's convention."""
    c1 = fa.LOG2E / math.sqrt(q.shape[-1])
    t = _mm(q, k.transpose(-1, -2), products) * c1
    if kv_bias is not None:
        t = t + (kv_bias[:, None, None, :] if kv_bias.ndim == 2 else kv_bias) * fa.LOG2E
    m = t.amax(-1, keepdim=True)
    p = torch.exp2(t - m)
    l = p.sum(-1, keepdim=True)
    o = _mm(p, v, products) / l
    return o, l[..., 0], m[..., 0] / fa.LOG2E


def _errs(got, want) -> tuple[float, float]:
    """(max |d| / (1 + |want|), the largest relative L2) over (o, l, m)."""
    tol = max(float(((g.double() - w.double()).abs() / (1 + w.double().abs())).max()) for g, w in zip(got, want))
    l2 = max(float((g.double() - w.double()).norm() / w.double().norm()) for g, w in zip(got, want))
    return tol, l2


def _bias(rng, b: int, n: int, form: str) -> np.ndarray:
    """A bucket mask (0 / -1e30, a fifth masked) plus a small random part:
    (B, N) per item or (N,) shared."""
    mask = np.where(rng.random((b, n)) < 0.2, -1e30, 0.0)
    mask[:, 0] = 0.0
    bias = (mask + rng.standard_normal((b, n))).astype(np.float32)
    return bias if form == "item" else bias[1]


def _qkv_case(hd: int, n: int, form: str | None):
    rng = np.random.default_rng(hd * 1000 + n)
    b, h = 2, 2  # two heads fill the JAX kernel's lane block
    qkv = rng.standard_normal((b, n, 3 * h * hd)).astype(np.float32)
    return qkv, h, None if form is None else _bias(rng, b, n, form)


def _emulated_k1(qkv: np.ndarray, h: int, bias, products: int = 3):
    q, k, v = fa.qkv_head_views(torch.from_numpy(qkv), h)
    o, l, m = _attention_tf32(q, k, v, None if bias is None else torch.from_numpy(bias), products)
    return fa._merge_heads(o), l, m


K1_CASES = [(16, 70, None), (48, 37, None), (64, 130, None), (128, 45, None), (64, 37, "item"), (64, 130, "shared"),
            (48, 70, "item")]


@pytest.mark.parametrize("hd,n,form", K1_CASES)
def test_emulated_3xtf32_matches_jax_and_the_plain_version(hd, n, form):
    qkv, h, bias = _qkv_case(hd, n, form)
    got = _emulated_k1(qkv, h, bias)
    jax_out = _flash_qkv_fwd(jnp.asarray(qkv), h, kv_bias=None if bias is None else jnp.asarray(bias))
    want_jax = [torch.from_numpy(np.array(t)).reshape(g.shape) for t, g in zip(jax_out, got)]
    qkv_t = torch.from_numpy(qkv)
    want_plain = (fa.flash_qkv_self_attention_plain(qkv_t, h) if bias is None
                  else fa.flash_qkv_self_attention_masked_plain(qkv_t, torch.from_numpy(bias), h))
    for want in (want_jax, want_plain):
        tol, l2 = _errs(got, want)
        assert tol <= TOL and l2 <= TOL_L2, (tol, l2)


@pytest.mark.parametrize("hd,nq,nk,form", [(16, 40, 300, None), (48, 63, 257, "item"), (96, 65, 129, "shared"),
                                           (128, 1, 65, None)])
def test_emulated_3xtf32_cross_matches_the_plain_version(hd, nq, nk, form):
    """K3, K6 and K7's shapes (ragged Nq and Nk) against the port's plain
    version of K7, which K3 and K6 share."""
    rng = np.random.default_rng(hd + nq + nk)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 3, n, hd)).astype(np.float32)) for n in (nq, nk, nk))
    bias = None if form is None else torch.from_numpy(_bias(rng, 2, nk, form))
    got = _attention_tf32(q, k, v, bias)
    if bias is not None and bias.ndim == 2:  # K6's per-item row, through the plain K3/K6
        tm = [fa._merge_heads(t) for t in (q, k, v)]
        o, l, m = fa.flash_cross_attention_masked_plain(*tm, bias, 3)
        want = (fa._split_heads(o, 3), l, m)
    else:
        want = fa.flash_attention_head_major_plain(q, k, v, bias)
    tol, l2 = _errs(got, want)
    assert tol <= TOL and l2 <= TOL_L2, (tol, l2)


@pytest.mark.parametrize("hd,n,form", [(64, 130, None), (64, 37, "item")])
def test_one_tf32_product_misses_the_fp32_bound(hd, n, form):
    """The split is what keeps fp32's error: with one TF32 product for each
    of S and P V, the same inputs read above the fp32 relative L2 bound."""
    qkv, h, bias = _qkv_case(hd, n, form)
    qkv_t = torch.from_numpy(qkv)
    want = (fa.flash_qkv_self_attention_plain(qkv_t, h) if bias is None
            else fa.flash_qkv_self_attention_masked_plain(qkv_t, torch.from_numpy(bias), h))
    assert _errs(_emulated_k1(qkv, h, bias, products=3), want)[1] <= TOL_L2
    assert _errs(_emulated_k1(qkv, h, bias, products=1), want)[1] > TOL_L2
