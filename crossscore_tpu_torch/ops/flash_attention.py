"""Flash-attention forwards K1 and K3, their masked forms K5 and K6, the
head-major forward K7, the decoder backward K4 and the head-major backward
K8/K9; counterpart of ``crossscore_tpu/ops/flash_attention.py``
(``_flash_qkv_fwd``, ``_flash_cross_ln_fwd``, each with and without
``kv_bias``, ``_flash_fwd``, ``_bwd_cross_ln_pallas``, ``_bwd_pallas_single``
and ``_bwd_pallas_multi``). Also the timing instruments K11 (``_flash_qkv_fwd``
with ``probe`` or ``chunks``) and K7' (``_flash_fwd``'s ``v2_mxuprobe``,
``v2_noexp`` and ``v2_bf16`` variants), which no model path calls: the
probes compute wrong math on purpose, to time the passes they keep.

The forwards return ``(o, l, m)`` in the JAX package's convention: ``o``
token-major (B, Nq, H*hd) (K7: head-major (B, H, Nq, hd)), ``l`` and ``m``
(B, H, Nq) fp32, ``m`` the row max of the scaled logits in natural units and
``l`` = sum(exp(scaled - m)).
:func:`flash_cross_attention_ln` is the differentiable decoder attention
(forward K3, backward K4), the counterpart of the JAX ``custom_vjp``
``flash_cross_attention_ln``; :func:`head_major_flash_attention` is the
differentiable head-major attention (forward K7, backward K8 up to 2048 KV
tokens, K9 beyond), the counterpart of the JAX ``custom_vjp``
``flash_cross_attention``. K5 and K6 (shape-bucketed inference) are forward
only, as in the JAX package: they raise on an input that requires grad.

On a CUDA tensor each wrapper launches its kernel (``csrc/flash_qkv.cu`` (K1,
K5), ``csrc/flash_cross.cu`` (K3, K6, K7), ``csrc/attention_modes.cu`` (K11,
K7'), ``csrc/flash_cross_bwd.cu`` (K4, K8, K9)) or raises; on a CPU tensor
it runs the plain PyTorch version beside it. Each wrapper counts its kernel launches in ``.launches`` (K11 and
K7' also per mode, in ``.launches_by_mode``).

fp32 operands take the 3xTF32 body on the tensor cores
(``csrc/attention_fwd_f32.cuh``, in the K1/K5 and K3/K6/K7 libraries): a
pre-pass splits k and v into TF32 (hi, lo) pairs in the body's tile layout
(:func:`f32_kv_tiles_plain` is its plain version) in a scratch the wrapper
allocates, then the body runs every product as three TF32 products
(:func:`tf32_split`). A wrapper call counts one launch for the two kernels.

The kernels take head dims that are multiples of 16 up to 128. The
decoder's wrappers (K3, K4, K6, K7, K8/K9) also take hd 8, the decoder's at
the ``dinov2-test`` preset (width 64, 8 heads), through
:func:`narrow_head_route`, which zero-pads each head to 16 lanes, launches
the hd 16 body at the true scale 1/sqrt(8) and slices the outputs back, as
the TPU kernels compute hd 8 beside zero lanes. The backbone's K1, K5 and
K11 refuse hd 8: no backbone preset has it (``dinov2-test`` has hd 16).
"""

from __future__ import annotations

import ctypes
import math
import types

import torch
import torch.nn.functional as F

from crossscore_tpu_torch.ops import _build
from crossscore_tpu_torch.ops.attention import attention_with_stats

_P = ctypes.c_void_p
_I = ctypes.c_int
LOG2E = 1.4426950408889634


def _split_heads(x: torch.Tensor, h: int) -> torch.Tensor:
    b, n, d = x.shape
    return x.reshape(b, n, h, d // h).permute(0, 2, 1, 3)  # (B, H, N, hd)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, n, hd = x.shape
    return x.permute(0, 2, 1, 3).reshape(b, n, h * hd)


# hd 8 runs on the hd 16 bodies beside zero lanes (narrow_head_route), at
# the true head dim's softmax scale
NARROW_HEAD_DIM, NARROW_PADDED = 8, 16
NARROW_SCALE = 1.0 / math.sqrt(NARROW_HEAD_DIM)


def _check_head_dim(what: str, hd: int, narrow: bool = True) -> None:
    """A multiple of 16 up to 128, or hd 8 where the wrapper takes the
    narrow route (``narrow``)."""
    if not (narrow and hd == NARROW_HEAD_DIM) and (hd % 16 or not 16 <= hd <= 128):
        raise ValueError(
            f"{what}: head dim {hd} is not supported by the CUDA kernel "
            f"({f'{NARROW_HEAD_DIM}, or ' if narrow else ''}a multiple of 16 up to 128)"
        )


def pad_head_dim(x: torch.Tensor) -> torch.Tensor:
    """Zero-pad every 8-lane head slice of the last axis to 16 lanes:
    token-major (B, N, n*8) -> (B, N, n*16) (a fused qkv included) or
    head-major (B, H, N, 8) -> (B, H, N, 16), contiguous."""
    *lead, d = x.shape
    w = NARROW_HEAD_DIM
    return F.pad(x.reshape(*lead, d // w, w), (0, NARROW_PADDED - w)).reshape(*lead, d * NARROW_PADDED // w)


def unpad_head_dim(x: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`pad_head_dim`: the first 8 lanes of every
    16-lane head slice, as a contiguous tensor."""
    *lead, d = x.shape
    w = NARROW_PADDED
    return x.reshape(*lead, d // w, w)[..., :NARROW_HEAD_DIM].reshape(*lead, d * NARROW_HEAD_DIM // w).contiguous()


def narrow_head_route(launch, operands, n_sliced: int):
    """hd 8 on the hd 16 kernels: ``launch(*padded, scale=NARROW_SCALE)``
    on each operand zero-padded by :func:`pad_head_dim`, then the first
    ``n_sliced`` outputs sliced back to 8 lanes (o; or dq, dk, dv), the rest
    (l, m) as they come. Zero q and k lanes add nothing to q k^T and zero v
    lanes give zero o lanes, so o, l and m are hd 8's at the true scale. In
    the backward the zero lanes of q, k, o and do give zero dq, dk and dv
    lanes and leave delta = rowsum(do o) as it is. Head-major outputs come
    back contiguous. ``launch`` is a kernel's launcher, or on the CPU a
    plain version at the padded width, which the tests put in its place."""
    out = launch(*(pad_head_dim(t) for t in operands), scale=NARROW_SCALE)
    return tuple(unpad_head_dim(t) for t in out[:n_sliced]) + tuple(out[n_sliced:])


def _check_grid(what: str, b: int, num_heads: int) -> None:
    if b > 65535 or num_heads > 65535:
        raise ValueError(f"{what}: batch and heads must be < 65536")


def _check_bias(what: str, kv_bias: torch.Tensor, b: int, nk: int, *tensors) -> None:
    """Raise unless ``kv_bias`` is a float32 (Nk,) or (B, Nk) bias and no
    operand requires grad (the masked kernels are forward only)."""
    if kv_bias.dtype != torch.float32 or kv_bias.shape not in ((nk,), (b, nk)):
        raise ValueError(f"{what}: kv_bias must be float32 ({nk},) or ({b}, {nk}), "
                         f"got {kv_bias.dtype} {tuple(kv_bias.shape)}")
    if any(t.requires_grad for t in (kv_bias, *tensors)):
        raise RuntimeError(f"{what} is forward only (shape-bucketed inference); "
                           "an input requires grad")


def _bias_args(what: str, kv_bias, device) -> tuple[list, tuple]:
    """The masked entry points' extra C arguments: the bias pointer and its
    batch stride in elements (0 for the shared row); none without a bias."""
    if kv_bias is None:
        return [], ()
    if kv_bias.device != device or not kv_bias.is_contiguous():
        raise ValueError(f"{what}: kv_bias must be a contiguous tensor on {device}")
    return [_P, ctypes.c_longlong], (kv_bias.data_ptr(), kv_bias.shape[-1] if kv_bias.ndim == 2 else 0)


# --- fp32: the 3xTF32 body's split and tiles ---------------------------------

TF32_DROPPED = 13  # mantissa bits a TF32 container drops of fp32's 23
# the key (0-7 of a k8 step) that the body's P registers take at column c
# (``tf32_pair_key``): columns q and q + 4 come from the accumulator pair 2q, 2q + 1
TF32_PAIR_KEYS = (0, 2, 4, 6, 1, 3, 5, 7)


def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32 (10 mantissa bits), nearest with ties away from
    zero, by integer operations on the bits, as ``cvt.rna.tf32.f32`` rounds:
    half the dropped bits' range added to the magnitude, then those bits
    cleared (a finite value past the largest TF32 one becomes inf). Non-finite
    values are returned as they are."""
    bits = x.contiguous().view(torch.int32)
    half, keep = 1 << (TF32_DROPPED - 1), ~((1 << TF32_DROPPED) - 1)
    finite = (bits & 0x7F800000) != 0x7F800000
    return torch.where(finite, (bits + half) & keep, bits).view(torch.float32)


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x (fp32) -> (hi, lo), the 3xTF32 body's split: hi = rna_tf32(x), lo =
    rna_tf32(x - hi), each with at most 10 mantissa bits, and x - hi - lo
    within 2^-22 |x|; lo = 0 where hi is not finite. Bit for bit what the
    body computes (``tf32_split`` in ``csrc/attention_fwd_f32.cuh``)."""
    x = x.float()
    hi = _tf32_rna(x)
    return hi, torch.where(torch.isfinite(hi), _tf32_rna(x - hi), torch.zeros_like(x))


def _swizzle128(t: torch.Tensor) -> torch.Tensor:
    """Rows of 32 fp32 values (128 bytes) laid out as a 128-byte swizzled
    shared-memory tile: the 16-byte chunk c of row r holds the row's chunk
    c ^ (r % 8)."""
    rows = t.shape[-2]
    r = torch.arange(rows, device=t.device)[:, None]
    c = torch.arange(32, device=t.device)[None, :]
    idx = (((c // 4) ^ (r % 8)) * 4 + c % 4).expand(t.shape)
    return torch.gather(t, -1, idx)


def f32_kv_tiles_plain(k: torch.Tensor, v: torch.Tensor, block_k: int) -> torch.Tensor:
    """Plain version of the fp32 pre-pass: k, v (B, H, Nk, hd) -> (B, H,
    ceil(Nk / block_k), tile floats), each KV tile one stage of the body's
    ring: [K hi | K lo | Vt hi | Vt lo]. K's rows are hd padded to 32-column
    blocks, stored as [blocks][block_k rows][32]; Vt is V transposed, block_k
    / 32 blocks of [hd rows][32 keys], the keys of each 8 in the order
    ``TF32_PAIR_KEYS``; every 32-value row 128-byte swizzled, rows past Nk
    and the padding zero."""
    b, h, nk, hd = k.shape
    cb, nt = -(-hd // 32), -(-nk // block_k)
    pad = nt * block_k - nk
    kp = F.pad(k.float(), (0, 32 * cb - hd, 0, pad)).reshape(b, h, nt, block_k, cb, 32).transpose(3, 4)
    order = torch.tensor([8 * (p // 8) + TF32_PAIR_KEYS[p % 8] for p in range(32)], device=v.device)
    vp = F.pad(v.float(), (0, 0, 0, pad)).reshape(b, h, nt, block_k // 32, 32, hd)[..., order, :]
    parts = [*tf32_split(_swizzle128(kp)), *tf32_split(_swizzle128(vp.transpose(-1, -2)))]
    return torch.cat([t.reshape(b, h, nt, -1) for t in parts], -1)


F32_PLAN_FIELDS = ("rows", "block_k", "stages", "smem_bytes", "tile_bytes", "consumer_warpgroups")


def f32_plan(lib: ctypes.CDLL, hd: int) -> dict:
    """The fp32 body's tile plan at head dim ``hd`` (``cs_attention_f32_plan``)."""
    fn = lib.cs_attention_f32_plan
    fn.argtypes, fn.restype = [_I, _P], _I
    out = (ctypes.c_int * len(F32_PLAN_FIELDS))()
    _build.check_rc(lib, fn(hd, ctypes.addressof(out)), f"the fp32 plan at hd {hd}")
    return dict(zip(F32_PLAN_FIELDS, out))


def f32_split_kv(lib: ctypes.CDLL, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The fp32 pre-pass on CUDA tensors: k, v (B, H, Nk, hd) views with hd
    contiguous -> the body's stages, (B, H, ceil(Nk / BK), tile floats) fp32
    (:func:`f32_kv_tiles_plain`'s layout)."""
    b, h, nk, hd = k.shape
    plan = f32_plan(lib, hd)
    tiles = torch.empty(b, h, -(-nk // plan["block_k"]), plan["tile_bytes"] // 4, dtype=torch.float32,
                        device=k.device)
    fn = lib.cs_attention_f32_split_kv
    fn.argtypes, fn.restype = [_P, _P, _P, _P, _I, _I, _I, _I, _P], _I
    strides = (ctypes.c_longlong * 6)(*k.stride()[:3], *v.stride()[:3])
    rc = fn(k.data_ptr(), v.data_ptr(), ctypes.addressof(strides), tiles.data_ptr(), b, h, nk, hd,
            torch.cuda.current_stream(k.device).cuda_stream)
    _build.check_rc(lib, rc, "the fp32 pre-pass")
    return tiles


def f32_forward(lib: ctypes.CDLL, q: torch.Tensor, tiles: torch.Tensor, nk: int, o: torch.Tensor, kv_bias,
                scale: float, what: str) -> tuple[torch.Tensor, torch.Tensor]:
    """The fp32 body on CUDA tensors: q and o (B, H, Nq, hd) views with hd
    contiguous (o written in place), ``tiles`` from :func:`f32_split_kv` over
    ``nk`` keys, ``kv_bias`` None, (Nk,) or (B, Nk) -> (l, m)."""
    b, h, nq, hd = q.shape
    l = torch.empty(b, h, nq, dtype=torch.float32, device=q.device)
    m = torch.empty_like(l)
    bias_ptr, bias_bs = _bias_args(what, kv_bias, q.device)[1] or (None, 0)
    fn = lib.cs_attention_f32_fwd
    fn.argtypes = [_P, _P, _P, _P, ctypes.c_longlong, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _P]
    fn.restype = _I
    strides = (ctypes.c_longlong * 6)(*q.stride()[:3], *o.stride()[:3])
    rc = fn(q.data_ptr(), tiles.data_ptr(), ctypes.addressof(strides), bias_ptr, bias_bs, o.data_ptr(), l.data_ptr(),
            m.data_ptr(), b, h, nq, nk, hd, scale, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check_rc(lib, rc, what)
    return l, m


def _launch_f32(what: str, source: str, q, k, v, o, kv_bias, scale: float):
    """fp32 on the 3xTF32 body: the pre-pass, then the body, from library
    ``source``; q, k, v, o (B, H, N, hd) views with hd contiguous, rows
    16-byte aligned (the wrappers' checks) -> (l, m), o written."""
    _bias_args(what, kv_bias, q.device)  # a bias the body cannot take raises before the pre-pass runs
    lib = _build.load(source)
    return f32_forward(lib, q, f32_split_kv(lib, k, v), k.shape[2], o, kv_bias, scale, what)


# --- K1 and K5: the backbone self-attention, unmasked and masked -------------


def _check_qkv(qkv: torch.Tensor, num_heads: int) -> None:
    if qkv.ndim != 3 or qkv.shape[2] % (3 * num_heads):
        raise ValueError(f"qkv must be (B, N, 3*H*hd) with H={num_heads}, got {tuple(qkv.shape)}")


def _launch_qkv(what: str, qkv: torch.Tensor, num_heads: int, kv_bias=None):
    """Launch K1, or K5 with ``kv_bias``, on CUDA tensors -> (o, l, m)."""
    b, n, d3 = qkv.shape
    d = d3 // 3
    hd = d // num_heads
    _build.check_cuda_operands(what, qkv)
    _check_head_dim(what, hd, narrow=False)
    _check_grid(what, b, num_heads)
    if qkv.dtype == torch.float32:
        o = torch.empty(b, n, d, dtype=qkv.dtype, device=qkv.device)
        l, m = _launch_f32(what, "flash_qkv", *qkv_head_views(qkv, num_heads), _split_heads(o, num_heads),
                           kv_bias, 1.0 / math.sqrt(hd))
        return o, l, m
    bias_types, bias_args = _bias_args(what, kv_bias, qkv.device)
    lib = _build.load("flash_qkv")
    fn = lib.cs_flash_qkv_self_attention if kv_bias is None else lib.cs_flash_qkv_self_attention_masked
    fn.argtypes = [_P, *bias_types, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _P]
    fn.restype = _I
    o = torch.empty(b, n, d, dtype=qkv.dtype, device=qkv.device)
    l = torch.empty(b, num_heads, n, dtype=torch.float32, device=qkv.device)
    m = torch.empty_like(l)
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    rc = fn(qkv.data_ptr(), *bias_args, o.data_ptr(), l.data_ptr(), m.data_ptr(), b, n, num_heads, hd,
            _build.DTYPE_CODES[str(qkv.dtype)], 1.0 / math.sqrt(hd), stream)
    _build.check_rc(lib, rc, what)
    return o, l, m


def qkv_head_views(qkv: torch.Tensor, num_heads: int) -> list[torch.Tensor]:
    """The q, k and v sections of a fused (B, N, 3*H*hd) projection (column
    offsets 0, D and 2D) as head-major (B, H, N, hd) views: what the tensor
    maps of K1, K5 and K11 read in place. The launch needs no check of them
    beyond ``check_cuda_operands`` and the head dim: a contiguous 16-byte
    aligned projection with hd a multiple of 16 meets every condition of
    :func:`tma_strides` (tests/test_torch_fwd_plan.py), as K3's and K6's
    token-major operands do."""
    d = qkv.shape[2] // 3
    return [_split_heads(qkv[..., i * d:(i + 1) * d], num_heads) for i in range(3)]


def flash_qkv_self_attention_plain(qkv: torch.Tensor, num_heads: int, kv_bias=None):
    """Plain version of K1 (and of K5 with ``kv_bias``): split the fused
    projection, attend, re-pack."""
    o, _, l, m = attention_with_stats(*qkv_head_views(qkv, num_heads), kv_bias)
    return _merge_heads(o), l, m


def flash_qkv_self_attention(qkv: torch.Tensor, num_heads: int):
    """Self-attention straight off the fused projection: qkv (B, N, 3*H*hd)
    -> (o (B, N, H*hd), l, m (B, H, N))."""
    _check_qkv(qkv, num_heads)
    if _build.device_type(qkv) == "cpu":
        return flash_qkv_self_attention_plain(qkv, num_heads)
    out = _launch_qkv("flash_qkv_self_attention", qkv, num_heads)
    flash_qkv_self_attention.launches += 1
    return out


flash_qkv_self_attention.launches = 0


def flash_qkv_self_attention_masked_plain(qkv: torch.Tensor, kv_bias: torch.Tensor, num_heads: int):
    """Plain version of K5: K1's with the bias added to the scaled logits."""
    return flash_qkv_self_attention_plain(qkv, num_heads, kv_bias)


def flash_qkv_self_attention_masked(qkv: torch.Tensor, kv_bias: torch.Tensor, num_heads: int):
    """K1 with an additive KV-token bias (forward only): qkv (B, N, 3*H*hd),
    kv_bias (N,) or (B, N) fp32 in natural units -> (o (B, N, H*hd), l, m
    (B, H, N)), ``m`` including the bias."""
    what = "flash_qkv_self_attention_masked"
    _check_qkv(qkv, num_heads)
    _check_bias(what, kv_bias, qkv.shape[0], qkv.shape[1], qkv)
    if _build.device_type(qkv) == "cpu":
        return flash_qkv_self_attention_masked_plain(qkv, kv_bias, num_heads)
    out = _launch_qkv(what, qkv, num_heads, kv_bias)
    flash_qkv_self_attention_masked.launches += 1
    return out


flash_qkv_self_attention_masked.launches = 0


# --- K11: K1's timing probes and its chunked schedule -----------------------

# the C codes of the probes and of the head-major variants (csrc/attention_fwd.cuh)
QKV_PROBES = {"nomax": 1, "nosum": 2, "mxu": 3}
HEAD_MAJOR_VARIANTS = {"mxuprobe": 5, "noexp": 6, "bf16exp": 7}
# the head dims of the timing modes' CUDA kernels: the microbenchmark's
# backbone (64) and decoder (48) shapes, and the ViT-L decoder's (128)
TIMING_HEAD_DIMS = (48, 64, 128)
BF16_LN2 = 0.69140625  # ln 2 rounded to bf16, the factor of JAX's bf16 exp2


def _check_timing(what: str, dtype: torch.dtype, hd: int, *tensors) -> None:
    """The timing modes' CUDA kernels: bf16, hd 48, 64 or 128, forward only."""
    if dtype != torch.bfloat16 or hd not in TIMING_HEAD_DIMS:
        raise ValueError(f"{what}: the CUDA kernel takes bfloat16 at head dim 48, 64 or 128, got {dtype}, hd {hd}")
    if any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{what} is a forward-only timing instrument; an input requires grad")


def _qkv_heads_f32(qkv: torch.Tensor, num_heads: int):
    """q, k, v (B, H, N, hd) in fp32 from the fused projection."""
    return (t.float() for t in qkv_head_views(qkv, num_heads))


def flash_qkv_self_attention_probe_plain(qkv: torch.Tensor, num_heads: int, probe: str):
    """Plain version of K11's probes, the TPU body ``_fwd_kernel_qkv_probe``
    step by step: fp32 scores, p rounded to qkv's dtype, fp32 products.
    "nomax": p = exp2(s c1 - 8), l = sum p, o / l, m = l * scale; "nosum":
    m = rowmax(s), p = exp2((s - m) c1), o / m, l = m, m * scale; "mxu":
    p = s, o unnormalised, l = m = 0 (c1 = scale * log2(e))."""
    if probe not in QKV_PROBES:
        raise ValueError(f"probe must be one of {sorted(QKV_PROBES)}, got {probe!r}")
    dt = qkv.dtype
    q, k, v = _qkv_heads_f32(qkv, num_heads)
    scale = 1.0 / math.sqrt(q.shape[-1])
    c1 = scale * LOG2E
    s = torch.matmul(q, k.transpose(-1, -2))
    if probe == "mxu":
        o = torch.matmul(s.to(dt).float(), v)
        l = torch.zeros(s.shape[:-1], dtype=torch.float32, device=qkv.device)
        m = torch.zeros_like(l)
    else:
        if probe == "nomax":
            p = torch.exp2(s * c1 - 8.0).to(dt).float()
            l = m = p.sum(-1)
        else:
            m = s.amax(-1)
            p = torch.exp2((s - m[..., None]) * c1).to(dt).float()
            l = m
        o = torch.matmul(p, v) * torch.where(l == 0, torch.ones_like(l), 1.0 / l)[..., None]
        m = m * scale
    return _merge_heads(o.to(dt)), l, m


def flash_qkv_self_attention_probe(qkv: torch.Tensor, num_heads: int, probe: str):
    """K11's probe ``probe`` ("nomax", "nosum" or "mxu"; wrong math on
    purpose, see the plain version) off the fused projection: qkv (B, N,
    3*H*hd) -> (o (B, N, H*hd), l, m (B, H, N)). A timing instrument only."""
    what = "flash_qkv_self_attention_probe"
    _check_qkv(qkv, num_heads)
    if probe not in QKV_PROBES:
        raise ValueError(f"{what}: probe must be one of {sorted(QKV_PROBES)}, got {probe!r}")
    if _build.device_type(qkv) == "cpu":
        return flash_qkv_self_attention_probe_plain(qkv, num_heads, probe)
    b, n, d3 = qkv.shape
    hd = d3 // 3 // num_heads
    _build.check_cuda_operands(what, qkv)
    _check_timing(what, qkv.dtype, hd, qkv)
    _check_grid(what, b, num_heads)
    lib = _build.load("attention_modes")
    fn = lib.cs_flash_qkv_self_attention_probe
    fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _P]
    fn.restype = _I
    o = torch.empty(b, n, d3 // 3, dtype=qkv.dtype, device=qkv.device)
    l = torch.empty(b, num_heads, n, dtype=torch.float32, device=qkv.device)
    m = torch.empty_like(l)
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    rc = fn(qkv.data_ptr(), o.data_ptr(), l.data_ptr(), m.data_ptr(), b, n, num_heads, hd, QKV_PROBES[probe],
            1.0 / math.sqrt(hd), stream)
    _build.check_rc(lib, rc, what)
    flash_qkv_self_attention_probe.launches += 1
    flash_qkv_self_attention_probe.launches_by_mode[probe] += 1
    return o, l, m


flash_qkv_self_attention_probe.launches = 0
flash_qkv_self_attention_probe.launches_by_mode = dict.fromkeys(QKV_PROBES, 0)


def chunk_bounds(n: int, chunks: int) -> list[int]:
    """The TPU kernel's KV chunk bounds: steps of ceil(n / chunks) rounded up
    to 128 tokens, the last chunk ending at n (so there may be fewer chunks
    than asked)."""
    if chunks < 1:
        raise ValueError(f"chunks must be >= 1, got {chunks}")
    step = -(-(-(-n // chunks)) // 128) * 128
    bounds = [0]
    while bounds[-1] + step < n:
        bounds.append(bounds[-1] + step)
    return bounds + [n]


def flash_qkv_self_attention_chunked_plain(qkv: torch.Tensor, num_heads: int, chunks: int):
    """Plain version of K11's ``chunks``, the TPU body
    ``_fwd_kernel_qkv_chunked`` step by step: per KV chunk the running max of
    the raw scores, p = exp2((s - m_run) c1) rounded to qkv's dtype, the
    running l and o rescaled by exp2((m_old - m_new) c1); K1's function."""
    dt = qkv.dtype
    q, k, v = _qkv_heads_f32(qkv, num_heads)
    scale = 1.0 / math.sqrt(q.shape[-1])
    c1 = scale * LOG2E
    bounds = chunk_bounds(qkv.shape[1], chunks)
    m_run = l_run = acc = None
    for c0, c1_ in zip(bounds[:-1], bounds[1:]):
        s = torch.matmul(q, k[:, :, c0:c1_].transpose(-1, -2))
        m_c = s.amax(-1, keepdim=True)
        m_new = m_c if m_run is None else torch.maximum(m_run, m_c)
        p = torch.exp2((s - m_new) * c1).to(dt).float()
        pv = torch.matmul(p, v[:, :, c0:c1_])
        if m_run is None:
            l_run, acc = p.sum(-1, keepdim=True), pv
        else:
            alpha = torch.exp2((m_run - m_new) * c1)
            l_run = l_run * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + pv
        m_run = m_new
    o = acc * torch.where(l_run == 0, torch.ones_like(l_run), 1.0 / l_run)
    return _merge_heads(o.to(dt)), l_run[..., 0], m_run[..., 0] * scale


def flash_qkv_self_attention_chunked(qkv: torch.Tensor, num_heads: int, chunks: int):
    """K11's ``chunks``: K1's function with the KV axis split at the TPU's
    128-aligned chunk bounds (:func:`chunk_bounds`), each chunk a block of
    its own, merged by the exact online-softmax rule: qkv (B, N, 3*H*hd) ->
    (o (B, N, H*hd), l, m (B, H, N)). A timing instrument only."""
    what = "flash_qkv_self_attention_chunked"
    _check_qkv(qkv, num_heads)
    bounds = chunk_bounds(qkv.shape[1], chunks)
    if _build.device_type(qkv) == "cpu":
        return flash_qkv_self_attention_chunked_plain(qkv, num_heads, chunks)
    b, n, d3 = qkv.shape
    hd = d3 // 3 // num_heads
    _build.check_cuda_operands(what, qkv)
    _check_timing(what, qkv.dtype, hd, qkv)
    _check_grid(what, b, num_heads)
    nchunks = len(bounds) - 1
    lib = _build.load("attention_modes")
    fn = lib.cs_flash_qkv_self_attention_chunked
    fn.argtypes = [_P] * 7 + [_I] * 6 + [ctypes.c_float, _P]
    fn.restype = _I
    o = torch.empty(b, n, d3 // 3, dtype=qkv.dtype, device=qkv.device)
    l = torch.empty(b, num_heads, n, dtype=torch.float32, device=qkv.device)
    m = torch.empty_like(l)
    part_o = torch.empty(nchunks, b, num_heads, n, hd, dtype=torch.float32, device=qkv.device)
    part_l = torch.empty(nchunks, b, num_heads, n, dtype=torch.float32, device=qkv.device)
    part_m = torch.empty_like(part_l)
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    rc = fn(qkv.data_ptr(), o.data_ptr(), l.data_ptr(), m.data_ptr(), part_o.data_ptr(), part_l.data_ptr(),
            part_m.data_ptr(), b, n, num_heads, hd, bounds[1], nchunks, 1.0 / math.sqrt(hd), stream)
    _build.check_rc(lib, rc, what)
    flash_qkv_self_attention_chunked.launches += 1
    by_mode = flash_qkv_self_attention_chunked.launches_by_mode
    by_mode[f"chunks{chunks}"] = by_mode.get(f"chunks{chunks}", 0) + 1
    return o, l, m


flash_qkv_self_attention_chunked.launches = 0
flash_qkv_self_attention_chunked.launches_by_mode = {}  # "chunks<n>" -> launches


# --- K3 and K6: the decoder attention forward, unmasked and masked -----------


def _check_cross(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int) -> None:
    if q.ndim != 3 or k.shape != v.shape or k.ndim != 3 or q.shape[0] != k.shape[0] \
            or q.shape[2] != k.shape[2] or q.shape[2] % num_heads:
        raise ValueError(
            f"q (B, Nq, H*hd) and k, v (B, Nk, H*hd) expected, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )


def _launch_cross(what: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
                  kv_bias=None, scale=None):
    """Launch K3, or K6 with ``kv_bias``, on CUDA tensors -> (o, l, m). The
    bias is per key, so the hd 8 route passes it as it is."""
    b, nq, d = q.shape
    nk = k.shape[1]
    hd = d // num_heads
    _build.check_cuda_operands(what, q, k, v)
    _check_head_dim(what, hd)
    if hd == NARROW_HEAD_DIM:
        return narrow_head_route(
            lambda q, k, v, scale: _launch_cross(what, q, k, v, num_heads, kv_bias, scale), (q, k, v), 1)
    _check_grid(what, b, num_heads)
    scale = 1.0 / math.sqrt(hd) if scale is None else scale
    if q.dtype == torch.float32:
        o = torch.empty_like(q)
        l, m = _launch_f32(what, "flash_cross", *(_split_heads(t, num_heads) for t in (q, k, v, o)), kv_bias, scale)
        return o, l, m
    bias_types, bias_args = _bias_args(what, kv_bias, q.device)
    lib = _build.load("flash_cross")
    fn = lib.cs_flash_cross_attention if kv_bias is None else lib.cs_flash_cross_attention_masked
    fn.argtypes = [_P, _P, _P, *bias_types, _P, _P, _P, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P]
    fn.restype = _I
    o = torch.empty_like(q)
    l = torch.empty(b, num_heads, nq, dtype=torch.float32, device=q.device)
    m = torch.empty_like(l)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), *bias_args, o.data_ptr(), l.data_ptr(), m.data_ptr(),
            b, nq, nk, num_heads, hd, _build.DTYPE_CODES[str(q.dtype)], scale, stream)
    _build.check_rc(lib, rc, what)
    return o, l, m


def flash_cross_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
                                kv_bias=None, scale=None):
    """Plain version of K3 (and of K6 with ``kv_bias``) on token-major
    (B, N, H*hd) projections."""
    o, _, l, m = attention_with_stats(
        _split_heads(q, num_heads), _split_heads(k, num_heads), _split_heads(v, num_heads), kv_bias, scale
    )
    return _merge_heads(o), l, m


def flash_cross_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int):
    """Decoder attention at the true head dim with scale 1/sqrt(hd):
    q (B, Nq, H*hd), k/v (B, Nk, H*hd) -> (o (B, Nq, H*hd), l, m (B, H, Nq))."""
    _check_cross(q, k, v, num_heads)
    if _build.device_type(q) == "cpu":
        return flash_cross_attention_plain(q, k, v, num_heads)
    out = _launch_cross("flash_cross_attention", q, k, v, num_heads)
    flash_cross_attention.launches += 1
    return out


flash_cross_attention.launches = 0


def flash_cross_attention_masked_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                       kv_bias: torch.Tensor, num_heads: int):
    """Plain version of K6: K3's with the bias added to the scaled logits."""
    return flash_cross_attention_plain(q, k, v, num_heads, kv_bias)


def flash_cross_attention_masked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 kv_bias: torch.Tensor, num_heads: int):
    """K3 with an additive KV-token bias (forward only), the counterpart of the
    JAX ``flash_cross_attention_ln_masked``: q (B, Nq, H*hd), k/v (B, Nk,
    H*hd), kv_bias (Nk,) or (B, Nk) fp32 -> (o (B, Nq, H*hd), l, m (B, H, Nq))."""
    what = "flash_cross_attention_masked"
    _check_cross(q, k, v, num_heads)
    _check_bias(what, kv_bias, q.shape[0], k.shape[1], q, k, v)
    if _build.device_type(q) == "cpu":
        return flash_cross_attention_masked_plain(q, k, v, kv_bias, num_heads)
    out = _launch_cross(what, q, k, v, num_heads, kv_bias)
    flash_cross_attention_masked.launches += 1
    return out


flash_cross_attention_masked.launches = 0


# --- K7: the head-major forward ----------------------------------------------


def _check_head_major(what: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_bias) -> None:
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape or q.shape[:2] != k.shape[:2] \
            or q.shape[3] != k.shape[3]:
        raise ValueError(f"{what}: q (B, H, Nq, hd) and k, v (B, H, Nk, hd) expected, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if kv_bias is not None:
        if kv_bias.dtype != torch.float32 or tuple(kv_bias.shape) != (k.shape[2],):
            raise ValueError(f"{what}: kv_bias must be float32 ({k.shape[2]},), got "
                             f"{kv_bias.dtype} {tuple(kv_bias.shape)}")
    if any(t is not None and t.requires_grad for t in (q, k, v, kv_bias)):
        raise RuntimeError(f"{what} is forward only; an input requires grad")


def flash_attention_head_major_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_bias=None,
                                     scale=None):
    """Plain version of K7: dense attention with fp32 logits on (B, H, N, hd)
    operands (strided views included) -> (o (B, H, Nq, hd), l, m)."""
    o, _, l, m = attention_with_stats(q, k, v, kv_bias, scale)
    return o, l, m


def flash_attention_head_major(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_bias=None):
    """Forward-only flash attention on head-major operands, the counterpart of
    the JAX ``_flash_fwd`` (v1 without a bias, v2 with one): q (B, H, Nq, hd),
    k/v (B, H, Nk, hd), each contiguous or a strided view with hd contiguous
    (``x.view(B, N, H, hd).transpose(1, 2)`` of a token-major projection);
    ``kv_bias`` None or a float32 (Nk,) row in natural units shared by the
    batch -> (o (B, H, Nq, hd) contiguous, l, m (B, H, Nq) fp32), scale
    1/sqrt(hd), ``m`` including the bias."""
    what = "flash_attention_head_major"
    _check_head_major(what, q, k, v, kv_bias)
    if _build.device_type(q) == "cpu":
        return flash_attention_head_major_plain(q, k, v, kv_bias)
    out = _launch_head_major(what, q, k, v, kv_bias)
    flash_attention_head_major.launches += 1
    return out


def _launch_head_major(what: str, q, k, v, kv_bias, scale=None):
    """Launch K7 on CUDA tensors -> (o, l, m)."""
    b, h, nq, hd = q.shape
    nk = k.shape[2]
    for t in (k, v) + (() if kv_bias is None else (kv_bias,)):
        if t.device != q.device:
            raise ValueError(f"{what}: operands must share one CUDA device, got {t.device}")
    if str(q.dtype) not in _build.DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{what}: operands must all be float32 or bfloat16")
    _check_head_dim(what, hd)
    if hd == NARROW_HEAD_DIM:
        return narrow_head_route(lambda q, k, v, scale: _launch_head_major(what, q, k, v, kv_bias, scale),
                                 (q, k, v), 1)
    _check_grid(what, b, h)
    strides = (ctypes.c_longlong * 9)(*_tma_strides(what, q, k, v))
    scale = 1.0 / math.sqrt(hd) if scale is None else scale
    if q.dtype == torch.float32:
        o = torch.empty(b, h, nq, hd, dtype=q.dtype, device=q.device)
        l, m = _launch_f32(what, "flash_cross", q, k, v, o, kv_bias, scale)
        return o, l, m
    lib = _build.load("flash_cross")
    if kv_bias is None:
        fn, bias_types, bias_args = lib.cs_flash_attention_head_major, [], ()
    else:
        if not kv_bias.is_contiguous():
            raise ValueError(f"{what}: kv_bias must be contiguous")
        fn, bias_types, bias_args = lib.cs_flash_attention_head_major_biased, [_P], (kv_bias.data_ptr(),)
    fn.argtypes = [_P, _P, _P, _P, *bias_types, _P, _P, _P, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P]
    fn.restype = _I
    o = torch.empty(b, h, nq, hd, dtype=q.dtype, device=q.device)
    l = torch.empty(b, h, nq, dtype=torch.float32, device=q.device)
    m = torch.empty_like(l)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), ctypes.addressof(strides), *bias_args,
            o.data_ptr(), l.data_ptr(), m.data_ptr(), b, h, nq, nk, hd,
            _build.DTYPE_CODES[str(q.dtype)], scale, stream)
    _build.check_rc(lib, rc, what)
    return o, l, m


flash_attention_head_major.launches = 0


# --- K7': K7's timing variants -----------------------------------------------


def flash_attention_head_major_variant_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, variant: str):
    """Plain version of K7', the TPU bodies step by step (fp32 scores, p
    rounded to v's dtype, fp32 products, c1 = log2(e) / sqrt(hd)):
    "mxuprobe" (``_fwd_kernel_v2_mxu_probe``): p = s c1, o = p v
    unnormalised, l = sum p, m = 0; "noexp" and "bf16exp" (the options of
    ``_fwd_kernel_single_v2``): t = s c1, m = rowmax(t), p = t - m (noexp)
    or exp2 of t - m rounded to bf16, in bf16 (bf16exp: JAX computes a bf16
    exp2 as exp(bf16(x * bf16(ln 2)))); o / l, l = sum p, m in natural
    units. p is rounded to v's dtype, so bf16exp's exponential rounds to bf16
    for bf16 inputs and stays fp32 for fp32 ones, as XLA runs the TPU body."""
    if variant not in HEAD_MAJOR_VARIANTS:
        raise ValueError(f"variant must be one of {sorted(HEAD_MAJOR_VARIANTS)}, got {variant!r}")
    dt = v.dtype
    c1 = LOG2E / math.sqrt(q.shape[-1])
    vf = v.float()
    t = torch.matmul(q.float(), k.float().transpose(-1, -2)) * c1
    if variant == "mxuprobe":
        p = t.to(dt).float()
        l = p.sum(-1)
        return torch.matmul(p, vf).to(q.dtype), l, torch.zeros_like(l)
    m = t.amax(-1, keepdim=True)
    if variant == "noexp":
        p = (t - m).to(dt).float()
    else:  # exp2 on bf16 as JAX lowers it: exp(bf16(bf16(x) * bf16(ln 2))); XLA keeps the
        # exponential itself in fp32 (its excess-precision rule), so p rounds to v's dtype only
        u = (t - m).to(torch.bfloat16) * torch.tensor(BF16_LN2, dtype=torch.bfloat16)
        p = torch.exp(u.float()).to(dt).float()
    l = p.sum(-1, keepdim=True)
    o = torch.matmul(p, vf) * torch.where(l == 0, torch.ones_like(l), 1.0 / l)
    return o.to(q.dtype), l[..., 0], m[..., 0] / LOG2E


def flash_attention_head_major_variant(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, variant: str):
    """K7' ("mxuprobe", "noexp" or "bf16exp"; see the plain version) on
    head-major operands as K7 takes them (contiguous or head-major views, no
    bias): q (B, H, Nq, hd), k/v (B, H, Nk, hd) -> (o (B, H, Nq, hd), l, m).
    A timing instrument only: no model path calls it."""
    what = "flash_attention_head_major_variant"
    _check_head_major(what, q, k, v, None)
    if variant not in HEAD_MAJOR_VARIANTS:
        raise ValueError(f"{what}: variant must be one of {sorted(HEAD_MAJOR_VARIANTS)}, got {variant!r}")
    if _build.device_type(q) == "cpu":
        return flash_attention_head_major_variant_plain(q, k, v, variant)
    b, h, nq, hd = q.shape
    nk = k.shape[2]
    for t in (k, v):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{what}: operands must share one CUDA device and dtype")
    _check_timing(what, q.dtype, hd)
    _check_grid(what, b, h)
    strides = (ctypes.c_longlong * 9)(*_tma_strides(what, q, k, v))
    lib = _build.load("attention_modes")
    fn = lib.cs_flash_attention_head_major_variant
    fn.argtypes = [_P] * 7 + [_I] * 6 + [ctypes.c_float, _P]
    fn.restype = _I
    o = torch.empty(b, h, nq, hd, dtype=q.dtype, device=q.device)
    l = torch.empty(b, h, nq, dtype=torch.float32, device=q.device)
    m = torch.empty_like(l)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), ctypes.addressof(strides), o.data_ptr(), l.data_ptr(),
            m.data_ptr(), b, h, nq, nk, hd, HEAD_MAJOR_VARIANTS[variant], 1.0 / math.sqrt(hd), stream)
    _build.check_rc(lib, rc, what)
    flash_attention_head_major_variant.launches += 1
    flash_attention_head_major_variant.launches_by_mode[variant] += 1
    return o, l, m


flash_attention_head_major_variant.launches = 0
flash_attention_head_major_variant.launches_by_mode = dict.fromkeys(HEAD_MAJOR_VARIANTS, 0)


# --- K4 ---------------------------------------------------------------------


def _bwd_stats(o: torch.Tensor, do: torch.Tensor, l: torch.Tensor, m: torch.Tensor, num_heads: int):
    """The backward's per-row inputs, prepared as the JAX package prepares
    them outside its kernel: ``lb = (m + ln l) * log2(e)`` (l == 0 taken as
    1) and ``delta = rowsum_h(o * do)``, both (B, H, Nq) in fp32 (fp64 for
    fp64 inputs)."""
    acc = torch.float64 if o.dtype == torch.float64 else torch.float32
    b, nq, d = o.shape
    delta = (o.to(acc) * do.to(acc)).reshape(b, nq, num_heads, d // num_heads).sum(-1)
    return _log_normaliser(l, m, acc), delta.transpose(1, 2).contiguous()


def _log_normaliser(l: torch.Tensor, m: torch.Tensor, acc) -> torch.Tensor:
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    return ((m + torch.log(l_safe)) * LOG2E).to(acc).contiguous()


def _bwd_stats_head_major(o: torch.Tensor, do: torch.Tensor, l: torch.Tensor, m: torch.Tensor):
    """:func:`_bwd_stats` for head-major (B, H, Nq, hd) ``o`` and ``do``."""
    acc = torch.float64 if o.dtype == torch.float64 else torch.float32
    return _log_normaliser(l, m, acc), (o.to(acc) * do.to(acc)).sum(-1).contiguous()


def _bwd_recipe(qh, kh, vh, doh, lb, delta, dt, scale=None):
    """The backward kernels' recipe on one batch row of head-major (H, N, hd)
    operands in the accumulation dtype: recompute ``p = exp2(s * scale *
    log2e - lb)``, form ``ds = p * (dp - delta) * scale``, then take the
    products, with p and ds rounded to ``dt`` (the input dtype) before their
    products and every product summed in fp32 -> (dq, dk, dv), (H, N, hd)."""
    acc = qh.dtype
    if scale is None:
        scale = 1.0 / math.sqrt(qh.shape[-1])
    s = torch.matmul(qh, kh.transpose(-1, -2))  # (H, Nq, Nk)
    p = torch.exp2(s * (scale * LOG2E) - lb[..., None])
    dp = torch.matmul(doh, vh.transpose(-1, -2))
    ds = p * (dp - delta[..., None]) * scale
    p, ds = p.to(dt).to(acc), ds.to(dt).to(acc)
    return (torch.matmul(ds, kh), torch.matmul(ds.transpose(-1, -2), qh),
            torch.matmul(p.transpose(-1, -2), doh))


def _launch_bwd_stats(what: str, o: torch.Tensor, do: torch.Tensor, l: torch.Tensor, m: torch.Tensor):
    """:func:`_bwd_stats_head_major` on the card, for bf16: the backward's lb
    and delta (B, H, Nq) fp32 by one kernel (``cs_flash_attention_bwd_stats``)
    from head-major o and do, each contiguous or a view whose rows of hd
    elements start on 16-byte boundaries (the caller checks)."""
    b, h, nq, hd = o.shape
    strides = (ctypes.c_longlong * 6)(*(o.stride()[:3] + do.stride()[:3]))
    l, m = l.contiguous(), m.contiguous()
    lb = torch.empty(b, h, nq, dtype=torch.float32, device=o.device)
    delta = torch.empty_like(lb)
    lib = _build.load("flash_cross_bwd")
    fn = lib.cs_flash_attention_bwd_stats
    fn.argtypes = [_P] * 7 + [_I] * 4 + [_P]
    fn.restype = _I
    rc = fn(o.data_ptr(), do.data_ptr(), ctypes.addressof(strides), l.data_ptr(), m.data_ptr(), lb.data_ptr(),
            delta.data_ptr(), b, h, nq, hd, torch.cuda.current_stream(o.device).cuda_stream)
    _build.check_rc(lib, rc, what)
    return lb, delta


def flash_cross_attention_bwd_plain(q, k, v, o, do, l, m, num_heads: int, scale=None):
    """Plain version of K4: the kernel's recipe (:func:`_bwd_recipe`) step by
    step for one batch row at a time, which bounds the memory of the score
    tensors."""
    acc = torch.float64 if q.dtype == torch.float64 else torch.float32
    lb, delta = _bwd_stats(o, do, l, m, num_heads)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    for i in range(q.shape[0]):
        qh, kh, vh, doh = (_split_heads(t[i:i + 1].to(acc), num_heads)[0] for t in (q, k, v, do))
        gq, gk, gv = _bwd_recipe(qh, kh, vh, doh, lb[i], delta[i], q.dtype, scale)
        dq[i], dk[i], dv[i] = (_merge_heads(g[None])[0].to(q.dtype) for g in (gq, gk, gv))
    return dq, dk, dv


def flash_cross_attention_bwd(q, k, v, o, do, l, m, num_heads: int):
    """Backward of :func:`flash_cross_attention`: q, o, do (B, Nq, H*hd), k, v
    (B, Nk, H*hd), l, m (B, H, Nq) -> (dq, dk, dv) in the input dtype."""
    if q.ndim != 3 or k.shape != v.shape or o.shape != q.shape or do.shape != q.shape \
            or q.shape[0] != k.shape[0] or q.shape[2] != k.shape[2] or q.shape[2] % num_heads \
            or l.shape != (q.shape[0], num_heads, q.shape[1]) or m.shape != l.shape:
        raise ValueError(
            f"flash_cross_attention_bwd: q/o/do (B, Nq, H*hd), k/v (B, Nk, H*hd) and "
            f"l/m (B, H, Nq) expected, got q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"o {tuple(o.shape)}, do {tuple(do.shape)}, l {tuple(l.shape)}"
        )
    if _build.device_type(q) == "cpu":
        return flash_cross_attention_bwd_plain(q, k, v, o, do, l, m, num_heads)
    out = _launch_cross_bwd("flash_cross_attention_bwd", q, k, v, o, do, l, m, num_heads)
    flash_cross_attention_bwd.launches += 1
    return out


def _launch_cross_bwd(what: str, q, k, v, o, do, l, m, num_heads: int, scale=None):
    """Launch K4 on CUDA tensors -> (dq, dk, dv)."""
    b, nq, d = q.shape
    nk = k.shape[1]
    hd = d // num_heads
    _build.check_cuda_operands(what, q, k, v, o, do)
    _check_head_dim(what, hd)
    if hd == NARROW_HEAD_DIM:
        return narrow_head_route(
            lambda q, k, v, o, do, scale: _launch_cross_bwd(what, q, k, v, o, do, l, m, num_heads, scale),
            (q, k, v, o, do), 3)
    _check_grid(what, b, num_heads)
    if q.dtype == torch.bfloat16:
        lb, delta = _launch_bwd_stats(what, _split_heads(o, num_heads), _split_heads(do, num_heads), l, m)
    else:  # the fp32 path as it was
        lb, delta = _bwd_stats(o, do, l, m, num_heads)
    _build.check_cuda_operands(what, lb, delta)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    lib = _build.load("flash_cross_bwd")
    fn = lib.cs_flash_cross_attention_bwd
    fn.argtypes = [_P] * 9 + [_I] * 6 + [ctypes.c_float, _P]
    fn.restype = _I
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lb.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, nq, nk, num_heads, hd,
            _build.DTYPE_CODES[str(q.dtype)], 1.0 / math.sqrt(hd) if scale is None else scale, stream)
    _build.check_rc(lib, rc, what)
    return dq, dk, dv


flash_cross_attention_bwd.launches = 0


class _FlashCrossAttention(torch.autograd.Function):
    """Decoder attention with forward K3 and backward K4; the counterpart of
    the JAX ``custom_vjp`` ``flash_cross_attention_ln``. Saves q, k, v, o, l
    and m for the backward."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads: int):
        o, l, m = flash_cross_attention(q, k, v, num_heads)
        ctx.save_for_backward(q, k, v, o, l, m)
        ctx.num_heads = num_heads
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, l, m = ctx.saved_tensors
        # the incoming gradient may be a strided view; the kernel takes rows
        dq, dk, dv = flash_cross_attention_bwd(q, k, v, o, do.contiguous(), l, m, ctx.num_heads)
        return dq, dk, dv, None


def flash_cross_attention_ln(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Differentiable decoder attention: q (B, Nq, H*hd), k/v (B, Nk, H*hd) ->
    o (B, Nq, H*hd), through K3 forward and K4 backward."""
    return _FlashCrossAttention.apply(q, k, v, num_heads)


# --- K8 and K9: the head-major backward --------------------------------------

# the JAX dispatch rule (``_dispatch_bwd``): the single-KV-block kernel up to
# this many KV tokens, the multi-block kernel beyond; here one kernel serves
# both, and the rule only says which counter a launch adds to
BWD_SINGLE_MAX_NK = 2048


def _check_head_major_bwd(what: str, q, k, v, o, do, l, m) -> None:
    b, h, nq, hd = q.shape if q.ndim == 4 else (0, 0, 0, 0)
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape or k.shape[:2] != (b, h) or k.shape[3] != hd \
            or o.shape != q.shape or do.shape != q.shape or l.shape != (b, h, nq) or m.shape != l.shape:
        raise ValueError(f"{what}: q/o/do (B, H, Nq, hd), k/v (B, H, Nk, hd) and l/m (B, H, Nq) "
                         f"expected, got q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}, "
                         f"o {tuple(o.shape)}, do {tuple(do.shape)}, l {tuple(l.shape)}")


def flash_attention_head_major_bwd_plain(q, k, v, o, do, l, m, scale=None):
    """Plain version of K8/K9: :func:`_bwd_recipe` for one batch row at a time
    on head-major operands (strided views included) -> (dq, dk, dv) as the
    kernel returns them, head-major views of token-major (B, N, H*hd)
    buffers in the input dtype."""
    acc = torch.float64 if q.dtype == torch.float64 else torch.float32
    b, h, nq, hd = q.shape
    nk = k.shape[2]
    lb, delta = _bwd_stats_head_major(o, do, l, m)
    dq = torch.empty(b, nq, h * hd, dtype=q.dtype, device=q.device)
    dk = torch.empty(b, nk, h * hd, dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    for i in range(b):
        gq, gk, gv = _bwd_recipe(q[i].to(acc), k[i].to(acc), v[i].to(acc), do[i].to(acc), lb[i], delta[i],
                                 q.dtype, scale)
        dq[i], dk[i], dv[i] = (_merge_heads(g[None])[0].to(q.dtype) for g in (gq, gk, gv))
    return tuple(_split_heads(t, h) for t in (dq, dk, dv))


# the launch counters of K8 and K9 (``.launches``)
flash_attention_bwd_single = types.SimpleNamespace(launches=0)  # K8, the JAX ``_bwd_pallas_single``
flash_attention_bwd_multi = types.SimpleNamespace(launches=0)  # K9, the JAX ``_bwd_pallas_multi``

# what a TMA tensor map takes (``cuTensorMapEncodeTiled``): a 16-byte aligned
# base, byte strides that are multiples of 16 below 2**40, dimensions of at
# most 2**32 elements
TMA_MAX_STRIDE_BYTES = 1 << 40
TMA_MAX_DIM = 1 << 32


def tma_strides(shape, strides, elem_size: int, data_ptr: int) -> list[int] | None:
    """The element strides (batch, head, row) with which the bf16 kernels
    (the forward K1, K3, K5-K7, K11, K7' and the backward K4, K8, K9) map one
    (B, H, N, hd) operand onto a TMA tensor map of dimensions (hd, N, H, B),
    or None when TMA cannot take it: hd not contiguous, a base or
    a stride off a 16-byte boundary, a stride of 2**40 bytes or more, a
    stride of 0 on an axis longer than 1, or a dimension above 2**32. An axis
    of length 1 is never stepped over, so its stride is reported as that of
    a contiguous tensor."""
    if len(shape) != 4 or len(strides) != 4 or strides[3] != 1 or data_ptr % 16:
        return None
    if any(not 0 < n <= TMA_MAX_DIM for n in shape):
        return None
    out, inner = [], shape[3]
    for axis in (2, 1, 0):  # rows, heads, batch
        st = strides[axis] if shape[axis] > 1 else inner
        nbytes = st * elem_size
        if st <= 0 or nbytes % 16 or nbytes >= TMA_MAX_STRIDE_BYTES:
            return None
        out.append(st)
        inner *= shape[axis]
    return out[::-1]


def _tma_strides(what: str, *tensors) -> list[int]:
    """:func:`tma_strides` of each operand, batch, head and row stride in
    turn; raises ValueError, before any launch, for an operand TMA cannot
    take."""
    out = []
    for t in tensors:
        st = tma_strides(tuple(t.shape), t.stride(), t.element_size(), t.data_ptr())
        if st is None:
            raise ValueError(f"{what}: each operand needs contiguous rows of hd elements, a 16-byte aligned "
                             f"base and positive strides that are 16-byte multiples, got shape "
                             f"{tuple(t.shape)}, strides {t.stride()}")
        out += st
    return out


def _launch_head_major_bwd(what: str, q, k, v, o, do, l, m, scale=None):
    """Launch the head-major backward on CUDA tensors -> (dq, dk, dv)."""
    b, h, nq, hd = q.shape
    nk = k.shape[2]
    for t in (k, v, o, do, l, m):
        if t.device != q.device:
            raise ValueError(f"{what}: operands must share one CUDA device, got {t.device}")
    if str(q.dtype) not in _build.DTYPE_CODES or any(t.dtype != q.dtype for t in (k, v, o, do)):
        raise ValueError(f"{what}: q, k, v, o and do must all be float32 or all bfloat16")
    _check_head_dim(what, hd)
    if hd == NARROW_HEAD_DIM:
        return narrow_head_route(
            lambda q, k, v, o, do, scale: _launch_head_major_bwd(what, q, k, v, o, do, l, m, scale),
            (q, k, v, o, do), 3)
    _check_grid(what, b, h)
    strides = (ctypes.c_longlong * 12)(*_tma_strides(what, q, do, k, v))
    if q.dtype == torch.bfloat16:
        lb, delta = _launch_bwd_stats(what, _kernel_rows(o), do, l, m)
    else:  # the fp32 path as it was
        lb, delta = _bwd_stats_head_major(o, do, l, m)
    dq = torch.empty(b, nq, h * hd, dtype=q.dtype, device=q.device)
    dk = torch.empty(b, nk, h * hd, dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    lib = _build.load("flash_cross_bwd")
    fn = lib.cs_flash_attention_head_major_bwd
    fn.argtypes = [_P] * 10 + [_I] * 6 + [ctypes.c_float, _P]
    fn.restype = _I
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), ctypes.addressof(strides),
            lb.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h, nq, nk, hd,
            _build.DTYPE_CODES[str(q.dtype)], 1.0 / math.sqrt(hd) if scale is None else scale, stream)
    _build.check_rc(lib, rc, what)
    return tuple(_split_heads(t, h) for t in (dq, dk, dv))


def flash_attention_head_major_bwd(q, k, v, o, do, l, m):
    """Backward of the head-major attention, the counterpart of the JAX
    ``_dispatch_bwd``: q, o, do (B, H, Nq, hd) and k, v (B, H, Nk, hd), each
    contiguous or a strided view with hd contiguous; l, m (B, H, Nq) fp32 in
    K7's convention (the context-parallel backward passes the global ones)
    -> (dq, dk, dv) in the input dtype, the head-major views of token-major
    (B, N, H*hd) buffers, ready for the projections' backward (at hd 8,
    contiguous head-major tensors). A launch counts as K8 (one KV block on
    the TPU) up to :data:`BWD_SINGLE_MAX_NK` KV tokens, as K9 beyond."""
    what = "flash_attention_head_major_bwd"
    _check_head_major_bwd(what, q, k, v, o, do, l, m)
    if _build.device_type(q) == "cpu":
        return flash_attention_head_major_bwd_plain(q, k, v, o, do, l, m)
    out = _launch_head_major_bwd(what, q, k, v, o, do, l, m)
    (flash_attention_bwd_single if k.shape[2] <= BWD_SINGLE_MAX_NK else flash_attention_bwd_multi).launches += 1
    return out


def _kernel_rows(t: torch.Tensor) -> torch.Tensor:
    """``t``, or its contiguous copy when the TMA loads cannot read it in
    place (:func:`tma_strides`; an incoming gradient may be any view). A
    fresh copy: a contiguous tensor may still start off a 16-byte boundary."""
    if tma_strides(tuple(t.shape), t.stride(), t.element_size(), t.data_ptr()) is not None:
        return t
    return t.clone(memory_format=torch.contiguous_format)


class _FlashAttentionHeadMajor(torch.autograd.Function):
    """Head-major attention with forward K7 and backward K8/K9; the
    counterpart of the JAX ``custom_vjp`` ``flash_cross_attention``. Saves
    q, k, v, o, l and m for the backward."""

    @staticmethod
    def forward(ctx, q, k, v):
        # K7 refuses inputs that require grad: it is handed the detached ones
        q, k, v = q.detach(), k.detach(), v.detach()
        o, l, m = flash_attention_head_major(q, k, v)
        ctx.save_for_backward(q, k, v, o, l, m)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, l, m = ctx.saved_tensors
        return flash_attention_head_major_bwd(q, k, v, o, _kernel_rows(do), l, m)


def head_major_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Differentiable head-major attention, softmax(q k^T / sqrt(hd)) v:
    q (B, H, Nq, hd), k/v (B, H, Nk, hd), each contiguous or a head-major
    view of a token-major projection -> o (B, H, Nq, hd), through K7 forward
    and K8/K9 backward."""
    return _FlashAttentionHeadMajor.apply(q, k, v)
