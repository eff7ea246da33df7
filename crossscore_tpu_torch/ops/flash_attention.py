"""Flash-attention forwards K1 and K3; counterpart of
``crossscore_tpu/ops/flash_attention.py`` (``_flash_qkv_fwd`` and
``_flash_cross_ln_fwd``).

Both return ``(o, l, m)`` in the JAX package's convention: ``o`` token-major
(B, Nq, H*hd), ``l`` and ``m`` (B, H, Nq) fp32, ``m`` the row max of the
scaled logits in natural units and ``l`` = sum(exp(scaled - m)).

On a CUDA tensor each wrapper launches its kernel (``csrc/flash_qkv.cu``,
``csrc/flash_cross.cu``) or raises; on a CPU tensor it runs the plain PyTorch
version beside it. Each wrapper counts its kernel launches in ``.launches``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from crossscore_tpu_torch.ops import _build
from crossscore_tpu_torch.ops.attention import attention_with_stats

_P = ctypes.c_void_p
_I = ctypes.c_int


def _split_heads(x: torch.Tensor, h: int) -> torch.Tensor:
    b, n, d = x.shape
    return x.reshape(b, n, h, d // h).permute(0, 2, 1, 3)  # (B, H, N, hd)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, n, hd = x.shape
    return x.permute(0, 2, 1, 3).reshape(b, n, h * hd)


def _check_head_dim(what: str, hd: int) -> None:
    if hd % 16 or not 16 <= hd <= 128:
        raise ValueError(
            f"{what}: head dim {hd} is not supported by the CUDA kernel "
            "(a multiple of 16 up to 128)"
        )


# --- K1 ---------------------------------------------------------------------


def flash_qkv_self_attention_plain(qkv: torch.Tensor, num_heads: int):
    """Plain version of K1: split the fused projection, attend, re-pack."""
    b, n, d3 = qkv.shape
    d = d3 // 3
    q, k, v = (_split_heads(qkv[..., i * d:(i + 1) * d], num_heads) for i in range(3))
    o, _, l, m = attention_with_stats(q, k, v)
    return _merge_heads(o), l, m


def flash_qkv_self_attention(qkv: torch.Tensor, num_heads: int):
    """Self-attention straight off the fused projection: qkv (B, N, 3*H*hd)
    -> (o (B, N, H*hd), l, m (B, H, N))."""
    if qkv.ndim != 3 or qkv.shape[2] % (3 * num_heads):
        raise ValueError(f"qkv must be (B, N, 3*H*hd) with H={num_heads}, got {tuple(qkv.shape)}")
    if _build.device_type(qkv) == "cpu":
        return flash_qkv_self_attention_plain(qkv, num_heads)
    b, n, d3 = qkv.shape
    d = d3 // 3
    hd = d // num_heads
    _build.check_cuda_operands("flash_qkv_self_attention", qkv)
    _check_head_dim("flash_qkv_self_attention", hd)
    if b > 65535 or num_heads > 65535:
        raise ValueError("flash_qkv_self_attention: batch and heads must be < 65536")
    lib = _build.load("flash_qkv")
    fn = lib.cs_flash_qkv_self_attention
    fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _P]
    fn.restype = _I
    o = torch.empty(b, n, d, dtype=qkv.dtype, device=qkv.device)
    l = torch.empty(b, num_heads, n, dtype=torch.float32, device=qkv.device)
    m = torch.empty_like(l)
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    rc = fn(qkv.data_ptr(), o.data_ptr(), l.data_ptr(), m.data_ptr(), b, n, num_heads, hd,
            _build.DTYPE_CODES[str(qkv.dtype)], 1.0 / math.sqrt(hd), stream)
    _build.check_rc(lib, rc, "flash_qkv_self_attention")
    flash_qkv_self_attention.launches += 1
    return o, l, m


flash_qkv_self_attention.launches = 0


# --- K3 ---------------------------------------------------------------------


def flash_cross_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int):
    """Plain version of K3 on token-major (B, N, H*hd) projections."""
    o, _, l, m = attention_with_stats(
        _split_heads(q, num_heads), _split_heads(k, num_heads), _split_heads(v, num_heads)
    )
    return _merge_heads(o), l, m


def flash_cross_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int):
    """Decoder attention at the true head dim with scale 1/sqrt(hd):
    q (B, Nq, H*hd), k/v (B, Nk, H*hd) -> (o (B, Nq, H*hd), l, m (B, H, Nq))."""
    if q.ndim != 3 or k.shape != v.shape or k.ndim != 3 or q.shape[0] != k.shape[0] \
            or q.shape[2] != k.shape[2] or q.shape[2] % num_heads:
        raise ValueError(
            f"q (B, Nq, H*hd) and k, v (B, Nk, H*hd) expected, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if _build.device_type(q) == "cpu":
        return flash_cross_attention_plain(q, k, v, num_heads)
    b, nq, d = q.shape
    nk = k.shape[1]
    hd = d // num_heads
    _build.check_cuda_operands("flash_cross_attention", q, k, v)
    _check_head_dim("flash_cross_attention", hd)
    if b > 65535 or num_heads > 65535:
        raise ValueError("flash_cross_attention: batch and heads must be < 65536")
    lib = _build.load("flash_cross")
    fn = lib.cs_flash_cross_attention
    fn.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P]
    fn.restype = _I
    o = torch.empty_like(q)
    l = torch.empty(b, num_heads, nq, dtype=torch.float32, device=q.device)
    m = torch.empty_like(l)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), l.data_ptr(), m.data_ptr(),
            b, nq, nk, num_heads, hd, _build.DTYPE_CODES[str(q.dtype)], 1.0 / math.sqrt(hd), stream)
    _build.check_rc(lib, rc, "flash_cross_attention")
    flash_cross_attention.launches += 1
    return o, l, m


flash_cross_attention.launches = 0
