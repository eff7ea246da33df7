"""Fused LayerNorm -> fc1 -> GELU -> fc2 -> LayerScale -> residual (K2);
counterpart of ``crossscore_tpu/ops/fused_mlp.py`` (``fused_ln_mlp``)::

    out = x + ls2 * (fc2(gelu(fc1(ln(x)) + b1)) + b2)

and the same with the attention half's LayerScale residual folded in (K10,
``fused_res_ln_mlp``)::

    x2 = x + attn * ls1;  out = x2 + ls2 * (fc2(gelu(fc1(ln(x2)) + b1)) + b2)

Weights are in torch ``Linear`` layout: ``w1`` (F, D), ``w2`` (D, F). On a
CUDA tensor :func:`fused_ln_mlp` and :func:`fused_res_ln_mlp` launch
``csrc/fused_ln_mlp.cu`` or raise; on a CPU tensor they run their plain
versions. The GELU rule is the JAX kernel's: the tanh form only for bf16 with
``gelu="tanh"`` (K10: always on bf16), otherwise the exact form through XLA's
f32 erf polynomial. ``ViTBlock`` calls K2, never K10, as in the JAX package.
"""

from __future__ import annotations

import ctypes

import torch

from crossscore_tpu_torch.ops import _build

# XLA's f32 erf rational approximation (xla/client/lib/math.cc ErfImpl32),
# as evaluated by the TPU kernel and by csrc/fused_ln_mlp.cu
_ERF_ALPHA = (0.00022905065861350646, 0.0034082910107109506,
              0.050955695062380861, 0.18520832239976145, 1.128379143519084)
_ERF_BETA = (-1.1791602954361697e-7, 2.3547966471313185e-5,
             1.0179625278914885e-3, 1.4070470171167667e-2,
             1.1098505178285362e-1, 4.9746925110067538e-1, 1.0)


def _erf_f32(x: torch.Tensor) -> torch.Tensor:
    x = x.clamp(-4.0, 4.0)
    x2 = x * x
    p = torch.full_like(x, _ERF_ALPHA[0])
    for c in _ERF_ALPHA[1:]:
        p = p * x2 + c
    q = torch.full_like(x, _ERF_BETA[0])
    for c in _ERF_BETA[1:]:
        q = q * x2 + c
    return x * p / q


def _use_tanh(dtype: torch.dtype, gelu: str) -> bool:
    if gelu not in ("tanh", "exact"):
        raise ValueError(f"gelu must be 'tanh' or 'exact', got {gelu!r}")
    return dtype == torch.bfloat16 and gelu == "tanh"


def fused_ln_mlp_plain(x, ln_scale, ln_bias, w1, b1, w2, b2, ls2, eps: float = 1e-6,
                       gelu: str = "tanh"):
    """Plain version of K2 with the kernel's casts: vectors and weights in
    x's dtype, LN statistics, products, GELU, LayerScale and residual in fp32."""
    return _ln_mlp_body(x.float(), x.dtype, ln_scale, ln_bias, w1, b1, w2, b2, ls2, eps, gelu)


def _ln_mlp_body(xf, dt, ln_scale, ln_bias, w1, b1, w2, b2, ls2, eps, gelu):
    """The TPU kernels' ``_ln_mlp_body``: LN of the fp32 stream ``xf``, the
    MLP with the vectors and weights in ``dt``, and ``xf`` added unrounded."""
    f32 = lambda t: t.to(dt).float()  # noqa: E731
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = (y * f32(ln_scale) + f32(ln_bias)).to(dt)
    h = torch.matmul(y.float(), f32(w1).t()) + f32(b1)
    if _use_tanh(dt, gelu):
        h = 0.5 * h * (1.0 + torch.tanh(0.7978845608028654 * (h + 0.044715 * h * h * h)))
    else:
        h = 0.5 * h * (1.0 + _erf_f32(h * 0.7071067811865476))
    o = torch.matmul(h.to(dt).float(), f32(w2).t())
    o = (o + f32(b2)) * f32(ls2)
    return (xf + o).to(dt)


def fused_ln_mlp(x, ln_scale, ln_bias, w1, b1, w2, b2, ls2, eps: float = 1e-6,
                 gelu: str = "tanh"):
    """``x + ls2 * fc2(gelu(fc1(ln(x))))`` in one kernel. x: (..., D);
    w1: (F, D); w2: (D, F); the vectors (D,) or (F,)."""
    d = x.shape[-1]
    f = w1.shape[0]
    if w1.shape != (f, d) or w2.shape != (d, f) or b1.shape != (f,) \
            or any(t.shape != (d,) for t in (ln_scale, ln_bias, b2, ls2)):
        raise ValueError(f"fused_ln_mlp: shapes do not match x (..., {d}) and w1 {tuple(w1.shape)}")
    tanh = _use_tanh(x.dtype, gelu)
    if _build.device_type(x) == "cpu":
        return fused_ln_mlp_plain(x, ln_scale, ln_bias, w1, b1, w2, b2, ls2, eps, gelu)
    dt = x.dtype
    params = [t.to(dt).contiguous() for t in (ln_scale, ln_bias, w1, b1, w2, b2, ls2)]
    _build.check_cuda_operands("fused_ln_mlp", x, *params)
    widths = (64, 384, 768, 1024) if dt == torch.bfloat16 else range(8, 1025, 8)
    if d not in widths or f % 64:
        raise ValueError("fused_ln_mlp: the CUDA kernel takes D in (64, 384, 768, 1024) for "
                         "bfloat16, D % 8 == 0 and D <= 1024 for float32, and F % 64 == 0; "
                         f"got D={d}, F={f}")
    rows = x.numel() // d
    lib = _build.load("fused_ln_mlp")
    fn = lib.cs_fused_ln_mlp
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + [ctypes.c_float] \
        + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(x.data_ptr(), *(t.data_ptr() for t in params), out.data_ptr(), rows, d, f,
            float(eps), int(tanh), _build.DTYPE_CODES[str(dt)], stream)
    _build.check_rc(lib, rc, "fused_ln_mlp")
    fused_ln_mlp.launches += 1
    return out


fused_ln_mlp.launches = 0


# --- K10: K2 with the attention half's LayerScale residual folded in ---------


def fused_res_ln_mlp_plain(x, attn, ls1, ln_scale, ln_bias, w1, b1, w2, b2, ls2, eps: float = 1e-6):
    """Plain version of K10 with the kernel's casts: x2 = x + attn * ls1 in
    fp32 (ls1 in x's dtype), then K2's body on x2 with x2 added unrounded."""
    dt = x.dtype
    x2 = x.float() + attn.float() * ls1.to(dt).float()
    return _ln_mlp_body(x2, dt, ln_scale, ln_bias, w1, b1, w2, b2, ls2, eps, "tanh")


def _reference_res(x, attn, ls1, ln_scale, ln_bias, w1, b1, w2, b2, ls2, eps: float = 1e-6):
    """The JAX ``_reference_res_xla``, K10's backward recompute: x2 = x +
    attn * ls1 in fp32 rounded to x's dtype, then the unfused block half
    (``_reference_xla``) with exact erf, the products in x's dtype with fp32
    accumulation."""
    dt = x.dtype
    xf = (x.float() + attn.float() * ls1.float()).to(dt).float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = (y * ln_scale.float() + ln_bias.float()).to(dt)
    h = torch.matmul(y.float(), w1.to(dt).float().t()) + b1.float()
    h = 0.5 * h * (1.0 + torch.erf(h * 0.7071067811865476))
    o = torch.matmul(h.to(dt).float(), w2.to(dt).float().t())
    o = (o + b2.float()) * ls2.float()
    return (xf + o).to(dt)


def _launch_res(x, attn, ls1, ln_scale, ln_bias, w1, b1, w2, b2, ls2, eps):
    """Launch K10 on CUDA tensors -> out, x's shape and dtype."""
    what = "fused_res_ln_mlp"
    dt = x.dtype
    d = x.shape[-1]
    f = w1.shape[0]
    params = [t.to(dt).contiguous() for t in (ls1, ln_scale, ln_bias, w1, b1, w2, b2, ls2)]
    _build.check_cuda_operands(what, x, attn, *params)
    widths = (64, 384) if dt == torch.bfloat16 else range(8, 1025, 8)
    if d not in widths or f % 64:
        raise ValueError(f"{what}: the CUDA kernel takes D in (64, 384) for bfloat16, D % 8 == 0 and "
                         f"D <= 1024 for float32, and F % 64 == 0; got D={d}, F={f}")
    lib = _build.load("fused_ln_mlp")
    fn = lib.cs_fused_res_ln_mlp
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(x.data_ptr(), attn.data_ptr(), *(t.data_ptr() for t in params), out.data_ptr(), x.numel() // d, d, f,
            float(eps), _build.DTYPE_CODES[str(dt)], stream)
    _build.check_rc(lib, rc, what)
    fused_res_ln_mlp.launches += 1
    return out


class _FusedResLnMlp(torch.autograd.Function):
    """K10 forward; the backward recomputes through :func:`_reference_res`,
    as the JAX ``_frlm_bwd`` does, and returns the ten gradients. In bf16 the
    backward therefore differentiates the exact-erf form while the forward
    runs the tanh form (a deviation inside the reference)."""

    @staticmethod
    def forward(ctx, x, attn, ls1, ln_scale, ln_bias, w1, b1, w2, b2, ls2, eps):
        args = (x, attn, ls1, ln_scale, ln_bias, w1, b1, w2, b2, ls2)
        ctx.save_for_backward(*args)
        ctx.eps = eps
        if _build.device_type(x) == "cpu":
            return fused_res_ln_mlp_plain(*args, eps)
        return _launch_res(*args, eps)

    @staticmethod
    def backward(ctx, g):
        args = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = _reference_res(*args, ctx.eps)
        grads = torch.autograd.grad(out, args, g)
        return (*grads, None)


def fused_res_ln_mlp(x, attn, ls1, ln_scale, ln_bias, w1, b1, w2, b2, ls2, eps: float = 1e-6):
    """``x2 + ls2 * fc2(gelu(fc1(ln(x2))))`` with ``x2 = x + attn * ls1`` in
    one kernel (K10), differentiable in all ten tensors. x, attn: (..., D);
    w1: (F, D); w2: (D, F); the vectors (D,) or (F,)."""
    d = x.shape[-1]
    f = w1.shape[0]
    if attn.shape != x.shape or w1.shape != (f, d) or w2.shape != (d, f) or b1.shape != (f,) \
            or any(t.shape != (d,) for t in (ls1, ln_scale, ln_bias, b2, ls2)):
        raise ValueError(f"fused_res_ln_mlp: shapes do not match x (..., {d}) and w1 {tuple(w1.shape)}")
    return _FusedResLnMlp.apply(x, attn, ls1, ln_scale, ln_bias, w1, b1, w2, b2, ls2, eps)


fused_res_ln_mlp.launches = 0
