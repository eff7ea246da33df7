"""W8A8 dynamic int8 linear for the frozen backbone (``model.gpu.backbone_quant=int8``);
counterpart of ``crossscore_tpu/ops/quant.py``.

Scheme, as the JAX package's:

- every row of x (a token) gets a symmetric scale ``s = max(absmax, 1e-8) / 127``
  (an fp32 division) and int8 codes ``clamp(round_half_even(x / s), -127, 127)``;
- the weight, torch ``Linear`` layout (N, K), gets the same per output channel
  (row), so JAX's ``quantize_colwise`` of its (K, N) kernel is this module's
  :func:`quantize_rowwise` of the (N, K) weight;
- the product is exact in int32, dequantised as ``(float(acc) * sx) * sw``,
  rounded once to x's dtype, then the bias is added in x's dtype.

Two kernels of the port's own, with no Pallas counterpart (XLA lowers the JAX
path): Q1 (:func:`quantize_rowwise`) and Q2 (:func:`int8_linear`), both in
``csrc/int8_linear.cu``. On a CUDA tensor each launches its kernel or raises;
on a CPU tensor each runs its plain version. ``torch._int_mm`` writes the int32
products to memory (4 bytes an element), so Q2 keeps them in registers and
applies the dequantisation in its epilogue; ``torch._int_mm`` stays the plain
version's product and the yardstick.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from crossscore_tpu_torch.ops import _build

BACKBONE_QUANTS = ("none", "int8")
EPS = 1e-8
QMAX = 127.0
# the widths Q2 takes: the int8 product's depth (mma m16n8k32) and the
# output's column pairs
K_MULTIPLE = 32
N_MULTIPLE = 8


def check_quant(quant: str) -> str:
    """``quant`` if it names a backbone mode; ValueError otherwise."""
    if quant not in BACKBONE_QUANTS:
        raise ValueError(f"unknown backbone_quant {quant!r} (expected none|int8)")
    return quant


# --- plain versions -----------------------------------------------------------


def quantize_rowwise_plain(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., K) float -> int8 codes (..., K) and fp32 scales (..., 1)."""
    xf = x.float()
    m = xf.abs().amax(dim=-1, keepdim=True).clamp_min(EPS)
    # divided by a tensor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, one ulp off the division on some rows
    s = m / torch.full_like(m, QMAX)
    q = torch.round(xf / s).clamp(-QMAX, QMAX).to(torch.int8)
    return q, s


def _int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M, K) int8 times b (N, K) int8 transposed -> (M, N) int32, exact.
    cuBLASLt's int8 product takes M > 16, so a short a is padded with zero rows."""
    m = a.shape[0]
    if a.device.type == "cuda" and m <= 16:
        a = F.pad(a, (0, 0, 0, 17 - m))
    return torch._int_mm(a, b.t())[:m]


def int8_product_plain(xq, sx, wq, sw, bias=None, dtype=torch.float32) -> torch.Tensor:
    """Plain version of Q2: codes xq (..., K) with scales sx (..., 1) and wq
    (N, K) with sw (N, 1) -> ``(float(xq @ wq^T) * sx) * sw`` rounded to
    ``dtype``, then ``+ bias`` (N,) in ``dtype``."""
    lead, k = xq.shape[:-1], xq.shape[-1]
    acc = _int_mm(xq.reshape(-1, k), wq)
    y = (acc.float() * sx.reshape(-1, 1).float()) * sw.reshape(1, -1).float()
    y = y.to(dtype).reshape(*lead, wq.shape[0])
    return y if bias is None else y + bias.to(dtype)


def int8_linear_plain(x: torch.Tensor, weight: torch.Tensor, bias=None) -> torch.Tensor:
    """Plain version of the W8A8 linear: x (..., K) float, weight (N, K)
    (quantised from its own dtype: the fp32 parameter), bias (N,) -> (..., N)
    in x's dtype."""
    xq, sx = quantize_rowwise_plain(x)
    wq, sw = quantize_rowwise_plain(weight)
    return int8_product_plain(xq, sx, wq, sw, bias, x.dtype)


# --- the kernels ----------------------------------------------------------------


def _launch_q1(x: torch.Tensor, qmax: float = QMAX) -> tuple[torch.Tensor, torch.Tensor]:
    """Q1 on a CUDA tensor, uncounted. ``qmax`` is 127 on every path; another
    value plants a wrong scale (``chip_smoke.py`` checks that it is caught)."""
    k = x.shape[-1]
    if k <= 0 or k % 4:
        raise ValueError(f"quantize_rowwise: the CUDA kernel takes K % 4 == 0, got K={k}")
    x = x.contiguous()
    _build.check_cuda_operands("quantize_rowwise", x)
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    s = torch.empty((*x.shape[:-1], 1), dtype=torch.float32, device=x.device)
    lib = _build.load("int8_linear")
    fn = lib.cs_quantize_rows
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(x.data_ptr(), q.data_ptr(), s.data_ptr(), x.numel() // k, k, float(qmax),
            _build.DTYPE_CODES[str(x.dtype)], stream)
    _build.check_rc(lib, rc, "quantize_rowwise")
    return q, s


def quantize_rowwise(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Q1: (..., K) float32 or bfloat16 -> int8 codes (..., K) and fp32
    scales (..., 1), one warp a row."""
    if _build.device_type(x) == "cpu":
        return quantize_rowwise_plain(x)
    out = _launch_q1(x)
    quantize_rowwise.launches += 1
    return out


quantize_rowwise.launches = 0


def _operand(t, what: str):
    """A float tensor, quantised by Q1, or a (codes, scales) pair as it is."""
    if isinstance(t, (tuple, list)):
        q, s = t
        if q.dtype != torch.int8 or s.dtype != torch.float32 or s.shape != (*q.shape[:-1], 1):
            raise ValueError(f"int8_linear: {what} must be int8 codes (..., K) with fp32 scales (..., 1)")
        return q, s
    return quantize_rowwise(t)


def int8_linear(x, weight, bias=None, dtype=None) -> torch.Tensor:
    """Q2, the W8A8 linear: ``x @ weight^T + bias`` through int8 codes.

    ``x`` (..., K) and ``weight`` (N, K) are float tensors, quantised here by
    Q1 (the weight from its own dtype: pass the fp32 parameter), or (codes,
    scales) pairs from :func:`quantize_rowwise`. The output has x's dtype, or
    ``dtype`` (bfloat16 or float32; required when x is a pair); ``bias`` (N,)
    is added in that dtype after the rounding. On CUDA, K % 32 == 0 and
    N % 8 == 0, else ValueError."""
    pair = isinstance(x, (tuple, list))
    if dtype is None:
        if pair:
            raise ValueError("int8_linear: pass dtype when x is already quantised")
        dtype = x.dtype
    if str(dtype) not in _build.DTYPE_CODES:
        raise ValueError(f"int8_linear: the output is float32 or bfloat16, got {dtype}")
    xt, wt = x[0] if pair else x, weight[0] if isinstance(weight, (tuple, list)) else weight
    k, n = xt.shape[-1], wt.shape[0]
    if wt.dim() != 2 or wt.shape[1] != k or (bias is not None and bias.shape != (n,)):
        raise ValueError(f"int8_linear: x (..., {k}) does not match weight {tuple(wt.shape)}")
    cpu = _build.device_type(xt) == "cpu"
    if not cpu and (k % K_MULTIPLE or n % N_MULTIPLE):
        raise ValueError(f"int8_linear: the CUDA kernel takes K % {K_MULTIPLE} == 0 and N % {N_MULTIPLE} == 0, "
                         f"got K={k}, N={n}")
    xq, sx = _operand(x, "x")
    wq, sw = _operand(weight, "weight")
    if cpu:
        return int8_product_plain(xq, sx, wq, sw, bias, dtype)
    operands = [t.contiguous() for t in (xq, sx, wq, sw)]
    b = None if bias is None else bias.to(dtype).contiguous()
    for t in operands + ([b] if b is not None else []):
        if t.device != xq.device or t.data_ptr() % 16:
            raise ValueError("int8_linear: operands must share one CUDA device and be 16-byte aligned")
    m = xq.numel() // k
    out = torch.empty((*xq.shape[:-1], n), dtype=dtype, device=xq.device)
    lib = _build.load("int8_linear")
    fn = lib.cs_int8_linear
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(xq.device).cuda_stream
    rc = fn(*(t.data_ptr() for t in operands), 0 if b is None else b.data_ptr(), out.data_ptr(), m, n, k,
            _build.DTYPE_CODES[str(dtype)], stream)
    _build.check_rc(lib, rc, "int8_linear")
    int8_linear.launches += 1
    return out


int8_linear.launches = 0
