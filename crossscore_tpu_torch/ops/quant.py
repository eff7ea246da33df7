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

The tensor-parallel row layer (``parallel/tensor_parallel.py``) holds a shard
of each row's features, so it takes Q1 and Q2 apart: Q1a
(:func:`row_absmax`) gives each row's absmax, which the layer max-reduces over
its group; Q1b (:func:`quantize_rowwise_given`) quantises from that absmax;
Q2's int32 form (:func:`int8_matmul_s32`) gives the exact partial products,
which the layer sums, then :func:`dequantize_s32` applies Q2's epilogue.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from crossscore_tpu_torch.ops import _build

BACKBONE_QUANTS = ("none", "int8")
EPS = 1e-8
QMAX = 127.0
# the widths Q2 takes: the int8 product's depth (wgmma k32), and whole
# column pairs and 16-byte output rows (TMA's strides)
K_MULTIPLE = 32
N_MULTIPLE = 8


def check_quant(quant: str) -> str:
    """``quant`` if it names a backbone mode; ValueError otherwise."""
    if quant not in BACKBONE_QUANTS:
        raise ValueError(f"unknown backbone_quant {quant!r} (expected none|int8)")
    return quant


# --- plain versions -----------------------------------------------------------


def row_absmax_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of Q1a: (..., K) float -> fp32 max |x| of each row (..., 1)."""
    return x.float().abs().amax(dim=-1, keepdim=True)


def quantize_rowwise_given_plain(x: torch.Tensor, m: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of Q1b: (..., K) float and each row's absmax m (..., 1)
    fp32 -> int8 codes (..., K) and fp32 scales ``max(m, 1e-8) / 127`` (..., 1)."""
    m = m.float().clamp_min(EPS)
    # divided by a tensor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, one ulp off the division on some rows
    s = m / torch.full_like(m, QMAX)
    q = torch.round(x.float() / s).clamp(-QMAX, QMAX).to(torch.int8)
    return q, s


def quantize_rowwise_plain(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., K) float -> int8 codes (..., K) and fp32 scales (..., 1)."""
    return quantize_rowwise_given_plain(x, row_absmax_plain(x))


def _int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M, K) int8 times b (N, K) int8 transposed -> (M, N) int32, exact.
    cuBLASLt's int8 product takes M > 16, so a short a is padded with zero rows."""
    m = a.shape[0]
    if a.device.type == "cuda" and m <= 16:
        a = F.pad(a, (0, 0, 0, 17 - m))
    return torch._int_mm(a, b.t())[:m]


def int8_matmul_s32_plain(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """Plain version of Q2's int32 form: codes xq (..., K) times wq (N, K)
    transposed -> (..., N) int32, exact."""
    lead, k = xq.shape[:-1], xq.shape[-1]
    return _int_mm(xq.reshape(-1, k), wq).reshape(*lead, wq.shape[0])


def dequantize_s32(acc: torch.Tensor, sx: torch.Tensor, sw: torch.Tensor, bias=None,
                   dtype=torch.float32) -> torch.Tensor:
    """Q2's epilogue on int32 products acc (..., N) with scales sx (..., 1)
    and sw (N, 1): ``(float(acc) * sx) * sw`` in fp32, rounded once to
    ``dtype``, then ``+ bias`` (N,) in ``dtype``; each step a separate
    rounding, as the kernel's (no fused multiply-add)."""
    y = (acc.float() * sx.float()) * sw.reshape(-1).float()
    y = y.to(dtype)
    return y if bias is None else y + bias.to(dtype)


def int8_product_plain(xq, sx, wq, sw, bias=None, dtype=torch.float32) -> torch.Tensor:
    """Plain version of Q2: codes xq (..., K) with scales sx (..., 1) and wq
    (N, K) with sw (N, 1) -> ``(float(xq @ wq^T) * sx) * sw`` rounded to
    ``dtype``, then ``+ bias`` (N,) in ``dtype``."""
    return dequantize_s32(int8_matmul_s32_plain(xq, wq), sx, sw, bias, dtype)


def int8_linear_plain(x: torch.Tensor, weight: torch.Tensor, bias=None) -> torch.Tensor:
    """Plain version of the W8A8 linear: x (..., K) float, weight (N, K)
    (quantised from its own dtype: the fp32 parameter), bias (N,) -> (..., N)
    in x's dtype."""
    xq, sx = quantize_rowwise_plain(x)
    wq, sw = quantize_rowwise_plain(weight)
    return int8_product_plain(xq, sx, wq, sw, bias, x.dtype)


# --- the kernels ----------------------------------------------------------------


def _rows_entry(what: str, x: torch.Tensor, name: str, argtypes: list):
    """Checks shared by Q1, Q1a and Q1b -> (contiguous x, K, the library, its C
    function ``name``)."""
    k = x.shape[-1]
    if k <= 0 or k % 4:
        raise ValueError(f"{what}: the CUDA kernel takes K % 4 == 0, got K={k}")
    x = x.contiguous()
    _build.check_cuda_operands(what, x)
    lib = _build.load("int8_linear")
    fn = getattr(lib, name)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return x, k, lib, fn


def _launch_q1(x: torch.Tensor, qmax: float = QMAX) -> tuple[torch.Tensor, torch.Tensor]:
    """Q1 on a CUDA tensor, uncounted. ``qmax`` is 127 on every path; another
    value plants a wrong scale (``chip_smoke.py`` checks that it is caught)."""
    x, k, lib, fn = _rows_entry("quantize_rowwise", x, "cs_quantize_rows",
                                [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                                                         ctypes.c_void_p])
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    s = torch.empty((*x.shape[:-1], 1), dtype=torch.float32, device=x.device)
    rc = fn(x.data_ptr(), q.data_ptr(), s.data_ptr(), x.numel() // k, k, float(qmax),
            _build.DTYPE_CODES[str(x.dtype)], torch.cuda.current_stream(x.device).cuda_stream)
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


def row_absmax(x: torch.Tensor) -> torch.Tensor:
    """Q1a: (..., K) float32 or bfloat16 -> the fp32 max |x| of each row
    (..., 1), one warp a row."""
    if _build.device_type(x) == "cpu":
        return row_absmax_plain(x)
    x, k, lib, fn = _rows_entry("row_absmax", x, "cs_row_absmax", [ctypes.c_void_p, ctypes.c_void_p,
                                                                   ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                                                   ctypes.c_void_p])
    m = torch.empty((*x.shape[:-1], 1), dtype=torch.float32, device=x.device)
    rc = fn(x.data_ptr(), m.data_ptr(), x.numel() // k, k, _build.DTYPE_CODES[str(x.dtype)],
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check_rc(lib, rc, "row_absmax")
    row_absmax.launches += 1
    return m


row_absmax.launches = 0


def quantize_rowwise_given(x: torch.Tensor, m: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Q1b: (..., K) float32 or bfloat16 and each row's absmax m (..., 1)
    fp32 -> Q1's int8 codes (..., K) and fp32 scales (..., 1) at
    ``max(m, 1e-8) / 127``. After :func:`row_absmax` of the same rows it is
    :func:`quantize_rowwise` bit for bit."""
    if m.dtype != torch.float32 or m.shape != (*x.shape[:-1], 1):
        raise ValueError(f"quantize_rowwise_given: m must be fp32 {(*x.shape[:-1], 1)}, got {m.dtype} "
                         f"{tuple(m.shape)}")
    if _build.device_type(x) == "cpu":
        return quantize_rowwise_given_plain(x, m)
    x, k, lib, fn = _rows_entry("quantize_rowwise_given", x, "cs_quantize_rows_given",
                                [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                                         ctypes.c_void_p])
    m = m.contiguous()
    if m.device != x.device:
        raise ValueError("quantize_rowwise_given: x and m must share one CUDA device")
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    s = torch.empty_like(m)
    rc = fn(x.data_ptr(), m.data_ptr(), q.data_ptr(), s.data_ptr(), x.numel() // k, k,
            _build.DTYPE_CODES[str(x.dtype)], torch.cuda.current_stream(x.device).cuda_stream)
    _build.check_rc(lib, rc, "quantize_rowwise_given")
    quantize_rowwise_given.launches += 1
    return q, s


quantize_rowwise_given.launches = 0


def _check_q2_widths(what: str, k: int, n: int) -> None:
    if k % K_MULTIPLE or n % N_MULTIPLE:
        raise ValueError(f"{what}: the CUDA kernel takes K % {K_MULTIPLE} == 0 and N % {N_MULTIPLE} == 0, "
                         f"got K={k}, N={n}")


def _q2_operands(what: str, *tensors) -> list:
    """Q2's operands, contiguous; raises unless they share one CUDA device
    and are 16-byte aligned."""
    out = [t.contiguous() for t in tensors]
    for t in out:
        if t.device != out[0].device or t.data_ptr() % 16:
            raise ValueError(f"{what}: operands must share one CUDA device and be 16-byte aligned")
    return out


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
    if not cpu:
        _check_q2_widths("int8_linear", k, n)
    xq, sx = _operand(x, "x")
    wq, sw = _operand(weight, "weight")
    if cpu:
        return int8_product_plain(xq, sx, wq, sw, bias, dtype)
    operands = _q2_operands("int8_linear", xq, sx, wq, sw, *(() if bias is None else (bias.to(dtype),)))
    b = operands.pop() if bias is not None else None
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


def int8_matmul_s32(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """Q2's int32 form: int8 codes xq (..., K) times wq (N, K) transposed ->
    the exact int32 products (..., N), not dequantised (Q2's main loop, its
    accumulators stored as they are). On CUDA, K % 32 == 0 and N % 8 == 0,
    else ValueError."""
    k, n = xq.shape[-1], wq.shape[0]
    if xq.dtype != torch.int8 or wq.dtype != torch.int8 or wq.dim() != 2 or wq.shape[1] != k:
        raise ValueError(f"int8_matmul_s32: int8 codes (..., K) and (N, K), got {xq.dtype} {tuple(xq.shape)} and "
                         f"{wq.dtype} {tuple(wq.shape)}")
    if _build.device_type(xq) == "cpu":
        return int8_matmul_s32_plain(xq, wq)
    _check_q2_widths("int8_matmul_s32", k, n)
    a, w = _q2_operands("int8_matmul_s32", xq, wq)
    out = torch.empty((*a.shape[:-1], n), dtype=torch.int32, device=a.device)
    lib = _build.load("int8_linear")
    fn = lib.cs_int8_matmul_s32
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(a.data_ptr(), w.data_ptr(), out.data_ptr(), a.numel() // k, n, k,
            torch.cuda.current_stream(a.device).cuda_stream)
    _build.check_rc(lib, rc, "int8_matmul_s32")
    int8_matmul_s32.launches += 1
    return out


int8_matmul_s32.launches = 0
