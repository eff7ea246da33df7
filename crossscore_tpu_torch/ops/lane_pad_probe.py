"""K12: the decoder backward's five matrix products without its
transcendentals, at four head-slice geometries of a 128-lane block; the
counterpart of the inline Pallas kernel of the TPU tool
``tools/lane_pad_probe.py`` (``probe_kernel``), a timing instrument that no
model path calls.

For each batch item and each head slice of the block (two slices of width
``hd`` at lane offsets 0 and ``stride``; one at hd 128), with c1 = 0.1442695::

    s = q k^T, dp = do v^T, pb = bf16(s c1), dsb = bf16(dp c1)
    dq = dsb k, dk = dsb^T q, dv = pb^T do      (fp32 sums, bf16 out)

Lanes outside the slices are not part of the function: the CUDA kernel
(``csrc/lane_pad_probe.cu``) leaves them unwritten, the plain version zero.
On a CUDA tensor :func:`lane_pad_probe` launches the kernel or raises; on a
CPU tensor it runs :func:`lane_pad_probe_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from crossscore_tpu_torch.ops import _build

LANES = 128
C1 = 0.1442695  # the TPU tool's stand-in scale
# name -> (slice width, lane stride), the TPU tool's four geometries: the
# decoder's current padded packing, hd 48 packed without padding, hd 48 at
# the 64-lane offsets, and one 128-wide contraction (the products' ceiling)
GEOMETRIES = {"hd64_current": (64, 64), "hd48_nopad": (48, 48), "hd48_off64": (48, 64),
              "hd128_fused": (128, 128)}


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def probe_shapes(b: int, k_views: int, cpu: bool = False) -> tuple[int, int]:
    """(nq_p, nk_p), the TPU tool's padded token counts: its q chunking of
    the backward (``_bwd_cross_ln_pallas``: 300,000-element chunks of 512-key
    blocks; 1392 at Nq 1369) and its KV blocks (7168 at K=5). ``cpu``: the
    tool's ``--cpu`` shapes (one view, 64 queries, two 128-key blocks)."""
    if cpu:
        nq, nk, block_k = 64, 256, 128
    else:
        nq, nk, block_k = 1369, k_views * 1369, 512
    q_chunks = max(1, -(-nq * block_k // 300_000))
    cq = _ceil_to(-(-nq // q_chunks), 8)
    return cq * q_chunks, _ceil_to(nk, block_k)


def slices(geometry: str) -> list[tuple[int, int]]:
    """The (first, last + 1) lanes of each head slice of ``geometry``."""
    hd, stride = GEOMETRIES[geometry]
    return [(j * stride, j * stride + hd) for j in range(1 if hd == LANES else 2)]


def useful_flops(b: int, nq_p: int, nk_p: int, geometry: str) -> float:
    """The five products' operations at the slices' own width (the TPU tool
    counts hd 48 for every geometry; at hd 64 and 128 this counts the work
    the geometry does)."""
    return 10.0 * b * nq_p * nk_p * sum(hi - lo for lo, hi in slices(geometry))


def _check(qp, dop, kp, vp, geometry: str) -> None:
    if geometry not in GEOMETRIES:
        raise ValueError(f"geometry must be one of {sorted(GEOMETRIES)}, got {geometry!r}")
    b, nq, lanes = qp.shape
    if lanes != LANES or dop.shape != qp.shape or kp.ndim != 3 or kp.shape[0] != b or kp.shape[2] != LANES \
            or vp.shape != kp.shape:
        raise ValueError(f"q/do (B, Nq, {LANES}) and k/v (B, Nk, {LANES}) expected, got "
                         f"{tuple(qp.shape)}, {tuple(dop.shape)}, {tuple(kp.shape)}, {tuple(vp.shape)}")


def lane_pad_probe_plain(qp, dop, kp, vp, geometry: str):
    """Plain version of K12, the TPU body step by step: fp32 products of the
    slices, pb and dsb rounded to the input dtype, fp32 sums -> (dq, dk, dv)
    in the input dtype, zero outside the slices."""
    _check(qp, dop, kp, vp, geometry)
    dt = qp.dtype
    dq, dk, dv = torch.zeros_like(qp), torch.zeros_like(kp), torch.zeros_like(vp)
    for lo, hi in slices(geometry):
        q, do, k, v = (t[..., lo:hi].float() for t in (qp, dop, kp, vp))
        pb = (torch.matmul(q, k.transpose(1, 2)) * C1).to(dt).float()
        dsb = (torch.matmul(do, v.transpose(1, 2)) * C1).to(dt).float()
        dq[..., lo:hi] = torch.matmul(dsb, k).to(dt)
        dk[..., lo:hi] = torch.matmul(dsb.transpose(1, 2), q).to(dt)
        dv[..., lo:hi] = torch.matmul(pb.transpose(1, 2), do).to(dt)
    return dq, dk, dv


def lane_pad_probe(qp, dop, kp, vp, geometry: str):
    """K12 at ``geometry`` (a key of :data:`GEOMETRIES`): qp, dop (B, Nq,
    128) and kp, vp (B, Nk, 128) bf16 -> (dq, dk, dv), their shapes, defined
    on the slices' lanes only."""
    what = "lane_pad_probe"
    _check(qp, dop, kp, vp, geometry)
    if _build.device_type(qp) == "cpu":
        return lane_pad_probe_plain(qp, dop, kp, vp, geometry)
    _build.check_cuda_operands(what, qp, dop, kp, vp)
    if qp.dtype != torch.bfloat16:
        raise ValueError(f"{what}: the CUDA kernel takes bfloat16, got {qp.dtype}")
    if qp.shape[0] > 65535:
        raise ValueError(f"{what}: batch must be < 65536")
    b, nq, _ = qp.shape
    nk = kp.shape[1]
    hd, stride = GEOMETRIES[geometry]
    dq, dk, dv = torch.empty_like(qp), torch.empty_like(kp), torch.empty_like(vp)
    lib = _build.load("lane_pad_probe")
    fn = lib.cs_lane_pad_probe
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(qp.device).cuda_stream
    rc = fn(qp.data_ptr(), dop.data_ptr(), kp.data_ptr(), vp.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), b, nq, nk, LANES, len(slices(geometry)), hd, stride, C1, stream)
    _build.check_rc(lib, rc, what)
    lane_pad_probe.launches += 1
    lane_pad_probe.launches_by_mode[geometry] += 1
    return dq, dk, dv


lane_pad_probe.launches = 0
lane_pad_probe.launches_by_mode = dict.fromkeys(GEOMETRIES, 0)
