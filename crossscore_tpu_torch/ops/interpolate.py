"""2D interpolation with torch-compatible coordinate semantics; counterpart of
``crossscore_tpu/ops/interpolate.py`` (static forms only).

- ``interpolate_bilinear_align_corners`` resizes the multi-view positional
  table (reference ``model/positional_encoding.py:61-69``).
- ``interpolate_bicubic`` resizes the ViT position table off its native grid
  (HF DINOv2: bicubic, align_corners=False, a=-0.75). It applies the same
  numpy interpolation matrices as the JAX package, so both packages use one
  set of weights whatever ``F.interpolate``'s size and scale rules are.
- ``resize_bilinear_antialias`` resizes host-side numpy images in the input
  pipeline (torchvision ``Resize(antialias=True)`` semantics).
"""

from __future__ import annotations

import numpy as np
import torch


def _align_corners_axis(in_size: int, out_size: int):
    if out_size == 1:
        coords = np.zeros((1,), dtype=np.float64)
    else:
        coords = np.arange(out_size, dtype=np.float64) * (in_size - 1) / (out_size - 1)
    lo = np.clip(np.floor(coords).astype(np.int64), 0, in_size - 1)
    hi = np.clip(lo + 1, 0, in_size - 1)
    frac = (coords - lo).astype(np.float32)
    return lo, hi, frac


def interpolate_bilinear_align_corners(src: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize of (H, W, C), ``align_corners=True``: the source
    coordinate of output index i is ``i * (in-1)/(out-1)`` (0 when out == 1)."""
    in_h, in_w, _ = src.shape
    dev = src.device
    lo_h, hi_h, fh = _align_corners_axis(in_h, out_h)
    lo_w, hi_w, fw = _align_corners_axis(in_w, out_w)
    fh = torch.from_numpy(fh).to(dev, src.dtype)
    fw = torch.from_numpy(fw).to(dev, src.dtype)
    top = src[torch.from_numpy(lo_h).to(dev)]  # (out_h, in_w, C)
    bot = src[torch.from_numpy(hi_h).to(dev)]
    rows = top + (bot - top) * fh[:, None, None]
    left = rows[:, torch.from_numpy(lo_w).to(dev)]  # (out_h, out_w, C)
    right = rows[:, torch.from_numpy(hi_w).to(dev)]
    return left + (right - left) * fw[None, :, None]


def _cubic_kernel(t: np.ndarray, a: float = -0.75) -> np.ndarray:
    """torch/PIL cubic convolution kernel (Keys, a=-0.75 matches torch)."""
    t = np.abs(t)
    return np.where(
        t <= 1,
        (a + 2) * t**3 - (a + 3) * t**2 + 1,
        np.where(t < 2, a * t**3 - 5 * a * t**2 + 8 * a * t - 4 * a, 0.0),
    )


def _bicubic_axis_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) interpolation matrix, align_corners=False."""
    scale = in_size / out_size
    coords = (np.arange(out_size, dtype=np.float64) + 0.5) * scale - 0.5
    base = np.floor(coords).astype(np.int64)
    mat = np.zeros((out_size, in_size), dtype=np.float32)
    for tap in range(-1, 3):
        idx = np.clip(base + tap, 0, in_size - 1)
        w = _cubic_kernel(coords - (base + tap))
        np.add.at(mat, (np.arange(out_size), idx), w.astype(np.float32))
    return mat


def interpolate_bicubic(src: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bicubic resize of (H, W, C) in fp32, align_corners=False, no antialias."""
    in_h, in_w, _ = src.shape
    mh = torch.from_numpy(_bicubic_axis_matrix(in_h, out_h)).to(src.device)
    mw = torch.from_numpy(_bicubic_axis_matrix(in_w, out_w)).to(src.device)
    out = torch.einsum("oi,iwc->owc", mh, src.float())
    out = torch.einsum("pw,owc->opc", mw, out)
    return out.to(src.dtype)


def resize_bilinear_antialias(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Antialiased bilinear resize for host-side numpy images (H, W, C) or (H, W).

    Matches torchvision ``Resize(..., antialias=True)`` semantics (triangle
    filter scaled by the downsampling factor). Used by the input pipeline.
    """
    squeeze = img.ndim == 2
    if squeeze:
        img = img[:, :, None]
    in_h, in_w, _ = img.shape

    def axis_matrix(in_size: int, out_size: int) -> np.ndarray:
        scale = in_size / out_size
        support = max(scale, 1.0)
        coords = (np.arange(out_size, dtype=np.float64) + 0.5) * scale - 0.5
        lo = np.floor(coords - support).astype(np.int64)
        taps = int(np.ceil(2 * support)) + 2
        mat = np.zeros((out_size, in_size), dtype=np.float64)
        for tap in range(taps):
            idx = lo + tap
            w = np.maximum(0.0, 1.0 - np.abs((coords - idx) / support))
            # torch drops out-of-range taps (no edge clamping) and renormalises
            valid = (idx >= 0) & (idx < in_size)
            rows = np.arange(out_size)[valid]
            np.add.at(mat, (rows, idx[valid]), w[valid])
        mat /= mat.sum(axis=1, keepdims=True)
        return mat.astype(np.float32)

    mh = axis_matrix(in_h, out_h)
    mw = axis_matrix(in_w, out_w)
    out = np.einsum("oi,iwc->owc", mh, img.astype(np.float32))
    out = np.einsum("pw,owc->opc", mw, out)
    if squeeze:
        out = out[:, :, 0]
    return out
