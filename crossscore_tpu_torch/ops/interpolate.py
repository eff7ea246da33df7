"""2D interpolation with torch-compatible coordinate semantics; counterpart of
``crossscore_tpu/ops/interpolate.py``.

- ``interpolate_bilinear_align_corners`` resizes the multi-view positional
  table (reference ``model/positional_encoding.py:61-69``).
- ``interpolate_bicubic`` resizes the ViT position table off its native grid
  (HF DINOv2: bicubic, align_corners=False, a=-0.75). It applies the same
  numpy interpolation matrices as the JAX package, so both packages use one
  set of weights whatever ``F.interpolate``'s size and scale rules are.
- The ``_dyn`` forms serve shape-bucketed inference: a padded (out_h, out_w)
  grid whose top-left (valid_h, valid_w) region holds the resize to the valid
  grid, one valid size shared by the batch or one per item. The valid sizes
  come from the host loader, so the matrices are built on the host, as the
  static forms' are, with no device sync; rows and columns past the valid
  extent are zero (those tokens are masked out of every attention).
- ``resize_bilinear_antialias`` resizes host-side numpy images in the input
  pipeline (torchvision ``Resize(antialias=True)`` semantics).
"""

from __future__ import annotations

import functools

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


def _bilinear_align_corners_matrix(in_size: int, out_size: int, valid: int) -> np.ndarray:
    """(out_size, in_size) align_corners=True matrix resizing to ``valid``
    outputs; rows at and past ``valid`` are zero."""
    lo, hi, frac = _align_corners_axis(in_size, int(valid))
    mat = np.zeros((out_size, in_size), dtype=np.float32)
    rows = np.arange(int(valid))
    np.add.at(mat, (rows, lo), 1.0 - frac)
    np.add.at(mat, (rows, hi), frac)
    return mat


def _per_item(valid, build) -> np.ndarray:
    """One matrix for a scalar valid size, a stack of (B, ...) for a 1-D one."""
    if np.ndim(valid) == 0:
        return build(int(valid))
    return np.stack([build(int(v)) for v in np.asarray(valid)])


def _apply_axes(src: torch.Tensor, mh: np.ndarray, mw: np.ndarray) -> torch.Tensor:
    """(H, W, C) through (out_h, H) and (out_w, W) matrices, shared (2-D) or
    per item (3-D, giving (B, out_h, out_w, C)), in fp32."""
    mh = torch.from_numpy(mh).to(src.device)
    mw = torch.from_numpy(mw).to(src.device)
    x = src.float()
    if mh.ndim == 2:
        return torch.einsum("pw,owc->opc", mw, torch.einsum("oi,iwc->owc", mh, x))
    return torch.einsum("bpw,bowc->bopc", mw, torch.einsum("boi,iwc->bowc", mh, x))


def interpolate_bilinear_align_corners_dyn(src: torch.Tensor, out_h: int, out_w: int,
                                           valid_h, valid_w) -> torch.Tensor:
    """(H, W, C) -> (out_h, out_w, C) for host ints ``valid_h``/``valid_w``,
    or (B, out_h, out_w, C) for (B,) arrays of them, whose
    ``[:valid_h, :valid_w]`` region equals
    ``interpolate_bilinear_align_corners(src, valid_h, valid_w)``; zero
    elsewhere."""
    in_h, in_w, _ = src.shape
    mh = _per_item(valid_h, lambda v: _bilinear_align_corners_matrix(in_h, out_h, v))
    mw = _per_item(valid_w, lambda v: _bilinear_align_corners_matrix(in_w, out_w, v))
    return _apply_axes(src, mh, mw).to(src.dtype)


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


def _bicubic_axis_matrix_padded(in_size: int, out_size: int, valid: int) -> np.ndarray:
    """The (valid, in_size) bicubic matrix in the top rows of an
    (out_size, in_size) zero matrix."""
    mat = np.zeros((out_size, in_size), dtype=np.float32)
    mat[:valid] = _bicubic_axis_matrix(in_size, valid)
    return mat


def interpolate_bicubic(src: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bicubic resize of (H, W, C) in fp32, align_corners=False, no antialias."""
    in_h, in_w, _ = src.shape
    mh = torch.from_numpy(_bicubic_axis_matrix(in_h, out_h)).to(src.device)
    mw = torch.from_numpy(_bicubic_axis_matrix(in_w, out_w)).to(src.device)
    out = torch.einsum("oi,iwc->owc", mh, src.float())
    out = torch.einsum("pw,owc->opc", mw, out)
    return out.to(src.dtype)


def interpolate_bicubic_dyn(src: torch.Tensor, out_h: int, out_w: int, valid_h, valid_w) -> torch.Tensor:
    """Bicubic counterpart of :func:`interpolate_bilinear_align_corners_dyn`:
    the ``[:valid_h, :valid_w]`` region equals ``interpolate_bicubic(src,
    valid_h, valid_w)``; shared or per-item valid sizes; fp32 arithmetic."""
    in_h, in_w, _ = src.shape
    mh = _per_item(valid_h, lambda v: _bicubic_axis_matrix_padded(in_h, out_h, v))
    mw = _per_item(valid_w, lambda v: _bicubic_axis_matrix_padded(in_w, out_w, v))
    return _apply_axes(src, mh, mw).to(src.dtype)


def _antialias_axis_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) antialiased bilinear matrix (the JAX package's)."""
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


@functools.lru_cache(maxsize=64)
def _antialias_axis(in_size: int, out_size: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The axis matrix and its banded form, (out, T) column indices and
    weights of each row's nonzero entries in increasing column order (short
    rows padded with weight 0). Cached per size pair: an input pipeline
    resizes every image of a directory between the same sizes. The arrays are
    read-only, since every caller shares them."""
    mat = _antialias_axis_matrix(in_size, out_size)
    nz = [np.nonzero(row)[0] for row in mat]
    taps = max(len(z) for z in nz)
    idx = np.zeros((out_size, taps), np.int64)
    w = np.zeros((out_size, taps), np.float32)
    for o, z in enumerate(nz):
        idx[o, :len(z)], idx[o, len(z):], w[o, :len(z)] = z, z[-1], mat[o, z]
    for a in (mat, idx, w):
        a.setflags(write=False)
    return mat, idx, w


def resize_bilinear_antialias(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Antialiased bilinear resize for host-side numpy images (H, W, C) or (H, W).

    Matches torchvision ``Resize(..., antialias=True)`` semantics (triangle
    filter scaled by the downsampling factor). Used by the input pipeline.

    The weights are the JAX package's interpolation matrices. For images of
    several channels each axis sums its few nonzero taps in increasing order,
    which gives the JAX package's dense ``einsum`` result bit for bit (its
    loop also sums in order, and a zero product changes no float32 sum) at a
    fraction of its host time (0.07 s against 4.4 s for a 540x960 RGB image
    on one CPU core). numpy's ``einsum`` sums a single channel in another
    order, so single-channel maps keep the dense form.
    """
    squeeze = img.ndim == 2
    if squeeze:
        img = img[:, :, None]
    in_h, in_w, _ = img.shape
    mh, ih, wh = _antialias_axis(in_h, out_h)
    mw, iw, ww = _antialias_axis(in_w, out_w)
    if img.shape[2] == 1:
        out = np.einsum("oi,iwc->owc", mh, img.astype(np.float32))
        out = np.einsum("pw,owc->opc", mw, out)
        return out[:, :, 0] if squeeze else out
    img = img.astype(np.float32)
    rows = np.zeros((out_h, in_w, img.shape[2]), np.float32)
    for t in range(ih.shape[1]):
        rows += wh[:, t, None, None] * img[ih[:, t]]
    out = np.zeros((out_h, out_w, img.shape[2]), np.float32)
    for t in range(iw.shape[1]):
        out += ww[None, :, t, None] * rows[:, iw[:, t]]
    return out
