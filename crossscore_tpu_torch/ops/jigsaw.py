"""Jigsaw (patch grid <-> image) reshapes; counterpart of
``crossscore_tpu/ops/jigsaw.py`` (reference ``utils/misc/image.py:8-21``)."""

from __future__ import annotations

import torch


def jigsaw_to_image(x: torch.Tensor, grid_size: tuple[int, int]) -> torch.Tensor:
    """(B, N_patch, P_h, P_w) -> (B, N_patch_h*P_h, N_patch_w*P_w)."""
    b, num_patches, ph, pw = x.shape
    gh, gw = grid_size
    if num_patches != gh * gw:
        raise ValueError(f"num_patches {num_patches} != grid {gh}x{gw}")
    x = x.reshape(b, gh, gw, ph, pw).permute(0, 1, 3, 2, 4)  # (B, gh, ph, gw, pw)
    return x.reshape(b, gh * ph, gw * pw)


def image_to_jigsaw(img: torch.Tensor, patch_size: int) -> torch.Tensor:
    """(B, H, W) -> (B, N_patch, P, P); exact inverse of :func:`jigsaw_to_image`."""
    b, h, w = img.shape
    p = patch_size
    if h % p or w % p:
        raise ValueError(f"image {h}x{w} not divisible by patch {p}")
    gh, gw = h // p, w // p
    x = img.reshape(b, gh, p, gw, p).permute(0, 1, 3, 2, 4)  # (B, gh, gw, P, P)
    return x.reshape(b, gh * gw, p, p)
