"""Multi-view positional embedding; counterpart of
``crossscore_tpu/models/positional.py`` (reference ``model/positional_encoding.py``).

A fixed random (pe_h, pe_w, C) table, bilinearly resized with
align_corners=True to the patch grid and added identically to every view.
Stored as ``PE`` of shape (1, pe_h, pe_w, C), the reference's layout.
"""

from __future__ import annotations

import torch
from torch import nn

from crossscore_tpu_torch.ops.interpolate import interpolate_bilinear_align_corners


class MultiViewPositionalEmbedding(nn.Module):
    def __init__(self, pe_h: int = 40, pe_w: int = 40, hidden_size: int = 384, device=None):
        super().__init__()
        self.PE = nn.Parameter(torch.zeros(1, pe_h, pe_w, hidden_size, device=device))

    def forward(self, tokens: torch.Tensor, n_view: int, grid_h: int, grid_w: int) -> torch.Tensor:
        """tokens: (B, n_view * grid_h * grid_w, C) -> the same with the PE added."""
        pe = self.PE[0]
        if (grid_h, grid_w) != tuple(pe.shape[:2]):
            pe = interpolate_bilinear_align_corners(pe, grid_h, grid_w)
        b, _, c = tokens.shape
        x = tokens.reshape(b, n_view, grid_h, grid_w, c) + pe.to(tokens.dtype)
        return x.reshape(b, n_view * grid_h * grid_w, c)
