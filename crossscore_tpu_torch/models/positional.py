"""Multi-view positional embedding; counterpart of
``crossscore_tpu/models/positional.py`` (reference ``model/positional_encoding.py``).

A fixed random (pe_h, pe_w, C) table, bilinearly resized with
align_corners=True to the patch grid and added identically to every view.
Stored as ``PE`` of shape (1, pe_h, pe_w, C), the reference's layout.
"""

from __future__ import annotations

import torch
from torch import nn

from crossscore_tpu_torch.ops.interpolate import (
    interpolate_bilinear_align_corners, interpolate_bilinear_align_corners_dyn,
)
from crossscore_tpu_torch.parallel.tensor_parallel import copy_to_group


class MultiViewPositionalEmbedding(nn.Module):
    def __init__(self, pe_h: int = 40, pe_w: int = 40, hidden_size: int = 384, device=None):
        super().__init__()
        self.PE = nn.Parameter(torch.zeros(1, pe_h, pe_w, hidden_size, device=device))

    def forward(self, tokens: torch.Tensor, n_view: int, grid_h: int, grid_w: int,
                valid_grid=None, grad_group=None) -> torch.Tensor:
        """tokens: (B, n_view * grid_h * grid_w, C) -> the same with the PE added.

        ``valid_grid`` (shape-bucketed inference): host ints (gh_v, gw_v)
        shared by the batch, or (B,) arrays of them per item. The PE is
        resized to the valid grid and placed in the top-left of the padded
        (grid_h, grid_w) layout; padded positions get none (they are masked
        in every attention).

        ``grad_group``: a process group over which the table's gradient from
        these tokens is summed in the backward (view parallelism: each rank
        holds a share of the reference views)."""
        pe = self.PE[0] if grad_group is None else copy_to_group(self.PE, grad_group)[0]
        b, _, c = tokens.shape
        if valid_grid is not None:
            pe = interpolate_bilinear_align_corners_dyn(pe, grid_h, grid_w, *valid_grid)
            if pe.ndim == 4:  # per item: (B, gh, gw, C), the same for every view
                x = tokens.reshape(b, n_view, grid_h, grid_w, c) + pe.to(tokens.dtype)[:, None]
                return x.reshape(b, n_view * grid_h * grid_w, c)
        elif (grid_h, grid_w) != tuple(pe.shape[:2]):
            pe = interpolate_bilinear_align_corners(pe, grid_h, grid_w)
        x = tokens.reshape(b, n_view, grid_h, grid_w, c) + pe.to(tokens.dtype)
        return x.reshape(b, n_view * grid_h * grid_w, c)
