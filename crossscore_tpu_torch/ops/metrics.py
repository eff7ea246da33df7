"""Evaluation metric math; counterpart of ``crossscore_tpu/ops/metrics.py``
(reference ``utils/evaluation/metric.py:5-30``), on torch tensors."""

from __future__ import annotations

import torch


def abs2psnr(a: torch.Tensor) -> torch.Tensor:
    """PSNR from an L1-style mean-absolute value (pairs with the L1 loss)."""
    return -10.0 * torch.log10(torch.square(a))


def correlation(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pearson correlation between two equally-shaped maps (flattened), in
    fp32; 0 where either side is constant."""
    x = a.reshape(-1).float()
    y = b.reshape(-1).float()
    x = x - x.mean()
    y = y - y.mean()
    denom = torch.sqrt(torch.sum(x * x) * torch.sum(y * y))
    return torch.where(denom == 0, torch.zeros_like(denom), torch.sum(x * y) / denom)


def masked_correlation(a: torch.Tensor, b: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Pearson correlation over the elements where the 0/1 weight ``w``
    (broadcastable to ``a``) is non-zero; equals :func:`correlation` for a
    uniform weight. Excludes loader-padded duplicate items from metrics."""
    x = a.float()
    y = b.float()
    w = torch.broadcast_to(w, x.shape).float()
    n = torch.clamp(torch.sum(w), min=1.0)
    mx = torch.sum(x * w) / n
    my = torch.sum(y * w) / n
    xc = (x - mx) * w
    yc = (y - my) * w
    # w is 0/1 so w^2 == w; cross terms carry a single w factor
    denom = torch.sqrt(torch.sum(xc * xc) * torch.sum(yc * yc))
    return torch.where(denom == 0, torch.zeros_like(denom), torch.sum(xc * (y - my)) / denom)
