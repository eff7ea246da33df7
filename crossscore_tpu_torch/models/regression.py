"""Regression output activation; counterpart of
``crossscore_tpu/models/regression.py`` (reference ``model/regression_layer.py``).

``metric_min == -1`` -> tanh; ``metric_min == 0`` -> sigmoid, then an
element-wise power (defaults {ssim: 1, mae: 2, mse: 4}).
"""

from __future__ import annotations

from typing import Callable

import torch

from crossscore_tpu_torch.utils.check_config import check_metric_prediction_config

_POW_DEFAULT = {"ssim": 1, "mae": 2, "mse": 4}


def regression_activation(
    metric_type: str, metric_min: int, metric_max: int, pow_factor="default"
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Return the activation for the configured metric."""
    check_metric_prediction_config(metric_type, metric_min, metric_max)
    if metric_min == -1:
        base, p = torch.tanh, 1
    elif metric_min == 0:
        base = torch.sigmoid
        p = _POW_DEFAULT[metric_type] if pow_factor == "default" else pow_factor
    else:
        raise ValueError(f"metric_min={metric_min} not supported")
    p = float(p)
    if p == 1.0:
        return base
    return lambda x: torch.pow(base(x), p)
