"""Semantic config validation (reference ``utils/check_config.py``); the port's
own copy of ``crossscore_tpu/utils/check_config.py``."""

from __future__ import annotations


def check_metric_prediction_config(metric_type, metric_min, metric_max) -> None:
    if metric_type not in ("ssim", "mse", "mae"):
        raise ValueError(f"Invalid metric type {metric_type}")
    if metric_max != 1:
        raise ValueError(f"Invalid metric range {metric_min} to {metric_max} for {metric_type}")
    if metric_type == "ssim":
        valid_min = metric_min in (-1, 0)
    else:
        valid_min = metric_min == 0
    if not valid_min:
        raise ValueError(f"Invalid metric range {metric_min} to {metric_max} for {metric_type}")
