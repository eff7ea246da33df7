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


def check_reference_type(do_reference_cross) -> str:
    if do_reference_cross:
        return "cross"
    raise ValueError("Reference type must be 'cross'")


class ConfigChecker:
    """Entry-point config validation for the train, test and predict entry points."""

    def __init__(self, cfg):
        self.cfg = cfg

    def _check_common(self):
        check_reference_type(self.cfg.model.do_reference_cross)
        check_metric_prediction_config(
            self.cfg.model.predict.metric.type,
            self.cfg.model.predict.metric.min,
            self.cfg.model.predict.metric.max,
        )

    def check_train_val(self):
        self._check_common()

    def check_test(self):
        self._check_common()

    def check_predict(self):
        self._check_common()
