"""Predict step; counterpart of ``crossscore_tpu/train/step.py::make_predict_step``
(training steps wait for the slice that ports the backward kernel)."""

from __future__ import annotations

from typing import Callable

import torch

from crossscore_tpu_torch.models.crossscore import CrossScoreNet


def make_predict_step(model: CrossScoreNet, need_attn_weights: bool = False,
                      head_id: int = 0) -> Callable:
    """``predict_step(query_img, ref_imgs) -> dict`` under inference mode; the
    model holds its weights (the JAX step takes them as an argument)."""

    def predict_step(query_img: torch.Tensor, ref_imgs: torch.Tensor, valid_hw=None) -> dict:
        with torch.inference_mode():
            return model(query_img, ref_imgs, need_attn_weights=need_attn_weights,
                         need_attn_weights_head_id=head_id, valid_hw=valid_hw)

    return predict_step
