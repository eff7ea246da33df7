"""Random cropping for host-side numpy images (HWC / HW layouts); the port's
own copy of ``crossscore_tpu/data/crop.py``.

Behavioural parity with reference ``dataloading/transformation/crop.py:7-86``:
- ``CropperSame``: ONE crop window applied to a group of aligned arrays
  (query image + its score map).
- ``CropperSeparate``: an independent window per item (each reference view).
- deterministic mode crops the top-left corner.
"""

from __future__ import annotations

import numpy as np


def get_crop_params(
    input_hw: tuple[int, int],
    output_hw: tuple[int, int],
    rng: np.random.Generator,
    deterministic: bool = False,
) -> np.ndarray:
    """Returns (i, j, out_h, out_w)."""
    in_h, in_w = input_hw
    out_h, out_w = output_hw
    if in_h < out_h or in_w < out_w:
        raise ValueError(f"crop {output_hw} larger than input {input_hw}")
    if deterministic:
        i, j = 0, 0
    else:
        i = int(rng.integers(0, in_h - out_h + 1))
        j = int(rng.integers(0, in_w - out_w + 1))
    return np.array([i, j, out_h, out_w], dtype=np.int64)


def crop(arr: np.ndarray, param: np.ndarray) -> np.ndarray:
    """Crop leading-2-spatial-dims array (H, W, ...) by (i, j, h, w)."""
    i, j, h, w = (int(x) for x in param)
    return arr[i : i + h, j : j + w]


class CropperSame:
    """Same window for all arrays passed in one call."""

    def __init__(self, output_size: tuple[int, int], deterministic: bool = False):
        self.output_size = tuple(output_size)
        self.deterministic = deterministic

    def __call__(self, *arrays: np.ndarray, rng: np.random.Generator):
        param = get_crop_params(
            arrays[0].shape[:2], self.output_size, rng, self.deterministic
        )
        return {"out": [crop(a, param) for a in arrays], "crop_param": param}


class CropperSeparate:
    """Independent window per item of a stacked (N, H, W, ...) array."""

    def __init__(self, output_size: tuple[int, int], deterministic: bool = False):
        self.output_size = tuple(output_size)
        self.deterministic = deterministic

    def __call__(self, arrays: np.ndarray, rng: np.random.Generator):
        outs, params = [], []
        for a in arrays:
            p = get_crop_params(a.shape[:2], self.output_size, rng, self.deterministic)
            outs.append(crop(a, p))
            params.append(p)
        return {"out": np.stack(outs), "crop_param": np.stack(params)}
