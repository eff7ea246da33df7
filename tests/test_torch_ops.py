"""The port's primitives (jigsaw, regression activation, interpolation,
dense attention) against the JAX package on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crossscore_tpu.models.regression import regression_activation as jax_activation
from crossscore_tpu.ops.attention import dense_attention as jax_dense_attention
from crossscore_tpu.ops.interpolate import interpolate_bicubic as jax_bicubic
from crossscore_tpu.ops.interpolate import interpolate_bilinear_align_corners as jax_bilinear
from crossscore_tpu.ops.jigsaw import jigsaw_to_image as jax_jigsaw
from crossscore_tpu_torch.models.regression import regression_activation
from crossscore_tpu_torch.ops.attention import dense_attention
from crossscore_tpu_torch.ops.interpolate import (
    _bicubic_axis_matrix, interpolate_bicubic, interpolate_bilinear_align_corners,
)
from crossscore_tpu_torch.ops.jigsaw import image_to_jigsaw, jigsaw_to_image


def test_jigsaw_matches_jax_and_inverts():
    x = np.random.default_rng(0).standard_normal((2, 12, 5, 5)).astype(np.float32)
    got = jigsaw_to_image(torch.from_numpy(x), (3, 4))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_jigsaw(jnp.asarray(x), (3, 4))))
    assert torch.equal(image_to_jigsaw(got, 5), torch.from_numpy(x))
    with pytest.raises(ValueError):
        jigsaw_to_image(torch.from_numpy(x), (3, 3))


@pytest.mark.parametrize("metric,lo,power", [("ssim", 0, "default"), ("ssim", -1, "default"),
                                             ("mae", 0, "default"), ("mse", 0, 3)])
def test_regression_activation_matches_jax(metric, lo, power):
    x = np.linspace(-6, 6, 101).astype(np.float32)
    want = np.asarray(jax_activation(metric, lo, 1, power)(jnp.asarray(x)))
    got = regression_activation(metric, lo, 1, power)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_regression_activation_rejects_bad_config():
    with pytest.raises(ValueError):
        regression_activation("psnr", 0, 1)
    with pytest.raises(ValueError):
        regression_activation("mae", -1, 1)


@pytest.mark.parametrize("out_hw", [(37, 37), (5, 7), (1, 3), (40, 40)])
def test_bilinear_align_corners_matches_jax(out_hw):
    src = np.random.default_rng(1).standard_normal((40, 40, 8)).astype(np.float32)
    want = np.asarray(jax_bilinear(jnp.asarray(src), *out_hw))
    got = interpolate_bilinear_align_corners(torch.from_numpy(src), *out_hw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("out_hw", [(5, 5), (37, 66), (64, 48)])
def test_bicubic_matches_jax(out_hw):
    src = np.random.default_rng(2).standard_normal((37, 37, 8)).astype(np.float32)
    want = np.asarray(jax_bicubic(jnp.asarray(src), *out_hw))
    got = interpolate_bicubic(torch.from_numpy(src), *out_hw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_bicubic_matrix_is_the_jax_matrix():
    from crossscore_tpu.ops.interpolate import _bicubic_axis_matrix as jax_matrix

    for n_in, n_out in ((37, 5), (37, 66), (4, 9)):
        np.testing.assert_array_equal(_bicubic_axis_matrix(n_in, n_out), jax_matrix(n_in, n_out))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_attention_matches_jax(dtype):
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((2, 3, n, 16)).astype(np.float32) for n in (7, 11, 11))
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want, wprobs = jax_dense_attention(*(jnp.asarray(a).astype(jd) for a in (q, k, v)), return_probs=True)
    got, probs = dense_attention(*(torch.from_numpy(a).to(td) for a in (q, k, v)), return_probs=True)
    assert got.dtype == td and probs.dtype == torch.float32
    tol = 1e-5 if dtype == "float32" else 1.6e-2
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=tol, atol=tol)
    np.testing.assert_allclose(probs.numpy(), np.asarray(wprobs), rtol=1e-5, atol=1e-6)
