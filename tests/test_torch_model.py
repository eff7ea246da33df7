"""The port's model (blocks, encoder, decoder, the whole predict slice)
against the JAX package on the CPU, with the same parameters carried across
by ``state_dict_from_jax`` and the same inputs from a numpy seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crossscore_tpu.models import CrossScoreConfig as JaxConfig
from crossscore_tpu.models import CrossScoreNet as JaxNet
from crossscore_tpu.models.decoder import CrossReferenceDecoder as JaxDecoder
from crossscore_tpu.models.dinov2 import VIT_PRESETS as JAX_VIT
from crossscore_tpu.models.dinov2 import Dinov2Encoder as JaxEncoder
from crossscore_tpu.models.dinov2 import ViTBlock as JaxBlock
from crossscore_tpu.train.step import make_predict_step as jax_make_predict_step
from crossscore_tpu_torch.io.convert import load_into, state_dict_from_jax
from crossscore_tpu_torch.models import VIT_PRESETS, CrossScoreConfig, CrossScoreNet
from crossscore_tpu_torch.train.step import make_predict_step

# fp32 module-level bound: the two packages differ only in summation order
TOL32 = 2e-5
# fp32 score maps (sigmoid outputs in [0, 1]): mean absolute error
MAE32 = 1e-4


def _jax_net(preset: str, hw: int, b: int, k: int, pe: int, impl="xla", mlp="xla",
             dtype=jnp.float32, seed=0):
    cfg = JaxConfig(backbone=JAX_VIT[preset], pe_h=pe, pe_w=pe, attention_impl=impl,
                    mlp_impl=mlp, compute_dtype=dtype)
    net = JaxNet(cfg)
    q = jnp.zeros((b, hw, hw, 3), jnp.float32)
    r = jnp.zeros((b, k, hw, hw, 3), jnp.float32)
    params = jax.device_get(net.init(jax.random.PRNGKey(seed), q, r)["params"])
    return net, params


def _port_net(preset: str, pe: int, params, impl="flash", mlp="fused", dtype=torch.float32):
    cfg = CrossScoreConfig(backbone=VIT_PRESETS[preset], pe_h=pe, pe_w=pe, attention_impl=impl,
                           mlp_impl=mlp, compute_dtype=dtype)
    return load_into(CrossScoreNet(cfg, device="cpu"), state_dict_from_jax(params))


def _images(seed: int, b: int, k: int, hw: int):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hw, hw, 3)).astype(np.float32),
            rng.standard_normal((b, k, hw, hw, 3)).astype(np.float32))


def _close(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = float(np.max(np.abs(got - want) / (1.0 + np.abs(want))))
    assert err <= tol, f"error {err} > {tol}"


@pytest.fixture(scope="module")
def small():
    """dinov2-small width, 70x70 px (5x5 patches), the 40x40 PE and the
    37x37 position table both resized; K=2, B=1."""
    net, params = _jax_net("dinov2-small", 70, 1, 2, 40)
    return net, params


@pytest.mark.parametrize("impl,mlp", [("flash", "fused_exact"), ("dense", "unfused")])
def test_vit_block_matches_jax(small, impl, mlp):
    _, params = small
    port = _port_net("dinov2-small", 40, params, impl, mlp)
    x = np.random.default_rng(7).standard_normal((2, 26, 384)).astype(np.float32)
    want = JaxBlock(JAX_VIT["dinov2-small"]).apply({"params": params["backbone"]["block_3"]}, jnp.asarray(x))
    with torch.no_grad():
        got = port.backbone.encoder.layer[3](torch.from_numpy(x))
    _close(got.numpy(), want, TOL32)


@pytest.mark.parametrize("impl,mlp", [("flash", "fused"), ("dense", "unfused")])
def test_dinov2_encoder_matches_jax(small, impl, mlp):
    _, params = small
    port = _port_net("dinov2-small", 40, params, impl, mlp)
    imgs = np.random.default_rng(8).standard_normal((2, 70, 70, 3)).astype(np.float32)
    want = JaxEncoder(JAX_VIT["dinov2-small"]).apply({"params": params["backbone"]}, jnp.asarray(imgs))
    with torch.no_grad():
        got = port.backbone(torch.from_numpy(imgs))
    assert got.shape == (2, 26, 384)
    _close(got.numpy(), want, TOL32)


@pytest.mark.parametrize("impl", ["flash", "dense"])
def test_cross_reference_decoder_matches_jax(small, impl):
    _, params = small
    port = _port_net("dinov2-small", 40, params, impl)
    rng = np.random.default_rng(9)
    tgt = rng.standard_normal((1, 25, 384)).astype(np.float32)
    mem = rng.standard_normal((1, 50, 384)).astype(np.float32)
    want, _ = JaxDecoder(384).apply({"params": params["decoder"]}, jnp.asarray(tgt), jnp.asarray(mem))
    with torch.no_grad():
        got, w = port.ref_cross.attn(torch.from_numpy(tgt), torch.from_numpy(mem))
    assert w is None
    _close(got.numpy(), want, TOL32)


def test_decoder_attention_weights_match_jax(small):
    _, params = small
    port = _port_net("dinov2-small", 40, params)
    rng = np.random.default_rng(10)
    tgt = rng.standard_normal((1, 25, 384)).astype(np.float32)
    mem = rng.standard_normal((1, 50, 384)).astype(np.float32)
    _, want = JaxDecoder(384).apply({"params": params["decoder"]}, jnp.asarray(tgt), jnp.asarray(mem),
                                    need_weights=True, need_weights_head_id=3)
    with torch.no_grad():
        _, got = port.ref_cross.attn(torch.from_numpy(tgt), torch.from_numpy(mem),
                                     need_weights=True, need_weights_head_id=3)
    assert got.shape == (1, 25, 50)
    _close(got.numpy(), want, 1e-6)


@pytest.fixture(scope="module")
def dinov2_test_params():
    """JAX parameters at the dinov2-test preset (the same tree on every route)."""
    return _jax_net("dinov2-test", 56, 2, 3, 6)[1]


@pytest.fixture(scope="module", params=[("xla", "xla"), ("pallas", "fused")], ids=["jax_xla", "jax_pallas"])
def dinov2_test_case(request, dinov2_test_params):
    """dinov2-test, 56 px, B=2, K=3 through one of the two JAX routes."""
    impl, mlp = request.param
    net = JaxNet(JaxConfig(backbone=JAX_VIT["dinov2-test"], pe_h=6, pe_w=6, attention_impl=impl, mlp_impl=mlp))
    q, r = _images(11, 2, 3, 56)
    params = dinov2_test_params
    want = np.asarray(jax_make_predict_step(net)(params, jnp.asarray(q), jnp.asarray(r))["score_map_ref_cross"])
    return params, q, r, want


@pytest.mark.parametrize("port_route", [("flash", "fused"), ("dense", "unfused")])
def test_predict_step_dinov2_test_matches_jax(dinov2_test_case, port_route):
    params, q, r, want = dinov2_test_case
    port = _port_net("dinov2-test", 6, params, *port_route)
    got = make_predict_step(port)(torch.from_numpy(q), torch.from_numpy(r))["score_map_ref_cross"]
    assert got.shape == (2, 56, 56) and got.dtype == torch.float32
    assert float(np.abs(got.numpy() - want).mean()) < MAE32


def test_predict_step_dinov2_small_width_matches_jax(small):
    net, params = small
    q, r = _images(12, 1, 2, 70)
    want = np.asarray(jax_make_predict_step(net)(params, jnp.asarray(q), jnp.asarray(r))["score_map_ref_cross"])
    got = make_predict_step(_port_net("dinov2-small", 40, params))(
        torch.from_numpy(q), torch.from_numpy(r))["score_map_ref_cross"]
    assert got.shape == (1, 70, 70)
    assert float(np.abs(got.numpy() - want).mean()) < MAE32


@pytest.mark.parametrize("gelu", ["tanh", "exact"])
def test_predict_step_bf16_matches_jax(gelu):
    """bf16 with the same GELU form on both sides. The two frameworks round
    at different places (matmul epilogues, the patch embed), so the bound is
    the JAX package's own bf16-vs-fp32 budget divided by five."""
    mlp_j, mlp_t = ("fused", "fused") if gelu == "tanh" else ("fused_exact", "fused_exact")
    net, params = _jax_net("dinov2-test", 56, 2, 3, 6, "pallas", mlp_j, jnp.bfloat16)
    q, r = _images(13, 2, 3, 56)
    want = np.asarray(jax_make_predict_step(net)(params, jnp.asarray(q), jnp.asarray(r))["score_map_ref_cross"])
    port = _port_net("dinov2-test", 6, params, "flash", mlp_t, torch.bfloat16)
    got = make_predict_step(port)(torch.from_numpy(q), torch.from_numpy(r))["score_map_ref_cross"]
    assert float(np.abs(got.numpy() - want).mean()) < 1e-2


def test_uint8_input_matches_jax_and_float_wire(dinov2_test_params):
    params = dinov2_test_params
    net = JaxNet(JaxConfig(backbone=JAX_VIT["dinov2-test"], pe_h=6, pe_w=6))
    rng = np.random.default_rng(14)
    q8 = rng.integers(0, 256, (2, 56, 56, 3)).astype(np.uint8)
    r8 = rng.integers(0, 256, (2, 3, 56, 56, 3)).astype(np.uint8)
    want = np.asarray(jax_make_predict_step(net)(params, jnp.asarray(q8), jnp.asarray(r8))["score_map_ref_cross"])
    port = _port_net("dinov2-test", 6, params)
    step = make_predict_step(port)
    got = step(torch.from_numpy(q8), torch.from_numpy(r8))["score_map_ref_cross"].numpy()
    assert float(np.abs(got - want).mean()) < MAE32
    mean = np.array([0.485, 0.456, 0.406], np.float32)
    std = np.array([0.229, 0.224, 0.225], np.float32)
    norm = lambda a: ((a.astype(np.float32) * np.float32(1 / 255) - mean) / std).astype(np.float32)  # noqa: E731
    got_f = step(torch.from_numpy(norm(q8)), torch.from_numpy(norm(r8)))["score_map_ref_cross"].numpy()
    np.testing.assert_allclose(got, got_f, atol=1e-5)


def test_attention_weight_map_shape_and_values(dinov2_test_params):
    params = dinov2_test_params
    net = JaxNet(JaxConfig(backbone=JAX_VIT["dinov2-test"], pe_h=6, pe_w=6))
    q, r = _images(15, 1, 2, 56)
    want = net.apply({"params": params}, jnp.asarray(q), jnp.asarray(r), need_attn_weights=True,
                     need_attn_weights_head_id=1)
    out = make_predict_step(_port_net("dinov2-test", 6, params), need_attn_weights=True, head_id=1)(
        torch.from_numpy(q), torch.from_numpy(r))
    w = out["attn_weights_map_ref_cross"]
    assert w.shape == (1, 4, 4, 2, 4, 4)
    _close(w.numpy(), np.asarray(want["attn_weights_map_ref_cross"]), 1e-5)


def test_unported_inputs_raise(dinov2_test_params):
    """Every input of the JAX net is ported: ``valid_hw`` and ``ref_tokens``
    (tests/test_torch_masked.py) and, since the token-space slice, the
    decoder-only graph's ``query_tokens`` and ``token_grid``
    (tests/test_torch_token_train.py). Given incompletely, the token inputs
    raise instead of being ignored."""
    port = _port_net("dinov2-test", 6, dinov2_test_params)
    q, r = (torch.from_numpy(a) for a in _images(16, 1, 1, 56))
    with pytest.raises(ValueError, match="query_tokens"):
        port(None, None, ref_tokens=torch.zeros(1, 1, 16, 64), query_tokens=torch.zeros(1, 16, 64))
    with pytest.raises(ValueError, match="token_grid"):
        port(q, r, token_grid=(4, 4))


def test_parity_config_rule():
    cfg = CrossScoreConfig(parity=True)
    assert cfg.compute_dtype == torch.float32 and cfg.mlp_impl == "fused_exact"
    assert CrossScoreConfig(parity=True, mlp_impl="unfused").mlp_impl == "unfused"
    default = CrossScoreConfig()
    assert (default.compute_dtype, default.attention_impl, default.mlp_impl) == (torch.bfloat16, "flash", "fused")
    with pytest.raises(ValueError, match="attention_impl"):
        CrossScoreConfig(attention_impl="pallas")
