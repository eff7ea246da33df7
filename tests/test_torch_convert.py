"""Weights carried into the port: ``state_dict_from_jax`` against the JAX
package's ``revert_lightning_ckpt``, loading, and ``init_params``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crossscore_tpu.io.torch_convert import revert_lightning_ckpt
from crossscore_tpu.models import CrossScoreConfig as JaxConfig
from crossscore_tpu.models import CrossScoreNet as JaxNet
from crossscore_tpu.models.dinov2 import VIT_PRESETS as JAX_VIT
from crossscore_tpu_torch.io.convert import init_params, load_into, state_dict_from_jax
from crossscore_tpu_torch.models import VIT_PRESETS, CrossScoreConfig, CrossScoreNet


@pytest.fixture(scope="module", params=[True, False], ids=["self_attn", "no_self_attn"])
def jax_params(request):
    cfg = JaxConfig(backbone=JAX_VIT["dinov2-test"], pe_h=6, pe_w=6, do_self_attn=request.param)
    q = jnp.zeros((1, 56, 56, 3))
    r = jnp.zeros((1, 2, 56, 56, 3))
    return request.param, jax.device_get(JaxNet(cfg).init(jax.random.PRNGKey(3), q, r)["params"])


def _cfg(do_self_attn=True):
    return CrossScoreConfig(backbone=VIT_PRESETS["dinov2-test"], pe_h=6, pe_w=6,
                            do_self_attn=do_self_attn, compute_dtype=torch.float32)


def test_state_dict_from_jax_equals_revert_lightning_ckpt(jax_params):
    _, params = jax_params
    got = state_dict_from_jax(params)
    want = revert_lightning_ckpt(params)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("prefixed", [True, False])
def test_lightning_dict_loads_strict(jax_params, prefixed):
    self_attn, params = jax_params
    sd = state_dict_from_jax(params)
    if not prefixed:
        sd = {k[len("model."):]: v for k, v in sd.items()}
    model = load_into(CrossScoreNet(_cfg(self_attn), device="cpu"), sd)
    state = model.state_dict()
    assert len(state) == len(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(state[k.removeprefix("model.")].numpy(), v, err_msg=k)


def test_load_rejects_missing_and_extra_keys(jax_params):
    self_attn, params = jax_params
    sd = state_dict_from_jax(params)
    model = CrossScoreNet(_cfg(self_attn), device="cpu")
    with pytest.raises(RuntimeError):
        load_into(model, {k: v for k, v in sd.items() if "pos_enc_fn" not in k})
    with pytest.raises(RuntimeError):
        load_into(model, {**sd, "model.extra.weight": np.zeros(1, np.float32)})


def test_init_params_distributions_and_seed():
    cfg = CrossScoreConfig(backbone=VIT_PRESETS["dinov2-small"])
    p = init_params(cfg, 0, "cpu")
    model = load_into(CrossScoreNet(cfg, device="cpu"), p)
    assert model.img_mean_std.shape == (6,)
    assert torch.equal(p["backbone.encoder.layer.0.layer_scale1.lambda1"], torch.ones(384))
    assert torch.equal(p["backbone.encoder.layer.0.norm1.weight"], torch.ones(384))
    assert not p["ref_cross.attn.layers.1.linear1.bias"].any()
    assert abs(float(p["pos_enc_fn.PE"].std()) - 1.0) < 0.01
    for key, fan_in in (("backbone.encoder.layer.0.mlp.fc2.weight", 1536),
                        ("ref_cross.attn.layers.0.multihead_attn.in_proj_weight", 384),
                        ("backbone.embeddings.patch_embeddings.projection.weight", 588)):
        assert abs(float(p[key].std()) * fan_in ** 0.5 - 1.0) < 0.05, key
    pos = p["backbone.embeddings.position_embeddings"]
    assert float(pos.abs().max()) <= 0.04 and abs(float(pos.std()) - 0.0176) < 0.002
    assert torch.equal(init_params(cfg, 0, "cpu")["pos_enc_fn.PE"], p["pos_enc_fn.PE"])
    assert not torch.equal(init_params(cfg, 1, "cpu")["pos_enc_fn.PE"], p["pos_enc_fn.PE"])
