"""The ViT-L stress path's shapes on the CPU against the JAX package: K2 and
K10 at D 768 and 1024 (the port's plain versions, which the CPU runs, against
the JAX ops' Pallas kernels in interpret mode), nets at the ViT-L width (D
1024, 16 heads, decoder hd 128) and the dinov2-base width (768, 12 heads,
decoder hd 96) cut to two backbone layers, the full dinov2-large's parameter
map, and the tools' analytic FLOP count. Parameters are carried across with
``state_dict_from_jax``; inputs come from a numpy seed."""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crossscore_tpu.models import CrossScoreConfig as JaxConfig
from crossscore_tpu.models import CrossScoreNet as JaxNet
from crossscore_tpu.models.dinov2 import VIT_PRESETS as JAX_VIT
from crossscore_tpu.models.dinov2 import ViTConfig as JaxViT
from crossscore_tpu.ops.fused_mlp import fused_ln_mlp as jax_flm
from crossscore_tpu.ops.fused_mlp import fused_res_ln_mlp as jax_frlm
from crossscore_tpu.train.step import loss_fn as jax_loss_fn
from crossscore_tpu_torch.io.convert import load_into, state_dict_from_jax
from crossscore_tpu_torch.models import VIT_PRESETS, CrossScoreConfig, CrossScoreNet
from crossscore_tpu_torch.models.dinov2 import ViTConfig
from crossscore_tpu_torch.ops import fused_mlp as fm
from crossscore_tpu_torch.tools import stress_vitl
from crossscore_tpu_torch.train.step import loss_fn, make_predict_step

ROOT = Path(__file__).resolve().parent.parent
WIDTHS = (768, 1024)
# tests/test_torch_k10.py's bounds: fp32 differs by summation order only; bf16
# rounds LN(x), the hidden layer and the output, one ulp of 2^-6 at |out| < 4
ATOL = {"float32": 1e-5, "bfloat16": 1.6e-2}
# fp32 score maps (sigmoid outputs in [0, 1]): mean absolute error
MAE32 = 1e-4
# fp32 token-step gradients, relative to each leaf's largest entry
GRAD_RTOL = 1e-4


def _mlp_args(seed, d, n=5, b=2):
    """x (b, n, d), attn, ls1 and K2's seven parameters at F = 4 D, numpy
    fp32, in the JAX layout: w1 (D, F), w2 (F, D)."""
    f = 4 * d
    rng = np.random.default_rng(seed)
    r = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return [r(b, n, d) * 0.5, r(b, n, d) * 0.3, 1.0 + 0.05 * r(d), 1.0 + 0.1 * r(d), 0.1 * r(d),
            r(d, f) * d ** -0.5, 0.1 * r(f), r(f, d) * f ** -0.5, 0.1 * r(d), 1.0 + 0.05 * r(d)]


def _torch_args(args, dtype):
    t = [torch.from_numpy(a.copy()) for a in args]
    t[5], t[7] = t[5].t().contiguous(), t[7].t().contiguous()  # torch Linear layout
    return [a.to(dtype) for a in t]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", WIDTHS)
def test_k2_and_k10_wide_match_jax(d, dtype):
    """K2 (tanh and exact GELU) and K10 at D 768 and 1024, F = 4 D, against
    the JAX ops; on the CPU the port launches nothing."""
    args = _mlp_args(d, d)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ja = [jnp.asarray(a, jdt) for a in args]
    t = _torch_args(args, tdt)
    k2, k10 = fm.fused_ln_mlp.launches, fm.fused_res_ln_mlp.launches
    for gelu in ("tanh", "exact"):
        want = np.asarray(jax_flm(ja[0], *ja[3:], 1e-6, gelu).astype(jnp.float32))
        got = fm.fused_ln_mlp(t[0], *t[3:], 1e-6, gelu)
        assert got.dtype == tdt and got.shape == (2, 5, d)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=ATOL[dtype], err_msg=gelu)
    want = np.asarray(jax_frlm(*ja).astype(jnp.float32))
    np.testing.assert_allclose(fm.fused_res_ln_mlp(*t).float().numpy(), want, rtol=0, atol=ATOL[dtype])
    assert (fm.fused_ln_mlp.launches, fm.fused_res_ln_mlp.launches) == (k2, k10)


def test_k10_gradients_at_d1024_match_jax():
    """All ten gradients of sum(out^2) at D 1024 against ``jax.grad`` of the
    JAX op, within 1e-4."""
    args = _mlp_args(1, 1024, n=3, b=1)
    g_j = jax.grad(lambda *a: jnp.sum(jnp.square(jax_frlm(*a))), argnums=tuple(range(10)))(
        *(jnp.asarray(a) for a in args))
    t = [a.requires_grad_() for a in _torch_args(args, torch.float32)]
    fm.fused_res_ln_mlp(*t).square().sum().backward()
    for i, (a, gj) in enumerate(zip(t, g_j)):
        got = a.grad.numpy()
        np.testing.assert_allclose(got.T if i in (5, 7) else got, np.asarray(gj), rtol=1e-4, atol=1e-4,
                                   err_msg=f"gradient {i}")


def test_wide_widths_need_f_in_whole_cluster_chunks():
    """The CUDA wrappers refuse bf16 D 768 / 1024 with F not a multiple of
    128 (the wide body splits 64-column chunks over a cluster of two) before
    any launch; the check runs ahead of the build."""
    with pytest.raises(ValueError, match="F % 128"):
        fm._check_widths("fused_ln_mlp", torch.bfloat16, 1024, 4096 + 64)
    fm._check_widths("fused_ln_mlp", torch.bfloat16, 768, 3072)
    fm._check_widths("fused_ln_mlp", torch.bfloat16, 384, 1536 + 64)
    with pytest.raises(ValueError, match="D in"):
        fm._check_widths("fused_res_ln_mlp", torch.bfloat16, 512, 2048)


# width name -> (hidden, heads): the backbone cut to 2 layers, the decoder at
# the backbone's width with its 8 heads (hd 128 and 96)
NETS = {"vitl": (1024, 16), "base": (768, 12)}


@pytest.fixture(scope="module", params=list(NETS))
def net(request):
    hidden, heads = NETS[request.param]
    jvit = JaxViT(hidden_size=hidden, num_layers=2, num_heads=heads)
    jnet = JaxNet(JaxConfig(backbone=jvit, pe_h=8, pe_w=8))
    q = jnp.zeros((1, 56, 56, 3), jnp.float32)
    params = jax.device_get(jnet.init(jax.random.PRNGKey(3), q, jnp.zeros((1, 2, 56, 56, 3)))["params"])
    cfg = CrossScoreConfig(backbone=ViTConfig(hidden_size=hidden, num_layers=2, num_heads=heads), pe_h=8, pe_w=8,
                           compute_dtype=torch.float32)
    port = load_into(CrossScoreNet(cfg, device="cpu"), state_dict_from_jax(params))
    return jnet, params, port


def test_presets_match_jax():
    for name in ("dinov2-base", "dinov2-large"):
        j, p = JAX_VIT[name], VIT_PRESETS[name]
        assert (p.hidden_size, p.num_layers, p.num_heads, p.mlp_ratio, p.image_size) == (
            j.hidden_size, j.num_layers, j.num_heads, j.mlp_ratio, j.image_size)


@pytest.mark.parametrize("hw", [56, 112])
def test_wide_net_score_map_matches_jax(net, hw):
    """The predict forward at 56 and 112 px, B=1, K=2: the 37x37 position
    table resized to 4x4 and 8x8 (bicubic) and the 8x8 PE to the grid
    (bilinear), K1 at the backbone's heads, K2 at D 768 / 1024, K3 at hd 96 /
    128; fp32 score-map MAE < 1e-4."""
    jnet, params, port = net
    rng = np.random.default_rng(hw)
    q = rng.standard_normal((1, hw, hw, 3)).astype(np.float32)
    r = rng.standard_normal((1, 2, hw, hw, 3)).astype(np.float32)
    want = np.asarray(jnet.apply({"params": params}, jnp.asarray(q), jnp.asarray(r))["score_map_ref_cross"])
    got = make_predict_step(port)(torch.from_numpy(q), torch.from_numpy(r))["score_map_ref_cross"].numpy()
    assert got.shape == want.shape == (1, hw, hw)
    assert float(np.abs(got - want).mean()) < MAE32


def test_wide_net_token_step_gradients_match_jax(net):
    """The token train step's loss and every decoder and head gradient at the
    wide widths (B=1, K=2, a 6x6 grid), within 1e-4 of each leaf's largest."""
    jnet, params, port = net
    d = port.cfg.backbone.hidden_size
    rng = np.random.default_rng(5)
    batch = {"query/tokens": rng.standard_normal((1, 36, d)).astype(np.float32),
             "reference/cross/tokens": rng.standard_normal((1, 2, 36, d)).astype(np.float32),
             "query/score_map": rng.random((1, 84, 84)).astype(np.float32)}
    (loss_j, _), grads_j = jax.jit(jax.value_and_grad(lambda p, bt: jax_loss_fn(jnet, p, bt), has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    want = state_dict_from_jax(jax.device_get(grads_j))
    port.zero_grad(set_to_none=True)
    loss_t, _ = loss_fn(port, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss_t.backward()
    assert loss_t.item() == pytest.approx(float(loss_j), rel=GRAD_RTOL)
    checked = 0
    for name, p in port.named_parameters():
        if name.startswith("ref_cross."):
            g, gw = p.grad.numpy(), want[f"model.{name}"]
            assert float(np.abs(g - gw).max()) <= GRAD_RTOL * float(np.abs(gw).max()), name
            checked += 1
        else:
            assert p.grad is None, name
    assert checked > 10


def _jax_tool(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("hw,k,preset", [(1036, 5, "dinov2-large"), (1036, 16, "dinov2-large"),
                                         (518, 5, "dinov2-small"), (518, 8, "dinov2-base"),
                                         (56, 2, "dinov2-test"), (70, 1, "dinov2-large")])
def test_model_flops_is_the_jax_tools(hw, k, preset):
    """The port's copy of ``model_flops`` equals the JAX tool's."""
    jax_tool = _jax_tool("stress_vitl")
    args = (hw, k, VIT_PRESETS[preset], VIT_PRESETS[preset].hidden_size, 2, 1, 14)
    assert stress_vitl.model_flops(*args) == jax_tool.model_flops(*args)


def test_dinov2_large_jax_tree_maps_onto_the_port():
    """At the full depth and width (24 blocks, D 1024, 1036 px's PE), every
    tensor ``state_dict_from_jax`` makes from the JAX tree has a parameter of
    its shape in the port's ViT-L and none is missing, so JAX weights load
    under ``strict=True``; ``init_params`` gives the same keys. Shapes only
    (``jax.eval_shape``, zero-stride arrays): nothing is allocated."""
    jnet = JaxNet(JaxConfig(backbone=JAX_VIT["dinov2-large"]))
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0), jnp.zeros((1, 70, 70, 3)),
                            jnp.zeros((1, 2, 70, 70, 3)))["params"]
    tree = jax.tree_util.tree_map(lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
    sd = state_dict_from_jax(tree)
    port = CrossScoreNet(CrossScoreConfig(backbone=VIT_PRESETS["dinov2-large"]), device="meta").state_dict()
    assert {k[len("model."):]: tuple(v.shape) for k, v in sd.items()} == {k: tuple(v.shape) for k, v in port.items()}
    assert sum(1 for k in port if k.startswith("backbone.encoder.layer.") and k.endswith(".mlp.fc1.weight")) == 24
