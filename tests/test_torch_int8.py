"""The port's int8 W8A8 backbone (``ops/quant.py``, ``model.gpu.backbone_quant``)
against the JAX package's (``crossscore_tpu/ops/quant.py``,
``model.tpu.backbone_quant``) on the CPU: the row quantisation bit for bit,
the linear against ``QuantDense``, JAX's accuracy and outlier checks, the
small net against JAX's and against its own unquantised map (JAX's int8
tier), the config rules and routing, the bucketed encoder, the predict CLI
and the routing of every other entry point that builds the net. Inputs come
from numpy seeds; weights cross by ``state_dict_from_jax``.

The JAX functions run eagerly here: under ``jax.jit`` XLA turns the division
by the constant 127 into a multiplication by fl(1/127), which moves a scale
by one ulp (:func:`test_jitted_jax_scales_multiply_by_the_reciprocal`)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from crossscore_tpu.data import fastimage
from crossscore_tpu.models import CrossScoreConfig as JaxConfig
from crossscore_tpu.models import CrossScoreNet as JaxNet
from crossscore_tpu.models.dinov2 import VIT_PRESETS as JAX_VIT
from crossscore_tpu.ops.quant import QuantDense, int8_matmul, quantize_colwise
from crossscore_tpu.ops.quant import quantize_rowwise as jax_quantize_rowwise
from crossscore_tpu.tasks.predict import main as jax_main
from crossscore_tpu_torch.confsys import load_config
from crossscore_tpu_torch.data import fastimage as port_fastimage
from crossscore_tpu_torch.data.synthetic import generate
from crossscore_tpu_torch.io.convert import init_params, load_into, state_dict_from_jax
from crossscore_tpu_torch.models import VIT_PRESETS, CrossScoreConfig, CrossScoreNet
from crossscore_tpu_torch.models import dinov2 as port_dinov2
from crossscore_tpu_torch.models.crossscore import make_backbone_encoder
from crossscore_tpu_torch.models.dinov2 import ViTAttention
from crossscore_tpu_torch.ops import quant
from crossscore_tpu_torch.tasks.predict import main as port_main
from crossscore_tpu_torch.train.step import make_predict_step

# the port's int8 net against JAX's on the same weights, fp32 score maps:
# both quantise the same codes, but a summation-order difference of ~1e-7
# upstream flips a code that sits at a rounding boundary (measured on the
# CPU: MAE 5.5e-5, max 1.24e-3)
NET_MAE, NET_MAX = 1e-4, 2.5e-3
# JAX's int8 tier (tests/test_quant.py::test_int8_score_map_close): int8
# against the unquantised map of the same net
TIER_MAE, TIER_MAX = 5e-3, 5e-2
# uint16 gray maps in [-1, 1]: the predict CLI's band (tests/test_torch_predict_cli.py)
COUNTS = 32
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _to_torch(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _ulps(got: torch.Tensor, want: torch.Tensor) -> int:
    """The largest distance in units in the last place of the dtype."""
    bits, mask = (torch.int16, 0x7FFF) if got.dtype == torch.bfloat16 else (torch.int32, 0x7FFFFFFF)
    a, b = (t.contiguous().view(bits).long() for t in (got, want))
    a, b = (torch.where(v < 0, -(v & mask), v) for v in (a, b))
    return int((a - b).abs().max())


def _rows() -> np.ndarray:
    """(8, 64) fp32: random rows, a zero row (the eps path), a row of
    absmax 127 holding exact ties (s = 1: codes of +-0.5, 1.5, 2.5, 3.5), a
    row of one outlier, a row of tiny values and an all-negative row."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, 64)).astype(np.float32)
    x[1] = 0.0
    x[2] = np.resize(np.array([127.0, 2.5, -2.5, 3.5, -3.5, 0.5, -0.5, 1.5, -1.5, 126.5], np.float32), 64)
    x[3, 5] = 1000.0
    x[4] *= 1e-9
    x[5] = -np.abs(x[5])
    return x


# --- the row quantisation (Q1's plain version) -----------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("side", ["rowwise", "colwise"])
def test_quantize_rowwise_plain_is_jax_bit_for_bit(dtype, side):
    tdt, jdt = DTYPES[dtype]
    x = _rows()
    xt = _to_torch(x, tdt)
    q, s = quant.quantize_rowwise_plain(xt)
    if side == "rowwise":
        jq, js = jax_quantize_rowwise(jnp.asarray(x, jdt))
    else:  # JAX's (K, N) kernel: per-output-channel scales of the columns
        jq, js = quantize_colwise(jnp.asarray(x.T, jdt))
        jq, js = jnp.transpose(jq), jnp.transpose(js)
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and s.shape == (8, 1)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    # the ties of row 2 round half to even, the zero row takes the eps scale
    assert q[2, 1:10].tolist() == [2, -2, 4, -4, 0, 0, 2, -2, 126]
    assert q[1].abs().max() == 0 and float(s[1, 0]) == np.float32(np.float32(1e-8) / np.float32(127.0))
    assert q[3, 5] == 127 and q[3].abs().sum() == 127  # the outlier takes the row's whole range


def test_jitted_jax_scales_multiply_by_the_reciprocal():
    """A known deviation inside the reference: compiled, JAX's ``s = m /
    127`` becomes ``m * fl(1/127)`` (XLA's algebraic simplifier), one ulp
    off the division, which the port computes as the source reads, on some
    rows; the codes then differ only where x / s sits at a rounding boundary."""
    x = np.random.default_rng(1).standard_normal((512, 384)).astype(np.float32)
    _, js = jax.jit(jax_quantize_rowwise)(jnp.asarray(x))
    _, s = quant.quantize_rowwise_plain(torch.from_numpy(x))
    m = np.maximum(np.abs(x).max(-1, keepdims=True), np.float32(1e-8))
    np.testing.assert_array_equal(np.asarray(js), m * np.float32(1 / 127.0))
    np.testing.assert_array_equal(s.numpy(), m / np.float32(127.0))
    assert _ulps(torch.from_numpy(np.array(js)), s) <= 1 and not np.array_equal(np.asarray(js), s.numpy())


# --- the W8A8 linear (Q2's plain version with Q1's) --------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", [(37, 64, 192), (300, 384, 1536), (129, 1536, 384)])
def test_int8_linear_plain_matches_quantdense(dtype, m, k, n):
    tdt, jdt = DTYPES[dtype]
    rng = np.random.default_rng(m)
    x = rng.standard_normal((m, k)).astype(np.float32)
    kernel = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(n)).astype(np.float32)
    xj = jnp.asarray(x, jdt)
    want = QuantDense(n, dtype=jdt).apply({"params": {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)}},
                                          xj)
    got = quant.int8_linear_plain(_to_torch(np.asarray(xj, np.float32), tdt), torch.from_numpy(kernel.T.copy()),
                                  torch.from_numpy(bias))
    assert got.dtype == tdt and got.shape == (m, n)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)
    else:
        assert _ulps(got, _to_torch(np.asarray(want, np.float32), tdt)) <= 1
    # the wrapper takes the plain version on the CPU, counting nothing
    before = (quant.int8_linear.launches, quant.quantize_rowwise.launches)
    torch.testing.assert_close(quant.int8_linear(_to_torch(np.asarray(xj, np.float32), tdt),
                                                 torch.from_numpy(kernel.T.copy()), torch.from_numpy(bias)),
                               got, atol=0, rtol=0)
    assert (quant.int8_linear.launches, quant.quantize_rowwise.launches) == before


def test_int8_linear_takes_quantised_operands():
    """(codes, scales) pairs give what the float operands give; a pair needs
    ``dtype``; shapes must match."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((5, 3, 64)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((40, 64)).astype(np.float32))
    want = quant.int8_linear(x, w)
    got = quant.int8_linear(quant.quantize_rowwise(x), quant.quantize_rowwise(w), dtype=torch.float32)
    assert got.shape == (5, 3, 40)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    with pytest.raises(ValueError, match="dtype"):
        quant.int8_linear(quant.quantize_rowwise(x), w)
    with pytest.raises(ValueError, match="does not match"):
        quant.int8_linear(x, w[:, :32])


def test_int8_matmul_accuracy():
    """tests/test_quant.py::test_int8_matmul_accuracy on the port."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((256, 384)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((384, 512)) / np.sqrt(384)).astype(np.float32))
    ref = x @ w
    got = quant.int8_linear_plain(x, w.t().contiguous())
    rel = float((got - ref).abs().max() / ref.abs().max())
    assert rel < 0.02, rel
    want = np.asarray(int8_matmul(jnp.asarray(x.numpy()), jnp.asarray(w.numpy())))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


def test_int8_matmul_outlier_rows():
    """tests/test_quant.py::test_int8_matmul_outlier_rows on the port: per-row
    activation scales keep an outlier token from wrecking the rest."""
    rng = np.random.default_rng(1)
    x = np.asarray(rng.standard_normal((64, 128)), np.float32)
    x[3] *= 1000.0
    w = np.asarray(rng.standard_normal((128, 64)) / np.sqrt(128), np.float32)
    ref = x @ w
    got = quant.int8_linear_plain(torch.from_numpy(x), torch.from_numpy(w.T.copy())).numpy()
    rel = np.abs(got[:3] - ref[:3]).max() / np.abs(ref[:3]).max()
    assert rel < 0.02, rel


# --- the small net --------------------------------------------------------------


def _jax_cfg(quant_mode: str) -> JaxConfig:
    return JaxConfig(backbone=JAX_VIT["dinov2-test"], pe_h=6, pe_w=6, decoder_heads=4, decoder_layers=1,
                     backbone_quant=quant_mode)


def _port_cfg(quant_mode: str, **kw) -> CrossScoreConfig:
    return CrossScoreConfig(backbone=VIT_PRESETS["dinov2-test"], pe_h=6, pe_w=6, decoder_heads=4,
                            decoder_layers=1, backbone_quant=quant_mode, compute_dtype=torch.float32, **kw)


@pytest.fixture(scope="module")
def nets():
    """JAX's int8 net at tests/test_quant.py's size (VIT 64 wide, 2 layers, 4
    heads, 56 px; fp32, B=2, K=2), its weights and score map, and the
    inputs."""
    rng = np.random.default_rng(0)
    q = rng.standard_normal((2, 56, 56, 3)).astype(np.float32)
    r = rng.standard_normal((2, 2, 56, 56, 3)).astype(np.float32)
    net = JaxNet(_jax_cfg("int8"))
    # compiled (3x faster than eager here): its scales are the reciprocal's,
    # which moves this map by ~2e-7
    params = jax.device_get(jax.jit(net.init)(jax.random.PRNGKey(0), jnp.asarray(q), jnp.asarray(r))["params"])
    want = np.asarray(jax.jit(net.apply)({"params": params}, jnp.asarray(q), jnp.asarray(r))["score_map_ref_cross"])
    return params, q, r, want


def _port_map(params, q, r, quant_mode: str, **kw) -> np.ndarray:
    model = load_into(CrossScoreNet(_port_cfg(quant_mode, **kw), device="cpu"), state_dict_from_jax(params))
    return make_predict_step(model)(torch.from_numpy(q), torch.from_numpy(r))["score_map_ref_cross"].numpy()


@pytest.mark.parametrize("impl,mlp", [("flash", "fused"), ("dense", "unfused")])
def test_int8_net_matches_jax(nets, impl, mlp):
    params, q, r, want = nets
    got = _port_map(params, q, r, "int8", attention_impl=impl, mlp_impl=mlp)
    err = np.abs(got - want)
    assert float(err.mean()) < NET_MAE and float(err.max()) < NET_MAX, (float(err.mean()), float(err.max()))


def test_int8_tier_against_the_unquantised_net(nets):
    """JAX's int8 tier on the port: the same weights without quantisation."""
    params, q, r, _ = nets
    err = np.abs(_port_map(params, q, r, "int8") - _port_map(params, q, r, "none"))
    assert 0 < float(err.mean()) < TIER_MAE and float(err.max()) < TIER_MAX, (float(err.mean()), float(err.max()))


# --- config and routing -------------------------------------------------------------


def test_config_rules_match_jax():
    """``model.gpu.backbone_quant`` as JAX's ``model.tpu.backbone_quant``:
    read by ``from_config``, forced to none by parity, unknown values refused."""
    from crossscore_tpu.confsys import load_config as jax_load_config

    for over, want in (([], "none"), (["int8"], "int8"), (["int8", "parity"], "none")):
        port = ["model.gpu.backbone_quant=int8"] * ("int8" in over) + ["model.gpu.parity=true"] * ("parity" in over)
        jax_over = [o.replace("gpu", "tpu") for o in port]
        assert CrossScoreConfig.from_config(load_config("default", port)).backbone_quant == want
        assert JaxConfig.from_config(jax_load_config("default", jax_over)).backbone_quant == want
    assert _port_cfg("int8", parity=True).backbone_quant == "none"
    with pytest.raises(ValueError, match="backbone_quant"):
        _port_cfg("int4")
    with pytest.raises(ValueError, match="backbone_quant"):
        CrossScoreConfig.from_config(load_config("default", ["model.gpu.backbone_quant=int4"]))


def test_tp_under_int8_builds_and_runs(monkeypatch):
    """``ViTAttention`` on the tp route under int8 builds and runs: one gloo
    rank in this process (TP = 1) against the dense route's int8 attention
    on the same weights (the int8 products are exact; only the attention
    core's summation order differs). With autograd on, the frozen int8
    layers refuse to run. tests/test_torch_tp_int8.py holds TP = 2 and DP x
    TP against JAX's tp:model int8 step."""
    from crossscore_tpu_torch.parallel import mesh
    from crossscore_tpu_torch.parallel.launch import free_port

    for k, v in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", LOCAL_WORLD_SIZE="1", MASTER_ADDR="127.0.0.1",
                     MASTER_PORT=str(free_port())).items():
        monkeypatch.setenv(k, v)
    mesh.init_distributed("gloo", "cpu")
    try:
        mesh.make_groups(1)
        vit = VIT_PRESETS["dinov2-test"]
        torch.manual_seed(0)
        tp = ViTAttention(vit, "tp", quant="int8")
        dense = ViTAttention(vit, "dense", quant="int8")
        dense.load_state_dict(tp.state_dict())
        x = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 17, vit.hidden_size)).astype(np.float32))
        with torch.no_grad():
            got, want = tp(x), dense(x)
        assert got.shape == (2, 17, vit.hidden_size)
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
        with pytest.raises(RuntimeError, match="no backward"):
            tp(x)
    finally:
        mesh.teardown()


def test_one_state_dict_serves_both_settings(nets):
    """The parameters are the same under both settings: one state dict loads
    strictly into either net and each computes a finite map."""
    params, q, r, _ = nets
    sd = state_dict_from_jax(params)
    keys = {}
    for mode in ("none", "int8"):
        model = load_into(CrossScoreNet(_port_cfg(mode), device="cpu"), sd)
        keys[mode] = {k: tuple(v.shape) for k, v in model.state_dict().items()}
        out = make_predict_step(model)(torch.from_numpy(q[:1]), torch.from_numpy(r[:1]))["score_map_ref_cross"]
        assert bool(torch.isfinite(out).all())
    assert keys["none"] == keys["int8"]


class _Spy:
    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *args, **kwargs):
        self.calls += 1
        return self.fn(*args, **kwargs)


@pytest.mark.parametrize("mode", ["none", "int8"])
def test_routing_under_int8(nets, monkeypatch, mode):
    """Under int8 with ``mlp_impl="fused"`` requested, K2 is never called
    and every backbone product (qkv, out, fc1, fc2 of each block) goes
    through the W8A8 linear; under none, the reverse."""
    params, q, r, _ = nets
    k2, lin = _Spy(port_dinov2.fused_ln_mlp), _Spy(port_dinov2.int8_linear)
    monkeypatch.setattr(port_dinov2, "fused_ln_mlp", k2)
    monkeypatch.setattr(port_dinov2, "int8_linear", lin)
    _port_map(params, q[:1], r[:1], mode, mlp_impl="fused")
    layers = VIT_PRESETS["dinov2-test"].num_layers
    # one backbone pass over the query and its references
    assert (k2.calls, lin.calls) == ((0, 4 * layers) if mode == "int8" else (layers, 0))


def test_bucketed_encode_under_int8_matches_unpadded(nets):
    """A bucket-padded image's valid tokens equal an unpadded encode's: the
    codes are per token and the padded tokens are masked out of attention."""
    params, *_ = nets
    cfg = _port_cfg("int8")
    model = load_into(CrossScoreNet(cfg, device="cpu"), state_dict_from_jax(params))
    rng = np.random.default_rng(7)
    imgs = rng.standard_normal((2, 84, 84, 3)).astype(np.float32)
    encode = make_backbone_encoder(cfg)
    got = encode(model, torch.from_numpy(imgs), np.array([[84, 84], [56, 70]], np.int32))
    want0 = encode(model, torch.from_numpy(imgs[:1]))
    want1 = encode(model, torch.from_numpy(imgs[1:, :56, :70].copy()))
    torch.testing.assert_close(got[0], want0[0], atol=2e-5, rtol=0)
    torch.testing.assert_close(got[1].reshape(6, 6, 64)[:4, :5], want1[0].reshape(4, 5, 64), atol=2e-5, rtol=0)


# --- the predict CLI --------------------------------------------------------------

QUERY = "datadir/res_540/s00001/test/ours_1000/renders"
REFS = "datadir/res_540/s00001/train/ours_1000/gt"
CLI = [
    "trainer.accelerator=cpu",
    "model.backbone.preset=dinov2-test",
    "data.neighbour_config.cross=2",
    f"data.dataset.query_dir={QUERY}",
    f"data.dataset.reference_dir={REFS}",
    "data.loader.validation.batch_size=2",
    "data.loader.validation.num_workers=1",
    "this_main.resize_short_side=84",
    "logger.predict.write.config.score_map_colour_mode=gray",
    "logger.predict.write.config.vis_img_every_n_steps=-1",
]


def test_predict_cli_int8_matches_jax(tmp_path, monkeypatch):
    """One predict run with int8 through both CLIs on one checkpoint (both
    loaders on Pillow): the same maps within 32 uint16 counts."""
    monkeypatch.setattr(fastimage, "available", lambda: False)
    monkeypatch.setattr(port_fastimage, "available", lambda: False)
    generate(tmp_path / "datadir", hw=(84, 112), scenes_per_split={"train": 1, "test": 1})
    cfg = CrossScoreConfig.from_config(load_config("default_predict", ["model.backbone.preset=dinov2-test"]))
    ckpt = tmp_path / "run" / "ckpt" / "model.ckpt"
    ckpt.parent.mkdir(parents=True)
    torch.save({"state_dict": {f"model.{k}": v for k, v in init_params(cfg, 3).items()}}, ckpt)
    monkeypatch.chdir(tmp_path)
    extra = [f"trainer.ckpt_path_to_load={ckpt}"]
    want = tmp_path / jax_main(CLI + extra + ["alias=jax", "model.tpu.compute_dtype=float32",
                                              "model.tpu.backbone_quant=int8"])
    got = tmp_path / port_main(CLI + extra + ["alias=port", "model.gpu.compute_dtype=float32",
                                              "model.gpu.backbone_quant=int8"])
    maps = sorted((got / "batch" / "score_map_ref_cross").glob("*.png"))
    assert len(maps) == 3
    for path in maps:
        a = np.asarray(Image.open(path)).astype(np.int64)
        b = np.asarray(Image.open(want / "batch" / "score_map_ref_cross" / path.name)).astype(np.int64)
        assert a.shape == b.shape == (84, 112), path.name
        assert np.abs(a - b).max() <= COUNTS, (path.name, np.abs(a - b).max())


# --- every entry point that builds the net ------------------------------------------

ENTRY_BASE = [
    "trainer.accelerator=cpu",
    "model.gpu.compute_dtype=float32",
    "model.backbone.preset=dinov2-test",
    "model.gpu.backbone_quant=int8",
    "data.neighbour_config.cross=2",
    "this_main.resize_short_side=-1",
    "seed=0",
]
TRAIN = [
    "data.dataset.path=[datadir]",
    "data.loader.train.batch_size=2",
    "data.loader.validation.batch_size=2",
    "data.loader.train.num_workers=1",
    "data.loader.validation.num_workers=1",
    "data.transforms.crop_size=56",
    "trainer.num_sanity_val_steps=0",
    "trainer.limit_val_batches=1",
    "trainer.max_steps=2",
    "logger.vis_scalar_every_n_train_steps=1",
]


def _train(tmp_path, extra):
    from crossscore_tpu_torch.tasks.train import main

    run_dir = tmp_path / main(ENTRY_BASE + TRAIN + extra)
    rows = [r for r in (json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines())
            if "train/loss" in r]
    assert [r["step"] for r in rows] == [1, 2]
    assert all(np.isfinite(r["train/loss"]) for r in rows)


def _entry_train(tmp_path):
    _train(tmp_path, ["alias=int8_pixel"])


def _entry_train_tokens(tmp_path):
    # the token loader encodes the crops' images into a fresh store
    _train(tmp_path, ["alias=int8_tokens", "this_main.train_recipe=token_fast", "this_main.token_fast_min_coverage=0.2",
                      f"this_main.ref_token_cache_dir={tmp_path / 'tokens'}"])


def _entry_test(tmp_path):
    from crossscore_tpu_torch.tasks.test import main

    out = tmp_path / main(ENTRY_BASE + ["data.dataset.path=[datadir]", "data.loader.validation.batch_size=2",
                                        "data.loader.validation.num_workers=1", "alias=int8_test",
                                        "logger.test.write.config.vis_img_every_n_steps=-1"])
    assert (out / "metrics.csv").exists()


def _entry_encode_tokens(tmp_path):
    from crossscore_tpu_torch.tasks.encode_tokens import main

    assert main(ENTRY_BASE + ["data.dataset.path=[datadir]", f"this_main.ref_token_cache_dir={tmp_path / 'store'}"]) > 0


def _entry_serve(tmp_path):
    from crossscore_tpu_torch.tasks.common import parse_cli
    from crossscore_tpu_torch.tasks.serve import Scorer

    scorer = Scorer(parse_cli("default_predict", [e for e in ENTRY_BASE if "resize_short_side" not in e] + [
        "this_main.resize_short_side=84", f"data.dataset.reference_dir={REFS}", "this_main.serve_max_refs=2",
        "this_main.serve_port=0"]))
    res = scorer.score_path(str(next(iter(sorted((tmp_path / QUERY).iterdir())))))
    assert res["score_map"].shape == (84, 112) and np.isfinite(res["score_map"]).all()


@pytest.mark.parametrize("entry", [_entry_train, _entry_train_tokens, _entry_test, _entry_encode_tokens,
                                   _entry_serve], ids=lambda f: f.__name__[len("_entry_"):])
def test_entry_points_route_through_int8(tmp_path, monkeypatch, entry):
    """``model.gpu.backbone_quant=int8`` reaches the backbone from the train
    CLI (pixel and token recipes: the token loader's encoder), the test CLI,
    ``encode_tokens`` and the serving daemon's ``Scorer``: every backbone
    product goes through the W8A8 linear and K2 is never called."""
    monkeypatch.setattr(port_fastimage, "available", lambda: False)
    generate(tmp_path / "datadir", hw=(84, 112), scenes_per_split={"train": 1, "val": 1, "test": 1})
    monkeypatch.chdir(tmp_path)
    k2, lin = _Spy(port_dinov2.fused_ln_mlp), _Spy(port_dinov2.int8_linear)
    monkeypatch.setattr(port_dinov2, "fused_ln_mlp", k2)
    monkeypatch.setattr(port_dinov2, "int8_linear", lin)
    entry(tmp_path)
    per_pass = 4 * VIT_PRESETS["dinov2-test"].num_layers
    assert k2.calls == 0 and lin.calls > 0 and lin.calls % per_pass == 0, (k2.calls, lin.calls)
