"""Shape-bucketed inference in the port against the JAX package on the CPU:
the masked kernels K5 and K6 (plain versions against the Pallas kernels in
interpret mode), the dense core, the valid-grid interpolation, the masked net
(padded + masked equals unpadded, and equals JAX), the cached predict step,
the backbone encoder and the reference-token cache. Inputs come from numpy
seeds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crossscore_tpu.models import CrossScoreConfig as JaxConfig
from crossscore_tpu.models import CrossScoreNet as JaxNet
from crossscore_tpu.models import ViTConfig as JaxViT
from crossscore_tpu.models.crossscore import make_backbone_encoder as jax_make_backbone_encoder
from crossscore_tpu.ops.attention import dense_attention as jax_dense_attention
from crossscore_tpu.ops.flash_attention import _flash_cross_ln_fwd, _flash_qkv_fwd
from crossscore_tpu.ops.interpolate import (
    interpolate_bicubic_dyn as jax_bicubic_dyn,
    interpolate_bilinear_align_corners_dyn as jax_bilinear_dyn,
)
from crossscore_tpu.train.step import make_predict_step_cached as jax_make_predict_step_cached
from crossscore_tpu_torch.data.token_cache import RefTokenCache
from crossscore_tpu_torch.io.convert import load_into, state_dict_from_jax
from crossscore_tpu_torch.models import CrossScoreConfig, CrossScoreNet, ViTConfig
from crossscore_tpu_torch.models.crossscore import make_backbone_encoder
from crossscore_tpu_torch.models.dinov2 import token_bias
from crossscore_tpu_torch.ops import flash_attention as fa
from crossscore_tpu_torch.ops.attention import dense_attention
from crossscore_tpu_torch.ops.interpolate import (
    interpolate_bicubic, interpolate_bicubic_dyn, interpolate_bilinear_align_corners,
    interpolate_bilinear_align_corners_dyn,
)
from crossscore_tpu_torch.train.step import make_predict_step, make_predict_step_cached

# fp32 kernel-level bound: summation order, exp against exp2
ATOL = 1e-5
# padded + masked against unpadded, max |d| (tests/test_bucketing.py's bound)
MASKED_TOL = 5e-4
# fp32 score maps against JAX: mean absolute error
MAE32 = 1e-4


def _bias(rng, b: int, n: int, form: str) -> np.ndarray:
    """A bucket mask (0 / -1e30, about a fifth masked) plus a small random
    additive part, so both the masking and the log2(e) scaling are seen;
    (B, N) per item or (N,) shared."""
    mask = np.where(rng.random((b, n)) < 0.2, -1e30, 0.0)
    mask[:, 0] = 0.0  # one valid column per row, as CLS always is
    bias = (mask + rng.standard_normal((b, n))).astype(np.float32)
    return bias if form == "item" else bias[1]


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


# --- the kernels' plain versions against the Pallas kernels -----------------


@pytest.mark.parametrize("form", ["item", "shared"])
@pytest.mark.parametrize("n", [37, 130])  # ragged: not a multiple of any tile
def test_k5_plain_matches_jax_kernel(form, n):
    rng = np.random.default_rng(n)
    b, h, hd = 2, 2, 64  # two heads fill the JAX kernel's 128-lane block
    qkv = rng.standard_normal((b, n, 3 * h * hd)).astype(np.float32)
    bias = _bias(rng, b, n, form)
    o_j, l_j, m_j = _flash_qkv_fwd(jnp.asarray(qkv), h, kv_bias=jnp.asarray(bias))
    o_t, l_t, m_t = fa.flash_qkv_self_attention_masked(torch.from_numpy(qkv), torch.from_numpy(bias), h)
    assert o_t.shape == (b, n, h * hd) and l_t.shape == m_t.shape == (b, h, n)
    np.testing.assert_allclose(_np(o_t), np.asarray(o_j), atol=ATOL, rtol=0)
    np.testing.assert_allclose(_np(m_t), np.asarray(m_j), atol=ATOL, rtol=1e-6)
    np.testing.assert_allclose(_np(l_t), np.asarray(l_j), atol=ATOL, rtol=1e-5)


@pytest.mark.parametrize("form", ["item", "shared"])
@pytest.mark.parametrize("nk", [150, 300])  # the JAX kernel pads Nk to its block: the masks combine
def test_k6_plain_matches_jax_kernel_hd64(form, nk):
    rng = np.random.default_rng(nk)
    b, nq, h, hd = 2, 37, 2, 64
    q, k, v = (rng.standard_normal((b, n, h * hd)).astype(np.float32) for n in (nq, nk, nk))
    bias = _bias(rng, b, nk, form)
    o_j, l_j, m_j = _flash_cross_ln_fwd(*(jnp.asarray(a) for a in (q, k, v)), h, hd, block_q=40,
                                        block_k=128, kv_bias=jnp.asarray(bias))
    o_t, l_t, m_t = fa.flash_cross_attention_masked(*(torch.from_numpy(a) for a in (q, k, v, bias)), h)
    np.testing.assert_allclose(_np(o_t), np.asarray(o_j), atol=ATOL, rtol=0)
    np.testing.assert_allclose(_np(m_t), np.asarray(m_j), atol=ATOL, rtol=1e-6)
    np.testing.assert_allclose(_np(l_t), np.asarray(l_j), atol=ATOL, rtol=1e-5)


@pytest.mark.parametrize("form", ["item", "shared"])
def test_k6_plain_matches_jax_padded_prescaled_route_hd48(form):
    """At hd 48 the JAX decoder pads heads to 64 lanes and folds sqrt(64/48)
    into q; the logits, so (o, l, m), equal the port's at the true hd."""
    rng = np.random.default_rng(48)
    b, nq, nk, h, hd, hd_pad = 2, 37, 150, 2, 48, 64
    prescale = (hd_pad ** 0.5) / (hd ** 0.5)
    q, k, v = (rng.standard_normal((b, n, h * hd)).astype(np.float32) for n in (nq, nk, nk))
    bias = _bias(rng, b, nk, form)

    def pad(x, s=1.0):
        x = np.pad((x * s).reshape(*x.shape[:2], h, hd), ((0, 0), (0, 0), (0, 0), (0, hd_pad - hd)))
        return jnp.asarray(x.reshape(*x.shape[:2], h * hd_pad).astype(np.float32))

    o_p, l_j, m_j = _flash_cross_ln_fwd(pad(q, prescale), pad(k), pad(v), h, hd_pad, block_q=40,
                                        block_k=128, kv_bias=jnp.asarray(bias))
    o_j = np.asarray(o_p).reshape(b, nq, h, hd_pad)[..., :hd].reshape(b, nq, h * hd)
    o_t, l_t, m_t = fa.flash_cross_attention_masked(*(torch.from_numpy(a) for a in (q, k, v, bias)), h)
    np.testing.assert_allclose(_np(o_t), o_j, atol=ATOL, rtol=0)
    np.testing.assert_allclose(_np(m_t), np.asarray(m_j), atol=ATOL, rtol=1e-6)
    np.testing.assert_allclose(_np(l_t), np.asarray(l_j), atol=ATOL, rtol=1e-5)


@pytest.mark.parametrize("form", ["item", "shared"])
def test_dense_attention_bias_matches_jax(form):
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((2, 3, n, 16)).astype(np.float32) for n in (9, 20, 20))
    bias = _bias(rng, 2, 20, form)
    want_o, want_p = jax_dense_attention(*(jnp.asarray(a) for a in (q, k, v)), kv_bias=jnp.asarray(bias),
                                         return_probs=True)
    got_o, got_p = dense_attention(*(torch.from_numpy(a) for a in (q, k, v)), kv_bias=torch.from_numpy(bias),
                                   return_probs=True)
    np.testing.assert_allclose(_np(got_o), np.asarray(want_o), atol=ATOL, rtol=0)
    np.testing.assert_allclose(_np(got_p), np.asarray(want_p), atol=1e-6, rtol=0)
    masked = np.broadcast_to(bias < -1e29, (2, 20))
    assert float(got_p[1][..., masked[1]].max()) == 0.0  # a masked token takes no weight


def test_masked_wrappers_on_cpu_count_nothing_and_check_inputs():
    qkv = torch.randn(2, 5, 3 * 32, generator=torch.Generator().manual_seed(0))
    bias = torch.zeros(2, 5)
    before = (fa.flash_qkv_self_attention_masked.launches, fa.flash_cross_attention_masked.launches)
    o, l, m = fa.flash_qkv_self_attention_masked(qkv, bias, 2)
    o_p, l_p, m_p = fa.flash_qkv_self_attention_plain(qkv, 2)  # a zero bias masks nothing
    torch.testing.assert_close(o, o_p, atol=1e-6, rtol=0)
    q = qkv[..., :32].contiguous()
    fa.flash_cross_attention_masked(q, q, q, bias[0], 2)
    assert (fa.flash_qkv_self_attention_masked.launches, fa.flash_cross_attention_masked.launches) == before
    with pytest.raises(ValueError, match="kv_bias must be float32"):
        fa.flash_qkv_self_attention_masked(qkv, torch.zeros(3, 5), 2)
    with pytest.raises(ValueError, match="kv_bias must be float32"):
        fa.flash_cross_attention_masked(q, q, q, torch.zeros(5, dtype=torch.float64), 2)
    with pytest.raises(RuntimeError, match="forward only"):
        fa.flash_cross_attention_masked(q.clone().requires_grad_(), q, q, bias[0], 2)
    with pytest.raises(RuntimeError, match="forward only"):
        fa.flash_qkv_self_attention_masked(qkv.clone().requires_grad_(), bias, 2)


# --- valid-grid interpolation ------------------------------------------------


@pytest.mark.parametrize("per_item", [False, True], ids=["shared", "item"])
def test_dyn_interpolation_matches_jax_and_static_form(per_item):
    rng = np.random.default_rng(5)
    pe = rng.standard_normal((6, 6, 8)).astype(np.float32)
    table = rng.standard_normal((4, 4, 8)).astype(np.float32)
    vh, vw = (np.array([5, 7]), np.array([8, 3])) if per_item else (np.int64(5), np.int64(6))
    cases = [
        (interpolate_bilinear_align_corners_dyn, jax_bilinear_dyn, interpolate_bilinear_align_corners, pe),
        (interpolate_bicubic_dyn, jax_bicubic_dyn, interpolate_bicubic, table),
    ]
    for port_dyn, jax_dyn, static, src in cases:
        got = port_dyn(torch.from_numpy(src), 7, 8, vh, vw).numpy()
        items = list(zip(vh, vw)) if per_item else [(vh, vw)]
        assert got.shape == ((2, 7, 8, 8) if per_item else (7, 8, 8))
        for i, (h, w) in enumerate(items):
            g = got[i] if per_item else got
            want = np.asarray(jax_dyn(jnp.asarray(src), 7, 8, jnp.asarray(h), jnp.asarray(w)))
            np.testing.assert_allclose(g[:h, :w], want[:h, :w], atol=1e-5, rtol=0)
            np.testing.assert_allclose(g[:h, :w], static(torch.from_numpy(src), int(h), int(w)).numpy(),
                                       atol=1e-5, rtol=0)
            assert not g[h:].any() and not g[:, w:].any()


def test_token_bias_forms():
    shared = token_bias(3, 4, (2, 3))
    assert shared.shape == (12,) and shared.dtype == np.float32
    assert (shared.reshape(3, 4)[:2, :3] == 0).all() and (shared.reshape(3, 4)[2] == -1e30).all()
    item = token_bias(3, 4, (np.array([3, 1]), np.array([4, 2])), cls=True)
    assert item.shape == (2, 13) and (item[:, 0] == 0).all()
    assert (item[0] == 0).all() and int((item[1] == 0).sum()) == 1 + 2


# --- the masked net ------------------------------------------------------------

VIT = dict(hidden_size=64, num_layers=2, num_heads=4, patch_size=14, image_size=56)


@pytest.fixture(scope="module")
def jax_params():
    model = JaxNet(JaxConfig(backbone=JaxViT(**VIT), pe_h=6, pe_w=6, decoder_heads=4))
    rng = np.random.default_rng(0)
    q = jnp.asarray(rng.standard_normal((1, 56, 56, 3)).astype(np.float32))
    r = jnp.asarray(rng.standard_normal((1, 2, 56, 56, 3)).astype(np.float32))
    return jax.device_get(model.init(jax.random.PRNGKey(0), q, r)["params"])


def _port(params, impl: str) -> CrossScoreNet:
    cfg = CrossScoreConfig(backbone=ViTConfig(**VIT), pe_h=6, pe_w=6, decoder_heads=4, attention_impl=impl,
                           mlp_impl="fused_exact" if impl == "flash" else "unfused",
                           compute_dtype=torch.float32)
    return load_into(CrossScoreNet(cfg, device="cpu"), state_dict_from_jax(params))


def _jax(impl: str) -> JaxNet:
    return JaxNet(JaxConfig(backbone=JaxViT(**VIT), pe_h=6, pe_w=6, decoder_heads=4, attention_impl=impl,
                            mlp_impl="xla"))


def _pad_to(x: np.ndarray, hw) -> np.ndarray:
    pad = [(0, 0)] * x.ndim
    pad[-3], pad[-2] = (0, hw[0] - x.shape[-3]), (0, hw[1] - x.shape[-2])
    return np.pad(x, pad)


@pytest.mark.parametrize("impl", ["flash", "dense"])
@pytest.mark.parametrize("true_hw", [(56, 84), (84, 70), (42, 98)])
def test_shared_valid_hw_matches_unpadded(jax_params, impl, true_hw):
    """The (2,) form: padded + masked equals the unpadded run on its valid
    region (tests/test_bucketing.py::test_padded_masked_forward_matches_unpadded)."""
    step = make_predict_step(_port(jax_params, impl))
    rng = np.random.default_rng(sum(true_hw))
    h, w = true_hw
    q = rng.standard_normal((2, h, w, 3)).astype(np.float32)
    r = rng.standard_normal((2, 3, h, w, 3)).astype(np.float32)
    want = step(torch.from_numpy(q), torch.from_numpy(r))["score_map_ref_cross"]
    got = step(torch.from_numpy(_pad_to(q, (98, 112))), torch.from_numpy(_pad_to(r, (98, 112))),
               np.array([h, w]))["score_map_ref_cross"]
    assert got.shape == (2, 98, 112)
    assert float((got[:, :h // 14 * 14, :w // 14 * 14] - want).abs().max()) < MASKED_TOL


@pytest.fixture(scope="module")
def packed_batch():
    """A bucket-packed batch mixing two extents in an 84x84 bucket, K=2."""
    rng = np.random.default_rng(7)
    q = rng.standard_normal((2, 84, 84, 3)).astype(np.float32)
    r = rng.standard_normal((2, 2, 84, 84, 3)).astype(np.float32)
    return q, r, np.array([[84, 84], [56, 70]], np.int32)


@pytest.mark.parametrize("impl", ["flash", "dense"])
def test_per_item_valid_hw_matches_unpadded(jax_params, packed_batch, impl):
    """The (B, 2) form (tests/test_bucketing.py::test_per_item_valid_hw_matches_unpadded)."""
    q, r, vhw = packed_batch
    step = make_predict_step(_port(jax_params, impl))
    out = step(torch.from_numpy(q), torch.from_numpy(r), vhw)["score_map_ref_cross"]
    want0 = step(torch.from_numpy(q[:1]), torch.from_numpy(r[:1]))["score_map_ref_cross"]
    want1 = step(torch.from_numpy(q[1:, :56, :70].copy()),
                 torch.from_numpy(r[1:, :, :56, :70].copy()))["score_map_ref_cross"]
    assert float((out[0] - want0[0]).abs().max()) < MASKED_TOL
    assert float((out[1, :56, :70] - want1[0]).abs().max()) < MASKED_TOL


@pytest.mark.parametrize("jax_impl", ["xla", "pallas"])
@pytest.mark.parametrize("form", ["item", "shared"])
def test_masked_net_matches_jax(jax_params, packed_batch, jax_impl, form):
    q, r, vhw = packed_batch
    if form == "shared":
        vhw = vhw[1]
    want = np.asarray(_jax(jax_impl).apply({"params": jax_params}, jnp.asarray(q), jnp.asarray(r),
                                           valid_hw=jnp.asarray(vhw) if form == "item"
                                           else (jnp.asarray(vhw[0]), jnp.asarray(vhw[1])))
                      ["score_map_ref_cross"])
    for impl in ("flash", "dense"):
        got = make_predict_step(_port(jax_params, impl))(torch.from_numpy(q), torch.from_numpy(r),
                                                         vhw)["score_map_ref_cross"].numpy()
        rows = [vhw] * 2 if form == "shared" else vhw
        for i, (h, w) in enumerate(rows):
            ch, cw = h // 14 * 14, w // 14 * 14
            assert float(np.abs(got[i, :ch, :cw] - want[i, :ch, :cw]).mean()) < MAE32, (impl, i)


# --- the backbone encoder and the cached step ----------------------------------


@pytest.mark.parametrize("masked", [False, True])
def test_backbone_encoder_matches_jax(jax_params, packed_batch, masked):
    q, _, vhw = packed_batch
    cfg = _port(jax_params, "flash").cfg
    vhw = vhw if masked else None
    want = np.asarray(jax_make_backbone_encoder(_jax("xla").cfg)(jax_params, jnp.asarray(q),
                                                                 None if vhw is None else jnp.asarray(vhw)))
    got = make_backbone_encoder(cfg)(_port(jax_params, "flash"), torch.from_numpy(q), vhw)
    assert got.shape == (2, 36, 64)
    if masked:  # the valid tokens of item 1: a 4x5 grid of the 6x6 one
        got, want = got.reshape(2, 6, 6, 64)[1, :4, :5], want.reshape(2, 6, 6, 64)[1, :4, :5]
    np.testing.assert_allclose(_np(got), want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("masked", [False, True])
def test_cached_step_equals_uncached(jax_params, packed_batch, masked):
    """The cached step is the ``ref_tokens`` path exactly, and equals the
    pixel path to float reduction-order noise (the references are encoded in
    another batch); it matches JAX's cached step on the same tokens."""
    q, r, vhw = packed_batch
    vhw = vhw if masked else None
    model = _port(jax_params, "flash")
    encode = make_backbone_encoder(model.cfg)
    tokens = encode(model, torch.from_numpy(r.reshape(4, 84, 84, 3)),
                    None if vhw is None else np.repeat(vhw, 2, axis=0)).reshape(2, 2, 36, 64)
    qt = torch.from_numpy(q)
    got = make_predict_step_cached(model)(qt, tokens, vhw)["score_map_ref_cross"]
    with torch.inference_mode():
        direct = model(qt, None, ref_tokens=tokens, valid_hw=vhw)["score_map_ref_cross"]
    assert torch.equal(got, direct)
    pixels = make_predict_step(model)(qt, torch.from_numpy(r), vhw)["score_map_ref_cross"]
    torch.testing.assert_close(got, pixels, atol=1e-5, rtol=0)
    want = np.asarray(jax_make_predict_step_cached(_jax("xla"))(
        jax_params, jnp.asarray(q), jnp.asarray(tokens.numpy()),
        None if vhw is None else jnp.asarray(vhw))["score_map_ref_cross"])
    for i, (h, w) in enumerate([(84, 84)] * 2 if vhw is None else vhw):  # the valid regions
        assert float(np.abs(got.numpy()[i, :h, :w] - want[i, :h, :w]).mean()) < MAE32


def test_ref_grid_and_token_checks(jax_params):
    model = _port(jax_params, "flash")
    q = torch.zeros(1, 56, 56, 3)
    with pytest.raises(ValueError, match="ref_tokens carry 9 patches"):
        model(q, None, ref_tokens=torch.zeros(1, 2, 9, 64))
    with pytest.raises(ValueError, match="only meaningful with ref_tokens"):
        model(q, torch.zeros(1, 2, 56, 56, 3), ref_grid=(4, 4))
    with pytest.raises(ValueError, match="not both"):
        model(q, torch.zeros(1, 2, 56, 56, 3), ref_tokens=torch.zeros(1, 2, 16, 64))
    with pytest.raises(ValueError, match="grids to match"):
        model(q, None, ref_tokens=torch.zeros(1, 2, 9, 64), ref_grid=(3, 3), valid_hw=np.array([56, 56]))
    out = model(q, None, ref_tokens=torch.zeros(1, 2, 9, 64), ref_grid=(3, 3))  # another grid per view
    assert out["score_map_ref_cross"].shape == (1, 56, 56)


# --- the reference-token cache ------------------------------------------------------


class _Encoder:
    """Stands in for the backbone: a token per image that depends on its
    pixels and valid extent; records the batch shapes it was called with."""

    def __init__(self):
        self.calls = []

    def __call__(self, imgs, valid_hw=None):
        self.calls.append((imgs.shape[0], None if valid_hw is None else np.asarray(valid_hw).copy()))
        x = torch.from_numpy(np.ascontiguousarray(imgs)).float().mean(dim=(1, 2, 3))
        extra = 0.0 if valid_hw is None else torch.from_numpy(np.asarray(valid_hw)).float().sum(1)
        return (x + extra)[:, None, None].expand(-1, 4, 3).to(torch.bfloat16)


def _refs(tmp_path, n: int):
    paths = []
    for i in range(n):
        p = tmp_path / f"ref{i}.png"
        p.write_bytes(b"x")
        paths.append(str(p))
    imgs = np.stack([np.full((8, 8, 3), i, np.float32) for i in range(n)])
    return paths, imgs


def test_token_cache_hits_misses_and_fixed_batches(tmp_path):
    paths, imgs = _refs(tmp_path, 3)
    enc = _Encoder()
    cache = RefTokenCache(enc, encode_batch=4, max_items=10)
    ref_paths = [[paths[0], paths[1]], [paths[2], paths[0]]]  # (K=2, B=2)
    ref_imgs = np.stack([np.stack([imgs[0], imgs[2]]), np.stack([imgs[1], imgs[0]])])
    tokens = cache.gather(ref_paths, ref_imgs)
    assert tokens.shape == (2, 2, 4, 3) and tokens.dtype == torch.bfloat16
    assert (cache.hits, cache.misses) == (0, 3) and [c[0] for c in enc.calls] == [4]  # padded chunk
    assert torch.equal(tokens[0, 0], tokens[1, 1])  # the same image in two slots
    assert float(tokens[1, 0, 0, 0]) == 1.0
    again = cache.gather(ref_paths, ref_imgs)
    assert torch.equal(again, tokens) and (cache.hits, cache.misses) == (4, 3) and len(enc.calls) == 1


def test_token_cache_lru_eviction(tmp_path):
    paths, imgs = _refs(tmp_path, 3)
    cache = RefTokenCache(_Encoder(), encode_batch=1, max_items=2)
    for i in (0, 1, 0, 2):  # touch 0 again: 1 is the least recent when 2 arrives
        cache.gather([[paths[i]]], imgs[i][None, None])
    assert len(cache) == 2 and cache.misses == 3
    cache.gather([[paths[0]]], imgs[0][None, None])
    assert cache.misses == 3  # 0 survived
    cache.gather([[paths[1]]], imgs[1][None, None])
    assert cache.misses == 4  # 1 was evicted


def test_token_cache_keys_by_valid_extent(tmp_path):
    paths, imgs = _refs(tmp_path, 1)
    enc = _Encoder()
    cache = RefTokenCache(enc, encode_batch=2)
    a = cache.gather([[paths[0]]], imgs[None, :1], valid_hw=np.array([[6, 7]]))
    b = cache.gather([[paths[0]]], imgs[None, :1], valid_hw=np.array([[8, 8]]))  # the full extent
    c = cache.gather([[paths[0]]], imgs[None, :1], valid_hw=np.array([6, 7]))  # shared form, same key as a
    assert cache.misses == 2 and cache.hits == 1 and torch.equal(a, c) and not torch.equal(a, b)
    np.testing.assert_array_equal(enc.calls[0][1], [[6, 7], [6, 7]])  # the valid extent reaches the encoder
    assert len(RefTokenCache._key(paths[0], (8, 8), (8, 8))) == 3  # an unpadded extent adds nothing


def test_token_cache_persist_dir_round_trip(tmp_path):
    paths, imgs = _refs(tmp_path, 2)
    store = tmp_path / "tokens"
    first = RefTokenCache(_Encoder(), encode_batch=2, persist_dir=store)
    want = first.gather([[paths[0], paths[1]]], imgs[:, None])
    assert len(list(store.glob("*.npz"))) == 2
    enc = _Encoder()
    second = RefTokenCache(enc, encode_batch=2, persist_dir=store)  # a new process, warm disk
    got = second.gather([[paths[0], paths[1]]], imgs[:, None])
    assert torch.equal(got, want) and got.dtype == torch.bfloat16
    assert (second.misses, second.disk_hits, len(enc.calls)) == (0, 2, 0)
    (store / next(store.glob("*.npz")).name).write_bytes(b"torn")  # a partial write re-encodes
    third = RefTokenCache(_Encoder(), encode_batch=2, persist_dir=store)
    torch.testing.assert_close(third.gather([[paths[0], paths[1]]], imgs[:, None]), want)
    assert third.misses == 1
