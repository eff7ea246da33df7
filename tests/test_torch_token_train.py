"""Token-space training in the port against the JAX package on the CPU: the
decoder-only graph (forward, loss and decoder/head gradients), the window
primitives, ``TokenSpaceLoader``, ``apply_train_recipe``, the token_fast
coverage guard and the cache-capacity check (with the two repairs the port
makes), and the train CLI with token batches. Weights are carried across with
``state_dict_from_jax``; inputs come from a numpy seed; fp32."""

import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crossscore_tpu.data import fastimage as jax_fastimage
from crossscore_tpu.data.loader import _fold_rng as jax_fold_rng
from crossscore_tpu.data.nvs_index import ConcatDataset as JaxConcat
from crossscore_tpu.data.nvs_index import NvsDataset as JaxNvsDataset
from crossscore_tpu.data.token_cache import RefTokenCache as JaxCache
from crossscore_tpu.data.token_train import TokenSpaceLoader as JaxTokenLoader
from crossscore_tpu.data.token_train import aligned_window as jax_aligned_window
from crossscore_tpu.data.token_train import crop_token_grid as jax_crop_token_grid
from crossscore_tpu.models import CrossScoreConfig as JaxConfig
from crossscore_tpu.models import CrossScoreNet as JaxNet
from crossscore_tpu.models.crossscore import make_backbone_encoder as jax_make_encoder
from crossscore_tpu.models.dinov2 import VIT_PRESETS as JAX_VIT
from crossscore_tpu.tasks.common import parse_cli as jax_parse_cli
from crossscore_tpu.tasks.train import apply_train_recipe as jax_apply_recipe
from crossscore_tpu.tasks.train import token_fast_coverage_guard as jax_coverage_guard
from crossscore_tpu.train.step import loss_fn as jax_loss_fn
from crossscore_tpu_torch.data import fastimage as port_fastimage
from crossscore_tpu_torch.data.loader import _fold_rng
from crossscore_tpu_torch.data.nvs_index import ConcatDataset, NvsDataset
from crossscore_tpu_torch.data.synthetic import generate
from crossscore_tpu_torch.data.token_cache import RefTokenCache
from crossscore_tpu_torch.data.token_train import (
    _WINDOW_SEED_OFFSET, TokenSpaceLoader, aligned_window, crop_token_grid,
)
from crossscore_tpu_torch.io.convert import load_into, state_dict_from_jax
from crossscore_tpu_torch.models import VIT_PRESETS, CrossScoreConfig, CrossScoreNet
from crossscore_tpu_torch.models.crossscore import make_backbone_encoder
from crossscore_tpu_torch.tasks.common import parse_cli
from crossscore_tpu_torch.tasks.train import apply_train_recipe, main, token_fast_coverage_guard
from crossscore_tpu_torch.train.step import loss_fn

# the decoder-only graph, fp32 on both sides: the JAX package's own bound for
# its token graph against its pixel graph (tests/test_token_train.py), met
# here across the two packages as well (summation order only)
TOL = 1e-6
# the port's established fp32 bounds: the encoder's tokens (the net's TOL32,
# tests/test_torch_model.py) and each gradient leaf relative to its largest
# entry (tests/test_torch_train.py)
TOK_TOL = 2e-5
GRAD_RTOL = 1e-4


@pytest.fixture(scope="module")
def nets():
    """The same weights in both packages: dinov2-test, a 6x6 PE table, fp32."""
    jnet = JaxNet(JaxConfig(backbone=JAX_VIT["dinov2-test"], pe_h=6, pe_w=6))
    rng = np.random.default_rng(0)
    q = rng.standard_normal((2, 56, 70, 3)).astype(np.float32)
    r = rng.standard_normal((2, 3, 56, 70, 3)).astype(np.float32)
    params = jax.device_get(jnet.init(jax.random.PRNGKey(0), q, r)["params"])
    cfg = CrossScoreConfig(backbone=VIT_PRESETS["dinov2-test"], pe_h=6, pe_w=6, compute_dtype=torch.float32,
                           mlp_impl="unfused")
    model = load_into(CrossScoreNet(cfg, device="cpu"), state_dict_from_jax(params))
    return jnet, params, model, q, r


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("token_tree")
    generate(root, hw=(84, 112), scenes_per_split={"train": 1, "val": 1, "test": 1})
    return root


def _token_batch(seed, b=2, k=3, grid=(4, 4), d=64):
    rng = np.random.default_rng(seed)
    n = grid[0] * grid[1]
    return {"query/tokens": rng.standard_normal((b, n, d)).astype(np.float32),
            "reference/cross/tokens": rng.standard_normal((b, k, n, d)).astype(np.float32),
            "query/score_map": rng.random((b, grid[0] * 14, grid[1] * 14)).astype(np.float32)}


def _port_grads(model):
    return {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}


def test_decoder_only_graph_matches_jax(nets):
    """The port's ``query_tokens`` graph through ``loss_fn`` against JAX's on
    the same weights and tokens: the loss, the score map and every decoder
    and head gradient; the backbone and the PE take none."""
    jnet, params, model, _, _ = nets
    batch = _token_batch(1)
    (loss_j, (pred_j, _, _)), grads_j = jax.jit(jax.value_and_grad(
        lambda p, bt: jax_loss_fn(jnet, p, bt), has_aux=True))(params, {k: jnp.asarray(v) for k, v in batch.items()})
    want = state_dict_from_jax(jax.device_get(grads_j))
    model.zero_grad(set_to_none=True)
    loss, (pred, _, _) = loss_fn(model, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    assert pred.shape == (2, 56, 56)
    np.testing.assert_allclose(pred.detach().numpy(), np.asarray(pred_j), rtol=0, atol=TOL)
    assert loss.item() == pytest.approx(float(loss_j), rel=TOL)
    grads = _port_grads(model)
    assert grads and all(n.startswith("ref_cross.") for n in grads)
    for name, g in grads.items():
        gw = want[f"model.{name}"]
        err = float(np.abs(g.numpy() - gw).max()) / float(np.abs(gw).max())
        assert err <= GRAD_RTOL, (name, err)
    assert len(grads) == sum(1 for n, _ in model.named_parameters() if n.startswith("ref_cross."))
    model.zero_grad(set_to_none=True)


def test_token_graph_equals_pixel_graph(nets):
    """Tokens encoded from the same images (one grouped encode, as the pixel
    graph's) give the pixel graph's score map and trainable gradients."""
    _, _, model, q, r = nets
    b, k = r.shape[:2]
    qt, rt = torch.from_numpy(q), torch.from_numpy(r)
    tokens = make_backbone_encoder(model.cfg)(model, torch.cat([qt, rt.reshape(b * k, *rt.shape[2:])]))
    q_tok, r_tok = tokens[:b], tokens[b:].reshape(b, k, *tokens.shape[1:])
    gt = torch.from_numpy(np.random.default_rng(2).random((b, 56, 70)).astype(np.float32))
    out = {}
    for name, kw in (("pixel", dict(query_img=qt, ref_imgs=rt)),
                     ("token", dict(query_img=None, ref_imgs=None, ref_tokens=r_tok, query_tokens=q_tok,
                                    token_grid=(4, 5)))):
        model.zero_grad(set_to_none=True)
        pred = model(**kw)["score_map_ref_cross"]
        (pred - gt).abs().mean().backward()
        out[name] = (pred.detach(), _port_grads(model))
    np.testing.assert_allclose(out["token"][0].numpy(), out["pixel"][0].numpy(), rtol=0, atol=TOL)
    assert out["token"][1].keys() == out["pixel"][1].keys()
    for name, g in out["pixel"][1].items():
        err = float((out["token"][1][name] - g).abs().max() / g.abs().max())
        assert err <= TOL, (name, err)
    model.zero_grad(set_to_none=True)


@pytest.mark.parametrize("case", ["no_refs", "both_queries", "grid", "valid_hw", "norm_img"])
def test_guards_match_jax(nets, case):
    """The decoder-only graph refuses what JAX's refuses, with its messages."""
    jnet, params, model, _, _ = nets
    batch = _token_batch(3)
    qt, rt = batch["query/tokens"], batch["reference/cross/tokens"]
    q_img = np.zeros((2, 56, 56, 3), np.float32)
    kw, match = {"no_refs": ({"query_tokens": qt, "token_grid": (4, 4)}, "requires ref_tokens"),
                 "both_queries": ({"query_img": q_img, "ref_tokens": rt, "query_tokens": qt,
                                   "token_grid": (4, 4)}, "not both"),
                 "grid": ({"ref_tokens": rt, "query_tokens": qt, "token_grid": (5, 4)}, "token_grid is"),
                 "valid_hw": ({"ref_tokens": rt, "query_tokens": qt, "token_grid": (4, 4),
                               "valid_hw": np.asarray([56, 56])}, "pixel-space"),
                 "norm_img": ({"ref_tokens": rt, "query_tokens": qt, "token_grid": (4, 4), "norm_img": True},
                              "pixel-space")}[case]
    jkw = {"query_img": None, "ref_imgs": None} | {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
                                                  for k, v in kw.items()}
    with pytest.raises(ValueError, match=match):
        jnet.apply({"params": params}, **jkw)
    tkw = {"query_img": None, "ref_imgs": None} | {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
                                                  for k, v in kw.items() if k != "valid_hw"}
    if "valid_hw" in kw:
        tkw["valid_hw"] = kw["valid_hw"]
    with pytest.raises(ValueError, match=match):
        model(**tkw)


def test_window_primitives_match_jax():
    """A seeded fuzz like the JAX package's ``test_window_primitives_fuzz``:
    the same rng gives the same windows, and the port's token windows equal
    JAX's numpy ones (any leading dims, fp32 and fp16), also when copied into
    a preallocated tensor."""
    rng = np.random.default_rng(42)
    for _ in range(25):
        gh, gw = int(rng.integers(2, 12)), int(rng.integers(2, 12))
        ch, cw = int(rng.integers(1, gh + 1)), int(rng.integers(1, gw + 1))
        d = int(rng.integers(1, 9)) * 8
        lead = () if rng.random() < 0.5 else (int(rng.integers(1, 4)),)
        dtype = rng.choice([np.float32, np.float16])
        toks = rng.standard_normal((*lead, gh * gw, d)).astype(dtype)
        rng_j = np.random.default_rng()
        rng_j.bit_generator.state = rng.bit_generator.state  # the same draws on both sides
        ij = aligned_window((gh, gw), (ch, cw), rng)
        assert ij == jax_aligned_window((gh, gw), (ch, cw), rng_j)
        assert 0 <= ij[0] <= gh - ch and 0 <= ij[1] <= gw - cw
        want = jax_crop_token_grid(toks, (gh, gw), ij, (ch, cw))
        got = crop_token_grid(torch.from_numpy(toks), (gh, gw), ij, (ch, cw))
        np.testing.assert_array_equal(got.numpy(), want)
        out = torch.empty(*lead, ch * cw, d, dtype=got.dtype)
        assert crop_token_grid(torch.from_numpy(toks), (gh, gw), ij, (ch, cw), out=out) is out
        np.testing.assert_array_equal(out.numpy(), want)
    assert aligned_window((6, 8), (4, 5), rng, deterministic=True) == (0, 0)
    with pytest.raises(ValueError, match="larger"):
        aligned_window((3, 8), (4, 5), rng)


def _datasets(tree, crop_mode="integer_patches"):
    kw = dict(dataset_path=str(tree), resolution="res_540", data_split="train",
              neighbour_config={"strategy": "random", "cross": 2, "deterministic": False},
              metric_type="ssim", metric_min=0, metric_max=1, crop_size=None, crop_mode=crop_mode,
              return_item_paths=True)
    return JaxNvsDataset(**kw), NvsDataset(**kw)


def _loaders(nets, tree, **kw):
    jnet, params, model, _, _ = nets
    encode = jax.jit(jax_make_encoder(jnet.cfg))
    encoder = make_backbone_encoder(model.cfg)
    ds_j, ds_t = _datasets(tree)
    kw = dict(crop_size=56, batch_size=3, shuffle=True, seed=3, num_workers=2) | kw
    jl = JaxTokenLoader(ds_j, JaxCache(lambda imgs, valid_hw=None: encode({"backbone": params["backbone"]}, imgs),
                                       encode_batch=4), **kw)
    tl = TokenSpaceLoader(ds_t, RefTokenCache(lambda imgs, valid_hw=None: encoder(model, torch.from_numpy(imgs)),
                                              encode_batch=4), **kw)
    return jl, tl


def test_token_loader_matches_jax(nets, tree, monkeypatch):
    """Seven items at batch 3 (the last batch padded by repeating its final
    index): the plans, score-map crops and _valid equal JAX's exactly for the
    same seed and epoch (both packages on their Pillow paths;
    tests/test_torch_records.py holds the native path with the decode skip);
    the token windows equal JAX's within the encoder's bound (a window off by
    one patch would differ by O(1))."""
    monkeypatch.setattr(jax_fastimage, "available", lambda: False)
    monkeypatch.setattr(port_fastimage, "available", lambda: False)
    jl, tl = _loaders(nets, tree)
    for epoch in (0, 1):
        plan_j, plan_t = jl._plan(epoch), tl._plan(epoch)
        assert [(list(c), n) for c, n, _ in plan_j] == [(list(c), n) for c, n, _ in plan_t]
        assert plan_t[-1][1] == 1  # 7 = 3 + 3 + 1: pad_last
        bj, bt = list(jl.epoch(epoch)), list(tl.epoch(epoch))
        assert len(bj) == len(bt) == 3
        for a, b in zip(bj, bt):
            assert set(b) == {"query/tokens", "reference/cross/tokens", "query/score_map", "_valid"}
            assert int(a["_valid"]) == int(b["_valid"])
            np.testing.assert_array_equal(b["query/score_map"], np.asarray(a["query/score_map"]))
            assert b["query/tokens"].shape == (3, 16, 64) and b["reference/cross/tokens"].shape == (3, 2, 16, 64)
            for key in ("query/tokens", "reference/cross/tokens"):
                np.testing.assert_allclose(b[key].numpy(), np.asarray(a[key]), rtol=0, atol=TOK_TOL,
                                           err_msg=key)
        last = bt[-1]  # the padded duplicates carry the final item's windows
        for key in ("query/tokens", "reference/cross/tokens", "query/score_map"):
            x = last[key]
            assert all(np.array_equal(np.asarray(x[0]), np.asarray(x[i])) for i in (1, 2)), key
    assert tl.cache.misses == len(tl.cache) <= 14  # 7 renders, 7 captures: each encoded once at most


def test_token_loader_windows_follow_the_stream(nets, tree):
    """Item 0's score-map crop and query tokens are the window that the
    documented stream (seed + 7919, epoch, index) draws, on the full-image
    grid the cache holds."""
    _, tl = _loaders(nets, tree, num_workers=1)
    batch = next(iter(tl.epoch(0)))
    idx0 = int(tl._plan(0)[0][2]["indices"][0])
    item = tl.dataset.get_item(idx0, _fold_rng(tl.seed, 0, idx0))
    i, j = aligned_window((6, 8), (4, 4), _fold_rng(tl.seed + _WINDOW_SEED_OFFSET, 0, idx0))
    assert (i, j) == jax_aligned_window((6, 8), (4, 4), jax_fold_rng(tl.seed + _WINDOW_SEED_OFFSET, 0, idx0))
    np.testing.assert_array_equal(batch["query/score_map"][0],
                                  item["query/score_map"][i * 14:i * 14 + 56, j * 14:j * 14 + 56])
    full = tl.cache.gather([[item["item_paths"]["query/img"]]], item["query/img"][None, None])[0, 0]
    np.testing.assert_array_equal(batch["query/tokens"][0].numpy(),
                                  crop_token_grid(full, (6, 8), (i, j), (4, 4)).numpy())


def test_parallel_slicing_matches_serial(nets, tree):
    _, serial = _loaders(nets, tree, batch_size=4, num_workers=1)
    _, parallel = _loaders(nets, tree, batch_size=4, num_workers=4)
    for a, b in zip(serial.epoch(0), parallel.epoch(0)):
        for key in ("query/tokens", "reference/cross/tokens", "query/score_map"):
            np.testing.assert_array_equal(np.asarray(a[key]), np.asarray(b[key]), err_msg=key)
    assert serial.cache.misses == parallel.cache.misses


def test_loader_guards(tree):
    _, ds = _datasets(tree)
    kw = dict(dataset_path=str(tree), resolution="res_540", data_split="train",
              neighbour_config={"strategy": "random", "cross": 2}, metric_type="ssim", metric_min=0,
              metric_max=1, crop_size=56, crop_mode="dataset_default", return_item_paths=True)
    with pytest.raises(ValueError, match="uncropped"):
        TokenSpaceLoader(ConcatDataset([ds, NvsDataset(**kw)]), None, crop_size=56, batch_size=2)
    ds.return_item_paths = False
    with pytest.raises(ValueError, match="return_item_paths"):
        TokenSpaceLoader(ds, None, crop_size=56, batch_size=2)
    with pytest.raises(ValueError, match="multiple"):
        TokenSpaceLoader(_datasets(tree)[1], None, crop_size=50, batch_size=2)


def _capacity_outcome(loader_cls, leaf, ds, cache) -> str:
    """What the cache-capacity check of a loader (batch 8, prefetch 8: a
    working set of 432 grids) does for ``ds`` and ``cache``: "silent",
    "warns" or "raises". It is called on a loader built over one leaf, since
    the JAX loader refuses a ConcatDataset (it reads return_item_paths on the
    dataset itself)."""
    loader = loader_cls(leaf, (JaxCache if loader_cls is JaxTokenLoader else RefTokenCache)(None),
                        crop_size=56, batch_size=8, num_workers=2, prefetch_batches=8)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            loader._check_cache_capacity(ds, cache)
        except ValueError as e:
            assert "working set" in str(e)
            return "raises"
    return "warns" if any("working set" in str(w.message) for w in caught) else "silent"


def _capacity_warned(loader_cls, leaf, ds, cache) -> bool:
    return _capacity_outcome(loader_cls, leaf, ds, cache) == "warns"


def test_cache_capacity_agrees_with_jax_on_one_geometry(tree, monkeypatch, tmp_path):
    """One leaf: a cache that holds the corpus (14 images) passes silently;
    one of 2 items raises in both packages where the native decoder is
    present and no disk store is (the decode skip could lose an evicted
    slot), and warns otherwise (a store reloads an eviction; without the
    decoder every slot carries pixels)."""
    ds_j, ds_t = _datasets(tree)
    for native in (False, True):
        monkeypatch.setattr(jax_fastimage, "available", lambda: native)
        monkeypatch.setattr(port_fastimage, "available", lambda: native)
        small = "raises" if native else "warns"
        for max_items, store, want in ((14, None, "silent"), (2, None, small), (2, tmp_path / "store", "warns")):
            assert _capacity_outcome(JaxTokenLoader, ds_j, ds_j, JaxCache(None, max_items=max_items,
                                                                          persist_dir=store)) == want, native
            assert _capacity_outcome(TokenSpaceLoader, ds_t, ds_t, RefTokenCache(None, max_items=max_items,
                                                                                  persist_dir=store)) == want, native


def test_cache_capacity_counts_crop_mode_geometries(tree, monkeypatch):
    """Two leaves over one root at the same resize, one trimmed to whole
    patches and one not, key each image twice. The port counts both
    geometries and warns for a cache of the 14-image corpus; the JAX package
    counts resize_short_side only and stays silent (the ADVICE r5 finding at
    its ``data/token_train.py:162-166``). Both on the Pillow path, where the
    check warns."""
    monkeypatch.setattr(jax_fastimage, "available", lambda: False)
    monkeypatch.setattr(port_fastimage, "available", lambda: False)
    (j1, t1), (j2, t2) = _datasets(tree), _datasets(tree, crop_mode=None)
    assert _capacity_warned(JaxTokenLoader, j1, JaxConcat([j1, j2]), JaxCache(None, max_items=14)) is False
    assert _capacity_warned(TokenSpaceLoader, t1, ConcatDataset([t1, t2]), RefTokenCache(None, max_items=14))
    assert not _capacity_warned(TokenSpaceLoader, t1, ConcatDataset([t1, t2]), RefTokenCache(None, max_items=28))


CLI = [
    "trainer.accelerator=cpu",
    "model.backbone.preset=dinov2-test",
    "data.neighbour_config.cross=2",
    "data.loader.train.batch_size=2",
    "data.loader.validation.batch_size=2",
    "data.loader.train.num_workers=2",
    "data.loader.validation.num_workers=1",
    "data.transforms.crop_size=56",
    "this_main.resize_short_side=-1",
    "trainer.limit_val_batches=1",
    "logger.vis_scalar_every_n_train_steps=1",
]


def _cfgs(extra):
    return (jax_parse_cli("default", CLI + ["model.tpu.compute_dtype=float32"] + extra),
            parse_cli("default", CLI + ["model.gpu.compute_dtype=float32"] + extra))


@pytest.mark.parametrize("recipe", ["token_fast", "pixel", "default"])
def test_train_recipe_composes_the_same_keys(recipe):
    jcfg, tcfg = _cfgs([f"this_main.train_recipe={recipe}"])
    assert apply_train_recipe(tcfg) == jax_apply_recipe(jcfg)
    for key in ("this_main.token_space_train", "data.dataset.wire_uint8", "this_main.ref_token_cache_max_items"):
        a, b = jcfg, tcfg
        for part in key.split("."):
            a, b = a[part], b[part]
        assert a == b, key
    if recipe == "token_fast":
        assert tcfg.this_main.token_space_train is True and tcfg.data.dataset.wire_uint8 is True


def test_unknown_train_recipe_raises():
    jcfg, tcfg = _cfgs(["this_main.train_recipe=warp9"])
    with pytest.raises(ValueError, match="train_recipe"):
        jax_apply_recipe(jcfg)
    with pytest.raises(ValueError, match="train_recipe"):
        apply_train_recipe(tcfg)


@pytest.mark.parametrize("crop,keeps", [(84, True), (56, False)])
def test_coverage_guard_agrees_with_jax_on_one_geometry(tree, crop, keeps):
    """84x112 images: a crop of 84 covers 75% (kept), 56 covers 33% (falls
    back, with the warning), in both packages."""
    jcfg, tcfg = _cfgs([f"data.transforms.crop_size={crop}"])
    ds_j, ds_t = _datasets(tree)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert jax_coverage_guard(jcfg, ds_j) is keeps
        assert token_fast_coverage_guard(tcfg, ds_t) is keeps
    assert sum("token_fast_min_coverage" in str(w.message) for w in caught) == (0 if keeps else 2)


def test_coverage_guard_reads_every_root(tree, tmp_path):
    """A two-root corpus whose second root has 168x224 images: a crop of 84
    covers 75% of the first root's images and 19% of the second's. The port
    gates on the least coverage and falls back; the JAX package reads item 0
    (the first root) and keeps the token path (the ADVICE r5 finding at its
    ``tasks/train.py:103``)."""
    generate(tmp_path / "big", hw=(168, 224), scenes_per_split={"train": 1, "val": 1, "test": 1})
    jcfg, tcfg = _cfgs(["data.transforms.crop_size=84"])
    (j1, t1), (j2, t2) = _datasets(tree), _datasets(tmp_path / "big")
    assert jax_coverage_guard(jcfg, JaxConcat([j1, j2])) is True
    with pytest.warns(RuntimeWarning, match="covers only 19%"):
        assert token_fast_coverage_guard(tcfg, ConcatDataset([t1, t2])) is False
    with pytest.warns(RuntimeWarning, match="covers only 19%"):
        assert token_fast_coverage_guard(tcfg, ConcatDataset([t2, t1])) is False  # order-free


def _rows(run_dir):
    return [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]


def test_token_train_cli_runs_and_resumes(tree, tmp_path, monkeypatch, capsys):
    """``this_main.token_space_train=true``: token batches feed the
    decoder-only step, validation runs on pixel crops, a resume continues the
    step count, and the cache encodes each of the 14 images once a run."""
    monkeypatch.chdir(tmp_path)
    ov = CLI + ["model.gpu.compute_dtype=float32", f"data.dataset.path=[{tree}]",
                "this_main.token_space_train=true", "trainer.num_sanity_val_steps=1"]
    run1 = main(ov + ["trainer.max_epochs=1", "alias=tok1"])
    rows = _rows(run1)
    steps1 = [r["step"] for r in rows if "train/loss" in r]
    assert steps1 == [1, 2, 3]  # 7 items at batch 2, drop_last
    assert all(np.isfinite(r["train/loss"]) for r in rows if "train/loss" in r)
    assert any("validation/loss" in r for r in rows)
    run2 = main(ov + ["trainer.max_epochs=2", f"trainer.ckpt_path_to_load={run1 / 'ckpt'}", "alias=tok2"])
    out = capsys.readouterr().out
    assert "resumed from step 3 (epoch 1, batch 0)" in out
    assert [r["step"] for r in _rows(run2) if "train/loss" in r] == [4, 5, 6]
    assert sorted(p.name for p in (run2 / "ckpt").glob("*.ckpt")) == ["step_00000006.ckpt"]
    assert out.count("token cache: ") == 2 and "misses" in out


def test_token_fast_falls_back_to_pixels_at_low_coverage(tree, tmp_path, monkeypatch, capsys):
    """Crop 56 on 84x112 images covers 33%, under the 0.6 default: the recipe
    warns and trains on pixel crops (uint8 on the wire, no token cache)."""
    monkeypatch.chdir(tmp_path)
    ov = CLI + ["model.gpu.compute_dtype=float32", f"data.dataset.path=[{tree}]",
                "this_main.train_recipe=token_fast", "trainer.num_sanity_val_steps=0", "trainer.max_steps=2",
                "alias=lowcov"]
    with pytest.warns(RuntimeWarning, match="token_fast_min_coverage"):
        run_dir = main(ov)
    losses = [r["train/loss"] for r in _rows(run_dir) if "train/loss" in r]
    assert len(losses) == 2 and all(np.isfinite(losses))
    out = capsys.readouterr().out
    assert "train_recipe=token_fast" in out and "token cache: " not in out


def test_token_fast_trains_on_tokens(tree, tmp_path, monkeypatch, capsys):
    """With the bound lowered under the toy tree's 33% the recipe keeps the
    token path: uint8 pixels into the encoder, token batches into the step."""
    monkeypatch.chdir(tmp_path)
    ov = CLI + ["model.gpu.compute_dtype=float32", f"data.dataset.path=[{tree}]",
                "this_main.train_recipe=token_fast", "this_main.token_fast_min_coverage=0.2",
                "trainer.num_sanity_val_steps=0", "trainer.max_steps=2", "alias=recipe"]
    run_dir = main(ov)
    losses = [r["train/loss"] for r in _rows(run_dir) if "train/loss" in r]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert "token cache: " in capsys.readouterr().out
