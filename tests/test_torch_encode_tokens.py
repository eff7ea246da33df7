"""The port's ``tasks/encode_tokens.py`` on the CPU: it walks the JAX
package's unique image paths (its shards disjoint and covering), fills the
disk store with them and the empty placeholder, encodes nothing on a warm
store and only what is missing from a partly filled one, and a token-space
loader or a ``token_fast`` training run pointed at the store encodes nothing
either."""

import shutil

import numpy as np
import pytest
import torch

from crossscore_tpu.data.nvs_index import ConcatDataset as JaxConcat
from crossscore_tpu.data.nvs_index import NvsDataset as JaxNvsDataset
from crossscore_tpu.tasks.encode_tokens import unique_image_paths as jax_unique_image_paths
from crossscore_tpu_torch.data.nvs_index import ConcatDataset, NvsDataset, unique_image_paths
from crossscore_tpu_torch.data.synthetic import generate
from crossscore_tpu_torch.data.token_cache import RefTokenCache
from crossscore_tpu_torch.data.token_train import TokenSpaceLoader
from crossscore_tpu_torch.io.convert import init_params, load_into
from crossscore_tpu_torch.io.images import image_read, normalize_imagenet
from crossscore_tpu_torch.models import CrossScoreConfig, CrossScoreNet
from crossscore_tpu_torch.models.crossscore import make_backbone_encoder
from crossscore_tpu_torch.tasks.common import parse_cli
from crossscore_tpu_torch.tasks.encode_tokens import main as encode_main
from crossscore_tpu_torch.tasks.encode_tokens import parse_shard
from crossscore_tpu_torch.tasks.train import main as train_main

BASE = [
    "trainer.accelerator=cpu",
    "model.gpu.compute_dtype=float32",
    "model.backbone.preset=dinov2-test",
    "data.neighbour_config.cross=2",
    "data.loader.train.num_workers=2",
    "this_main.resize_short_side=-1",
    "seed=0",
]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("encode_tree")
    generate(root, hw=(84, 112), scenes_per_split={"train": 2, "val": 1, "test": 1})
    return root


@pytest.fixture(scope="module")
def store(tree, tmp_path_factory):
    """A store filled by one unsharded run: (directory, images walked)."""
    path = tmp_path_factory.mktemp("store") / "tokens"
    return path, encode_main(BASE + [f"data.dataset.path=[{tree}]", f"this_main.ref_token_cache_dir={path}"])


def _dataset(cls, root, cross=2):
    return cls(dataset_path=str(root), resolution="res_540", data_split="train",
               neighbour_config={"strategy": "random", "cross": cross}, metric_type="ssim", metric_min=0, metric_max=1,
               crop_size=None, crop_mode="integer_patches", return_item_paths=True)


def test_unique_image_paths_match_jax(tree, tmp_path):
    """Every query render and reference capture once, in the JAX order; over
    a two-root corpus (one root twice here: no path repeats)."""
    paths = unique_image_paths(_dataset(NvsDataset, tree))
    assert paths == jax_unique_image_paths(_dataset(JaxNvsDataset, tree))
    assert len(paths) == len(set(paths)) == 28  # 2 scenes x (7 renders + 7 captures)
    generate(tmp_path / "other", hw=(84, 112), scenes_per_split={"train": 1, "val": 1, "test": 1}, seed=5)
    roots = (tree, tmp_path / "other", tree)
    both = unique_image_paths(ConcatDataset([_dataset(NvsDataset, r) for r in roots]))
    assert both == jax_unique_image_paths(JaxConcat([_dataset(JaxNvsDataset, r) for r in roots]))
    assert len(both) == 28 + 14


@pytest.mark.parametrize("n", [2, 3])
def test_shards_are_disjoint_and_cover(tree, store, tmp_path, capsys, n):
    """Each shard encodes every n-th image of the JAX walk; the shards'
    stores together hold the unsharded store's files."""
    full_dir, n_all = store
    walk = jax_unique_image_paths(_dataset(JaxNvsDataset, tree))
    counts = [encode_main(BASE + [f"data.dataset.path=[{tree}]", f"this_main.ref_token_cache_dir={tmp_path}",
                                  f"this_main.encode_shard={i}/{n}"]) for i in range(n)]
    assert counts == [len(walk[i::n]) for i in range(n)] and sum(counts) == n_all == len(walk)
    assert sorted(p.name for p in tmp_path.glob("*.npz")) == sorted(p.name for p in full_dir.glob("*.npz"))
    assert "0 were already in the store" in capsys.readouterr().out


def test_bad_arguments_raise(tree):
    for shard in ("2/2", "-1/2", "0/0"):
        with pytest.raises(ValueError, match="encode_shard"):
            parse_shard(shard)
    with pytest.raises(ValueError, match="ref_token_cache_dir"):
        encode_main(BASE + [f"data.dataset.path=[{tree}]"])


def test_warm_store_encodes_nothing(tree, store, capsys):
    full_dir, n_all = store
    files = sorted(full_dir.glob("*.npz"))
    assert len(files) == n_all + 1 == 29  # the images and the empty placeholder
    assert encode_main(BASE + [f"data.dataset.path=[{tree}]", f"this_main.ref_token_cache_dir={full_dir}"]) == n_all
    assert f"encode_tokens done: {n_all} images, {n_all} were already in the store" in capsys.readouterr().out
    assert sorted(full_dir.glob("*.npz")) == files


def test_partly_filled_store_encodes_only_what_is_missing(tree, store, tmp_path, capsys):
    """Images already in the store are skipped before they are decoded
    (``RefTokenCache.has``); the rest, the placeholder among them, are
    encoded again under the same names."""
    full_dir, n_all = store
    part = tmp_path / "tokens"
    shutil.copytree(full_dir, part)
    files = sorted(p.name for p in part.glob("*.npz"))
    for name in files[::3]:
        (part / name).unlink()
    kept = len(list(part.glob("*.npz")))
    assert encode_main(BASE + [f"data.dataset.path=[{tree}]", f"this_main.ref_token_cache_dir={part}"]) == n_all
    out = capsys.readouterr().out
    assert f"encode_tokens: {len(files) - kept}/{len(files) - kept} encoded" in out
    assert sorted(p.name for p in part.glob("*.npz")) == files


def test_store_holds_the_seeded_backbone_tokens(tree, store):
    """An image's stored tokens are the frozen backbone's on the trimmed
    image, with the weights a run of the same seed starts from."""
    full_dir, _ = store
    cfg = CrossScoreConfig.from_config(parse_cli("default", BASE))
    model = load_into(CrossScoreNet(cfg, device="cpu"), init_params(cfg, 0, "cpu"))
    path = unique_image_paths(_dataset(NvsDataset, tree))[0]
    img = normalize_imagenet(image_read(path)).astype(np.float32)[None]
    want = make_backbone_encoder(cfg)(model, torch.from_numpy(img))[0]

    def forbidden(imgs, valid_hw=None):
        raise AssertionError("encoder called despite a warm store")

    cache = RefTokenCache(forbidden, persist_dir=full_dir)
    assert cache.has(path, img.shape[1:3]) and cache.disk_hits == 1
    got = cache.gather([[path]], img[:, None])[0, 0]
    # the store encoded a batch of 16, this one image: fp32 reduction order
    # only, within the port's fp32 net bound (tests/test_torch_model.py)
    torch.testing.assert_close(got, want, rtol=0, atol=2e-5)
    assert cache.misses == 0 and not cache.has(path, (70, 112))


def test_loader_on_a_warm_store_encodes_nothing(tree, store):
    full_dir, _ = store

    def forbidden(imgs, valid_hw=None):
        raise AssertionError("encoder called despite a warm store")

    cache = RefTokenCache(forbidden, persist_dir=full_dir)
    loader = TokenSpaceLoader(_dataset(NvsDataset, tree), cache, crop_size=56, batch_size=2, shuffle=True,
                              num_workers=2, seed=5)
    batches = list(loader.epoch(0))
    assert len(batches) == loader.batches_per_epoch() == 7 and cache.misses == 0 and cache.disk_hits > 0


def test_loader_padding_short_pools_encodes_nothing(tree, store):
    """K=5 over pools of 4 and 3 captures: the padded slots are the empty
    placeholder, whose tokens the store holds (the JAX package's store does
    not, and its run encodes them once)."""
    full_dir, _ = store

    def forbidden(imgs, valid_hw=None):
        raise AssertionError("encoder called despite a warm store")

    cache = RefTokenCache(forbidden, persist_dir=full_dir)
    loader = TokenSpaceLoader(_dataset(NvsDataset, tree, cross=5), cache, crop_size=56, batch_size=7,
                              shuffle=False, num_workers=1, seed=0)
    batches = list(loader.epoch(0))
    assert len(batches) == 2 and cache.misses == 0
    assert all(b["reference/cross/tokens"].shape[1] == 5 for b in batches)


def test_token_fast_run_on_a_warm_store_encodes_nothing(tree, store, tmp_path, monkeypatch, capsys):
    """A ``token_fast`` training run pointed at the store: every grid comes
    from the disk store (uint8 pixels on the wire change no key)."""
    full_dir, _ = store
    monkeypatch.chdir(tmp_path)
    run_dir = train_main(BASE + [
        f"data.dataset.path=[{tree}]", f"this_main.ref_token_cache_dir={full_dir}",
        "this_main.train_recipe=token_fast", "this_main.token_fast_min_coverage=0.2", "data.transforms.crop_size=56",
        "data.loader.train.batch_size=2", "data.loader.validation.batch_size=2", "trainer.max_steps=3",
        "trainer.num_sanity_val_steps=0", "alias=warm"])
    out = capsys.readouterr().out
    assert "train done: 3 steps" in out
    line = next(x for x in out.splitlines() if x.startswith("token cache: "))
    assert " 0 misses" in line and not line.endswith(" 0 disk hits"), line
    assert (run_dir / "ckpt" / "step_00000003.ckpt").exists()


@pytest.fixture(scope="module")
def resized_store(tmp_path_factory):
    """A tree whose 300x400 sources the dataset resizes (short side 224:
    224x299, trimmed to 224x294), and the store that ``encode_tokens`` fills
    for a ``token_fast`` run on it."""
    root = tmp_path_factory.mktemp("resized_tree")
    generate(root, hw=(300, 400), scenes_per_split={"train": 1, "val": 0, "test": 0})
    store_dir = root / "tokens"
    encode_main(BASE[:-2] + ["this_main.resize_short_side=224", "seed=0", f"data.dataset.path=[{root}]",
                             "this_main.train_recipe=token_fast", f"this_main.ref_token_cache_dir={store_dir}"])
    return root, store_dir


def test_token_fast_store_holds_the_loaders_encode_of_resized_images(resized_store):
    """The tokens ``encode_tokens`` stores for a ``token_fast`` run equal the
    token loader's own encode of the uint8-wire pixels (2e-5, fp32 reduction
    order), while the unrounded pixels' encode differs there: the store
    serves the run the tokens a cold cache would have encoded."""
    root, store_dir = resized_store
    cfg = CrossScoreConfig.from_config(parse_cli("default", BASE))
    model = load_into(CrossScoreNet(cfg, device="cpu"), init_params(cfg, 0, "cpu"))
    encoder = make_backbone_encoder(cfg)
    ds = NvsDataset(dataset_path=str(root), resolution="res_540", data_split="train",
                    neighbour_config={"strategy": "random", "cross": 2}, metric_type="ssim", metric_min=0,
                    metric_max=1, crop_size=None, crop_mode="integer_patches", resize_short_side=224,
                    return_item_paths=True, wire_uint8=True)
    assert ds.get_item_shape(0) == (224, 294)
    loaded = RefTokenCache(lambda imgs, valid_hw=None: encoder(model, torch.from_numpy(imgs)), max_items=64)
    loader = TokenSpaceLoader(ds, loaded, crop_size=56, batch_size=2, shuffle=False, num_workers=1, seed=0)
    list(loader.epoch(0))

    def forbidden(imgs, valid_hw=None):
        raise AssertionError("encoder called despite a warm store")

    stored = RefTokenCache(forbidden, persist_dir=store_dir)
    assert len(loaded) == len(unique_image_paths(ds)) == 14
    worst_unrounded = 0.0
    for (path, _, hw), want in loaded._cache.items():
        assert stored.has(path, hw), path
        got = stored.gather([[path]], np.zeros((1, 1, *hw, 3), np.uint8))[0, 0]
        torch.testing.assert_close(got, want, rtol=0, atol=2e-5)
        img = ds._resize(image_read(path))[:hw[0], :hw[1]]
        unrounded = encoder(model, torch.from_numpy(normalize_imagenet(img).astype(np.float32)[None]))[0]
        worst_unrounded = max(worst_unrounded, float((unrounded - want).abs().max()))
    assert stored.misses == 0
    assert worst_unrounded > 1e-3, worst_unrounded  # the JAX package's store: 50x the bound off
