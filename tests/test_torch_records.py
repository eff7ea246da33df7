"""The port's record shards (``crossscore_tpu_torch/data/records.py``, the
``data.pack`` CLI) against the JAX package's: the same payloads and index,
each package reading the other's store, ``CSRT`` payloads through
``io/images.py``. And the decode skip on the native path: the predict CLI's
maps with the skip on and off, and its skip count against the JAX package's
machinery on the same tree; the token loader's windows with the skip against
JAX's; ``RefTokenCache.gather(skipped=)`` against JAX's, the evicted-slot
error among its cases. The tests of the skip run where the port's native
decoder builds."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from crossscore_tpu.data import fastimage as jax_fi
from crossscore_tpu.data.loader import Loader as JaxLoader
from crossscore_tpu.data.nvs_index import NvsDataset as JaxNvsDataset
from crossscore_tpu.data.records import RecordStore as JaxStore
from crossscore_tpu.data.records import pack as jax_pack
from crossscore_tpu.data.simple_reference import SimpleReference as JaxSimpleReference
from crossscore_tpu.data.token_cache import RefTokenCache as JaxCache
from crossscore_tpu.data.token_train import TokenSpaceLoader as JaxTokenLoader
from crossscore_tpu.io.images import image_read_bytes as jax_image_read_bytes
from crossscore_tpu.io.images import metric_map_read_bytes as jax_metric_map_read_bytes
from crossscore_tpu_torch.data import fastimage
from crossscore_tpu_torch.data.nvs_index import NvsDataset, unique_image_paths
from crossscore_tpu_torch.data.records import RecordStore, RecordWriter, decode_raw_payload, encode_raw_payload, pack
from crossscore_tpu_torch.data.simple_reference import SimpleReference
from crossscore_tpu_torch.data.synthetic import generate
from crossscore_tpu_torch.data.token_cache import RefTokenCache
from crossscore_tpu_torch.data.token_train import TokenSpaceLoader
from crossscore_tpu_torch.io.images import image_read, image_read_bytes, metric_map_read, metric_map_read_bytes
from crossscore_tpu_torch.tasks.predict import main as predict_main
from torch_native import require_jax_native

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture
def native():
    if not fastimage.available():
        pytest.skip(f"the port's native decoder does not build here: {fastimage.load_error()}")
    require_jax_native()


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("records_tree")
    generate(root / "datadir", hw=(84, 112), scenes_per_split={"train": 1, "test": 1})
    return root


def test_writer_reader_roundtrip_and_rollover(tmp_path):
    payloads = {f"dir/file_{i}.bin": bytes([i]) * (300 * 1024 + i) for i in range(8)}
    with RecordWriter(tmp_path / "rec", shard_mb=1) as w:
        for k, v in payloads.items():
            w.write(k, v)
    assert len(list((tmp_path / "rec").glob("shard-*.bin"))) > 1  # rolled over
    store, jstore = RecordStore(tmp_path / "rec"), JaxStore(tmp_path / "rec")
    assert len(store) == 8 and set(store.keys()) == set(payloads)
    assert all(store.read(k) == v == jstore.read(k) for k, v in payloads.items())
    store.close()
    jstore.close()


@pytest.mark.parametrize("decoded", [False, True], ids=["png", "decoded"])
def test_each_package_reads_the_others_store(tree, tmp_path, decoded):
    """The port packs through its CLI with two worker processes (shards
    merged into one sequence; in a process of its own, since forking this
    one, which runs JAX's threads, could deadlock); the JAX package packs in
    one process: the same keys and payloads, read through either package's
    store."""
    argv = [str(tree / "datadir"), str(tmp_path / "port"), "1", "2"] + (["--decoded"] if decoded else [])
    res = subprocess.run([sys.executable, "-m", "crossscore_tpu_torch.data.pack", *argv], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and "2 worker(s)" in res.stdout, res.stdout + res.stderr
    n = jax_pack(tree / "datadir", tmp_path / "jax", verbose=False, decoded=decoded)
    assert n > 0 and f"packed {n} files" in res.stdout
    port, jax = RecordStore(tmp_path / "port"), JaxStore(tmp_path / "jax")
    assert sorted(port.keys()) == sorted(jax.keys()) and len(port) == n
    assert not list((tmp_path / "port").glob("tmp-w*"))  # the workers' directories merged away
    for key in jax.keys():
        payload = jax.read(key)
        assert port.read(key) == payload
        assert JaxStore(tmp_path / "port").read(key) == payload == RecordStore(tmp_path / "jax").read(key)
        assert fastimage.payload_is_raw(payload) is decoded


def test_raw_payloads_match_jax(tree):
    """``CSRT`` payloads: the same bytes from both packages, decoded to the
    PNG's pixels, and read by ``io/images.py`` as the JAX package reads them."""
    scene = next(p for p in (tree / "datadir" / "res_540").iterdir() if p.is_dir())
    img = next(scene.rglob("renders/*.png"))
    payload = encode_raw_payload(img)
    np.testing.assert_array_equal(decode_raw_payload(payload), np.asarray(Image.open(img).convert("RGB")))
    np.testing.assert_array_equal(image_read_bytes(payload), jax_image_read_bytes(payload))
    np.testing.assert_array_equal(image_read_bytes(payload), image_read(img))
    smap = next(scene.rglob("metric_map/ssim/*.png"))
    payload = encode_raw_payload(smap)
    np.testing.assert_array_equal(decode_raw_payload(payload), np.asarray(Image.open(smap)))
    for vrange in ([-1, 1], [0, 1]):
        got = metric_map_read_bytes(payload, vrange)
        np.testing.assert_array_equal(got, jax_metric_map_read_bytes(payload, vrange))
        np.testing.assert_array_equal(got, metric_map_read(smap, vrange))
        np.testing.assert_array_equal(metric_map_read_bytes(smap.read_bytes(), vrange), got)
    with pytest.raises(ValueError, match="not a CSRT"):
        decode_raw_payload(b"CSRT\0\0\0\0")


PREDICT = ["trainer.accelerator=cpu", "model.gpu.compute_dtype=float32", "model.backbone.preset=dinov2-test",
           "data.neighbour_config.cross=2", "data.loader.validation.batch_size=2",
           "data.loader.validation.num_workers=2", "this_main.resize_short_side=84",
           "logger.predict.write.config.score_map_colour_mode=gray",
           "logger.predict.write.config.vis_img_every_n_steps=-1"]


def _dirs(tree):
    scene = tree / "datadir" / "res_540" / "s00001"
    return scene / "test" / "ours_1000" / "renders", scene / "train" / "ours_1000" / "gt"


def _skips_by_jax(qdir, rdir, cache_hw) -> tuple:
    """The JAX package's decode-skip count for the same run: its dataset with
    the skip hook of its cache, warm with every reference at the planned
    shape, through its loader and ``gather``: (hits, misses, decode-skips)."""
    ds = JaxSimpleReference(str(qdir), str(rdir), {"strategy": "random", "cross": 2, "deterministic": False},
                            resize_short_side=84)
    cache = JaxCache(lambda imgs, valid_hw=None: np.zeros((len(imgs), 1, 1), np.float32))
    for p in sorted(rdir.iterdir()):
        cache._put(JaxCache._key(str(p), cache_hw), np.zeros((1, 1), np.float32))
    ds.ref_pixel_skip = cache.has
    for batch in JaxLoader(ds, batch_size=2, shuffle=False, num_workers=2, seed=1).epoch(0):
        cache.gather(batch["item_paths"]["reference/cross/imgs"], batch["reference/cross/imgs"],
                     skipped=batch["reference/skipped"])
    return cache.hits, cache.misses, cache.skipped_decodes


def test_predict_cli_decode_skip(tree, tmp_path, monkeypatch, capsys, native):
    """The predict CLI natively: a run with the skip off (reference copies
    are written) fills a token store; a run on it with the skip on decodes
    no reference and writes the same maps, and skips as many decodes as the
    JAX package's dataset, cache and loader on the same tree; a run from the
    decoded shards of the tree gives the same maps again."""
    qdir, rdir = _dirs(tree)
    monkeypatch.chdir(tmp_path)
    base = PREDICT + [f"data.dataset.query_dir={qdir}", f"data.dataset.reference_dir={rdir}",
                      f"this_main.ref_token_cache_dir={tmp_path / 'store'}"]
    off = predict_main(base + ["logger.predict.write.flag.image_reference=true", f"logger.predict.out_dir={tmp_path}/off"])
    out_off = capsys.readouterr().out
    on = predict_main(base + ["logger.predict.write.flag.image_reference=false", f"logger.predict.out_dir={tmp_path}/on"])
    out_on = capsys.readouterr().out
    pack(rdir.parents[2], tmp_path / "raw", verbose=False, decoded=True)  # the scene: both directories below it
    rec = predict_main(base + ["logger.predict.write.flag.image_reference=false", f"logger.predict.out_dir={tmp_path}/rec",
                               f"+data.dataset.record_dir={tmp_path / 'raw'}"])
    out_rec = capsys.readouterr().out
    assert "decode-skip off" in out_off and "decode-skip on" in out_on and "decode-skip on" in out_rec
    maps = {name: sorted((d / "batch" / "score_map_ref_cross").glob("*.png")) for name, d in
            (("off", off), ("on", on), ("rec", rec))}
    assert len(maps["off"]) == len(list(qdir.iterdir())) == 3
    for name in ("on", "rec"):
        assert [p.name for p in maps[name]] == [p.name for p in maps["off"]]
        for a, b in zip(maps[name], maps["off"]):
            np.testing.assert_array_equal(np.asarray(Image.open(a)), np.asarray(Image.open(b)))
    h, w = np.asarray(Image.open(next(rdir.iterdir()))).shape[:2]
    hits, misses, skips = _skips_by_jax(qdir, rdir, (84, round(w * 84 / h)))
    assert skips == 2 * 2 * 2 and hits == misses == 0  # 2 batches (the last padded) of B=2, K=2
    for text in (out_on, out_rec):
        assert f"ref-token cache: {hits} hits, {misses} unique misses, {skips} decode-skips" in text, text


def _token_loaders(tree, encode_np, **kw):
    """The JAX and the port token loaders over the same tree (K=2, 56 px
    windows), each with a cache around the same numpy encoder."""
    dkw = dict(dataset_path=str(tree / "datadir"), resolution="res_540", data_split="train",
               neighbour_config={"strategy": "random", "cross": 2, "deterministic": False}, metric_type="ssim",
               metric_min=0, metric_max=1, crop_size=None, crop_mode="integer_patches", return_item_paths=True)
    ds_j, ds_t = JaxNvsDataset(**dkw), NvsDataset(**dkw)
    kw = dict(crop_size=56, batch_size=3, shuffle=True, seed=3, num_workers=2) | kw
    jl = JaxTokenLoader(ds_j, JaxCache(lambda imgs, valid_hw=None: encode_np(imgs), encode_batch=4), **kw)
    tl = TokenSpaceLoader(ds_t, RefTokenCache(lambda imgs, valid_hw=None: torch.from_numpy(encode_np(imgs)),
                                              encode_batch=4), **kw)
    return jl, tl


def _patch_means(imgs: np.ndarray) -> np.ndarray:
    """A stand-in encoder: each 14x14 patch's mean pixel, (B, gh*gw, 3)."""
    b, h, w, c = imgs.shape
    x = np.asarray(imgs, np.float32).reshape(b, h // 14, 14, w // 14, 14, c).mean(axis=(2, 4))
    return np.ascontiguousarray(x.reshape(b, -1, c))


def test_token_loader_windows_with_the_skip_match_jax(tree, native):
    """Both caches hold every image of the split (as on a warm store); with
    the decode-skip hooks set, as the train CLI sets them, an epoch decodes
    no query or reference, skips every slot, and gives JAX's windows and
    score-map crops exactly."""
    jl, tl = _token_loaders(tree, _patch_means)
    for path in unique_image_paths(tl.dataset):
        img = fastimage.load_rgb(path)[None, None]
        jl.cache.gather([[path]], img)
        tl.cache.gather([[path]], img)
    for loader in (jl, tl):
        loader.dataset.ref_pixel_skip = loader.dataset.query_pixel_skip = loader.cache.has
    misses = tl.cache.misses
    bj, bt = list(jl.epoch(1)), list(tl.epoch(1))
    assert len(bj) == len(bt) == 3
    for a, b in zip(bj, bt):
        for key in ("query/tokens", "reference/cross/tokens", "query/score_map"):
            np.testing.assert_array_equal(np.asarray(b[key]), np.asarray(a[key]), err_msg=key)
    assert tl.cache.misses == jl.cache.misses == misses
    # 3 batches of 3 (the last padded), a query and K=2 references each
    assert tl.cache.skipped_decodes == jl.cache.skipped_decodes == 3 * 3 * (1 + 2)


def _one_batch_caches(tmp_path, max_items=8, store=False):
    enc = lambda imgs, valid_hw=None: _patch_means(imgs)  # noqa: E731
    return (JaxCache(enc, max_items=max_items, persist_dir=tmp_path / "jax" if store else None),
            RefTokenCache(lambda imgs, valid_hw=None: torch.from_numpy(enc(imgs)), max_items=max_items,
                          persist_dir=tmp_path / "port" if store else None))


@pytest.mark.parametrize("case", ["evicted", "rescued by the batch", "from the disk store", "from RAM"])
def test_gather_skipped_slots_match_jax(tmp_path, case):
    """``gather(skipped=)``: a skipped slot resolves from the host LRU, the
    disk store, or a slot of the batch that carries the same image's pixels;
    with none of them both packages raise the same error. The counts agree."""
    rng = np.random.default_rng(5)
    imgs = rng.random((1, 3, 28, 28, 3)).astype(np.float32)
    paths = [[str(tmp_path / f"img{k}.png")] for k in (0, 1, 0)]  # view 2 repeats view 0's image
    skipped = np.array([[False, True, True]])  # view 1: a placeholder; view 2: rescued by view 0
    jc, tc = _one_batch_caches(tmp_path, store=case == "from the disk store")
    if case in ("from the disk store", "from RAM"):
        warm = imgs[:, 1:2]
        for c in (jc, tc):
            c.gather([paths[1]], warm)
        if case == "from the disk store":  # new caches on the same stores: RAM empty
            jc, tc = _one_batch_caches(tmp_path, store=True)
    placeholders = np.where(skipped[..., None, None, None], 0, imgs).astype(np.float32)
    if case == "evicted":
        for c in (jc, tc):
            with pytest.raises(RuntimeError) as err:
                c.gather(paths, placeholders, skipped=skipped)
            assert "decode-skipped reference evicted from the token cache before use" in str(err.value)
            assert paths[1][0] in str(err.value) and "ref_token_cache_max_items" in str(err.value)
        return
    if case == "rescued by the batch":
        skipped = np.array([[False, False, True]])
        placeholders = np.where(skipped[..., None, None, None], 0, imgs).astype(np.float32)
    want, got = jc.gather(paths, placeholders, skipped=skipped), tc.gather(paths, placeholders, skipped=skipped)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (tc.hits, tc.misses, tc.skipped_decodes, tc.disk_hits) == \
        (jc.hits, jc.misses, jc.skipped_decodes, jc.disk_hits)
    np.testing.assert_array_equal(got[0, 2].numpy(), _patch_means(imgs[0, :1])[0])  # view 0's tokens


def test_simple_reference_reads_record_shards(tree, tmp_path, native):
    """The predict dataset keys the shards by paths relative to the deepest
    directory that holds both of its directories (the JAX one reads files
    only): its items from PNG and decoded shards equal its items from files."""
    qdir, rdir = _dirs(tree)
    scene = rdir.parents[2]
    pack(scene, tmp_path / "png", verbose=False)
    pack(scene, tmp_path / "raw", verbose=False, decoded=True)
    nc = {"strategy": "random", "cross": 2, "deterministic": False}
    files = SimpleReference(str(qdir), str(rdir), nc, resize_short_side=84)
    for store in ("png", "raw"):
        ds = SimpleReference(str(qdir), str(rdir), nc, resize_short_side=84, record_dir=str(tmp_path / store))
        assert ds._store_payload(str(next(qdir.iterdir()))) is not None
        for i in range(len(files)):
            a, b = files.get_item(i, np.random.default_rng(i)), ds.get_item(i, np.random.default_rng(i))
            for key in ("query/img", "reference/cross/imgs"):
                np.testing.assert_array_equal(b[key], a[key], err_msg=key)
