"""The port's native decoder (``crossscore_tpu_torch/data/fastimage.py`` over
``csrc/fastimage.cpp``) against the JAX package's (``native/fastimage.cpp``):
the same seeded PNGs (60x80 RGB, gray and RGBA, 16-bit metric maps) give the
same bits through every entry point (files, in-memory PNG payloads and
``CSRT`` raw payloads; resize up and down, crop, normalise, the uint8 wire).
And the dataset's items through the JAX ``NvsDataset`` and the port's, on the
native and on the Pillow path, from files and from PNG and decoded record
shards: the same bits, with the same rng draws. Each test runs where the
port's decoder builds (g++ and libpng); both copies are built with the same
flags on this machine."""

import struct

import numpy as np
import pytest
from PIL import Image

from crossscore_tpu.data import fastimage as jax_fi
from crossscore_tpu.data.nvs_index import NvsDataset as JaxNvsDataset
from crossscore_tpu.data.records import encode_raw_payload as jax_encode_raw
from crossscore_tpu.data.records import pack as jax_pack
from crossscore_tpu_torch.data import fastimage as fi
from crossscore_tpu_torch.data.nvs_index import NvsDataset
from crossscore_tpu_torch.data.records import encode_raw_payload, pack
from crossscore_tpu_torch.data.synthetic import generate
from crossscore_tpu_torch.io.images import metric_map_write
from crossscore_tpu_torch.ops import _build
from torch_native import require_jax_native


@pytest.fixture(autouse=True)
def _native():
    if not fi.available():
        pytest.skip(f"the port's native decoder does not build here: {fi.load_error()}")
    require_jax_native()


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    """Seeded 60x80 PNGs: RGB, gray, RGBA, and [-1, 1] and [0, 1] 16-bit
    metric maps."""
    root = tmp_path_factory.mktemp("fastimage")
    rng = np.random.default_rng(0)
    paths = {}
    for name, shape in (("rgb", (60, 80, 3)), ("gray", (60, 80)), ("rgba", (60, 80, 4))):
        paths[name] = root / f"{name}.png"
        Image.fromarray(rng.integers(0, 256, shape, dtype=np.uint8)).save(paths[name])
    for name, vrange, m in (("m11", [-1, 1], rng.random((60, 80)) * 2 - 1), ("m01", [0, 1], rng.random((60, 80)))):
        paths[name] = root / f"{name}.png"
        metric_map_write(paths[name], m.astype(np.float32), vrange)
    return paths


RGB_CASES = {
    "plain": dict(normalize=False),
    "normalised": dict(),
    "resize down": dict(resize_hw=(30, 40), normalize=False),
    "resize up": dict(resize_hw=(90, 100)),
    "resize odd": dict(resize_hw=(37, 51)),
    "crop": dict(crop=(5, 7, 20, 30)),
    "resize and crop": dict(resize_hw=(45, 60), crop=(3, 4, 28, 42)),
    "uint8": dict(as_uint8=True),
    "uint8 crop": dict(crop=(5, 7, 20, 30), as_uint8=True),
    "uint8 resize": dict(resize_hw=(30, 40), as_uint8=True),
}


def _same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["rgb", "gray", "rgba"])
@pytest.mark.parametrize("case", list(RGB_CASES))
def test_rgb_matches_jax(images, kind, case):
    """A file, its PNG bytes and its CSRT payload, through both packages."""
    path, kw = images[kind], RGB_CASES[case]
    want = jax_fi.load_rgb(str(path), **kw)
    _same(fi.load_rgb(str(path), **kw), want)
    _same(fi.load_rgb_bytes(path.read_bytes(), **kw), want)
    raw = encode_raw_payload(path)
    assert raw == jax_encode_raw(path)
    _same(fi.load_rgb_bytes(raw, **kw), jax_fi.load_rgb_bytes(raw, **kw))
    _same(fi.load_rgb_bytes(raw, **kw), want)  # PNG is lossless: the payload decodes alike
    out = np.empty_like(want)
    assert fi.load_rgb(str(path), out=out, **kw) is out
    _same(out, want)


METRIC_CASES = {
    "m11": dict(vrange=[-1, 1]),
    "m11 clamp": dict(vrange=[-1, 1], clamp01=True),
    "m01 square": dict(vrange=[0, 1], square=True),
    "m11 resize": dict(vrange=[-1, 1], clamp01=True, resize_hw=(45, 60)),
    "m01 resize up and crop": dict(vrange=[0, 1], resize_hw=(70, 90), crop=(2, 3, 40, 50)),
    "m11 crop": dict(vrange=[-1, 1], crop=(10, 20, 15, 25)),
}


@pytest.mark.parametrize("case", list(METRIC_CASES))
def test_metric_matches_jax(images, case):
    path, kw = images[case.split()[0]], METRIC_CASES[case]
    want = jax_fi.load_metric(str(path), **kw)
    _same(fi.load_metric(str(path), **kw), want)
    _same(fi.load_metric_bytes(path.read_bytes(), **kw), want)
    raw = encode_raw_payload(path)
    _same(fi.load_metric_bytes(raw, **kw), jax_fi.load_metric_bytes(raw, **kw))
    _same(fi.load_metric_bytes(raw, **kw), want)


def test_info_and_errors_match_jax(images, tmp_path):
    for kind in ("rgb", "gray", "rgba", "m11"):
        path = images[kind]
        assert fi.image_info(str(path)) == jax_fi.image_info(str(path))
        assert fi.image_info_bytes(path.read_bytes()) == jax_fi.image_info_bytes(path.read_bytes())
        raw = encode_raw_payload(path)
        assert fi.payload_is_raw(raw) and not fi.payload_is_raw(path.read_bytes())
        assert fi.image_info_bytes(raw) == jax_fi.image_info_bytes(raw)
    with pytest.raises(IOError):
        fi.load_rgb(str(images["rgb"]), crop=(50, 50, 30, 40))  # outside the image
    with pytest.raises(IOError):
        fi.load_rgb(str(tmp_path / "missing.png"))
    with pytest.raises(IOError):
        fi.load_metric(str(images["rgb"]), vrange=[0, 1])  # 8-bit RGB is not a metric map
    with pytest.raises(IOError):
        fi.load_rgb_bytes(b"CSRT\x01\x00\x03\x00" + struct.pack("<II", 2, 2))  # a 2x2 header, no pixels


def test_no_native_switch_and_the_build(monkeypatch):
    """``CROSSSCORE_NO_NATIVE`` turns the decoder off at any call (the JAX
    package reads it at its first), and the library is built into the port's
    build directory, hashed apart from the CUDA sources."""
    monkeypatch.setenv("CROSSSCORE_NO_NATIVE", "1")
    assert not fi.available() and fi.get_lib() is None
    with pytest.raises(RuntimeError, match="unavailable"):
        fi.image_info("x.png")
    monkeypatch.delenv("CROSSSCORE_NO_NATIVE")
    assert fi.available()
    path = _build.host_library_path()
    assert path.parent == _build.BUILD_DIR and path.exists() and path.name.startswith("fastimage-")
    assert "-lpng" in _build.GXX_LIBS and "fastimage.cpp" not in [p.name for p in _build.CSRC.glob("*.cu*")]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """An 84x112 synthetic tree, packed by the port as PNG and by the JAX
    package as decoded shards."""
    root = tmp_path_factory.mktemp("fused_tree")
    generate(root / "datadir", hw=(84, 112), scenes_per_split={"train": 1, "test": 1})
    pack(root / "datadir", root / "png", verbose=False)
    jax_pack(root / "datadir", root / "raw", verbose=False, decoded=True)
    return root


DATASET_CASES = {
    "ssim crop": dict(metric_type="ssim", metric_min=0, crop_size=56, crop_mode="dataset_default"),
    "ssim [-1,1] crop": dict(metric_type="ssim", metric_min=-1, crop_size=56, crop_mode="dataset_default"),
    "mse patches": dict(metric_type="mse", metric_min=0, crop_mode="integer_patches"),
    "mae resize": dict(metric_type="mae", metric_min=0, crop_mode=None, resize_short_side=56),
    "uint8 resize crop": dict(metric_type="ssim", metric_min=0, crop_size=56, crop_mode="dataset_default",
                              resize_short_side=70, wire_uint8=True),
    "zero reference": dict(metric_type="ssim", metric_min=0, crop_size=56, crop_mode="dataset_default",
                           zero_reference=True),
}


@pytest.mark.parametrize("store", [None, "png", "raw"], ids=["files", "png shards", "decoded shards"])
@pytest.mark.parametrize("native", [True, False], ids=["native", "pillow"])
def test_dataset_items_match_jax(tree, monkeypatch, native, store):
    """Every item of the train split (K=6: the empty placeholder pads the
    pool) in each configuration: the port's item equals the JAX package's on
    the same path, bit for bit, for the same rng."""
    monkeypatch.setattr(jax_fi, "available", lambda: native)
    monkeypatch.setattr(fi, "available", lambda: native)
    for case in DATASET_CASES.values():
        kw = dict(dataset_path=str(tree / "datadir"), resolution="res_540", data_split="train",
                  neighbour_config={"strategy": "random", "cross": 6, "deterministic": False}, metric_max=1,
                  record_dir=str(tree / store) if store else None) | case
        ds_j, ds_t = JaxNvsDataset(**kw), NvsDataset(**kw)
        assert len(ds_t) == len(ds_j) > 0
        for idx in range(len(ds_j)):
            want = ds_j.get_item(idx, np.random.default_rng(idx))
            got = ds_t.get_item(idx, np.random.default_rng(idx))
            assert set(got) == set(want)
            for key in ("query/img", "query/score_map", "reference/cross/imgs"):
                assert got[key].dtype == want[key].dtype, key
                np.testing.assert_array_equal(got[key], want[key], err_msg=f"{case} {idx} {key}")


def test_fused_path_draws_the_pillow_paths_rng(tree, monkeypatch):
    """The port's native item and its Pillow item cut the same windows: the
    uint8 wire without a resize is a copy of the PNG's bytes, so both paths
    give the same bytes, and the rng is left in the same state."""
    kw = dict(dataset_path=str(tree / "datadir"), resolution="res_540", data_split="train",
              neighbour_config={"strategy": "random", "cross": 3, "deterministic": False}, metric_type="ssim",
              metric_min=0, metric_max=1, crop_size=56, crop_mode="dataset_default", wire_uint8=True)
    ds = NvsDataset(**kw)
    for idx in range(len(ds)):
        rng_n, rng_p = np.random.default_rng(idx), np.random.default_rng(idx)
        native = ds.get_item(idx, rng_n)
        monkeypatch.setattr(fi, "available", lambda: False)
        pillow = ds.get_item(idx, rng_p)
        monkeypatch.undo()
        for key in ("query/img", "reference/cross/imgs"):
            np.testing.assert_array_equal(native[key], pillow[key], err_msg=key)
        np.testing.assert_allclose(native["query/score_map"], pillow["query/score_map"], rtol=0, atol=1e-6)
        assert rng_n.random() == rng_p.random()
