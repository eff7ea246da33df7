"""The port's data path against the JAX package's: the synthetic generator
writes the same files for a seed, and the dataset and the loader yield the
same items and batches for the same seed and epoch. Both packages' native
fused decoders are switched off so that both sides take the Pillow path
(tests/test_torch_fastimage.py holds the native paths)."""

from pathlib import Path

import numpy as np
import pytest

from crossscore_tpu.confsys import load_config as jax_load_config
from crossscore_tpu.data import fastimage
from crossscore_tpu.data.loader import Loader as JaxLoader
from crossscore_tpu.data.nvs_index import get_dataset as jax_get_dataset
from crossscore_tpu.data.synthetic import generate as jax_generate
from crossscore_tpu_torch.confsys import load_config
from crossscore_tpu_torch.data import fastimage as port_fastimage
from crossscore_tpu_torch.data.loader import Loader
from crossscore_tpu_torch.data.nvs_index import get_dataset
from crossscore_tpu_torch.data.synthetic import generate


@pytest.mark.parametrize("learnable", [False, True])
def test_generate_writes_the_same_files(tmp_path, learnable):
    kw = dict(hw=(30, 44), scenes_per_split={"train": 1, "val": 1, "test": 1}, n_train_imgs=2,
              n_test_imgs=2, seed=5, learnable=learnable)
    jax_generate(tmp_path / "jax", **kw)
    generate(tmp_path / "port", **kw)
    files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*") if p.is_file())
    assert len(files) == 1 + 3 * 2 * 4 * 2  # split.json + 3 scenes x 2 splits x 4 kinds x 2 frames
    for rel in files:
        assert (tmp_path / "port" / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes(), rel


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_data") / "datadir"
    generate(root, hw=(84, 112), scenes_per_split={"train": 2, "val": 1, "test": 1}, seed=3)
    return root


def _datasets(root: Path, monkeypatch, extra=()):
    monkeypatch.setattr(fastimage, "available", lambda: False)
    monkeypatch.setattr(port_fastimage, "available", lambda: False)
    ov = [f"data.dataset.path=[{root}]", "data.neighbour_config.cross=3", "data.transforms.crop_size=56",
          *extra]
    jcfg, tcfg = jax_load_config("default", ov), load_config("default", ov)
    kw = dict(crop_mode="dataset_default", resize_short_side=70)  # 84x112 -> 70x93, then 56x56 crops
    return jax_get_dataset(jcfg, "train", **kw), get_dataset(tcfg, "train", **kw)


def _assert_same(got: dict, want: dict):
    assert set(got) == set(want)
    for key in want:
        if isinstance(want[key], np.ndarray):
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        else:
            assert got[key] == want[key], key


@pytest.mark.parametrize("wire_uint8", [False, True], ids=["float", "uint8"])
def test_dataset_items_match_jax(data_root, monkeypatch, wire_uint8):
    ds_j, ds_t = _datasets(data_root, monkeypatch, [f"data.dataset.wire_uint8={str(wire_uint8).lower()}"])
    assert len(ds_t) == len(ds_j) == 2 * (4 + 3)
    for i in range(len(ds_j)):
        got = ds_t.get_item(i, np.random.default_rng([7, i]))
        want = ds_j.get_item(i, np.random.default_rng([7, i]))
        assert got["query/img"].shape == (56, 56, 3)
        assert got["reference/cross/imgs"].shape == (3, 56, 56, 3)
        _assert_same(got, want)


def test_loader_batches_match_jax(data_root, monkeypatch):
    ds_j, ds_t = _datasets(data_root, monkeypatch)
    kw = dict(batch_size=4, shuffle=True, num_workers=2, prefetch_batches=2, seed=11, drop_last=False)
    lj, lt = JaxLoader(ds_j, **kw), Loader(ds_t, **kw)
    assert lt.batches_per_epoch() == lj.batches_per_epoch() == 4
    for epoch, start in ((0, 0), (1, 2)):
        got = list(lt.epoch(epoch, start_batch=start))
        want = list(lj.epoch(epoch, start_batch=start))
        assert len(got) == len(want) == 4 - start
        for g, w in zip(got, want):
            _assert_same(g, w)
    # the final partial batch is padded by repeating its last item
    last = got[-1]
    assert int(last["_valid"]) == 14 - 12 and last["query/img"].shape[0] == 4
    np.testing.assert_array_equal(last["query/img"][2], last["query/img"][1])
