"""The port's predict CLI against the JAX package's on the CPU, on one
checkpoint written by the port (dinov2-test, fp32, gray maps): the same files
in the same layout, uint16 score maps within 32 counts, with shape buckets
forced and off; and the CLI's parts on their own (the serving plan, the
bucketed loader, the bucketed-output helpers, checkpoint loading)."""

import os

import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image

from crossscore_tpu.data import fastimage
from crossscore_tpu.data.bucketing import ShapeBucketedLoader as JaxBucketedLoader
from crossscore_tpu.data.simple_reference import SimpleReference as JaxSimpleReference
from crossscore_tpu.parallel.mesh import _per_process_data_par as jax_data_par
from crossscore_tpu.tasks.common import crop_bucketed as jax_crop_bucketed
from crossscore_tpu.tasks.common import iter_bucketed_items as jax_iter_bucketed_items
from crossscore_tpu.tasks.predict import main as jax_main
from crossscore_tpu.tasks.predict import plan_serving_modes as jax_plan
from crossscore_tpu_torch.confsys import load_config
from crossscore_tpu_torch.data import fastimage as port_fastimage
from crossscore_tpu_torch.data.bucketing import ShapeBucketedLoader, bucket_hw
from crossscore_tpu_torch.data.simple_reference import SimpleReference
from crossscore_tpu_torch.data.synthetic import generate
from crossscore_tpu_torch.io.checkpoint import step_path
from crossscore_tpu_torch.io.convert import init_params
from crossscore_tpu_torch.models import CrossScoreConfig, CrossScoreNet
from crossscore_tpu_torch.parallel.mesh import _per_process_data_par
from crossscore_tpu_torch.tasks.common import crop_bucketed, iter_bucketed_items, load_model_params
from crossscore_tpu_torch.tasks.predict import main, plan_serving_modes

QUERY = "datadir/res_540/s00001/test/ours_1000/renders"
REFS = "datadir/res_540/s00001/train/ours_1000/gt"
COMMON = [
    "trainer.accelerator=cpu",
    "model.backbone.preset=dinov2-test",
    "data.neighbour_config.cross=2",
    f"data.dataset.query_dir={QUERY}",
    f"data.dataset.reference_dir={REFS}",
    "data.loader.validation.batch_size=2",
    "data.loader.validation.num_workers=2",
    "this_main.resize_short_side=84",
    "logger.predict.write.config.score_map_colour_mode=gray",
]
# uint16 gray maps in [-1, 1]: 32 counts are 1e-3, the masked path's float
# tolerance at that quantisation (tests/test_bucketing.py)
COUNTS = 32


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    """A synthetic 84x112 tree and one checkpoint written by the port
    (seeded weights, reference Lightning keys) under ``run/ckpt/``; the CLIs
    run with cwd inside it, and both loaders on their Pillow paths, so that
    both see the same pixels (tests/test_torch_fastimage.py holds the native
    ones)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(fastimage, "available", lambda: False)
    mp.setattr(port_fastimage, "available", lambda: False)
    root = tmp_path_factory.mktemp("torch_predict_ws")
    generate(root / "datadir", hw=(84, 112), scenes_per_split={"train": 1, "test": 1})
    cfg = CrossScoreConfig.from_config(load_config("default_predict", ["model.backbone.preset=dinov2-test"]))
    ckpt = root / "run" / "ckpt" / "model.ckpt"
    ckpt.parent.mkdir(parents=True)
    torch.save({"state_dict": {f"model.{k}": v for k, v in init_params(cfg, 3).items()}}, ckpt)
    old = os.getcwd()
    os.chdir(root)
    yield root, ckpt
    os.chdir(old)
    mp.undo()


def _files(out):
    return sorted(str(p.relative_to(out)) for p in out.rglob("*") if p.is_file() and p.name != "config.yaml")


def _gray(path):
    return np.asarray(Image.open(path)).astype(np.int64)


@pytest.fixture(scope="module", params=["off", "forced"])
def cli_pair(request, ws):
    """The JAX and the port CLI on the same checkpoint and inputs. Forced
    buckets (a 56 multiple pads 84x112 to 112x112) take the per-item
    (B, 2) path with the token cache. Reference image copies are compared in
    the unbucketed pair only: the JAX package's per-item slicing of a packed
    batch names them after another item's references."""
    root, ckpt = ws
    extra = [f"trainer.ckpt_path_to_load={ckpt}", f"alias={request.param}"]
    if request.param == "forced":
        extra += ["this_main.shape_buckets=on", "this_main.bucket_multiple=56",
                  "logger.predict.write.flag.image_reference=false"]
    else:
        extra += ["this_main.shape_buckets=off"]
    want = root / jax_main(COMMON + extra + ["model.tpu.compute_dtype=float32"])
    got = root / main(COMMON + extra + ["model.gpu.compute_dtype=float32"])
    return request.param, want, got


def test_cli_layout_matches_jax(cli_pair):
    _, want, got = cli_pair
    files = _files(got)
    assert files == _files(want)
    assert len([f for f in files if f.startswith("batch/score_map_ref_cross/")]) == 3
    assert "vis/r0_B0000_b0.png" in files and "score_summary/datadir/datadir.csv" in files
    assert got.parent.parent.name == "run"  # the out dir derives from the checkpoint's run dir


def test_cli_score_maps_match_jax(cli_pair):
    _, want, got = cli_pair
    maps = sorted((got / "batch" / "score_map_ref_cross").glob("*.png"))
    for path in maps:
        a, b = _gray(path), _gray(want / "batch" / "score_map_ref_cross" / path.name)
        assert a.shape == b.shape == (84, 112), path.name
        assert np.abs(a - b).max() <= COUNTS, (path.name, np.abs(a - b).max())


def test_cli_images_and_summary_match_jax(cli_pair):
    _, want, got = cli_pair
    for path in sorted((got / "batch").rglob("image_*/**/*.png")):
        np.testing.assert_array_equal(_gray(path), _gray(want / path.relative_to(got)), err_msg=path.name)
    a = pd.read_csv(got / "score_summary" / "datadir" / "datadir.csv")
    b = pd.read_csv(want / "score_summary" / "datadir" / "datadir.csv")
    assert list(a.columns) == list(b.columns) and len(a) == 3
    pd.testing.assert_frame_equal(a.drop(columns=a.columns[-1]), b.drop(columns=b.columns[-1]))
    np.testing.assert_allclose(a.iloc[:, -1], b.iloc[:, -1], atol=2e-4)  # %.4f rounding of the means


def test_cli_modes_agree_and_reference_copies_are_per_item(ws, capsys):
    """The port's four modes give the same maps; a bucket-packed batch
    writes each item's own reference copies, named as the unbucketed run
    names them."""
    _, ckpt = ws
    base = COMMON + [f"trainer.ckpt_path_to_load={ckpt}", "model.gpu.compute_dtype=float32",
                     "logger.predict.write.config.vis_img_every_n_steps=-1"]
    outs = {}
    for buckets in ("off", "on"):
        for cache in ("off", "on"):
            outs[buckets, cache] = main(base + [f"this_main.shape_buckets={buckets}",
                                                "this_main.bucket_multiple=56",
                                                f"this_main.ref_token_cache={cache}",
                                                f"alias=m{buckets}{cache}"])
    text = capsys.readouterr().out
    # 8 slots (2 batches of 2 items x 2 refs, the padded duplicate included):
    # each of the 4 references misses once, and misses in its own batch
    assert text.count("ref-token cache: 2 hits, 4 unique misses") == 2
    ref = outs["off", "off"]
    assert _files(ref) == _files(outs["on", "on"])
    for out in outs.values():
        for path in sorted((ref / "batch" / "score_map_ref_cross").glob("*.png")):
            other = out / "batch" / "score_map_ref_cross" / path.name
            assert np.abs(_gray(path) - _gray(other)).max() <= COUNTS


# --- the CLI's parts -------------------------------------------------------------------


# (K, ranks, ranks per node, nodes, view_parallel, batch size)
PLAN_CASES = [(4, 1, 1, 1, "auto", 2), (4, 2, 2, 1, "on", 2), (4, 4, 4, 1, "auto", 2), (3, 2, 2, 1, "on", 2),
              (4, 2, 2, 1, "off", 2), (4, 4, 4, 1, "auto", 1), (8, 2, 2, 1, "auto", 1), (4, 4, 2, 2, "on", 2),
              (4, 8, 4, 2, "auto", 1)]


@pytest.mark.parametrize("k_refs,n_dev,n_local,n_proc,vp,bs", PLAN_CASES)
@pytest.mark.parametrize("buckets", [False, True])
@pytest.mark.parametrize("cache", ["auto", "off"])
def test_serving_plan_matches_jax(k_refs, n_dev, n_local, n_proc, vp, bs, buckets, cache):
    """One rank per card and one node per JAX process: the port takes the
    JAX plan on every topology, data-parallel and multi-node plans
    included."""
    kw = dict(vp_mode=vp, cache_mode=cache, use_buckets=buckets, need_attn_weights=False,
              zero_reference=False, k_refs=k_refs, n_dev=n_dev, n_local=n_local, n_proc=n_proc,
              data_mesh_size=n_proc * _per_process_data_par(n_local, 1, bs))
    assert tuple(plan_serving_modes(**kw)) == tuple(jax_plan(**kw))


@pytest.mark.parametrize("group,mp,bs", [(1, 1, 8), (2, 1, 8), (4, 1, 6), (8, 2, 3), (3, 1, 7), (4, 4, 5)])
def test_per_process_data_par_matches_jax(group, mp, bs):
    assert _per_process_data_par(group, mp, bs) == jax_data_par(group, mp, bs)


def test_view_parallel_plan_raises():
    """view_parallel=on with K divisible by the ranks takes the view-parallel
    plan (cached or not); without it, or with buckets, several ranks take
    the data-parallel plan, and several nodes with the cache the node-local
    view-parallel plan: none of them raises any more."""
    kw = dict(cache_mode="auto", use_buckets=False, need_attn_weights=False, zero_reference=False,
              k_refs=8, n_dev=2, n_local=2, n_proc=1, data_mesh_size=2)
    assert plan_serving_modes(vp_mode="on", **kw) == (True, False, True)
    assert plan_serving_modes(vp_mode="on", **kw | {"cache_mode": "off"}) == (True, False, False)
    assert plan_serving_modes(vp_mode="off", **kw) == (False, False, True)
    assert plan_serving_modes(vp_mode="on", **kw | {"use_buckets": True}) == (False, False, True)
    assert plan_serving_modes(vp_mode="on", **kw | {"n_dev": 4, "n_proc": 2}) == (True, True, True)
    assert plan_serving_modes(vp_mode="on", **kw | {"n_dev": 4, "n_proc": 2, "cache_mode": "off"}) \
        == (True, False, False)


@pytest.fixture
def mixed_dirs(tmp_path):
    """Queries of two shapes that round up to one 112x112 bucket."""
    rng = np.random.default_rng(4)
    for d, shapes in (("q", [(84, 112), (112, 84), (84, 112)]), ("r", [(84, 112)] * 3)):
        (tmp_path / d).mkdir()
        for i, (h, w) in enumerate(shapes):
            img = (rng.random((h, w, 3)) * 255).astype(np.uint8)
            Image.fromarray(img).save(tmp_path / d / f"frame_{i:05d}.png")
    return tmp_path / "q", tmp_path / "r"


def test_bucketed_loader_matches_jax(mixed_dirs, monkeypatch):
    monkeypatch.setattr(fastimage, "available", lambda: False)  # both packages' Pillow paths
    monkeypatch.setattr(port_fastimage, "available", lambda: False)
    q, r = mixed_dirs
    nc = {"strategy": "random", "cross": 2, "deterministic": False}
    ds_t = SimpleReference(str(q), str(r), nc, resize_short_side=-1)
    ds_j = JaxSimpleReference(str(q), str(r), nc, resize_short_side=-1)
    assert [ds_t.get_item_shape(i) for i in range(3)] == [ds_j.get_item_shape(i) for i in range(3)] \
        == [(84, 112), (112, 84), (84, 112)]
    assert ds_t.reference_pool_size() == 3 and bucket_hw(84, 112) == (112, 112)
    loader_t = ShapeBucketedLoader(ds_t, batch_size=2, num_workers=2, seed=5)
    loader_j = JaxBucketedLoader(ds_j, batch_size=2, num_workers=2, seed=5)
    assert loader_t.distinct_buckets() == loader_j.distinct_buckets() == {(112, 112)}
    batches_t, batches_j = list(loader_t.epoch(0)), list(loader_j.epoch(0))
    assert len(batches_t) == len(batches_j) == 2
    for bt, bj in zip(batches_t, batches_j):
        assert set(bt) == set(bj) and bt["item_paths"] == bj["item_paths"]
        for key in ("query/img", "reference/cross/imgs", "query/score_map", "_valid", "_valid_hw"):
            np.testing.assert_array_equal(bt[key], bj[key], err_msg=key)
    np.testing.assert_array_equal(batches_t[0]["_valid_hw"], [[84, 112], [112, 84]])
    assert int(batches_t[1]["_valid"]) == 1  # the padded final batch


def test_bucketed_output_helpers_match_jax():
    rng = np.random.default_rng(6)
    batch = {
        "query/img": rng.random((3, 112, 112, 3)).astype(np.float32),
        "reference/cross/imgs": rng.random((3, 2, 112, 112, 3)).astype(np.float32),
        "query/score_map": rng.random((3, 112, 112)).astype(np.float32),
        "item_paths": {"query/img": ["a", "b", "c"], "query/score_map": ["x", "y", "z"],
                       "reference/cross/imgs": [["r0", "r1", "r2"], ["s0", "s1", "s2"]]},
        "_valid": np.asarray(2, np.int32),
        "_valid_hw": np.asarray([[84, 112], [112, 70], [112, 70]], np.int32),
    }
    outputs = {"score_map_ref_cross": rng.random((3, 112, 112)).astype(np.float32)}
    got, want = list(iter_bucketed_items(batch, outputs)), list(jax_iter_bucketed_items(batch, outputs))
    assert [g[0] for g in got] == [w[0] for w in want] == [0, 1]
    for (i, b1, o1), (_, bj, oj) in zip(got, want):
        for key in ("query/img", "reference/cross/imgs", "query/score_map"):
            np.testing.assert_array_equal(b1[key], bj[key])
        np.testing.assert_array_equal(o1["score_map_ref_cross"], oj["score_map_ref_cross"])
        assert b1["item_paths"]["query/img"] == bj["item_paths"]["query/img"]
        # each item keeps its own K reference paths, in the (K, 1) layout
        assert b1["item_paths"]["reference/cross/imgs"] == [[f"r{i}"], [f"s{i}"]]
    assert got[1][2]["score_map_ref_cross"].shape == (1, 112, 70)
    shared = {**batch, "_valid_hw": np.asarray([98, 84], np.int32)}
    for a, b in zip(crop_bucketed(shared, outputs), jax_crop_bucketed(shared, outputs)):
        for key in ("query/img", "query/score_map", "score_map_ref_cross"):
            if key in a:
                np.testing.assert_array_equal(a[key], b[key])
    assert crop_bucketed(batch | {"_valid_hw": None}, outputs)[1] is outputs


def test_load_model_params_sources(tmp_path, capsys):
    cfg = load_config("default_predict", ["model.backbone.preset=dinov2-test", "trainer.accelerator=cpu"])
    mcfg = CrossScoreConfig.from_config(cfg)
    weights = init_params(mcfg, 9)
    run = tmp_path / "ckpt"
    run.mkdir()
    for step in (3, 12):  # a train run's ckpt/ dir: the latest step is used
        torch.save({"state_dict": {f"model.{k}": v * step for k, v in weights.items()}}, step_path(run, step))
    cfg.trainer.ckpt_path_to_load = str(run)
    model = load_model_params(cfg, CrossScoreNet(mcfg, device="cpu"))
    assert torch.equal(model.pos_enc_fn.PE, weights["pos_enc_fn.PE"] * 12)
    cfg.trainer.ckpt_path_to_load = str(step_path(run, 3))  # one .ckpt file
    assert torch.equal(load_model_params(cfg, CrossScoreNet(mcfg, device="cpu")).pos_enc_fn.PE,
                       weights["pos_enc_fn.PE"] * 3)
    cfg.trainer.ckpt_path_to_load = None  # seeded random weights, loudly
    model = load_model_params(cfg, CrossScoreNet(mcfg, device="cpu"))
    assert "RANDOM weights" in capsys.readouterr().out
    assert torch.equal(model.pos_enc_fn.PE, init_params(mcfg, cfg.seed)["pos_enc_fn.PE"])
    cfg.trainer.ckpt_path_to_load = str(tmp_path)
    with pytest.raises(FileNotFoundError, match="step_"):
        load_model_params(cfg, CrossScoreNet(mcfg, device="cpu"))
