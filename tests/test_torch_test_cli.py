"""The port's test CLI against the JAX package's on the CPU, on one
checkpoint written by the port (dinov2-test, fp32, gray maps): the same files
in the same layout, ``metrics.csv`` rows within rtol 1e-5 / atol 1e-6, uint16
score maps within 32 counts and byte-equal score summaries, with shape buckets
off, forced, and on a mixed-aspect tree, the reference-token cache on and
off; then the port alone: cached against uncached, bucketed and not, and a
padded final batch whose ``mean`` row is the mean over the distinct items."""

import json
import os

import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image

from crossscore_tpu.data import fastimage
from crossscore_tpu.tasks.test import main as jax_main
from crossscore_tpu_torch.confsys import load_config
from crossscore_tpu_torch.data import fastimage as port_fastimage
from crossscore_tpu_torch.data.synthetic import generate
from crossscore_tpu_torch.io.convert import init_params
from crossscore_tpu_torch.models import CrossScoreConfig
from crossscore_tpu_torch.tasks.test import main

COMMON = [
    "trainer.accelerator=cpu",
    "model.backbone.preset=dinov2-test",
    "data.neighbour_config.cross=2",
    "data.loader.validation.batch_size=2",
    "data.loader.validation.num_workers=2",
    "this_main.resize_short_side=-1",
    "this_main.ref_token_cache_encode_batch=2",
]
# the JAX test CLI's cached-eval bound (tests/test_token_cache.py)
RTOL, ATOL = 1e-5, 1e-6
# uint16 gray maps in [-1, 1]: 32 counts are 1e-3 (tests/test_torch_predict_cli.py)
COUNTS = 32
# (tree, the runs' overrides): buckets off with the cache off (figures on);
# forced buckets on one shape (a 56 multiple pads 84x112 to 112x112: the
# per-item (B, 2) path) with the cache; the mixed-aspect tree's auto buckets
# (84x112 and 112x84 share the 112x112 bucket) with the cache
PAIRS = {
    "off": ("datadir", ["this_main.shape_buckets=off", "this_main.ref_token_cache=off"]),
    "forced": ("datadir", ["this_main.shape_buckets=on", "this_main.bucket_multiple=56",
                           "logger.test.write.config.vis_img_every_n_steps=-1"]),
    "mixed": ("mixed", ["this_main.bucket_multiple=56", "logger.test.write.config.vis_img_every_n_steps=-1"]),
}


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    """Two synthetic trees, 84x112 (one test scene: 7 frames) and mixed-aspect
    (two test scenes of 84x112 and 112x84), and one checkpoint written by the
    port under ``run/ckpt/``; the CLIs run with cwd inside, both loaders on
    their Pillow paths (tests/test_torch_fastimage.py holds the native ones)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(fastimage, "available", lambda: False)
    mp.setattr(port_fastimage, "available", lambda: False)
    root = tmp_path_factory.mktemp("torch_test_ws")
    generate(root / "datadir", hw=(84, 112), scenes_per_split={"train": 1, "test": 1})
    generate(root / "mixed", hw=[(84, 112), (112, 84)], scenes_per_split={"train": 1, "test": 2})
    cfg = CrossScoreConfig.from_config(load_config("default_test", ["model.backbone.preset=dinov2-test"]))
    ckpt = root / "run" / "ckpt" / "model.ckpt"
    ckpt.parent.mkdir(parents=True)
    torch.save({"state_dict": {f"model.{k}": v for k, v in init_params(cfg, 3).items()}}, ckpt)
    old = os.getcwd()
    os.chdir(root)
    yield root, ckpt
    os.chdir(old)
    mp.undo()


def _run(ws, tag: str, extra: list, port: bool = True):
    root, ckpt = ws
    argv = COMMON + [f"trainer.ckpt_path_to_load={ckpt}", f"alias={tag}"] + extra
    if port:
        return root / main(argv + ["model.gpu.compute_dtype=float32"])
    return root / jax_main(argv + ["model.tpu.compute_dtype=float32"])


@pytest.fixture(scope="module")
def runs(ws):
    """The port's runs beside the pairs: each pair's tree with the cache
    flipped, and the 84x112 tree at B=1."""
    out = {}
    for tag, (tree, extra) in PAIRS.items():
        flip = "on" if "this_main.ref_token_cache=off" in extra else "off"
        extra = [e for e in extra if not e.startswith("this_main.ref_token_cache")]
        out[tag] = _run(ws, f"{tag}_cache{flip}", [f"data.dataset.path=[{tree}]", f"this_main.ref_token_cache={flip}",
                                                   "logger.test.write.config.vis_img_every_n_steps=-1"] + extra)
    out["b1"] = _run(ws, "b1", ["data.dataset.path=[datadir]", "data.loader.validation.batch_size=1",
                                "this_main.shape_buckets=off", "logger.test.write.flag.batch=false",
                                "logger.test.write.config.vis_img_every_n_steps=-1"])
    return out


@pytest.fixture(scope="module", params=list(PAIRS))
def cli_pair(request, ws):
    tree, extra = PAIRS[request.param]
    extra = [f"data.dataset.path=[{tree}]"] + extra
    return request.param, _run(ws, request.param, extra, port=False), _run(ws, request.param, extra)


def _files(out):
    return sorted(str(p.relative_to(out)) for p in out.rglob("*") if p.is_file() and p.name != "config.yaml")


def _gray(path):
    return np.asarray(Image.open(path)).astype(np.int64)


def _metrics(out):
    return pd.read_csv(out / "metrics.csv", dtype={"batch_idx": str})


def test_cli_layout_matches_jax(cli_pair):
    tag, want, got = cli_pair
    files = _files(got)
    assert files == _files(want)
    maps = [f for f in files if f.startswith("batch/score_map_ref_cross/")]
    assert len(maps) == (7 if tag != "mixed" else 14)
    assert "metrics.csv" in files and any(f.startswith("batch/item_path_json/") for f in files)
    assert ("vis/r0_B0000_b0.png" in files) == (tag == "off")
    assert got.parent.parent.name == "run"  # the out dir derives from the checkpoint's run dir


def test_cli_metrics_match_jax(cli_pair):
    tag, want, got = cli_pair
    a, b = _metrics(got), _metrics(want)
    assert list(a.columns) == list(b.columns) == ["batch_idx", "test/loss", "test/loss_cross", "test/corr_cross",
                                                  "test/psnr_cross"]
    n_batches = 4 if tag != "mixed" else 7  # 7 frames at B=2; 7 and 7 frames of two shapes
    assert list(a["batch_idx"]) == list(b["batch_idx"]) == [str(i) for i in range(n_batches)] + ["mean"]
    for col in a.columns[1:]:
        assert np.isfinite(a[col]).all()
        np.testing.assert_allclose(a[col], b[col], rtol=RTOL, atol=ATOL, err_msg=col)


def test_cli_score_maps_match_jax(cli_pair):
    tag, want, got = cli_pair
    maps = sorted((got / "batch" / "score_map_ref_cross").glob("*.png"))
    shapes = set()
    for path in maps:
        a, b = _gray(path), _gray(want / "batch" / "score_map_ref_cross" / path.name)
        assert a.shape == b.shape, path.name
        shapes.add(a.shape)
        assert np.abs(a - b).max() <= COUNTS, (path.name, np.abs(a - b).max())
    assert shapes == ({(84, 112)} if tag != "mixed" else {(84, 112), (112, 84)})


def test_cli_summaries_and_item_paths_byte_equal_to_jax(cli_pair):
    """Summaries byte-equal; item-path JSONs byte-equal unbucketed, and the
    query paths equal in bucket-packed batches, whose per-item reference
    lists are the port's own (the JAX package's per-item slice takes view i
    there: ROADMAP, known deviations)."""
    tag, want, got = cli_pair
    summaries = sorted((got / "score_summary").rglob("*.csv"))
    assert summaries
    for path in summaries:
        assert path.read_bytes() == (want / path.relative_to(got)).read_bytes(), path.name
    for path in sorted((got / "batch" / "item_path_json").glob("*.json")):
        other = want / path.relative_to(got)
        if tag == "off":
            assert path.read_bytes() == other.read_bytes(), path.name
        else:
            assert json.loads(path.read_text())["query/img"] == json.loads(other.read_text())["query/img"]


def test_cached_and_uncached_eval_agree(cli_pair, runs):
    """Each pair's tree with the token cache flipped, bucketed and not: the
    rows agree to reduction-order noise (the backbone encodes the references
    in other batches) and the maps within a count."""
    tag, _, got = cli_pair
    other = runs[tag]
    assert [f for f in _files(got) if not f.startswith("vis/")] == _files(other)
    a, b = _metrics(got), _metrics(other)
    assert list(a["batch_idx"]) == list(b["batch_idx"])
    for col in a.columns[1:]:
        np.testing.assert_allclose(a[col], b[col], rtol=RTOL, atol=ATOL, err_msg=col)
    for path in sorted((got / "batch" / "score_map_ref_cross").glob("*.png")):
        assert np.abs(_gray(path) - _gray(other / path.relative_to(got))).max() <= 1, path.name


def test_padded_final_batch_counts_each_item_once(cli_pair, runs):
    """At B=2 the last of four batches holds the seventh frame and its
    padded duplicate: its row equals that frame's own row at B=1, and the
    ``mean`` row (each batch weighed by its valid items) equals the mean
    over the seven frames."""
    tag, _, got = cli_pair
    if tag != "off":
        got = runs["off"]  # the unbucketed tree with the cache on
    b2, b1 = _metrics(got).set_index("batch_idx"), _metrics(runs["b1"]).set_index("batch_idx")
    assert list(b1.index) == [str(i) for i in range(7)] + ["mean"]
    for col in b2.columns:
        np.testing.assert_allclose(b2.loc["3", col], b1.loc["6", col], rtol=RTOL, atol=ATOL, err_msg=col)
    for col in ("test/loss", "test/loss_cross"):  # the loss is linear in the items; corr and psnr are not
        frames = b1.loc[[str(i) for i in range(7)], col].mean()
        np.testing.assert_allclose(b2.loc["mean", col], frames, rtol=RTOL, atol=ATOL, err_msg=col)
        np.testing.assert_allclose(b1.loc["mean", col], round(frames, 6), rtol=0, atol=1e-12, err_msg=col)
