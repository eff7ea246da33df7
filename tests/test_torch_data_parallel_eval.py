"""The port's test and predict CLIs over data ranks on the CPU (gloo; one pool
of 4 ranks for the module, free of JAX, laid out per run as one node of 2
ranks or as 2 nodes x 2): against the JAX CLIs in one process on the virtual
devices of ``conftest.py`` (the same files, ``metrics.csv`` cells, score maps
within 32 uint16 counts, the summaries), the wrap-around duplicates of node
shards counted once, 2 nodes x 2 against one node, and a rank left outside
the data layout."""

import json
import os
import re

import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image

import torch_rank_workers as workers
from crossscore_tpu.data import fastimage
from crossscore_tpu.tasks.predict import main as jax_predict
from crossscore_tpu.tasks.test import main as jax_test
from crossscore_tpu_torch.confsys import load_config
from crossscore_tpu_torch.data import fastimage as port_fastimage
from crossscore_tpu_torch.data.synthetic import generate
from crossscore_tpu_torch.io.convert import init_params
from crossscore_tpu_torch.models import CrossScoreConfig
from crossscore_tpu_torch.parallel.launch import RankPool
from crossscore_tpu_torch.tasks.test import main as port_test

# metrics.csv cells: fp32 on both sides, the global batch's metrics, within
# 1e-6, relative to the cell above 1 (the PSNR cells, ~8.6, sit at fp32 ulps
# of ~1e-6)
ATOL = RTOL = 1e-6
# uint16 gray maps in [-1, 1]: 32 counts are 1e-3 (PR 3's bound)
COUNTS = 32
TEST = [
    "trainer.accelerator=cpu",
    "model.backbone.preset=dinov2-test",
    "data.neighbour_config.cross=2",
    "data.loader.validation.batch_size=2",
    "data.loader.validation.num_workers=1",
    "this_main.resize_short_side=-1",
    "this_main.ref_token_cache_encode_batch=2",
    "logger.test.write.config.vis_img_every_n_steps=-1",
]
QUERY = "datadir/res_540/s00001/test/ours_1000/renders"
REFS = "datadir/res_540/s00001/train/ours_1000/gt"
PREDICT = [
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
PORT = ["model.gpu.compute_dtype=float32", "model.gpu.dist_backend=gloo"]
JAX = ["model.tpu.compute_dtype=float32", "trainer.devices=2"]
# (tree, overrides): buckets off and the cache off; buckets forced (the
# per-item (B, 2) path) with the cache; the mixed-aspect tree's auto buckets
# with the cache
MODES = {
    "off": ("datadir", ["this_main.shape_buckets=off", "this_main.ref_token_cache=off"]),
    "forced": ("datadir", ["this_main.shape_buckets=on", "this_main.bucket_multiple=56"]),
    "mixed": ("mixed", ["this_main.bucket_multiple=56"]),
}


@pytest.fixture(scope="module")
def pool():
    with RankPool(4, env={"OMP_NUM_THREADS": "1", "CROSSSCORE_NO_NATIVE": "1"}) as p:
        yield p


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    """The 84x112 tree (7 test frames) and a mixed-aspect one, and one
    checkpoint written by the port; the CLIs run with cwd inside, both
    packages on their Pillow decoders."""
    mp = pytest.MonkeyPatch()
    mp.setattr(fastimage, "available", lambda: False)
    mp.setattr(port_fastimage, "available", lambda: False)
    root = tmp_path_factory.mktemp("dp_eval_ws")
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


def _ranks(pool, ws, task, argv, n=2, local=2):
    """The CLI on the first ``n`` ranks as nodes of ``local`` -> (out dir, texts)."""
    root, _ = ws
    res = [r for r in pool.run(workers.run_cli, n, local, task, argv, str(root), timeout=300) if r is not None]
    dirs = {r[0] for r in res if r[0] is not None}
    assert len(dirs) == 1, dirs
    return root / dirs.pop(), [r[1] for r in res]


def _files(out):
    return sorted(str(p.relative_to(out)) for p in out.rglob("*") if p.is_file() and p.name != "config.yaml")


def _gray(path):
    return np.asarray(Image.open(path)).astype(np.int64)


def _metrics(out):
    return pd.read_csv(out / "metrics.csv", dtype={"batch_idx": str})


def _maps(out) -> dict:
    """The written score maps by query (the name without its r/B/b prefix)."""
    maps = sorted((out / "batch" / "score_map_ref_cross").glob("*.png"))
    by_query = {re.sub(r"^r\d+_B\d{4}_b\d{3}_", "", p.name): p for p in maps}
    assert len(by_query) == len(maps)  # each query written once
    return by_query


@pytest.mark.parametrize("mode", list(MODES))
def test_test_cli_on_two_ranks_matches_jax(pool, ws, mode):
    """One node of 2 ranks (1 row each of every B=2 batch) against the JAX
    CLI in one process over 2 devices: the same files, the item-path JSONs
    equal (the whole node batch gathered into one), every ``metrics.csv`` cell within 1e-6, maps within 32 counts,
    the same per-frame summary."""
    root, ckpt = ws
    tree, extra = MODES[mode]
    argv = TEST + [f"trainer.ckpt_path_to_load={ckpt}", f"data.dataset.path=[{tree}]"] + extra
    want = root / jax_test(argv + JAX + [f"alias=jax_{mode}"])
    got, texts = _ranks(pool, ws, "test", argv + PORT + [f"alias=dp_{mode}"])
    assert _files(got) == _files(want)
    for name in _files(want):
        if name.endswith(".json"):
            a, b = (json.loads((out / name).read_text()) for out in (got, want))
            if mode != "off":
                # a bucket-packed batch's JSON holds its last item; JAX's
                # per-item slice takes view i of the (K, B) reference lists
                # where the port takes item i (PR 11), so only the queries
                # are held there
                a, b = ({k: v for k, v in x.items() if k != "reference/cross/imgs"} for x in (a, b))
            assert a == b, name
        elif "score_map" in name:
            assert np.abs(_gray(got / name) - _gray(want / name)).max() <= COUNTS, name
    a, b = _metrics(got), _metrics(want)
    assert list(a["batch_idx"]) == list(b["batch_idx"]) and list(a.columns) == list(b.columns)
    np.testing.assert_allclose(a.drop(columns="batch_idx").to_numpy(), b.drop(columns="batch_idx").to_numpy(),
                               rtol=RTOL, atol=ATOL)
    (sa,), (sb,) = (list((o / "score_summary").rglob("*.csv")) for o in (got, want))
    pd.testing.assert_frame_equal(pd.read_csv(sa), pd.read_csv(sb), atol=1e-3, check_exact=False)
    if mode != "off":  # each rank its own cache over its rows' references
        assert all(re.search(r"ref-token cache: \d+ hits, [1-9]\d* unique misses", t) for t in texts)


def test_test_cli_on_two_nodes_counts_each_item_once(pool, ws):
    """2 nodes x 2 ranks, B=2 a node, 7 items: each node's shard of 4 holds a
    wrap-around duplicate. The duplicates are weighed out: the mean loss is
    the one-rank run's (per-item L1 means, each item once), and every item's
    map is written once, under its node's index."""
    root, ckpt = ws
    argv = TEST + [f"trainer.ckpt_path_to_load={ckpt}", "data.dataset.path=[datadir]",
                   "this_main.ref_token_cache=off"]
    one = root / port_test(argv + ["model.gpu.compute_dtype=float32", "alias=one"])
    got, _ = _ranks(pool, ws, "test", argv + PORT + ["alias=nodes"], n=4, local=2)
    mean = lambda out: _metrics(out).set_index("batch_idx").loc["mean"]  # noqa: E731
    assert abs(mean(got)["test/loss"] - mean(one)["test/loss"]) <= ATOL
    assert len(_metrics(got)) == 2 + 1  # 2 global batches of 2 nodes x 2 rows, then the mean
    maps_one, maps_got = _maps(one), _maps(got)
    assert set(maps_got) == set(maps_one) and len(maps_got) == 7
    assert {p.name[:2] for p in maps_got.values()} == {"r0", "r1"}
    for q, p in maps_got.items():
        assert np.abs(_gray(p) - _gray(maps_one[q])).max() <= COUNTS, q


@pytest.mark.parametrize("buckets,cache", [("off", "off"), ("on", "on")])
def test_predict_cli_on_two_ranks_matches_jax(pool, ws, buckets, cache):
    """Data-parallel predict on one node of 2 ranks against the JAX CLI in
    one process: the same files, maps within 32 counts."""
    root, ckpt = ws
    argv = PREDICT + [f"trainer.ckpt_path_to_load={ckpt}", f"this_main.shape_buckets={buckets}",
                      "this_main.bucket_multiple=56", f"this_main.ref_token_cache={cache}"]
    if buckets == "on":  # JAX's per-item slice takes view i of the references (PR 11)
        argv += ["logger.predict.write.flag.image_reference=false"]
    want = root / jax_predict(argv + ["model.tpu.compute_dtype=float32", "model.tpu.view_parallel=off",
                                      f"alias=jp_{buckets}{cache}"])
    got, texts = _ranks(pool, ws, "predict", argv + PORT + ["model.gpu.view_parallel=off",
                                                            f"alias=dp_{buckets}{cache}"])
    for rank, text in enumerate(texts):
        assert f"[rank {rank}/2] data-parallel predict: 2 data ranks over 1 node(s); this rank takes rows " \
               f"[{rank}, {rank + 1}) of node 0's batches of 2" in text
    assert _files(got) == _files(want)
    for name in _files(want):
        if "score_map" in name:
            assert np.abs(_gray(got / name) - _gray(want / name)).max() <= COUNTS, name


@pytest.mark.parametrize("plan", ["data", "vp_local"])
def test_predict_cli_on_two_nodes_equals_one_node(pool, ws, plan):
    """4 ranks as 2 nodes x 2 against one node of 2: each node takes its
    shard of the queries and writes it under its index, data parallel over
    its ranks, or (the cache on and ``view_parallel=on``) view parallel
    within the node, its first rank writing (JAX's ``vp_local``); the union
    of the maps is the one node's, each query once."""
    root, ckpt = ws
    argv = PREDICT + [f"trainer.ckpt_path_to_load={ckpt}"] + (
        ["this_main.ref_token_cache=off"] if plan == "data" else
        ["this_main.ref_token_cache=on", "model.gpu.view_parallel=on"])
    one, _ = _ranks(pool, ws, "predict", argv + PORT + ["model.gpu.view_parallel=off", f"alias=node1_{plan}"])
    got, texts = _ranks(pool, ws, "predict", argv + PORT + [f"alias=node2_{plan}"], n=4, local=2)
    want = "data-parallel predict: 4 data ranks over 2 node(s)" if plan == "data" \
        else "view-parallel predict: K=2 references over 2 ranks"
    assert all(want in t for t in texts), texts
    maps_one, maps_got = _maps(one), _maps(got)
    assert set(maps_got) == set(maps_one)
    assert {p.name[:2] for p in maps_got.values()} == {"r0", "r1"}
    for q, p in maps_got.items():
        assert np.abs(_gray(p) - _gray(maps_one[q])).max() <= COUNTS, q


def test_rank_outside_the_layout_waits_and_the_run_equals_one_rank(pool, ws):
    """B=1 over 2 ranks: the data width is 1, so rank 1 is outside the
    layout; it says so, returns nothing, and the run's metrics are the one
    rank's."""
    root, ckpt = ws
    argv = TEST + [f"trainer.ckpt_path_to_load={ckpt}", "data.dataset.path=[datadir]",
                   "data.loader.validation.batch_size=1", "this_main.ref_token_cache=off",
                   "logger.test.write.flag.batch=false"]
    one = root / port_test(argv + ["model.gpu.compute_dtype=float32", "alias=b1one"])
    res = pool.run(workers.run_cli, 2, 2, "test", argv + PORT + ["alias=b1two"], str(root), timeout=300)
    assert res[1][0] is None and "[rank 1/2] test: this rank is outside the data layout" in res[1][1]
    got = root / res[0][0]
    np.testing.assert_allclose(_metrics(got).drop(columns="batch_idx").to_numpy(),
                               _metrics(one).drop(columns="batch_idx").to_numpy(), rtol=RTOL, atol=ATOL)
