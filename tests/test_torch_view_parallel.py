"""View-parallel predict on 2 gloo ranks of one pool (spawned once for the
module, free of JAX): the view-parallel net and its cached twin against the
JAX package's ``make_view_parallel_apply`` / ``_tokens`` on 2 virtual CPU
devices and against the single-process port net, with the same weights
(dinov2-test, fp32); view-parallel training's gradients against the JAX
single-device ones; the position embedding of a shard; and the predict CLI
on 2 ranks against the single-rank CLI."""

import dataclasses
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from PIL import Image

import torch_rank_workers as workers
from crossscore_tpu.models import CrossScoreConfig as JaxConfig
from crossscore_tpu.models import CrossScoreNet as JaxNet
from crossscore_tpu.models.crossscore import make_backbone_encoder as jax_encoder
from crossscore_tpu.models.dinov2 import VIT_PRESETS as JAX_VIT
from crossscore_tpu.parallel.view_parallel import (
    make_view_parallel_apply as jax_vp_apply, make_view_parallel_apply_tokens as jax_vp_tokens,
)
from crossscore_tpu_torch.confsys import load_config
from crossscore_tpu_torch.data.synthetic import generate
from crossscore_tpu_torch.io.convert import init_params, load_into, state_dict_from_jax
from crossscore_tpu_torch.models import VIT_PRESETS, CrossScoreConfig, CrossScoreNet
from crossscore_tpu_torch.models.positional import MultiViewPositionalEmbedding
from crossscore_tpu_torch.parallel.launch import RankPool
from crossscore_tpu_torch.tasks.predict import main
from crossscore_tpu_torch.train.step import make_predict_step

# fp32 score maps in [0, 1]: mean absolute error (the whole-net bound of
# tests/test_torch_model.py)
MAE32 = 1e-4
B, K, HW = 2, 4, 56


@pytest.fixture(scope="module")
def pool():
    # one intra-op thread per rank: the ranks' work is small, and the test
    # run's other workers share the cores
    with RankPool(2, env={"OMP_NUM_THREADS": "1"}) as p:
        yield p


@pytest.fixture(scope="module")
def case():
    """dinov2-test weights from the JAX package, carried to the port, and
    seeded images: B=2 queries with K=4 references each."""
    jcfg = JaxConfig(backbone=JAX_VIT["dinov2-test"], pe_h=6, pe_w=6, decoder_heads=4)
    rng = np.random.default_rng(11)
    q = rng.standard_normal((B, HW, HW, 3)).astype(np.float32)
    r = rng.standard_normal((B, K, HW, HW, 3)).astype(np.float32)
    params = jax.device_get(jax.jit(JaxNet(jcfg).init)(jax.random.PRNGKey(4), jnp.asarray(q),
                                                       jnp.asarray(r))["params"])
    cfg = CrossScoreConfig(backbone=VIT_PRESETS["dinov2-test"], pe_h=6, pe_w=6, decoder_heads=4,
                           compute_dtype=torch.float32, mlp_impl="fused_exact")
    return jcfg, params, cfg, state_dict_from_jax(params), q, r


def _mae(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).mean())


@pytest.mark.parametrize("cached", [False, True], ids=["pixels", "cached-tokens"])
def test_vp_net_matches_jax_and_single_process(pool, case, cached):
    jcfg, params, cfg, state, q, r = case
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("data",))
    jcp = JaxNet(dataclasses.replace(jcfg, attention_impl="cp:data"))
    if cached:
        tokens = jax.jit(jax_encoder(dataclasses.replace(jcfg, attention_impl="cp:data")))(
            params, jnp.asarray(r.reshape(B * K, HW, HW, 3)))
        want = jax.jit(jax_vp_tokens(jcp, mesh))(params, jnp.asarray(q),
                                                 tokens.reshape(B, K, *tokens.shape[1:]))
    else:
        want = jax.jit(jax_vp_apply(jcp, mesh))(params, jnp.asarray(q), jnp.asarray(r))
    got = pool.run(workers.vp_net, dataclasses.replace(cfg, attention_impl="cp"), state, q, r, cached,
                   timeout=300)
    np.testing.assert_array_equal(got[0], got[1])  # every rank returns the same maps
    assert got[0].shape == (B, HW, HW)
    single = make_predict_step(load_into(CrossScoreNet(cfg, device="cpu"), state))(
        torch.from_numpy(q), torch.from_numpy(r))["score_map_ref_cross"].numpy()
    assert _mae(got[0], want) < MAE32, _mae(got[0], want)
    assert _mae(got[0], single) < MAE32, _mae(got[0], single)


def test_vp_train_gradients_match_jax_single_device(pool, case):
    """Training through view parallelism (the analogue of the JAX
    ``test_gradients_flow``), over every trainable gradient: the decoder, the
    head and the PE (``pe_trainable``), whose reference share each rank holds
    only in part. Every rank's gradients equal the JAX single-device ones."""
    jcfg, params, cfg, state, q, r = case
    gt = np.random.default_rng(12).random((B, HW, HW)).astype(np.float32)
    net = JaxNet(jcfg)

    def loss(p):
        out = net.apply({"params": p}, jnp.asarray(q), jnp.asarray(r))["score_map_ref_cross"]
        return jnp.abs(out - jnp.asarray(gt)).mean()

    want = state_dict_from_jax(jax.device_get(jax.jit(jax.grad(loss))(params)))
    got = pool.run(workers.vp_train_grads, dataclasses.replace(cfg, attention_impl="cp", pe_trainable=True),
                   state, q, r, gt, timeout=300)
    names = sorted(got[0])
    assert names == sorted(n for n in (f[len("model."):] for f in want)
                           if n.startswith("ref_cross.") or n == "pos_enc_fn.PE")
    for name in names:
        np.testing.assert_array_equal(got[1][name], got[0][name], err_msg=name)
        np.testing.assert_allclose(got[0][name], want[f"model.{name}"], atol=1e-5, rtol=0, err_msg=name)


def test_shard_position_embedding_needs_no_view_offset():
    """A shard of K/n views gets the PE that the whole K-view stack gives
    those views: the table is the same for every view."""
    pe = MultiViewPositionalEmbedding(6, 6, 16, device="cpu")
    torch.nn.init.normal_(pe.PE)
    x = torch.randn(2, 4 * 9, 16)
    whole = pe(x, 4, 3, 3).reshape(2, 4, 9, 16)
    for lo in (0, 2):
        shard = pe(x.reshape(2, 4, 9, 16)[:, lo:lo + 2].reshape(2, 18, 16), 2, 3, 3)
        torch.testing.assert_close(shard.reshape(2, 2, 9, 16), whole[:, lo:lo + 2], rtol=0, atol=0)


# --- the predict CLI on 2 ranks ---------------------------------------------------------------

QUERY = "datadir/res_540/s00001/test/ours_1000/renders"
REFS = "datadir/res_540/s00001/train/ours_1000/gt"


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    """A synthetic 84x112 tree and a checkpoint written by the port."""
    root = tmp_path_factory.mktemp("torch_vp_ws")
    generate(root / "datadir", hw=(84, 112), scenes_per_split={"train": 1, "test": 1})
    cfg = CrossScoreConfig.from_config(load_config("default_predict", ["model.backbone.preset=dinov2-test"]))
    ckpt = root / "run" / "ckpt" / "model.ckpt"
    ckpt.parent.mkdir(parents=True)
    torch.save({"state_dict": {f"model.{k}": v for k, v in init_params(cfg, 3).items()}}, ckpt)
    return root, ckpt


def _argv(ckpt, cache, alias):
    return ["trainer.accelerator=cpu", "model.backbone.preset=dinov2-test", "model.gpu.compute_dtype=float32",
            "data.neighbour_config.cross=2", "data.neighbour_config.deterministic=true",
            f"data.dataset.query_dir={QUERY}",
            f"data.dataset.reference_dir={REFS}", "data.loader.validation.batch_size=2",
            "data.loader.validation.num_workers=2", "this_main.resize_short_side=84",
            "logger.predict.write.config.score_map_colour_mode=gray",
            "logger.predict.write.config.vis_img_every_n_steps=-1", f"trainer.ckpt_path_to_load={ckpt}",
            f"this_main.ref_token_cache={cache}", f"alias={alias}"]


def _files(out):
    return sorted(str(p.relative_to(out)) for p in out.rglob("*") if p.is_file() and p.name != "config.yaml")


@pytest.mark.parametrize("cache", ["off", "on"])
def test_vp_cli_on_two_ranks_matches_single_rank(pool, ws, cache):
    root, ckpt = ws
    old = os.getcwd()
    os.chdir(root)
    try:
        want = root / main(_argv(ckpt, cache, f"one{cache}"))
    finally:
        os.chdir(old)
    texts = pool.run(workers.predict_cli, _argv(ckpt, cache, f"vp{cache}") + [
        "model.gpu.view_parallel=on", "model.gpu.dist_backend=gloo"], str(root), timeout=300)
    outs = {re.search(r"predict done: \d+ batches -> (\S+)", t).group(1) for t in texts}
    assert len(outs) == 1  # every rank names rank 0's output dir
    got = root / outs.pop()
    for rank, text in enumerate(texts):
        assert f"[rank {rank}/2] view-parallel predict: K=2 references over 2 ranks; this rank takes " \
               f"views [{rank}, {rank + 1})" in text
    digests = {re.search(r"score maps sha256 (\w+)", t).group(1) for t in texts}
    assert len(digests) == 1, digests  # both ranks computed the same maps
    if cache == "on":
        # every query lists the pool in one order, so rank r's view is always
        # reference r: one miss, which fills both slots of the first batch;
        # both slots of the second batch are hits
        for rank, text in enumerate(texts):
            assert f"[rank {rank}/2] ref-token cache: 2 hits, 1 unique misses" in text, text
    assert _files(got) == _files(want)  # rank 0 alone wrote, in the single rank's layout
    maps = sorted((want / "batch" / "score_map_ref_cross").glob("*.png"))
    assert len(maps) == 3
    for path in maps:
        a, b = (np.asarray(Image.open(p)).astype(np.float64) / 32767.0 for p in
                (path, got / "batch" / "score_map_ref_cross" / path.name))
        assert np.abs(a - b).max() <= MAE32, (path.name, np.abs(a - b).max())
