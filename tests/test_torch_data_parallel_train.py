"""The port's train CLI over data ranks on the CPU (gloo, one pool of 2 ranks
for the module, free of JAX): against the JAX train CLI at
``trainer.devices=2`` on 2 of the 8 virtual devices of ``conftest.py`` from
the same initial weights (per-step losses, validation, the final
parameters), a mid-epoch resume on 2 ranks against the uninterrupted run,
the files rank 0 alone writes, and ``train_recipe=token_fast`` on 2 ranks
against one rank at the same global batch."""

import json
import os
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_rank_workers as workers
from crossscore_tpu.confsys import load_config as jax_load_config
from crossscore_tpu.data import fastimage as jax_fastimage
from crossscore_tpu.io.checkpoint import load_params_host
from crossscore_tpu.io.torch_convert import convert_lightning_ckpt, load_torch_checkpoint
from crossscore_tpu.models import CrossScoreConfig as JaxConfig
from crossscore_tpu.models import CrossScoreNet as JaxNet
from crossscore_tpu.tasks.train import main as jax_main
from crossscore_tpu_torch.confsys import load_config
from crossscore_tpu_torch.data import fastimage as port_fastimage
from crossscore_tpu_torch.data.synthetic import generate
from crossscore_tpu_torch.io.checkpoint import CheckpointManager
from crossscore_tpu_torch.io.convert import load_into, state_dict_from_jax
from crossscore_tpu_torch.models import CrossScoreConfig, CrossScoreNet
from crossscore_tpu_torch.parallel.launch import RankPool
from crossscore_tpu_torch.tasks.train import main
from crossscore_tpu_torch.train.optim import make_optimizer

# fp32 on both sides: the packages differ by summation order (the JAX step
# over 2 devices, the port's gradient sum over 2 ranks)
LOSS_TOL, PARAM_TOL = 1e-5, 2e-5

COMMON = [
    "trainer.accelerator=cpu",
    "model.backbone.preset=dinov2-test",
    "data.neighbour_config.cross=2",
    "data.dataset.path=[datadir]",
    "data.loader.train.batch_size=2",
    "data.loader.validation.batch_size=2",
    "data.loader.train.num_workers=1",
    "data.loader.validation.num_workers=1",
    "data.transforms.crop_size=56",
    "this_main.resize_short_side=-1",
    "trainer.limit_val_batches=2",
    "trainer.num_sanity_val_steps=0",
    "logger.vis_scalar_every_n_train_steps=1",
]
PORT = COMMON + ["model.gpu.compute_dtype=float32", "model.gpu.dist_backend=gloo"]
JAX = COMMON + ["model.tpu.compute_dtype=float32", "logger.vis_imgs_every_n_train_steps=100000",
                "logger.vis_histogram_every_n_train_steps=100000",
                "logger.cache_size.validation.n_fig=0"]


@pytest.fixture(scope="module")
def pool():
    # one intra-op thread per rank, and the Pillow decoder (the JAX side's)
    with RankPool(2, env={"OMP_NUM_THREADS": "1", "CROSSSCORE_NO_NATIVE": "1"}) as p:
        yield p


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    """A synthetic tree (7 train items: 3 steps of 2 with drop_last) and the
    JAX CLI's initial weights, read into a step-0 checkpoint of the port's,
    so that both CLIs start from the same parameters; the CLIs run with cwd
    inside it, both packages on their Pillow decoders."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_fastimage, "available", lambda: False)
    mp.setattr(port_fastimage, "available", lambda: False)
    root = tmp_path_factory.mktemp("dp_train_ws")
    generate(root / "datadir", hw=(84, 112), scenes_per_split={"train": 1, "val": 1, "test": 1})
    old = os.getcwd()
    os.chdir(root)
    # the JAX CLI's init: the seed's key on the crop's shapes
    jax_cfg = jax_load_config("default", JAX)
    params = jax.device_get(JaxNet(JaxConfig.from_config(jax_cfg)).init(
        jax.random.PRNGKey(jax_cfg.seed), jnp.zeros((1, 56, 56, 3)), jnp.zeros((1, 2, 56, 56, 3)))["params"])
    cfg = load_config("default", PORT)
    model = load_into(CrossScoreNet(CrossScoreConfig.from_config(cfg), device="cpu"), state_dict_from_jax(params))
    optimizer, scheduler, _ = make_optimizer(cfg, model, 3)
    CheckpointManager(root / "init" / "ckpt").save(0, model, optimizer, scheduler,
                                                   {"step": 0, "epoch": 0, "batch_in_epoch": 0})
    yield root
    os.chdir(old)
    mp.undo()


def _rows(run_dir) -> list[dict]:
    return [json.loads(line) for line in (Path(run_dir) / "metrics.jsonl").read_text().splitlines()]


def _series(run_dir, key) -> list:
    return [r[key] for r in _rows(run_dir) if key in r]


def _run(pool, ws, argv, n=2, timeout=300) -> tuple[Path, list[str]]:
    out = pool.run(workers.run_cli, n, n, "train", argv, str(ws), timeout=timeout)
    dirs = {r[0] for r in out if r is not None}
    assert len(dirs) == 1, dirs  # every rank names rank 0's run dir
    return ws / dirs.pop(), [r[1] for r in out if r is not None]


def test_train_cli_on_two_ranks_matches_jax_on_two_devices(pool, ws):
    """B=2 a step on 2 ranks (1 row each) against the JAX CLI's B=2 over 2
    devices, from the same weights: every step's loss, the validation mean,
    and the final parameters read back into the JAX tree."""
    jax_run = jax_main(JAX + ["trainer.devices=2", "trainer.max_epochs=1", "alias=jax2"])
    port_run, texts = _run(pool, ws, PORT + ["trainer.max_epochs=1", "alias=port2",
                                             f"trainer.ckpt_path_to_load={ws / 'init' / 'ckpt'}"])
    for rank, text in enumerate(texts):
        assert f"[rank {rank}/2] resumed from step 0 (epoch 0, batch 0)" in text
        assert f"[rank {rank}/2] train done: 3 steps" in text
    assert _series(port_run, "step")[:3] == [1, 2, 3]
    for key in ("train/loss_cross", "train/loss", "validation/loss", "validation/correlation_cross"):
        want, got = _series(jax_run, key), _series(port_run, key)
        assert len(got) == len(want) > 0, key
        np.testing.assert_allclose(got, want, atol=LOSS_TOL, rtol=0, err_msg=key)
    jax_params = load_params_host(jax_run / "ckpt" / "3" / "default")["params"]
    port_tree = convert_lightning_ckpt(load_torch_checkpoint(str(port_run / "ckpt" / "step_00000003.ckpt")),
                                       num_backbone_layers=2, num_decoder_layers=2, d_model=64, do_self_attn=True)
    flat_j = {jax.tree_util.keystr(k): np.asarray(v) for k, v in jax.tree_util.tree_leaves_with_path(jax_params)}
    flat_p = {jax.tree_util.keystr(k): np.asarray(v) for k, v in jax.tree_util.tree_leaves_with_path(port_tree)}
    assert set(flat_j) == set(flat_p)
    # a key projection's bias has no gradient in exact arithmetic (it shifts
    # each query's logits by one constant, which the softmax removes): both
    # packages step it by AdamW-normalised rounding noise, up to lr a step
    # from its zero init, so it is held to that, and every other leaf to
    # PARAM_TOL
    noise = [k for k in flat_j if k.endswith("['k_proj']['bias']")]
    assert len(noise) == 4
    lr = float(load_config("default", PORT).trainer.optimizer.lr)
    assert all(np.abs(flat_j[k]).max() <= 3 * lr and np.abs(flat_p[k]).max() <= 3 * lr for k in noise)
    worst = max(float(np.abs(flat_j[k] - flat_p[k]).max()) for k in flat_j if k not in noise)
    assert worst <= PARAM_TOL, worst


def test_mid_epoch_resume_on_two_ranks_and_rank0_files(pool, ws):
    """Stop mid-epoch on 2 ranks and resume there from rank 0's checkpoint:
    the losses equal the uninterrupted 2-rank run's; one run dir, one line
    per step in the log and one checkpoint file set, written by rank 0."""
    ov = PORT + ["trainer.limit_train_batches=3", "trainer.max_epochs=2", "trainer.limit_val_batches=1"]
    full, _ = _run(pool, ws, ov + ["alias=full"])
    first, _ = _run(pool, ws, ov + ["trainer.max_steps=2", "alias=first",
                                    "trainer.checkpointing.save_last=true"])
    second, texts = _run(pool, ws, ov + [f"trainer.ckpt_path_to_load={first / 'ckpt'}", "alias=second"])
    assert all("resumed from step 2 (epoch 0, batch 2)" in t for t in texts)
    steps = [r["step"] for r in _rows(full) if "train/loss_cross" in r]
    assert steps == [1, 2, 3, 4, 5, 6]
    want = _series(full, "train/loss_cross")
    got = _series(first, "train/loss_cross") + _series(second, "train/loss_cross")
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    # rank 0 alone wrote: one run dir per alias, each step logged once, one
    # checkpoint file set and no stray tmp file
    for alias, run in (("full", full), ("first", first), ("second", second)):
        assert [p.name for p in (ws / "log").iterdir() if p.name.endswith(f"_{alias}")] == [run.name]
        logged = [r["step"] for r in _rows(run) if "train/loss_cross" in r]
        assert len(logged) == len(set(logged))
    assert sorted(p.name for p in (full / "ckpt").iterdir()) == ["hparams.yaml", "step_00000006.ckpt"]
    assert sorted(p.name for p in (first / "ckpt").iterdir()) == ["hparams.yaml", "step_00000002.ckpt"]
    assert sorted(p.name for p in full.iterdir()) == ["ckpt", "config.yaml", "metrics.jsonl"]


def test_token_fast_on_two_ranks_matches_one_rank(pool, ws):
    """``train_recipe=token_fast`` at B=2 on 2 ranks against one rank at
    B=2, on one shared token store: each rank encodes and stores only its
    own rows' images, every step's loss is the one rank's, and the store
    holds every file whole."""
    store = ws / "tokens_dp"
    ov = PORT + ["this_main.train_recipe=token_fast", "this_main.token_fast_min_coverage=0.2",
                 "trainer.max_steps=3", "trainer.limit_val_batches=1"]
    one = main(ov + ["alias=tok1", f"this_main.ref_token_cache_dir={ws / 'tokens_one'}"])
    two, texts = _run(pool, ws, ov + ["alias=tok2", f"this_main.ref_token_cache_dir={store}"])
    np.testing.assert_allclose(_series(two, "train/loss_cross"), _series(one, "train/loss_cross"),
                               atol=LOSS_TOL, rtol=0)
    np.testing.assert_allclose(_series(two, "validation/loss"), _series(one, "validation/loss"),
                               atol=LOSS_TOL, rtol=0)
    misses = [int(re.search(r"token cache: \d+ hits, (\d+) misses", t).group(1)) for t in texts]
    assert all(m > 0 for m in misses)
    files = sorted(p.name for p in store.iterdir())
    assert files and all(f.endswith(".npz") and ".tmp." not in f for f in files)
    assert set(files) <= {p.name for p in (ws / "tokens_one").iterdir()}
    for p in store.iterdir():
        with np.load(p) as z:
            assert z["data"].size == int(np.prod(z["shape"])) * torch.empty((), dtype=getattr(
                torch, str(z["dtype"]).removeprefix("torch."))).element_size()
