"""The port's train CLI end to end on the CPU (``trainer.accelerator=cpu``,
the tiny dinov2-test preset, fp32) on a synthetic dataset: validation,
checkpoints, resume, the exact mid-epoch resume, and checkpoints that the
JAX package's converter reads."""

import json
import os

import numpy as np
import pytest
import torch

from crossscore_tpu.io.torch_convert import convert_lightning_ckpt, load_torch_checkpoint
from crossscore_tpu_torch.data.synthetic import generate
from crossscore_tpu_torch.io.convert import state_dict_from_jax
from crossscore_tpu_torch.tasks.train import main

BASE = [
    "trainer.accelerator=cpu",
    "model.gpu.compute_dtype=float32",
    "model.backbone.preset=dinov2-test",
    "data.neighbour_config.cross=2",
    "data.dataset.path=[datadir]",
    "data.loader.train.batch_size=2",
    "data.loader.validation.batch_size=2",
    "data.loader.train.num_workers=1",
    "data.loader.validation.num_workers=1",
    "data.transforms.crop_size=56",
    "this_main.resize_short_side=-1",
    "trainer.limit_val_batches=1",
    "logger.vis_scalar_every_n_train_steps=1",
]


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    """A workspace with a synthetic dataset; the CLI runs with cwd inside it."""
    root = tmp_path_factory.mktemp("torch_train_ws")
    generate(root / "datadir", hw=(84, 112), scenes_per_split={"train": 1, "val": 1, "test": 1})
    old = os.getcwd()
    os.chdir(root)
    yield root
    os.chdir(old)


def _rows(run_dir):
    return [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]


def test_short_training_run_and_resume(ws, capsys):
    run_dir = main(BASE + ["trainer.num_sanity_val_steps=1", "trainer.max_epochs=1", "alias=t1"])
    rows = _rows(run_dir)
    assert any("validation/loss" in r for r in rows)
    train_rows = [r for r in rows if "train/loss" in r]
    assert [r["step"] for r in train_rows] == [1, 2, 3]  # 7 train items, batch 2, drop_last
    assert set(train_rows[0]) == {"step", "time", "train/loss", "train/loss_cross", "train/psnr_cross",
                                  "train/correlation_cross", "train/lr", "train/steps_per_sec"}
    assert all(np.isfinite(r["train/loss"]) for r in train_rows)
    assert (run_dir / "config.yaml").exists() and (run_dir / "ckpt" / "hparams.yaml").exists()
    assert sorted(p.name for p in (run_dir / "ckpt").glob("*.ckpt")) == ["step_00000003.ckpt"]

    run2 = main(BASE + ["trainer.num_sanity_val_steps=0", "trainer.max_epochs=2",
                        "trainer.optimizer.lr=1e-3", f"trainer.ckpt_path_to_load={run_dir / 'ckpt'}",
                        "alias=t2"])
    out = capsys.readouterr().out
    assert "resumed from step 3 (epoch 1, batch 0)" in out
    assert "WARNING: resuming with a config that differs" in out and "trainer.optimizer.lr" in out
    steps = [r["step"] for r in _rows(run2) if "train/loss" in r]
    assert steps == [4, 5, 6]
    assert [r["train/lr"] for r in _rows(run2) if "train/lr" in r] == [1e-3] * 3


def test_mid_epoch_resume_identical_trajectory(ws):
    """Stop mid-epoch and resume from the checkpoint: the losses equal an
    uninterrupted run's (the checkpoint holds the loop cursor, epoch and
    batch in epoch, and the loader's items are functions of (seed, epoch,
    index))."""
    ov = BASE + ["trainer.num_sanity_val_steps=0", "trainer.limit_train_batches=3",
                 "trainer.max_epochs=2"]

    def losses(run_dir):
        return {r["step"]: r["train/loss_cross"] for r in _rows(run_dir) if "train/loss_cross" in r}

    full = losses(main(ov + ["alias=full"]))
    part = main(ov + ["trainer.max_steps=4", "alias=part"])  # epoch 1, batch 1 (3 steps per epoch)
    resumed = losses(main(ov + [f"trainer.ckpt_path_to_load={part / 'ckpt'}", "alias=res"]))
    assert set(full) == {1, 2, 3, 4, 5, 6}
    assert set(resumed) == {5, 6}, "resume must re-enter mid-epoch, not restart it"
    for step in resumed:
        assert resumed[step] == pytest.approx(full[step], rel=1e-6), step


def test_checkpoint_reads_into_the_jax_tree(ws):
    """``crossscore_tpu/io/torch_convert.py`` reads the port's checkpoint (the
    reference Lightning keys) into the JAX parameter tree, value for value."""
    run_dir = main(BASE + ["trainer.num_sanity_val_steps=0", "trainer.max_steps=1", "alias=conv"])
    path = run_dir / "ckpt" / "step_00000001.ckpt"
    blob = torch.load(path, map_location="cpu", weights_only=True)
    assert blob["loop"] == {"step": 1, "epoch": 0, "batch_in_epoch": 1}
    assert len(blob["optimizer_states"][0]["state"]) == sum(
        1 for k in blob["state_dict"] if k.startswith("model.ref_cross."))
    tree = convert_lightning_ckpt(load_torch_checkpoint(str(path)), num_backbone_layers=2,
                                  num_decoder_layers=2, d_model=64, do_self_attn=True)
    back = state_dict_from_jax(tree)
    assert set(back) == set(blob["state_dict"])
    for key, value in blob["state_dict"].items():
        np.testing.assert_array_equal(back[key], value.numpy(), err_msg=key)


def test_padded_final_val_batch_equals_exact_mean(ws):
    """Validation keeps the final partial batch and weights its padded
    duplicates out (``_valid``): with 7 val items at batch 2 the logged loss
    equals a batch-1 run over the same items."""
    common = BASE + ["trainer.num_sanity_val_steps=999", "trainer.limit_val_batches=1.0",
                     "trainer.max_epochs=0"]

    def val_loss(bs):
        rows = _rows(main(common + [f"data.loader.validation.batch_size={bs}", f"alias=val{bs}"]))
        return [r["validation/loss"] for r in rows if "validation/loss" in r]

    padded, exact = val_loss(2), val_loss(1)
    assert len(padded) == len(exact) == 1
    assert padded[0] == pytest.approx(exact[0], rel=1e-5)


def test_profiler_window_and_sustained_report(ws, capsys):
    """``trainer.do_profiling`` traces steps 12..22 into the run dir, and the
    sustained report times the steps after its warm-up."""
    run_dir = main(BASE + ["trainer.num_sanity_val_steps=0", "trainer.max_epochs=8",
                           "trainer.check_val_every_n_epoch=100", "trainer.do_profiling=true",
                           "this_main.sustained_report_after_steps=2", "alias=prof"])
    assert (run_dir / "profiler" / "trace.json").stat().st_size > 0
    assert "sustained:" in capsys.readouterr().out
    rows = _rows(run_dir)
    sustained = [r for r in rows if "train/sustained_ms_per_step" in r]
    assert len(sustained) == 1 and sustained[0]["train/sustained_steps"] == 24 - 2
    assert max(r["step"] for r in rows) == 24


@pytest.mark.parametrize("overrides,world,error,match", [
    (["trainer.devices=2"], None, ValueError, r"trainer.devices=2 asks for 2 ranks, and 1 were launched.*"
                                              r"torchrun --nproc_per_node 2"),
    (["trainer.devices=[0,1]"], None, ValueError, r"asks for 2 ranks, and 1 were launched"),
    (["model.gpu.dist_backend=gloo"], "2", RuntimeError, "MASTER_PORT is not set: start the ranks with torchrun"),
])
def test_more_than_one_device_or_rank_is_refused(ws, monkeypatch, overrides, world, error, match):
    """``trainer.devices`` above the launched ranks (one process drives one
    card), or a launch of several ranks that cannot join its process group,
    raises before any run dir is made; the data-parallel runs themselves are
    held in ``tests/test_torch_data_parallel*.py``."""
    for key in ("MASTER_PORT", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)
    if world is None:
        monkeypatch.delenv("WORLD_SIZE", raising=False)
    else:
        monkeypatch.setenv("WORLD_SIZE", world)
    before = set((ws / "log").rglob("*")) if (ws / "log").exists() else set()
    with pytest.raises(error, match=match):
        main(BASE + overrides + ["alias=refused"])
    after = set((ws / "log").rglob("*")) if (ws / "log").exists() else set()
    assert after == before


def test_devices_minus_one_runs_on_the_one_launched_rank(ws, monkeypatch):
    """``trainer.devices=-1`` (the default, as in the JAX config) takes every
    launched rank: without a launcher, the one process, whose run equals
    ``trainer.devices=1``'s step for step."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    ov = BASE + ["trainer.num_sanity_val_steps=0", "trainer.max_steps=2"]
    runs = [main(ov + [f"trainer.devices={d}", f"alias=dev{d}"]) for d in (-1, 1)]
    losses = [[r["train/loss"] for r in _rows(run) if "train/loss" in r] for run in runs]
    assert len(losses[0]) == 2 and losses[0] == losses[1]
