"""The rest of the port's train CLI against the JAX train CLI on the CPU
(dinov2-test, fp32, both packages on their Pillow decoders, the same initial
weights): ``model.backbone.init_path`` (the port reads a HuggingFace-keyed
torch file where JAX reads an orbax directory of the same backbone), the
score and L1 histograms in ``metrics.jsonl``, the figure files, the startup
check that stops a run whose figures cannot be drawn, ``JsonlLogger``'s
histogram rows, and the two packages' config keys."""

import json
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from crossscore_tpu.confsys import load_config as jax_load_config
from crossscore_tpu.data import fastimage as jax_fastimage
from crossscore_tpu.io.checkpoint import load_params_host, save_params
from crossscore_tpu.io.torch_convert import convert_lightning_ckpt, load_torch_checkpoint, revert_hf_dinov2
from crossscore_tpu.models import CrossScoreConfig as JaxConfig
from crossscore_tpu.models import CrossScoreNet as JaxNet
from crossscore_tpu.tasks.common import JsonlLogger as JaxJsonlLogger
from crossscore_tpu.tasks.train import main as jax_main
from crossscore_tpu_torch.confsys import load_config
from crossscore_tpu_torch.data import fastimage as port_fastimage
from crossscore_tpu_torch.data.synthetic import generate
from crossscore_tpu_torch.io.convert import load_backbone, state_dict_from_jax
from crossscore_tpu_torch.models import CrossScoreConfig, CrossScoreNet
from crossscore_tpu_torch.tasks import train as train_mod
from crossscore_tpu_torch.tasks.common import JsonlLogger

ROOT = Path(__file__).resolve().parent.parent
# fp32 on both sides; summation order differs
LOSS_TOL = 1e-5
# the 10-bin histograms of ~6k scores: both packages' maps agree to ~1e-6, so
# a value that close to a bin edge may land in the next bin on one side
HIST_COUNT_TOL = 2

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
    "trainer.num_sanity_val_steps=0",
    "logger.vis_scalar_every_n_train_steps=1",
]
PORT = COMMON + ["model.gpu.compute_dtype=float32"]
JAX = COMMON + ["model.tpu.compute_dtype=float32"]
FIGURES_OFF = ["logger.vis_imgs_every_n_train_steps=100000", "logger.cache_size.validation.n_fig=0"]
# the keys of the packages' YAML trees that only one of them has: the TPU
# knobs (model.tpu.*) and the GPU knobs (model.gpu.*)
TPU_ONLY = {"tpu.parity", "tpu.compute_dtype", "tpu.attention_impl", "tpu.mlp_impl", "tpu.remat_backbone",
            "tpu.backbone_quant", "tpu.view_parallel", "tpu.scoped_vmem_kib"}
GPU_ONLY = {"gpu.parity", "gpu.compute_dtype", "gpu.attention_impl", "gpu.mlp_impl", "gpu.backbone_quant",
            "gpu.dist_backend"}


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    """A synthetic tree (7 train items: 3 steps of 2), the JAX CLI's initial
    weights for the port's CLI, and a seeded dinov2-test backbone saved as an
    orbax directory (JAX) and as a HuggingFace-keyed torch file (the port)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_fastimage, "available", lambda: False)
    mp.setattr(port_fastimage, "available", lambda: False)
    root = tmp_path_factory.mktemp("train_quality_ws")
    generate(root / "datadir", hw=(84, 112), scenes_per_split={"train": 1, "val": 1, "test": 1})
    old = os.getcwd()
    os.chdir(root)
    jax_cfg = jax_load_config("default", JAX)
    net = JaxNet(JaxConfig.from_config(jax_cfg))
    shapes = (jnp.zeros((1, 56, 56, 3)), jnp.zeros((1, 2, 56, 56, 3)))
    params = jax.device_get(net.init(jax.random.PRNGKey(jax_cfg.seed), *shapes)["params"])
    backbone = jax.device_get(net.init(jax.random.PRNGKey(123), *shapes)["params"]["backbone"])
    save_params(root / "backbone_orbax", backbone)
    torch.save({k: torch.from_numpy(np.array(v, np.float32))
                for k, v in revert_hf_dinov2(backbone).items()}, root / "backbone_hf.pt")
    # the port's CLI starts from the JAX CLI's init
    mp.setattr(train_mod, "init_params", lambda mcfg, seed, device: state_dict_from_jax(params))
    yield root, backbone
    os.chdir(old)
    mp.undo()


def _rows(run_dir) -> list[dict]:
    return [json.loads(line) for line in (Path(run_dir) / "metrics.jsonl").read_text().splitlines()]


def _series(run_dir, key) -> list:
    return [r[key] for r in _rows(run_dir) if key in r]


def _flat(tree) -> dict:
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def test_init_path_matches_jax(ws):
    """2 fp32 steps from the same decoder and head, the backbone from
    ``init_path``: the losses within LOSS_TOL and, after the run, the port's
    backbone the file's and the JAX run's, bit for bit."""
    root, backbone = ws
    ov = ["trainer.max_steps=2", "trainer.limit_val_batches=0"] + FIGURES_OFF
    jax_run = jax_main(JAX + ov + [f"model.backbone.init_path={root / 'backbone_orbax'}", "alias=jax_init"])
    port_run = train_mod.main(PORT + ov + [f"model.backbone.init_path={root / 'backbone_hf.pt'}", "alias=port_init"])
    want, got = _series(jax_run, "train/loss_cross"), _series(port_run, "train/loss_cross")
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got, want, atol=LOSS_TOL, rtol=0)
    port_tree = convert_lightning_ckpt(load_torch_checkpoint(str(port_run / "ckpt" / "step_00000002.ckpt")),
                                       num_backbone_layers=2, num_decoder_layers=2, d_model=64, do_self_attn=True)
    jax_bb = _flat(load_params_host(jax_run / "ckpt" / "2" / "default")["params"]["backbone"])
    port_bb, file_bb = _flat(port_tree["backbone"]), _flat(backbone)
    assert set(port_bb) == set(jax_bb) == set(file_bb)
    for key in file_bb:
        np.testing.assert_array_equal(port_bb[key], file_bb[key], err_msg=key)
        np.testing.assert_array_equal(port_bb[key], jax_bb[key], err_msg=key)


def test_init_path_reads_a_lightning_checkpoint_and_refuses_a_mismatch(ws, tmp_path):
    root, _ = ws
    hf = torch.load(root / "backbone_hf.pt", weights_only=True)
    cfg = CrossScoreConfig.from_config(load_config("default", PORT))
    torch.save({"state_dict": {f"model.backbone.{k}": v for k, v in hf.items()} | {"model.pos_enc_fn.PE": 0},
                "epoch": 0}, tmp_path / "lightning.ckpt")
    model = load_backbone(CrossScoreNet(cfg, device="cpu"), tmp_path / "lightning.ckpt")
    for k, v in model.backbone.state_dict().items():
        assert torch.equal(v, hf[k]), k
    bad = dict(hf)
    bad["layernorm.weight"] = torch.zeros(65)
    torch.save(bad, tmp_path / "bad.pt")
    with pytest.raises(ValueError, match="layernorm.weight"):
        load_backbone(CrossScoreNet(cfg, device="cpu"), tmp_path / "bad.pt")
    del bad["layernorm.weight"]
    torch.save(bad, tmp_path / "missing.pt")
    with pytest.raises(ValueError, match="missing"):
        load_backbone(CrossScoreNet(cfg, device="cpu"), tmp_path / "missing.pt")


def test_histograms_and_figures_match_jax(ws):
    """3 steps with the histograms every step, the train-batch figure every
    2nd and 2 validation figures: the ``train/score_hist_*`` and
    ``train/l1_diff_hist_*`` rows as JAX's (each bin within HIST_COUNT_TOL,
    the totals the batch's pixels), and the same figure files."""
    ov = ["trainer.max_epochs=1", "trainer.limit_val_batches=2", "logger.vis_histogram_every_n_train_steps=1",
          "logger.vis_imgs_every_n_train_steps=2", "logger.cache_size.validation.n_fig=2"]
    jax_run = jax_main(JAX + ov + ["alias=jax_hist"])
    port_run = train_mod.main(PORT + ov + ["alias=port_hist"])
    for name in ("train/score_hist", "train/l1_diff_hist"):
        keys = [f"{name}_{i}" for i in range(10)]
        want = [[r[k] for k in keys] for r in _rows(jax_run) if keys[0] in r]
        got = [[r[k] for k in keys] for r in _rows(port_run) if keys[0] in r]
        assert len(got) == len(want) == 3, name
        assert [r["step"] for r in _rows(port_run) if keys[0] in r] == [1, 2, 3]
        for g, w in zip(got, want):
            assert sum(g) == sum(w) == 2 * 56 * 56, name
            assert max(abs(a - b) for a, b in zip(g, w)) <= HIST_COUNT_TOL, (name, g, w)
    names = sorted(p.name for p in (port_run / "vis").iterdir())
    assert names == sorted(p.name for p in (jax_run / "vis").iterdir())
    assert names == ["train_s000002.png", "val_e000_B00.png", "val_e000_B01.png"]


def test_figures_without_matplotlib_stop_the_run_before_a_step(ws, monkeypatch):
    """With matplotlib missing (the card's machine), a run that would draw
    a figure raises at startup naming both keys: validation figures, or a
    train-batch figure within the run's last step. A run whose cadence lies
    beyond its last step, with no validation figure, runs, and logs the
    histograms, which need no matplotlib."""
    root, _ = ws
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # import matplotlib raises ImportError
    before = set((root / "log").iterdir()) if (root / "log").exists() else set()
    for ov in (["trainer.max_steps=2"],  # validation figures (n_fig 2 by default)
               ["trainer.max_steps=2", "logger.vis_imgs_every_n_train_steps=2",
                "logger.cache_size.validation.n_fig=0"]):
        with pytest.raises(RuntimeError, match="vis_imgs_every_n_train_steps.*validation.n_fig"):
            train_mod.main(PORT + ov + ["alias=nofig"])
    for run in set((root / "log").iterdir()) - before:  # no step was taken
        assert not any("train/loss" in r for r in _rows(run))
    # 1 step an epoch, 1 epoch: the figure cadence of 100 is never reached
    run = train_mod.main(PORT + ["logger.cache_size.validation.n_fig=0", "trainer.max_epochs=1",
                                 "trainer.limit_train_batches=1", "trainer.limit_val_batches=1",
                                 "logger.vis_histogram_every_n_train_steps=1", "alias=hist_only"])
    rows = _rows(run)
    assert [r["step"] for r in rows if "train/score_hist_0" in r] == [1]
    assert not (run / "vis").exists()


def test_jsonl_logger_histogram_rows_match_jax(tmp_path, capsys):
    values = np.random.default_rng(0).random((2, 9, 11), dtype=np.float32)
    for cls, sub in ((JaxJsonlLogger, "jax"), (JsonlLogger, "port")):
        (tmp_path / sub).mkdir()
        logger = cls(tmp_path / sub, load_config("default"), use_wandb=True)  # no wandb here: the file only
        logger.log_histogram("train/score_hist", values, 5)
        logger.log_figure("train/batch_vis", object(), 5)  # a no-op without wandb
        logger.close()
    assert capsys.readouterr().out.count("wandb unavailable") == 2
    jax_rows, port_rows = _rows(tmp_path / "jax"), _rows(tmp_path / "port")
    for r in jax_rows + port_rows:
        r.pop("time")
    assert port_rows == jax_rows and len(port_rows) == 1
    assert sum(port_rows[0][f"train/score_hist_{i}"] for i in range(10)) == values.size


@pytest.mark.parametrize("name", ["default.yaml", "model/model.yaml"])
def test_config_keys_match_jax_but_the_device_knobs(name):
    def keys(tree, pre=""):
        out = set()
        for k, v in tree.items():
            out |= keys(v, f"{pre}{k}.") if isinstance(v, dict) else {pre + k}
        return out

    jax_keys = keys(yaml.safe_load((ROOT / "crossscore_tpu" / "config" / name).read_text()))
    port_keys = keys(yaml.safe_load((ROOT / "crossscore_tpu_torch" / "config" / name).read_text()))
    only = (TPU_ONLY, GPU_ONLY) if name.startswith("model") else (set(), set())
    assert jax_keys - port_keys == only[0]
    assert port_keys - jax_keys == only[1]
