"""The port's converter command (``python -m crossscore_tpu_torch.io.convert``)
against the JAX package's converter (``crossscore_tpu/io/torch_convert.py``):
the default mode and ``--reverse`` bit for bit in both directions,
``--hf-backbone`` on HuggingFace directories written by ``save_pretrained``
(safetensors and ``pytorch_model.bin``) against the JAX backbone loaded
through ``convert_hf_dinov2`` (fp32, 1e-4), and the refusals. dinov2-test
widths, seeded random weights."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crossscore_tpu.io.torch_convert import (
    convert_hf_dinov2, convert_lightning_ckpt, load_torch_checkpoint, save_lightning_ckpt, state_dict_to_numpy,
)
from crossscore_tpu.models import CrossScoreConfig as JaxConfig
from crossscore_tpu.models import CrossScoreNet as JaxNet
from crossscore_tpu.models.dinov2 import VIT_PRESETS as JAX_VIT
from crossscore_tpu.models.dinov2 import Dinov2Encoder as JaxEncoder
from crossscore_tpu_torch.io import convert
from crossscore_tpu_torch.io.checkpoint import CheckpointManager
from crossscore_tpu_torch.models import VIT_PRESETS, CrossScoreConfig, CrossScoreNet

ROOT = Path(__file__).resolve().parent.parent
WIDTHS = ["--backbone-layers", "2", "--decoder-layers", "2", "--d-model", "64"]
HF_TOL = 1e-4  # fp32 backbone against JAX's (the score-map parity tolerance)


@pytest.fixture(scope="module")
def jax_params():
    cfg = JaxConfig(backbone=JAX_VIT["dinov2-test"])
    q, r = jnp.zeros((1, 56, 56, 3)), jnp.zeros((1, 2, 56, 56, 3))
    return jax.device_get(JaxNet(cfg).init(jax.random.PRNGKey(5), q, r)["params"])


@pytest.fixture(scope="module")
def hf_dirs(tmp_path_factory):
    """A random dinov2-test ``Dinov2Model`` saved twice by ``save_pretrained``:
    as ``model.safetensors`` and as ``pytorch_model.bin``."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("USE_TF", "0")  # transformers' TensorFlow half is not needed
        from transformers import Dinov2Config, Dinov2Model

    torch.manual_seed(0)
    vit = VIT_PRESETS["dinov2-test"]
    model = Dinov2Model(Dinov2Config(
        hidden_size=vit.hidden_size, num_hidden_layers=vit.num_layers, num_attention_heads=vit.num_heads,
        mlp_ratio=vit.mlp_ratio, patch_size=vit.patch_size, image_size=vit.image_size,
        layerscale_value=0.5, hidden_act="gelu")).eval()
    root = tmp_path_factory.mktemp("hf")
    model.save_pretrained(root / "safetensors")
    model.save_pretrained(root / "bin", safe_serialization=False)
    assert (root / "safetensors" / "model.safetensors").is_file()
    assert (root / "bin" / "pytorch_model.bin").is_file()
    return {"safetensors": root / "safetensors", "bin": root / "bin"}, Dinov2Model


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}/") if isinstance(v, dict) else {f"{prefix}{k}": np.asarray(v)})
    return out


def _port_checkpoint(params, directory: Path, step: int = 3) -> Path:
    """A train checkpoint of the port (``io/checkpoint.py``, optimiser state
    included) holding the JAX tree's weights."""
    net = convert.load_into(CrossScoreNet(CrossScoreConfig(backbone=VIT_PRESETS["dinov2-test"]), device="cpu"),
                            convert.state_dict_from_jax(params))
    optimizer = torch.optim.AdamW([p for p in net.parameters() if p.requires_grad])
    scheduler = torch.optim.lr_scheduler.StepLR(optimizer, 1)
    CheckpointManager(directory).save(step, net, optimizer, scheduler, {"step": step, "epoch": 1, "batch_in_epoch": 0})
    return directory


def test_round_trip_through_the_port_is_bit_for_bit(jax_params, tmp_path, capsys):
    """JAX tree -> ``save_lightning_ckpt`` -> the default mode -> ``--reverse``:
    the same ``state_dict``, bit for bit, in the Lightning envelope."""
    src = tmp_path / "reference.ckpt"
    save_lightning_ckpt(str(src), jax_params)
    convert.main([str(src), str(tmp_path / "port"), *WIDTHS])
    written = tmp_path / "port" / "step_00000000.ckpt"
    assert f"Converted {src} -> {written}" in capsys.readouterr().out
    assert set(torch.load(written, weights_only=True)) == {"state_dict"}
    convert.main([str(tmp_path / "port"), str(tmp_path / "back.ckpt"), "--reverse"])
    want = torch.load(src, weights_only=True)["state_dict"]
    back = torch.load(tmp_path / "back.ckpt", weights_only=True)
    assert set(back["state_dict"]) == set(want)
    for k, v in want.items():
        assert back["state_dict"][k].dtype == torch.float32 and torch.equal(back["state_dict"][k], v), k
    assert {k: back[k] for k in ("pytorch-lightning_version", "epoch", "global_step", "loops")} == {
        "pytorch-lightning_version": "2.1.3", "epoch": 0, "global_step": 0, "loops": {}}


def test_the_jax_converter_reads_the_reverse_file(jax_params, tmp_path):
    """A port train checkpoint -> ``--reverse`` -> ``load_torch_checkpoint`` +
    ``convert_lightning_ckpt``: the JAX tree the port started from, bit for
    bit; the envelope carries the checkpoint's step and epoch."""
    ckpt_dir = _port_checkpoint(jax_params, tmp_path / "run" / "ckpt")
    out = tmp_path / "reverted.ckpt"
    convert.main([str(ckpt_dir), str(out), "--reverse"])
    tree = convert_lightning_ckpt(load_torch_checkpoint(str(out)), 2, 2, 64)
    got, want = _flat(tree), _flat(jax_params)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k
    blob = torch.load(out, weights_only=True)
    assert (blob["epoch"], blob["global_step"]) == (1, 3)


def test_the_converted_directory_restores_through_the_clis_loader(jax_params, tmp_path):
    """The default mode's directory is what ``trainer.ckpt_path_to_load``
    takes (``tasks/common.py::load_model_params``): the net holds the JAX
    weights exactly."""
    from crossscore_tpu_torch.confsys import load_config
    from crossscore_tpu_torch.tasks.common import load_model_params

    src = tmp_path / "reference.ckpt"
    save_lightning_ckpt(str(src), jax_params)
    convert.main([str(src), str(tmp_path / "port"), *WIDTHS])
    cfg = load_config("default_predict", overrides=["model.backbone.preset=dinov2-test",
                                                    f"trainer.ckpt_path_to_load={tmp_path / 'port'}"])
    net = load_model_params(cfg, CrossScoreNet(CrossScoreConfig.from_config(cfg), device="cpu"))
    want = convert.state_dict_from_jax(jax_params)
    for k, v in net.state_dict().items():
        assert np.array_equal(v.numpy(), np.asarray(want[f"model.{k}"], np.float32)), k


def _pickled_objects_ckpt(jax_params, path) -> dict:
    """A Lightning-like file whose hyper-parameters are a pickled object ->
    its state_dict."""
    import argparse

    sd = {k: torch.from_numpy(np.ascontiguousarray(v, np.float32))
          for k, v in convert.state_dict_from_jax(jax_params).items()}
    torch.save({"state_dict": sd, "hyper_parameters": argparse.Namespace(lr=1e-4)}, path)
    return sd


def test_the_default_mode_reads_a_lightning_file_that_pickled_objects(jax_params, tmp_path, capsys):
    """A Lightning file also pickles its hyper-parameters, which a tensors-only
    load refuses: with --trust-pickle the converter reads it in full, as the
    JAX converter does."""
    sd = _pickled_objects_ckpt(jax_params, tmp_path / "hp.ckpt")
    convert.main([str(tmp_path / "hp.ckpt"), str(tmp_path / "out"), *WIDTHS, "--trust-pickle"])
    assert "holds Python objects besides tensors: read in full (--trust-pickle)" in capsys.readouterr().out
    got = torch.load(tmp_path / "out" / "step_00000000.ckpt", weights_only=True)["state_dict"]
    assert set(got) == set(sd) and all(torch.equal(got[k], v) for k, v in sd.items())


def test_the_default_mode_refuses_pickled_objects_without_trust_pickle(jax_params, tmp_path):
    _pickled_objects_ckpt(jax_params, tmp_path / "hp.ckpt")
    with pytest.raises(ValueError, match="pass --trust-pickle"):
        convert.main([str(tmp_path / "hp.ckpt"), str(tmp_path / "out"), *WIDTHS])
    assert not (tmp_path / "out").exists()


@pytest.mark.parametrize("case", ["unexpected key", "missing key", "shape", "width"])
def test_the_default_mode_refuses_a_checkpoint_that_does_not_fit(jax_params, tmp_path, case):
    sd = {k: torch.from_numpy(np.ascontiguousarray(v, np.float32))
          for k, v in convert.state_dict_from_jax(jax_params).items()}
    argv, name = list(WIDTHS), None
    if case == "unexpected key":
        sd["model.extra.weight"], name = torch.zeros(2), "model.extra.weight"
    elif case == "missing key":
        name = "model.ref_cross.head.2.bias"
        del sd[name]
    elif case == "shape":
        name = "model.ref_cross.head.0.weight"
        sd[name] = torch.zeros(3, 3)
    else:  # a third backbone layer the file does not hold
        argv[1], name = "3", "model.backbone.encoder.layer.2"
    torch.save({"state_dict": sd}, tmp_path / "bad.ckpt")
    with pytest.raises(ValueError, match=name.replace(".", r"\.")):
        convert.main([str(tmp_path / "bad.ckpt"), str(tmp_path / "out"), *argv])
    assert not (tmp_path / "out").exists()


@pytest.mark.parametrize("form", ["safetensors", "bin"])
def test_hf_backbone_matches_the_jax_backbone(hf_dirs, tmp_path, form):
    """``--hf-backbone`` on a ``save_pretrained`` directory: the file loads
    through ``load_backbone`` under the HF keys, and the port's fp32
    backbone matches the JAX backbone converted by ``convert_hf_dinov2`` from
    the same directory."""
    dirs, hf_model_cls = hf_dirs
    out = tmp_path / "backbone.pt"
    convert.main([str(dirs[form]), str(out), "--hf-backbone"])
    state = torch.load(out, weights_only=True)
    hf = hf_model_cls.from_pretrained(str(dirs[form]), local_files_only=True).eval()
    assert set(state) == set(hf.state_dict())
    for k, v in hf.state_dict().items():
        assert state[k].dtype == torch.float32 and torch.equal(state[k], v.float()), k

    vit = VIT_PRESETS["dinov2-test"]
    net = convert.load_backbone(CrossScoreNet(CrossScoreConfig(backbone=vit, parity=True), device="cpu"), out)
    img = np.random.default_rng(1).standard_normal((2, 56, 56, 3)).astype(np.float32)
    with torch.no_grad():
        got = net.backbone(torch.from_numpy(img)).numpy()
    params = convert_hf_dinov2(state_dict_to_numpy(hf.state_dict()), vit.num_layers)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(JaxEncoder(JAX_VIT["dinov2-test"]).apply({"params": params}, jnp.asarray(img)))
    assert got.shape == want.shape == (2, 17, 64)
    assert float(np.abs(got - want).max()) <= HF_TOL


def test_hf_backbone_refuses_weights_that_its_config_does_not_describe(hf_dirs, tmp_path):
    dirs, _ = hf_dirs
    bad = tmp_path / "three_layers"
    bad.mkdir()
    cfg = json.loads((dirs["safetensors"] / "config.json").read_text())
    (bad / "config.json").write_text(json.dumps({**cfg, "num_hidden_layers": 3}))
    os.symlink(dirs["safetensors"] / "model.safetensors", bad / "model.safetensors")
    with pytest.raises(ValueError, match=r"encoder\.layer\.2"):
        convert.main([str(bad), str(tmp_path / "out.pt"), "--hf-backbone"])


def test_safetensors_reader_takes_f32_f16_and_bf16(tmp_path):
    from safetensors.torch import save_file

    gen = torch.Generator().manual_seed(0)
    want = {"f32": torch.randn(3, 5, generator=gen), "f16": torch.randn(4, generator=gen).half(),
            "bf16": torch.randn(2, 3, 2, generator=gen).to(torch.bfloat16)}
    save_file(want, str(tmp_path / "t.safetensors"), metadata={"format": "pt"})
    got = convert.read_safetensors(tmp_path / "t.safetensors")
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    save_file({"i64": torch.arange(3)}, str(tmp_path / "i.safetensors"))
    with pytest.raises(ValueError, match="I64"):
        convert.read_safetensors(tmp_path / "i.safetensors")


def test_the_port_reads_hf_directories_without_transformers_or_safetensors(hf_dirs, tmp_path):
    """The card's machine has neither package: the converter imports neither."""
    dirs, _ = hf_dirs
    code = ("import sys; from crossscore_tpu_torch.io import convert; "
            f"convert.main([{str(dirs['safetensors'])!r}, {str(tmp_path / 'b.pt')!r}, '--hf-backbone']); "
            "print(sorted(m for m in ('transformers', 'safetensors') if m in sys.modules))")
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == "[]"
    assert (tmp_path / "b.pt").is_file()
