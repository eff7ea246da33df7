"""The port's evaluation tools and small host CLIs on the CPU:
``multimethod_eval --tiny`` (one training step, K=4) and ``k_sweep`` on its
corpus and checkpoint, their output lines parsed; ``data/split_builder.py``
against the JAX package's on the same seeded 3DGS-style logs (the same
``split.json``); ``data/debug_vis.py`` against the JAX package's (the same
arrays, bit for bit, and the same file names); the corpus of
``generate_method_tree`` against the JAX package's, byte for byte."""

import json
import shutil
from pathlib import Path

import numpy as np
import pytest

from crossscore_tpu.data import debug_vis as jax_debug_vis
from crossscore_tpu.data import fastimage as jax_fastimage
from crossscore_tpu.data import split_builder as jax_split_builder
from crossscore_tpu.data.nvs_index import NvsDataset as JaxNvsDataset
from crossscore_tpu.data.synthetic import generate_method_tree as jax_generate_method_tree
from crossscore_tpu_torch.data import debug_vis, split_builder
from crossscore_tpu_torch.data import fastimage as port_fastimage
from crossscore_tpu_torch.data.nvs_index import NvsDataset
from crossscore_tpu_torch.data.synthetic import generate, generate_method_tree
from crossscore_tpu_torch.tools import k_sweep, multimethod_eval


def _trailing_json(text: str):
    return json.loads(text[text.rindex("\n{\n") + 1:])


def test_multimethod_eval_and_k_sweep(tmp_path, capsys):
    assert multimethod_eval.main(["--out", str(tmp_path), "--accel", "cpu", "--tiny", "--train-steps", "1",
                                  "--ks", "4"]) == 0
    report = _trailing_json(capsys.readouterr().out)
    assert report["dataset"] == "synthmfr" and report["methods"] == ["gaussian", "tensorf", "nerfacto"]
    (run,) = report["runs"]
    assert run["K"] == 4 and set(run["pooled"]) == {"test/loss", "test/loss_cross", "test/corr_cross",
                                                    "test/psnr_cross"}
    for m in report["methods"]:
        pm = run["per_method"][m]
        assert pm["n_frames"] == 5 and 0 <= pm["pred_ssim_mean"] <= 1 and 0 <= pm["gt_ssim_mean"] <= 1
        assert -1 <= pm["frame_corr"] <= 1
    saved = json.loads((tmp_path / "multimethod_report.json").read_text())
    assert "resolved_config" in saved["runs"][0]

    base = multimethod_eval.geometry(True)[4] + ["trainer.accelerator=cpu",
                                                 "logger.test.write.config.vis_img_every_n_steps=-1"]
    root = tmp_path / "corpus" / "gaussian" / "synthmfr"
    assert k_sweep.main([str(root), report["ckpt"]] + base) == 0
    lines = [line for line in capsys.readouterr().out.splitlines() if line.startswith("k_sweep ")]
    assert [line.split(":")[0] for line in lines] == ["k_sweep K=4", "k_sweep K=8", "k_sweep K=16"]
    for line in lines:
        assert " 3 batches -> " in line and "test/loss " in line and line.split("_K")[-1].split(";")[0]
    assert k_sweep.main([]) == 2


def test_method_tree_matches_jax(tmp_path):
    kw = dict(hw=(28, 42), scenes_per_split={"train": 1, "test": 1}, n_train_imgs=2, n_test_imgs=1)
    roots = generate_method_tree(tmp_path / "port", **kw)  # PNGs encoded on several threads
    jax_roots = jax_generate_method_tree(tmp_path / "jax", **kw)
    assert [r.relative_to(tmp_path / "port") for r in roots] == [r.relative_to(tmp_path / "jax") for r in jax_roots]
    files = sorted(p.relative_to(tmp_path / "port") for p in (tmp_path / "port").rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*") if p.is_file())
    for rel in files:
        assert (tmp_path / "port" / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes(), rel


def _gs_logs(root: Path, seed: int) -> None:
    """3DGS-style training logs over 14 scenes (two of them failing the PSNR
    floor), and their gt folders (one too short)."""
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True)
    for f in range(2):
        lines = []
        for s in range(7):
            scene = f"s{f * 7 + s:05d}"
            psnr = 8.0 if scene in ("s00003", "s00011") else float(rng.uniform(12, 30))
            lines += [f"Output folder: ./output/{scene}\n", "Training progress: 0%\n",
                      f"[ITER 7000] Evaluating train: L1 0.0{s} PSNR {psnr}\n"]
            for split in ("train", "test"):
                gt = root / scene / split / "ours_1000" / "gt"
                gt.mkdir(parents=True)
                for i in range(1 if scene == "s00005" and split == "test" else 3):
                    (gt / f"frame_{i:05d}.png").write_bytes(b"")
        (root / f"gs_{f}.log").write_text("".join(lines))


def test_split_builder_matches_jax(tmp_path, capsys):
    _gs_logs(tmp_path / "port", 4)
    shutil.copytree(tmp_path / "port", tmp_path / "jax")
    split_builder.main(["--data_path", str(tmp_path / "port")])
    assert "num_scene_after_all_filtering" in capsys.readouterr().out
    want = jax_split_builder.build_split(tmp_path / "jax")
    got = json.loads((tmp_path / "port" / "split.json").read_text())
    assert got == json.loads((tmp_path / "jax" / "split.json").read_text()) == json.loads(json.dumps(want))
    assert got["stats"]["num_scene_low_psnr"] == 2 and got["stats"]["num_scene_low_length"] == 1
    assert sum(len(got[k]) for k in ("train", "val", "test")) == 11


def _same(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _same(a[k], b[k], f"{path}/{k}")
    elif a is None or isinstance(a, (str, int, float)):
        assert a == b, path
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=path)


def test_debug_vis_matches_jax(tmp_path, monkeypatch, capsys):
    pytest.importorskip("matplotlib")
    monkeypatch.setattr(jax_fastimage, "available", lambda: False)
    monkeypatch.setattr(port_fastimage, "available", lambda: False)
    generate(tmp_path / "datadir", hw=(84, 112), scenes_per_split={"train": 1, "test": 1})
    kw = dict(dataset_path=str(tmp_path / "datadir"), resolution=None, data_split="train",
              neighbour_config={"strategy": "random", "cross": 2, "deterministic": False}, metric_type="ssim",
              metric_min=0, metric_max=1, crop_size=56, crop_mode="dataset_default")
    port_ds, jax_ds = NvsDataset(**kw), JaxNvsDataset(**kw)
    for i in range(3):
        got = debug_vis.debug_item(port_ds, i, np.random.default_rng([1, i]))
        want = jax_debug_vis.debug_item(jax_ds, i, np.random.default_rng([1, i]))
        _same(got, want, f"item {i}")
    argv = [str(tmp_path / "datadir"), "--n-items", "2", "--crop-size", "56", "--cross", "2"]
    debug_vis.main(argv + ["--out", str(tmp_path / "port")])
    jax_debug_vis.main(argv + ["--out", str(tmp_path / "jax")])
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax").iterdir()) == ["item_000.png", "item_001.png"]
    assert capsys.readouterr().out.count("2 debug figures -> ") == 2
