"""The multi-method evaluation workflow at production geometry (BASELINE
config #4); the port's counterpart of ``tools/multimethod_eval.py``.

The reference's headline evaluation is a K sweep over a ConcatDataset of
several NVS-method roots, summarised per (dataset, method) (reference
``utils/io/score_summariser.py:241-250``, ``dataloading/data_manager.py:8-41``).
This tool runs it end to end:

1. build a learnable corpus of three "method" roots, one degradation process
   each (``data/synthetic.py::generate_method_tree``);
2. train briefly on the multi-root dataset through ``tasks.train`` (every
   CLI runs in a child process, as the TPU tool runs them);
3. run ``tasks.test`` at K in ``--ks`` (4, 8, 16) over the test split;
4. summarise the ground truth (``tasks.summarise_score_gt``) and write
   ``<out>/multimethod_report.json``: per K and method the predicted and GT
   means, the per-frame correlation and the pooled metrics, with the
   resolved configs; the last stdout lines are the report without them, as
   indented JSON.

    python -m crossscore_tpu_torch.tools.multimethod_eval --out /tmp/mm_eval              # the card
    python -m crossscore_tpu_torch.tools.multimethod_eval --out /tmp/mm --accel cpu --tiny

Figures are off in every run (the card's machine has no matplotlib).
"""

from __future__ import annotations

import argparse
import csv
import json
import sys
import time
from pathlib import Path

import numpy as np

from crossscore_tpu_torch.tools._common import done_dir, run_cli
from crossscore_tpu_torch.tools.ab_token_vs_pixel import FIGURES_OFF

METHODS = ("gaussian", "tensorf", "nerfacto")
DATASET = "synthmfr"
TEST_FIGURES_OFF = "logger.test.write.config.vis_img_every_n_steps=-1"


def cli(task: str, argv: list[str], cwd: Path):
    """``python -m crossscore_tpu_torch.tasks.<task> argv`` in a child process
    in ``cwd`` -> the output dir the train and test CLIs name, absolute."""
    print(f"$ python -m crossscore_tpu_torch.tasks.{task} {' '.join(argv)}", flush=True)
    stdout = run_cli(task, argv, cwd, tail=1500)
    return done_dir(stdout, task, cwd) if task in ("train", "test") else None


def read_csv(path: Path) -> list[dict]:
    with open(path) as f:
        return list(csv.DictReader(f))


def geometry(tiny: bool) -> tuple:
    """(hw, scenes per split, train images, test images, base overrides)."""
    if tiny:
        return (112, 140), (1, 1, 1), 3, 2, [
            "model.gpu.compute_dtype=float32",
            "model.backbone.preset=dinov2-test",
            "data.loader.train.batch_size=2",
            "data.loader.validation.batch_size=2",
            "data.loader.train.num_workers=2",
            "data.loader.validation.num_workers=2",
            "data.transforms.crop_size=84",
            "this_main.resize_short_side=-1",
        ]
    return (540, 720), (2, 1, 1), 6, 4, [
        "model.backbone.preset=dinov2-small",
        "data.loader.train.batch_size=24",
        "data.loader.validation.batch_size=2",
        "data.loader.train.num_workers=4",
        "data.loader.validation.num_workers=2",
        "data.transforms.crop_size=518",
        "this_main.resize_short_side=-1",
        # the uint8 wire: the production train path
        "data.dataset.wire_uint8=true",
    ]


def ensure_corpus(out: Path, tiny: bool) -> list[Path]:
    """The three method roots under ``<out>/corpus``, generated once."""
    hw, scenes, n_tr, n_te, _ = geometry(tiny)
    corpus = out / "corpus"
    if not (corpus / METHODS[0] / DATASET / "res_540" / "split.json").exists():
        from crossscore_tpu_torch.data.synthetic import generate_method_tree

        t0 = time.time()
        generate_method_tree(corpus, methods=METHODS, dataset_name=DATASET, hw=hw,
                             scenes_per_split={"train": scenes[0], "val": scenes[1], "test": scenes[2]},
                             n_train_imgs=n_tr, n_test_imgs=n_te)
        print(f"corpus generated in {time.time() - t0:.0f}s -> {corpus}")
    return [corpus / m / DATASET for m in METHODS]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="/tmp/mm_eval")
    ap.add_argument("--accel", default="cuda")
    ap.add_argument("--tiny", action="store_true", help="dinov2-test geometry for a CPU run")
    ap.add_argument("--ks", default="4,8,16")
    ap.add_argument("--train-steps", type=int, default=150)
    ap.add_argument("--ckpt", default=None, help="skip the training stage, evaluate this checkpoint")
    args = ap.parse_args(argv)

    out = Path(args.out).resolve()
    out.mkdir(parents=True, exist_ok=True)
    ks = [int(k) for k in args.ks.split(",")]
    base = geometry(args.tiny)[4]

    # 1. corpus
    roots = ensure_corpus(out, args.tiny)
    path_ov = f"data.dataset.path=[{','.join(str(r) for r in roots)}]"

    # 2. a short train over the multi-root dataset
    ckpt = args.ckpt
    if ckpt is None:
        run_dir = cli("train", [f"trainer.accelerator={args.accel}", f"run.dir={out}", "alias=mmtrain", path_ov,
                                f"trainer.max_steps={args.train_steps}", "trainer.max_epochs=1000",
                                "trainer.optimizer.lr=3e-4", "trainer.num_sanity_val_steps=0",
                                "trainer.limit_val_batches=0"] + FIGURES_OFF + base, out)
        ckpt = str(run_dir / "ckpt")

    # 3. the K sweep
    report = {"dataset": DATASET, "methods": list(METHODS), "ckpt": ckpt, "runs": []}
    for k in ks:
        # no run.dir: the test config puts its out dir beside the checkpoint
        test_dir = cli("test", [f"trainer.accelerator={args.accel}", f"alias=mmtest_k{k}", path_ov,
                                f"trainer.ckpt_path_to_load={ckpt}", f"data.neighbour_config.cross={k}",
                                "this_main.force_batch_size=true", TEST_FIGURES_OFF] + base, out)
        run = {"K": k, "test_dir": str(test_dir), "per_method": {}}
        snap = test_dir / "config.yaml"
        if snap.exists():
            import yaml

            run["resolved_config"] = yaml.safe_load(snap.read_text())
        rows = read_csv(test_dir / "metrics.csv")
        run["pooled"] = {kk: float(v) for kk, v in rows[-1].items() if kk != "batch_idx"}
        for m in METHODS:
            pred = read_csv(test_dir / "score_summary" / DATASET / f"{m}.csv")
            run["per_method"][m] = {"n_frames": len(pred),
                                    "pred_ssim_mean": round(float(np.mean([float(r["pred_ssim_0_1"])
                                                                           for r in pred])), 4)}
        report["runs"].append(run)

    # 4. GT summaries and the per-frame correlation
    gt_dir = out / "gt_summary"
    for m, root in zip(METHODS, roots):
        cli("summarise_score_gt", ["--dir_in", str(root / "res_540"), "--dir_out", str(gt_dir), "-n", "4", "-f"],
            out)
    key = ("scene_name", "rendered_dir", "image_name")
    gt = {m: {tuple(r[c] for c in key): float(r["gt_ssim_0_1"])
              for r in read_csv(gt_dir / DATASET / f"{m}.csv")} for m in METHODS}
    for run in report["runs"]:
        for m in METHODS:
            pairs = [(float(r["pred_ssim_0_1"]), gt[m][tuple(r[c] for c in key)])
                     for r in read_csv(Path(run["test_dir"]) / "score_summary" / DATASET / f"{m}.csv")
                     if tuple(r[c] for c in key) in gt[m]]
            pm = run["per_method"][m]
            pm["gt_ssim_mean"] = round(float(np.mean([g for _, g in pairs])), 4)
            if len(pairs) >= 3:
                p, g = np.asarray(pairs).T
                pm["frame_corr"] = round(float(np.corrcoef(p, g)[0, 1]), 4)

    (out / "multimethod_report.json").write_text(json.dumps(report, indent=2))
    slim = {k: v for k, v in report.items() if k != "runs"}
    slim["runs"] = [{k2: v2 for k2, v2 in r.items() if k2 != "resolved_config"} for r in report["runs"]]
    print(json.dumps(slim, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
