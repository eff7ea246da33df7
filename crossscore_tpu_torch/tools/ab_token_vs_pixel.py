"""Pixel-crop against token-space training quality at matched budgets; the
port's counterpart of ``tools/ab_token_vs_pixel.py``.

Token-space training (``this_main.token_space_train``, ``data/token_train.py``)
departs from the reference in two documented ways: a token's attention
context is the whole image (the reference encodes the crop, reference
``task/core.py:119-161``), and crop offsets are 14 px aligned. This tool asks
whether a token-mode run reaches the same held-out quality as a pixel-mode
run under the same step and lr budget.

Protocol:
- one learnable synthetic corpus (``data/synthetic.py``, ``learnable=True``):
  the ssim target is a deterministic monotone map of a smooth degradation
  field, recoverable from (query, references), so the held-out loss measures
  learning, not noise fitting;
- two ``tasks.train`` runs with the same seed, steps, lr schedule and model,
  each in a child process with a time limit (``ARM_TIMEOUT_S``); the only
  difference is the crop mechanism (both validate on the pixel eval path);
- the report: final and best validation loss and correlation per arm, and
  the sustained ms/step when ``--sustained`` warm-up steps are given.

    python -m crossscore_tpu_torch.tools.ab_token_vs_pixel --out /tmp/ab                           # the card
    python -m crossscore_tpu_torch.tools.ab_token_vs_pixel --preset cpu-tiny --out /tmp/ab_cpu     # the CPU

``gpu-medium`` is the TPU tool's ``tpu-medium`` (dinov2-small at 518 px,
B=24, K=5) on ``trainer.accelerator=cuda``. Both presets turn the figures off
(the card's machine has no matplotlib). The last stdout lines are the report
as indented JSON; ``<out>/ab_report.json`` holds it with each arm's resolved
config and validation curve.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import time
from pathlib import Path

from crossscore_tpu_torch.tasks.train import FIGURES_OFF as NO_FIGURES
from crossscore_tpu_torch.tools._common import done_dir, run_cli

# the TPU tool's logger overrides, and no validation figure
FIGURES_OFF = [*NO_FIGURES, "logger.vis_histogram_every_n_train_steps=100000"]

# arm-invariant overrides; the corpus keeps crop <= the trimmed image in both
# modes (token mode trims full images to whole patches first)
PRESETS = {
    # the tiny dinov2-test model on the CPU
    "cpu-tiny": dict(
        accel="cpu",
        hw=(112, 140),
        scenes=(4, 2, 1),
        n_train=6,
        n_test=4,
        base=[
            "model.gpu.compute_dtype=float32",
            "model.backbone.preset=dinov2-test",
            "data.neighbour_config.cross=2",
            "data.loader.train.batch_size=4",
            "data.loader.validation.batch_size=4",
            "data.transforms.crop_size=84",
            "this_main.resize_short_side=-1",
            "trainer.max_epochs=80",
            "trainer.optimizer.lr=1e-3",
            "trainer.num_sanity_val_steps=0",
        ] + FIGURES_OFF,
    ),
    # dinov2-small at the production shapes on the card; the corpus matches
    # the reference's res_540 geometry (540x720, crop 518)
    "gpu-medium": dict(
        accel="cuda",
        hw=(540, 720),
        scenes=(6, 2, 1),
        n_train=10,
        n_test=6,
        base=[
            "model.backbone.preset=dinov2-small",
            "data.neighbour_config.cross=5",
            "data.loader.train.batch_size=24",
            "data.loader.validation.batch_size=24",
            "data.transforms.crop_size=518",
            "this_main.resize_short_side=-1",
            "trainer.max_epochs=80",
            "trainer.max_steps=300",
            "trainer.optimizer.lr=3e-4",
            "trainer.num_sanity_val_steps=0",
            "trainer.limit_val_batches=6",
            # an epoch is ~4 steps on this corpus: validate every 4th
            "trainer.check_val_every_n_epoch=4",
        ] + FIGURES_OFF,
    ),
}


def ensure_corpus(root: Path, preset: dict, pack_records: bool) -> list[str]:
    """Generate the learnable corpus (and, with ``pack_records``, decoded
    record shards beside it); return the dataset overrides."""
    if not (root / "res_540" / "split.json").exists():
        from crossscore_tpu_torch.data.synthetic import generate

        t0 = time.time()
        generate(root, hw=preset["hw"],
                 scenes_per_split={"train": preset["scenes"][0], "val": preset["scenes"][1],
                                   "test": preset["scenes"][2]},
                 n_train_imgs=preset["n_train"], n_test_imgs=preset["n_test"], learnable=True)
        print(f"corpus generated in {time.time() - t0:.0f}s -> {root}")
    overrides = [f"data.dataset.path=[{root}]"]
    if pack_records:
        # a sibling of the dataset root: the dataset walks res_* under the root
        rec = root.with_name(root.name + "_records")
        if not (rec / "index.npz").exists():
            from crossscore_tpu_torch.data.records import pack

            t0 = time.time()
            pack(root, rec, shard_mb=512, decoded=True, verbose=False)
            print(f"decoded record shards packed in {time.time() - t0:.0f}s -> {rec}")
        overrides.append(f"data.dataset.record_dir={rec}")
    return overrides


# an arm's time limit: a hung run is killed and recorded, and the session
# goes on
ARM_TIMEOUT_S = 5400


def run_arm(name: str, out_dir: Path, overrides: list[str], accel: str, timeout_s: float) -> dict:
    """One ``tasks.train`` arm in a child process (the last 2000 characters
    of its output echoed); read its run dir and metrics."""
    argv = [f"trainer.accelerator={accel}", f"run.dir={out_dir}", f"alias={name}"] + overrides
    print(f"[{name}] crossscore_tpu_torch.tasks.train {' '.join(argv)}", flush=True)
    t0 = time.time()
    stdout = run_cli("train", argv, out_dir, timeout=timeout_s)
    wall = time.time() - t0
    run_dir = done_dir(stdout, "train", out_dir)
    rows = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    # the verbatim overrides and the composed config the run saved, so that
    # the artifact says what it ran
    res = {"arm": name, "steps": int(re.search(r"train done: (\d+) steps", stdout).group(1)),
           "wall_s": round(wall, 1), "cli_overrides": ["crossscore_tpu_torch.tasks.train"] + argv,
           "run_dir": str(run_dir)}
    snap = run_dir / "config.yaml"
    if snap.exists():
        import yaml

        res["resolved_config"] = yaml.safe_load(snap.read_text())
    sus = [r for r in rows if "train/sustained_ms_per_step" in r]
    if sus:
        res["sustained_ms_per_step"] = round(sus[-1]["train/sustained_ms_per_step"], 1)
        res["sustained_steps"] = int(sus[-1]["train/sustained_steps"])
    vals = [row for row in rows if "validation/loss" in row]
    if vals:
        res["final_val_loss"] = vals[-1]["validation/loss"]
        res["final_val_corr"] = vals[-1]["validation/correlation_cross"]
        res["best_val_loss"] = min(v["validation/loss"] for v in vals)
        res["best_val_corr"] = max(v["validation/correlation_cross"] for v in vals)
        res["val_curve"] = [(v["step"], round(v["validation/loss"], 5)) for v in vals]
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--preset", choices=PRESETS, default="gpu-medium")
    ap.add_argument("--out", default="/tmp/ab_token_vs_pixel")
    ap.add_argument("--data", default=None, help="corpus root (default <out>/data)")
    ap.add_argument("--records", action="store_true", help="pack, and train from, decoded record shards")
    ap.add_argument("--sustained", type=int, default=0, help="warm-up steps before the sustained-timing window")
    ap.add_argument("--arm", choices=["pixel", "token", "both"], default="both")
    ap.add_argument("--extra", action="append", default=[],
                    help="a dotted override appended to both arms (e.g. trainer.max_steps=150)")
    ap.add_argument("--seeds", default=None,
                    help="comma-separated seeds (e.g. 1,2,3): every arm once per seed, with the mean and "
                         "spread per arm")
    args = ap.parse_args(argv)

    preset = PRESETS[args.preset]
    out = Path(args.out).resolve()
    out.mkdir(parents=True, exist_ok=True)
    data_root = Path(args.data).resolve() if args.data else out / "data"
    base = preset["base"] + ensure_corpus(data_root, preset, args.records) + list(args.extra)
    if args.sustained:
        base = base + [f"this_main.sustained_report_after_steps={args.sustained}"]
    seeds = [int(s) for s in args.seeds.split(",")] if args.seeds else [None]
    results = []

    def _arm(name, overrides, arm, seed):
        """A failed or hung arm is recorded and the session goes on."""
        try:
            r = run_arm(name, out, overrides, preset["accel"], ARM_TIMEOUT_S)
        except Exception as e:
            r = {"arm": arm, "error": f"{type(e).__name__}: {e}"[:300]}
            print(f"[{name}] FAILED: {r['error']}", flush=True)
        r["arm"], r["seed"] = arm, seed
        results.append(r)
        (out / "ab_report_partial.json").write_text(json.dumps(results, indent=2))

    for seed in seeds:
        seed_ov = [] if seed is None else [f"seed={seed}"]
        tag = "" if seed is None else f"_s{seed}"
        if args.arm in ("pixel", "both"):
            _arm(f"pixel{tag}", base + seed_ov, "pixel", seed)
        if args.arm in ("token", "both"):
            _arm(f"token{tag}", base + seed_ov + ["this_main.token_space_train=true"], "token", seed)

    report = {"preset": args.preset, "records": args.records, "seeds": seeds if args.seeds else None,
              "arms": results}
    if args.seeds and len(seeds) > 1:
        import statistics as st

        agg = {}
        for arm in ("pixel", "token"):
            rows = [r for r in results if r["arm"] == arm and "final_val_loss" in r]
            if len(rows) >= 2:
                agg[arm] = {k: {"mean": round(st.mean(r[k] for r in rows), 5),
                                "stdev": round(st.stdev(r[k] for r in rows), 5),
                                "values": [round(r[k], 5) for r in rows]}
                            for k in ("final_val_loss", "final_val_corr", "best_val_loss", "best_val_corr")}
        report["aggregate"] = agg
    (out / "ab_report.json").write_text(json.dumps(report, indent=2))
    print(json.dumps({k: v for k, v in report.items() if k != "arms"}
                     | {"arms": [{k2: v2 for k2, v2 in r.items() if k2 not in ("resolved_config", "val_curve")}
                                 for r in report["arms"]]}, indent=2))
    return 1 if any("error" in r for r in results) else 0


if __name__ == "__main__":
    sys.exit(main())
