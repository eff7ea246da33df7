"""One-batch overfit through the train CLI; the port's counterpart of
``tools/overfit_convergence.py``.

Overfits one batch (B=4, K=2, 224 px crops, bf16, deterministic crops: the
reference's ``overfit_batches`` mode, ``config/default.yaml:27`` and
``task/train.py:61,66``) from decoded record shards of a seeded 540x720
synthetic corpus, until the train-batch correlation passes ``--min-corr``
(0.95) and the L1 loss nears its floor: the whole gradient path (K1-K4, the
masked AdamW, StepLR) trains, not only runs. It prints the logged steps, the
final and best correlation and the ms a step (the median gap between the
logged steps: the loader, the step and the logging, wall clock).

    python -m crossscore_tpu_torch.tools.overfit_convergence [steps] [workdir] [crop]
    python -m crossscore_tpu_torch.tools.overfit_convergence 3 /tmp/ow 56 --cpu --hw 84 112 --min-corr -1

``--cpu`` runs the plain versions on the CPU with the tiny ``dinov2-test``
preset in fp32 (tests). Exits 1 below ``--min-corr``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

CPU_OVERRIDES = ["trainer.accelerator=cpu", "model.gpu.compute_dtype=float32",
                 "model.backbone.preset=dinov2-test"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Overfit one batch through the train CLI.")
    ap.add_argument("steps", nargs="?", type=int, default=300)
    ap.add_argument("workdir", nargs="?", default="/tmp/overfit_ws")
    ap.add_argument("crop", nargs="?", type=int, default=224)
    ap.add_argument("--cpu", action="store_true", help="the plain versions on the CPU, dinov2-test, fp32")
    ap.add_argument("--hw", type=int, nargs=2, default=(540, 720), help="the corpus's image size")
    ap.add_argument("--min-corr", type=float, default=0.95, help="the correlation the run must pass")
    args = ap.parse_args(argv)
    workdir = Path(args.workdir).resolve()
    workdir.mkdir(parents=True, exist_ok=True)

    from crossscore_tpu_torch.data.records import pack
    from crossscore_tpu_torch.data.synthetic import generate

    data = workdir / "datadir"
    if not (data / "res_540" / "split.json").exists():
        # 2 train scenes x (8 gs_train + 4 gs_test) = 24 query items
        generate(data, hw=tuple(args.hw), scenes_per_split={"train": 2, "val": 1, "test": 1},
                 n_train_imgs=8, n_test_imgs=4)
    if not (workdir / "decoded" / "index.npz").exists():
        # decoded shards keep PNG inflation of the noise images out of the loop
        pack(data, workdir / "decoded", shard_mb=512, verbose=False, decoded=True)

    from crossscore_tpu_torch.tasks.train import FIGURES_OFF, main as train_main

    old = os.getcwd()
    os.chdir(workdir)
    try:
        run_dir = train_main([
            "data.dataset.path=[datadir]",
            f"data.dataset.record_dir={workdir / 'decoded'}",
            "data.loader.train.batch_size=4",
            "data.loader.train.num_workers=4",
            "data.loader.validation.batch_size=4",
            "data.loader.validation.num_workers=1",
            "data.neighbour_config.cross=2",
            f"data.transforms.crop_size={args.crop}",
            "this_main.resize_short_side=-1",
            "trainer.overfit_batches=1",
            f"trainer.max_epochs={args.steps}",
            "trainer.num_sanity_val_steps=0",
            "trainer.limit_val_batches=0",
            # 1e-3 oscillates with the 12-layer random frozen backbone; 3e-4 converges
            "trainer.optimizer.lr=3e-4",
            "trainer.lr_scheduler.step_size=1000",  # a flat lr over the run
            # a trainable multi-view PE gives per-position capacity: without it
            # the random frozen backbone's features cap memorisation
            "model.pos_enc.multi_view.req_grad=true",
            # unclamped ssim targets ([-1, 1], tanh head): the min=0 clamp
            # flattens half of each synthetic map to 0
            "model.predict.metric.min=-1",
            "logger.vis_scalar_every_n_train_steps=1",
            "logger.vis_histogram_every_n_train_steps=100000",
            *FIGURES_OFF,
            "alias=overfit",
        ] + (CPU_OVERRIDES if args.cpu else []))
    finally:
        os.chdir(old)
    run_dir = workdir / run_dir if not run_dir.is_absolute() else run_dir

    rows = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    tr = [(r["step"], r["train/loss_cross"], r["train/correlation_cross"], r["time"])
          for r in rows if "train/correlation_cross" in r]
    print(f"steps logged: {len(tr)}")
    for s, loss, corr, _ in tr[:: max(1, len(tr) // 12)]:
        print(f"  step {s:4d}: L1 {loss:.4f}  corr {corr:.4f}")
    best = max(c for _, _, c, _ in tr)
    final = tr[-1]
    print(f"final: step {final[0]} L1 {final[1]:.4f} corr {final[2]:.4f} (best corr {best:.4f})")
    gaps = sorted(1e3 * (b[3] - a[3]) for a, b in zip(tr, tr[1:]))
    if gaps:
        print(f"ms/step: {gaps[len(gaps) // 2]:.2f} (median of {len(gaps)} gaps between logged steps, "
              "wall clock, loader in the loop)")
    if best <= args.min_corr:
        print(f"did not converge: best corr {best:.4f} <= {args.min_corr}", file=sys.stderr)
        return 1
    print(f"CONVERGED: correlation > {args.min_corr} on the overfit batch")
    return 0


if __name__ == "__main__":
    sys.exit(main())
