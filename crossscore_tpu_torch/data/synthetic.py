"""Synthetic NVS dataset generator (tests, demos, pipeline benchmarks); the
port's own copy of ``crossscore_tpu/data/synthetic.py`` (the same arrays for
the same seed).

Produces the exact directory layout the reference's preprocessing emits
(reference ``dataloading/dataset/nvs_dataset.py:321-426``):

    <root>/<res>/split.json
    <root>/<res>/<scene>/{train,test}/ours_<iter>/renders/frame_XXXXX.png
    <root>/<res>/<scene>/{train,test}/ours_<iter>/gt/frame_XXXXX.png
    <root>/<res>/<scene>/{train,test}/ours_<iter>/metric_map/{ssim,mae}/frame_XXXXX.png

Renders are GT plus noise; metric maps are smooth random fields written with
the uint16 codec. CLI: ``python -m crossscore_tpu_torch.data.synthetic <root> [--hw 84 112]``.

``learnable=True`` makes the supervision a RECOVERABLE function of the inputs
so training-quality A/Bs (pixel-crop vs token-space) measure learning, not
noise-fitting: each scene has one textured base image, frames are cyclic
rolls of it (stand-in "viewpoints" whose content cross-references exactly),
renders are degraded by a smooth spatially-varying noise field sigma(x, y),
and the ssim target is a deterministic monotone map of sigma. A model can
estimate sigma locally from the query and sharpen the estimate against the
clean reference views — exactly the reference task's structure
(reference ``README.md:1-4``: score a render against unaligned real captures).

The arrays are drawn in order from one seeded stream; the PNG files are
encoded on up to 8 threads (Pillow's encoder releases the GIL), the same
bytes as one thread's. :func:`generate_method_tree` writes the
multi-method layout of the JAX package's ``generate_method_tree``.
"""

from __future__ import annotations

import json
import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from crossscore_tpu_torch.io.images import image_write, metric_map_write


def _smooth_field(rng: np.random.Generator, hw: tuple, grid: tuple) -> np.ndarray:
    """Piecewise-constant random field in [0, 1] on a coarse grid, upsampled
    to (H, W) — the cheap stand-in for smooth spatial structure."""
    coarse = rng.random(grid).astype(np.float32)
    reps = (hw[0] // grid[0] + 1, hw[1] // grid[1] + 1)
    return np.kron(coarse, np.ones(reps, np.float32))[: hw[0], : hw[1]]


def _box_blur(img: np.ndarray, iters: int = 3) -> np.ndarray:
    """Cheap separable 3x3 blur (edge-replicated), iterated."""
    out = img
    for _ in range(iters):
        p = np.pad(out, ((1, 1), (1, 1), (0, 0)), mode="edge")
        out = (p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:]
               + p[1:-1, 1:-1]) / 5.0
    return out


# Distinct degradation processes for multi-"method" corpora (the reference
# evaluates several NVS methods — gaussian / tensorf / nerfacto — over the
# same scenes and summarises per (dataset, method),
# reference ``utils/io/score_summariser.py:241-250``). Each process has its
# own visual signature AND its own score scale, so per-method summary CSVs
# rank distinctly: (degrade_fn(gt, field, rng) -> render, score_fn(field)).
DEGRADATIONS = {
    # additive noise, amplitude field (the r4 learnable default)
    "gauss": (
        lambda gt, f, rng: np.clip(
            gt + (0.4 * f)[..., None] * rng.normal(0, 1, gt.shape), 0, 1
        ).astype(np.float32),
        lambda f: (1.0 - 1.6 * f).astype(np.float32),
    ),
    # spatially-varying blur: blend toward a blurred copy by the field
    "blur": (
        lambda gt, f, rng: (
            (1.0 - f[..., None]) * gt + f[..., None] * _box_blur(gt)
        ).astype(np.float32),
        lambda f: (1.0 - 0.9 * f).astype(np.float32),
    ),
    # posterisation: fewer quantisation levels where the field is high
    "quant": (
        lambda gt, f, rng: (
            np.round(gt * (2 + 14 * (1 - f))[..., None])
            / (2 + 14 * (1 - f))[..., None]
        ).astype(np.float32),
        lambda f: (1.0 - 0.5 * f).astype(np.float32),
    ),
}


class _Writes:
    """File writes on a thread pool, at most ``4 * workers`` in flight (each
    holds its image); inline with one worker."""

    def __init__(self, workers: int):
        self.workers = max(1, workers)
        self.pool = ThreadPoolExecutor(self.workers) if self.workers > 1 else None
        self.pending: deque = deque()

    def __call__(self, fn, *args) -> None:
        if self.pool is None:
            fn(*args)
            return
        self.pending.append(self.pool.submit(fn, *args))
        while len(self.pending) > 4 * self.workers:
            self.pending.popleft().result()

    def close(self) -> None:
        if self.pool is not None:
            while self.pending:
                self.pending.popleft().result()
            self.pool.shutdown()


def generate(
    root: str | Path,
    resolution: str = "res_540",
    scenes_per_split: dict | None = None,
    n_train_imgs: int = 4,
    n_test_imgs: int = 3,
    iters: tuple = (1000,),
    hw: tuple = (84, 112),
    seed: int = 0,
    learnable: bool = False,
    degradation: str = "gauss",
) -> Path:
    scenes_per_split = scenes_per_split or {"train": 2, "val": 1, "test": 1}
    write = _Writes(min(8, os.cpu_count() or 1))
    root = Path(root)
    res_dir = root / resolution
    res_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)

    # hw: one (H, W) for all scenes, or a list cycled per scene (mixed-aspect
    # datasets for shape-bucketing tests)
    hw_list = [tuple(hw)] if isinstance(hw[0], int) else [tuple(x) for x in hw]

    split_json: dict[str, list[str]] = {}
    scene_id = 0
    for split, count in scenes_per_split.items():
        split_json[split] = []
        for _ in range(count):
            scene = f"s{scene_id:05d}"
            hw = hw_list[scene_id % len(hw_list)]
            scene_id += 1
            split_json[split].append(scene)
            if learnable:
                # one textured base per scene: coarse structure + fine
                # texture, so token patches are matchable across "views"
                base_img = (
                    0.6 * np.stack([_smooth_field(rng, hw, (9, 12)) for _ in range(3)], -1)
                    + 0.4 * rng.random((*hw, 3)).astype(np.float32)
                )
            for gs_split, n_imgs in (("train", n_train_imgs), ("test", n_test_imgs)):
                for it in iters:
                    base = res_dir / scene / gs_split / f"ours_{it}"
                    for sub in ("renders", "gt", "metric_map/ssim", "metric_map/mae"):
                        (base / sub).mkdir(parents=True, exist_ok=True)
                    for i in range(n_imgs):
                        name = f"frame_{i:05d}.png"
                        if learnable:
                            # "viewpoint" = cyclic roll of the scene base;
                            # gs_train and gs_test frames roll differently so
                            # cross-references are unaligned but same-content
                            off = (17 * i + (251 if gs_split == "test" else 0),
                                   31 * i + (83 if gs_split == "test" else 0))
                            gt = np.roll(base_img, off, axis=(0, 1))
                            # smooth degradation field; the render and the
                            # ssim target both derive from it via the chosen
                            # DEGRADATIONS process — supervision stays a
                            # deterministic monotone map of the field,
                            # recoverable from (query, references)
                            degrade_fn, score_fn = DEGRADATIONS[degradation]
                            field = _smooth_field(rng, hw, (7, 9))
                            render = degrade_fn(gt, field, rng)
                            ssim = score_fn(field)
                        else:
                            gt = rng.random((*hw, 3)).astype(np.float32)
                            render = np.clip(
                                gt + rng.normal(0, 0.08, gt.shape), 0, 1
                            ).astype(np.float32)
                            # smooth random metric maps
                            ssim = _smooth_field(rng, hw, (6, 8)) * 1.6 - 0.8
                        mae = np.abs(render - gt).mean(-1)

                        write(image_write, base / "renders" / name, render)
                        write(image_write, base / "gt" / name, gt)
                        write(metric_map_write, base / "metric_map/ssim" / name, ssim, [-1, 1])
                        write(metric_map_write, base / "metric_map/mae" / name, mae, [0, 1])
    write.close()

    with open(res_dir / "split.json", "w") as f:
        json.dump(split_json, f, indent=2)
    return root


def generate_method_tree(
    root: str | Path,
    methods: tuple = ("gaussian", "tensorf", "nerfacto"),
    dataset_name: str = "synthmfr",
    seed: int = 0,
    **kw,
) -> list[Path]:
    """A multi-method corpus in the reference's processed-tree layout
    ``<root>/<method>/<dataset>/res_*``, which the summariser's (dataset,
    method) grouping parses from item paths (reference
    ``utils/io/score_summariser.py:170-195``). Each method gets its own
    degradation process (``DEGRADATIONS``) with its own score scale, so the
    per-(dataset, method) summaries rank apart. Returns the method roots,
    for ``data.dataset.path=[...]``."""
    degr = list(DEGRADATIONS)
    roots = []
    for i, m in enumerate(methods):
        r = Path(root) / m / dataset_name
        generate(r, seed=seed, degradation=degr[i % len(degr)], learnable=True, **kw)
        roots.append(r)
    return roots


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description="Generate a synthetic NVS dataset tree")
    ap.add_argument("root")
    ap.add_argument("--resolution", default="res_540")
    ap.add_argument("--hw", type=int, nargs=2, default=(84, 112))
    ap.add_argument("--train-imgs", type=int, default=4)
    ap.add_argument("--test-imgs", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--learnable", action="store_true",
                    help="supervision is a recoverable function of the "
                         "inputs (training-quality A/Bs)")
    ap.add_argument("--scenes", type=int, nargs=3, metavar=("TRAIN", "VAL", "TEST"),
                    default=None, help="scenes per split")
    ap.add_argument("--degradation", choices=sorted(DEGRADATIONS), default="gauss",
                    help="degradation process for --learnable renders")
    args = ap.parse_args(argv)
    scenes = None
    if args.scenes is not None:
        scenes = {"train": args.scenes[0], "val": args.scenes[1], "test": args.scenes[2]}
    path = generate(
        args.root,
        resolution=args.resolution,
        scenes_per_split=scenes,
        hw=tuple(args.hw),
        n_train_imgs=args.train_imgs,
        n_test_imgs=args.test_imgs,
        seed=args.seed,
        learnable=args.learnable,
        degradation=args.degradation,
    )
    print(f"Synthetic dataset written to {path}")


if __name__ == "__main__":
    main()
