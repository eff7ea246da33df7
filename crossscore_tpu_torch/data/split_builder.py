"""Split-builder CLI: train/val/test scene splits from 3DGS training logs; the
port's own copy of ``crossscore_tpu/data/split_builder.py`` (the same
``split.json`` from the same logs).

Parity with reference ``utils/data_processing/split_gaussian_processed.py:32-134``:
parses ``*.log`` files for scene names ("Output folder: .../<scene>") and their
ITER-7000 train PSNR, filters scenes with PSNR < min_psnr or fewer than
min_seq_len images, shuffles (seed 1234) and splits by ratio into
``split.json`` (with a ``stats`` block).

CLI: ``python -m crossscore_tpu_torch.data.split_builder --data_path <res_dir>``
"""

from __future__ import annotations

import argparse
import json
import os
from pathlib import Path
from pprint import pprint

import numpy as np


def split_list_by_ratio(list_input, ratio_dict: dict) -> dict:
    if not 0.999 < sum(ratio_dict.values()) < 1.001:
        raise ValueError("The sum of the ratios must be close to 1")
    total = len(list_input)
    lengths = {k: int(v * total) for k, v in ratio_dict.items()}
    last = list(ratio_dict.keys())[-1]
    lengths[last] = total - sum(lengths.values()) + lengths[last]
    out, start = {}, 0
    for name, length in lengths.items():
        out[name] = [str(s) for s in list_input[start : start + length]]
        start += length
    return out


def parse_gs_logs(data_path: Path, min_psnr: float) -> tuple[list[str], dict]:
    """Scene list + low-PSNR scenes from gaussian-splatting training logs."""
    scene_all: list[str] = []
    scene_low_psnr: dict[str, float] = {}
    scene_name = None
    for log_f in sorted(f for f in os.listdir(data_path) if f.endswith(".log")):
        with open(data_path / log_f) as f:
            for line in f:
                if "Output folder" in line:
                    scene_name = line.split("Output folder: ")[1].split("/")[-1].rstrip("\n")
                elif "[ITER 7000] Evaluating train" in line and scene_name is not None:
                    psnr = float(line.split("PSNR ")[1].rstrip("\n"))
                    scene_all.append(scene_name)
                    if psnr < min_psnr:
                        scene_low_psnr[scene_name] = psnr
    return scene_all, scene_low_psnr


def build_split(
    data_path: str | Path,
    min_seq_len: int = 2,
    min_psnr: float = 10.0,
    split_ratio=(0.8, 0.1, 0.1),
    seed: int = 1234,
) -> dict:
    data_path = Path(data_path).expanduser()
    scene_all, scene_low_psnr = parse_gs_logs(data_path, min_psnr)

    scene_low_length: dict[str, int] = {}
    for scene in scene_all:
        for gs_split in ("train", "test"):
            gt_dir = data_path / scene / gs_split / "ours_1000" / "gt"
            n = len(os.listdir(gt_dir)) if gt_dir.exists() else 0
            if n < min_seq_len:
                scene_low_length[scene] = n

    n_total = len(scene_all)
    scene_all = [s for s in scene_all if s not in scene_low_psnr]
    n_after_psnr = len(scene_all)
    scene_all = [s for s in scene_all if s not in scene_low_length]
    n_after_len = len(scene_all)

    rng = np.random.RandomState(seed)
    scene_all = rng.permutation(scene_all)
    ratio = {"train": split_ratio[0], "val": split_ratio[1], "test": split_ratio[2]}
    splits = split_list_by_ratio(scene_all, ratio)

    stats = {
        "min_psnr": min_psnr,
        "min_seq_len": min_seq_len,
        "split_ratio": list(split_ratio),
        "num_scene_total_after_gaussian": n_total,
        "num_scene_low_psnr": len(scene_low_psnr),
        "num_scene_low_length": len(scene_low_length),
        "num_scene_total_filtered_low_psnr": n_after_psnr,
        "num_scene_total_filtered_low_length": n_after_len,
        "num_scene_after_all_filtering": n_after_len,
        "num_scene_train": len(splits["train"]),
        "num_scene_val": len(splits["val"]),
        "num_scene_test": len(splits["test"]),
        "num_scene_after_split": sum(len(v) for v in splits.values()),
    }
    out = {"stats": stats, **splits}
    with open(data_path / "split.json", "w") as f:
        json.dump(out, f, indent=2)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description="Build train/val/test scene splits")
    ap.add_argument("--data_path", type=str, required=True)
    ap.add_argument("--min_seq_len", type=int, default=2)
    ap.add_argument("--min_psnr", type=float, default=10.0)
    ap.add_argument("--split_ratio", nargs="+", type=float, default=[0.8, 0.1, 0.1])
    args = ap.parse_args(argv)
    out = build_split(args.data_path, args.min_seq_len, args.min_psnr, tuple(args.split_ratio))
    pprint(out["stats"], sort_dicts=False)


if __name__ == "__main__":
    main()
