"""Per-frame score summaries (online, written by test and predict), the GT
score summary (offline) and its reader; the port's own copy of
``crossscore_tpu/io/summariser.py``.

Parity with reference ``utils/io/score_summariser.py:16-315``: identical CSV
layouts (columns, float format, path-derived scene/method/dataset grouping) so
the reference's downstream analysis keeps working.
"""

from __future__ import annotations

import os
from glob import glob
from pathlib import Path

import numpy as np
import pandas as pd
from pandas import DataFrame

from crossscore_tpu_torch.io.images import metric_map_read


def _metric_type_str(metric_type: str, metric_min) -> str:
    if metric_type == "ssim":
        return "ssim_-1_1" if metric_min == -1 else "ssim_0_1"
    return str(metric_type)


class SummaryWriterPredictedOnline:
    """Accumulates per-frame mean predicted scores during fit/test/predict."""

    def __init__(self, metric_type: str, metric_min):
        self.columns = [
            "scene_name",
            "rendered_dir",
            "image_name",
            f"pred_{_metric_type_str(metric_type, metric_min)}",
        ]
        self.reset()

    def reset(self):
        self.rows = DataFrame(columns=self.columns)

    def update(self, batch_input: dict, batch_output: dict):
        n_valid = int(batch_input.get("_valid", len(batch_input["item_paths"]["query/img"])))
        query_img_paths = batch_input["item_paths"]["query/img"][:n_valid]
        ref_types = [t for t in batch_output if t.startswith("score_map")]
        if len(ref_types) != 1:
            raise ValueError(f"Expect exactly one score_map output, got {ref_types}.")

        score_maps = np.asarray(batch_output[ref_types[0]], dtype=np.float32)
        scores = score_maps.reshape(score_maps.shape[0], -1).mean(axis=1)

        rows_batch = []
        for i, p in enumerate(query_img_paths):
            parts = p.split("/")
            scene = parts[-5] if len(parts) >= 5 else parts[0]
            rendered_dir = os.path.join(*parts[:-2]) if len(parts) > 2 else p
            image_name = parts[-1].replace("frame_", "")
            rows_batch.append([scene, rendered_dir, image_name, float(scores[i])])
        new = DataFrame(rows_batch, columns=self.columns)
        self.rows = new if self.rows.empty else pd.concat([self.rows, new])

    @staticmethod
    def _part(path: str, idx: int, fallback: str = "unknown") -> str:
        parts = [p for p in path.split("/") if p not in ("", ".")]
        if len(parts) >= -idx:
            return parts[idx]
        return parts[0] if parts else fallback

    def summarise(self):
        # method/dataset derive from the processed-tree layout
        # .../<method>/<dataset>/res_*/scene/split/ours_*; shallow demo paths
        # fall back to their first component (reference indexes blindly:
        # score_summariser.py:204-207)
        methods = self.rows["rendered_dir"].apply(lambda x: self._part(x, -6)).unique()
        datasets = self.rows["rendered_dir"].apply(lambda x: self._part(x, -5)).unique()
        self.summary = {}
        for dataset in datasets:
            self.summary[dataset] = {}
            for method in methods:
                sel = self.rows[
                    self.rows["rendered_dir"].str.contains(method, regex=False)
                    & self.rows["rendered_dir"].str.contains(dataset, regex=False)
                ]
                self.summary[dataset][method] = sel.sort_values(
                    by=["scene_name", "rendered_dir", "image_name"]
                )

    def __len__(self):
        return len(self.rows)


class SummaryWriterPredictedOnlineTestPrediction(SummaryWriterPredictedOnline):
    """Adds CSV writing at epoch end: <dir_out>/score_summary/<dataset>/<method>.csv"""

    def __init__(self, metric_type: str, metric_min, dir_out):
        super().__init__(metric_type, metric_min)
        self.csv_dir = Path(dir_out).expanduser() / "score_summary"
        self.csv_dir.mkdir(parents=True, exist_ok=True)

    def summarise(self):
        if self.rows.empty:
            return
        super().summarise()
        for dataset, per_method in self.summary.items():
            for method, rows in per_method.items():
                d = self.csv_dir / dataset
                d.mkdir(parents=True, exist_ok=True)
                rows.to_csv(d / f"{method}.csv", index=False, float_format="%.4f")


class ScoreReader:
    """Reads GT ssim/mae metric-map pairs and derives per-frame means."""

    def __init__(self, score_map_dir_list):
        read_types = ["ssim", "mae"]
        per_type = {k: [] for k in read_types}
        for t in read_types:
            for d in score_map_dir_list:
                td = os.path.join(d, t)
                per_type[t].extend(os.path.join(td, n) for n in sorted(os.listdir(td)))
        self.read_paths_all = np.stack([per_type[k] for k in read_types], axis=1)

    def __len__(self):
        return len(self.read_paths_all)

    def __getitem__(self, idx):
        path_ssim, path_mae = self.read_paths_all[idx]
        ssim_map = metric_map_read(path_ssim, vrange=[-1, 1])
        mae_map = metric_map_read(path_mae, vrange=[0, 1])
        mse = float(np.square(mae_map).mean())
        return {
            "ssim_-1_1": float(ssim_map.mean()),
            "ssim_0_1": float(np.clip(ssim_map, 0, 1).mean()),
            "mae": float(mae_map.mean()),
            "mse": mse,
            "psnr": float(-10.0 * np.log10(mse)) if mse > 0 else float("inf"),
            "path_ssim": str(path_ssim),
        }


class SummaryWriterGroundTruth:
    """Offline: read GT metric maps under <dir_in>/**/metric_map and write a
    per-frame CSV (<dir_out>/<dataset>/<method>.csv)."""

    COLUMNS = [
        "scene_name", "rendered_dir", "image_name",
        "gt_ssim_-1_1", "gt_ssim_0_1", "gt_mae", "gt_mse", "gt_psnr",
    ]

    def __init__(self, dir_in, dir_out, num_workers: int = 8, fast_debug: int = 0, force: bool = False):
        self.dir_in = Path(dir_in).expanduser()
        self.dir_out = Path(dir_out).expanduser()
        self.num_workers = num_workers
        self.fast_debug = fast_debug
        self.force = force
        self.dataset_type = self.dir_in.parent.name
        self.rendering_method = self.dir_in.parents[1].name
        self.csv_dir = self.dir_out / self.dataset_type
        self.csv_path = self.csv_dir / f"{self.rendering_method}.csv"
        self.csv_dir.mkdir(parents=True, exist_ok=True)

    def write_csv(self):
        if self.csv_path.exists() and not self.force:
            print(f"Write to csv {self.csv_path} (SKIP)")
            return
        rows = self._load_per_frame_scores()
        DataFrame(rows, columns=self.COLUMNS).to_csv(
            self.csv_path, index=False, float_format="%.4f"
        )
        print(f"Write to csv {self.csv_path}")

    def _load_per_frame_scores(self):
        from concurrent.futures import ThreadPoolExecutor

        dirs = sorted(glob(str(self.dir_in / "**/metric_map"), recursive=True))
        reader = ScoreReader(dirs)
        n = len(reader)
        if self.fast_debug > 0:
            n = min(n, self.fast_debug * 16)
        with ThreadPoolExecutor(self.num_workers) as pool:
            data = list(pool.map(reader.__getitem__, range(n)))
        rows = []
        for d in data:
            parts = d["path_ssim"].split("/")
            rows.append([
                parts[-6],
                os.path.join(*parts[:-3]),
                parts[-1].replace("frame_", ""),
                d["ssim_-1_1"], d["ssim_0_1"], d["mae"], d["mse"], d["psnr"],
            ])
        return rows


class SummaryReader:
    @staticmethod
    def read_summary(summary_dir, dataset, method_list, scene_list, split_list, iter_list):
        summary_dir = Path(summary_dir).expanduser() / dataset
        available = [f.stem for f in summary_dir.iterdir() if f.is_file()]
        if method_list != [""]:
            missing = [m for m in method_list if m not in available]
            if missing:
                raise ValueError(f"{missing[0]} is not available in {summary_dir}")
            methods = method_list
        else:
            methods = available

        summary = pd.concat(
            [pd.read_csv(summary_dir / f"{m}.csv").assign(method_name=m) for m in methods]
        )
        if scene_list != [""]:
            summary = summary[summary["scene_name"].isin(scene_list)]
        if split_list != [""]:
            summary = pd.concat(
                [summary[summary["rendered_dir"].str.split("/").str[-2] == s] for s in split_list]
            )
        if len(iter_list) > 0:
            summary = pd.concat(
                [summary[summary["rendered_dir"].str.endswith(f"ours_{i}")] for i in iter_list]
            )
        summary = summary.sort_values(["scene_name", "rendered_dir", "image_name", "method_name"])
        return summary.reset_index(drop=True)

    @staticmethod
    def check_summary_gt_prediction_rows(summary_gt, summary_prediction):
        if len(summary_gt) != len(summary_prediction):
            raise ValueError("Summary GT and prediction have different length")
        if not summary_gt["rendered_dir"].equals(summary_prediction["rendered_dir"]):
            raise ValueError("Summary GT and prediction have different rendered_dir")
        if not summary_gt["image_name"].equals(summary_prediction["image_name"]):
            raise ValueError("Summary GT and prediction have different image_name")
