"""Per-frame score summaries written during predict; the port's own copy of
the online writers of ``crossscore_tpu/io/summariser.py``.

Parity with reference ``utils/io/score_summariser.py:16-315``: identical CSV
layouts (columns, float format, path-derived scene/method/dataset grouping) so
the reference's downstream analysis keeps working.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import pandas as pd
from pandas import DataFrame


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
