"""Per-batch disk outputs for test/predict; the port's own copy of
``crossscore_tpu/io/batch_writer.py``.

Parity with reference ``utils/io/batch_writer.py:24-270``: identical on-disk
layout and filename conventions so downstream tooling keeps working:

    <out_dir>/batch/score_map_ref_cross/r{rank}_B{batch:04}_b{b:03}_{query-path-mangled}.png
    <out_dir>/batch/score_map_gt/...
    <out_dir>/batch/item_path_json/r{rank}_B{batch:04}.json
    <out_dir>/batch/image_query/...
    <out_dir>/batch/image_reference/r..._{query}/cross/ref{k:02}_{ref-path-mangled}.png
    <out_dir>/batch/attn_weights/r..._{query}/cross/ref{k:02}_....png

Gray mode writes uint16 metric-map PNGs in the metric's intrinsic range
(ssim: [-1,1], mae/mse: [0,1]); rgb mode writes turbo-colormapped PNGs in the
model's prediction range.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
from PIL import Image

from crossscore_tpu_torch.io.images import metric_map_write, u8, to_display_rgb
from crossscore_tpu_torch.utils.vis import gray2rgb, attn2rgb


def get_vrange(metric_type: str, metric_min, metric_max):
    if metric_type == "ssim":
        vrange_intrinsic = [-1, 1]
    elif metric_type in ("mse", "mae"):
        vrange_intrinsic = [0, 1]
    else:
        raise ValueError(f"metric_type {metric_type} not supported")
    return vrange_intrinsic, [metric_min, metric_max]


def _mangle(path: str) -> str:
    return str(Path(*Path(path).parts[-5:])).replace("/", "_").replace(".png", "")


class BatchWriter:
    def __init__(self, cfg, phase: str):
        if phase not in ("test", "predict"):
            raise ValueError(f"Phase {phase} not supported")
        self.cfg = cfg
        self.phase = phase
        self.out_dir = Path(cfg.logger[phase].out_dir)
        self.write_config = cfg.logger[phase].write.config
        self.write_flag = dict(cfg.logger[phase].write.flag)
        self.write_flag["attn_weights"] = (
            self.write_flag["attn_weights"] and cfg.model.need_attn_weights
        )
        m = cfg.model.predict.metric
        self.vrange_intrinsic, self.vrange_vis = get_vrange(m.type, m.min, m.max)

        self.dirs = {"batch": self.out_dir / "batch"}
        if self.write_flag["batch"]:
            for k, on in self.write_flag.items():
                if k not in ("batch", "score_map_prediction") and on:
                    self.dirs[k] = self.dirs["batch"] / k
                    self.dirs[k].mkdir(parents=True, exist_ok=True)

    # ------------------------------------------------------------------ api

    def write_out(self, batch_input: dict, batch_output: dict, local_rank: int,
                  batch_idx: int, item_offset: int = 0, item_paths: bool = True):
        """``item_offset`` shifts the ``b{i}`` filename index — used when a
        bucket-PACKED batch (per-item shapes) is written one item at a time,
        and by a data rank for its rows of a node batch. ``item_paths=False``
        leaves the batch's item-path JSON to the caller (a data rank holds
        only its rows of it)."""
        self._item_offset = item_offset
        n_valid = int(batch_input.get("_valid", len(batch_input["item_paths"]["query/img"])))
        if self.write_flag["score_map_prediction"]:
            self._write_score_maps(batch_input, batch_output, local_rank, batch_idx, n_valid)
        if self.write_flag["score_map_gt"]:
            self._write_gt_maps(batch_input, local_rank, batch_idx, n_valid)
        if self.write_flag["item_path_json"] and item_paths:
            self._write_item_paths(batch_input, local_rank, batch_idx, n_valid)
        if self.write_flag["image_query"]:
            self._write_query_images(batch_input, local_rank, batch_idx, n_valid)
        if self.write_flag["image_reference"]:
            self._write_reference_images(batch_input, local_rank, batch_idx, n_valid)
        if self.write_flag["attn_weights"]:
            self._write_attn_weights(batch_input, batch_output, local_rank, batch_idx, n_valid)

    # -------------------------------------------------------------- helpers

    def _names(self, batch_input, local_rank, batch_idx, n_valid):
        qpaths = batch_input["item_paths"]["query/img"][:n_valid]
        off = getattr(self, "_item_offset", 0)  # per-item bucket-packed writes
        return [
            (b, f"r{local_rank}_B{batch_idx:04}_b{b + off:03}_{_mangle(p)}")
            for b, p in enumerate(qpaths)
        ]

    def _write_map(self, out_path: Path, score_map: np.ndarray):
        mode = self.write_config.score_map_colour_mode
        if mode == "gray":
            metric_map_write(out_path, score_map, self.vrange_intrinsic)
        elif mode == "rgb":
            Image.fromarray(gray2rgb(score_map, self.vrange_vis)).save(out_path)
        else:
            raise ValueError(f"colour_mode {mode} not supported")

    def _write_score_maps(self, batch_input, batch_output, local_rank, batch_idx, n_valid):
        for key in (k for k in batch_output if k.startswith("score_map")):
            out_dir = self.dirs["batch"] / key
            out_dir.mkdir(parents=True, exist_ok=True)
            maps = np.asarray(batch_output[key], dtype=np.float32)
            if len(batch_input["item_paths"]["query/img"]) < len(maps):
                raise ValueError("num of query images and score maps are not equal")
            for b, name in self._names(batch_input, local_rank, batch_idx, n_valid):
                self._write_map(out_dir / f"{name}.png", maps[b])

    def _write_gt_maps(self, batch_input, local_rank, batch_idx, n_valid):
        maps = np.asarray(batch_input["query/score_map"], dtype=np.float32)
        for b, name in self._names(batch_input, local_rank, batch_idx, n_valid):
            self._write_map(self.dirs["score_map_gt"] / f"{name}.png", maps[b])

    def _write_item_paths(self, batch_input, local_rank, batch_idx, n_valid):
        out = self.dirs["item_path_json"] / f"r{local_rank}_B{batch_idx:04}.json"
        item_paths = dict(batch_input["item_paths"])
        item_paths["query/img"] = list(item_paths["query/img"][:n_valid])
        item_paths["query/score_map"] = list(item_paths["query/score_map"][:n_valid])
        refs = item_paths.get("reference/cross/imgs", [])
        if len(refs) > 0:
            # (K, B) -> (B_valid, K), matching the reference's transposition
            item_paths["reference/cross/imgs"] = np.array(refs).T[:n_valid].tolist()
        with open(out, "w") as f:
            json.dump(item_paths, f, indent=2)

    def _write_query_images(self, batch_input, local_rank, batch_idx, n_valid):
        # no dtype cast: to_display_rgb branches on uint8 (wire_uint8 batches)
        imgs = np.asarray(batch_input["query/img"])
        for b, name in self._names(batch_input, local_rank, batch_idx, n_valid):
            rgb = u8(np.clip(to_display_rgb(imgs[b]), 0, 1))
            Image.fromarray(rgb).save(self.dirs["image_query"] / f"{name}.png")

    def _write_reference_images(self, batch_input, local_rank, batch_idx, n_valid):
        refs_paths = batch_input["item_paths"].get("reference/cross/imgs", [])
        if len(refs_paths) == 0:
            return
        refs_paths = np.array(refs_paths).T  # (B, K)
        # no dtype cast: to_display_rgb branches on uint8 (wire_uint8 batches)
        ref_imgs = np.asarray(batch_input["reference/cross/imgs"])
        for b, name in self._names(batch_input, local_rank, batch_idx, n_valid):
            sub = self.dirs["image_reference"] / name / "cross"
            sub.mkdir(parents=True, exist_ok=True)
            for k, rp in enumerate(refs_paths[b]):
                rgb = u8(np.clip(to_display_rgb(ref_imgs[b, k]), 0, 1))
                Image.fromarray(rgb).save(sub / f"ref{k:02}_{_mangle(rp)}.png")

    def _write_attn_weights(self, batch_input, batch_output, local_rank, batch_idx, n_valid,
                            check_patch_mode: str = "centre"):
        refs_paths = batch_input["item_paths"].get("reference/cross/imgs", [])
        if len(refs_paths) == 0 or "attn_weights_map_ref_cross" not in batch_output:
            return
        refs_paths = np.array(refs_paths).T  # (B, K)
        attn = np.asarray(batch_output["attn_weights_map_ref_cross"], dtype=np.float32)
        gh, gw = attn.shape[1:3]
        if check_patch_mode == "centre":
            patch = (gh // 2, gw // 2)
        else:
            raise ValueError(f"Unknown check_patch_mode: {check_patch_mode}")
        for b, name in self._names(batch_input, local_rank, batch_idx, n_valid):
            sub = self.dirs["attn_weights"] / name / "cross"
            sub.mkdir(parents=True, exist_ok=True)
            maps = attn[b][patch]  # (K, gh, gw)
            for k, rp in enumerate(refs_paths[b]):
                Image.fromarray(attn2rgb(maps[k])).save(sub / f"ref{k:02}_{_mangle(rp)}.png")
