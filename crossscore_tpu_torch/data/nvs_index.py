"""NVS dataset: filesystem index, neighbour selection, per-item loading; the
port's own copy of ``crossscore_tpu/data/nvs_index.py``.

An item is decoded by the native fused decoder (``data/fastimage.py``: decode,
resize, crop and normalise in one C call per image, without the GIL) when it
is available and every image of the item is a PNG, else by Pillow and numpy.
Both paths draw the same rng and give the same geometry. Images may come
from packed record shards (``record_dir``, ``data/records.py``) instead of
one file each. The fused path can skip the decode of an image whose tokens a
consumer already holds (``query_pixel_skip``, ``ref_pixel_skip``).

Behavioural parity with reference ``dataloading/dataset/nvs_dataset.py``:

Directory layout (produced by the reference's preprocessing):
``<dataset_path>/<res_*>/<scene>/<train|test>/ours_<iter>/{renders,gt,metric_map/{ssim,mae}}``
plus ``<res_*>/split.json`` with train/val/test scene-name lists.

Semantics:
- Query images are RENDERS of split S; cross-references are GT CAPTURES of
  the OTHER split (``nvs_dataset.py:395-399``).
- ``ssim`` maps are stored uint16 in [-1, 1] and optionally clamped to [0, 1];
  ``mse`` is derived as mae^2 (``nvs_dataset.py:441-455``).
- Missing metric maps and padded references use ``empty_image`` placeholders
  (zeros; NaN maps for mae/mse).
- ``num_gaussians_iters`` truncates to earlier (noisier) GS checkpoints.
- ``zero_reference`` ablation zeroes all reference pixels.

Unlike the reference's torch ``Dataset`` (implicit np.random state per
worker), items are pure functions of (index, epoch_seed): every call derives
its RNG from a fold-in, so any element is reproducible in isolation and
sharding across hosts/workers cannot skew distributions.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Optional

import numpy as np
from PIL import Image

from crossscore_tpu_torch.data import fastimage
from crossscore_tpu_torch.data.crop import CropperSame, CropperSeparate, get_crop_params
from crossscore_tpu_torch.data.samplers import EMPTY_IMAGE, make_sampler
from crossscore_tpu_torch.io.images import (
    image_read, image_read_bytes, metric_map_read, metric_map_read_bytes, normalize_imagenet,
)
from crossscore_tpu_torch.ops.interpolate import resize_bilinear_antialias


def to_wire_uint8(img: np.ndarray) -> np.ndarray:
    """[0, 1] float pixels -> the uint8 wire format (``wire_uint8``); exact
    for unresized 8-bit sources (k/255 * 255 rounds back to k)."""
    return np.clip(np.rint(img * 255.0), 0, 255).astype(np.uint8)


class NeighbourSelector:
    """Flattens (scene, gs_split, iter, image) into a global index and returns
    query/score-map/reference paths per element."""

    def __init__(self, paths: dict, neighbour_config: dict):
        self.paths = paths
        self.neighbour_config = neighbour_config
        self.index = self._build_index(paths)
        self.sampler = None
        if neighbour_config["cross"] > 0:
            self.sampler = make_sampler(
                neighbour_config.get("strategy", "random"),
                neighbour_config["cross"],
                neighbour_config.get("deterministic", False),
            )

    @staticmethod
    def _build_index(paths: dict) -> list[dict]:
        index = []
        for scene in sorted(paths.keys()):
            for gs_split in ("train", "test"):
                key = f"gs_{gs_split}"
                if key not in paths[scene]:
                    continue
                q = paths[scene][key]["query"]
                for it in range(q["N_iters"]):
                    for img in range(q["N_imgs_per_iter"]):
                        index.append(
                            {
                                "scene_name": scene,
                                "gaussian_split": gs_split,
                                "iter_idx": it,
                                "img_idx": img,
                            }
                        )
        return index

    def __len__(self) -> int:
        return len(self.index)

    def __getitem__(self, idx: int) -> dict:
        return self.select(idx, np.random.default_rng(0))

    def select(self, idx: int, rng: np.random.Generator) -> dict:
        meta = self.index[idx]
        split_paths = self.paths[meta["scene_name"]][f"gs_{meta['gaussian_split']}"]
        iter_name = list(split_paths["query"]["images"].keys())[meta["iter_idx"]]
        img_idx = meta["img_idx"]

        result = {
            "query/img": split_paths["query"]["images"][iter_name][img_idx],
            "query/score_map": split_paths["query"]["score_map"][iter_name][img_idx],
            "reference/cross/imgs": [],
        }
        if self.sampler is not None:
            ref_list = split_paths["reference"]["cross"]["images"][iter_name]
            result["reference/cross/imgs"] = self.sampler(ref_list, rng)
        return result


class NvsDataset:
    """Index + loader over one preprocessed NVS dataset root."""

    def __init__(
        self,
        dataset_path: str,
        resolution: Optional[str],
        data_split: str,
        neighbour_config: dict,
        metric_type: str,
        metric_min: int,
        metric_max: int,
        crop_size: Optional[int] = None,
        crop_mode: Optional[str] = "dataset_default",
        resize_short_side: int = -1,
        deterministic_crop: bool = False,
        num_gaussians_iters: int = -1,
        zero_reference: bool = False,
        return_item_paths: bool = False,
        record_dir: Optional[str] = None,
        wire_uint8: bool = False,
    ):
        if data_split not in ("train", "test", "val", "val_small", "test_small"):
            raise ValueError(f"Unknown data_split {data_split}")
        # optional record-shard store (data/records.py): a few large files
        # read sequentially instead of one open and seek per PNG. Its keys
        # are paths relative to the dataset root
        self._record_root = Path(dataset_path)
        self._store = None
        if record_dir:
            from crossscore_tpu_torch.data.records import RecordStore

            self._store = RecordStore(record_dir)
        self.neighbour_config = dict(neighbour_config)
        self.zero_reference = zero_reference
        # wire-compact batches: emit raw uint8 pixels; the model normalises
        # them on the device (models/crossscore.py::_normalize_u8). 1/4 the
        # collate + host->device bytes per step; byte-exact vs the float path
        # when no resize is active, <=0.5/255 re-quantisation under a resize.
        self.wire_uint8 = wire_uint8
        self.return_item_paths = return_item_paths
        self.resize_short_side = resize_short_side
        self.crop_mode = crop_mode
        self.metric_config = self._build_metric_config(metric_type, metric_min, metric_max)

        if crop_mode == "dataset_default":
            if crop_size is None:
                raise ValueError("crop_size required for crop_mode=dataset_default")
            if resize_short_side > 0 and resize_short_side < crop_size:
                raise ValueError(
                    f"Required to resize image before crop, but resize_short_side "
                    f"{resize_short_side} < crop_size {crop_size}"
                )
            self.query_crop = CropperSame((crop_size, crop_size), deterministic_crop)
            self.reference_crop = CropperSeparate((crop_size, crop_size), deterministic_crop)
        else:
            self.query_crop = None
            self.reference_crop = None

        if resolution is None:
            # the reference discovers resolutions as res_* dirs (reference
            # dataloading/dataset/nvs_dataset.py:122-131); restricting the
            # auto-pick the same way keeps sibling dirs (e.g. packed record
            # shards) from being mistaken for a resolution
            res_dirs = sorted(
                n for n in os.listdir(dataset_path) if n.startswith("res_")
            ) or sorted(os.listdir(dataset_path))
            resolution = res_dirs[0]
        self.dataset_path = Path(dataset_path, resolution)

        with open(self.dataset_path / "split.json") as f:
            scene_names = json.load(f)[data_split]
        scene_paths = [self.dataset_path / n for n in sorted(scene_names)]
        scene_paths = [p for p in scene_paths if p.exists()]

        self.all_paths = self.get_paths(
            scene_paths, num_gaussians_iters, self.metric_config["load_dir"]
        )
        self.neighbour_selector = NeighbourSelector(self.all_paths, self.neighbour_config)

    # ------------------------------------------------------------------ paths

    @staticmethod
    def _build_metric_config(metric_type, metric_min, metric_max) -> dict:
        if metric_type in ("ssim", "mae"):
            load_dir = f"metric_map/{metric_type}"
        elif metric_type == "mse":
            load_dir = "metric_map/mae"  # mse derived from mae
        elif metric_type is None:
            load_dir = None
        else:
            raise ValueError(f"Invalid metric type {metric_type}")
        return {"type": metric_type, "vrange": [metric_min, metric_max], "load_dir": load_dir}

    @staticmethod
    def get_paths(scene_paths, num_gaussians_iters: int, metric_load_dir: Optional[str]) -> dict:
        raw: dict = {}
        for scene_path in scene_paths:
            scene = scene_path.name
            raw[scene] = {}
            for gs_split in ("train", "test"):
                dir_split = Path(scene_path, gs_split)
                if not dir_split.exists():
                    continue
                iter_dirs = sorted(os.listdir(dir_split), key=lambda x: int(x.split("_")[-1]))
                iter_dirs = [Path(dir_split, d) for d in iter_dirs]
                if num_gaussians_iters > 0:
                    iter_dirs = iter_dirs[:num_gaussians_iters]

                per_split = {"renders": {}, "gt": {}, "score_map": {}}
                for dir_iter in iter_dirs:
                    iter_num = int(dir_iter.name.split("_")[-1])
                    gt_dir = dir_iter / "gt"
                    n_gt = len(os.listdir(gt_dir)) if gt_dir.exists() else 0
                    for img_type in per_split:
                        if img_type in ("renders", "gt"):
                            img_dir = dir_iter / img_type
                        else:
                            img_dir = dir_iter / metric_load_dir if metric_load_dir else None
                        if img_dir is not None and img_dir.exists():
                            names = sorted(os.listdir(img_dir))
                            paths = [str(img_dir / n) for n in names]
                        else:
                            paths = [EMPTY_IMAGE] * n_gt
                        if len(paths) != n_gt:
                            raise ValueError(
                                f"Number of items mismatch in {scene}/{gs_split}/{iter_num}/{img_type}"
                            )
                        per_split[img_type][iter_num] = paths
                raw[scene][gs_split] = per_split

        results: dict = {}
        for scene, splits in raw.items():
            results[scene] = {}
            for gs_split in ("train", "test"):
                if gs_split not in splits:
                    continue
                cross_split = "test" if gs_split == "train" else "train"
                if cross_split not in splits:
                    continue
                q = splits[gs_split]
                r = splits[cross_split]
                results[scene][f"gs_{gs_split}"] = {
                    "query": {
                        "images": q["renders"],
                        "score_map": q["score_map"],
                        "N_iters": len(q["renders"]),
                        "N_imgs_per_iter": len(next(iter(q["renders"].values()), [])),
                    },
                    "reference": {
                        "cross": {
                            "images": r["gt"],
                            "N_iters": len(r["gt"]),
                            "N_imgs_per_iter": len(next(iter(r["gt"].values()), [])),
                        }
                    },
                }
        return results

    # ------------------------------------------------------------------ items

    def __len__(self) -> int:
        return len(self.neighbour_selector)

    def _store_payload(self, path: str):
        """The record store's payload of ``path``, or None (read the file)."""
        if self._store is None or path == EMPTY_IMAGE:
            return None
        try:
            key = Path(path).resolve().relative_to(self._record_root.resolve()).as_posix()
        except ValueError:
            return None
        return self._store.read(key) if key in self._store else None

    def _read_image(self, path: str) -> np.ndarray:
        payload = self._store_payload(path)
        return image_read(path) if payload is None else image_read_bytes(payload)

    def _read_metric_map(self, path: str, vrange) -> np.ndarray:
        payload = self._store_payload(path)
        return metric_map_read(path, vrange) if payload is None else metric_map_read_bytes(payload, vrange)

    def load_content(self, item_paths: dict) -> dict:
        mc = self.metric_config
        query = self._read_image(item_paths["query/img"])  # (H, W, 3)

        sm_path = item_paths["query/score_map"]
        if mc["type"] == "ssim":
            if sm_path == EMPTY_IMAGE:
                score_map = np.zeros(query.shape[:2], np.float32)
            else:
                score_map = self._read_metric_map(sm_path, vrange=[-1, 1])
                if mc["vrange"] == [0, 1]:
                    score_map = np.clip(score_map, 0, 1)
        elif mc["type"] in ("mae", "mse"):
            if sm_path == EMPTY_IMAGE:
                score_map = np.full(query.shape[:2], np.nan, np.float32)
            else:
                score_map = self._read_metric_map(sm_path, vrange=[0, 1])
                if mc["type"] == "mse":
                    score_map = np.square(score_map)
        else:  # None: SimpleReference — no GT maps
            score_map = np.zeros(query.shape[:2], np.float32)

        refs = []
        for p in item_paths["reference/cross/imgs"]:
            if p == EMPTY_IMAGE:
                refs.append(np.zeros_like(query))
            else:
                refs.append(self._read_image(p))
        ref_imgs = np.stack(refs) if refs else None
        if ref_imgs is not None and self.zero_reference:
            ref_imgs = np.zeros_like(ref_imgs)
        return {"query/img": query, "query/score_map": score_map, "reference/cross/imgs": ref_imgs}

    def load_image(self, path: str) -> np.ndarray:
        """One whole image as an item of this dataset carries it, for a
        dataset trimmed to whole patches (``crop_mode="integer_patches"``):
        the decode path, resize, trim and wire of :meth:`get_item`, so what
        the token loader hands the encoder for it (``tasks/encode_tokens.py``
        fills the token store with these)."""
        if self.crop_mode != "integer_patches":
            raise ValueError("load_image needs crop_mode='integer_patches': other crops draw from the item's rng")
        if fastimage.available() and path.lower().endswith(".png"):
            payload = self._store_payload(path)
            resize_hw, crop, _, _ = self._plan_geometry(path, None, is_query=True, payload=payload)
            return self._fi_load_rgb(path, payload, resize_hw=resize_hw, crop=crop, normalize=True,
                                     as_uint8=self.wire_uint8)
        img = self._read_image(path)
        if self.resize_short_side > 0:
            img = self._resize(img)
        img = img[:img.shape[0] - img.shape[0] % 14, :img.shape[1] - img.shape[1] % 14]
        return to_wire_uint8(img) if self.wire_uint8 else normalize_imagenet(img).astype(np.float32)

    def resized_hw(self, h: int, w: int) -> tuple[int, int]:
        """Post-pipeline (H, W) for an original (h, w) image: the rounding of
        :meth:`_resize` and the optional integer-patch crop."""
        s = self.resize_short_side
        if s > 0 and min(h, w) != s:
            if h <= w:
                h, w = s, max(1, round(w * s / h))
            else:
                h, w = max(1, round(h * s / w)), s
        if self.crop_mode == "integer_patches":
            h, w = h - h % 14, w - w % 14
        return h, w

    def get_item_shape(self, idx: int) -> tuple[int, int]:
        """Post-pipeline query (H, W) of item ``idx`` without decoding it: only
        the PNG header is read. The shape-bucketed loader groups items by it
        before any pixel I/O."""
        if self.query_crop is not None:
            return tuple(self.query_crop.output_size)
        with Image.open(self.neighbour_selector[idx]["query/img"]) as im:
            w, h = im.size
        return self.resized_hw(h, w)

    def _resize(self, img: np.ndarray) -> np.ndarray:
        """Resize so the SHORT side == resize_short_side (torchvision semantics)."""
        s = self.resize_short_side
        h, w = img.shape[:2]
        if min(h, w) == s:
            return img
        if h <= w:
            out_h, out_w = s, max(1, round(w * s / h))
        else:
            out_h, out_w = max(1, round(h * s / w)), s
        if not img.any():  # the zero score maps of a dataset without GT: the resize is zero too
            return np.zeros((out_h, out_w, *img.shape[2:]), np.float32)
        return resize_bilinear_antialias(img, out_h, out_w)

    @staticmethod
    def _all_png(item_paths: dict) -> bool:
        paths = [item_paths["query/img"], item_paths["query/score_map"], *item_paths["reference/cross/imgs"]]
        return all(p == EMPTY_IMAGE or p.lower().endswith(".png") for p in paths)

    def get_item(self, idx: int, rng: np.random.Generator) -> dict:
        item_paths = self.neighbour_selector.select(idx, rng)
        # the fused path decodes PNG only (files or record-shard payloads);
        # JPEG and the rest go through Pillow
        if fastimage.available() and self._all_png(item_paths):
            return self._get_item_fused(item_paths, rng)
        content = self.load_content(item_paths)

        q = content["query/img"]
        sm = content["query/score_map"]
        refs = content["reference/cross/imgs"]

        if self.resize_short_side > 0:
            q = self._resize(q)
            sm = self._resize(sm)
            if refs is not None:
                refs = np.stack([self._resize(r) for r in refs])

        if self.crop_mode == "integer_patches":
            p = 14
            nh, nw = q.shape[0] - q.shape[0] % p, q.shape[1] - q.shape[1] % p
            q, sm = q[:nh, :nw], sm[:nh, :nw]
            if refs is not None:
                refs = refs[:, :nh, :nw]

        if self.query_crop is not None:
            res = self.query_crop(q, sm, rng=rng)
            q, sm = res["out"]
        if self.reference_crop is not None and refs is not None:
            refs = self.reference_crop(refs, rng=rng)["out"]

        if self.wire_uint8:
            q_out = to_wire_uint8(q)  # raw pixels on the wire
        else:
            q_out = normalize_imagenet(q).astype(np.float32)
        out = {
            "query/img": q_out,
            "query/score_map": sm.astype(np.float32),
        }
        # the decode skip is the fused path's; with the hooks set this path
        # emits the same keys, all False, so that a corpus mixing PNG and
        # other items still collates into one batch
        if getattr(self, "query_pixel_skip", None) is not None:
            out["query/skipped"] = np.asarray(False)
        if refs is not None:
            if self.wire_uint8:
                out["reference/cross/imgs"] = to_wire_uint8(refs)
            else:
                out["reference/cross/imgs"] = normalize_imagenet(refs).astype(np.float32)
            if getattr(self, "ref_pixel_skip", None) is not None:
                out["reference/skipped"] = np.zeros(len(refs), bool)
        if self.return_item_paths:
            out["item_paths"] = item_paths
        return out

    # ------------------------------------------------- the native fused path

    @staticmethod
    def _fi_load_rgb(path: str, payload, **kw) -> np.ndarray:
        if payload is not None:
            return fastimage.load_rgb_bytes(payload, **kw)
        return fastimage.load_rgb(path, **kw)

    @staticmethod
    def _fi_load_metric(path: str, payload, **kw) -> np.ndarray:
        if payload is not None:
            return fastimage.load_metric_bytes(payload, **kw)
        return fastimage.load_metric(path, **kw)

    def _plan_geometry(self, path: str, rng, is_query: bool, payload=None):
        """(resize_hw, crop, out_hw, pre_crop_hw) of one image from its header,
        drawing from ``rng`` what the Pillow path draws for it, so that both
        paths cut the same windows."""
        h, w, _, _ = fastimage.image_info(path) if payload is None else fastimage.image_info_bytes(payload)
        resize_hw = None
        if self.resize_short_side > 0 and min(h, w) != self.resize_short_side:
            s = self.resize_short_side
            resize_hw = (s, max(1, round(w * s / h))) if h <= w else (max(1, round(h * s / w)), s)
            h, w = resize_hw
        if self.crop_mode == "integer_patches":
            nh, nw = h - h % 14, w - w % 14
            return resize_hw, (0, 0, nh, nw), (nh, nw), (h, w)
        cropper = self.query_crop if is_query else self.reference_crop
        if cropper is not None:
            p = get_crop_params((h, w), cropper.output_size, rng, cropper.deterministic)
            return resize_hw, tuple(int(x) for x in p), tuple(cropper.output_size), (h, w)
        return resize_hw, None, (h, w), (h, w)

    def _get_item_fused(self, item_paths: dict, rng: np.random.Generator) -> dict:
        mc = self.metric_config
        qpath = item_paths["query/img"]
        q_payload = self._store_payload(qpath)
        resize_hw, crop, out_hw, pre_crop_hw = self._plan_geometry(qpath, rng, is_query=True, payload=q_payload)
        # the query decode skip (token-space training, data/token_train.py):
        # once the token cache holds this image's grid its pixels are never
        # read (the window comes from the cached tokens, the supervision from
        # the score map below). This path draws no rng for it, and the
        # consumer resolves a skipped slot from the cache alone
        qskip_fn = getattr(self, "query_pixel_skip", None)
        q_skipped = bool(qskip_fn is not None and qskip_fn(qpath, out_hw))
        wire_dt = np.uint8 if self.wire_uint8 else np.float32
        if q_skipped:
            q = np.zeros((*out_hw, 3), wire_dt)  # a placeholder
        else:
            q = self._fi_load_rgb(qpath, q_payload, resize_hw=resize_hw, crop=crop, normalize=True,
                                  as_uint8=self.wire_uint8)

        sm_path = item_paths["query/score_map"]
        if sm_path == EMPTY_IMAGE or mc["type"] is None:
            if mc["type"] in ("mae", "mse") and sm_path == EMPTY_IMAGE:
                sm = np.full(out_hw, np.nan, np.float32)
            else:
                sm = np.zeros(out_hw, np.float32)
        elif mc["type"] == "ssim":
            sm = self._fi_load_metric(sm_path, self._store_payload(sm_path), vrange=[-1, 1],
                                      clamp01=(mc["vrange"] == [0, 1]), resize_hw=resize_hw, crop=crop)
        else:  # mae / mse
            sm = self._fi_load_metric(sm_path, self._store_payload(sm_path), vrange=[0, 1],
                                      square=(mc["type"] == "mse"), resize_hw=resize_hw, crop=crop)

        refs = skipped = None
        # the reference decode skip (the predict CLI's token cache, the token
        # loader): a reference whose tokens the cache holds is a placeholder,
        # and the consumer (RefTokenCache.gather) resolves its slot from the
        # cache alone. Exact: the crops here draw what the Pillow path draws
        skip_fn = getattr(self, "ref_pixel_skip", None)
        ref_paths = item_paths["reference/cross/imgs"]
        if ref_paths:
            if self.wire_uint8:
                # raw zeros on the wire: the device normalise maps them to
                # the -mean/std that the float path ships normalised
                zero_ref = np.zeros((*out_hw, 3), np.uint8)
            else:
                zero_ref = normalize_imagenet(np.zeros((*out_hw, 3), np.float32))
            refs = np.empty((len(ref_paths), *out_hw, 3), wire_dt)
            skipped = np.zeros(len(ref_paths), bool)
            for i, rp in enumerate(ref_paths):
                if rp == EMPTY_IMAGE:
                    # the Pillow path crops a zeros image of the query's
                    # pre-crop size: draw the same, the output is zeros
                    if self.reference_crop is not None:
                        get_crop_params(pre_crop_hw, self.reference_crop.output_size, rng,
                                        self.reference_crop.deterministic)
                    refs[i] = zero_ref
                    continue
                r_payload = self._store_payload(rp)
                r_resize, r_crop, r_hw, _ = self._plan_geometry(rp, rng, is_query=False, payload=r_payload)
                if self.zero_reference:
                    refs[i] = zero_ref
                    continue
                if r_hw != out_hw:
                    raise ValueError(f"reference {rp} output {r_hw} != query {out_hw}; "
                                     "set a crop or resize for mixed-size inputs")
                if skip_fn is not None and skip_fn(rp, r_hw):
                    refs[i] = 0  # a placeholder; the tokens come from the cache
                    skipped[i] = True
                    continue
                self._fi_load_rgb(rp, r_payload, resize_hw=r_resize, crop=r_crop, normalize=True,
                                  as_uint8=self.wire_uint8, out=refs[i])

        out = {"query/img": q, "query/score_map": sm}
        if qskip_fn is not None:
            out["query/skipped"] = np.asarray(q_skipped)
        if refs is not None:
            out["reference/cross/imgs"] = refs
            if skip_fn is not None:
                out["reference/skipped"] = skipped
        if self.return_item_paths:
            out["item_paths"] = item_paths
        return out


def get_dataset(cfg, data_split: str, return_item_paths: bool = False, crop_mode="dataset_default",
                deterministic_crop: bool = False, resize_short_side: int = -1):
    """Dataset factory (parity with reference ``dataloading/data_manager.py:7-41``):
    one NvsDataset per configured root, concatenated."""
    paths = cfg.data.dataset.path
    if isinstance(paths, str):
        paths = [paths]

    datasets = [
        NvsDataset(
            dataset_path=p,
            resolution=cfg.data.dataset.resolution,
            data_split=data_split,
            neighbour_config=cfg.data.neighbour_config,
            metric_type=cfg.model.predict.metric.type,
            metric_min=cfg.model.predict.metric.min,
            metric_max=cfg.model.predict.metric.max,
            crop_size=cfg.data.transforms.crop_size,
            crop_mode=crop_mode,
            resize_short_side=resize_short_side,
            deterministic_crop=deterministic_crop,
            num_gaussians_iters=cfg.data.dataset.num_gaussians_iters,
            zero_reference=cfg.data.dataset.zero_reference,
            return_item_paths=return_item_paths,
            record_dir=cfg.data.dataset.get("record_dir"),
            wire_uint8=bool(cfg.data.dataset.get("wire_uint8", False)),
        )
        for p in paths
    ]
    if len(datasets) == 1:
        return datasets[0]
    return ConcatDataset(datasets)


def leaf_datasets(ds) -> list:
    """The NvsDataset leaves of ``ds``: itself, or a ConcatDataset's parts.
    Per-leaf settings (the crop geometry, the neighbour config) are read on
    the leaves, and the per-item hooks (``ref_pixel_skip``,
    ``query_pixel_skip``) are set on them; a ConcatDataset carries none of
    them."""
    return list(ds.datasets) if isinstance(ds, ConcatDataset) else [ds]


def unique_image_paths(ds) -> list[str]:
    """Every image the token trainer could read: all query renders and the
    whole reference pools (the sampler may pick any of them over the epochs),
    each once, in index order."""
    if isinstance(ds, ConcatDataset):
        return list(dict.fromkeys(p for sub in ds.datasets for p in unique_image_paths(sub)))
    paths: dict = {}
    tree = ds.neighbour_selector.paths
    for scene in sorted(tree):
        for key in ("gs_train", "gs_test"):
            sp = tree[scene].get(key)
            if not sp:
                continue
            groups = [sp["query"]["images"]]
            if "reference" in sp:
                groups.append(sp["reference"]["cross"]["images"])
            for group in groups:
                for it in sorted(group):
                    paths.update(dict.fromkeys(group[it]))
    return list(paths)


class ConcatDataset:
    def __init__(self, datasets):
        self.datasets = datasets
        self._offsets = np.cumsum([0] + [len(d) for d in datasets])

    def __len__(self):
        return int(self._offsets[-1])

    def _locate(self, idx: int) -> tuple:
        d = int(np.searchsorted(self._offsets, idx, side="right")) - 1
        return self.datasets[d], idx - int(self._offsets[d])

    def get_item(self, idx: int, rng: np.random.Generator) -> dict:
        ds, local = self._locate(idx)
        return ds.get_item(local, rng)

    def get_item_shape(self, idx: int) -> tuple:
        """Post-pipeline query (H, W) of item ``idx``, read by the leaf that
        holds it (shape bucketing, the token_fast coverage guard)."""
        ds, local = self._locate(idx)
        return ds.get_item_shape(local)
