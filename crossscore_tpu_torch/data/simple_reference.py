"""SimpleReference dataset: the predict path's input from two flat image
directories; the port's own copy of ``crossscore_tpu/data/simple_reference.py``.

Behavioural parity with reference ``dataloading/dataset/simple_reference.py:10-85``:
builds the same nested path index as NvsDataset from a bare ``query_dir`` +
``reference_dir`` (one fake scene, ``gs_test`` split, iter -1), with an empty
metric config so score maps load as zeros. The port may also read the images
from record shards (``record_dir``).
"""

from __future__ import annotations

import os
from pathlib import Path

from crossscore_tpu_torch.data.crop import CropperSame, CropperSeparate
from crossscore_tpu_torch.data.nvs_index import NeighbourSelector, NvsDataset
from crossscore_tpu_torch.data.samplers import EMPTY_IMAGE


class SimpleReference(NvsDataset):
    def __init__(
        self,
        query_dir: str,
        reference_dir: str,
        neighbour_config: dict,
        crop_size=None,
        crop_mode=None,
        resize_short_side: int = 518,
        deterministic_crop: bool = True,
        zero_reference: bool = False,
        return_item_paths: bool = True,
        wire_uint8: bool = False,
        record_dir=None,
    ):
        self.neighbour_config = dict(neighbour_config)
        self.zero_reference = zero_reference
        self.return_item_paths = return_item_paths
        self.wire_uint8 = wire_uint8
        # record shards (data/records.py) keyed relative to the deepest
        # directory holding both directories; the JAX package reads files only
        self._store = None
        if record_dir:
            from crossscore_tpu_torch.data.records import RecordStore

            self._record_root = Path(os.path.commonpath(
                [os.path.abspath(os.path.expanduser(d)) for d in (query_dir, reference_dir)]))
            self._store = RecordStore(record_dir)
        self.resize_short_side = resize_short_side
        self.crop_mode = crop_mode
        self.metric_config = self._build_metric_config(None, None, None)

        if crop_mode == "dataset_default":
            self.query_crop = CropperSame((crop_size, crop_size), deterministic_crop)
            self.reference_crop = CropperSeparate((crop_size, crop_size), deterministic_crop)
        else:
            self.query_crop = None
            self.reference_crop = None

        self.all_paths = self.build_paths(query_dir, reference_dir)
        self.neighbour_selector = NeighbourSelector(self.all_paths, self.neighbour_config)

    def reference_pool_size(self) -> int:
        """Number of distinct reference images (the token cache's working set)."""
        scene = next(iter(self.all_paths.values()))
        return scene["gs_test"]["reference"]["cross"]["N_imgs_per_iter"]

    @staticmethod
    def build_paths(query_dir: str, reference_dir: str) -> dict:
        query_dir = os.path.expanduser(query_dir)
        reference_dir = os.path.expanduser(reference_dir)
        query_paths = [os.path.join(query_dir, p) for p in sorted(os.listdir(query_dir))]
        reference_paths = [
            os.path.join(reference_dir, p) for p in sorted(os.listdir(reference_dir))
        ]

        fake_iter = -1
        scene_name = str(query_dir).replace(str(Path.home()), "~")
        return {
            scene_name: {
                "gs_test": {
                    "query": {
                        "images": {fake_iter: query_paths},
                        "score_map": {fake_iter: [EMPTY_IMAGE] * len(query_paths)},
                        "N_iters": 1,
                        "N_imgs_per_iter": len(query_paths),
                    },
                    "reference": {
                        "cross": {
                            "images": {fake_iter: reference_paths},
                            "N_iters": 1,
                            "N_imgs_per_iter": len(reference_paths),
                        }
                    },
                }
            }
        }
