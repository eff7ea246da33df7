"""Shape-bucketed inference loader; the port's own copy of
``crossscore_tpu/data/bucketing.py``.

The reference's predict path resizes the short side only (reference
``config/default_predict.yaml:47-48``, ``task/predict.py:69-93``), so a
mixed-aspect directory yields batches of many shapes. This loader:

1. reads each item's post-pipeline shape from the PNG header (no decode),
2. groups items by the BUCKET shape (each dim rounded up to a multiple of
   ``bucket_multiple``) and batches within a bucket,
3. pads every item right/bottom to its bucket, attaching ``_valid_hw``.

The model masks the padded tokens (K5 and K6 on the flash route,
models/crossscore.py), so the valid region of each output equals an unpadded
run's. Outputs come back bucket-sized; the tasks crop them on the host to
``(h//14*14, w//14*14)``, the jigsaw extent of an unpadded run.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

from crossscore_tpu_torch.data.loader import Loader, shard_split


def bucket_hw(h: int, w: int, multiple: int = 112) -> tuple[int, int]:
    up = lambda x: -(-x // multiple) * multiple  # noqa: E731
    return up(h), up(w)


def _pad_hw(x: np.ndarray, h: int, w: int, h_axis: int) -> np.ndarray:
    pad = [(0, 0)] * x.ndim
    pad[h_axis] = (0, h - x.shape[h_axis])
    pad[h_axis + 1] = (0, w - x.shape[h_axis + 1])
    if any(p != (0, 0) for p in pad):
        x = np.pad(x, pad)
    return x


class ShapeBucketedLoader(Loader):
    """Inference loader over mixed-shape datasets (iteration is bucket-major,
    without shuffling).

    Batches PACK items of different shapes that round up to the same bucket
    (each item padded right/bottom on its own); ``_valid_hw`` is per item
    (B, 2) and the model masks per item.

    Over several nodes each bucket's items are split as the base loader
    splits the index space (:func:`~crossscore_tpu_torch.data.loader.shard_split`),
    so that every node steps through the same buckets the same number of
    times. The JAX loader takes the shard arguments and ignores them, so
    each of its processes evaluates every item (ROADMAP, Known
    deviations); on one node the two plans are the same."""

    def __init__(self, dataset, batch_size: int, bucket_multiple: int = 112, **kw):
        kw.setdefault("pad_last", True)
        super().__init__(dataset, batch_size, shuffle=False, **kw)
        self.bucket_multiple = bucket_multiple
        self._shapes = [dataset.get_item_shape(i) for i in range(len(dataset))]

    def distinct_buckets(self) -> set:
        return {bucket_hw(*s, self.bucket_multiple) for s in self._shapes}

    def _node_plan(self, epoch: int) -> list:
        groups: dict = defaultdict(list)
        for i, s in enumerate(self._shapes):
            groups[bucket_hw(*s, self.bucket_multiple)].append(i)
        plan = []
        for bucket in sorted(groups):
            idxs, n_real = shard_split(np.asarray(groups[bucket]), self.shard_index, self.num_shards)
            for start in range(0, len(idxs), self.batch_size):
                chunk = idxs[start : start + self.batch_size]
                plan.append((chunk, max(0, min(len(chunk), n_real - start)), {"bucket": bucket}))
        return plan

    def _pre_collate(self, items: list, extra) -> list:
        bh, bw = extra["bucket"]
        out = []
        for it in items:
            it2 = dict(it)
            h, w = it["query/img"].shape[:2]
            for k in ("query/img", "reference/cross/imgs"):
                if k in it2 and it2[k] is not None:
                    it2[k] = _pad_hw(it2[k], bh, bw, it2[k].ndim - 3)
            if "query/score_map" in it2:
                it2["query/score_map"] = _pad_hw(
                    it2["query/score_map"], bh, bw, it2["query/score_map"].ndim - 2,
                )
            it2["_valid_hw"] = np.asarray([h, w], np.int32)  # collates (B, 2)
            out.append(it2)
        return out
