"""Host input pipeline: multi-threaded decode + prefetch feeding the device;
the port's own copy of ``crossscore_tpu/data/loader.py`` for one process.

Replaces the reference's torch ``DataLoader`` stack (reference
``task/train.py:86-103``: 6 workers, pin_memory, prefetch_factor 2). Design:

- Items are pure functions of (epoch, index): the RNG for sampling/crops is
  folded from ``(seed, epoch, index)``, so any batch is reproducible in
  isolation.
- A thread pool decodes PNGs concurrently (PIL releases the GIL during
  decode); whole batches are assembled ahead of time into a bounded prefetch
  queue so the accelerator never waits on the host.
- Fixed output shapes per (crop_size, K). The final partial batch is padded
  by repeating the last item (``pad_last``); the true count travels in
  ``batch["_valid"]``. Subclasses may pad mixed-shape items to one shape
  before collation (``_pre_collate``, data/bucketing.py).
- Batches are numpy; the train loop moves them to the device.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np


_PERM_SENTINEL = 2**31  # index slot used for the epoch permutation RNG


class _ProducerError:
    def __init__(self, exc: BaseException):
        self.exc = exc


def _fold_rng(seed: int, epoch: int, index: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, epoch, index]))


def collate(items: list[dict]) -> dict:
    """Stack item dicts into batch arrays; item_paths collates to lists."""
    out: dict = {}
    for key in items[0]:
        if key == "item_paths":
            paths = [it["item_paths"] for it in items]
            out["item_paths"] = {
                "query/img": [p["query/img"] for p in paths],
                "query/score_map": [p["query/score_map"] for p in paths],
                # (K, B) transposed layout, matching the reference batch format
                "reference/cross/imgs": [
                    [p["reference/cross/imgs"][k] for p in paths]
                    for k in range(len(paths[0]["reference/cross/imgs"]))
                ],
            }
        else:
            out[key] = np.stack([it[key] for it in items])
    return out


class Loader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        num_workers: int = 6,
        prefetch_batches: int = 2,
        seed: int = 0,
        drop_last: bool = False,
        pad_last: bool = True,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.prefetch_batches = max(1, prefetch_batches)
        self.seed = seed
        self.drop_last = drop_last
        self.pad_last = pad_last

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            return _fold_rng(self.seed, epoch, _PERM_SENTINEL).permutation(n)
        return np.arange(n)

    def batches_per_epoch(self) -> int:
        return len(self._plan(0))

    def _plan(self, epoch: int) -> list:
        """Batch plan: a list of (index_chunk, n_valid, extra); ``extra`` is an
        opaque value handed to :meth:`_pre_collate` and :meth:`_finalize`
        (ShapeBucketedLoader's bucket shape, TokenSpaceLoader's epoch and
        indices)."""
        indices = self._epoch_indices(epoch)
        bs = self.batch_size
        plan = []
        for start in range(0, len(indices), bs):
            chunk = indices[start : start + bs]
            if len(chunk) < bs and self.drop_last:
                continue
            plan.append((chunk, len(chunk), None))
        return plan

    def _pre_collate(self, items: list, extra) -> list:
        """Per-item hook before collation (subclasses pad mixed-shape items
        to a common shape here so that they stack)."""
        return items

    def _finalize(self, batch: dict, extra) -> dict:
        """Post-collate hook (TokenSpaceLoader turns pixels into token
        windows here)."""
        return batch

    def epoch(self, epoch: int = 0, start_batch: int = 0) -> Iterator[dict]:
        """Yield collated numpy batches for one epoch.

        ``start_batch`` skips the first N batches without decoding them —
        used for exact mid-epoch resume (items are pure functions of
        (seed, epoch, index), so the skipped prefix is identical to what the
        interrupted run consumed)."""
        bs = self.batch_size
        batch_slices = self._plan(epoch)[start_batch:]

        out_q: queue.Queue = queue.Queue(maxsize=self.prefetch_batches)
        stop = threading.Event()

        def put_checked(item) -> bool:
            """put that aborts when the consumer has gone away (early break)."""
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                _produce_inner()
            except BaseException as e:  # surface worker errors to the consumer
                put_checked(_ProducerError(e))

        def _produce_inner():
            with ThreadPoolExecutor(self.num_workers) as pool:
                for chunk, n_valid, extra in batch_slices:
                    if stop.is_set():
                        break
                    items = list(
                        pool.map(
                            lambda i: self.dataset.get_item(
                                int(i), _fold_rng(self.seed, epoch, int(i))
                            ),
                            chunk,
                        )
                    )
                    if len(items) < bs and self.pad_last:
                        items = items + [items[-1]] * (bs - len(items))
                    batch = self._finalize(collate(self._pre_collate(items, extra)), extra)
                    batch["_valid"] = np.asarray(n_valid, np.int32)
                    if not put_checked(batch):
                        return
            try:
                out_q.put_nowait(None)
            except queue.Full:
                pass  # consumer is draining; it checks producer liveness

        producer = threading.Thread(target=produce, daemon=True)
        producer.start()
        try:
            producer_done = False
            while True:
                try:
                    batch = out_q.get(timeout=0.5)
                except queue.Empty:
                    if producer_done:
                        break
                    # the producer can enqueue its final batch(es) and exit
                    # in the window between our timeout firing and this
                    # liveness check — don't break yet; make one more full
                    # get() pass first (the queue cannot grow after producer
                    # death, so a second Empty then means true EOF)
                    producer_done = not producer.is_alive()
                    continue
                if batch is None:
                    break
                if isinstance(batch, _ProducerError):
                    raise batch.exc
                yield batch
        finally:
            stop.set()
            # unblock and reap the producer so no pool threads linger
            while producer.is_alive():
                try:
                    out_q.get_nowait()
                except queue.Empty:
                    pass
                producer.join(timeout=0.2)
