"""Host input pipeline: multi-threaded decode + prefetch feeding the device;
the port's own copy of ``crossscore_tpu/data/loader.py``.

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
- Several nodes (``shard_index/num_shards``): the index space is split as
  the JAX package splits it over processes, with wrap-around padding so that
  every shard has the same length (one node of the port stands for one JAX
  process).
- Several data ranks of one node (``rank_index/rank_count``): each node
  batch of ``batch_size`` rows is cut into contiguous blocks, rank r taking
  rows ``[r*B/d, (r+1)*B/d)``; a rank decodes only its own rows.
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


# the keys whose leading axis is the batch, in the order they are looked for
_ROW_KEYS = ("query/img", "query/tokens", "query/score_map", "reference/cross/imgs", "reference/cross/tokens")


def prepare_global_shard(batch: dict, bs: int) -> dict:
    """Host-side prep for a batch that is one rank's rows of a global batch:
    the port's copy of the JAX ``prepare_global_shard``.

    The ``_valid`` prefix count becomes a per-row ``_valid_mask``, and
    ``_valid`` stays behind as a plain python int for host-side consumers
    (writers, metric weights); a shared ``(2,)`` ``_valid_hw`` is promoted to
    the per-item ``(rows, 2)`` form.

    The row count is the leading axis of the first of :data:`_ROW_KEYS`
    present (``bs`` when none is). The JAX package takes it from whichever
    ndarray comes first in the dict, so a shared ``(2,)`` ``_valid_hw``
    ahead of the images gives it 2 rows whatever the batch size (ROADMAP,
    Known deviations).
    """
    out = dict(batch)
    rows = next((int(out[k].shape[0]) for k in _ROW_KEYS
                 if getattr(out.get(k), "ndim", 0) > 0), bs)
    n_valid = out.get("_valid")
    if n_valid is not None:
        n = int(n_valid)
        out["_valid"] = n  # host-only from here on
        out["_valid_mask"] = (np.arange(rows) < n).astype(np.float32)
    vhw = out.get("_valid_hw")
    if vhw is not None and getattr(vhw, "ndim", 0) == 1:
        out["_valid_hw"] = np.tile(np.asarray(vhw)[None], (rows, 1))
    return out


def rank_block(chunk: np.ndarray, n_valid: int, batch_size: int, rank_index: int,
               rank_count: int) -> tuple[np.ndarray, int]:
    """Rank ``rank_index`` of ``rank_count``'s rows of one node batch ->
    (its indices, its ``_valid``). The node batch is ``chunk`` padded to
    ``batch_size`` rows by repeating its last index (``pad_last``); the rank
    takes rows ``[r*b, (r+1)*b)``, ``b = batch_size // rank_count``, and its
    ``_valid`` is ``clip(n_valid - r*b, 0, b)``: the node batch's
    ``_valid_mask`` cut to the rank. The indices come back unpadded (the
    loader repeats the last one), and a block that is all padding is the
    node batch's last index alone."""
    b = batch_size // rank_count
    lo = rank_index * b
    rows = chunk[lo:lo + b]
    if len(rows) == 0:
        rows = chunk[-1:]
    return rows, int(np.clip(n_valid - lo, 0, b))


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


def shard_split(idx: np.ndarray, shard_index: int, num_shards: int) -> tuple[np.ndarray, int]:
    """Shard ``shard_index`` of ``num_shards`` of the index list ``idx`` ->
    (its indices, how many of them are not wrap-around duplicates): the JAX
    ``Loader``'s split. The list is padded cyclically to a multiple of the
    shard count (``np.resize``, which also covers fewer items than shards)
    and split with a stride, so the duplicates end each shard's list."""
    n = len(idx)
    if num_shards <= 1:
        return idx, n
    total = -(-n // num_shards) * num_shards
    local = np.resize(idx, total)[shard_index::num_shards]
    global_pos = shard_index + np.arange(len(local)) * num_shards
    return local, int(np.sum(global_pos < n))


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
        shard_index: int = 0,
        num_shards: int = 1,
        rank_index: int = 0,
        rank_count: int = 1,
    ):
        if rank_count < 1 or batch_size % rank_count or not 0 <= rank_index < rank_count:
            raise ValueError(f"rank {rank_index} of {rank_count} cannot take an equal block of a "
                             f"{batch_size}-row batch")
        if rank_count > 1 and not (pad_last or drop_last):
            raise ValueError("rank blocks need whole node batches: pad_last or drop_last")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.prefetch_batches = max(1, prefetch_batches)
        self.seed = seed
        self.drop_last = drop_last
        self.pad_last = pad_last
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.rank_index = rank_index
        self.rank_count = rank_count

    @property
    def rank_batch_size(self) -> int:
        """The rows of each batch this loader yields: its block of a node batch."""
        return self.batch_size // self.rank_count

    def _epoch_indices(self, epoch: int) -> tuple[np.ndarray, int]:
        """This shard's index list and its count of non-duplicate entries (the
        JAX ``Loader._epoch_indices``): over several shards the index space is
        padded by wrap-around so that every shard has the same length, and the
        duplicates land at the end of each shard's list, so that the
        ``_valid`` prefix count of the final batch excludes them."""
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            idx = _fold_rng(self.seed, epoch, _PERM_SENTINEL).permutation(n)
        return shard_split(idx, self.shard_index, self.num_shards)

    def batches_per_epoch(self) -> int:
        return len(self._plan(0))

    def _node_plan(self, epoch: int) -> list:
        """The node's batch plan: a list of (index_chunk, n_valid, extra);
        ``extra`` is an opaque value handed to :meth:`_pre_collate` and
        :meth:`_finalize` (ShapeBucketedLoader's bucket shape)."""
        indices, n_real = self._epoch_indices(epoch)
        bs = self.batch_size
        plan = []
        for start in range(0, len(indices), bs):
            chunk = indices[start : start + bs]
            if len(chunk) < bs and self.drop_last:
                continue
            # the non-duplicate prefix of this chunk (see _epoch_indices)
            plan.append((chunk, max(0, min(len(chunk), n_real - start)), None))
        return plan

    def _plan(self, epoch: int) -> list:
        """This rank's batch plan: its block of each node batch
        (:func:`rank_block`), or the node plan itself on one rank
        (TokenSpaceLoader wraps it with its epoch and indices)."""
        plan = self._node_plan(epoch)
        if self.rank_count == 1:
            return plan
        return [(*rank_block(chunk, n_valid, self.batch_size, self.rank_index, self.rank_count), extra)
                for chunk, n_valid, extra in plan]

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
        bs = self.rank_batch_size
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
                    if self.rank_count > 1:
                        # the rank's _valid_mask and per-item _valid_hw; _valid
                        # stays an int32 array like every other batch's
                        batch = prepare_global_shard(batch, bs)
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
