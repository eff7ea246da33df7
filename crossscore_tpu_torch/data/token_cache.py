"""Reference-token cache: each reference image goes through the frozen
backbone once per predict run; the port's own copy of
``crossscore_tpu/data/token_cache.py``.

The reference pipeline re-encodes every reference view for every query
(reference ``task/core.py:119-161``: 1+K ViT forwards per score map), although
the backbone is frozen and one reference directory serves all queries
(``task/predict.py`` + ``simple_reference.py``). A frozen backbone makes a
reference's tokens a pure function of its pixels, so with the cache warm a
score map costs one ViT forward and a decoder pass. The tokens are reused
verbatim; the score maps match an uncached run to float reduction-order noise
(the backbone runs on ``encode_batch`` chunks instead of one B*(1+K) batch).

Design:
- misses are encoded in fixed-size batches (the last chunk padded), so the
  encoder always sees one shape;
- tokens stay on the host as (N_patch, D) CPU tensors in the compute dtype
  (~1 MB each at 518 px, D=384); the caller moves the assembled
  (B, K, N, D) batch to the device. An LRU bounds host memory;
- keys are (path, mtime, pixel shape[, valid extent]): the predict path crops
  deterministically, and the mtime guards against files rewritten mid-run.
  Under shape bucketing the pixel shape is the bucket and the valid extent
  the item's true (h, w): tokens are a function of both.

The loader may skip the decode of an image whose tokens are cached (the
native fused path's ``ref_pixel_skip`` / ``query_pixel_skip`` hooks, set to
:meth:`RefTokenCache.has`): such a slot carries placeholder pixels, and
``gather(..., skipped=)`` resolves it from the cache alone. The token-space
loader (``data/token_train.py``) reads the grids unstacked.
"""

from __future__ import annotations

import hashlib
import os
import threading
import time
from collections import OrderedDict
from pathlib import Path
from typing import Callable

import numpy as np
import torch


class RefTokenCache:
    def __init__(
        self,
        encode_fn: Callable[..., torch.Tensor],
        encode_batch: int = 16,
        max_items: int = 2048,
        persist_dir=None,
    ):
        """:param encode_fn: ``(imgs (B, H, W, 3) numpy, valid_hw (B, 2) or
            None) -> (B, N_patch, D)`` tensor: the frozen backbone
            (``models.crossscore.make_backbone_encoder``).
        :param encode_batch: the fixed miss-encoding batch.
        :param max_items: the host LRU bound.
        :param persist_dir: optional directory of a disk-backed store: tokens
            survive process restarts. Keys include the file mtime, so
            re-rendered references re-encode; the caller keys the directory
            by checkpoint (other weights give other tokens)."""
        self._encode = encode_fn
        self._batch = int(encode_batch)
        self._max = int(max_items)
        self._cache: OrderedDict[tuple, torch.Tensor] = OrderedDict()
        # loader worker threads and the consuming thread may both touch the
        # LRU; check-then-act sequences need one lock
        self._lock = threading.Lock()
        self._dir = Path(persist_dir) if persist_dir else None
        if self._dir is not None:
            self._dir.mkdir(parents=True, exist_ok=True)
            # sweep tmp files orphaned by crashed writers (older than an hour;
            # live writers replace theirs within milliseconds)
            cutoff = time.time() - 3600
            for t in self._dir.glob("*.tmp.*.npz"):
                try:
                    if t.stat().st_mtime < cutoff:
                        t.unlink()
                except OSError:
                    pass  # another sweeper got it first
        self.hits = 0
        self.misses = 0
        self.skipped_decodes = 0  # slots whose host decode the loader skipped
        self.disk_hits = 0

    @staticmethod
    def _key(path: str, hw: tuple, valid: "tuple | None" = None) -> tuple:
        """``hw``: the pixel shape the encoder sees (the bucket shape under
        shape bucketing); ``valid``: the item's true (h, w) when the pixels
        are bucket-padded."""
        try:
            mtime = Path(path).stat().st_mtime_ns
        except OSError:
            mtime = 0
        key = (path, mtime, (int(hw[0]), int(hw[1])))
        if valid is not None and tuple(int(v) for v in valid) != key[2]:
            key = key + ((int(valid[0]), int(valid[1])),)
        return key

    # ------------------------------------------------------- disk persistence

    def _disk_path(self, key: tuple) -> Path:
        return self._dir / (hashlib.sha1(repr(key).encode()).hexdigest() + ".npz")

    def _disk_load(self, key: tuple):
        """Host-miss fallback: the persistent store's entry, or None."""
        if self._dir is None:
            return None
        p = self._disk_path(key)
        if not p.exists():
            return None
        try:
            with np.load(p) as z:
                dtype = getattr(torch, str(z["dtype"]).removeprefix("torch."))
                tokens = torch.from_numpy(z["data"].copy()).view(dtype).reshape(tuple(z["shape"]))
        except (OSError, ValueError, KeyError, AttributeError, RuntimeError):
            return None  # a partial or corrupt write: a miss, re-encoded
        self.disk_hits += 1
        self._put(key, tokens, write_disk=False)
        return tokens

    def _disk_store(self, key: tuple, tokens: torch.Tensor) -> None:
        p = self._disk_path(key)
        # one tmp name per writer: concurrent writers of one key must not race
        # on a shared tmp file; the last replace wins and every file is whole
        tmp = p.with_suffix(f".tmp.{os.getpid()}.{threading.get_ident()}.npz")
        np.savez(tmp, data=tokens.contiguous().view(torch.uint8).numpy(),
                 shape=np.asarray(tokens.shape), dtype=str(tokens.dtype))
        tmp.replace(p)

    def has(self, path: str, hw: tuple) -> bool:
        """True when the tokens of ``path`` at the pixel shape ``hw`` are in
        the host LRU (which this touches, so that the entry is not evicted
        before a ``gather`` consumes it) or in the disk store (loaded into
        the LRU)."""
        key = self._key(path, hw)
        with self._lock:
            try:
                self._cache.move_to_end(key)
                return True
            except KeyError:
                pass
        return self._disk_load(key) is not None

    def gather(self, ref_paths: list[list[str]], ref_imgs: np.ndarray, skipped=None, valid_hw=None,
               stack: bool = True):
        """:param ref_paths: per-view path lists ``[k][b]`` (the collated
            ``batch["item_paths"]["reference/cross/imgs"]`` layout).
        :param ref_imgs: (B, K, H, W, 3) host pixels.
        :param skipped: optional (B, K) bools: slots whose pixels are
            placeholders because the loader skipped their decode on a cache
            hit. Each resolves from the host LRU, the disk store, or a slot
            of the same batch that carries the same image's pixels (whose
            miss encode fills the key); with none of them it raises (raise
            ``max_items``).
        :param valid_hw: optional true pixel extents of bucket-padded
            batches, (B, 2) per item or (2,) shared: an item's K refs share
            its extent; misses encode with the mask and are keyed by it.
        :param stack: False returns ``[b][k]`` lists of the cache's own
            (N_patch, D) host tensors, without a stacked copy (token-space
            training slices windows out of them); callers only read them.
        :return: (B, K, N_patch, D) host tokens in encode_fn's dtype, or the
            ``[b][k]`` lists."""
        b, k = ref_imgs.shape[:2]
        if valid_hw is None:
            valids = [None] * b
        else:
            vhw = np.asarray(valid_hw)
            valids = [tuple(vhw)] * b if vhw.ndim == 1 else [tuple(v) for v in vhw]
        keys = [[self._key(ref_paths[kk][bb], ref_imgs.shape[2:4], valids[bb]) for kk in range(k)]
                for bb in range(b)]

        # unique misses in first-occurrence order. Skipped slots are checked
        # after the miss pass, so that an entry evicted between a loader
        # thread's has() and this gather is rescued by another slot of the
        # batch that carries the same image's pixels
        miss: "OrderedDict[tuple, tuple]" = OrderedDict()
        n_miss_slots = n_skipped = 0
        skipped_keys = []
        for bb in range(b):
            for kk in range(k):
                key = keys[bb][kk]
                if skipped is not None and skipped[bb][kk]:
                    n_skipped += 1
                    skipped_keys.append(key)
                    continue
                with self._lock:
                    in_ram = key in self._cache
                if key in miss:
                    n_miss_slots += 1
                elif not in_ram and self._disk_load(key) is None:
                    miss[key] = (ref_imgs[bb, kk], valids[bb])
                    n_miss_slots += 1
        for key in skipped_keys:
            with self._lock:
                in_ram = key in self._cache
            if not in_ram and key not in miss and self._disk_load(key) is None:
                raise RuntimeError(f"decode-skipped reference evicted from the token cache before use: {key[0]} — "
                                   "raise this_main.ref_token_cache_max_items")
        # a skipped slot resolves from the cache by construction: it counts
        # as a decode skip, not as a hit
        self.skipped_decodes += n_skipped
        self.hits += b * k - n_skipped - n_miss_slots
        self.misses += len(miss)

        if miss:
            miss_keys = list(miss)
            imgs = np.stack([v[0] for v in miss.values()])
            miss_valid = [v[1] for v in miss.values()]
            for i0 in range(0, len(miss_keys), self._batch):
                chunk = imgs[i0:i0 + self._batch]
                n_valid = len(chunk)
                if n_valid < self._batch:  # pad to the fixed batch
                    pad = np.broadcast_to(chunk[-1:], (self._batch - n_valid, *chunk.shape[1:]))
                    chunk = np.concatenate([chunk, pad])
                vchunk = None
                if valid_hw is not None:
                    vchunk = miss_valid[i0:i0 + self._batch]
                    vchunk = np.asarray(vchunk + [vchunk[-1]] * (self._batch - len(vchunk)), np.int32)
                tokens = self._encode(chunk, vchunk).cpu()
                for j in range(n_valid):
                    self._put(miss_keys[i0 + j], tokens[j].clone())

        grids = [[self._get(keys[bb][kk]) for kk in range(k)] for bb in range(b)]
        return torch.stack([torch.stack(row) for row in grids]) if stack else grids

    def _put(self, key: tuple, tokens: torch.Tensor, write_disk: bool = True) -> None:
        with self._lock:
            self._cache[key] = tokens
            self._cache.move_to_end(key)
            while len(self._cache) > self._max:
                self._cache.popitem(last=False)
        if write_disk and self._dir is not None:
            self._disk_store(key, tokens)

    def _get(self, key: tuple) -> torch.Tensor:
        with self._lock:
            try:
                self._cache.move_to_end(key)
                return self._cache[key]
            except KeyError:
                pass
        # evicted between the miss pass and this read (a batch holding more
        # distinct references than max_items); the disk store may still hold it
        tokens = self._disk_load(key)
        if tokens is None:
            raise RuntimeError(
                f"reference tokens evicted from the token cache before use: {key[0]} — "
                "raise this_main.ref_token_cache_max_items"
            )
        return tokens

    def __len__(self) -> int:
        with self._lock:
            return len(self._cache)
