"""Token-space training: each full image goes through the frozen backbone
once, and training crops are windows of its token grid; the port's own copy
of ``crossscore_tpu/data/token_train.py``.

The backbone is frozen, so a full image's token grid is a constant of the
dataset. The loader encodes each distinct image once (the LRU and optional
disk store of ``data/token_cache.py``) and samples each training crop as a
patch-aligned window of the grid. The train step is then the decoder-only
graph (``models/crossscore.py``, ``query_tokens``): the (1+K) x B backbone
forwards per step are gone.

It differs from the reference's pixel crops (opt-in,
``this_main.token_space_train`` or ``this_main.train_recipe=token_fast``):

- a token's attention context is the full image, not the crop (the reference
  encodes the crop, reference ``task/core.py:119-161``);
- crop offsets are multiples of the 14 px patch, where the reference samples
  them per pixel (``crop.py:19-23``).

The supervision is the same: the score-map crop is the query window's pixels.

Tokens stay torch tensors on the host in the encoder's dtype (bf16 on the
card: numpy has no bf16); score maps stay numpy.
"""

from __future__ import annotations

import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from crossscore_tpu_torch.data import fastimage
from crossscore_tpu_torch.data.loader import Loader, _fold_rng
from crossscore_tpu_torch.data.nvs_index import leaf_datasets, unique_image_paths

# the window stream: the dataset's own per-item stream (seed, epoch, idx)
# draws the neighbours, and reusing it would tie windows to reference choices
_WINDOW_SEED_OFFSET = 7919


def _retain_malloc_arena() -> None:
    """Keep glibc's arena mapped for the per-batch window tensors.

    A token batch is ~144 MiB of new host tensors (B=24, K=5, 37x37
    windows, D=384 bf16). glibc serves allocations that large by mmap and
    unmaps them when they are freed, so every batch faults its pages in
    again. A 1 GiB mmap threshold and no trimming keep the freed arena
    mapped for the next batch: on the 8-core host of an H100 machine this
    took ``_finalize`` from 160.85 to 29.18 ms a batch (median, one thread;
    ``tools/token_assembly_bench.py``). Process-wide and resident by design
    (a training host wants its working set mapped); a no-op off glibc."""
    import ctypes

    try:
        libc = ctypes.CDLL("libc.so.6")
        libc.mallopt(ctypes.c_int(-1), ctypes.c_int(2**31 - 1))  # M_TRIM_THRESHOLD
        libc.mallopt(ctypes.c_int(-3), ctypes.c_int(1 << 30))    # M_MMAP_THRESHOLD
    except (OSError, AttributeError):
        pass


def aligned_window(full_grid: tuple[int, int], crop_grid: tuple[int, int], rng: np.random.Generator,
                   deterministic: bool = False) -> tuple[int, int]:
    """Top-left (i, j) of a crop window in patch units; deterministic mode is
    the top-left corner (the reference's rule, ``crop.py:19-23``)."""
    gh, gw = full_grid
    ch, cw = crop_grid
    if gh < ch or gw < cw:
        raise ValueError(f"crop grid {crop_grid} larger than image grid {full_grid}")
    if deterministic:
        return 0, 0
    return int(rng.integers(0, gh - ch + 1)), int(rng.integers(0, gw - cw + 1))


def crop_token_grid(tokens: torch.Tensor, grid: tuple[int, int], ij: tuple[int, int],
                    crop_grid: tuple[int, int], out: torch.Tensor | None = None) -> torch.Tensor:
    """The (..., ch*cw, D) window at ``ij`` of a (..., gh*gw, D) token tensor,
    as a new contiguous tensor or copied into ``out`` (one strided copy,
    no intermediate)."""
    gh, gw = grid
    ch, cw = crop_grid
    i, j = ij
    lead, d = tokens.shape[:-2], tokens.shape[-1]
    window = tokens.reshape(*lead, gh, gw, d)[..., i:i + ch, j:j + cw, :]
    if out is None:
        return window.reshape(*lead, ch * cw, d)
    out.view(*lead, ch, cw, d).copy_(window)
    return out


def token_working_set(prefetch_batches: int, batch_size: int, k: int) -> int:
    """The token cache's in-flight working set: 2 x (prefetch + 1) batches of
    B*(1+K) image grids. The ``train_recipe=token_fast`` cache sizing
    (tasks/train.py) uses it too."""
    return 2 * (prefetch_batches + 1) * batch_size * (k + 1)


class TokenSpaceLoader(Loader):
    """Loader whose batches carry token windows instead of pixel crops.

    Wraps a dataset built without pixel cropping (``crop_mode=
    "integer_patches"``, ``return_item_paths=True``): items are full images
    trimmed to whole patches, with their paths. The workers decode them; this
    loader's producer thread encodes the cache's misses through the frozen
    backbone (overlapping the train step) and slices aligned windows:

    - the query's window is the score map's (reference ``RandomCropperBatchSame``);
    - each reference view has its own window (``...BatchSeparate``).

    Batch keys: ``query/tokens`` (B, ch*cw, D) and ``reference/cross/tokens``
    (B, K, ch*cw, D), host tensors; ``query/score_map`` (B, ch*14, cw*14)
    numpy; ``_valid``.
    """

    def __init__(self, dataset, cache, crop_size: int, patch: int = 14,
                 deterministic_crop: bool = False, **kw):
        # read on the leaves, so that a multi-root corpus (ConcatDataset) is
        # checked too (the JAX package reads the dataset itself and refuses one)
        leaves = leaf_datasets(dataset)
        if any(getattr(leaf, "query_crop", None) is not None for leaf in leaves):
            raise ValueError("TokenSpaceLoader needs an uncropped dataset "
                             "(crop_mode='integer_patches'); it crops in token space")
        if not all(getattr(leaf, "return_item_paths", False) for leaf in leaves):
            raise ValueError("TokenSpaceLoader needs return_item_paths=true")
        if crop_size % patch:
            raise ValueError(f"crop_size {crop_size} must be a multiple of {patch}")
        super().__init__(dataset, **kw)
        self.cache = cache
        self.patch = patch
        self.crop_grid = (crop_size // patch, crop_size // patch)
        self.deterministic_crop = deterministic_crop
        self._slice_pool = None  # made on first use, kept for the loader's life
        self._check_cache_capacity(dataset, cache)
        _retain_malloc_arena()

    def _check_cache_capacity(self, dataset, cache) -> None:
        """Refuse an undersized cache at start-up, not mid-epoch. With the
        native decoder the train CLI sets the decode-skip hooks, so a cached
        image arrives as placeholder pixels; an entry evicted between a
        loader thread's ``has`` and the consuming ``gather`` cannot be
        encoded again, and the exposure spans the prefetch pipeline
        (:func:`token_working_set`). So this raises where there is no disk
        store and the native decoder is present, as the JAX package does,
        and warns otherwise (a disk store turns an eviction into a reload;
        without the decoder every slot carries pixels and an eviction is
        encoded again). A cache that holds the whole corpus never evicts, so
        the corpus bounds the need; cache keys carry the image's shape, so a
        path read by leaves of different geometry holds one key per
        geometry: (resize_short_side, crop_mode) per leaf. The JAX package
        counts resize_short_side only, and under-counts leaves that share a
        resize but trim differently."""
        leaves = leaf_datasets(dataset)
        k = max((int(leaf.neighbour_config.get("cross", 0)) for leaf in leaves), default=0)
        # per rank: a rank's cache holds the images of its own rows
        need = token_working_set(self.prefetch_batches, self.rank_batch_size, k)
        n_geoms = len({(getattr(leaf, "resize_short_side", None) or -1, getattr(leaf, "crop_mode", None))
                       for leaf in leaves}) or 1
        need = min(need, len(unique_image_paths(dataset)) * n_geoms)
        if cache._max >= need:
            return
        msg = (f"token cache max_items={cache._max} is below the in-flight working set ~{need} "
               f"(2 x {self.prefetch_batches + 1} batches x batch_size {self.rank_batch_size} x (K+1)={k + 1}); "
               f"eviction races with the decode skip: raise this_main.ref_token_cache_max_items to >= {need}")
        if cache._dir is None and fastimage.available():
            raise ValueError(msg)
        warnings.warn(msg + (" (disk store present: evictions degrade to reloads)" if cache._dir is not None
                             else " (no native decoder: the decode skip is off, evictions degrade to re-encodes)"),
                      RuntimeWarning, stacklevel=3)

    def _plan(self, epoch: int) -> list:
        return [(chunk, n_valid, {"epoch": epoch, "indices": chunk})
                for chunk, n_valid, _ in super()._plan(epoch)]

    def _finalize(self, batch: dict, extra) -> dict:
        q = batch["query/img"]                # (B, H, W, 3) full images
        sm = batch["query/score_map"]         # (B, H, W)
        refs = batch["reference/cross/imgs"]  # (B, K, H, W, 3)
        paths = batch["item_paths"]
        b, k = refs.shape[:2]
        p = self.patch
        full_grid = (q.shape[1] // p, q.shape[2] // p)
        ch, cw = self.crop_grid

        # full-image grids, encoded once per (path, shape); [b][k] lists of
        # the cache's own tensors: windows are copied straight out of them.
        # With the decode skip the dataset emits placeholder pixels for the
        # cached images (queries and references) and gather resolves those
        # slots from the cache: once it is warm only score maps are decoded
        q_skip = batch.get("query/skipped")
        q_grids = self.cache.gather([list(paths["query/img"])], q[:, None], stack=False,
                                    skipped=None if q_skip is None else q_skip[:, None])
        r_grids = self.cache.gather(paths["reference/cross/imgs"], refs, stack=False,
                                    skipped=batch.get("reference/skipped"))
        tok_dtype, tok_d = q_grids[0][0].dtype, q_grids[0][0].shape[-1]

        # per-item windows; a pad_last batch repeats its final index, and the
        # same stream gives the duplicate the same windows (true duplicates
        # for the _valid weights, as on the pixel path)
        idxs = list(extra["indices"]) + [extra["indices"][-1]] * (b - len(extra["indices"]))
        q_toks = torch.empty((b, ch * cw, tok_d), dtype=tok_dtype)
        r_toks = torch.empty((b, k, ch * cw, tok_d), dtype=tok_dtype)
        sm_crops = np.empty((b, ch * p, cw * p), sm.dtype)

        def slice_item(bb: int) -> None:
            # one stream per item, so the order of the pool's work changes nothing
            rng = _fold_rng(self.seed + _WINDOW_SEED_OFFSET, extra["epoch"], int(idxs[bb]))
            i, j = aligned_window(full_grid, self.crop_grid, rng, self.deterministic_crop)
            crop_token_grid(q_grids[bb][0], full_grid, (i, j), self.crop_grid, out=q_toks[bb])
            sm_crops[bb] = sm[bb, i * p:(i + ch) * p, j * p:(j + cw) * p]
            for kk in range(k):
                ij = aligned_window(full_grid, self.crop_grid, rng, self.deterministic_crop)
                crop_token_grid(r_grids[bb][kk], full_grid, ij, self.crop_grid, out=r_toks[bb, kk])

        # the copies release the GIL, so items slice in parallel
        if self.num_workers > 1 and b > 1:
            if self._slice_pool is None:
                self._slice_pool = ThreadPoolExecutor(self.num_workers)
            list(self._slice_pool.map(slice_item, range(b)))
        else:
            for bb in range(b):
                slice_item(bb)
        return {"query/tokens": q_toks, "reference/cross/tokens": r_toks, "query/score_map": sm_crops}
