"""Offline token encoding: fill the full-image token store of a corpus; the
port's counterpart of ``crossscore_tpu/tasks/encode_tokens.py``.

Token-space training (``this_main.token_space_train``, ``data/token_train.py``)
encodes each distinct image once through the frozen backbone during its first
epoch. This CLI pays that epoch ahead of time: it walks the dataset index,
encodes every query render and every reference-pool capture at the training
resolution, and writes the tokens to the disk store
(``this_main.ref_token_cache_dir``). A training run pointed at the same store
encodes nothing.

    python -m crossscore_tpu_torch.tasks.encode_tokens \\
        'data.dataset.path=[<root>]' trainer.ckpt_path_to_load=<ckpt> \\
        this_main.ref_token_cache_dir=<store>

A reference pool smaller than K pads its slots with the empty placeholder
(the dataset's zero image); the store holds its tokens too, at each training
shape. Images already in the store are neither decoded nor encoded again, so
a run over a partly filled store resumes it.

The store holds what the loader of the run it serves would encode: each image
is decoded by the dataset itself (``NvsDataset.load_image``: the native
decoder where it builds, else Pillow; its resize, trim and wire). When that
run puts uint8 pixels on the wire (``data.dataset.wire_uint8``, which
``this_main.train_recipe=token_fast`` turns on), the resized pixels are
rounded to uint8 as the dataset rounds them and the encoder normalises them
on the device; otherwise they are normalised in fp32 on the host. The JAX
package normalises the unrounded Pillow pixels in both cases.

Several processes may write one store (``data/token_cache.py``); split a large
corpus over them with ``this_main.encode_shard=i/n`` (each encodes every n-th
image). Tokens are a function of the backbone's weights: key the store's
directory by checkpoint.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from PIL import Image

from crossscore_tpu_torch.data.nvs_index import get_dataset, to_wire_uint8, unique_image_paths
from crossscore_tpu_torch.data.samplers import EMPTY_IMAGE
from crossscore_tpu_torch.data.token_cache import RefTokenCache
from crossscore_tpu_torch.io.images import normalize_imagenet
from crossscore_tpu_torch.models import CrossScoreConfig, CrossScoreNet
from crossscore_tpu_torch.models.crossscore import make_backbone_encoder
from crossscore_tpu_torch.tasks.common import (
    load_model_params, parse_cli, refuse_tensor_parallel, resolve_accelerator,
)
from crossscore_tpu_torch.tasks.train import apply_train_recipe
from crossscore_tpu_torch.utils import compilation_cache


def parse_shard(shard) -> tuple[int, int]:
    """``this_main.encode_shard`` "i/n" -> (i, n), 0 <= i < n."""
    i, n = (int(x) for x in str(shard).split("/"))
    if not 0 <= i < n:
        raise ValueError(f"this_main.encode_shard must be i/n with 0 <= i < n, got {shard!r}")
    return i, n


def encode_tokens(cfg) -> int:
    """Encode this shard's images into the store; returns how many it walked."""
    refuse_tensor_parallel(str(cfg.model.gpu.attention_impl))
    device = resolve_accelerator(cfg)
    compilation_cache.enable()
    store_dir = cfg.this_main.get("ref_token_cache_dir")
    if not store_dir:
        raise ValueError("encode_tokens requires this_main.ref_token_cache_dir")

    # the config of the run the store serves: token_fast puts uint8 on the wire
    apply_train_recipe(cfg)
    ds = get_dataset(cfg, cfg.this_main.get("data_split", "train"), crop_mode="integer_patches",
                     return_item_paths=True, resize_short_side=cfg.this_main.resize_short_side)
    i_sh, n_sh = parse_shard(cfg.this_main.get("encode_shard", "0/1"))
    paths = unique_image_paths(ds)[i_sh::n_sh]

    mcfg = CrossScoreConfig.from_config(cfg)
    if cfg.trainer.ckpt_path_to_load is None:
        print("WARNING: the tokens match only a training run that starts from the same seeded init")
    model = load_model_params(cfg, CrossScoreNet(mcfg, device=device))
    encoder = make_backbone_encoder(mcfg)
    # the loader of a uint8-wire run rounds the resized pixels before the encoder sees them
    wire_uint8 = bool(cfg.data.dataset.get("wire_uint8", False))
    enc_batch = int(cfg.this_main.get("ref_token_cache_encode_batch", 16))
    cache = RefTokenCache(
        lambda imgs, valid_hw=None: encoder(model, torch.from_numpy(imgs).to(device)),
        encode_batch=enc_batch,
        max_items=enc_batch,  # streamed through: the disk store is the product
        persist_dir=store_dir,
    )
    probe = ds.datasets[0] if hasattr(ds, "datasets") else ds

    def shape_of(path: str) -> tuple[int, int]:
        """The training shape of ``path`` from its header alone."""
        with Image.open(path) as im:
            w, h = im.size
        return probe.resized_hw(h, w)

    def load(item: tuple) -> np.ndarray:
        """The pixels the training loader hands the encoder for ``item``: the
        dataset's own decode (native or Pillow), resize, trim and wire."""
        path, hw = item
        if path != EMPTY_IMAGE:
            return probe.load_image(path)
        img = np.zeros((*hw, 3), np.float32)
        return to_wire_uint8(img) if wire_uint8 else normalize_imagenet(img).astype(np.float32)

    hws = [shape_of(p) for p in paths]
    todo = [(p, hw) for p, hw in zip(paths, hws) if not cache.has(p, hw)]
    stored = len(paths) - len(todo)
    todo += [(EMPTY_IMAGE, hw) for hw in sorted(set(hws)) if not cache.has(EMPTY_IMAGE, hw)]
    print(f"encode_tokens: {len(paths)} images, {stored} already in the store", flush=True)
    with ThreadPoolExecutor(max(1, int(cfg.data.loader.train.num_workers))) as pool:
        for i0 in range(0, len(todo), enc_batch):
            chunk = todo[i0:i0 + enc_batch]
            imgs = list(pool.map(load, chunk))
            shapes = {im.shape for im in imgs}
            if len(shapes) != 1:
                raise ValueError(f"mixed post-resize shapes in one dataset: {sorted(shapes)}; "
                                 "token-space training needs one training resolution")
            cache.gather([[p for p, _ in chunk]], np.stack(imgs)[:, None])  # one view of len(chunk) items
            if (i0 // enc_batch) % 20 == 0:
                print(f"encode_tokens: {i0 + len(chunk)}/{len(todo)} encoded", flush=True)
    print(f"encode_tokens done: {len(paths)} images, {stored} were already in the store -> {store_dir}",
          flush=True)
    return len(paths)


def main(argv=None):
    return encode_tokens(parse_cli("default", argv))


if __name__ == "__main__":
    main()
