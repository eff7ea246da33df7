"""Host ingestion throughput of the dataset and loader: one file per image
against packed record shards, on the Pillow and on the native path; the
counterpart of the TPU tool ``tools/ingest_bench.py``.

    python -m crossscore_tpu_torch.tools.ingest_bench [epochs] [--cpu]

It writes a seeded synthetic tree (270x360 images, two train scenes), packs
it twice (PNG payloads, and decoded ``CSRT`` payloads), and times full
epochs of ``data.loader.Loader`` over ``NvsDataset`` (K=5 references, 224 px
crops, SSIM maps, B=4, 4 threads) after one untimed epoch: items/s and
images/s (an item decodes a query, its score map and 5 references). Rows: files and PNG
shards on Pillow; files, PNG shards and decoded shards on the native
decoder (``data/fastimage.py``), when it builds. The work is the host's; the
tool prints the host's CPU count and, without ``--cpu``, the card's line of
the machine it ran on (it needs a card then, as the other tools do).
``--cpu`` runs one epoch of a one-scene tree on any machine.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time
from pathlib import Path

from crossscore_tpu_torch.tools._common import device_line, resolve_device

HW, K, CROP, BATCH, WORKERS = (270, 360), 5, 224, 4, 4


def run(epochs: int, scenes: int, root: Path) -> dict:
    """items/s of each (transport, decoder) row over ``epochs`` epochs."""
    from crossscore_tpu_torch.data import fastimage
    from crossscore_tpu_torch.data.loader import Loader
    from crossscore_tpu_torch.data.nvs_index import NvsDataset
    from crossscore_tpu_torch.data.records import pack
    from crossscore_tpu_torch.data.synthetic import generate

    generate(root / "data", hw=HW, scenes_per_split={"train": scenes, "test": 1})
    pack(root / "data", root / "packed", shard_mb=256, verbose=False)
    pack(root / "data", root / "decoded", shard_mb=256, verbose=False, decoded=True)
    kw = dict(dataset_path=str(root / "data"), resolution=None, data_split="train",
              neighbour_config={"cross": K, "strategy": "random"}, metric_type="ssim", metric_min=0,
              metric_max=1, crop_size=CROP)
    native = fastimage.available()
    if not native:
        print(f"native decoder unavailable: {fastimage.load_error()}", flush=True)
    rows = [("files / pillow", None, False), ("png shards / pillow", "packed", False)]
    if native:
        rows += [("files / native", None, True), ("png shards / native", "packed", True),
                 ("decoded shards / native", "decoded", True)]
    out = {}
    for tag, store, use_native in rows:
        os.environ.pop("CROSSSCORE_NO_NATIVE", None)
        if not use_native:
            os.environ["CROSSSCORE_NO_NATIVE"] = "1"
        try:
            ds = NvsDataset(**kw, record_dir=str(root / store) if store else None)
            loader = Loader(ds, batch_size=BATCH, num_workers=WORKERS, seed=0)
            for _ in loader.epoch(999):  # untimed: the page cache, the library's first load
                pass
            items = 0
            t0 = time.perf_counter()
            for ep in range(epochs):
                for b in loader.epoch(ep):
                    items += int(b["_valid"])
            dt = time.perf_counter() - t0
        finally:
            os.environ.pop("CROSSSCORE_NO_NATIVE", None)
        out[tag] = items / dt
        print(f"{tag:24s}: {items / dt:8.1f} items/s ({items * (K + 2) / dt:8.1f} images/s, {items} items in "
              f"{dt:.2f} s)", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0],
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("epochs", nargs="?", type=int, default=3, help="timed epochs (default 3)")
    ap.add_argument("--cpu", action="store_true", help="one epoch of a one-scene tree, no card needed")
    args = ap.parse_args(argv)
    device = resolve_device(args.cpu)
    if device is None:
        return 1
    print(device_line(device))
    print(f"host: {os.cpu_count()} CPUs, {len(os.sched_getaffinity(0))} usable; loader threads {WORKERS}; "
          f"{HW[0]}x{HW[1]} images, K={K}, crop {CROP}, B={BATCH}", flush=True)
    epochs, scenes = (1, 1) if args.cpu else (args.epochs, 2)
    with tempfile.TemporaryDirectory() as td:
        run(epochs, scenes, Path(td))
    return 0


if __name__ == "__main__":
    sys.exit(main())
