"""CLI: pack a dataset tree into record shards for sequential reads; the
port's counterpart of ``crossscore_tpu/data/pack.py``.

Usage:
    python -m crossscore_tpu_torch.data.pack <dataset_root> <out_dir> [shard_mb] [workers] [--decoded]

Then train, test or predict with ``data.dataset.record_dir=<out_dir>``.
``workers > 1`` packs in parallel processes (the result holds the same
records as a one-process pack). ``--decoded`` stores pre-decoded raw tensors
instead of PNG bytes (no decode when reading; ~1.5-2.3x the bytes on disk).
See crossscore_tpu_torch/data/records.py.
"""

from __future__ import annotations

import sys

from crossscore_tpu_torch.data.records import pack


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    decoded = "--decoded" in argv
    argv = [a for a in argv if a != "--decoded"]
    if len(argv) < 2:
        print(__doc__)
        raise SystemExit(2)
    shard_mb = int(argv[2]) if len(argv) > 2 else 512
    workers = int(argv[3]) if len(argv) > 3 else 1
    return pack(argv[0], argv[1], shard_mb=shard_mb, workers=workers, decoded=decoded)


if __name__ == "__main__":
    main()
