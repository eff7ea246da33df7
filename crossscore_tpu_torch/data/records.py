"""Record shards for ingesting a corpus of many PNGs; the port's own copy of
``crossscore_tpu/data/records.py``. Shards and ``index.npz`` are the same
format in both packages, so either reads what the other packed.

The reference trains from ~2 TB of individual PNGs (reference
``README.md:53-57``): at production batch sizes, hundreds of open()+read()
calls and random seeks per step. This module packs the corpus into a few
large shard files with a compact binary index, so the host pipeline does
large sequential reads:

- ``pack``: walks a dataset root, appends each file's bytes to
  ``shard-NNNNN.bin`` files (512 MB by default) and writes ``index.npz``
  (keys and per-record shard/offset/length arrays). Payloads stay
  PNG-encoded: the decode costs the same, the gain is I/O locality and
  fewer open files.
- ``pack(..., decoded=True)``: payloads are pre-decoded raw tensors (a
  "CSRT" header + uint8 HWC / uint16 HW bytes, :func:`encode_raw_payload`):
  a sample then costs a pread and one fused crop/normalise pass in C
  (``data/fastimage.py``), no PNG inflate. Raw uint8 540x720 RGB is ~1.17 MB
  against ~0.5-0.8 MB of PNG, so the corpus grows ~1.5-2.3x on disk. PNG is
  lossless, so the stored tensor is the decode's output byte for byte.
- ``RecordStore``: one fd per shard; ``read`` uses ``os.pread`` (thread-safe,
  no seek contention between loader threads).

CLI::

    python -m crossscore_tpu_torch.data.pack <dataset_root> <out_dir> [shard_mb] [workers] [--decoded]

Datasets opt in with ``data.dataset.record_dir=<out_dir>``; keys are POSIX
paths relative to the dataset root, so the dataset's index (``split.json``
and the directory walk) stays on the filesystem unchanged.
"""

from __future__ import annotations

import os
import struct
from pathlib import Path
from typing import Iterable, Optional

import numpy as np

_INDEX = "index.npz"
RAW_MAGIC = b"CSRT"


def encode_raw_payload(path: str | Path) -> bytes:
    """Decode one image file into the raw-tensor payload format consumed by
    the native loaders (fastimage ``fi_*_raw``): 8-bit images become uint8
    (H, W, 3) RGB; 16-bit gray metric maps become uint16 (H, W)."""
    from PIL import Image

    with Image.open(path) as im:
        if im.mode in ("I", "I;16", "I;16B", "I;16L"):
            arr = np.asarray(im).astype(np.uint16)
            dtype_code, channels = 1, 1
        else:
            arr = np.asarray(im.convert("RGB"))
            dtype_code, channels = 0, 3
    h, w = arr.shape[:2]
    header = RAW_MAGIC + bytes([1, dtype_code, channels, 0]) + struct.pack("<II", h, w)
    return header + np.ascontiguousarray(arr).tobytes()


def decode_raw_payload(data: bytes) -> np.ndarray:
    """numpy fallback decode (the native path uses fastimage ``fi_*_raw``):
    returns uint8 (H, W, 3) or uint16 (H, W)."""
    if data[:4] != RAW_MAGIC or data[4] != 1:
        raise ValueError("not a CSRT raw-tensor payload")
    dtype_code, channels = data[5], data[6]
    h, w = struct.unpack("<II", data[8:16])
    dt = np.uint16 if dtype_code == 1 else np.uint8
    shape = (h, w) if channels == 1 else (h, w, channels)
    return np.frombuffer(data, dt, count=h * w * channels, offset=16).reshape(shape)


class RecordWriter:
    def __init__(self, out_dir: str | Path, shard_mb: int = 512):
        self.out_dir = Path(out_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self.shard_bytes = shard_mb * 1024 * 1024
        self._keys: list[str] = []
        self._shard: list[int] = []
        self._offset: list[int] = []
        self._length: list[int] = []
        self._cur_idx = -1
        self._cur_f = None
        self._cur_size = 0
        self._roll()

    def _roll(self):
        if self._cur_f is not None:
            self._cur_f.close()
        self._cur_idx += 1
        self._cur_f = open(self.out_dir / f"shard-{self._cur_idx:05d}.bin", "wb")
        self._cur_size = 0

    def write(self, key: str, payload: bytes) -> None:
        if self._cur_size > 0 and self._cur_size + len(payload) > self.shard_bytes:
            self._roll()
        self._keys.append(key)
        self._shard.append(self._cur_idx)
        self._offset.append(self._cur_size)
        self._length.append(len(payload))
        self._cur_f.write(payload)
        self._cur_size += len(payload)

    def close(self) -> None:
        self._cur_f.close()
        np.savez(
            self.out_dir / _INDEX,
            keys=np.asarray("\n".join(self._keys).encode()),
            shard=np.asarray(self._shard, np.uint32),
            offset=np.asarray(self._offset, np.uint64),
            length=np.asarray(self._length, np.uint64),
        )

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class RecordStore:
    """Read side: one fd per shard, thread-safe pread access by key."""

    def __init__(self, directory: str | Path):
        self.directory = Path(directory)
        with np.load(self.directory / _INDEX) as idx:
            keys = bytes(idx["keys"]).decode().split("\n")
            self._index = {
                k: (int(s), int(o), int(n))
                for k, s, o, n in zip(keys, idx["shard"], idx["offset"], idx["length"])
            }
        n_shards = 1 + max((s for s, _, _ in self._index.values()), default=-1)
        self._fds = [
            os.open(self.directory / f"shard-{i:05d}.bin", os.O_RDONLY)
            for i in range(n_shards)
        ]

    def __contains__(self, key: str) -> bool:
        return key in self._index

    def __len__(self) -> int:
        return len(self._index)

    def keys(self):
        return self._index.keys()

    def read(self, key: str) -> bytes:
        shard, offset, length = self._index[key]
        return os.pread(self._fds[shard], length, offset)

    def close(self) -> None:
        for fd in self._fds:
            os.close(fd)
        self._fds = []


def _pack_chunk(args) -> int:
    """Worker: pack one contiguous file chunk into its own sub-directory.
    Module-level (picklable for ProcessPoolExecutor)."""
    root, sub_dir, files, shard_mb, decoded = args
    root = Path(root)
    with RecordWriter(sub_dir, shard_mb=shard_mb) as w:
        for f in files:
            payload = encode_raw_payload(f) if decoded else Path(f).read_bytes()
            w.write(Path(f).relative_to(root).as_posix(), payload)
    return w._cur_idx + 1  # shards written


def _merge_worker_dirs(out_dir: Path, sub_dirs: list[Path]) -> None:
    """Renumber per-worker shards into one global sequence and write the
    merged index; per-chunk record contiguity is preserved."""
    keys: list[str] = []
    shard: list[np.ndarray] = []
    offset: list[np.ndarray] = []
    length: list[np.ndarray] = []
    base = 0
    for sub in sub_dirs:
        with np.load(sub / _INDEX) as idx:
            keys.extend(bytes(idx["keys"]).decode().split("\n"))
            shard.append(idx["shard"].astype(np.uint32) + base)
            offset.append(idx["offset"])
            length.append(idx["length"])
            n_shards = 1 + int(idx["shard"].max()) if len(idx["shard"]) else 0
        for i in range(n_shards):
            (sub / f"shard-{i:05d}.bin").rename(out_dir / f"shard-{base + i:05d}.bin")
        (sub / _INDEX).unlink()
        sub.rmdir()
        base += n_shards
    np.savez(
        out_dir / _INDEX,
        keys=np.asarray("\n".join(keys).encode()),
        shard=np.concatenate(shard) if shard else np.zeros(0, np.uint32),
        offset=np.concatenate(offset) if offset else np.zeros(0, np.uint64),
        length=np.concatenate(length) if length else np.zeros(0, np.uint64),
    )


def pack(
    root: str | Path,
    out_dir: str | Path,
    shard_mb: int = 512,
    patterns: Iterable[str] = ("*.png", "*.jpg", "*.jpeg"),
    verbose: bool = True,
    workers: int = 1,
    decoded: bool = False,
) -> int:
    """Pack every image under ``root`` into shards at ``out_dir``.

    Returns the number of records. Keys are POSIX relative paths; files are
    walked in sorted order so records of one scene/iteration are contiguous
    (sequential reads during in-order evaluation).

    ``workers > 1`` packs contiguous chunks in parallel processes (each into
    private shards, renumbered into one global sequence afterwards) — at the
    2 TB corpus scale packing is read-IO bound and parallelises linearly
    until the source disk saturates. The resulting store is byte-identical
    in content and key->payload mapping to a single-process pack (shard
    boundaries may differ; readers only use the index)."""
    root = Path(root)
    out_path = Path(out_dir)
    files: list[Path] = []
    for pat in patterns:
        files.extend(root.rglob(pat))
    files = sorted(set(files))

    workers = max(1, min(int(workers), len(files) or 1))
    if workers == 1:
        with RecordWriter(out_dir, shard_mb=shard_mb) as w:
            for f in files:
                payload = encode_raw_payload(f) if decoded else f.read_bytes()
                w.write(f.relative_to(root).as_posix(), payload)
        n_shards = w._cur_idx + 1
    else:
        from concurrent.futures import ProcessPoolExecutor

        out_path.mkdir(parents=True, exist_ok=True)
        step = (len(files) + workers - 1) // workers
        chunks = [files[i:i + step] for i in range(0, len(files), step)]
        sub_dirs = [out_path / f"tmp-w{i:03d}" for i in range(len(chunks))]
        with ProcessPoolExecutor(len(chunks)) as pool:
            counts = list(
                pool.map(
                    _pack_chunk,
                    [(str(root), sd, [str(f) for f in ch], shard_mb, decoded)
                     for sd, ch in zip(sub_dirs, chunks)],
                )
            )
        _merge_worker_dirs(out_path, sub_dirs)
        n_shards = sum(counts)
    if verbose:
        total = sum(f.stat().st_size for f in files)
        print(
            f"packed {len(files)} files ({total / 2**20:.1f} MB"
            f"{', decoded' if decoded else ''}) from {root} "
            f"into {out_dir} ({n_shards} shard(s), {workers} worker(s))"
        )
    return len(files)
