"""Host-side token-batch assembly: times ``TokenSpaceLoader._finalize``, the
per-batch host work of the token-space train step (the cache lookup and the
window copies), on an all-hit cache; the counterpart of the TPU tool
``tools/token_assembly_bench.py``.

    python -m crossscore_tpu_torch.tools.token_assembly_bench [--cpu] [--iters N] [--b 24] [--k 5]
        [--arena loader|glibc]

At the train point: B=24, K=5, 38x52 token grids (532x728 images) cut to
37x37 windows (518 px crops), D=384, bf16 torch tensors. Every slot carries
the decode-skip flag, as on a warm store with the native decoder. It prints
the mean, min and median ms per batch over ``--iters`` batches after three
untimed ones, and views/s. Without ``--cpu`` (a card is needed) it also
times the batch's host-to-device copy from the fresh pageable tensors
``_finalize`` returns against the copy from a pinned buffer, and a host
copy into a reused pinned buffer followed by that copy.
The loader sets glibc's mmap threshold to 1 GiB and turns trimming off
(``data/token_train.py::_retain_malloc_arena``, as the JAX loader does), so
that the freed batch tensors stay mapped for the next batch; ``--arena
glibc`` skips that and keeps glibc's defaults. ``mallopt`` is process-wide,
so compare the two settings in two processes. ``--cpu`` runs a small shape
(B=2, K=2, 10x12 grids, 9x9 windows, D=64) on the host.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from crossscore_tpu_torch.tools._common import device_line, resolve_device

PATCH = 14


def _stats(ts: list) -> str:
    return f"{np.mean(ts):.2f} ms (min {np.min(ts):.2f}, p50 {np.median(ts):.2f})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0],
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--cpu", action="store_true", help="a small shape on the host, no card needed")
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--b", type=int, default=24)
    ap.add_argument("--k", type=int, default=5)
    ap.add_argument("--gh", type=int, default=38)
    ap.add_argument("--gw", type=int, default=52)
    ap.add_argument("--d", type=int, default=384)
    ap.add_argument("--crop", type=int, default=518)
    ap.add_argument("--arena", choices=("loader", "glibc"), default="loader",
                    help="the loader's retained malloc arena (default), or glibc's defaults")
    args = ap.parse_args(argv)
    device = resolve_device(args.cpu)
    if device is None:
        return 1
    if args.cpu:
        args.b, args.k, args.gh, args.gw, args.d, args.crop, args.iters = 2, 2, 10, 12, 64, 126, 5
    from crossscore_tpu_torch.data import token_train
    from crossscore_tpu_torch.data.token_cache import RefTokenCache
    from crossscore_tpu_torch.data.token_train import TokenSpaceLoader

    if args.arena == "glibc":
        token_train._retain_malloc_arena = lambda: None

    b, k, gh, gw, d = args.b, args.k, args.gh, args.gw, args.d
    h, w, ch = gh * PATCH, gw * PATCH, args.crop // PATCH

    def no_encode(*a, **kw):
        raise AssertionError("the bench's cache must hit every slot")

    cache = RefTokenCache(no_encode, max_items=4 * b * (k + 1))
    q_paths = [f"/bench/q{i}.png" for i in range(b)]
    r_paths = [[f"/bench/r{kk}_{i}.png" for i in range(b)] for kk in range(k)]
    gen = torch.Generator().manual_seed(0)
    for path in q_paths + [p for row in r_paths for p in row]:
        cache._put(RefTokenCache._key(path, (h, w)), torch.randn(gh * gw, d, generator=gen).to(torch.bfloat16))
    # the pixels are placeholders of the right shape (decode-skipped slots):
    # broadcast views keep the bench's memory at the grids
    zero = np.zeros((h, w, 3), np.uint8)
    batch = {"query/img": np.broadcast_to(zero, (b, h, w, 3)),
             "query/score_map": np.broadcast_to(np.zeros((h, w), np.float32), (b, h, w)),
             "reference/cross/imgs": np.broadcast_to(zero, (b, k, h, w, 3)),
             "query/skipped": np.ones(b, bool), "reference/skipped": np.ones((b, k), bool),
             "item_paths": {"query/img": q_paths, "reference/cross/imgs": r_paths}}
    stub = SimpleNamespace(query_crop=None, return_item_paths=True, neighbour_config={"cross": k},
                           resize_short_side=-1, crop_mode="integer_patches",
                           neighbour_selector=SimpleNamespace(paths={}))
    loader = TokenSpaceLoader(stub, cache, crop_size=args.crop, batch_size=b, num_workers=1)

    print(device_line(device))
    print(f"host: {os.cpu_count()} CPUs, {len(os.sched_getaffinity(0))} usable; malloc arena {args.arena}; B={b} K={k} grids {gh}x{gw} -> windows {ch}x{ch}, D={d} bf16, "
          f"one slicing thread, all {b * (k + 1)} slots decode-skipped", flush=True)
    times, out = [], None
    for it in range(args.iters + 3):
        t0 = time.perf_counter()
        out = loader._finalize(batch, {"epoch": it, "indices": list(range(b))})
        if it >= 3:
            times.append(1e3 * (time.perf_counter() - t0))
    assert tuple(out["reference/cross/tokens"].shape) == (b, k, ch * ch, d)
    mib = (out["query/tokens"].nbytes + out["reference/cross/tokens"].nbytes) / 2**20
    print(f"_finalize: {_stats(times)} per batch; {b * (k + 1) / np.mean(times) * 1e3:.0f} views/s; "
          f"{mib:.1f} MiB of windows a batch", flush=True)
    if device.type != "cuda":
        return 0

    toks = [out["query/tokens"], out["reference/cross/tokens"]]
    pinned = [torch.empty_like(t).pin_memory() for t in toks]

    def timed(fn, reps: int = 10) -> list:
        ts = []
        for _ in range(reps + 2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append(1e3 * (time.perf_counter() - t0))
        return ts[2:]

    def fresh_pageable():
        o = loader._finalize(batch, {"epoch": 0, "indices": list(range(b))})
        t0 = time.perf_counter()
        for t in (o["query/tokens"], o["reference/cross/tokens"]):
            t.to(device, non_blocking=True)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0)

    pageable = [fresh_pageable() for _ in range(12)][2:]
    from_pinned = timed(lambda: [p.to(device, non_blocking=True) for p in pinned])
    staged = timed(lambda: [p.copy_(t).to(device, non_blocking=True) for p, t in zip(pinned, toks)])
    rate = lambda ts: mib / 1024 / (np.median(ts) / 1e3)  # noqa: E731
    print(f"host-to-device of one batch ({mib:.1f} MiB): from _finalize's fresh pageable tensors {_stats(pageable)} "
          f"({rate(pageable):.1f} GiB/s); from a pinned buffer {_stats(from_pinned)} ({rate(from_pinned):.1f} GiB/s); "
          f"a host copy into a reused pinned buffer, then that copy {_stats(staged)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
