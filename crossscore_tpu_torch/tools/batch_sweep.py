"""Train-batch sweep at the production operating point; the counterpart of the
TPU tool ``tools/batch_sweep.py``.

    python -m crossscore_tpu_torch.tools.batch_sweep [--preset dinov2-small] [--hw 518] [--k 5]
        [--batches 16,24,32,48] [--modes pixel,token] [--out FILE] [--cpu] [--reps N] [--seed N]

B=24 is inherited from the reference's 24 GB card; this sweeps B for the
pixel train step and the token-space (decoder-only) train step at K=5, 518
px, bf16, in one process, from the port's seeded init and seeded random
inputs. A row is the median of ``--reps`` steps (at least 5) after two
warm-up steps, by CUDA events, with the spread, the peak memory and one
step's kernel launches; ``compile_s`` is the seconds of the first step (no
graph is compiled on CUDA: the kernels' build, when not yet built, and the
first launches). Out-of-memory rows are recorded, not fatal, as the TPU tool
records them. The report (the TPU tool's keys) goes to ``--out`` and, as the
last line, to standard output. ``--cpu`` runs the plain versions on the CPU
(use a small ``--hw`` and ``--batches``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

from crossscore_tpu_torch.tools._common import device_line, resolve_device
from crossscore_tpu_torch.tools.stress_vitl import MIN_REPS, build, make_batch, timed_row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--preset", default="dinov2-small")
    ap.add_argument("--hw", type=int, default=518)
    ap.add_argument("--k", type=int, default=5)
    ap.add_argument("--batches", default="16,24,32,48")
    ap.add_argument("--modes", default="pixel,token")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--reps", type=int, default=MIN_REPS)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = resolve_device(args.cpu)
    if device is None:
        return 1
    reps = max(MIN_REPS, args.reps)
    print(device_line(device), flush=True)

    from crossscore_tpu_torch.train.optim import make_optimizer
    from crossscore_tpu_torch.train.step import TrainState, make_train_step

    cfg, mcfg, model = build(args.preset, [], device, args.seed)
    hw, k = args.hw, args.k
    d = mcfg.backbone.hidden_size
    optimizer, scheduler, _ = make_optimizer(cfg, model, steps_per_epoch=100)
    step = make_train_step(model, optimizer, scheduler)
    gen = torch.Generator(device=device).manual_seed(args.seed)

    results = []
    for mode in args.modes.split(","):
        token = mode == "token"
        for b in (int(x) for x in args.batches.split(",")):
            label = f"{mode} B={b}"
            batch = make_batch(gen, device, b, k, hw, d, mcfg.patch_size, with_map=True, token=token)
            try:
                t0 = time.perf_counter()
                step(TrainState(), batch)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                compile_s = time.perf_counter() - t0
                r = timed_row(lambda: step(TrainState(), batch), device, reps)
                ms = r["median_ms"]
                row = {"mode": mode, "B": b, "ms_per_step": ms, "items_per_s": b / (ms / 1e3),
                       "compile_s": compile_s, **r}
                print(f"{label}: {ms:.1f} ms/step ({b / (ms / 1e3):.1f} items/s, spread {r['spread_ms'][0]:.1f}-"
                      f"{r['spread_ms'][1]:.1f} ms, peak {r.get('peak_gib', 0.0):.2f} GiB, first step "
                      f"{compile_s:.1f}s)", flush=True)
            except torch.cuda.OutOfMemoryError as e:
                row = {"mode": mode, "B": b, "error": type(e).__name__, "detail": str(e)[:200]}
                print(f"{label}: FAILED ({type(e).__name__}) {str(e)[:160]}", flush=True)
            del batch
            results.append(row)

    best = {}
    for mode in args.modes.split(","):
        ok = [r for r in results if r["mode"] == mode and "items_per_s" in r]
        if ok:
            best[mode] = max(ok, key=lambda r: r["items_per_s"])
            print(f"best {mode}: B={best[mode]['B']} ({best[mode]['items_per_s']:.1f} items/s)", flush=True)
    report = {"preset": args.preset, "hw": hw, "k": k, "results": results, "best": best, "device": str(device)}
    if args.out:
        Path(args.out).write_text(json.dumps(report, indent=2))
        print(f"report -> {args.out}", flush=True)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
