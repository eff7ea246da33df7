#!/usr/bin/env python3
"""Where the PyTorch port's predict step spends its device time, on one CUDA card.

    python3 tools/torch_step_profile.py [--trace step_trace.json]

Builds the kernels, runs ``make_predict_step`` at the main-path operating
point (dinov2-small, 518 px, K=8 references, B=8, bf16, flash attention and
the fused MLP, seeded random weights, uint8 images), warms up, then records
three steps under ``torch.profiler``. Prints the card, the
step time (CUDA events, no profiler), the device time per kernel (top 25),
the device time per layer group (K1, K2, K3 kernels, K10 where launched, matrix
products, the rest)
and the device busy share (kernel time over the profiled wall time).
"""

from __future__ import annotations

import argparse
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
B, K, HW, STEPS = 8, 8, 518, 3


def _group(name: str) -> str:
    """The layer group of a kernel, from its name as the profiler gives it
    (demangled, ``cs::ln_mlp_tma<384, false, true>(...)``) or mangled
    (``_ZN2cs10ln_mlp_tmaILi384ELb0ELb1EE...``)."""
    # the attention forward's kernels are templates on the head dim first:
    # the backbone's is 64, the decoder's 48
    if re.search(r"attn_fwd_\w*?(<64\b|ILi64E)", name):
        return "K1 backbone attention"
    if "attn_fwd" in name:
        return "K3 decoder attention"
    # the fused MLP's bf16 and fp32 kernels take RES (K10) second
    if re.search(r"ln_mlp_(tma|f32)(<\s*\d+\s*,\s*(true|1)\b|ILi\d+ELb1E)", name):
        return "K10 fused residual LN-MLP"
    if "ln_mlp" in name:
        return "K2 fused LN-MLP"
    if any(s in name.lower() for s in ("gemm", "cutlass", "xmma", "cublas", "sm90_", "nvjet")):
        return "matrix products (cuBLAS)"
    return "elementwise, reductions, copies"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trace", default="", help="write a Chrome trace of the profiled steps here")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_step_profile: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from torch.profiler import ProfilerActivity, profile

    from crossscore_tpu_torch.io.convert import init_params, load_into
    from crossscore_tpu_torch.models import CrossScoreConfig, CrossScoreNet
    from crossscore_tpu_torch.ops import _build
    from crossscore_tpu_torch.train.step import make_predict_step

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    _build.build_all()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    cfg = CrossScoreConfig()
    model = load_into(CrossScoreNet(cfg, device=dev), init_params(cfg, 0, dev))
    step = make_predict_step(model)
    query = torch.randint(0, 256, (B, HW, HW, 3), generator=gen, device=dev, dtype=torch.uint8)
    refs = torch.randint(0, 256, (B, K, HW, HW, 3), generator=gen, device=dev, dtype=torch.uint8)
    for _ in range(3):
        step(query, refs)
    torch.cuda.synchronize()

    times = []
    for _ in range(5):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        step(query, refs)
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    times.sort()
    print(f"step (no profiler): median {times[2]:.3f} ms of 5, {1e3 * B / times[2]:.2f} maps/s "
          f"(B={B}, K={K}, {HW} px)")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            step(query, refs)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    if args.trace:
        Path(args.trace).parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(args.trace)

    rows = []
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0.0)
        if dev_us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((dev_us / 1e3 / STEPS, evt.count // STEPS, evt.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    step_wall = wall_ms / STEPS
    print(f"profiled: {step_wall:.3f} ms wall per step, {busy:.3f} ms device time per step, "
          f"device busy {100 * busy / step_wall:.1f}% (idle {100 * (1 - busy / step_wall):.1f}%)")
    if busy == 0:
        print("torch_step_profile: the profiler recorded no device time", file=sys.stderr)
        return 1
    groups: dict[str, float] = {}
    for ms, _, name in rows:
        groups[_group(name)] = groups.get(_group(name), 0.0) + ms
    for name, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {ms:9.3f} ms  {100 * ms / busy:5.1f}%  {name}")
    print("top kernels (device ms per step, launches per step):")
    for ms, count, name in rows[:25]:
        print(f"  {ms:9.3f} ms  x{count:<4d} {name[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
