"""What would an unpadded decoder backward buy? Times K12, the backward's
five matrix products without its transcendentals, at the TPU tool's four
head-slice geometries; the counterpart of the TPU tool
``tools/lane_pad_probe.py``.

    python -m crossscore_tpu_torch.tools.lane_pad_probe [b] [k_views] [--cpu] [--seed N] \\
        [--reps N] [--step-ms MS]

The decoder's head dim is 48 (384 / 8); the TPU kernels pad it to 64 so that
two heads fill a 128-lane block. Geometries (``ops/lane_pad_probe.py``):

    hd64_current   two 64-wide slices: the padded packing
    hd48_nopad     two 48-wide slices packed at a 48-lane stride
    hd48_off64     two 48-wide slices at the 64-lane offsets
    hd128_fused    one 128-wide contraction: the products' ceiling

At b (24) batch items and k_views (5) references the shapes are the TPU
tool's: q/do (b, 1392, 128) and k/v (b, 7168, 128) bf16, one lane block of the
four in the decoder's backward. Each geometry's time is the median of
``--reps`` (at least 5) calls after two warm-up calls, by CUDA events, and
its rate counts the useful operations (10 b Nq Nk per lane of the slices).
The last lines give the hd-48 geometries' saving per call and per train step
(x 4 lane blocks x 2 decoder layers), and as a share of ``--step-ms`` when
given. ``--cpu`` runs the plain version at the TPU tool's ``--cpu`` shapes
(b 1, 64 queries, 256 keys); without it the tool needs a CUDA card.
"""

from __future__ import annotations

import argparse
import sys

import torch

from crossscore_tpu_torch.ops.lane_pad_probe import GEOMETRIES, LANES, lane_pad_probe, probe_shapes, useful_flops
from crossscore_tpu_torch.tools._common import device_line, median_ms, resolve_device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0],
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("b", nargs="?", type=int, default=24, help="batch items (default 24)")
    ap.add_argument("k_views", nargs="?", type=int, default=5, help="reference views (default 5)")
    ap.add_argument("--cpu", action="store_true", help="run the plain version on the CPU at small shapes")
    ap.add_argument("--reps", type=int, default=8, help="timed calls per geometry, at least 5")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--step-ms", type=float, default=None,
                    help="a train step's time, to express the saving as a share of it")
    args = ap.parse_args(argv)
    if args.reps < 5:
        ap.error("--reps must be at least 5")
    device = resolve_device(args.cpu)
    if device is None:
        return 1
    b = 1 if args.cpu else args.b
    nq_p, nk_p = probe_shapes(b, args.k_views, cpu=args.cpu)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    qp, dop = (torch.randn(b, nq_p, LANES, generator=gen, device=device).to(torch.bfloat16) for _ in range(2))
    kp, vp = (torch.randn(b, nk_p, LANES, generator=gen, device=device).to(torch.bfloat16) for _ in range(2))
    print(device_line(device))
    print(f"probe: b={b} nq_p={nq_p} nk_p={nk_p} (one lane block of the 4 in the decoder backward; x4 per "
          f"layer, x2 layers for the step), median of {args.reps} calls, seed {args.seed}", flush=True)
    results = {}
    for name in GEOMETRIES:
        ms = median_ms(lambda g=name: lane_pad_probe(qp, dop, kp, vp, g), device, args.reps)
        results[name] = ms
        unit = "useful TFLOP/s" if device.type == "cuda" else "useful TFLOP/s (host)"
        print(f"{name:14s} {ms:9.3f} ms ({useful_flops(b, nq_p, nk_p, name) / (ms / 1e3) / 1e12:6.1f} {unit})",
              flush=True)
    d64 = results["hd64_current"]
    for name in ("hd48_nopad", "hd48_off64"):
        step_ms = (d64 - results[name]) * 4 * 2
        share = f" = {100 * step_ms / args.step_ms:.1f}% of a {args.step_ms:g} ms step" if args.step_ms else ""
        print(f"{name} saving: {d64 - results[name]:.3f} ms per call -> ~{step_ms:.3f} ms per step "
              f"(2 layers, 4 lane blocks){share}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
