"""Fused against unfused backbone MLP at the bench operating point; the
counterpart of the TPU tool ``tools/mlp_microbench.py``.

    python -m crossscore_tpu_torch.tools.mlp_microbench [xla] [fused] [block_m ...] [--cpu] [--reps N] [--seed N]

Times one ViT-block MLP half (ln2 -> fc1 -> GELU -> fc2 -> ls2 -> residual)
over the backbone's activation at the predict point, (72 views x 1370 tokens
x D 384), F 1536, bf16. Modes, the TPU tool's (both by default):

    xla     the unfused chain, the counterpart of ``_reference_xla``:
            F.layer_norm, F.linear, the exact-erf GELU, F.linear, then
            LayerScale and the residual, each a PyTorch call (a yardstick: no
            model path of the port calls it)
    fused   K2 (``ops.fused_mlp.fused_ln_mlp``, the tanh GELU ViTBlock runs)

The integers are the TPU tool's ``block_m`` sweep of its kernel's row tile
(default 256 512 1024). They choose nothing on CUDA: the fused row reports
them as unused TPU tiles. A row is the median of ``--reps`` calls (at least
5) after two warm-up calls, by CUDA events; TFLOP/s counts 4 rows D F
operations. ``--cpu`` runs the plain versions at a small shape (2 x 64 x 64,
F 256); without it the tool needs a CUDA card.
"""

from __future__ import annotations

import argparse
import sys

import torch
import torch.nn.functional as F

from crossscore_tpu_torch.ops.fused_mlp import fused_ln_mlp
from crossscore_tpu_torch.tools._common import device_line, median_ms, resolve_device

SHAPE = (72, 1370, 384, 1536)  # views, tokens, D, F
CPU_SHAPE = (2, 64, 64, 256)
MODES = ("xla", "fused")
BLOCK_M = (256, 512, 1024)
EPS = 1e-6


def unfused_chain(x, ln_scale, ln_bias, w1, b1, w2, b2, ls2, eps: float = EPS):
    """LN -> fc1 -> exact GELU -> fc2 -> LayerScale -> residual as separate
    PyTorch calls in x's dtype (weights in torch ``Linear`` layout)."""
    dt = x.dtype
    y = F.layer_norm(x, (x.shape[-1],), ln_scale.to(dt), ln_bias.to(dt), eps)
    h = F.gelu(F.linear(y, w1.to(dt), b1.to(dt)))
    return x + F.linear(h, w2.to(dt), b2.to(dt)) * ls2.to(dt)


def inputs(views: int, n: int, d: int, f: int, device, seed: int):
    """The TPU tool's inputs at (views, n, d), F f, bf16, from ``seed``:
    x and the seven parameters (w1 (F, D), w2 (D, F))."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape, scale=1.0, shift=0.0):
        return (torch.randn(*shape, generator=gen, device=device) * scale + shift).to(torch.bfloat16)

    x = randn(views, n, d, scale=0.5)
    params = (randn(d, scale=0.1, shift=1.0), randn(d, scale=0.1), randn(f, d, scale=d ** -0.5),
              randn(f, scale=0.1), randn(d, f, scale=f ** -0.5), randn(d, scale=0.1),
              randn(d, scale=0.05, shift=1.0))
    return x, params


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0],
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("args", nargs="*", help="modes (xla, fused) and TPU block_m integers")
    ap.add_argument("--cpu", action="store_true", help="run the plain versions on the CPU at a small shape")
    ap.add_argument("--reps", type=int, default=5, help="timed calls per row, at least 5")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.reps < 5:
        ap.error("--reps must be at least 5")
    bad = [a for a in args.args if not a.isdigit() and a not in MODES]
    if bad:
        ap.error(f"unknown mode {bad[0]!r}: expected one of {', '.join(MODES)} or block_m integers")
    modes = [a for a in args.args if not a.isdigit()] or list(MODES)
    blocks = [int(a) for a in args.args if a.isdigit()] or list(BLOCK_M)
    device = resolve_device(args.cpu)
    if device is None:
        return 1
    views, n, d, f = CPU_SHAPE if args.cpu else SHAPE
    x, params = inputs(views, n, d, f, device, args.seed)
    print(device_line(device))
    print(f"shape: x ({views}, {n}, {d}) bf16, F={f}, median of {args.reps} calls, seed {args.seed}", flush=True)
    fns = {"xla": ("xla unfused", lambda: unfused_chain(x, *params)),
           "fused": ("fused (K2)", lambda: fused_ln_mlp(x, *params, EPS, "tanh"))}
    tflop = 4.0 * views * n * d * f / 1e12
    unit = "TFLOP/s" if device.type == "cuda" else "TFLOP/s (host)"
    for mode in modes:
        label, fn = fns[mode]
        ms = median_ms(fn, device, args.reps)
        line = f"{label:24s} {ms:7.3f} ms/layer  {tflop / (ms / 1e3):6.1f} {unit}"
        if mode == "fused":
            line += f"  [unused TPU tiles: block_m={', '.join(map(str, blocks))}]"
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
