"""int8 against bf16 products at the backbone's operating point; the
counterpart of the TPU tool ``tools/matmul_microbench.py``.

    python -m crossscore_tpu_torch.tools.matmul_microbench [mode ...] [--cpu] [--reps N] [--seed N]

Times the three backbone products of the predict point (72 views x 1370
tokens = 98,640 rows): fc1 (384 -> 1536), fc2 (1536 -> 384) and qkv
(384 -> 1152), no bias. Modes (all by default), the TPU tool's four and a
yardstick:

    bf16         F.linear on bf16 x and the bf16 weight (cuBLAS)
    int8         the backbone's W8A8 linear: Q1 on x and on the fp32 weight,
                 then Q2 (``ops.quant.int8_linear``)
    int8_static  a weight quantised once and a fixed activation scale (|x| <=
                 4): one PyTorch pass quantises x (no absmax), then Q2
    int8_pure    Q2 alone on operands already int8
    int8_lib     the yardstick: ``torch._int_mm`` and a PyTorch dequantisation
                 on the same int8 operands (no model path calls it)

A row is the median of ``--reps`` calls (at least 5) after two warm-up calls,
by CUDA events; TOP/s counts 2 M K N operations. Each product then prints the
int8 mode's largest absolute difference from bf16. ``--cpu`` runs the plain
versions at a small shape (64 rows, the widths divided by 4); without it the
tool needs a CUDA card.
"""

from __future__ import annotations

import argparse
import sys

import torch
import torch.nn.functional as F

from crossscore_tpu_torch.ops.quant import int8_linear
from crossscore_tpu_torch.tools._common import device_line, median_ms, resolve_device

M = 72 * 1370
PRODUCTS = (("fc1", 384, 1536), ("fc2", 1536, 384), ("qkv", 384, 3 * 384))  # (tag, K, N)
CPU_M, CPU_DIV = 64, 4
MODES = ("bf16", "int8", "int8_static", "int8_pure", "int8_lib")
X_SCALE = 4.0 / 127.0  # the TPU tool's static calibration: |x| <= 4


def operands(m: int, k: int, n: int, device, seed: int) -> dict:
    """x (m, k) bf16 and the fp32 weight (n, k) from ``seed``, with the
    static modes' int8 operands: the weight quantised once (scale 1/127),
    random codes for int8_pure and their fixed scales."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(m, k, generator=gen, device=device).to(torch.bfloat16)
    w = torch.randn(n, k, generator=gen, device=device) / k ** 0.5
    wq = torch.round(w * 127.0).clamp(-127, 127).to(torch.int8)
    xq0 = torch.round(torch.randn(m, k, generator=gen, device=device) * 31).clamp(-127, 127).to(torch.int8)
    return {"x": x, "w": w, "w_bf16": w.to(torch.bfloat16), "wq": wq,
            "sw": torch.full((n, 1), 1 / 127.0, device=device), "xq0": xq0,
            "sx": torch.full((m, 1), X_SCALE, device=device)}


def mode_fns(o: dict) -> dict:
    """mode -> the call it times."""
    def static():
        xq = torch.round(o["x"].float() * (1.0 / X_SCALE)).clamp(-127, 127).to(torch.int8)
        return int8_linear((xq, o["sx"]), (o["wq"], o["sw"]), dtype=torch.bfloat16)

    return {"bf16": lambda: F.linear(o["x"], o["w_bf16"]),
            "int8": lambda: int8_linear(o["x"], o["w"]),
            "int8_static": static,
            "int8_pure": lambda: int8_linear((o["xq0"], o["sx"]), (o["wq"], o["sw"]), dtype=torch.bfloat16),
            "int8_lib": lambda: (torch._int_mm(o["xq0"], o["wq"].t()).float() * o["sx"] * o["sw"].t()).to(
                torch.bfloat16)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0],
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("modes", nargs="*", help=f"modes ({', '.join(MODES)}); all by default")
    ap.add_argument("--cpu", action="store_true", help="run the plain versions on the CPU at a small shape")
    ap.add_argument("--reps", type=int, default=5, help="timed calls per row, at least 5")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.reps < 5:
        ap.error("--reps must be at least 5")
    bad = [a for a in args.modes if a not in MODES]
    if bad:
        ap.error(f"unknown mode {bad[0]!r}: expected one of {', '.join(MODES)}")
    modes = args.modes or list(MODES)
    device = resolve_device(args.cpu)
    if device is None:
        return 1
    m, div = (CPU_M, CPU_DIV) if args.cpu else (M, 1)
    print(device_line(device))
    print(f"rows {m}, bf16 activations, fp32 weights for int8, median of {args.reps} calls, seed {args.seed}",
          flush=True)
    host = "" if device.type == "cuda" else " (host)"
    for tag, k, n in PRODUCTS:
        k, n = k // div, n // div
        o = operands(m, k, n, device, args.seed)
        fns = mode_fns(o)
        tera = 2.0 * m * k * n / 1e12
        for mode in modes:
            ms = median_ms(fns[mode], device, args.reps)
            unit = "TFLOP/s" if mode == "bf16" else "TOP/s"
            print(f"{tag:4s} {mode:11s}: {ms:7.3f} ms  {tera / (ms / 1e3):7.1f} {unit}{host}  "
                  f"({m} x {k} -> {n})", flush=True)
        err = (int8_linear(o["x"], o["w"]).float() - F.linear(o["x"], o["w_bf16"]).float()).abs().max()
        print(f"{tag:4s} int8-vs-bf16 max abs err: {float(err):.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
