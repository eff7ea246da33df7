"""Times K4, the decoder attention backward, at the decoder's training shape;
the counterpart of the TPU tool ``tools/bwd_microbench.py``.

    python -m crossscore_tpu_torch.tools.bwd_microbench [b] [k] [nq] [h] [--cpu] [--reps N] [--seed N]

Shapes: b batch items (24), k reference views (5), nq queries (1369) over
k * nq keys, h heads (8), bf16 token-major projections (B, N, H*hd), as the
train step hands them to K4. The TPU tool sweeps its kernel's KV block and
q-chunk budget at the packed hd 64 and, as ``hd_true=48``, at the decoder's
unpadded hd 48; here each of its rows times K4 at that head dim (hd 64:
H*64 columns; hd 48: H*48), and the TPU tile sizes choose nothing: they are
reported as unused. A row's time is the median of ``--reps`` (at least 5)
calls after two warm-up calls, by CUDA events; its rate counts 10 B H Nq Nk
hd operations (five products). ``--cpu`` runs the plain version on the
CPU at a small shape (b 1, k 2, nq 64, h 2); without it the tool needs a
CUDA card.
"""

from __future__ import annotations

import argparse
import sys

import torch

from crossscore_tpu_torch.ops import flash_attention as fa
from crossscore_tpu_torch.tools._common import device_line, median_ms, resolve_device

# the TPU tool's rows: (block_k, qc_budget, hd_true), hd_true 0 = the packed hd 64
CONFIGS = (
    (512, 300_000, 0), (512, 480_000, 0), (512, 700_000, 0),
    (768, 300_000, 0), (768, 420_000, 0),
    (1024, 300_000, 0), (1024, 240_000, 0),
    (256, 300_000, 0),
    (768, 420_000, 48), (512, 480_000, 48), (1024, 300_000, 48),
)
CPU_SHAPE = (1, 2, 64, 2)  # b, k, nq, h


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0],
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("b", nargs="?", type=int, default=24, help="batch items (default 24)")
    ap.add_argument("k", nargs="?", type=int, default=5, help="reference views (default 5)")
    ap.add_argument("nq", nargs="?", type=int, default=1369, help="queries (default 1369)")
    ap.add_argument("h", nargs="?", type=int, default=8, help="heads (default 8)")
    ap.add_argument("--cpu", action="store_true", help="run the plain version on the CPU at a small shape")
    ap.add_argument("--reps", type=int, default=5, help="timed calls per row, at least 5")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.reps < 5:
        ap.error("--reps must be at least 5")
    device = resolve_device(args.cpu)
    if device is None:
        return 1
    b, k_views, nq, h = CPU_SHAPE if args.cpu else (args.b, args.k, args.nq, args.h)
    nk = k_views * nq
    gen = torch.Generator(device=device).manual_seed(args.seed)
    print(device_line(device))
    print(f"shape: B={b} K={k_views} Nq={nq} Nk={nk} H={h} bf16, median of {args.reps} calls, seed {args.seed}",
          flush=True)
    inputs = {}
    for block_k, budget, hd_true in CONFIGS:
        hd = hd_true or 64
        if hd not in inputs:
            q, do = (torch.randn(b, nq, h * hd, generator=gen, device=device).to(torch.bfloat16) for _ in range(2))
            k, v = (torch.randn(b, nk, h * hd, generator=gen, device=device).to(torch.bfloat16) for _ in range(2))
            o, l, m = fa.flash_cross_attention(q, k, v, h)
            inputs[hd] = (q, k, v, o, do, l, m, h)
        ms = median_ms(lambda a=inputs[hd]: fa.flash_cross_attention_bwd(*a), device, args.reps)
        flops = 10.0 * b * h * nq * nk * hd
        unit = "TFLOP/s" if device.type == "cuda" else "TFLOP/s (host)"
        tag = f" hd_true={hd_true}" if hd_true else ""
        print(f"bk={block_k:5d} budget={budget:7d}{tag}: {ms:6.2f} ms/layer ({flops / (ms / 1e3) / 1e12:5.1f} {unit})"
              f"  [K4 hd {hd}; unused TPU tiles: block_k={block_k}, qc_budget={budget}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
