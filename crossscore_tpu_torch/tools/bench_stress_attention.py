"""Stress benchmark of the decoder attention (BASELINE config #5); the port's
counterpart of ``tools/bench_stress_attention.py``.

The 2x-resolution ViT-L operating point: a 1036 px query gives 74x74 = 5476
query tokens, K=16 references 87,616 reference tokens; 16 heads of hd 64,
B=2, bf16. Dense scores there would take 30.6 GiB; the kernels stream them.
It times K7 (``flash_attention_head_major``, head-major operands) and K3
(``flash_cross_attention``, token-major "layout-native" operands) on the same
inputs, each beside one ``F.scaled_dot_product_attention`` call (a yardstick;
the port never calls it) and the bound: the larger of 4 B H Nq Nk hd
operations at the bf16 peak (989 TFLOP/s: 3.97 ms) and B H Nq Nk
exponentials at 3.9 T/s (3.94 ms). Median of ``--reps`` CUDA-event timed
calls after two warm-ups; the outputs are held against SDPA's by the
relative L2 error of o (:func:`errors`; a typical |o| over 87,616 random
keys is ~5e-3, so the max |d| beside it says little).

    python -m crossscore_tpu_torch.tools.bench_stress_attention          # the card
    python -m crossscore_tpu_torch.tools.bench_stress_attention --cpu    # plain versions, 6x6 grid

The last stdout line is one JSON object of the readings.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from crossscore_tpu_torch.tools._common import H100_BF16_PEAK, device_line, median_ms, resolve_device

# the H100 SXM's exponential rate: 16 a clock on each of 132 SMs
# (FlashAttention-3, arXiv 2407.08608, section 1)
H100_EXP2_PER_S = 3.9e12
B, HEADS, HD = 2, 16, 64


def inputs(device, grid: int, dtype) -> tuple:
    """Head-major q (B, H, grid^2, hd) and k, v (B, H, 16 grid^2, hd): K=16
    references, from a seeded generator on ``device``."""
    gen = torch.Generator(device=device).manual_seed(0)
    return tuple(torch.randn(B, HEADS, n, HD, generator=gen, device=device).to(dtype)
                 for n in (grid * grid, 16 * grid * grid, 16 * grid * grid))


def errors(o: torch.Tensor, want: torch.Tensor) -> dict:
    """o (head-major) against SDPA's: the relative L2 error, the check,
    and the max |d|, which is reported."""
    d = o.double() - want.double()
    return {"rel_l2_vs_sdpa": float(d.norm() / want.double().norm()), "max_abs_vs_sdpa": float(d.abs().max())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu", action="store_true", help="the plain versions on the CPU at a 6x6 grid")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    device = resolve_device(args.cpu)
    if device is None:
        return 1
    from crossscore_tpu_torch.ops.flash_attention import flash_attention_head_major, flash_cross_attention

    g = 6 if args.cpu else 74  # query tokens a side: 1036 px / 14
    b, h, hd = B, HEADS, HD
    nq, nk = g * g, 16 * g * g  # K=16 references
    dtype = torch.float32 if args.cpu else torch.bfloat16
    print(device_line(device))
    print(f"dense scores would be {b * h * nq * nk * 2 / 2 ** 30:.1f} GiB bf16 -> flash only")
    q, k, v = inputs(device, g, dtype)
    pack = lambda x: x.transpose(1, 2).reshape(b, x.shape[2], h * hd).contiguous()  # noqa: E731
    qp, kp, vp = pack(q), pack(k), pack(v)
    flops = 4.0 * b * h * nq * nk * hd
    exps = float(b * h * nq * nk)
    bound_ms = 1e3 * max(flops / H100_BF16_PEAK, exps / H100_EXP2_PER_S)

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(q, k, v)

    want = sdpa()
    rows = {}
    for name, fn, unpack in (
            ("head-major K7", lambda: flash_attention_head_major(q, k, v)[0], lambda o: o),
            ("layout-native K3", lambda: flash_cross_attention(qp, kp, vp, h)[0],
             lambda o: o.view(b, nq, h, hd).transpose(1, 2))):
        err = errors(unpack(fn()), want)
        ms = median_ms(fn, device, args.reps)
        rows[name] = {"ms": ms, "tflops": flops / ms / 1e9} | err
        print(f"stress cross-attn [{name}] (B={b} H={h} {nq}x{nk} hd={hd}): {ms:.2f} ms  "
              f"{flops / ms / 1e9:.1f} TFLOP/s  vs SDPA: relative L2 {err['rel_l2_vs_sdpa']:.3e}, "
              f"max|d| {err['max_abs_vs_sdpa']:.3e}", flush=True)
    sdpa_ms = median_ms(sdpa, device, args.reps)
    print(f"stress cross-attn [SDPA] (B={b} H={h} {nq}x{nk} hd={hd}): {sdpa_ms:.2f} ms  "
          f"{flops / sdpa_ms / 1e9:.1f} TFLOP/s (a yardstick)")
    print(f"bound: {bound_ms:.3f} ms (the larger of {flops / 1e12:.3f} TFLOP at {H100_BF16_PEAK / 1e12:g} "
          f"TFLOP/s and {exps:.3e} exponentials at {H100_EXP2_PER_S / 1e12:g} T/s; H100 SXM)")
    print(json.dumps({"geometry": dict(b=b, heads=h, hd=hd, nq=nq, nk=nk, dtype=str(dtype).split(".")[-1]),
                      "device": str(device), "kernels": rows, "sdpa_ms": sdpa_ms, "bound_ms": bound_ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
