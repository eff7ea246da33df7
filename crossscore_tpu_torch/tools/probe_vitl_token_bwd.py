"""Attribute the ViT-L token-space train step; the counterpart of the TPU tool
``tools/probe_vitl_token_bwd.py``.

    python -m crossscore_tpu_torch.tools.probe_vitl_token_bwd [--preset dinov2-large] [--g 74] [--k 5]
        [--b 1] [--trace DIR] [--out FILE] [--scoped-vmem-kib N] [--cpu] [--reps N] [--seed N]

At the ViT-L stress geometry (B=1, a 74x74 grid: nq = 5476 query tokens, nk
= K x 5476 memory tokens, d_model 1024, 8 heads of hd 128) the tool times,
in one process:

  1. the full token train step (loss, gradients, AdamW; ``make_train_step``);
  2. the loss and its gradients only (no optimizer update);
  3. the forward and loss only;
  4. the decoder cross-attention backward alone (K4, one call; the TPU tool
     counts two layers' worth of it);
  5. the decoder cross-attention forward alone (K3, one call);

and prints the H100's floors of one K4 call at this geometry: the tensor
cores' (10 h nq nk hd operations, five products, at 989 TFLOP/s bf16) and
the memory's (q, o, do, k, v, l and m read once, dq, dk and dv written once,
at 3.35 TB/s). Then the attribution: optimizer = (1) - (2), backward = (2) -
(3), and two layers of K4 against their floor.

Each time is the median of ``--reps`` calls (at least 5) after two warm-up
calls, by CUDA events. The TPU tool's ``(block_k, qc_budget)`` sweep picks
Mosaic tiles: K4 has one tile plan on CUDA, so ``bwd_sweep`` holds one row,
K4 at its plan (``block_k`` its KV tile, ``qc_budget`` null). The kernel
stages run where the CUDA kernels take the head dim (a multiple of 16 up to
128), as the TPU tool runs them where its layout-native kernel does.
``--scoped-vmem-kib`` (a TPU VMEM limit) is taken and reported unused;
``--trace DIR`` writes a ``torch.profiler`` trace of one full step there (on
the card). The report (the TPU tool's keys) goes to ``--out`` and, as the
last line, to standard output. ``--cpu`` runs the plain versions on the CPU
(use ``--preset dinov2-test`` and a small ``--g``).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

from crossscore_tpu_torch.tools._common import (
    H100_BF16_PEAK, H100_BYTES_PER_S, device_line, median_ms, resolve_device,
)
from crossscore_tpu_torch.tools.stress_vitl import MIN_REPS, build, make_batch


def bwd_floors(b: int, heads: int, nq: int, nk: int, hd: int) -> tuple[float, float, int]:
    """One K4 call's floors on the H100 -> (tensor-core ms, memory ms,
    bytes): five products of 2 nq nk hd a head; q, o, do, k, v (bf16) and
    l, m (fp32) read once, dq, dk, dv (bf16) written once."""
    d = heads * hd
    ops = 10.0 * b * heads * nq * nk * hd
    nbytes = 2 * (3 * b * nq * d + 2 * b * nk * d) + 4 * 2 * b * heads * nq + 2 * (b * nq * d + 2 * b * nk * d)
    return ops / H100_BF16_PEAK * 1e3, nbytes / H100_BYTES_PER_S * 1e3, nbytes


def bwd_plan(hd: int):
    """K4's tile plan at ``hd`` from its library -> (q tile, KV tile)."""
    import ctypes

    from crossscore_tpu_torch.ops import _build

    fn = _build.load("flash_cross_bwd").cs_flash_attention_bwd_plan
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_void_p], ctypes.c_int
    out = (ctypes.c_int * 6)()
    if fn(hd, ctypes.addressof(out)) != 0:
        raise ValueError(f"K4 has no tile plan at hd {hd}")
    return out[1], out[2]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--preset", default="dinov2-large")
    ap.add_argument("--g", type=int, default=74, help="patch grid side")
    ap.add_argument("--k", type=int, default=5)
    ap.add_argument("--b", type=int, default=1)
    ap.add_argument("--scoped-vmem-kib", type=int, default=32768, help="a TPU VMEM limit: reported unused")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--trace", default=None, help="write a torch.profiler trace of one full step here")
    ap.add_argument("--out", default=None, help="write the report JSON here")
    ap.add_argument("--reps", type=int, default=MIN_REPS)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = resolve_device(args.cpu)
    if device is None:
        return 1
    reps = max(MIN_REPS, args.reps)
    print(device_line(device), flush=True)
    print(f"TPU-only knobs, unused on this port: --scoped-vmem-kib={args.scoped_vmem_kib}", flush=True)

    from crossscore_tpu_torch.ops.flash_attention import flash_cross_attention, flash_cross_attention_bwd
    from crossscore_tpu_torch.train.optim import make_optimizer
    from crossscore_tpu_torch.train.step import TrainState, loss_fn, make_train_step

    cfg, mcfg, model = build(args.preset, [], device, args.seed)
    b, g, k = args.b, args.g, args.k
    hw = g * mcfg.patch_size
    d = mcfg.backbone.hidden_size
    heads = mcfg.decoder_heads
    hd = d // heads
    nq, nk = g * g, k * g * g
    print(f"{args.preset}: grid {g}x{g} nq={nq} nk={nk} d={d} heads={heads} hd={hd}", flush=True)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    batch = make_batch(gen, device, b, k, hw, d, mcfg.patch_size, with_map=True, token=True)
    report = {"geometry": dict(g=g, k=k, b=b, nq=nq, nk=nk, d=d, heads=heads, hd=hd), "components_ms": {},
              "bwd_sweep": [], "unused": [f"--scoped-vmem-kib={args.scoped_vmem_kib}"], "device": str(device)}
    kernels = hd % 16 == 0 and hd <= 128
    block_q, block_k = bwd_plan(hd) if kernels and device.type == "cuda" else (None, None)
    mxu_ms, hbm_ms, nbytes = bwd_floors(b, heads, nq, nk, hd)
    print(f"H100 floors (one bwd call): tensor cores {mxu_ms:.2f} ms, memory {hbm_ms:.2f} ms "
          f"({nbytes / 1e6:.0f} MB)", flush=True)
    report["floors"] = {"bwd_mxu_ms": mxu_ms, "bwd_hbm_ms": hbm_ms, "block_q": block_q, "block_k": block_k}

    def timed(fn, label):
        ms = median_ms(fn, device, reps)
        print(f"  {label}: {ms:.1f} ms", flush=True)
        return ms

    c = report["components_ms"]
    optimizer, scheduler, _ = make_optimizer(cfg, model, steps_per_epoch=100)
    step = make_train_step(model, optimizer, scheduler)
    c["full_step"] = timed(lambda: step(TrainState(), batch), "full token train step")
    if args.trace and device.type == "cuda":
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step(TrainState(), batch)
            torch.cuda.synchronize()
        Path(args.trace).mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(Path(args.trace) / "full_step.json"))
        print(f"trace written to {args.trace}", flush=True)

    def value_and_grad():
        model.zero_grad(set_to_none=True)
        loss, _ = loss_fn(model, batch)
        loss.backward()

    c["value_and_grad"] = timed(value_and_grad, "value_and_grad (no optimizer)")

    def forward_loss():
        with torch.no_grad():
            loss_fn(model, batch)

    c["forward_loss"] = timed(forward_loss, "forward + loss only")

    if not kernels:
        print(f"hd={hd}: the CUDA kernels take hd 16-128 in steps of 16 (smoke geometry); skipping kernel-alone "
              "stages", flush=True)
    else:
        def randn(*shape):
            return torch.randn(*shape, generator=gen, device=device).to(torch.bfloat16)

        qp, kp, vp, do = randn(b, nq, d), randn(b, nk, d), randn(b, nk, d), randn(b, nq, d)
        o, l, m = flash_cross_attention(qp, kp, vp, heads)
        c["cross_fwd_kernel"] = timed(lambda: flash_cross_attention(qp, kp, vp, heads), "cross fwd kernel (x1)")
        ms = timed(lambda: flash_cross_attention_bwd(qp, kp, vp, o, do, l, m, heads),
                   f"cross bwd kernel (x1; tiles {block_q}x{block_k})")
        c["cross_bwd_kernel"] = ms
        report["bwd_sweep"].append({"block_k": block_k, "qc_budget": None, "ms": ms})

    print("\nattribution:", flush=True)
    print(f"  optimizer+state overhead = full - vag = {c['full_step'] - c['value_and_grad']:.1f} ms", flush=True)
    print(f"  backward-only = vag - fwd = {c['value_and_grad'] - c['forward_loss']:.1f} ms", flush=True)
    if "cross_bwd_kernel" in c:
        print(f"  isolated cross-bwd x2 layers = {2 * c['cross_bwd_kernel']:.1f} ms (floor "
              f"{2 * max(mxu_ms, hbm_ms):.1f} ms)", flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(report, indent=2))
        print(f"report -> {args.out}", flush=True)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
