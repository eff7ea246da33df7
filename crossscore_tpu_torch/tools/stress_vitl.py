"""BASELINE config #5 end to end on one card: the ViT-L backbone at twice the
training resolution; the counterpart of the TPU tool ``tools/stress_vitl.py``.

    python -m crossscore_tpu_torch.tools.stress_vitl [--hw 1036] [--k 5] [--batches 1,2,4]
        [--preset dinov2-large] [--train-batches B,..] [--token] [--skip-forward]
        [--extra key=value,..] [--scoped-vmem-kib N] [--cpu] [--reps N] [--seed N]

Runs the real model, ``dinov2-large`` (hidden 1024, 24 layers, 16 heads) at
1036 px (a 74x74 patch grid: 5477 tokens a view, 5476 query tokens and K x
5476 memory tokens in the decoder), through the predict forward
(``make_predict_step``) at each of ``--batches`` and through the train step
(``make_train_step``: the pixel step, or with ``--token`` the decoder-only
token step) at each of ``--train-batches`` (default: the same list), from the
port's seeded init (``io.convert.init_params``) and seeded random inputs.

A row is the median of ``--reps`` calls (at least 5) after two warm-up calls,
timed by CUDA events, with the spread (fastest, slowest), the peak memory and
the kernel launches of one call; ``mfu`` is the analytic FLOPs
(:func:`model_flops`, the TPU tool's count) over the time at the H100's 989
TFLOP/s bf16 (``null`` on the CPU). The TPU tool's in-graph loop and its
input perturbations guard against its relay's memoisation, which CUDA has
not. A row that fails (out of memory) is recorded as ``{"error": name}``, as
the TPU tool records it. The last line is the TPU tool's JSON, with these
extra keys.

TPU-only knobs are taken and reported unused: ``--scoped-vmem-kib`` (a Mosaic
VMEM limit) and ``model.tpu.*`` overrides in ``--extra`` (the TPU tool sets
``model.tpu.remat_backbone=true``; the port's backbone runs under
``no_grad`` and its config has no ``model.tpu``). ``--cpu`` runs the plain
versions on the CPU (use a small ``--hw`` and ``--preset dinov2-test``);
without it the tool needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from crossscore_tpu_torch.tools._common import H100_BF16_PEAK, device_line, resolve_device, times_ms

MIN_REPS = 5


def model_flops(hw: int, k: int, vit, d_dec: int, dec_layers: int,
                ffn_ratio: int, patch: int = 14) -> tuple[float, float]:
    """Analytic forward FLOPs per score map: (encoder_all_views, decoder+head).

    MAC-counted x2; attention counted as the 2 N^2 d matmuls (QK^T, PV);
    softmax and normalisation excluded, so MFU is mildly conservative. The
    TPU tool's count, term for term."""
    g = hw // patch
    nt = 1 + g * g  # tokens per view incl CLS
    d = vit.hidden_size
    per_layer = 24 * nt * d * d + 4 * nt * nt * d
    enc_view = vit.num_layers * per_layer + 2 * (nt - 1) * (patch * patch * 3) * d
    enc = (1 + k) * enc_view

    nq = g * g
    nk = k * nq
    dd = d_dec
    self_attn = 8 * nq * dd * dd + 4 * nq * nq * dd
    cross = 4 * nq * dd * dd + 4 * nk * dd * dd + 4 * nq * nk * dd
    ffn = 4 * nq * dd * dd * ffn_ratio
    dec = dec_layers * (self_attn + cross + ffn)
    head = 2 * nq * (dd * dd + dd * 196)
    return float(enc), float(dec + head)


def split_extra(extra: str) -> tuple[list[str], list[str]]:
    """``--extra``'s comma-separated overrides -> (the port's, the TPU-only
    ``model.tpu.*`` ones, which the port's config does not have)."""
    items = [o for o in extra.split(",") if o]
    return ([o for o in items if not o.startswith("model.tpu.")],
            [o for o in items if o.startswith("model.tpu.")])


def build(preset: str, overrides: list[str], device: torch.device, seed: int):
    """-> (composed config, CrossScoreConfig, model with the seeded init)."""
    from crossscore_tpu_torch.confsys import load_config
    from crossscore_tpu_torch.io.convert import init_params, load_into
    from crossscore_tpu_torch.models import CrossScoreConfig, CrossScoreNet

    cfg = load_config("default", overrides=[f"model.backbone.preset={preset}", *overrides])
    mcfg = CrossScoreConfig.from_config(cfg)
    model = load_into(CrossScoreNet(mcfg, device=device), init_params(mcfg, seed, device))
    return cfg, mcfg, model


def make_batch(gen: torch.Generator, device, b: int, k: int, hw: int, d: int, patch: int = 14,
               with_map: bool = False, token: bool = False) -> dict:
    """The TPU tool's batch from ``gen``: bf16 images (B, hw, hw, 3) and (B,
    K, hw, hw, 3), or with ``token`` bf16 tokens (B, g*g, D) and (B, K, g*g,
    D); with ``with_map`` an fp32 score map (B, hw, hw) in [0, 1)."""
    g = hw // patch

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=device).to(torch.bfloat16)

    if token:
        out = {"query/tokens": randn(b, g * g, d), "reference/cross/tokens": randn(b, k, g * g, d)}
    else:
        out = {"query/img": randn(b, hw, hw, 3), "reference/cross/imgs": randn(b, k, hw, hw, 3)}
    if with_map:
        out["query/score_map"] = torch.rand(b, hw, hw, generator=gen, device=device)
    return out


def kernel_counters() -> dict:
    """The launch counters of the kernels on this path (K1-K4; K10 too,
    which no model path calls)."""
    from crossscore_tpu_torch.ops.flash_attention import (
        flash_cross_attention, flash_cross_attention_bwd, flash_qkv_self_attention,
    )
    from crossscore_tpu_torch.ops.fused_mlp import fused_ln_mlp, fused_res_ln_mlp

    return {"K1": flash_qkv_self_attention, "K2": fused_ln_mlp, "K3": flash_cross_attention,
            "K4": flash_cross_attention_bwd, "K10": fused_res_ln_mlp}


def launches_of(fn) -> dict:
    """The kernel launches of one call of ``fn`` (0 on the CPU, where the
    wrappers run their plain versions)."""
    counters = kernel_counters()
    for w in counters.values():
        w.launches = 0
    fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return {name: w.launches for name, w in counters.items() if w.launches}


def timed_row(fn, device: torch.device, reps: int) -> dict:
    """One call's launches, then the median of ``reps`` calls after two
    warm-up calls, their spread and the peak memory."""
    launches = launches_of(fn)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    ts = sorted(times_ms(fn, device, reps))
    row = {"median_ms": ts[len(ts) // 2], "spread_ms": [ts[0], ts[-1]], "launches": launches}
    if device.type == "cuda":
        row["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
    return row


def mfu(flops: float, ms: float, device: torch.device):
    return flops / (ms / 1e3) / H100_BF16_PEAK if device.type == "cuda" else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--hw", type=int, default=1036)  # 2 x 518
    ap.add_argument("--k", type=int, default=5)
    ap.add_argument("--batches", default="1,2,4")
    ap.add_argument("--preset", default="dinov2-large")
    ap.add_argument("--train-batches", default=None, help="batch sizes for the train step (default: same list)")
    ap.add_argument("--cpu", action="store_true", help="the plain versions on the CPU")
    ap.add_argument("--extra", default="", help="extra dotted overrides, comma-separated")
    ap.add_argument("--skip-forward", action="store_true", help="train-step sweep only")
    ap.add_argument("--scoped-vmem-kib", type=int, default=0, help="a TPU VMEM limit: reported unused")
    ap.add_argument("--token", action="store_true", help="the train sweep runs the decoder-only token step")
    ap.add_argument("--reps", type=int, default=MIN_REPS)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = resolve_device(args.cpu)
    if device is None:
        return 1
    reps = max(MIN_REPS, args.reps)
    overrides, tpu_only = split_extra(args.extra)
    unused = tpu_only + ([f"--scoped-vmem-kib={args.scoped_vmem_kib}"] if args.scoped_vmem_kib else [])
    print(device_line(device), flush=True)
    if unused:
        print(f"TPU-only knobs, unused on this port: {' '.join(unused)}", flush=True)

    from crossscore_tpu_torch.train.optim import make_optimizer
    from crossscore_tpu_torch.train.step import TrainState, make_predict_step, make_train_step

    cfg, mcfg, model = build(args.preset, overrides, device, args.seed)
    hw, k = args.hw, args.k
    g = hw // mcfg.patch_size
    d = mcfg.backbone.hidden_size
    enc_f, dec_f = model_flops(hw, k, mcfg.backbone, d, mcfg.decoder_layers, mcfg.decoder_ffn_ratio,
                               mcfg.patch_size)
    print(f"{args.preset} @ {hw}px K={k}: grid {g}x{g} ({g * g} query tokens, {k * g * g} memory tokens); "
          f"analytic fwd FLOPs/map: encoder {enc_f / 1e12:.2f} T + decoder/head {dec_f / 1e12:.3f} T", flush=True)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"params: {n_params / 1e6:.0f} M", flush=True)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    results = {}

    step = make_predict_step(model)
    for b in ([] if args.skip_forward else [int(x) for x in args.batches.split(",")]):
        batch = make_batch(gen, device, b, k, hw, d, mcfg.patch_size)
        print(f"forward B={b}:", flush=True)
        try:
            r = timed_row(lambda: step(batch["query/img"], batch["reference/cross/imgs"]), device, reps)
        except torch.cuda.OutOfMemoryError as e:
            print(f"  FAILED ({type(e).__name__}): {str(e)[:300]}", flush=True)
            results[f"fwd_B{b}"] = {"error": type(e).__name__}
            continue
        finally:
            del batch
        ms = r["median_ms"]
        results[f"fwd_B{b}"] = {"ms": ms, "maps_per_s": b / (ms / 1e3),
                                "mfu": mfu(b * (enc_f + dec_f), ms, device), **r}
        print(f"  {ms:.1f} ms ({b / (ms / 1e3):.2f} maps/s, spread {r['spread_ms'][0]:.1f}-{r['spread_ms'][1]:.1f} "
              f"ms, peak {r.get('peak_gib', 0.0):.2f} GiB, launches {r['launches']})", flush=True)

    optimizer, scheduler, _ = make_optimizer(cfg, model, steps_per_epoch=100)
    train_step = make_train_step(model, optimizer, scheduler)
    tag = "train_tok" if args.token else "train"
    for b in (int(x) for x in (args.train_batches or args.batches).split(",")):
        batch = make_batch(gen, device, b, k, hw, d, mcfg.patch_size, with_map=True, token=args.token)
        print(f"{tag} B={b}:", flush=True)
        try:
            r = timed_row(lambda: train_step(TrainState(), batch), device, reps)
        except torch.cuda.OutOfMemoryError as e:
            print(f"  FAILED ({type(e).__name__}): {str(e)[:300]}", flush=True)
            results[f"{tag}_B{b}"] = {"error": type(e).__name__}
            continue
        finally:
            del batch
        ms = r["median_ms"]
        # frozen backbone: the encoder runs forward only, the decoder and
        # head forward and backward; the token step never runs the encoder
        fl = b * ((0 if args.token else enc_f) + 3 * dec_f)
        results[f"{tag}_B{b}"] = {"ms": ms, "ms_per_map": ms / b, "mfu": mfu(fl, ms, device), **r}
        print(f"  {ms:.1f} ms/step ({ms / b:.1f} ms/map, spread {r['spread_ms'][0]:.1f}-{r['spread_ms'][1]:.1f} ms, "
              f"peak {r.get('peak_gib', 0.0):.2f} GiB, launches {r['launches']})", flush=True)

    print(json.dumps({"hw": hw, "k": k, "preset": args.preset, "params_m": round(n_params / 1e6),
                      **results, "unused": unused, "device": str(device)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
