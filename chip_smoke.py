#!/usr/bin/env python3
"""Drive the PyTorch/H100 port's predict forward on one CUDA card.

    python3 chip_smoke.py            # from the repository root, one card

In order:
1. print the card's name and power limit (``nvidia-smi``);
2. build the three kernels from ``crossscore_tpu_torch/csrc/`` (one ``nvcc``
   per source, all at once) and print the build time;
3. hold K1 (backbone self-attention), K2 (fused LN->MLP) and K3 (decoder
   attention) against their plain PyTorch versions at the main-path shapes
   (dinov2-small, 518 px, K=8 references, B=8), in bf16 and fp32 (and at the
   other presets' head dims and widths at small shapes), and time
   the kernel, the plain version and, for the attention kernels, one
   ``F.scaled_dot_product_attention`` call on the same inputs (a yardstick
   only; the port never calls it);
4. run the full-width forward through ``make_predict_step`` (dinov2-small,
   518 px, K=8, B=8, bf16, seeded random weights) with the launch counters
   zeroed, check the score map and that the forward launched 12 / 12 / 4
   kernels, and time it with CUDA events;
5. run the net again at B=1 with every kernel replaced by its plain version
   and bound the score-map difference, in bf16 and fp32;
6. print one ``{"kernels": [...]}`` line, then, last, the device line.

Exits non-zero, printing no result, without a CUDA card or outside the
repository. No JAX is imported.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

SEED = 0
B, K, HW = 8, 8, 518  # main-path operating point: 72 backbone views of 1370 tokens

# least time the card could take: the larger of ops / peak and bytes / rate.
# Dense peaks from NVIDIA's data sheets (bf16 tensor cores, fp32 CUDA cores).
PEAKS = {  # name fragment: (bf16 op/s, fp32 op/s, bytes/s)
    "H100 PCIe": (756e12, 51e12, 2.0e12),
    "H100 NVL": (835e12, 60e12, 3.9e12),
    "H100": (989e12, 67e12, 3.35e12),  # SXM
}

# kernel-vs-plain tolerances at the main-path shapes: the largest of
# |kernel - plain| / (1 + |plain|) over o (or out), m and l.
# fp32: both sides are full fp32 and differ by summation order and exp2 ulps.
# bf16: the kernels round p to bf16 before P.V (as the TPU kernels do) and
# every output is rounded to bf16 once (2^-8 relative): two bf16 ulps.
TOL = {"float32": 5e-5, "bfloat16": 1.6e-2}
# whole-net score-map MAE, kernel path vs all-plain path, B=1 (scores in [0, 1])
NET_TOL = {"float32": 1e-4, "bfloat16": 1e-2}


def _fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def _peaks(name: str):
    for frag, peaks in PEAKS.items():
        if frag in name:
            return frag, peaks
    return "H100", PEAKS["H100"]


def _time_ms(torch, fn, reps: int = 10) -> float:
    """Median of ``reps`` CUDA-event timings after two warm-up calls."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def _rel_err(got, want) -> float:
    got, want = got.float(), want.float()
    return float(((got - want).abs() / (1.0 + want.abs())).max())


def _max_abs(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    root = Path(__file__).resolve().parent
    if not (root / "crossscore_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(root))
    import torch.nn.functional as F

    from crossscore_tpu_torch.io.convert import init_params, load_into
    from crossscore_tpu_torch.models import CrossScoreConfig, CrossScoreNet, VIT_PRESETS
    from crossscore_tpu_torch.ops import _build
    from crossscore_tpu_torch.ops.flash_attention import (
        flash_cross_attention, flash_cross_attention_plain,
        flash_qkv_self_attention, flash_qkv_self_attention_plain,
    )
    from crossscore_tpu_torch.ops.fused_mlp import fused_ln_mlp, fused_ln_mlp_plain
    from crossscore_tpu_torch.train.step import make_predict_step

    # full fp32 for fp32 products and convolutions (cuDNN defaults to TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = _card_line()
    print(card)
    name = torch.cuda.get_device_name(0)
    peak_row, (peak_bf16, peak_f32, peak_bw) = _peaks(name)
    print(f"peaks used for bounds: {peak_row} row: {peak_bf16 / 1e12:g} TFLOP/s bf16, "
          f"{peak_f32 / 1e12:g} TFLOP/s fp32, {peak_bw / 1e12:g} TB/s")

    t0 = time.perf_counter()
    secs = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s wall "
          + " ".join(f"{k}={v:.1f}s" for k, v in secs.items()))
    for src in _build.SOURCES:
        log = _build.BUILD_DIR / f"{src}.log"
        entry = ""
        for line in (log.read_text().splitlines() if log.exists() else []):
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                entry = m.group(1)
            m = re.search(r"(\d+) bytes spill stores", line)
            if m and m.group(1) != "0":
                print(f"  ptxas {src} {entry}: {line.strip()}")
            m = re.search(r"Used (\d+) registers", line)
            if m:
                print(f"  ptxas {src} {entry}: {m.group(1)} registers")

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    vit = VIT_PRESETS["dinov2-small"]
    d, h, hd = vit.hidden_size, vit.num_heads, vit.hidden_size // vit.num_heads
    f = vit.mlp_ratio * d
    n = (HW // vit.patch_size) ** 2 + 1  # 1370 tokens
    nq = n - 1  # decoder query tokens
    dec_h = CrossScoreConfig().decoder_heads
    views = B * (1 + K)

    def randn(*shape, dtype, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)

    report = {}

    # --- 3. kernels vs plain versions at the main-path shapes ----------------
    for dtype in (torch.bfloat16, torch.float32):
        tname = str(dtype).split(".")[-1]
        es = dtype.itemsize
        peak = peak_bf16 if dtype == torch.bfloat16 else peak_f32

        qkv = randn(views, n, 3 * d, dtype=dtype)
        got = flash_qkv_self_attention(qkv, h)
        want = flash_qkv_self_attention_plain(qkv, h)
        err = max(_rel_err(g, w) for g, w in zip(got, want))
        ops = 4.0 * views * h * n * n * hd
        nbytes = views * n * (3 * d + d) * es + 2 * views * h * n * 4
        report[("K1", tname)] = dict(
            err=err, max_abs=_max_abs(got[0], want[0]),
            ms=_time_ms(torch, lambda: flash_qkv_self_attention(qkv, h)),
            plain_ms=_time_ms(torch, lambda: flash_qkv_self_attention_plain(qkv, h), reps=3),
            library_ms=_time_ms(torch, lambda: F.scaled_dot_product_attention(
                *(qkv.view(views, n, 3, h, hd)[:, :, i].transpose(1, 2) for i in range(3)))),
            bound_ms=1e3 * max(ops / peak, nbytes / peak_bw),
            bound_by="operations" if ops / peak >= nbytes / peak_bw else "bytes",
        )
        del qkv, got, want

        x = randn(views, n, d, dtype=dtype)
        mlp = (randn(d, dtype=torch.float32, scale=0.1) + 1, randn(d, dtype=torch.float32, scale=0.1),
               randn(f, d, dtype=torch.float32, scale=d ** -0.5), randn(f, dtype=torch.float32, scale=0.1),
               randn(d, f, dtype=torch.float32, scale=f ** -0.5), randn(d, dtype=torch.float32, scale=0.1),
               randn(d, dtype=torch.float32, scale=0.5) + 1)
        got = fused_ln_mlp(x, *mlp, vit.layer_norm_eps, "tanh")
        want = fused_ln_mlp_plain(x, *mlp, vit.layer_norm_eps, "tanh")
        err = _rel_err(got, want)
        if dtype == torch.bfloat16:  # the exact-erf form too (fused_exact)
            err = max(err, _rel_err(fused_ln_mlp(x, *mlp, vit.layer_norm_eps, "exact"),
                                    fused_ln_mlp_plain(x, *mlp, vit.layer_norm_eps, "exact")))
        rows = views * n
        ops = 4.0 * rows * d * f
        nbytes = 2 * rows * d * es + 2 * d * f * es + (4 * d + f) * es
        report[("K2", tname)] = dict(
            err=err, max_abs=_max_abs(got, want),
            ms=_time_ms(torch, lambda: fused_ln_mlp(x, *mlp, vit.layer_norm_eps, "tanh")),
            plain_ms=_time_ms(torch, lambda: fused_ln_mlp_plain(x, *mlp, vit.layer_norm_eps, "tanh"), reps=3),
            library_ms=None,
            bound_ms=1e3 * max(ops / peak, nbytes / peak_bw),
            bound_by="operations" if ops / peak >= nbytes / peak_bw else "bytes",
        )
        del x, mlp, got, want

        q = randn(B, nq, d, dtype=dtype)
        for tag, nk in (("K3", K * nq), ("K3self", nq)):  # cross, then self
            k_, v_ = randn(B, nk, d, dtype=dtype), randn(B, nk, d, dtype=dtype)
            got = flash_cross_attention(q, k_, v_, dec_h)
            want = flash_cross_attention_plain(q, k_, v_, dec_h)
            err = max(_rel_err(g, w) for g, w in zip(got, want))
            dhd = d // dec_h
            ops = 4.0 * B * dec_h * nq * nk * dhd
            nbytes = B * (2 * nq + 2 * nk) * d * es + 2 * B * dec_h * nq * 4
            heads = lambda t: t.view(B, -1, dec_h, dhd).transpose(1, 2)  # noqa: E731
            report[(tag, tname)] = dict(
                err=err, max_abs=_max_abs(got[0], want[0]),
                ms=_time_ms(torch, lambda: flash_cross_attention(q, k_, v_, dec_h)),
                plain_ms=_time_ms(torch, lambda: flash_cross_attention_plain(q, k_, v_, dec_h), reps=3),
                library_ms=_time_ms(torch, lambda: F.scaled_dot_product_attention(
                    heads(q), heads(k_), heads(v_))),
                bound_ms=1e3 * max(ops / peak, nbytes / peak_bw),
                bound_by="operations" if ops / peak >= nbytes / peak_bw else "bytes",
            )
            del k_, v_, got, want
        del q
        torch.cuda.empty_cache()

    # the other presets' widths, small shapes, correctness only: K1 at hd 16
    # (dinov2-test) and 64 (base, large), K2 at D 64, 768, 1024, K3 at hd 96
    # and 128 (base, large decoders)
    for dtype in (torch.bfloat16, torch.float32):
        tname = str(dtype).split(".")[-1]
        for heads, hdim in ((4, 16), (12, 64)):
            qkv = randn(2, 300, 3 * heads * hdim, dtype=dtype)
            err = max(_rel_err(g, w) for g, w in zip(
                flash_qkv_self_attention(qkv, heads), flash_qkv_self_attention_plain(qkv, heads)))
            report[(f"K1 hd{hdim}", tname)] = dict(err=err)
        for width in (64, 768, 1024):
            x = randn(2, 300, width, dtype=dtype)
            mlp = (randn(width, dtype=torch.float32, scale=0.1) + 1,
                   randn(width, dtype=torch.float32, scale=0.1),
                   randn(4 * width, width, dtype=torch.float32, scale=width ** -0.5),
                   randn(4 * width, dtype=torch.float32, scale=0.1),
                   randn(width, 4 * width, dtype=torch.float32, scale=(4 * width) ** -0.5),
                   randn(width, dtype=torch.float32, scale=0.1), randn(width, dtype=torch.float32) + 1)
            err = max(_rel_err(fused_ln_mlp(x, *mlp, 1e-6, g), fused_ln_mlp_plain(x, *mlp, 1e-6, g))
                      for g in ("tanh", "exact"))
            report[(f"K2 D{width}", tname)] = dict(err=err)
        for heads, hdim in ((8, 96), (8, 128)):
            q, k_, v_ = (randn(2, n_, heads * hdim, dtype=dtype) for n_ in (300, 700, 700))
            err = max(_rel_err(g, w) for g, w in zip(
                flash_cross_attention(q, k_, v_, heads), flash_cross_attention_plain(q, k_, v_, heads)))
            report[(f"K3 hd{hdim}", tname)] = dict(err=err)

    bad = []
    for (kern, tname), r in report.items():
        if "ms" not in r:  # a preset-width check
            ok = r["err"] <= TOL[tname]
            print(f"{kern:7s} {tname:8s} err {r['err']:.3e} (tol {TOL[tname]:.1e}) {'ok' if ok else 'FAIL'}")
            if not ok:
                bad.append(f"{kern} {tname}")
            continue
        ok = r["err"] <= TOL[tname]
        print(f"{kern:7s} {tname:8s} err {r['err']:.3e} (tol {TOL[tname]:.1e}) max|d| {r['max_abs']:.3e} "
              f"kernel {r['ms']:.3f} ms plain {r['plain_ms']:.3f} ms "
              f"library {r['library_ms'] if r['library_ms'] is None else round(r['library_ms'], 3)} ms "
              f"bound {r['bound_ms']:.3f} ms ({r['bound_by']}) {'ok' if ok else 'FAIL'}")
        if not ok:
            bad.append(f"{kern} {tname}")
    if bad:
        _fail("kernel disagrees with its plain version: " + ", ".join(bad))

    # --- 4. the full-width forward through make_predict_step ------------------
    cfg = CrossScoreConfig()  # dinov2-small, bf16, flash, fused
    params = init_params(cfg, SEED, dev)
    model = load_into(CrossScoreNet(cfg, device=dev), params)
    step = make_predict_step(model)
    query = torch.randint(0, 256, (B, HW, HW, 3), generator=gen, device=dev, dtype=torch.uint8)
    refs = torch.randint(0, 256, (B, K, HW, HW, 3), generator=gen, device=dev, dtype=torch.uint8)
    wrappers = {"K1": flash_qkv_self_attention, "K2": fused_ln_mlp, "K3": flash_cross_attention}
    for w in wrappers.values():
        w.launches = 0
    score = step(query, refs)["score_map_ref_cross"]
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items()}
    want = {"K1": vit.num_layers, "K2": vit.num_layers, "K3": 2 * cfg.decoder_layers}
    print(f"main path launches per forward: {launches} (expected {want})")
    if launches != want:
        _fail(f"launch counts {launches} != {want}")
    if tuple(score.shape) != (B, HW, HW) or not bool(torch.isfinite(score).all()) \
            or float(score.min()) < 0.0 or float(score.max()) > 1.0:
        _fail(f"score map shape {tuple(score.shape)} / finite / range check failed")
    print(f"score map {tuple(score.shape)} mean {float(score.mean()):.6f} "
          f"min {float(score.min()):.6f} max {float(score.max()):.6f}")
    torch.cuda.reset_peak_memory_stats()
    step_ms = _time_ms(torch, lambda: step(query, refs), reps=5)
    print(f"predict step: {step_ms:.2f} ms per batch of {B} maps = {1e3 * B / step_ms:.2f} maps/s "
          f"(518 px, K={K}, bf16, median of 5 after warm-up); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # --- 5. the same net at B=1, kernels vs all-plain, bf16 and fp32 ----------
    q1, r1 = query[:1], refs[:1]
    for dtype, kernel_mlp in ((torch.bfloat16, "fused_exact"), (torch.bfloat16, "fused"),
                              (torch.float32, "fused_exact")):
        tname = str(dtype).split(".")[-1]
        maps = {}
        for impl, mlp_impl in (("flash", kernel_mlp), ("dense", "unfused")):
            c = CrossScoreConfig(compute_dtype=dtype, attention_impl=impl, mlp_impl=mlp_impl)
            net = load_into(CrossScoreNet(c, device=dev), params)
            maps[impl] = make_predict_step(net)(q1, r1)["score_map_ref_cross"]
        mae = float((maps["flash"] - maps["dense"]).abs().mean())
        # the default bf16 path uses the tanh GELU, the plain one the exact form
        tol = NET_TOL[tname] if kernel_mlp == "fused_exact" else 2 * NET_TOL[tname]
        print(f"whole net B=1 {tname} {kernel_mlp} vs dense/unfused: score MAE {mae:.3e} (tol {tol:.1e})")
        if not mae < tol:
            _fail(f"whole-net {tname} {kernel_mlp} MAE {mae} >= {tol}")

    # --- 6. the kernels line, then the device line ----------------------------
    sources = {"K1": ("flash_qkv_self_attention", "crossscore_tpu_torch/csrc/flash_qkv.cu",
                      "crossscore_tpu/ops/flash_attention.py:1347"),
               "K2": ("fused_ln_mlp", "crossscore_tpu_torch/csrc/fused_ln_mlp.cu",
                      "crossscore_tpu/ops/fused_mlp.py:64"),
               "K3": ("flash_cross_attention", "crossscore_tpu_torch/csrc/flash_cross.cu",
                      "crossscore_tpu/ops/flash_attention.py:799")}
    kernels = []
    for kern, (fn, src, replaces) in sources.items():
        r, r32 = report[(kern, "bfloat16")], report[(kern, "float32")]
        row = {"name": fn, "route": "cuda", "source": src, "replaces": replaces,
               "launches": launches[kern], "max_abs_err": r["max_abs"], "ms": r["ms"],
               "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
               "library_ms": r["library_ms"], "rel_err": r["err"], "tol": TOL["bfloat16"],
               "fp32": {k: r32[k] for k in ("err", "max_abs", "ms", "plain_ms", "library_ms", "bound_ms")},
               "shape": {"K1": f"qkv ({views}, {n}, {3 * d}) bf16",
                         "K2": f"x ({views}, {n}, {d}) bf16, F={f}",
                         "K3": f"q ({B}, {nq}, {d}), k/v ({B}, {K * nq}, {d}) bf16, hd {d // dec_h}"}[kern]}
        if kern == "K3":
            s, s32 = report[("K3self", "bfloat16")], report[("K3self", "float32")]
            row["self"] = {k: s[k] for k in ("err", "max_abs", "ms", "plain_ms", "library_ms", "bound_ms")}
            row["self_fp32"] = {k: s32[k] for k in ("err", "max_abs", "ms", "plain_ms", "library_ms", "bound_ms")}
        kernels.append(row)
    print(json.dumps({"kernels": kernels, "card": card, "maps_per_s": 1e3 * B / step_ms,
                      "step_ms": step_ms}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
