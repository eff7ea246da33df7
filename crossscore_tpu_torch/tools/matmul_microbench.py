"""int8 against bf16 products at the backbone's operating point; the
counterpart of the TPU tool ``tools/matmul_microbench.py``. With
``--against``, two builds of ``csrc/int8_linear.cu`` side by side.

    python -m crossscore_tpu_torch.tools.matmul_microbench [mode ...] [--cpu] [--reps N] [--seed N]
    python -m crossscore_tpu_torch.tools.matmul_microbench --against DIR [--products-only] [mode ...]

Times the backbone products of the predict point (72 views x 1370
tokens = 98,640 rows): fc1 (384 -> 1536), fc2 (1536 -> 384), qkv
(384 -> 1152), out (384 -> 384), and out's row shards under ``tp`` at TP 2
and 4 (192 and 96 -> 384), no bias. Modes (all by default), the TPU tool's
four and two yardsticks:

    bf16         F.linear on bf16 x and the bf16 weight (cuBLAS)
    int8         the backbone's W8A8 linear: Q1 on x and on the fp32 weight,
                 then Q2 (``ops.quant.int8_linear``)
    int8_static  a weight quantised once and a fixed activation scale (|x| <=
                 4): one PyTorch pass quantises x (no absmax), then Q2
    int8_pure    Q2 alone on operands already int8
    int8_s32     Q2's int32 form alone on the int8_pure operands (the
                 tensor-parallel row layer's product, ``int8_matmul_s32``)
    int8_lib     the yardstick: ``torch._int_mm`` and a PyTorch dequantisation
                 on the same int8 operands (no model path calls it)

A row is the median of three in-stream means over ``--reps`` back-to-back
calls (at least 5), after two warm-up calls, by CUDA events; TOP/s counts
2 M K N operations. Each product then prints the byte bounds of Q2 (bf16
out) and of its int32 form at the H100's 3.35 TB/s, and the int8 mode's
largest absolute difference from bf16. ``--cpu`` runs the plain versions at
a small shape (64 rows, the widths divided by 4); without it the tool needs
a CUDA card.

``--against DIR`` builds another checkout's ``csrc/int8_linear.cu`` (Q1, Q2
and its int32 form) with this tree's flags, such as the parent commit
unpacked with ``git archive``, and binds it in place of this tree's library
for its turns: every mode that launches it is timed in turns other / this /
this / other. Then, unless ``--products-only``, the int8 predict step (518
px, K=8, B=8), the int8 pixel train step (B=24, K=5), the int8 ``tp`` train
step (TP = 1 on one NCCL rank, the MLP split) and dinov2-large's int8
forward (1036 px, K=5, B=1), each timed by CUDA events in the same turns.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import hashlib
import os
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

from crossscore_tpu_torch.ops import _build
from crossscore_tpu_torch.ops.quant import int8_linear, int8_matmul_s32
from crossscore_tpu_torch.tools._common import H100_BYTES_PER_S, device_line, resolve_device, stream_ms, times_ms

M = 72 * 1370
PRODUCTS = (("fc1", 384, 1536), ("fc2", 1536, 384), ("qkv", 384, 3 * 384), ("out", 384, 384),
            ("out/2", 192, 384), ("out/4", 96, 384))  # (tag, K, N)
CPU_M, CPU_DIV = 64, 4
MODES = ("bf16", "int8", "int8_static", "int8_pure", "int8_s32", "int8_lib")
X_SCALE = 4.0 / 127.0  # the TPU tool's static calibration: |x| <= 4
SOURCE = "int8_linear"
AB_MODES = ("int8", "int8_static", "int8_pure", "int8_s32")  # the modes that launch csrc/int8_linear.cu
TURNS = ("other", "this", "this", "other")


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
            "int8_s32": lambda: int8_matmul_s32(o["xq0"], o["wq"]),
            "int8_lib": lambda: (torch._int_mm(o["xq0"], o["wq"].t()).float() * o["sx"] * o["sw"].t()).to(
                torch.bfloat16)}


def build_other(root: Path, source: str = SOURCE) -> Path:
    """``root``'s ``csrc/<source>.cu`` (the int8 kernels unless named)
    compiled with this tree's flags, unless built -> the library's path
    (hashed on that checkout's sources)."""
    csrc = root / "crossscore_tpu_torch" / "csrc"
    h = hashlib.sha256(" ".join(_build.NVCC_FLAGS).encode())
    for p in sorted(csrc.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    out = _build.build_dir() / "other" / f"{source}-{h.hexdigest()[:16]}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(tmp), str(csrc / f"{source}.cu")],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed for {csrc / source}.cu:\n{(res.stdout + res.stderr)[-4000:]}")
        os.replace(tmp, out)
    return out


@contextlib.contextmanager
def bound(lib):
    """``lib`` as the loaded int8 library for the block."""
    saved = _build._libs.get(SOURCE)
    _build._libs[SOURCE] = lib
    try:
        yield
    finally:
        _build._libs[SOURCE] = saved


def in_turns(libs: dict, fn) -> dict:
    """``fn()`` with each turn's library bound, in the turns other / this /
    this / other -> turn -> its results in order."""
    out = {t: [] for t in libs}
    for turn in TURNS:
        with bound(libs[turn]):
            out[turn].append(fn())
    return out


@contextlib.contextmanager
def one_nccl_rank():
    """This process as the one rank of an NCCL process group, one model rank."""
    from crossscore_tpu_torch.parallel import mesh
    from crossscore_tpu_torch.parallel.launch import free_port

    env = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", LOCAL_WORLD_SIZE="1", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(free_port()))
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        mesh.init_distributed("nccl", "cuda")
        mesh.make_groups(1)
        yield
    finally:
        mesh.teardown()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def steps(libs: dict, dev, seed: int) -> None:
    """The int8 model steps, each timed in turns: the median of every
    turn's CUDA-event timed calls (5 a turn of the predict step, 2 of the
    others), after one warm-up call a turn."""
    from crossscore_tpu_torch.confsys import load_config
    from crossscore_tpu_torch.io.convert import init_params, load_into
    from crossscore_tpu_torch.models import CrossScoreConfig, CrossScoreNet
    from crossscore_tpu_torch.tools import stress_vitl
    from crossscore_tpu_torch.train.optim import make_optimizer
    from crossscore_tpu_torch.train.step import TrainState, make_predict_step, make_train_step

    def report(what: str, fn, reps: int) -> None:
        times = {t: sum(v, []) for t, v in in_turns(libs, lambda: times_ms(fn, dev, reps, warmup=1)).items()}
        line = []
        for t in ("other", "this"):
            ts = sorted(times[t])
            line.append(f"{t} {ts[len(ts) // 2]:.2f} ms (spread {ts[0]:.2f}-{ts[-1]:.2f})")
        print(f"{what}: " + ", ".join(line) + f", medians of {2 * reps} in turns", flush=True)

    gen = torch.Generator(device=dev).manual_seed(seed)
    cfg = CrossScoreConfig()
    cfg8 = dataclasses.replace(cfg, backbone_quant="int8")
    params = init_params(cfg, seed, dev)
    b, k, hw, tb, tk = 8, 8, 518, 24, 5
    query = torch.randint(0, 256, (b, hw, hw, 3), generator=gen, device=dev, dtype=torch.uint8)
    refs = torch.randint(0, 256, (b, k, hw, hw, 3), generator=gen, device=dev, dtype=torch.uint8)
    step = make_predict_step(load_into(CrossScoreNet(cfg8, device=dev), params))
    report(f"int8 predict step (dinov2-small, {hw} px, K={k}, B={b})", lambda: step(query, refs), 5)
    del step, query, refs
    torch.cuda.empty_cache()

    batch = {"query/img": torch.randint(0, 256, (tb, hw, hw, 3), generator=gen, device=dev, dtype=torch.uint8),
             "reference/cross/imgs": torch.randint(0, 256, (tb, tk, hw, hw, 3), generator=gen, device=dev,
                                                   dtype=torch.uint8),
             "query/score_map": torch.rand(tb, hw, hw, generator=gen, device=dev),
             "_valid": torch.tensor(tb, device=dev)}
    tcfg = load_config("default")

    def train_step(c):
        net = load_into(CrossScoreNet(c, device=dev), params)
        optimizer, scheduler, _ = make_optimizer(tcfg, net, steps_per_epoch=1)
        fn = make_train_step(net, optimizer, scheduler)
        state, _ = fn(TrainState(), batch)
        return lambda: fn(state, batch)

    report(f"int8 pixel train step (B={tb}, K={tk}, {hw} px)", train_step(cfg8), 2)
    with one_nccl_rank():
        report(f"int8 tp train step (TP = 1, unfused; B={tb}, K={tk})",
               train_step(dataclasses.replace(cfg8, attention_impl="tp", mlp_impl="unfused")), 2)
    del batch, params
    torch.cuda.empty_cache()

    _, mcfg_l, model_l = stress_vitl.build("dinov2-large", [], dev, seed)
    net_l = load_into(CrossScoreNet(dataclasses.replace(mcfg_l, backbone_quant="int8"), device=dev),
                      model_l.state_dict())
    del model_l
    lb = stress_vitl.make_batch(gen, dev, 1, 5, 1036, mcfg_l.backbone.hidden_size)
    step = make_predict_step(net_l)
    report("dinov2-large int8 forward (1036 px, K=5, B=1)",
           lambda: step(lb["query/img"], lb["reference/cross/imgs"]), 2)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0],
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("modes", nargs="*", help=f"modes ({', '.join(MODES)}); all by default")
    ap.add_argument("--cpu", action="store_true", help="run the plain versions on the CPU at a small shape")
    ap.add_argument("--reps", type=int, default=5, help="back-to-back calls a mean, at least 5")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--against", type=Path, help="another checkout's root: its int8 kernels in turns with this tree's")
    ap.add_argument("--products-only", action="store_true", help="with --against: the products, no model step")
    args = ap.parse_args(argv)
    if args.reps < 5:
        ap.error("--reps must be at least 5")
    bad = [a for a in args.modes if a not in MODES]
    if bad:
        ap.error(f"unknown mode {bad[0]!r}: expected one of {', '.join(MODES)}")
    if args.against is not None and args.cpu:
        ap.error("--against times the kernels: it needs the card, not --cpu")
    if args.products_only and args.against is None:
        ap.error("--products-only goes with --against")
    modes = args.modes or list(MODES)
    device = resolve_device(args.cpu)
    if device is None:
        return 1
    libs = None
    if args.against is not None:
        libs = {"other": ctypes.CDLL(str(build_other(args.against.resolve()))), "this": _build.load(SOURCE)}
    m, div = (CPU_M, CPU_DIV) if args.cpu else (M, 1)
    print(device_line(device))
    print(f"rows {m}, bf16 activations, fp32 weights for int8, median of 3 in-stream means of {args.reps} calls, "
          f"seed {args.seed}" + (f"; other: {args.against}'s int8 kernels, in turns other / this / this / other"
                                 if libs else ""), flush=True)
    host = "" if device.type == "cuda" else " (host)"
    for tag, k, n in PRODUCTS:
        k, n = k // div, n // div
        o = operands(m, k, n, device, args.seed)
        fns = mode_fns(o)
        tera = 2.0 * m * k * n / 1e12
        for mode in modes:
            unit = "TFLOP/s" if mode == "bf16" else "TOP/s"
            if libs and mode in AB_MODES:
                t = in_turns(libs, lambda: stream_ms(fns[mode], device, args.reps))
                ms = sum(t["this"]) / 2
                when = ("other " + ", ".join(f"{v:.3f}" for v in t["other"]) + " / this "
                        + ", ".join(f"{v:.3f}" for v in t["this"]))
            else:
                ms = stream_ms(fns[mode], device, args.reps)
                when = f"{ms:7.3f}"
            print(f"{tag:5s} {mode:11s}: {when} ms  {tera / (ms / 1e3):7.1f} {unit}{host}  ({m} x {k} -> {n})",
                  flush=True)
        io = m * k + n * k  # the int8 operands, read once
        q2_ms, s32_ms = (1e3 * (io + extra) / H100_BYTES_PER_S for extra in (4 * (m + n) + 2 * m * n, 4 * m * n))
        print(f"{tag:5s} byte bounds at 3.35 TB/s: Q2 (bf16 out) {q2_ms:.3f} ms, its int32 form {s32_ms:.3f} ms",
              flush=True)
        err = (int8_linear(o["x"], o["w"]).float() - F.linear(o["x"], o["w_bf16"]).float()).abs().max()
        print(f"{tag:5s} int8-vs-bf16 max abs err: {float(err):.4f}", flush=True)
    if libs and not args.products_only:
        steps(libs, device, args.seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
