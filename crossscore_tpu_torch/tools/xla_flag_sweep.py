"""The predict forward under sets of device-code compiler flags; the
counterpart of the TPU tool ``tools/xla_flag_sweep.py``.

    python -m crossscore_tpu_torch.tools.xla_flag_sweep                 # the DEFAULT subset
    python -m crossscore_tpu_torch.tools.xla_flag_sweep all             # every set
    python -m crossscore_tpu_torch.tools.xla_flag_sweep baseline ptxas_o2  # named sets
        [--cpu]

The JAX tool times the full forward at the bench point (B=8, K=8, 518 px,
bf16) under per-compile XLA option sets. The port's compile is ``nvcc``
(``ops/_build.py``'s ``NVCC_FLAGS``), so each set here adds device-code flags
to it: ``-Xptxas -O2`` / ``-O1`` below ptxas's default ``-O3``,
``--use_fast_math``, a register cap and nvcc's extra device vectorisation.
The host ``-O3`` only shapes the kernels' C wrappers, so it has no device
counterpart and is not swept.

A set builds the predict path's three sources (``flash_qkv``, ``flash_cross``,
``fused_ln_mlp``) with its flags into a build directory of its own,
``<build dir>/flags-<set>/`` (``baseline`` adds no flag and uses the build
directory as it is), through ``_build.set_extra_flags``, which only this
tool calls. The set counts only if K1, K2 and K3 built with it pass the
checks ``chip_smoke.py`` step 3 applies to them at the predict shapes (max
|d| / (1 + |plain|) of every output at most 1.6e-2, and the relative L2 of
K1's and K3's o, l and m at most 8e-3, in bf16, against the plain versions);
then ``make_predict_step`` is timed, the median of 8 calls by CUDA
events after two warm-up calls, each call on a query of its own. A line
names the libraries the timed calls loaded, so that a reader sees the
variant's files were the ones timed. A set that does not build, or fails a
check, is reported as ``REJECTED: <first 200 characters>``, as the JAX tool
reports a flag its compiler refuses; the run goes on and exits 0. The last
lines rank the sets. ``--cpu`` builds nothing and times the plain versions
at a small shape (dinov2-test, B=1, K=2, 56 px); without it the tool needs
a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import itertools
import sys
import time
from pathlib import Path

import torch

from crossscore_tpu_torch.tools._common import card_tag, device_line, resolve_device, times_ms

BATCH, K, HW = 8, 8, 518
CPU_POINT = ("dinov2-test", 1, 2, 56)  # preset, B, K, hw
REPS, SEED = 8, 0

# device-code flags added to the port's nvcc command, one set a build
SETS = {
    "baseline": (),
    "ptxas_o2": ("-Xptxas", "-O2"),
    "ptxas_o1": ("-Xptxas", "-O1"),
    "fast_math": ("--use_fast_math",),
    "maxrreg_168": ("-maxrregcount=168",),
    "extra_vec": ("--extra-device-vectorization",),
}
DEFAULT = ["baseline", "ptxas_o2", "fast_math", "maxrreg_168"]
SOURCES = ("flash_qkv", "flash_cross", "fused_ln_mlp")  # K1, K3, K2: the predict path's
TOL, TOL_L2 = 1.6e-2, 8e-3  # chip_smoke.py step 3, bf16


def _rel_err(got, want) -> float:
    got, want = got.float(), want.float()
    return float(((got - want).abs() / (1.0 + want.abs())).max())


def _rel_l2(got, want) -> float:
    got, want = got.double(), want.double()
    norm = float(want.norm())
    return float((got - want).norm()) / norm if norm else float(got.abs().max())


def check_inputs(mcfg, b: int, k: int, hw: int, device, gen: torch.Generator) -> list:
    """The predict shapes' K1, K2 and K3 cases: [(name, kernel call, plain
    outputs)], the plain versions run once here."""
    from crossscore_tpu_torch.ops.flash_attention import (
        flash_cross_attention, flash_cross_attention_plain, flash_qkv_self_attention,
        flash_qkv_self_attention_plain,
    )
    from crossscore_tpu_torch.ops.fused_mlp import fused_ln_mlp, fused_ln_mlp_plain

    vit = mcfg.backbone
    d, h, f, eps = vit.hidden_size, vit.num_heads, vit.mlp_ratio * vit.hidden_size, vit.layer_norm_eps
    views, nq = b * (1 + k), (hw // mcfg.patch_size) ** 2
    dec_h = mcfg.decoder_heads

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=gen, device=device) * scale).to(dtype)

    qkv = randn(views, nq + 1, 3 * d)
    x = randn(views, nq + 1, d)
    mlp = (randn(d, scale=0.1, dtype=torch.float32) + 1, randn(d, scale=0.1, dtype=torch.float32),
           randn(f, d, scale=d ** -0.5, dtype=torch.float32), randn(f, scale=0.1, dtype=torch.float32),
           randn(d, f, scale=f ** -0.5, dtype=torch.float32), randn(d, scale=0.1, dtype=torch.float32),
           randn(d, scale=0.5, dtype=torch.float32) + 1)
    q, kv = randn(b, nq, d), [randn(b, k * nq, d) for _ in range(2)]
    return [("K1", lambda: flash_qkv_self_attention(qkv, h), flash_qkv_self_attention_plain(qkv, h)),
            ("K2", lambda: (fused_ln_mlp(x, *mlp, eps, "tanh"),), (fused_ln_mlp_plain(x, *mlp, eps, "tanh"),)),
            ("K3", lambda: flash_cross_attention(q, *kv, dec_h), flash_cross_attention_plain(q, *kv, dec_h))]


def check(cases: list) -> list:
    """The failed checks of the kernels as built now, as strings."""
    failed = []
    for name, call, want in cases:
        got = call()
        err = max(_rel_err(g, w) for g, w in zip(got, want))
        l2 = max(_rel_l2(g, w) for g, w in zip(got, want)) if len(want) > 1 else 0.0
        if not err <= TOL or not l2 <= TOL_L2:  # a NaN fails
            failed.append(f"{name} max|d|/(1+|plain|) {err:.3e} (tol {TOL:g}), relative L2 {l2:.3e} "
                          f"(tol {TOL_L2:g})")
    return failed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0],
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("sets", nargs="*", help="'all', or names of SETS (default: DEFAULT)")
    ap.add_argument("--cpu", action="store_true", help="no build: the plain versions on the CPU, small shape")
    args = ap.parse_args(argv)
    names = args.sets or DEFAULT
    if names == ["all"]:
        names = list(SETS)
    for n in names:
        if n not in SETS:
            raise SystemExit(f"unknown set {n!r}; known: {list(SETS)}")
    device = resolve_device(args.cpu)
    if device is None:
        return 1

    from crossscore_tpu_torch.ops import _build
    from crossscore_tpu_torch.tools.stress_vitl import build
    from crossscore_tpu_torch.train.step import make_predict_step
    from crossscore_tpu_torch.utils import compilation_cache

    cuda = device.type == "cuda"
    preset, b, k, hw = CPU_POINT if args.cpu else ("dinov2-small", BATCH, K, HW)
    _, mcfg, model = build(preset, [], device, SEED)
    tag = card_tag(device)
    print(device_line(device))
    print(f"forward: {preset}, B={b}, K={k}, {hw} px, bf16; median of {REPS} calls a set; sources "
          f"{', '.join(SOURCES)}; nvcc {' '.join(_build.NVCC_FLAGS)} + the set's flags", flush=True)
    gen = torch.Generator(device=device).manual_seed(SEED)
    cases = check_inputs(mcfg, b, k, hw, device, gen)
    refs = torch.randn(b, k, hw, hw, 3, generator=gen, device=device).to(torch.bfloat16)
    query = torch.randn(b, hw, hw, 3, generator=gen, device=device).to(torch.bfloat16)
    queries = itertools.cycle([query * (1.0 + 1e-3 * i) for i in range(4)])
    step = make_predict_step(model)
    base_dir, prev_dir = _build.build_dir(), _build._build_dir

    results = []
    for name in names:
        flags = SETS[name]
        try:
            if flags:
                compilation_cache.enable(base_dir / f"flags-{name}")
            _build.set_extra_flags(flags)
            t = time.perf_counter()
            if cuda:
                _build.build_all(SOURCES)
            build_s = time.perf_counter() - t
            failed = check(cases)
            if failed:
                raise RuntimeError("check " + "; ".join(failed))
            with torch.no_grad():
                ts = times_ms(lambda: step(next(queries), refs), device, REPS)
            if cuda:  # the libraries the timed calls ran: the set's own files
                loaded = {src: Path(_build._libs[src]._name) for src in SOURCES}
                if any(p != _build.library_path(src) for src, p in loaded.items()):
                    raise RuntimeError(f"the timed calls loaded other libraries: {loaded}")
                where = f"{loaded['flash_qkv'].parent.name}/*-{_build._digest()}.so"
            else:
                where = "no build (plain versions)"
            ms = sorted(ts)[len(ts) // 2]
            print(f"{name:20s} {ms:8.3f} ms/fwd  {b / (ms / 1e3):7.2f} maps/s  (build {build_s:.1f}s, runs "
                  f"{'/'.join(f'{x:.2f}' for x in ts)}ms; {where})  [{tag}]", flush=True)
            results.append((name, ms, b / (ms / 1e3)))
        except Exception as e:  # a set the compiler or a check refuses is data, as in the JAX tool
            print(f"{name:20s} REJECTED: {str(e)[:200]}", flush=True)
            results.append((name, float("inf"), 0.0))
        finally:
            _build.set_extra_flags(())
            _build.set_build_dir(prev_dir)

    print("\nranked:")
    for name, ms, maps_s in sorted(results, key=lambda r: r[1]):
        print(f"  {name:20s} {ms:8.3f} ms/fwd  {maps_s:7.2f} maps/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
