"""A trace's device time by kernel family and layer group; the counterpart of
the TPU tool ``tools/trace_breakdown.py``.

    python -m crossscore_tpu_torch.tools.trace_breakdown [TRACE] [--cpu]

With no argument it captures three forwards of the backbone at the bench
point (72 views at 518 px, bf16, ``flash`` attention, the ``fused`` MLP;
one forward of warm-up before them) under ``torch.profiler`` with
``record_shapes=True`` into a temporary Chrome trace, then analyses it. With
a path it analyses an existing Chrome trace: a file, or a directory whose
``trace.json`` or newest ``*.json`` is taken, such as the file that
``tools/torch_step_profile.py --trace`` writes or the train CLI's profiler
window (``trainer.do_profiling``, ``<profile_dir>/trace.json``).

:func:`analyse` reads the trace's ``kernel`` events (their ``dur`` in µs)
and prints the device total per run with the event count, then the top 20
kernel families by ms per run, with launches per run and each family's
layer group, then the groups' sums. A family is a kernel's name up to its
template arguments or parameter list; the group is :func:`kernel_group`'s,
which ``tools/torch_step_profile.py`` and ``chip_smoke.py`` share. A trace
with no kernel event (a capture on the CPU) is read by its ``cpu_op``
events instead, which nest, so their sum is no device time. The TPU tool's
XSpace parsing has no counterpart: a ``torch.profiler`` trace is JSON.
``--cpu`` captures at a small shape (dinov2-test, 2 views at 56 px) with
the plain versions; without it the capture needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import tempfile
from collections import Counter
from pathlib import Path

import torch

from crossscore_tpu_torch.tools._common import card_tag, device_line, resolve_device

VIEWS, HW = 72, 518  # the bench point's backbone: B=8 queries and K=8 references
CPU_VIEWS, CPU_HW, CPU_PRESET = 2, 56, "dinov2-test"
RUNS = 3
TOP = 20


def kernel_group(name: str) -> str:
    """The layer group of a kernel, from its name as the profiler gives it
    (demangled, ``cs::ln_mlp_tma<384, false, true>(...)``) or mangled
    (``_ZN2cs10ln_mlp_tmaILi384ELb0ELb1EE...``)."""
    # the attention forward's kernels are templates on the head dim first:
    # the backbone's is 64, the decoder's 48 (fp32: the 3xTF32 body,
    # attn_fwd_tf32, and its pre-pass, attn_fwd_split_kv, in the same group)
    if re.search(r"attn_fwd_\w*?(<64\b|ILi64E)", name):
        return "K1 backbone attention"
    if "attn_fwd" in name:
        return "K3 decoder attention"
    # the decoder attention's backward: the statistics pass and the two
    # wgmma passes (K8/K9 under tp run the same kernels)
    if "attn_bwd" in name or "bwd_stats" in name:
        return "K4 decoder attention backward"
    # the fused MLP's bf16 and fp32 kernels take RES (K10) second
    if re.search(r"ln_mlp_(tma|wide|f32)(<\s*\d+\s*,\s*(true|1)\b|ILi\d+ELb1E)", name):
        return "K10 fused residual LN-MLP"
    if "ln_mlp" in name:
        return "K2 fused LN-MLP"
    # the int8 backbone's kernels (model.gpu.backbone_quant=int8)
    if "quantize_rows_kernel" in name:
        return "Q1 int8 row quantise"
    if "int8_linear_kernel" in name:
        return "Q2 int8 linear"
    if any(s in name.lower() for s in ("gemm", "cutlass", "xmma", "cublas", "sm90_", "nvjet")):
        return "matrix products (cuBLAS)"
    return "elementwise, reductions, copies"


def counts_as_launch(name: str) -> bool:
    """Whether a kernel is a launch that its wrapper counts in ``.launches``:
    the fp32 attention's pre-pass (``attn_fwd_split_kv``) runs before the
    body (``attn_fwd_tf32``) inside the one launch that K1, K3, K5, K6 or K7
    counts, so its time is its group's but it is no launch of its own."""
    return "attn_fwd_split_kv" not in name


def family(name: str) -> str:
    """A kernel's name up to its template arguments or parameter list, its
    return type and anonymous namespaces dropped (``void
    cs::attn_fwd_wgmma<64, ...>(...)`` -> ``cs::attn_fwd_wgmma``;
    ``void at::native::(anonymous namespace)::reduce<...>(...)`` ->
    ``at::native::reduce``)."""
    name = name.replace("(anonymous namespace)::", "")
    name = name[len("void "):] if name.startswith("void ") else name
    return re.split(r"[<(]", name, maxsplit=1)[0].strip()


def trace_file(path) -> Path:
    """``path`` if it is a file, else its directory's ``trace.json``, else the
    directory's newest ``*.json``."""
    path = Path(path)
    if path.is_file():
        return path
    if (path / "trace.json").is_file():
        return path / "trace.json"
    found = sorted(path.glob("*.json"), key=lambda p: p.stat().st_mtime)
    if not found:
        raise SystemExit(f"no Chrome trace at {path}")
    return found[-1]


def load_events(path) -> list:
    """The ``traceEvents`` of a Chrome trace (``path`` as :func:`trace_file`)."""
    blob = json.loads(trace_file(path).read_text())
    return blob["traceEvents"] if isinstance(blob, dict) else blob


def timed_events(events: list, category: str | None = None) -> tuple[str, list]:
    """(the category read, its complete events): ``kernel`` unless the trace
    holds none, then ``cpu_op``; or ``category`` as given."""
    if category is None:
        category = "kernel" if any(e.get("cat") == "kernel" for e in events) else "cpu_op"
    return category, [e for e in events if e.get("cat") == category and "dur" in e]


def analyse(path, n_runs: int = RUNS, category: str | None = None, tag: str = "") -> dict:
    """Print the trace's time per run by kernel family and by layer group
    (``category`` as :func:`timed_events`; ``tag``, the card's line, closes
    the total's line); return ``{"category", "events",
    "total_ms", "families": [(family, group, ms per run, launches per run)],
    "groups": {group: ms per run}}``, every family and group."""
    category, evs = timed_events(load_events(path), category)
    ms, count = Counter(), Counter()
    for e in evs:
        key = (family(e["name"]), kernel_group(e["name"]))
        ms[key] += e["dur"] / 1e3 / n_runs
        count[key] += 1
    groups = Counter()
    for (_, grp), v in ms.items():
        groups[grp] += v
    total = sum(ms.values())
    where = "device" if category == "kernel" else "host, nested (no kernel event: a CPU capture)"
    print(f"{where} [{category}]: {total:.3f} ms/run over {len(evs)} events ({n_runs} runs)"
          + (f"  [{tag}]" if tag else ""))
    for (fam, grp), v in ms.most_common(TOP):
        print(f"   {v:9.3f} ms  x{count[(fam, grp)] // n_runs:4d}  {grp:32s} {fam[:100]}")
    print("by group:")
    for grp, v in groups.most_common():
        print(f"   {v:9.3f} ms  {100 * v / total if total else 0.0:5.1f}%  {grp}")
    return {"category": category, "events": len(evs), "total_ms": total,
            "families": [(fam, grp, v, count[(fam, grp)] / n_runs) for (fam, grp), v in ms.most_common()],
            "groups": dict(groups)}


def capture(trace_path, device: torch.device) -> None:
    """The backbone's forward at the bench point (on the CPU: dinov2-test, 2
    views at 56 px), one warm-up and :data:`RUNS` forwards under the profiler
    on distinct inputs, written to ``trace_path`` as a Chrome trace."""
    from torch.profiler import ProfilerActivity, profile

    from crossscore_tpu_torch.tools.stress_vitl import build

    cpu = device.type == "cpu"
    views, hw = (CPU_VIEWS, CPU_HW) if cpu else (VIEWS, HW)
    _, mcfg, model = build(CPU_PRESET if cpu else "dinov2-small", [], device, 0)
    enc = model.backbone  # bf16 compute, flash attention, the fused MLP
    gen = torch.Generator(device=device).manual_seed(0)
    imgs = [torch.randn(views, hw, hw, 3, generator=gen, device=device).to(torch.bfloat16)
            for _ in range(1 + RUNS)]
    activities = [ProfilerActivity.CPU] + ([] if cpu else [ProfilerActivity.CUDA])
    with torch.no_grad():
        enc(imgs[0])
        if not cpu:
            torch.cuda.synchronize()
        with profile(activities=activities, record_shapes=True) as prof:
            for x in imgs[1:]:
                enc(x)
            if not cpu:
                torch.cuda.synchronize()
    Path(trace_path).parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace_path))
    print(f"trace captured -> {trace_path}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0],
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("trace", nargs="?", help="a Chrome trace, or a directory holding one")
    ap.add_argument("--cpu", action="store_true", help="capture with the plain versions on the CPU, small shape")
    args = ap.parse_args(argv)
    if args.trace:
        return 0 if analyse(args.trace)["events"] else 1
    device = resolve_device(args.cpu)
    if device is None:
        return 1
    print(device_line(device), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        capture(path, device)
        res = analyse(path, tag=card_tag(device))
    # a capture on the card that holds no kernel is a lost trace
    return 0 if res["events"] and (device.type == "cpu" or res["category"] == "kernel") else 1


if __name__ == "__main__":
    sys.exit(main())
