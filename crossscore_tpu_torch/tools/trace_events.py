"""The top single kernels of a trace, each with the op that launched it and
that op's input shapes; the counterpart of the TPU tool
``tools/trace_events.py``.

    python -m crossscore_tpu_torch.tools.trace_events TRACE [n_runs] [family_filter]

Reads a ``torch.profiler`` Chrome trace (a file, or a directory as
``trace_breakdown`` takes it) and prints the top 40 kernels by full name
(not by family) by ms per run, with launches per run. Under each it prints
the op that launched its first launch, found through the trace's links: the
kernel's ``correlation`` to the runtime call that launched it (``cudaLaunchKernel``
and the like), that call's ``External id`` to the ``cpu_op`` around it, and that op's
``Input Dims``, which a capture records under ``record_shapes=True`` (as
``trace_breakdown`` and ``train_trace`` capture). A kernel the port launches
through ctypes has no ATen op of its own: the innermost op around it is
named, or none. ``family_filter`` keeps the kernels whose name contains it.
The TPU tool's HLO long names have no counterpart; the op and its shapes
take their place. A trace with no kernel event is read by its ``cpu_op``
events, as ``trace_breakdown`` reads it.
"""

from __future__ import annotations

import sys
from collections import Counter

from crossscore_tpu_torch.tools.trace_breakdown import load_events, timed_events

TOP = 40
RUNTIME_CATEGORIES = ("cuda_runtime", "cuda_driver")


def launching_ops(events: list) -> dict:
    """{a kernel's correlation id: (op name, its input shapes or None)}, by
    the kernel -> runtime call -> ``cpu_op`` links (the kernel's own
    ``External id`` where its runtime call is missing)."""
    ops = {e["args"]["External id"]: e for e in events
           if e.get("cat") == "cpu_op" and "External id" in e.get("args", {})}
    runtime = {e["args"]["correlation"]: e for e in events
               if e.get("cat") in RUNTIME_CATEGORIES and "correlation" in e.get("args", {})}
    out = {}
    for e in events:
        args = e.get("args", {})
        if e.get("cat") != "kernel" or "correlation" not in args:
            continue
        call = runtime.get(args["correlation"])
        ext = call["args"].get("External id") if call is not None else args.get("External id")
        op = ops.get(ext)
        if op is not None:
            out[args["correlation"]] = (op["name"], op["args"].get("Input Dims"))
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0 if argv else 2
    path = argv[0]
    n_runs = int(argv[1]) if len(argv) > 1 else 3
    fam = argv[2] if len(argv) > 2 else None

    events = load_events(path)
    category, evs = timed_events(events)
    links = launching_ops(events)
    ms, count, first = Counter(), Counter(), {}
    for e in evs:
        name = e["name"]
        if fam and fam not in name:
            continue
        ms[name] += e["dur"] / 1e3 / n_runs
        count[name] += 1
        first.setdefault(name, e.get("args", {}).get("correlation"))
    where = "device" if category == "kernel" else "host, nested"
    print(f"{where} [{category}]: {sum(ms.values()):.3f} ms/run in filter {fam or '<all>'} "
          f"({sum(count.values())} events, {n_runs} runs)")
    for name, v in ms.most_common(TOP):
        print(f"  {v:9.3f} ms x{count[name] // max(1, n_runs):4d}  {name[:200]}")
        op = links.get(first[name])
        if category == "kernel":
            shapes = op[1] if op and op[1] is not None else "not recorded"
            launched = f"{op[0]}, input shapes {shapes}" if op else "no op recorded"
            print(f"             launched by {launched}"[:240])
    return 0


if __name__ == "__main__":
    sys.exit(main())
