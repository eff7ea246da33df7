"""A device profile of the whole train step and its breakdown by kernel
family; the counterpart of the TPU tool ``tools/train_trace.py``.

    python -m crossscore_tpu_torch.tools.train_trace [batch] [k] [trace_path] [tokens] [--cpu]

Runs the train step (``make_train_step``: the forward with the frozen
backbone, the L1 loss, the backward and AdamW over the decoder and head) at
the production operating point, B=24, K=5, 518 px, bf16 compute and fp32
master weights, from the port's seeded init: one warm-up step, then three
steps on inputs of their own under ``torch.profiler`` (``record_shapes=True``),
written as a Chrome trace to ``trace_path`` (default: a temporary file,
removed after the analysis). A fourth argument ``tokens`` runs the
token-space step instead: the decoder-only graph over cached backbone
tokens (B x 1369 query and B x K x 1369 reference tokens of D 384). The
trace is then analysed by ``trace_breakdown.analyse``, as the JAX tool
imports its ``analyse``. ``--cpu`` runs the plain versions on the CPU at a
small shape (dinov2-test at 56 px); without it the tool needs a CUDA card.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path

import torch

from crossscore_tpu_torch.tools._common import card_tag, device_line, resolve_device
from crossscore_tpu_torch.tools.trace_breakdown import analyse
from crossscore_tpu_torch.tools.train_microbench import train_setup

WARMUP, STEPS = 1, 3  # steps run: WARMUP + STEPS, the last STEPS traced


def capture(trace_path, batch_size: int, k: int, tokens: bool, device: torch.device) -> None:
    """:data:`WARMUP` train steps, then :data:`STEPS` under the profiler, each
    on a batch of its own, into ``trace_path``."""
    from torch.profiler import ProfilerActivity, profile

    from crossscore_tpu_torch.train.step import TrainState

    cpu = device.type == "cpu"
    step, batches, hw = train_setup(device, batch_size, k, WARMUP + STEPS, tokens)
    sync = (lambda: None) if cpu else torch.cuda.synchronize
    state = TrainState()
    for batch in batches[:WARMUP]:
        state, metrics = step(state, batch)
    float(metrics["loss"])
    sync()
    activities = [ProfilerActivity.CPU] + ([] if cpu else [ProfilerActivity.CUDA])
    with profile(activities=activities, record_shapes=True) as prof:
        for batch in batches[WARMUP:]:
            state, metrics = step(state, batch)
        float(metrics["loss"])
        sync()
    Path(trace_path).parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace_path))
    what = "token-space train-step" if tokens else "train-step"
    print(f"{what} trace captured -> {trace_path} (B={batch_size}, K={k}, {hw} px, last loss "
          f"{float(metrics['loss']):.6f})", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0],
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("args", nargs="*", help="[batch] [k] [trace_path] [tokens]")
    ap.add_argument("--cpu", action="store_true", help="the plain versions on the CPU at a small shape")
    args = ap.parse_args(argv)
    pos = args.args
    if len(pos) > 4 or (len(pos) > 3 and pos[3] != "tokens"):
        ap.error("expected [batch] [k] [trace_path] [tokens]")
    batch_size = int(pos[0]) if len(pos) > 0 else 24
    k = int(pos[1]) if len(pos) > 1 else 5
    tokens = len(pos) > 3
    device = resolve_device(args.cpu)
    if device is None:
        return 1
    print(device_line(device), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(pos[2]) if len(pos) > 2 else Path(tmp) / "trace.json"
        capture(path, batch_size, k, tokens, device)
        res = analyse(path, STEPS, tag=card_tag(device))
    return 0 if res["events"] and (device.type == "cpu" or res["category"] == "kernel") else 1


if __name__ == "__main__":
    sys.exit(main())
