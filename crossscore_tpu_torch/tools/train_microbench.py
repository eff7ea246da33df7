"""The pixel train step's time at the reference's production operating point;
the counterpart of the TPU tool ``tools/train_microbench.py``.

    python -m crossscore_tpu_torch.tools.train_microbench [batch] [k] [--cpu]

Times ``make_train_step`` (the forward with the frozen backbone, the L1
loss, the backward and AdamW over the decoder and head, one update of the
parameters in place) at B x K references (default 24 and 5), 518 px, bf16
compute and fp32 master weights, from the port's seeded init: two warm-up
steps, then three runs of three steps each, every step on a batch of its
own and the state chained from step to step, each run timed by CUDA events
around its three steps. The line is the JAX tool's: ``train step B= K=
518px: ms/step (runs ...)``, the median run over its steps.

The JAX tool's ``SCOPED_VMEM_KIB`` sets a Mosaic VMEM budget of the TPU
compile, which has no counterpart on CUDA (ROADMAP "Not ported"); this tool
does not read it. Its in-graph loop, input perturbations and sanity floor
guard against its relay's memoisation, which CUDA has not. ``--cpu`` runs
the plain versions on the CPU at a small shape (dinov2-test at 56 px);
without it the tool needs a CUDA card.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from crossscore_tpu_torch.tools._common import card_tag, device_line, resolve_device, times_ms

HW = 518
CPU_PRESET, CPU_HW = "dinov2-test", 56
N_IT, RUNS, WARMUP, SEED = 3, 3, 2, 0


def train_setup(device: torch.device, batch_size: int, k: int, n_batches: int, tokens: bool = False):
    """The train step at the production point (on the CPU: dinov2-test at
    56 px) from the port's seeded init, and ``n_batches`` batches of its own
    (pixels, or with ``tokens`` the token-space step's tokens) -> (step,
    batches, hw)."""
    from crossscore_tpu_torch.tools.stress_vitl import build, make_batch
    from crossscore_tpu_torch.train.optim import make_optimizer
    from crossscore_tpu_torch.train.step import make_train_step

    cpu = device.type == "cpu"
    hw = CPU_HW if cpu else HW
    cfg, mcfg, model = build(CPU_PRESET if cpu else "dinov2-small", [], device, SEED)
    optimizer, scheduler, _ = make_optimizer(cfg, model, steps_per_epoch=100)
    gen = torch.Generator(device=device).manual_seed(SEED)
    batches = [make_batch(gen, device, batch_size, k, hw, mcfg.backbone.hidden_size, mcfg.patch_size,
                          with_map=True, token=tokens) for _ in range(n_batches)]
    return make_train_step(model, optimizer, scheduler), batches, hw


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0],
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("args", nargs="*", type=int, help="[batch] [k]")
    ap.add_argument("--cpu", action="store_true", help="the plain versions on the CPU at a small shape")
    args = ap.parse_args(argv)
    if len(args.args) > 2:
        ap.error("expected [batch] [k]")
    batch_size = args.args[0] if len(args.args) > 0 else 24
    k = args.args[1] if len(args.args) > 1 else 5
    device = resolve_device(args.cpu)
    if device is None:
        return 1
    print(device_line(device), flush=True)

    from crossscore_tpu_torch.train.step import TrainState

    step, batches, hw = train_setup(device, batch_size, k, WARMUP + RUNS * N_IT)
    feed = iter(batches)
    state = TrainState()
    t = time.perf_counter()
    for _ in range(WARMUP):
        state, metrics = step(state, next(feed))
    float(metrics["loss"])  # the host's fetch waits for the device
    print(f"warm-up ({WARMUP} steps): {time.perf_counter() - t:.1f} s", flush=True)

    def run():  # N_IT steps, each on a batch of its own, the state chained
        nonlocal state, metrics
        for _ in range(N_IT):
            state, metrics = step(state, next(feed))

    runs = times_ms(run, device, RUNS, warmup=0)
    if not bool(torch.isfinite(metrics["loss"])):
        print("train_microbench: the loss is not finite", file=sys.stderr)
        return 1
    ms = sorted(runs)[len(runs) // 2] / N_IT
    print(f"train step B={batch_size} K={k} {hw}px: {ms:.2f} ms/step "
          f"(runs {'/'.join(f'{x:.1f}' for x in runs)}ms over {N_IT} steps)  [{card_tag(device)}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
