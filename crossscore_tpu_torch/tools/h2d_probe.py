"""Host-to-card copy rates of the batches the loaders ship; the counterpart of
the TPU tool ``tools/h2d_probe.py``.

    python -m crossscore_tpu_torch.tools.h2d_probe [--cpu]

Times the copy to the card of (a) the float32 pixel batch (B=24, K=5, 518 px:
the query and its references, ~464 MB), (b) the same batch as uint8 (~116
MB) and (c) the token batch of ``token_fast`` training (B=24 x 1369 query
and B x K x 1369 reference tokens of D 384 in bf16, ~151 MB), 2 reps each
with fresh values, each copy anchored by ``torch.cuda.synchronize()``; from
pageable host memory, and from pinned memory (``pin_memory()``, the pinning
outside the timed window). Pinning has no TPU counterpart; it is the one
host-memory choice a CUDA copy has. Each line is the JAX tool's: ``name
repN: MB in s = MB/s``. The tool only measures: the loaders stay as they
are. ``--cpu`` copies a small batch (B=2, K=2, 56 px, 16 tokens of D 64)
within host memory and skips the pinned arm (pinning needs CUDA); without
it the tool needs a CUDA card.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from crossscore_tpu_torch.tools._common import card_tag, device_line, resolve_device

B, K, S, N_TOK, D = 24, 5, 518, 1369, 384
CPU_POINT = (2, 2, 56, 16, 64)
REPS = 2


def batch(name: str, b: int, k: int, s: int, n_tok: int, d: int, gen: torch.Generator) -> tuple:
    """The host tensors of arm ``name``: (query, references)."""
    if name == "float32":
        return torch.rand(b, s, s, 3, generator=gen), torch.rand(b, k, s, s, 3, generator=gen)
    if name == "uint8":
        return (torch.randint(0, 256, (b, s, s, 3), generator=gen, dtype=torch.uint8),
                torch.randint(0, 256, (b, k, s, s, 3), generator=gen, dtype=torch.uint8))
    return (torch.randn(b, n_tok, d, generator=gen).to(torch.bfloat16),
            torch.randn(b, k, n_tok, d, generator=gen).to(torch.bfloat16))


def copy_s(tensors: tuple, device: torch.device) -> float:
    """Seconds to copy ``tensors`` to ``device`` (a copy within host memory
    on the CPU), up to a synchronisation."""
    t0 = time.perf_counter()
    if device.type == "cuda":
        out = [t.to(device, non_blocking=t.is_pinned()) for t in tensors]
        torch.cuda.synchronize()
    else:
        out = [t.clone() for t in tensors]
    dt = time.perf_counter() - t0
    del out
    return dt


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0],
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--cpu", action="store_true", help="a small batch within host memory")
    args = ap.parse_args(argv)
    device = resolve_device(args.cpu)
    if device is None:
        return 1
    tag = card_tag(device)
    point = CPU_POINT if args.cpu else (B, K, S, N_TOK, D)
    print(device_line(device))
    print(f"batch: B={point[0]}, K={point[1]}, {point[2]} px; tokens {point[3]} of D {point[4]}, bf16; "
          f"{REPS} reps an arm", flush=True)
    gen = torch.Generator().manual_seed(0)
    if device.type == "cuda":  # the context and the allocator, outside any timed copy
        torch.zeros(1, device=device)
        torch.cuda.synchronize()
    for name in ("float32", "uint8", "tokens"):
        for rep in range(REPS):
            host = batch(name, *point, gen)
            nbytes = sum(t.numel() * t.element_size() for t in host)
            arms = [("pageable", host)]
            if device.type == "cuda":
                arms.append(("pinned", tuple(t.pin_memory() for t in host)))
            for mem, tensors in arms:
                dt = copy_s(tensors, device)
                print(f"{name} {mem} rep{rep}: {nbytes / 1e6:.1f} MB in {dt:.4f}s = {nbytes / 1e6 / dt:.1f} MB/s"
                      f"  [{tag}]", flush=True)
        if device.type == "cpu":
            print(f"{name} pinned: skipped (pinning needs CUDA)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
