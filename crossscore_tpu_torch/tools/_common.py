"""What the tools share: the device they time on, the card's line, and a
median of timed runs."""

from __future__ import annotations

import subprocess
import sys
import time

import torch


def resolve_device(cpu: bool) -> torch.device | None:
    """The CUDA card, or the CPU when asked (the plain versions); None, with
    a message, when there is no card and the CPU was not asked for."""
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        print("no CUDA device: pass --cpu to run the plain versions on the CPU", file=sys.stderr)
        return None
    return torch.device("cuda")


def card_line(*extra: str) -> str:
    """The card's name and power limit, then any ``extra`` query fields, as
    ``nvidia-smi`` gives them."""
    query = ",".join(("name", "power.limit") + extra)
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()
    return out[0]


def device_line(device: torch.device) -> str:
    """The card's line, or the CPU's label."""
    if device.type == "cpu":
        return "device: cpu (the plain PyTorch versions; host times, not device times)"
    return f"device: {torch.cuda.get_device_name(device)} ({card_line()})"


def median_ms(fn, device: torch.device, reps: int, warmup: int = 2) -> float:
    """The median, in ms, of ``reps`` runs of ``fn`` after ``warmup`` runs:
    CUDA events on the card, the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            times.append(1e3 * (time.perf_counter() - t0))
    return sorted(times)[len(times) // 2]
