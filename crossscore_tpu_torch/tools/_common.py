"""What the tools share: the device they time on, the card's line, a
median of timed runs, an in-stream mean, and the CLIs in child processes."""

from __future__ import annotations

import os
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[2]


def cli_command(task: str) -> list[str]:
    """The command that runs ``crossscore_tpu_torch.tasks.<task>``."""
    return [sys.executable, "-m", f"crossscore_tpu_torch.tasks.{task}"]


def run_cli(task: str, argv: list[str], cwd: Path, timeout: float | None = None, tail: int = 2000) -> str:
    """``tasks.<task>`` with ``argv`` in a child process in ``cwd`` (the repo
    first on its PYTHONPATH), the last ``tail`` characters of its stdout
    echoed -> its stdout. A nonzero exit raises with the end of its stderr;
    past ``timeout`` seconds the child is killed and
    ``subprocess.TimeoutExpired`` raised, so that a hung run ends."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [str(REPO), env.get("PYTHONPATH")]))
    proc = subprocess.run(cli_command(task) + list(argv), env=env, cwd=cwd, capture_output=True, text=True,
                          timeout=timeout)
    sys.stdout.write(proc.stdout[-tail:])
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr[-4000:])
        raise RuntimeError(f"tasks.{task} failed (rc={proc.returncode})")
    return proc.stdout


def done_dir(stdout: str, what: str, cwd: Path) -> Path:
    """The output dir a CLI names on its ``<what> done: N ... -> dir`` line,
    absolute (relative to the child's ``cwd``)."""
    return cwd / re.search(rf"{what} done: \d+ \w+ -> (.+)", stdout).group(1).strip()


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


# the H100 SXM's dense bf16 tensor-core peak and memory rate (NVIDIA's data
# sheet), the denominators of the tools' MFU and floors
H100_BF16_PEAK = 989e12
H100_BYTES_PER_S = 3.35e12


def median_ms(fn, device: torch.device, reps: int, warmup: int = 2) -> float:
    """The median, in ms, of ``reps`` runs of ``fn`` after ``warmup`` runs:
    CUDA events on the card, the host clock on the CPU."""
    times = times_ms(fn, device, reps, warmup)
    return sorted(times)[len(times) // 2]


def stream_ms(fn, device: torch.device, calls: int, turns: int = 3, warmup: int = 2) -> float:
    """The in-stream time of one call of ``fn`` in ms: the median of
    ``turns`` means over ``calls`` back-to-back calls (no wait between
    them), after ``warmup`` calls; CUDA events around each run of calls on
    the card, the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    means = []
    for _ in range(turns):
        if device.type == "cuda":
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(calls):
                fn()
            b.record()
            b.synchronize()
            means.append(a.elapsed_time(b) / calls)
        else:
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            means.append(1e3 * (time.perf_counter() - t0) / calls)
    return sorted(means)[turns // 2]


def times_ms(fn, device: torch.device, reps: int, warmup: int = 2) -> list[float]:
    """``reps`` timings of ``fn`` in ms after ``warmup`` runs: CUDA events on
    the card, the host clock on the CPU."""
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
    return times


def card_tag(device: torch.device) -> str:
    """What each measurement line of a tool ends with: the card's name and
    power limit (:func:`card_line`), or the CPU's label."""
    return card_line() if device.type == "cuda" else "cpu: plain versions, host times"
