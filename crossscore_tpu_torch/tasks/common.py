"""Shared task-entry plumbing: CLI parsing, run dirs, logging and the
accelerator rule; the port's counterpart of ``crossscore_tpu/tasks/common.py``
for one process."""

from __future__ import annotations

import json
import sys
import time
from datetime import datetime
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import yaml

from crossscore_tpu_torch.confsys import Config, load_config
from crossscore_tpu_torch.device import resolve_device


def parse_cli(config_name: str, argv: Optional[list[str]] = None) -> Config:
    """Hydra-style CLI: every argument is a ``key.sub=value`` override (or
    ``group=choice`` to swap a config group; ``--help`` prints the composed
    config)."""
    argv = sys.argv[1:] if argv is None else argv
    if any(a in ("--help", "-h", "help") for a in argv):
        cfg = load_config(config_name, overrides=[a for a in argv if "=" in a])
        print(f"usage: override any key below as key.sub=value (root config: {config_name}.yaml)\n")
        print(yaml.safe_dump(cfg.to_dict(), sort_keys=False))
        sys.exit(0)
    return load_config(config_name, overrides=argv)


def timestamp() -> str:
    return datetime.now().strftime("%Y%m%d_%H%M%S.%f")


def resolve_limit(limit, batches_per_epoch: int) -> Optional[int]:
    """Lightning limit_*_batches semantics: int = number of batches,
    float = fraction of the epoch (1.0 = everything)."""
    if isinstance(limit, bool):
        raise ValueError(f"invalid limit {limit!r}")
    if isinstance(limit, int):
        return int(limit)
    if isinstance(limit, float):
        return None if limit >= 1.0 else int(limit * batches_per_epoch)
    return None


def resolve_accelerator(cfg: Config) -> torch.device:
    """``trainer.accelerator``: ``cuda`` (the default; raises without a card)
    or ``cpu`` (the plain PyTorch versions of every kernel). Nothing else, and
    no fallback from one to the other."""
    accel = str(cfg.trainer.get("accelerator", "cuda"))
    if accel not in ("cuda", "cpu"):
        raise ValueError(f"trainer.accelerator must be cuda or cpu, got {accel!r}")
    return resolve_device(None if accel == "cuda" else "cpu")


def save_config_snapshot(cfg: Config, out_dir: Path) -> Path:
    """Persist the composed config into the run dir (hydra's
    ``.hydra/config.yaml``, reference ``config/default.yaml:6-8``)."""
    path = Path(out_dir) / "config.yaml"
    path.write_text(yaml.safe_dump(cfg.to_dict(), sort_keys=False))
    return path


def config_diff(old, new, prefix: str = "") -> list[str]:
    """Recursive leaf-level diff of two nested config dicts, as
    ``key.path: old -> new`` lines (the resume mismatch warning)."""
    lines: list[str] = []
    keys = sorted(set(old) | set(new)) if isinstance(old, dict) and isinstance(new, dict) else None
    if keys is None:
        if old != new:
            lines.append(f"{prefix}: {old!r} -> {new!r}")
        return lines
    for k in keys:
        p = f"{prefix}.{k}" if prefix else str(k)
        if k not in old:
            lines.append(f"{p}: <absent> -> {new[k]!r}")
        elif k not in new:
            lines.append(f"{p}: {old[k]!r} -> <absent>")
        else:
            lines.extend(config_diff(old[k], new[k], p))
    return lines


def weighted_mean(series: list, weights: list) -> list[float]:
    """Weighted means of one or more metric series (the reference's epoch
    reduction of ``self.log``, ``task/core.py:449``, for one process)."""
    w = np.asarray(weights, np.float64)
    denom = max(float(w.sum()), 1e-12)
    return [float(np.sum(w * np.asarray(s, np.float64))) / denom for s in series]


class JsonlLogger:
    """Scalar metric logging to ``<run_dir>/metrics.jsonl``."""

    def __init__(self, run_dir: Path):
        self.path = Path(run_dir) / "metrics.jsonl"
        self.f = open(self.path, "a")

    def log(self, metrics: dict, step: int):
        row = {"step": step, "time": time.time()}
        row.update({k: float(v) for k, v in metrics.items()})
        self.f.write(json.dumps(row) + "\n")
        self.f.flush()

    def close(self):
        self.f.close()
