"""Training checkpoints with ``torch.save``; the counterpart of
``crossscore_tpu/io/checkpoint.py`` (which uses orbax).

One file per saved step, ``<dir>/step_<NNNNNNNN>.ckpt``, holding a reference
Lightning-style dict: ``state_dict`` (the model's parameters and buffers
under ``model.``-prefixed keys, so ``crossscore_tpu/io/torch_convert.py``
reads it), ``optimizer_states``, ``lr_schedulers`` and ``loop`` (the exact
cursor: step, epoch, batch in epoch). ``hparams.yaml`` beside the steps holds
the composed config of the run. The cadences are the reference's
(``task/train.py:117-129``): every N train steps, every N epochs, a
wall-clock interval, and a last save at the end; every save is kept.
"""

from __future__ import annotations

import os
import re
import time
from pathlib import Path
from typing import Optional

import torch
import yaml

_STEP_FILE = re.compile(r"^step_(\d+)\.ckpt$")


def load_hparams(ckpt_dir: str | Path) -> Optional[dict]:
    """The ``hparams.yaml`` stored beside a checkpoint directory's steps, or
    None when there is none."""
    path = Path(ckpt_dir) / "hparams.yaml"
    if not path.exists():
        return None
    return yaml.safe_load(path.read_text())


def step_path(directory: str | Path, step: int) -> Path:
    return Path(directory) / f"step_{step:08d}.ckpt"


def latest_step(directory: str | Path) -> Optional[int]:
    steps = [int(m.group(1)) for p in Path(directory).iterdir() if (m := _STEP_FILE.match(p.name))]
    return max(steps) if steps else None


class CheckpointManager:
    """Writes and restores the train checkpoints of one run directory."""

    def __init__(
        self,
        directory: str | Path,
        train_time_interval_hours: Optional[float] = 2.0,
        every_n_train_steps: Optional[int] = None,
        every_n_epochs: Optional[int] = None,
        hparams: Optional[dict] = None,
    ):
        self.directory = Path(directory)
        if hparams is not None:  # the writer's manager; the others touch no file until they save
            self.directory.mkdir(parents=True, exist_ok=True)
            (self.directory / "hparams.yaml").write_text(yaml.safe_dump(hparams, sort_keys=False))
        self.interval_s = train_time_interval_hours * 3600 if train_time_interval_hours else None
        self.every_n_train_steps = every_n_train_steps
        self.every_n_epochs = every_n_epochs
        self._last_save_t = time.monotonic()

    def should_save(self, step: int, epoch_end: bool = False, epoch: int = 0, wall_clock: bool = True) -> bool:
        """``wall_clock=False`` keeps to the step and epoch cadences, which are
        functions of (config, step) and so the same on every rank; the
        wall-clock interval is a per-host clock, on which the ranks agree
        separately (:meth:`wall_clock_due` and a broadcast)."""
        if self.every_n_train_steps and step > 0 and step % self.every_n_train_steps == 0:
            return True
        if epoch_end and self.every_n_epochs and (epoch + 1) % self.every_n_epochs == 0:
            return True
        return wall_clock and self.wall_clock_due()

    def wall_clock_due(self) -> bool:
        return self.interval_s is not None and time.monotonic() - self._last_save_t >= self.interval_s

    def save(self, step: int, model: torch.nn.Module, optimizer, scheduler, loop: dict) -> Path:
        """Write step ``step``; a step already on disk is written again. The
        file appears whole or not at all (written aside, then renamed)."""
        path = step_path(self.directory, step)
        self.directory.mkdir(parents=True, exist_ok=True)
        blob = {
            "state_dict": {f"model.{k}": v.detach().cpu() for k, v in model.state_dict().items()},
            "optimizer_states": [optimizer.state_dict()],
            "lr_schedulers": [scheduler.state_dict()],
            "loop": {k: int(v) for k, v in loop.items()},
            "global_step": int(loop["step"]),
            "epoch": int(loop["epoch"]),
        }
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        torch.save(blob, tmp)
        os.replace(tmp, path)
        self._last_save_t = time.monotonic()
        return path

    def restore(self, model: torch.nn.Module, optimizer, scheduler, step: Optional[int] = None) -> dict:
        """Load step ``step`` (the latest when None) into the model, the
        optimiser and the scheduler; returns the loop cursor."""
        step = latest_step(self.directory) if step is None else step
        if step is None:
            raise FileNotFoundError(f"No checkpoint found in {self.directory}")
        blob = torch.load(step_path(self.directory, step), map_location="cpu", weights_only=True)
        state = {k[len("model."):]: v for k, v in blob["state_dict"].items()}
        model.load_state_dict(state, strict=True)
        optimizer.load_state_dict(blob["optimizer_states"][0])
        scheduler.load_state_dict(blob["lr_schedulers"][0])
        return dict(blob["loop"])
