"""Optimizer / LR-schedule assembly; counterpart of
``crossscore_tpu/train/optim.py``.

Reference semantics (``task/core.py:486-513``): AdamW(lr=5e-4) over the
requires-grad parameters only (the backbone, and the PE unless
``req_grad``, are frozen and get no optimiser state), StepLR(step_size=100,
gamma=0.5) stepped per epoch. The schedule is applied per optimiser step by a
``LambdaLR`` that reproduces optax's count: update t (from 0) runs at
``schedule(t)``.
"""

from __future__ import annotations

from typing import Callable

import torch


def _period(step_size: int, steps_per_epoch: int, interval: str) -> int:
    if interval == "epoch":
        return max(1, step_size * max(1, steps_per_epoch))
    if interval == "step":
        return max(1, step_size)
    raise ValueError(f"Unknown lr step_interval {interval!r}")


def step_lr_schedule(base_lr: float, step_size: int, gamma: float, steps_per_epoch: int,
                     interval: str = "epoch") -> Callable[[int], float]:
    """StepLR: lr = base * gamma^(t // step_size), t in epochs or steps."""
    period = _period(step_size, steps_per_epoch, interval)
    return lambda count: base_lr * (gamma ** (count // period))


def make_optimizer(cfg, model: torch.nn.Module, steps_per_epoch: int):
    """AdamW + per-step StepLR from a composed config; returns
    ``(optimizer, scheduler, schedule)``.

    ``steps_per_epoch`` must be the number of optimiser steps actually taken
    per epoch (after any limit_train_batches/overfit truncation) so the
    epoch-interval schedule decays at the right point."""
    opt_cfg = cfg.trainer.optimizer
    if opt_cfg.type != "AdamW":
        raise NotImplementedError(f"optimizer {opt_cfg.type}")
    sched_cfg = cfg.trainer.lr_scheduler
    if sched_cfg.type != "StepLR":
        raise NotImplementedError(f"lr_scheduler {sched_cfg.type}")
    base_lr = float(opt_cfg.lr)
    period = _period(sched_cfg.step_size, steps_per_epoch, sched_cfg.step_interval)
    gamma = float(sched_cfg.gamma)
    # torch.optim.AdamW defaults (the reference passes only lr,
    # task/core.py:495-498): betas (0.9, 0.999), eps 1e-8, weight_decay 1e-2
    optimizer = torch.optim.AdamW(
        [p for p in model.parameters() if p.requires_grad], lr=base_lr, betas=(0.9, 0.999),
        eps=1e-8, weight_decay=float(opt_cfg.get("weight_decay", 1e-2)),
    )
    scheduler = torch.optim.lr_scheduler.LambdaLR(optimizer, lambda t: gamma ** (t // period))
    schedule = step_lr_schedule(base_lr, sched_cfg.step_size, gamma, steps_per_epoch,
                                sched_cfg.step_interval)
    return optimizer, scheduler, schedule
