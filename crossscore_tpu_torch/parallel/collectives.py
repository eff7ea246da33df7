"""The collectives of the context-, tensor- and data-parallel paths, in one
place: an in-place all-reduce and an all-gather over a process group.

gloo reduces on the host, so on gloo a CUDA tensor is staged through a host
copy explicitly (the backend is never switched); NCCL, and gloo with CPU
tensors, reduce the tensor itself. ``group`` None is the default group.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _host_staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == dist.Backend.GLOO


def all_reduce(t: torch.Tensor, op=dist.ReduceOp.SUM, group=None) -> torch.Tensor:
    """In-place all-reduce of ``t`` over ``group``; returns ``t``."""
    if _host_staged(t, group):
        host = t.cpu()
        dist.all_reduce(host, op=op, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, op=op, group=group)
    return t


def all_gather(t: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes), concatenated along ``dim`` in the
    order of the ranks of ``group``, on ``t``'s device."""
    src = t.contiguous()
    staged = _host_staged(src, group)
    if staged:
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim)
    return out.to(t.device) if staged else out
