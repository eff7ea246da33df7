"""Megatron-style tensor parallelism over the model group: the port's
counterpart of ``_tp_spec_for`` / ``param_shardings`` in
``crossscore_tpu/parallel/mesh.py`` and of ``tp_flash_cross_attention`` in
``crossscore_tpu/ops/flash_attention.py``.

The JAX package keeps global parameters with sharding annotations and lets
GSPMD insert the collectives; the port holds each rank's shard and calls the
collectives itself. A column-parallel layer (the q/k/v projections, ``fc1``,
``linear1``, the head's first linear) keeps the rows of its torch weight
(out, in) for this rank's output features, and its bias with them; a
row-parallel layer (the out projections, ``fc2``, ``linear2``, the head's
second linear) keeps the columns for this rank's input features, and its
bias whole, added once after the all-reduce. Attention projections split by
whole heads, so each rank attends over its own heads with no communication.

Two autograd collectives carry the Megatron pattern
``x -> copy_to_group -> column -> ... -> row -> reduce_from_group -> + bias``:
:func:`copy_to_group` (identity forward, all-reduce SUM backward) and
:func:`reduce_from_group` (all-reduce SUM forward, identity backward). With
them the gradients of replicated parameters come out whole and equal on
every rank of the model group, so the model group needs no gradient
reduction after the backward.

Under ``backbone_quant=int8`` the backbone's products go through the W8A8
linear (``ops/quant.py``), whose scales the JAX package takes over whole
rows and columns (GSPMD): :func:`int8_column_linear` is the one-rank linear on
this rank's weight rows, since each of them and each token of the replicated
input are whole; :func:`int8_row_linear` holds a shard of every row, so it
max-reduces the absmaxes before it quantises and sums the exact int32
products before it dequantises, and gives the one-rank linear's bits. The
backbone is frozen and runs under ``no_grad``, so neither has a backward;
both raise when autograd would record them.

One deviation from the JAX layout: the JAX package column-shards the
backbone's fused (D, 3D) qkv kernel in contiguous blocks, which are not
head-aligned, and GSPMD reshards it before the kernel; the port holds the
query, key and value projections as three layers and shards each by heads.
The function is the same.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from crossscore_tpu_torch.ops.quant import (
    dequantize_s32, int8_linear, int8_matmul_s32, quantize_rowwise_given, row_absmax,
)
from crossscore_tpu_torch.parallel.collectives import all_gather, all_reduce

COLUMN, ROW = "column", "row"

# the port's (reference Lightning) layer names, without the "model." prefix
_COLUMN_LAYERS = (".attention.attention.query", ".attention.attention.key", ".attention.attention.value",
                  ".mlp.fc1", ".linear1", "ref_cross.head.0")
_ROW_LAYERS = (".attention.output.dense", ".out_proj", ".mlp.fc2", ".linear2", "ref_cross.head.2")
_IN_PROJ = ("in_proj_weight", "in_proj_bias")  # the decoder's packed q/k/v rows


def tp_spec_for(key: str, mlp_impl: str = "unfused") -> Optional[str]:
    """:data:`COLUMN`, :data:`ROW` or None (replicated) for one parameter of
    the port's ``CrossScoreNet`` by its reference Lightning key (with or
    without the ``model.`` prefix). Weights follow the JAX ``_tp_spec_for``;
    a column-parallel bias is split with its layer's outputs (the JAX package
    keeps it whole and GSPMD slices it), a row-parallel bias stays whole.
    With ``mlp_impl`` ``fused``/``fused_exact`` the backbone's fc1 and fc2 stay
    whole: K2 runs on the whole weights on every rank, as the JAX package's
    ``pallas_call`` does once GSPMD has gathered its sharded operands."""
    key = key[len("model."):] if key.startswith("model.") else key
    layer, _, leaf = key.rpartition(".")
    if leaf in _IN_PROJ:
        return COLUMN
    if leaf not in ("weight", "bias"):
        return None
    if mlp_impl != "unfused" and layer.endswith((".mlp.fc1", ".mlp.fc2")):
        return None
    if layer.endswith(_COLUMN_LAYERS):
        return COLUMN
    if layer.endswith(_ROW_LAYERS):
        return ROW if leaf == "weight" else None
    return None


def _shard(key: str, t: torch.Tensor, spec: str, rank: int, mp: int) -> torch.Tensor:
    if key.endswith(_IN_PROJ):  # each third (q, k, v) split by heads
        return t.reshape(3, mp, t.shape[0] // (3 * mp), *t.shape[1:])[:, rank].reshape(-1, *t.shape[1:])
    return t.chunk(mp, dim=0 if spec == COLUMN else 1)[rank]


def shard_state_dict(full_sd: Mapping, rank: int, mp: int, mlp_impl: str = "unfused") -> dict:
    """A full Lightning-keyed state dict (tensors or numpy arrays, ``model.``
    prefixed or not) -> model rank ``rank``'s shard of it, as tensors, for a
    ``CrossScoreNet`` built with ``attention_impl="tp"`` over ``mp`` ranks."""
    out = {}
    for key, val in full_sd.items():
        t = val if isinstance(val, torch.Tensor) else torch.from_numpy(np.array(val, np.float32))
        spec = tp_spec_for(key, mlp_impl)
        if spec is not None:
            dim = 1 if spec == ROW else 0
            if t.shape[dim] % (3 * mp if key.endswith(_IN_PROJ) else mp):
                raise ValueError(f"{key} {tuple(t.shape)} does not split over {mp} ranks")
            t = _shard(key, t, spec, rank, mp).contiguous()
        out[key] = t
    return out


def gather_state_dict(local_sd: Mapping, group=None, mlp_impl: str = "unfused") -> dict:
    """The inverse of :func:`shard_state_dict` over the model group
    ``group``: every rank's shards gathered into the full state dict, on
    every rank."""
    mp = dist.get_world_size(group)
    out = {}
    for key, t in local_sd.items():
        spec = tp_spec_for(key, mlp_impl)
        if spec is not None:
            if key.endswith(_IN_PROJ):  # (3 * rows, ...) per rank -> (3, mp * rows, ...)
                parts = all_gather(t.reshape(1, 3, -1, *t.shape[1:]), group)
                t = parts.transpose(0, 1).reshape(-1, *t.shape[1:])
            else:
                t = all_gather(t, group, dim=0 if spec == COLUMN else 1)
        out[key] = t
    return out


def check_divisible(what: str, n: int, mp: int) -> int:
    """``n // mp``; raises unless ``mp`` divides ``n`` (heads, widths)."""
    if n % mp:
        raise ValueError(f"{n} {what} not divisible by the model group's {mp} ranks")
    return n // mp


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), dist.ReduceOp.SUM, ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous().clone(), dist.ReduceOp.SUM, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; the backward sums the gradient over ``group``
    (Megatron's f: the input of a column-parallel layer, or any tensor whose
    gradient each rank holds only a share of)."""
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce SUM forward over ``group``, identity backward (Megatron's
    g: the partial outputs of a row-parallel layer)."""
    return _ReduceFromGroup.apply(x, group)


def column_linear(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, group) -> torch.Tensor:
    """A column-parallel layer on replicated ``x``, in x's dtype: this rank's
    output features."""
    return F.linear(copy_to_group(x, group), weight.to(x.dtype), bias.to(x.dtype))


def row_linear(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, group) -> torch.Tensor:
    """A row-parallel layer on this rank's input features, in x's dtype: the
    partial products summed over ``group``, then the whole bias, once."""
    return reduce_from_group(F.linear(x, weight.to(x.dtype)), group) + bias.to(x.dtype)


def _no_autograd(what: str, *tensors) -> None:
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{what} has no backward (the int8 backbone is frozen): run it under torch.no_grad(), "
                           "on tensors that do not require grad")


def int8_column_linear(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """A column-parallel W8A8 layer on replicated ``x`` (..., K): this rank's
    output features, in x's dtype. Q1 on x and on this rank's fp32 weight
    rows (N/mp, K), Q2 with their bias slice: every scale is whole, so no
    collective."""
    _no_autograd("int8_column_linear", x, weight, bias)
    return int8_linear(x, weight, bias)


def int8_row_linear(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, group) -> torch.Tensor:
    """A row-parallel W8A8 layer on this rank's input features ``x`` (...,
    K/mp) and fp32 weight columns (N, K/mp), in x's dtype, the same bits as
    the one-rank :func:`~crossscore_tpu_torch.ops.quant.int8_linear` on the
    gathered operands: Q1a on both, one all-reduce MAX of the absmaxes over
    ``group``, Q1b on both, Q2's int32 form, an all-reduce SUM of the int32
    products, then Q2's dequantisation and the whole bias, once."""
    _no_autograd("int8_row_linear", x, weight, bias)
    mx, mw = row_absmax(x), row_absmax(weight)
    m = all_reduce(torch.cat([mx.reshape(-1), mw.reshape(-1)]), dist.ReduceOp.MAX, group)
    xq, sx = quantize_rowwise_given(x, m[:mx.numel()].reshape(mx.shape))
    wq, sw = quantize_rowwise_given(weight, m[mx.numel():].reshape(mw.shape))
    acc = all_reduce(int8_matmul_s32(xq, wq), dist.ReduceOp.SUM, group)
    return dequantize_s32(acc, sx, sw, bias, x.dtype)
