"""Context-parallel cross-attention: the KV (reference-token) axis sharded over
the ranks of a process group; counterpart of
``crossscore_tpu/ops/context_parallel.py``.

Each rank runs K7 (:func:`flash_attention_head_major`) on its local KV shard,
which gives the shard's ``(o, l, m)``; the partial results are then combined
exactly with the online-softmax correction across ranks: an all-reduce MAX of
``m``, then one all-reduce SUM of ``l * alpha`` and ``o * l * alpha`` with
``alpha = exp(m - m_global)``, all in fp32, and one cast to q's dtype at the
end. Per query row this moves hd + 2 floats a rank, whatever the KV length.

On the gloo backend CUDA tensors are staged through host memory explicitly
(gloo reduces on the host); NCCL reduces on the card. Forward only: the
backward (the JAX package's ``_bwd_xla`` fed the global ``(l, m)``) is not
ported (ROADMAP queue 1 item 13), and asking for it raises.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from crossscore_tpu_torch.ops.flash_attention import flash_attention_head_major
from crossscore_tpu_torch.parallel.mesh import view_group


def _all_reduce(t: torch.Tensor, op, group) -> torch.Tensor:
    """In-place all-reduce of ``t`` over ``group``; CUDA tensors go through a
    host copy on gloo."""
    if t.is_cuda and dist.get_backend(group) == dist.Backend.GLOO:
        host = t.cpu()
        dist.all_reduce(host, op=op, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, op=op, group=group)
    return t


def _combine(q: torch.Tensor, k_shard: torch.Tensor, v_shard: torch.Tensor, group):
    """-> (o in q's dtype, l_global with 0 taken as 1, m_global), o (B, H, Nq,
    hd) and the statistics (B, H, Nq) fp32, equal on every rank."""
    o_local, l_local, m_local = flash_attention_head_major(q, k_shard, v_shard)
    m_global = _all_reduce(m_local.clone(), dist.ReduceOp.MAX, group)
    alpha = torch.exp(m_local - m_global)
    # o_local rows are normalised by the local l: undo it for the raw sums,
    # and carry l * alpha as one more column so that a single SUM moves both
    acc = torch.cat([o_local.float() * (l_local * alpha)[..., None], (l_local * alpha)[..., None]], -1)
    acc = _all_reduce(acc, dist.ReduceOp.SUM, group)
    l_global = acc[..., -1]
    l_safe = torch.where(l_global == 0, torch.ones_like(l_global), l_global)
    return (acc[..., :-1] / l_safe[..., None]).to(q.dtype), l_safe, m_global


class _ContextParallelAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k_shard, v_shard, group):
        # the kernel refuses inputs that require grad; the backward raises
        return _combine(q.detach(), k_shard.detach(), v_shard.detach(), group)[0]

    @staticmethod
    def backward(ctx, do):
        raise NotImplementedError(
            "the context-parallel backward is not ported (ROADMAP queue 1 item 13): "
            "view-parallel predict is forward only"
        )


def context_parallel_cross_attention(q: torch.Tensor, k_shard: torch.Tensor, v_shard: torch.Tensor,
                                     group=None) -> torch.Tensor:
    """softmax(q k^T / sqrt(hd)) v with the KV axis sharded over ``group``
    (default: the registered view group, :func:`view_group`).

    q (B, H, Nq, hd) is the same on every rank; k_shard and v_shard (B, H,
    Nk_local, hd) are this rank's shard (shards may differ in length). Each
    may be a strided head-major view. Returns o (B, H, Nq, hd) in q's dtype,
    the same on every rank: exact, equal to single-device attention up to the
    order of float additions."""
    return _ContextParallelAttention.apply(q, k_shard, v_shard, view_group() if group is None else group)
