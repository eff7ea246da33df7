"""Context-parallel cross-attention: the KV (reference-token) axis sharded over
the ranks of a process group; counterpart of
``crossscore_tpu/ops/context_parallel.py``.

Each rank runs K7 (:func:`flash_attention_head_major`) on its local KV shard,
which gives the shard's ``(o, l, m)``; the partial results are then combined
exactly with the online-softmax correction across ranks: an all-reduce MAX of
``m``, then one all-reduce SUM of ``l * alpha`` and ``o * l * alpha`` with
``alpha = exp(m - m_global)``, all in fp32, and one cast to q's dtype at the
end. Per query row this moves hd + 2 floats a rank, whatever the KV length.

The backward, the JAX package's ``_bwd_xla`` fed the global ``(l, m)``, is
K8/K9 (:func:`flash_attention_head_major_bwd`) on the local shard with the
global ``o``, ``l`` and ``m``: dk and dv stay local, and dq, this shard's
partial sum, takes one all-reduce SUM over the view group. The collectives
are ``parallel/collectives.py``'s (gloo stages CUDA tensors through host
memory; NCCL reduces on the card).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from crossscore_tpu_torch.ops.flash_attention import (
    _kernel_rows, flash_attention_head_major, flash_attention_head_major_bwd,
)
from crossscore_tpu_torch.parallel.collectives import all_reduce
from crossscore_tpu_torch.parallel.mesh import view_group


def _combine(q: torch.Tensor, k_shard: torch.Tensor, v_shard: torch.Tensor, group):
    """-> (o in q's dtype, l_global with 0 taken as 1, m_global), o (B, H, Nq,
    hd) and the statistics (B, H, Nq) fp32, equal on every rank."""
    o_local, l_local, m_local = flash_attention_head_major(q, k_shard, v_shard)
    m_global = all_reduce(m_local.clone(), dist.ReduceOp.MAX, group)
    alpha = torch.exp(m_local - m_global)
    # o_local rows are normalised by the local l: undo it for the raw sums,
    # and carry l * alpha as one more column so that a single SUM moves both
    acc = torch.cat([o_local.float() * (l_local * alpha)[..., None], (l_local * alpha)[..., None]], -1)
    acc = all_reduce(acc, dist.ReduceOp.SUM, group)
    l_global = acc[..., -1]
    l_safe = torch.where(l_global == 0, torch.ones_like(l_global), l_global)
    return (acc[..., :-1] / l_safe[..., None]).to(q.dtype), l_safe, m_global


class _ContextParallelAttention(torch.autograd.Function):
    """The JAX ``custom_vjp`` ``context_parallel_cross_attention``: the
    combine forward; backward K8/K9 on the local shard fed the global
    ``(o, l, m)``, so that p = exp(s - m_g) / l_g are the true attention
    weights restricted to this shard."""

    @staticmethod
    def forward(ctx, q, k_shard, v_shard, group):
        # K7 refuses inputs that require grad: it is handed the detached ones
        q, k_shard, v_shard = q.detach(), k_shard.detach(), v_shard.detach()
        o, l_global, m_global = _combine(q, k_shard, v_shard, group)
        ctx.save_for_backward(q, k_shard, v_shard, o, l_global, m_global)
        ctx.group = group
        return o

    @staticmethod
    def backward(ctx, do):
        q, k_shard, v_shard, o, l_global, m_global = ctx.saved_tensors
        # The JAX VJP first takes psum(do): under shard_map the output
        # cotangent arrives split across the shards. Here every rank runs the
        # replicated downstream on the same o, so its do is already whole.
        dq, dk, dv = flash_attention_head_major_bwd(q, k_shard, v_shard, o, _kernel_rows(do), l_global,
                                                    m_global)
        # dk and dv are exactly this shard's rows of the full gradients; dq is
        # this shard's partial sum, summed over the view group here (shard_map's
        # transpose inserts that psum in the JAX package), in q's dtype as there
        dq_rows = dq.transpose(1, 2)  # the token-major buffer the kernel wrote
        if not dq_rows.is_contiguous():
            dq_rows = dq_rows.contiguous()
        all_reduce(dq_rows, dist.ReduceOp.SUM, ctx.group)
        return dq_rows.transpose(1, 2), dk, dv, None


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
