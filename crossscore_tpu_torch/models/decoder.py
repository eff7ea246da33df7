"""Cross-reference transformer decoder; counterpart of
``crossscore_tpu/models/decoder.py`` (reference
``model/customised_transformer/transformer.py``).

Post-norm layers (``x = norm1(x + sa(x))``, ``x = norm2(x + mha(x, mem))``,
``x = norm3(x + ff(x))``, eps 1e-5), a ReLU feed-forward, and optionally the
last layer's cross-attention weights for one head. Parameter names are
torch's ``TransformerDecoder`` ones (packed ``in_proj_weight``).

With ``attention_impl="flash"`` both attentions run through K3 forward and
K4 backward (:func:`flash_cross_attention_ln`) at the true head dim (48 for
the main path), or through K6 (:func:`flash_cross_attention_masked`, forward
only) when a token bias masks bucket-padded tokens; ``need_weights`` and
``"dense"`` take the dense fp32-softmax path, differentiable through plain
autograd. With ``"cp"`` (view parallelism) the cross-attention runs the
context-parallel op (:func:`context_parallel_cross_attention`, K7 per rank
and an exact softmax combine over the view group; backward K8/K9 fed the
global statistics) on head-major views of the projections, and the query
self-attention stays local on K3 (the JAX package runs it dense; the two
compute the same function). The k/v rows of the cross-attention's packed
projection see only this rank's reference views, so their gradients are
partial: a copy to the view group sums them over it in the backward, and
every trainable gradient comes out whole on every rank.

With ``"tp"`` (tensor parallelism) each layer holds the model group's share
of the heads: the q, k and v rows of ``in_proj_weight`` and ``in_proj_bias``
for this rank's heads, the matching columns of ``out_proj`` (row-parallel,
its bias whole) and of ``linear1`` / ``linear2`` (column- / row-parallel);
the LayerNorms are replicated. Both attentions run
:func:`head_major_flash_attention` on head-major views of the local
projections: K7 forward, K8 (self-attention) or K9 (cross-attention over
more than 2048 tokens) backward.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from crossscore_tpu_torch.models.dinov2 import ATTENTION_IMPLS, LayerNorm, linear, tp_ranks
from crossscore_tpu_torch.ops.attention import dense_attention
from crossscore_tpu_torch.ops.context_parallel import context_parallel_cross_attention
from crossscore_tpu_torch.ops.flash_attention import (
    _merge_heads, _split_heads, flash_cross_attention_ln, flash_cross_attention_masked,
    head_major_flash_attention,
)
from crossscore_tpu_torch.parallel.mesh import model_group, view_group
from crossscore_tpu_torch.parallel.tensor_parallel import (
    check_divisible, column_linear, copy_to_group, row_linear,
)


class TorchStyleMHA(nn.Module):
    """``torch.nn.MultiheadAttention`` equivalent (batch_first, equal q/k/v dims)."""

    def __init__(self, d_model: int, num_heads: int, attention_impl: str = "flash", device=None):
        super().__init__()
        if attention_impl not in ATTENTION_IMPLS:
            raise ValueError(f"attention_impl must be one of {ATTENTION_IMPLS}, got {attention_impl!r}")
        mp = tp_ranks(attention_impl)
        self.d_model = d_model
        self.num_heads = check_divisible("heads", num_heads, mp)  # this rank's heads under "tp"
        self.attention_impl = attention_impl
        d_local = d_model // mp
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_local, d_model, device=device))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_local, device=device))
        self.out_proj = nn.Linear(d_local, d_model, device=device)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, query, key, value, need_weights: bool = False, kv_bias=None):
        """``kv_bias``: None, or an fp32 (Nk,) / (B, Nk) additive bias over
        the key tokens (shape-bucketed inference)."""
        if self.attention_impl == "tp":
            return self._forward_tp(query, key, value, need_weights, kv_bias)
        d, h, dt = self.d_model, self.num_heads, query.dtype
        w, b = self.in_proj_weight, self.in_proj_bias
        if self.attention_impl == "cp" and torch.is_grad_enabled():
            # the k/v rows meet only this rank's reference views: their
            # gradients are partial, summed over the view group in the backward
            w = torch.cat([w[:d], copy_to_group(w[d:], view_group())])
            b = torch.cat([b[:d], copy_to_group(b[d:], view_group())])
        w, b = w.to(dt), b.to(dt)
        q = F.linear(query, w[:d], b[:d])
        k = F.linear(key, w[d:2 * d], b[d:2 * d])
        v = F.linear(value, w[2 * d:], b[2 * d:])
        probs = None
        if need_weights or self.attention_impl == "dense":
            out, probs = dense_attention(_split_heads(q, h), _split_heads(k, h),
                                         _split_heads(v, h), kv_bias=kv_bias, return_probs=True)
            out = _merge_heads(out)
            probs = probs if need_weights else None
        elif self.attention_impl == "cp":
            if kv_bias is not None:
                raise NotImplementedError("token masks (shape buckets) do not compose with view "
                                          "parallelism, as in the JAX package")
            # k and v hold this rank's reference views; head-major views, no copy
            out = _merge_heads(context_parallel_cross_attention(*(_split_heads(t, h) for t in (q, k, v))))
        elif kv_bias is not None:
            out, _, _ = flash_cross_attention_masked(q, k, v, kv_bias, h)
        else:
            out = flash_cross_attention_ln(q, k, v, h)
        return linear(out, self.out_proj), probs  # probs: (B, H, Nq, Nk) or None

    def _forward_tp(self, query, key, value, need_weights: bool, kv_bias):
        """This rank's heads: the column-parallel q/k/v projections, K7
        forward and K8/K9 backward on their head-major views, and the
        row-parallel out projection summed over the model group (the JAX
        ``tp_flash_cross_attention`` inside the decoder's ``tp:`` route)."""
        if need_weights or kv_bias is not None:
            raise NotImplementedError("attention weights and token masks under the tp attention route")
        group, h = model_group(), self.num_heads
        w, b = self.in_proj_weight, self.in_proj_bias
        dl = w.shape[0] // 3
        if query is key:  # self-attention: one projection of the replicated input
            q, k, v = column_linear(query, w, b, group).split(dl, dim=-1)
        else:
            q = column_linear(query, w[:dl], b[:dl], group)
            k, v = column_linear(key, w[dl:], b[dl:], group).split(dl, dim=-1)
        out = head_major_flash_attention(*(_split_heads(t, h) for t in (q, k, v)))
        return row_linear(_merge_heads(out), self.out_proj.weight, self.out_proj.bias, group), None


class DecoderLayer(nn.Module):
    def __init__(self, d_model: int, num_heads: int, dim_feedforward: int,
                 do_self_attn: bool = True, do_short_cut: bool = True,
                 attention_impl: str = "flash", layer_norm_eps: float = 1e-5, device=None):
        super().__init__()
        self.do_self_attn = do_self_attn
        self.do_short_cut = do_short_cut
        if do_self_attn:
            # the query self-attention is local under "cp"
            local_impl = "flash" if attention_impl == "cp" else attention_impl
            self.self_attn = TorchStyleMHA(d_model, num_heads, local_impl, device)
            self.norm1 = LayerNorm(d_model, layer_norm_eps, device)
        self.multihead_attn = TorchStyleMHA(d_model, num_heads, attention_impl, device)
        self.norm2 = LayerNorm(d_model, layer_norm_eps, device)
        self.tp = attention_impl == "tp"  # linear1 column-, linear2 row-parallel
        f = check_divisible("feed-forward features", dim_feedforward, tp_ranks(attention_impl))
        self.linear1 = nn.Linear(d_model, f, device=device)
        self.linear2 = nn.Linear(f, d_model, device=device)
        self.norm3 = LayerNorm(d_model, layer_norm_eps, device)

    def forward(self, x, memory, need_weights: bool = False, self_bias=None, cross_bias=None):
        if self.do_self_attn:
            sa, _ = self.self_attn(x, x, x, kv_bias=self_bias)
            x = self.norm1(x + sa if self.do_short_cut else sa)
        mha, weights = self.multihead_attn(x, memory, memory, need_weights=need_weights,
                                           kv_bias=cross_bias)
        x = self.norm2(x + mha if self.do_short_cut else mha)
        if self.tp:
            group = model_group()
            y = column_linear(x, self.linear1.weight, self.linear1.bias, group)
            y = row_linear(F.relu(y), self.linear2.weight, self.linear2.bias, group)
        else:
            y = linear(F.relu(linear(x, self.linear1)), self.linear2)
        return self.norm3(x + y), weights


class CrossReferenceDecoder(nn.Module):
    """Stack of decoder layers; returns the last layer's selected-head weights."""

    def __init__(self, d_model: int, num_heads: int = 8, num_layers: int = 2, ffn_ratio: int = 1,
                 do_self_attn: bool = True, do_short_cut: bool = True,
                 attention_impl: str = "flash", device=None):
        super().__init__()
        self.layers = nn.ModuleList(
            DecoderLayer(d_model, num_heads, ffn_ratio * d_model, do_self_attn, do_short_cut,
                         attention_impl, device=device)
            for _ in range(num_layers)
        )

    def forward(self, tgt, memory, need_weights: bool = False, need_weights_head_id: int = 0,
                self_bias=None, cross_bias=None):
        """``self_bias`` / ``cross_bias``: None, or fp32 token biases over the
        query and the memory tokens that mask bucket padding."""
        x = tgt
        weights: Optional[torch.Tensor] = None
        for layer in self.layers:
            x, w = layer(x, memory, need_weights=need_weights, self_bias=self_bias,
                         cross_bias=cross_bias)
            if w is not None:
                weights = w[:, need_weights_head_id]  # (B, Nq, Nk), the last layer wins
        return x, weights
