"""Dense attention core; counterpart of ``crossscore_tpu/ops/attention.py``.

The plain version behind the K1, K3, K5 and K6 kernels, and the decoder's
``need_weights`` path. Logits and softmax are fp32 (torch-MHA scaling,
1/sqrt(head_dim)); the probabilities are cast to v's dtype before the
product with v, as in the JAX package. fp64 inputs (the gradient checks)
stay in fp64 throughout.

``kv_bias`` is an optional additive logits bias over the KV tokens in natural
units: (Nk,) shared by the batch, or (B, Nk) per item. Shape-bucketed
inference passes 0 for a valid token and -1e30 for a padded one.
"""

from __future__ import annotations

import math

import torch


def _bias(kv_bias: torch.Tensor, acc: torch.dtype) -> torch.Tensor:
    """(Nk,) or (B, Nk) -> a bias broadcastable over (B, H, Nq, Nk) logits."""
    if kv_bias.ndim == 2:
        kv_bias = kv_bias[:, None, None, :]
    return kv_bias.to(acc)


def attention_with_stats(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_bias=None):
    """(B, H, Nq, hd) x (B, H, Nk, hd) -> (o (B, H, Nq, hd), probs, l, m).

    ``m`` is the row max of the scaled (and biased) logits (natural units),
    ``l`` is sum(exp(scaled - m)) -- the (o, l, m) convention of the flash
    kernels."""
    acc = torch.float64 if q.dtype == torch.float64 else torch.float32
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2)) * scale
    if kv_bias is not None:
        logits = logits + _bias(kv_bias, acc)
    m = logits.amax(dim=-1)
    p = torch.exp(logits - m[..., None])
    l = p.sum(dim=-1)
    probs = p / l[..., None]
    o = torch.matmul(probs.to(v.dtype).to(acc), v.to(acc)).to(v.dtype)
    return o, probs, l, m


def dense_attention(q, k, v, *, kv_bias=None, return_probs: bool = False):
    """(B, H, Nq, hd) x (B, H, Nk, hd) -> (B, H, Nq, hd) dense attention;
    with ``return_probs`` also the fp32 (B, H, Nq, Nk) probabilities."""
    o, probs, _, _ = attention_with_stats(q, k, v, kv_bias)
    return (o, probs) if return_probs else o
