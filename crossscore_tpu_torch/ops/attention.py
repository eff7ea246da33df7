"""Dense attention core; counterpart of ``crossscore_tpu/ops/attention.py``.

The plain version behind the K1 and K3 kernels, and the decoder's
``need_weights`` path. Logits and softmax are fp32 (torch-MHA scaling,
1/sqrt(head_dim)); the probabilities are cast to v's dtype before the
product with v, as in the JAX package. fp64 inputs (the gradient checks)
stay in fp64 throughout.
"""

from __future__ import annotations

import math

import torch


def attention_with_stats(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """(B, H, Nq, hd) x (B, H, Nk, hd) -> (o (B, H, Nq, hd), probs, l, m).

    ``m`` is the row max of the scaled logits (natural units), ``l`` is
    sum(exp(scaled - m)) -- the (o, l, m) convention of the flash kernels."""
    acc = torch.float64 if q.dtype == torch.float64 else torch.float32
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2)) * scale
    m = logits.amax(dim=-1)
    p = torch.exp(logits - m[..., None])
    l = p.sum(dim=-1)
    probs = p / l[..., None]
    o = torch.matmul(probs.to(v.dtype).to(acc), v.to(acc)).to(v.dtype)
    return o, probs, l, m


def dense_attention(q, k, v, *, return_probs: bool = False):
    """(B, H, Nq, hd) x (B, H, Nk, hd) -> (B, H, Nq, hd) dense attention;
    with ``return_probs`` also the fp32 (B, H, Nq, Nk) probabilities."""
    o, probs, _, _ = attention_with_stats(q, k, v)
    return (o, probs) if return_probs else o
