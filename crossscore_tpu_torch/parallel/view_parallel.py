"""Reference-view parallelism: the K reference views sharded over the ranks of
the view group; the port's counterpart of
``crossscore_tpu/parallel/view_parallel.py``.

Each rank encodes the query and its K/n reference views (or takes their
cached tokens), and the decoder's cross-attention combines the sharded
reference-token axis exactly through the context-parallel softmax
(``ops/context_parallel.py``, the ``cp`` attention route). Rank r takes views
``[r*K/n, (r+1)*K/n)``, which is the JAX package's ``P(None, axis)`` on K, and
every rank returns the same score maps. The position embedding is the same
for every view, so a shard needs no view offset.

    top, device = parallel.mesh.init_distributed("nccl")
    model = CrossScoreNet(dataclasses.replace(cfg, attention_impl="cp"), device=device)
    fn = make_view_parallel_apply(model)
    maps = fn(query, refs[:, view_shard(refs.shape[1])])

Training runs the same model with gradients (:func:`make_view_parallel_train_apply`,
or ``train.step.make_train_step`` on a batch that carries this rank's views):
the context-parallel backward runs K8/K9 per rank, and every trainable
gradient comes out whole and equal on every rank (``models/decoder.py``).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from crossscore_tpu_torch.parallel.mesh import view_group


def view_shard(k_refs: int, group: Optional[dist.ProcessGroup] = None) -> slice:
    """This rank's views among ``k_refs``: ``[r*K/n, (r+1)*K/n)``; K must divide."""
    group = view_group() if group is None else group
    n, r = dist.get_world_size(group), dist.get_rank(group)
    if k_refs % n:
        raise ValueError(f"K={k_refs} reference views do not divide over {n} ranks")
    per = k_refs // n
    return slice(r * per, (r + 1) * per)


def _check_cp(model) -> None:
    if model.cfg.attention_impl != "cp":
        raise ValueError(f"model.cfg.attention_impl must be 'cp', got {model.cfg.attention_impl!r}")


def make_view_parallel_apply(model, need_attn_weights: bool = False) -> Callable:
    """Returns ``fn(query (B, H, W, 3), refs_local (B, K/n, H, W, 3)) ->
    (B, H, W)`` score maps, under inference mode; ``refs_local`` is this
    rank's shard (:func:`view_shard`). The model must be built with
    ``attention_impl="cp"``."""
    _check_cp(model)
    if need_attn_weights:
        raise NotImplementedError("attention-weight extraction is a single-device debug path")

    def fn(query: torch.Tensor, refs_local: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return model(query, refs_local)["score_map_ref_cross"]

    return fn


def make_view_parallel_train_apply(model) -> Callable:
    """The differentiable twin of :func:`make_view_parallel_apply`, the
    counterpart of the JAX ``make_view_parallel_apply`` under ``jax.grad``:
    ``fn(query, refs_local) -> (B, H, W)`` score maps with autograd on."""
    _check_cp(model)

    def fn(query: torch.Tensor, refs_local: torch.Tensor) -> torch.Tensor:
        return model(query, refs_local)["score_map_ref_cross"]

    return fn


def make_view_parallel_apply_tokens(model) -> Callable:
    """Token-consuming twin of :func:`make_view_parallel_apply`, the cache x
    view-parallel composition: ``fn(query, tokens_local (B, K/n, N, D))`` with
    this rank's cached reference tokens; only the query is encoded."""
    _check_cp(model)

    def fn(query: torch.Tensor, tokens_local: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return model(query, None, ref_tokens=tokens_local)["score_map_ref_cross"]

    return fn
