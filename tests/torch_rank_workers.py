"""Functions that the port's multi-rank tests run in every rank of a
``crossscore_tpu_torch.parallel.launch.RankPool``. The ranks import this
module by name, so it imports no JAX and no test module: each rank stays a
plain PyTorch process on the CPU, joined over gloo."""

from __future__ import annotations

import contextlib
import io
import os

import numpy as np
import torch
import torch.distributed as dist

from crossscore_tpu_torch.parallel import mesh


def cp_attention(n_active: int, q: np.ndarray, k: np.ndarray, v: np.ndarray):
    """The context-parallel op over the first ``n_active`` ranks, the KV axis
    split into contiguous shards (np.array_split): -> (o, l, m) as numpy on
    the active ranks, None on the others."""
    from crossscore_tpu_torch.ops.context_parallel import _combine, context_parallel_cross_attention

    mesh.init_distributed("gloo", "cpu")
    try:
        group = dist.new_group(list(range(n_active)))
        if dist.get_rank() >= n_active:
            return None
        r = dist.get_rank(group)
        ks, vs = (torch.from_numpy(np.ascontiguousarray(np.array_split(x, n_active, axis=2)[r]))
                  for x in (k, v))
        qt = torch.from_numpy(q)
        o, l, m = _combine(qt, ks, vs, group)
        assert torch.equal(context_parallel_cross_attention(qt, ks, vs, group), o)
        return o.numpy(), l.numpy(), m.numpy()
    finally:
        mesh.teardown()


def cp_backward_raises() -> str:
    """The op's backward on 2 ranks: -> the error it raises."""
    from crossscore_tpu_torch.ops.context_parallel import context_parallel_cross_attention

    mesh.init_distributed("gloo", "cpu")
    try:
        q = torch.randn(1, 1, 4, 16, requires_grad=True)
        out = context_parallel_cross_attention(q, torch.randn(1, 1, 8, 16), torch.randn(1, 1, 8, 16))
        try:
            out.sum().backward()
        except NotImplementedError as e:
            return str(e)
        return "no error"
    finally:
        mesh.teardown()


def fail_on_rank(rank: int) -> int:
    if int(os.environ["RANK"]) == rank:
        raise ValueError(f"rank {rank} fails on purpose")
    return int(os.environ["RANK"])


def vp_net(cfg, state: dict, query: np.ndarray, refs: np.ndarray, cached: bool) -> np.ndarray:
    """View-parallel score maps of ``CrossScoreNet(cfg)`` (cfg with
    attention_impl "cp") on this rank's views: from pixels, or (``cached``)
    from the tokens of its views encoded by the backbone alone."""
    from crossscore_tpu_torch.io.convert import load_into
    from crossscore_tpu_torch.models import CrossScoreNet
    from crossscore_tpu_torch.models.crossscore import make_backbone_encoder
    from crossscore_tpu_torch.parallel.view_parallel import (
        make_view_parallel_apply, make_view_parallel_apply_tokens, view_shard,
    )

    mesh.init_distributed("gloo", "cpu")
    try:
        model = load_into(CrossScoreNet(cfg, device="cpu"), state)
        local = torch.from_numpy(np.ascontiguousarray(refs[:, view_shard(refs.shape[1])]))
        q = torch.from_numpy(query)
        if not cached:
            return make_view_parallel_apply(model)(q, local).numpy()
        b, k = local.shape[:2]
        tokens = make_backbone_encoder(cfg)(model, local.reshape(b * k, *local.shape[2:]))
        return make_view_parallel_apply_tokens(model)(q, tokens.reshape(b, k, *tokens.shape[1:])).numpy()
    finally:
        mesh.teardown()


def predict_cli(argv: list[str], cwd: str) -> str:
    """The predict CLI on this rank, run from ``cwd`` -> what it printed."""
    from crossscore_tpu_torch.tasks.predict import main

    os.chdir(cwd)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue()
