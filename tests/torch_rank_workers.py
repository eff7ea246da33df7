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


@contextlib.contextmanager
def _process_group():
    """Join the pool's process group (gloo, the CPU) for one run and leave it
    once every rank is done: a rank that sits a run out must not close its
    connections while another rank is still making its own."""
    mesh.init_distributed("gloo", "cpu")
    try:
        yield
        dist.barrier()
    finally:
        mesh.teardown()


def cp_attention(n_active: int, q: np.ndarray, k: np.ndarray, v: np.ndarray):
    """The context-parallel op over the first ``n_active`` ranks, the KV axis
    split into contiguous shards (np.array_split): -> (o, l, m) as numpy on
    the active ranks, None on the others."""
    from crossscore_tpu_torch.ops.context_parallel import _combine, context_parallel_cross_attention

    with _process_group():
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


def cp_backward(n_active: int, q: np.ndarray, k: np.ndarray, v: np.ndarray, do: np.ndarray):
    """The context-parallel op's gradients over the first ``n_active`` ranks,
    the KV axis split as in :func:`cp_attention`, every rank given the whole
    ``do``: -> (dq, this rank's dk and dv shards) as numpy on the active
    ranks, None on the others."""
    from crossscore_tpu_torch.ops.context_parallel import context_parallel_cross_attention

    with _process_group():
        group = dist.new_group(list(range(n_active)))
        if dist.get_rank() >= n_active:
            return None
        r = dist.get_rank(group)
        ks, vs = (torch.from_numpy(np.ascontiguousarray(np.array_split(x, n_active, axis=2)[r]))
                  .requires_grad_() for x in (k, v))
        qt = torch.from_numpy(q).requires_grad_()
        o = context_parallel_cross_attention(qt, ks, vs, group)
        o.backward(torch.from_numpy(do))
        return qt.grad.numpy(), ks.grad.numpy(), vs.grad.numpy()


def intra_op_threads() -> int:
    return torch.get_num_threads()


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

    with _process_group():
        model = load_into(CrossScoreNet(cfg, device="cpu"), state)
        local = torch.from_numpy(np.ascontiguousarray(refs[:, view_shard(refs.shape[1])]))
        q = torch.from_numpy(query)
        if not cached:
            return make_view_parallel_apply(model)(q, local).numpy()
        b, k = local.shape[:2]
        tokens = make_backbone_encoder(cfg)(model, local.reshape(b * k, *local.shape[2:]))
        return make_view_parallel_apply_tokens(model)(q, tokens.reshape(b, k, *tokens.shape[1:])).numpy()


def predict_cli(argv: list[str], cwd: str) -> str:
    """The predict CLI on this rank, run from ``cwd`` -> what it printed."""
    from crossscore_tpu_torch.tasks.predict import main

    os.chdir(cwd)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue()


def vp_train_grads(cfg, state: dict, query: np.ndarray, refs: np.ndarray, gt: np.ndarray) -> dict:
    """One backward of the mean |score - gt| through the view-parallel net
    (cfg with attention_impl "cp") on this rank's views: -> every trainable
    gradient by name, as numpy."""
    from crossscore_tpu_torch.io.convert import load_into
    from crossscore_tpu_torch.models import CrossScoreNet
    from crossscore_tpu_torch.parallel.view_parallel import make_view_parallel_train_apply, view_shard

    with _process_group():
        model = load_into(CrossScoreNet(cfg, device="cpu"), state)
        local = torch.from_numpy(np.ascontiguousarray(refs[:, view_shard(refs.shape[1])]))
        maps = make_view_parallel_train_apply(model)(torch.from_numpy(query), local)
        torch.abs(maps - torch.from_numpy(gt)).mean().backward()
        return {n: p.grad.numpy() for n, p in model.named_parameters() if p.requires_grad}


def make_groups_grid(n_ranks: int, model_parallel: int, batch_size) -> tuple:
    """``make_groups`` on the pool's ranks: -> (data_parallel, model_parallel,
    data_rank, model_rank, the ranks of this rank's model and data groups),
    or the error it raised."""
    with _process_group():
        try:
            grid = mesh.make_groups(model_parallel, batch_size, n_ranks=n_ranks)
        except ValueError as e:
            return ("raised", str(e))
        if not grid.active:
            return (grid.data_parallel, grid.model_parallel, None, None, None, None)
        ranks = [dist.get_process_group_ranks(g) for g in (mesh.model_group(), mesh.data_group())]
        return (grid.data_parallel, grid.model_parallel, grid.data_rank, grid.model_rank, *ranks)


def tp_train_step(n_ranks: int, model_parallel: int, cfg, state: dict, batch: dict, overrides: list):
    """One train step of ``CrossScoreNet(cfg)`` (cfg with attention_impl "tp")
    over a (data, model) grid of the first ``n_ranks`` ranks, each data rank
    taking its rows of ``batch``: -> the global loss, the full state dict
    after the step gathered over the model group, this rank's gradients of
    the replicated trainable parameters, and the shard/gather round trip of
    the initial weights; None on a rank outside the grid."""
    from crossscore_tpu_torch.confsys import load_config
    from crossscore_tpu_torch.io.convert import load_into
    from crossscore_tpu_torch.models import CrossScoreNet
    from crossscore_tpu_torch.parallel.tensor_parallel import gather_state_dict, shard_state_dict, tp_spec_for
    from crossscore_tpu_torch.train.optim import make_optimizer
    from crossscore_tpu_torch.train.step import TrainState, make_train_step

    with _process_group():
        grid = mesh.make_groups(model_parallel, n_ranks=n_ranks)
        if not grid.active:
            return None
        model = load_into(CrossScoreNet(cfg, device="cpu"),
                          shard_state_dict(state, grid.model_rank, model_parallel, cfg.mlp_impl))
        full = gather_state_dict(model.state_dict(), mesh.model_group(), cfg.mlp_impl)
        round_trip = all(torch.equal(full[k], torch.as_tensor(np.asarray(state[f"model.{k}"])))
                         for k in full)
        tcfg = load_config("default", overrides)
        optimizer, scheduler, _ = make_optimizer(tcfg, model, steps_per_epoch=10)
        rows = len(batch["query/score_map"]) // grid.data_parallel
        local = {k: torch.from_numpy(np.ascontiguousarray(v[grid.data_rank * rows:(grid.data_rank + 1) * rows]))
                 for k, v in batch.items()}
        _, metrics = make_train_step(model, optimizer, scheduler)(TrainState(), local)
        replicated = {n: p.grad.numpy().copy() for n, p in model.named_parameters()
                      if p.requires_grad and tp_spec_for(n, cfg.mlp_impl) is None}
        after = gather_state_dict(model.state_dict(), mesh.model_group(), cfg.mlp_impl)
        return {"loss": float(metrics["loss"]), "grid": (grid.data_rank, grid.model_rank),
                "params": {k: v.numpy() for k, v in after.items()}, "replicated_grads": replicated,
                "round_trip": round_trip, "n_local": sum(p.numel() for p in model.parameters())}


def tp_refusals(cfg) -> dict:
    """What the tp route refuses, on 2 ranks: a model built before any model
    group exists, heads that do not divide over the group, and a
    shape-bucketed (token-masked) forward -> the error of each."""
    import dataclasses

    from crossscore_tpu_torch.models import CrossScoreNet

    def error(fn) -> str:
        try:
            fn()
        except (NotImplementedError, RuntimeError, ValueError) as e:
            return f"{type(e).__name__}: {e}"
        return "no error"

    with _process_group():
        out = {"no groups": error(lambda: CrossScoreNet(cfg, device="cpu"))}
        mesh.make_groups(2)
        out["heads"] = error(lambda: CrossScoreNet(dataclasses.replace(cfg, decoder_heads=3), device="cpu"))
        model, hw = CrossScoreNet(cfg, device="cpu"), cfg.backbone.image_size
        with torch.no_grad():
            out["buckets"] = error(lambda: model(torch.zeros(1, hw, hw, 3), torch.zeros(1, 2, hw, hw, 3),
                                                 valid_hw=(hw, hw)))
        return out


def run_cli(n_active: int, local_world: int, task: str, argv: list[str], cwd: str, env: dict | None = None):
    """``crossscore_tpu_torch.tasks.<task>.main(argv)`` from ``cwd`` on the
    first ``n_active`` ranks of the pool, laid out as nodes of
    ``local_world`` ranks (the launcher's variables set for the run, as
    ``torchrun --nnodes n_active // local_world --nproc_per_node
    local_world`` sets them), with ``env`` set too -> (what it returned, as a
    string or None, and what it printed); None on the other ranks."""
    import importlib

    rank = int(os.environ["RANK"])
    if rank >= n_active:
        return None
    saved = {k: os.environ.get(k) for k in ("WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", *(env or {}))}
    os.environ.update(WORLD_SIZE=str(n_active), LOCAL_RANK=str(rank % local_world),
                      LOCAL_WORLD_SIZE=str(local_world), **(env or {}))
    cwd0 = os.getcwd()
    out = io.StringIO()
    try:
        os.chdir(cwd)
        with contextlib.redirect_stdout(out):
            ret = importlib.import_module(f"crossscore_tpu_torch.tasks.{task}").main(argv)
    finally:
        os.chdir(cwd0)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return (None if ret is None else str(ret)), out.getvalue()


def weighted_mean(n_active: int, series_by_rank: list, weights_by_rank: list):
    """``tasks.common.all_process_weighted_mean`` over a group of the first
    ``n_active`` ranks, each rank its own series and weights -> the means on
    the active ranks, None on the others."""
    from crossscore_tpu_torch.tasks.common import all_process_weighted_mean

    with _process_group():
        group = dist.new_group(list(range(n_active)))
        r = dist.get_rank()
        if r >= n_active:
            return None
        return all_process_weighted_mean(series_by_rank[r], weights_by_rank[r], group)


def data_layout(batch_size: int, n_ranks, local_world_by_rank: list | None = None):
    """``mesh.make_groups(1, batch_size, n_ranks)`` on the pool's ranks, each
    rank's ``LOCAL_WORLD_SIZE`` optionally replaced (uneven nodes) -> (data
    width, data rank, the ranks of its data group), or the error it raised."""
    rank = int(os.environ["RANK"])
    saved = os.environ["LOCAL_WORLD_SIZE"], os.environ["LOCAL_RANK"]
    if local_world_by_rank is not None:
        local = local_world_by_rank[rank]
        os.environ.update(LOCAL_WORLD_SIZE=str(local), LOCAL_RANK=str(rank % local))
    try:
        with _process_group():
            try:
                grid = mesh.make_groups(1, batch_size, n_ranks=n_ranks)
            except ValueError as e:
                return ("raised", str(e))
            group = mesh.data_group()
            return (grid.data_parallel, grid.data_rank,
                    None if group is None else dist.get_process_group_ranks(group))
    finally:
        os.environ["LOCAL_WORLD_SIZE"], os.environ["LOCAL_RANK"] = saved


def store_one_key(store: str, n_writes: int) -> list:
    """Every rank writes the same key of one token store ``n_writes`` times,
    the ranks released together -> the store's file names afterwards."""
    from pathlib import Path

    from crossscore_tpu_torch.data.token_cache import RefTokenCache

    with _process_group():
        cache = RefTokenCache(lambda imgs, valid_hw=None: None, persist_dir=store)
        key = cache._key("shared/frame_00000.png", (56, 56))
        tokens = torch.arange(16 * 64, dtype=torch.float32).reshape(16, 64) * (1 + dist.get_rank())
        dist.barrier()
        for _ in range(n_writes):
            cache._disk_store(key, tokens)
        dist.barrier()
        return sorted(p.name for p in Path(store).iterdir())
