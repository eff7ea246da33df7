"""Train, eval and predict steps; counterpart of ``crossscore_tpu/train/step.py``.

The train step is forward (frozen backbone under ``torch.no_grad``; on a
token batch, ``query/tokens``, the decoder-only graph), L1 loss, backward
(K4 for the decoder attention; K8/K9 on the ``tp`` and ``cp`` routes), AdamW
update and the per-step schedule. Loss parity: reference
``task/core.py:277-293``, the mean |pred - gt| over the (B, H, W) score maps,
with loader-padded rows weighted out.

Over ranks (``parallel.mesh``), the step reduces what the JAX package's
sharded step reduces:

- data group (``make_groups``): each rank takes its rows of the global batch.
  The loss is JAX's global weighted mean, ``sum(l1 * w) / max(sum(w), 1)``:
  one all-reduce SUM of the weight before the backward, each rank's loss its
  weighted L1 sum over the global weight, then one SUM of the gradients over
  the data group. The metrics are the global ones.
- model group (``tp``): nothing to reduce. The Megatron collectives of
  ``parallel.tensor_parallel`` leave the gradients of replicated parameters
  whole and equal on every model rank, and each shard's its own.
- view group (``cp``): nothing to reduce either. The query side's gradients
  are whole on every rank; those reached only through this rank's reference
  views (the cross-attention's k/v rows, the PE's reference share) are
  summed over the view group inside the backward (``models/decoder.py``,
  ``models/crossscore.py``).

AdamW is elementwise and neither package clips by a global norm, so the
optimiser runs on each rank's parameters as they are.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from crossscore_tpu_torch.models.crossscore import CrossScoreNet
from crossscore_tpu_torch.ops.metrics import abs2psnr, correlation, masked_correlation
from crossscore_tpu_torch.parallel import mesh
from crossscore_tpu_torch.parallel.collectives import all_gather, all_reduce


@dataclasses.dataclass(frozen=True)
class TrainState:
    """The step count and the exact loop cursor for a mid-epoch resume (the
    model and the optimiser hold the rest). The train loop resets
    ``batch_in_epoch`` at epoch boundaries."""

    step: int = 0
    epoch: int = 0
    batch_in_epoch: int = 0


def batch_to_device(batch: dict, device) -> dict:
    """Loader batch (numpy arrays, or host tensors: the token loader's
    tokens) -> tensors on ``device`` (``item_paths`` dropped). ``_valid_hw``
    stays a host array: the model reads the bucket extents on the host."""
    return {k: v if k == "_valid_hw" else
            (v if isinstance(v, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(v)))
            .to(device, non_blocking=True) for k, v in batch.items() if k != "item_paths"}


def _weights(batch: dict, shape, patch: int = 14, device="cpu") -> Optional[torch.Tensor]:
    """(B, H, W) 0/1 fp32 weights excluding loader padding from the loss and
    the metrics; the port's copy of the JAX ``_weights``. Two sources, both
    from the loaders:

    - duplicate items in the final partial batch: the ``_valid`` prefix
      count, or its per-row ``_valid_mask`` form;
    - bucket-padded image regions under shape bucketing (``_valid_hw``,
      (2,) shared or (B, 2) per item): the valid jigsaw extent is
      ``(h // patch * patch, w // patch * patch)``, ``patch`` the model's
      patch size.

    None when the batch carries none of them. The padding may come as numpy
    arrays or tensors; the weights are made on ``device``."""
    b, hgt, wdt = shape
    valid, valid_mask, valid_hw = batch.get("_valid"), batch.get("_valid_mask"), batch.get("_valid_hw")
    if valid is None and valid_mask is None and valid_hw is None:
        return None
    w = torch.ones((b, 1, 1), dtype=torch.float32, device=device)
    if valid_mask is not None:
        w = torch.as_tensor(valid_mask, device=device).float()[:, None, None]
    elif valid is not None:
        w = (torch.arange(b, device=device) < torch.as_tensor(valid, device=device)).float()[:, None, None]
    if valid_hw is not None:
        vhw = torch.as_tensor(valid_hw, device=device)
        ch, cw = vhw[..., 0] // patch * patch, vhw[..., 1] // patch * patch
        rows, cols = torch.arange(hgt, device=device), torch.arange(wdt, device=device)
        if vhw.ndim == 2:  # (B, 2) per item (bucket-packed)
            region = (rows[None, :, None] < ch[:, None, None]) & (cols[None, None, :] < cw[:, None, None])
        else:
            region = ((rows[:, None] < ch) & (cols[None, :] < cw))[None]
        w = w * region.float()
    # without bucket padding the rows' weights are a view: no (B, H, W) buffer
    return w.expand(shape)


def loss_fn(model: CrossScoreNet, batch: dict, weight_sum: Optional[torch.Tensor] = None):
    """-> (loss, (pred, l1, w)). ``weight_sum``: the global sum of the
    weights over the data group (each rank then returns its weighted L1 sum
    over it, its share of the global mean)."""
    gt = batch["query/score_map"]
    w = _weights(batch, gt.shape, model.cfg.patch_size, gt.device)
    q_tokens = batch.get("query/tokens")
    if q_tokens is not None:
        # token-space training (data/token_train.py): both sides arrive as
        # frozen-backbone tokens, the step is the decoder-only graph on the
        # score map's patch grid
        _, hgt, wdt = batch["query/score_map"].shape
        p = model.cfg.patch_size
        out = model(None, None, ref_tokens=batch["reference/cross/tokens"], query_tokens=q_tokens,
                    token_grid=(hgt // p, wdt // p))
    else:
        # valid_hw: the host (2,) shared or (B, 2) per-item extents of a
        # bucket-padded batch; the model branches on its ndim
        out = model(batch["query/img"], batch.get("reference/cross/imgs"),
                    ref_tokens=batch.get("reference/cross/tokens"), valid_hw=batch.get("_valid_hw"))
    pred = out["score_map_ref_cross"]
    l1 = torch.abs(pred.float() - gt.float())
    if weight_sum is not None:
        loss = (l1.sum() if w is None else torch.sum(l1 * w)) / torch.clamp(weight_sum, min=1.0)
    elif w is None:
        loss = l1.mean()
    else:
        loss = torch.sum(l1 * w) / torch.clamp(w.sum(), min=1.0)
    return loss, (pred, l1, w)


def _data_parallel_loss(model: CrossScoreNet, batch: dict, group):
    """The global weighted mean over the data group: -> (this rank's share of
    the loss, the global loss, (this rank's pred, pred and w gathered over
    the group))."""
    gt = batch["query/score_map"]
    shape = gt.shape
    w = _weights(batch, shape, model.cfg.patch_size, gt.device)
    ws = torch.tensor(float(np.prod(shape)), device=gt.device) if w is None \
        else w.sum()
    ws = all_reduce(ws.float(), dist.ReduceOp.SUM, group)
    loss, (pred, _, w) = loss_fn(model, batch, weight_sum=ws)
    with torch.no_grad():
        total = all_reduce(loss.detach().clone(), dist.ReduceOp.SUM, group)
        pred_all = all_gather(pred.detach(), group)
        w_all = None if w is None else all_gather(w, group)
    return loss, total, (pred, pred_all, w_all)


def _sum_gradients(params: list, group) -> None:
    """One all-reduce SUM of every gradient over ``group``, in one buffer."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    flat = all_reduce(torch.cat([p.grad.reshape(-1) for p in params]), dist.ReduceOp.SUM, group)
    for p, g in zip(params, flat.split([p.numel() for p in params])):
        p.grad.copy_(g.view_as(p))


def _metrics(loss, pred, gt, w=None) -> dict:
    corr = correlation(pred, gt) if w is None else masked_correlation(pred, gt, w)
    return {"loss": loss, "loss_cross": loss, "psnr_cross": abs2psnr(loss), "correlation_cross": corr}


def make_train_step(model: CrossScoreNet, optimizer: torch.optim.Optimizer, scheduler) -> Callable:
    """``train_step(state, batch) -> (state, metrics)``: one update of the
    model's trainable parameters in place. ``metrics`` holds 0-d tensors on
    the device and, under ``"pred"``, the training forward's score map (the
    figure and histogram cadences reuse it, reference
    ``task/core.py:312-362``). With a data group registered
    (``parallel.mesh.make_groups``) the batch is this rank's rows, and the
    loss, the gradients and the metrics are the global ones; ``"pred"`` stays
    this rank's rows."""
    group = _one_data_rank(mesh.data_group())
    params = [p for p in model.parameters() if p.requires_grad]

    def train_step(state: TrainState, batch: dict):
        optimizer.zero_grad(set_to_none=True)
        gt = batch["query/score_map"]
        if group is None:
            loss, (pred, _, w) = loss_fn(model, batch)
            loss.backward()
            total, pred_m, gt_m, w_m = loss.detach(), pred.detach(), gt, w
        else:
            loss, total, (pred, pred_m, w_m) = _data_parallel_loss(model, batch, group)
            loss.backward()
            _sum_gradients(params, group)
            gt_m = all_gather(gt, group)
        optimizer.step()
        scheduler.step()
        state = dataclasses.replace(state, step=state.step + 1, batch_in_epoch=state.batch_in_epoch + 1)
        with torch.no_grad():
            metrics = _metrics(total, pred_m, gt_m, w_m)
        metrics["pred"] = pred.detach()
        return state, metrics

    return train_step


def _one_data_rank(group):
    """None for no data group or a group of one rank (its batch is the global one)."""
    return None if group is None or dist.get_world_size(group) == 1 else group


def make_eval_step(model: CrossScoreNet, data_parallel: bool = True) -> Callable:
    """``eval_step(batch) -> (pred, metrics)`` without gradients. With a data
    group registered (``parallel.mesh.make_groups``) and ``data_parallel``,
    the batch is this rank's rows and the metrics are those of the global
    batch, as the JAX step computes them over a sharded batch: the loss is
    the global weighted mean and pred, gt and w are gathered over the group
    for the correlation (as the train step's, ``_data_parallel_loss``);
    ``pred`` stays this rank's rows. A collective then: every rank of the
    group steps through the same batches."""
    group = _one_data_rank(mesh.data_group()) if data_parallel else None

    def eval_step(batch: dict):
        with torch.no_grad():
            if group is None:
                loss, (pred, _, w) = loss_fn(model, batch)
                return pred, _metrics(loss, pred, batch["query/score_map"], w)
            _, total, (pred, pred_all, w_all) = _data_parallel_loss(model, batch, group)
            return pred, _metrics(total, pred_all, all_gather(batch["query/score_map"], group), w_all)

    return eval_step


def make_predict_step(model: CrossScoreNet, need_attn_weights: bool = False,
                      head_id: int = 0) -> Callable:
    """``predict_step(query_img, ref_imgs, valid_hw=None) -> dict`` under
    inference mode; the model holds its weights (the JAX step takes them as an
    argument). ``valid_hw``: host (2,) or (B, 2) extents of bucket-padded
    images (shape-bucketed inference)."""

    def predict_step(query_img: torch.Tensor, ref_imgs: torch.Tensor, valid_hw=None) -> dict:
        with torch.inference_mode():
            return model(query_img, ref_imgs, need_attn_weights=need_attn_weights,
                         need_attn_weights_head_id=head_id, valid_hw=valid_hw)

    return predict_step


def make_predict_step_cached(model: CrossScoreNet) -> Callable:
    """``predict_step(query_img, ref_tokens, valid_hw=None, ref_grid=None) ->
    dict``: the predict step on precomputed reference tokens (the
    cached-reference path, ``data/token_cache.py``), so only the queries go
    through the frozen backbone. ``valid_hw`` (B, 2) composes the cache with
    shape bucketing: the query encode and the decoder mask the padding as the
    uncached bucketed step does."""

    def predict_step(query_img: torch.Tensor, ref_tokens: torch.Tensor, valid_hw=None,
                     ref_grid=None) -> dict:
        with torch.inference_mode():
            return model(query_img, None, ref_tokens=ref_tokens, valid_hw=valid_hw,
                         ref_grid=ref_grid)

    return predict_step
