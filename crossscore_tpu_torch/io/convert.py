"""Weights into the port: from the JAX package's parameter tree, from a
reference Lightning ``state_dict``, or from a seed.

- :func:`state_dict_from_jax` maps a JAX ``CrossScoreNet`` parameter tree
  (nested dicts of numpy arrays, as ``jax.device_get`` gives it) to the
  reference Lightning keys (``model.``-prefixed, plus ``model.img_mean_std``),
  the same dict ``crossscore_tpu.io.torch_convert.revert_lightning_ckpt``
  returns. This is the port's own implementation of that mapping.
- :func:`load_into` loads such a dict, or a reference ``state_dict``, into a
  port model. A model built with ``attention_impl="tp"`` takes its model
  rank's shard: ``parallel.tensor_parallel.shard_state_dict`` of the full
  dict, so ``state_dict_from_jax`` then ``shard_state_dict`` carries the JAX
  parameters into every rank.
- :func:`init_params` draws the port's own seeded parameters with the flax
  initialisers' distributions.

Layouts: a flax Dense kernel (in, out) is a torch Linear weight (out, in)
transposed; the patch-embed kernel (P*P*3, D) is the conv weight (D, 3, P, P)
flattened in (p_h, p_w, c) order; the fused qkv kernel (D, 3D) holds the
query, key and value weights as column blocks; the decoder's q/k/v kernels
pack into torch's ``in_proj_weight`` (3D, D).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping

import numpy as np
import torch

from crossscore_tpu_torch.models.crossscore import (
    IMAGENET_MEAN, IMAGENET_STD, CrossScoreConfig, CrossScoreNet,
)


def _dense(tree: Mapping, out: dict, prefix: str) -> None:
    out[f"{prefix}.weight"] = np.ascontiguousarray(np.asarray(tree["kernel"]).T)
    out[f"{prefix}.bias"] = np.asarray(tree["bias"])


def _ln(tree: Mapping, out: dict, prefix: str) -> None:
    out[f"{prefix}.weight"] = np.asarray(tree["scale"])
    out[f"{prefix}.bias"] = np.asarray(tree["bias"])


def _backbone(params: Mapping, out: dict, root: str) -> None:
    kern = np.asarray(params["patch_proj"]["kernel"])  # (P*P*3, D)
    d = kern.shape[1]
    p = math.isqrt(kern.shape[0] // 3)
    emb = f"{root}embeddings"
    out[f"{emb}.patch_embeddings.projection.weight"] = np.ascontiguousarray(
        kern.reshape(p, p, 3, d).transpose(3, 2, 0, 1)
    )
    out[f"{emb}.patch_embeddings.projection.bias"] = np.asarray(params["patch_proj"]["bias"])
    out[f"{emb}.cls_token"] = np.asarray(params["cls_token"])
    out[f"{emb}.mask_token"] = np.zeros((1, d), np.float32)
    out[f"{emb}.position_embeddings"] = np.asarray(params["pos_embed"])
    _ln(params["final_ln"], out, f"{root}layernorm")
    for i in range(sum(1 for k in params if str(k).startswith("block_"))):
        blk, pre = params[f"block_{i}"], f"{root}encoder.layer.{i}"
        qkv = np.asarray(blk["attn"]["qkv"]["kernel"])  # (D, 3D)
        qkv_b = np.asarray(blk["attn"]["qkv"]["bias"])
        for j, name in enumerate(("query", "key", "value")):
            out[f"{pre}.attention.attention.{name}.weight"] = np.ascontiguousarray(
                qkv[:, j * d:(j + 1) * d].T
            )
            out[f"{pre}.attention.attention.{name}.bias"] = qkv_b[j * d:(j + 1) * d]
        _dense(blk["attn"]["out"], out, f"{pre}.attention.output.dense")
        _ln(blk["ln1"], out, f"{pre}.norm1")
        _ln(blk["ln2"], out, f"{pre}.norm2")
        _dense(blk["fc1"], out, f"{pre}.mlp.fc1")
        _dense(blk["fc2"], out, f"{pre}.mlp.fc2")
        out[f"{pre}.layer_scale1.lambda1"] = np.asarray(blk["ls1"])
        out[f"{pre}.layer_scale2.lambda1"] = np.asarray(blk["ls2"])


def mha_state_from_jax(tree: Mapping, out: dict, prefix: str) -> None:
    """A JAX ``TorchStyleMHA`` tree -> torch ``MultiheadAttention`` keys."""
    names = ("q_proj", "k_proj", "v_proj")
    out[f"{prefix}.in_proj_weight"] = np.ascontiguousarray(
        np.concatenate([np.asarray(tree[k]["kernel"]).T for k in names], axis=0)
    )
    out[f"{prefix}.in_proj_bias"] = np.concatenate([np.asarray(tree[k]["bias"]) for k in names])
    _dense(tree["out_proj"], out, f"{prefix}.out_proj")


def _decoder(params: Mapping, out: dict, root: str) -> None:
    for i in range(sum(1 for k in params if str(k).startswith("layer_"))):
        layer, pre = params[f"layer_{i}"], f"{root}layers.{i}"
        if "self_attn" in layer:
            mha_state_from_jax(layer["self_attn"], out, f"{pre}.self_attn")
            _ln(layer["norm1"], out, f"{pre}.norm1")
        mha_state_from_jax(layer["cross_attn"], out, f"{pre}.multihead_attn")
        _ln(layer["norm2"], out, f"{pre}.norm2")
        _dense(layer["linear1"], out, f"{pre}.linear1")
        _dense(layer["linear2"], out, f"{pre}.linear2")
        _ln(layer["norm3"], out, f"{pre}.norm3")


def state_dict_from_jax(params: Mapping) -> dict[str, np.ndarray]:
    """JAX ``CrossScoreNet`` parameter tree -> reference Lightning ``state_dict``."""
    sd: dict[str, np.ndarray] = {
        "model.img_mean_std": np.concatenate([IMAGENET_MEAN, IMAGENET_STD]).astype(np.float32),
        "model.pos_enc_fn.PE": np.asarray(params["pos_enc"]["pe"])[None],
    }
    _backbone(params["backbone"], sd, "model.backbone.")
    _decoder(params["decoder"], sd, "model.ref_cross.attn.")
    _dense(params["head_fc1"], sd, "model.ref_cross.head.0")
    _dense(params["head_fc2"], sd, "model.ref_cross.head.2")
    return sd


def load_into(model: torch.nn.Module, sd: Mapping) -> torch.nn.Module:
    """Load a Lightning-keyed dict (``model.``-prefixed or not; numpy arrays or
    tensors) into ``model`` under ``strict=True``; returns the model."""
    prefix = "model."
    state = {}
    for k, v in sd.items():
        key = k[len(prefix):] if k.startswith(prefix) else k
        state[key] = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v, np.float32))
    model.load_state_dict(state, strict=True)
    return model


def _truncated_normal(shape, std: float, gen: torch.Generator) -> torch.Tensor:
    """std * a standard normal truncated to [-2, 2] (jax.random.truncated_normal)."""
    lo, hi = (1.0 + math.erf(-2.0 / math.sqrt(2.0))) / 2.0, (1.0 + math.erf(2.0 / math.sqrt(2.0))) / 2.0
    u = lo + (hi - lo) * torch.rand(shape, generator=gen, dtype=torch.float64)
    return (std * math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)).float()


def init_params(cfg: CrossScoreConfig, seed: int, device=None) -> dict[str, torch.Tensor]:
    """Seeded parameters for the port's ``CrossScoreNet(cfg)`` (unprefixed keys).

    The flax initialisers' distributions: lecun-normal kernels (truncated
    normal, variance 1/fan_in), zero biases, LayerNorm scale 1, LayerScale at
    ``layerscale_init``, the PE from N(0, 1), CLS token and position table
    truncated normal with std 0.02. Drawn on the CPU from a
    ``torch.Generator``, then moved to ``device``."""
    gen = torch.Generator().manual_seed(seed)
    if cfg.attention_impl == "tp":  # the full parameters; shard_state_dict shards them
        cfg = dataclasses.replace(cfg, attention_impl="flash")
    shapes = CrossScoreNet(cfg, device="meta").state_dict()
    out: dict[str, torch.Tensor] = {}
    for key, t in shapes.items():
        shape = tuple(t.shape)
        leaf = key.rsplit(".", 1)[-1]
        if key == "img_mean_std":
            val = torch.from_numpy(np.concatenate([IMAGENET_MEAN, IMAGENET_STD]))
        elif key == "pos_enc_fn.PE":
            val = torch.randn(shape, generator=gen)
        elif leaf in ("cls_token", "position_embeddings"):
            val = _truncated_normal(shape, 0.02, gen)
        elif leaf == "mask_token":
            val = torch.zeros(shape)
        elif leaf == "lambda1":
            val = torch.full(shape, float(cfg.backbone.layerscale_init))
        elif leaf in ("bias", "in_proj_bias"):
            val = torch.zeros(shape)
        elif key.split(".")[-2].startswith(("norm", "layernorm")):
            val = torch.ones(shape)
        else:  # Linear / packed in_proj / patch-embed conv weights
            fan_in = math.prod(shape[1:])
            val = _truncated_normal(shape, math.sqrt(1.0 / fan_in) / 0.87962566103423978, gen)
        out[key] = val.to(device)
    return out
