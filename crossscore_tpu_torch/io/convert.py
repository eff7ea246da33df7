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
- :func:`load_backbone` loads the frozen backbone from a local torch file
  (``model.backbone.init_path``): a HuggingFace ``Dinov2Model`` state dict,
  whose keys are the port's backbone keys, or a reference Lightning
  checkpoint, whose ``model.backbone.*`` part it takes. The JAX package reads
  an orbax directory there instead.
- :func:`main` is the converter's command, the counterpart of
  ``crossscore_tpu/io/torch_convert.py``'s (``crossscore-convert``), with its
  arguments; the port's checkpoints are torch files, so its three modes are:

      python -m crossscore_tpu_torch.io.convert CKPT OUT_DIR [--backbone-layers 12]
          [--decoder-layers 2] [--d-model 384] [--trust-pickle]
                                                    # Lightning .ckpt -> OUT_DIR/step_00000000.ckpt
      python -m crossscore_tpu_torch.io.convert HF_DIR OUT_FILE --hf-backbone
                                                    # HF Dinov2Model dir -> model.backbone.init_path file
      python -m crossscore_tpu_torch.io.convert PORT_CKPT OUT_FILE --reverse
                                                    # step_<N>.ckpt or a ckpt/ dir -> Lightning .ckpt

  The default mode keeps the model's tensors in fp32 (the optimiser and loop
  state dropped) in a directory that ``tasks/common.py::load_model_params``
  restores (``trainer.ckpt_path_to_load``); every key and shape is checked
  against ``CrossScoreNet`` at the flags' widths (the backbone preset of
  ``--d-model``'s width, its depth ``--backbone-layers``). It loads tensors
  and plain containers only; a file that also pickled Python objects (a
  Lightning file's hyper-parameters) is refused unless ``--trust-pickle``
  asks for the full unpickling the JAX converter does, which can run code
  from the file. ``--hf-backbone``
  reads ``config.json`` and ``model.safetensors`` (parsed here: neither
  ``transformers`` nor ``safetensors`` is imported) or, failing that,
  ``pytorch_model.bin``, checks it against the backbone that ``config.json``
  describes, and writes the HF keys unchanged in fp32. ``--reverse`` writes
  the JAX ``save_lightning_ckpt`` envelope, which the reference stack and
  ``convert_lightning_ckpt`` read.

Layouts: a flax Dense kernel (in, out) is a torch Linear weight (out, in)
transposed; the patch-embed kernel (P*P*3, D) is the conv weight (D, 3, P, P)
flattened in (p_h, p_w, c) order; the fused qkv kernel (D, 3D) holds the
query, key and value weights as column blocks; the decoder's q/k/v kernels
pack into torch's ``in_proj_weight`` (3D, D).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import pickle
from pathlib import Path
from typing import Mapping

import numpy as np
import torch

from crossscore_tpu_torch.io.checkpoint import latest_step, step_path
from crossscore_tpu_torch.models.crossscore import (
    IMAGENET_MEAN, IMAGENET_STD, CrossScoreConfig, CrossScoreNet,
)
from crossscore_tpu_torch.models.dinov2 import VIT_PRESETS, Dinov2Encoder, ViTConfig


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


def _mismatch(own: Mapping, state: Mapping) -> str | None:
    """What keeps ``state`` from loading into a module whose state dict is
    ``own`` (missing and unexpected keys, shapes that differ), or None."""
    missing, extra = sorted(set(own) - set(state)), sorted(set(state) - set(own))
    shapes = [f"{k} {tuple(state[k].shape)} != {tuple(v.shape)}" for k, v in own.items()
              if k in state and tuple(state[k].shape) != tuple(v.shape)]
    if missing or extra or shapes:
        return f"missing {missing[:5]} ({len(missing)}), unexpected {extra[:5]} ({len(extra)}), shapes {shapes[:5]}"
    return None


def load_backbone(model: torch.nn.Module, path) -> torch.nn.Module:
    """Load the backbone's tensors in a local torch file into
    ``model.backbone``: a HuggingFace ``Dinov2Model`` state dict
    (``embeddings.*``, ``encoder.layer.*``, ``layernorm.*``) as it is, or the
    ``model.backbone.*`` (or ``backbone.*``) entries of a reference Lightning
    checkpoint or a state dict, their prefix dropped. A missing or
    unexpected key, or a shape that differs, raises ValueError naming them.
    Returns the model."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    state = blob.get("state_dict", blob) if isinstance(blob, dict) else blob
    for prefix in ("model.backbone.", "backbone."):
        if any(k.startswith(prefix) for k in state):
            state = {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}
            break
    own = model.backbone.state_dict()
    bad = _mismatch(own, state)
    if bad:
        raise ValueError(f"model.backbone.init_path={path} does not fit the backbone: {bad}")
    model.backbone.load_state_dict({k: torch.as_tensor(state[k]).to(v.dtype) for k, v in own.items()}, strict=True)
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


# --- the converter's command -------------------------------------------------

LIGHTNING_VERSION = "2.1.3"  # the JAX save_lightning_ckpt envelope's
_SAFETENSORS_DTYPES = {"F32": np.dtype("<f4"), "F16": np.dtype("<f2"), "BF16": np.dtype("<u2")}


def read_safetensors(path) -> dict[str, torch.Tensor]:
    """A ``.safetensors`` file's tensors, parsed by hand: an 8-byte
    little-endian header length, a JSON header of ``dtype``, ``shape`` and
    ``data_offsets`` per tensor, then the raw bytes. F32, F16 and BF16 (read
    as uint16, viewed as bfloat16); any other dtype raises ValueError."""
    data = Path(path).read_bytes()
    n = int.from_bytes(data[:8], "little")
    header = json.loads(data[8:8 + n])
    out = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        if meta["dtype"] not in _SAFETENSORS_DTYPES:
            raise ValueError(f"{path}: {name} is {meta['dtype']}; the converter reads F32, F16 and BF16")
        dt = _SAFETENSORS_DTYPES[meta["dtype"]]
        begin, end = meta["data_offsets"]
        arr = np.frombuffer(data, dt, (end - begin) // dt.itemsize, 8 + n + begin).copy()
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16) if meta["dtype"] == "BF16" \
            else torch.from_numpy(arr)
        out[name] = t.reshape(meta["shape"])
    return out


def hf_backbone_config(hf_config: Mapping) -> ViTConfig:
    """The port's backbone for a HuggingFace ``Dinov2Config`` (``config.json``)."""
    return ViTConfig(hidden_size=hf_config["hidden_size"], num_layers=hf_config["num_hidden_layers"],
                     num_heads=hf_config["num_attention_heads"], mlp_ratio=hf_config.get("mlp_ratio", 4),
                     patch_size=hf_config.get("patch_size", 14),
                     layerscale_init=hf_config.get("layerscale_value", 1.0),
                     layer_norm_eps=hf_config.get("layer_norm_eps", 1e-6),
                     image_size=hf_config.get("image_size", 518))


def read_hf_backbone(directory) -> tuple[dict[str, torch.Tensor], ViTConfig]:
    """A local HuggingFace ``Dinov2Model`` directory -> (its state dict in
    fp32 under the HF keys, the backbone ``config.json`` describes). The
    weights come from ``model.safetensors``, else ``pytorch_model.bin``; a
    key or shape that does not fit that backbone raises ValueError."""
    directory = Path(directory)
    vit = hf_backbone_config(json.loads((directory / "config.json").read_text()))
    if (directory / "model.safetensors").is_file():
        state = read_safetensors(directory / "model.safetensors")
    elif (directory / "pytorch_model.bin").is_file():
        state = torch.load(directory / "pytorch_model.bin", map_location="cpu", weights_only=True)
    else:
        raise FileNotFoundError(f"{directory} holds neither model.safetensors nor pytorch_model.bin")
    bad = _mismatch(Dinov2Encoder(vit, device="meta").state_dict(), state)
    if bad:
        raise ValueError(f"{directory} does not fit the backbone its config.json describes: {bad}")
    return {k: v.float().contiguous() for k, v in state.items()}, vit


def net_config(backbone_layers: int, decoder_layers: int, d_model: int) -> CrossScoreConfig:
    """The net the CLIs build at these widths: the backbone preset of width
    ``d_model`` at depth ``backbone_layers``, the config's defaults else."""
    presets = [p for p in VIT_PRESETS.values() if p.hidden_size == d_model]
    if not presets:
        raise ValueError(f"--d-model {d_model}: no backbone preset has that width "
                         f"({sorted({p.hidden_size for p in VIT_PRESETS.values()})})")
    return CrossScoreConfig(backbone=dataclasses.replace(presets[0], num_layers=backbone_layers),
                            decoder_layers=decoder_layers, compute_dtype=torch.float32)


def _load_checkpoint(path, trust_pickle: bool = False) -> dict:
    """A torch checkpoint's dict. Tensors and plain containers load as they
    are; a Lightning file that also pickled Python objects (its
    hyper-parameters) raises ValueError, unless ``trust_pickle`` reads it in
    full, as the JAX converter does (unpickling can run code from the file)."""
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as e:
        if not trust_pickle:
            raise ValueError(f"{path} holds Python objects besides tensors, which a tensors-only load refuses; "
                             f"if the file is trusted, pass --trust-pickle to read it in full (unpickling can "
                             f"run code from the file)") from e
        print(f"{path} holds Python objects besides tensors: read in full (--trust-pickle)")
        return torch.load(path, map_location="cpu", weights_only=False)


def _save(blob: dict, path: Path) -> Path:
    """``blob`` to ``path`` whole or not at all (written aside, then renamed)."""
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    torch.save(blob, tmp)
    os.replace(tmp, path)
    return path


def convert_lightning(ckpt, out_dir, backbone_layers: int = 12, decoder_layers: int = 2,
                      d_model: int = 384, trust_pickle: bool = False) -> Path:
    """A reference Lightning ``.ckpt`` -> ``out_dir/step_00000000.ckpt``
    holding ``{"state_dict"}``, the model's tensors in fp32 under their
    ``model.`` keys, checked against :func:`net_config`'s net
    (``trust_pickle``: :func:`_load_checkpoint`)."""
    blob = _load_checkpoint(ckpt, trust_pickle)
    state = blob.get("state_dict", blob)
    own = {f"model.{k}": v for k, v in
           CrossScoreNet(net_config(backbone_layers, decoder_layers, d_model), device="meta").state_dict().items()}
    bad = _mismatch(own, state)
    if bad:
        raise ValueError(f"{ckpt} does not fit CrossScoreNet at --backbone-layers {backbone_layers} "
                         f"--decoder-layers {decoder_layers} --d-model {d_model}: {bad}")
    sd = {k: torch.as_tensor(state[k]).float().contiguous() for k in own}
    return _save({"state_dict": sd}, Path(out_dir) / "step_00000000.ckpt")


def revert(ckpt, out_path) -> Path:
    """A port checkpoint (a ``step_<N>.ckpt`` file, or a ``ckpt/`` directory,
    whose latest step is taken) -> a Lightning ``.ckpt`` at ``out_path``: the
    fp32 ``state_dict`` in the JAX ``save_lightning_ckpt`` envelope, with the
    checkpoint's epoch and global step."""
    ckpt = Path(ckpt)
    if ckpt.is_dir():
        step = latest_step(ckpt)
        if step is None:
            raise FileNotFoundError(f"no step_<N>.ckpt in {ckpt}")
        ckpt = step_path(ckpt, step)
    blob = torch.load(ckpt, map_location="cpu", weights_only=True)
    sd = {k: v.float().contiguous() for k, v in blob["state_dict"].items()}
    return _save({"state_dict": sd, "pytorch-lightning_version": LIGHTNING_VERSION,
                  "epoch": int(blob.get("epoch", 0)), "global_step": int(blob.get("global_step", 0)),
                  "loops": {}}, Path(out_path))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Convert a CrossScore checkpoint for the port, or back")
    ap.add_argument("ckpt", help="Lightning .ckpt file; with --hf-backbone a local HuggingFace Dinov2Model "
                                 "directory; with --reverse a port step_<N>.ckpt or a run's ckpt/ directory")
    ap.add_argument("out_dir", help="the port checkpoint directory to write; with --hf-backbone or --reverse "
                                    "the FILE to write")
    ap.add_argument("--backbone-layers", type=int, default=12)
    ap.add_argument("--decoder-layers", type=int, default=2)
    ap.add_argument("--d-model", type=int, default=384)
    ap.add_argument("--hf-backbone", action="store_true",
                    help="convert only a HF Dinov2Model backbone (for model.backbone.init_path)")
    ap.add_argument("--reverse", action="store_true",
                    help="reverse direction: a port checkpoint into a Lightning .ckpt FILE (loadable by the "
                         "reference stack)")
    ap.add_argument("--trust-pickle", action="store_true",
                    help="read a Lightning .ckpt that pickled Python objects (its hyper-parameters) in full; "
                         "unpickling can run code from the file, so only for a trusted file")
    args = ap.parse_args(argv)
    if args.reverse:
        revert(args.ckpt, args.out_dir)
        print(f"Reverted {args.ckpt} -> {args.out_dir}")
        return
    if args.hf_backbone:
        state, vit = read_hf_backbone(args.ckpt)
        _save(state, Path(args.out_dir))
        print(f"Converted {args.ckpt} ({vit.num_layers} layers, D {vit.hidden_size}) -> {args.out_dir}")
        return
    out = convert_lightning(args.ckpt, args.out_dir, args.backbone_layers, args.decoder_layers, args.d_model,
                            args.trust_pickle)
    print(f"Converted {args.ckpt} -> {out}")


if __name__ == "__main__":
    main()
