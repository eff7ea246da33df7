"""CrossScoreNet; counterpart of ``crossscore_tpu/models/crossscore.py``.

1. query (B, H, W, 3) + references (B, K, H, W, 3), ImageNet-normalised (or
   raw uint8, normalised here in fp32), or the references' cached backbone
   tokens (``ref_tokens``, from :func:`make_backbone_encoder`), or both sides
   as tokens (``query_tokens`` + ``ref_tokens``: the decoder-only graph of
   token-space training, ``data/token_train.py``)
2. all B*(1+K) images (or the B queries alone) through the frozen DINOv2
   encoder in one batch, under ``torch.no_grad()``; CLS stripped (skipped by
   the decoder-only graph)
3. the multi-view PE added to query and reference tokens (trainable only
   with ``pe_trainable``)
4. the 2-layer cross-reference decoder
5. head Linear -> LeakyReLU -> Linear -> regression activation
6. jigsaw reassembly -> (B, H, W) score map

Shape-bucketed inference (``valid_hw``): the images are padded right and
bottom to a bucket shape; the encoder, the PE and the decoder mask the tokens
of padded patches (K5 and K6 on the flash route), so the valid region of the
score map equals an unpadded run's.

Parameter names are the reference Lightning state-dict keys without the
``model.`` prefix (``backbone.*``, ``pos_enc_fn.PE``, ``ref_cross.attn.*``,
``ref_cross.head.{0,2}.*``, ``img_mean_std``), so a reference checkpoint loads
through ``crossscore_tpu_torch.io.convert.load_into``.

Trainable parameters, as the JAX ``trainable_mask`` (reference
``task/core.py:41-42,494``): the decoder and the head; the backbone never;
the PE only with ``pe_trainable`` (``model.pos_enc.multi_view.req_grad``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from crossscore_tpu_torch.device import resolve_device
from crossscore_tpu_torch.models.decoder import CrossReferenceDecoder
from crossscore_tpu_torch.models.dinov2 import (
    ATTENTION_IMPLS, MLP_IMPLS, VIT_PRESETS, Dinov2Encoder, ViTConfig, linear, token_bias, tp_ranks,
)
from crossscore_tpu_torch.models.positional import MultiViewPositionalEmbedding
from crossscore_tpu_torch.models.regression import regression_activation
from crossscore_tpu_torch.ops.jigsaw import jigsaw_to_image
from crossscore_tpu_torch.parallel.mesh import model_group, view_group
from crossscore_tpu_torch.parallel.tensor_parallel import check_divisible, column_linear, row_linear

# the port's copy of crossscore_tpu/io/images.py's constants
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def _normalize_u8(img: torch.Tensor) -> torch.Tensor:
    """Raw uint8 pixels -> ImageNet-normalised float32: x*(1/255), then
    (x-mean)/std, all in fp32 (the host normalise of native/fastimage.cpp)."""
    mean = torch.from_numpy(IMAGENET_MEAN).to(img.device)
    std = torch.from_numpy(IMAGENET_STD).to(img.device)
    return (img.float() * np.float32(1.0 / 255.0) - mean) / std


@dataclasses.dataclass(frozen=True)
class CrossScoreConfig:
    """Mirrors the JAX ``CrossScoreConfig``. ``attention_impl`` is ``"flash"``
    (K1/K3, JAX's ``pallas``), ``"dense"`` (JAX's ``xla``), ``"cp"`` (JAX's
    ``cp:<axis>``: the decoder cross-attention through the context-parallel
    op over the view group, K7 and K8/K9; the rest as ``"flash"``) or
    ``"tp"`` (JAX's ``tp:<axis>``: heads, MLP features and the head's hidden
    features sharded over the model group, ``parallel.tensor_parallel``;
    every attention on K7, the decoder's backward on K8/K9); ``mlp_impl`` is
    ``"fused"``, ``"fused_exact"`` (K2) or ``"unfused"``. ``parity=True`` is
    the JAX ``model.tpu.parity`` rule: fp32 compute, exact GELU in K2.
    ``pe_trainable`` is ``model.pos_enc.multi_view.req_grad``."""

    backbone: ViTConfig = VIT_PRESETS["dinov2-small"]
    patch_size: int = 14
    pe_h: int = 40
    pe_w: int = 40
    decoder_layers: int = 2
    decoder_heads: int = 8
    decoder_ffn_ratio: int = 1
    do_self_attn: bool = True
    do_short_cut: bool = True
    do_reference_cross: bool = True
    metric_type: str = "ssim"
    metric_min: int = 0
    metric_max: int = 1
    power_factor: Any = "default"
    compute_dtype: torch.dtype = torch.bfloat16
    attention_impl: str = "flash"
    mlp_impl: str = "fused"
    parity: bool = False
    pe_trainable: bool = False

    def __post_init__(self):
        if self.attention_impl not in ATTENTION_IMPLS:
            raise ValueError(f"attention_impl must be one of {ATTENTION_IMPLS}")
        if self.mlp_impl not in MLP_IMPLS:
            raise ValueError(f"mlp_impl must be one of {MLP_IMPLS}")
        if self.compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError("compute_dtype must be torch.float32 or torch.bfloat16")
        if self.parity:
            object.__setattr__(self, "compute_dtype", torch.float32)
            if self.mlp_impl == "fused":
                object.__setattr__(self, "mlp_impl", "fused_exact")

    @staticmethod
    def from_config(cfg) -> "CrossScoreConfig":
        """Build from a composed YAML config (``crossscore_tpu_torch.confsys``);
        the GPU knobs are ``model.gpu``."""
        m = cfg.model
        gpu = m.gpu
        dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32}
        if str(gpu.compute_dtype) not in dtypes:
            raise ValueError(f"model.gpu.compute_dtype must be one of {sorted(dtypes)}, "
                             f"got {gpu.compute_dtype!r}")
        return CrossScoreConfig(
            backbone=VIT_PRESETS[m.backbone.get("preset", "dinov2-small")],
            patch_size=m.patch_size,
            pe_h=m.pos_enc.multi_view.h,
            pe_w=m.pos_enc.multi_view.w,
            decoder_layers=m.decoder.num_layers,
            decoder_heads=m.decoder.num_heads,
            decoder_ffn_ratio=m.decoder.ffn_ratio,
            do_self_attn=m.decoder_do_self_attn,
            do_short_cut=m.decoder_do_short_cut,
            do_reference_cross=m.do_reference_cross,
            metric_type=m.predict.metric.type,
            metric_min=m.predict.metric.min,
            metric_max=m.predict.metric.max,
            power_factor=m.predict.metric.power_factor,
            compute_dtype=dtypes[str(gpu.compute_dtype)],
            attention_impl=str(gpu.attention_impl),
            mlp_impl=str(gpu.mlp_impl),
            parity=bool(gpu.get("parity", False)),
            pe_trainable=bool(m.pos_enc.multi_view.get("req_grad", False)),
        )


class _RefCross(nn.Module):
    def __init__(self, cfg: CrossScoreConfig, device):
        super().__init__()
        d, p = cfg.backbone.hidden_size, cfg.patch_size
        self.attn = CrossReferenceDecoder(
            d, cfg.decoder_heads, cfg.decoder_layers, cfg.decoder_ffn_ratio,
            cfg.do_self_attn, cfg.do_short_cut, cfg.attention_impl, device,
        )
        # under "tp" the first linear is column-, the second row-parallel
        d_local = check_divisible("head features", d, tp_ranks(cfg.attention_impl))
        self.head = nn.Sequential(
            nn.Linear(d, d_local, device=device), nn.LeakyReLU(), nn.Linear(d_local, p * p, device=device)
        )


class CrossScoreNet(nn.Module):
    def __init__(self, cfg: CrossScoreConfig = CrossScoreConfig(), device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        d = cfg.backbone.hidden_size
        self.register_buffer(
            "img_mean_std",
            torch.from_numpy(np.concatenate([IMAGENET_MEAN, IMAGENET_STD])).to(device),
        )
        # "cp" shards only the decoder's cross-attention; each rank's views
        # are whole, so the backbone runs its local kernels ("tp" shards the
        # backbone's heads too)
        backbone_impl = "flash" if cfg.attention_impl == "cp" else cfg.attention_impl
        self.backbone = Dinov2Encoder(cfg.backbone, cfg.compute_dtype, backbone_impl,
                                      cfg.mlp_impl, device)
        self.pos_enc_fn = MultiViewPositionalEmbedding(cfg.pe_h, cfg.pe_w, d, device)
        self.ref_cross = _RefCross(cfg, device)
        self.backbone.requires_grad_(False)
        self.pos_enc_fn.requires_grad_(cfg.pe_trainable)

    def forward(self, query_img: torch.Tensor, ref_imgs, need_attn_weights: bool = False,
                need_attn_weights_head_id: int = 0, norm_img: bool = False, valid_hw=None,
                ref_tokens=None, ref_grid=None, query_tokens=None, token_grid=None) -> dict:
        """query_img (B, H, W, 3), ref_imgs (B, K, H, W, 3) or None ->
        {"score_map_ref_cross": (B, H, W) fp32[, "attn_weights_map_ref_cross":
        (B, gh, gw, K, gh_r, gw_r)]}.

        :param valid_hw: the true (h, w) pixel extents of bucket-padded
            images, from the host loader: (2,) shared by the batch or (B, 2)
            per item (each item's K references share its extent). Numpy or
            Python ints; a device tensor is refused rather than synchronised.
        :param ref_tokens: (B, K, N_r, D) cached reference tokens in place of
            ``ref_imgs``; only the queries are encoded.
        :param ref_grid: the (gh_r, gw_r) patch grid of ``ref_tokens`` when it
            differs from the query's (only with ``ref_tokens``, not with
            ``valid_hw``).
        :param query_tokens: (B, N, D) backbone tokens of the queries with
            ``query_img=None``: the decoder-only graph. Needs ``ref_tokens``
            and ``token_grid``; the backbone does not run, and the query
            tokens take no gradient.
        :param token_grid: the (gh, gw) patch grid of ``query_tokens`` (the
            score map is (B, gh*patch, gw*patch)).
        """
        c = self.cfg
        if query_tokens is not None:
            if ref_tokens is None or token_grid is None:
                raise ValueError("query_tokens (the decoder-only graph) requires ref_tokens "
                                 "and a token_grid=(gh, gw)")
            if query_img is not None:
                raise ValueError("pass query_img or query_tokens, not both")
            if norm_img:
                raise ValueError("norm_img is pixel-space; tokens are post-encode")
            if valid_hw is not None:
                raise ValueError("bucket masking (valid_hw) is pixel-space; token inputs must be "
                                 "pre-sliced to their valid grid instead")
            if token_grid[0] * token_grid[1] != query_tokens.shape[1]:
                raise ValueError(f"query_tokens carry {query_tokens.shape[1]} patches but "
                                 f"token_grid is {tuple(token_grid)}")
        elif token_grid is not None:
            raise ValueError("token_grid is only meaningful with query_tokens")
        for name, img in (("query_img", query_img), ("ref_imgs", ref_imgs), ("ref_tokens", ref_tokens),
                          ("query_tokens", query_tokens)):
            if img is not None and img.device != self.img_mean_std.device:
                raise ValueError(f"{name} is on {img.device}, the model on {self.img_mean_std.device}")
        if ref_tokens is not None and ref_imgs is not None:
            raise ValueError("pass ref_imgs or ref_tokens, not both")
        if query_tokens is not None:
            gh, gw = token_grid
            # the decoder-only graph: the tokens are constants of the frozen
            # backbone, so the query side takes no gradient
            q_tok = query_tokens.to(c.compute_dtype).detach()
            if not (c.do_reference_cross and ref_tokens.shape[1] > 0):
                return {}
            self._check_ref_grid(ref_tokens, gh, gw)
            return self._decode(q_tok, ref_tokens.to(c.compute_dtype), gh, gw, gh, gw,
                                need_attn_weights, need_attn_weights_head_id)
        if query_img.dtype == torch.uint8 or (ref_imgs is not None and ref_imgs.dtype == torch.uint8):
            if norm_img:
                raise ValueError("norm_img expects [0,1] float pixels, got uint8")
            query_img = _normalize_u8(query_img) if query_img.dtype == torch.uint8 else query_img
            if ref_imgs is not None and ref_imgs.dtype == torch.uint8:
                ref_imgs = _normalize_u8(ref_imgs)
        if norm_img:
            # the reference divides by the mean on this (unused) path; like the
            # JAX package, normalise correctly
            mean = torch.from_numpy(IMAGENET_MEAN).to(query_img.device, query_img.dtype)
            std = torch.from_numpy(IMAGENET_STD).to(query_img.device, query_img.dtype)
            query_img = (query_img - mean) / std
            if ref_imgs is not None:
                ref_imgs = (ref_imgs - mean) / std

        b, hgt, wdt, _ = query_img.shape
        p = c.patch_size
        gh, gw = hgt // p, wdt // p
        n_patch = gh * gw
        d = c.backbone.hidden_size
        if ref_tokens is not None:
            k_ref = ref_tokens.shape[1]
            all_imgs = query_img  # only the queries need encoding
        else:
            k_ref = 0 if ref_imgs is None else ref_imgs.shape[1]
            all_imgs = query_img if ref_imgs is None else torch.cat(
                [query_img, ref_imgs.reshape(b * k_ref, hgt, wdt, 3).to(query_img.dtype)]
            )

        valid_grid = enc_valid_grid = tok_bias = None
        per_item = False
        if valid_hw is not None:
            vhw = np.asarray(valid_hw)
            per_item = vhw.ndim == 2
            if vhw.shape not in ((2,), (b, 2)):
                raise ValueError(f"valid_hw must be (2,) or ({b}, 2), got {vhw.shape}")
            valid_grid = (vhw[..., 0] // p, vhw[..., 1] // p)
            enc_valid_grid = valid_grid
            if per_item and ref_tokens is None and k_ref:
                # encoder order: B queries, then each item's K refs in turn
                enc_valid_grid = tuple(np.concatenate([g, np.repeat(g, k_ref)]) for g in valid_grid)
            tok_bias = token_bias(gh, gw, valid_grid)

        with torch.no_grad():  # frozen backbone
            tokens = self.backbone(all_imgs, enc_valid_grid)[:, 1:]
        if not (c.do_reference_cross and k_ref > 0):
            return {}

        if ref_grid is not None and ref_tokens is None:
            raise ValueError("ref_grid is only meaningful with ref_tokens")
        gh_r, gw_r = ref_grid if ref_grid is not None else (gh, gw)
        r_tok = tokens[b:].reshape(b, k_ref, n_patch, d) if ref_tokens is None \
            else ref_tokens.to(c.compute_dtype)
        self._check_ref_grid(r_tok, gh_r, gw_r)
        if (gh_r, gw_r) != (gh, gw) and valid_hw is not None:
            raise ValueError("shape-bucketed inference (valid_hw) needs the query and reference "
                             "grids to match: the bucket masks assume one grid per item")
        return self._decode(tokens[:b], r_tok, gh, gw, gh_r, gw_r, need_attn_weights,
                            need_attn_weights_head_id, valid_grid, tok_bias, per_item)

    @staticmethod
    def _check_ref_grid(r_tok: torch.Tensor, gh_r: int, gw_r: int) -> None:
        if gh_r * gw_r != r_tok.shape[2]:
            raise ValueError(f"ref_tokens carry {r_tok.shape[2]} patches per view but the reference "
                             f"grid is {(gh_r, gw_r)}")

    def _decode(self, q_tok, r_tok, gh, gw, gh_r, gw_r, need_attn_weights, need_attn_weights_head_id,
                valid_grid=None, tok_bias=None, per_item=False) -> dict:
        """The PE, the decoder, the head and the jigsaw on (B, gh*gw, D) query
        and (B, K, gh_r*gw_r, D) reference tokens in the compute dtype."""
        c = self.cfg
        d = c.backbone.hidden_size
        p = c.patch_size
        n_patch = gh * gw
        b, k_ref, n_patch_r = r_tok.shape[:3]
        results: dict = {}
        feat_query = self.pos_enc_fn(q_tok, 1, gh, gw, valid_grid)
        # view parallelism: the PE meets only this rank's reference views on
        # the reference side, so that share of its gradient is summed over
        # the view group (the query side's is whole on every rank)
        pe_group = view_group() if c.attention_impl == "cp" and c.pe_trainable and torch.is_grad_enabled() \
            else None
        feat_ref = self.pos_enc_fn(r_tok.reshape(b, k_ref * n_patch_r, d), k_ref, gh_r, gw_r,
                                   valid_grid, grad_group=pe_group)
        self_bias = cross_bias = None
        if tok_bias is not None:
            # the same mask for every view: each item's refs share its extent
            cross = np.tile(tok_bias, (1, k_ref) if per_item else k_ref)
            self_bias, cross_bias = (torch.from_numpy(t).to(q_tok.device) for t in (tok_bias, cross))
        decoded, weights = self.ref_cross.attn(
            feat_query, feat_ref, need_weights=need_attn_weights,
            need_weights_head_id=need_attn_weights_head_id, self_bias=self_bias,
            cross_bias=cross_bias,
        )
        head = self.ref_cross.head
        if c.attention_impl == "tp":
            group = model_group()
            y = column_linear(decoded, head[0].weight, head[0].bias, group)
            y = row_linear(F.leaky_relu(y, 0.01), head[2].weight, head[2].bias, group)
        else:
            y = linear(F.leaky_relu(linear(decoded, head[0]), 0.01), head[2])
        act = regression_activation(c.metric_type, c.metric_min, c.metric_max, c.power_factor)
        # jigsaw in the compute dtype, then the activation in fp32 (as JAX)
        score_map = jigsaw_to_image(y.reshape(b, n_patch, p, p), (gh, gw))
        results["score_map_ref_cross"] = act(score_map.float())
        if need_attn_weights and weights is not None:
            results["attn_weights_map_ref_cross"] = weights.reshape(b, gh, gw, k_ref, gh_r, gw_r)
        return results


def make_backbone_encoder(cfg: CrossScoreConfig):
    """Returns ``encode(model, imgs, valid_hw=None) -> (B, N_patch, D)``,
    running only the frozen backbone of ``model`` (CLS stripped) with the
    same knobs as the full net: the producer side of the cached-reference
    path (the consumer is ``CrossScoreNet(..., ref_tokens=...)``).

    ``valid_hw`` (B, 2): the true pixel extents of bucket-padded images; the
    tokens of padded patches are masked out of the encoder's attention and get
    no position embedding, so the valid tokens equal an unpadded encode."""
    p = cfg.patch_size

    def encode(model: CrossScoreNet, imgs: torch.Tensor, valid_hw=None) -> torch.Tensor:
        if imgs.dtype == torch.uint8:
            imgs = _normalize_u8(imgs)
        valid_grid = None
        if valid_hw is not None:
            vhw = np.asarray(valid_hw)
            valid_grid = (vhw[:, 0] // p, vhw[:, 1] // p)
        with torch.no_grad():
            return model.backbone(imgs, valid_grid)[:, 1:]

    return encode
