"""DINOv2-style ViT patch encoder; counterpart of ``crossscore_tpu/models/dinov2.py``.

Parameter names follow HuggingFace ``Dinov2Model`` (the reference checkpoint's
``model.backbone.*`` keys): patch-embed conv, CLS token, learned position
table with bicubic resize off its native grid, pre-LN blocks with LayerScale,
exact-GELU MLP, final LayerNorm. Parameters stay fp32; each forward casts them
to the compute dtype, with LayerNorm statistics in fp32 (as the JAX package).

``attention_impl="flash"`` runs the attention core through K1
(:func:`flash_qkv_self_attention`), or through K5
(:func:`flash_qkv_self_attention_masked`) when the encoder masks the tokens of
bucket-padded patches; ``mlp_impl="fused"``/``"fused_exact"`` runs the LN->MLP
half through K2 (:func:`fused_ln_mlp`). ``"dense"`` and ``"unfused"`` are the
plain routes, for tests and whole-net comparisons.

``attention_impl="tp"`` (tensor parallelism, JAX's ``tp:<axis>``) shards the
heads over the registered model group (``parallel.mesh.make_groups``): each
rank projects its heads' q, k and v, runs K7 (:func:`flash_attention_head_major`)
on their head-major views, and sums its share of the output projection over
the group (``parallel.tensor_parallel``). Forward only: the backbone is
frozen. The MLP under ``tp`` is K2 on the whole fc1/fc2 weights on every rank
(``fused``/``fused_exact``), or column-/row-parallel (``unfused``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from crossscore_tpu_torch.ops.attention import dense_attention
from crossscore_tpu_torch.ops.flash_attention import (
    _merge_heads, _split_heads, flash_attention_head_major, flash_qkv_self_attention,
    flash_qkv_self_attention_masked,
)
from crossscore_tpu_torch.ops.fused_mlp import fused_ln_mlp
from crossscore_tpu_torch.ops.interpolate import interpolate_bicubic, interpolate_bicubic_dyn
from crossscore_tpu_torch.parallel.mesh import model_group
from crossscore_tpu_torch.parallel.tensor_parallel import check_divisible, column_linear, row_linear

# additive logits bias of a masked token: -1e30, not -inf or -fmax, since the
# kernels scale biases by log2(e), which must stay finite in fp32
MASKED = -1e30


def token_bias(gh: int, gw: int, valid_grid, cls: bool = False) -> np.ndarray:
    """fp32 bias over a (gh, gw) patch grid: 0 inside the valid (gh_v, gw_v)
    top-left region, :data:`MASKED` outside. Host ints give one (N,) row; (B,)
    arrays give (B, N). ``cls`` prepends an always-valid CLS column."""
    vh, vw = (np.asarray(v) for v in valid_grid)
    valid = (np.arange(gh)[:, None] < vh[..., None, None]) & (np.arange(gw)[None, :] < vw[..., None, None])
    valid = valid.reshape(*vh.shape, gh * gw)
    if cls:
        valid = np.concatenate([np.ones((*vh.shape, 1), bool), valid], axis=-1)
    return np.where(valid, 0.0, MASKED).astype(np.float32)

# "tp": heads sharded over the model group (tensor parallelism)
BACKBONE_IMPLS = ("flash", "dense", "tp")
# "cp": the decoder's cross-attention over a KV axis sharded across the view
# group (view parallelism); the backbone then runs "flash"
ATTENTION_IMPLS = (*BACKBONE_IMPLS, "cp")
MLP_IMPLS = ("fused", "fused_exact", "unfused")


def tp_ranks(attention_impl: str) -> int:
    """The number of ranks that shard the heads: the registered model
    group's size under ``"tp"`` (raising when none is), else 1."""
    return dist.get_world_size(model_group()) if attention_impl == "tp" else 1


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    hidden_size: int = 384
    num_layers: int = 12
    num_heads: int = 6
    mlp_ratio: int = 4
    patch_size: int = 14
    layerscale_init: float = 1.0
    layer_norm_eps: float = 1e-6
    image_size: int = 518  # native pos-emb grid = image_size // patch_size


VIT_PRESETS: dict[str, ViTConfig] = {
    "dinov2-small": ViTConfig(hidden_size=384, num_layers=12, num_heads=6),
    "dinov2-base": ViTConfig(hidden_size=768, num_layers=12, num_heads=12),
    "dinov2-large": ViTConfig(hidden_size=1024, num_layers=24, num_heads=16),
    # tiny preset for CI / smoke runs
    "dinov2-test": ViTConfig(hidden_size=64, num_layers=2, num_heads=4, image_size=56),
}


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm in fp32 (statistics, scale and shift) whatever the compute
    dtype, rounded once to x's dtype."""
    return F.layer_norm(x.float(), (x.shape[-1],), weight.float(), bias.float(), eps).to(x.dtype)


def linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """``layer`` applied in x's dtype (fp32 parameters cast at use)."""
    return F.linear(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype))


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, self.eps)


class _QKV(nn.Module):
    def __init__(self, d: int, d_local: int, device):
        super().__init__()
        self.query = nn.Linear(d, d_local, device=device)
        self.key = nn.Linear(d, d_local, device=device)
        self.value = nn.Linear(d, d_local, device=device)


class _Output(nn.Module):
    def __init__(self, d: int, d_local: int, device):
        super().__init__()
        self.dense = nn.Linear(d_local, d, device=device)


class ViTAttention(nn.Module):
    """Multi-head self-attention through one fused (D, 3D) projection."""

    def __init__(self, cfg: ViTConfig, attention_impl: str = "flash", device=None):
        super().__init__()
        if attention_impl not in BACKBONE_IMPLS:
            raise ValueError(f"attention_impl must be one of {BACKBONE_IMPLS}, got {attention_impl!r}")
        mp = tp_ranks(attention_impl)
        self.num_heads = check_divisible("heads", cfg.num_heads, mp)  # this rank's heads
        self.attention_impl = attention_impl
        d_local = cfg.hidden_size // mp
        self.attention = _QKV(cfg.hidden_size, d_local, device)
        self.output = _Output(cfg.hidden_size, d_local, device)

    def forward(self, x, kv_bias=None):
        """``kv_bias``: None, or the fp32 (N,) / (B, N) token bias that masks
        bucket-padded tokens (K5 on the flash route)."""
        a = self.attention
        if self.attention_impl == "tp":
            return self._forward_tp(x, kv_bias)
        w = torch.cat([a.query.weight, a.key.weight, a.value.weight]).to(x.dtype)
        bias = torch.cat([a.query.bias, a.key.bias, a.value.bias]).to(x.dtype)
        qkv = F.linear(x, w, bias)  # (B, N, 3D)
        if self.attention_impl == "flash" and kv_bias is None:
            out, _, _ = flash_qkv_self_attention(qkv, self.num_heads)
        elif self.attention_impl == "flash":
            out, _, _ = flash_qkv_self_attention_masked(qkv, kv_bias, self.num_heads)
        else:
            q, k, v = (_split_heads(t, self.num_heads) for t in qkv.chunk(3, dim=-1))
            out = _merge_heads(dense_attention(q, k, v, kv_bias=kv_bias))
        return linear(out, self.output.dense)

    def _forward_tp(self, x, kv_bias):
        """This rank's heads on K7, then the row-parallel output projection
        summed over the model group (JAX ``tp_flash_cross_attention``)."""
        if kv_bias is not None:
            raise NotImplementedError("shape-bucketed masking under the tp attention route")
        group, a, h = model_group(), self.attention, self.num_heads
        q, k, v = (column_linear(x, lin.weight, lin.bias, group) for lin in (a.query, a.key, a.value))
        out, _, _ = flash_attention_head_major(*(_split_heads(t, h) for t in (q, k, v)))
        dense = self.output.dense
        return row_linear(_merge_heads(out), dense.weight, dense.bias, group)


class LayerScale(nn.Module):
    def __init__(self, dim: int, init: float, device):
        super().__init__()
        self.lambda1 = nn.Parameter(torch.full((dim,), float(init), device=device))


class _MLP(nn.Module):
    def __init__(self, d: int, f: int, device):
        super().__init__()
        self.fc1 = nn.Linear(d, f, device=device)
        self.fc2 = nn.Linear(f, d, device=device)


class ViTBlock(nn.Module):
    def __init__(self, cfg: ViTConfig, attention_impl: str = "flash", mlp_impl: str = "fused",
                 device=None):
        super().__init__()
        if mlp_impl not in MLP_IMPLS:
            raise ValueError(f"mlp_impl must be one of {MLP_IMPLS}, got {mlp_impl!r}")
        d = cfg.hidden_size
        self.eps = cfg.layer_norm_eps
        self.mlp_impl = mlp_impl
        # under tp the unfused MLP is column-/row-parallel; K2 takes whole weights
        self.tp = attention_impl == "tp" and mlp_impl == "unfused"
        f = cfg.mlp_ratio * d
        self.norm1 = LayerNorm(d, self.eps, device)
        self.attention = ViTAttention(cfg, attention_impl, device)
        self.layer_scale1 = LayerScale(d, cfg.layerscale_init, device)
        self.norm2 = LayerNorm(d, self.eps, device)
        self.mlp = _MLP(d, check_divisible("MLP features", f, tp_ranks(attention_impl)) if self.tp else f, device)
        self.layer_scale2 = LayerScale(d, cfg.layerscale_init, device)

    def forward(self, x, kv_bias=None):
        y = self.attention(self.norm1(x), kv_bias)
        x = x + y * self.layer_scale1.lambda1.to(x.dtype)
        if self.mlp_impl != "unfused":
            n2, m = self.norm2, self.mlp
            gelu = "exact" if self.mlp_impl == "fused_exact" else "tanh"
            return fused_ln_mlp(x, n2.weight, n2.bias, m.fc1.weight, m.fc1.bias, m.fc2.weight,
                                m.fc2.bias, self.layer_scale2.lambda1, self.eps, gelu)
        if self.tp:
            fc1, fc2, group = self.mlp.fc1, self.mlp.fc2, model_group()
            y = column_linear(self.norm2(x), fc1.weight, fc1.bias, group)
            y = row_linear(F.gelu(y, approximate="none"), fc2.weight, fc2.bias, group)
        else:
            y = linear(self.norm2(x), self.mlp.fc1)
            y = linear(F.gelu(y, approximate="none"), self.mlp.fc2)
        return x + y * self.layer_scale2.lambda1.to(x.dtype)


class _PatchEmbeddings(nn.Module):
    def __init__(self, d: int, p: int, device):
        super().__init__()
        self.projection = nn.Conv2d(3, d, p, stride=p, device=device)


class _Embeddings(nn.Module):
    def __init__(self, cfg: ViTConfig, device):
        super().__init__()
        d = cfg.hidden_size
        native = cfg.image_size // cfg.patch_size
        self.patch_embeddings = _PatchEmbeddings(d, cfg.patch_size, device)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d, device=device))
        # HF's masked-image-modelling token: never used at inference, kept so
        # that reference checkpoints load under strict=True
        self.mask_token = nn.Parameter(torch.zeros(1, d, device=device))
        self.position_embeddings = nn.Parameter(torch.zeros(1, 1 + native * native, d, device=device))


class _Encoder(nn.Module):
    def __init__(self, cfg: ViTConfig, attention_impl: str, mlp_impl: str, device):
        super().__init__()
        self.layer = nn.ModuleList(
            ViTBlock(cfg, attention_impl, mlp_impl, device) for _ in range(cfg.num_layers)
        )


class Dinov2Encoder(nn.Module):
    """Frozen DINOv2-style backbone: (B, H, W, 3) -> (B, 1+N, D) tokens (token 0 is CLS)."""

    def __init__(self, cfg: ViTConfig, dtype: torch.dtype = torch.float32,
                 attention_impl: str = "flash", mlp_impl: str = "fused", device=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.embeddings = _Embeddings(cfg, device)
        self.encoder = _Encoder(cfg, attention_impl, mlp_impl, device)
        self.layernorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, device)

    def forward(self, images: torch.Tensor, valid_grid=None) -> torch.Tensor:
        """``valid_grid`` (shape-bucketed inference): the valid (gh_v, gw_v)
        patch grid of bucket-padded images, host ints shared by the batch or
        (B,) arrays per image. Position embeddings are resized to the valid
        grid, and the tokens of padded patches are masked out of every
        self-attention: their residual stream holds garbage that cannot reach
        a valid token."""
        c, dt, e = self.cfg, self.dtype, self.embeddings
        b, hgt, wdt, _ = images.shape
        p, d = c.patch_size, c.hidden_size
        gh, gw = hgt // p, wdt // p
        n = gh * gw
        native = c.image_size // p

        # patch embedding as one matmul over (p_h, p_w, c)-flattened patches
        # (a stride-p VALID conv; floor semantics for non-multiple sizes)
        x = images[:, : gh * p, : gw * p].to(dt)
        x = x.reshape(b, gh, p, gw, p, 3).permute(0, 1, 3, 2, 4, 5).reshape(b, n, p * p * 3)
        conv = e.patch_embeddings.projection
        w = conv.weight.permute(0, 2, 3, 1).reshape(d, p * p * 3)
        x = F.linear(x, w.to(dt), conv.bias.to(dt))

        pos = e.position_embeddings
        grid = pos[0, 1:].reshape(native, native, d)
        kv_bias = None
        if valid_grid is not None:
            patch_pos = interpolate_bicubic_dyn(grid, gh, gw, *valid_grid).reshape(-1, n, d)
            kv_bias = torch.from_numpy(token_bias(gh, gw, valid_grid, cls=True)).to(images.device)
        elif (gh, gw) == (native, native):
            patch_pos = pos[:, 1:]
        else:
            patch_pos = interpolate_bicubic(grid, gh, gw).reshape(1, n, d)
        x = x + patch_pos.to(dt)
        cls = (e.cls_token + pos[:, :1]).to(dt)
        x = torch.cat([cls.expand(b, 1, d), x], dim=1)
        for blk in self.encoder.layer:
            x = blk(x, kv_bias)
        return self.layernorm(x)
