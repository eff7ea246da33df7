"""The widths Q2 takes on the card (``ops/quant.py::_check_q2_widths``)
against every product a preset's int8 backbone reaches.

The products are qkv, out, fc1 and fc2 of dinov2-test, -small, -base and
-large: whole, and as each rank's shard under ``attention_impl="tp"`` over 2
and 4 ranks (``parallel/tensor_parallel.py::shard_state_dict``), with the MLP
split (``unfused``) or whole (``fused``). Q2 takes K % 32 == 0 and N % 8 == 0,
the widths the ``mma.sync`` kernel before the Hopper kernel took, so every
product is accepted exactly where that rule accepts it. The shapes come from
the net itself, built on the meta device.
"""

import dataclasses
import functools

import pytest

from crossscore_tpu_torch.models import CrossScoreConfig, CrossScoreNet
from crossscore_tpu_torch.models.dinov2 import VIT_PRESETS
from crossscore_tpu_torch.ops import quant
from crossscore_tpu_torch.parallel.tensor_parallel import shard_state_dict

PRESETS = ("dinov2-test", "dinov2-small", "dinov2-base", "dinov2-large")
LAYOUTS = ((1, "unfused"), (2, "unfused"), (2, "fused"), (4, "unfused"), (4, "fused"))  # (ranks, mlp_impl)
PRODUCTS = ("qkv", "out", "fc1", "fc2")
LAYER = "backbone.encoder.layer.0."


@functools.lru_cache(maxsize=None)
def _layer_weights(preset: str) -> dict:
    cfg = dataclasses.replace(CrossScoreConfig(), backbone=VIT_PRESETS[preset])
    sd = CrossScoreNet(cfg, device="meta").state_dict()
    return {k: v for k, v in sd.items() if k.startswith(LAYER) and k.endswith(".weight")}


def _products(preset: str, ranks: int, mlp_impl: str) -> dict:
    """(K, N) of each int8 product of one backbone layer on one rank."""
    sd = shard_state_dict(_layer_weights(preset), 0, ranks, mlp_impl)
    q = sd[LAYER + "attention.attention.query.weight"]  # q, k and v: one product over their rows
    out = sd[LAYER + "attention.output.dense.weight"]
    fc1, fc2 = sd[LAYER + "mlp.fc1.weight"], sd[LAYER + "mlp.fc2.weight"]
    return {"qkv": (q.shape[1], 3 * q.shape[0]), "out": (out.shape[1], out.shape[0]),
            "fc1": (fc1.shape[1], fc1.shape[0]), "fc2": (fc2.shape[1], fc2.shape[0])}


@pytest.mark.parametrize("product", PRODUCTS)
@pytest.mark.parametrize("ranks,mlp_impl", LAYOUTS)
@pytest.mark.parametrize("preset", PRESETS)
def test_q2_takes_every_preset_product(preset, ranks, mlp_impl, product):
    k, n = _products(preset, ranks, mlp_impl)[product]
    d = VIT_PRESETS[preset].hidden_size
    whole = {"qkv": (d, 3 * d), "out": (d, d), "fc1": (d, 4 * d), "fc2": (4 * d, d)}[product]
    split = ranks > 1 and (product in ("qkv", "out") or mlp_impl == "unfused")
    # column products split N, row products K; with the MLP whole fc1 and fc2 stay whole
    assert (k, n) == ((whole[0] // ranks, whole[1]) if split and product in ("out", "fc2")
                      else (whole[0], whole[1] // ranks) if split else whole)
    if k % 32 == 0 and n % 8 == 0:
        quant._check_q2_widths("int8_linear", k, n)
        quant._check_q2_widths("int8_matmul_s32", k, n)
    else:
        for what in ("int8_linear", "int8_matmul_s32"):
            with pytest.raises(ValueError, match="K % 32 == 0 and N % 8 == 0"):
                quant._check_q2_widths(what, k, n)
