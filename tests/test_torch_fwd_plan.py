"""What the port's Python decides before the bf16 attention forward (K1, K3,
K5-K7, K11, K7') launches: which operands its TMA tensor maps can read in
place (``tma_strides``). At every head dim the wrappers take (16-128 in steps
of 16) the forward's three geometries map: K1's (and K5's, K11's) q, k and v
sections of the fused (B, N, 3*H*hd) projection at column offsets 0, D and
2D; K3's (and K6's) token-major q/k/v; K7's contiguous tensors and head-major
views of token-major projections. K7 reads strided views, and a layout that
TMA cannot take is refused there with a ValueError before any launch, or
copied by ``_kernel_rows``; K1 and K3 take only contiguous 16-byte aligned
operands, which ``check_cuda_operands`` enforces."""

import pytest
import torch

from crossscore_tpu_torch.ops import flash_attention as fa

HDS = range(16, 129, 16)
B, H, N = 2, 3, 37


def _strides(t):
    return fa.tma_strides(tuple(t.shape), t.stride(), t.element_size(), t.data_ptr())


@pytest.mark.parametrize("hd", HDS)
def test_k1_sections_of_the_fused_projection_map_in_place(hd):
    d = H * hd
    qkv = torch.zeros(B, N, 3 * d, dtype=torch.bfloat16)
    views = fa.qkv_head_views(qkv, H)
    for i, t in enumerate(views):  # q, k, v at column offsets 0, D and 2D
        assert t.shape == (B, H, N, hd)
        assert t.data_ptr() - qkv.data_ptr() == i * d * qkv.element_size()
        assert t.data_ptr() % 16 == 0
        # the strides the C entry gives its tensor maps (qkv_args): batch N*3D, head hd, row 3D
        assert _strides(t) == [N * 3 * d, hd, 3 * d]
    assert fa._tma_strides("flash_qkv_self_attention", *views) == [N * 3 * d, hd, 3 * d] * 3
    assert all(fa._kernel_rows(t) is t for t in views)


@pytest.mark.parametrize("hd", HDS)
def test_k3_token_major_operands_map_in_place(hd):
    d = H * hd
    q, k, v = (torch.zeros(B, n, d, dtype=torch.bfloat16) for n in (N, 2 * N + 1, 2 * N + 1))
    views = [fa._split_heads(t, H) for t in (q, k, v)]
    # cross_args: batch N*D, head hd (heads side by side in a row), row D
    assert fa._tma_strides("flash_cross_attention", *views) == [
        N * d, hd, d, (2 * N + 1) * d, hd, d, (2 * N + 1) * d, hd, d]


@pytest.mark.parametrize("hd", HDS)
def test_k7_contiguous_and_head_major_views_map_in_place(hd):
    x = torch.zeros(B, N, H * hd, dtype=torch.bfloat16)
    view = x.view(B, N, H, hd).transpose(1, 2)
    contiguous = view.contiguous()
    assert fa._tma_strides("flash_attention_head_major", view, contiguous) == [
        N * H * hd, hd, H * hd, H * N * hd, N * hd, hd]
    assert fa._kernel_rows(view) is view and fa._kernel_rows(contiguous) is contiguous


@pytest.mark.parametrize("why", ["odd base", "104-byte rows", "batch stride 0"])
def test_layouts_tma_cannot_take_are_refused_or_copied(why):
    ok = torch.zeros(2, 9, 3 * 48, dtype=torch.bfloat16).view(2, 9, 3, 48).transpose(1, 2)
    if why == "odd base":  # 8 bytes past a 16-byte boundary
        bad = torch.zeros(2 * 3 * 9 * 48 + 4, dtype=torch.bfloat16)[4:].view(2, 3, 9, 48)
    elif why == "104-byte rows":
        bad = torch.zeros(2, 3, 9, 52, dtype=torch.bfloat16)[..., :48]
    else:  # an expanded view
        bad = ok[:1].expand(2, -1, -1, -1)
    assert _strides(bad) is None
    with pytest.raises(ValueError, match="16-byte"):
        fa._tma_strides("flash_attention_head_major", ok, bad, ok)
    copy = fa._kernel_rows(bad)
    assert copy is not bad and copy.is_contiguous() and torch.equal(copy, bad)
    assert _strides(copy) is not None
