"""What the port's Python decides before the bf16 attention backward (K4,
K8, K9) launches: which operands its TMA tensor maps can read in place
(``tma_strides``). Every head dim the wrappers take (16-128 in steps of 16)
maps, contiguous and as a head-major view of a token-major projection; an
alignment, a stride or a layout that TMA cannot take is refused with a
ValueError before any launch, and the autograd backward copies such an
incoming gradient instead (``_kernel_rows``)."""

import pytest
import torch

from crossscore_tpu_torch.ops import flash_attention as fa

HDS = range(16, 129, 16)


def _strides(t):
    return fa.tma_strides(tuple(t.shape), t.stride(), t.element_size(), t.data_ptr())


@pytest.mark.parametrize("hd", HDS)
def test_every_head_dim_maps_contiguous_and_as_views(hd):
    b, h, n = 2, 3, 37
    x = torch.zeros(b, n, h * hd, dtype=torch.bfloat16)  # token-major, as the projections give it
    view = x.view(b, n, h, hd).transpose(1, 2)
    assert _strides(view) == [n * h * hd, hd, h * hd]
    assert _strides(view.contiguous()) == [h * n * hd, n * hd, hd]
    assert fa._tma_strides("t", view, view.contiguous()) == [n * h * hd, hd, h * hd, h * n * hd, n * hd, hd]
    assert fa._kernel_rows(view) is view


@pytest.mark.parametrize("hd", [16, 48, 128])
def test_an_axis_of_length_one_is_never_stepped_over(hd):
    # a single batch item, head or row may carry any stride: it is reported as a contiguous one
    assert fa.tma_strides((1, 1, 1, hd), (7, 5, 3, 1), 2, 0) == [hd, hd, hd]
    assert fa.tma_strides((1, 2, 5, hd), (3, 5 * hd, hd, 1), 2, 64) == [10 * hd, 5 * hd, hd]


@pytest.mark.parametrize("shape,strides,ptr,why", [
    ((2, 2, 8, 48), (768, 384, 48, 1), 8, "base off a 16-byte boundary"),
    ((2, 2, 8, 48), (768, 384, 52, 1), 0, "row stride of 104 bytes"),
    ((2, 2, 8, 48), (768, 388, 48, 1), 0, "head stride of 776 bytes"),
    ((2, 2, 8, 48), (0, 384, 48, 1), 0, "batch stride 0 (an expanded view)"),
    ((2, 2, 8, 48), (1 << 39, 384, 48, 1), 0, "batch stride of 2**40 bytes"),
    ((2, 2, 8, 48), (768, 384, 1, 8), 0, "hd not contiguous"),
    ((2, 2, 8), (16, 8, 1), 0, "three axes"),
    ((2, 0, 8, 48), (768, 384, 48, 1), 0, "an empty axis"),
])
def test_layouts_tma_cannot_take_are_refused(shape, strides, ptr, why):
    assert fa.tma_strides(shape, strides, 2, ptr) is None, why


def test_the_launch_check_raises_before_any_launch():
    x = torch.zeros(2, 9, 3 * 48, dtype=torch.bfloat16)
    ok = x.view(2, 9, 3, 48).transpose(1, 2)
    expanded = ok[:1].expand(2, -1, -1, -1)  # batch stride 0
    odd_rows = torch.zeros(2, 3, 9, 52, dtype=torch.bfloat16)[..., :48]  # rows of 104 bytes
    for bad in (expanded, odd_rows):
        with pytest.raises(ValueError, match="16-byte"):
            fa._tma_strides("flash_attention_head_major_bwd", ok, bad)
        copy = fa._kernel_rows(bad)
        assert copy is not bad and copy.is_contiguous() and torch.equal(copy, bad)
