"""``tools/matmul_microbench.py --against``, the A/B of two builds of the
int8 kernels, off the card: it needs one and says so, its options go
together as documented, and it binds the other build's library for a block
and puts this tree's back. And the step profile's layer group of Q2 and its
int32 form under the kernel's names as the profiler gives them."""

import importlib.util
from pathlib import Path

import pytest
import torch

from crossscore_tpu_torch.ops import _build
from crossscore_tpu_torch.tools import matmul_microbench

ROOT = Path(__file__).resolve().parent.parent


def test_without_a_card_it_exits_1(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the tool would run on it")
    assert matmul_microbench.main(["--against", str(ROOT)]) == 1
    assert "no CUDA device" in capsys.readouterr().err


@pytest.mark.parametrize("argv", [["--against", str(ROOT), "--cpu"], ["--products-only"]])
def test_options_that_do_not_go_together(argv):
    with pytest.raises(SystemExit) as e:
        matmul_microbench.main(argv)
    assert e.value.code == 2


def test_bound_swaps_the_library_for_the_block_only():
    saved = _build._libs.get(matmul_microbench.SOURCE)
    other = object()
    with matmul_microbench.bound(other):
        assert _build._libs[matmul_microbench.SOURCE] is other
    assert _build._libs.get(matmul_microbench.SOURCE) is saved


def test_in_turns_binds_each_build_in_order():
    libs = {"other": object(), "this": object()}
    seen = []
    out = matmul_microbench.in_turns(libs, lambda: seen.append(_build._libs[matmul_microbench.SOURCE]) or len(seen))
    assert seen == [libs[t] for t in matmul_microbench.TURNS]
    assert out == {"other": [1, 4], "this": [2, 3]}


@pytest.mark.parametrize("name", [
    "void (anonymous namespace)::int8_linear_kernel<__nv_bfloat16, 3>(CUtensorMap_st, CUtensorMap_st, "
    "CUtensorMap_st, float const*, float const*, __nv_bfloat16 const*, int, int, int)",
    "_ZN47_GLOBAL__N__b3ac4818_14_int8_linear_cu_4f29afe418int8_linear_kernelIiLi0EEEv14CUtensorMap_stS1_S1_"
    "PKfS3_PKT_iii"])
def test_step_profile_groups_the_hopper_q2(name):
    spec = importlib.util.spec_from_file_location("torch_step_profile", ROOT / "tools" / "torch_step_profile.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    assert tool._group(name) == "Q2 int8 linear"
