"""The port's microbenchmark entry points (``crossscore_tpu_torch.tools``):
each runs with ``--cpu`` (the plain versions at small shapes; the two host
benchmarks at a small size) as a subprocess and exits 0 with its timed
lines, and without ``--cpu`` on a machine with no card exits 1; the attention tool keeps the TPU tool's spec
grammar and the MLP tool its modes and ``block_m`` integers. And the step
profile's layer groups (``tools/torch_step_profile.py``) of the kernels'
names as the profiler gives them."""

import importlib.util
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from crossscore_tpu_torch.data import fastimage
from crossscore_tpu_torch.tools import (
    attn_microbench, bwd_microbench, ingest_bench, lane_pad_probe, matmul_microbench, mlp_microbench,
    token_assembly_bench,
)

ROOT = Path(__file__).resolve().parent.parent


def _run(*args):
    return subprocess.run([sys.executable, "-m", *args], cwd=ROOT, capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("args,lines", [
    (["crossscore_tpu_torch.tools.attn_microbench", "--cpu", "--layers", "2", "qkv:688,2", "qkvc:688,2,3",
      "qkvp:688,2,nomax", "qkvp:688,2,nosum", "qkvp:688,2,mxu", "v1:688,1408,2", "xln:512,1024"], 7),
    (["crossscore_tpu_torch.tools.attn_microbench", "--cpu", "--decoder", "--layers", "2", "v2:1,1024,1",
      "v2noaug:1,1024,1", "v2bf16:1,1024,1", "v2noexp:1,1024,1", "v2mxu:1,1024,1"], 5),
    (["crossscore_tpu_torch.tools.lane_pad_probe", "--cpu", "--reps", "5", "--step-ms", "98"], 6),
    (["crossscore_tpu_torch.tools.bwd_microbench", "--cpu"], len(bwd_microbench.CONFIGS)),
    (["crossscore_tpu_torch.tools.mlp_microbench", "--cpu"], len(mlp_microbench.MODES)),
    (["crossscore_tpu_torch.tools.matmul_microbench", "--cpu"],
     len(matmul_microbench.PRODUCTS) * len(matmul_microbench.MODES)),
    # the host tools: two Pillow rows, and three native ones where the decoder builds
    (["crossscore_tpu_torch.tools.ingest_bench", "--cpu"], None),
    (["crossscore_tpu_torch.tools.token_assembly_bench", "--cpu"], 1)])
def test_tool_runs_on_the_cpu(args, lines):
    if lines is None:
        lines = 5 if fastimage.available() else 2
    res = _run(*args)
    assert res.returncode == 0, res.stdout + res.stderr
    out = res.stdout.splitlines()
    assert out[0].startswith("device: cpu")
    timed = [line for line in out if " items/s" in line or " ms" in line and (
        "ms/layer" in line or "saving" in line or "TFLOP" in line or "TOP/s" in line or "per batch" in line)]
    assert len(timed) == lines, res.stdout
    if "attn_microbench" in args[0]:
        assert sum("PROBE(wrong math)" in line for line in out) == sum(
            a.startswith(("qkvp", "v2noexp", "v2mxu")) for a in args)
        assert "maxdiff=0.0000" in out[2]  # the first spec against itself


@pytest.mark.parametrize("tool", [attn_microbench, lane_pad_probe, bwd_microbench, mlp_microbench, ingest_bench,
                                  token_assembly_bench, matmul_microbench])
def test_tool_without_cpu_needs_a_card(tool, capsys):
    """``main`` is the exit code of ``python -m``: 1, with a message, when
    there is no card and ``--cpu`` was not given."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the tool would run on it")
    assert tool.main([]) == 1
    assert "no CUDA device" in capsys.readouterr().err


@pytest.mark.parametrize("spec,want", [
    ("v2bf16:688,1408,2", {"kind": "head_major", "variant": "bf16exp", "chunks": 1}),
    ("v2noaug:688,1408,2", {"kind": "head_major", "variant": None}),
    ("qkv:688,2", {"kind": "qkv", "chunks": 1, "probe": None}),
    ("qkv:688,2,3", {"kind": "qkv", "chunks": 3}),
    ("qkvc:688,2,2", {"kind": "qkv", "chunks": 2}),
    ("qkvp:688,2,nosum", {"kind": "qkv", "probe": "nosum", "tiles": {"block_q": 688, "hpack": 2}}),
    ("xln:512,1024", {"kind": "xln", "tiles": {"block_q": 512, "block_k": 1024}})])
def test_spec_grammar(spec, want):
    got = attn_microbench.parse_spec(spec)
    assert {k: got[k] for k in want} == want


@pytest.mark.parametrize("spec,match", [("qkv:688,2,1,allpar", "Mosaic"), ("v3:1,2,3", "unknown"),
                                        ("qkvp:688,2,nosoftmax", "probe"), ("qkvc:688,2", "chunks"),
                                        ("v2:688,1408", "block_h")])
def test_spec_refusals(spec, match):
    with pytest.raises(ValueError, match=match):
        attn_microbench.parse_spec(spec)


@pytest.mark.parametrize("argv,labels,blocks", [
    (["--cpu", "fused", "256", "512"], ["fused (K2)"], "256, 512"),
    (["--cpu", "xla"], ["xla unfused"], None),
    (["--cpu", "128", "xla", "fused"], ["xla unfused", "fused (K2)"], "128")])
def test_mlp_microbench_modes_and_unused_block_m(argv, labels, blocks, capsys):
    """The TPU tool's arguments: modes in the order given, the block_m
    integers accepted and reported as unused TPU tiles on the fused row."""
    assert mlp_microbench.main(argv) == 0
    out = capsys.readouterr().out.splitlines()
    rows = [line for line in out if "ms/layer" in line and "TFLOP/s" in line]
    assert [r[:24].strip() for r in rows] == labels
    if blocks:
        assert rows[-1].endswith(f"[unused TPU tiles: block_m={blocks}]")
    assert all("unused" not in r for r in rows if r.startswith("xla"))


def test_mlp_microbench_refuses_an_unknown_mode():
    with pytest.raises(SystemExit):
        mlp_microbench.main(["--cpu", "pallas"])


def _profile_group():
    spec = importlib.util.spec_from_file_location("torch_step_profile", ROOT / "tools" / "torch_step_profile.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod._group


@pytest.mark.parametrize("name,group", [
    # K2 and K10: the bf16 body (D, RES, TANH), demangled and mangled, and the
    # fp32 and wide-D kernels
    ("void cs::ln_mlp_tma<384, false, true>(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
     "CUtensorMap_st, cs::MlpArgs)", "K2 fused LN-MLP"),
    ("void cs::ln_mlp_tma<64, false, false>(CUtensorMap_st, cs::MlpArgs)", "K2 fused LN-MLP"),
    ("_ZN2cs10ln_mlp_tmaILi384ELb0ELb1EEEv14CUtensorMap_stS1_S1_S1_S1_NS_7MlpArgsE", "K2 fused LN-MLP"),
    ("_ZN2cs10ln_mlp_tmaILi384ELb0ELb0EEEv14CUtensorMap_stS1_S1_S1_S1_NS_7MlpArgsE", "K2 fused LN-MLP"),
    ("void cs::ln_mlp_tma<384, true, true>(CUtensorMap_st, cs::MlpArgs)", "K10 fused residual LN-MLP"),
    ("_ZN2cs10ln_mlp_tmaILi64ELb1ELb1EEEv14CUtensorMap_stS1_S1_S1_S1_NS_7MlpArgsE", "K10 fused residual LN-MLP"),
    ("void cs::ln_mlp_f32<32, false>(cs::MlpArgs)", "K2 fused LN-MLP"),
    ("void cs::ln_mlp_f32<32, true>(cs::MlpArgs)", "K10 fused residual LN-MLP"),
    ("_ZN2cs10ln_mlp_f32ILi16ELb1EEEvNS_7MlpArgsE", "K10 fused residual LN-MLP"),
    ("void cs::ln_mlp_wide<1024, false, true>(CUtensorMap_st, CUtensorMap_st, cs::MlpArgs)", "K2 fused LN-MLP"),
    ("_ZN2cs11ln_mlp_wideILi1024ELb0ELb1EEEv14CUtensorMap_stS1_NS_7MlpArgsE", "K2 fused LN-MLP"),
    ("void cs::ln_mlp_wide<768, true, true>(CUtensorMap_st, CUtensorMap_st, cs::MlpArgs)",
     "K10 fused residual LN-MLP"),
    ("_ZN2cs11ln_mlp_wideILi768ELb1ELb1EEEv14CUtensorMap_stS1_NS_7MlpArgsE", "K10 fused residual LN-MLP"),
    # the int8 backbone's two kernels, demangled and mangled
    ("void (anonymous namespace)::quantize_rows_kernel<__nv_bfloat16>(__nv_bfloat16 const*, signed char*, "
     "float*, long long, int, float)", "Q1 int8 row quantise"),
    ("_ZN47_GLOBAL__N__b3ac4818_14_int8_linear_cu_4f29afe420quantize_rows_kernelIfEEvPKT_PaPfxif",
     "Q1 int8 row quantise"),
    ("void (anonymous namespace)::int8_linear_kernel<__nv_bfloat16>(signed char const*, float const*, "
     "signed char const*, float const*, __nv_bfloat16 const*, __nv_bfloat16*, long long, int, int)",
     "Q2 int8 linear"),
    ("_ZN47_GLOBAL__N__b3ac4818_14_int8_linear_cu_4f29afe418int8_linear_kernelIfEEvPKaPKfS2_S4_PKT_PS5_xii",
     "Q2 int8 linear"),
    # the attention forward at the backbone's hd 64 and the decoder's 48
    ("void cs::attn_fwd_wgmma<64, false, 0>(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, cs::AttnArgs)",
     "K1 backbone attention"),
    ("_ZN2cs14attn_fwd_wgmmaILi64ELb0ELi0EEEv14CUtensorMap_stS1_S1_NS_8AttnArgsE", "K1 backbone attention"),
    ("void cs::attn_fwd_wgmma<48, true, 0>(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, cs::AttnArgs)",
     "K3 decoder attention"),
    ("_ZN2cs14attn_fwd_wgmmaILi48ELb0ELi0EEEv14CUtensorMap_stS1_S1_NS_8AttnArgsE", "K3 decoder attention"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64", "matrix products (cuBLAS)"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>>",
     "elementwise, reductions, copies")])
def test_step_profile_groups(name, group):
    assert _profile_group()(name) == group
