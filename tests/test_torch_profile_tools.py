"""The port's profiling tools and its build-flag sweep on the CPU (``--cpu``,
small shapes): each tool's sections and line keys, the trace readers on a
hand-written Chrome trace of known kernel durations and links, and the
sweep's sets, its refusal of an unknown set and the build digest it must
leave as it was."""

import hashlib
import json
import re

import pytest

from crossscore_tpu_torch.ops import _build
from crossscore_tpu_torch.tools import (
    h2d_probe, model_breakdown, trace_breakdown, trace_events, train_microbench, train_trace, xla_flag_sweep,
)

CPU_TAG = "[cpu: plain versions, host times]"


def _lines(capsys) -> list:
    return capsys.readouterr().out.splitlines()


# --- a hand-written trace: three runs of two K1 launches, one K4 pass, a
# cuBLAS product and a copy; each kernel linked to its runtime call and op


def _trace_events() -> list:
    ev = []

    def op(ext, name, dims):
        ev.append({"ph": "X", "cat": "cpu_op", "name": name, "ts": 0, "dur": 100,
                   "args": {"External id": ext, "Input Dims": dims}})

    def kernel(corr, ext, name, dur):
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 0, "dur": 5,
                   "args": {"External id": ext, "correlation": corr}})
        ev.append({"ph": "X", "cat": "kernel", "name": name, "ts": 0, "dur": dur,
                   "args": {"External id": ext, "correlation": corr}})

    # K1 is launched through ctypes outside any ATen op: External id 1 names no op
    op(2, "aten::addmm", [[384], [98640, 384], [384, 1536]])
    op(3, "_FlashCrossAttentionBackward", [[24, 1369, 384]])
    op(4, "aten::copy_", [[8, 3], [8, 3]])
    corr = 100
    for _ in range(3):
        for ext, name, dur in ((1, "void cs::attn_fwd_wgmma<64, false, 0>(CUtensorMap_st, cs::AttnArgs)", 500.0),
                               (1, "void cs::attn_fwd_wgmma<64, false, 0>(CUtensorMap_st, cs::AttnArgs)", 520.0),
                               (3, "void cs::attn_bwd_dq_wgmma<48, false>(CUtensorMap_st, cs::BwdArgs)", 300.0),
                               (2, "nvjet_tst_192x192_64x4_2x1_v_bz_coopB_bias_TNN", 250.0),
                               (4, "void at::native::(anonymous namespace)::elementwise_kernel<128, 2>(int)", 30.0)):
            corr += 1
            kernel(corr, ext, name, dur)
    # a kernel whose runtime call was not recorded, found by its own External id
    ev.append({"ph": "X", "cat": "kernel", "name": "void (anonymous namespace)::bwd_stats<48>(cs::BwdArgs)",
               "ts": 0, "dur": 60.0, "args": {"External id": 3, "correlation": 999}})
    ev.append({"ph": "f", "cat": "ac2g", "name": "flow", "id": 101, "ts": 0})
    return ev


@pytest.fixture
def trace(tmp_path):
    path = tmp_path / "prof" / "trace.json"
    path.parent.mkdir()
    path.write_text(json.dumps({"schemaVersion": 1, "traceEvents": _trace_events()}))
    return path


@pytest.mark.parametrize("name,fam,group", [
    ("void cs::attn_fwd_wgmma<64, false, 0>(CUtensorMap_st, cs::AttnArgs)", "cs::attn_fwd_wgmma",
     "K1 backbone attention"),
    ("void cs::attn_fwd_wgmma<48, false, 0>(CUtensorMap_st, cs::AttnArgs)", "cs::attn_fwd_wgmma",
     "K3 decoder attention"),
    ("void cs::attn_bwd_dkdv_wgmma<48, false>(CUtensorMap_st, cs::BwdArgs)", "cs::attn_bwd_dkdv_wgmma",
     "K4 decoder attention backward"),
    # the fp32 forward: the 3xTF32 body and its pre-pass, by head dim as the bf16 body
    ("void cs::attn_fwd_tf32<64, false>(cs::AttnArgs)", "cs::attn_fwd_tf32", "K1 backbone attention"),
    ("void cs::attn_fwd_split_kv<64>(cs::AttnArgs, float*)", "cs::attn_fwd_split_kv", "K1 backbone attention"),
    ("_ZN2cs13attn_fwd_tf32ILi48ELb1EEEvNS_8AttnArgsE", "_ZN2cs13attn_fwd_tf32ILi48ELb1EEEvNS_8AttnArgsE",
     "K3 decoder attention"),
    ("_ZN2cs17attn_fwd_split_kvILi48EEEvNS_8AttnArgsEPf", "_ZN2cs17attn_fwd_split_kvILi48EEEvNS_8AttnArgsEPf",
     "K3 decoder attention"),
    ("void (anonymous namespace)::bwd_stats<48>(cs::BwdArgs)", "bwd_stats", "K4 decoder attention backward"),
    ("_ZN2cs17attn_bwd_dq_wgmmaILi48ELb0EEEv14CUtensorMap_stS1_S1_S1_NS_7BwdArgsE",
     "_ZN2cs17attn_bwd_dq_wgmmaILi48ELb0EEEv14CUtensorMap_stS1_S1_S1_NS_7BwdArgsE", "K4 decoder attention backward"),
    ("void at::native::(anonymous namespace)::reduce_kernel<512, 1>(int)", "at::native::reduce_kernel",
     "elementwise, reductions, copies"),
    ("nvjet_tst_192x192_64x4_2x1_v_bz_coopB_bias_TNN", "nvjet_tst_192x192_64x4_2x1_v_bz_coopB_bias_TNN",
     "matrix products (cuBLAS)"),
])
def test_family_and_group_of_a_kernel_name(name, fam, group):
    assert trace_breakdown.family(name) == fam
    assert trace_breakdown.kernel_group(name) == group


@pytest.mark.parametrize("name,counted", [
    ("void cs::attn_fwd_tf32<64, false>(cs::AttnArgs)", True),
    ("void cs::attn_fwd_split_kv<64>(cs::AttnArgs, float*)", False),
    ("_ZN2cs17attn_fwd_split_kvILi48EEEvNS_8AttnArgsEPf", False),
    ("void cs::attn_fwd_wgmma<64, false, 0>(CUtensorMap_st, cs::AttnArgs)", True),
])
def test_the_fp32_pre_pass_is_no_launch_of_its_own(name, counted):
    """One wrapper call of the fp32 forward runs the pre-pass and the body and
    counts one launch: a profile counts the body, and times both in its group."""
    assert trace_breakdown.counts_as_launch(name) is counted


def test_the_step_profile_uses_the_shared_grouping():
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "torch_step_profile", Path(__file__).resolve().parent.parent / "tools" / "torch_step_profile.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    assert tool._group is trace_breakdown.kernel_group


@pytest.mark.parametrize("where", ["file", "directory"])
def test_analyse_sums_families_and_groups_exactly(trace, capsys, where):
    res = trace_breakdown.analyse(trace if where == "file" else trace.parent, n_runs=3)
    assert res["category"] == "kernel" and res["events"] == 16
    fams = {(f, g): (ms, n) for f, g, ms, n in res["families"]}
    assert fams[("cs::attn_fwd_wgmma", "K1 backbone attention")] == (pytest.approx(1.02), 2)
    assert fams[("cs::attn_bwd_dq_wgmma", "K4 decoder attention backward")] == (pytest.approx(0.3), 1)
    assert fams[("bwd_stats", "K4 decoder attention backward")] == (pytest.approx(0.02), pytest.approx(1 / 3))
    assert fams[("at::native::elementwise_kernel", "elementwise, reductions, copies")] == (pytest.approx(0.03), 1)
    assert res["groups"] == pytest.approx({"K1 backbone attention": 1.02, "K4 decoder attention backward": 0.32,
                                           "matrix products (cuBLAS)": 0.25, "elementwise, reductions, copies": 0.03})
    assert res["total_ms"] == pytest.approx(1.62)
    out = _lines(capsys)
    assert out[0] == "device [kernel]: 1.620 ms/run over 16 events (3 runs)"
    assert re.fullmatch(r" +1\.020 ms  x   2  K1 backbone attention +cs::attn_fwd_wgmma", out[1])
    assert out[out.index("by group:") + 1].split() == ["1.020", "ms", "63.0%", "K1", "backbone", "attention"]


def test_trace_breakdown_main_reads_a_trace(trace, capsys):
    assert trace_breakdown.main([str(trace)]) == 0
    assert _lines(capsys)[0].startswith("device [kernel]: 1.620 ms/run")


def test_trace_events_links_kernels_to_their_ops(trace, capsys):
    assert trace_events.main([str(trace), "3"]) == 0
    out = _lines(capsys)
    assert out[0] == "device [kernel]: 1.620 ms/run in filter <all> (16 events, 3 runs)"
    rows = [ln for ln in out if " ms x" in ln]
    assert rows[0].split()[:4] == ["1.020", "ms", "x", "2"] and "attn_fwd_wgmma<64, false, 0>" in rows[0]
    assert len(rows) == 5  # the K1 launches share one name
    launched = {out[i - 1]: out[i].strip() for i, ln in enumerate(out) if "launched by" in ln}
    assert len(launched) == 5
    by_kernel = {k.split("  ")[-1].split("<")[0]: v for k, v in launched.items()}
    assert by_kernel == {
        "void cs::attn_fwd_wgmma": "launched by no op recorded",
        "void cs::attn_bwd_dq_wgmma": "launched by _FlashCrossAttentionBackward, input shapes [[24, 1369, 384]]",
        "nvjet_tst_192x192_64x4_2x1_v_bz_coopB_bias_TNN":
            "launched by aten::addmm, input shapes [[384], [98640, 384], [384, 1536]]",
        "void at::native::(anonymous namespace)::elementwise_kernel":
            "launched by aten::copy_, input shapes [[8, 3], [8, 3]]",
        # its runtime call is missing: its own External id names the op
        "void (anonymous namespace)::bwd_stats":
            "launched by _FlashCrossAttentionBackward, input shapes [[24, 1369, 384]]"}


def test_trace_events_filters_by_family(trace, capsys):
    assert trace_events.main([str(trace), "3", "attn_bwd"]) == 0
    out = _lines(capsys)
    assert out[0] == "device [kernel]: 0.300 ms/run in filter attn_bwd (3 events, 3 runs)"
    assert [ln for ln in out if " ms x" in ln][0].split()[:4] == ["0.300", "ms", "x", "1"]


# --- the tools on the CPU


def test_model_breakdown_sections(capsys):
    argv = ["--cpu", "full", "backbone", "backbone_fusedmlp", "backbone_xla", "backbone_int8", "decoder"]
    assert model_breakdown.main(argv) == 0
    out = _lines(capsys)
    assert out[1].startswith("bench point: dinov2-test, B=1, K=2, 56 px, bfloat16, median of 5 calls")
    rows = out[2:]
    assert [r.split()[0] for r in rows] == ["full(warm)", "full", "backbone", "backbone_fusedmlp", "backbone_xla",
                                           "backbone_int8", "decoder"]
    for r in rows:
        assert re.fullmatch(r"\S+ +\d+\.\d{3} ms  \(warm-up \d+\.\d s, runs (\d+\.\d\d/){4}\d+\.\d\d ms\)  "
                            + re.escape(CPU_TAG), r), r


def test_model_breakdown_refuses_an_unknown_section():
    with pytest.raises(SystemExit):
        model_breakdown.main(["--cpu", "encoder"])


def test_train_microbench_line(capsys):
    assert train_microbench.main(["--cpu", "2", "2"]) == 0
    out = _lines(capsys)
    assert re.fullmatch(r"train step B=2 K=2 56px: \d+\.\d\d ms/step \(runs (\d+\.\d/){2}\d+\.\dms over 3 steps\)  "
                        + re.escape(CPU_TAG), out[-1]), out[-1]


@pytest.mark.parametrize("mode", ["pixel", "tokens"])
def test_train_trace_captures_and_analyses(tmp_path, capsys, mode):
    path = tmp_path / "t.json"
    argv = ["--cpu", "2", "2", str(path)] + (["tokens"] if mode == "tokens" else [])
    assert train_trace.main(argv) == 0
    out = _lines(capsys)
    what = "token-space train-step" if mode == "tokens" else "train-step"
    assert any(ln.startswith(f"{what} trace captured -> {path} (B=2, K=2, 56 px") for ln in out)
    head = next(ln for ln in out if "ms/run over" in ln)
    assert head.startswith("host, nested (no kernel event: a CPU capture) [cpu_op]:") and head.endswith(CPU_TAG)
    assert "by group:" in out and path.is_file()
    names = {e["name"] for e in json.loads(path.read_text())["traceEvents"] if e.get("cat") == "cpu_op"}
    assert "_FlashCrossAttentionBackward" in names  # the decoder's backward ran under the profiler


def test_trace_breakdown_captures_the_backbone(capsys):
    assert trace_breakdown.main(["--cpu"]) == 0
    out = _lines(capsys)
    assert out[1].startswith("trace captured -> ") and out[1].endswith("trace.json")
    assert "ms/run over" in out[2] and "(3 runs)" in out[2]


def test_h2d_probe_lines(capsys):
    assert h2d_probe.main(["--cpu"]) == 0
    out = _lines(capsys)
    rows = [ln for ln in out if "MB/s" in ln]
    assert [ln.split(":")[0] for ln in rows] == [f"{n} pageable rep{r}" for n in ("float32", "uint8", "tokens")
                                               for r in range(h2d_probe.REPS)]
    for ln in rows:
        assert re.fullmatch(r"\S+ pageable rep\d: \d+\.\d MB in \d+\.\d{4}s = [\d.]+ MB/s  " + re.escape(CPU_TAG), ln)
    assert [ln for ln in out if "pinned" in ln] == [f"{n} pinned: skipped (pinning needs CUDA)"
                                                    for n in ("float32", "uint8", "tokens")]


def test_h2d_probe_batches_are_the_loaders():
    b, k, s, n, d = h2d_probe.B, h2d_probe.K, h2d_probe.S, h2d_probe.N_TOK, h2d_probe.D
    assert (b, k, s, n, d) == (24, 5, 518, 1369, 384)
    assert b * (1 + k) * s * s * 3 * 4 == 463_663_872 and b * (1 + k) * n * d * 2 == 151_400_448


# --- the build-flag sweep


def test_sweep_sets_and_default():
    assert xla_flag_sweep.SETS == {
        "baseline": (), "ptxas_o2": ("-Xptxas", "-O2"), "ptxas_o1": ("-Xptxas", "-O1"),
        "fast_math": ("--use_fast_math",), "maxrreg_168": ("-maxrregcount=168",),
        "extra_vec": ("--extra-device-vectorization",)}
    assert xla_flag_sweep.DEFAULT == ["baseline", "ptxas_o2", "fast_math", "maxrreg_168"]
    assert set(xla_flag_sweep.DEFAULT) <= set(xla_flag_sweep.SETS)
    assert xla_flag_sweep.SOURCES == ("flash_qkv", "flash_cross", "fused_ln_mlp")


def test_sweep_refuses_an_unknown_set():
    with pytest.raises(SystemExit, match=r"unknown set 'no_lhs'; known: \['baseline'"):
        xla_flag_sweep.main(["--cpu", "baseline", "no_lhs"])


def test_sweep_lines_and_ranking(capsys):
    assert xla_flag_sweep.main(["--cpu", "baseline", "ptxas_o2"]) == 0
    out = _lines(capsys)
    for name in ("baseline", "ptxas_o2"):
        (row,) = [ln for ln in out if ln.startswith(name + " ")]
        assert re.fullmatch(rf"{name} +\d+\.\d{{3}} ms/fwd +[\d.]+ maps/s  \(build \d+\.\ds, runs (\d+\.\d\d/){{7}}"
                            rf"\d+\.\d\dms; no build \(plain versions\)\)  " + re.escape(CPU_TAG), row), row
    ranked = out[out.index("ranked:") + 1:]
    assert sorted(r.split()[0] for r in ranked) == ["baseline", "ptxas_o2"]
    assert _build._extra_flags == () and _build._build_dir is None


def test_the_default_digest_is_the_parents():
    """The AOT artifacts check library digests: with no extra flag, the digest
    and the library paths are the formula they were before the sweep."""
    h = hashlib.sha256(" ".join(_build.NVCC_FLAGS).encode())
    for p in sorted(_build.CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    assert _build._digest() == h.hexdigest()[:16]
    assert _build.library_path("flash_qkv") == _build.build_dir() / f"flash_qkv-{h.hexdigest()[:16]}.so"


def test_extra_flags_reach_nvcc_and_the_digest(tmp_path, monkeypatch):
    default = _build._digest()
    seen = []

    class FakeNvcc:
        def __init__(self, cmd, stdout, stderr):
            seen.append(cmd)
            out = cmd[cmd.index("-o") + 1]
            open(out, "wb").close()

        def wait(self):
            return 0

    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "Popen", FakeNvcc)
    monkeypatch.setattr(_build, "_build_dir", tmp_path)
    _build._libs["flash_qkv"] = object()  # a library loaded before the switch
    try:
        _build.set_extra_flags(xla_flag_sweep.SETS["ptxas_o2"])
        assert "flash_qkv" not in _build._libs
        assert _build._digest() != default
        _build.build_all(("flash_qkv",))
        assert seen[0][-5:-3] == ["-Xptxas", "-O2"] and seen[0][1:-5] == list(_build.NVCC_FLAGS)
        assert _build.library_path("flash_qkv").is_file()
        assert _build.library_path("flash_qkv").name == f"flash_qkv-{_build._digest()}.so"
    finally:
        _build.set_extra_flags(())
    assert _build._digest() == default
