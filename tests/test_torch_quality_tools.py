"""The port's training-quality tools on the CPU at minimal sizes, each through
its entry point: ``overfit_convergence`` and ``ab_token_vs_pixel`` (the
``cpu-tiny`` preset, one step an arm), whose presets are held against the
TPU tool's, and ``bench_stress_attention --cpu``; their output lines are
parsed."""

import importlib.util
import json
import re
from pathlib import Path

import pytest
import torch

from crossscore_tpu_torch.tools import ab_token_vs_pixel, bench_stress_attention, overfit_convergence

ROOT = Path(__file__).resolve().parent.parent


def _jax_tool(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _trailing_json(text: str):
    """The indented JSON object that ends the output."""
    return json.loads(text[text.rindex("\n{\n") + 1:])


def test_overfit_convergence_reports_its_lines(tmp_path, capsys):
    assert overfit_convergence.main(["3", str(tmp_path), "56", "--cpu", "--hw", "84", "112",
                                     "--min-corr", "-1"]) == 0
    out = capsys.readouterr().out
    assert "steps logged: 3" in out
    assert [int(s) for s in re.findall(r"  step\s+(\d+): L1 [\d.]+  corr -?[\d.]+", out)] == [1, 2, 3]
    final = re.search(r"final: step 3 L1 ([\d.]+) corr (-?[\d.]+) \(best corr (-?[\d.]+)\)", out)
    assert final and float(final.group(3)) >= float(final.group(2))
    assert re.search(r"ms/step: [\d.]+ \(median of 2 gaps", out)
    assert "CONVERGED: correlation > -1.0" in out
    # the bound is enforced: no run of 3 steps reaches 0.999
    assert overfit_convergence.main(["1", str(tmp_path), "56", "--cpu", "--min-corr", "0.999"]) == 1


def test_ab_presets_are_the_tpu_tools(tmp_path):
    jax_tool = _jax_tool("ab_token_vs_pixel")
    pairs = {"cpu-tiny": "cpu-tiny", "gpu-medium": "tpu-medium"}
    assert set(ab_token_vs_pixel.PRESETS) == set(pairs)
    for port_name, jax_name in pairs.items():
        port, jax = ab_token_vs_pixel.PRESETS[port_name], jax_tool.PRESETS[jax_name]
        assert {k: port[k] for k in ("hw", "scenes", "n_train", "n_test")} == \
            {k: jax[k] for k in ("hw", "scenes", "n_train", "n_test")}
        assert port["accel"] == {"cpu": "cpu", "tpu": "cuda"}[jax["accel"]]
        same = [o.replace("model.tpu.", "model.gpu.") for o in jax["base"] if not o.startswith("logger.")]
        assert [o for o in port["base"] if not o.startswith("logger.")] == same
        assert set(ab_token_vs_pixel.FIGURES_OFF) <= set(port["base"])


def test_ab_token_vs_pixel_both_arms(tmp_path, capsys):
    rc = ab_token_vs_pixel.main(["--preset", "cpu-tiny", "--out", str(tmp_path), "--sustained", "1",
                                 "--extra", "trainer.max_steps=2", "--extra", "trainer.limit_val_batches=1",
                                 "--extra", "trainer.num_sanity_val_steps=1"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "corpus generated in" in out
    report = _trailing_json(out)
    assert report["preset"] == "cpu-tiny" and report["seeds"] is None
    assert [a["arm"] for a in report["arms"]] == ["pixel", "token"]
    for arm in report["arms"]:
        assert arm["steps"] == 2 and arm["sustained_steps"] == 1 and arm["sustained_ms_per_step"] > 0
        assert 0 < arm["final_val_loss"] == arm["best_val_loss"] and -1 <= arm["final_val_corr"] <= 1
    assert json.loads((tmp_path / "ab_report.json").read_text())["arms"][1]["val_curve"]


def test_ab_token_vs_pixel_records_a_hung_arm(tmp_path, capsys, monkeypatch):
    """An arm past its time limit is killed and recorded; the session goes
    on to the next arm and exits 1."""
    monkeypatch.setattr(ab_token_vs_pixel, "ARM_TIMEOUT_S", 0.5)
    assert ab_token_vs_pixel.main(["--preset", "cpu-tiny", "--out", str(tmp_path)]) == 1
    report = _trailing_json(capsys.readouterr().out)
    assert [a["arm"] for a in report["arms"]] == ["pixel", "token"]
    assert all(a["error"].startswith("TimeoutExpired") for a in report["arms"])


def test_bench_stress_attention_cpu(capsys):
    assert bench_stress_attention.main(["--cpu", "--reps", "2"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    got = json.loads(out[-1])
    assert got["geometry"] == {"b": 2, "heads": 16, "hd": 64, "nq": 36, "nk": 576, "dtype": "float32"}
    assert set(got["kernels"]) == {"head-major K7", "layout-native K3"}
    for row in got["kernels"].values():
        assert row["ms"] > 0 and row["rel_l2_vs_sdpa"] < 1e-5 and row["max_abs_vs_sdpa"] < 1e-5
    assert sum(line.startswith("stress cross-attn [") for line in out) == 3
    # the card's point: 4 B H Nq Nk hd at 989 TFLOP/s
    assert 4 * 2 * 16 * 5476 * 87616 * 64 / 989e12 * 1e3 == pytest.approx(3.97, abs=0.01)


def test_bench_stress_attention_check_sees_a_scaled_o():
    """The check's measure, the relative L2 of o against SDPA: an o 15% off
    reads 0.15, where the max |d| is of the size of o itself."""
    q, k, v = bench_stress_attention.inputs(torch.device("cpu"), 6, torch.float32)
    want = torch.nn.functional.scaled_dot_product_attention(q, k, v)
    assert bench_stress_attention.errors(want, want)["rel_l2_vs_sdpa"] == 0
    planted = bench_stress_attention.errors(0.85 * want, want)
    assert planted["rel_l2_vs_sdpa"] == pytest.approx(0.15, rel=1e-6)
    assert planted["max_abs_vs_sdpa"] == pytest.approx(0.15 * float(want.abs().max()), rel=1e-6)
