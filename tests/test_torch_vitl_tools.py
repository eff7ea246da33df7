"""The ViT-L stress path's tools (``crossscore_tpu_torch.tools.stress_vitl``,
``probe_vitl_token_bwd``, ``batch_sweep``): each takes the TPU tool's argv,
runs with ``--cpu`` at a tiny size and prints, as its last line, the TPU
tool's JSON report with the same keys, which the TPU tool itself prints (or
writes to ``--out``) for the same argv here; without ``--cpu`` on a machine
with no card each exits 1. The TPU-only knobs are taken and reported
unused."""

import importlib.util
import json
from pathlib import Path

import jax
import pytest
import torch

from crossscore_tpu.utils import compilation_cache
from crossscore_tpu_torch.tools import batch_sweep, probe_vitl_token_bwd, stress_vitl

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture
def jax_tool(tmp_path, monkeypatch):
    """Load ``tools/<name>.py`` (the TPU tool) with its compilation cache in
    ``tmp_path``, and restore the JAX settings it changes afterwards."""
    monkeypatch.setattr(compilation_cache, "_DEFAULT", tmp_path / "xla_cache")
    saved = {k: getattr(jax.config, k) for k in ("jax_compilation_cache_dir",
                                                  "jax_persistent_cache_min_compile_time_secs")}

    def load(name: str):
        spec = importlib.util.spec_from_file_location(f"jax_{name}", ROOT / "tools" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    yield load
    for k, v in saved.items():
        jax.config.update(k, v)


def _last_json(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])


def _keys_within(want: dict, got: dict, path: str = "") -> None:
    """Every key of ``want`` in ``got``, recursively through dicts."""
    for k, v in want.items():
        assert k in got, f"{path}{k} missing"
        if isinstance(v, dict):
            assert isinstance(got[k], dict), f"{path}{k}"
            _keys_within(v, got[k], f"{path}{k}.")


def test_stress_vitl_prints_the_tpu_tools_keys(jax_tool, capsys):
    argv = ["--cpu", "--hw", "56", "--k", "2", "--batches", "1", "--preset", "dinov2-test", "--token"]
    jax_tool("stress_vitl").main(argv)
    want = _last_json(capsys.readouterr().out)
    assert stress_vitl.main(argv + ["--extra", "model.tpu.remat_backbone=true", "--scoped-vmem-kib", "65536"]) == 0
    out = capsys.readouterr().out
    got = _last_json(out)
    assert out.splitlines()[0].startswith("device: cpu")
    _keys_within(want, got)
    assert set(want) - {"hw", "k", "preset", "params_m"} == {"fwd_B1", "train_tok_B1"}
    assert (got["hw"], got["k"], got["preset"], got["params_m"]) == (56, 2, "dinov2-test", want["params_m"])
    assert got["unused"] == ["model.tpu.remat_backbone=true", "--scoped-vmem-kib=65536"]
    assert got["fwd_B1"]["mfu"] is None and got["fwd_B1"]["ms"] > 0  # no device metric on the CPU
    assert got["fwd_B1"]["spread_ms"][0] <= got["fwd_B1"]["ms"] <= got["fwd_B1"]["spread_ms"][1]


def test_stress_vitl_token_train_only(capsys):
    """``--skip-forward`` and ``--train-batches`` as the TPU tool reads them:
    the train rows only, at the train list's batch sizes."""
    argv = ["--cpu", "--hw", "56", "--k", "2", "--batches", "1", "--preset", "dinov2-test", "--token",
            "--skip-forward", "--train-batches", "2"]
    assert stress_vitl.main(argv) == 0
    got = _last_json(capsys.readouterr().out)
    assert set(got) == {"hw", "k", "preset", "params_m", "train_tok_B2", "unused", "device"}


def test_stress_vitl_pixel_train_rows(capsys):
    """Without ``--token`` the train rows are the pixel step's, named as the
    TPU tool names them, with the token rows' keys (the TPU tool's train rows
    differ only in name)."""
    argv = ["--cpu", "--hw", "56", "--k", "2", "--batches", "1", "--preset", "dinov2-test", "--skip-forward"]
    assert stress_vitl.main(argv + ["--token"]) == 0
    tok = _last_json(capsys.readouterr().out)
    assert stress_vitl.main(argv) == 0
    got = _last_json(capsys.readouterr().out)
    assert set(got) - {"train_B1"} == set(tok) - {"train_tok_B1"}
    assert set(got["train_B1"]) == set(tok["train_tok_B1"])


def test_probe_vitl_token_bwd_reports_the_tpu_tools_keys(jax_tool, tmp_path, capsys):
    argv = ["--cpu", "--g", "4", "--k", "2", "--preset", "dinov2-test"]
    jax_tool("probe_vitl_token_bwd").main(argv + ["--out", str(tmp_path / "jax.json")])
    want = json.loads((tmp_path / "jax.json").read_text())
    assert probe_vitl_token_bwd.main(argv + ["--out", str(tmp_path / "port.json")]) == 0
    got = _last_json(capsys.readouterr().out)
    assert got == json.loads((tmp_path / "port.json").read_text())
    _keys_within(want, got)
    assert got["geometry"] == want["geometry"]  # hd 8: no kernel stage on either side
    assert got["bwd_sweep"] == want["bwd_sweep"] == []


def test_probe_vitl_token_bwd_times_the_kernels_where_they_take_the_head_dim(capsys):
    """dinov2-small's decoder (hd 48): K3 and K4 alone, one bwd_sweep row."""
    assert probe_vitl_token_bwd.main(["--cpu", "--g", "2", "--k", "2", "--preset", "dinov2-small"]) == 0
    got = _last_json(capsys.readouterr().out)
    assert {"cross_fwd_kernel", "cross_bwd_kernel"} <= set(got["components_ms"])
    assert [set(r) for r in got["bwd_sweep"]] == [{"block_k", "qc_budget", "ms"}]
    assert got["floors"]["bwd_mxu_ms"] > 0 and got["floors"]["bwd_hbm_ms"] > 0


def test_batch_sweep_reports_the_tpu_tools_keys(jax_tool, tmp_path, capsys):
    argv = ["--cpu", "--hw", "56", "--batches", "1", "--preset", "dinov2-test", "--modes", "token"]
    jax_tool("batch_sweep").main(argv + ["--out", str(tmp_path / "jax.json")])
    want = json.loads((tmp_path / "jax.json").read_text())
    assert batch_sweep.main(argv + ["--out", str(tmp_path / "port.json")]) == 0
    got = _last_json(capsys.readouterr().out)
    assert got == json.loads((tmp_path / "port.json").read_text())
    _keys_within(want, got)
    assert [(r["mode"], r["B"]) for r in got["results"]] == [(r["mode"], r["B"]) for r in want["results"]]
    for w, g in zip(want["results"], got["results"]):
        assert set(w) <= set(g)
    assert set(got["best"]) == set(want["best"]) == {"token"}


def test_batch_sweep_pixel_rows(capsys):
    """The pixel step's rows carry the token rows' keys, and ``best`` names
    each mode."""
    assert batch_sweep.main(["--cpu", "--hw", "56", "--batches", "1", "--preset", "dinov2-test",
                             "--modes", "pixel,token"]) == 0
    got = _last_json(capsys.readouterr().out)
    assert [(r["mode"], r["B"]) for r in got["results"]] == [("pixel", 1), ("token", 1)]
    assert set(got["results"][0]) == set(got["results"][1])
    assert set(got["best"]) == {"pixel", "token"}


@pytest.mark.parametrize("tool", [stress_vitl, probe_vitl_token_bwd, batch_sweep])
def test_tool_without_cpu_needs_a_card(tool, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the tool would run on it")
    assert tool.main([]) == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_split_extra_keeps_the_ports_overrides():
    assert stress_vitl.split_extra("model.tpu.remat_backbone=true,model.decoder.num_layers=1,") == (
        ["model.decoder.num_layers=1"], ["model.tpu.remat_backbone=true"])
