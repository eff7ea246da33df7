"""The port's import boundary and device rule: no JAX, Flax, optax or
``crossscore_tpu`` import in ``crossscore_tpu_torch/`` or ``chip_smoke.py``,
no read of the JAX package's YAML tree, and no silent move to the CPU."""

import ast
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "crossscore_tpu")
PORT_FILES = sorted((ROOT / "crossscore_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_the_scan_covers_the_serving_daemon():
    for rel in ("tasks/serve.py", "client.py", "tools/serve_load_bench.py"):
        assert ROOT / "crossscore_tpu_torch" / rel in PORT_FILES, rel


def test_the_scan_covers_the_host_input_path():
    """The native decoder's bindings, the record shards and their CLI, and
    the two host benchmarks; the decoder's C++ source is the port's own copy,
    and nothing of the port loads the JAX package's ``native/`` library."""
    for rel in ("data/fastimage.py", "data/records.py", "data/pack.py", "tools/ingest_bench.py",
                "tools/token_assembly_bench.py"):
        assert ROOT / "crossscore_tpu_torch" / rel in PORT_FILES, rel
    assert (ROOT / "crossscore_tpu_torch" / "csrc" / "fastimage.cpp").is_file()
    for path in PORT_FILES:
        text = path.read_text()
        assert "libfastimage" not in text and not re.search(r'/\s*"native"', text), path


def test_the_scan_covers_the_data_parallel_modules():
    """The data-parallel slice's modules: the loader's shards and rank
    blocks, the data layout, the CLIs' rank plumbing, the launcher and the
    dry run."""
    for rel in ("data/loader.py", "data/bucketing.py", "data/token_train.py", "parallel/mesh.py",
                "parallel/launch.py", "tasks/common.py", "tasks/train.py", "tasks/test.py", "tasks/predict.py",
                "train/step.py", "tools/dryrun_multichip.py"):
        assert ROOT / "crossscore_tpu_torch" / rel in PORT_FILES, rel


def test_the_scan_covers_the_vitl_stress_tools():
    """The ViT-L stress path's tools, which keep their own copy of the TPU
    tool's ``model_flops``."""
    for rel in ("tools/stress_vitl.py", "tools/probe_vitl_token_bwd.py", "tools/batch_sweep.py"):
        assert ROOT / "crossscore_tpu_torch" / rel in PORT_FILES, rel
    assert "def model_flops" in (ROOT / "crossscore_tpu_torch" / "tools" / "stress_vitl.py").read_text()


QUALITY_MODULES = ("tools/overfit_convergence.py", "tools/ab_token_vs_pixel.py", "tools/multimethod_eval.py",
                   "tools/k_sweep.py", "tools/bench_stress_attention.py", "data/split_builder.py",
                   "data/debug_vis.py")


def test_the_scan_covers_the_training_quality_workflow():
    """The quality tools and the small host CLIs; none loads the JAX
    package's ``native/`` library."""
    for rel in QUALITY_MODULES:
        path = ROOT / "crossscore_tpu_torch" / rel
        assert path in PORT_FILES, rel
        text = path.read_text()
        assert "libfastimage" not in text and not re.search(r'/\s*"native"', text), rel


def test_predict_sh_runs_only_port_modules():
    """The port's ``predict.sh`` names the port's predict CLI and nothing of
    the JAX package."""
    text = (ROOT / "crossscore_tpu_torch" / "predict.sh").read_text()
    modules = re.findall(r"python3? -m ([\w.]+)", text)
    assert modules == ["crossscore_tpu_torch.tasks.predict"], modules
    assert not re.search(r"\bcrossscore_tpu(?!_torch)\b", text)
    assert not re.search(r"\b(jax|flax|optax|orbax)\b", text) and "native/" not in text


def test_importing_the_quality_tools_loads_no_jax():
    mods = ", ".join("crossscore_tpu_torch." + rel[:-3].replace("/", ".") for rel in QUALITY_MODULES)
    code = (f"import sys\nimport {mods}\n"
            f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_package_import(path):
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys\n"
        "import crossscore_tpu_torch.models, crossscore_tpu_torch.io.convert, "
        "crossscore_tpu_torch.train.step, crossscore_tpu_torch.ops.fused_mlp, "
        "crossscore_tpu_torch.train.optim, crossscore_tpu_torch.tasks.train, "
        "crossscore_tpu_torch.io.checkpoint, crossscore_tpu_torch.data.loader, "
        "crossscore_tpu_torch.data.nvs_index, crossscore_tpu_torch.data.synthetic, "
        "crossscore_tpu_torch.ops.metrics, crossscore_tpu_torch.utils.metric_logger, "
        "crossscore_tpu_torch.tasks.predict, crossscore_tpu_torch.data.bucketing, "
        "crossscore_tpu_torch.data.simple_reference, crossscore_tpu_torch.data.token_cache, "
        "crossscore_tpu_torch.io.batch_writer, crossscore_tpu_torch.io.summariser, "
        "crossscore_tpu_torch.utils.vis, crossscore_tpu_torch.ops.context_parallel, "
        "crossscore_tpu_torch.parallel.mesh, crossscore_tpu_torch.parallel.launch, "
        "crossscore_tpu_torch.parallel.view_parallel, crossscore_tpu_torch.tasks.test, "
        "crossscore_tpu_torch.tasks.summarise_score_gt, crossscore_tpu_torch.tasks.encode_tokens, "
        "crossscore_tpu_torch.tasks.serve, crossscore_tpu_torch.client, "
        "crossscore_tpu_torch.tools.serve_load_bench, crossscore_tpu_torch.data.fastimage, "
        "crossscore_tpu_torch.data.records, crossscore_tpu_torch.data.pack, "
        "crossscore_tpu_torch.data.token_train, crossscore_tpu_torch.tools.ingest_bench, "
        "crossscore_tpu_torch.tools.token_assembly_bench, crossscore_tpu_torch.tasks.common, "
        "crossscore_tpu_torch.tools.dryrun_multichip\n"
        "from crossscore_tpu_torch.data import fastimage\n"
        "fastimage.available()\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


def test_model_without_device_needs_cuda():
    from crossscore_tpu_torch.models import VIT_PRESETS, CrossScoreConfig, CrossScoreNet

    cfg = CrossScoreConfig(backbone=VIT_PRESETS["dinov2-test"], pe_h=6, pe_w=6)
    if torch.cuda.is_available():
        assert CrossScoreNet(cfg).img_mean_std.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            CrossScoreNet(cfg)
    assert CrossScoreNet(cfg, device="cpu").img_mean_std.device.type == "cpu"


def test_model_rejects_inputs_on_another_device():
    from crossscore_tpu_torch.models import VIT_PRESETS, CrossScoreConfig, CrossScoreNet

    cfg = CrossScoreConfig(backbone=VIT_PRESETS["dinov2-test"], pe_h=6, pe_w=6)
    model = CrossScoreNet(cfg, device="cpu")
    with pytest.raises(ValueError, match="meta"):
        model(torch.zeros(1, 56, 56, 3, device="meta"), None)


def test_csrc_builds_only_from_the_package_sources():
    from crossscore_tpu_torch.ops import _build

    assert _build.CSRC == ROOT / "crossscore_tpu_torch" / "csrc"
    assert _build.BUILD_DIR == ROOT / "build" / "crossscore_tpu_torch"
    for name in _build.SOURCES:
        assert (_build.CSRC / f"{name}.cu").is_file()
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_the_port_composes_its_own_yaml_tree():
    """The port's copy of the config tree: the same data groups (the packed
    record store's ``record_dir`` among them), the model schema with a
    ``model.gpu`` block in place of ``model.tpu``, and a train root the
    port's CLI reads."""
    import yaml

    from crossscore_tpu_torch import confsys

    port_dir = ROOT / "crossscore_tpu_torch" / "config"
    jax_dir = ROOT / "crossscore_tpu" / "config"
    assert confsys._CONFIG_DIR == port_dir
    assert sorted(p.name for p in (port_dir / "data").glob("*.yaml")) == \
        sorted(p.name for p in (jax_dir / "data").glob("*.yaml"))
    for path in (port_dir / "data").glob("*.yaml"):
        want = yaml.safe_load((jax_dir / "data" / path.name).read_text())
        assert yaml.safe_load(path.read_text()) == want, path.name
    cfg = confsys.load_config("default")
    assert "tpu" not in cfg.model
    assert cfg.model.gpu.to_dict() == {"parity": False, "compute_dtype": "bfloat16",
                                       "attention_impl": "flash", "mlp_impl": "fused", "backbone_quant": "none",
                                       "dist_backend": "nccl"}
    assert cfg.trainer.accelerator == "cuda" and cfg.trainer.optimizer.lr == 5e-4
    assert cfg.data.loader.train.batch_size == 24 and cfg.data.neighbour_config.cross == 5
    with pytest.raises(KeyError, match="tpu"):
        confsys.load_config("default", ["model.tpu.compute_dtype=float32"])


def test_predict_composes_its_own_root_and_needs_cuda_unless_told_cpu(tmp_path):
    """The predict root of the port's tree: the GPU knobs under ``model.gpu``
    (view parallelism among them), and the serving daemon's ``serve_*``
    knobs with the JAX root's defaults; without a card the CLI raises unless
    told ``trainer.accelerator=cpu``."""
    import yaml

    from crossscore_tpu_torch import confsys
    from crossscore_tpu_torch.tasks.predict import main

    cfg = confsys.load_config("default_predict")
    assert "tpu" not in cfg.model and cfg.model.gpu.view_parallel == "auto"
    assert cfg.model.gpu.attention_impl == "flash" and cfg.trainer.accelerator == "cuda"
    assert cfg.data.neighbour_config.cross == 5 and cfg.data.loader.validation.batch_size == 8
    want = yaml.safe_load((ROOT / "crossscore_tpu" / "config" / "default_predict.yaml").read_text())["this_main"]
    serve_keys = {k: v for k, v in cfg.this_main.to_dict().items() if k.startswith("serve_")}
    assert serve_keys == {k: v for k, v in want.items() if k.startswith("serve_")}
    assert len(serve_keys) == 13 and serve_keys["serve_max_batch"] == 1 and serve_keys["serve_port"] == 8642
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main([f"data.dataset.query_dir={tmp_path}", f"data.dataset.reference_dir={tmp_path}",
                  f"logger.predict.out_dir={tmp_path / 'out'}"])


def test_test_composes_its_own_root_and_needs_cuda_unless_told_cpu(tmp_path):
    """The test root of the port's tree: the JAX root's keys with the GPU
    device rule (one card, ``cuda``); without a card the CLI raises unless
    told ``trainer.accelerator=cpu``, and several devices or a ``tp`` route
    raise on every machine."""
    import yaml

    from crossscore_tpu_torch import confsys
    from crossscore_tpu_torch.tasks.test import main

    cfg = confsys.load_config("default_test")
    want = yaml.safe_load((ROOT / "crossscore_tpu" / "config" / "default_test.yaml").read_text())
    got = yaml.safe_load((ROOT / "crossscore_tpu_torch" / "config" / "default_test.yaml").read_text())
    assert got["trainer"].pop("accelerator") == "cuda" and want["trainer"].pop("accelerator") == "tpu"
    assert got["trainer"].pop("devices") == want["trainer"].pop("devices") == -1
    assert got == want
    assert "tpu" not in cfg.model and cfg.model.gpu.attention_impl == "flash"
    assert cfg.this_main.crop_mode == "integer_patches" and cfg.this_main.data_split == "test"
    assert cfg.data.loader.validation.batch_size == 24 and cfg.data.neighbour_config.cross == 5
    assert cfg.logger.test.write.config.vis_img_every_n_steps == 1
    base = [f"data.dataset.path=[{tmp_path}]", f"logger.test.out_dir={tmp_path / 'out'}"]
    with pytest.raises(NotImplementedError, match="attention_impl=tp"):
        main(base + ["model.gpu.attention_impl=tp"])
    with pytest.raises(ValueError, match=r"trainer.devices=2 asks for 2 ranks, and 1 were launched.*"
                                         r"torchrun --nproc_per_node 2"):
        main(base + ["trainer.devices=2"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(base)


def test_train_entry_point_needs_cuda_unless_told_cpu():
    from crossscore_tpu_torch import confsys
    from crossscore_tpu_torch.tasks.common import resolve_accelerator

    cfg = confsys.load_config("default")
    if torch.cuda.is_available():
        assert resolve_accelerator(cfg).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_accelerator(cfg)
    assert resolve_accelerator(confsys.load_config("default", ["trainer.accelerator=cpu"])).type == "cpu"
    with pytest.raises(ValueError, match="cuda or cpu"):
        resolve_accelerator(confsys.load_config("default", ["trainer.accelerator=auto"]))
