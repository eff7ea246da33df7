"""The port's serving artifacts (``crossscore_tpu_torch/io/aot.py``) and its
kernel build cache (``crossscore_tpu_torch/utils/compilation_cache.py``) on
the CPU, in the terms of the JAX package's ``tests/test_aot.py``: the
artifact's libraries round-trip bit for bit, every environment and serving
field that differs is refused by name, and the daemon's save then load gives
the same scores with every artifact key warm before the first request. On
the CPU the daemon's executables are eager; the graphs and the libraries of
a real build are held on the card by ``chip_smoke.py`` step 16 (d)."""

import json
import os
import re
import zipfile

import numpy as np
import pytest
import torch

from crossscore_tpu_torch.data.synthetic import generate
from crossscore_tpu_torch.io import aot
from crossscore_tpu_torch.ops import _build, interpolate
from crossscore_tpu_torch.tasks.common import parse_cli
from crossscore_tpu_torch.tasks.serve import Scorer, serve
from crossscore_tpu_torch.utils import compilation_cache

ROOT = _build.CSRC.parent.parent
QUERY = "datadir/res_540/s00001/test/ours_1000/renders"
REFS = "datadir/res_540/s00001/train/ours_1000/gt"
OVERRIDES = [
    "trainer.accelerator=cpu",
    "model.gpu.compute_dtype=float32",
    "model.backbone.preset=dinov2-test",
    "data.neighbour_config.cross=2",
    "data.neighbour_config.deterministic=true",
    "this_main.resize_short_side=84",
    "this_main.serve_max_refs=2",
    "this_main.serve_port=0",
    f"data.dataset.reference_dir={REFS}",
]
SERVING = {"token_shape": [2, 48, 64], "ref_grid": [6, 8], "params_signature": [["w", [2, 3], "float32"]],
           "in_dtype": "float32", "backbone_quant": "none", "n_devices": 1}


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_aot_ws")
    generate(root / "datadir", hw=(84, 112), scenes_per_split={"train": 1, "test": 1})
    old = os.getcwd()
    os.chdir(root)
    yield root
    os.chdir(old)


@pytest.fixture
def cache_dir(tmp_path, monkeypatch):
    """The kernel build directory pointed at an empty ``tmp_path / "cache"``,
    restored to the default after the test."""
    monkeypatch.delenv(compilation_cache.ENV, raising=False)
    yield compilation_cache.enable(tmp_path / "cache")
    _build.set_build_dir(None)


def _scorer(*extra):
    return Scorer(parse_cli("default_predict", OVERRIDES + list(extra)))


def _query_path():
    return os.path.join(QUERY, sorted(os.listdir(QUERY))[0])


def _fake_library(directory, name="flash_qkv", payload=b"\x7fELF not a real library"):
    path = directory / f"{name}-{_build._digest()}.so"
    path.write_bytes(payload)
    return path


def _rewrite(path, edit):
    """Apply ``edit`` to the artifact's decoded header in place."""
    with zipfile.ZipFile(path) as zf:
        members = {n: zf.read(n) for n in zf.namelist()}
    header = json.loads(members["header.json"])
    edit(header)
    members["header.json"] = json.dumps(header).encode()
    with zipfile.ZipFile(path, "w") as zf:
        for n, data in members.items():
            zf.writestr(n, data)


def _artifact(tmp_path, cache_dir, libraries=True):
    libs = [_fake_library(cache_dir)] if libraries else []
    path = tmp_path / "a.aot"
    aot.save_artifact(path, {"84x112xb1": {"n_devices": 1}}, SERVING, libs, device="cpu")
    return path, libs


class TestArtifactPrimitives:
    def test_library_round_trip(self, tmp_path, cache_dir):
        """The libraries come back bit for bit into a wiped build directory;
        one already there is left as it is."""
        path, (lib,) = _artifact(tmp_path, cache_dir)
        want = lib.read_bytes()
        lib.unlink()
        meta, entries, installed = aot.load_artifact(path, device="cpu")
        assert installed == [lib] and lib.read_bytes() == want
        assert meta["platform"] == "cpu" and meta["kernel_digest"] == _build._digest()
        assert entries == {"84x112xb1": {"n_devices": 1}}
        assert sorted(p.name for p in cache_dir.iterdir()) == [lib.name]  # no temporary left behind
        assert aot.load_artifact(path, device="cpu")[2] == []

    @pytest.mark.parametrize("kind", ["not_a_zip", "another_zip"])
    def test_not_an_artifact_raises(self, tmp_path, kind):
        p = tmp_path / "junk.aot"
        if kind == "not_a_zip":
            p.write_bytes(b"not an archive")
        else:
            with zipfile.ZipFile(p, "w") as zf:
                zf.writestr("header.json", json.dumps({"format": "crossscore-aot-v1"}))
        with pytest.raises(ValueError, match="not a crossscore-torch-aot-v1 artifact"):
            aot.load_artifact(p, device="cpu")
        with pytest.raises(ValueError, match="not a crossscore-torch-aot-v1 artifact"):
            aot.describe(p)

    @pytest.mark.parametrize("field", aot.ENV_FIELDS)
    def test_environment_mismatch_raises(self, tmp_path, cache_dir, field):
        """Each environment field (platform, card, compute capability, torch,
        CUDA, kernel digest) that differs is refused by name, with both
        values."""
        path, _ = _artifact(tmp_path, cache_dir)
        other = {"platform": "gpu", "device_name": "NVIDIA H100 80GB HBM3", "compute_capability": [9, 0],
                 "torch_version": "0.0.0", "cuda_version": "12.4", "kernel_digest": "0" * 16}[field]
        _rewrite(path, lambda h: h["meta"].update({field: other}))
        env = aot.env_meta("cpu")
        want = re.escape(f"{field}={other!r}") + ".*" + re.escape(f"{field}={env[field]!r}")
        with pytest.raises(ValueError, match=want):
            aot.load_artifact(path, device="cpu")

    @pytest.mark.parametrize("field", list(SERVING))
    def test_expect_meta_mismatch_names_the_field(self, tmp_path, cache_dir, field):
        path, _ = _artifact(tmp_path, cache_dir, libraries=False)
        other = {"token_shape": (3, 48, 64), "ref_grid": (8, 6), "params_signature": [("w", (2, 4), "float32")],
                 "in_dtype": "bfloat16", "backbone_quant": "int8", "n_devices": 2}[field]
        aot.load_artifact(path, expect_meta=SERVING, device="cpu")
        with pytest.raises(ValueError, match=f"artifact {field}="):
            aot.load_artifact(path, expect_meta=dict(SERVING, **{field: other}), device="cpu")

    def test_params_signature_stable_and_discriminating(self):
        a = {"w": torch.zeros(2, 3), "b.x": torch.ones(4, dtype=torch.bfloat16)}
        b = {"b.x": torch.full((4,), 9.0, dtype=torch.bfloat16), "w": torch.ones(2, 3)}
        assert aot.params_signature(a) == aot.params_signature(b)  # values and order free
        c = {"w": torch.zeros(2, 4), "b.x": torch.ones(4, dtype=torch.bfloat16)}
        assert aot.params_signature(a) != aot.params_signature(c)
        assert aot.params_signature(a)[1] == ("w", (2, 3), "float32")

    @pytest.mark.parametrize("damage", ["digest", "sha256"])
    def test_foreign_or_damaged_library_refused(self, tmp_path, cache_dir, damage):
        """A library built from other sources is refused by its digest, one
        whose bytes differ from its record by its sha256; neither is
        installed."""
        path, (lib,) = _artifact(tmp_path, cache_dir)
        lib.unlink()
        if damage == "digest":
            other = "f" * 16

            def edit(h):
                rec = h["libraries"][0]
                rec["digest"], rec["file"] = other, rec["file"].replace(_build._digest(), other)
        else:
            def edit(h):
                h["libraries"][0]["sha256"] = "0" * 64
        _rewrite(path, edit)
        with pytest.raises(ValueError, match="built from other sources" if damage == "digest" else "sha256="):
            aot.load_artifact(path, device="cpu")
        assert list(cache_dir.iterdir()) == []

    def test_insufficient_devices_named_error(self, tmp_path):
        path = tmp_path / "a.aot"
        aot.save_artifact(path, {"84x112xb8": {"n_devices": 99}}, device="cpu")
        with pytest.raises(ValueError, match="99 devices, this process has 1"):
            aot.load_artifact(path, device="cpu")
        aot.load_artifact(path, device="cpu", max_devices=99)

    def test_compilation_cache_redirects_the_build(self, tmp_path, monkeypatch):
        """``enable`` points every library path at its directory, else at
        ``$CROSSSCORE_COMPILE_CACHE``; with neither the build stays in the
        checkout's ``build/crossscore_tpu_torch``."""
        monkeypatch.delenv(compilation_cache.ENV, raising=False)
        try:
            assert compilation_cache.enable(tmp_path / "a") == tmp_path / "a"
            assert _build.library_path("flash_qkv").parent == tmp_path / "a"
            assert _build.host_library_path().parent == tmp_path / "a"
            monkeypatch.setenv(compilation_cache.ENV, str(tmp_path / "b"))
            assert compilation_cache.enable() == tmp_path / "b" and (tmp_path / "b").is_dir()
            monkeypatch.delenv(compilation_cache.ENV)
            assert compilation_cache.enable() == ROOT / "build" / "crossscore_tpu_torch" == _build.BUILD_DIR
            assert _build.library_path("flash_qkv").parent == _build.BUILD_DIR
        finally:
            _build.set_build_dir(None)


@pytest.mark.parametrize("kind", ["bicubic", "align_corners"])
def test_resize_constants_outlive_their_table(kind):
    """The static resizes' device constants, which the daemon's CUDA graphs
    read by address, are made once a key and never evicted, and the list a
    graph keeps (``interpolate.constants()``) holds them through a clearing
    of the table; a resize made after it gives the same bits."""
    src = torch.from_numpy(np.random.default_rng(0).standard_normal((37, 37, 8)).astype(np.float32))
    if kind == "bicubic":
        resize, get = interpolate.interpolate_bicubic, lambda g: interpolate._bicubic_tensor(37, g, src.device)
    else:
        resize = interpolate.interpolate_bilinear_align_corners
        get = lambda g: interpolate._align_corners_tensors(37, g, src.device, src.dtype)  # noqa: E731
    want, first = resize(src, 37, 49), get(49)
    for g in range(1, 160):  # more keys than a bounded cache of 64 holds
        get(g)
    assert get(49) is first
    held = interpolate.constants()
    interpolate._CONSTANTS.clear()
    assert any(t is first for t in held)
    assert torch.equal(resize(src, 37, 49), want) and get(49) is not first


class TestServeArtifacts:
    def test_save_load_same_scores(self, ws, tmp_path, capsys):
        """The exporter saves; a node loads and serves the same scores, with
        every artifact key warm before its first request."""
        art = tmp_path / "serve.aot"
        exporter = _scorer(f"this_main.serve_aot_save={art}")
        assert art.exists() and exporter._aot_keys == set()
        node = _scorer(f"this_main.serve_aot_load={art}")
        assert node._aot_keys == set(exporter._executables) == {(84, 112, 1)}
        assert set(node.compiled_shapes) == node._aot_keys and node.health()["aot_shapes"] == 1
        capsys.readouterr()
        got, want = node.score_path(_query_path()), exporter.score_path(_query_path())
        assert "first dispatch" not in capsys.readouterr().out
        np.testing.assert_array_equal(got["score_map"], want["score_map"])
        assert got["mean_score"] == want["mean_score"]
        assert set(node._executables) == set(exporter._executables)

    def test_config_mismatch_refuses_artifact(self, ws, tmp_path):
        """An artifact of another serving configuration (one reference: another
        token shape) is refused at startup by the field's name."""
        art = tmp_path / "serve.aot"
        _scorer(f"this_main.serve_aot_save={art}")
        with pytest.raises(ValueError, match="token_shape"):
            _scorer("this_main.serve_max_refs=1", f"this_main.serve_aot_load={art}")

    def test_warm_shapes_precompile_and_validate(self, ws):
        s = _scorer("this_main.serve_warm_shapes=[56x70]")
        assert (84, 112, 1) in s.compiled_shapes and (56, 70, 1) in s.compiled_shapes
        with pytest.raises(ValueError, match="%14-trimmed"):
            _scorer("this_main.serve_warm_shapes=[50x70]")

    def test_warmup_only_mode_exits_after_export(self, ws, tmp_path, capsys):
        art = tmp_path / "serve.aot"
        serve(parse_cli("default_predict", OVERRIDES + [f"this_main.serve_aot_save={art}",
                                                        "this_main.serve_warmup_only=true"]))
        out = capsys.readouterr().out
        assert art.exists() and "warmup-only done" in out and "kernels built: none" in out

    def test_load_then_save_reexports_the_union(self, ws, tmp_path):
        a1, a2 = tmp_path / "v1.aot", tmp_path / "v2.aot"
        _scorer(f"this_main.serve_aot_save={a1}")
        _scorer(f"this_main.serve_aot_load={a1}", "this_main.serve_warm_shapes=[56x70]",
                f"this_main.serve_aot_save={a2}")
        d1, d2 = aot.describe(a1), aot.describe(a2)
        assert set(d1["entries"]) < set(d2["entries"]) and "56x70xb1" in d2["entries"]
        assert d2["meta"]["token_shape"] == d1["meta"]["token_shape"]
        node = _scorer(f"this_main.serve_aot_load={a2}")  # the artifact's keys alone
        assert set(node._executables) == node._aot_keys == {(84, 112, 1), (56, 70, 1)}
        node._run_device(np.zeros((1, 56, 70, 3), np.float32), want_map=False)
        assert set(node._executables) == {(84, 112, 1), (56, 70, 1)}

    def test_transposed_ref_grid_is_refused(self, ws, tmp_path):
        """A transposed reference grid gives the same token count; the
        artifact pins the grid, and the node refuses it at startup."""
        art = tmp_path / "serve.aot"
        _scorer(f"this_main.serve_aot_save={art}")
        _rewrite(art, lambda h: h["meta"].update(ref_grid=h["meta"]["ref_grid"][::-1]))
        with pytest.raises(ValueError, match="ref_grid"):
            _scorer(f"this_main.serve_aot_load={art}")

    def test_failed_executable_raises(self, ws, tmp_path):
        """A key whose executable fails raises, whether the artifact listed it
        or this process warmed it: the artifact carries no executable, so its
        keys are captured in process like any other, and nothing falls back."""
        art = tmp_path / "serve.aot"
        exporter = _scorer(f"this_main.serve_aot_save={art}")
        node = _scorer(f"this_main.serve_aot_load={art}")

        class Failing:
            def __init__(self, model):
                self.model = model

            def __call__(self, q):
                raise RuntimeError("replay failed")

        key = (84, 112, 1)
        for sc in (node, exporter):
            sc._executables[key] = [Failing(sc.model)]
            with pytest.raises(RuntimeError, match="replay failed"):
                sc.score_path(_query_path())
        assert node.health()["aot_shapes"] == 1 and exporter.health()["aot_shapes"] == 0

    def test_describe_inventory_without_loading(self, ws, tmp_path, capsys):
        art = tmp_path / "serve.aot"
        _scorer(f"this_main.serve_aot_save={art}")
        d = aot.describe(art)
        assert d["meta"]["token_shape"] == [2, 48, 64] and d["meta"]["ref_grid"] == [6, 8]
        assert d["meta"]["platform"] == "cpu" and d["meta"]["n_devices"] == 1
        assert "params_signature" not in d["meta"] and d["params"] > 50
        assert d["entries"] == {"84x112xb1": {"n_devices": 1}} and d["libraries"] == {}
        capsys.readouterr()
        aot.main([str(art)])
        assert json.loads(capsys.readouterr().out)["entries"] == d["entries"]
