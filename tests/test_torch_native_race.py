"""The port's tests reach the JAX package's native decoder through
``tests/torch_native.py``, which waits out a sibling process's build of
``native/libfastimage.so`` instead of keeping a failed load. Here six
processes call it at once on a scratch copy of ``native/`` (no library yet)
and of ``crossscore_tpu/data/fastimage.py``: each must get a library. The
repository's own copies are only read."""

import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
N_PROCS = 6

CHILD = r"""
import importlib.util, sys, time
sys.path.insert(0, sys.argv[1])
import torch_native
spec = importlib.util.spec_from_file_location("scratch_fastimage", sys.argv[2])
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
start = float(sys.argv[3])
while time.time() < start:
    time.sleep(0.001)
lib, err = torch_native.jax_native_lib(mod, timeout=60.0)
print("lib" if lib is not None else f"none: {err}")
"""


def test_six_processes_racing_the_first_build_all_get_the_decoder(tmp_path):
    if shutil.which("make") is None or shutil.which("g++") is None:
        pytest.skip("no make or g++ here: the JAX package's decoder cannot build")
    (tmp_path / "native").mkdir()
    for name in ("Makefile", "fastimage.cpp"):
        shutil.copy2(ROOT / "native" / name, tmp_path / "native" / name)
    # fastimage.py finds native/ two directories above its own
    (tmp_path / "pkg" / "data").mkdir(parents=True)
    module = tmp_path / "pkg" / "data" / "fastimage.py"
    shutil.copy2(ROOT / "crossscore_tpu" / "data" / "fastimage.py", module)
    assert not (tmp_path / "native" / "libfastimage.so").exists()

    start = time.time() + 1.5  # every child imports first, then all call at once
    procs = [subprocess.Popen([sys.executable, "-c", CHILD, str(ROOT / "tests"), str(module), repr(start)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(N_PROCS)]
    outs = [p.communicate(timeout=150) for p in procs]
    got = [o.strip() for o, _ in outs]
    assert all(p.returncode == 0 for p in procs), [e[-500:] for _, e in outs]
    assert got == ["lib"] * N_PROCS, got
    assert (tmp_path / "native" / "libfastimage.so").exists()
