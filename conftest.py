"""Repository-wide pytest hooks, run before any test module is collected.

The JAX package's decoder (``crossscore_tpu/data/fastimage.py``) builds
``native/libfastimage.so`` with ``make`` at its first use, in every process that
asks for it, with no lock between processes. Under pytest-xdist each worker
imports ``tests/test_fastimage.py``, whose skip condition asks for the library
while the module is collected, so the workers of a fresh checkout race one
build, and a worker that loads the half-written library keeps that failure for
its whole life. Here the controlling process runs the same build once, under a
file lock, before any worker starts: the workers then find the library up to
date and build nothing. Nothing is selected, skipped or deselected here; a
failed build prints one line and the run goes on.
"""

from __future__ import annotations

import fcntl
import os
import subprocess
from pathlib import Path

ROOT = Path(__file__).resolve().parent
NATIVE = ROOT / "native"
LOCK = ROOT / "build" / "native-make.lock"


def _stale(lib: Path, src: Path) -> bool:
    """The JAX decoder's rebuild rule: the library is missing or older than its source."""
    return not lib.exists() or lib.stat().st_mtime < src.stat().st_mtime


def pytest_configure(config):
    if hasattr(config, "workerinput"):  # an xdist worker: the controller has built it
        return
    src, lib = NATIVE / "fastimage.cpp", NATIVE / "libfastimage.so"
    if os.environ.get("CROSSSCORE_NO_NATIVE") or not src.exists() or not _stale(lib, src):
        return
    LOCK.parent.mkdir(parents=True, exist_ok=True)
    with open(LOCK, "w") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        if not _stale(lib, src):  # another session built it while this one waited
            return
        try:
            subprocess.run(["make", "-C", str(NATIVE)], check=True, capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError) as e:
            print(f"conftest: make -C native failed ({type(e).__name__}); the decoder's tests decide for themselves")
