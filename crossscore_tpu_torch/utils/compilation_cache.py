"""The kernel build cache; counterpart of
``crossscore_tpu/utils/compilation_cache.py``.

The JAX package's cold start is an XLA compile, and its cache is XLA's
persistent compilation cache. The port's cold start is the ``nvcc`` build of
``csrc/`` (``ops/_build.py``), so its cache is the directory the kernel
libraries are built into and loaded from. Libraries are named by the digest
of their sources and flags, so one directory can serve several checkouts.
Call :func:`enable` before the first kernel build or load.
"""

from __future__ import annotations

import os
from pathlib import Path

from crossscore_tpu_torch.ops import _build

ENV = "CROSSSCORE_COMPILE_CACHE"  # the JAX module's own variable


def enable(cache_dir: str | Path | None = None) -> Path:
    """Point the kernel build directory at ``cache_dir``, else at
    ``$CROSSSCORE_COMPILE_CACHE``, else at the default
    ``build/crossscore_tpu_torch/`` of this checkout. Returns the directory."""
    path = cache_dir or os.environ.get(ENV) or None
    _build.set_build_dir(path)
    out = _build.build_dir()
    out.mkdir(parents=True, exist_ok=True)
    return out
