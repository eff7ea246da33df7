"""The JAX package's native decoder for the port's tests, steady under
parallel workers.

``crossscore_tpu/data/fastimage.py::get_lib`` builds ``native/libfastimage.so``
with ``make`` on its first call, with no lock between processes, and keeps a
failed load for the life of the process. A fresh checkout has no library (it
is git-ignored), so when several pytest workers call it at once, one of them
can load a half-written file and lose the decoder for every later test.

:func:`jax_native_lib` waits out a sibling's build instead: when ``get_lib()``
returns None it polls, for up to ``timeout`` seconds, until the library loads
in a fresh ``ctypes.CDLL`` attempt, then clears the module's memo under the
module's own lock and calls ``get_lib()`` once more. It starts no build of its
own and touches no file. The outcome is memoised per module, so a process
waits at most once.
"""

from __future__ import annotations

import ctypes
import time

_outcome: dict = {}  # module name -> (lib or None, the last load error)


def jax_native_lib(module=None, timeout: float = 120.0, poll: float = 0.25):
    """(lib, error): ``module.get_lib()`` (default: the JAX package's
    ``crossscore_tpu.data.fastimage``) once any sibling process's build has
    finished; lib is None, with the last load error, when it still fails."""
    if module is None:
        from crossscore_tpu.data import fastimage as module
    if module.__name__ in _outcome:
        return _outcome[module.__name__]
    lib, err = module.get_lib(), None
    if lib is None:
        deadline = time.monotonic() + timeout
        while True:
            try:
                ctypes.CDLL(str(module._SO_PATH))
                err = None
                break
            except OSError as e:  # missing, or still being written
                err = e
            if time.monotonic() >= deadline:
                break
            time.sleep(poll)
        with module._lock:
            module._tried = False
            module._lib = None
        lib = module.get_lib()
        if lib is None and err is None:
            err = "get_lib() returned None after the library loaded"
    _outcome[module.__name__] = (lib, err)
    return lib, err


def require_jax_native() -> None:
    """Skip the calling test, naming the error, when the JAX package's
    decoder cannot be had (:func:`jax_native_lib`)."""
    import pytest

    lib, err = jax_native_lib()
    if lib is None:
        pytest.skip(f"the JAX package's native decoder does not build here: {err}")
