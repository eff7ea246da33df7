"""Build the CUDA kernels under ``csrc/`` with ``nvcc`` and bind them with ctypes,
and build the host decoder ``csrc/fastimage.cpp`` with ``g++``.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C interface,
``<name>-<hash>.so`` in the build directory, where the hash covers every CUDA
source in ``csrc/`` and the compiler flags, so that one directory can serve
several checkouts. The build directory is :func:`build_dir`:
``build/crossscore_tpu_torch/`` at the repository root unless
``utils/compilation_cache.py::enable`` pointed it elsewhere; it is read at
each build and load. A library is built at its first use; :func:`build_all`
starts one ``nvcc`` per source at once. The host decoder (:func:`build_host`) is hashed on its own
source, its flags and the host CPU (``-march=native``), so that a change to
one side rebuilds neither the other nor a library built for another CPU.
Nothing here runs when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
# the default build directory (git-ignored)
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "crossscore_tpu_torch"
SOURCES = ("flash_qkv", "flash_cross", "attention_modes", "flash_cross_bwd", "fused_ln_mlp", "lane_pad_probe",
           "int8_linear")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# the JAX package's flags for its copy (native/Makefile), so that both copies
# compute the same bits on one machine
GXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-Wall")
GXX_LIBS = ("-lpng", "-lz")

_libs: dict[str, ctypes.CDLL] = {}
_build_dir: Path | None = None  # set by utils/compilation_cache.py::enable
_extra_flags: tuple[str, ...] = ()  # set by tools/xla_flag_sweep.py alone


def build_dir() -> Path:
    """Where libraries are built and loaded from: the directory that
    ``compilation_cache.enable`` set, else :data:`BUILD_DIR`."""
    return BUILD_DIR if _build_dir is None else _build_dir


def set_build_dir(path) -> None:
    """Point every later build and load at ``path`` (None: the default)."""
    global _build_dir
    _build_dir = None if path is None else Path(path).expanduser().resolve()


def set_extra_flags(flags=()) -> None:
    """Add ``flags`` to every later ``nvcc`` command, and into the library
    digest, and forget the loaded libraries, so that the next :func:`load`
    of a source builds or loads its variant. Only the build-flag sweep
    (``tools/xla_flag_sweep.py``) calls this; with no flags the digest and
    the library paths are the default build's."""
    global _extra_flags
    _extra_flags = tuple(flags)
    _libs.clear()


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")
    return nvcc


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + _extra_flags).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return build_dir() / f"{name}-{_digest()}.so"


def build_all(names=SOURCES) -> dict[str, float]:
    """Compile every missing library, one ``nvcc`` per source, all at once.

    Returns the wall seconds of each compile that ran. The ``-Xptxas -v``
    report (registers, shared memory, spills) goes to ``<name>.log`` beside
    the library. Raises if any compile fails."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = open(out_dir / f"{name}.log", "wb")
        cmd = [nvcc, *NVCC_FLAGS, *_extra_flags, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT), tmp, out, log, time.perf_counter())
    secs, failed = {}, []
    for name, (proc, tmp, out, log, t0) in procs.items():
        rc = proc.wait()
        log.close()
        secs[name] = time.perf_counter() - t0
        if rc != 0:
            failed.append(f"{name} (rc {rc}):\n" + (out_dir / f"{name}.log").read_text()[-4000:])
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return secs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if missing."""
    lib = _libs.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build_all((name,))
        lib = ctypes.CDLL(str(path))
        _libs[name] = lib
    return lib


def _cpu_identity() -> bytes:
    """The host CPU's model and feature flags: ``-march=native`` compiles for
    them, so a library built on one CPU is not reused on another."""
    try:
        info = Path("/proc/cpuinfo").read_text().splitlines()
    except OSError:
        return platform.processor().encode()
    keep = [line for line in info if line.startswith(("model name", "flags", "Features", "CPU part"))]
    return "\n".join(dict.fromkeys(keep)).encode()


def host_library_path(name: str = "fastimage") -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS + GXX_LIBS).encode())
    h.update((CSRC / f"{name}.cpp").read_bytes())
    h.update(_cpu_identity())
    return build_dir() / f"{name}-{h.hexdigest()[:16]}.so"


def build_host(name: str = "fastimage") -> tuple[Path, float]:
    """Compile ``csrc/<name>.cpp`` with ``g++`` unless built -> (library, wall
    seconds of the compile, 0 when it was there). Raises with the compiler's
    output when the compile fails (``png.h`` missing among the causes)."""
    out = host_library_path(name)
    if out.exists():
        return out, 0.0
    gxx = shutil.which("g++") or shutil.which("c++")
    if gxx is None:
        raise RuntimeError("g++ not found: the host decoder is built with g++ and libpng")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    res = subprocess.run([gxx, *GXX_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cpp"), *GXX_LIBS],
                         capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {name} (rc {res.returncode}):\n{(res.stdout + res.stderr)[-4000:]}")
    os.replace(tmp, out)
    return out, time.perf_counter() - t0


# dtype codes of the C entry points (csrc/common.cuh)
DTYPE_CODES = {"torch.float32": 0, "torch.bfloat16": 1}


def device_type(x) -> str:
    """"cpu" or "cuda"; raise for any other device."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    return x.device.type


def check_cuda_operands(what: str, *tensors) -> None:
    """Raise unless every tensor is a contiguous, 16-byte aligned CUDA tensor
    of one kernel dtype (float32 or bfloat16) on one device."""
    t0 = tensors[0]
    for t in tensors:
        if t.device.type != "cuda" or t.device != t0.device:
            raise ValueError(f"{what}: operands must share one CUDA device, got {t.device}")
        if str(t.dtype) not in DTYPE_CODES or t.dtype != t0.dtype:
            raise ValueError(f"{what}: operands must all be float32 or bfloat16, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: operands must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: operands must be 16-byte aligned")


def check_rc(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error (``cudaGetLastError``)."""
    if rc != 0:
        fn = lib.cs_error_string
        fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_char_p
        raise RuntimeError(f"{what}: CUDA error {rc}: {fn(rc).decode()}")
