"""ctypes bindings of the host decoder ``csrc/fastimage.cpp``; the port's own
copy of ``crossscore_tpu/data/fastimage.py``.

The library is built with ``g++`` and libpng at its first use
(``ops/_build.py::build_host``, into ``build/crossscore_tpu_torch/``). Where it
cannot be built (no ``png.h``, no ``g++``) :func:`available` is False, with
one warning that quotes the compiler, and the dataset decodes with Pillow.
A native call that fails raises; none of them falls back to Pillow.

``CROSSSCORE_NO_NATIVE`` set to a non-empty value turns the decoder off, as
in the JAX package. The port reads it at every call, so one process can run
both paths (the JAX package reads it at the first call only).

The C calls release the GIL, so the loader's thread pool decodes in
parallel; the reference pays multiprocessing for the same (reference
``config/data/combined_training.yaml:4``).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
import warnings
from typing import Optional

import numpy as np

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None  # why the library could not be built or loaded

# pre-decoded raw-tensor payloads of decoded record shards (data/records.py):
# "CSRT" + u8 version + u8 dtype (0 = u8, 1 = u16) + u8 channels + u8 pad +
# u32le h + u32le w + the C-order tensor bytes. The ``*_bytes`` loaders sniff
# it and skip the PNG inflate: a sample costs a pread and one fused
# crop/normalise pass in C
RAW_MAGIC = b"CSRT"

_INT4 = [ctypes.POINTER(ctypes.c_int)] * 4
_RGB_ARGS = [ctypes.c_int] * 7  # resize_h, resize_w, crop_i, crop_j, crop_h, crop_w, normalize
_METRIC_ARGS = [ctypes.c_int] * 9  # vrange_mode, clamp01, square, resize_h/w, crop_i/j/h/w


def _bind(lib: ctypes.CDLL) -> None:
    fptr = ctypes.POINTER(ctypes.c_float)
    mem = [ctypes.c_char_p, ctypes.c_size_t]
    sigs = {
        "fi_image_info": [ctypes.c_char_p] + _INT4,
        "fi_load_rgb": [ctypes.c_char_p, fptr] + _RGB_ARGS,
        "fi_load_metric": [ctypes.c_char_p, fptr] + _METRIC_ARGS,
        "fi_image_info_mem": mem + _INT4,
        "fi_load_rgb_mem": mem + [fptr] + _RGB_ARGS,
        "fi_load_metric_mem": mem + [fptr] + _METRIC_ARGS,
        "fi_raw_info": mem + _INT4,
        "fi_load_rgb_raw": mem + [fptr] + _RGB_ARGS,
        "fi_load_metric_raw": mem + [fptr] + _METRIC_ARGS,
    }
    for name, args in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, ctypes.c_int


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded decoder, built first if missing; None when it is turned off
    (``CROSSSCORE_NO_NATIVE``) or could not be built (:func:`load_error`)."""
    global _lib, _error
    if os.environ.get("CROSSSCORE_NO_NATIVE"):
        return None
    if _lib is not None or _error is not None:
        return _lib
    with _lock:
        if _lib is None and _error is None:
            from crossscore_tpu_torch.ops import _build

            try:
                path, _ = _build.build_host("fastimage")
                lib = ctypes.CDLL(str(path))
                _bind(lib)
                _lib = lib
            except (RuntimeError, OSError, AttributeError, subprocess.SubprocessError) as e:
                _error = str(e)
                warnings.warn(f"native decoder unavailable, decoding with Pillow: {_error}", RuntimeWarning,
                              stacklevel=2)
    return _lib


def available() -> bool:
    return get_lib() is not None


def load_error() -> Optional[str]:
    """The build or load error of the decoder, or None."""
    get_lib()
    return _error


def _need() -> ctypes.CDLL:
    lib = get_lib()
    if lib is None:
        raise RuntimeError("fastimage unavailable")
    return lib


def payload_is_raw(data: bytes) -> bool:
    return data[:4] == RAW_MAGIC


def _info(fn, *args) -> tuple[int, int, int, int]:
    h, w, c, b = (ctypes.c_int() for _ in range(4))
    rc = fn(*args, h, w, c, b)
    if rc:
        raise IOError(f"{fn.__name__} failed rc={rc}")
    return h.value, w.value, c.value, b.value


def image_info(path: str) -> tuple[int, int, int, int]:
    """(h, w, channels, bit depth) from the PNG header alone."""
    return _info(_need().fi_image_info, str(path).encode())


def image_info_bytes(data: bytes) -> tuple[int, int, int, int]:
    """:func:`image_info` of a PNG payload or a ``CSRT`` payload."""
    lib = _need()
    return _info(lib.fi_raw_info if payload_is_raw(data) else lib.fi_image_info_mem, data, len(data))


def _geometry(resize_hw, crop, info) -> tuple[tuple[int, int, int, int], tuple[int, int]]:
    """The C call's (crop_i, crop_j, crop_h, crop_w) arguments and the output
    (h, w): the crop, else the resize, else the image's own size."""
    if crop:
        ci, cj, ch, cw = crop
        return (ci, cj, ch, cw), (ch, cw)
    if resize_hw:
        return (0, 0, 0, 0), tuple(resize_hw)
    h, w, _, _ = info()
    return (0, 0, 0, 0), (h, w)


def _fptr(out: np.ndarray):
    return out.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def load_rgb(path: str, resize_hw: Optional[tuple[int, int]] = None,
             crop: Optional[tuple[int, int, int, int]] = None, normalize: bool = True,
             out: Optional[np.ndarray] = None, as_uint8: bool = False) -> np.ndarray:
    """Fused decode (+ resize) (+ crop) (+ ImageNet normalisation) -> float32
    (H, W, 3).

    ``as_uint8=True`` (over ``normalize``) returns raw uint8 pixels, the
    wire-compact loader path (the model normalises on the device). Without a
    resize the crop is byte-exact; with one, the bilinear output is
    re-quantised to 8 bits (within 0.5/255)."""
    lib = _need()
    rh, rw = resize_hw if resize_hw else (0, 0)
    crop_args, (ch, cw) = _geometry(resize_hw, crop, lambda: image_info(path))
    if out is None:
        out = np.empty((ch, cw, 3), np.uint8 if as_uint8 else np.float32)
    rc = lib.fi_load_rgb(str(path).encode(), _fptr(out), rh, rw, *crop_args, 2 if as_uint8 else int(normalize))
    if rc:
        raise IOError(f"fi_load_rgb({path}) failed rc={rc}")
    return out


def load_rgb_bytes(data: bytes, resize_hw: Optional[tuple[int, int]] = None,
                   crop: Optional[tuple[int, int, int, int]] = None, normalize: bool = True,
                   out: Optional[np.ndarray] = None, as_uint8: bool = False) -> np.ndarray:
    """:func:`load_rgb` of an in-memory PNG payload or a ``CSRT`` payload
    (record shards)."""
    lib = _need()
    rh, rw = resize_hw if resize_hw else (0, 0)
    crop_args, (ch, cw) = _geometry(resize_hw, crop, lambda: image_info_bytes(data))
    if out is None:
        out = np.empty((ch, cw, 3), np.uint8 if as_uint8 else np.float32)
    fn = lib.fi_load_rgb_raw if payload_is_raw(data) else lib.fi_load_rgb_mem
    rc = fn(data, len(data), _fptr(out), rh, rw, *crop_args, 2 if as_uint8 else int(normalize))
    if rc:
        raise IOError(f"load_rgb_bytes failed rc={rc}")
    return out


def load_metric(path: str, vrange: list, clamp01: bool = False, square: bool = False,
                resize_hw: Optional[tuple[int, int]] = None, crop: Optional[tuple[int, int, int, int]] = None,
                out: Optional[np.ndarray] = None) -> np.ndarray:
    """Fused 16-bit metric-map decode (+ transforms) -> float32 (H, W)."""
    lib = _need()
    rh, rw = resize_hw if resize_hw else (0, 0)
    crop_args, (ch, cw) = _geometry(resize_hw, crop, lambda: image_info(path))
    if out is None:
        out = np.empty((ch, cw), np.float32)
    rc = lib.fi_load_metric(str(path).encode(), _fptr(out), 0 if list(vrange) == [0, 1] else 1, int(clamp01),
                            int(square), rh, rw, *crop_args)
    if rc:
        raise IOError(f"fi_load_metric({path}) failed rc={rc}")
    return out


def load_metric_bytes(data: bytes, vrange: list, clamp01: bool = False, square: bool = False,
                      resize_hw: Optional[tuple[int, int]] = None,
                      crop: Optional[tuple[int, int, int, int]] = None,
                      out: Optional[np.ndarray] = None) -> np.ndarray:
    """:func:`load_metric` of an in-memory PNG payload or a ``CSRT`` payload."""
    lib = _need()
    rh, rw = resize_hw if resize_hw else (0, 0)
    crop_args, (ch, cw) = _geometry(resize_hw, crop, lambda: image_info_bytes(data))
    if out is None:
        out = np.empty((ch, cw), np.float32)
    fn = lib.fi_load_metric_raw if payload_is_raw(data) else lib.fi_load_metric_mem
    rc = fn(data, len(data), _fptr(out), 0 if list(vrange) == [0, 1] else 1, int(clamp01), int(square),
            rh, rw, *crop_args)
    if rc:
        raise IOError(f"load_metric_bytes failed rc={rc}")
    return out
