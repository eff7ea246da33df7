"""Serving artifacts: what a node needs to serve warm without a compiler; the
port's counterpart of ``crossscore_tpu/io/aot.py``.

The JAX package's cold start is an XLA compile, and its artifact ships the
daemon's compiled executables. The port's cold start is the ``nvcc`` build of
``csrc/`` (``ops/_build.py``), and its executable per (h, w, bucket) is a
CUDA graph (``tasks/serve.py``), which cannot be serialised: a graph holds
this process's device addresses. So the artifact holds what a node needs in
order to capture the graphs without a compiler:

- ``meta``: the format tag and the environment the libraries were built for
  (``platform``, ``device_name``, ``compute_capability``, ``torch_version``,
  ``cuda_version``, ``kernel_digest``: ``_build._digest()`` of the sources
  and flags), then the caller's fields (the daemon adds ``token_shape``,
  ``ref_grid``, ``params_signature``, ``in_dtype``, ``backbone_quant`` and
  ``n_devices``);
- ``entries``: one per key the caller chooses (the daemon uses JAX's
  ``"{h}x{w}xb{bucket}"``), each with the number of devices its graph runs on;
- ``libraries``: the bytes of each kernel library the serving path loads
  (``<name>-<digest>.so``), each with its sha256.

:func:`load_artifact` checks the format, then every environment field and
every field the caller expects, each mismatch a ``ValueError`` naming the
field and both values, then refuses a library built from other sources, and
writes each library into the build directory (``utils/compilation_cache.py``)
where it is absent, so that ``_build`` loads it and runs no ``nvcc``. The
daemon then captures one graph per entry at warm-up.

Format: a zip archive holding ``header.json`` (format, meta, entries, the
library records) and ``libraries/<file>``. Reading it runs no code.

Trust model: loading an artifact installs shared libraries that the process
then ``dlopen``s, which runs their code. Load only operator-controlled
artifacts from the deployment's own exporter, never user uploads, as the JAX
package says of its pickles.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import threading
import zipfile
from pathlib import Path

from crossscore_tpu_torch.ops import _build

FORMAT = "crossscore-torch-aot-v1"
ENV_FIELDS = ("platform", "device_name", "compute_capability", "torch_version", "cuda_version", "kernel_digest")
_HEADER = "header.json"
_LIBS = "libraries/"
_LIB_FILE = re.compile(r"^([a-z0-9_]+)-([0-9a-f]{16})\.so$")
_KEY = re.compile(r"^\d+x\d+xb\d+$")


def _plain(value):
    """``value`` as it reads back from JSON (tuples become lists)."""
    return json.loads(json.dumps(value))


def env_meta(device=None) -> dict:
    """This process's environment fields for ``device`` (default: the first
    CUDA card if there is one, else the CPU)."""
    import torch

    dev = torch.device(device if device is not None else "cuda" if torch.cuda.is_available() else "cpu")
    if dev.type == "cuda":
        name, cap = torch.cuda.get_device_name(dev), list(torch.cuda.get_device_capability(dev))
    else:
        name, cap = "cpu", None
    return {"platform": "gpu" if dev.type == "cuda" else "cpu", "device_name": name, "compute_capability": cap,
            "torch_version": torch.__version__, "cuda_version": torch.version.cuda,
            "kernel_digest": _build._digest()}


def params_signature(state_dict) -> list[tuple[str, tuple, str]]:
    """Sorted (name, shape, dtype) of a state dict: pins the architecture an
    artifact was exported for (another checkpoint of it still matches)."""
    return sorted((name, tuple(t.shape), str(t.dtype).removeprefix("torch.")) for name, t in state_dict.items())


def key(h: int, w: int, bucket: int) -> str:
    return f"{h}x{w}xb{bucket}"


def parse_key(k: str) -> tuple[int, int, int]:
    if not _KEY.match(k):
        raise ValueError(f"artifact key {k!r} is not of the form HxWxbB")
    h, w, b = (int(x) for x in k.replace("xb", "x").split("x"))
    return h, w, b


def _library_record(path: Path) -> dict:
    m = _LIB_FILE.match(path.name)
    if m is None:
        raise ValueError(f"{path}: a kernel library is named <name>-<16 hex digest>.so")
    data = path.read_bytes()
    return {"name": m.group(1), "file": path.name, "digest": m.group(2), "bytes": len(data),
            "sha256": hashlib.sha256(data).hexdigest()}


def save_artifact(path, entries: dict[str, dict], meta: dict | None = None, libraries=(), device=None) -> None:
    """Write the entries, this process's environment fields with ``meta``
    and the ``libraries`` (paths of built ``<name>-<digest>.so``) atomically:
    through a temporary name unique to the writer, so that concurrent
    exporters of one path never interleave; the last replace wins."""
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    for k in entries:
        parse_key(k)
    libs = [Path(x) for x in libraries]
    header = {"format": FORMAT, "meta": _plain({**env_meta(device), **(meta or {})}), "entries": _plain(entries),
              "libraries": [_library_record(x) for x in libs]}
    tmp = p.with_name(f"{p.name}.tmp.{os.getpid()}.{threading.get_ident()}")
    try:
        with zipfile.ZipFile(tmp, "w", compression=zipfile.ZIP_DEFLATED, compresslevel=1) as zf:
            zf.writestr(_HEADER, json.dumps(header, indent=1))
            for x in libs:
                zf.write(x, _LIBS + x.name)
        tmp.replace(p)
    finally:
        tmp.unlink(missing_ok=True)


def _header(zf: zipfile.ZipFile, path) -> dict:
    try:
        header = json.loads(zf.read(_HEADER))
    except (KeyError, ValueError):
        header = None
    if not isinstance(header, dict) or header.get("format") != FORMAT:
        raise ValueError(f"{path}: not a {FORMAT} artifact")
    return header


def _open(path) -> zipfile.ZipFile:
    try:
        return zipfile.ZipFile(path)
    except zipfile.BadZipFile:
        raise ValueError(f"{path}: not a {FORMAT} artifact") from None


def load_artifact(path, expect_meta: dict | None = None, device=None,
                  max_devices: int | None = None) -> tuple[dict, dict, list]:
    """Check the artifact against this process and install its libraries;
    returns (meta, entries, the library paths this call wrote).

    ``expect_meta``: the caller's fields (for the daemon, its serving
    configuration); a mismatch raises ``ValueError`` naming the field, so an
    operator pointing a node at the wrong artifact gets a diagnosis at
    startup, not a shape error mid-request. ``device``: whose environment to
    check (as :func:`env_meta`). ``max_devices``: the devices this process
    can run an entry on (default: the CUDA cards on ``gpu``, else 1). Each
    library is written into ``_build.build_dir()`` where that file is
    absent, after its sha256 is checked."""
    with _open(path) as zf:
        header = _header(zf, path)
        meta, entries = header["meta"], header["entries"]
        env = _plain(env_meta(device))
        for k in ENV_FIELDS:
            if meta.get(k) != env[k]:
                raise ValueError(f"{path}: artifact was built for {k}={meta.get(k)!r}, this process runs "
                                 f"{k}={env[k]!r} — re-export on matching hardware and sources")
        for k, want in (expect_meta or {}).items():
            if meta.get(k) != _plain(want):
                raise ValueError(f"{path}: artifact {k}={meta.get(k)!r} does not match this serving "
                                 f"configuration ({_plain(want)!r})")
        if max_devices is None:
            import torch

            max_devices = torch.cuda.device_count() if env["platform"] == "gpu" else 1
        for k, entry in entries.items():
            parse_key(k)
            n = int(entry.get("n_devices", 1))
            if n > max_devices:
                raise ValueError(f"{path}: entry {k} runs on {n} devices, this process has {max_devices} — "
                                 f"re-export on a matching topology")
        digest = _build._digest()
        for lib in header["libraries"]:
            m = _LIB_FILE.match(str(lib.get("file")))
            if m is None or m.group(1) != lib.get("name") or m.group(2) != lib.get("digest"):
                raise ValueError(f"{path}: library record {lib.get('file')!r} is malformed")
            if lib["digest"] != digest:
                raise ValueError(f"{path}: library {lib['file']} has digest={lib['digest']!r}, this checkout's "
                                 f"kernel digest is {digest!r} — it was built from other sources")
        installed = []
        out_dir = _build.build_dir()
        out_dir.mkdir(parents=True, exist_ok=True)
        for lib in header["libraries"]:
            dest = out_dir / lib["file"]
            if dest.exists():
                continue
            data = zf.read(_LIBS + lib["file"])
            got = hashlib.sha256(data).hexdigest()
            if got != lib["sha256"]:
                raise ValueError(f"{path}: library {lib['file']} has sha256={got!r}, its record says "
                                 f"sha256={lib['sha256']!r} — the artifact is damaged")
            tmp = dest.with_name(f".{dest.name}.{os.getpid()}.{threading.get_ident()}.tmp")
            try:
                tmp.write_bytes(data)
                tmp.replace(dest)
            finally:
                tmp.unlink(missing_ok=True)
            installed.append(dest)
    return meta, entries, installed


def describe(path) -> dict:
    """The artifact's meta and inventory, with no device and no check
    against this process (usable from any machine)."""
    with _open(path) as zf:
        header = _header(zf, path)
    meta = header["meta"]
    return {
        "meta": {k: v for k, v in meta.items() if k != "params_signature"},
        "params": len(meta.get("params_signature") or []),
        "entries": header["entries"],
        "libraries": {lib["file"]: {k: lib[k] for k in ("bytes", "sha256", "digest")}
                      for lib in header["libraries"]},
    }


def main(argv=None) -> None:
    """``python -m crossscore_tpu_torch.io.aot <artifact>``: print the
    inventory as JSON."""
    import sys

    args = sys.argv[1:] if argv is None else argv
    if len(args) != 1:
        raise SystemExit("usage: python -m crossscore_tpu_torch.io.aot <artifact.aot>")
    print(json.dumps(describe(args[0]), indent=2))


if __name__ == "__main__":
    main()
