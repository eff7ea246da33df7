"""Python client for the scoring daemon (``tasks/serve.py``); the port's own
copy of ``crossscore_tpu/client.py``.

Stdlib HTTP (urllib), numpy, and Pillow to encode an array query. The
programmatic counterpart of the daemon's HTTP API:

    from crossscore_tpu_torch.client import ScoreClient
    c = ScoreClient("http://localhost:8642")
    c.health()["status"]                  # "ok"
    c.score("render.png")                 # {"mean_score": ..., ...}
    m = c.score_map("render.png")         # float32 (H, W) np.ndarray
    c.score_paths(["a.png", "b.png"])     # server-local batch
    c.reload("run/ckpt")                  # weight hot-swap
"""

from __future__ import annotations

import io
import json
import urllib.error
import urllib.request
from pathlib import Path
from typing import Union

import numpy as np

ImageArg = Union[str, Path, bytes, np.ndarray]


class ScoreClientError(RuntimeError):
    """Server-side failure, carrying the daemon's HTTP status and error message."""


class ScoreClient:
    def __init__(self, base_url: str = "http://127.0.0.1:8642", timeout: float = 300.0):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout

    # ------------------------------------------------------------ transport

    def _request(self, method: str, path: str, body: bytes | None = None,
                 ctype: str = "application/octet-stream") -> tuple[bytes, str]:
        req = urllib.request.Request(
            self.base_url + path, data=body, method=method,
            headers={"Content-Type": ctype} if body is not None else {},
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                return r.read(), r.headers.get("Content-Type", "")
        except urllib.error.HTTPError as e:
            detail = e.read().decode(errors="replace")
            try:
                detail = json.loads(detail).get("error", detail)
            except (json.JSONDecodeError, AttributeError):
                pass
            raise ScoreClientError(f"{method} {path} -> {e.code}: {detail}") from None

    def _json(self, method: str, path: str, body: bytes | None = None,
              ctype: str = "application/json"):
        data, _ = self._request(method, path, body, ctype)
        return json.loads(data)

    @staticmethod
    def _image_bytes(image: ImageArg) -> bytes:
        """Accept a path, raw encoded bytes, or a float [0,1] / uint8 HWC
        array (encoded to PNG here; the daemon decodes server-side)."""
        if isinstance(image, (str, Path)):
            return Path(image).read_bytes()
        if isinstance(image, bytes):
            return image
        from PIL import Image

        arr = np.asarray(image)
        if arr.dtype != np.uint8:
            arr = (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format="PNG")
        return buf.getvalue()

    # ------------------------------------------------------------ endpoints

    def health(self) -> dict:
        return self._json("GET", "/healthz")

    def score(self, image: ImageArg) -> dict:
        """Per-frame mean score (the summariser-CSV quantity): one scalar
        fetched from the device, no map transfer."""
        return self._json("POST", "/score", self._image_bytes(image), "application/octet-stream")

    def score_map(self, image: ImageArg) -> np.ndarray:
        """Full float32 (H, W) score map (``?map=npy`` transfer)."""
        data, _ = self._request("POST", "/score?map=npy", self._image_bytes(image))
        return np.load(io.BytesIO(data))

    def score_map_png(self, image: ImageArg) -> bytes:
        """uint16 gray PNG score map (``metric_map_write`` encoding, reference
        ``utils/io/images.py:32-63``), ready to write beside the reference's
        batch outputs."""
        data, _ = self._request("POST", "/score?map=png", self._image_bytes(image))
        return data

    def score_paths(self, paths: list[str]) -> list[dict]:
        """Score server-local files (no upload); results in input order."""
        body = json.dumps({"paths": [str(p) for p in paths]}).encode()
        return self._json("POST", "/score_path", body)

    def reload(self, ckpt: str) -> dict:
        """Weight hot-swap on the daemon."""
        return self._json("POST", "/reload", json.dumps({"ckpt": str(ckpt)}).encode())
