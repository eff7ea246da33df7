"""Image and metric-map codecs; the port's own copy of
``crossscore_tpu/io/images.py`` (reference ``utils/io/images.py``).

- RGB images: PNG -> float32 in [0, 1], HWC.
- Metric maps: 16-bit PNG. [0, 1] maps to uint16 via ``/65535``; [-1, 1] via
  ``/32767 - 1`` (encode ``(m + 1) * 32767``, truncated to int, as the
  reference).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
from PIL import Image

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def f32(img: np.ndarray) -> np.ndarray:
    return img.astype(np.float32) / 255.0


def u8(img: np.ndarray) -> np.ndarray:
    return (img * 255.0).astype(np.uint8)


def image_read(path: str | Path) -> np.ndarray:
    """PNG/JPG -> float32 (H, W, 3) in [0, 1]. Drops any alpha channel."""
    img = np.array(Image.open(path))
    if img.ndim == 2:
        img = np.repeat(img[:, :, None], 3, axis=2)
    if img.shape[2] == 4:
        img = img[:, :, :3]
    return f32(img)


def image_read_bytes(data: bytes) -> np.ndarray:
    """Encoded PNG/JPEG bytes (a scoring request's body, a record store's
    payload) or a pre-decoded raw-tensor payload of the decoded record shards
    (``CSRT``, ``data/records.py::encode_raw_payload``) -> float32 (H, W, 3)
    in [0, 1], as :func:`image_read`."""
    import io as _io

    if data[:4] == b"CSRT":
        from crossscore_tpu_torch.data.records import decode_raw_payload

        return f32(decode_raw_payload(data))
    return image_read(_io.BytesIO(data))


def image_write(path: str | Path, img: np.ndarray) -> None:
    """float32 (H, W, 3) in [0, 1] -> PNG."""
    Image.fromarray(u8(np.clip(img, 0.0, 1.0))).save(path)


def _metric_range(m: np.ndarray, vrange) -> np.ndarray:
    vrange = list(vrange)
    if vrange == [0, 1]:
        return m / 65535.0
    if vrange == [-1, 1]:
        return m / 32767.0 - 1.0
    raise ValueError("Invalid range for metric map reading. Must be [0,1] or [-1,1]")


def metric_map_read(path: str | Path, vrange: list | tuple) -> np.ndarray:
    """16-bit PNG -> float32 (H, W) in the requested value range."""
    return _metric_range(np.array(Image.open(path)).astype(np.float32), vrange)


def metric_map_read_bytes(data: bytes, vrange: list | tuple) -> np.ndarray:
    """Encoded 16-bit PNG bytes or a pre-decoded uint16 ``CSRT`` payload ->
    float32 (H, W) in the requested value range, as :func:`metric_map_read`."""
    import io as _io

    if data[:4] == b"CSRT":
        from crossscore_tpu_torch.data.records import decode_raw_payload

        return _metric_range(decode_raw_payload(data).astype(np.float32), vrange)
    return metric_map_read(_io.BytesIO(data), vrange)


def metric_map_write(path: str | Path, m: np.ndarray, vrange: list | tuple) -> None:
    """float32 (H, W) -> 16-bit PNG (truncating-to-int encode, like reference)."""
    vrange = list(vrange)
    if vrange == [0, 1]:
        enc = m * 65535.0
    elif vrange == [-1, 1]:
        enc = (m + 1.0) * 32767.0
    else:
        raise ValueError("Invalid range for metric map writing. Must be [0,1] or [-1,1]")
    enc = np.clip(enc, 0, 65535).astype(np.uint16)
    Image.fromarray(enc, mode="I;16").save(path)


def normalize_imagenet(img: np.ndarray) -> np.ndarray:
    """(..., 3) float32 [0,1] -> ImageNet-normalised."""
    return (img - IMAGENET_MEAN) / IMAGENET_STD


def denormalize_imagenet(img: np.ndarray) -> np.ndarray:
    """(..., 3) ImageNet-normalised -> [0,1]-ish float32."""
    return img * IMAGENET_STD + IMAGENET_MEAN


def to_display_rgb(img: np.ndarray) -> np.ndarray:
    """Batch pixels -> [0,1] float32 for display, whichever wire format the
    loader shipped: raw uint8 (``data.dataset.wire_uint8``) or
    ImageNet-normalised float."""
    img = np.asarray(img)
    if img.dtype == np.uint8:
        return img.astype(np.float32) / 255.0
    return denormalize_imagenet(img)
