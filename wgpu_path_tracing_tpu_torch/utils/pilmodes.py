"""What Pillow's raw decoder and its conversions to 8 bits do, shared by
the readers of the formats Pillow opens in its 16-bit, 32-bit and float
modes.

* ``raw_rows``: Pillow's ``raw`` decoder reads ``h`` rows of
  ``row_bytes`` from ``offset``, one every ``stride`` bytes (the padding
  between rows is skipped, the last row needs only its own bytes), top
  row first or, with ``bottom_up`` (a negative ``ystep``), bottom row
  first; data that ends before the last row makes ``load`` raise.
* ``gray8``: ``convert`` of modes "I", "I;16", "I;16B" and "F" to "L"
  (and through "L" to "RGB" and "RGBA"): each value clipped to 0..255 and
  truncated, NaN read as 0.
"""

from __future__ import annotations

import numpy as np


def raw_rows(data: bytes, offset: int, h: int, row_bytes: int,
             stride: int, bottom_up: bool, name: str) -> np.ndarray:
    """(h, row_bytes) uint8 rows of the image, top row first."""
    if offset < 0 or offset + (h - 1) * stride + row_bytes > len(data):
        raise ValueError(f"{name}: image file is truncated (the raw data "
                         "ends before the last row)")
    buf = np.frombuffer(data, np.uint8)
    at = offset + np.arange(h, dtype=np.int64)[:, None] * stride
    rows = buf[at + np.arange(row_bytes, dtype=np.int64)]
    return rows[::-1] if bottom_up else rows


def gray8(values: np.ndarray) -> np.ndarray:
    """Samples of an "I", "I;16" or "F" image -> uint8, as ``convert("L")``
    gives them: clipped to 0..255 and truncated, NaN 0."""
    v = np.asarray(values)
    if v.dtype.kind == "f":
        with np.errstate(invalid="ignore"):
            return np.where(np.isnan(v), 0, np.clip(v, 0, 255)).astype(
                np.uint8)
    return np.clip(v.astype(np.int64), 0, 255).astype(np.uint8)


def gray_rgba(gray: np.ndarray) -> np.ndarray:
    """(H, W) uint8 gray -> (H, W, 4) RGBA, alpha 255."""
    out = np.full(gray.shape + (4,), 255, np.uint8)
    out[..., :3] = gray[..., None]
    return out


YCC_PATH = __file__.rsplit("/", 1)[0] + "/pillow_ycc.npz"


def ycc_tables() -> dict:
    """Pillow's YCC tables, read out of Pillow by ``tools/pillow_ycc.py``:
    "YCbCr" -> RGB (``t_r``, ``t_g``, ``t_b``) and Photo CD's PhotoYCC
    (``pcd_L``, ``pcd_CR``, ``pcd_CB``, ``pcd_GR``, ``pcd_GB``)."""
    with np.load(YCC_PATH) as f:
        return {k: f[k].astype(np.int64) for k in f.files}


def ycbcr_to_rgb(ycc: np.ndarray) -> np.ndarray:
    """(..., 3) uint8 Y, Cb, Cr -> (..., 3) uint8 RGB, as Pillow's
    ``convert`` of mode "YCbCr" gives it (``ConvertYCbCr.c``): the luma
    plus a fixed-point table entry of Cr (red), Cb (blue) or both (green),
    clipped."""
    t = ycc_tables()
    y, cb, cr = (ycc[..., k].astype(np.int64) for k in range(3))
    rgb = np.stack([y + t["t_r"][cr], y + t["t_g"][cb, cr],
                    y + t["t_b"][cb]], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)
