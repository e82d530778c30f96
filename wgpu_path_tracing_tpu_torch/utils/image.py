"""Image output and comparison.

The counterpart of the JAX package's ``utils/image.py``. The accumulation
buffer's row 0 is the BOTTOM of the view, so the display image is flipped.
The PNG writer uses only the standard library (``zlib`` + ``struct``).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch


def buffer_to_srgb(accum, width: int, height: int, exposure: float = 1.0):
    """HDR accumulation (N, 3) -> display-referred (H, W, 3) float32 NumPy in
    [0, 1], top row first."""
    from wgpu_path_tracing_tpu_torch.ops import tonemap

    hdr = torch.as_tensor(np.asarray(accum, np.float32)).reshape(height, width, 3)
    img = tonemap.display_transform(hdr, exposure).numpy()
    img = np.nan_to_num(img, nan=0.0, posinf=1.0, neginf=0.0)
    img = np.clip(img, 0.0, 1.0)
    return img[::-1]


def encode_png(img01: np.ndarray) -> bytes:
    """(H, W, 3) float in [0, 1], top row first -> 8-bit RGB PNG bytes."""
    data = (np.clip(img01, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    h, w = data.shape[0], data.shape[1]
    raw = b"".join(b"\x00" + data[y].tobytes() for y in range(h))

    def chunk(tag: bytes, payload: bytes) -> bytes:
        body = tag + payload
        return (struct.pack(">I", len(payload)) + body
                + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6))
            + chunk(b"IEND", b""))


def write_png(path: str, img01: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img01))


def rmse(a: np.ndarray, b: np.ndarray) -> float:
    """Root-mean-square error between two [0, 1] images of equal shape."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch {a.shape} vs {b.shape}")
    return float(np.sqrt(np.mean((a - b) ** 2)))


def write_hdr(path: str, hdr: np.ndarray) -> None:
    """Radiance RGBE .hdr (linear, no tonemap), flat scanlines.
    hdr: (H, W, 3) float32, top row first."""
    hdr = np.asarray(hdr, np.float32)
    h, w = hdr.shape[0], hdr.shape[1]
    maxc = np.maximum(hdr.max(axis=2), 1e-32)
    exp = np.ceil(np.log2(maxc)).astype(np.int32) + 1
    scale = np.exp2(exp.astype(np.float32) - 8.0)
    rgbe = np.zeros((h, w, 4), np.uint8)
    mantissa = np.clip(hdr / scale[..., None] + 0.5, 0.0, 255.0).astype(np.uint8)
    rgbe[..., 0:3] = mantissa
    rgbe[..., 3] = np.clip(exp + 128, 0, 255).astype(np.uint8)
    rgbe[maxc <= 1e-32] = 0
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())
