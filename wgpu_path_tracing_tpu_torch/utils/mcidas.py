"""McIdas area files in NumPy, the pixels Pillow gives.

Pillow's ``McIdasImagePlugin`` reads the 64 big-endian words of the area
descriptor after its 8-byte signature: word 11 gives the bytes a sample,
1 ("L"), 2 ("I;16B") or 4 ("I;32B", read as "I"), anything else and a
descriptor cut short pass the bytes on; the image is word 10 x word 9,
its first row at word 34 + word 15, a row every word 15 + word 10 x word
11 x word 14 bytes (each row led by word 15 bytes of prefix). "I;16B" and
"I" reach RGBA through "L", clipped (70,000 gives 255, -5 gives 0).
"""

from __future__ import annotations

import struct

import numpy as np

from wgpu_path_tracing_tpu_torch.utils.pilmodes import gray8, gray_rgba, raw_rows
from wgpu_path_tracing_tpu_torch.utils.sniff import NotThisFormat, bomb_check

SIGNATURE = b"\x00\x00\x00\x00\x00\x00\x00\x04"
DTYPES = {1: "u1", 2: ">u2", 4: ">i4"}


def decode_mcidas_rgba(data: bytes, name: str = "image") -> np.ndarray:
    """McIdas area bytes -> (H, W, 4) uint8 RGBA, what Pillow's
    ``Image.open(...).convert("RGBA")`` returns."""
    if len(data) < 256 or not data.startswith(SIGNATURE):
        raise NotThisFormat(f"{name}: not a McIdas area file")
    w = (0,) + struct.unpack_from(">64i", data)
    unit = w[11]
    if unit not in DTYPES:
        raise NotThisFormat(f"{name}: unsupported McIdas format ({unit} "
                            "bytes a sample)")
    width, height = w[10], w[9]
    if width <= 0 or height <= 0:
        raise NotThisFormat(f"{name}: a McIdas area of no pixels")
    bomb_check(width, height, name)
    offset = w[34] + w[15]
    stride = w[15] + width * unit * w[14]
    if stride < width * unit:
        raise ValueError(f"{name}: McIdas rows of {stride} bytes cannot hold "
                         f"{width * unit} (Pillow: codec configuration error)")
    rows = raw_rows(data, offset, height, width * unit, stride, False, name)
    values = np.ascontiguousarray(rows).view(np.dtype(DTYPES[unit]))
    return gray_rgba(gray8(values.reshape(height, width)))
