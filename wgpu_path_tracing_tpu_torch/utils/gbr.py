"""GIMP brushes in NumPy, the pixels Pillow gives.

Pillow's ``GbrImagePlugin`` reads a big-endian header (its size, version
1 or 2, width, height, depth 1 or 4; version 2 adds the "GIMP" magic and
the spacing) and a comment up to the header's size; anything else passes
the bytes on (``NotThisFormat``). The pixels follow: depth 1 is mode "L",
depth 4 "RGBA", read whole ("not enough image data" where they are not).
"""

from __future__ import annotations

import struct

import numpy as np

from wgpu_path_tracing_tpu_torch.utils.pilmodes import gray_rgba
from wgpu_path_tracing_tpu_torch.utils.sniff import NotThisFormat, bomb_check


def decode_gbr_rgba(data: bytes, name: str = "image") -> np.ndarray:
    """GIMP brush bytes -> (H, W, 4) uint8 RGBA, what Pillow's
    ``Image.open(...).convert("RGBA")`` returns."""
    if len(data) < 20:
        raise NotThisFormat(f"{name}: not a GIMP brush")
    size, version, w, h, depth = struct.unpack_from(">5I", data)
    if size < 20 or version not in (1, 2) or w == 0 or h == 0 \
            or depth not in (1, 4):
        raise NotThisFormat(f"{name}: not a GIMP brush Pillow reads")
    if version == 2 and (data[20:24] != b"GIMP" or len(data) < 28):
        raise NotThisFormat(f"{name}: not a GIMP brush, bad magic number")
    bomb_check(w, h, name)
    # A version-2 header under 28 bytes makes the comment's read negative:
    # it reads to the end, and no pixels are left.
    start = size if version == 1 or size >= 28 else len(data)
    pixels = data[start:start + w * h * depth]
    if len(pixels) < w * h * depth:
        raise ValueError(f"{name}: not enough image data in the GIMP brush")
    px = np.frombuffer(pixels, np.uint8)
    if depth == 1:
        return gray_rgba(px.reshape(h, w))
    return px.reshape(h, w, 4).copy()
