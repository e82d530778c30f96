"""PIXAR raster images in NumPy, the pixels Pillow gives.

Pillow's ``PixarImagePlugin`` reads a 512-byte header after its 4-byte
signature: the width and height as little-endian words at 418 and 416,
and the mode at 424 and 426; only (14, 2) gives a mode ("RGB"), and
every other header leaves none, which passes the bytes on. The pixels are
raw RGB from byte 1,024, rows top-down.
"""

from __future__ import annotations

import struct

import numpy as np

from wgpu_path_tracing_tpu_torch.utils.pilmodes import raw_rows
from wgpu_path_tracing_tpu_torch.utils.sniff import NotThisFormat, bomb_check

MAGIC = b"\200\350\000\000"


def decode_pixar_rgba(data: bytes, name: str = "image") -> np.ndarray:
    """PIXAR bytes -> (H, W, 4) uint8 RGBA, what Pillow's
    ``Image.open(...).convert("RGBA")`` returns."""
    if not data.startswith(MAGIC) or len(data) < 428:
        raise NotThisFormat(f"{name}: not a PIXAR file Pillow reads")
    h, w = struct.unpack_from("<2H", data, 416)
    if struct.unpack_from("<2H", data, 424) != (14, 2) or w == 0 or h == 0:
        raise NotThisFormat(f"{name}: a PIXAR file Pillow gives no mode or "
                            "size")
    bomb_check(w, h, name)
    rows = raw_rows(data, 1024, h, 3 * w, 3 * w, False, name)
    out = np.full((h, w, 4), 255, np.uint8)
    out[..., :3] = rows.reshape(h, w, 3)
    return out
