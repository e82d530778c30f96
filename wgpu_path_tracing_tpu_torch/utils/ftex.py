"""FTEX texture decoding in NumPy, the pixels Pillow gives.

Pillow's ``FtexImagePlugin`` reads a little-endian header (magic, version,
width, height, mipmap count, format count, then one format and its
offset) and the first mipmap only; this module reads what it reads, to the
same bytes:

* the format count must be 1: Pillow asserts it, and its
  ``AssertionError`` ends its search, so this module raises;
* the mipmap's size is a 32-bit word at the offset, its data right after
  (a negative size reads to the file's end; a negative offset raises, as
  ``BytesIO.seek`` does);
* format 0 is BC1 (Pillow's C ``bcn`` decoder, ``utils/bcn.py``), format
  1 raw RGB, any other raises;
* a mipmap too short for the image raises.

A header cut short is passed on to Pillow's next formats
(``NotThisFormat``). An image of no pixels is not: Pillow's ``_open`` has
closed the file by then, so the next format's read fails and ends the
search, and this module raises. The BC1 blocks are decoded in C++
(``accel/cbvh/bcn_scan.cpp``) wherever ``accel.native.native_available()``,
else in NumPy (``utils/dds.py::decode_blocks``).
"""

from __future__ import annotations

import struct

import numpy as np

from wgpu_path_tracing_tpu_torch.utils.sniff import NotThisFormat, bomb_check


def decode_ftex_rgba(data: bytes, name: str = "image") -> np.ndarray:
    """FTEX bytes -> (H, W, 4) uint8 RGBA, what Pillow's
    ``Image.open(...).convert("RGBA")`` returns."""
    from wgpu_path_tracing_tpu_torch.utils.dds import decode_blocks

    if len(data) < 24 or not data.startswith(b"FTEX"):
        raise NotThisFormat(f"{name}: the FTEX header is cut short")
    w, h, _, formats = struct.unpack_from("<4i", data, 8)
    if formats != 1:
        raise ValueError(f"{name}: an FTEX file of {formats} formats (Pillow "
                         "asserts 1)")
    if len(data) < 32:
        raise NotThisFormat(f"{name}: the FTEX header is cut short")
    fmt, where = struct.unpack_from("<2i", data, 24)
    if where < 0:
        raise ValueError(f"{name}: negative FTEX mipmap offset {where}")
    if where + 4 > len(data):
        raise NotThisFormat(f"{name}: the FTEX mipmap size is cut short")
    (size,) = struct.unpack_from("<i", data, where)
    mip = data[where + 4:] if size < 0 else data[where + 4:where + 4 + size]
    if fmt not in (0, 1):
        raise ValueError(f"{name}: invalid FTEX texture compression format "
                         f"{fmt}")
    if w <= 0 or h <= 0:
        raise ValueError(f"{name}: an FTEX image of no pixels (Pillow has "
                         "closed the file, so the next format cannot read "
                         "it)")
    bomb_check(w, h, name)
    out = np.full((h, w, 4), 255, np.uint8)
    if fmt == 0:
        out[...] = decode_blocks(mip, 0, "BC1", w, h, name)
    else:
        if len(mip) < 3 * w * h:
            raise ValueError(f"{name}: image file is truncated (the FTEX "
                             "mipmap ends early)")
        out[..., :3] = np.frombuffer(mip, np.uint8, count=3 * w * h
                                     ).reshape(h, w, 3)
    return out
