"""SPIDER 2D images in NumPy, the pixels Pillow gives.

Pillow's ``SpiderImagePlugin`` reads 27 floats of header, big-endian
first and then little-endian, and takes the file when ``isSpiderHeader``
passes (integral fields 1, 2, 5, 12, 13, 22 and 23, a known ``iform``,
``labbyt == labrec * lenbyt``); anything else, and an ``iform`` other
than 1 (not a 2D image) or inconsistent stack fields, passes the bytes on
(``NotThisFormat``). The image is ``nsam`` x ``nrow`` floats ("F;32BF" or
"F;32F", the header's byte order) from the header's end, or, in a stack,
the first image after the stack's own header (twice the header length).
An "F" image reaches RGBA through "L": clipped and truncated
(``pilmodes.gray8``).
"""

from __future__ import annotations

import struct

import numpy as np

from wgpu_path_tracing_tpu_torch.utils.pilmodes import gray8, gray_rgba, raw_rows
from wgpu_path_tracing_tpu_torch.utils.sniff import NotThisFormat, bomb_check


def spider_header(t) -> int:
    """SpiderImagePlugin.isSpiderHeader: the header's length, or 0."""
    h = (99,) + tuple(t)

    def is_int(f) -> bool:
        try:
            return f - int(f) == 0
        except (ValueError, OverflowError):
            return False

    if not all(is_int(h[i]) for i in (1, 2, 5, 12, 13, 22, 23)):
        return 0
    if int(h[5]) not in (1, 3, -11, -12, -21, -22):
        return 0
    if int(h[22]) != int(h[13]) * int(h[23]):
        return 0
    return int(h[22])


def decode_spider_rgba(data: bytes, name: str = "image") -> np.ndarray:
    """SPIDER bytes -> (H, W, 4) uint8 RGBA, what Pillow's
    ``Image.open(...).convert("RGBA")`` returns."""
    if len(data) < 108:
        raise NotThisFormat(f"{name}: not a SPIDER file")
    for order in ">", "<":
        t = struct.unpack_from(order + "27f", data)
        hdrlen = spider_header(t)
        if hdrlen:
            break
    else:
        raise NotThisFormat(f"{name}: not a valid SPIDER file")
    h = (99,) + t
    if int(h[5]) != 1:
        raise NotThisFormat(f"{name}: not a SPIDER 2D image")
    w, rows = int(h[12]), int(h[2])
    istack, imgnumber = int(h[24]), int(h[27])
    if istack == 0 and imgnumber == 0:
        offset = hdrlen
    elif istack > 0 and imgnumber == 0:
        offset = 2 * hdrlen
    else:
        # istack 0 with an image number reads ``stkoffset``, which only
        # a seek sets: an AttributeError that ends Pillow's search
        raise ValueError(f"{name}: a SPIDER stack image header (Pillow "
                         "cannot open it alone)")
    if w <= 0 or rows <= 0:
        raise NotThisFormat(f"{name}: a SPIDER image of no pixels")
    bomb_check(w, rows, name)
    raw = raw_rows(data, offset, rows, 4 * w, 4 * w, False, name)
    values = raw.view(np.dtype(order + "f4")).reshape(rows, w)
    return gray_rgba(gray8(values))
