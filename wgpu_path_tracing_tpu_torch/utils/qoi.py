"""QOI ("Quite OK Image") decoding, the pixels Pillow gives.

Pillow 12.1.0 decodes QOI with a decoder of its own in Python
(``QoiImagePlugin.QoiDecoder``), which departs from the QOI specification
in ways a file can show; this module copies it op for op:

* the previous pixel starts at (0, 0, 0, 255) and the 64-slot index is
  empty; an ``OP_INDEX`` of an empty slot gives (0, 0, 0, 0);
* every op but ``OP_RUN`` stores its pixel in the index under the hash
  ``(3r + 5g + 7b + 11a) % 64``, alpha included even in a 3-channel file,
  where an ``OP_RGBA`` still moves the (unseen) alpha and the hash;
* a run repeats the previous pixel and may run past the image's end;
* a channels byte other than 3 means RGBA; the colour-space byte and the
  end marker are not read;
* data that ends before the last pixel raises.

The op loop is ``ops_plain`` here, the plain version of
``accel/cbvh/image_scan.cpp``'s ``wpt_qoi``, which the native library runs
wherever ``accel.native.native_available()``.
"""

from __future__ import annotations

import struct

import numpy as np

from wgpu_path_tracing_tpu_torch.utils.sniff import NotThisFormat, bomb_check


def ops_plain(data: bytes, pos: int, pixels: int) -> tuple[np.ndarray, int]:
    """The ops from ``pos`` -> ((pixels, 4) uint8 RGBA, status): 0, or 1
    where the data ends before the last pixel (the pixels decoded so far
    and zeros after)."""
    out = bytearray(4 * pixels)
    index = [None] * 64
    prev = (0, 0, 0, 255)
    n = 0
    end = len(data)
    while n < pixels:
        if pos >= end:
            return np.frombuffer(bytes(out), np.uint8).reshape(-1, 4), 1
        b = data[pos]
        pos += 1
        if b == 0xFE:
            if pos + 3 > end:
                return np.frombuffer(bytes(out), np.uint8).reshape(-1, 4), 1
            value = (data[pos], data[pos + 1], data[pos + 2], prev[3])
            pos += 3
        elif b == 0xFF:
            if pos + 4 > end:
                return np.frombuffer(bytes(out), np.uint8).reshape(-1, 4), 1
            value = tuple(data[pos:pos + 4])
            pos += 4
        elif b >> 6 == 0:
            value = index[b] or (0, 0, 0, 0)
        elif b >> 6 == 1:
            value = ((prev[0] + ((b >> 4) & 3) - 2) % 256,
                     (prev[1] + ((b >> 2) & 3) - 2) % 256,
                     (prev[2] + (b & 3) - 2) % 256, prev[3])
        elif b >> 6 == 2:
            if pos >= end:
                return np.frombuffer(bytes(out), np.uint8).reshape(-1, 4), 1
            second = data[pos]
            pos += 1
            dg = (b & 0x3F) - 32
            value = ((prev[0] + dg + (second >> 4) - 8) % 256,
                     (prev[1] + dg) % 256,
                     (prev[2] + dg + (second & 15) - 8) % 256, prev[3])
        else:
            run = min((b & 0x3F) + 1, pixels - n)
            out[4 * n:4 * (n + run)] = bytes(prev) * run
            n += run
            continue
        prev = value
        r, g, bl, a = value
        index[(r * 3 + g * 5 + bl * 7 + a * 11) % 64] = value
        out[4 * n:4 * n + 4] = bytes(value)
        n += 1
    return np.frombuffer(bytes(out), np.uint8).reshape(-1, 4), 0


def decode_qoi_rgba(data: bytes, name: str = "image") -> np.ndarray:
    """QOI bytes -> (H, W, 4) uint8 RGBA, what Pillow's
    ``Image.open(...).convert("RGBA")`` returns."""
    from wgpu_path_tracing_tpu_torch.accel import native

    if len(data) < 13 or not data.startswith(b"qoif"):
        raise NotThisFormat(f"{name}: not a QOI header")
    w, h = struct.unpack_from(">II", data, 4)
    if w == 0 or h == 0:
        raise NotThisFormat(f"{name}: a QOI image of no pixels")
    bomb_check(w, h, name)
    rgb = data[12] == 3
    if native.native_available():
        px, status = native.qoi_native(data, 14, w * h)
    else:
        px, status = ops_plain(data, 14, w * h)
    if status:
        raise ValueError(f"{name}: the QOI data ends before the last pixel")
    px = px.reshape(h, w, 4)
    if rgb:
        px = px.copy()
        px[..., 3] = 255
    return px
