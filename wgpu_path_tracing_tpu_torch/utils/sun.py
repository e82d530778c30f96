"""Sun raster decoding in NumPy, the pixels Pillow gives.

Pillow's ``SunImagePlugin`` reads the 32-byte header (big-endian words:
magic, width, height, depth, length, type, colour-map type, colour-map
length) and the pixels after the colour map; this module reads what it
reads, to the same bytes:

* depth 1 (Pillow's "1;I": a set bit is black), 4 (gray "L;4", each
  nibble times 17), 8 (gray), 24 (BGR, or RGB for type 3) and 32 (BGRX,
  or RGBX for type 3); rows start on 16-bit boundaries, and the last row
  needs only its own bytes, not its padding;
* a colour map of at most 1,024 bytes, of type 1, is planar ("RGB;L":
  every red, then every green, then every blue, ``length // 3`` entries,
  indices past them black) and turns a gray image (4 or 8 bits) into a
  palette one; a map of more than 256 entries, or a map on a 1-, 24- or
  32-bit image, makes Pillow's ``load`` raise (``invalid palette size``,
  ``unrecognized image mode``), and so does this module;
* type 2 is run-length coded (Pillow's C ``sun_rle``): 0x80 0 is a literal
  0x80, 0x80 n v repeats v n + 1 times, any other byte is itself. Pillow
  gives the decoder no stride, so its rows are the pixels' bytes without
  the 16-bit padding, and a run spills on into the next rows: a file
  whose rows carry the padding comes out sheared, as it does in Pillow;
* types 0, 1, 3, 4 and 5 are raw; data that ends before the last pixel
  raises.

A header cut short, an unsupported depth, colour-map length or type, or
file type, and an image of no pixels, are passed on to Pillow's next
formats (``NotThisFormat``), as Pillow's ``SyntaxError`` passes them on.

The run-length loop is ``rle_plain`` here, the plain version of
``accel/cbvh/image_scan.cpp``'s ``wpt_sun_rle``, which the native library
runs wherever ``accel.native.native_available()``.
"""

from __future__ import annotations

import struct

import numpy as np

from wgpu_path_tracing_tpu_torch.utils.sniff import NotThisFormat, bomb_check

MAGIC = 0x59A66A95


def rle_plain(data: bytes, pos: int, size: int) -> tuple[np.ndarray, int]:
    """Pillow's ``ImagingSunRleDecode`` from ``pos`` -> (``size`` bytes,
    status): 0, or 1 where the data ends first (the bytes decoded so far
    and zeros after). Literal bytes are copied a stretch at a time, up to
    the next 0x80."""
    out = bytearray(size)
    at = 0
    n = len(data)
    while at < size:
        if pos >= n:
            return np.frombuffer(bytes(out), np.uint8), 1
        if data[pos] != 0x80:
            end = data.find(b"\x80", pos, pos + size - at)
            end = min(n, pos + size - at) if end < 0 else end
            out[at:at + end - pos] = data[pos:end]
            at += end - pos
            pos = end
            continue
        if pos + 1 >= n:
            return np.frombuffer(bytes(out), np.uint8), 1
        k = data[pos + 1]
        if k == 0:
            out[at] = 0x80
            at += 1
            pos += 2
            continue
        if pos + 2 >= n:
            return np.frombuffer(bytes(out), np.uint8), 1
        run = min(k + 1, size - at)
        out[at:at + run] = bytes([data[pos + 2]]) * run
        at += run
        pos += 3
    return np.frombuffer(bytes(out), np.uint8), 0


def rle_decode(data: bytes, pos: int, size: int, name: str) -> np.ndarray:
    """``rle_plain``'s bytes, in C++ wherever the native library builds
    (``accel.native.sun_rle_native``); data that ends first raises naming
    the image."""
    from wgpu_path_tracing_tpu_torch.accel import native

    if native.native_available():
        out, status = native.sun_rle_native(data, pos, size)
    else:
        out, status = rle_plain(data, pos, size)
    if status:
        raise ValueError(f"{name}: image file is truncated (the Sun "
                         "run-length data ends early)")
    return out


def _samples(rows: np.ndarray, w: int, depth: int) -> np.ndarray:
    """(h, bytes) rows -> (h, w) samples of 1, 4 or 8 bits, or (h, w, 3|4)
    bytes of 24 or 32."""
    h = rows.shape[0]
    if depth == 1:
        return np.unpackbits(rows, axis=1)[:, :w]
    if depth == 4:
        return np.stack([rows >> 4, rows & 15], -1).reshape(h, -1)[:, :w]
    if depth == 8:
        return rows[:, :w]
    return rows[:, :w * depth // 8].reshape(h, w, depth // 8)


def decode_sun_rgba(data: bytes, name: str = "image") -> np.ndarray:
    """Sun raster bytes -> (H, W, 4) uint8 RGBA, what Pillow's
    ``Image.open(...).convert("RGBA")`` returns."""
    if len(data) < 32:
        raise NotThisFormat(f"{name}: the Sun raster header is cut short")
    magic, w, h, depth, _, ftype, ptype, plen = struct.unpack_from(">8I",
                                                                   data)
    if magic != MAGIC:
        raise NotThisFormat(f"{name}: not a Sun raster file")
    if depth not in (1, 4, 8, 24, 32):
        raise NotThisFormat(f"{name}: unsupported Sun raster depth {depth}")
    if plen and (plen > 1024 or ptype != 1):
        raise NotThisFormat(f"{name}: unsupported Sun colour map (type "
                            f"{ptype}, {plen} bytes)")
    if ftype not in (0, 1, 2, 3, 4, 5):
        raise NotThisFormat(f"{name}: unsupported Sun raster type {ftype}")
    if w == 0 or h == 0:
        raise NotThisFormat(f"{name}: a Sun raster of no pixels")
    bomb_check(w, h, name)
    palette = data[32:32 + plen] if plen else None
    if palette is not None and depth not in (4, 8):
        raise ValueError(f"{name}: a colour map on a {depth}-bit Sun raster "
                         "(Pillow: unrecognized image mode)")
    if palette is not None and len(palette) // 3 > 256:
        raise ValueError(f"{name}: a Sun colour map of {len(palette) // 3} "
                         "entries (Pillow: invalid palette size)")
    pos = 32 + plen
    row_bytes = (w * depth + 7) // 8
    if ftype == 2:
        rows = rle_decode(data, pos, h * row_bytes, name).reshape(h, row_bytes)
    else:
        stride = (w * depth + 15) // 16 * 2
        if pos + (h - 1) * stride + row_bytes > len(data):
            raise ValueError(f"{name}: image file is truncated (the Sun "
                             "raster data ends early)")
        buf = np.frombuffer(data, np.uint8)
        at = pos + np.arange(h, dtype=np.int64)[:, None] * stride
        rows = buf[at + np.arange(row_bytes, dtype=np.int64)]
    s = _samples(rows, w, depth)
    out = np.full((h, w, 4), 255, np.uint8)
    if depth == 1:
        out[..., :3] = np.where(s, 0, 255).astype(np.uint8)[..., None]
    elif palette is not None:
        n = len(palette) // 3
        table = np.zeros((256, 3), np.uint8)
        table[:n] = np.frombuffer(palette, np.uint8, count=3 * n).reshape(
            3, n).T
        out[..., :3] = table[s]
    elif depth in (4, 8):
        out[..., :3] = (s * (17 if depth == 4 else 1)).astype(np.uint8)[
            ..., None]
    else:
        out[..., :3] = s[..., :3] if ftype == 3 else s[..., 2::-1]
    return out
