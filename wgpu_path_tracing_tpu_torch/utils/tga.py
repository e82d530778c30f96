"""Truevision TGA decoding in NumPy, the pixels Pillow gives.

The JAX package opens LDR environment maps and textures with Pillow
(``Image.open(...).convert("RGBA")``). Pillow's ``TgaImagePlugin`` has no
signature test: ``Image.open`` tries it on any bytes no earlier format took
(``utils/sniff.py``), and it takes them when the 18-byte header passes its
checks. This module reads what it reads, to the same bytes:

* image types 1 and 9 (colour-mapped, 8-bit indices into a 16- or 24-bit
  map of at most 256 entries whose first ``start`` entries are black, as
  are indices past it), 2 and 10 (true colour: 16-bit ``A1R5G5B5``, 24-bit
  BGR, 32-bit BGRA), 3 and 11 (gray: 1 bit raw only, 8 bits, or 16 bits as
  gray and alpha; a gray image that carries a colour map has its gray
  values looked up in it, the map's alpha included at 8 bits);
* 16-bit colour, in pixels or in the map, widens each 5-bit value as
  ``v * 255 // 31`` and takes alpha 0 where the top bit is SET
  (Pillow's "BGRA;15Z"), 255 where it is clear; 32-bit alpha is kept as it
  is, even when it is 0 everywhere;
* the origin bits: bottom-left (rows stored bottom-up) unless bit 5 is set,
  and bit 4 mirrors each row;
* RLE: a raw packet may run on across the end of a row, as many writers
  emit it, while a run packet that does raises (Pillow's ``TgaRleDecode.c``
  reports a buffer overrun); data that stops short raises; what follows
  the last pixel is ignored.

The run-length decode is a loop a packet: ``rle_plain`` here is the plain
version of ``accel/cbvh/image_scan.cpp``'s ``wpt_tga_rle``, which the
native library runs wherever ``accel.native.native_available()``.

Combinations Pillow refuses (a 32-bit or 15-bit map, a map on a true-colour
or gray image, 8-bit true colour, RLE at 1 bit, ...) raise ``ValueError``
naming the image; a header Pillow's checks reject raises ``NotThisFormat``.
"""

from __future__ import annotations

import struct

import numpy as np

from wgpu_path_tracing_tpu_torch.utils.sniff import NotThisFormat, bomb_check

# (image type & 7, depth) -> Pillow's raw mode (TgaImagePlugin.MODES).
MODES = {(1, 8): "P", (3, 1): "1", (3, 8): "L", (3, 16): "LA",
         (2, 16): "BGRA;15Z", (2, 24): "BGR", (2, 32): "BGRA"}
RLE_STATUS = {1: "the run-length data is truncated",
              2: "a run packet runs past the end of a row (buffer overrun)"}


def widen5(v: np.ndarray) -> np.ndarray:
    """5-bit values to 8 bits as Pillow unpacks them (truncated)."""
    return (v.astype(np.uint32) * 255 // 31).astype(np.uint8)


def bgra15z(raw: np.ndarray) -> np.ndarray:
    """Little-endian 16-bit A1R5G5B5 (..., 2) bytes -> (..., 4) RGBA with
    Pillow's "BGRA;15Z" alpha: 0 where the top bit is set."""
    v = raw[..., 0].astype(np.uint16) | (raw[..., 1].astype(np.uint16) << 8)
    return np.stack([widen5((v >> 10) & 31), widen5((v >> 5) & 31),
                     widen5(v & 31),
                     np.where(v & 0x8000, 0, 255).astype(np.uint8)], -1)


def rle_plain(data: bytes, pos: int, bpp: int, width: int,
              pixels: int) -> tuple[np.ndarray, int]:
    """TGA run-length data from ``pos`` -> (the ``pixels * bpp`` bytes in
    stored order, status): 0, or a key of RLE_STATUS. Raw packets continue
    across rows; a run packet must end within its row."""
    out = bytearray(pixels * bpp)
    row = width * bpp
    x = 0  # bytes into the current row
    done = 0  # bytes of whole rows written
    end = len(data)
    total = pixels * bpp
    while done < total:
        if pos >= end:
            return np.frombuffer(bytes(out), np.uint8), 1
        head = data[pos]
        n = ((head & 0x7F) + 1) * bpp
        if head & 0x80:
            if pos + 1 + bpp > end:
                return np.frombuffer(bytes(out), np.uint8), 1
            if x + n > row:
                return np.frombuffer(bytes(out), np.uint8), 2
            at = done + x
            out[at:at + n] = data[pos + 1:pos + 1 + bpp] * (n // bpp)
            pos += 1 + bpp
            x += n
        else:
            if pos + 1 + n > end:
                return np.frombuffer(bytes(out), np.uint8), 1
            src = pos + 1
            pos += 1 + n
            while n > 0 and done < total:
                take = min(n, row - x)
                at = done + x
                out[at:at + take] = data[src:src + take]
                src += take
                n -= take
                x += take
                if x == row:
                    done += row
                    x = 0
            continue
        if x == row:
            done += row
            x = 0
    return np.frombuffer(bytes(out), np.uint8), 0


def rle_decode(data: bytes, pos: int, bpp: int, width: int, pixels: int,
               name: str) -> np.ndarray:
    """``rle_plain``'s bytes, in C++ wherever the native library builds
    (``accel.native.tga_rle_native``); a failure raises naming the image."""
    from wgpu_path_tracing_tpu_torch.accel import native

    if native.native_available():
        out, status = native.tga_rle_native(data, pos, bpp, width, pixels)
    else:
        out, status = rle_plain(data, pos, bpp, width, pixels)
    if status:
        raise ValueError(f"{name}: {RLE_STATUS[status]}")
    return out


def decode_tga_rgba(data: bytes, name: str = "image") -> np.ndarray:
    """TGA bytes -> (H, W, 4) uint8 RGBA, what Pillow's
    ``Image.open(...).convert("RGBA")`` returns."""
    if len(data) < 18:
        raise NotThisFormat(f"{name}: too short for a TGA header")
    id_len, cmap_type, itype = data[0], data[1], data[2]
    cmap_start, cmap_len, cmap_depth = struct.unpack_from("<HHB", data, 3)
    w, h, depth, flags = struct.unpack_from("<HHBB", data, 12)
    if (cmap_type not in (0, 1) or w == 0 or h == 0
            or depth not in (1, 8, 16, 24, 32)):
        raise NotThisFormat(f"{name}: not a TGA header")
    if itype in (3, 11):
        mode = {1: "1", 16: "LA"}.get(depth, "L")
    elif itype in (1, 9):
        mode = "P" if cmap_type else "L"
    elif itype in (2, 10):
        mode = "RGB" if depth == 24 else "RGBA"
    else:
        raise NotThisFormat(f"{name}: unknown TGA image type {itype}")
    bomb_check(w, h, name)
    pos = min(18 + id_len, len(data))
    palette = None
    if cmap_type:
        size = {16: 2, 24: 3, 32: 4}.get(cmap_depth)
        if size is None:
            raise NotThisFormat(f"{name}: unknown TGA colour-map depth "
                                f"{cmap_depth}")
        raw = data[pos:pos + size * cmap_len]
        pos += len(raw)
        palette = bytes(size * cmap_start) + raw
    rawmode = MODES.get((itype & 7, depth))
    if rawmode is None:
        raise ValueError(f"{name}: Pillow cannot load a TGA of image type "
                         f"{itype} at {depth} bits")
    if palette is not None and (mode not in ("P", "L", "LA")
                                or cmap_depth == 32):
        raise ValueError(f"{name}: Pillow cannot load a TGA colour map of "
                         f"{cmap_depth} bits on an image of mode {mode}")
    if palette is not None and len(palette) > 256 * size:
        raise ValueError(f"{name}: a TGA colour map of more than 256 entries "
                         "(Pillow: invalid palette size)")
    if mode == "L" and rawmode == "P":
        raise ValueError(f"{name}: a colour-mapped TGA without a colour map")
    if depth == 1:
        if itype & 8:
            raise ValueError(f"{name}: Pillow cannot decode a run-length "
                             "TGA at 1 bit")
        stride = (w + 7) // 8
        if len(data) - pos < stride * h:
            raise ValueError(f"{name}: the TGA data is truncated")
        rows = np.frombuffer(data, np.uint8, count=stride * h,
                             offset=pos).reshape(h, stride)
        px = np.where(np.unpackbits(rows, axis=1)[:, :w], 255, 0)
        px = px.astype(np.uint8)[..., None]
    else:
        bpp = depth // 8
        if itype & 8:
            flat = rle_decode(data, pos, bpp, w, w * h, name)
        else:
            if len(data) - pos < w * h * bpp:
                raise ValueError(f"{name}: the TGA data is truncated")
            flat = np.frombuffer(data, np.uint8, count=w * h * bpp,
                                 offset=pos)
        px = flat.reshape(h, w, bpp)
    orientation = flags & 0x30
    if orientation in (0x00, 0x10):  # bottom-left origin: rows bottom-up
        px = px[::-1]
    if orientation in (0x10, 0x30):
        px = px[:, ::-1]
    out = np.full((h, w, 4), 255, np.uint8)
    if palette is not None:  # P, or gray looked up in the map as Pillow does
        k = 2 if cmap_depth == 16 else 3
        entries = np.frombuffer(palette[:256 * k], np.uint8)
        entries = entries[:len(entries) // k * k].reshape(-1, k)
        table = np.zeros((256, 4), np.uint8)
        table[:, 3] = 255
        table[:len(entries)] = (bgra15z(entries) if k == 2 else np.concatenate(
            [entries[:, ::-1], np.full((len(entries), 1), 255, np.uint8)], 1))
        out = table[px[..., 0]]
        if mode == "LA":
            out[..., 3] = px[..., 1]
        return out
    if rawmode == "BGRA;15Z":
        return bgra15z(px)
    if mode in ("1", "L"):
        out[..., :3] = px
    elif mode == "LA":
        out[..., :3] = px[..., :1]
        out[..., 3] = px[..., 1]
    elif mode == "RGB":
        out[..., :3] = px[..., ::-1]
    else:  # BGRA
        out[..., :3] = px[..., 2::-1]
        out[..., 3] = px[..., 3]
    return out
