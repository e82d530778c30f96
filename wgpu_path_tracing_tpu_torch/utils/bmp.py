"""Windows BMP, DIB, ICO and CUR decoding in NumPy, the pixels Pillow gives.

The JAX package opens LDR environment maps and textures with Pillow
(``Image.open(...).convert("RGBA")``). This module reads what Pillow
12.1.0's ``BmpImagePlugin``, ``IcoImagePlugin`` and ``CurImagePlugin``
read, to the same bytes, with their rules as they are:

* headers of 12 (OS/2 core: 16-bit sizes, 3-byte palette entries), 40,
  52, 56, 64, 108 and 124 bytes; a height whose top byte is 0xFF is a
  top-down image; a file offset that points right after the header while
  the palette lies there is moved past ``4 * colors`` bytes;
* 1, 4 and 8 bits through a palette of ``colors`` entries (or ``1 <<
  bits``; more than 256 raise), entries past it black. A palette of
  exactly black and white (two entries) or of gray ramp entries (``i`` at
  ``i``) is dropped and the bits read as 1-bit or 8-bit gray, as Pillow
  drops it;
* 16 bits as 5-5-5 (or 5-6-5 under those ``BI_BITFIELDS`` masks), each
  widened as ``v * 255 // 31`` (``// 63`` for 6 bits); 24 bits BGR; 32 bits BGR with the fourth byte dropped, except
  under ``BI_BITFIELDS`` masks that name an alpha byte (the all-zero masks
  too), and in a cursor whose bitmap starts at byte 22;
* ``BI_RLE8`` and ``BI_RLE4`` as Pillow's Python decoder reads them: runs
  clipped at the row's end, an end-of-line escape that pads with index 0,
  a delta escape that reads two bytes and then takes the NEXT two as its
  right and up steps, absolute runs aligned to 16 bits by the position in
  the file, and an odd absolute RLE4 run that loses its last pixel;
* ICO: the first frame after sorting by colour depth, then (stably) by
  area, largest first, which is the largest frame of the least depth; a
  PNG frame through ``utils/image.py::decode_png_rgba``; a BMP frame of
  half its stated height, with alpha from its 32-bit pixels' fourth bytes
  when the directory says 32 bits, else from the AND mask after it (rows
  padded to 32 bits, placed by the directory's size), both read
  bottom-up; CUR: the first entry, or a later one both wider and taller
  (by the directory's width and height bytes), with no mask.

``BI_JPEG``, ``BI_PNG``, ``BI_ALPHABITFIELDS`` and other masks raise
``ValueError`` naming the image, as Pillow refuses them. The run-length
loop is ``rle_plain`` here, the plain version of ``accel/cbvh/
image_scan.cpp``'s ``wpt_bmp_rle``, which the native library runs wherever
``accel.native.native_available()``.
"""

from __future__ import annotations

import math
import struct
from dataclasses import dataclass

import numpy as np

from wgpu_path_tracing_tpu_torch.utils.sniff import NotThisFormat, bomb_check

HEADER_SIZES = (12, 40, 52, 56, 64, 108, 124)
BIT2MODE = {1: ("P", "P;1"), 4: ("P", "P;4"), 8: ("P", "P"),
            16: ("RGB", "BGR;15"), 24: ("RGB", "BGR"), 32: ("RGB", "BGRX")}
MASK_MODES = {
    (32, (0xFF0000, 0xFF00, 0xFF, 0x0)): "BGRX",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0x0)): "XBGR",
    (32, (0xFF000000, 0xFF00, 0xFF, 0x0)): "BGXR",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0xFF)): "ABGR",
    (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)): "RGBA",
    (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)): "BGRA",
    (32, (0xFF000000, 0xFF00, 0xFF, 0xFF0000)): "BGAR",
    (32, (0x0, 0x0, 0x0, 0x0)): "BGRA",
    (24, (0xFF0000, 0xFF00, 0xFF)): "BGR",
    (16, (0xF800, 0x7E0, 0x1F)): "BGR;16",
    (16, (0x7C00, 0x3E0, 0x1F)): "BGR;15",
}
RAW, RLE8, RLE4, BITFIELDS = 0, 1, 2, 3
# Bits a pixel of each raw mode: Pillow's raw decoder reads a row's bytes
# by the raw mode, not by the header's bit count.
RAW_BITS = {"1": 1, "P;1": 1, "P;4": 4, "P": 8, "L": 8, "BGR;15": 16,
            "BGR;16": 16, "BGR": 24}
PNG_MAGIC = b"\x89PNG\r\n\x1a\n"


@dataclass
class Bitmap:
    """What ``BmpImageFile._bitmap`` sets up: the image's mode, the raw
    mode its pixels are unpacked with, its size, the decoder ("raw" or
    "rle"), the row stride, the direction (-1 bottom-up), the data's
    offset, the palette (N, 3) and the bit count."""
    mode: str
    rawmode: str
    width: int
    height: int
    decoder: str
    rle4: bool
    stride: int
    direction: int
    offset: int
    palette: np.ndarray | None
    bits: int


def _u32(data: bytes, at: int, name: str) -> int:
    if at + 4 > len(data):
        raise ValueError(f"{name}: the bitmap header is truncated")
    return struct.unpack_from("<I", data, at)[0]


def parse_bitmap(data: bytes, pos: int, offset: int, name: str,
                 cursor22: bool = False) -> Bitmap:
    """``_bitmap`` on the info header at ``pos``: ``offset`` is the file
    header's data offset (0 for a DIB: the data follows the palette).
    Where Pillow's ``_open`` would pass the bytes on to its next format (a
    header size or masks cut short, an empty image), raises
    ``NotThisFormat``."""
    if pos + 4 > len(data):
        raise NotThisFormat(f"{name}: no bitmap header")
    hsize = struct.unpack_from("<I", data, pos)[0]
    if hsize not in HEADER_SIZES:
        raise ValueError(f"{name}: unsupported BMP header type ({hsize})")
    if pos + hsize > len(data):
        raise ValueError(f"{name}: the bitmap header is truncated")
    hd = data[pos + 4:pos + hsize]
    cur = pos + hsize
    direction = -1
    masks = None
    if hsize == 12:
        width, height, _, bits = struct.unpack_from("<HHHH", hd)
        compression, colors, padding = RAW, 0, 3
    else:
        flip = hd[7] == 0xFF
        direction = 1 if flip else -1
        width, height = struct.unpack_from("<II", hd)
        if flip:
            height = 2 ** 32 - height
        bits, compression = struct.unpack_from("<HI", hd, 10)
        colors = struct.unpack_from("<I", hd, 28)[0]
        padding = 4
        if compression == BITFIELDS:
            if len(hd) >= 48:
                rgb = struct.unpack_from("<3I", hd, 36)
                alpha = struct.unpack_from("<I", hd, 48)[0] if len(hd) >= 52 else 0
            else:
                if cur + 12 > len(data):
                    raise NotThisFormat(f"{name}: the bitmap masks are cut "
                                        "short")
                rgb, alpha = struct.unpack_from("<3I", data, cur), 0
                cur += 12
            masks = (tuple(rgb), tuple(rgb) + (alpha,))
    colors = colors or (1 << bits)
    if offset == 14 + hsize and bits <= 8:
        offset += 4 * colors
    if bits not in BIT2MODE:
        raise ValueError(f"{name}: unsupported BMP pixel depth ({bits})")
    mode, rawmode = BIT2MODE[bits]
    decoder = "raw"
    if compression == BITFIELDS:
        rgb_mask, rgba_mask = masks
        key = (bits, rgba_mask if bits == 32 else rgb_mask)
        if key not in MASK_MODES:
            raise ValueError(f"{name}: unsupported BMP bitfields layout")
        rawmode = MASK_MODES[key]
        if "A" in rawmode:
            mode = "RGBA"
    elif compression == RAW:
        if bits == 32 and cursor22:
            rawmode, mode = "BGRA", "RGBA"
    elif compression in (RLE8, RLE4):
        decoder = "rle"
    else:
        raise ValueError(f"{name}: unsupported BMP compression "
                         f"({compression})")
    palette = None
    if mode == "P":
        if not 0 < colors <= 65536:
            raise ValueError(f"{name}: unsupported BMP palette size ({colors})")
        raw = data[cur:cur + padding * colors]
        cur += len(raw)
        indices = (0, 255) if colors == 2 else range(colors)
        gray = all(raw[i * padding:i * padding + 3] == bytes([v & 255]) * 3
                   for i, v in enumerate(indices))
        if gray:
            mode = rawmode = "1" if colors == 2 else "L"
        else:
            n = len(raw) // padding  # what the file holds of it
            if n > 256:
                raise ValueError(f"{name}: a BMP palette of {n} colours "
                                 "(Pillow: invalid palette size)")
            palette = np.frombuffer(raw[:n * padding], np.uint8).reshape(
                n, padding)[:, 2::-1]
    if width <= 0 or height <= 0:
        raise NotThisFormat(f"{name}: bitmap size {width}x{height} is empty")
    bomb_check(width, height, name)
    stride = ((width * bits + 31) >> 3) & ~3
    return Bitmap(mode, rawmode, width, height, decoder, compression == RLE4,
                  stride, direction, offset or cur, palette, bits)


def rle_plain(data: bytes, pos: int, rle4: bool, width: int,
              count: int) -> tuple[bytes, int]:
    """``BmpRleDecoder.decode``: (one index a pixel, row after row in
    stored order, until ``count`` pixels, the end of the data or an
    end-of-bitmap escape: at most the first ``count``; status 1 where a
    delta escape is cut short, on which Pillow raises, else 0)."""
    out = bytearray()
    x = 0
    end = len(data)
    while len(out) < count:
        if pos + 2 > end:
            break
        n, byte = data[pos], data[pos + 1]
        pos += 2
        if n:
            if x + n > width:
                n = max(0, width - x)
            n = min(n, count - len(out))
            if rle4:
                pair = bytes([byte >> 4, byte & 0x0F])
                out += (pair * ((n + 1) // 2))[:n]
            else:
                out += bytes([byte]) * n
            x += n
        elif byte == 0:  # end of line
            out += bytes(min(-len(out) % width, count - len(out)))
            x = 0
        elif byte == 1:  # end of bitmap
            break
        elif byte == 2:  # delta: two bytes skipped, the next two read
            if pos + 2 > end:
                break
            pos += 2
            if pos + 2 > end:
                return bytes(out[:count]), 1
            right, up = data[pos], data[pos + 1]
            pos += 2
            out += bytes(min(right + up * width, count - len(out)))
            x = len(out) % width
        else:  # absolute run
            if rle4:
                k = byte // 2
                got = data[pos:pos + k]
                for b in got:
                    out += bytes([b >> 4, b & 0x0F])
            else:
                k = byte
                got = data[pos:pos + k]
                out += got
            pos += len(got)
            if len(got) < k:
                break
            x += byte
            if pos % 2:
                pos += 1
    return bytes(out[:count]), 0


def _rle_pixels(data: bytes, bm: Bitmap, rows: int, name: str) -> np.ndarray:
    from wgpu_path_tracing_tpu_torch.accel import native

    if bm.mode not in ("P", "L"):
        raise ValueError(f"{name}: Pillow cannot unpack a run-length BMP "
                         f"into mode {bm.mode}")
    count = bm.width * rows
    if native.native_available():
        out, status = native.bmp_rle_native(data, bm.offset, bm.rle4,
                                            bm.width, count)
    else:
        out, status = rle_plain(data, bm.offset, bm.rle4, bm.width, count)
    if status:
        raise ValueError(f"{name}: a BMP delta escape is cut short")
    if len(out) < count:
        raise ValueError(f"{name}: not enough run-length BMP data")
    return np.frombuffer(out, np.uint8, count=count).reshape(rows, bm.width)


def _widen(v: np.ndarray, bits: int) -> np.ndarray:
    """``bits``-bit values to 8 bits as Pillow unpacks them (truncated)."""
    return (v.astype(np.uint32) * 255 // ((1 << bits) - 1)).astype(np.uint8)


def _unpack_rows(rows: np.ndarray, bm: Bitmap) -> np.ndarray:
    """(rows, stride) bytes -> (rows, width, c) values by the raw mode."""
    w, raw = bm.width, bm.rawmode
    if raw in ("1", "P;1", "P;4"):
        bits = np.unpackbits(rows, axis=1)
        if raw == "P;4":
            nib = bits[:, :4 * w].reshape(len(rows), w, 4)
            return (nib * np.array([8, 4, 2, 1], np.uint8)).sum(
                -1, dtype=np.uint8)[..., None]
        px = bits[:, :w]
        return (px * 255 if raw == "1" else px)[..., None]
    size = RAW_BITS.get(raw, 32) // 8
    px = rows[:, :w * size].reshape(len(rows), w, size)
    if size == 1:
        return px
    if size == 2:
        v = px[..., 0].astype(np.uint16) | (px[..., 1].astype(np.uint16) << 8)
        if raw == "BGR;15":
            r, g, b = _widen((v >> 10) & 31, 5), _widen((v >> 5) & 31, 5), \
                _widen(v & 31, 5)
        else:
            r, g, b = _widen(v >> 11, 5), _widen((v >> 5) & 63, 6), \
                _widen(v & 31, 5)
        return np.stack([r, g, b], -1)
    order = {"BGR": (2, 1, 0), "BGRX": (2, 1, 0), "XBGR": (3, 2, 1),
             "BGXR": (3, 1, 0), "ABGR": (3, 2, 1, 0), "RGBA": (0, 1, 2, 3),
             "BGRA": (2, 1, 0, 3), "BGAR": (3, 1, 0, 2)}[raw]
    return px[..., list(order)]


def decode_bitmap(data: bytes, bm: Bitmap, rows: int,
                  name: str) -> np.ndarray:
    """The first ``rows`` rows of a parsed bitmap as (rows, W, 4) RGBA,
    top row first, what ``convert("RGBA")`` gives."""
    if bm.decoder == "rle":
        px = _rle_pixels(data, bm, rows, name)[..., None]
    else:
        # Pillow's raw decoder skips the padding between rows, so the last
        # row needs no padding.
        line = (bm.width * RAW_BITS.get(bm.rawmode, 32) + 7) // 8
        if line > bm.stride:
            raise ValueError(f"{name}: rows of {bm.stride} bytes cannot hold "
                             f"{bm.width} pixels of raw mode {bm.rawmode} "
                             "(Pillow refuses them)")
        need = bm.stride * (rows - 1) + line
        if bm.offset < 0 or len(data) - bm.offset < need:
            raise ValueError(f"{name}: the bitmap data is truncated")
        raw = np.zeros((rows, bm.stride), np.uint8)
        raw.reshape(-1)[:need] = np.frombuffer(data, np.uint8, count=need,
                                               offset=bm.offset)
        px = _unpack_rows(raw, bm)
    if bm.direction < 0:
        px = px[::-1]
    out = np.full((rows, bm.width, 4), 255, np.uint8)
    if bm.mode == "P":
        table = np.zeros((256, 3), np.uint8)
        table[:len(bm.palette)] = bm.palette[:256]
        out[..., :3] = table[px[..., 0]]
    elif px.shape[-1] == 1:
        out[..., :3] = px
    else:
        out[..., :px.shape[-1]] = px if bm.mode == "RGBA" else px[..., :3]
    return out


def decode_bmp_rgba(data: bytes, name: str = "image") -> np.ndarray:
    """BMP bytes (``BM`` and a file header) -> (H, W, 4) uint8 RGBA."""
    if data[:2] != b"BM":
        raise NotThisFormat(f"{name}: not a BMP file")
    offset = _u32(data, 10, name)
    bm = parse_bitmap(data, 14, offset, name)
    return decode_bitmap(data, bm, bm.height, name)


def decode_dib_rgba(data: bytes, name: str = "image") -> np.ndarray:
    """A bare DIB (an info header first) -> (H, W, 4) uint8 RGBA."""
    bm = parse_bitmap(data, 0, 0, name)
    return decode_bitmap(data, bm, bm.height, name)


def _directory(data: bytes, magic: bytes, name: str) -> list:
    """The 16-byte entries (the last maybe cut short) after an ICO or CUR
    header; none passes the bytes on, as Pillow's IndexError or TypeError
    does."""
    if data[:4] != magic or len(data) < 6:
        raise NotThisFormat(f"{name}: not an icon or cursor")
    n = struct.unpack_from("<H", data, 4)[0]
    out = [data[6 + 16 * i:22 + 16 * i] for i in range(n)]
    if not out:
        raise NotThisFormat(f"{name}: an icon or cursor without entries")
    return out


def decode_ico_rgba(data: bytes, name: str = "image") -> np.ndarray:
    """ICO bytes -> (H, W, 4) uint8 RGBA of the frame Pillow opens."""
    from wgpu_path_tracing_tpu_torch.utils.image import decode_png_rgba

    heads = []
    for s in _directory(data, b"\0\0\1\0", name):
        if len(s) < 16:
            raise NotThisFormat(f"{name}: the icon directory is cut short")
        w, h, nb_color = s[0] or 256, s[1] or 256, s[2]
        bpp, size, offset = struct.unpack_from("<HII", s, 6)
        depth = bpp or (nb_color != 0 and math.ceil(math.log(nb_color, 2))) or 256
        heads.append((w * h, depth, bpp, size, offset))
    heads.sort(key=lambda e: e[1])
    heads.sort(key=lambda e: e[0], reverse=True)
    _, _, bpp, size, offset = heads[0]
    if data[offset:offset + 8] == PNG_MAGIC:
        return decode_png_rgba(data[offset:], name)
    bm = parse_bitmap(data, offset, 0, name)
    rows = int(bm.height / 2)
    bm.height = rows
    out = decode_bitmap(data, bm, rows, name)
    w = bm.width
    if bpp == 32:
        alpha = data[bm.offset:bm.offset + w * rows * 4][3::4]
        if len(alpha) < w * rows:
            raise ValueError(f"{name}: the icon's alpha is truncated")
        mask = np.frombuffer(alpha, np.uint8).reshape(rows, w)
    else:
        w32 = w + (32 - w % 32) % 32
        total = int(w32 * rows / 8)
        at = offset + size - total
        need = w32 // 8 * (rows - 1) + (w + 7) // 8
        if at < 0 or len(data) - at < need:
            raise ValueError(f"{name}: the icon's AND mask is truncated")
        raw = np.zeros(total, np.uint8)
        raw[:need] = np.frombuffer(data, np.uint8, count=need, offset=at)
        bits = np.unpackbits(raw.reshape(rows, w32 // 8), axis=1)[:, :w]
        mask = np.where(bits, 0, 255).astype(np.uint8)
    out[..., 3] = mask[::-1]
    return out


def decode_cur_rgba(data: bytes, name: str = "image") -> np.ndarray:
    """CUR bytes -> (H, W, 4) uint8 RGBA of the cursor Pillow opens."""
    entries = _directory(data, b"\0\0\2\0", name)
    m = b""
    try:
        for s in entries:
            if not m:
                m = s
            elif s[0] > m[0] and s[1] > m[1]:
                m = s
    except IndexError:
        raise NotThisFormat(f"{name}: the cursor directory is cut short") from None
    if len(m) < 16:
        raise NotThisFormat(f"{name}: the cursor directory is cut short")
    header = struct.unpack_from("<I", m, 12)[0]
    # Pillow seeks to a non-zero header only: 0 reads on after the directory.
    pos = header if header else min(6 + 16 * len(entries), len(data))
    bm = parse_bitmap(data, pos, 0, name, cursor22=header == 22)
    bm.height //= 2
    if bm.height == 0:
        raise NotThisFormat(f"{name}: a cursor of height 0")
    return decode_bitmap(data, bm, bm.height, name)
