"""PNG files of every kind the standard allows, for the tests of the port's
PNG reader (``utils/image.py::decode_png_rgba``, ``read_png``) against
Pillow and the JAX package's Pillow reader.

Pillow writes neither 16-bit RGB nor interlaced PNGs, so ``write_png``
writes them itself with ``zlib``: samples at any bit depth, Adam7 or not,
a PLTE and a tRNS chunk where given, and each row under another of the
five filter types in turn (PNG spec 9.2), so that the reader undoes each
filter on each Adam7 pass.
"""

import struct
import zlib

import numpy as np

ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# kind -> (bit depth, colour type, tRNS): palette, gray + alpha, sub-byte
# gray and palette, 16-bit gray, gray + alpha, RGB and RGBA, and tRNS where
# a type takes one.
KINDS = {
    "gray1": (1, 0, False), "gray1_trns": (1, 0, True),
    "gray2": (2, 0, False), "gray2_trns": (2, 0, True),
    "gray4": (4, 0, False), "gray8_trns": (8, 0, True),
    "gray16": (16, 0, False), "gray16_trns": (16, 0, True),
    "rgb8_trns": (8, 2, True), "rgb16": (16, 2, False),
    "rgb16_trns": (16, 2, True),
    "palette1": (1, 3, False), "palette2": (2, 3, True),
    "palette4": (4, 3, False), "palette": (8, 3, False),
    "palette_trns": (8, 3, True),
    "gray_alpha": (8, 4, False), "gray_alpha16": (16, 4, False),
    "rgba16": (16, 6, False),
}
# (height, width): odd sizes, and sizes under 8 on a side where some Adam7
# passes hold no pixel.
SIZES = ((1, 1), (2, 3), (5, 7), (7, 2), (13, 9))


def _chunk(tag: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + tag + body
            + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))


def _rows(samples: np.ndarray, depth: int) -> list:
    """(h, w, c) samples -> each row's bytes, packed at ``depth``."""
    out = []
    for row in samples.reshape(samples.shape[0], -1):
        if depth == 16:
            out.append(row.astype(">u2").tobytes())
        elif depth == 8:
            out.append(row.astype(np.uint8).tobytes())
        else:
            per = 8 // depth
            r = np.concatenate([row, np.zeros((-len(row)) % per, int)])
            v = np.zeros(len(r) // per, int)
            for k in range(per):
                v = (v << depth) | r[k::per]
            out.append(v.astype(np.uint8).tobytes())
    return out


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filter(rows: list, bpp: int, first: int) -> bytes:
    """Each row under filter type (first + y) % 5."""
    out, prior = b"", bytes(len(rows[0]))
    for y, row in enumerate(rows):
        ftype = (first + y) % 5
        line = bytearray()
        for i, x in enumerate(row):
            a = row[i - bpp] if i >= bpp else 0
            b = prior[i]
            c = prior[i - bpp] if i >= bpp else 0
            pred = (0, a, b, (a + b) >> 1, _paeth(a, b, c))[ftype]
            line.append((x - pred) & 0xFF)
        out += bytes([ftype]) + bytes(line)
        prior = row
    return out


def write_png(samples, depth: int, ctype: int, interlace: int = 0,
              plte=None, trns: bytes | None = None) -> bytes:
    """PNG bytes of ``samples`` ((h, w) or (h, w, channels) integers at
    ``depth`` bits)."""
    samples = np.asarray(samples)
    if samples.ndim == 2:
        samples = samples[..., None]
    h, w, ch = samples.shape
    bpp = max(1, depth * ch // 8)
    raw = b""
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    for k, (x0, y0, dx, dy) in enumerate(passes):
        sub = samples[y0::dy, x0::dx]
        if sub.shape[0] and sub.shape[1]:
            raw += _filter(_rows(sub, depth), bpp, k)
    data = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
    if plte is not None:
        data += _chunk(b"PLTE", np.asarray(plte, np.uint8).tobytes())
    if trns is not None:
        data += _chunk(b"tRNS", trns)
    return data + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b"")


def case(kind: str, h: int, w: int, interlace: int, seed: int) -> bytes:
    """A PNG of ``kind`` (``KINDS``), h x w, from ``seed``: random samples
    over the depth's whole range (16-bit gray also near 255, where Pillow
    clips), a random palette shorter than the depth allows (so some
    indices lie past it), and a tRNS value that some pixel takes."""
    depth, ctype, with_trns = KINDS[kind]
    rng = np.random.default_rng(seed)
    top = (1 << depth) - 1
    s = rng.integers(0, top + 1, (h, w, CHANNELS[ctype]))
    if depth == 16 and ctype == 0:
        s[::2, ::3, 0] = rng.integers(250, 260, s[::2, ::3, 0].shape)
    plte = trns = None
    if ctype == 3:
        plte = rng.integers(0, 256, (max(1, (top + 1) * 3 // 4), 3))
        if with_trns:
            trns = rng.integers(0, 256, max(1, len(plte) // 2)).astype(
                np.uint8).tobytes()
    elif with_trns and ctype == 0:
        key = int(s[0, 0, 0])
        if depth == 16:
            key = min(key, 255)  # Pillow compares the clipped value
        elif depth in (2, 4):
            key = key * (255 // top)  # ... and the scaled one
        trns = struct.pack(">H", key)
    elif with_trns:
        key = s[0, 0] >> 8 if depth == 16 else s[0, 0]  # ... the high byte
        trns = struct.pack(">HHH", *(int(v) for v in key))
    return write_png(s, depth, ctype, interlace, plte, trns)
