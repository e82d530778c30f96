"""Which image format Pillow would open some bytes as.

The JAX package opens every LDR image with ``PIL.Image.open``, which picks
a format by trying its plugins in turn (Pillow 12.1.0): first the five
formats of ``Image.preinit`` (BMP and DIB, GIF, JPEG, PPM, PNG), then every
other registered format in registration order. A plugin is tried when its
``_accept`` passes on the first 16 bytes, or always when it has none (IM,
IMT, IPTC, PCD, SPIDER and TGA); an ``_open`` that raises ``SyntaxError``,
``IndexError``, ``TypeError``, ``KeyError``, ``EOFError`` or
``struct.error`` (``ImageFile`` turns the last five into
``SyntaxError``), or leaves no mode or a size of no pixels, passes the
bytes on to the next plugin; any other error ends the search.

``pillow_candidates`` lists, in that order, the formats Pillow would try
on some bytes: every format whose ``_accept`` passes and every format
without one, so the list is what Pillow might choose, never less.
``utils/image.py::decode_image_rgba`` walks it, passing a format on only
where that format's reader says Pillow's ``_open`` would (a RIFF header
fails TGA's colour-map check, so a WebP file reaches WEBP), and stops at
the first format it has no reader for (each of those has an ``_accept``).
"""

from __future__ import annotations

import struct


class NotThisFormat(ValueError):
    """Pillow's ``_open`` of this format would pass the bytes on to its next
    format (it raises ``SyntaxError`` or one of the errors ``Image.open``
    treats alike)."""

# Image.open refuses an image of more pixels (DecompressionBombError: twice
# Image.MAX_IMAGE_PIXELS).
MAX_PIXELS = 2 * (1024 * 1024 * 1024 // 4 // 3)


def bomb_check(w: int, h: int, name: str) -> None:
    """Raise as ``Image.open`` does for an image of more than MAX_PIXELS."""
    if w * h > MAX_PIXELS:
        raise ValueError(f"{name}: {w}x{h} is {w * h} pixels, more than "
                         f"Pillow opens ({MAX_PIXELS})")


# Pillow's preinit formats, then the rest in the order Image.init()
# registers them (Pillow 12.1.0).
FIRST_PASS = ("BMP", "DIB", "GIF", "JPEG", "PPM", "PNG")
SECOND_PASS = ("AVIF", "BLP", "BUFR", "CUR", "PCX", "DCX", "DDS", "EPS",
               "FITS", "FLI", "FTEX", "GBR", "GRIB", "HDF5", "JPEG2000",
               "ICNS", "ICO", "IM", "IMT", "IPTC", "MCIDAS", "MPEG", "TIFF",
               "MSP", "PCD", "PIXAR", "PSD", "QOI", "SGI", "SPIDER", "SUN",
               "TGA", "WEBP", "WMF", "XBM", "XPM", "XVTHUMB")
ORDER = FIRST_PASS + SECOND_PASS

TIFF_PREFIXES = (b"MM\x00\x2a", b"II\x2a\x00", b"MM\x2a\x00", b"II\x00\x2a",
                 b"MM\x00\x2b", b"II\x2b\x00")


def _u16le(b: bytes, at: int = 0) -> int | None:
    return struct.unpack_from("<H", b, at)[0] if len(b) >= at + 2 else None


def _u32le(b: bytes, at: int = 0) -> int | None:
    return struct.unpack_from("<I", b, at)[0] if len(b) >= at + 4 else None


def _u32be(b: bytes, at: int = 0) -> int | None:
    return struct.unpack_from(">I", b, at)[0] if len(b) >= at + 4 else None


# Each plugin's _accept on the first 16 bytes (a short prefix that makes
# Pillow's test raise counts as not accepted, as Image.open counts it).
ACCEPT = {
    "BMP": lambda p: p.startswith(b"BM"),
    "DIB": lambda p: _u32le(p) in (12, 40, 52, 56, 64, 108, 124),
    "GIF": lambda p: p.startswith((b"GIF87a", b"GIF89a")),
    "JPEG": lambda p: p.startswith(b"\xff\xd8\xff"),
    "PPM": lambda p: len(p) >= 2 and p[:1] == b"P" and p[1] in b"0123456fy",
    "PNG": lambda p: p.startswith(b"\x89PNG\r\n\x1a\n"),
    "AVIF": lambda p: p[4:8] == b"ftyp" and p[8:12] in (b"avif", b"avis",
                                                        b"mif1", b"msf1"),
    "BLP": lambda p: p.startswith((b"BLP1", b"BLP2")),
    "BUFR": lambda p: p.startswith((b"BUFR", b"ZCZC")),
    "CUR": lambda p: p.startswith(b"\0\0\2\0"),
    "PCX": lambda p: len(p) >= 2 and p[0] == 10 and p[1] in (0, 2, 3, 5),
    "DCX": lambda p: _u32le(p) == 0x3ADE68B1,
    "DDS": lambda p: p.startswith(b"DDS "),
    "EPS": lambda p: p.startswith(b"%!PS") or _u32le(p) == 0xC6D3D0C5,
    "FITS": lambda p: p.startswith(b"SIMPLE"),
    "FLI": lambda p: (len(p) >= 16 and _u16le(p, 4) in (0xAF11, 0xAF12)
                      and _u16le(p, 14) in (0, 3)),
    "FTEX": lambda p: p.startswith(b"FTEX"),
    "GBR": lambda p: (len(p) >= 8 and _u32be(p) >= 20
                      and _u32be(p, 4) in (1, 2)),
    "GRIB": lambda p: len(p) >= 8 and p.startswith(b"GRIB") and p[7] == 1,
    "HDF5": lambda p: p.startswith(b"\x89HDF\r\n\x1a\n"),
    "JPEG2000": lambda p: p.startswith((b"\xff\x4f\xff\x51",
                                        b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a")),
    "ICNS": lambda p: p.startswith(b"icns"),
    "ICO": lambda p: p.startswith(b"\0\0\1\0"),
    "MCIDAS": lambda p: p.startswith(b"\x00\x00\x00\x00\x00\x00\x00\x04"),
    "MPEG": lambda p: p.startswith(b"\x00\x00\x01\xb3"),
    "TIFF": lambda p: p.startswith(TIFF_PREFIXES),
    "MSP": lambda p: p.startswith((b"DanM", b"LinS")),
    "PIXAR": lambda p: p.startswith(b"\200\350\000\000"),
    "PSD": lambda p: p.startswith(b"8BPS"),
    "QOI": lambda p: p.startswith(b"qoif"),
    "SGI": lambda p: len(p) >= 2 and p[0] == 1 and p[1] == 0xDA,
    "SUN": lambda p: _u32be(p) == 0x59A66A95,
    "WEBP": lambda p: (p.startswith(b"RIFF") and p[8:12] == b"WEBP"
                       and p[12:16] in (b"VP8 ", b"VP8X", b"VP8L")),
    "WMF": lambda p: p.startswith((b"\xd7\xcd\xc6\x9a\x00\x00",
                                   b"\x01\x00\x00\x00")),
    "XBM": lambda p: p.lstrip().startswith(b"#define"),
    "XPM": lambda p: p.startswith(b"/* XPM */"),
    "XVTHUMB": lambda p: p.startswith(b"P7 332"),
}


# Formats without _accept: Pillow tries each on any bytes, and its reader
# passes them on (NotThisFormat) where its _open would.
ALWAYS = frozenset({"IM", "IMT", "IPTC", "PCD", "SPIDER", "TGA"})


def pillow_candidates(data: bytes):
    """The formats Pillow would try on ``data``, in its order: each whose
    ``_accept`` passes on the first 16 bytes, and each that has none."""
    prefix = data[:16]
    for fmt in ORDER:
        if fmt in ALWAYS or ACCEPT[fmt](prefix):
            yield fmt
