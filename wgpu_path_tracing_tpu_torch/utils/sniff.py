"""Which image format Pillow would open some bytes as.

The JAX package opens every LDR image with ``PIL.Image.open``, which picks
a format by trying its plugins in turn (Pillow 12.1.0): first the five
formats of ``Image.preinit`` (BMP and DIB, GIF, JPEG, PPM, PNG), then every
other registered format in registration order. A plugin is tried when its
``_accept`` passes on the first 16 bytes, or always when it has none (IM,
IMT, IPTC, PCD, SPIDER and TGA); an ``_open`` that raises ``SyntaxError``,
``IndexError``, ``TypeError`` or ``struct.error`` passes the bytes on to
the next plugin, any other error ends the search.

``pillow_candidates`` lists, in that order, the formats Pillow would try
on some bytes: every format whose test passes, TGA among them (it has no
signature and is always tried), and the formats after TGA (WEBP first).
The formats this package does not read are kept by their ``_accept`` test
alone (or, for those without one, by a copy of the first checks of their
``_open``), so the list is what Pillow might choose, never less:
``utils/image.py::decode_image_rgba`` walks it, passing a format on only
where that format's reader says Pillow's ``_open`` would (a RIFF header
fails TGA's colour-map check, so a WebP file reaches WEBP), and stops at
the first format it has no reader for.
"""

from __future__ import annotations

import re
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


def _pcx_takes(data: bytes) -> bool:
    """PcxImageFile._open passes a bad box on (SyntaxError); with a good
    one it opens the file or raises ``unknown PCX mode``."""
    if len(data) < 12:
        return False
    x0, y0, x1, y1 = struct.unpack_from("<4H", data, 4)
    return x1 + 1 > x0 and y1 + 1 > y0


def _gbr_takes(data: bytes) -> bool:
    """GbrImageFile._open: a header of at least 20 bytes, version 1 or 2
    (2 with the "GIMP" magic at byte 20), a size and a depth of 1 or 4;
    anything else passes the bytes on."""
    if len(data) < 20:
        return False
    header, version, w, h, depth = struct.unpack_from(">5I", data)
    if header < 20 or version not in (1, 2) or w == 0 or h == 0 \
            or depth not in (1, 4):
        return False
    return version == 1 or (len(data) >= 28 and data[20:24] == b"GIMP")


_IM_SPLIT = re.compile(rb"^([A-Za-z][^:]*):[ \t]*(.*)[ \t]*$")
_IM_TAGS = {"Comment", "Date", "Digitalization equipment",
            "File size (no of images)", "Lut", "Name", "Scale (x,y)",
            "Image size (x*y)", "Image type"}


def _im_takes(data: bytes) -> bool:
    """ImImageFile._open's header loop: lines of ``key: value`` up to a
    NUL, ^Z or the end, at least one of them a known tag; any other line
    passes the bytes on."""
    if b"\n" not in data[:100]:
        return False
    pos, n = 0, 0
    while pos < len(data):
        c = data[pos:pos + 1]
        pos += 1
        if c == b"\r":
            continue
        if c in (b"\0", b"\x1a"):
            break
        end = data.find(b"\n", pos)
        end = len(data) if end < 0 else end + 1
        s, pos = c + data[pos:end], end
        if len(s) > 100:
            return False
        s = s[:-2] if s.endswith(b"\r\n") else s[:-1] if s.endswith(b"\n") else s
        m = _IM_SPLIT.match(s)
        if not m:
            return False
        if m.group(1).decode("latin-1") in _IM_TAGS:
            n += 1
    return n > 0


_IMT_FIELD = re.compile(rb"([a-z]*) ([^ \r\n]*)")


def _imt_takes(data: bytes) -> bool:
    """ImtImageFile._open: ``width``, ``height`` and ``pixel n8`` lines
    before the first line it cannot read; a number it cannot read raises
    (which also ends Pillow's search)."""
    if b"\n" not in data[:100]:
        return False
    lines = data.split(b"\n")
    w = h = 0
    mode = False
    for line in lines:
        if line[:1] in (b"", b"\x0c"):
            break
        if len(line) > 100:
            break
        if line[:1] == b"*":
            continue
        m = _IMT_FIELD.match(line)
        if not m:
            break
        k, v = m.group(1, 2)
        try:
            if k == b"width":
                w = int(v)
            elif k == b"height":
                h = int(v)
        except ValueError:
            return True
        if k == b"pixel" and v == b"n8":
            mode = True
    return mode and w > 0 and h > 0


def _iptc_takes(data: bytes) -> bool:
    """IptcImageFile._open's field walk: the bytes go on to the next
    plugin only when a field header is malformed (or cut short)."""
    pos = 0
    while True:
        s = data[pos:pos + 5]
        pos += 5
        if not s.strip(b"\x00"):
            return True  # Pillow then opens the fields or raises
        if len(s) < 5:
            return False
        if s[0] != 0x1C or s[1] not in (1, 2, 3, 4, 5, 6, 7, 8, 9, 240):
            return False
        if (s[1], s[2]) == (8, 10):
            return True
        size = s[3]
        if size > 132:
            return True  # an OSError, which ends the search
        if size == 128:
            size = 0
        elif size > 128:
            size = int.from_bytes(data[pos:pos + size - 128].rjust(4, b"\0")[-4:],
                                  "big")
            pos += s[3] - 128
        else:
            size = struct.unpack_from(">H", s, 3)[0]
        pos += size


def _spider_header(t) -> int:
    """SpiderImagePlugin.isSpiderHeader."""
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


def _spider_takes(data: bytes) -> bool:
    if len(data) < 108:
        return False
    for order in ">", "<":
        t = struct.unpack_from(order + "27f", data)
        if _spider_header(t):
            return int(t[4]) == 1
    return False


# Formats without _accept (or whose _open is copied to decide), each a test
# of whether Pillow's _open might take the bytes or end the search there.
TAKES = {
    "PCX": lambda d: ACCEPT["PCX"](d[:16]) and _pcx_takes(d),
    "GBR": lambda d: ACCEPT["GBR"](d[:16]) and _gbr_takes(d),
    "IM": _im_takes,
    "IMT": _imt_takes,
    "IPTC": _iptc_takes,
    "PCD": lambda d: d[2048:2055] == b"PCD_IPI",
    "SPIDER": _spider_takes,
}


def pillow_candidates(data: bytes):
    """The formats Pillow would try on ``data``, in its order: each whose
    test passes, TGA always (it takes any bytes its header checks pass),
    then each after TGA whose ``_accept`` passes."""
    prefix = data[:16]
    for fmt in ORDER:
        test = TAKES.get(fmt)
        if fmt == "TGA" or (test(data) if test is not None
                            else ACCEPT[fmt](prefix)):
            yield fmt
