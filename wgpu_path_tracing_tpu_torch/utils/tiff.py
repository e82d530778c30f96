"""TIFF decoding in NumPy, the pixels Pillow gives.

The JAX package opens LDR environment maps and textures with Pillow
(``Image.open(...).convert("RGBA")``). Pillow 12.1.0 reads the first page
of a TIFF (classic, or little-endian BigTIFF: 8-byte offsets and counts) in
one of two ways, and this module copies both:

* uncompressed data with its own raw decoder, strip by strip or tile by
  tile, from each offset (byte counts unread; one strip or tile that covers
  the image is read from the LAST offset), a separate plane (planar
  configuration 2) a band at a time, fill order 2 reversing each byte's
  bits; the predictor is not applied; YCbCr is read as "RGBX" (four bytes
  a pixel, no colour conversion), so a file of three samples a pixel
  mostly runs out of data;
* compressed data through libtiff: PackBits (32773), LZW (5, new-style and
  old-style codes), deflate (8, 32946), LZMA (34925, the standard
  library's ``lzma``), zstd (50000, ``utils/zstd.py``: what
  ``ZSTD_decompressStream`` gives libtiff), CCITT modified Huffman, T.4,
  T.6 and RLEW (2, 3, 4, 32771; ``utils/fax.py``), ThunderScan (32809,
  ``thunder_plain``), JPEG (7: each strip's or tile's stream after the
  ``JPEGTables`` stream, decoded by ``utils/jpeg.py``; YCbCr converted to
  RGB by libjpeg as Pillow's JPEGCOLORMODE_RGB asks, other colour spaces
  left as they are; what libjpeg refuses after a strip's single scan
  leaves its rows read; separate planes a component a stream) and
  old-style JPEG (6: the stream libtiff's OJPEG
  codec builds from the JPEGInterchangeFormat stream or the JPEG table
  tags and the strips, an RSTn between them, decoded as libjpeg's raw
  data into TIFF data units), each strip or tile decoded to its whole
  size (a short one raises, extra data is ignored), fill order 2 reversing
  the bits of the compressed bytes (not old-style JPEG's), horizontal
  differencing (predictor 2) at 8, 16 and 32 bits and the floating-point
  predictor (3) undone a row at a time, 16-bit samples in the file's byte
  order, 32-bit and signed 16-bit samples in the host's (little-endian)
  order, which Pillow then reads in the file's: a big-endian compressed
  32-bit or signed 16-bit file comes out byte-swapped, as in Pillow.
  Separate planes are copied as Pillow's libtiff reader copies them: plane
  k into byte k of each 4-byte pixel (a 16-bit sample's high byte), so an
  "LA" or "PA" image loses its alpha (byte 3), and "LAB" keeps a* and b*
  unflipped with alpha 0; planes of other depths than 8 and 16 bits, or
  more planes than the mode has bands, are refused.
  YCbCr data that is not JPEG goes through libtiff's
  ``TIFFRGBAImage``: data units of ``YCbCrSubsampling`` (1x1, 1x2, 2x1,
  2x2, 4x1, 4x2, 4x4), each pixel taking its unit's Cb and Cr, converted
  by ``TIFFYCbCrToRGB``'s tables (``YCbCrCoefficients``,
  ``ReferenceBlackWhite``); old-style JPEG's data units go the same way.

Then Pillow's modes (``TiffImagePlugin.OPEN_INFO``) and conversions: 1, 2,
4 and 8-bit gray (WhiteIsZero inverted at up to 8 bits; 2 and 4 bits
scaled by 85 and 17), 12 and 16-bit gray clipped at 255 (not inverted
under WhiteIsZero, as Pillow reads it; signed samples clipped at 0),
32-bit integer gray ("I": clipped to 0-255; an unsigned sample past 2^31
is negative, so 0) and float gray ("F": clipped, then truncated; NaN is
0), gray with alpha, RGB at 8 and 16 bits (a 16-bit sample's high byte)
with its extra samples: unassociated alpha kept, associated alpha divided
out as Pillow's "RGBa" unpacker does, others dropped; palette images at
1-8 bits (each ``ColorMap`` entry's high byte), with alpha; CMYK at 8 and
16 bits through Pillow's ``cmyk2rgb``; CIELab through LittleCMS's Lab to
sRGB transform (``utils/lab.py``); and the ``Orientation`` tag, which
Pillow's TIFF loader applies (``ImageOps.exif_transpose``) after the load.
Old-style JPEG is YCbCr to Pillow whatever the file says, of 3 samples
where it gives no count.

A separate plane read uncompressed takes one character of Pillow's raw
mode as its own: 8 bits a sample (1 for "1"), neither inverted nor
reversed, whatever the file says, as Pillow reads it. WebP-in-TIFF
(Pillow's libtiff has no WebP codec) and SGILog (its photometrics have no
Pillow mode, and libtiff refuses it under others) raise ``ValueError``.
Separate YCbCr planes compressed with JPEG are refused (``ValueError``),
those under another codec raise ``NotImplementedError``, as do old-style
JPEG in separate planes or whose striles pass its JPEG frame or whose sampling TIFF has no data units for, CCITT data that
ends before its strip's last row (libtiff leaves the rows after
unwritten), LZMA or zstd data bad where libtiff reads part of it, and
directories libtiff may refuse where Pillow's parser does not (repeated
tags, a single-valued tag of several values, baseline tags of other types
than SHORT, LONG and, in a BigTIFF, LONG8) raise ``NotImplementedError``
naming the image; what Pillow refuses raises ``ValueError``. The
PackBits, LZW, CCITT and ThunderScan loops are ``packbits_plain``,
``lzw_plain``, ``utils/fax.py::fax_plain`` and ``thunder_plain`` here, the
plain versions of ``accel/cbvh/image_scan.cpp``'s ``wpt_packbits``,
``wpt_lzw`` and ``wpt_thunder`` and ``fax_scan.cpp``'s ``wpt_fax``, which
the native library runs wherever ``accel.native.native_available()``.
"""

from __future__ import annotations

import re
import struct
import zlib

import numpy as np

from wgpu_path_tracing_tpu_torch.utils.sniff import TIFF_PREFIXES, bomb_check

COMPRESSIONS = {1: "raw", 2: "tiff_ccitt", 3: "group3", 4: "group4",
                5: "tiff_lzw", 6: "tiff_jpeg", 7: "jpeg",
                8: "tiff_adobe_deflate", 32771: "tiff_raw_16",
                32773: "packbits", 32809: "tiff_thunderscan",
                32946: "tiff_deflate", 34676: "tiff_sgilog",
                34677: "tiff_sgilog24", 34925: "lzma", 50000: "zstd",
                50001: "webp"}
READ = ("raw", "packbits", "tiff_lzw", "tiff_adobe_deflate", "tiff_deflate",
        "lzma", "zstd", "jpeg", "tiff_jpeg", "tiff_ccitt", "group3", "group4",
        "tiff_raw_16", "tiff_thunderscan")
# Codecs Pillow's libtiff fails on for every file: WebP is not configured,
# and SGILog takes only the LogL and LogLuv photometrics, which Pillow has
# no mode for.
REFUSED = {"webp": "WEBP compression support is not configured",
           "tiff_sgilog": "SGILog data needs a LogL or LogLuv photometric",
           "tiff_sgilog24": "SGILog data needs a LogL or LogLuv photometric"}
# CCITT codings: modified Huffman, T.4, T.6, and modified Huffman with
# each row padded to 16 bits (RLEW).
FAX = {"tiff_ccitt": 2, "group3": 3, "group4": 4, "tiff_raw_16": 32771}
# JPEG frame headers libjpeg reads (SOF0-SOF3, SOF9-SOF11).
SOF_MARKERS = (0xC0, 0xC1, 0xC2, 0xC3, 0xC9, 0xCA, 0xCB)
# Codecs that take libtiff's predictor.
PREDICTED = ("tiff_lzw", "tiff_adobe_deflate", "tiff_deflate", "lzma",
             "zstd")
# Integer field types: (struct code, size).
TYPES = {1: ("B", 1), 3: ("H", 2), 4: ("I", 4), 6: ("b", 1), 8: ("h", 2),
         9: ("i", 4), 16: ("Q", 8)}
# Pillow's other field types, read and skipped: (size of a value).
OTHER_TYPES = {2: 1, 5: 8, 7: 1, 10: 8, 11: 4, 12: 8, 13: 4}
SCALAR_TAGS = {256, 257, 259, 262, 266, 274, 277, 278, 284, 317, 322, 323}
# Tags libtiff reads from other field types: JPEGTables (bytes),
# YCbCrCoefficients and ReferenceBlackWhite (as floats, at these counts).
FLOAT_TAGS = {529: 3, 532: 6}
LZW_TABLE = 5119  # libtiff's CSIZE: entries past it corrupt the table
LZW_STATUS = {1: "corrupted LZW table", 2: "not enough LZW data"}

_REVERSE = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)
BASELINE_TAGS = (256, 257, 258, 259, 262, 266, 273, 274, 277, 278, 279, 284,
                 317, 320, 322, 323, 324, 325, 338, 339)


def _header(data: bytes, name: str) -> tuple[str, bool, int]:
    """(byte order, BigTIFF, the first IFD's offset) as Pillow reads the
    header: only "II+\\0" is BigTIFF to it (it tests byte 2 for 43), so a
    big-endian BigTIFF is read as a classic TIFF."""
    if not data.startswith(TIFF_PREFIXES):
        raise ValueError(f"{name}: not a TIFF file")
    order = "<" if data[:2] == b"II" else ">"
    big = data[2] == 43
    if len(data) < (16 if big else 8):
        raise ValueError(f"{name}: the TIFF header is truncated")
    (first,) = struct.unpack_from(order + ("Q" if big else "I"), data,
                                  8 if big else 4)
    return order, big, first


def _float_values(typ: int, raw: bytes, order: str, count: int):
    """A tag's values as libtiff's TIFFReadDirEntryFloatArray gives them
    (float32; a rational's numerator and denominator each made a float
    first, 0 over 0 as 0)."""
    f32 = np.float32
    if typ in (5, 10):
        pairs = struct.unpack(f"{order}{2 * count}{'I' if typ == 5 else 'i'}",
                              raw)
        return tuple(f32(0.0) if b == 0 else f32(a) / f32(b)
                     for a, b in zip(pairs[::2], pairs[1::2]))
    code = {3: "H", 4: "I", 11: "f", 12: "d"}[typ]
    return tuple(f32(v) for v in struct.unpack(f"{order}{count}{code}", raw))


def _ifd(data: bytes, order: str, pos: int, name: str,
         big: bool = False) -> tuple[dict, dict]:
    """The first IFD's tags as Pillow's ``tag_v2`` holds them (scalar tags
    a number, the others a tuple; JPEGTables as bytes, YCbCrCoefficients
    and ReferenceBlackWhite as floats where libtiff would read them), and
    each tag's field type (minus its count for a single-valued tag of
    several values; key -1 for a repeated tag). A BigTIFF directory has an
    8-byte count, 20-byte entries and 8-byte offsets."""
    head, entry, count_code, slot = ((8, 20, "Q", 8) if big
                                     else (2, 12, "I", 4))
    if pos + head > len(data):
        raise ValueError(f"{name}: the TIFF directory is truncated")
    (n,) = struct.unpack_from(order + ("Q" if big else "H"), data, pos)
    tags, types = {}, {}
    for i in range(n):
        at = pos + head + entry * i
        if at + entry > len(data):
            raise ValueError(f"{name}: the TIFF directory is truncated")
        tag, typ, count = struct.unpack_from(order + "HH" + count_code, data,
                                             at)
        value_at = at + 4 + slot
        if tag in types:
            types[-1] = tag  # a repeated tag: libtiff keeps another copy
        # libtiff refuses a count other than 1 for a single-valued tag,
        # where Pillow keeps the first value.
        types[tag] = typ if count == 1 or tag not in SCALAR_TAGS else -count
        if typ in OTHER_TYPES:
            size = count * OTHER_TYPES[typ]
            off = value_at
            if size > slot:
                (off,) = struct.unpack_from(order + count_code, data, value_at)
                if off + size > len(data):
                    raise ValueError(f"{name}: TIFF tag {tag}'s data is "
                                     "truncated")
            if tag in BASELINE_TAGS:
                raise NotImplementedError(f"{name}: TIFF tag {tag} of field "
                                          f"type {typ}")
            raw = data[off:off + size]
            if tag == 347 and typ == 7:
                tags[tag] = raw
            elif FLOAT_TAGS.get(tag) == count and typ in (5, 10, 11, 12):
                tags[tag] = _float_values(typ, raw, order, count)
            continue
        if typ not in TYPES:
            continue
        if typ == 1 and tag in BASELINE_TAGS:
            # Pillow holds a BYTE field as bytes, which its reader then
            # fails on (or reads as another image).
            raise ValueError(f"{name}: TIFF tag {tag} of field type BYTE")
        code, unit = TYPES[typ]
        size = count * unit
        off = value_at
        if size > slot:
            (off,) = struct.unpack_from(order + count_code, data, value_at)
            if off + size > len(data):
                raise ValueError(f"{name}: TIFF tag {tag}'s data is truncated")
        if size == 0:
            continue
        vals = struct.unpack_from(f"{order}{count}{code}", data, off)
        tags[tag] = vals[0] if tag in SCALAR_TAGS else vals
        if FLOAT_TAGS.get(tag) == count and typ in (3, 4):
            tags[tag] = tuple(np.float32(v) for v in vals)
    return tags, types


def _mode(key: tuple) -> tuple[str, str] | None:
    """``OPEN_INFO`` for the keys this module reads: (order, photometric,
    sample format, fill order, bits, extra samples) -> (Pillow's mode, its
    raw mode)."""
    order, photo, fmt, fill, bps, extra = key
    r = "R" if fill == 2 else ""
    if fill not in (1, 2):
        return None
    if fill == 1 and extra == ():
        if bps == (32,) and fmt == (3,) and photo in (0, 1):
            return "F", "F;32F" if order == "<" else "F;32BF"
        if bps == (32,) and photo == 1:
            raw = {((1,), "<"): "I;32N", ((2,), "<"): "I;32S",
                   ((2,), ">"): "I;32BS"}.get((fmt, order))
            return ("I", raw) if raw else None
        if bps == (12,) and photo == 1 and fmt == (1,) and order == "<":
            return "I;16", "I;12"
        if photo == 6 and fmt == (1,) and bps in ((8,), (8, 8, 8)):
            return ("L", "L") if bps == (8,) else ("RGB", "RGBX")
        if photo == 8 and fmt == (1,) and bps == (8, 8, 8):
            return "LAB", "LAB"
    if fmt == (1,) and extra == () and bps in ((1,), (2,), (4,), (8,)):
        b = bps[0]
        if photo in (0, 1):
            inv = "I" if photo == 0 else ""
            if b == 1:
                return "1", "1" + (";" + inv + r if inv or r else "")
            if b == 8:
                return "L", "L" + (";" + inv + r if inv or r else "")
            return "L", f"L;{b}{inv}{r}"
        if photo == 3:
            if b == 8:
                return "P", "P" + (";R" if r else "")
            return "P", f"P;{b}{r}"
    if fill == 2:
        if fmt == (1,) and photo == 2 and bps == (8, 8, 8) and extra == ():
            return "RGB", "RGB;R"
        if fmt == (1,) and photo == 1 and bps == (16,) and order == "<" \
                and extra == ():
            return "I;16", "I;16R"
        return None
    if photo == 1 and fmt == (2,) and bps == (8,) and extra == ():
        return "L", "L"
    if photo in (0, 1) and bps == (16,) and extra == ():
        if fmt == (1,) and order == "<":
            return "I;16", "I;16"
        if fmt == (1,) and photo == 1:
            return "I;16B", "I;16B"
        if fmt == (2,) and photo == 1:
            return "I", "I;16S" if order == "<" else "I;16BS"
    if fmt != (1,):
        return None
    if photo == 1 and bps == (8, 8) and extra == (2,):
        return "LA", "LA"
    if photo == 3 and bps == (8, 8) and extra in ((0,), (2,)):
        return ("P", "PX") if extra == (0,) else ("PA", "PA")
    end = ";16" + ("L" if order == "<" else "B")
    if photo == 2 and len(set(bps)) == 1 and bps[0] in (8, 16):
        raw = {(): "RGB" if len(bps) == 3 else "RGBA", (0,): "RGBX",
               (0, 0): "RGBXX", (0, 0, 0): "RGBXXX", (1,): "RGBa",
               (1, 0): "RGBaX", (1, 0, 0): "RGBaXX", (2,): "RGBA",
               (2, 0): "RGBAX", (2, 0, 0): "RGBAXX", (999,): "RGBA"}.get(extra)
        if raw is None or len(bps) != 3 + max(len(extra), len(bps) == 4):
            return None
        if bps[0] == 16:
            if len(bps) > 4 or extra == (999,):
                return None
            raw += end
        return ("RGBA" if "A" in raw or "a" in raw else "RGB"), raw
    if photo == 5 and bps in ((8,) * 4, (16,) * 4) and extra == ():
        return "CMYK", "CMYK" + (end if bps[0] == 16 else "")
    if photo == 5 and bps in ((8,) * 5, (8,) * 6) \
            and extra == (0,) * (len(bps) - 4):
        return "CMYK", "CMYK" + "X" * len(extra)
    return None


def packbits_plain(src: bytes, size: int) -> tuple[bytes, int]:
    """libtiff's ``PackBitsDecode`` into ``size`` bytes: (bytes, status 0
    or 2 for data that runs out first)."""
    out = bytearray()
    pos, end = 0, len(src)
    while pos < end and len(out) < size:
        n = src[pos]
        pos += 1
        if n >= 128:
            n -= 256
        if n < 0:
            if n == -128:
                continue
            n = min(-n + 1, size - len(out))
            if pos >= end:
                break
            out += bytes([src[pos]]) * n
            pos += 1
        else:
            n = min(n + 1, size - len(out))
            if end - pos < n:
                break
            out += src[pos:pos + n]
            pos += n
    return bytes(out), 0 if len(out) == size else 2


def _lzw_codes(bits: np.ndarray, pos: int, first: int,
               old_style: bool) -> tuple:
    """The codes from bit ``pos`` while no clear code comes: (codes, the
    bit after each), ``first`` codes decoded since the last clear. The
    width of each follows from that count alone: 9 bits up to code 253
    after a clear, then 10, 11 and 12, each one code early (old-style
    codes: one code later, each code least significant bit first)."""
    late = int(old_style)
    k = np.arange(first, first + 4096)
    width = (9 + (k >= 254 + late) + (k >= 766 + late)
             + (k >= 1790 + late))
    ends = pos + np.cumsum(width)
    keep = ends <= len(bits)
    width, ends = width[keep], ends[keep]
    starts = ends - width
    idx = starts[:, None] + np.arange(12)[None, :]
    take = np.arange(12)[None, :] < width[:, None]
    got = np.where(take, bits[np.minimum(idx, len(bits) - 1)], 0)
    if old_style:
        shift = np.broadcast_to(np.arange(12)[None, :], got.shape)
    else:
        shift = width[:, None] - 1 - np.arange(12)[None, :]
    codes = (got.astype(np.int64) << np.maximum(shift, 0)).sum(1)
    return codes.tolist(), ends.tolist()


def lzw_old_style(src: bytes) -> bool:
    """libtiff's test for old-style LZW codes: the data starts with 0, then
    a byte with its low bit set."""
    return len(src) >= 2 and src[0] == 0 and bool(src[1] & 1)


def lzw_plain(src: bytes, size: int, old_style: bool = False
              ) -> tuple[bytes, int]:
    """libtiff's ``LZWDecode`` (new-style codes, most significant bit
    first, the code width growing one code early) or ``LZWDecodeCompat``
    (``old_style``: least significant bit first, the width growing one code
    later) into ``size`` bytes: (bytes, status: 0, or a key of
    LZW_STATUS)."""
    bits = np.unpackbits(np.frombuffer(src, np.uint8),
                         bitorder="little" if old_style else "big")
    out = bytearray()
    table: list[bytes] = [bytes([i]) for i in range(256)] + [b"", b""]
    prev = -2  # -2: no clear code yet (libtiff's sentinel); -1: after one
    pos, count = 0, 0  # bit position; codes since the last clear
    while len(out) < size:
        codes, ends = _lzw_codes(bits, pos, count, old_style)
        if not codes:
            break  # no EOI: what is there is all
        for code, end in zip(codes, ends):
            pos = end
            if code == 257 or len(out) >= size:
                return bytes(out[:size]), 0 if len(out) >= size else 2
            if code == 256:
                del table[258:]
                prev, count = -1, 0
                break
            count += 1
            if prev == -2:
                return bytes(out), 1
            if prev == -1:
                if code >= 256:
                    return bytes(out), 1
                entry = table[code]
            elif len(table) >= LZW_TABLE:
                return bytes(out), 1
            elif code < len(table):
                entry = table[code]
                table.append(table[prev] + entry[:1])
            elif code == len(table):
                entry = table[prev] + table[prev][:1]
                table.append(entry)
            else:
                return bytes(out), 1
            out += entry
            prev = code
        else:
            if len(codes) < 4096:
                break  # the data ran out
    return bytes(out[:size]), 0 if len(out) >= size else 2


def thunder_plain(src: bytes, width: int, rows: int) -> tuple[bytes, int]:
    """libtiff's ThunderDecode (4-bit ThunderScan data) of one strip, a row
    of ``width`` pixels at a time, each row starting again from pixel 0:
    runs of the last pixel (a run after an odd pixel repeats the byte it
    completes), 2- and 3-bit deltas, each from the pixel before, with
    their skip codes, and raw pixels. Returns (rows of (width + 1) // 2
    bytes, status: 0, or 1 for a row whose data runs out or gives too many
    pixels, the rest of that row zeroed)."""
    two, three = (0, 1, 0, -1), (0, 1, 2, 3, 0, -3, -2, -1)
    rowbytes = (width + 1) // 2
    out = bytearray(rows * rowbytes + 1)
    bp = 0
    for r in range(rows):
        row = op = r * rowbytes
        last = npixels = 0

        def put(v):
            nonlocal last, npixels, op
            last = v & 0xF
            if npixels < width:
                if npixels & 1:
                    out[op] |= last
                    op += 1
                else:
                    out[op] = last << 4
                npixels += 1

        while bp < len(src) and npixels < width:
            c = src[bp]
            bp += 1
            code = c & 0xC0
            if code == 0:
                k = c
                if npixels & 1:
                    out[op] |= last
                    last = out[op]
                    op += 1
                    npixels += 1
                    k -= 1
                else:
                    last |= last << 4
                npixels += k
                if npixels <= width:
                    while k > 0:
                        out[op] = last
                        op += 1
                        k -= 2
                if k == -1:
                    op -= 1
                    out[op] &= 0xF0
                last &= 0xF
            elif code == 0x40:
                for sh in (4, 2, 0):
                    if (c >> sh) & 3 != 2:
                        put(last + two[(c >> sh) & 3])
            elif code == 0x80:
                for sh in (3, 0):
                    if (c >> sh) & 7 != 4:
                        put(last + three[(c >> sh) & 7])
            else:
                put(c)
        if npixels != width:
            out[op:row + rowbytes] = bytes(row + rowbytes - op)
            return bytes(out[:-1]), 1
    return bytes(out[:-1]), 0


def _decompress(kind: str, src: bytes, size: int, name: str,
                old_lzw: bool = False, partial: bool = False) -> np.ndarray:
    """One strip's or tile's ``size`` bytes, in C++ for PackBits and LZW
    wherever the native library builds. Bad or short data raises, or with
    ``partial`` gives what the codec wrote before it failed and zeros after
    (what libtiff's RGBA reader goes on with)."""
    from wgpu_path_tracing_tpu_torch.accel import native

    error = None
    if kind == "tiff_lzw":
        fn = native.lzw_native if native.native_available() else lzw_plain
        out, status = fn(src, size, old_lzw)
        error = LZW_STATUS.get(status)
    elif kind == "packbits":
        fn = (native.packbits_native if native.native_available()
              else packbits_plain)
        out, status = fn(src, size)
        error = "not enough PackBits data" if status else None
    elif kind == "zstd":
        from wgpu_path_tracing_tpu_torch.utils.zstd import (ZstdError,
                                                            decompress)
        try:
            out = decompress(src, size)
        except ZstdError as exc:
            if partial:
                raise NotImplementedError(f"{name}: bad zstd data ({exc}), "
                                          "which libtiff reads in part") from None
            raise ValueError(f"{name}: bad zstd data ({exc})") from None
        error = "not enough zstd data" if len(out) < size else None
    elif kind == "lzma":
        try:
            import lzma
        except ImportError:
            raise NotImplementedError(f"{name}: LZMA-compressed TIFF needs "
                                      "Python's lzma module") from None
        try:
            out = lzma.LZMADecompressor(lzma.FORMAT_XZ).decompress(src, size)
        except lzma.LZMAError as exc:
            # libtiff keeps what liblzma wrote before it found the bad data,
            # and a strip stands if that fills it; Python's lzma gives none
            # of it back.
            raise NotImplementedError(f"{name}: bad LZMA data ({exc}), which "
                                      "libtiff may read in part") from None
        error = "not enough LZMA data" if len(out) < size else None
    else:
        try:
            out = zlib.decompressobj().decompress(src, size)
        except zlib.error as exc:
            error = f"bad deflate data ({exc})"
            out = _inflate_until_error(src, size) if partial else b""
        if len(out) < size and error is None:
            error = "not enough deflate data"
    if error and not partial:
        raise ValueError(f"{name}: {error}")
    buf = np.zeros(size, np.uint8)
    buf[:min(len(out), size)] = np.frombuffer(out, np.uint8)[:size]
    return buf


def _inflate_until_error(src: bytes, size: int) -> bytes:
    """The bytes zlib writes before it finds bad data, fed a byte at a
    time (only on bad data)."""
    dec = zlib.decompressobj()
    out = bytearray()
    try:
        for i in range(len(src)):
            out += dec.decompress(src[i:i + 1], size - len(out))
            if len(out) >= size or dec.eof:
                break
    except zlib.error:
        pass
    return bytes(out)


def _fax(kind: str, src: bytes, width: int, rows: int, options: int,
         runs: np.ndarray, name: str) -> np.ndarray:
    """One strip's or tile's CCITT data -> (rows, width) 0/1 samples, in
    C++ wherever the native library builds; ``runs`` the page's run
    array; ``options`` T4Options, or for RLEW the strip's file offset
    (libtiff reads the data where it lies in the file's image, and pads a
    row to a 16-bit boundary of that memory)."""
    from wgpu_path_tracing_tpu_torch.accel import native
    from wgpu_path_tracing_tpu_torch.utils.fax import FAX_STATUS, fax_plain

    fn = native.fax_native if native.native_available() else fax_plain
    out, status = fn(src, FAX[kind], width, rows, options, runs)
    if status:
        raise (NotImplementedError if status == 1 else ValueError)(
            f"{name}: {FAX_STATUS[status]}")
    return out


def _undo_predictor(buf: np.ndarray, rowsize: int, spp: int, bits: int,
                    predictor: int, order: str, name: str) -> np.ndarray:
    """libtiff's predictor undone on one strip's or tile's bytes, a row of
    ``rowsize`` bytes at a time: horizontal differencing (horAcc8/16/32,
    samples in the file's byte order) or the floating-point predictor
    (fpAcc: each row's bytes summed ``spp`` apart, then its byte planes,
    most significant first, put back into samples, here in the file's
    order)."""
    size = bits // 8
    if len(buf) % rowsize or rowsize % (size * spp):
        raise ValueError(f"{name}: TIFF rows that the predictor cannot "
                         "split (libtiff refuses them)")
    rows = buf.reshape(-1, rowsize)
    n = rows.shape[0]
    if predictor == 3:
        acc = np.cumsum(rows.reshape(n, -1, spp), axis=1, dtype=np.uint8)
        planes = acc.reshape(n, size, -1).transpose(0, 2, 1)
        vals = np.ascontiguousarray(planes).view(f">u{size}")
        return vals.astype(f"{order}u{size}").view(np.uint8).reshape(-1)
    if bits == 8:
        return np.cumsum(rows.reshape(n, -1, spp), axis=1,
                         dtype=np.uint8).reshape(-1)
    dt = np.dtype(f"{order}u{size}")
    acc = np.cumsum(rows.view(dt).reshape(n, -1, spp), axis=1,
                    dtype=f"u{size}")
    return acc.astype(dt).view(np.uint8).reshape(-1)


def _samples(rows: np.ndarray, count: int, bits: int, order: str) -> np.ndarray:
    """(rows, bytes) -> (rows, count) sample values at ``bits`` bits."""
    n = rows.shape[0]
    if bits == 8:
        return rows[:, :count]
    if bits in (16, 32):
        size = bits // 8
        return rows[:, :size * count].copy().view(f"{order}u{size}")[:, :count]
    b = np.unpackbits(rows, axis=1)[:, :count * bits].reshape(n, count, bits)
    w = (1 << np.arange(bits - 1, -1, -1)).astype(np.uint16)
    return (b * w).sum(-1, dtype=np.uint16)


def _layout(tags: dict, w: int, h: int, name: str):
    """(offsets, byte counts or None, tile width, tile height, tiled)."""
    if 324 in tags:
        tw, th = tags.get(322), tags.get(323)
        if not isinstance(tw, int) or not isinstance(th, int) or tw <= 0 \
                or th <= 0:
            raise ValueError(f"{name}: invalid TIFF tile dimensions")
        return tags[324], tags.get(325), tw, th, True
    if 273 in tags:
        return tags[273], tags.get(279), w, tags.get(278, h), False
    raise ValueError(f"{name}: unknown TIFF data organization")


def _chunks(data, tags, w, h, n_planes, name):
    """Each strip or tile libtiff decodes, in its order: (index, plane,
    top row, left column, rows, its bytes, fill order undone), and (tile
    width, tile height, tiled)."""
    offsets, counts, tw, th, tiled = _layout(tags, w, h, name)
    if counts is None:
        raise NotImplementedError(f"{name}: compressed TIFF data without "
                                  "byte counts")
    th = th if tiled else min(th, h)
    across, down = -(-w // tw), -(-h // th)
    if len(offsets) < across * down * n_planes or len(counts) < len(offsets):
        raise ValueError(f"{name}: too few TIFF strips or tiles")
    fill = tags.get(266, 1)
    out = []
    for p in range(n_planes):
        for k in range(across * down):
            ty, tx = divmod(k, across)
            y0, x0 = ty * th, tx * tw
            i = p * across * down + k
            if offsets[i] + counts[i] > len(data):
                raise ValueError(f"{name}: TIFF strip or tile {i} runs past "
                                 "the end of the file")
            src = data[offsets[i]:offsets[i] + counts[i]]
            if fill == 2:
                src = _REVERSE[np.frombuffer(src, np.uint8)].tobytes()
            rows = th if tiled else min(th, h - y0)
            out.append((i, p, y0, x0, rows, src))
    return out, tw, th, tiled


def _predictor(tags: dict, kind: str, bits: int, fmt: tuple,
               name: str) -> int:
    """The predictor libtiff applies, checked as PredictorSetup checks
    it."""
    predictor = tags.get(317, 1) if kind in PREDICTED else 1
    if predictor not in (1, 2, 3):
        raise NotImplementedError(f"{name}: TIFF predictor {predictor}")
    if predictor == 2 and bits not in (8, 16, 32):
        raise ValueError(f"{name}: horizontal differencing of {bits}-bit "
                         "samples (libtiff refuses it)")
    if predictor == 3 and (fmt[0] != 3 or bits not in (16, 32)):
        raise ValueError(f"{name}: the floating-point predictor on sample "
                         f"format {fmt[0]} at {bits} bits (libtiff refuses "
                         "it)")
    return predictor


def _compressed(data, tags, order, kind, w, h, spp, bits, planar, fmt, name):
    """libtiff's decode: (H, W, spp) samples, each strip or tile decoded to
    its whole size; rows and columns past the image are dropped. Old-style
    LZW is chosen by the first strip or tile libtiff reads, for all."""
    predictor = _predictor(tags, kind, bits, fmt, name)
    per = spp if planar == 1 else 1
    chunks, tw, th, tiled = _chunks(data, tags, w, h,
                                    1 if planar == 1 else spp, name)
    line = (tw * per * bits + 7) // 8
    out = np.zeros((h, w, spp), np.uint32 if bits == 32 else np.uint16)
    old_lzw = kind == "tiff_lzw" and bool(chunks) and lzw_old_style(
        chunks[0][5])
    if kind in FAX:
        from wgpu_path_tracing_tpu_torch.utils.fax import fax_runs

        if bits != 1:
            raise ValueError(f"{name}: CCITT data of {bits}-bit samples "
                             "(libtiff refuses it)")
        t4 = tags.get(292, (0,)) if kind == "group3" else (0,)
        t4 = t4[0] if isinstance(t4, tuple) else t4
        runs = fax_runs(FAX[kind], tw, t4)
    if kind == "tiff_thunderscan" and (bits != 4 or tiled):
        raise ValueError(f"{name}: ThunderScan data of {bits}-bit samples or "
                         "in tiles (libtiff refuses it)")
    offsets = _layout(tags, w, h, name)[0]
    for i, p, y0, x0, rows, src in chunks:
        if kind in FAX:
            opts = offsets[i] & 1 if kind == "tiff_raw_16" else t4
            vals = _fax(kind, src, tw, rows, opts, runs, name)[..., None]
        elif kind == "tiff_thunderscan":
            from wgpu_path_tracing_tpu_torch.accel import native

            fn = (native.thunder_native if native.native_available()
                  else thunder_plain)
            buf, status = fn(src, tw * per, rows)
            if status:
                raise ValueError(f"{name}: ThunderScan data that does not "
                                 "fill its rows")
            vals = _samples(np.frombuffer(buf, np.uint8).reshape(rows, line),
                            tw * per, bits, order).reshape(rows, tw, per)
        else:
            buf = _decompress(kind, src, rows * line, name, old_lzw)
            if predictor != 1:
                buf = _undo_predictor(buf, line, per, bits, predictor, order,
                                      name)
            vals = _samples(buf.reshape(rows, line), tw * per, bits,
                            order).reshape(rows, tw, per)
        ys, xs = min(rows, h - y0), min(tw, w - x0)
        out[y0:y0 + ys, x0:x0 + xs, p:p + per] = vals[:ys, :xs]
    return out


def _jpeg_segments(stream: bytes) -> list:
    """A JPEG stream's marker segments after its SOI, up to its first scan
    or its EOI: [(marker, the segment's bytes)]."""
    out, pos = [], 2
    while pos + 4 <= len(stream) and stream[pos] == 0xFF \
            and stream[pos + 1] not in (0xD9, 0xDA):
        (length,) = struct.unpack(">H", stream[pos + 2:pos + 4])
        out.append((stream[pos + 1], stream[pos:pos + 2 + length]))
        pos += 2 + length
    return out


def _jpeg(data, tags, w, h, spp, photo, planar, name):
    """libtiff's JPEG decode (compression 7): each strip's or tile's stream
    after the JPEGTables stream's segments, through ``utils/jpeg.py``,
    checked as JPEGPreDecode checks it; (H, W, spp) samples, RGB for
    YCbCr (JPEGCOLORMODE_RGB). A tile is decoded at its full size and cut
    to the image."""
    from wgpu_path_tracing_tpu_torch.utils.jpeg import decode_jpeg_samples

    per = 1 if planar == 2 else spp  # components a stream
    chunks, tw, th, tiled = _chunks(data, tags, w, h, spp // per, name)
    tables = tags.get(347, b"\xff\xd8")
    if tables[:2] != b"\xff\xd8":
        raise ValueError(f"{name}: the JPEGTables stream does not start with "
                         "SOI")
    seen = b"".join(seg for _, seg in _jpeg_segments(tables))
    sampling = (1, 1)
    if photo == 6 and 530 in tags:
        sampling = (tuple(tags[530]) + (2, 2))[:2]
    elif photo == 6:
        # JPEGFixupTagsSubsampling: without the tag, the first strip's frame
        # header (its first component's factors) gives it.
        sof = [seg for marker, seg in (_jpeg_segments(chunks[0][5])
                                       if chunks else [])
               if marker in SOF_MARKERS and len(seg) >= 12]
        sampling = (sof[0][11] >> 4, sof[0][11] & 15) if sof else (2, 2)
    out = np.zeros((h, w, spp), np.uint16)
    for i, p, y0, x0, rows, src in chunks:
        if src[:2] != b"\xff\xd8":
            raise ValueError(f"{name}: JPEG strip or tile {i} does not start "
                             "with SOI")
        # libtiff hands libjpeg a fake EOI where the strip's bytes end
        # (std_fill_input_buffer); libjpeg reads what is cut short as it
        # reads any JPEG cut at a marker.
        frame, vals = decode_jpeg_samples(src[:2] + seen + src[2:]
                                          + b"\xff\xd9", name,
                                          ycbcr=photo == 6)
        comps = frame["comps"]
        if len(comps) != per:
            raise ValueError(f"{name}: improper JPEG component count")
        if (comps[0].h, comps[0].v) != sampling or any(
                (c.h, c.v) != (1, 1) for c in comps[1:]):
            raise ValueError(f"{name}: improper JPEG sampling factors")
        jw, jh = frame["width"], frame["height"]
        if jw > tw or (jh > rows and (tiled or y0 + rows != h)):
            raise ValueError(f"{name}: JPEG strip or tile size exceeds "
                             "expected dimensions")
        if jh < rows:
            raise ValueError(f"{name}: a JPEG strip or tile of {jh} rows "
                             f"where libtiff reads {rows}")
        if jw < tw:
            # libjpeg fills only the first jw pixels of each row.
            raise NotImplementedError(f"{name}: a JPEG strip or tile of "
                                      f"width {jw} where libtiff expects "
                                      f"{tw}")
        # libjpeg keeps the tables a stream defines for the streams after.
        seen += b"".join(seg for marker, seg in _jpeg_segments(src)
                         if marker in (0xC4, 0xDB))
        ys, xs = min(rows, h - y0), min(tw, w - x0)
        out[y0:y0 + ys, x0:x0 + xs, p:p + per] = vals[:ys, :xs]
    return out


# TIFFRGBAImage's YCbCr data units, (horizontal, vertical) subsampling.
YCBCR_UNITS = ((1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4))
LUMA_DEFAULT = (0.299, 0.587, 0.114)


def ycbcr_tables(luma, rbw, name: str = "image") -> tuple:
    """libtiff's TIFFYCbCrToRGBInit (tif_color.c) on float32 coefficients
    and ReferenceBlackWhite: (Y, Cr->R, Cb->B, Cr->G, Cb->G) tables of 256
    int64, the float arithmetic in float32 as libtiff's."""
    f32 = np.float32
    luma = [f32(v) for v in luma]
    rbw = [f32(v) for v in rbw]
    if any(np.isnan(v) for v in luma) or luma[1] == 0:
        raise ValueError(f"{name}: invalid YCbCrCoefficients")
    if not all(f32(-2 ** 31) < v < f32(2 ** 31) for v in rbw):
        raise ValueError(f"{name}: invalid ReferenceBlackWhite")

    def clamp(f, lo, hi):  # !((f) >= (min)) ? min : f > max ? max : f
        f = np.asarray(f, np.float32)
        return np.where(~(f >= lo), f32(lo), np.where(f > hi, f32(hi), f))

    def fix(f):  # (int32_t)(f * 65536 + 0.5), the sum in double
        return np.int64(np.float64(f32(f) * f32(65536)) + 0.5)

    def code2v(c, rb, rw, cr):
        den = rw - rb
        den = den if den != 0 else f32(1)
        num = (c - np.int64(np.trunc(rb))).astype(np.float32) * f32(cr)
        return num / den

    with np.errstate(invalid="ignore", over="ignore", divide="ignore"):
        f1 = f32(2) - f32(2) * luma[0]
        d1 = fix(clamp(f1, 0, 2))
        f2 = luma[0] * f1 / luma[1]
        d2 = -fix(clamp(f2, 0, 2))
        f3 = f32(2) - f32(2) * luma[2]
        d3 = fix(clamp(f3, 0, 2))
        f4 = luma[2] * f3 / luma[1]
        d4 = -fix(clamp(f4, 0, 2))
        x = np.arange(-128, 128, dtype=np.int64)
        cr = clamp(code2v(x, rbw[4] - f32(128), rbw[5] - f32(128), 127),
                   -4096, 4096).astype(np.int64)
        cb = clamp(code2v(x, rbw[2] - f32(128), rbw[3] - f32(128), 127),
                   -4096, 4096).astype(np.int64)
        y = clamp(code2v(x + 128, rbw[0], rbw[1], 255), -4096,
                  4096).astype(np.int64)
    return (y, (d1 * cr + 32768) >> 16, (d3 * cb + 32768) >> 16, d2 * cr,
            d4 * cb + 32768)


def ycbcr_to_rgb(y, cb, cr, tables) -> np.ndarray:
    """TIFFYCbCrtoRGB on uint8 planes -> (..., 3) uint8."""
    yt, cr_r, cb_b, cr_g, cb_g = tables
    yv = yt[y]
    out = np.empty(np.shape(y) + (3,), np.uint8)
    out[..., 0] = np.clip(yv + cr_r[cr], 0, 255)
    out[..., 1] = np.clip(yv + ((cb_g[cb] + cr_g[cr]) >> 16), 0, 255)
    out[..., 2] = np.clip(yv + cb_b[cb], 0, 255)
    return out


def _ycbcr(data, tags, order, kind, w, h, fmt, name):
    """Pillow's read of YCbCr that is not JPEG-compressed: libtiff's
    TIFFRGBAImage -> (H, W, 3) RGB in the file's row order (Pillow applies
    the Orientation after)."""
    hs, vs = (tuple(tags.get(530, (2, 2))) + (2, 2))[:2]
    if (hs, vs) not in YCBCR_UNITS:
        raise ValueError(f"{name}: YCbCr subsampling {hs}x{vs} (libtiff "
                         "cannot read it)")
    tables = ycbcr_tables(tags.get(529, LUMA_DEFAULT),
                          tags.get(532, (0, 255, 128, 255, 128, 255)), name)
    predictor = _predictor(tags, kind, 8, fmt, name)
    chunks, tw, th, tiled = _chunks(data, tags, w, h, 1, name)
    unit = hs * vs + 2
    across = -(-tw // hs)
    if tiled and tw % hs:
        raise NotImplementedError(f"{name}: YCbCr tiles of a width that is "
                                  "no multiple of the subsampling")
    # TIFFScanlineSize rounds a row of data units over vs down: a strip
    # reads that many bytes a row, the rest of its units stay 0.
    rowsize = tw * 3 if tiled else across * unit // vs
    old_lzw = kind == "tiff_lzw" and bool(chunks) and lzw_old_style(
        chunks[0][5])
    out = np.zeros((h, w, 3), np.uint8)
    for _, _, y0, x0, rows, src in chunks:
        down = -(-rows // vs)
        size = down * across * unit if tiled else down * vs * rowsize
        # The reader does not stop on a strip's bad data: it goes on with
        # what the codec wrote, the predictor not undone (a tile's buffer
        # would still hold the tile before it).
        try:
            buf = _decompress(kind, src, size, name, old_lzw)
        except ValueError as exc:
            if tiled:
                raise NotImplementedError(f"{exc} (in a YCbCr tile)") from None
            buf = _decompress(kind, src, size, name, old_lzw, partial=True)
        else:
            if predictor != 1:
                try:
                    buf = _undo_predictor(buf, rowsize, 3, 8, predictor,
                                          order, name)
                except ValueError:
                    if tiled:
                        raise NotImplementedError(
                            f"{name}: a YCbCr tile the predictor cannot "
                            "split") from None
        units = np.zeros(down * across * unit, np.uint8)
        units[:size] = buf
        _put_ycbcr(out, units, y0, x0, rows, tw, hs, vs, tables)
    return out


def _put_ycbcr(out, units, y0, x0, rows, tw, hs, vs, tables) -> None:
    """TIFFRGBAImage's putcontig8bitYCbCr put functions: one strip's or
    tile's data units (``units``, rows of ceil(tw / hs) units of hs x vs Y,
    Cb and Cr) into ``out`` at (y0, x0)."""
    h, w = out.shape[:2]
    unit = hs * vs + 2
    ys, xs = min(rows, h - y0), min(tw, w - x0)
    # putcontig8bitYCbCr44tile skips the units past the image's edge as if
    # they were 4x2 units (libtiff's fromskew).
    stride = -(-tw // hs) * unit
    if (hs, vs) == (4, 4) and xs < tw:
        stride = -(-xs // 4) * unit + (tw - xs) // 4 * 10
    r = np.arange(ys)[:, None]
    c = np.arange(xs)[None, :]
    at = (r // vs) * stride + (c // hs) * unit
    out[y0:y0 + ys, x0:x0 + xs] = ycbcr_to_rgb(
        units[at + (r % vs) * hs + c % hs], units[at + hs * vs],
        units[at + hs * vs + 1], tables)


# Old-style JPEG (compression 6): the JPEG markers libtiff's OJPEG codec
# reads from the stream, and the tables it keeps.
OJPEG_SOF = (0xC0, 0xC1)


def _ojpeg_sources(data, tags, n_chunks, name) -> tuple:
    """The bytes libtiff's OJPEGReadBufferFill reads, in order: the
    JPEGInterchangeFormat stream (cut to the file, to its end where the
    length is 0 or too long), then each strip or tile (a byte count of 0
    reading to the end of the file, an offset past it nothing), unreversed
    whatever the fill order. Returns (the interchange stream, [each strip's
    or tile's bytes])."""
    size = len(data)
    jif = tags.get(513, (0,))
    jif = jif[0] if isinstance(jif, tuple) else jif
    jif_bytes = b""
    if 0 < jif < size:
        n = tags.get(514, (0,))
        n = n[0] if isinstance(n, tuple) else n
        if n == 0 or jif + n > size:
            n = size - jif
        jif_bytes = data[jif:jif + n]
    offsets, counts, *_ = _layout(tags, tags[256], tags[257], name)
    if counts is None:
        raise NotImplementedError(f"{name}: old-style JPEG data without byte "
                                  "counts")
    if len(offsets) < n_chunks or len(counts) < n_chunks:
        raise ValueError(f"{name}: too few TIFF strips or tiles")
    parts = []
    for off, count in zip(offsets[:n_chunks], counts[:n_chunks]):
        if off == 0 or off >= size:
            parts.append(b"")
            continue
        parts.append(data[off:size if count == 0 else min(off + count, size)])
    return jif_bytes, parts


def _ojpeg_tables(data, tags, key, spp, dht_class, name) -> tuple:
    """OJPEGReadHeaderInfoSecTables{Q,Dc,Ac}Table: each component's table
    read from the offsets of tag ``key`` (519-521), a table repeating the
    one before where its offset does: ({table id: its marker segment},
    [the id each component takes])."""
    offs = list(tags.get(key, ()))
    if len(offs) > 3:
        raise ValueError(f"{name}: JPEG table tag {key} has incorrect count")
    offs += [0] * (spp - len(offs))
    if not offs or offs[0] == 0:
        raise ValueError(f"{name}: missing JPEG tables")
    segs, ids = {}, []
    for m in range(spp):
        if offs[m] and (m == 0 or offs[m] != offs[m - 1]):
            if offs[m] in offs[:max(m - 1, 0)]:
                raise ValueError(f"{name}: corrupt JPEG table tag {key}")
            if key == 519:
                table = data[offs[m]:offs[m] + 64]
                if len(table) != 64:
                    raise ValueError(f"{name}: JPEG table past the file")
                segs[m] = b"\xff\xdb\x00\x43" + bytes([m]) + table
            else:
                counts = data[offs[m]:offs[m] + 16]
                n = sum(counts)
                values = data[offs[m] + 16:offs[m] + 16 + n]
                if len(counts) != 16 or len(values) != n:
                    raise ValueError(f"{name}: JPEG table past the file")
                segs[m] = (b"\xff\xc4" + struct.pack(">H", 19 + n)
                           + bytes([dht_class | m]) + counts + values)
            ids.append(m)
        else:
            ids.append(ids[-1])
    return segs, ids


def _ojpeg_stream(data, tags, spp, hs, vs, strile, name) -> tuple:
    """The JPEG stream libtiff's OJPEG codec hands libjpeg for the image:
    the header markers read from the JPEGInterchangeFormat stream (or, with
    no SOF there, built from the table tags), written again as OJPEG
    writes them (every stored quantization table, then DC and AC tables,
    DRI, SOF, SOS), then the entropy-coded data from where the markers end,
    an RSTn after each strip or tile but the last, and EOI. ``strile`` is
    (strip or tile width, its rows, the rows of all striles, their count).
    Returns (the stream, the SOF's components' (h, v))."""
    sw, sl, sl_total, n_chunks = strile
    jif, parts = _ojpeg_sources(data, tags, n_chunks, name)
    if not all(parts):
        raise NotImplementedError(f"{name}: old-style JPEG with an empty "
                                  "strip or tile")
    stream = jif + b"".join(parts)
    qt, dc, ac = {}, {}, {}
    restart = tags.get(515, 0)
    restart = restart[0] if isinstance(restart, tuple) else restart
    sof = sos = None
    pos = 0

    def word(at):
        if at + 2 > len(stream):
            raise ValueError(f"{name}: old-style JPEG data cut short")
        return struct.unpack_from(">H", stream, at)[0]

    while True:
        if pos >= len(stream):
            raise ValueError(f"{name}: old-style JPEG data cut short")
        if stream[pos] != 0xFF:
            break
        pos += 1
        while pos < len(stream) and stream[pos] == 0xFF:
            pos += 1
        if pos >= len(stream):
            raise ValueError(f"{name}: old-style JPEG data cut short")
        m = stream[pos]
        pos += 1
        if m == 0xD8:
            continue
        if m not in (0xC4, 0xDA, 0xDB, 0xDD, 0xFE, *OJPEG_SOF) and not (
                0xE0 <= m <= 0xEF):
            if m == 0xC3:
                raise NotImplementedError(f"{name}: lossless old-style JPEG")
            raise ValueError(f"{name}: unknown marker {m:#x} in old-style "
                             "JPEG data")
        n = word(pos)
        seg = stream[pos + 2:pos + n]
        if n < 2 or (m in (0xC4, 0xDB) and n <= 2):
            raise ValueError(f"{name}: corrupt old-style JPEG marker")
        if m in (0xDB, 0xC4, 0xDD, *OJPEG_SOF, 0xDA) and len(seg) < n - 2:
            raise ValueError(f"{name}: old-style JPEG data cut short")
        pos += n
        if m == 0xDD:
            if n != 4:
                raise ValueError(f"{name}: corrupt DRI marker")
            restart = word(pos - 2)
        elif m == 0xDB:
            if (n - 2) % 65:
                raise ValueError(f"{name}: corrupt DQT marker")
            for k in range(0, n - 2, 65):
                if seg[k] & 15 > 3:
                    raise ValueError(f"{name}: corrupt DQT marker")
                qt[seg[k] & 15] = b"\xff\xdb\x00\x43" + seg[k:k + 65]
        elif m == 0xC4:
            c = seg[0]
            if c & 0xF0 not in (0, 0x10) or c & 15 > 3:
                raise ValueError(f"{name}: corrupt DHT marker")
            (dc if c < 16 else ac)[c & 15] = b"\xff\xc4" + stream[
                pos - n:pos]
        elif m in OJPEG_SOF:
            if sof is not None or n < 11 or (n - 8) % 3 or (n - 8) // 3 != spp:
                raise ValueError(f"{name}: old-style JPEG data of another "
                                 "frame than the TIFF's")
            y, x = struct.unpack(">HH", seg[1:5])
            if seg[0] != 8 or seg[5] != spp or (y < tags[257] and y < sl_total) \
                    or (x < tags[256] and x < sw) or x > sw:
                raise ValueError(f"{name}: old-style JPEG data of another "
                                 "frame than the TIFF's")
            comps = [tuple(seg[6 + 3 * k:9 + 3 * k]) for k in range(spp)]
            if comps[0][1] != (hs << 4 | vs) or any(
                    c[1] != 0x11 for c in comps[1:]):
                raise ValueError(f"{name}: old-style JPEG data of other "
                                 "sampling factors than the TIFF's")
            sof = (m, y, x, comps)
        elif m == 0xDA:
            if sof is None or n != 6 + 2 * spp or seg[0] != spp:
                raise ValueError(f"{name}: corrupt SOS marker")
            sos = [tuple(seg[1 + 2 * k:3 + 2 * k]) for k in range(spp)]
            break  # Ss, Se, Ah/Al not read
    if sof is None:
        if n_chunks > 1:
            # The table layout of several strips or tiles: each one a
            # restart interval, whatever JPEGRestartInterval says.
            restart = -(-sw // (8 * hs)) * (sl // (8 * vs))
        qt, tq = _ojpeg_tables(data, tags, 519, spp, 0, name)
        dc, td = _ojpeg_tables(data, tags, 520, spp, 0x00, name)
        ac, ta = _ojpeg_tables(data, tags, 521, spp, 0x10, name)
        comps = [(k, (hs << 4 | vs) if k == 0 else 0x11, tq[k])
                 for k in range(spp)]
        sof = (0xC0, sl_total, sw, comps)
        sos = [(k, td[k] << 4 | ta[k]) for k in range(spp)]
    elif sos is None:
        raise NotImplementedError(f"{name}: old-style JPEG data with a frame "
                                  "but no scan header")
    m, y, x, comps = sof
    head = b"\xff\xd8" + b"".join(qt[k] for k in sorted(qt)) + b"".join(
        dc[k] for k in sorted(dc)) + b"".join(ac[k] for k in sorted(ac))
    if restart:
        head += b"\xff\xdd\x00\x04" + struct.pack(">H", restart)
    head += bytes([0xFF, m]) + struct.pack(">HBHHB", 8 + 3 * spp, 8, y & 0xFFFF,
                                           x, spp)
    head += b"".join(bytes(c) for c in comps)
    head += b"\xff\xda" + struct.pack(">HB", 6 + 2 * spp, spp) + b"".join(
        bytes(c) for c in sos) + b"\x00\x3f\x00"
    # The entropy-coded data: from where the markers end, with an RSTn where
    # each strip or tile but the last ends (one the markers used up, none).
    body, at, rst = [stream[pos:max(pos, len(jif))]], len(jif), 0
    for k, part in enumerate(parts):
        body.append(stream[max(at, pos):at + len(part)])
        at += len(part)
        if k < len(parts) - 1 and at > pos:
            body.append(bytes([0xFF, 0xD0 + rst]))
            rst = (rst + 1) % 8
    data = b"".join(body)
    if restart:
        # libtiff's OJPEG source cannot resync: every restart boundary of
        # the frame must find its RSTn next (junk before it is skipped).
        hs0, vs0 = comps[0][1] >> 4, comps[0][1] & 15
        if spp == 1:
            hs0 = vs0 = 1
        mcus = -(-x // (8 * hs0)) * -(-y // (8 * vs0))
        need = -(-mcus // restart) - 1
        found = [mk.group(1)[0] for mk in re.finditer(rb"\xff+([^\x00\xff])",
                                                       data)]
        if [m - 0xD0 for m in found[:need]] != [k % 8 for k in range(need)]:
            raise NotImplementedError(
                f"{name}: old-style JPEG whose restart markers libjpeg would "
                "resync (libtiff's OJPEG fails there; Pillow goes on with "
                "what its buffer holds)")
    return head + data + b"\xff\xd9", [(c[1] >> 4, c[1] & 15)
                                        for c in comps]


def _ojpeg(data, tags, w, h, spp, name):
    """libtiff's old-style JPEG decode (compression 6) as Pillow reads it:
    (H, W, spp) samples, RGB for YCbCr. Three samples of a YCbCr file come
    as libjpeg's raw data (each component at its own sampling, whole
    blocks) packed into TIFF data units, then TIFFRGBAImage's conversion
    (``ycbcr_tables``), the subsampling taken from the JPEG frame where the
    interchange stream has one; one sample as libjpeg decodes it, with no
    colour conversion."""
    from wgpu_path_tracing_tpu_torch.utils.jpeg import decode_jpeg_raw

    # libtiff's directory reader takes old-style JPEG with no photometric,
    # or RGB, for YCbCr.
    photo = tags.get(262, 6)
    photo = 6 if photo == 2 else photo
    if tags.get(284, 1) != 1:
        raise NotImplementedError(f"{name}: old-style JPEG in separate planes")
    if photo == 6 and spp != 3:
        raise ValueError(f"{name}: YCbCr of {spp} samples (libtiff refuses "
                         "the directory)")
    ycbcr = photo == 6
    if not ycbcr and spp != 1:
        raise NotImplementedError(f"{name}: old-style JPEG of {spp} samples "
                                  f"under photometric {photo}")
    offsets, _, tw, th, tiled = _layout(tags, w, h, name)
    th = th if tiled else min(th, h)
    across, down = -(-w // tw), -(-h // th)
    total = down * th if tiled else h
    hs, vs = (1, 1)
    if ycbcr:
        hs, vs = (tuple(tags.get(530, (2, 2))) + (2, 2))[:2]
        jif, parts = _ojpeg_sources(data, tags, across * down, name)
        found = _ojpeg_frame_sampling(jif + b"".join(parts))
        if found is not None:
            if found[1:] != [(1, 1)] * (len(found) - 1) or any(
                    f not in (1, 2, 4) for f in found[0]):
                raise NotImplementedError(
                    f"{name}: old-style JPEG of sampling factors TIFF has no "
                    "data units for (libtiff upsamples inside libjpeg)")
            hs, vs = found[0]
    stream, _ = _ojpeg_stream(data, tags, spp, hs, vs,
                              (tw, th, total, across * down), name)
    frame, planes = decode_jpeg_raw(stream, name)
    lines = -(-th // vs)  # data-unit rows a strip or tile
    out = np.zeros((h, w, 3 if ycbcr else 1), np.uint16 if not ycbcr
                   else np.uint8)
    tables = ycbcr_tables(tags.get(529, LUMA_DEFAULT),
                          tags.get(532, (0, 255, 128, 255, 128, 255)),
                          name) if ycbcr else None
    units_across = -(-tw // hs)
    for k in range(across * down):
        ty, tx = divmod(k, across)
        y0, x0 = ty * th, tx * tw
        rows = th if tiled else min(th, h - y0)
        n_lines = -(-rows // vs)
        top = k * lines  # the JPEG's data-unit row this strile starts at
        if not ycbcr:
            plane = planes[0]
            block = plane[top:top + rows, :tw]
            if block.shape != (rows, tw):
                raise NotImplementedError(f"{name}: old-style JPEG striles "
                                          "past the JPEG frame")
            ys, xs = min(rows, h - y0), min(tw, w - x0)
            out[y0:y0 + ys, x0:x0 + xs, 0] = block[:ys, :xs]
            continue
        yp, cb, cr = planes
        r = np.arange(n_lines)[:, None]
        c = np.arange(units_across)[None, :]
        ry = (top + r) * vs
        if ry.max() + vs > yp.shape[0] or (c.max() + 1) * hs > yp.shape[1]:
            raise NotImplementedError(f"{name}: old-style JPEG striles past "
                                      "the JPEG frame")
        units = np.empty((n_lines, units_across, hs * vs + 2), np.uint8)
        for sy in range(vs):
            for sx in range(hs):
                units[..., sy * hs + sx] = yp[ry + sy, c * hs + sx]
        units[..., -2] = cb[top + r, c]
        units[..., -1] = cr[top + r, c]
        _put_ycbcr(out, units.reshape(-1), y0, x0, rows, tw, hs, vs, tables)
    return out


def _ojpeg_frame_sampling(stream: bytes):
    """OJPEGSubsamplingCorrect's look at the stream: each component's (h,
    v) in the first SOF0/SOF1/SOF3 among the leading markers, or None."""
    pos = 0
    while pos + 1 < len(stream) and stream[pos] == 0xFF:
        pos += 1
        while pos < len(stream) and stream[pos] == 0xFF:
            pos += 1
        if pos >= len(stream):
            return None
        m = stream[pos]
        pos += 1
        if m == 0xD8:
            continue
        if pos + 2 > len(stream) or m == 0xDA:
            return None
        (n,) = struct.unpack_from(">H", stream, pos)
        if m in (0xC0, 0xC1, 0xC3):
            seg = stream[pos + 2:pos + n]
            nc = (n - 8) // 3
            if n < 11 or (n - 8) % 3 or len(seg) < 6 + 3 * nc or seg[0] != 8 \
                    or seg[5] != nc:
                return None
            return [(seg[7 + 3 * k] >> 4, seg[7 + 3 * k] & 15)
                    for k in range(nc)]
        if n < 2 or (m in (0xC4, 0xDB) and n <= 2) or (m == 0xDD and n != 4) \
                or (m not in (0xC4, 0xDB, 0xDD, 0xFE)
                    and not 0xE0 <= m <= 0xEF):
            return None
        pos += n
    return None


# WhiteIsZero gray: Pillow's raw modes that invert.
INVERTED = ("1;I", "1;IR", "L;2I", "L;2IR", "L;4I", "L;4IR", "L;I", "L;IR")
# Raw modes of Pillow's own (uncompressed) reads it has no unpacker for.
NO_UNPACKER = ("L;IR", "P;1R", "P;2R", "P;4R")
# Pillow's bands of a mode, for the separate planes its libtiff reader
# copies (one a band).
PLANE_COUNT = {"LA": 2, "PA": 2, "RGB": 3, "RGBA": 4, "CMYK": 4, "LAB": 3}
# A separate plane read uncompressed takes one character of the raw mode
# as its own raw mode: the bands Pillow unpacks that way, by image mode.
PLANE_BANDS = {"RGB": "RGB", "RGBA": "RGBA", "CMYK": "CMYK", "L": "L",
               "P": "P", "1": "1"}


def _raw(data, tags, order, w, h, spp, bits, planar, mode, rawmode, name):
    """Pillow's own decode of uncompressed data: each offset's strip or
    tile read as rows into its extent, moving on to the next layer once a
    pass covers the image, the tiles taken in the order of their offsets
    (a later one over an earlier one). A separate plane is read as one
    character of the raw mode: 8 bits a sample (1 for "1"), neither
    inverted nor reversed, whatever the file's bits. Raw mode "RGBX" (of
    YCbCr) reads four bytes a pixel. Returns (samples, bits, raw mode) of
    what was read."""
    offsets, _, tw, th, tiled = _layout(tags, w, h, name)
    fill = tags.get(266, 1)
    if planar != 2 and fill == 2 and rawmode in NO_UNPACKER:
        raise ValueError(f"{name}: Pillow has no unpacker for raw mode "
                         f"{rawmode!r}")
    if tw == w and th == h and planar != 2:
        offsets = offsets[-1:]
    tiles = []
    x = y = layer = 0
    for off in offsets:
        tiles.append((off, x, y, layer))
        x += tw
        if x >= w:
            x, y = 0, y + th
            if y >= h:
                y, layer = 0, layer + 1
    read = 4 if rawmode == "RGBX" else spp  # samples a pixel Pillow reads
    per = 1 if planar == 2 else read
    chars = rawmode
    if planar == 2:
        top_layer = max(t[3] for t in tiles) if tiles else 0
        if top_layer >= len(chars) or any(
                c not in PLANE_BANDS.get(mode, "") for c in chars[:top_layer + 1]):
            raise ValueError(f"{name}: Pillow has no unpacker for a separate "
                             f"plane of raw mode {rawmode!r}")
        rawmode = {"1": "1", "L": "L", "P": "P"}.get(mode, mode)
    # What no strip covers stays 0 in Pillow's image: a sample that an
    # inverting raw mode turns into 0; in "LAB", whose zero bytes no file
    # sample unpacks to (its fourth byte is 255), LAB_UNWRITTEN.
    out = np.full((h, w, per if planar != 2 else spp),
                  LAB_UNWRITTEN if rawmode == "LAB" else
                  (1 << bits) - 1 if rawmode in INVERTED else 0,
                  np.uint32 if bits == 32 else np.uint16)
    for off, x, y, layer in sorted(tiles, key=lambda t: t[0]):
        b = (1 if chars[layer] == "1" else 8) if planar == 2 else bits
        band = layer if planar == 2 else 0
        xe, ye = min(x + tw, w), min(y + th, h)
        # A tile past the right edge keeps its own row stride, and the last
        # row needs only the bytes of the image's part.
        line = ((xe - x) * per * b + 7) // 8
        stride = int(tw * bits * spp / 8 / (spp if planar == 2 else 1)) \
            if x + tw > w else line
        rows = ye - y
        if stride < line:
            raise ValueError(f"{name}: TIFF rows of {stride} bytes cannot "
                             f"hold {line} (Pillow: codec configuration "
                             "error)")
        need = stride * (rows - 1) + line
        if off + need > len(data):
            raise ValueError(f"{name}: the TIFF data is truncated")
        buf = np.zeros((rows, stride), np.uint8)
        buf.reshape(-1)[:need] = np.frombuffer(data, np.uint8, count=need,
                                               offset=off)
        if fill == 2 and planar != 2:
            buf = _REVERSE[buf]
        vals = _samples(buf, (xe - x) * per, b, order)
        out[y:ye, x:xe, band:band + per] = vals.reshape(rows, xe - x, per)
    return out, (8 if planar == 2 and bits != 1 else bits), rawmode


# A "LAB" pixel no strip wrote: Pillow's zero bytes (L* 0, a* and b*
# -128, the fourth byte 0), which convert to black-blue with alpha 0.
LAB_UNWRITTEN = 256

TRANSPOSE = {2: lambda a: a[:, ::-1], 3: lambda a: a[::-1, ::-1],
             4: lambda a: a[::-1], 5: lambda a: a.transpose(1, 0, 2),
             6: lambda a: a.transpose(1, 0, 2)[:, ::-1],
             7: lambda a: a.transpose(1, 0, 2)[::-1, ::-1],
             8: lambda a: a.transpose(1, 0, 2)[::-1]}


def _to_rgba(mode: str, raw: str, s: np.ndarray, bits: int,
             cmap) -> np.ndarray:
    """Samples read under Pillow's raw mode ``raw`` -> RGBA as
    ``convert("RGBA")`` gives it."""
    from wgpu_path_tracing_tpu_torch.utils.jpeg import pillow_cmyk_to_rgb
    from wgpu_path_tracing_tpu_torch.utils.pilmodes import gray8

    h, w = s.shape[:2]
    out = np.full((h, w, 4), 255, np.uint8)
    v = s[..., 0].astype(np.int64)
    if mode in ("1", "L"):
        top = (1 << bits) - 1
        if raw in INVERTED:
            v = top - v
        out[..., :3] = (v * (255 // top))[..., None]
        return out
    if mode == "F":  # Pillow's F -> L: clipped, then truncated; NaN 0
        out[..., :3] = gray8(s[..., 0].astype(np.uint32).view(np.float32))[
            ..., None]
        return out
    if mode in ("I;16", "I;16B", "I"):
        if raw in ("I;16S", "I;16BS"):
            v = np.where(v >= 32768, v - 65536, v)
        elif bits == 32:  # Pillow's "I" holds int32
            v = s[..., 0].astype(np.uint32).view(np.int32)
        out[..., :3] = gray8(v)[..., None]
        return out
    if mode == "LAB":
        from wgpu_path_tracing_tpu_torch.utils.lab import lab_to_rgb

        unwritten = s[..., 0] == LAB_UNWRITTEN
        lab = np.where(unwritten[..., None], np.array([0, 128, 128]),
                       s[..., :3])
        out[..., :3] = lab_to_rgb(lab.astype(np.uint8))
        out[..., 3] = np.where(unwritten, 0, 255)
        return out
    if mode in ("P", "PA"):
        n = len(cmap) // 3
        pal = (np.asarray(cmap[:3 * n], np.int64) // 256).astype(np.uint8)
        table = np.zeros((256, 3), np.uint8)
        entries = pal.reshape(3, n).T
        table[:len(entries)] = entries
        out[..., :3] = table[np.minimum(v, 255)]
        if mode == "PA":
            out[..., 3] = s[..., 1]
        return out
    s8 = (s >> 8 if bits == 16 else s).astype(np.int64)
    if mode == "LA":
        out[..., :3] = s8[..., :1]
        out[..., 3] = s8[..., 1]
    elif mode == "CMYK":
        out[..., :3] = pillow_cmyk_to_rgb(s8[..., :4])
    else:
        out[..., :3] = s8[..., :3]
        if mode == "RGBA":
            a = s8[..., 3]
            out[..., 3] = a
            if "a" in raw:  # associated alpha: Pillow's unpackRGBa
                div = np.minimum(s8[..., :3] * 255
                                 // np.maximum(a, 1)[..., None], 255)
                rgb = np.where((a == 255)[..., None], s8[..., :3], div)
                out[..., :3] = np.where((a == 0)[..., None], 0, rgb)
    return out


def decode_tiff_rgba(data: bytes, name: str = "image") -> np.ndarray:
    """TIFF bytes -> (H, W, 4) uint8 RGBA of the first page, what
    Pillow's ``Image.open(...).convert("RGBA")`` returns."""
    order, big, first = _header(data, name)
    tags, types = _ifd(data, order, first, name, big)
    if 0xBC01 in tags:
        raise ValueError(f"{name}: Windows Media Photo is not supported")
    if tags.get(259, 1) not in COMPRESSIONS:
        raise ValueError(f"{name}: unknown TIFF compression "
                         f"{tags.get(259)}")
    kind = COMPRESSIONS[tags.get(259, 1)]
    # Pillow takes old-style JPEG for YCbCr whatever the file says ("most
    # certainly"), and for 3 samples where the file gives no count.
    photo = 6 if kind == "tiff_jpeg" else tags.get(262, 0)
    fill = tags.get(266, 1)
    if 256 not in tags or 257 not in tags:
        raise ValueError(f"{name}: TIFF without its dimensions")
    w, h = tags[256], tags[257]
    fmt = tags.get(339, (1,))
    bps = tags.get(258, (1,))
    extra = tags.get(338, ())
    if len(fmt) > 1 and max(fmt) == min(fmt) == 1:
        fmt = (1,)
    spp = tags.get(277, 3 if kind == "tiff_jpeg" else 1)
    if spp < len(bps):
        bps = bps[:spp]
    elif spp > len(bps) and len(bps) == 1:
        bps = bps * spp
    if len(bps) != spp:
        raise ValueError(f"{name}: unknown TIFF data organization")
    planar = tags.get(284, 1)
    found = _mode((order, photo, fmt, fill, bps, extra))
    if found is None:
        raise ValueError(f"{name}: unknown TIFF pixel mode (photometric "
                         f"{photo}, sample format {fmt}, fill order {fill}, "
                         f"bits {bps}, extra samples {extra})")
    mode, raw = found
    if kind in REFUSED:
        raise ValueError(f"{name}: {REFUSED[kind]}")
    if kind not in READ:
        raise NotImplementedError(f"{name}: TIFF compression {kind!r} is "
                                  "not supported")
    if w <= 0 or h <= 0:
        raise ValueError(f"{name}: TIFF size {w}x{h} is empty")
    bomb_check(w, h, name)
    bits = bps[0]
    if mode in ("P", "PA") and (320 not in tags or len(tags[320]) < 3):
        raise ValueError(f"{name}: a palette TIFF without a ColorMap")
    if mode in ("P", "PA") and len(tags[320]) // 3 > 256:
        raise ValueError(f"{name}: a TIFF ColorMap of more than 256 "
                         "entries (Pillow: invalid palette size)")
    rps = tags.get(278)
    if rps == 0 and (kind != "raw" or 324 not in tags):
        raise ValueError(f"{name}: RowsPerStrip 0 (libtiff and Pillow refuse "
                         "it)")
    if kind == "raw":
        s, bits, raw = _raw(data, tags, order, w, h, spp, bits, planar, mode,
                            raw, name)
    else:
        # libtiff reads the directory again, and checks what Pillow's own
        # parser lets through.
        odd = {t: types[t] for t in BASELINE_TAGS + (-1,) if t in types
               and types[t] not in ((3, 4, 16) if big else (3, 4))}
        odd.update({t: 0 for t in types if t in BASELINE_TAGS
                    and t not in tags})
        if odd or planar not in (1, 2) or 258 not in tags:
            raise NotImplementedError(
                f"{name}: TIFF tags of field types {odd}, planar "
                f"configuration {planar} or no BitsPerSample, which libtiff "
                "may refuse")
        if big and data[4:8] != b"\x08\x00\x00\x00":
            raise ValueError(f"{name}: a BigTIFF header libtiff refuses")
        bands = PLANE_COUNT.get(mode, 1)
        if planar == 2 and bands > 1:
            # Pillow's libtiff reader copies plane k into byte k of each
            # 4-byte pixel (the high byte of a 16-bit sample) and reads the
            # bands from there.
            if photo == 6 and kind != "tiff_jpeg":
                raise (ValueError if kind == "jpeg" else NotImplementedError)(
                    f"{name}: compressed separate planes of YCbCr")
            if kind == "tiff_jpeg":
                raise NotImplementedError(f"{name}: old-style JPEG in "
                                          "separate planes")
            if bits not in (8, 16) or spp != bands:
                raise ValueError(f"{name}: {spp} separate planes of {bits}-bit "
                                 f"samples for mode {mode} (Pillow's libtiff "
                                 "reader refuses them)")
        # Pillow's strip buffer is RowsPerStrip rows (all of them for
        # 2^32 - 1): it refuses one past 2^31 - 1 bytes.
        row = w * 4 if photo == 6 and kind != "jpeg" else -(-w * sum(
            bps) // (spp if planar == 2 else 1) // 8)
        if 324 not in tags and isinstance(rps, int) and rps != 2 ** 32 - 1 \
                and (2 ** 31 - 1) // max(row, 1) < rps:
            raise ValueError(f"{name}: RowsPerStrip {rps} (Pillow: out of "
                             "memory)")
        if kind == "jpeg":
            s = _jpeg(data, tags, w, h, spp, photo, planar, name)
            raw = "RGB" if photo == 6 else raw
        elif kind == "tiff_jpeg":
            s = _ojpeg(data, tags, w, h, spp, name)
        elif photo == 6:
            if spp != 3:
                raise ValueError(f"{name}: YCbCr of {spp} samples (libtiff's "
                                 "RGBA reader refuses it)")
            s = _ycbcr(data, tags, order, kind, w, h, fmt, name)
        else:
            s = _compressed(data, tags, order, kind, w, h, spp, bits, planar,
                            fmt, name)
            if (bits == 32 or raw == "I;16BS") and order == ">":
                s = s.byteswap()  # libtiff's host order, read as the file's
            if planar == 2 and mode in ("LA", "PA"):
                s[..., 1] = 0  # plane 1 lands in byte 1; alpha is byte 3
            if planar == 2 and mode == "LAB":
                s[..., 1:3] ^= 128  # copied, not unpacked as signed bytes
    out = _to_rgba(mode, raw, s, bits, tags.get(320))
    if kind != "raw" and planar == 2 and mode == "LAB":
        out[..., 3] = 0  # byte 3, which no plane writes
    orientation = tags.get(274)
    if orientation in TRANSPOSE:
        out = np.ascontiguousarray(TRANSPOSE[orientation](out))
    return out
