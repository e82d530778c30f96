"""Baseline TIFF decoding in NumPy, the pixels Pillow gives.

The JAX package opens LDR environment maps and textures with Pillow
(``Image.open(...).convert("RGBA")``). Pillow 12.1.0 reads the first page
of a TIFF in one of two ways, and this module copies both:

* uncompressed data with its own raw decoder, strip by strip or tile by
  tile, from each offset (byte counts unread; one strip or tile that covers
  the image is read from the LAST offset), a separate plane (planar
  configuration 2) a band at a time, fill order 2 reversing each byte's
  bits; the predictor is not applied;
* compressed data through libtiff: PackBits (32773), LZW (5) and deflate
  (8, 32946), each strip or tile decoded to its whole size (a short one
  raises, extra data is ignored), fill order 2 reversing the bits of the
  compressed bytes, horizontal differencing (predictor 2) at 8 and 16 bits
  undone a sample at a time, 16-bit samples in the file's byte order.

Then Pillow's modes (``TiffImagePlugin.OPEN_INFO``) and conversions: 1, 2,
4 and 8-bit gray (WhiteIsZero inverted at up to 8 bits; 2 and 4 bits
scaled by 85 and 17), 16-bit gray clipped at 255 (not inverted under
WhiteIsZero, as Pillow reads it; signed samples clipped at 0), gray with
alpha, RGB at 8 and 16 bits (a 16-bit sample's high byte) with its extra
samples: unassociated alpha kept, associated alpha divided out as
Pillow's "RGBa" unpacker does, others dropped; palette images at 1-8 bits
(each ``ColorMap`` entry's high byte), with alpha; CMYK at 8 and 16 bits
through Pillow's ``cmyk2rgb``; and the ``Orientation`` tag, which
Pillow's TIFF loader applies (``ImageOps.exif_transpose``) after the load.

A separate plane read uncompressed takes one character of Pillow's raw
mode as its own: 8 bits a sample (1 for "1"), neither inverted nor
reversed, whatever the file says, as Pillow reads it. JPEG-in-TIFF (6,
7), YCbCr, CIELab, float and 32-bit samples, 12-bit samples, predictor 3,
old-style LZW, CCITT G3/G4 and the other codecs, BigTIFF, compressed
separate planes other than 8-bit RGB, RGBA and CMYK, and directories
libtiff may refuse where Pillow's parser does not (repeated tags, a
single-valued tag of several values, baseline tags of other types than
SHORT and LONG) raise ``NotImplementedError`` naming the image; what
Pillow refuses raises ``ValueError``. The PackBits and LZW loops are ``packbits_plain`` and
``lzw_plain`` here, the plain versions of ``accel/cbvh/image_scan.cpp``'s
``wpt_packbits`` and ``wpt_lzw``, which the native library runs wherever
``accel.native.native_available()``.
"""

from __future__ import annotations

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
READ = ("raw", "packbits", "tiff_lzw", "tiff_adobe_deflate", "tiff_deflate")
# Integer field types: (struct code, size).
TYPES = {1: ("B", 1), 3: ("H", 2), 4: ("I", 4), 6: ("b", 1), 8: ("h", 2),
         9: ("i", 4), 16: ("Q", 8)}
# Pillow's other field types, read and skipped: (size of a value).
OTHER_TYPES = {2: 1, 5: 8, 7: 1, 10: 8, 11: 4, 12: 8, 13: 4}
SCALAR_TAGS = {256, 257, 259, 262, 266, 274, 277, 278, 284, 317, 322, 323}
LZW_TABLE = 5119  # libtiff's CSIZE: entries past it corrupt the table
LZW_STATUS = {1: "corrupted LZW table", 2: "not enough LZW data",
              3: "old-style LZW codes are not supported"}

_REVERSE = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)
BASELINE_TAGS = (256, 257, 258, 259, 262, 266, 273, 274, 277, 278, 279, 284,
                 317, 320, 322, 323, 324, 325, 338, 339)


def _ifd(data: bytes, order: str, pos: int, name: str) -> tuple[dict, dict]:
    """The first IFD's tags as Pillow's ``tag_v2`` holds them (scalar tags
    a number, the others a tuple), and each tag's field type (minus its
    count for a single-valued tag of several values; key -1 for a
    repeated tag)."""
    if pos + 2 > len(data):
        raise ValueError(f"{name}: the TIFF directory is truncated")
    (n,) = struct.unpack_from(order + "H", data, pos)
    tags, types = {}, {}
    for i in range(n):
        at = pos + 2 + 12 * i
        if at + 12 > len(data):
            raise ValueError(f"{name}: the TIFF directory is truncated")
        tag, typ, count = struct.unpack_from(order + "HHI", data, at)
        if tag in types:
            types[-1] = tag  # a repeated tag: libtiff keeps another copy
        # libtiff refuses a count other than 1 for a single-valued tag,
        # where Pillow keeps the first value.
        types[tag] = typ if count == 1 or tag not in SCALAR_TAGS else -count
        if typ in OTHER_TYPES:
            size = count * OTHER_TYPES[typ]
            (off,) = struct.unpack_from(order + "I", data, at + 8)
            if size > 4 and off + size > len(data):
                raise ValueError(f"{name}: TIFF tag {tag}'s data is truncated")
            if tag in BASELINE_TAGS:
                raise NotImplementedError(f"{name}: TIFF tag {tag} of field "
                                          f"type {typ}")
            continue
        if typ not in TYPES:
            continue
        if typ == 1 and tag in BASELINE_TAGS:
            # Pillow holds a BYTE field as bytes, which its reader then
            # fails on (or reads as another image).
            raise ValueError(f"{name}: TIFF tag {tag} of field type BYTE")
        code, unit = TYPES[typ]
        size = count * unit
        off = at + 8
        if size > 4:
            (off,) = struct.unpack_from(order + "I", data, at + 8)
            if off + size > len(data):
                raise ValueError(f"{name}: TIFF tag {tag}'s data is truncated")
        if size == 0:
            continue
        vals = struct.unpack_from(f"{order}{count}{code}", data, off)
        tags[tag] = vals[0] if tag in SCALAR_TAGS else vals
    return tags, types


def _mode(key: tuple) -> tuple[str, str] | None:
    """``OPEN_INFO`` for the keys this module reads: (order, photometric,
    sample format, fill order, bits, extra samples) -> (Pillow's mode, its
    raw mode)."""
    order, photo, fmt, fill, bps, extra = key
    r = "R" if fill == 2 else ""
    if fill not in (1, 2):
        return None
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


def _lzw_codes(bits: np.ndarray, pos: int, first: int) -> tuple:
    """The codes from bit ``pos`` while no clear code comes: (codes, the
    bit after each), ``first`` codes decoded since the last clear. The
    width of each follows from that count alone: 9 bits up to code 253
    after a clear, then 10, 11 and 12, each one code early."""
    k = np.arange(first, first + 4096)
    width = 9 + (k >= 254) + (k >= 766) + (k >= 1790)
    ends = pos + np.cumsum(width)
    keep = ends <= len(bits)
    width, ends = width[keep], ends[keep]
    starts = ends - width
    idx = starts[:, None] + np.arange(12)[None, :]
    take = np.arange(12)[None, :] < width[:, None]
    got = np.where(take, bits[np.minimum(idx, len(bits) - 1)], 0)
    shift = width[:, None] - 1 - np.arange(12)[None, :]
    codes = (got.astype(np.int64) << np.maximum(shift, 0)).sum(1)
    return codes.tolist(), ends.tolist()


def lzw_plain(src: bytes, size: int) -> tuple[bytes, int]:
    """libtiff's ``LZWDecode`` (new-style codes, most significant bit
    first, the code width growing one code early) into ``size`` bytes:
    (bytes, status: 0, or a key of LZW_STATUS)."""
    if len(src) >= 2 and src[0] == 0 and src[1] & 1:
        return b"", 3
    bits = np.unpackbits(np.frombuffer(src, np.uint8))
    out = bytearray()
    table: list[bytes] = [bytes([i]) for i in range(256)] + [b"", b""]
    prev = -2  # -2: no clear code yet (libtiff's sentinel); -1: after one
    pos, count = 0, 0  # bit position; codes since the last clear
    while len(out) < size:
        codes, ends = _lzw_codes(bits, pos, count)
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


def _decompress(kind: str, src: bytes, size: int, name: str) -> np.ndarray:
    """One strip's or tile's ``size`` bytes, in C++ for PackBits and LZW
    wherever the native library builds."""
    from wgpu_path_tracing_tpu_torch.accel import native

    if kind == "tiff_lzw":
        fn = native.lzw_native if native.native_available() else lzw_plain
        out, status = fn(src, size)
        if status:
            raise (NotImplementedError if status == 3 else ValueError)(
                f"{name}: {LZW_STATUS[status]}")
    elif kind == "packbits":
        fn = (native.packbits_native if native.native_available()
              else packbits_plain)
        out, status = fn(src, size)
        if status:
            raise ValueError(f"{name}: not enough PackBits data")
    else:
        try:
            out = zlib.decompressobj().decompress(src, size)
        except zlib.error as exc:
            raise ValueError(f"{name}: bad deflate data ({exc})") from None
        if len(out) < size:
            raise ValueError(f"{name}: not enough deflate data")
    return np.frombuffer(out, np.uint8)


def _undo_predictor(rows: np.ndarray, spp: int, bits: int,
                    order: str) -> np.ndarray:
    """Horizontal differencing undone (libtiff's horAcc8/horAcc16) on
    (rows, bytes) of one strip or tile; 16-bit samples come back in the
    file's byte order."""
    n = rows.shape[0]
    if bits == 8:
        s = rows.reshape(n, -1, spp).astype(np.uint64)
        return (np.cumsum(s, axis=1) & 0xFF).astype(np.uint8).reshape(n, -1)
    dt = np.dtype(order + "u2")
    s = rows.view(dt).reshape(n, -1, spp).astype(np.uint64)
    acc = (np.cumsum(s, axis=1) & 0xFFFF).astype(dt)
    return acc.reshape(n, -1).view(np.uint8)


def _samples(rows: np.ndarray, count: int, bits: int, order: str) -> np.ndarray:
    """(rows, bytes) -> (rows, count) sample values at ``bits`` bits."""
    n = rows.shape[0]
    if bits == 8:
        return rows[:, :count]
    if bits == 16:
        return rows[:, :2 * count].copy().view(order + "u2")[:, :count]
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


def _compressed(data, tags, order, kind, w, h, spp, bits, planar, name):
    """libtiff's decode: (H, W, spp) samples, each strip or tile decoded to
    its whole size; rows and columns past the image are dropped."""
    fill = tags.get(266, 1)
    predictor = tags.get(317, 1) if kind != "packbits" else 1
    if predictor not in (1, 2):
        raise NotImplementedError(f"{name}: TIFF predictor {predictor}")
    if predictor == 2 and bits not in (8, 16):
        raise ValueError(f"{name}: horizontal differencing of {bits}-bit "
                         "samples (libtiff refuses it)")
    offsets, counts, tw, th, tiled = _layout(tags, w, h, name)
    if counts is None:
        raise NotImplementedError(f"{name}: compressed TIFF data without "
                                  "byte counts")
    th = th if tiled else min(th, h)
    per = spp if planar == 1 else 1
    n_planes = 1 if planar == 1 else spp
    across, down = -(-w // tw), -(-h // th)
    if len(offsets) < across * down * n_planes or len(counts) < len(offsets):
        raise ValueError(f"{name}: too few TIFF strips or tiles")
    line = (tw * per * bits + 7) // 8
    out = np.zeros((h, w, spp), np.uint16)
    for p in range(n_planes):
        for k in range(across * down):
            ty, tx = divmod(k, across)
            y0, x0 = ty * th, tx * tw
            rows = th if tiled else min(th, h - y0)
            i = p * across * down + k
            if offsets[i] + counts[i] > len(data):
                raise ValueError(f"{name}: TIFF strip or tile {i} runs past "
                                 "the end of the file")
            src = data[offsets[i]:offsets[i] + counts[i]]
            if fill == 2:
                src = _REVERSE[np.frombuffer(src, np.uint8)].tobytes()
            buf = _decompress(kind, src, rows * line, name).reshape(rows, line)
            if predictor == 2:
                buf = _undo_predictor(buf, per, bits, order)
            vals = _samples(buf, tw * per, bits, order).reshape(rows, tw, per)
            ys, xs = min(rows, h - y0), min(tw, w - x0)
            out[y0:y0 + ys, x0:x0 + xs, p:p + per] = vals[:ys, :xs]
    return out


# WhiteIsZero gray: Pillow's raw modes that invert.
INVERTED = ("1;I", "1;IR", "L;2I", "L;2IR", "L;4I", "L;4IR", "L;I", "L;IR")
# Raw modes of Pillow's own (uncompressed) reads it has no unpacker for.
NO_UNPACKER = ("L;IR", "P;1R", "P;2R", "P;4R")
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
    inverted nor reversed, whatever the file's bits. Returns (samples,
    bits, raw mode) of what was read."""
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
    per = 1 if planar == 2 else spp
    chars = rawmode
    if planar == 2:
        top_layer = max(t[3] for t in tiles) if tiles else 0
        if top_layer >= len(chars) or any(
                c not in PLANE_BANDS.get(mode, "") for c in chars[:top_layer + 1]):
            raise ValueError(f"{name}: Pillow has no unpacker for a separate "
                             f"plane of raw mode {rawmode!r}")
        rawmode = {"1": "1", "L": "L", "P": "P"}.get(mode, mode)
    # What no strip covers stays 0 in Pillow's image: a sample that an
    # inverting raw mode turns into 0.
    out = np.full((h, w, spp), (1 << bits) - 1 if rawmode in INVERTED else 0,
                  np.uint16)
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

    h, w = s.shape[:2]
    out = np.full((h, w, 4), 255, np.uint8)
    v = s[..., 0].astype(np.int64)
    if mode in ("1", "L"):
        top = (1 << bits) - 1
        if raw in INVERTED:
            v = top - v
        out[..., :3] = (v * (255 // top))[..., None]
        return out
    if mode in ("I;16", "I;16B", "I"):
        if raw in ("I;16S", "I;16BS"):
            v = np.where(v >= 32768, v - 65536, v)
        out[..., :3] = np.clip(v, 0, 255)[..., None]
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
    if not data.startswith(TIFF_PREFIXES):
        raise ValueError(f"{name}: not a TIFF file")
    if data[2] == 43 or data[3] == 43:
        raise NotImplementedError(f"{name}: BigTIFF is not supported")
    order = "<" if data[:2] == b"II" else ">"
    if len(data) < 8:
        raise ValueError(f"{name}: the TIFF header is truncated")
    (first,) = struct.unpack_from(order + "I", data, 4)
    tags, types = _ifd(data, order, first, name)
    if 0xBC01 in tags:
        raise ValueError(f"{name}: Windows Media Photo is not supported")
    if tags.get(259, 1) not in COMPRESSIONS:
        raise ValueError(f"{name}: unknown TIFF compression "
                         f"{tags.get(259)}")
    kind = COMPRESSIONS[tags.get(259, 1)]
    if kind not in READ:
        raise NotImplementedError(f"{name}: TIFF compression {kind!r} is "
                                  "not supported")
    photo = tags.get(262, 0)
    fill = tags.get(266, 1)
    if 256 not in tags or 257 not in tags:
        raise ValueError(f"{name}: TIFF without its dimensions")
    w, h = tags[256], tags[257]
    fmt = tags.get(339, (1,))
    bps = tags.get(258, (1,))
    extra = tags.get(338, ())
    if len(fmt) > 1 and max(fmt) == min(fmt) == 1:
        fmt = (1,)
    spp = tags.get(277, 1)
    if spp < len(bps):
        bps = bps[:spp]
    elif spp > len(bps) and len(bps) == 1:
        bps = bps * spp
    if len(bps) != spp:
        raise ValueError(f"{name}: unknown TIFF data organization")
    if photo in (6, 8) or 3 in fmt or max(bps) > 16 or 12 in bps:
        raise NotImplementedError(
            f"{name}: TIFF photometric {photo}, sample format {fmt} at "
            f"{bps} bits is not supported")
    planar = tags.get(284, 1)
    found = _mode((order, photo, fmt, fill, bps, extra))
    if found is None:
        raise ValueError(f"{name}: unknown TIFF pixel mode (photometric "
                         f"{photo}, sample format {fmt}, fill order {fill}, "
                         f"bits {bps}, extra samples {extra})")
    mode, raw = found
    if w <= 0 or h <= 0:
        raise ValueError(f"{name}: TIFF size {w}x{h} is empty")
    bomb_check(w, h, name)
    bits = bps[0]
    if mode in ("P", "PA") and (320 not in tags or len(tags[320]) < 3):
        raise ValueError(f"{name}: a palette TIFF without a ColorMap")
    if mode in ("P", "PA") and len(tags[320]) // 3 > 256:
        raise ValueError(f"{name}: a TIFF ColorMap of more than 256 "
                         "entries (Pillow: invalid palette size)")
    if kind == "raw":
        s, bits, raw = _raw(data, tags, order, w, h, spp, bits, planar, mode,
                            raw, name)
    else:
        # libtiff reads the directory again, and checks what Pillow's own
        # parser lets through.
        odd = {t: types[t] for t in BASELINE_TAGS + (-1,) if t in types
               and types[t] not in (3, 4)}
        odd.update({t: 0 for t in types if t in BASELINE_TAGS
                    and t not in tags})
        if odd or planar not in (1, 2) or 258 not in tags:
            raise NotImplementedError(
                f"{name}: TIFF tags of field types {odd}, planar "
                f"configuration {planar} or no BitsPerSample, which libtiff "
                "may refuse")
        if planar == 2 and spp > 1 and not (
                bits == 8 and raw in ("RGB", "RGBA", "RGBa", "CMYK")):
            raise NotImplementedError(f"{name}: a compressed separate-plane "
                                      f"TIFF of raw mode {raw!r}")
        if order == ">" and raw in ("I;16BS",):
            raise NotImplementedError(f"{name}: compressed big-endian signed "
                                      "16-bit samples")
        s = _compressed(data, tags, order, kind, w, h, spp, bits, planar,
                        name)
    out = _to_rgba(mode, raw, s, bits, tags.get(320))
    orientation = tags.get(274)
    if orientation in TRANSPOSE:
        out = np.ascontiguousarray(TRANSPOSE[orientation](out))
    return out
