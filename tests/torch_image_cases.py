"""Small writers of TGA, BMP (DIB, ICO, CUR), netpbm and TIFF files for the
LDR readers' tests (``utils/tga.py``, ``bmp.py``, ``netpbm.py``,
``tiff.py``), and the fixtures under ``tests/ldr/``.

The writers make what Pillow cannot write: TGA at 16 bits and through a
colour map of 16 bits, RLE packets that run across rows, every origin;
BMP with RLE8 and RLE4 (their escapes included), OS/2 and V2-V5 headers,
bit fields, top-down rows and short palettes; cursors; netpbm with
comments anywhere and any maxval; TIFF in strips or tiles, in separate
planes, in either byte order, under PackBits, LZW or deflate with or
without horizontal differencing, fill order 2 and an orientation. Each
file is decoded by Pillow, the reference, and by the port; only the
decoders are compared. The writers need NumPy only (the card's host has
no Pillow, and ``chip_smoke.py`` makes its timing files with them); the
fixture writer uses Pillow's own encoders where Pillow has one.

``python -m tests.torch_image_cases`` writes ``tests/ldr/`` anew: the
files, Pillow's ``convert("RGBA")`` of each in ``pillow_rgba.npz``, and
the SHA-256 of each decode in ``pillow_sha256.json``; byte for byte the
same each time.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import struct
import zlib

import numpy as np

LDR_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "ldr")


def sample_image(w: int, h: int, seed: int = 0, channels: int = 4,
                 noise: float = 0.15) -> np.ndarray:
    """(h, w, channels) uint8: separable gradients and ripples, columns
    quantized every fifth pixel (runs for RLE) and seeded noise on two
    rows in seven."""
    rng = np.random.default_rng(seed)
    y = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None]
    x = np.linspace(0.0, 1.0, w, dtype=np.float32)[None, :]
    planes = [0.2 + 0.6 * y + 0.0 * x, 0.5 + 0.4 * np.sin(6 * x) * np.cos(y),
              1.0 - 0.8 * y * x, 0.5 + 0.5 * np.cos(5 * y) + 0.0 * x]
    img = np.floor(np.stack(planes[:channels], -1) * 255.0)
    img[:, ::5] = np.floor(img[:, ::5] / 32) * 32
    band = np.flatnonzero(np.arange(h) % 7 < 2)
    img[band] += noise * 255.0 * rng.random((len(band), w, channels),
                                            dtype=np.float32)
    return np.clip(img, 0, 255).astype(np.uint8)


def pillow_rgba(data: bytes) -> np.ndarray:
    """Pillow's ``Image.open(...).convert("RGBA")`` (the reference)."""
    from PIL import Image

    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGBA"))


def pillow_bytes(img, fmt: str, **kw) -> bytes:
    """A NumPy image or PIL image written by Pillow's own encoder."""
    from PIL import Image

    if isinstance(img, np.ndarray):
        img = Image.fromarray(img)
    buf = io.BytesIO()
    img.save(buf, fmt, **kw)
    return buf.getvalue()


def decode_in(in_cxx: bool, data: bytes, name: str = "case") -> np.ndarray:
    """``utils/image.py::decode_image_rgba`` with the C++ loops, or with
    their plain Python versions (``native_available`` made False)."""
    from wgpu_path_tracing_tpu_torch.accel import native
    from wgpu_path_tracing_tpu_torch.utils.image import decode_image_rgba

    real = native.native_available
    native.native_available = real if in_cxx else (lambda: False)
    try:
        return decode_image_rgba(data, name)
    finally:
        native.native_available = real


def assert_like_pillow(data: bytes, name: str = "case") -> np.ndarray:
    """Both ways of decoding equal to Pillow's RGBA; returns it."""
    want = pillow_rgba(data)
    for in_cxx in (True, False):
        np.testing.assert_array_equal(decode_in(in_cxx, data, name), want,
                                      err_msg=f"{name}, in C++: {in_cxx}")
    return want


def assert_refused(data: bytes, name: str = "r.img",
                   exc=(ValueError, NotImplementedError),
                   match: str = "") -> None:
    """Pillow refuses ``data`` (or opens it as a format not read here), and
    both ways of decoding raise ``exc`` naming ``name``."""
    import pytest

    for in_cxx in (True, False):
        with pytest.raises(exc, match=f"{name}: {match}"):
            decode_in(in_cxx, data, name)


def pillow_refuses(data: bytes) -> bool:
    try:
        pillow_rgba(data)
    except Exception:
        return True
    return False


# --- TGA -----------------------------------------------------------------------


def to_a1r5g5b5(rgba: np.ndarray) -> np.ndarray:
    """(..., 4) uint8 -> (..., 2) little-endian A1R5G5B5 bytes, the top
    bit SET where alpha is below 128 (Pillow reads a set bit as alpha 0)."""
    v = ((rgba[..., 0].astype(np.uint16) >> 3) << 10
         | (rgba[..., 1].astype(np.uint16) >> 3) << 5
         | rgba[..., 2].astype(np.uint16) >> 3)
    v = v | np.where(rgba[..., 3] < 128, 0x8000, 0).astype(np.uint16)
    return v.astype("<u2").view(np.uint8).reshape(rgba.shape[:-1] + (2,))


def _runs(stream: np.ndarray, row_px: int) -> tuple[np.ndarray, np.ndarray]:
    """Starts and lengths of runs of equal pixels in (n, bpp), none across
    a row boundary."""
    n = len(stream)
    same = np.zeros(n, bool)
    same[1:] = (stream[1:] == stream[:-1]).all(-1)
    same[::row_px] = False
    starts = np.flatnonzero(~same)
    return starts, np.diff(np.append(starts, n))


def tga_rle(stream: np.ndarray, row_px: int, cross_rows: bool = True) -> bytes:
    """TGA run-length packets of the pixels (n, bpp) in stored order: runs
    of two or more a run packet (never across a row), the rest raw packets
    of up to 128 pixels, across rows when ``cross_rows``."""
    starts, lengths = _runs(stream, row_px)
    raw = stream.tobytes()
    bpp = stream.shape[1]
    out = bytearray()

    def literal(lo: int, hi: int) -> None:
        while lo < hi:
            k = min(128, hi - lo)
            if not cross_rows:
                k = min(k, row_px - lo % row_px)
            out.append(k - 1)
            out.extend(raw[lo * bpp:(lo + k) * bpp])
            lo += k

    at = 0  # first pixel not yet written
    for s, k in zip(starts[lengths > 1].tolist(),
                    lengths[lengths > 1].tolist()):
        literal(at, s)  # the single pixels before this run
        at = s + k
        while k > 0:
            m = min(128, k)
            out.append(0x80 | (m - 1))
            out.extend(raw[s * bpp:(s + 1) * bpp])
            s += m
            k -= m
    literal(at, len(stream))
    return bytes(out)


def write_tga(px: np.ndarray, itype: int, depth: int, *, bottom: bool = True,
              mirror: bool = False, cmap: np.ndarray | None = None,
              cmap_start: int = 0, cmap_depth: int = 24, ident: bytes = b"",
              cross_rows: bool = True, gray_alpha: bool = False) -> bytes:
    """A TGA of ``px`` (h, w, bytes a pixel) as stored a pixel (BGR(A),
    A1R5G5B5, gray, gray + alpha or an index), top row first as displayed;
    ``bottom`` stores rows bottom-up (origin bit 5 clear), ``mirror`` right
    to left (bit 4). RLE for image types 9-11. ``cmap`` (n, bytes an entry)
    as stored."""
    h, w = px.shape[:2]
    stored = px[::-1] if bottom else px
    stored = stored[:, ::-1] if mirror else stored
    flags = (0 if bottom else 0x20) | (0x10 if mirror else 0)
    if gray_alpha or depth == 32:
        flags |= 8
    elif depth == 16 and itype & 3 == 2:
        flags |= 1
    cmap_len = 0 if cmap is None else len(cmap)
    head = struct.pack("<BBBHHBHHHHBB", len(ident), int(cmap is not None),
                       itype, cmap_start, cmap_len,
                       cmap_depth if cmap is not None else 0, 0, 0, w, h,
                       depth, flags)
    if depth == 1:
        body = np.packbits(stored[..., 0] > 0, axis=1).tobytes()
    elif itype & 8:
        body = tga_rle(stored.reshape(h * w, -1), w, cross_rows)
    else:
        body = stored.tobytes()
    pal = b"" if cmap is None else np.ascontiguousarray(cmap, np.uint8).tobytes()
    return head + ident + pal + body


# --- BMP, DIB, ICO, CUR ----------------------------------------------------------


def rle8_rows(idx: np.ndarray, absolute: bool = True) -> bytes:
    """RLE8 of (h, w) indices in stored order: runs as encoded pairs,
    stretches of three or more differing pixels as absolute runs (padded to
    16 bits), an end-of-line after each row and end-of-bitmap last."""
    out = bytearray()
    for row in idx:
        starts, lengths = _runs(row[:, None], len(row))
        singles = []

        def flush():
            while singles:
                part = singles[:255]
                del singles[:255]
                if len(part) >= 3 and absolute:
                    out.extend([0, len(part)])
                    out.extend(part)
                    if len(part) % 2:
                        out.append(0)
                else:
                    for v in part:
                        out.extend([1, v])

        for s, k in zip(starts.tolist(), lengths.tolist()):
            if k == 1:
                singles.append(int(row[s]))
                continue
            flush()
            while k:
                m = min(255, k)
                out.extend([m, int(row[s])])
                k -= m
        flush()
        out.extend([0, 0])
    out.extend([0, 1])
    return bytes(out)


def rle4_rows(idx: np.ndarray) -> bytes:
    """RLE4 of (h, w) 4-bit indices: pairs of pixels as encoded runs of
    two alternating nibbles, absolute runs of an even count where pairs
    differ, end-of-line and end-of-bitmap."""
    out = bytearray()
    for row in idx:
        pairs = [(int(row[i]), int(row[i + 1]) if i + 1 < len(row) else 0)
                 for i in range(0, len(row), 2)]
        i = 0
        while i < len(pairs):
            j = i
            while j + 1 < len(pairs) and pairs[j + 1] == pairs[i] and j - i < 126:
                j += 1
            if j > i or len(pairs) - i < 2:
                n = min(2 * (j - i + 1), len(row) - 2 * i)
                out.extend([n, pairs[i][0] << 4 | pairs[i][1]])
                i = j + 1
                continue
            k = i
            while k < len(pairs) and (k + 1 >= len(pairs) or pairs[k + 1] != pairs[k]) \
                    and k - i < 60 and 2 * (k + 1) <= len(row):
                k += 1
            n = 2 * (k - i)
            if n < 4:
                out.extend([2 if 2 * i + 2 <= len(row) else 1,
                            pairs[i][0] << 4 | pairs[i][1]])
                i += 1
                continue
            data = bytes(p[0] << 4 | p[1] for p in pairs[i:k])
            out.extend([0, n])
            out.extend(data)
            if len(data) % 2:
                out.append(0)
            i = k
        out.extend([0, 0])
    out.extend([0, 1])
    return bytes(out)


def write_bmp(pixels: np.ndarray, bits: int, *, header: int = 40,
              compression: int = 0, palette: np.ndarray | None = None,
              colors: int | None = None, masks=None, top_down: bool = False,
              file_header: bool = True, rle_data: bytes | None = None,
              data_offset: int | None = None) -> bytes:
    """A BMP (or a bare DIB without ``file_header``) of ``pixels``, top row
    first: (h, w) indices at 1, 4 and 8 bits, or (h, w, bytes) as stored a
    pixel (16: little-endian words; 24: BGR; 32: BGRX or as ``masks``
    say). ``palette`` (n, 3) RGB; ``colors`` the header's count (default
    the palette's length, 0 for none). ``rle_data`` replaces the pixel data
    (BI_RLE8 = 1, BI_RLE4 = 2)."""
    h, w = pixels.shape[:2]
    stored = pixels if top_down else pixels[::-1]
    if rle_data is not None:
        body = rle_data
    elif bits < 8:
        per = 8 // bits
        padded = np.zeros((h, -(-w // per) * per), np.uint8)
        padded[:, :w] = stored
        vals = padded.reshape(h, -1, per)
        shifts = (8 - bits * (1 + np.arange(per))).astype(np.uint8)
        packed = (vals << shifts).sum(-1, dtype=np.uint8)
        body = _pad_rows(packed)
    else:
        body = _pad_rows(stored.reshape(h, -1))
    pal = b""
    n_pal = 0 if palette is None else len(palette)
    if palette is not None:
        entry = 3 if header == 12 else 4
        p = np.zeros((n_pal, entry), np.uint8)
        p[:, :3] = np.asarray(palette, np.uint8)[:, ::-1]
        pal = p.tobytes()
    if header == 12:
        info = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        info = struct.pack("<IiiHHIIiiII", header, w, -h if top_down else h, 1,
                           bits, compression, len(body), 2835, 2835,
                           n_pal if colors is None else colors, 0)
        if header > 40:
            extra = bytearray(header - 40)
            if masks is not None:
                m = struct.pack(f"<{len(masks)}I", *masks)
                extra[:len(m)] = m
            info += bytes(extra)
        elif masks is not None:
            info += struct.pack("<3I", *masks[:3])
    offset = (14 if file_header else 0) + len(info) + len(pal)
    if data_offset is not None:
        offset = data_offset
    body_at = (14 if file_header else 0) + len(info) + len(pal)
    gap = bytes(max(0, offset - body_at)) if file_header else b""
    if not file_header:
        return info + pal + body
    size = body_at + len(gap) + len(body)
    return (b"BM" + struct.pack("<IHHI", size, 0, 0, offset) + info + pal
            + gap + body)


def _pad_rows(rows: np.ndarray) -> bytes:
    stride = -(-rows.shape[1] // 4) * 4
    out = np.zeros((rows.shape[0], stride), np.uint8)
    out[:, :rows.shape[1]] = rows
    return out.tobytes()


def and_mask(alpha: np.ndarray) -> bytes:
    """The AND mask of an icon frame (1 where transparent), bottom-up, rows
    padded to 32 bits."""
    h, w = alpha.shape
    bits = np.zeros((h, -(-w // 32) * 32), np.uint8)
    bits[:, :w] = alpha < 128
    return np.packbits(bits[::-1], axis=1).tobytes()


def icon_dib(rgba: np.ndarray, bits: int = 32,
             palette: np.ndarray | None = None,
             idx: np.ndarray | None = None) -> bytes:
    """An icon frame's DIB: a 40-byte header of twice the height, the XOR
    pixels (32-bit BGRA, 24-bit BGR, or indices through ``palette``), then
    the AND mask from ``rgba``'s alpha."""
    h, w = rgba.shape[:2]
    if bits == 32:
        px = rgba[..., [2, 1, 0, 3]]
    elif bits == 24:
        px = rgba[..., 2::-1]
    else:
        px = idx
    dib = write_bmp(px, bits, palette=palette, file_header=False)
    info = bytearray(dib[:40])
    info[8:12] = struct.pack("<i", 2 * h)
    return bytes(info) + dib[40:] + and_mask(rgba[..., 3])


def write_icon(frames: list, cursor: bool = False) -> bytes:
    """An ICO (or CUR) of ``frames``: (frame bytes, directory width,
    height, colour count, bits (ICO) or hotspot x (CUR), planes (ICO) or
    hotspot y (CUR)), laid out after the directory."""
    out = bytearray(struct.pack("<HHH", 0, 2 if cursor else 1, len(frames)))
    at = 6 + 16 * len(frames)
    for data, w, h, ncol, a, b in frames:
        out += struct.pack("<BBBBHHII", w & 255, h & 255, ncol, 0, b, a,
                           len(data), at) if not cursor else struct.pack(
            "<BBBBHHII", w & 255, h & 255, ncol, 0, a, b, len(data), at)
        at += len(data)
    for data, *_ in frames:
        out += data
    return bytes(out)


# --- netpbm ----------------------------------------------------------------------


def write_netpbm(magic: bytes, values: np.ndarray, maxval: int | None = None,
                 *, comments: bool = False, line: int = 12) -> bytes:
    """P1-P6 of ``values`` ((h, w) or (h, w, 3), top row first): plain
    files as decimal tokens ``line`` a line, binary ones at one byte a
    sample below 256, two (big-endian) above; ``comments`` puts a comment
    in the header (inside the width token too) and in plain data."""
    h, w = values.shape[:2]
    if comments:
        head = magic + b"\n# written by tests\n" + (
            f"{w // 10}#inner\n{w % 10} {h}\n".encode() if w >= 10
            else f"{w} {h}\n".encode())
    else:
        head = magic + f"\n{w} {h}\n".encode()
    if magic not in (b"P1", b"P4"):
        head += f"{maxval}\n".encode()
    flat = np.asarray(values).reshape(-1)
    if magic == b"P4":
        return head + np.packbits(np.asarray(values).reshape(h, w) > 0,
                                  axis=1).tobytes()
    if magic in (b"P5", b"P6"):
        dt = np.uint8 if maxval < 256 else np.dtype(">u2")
        return head + flat.astype(dt).tobytes()
    tokens = [str(int(v)).encode() for v in flat]
    lines = []
    for i in range(0, len(tokens), line):
        lines.append(b" ".join(tokens[i:i + line])
                     + (b" # row note" if comments and i % (3 * line) == 0 else b""))
    return head + b"\n".join(lines) + b"\n"


# --- TIFF ------------------------------------------------------------------------


def packbits(data: bytes) -> bytes:
    """PackBits: runs of 3 or more as repeats, the rest literal (128 at
    most a packet)."""
    out = bytearray()
    i, n = 0, len(data)
    while i < n:
        j = i
        while j + 1 < n and data[j + 1] == data[i] and j - i < 127:
            j += 1
        if j - i >= 2:
            out += bytes([257 - (j - i + 1), data[i]])
            i = j + 1
            continue
        k = i
        while k < n and k - i < 128 and not (k + 2 < n and data[k] == data[k + 1] == data[k + 2]):
            k += 1
        out.append(k - i - 1)
        out += data[i:k]
        i = k
    return bytes(out)


def lzw(data: bytes) -> bytes:
    """TIFF LZW as libtiff writes it: codes most significant bit first, a
    clear code first and whenever the table fills, the width growing one
    code early, an end-of-information code last."""
    codes, widths = [256], [9]
    if not data:
        codes.append(257)
        widths.append(9)
        return _pack_codes(codes, widths)
    table: dict[int, int] = {}
    nxt, width, maxcode = 258, 9, 511
    w = data[0]
    for c in data[1:]:
        key = w << 8 | c
        code = table.get(key)
        if code is not None:
            w = code
            continue
        codes.append(w)
        widths.append(width)
        table[key] = nxt
        nxt += 1
        if nxt == 4094:
            codes.append(256)
            widths.append(width)
            table.clear()
            nxt, width, maxcode = 258, 9, 511
        elif nxt > maxcode:
            width += 1
            maxcode = (1 << width) - 1
        w = c
    codes.append(w)
    widths.append(width)
    nxt += 1
    if nxt == 4094:
        codes.append(256)
        widths.append(width)
        width = 9
    elif nxt > maxcode:
        width += 1
    codes.append(257)
    widths.append(width)
    return _pack_codes(codes, widths)


def _pack_codes(codes: list, widths: list) -> bytes:
    c = np.asarray(codes, np.uint32)
    wd = np.asarray(widths, np.uint8)
    top = 12
    bits = ((c[:, None] >> np.arange(top - 1, -1, -1, dtype=np.uint32)) & 1)
    keep = np.arange(top)[None, :] >= (top - wd[:, None])
    return np.packbits(bits[keep].astype(np.uint8)).tobytes()


def predict(rows: np.ndarray, spp: int, bits: int, order: str) -> np.ndarray:
    """Horizontal differencing of (rows, bytes) a sample apart."""
    n = rows.shape[0]
    if bits == 8:
        s = rows.reshape(n, -1, spp).astype(np.int16)
        d = s.copy()
        d[:, 1:] = s[:, 1:] - s[:, :-1]
        return (d & 0xFF).astype(np.uint8).reshape(n, -1)
    dt = np.dtype(order + "u2")
    s = rows.copy().view(dt).reshape(n, -1, spp).astype(np.int32)
    d = s.copy()
    d[:, 1:] = s[:, 1:] - s[:, :-1]
    return (d & 0xFFFF).astype(dt).reshape(n, -1).view(np.uint8)


_REV = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)
COMPRESS = {1: lambda b: b, 5: lzw, 8: lambda b: zlib.compress(b, 6),
            32946: lambda b: zlib.compress(b, 6), 32773: packbits}


def write_tiff(samples: np.ndarray, bits: int, photometric: int, *,
               compression: int = 1, predictor: int = 1, order: str = "<",
               rows_per_strip: int | None = None, tile: tuple | None = None,
               planar: int = 1, fill: int = 1, extra: tuple = (),
               orientation: int | None = None, colormap=None,
               sample_format: int | None = None) -> bytes:
    """A one-page TIFF of ``samples`` (h, w, spp) at ``bits`` (1-16) a
    sample, top row first: strips of ``rows_per_strip`` rows or tiles of
    ``tile = (w, h)``, chunky or in separate planes, compressed with
    ``compression`` (1, 5, 8, 32773, 32946), ``predictor`` 2 differencing
    (8 and 16 bits), ``fill`` 2 reversing the bits of each stored byte."""
    h, w, spp = samples.shape
    byte_order = b"II" if order == "<" else b"MM"
    tw, th = tile if tile else (w, rows_per_strip or h)
    chunks = []
    per = spp if planar == 1 else 1
    for p in range(1 if planar == 1 else spp):
        src = samples if planar == 1 else samples[..., p:p + 1]
        for ty in range(0, h, th):
            for tx in range(0, w, tw if tile else w):
                if tile:
                    block = np.zeros((th, tw, per), samples.dtype)
                    part = src[ty:ty + th, tx:tx + tw]
                    block[:part.shape[0], :part.shape[1]] = part
                else:
                    block = src[ty:ty + th]
                rows = _pack_samples(block, bits, order)
                if predictor == 2:
                    rows = predict(rows, per, bits, order)
                raw = rows.tobytes()
                data = COMPRESS[compression](raw)
                if fill == 2:
                    data = _REV[np.frombuffer(data, np.uint8)].tobytes()
                chunks.append(data)
    entries = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * spp),
               259: (3, [compression]), 262: (3, [photometric]),
               277: (3, [spp]), 284: (3, [planar])}
    if fill != 1:
        entries[266] = (3, [fill])
    if predictor != 1:
        entries[317] = (3, [predictor])
    if extra:
        entries[338] = (3, list(extra))
    if orientation is not None:
        entries[274] = (3, [orientation])
    if colormap is not None:
        entries[320] = (3, [int(v) for v in np.asarray(colormap).reshape(-1)])
    if sample_format is not None:
        entries[339] = (3, [sample_format] * spp)
    if tile:
        entries[322] = (4, [tw])
        entries[323] = (4, [th])
        off_tag, cnt_tag = 324, 325
    else:
        entries[278] = (4, [th])
        off_tag, cnt_tag = 273, 279
    body = bytearray(byte_order + struct.pack(order + "HI", 42, 0))
    offsets = []
    for data in chunks:
        offsets.append(len(body))
        body += data
        if len(body) % 2:
            body.append(0)
    entries[off_tag] = (4, offsets)
    entries[cnt_tag] = (4, [len(d) for d in chunks])
    ifd_at = len(body)
    struct.pack_into(order + "I", body, 4, ifd_at)
    tags = sorted(entries)
    values_at = ifd_at + 2 + 12 * len(tags) + 4
    ifd = bytearray(struct.pack(order + "H", len(tags)))
    blob = bytearray()
    for tag in tags:
        typ, vals = entries[tag]
        code = "H" if typ == 3 else "I"
        payload = struct.pack(f"{order}{len(vals)}{code}", *vals)
        if len(payload) <= 4:
            ifd += struct.pack(order + "HHI", tag, typ, len(vals)) + payload.ljust(4, b"\0")
        else:
            ifd += struct.pack(order + "HHII", tag, typ, len(vals),
                               values_at + len(blob))
            blob += payload
            if len(blob) % 2:
                blob.append(0)
    ifd += struct.pack(order + "I", 0)
    return bytes(body + ifd + blob)


def _pack_samples(block: np.ndarray, bits: int, order: str) -> np.ndarray:
    """(rows, w, spp) samples -> (rows, bytes) at ``bits`` a sample, rows
    padded to whole bytes."""
    n = block.shape[0]
    flat = block.reshape(n, -1)
    if bits == 8:
        return flat.astype(np.uint8)
    if bits == 16:
        return flat.astype(order + "u2").view(np.uint8).reshape(n, -1)
    shifts = np.arange(bits - 1, -1, -1)
    b = ((flat[..., None].astype(np.uint16) >> shifts) & 1).astype(np.uint8)
    return np.packbits(b.reshape(n, -1), axis=1)


# --- the committed fixtures --------------------------------------------------------


def fixtures() -> dict:
    """{file name: bytes} of every small file under ``tests/ldr``."""
    from PIL import Image

    rgba = sample_image(37, 21, 1)
    rgb = sample_image(40, 24, 2, 3)
    gray = sample_image(33, 17, 3, 1)[..., 0]
    idx16 = (sample_image(29, 19, 4, 1)[..., 0] >> 4)
    out = {}
    # TGA: Pillow's raw and RLE, and the writer's 16-bit, colour-mapped and
    # cross-row files.
    out["albedo_rle_rgba.tga"] = pillow_bytes(rgba, "TGA", compression="tga_rle")
    out["raw_rgb.tga"] = pillow_bytes(rgb, "TGA")
    out["gray_rle.tga"] = pillow_bytes(gray, "TGA", compression="tga_rle")
    pal = Image.fromarray(rgb).convert("P", palette=Image.Palette.ADAPTIVE,
                                       colors=40)
    out["palette_rle.tga"] = pillow_bytes(pal, "TGA", compression="tga_rle")
    out["a1r5g5b5_rle_topleft.tga"] = write_tga(
        to_a1r5g5b5(rgba), 10, 16, bottom=False)
    out["bgra_rle_mirrored.tga"] = write_tga(rgba[..., [2, 1, 0, 3]], 10, 32,
                                             mirror=True)
    out["gray_alpha_rle_rows.tga"] = write_tga(
        np.stack([gray, 255 - gray], -1), 11, 16, cross_rows=False,
        gray_alpha=True)
    cmap16 = to_a1r5g5b5(sample_image(24, 1, 5)[0])
    out["cmap16_rle.tga"] = write_tga(
        (idx16 + 3)[..., None].astype(np.uint8), 9, 8, cmap=cmap16,
        cmap_start=2, cmap_depth=16, ident=b"made by tests")
    # BMP, DIB, ICO, CUR.
    out["rgb24.bmp"] = pillow_bytes(rgb, "BMP")
    out["palette8.bmp"] = pillow_bytes(pal, "BMP")
    out["gray8.dib"] = pillow_bytes(Image.fromarray(gray), "DIB")
    pal_rgb = np.asarray(pal.getpalette()[:120], np.uint8).reshape(40, 3)
    idx8 = np.asarray(pal)
    out["roughness_rle8.bmp"] = write_bmp(idx8, 8, compression=1,
                                          palette=pal_rgb,
                                          rle_data=rle8_rows(idx8[::-1]))
    pal4 = sample_image(16, 1, 6, 3)[0]
    out["rle4.bmp"] = write_bmp(idx16, 4, compression=2, palette=pal4,
                                rle_data=rle4_rows(idx16[::-1]))
    out["os2_palette4.bmp"] = write_bmp(idx16, 4, header=12, palette=pal4)
    v4 = rgba[..., [2, 1, 0, 3]]
    out["v4_bgra_topdown.bmp"] = write_bmp(
        v4, 32, header=108, compression=3,
        masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000), top_down=True)
    out["rgb565_v5.bmp"] = write_bmp(
        (((rgb[..., 0].astype(np.uint16) >> 3) << 11)
         | ((rgb[..., 1].astype(np.uint16) >> 2) << 5)
         | (rgb[..., 2].astype(np.uint16) >> 3)).astype("<u2").view(
            np.uint8).reshape(24, 40, 2), 16, header=124, compression=3,
        masks=(0xF800, 0x7E0, 0x1F, 0))
    out["short_palette1.bmp"] = write_bmp(
        (gray > 128).astype(np.uint8), 1,
        palette=np.array([[200, 30, 40], [10, 220, 90]], np.uint8))
    out["icon.ico"] = pillow_bytes(Image.fromarray(sample_image(32, 32, 7)),
                                   "ICO", sizes=[(16, 16), (32, 32)])
    ico24 = sample_image(16, 16, 8)
    out["icon_bmp_frames.ico"] = write_icon([
        (icon_dib(ico24, 24), 16, 16, 0, 24, 1),
        (icon_dib(sample_image(16, 16, 9), 32), 16, 16, 0, 32, 1),
        (icon_dib(sample_image(8, 8, 10), 32), 8, 8, 0, 32, 1)])
    cur = sample_image(32, 32, 11)
    out["pointer.cur"] = write_icon([(icon_dib(cur, 32), 32, 32, 0, 3, 5)],
                                    cursor=True)
    # netpbm.
    out["rgb.ppm"] = pillow_bytes(rgb, "PPM")
    out["gray.pgm"] = pillow_bytes(Image.fromarray(gray), "PPM")
    out["bits.pbm"] = pillow_bytes(Image.fromarray(gray).convert("1"), "PPM")
    rgb16 = (sample_image(19, 11, 12, 3).astype(np.uint32) * 257
             + np.arange(19)[None, :, None] * 7) % 65536
    out["rgb16.ppm"] = write_netpbm(b"P6", rgb16, 65535)
    out["rgb1000_plain.ppm"] = write_netpbm(
        b"P3", (rgb16[:5, :7] % 1001), 1000, comments=True)
    out["gray16.pgm"] = write_netpbm(b"P5", rgb16[..., 0], 65535)
    out["gray_plain.pgm"] = write_netpbm(b"P2", gray[:6, :9], 255,
                                         comments=True)
    out["bits_plain.pbm"] = write_netpbm(b"P1", (gray[:5, :13] > 100), None,
                                         comments=True)
    # TIFF.
    out["rgb_lzw.tif"] = pillow_bytes(rgb, "TIFF", compression="tiff_lzw")
    out["rgba_packbits.tif"] = pillow_bytes(rgba, "TIFF",
                                            compression="packbits")
    out["gray_deflate.tif"] = pillow_bytes(Image.fromarray(gray), "TIFF",
                                           compression="tiff_adobe_deflate")
    out["palette_raw.tif"] = pillow_bytes(pal, "TIFF")
    out["cmyk_raw.tif"] = pillow_bytes(Image.fromarray(rgb).convert("CMYK"),
                                       "TIFF")
    out["pbr_lzw_predictor.tif"] = write_tiff(rgb, 8, 2, compression=5,
                                              predictor=2, rows_per_strip=5)
    rgb16s = rgb16.astype(np.uint16)
    out["rgb16_tiled_mm.tif"] = write_tiff(rgb16s, 16, 2, compression=5,
                                           predictor=2, order=">",
                                           tile=(16, 16))
    out["rgba_planar_deflate.tif"] = write_tiff(rgba, 8, 2, compression=8,
                                                planar=2, extra=(2,),
                                                rows_per_strip=8)
    out["rgba_assoc_packbits.tif"] = write_tiff(
        (rgba.astype(np.uint16) * np.concatenate([rgba[..., 3:]] * 3 + [
            np.full_like(rgba[..., 3:], 255)], -1) // 255).astype(np.uint8),
        8, 2, compression=32773, extra=(1,))
    out["gray4_fill2.tif"] = write_tiff((gray >> 4)[..., None], 4, 1,
                                        compression=32773, fill=2)
    out["white_is_zero_raw.tif"] = write_tiff(gray[..., None], 8, 0,
                                              rows_per_strip=4)
    out["orientation6.tif"] = write_tiff(rgb, 8, 2, compression=5,
                                         orientation=6)
    out["cmyk16_lzw.tif"] = write_tiff(
        (sample_image(21, 13, 13, 4).astype(np.uint16) * 257), 16, 5,
        compression=5)
    return out


def env_tga(w: int, h: int, seed: int) -> bytes:
    """An RLE 32-bit bottom-left TGA map of ``sample_image`` (alpha 255)."""
    img = sample_image(w, h, seed)
    img[..., 3] = 255
    return write_tga(img[..., [2, 1, 0, 3]], 10, 32)


def env_tiff16(w: int, h: int, seed: int) -> bytes:
    """A 16-bit RGB TIFF map (LZW, predictor 2) of ``sample_image``."""
    img = sample_image(w, h, seed, 3).astype(np.uint16) * 257
    img = img + (np.arange(w, dtype=np.uint16)[None, :, None] * 13) % 200
    return write_tiff(img, 16, 2, compression=5, predictor=2,
                      rows_per_strip=16)


def write_fixtures(directory: str = LDR_DIR) -> None:
    """Write ``tests/ldr``: the files, Pillow's decode of each in
    ``pillow_rgba.npz`` and its SHA-256 in ``pillow_sha256.json``."""
    os.makedirs(directory, exist_ok=True)
    files = fixtures()
    files["env_rle32.tga"] = env_tga(64, 32, 21)
    files["env_rgb16.tif"] = env_tiff16(64, 32, 22)
    decoded = {}
    for name, data in files.items():
        with open(os.path.join(directory, name), "wb") as f:
            f.write(data)
        decoded[name] = pillow_rgba(data)
    np.savez_compressed(os.path.join(directory, "pillow_rgba.npz"), **decoded)
    digests = {n: hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()
               for n, a in sorted(decoded.items())}
    with open(os.path.join(directory, "pillow_sha256.json"), "w") as f:
        json.dump(digests, f, indent=1)


if __name__ == "__main__":
    write_fixtures()
