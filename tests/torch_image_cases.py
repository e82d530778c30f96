"""Small writers of TGA, BMP (DIB, ICO, CUR), netpbm, TIFF, WebP, GIF,
QOI, PCX (DCX), SGI, PSD and DDS files (and, further down, of the older
and rarer formats: FTEX to XPM, IM to FLI) for the LDR readers' tests
(``utils/tga.py``, ``bmp.py``, ``netpbm.py``, ``tiff.py``, ``webp.py``,
``gif.py``, ``qoi.py``, ``pcx.py``, ``sgi.py``, ``psd.py``, ``dds.py``),
and the fixtures under ``tests/ldr/``.

The writers make what Pillow cannot write: TGA at 16 bits and through a
colour map of 16 bits, RLE packets that run across rows, every origin;
BMP with RLE8 and RLE4 (their escapes included), OS/2 and V2-V5 headers,
bit fields, top-down rows and short palettes; cursors; netpbm with
comments anywhere and any maxval; TIFF in strips or tiles, in separate
planes, in either byte order, under PackBits, LZW or deflate with or
without horizontal differencing, fill order 2 and an orientation; VP8L
streams with each transform and the colour cache, ALPH chunks under each
filter, animations whose first frame sits at an offset; GIF at every
minimum code size, with any palette, transparency, interlace and offset;
QOI op streams; PCX on 2 and 4 bit planes and with odd strides, DCX; SGI
at 16 bits, RLE rows shared or out of order; PSD in every colour mode,
raw and PackBits, with resources and layer sections; DDS headers of every
pixel format Pillow reads, BC7 mode-6 blocks and random blocks.
Pillow's own libwebp, driven through ctypes (``libwebp_encode``), writes
lossy files with the options Pillow's ``save`` never sets. Each
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

import bisect
import hashlib
import io
import json
import os
import struct
import zlib

import numpy as np

# The formats Pillow tries on any bytes (they have no ``_accept``), in its
# order; TGA, tried on any bytes too, comes after them.
ANY_BYTES = ["IM", "IMT", "IPTC", "PCD", "SPIDER"]

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


def assert_as_pillow(data: bytes, name: str = "case") -> None:
    """Pillow's array both ways, or, where Pillow refuses ``data``, both
    ways of decoding raising naming ``name``."""
    if pillow_refuses(data):
        assert_refused(data, name)
    else:
        assert_like_pillow(data, name)


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


def lzw(data: bytes, old_style: bool = False) -> bytes:
    """TIFF LZW as libtiff writes it: codes most significant bit first, a
    clear code first and whenever the table fills, the width growing one
    code early, an end-of-information code last. ``old_style`` writes the
    codes libtiff's ``LZWDecodeCompat`` reads: least significant bit
    first, the width growing one code later."""
    codes, widths = [256], [9]
    if not data:
        codes.append(257)
        widths.append(9)
        return _pack_codes(codes, widths, old_style)
    table: dict[int, int] = {}
    late = int(old_style)
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
        elif nxt > maxcode + late:
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
    elif nxt > maxcode + late:
        width += 1
    codes.append(257)
    widths.append(width)
    return _pack_codes(codes, widths, old_style)


def _pack_codes(codes: list, widths: list, lsb_first: bool = False) -> bytes:
    c = np.asarray(codes, np.uint32)
    wd = np.asarray(widths, np.uint8)
    top = 12
    if lsb_first:
        bits = (c[:, None] >> np.arange(top, dtype=np.uint32)) & 1
        keep = np.arange(top)[None, :] < wd[:, None]
        return np.packbits(bits[keep].astype(np.uint8),
                           bitorder="little").tobytes()
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
    size = bits // 8
    dt = np.dtype(f"{order}u{size}")
    s = rows.copy().view(dt).reshape(n, -1, spp).astype(np.int64)
    d = s.copy()
    d[:, 1:] = s[:, 1:] - s[:, :-1]
    return (d & ((1 << bits) - 1)).astype(dt).reshape(n, -1).view(np.uint8)


def float_predict(rows: np.ndarray, spp: int, bits: int,
                  order: str) -> np.ndarray:
    """libtiff's floating-point predictor (3) on (rows, bytes): each row's
    samples as big-endian byte planes (most significant first), then
    differenced a byte ``spp`` bytes back."""
    n = rows.shape[0]
    size = bits // 8
    vals = rows.copy().view(f"{order}u{size}").reshape(n, -1)
    planes = vals.astype(f">u{size}").view(np.uint8).reshape(
        n, -1, size).transpose(0, 2, 1).reshape(n, -1).astype(np.int16)
    d = planes.copy()
    d[:, spp:] = planes[:, spp:] - planes[:, :-spp]
    return (d & 0xFF).astype(np.uint8)


def ycbcr_blocks(block: np.ndarray, hs: int, vs: int) -> np.ndarray:
    """(rows, w, 3) Y, Cb, Cr at full size -> (block rows, bytes) of
    TIFF's subsampled YCbCr data units: hs x vs luma samples (row by row)
    then Cb and Cr, the chroma taken from each unit's first pixel; a unit
    past the edge repeats the last row and column."""
    rows, w, _ = block.shape
    by, bx = -(-rows // vs), -(-w // hs)
    pad = np.pad(block, ((0, by * vs - rows), (0, bx * hs - w), (0, 0)),
                 mode="edge")
    units = pad.reshape(by, vs, bx, hs, 3).transpose(0, 2, 1, 3, 4)
    luma = units[..., 0].reshape(by, bx, vs * hs)
    chroma = units[:, :, 0, 0, 1:]
    return np.concatenate([luma, chroma], -1).reshape(by, -1).astype(np.uint8)


def rgb_to_ycbcr(rgb: np.ndarray) -> np.ndarray:
    """JFIF's RGB -> YCbCr, rounded, as uint8."""
    r, g, b = (rgb[..., k].astype(np.float64) for k in range(3))
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = 128 - 0.168736 * r - 0.331264 * g + 0.5 * b
    cr = 128 + 0.5 * r - 0.418688 * g - 0.081312 * b
    return np.clip(np.round(np.stack([y, cb, cr], -1)), 0, 255).astype(
        np.uint8)


def _jpeg_cases():
    """``tests/torch_jpeg_cases.py``, loaded by its path (``tests`` may be
    no package where this module is loaded by path)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_jpeg_cases", os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "torch_jpeg_cases.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def split_jpeg_tables(stream: bytes) -> tuple[bytes, bytes]:
    """A JPEG -> (its DQT and DHT segments as an abbreviated table stream,
    SOI ... EOI; the stream without them)."""
    tables, rest = bytearray(b"\xff\xd8"), bytearray(b"\xff\xd8")
    pos = 2
    while pos < len(stream):
        marker = stream[pos + 1]
        if marker == 0xDA:
            rest += stream[pos:]
            break
        (length,) = struct.unpack(">H", stream[pos + 2:pos + 4])
        seg = stream[pos:pos + 2 + length]
        (tables if marker in (0xC4, 0xDB) else rest).extend(seg)
        pos += 2 + length
    return bytes(tables + b"\xff\xd9"), bytes(rest)


# T.4's modified Huffman codes: run length -> code string, white and black
# terminating codes (0-63), make-up codes (64-1728) and the extended
# make-up codes both colours share (1792-2560).
_WHITE_TERM = (
    "00110101 000111 0111 1000 1011 1100 1110 1111 10011 10100 00111 01000 "
    "001000 000011 110100 110101 101010 101011 0100111 0001100 0001000 "
    "0010111 0000011 0000100 0101000 0101011 0010011 0100100 0011000 "
    "00000010 00000011 00011010 00011011 00010010 00010011 00010100 "
    "00010101 00010110 00010111 00101000 00101001 00101010 00101011 "
    "00101100 00101101 00000100 00000101 00001010 00001011 01010010 "
    "01010011 01010100 01010101 00100100 00100101 01011000 01011001 "
    "01011010 01011011 01001010 01001011 00110010 00110011 00110100").split()
_WHITE_MAKEUP = (
    "11011 10010 010111 0110111 00110110 00110111 01100100 01100101 "
    "01101000 01100111 011001100 011001101 011010010 011010011 011010100 "
    "011010101 011010110 011010111 011011000 011011001 011011010 "
    "011011011 010011000 010011001 010011010 011000 010011011").split()
_BLACK_TERM = (
    "0000110111 010 11 10 011 0011 0010 00011 000101 000100 0000100 "
    "0000101 0000111 00000100 00000111 000011000 0000010111 0000011000 "
    "0000001000 00001100111 00001101000 00001101100 00000110111 "
    "00000101000 00000010111 00000011000 000011001010 000011001011 "
    "000011001100 000011001101 000001101000 000001101001 000001101010 "
    "000001101011 000011010010 000011010011 000011010100 000011010101 "
    "000011010110 000011010111 000001101100 000001101101 000011011010 "
    "000011011011 000001010100 000001010101 000001010110 000001010111 "
    "000001100100 000001100101 000001010010 000001010011 000000100100 "
    "000000110111 000000111000 000000100111 000000101000 000001011000 "
    "000001011001 000000101011 000000101100 000001011010 000001100110 "
    "000001100111").split()
_BLACK_MAKEUP = (
    "0000001111 000011001000 000011001001 000001011011 000000110011 "
    "000000110100 000000110101 0000001101100 0000001101101 0000001001010 "
    "0000001001011 0000001001100 0000001001101 0000001110010 "
    "0000001110011 0000001110100 0000001110101 0000001110110 "
    "0000001110111 0000001010010 0000001010011 0000001010100 "
    "0000001010101 0000001011010 0000001011011 0000001100100 "
    "0000001100101").split()
_EXT_MAKEUP = (
    "00000001000 00000001100 00000001101 000000010010 000000010011 "
    "000000010100 000000010101 000000010110 000000010111 000000011100 "
    "000000011101 000000011110 000000011111").split()
FAX_CODES = []
for _term, _makeup in ((_WHITE_TERM, _WHITE_MAKEUP),
                       (_BLACK_TERM, _BLACK_MAKEUP)):
    _codes = dict(enumerate(_term))
    _codes.update({64 * (i + 1): c for i, c in enumerate(_makeup)})
    _codes.update({1792 + 64 * i: c for i, c in enumerate(_EXT_MAKEUP)})
    FAX_CODES.append(_codes)
FAX_EOL = "000000000001"
# T.4's two-dimensional mode codes.
FAX_PASS, FAX_HORIZ = "0001", "001"
FAX_VERTICAL = {0: "1", 1: "011", 2: "000011", 3: "0000011", -1: "010",
                -2: "000010", -3: "0000010"}


def fax_run(run: int, colour: int) -> str:
    """One run's codes: make-up codes of 2560 while more than 2560 is
    left, one make-up code, a terminating code."""
    table = FAX_CODES[colour]
    out = []
    while run > 2560 + 63:
        out.append(table[2560])
        run -= 2560
    if run >= 64:
        out.append(table[run & ~63])
    out.append(table[run & 63])
    return "".join(out)


def _changes(row: np.ndarray) -> np.ndarray:
    """A row's changing elements (where a pixel differs from the one
    before, the pixel before the row white), then the width twice."""
    prev = np.concatenate([[0], row[:-1]])
    w = len(row)
    return np.concatenate([np.flatnonzero(row != prev), [w, w]])


def fax_row_1d(row: np.ndarray) -> str:
    ch = _changes(row)
    w = len(row)
    edges = np.concatenate([[0], ch[ch < w], [w]])
    return "".join(fax_run(int(b - a), i & 1)
                   for i, (a, b) in enumerate(zip(edges[:-1], edges[1:])))


def fax_row_2d(row: np.ndarray, ref: np.ndarray) -> str:
    """T.4's two-dimensional coding of ``row`` against ``ref``: pass,
    vertical and horizontal modes."""
    w = len(row)
    ca = _changes(row).tolist()
    cb = _changes(ref).tolist()
    # The reference line's changes to each colour (the colour a change
    # starts), then w.
    to = [[x for x in cb[:-2] if ref[x] == c] + [w] for c in (0, 1)]
    out = []
    a0, colour = -1, 0
    while a0 < w:
        a1 = ca[bisect.bisect_right(ca, a0)]
        b1 = to[1 - colour][bisect.bisect_right(to[1 - colour], a0)]
        b2 = cb[bisect.bisect_right(cb, b1)] if b1 < w else w
        if b2 < a1:
            out.append(FAX_PASS)
            a0 = b2
        elif abs(a1 - b1) <= 3:
            out.append(FAX_VERTICAL[a1 - b1])
            a0, colour = a1, 1 - colour
        else:
            a2 = ca[bisect.bisect_right(ca, a1)] if a1 < w else w
            out.append(FAX_HORIZ + fax_run(a1 - max(a0, 0), colour)
                       + fax_run(a2 - a1, 1 - colour))
            a0 = a2
    return "".join(out)


def fax_encode(bits: np.ndarray, compression: int, options: int = 0,
               k: int = 2) -> bytes:
    """(rows, w) 0/1 samples -> one strip of CCITT data as libtiff writes
    it: compression 2 (modified Huffman, each row to a byte boundary), 3
    (T.4: an EOL before each row, to a byte boundary under ``options``
    bit 2; two-dimensional rows under bit 0, every ``k``-th row
    one-dimensional, a tag bit after each EOL; six EOLs at the end) or 4
    (T.6: every row two-dimensional, EOFB at the end)."""
    out = []
    ref = np.zeros(bits.shape[1], np.uint8)
    two_d = compression == 4 or (compression == 3 and options & 1)
    for i, row in enumerate(bits.astype(np.uint8)):
        one_d = not two_d or (compression == 3 and i % k == 0)
        if compression == 3:
            if options & 4:  # fill so that the EOL ends on a byte boundary
                length = len("".join(out))
                out.append("0" * ((4 - length) % 8))
            out.append(FAX_EOL + ("" if not options & 1 else
                                  "1" if one_d else "0"))
        out.append(fax_row_1d(row) if one_d else fax_row_2d(row, ref))
        if compression == 2:
            out.append("0" * (-len("".join(out)) % 8))
        ref = row
    if compression == 3:
        out.append((FAX_EOL + ("1" if options & 1 else "")) * 6)
    elif compression == 4:
        out.append(FAX_EOL * 2)
    s = "".join(out)
    s += "0" * (-len(s) % 8)
    return np.packbits(np.frombuffer(s.encode(), np.uint8) - 48).tobytes()


_REV = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)


def rlew_encode(bits: np.ndarray, parity: int = 0) -> bytes:
    """(rows, w) 0/1 samples -> CCITT RLEW data (compression 32771):
    modified Huffman rows, each padded to a byte and then to a 16-bit
    boundary of the file (the strip starting at a file offset of
    ``parity``)."""
    out = bytearray()
    for row in bits.astype(np.uint8):
        s = fax_row_1d(row)
        s += "0" * (-len(s) % 8)
        out += np.packbits(np.frombuffer(s.encode(), np.uint8) - 48).tobytes()
        if (len(out) + parity) % 2:
            out.append(0)
    return bytes(out)


def thunder_encode(px: np.ndarray, seed: int = 0) -> bytes:
    """(rows, w) 4-bit samples -> ThunderScan data (compression 32809),
    each row from pixel 0: runs of the last pixel at even pixels, three
    2-bit or two 3-bit deltas where they reach, raw pixels else (chosen
    with a seeded coin so that every code turns up)."""
    rng = np.random.default_rng(seed)
    out = bytearray()
    for row in px.astype(int):
        last, i, w = 0, 0, len(row)
        while i < w:
            run = 0
            while i + run < w and row[i + run] == last and run < 63:
                run += 1
            if run >= 2 and i % 2 == 0 and rng.random() < 0.8:
                out.append(run)
                i += run
                continue
            d = [int(row[j]) - p for j, p in zip(range(i, min(i + 3, w)),
                                                  [last] + list(row[i:i + 2]))]
            if len(d) == 3 and all(abs(x) <= 1 for x in d) and rng.random() < .8:
                out.append(0x40 | sum({0: 0, 1: 1, -1: 3}[x] << (4 - 2 * k)
                                      for k, x in enumerate(d)))
                last, i = int(row[i + 2]), i + 3
                continue
            if len(d) >= 2 and all(abs(x) <= 3 for x in d[:2]) \
                    and rng.random() < .8:
                codes = {0: 0, 1: 1, 2: 2, 3: 3, -3: 5, -2: 6, -1: 7}
                out.append(0x80 | codes[d[0]] << 3 | codes[d[1]])
                last, i = int(row[i + 1]), i + 2
                continue
            out.append(0xC0 | int(row[i]))
            last, i = int(row[i]), i + 1
    return bytes(out)




def _lzma(data: bytes) -> bytes:
    import lzma

    return lzma.compress(data, format=lzma.FORMAT_XZ, check=lzma.CHECK_NONE)


COMPRESS = {1: lambda b: b, 5: lzw, 8: lambda b: zlib.compress(b, 6),
            32946: lambda b: zlib.compress(b, 6), 32773: packbits,
            34925: _lzma, 50000: lambda b: zstd_compress(b, 3)}
# Field types the writer packs: struct code and size.
_FIELD = {3: ("H", 2), 4: ("I", 4), 16: ("Q", 8), 7: ("B", 1)}


def write_tiff(samples: np.ndarray, bits: int, photometric: int, *,
               compression: int = 1, predictor: int = 1, order: str = "<",
               rows_per_strip: int | None = None, tile: tuple | None = None,
               planar: int = 1, fill: int = 1, extra: tuple = (),
               orientation: int | None = None, colormap=None,
               sample_format: int | None = None, bigtiff: bool = False,
               subsampling: tuple | None = None, jpeg: dict | None = None,
               old_lzw: bool | tuple = False, fax_options: int = 0,
               tags: dict | None = None) -> bytes:
    """A one-page TIFF of ``samples`` (h, w, spp) at ``bits`` (1-16 or 32;
    32-bit float samples as a float32 array) a sample, top row first:
    strips of ``rows_per_strip`` rows or tiles of ``tile = (w, h)``,
    chunky or in separate planes, compressed with ``compression`` (1, 2,
    3, 4, 5, 7, 8, 32771, 32773, 32809, 32946, 34925, 50000), ``predictor``
    2 (differencing) or
    3 (libtiff's floating-point predictor), ``fill`` 2 reversing the bits
    of each stored byte. ``bigtiff`` writes the BigTIFF container (8-byte
    offsets and counts); ``subsampling`` (hs, vs) packs YCbCr ``samples``
    into data units; compression 7 writes each strip or tile as a JPEG of
    ``jpeg`` = {"quality", "sampling", "tables": a JPEGTables tag};
    ``old_lzw`` writes old-style LZW codes (True: every strip or tile; a
    tuple: those of these indices); ``fax_options`` is the
    T4Options tag of compression 3; ``tags`` adds {tag: (type, values)}
    (type 5: (numerator, denominator) pairs; type 7: bytes)."""
    h, w, spp = samples.shape
    byte_order = b"II" if order == "<" else b"MM"
    tw, th = tile if tile else (w, rows_per_strip or h)
    chunks = []
    made: dict = {}  # a strip or tile seen before is compressed once
    per = spp if planar == 1 else 1
    jpeg_tables = None
    for p in range(1 if planar == 1 else spp):
        src = samples if planar == 1 else samples[..., p:p + 1]
        for ty in range(0, h, th):
            for tx in range(0, w, tw if tile else w):
                if tile:
                    block = np.zeros((th, tw, per), samples.dtype)
                    part = src[ty:ty + th, tx:tx + tw]
                    block[:part.shape[0], :part.shape[1]] = part
                    if compression == 7:  # a JPEG tile pads with its edge
                        block = np.pad(part, ((0, th - part.shape[0]),
                                              (0, tw - part.shape[1]),
                                              (0, 0)), mode="edge")
                else:
                    block = src[ty:ty + th]
                if compression == 7:
                    opts = jpeg or {}
                    sampling = opts.get("sampling", [(1, 1)] * per)
                    stream = _jpeg_cases().write_jpeg(
                        [block[..., c] for c in range(per)], sampling,
                        quality=opts.get("quality", 75), app="none")
                    if opts.get("tables", True):
                        jpeg_tables, stream = split_jpeg_tables(stream)
                    chunks.append(stream)
                    continue
                if compression in (2, 3, 4):
                    data = fax_encode(block[..., 0], compression, fax_options)
                elif compression == 32771:
                    data = rlew_encode(block[..., 0])
                elif compression == 32809:
                    data = thunder_encode(block[..., 0], seed=len(chunks))
                else:
                    if subsampling:
                        rows = ycbcr_blocks(block, *subsampling)
                    else:
                        rows = _pack_samples(block, bits, order)
                    if predictor == 2:
                        rows = predict(rows, per, bits, order)
                    elif predictor == 3:
                        rows = float_predict(rows, per, bits, order)
                    raw = rows.tobytes()
                    old = old_lzw is True or len(chunks) in (old_lzw or ())
                    if (raw, old) not in made:
                        made[raw, old] = (lzw(raw, old_style=True) if old
                                          else COMPRESS[compression](raw))
                    data = made[raw, old]
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
    if subsampling:
        entries[530] = (3, list(subsampling))
    if jpeg_tables is not None:
        entries[347] = (7, jpeg_tables)
    if compression == 3:
        entries[292] = (4, [fax_options])
    if tile:
        entries[322] = (4, [tw])
        entries[323] = (4, [th])
        off_tag, cnt_tag = 324, 325
    else:
        entries[278] = (4, [th])
        off_tag, cnt_tag = 273, 279
    entries.update(tags or {})
    head = 16 if bigtiff else 8
    body = bytearray(byte_order + (struct.pack(order + "HHHQ", 43, 8, 0, 0)
                                   if bigtiff else
                                   struct.pack(order + "HI", 42, 0)))
    offsets = []
    for data in chunks:
        offsets.append(len(body))
        body += data
        if len(body) % 2:
            body.append(0)
    long_type = 16 if bigtiff else 4
    entries[off_tag] = (long_type, offsets)
    entries[cnt_tag] = (long_type, [len(d) for d in chunks])
    ifd_at = len(body)
    struct.pack_into(order + ("Q" if bigtiff else "I"), body, head - (
        8 if bigtiff else 4), ifd_at)
    tags_sorted = sorted(entries)
    slot, entry, count_code = (8, 20, "Q") if bigtiff else (4, 12, "I")
    values_at = ifd_at + (8 if bigtiff else 2) + entry * len(tags_sorted) + slot
    ifd = bytearray(struct.pack(order + ("Q" if bigtiff else "H"),
                                len(tags_sorted)))
    blob = bytearray()
    for tag in tags_sorted:
        typ, vals = entries[tag]
        if typ == 5:
            payload = struct.pack(f"{order}{2 * len(vals)}I",
                                  *[v for pair in vals for v in pair])
            count = len(vals)
        elif typ == 7:
            payload, count = bytes(vals), len(vals)
        else:
            code = _FIELD[typ][0]
            payload = struct.pack(f"{order}{len(vals)}{code}", *vals)
            count = len(vals)
        head_fmt = order + "HH" + count_code
        if len(payload) <= slot:
            ifd += struct.pack(head_fmt, tag, typ, count) + payload.ljust(
                slot, b"\0")
        else:
            ifd += struct.pack(head_fmt + count_code, tag, typ, count,
                               values_at + len(blob))
            blob += payload
            if len(blob) % 2:
                blob.append(0)
    ifd += struct.pack(order + count_code, 0)
    return bytes(body + ifd + blob)


def _pack_samples(block: np.ndarray, bits: int, order: str) -> np.ndarray:
    """(rows, w, spp) samples -> (rows, bytes) at ``bits`` a sample, rows
    padded to whole bytes (32-bit samples as the array's kind: float,
    signed or unsigned)."""
    n = block.shape[0]
    flat = block.reshape(n, -1)
    if bits == 8:
        return flat.astype(np.uint8)
    if bits in (16, 32):
        kind = "f" if flat.dtype.kind == "f" else "u"
        dt = f"{order}{kind}{bits // 8}"
        if kind == "u":
            flat = flat.astype(np.int64) & ((1 << bits) - 1)
        return np.ascontiguousarray(flat.astype(dt)).view(np.uint8).reshape(
            n, -1)
    shifts = np.arange(bits - 1, -1, -1)
    b = ((flat[..., None].astype(np.uint16) >> shifts) & 1).astype(np.uint8)
    return np.packbits(b.reshape(n, -1), axis=1)


# --- old-style JPEG (OJPEG) TIFFs ------------------------------------------------

def jpeg_markers(stream: bytes) -> list:
    """A JPEG's marker segments up to and including SOS: [(marker, start,
    end)], then ("scan", start, end) for the entropy-coded data up to EOI
    (restart markers kept)."""
    out, pos = [], 2
    while True:
        marker = stream[pos + 1]
        (length,) = struct.unpack(">H", stream[pos + 2:pos + 4])
        out.append((marker, pos, pos + 2 + length))
        pos += 2 + length
        if marker == 0xDA:
            break
    end = stream.rindex(b"\xff\xd9")
    out.append(("scan", pos, end))
    return out


def split_restarts(scan: bytes) -> list:
    """Entropy-coded data -> its restart intervals (RSTn removed)."""
    import re

    return re.split(rb"\xff[\xd0-\xd7]", scan)


def write_ojpeg(rgb: np.ndarray, *, layout: str = "jif", sampling=(2, 2),
                rows_per_strip: int | None = None,
                tile: tuple | None = None, quality: int = 75,
                photometric: int = 6, spp_tag: bool = True,
                restart_tag: bool = True, tags: dict | None = None) -> bytes:
    """An old-style JPEG (compression 6) TIFF of ``rgb`` ((h, w, 3), or
    (h, w, 1) for gray) made from a JPEG Pillow writes: the image as one
    JPEG with a restart interval a strip (or tiles stacked as one JPEG a
    tile wide), each strip's or tile's entropy-coded data an interval.
    ``layout`` "jif" points JPEGInterchangeFormat (513/514) at the whole
    JPEG; "tables" writes JPEGProc (512), JPEGRestartInterval (515) and the
    JPEGQTables/DCTables/ACTables (519-521) a component, the strips then
    holding the bare intervals. ``sampling`` (h, v) is 1x1, 2x1 or 2x2."""
    from PIL import Image

    h, w, nc = rgb.shape
    hs, vs = sampling if nc == 3 else (1, 1)
    if tile:
        tw, th = tile
        across, down = -(-w // tw), -(-h // th)
        blocks = []
        for ty in range(down):
            for tx in range(across):
                part = rgb[ty * th:(ty + 1) * th, tx * tw:(tx + 1) * tw]
                blocks.append(np.pad(part, ((0, th - part.shape[0]),
                                            (0, tw - part.shape[1]), (0, 0)),
                                     mode="edge"))
        image = np.concatenate(blocks, 0)
        unit_rows = th // (8 * vs)
    else:
        rps = rows_per_strip or h
        image = rgb
        unit_rows = rps // (8 * vs)
    sub = {(1, 1): 0, (2, 1): 1, (2, 2): 2}[(hs, vs)]
    img = Image.fromarray(image[..., 0] if nc == 1 else image)
    jpeg = pillow_bytes(img, "JPEG", quality=quality, subsampling=sub,
                        restart_marker_rows=unit_rows)
    segs = jpeg_markers(jpeg)
    scan_start, scan_end = segs[-1][1], segs[-1][2]
    intervals = split_restarts(jpeg[scan_start:scan_end])
    body = bytearray(b"II*\x00\x00\x00\x00\x00")
    jif_at = len(body)
    body += jpeg
    # each interval's place in the copy of the JPEG
    offsets, pos = [], jif_at + scan_start
    for part in intervals:
        offsets.append(pos)
        pos += len(part) + 2
    counts = [len(p) for p in intervals]
    entries = {}
    if layout == "tables":
        dqt = _dqt_tables(jpeg, segs)
        dht = _dht_tables(jpeg, segs)
        sof = next(jpeg[a:e] for m, a, e in segs[:-1] if m == 0xC0)
        sos = next(jpeg[a:e] for m, a, e in segs[:-1] if m == 0xDA)
        tq = [sof[10 + 3 * c + 2] for c in range(nc)]
        td = [sos[6 + 2 * c] >> 4 for c in range(nc)]
        ta = [sos[6 + 2 * c] & 15 for c in range(nc)]
        at = {}
        for key, blob in [*dqt.items(), *dht.items()]:
            at[key] = len(body)
            body += blob
        entries[512] = (3, [1])
        if restart_tag:
            dri = [jpeg[a + 4:a + 6] for m, a, e in segs[:-1] if m == 0xDD]
            entries[515] = (3, [struct.unpack(">H", dri[0])[0]])
        entries[519] = (4, [at["q", t] for t in tq])
        entries[520] = (4, [at["dc", t] for t in td])
        entries[521] = (4, [at["ac", t] for t in ta])
    else:
        entries[513] = (4, [jif_at])
        entries[514] = (4, [len(jpeg)])
    entries.update({256: (4, [w]), 257: (4, [h]), 258: (3, [8] * nc),
                    259: (3, [6]), 262: (3, [photometric])})
    if spp_tag:
        entries[277] = (3, [nc])
    if nc == 3:
        entries[530] = (3, [hs, vs])
    if tile:
        entries.update({322: (4, [tw]), 323: (4, [th]), 324: (4, offsets),
                        325: (4, counts)})
    else:
        entries.update({278: (4, [rps]), 273: (4, offsets),
                        279: (4, counts)})
    entries.update(tags or {})
    return _tiff_with_body(bytes(body), entries)


def _dqt_tables(jpeg: bytes, segs: list) -> dict:
    """{("q", id): 64 bytes} of the 8-bit tables of the DQT segments."""
    out = {}
    for m, a, e in segs[:-1]:
        if m == 0xDB:
            for at in range(a + 4, e, 65):
                out["q", jpeg[at] & 15] = jpeg[at + 1:at + 65]
    return out


def _dht_tables(jpeg: bytes, segs: list) -> dict:
    """{("dc" or "ac", id): 16 counts + values} from the DHT segments."""
    out = {}
    for m, a, e in segs[:-1]:
        if m != 0xC4:
            continue
        pos = a + 4
        while pos < e:
            tc, th = jpeg[pos] >> 4, jpeg[pos] & 15
            n = sum(jpeg[pos + 1:pos + 17])
            out["ac" if tc else "dc", th] = jpeg[pos + 1:pos + 17 + n]
            pos += 17 + n
    return out


def _tiff_with_body(body: bytes, entries: dict) -> bytes:
    """A little-endian TIFF of ``body`` (its first 8 bytes the header,
    rewritten) and one IFD of ``entries`` {tag: (type, values)} after it."""
    body = bytearray(body)
    if len(body) % 2:
        body.append(0)
    ifd_at = len(body)
    struct.pack_into("<I", body, 4, ifd_at)
    tags = sorted(entries)
    values_at = ifd_at + 2 + 12 * len(tags) + 4
    ifd = bytearray(struct.pack("<H", len(tags)))
    blob = bytearray()
    for tag in tags:
        typ, vals = entries[tag]
        if typ == 5:
            payload = struct.pack(f"<{2 * len(vals)}I",
                                  *[v for pair in vals for v in pair])
        elif typ == 7:
            payload = bytes(vals)
        else:
            payload = struct.pack(f"<{len(vals)}{_FIELD[typ][0]}", *vals)
        if len(payload) <= 4:
            ifd += struct.pack("<HHI", tag, typ, len(vals)) + payload.ljust(
                4, b"\0")
        else:
            ifd += struct.pack("<HHII", tag, typ, len(vals),
                               values_at + len(blob))
            blob += payload
            if len(blob) % 2:
                blob.append(0)
    ifd += struct.pack("<I", 0)
    return bytes(body + ifd + blob)


# --- Zstandard (libzstd through ctypes) --------------------------------------

_LIBZSTD: list = []


def libzstd():
    """Pillow's bundled libzstd 1.5.7 (``pillow.libs/libzstd-*.so.1.5.7``,
    which its libtiff writes and reads zstd TIFFs with), bound with
    ctypes."""
    if _LIBZSTD:
        return _LIBZSTD[0]
    import ctypes
    import glob

    import PIL

    root = os.path.dirname(os.path.dirname(PIL.__file__))
    lib = ctypes.CDLL(glob.glob(os.path.join(root, "pillow.libs",
                                             "libzstd-*"))[0])
    size_t, vp = ctypes.c_size_t, ctypes.c_void_p
    for name, args, res in (
            ("ZSTD_decompress", [vp, size_t, vp, size_t], size_t),
            ("ZSTD_isError", [size_t], ctypes.c_uint),
            ("ZSTD_getErrorName", [size_t], ctypes.c_char_p),
            ("ZSTD_createCCtx", [], vp), ("ZSTD_freeCCtx", [vp], size_t),
            ("ZSTD_CCtx_setParameter", [vp, ctypes.c_int, ctypes.c_int],
             size_t),
            ("ZSTD_compress2", [vp, vp, size_t, vp, size_t], size_t),
            ("ZSTD_compressBound", [size_t], size_t),
            ("ZSTD_createDStream", [], vp), ("ZSTD_freeDStream", [vp], size_t),
            ("ZSTD_initDStream", [vp], size_t),
            ("ZSTD_decompressStream", [vp, vp, vp], size_t)):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, res
    _LIBZSTD.append(lib)
    return lib


def zstd_compress(data: bytes, level: int = 3, checksum: bool = False,
                  content_size: bool = True, window_log: int = 0) -> bytes:
    """``ZSTD_compress2`` at ``level`` (-5 to 22), with or without the
    content checksum and the content size."""
    import ctypes

    lib = libzstd()
    cctx = lib.ZSTD_createCCtx()
    try:
        for param, value in ((100, level), (201, int(checksum)),
                             (200, int(content_size)), (101, window_log)):
            lib.ZSTD_CCtx_setParameter(cctx, param, value)
        cap = lib.ZSTD_compressBound(len(data))
        out = ctypes.create_string_buffer(cap)
        n = lib.ZSTD_compress2(cctx, out, cap, data, len(data))
        assert not lib.ZSTD_isError(n), lib.ZSTD_getErrorName(n)
        return out.raw[:n]
    finally:
        lib.ZSTD_freeCCtx(cctx)


def libzstd_decompress(src: bytes, cap: int = 1 << 24) -> bytes | None:
    """``ZSTD_decompress`` into ``cap`` bytes: the output, or None where
    libzstd refuses ``src``."""
    import ctypes

    lib = libzstd()
    out = ctypes.create_string_buffer(max(cap, 1))
    n = lib.ZSTD_decompress(out, cap, src, len(src))
    return None if lib.ZSTD_isError(n) else out.raw[:n]


def libzstd_stream(src: bytes, limit: int) -> bytes | None:
    """libtiff's ``ZSTDDecode`` loop over ``ZSTD_decompressStream`` with
    ``limit`` bytes of output: what it wrote (short where the data ran
    out), or None where it failed."""
    import ctypes

    class Buffer(ctypes.Structure):
        _fields_ = [("ptr", ctypes.c_void_p), ("size", ctypes.c_size_t),
                    ("pos", ctypes.c_size_t)]

    lib = libzstd()
    ds = lib.ZSTD_createDStream()
    try:
        lib.ZSTD_initDStream(ds)
        src_buf = ctypes.create_string_buffer(src, len(src))
        out = ctypes.create_string_buffer(max(limit, 1))
        inb = Buffer(ctypes.cast(src_buf, ctypes.c_void_p), len(src), 0)
        outb = Buffer(ctypes.cast(out, ctypes.c_void_p), limit, 0)
        while True:
            ret = lib.ZSTD_decompressStream(ds, ctypes.byref(outb),
                                            ctypes.byref(inb))
            if lib.ZSTD_isError(ret):
                return None
            if not (ret != 0 and inb.pos < inb.size and outb.pos < outb.size):
                break
        return out.raw[:outb.pos]
    finally:
        lib.ZSTD_freeDStream(ds)


# --- WebP ------------------------------------------------------------------------

_LIBWEBP: list = []
_WEBP_CONFIG_FIELDS = (
    "lossless", "quality", "method", "image_hint", "target_size",
    "target_PSNR", "segments", "sns_strength", "filter_strength",
    "filter_sharpness", "filter_type", "autofilter", "alpha_compression",
    "alpha_filtering", "alpha_quality", "pass_", "show_compressed",
    "preprocessing", "partitions", "partition_limit", "emulate_jpeg_size",
    "thread_level", "low_memory", "near_lossless", "exact",
    "use_delta_palette", "use_sharp_yuv", "qmin", "qmax")


def _libwebp():
    """Pillow's own libwebp (the one its WebP plugin is linked with), found
    among the libraries this process has mapped once ``PIL._webp`` is
    imported, and bound with ctypes."""
    if _LIBWEBP:
        return _LIBWEBP[0]
    import ctypes

    from PIL import _webp  # noqa: F401  (maps libwebp into the process)

    with open("/proc/self/maps") as f:
        paths = {line.split()[-1] for line in f if "libwebp" in line}
    path = next(p for p in sorted(paths)
                if "demux" not in os.path.basename(p)
                and "mux" not in os.path.basename(p))
    lib = ctypes.CDLL(path)

    class Config(ctypes.Structure):
        _fields_ = [(n, ctypes.c_float if n in ("quality", "target_PSNR")
                     else ctypes.c_int) for n in _WEBP_CONFIG_FIELDS] + [
            ("pad", ctypes.c_uint32 * 8)]

    class Writer(ctypes.Structure):
        _fields_ = [("mem", ctypes.c_void_p), ("size", ctypes.c_size_t),
                    ("max_size", ctypes.c_size_t),
                    ("pad", ctypes.c_uint32 * 1)]

    _LIBWEBP.append((lib, Config, Writer))
    return _LIBWEBP[0]


def libwebp_encode(rgba: np.ndarray, **options) -> bytes:
    """An (h, w, 4) uint8 image encoded by Pillow's libwebp through its
    advanced API (``WebPConfig``), which reaches what Pillow's ``save``
    never sets: ``segments``, ``partitions`` (log2 of the token
    partitions), ``filter_type`` (0 the simple loop filter),
    ``filter_strength``, ``filter_sharpness``, ``use_sharp_yuv``,
    ``alpha_compression``, ``alpha_filtering``, ``preprocessing`` and the
    rest of ``_WEBP_CONFIG_FIELDS``. Returns the whole RIFF file."""
    import ctypes

    lib, Config, Writer = _libwebp()
    rgba = np.ascontiguousarray(rgba, np.uint8)
    h, w = rgba.shape[:2]
    abi = 0x0210  # WEBP_ENCODER_ABI_VERSION of libwebp 1.x
    config = Config()
    assert lib.WebPConfigInitInternal(ctypes.byref(config), 0,
                                      ctypes.c_float(75.0), abi)
    for key, value in options.items():
        setattr(config, key, value)
    assert lib.WebPValidateConfig(ctypes.byref(config)), options
    # WebPPicture (256 bytes on 64-bit): use_argb at 0, width at 8, height
    # at 12, writer at 96, custom_ptr at 104.
    pic = ctypes.create_string_buffer(512)
    assert lib.WebPPictureInitInternal(pic, abi)
    ctypes.c_int.from_buffer(pic, 0).value = 1
    ctypes.c_int.from_buffer(pic, 8).value = w
    ctypes.c_int.from_buffer(pic, 12).value = h
    assert lib.WebPPictureImportRGBA(pic, rgba.ctypes.data_as(ctypes.c_void_p),
                                     4 * w)
    writer = Writer()
    lib.WebPMemoryWriterInit(ctypes.byref(writer))
    ctypes.c_void_p.from_buffer(pic, 96).value = ctypes.cast(
        lib.WebPMemoryWrite, ctypes.c_void_p).value
    ctypes.c_void_p.from_buffer(pic, 104).value = ctypes.addressof(writer)
    ok = lib.WebPEncode(ctypes.byref(config), pic)
    out = ctypes.string_at(writer.mem, writer.size)
    lib.WebPPictureFree(pic)
    lib.WebPMemoryWriterClear(ctypes.byref(writer))
    assert ok, f"WebPEncode failed: {options}"
    return out


def riff_chunks(data: bytes) -> list:
    """[(fourcc, payload)] of a RIFF/WEBP file's top-level chunks."""
    out, at = [], 12
    while at + 8 <= len(data):
        fourcc = data[at:at + 4]
        (size,) = struct.unpack_from("<I", data, at + 4)
        out.append((fourcc, data[at + 8:at + 8 + size]))
        at += 8 + size + (size & 1)
    return out


def chunk(fourcc: bytes, payload: bytes) -> bytes:
    """One RIFF chunk, padded to an even size."""
    return (fourcc + struct.pack("<I", len(payload)) + payload
            + b"\0" * (len(payload) & 1))


def riff(chunks: list) -> bytes:
    """A RIFF/WEBP file of the given chunk bytes."""
    body = b"WEBP" + b"".join(chunks)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def vp8x(width: int, height: int, flags: int) -> bytes:
    """A VP8X chunk (flags: 0x10 alpha, 0x02 animation, 0x20 ICC, 0x08
    EXIF, 0x04 XMP)."""
    return chunk(b"VP8X", struct.pack("<I", flags)
                 + (width - 1).to_bytes(3, "little")
                 + (height - 1).to_bytes(3, "little"))


def image_chunks(still: bytes) -> bytes:
    """The ALPH (if any) and VP8/VP8L chunks of a still WebP file."""
    return b"".join(chunk(f, p) for f, p in riff_chunks(still)
                    if f in (b"ALPH", b"VP8 ", b"VP8L"))


def write_animated_webp(frames: list, canvas: tuple, flags: int = 0x12,
                        background: int = 0, loop: int = 0) -> bytes:
    """An animated WebP: ``frames`` of (x, y, still WebP bytes, duration,
    ANMF flags), each placed at its even offset on a ``canvas`` (w, h)."""
    body = [vp8x(canvas[0], canvas[1], flags),
            chunk(b"ANIM", struct.pack("<IH", background, loop))]
    for x, y, still, duration, fflags in frames:
        w, h = webp_size(still)
        body.append(chunk(b"ANMF", (x // 2).to_bytes(3, "little")
                          + (y // 2).to_bytes(3, "little")
                          + (w - 1).to_bytes(3, "little")
                          + (h - 1).to_bytes(3, "little")
                          + duration.to_bytes(3, "little") + bytes([fflags])
                          + image_chunks(still)))
    return riff(body)


def webp_size(still: bytes) -> tuple:
    """(width, height) of a still WebP file's bitstream."""
    for fourcc, payload in riff_chunks(still):
        if fourcc == b"VP8L":
            v = int.from_bytes(payload[1:5], "little")
            return (v & 0x3FFF) + 1, ((v >> 14) & 0x3FFF) + 1
        if fourcc == b"VP8 ":
            return (struct.unpack_from("<H", payload, 6)[0] & 0x3FFF,
                    struct.unpack_from("<H", payload, 8)[0] & 0x3FFF)
    raise ValueError("no image chunk")


class _Bits:
    """An LSB-first bit writer (VP8L's order)."""

    def __init__(self):
        self.acc, self.n, self.out = 0, 0, bytearray()

    def put(self, value: int, nbits: int) -> None:
        self.acc |= (int(value) & ((1 << nbits) - 1)) << self.n
        self.n += nbits
        while self.n >= 8:
            self.out.append(self.acc & 0xFF)
            self.acc >>= 8
            self.n -= 8

    def code(self, codes: dict, symbol: int) -> None:
        """A canonical prefix code's symbol, its bits most significant
        first."""
        code, n = codes[symbol]
        for i in range(n - 1, -1, -1):
            self.put((code >> i) & 1, 1)

    def done(self) -> bytes:
        return bytes(self.out) + (bytes([self.acc]) if self.n else b"")


def _canonical(lengths: list) -> dict:
    """{symbol: (code, length)} of the canonical code of ``lengths``."""
    codes, code = {}, 0
    for n in range(1, 16):
        for s, sn in enumerate(lengths):
            if sn == n:
                codes[s] = (code, n)
                code += 1
        code <<= 1
    return codes


def _put_code(bw: _Bits, lengths: list) -> dict:
    """A normal prefix code of ``lengths`` (all at most 15), written with a
    flat code-length code (lengths 0-15 at 4 bits each)."""
    order = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14,
             15)
    bw.put(0, 1)
    bw.put(len(order) - 4, 4)
    for sym in order:
        bw.put(0 if sym >= 16 else 4, 3)
    bw.put(0, 1)
    cl_codes = _canonical([4] * 16)
    for n in lengths:
        bw.code(cl_codes, n)
    return _canonical(lengths)


def _flat_lengths(alphabet: int, cache: int = 0) -> list:
    """Code lengths of a complete code: 256 literals at 8 bits, or, with a
    colour cache of 2**cache entries, literals at 9 and cache codes at
    cache + 1 bits."""
    if not cache:
        return [8] * 256 + [0] * (alphabet - 256)
    return [9] * 256 + [0] * 24 + [cache + 1] * (1 << cache)


def _put_image(bw: _Bits, px: np.ndarray, cache: int = 0,
               main: bool = False) -> None:
    """An entropy-coded ARGB image (flat uint32 pixels): its colour cache
    bit, the main image's "no meta prefix codes" bit (a transform's
    sub-image has none), five prefix codes and the pixels as literals or
    colour cache hits."""
    if cache:
        bw.put(1, 1)
        bw.put(cache, 4)
    else:
        bw.put(0, 1)
    if main:
        bw.put(0, 1)
    green = _put_code(bw, _flat_lengths(280 + ((1 << cache) if cache else 0),
                                        cache))
    others = [_put_code(bw, [8] * 256) for _ in range(3)]
    bw.put(1, 1)  # distance: a simple code of one symbol, 0
    bw.put(0, 1)
    bw.put(0, 1)
    bw.put(0, 1)
    table = [None] * (1 << cache) if cache else None
    for v in np.asarray(px, np.uint32).tolist():
        if table is not None:
            key = ((v * 0x1E35A7BD) & 0xFFFFFFFF) >> (32 - cache)
            if table[key] == v:
                bw.code(green, 280 + key)
                continue
            table[key] = v
        bw.code(green, (v >> 8) & 0xFF)
        bw.code(others[0], (v >> 16) & 0xFF)
        bw.code(others[1], v & 0xFF)
        bw.code(others[2], v >> 24)


def _argb(rgba: np.ndarray) -> np.ndarray:
    a = rgba.astype(np.uint32)
    return (a[..., 3] << 24) | (a[..., 0] << 16) | (a[..., 1] << 8) | a[..., 2]


def _sub8(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Per-channel (a - b) mod 256 of ARGB words."""
    out = np.zeros_like(a)
    for s in (0, 8, 16, 24):
        out |= (((a >> s) - (b >> s)) & 0xFF) << s
    return out


def _predictions(img: np.ndarray, mode: int) -> np.ndarray:
    """VP8L predictor ``mode`` (0-13) of every pixel from its neighbours in
    ``img`` (h, w) ARGB, the rightmost pixel's top-right being the first
    pixel of its own row (the decoder's layout); rows and columns 0 are
    the caller's."""
    h, w = img.shape
    flat = img.reshape(-1).astype(np.int64)
    idx = np.arange(h * w).reshape(h, w)
    L = flat[np.maximum(idx - 1, 0)]
    T = flat[np.maximum(idx - w, 0)]
    TL = flat[np.maximum(idx - w - 1, 0)]
    TR = flat[np.maximum(idx - w + 1, 0)]

    def avg(a, b):
        return (((a ^ b) & 0xFEFEFEFE) >> 1) + (a & b)

    def ch(v, s):
        return (v >> s) & 0xFF

    if mode == 0:
        p = np.full(h * w, 0xFF000000, np.int64)
    elif mode in (1, 2, 3, 4):
        p = {1: L, 2: T, 3: TR, 4: TL}[mode]
    elif mode == 5:
        p = avg(avg(L, TR), T)
    elif mode == 6:
        p = avg(L, TL)
    elif mode == 7:
        p = avg(L, T)
    elif mode == 8:
        p = avg(TL, T)
    elif mode == 9:
        p = avg(T, TR)
    elif mode == 10:
        p = avg(avg(L, TL), avg(T, TR))
    elif mode == 11:
        score = sum(np.abs(ch(L, s) - ch(TL, s)) - np.abs(ch(T, s) - ch(TL, s))
                    for s in (0, 8, 16, 24))
        p = np.where(score <= 0, T, L)
    elif mode == 12:
        p = sum(np.clip(ch(L, s) + ch(T, s) - ch(TL, s), 0, 255) << s
                for s in (0, 8, 16, 24))
    else:
        a = avg(L, T)
        p = 0
        for s in (0, 8, 16, 24):
            d = ch(a, s) - ch(TL, s)
            p = p + (np.clip(ch(a, s) + np.trunc(d / 2).astype(np.int64), 0,
                             255) << s)
    return np.asarray(p, np.int64).astype(np.uint32).reshape(h, w)


def write_vp8l(rgba: np.ndarray, *, transforms: tuple = (), cache: int = 0,
               seed: int = 0, bits: int = 2, alpha_used: bool | None = None,
               riff_wrap: bool = True, mode: int | None = None) -> bytes:
    """A lossless WebP of an (h, w, 4) uint8 image written by this module,
    not by libwebp: ``transforms`` applied in order from "palette" (colour
    indexing, bundled at 2, 4 and 16 colours), "subtract_green",
    "predictor" (a seeded mode, 0-13, a tile of 2**``bits`` pixels, or
    ``mode`` in every tile) and
    "cross_color" (seeded multipliers a tile), then the pixels as literals
    or ``cache`` colour cache hits (``cache`` bits), every prefix code
    complete. No transform and no cache is the vectorized minimal writer
    (8-bit codes, 32 bits a pixel), fast at 4096x2048; ``riff_wrap=False``
    returns the bare stream after the header, as an ALPH chunk holds it."""
    rgba = np.ascontiguousarray(rgba, np.uint8)
    h, w = rgba.shape[:2]
    if alpha_used is None:
        alpha_used = bool((rgba[..., 3] != 255).any())
    if not transforms and not cache and riff_wrap:
        return _write_vp8l_minimal(rgba, alpha_used)
    rng = np.random.default_rng(seed)
    bw = _Bits()
    if riff_wrap:
        bw.put(0x2F, 8)
        bw.put(w - 1, 14)
        bw.put(h - 1, 14)
        bw.put(int(alpha_used), 1)
        bw.put(0, 3)
    img = _argb(rgba)
    width = w
    for kind in transforms:
        bw.put(1, 1)
        if kind == "palette":
            colours, inverse = np.unique(img.reshape(-1), return_inverse=True)
            n = len(colours)
            assert n <= 256, "a palette of at most 256 colours"
            pbits = 0 if n > 16 else 1 if n > 4 else 2 if n > 2 else 3
            bw.put(3, 2)
            bw.put(n - 1, 8)
            deltas = colours.copy()
            deltas[1:] = _sub8(colours[1:], colours[:-1])
            _put_image(bw, deltas)
            idx = inverse.reshape(h, width).astype(np.uint32)
            per = 1 << pbits
            packed_w = -(-width // per)
            full = np.zeros((h, packed_w * per), np.uint32)
            full[:, :width] = idx
            packed = np.zeros((h, packed_w), np.uint32)
            for k in range(per):
                packed |= full[:, k::per] << ((8 >> pbits) * k)
            img = (packed << 8) | 0xFF000000
            width = packed_w
        elif kind == "subtract_green":
            bw.put(2, 2)
            g = (img >> 8) & 0xFF
            img = ((img & 0xFF00FF00) | ((((img >> 16) - g) & 0xFF) << 16)
                   | ((img - g) & 0xFF))
        elif kind == "predictor":
            bw.put(0, 2)
            bw.put(bits - 2, 3)
            tw, th = -(-width // (1 << bits)), -(-h // (1 << bits))
            modes = (rng.integers(0, 14, (th, tw)) if mode is None
                     else np.full((th, tw), mode)).astype(np.uint32)
            pred = np.zeros((h, width), np.uint32)
            for m in range(14):
                sel = np.repeat(np.repeat(modes == m, 1 << bits, 0),
                                1 << bits, 1)[:h, :width]
                if sel.any():
                    pred = np.where(sel, _predictions(img, m), pred)
            pred[0, :] = np.concatenate([[0xFF000000], img[0, :-1]])
            pred[1:, 0] = img[:-1, 0]
            _put_image(bw, ((modes << 8) | 0xFF000000).reshape(-1))
            img = _sub8(img, pred)
        elif kind == "cross_color":
            bw.put(1, 2)
            bw.put(bits - 2, 3)
            tw, th = -(-width // (1 << bits)), -(-h // (1 << bits))
            mult = rng.integers(0, 256, (th, tw, 3)).astype(np.uint32)
            m = np.repeat(np.repeat(mult, 1 << bits, 0), 1 << bits,
                          1)[:h, :width]
            s8 = lambda v: ((v.astype(np.int64) & 0xFF) ^ 0x80) - 128  # noqa
            g2r, g2b, r2b = s8(m[..., 0]), s8(m[..., 1]), s8(m[..., 2])
            green, red = s8(img >> 8), s8(img >> 16)
            new_r = (((img >> 16) & 0xFF).astype(np.int64)
                     - ((g2r * green) >> 5)) & 0xFF
            new_b = ((img & 0xFF).astype(np.int64) - ((g2b * green) >> 5)
                     - ((r2b * red) >> 5)) & 0xFF
            img = ((img & 0xFF00FF00) | (new_r.astype(np.uint32) << 16)
                   | new_b.astype(np.uint32))
            codes = (mult[..., 0] | (mult[..., 1] << 8) | (mult[..., 2] << 16)
                     | np.uint32(0xFF000000))
            _put_image(bw, codes.reshape(-1))
        else:
            raise ValueError(kind)
    bw.put(0, 1)  # no more transforms
    _put_image(bw, img.reshape(-1), cache, main=True)
    payload = bw.done()
    return riff([chunk(b"VP8L", payload)]) if riff_wrap else payload


def _write_vp8l_minimal(rgba: np.ndarray, alpha_used: bool) -> bytes:
    h, w = rgba.shape[:2]
    head = []  # (value, bits), LSB first

    def put(value, nbits):
        head.append((int(value), nbits))

    put(0x2F, 8)
    put(w - 1, 14)
    put(h - 1, 14)
    put(int(alpha_used), 1)
    put(0, 3)  # version
    put(0, 1)  # no transform
    put(0, 1)  # no colour cache
    put(0, 1)  # no meta prefix codes
    order = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8)
    for alphabet in (280, 256, 256, 256):
        put(0, 1)  # normal code
        put(len(order) - 4, 4)
        for sym in order:  # the code-length code: symbols 0 and 8, 1 bit
            put(1 if sym in (0, 8) else 0, 3)
        put(0, 1)  # every symbol's length is written
        for sym in range(alphabet):
            put(1 if sym < 256 else 0, 1)  # length 8 ('1') or 0 ('0')
    for v in (1, 0, 0, 0):  # distance: a simple code of one symbol, 0
        put(v, 1)
    bits = np.concatenate([((np.uint64(v) >> np.arange(n, dtype=np.uint64))
                            & np.uint64(1)).astype(np.uint8)
                           for v, n in head])
    # Each symbol's 8-bit canonical code is the symbol, read MSB first.
    px = rgba[..., [1, 0, 2, 3]].reshape(-1)
    bits = np.concatenate([bits, np.unpackbits(px, bitorder="big")])
    payload = np.packbits(bits, bitorder="little").tobytes()
    return riff([chunk(b"VP8L", payload)])


def write_alph(alpha: np.ndarray, filt: int, compressed: bool,
               pre: int = 0) -> bytes:
    """An ALPH payload of an (h, w) alpha plane: the header byte (method,
    ``filt`` 0 none, 1 horizontal, 2 vertical, 3 gradient, ``pre``), then
    the filtered values raw or as a VP8L stream of implicit size (green
    only)."""
    a = np.asarray(alpha, np.int32)
    h, w = a.shape
    pred = np.zeros_like(a)
    if filt == 1:
        pred[:, 1:] = a[:, :-1]
        pred[1:, 0] = a[:-1, 0]
    elif filt == 2:
        pred[0, 1:] = a[0, :-1]
        pred[1:] = a[:-1]
    elif filt == 3:
        pred[0, 1:] = a[0, :-1]
        pred[1:, 0] = a[:-1, 0]
        pred[1:, 1:] = np.clip(a[1:, :-1] + a[:-1, 1:] - a[:-1, :-1], 0, 255)
    res = ((a - pred) & 0xFF).astype(np.uint8)
    head = bytes([int(compressed) | (filt << 2) | (pre << 4)])
    if not compressed:
        return head + res.tobytes()
    rgba = np.zeros((h, w, 4), np.uint8)
    rgba[..., 1] = res
    rgba[..., 3] = 255
    return head + write_vp8l(rgba, transforms=("palette",) if len(
        np.unique(res)) <= 256 else (), riff_wrap=False)


def with_alph(still: bytes, alph: bytes, width: int, height: int) -> bytes:
    """A VP8X file of a still lossy file's VP8 chunk and the ALPH payload
    ``alph``."""
    vp8 = next(p for f, p in riff_chunks(still) if f == b"VP8 ")
    return riff([vp8x(width, height, 0x10), chunk(b"ALPH", alph),
                 chunk(b"VP8 ", vp8)])


# --- GIF -----------------------------------------------------------------------


def gif_lzw(indices: np.ndarray, bits: int, *, literal: bool = False,
            clear_first: bool = True, end: bool = True,
            stats: dict | None = None) -> bytes:
    """LZW codes of ``indices`` (flat, in stream order) for minimum code
    size ``bits``, packed LSB first into sub-blocks (and the terminator), as
    Pillow's decoder reads them: the width grows once the entry at the
    width's last code is added, up to 12 bits, and the table stays full
    without a clear code. ``literal`` writes each index as its own code,
    with a clear code before every ``2**bits - 2`` of them so the width
    stays ``bits + 1`` (vectorized: the writer of the card's large file);
    below 2 bits the codes are literal anyway, since Pillow's table never
    widens there. ``stats``, if given, gets the codes written after the
    first clear ("codes") and the widest code ("width")."""
    idx = np.asarray(indices, np.uint8).reshape(-1)
    clear, eoi = 1 << bits, (1 << bits) + 1
    if literal or bits < 2:
        width = bits + 1
        n = len(idx)
        per = (1 << bits) - 2 if bits >= 2 else max(n, 1)
        groups = -(-n // per)
        pos = np.arange(n)
        codes = np.empty(n + groups + int(end), np.int64)
        codes[pos + pos // per + 1] = idx
        codes[np.arange(groups) * (per + 1)] = clear
        if end:
            codes[-1] = eoi
        if not clear_first and groups:
            codes = codes[1:]
        shifts = np.arange(width, dtype=np.int64)
        stream = ((codes[:, None] >> shifts) & 1).astype(np.uint8).reshape(-1)
        return _sub_blocks(np.packbits(stream, bitorder="little").tobytes())
    codes, widths = [], []
    state = {"width": bits + 1, "next": clear + 2, "emitted": 0}

    def emit(code):
        codes.append(code)
        widths.append(state["width"])
        state["emitted"] += 1
        # From the second code after a clear the decoder adds an entry.
        if state["emitted"] >= 2 and state["next"] < 4096:
            if (state["next"] == (1 << state["width"]) - 1
                    and state["width"] < 12):
                state["width"] += 1
            state["next"] += 1

    if clear_first:
        codes.append(clear)
        widths.append(bits + 1)
    table: dict = {}
    enc_next = clear + 2
    w = None
    for v in idx.tolist():
        if w is None:
            w = v
            continue
        key = (w, v)
        if key in table:
            w = table[key]
            continue
        emit(w)
        if enc_next < 4096:
            table[key] = enc_next
            enc_next += 1
        w = v
    if w is not None:
        emit(w)
    if end:
        codes.append(eoi)
        widths.append(state["width"])
    if stats is not None:
        stats["codes"] = state["emitted"]
        stats["width"] = max(widths)
    acc, nacc, out = 0, 0, bytearray()
    for c, n in zip(codes, widths):
        acc |= c << nacc
        nacc += n
        while nacc >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nacc -= 8
    if nacc:
        out.append(acc)
    return _sub_blocks(bytes(out))


def _sub_blocks(data: bytes) -> bytes:
    out = bytearray()
    for i in range(0, len(data), 255):
        part = data[i:i + 255]
        out.append(len(part))
        out += part
    return bytes(out) + b"\0"


def _gif_palette(pal) -> tuple[int, bytes]:
    pal = np.asarray(pal, np.uint8).reshape(-1, 3)
    k = max(0, int(np.ceil(np.log2(max(len(pal), 2)))) - 1)
    full = np.zeros((2 << k, 3), np.uint8)
    full[:len(pal)] = pal
    return k, full.tobytes()


def write_gif(indices: np.ndarray, *, screen: tuple | None = None,
              offset: tuple = (0, 0), bits: int | None = None,
              global_palette=None, local_palette=None,
              transparency: int | None = None, interlace: bool = False,
              literal: bool = False, end: bool = True,
              extensions: bytes = b"", version: bytes = b"GIF89a") -> bytes:
    """A one-frame GIF of (h, w) ``indices``: the logical ``screen`` (w, h;
    the frame's size by default), the frame at ``offset``, palettes of
    (n, 3) entries padded to a power of two (n itself when it is one),
    a graphic control extension with ``transparency``, ``interlace``d rows,
    minimum code size ``bits`` (enough for the largest index by default),
    raw ``extensions`` bytes before the frame."""
    idx = np.asarray(indices, np.uint8)
    h, w = idx.shape
    sw, sh = screen or (w, h)
    flags = 0
    gpal = b""
    if global_palette is not None:
        k, gpal = _gif_palette(global_palette)
        flags = 0x80 | k
    out = version + struct.pack("<HHBBB", sw, sh, flags, 0, 0) + gpal
    out += extensions
    if transparency is not None:
        out += b"!\xf9\x04" + bytes([1, 0, 0, transparency]) + b"\0"
    lflags = 0x40 if interlace else 0
    lpal = b""
    if local_palette is not None:
        k, lpal = _gif_palette(local_palette)
        lflags |= 0x80 | k
    out += b"," + struct.pack("<HHHHB", offset[0], offset[1], w, h, lflags)
    out += lpal
    if bits is None:
        bits = max(2, int(idx.max()).bit_length() if idx.size else 2)
    rows = (np.concatenate([np.arange(0, h, 8), np.arange(4, h, 8),
                            np.arange(2, h, 4), np.arange(1, h, 2)])
            if interlace else np.arange(h))
    out += bytes([bits]) + gif_lzw(idx[rows].reshape(-1), bits,
                                   literal=literal, end=end)
    return out + b";"


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
    out.update(webp_gif_fixtures())
    out.update(tiff_variant_fixtures())
    out.update(new_format_fixtures())
    out.update(legacy_fixtures())
    out.update(sci_rare_fixtures())
    out.update(jpeg2000_fixtures())
    out.update(tiff_leftover_fixtures())
    return out


def tiff_variant_fixtures() -> dict:
    """{file name: bytes} of the TIFF variants under ``tests/ldr``:
    JPEG-in-TIFF, YCbCr, CIELab, float, 32-bit and 12-bit samples,
    BigTIFF, old-style LZW, CCITT and LZMA."""
    from PIL import Image

    rgb = sample_image(40, 24, 2, 3)
    rgba = sample_image(37, 21, 1)
    gray = sample_image(33, 17, 3, 1)
    ycc = rgb_to_ycbcr(rgb)
    out = {}
    out["jpeg_ycbcr_tiles.tif"] = write_tiff(
        ycc, 8, 6, compression=7, subsampling=(2, 2), tile=(16, 16),
        jpeg={"sampling": [(2, 2), (1, 1), (1, 1)], "quality": 85})
    out["jpeg_rgb_pillow.tif"] = pillow_bytes(rgb, "TIFF", compression="jpeg")
    out["jpeg_gray_strips.tif"] = write_tiff(gray, 8, 1, compression=7,
                                             rows_per_strip=8,
                                             jpeg={"tables": False})
    out["ycbcr_lzw_22.tif"] = write_tiff(ycc, 8, 6, compression=5,
                                         subsampling=(2, 2), rows_per_strip=6)
    out["ycbcr_deflate_41_rbw.tif"] = write_tiff(
        ycc, 8, 6, compression=8, subsampling=(4, 1), rows_per_strip=5,
        tags={532: (5, [(16, 1), (235, 1), (128, 1), (240, 1), (128, 1),
                        (240, 1)]),
              529: (5, [(2126, 10000), (7152, 10000), (722, 10000)])})
    out["ycbcr_packbits_44_tiles.tif"] = write_tiff(
        ycc, 8, 6, compression=32773, subsampling=(4, 4), tile=(32, 16))
    lab = np.stack([gray[..., 0], sample_image(33, 17, 4, 1)[..., 0] - 100,
                    sample_image(33, 17, 5, 1)[..., 0] ^ 0x80], -1)
    out["lab_lzw.tif"] = write_tiff(lab.astype(np.uint8), 8, 8, compression=5,
                                    rows_per_strip=7)
    out["lab_pillow.tif"] = pillow_bytes(Image.fromarray(rgb).convert("LAB"),
                                         "TIFF")
    out["float_lzw_pred3.tif"] = write_tiff(float_gray(37, 21, 6), 32, 1,
                                            compression=5, predictor=3,
                                            sample_format=3, rows_per_strip=8)
    out["float_mm_raw.tif"] = write_tiff(float_gray(19, 11, 7), 32, 0,
                                         order=">", sample_format=3)
    out["int32_deflate.tif"] = write_tiff(
        gray.astype(np.int64) * 3 - 200, 32, 1, compression=8, predictor=2,
        sample_format=2)
    out["gray12_lzw.tif"] = write_tiff(gray.astype(np.uint16) * 13 + 7, 12, 1,
                                       compression=5)
    out["bigtiff_lzw_rgba.tif"] = write_tiff(rgba, 8, 2, compression=5,
                                             extra=(2,), predictor=2,
                                             bigtiff=True, rows_per_strip=5)
    out["bigtiff_pillow.tif"] = pillow_bytes(rgb, "TIFF", big_tiff=True,
                                             compression="tiff_adobe_deflate")
    out["old_lzw_predictor.tif"] = write_tiff(rgb, 8, 2, compression=5,
                                              predictor=2, old_lzw=True,
                                              rows_per_strip=9)
    bits = (gray > 120).astype(np.uint8)
    out["g4.tif"] = write_tiff(bits, 1, 0, compression=4, rows_per_strip=6)
    out["g3_2d_fill2.tif"] = write_tiff(bits, 1, 1, compression=3,
                                        fax_options=5, fill=2)
    out["ccitt_pillow.tif"] = pillow_bytes(
        Image.fromarray(gray[..., 0]).convert("1"), "TIFF",
        compression="tiff_ccitt")
    out["lzma_rgb16_predictor.tif"] = write_tiff(
        sample_image(21, 13, 14, 3).astype(np.uint16) * 257, 16, 2,
        compression=34925, predictor=2)
    return out


def tiff_leftover_fixtures() -> dict:
    """{file name: bytes} of TIFF's last variants under ``tests/ldr``: zstd
    (Pillow's libtiff and this suite's writer, with libzstd), old-style
    JPEG in both layouts (``write_ojpeg``), ThunderScan, CCITT RLEW,
    big-endian signed 16-bit samples and separate planes of other modes."""
    from PIL import Image

    rgb = sample_image(40, 24, 41, 3)
    rgba = sample_image(37, 21, 42)
    gray = sample_image(33, 17, 43, 1)
    rgb16 = sample_image(29, 15, 44, 4).astype(np.uint16) * 257 + 3
    wide = sample_image(48, 32, 45, 3)
    out = {}
    out["zstd_rgb_pillow.tif"] = pillow_bytes(rgb, "TIFF", compression="zstd")
    out["zstd_rgba_pred2.tif"] = pillow_bytes(rgba, "TIFF", compression="zstd",
                                              tiffinfo={317: 2})
    out["zstd_gray16_mm_tiles.tif"] = write_tiff(
        rgb16[..., :1], 16, 1, compression=50000, predictor=2, order=">",
        tile=(16, 16))
    out["zstd_float_pred3.tif"] = write_tiff(float_gray(27, 19, 46), 32, 1,
                                             compression=50000, predictor=3,
                                             sample_format=3, rows_per_strip=8)
    out["ojpeg_jif_420_strips.tif"] = write_ojpeg(wide, rows_per_strip=16)
    out["ojpeg_jif_422_tiles.tif"] = write_ojpeg(wide, sampling=(2, 1),
                                                 tile=(16, 16))
    out["ojpeg_tables_444.tif"] = write_ojpeg(wide, layout="tables",
                                              sampling=(1, 1),
                                              rows_per_strip=8)
    out["ojpeg_tables_420_nospp.tif"] = write_ojpeg(wide, layout="tables",
                                                    spp_tag=False,
                                                    rows_per_strip=16)
    out["ojpeg_tables_gray.tif"] = write_ojpeg(wide[..., :1], layout="tables",
                                               photometric=1,
                                               rows_per_strip=8)
    out["ojpeg_jif_rgb_photometric.tif"] = write_ojpeg(wide, photometric=2,
                                                       sampling=(1, 1))
    out["thunderscan_gray4.tif"] = write_tiff(gray >> 4, 4, 1,
                                              compression=32809,
                                              rows_per_strip=6)
    out["thunderscan_palette4.tif"] = write_tiff(
        gray >> 4, 4, 3, compression=32809,
        colormap=np.arange(48).reshape(3, 16) * 4000 % 65536)
    bits = (gray > 110).astype(np.uint8)
    out["rlew.tif"] = write_tiff(bits, 1, 0, compression=32771,
                                 rows_per_strip=5)
    out["rlew_fill2.tif"] = write_tiff(bits, 1, 1, compression=32771, fill=2)
    signed = (gray.astype(np.int64) - 100) * 150
    out["signed16_mm_lzw.tif"] = write_tiff(signed, 16, 1, compression=5,
                                            order=">", sample_format=2)
    out["signed16_mm_zstd_pred2.tif"] = write_tiff(
        signed, 16, 1, compression=50000, order=">", sample_format=2,
        predictor=2)
    out["planes_rgb16_lzw.tif"] = write_tiff(rgb16[..., :3], 16, 2,
                                             compression=5, planar=2)
    out["planes_rgba16_zstd.tif"] = write_tiff(rgb16, 16, 2,
                                               compression=50000, planar=2,
                                               extra=(2,))
    out["planes_cmyk16_deflate.tif"] = write_tiff(rgb16, 16, 5, compression=8,
                                                  planar=2)
    out["planes_la_packbits.tif"] = write_tiff(rgba[..., :2], 8, 1,
                                               compression=32773, planar=2,
                                               extra=(2,))
    out["planes_lab_lzw.tif"] = write_tiff(rgb, 8, 8, compression=5,
                                           planar=2, rows_per_strip=7)
    out["planes_jpeg_rgb.tif"] = write_tiff(rgb, 8, 2, compression=7,
                                            planar=2, rows_per_strip=8)
    return out


def env_tiff_zstd(w: int, h: int, seed: int) -> bytes:
    """An environment map: a zstd RGB TIFF (predictor 2) written by
    Pillow's libtiff."""
    return pillow_bytes(sample_image(w, h, seed, 3), "TIFF",
                        compression="zstd", tiffinfo={317: 2})


def env_tiff_ojpeg(w: int, h: int, seed: int) -> bytes:
    """An environment map: an old-style JPEG TIFF, YCbCr 2x2, the table
    tags' layout."""
    return write_ojpeg(sample_image(w, h, seed, 3), layout="tables",
                       rows_per_strip=16)


LARGE_TIFF_ZSTD = "zstd_rgb_pred2_4096x2048.tif"
LARGE_TIFF_OJPEG = "ojpeg_ycbcr_4096x2048.tif"
MEDIUM_TIFF_ZSTD = "zstd_rgb_pred2_512x256.tif"
MEDIUM_TIFF_OJPEG = "ojpeg_ycbcr_512x256.tif"


def tiff_timing_file(kind: str, w: int, h: int) -> bytes:
    """The card's zstd and old-style JPEG timing maps (committed: its host
    has neither libzstd nor a JPEG encoder): ``smooth_rgba``'s colours,
    zstd at level 3 with predictor 2 in strips of 16 rows, or old-style
    JPEG (4:2:0, quality 90, the interchange stream's layout, strips of
    64 rows)."""
    rgb = smooth_rgba(w, h)[..., :3]
    if kind == "zstd":
        return write_tiff(rgb, 8, 2, compression=50000, predictor=2,
                          rows_per_strip=16)
    return write_ojpeg(rgb, rows_per_strip=64, quality=90)


def float_gray(w: int, h: int, seed: int) -> np.ndarray:
    """(h, w, 1) float32 samples around 0-255 with the edges of Pillow's
    F -> L conversion in the first row: below 0, fractions, past 255, NaN
    and infinities."""
    v = sample_image(w, h, seed, 1).astype(np.float32) * 1.3 - 40.7
    edges = [-3.7, 0.5, 1.5, 254.6, 300.0, np.nan, -np.inf, np.inf, 255.99,
             -0.5, 1e30]
    v[0, :min(w, len(edges)), 0] = edges[:w]
    return v


def fax_page(w: int, h: int, seed: int) -> np.ndarray:
    """(h, w) 0/1 samples like a scanned page: lines of 12x16 glyph cells,
    each glyph a seeded 8x12 pattern, with margins and blank lines."""
    rng = np.random.default_rng(seed)
    glyphs = (rng.random((64, 12, 8)) < 0.45).astype(np.uint8)
    page = np.zeros((h, w), np.uint8)
    cells_y, cells_x = (h - 64) // 16, (w - 64) // 12
    picks = rng.integers(0, 64, (cells_y, cells_x))
    blank = rng.random((cells_y, cells_x)) < 0.2
    for cy in range(cells_y):
        if cy % 9 == 8:
            continue  # a blank line between paragraphs
        for cx in range(cells_x):
            if not blank[cy, cx]:
                y, x = 32 + 16 * cy, 32 + 12 * cx
                page[y:y + 12, x:x + 8] = glyphs[picks[cy, cx]]
    return page


def float_field(w: int, h: int, period: int = 16) -> np.ndarray:
    """(h, w, 1) float32 radiance-like samples (0 to a few hundred, smooth
    in x), repeating every ``period`` rows so that the LZW writer
    compresses one strip of them."""
    x = np.linspace(0.0, 1.0, w, dtype=np.float32)[None, :]
    y = np.linspace(0.0, 1.0, period, dtype=np.float32)[:, None]
    band = (120 + 110 * np.sin(9 * x) * np.cos(3 * y) + 40 * x * y) ** 1.1
    return np.tile(band.astype(np.float32), (-(-h // period), 1))[:h, :, None]


# The committed JPEG-in-TIFF YCbCr 2x2 timing file, 4096x2048, whose Pillow
# decode only ``pillow_sha256.json`` holds.
LARGE_TIFF_JPEG = "large_jpeg_ycbcr_4096x2048.tif"


def large_tiff_jpeg(w: int = 4096, h: int = 2048) -> bytes:
    """A JPEG-in-TIFF YCbCr map (2x2, 256x256 tiles, quality 75) of smooth
    content."""
    y = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None]
    x = np.linspace(0.0, 1.0, w, dtype=np.float32)[None, :]
    img = np.stack([0.5 + 0.4 * np.sin(6 * x + 3 * y),
                    0.5 + 0.4 * np.cos(5 * y) * x, 0.3 + 0.5 * x * y], -1)
    return write_tiff(rgb_to_ycbcr((img * 255).astype(np.uint8)), 8, 6,
                      compression=7, subsampling=(2, 2), tile=(256, 256),
                      jpeg={"sampling": [(2, 2), (1, 1), (1, 1)],
                            "quality": 75})


def env_tiff_jpeg(w: int, h: int, seed: int) -> bytes:
    """A JPEG-in-TIFF YCbCr map (2x2 subsampling, 16x16 tiles, quality 90)
    of ``sample_image``."""
    ycc = rgb_to_ycbcr(sample_image(w, h, seed, 3))
    return write_tiff(ycc, 8, 6, compression=7, subsampling=(2, 2),
                      tile=(16, 16), jpeg={"sampling": [(2, 2), (1, 1), (1, 1)],
                                           "quality": 90})


def env_tiff_float(w: int, h: int, seed: int) -> bytes:
    """A float gray map (LZW, the floating-point predictor) of
    ``float_gray``."""
    return write_tiff(float_gray(w, h, seed), 32, 1, compression=5,
                      predictor=3, sample_format=3, rows_per_strip=16)


def webp_gif_fixtures() -> dict:
    """{file name: bytes} of the WebP and GIF files under ``tests/ldr``."""
    from PIL import Image

    rgba = sample_image(37, 21, 1)
    rgb = sample_image(40, 24, 2, 3)
    opaque = np.concatenate([rgb, np.full((24, 40, 1), 255, np.uint8)], -1)
    out = {}
    # WebP: Pillow's lossless and lossy writers, libwebp's encoder with
    # options Pillow never sets, and this module's own VP8L and ALPH data.
    out["lossless_rgba.webp"] = pillow_bytes(rgba, "WEBP", lossless=True)
    out["lossless_rgb.webp"] = pillow_bytes(rgb, "WEBP", lossless=True)
    out["lossless_alpha_bit_cleared.webp"] = write_vp8l(
        rgba, transforms=("subtract_green",), alpha_used=False)
    out["lossy_q75.webp"] = pillow_bytes(rgb, "WEBP", quality=75)
    out["lossy_q5_m0.webp"] = pillow_bytes(rgb, "WEBP", quality=5, method=0)
    out["lossy_alpha.webp"] = pillow_bytes(rgba, "WEBP", quality=80)
    out["lossy_simple_filter_8parts.webp"] = libwebp_encode(
        opaque, filter_type=0, partitions=3, segments=4, sns_strength=100,
        filter_strength=60)
    out["lossy_sharp_yuv_17x23.webp"] = libwebp_encode(
        sample_image(17, 23, 3), use_sharp_yuv=1, quality=60.0)
    lossy = libwebp_encode(sample_image(13, 9, 2), alpha_compression=0)
    alpha = sample_image(13, 9, 4)[..., 3]
    out["alpha_raw_gradient.webp"] = with_alph(lossy, write_alph(alpha, 3,
                                                                 False), 13, 9)
    out["alpha_vp8l_horizontal.webp"] = with_alph(
        lossy, write_alph(alpha, 1, True), 13, 9)
    out["vp8l_all_transforms_cache.webp"] = write_vp8l(
        rgba, transforms=("subtract_green", "predictor", "cross_color"),
        cache=5, seed=7)
    pal = sample_image(4, 1, 8)[0]
    out["vp8l_palette4.webp"] = write_vp8l(
        pal[(sample_image(29, 19, 9, 1)[..., 0] >> 6)],
        transforms=("palette",))
    out["vp8x_icc_exif_xmp.webp"] = pillow_bytes(
        rgba, "WEBP", icc_profile=bytes(range(128)),
        exif=b"Exif\0\0II*\0\x08\0\0\0\0\0", xmp=b"<x:xmpmeta/>")
    out["animated_offset.webp"] = write_animated_webp(
        [(4, 6, libwebp_encode(sample_image(9, 7, 10)), 50, 0),
         (0, 0, libwebp_encode(sample_image(20, 17, 11), lossless=1), 50, 2)],
        (20, 17))
    # GIF: Pillow's writer and this module's.
    idx = sample_image(40, 24, 12, 1)[..., 0] >> 4
    palette = sample_image(16, 1, 13, 3)[0]
    pimg = Image.fromarray(rgb).convert("P", palette=Image.Palette.ADAPTIVE,
                                        colors=50)
    out["pillow_p.gif"] = pillow_bytes(pimg, "GIF")
    out["pillow_l.gif"] = pillow_bytes(Image.fromarray(rgb).convert("L"), "GIF")
    out["interlaced_local.gif"] = write_gif(idx, interlace=True,
                                            local_palette=palette)
    ramp = np.repeat(np.arange(4, dtype=np.uint8)[:, None], 3, 1)
    out["gray_ramp_past.gif"] = write_gif(
        (idx[:9, :11] % 10).astype(np.uint8), global_palette=ramp)
    out["past_palette.gif"] = write_gif((idx[:9, :11] % 10).astype(np.uint8),
                                        global_palette=palette[:4])
    out["transparent.gif"] = write_gif(idx[:10, :12], screen=(20, 15),
                                       offset=(3, 4), global_palette=palette,
                                       transparency=5)
    out["offset_past_screen.gif"] = write_gif(idx[:10, :12], screen=(8, 6),
                                              offset=(5, 2),
                                              global_palette=palette)
    out["no_palette_transparent.gif"] = write_gif(idx[:7, :9], transparency=3)
    rng = np.random.default_rng(14)
    out["full_table_12bit.gif"] = write_gif(
        rng.integers(0, 256, (64, 64)).astype(np.uint8), bits=8,
        global_palette=rng.integers(0, 256, (256, 3)))
    out["bits5_literal.gif"] = write_gif(idx[:11, :13], bits=5, literal=True,
                                         global_palette=palette)
    return out


def env_webp(w: int, h: int, seed: int) -> bytes:
    """A lossy (quality 80) RGB WebP map of ``sample_image``."""
    return pillow_bytes(sample_image(w, h, seed, 3), "WEBP", quality=80)


def env_gif(w: int, h: int, seed: int) -> bytes:
    """A GIF map: ``sample_image`` quantized by Pillow to 64 colours."""
    from PIL import Image

    img = Image.fromarray(sample_image(w, h, seed, 3))
    return pillow_bytes(img.convert("P", palette=Image.Palette.ADAPTIVE,
                                    colors=64), "GIF")


# The committed lossy WebPs with alpha, 4096x2048 and 1024x512, whose
# Pillow decodes only ``pillow_sha256.json`` holds (the larger is 32 MiB).
LARGE_WEBP = "large_lossy_alpha_4096x2048.webp"
MEDIUM_WEBP = "medium_lossy_alpha_1024x512.webp"


def large_webp(w: int = 4096, h: int = 2048) -> bytes:
    """A lossy (quality 75) WebP with alpha of smooth seeded content,
    written by Pillow."""
    y = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None]
    x = np.linspace(0.0, 1.0, w, dtype=np.float32)[None, :]
    img = np.stack([0.5 + 0.4 * np.sin(6 * x + 3 * y),
                    0.5 + 0.4 * np.cos(5 * y) * x, 0.3 + 0.5 * x * y,
                    0.6 + 0.4 * np.sin(9 * x * y)], -1)
    return pillow_bytes((img * 255).astype(np.uint8), "WEBP", quality=75)


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


# --- QOI, PCX, DCX, SGI, PSD, DDS ---------------------------------------------


def qoi_ops(rgba: np.ndarray, channels: int = 4) -> bytes:
    """A QOI op stream of (h, w, 4) pixels, as the specification's encoder
    writes it (index, diff, luma, run, RGB and RGBA ops)."""
    index = [None] * 64
    prev = (0, 0, 0, 255)
    out = bytearray()
    run = 0
    for px in map(tuple, rgba.reshape(-1, 4).astype(int)):
        if channels == 3:
            px = px[:3] + (255,)
        if px == prev:
            run += 1
            if run == 62:
                out.append(0xC0 | 61)
                run = 0
            continue
        if run:
            out.append(0xC0 | (run - 1))
            run = 0
        h = (px[0] * 3 + px[1] * 5 + px[2] * 7 + px[3] * 11) % 64
        if index[h] == px:
            out.append(h)
        else:
            index[h] = px
            if px[3] != prev[3]:
                out += bytes([0xFF, *px])
            else:
                dr, dg, db = ((px[i] - prev[i] + 128) % 256 - 128
                              for i in range(3))
                if all(-2 <= d <= 1 for d in (dr, dg, db)):
                    out.append(0x40 | (dr + 2) << 4 | (dg + 2) << 2 | (db + 2))
                elif -32 <= dg <= 31 and -8 <= dr - dg <= 7 and \
                        -8 <= db - dg <= 7:
                    out += bytes([0x80 | (dg + 32),
                                  (dr - dg + 8) << 4 | (db - dg + 8)])
                else:
                    out += bytes([0xFE, *px[:3]])
        prev = px
    if run:
        out.append(0xC0 | (run - 1))
    return bytes(out)


def write_qoi(w: int, h: int, ops: bytes, channels: int = 4,
              colourspace: int = 0, end: bytes = b"\0" * 7 + b"\1") -> bytes:
    """A QOI file: the 14-byte header, ``ops`` and the end marker."""
    return b"qoif" + struct.pack(">IIBB", w, h, channels, colourspace) + ops \
        + end


def pcx_rle(rows: np.ndarray) -> bytes:
    """PCX run-length data of (h, row bytes) uint8, each row on its own:
    runs of up to 63, a byte with its two top bits set always as a run."""
    out = bytearray()
    for row in rows:
        starts, lengths = _runs(row[:, None], len(row))
        for s, n in zip(starts, lengths):
            v = int(row[s])
            while n > 0:
                k = min(n, 63)
                if k == 1 and v < 0xC0:
                    out.append(v)
                else:
                    out += bytes([0xC0 | k, v])
                n -= k
    return bytes(out)


def write_pcx(rows: np.ndarray, w: int, bits: int, planes: int, *,
              version: int = 5, palette16: bytes = bytes(48),
              trailer: bytes | None = None, stride: int | None = None,
              origin: tuple = (0, 0), data: bytes | None = None) -> bytes:
    """A PCX file of (h, planes * stride) row bytes (``stride`` the
    header's bytes a plane a row, as the rows were laid out), run-length
    coded (or ``data`` as it is), with a 16-colour header palette and an
    optional 769-byte trailer."""
    h = rows.shape[0]
    stride = rows.shape[1] // planes if stride is None else stride
    x0, y0 = origin
    head = struct.pack("<BBBB4HHH", 10, version, 1, bits, x0, y0, x0 + w - 1,
                       y0 + h - 1, 72, 72) + palette16 + bytes([0, planes]) \
        + struct.pack("<HH", stride, 1) + bytes(58)
    body = pcx_rle(rows) if data is None else data
    return head + body + (trailer or b"")


def pcx_planes(idx: np.ndarray, planes: int, stride: int) -> np.ndarray:
    """(h, w) indices below 2^planes -> (h, planes * stride) rows of bit
    planes, plane k the indices' bit k."""
    h, w = idx.shape
    rows = np.zeros((h, planes * stride), np.uint8)
    for k in range(planes):
        packed = np.packbits((idx >> k) & 1, axis=1)
        rows[:, k * stride:k * stride + packed.shape[1]] = packed
    return rows


def write_dcx(pages: list) -> bytes:
    """A DCX file: its magic, the page offsets, a 0, the pages."""
    at = 4 + 4 * (len(pages) + 1)
    offsets = []
    for page in pages:
        offsets.append(at)
        at += len(page)
    return struct.pack(f"<I{len(pages) + 1}I", 0x3ADE68B1, *offsets, 0) + \
        b"".join(pages)


def sgi_rle_row(samples: np.ndarray, bpc: int) -> bytes:
    """One channel of one SGI row: runs (up to 127) and copies, then a 0
    count; 16-bit samples as big-endian words."""
    fmt = ">u2" if bpc == 2 else "u1"
    out = bytearray()
    starts, lengths = _runs(samples[:, None], len(samples))
    lit = []

    def flush():
        while lit:
            k = min(len(lit), 127)
            out.extend(np.array([0x80 | k], fmt).tobytes())
            out.extend(np.array(lit[:k], fmt).tobytes())
            del lit[:k]

    for s, n in zip(starts, lengths):
        if n < 3:
            lit.extend(int(v) for v in samples[s:s + n])
            continue
        flush()
        while n > 0:
            k = min(n, 127)
            out.extend(np.array([k, int(samples[s])], fmt).tobytes())
            n -= k
    flush()
    out.extend(np.array([0], fmt).tobytes())
    return bytes(out)


def write_sgi(px: np.ndarray, bpc: int = 1, rle: bool = False, *,
              dimension: int | None = None, share_rows: bool = False,
              reverse_rows: bool = False) -> bytes:
    """An SGI file of (h, w, z) samples (uint16 at ``bpc`` 2), rows stored
    bottom-up; RLE rows each once (identical rows sharing their data when
    ``share_rows``; the rows' data in reverse order when
    ``reverse_rows``)."""
    h, w, z = px.shape
    dimension = dimension or (3 if z > 1 else 2)
    head = struct.pack(">HBBHHHHiiI", 474, int(rle), bpc, dimension, w, h, z,
                       0, (1 << (8 * bpc)) - 1, 0)
    head = head.ljust(512, b"\0")
    planes = np.moveaxis(px[::-1], -1, 0)  # (z, h, w), bottom row first
    if not rle:
        fmt = ">u2" if bpc == 2 else "u1"
        return head + planes.astype(fmt).tobytes()
    rows = [sgi_rle_row(planes[c, y], bpc) for c in range(z) for y in range(h)]
    order = list(range(len(rows)))[::-1] if reverse_rows else list(
        range(len(rows)))
    at = 512 + 8 * len(rows)
    placed, body = {}, bytearray()
    starts = [0] * len(rows)
    for i in order:
        key = rows[i] if share_rows else i
        if key not in placed:
            placed[key] = at + len(body)
            body += rows[i]
        starts[i] = placed[key]
    lengths = [len(r) for r in rows]
    return head + struct.pack(f">{2 * len(rows)}I", *starts, *lengths) + body


def psd_packbits_row(row: bytes) -> bytes:
    """One PSD row in PackBits: runs of 3-128 bytes, literals of up to
    128."""
    out = bytearray()
    i, n = 0, len(row)
    lit = bytearray()
    while i < n:
        j = i
        while j < n and j - i < 128 and row[j] == row[i]:
            j += 1
        if j - i >= 3:
            while lit:
                out += bytes([min(len(lit), 128) - 1]) + lit[:128]
                del lit[:128]
            out += bytes([257 - (j - i), row[i]])
            i = j
        else:
            lit.append(row[i])
            i += 1
    while lit:
        out += bytes([min(len(lit), 128) - 1]) + lit[:128]
        del lit[:128]
    return bytes(out)


def psd_packbits_segments(planes: np.ndarray) -> tuple[np.ndarray, bytes]:
    """PackBits of (c, h, w) uint8 planes in NumPy, each row cut into
    128-byte segments, a run packet where a segment is one value and a
    literal one elsewhere: (the (c * h,) row byte counts, the data)."""
    c, h, w = planes.shape
    n = -(-w // 128)
    seg = np.zeros((c * h, n, 128), np.uint8)
    seg.reshape(c * h, -1)[:, :w] = planes.reshape(c * h, w)
    size = np.full(n, 128)
    size[-1] = w - 128 * (n - 1)
    flat = ((seg == seg[..., :1]) | (np.arange(128) >= size[:, None])).all(-1)
    packets = np.zeros((c * h, n, 129), np.uint8)
    packets[..., 0] = np.where(flat, 257 - size, size - 1)
    packets[..., 1:] = seg
    length = np.where(flat, 2, size + 1)
    keep = np.arange(129) < length[..., None]
    return length.sum(1), packets[keep].tobytes()


def write_psd(planes: np.ndarray, mode: int, *, bits: int = 8,
              compression: int = 0, colour_data: bytes = b"",
              resources: bytes = b"", layers: bytes = b"",
              channels: int | None = None, width: int | None = None,
              segments: bool = False) -> bytes:
    """A PSD file of (c, h, row bytes) uint8 planes (bit-packed rows at 1
    bit) in colour ``mode``: the header (``channels`` as given, else c),
    the sections, and the merged image raw (0) or in PackBits (1, each row
    coded on its own after the table of row byte counts; in 128-byte
    segments by ``psd_packbits_segments`` when ``segments``)."""
    c, h, _ = planes.shape
    width = width or (planes.shape[2] * 8 if bits == 1 else planes.shape[2])
    head = b"8BPS" + struct.pack(">H6xHIIHH", 1, channels or c, h, width,
                                 bits, mode)
    out = head + struct.pack(">I", len(colour_data)) + colour_data \
        + struct.pack(">I", len(resources)) + resources \
        + struct.pack(">I", len(layers)) + layers + struct.pack(
            ">H", compression)
    if compression == 1 and segments:
        counts, data = psd_packbits_segments(planes)
        return out + counts.astype(">u2").tobytes() + data
    if compression == 1:
        coded = [psd_packbits_row(bytes(r)) for p in planes for r in p]
        return out + struct.pack(f">{len(coded)}H", *map(len, coded)) + \
            b"".join(coded)
    return out + planes.tobytes()


def psd_resource(ident: int, name: bytes, data: bytes) -> bytes:
    """One image resource block (name and data padded to even)."""
    label = bytes([len(name)]) + name
    label += b"\0" * (len(label) % 2)
    return b"8BIM" + struct.pack(">H", ident) + label + struct.pack(
        ">I", len(data)) + data + b"\0" * (len(data) % 2)


DDPF = {"alpha": 0x1, "fourcc": 0x4, "palette": 0x20, "rgb": 0x40,
        "luminance": 0x20000}


def write_dds(w: int, h: int, payload: bytes, *, flags: int = 0,
              fourcc: bytes = b"\0\0\0\0", bitcount: int = 0,
              masks: tuple = (0, 0, 0, 0), dxgi: int | None = None,
              header_size: int = 124) -> bytes:
    """A DDS file: the 128-byte header (a DX10 header after it when
    ``dxgi`` is given, FourCC "DX10"), then ``payload`` (a palette, the
    pixels or the blocks)."""
    if dxgi is not None:
        fourcc, flags = b"DX10", flags | DDPF["fourcc"]
    head = b"DDS " + struct.pack("<7I", header_size, 0x1007, h, w, 0, 0, 0) \
        + bytes(44) + struct.pack("<II4sI4I", 32, flags, fourcc, bitcount,
                                  *masks) + struct.pack("<5I", 0x1000, 0, 0,
                                                        0, 0)
    if dxgi is not None:
        head += struct.pack("<5I", dxgi, 3, 0, 1, 0)
    return head + payload


def blocks_of(img: np.ndarray) -> np.ndarray:
    """(h, w, c) pixels, h and w multiples of 4 -> (blocks, 16, c) in row
    order of blocks, each block's pixels in row order."""
    h, w, c = img.shape
    return img.reshape(h // 4, 4, w // 4, 4, c).transpose(0, 2, 1, 3, 4) \
        .reshape(-1, 16, c)


def bc7_mode6(rgba: np.ndarray) -> bytes:
    """BC7 mode-6 blocks of (h, w, 4) uint8 pixels (h and w multiples of
    4): each block's per-channel minimum and maximum as its endpoints (7
    bits and a p-bit of 0 and 1), 4-bit indices by projection on the
    segment between them, pixel 0's top index bit clear."""
    px = blocks_of(rgba).astype(np.int64)
    n = len(px)
    e0 = px.min(1) & ~1
    e1 = px.max(1) | 1
    d = (e1 - e0)[:, None, :]
    t = ((px - e0[:, None, :]) * d).sum(2) / np.maximum((d * d).sum(2), 1)
    idx = np.clip(np.rint(t * 15), 0, 15).astype(np.int64)
    flip = idx[:, 0] >= 8
    e0, e1 = np.where(flip[:, None], e1, e0), np.where(flip[:, None], e0, e1)
    idx = np.where(flip[:, None], 15 - idx, idx)
    fields = [(np.full(n, 64), 7)]
    for ch in range(4):
        fields += [(e0[:, ch] >> 1, 7), (e1[:, ch] >> 1, 7)]
    fields += [(e0[:, 0] & 1, 1), (e1[:, 0] & 1, 1), (idx[:, 0], 3)]
    fields += [(idx[:, i], 4) for i in range(1, 16)]
    bits = np.zeros((n, 128), np.uint8)
    pos = 0
    for value, width in fields:
        for k in range(width):
            bits[:, pos + k] = (value >> k) & 1
        pos += width
    return np.packbits(bits, axis=1, bitorder="little").tobytes()


def random_blocks(n: int, size: int, seed: int, fmt: str = "") -> bytes:
    """``n`` random blocks of ``size`` bytes; for BC6H the first byte's
    mode bits spread over all 32 codes (reserved ones included)."""
    rng = np.random.default_rng(seed)
    blocks = rng.integers(0, 256, (n, size), dtype=np.uint8)
    if fmt.startswith("BC6"):
        blocks[:, 0] = (blocks[:, 0] & 0xE0) | rng.integers(0, 32, n)
    return blocks.tobytes()


LARGE_BC7 = "bc7_mode6_4096x2048.dds"


def smooth_rgba(w: int, h: int) -> np.ndarray:
    """Smooth seeded-free RGBA content (the large timing files')."""
    y = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None]
    x = np.linspace(0.0, 1.0, w, dtype=np.float32)[None, :]
    img = np.stack([0.5 + 0.4 * np.sin(6 * x + 3 * y),
                    0.5 + 0.4 * np.cos(5 * y) * x, 0.3 + 0.5 * x * y,
                    0.6 + 0.4 * np.sin(9 * x * y)], -1)
    return (img * 255).astype(np.uint8)


def large_bc7(w: int = 4096, h: int = 2048) -> bytes:
    """A BC7 (mode 6) DDS of ``smooth_rgba`` content, DXGI BC7_UNORM."""
    return write_dds(w, h, bc7_mode6(smooth_rgba(w, h)), dxgi=98)


def large_psd(w: int = 4096, h: int = 2048) -> tuple[bytes, np.ndarray]:
    """A PackBits RGBA PSD (``psd_packbits_segments``) of ``sample_image``
    content with a flat band on the left (run packets), and the (h, w, 4)
    array it was made from."""
    img = sample_image(w, h, 61)
    img[:, :w // 4] = img[:, :1]
    return write_psd(np.moveaxis(img, -1, 0), 3, compression=1,
                     segments=True), img


def new_format_fixtures() -> dict:
    """{file name: bytes} of the QOI, PCX, DCX, SGI, PSD and DDS files
    under ``tests/ldr``."""
    from PIL import Image

    rgba = sample_image(37, 21, 1)
    rgb = sample_image(40, 24, 2, 3)
    gray = sample_image(33, 17, 3, 1)[..., 0]
    pal = Image.fromarray(rgb).convert("P", palette=Image.Palette.ADAPTIVE,
                                       colors=40)
    out = {}
    # QOI: Pillow's writer, and op streams showing Pillow's decoder.
    out["pillow_rgba.qoi"] = pillow_bytes(rgba, "QOI")
    out["pillow_rgb.qoi"] = pillow_bytes(rgb, "QOI")
    quirks = bytes([0x05, 0xFF, 10, 20, 30, 40, 0xC4, 0x15, 0x55, 0xFE, 1,
                    2, 3, 0x80 | 40, 0x9C, 0x3F, 0xC0 | 61])
    out["ops_rgb_alpha_index.qoi"] = write_qoi(9, 7, quirks, channels=3,
                                               colourspace=1, end=b"")
    # PCX: Pillow's writer in each mode, and planar, odd-stride and DCX files.
    out["pillow_rgb.pcx"] = pillow_bytes(rgb[:, :39], "PCX")
    out["pillow_p.pcx"] = pillow_bytes(pal, "PCX")
    out["pillow_l.pcx"] = pillow_bytes(Image.fromarray(gray), "PCX")
    out["pillow_1.pcx"] = pillow_bytes(Image.fromarray(gray).convert("1"),
                                       "PCX")
    idx16 = sample_image(29, 19, 4, 1)[..., 0] >> 4
    pal16 = sample_image(16, 1, 5, 3)[0].tobytes()
    out["planes4_p4l.pcx"] = write_pcx(pcx_planes(idx16, 4, 4), 29, 1, 4,
                                       palette16=pal16, version=2)
    out["planes2_p2l.pcx"] = write_pcx(pcx_planes(idx16 & 3, 2, 4), 29, 1, 2,
                                       palette16=pal16, version=3)
    odd = sample_image(13, 9, 6, 3)
    out["rgb_odd_width_even_stride.pcx"] = write_pcx(
        np.concatenate([np.pad(odd[..., c], ((0, 0), (0, 1)))
                        for c in range(3)], 1), 13, 8, 3, stride=15)
    out["pages.dcx"] = write_dcx([pillow_bytes(rgb[:9, :11], "PCX"),
                                  pillow_bytes(rgba[..., :3], "PCX")])
    # SGI: Pillow's writer, and 16-bit RLE, shared rows, 1-D gray.
    out["pillow_rgba_rle.sgi"] = pillow_bytes(rgba, "SGI", compression="rle")
    out["pillow_gray_raw.sgi"] = pillow_bytes(Image.fromarray(gray), "SGI")
    rgb16 = rgb.astype(np.uint16) * 257 + np.arange(40, dtype=np.uint16)[
        None, :, None]
    out["rgb16_rle.sgi"] = write_sgi(rgb16, 2, True)
    out["rgba16_raw.sgi"] = write_sgi(rgba.astype(np.uint16) * 257, 2)
    bands = np.repeat(sample_image(17, 3, 7)[:, :, :4], 4, 0)
    out["shared_rows_rle.sgi"] = write_sgi(bands, 1, True, share_rows=True,
                                           reverse_rows=True)
    out["gray_1d.sgi"] = write_sgi(gray[:1, :, None], 1, False, dimension=1)
    # PSD: this module's writer, every mode, raw and PackBits.
    planes = np.moveaxis(rgba, -1, 0)
    out["rgba_packbits.psd"] = write_psd(planes, 3, compression=1,
                                         resources=psd_resource(
                                             1005, b"", bytes(16)))
    out["rgb_raw.psd"] = write_psd(np.moveaxis(rgb, -1, 0), 3)
    out["rgb_5_channels.psd"] = write_psd(np.concatenate(
        [planes, planes[:1]]), 3, compression=1)
    cmyk = np.asarray(Image.fromarray(rgb).convert("CMYK"))
    out["cmyk_packbits.psd"] = write_psd(255 - np.moveaxis(cmyk, -1, 0), 4,
                                         compression=1)
    lab = sample_image(19, 11, 8, 3)
    out["lab_raw.psd"] = write_psd(np.moveaxis(lab, -1, 0), 9)
    idx = np.asarray(pal)
    colours = np.asarray(pal.getpalette(), np.uint8).reshape(-1, 3)
    out["indexed_packbits.psd"] = write_psd(
        idx[None], 2, compression=1,
        colour_data=np.pad(colours, ((0, 256 - len(colours)), (0, 0))).T
        .tobytes())
    out["bitmap_raw.psd"] = write_psd(
        np.packbits(gray > 100, axis=1)[None], 0, bits=1, width=33)
    out["gray_layers_packbits.psd"] = write_psd(
        gray[None], 1, compression=1, layers=struct.pack(">I", 4) + bytes(4),
        resources=psd_resource(1039, b"icc", bytes(7)))
    out["duotone_raw.psd"] = write_psd(gray[None], 8, colour_data=bytes(10),
                                       channels=2)
    # DDS: Pillow's writer, and every other format Pillow reads.
    b1 = rgba.copy()
    b1[..., 3] = (b1[..., 3] > 127) * 255
    out["dxt1_alpha.dds"] = pillow_bytes(b1, "DDS", pixel_format="DXT1")
    out["dxt5.dds"] = pillow_bytes(rgba, "DDS", pixel_format="DXT5")
    out["bc5_dx10.dds"] = pillow_bytes(rgb, "DDS", pixel_format="BC5")
    out["pillow_la.dds"] = pillow_bytes(Image.fromarray(rgba).convert("LA"),
                                        "DDS")
    out["bc7_mode6.dds"] = write_dds(40, 24, bc7_mode6(
        sample_image(40, 24, 9)), dxgi=99)
    out["bc7_random_17x13.dds"] = write_dds(
        17, 13, random_blocks(20, 16, 10), dxgi=97)
    out["bc6h_uf16.dds"] = write_dds(16, 16, random_blocks(16, 16, 11, "BC6"),
                                     dxgi=95)
    out["bc6h_sf16.dds"] = write_dds(16, 16, random_blocks(16, 16, 12, "BC6"),
                                     dxgi=96)
    out["ati1.dds"] = write_dds(16, 8, random_blocks(8, 8, 13),
                                fourcc=b"ATI1", flags=DDPF["fourcc"])
    out["bc5s.dds"] = write_dds(16, 8, random_blocks(8, 16, 14),
                                fourcc=b"BC5S", flags=DDPF["fourcc"])
    out["masks_rgb565.dds"] = write_dds(
        11, 5, sample_image(11, 5, 15, 2).tobytes(), flags=DDPF["rgb"],
        bitcount=16, masks=(0xF800, 0x7E0, 0x1F, 0))
    out["masks_a4r4g4b4.dds"] = write_dds(
        11, 5, sample_image(11, 5, 16, 2).tobytes(),
        flags=DDPF["rgb"] | DDPF["alpha"], bitcount=16,
        masks=(0xF00, 0xF0, 0xF, 0xF000))
    out["p8.dds"] = write_dds(
        12, 6, sample_image(256, 1, 17)[0].tobytes()
        + sample_image(12, 6, 18, 1).tobytes(), flags=DDPF["palette"],
        bitcount=8)
    out["r8g8b8a8_srgb.dds"] = write_dds(9, 7, sample_image(9, 7, 19)
                                         .tobytes(), dxgi=29)
    return out


def env_qoi(w: int, h: int, seed: int) -> bytes:
    """An RGB QOI map of ``sample_image``."""
    return write_qoi(w, h, qoi_ops(sample_image(w, h, seed), 3), channels=3)


def env_dds_bc1(w: int, h: int, seed: int) -> bytes:
    """A DXT1 (BC1) DDS map of ``sample_image``, written by Pillow."""
    return pillow_bytes(sample_image(w, h, seed, 3), "DDS",
                        pixel_format="DXT1")


def env_sgi_rle(w: int, h: int, seed: int) -> bytes:
    """An RLE RGB SGI map of ``sample_image``."""
    return write_sgi(sample_image(w, h, seed, 3), 1, True)


# --- FTEX, BLP, ICNS, Sun raster, MSP, XBM, XPM ----------------------------


def write_ftex(w: int, h: int, fmt: int, mip: bytes, *, formats: int = 1,
               where: int = 32, size: int | None = None) -> bytes:
    """An FTEX file: the 32-byte header (one format, its mipmap at
    ``where``), then the mipmap's size and data."""
    head = b"FTEX" + struct.pack("<7i", 1, w, h, 1, formats, fmt, where)
    pad = bytes(max(0, where - len(head)))
    return head + pad + struct.pack("<i", len(mip) if size is None else size) \
        + mip


def to565(rgb: np.ndarray) -> np.ndarray:
    """(..., 3) uint8 -> 5:6:5 words (the top bits of each channel)."""
    c = rgb.astype(np.int64)
    return (c[..., 0] >> 3) << 11 | (c[..., 1] >> 2) << 5 | c[..., 2] >> 3


def dxt_blocks(rgba: np.ndarray, kind: int) -> bytes:
    """DXT1, DXT3 or DXT5 blocks of (h, w, 4) uint8 pixels (h and w
    multiples of 4): each block's colour endpoints its channel-wise
    maximum and minimum, each pixel the nearest of the four colours Pillow's
    BLP decoder makes of them; DXT1 blocks with a pixel of alpha below 128
    in the 3-colour mode, those pixels transparent; DXT3 alpha its top
    nibble; DXT5 alpha on the 8-value ramp of its extremes. Encoded
    65,536 blocks at a time (the timing files are large)."""
    blocks = blocks_of(rgba)
    return b"".join(_dxt_encode(blocks[i:i + 65536].astype(np.int64), kind)
                    for i in range(0, len(blocks), 65536))


def _dxt_encode(px: np.ndarray, kind: int) -> bytes:
    """``dxt_blocks`` of (n, 16, 4) block pixels."""
    n = len(px)
    hi, lo = to565(px[..., :3].max(1)), to565(px[..., :3].min(1))
    holes = (px[..., 3] < 128) if kind == 1 else np.zeros((n, 16), bool)
    punch = holes.any(1)
    c0 = np.where(punch, lo, hi)
    c1 = np.where(punch, hi, lo)

    def unpack(c):
        return np.stack([((c >> 11) & 31) << 3, ((c >> 5) & 63) << 2,
                         (c & 31) << 3], -1)

    p0, p1 = unpack(c0), unpack(c1)
    four = c0 > c1
    pal = np.stack([p0, p1,
                    np.where(four[:, None], (2 * p0 + p1) // 3,
                             (p0 + p1) // 2),
                    np.where(four[:, None], (2 * p1 + p0) // 3, 1 << 20)], 1)
    dist = ((px[:, :, None, :3] - pal[:, None]) ** 2).sum(-1)
    idx = np.where(holes, 3, dist.argmin(-1))
    lut = (idx << (2 * np.arange(16))).sum(1)
    colour = np.stack([c0 & 255, c0 >> 8, c1 & 255, c1 >> 8, lut & 255,
                       (lut >> 8) & 255, (lut >> 16) & 255, lut >> 24], 1)
    if kind == 1:
        return colour.astype(np.uint8).tobytes()
    a = px[..., 3]
    if kind == 3:
        nib = (a >> 4).reshape(n, 8, 2)
        alpha = nib[..., 0] | nib[..., 1] << 4
    else:
        a0, a1 = a.max(1), a.min(1)
        k = np.arange(8)
        ramp = np.where(k == 0, a0[:, None], np.where(
            k == 1, a1[:, None], ((8 - k) * a0[:, None]
                                  + (k - 1) * a1[:, None]) // 7))
        ai = np.abs(a[:, :, None] - ramp[:, None]).argmin(-1)
        ai = np.where((a0 == a1)[:, None], 0, ai)
        bits = (ai << (3 * np.arange(16))).sum(1)
        alpha = np.concatenate([a0[:, None], a1[:, None]] + [
            ((bits >> (8 * j)) & 255)[:, None] for j in range(6)], 1)
    return np.concatenate([alpha, colour], 1).astype(np.uint8).tobytes()


def blp_palette(colours: np.ndarray) -> bytes:
    """(k, 4) RGBA entries -> BLP's 256 BGRA palette entries (the rest
    zero)."""
    pal = np.zeros((256, 4), np.uint8)
    pal[:len(colours)] = np.asarray(colours, np.uint8)[:, [2, 1, 0, 3]]
    return pal.tobytes()


def write_blp2(w: int, h: int, payload: bytes, *, encoding: int = 2,
               alpha: int = 0, alpha_encoding: int = 0, compression: int = 1,
               palette: bytes = bytes(1024), offset: int | None = None,
               length: int | None = None) -> bytes:
    """A BLP2 file: the 20-byte header, the offset and length tables (the
    first mipmap ``payload``, at ``offset`` or right after the palette),
    the palette, then ``payload``."""
    head = b"BLP2" + struct.pack("<i3bBII", compression, encoding, alpha,
                                 alpha_encoding, 0, w, h)
    at = 20 + 128 + len(palette)
    tables = struct.pack("<16I", at if offset is None else offset,
                         *[0] * 15) + struct.pack(
        "<16I", len(payload) if length is None else length, *[0] * 15)
    return head + tables + palette + payload


def write_blp1(w: int, h: int, payload: bytes, *, compression: int = 1,
               alpha: int = 0, encoding: int = 5,
               palette: bytes = bytes(1024), jpeg_header: bytes = b"",
               offset: int | None = None, length: int | None = None) -> bytes:
    """A BLP1 file: the 28-byte header, the tables, then for compression 0
    the shared JPEG header (its length first) and ``payload`` (the rest of
    the JPEG), else the palette and ``payload`` (the indices)."""
    head = b"BLP1" + struct.pack("<iIIIii", compression, alpha, w, h,
                                 encoding, 0)
    if compression == 0:
        body = struct.pack("<I", len(jpeg_header)) + jpeg_header
        at = 28 + 128 + len(body)
    else:
        body = palette
        at = 28 + 128 + len(body)
    tables = struct.pack("<16I", at if offset is None else offset,
                         *[0] * 15) + struct.pack(
        "<16I", len(payload) if length is None else length, *[0] * 15)
    return head + tables + body + payload


def blp1_jpeg(jpeg: bytes, w: int, h: int, split: int = 0, **kw) -> bytes:
    """A BLP1 JPEG file of a whole JPEG stream, its first ``split`` bytes
    as the shared header."""
    return write_blp1(w, h, jpeg[split:], compression=0,
                      jpeg_header=jpeg[:split], **kw)


def icns_rle(channel: bytes) -> bytes:
    """One ICNS channel run-length coded: runs of 3-130 bytes as b + 125,
    the rest as literal strings of up to 128."""
    out, lit = bytearray(), bytearray()
    i, n = 0, len(channel)

    def flush():
        for k in range(0, len(lit), 128):
            out.append(len(lit[k:k + 128]) - 1)
            out.extend(lit[k:k + 128])
        lit.clear()

    while i < n:
        j = i
        while j < n and j - i < 130 and channel[j] == channel[i]:
            j += 1
        if j - i >= 3:
            flush()
            out += bytes([j - i + 125, channel[i]])
        else:
            lit.extend(channel[i:j])
        i = j
    flush()
    return bytes(out)


def write_icns(entries: list, filesize: int | None = None) -> bytes:
    """An ICNS file of [(type, data)] blocks."""
    body = b"".join(t + struct.pack(">I", len(d) + 8) + d for t, d in entries)
    return b"icns" + struct.pack(">I", len(body) + 8 if filesize is None
                                 else filesize) + body


def icns_rgb(rgb: np.ndarray, rle: bool = True, it32: bool = False) -> bytes:
    """An ``*32`` entry of (h, w, 3) pixels: raw interleaved, or each
    channel run-length coded one after another (``it32`` with its zero
    signature)."""
    data = b"".join(icns_rle(rgb[..., c].tobytes()) for c in range(3)) \
        if rle else rgb.tobytes()
    return (bytes(4) if it32 else b"") + data


def sun_rle(stream: np.ndarray) -> bytes:
    """A byte stream in Sun raster run-length code: runs of 3 or more (or
    of 0x80) as 0x80, count - 1, value, in pieces of at most 256; a lone
    0x80 as 0x80 0; other bytes as they are. Vectorised (the timing
    files are large)."""
    v = np.asarray(stream, np.uint8).reshape(-1)
    if not len(v):
        return b""
    starts = np.flatnonzero(np.r_[True, v[1:] != v[:-1]])
    lengths = np.diff(np.r_[starts, len(v)])
    pieces = -(-lengths // 256)
    first = np.repeat(starts, pieces) + 256 * (
        np.arange(pieces.sum()) - np.repeat(np.cumsum(pieces) - pieces,
                                            pieces))
    size = np.minimum(np.repeat(starts + lengths, pieces) - first, 256)
    value = v[first]
    run = (size >= 3) | ((value == 0x80) & (size == 2))
    escape = (value == 0x80) & (size == 1)
    nbytes = np.where(run, 3, np.where(escape, 2, size))
    at = np.cumsum(nbytes) - nbytes
    out = np.zeros(int(nbytes.sum()), np.uint8)
    out[at[run | escape]] = 0x80
    out[at[run] + 1] = size[run] - 1
    out[at[run] + 2] = value[run]
    lit = ~(run | escape)
    out[at[lit]] = value[lit]
    two = lit & (size == 2)
    out[at[two] + 1] = value[two]
    return out.tobytes()


def write_sun(w: int, h: int, depth: int, payload: bytes, *, ftype: int = 1,
              ptype: int = 0, palette: bytes = b"") -> bytes:
    """A Sun raster file: the 32-byte header, the colour map, ``payload``."""
    return struct.pack(">8I", 0x59A66A95, w, h, depth, len(payload), ftype,
                       ptype if palette or ptype else 0, len(palette)) \
        + palette + payload


def sun_rows(px: np.ndarray, depth: int, pad: bool = True) -> np.ndarray:
    """Pixels as Sun raster rows: (h, w) gray or indices at 1, 4 or 8 bits
    (1 bits set where black), (h, w, 3|4) bytes at 24 or 32, each row
    padded to 16 bits where ``pad``."""
    h = px.shape[0]
    if depth == 1:
        rows = np.packbits(px.astype(bool), axis=1)
    elif depth == 4:
        p = px.astype(np.uint8)
        if p.shape[1] % 2:
            p = np.pad(p, ((0, 0), (0, 1)))
        rows = (p[:, 0::2] << 4) | p[:, 1::2]
    else:
        rows = px.reshape(h, -1).astype(np.uint8)
    if pad and rows.shape[1] % 2:
        rows = np.pad(rows, ((0, 0), (0, 1)))
    return rows


def msp_lins_row(row: bytes) -> bytes:
    """One MSP version-2 row: runs of 3-255 as 0, count, value, the rest
    as literal strings of up to 255."""
    out, lit = bytearray(), bytearray()
    i, n = 0, len(row)

    def flush():
        for k in range(0, len(lit), 255):
            out.append(len(lit[k:k + 255]))
            out.extend(lit[k:k + 255])
        lit.clear()

    while i < n:
        j = i
        while j < n and j - i < 255 and row[j] == row[i]:
            j += 1
        if j - i >= 3:
            flush()
            out += bytes([0, j - i, row[i]])
        else:
            lit.extend(row[i:j])
        i = j
    flush()
    return bytes(out)


def msp_header(magic: bytes, w: int, h: int) -> bytes:
    """A 32-byte MSP header whose words XOR to 0 (the checksum word 12)."""
    words = [*struct.unpack("<2H", magic), w, h, 1, 1, 1, 1, w, h, 0, 0, 0,
             0, 0, 0]
    check = 0
    for word in words:
        check ^= word
    words[12] = check
    return struct.pack("<16H", *words)


def write_msp_lins(bits: np.ndarray, rows: list | None = None) -> bytes:
    """An MSP version-2 file of (h, w) 0/1 pixels (1 white): the row map
    and each row coded (or the coded ``rows`` given)."""
    h, w = bits.shape
    if rows is None:
        packed = np.packbits(bits.astype(bool), axis=1)
        rows = [msp_lins_row(r.tobytes()) for r in packed]
    return msp_header(b"LinS", w, h) + struct.pack(
        f"<{h}H", *[len(r) for r in rows]) + b"".join(rows)


def write_xbm(bits: np.ndarray, *, prefix: bytes = b"", hotspot=None,
              per_line: int = 12, fmt: str = "0x{:02x}") -> bytes:
    """An XBM of (h, w) 0/1 pixels (1 white, the first pixel in the lowest
    bit)."""
    h, w = bits.shape
    data = np.packbits(bits.astype(bool), axis=1, bitorder="little")
    out = prefix + f"#define im_width {w}\n#define im_height {h}\n".encode()
    if hotspot:
        out += (f"#define im_x_hot {hotspot[0]}\n#define im_y_hot "
                f"{hotspot[1]}\n").encode()
    vals = [fmt.format(b) for b in data.reshape(-1).tolist()]
    lines = [", ".join(vals[i:i + per_line])
             for i in range(0, len(vals), per_line)]
    return out + b"static unsigned char im_bits[] = {\n   " + \
        ",\n   ".join(lines).encode() + b" };\n"


XPM_CHARS = b".#abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789"


def write_xpm(idx: np.ndarray, colours: list, *, bpp: int = 1,
              keys: list | None = None, comment: bool = True,
              extra: bytes = b"") -> bytes:
    """An XPM of (h, w) indices into ``colours`` (each ``#rrggbb`` bytes or
    ``None``), keys of ``bpp`` characters (or the ``keys`` given)."""
    h, w = idx.shape
    if keys is None:
        keys = [bytes(XPM_CHARS[(i // len(XPM_CHARS) ** k) % len(XPM_CHARS)]
                      for k in range(bpp)) for i in range(len(colours))]
    lines = [b"/* XPM */", b"static char *image[] = {",
             b'"%d %d %d %d",' % (w, h, len(colours), bpp)]
    lines += [b'"%s c %s",' % (k, c) for k, c in zip(keys, colours)]
    if comment:
        lines.append(b"/* pixels */")
    table = np.array([np.frombuffer(k, np.uint8) for k in keys])
    for row in idx:
        lines.append(b'"' + table[row].tobytes() + b'",')
    return b"\n".join(lines) + b"\n};\n" + extra


def xpm_colours(rgb: np.ndarray) -> list:
    """(k, 3) uint8 -> [b"#rrggbb", ...]."""
    return [b"#%02x%02x%02x" % tuple(c) for c in rgb.tolist()]


def quantize(rgb: np.ndarray, levels: int = 4) -> tuple:
    """(h, w, 3) -> ((h, w) indices, (k, 3) colours): each channel on
    ``levels`` steps, the colours those present."""
    step = 255 // (levels - 1)
    q = (rgb.astype(np.int64) + step // 2) // step
    codes = (q[..., 0] * levels + q[..., 1]) * levels + q[..., 2]
    present, idx = np.unique(codes, return_inverse=True)
    colours = np.stack([present // (levels * levels), present // levels
                        % levels, present % levels], -1) * step
    return idx.reshape(rgb.shape[:2]), colours.astype(np.uint8)


LARGE_SUN = "rle24_4096x2048.ras"
LARGE_BLP = "dxt5_4096x2048.blp"


def large_sun(w: int = 4096, h: int = 2048) -> tuple[bytes, np.ndarray]:
    """An RLE 24-bit Sun raster (BGR, unpadded rows as Pillow reads them)
    of ``sample_image`` content with a flat band on the left (runs), and
    the (h, w, 3) RGB array it was made from."""
    img = sample_image(w, h, 62, 3)
    img[:, :w // 4] = img[:, :1]
    return write_sun(w, h, 24, sun_rle(img[..., ::-1]), ftype=2), img


def large_blp(w: int = 4096, h: int = 2048) -> bytes:
    """A DXT5 BLP2 (alpha flag set) of ``smooth_rgba`` content."""
    return write_blp2(w, h, dxt_blocks(smooth_rgba(w, h), 5), alpha=8,
                      alpha_encoding=7)


def legacy_fixtures() -> dict:
    """{file name: bytes} of the FTEX, BLP, ICNS, Sun raster, MSP, XBM and
    XPM files under ``tests/ldr``."""
    from PIL import Image

    rgba = sample_image(36, 20, 41)
    rgb = sample_image(40, 24, 42, 3)
    gray = sample_image(33, 17, 43, 1)[..., 0]
    pal = Image.fromarray(rgb).convert("P", palette=Image.Palette.ADAPTIVE,
                                       colors=40)
    out = {}
    # FTEX: BC1 (random blocks, both palettes) and raw RGB.
    out["bc1_random.ftc"] = write_ftex(17, 13, 0, random_blocks(20, 8, 44))
    out["rgb.ftu"] = write_ftex(13, 9, 1, sample_image(13, 9, 45, 3)
                                .tobytes(), where=40)
    # BLP: Pillow's palette writer, and DXT, JPEG and BLP1 palette files.
    rgba_pal = Image.fromarray(rgba).convert("P", palette=Image.Palette.ADAPTIVE,
                                              colors=32)
    rgba_pal.putpalette(np.concatenate([np.asarray(
        rgba_pal.getpalette()[:96], np.uint8).reshape(32, 3), np.arange(
        0, 256, 8, dtype=np.uint8)[:, None]], 1).reshape(-1).tolist(), "RGBA")
    out["pillow_p_rgba.blp"] = pillow_bytes(rgba_pal, "BLP")
    out["pillow_p_blp1.blp"] = pillow_bytes(pal, "BLP", blp_version="BLP1")
    out["dxt1_random.blp"] = write_blp2(16, 8, random_blocks(8, 8, 46))
    out["dxt1_alpha_random.blp"] = write_blp2(16, 8, random_blocks(8, 8, 47),
                                              alpha=1)
    out["dxt3.blp"] = write_blp2(36, 20, dxt_blocks(rgba, 3), alpha=4,
                                 alpha_encoding=1)
    out["dxt5_18x10_sheared.blp"] = write_blp2(
        18, 10, dxt_blocks(sample_image(20, 12, 48), 5), alpha=8,
        alpha_encoding=7)
    out["dxt5_no_alpha_flag.blp"] = write_blp2(
        16, 12, dxt_blocks(sample_image(16, 12, 49), 5), alpha_encoding=7)
    out["dxt3_random_offset.blp"] = write_blp2(
        8, 8, random_blocks(4, 16, 50), alpha_encoding=1, offset=1200,
        palette=bytes(1024) + bytes(28))
    jpeg = pillow_bytes(rgb, "JPEG", quality=90)
    out["jpeg_blp1.blp"] = blp1_jpeg(jpeg, 40, 24, split=300)
    cmyk = Image.fromarray(rgb).convert("CMYK")
    out["jpeg_cmyk_alpha_blp1.blp"] = blp1_jpeg(
        pillow_bytes(cmyk, "JPEG", quality=90), 40, 24, split=0, alpha=1)
    with open(os.path.join(os.path.dirname(LDR_DIR), "jpeg",
                           "emissive_ycck_420.jpg"), "rb") as f:
        ycck = f.read()
    out["jpeg_ycck_as_cmyk_blp1.blp"] = blp1_jpeg(ycck, *Image.open(
        io.BytesIO(ycck)).size, split=len(ycck) // 3)
    out["jpeg_gray_smaller_blp1.blp"] = blp1_jpeg(
        pillow_bytes(gray, "JPEG", quality=90), 30, 17, split=200)
    colours = np.concatenate([sample_image(64, 1, 51, 3)[0], np.arange(
        0, 256, 4, dtype=np.uint8)[:, None]], 1)
    out["palette_alpha_blp1.blp"] = write_blp1(
        21, 13, (sample_image(21, 13, 52, 1)[..., 0] >> 2).tobytes(),
        alpha=8, encoding=4, palette=blp_palette(colours))
    out["palette_blp2.blp"] = write_blp2(
        21, 13, (sample_image(21, 13, 53, 1)[..., 0] >> 2).tobytes(),
        encoding=1, palette=blp_palette(colours))
    # ICNS: RGB entries raw and run-length coded, masks, PNG entries.
    it = sample_image(128, 128, 54)
    out["it32_rle_t8mk.icns"] = write_icns([
        (b"it32", icns_rgb(it[..., :3], it32=True)),
        (b"t8mk", it[..., 3].tobytes()),
        (b"is32", icns_rgb(sample_image(16, 16, 55, 3)))])
    small = sample_image(16, 16, 56)
    out["is32_raw_s8mk.icns"] = write_icns([
        (b"is32", icns_rgb(small[..., :3], rle=False)),
        (b"s8mk", small[..., 3].tobytes())])
    out["ih32_rle_no_mask.icns"] = write_icns([
        (b"ih32", icns_rgb(sample_image(48, 48, 57, 3)))])
    p16 = Image.fromarray(small[..., :3]).convert(
        "P", palette=Image.Palette.ADAPTIVE, colors=8)
    out["png_trns_ignored.icns"] = write_icns([
        (b"icp4", pillow_bytes(p16, "PNG", transparency=0)),
        (b"is32", icns_rgb(small[..., :3]))])
    out["png_half_size_ic08.icns"] = write_icns([
        (b"ic08", pillow_bytes(sample_image(32, 32, 58), "PNG")),
        (b"il32", icns_rgb(sample_image(32, 32, 59, 3)))])
    # Sun raster: every depth, raw and RLE, type 3, palettes, padded RLE.
    odd = sample_image(13, 9, 60, 3)
    out["bgr24_raw_odd.ras"] = write_sun(13, 9, 24, sun_rows(
        odd[..., ::-1], 24).tobytes())
    out["bgr24_rle.ras"] = write_sun(40, 24, 24, sun_rle(rgb[..., ::-1]),
                                     ftype=2)
    out["bgr24_rle_padded_sheared.ras"] = write_sun(
        13, 9, 24, sun_rle(sun_rows(odd[..., ::-1], 24)), ftype=2)
    out["bgrx32.ras"] = write_sun(11, 7, 32, sample_image(11, 7, 61)
                                  .tobytes())
    out["rgbx32_type3.ras"] = write_sun(11, 7, 32, sample_image(11, 7, 62)
                                        .tobytes(), ftype=3)
    out["gray8_palette_rle.ras"] = write_sun(
        33, 17, 8, sun_rle(gray), ftype=2, palette=np.ascontiguousarray(
            sample_image(200, 1, 63, 3)[0].T).tobytes(), ptype=1)
    out["gray4_odd.ras"] = write_sun(13, 9, 4, sun_rows(
        sample_image(13, 9, 64, 1)[..., 0] >> 4, 4).tobytes())
    out["mono1_rle.ras"] = write_sun(33, 17, 1, sun_rle(sun_rows(
        gray > 120, 1, pad=False)), ftype=2)
    # MSP: Pillow's version-1 writer and version-2 rows.
    bits = (gray > 110).astype(np.uint8)
    out["pillow_danm.msp"] = pillow_bytes(
        Image.fromarray(gray).convert("1"), "MSP")
    out["lins.msp"] = write_msp_lins(bits)
    rows = [msp_lins_row(r.tobytes()) for r in np.packbits(bits, axis=1)]
    rows[3] = b""  # a blank (white) row
    rows[6] = rows[6] + b"\x02\xaa\x55"  # two bytes too many: a shift
    out["lins_blank_and_shifted.msp"] = write_msp_lins(bits, rows)
    # XBM: Pillow's writer and a hand-written header.
    out["pillow.xbm"] = pillow_bytes(Image.fromarray(gray).convert("1"),
                                     "XBM")
    out["hotspot_leading_space.xbm"] = write_xbm(
        bits[:, :30], prefix=b"  \n", hotspot=(3, 4), per_line=7,
        fmt="0x{:X}")
    # XPM: palette with None, more than 256 colours, two-byte keys.
    idx, cols = quantize(rgb)
    out["palette.xpm"] = write_xpm(idx, xpm_colours(cols))
    idx2 = idx.copy()
    idx2[:, 0] = len(cols)
    none_first = [b"None"] + xpm_colours(cols)
    out["none_key_space_alpha.xpm"] = write_xpm(
        idx2[:, 1:] + 1, none_first, keys=[b" "] + [
            bytes([c]) for c in XPM_CHARS[:len(cols)]], comment=False)
    cube = np.stack(np.meshgrid(*[np.arange(7)] * 3, indexing="ij"),
                    -1).reshape(-1, 3)
    q = (sample_image(30, 20, 65, 3).astype(np.int64) + 21) // 42
    out["rgb_343_colours.xpm"] = write_xpm(
        (q[..., 0] * 7 + q[..., 1]) * 7 + q[..., 2],
        xpm_colours((cube * 42).astype(np.uint8)), bpp=2)
    return out


def env_sun_rle(w: int, h: int, seed: int) -> bytes:
    """An RLE 24-bit Sun raster map of ``sample_image``."""
    return write_sun(w, h, 24, sun_rle(sample_image(w, h, seed, 3)[..., ::-1]),
                     ftype=2)


def env_blp_dxt1(w: int, h: int, seed: int) -> bytes:
    """A DXT1 BLP2 map of ``sample_image`` (w and h multiples of 4)."""
    return write_blp2(w, h, dxt_blocks(sample_image(w, h, seed), 1))


def write_fixtures(directory: str = LDR_DIR) -> None:
    """Write ``tests/ldr``: the files, Pillow's decode of each in
    ``pillow_rgba.npz`` and its SHA-256 in ``pillow_sha256.json``."""
    os.makedirs(directory, exist_ok=True)
    files = fixtures()
    files["env_rle32.tga"] = env_tga(64, 32, 21)
    files["env_rgb16.tif"] = env_tiff16(64, 32, 22)
    files["env_lossy.webp"] = env_webp(64, 32, 23)
    files["env.gif"] = env_gif(64, 32, 24)
    files["env_jpeg_ycbcr.tif"] = env_tiff_jpeg(64, 32, 25)
    files["env_float.tif"] = env_tiff_float(64, 32, 26)
    files["env_bc1.dds"] = env_dds_bc1(64, 32, 27)
    files["env_rle.sgi"] = env_sgi_rle(64, 32, 28)
    files["env.qoi"] = env_qoi(64, 32, 29)
    files["env_rle.ras"] = env_sun_rle(64, 32, 30)
    files["env_dxt1.blp"] = env_blp_dxt1(64, 32, 31)
    files["env_float.fits"] = env_fits(64, 32, 32)
    files["env.spi"] = env_spider(64, 32, 33)
    files["env.jp2"] = env_jp2(64, 32, 34)
    files["env_rpcl.j2k"] = env_j2k_rpcl(64, 32, 35)
    files["env_zstd.tif"] = env_tiff_zstd(64, 32, 36)
    files["env_ojpeg.tif"] = env_tiff_ojpeg(64, 32, 37)
    decoded = {}
    for name, data in files.items():
        with open(os.path.join(directory, name), "wb") as f:
            f.write(data)
        decoded[name] = pillow_rgba(data)
    np.savez_compressed(os.path.join(directory, "pillow_rgba.npz"), **decoded)
    digests = {n: hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()
               for n, a in sorted(decoded.items())}
    for name, make in ((LARGE_WEBP, lambda: large_webp(4096, 2048)),
                       (MEDIUM_WEBP, lambda: large_webp(1024, 512)),
                       (LARGE_TIFF_JPEG, large_tiff_jpeg),
                       (LARGE_J2K_IRR, lambda: j2k_timing_file(4096, 2048,
                                                               True)),
                       (LARGE_J2K_REV, lambda: j2k_timing_file(4096, 2048,
                                                               False)),
                       (MEDIUM_J2K_IRR, lambda: j2k_timing_file(512, 256,
                                                                True)),
                       (MEDIUM_J2K_REV, lambda: j2k_timing_file(512, 256,
                                                                False)),
                       (LARGE_TIFF_ZSTD, lambda: tiff_timing_file(
                           "zstd", 4096, 2048)),
                       (LARGE_TIFF_OJPEG, lambda: tiff_timing_file(
                           "ojpeg", 4096, 2048)),
                       (MEDIUM_TIFF_ZSTD, lambda: tiff_timing_file(
                           "zstd", 512, 256)),
                       (MEDIUM_TIFF_OJPEG, lambda: tiff_timing_file(
                           "ojpeg", 512, 256))):
        data = make()
        with open(os.path.join(directory, name), "wb") as f:
            f.write(data)
        digests[name] = hashlib.sha256(pillow_rgba(data).tobytes()).hexdigest()
    # Made where they are used (8 MiB), only their decodes' digests kept.
    digests[LARGE_BC7] = hashlib.sha256(pillow_rgba(
        large_bc7()).tobytes()).hexdigest()
    digests[LARGE_SUN] = hashlib.sha256(pillow_rgba(
        large_sun()[0]).tobytes()).hexdigest()
    digests[LARGE_BLP] = hashlib.sha256(pillow_rgba(
        large_blp()).tobytes()).hexdigest()
    digests[LARGE_FLI] = hashlib.sha256(pillow_rgba(
        large_fli()).tobytes()).hexdigest()
    digests[LARGE_IM_BITS] = hashlib.sha256(pillow_rgba(
        large_im_bits()).tobytes()).hexdigest()
    for k, name in enumerate(PCD_FILES):
        digests[name] = hashlib.sha256(pillow_rgba(
            photo_cd(k)).tobytes()).hexdigest()
    with open(os.path.join(directory, "pillow_sha256.json"), "w") as f:
        json.dump(digests, f, indent=1)



# --- IM, SPIDER, FITS, McIdas, GBR, XV thumbnails, PIXAR, IMT, IPTC, PCD, FLI


def write_im(itype: bytes, w: int, h: int, data: bytes, *, lut: bytes = None,
             extra: bytes = b"", size: bytes | None = None,
             newline: bytes = b"\r\n", pad: bool = True) -> bytes:
    """An IM file: "Image type", "Image size" (or ``size`` as written),
    ``extra`` header lines and a "Lut" line with ``lut``'s 768 bytes,
    the header padded with NULs to 511 bytes and ended by ^Z (or, without
    ``pad``, ^Z right after it), then ``data`` (rows bottom-up, as IM
    stores them)."""
    head = b"Image type: " + itype + newline
    head += b"Image size (x*y): " + (size or b"%d*%d" % (w, h)) + newline
    head += extra
    if lut is not None:
        head += b"Lut: 1" + newline
    head = head + b"\0" * (511 - len(head)) if pad else head
    return head + b"\x1a" + (lut or b"") + data


def write_spider(values: np.ndarray, big: bool = True, stack: int = 0
                 ) -> bytes:
    """A SPIDER 2D image of float32 ``values`` (h, w): the header Pillow's
    writer makes (records of 4 w bytes up to 1,024), in either byte order;
    with ``stack`` images a stack file (its header, then each image after
    a header of its own)."""
    h, w = values.shape
    lenbyt = 4 * w
    labrec = -(-1024 // lenbyt)
    labbyt = labrec * lenbyt
    order = ">" if big else "<"

    def header(istack: int, imgnum: int, maxim: int) -> bytes:
        hd = [0.0] * (labbyt // 4)
        hd[0:12] = [1, h, h, 0, 1, 0, 0, 0, 0, 0, 0, w]  # nslice..nsam
        hd[12] = labrec
        hd[21] = labbyt
        hd[22] = lenbyt
        hd[23] = istack
        hd[25] = maxim
        hd[26] = imgnum
        return struct.pack(f"{order}{len(hd)}f", *hd)

    body = values.astype(order + "f4").tobytes()
    if not stack:
        return header(0, 0, 0) + body
    out = header(2, 0, stack)
    for k in range(stack):
        out += header(0, k + 1, 0) + body
    return out


def fits_cards(cards: list) -> bytes:
    """80-byte FITS header cards ``(keyword, value)`` then END, padded
    with spaces to a 2,880-byte block."""
    text = b"".join(b"%-8s= %20s" % (k, v) + b" " * 50 for k, v in cards)
    text += b"END" + b" " * 77
    return text + b" " * (-len(text) % 2880)


def write_fits(values: np.ndarray, bitpix: int, *, gzip_tile: bool = False,
               extra: list = ()) -> bytes:
    """A FITS file of ``values`` (h, w): the primary image big-endian,
    bottom row first (FITS's order), or (``gzip_tile``) a primary header
    of no image and a ``ZIMAGE`` BINTABLE whose heap is one gzip member of
    4 bytes a pixel, ending the file."""
    import gzip

    h, w = values.shape
    dt = {8: ">u1", 16: ">i2", 32: ">i4", -32: ">f4", -64: ">f8"}[bitpix]
    rows = np.ascontiguousarray(values[::-1]).astype(dt)
    if not gzip_tile:
        data = rows.tobytes()
        return (fits_cards([(b"SIMPLE", b"T"), (b"BITPIX", b"%d" % bitpix),
                            (b"NAXIS", b"2"), (b"NAXIS1", b"%d" % w),
                            (b"NAXIS2", b"%d" % h), *extra])
                + data + b"\0" * (-len(data) % 2880))
    cells = np.zeros((h, w, 4), np.uint8)
    raw = rows.view(np.uint8).reshape(h, w, -1)
    cells[..., 4 - min(raw.shape[2], 4):] = raw[..., :4]
    heap = gzip.compress(cells[::-1].tobytes(), mtime=0)
    table = b"\0" * 8
    return (fits_cards([(b"SIMPLE", b"T"), (b"BITPIX", b"8"),
                        (b"NAXIS", b"0"), (b"EXTEND", b"T")])
            + fits_cards([(b"XTENSION", b"'BINTABLE'"), (b"BITPIX", b"8"),
                          (b"NAXIS", b"2"), (b"NAXIS1", b"8"),
                          (b"NAXIS2", b"1"), (b"ZIMAGE", b"T"),
                          (b"ZCMPTYPE", b"'GZIP_1  '"),
                          (b"ZBITPIX", b"%d" % bitpix), (b"ZNAXIS", b"2"),
                          (b"ZNAXIS1", b"%d" % w), (b"ZNAXIS2", b"%d" % h),
                          *extra])
            + table + heap)


def write_mcidas(values: np.ndarray, unit: int, prefix: int = 0,
                 bands: int = 1, data_at: int = 256) -> bytes:
    """A McIdas area file of ``values`` (h, w) at ``unit`` bytes a sample
    (1, 2 or 4, big-endian), each row led by ``prefix`` bytes, rows
    ``bands`` samples wide apart (word 14), the data at ``data_at``."""
    h, w = values.shape
    words = [0] * 64
    words[1] = 4  # the signature's second word
    words[8], words[9], words[10], words[13] = h, w, unit, bands
    words[14], words[33] = prefix, data_at
    head = b"\0\0\0\0" + struct.pack(">64i", *words)[4:]
    head = head[:256]
    dt = {1: ">u1", 2: ">u2", 4: ">i4"}[unit]
    stride = prefix + w * unit * bands
    body = bytearray(b"\x5a" * (data_at - 256 + h * stride))
    for r in range(h):
        at = data_at - 256 + r * stride + prefix
        body[at:at + w * unit] = values[r].astype(dt).tobytes()
    return head + bytes(body)


def write_gbr(pixels: np.ndarray, version: int = 2, comment: bytes = b"brush"
              ) -> bytes:
    """A GIMP brush of (h, w) gray or (h, w, 4) RGBA ``pixels``."""
    h, w = pixels.shape[:2]
    depth = 1 if pixels.ndim == 2 else 4
    comment += b"\0"
    size = (20 if version == 1 else 28) + len(comment)
    head = struct.pack(">5I", size, version, w, h, depth)
    if version == 2:
        head += b"GIMP" + struct.pack(">I", 10)
    return head + comment + np.ascontiguousarray(pixels, np.uint8).tobytes()


def write_xvthumb(idx: np.ndarray, comments: tuple = (b"#XVVERSION:1",)
                  ) -> bytes:
    """An XV thumbnail of 3-3-2 palette indices (h, w)."""
    h, w = idx.shape
    return (b"P7 332\n" + b"".join(c + b"\n" for c in comments)
            + b"%d %d 255\n" % (w, h) + np.ascontiguousarray(
                idx, np.uint8).tobytes())


def write_pixar(rgb: np.ndarray, mode: tuple = (14, 2)) -> bytes:
    """A PIXAR raster of (h, w, 3) ``rgb`` at byte 1,024."""
    h, w = rgb.shape[:2]
    head = bytearray(1024)
    head[:4] = b"\200\350\000\000"
    struct.pack_into("<2H", head, 416, h, w)
    struct.pack_into("<2H", head, 424, *mode)
    return bytes(head) + np.ascontiguousarray(rgb, np.uint8).tobytes()


def write_imt(gray: np.ndarray, lines: tuple = ()) -> bytes:
    """An IM Tools file of (h, w) ``gray``: ``lines`` first (comments,
    other fields), then the size and "pixel n8", a form feed and the
    rows."""
    h, w = gray.shape
    head = b"".join(line + b"\n" for line in lines)
    head += b"width %d\nheight %d\npixel n8\n" % (w, h)
    return head + b"\x0c" + np.ascontiguousarray(gray, np.uint8).tobytes()


def iptc_field(record: int, dataset: int, data: bytes,
               extended: int = 0) -> bytes:
    """One IPTC field: a 15-bit size, or (``extended`` bytes) a size in
    the bytes after the header."""
    if extended:
        return bytes([0x1C, record, dataset, 0x80 | extended]) + len(
            data).to_bytes(extended, "big") + data
    return bytes([0x1C, record, dataset]) + struct.pack(">H", len(data)) + data


def write_iptc(image: bytes, w: int, h: int, *, layers: int = 1,
               component: int = 0, compression: int = 1,
               band: int | None = None, split: int = 0,
               extra: bytes = b"", extended: int = 0) -> bytes:
    """An IPTC/NAA file: the (3, 60), (3, 20), (3, 30), (3, 120) and
    optional (3, 65) fields, ``extra`` fields, then ``image`` (raw rows
    or a JPEG) in one image-data field (8, 10) or split in two at
    ``split``, the second with a size of ``extended`` bytes after its
    header where given (Pillow reads such a size one byte late)."""
    out = iptc_field(1, 90, b"\x1b%G") + iptc_field(3, 60, bytes(
        [layers, component])) + iptc_field(3, 20, struct.pack(">I", w))
    out += iptc_field(3, 30, struct.pack(">H", h))
    out += iptc_field(3, 120, bytes([compression])) + extra
    if band is not None:
        out += iptc_field(3, 65, bytes([band]))
    parts = [image[:split], image[split:]] if split else [image]
    for k, part in enumerate(parts):
        out += iptc_field(8, 10, part, extended=extended if k else 0)
    return out


def write_pcd(y: np.ndarray, cb: np.ndarray, cr: np.ndarray,
              orientation: int = 0) -> bytes:
    """A Photo CD base image: ``y`` (512, 768) lumas, ``cb`` and ``cr``
    (256, 384) chroma; the orientation byte's low bits rotate it."""
    head = bytearray(96 * 2048)
    head[2048:2055] = b"PCD_IPI"
    head[2048 + 1538] = orientation
    yy = np.asarray(y, np.uint8).reshape(256, 2 * 768)
    body = np.concatenate([yy, np.asarray(cb, np.uint8),
                           np.asarray(cr, np.uint8)], 1)
    return bytes(head) + body.tobytes()


def fli_chunk(kind: int, payload: bytes) -> bytes:
    return struct.pack("<IH", 6 + len(payload), kind) + payload


def fli_colors(palette: np.ndarray, kind: int = 4, skip: int = 0) -> bytes:
    """A COLOR_256 (4) or COLOR_64 (11, values >> 2) chunk of one packet."""
    pal = np.asarray(palette, np.uint8)
    if kind == 11:
        pal = pal >> 2
    n = len(pal)
    return fli_chunk(kind, struct.pack("<H", 1) + bytes([skip, n % 256])
                     + pal.tobytes())


def fli_brun(idx: np.ndarray) -> bytes:
    """A BRUN chunk: each row a packet count, then runs (a count and a
    byte) where a byte repeats and literal packets (a negative count)
    elsewhere, at most 127 a packet."""
    out = bytearray()
    for row in np.asarray(idx, np.uint8):
        packets = bytearray()
        npk = 0
        x, w = 0, len(row)
        while x < w:
            run = 1
            while x + run < w and run < 127 and row[x + run] == row[x]:
                run += 1
            if run >= 3 or x + run == w:
                packets += bytes([run, row[x]])
                x += run
            else:
                lit = 1
                while x + lit < w and lit < 127 and not (
                        x + lit + 2 < w and row[x + lit] == row[x + lit + 1]
                        == row[x + lit + 2]):
                    lit += 1
                packets += bytes([256 - lit]) + row[x:x + lit].tobytes()
                x += lit
            npk += 1
        out += bytes([npk & 255]) + packets
    return fli_chunk(15, bytes(out))


def fli_lc(idx: np.ndarray, before: np.ndarray, first: int = 0) -> bytes:
    """An LC chunk from ``before`` to ``idx`` (rows ``first`` on): each row
    a packet count, then packets of a skip and literal bytes (or a run,
    a negative count, where a changed stretch repeats one byte)."""
    idx, before = np.asarray(idx, np.uint8), np.asarray(before, np.uint8)
    rows = bytearray()
    for y in range(first, idx.shape[0]):
        changed = np.flatnonzero(idx[y] != before[y])
        packets, n, x = bytearray(), 0, 0
        k = 0
        while k < len(changed):
            start = int(changed[k])
            end = start + 1
            while end < idx.shape[1] and end - start < 100 and (
                    idx[y, end] != before[y, end] or end + 1 < idx.shape[1]
                    and idx[y, end + 1] != before[y, end + 1]):
                end += 1
            skip = start - x
            while skip > 255:
                packets += bytes([255, 0])
                n += 1
                skip -= 255
            seg = idx[y, start:end]
            if len(seg) >= 3 and (seg == seg[0]).all():
                packets += bytes([skip, 256 - len(seg), seg[0]])
            else:
                packets += bytes([skip, len(seg)]) + seg.tobytes()
            n += 1
            x = end
            while k < len(changed) and changed[k] < end:
                k += 1
        rows += bytes([n]) + packets
    return fli_chunk(12, struct.pack("<2H", first, idx.shape[0] - first)
                     + bytes(rows))


def fli_ss2(idx: np.ndarray, before: np.ndarray, skip_lines: bool = True
            ) -> bytes:
    """An SS2 chunk from ``before`` to ``idx`` (an even width): unchanged
    lines skipped with a flag word, each changed line's pairs as literal
    packets (or a run of one pair)."""
    idx, before = np.asarray(idx, np.uint8), np.asarray(before, np.uint8)
    h, w = idx.shape
    out, lines, pending = bytearray(), 0, 0
    for y in range(h):
        pairs = idx[y].reshape(-1, 2)
        diff = (idx[y] != before[y]).reshape(-1, 2).any(1)
        if skip_lines and not diff.any():
            pending += 1
            continue
        words = bytearray()
        if pending:
            words += struct.pack("<H", 65536 - pending)
            pending = 0
        packets, n, x = bytearray(), 0, 0
        k = 0
        changed = np.flatnonzero(diff)
        while k < len(changed):
            start = int(changed[k])
            end = start + 1
            while end < len(pairs) and diff[end] and end - start < 100:
                end += 1
            seg = pairs[start:end]
            if len(seg) >= 2 and (seg == seg[0]).all():
                packets += bytes([2 * (start - x), 256 - len(seg)]) + seg[
                    0].tobytes()
            else:
                packets += bytes([2 * (start - x), len(seg)]) + seg.tobytes()
            n += 1
            x = end
            k = int(np.searchsorted(changed, end))
        out += words + struct.pack("<H", n) + packets
        lines += 1
    return fli_chunk(7, struct.pack("<H", lines) + bytes(out))


def write_fli(w: int, h: int, chunks: list, *, magic: int = 0xAF12,
              frames: int = 1, later: list = ()) -> bytes:
    """An FLI (0xAF11) or FLC (0xAF12) file: the 128-byte header, the
    first frame's ``chunks`` and ``later`` frames' chunk lists."""
    head = bytearray(128)
    struct.pack_into("<IHHHHHH", head, 0, 0, magic, frames, w, h, 8, 0)
    struct.pack_into("<I", head, 16, 5)

    def frame(cs: list) -> bytes:
        body = b"".join(cs)
        return struct.pack("<IHH", 16 + len(body), 0xF1FA, len(cs)) + bytes(
            8) + body

    body = frame(chunks) + b"".join(frame(cs) for cs in later)
    struct.pack_into("<I", head, 0, 128 + len(body))
    return bytes(head) + body


def fli_brun_rows(idx: np.ndarray, run: int = 32) -> bytes:
    """A BRUN chunk in NumPy for large frames: each row cut into pieces of
    ``run`` pixels (the width a multiple of it), a piece of one value a
    run packet, any other a literal packet."""
    idx = np.asarray(idx, np.uint8)
    h, w = idx.shape
    pieces = idx.reshape(h, w // run, run)
    flat = (pieces == pieces[..., :1]).all(-1)
    lit = np.concatenate([np.full((h, w // run, 1), 256 - run, np.uint8),
                          pieces], -1)
    rle = np.zeros((h, w // run, run + 1), np.uint8)
    rle[..., 0] = run
    rle[..., 1] = pieces[..., 0]
    keep = np.where(flat[..., None], np.arange(run + 1) < 2, True)
    packets = np.where(flat[..., None], rle, lit)
    rows = [bytes([(w // run) & 255]) + packets[y][keep[y]].tobytes()
            for y in range(h)]
    return fli_chunk(15, b"".join(rows))


LARGE_FLI = "brun_4096x2048.flc"
LARGE_IM_BITS = "f12_bits_4096x2048.im"
PCD_FILES = ("photo_cd_landscape.pcd", "photo_cd_rotated.pcd")


def large_fli(w: int = 4096, h: int = 2048) -> bytes:
    """An FLC frame of a COLOR_256 palette and a BRUN chunk over
    ``sample_image`` indices, flat on the left quarter (run packets)."""
    idx = sample_image(w, h, 66, 1)[..., 0]
    idx[:, :w // 4] = idx[:, :1]
    return write_fli(w, h, [fli_colors(sample_image(256, 1, 67, 3)[0]),
                            fli_brun_rows(idx)])


def large_im_bits(w: int = 4096, h: int = 2048) -> bytes:
    """An IM "L*12" image (Pillow's bit decoder) of seeded bytes."""
    data = np.random.default_rng(68).integers(
        0, 256, (w * 12 + 7) // 8 * h, dtype=np.uint8).tobytes()
    return write_im(b"L*12 image", w, h, data)


def photo_cd(orientation: int) -> bytes:
    """A Photo CD base image of ``sample_image`` content as PhotoYCC."""
    y = sample_image(768, 512, 69, 1)[..., 0]
    c = sample_image(384, 256, 70, 2)
    return write_pcd(y, c[..., 0], c[..., 1], orientation)


def sci_rare_fixtures() -> dict:
    """{file name: bytes} of the IM, SPIDER, FITS, McIdas, GBR, XV
    thumbnail, PIXAR, IMT, IPTC and FLI files under ``tests/ldr``."""
    from PIL import Image

    rgba = sample_image(23, 13, 71)
    rgb = rgba[..., :3]
    gray = sample_image(21, 11, 72, 1)[..., 0]
    field = (gray.astype(np.float32) - 40.0) * 1.37
    out = {}
    # IM: Pillow's writer in each mode it writes, and hand-made headers.
    pal = Image.fromarray(rgb).convert("P", palette=Image.Palette.ADAPTIVE,
                                       colors=24)
    ims = {"L": Image.fromarray(gray), "P": pal, "RGB": Image.fromarray(rgb),
           "RGBA": Image.fromarray(rgba), "1": Image.fromarray(gray > 100),
           "LA": Image.fromarray(rgba).convert("LA"),
           "CMYK": Image.fromarray(rgb).convert("CMYK"),
           "YCbCr": Image.fromarray(rgb).convert("YCbCr"),
           "I": Image.fromarray(gray.astype(np.int32) * 3 - 50),
           "F": Image.fromarray(field),
           "I;16": Image.frombytes("I;16", gray.shape[::-1],
                                   (gray.astype("<u2") * 2).tobytes())}
    for mode, img in ims.items():
        out[f"pillow_{mode.replace(';', '')}.im"] = pillow_bytes(img, "IM")
    lut = np.stack([np.arange(256), (np.arange(256) * 7) % 256,
                    255 - np.arange(256)]).astype(np.uint8).tobytes()
    out["b4_colour_lut.im"] = write_im(b"B4 image", 21, 11, (gray >> 4)
                                       .tobytes(), lut=lut)
    out["grey_lut_kept.im"] = write_im(b"Greyscale image", 21, 11,
                                       gray[::-1].tobytes(),
                                       lut=bytes(255 - np.arange(256)
                                                 .astype(np.uint8)) * 3)
    out["f12_bits.im"] = write_im(b"L*12 image", 21, 11, sample_image(
        32, 11, 73, 1)[..., 0].tobytes())
    out["f16s.im"] = write_im(b"L 16S image", 21, 11, (gray.astype("<i2")
                                                       * 3 - 200).tobytes())
    out["rgb3_planes.im"] = write_im(b"RGB3 image", 21, 11, np.concatenate(
        [sample_image(21, 11, 74 + k, 1)[..., 0].reshape(-1)
         for k in range(3)]).tobytes())
    out["two_frames.im"] = write_im(b"Greyscale image", 21, 11,
                                    gray.tobytes() * 2, extra=b"File size "
                                    b"(no of images): 2\r\n")
    # SPIDER: Pillow's writer, big-endian, a little-endian stack.
    out["pillow.spi"] = pillow_bytes(Image.fromarray(field), "SPIDER")
    out["big_endian.spi"] = write_spider(field * 2.3, True)
    out["stack_little.spi"] = write_spider(field - 30, False, stack=2)
    # FITS: every BITPIX, raw and GZIP_1.
    for bits, v in ((8, gray), (16, gray.astype(np.int32) * 301 - 9000),
                    (32, gray.astype(np.int32) * 700 - 20000),
                    (-32, field), (-64, field * 0.5)):
        out[f"bitpix{bits}.fits"] = write_fits(v, bits)
    out["gzip_bitpix16.fits"] = write_fits(gray.astype(np.int32) * 3, 16,
                                           gzip_tile=True)
    out["gzip_bitpix8.fits"] = write_fits(gray, 8, gzip_tile=True)
    # McIdas: 1, 2 and 4 bytes a sample, row prefixes and bands.
    out["mcidas8.area"] = write_mcidas(gray, 1)
    out["mcidas16_prefix.area"] = write_mcidas(gray.astype(np.int64) * 290,
                                               2, prefix=4, data_at=300)
    out["mcidas32_bands.area"] = write_mcidas(
        gray.astype(np.int64) * 1000 - 70000, 4, bands=2)
    # GIMP brushes, XV thumbnails, PIXAR, IM Tools.
    out["v1_gray.gbr"] = write_gbr(gray, 1)
    out["v2_rgba.gbr"] = write_gbr(rgba, 2, comment=b"a brush")
    out["thumb.xv"] = write_xvthumb(sample_image(21, 11, 77, 1)[..., 0],
                                    comments=(b"#XVVERSION:3.10a",
                                              b"#IMGINFO:x"))
    out["rgb.pxr"] = write_pixar(rgb)
    out["gray.imt"] = write_imt(gray, lines=(b"* made for the tests",))
    # IPTC: raw one layer, bands of RGB and CMYK, a JPEG, a split field.
    out["raw_l.iim"] = write_iptc(gray.tobytes(), 21, 11)
    out["raw_rgb_band2.iim"] = write_iptc(gray.tobytes(), 21, 11, layers=3,
                                          component=1, band=2, split=90)
    out["raw_cmyk_last_band.iim"] = write_iptc(gray.tobytes(), 21, 11,
                                               layers=4, component=1,
                                               band=0)
    out["jpeg_l.iim"] = write_iptc(pillow_bytes(gray, "JPEG", quality=90),
                                   21, 11, compression=5)
    # FLI/FLC: BRUN under each palette chunk, LC and SS2 deltas, COPY,
    # BLACK.
    idx = sample_image(24, 13, 78, 1)[..., 0]
    later = idx.copy()
    later[3:7, 5:17] = 9
    later[10] = 250
    colours = sample_image(256, 1, 79, 3)[0]
    out["brun_colour64.fli"] = write_fli(24, 13, [
        fli_colors(colours, 11), fli_brun(idx)], magic=0xAF11)
    out["brun_lc.flc"] = write_fli(24, 13, [
        fli_colors(colours), fli_brun(idx), fli_lc(later, idx, 2)],
        frames=2, later=[[fli_chunk(13, b"")]])
    out["brun_ss2.flc"] = write_fli(24, 13, [
        fli_colors(colours[:128], skip=5), fli_brun(idx),
        fli_ss2(later, idx)])
    out["copy_stamp.flc"] = write_fli(24, 13, [
        fli_chunk(18, bytes(12)), fli_chunk(16, idx.tobytes())])
    # (a last chunk under 10 bytes is refused: BLACK carries 4 spare bytes)
    out["brun_black_gray.flc"] = write_fli(24, 13, [fli_brun(idx),
                                                    fli_chunk(13, bytes(4))])
    return out


def env_fits(w: int, h: int, seed: int) -> bytes:
    """A 32-bit float FITS map of ``sample_image`` gray."""
    g = sample_image(w, h, seed, 1)[..., 0].astype(np.float32)
    return write_fits(g * 1.1 - 10, -32)


def env_spider(w: int, h: int, seed: int) -> bytes:
    """A little-endian SPIDER map of ``sample_image`` gray."""
    g = sample_image(w, h, seed, 1)[..., 0].astype(np.float32)
    return write_spider(g * 0.9 + 20, False)


if __name__ == "__main__":
    write_fixtures()


# --- JPEG 2000 -------------------------------------------------------------------

# The timing files (committed: no encoder on the card's host): 4096x2048
# maps of smooth_rgba's RGB, irreversible at 60:1 in one layer and
# reversible, and the same pair at the plain decoder's size.
LARGE_J2K_IRR = "large_irreversible_4096x2048.jp2"
LARGE_J2K_REV = "large_reversible_4096x2048.j2k"
MEDIUM_J2K_IRR = "medium_irreversible_512x256.jp2"
MEDIUM_J2K_REV = "medium_reversible_512x256.j2k"


def j2k_timing_file(w: int, h: int, irreversible: bool) -> bytes:
    """A JPEG 2000 map of ``smooth_rgba``'s RGB written by Pillow: a JP2
    at 60:1 irreversible, or a reversible J2K codestream."""
    rgb = smooth_rgba(w, h)[..., :3]
    if irreversible:
        return pillow_bytes(rgb, "JPEG2000", irreversible=True,
                            quality_mode="rates", quality_layers=[60])
    return pillow_bytes(rgb, "JPEG2000", no_jp2=True)


def env_jp2(w: int, h: int, seed: int) -> bytes:
    """An irreversible JP2 map of ``sample_image`` (3 layers)."""
    return pillow_bytes(sample_image(w, h, seed, 3), "JPEG2000",
                        irreversible=True, quality_mode="rates",
                        quality_layers=[20, 8, 2])


def env_j2k_rpcl(w: int, h: int, seed: int) -> bytes:
    """A reversible J2K map of ``sample_image`` in RPCL order, 32 x 32
    precincts, two layers."""
    return pillow_bytes(sample_image(w, h, seed, 3), "JPEG2000", no_jp2=True,
                        progression="RPCL", precinct_size=(32, 32),
                        num_resolutions=3, quality_mode="rates",
                        quality_layers=[10, 1])


def jpeg2000_fixtures() -> dict:
    """{file name: bytes} of the JPEG 2000 files under ``tests/ldr``:
    Pillow's writer in every mode it writes and under each of its options,
    then ``tools/j2k_fixtures.py``'s files (libopenjp2's encoder with the
    options Pillow never sets, and byte-level rewrites)."""
    import sys

    from PIL import Image

    sys.path.insert(0, os.path.join(os.path.dirname(LDR_DIR), "..", "tools"))
    import j2k_fixtures

    rgba = sample_image(31, 22, 91)
    rgb = sample_image(37, 26, 92, 3)
    gray = sample_image(33, 19, 93, 1)[..., 0]
    im = Image.fromarray
    layers = {"quality_mode": "rates", "quality_layers": [30, 10, 2]}
    out = {
        "j2k_l_rev.j2k": pillow_bytes(im(gray), "JPEG2000", no_jp2=True),
        "j2k_la_irr.jp2": pillow_bytes(im(rgba).convert("LA"), "JPEG2000",
                                       irreversible=True),
        "j2k_rgb_rev.jp2": pillow_bytes(rgb, "JPEG2000"),
        "j2k_rgba_rev.jp2": pillow_bytes(rgba, "JPEG2000"),
        "j2k_rgba_irr_nomct.j2k": pillow_bytes(rgba, "JPEG2000", no_jp2=True,
                                               irreversible=True, mct=0),
        "j2k_i16_rev.jp2": pillow_bytes(
            im(gray.astype(np.uint16) * 3 + 5).convert("I;16"), "JPEG2000"),
        "j2k_i16_irr.j2k": pillow_bytes(
            im(gray.astype(np.uint16) // 4).convert("I;16"), "JPEG2000",
            irreversible=True, no_jp2=True),
        "j2k_rgb_irr_tiles_layers.j2k": pillow_bytes(
            rgb, "JPEG2000", no_jp2=True, irreversible=True,
            tile_size=(16, 12), tile_offset=(3, 2), offset=(5, 4), **layers),
        "j2k_rgb_signed_irr.jp2": pillow_bytes(rgb, "JPEG2000", signed=True,
                                               irreversible=True),
        "j2k_l_signed_rev.j2k": pillow_bytes(im(gray), "JPEG2000",
                                             signed=True, no_jp2=True),
        "j2k_rgb_res1_cblk.j2k": pillow_bytes(
            rgb, "JPEG2000", no_jp2=True, num_resolutions=1,
            codeblock_size=(8, 16)),
        "j2k_rgb_comment_plt_db.jp2": pillow_bytes(
            rgb, "JPEG2000", comment="a comment", plt=True,
            quality_mode="dB", quality_layers=[25, 35, 45]),
    }
    big = sample_image(64, 48, 94, 3)
    for prog in ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL"):
        for irr in (False, True):
            out[f"j2k_{prog.lower()}_{'irr' if irr else 'rev'}.j2k"] = (
                pillow_bytes(big, "JPEG2000", no_jp2=True, progression=prog,
                             irreversible=irr, num_resolutions=3,
                             precinct_size=(16, 16), codeblock_size=(8, 8),
                             **layers))
    out.update({f"j2k_{k}": v for k, v in j2k_fixtures.fixtures().items()})
    return out
