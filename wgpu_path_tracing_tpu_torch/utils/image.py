"""Image output and comparison.

The counterpart of the JAX package's ``utils/image.py``. The accumulation
buffer's row 0 is the BOTTOM of the view, so the display image is flipped.
Only the standard library and NumPy: the PNG writer and reader use ``zlib``
and ``struct`` (the JAX package's use Pillow); the Radiance .hdr and the
uncompressed float32 OpenEXR writers and readers are byte-for-byte the JAX
package's.
"""

from __future__ import annotations

import math
import struct
import zlib

import numpy as np
import torch

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def buffer_to_srgb(accum, width: int, height: int, exposure: float = 1.0):
    """HDR accumulation (N, 3) -> display-referred (H, W, 3) float32 NumPy in
    [0, 1], top row first."""
    from wgpu_path_tracing_tpu_torch.ops import tonemap

    hdr = torch.as_tensor(np.asarray(accum, np.float32)).reshape(height, width, 3)
    img = tonemap.display_transform(hdr, exposure).numpy()
    img = np.nan_to_num(img, nan=0.0, posinf=1.0, neginf=0.0)
    img = np.clip(img, 0.0, 1.0)
    return img[::-1]


def encode_png(img: np.ndarray) -> bytes:
    """An image, top row first, -> 8-bit PNG bytes: (H, W, 3) float in
    [0, 1] as RGB, or (H, W, 3) or (H, W, 4) uint8 as RGB or RGBA (the
    exporter's textures)."""
    img = np.asarray(img)
    if img.dtype == np.uint8:
        data = np.ascontiguousarray(img)
    else:
        data = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    h, w, ch = data.shape
    if ch not in (3, 4):
        raise ValueError(f"encode_png: expected 3 or 4 channels, got {ch}")
    raw = b"".join(b"\x00" + data[y].tobytes() for y in range(h))

    def chunk(tag: bytes, payload: bytes) -> bytes:
        body = tag + payload
        return (struct.pack(">I", len(payload)) + body
                + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))

    ctype = 2 if ch == 3 else 6
    return (_PNG_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6))
            + chunk(b"IEND", b""))


def write_png(path: str, img01: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img01))


def rmse(a: np.ndarray, b: np.ndarray) -> float:
    """Root-mean-square error between two [0, 1] images of equal shape."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch {a.shape} vs {b.shape}")
    return float(np.sqrt(np.mean((a - b) ** 2)))


def write_hdr(path: str, hdr: np.ndarray) -> None:
    """Radiance RGBE .hdr (linear, no tonemap), flat scanlines.
    hdr: (H, W, 3) float32, top row first."""
    hdr = np.asarray(hdr, np.float32)
    h, w = hdr.shape[0], hdr.shape[1]
    maxc = np.maximum(hdr.max(axis=2), 1e-32)
    exp = np.ceil(np.log2(maxc)).astype(np.int32) + 1
    scale = np.exp2(exp.astype(np.float32) - 8.0)
    rgbe = np.zeros((h, w, 4), np.uint8)
    mantissa = np.clip(hdr / scale[..., None] + 0.5, 0.0, 255.0).astype(np.uint8)
    rgbe[..., 0:3] = mantissa
    rgbe[..., 3] = np.clip(exp + 128, 0, 255).astype(np.uint8)
    rgbe[maxc <= 1e-32] = 0
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())


def read_hdr(path: str) -> np.ndarray:
    """Read a flat (uncompressed) Radiance RGBE .hdr file -> (H, W, 3)
    float32."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(b"#?RADIANCE"):
        raise ValueError(f"{path}: not a Radiance .hdr file (bad magic)")
    _, _, rest = data.partition(b"\n\n")
    dims, _, pix = rest.partition(b"\n")
    parts = dims.split()
    h, w = int(parts[1]), int(parts[3])
    rgbe = np.frombuffer(pix, np.uint8, count=h * w * 4).reshape(h, w, 4)
    exp = rgbe[..., 3].astype(np.int32)
    scale = np.where(exp == 0, 0.0, np.exp2(exp - 128 - 8, dtype=np.float64))
    return rgbe[..., 0:3].astype(np.float32) * scale[..., None].astype(np.float32)


_EXR_MAGIC = 20000630
_EXR_FLOAT = 2  # channel pixel type: 0 UINT, 1 HALF, 2 FLOAT


def write_exr(path: str, hdr: np.ndarray) -> None:
    """OpenEXR 2.0, uncompressed FLOAT scanlines, channels B, G, R (the
    format's alphabetical order), one scanline a chunk. hdr: (H, W, 3)
    float32, top row first. Lossless, unlike RGBE's shared exponent."""
    hdr = np.ascontiguousarray(np.asarray(hdr, np.float32))
    h, w = hdr.shape[0], hdr.shape[1]

    def attr(name: bytes, typ: bytes, payload: bytes) -> bytes:
        return (name + b"\0" + typ + b"\0" + struct.pack("<i", len(payload))
                + payload)

    # chlist: per channel name\0, pixel type, pLinear + 3 reserved, sampling.
    ch = b"".join(name + b"\0" + struct.pack("<i", _EXR_FLOAT) + b"\0" * 4
                  + struct.pack("<ii", 1, 1) for name in (b"B", b"G", b"R"))
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header = (
        struct.pack("<Ii", _EXR_MAGIC, 2)  # version 2, scanline
        + attr(b"channels", b"chlist", ch + b"\0")
        + attr(b"compression", b"compression", b"\0")  # NO_COMPRESSION
        + attr(b"dataWindow", b"box2i", box)
        + attr(b"displayWindow", b"box2i", box)
        + attr(b"lineOrder", b"lineOrder", b"\0")  # INCREASING_Y
        + attr(b"pixelAspectRatio", b"float", struct.pack("<f", 1.0))
        + attr(b"screenWindowCenter", b"v2f", struct.pack("<ff", 0.0, 0.0))
        + attr(b"screenWindowWidth", b"float", struct.pack("<f", 1.0))
        + b"\0"
    )
    line_bytes = 4 * w * 3
    data_at = len(header) + 8 * h  # after the offset table
    offsets = struct.pack(f"<{h}Q", *(data_at + y * (8 + line_bytes)
                                      for y in range(h)))
    with open(path, "wb") as f:
        f.write(header)
        f.write(offsets)
        for y in range(h):
            f.write(struct.pack("<ii", y, line_bytes))
            for c in (2, 1, 0):  # B, G, R
                f.write(hdr[y, :, c].tobytes())


def read_exr(path: str) -> np.ndarray:
    """Read an uncompressed FLOAT-scanline OpenEXR (as ``write_exr`` writes
    it) -> (H, W, 3) float32, top row first. Compressed, HALF, UINT, tiled
    or multi-channel files raise ``ValueError``."""
    with open(path, "rb") as f:
        data = f.read()
    magic, _ = struct.unpack_from("<Ii", data, 0)
    if magic != _EXR_MAGIC:
        raise ValueError(f"{path}: not an EXR file (bad magic)")
    pos, attrs = 8, {}
    while data[pos] != 0:
        nend = data.index(b"\0", pos)
        tend = data.index(b"\0", nend + 1)
        (size,) = struct.unpack_from("<i", data, tend + 1)
        attrs[data[pos:nend].decode()] = data[tend + 5:tend + 5 + size]
        pos = tend + 5 + size
    pos += 1  # the header's terminator
    if attrs.get("compression", b"?") != b"\0":
        raise ValueError(f"{path}: only uncompressed (NO_COMPRESSION) EXRs "
                         "are supported")
    chlist, cpos = attrs.get("channels", b"\0"), 0
    while chlist[cpos] != 0:
        cend = chlist.index(b"\0", cpos)
        (ctype,) = struct.unpack_from("<i", chlist, cend + 1)
        if ctype != _EXR_FLOAT:
            raise ValueError(f"{path}: channel "
                             f"{chlist[cpos:cend].decode()!r} is not FLOAT")
        cpos = cend + 17
    x0, y0, x1, y1 = struct.unpack("<iiii", attrs["dataWindow"])
    w, h = x1 - x0 + 1, y1 - y0 + 1
    out = np.empty((h, w, 3), np.float32)
    for row, off in enumerate(struct.unpack_from(f"<{h}Q", data, pos)):
        y, size = struct.unpack_from("<ii", data, off)
        if size != 12 * w:
            raise ValueError(f"{path}: scanline {row} has {size} bytes, "
                             f"expected {12 * w}")
        line = np.frombuffer(data, np.float32, count=3 * w, offset=off + 8)
        for k, c in enumerate((2, 1, 0)):  # B, G, R
            out[y - y0, :, c] = line[k * w:(k + 1) * w]
    return out


# PNG colour types this reader takes: 8-bit gray, RGB and RGBA.
_PNG_CHANNELS = {0: 1, 2: 3, 6: 4}


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """The Paeth predictor (PNG spec 9.4) on int16 arrays."""
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the five PNG filter types (PNG spec 9.2), row by row."""
    rows = np.frombuffer(raw, np.uint8).reshape(h, 1 + stride)
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.int16)
    for y in range(h):
        ftype, line = rows[y, 0], rows[y, 1:].astype(np.int16)
        if ftype == 0:
            cur = line
        elif ftype == 2:  # Up
            cur = (line + prior) & 0xFF
        elif ftype == 1:  # Sub: a running sum along each byte of a pixel
            cur = (np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.int64)
                   & 0xFF).reshape(-1).astype(np.int16)
        elif ftype in (3, 4):  # Average, Paeth: pixel by pixel
            cur = np.zeros(stride, np.int16)
            left = np.zeros(bpp, np.int16)
            up_left = np.zeros(bpp, np.int16)
            for x in range(0, stride, bpp):
                up = prior[x:x + bpp]
                pred = ((left + up) >> 1 if ftype == 3
                        else _paeth(left, up, up_left))
                left = (line[x:x + bpp] + pred) & 0xFF
                cur[x:x + bpp] = left
                up_left = up
        else:
            raise ValueError(f"unknown PNG filter type {ftype}")
        out[y] = cur
        prior = cur
    return out


def _png_chunks(data: bytes, name: str):
    """(IHDR fields, the joined IDAT payload, PLTE, tRNS) of PNG bytes."""
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{name}: not a PNG file (bad signature)")
    pos, idat, chunks = 8, [], {}
    while pos < len(data):
        (length,) = struct.unpack_from(">I", data, pos)
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        else:
            chunks.setdefault(tag, body)
        pos += 12 + length
    if b"IHDR" not in chunks:
        raise ValueError(f"{name}: no IHDR chunk")
    header = struct.unpack(">IIBBBBB", chunks[b"IHDR"])
    return header, b"".join(idat), chunks.get(b"PLTE"), chunks.get(b"tRNS")


def _png_pixels(header, idat: bytes, channels: int) -> np.ndarray:
    w, h = header[0], header[1]
    pixels = _unfilter(zlib.decompress(idat), h, w * channels, channels)
    return pixels.reshape(h, w, channels)


def read_png(path: str) -> np.ndarray:
    """Read an 8-bit gray, RGB or RGBA non-interlaced PNG -> (H, W, 3)
    float32 RGB in [0, 1] (gray replicated, alpha dropped), as the JAX
    package's Pillow reader returns it."""
    with open(path, "rb") as f:
        data = f.read()
    header, idat, _, _ = _png_chunks(data, path)
    _, _, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _PNG_CHANNELS or interlace != 0:
        raise ValueError(f"{path}: only 8-bit gray, RGB and RGBA "
                         "non-interlaced PNGs are supported")
    ch = _PNG_CHANNELS[ctype]
    pixels = _png_pixels(header, idat, ch)
    rgb = np.repeat(pixels, 3, axis=2) if ch == 1 else pixels[..., :3]
    return rgb.astype(np.float32) / 255.0


# Channels a pixel by PNG colour type: gray, RGB, palette, gray + alpha,
# RGBA.
_PNG_RGBA_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def decode_png_rgba(data: bytes, name: str = "image") -> np.ndarray:
    """PNG bytes -> (H, W, 4) uint8 RGBA, what Pillow's
    ``Image.open(...).convert("RGBA")`` returns for 8-bit non-interlaced
    gray, RGB, palette, gray + alpha and RGBA images: gray replicated, a
    palette looked up, alpha from the image, from ``tRNS`` (a palette's
    per-entry alphas; the one transparent gray value or RGB colour), else
    255. 16-bit, sub-byte and interlaced PNGs raise ``ValueError``; a JPEG
    raises ``NotImplementedError`` naming ``name``."""
    if data[:2] == b"\xff\xd8":
        raise NotImplementedError(
            f"{name}: JPEG textures are not supported (no JPEG decoder in "
            "this package); convert the image to PNG")
    header, idat, plte, trns = _png_chunks(data, name)
    _, _, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _PNG_RGBA_CHANNELS or interlace != 0:
        raise ValueError(f"{name}: only 8-bit non-interlaced PNGs are "
                         f"supported (bit depth {depth}, colour type "
                         f"{ctype}, interlace {interlace})")
    px = _png_pixels(header, idat, _PNG_RGBA_CHANNELS[ctype])
    h, w = px.shape[0], px.shape[1]
    out = np.full((h, w, 4), 255, np.uint8)
    if ctype == 3:
        if plte is None:
            raise ValueError(f"{name}: palette PNG without a PLTE chunk")
        table = np.zeros((256, 4), np.uint8)
        table[:, 3] = 255
        pal = np.frombuffer(plte, np.uint8)[:768].reshape(-1, 3)
        table[:len(pal), :3] = pal
        if trns is not None:
            alpha = np.frombuffer(trns, np.uint8)[:256]
            table[:len(alpha), 3] = alpha
        return table[px[..., 0]]
    if ctype in (0, 4):
        out[..., :3] = px[..., :1]
        if ctype == 4:
            out[..., 3] = px[..., 1]
        elif trns is not None and len(trns) >= 2:
            (gray,) = struct.unpack(">H", trns[:2])
            out[..., 3] = np.where(px[..., 0] == gray, 0, 255)
        return out
    out[..., :px.shape[2]] = px
    if ctype == 2 and trns is not None and len(trns) >= 6:
        key = np.array(struct.unpack(">HHH", trns[:6]))
        out[..., 3] = np.where((px == key).all(-1), 0, 255)
    return out


# Pillow's fixed-point resampling (Resample.c): weights carry
# PRECISION_BITS fraction bits.
_PRECISION_BITS = 32 - 8 - 2


def _bilinear_weights(in_size: int, out_size: int):
    """The triangle filter's taps of each output pixel, as Pillow's
    ``precompute_coeffs`` and ``normalize_coeffs_8bpc`` make them: (first
    source index (out,), fixed-point weights (out, ksize) int64, zero past
    each pixel's taps)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale  # the bilinear filter's support is 1
    ksize = int(math.ceil(support)) * 2 + 1
    first = np.zeros(out_size, np.int64)
    weights = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        k = [abs((x + xmin - center + 0.5) / filterscale)
             for x in range(xmax)]
        k = [1.0 - a if a < 1.0 else 0.0 for a in k]
        ww = 0.0
        for v in k:  # summed in order, as the C loop sums
            ww += v
        if ww != 0.0:
            k = [v / ww for v in k]
        first[xx] = xmin
        weights[xx, :xmax] = [int(0.5 + v * (1 << _PRECISION_BITS))
                              for v in k]
    return first, weights


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One 8-bit pass of Pillow's two-pass resize along ``axis`` (1: rows,
    horizontal; 0: columns, vertical) of an (H, W, C) uint8 image."""
    first, weights = _bilinear_weights(img.shape[axis], out_size)
    taps = first[:, None] + np.arange(weights.shape[1])
    taps = np.minimum(taps, img.shape[axis] - 1)  # zero-weight taps only
    src = np.moveaxis(img, axis, 0).astype(np.int64)  # (in, other, C)
    acc = np.full((out_size,) + src.shape[1:], 1 << (_PRECISION_BITS - 1),
                  np.int64)
    for j in range(weights.shape[1]):
        acc += src[taps[:, j]] * weights[:, j, None, None]
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize_bilinear_u8(img: np.ndarray, size) -> np.ndarray:
    """(H, W, 4) uint8 RGBA -> (h, w, 4) for ``size = (w, h)``, equal to
    Pillow's ``Image.fromarray(img).resize((w, h), Image.BILINEAR)``: the
    colour premultiplied by alpha first and divided back after, the
    horizontal pass and then the vertical one, each only where its size
    changes, each in Pillow's 22-bit fixed point and clipped to 8 bits; a
    copy when the size is the same."""
    img = np.asarray(img, np.uint8)
    w, h = (int(v) for v in size)
    if (h, w) == img.shape[:2]:
        return img.copy()
    a = img[..., 3:4].astype(np.uint32)
    tmp = img[..., :3].astype(np.uint32) * a + 128  # MULDIV255
    pre = np.concatenate([((tmp >> 8) + tmp) >> 8, a], -1).astype(np.uint8)
    if w != img.shape[1]:
        pre = _resample_axis(pre, w, 1)
    if h != img.shape[0]:
        pre = _resample_axis(pre, h, 0)
    alpha = pre[..., 3:4].astype(np.int64)
    rgb = pre[..., :3].astype(np.int64)
    keep = (alpha == 0) | (alpha == 255)
    div = np.clip(255 * rgb // np.maximum(alpha, 1), 0, 255)
    out = pre.copy()
    out[..., :3] = np.where(keep, rgb, div)
    return out
