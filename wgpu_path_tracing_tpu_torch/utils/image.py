"""Image output and comparison.

The counterpart of the JAX package's ``utils/image.py``. The accumulation
buffer's row 0 is the BOTTOM of the view, so the display image is flipped.
Only the standard library and NumPy: the PNG writer and reader use ``zlib``
and ``struct``; JPEG, BMP (with DIB, ICO and CUR), netpbm, TIFF and TGA
files are read by ``utils/jpeg.py``, ``bmp.py``, ``netpbm.py``, ``tiff.py``
and ``tga.py``, WebP and GIF files by ``utils/webp.py`` and ``gif.py``
(the JAX package's use Pillow); the Radiance .hdr and the
uncompressed float32 OpenEXR writers and readers are byte-for-byte the JAX
package's.
"""

from __future__ import annotations

import math
import re
import struct
import zlib

import numpy as np
import torch

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHUNK_TYPE = re.compile(rb"\w\w\w\w")  # Pillow's is_cid


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


# Channels a pixel by PNG colour type (gray, RGB, palette, gray + alpha,
# RGBA), and the bit depths the PNG standard allows each (PNG spec 11.2.2).
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8),
               4: (8, 16), 6: (8, 16)}
# The seven passes of Adam7 interlacing (PNG spec 8.2): first column, first
# row, column step, row step.
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


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
    """(IHDR fields, the joined IDAT payload, PLTE, tRNS, the first chunk
    before any IDAT whose CRC is wrong, or None, and for each IDAT chunk
    (where its bytes end in the joined payload, where they end in
    ``data``)) of PNG bytes."""
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{name}: not a PNG file (bad signature)")
    pos, idat, chunks, bad_crc, ends = 8, [], {}, None, []
    while pos + 8 <= len(data):  # a header cut short ends the chunks
        (length,) = struct.unpack_from(">I", data, pos)
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        # Pillow checks each CRC before the first IDAT, not the IDAT's own.
        if not idat and tag != b"IDAT" and bad_crc is None and (
                len(crc) < 4 or struct.unpack(">I", crc)[0]
                != zlib.crc32(tag + body) & 0xFFFFFFFF):
            bad_crc = tag
        if tag == b"IDAT":
            idat.append(body)
            ends.append((sum(map(len, idat)), pos + 8 + len(body)))
        elif tag == b"IEND":
            break
        else:
            chunks.setdefault(tag, body)
        pos += 12 + length
    if b"IHDR" not in chunks:
        raise ValueError(f"{name}: no IHDR chunk")
    header = struct.unpack(">IIBBBBB", chunks[b"IHDR"][:13])
    if header[5]:
        raise ValueError(f"{name}: unknown PNG filter method {header[5]}")
    return (header, b"".join(idat), chunks.get(b"PLTE"), chunks.get(b"tRNS"),
            bad_crc, ends)


def _png_trailer(data: bytes, ends: list, consumed: int, name: str) -> None:
    """Pillow's ``load_end``: from the end of the IDAT chunk that held the
    last image byte inflated (``consumed`` bytes into the payload), each
    chunk's CRC skipped and its data read whole, up to IEND, a header cut
    short or a type of other than four word characters. A chunk whose
    data runs past the end of ``data`` raises, as Pillow's read does."""
    if not ends:
        return
    pos = next((end for cum, end in ends if cum >= consumed), ends[-1][1])
    while True:
        head = data[pos + 4:pos + 12]
        if len(head) < 8 or not _PNG_CHUNK_TYPE.fullmatch(head[4:]):
            return
        length = int.from_bytes(head[:4], "big")
        pos += 12
        if head[4:] == b"IEND":
            return
        if pos + length > len(data):
            raise ValueError(f"{name}: the PNG chunk {head[4:]!r} after the "
                             "image data runs past the end (Pillow: "
                             "Truncated File Read)")
        pos += length


def _unpack_samples(rows: np.ndarray, w: int, depth: int,
                    ch: int) -> np.ndarray:
    """Unfiltered rows (h, stride) -> the samples (h, w, ch) as uint16:
    sub-byte samples from the high bits of each byte down, 16-bit ones
    big-endian."""
    h = rows.shape[0]
    if depth == 8:
        return rows[:, :w * ch].reshape(h, w, ch).astype(np.uint16)
    if depth == 16:
        pairs = rows[:, :2 * w * ch].reshape(h, w, ch, 2).astype(np.uint16)
        return (pairs[..., 0] << 8) | pairs[..., 1]
    bits = np.unpackbits(rows, axis=1)[:, :w * depth].reshape(h, w, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint16)
    return (bits.astype(np.uint16) * weights).sum(axis=2, dtype=np.uint16)[
        ..., None]


def _png_samples(header, idat: bytes, name: str) -> tuple[np.ndarray, int]:
    """(The image's samples (h, w, channels) uint16 at its own bit depth,
    each Adam7 pass (PNG spec 8.2) unfiltered on its own and put in place;
    the payload bytes inflated.) Inflation stops at the last row's byte,
    as Pillow's decoder stops: what the stream holds after it (its end,
    its checksum) is not read."""
    w, h, depth, ctype, _, _, interlace = header
    ch = _PNG_CHANNELS[ctype]
    bits = depth * ch
    bpp = max(1, bits // 8)  # the filters' byte distance (PNG spec 9.2)
    passes = []
    for x0, y0, dx, dy in (_ADAM7 if interlace else ((0, 0, 1, 1),)):
        pw, ph = max(0, -(-(w - x0) // dx)), max(0, -(-(h - y0) // dy))
        if pw and ph:  # an empty pass has no rows, not even filter bytes
            passes.append((x0, y0, dx, dy, pw, ph))
    total = sum(ph * (1 + (pw * bits + 7) // 8) for *_, pw, ph in passes)
    inflate = zlib.decompressobj()
    try:
        raw = inflate.decompress(idat, total)
    except zlib.error as exc:
        raise ValueError(f"{name}: bad PNG image data ({exc})") from None
    out = np.zeros((h, w, ch), np.uint16)
    pos = 0
    for x0, y0, dx, dy, pw, ph in passes:
        stride = (pw * bits + 7) // 8
        size = ph * (1 + stride)
        if pos + size > len(raw):
            raise ValueError(f"{name}: the image data is {len(raw)} bytes, "
                             "too short for its header")
        rows = _unfilter(raw[pos:pos + size], ph, stride, bpp)
        out[y0::dy, x0::dx] = _unpack_samples(rows, pw, depth, ch)
        pos += size
    return out, len(idat) - len(inflate.unconsumed_tail)


def read_png(path: str) -> np.ndarray:
    """Read an LDR image -> (H, W, 3) float32 RGB in [0, 1], as the JAX
    package's Pillow reader returns it (``Image.open(path).convert("RGB") /
    255``): the RGB of ``decode_image_rgba``, which tells the formats apart
    by their bytes, whatever the file's name says."""
    with open(path, "rb") as f:
        data = f.read()
    return decode_image_rgba(data, path)[..., :3].astype(np.float32) / 255.0


def _readers() -> dict:
    """The decoders of the formats this package reads, by Pillow's name."""
    from wgpu_path_tracing_tpu_torch.utils import (
        blp, bmp, dds, fits, fli, ftex, gbr, gif, icns, im, imt, iptc,
        jpeg2000, mcidas, msp, netpbm, pcd, pcx, pixar, psd, qoi, sgi,
        spider, stubs, sun, tga, tiff, webp, xbm, xpm, xvthumb)
    from wgpu_path_tracing_tpu_torch.utils.jpeg import decode_jpeg_rgba

    return {"BMP": bmp.decode_bmp_rgba, "DIB": bmp.decode_dib_rgba,
            "GIF": gif.decode_gif_rgba, "JPEG": decode_jpeg_rgba,
            "PPM": netpbm.decode_netpbm_rgba, "PNG": decode_png_rgba,
            "BLP": blp.decode_blp_rgba, "CUR": bmp.decode_cur_rgba,
            "PCX": pcx.decode_pcx_rgba, "DCX": pcx.decode_dcx_rgba,
            "DDS": dds.decode_dds_rgba, "FTEX": ftex.decode_ftex_rgba,
            "ICNS": icns.decode_icns_rgba, "ICO": bmp.decode_ico_rgba,
            "TIFF": tiff.decode_tiff_rgba, "MSP": msp.decode_msp_rgba,
            "PSD": psd.decode_psd_rgba, "QOI": qoi.decode_qoi_rgba,
            "SGI": sgi.decode_sgi_rgba, "SUN": sun.decode_sun_rgba,
            "TGA": tga.decode_tga_rgba, "WEBP": webp.decode_webp_rgba,
            "XBM": xbm.decode_xbm_rgba, "XPM": xpm.decode_xpm_rgba,
            "IM": im.decode_im_rgba, "IMT": imt.decode_imt_rgba,
            "IPTC": iptc.decode_iptc_rgba, "PCD": pcd.decode_pcd_rgba,
            "PIXAR": pixar.decode_pixar_rgba,
            "SPIDER": spider.decode_spider_rgba,
            "MCIDAS": mcidas.decode_mcidas_rgba,
            "FITS": fits.decode_fits_rgba, "FLI": fli.decode_fli_rgba,
            "GBR": gbr.decode_gbr_rgba, "WMF": stubs.decode_wmf_rgba,
            "XVTHUMB": xvthumb.decode_xvthumb_rgba,
            "EPS": stubs.decode_eps_rgba,
            "BUFR": stubs.decode_bufr_rgba, "GRIB": stubs.decode_grib_rgba,
            "HDF5": stubs.decode_hdf5_rgba, "MPEG": stubs.decode_mpeg_rgba,
            "JPEG2000": jpeg2000.decode_jpeg2000_rgba}


def decode_image_rgba(data: bytes, name: str = "image") -> np.ndarray:
    """LDR image bytes -> (H, W, 4) uint8 RGBA, what Pillow's
    ``Image.open(...).convert("RGBA")`` returns. The format is the one
    ``Image.open`` would choose, found as it finds it
    (``utils/sniff.py``): the bytes, not a file name or a MIME type, and
    Pillow's order of formats. PNG (``decode_png_rgba``), JPEG
    (``utils/jpeg.py``), BMP, DIB, ICO and CUR (``utils/bmp.py``), GIF
    (``utils/gif.py``, the first frame), netpbm (``utils/netpbm.py``),
    TIFF (``utils/tiff.py``), TGA (``utils/tga.py``), WebP
    (``utils/webp.py``, lossless, lossy with its alpha, the first frame of
    an animation), QOI (``utils/qoi.py``), PCX and DCX (``utils/pcx.py``),
    SGI (``utils/sgi.py``), PSD (the merged image, ``utils/psd.py``),
    DDS (``utils/dds.py``, BC1-BC7 through ``utils/bcn.py``), FTEX
    (``utils/ftex.py``), BLP (``utils/blp.py``), ICNS (``utils/icns.py``),
    Sun raster (``utils/sun.py``), MSP (``utils/msp.py``), XBM
    (``utils/xbm.py``), XPM (``utils/xpm.py``), IM (``utils/im.py``), IM
    Tools (``utils/imt.py``), IPTC/NAA (``utils/iptc.py``), Photo CD
    (``utils/pcd.py``), PIXAR (``utils/pixar.py``), SPIDER
    (``utils/spider.py``), McIdas (``utils/mcidas.py``), FITS
    (``utils/fits.py``), FLI and FLC (``utils/fli.py``, the first frame),
    GIMP brushes (``utils/gbr.py``), XV thumbnails (``utils/xvthumb.py``)
    and JPEG 2000 codestreams and JP2 files (``utils/jpeg2000.py``) are
    read; WMF, EPS, BUFR, GRIB, HDF5 and MPEG raise as Pillow's ``load``
    raises without a handler or Ghostscript, or as its MPEG stub fails
    (``utils/stubs.py``). The walk goes on past a format only where that
    format's reader says Pillow's ``_open`` would pass the bytes on (TGA
    and the other formats without a signature, tried on any bytes, pass
    on a RIFF header, so WebP files reach WEBP, and on ``#define`` and
    ``/* XPM */`` headers, so X bitmaps and pixmaps reach XBM and XPM).
    Bytes Pillow would open as a format this package does not read (AVIF)
    raise ``ValueError`` at the first such format, naming
    ``name`` and the format, and bytes no format takes raise
    ``ValueError`` too; a variant of a read format that Pillow opens but
    this package does not read raises ``NotImplementedError`` naming
    ``name``."""
    from wgpu_path_tracing_tpu_torch.utils import sniff

    readers = _readers()
    for fmt in sniff.pillow_candidates(data):
        reader = readers.get(fmt)
        if reader is None:
            raise ValueError(f"{name}: Pillow would open this file as {fmt}, "
                             "a format this package does not read")
        try:
            return reader(data, name)
        except sniff.NotThisFormat:
            continue
    raise ValueError(f"{name}: not an image Pillow can identify")


def _gray_to_8bit(s: np.ndarray, depth: int) -> np.ndarray:
    """Gray samples as Pillow opens them and converts them to 8 bits: a
    1-bit image is 0 or 255 (mode "1"), 2- and 4-bit ones are scaled (x85,
    x17), a 16-bit one (mode "I;16") is clipped at 255, not shifted."""
    if depth == 16:
        return np.minimum(s, 255).astype(np.uint8)
    return (s * (255 // ((1 << depth) - 1))).astype(np.uint8)


def decode_png_rgba(data: bytes, name: str = "image",
                    transparency: bool = True) -> np.ndarray:
    """PNG bytes -> (H, W, 4) uint8 RGBA, what Pillow's
    ``Image.open(...).convert("RGBA")`` returns, for every bit depth (1, 2,
    4, 8, 16) of every colour type the PNG standard allows it, interlaced
    (Adam7) or not. Pillow's rules, copied as it applies them:

    * gray: 1-bit 0 or 255, 2- and 4-bit scaled, 8-bit as it is, 16-bit
      clipped at 255; RGB, gray + alpha and RGBA at 16 bits keep each
      sample's high byte;
    * a palette is looked up (entries past PLTE are black), with ``tRNS``
      alphas for its first entries;
    * ``tRNS`` of a gray or RGB image makes alpha 0 where the 8-bit value
      equals the chunk's value as the file stores it (at 16 bits, and at 2
      and 4 bits, against the converted sample; at 1 bit any non-zero value
      means 255), else alpha is 255.

    With ``transparency`` False the ``tRNS`` chunk is not read, as when
    another format's reader (ICNS) takes the PNG's pixels without its
    ``info``.

    Other combinations, a chunk before the image data whose CRC is wrong
    (an IDAT's own CRC is not checked), a chunk after the image data
    whose data runs past the end (Pillow's ``load_end`` reads each one up
    to IEND) or a filter method other than 0 (Pillow refuses each), and
    bytes that are no PNG (``decode_image_rgba`` reads other formats),
    raise ``ValueError`` naming ``name``. The image data is inflated up to
    its last row only, so a stream cut after it reads."""
    header, idat, plte, trns, bad_crc, ends = _png_chunks(data, name)
    if not transparency:
        trns = None
    _, _, depth, ctype, _, _, interlace = header
    if depth not in _PNG_DEPTHS.get(ctype, ()) or interlace not in (0, 1):
        raise ValueError(f"{name}: not a valid PNG header (bit depth "
                         f"{depth}, colour type {ctype}, interlace "
                         f"{interlace})")
    if bad_crc is not None:
        raise ValueError(f"{name}: broken PNG file (bad checksum in "
                         f"{bad_crc!r})")
    s, consumed = _png_samples(header, idat, name)
    _png_trailer(data, ends, consumed, name)
    h, w = s.shape[0], s.shape[1]
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
        return table[s[..., 0]]
    out = np.full((h, w, 4), 255, np.uint8)
    if ctype == 0:
        gray = _gray_to_8bit(s[..., 0], depth)
        out[..., :3] = gray[..., None]
        if trns is not None and len(trns) >= 2:
            (key,) = struct.unpack(">H", trns[:2])
            if depth == 1:
                key = 255 if key else 0
            out[..., 3] = np.where(gray.astype(np.int32) == key, 0, 255)
        return out
    s8 = (s >> 8 if depth == 16 else s).astype(np.uint8)
    if ctype == 4:
        out[..., :3] = s8[..., :1]
        out[..., 3] = s8[..., 1]
        return out
    out[..., :s8.shape[2]] = s8  # RGB or RGBA
    if ctype == 2 and trns is not None and len(trns) >= 6:
        key = np.array(struct.unpack(">HHH", trns[:6]))
        out[..., 3] = np.where((s8 == key).all(-1), 0, 255)
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
