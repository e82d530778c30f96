"""Hold the LDR readers to Pillow on mutated and generated files.

    python tools/ldr_fuzz.py [--kind tga|bmp|icon|ppm|tiff|tiff_big|tiff_ycbcr|
        tiff_float|tiff_jpeg|tiff_fax|tiff_oldlzw|tiff_zstd|tiff_ojpeg|webp|
        gif|qoi|pcx|sgi|psd|dds|ftex|blp|icns|sun|msp|xbm|xpm|jpeg_cut|im|
        spider|fits|mcidas|gbr|xvthumb|pixar|imt|iptc|pcd|fli|j2k|jp2|zstd|
        mut] [--n 2000] [--seed 1]

Each case is random bytes of one format (``tests/torch_image_cases.py``'s
writers with random headers, depths, compressions and layouts; for TIFF
also BigTIFF, YCbCr at every subsampling, float, 32-bit, 12-bit and CIELab
samples under each predictor, JPEG, CCITT and old-style LZW; for WebP,
Pillow's writer and Pillow's own libwebp with random options, this
suite's VP8L writer with random transforms and animations with random
offsets; for GIF, random code sizes, palettes, transparency, interlace,
offsets and extensions; for QOI, encoded images and random op streams
under any channel count; for PCX, every bit and plane count, version,
stride and trailer, some in a DCX; for SGI, every mode, raw and RLE, with
random row tables; for PSD, every colour mode and depth, channel counts,
sections and compressions; for DDS, every pixel format (masks,
luminance, palette, FourCC and DX10 codes, Pillow's and others) over
random or encoded blocks; for FTEX, BC1 or RGB with wrong counts,
offsets and sizes; for BLP, BLP1 JPEG and palettes and BLP2 palettes and
DXT over random or encoded blocks, any compression, encoding and alpha
encoding; for ICNS, raw and run-length RGB entries, masks and PNG entries
in any order, some cut; for Sun rasters, every depth and type, padded or
not, with colour maps of any length; for MSP, raw and run-length rows,
some blank, long or cut; for XBM and XPM, any size and spelling, None
keys, up to 300 colours; for ``jpeg_cut``, a JPEG of any kind whose
scan data stops early, some inside a BLP1; for IM, SPIDER, FITS, McIdas,
GBR, XV thumbnails, PIXAR, IMT, IPTC, Photo CD and FLI, the test writers'
files with random modes, header fields, chunks and sizes; for ``j2k``,
Pillow's JPEG 2000 writer under random options and libopenjp2's encoder
with code-block styles, SOP/EPH, ROI, subsampling and tile-parts, some
rewritten with PPT/PPM or cut into tile-parts (``tools/j2k_fixtures.py``);
for ``jp2``, Pillow's JP2 files and codestreams under random JP2 boxes;
for ``tiff_zstd``, Pillow's zstd TIFFs and this suite's over libzstd at
any level, layout and sample kind; for ``tiff_ojpeg``, old-style JPEG in
both layouts with tags present, absent or wrong; a quarter of them then
mutated) or, with
``--kind mut``, a file under ``tests/ldr`` with a few bytes changed or its
end cut. Pillow (the JAX package's reader)
and ``utils/image.py::decode_image_rgba`` decode it, the latter with the
C++ loops and with their Python versions. A case is BAD when the port
returns an array that is not Pillow's, or any array where Pillow raises;
it is a GAP when Pillow reads it and the port raises. BAD cases are
written under ``build/ldr_fuzz/``; the exit code is 1 if there is one.
``--kind zstd`` holds Zstandard frames alone (libzstd's, a quarter
mutated) to ``ZSTD_decompress`` and to libtiff's stream loop with a
strip's room, through Pillow's libzstd.
A case Pillow takes longer than ``--pillow-seconds`` on is skipped and
counted apart, and so is one where OpenJPEG (in Pillow or its encoder)
kills the process, which JPEG 2000 cases run in a child.
The process's address space is capped at 3 GiB (headers may claim huge
images).
"""

from __future__ import annotations

import argparse
import io
import os
import resource
import signal
import struct
import sys
import warnings

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

from PIL import Image  # noqa: E402

from tests import torch_image_cases as C  # noqa: E402
from wgpu_path_tracing_tpu_torch.accel import native  # noqa: E402
from wgpu_path_tracing_tpu_torch.utils.image import decode_image_rgba  # noqa: E402

OUT_DIR = os.path.join(REPO, "build", "ldr_fuzz")


class PillowTimeout(Exception):
    """Pillow took longer than ``--pillow-seconds`` on a case."""


def _timeout(signum, frame):
    raise PillowTimeout()


def pillow(data: bytes, seconds: float = 0.0):
    """Pillow's RGBA and format, or (None, its error). With ``seconds``,
    a decode that takes longer raises ``PillowTimeout`` (Pillow's DDS mask
    decoder is a Python loop a pixel, hours on a header that claims a
    huge image)."""
    if seconds:
        signal.signal(signal.SIGALRM, _timeout)
        signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        with Image.open(io.BytesIO(data)) as im:
            return np.asarray(im.convert("RGBA")), im.format
    except PillowTimeout:
        raise
    except Exception as exc:
        return None, f"{type(exc).__name__}: {str(exc)[:80]}"
    finally:
        if seconds:
            signal.setitimer(signal.ITIMER_REAL, 0)


def port(data: bytes, in_cxx: bool):
    real = native.native_available
    native.native_available = real if in_cxx else (lambda: False)
    try:
        return decode_image_rgba(data, "f"), None
    except Exception as exc:
        return None, f"{type(exc).__name__}: {str(exc)[:80]}"
    finally:
        native.native_available = real


def pick(rng, options):
    return options[int(rng.integers(0, len(options)))]


def rand_bytes(rng, n: int) -> bytes:
    return rng.integers(0, 256, max(0, n), dtype=np.uint8).tobytes()


def mutate(data: bytes, rng) -> bytes:
    """Cut the end, or change one to three bytes (most in the header)."""
    d = bytearray(data)
    if rng.integers(0, 4) == 0 and len(d) > 1:
        return bytes(d[:rng.integers(1, len(d))])
    for _ in range(rng.integers(1, 4)):
        i = int(rng.integers(0, min(len(d), 80 if rng.random() < 0.7
                                    else len(d))))
        d[i] = (int(rng.integers(0, 256)) if rng.random() < 0.5
                else d[i] ^ (1 << int(rng.integers(0, 8))))
    return bytes(d)


def rnd_tga(rng) -> bytes:
    """A TGA header of any type, depth, map and origin, then pixels or
    run-length packets, a little short or long."""
    w, h = int(rng.integers(1, 9)), int(rng.integers(1, 7))
    itype = pick(rng, [1, 2, 3, 9, 10, 11, 0, 4])
    depth = pick(rng, [1, 8, 15, 16, 24, 32])
    has_map = int(rng.random() < (0.8 if itype in (1, 9) else 0.1))
    cdepth, start, length = pick(rng, [15, 16, 24, 32]), \
        int(rng.integers(0, 4)), int(rng.integers(0, 20))
    ident = rand_bytes(rng, int(rng.integers(0, 4)))
    head = struct.pack("<BBBHHBHHHHBB", len(ident), has_map, itype, start,
                       length, cdepth, 0, 0, w, h, depth,
                       int(rng.integers(0, 256)))
    cmap = rand_bytes(rng, length * ((cdepth + 7) // 8)) if has_map else b""
    bpp = max(1, depth // 8)
    if itype & 8:
        body, n = bytearray(), 0
        while n < w * h + rng.integers(-2, 3):
            k = int(rng.integers(1, 6))
            if rng.random() < 0.5:
                body += bytes([0x80 | (k - 1)]) + rand_bytes(rng, bpp)
            else:
                body += bytes([k - 1]) + rand_bytes(rng, bpp * k)
            n += k
    else:
        body = rand_bytes(rng, w * h * bpp + int(rng.integers(-2, 3)))
    return head + ident + cmap + bytes(body)


MASKS = [(0xFF0000, 0xFF00, 0xFF, 0), (0xFF000000, 0xFF0000, 0xFF00, 0),
         (0xFF, 0xFF00, 0xFF0000, 0xFF000000), (0xF800, 0x7E0, 0x1F, 0),
         (0x7C00, 0x3E0, 0x1F, 0), (0, 0, 0, 0), (1, 2, 3, 4)]


def rnd_bmp(rng) -> bytes:
    """A BMP or DIB of any header, depth, compression, masks and palette
    (a gray ramp sometimes), RLE data written or random, maybe cut."""
    w, h = int(rng.integers(1, 12)), int(rng.integers(1, 6))
    bits = pick(rng, [1, 4, 8, 16, 24, 32, 2])
    comp = pick(rng, [0, 0, 1, 2, 3, 4, 6])
    header = pick(rng, [12, 40, 52, 56, 64, 108, 124])
    colors = pick(rng, [0, 2, 3, 16, 256, 300] if bits <= 8 else [0, 0, 5])
    n_pal = colors or (1 << bits if bits <= 8 else 0)
    if rng.random() < 0.3 and bits <= 8:
        pal = np.repeat(np.arange(n_pal, dtype=np.uint8)[:, None], 3, 1)
        if n_pal == 2:
            pal[1] = 255
    else:
        pal = rng.integers(0, 256, (n_pal, 3), dtype=np.uint8)
    if bits <= 8:
        px = rng.integers(0, max(1, min(n_pal + 2, 1 << bits)), (h, w),
                          dtype=np.uint8)
    else:
        px = rng.integers(0, 256, (h, w, bits // 8), dtype=np.uint8)
    stream = None
    if comp in (1, 2):
        idx = px if px.ndim == 2 else px[..., 0]
        if rng.random() < 0.5:
            stream = (C.rle8_rows(idx % 255) if comp == 1
                      else C.rle4_rows(idx % 16))
        else:
            stream = bytes(int(v) % 4 if i % 2 == 0 and rng.random() < 0.5
                           else int(v) for i, v in enumerate(
                               rng.integers(0, 256, int(rng.integers(2, 40)))))
    try:
        data = C.write_bmp(px, bits, header=header, compression=comp,
                           palette=pal if bits <= 8 else None, colors=colors,
                           masks=pick(rng, MASKS) if comp == 3 else None,
                           top_down=rng.random() < 0.3 and header != 12,
                           rle_data=stream, file_header=rng.random() < 0.8)
    except Exception:
        return b"BM"
    if rng.random() < 0.3:
        data = data[:len(data) - int(rng.integers(0, 6))]
    return data


def rnd_icon(rng) -> bytes:
    """An ICO or CUR of zero to three frames: BMP frames of 4-32 bits with
    AND masks, or PNG frames; the directory's depth sometimes wrong."""
    frames = []
    for _ in range(int(rng.integers(0, 4))):
        size = pick(rng, [1, 2, 4, 8, 16])
        img = rng.integers(0, 256, (size, size, 4), dtype=np.uint8)
        bits = pick(rng, [32, 24, 8, 4])
        if bits <= 8:
            data = C.icon_dib(img, bits,
                              rng.integers(0, 256, (1 << bits, 3),
                                           dtype=np.uint8),
                              rng.integers(0, 1 << bits, (size, size),
                                           dtype=np.uint8))
        elif rng.random() < 0.2:
            data = C.pillow_bytes(img, "PNG")
        else:
            data = C.icon_dib(img, bits)
        shown = bits if rng.random() < 0.8 else pick(rng, [0, 32, 8])
        frames.append((data, size, size, 0, shown, 1))
    return C.write_icon(frames, rng.random() < 0.4)


def rnd_ppm(rng) -> bytes:
    """A netpbm header of any magic (some Pillow does not know), size and
    maxval, comments in it, then plain or binary data, a sample short or
    long."""
    magic = pick(rng, [b"P1", b"P2", b"P3", b"P4", b"P5", b"P6", b"Pf",
                       b"PyP", b"PyRGBA", b"PyCMYK", b"P0CMYK", b"P7", b"P0"])
    w, h = int(rng.integers(0, 6)), int(rng.integers(1, 5))
    maxval = pick(rng, [1, 7, 255, 256, 1000, 65535, 0, 70000])
    seps = [b" ", b"\n", b"\t", b"#c\n", b"\r", b" #x\r\n"]
    head = magic + pick(rng, seps) + str(w).encode() + pick(rng, seps) \
        + str(h).encode()
    if magic not in (b"P1", b"P4"):
        head += pick(rng, seps) + (str(maxval).encode() if magic != b"Pf"
                                   else pick(rng, [b"-1.0", b"1.0", b"0",
                                                   b"nan"]))
    head += pick(rng, [b"\n", b" ", b"#z\n"])
    bands = {b"P3": 3, b"P6": 3, b"PyRGBA": 4, b"PyCMYK": 4,
             b"P0CMYK": 4}.get(magic, 1)
    n = max(0, w * h * bands + int(rng.integers(-1, 2)))
    if magic == b"P1":
        body = b" ".join(pick(rng, [b"0", b"1", b"01", b"2", b"#q\n1"])
                         for _ in range(n))
    elif magic in (b"P2", b"P3"):
        body = b" ".join(str(int(v)).encode()
                         for v in rng.integers(-1, maxval + 2, n))
    elif magic == b"Pf":
        body = rng.random(n).astype("<f4").tobytes()
    else:
        body = rand_bytes(rng, n * (2 if maxval > 255 else 1))
    return head + body


def rnd_tiff(rng) -> bytes:
    """A baseline TIFF, or one of the kinds below (BigTIFF, YCbCr, float
    and 32-bit samples, JPEG, CCITT, old-style LZW)."""
    kinds = (rnd_tiff_base, rnd_tiff_big, rnd_tiff_ycbcr, rnd_tiff_float,
             rnd_tiff_jpeg, rnd_tiff_fax, rnd_tiff_oldlzw)
    return kinds[int(rng.integers(0, len(kinds)))](rng)


def rnd_tiff_base(rng, bigtiff: bool = False) -> bytes:
    """A TIFF of any photometric, depth, extra samples, compression,
    predictor, byte order, strips or tiles, planes, fill order,
    orientation and sample format."""
    h, w = int(rng.integers(1, 20)), int(rng.integers(1, 20))
    photo = pick(rng, [0, 1, 2, 3, 5])
    bits = pick(rng, [1, 2, 4, 8, 8, 16])
    extra = ()
    if photo in (1, 2) and bits >= 8 and rng.random() < 0.4:
        extra = tuple(pick(rng, [0, 1, 2])
                      for _ in range(int(rng.integers(1, 3))))
    if photo == 3 and bits == 8 and rng.random() < 0.3:
        extra = (pick(rng, [0, 2]),)
    spp = {2: 3, 5: 4}.get(photo, 1) + len(extra)
    samples = rng.integers(0, 1 << bits, (h, w, spp)).astype(
        np.uint16 if bits == 16 else np.uint8)
    if rng.random() < 0.5:
        samples = np.repeat(samples[:, :1], w, 1)
    comp = pick(rng, [1, 5, 8, 32946, 32773, 34925])
    predictor = 2 if comp in (5, 8, 32946) and bits in (8, 16) \
        and rng.random() < 0.5 else 1
    tile = ((16 * int(rng.integers(1, 3)), 16 * int(rng.integers(1, 3)))
            if rng.random() < 0.3 else None)
    return C.write_tiff(
        samples, bits, photo, compression=comp, predictor=predictor,
        order=pick(rng, ["<", ">"]), rows_per_strip=int(rng.integers(1, h + 3)),
        tile=tile, planar=pick(rng, [1, 1, 2]), fill=pick(rng, [1, 1, 2]),
        extra=extra,
        orientation=int(rng.integers(1, 9)) if rng.random() < 0.3 else None,
        colormap=(rng.integers(0, 65536, 3 * (1 << bits)) if photo == 3
                  else None),
        sample_format=pick(rng, [1, 2]) if rng.random() < 0.2 else None,
        bigtiff=bigtiff)


def rnd_tiff_big(rng) -> bytes:
    """A baseline random TIFF in the BigTIFF container (or, for a
    big-endian one, the header Pillow misreads)."""
    return rnd_tiff_base(rng, bigtiff=True)


def rnd_tiff_ycbcr(rng) -> bytes:
    """YCbCr: every subsampling (some libtiff refuses), raw or compressed,
    strips or tiles, with random ReferenceBlackWhite and coefficients."""
    h, w = int(rng.integers(1, 24)), int(rng.integers(1, 40))
    sub = pick(rng, [(1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4),
                     (2, 4), (3, 1)])
    samples = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    if rng.random() < 0.5:
        samples = C.rgb_to_ycbcr(C.sample_image(w, h, int(rng.integers(
            0, 1 << 16)), 3))
    tags = {}
    if rng.random() < 0.4:
        tags[532] = (5, [(int(rng.integers(0, 300)), int(rng.integers(0, 3)))
                         for _ in range(6)])
    if rng.random() < 0.3:
        tags[529] = (5, [(int(rng.integers(0, 2000)), 1000) for _ in range(3)])
    tile = ((16 * int(rng.integers(1, 3)), 16 * int(rng.integers(1, 3)))
            if rng.random() < 0.3 else None)
    return C.write_tiff(
        samples, 8, 6, compression=pick(rng, [1, 5, 8, 32773, 34925]),
        subsampling=sub, order=pick(rng, ["<", ">"]),
        rows_per_strip=int(rng.integers(1, h + 3)), tile=tile, tags=tags,
        orientation=int(rng.integers(1, 9)) if rng.random() < 0.2 else None)


def rnd_tiff_float(rng) -> bytes:
    """32-bit float and integer gray, 12-bit gray and CIELab: raw or
    compressed, predictors 1-3, either byte order."""
    h, w = int(rng.integers(1, 20)), int(rng.integers(1, 30))
    kind = pick(rng, ["float", "int", "12", "lab"])
    order = pick(rng, ["<", ">"])
    comp = pick(rng, [1, 5, 8, 34925, 32773])
    if kind == "float":
        v = (rng.standard_normal((h, w, 1)) * 200 + 100).astype(np.float32)
        v[rng.random((h, w, 1)) < 0.05] = np.nan
        bits, photo, fmt, pred = 32, pick(rng, [0, 1]), 3, pick(rng, [1, 2, 3])
    elif kind == "int":
        v = rng.integers(-300, 600, (h, w, 1))
        bits, photo, fmt, pred = 32, 1, pick(rng, [1, 2]), pick(rng, [1, 2, 3])
    elif kind == "12":
        v = rng.integers(0, 4096, (h, w, 1))
        bits, photo, fmt, pred = 12, 1, None, pick(rng, [1, 1, 2])
    else:
        v = rng.integers(0, 256, (h, w, 3))
        bits, photo, fmt, pred = 8, 8, None, pick(rng, [1, 2])
    if comp in (1, 32773):
        pred = 1
    tile = ((16 * int(rng.integers(1, 3)), 16 * int(rng.integers(1, 3)))
            if rng.random() < 0.3 else None)
    return C.write_tiff(v, bits, photo, compression=comp, predictor=pred,
                        order=order, sample_format=fmt, tile=tile,
                        rows_per_strip=int(rng.integers(1, h + 3)))


def rnd_tiff_jpeg(rng) -> bytes:
    """JPEG-in-TIFF: photometric 1, 2 and 6, strips or tiles, with or
    without JPEGTables, YCbCrSubsampling agreeing with the streams, absent
    or wrong."""
    h, w = int(rng.integers(1, 40)), int(rng.integers(1, 40))
    photo = pick(rng, [1, 2, 6, 6])
    img = C.sample_image(w, h, int(rng.integers(0, 1 << 16)), 3)
    if rng.random() < 0.2:
        img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    samples = img[..., :1] if photo == 1 else (
        C.rgb_to_ycbcr(img) if photo == 6 else img)
    n = samples.shape[-1]
    sampling = [(1, 1)] * n
    if photo == 6:
        sampling[0] = pick(rng, [(1, 1), (2, 1), (2, 2), (1, 2)])
    tags = {}
    sub = None
    if photo == 6 and rng.random() < 0.7:
        sub = sampling[0] if rng.random() < 0.8 else pick(rng, [(2, 2), (1, 1)])
    tile = ((16 * int(rng.integers(1, 3)), 16 * int(rng.integers(1, 3)))
            if rng.random() < 0.4 else None)
    return C.write_tiff(
        samples, 8, photo, compression=7, subsampling=sub, tile=tile,
        rows_per_strip=8 * int(rng.integers(1, 4)), tags=tags,
        jpeg={"sampling": sampling, "quality": int(rng.integers(20, 100)),
              "tables": bool(rng.random() < 0.7)})


def rnd_tiff_zstd(rng) -> bytes:
    """zstd TIFFs: Pillow's libtiff writer (predictor 2 or none) or this
    suite's writer over libzstd at any level, with or without checksums,
    gray, RGB(A), 16-bit either byte order, float under predictor 3,
    YCbCr, separate planes, strips or tiles."""
    h, w = int(rng.integers(1, 40)), int(rng.integers(1, 40))
    img = C.sample_image(w, h, int(rng.integers(0, 1 << 16)), 4)
    if rng.random() < 0.3:
        img = rng.integers(0, 256, (h, w, 4)).astype(np.uint8)
    kind = pick(rng, ["pillow", "rgb", "gray16", "float", "ycbcr", "planes"])
    if kind == "pillow":
        mode = pick(rng, ["RGB", "RGBA", "L", "1", "I;16", "CMYK"])
        im = Image.fromarray(img).convert(mode) if mode != "I;16" else \
            Image.fromarray(img[..., 0].astype(np.uint16) * 251)
        info = {317: 2} if mode not in ("1",) and rng.random() < 0.5 else {}
        return C.pillow_bytes(im, "TIFF", compression="zstd", tiffinfo=info)
    level, check = int(rng.integers(-5, 20)), bool(rng.random() < 0.5)
    old = C.COMPRESS[50000]
    C.COMPRESS[50000] = lambda b: C.zstd_compress(b, level, check)
    try:
        tile = ((16 * int(rng.integers(1, 3)), 16 * int(rng.integers(1, 3)))
                if rng.random() < 0.3 else None)
        rps = int(rng.integers(1, h + 3))
        order = pick(rng, ["<", ">"])
        if kind == "rgb":
            return C.write_tiff(img[..., :3], 8, 2, compression=50000,
                                predictor=pick(rng, [1, 2]), tile=tile,
                                rows_per_strip=rps)
        if kind == "gray16":
            return C.write_tiff(img[..., :1].astype(np.uint16) * 257, 16, 1,
                                compression=50000, order=order,
                                predictor=pick(rng, [1, 2]),
                                sample_format=pick(rng, [None, 2]),
                                tile=tile, rows_per_strip=rps)
        if kind == "float":
            return C.write_tiff(C.float_gray(w, h, int(rng.integers(99))),
                                32, 1, compression=50000, sample_format=3,
                                predictor=pick(rng, [1, 3]), order=order,
                                rows_per_strip=rps)
        if kind == "ycbcr":
            sub = pick(rng, [(1, 1), (2, 1), (2, 2), (4, 4)])
            return C.write_tiff(C.rgb_to_ycbcr(img[..., :3]), 8, 6,
                                compression=50000, subsampling=sub,
                                rows_per_strip=sub[1] * int(
                                    rng.integers(1, 4)))
        bits = pick(rng, [8, 16])
        v = img if bits == 8 else img.astype(np.uint16) * 257
        n = pick(rng, [2, 3, 4])
        photo = {2: 1, 3: 2, 4: 2}[n]
        extra = (2,) if n in (2, 4) else ()
        return C.write_tiff(v[..., :n], bits, photo, compression=50000,
                            planar=2, extra=extra, tile=tile,
                            rows_per_strip=rps)
    finally:
        C.COMPRESS[50000] = old


def rnd_tiff_ojpeg(rng) -> bytes:
    """Old-style JPEG TIFFs in both layouts: 4:2:0, 4:2:2, 4:4:4 or gray,
    strips or tiles, with or without the restart interval, the sample
    count, the photometric Pillow forces, YCbCrSubsampling agreeing or
    not, JPEGInterchangeFormatLength wrong."""
    w = 16 * int(rng.integers(1, 4))
    h = 16 * int(rng.integers(1, 4))
    img = C.sample_image(w, h, int(rng.integers(0, 1 << 16)), 3)
    if rng.random() < 0.2:
        img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    gray = rng.random() < 0.2
    kw = {"layout": pick(rng, ["jif", "tables"]),
          "sampling": pick(rng, [(1, 1), (2, 1), (2, 2)]),
          "quality": int(rng.integers(30, 98)),
          "restart_tag": bool(rng.random() < 0.85),
          "spp_tag": bool(rng.random() < 0.85)}
    if rng.random() < 0.3:
        kw["tile"] = (16, 16) if kw["sampling"] != (1, 1) or rng.random() < .5 \
            else (16, 8)
    else:
        kw["rows_per_strip"] = 16 * int(rng.integers(1, h // 16 + 1))
    if gray:
        kw["photometric"] = 1
        img = img[..., :1]
    elif rng.random() < 0.15:
        kw["photometric"] = pick(rng, [2, 6, 0])
    tags = {}
    if rng.random() < 0.15:
        tags[530] = (3, list(pick(rng, [(1, 1), (2, 1), (2, 2)])))
    if rng.random() < 0.1:
        tags[514] = (4, [int(rng.integers(0, 2000))])
    kw["tags"] = tags
    return C.write_ojpeg(img, **kw)


def zstd_case(rng) -> tuple:
    """A frame libzstd writes (any level, checksum, content size, window)
    over random, low-entropy, image or text bytes, a quarter mutated, and
    a strip's room for libtiff's stream loop."""
    n = int(pick(rng, [0, 1, 7, 100, 1000, 6000, 40000]))
    kind = int(rng.integers(0, 4))
    if kind == 0:
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    elif kind == 1:
        data = (rng.integers(0, 4, n, dtype=np.uint8) * 40).tobytes()
    elif kind == 2:
        data = C.sample_image(max(1, n // 12), 4, int(rng.integers(99)),
                              3).tobytes()[:n]
    else:
        words = [b"zstd", b"frame", b"literal", b" ", b"sequence"]
        data = b"".join(words[int(i)] for i in rng.integers(0, 5, n))[:n]
    frame = C.zstd_compress(data, int(rng.integers(-5, 23)),
                            bool(rng.random() < 0.5), bool(rng.random() < 0.7),
                            int(pick(rng, [0, 0, 10, 17])))
    if rng.random() < 0.75:
        frame = mutate(frame, rng)
    return frame, max(1, len(data) - int(pick(rng, [0, 0, 1, 5])))


def run_zstd(args) -> int:
    """``--kind zstd``: frames alone, the port's decoder (C++ and plain)
    against ``ZSTD_decompress`` and against libtiff's stream loop with a
    strip's room (a short or failed stream both refused)."""
    from wgpu_path_tracing_tpu_torch.utils import zstd

    rng = np.random.default_rng(args.seed)
    counts = {"same": 0, "both_raise": 0, "bad": 0}
    for i in range(args.n):
        frame, limit = zstd_case(rng)
        want = C.libzstd_decompress(frame, 1 << 24)
        stream = C.libzstd_stream(frame, limit)
        if stream is not None and len(stream) < limit:
            stream = None
        bad = False
        for fn in (native.zstd_native, zstd.zstd_plain):
            for lim, ref in ((None, want), (limit, stream)):
                try:
                    got = fn(frame, lim)
                except zstd.ZstdError:
                    got = None
                if lim is not None and got is not None and len(got) < lim:
                    got = None
                bad |= got != ref
        if bad:
            counts["bad"] += 1
            os.makedirs(OUT_DIR, exist_ok=True)
            path = os.path.join(OUT_DIR, f"zstd_s{args.seed}_{i}.zst")
            with open(path, "wb") as f:
                f.write(frame)
            print(f"BAD (room {limit}): {path}")
        else:
            counts["same" if want is not None else "both_raise"] += 1
    print("zstd", counts)
    return 1 if counts["bad"] else 0


def rnd_tiff_fax(rng) -> bytes:
    """CCITT modified Huffman, T.4 (1-D and 2-D, fill bits) and T.6, in
    strips or tiles, either photometric and fill order."""
    h, w = int(rng.integers(1, 30)), int(rng.integers(1, 90))
    b = (rng.random((h, w)) < rng.random()).astype(np.uint8)
    if rng.random() < 0.5:
        b = (C.sample_image(w, h, int(rng.integers(0, 1 << 16)), 1)[..., 0]
             > int(rng.integers(60, 200))).astype(np.uint8)
    comp = pick(rng, [2, 3, 4])
    tile = ((16 * int(rng.integers(1, 3)), 16 * int(rng.integers(1, 3)))
            if rng.random() < 0.2 else None)
    return C.write_tiff(
        b[..., None], 1, pick(rng, [0, 1]), compression=comp,
        fax_options=pick(rng, [0, 1, 4, 5]) if comp == 3 else 0,
        fill=pick(rng, [1, 1, 2]), tile=tile, order=pick(rng, ["<", ">"]),
        rows_per_strip=int(rng.integers(1, h + 3)))


def rnd_tiff_oldlzw(rng) -> bytes:
    """Old-style LZW (libtiff's LZWDecodeCompat), with predictor 2 at 8
    and 16 bits, and files mixing old- and new-style strips."""
    h, w = int(rng.integers(1, 30)), int(rng.integers(1, 60))
    bits = pick(rng, [8, 8, 16])
    spp = pick(rng, [1, 3, 4])
    samples = rng.integers(0, 1 << bits, (h, w, spp)).astype(
        np.uint16 if bits == 16 else np.uint8)
    if rng.random() < 0.5:
        samples = np.repeat(samples[:, :1], w, 1)
    photo = 1 if spp == 1 else 2
    data = C.write_tiff(samples, bits, photo, compression=5, old_lzw=True,
                        predictor=pick(rng, [1, 2]),
                        extra=(2,) if spp == 4 else (),
                        rows_per_strip=int(rng.integers(1, h + 3)))
    if rng.random() < 0.2:  # a new-style file, its first strip old-style
        new = C.write_tiff(samples, bits, photo, compression=5,
                           extra=(2,) if spp == 4 else (),
                           rows_per_strip=int(rng.integers(1, h + 3)))
        return new if rng.random() < 0.5 else data
    return data


def rnd_image(rng, w: int, h: int) -> np.ndarray:
    """Seeded smooth content, or noise, with alpha opaque, binary or
    smooth."""
    img = C.sample_image(w, h, int(rng.integers(0, 1 << 16)))
    if rng.random() < 0.25:
        img = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    alpha = rng.random()
    if alpha < 0.4:
        img[..., 3] = 255
    elif alpha < 0.6:
        img[..., 3] = (img[..., 3] > 127) * 255
    return img


def rnd_webp_still(rng, w: int, h: int) -> bytes:
    img = rnd_image(rng, w, h)
    kind = rng.random()
    if kind < 0.3:
        return C.pillow_bytes(img, "WEBP", lossless=bool(rng.random() < 0.4),
                              quality=int(rng.integers(0, 101)),
                              method=int(rng.integers(0, 7)),
                              exact=bool(rng.random() < 0.5),
                              alpha_quality=int(rng.integers(0, 101)))
    if kind < 0.75:
        return C.libwebp_encode(
            img, lossless=int(rng.random() < 0.3),
            quality=float(rng.integers(0, 101)),
            method=int(rng.integers(0, 7)), segments=int(rng.integers(1, 5)),
            sns_strength=int(rng.integers(0, 101)),
            filter_strength=int(rng.integers(0, 101)),
            filter_sharpness=int(rng.integers(0, 8)),
            filter_type=int(rng.integers(0, 2)),
            autofilter=int(rng.random() < 0.3),
            alpha_compression=int(rng.integers(0, 2)),
            alpha_filtering=int(rng.integers(0, 3)),
            alpha_quality=int(rng.integers(0, 101)),
            partitions=int(rng.integers(0, 4)),
            preprocessing=int(rng.integers(0, 3)),
            near_lossless=int(pick(rng, [100, 100,
                                         int(rng.integers(0, 101))])),
            exact=int(rng.integers(0, 2)),
            use_sharp_yuv=int(rng.integers(0, 2)))
    names = ["subtract_green", "predictor", "cross_color"]
    transforms = tuple(str(t) for t in rng.permutation(names)[
        :int(rng.integers(0, 4))])
    if rng.random() < 0.3:
        colours = int(rng.integers(1, 40))
        pal = rng.integers(0, 256, (colours, 4)).astype(np.uint8)
        img = pal[rng.integers(0, colours, (h, w))]
        transforms = ("palette",) + transforms[:1]
    return C.write_vp8l(img, transforms=transforms,
                        cache=int(pick(rng, [0, 0, 1, 4, 11])),
                        seed=int(rng.integers(0, 1000)),
                        bits=int(rng.integers(2, 5)),
                        alpha_used=bool(rng.random() < 0.8))


def rnd_webp(rng) -> bytes:
    """A still (Pillow, libwebp with random options, or this suite's VP8L
    writer), or an animation whose frames sit at random offsets."""
    w, h = int(rng.integers(1, 40)), int(rng.integers(1, 30))
    if rng.random() < 0.8:
        return rnd_webp_still(rng, w, h)
    canvas = (w + int(rng.integers(0, 12)), h + int(rng.integers(0, 12)))
    frames = []
    for _ in range(int(rng.integers(1, 4))):
        fw, fh = int(rng.integers(1, w + 1)), int(rng.integers(1, h + 1))
        x = 2 * int(rng.integers(0, (canvas[0] - fw) // 2 + 1))
        y = 2 * int(rng.integers(0, (canvas[1] - fh) // 2 + 1))
        frames.append((x, y, rnd_webp_still(rng, fw, fh),
                       int(rng.integers(0, 100)), int(rng.integers(0, 4))))
    return C.write_animated_webp(frames, canvas,
                                 flags=pick(rng, [0x12, 0x02, 0x12, 0x32]))


def rnd_gif(rng) -> bytes:
    """A frame of random indices through this suite's writer (code size,
    palettes, transparency, interlace, offset, extensions, literal codes),
    or Pillow's writer, one frame or several."""
    w, h = int(rng.integers(1, 40)), int(rng.integers(1, 30))
    if rng.random() < 0.25:
        img = Image.fromarray(rnd_image(rng, w, h))
        mode = pick(rng, ["P", "L", "RGB", "RGBA", "1", "LA"])
        im = img.convert(mode)
        buf = io.BytesIO()
        if rng.random() < 0.3:
            more = [Image.fromarray(rnd_image(rng, w, h)).convert(mode)]
            im.save(buf, "GIF", save_all=True, append_images=more,
                    interlace=bool(rng.random() < 0.5),
                    disposal=int(rng.integers(0, 4)))
        else:
            im.save(buf, "GIF", interlace=bool(rng.random() < 0.5))
        return buf.getvalue()
    bits = int(pick(rng, [1, 2, 3, 4, 5, 6, 7, 8, 8, 8, 0, 9, 12]))
    top = 1 if bits == 0 else 1 << min(bits, 8)
    idx = rng.integers(0, top, (h, w)).astype(np.uint8)
    if rng.random() < 0.5:
        idx[: h // 2] = idx[0, 0]

    def palette():
        r = rng.random()
        n = int(pick(rng, [2, 4, 8, 16, 256]))
        if r < 0.2:
            return np.repeat(np.arange(n, dtype=np.uint8)[:, None], 3, 1)
        return rng.integers(0, 256, (n, 3))

    screen = (max(1, w + int(rng.integers(-5, 8))),
              max(1, h + int(rng.integers(-5, 8))))
    ext = b""
    if rng.random() < 0.3:
        ext = pick(rng, [b"!\xfe\x03abc\x00",
                         b"!\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00",
                         b"\x00!\x01\x02ab\x00",
                         b"!\xf9\x04\x00\x00\x00\x00\x00"])
    return C.write_gif(
        idx, screen=screen,
        offset=(int(rng.integers(0, 6)), int(rng.integers(0, 6))), bits=bits,
        global_palette=palette() if rng.random() < 0.7 else None,
        local_palette=palette() if rng.random() < 0.3 else None,
        transparency=(int(rng.integers(0, max(top, 2)))
                      if rng.random() < 0.4 else None),
        interlace=bool(rng.random() < 0.4),
        literal=bool(rng.random() < 0.2 and bits >= 2), extensions=ext,
        version=pick(rng, [b"GIF89a", b"GIF87a"]))


def rnd_qoi(rng) -> bytes:
    """An encoded image or random ops, under any channel count, the end
    marker kept, cut or gone."""
    w, h = int(rng.integers(1, 12)), int(rng.integers(1, 9))
    channels = pick(rng, [3, 4, 4, 0, 5])
    if rng.random() < 0.6:
        ops = C.qoi_ops(rnd_image(rng, w, h), 3 if channels == 3 else 4)
    else:
        ops = bytes(pick(rng, [0xFE, 0xFF, int(rng.integers(0, 256))])
                    for _ in range(int(rng.integers(1, 4 * w * h))))
        ops = b"".join(bytes([b]) + rand_bytes(rng, 4 if b == 0xFF else 3
                                               if b == 0xFE else 0)
                       for b in ops)
    return C.write_qoi(w, h, ops, channels=channels,
                       colourspace=int(rng.integers(0, 3)),
                       end=pick(rng, [b"\0" * 7 + b"\1", b"", b"\0\0"]))


def rnd_pcx(rng) -> bytes:
    """A PCX of any bit and plane count, version, header stride, box and
    trailer, rows run-length coded or random, sometimes in a DCX."""
    w, h = int(rng.integers(1, 20)), int(rng.integers(1, 8))
    if rng.random() < 0.8:  # a mode Pillow reads
        bits, planes = pick(rng, [(1, 1), (1, 2), (1, 4), (8, 1), (8, 3)])
        version = 5 if bits == 8 else pick(rng, [0, 2, 3, 5])
    else:
        bits, planes = pick(rng, [1, 2, 4, 8]), pick(rng, [1, 2, 3, 4])
        version = pick(rng, [5, 0, 2, 3])
    stride = (w * bits + 7) // 8
    told = pick(rng, [stride, stride, stride + 1, max(stride - 1, 0),
                      stride + (stride % 2)])
    real = stride + (stride % 2 if told != stride else 0)
    rows = rng.integers(0, 256, (h, planes * real), dtype=np.uint8)
    if rng.random() < 0.5:
        rows[:, :] = rows[:, :1]
    data = None if rng.random() < 0.8 else rand_bytes(
        rng, int(rng.integers(0, 3 * h * planes * real)))
    trailer = None
    r = rng.random()
    if r < 0.3:
        trailer = b"\x0c" + np.repeat(np.arange(256, dtype=np.uint8),
                                      3).tobytes()
    elif r < 0.6:
        trailer = bytes([pick(rng, [12, 12, 11])]) + rand_bytes(rng, 768)
    data = C.write_pcx(rows, w, bits, planes, version=version, stride=told,
                       palette16=rand_bytes(rng, 48), trailer=trailer,
                       origin=(int(rng.integers(0, 3)),
                               int(rng.integers(0, 3))), data=data)
    if rng.random() < 0.2:
        data = C.write_dcx([data] * int(rng.integers(1, 3)))
    return data


def rnd_sgi(rng) -> bytes:
    """An SGI of any mode, raw or RLE (or an unknown compression), its row
    tables sometimes shared, reordered or random."""
    w, h = int(rng.integers(1, 10)), int(rng.integers(1, 7))
    z = pick(rng, [1, 3, 4, 2] if rng.random() < 0.2 else [1, 3, 4])
    bpc = pick(rng, [1, 2, 3] if rng.random() < 0.2 else [1, 2])
    px = rnd_image(rng, w, h)[..., :1].repeat(4, -1)[..., :z] if rng.random(
    ) < 0.3 else np.resize(rnd_image(rng, w, h), (h, w, z))
    px = px.astype(np.uint16) * 257 if bpc == 2 else px
    rle = rng.random() < 0.6
    data = C.write_sgi(px, min(bpc, 2), rle,
                       dimension=(pick(rng, [1, 2, 3]) if rng.random() < 0.1
                                  else 1 if z == 1 and rng.random() < 0.3
                                  else None),
                       share_rows=bool(rng.random() < 0.3),
                       reverse_rows=bool(rng.random() < 0.3))
    d = bytearray(data)
    d[3] = bpc
    if rng.random() < 0.1:
        d[2] = int(rng.integers(2, 5))
    if rle and rng.random() < 0.2:  # a random table entry
        at = 512 + 4 * int(rng.integers(0, 2 * z * h))
        d[at:at + 4] = struct.pack(">I", int(rng.integers(0, len(d) + 20)))
    return bytes(d)


PSD_MODES = [(0, 1), (0, 8), (1, 8), (2, 8), (3, 8), (3, 8), (4, 8), (7, 8),
             (8, 8), (9, 8), (3, 16), (5, 8)]


def rnd_psd(rng) -> bytes:
    """A PSD of any colour mode and depth, channel count, colour data,
    resources, layer section and compression."""
    w, h = int(rng.integers(1, 12)), int(rng.integers(1, 7))
    mode, bits = pick(rng, PSD_MODES)
    need = {3: 3, 4: 4, 9: 3}.get(mode, 1)
    c = max(1, need + pick(rng, [0, 0, 1, 2, -1]))
    row = (w + 7) // 8 if bits == 1 else w
    planes = rng.integers(0, 256, (c, h, row), dtype=np.uint8)
    if rng.random() < 0.5:
        planes[:] = planes[:, :, :1]
    colour = pick(rng, [b"", rand_bytes(rng, 768), rand_bytes(rng, 10)])
    res = b"".join(C.psd_resource(int(rng.integers(1000, 1100)),
                                  rand_bytes(rng, int(rng.integers(0, 4))),
                                  rand_bytes(rng, int(rng.integers(0, 9))))
                   for _ in range(int(rng.integers(0, 3))))
    layers = pick(rng, [b"", struct.pack(">I", 0), rand_bytes(rng, 12)])
    data = C.write_psd(planes, mode, bits=bits,
                       compression=pick(rng, [0, 1, 1, 2]),
                       colour_data=colour, resources=res, layers=layers,
                       width=w)
    return data


DXGI_CODES = [70, 71, 72, 73, 74, 76, 77, 79, 80, 81, 82, 83, 84, 95, 96, 97,
              98, 99, 27, 28, 29, 2, 87]
FOURCCS = [b"DXT1", b"DXT3", b"DXT5", b"ATI1", b"BC4U", b"ATI2", b"BC5U",
           b"BC5S", b"BC4S", b"DXT2", b"\0\0\0\0"]
DDS_MASKS = MASKS + [(0xF00, 0xF0, 0xF, 0xF000), (0xFF,), (0x3, 0xC, 0x30, 0xC0)]


def rnd_dds(rng) -> bytes:
    """A DDS of any pixel format: masks of any bit count, luminance,
    palette, FourCC and DX10 codes (some Pillow does not implement), over
    random blocks or BC7 mode-6 blocks, a header size sometimes wrong."""
    w, h = int(rng.integers(1, 14)), int(rng.integers(1, 10))
    kind = pick(rng, ["masks", "lum", "pal", "fourcc", "dx10", "dx10",
                      "bc7"])
    blocks = ((w + 3) // 4) * ((h + 3) // 4)
    kw = {"header_size": 124 if rng.random() < 0.95 else pick(rng, [100, 0])}
    if kind == "masks":
        masks = pick(rng, DDS_MASKS)
        masks = (masks + (0, 0, 0, 0))[:4]
        bitcount = pick(rng, [8, 16, 24, 32, 0, 12, 40])
        alpha = DDPF_ALPHA if rng.random() < 0.5 else 0
        return C.write_dds(w, h, rand_bytes(rng, w * h * bitcount // 8),
                           flags=0x40 | alpha, bitcount=bitcount, masks=masks,
                           **kw)
    if kind == "lum":
        bitcount = pick(rng, [8, 16, 16, 32])
        alpha = DDPF_ALPHA if rng.random() < 0.7 else 0
        return C.write_dds(w, h, rand_bytes(rng, w * h * bitcount // 8),
                           flags=0x20000 | alpha, bitcount=bitcount, **kw)
    if kind == "pal":
        return C.write_dds(w, h, rand_bytes(rng, 1024 + w * h), flags=0x20,
                           bitcount=8, **kw)
    if kind == "bc7":
        img = rnd_image(rng, 4 * ((w + 3) // 4), 4 * ((h + 3) // 4))
        return C.write_dds(w, h, C.bc7_mode6(img), dxgi=98, **kw)
    size = 16
    if kind == "fourcc":
        fourcc = pick(rng, FOURCCS)
        size = 8 if fourcc in (b"DXT1", b"ATI1", b"BC4U") else 16
        return C.write_dds(w, h, C.random_blocks(blocks, size, int(
            rng.integers(0, 1 << 30))), fourcc=fourcc, flags=0x4, **kw)
    dxgi = pick(rng, DXGI_CODES)
    if dxgi in (70, 71, 79, 80):
        size = 8
    n = w * h if dxgi in (27, 28, 29) else blocks
    return C.write_dds(w, h, C.random_blocks(n, 4 if n == w * h else size,
                                             int(rng.integers(0, 1 << 30)),
                                             "BC6" if dxgi in (95, 96) else ""),
                       dxgi=dxgi, **kw)


DDPF_ALPHA = 0x1


def rnd_ftex(rng) -> bytes:
    """An FTEX of BC1 blocks or raw RGB (or another format), its format
    count, offset and mipmap size sometimes wrong."""
    w, h = int(rng.integers(0, 14)), int(rng.integers(1, 10))
    fmt = pick(rng, [0, 1, 0, 1, 2])
    need = ((w + 3) // 4) * ((h + 3) // 4) * 8 if fmt == 0 else 3 * w * h
    mip = rand_bytes(rng, need + pick(rng, [0, 0, 5, -3]))
    size = pick(rng, [None, None, -1, len(mip) + 9, max(len(mip) - 2, 0)])
    return C.write_ftex(w, h, fmt, mip, formats=pick(rng, [1, 1, 1, 2, 0]),
                        where=pick(rng, [32, 32, 40, 31, 900, -8]), size=size)


def rnd_blp(rng) -> bytes:
    """A BLP1 or BLP2 of any compression, encoding and alpha encoding:
    DXT over random or encoded blocks, palettes, JPEG split anywhere, the
    offset and length tables sometimes wrong."""
    w, h = int(rng.integers(0, 14)), int(rng.integers(1, 10))
    alpha = pick(rng, [0, 1, 8])
    pal = rand_bytes(rng, 1024)
    offset = None if rng.random() < 0.8 else int(rng.integers(0, 1400))
    if rng.random() < 0.35:  # BLP1
        comp = pick(rng, [0, 0, 1, 1, 2])
        if comp == 0:
            jpeg = C.pillow_bytes(rnd_image(rng, max(w, 1) + int(
                rng.integers(0, 3)), h)[..., :3], "JPEG",
                quality=int(rng.integers(30, 95)))
            return C.blp1_jpeg(jpeg, w, h, split=int(rng.integers(
                0, len(jpeg))), alpha=alpha, offset=offset)
        return C.write_blp1(w, h, rand_bytes(rng, w * h + pick(
            rng, [0, 3, -2])), compression=comp, alpha=alpha,
            encoding=pick(rng, [4, 5, 5, 3]), palette=pal, offset=offset)
    encoding = pick(rng, [1, 2, 2, 2, 3])
    ae = pick(rng, [0, 1, 7, 0, 7, 2])
    if encoding == 2:
        kind = {0: 1, 1: 3, 7: 5}.get(ae, 5)
        bw, bh = (w + 3) // 4, (h + 3) // 4
        if rng.random() < 0.5 and bw:
            payload = C.dxt_blocks(rnd_image(rng, 4 * bw, 4 * bh), kind)
        else:
            payload = C.random_blocks(bw * bh, 8 if kind == 1 else 16,
                                      int(rng.integers(0, 1 << 30)))
    else:
        payload = rand_bytes(rng, w * h + pick(rng, [0, 2, -1]))
    return C.write_blp2(w, h, payload, encoding=encoding, alpha=alpha,
                        alpha_encoding=ae, compression=pick(rng, [1, 1, 1, 0]),
                        palette=pal, offset=offset)


ICNS_RGB = {b"is32": (16, b"s8mk"), b"il32": (32, b"l8mk"),
            b"ih32": (48, b"h8mk"), b"it32": (128, b"t8mk")}


def rnd_icns(rng) -> bytes:
    """An ICNS of raw or run-length RGB entries, masks and PNG entries of
    any size, in any order, some entries cut or unknown, the file size
    sometimes wrong."""
    entries = []
    for _ in range(int(rng.integers(1, 4))):
        r = rng.random()
        if r < 0.5:
            kind = pick(rng, list(ICNS_RGB))
            n, mask = ICNS_RGB[kind]
            img = rnd_image(rng, n, n)
            entries.append((kind, C.icns_rgb(img[..., :3],
                                             rle=bool(rng.random() < 0.7),
                                             it32=kind == b"it32")))
            if rng.random() < 0.6:
                entries.append((mask, img[..., 3].tobytes()))
        elif r < 0.8:
            kind = pick(rng, [b"icp4", b"icp5", b"ic11", b"ic07", b"ic08"])
            n = pick(rng, [8, 16, 16, 32, 12])
            entries.append((kind, C.pillow_bytes(rnd_image(rng, n, n),
                                                 "PNG")))
        else:
            entries.append((pick(rng, [b"TOC ", b"s8mk", b"icnV"]),
                            rand_bytes(rng, int(rng.integers(0, 300)))))
    if rng.random() < 0.3:
        k = int(rng.integers(0, len(entries)))
        entries[k] = (entries[k][0], entries[k][1][:int(rng.integers(
            0, len(entries[k][1]) + 1))])
    data = C.write_icns(entries)
    if rng.random() < 0.15:
        data = data[:4] + struct.pack(">I", int(rng.integers(0, len(data)
                                                             + 50))) + data[8:]
    return data


def rnd_sun(rng) -> bytes:
    """A Sun raster of any depth and type, raw (padded or not) or RLE,
    with or without a colour map of any type and length."""
    w, h = int(rng.integers(0, 14)), int(rng.integers(1, 8))
    depth = pick(rng, [1, 4, 8, 24, 32, 8, 16])
    ftype = pick(rng, [0, 1, 2, 2, 3, 4, 5, 6])
    img = rnd_image(rng, max(w, 1), h)
    px = {1: img[..., 0] > 128, 4: img[..., 0] >> 4, 8: img[..., 0],
          16: img[..., :2], 24: img[..., :3], 32: img}[depth]
    rows = C.sun_rows(px[:, :w], depth, pad=ftype != 2 or rng.random() < 0.2)
    payload = C.sun_rle(rows) if ftype == 2 else rows.tobytes()
    if rng.random() < 0.3:
        payload = payload[:int(rng.integers(0, len(payload) + 1))]
    palette = b""
    if rng.random() < 0.3:
        palette = rand_bytes(rng, pick(rng, [3, 30, 768, 769, 771, 1030]))
    return C.write_sun(w, h, depth, payload, ftype=ftype, palette=palette,
                       ptype=pick(rng, [1, 1, 2, 0]))


def rnd_msp(rng) -> bytes:
    """An MSP, version 1 raw or version 2 run-length rows (some blank,
    long, short or cut), the checksum sometimes wrong."""
    w, h = int(rng.integers(0, 40)), int(rng.integers(1, 8))
    bits = rnd_image(rng, max(w, 1), h)[:, :w, 0] > 100
    if rng.random() < 0.3:
        data = C.msp_header(b"DanM", w, h) + np.packbits(
            bits, axis=1).tobytes()
    else:
        rows = [C.msp_lins_row(r.tobytes()) for r in np.packbits(bits,
                                                                 axis=1)]
        for _ in range(int(rng.integers(0, 3))):
            k = int(rng.integers(0, h))
            rows[k] = pick(rng, [b"", rows[k] + b"\x01\x5a", rows[k][:-1],
                                 b"\x00\x04", b"\x07\x01"])
        data = C.write_msp_lins(bits.astype(np.uint8), rows)
    if rng.random() < 0.1:
        data = data[:30] + bytes([data[30] ^ 1]) + data[31:]
    return data


def rnd_xbm(rng) -> bytes:
    """An XBM of any size and spelling of its bytes, with or without a
    hot spot and leading white space, its data sometimes cut."""
    w, h = int(rng.integers(0, 30)), int(rng.integers(1, 8))
    bits = rnd_image(rng, max(w, 1), h)[:, :w, 0] > 100
    data = C.write_xbm(bits, prefix=pick(rng, [b"", b" \n", b"\t"]),
                       hotspot=(1, 2) if rng.random() < 0.3 else None,
                       per_line=int(rng.integers(1, 16)),
                       fmt=pick(rng, ["0x{:02x}", "0x{:X}", "0x{:x}",
                                      "0xx{:02x}"]))
    if rng.random() < 0.2:
        data = data[:int(rng.integers(1, len(data)))]
    return data


def rnd_xpm(rng) -> bytes:
    """An XPM of up to 300 colours, keys of 1-3 bytes, a None key, colour
    lines of other spellings and pixel lines of any length."""
    w, h = int(rng.integers(0, 12)), int(rng.integers(1, 6))
    levels = pick(rng, [2, 3, 4, 7])
    img = rnd_image(rng, max(w, 1), h)[:, :max(w, 1), :3]
    idx, cols = C.quantize(img, levels)
    colours = C.xpm_colours(cols)
    if rng.random() < 0.2:
        colours += C.xpm_colours(rng.integers(0, 256, (int(rng.integers(
            1, 300)), 3), dtype=np.uint8))
    if rng.random() < 0.3:
        colours.insert(0, b"None")
        idx = idx + 1
    if rng.random() < 0.1:
        colours[int(rng.integers(0, len(colours)))] = pick(
            rng, [b"red", b"#fff", b"#zz"])
    bpp = max(int(rng.integers(1, 4)), 2 if len(colours) > 64 else 1)
    data = C.write_xpm(idx[:, :w] if w else idx[:, :0], colours, bpp=bpp,
                       comment=bool(rng.random() < 0.5))
    if rng.random() < 0.2:
        data = data.replace(b'",\n"', b'"\n"', 1)
    return data


def jpeg_scans(data: bytes) -> list:
    """(start of each scan's entropy-coded data, the marker after it)."""
    out, pos = [], 2
    while pos + 4 <= len(data):
        if data[pos] != 0xFF or data[pos + 1] in (0xD8, 0xD9):
            break
        length = struct.unpack_from(">H", data, pos + 2)[0]
        pos += 2 + length
        if data[pos - length - 1] != 0xDA:
            continue
        end = pos
        while end + 1 < len(data) and not (
                data[end] == 0xFF and data[end + 1] not in (
                    0, *range(0xD0, 0xD8))):
            end += 1
        out.append((pos, end))
        pos = end
    return out


def rnd_jpeg_source(rng) -> bytes:
    """A JPEG of any kind the reader takes: Pillow's baseline, optimized
    or progressive, with or without restart markers, gray or colour at
    any subsampling; this suite's progressive scripts, arithmetic-coded
    and lossless files, restart intervals on any MCU count."""
    from tests import torch_jpeg_cases as J

    w, h = int(rng.integers(1, 70)), int(rng.integers(1, 70))
    nc = pick(rng, [1, 3, 3, 3])
    kind = pick(rng, ["pillow", "pillow", "script", "arith", "lossless"])
    if kind == "pillow":
        img = rnd_image(rng, w, h)[..., :3]
        kw = {"quality": int(rng.integers(20, 98)),
              "progressive": bool(rng.random() < 0.5),
              "optimize": bool(rng.random() < 0.3),
              "subsampling": pick(rng, [0, 1, 2])}
        if rng.random() < 0.4:
            kw["restart_marker_blocks"] = int(rng.integers(1, 6))
        return C.pillow_bytes(img[..., 0] if nc == 1 else img, "JPEG", **kw)
    planes = J.sample_planes(w, h, nc, int(rng.integers(0, 1 << 30)))
    sampling = [(1, 1)] * nc if nc == 1 else pick(rng, [
        [(1, 1)] * 3, [(2, 2), (1, 1), (1, 1)], [(2, 1), (1, 1), (1, 1)]])
    if kind == "lossless":
        return J.write_lossless_jpeg(
            planes, sampling, predictor=int(rng.integers(1, 8)),
            pt=pick(rng, [0, 0, 1]), restart_rows=pick(rng, [0, 0, 1, 2]),
            interleaved=bool(rng.random() < 0.6))
    scans = None
    if kind == "script" or rng.random() < 0.5:
        scans = J.script_for(pick(rng, sorted(J.SCRIPTS)), nc)
    return J.write_jpeg(planes, sampling, quality=int(rng.integers(20, 95)),
                        restart=pick(rng, [0, 0, 1, 3, 7]), scans=scans,
                        interleaved=bool(rng.random() < 0.8),
                        arithmetic=kind == "arith")


def rnd_jpeg_cut(rng) -> bytes:
    """A JPEG whose scan data stops early: one scan (the last, or any)
    cut at any byte, then EOI, the rest of the file from the marker after
    that scan (the later scans kept), nothing, or data cut from one
    restart interval on; sometimes through a BLP1 or a JPEG-in-TIFF."""
    data = rnd_jpeg_source(rng)
    scans = jpeg_scans(data)
    start, end = scans[-1] if rng.random() < 0.5 else pick(rng, scans)
    cut = int(rng.integers(start, end + 1))
    rest = pick(rng, ["eoi", "eoi", "after", "none", "restarts"])
    if rest == "restarts":
        marks = [i for i in range(start, end - 1) if data[i] == 0xFF
                 and 0xD0 <= data[i + 1] <= 0xD7]
        cut = pick(rng, marks) if marks else cut
        rest = pick(rng, ["eoi", "after"])
    head = data[:cut]
    if head.endswith(b"\xff"):
        head = head[:-1]
    data = head + (b"\xff\xd9" if rest == "eoi" else data[end:]
                   if rest == "after" else b"")
    if rng.random() < 0.15:
        with Image.open(io.BytesIO(rnd_jpeg_source(rng))) as im:
            w, h = im.size
        return C.blp1_jpeg(data, w, h, split=int(rng.integers(0, len(data))))
    return data


def rnd_im(rng) -> bytes:
    """An IM file of any "Image type" Pillow knows (or not), a size,
    sometimes a palette ("Lut") of gray or colour, header lines in any
    spelling, data cut or not."""
    from wgpu_path_tracing_tpu_torch.utils import im as IM

    w, h = int(rng.integers(1, 24)), int(rng.integers(1, 16))
    itype = pick(rng, sorted(IM.OPEN) + ["L", "RGB", "Weird image"])
    data = rand_bytes(rng, int(4 * 8 * w * h * rng.random() * 1.3) + 1)
    lut = None
    if rng.random() < 0.3:
        lut = (bytes(range(256)) * 3 if rng.random() < 0.3
               else rand_bytes(rng, 768))
    extra = pick(rng, [b"", b"Name: x\r\n", b"File size (no of images): 2\r\n",
                       b"Comment: a\r\nComment: b\r\n", b"Bad line\r\n"])
    size = pick(rng, [None, None, b"%d" % w, b"%d,%d" % (w, h),
                      b"%d*%d*2" % (w, h), b"%d.5*%d" % (w, h)])
    return C.write_im(itype.encode(), w, h, data, lut=lut, extra=extra,
                      size=size, newline=pick(rng, [b"\r\n", b"\n"]),
                      pad=bool(rng.random() < 0.8))


def rnd_spider(rng) -> bytes:
    """A SPIDER image or stack in either byte order, header fields changed
    at random."""
    w, h = int(rng.integers(1, 30)), int(rng.integers(1, 20))
    v = ((rng.random((h, w)) - 0.2) * 400).astype(np.float32)
    data = bytearray(C.write_spider(v, bool(rng.random() < 0.5),
                                    stack=pick(rng, [0, 0, 1, 2])))
    if rng.random() < 0.3:
        order = ">" if data[:4] != bytes(4) and struct.unpack_from(
            ">f", data, 4)[0] == h else "<"
        k = int(rng.integers(0, 27))
        struct.pack_into(order + "f", data, 4 * k, pick(
            rng, [0.0, 1.0, 3.0, -1.0, 2.5, float(w), 1e30]))
    return bytes(data)


def rnd_fits(rng) -> bytes:
    """A FITS image of any BITPIX (some Pillow gives no mode), raw or
    GZIP_1, its cards changed or dropped."""
    w, h = int(rng.integers(1, 30)), int(rng.integers(1, 20))
    bitpix = pick(rng, [8, 16, 32, -32, -64])
    v = {8: rng.integers(0, 256, (h, w)),
         16: rng.integers(-2000, 2000, (h, w)),
         32: rng.integers(-1000, 70000, (h, w)),
         -32: (rng.random((h, w)) - 0.3) * 400,
         -64: (rng.random((h, w)) - 0.3) * 400}[bitpix]
    extra = pick(rng, [[], [(b"BZERO", b"0")], [(b"COMMENT", b"'x'")]])
    data = C.write_fits(v, bitpix, gzip_tile=bool(rng.random() < 0.3),
                        extra=extra)
    if rng.random() < 0.2:  # another BITPIX or NAXIS
        data = data.replace(b"BITPIX  =" + b"%21d" % bitpix, b"BITPIX  ="
                            + b"%21d" % pick(rng, [64, 12, 8, -32]), 1)
    if rng.random() < 0.1:
        data = data.replace(b"NAXIS   =                    2",
                            b"NAXIS   =                    1", 1)
    return data


def rnd_mcidas(rng) -> bytes:
    """A McIdas area of 1, 2 or 4 bytes a sample (or another count), with
    row prefixes and band strides."""
    w, h = int(rng.integers(1, 30)), int(rng.integers(1, 20))
    unit = pick(rng, [1, 2, 4])
    v = rng.integers(-100, 1 << (8 * min(unit, 3)), (h, w))
    data = bytearray(C.write_mcidas(v, unit, prefix=pick(rng, [0, 0, 2, 5]),
                                    bands=pick(rng, [1, 1, 2]),
                                    data_at=pick(rng, [256, 256, 300])))
    if rng.random() < 0.15:
        struct.pack_into(">i", data, 40, pick(rng, [3, 0, 8]))
    return bytes(data)


def rnd_gbr(rng) -> bytes:
    """A GIMP brush, version 1 or 2, gray or RGBA, the header's fields
    changed at random."""
    w, h = int(rng.integers(1, 30)), int(rng.integers(1, 20))
    px = rnd_image(rng, w, h)
    data = bytearray(C.write_gbr(px[..., 0] if rng.random() < 0.5 else px,
                                 pick(rng, [1, 2]),
                                 comment=rand_bytes(rng, int(rng.integers(
                                     0, 40)))))
    if rng.random() < 0.3:
        struct.pack_into(">I", data, 4 * int(rng.integers(0, 5)), pick(
            rng, [0, 1, 2, 3, 4, 19, 20, 27, 28, 100]))
    return bytes(data)


def rnd_xvthumb(rng) -> bytes:
    """An XV thumbnail with comment lines and a size line of any form."""
    w, h = int(rng.integers(1, 30)), int(rng.integers(1, 20))
    data = C.write_xvthumb(rng.integers(0, 256, (h, w)), comments=tuple(
        b"#c%d" % k for k in range(int(rng.integers(0, 3)))))
    if rng.random() < 0.2:
        data = data.replace(b"%d %d 255" % (w, h), pick(
            rng, [b"%d" % w, b"x y", b"%d %d" % (w, h), b"-1 3"]), 1)
    return data


def rnd_pixar(rng) -> bytes:
    """A PIXAR raster in mode (14, 2) or another."""
    w, h = int(rng.integers(1, 30)), int(rng.integers(1, 20))
    return C.write_pixar(rnd_image(rng, w, h)[..., :3],
                         mode=pick(rng, [(14, 2), (14, 2), (14, 1), (8, 2)]))


def rnd_imt(rng) -> bytes:
    """An IM Tools file, lines of any kind before the size."""
    w, h = int(rng.integers(1, 30)), int(rng.integers(1, 20))
    lines = tuple(pick(rng, [b"* comment", b"depth 8", b"x", b"",
                             b"width abc", b"pixel n16"])
                  for _ in range(int(rng.integers(0, 3))))
    return C.write_imt(rnd_image(rng, w, h)[..., 0], lines=lines)


def rnd_iptc(rng) -> bytes:
    """An IPTC/NAA file: raw or JPEG data, one layer or three or four
    with a band, fields split, repeated or missing."""
    w, h = int(rng.integers(1, 30)), int(rng.integers(1, 20))
    gray = rnd_image(rng, w, h)[..., 0]
    compression = pick(rng, [1, 1, 1, 5, 5, 2])
    image = gray.tobytes() if compression != 5 else C.pillow_bytes(
        gray if rng.random() < 0.7 else rnd_image(rng, w, h)[..., :3],
        "JPEG", quality=80)
    layers = pick(rng, [1, 1, 1, 3, 4, 2])
    extra = pick(rng, [b"", b"", C.iptc_field(2, 5, b"title"),
                       C.iptc_field(3, 60, b"\x01\x00")])
    return C.write_iptc(image, w, h, layers=layers,
                        component=int(layers > 1 and rng.random() < 0.9),
                        compression=compression,
                        band=pick(rng, [None, 0, 1, 2, 3, 4]),
                        split=int(rng.integers(0, len(image))),
                        extra=extra, extended=pick(rng, [0, 0, 0, 4]))


def rnd_pcd(rng) -> bytes:
    """A Photo CD base image of random YCC, any orientation, cut or not."""
    data = C.write_pcd(rng.integers(0, 256, (512, 768)),
                       rng.integers(0, 256, (256, 384)),
                       rng.integers(0, 256, (256, 384)),
                       int(rng.integers(0, 256)))
    if rng.random() < 0.2:
        data = data[:int(rng.integers(2048, len(data)))]
    return data


def rnd_fli(rng) -> bytes:
    """An FLI or FLC first frame of BRUN, COPY, LC, SS2, BLACK, colour and
    stamp chunks over random or smooth indices, some cut or corrupt."""
    w = 2 * int(rng.integers(1, 16))
    h = int(rng.integers(1, 12))
    a = rnd_image(rng, w, h)[..., 0]
    b = a.copy()
    b[rng.random((h, w)) < 0.3] = rng.integers(0, 256)
    chunks = []
    if rng.random() < 0.7:
        chunks.append(C.fli_colors(rng.integers(0, 256, (int(rng.integers(
            1, 257)), 3)), pick(rng, [4, 11]), skip=int(rng.integers(0, 3))))
    first = pick(rng, ["brun", "copy", "black", "none"])
    if first == "brun":
        chunks.append(C.fli_brun(a))
    elif first == "copy":
        chunks.append(C.fli_chunk(16, a.tobytes()))
    elif first == "black":
        chunks.append(C.fli_chunk(13, b""))
    delta = pick(rng, ["lc", "ss2", "none", "stamp"])
    if delta == "lc":
        chunks.append(C.fli_lc(b, a, int(rng.integers(0, h))))
    elif delta == "ss2":
        chunks.append(C.fli_ss2(b, a, bool(rng.random() < 0.5)))
    elif delta == "stamp":
        chunks.append(C.fli_chunk(18, rand_bytes(rng, 10)))
    if rng.random() < 0.1:
        chunks.append(C.fli_chunk(int(rng.integers(0, 30)), rand_bytes(
            rng, 8)))
    return C.write_fli(w, h, chunks, magic=pick(rng, [0xAF11, 0xAF12]),
                       frames=pick(rng, [1, 1, 2, 0]))


def forked(fn):
    """``fn()`` in a child process -> its result, or ("crash", status)
    where the child dies (OpenJPEG's encoder asserts or faults on some
    option sets, and its decoder on some mutated files)."""
    import pickle

    r, w = os.pipe()
    pid = os.fork()
    if pid == 0:
        os.close(r)
        try:
            out = ("ok", fn())
        except Exception as exc:
            out = ("error", f"{type(exc).__name__}: {str(exc)[:80]}")
        with os.fdopen(w, "wb") as f:
            pickle.dump(out, f)
        os._exit(0)
    os.close(w)
    with os.fdopen(r, "rb") as f:
        raw = f.read()
    _, status = os.waitpid(pid, 0)
    return pickle.loads(raw) if raw else ("crash", status)


def _j2k_options(rng) -> dict:
    """Random options of Pillow's JPEG 2000 writer."""
    kw = {}
    if rng.random() < 0.5:
        kw["irreversible"] = True
    if rng.random() < 0.5:
        kw["progression"] = pick(rng, ["LRCP", "RLCP", "RPCL", "PCRL",
                                      "CPRL"])
    if rng.random() < 0.3:
        kw["tile_size"] = (int(rng.integers(8, 40)), int(rng.integers(8, 40)))
        if rng.random() < 0.5:
            kw["tile_offset"] = (int(rng.integers(0, 5)),
                                 int(rng.integers(0, 5)))
            kw["offset"] = kw["tile_offset"]
    if rng.random() < 0.3 and "offset" not in kw:
        kw["offset"] = (int(rng.integers(0, 9)), int(rng.integers(0, 9)))
    if rng.random() < 0.4:
        kw["num_resolutions"] = int(rng.integers(1, 5))
    if rng.random() < 0.4:
        kw["codeblock_size"] = (int(2 ** rng.integers(2, 7)),
                                int(2 ** rng.integers(2, 7)))
    if rng.random() < 0.3:
        kw["precinct_size"] = (int(2 ** rng.integers(5, 9)),
                               int(2 ** rng.integers(5, 9)))
    if rng.random() < 0.4:
        kw["quality_mode"] = pick(rng, ["rates", "dB"])
        layers = [float(rng.integers(1, 60))
                  for _ in range(int(rng.integers(1, 4)))]
        kw["quality_layers"] = sorted(layers, reverse=kw["quality_mode"]
                                      == "rates")
    if rng.random() < 0.3:
        kw["mct"] = int(rng.integers(0, 2))
    if rng.random() < 0.2:
        kw["signed"] = True
    if rng.random() < 0.2:
        kw["plt"] = True
    if rng.random() < 0.1:
        kw["comment"] = "fuzz"
    return kw


def _j2k_image(rng):
    from PIL import Image

    w, h = int(rng.integers(1, 40)), int(rng.integers(1, 40))
    mode = pick(rng, ["L", "LA", "RGB", "RGBA", "I;16"])
    if mode == "I;16":
        v = rnd_image(rng, w, h)[..., 0].astype(np.uint16)
        return Image.fromarray(v * int(rng.integers(1, 257))).convert("I;16")
    return Image.fromarray(rnd_image(rng, w, h)).convert(mode)


def _opj_case(rng) -> bytes:
    """A file of libopenjp2's encoder with the options Pillow never sets
    (``tools/j2k_fixtures.py``), or a rewrite of one."""
    import j2k_fixtures as F

    w, h = int(rng.integers(2, 36)), int(rng.integers(2, 36))
    nc = int(rng.integers(1, 5))
    img = rnd_image(rng, w, h)
    kw = {"mode": int(rng.integers(0, 64)) if rng.random() < 0.6 else 0,
          "irreversible": bool(rng.random() < 0.5),
          "numres": int(rng.integers(1, 4)),
          "cblk": (int(2 ** rng.integers(2, 6)), int(2 ** rng.integers(2, 6))),
          "rates": pick(rng, [None, [20, 5], [40, 10, 2]]),
          "csty": pick(rng, [0, 0, 2, 4, 6]),
          "prog": pick(rng, list(F.PROGRESSIONS))}
    dx, dy = [1] * nc, [1] * nc
    if nc >= 3 and rng.random() < 0.3:
        dx[1] = dx[2] = int(rng.integers(1, 3))
        dy[1] = dy[2] = int(rng.integers(1, 3))
    if rng.random() < 0.2:
        kw["roi"] = (int(rng.integers(0, nc)), int(rng.integers(1, 9)))
    if rng.random() < 0.2:
        kw["tile"] = (int(rng.integers(8, 24)), int(rng.integers(8, 24)))
        kw["tp_flag"] = pick(rng, [None, "R", "C", "L"])
    planes = [img[::dy[i], ::dx[i], i % 4].astype(np.int32)
              for i in range(nc)]
    planes = [p[:-(-h // dy[i]), :-(-w // dx[i])] for i, p in
              enumerate(planes)]
    data = F.opj_encode(planes, width=w, height=h, dx=dx, dy=dy,
                        colour=2 if nc < 3 else 1, **kw)
    if "tile" not in kw and not kw["csty"] and rng.random() < 0.4:
        data = pick(rng, [lambda d: F.with_ppt(d, int(rng.integers(1, 3))),
                          lambda d: F.with_ppm(d, int(rng.integers(1, 3))),
                          lambda d: F.split_tile_parts(
                              d, int(rng.integers(1, 4)),
                              bool(rng.random() < 0.5)),
                          lambda d: F.with_sop(d, bool(rng.random() < 0.5))
                          ])(data)
    return data


def rnd_j2k(rng) -> bytes:
    """A J2K codestream: Pillow's writer with random options, or
    libopenjp2's encoder with code-block styles, SOP/EPH, ROI,
    subsampling and tile-parts, some with headers moved into PPT/PPM or
    cut into tile-parts."""
    while True:
        if rng.random() < 0.5:
            img, kw = _j2k_image(rng), _j2k_options(rng)
            kw["no_jp2"] = True
            got = forked(lambda: C.pillow_bytes(img, "JPEG2000", **kw))
        else:
            seed = int(rng.integers(0, 1 << 30))
            got = forked(lambda: _opj_case(np.random.default_rng(seed)))
        if got[0] == "ok":
            return got[1]


def rnd_jp2(rng) -> bytes:
    """A JP2 file: Pillow's, or a codestream under random boxes (``colr``
    of each enumerated space or an ICC profile, ``pclr`` and ``cmap``,
    ``cdef``, ``res``, an ``ihdr`` that disagrees, boxes out of order)."""
    import j2k_fixtures as F

    if rng.random() < 0.4:
        while True:
            img, kw = _j2k_image(rng), _j2k_options(rng)
            got = forked(lambda: C.pillow_bytes(img, "JPEG2000", **kw))
            if got[0] == "ok":
                return got[1]
    cs = rnd_j2k(rng)
    from wgpu_path_tracing_tpu_torch.utils import jpeg2000 as J

    try:
        c = J._Codestream(cs)
        nc, w, h = c.nc, c.x1 - c.x0, c.y1 - c.y0
        bpc = c.prec[0] - 1 | (c.sgnd[0] << 7)
    except Exception:
        nc, w, h, bpc = 3, 8, 8, 7
    if rng.random() < 0.2:
        nc = int(rng.integers(1, 6))
    if rng.random() < 0.1:
        w, h = w + int(rng.integers(-2, 3)), h + int(rng.integers(-2, 3))
    boxes = [F.ihdr(max(w, 0), max(h, 0), nc, bpc)]
    enumcs = pick(rng, [16, 17, 18, 12, 24, 0])
    if rng.random() < 0.1:
        boxes.append(F.box(b"colr", b"\x02\x00\x00" + rand_bytes(rng, 20)))
    elif rng.random() < 0.95:
        boxes.append(F.colr(enumcs))
    if rng.random() < 0.25:
        ne = int(rng.integers(1, 40))
        npc = int(pick(rng, [3, 3, 4, 1]))
        boxes.append(F.pclr(rng.integers(0, 256, (ne, npc)),
                            pick(rng, [8, 8, 4, 12])))
        if rng.random() < 0.8:
            boxes.append(F.cmap([(0, 1, i) for i in range(npc)]))
    if rng.random() < 0.2:
        boxes.append(F.cdef([(i, int(rng.integers(0, 3)),
                              int(rng.integers(0, nc + 1)))
                             for i in range(nc)]))
    if rng.random() < 0.2:
        boxes.append(F.res(int(rng.integers(0, 9)), int(rng.integers(0, 3)),
                           int(rng.integers(0, 5))))
    if rng.random() < 0.1:
        boxes = boxes[1:] + boxes[:1]
    return F.jp2(cs, b"".join(boxes))


GEN = {"tga": rnd_tga, "bmp": rnd_bmp, "icon": rnd_icon, "ppm": rnd_ppm,
       "tiff": rnd_tiff, "tiff_big": rnd_tiff_big, "tiff_ycbcr": rnd_tiff_ycbcr,
       "tiff_float": rnd_tiff_float, "tiff_jpeg": rnd_tiff_jpeg,
       "tiff_fax": rnd_tiff_fax, "tiff_oldlzw": rnd_tiff_oldlzw,
       "webp": rnd_webp, "gif": rnd_gif, "qoi": rnd_qoi, "pcx": rnd_pcx,
       "sgi": rnd_sgi, "psd": rnd_psd, "dds": rnd_dds, "ftex": rnd_ftex,
       "blp": rnd_blp, "icns": rnd_icns, "sun": rnd_sun, "msp": rnd_msp,
       "xbm": rnd_xbm, "xpm": rnd_xpm, "jpeg_cut": rnd_jpeg_cut,
       "im": rnd_im, "spider": rnd_spider, "fits": rnd_fits,
       "mcidas": rnd_mcidas, "gbr": rnd_gbr, "xvthumb": rnd_xvthumb,
       "pixar": rnd_pixar, "imt": rnd_imt, "iptc": rnd_iptc, "pcd": rnd_pcd,
       "fli": rnd_fli, "j2k": rnd_j2k, "jp2": rnd_jp2,
       "tiff_zstd": rnd_tiff_zstd, "tiff_ojpeg": rnd_tiff_ojpeg}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kind", default="mut", choices=[*GEN, "zstd", "mut"])
    ap.add_argument("--n", type=int, default=2000)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--pillow-seconds", type=float, default=30.0,
                    help="skip a case Pillow takes longer than this on")
    args = ap.parse_args(argv)
    resource.setrlimit(resource.RLIMIT_AS, (3 << 30, 3 << 30))
    warnings.simplefilter("ignore")
    if args.kind == "zstd":
        return run_zstd(args)
    rng = np.random.default_rng(args.seed)
    fixtures = list(C.fixtures().values())
    counts = {"same": 0, "both_raise": 0, "gap": 0, "bad": 0,
              "pillow_timeout": 0, "pillow_crash": 0}
    gaps: dict = {}
    for _ in range(args.n):
        if args.kind == "mut":
            data = mutate(fixtures[int(rng.integers(0, len(fixtures)))], rng)
        else:
            data = GEN[args.kind](rng)
            if rng.random() < 0.25:
                data = mutate(data, rng)
        try:
            if args.kind in ("j2k", "jp2") or data.startswith(
                    (b"\xff\x4f\xff\x51", b"\x00\x00\x00\x0cjP")):
                got = forked(lambda: pillow(data, args.pillow_seconds))
                if got[0] == "crash":
                    counts["pillow_crash"] += 1
                    continue
                if got[0] == "error":
                    raise PillowTimeout()
                want, why = got[1]
            else:
                want, why = pillow(data, args.pillow_seconds)
        except PillowTimeout:
            counts["pillow_timeout"] += 1
            continue
        verdict = None
        for in_cxx in (True, False):
            got, err = port(data, in_cxx)
            if got is not None and (want is None or got.shape != want.shape
                                    or not np.array_equal(got, want)):
                verdict = "bad"
                break
            if got is None and want is not None:
                verdict = "gap"
                gaps[err] = gaps.get(err, 0) + 1
                break
        if verdict is None:
            verdict = "same" if want is not None else "both_raise"
        counts[verdict] += 1
        if verdict == "bad":
            os.makedirs(OUT_DIR, exist_ok=True)
            path = os.path.join(OUT_DIR, f"{args.kind}_s{args.seed}_"
                                f"{counts['bad']}.bin")
            with open(path, "wb") as f:
                f.write(data)
            print(f"BAD ({'C++' if in_cxx else 'Python'}; Pillow: {why}): "
                  f"{path}")
    print(args.kind, counts)
    for err, n in sorted(gaps.items(), key=lambda kv: -kv[1])[:20]:
        print(f"  gap x{n}: {err}")
    return 1 if counts["bad"] else 0


if __name__ == "__main__":
    sys.exit(main())
