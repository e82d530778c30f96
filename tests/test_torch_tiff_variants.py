"""TIFF's other variants in the port's reader (``utils/tiff.py``,
``utils/fax.py``, ``utils/lab.py``) against Pillow 12.1.0 with libtiff
4.7.1, which the JAX package reads LDR images with: JPEG-in-TIFF, YCbCr,
CIELab, float, 32-bit and 12-bit samples, BigTIFF, old-style LZW, CCITT
and LZMA; and the env map and the atlas of such files against the JAX
package's.

Every case is held array-equal to ``Image.open(...).convert("RGBA")`` and
decoded twice: with the C++ loops (``accel/cbvh/image_scan.cpp``'s LZW,
``fax_scan.cpp``, ``jpeg_scan.cpp``) and with their plain Python
versions. Pillow writes JPEG (RGB, gray, YCbCr), CCITT, BigTIFF, float,
32-bit, CIELab and LZMA files; ``tests/torch_image_cases.py`` writes what
Pillow cannot: YCbCr at every subsampling with ReferenceBlackWhite and
coefficients, JPEG streams of any sampling in strips or tiles with or
without JPEGTables, the floating-point predictor, 12-bit samples,
old-style LZW codes, T.4 two-dimensional and filled rows, T.6 tiles,
either byte order.
"""

import json
import struct

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from chip_smoke import (TIFF_VARIANT_ENV_MAPS, TIFF_VARIANT_TEXTURES,
                        with_sidecar_images)
from wgpu_path_tracing_tpu.models import gltf as JG
from wgpu_path_tracing_tpu.ops import env as JENV
from wgpu_path_tracing_tpu_torch import scene_to_glb, textured_cornell
from wgpu_path_tracing_tpu_torch.accel import native
from wgpu_path_tracing_tpu_torch.models import gltf as G
from wgpu_path_tracing_tpu_torch.ops import env as ENV
from wgpu_path_tracing_tpu_torch.utils import fax, lab, tiff
from tests import torch_image_cases as C

torch.set_num_threads(1)

RGB = C.sample_image(37, 23, 5, 3)
RGBA = C.sample_image(37, 23, 6)
GRAY = C.sample_image(37, 23, 7, 1)
YCC = C.rgb_to_ycbcr(RGB)
FLOAT = C.float_gray(37, 23, 8)
RGB16 = C.sample_image(37, 23, 9, 3).astype(np.uint16) * 257
BITS = (GRAY > 120).astype(np.uint8)
LAB = np.stack([GRAY[..., 0], C.sample_image(37, 23, 10, 1)[..., 0] - 90,
                C.sample_image(37, 23, 11, 1)[..., 0] ^ 0x55], -1)


def fixture(name: str) -> bytes:
    with open(f"{C.LDR_DIR}/{name}", "rb") as f:
        return f.read()


def pillow_cases():
    img = Image.fromarray(RGB)
    gray = Image.fromarray(GRAY[..., 0])
    out = {}
    for q in (30, 90):
        out[f"jpeg_rgb_q{q}"] = C.pillow_bytes(img, "TIFF", compression="jpeg",
                                               quality=q)
    out["jpeg_gray"] = C.pillow_bytes(gray, "TIFF", compression="jpeg")
    out["jpeg_ycbcr"] = C.pillow_bytes(img.convert("YCbCr"), "TIFF",
                                       compression="jpeg")
    for comp in ("group3", "group4", "tiff_ccitt"):
        out[f"{comp}"] = C.pillow_bytes(gray.convert("1"), "TIFF",
                                        compression=comp)
    for comp in ("raw", "packbits", "tiff_lzw", "lzma", "jpeg", "group4"):
        src = gray.convert("1") if comp == "group4" else img
        out[f"bigtiff_{comp}"] = C.pillow_bytes(src, "TIFF", big_tiff=True,
                                                compression=comp)
    f = Image.fromarray(FLOAT[..., 0], "F")
    for comp in ("raw", "tiff_lzw", "tiff_adobe_deflate", "lzma"):
        out[f"float_{comp}"] = C.pillow_bytes(f, "TIFF", compression=comp)
        out[f"int32_{comp}"] = C.pillow_bytes(gray.convert("I"), "TIFF",
                                              compression=comp)
    out["lab_raw"] = C.pillow_bytes(img.convert("LAB"), "TIFF")
    out["lab_lzw"] = C.pillow_bytes(img.convert("LAB"), "TIFF",
                                    compression="tiff_lzw")
    for mode in ("RGB", "RGBA", "L", "CMYK"):
        out[f"lzma_{mode}"] = C.pillow_bytes(
            Image.fromarray(RGBA).convert(mode), "TIFF", compression="lzma")
    out["ycbcr_lzw"] = C.pillow_bytes(img.convert("YCbCr"), "TIFF",
                                      compression="tiff_lzw")
    return out


PILLOW = pillow_cases()


@pytest.mark.parametrize("case", sorted(PILLOW))
def test_pillow_written_variants_equal_pillow(case):
    C.assert_like_pillow(PILLOW[case], case)


def rbw(*pairs):
    return {532: (5, list(pairs))}


WRITTEN = {
    # BigTIFF: 8-byte offsets and counts (LONG8) under every codec.
    "bigtiff_raw_tiles": lambda: C.write_tiff(RGB, 8, 2, bigtiff=True,
                                              tile=(16, 16)),
    "bigtiff_packbits": lambda: C.write_tiff(RGBA, 8, 2, compression=32773,
                                             extra=(2,), bigtiff=True),
    "bigtiff_deflate_tiles": lambda: C.write_tiff(RGB16, 16, 2, compression=8,
                                                  predictor=2, bigtiff=True,
                                                  tile=(16, 32)),
    "bigtiff_lzma": lambda: C.write_tiff(GRAY, 8, 1, compression=34925,
                                         bigtiff=True, rows_per_strip=4),
    "bigtiff_g3": lambda: C.write_tiff(BITS, 1, 0, compression=3,
                                       bigtiff=True, rows_per_strip=5),
    "bigtiff_jpeg": lambda: C.write_tiff(YCC, 8, 6, compression=7,
                                         subsampling=(2, 2), bigtiff=True,
                                         jpeg={"sampling": [(2, 2), (1, 1),
                                                            (1, 1)]}),
    "bigtiff_float_pred3": lambda: C.write_tiff(FLOAT, 32, 1, compression=5,
                                                predictor=3, sample_format=3,
                                                bigtiff=True),
    # 32-bit float gray, both byte orders, each predictor.
    "float_ii_raw": lambda: C.write_tiff(FLOAT, 32, 1, sample_format=3),
    "float_mm_raw_tiles": lambda: C.write_tiff(FLOAT, 32, 0, sample_format=3,
                                               order=">", tile=(16, 16)),
    "float_ii_lzw_pred3": lambda: C.write_tiff(FLOAT, 32, 1, compression=5,
                                               predictor=3, sample_format=3,
                                               rows_per_strip=5),
    "float_mm_lzw_pred3": lambda: C.write_tiff(FLOAT, 32, 1, compression=5,
                                               predictor=3, sample_format=3,
                                               order=">", rows_per_strip=5),
    "float_mm_deflate_pred2": lambda: C.write_tiff(FLOAT, 32, 1, compression=8,
                                                   predictor=2,
                                                   sample_format=3,
                                                   order=">"),
    "float_ii_lzma_pred3_tiles": lambda: C.write_tiff(
        FLOAT, 32, 0, compression=34925, predictor=3, sample_format=3,
        tile=(32, 16)),
    "float_mm_packbits": lambda: C.write_tiff(FLOAT, 32, 1, compression=32773,
                                              sample_format=3, order=">"),
    # 32-bit integers: I;32N, I;32S, I;32BS (compressed big-endian samples
    # come out byte-swapped, as libtiff hands Pillow the host's order).
    "int32_unsigned_raw": lambda: C.write_tiff(
        GRAY.astype(np.int64) * 7 - 300, 32, 1),
    "int32_unsigned_lzw_pred2": lambda: C.write_tiff(
        GRAY.astype(np.int64) * 7 - 300, 32, 1, compression=5, predictor=2),
    "int32_signed_deflate": lambda: C.write_tiff(
        GRAY.astype(np.int64) * 5 - 400, 32, 1, compression=8,
        sample_format=2),
    "int32_signed_mm_raw": lambda: C.write_tiff(
        GRAY.astype(np.int64) * 5 - 400, 32, 1, sample_format=2, order=">"),
    "int32_signed_mm_lzw": lambda: C.write_tiff(
        GRAY.astype(np.int64) * 5 - 400, 32, 1, compression=5,
        sample_format=2, order=">"),
    # 12-bit gray (I;12, little-endian only).
    "gray12_raw": lambda: C.write_tiff(GRAY.astype(np.uint16) * 16 + 5, 12,
                                       1, rows_per_strip=3),
    "gray12_lzw_tiles": lambda: C.write_tiff(GRAY.astype(np.uint16) * 3, 12,
                                             1, compression=5, tile=(16, 16)),
    "gray12_deflate": lambda: C.write_tiff(GRAY.astype(np.uint16) * 16, 12,
                                           1, compression=8),
    # CIELab through LittleCMS's Lab -> sRGB.
    "lab_raw": lambda: C.write_tiff(LAB, 8, 8),
    "lab_mm_lzw": lambda: C.write_tiff(LAB, 8, 8, compression=5, order=">",
                                       rows_per_strip=4),
    "lab_deflate_tiles": lambda: C.write_tiff(LAB, 8, 8, compression=8,
                                              predictor=2, tile=(16, 16)),
    # YCbCr through libtiff's RGBA reader, every subsampling.
    **{f"ycbcr_{h}{v}_lzw": (lambda h=h, v=v: C.write_tiff(
        YCC, 8, 6, compression=5, subsampling=(h, v), rows_per_strip=8))
       for h, v in tiff.YCBCR_UNITS},
    "ycbcr_22_deflate_odd_strips": lambda: C.write_tiff(
        YCC, 8, 6, compression=8, subsampling=(2, 2), rows_per_strip=5),
    "ycbcr_44_packbits_tiles": lambda: C.write_tiff(
        YCC, 8, 6, compression=32773, subsampling=(4, 4), tile=(32, 16)),
    "ycbcr_42_lzma_tiles_mm": lambda: C.write_tiff(
        YCC, 8, 6, compression=34925, subsampling=(4, 2), tile=(16, 16),
        order=">"),
    "ycbcr_44_strips_rounded": lambda: C.write_tiff(
        YCC[:, :19], 8, 6, compression=5, subsampling=(4, 4),
        rows_per_strip=8),
    "ycbcr_21_rbw_studio": lambda: C.write_tiff(
        YCC, 8, 6, compression=5, subsampling=(2, 1),
        tags=rbw((16, 1), (235, 1), (128, 1), (240, 1), (128, 1), (240, 1))),
    "ycbcr_11_rbw_odd": lambda: C.write_tiff(
        YCC, 8, 6, compression=5, subsampling=(1, 1),
        tags=rbw((300, 7), (31, 0), (77, 2), (255, 1), (9, 1), (400, 3))),
    "ycbcr_22_coefficients": lambda: C.write_tiff(
        YCC, 8, 6, compression=8, subsampling=(2, 2),
        tags={529: (5, [(2126, 10000), (7152, 10000), (722, 10000)])}),
    "ycbcr_22_coefficients_clamped": lambda: C.write_tiff(
        YCC, 8, 6, compression=8, subsampling=(2, 2),
        tags={529: (5, [(1983, 1000), (1394, 1000), (316, 1000)])}),
    "ycbcr_11_predictor2": lambda: C.write_tiff(
        YCC, 8, 6, compression=5, subsampling=(1, 1), predictor=2),
    "ycbcr_22_orientation6": lambda: C.write_tiff(
        YCC, 8, 6, compression=5, subsampling=(2, 2), orientation=6),
    "ycbcr_22_no_tag": lambda: C.write_tiff(YCC[:, :36], 8, 6, compression=5,
                                            subsampling=(2, 2),
                                            tags={530: (3, [2, 2])}),
    # JPEG-in-TIFF through utils/jpeg.py.
    "jpeg_ycbcr_22_tiles": lambda: C.write_tiff(
        YCC, 8, 6, compression=7, subsampling=(2, 2), tile=(16, 16),
        jpeg={"sampling": [(2, 2), (1, 1), (1, 1)]}),
    "jpeg_ycbcr_21_strips": lambda: C.write_tiff(
        YCC, 8, 6, compression=7, subsampling=(2, 1), rows_per_strip=8,
        jpeg={"sampling": [(2, 1), (1, 1), (1, 1)], "quality": 95}),
    "jpeg_ycbcr_12_strips_no_tables": lambda: C.write_tiff(
        YCC, 8, 6, compression=7, subsampling=(1, 2), rows_per_strip=16,
        jpeg={"sampling": [(1, 2), (1, 1), (1, 1)], "tables": False}),
    "jpeg_ycbcr_11_one_strip_mm": lambda: C.write_tiff(
        YCC, 8, 6, compression=7, subsampling=(1, 1), order=">",
        jpeg={"quality": 20}),
    "jpeg_ycbcr_fixup_without_tag": lambda: C.write_tiff(
        YCC, 8, 6, compression=7, rows_per_strip=8,
        jpeg={"sampling": [(2, 1), (1, 1), (1, 1)]}),
    "jpeg_rgb_tiles": lambda: C.write_tiff(RGB, 8, 2, compression=7,
                                           tile=(32, 16)),
    "jpeg_gray_tiles_min_is_white": lambda: C.write_tiff(
        GRAY, 8, 0, compression=7, tile=(16, 16), jpeg={"quality": 60}),
    "jpeg_gray_strips_orientation3": lambda: C.write_tiff(
        GRAY, 8, 1, compression=7, rows_per_strip=8, orientation=3),
    "jpeg_cmyk": lambda: C.write_tiff(C.sample_image(37, 23, 12), 8, 5,
                                      compression=7, rows_per_strip=16),
    # Old-style LZW (libtiff's LZWDecodeCompat).
    "old_lzw_gray": lambda: C.write_tiff(GRAY, 8, 1, compression=5,
                                         old_lzw=True),
    "old_lzw_rgb16_predictor": lambda: C.write_tiff(RGB16, 16, 2,
                                                    compression=5,
                                                    predictor=2, old_lzw=True,
                                                    rows_per_strip=7),
    "old_lzw_tiles_mm": lambda: C.write_tiff(RGBA, 8, 2, compression=5,
                                             extra=(2,), old_lzw=True,
                                             order=">", tile=(16, 16)),
    "old_lzw_long": lambda: C.write_tiff(C.sample_image(300, 80, 13, 3), 8,
                                         2, compression=5, old_lzw=True),
    # CCITT: modified Huffman, T.4 1-D, 2-D and filled, T.6.
    **{f"ccitt_{c}_{o}_photo{p}": (lambda c=c, o=o, p=p: C.write_tiff(
        BITS, 1, p, compression=c, fax_options=o, rows_per_strip=6))
       for c, o in ((2, 0), (3, 0), (3, 1), (3, 4), (3, 5), (4, 0))
       for p in (0, 1)},
    "ccitt_g4_tiles_fill2": lambda: C.write_tiff(BITS, 1, 0, compression=4,
                                                 tile=(16, 16), fill=2),
    "ccitt_g3_2d_mm_fill2": lambda: C.write_tiff(BITS, 1, 1, compression=3,
                                                 fax_options=1, fill=2,
                                                 order=">"),
    "ccitt_long_runs": lambda: C.write_tiff(
        np.concatenate([np.zeros((2, 5300, 1), np.uint8),
                        np.ones((2, 5300, 1), np.uint8)]), 1, 1,
        compression=4),
    "ccitt_page": lambda: C.write_tiff(C.fax_page(300, 200, 3)[..., None], 1,
                                       0, compression=4),
    "ccitt_page_mh": lambda: C.write_tiff(C.fax_page(120, 100, 4)[..., None],
                                          1, 0, compression=2),
    # LZMA (the standard library's lzma).
    "lzma_rgb_predictor2": lambda: C.write_tiff(RGB, 8, 2, compression=34925,
                                                predictor=2),
    "lzma_planar_rgba": lambda: C.write_tiff(RGBA, 8, 2, compression=34925,
                                             planar=2, extra=(2,)),
    "lzma_palette4_tiles": lambda: C.write_tiff(
        GRAY >> 4, 4, 3, compression=34925, tile=(16, 16),
        colormap=(np.arange(48) * 1361) % 65536),
}


@pytest.mark.parametrize("case", sorted(WRITTEN))
def test_written_variants_equal_pillow(case):
    C.assert_like_pillow(WRITTEN[case](), case)


def test_float_and_integer_conversions_clip_then_truncate():
    """Pillow's "F" -> RGBA clips to 0-255, then truncates; NaN gives 0.
    "I" clips; an unsigned 32-bit sample past 2^31 is negative to it."""
    f = np.array([[-3.7, 0.5, 1.5, 254.6, 300, np.nan, -np.inf, np.inf,
                   255.99, -0.5, 0.999]], np.float32)[..., None]
    data = C.write_tiff(f, 32, 1, sample_format=3)
    got = C.assert_like_pillow(data)
    assert got[0, :, 0].tolist() == [0, 0, 1, 254, 255, 0, 0, 255, 255, 0, 0]
    i = np.array([[-3, 0, 1, 254, 255, 256, 2 ** 31 - 1, -2 ** 31]])[..., None]
    got = C.assert_like_pillow(C.write_tiff(i, 32, 1, sample_format=2))
    assert got[0, :, 0].tolist() == [0, 0, 1, 254, 255, 255, 255, 0]
    got = C.assert_like_pillow(C.write_tiff(i, 32, 1))
    assert got[0, :, 0].tolist() == [0, 0, 1, 254, 255, 255, 255, 0]
    v = np.array([[0, 211, 254, 255, 256, 4095]], np.uint16)[..., None]
    got = C.assert_like_pillow(C.write_tiff(v, 12, 1, compression=5))
    assert got[0, :, 0].tolist() == [0, 211, 254, 255, 255, 255]


def test_lab_to_rgb_is_littlecms_on_pillow():
    """Pillow's CIELab: L*a*b* (113, 64, 30) is RGB (199, 31, 60); every
    29th value of each channel (and the ends) equal to Pillow's
    ``convert("RGB")`` of mode "LAB"."""
    assert lab.lab_to_rgb(np.array([113, 64, 30], np.uint8)).tolist() == [
        199, 31, 60]
    v = np.unique(np.r_[np.arange(0, 256, 29), 127, 128, 255]).astype(np.uint8)
    grid = np.stack(np.meshgrid(v, v, v, indexing="ij"), -1).reshape(-1, 1, 3)
    want = np.asarray(Image.frombytes("LAB", (1, len(grid)),
                                      grid.tobytes()).convert("RGB"))
    np.testing.assert_array_equal(lab.lab_to_rgb(grid), want)


def test_lab_clut_is_pillows_littlecms_grid():
    """The committed grid is the one ``tools/lab_clut.py`` reads out of the
    LittleCMS that Pillow ships."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "lab_clut", f"{C.LDR_DIR}/../../tools/lab_clut.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    np.testing.assert_array_equal(tool.read_clut(check=False), lab.clut())


@pytest.mark.parametrize("luma,refbw", [
    ((0.299, 0.587, 0.114), (0, 255, 128, 255, 128, 255)),
    ((0.2126, 0.7152, 0.0722), (16, 235, 128, 240, 128, 240)),
    ((1.5, 0.2, -0.3), (300, 31, 77, 255, 9, 400))])
def test_ycbcr_tables_equal_pillows_rgba_reader(luma, refbw):
    """Every (Y, Cb, Cr) of a 1x1 YCbCr file, read by libtiff's RGBA
    reader, equals ``ycbcr_to_rgb`` on the tables; coefficients and
    ReferenceBlackWhite as float32, as libtiff reads them."""
    y, cb, cr = np.meshgrid(np.arange(0, 256, 4), np.arange(0, 256, 3),
                            np.arange(0, 256, 7), indexing="ij")
    ycc = np.stack([y, cb, cr], -1).reshape(-1, 64, 3).astype(np.uint8)
    tags = {529: (5, [(round(v * 10000) & 0xFFFFFFFF, 10000)
                      if v >= 0 else (0, 1) for v in luma]),
            532: (5, [(v, 1) for v in refbw])}
    data = C.write_tiff(ycc, 8, 6, compression=5, subsampling=(1, 1),
                        tags=tags)
    want = C.assert_like_pillow(data)
    tables = tiff.ycbcr_tables(
        [np.float32(a) / np.float32(b) for a, b in tags[529][1]], refbw)
    np.testing.assert_array_equal(
        tiff.ycbcr_to_rgb(ycc[..., 0], ycc[..., 1], ycc[..., 2], tables),
        want[..., :3])


@pytest.mark.parametrize("old", [(0,), (1, 2), (0, 2)])
def test_old_style_lzw_is_chosen_by_the_first_strip(old):
    """Strips that mix old- and new-style LZW codes: libtiff picks the
    decoder by the first strip it reads, for all; the port reads what
    Pillow reads, or raises where Pillow refuses."""
    data = C.write_tiff(RGB, 8, 2, compression=5, rows_per_strip=8,
                        old_lzw=old)
    if C.pillow_refuses(data):
        C.assert_refused(data, "m.tif")
    else:
        C.assert_like_pillow(data, str(old))


def fax_strips():
    """(compression, T4Options, width, rows, strip) of every CCITT strip
    and tile of the fixtures and written cases, as a page's sequence, then
    random and cut streams."""
    pages = []
    names = [n for n in C.tiff_variant_fixtures() if n.endswith(".tif")]
    files = [fixture(n) for n in names] + [f() for f in WRITTEN.values()]
    for data in files:
        order, big, at = tiff._header(data, "f")
        tags, _ = tiff._ifd(data, order, at, "f", big)
        kind = tiff.COMPRESSIONS.get(tags.get(259, 1))
        if kind not in tiff.FAX:
            continue
        chunks, tw, th, _ = tiff._chunks(data, tags, tags[256], tags[257], 1,
                                         "f")
        opts = tags.get(292, (0,))
        opts = opts[0] if isinstance(opts, tuple) else opts
        pages.append([(tiff.FAX[kind], opts, tw, rows, src)
                      for _, _, _, _, rows, src in chunks])
    rng = np.random.default_rng(9)
    for _ in range(120):
        comp = int(rng.choice([2, 3, 4]))
        opts = int(rng.choice([0, 1, 4, 5])) if comp == 3 else 0
        w = int(rng.integers(1, 70))
        bits = (rng.random((int(rng.integers(1, 9)), w)) < rng.random())
        src = bytearray(C.fax_encode(bits, comp, opts))
        if rng.random() < 0.5:
            src = src[:int(rng.integers(0, len(src) + 1))]
        for _ in range(int(rng.integers(0, 4))):
            if src:
                src[int(rng.integers(0, len(src)))] ^= 1 << int(
                    rng.integers(0, 8))
        rows = bits.shape[0] + int(rng.integers(-1, 3))
        pages.append([(comp, opts, w, max(rows, 1), bytes(src))] * 2)
        if rng.random() < 0.3:
            pages.append([(comp, opts, w, 3, rng.integers(
                0, 256, int(rng.integers(0, 40)), dtype=np.uint8).tobytes())])
    return pages


def test_fax_loops_in_cxx_equal_python():
    """``wpt_fax`` gives the same rows, status and run array as
    ``fax_plain`` on every strip of a page in turn (the run array lives
    across a page's strips), good, cut or corrupt."""
    seen = set()
    for page in fax_strips():
        comp, opts, w = page[0][:3]
        runs_c, runs_p = fax.fax_runs(comp, w, opts), fax.fax_runs(comp, w,
                                                                   opts)
        for comp, opts, w, rows, src in page:
            got_c = native.fax_native(src, comp, w, rows, opts, runs_c)
            got_p = fax.fax_plain(src, comp, w, rows, opts, runs_p)
            np.testing.assert_array_equal(got_c[0], got_p[0])
            assert got_c[1] == got_p[1]
            np.testing.assert_array_equal(runs_c, runs_p)
            seen.add((comp, got_c[1]))
    assert seen >= {(2, 0), (2, 1), (3, 0), (3, 1), (4, 0), (4, 1), (4, 2)}


def test_fax_writer_codes_every_run_length():
    """The test suite's modified Huffman writer against Pillow on every
    run length 0-2,700 of both colours (the code tables the decoder
    shares)."""
    runs = list(range(0, 2700, 1))
    line = np.zeros(sum(runs) + len(runs), np.uint8)
    x = 0
    for i, r in enumerate(runs):
        line[x:x + r] = i & 1
        x += r
    line = line[:x]
    rows = np.stack([line, 1 - line])[..., None]
    C.assert_like_pillow(C.write_tiff(rows, 1, 1, compression=2))


@settings(max_examples=40, deadline=None)
@given(w=st.integers(1, 40), h=st.integers(1, 20),
       case=st.sampled_from([
           ("F", "raw"), ("F", "tiff_lzw"), ("F", "lzma"),
           ("I", "tiff_adobe_deflate"), ("I", "raw"), ("1", "group3"),
           ("1", "group4"), ("1", "tiff_ccitt"), ("L", "jpeg"),
           ("RGB", "jpeg"), ("YCbCr", "jpeg"), ("YCbCr", "tiff_lzw"),
           ("LAB", "raw"), ("LAB", "tiff_lzw"), ("RGBA", "lzma")]),
       big=st.booleans(), seed=st.integers(0, 2 ** 16))
def test_hypothesis_pillow_tiff_variants(w, h, case, big, seed):
    mode, compression = case
    img = Image.fromarray(C.sample_image(w, h, seed))
    img = (Image.fromarray(C.sample_image(w, h, seed, 1)[..., 0].astype(
        np.float32) * 1.7 - 30, "F") if mode == "F" else img.convert(mode))
    C.assert_like_pillow(C.pillow_bytes(img, "TIFF", compression=compression,
                                        big_tiff=big))


@pytest.mark.parametrize("name", [n for n, _ in TIFF_VARIANT_ENV_MAPS]
                         + ["g4.tif", "bigtiff_lzw_rgba.tif", "lab_lzw.tif",
                            "ycbcr_lzw_22.tif"])
def test_tiff_variant_env_map_equals_jax(name, tmp_path):
    path = str(tmp_path / "sky.png")
    with open(path, "wb") as f:
        f.write(fixture(name))
    np.testing.assert_array_equal(ENV.load_env_image(path),
                                  JENV.load_env_image(path))


@pytest.mark.parametrize("ratio", [0.5, 1.0])
def test_tiff_variant_sidecars_build_the_jax_atlas(ratio, tmp_path):
    """``textured_cornell()`` as a .gltf whose four textures are the
    sidecars ``chip_smoke.TIFF_VARIANT_TEXTURES`` (JPEG-in-TIFF YCbCr
    tiles, BigTIFF LZW RGBA, float gray, G4): the port's atlas equals the
    JAX ``build_atlas``'s."""
    for name in TIFF_VARIANT_TEXTURES:
        (tmp_path / name).write_bytes(fixture(name))
    path = tmp_path / "textured.gltf"
    path.write_text(with_sidecar_images(scene_to_glb(textured_cornell()),
                                        list(TIFF_VARIANT_TEXTURES)))
    assert len(json.loads(path.read_text())["images"]) == 4
    got, got_rects = G.build_atlas(G.GLTFFile.load(str(path)), ratio)
    want, want_rects = JG.build_atlas(JG.GLTFFile.load(str(path)), ratio)
    np.testing.assert_array_equal(got, want)
    assert got_rects == want_rects


def test_large_jpeg_in_tiff_equals_pillows_digest():
    """The committed 4096x2048 JPEG-in-TIFF YCbCr timing file (the card's
    host has no Pillow) decodes, in C++, to the array whose SHA-256 Pillow
    gave."""
    import hashlib

    with open(f"{C.LDR_DIR}/pillow_sha256.json") as f:
        want = json.load(f)[C.LARGE_TIFF_JPEG]
    got = C.decode_in(True, fixture(C.LARGE_TIFF_JPEG))
    assert hashlib.sha256(got.tobytes()).hexdigest() == want


def _longer(data: bytes, extra: int) -> bytes:
    """A TIFF whose ImageLength claims ``extra`` rows more than its strips
    hold."""
    order = "<" if data[:2] == b"II" else ">"
    (ifd,) = struct.unpack_from(order + "I", data, 4)
    (n,) = struct.unpack_from(order + "H", data, ifd)
    out = bytearray(data)
    for i in range(n):
        at = ifd + 2 + 12 * i
        tag, typ = struct.unpack_from(order + "HH", out, at)
        if tag == 257:
            code = order + ("H" if typ == 3 else "I")
            struct.pack_into(code, out, at + 8,
                             struct.unpack_from(code, out, at + 8)[0] + extra)
    return bytes(out)


SHORT_STRIPS = {
    "lab": (LAB, 8, 8, {}), "gray": (GRAY, 8, 1, {}),
    "white_is_zero": (GRAY, 8, 0, {}), "rgb": (RGB, 8, 2, {}),
    "rgba": (RGBA, 8, 2, {"extra": (2,)}),
    "rgba_associated": (RGBA, 8, 2, {"extra": (1,)}),
    "ycbcr_raw": (YCC, 8, 6, {"subsampling": (1, 1)}),
    "cmyk": (C.sample_image(37, 23, 11), 8, 5, {}),
    "gray16": (GRAY.astype(np.uint16) * 200, 16, 1, {}),
    "gray16_signed": (GRAY.astype(np.uint16) * 200, 16, 1,
                      {"sample_format": 2}),
    "bilevel": (BITS, 1, 1, {}), "bilevel_white_is_zero": (BITS, 1, 0, {}),
    "float": (FLOAT, 32, 1, {"sample_format": 3}),
    "gray_alpha": (C.sample_image(37, 23, 12, 2), 8, 1, {"extra": (2,)}),
}


@pytest.mark.parametrize("rows_per_strip", [None, 5])
@pytest.mark.parametrize("case", sorted(SHORT_STRIPS))
def test_rows_past_the_last_strip_equal_pillow(case, rows_per_strip):
    """Raw strips that cover fewer rows than ImageLength: Pillow leaves the
    rest at its image's zero bytes, which in "LAB" (whose fourth byte is
    255 wherever a strip wrote) convert to (0, 59, 195) with alpha 0; in
    the other modes the port's zero samples read as Pillow's zero bytes
    do. Where the strips end inside the last one the new height asks for,
    or raw YCbCr (four bytes a pixel) runs out, Pillow refuses the file,
    and so does the port."""
    samples, bits, photo, kw = SHORT_STRIPS[case]
    data = _longer(C.write_tiff(samples, bits, photo,
                                rows_per_strip=rows_per_strip, **kw), 4)
    if C.pillow_refuses(data):  # a last strip now short of its rows
        C.assert_refused(data, f"{case}.tif")
        assert rows_per_strip or case == "ycbcr_raw"
        return
    got = C.assert_like_pillow(data, f"{case}.tif")
    if case == "lab":
        assert got[-1, 0].tolist() == [0, 59, 195, 0]
