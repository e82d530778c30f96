"""The port's TIFF reader (``utils/tiff.py``) against Pillow 12.1.0 with
libtiff, which the JAX package reads LDR images with; and the atlas of a
.gltf whose sidecar textures are TGA, BMP, netpbm and TIFF files against
the JAX ``build_atlas``. The variants of ``tests/test_torch_tiff_variants.py``
(JPEG, YCbCr, CIELab, float, BigTIFF, CCITT ...) are held here too where
they were once left for later.

Every case is held array-equal to ``Image.open(...).convert("RGBA")``, and
decoded twice: with the C++ PackBits and LZW loops (``accel/cbvh/
image_scan.cpp``) and with their plain Python versions. Pillow reads
uncompressed data itself (each strip from its offset, a separate plane as
one character of the raw mode) and compressed data through libtiff;
``tests/torch_image_cases.py`` writes what Pillow cannot: tiles, separate
planes, big-endian files, fill order 2, predictor 2 at 16 bits, every
orientation (which Pillow applies), WhiteIsZero, 2 and 4-bit palettes,
associated alpha.
"""

import json
import struct

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from chip_smoke import LDR_TEXTURES, with_sidecar_images
from wgpu_path_tracing_tpu.models import gltf as JG
from wgpu_path_tracing_tpu.ops import env as JENV
from wgpu_path_tracing_tpu_torch import scene_to_glb, textured_cornell
from wgpu_path_tracing_tpu_torch.accel import native
from wgpu_path_tracing_tpu_torch.models import gltf as G
from wgpu_path_tracing_tpu_torch.ops import env as ENV
from wgpu_path_tracing_tpu_torch.utils import tiff
from tests import torch_image_cases as C

torch.set_num_threads(1)

FIXTURES = np.load(f"{C.LDR_DIR}/pillow_rgba.npz")
TIFF_FILES = sorted(n for n in FIXTURES.files if n.endswith(".tif"))
COMPRESSIONS = ["raw", "packbits", "tiff_lzw", "tiff_deflate",
                "tiff_adobe_deflate"]


def fixture(name: str) -> bytes:
    with open(f"{C.LDR_DIR}/{name}", "rb") as f:
        return f.read()


@pytest.mark.parametrize("name", TIFF_FILES)
def test_committed_tiff_files_equal_pillow(name):
    data = fixture(name)
    np.testing.assert_array_equal(C.assert_like_pillow(data, name),
                                  FIXTURES[name])


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "1", "P", "LA", "PA",
                                  "CMYK", "I;16", "I;16B", "RGBX"])
def test_pillow_written_tiff_equals_pillow(mode):
    """Every mode Pillow writes (16-bit gray clipped at 255), uncompressed
    and under each compression Pillow writes through libtiff, with
    predictor 2 where libtiff takes it."""
    img = Image.fromarray(C.sample_image(27, 18, 3))
    if mode in ("I;16", "I;16B"):
        v = C.sample_image(27, 18, 4, 1)[..., 0].astype(np.uint16) * 3
        img = Image.frombytes(mode, (27, 18), v.astype(
            "<u2" if mode == "I;16" else ">u2").tobytes())
    elif mode == "PA":
        img = img.convert("P").convert("PA")
    else:
        img = img.convert(mode)
    for compression in COMPRESSIONS:
        kw = {"compression": compression}
        C.assert_like_pillow(C.pillow_bytes(img, "TIFF", **kw),
                             f"{mode} {compression}")
        if compression in ("tiff_lzw", "tiff_adobe_deflate") and mode in (
                "RGB", "RGBA", "L", "CMYK", "I;16"):
            C.assert_like_pillow(C.pillow_bytes(img, "TIFF", tiffinfo={
                317: 2}, **kw), f"{mode} {compression} predictor 2")


RGB = C.sample_image(37, 23, 5, 3)
RGBA = C.sample_image(37, 23, 6)
GRAY = C.sample_image(37, 23, 7, 1)
RGB16 = (C.sample_image(37, 23, 8, 3).astype(np.uint16) * 257
         + np.arange(37, dtype=np.uint16)[None, :, None])


def palette(bits):
    return (np.arange(3 << bits) * 5003) % 65536


WRITTEN = {
    "strips_lzw_predictor_mm": lambda: C.write_tiff(
        RGB, 8, 2, compression=5, predictor=2, order=">", rows_per_strip=4),
    "tiles_raw": lambda: C.write_tiff(RGB, 8, 2, tile=(16, 16)),
    "tiles_packbits_mm": lambda: C.write_tiff(RGBA, 8, 2, compression=32773,
                                              extra=(2,), order=">",
                                              tile=(16, 32)),
    "tiles_1bit_lzw": lambda: C.write_tiff(GRAY >> 7, 1, 1, compression=5,
                                           tile=(32, 16)),
    "rgb16_lzw_predictor_ii": lambda: C.write_tiff(
        RGB16, 16, 2, compression=5, predictor=2, rows_per_strip=7),
    "rgb16_raw_mm": lambda: C.write_tiff(RGB16, 16, 2, order=">"),
    "rgba16_deflate": lambda: C.write_tiff(
        np.concatenate([RGB16, RGB16[..., :1]], -1), 16, 2, compression=8,
        extra=(2,)),
    "rgba16_associated": lambda: C.write_tiff(
        np.concatenate([RGB16 // 2, RGB16[..., :1]], -1), 16, 2,
        compression=32946, extra=(1,)),
    "planar_raw_rgb": lambda: C.write_tiff(RGB, 8, 2, planar=2,
                                           rows_per_strip=5),
    "planar_raw_cmyk": lambda: C.write_tiff(C.sample_image(9, 5, 9), 8, 5,
                                            planar=2),
    "planar_lzw_rgba": lambda: C.write_tiff(RGBA, 8, 2, compression=5,
                                            predictor=2, planar=2, extra=(2,)),
    "planar_deflate_rgba_tiles": lambda: C.write_tiff(
        RGBA, 8, 2, compression=8, planar=2, extra=(2,), tile=(16, 16)),
    # A single separate plane read uncompressed takes the raw mode's first
    # character: WhiteIsZero is then not inverted, 4-bit data read a byte a
    # pixel, fill order 2 not reversed.
    "planar_raw_white_is_zero": lambda: C.write_tiff(GRAY, 8, 0, planar=2),
    "planar_raw_gray4": lambda: C.write_tiff(GRAY[:4] >> 4, 4, 1, planar=2),
    "planar_raw_fill2": lambda: C.write_tiff(GRAY, 8, 1, planar=2, fill=2),
    "fill2_gray8_lzw": lambda: C.write_tiff(GRAY, 8, 1, compression=5, fill=2),
    "fill2_rgb_raw": lambda: C.write_tiff(RGB, 8, 2, fill=2),
    "fill2_gray1_raw": lambda: C.write_tiff(GRAY >> 7, 1, 0, fill=2),
    "fill2_gray16_raw": lambda: C.write_tiff(RGB16[..., :1], 16, 1, fill=2),
    "white_is_zero_1bit": lambda: C.write_tiff(GRAY >> 7, 1, 0,
                                               compression=32773),
    "white_is_zero_2bit": lambda: C.write_tiff(GRAY >> 6, 2, 0),
    "white_is_zero_4bit_lzw": lambda: C.write_tiff(GRAY >> 4, 4, 0,
                                                   compression=5),
    "white_is_zero_16bit_not_inverted": lambda: C.write_tiff(
        RGB16[..., :1] // 200, 16, 0, compression=8),
    "gray2_raw": lambda: C.write_tiff(GRAY >> 6, 2, 1, rows_per_strip=3),
    "gray16_mm_clipped": lambda: C.write_tiff(RGB16[..., :1] // 150, 16, 1,
                                              order=">", compression=5),
    "gray16_signed": lambda: C.write_tiff(
        (RGB16[..., :1].astype(np.int32) - 32768 + 200).astype(np.int16)
        .view(np.uint16), 16, 1, sample_format=2),
    "gray8_signed": lambda: C.write_tiff(GRAY, 8, 1, sample_format=2),
    "gray_alpha_lzw": lambda: C.write_tiff(
        np.concatenate([GRAY, 255 - GRAY], -1), 8, 1, compression=5,
        extra=(2,)),
    "palette1": lambda: C.write_tiff(GRAY >> 7, 1, 3, colormap=palette(1)),
    "palette2_packbits": lambda: C.write_tiff(GRAY >> 6, 2, 3,
                                              compression=32773,
                                              colormap=palette(2)),
    "palette4_lzw": lambda: C.write_tiff(GRAY >> 4, 4, 3, compression=5,
                                         colormap=palette(4)),
    "palette8_short_map": lambda: C.write_tiff(GRAY, 8, 3,
                                               colormap=palette(5)),
    "palette_alpha": lambda: C.write_tiff(
        np.concatenate([GRAY >> 4, GRAY], -1), 8, 3, extra=(2,),
        colormap=palette(8)),
    "rgb_extra_unspecified": lambda: C.write_tiff(RGBA, 8, 2, extra=(0,)),
    "rgb_associated_alpha": lambda: C.write_tiff(RGBA, 8, 2, extra=(1,),
                                                 compression=5),
    "rgb_two_extra_samples": lambda: C.write_tiff(
        np.concatenate([RGBA, GRAY], -1), 8, 2, extra=(2, 0)),
    "cmyk_deflate": lambda: C.write_tiff(C.sample_image(21, 9, 10), 8, 5,
                                         compression=8),
    "cmyk16_mm": lambda: C.write_tiff(C.sample_image(21, 9, 11).astype(
        np.uint16) * 251, 16, 5, order=">"),
    "one_strip_from_the_last_offset": lambda: C.write_tiff(RGB, 8, 2,
                                                           compression=1),
}


@pytest.mark.parametrize("case", sorted(WRITTEN))
def test_written_variants_equal_pillow(case):
    C.assert_like_pillow(WRITTEN[case]())


@pytest.mark.parametrize("orientation", range(1, 9))
def test_orientation_is_applied_as_pillow_applies_it(orientation):
    """Pillow's TIFF loader transposes by the Orientation tag
    (``ImageOps.exif_transpose``), unlike its JPEG reader; so does the
    port. Orientations 5-8 swap width and height."""
    data = C.write_tiff(RGB, 8, 2, compression=5, orientation=orientation)
    got = C.assert_like_pillow(data)
    assert got.shape[:2] == ((37, 23) if orientation > 4 else (23, 37))


def once_left_cases():
    """The variants PR 20 left for later, now read as Pillow reads them."""
    img = Image.fromarray(RGB)
    return {
        "jpeg": C.pillow_bytes(img, "TIFF", compression="jpeg"),
        "ycbcr": C.write_tiff(C.rgb_to_ycbcr(RGB), 8, 6, compression=5,
                              subsampling=(2, 2), rows_per_strip=6),
        "float": C.pillow_bytes(Image.fromarray(GRAY[..., 0]).convert("F"),
                                "TIFF"),
        "old_style_lzw": C.write_tiff(RGB, 8, 2, compression=5,
                                      old_lzw=True),
        "group4": C.pillow_bytes(Image.fromarray(GRAY[..., 0]).convert("1"),
                                 "TIFF", compression="group4"),
        "group3": C.pillow_bytes(Image.fromarray(GRAY[..., 0]).convert("1"),
                                 "TIFF", compression="group3"),
        "bigtiff": C.pillow_bytes(img, "TIFF", big_tiff=True),
        "int32": C.pillow_bytes(Image.fromarray(GRAY[..., 0]).convert("I"),
                                "TIFF"),
        # Left for later once more, then read as Pillow reads them.
        "zstd": C.pillow_bytes(Image.fromarray(RGB), "TIFF",
                               compression="zstd"),
        "separate_planes_16bit_lzw": C.write_tiff(RGB16, 16, 2, compression=5,
                                                  planar=2),
        "big_endian_signed_16bit_lzw": C.write_tiff(
            RGB16[..., :1], 16, 1, compression=5, order=">", sample_format=2),
    }


ONCE_LEFT = once_left_cases()


@pytest.mark.parametrize("case", sorted(ONCE_LEFT))
def test_variants_once_left_for_later_equal_pillow(case):
    """JPEG-in-TIFF, YCbCr, float and 32-bit samples, old-style LZW, CCITT
    G3/G4, BigTIFF, zstd, compressed 16-bit separate planes and compressed
    big-endian signed 16-bit samples decode as Pillow decodes them."""
    C.assert_like_pillow(ONCE_LEFT[case], case)


def with_byte_count(data: bytes, count: int) -> bytes:
    """A one-strip little-endian TIFF with its StripByteCounts set."""
    out = bytearray(data)
    at = out.index(struct.pack("<HHI", 279, 4, 1))
    struct.pack_into("<I", out, at + 8, count)
    return bytes(out)


def not_read_cases():
    return {
        "ccitt_ends_early": with_byte_count(C.write_tiff(
            (GRAY > 100).astype(np.uint8), 1, 1, compression=4), 9),
        "lzma_bad_data": bytes(C.write_tiff(RGB, 8, 2, compression=34925)[:30])
        + b"\xff" * 20 + bytes(C.write_tiff(RGB, 8, 2, compression=34925)[50:]),
    }


NOT_READ = not_read_cases()


@pytest.mark.parametrize("case", sorted(NOT_READ))
def test_variants_left_for_later_raise_naming_the_image(case):
    """CCITT data that ends before its last row (libtiff leaves rows
    unwritten) and bad LZMA data (libtiff keeps part of it) raise
    ``NotImplementedError`` naming the image, whatever Pillow does with
    them."""
    C.assert_refused(NOT_READ[case], "n.tif", NotImplementedError)


def refused_cases():
    return {
        # Once left for later: compression 6 over data that is no JPEG
        # (libtiff's OJPEG finds no tables) and WebP-in-TIFF (Pillow's
        # libtiff has no WebP codec).
        "old_style_jpeg": C.write_tiff(RGB, 8, 6, compression=1,
                                       tags={259: (3, [6])}),
        "webp": C.write_tiff(RGB, 8, 2, tags={259: (3, [50001])}),
        "lzw_cut_short": C.write_tiff(RGB, 8, 2, compression=5)[:200],
        "packbits_short": C.write_tiff(RGB[:, :3], 8, 2, compression=32773,
                                       rows_per_strip=23)[:60],
        "deflate_bad_data": bytes(C.write_tiff(RGB, 8, 2, compression=8)[:8])
        + b"\x78\x9c\xff\xff" + bytes(C.write_tiff(RGB, 8, 2, compression=8)[
            12:]),
        "no_unpacker_for_palette_fill2": C.write_tiff(GRAY >> 4, 4, 3, fill=2,
                                                      colormap=palette(4)),
        "rgb_fill2_16bit": C.write_tiff(RGB16, 16, 2, fill=2),
        "planar_raw_rgba_associated": C.write_tiff(RGBA, 8, 2, planar=2,
                                                   extra=(1,)),
        "raw_truncated": C.write_tiff(RGB, 8, 2)[:-50],
        "header_only": b"II*\x00",
        # Pillow reads uncompressed YCbCr as "RGBX", four bytes a pixel.
        "ycbcr_raw": C.write_tiff(RGB, 8, 6),
        "old_style_lzw_flipped": old_style_flipped(),
        "float_rgb": C.write_tiff(RGB.astype(np.float32), 32, 2,
                                  sample_format=3),
        "float64": C.write_tiff(GRAY.astype(np.float32), 32, 1,
                                sample_format=3, tags={258: (3, [64])}),
        "int32_mm_unsigned": C.write_tiff(GRAY.astype(np.int64), 32, 1,
                                          order=">"),
        "gray12_mm": C.write_tiff(GRAY.astype(np.uint16) * 9, 12, 1,
                                  order=">"),
        "bigtiff_mm": C.write_tiff(RGB, 8, 2, bigtiff=True, order=">"),
        "ycbcr_2x4": C.write_tiff(C.rgb_to_ycbcr(RGB), 8, 6, compression=5,
                                  subsampling=(2, 4)),
        "jpeg_sampling_disagrees": C.write_tiff(
            C.rgb_to_ycbcr(RGB), 8, 6, compression=7, subsampling=(2, 2),
            jpeg={"sampling": [(2, 1), (1, 1), (1, 1)]}),
        "predictor3_on_integers": C.write_tiff(RGB16[..., :1], 16, 1,
                                               compression=5, predictor=3),
        "predictor2_at_12_bits": C.write_tiff(GRAY.astype(np.uint16) * 9, 12,
                                              1, compression=5, predictor=2),
        "rows_per_strip_0_lzw": C.write_tiff(RGB, 8, 2, compression=5,
                                             tags={278: (4, [0])}),
        "rows_per_strip_0_raw": C.write_tiff(RGB, 8, 2, tags={278: (4, [0])}),
        "rows_per_strip_2e31_lzw": C.write_tiff(RGB, 8, 2, compression=5,
                                                tags={278: (4, [2 ** 31])}),
        "rows_per_strip_0_tiled_g4": C.write_tiff(
            (GRAY > 100).astype(np.uint8), 1, 1, compression=4,
            tile=(16, 16), tags={278: (4, [0])}),
        "ycbcr_fill2": C.write_tiff(C.rgb_to_ycbcr(RGB), 8, 6, compression=5,
                                    subsampling=(1, 2), fill=2),
        "jpeg_scan_header_of_the_wrong_length": C.write_tiff(
            RGB, 8, 2, compression=7, jpeg={"tables": False}).replace(
                b"\xff\xda\x00\x0c", b"\xff\xda\x00\x2c"),
        "jpeg_scan_names_a_component_twice": C.write_tiff(
            RGB, 8, 2, compression=7, jpeg={"tables": False}).replace(
                b"\xff\xda\x00\x0c\x03\x01\x00\x02\x11\x03",
                b"\xff\xda\x00\x0c\x03\x01\x00\x02\x11\x02"),
    }


def old_style_flipped() -> bytes:
    """A new-style LZW strip whose first two bytes say old-style."""
    data = bytearray(C.write_tiff(RGB, 8, 2, compression=5))
    data[8:10] = b"\x00\x01"
    return bytes(data)


REFUSED = refused_cases()


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_what_pillow_refuses_raises_naming_the_image(case):
    data = REFUSED[case]
    assert C.pillow_refuses(data)
    C.assert_refused(data, "r.tif")


def strips():
    """Every strip and tile of the compressed fixtures and written cases,
    with its decoded size, and random data."""
    out = []
    cases = [fixture(n) for n in TIFF_FILES] + [f() for f in WRITTEN.values()]
    for data in cases:
        order, big, first = tiff._header(data, "s")
        tags, _ = tiff._ifd(data, order, first, "s", big)
        kind = tiff.COMPRESSIONS[tags.get(259, 1)]
        if kind not in ("packbits", "tiff_lzw"):
            continue
        offs, counts = tags.get(273, tags.get(324)), tags.get(279,
                                                              tags.get(325))
        for off, cnt in zip(offs, counts):
            src = data[off:off + cnt]
            for size in (0, 1, 64, 4096, 1 << 20):
                out.append((kind, src, size))
    out.append(("tiff_lzw", b"\x00\x01\x02\x03", 16))  # old-style codes
    rng = np.random.default_rng(5)
    for _ in range(300):
        src = bytes(rng.integers(0, 256, int(rng.integers(0, 200)),
                                 dtype=np.uint8))
        kind = "packbits" if rng.random() < 0.5 else "tiff_lzw"
        if kind == "tiff_lzw" and rng.random() < 0.7:
            src = C.lzw(bytes(rng.integers(0, 5, int(rng.integers(0, 3000)),
                                           dtype=np.uint8)),
                        old_style=bool(rng.random() < 0.5))
            src = src[:int(rng.integers(len(src) // 2, len(src) + 1))]
        out.append((kind, src, int(rng.integers(0, 5000))))
    return out


def test_packbits_and_lzw_loops_in_cxx_equal_python():
    """``wpt_packbits`` and ``wpt_lzw`` (new- and old-style codes) give the
    same bytes and status as ``packbits_plain`` and ``lzw_plain`` on every
    strip, good or bad."""
    seen = set()
    for kind, src, size in strips():
        if kind == "packbits":
            got = native.packbits_native(src, size)
            assert got == tiff.packbits_plain(src, size)
            seen.add((kind, got[1]))
            continue
        for old in (False, True):
            got = native.lzw_native(src, size, old)
            assert got == tiff.lzw_plain(src, size, old)
            seen.add((kind, old, got[1]))
    assert seen >= {("packbits", 0), ("packbits", 2), ("tiff_lzw", False, 0),
                    ("tiff_lzw", False, 1), ("tiff_lzw", False, 2),
                    ("tiff_lzw", True, 0), ("tiff_lzw", True, 1),
                    ("tiff_lzw", True, 2)}


def test_writers_lzw_is_libtiffs():
    """The test suite's LZW writer (the card's timing file) against Pillow
    through libtiff, past a table reset, on 8-bit data with predictor 2."""
    img = C.sample_image(300, 80, 12, 3)
    data = C.write_tiff(img, 8, 2, compression=5, predictor=2)
    got = C.assert_like_pillow(data)
    np.testing.assert_array_equal(got[..., :3], img)


@settings(max_examples=30, deadline=None)
@given(w=st.integers(1, 40), h=st.integers(1, 20),
       mode=st.sampled_from(["RGB", "RGBA", "L", "1", "P", "CMYK"]),
       compression=st.sampled_from(COMPRESSIONS),
       seed=st.integers(0, 2 ** 16))
def test_hypothesis_pillow_tiff(w, h, mode, compression, seed):
    img = Image.fromarray(C.sample_image(w, h, seed)).convert(mode)
    C.assert_like_pillow(C.pillow_bytes(img, "TIFF", compression=compression))


@pytest.mark.parametrize("name", ["env_rgb16.tif", "rgb_lzw.tif",
                                  "palette_raw.tif", "orientation6.tif"])
def test_tiff_env_map_equals_jax(name, tmp_path):
    path = str(tmp_path / "sky.png")
    with open(path, "wb") as f:
        f.write(fixture(name))
    np.testing.assert_array_equal(ENV.load_env_image(path),
                                  JENV.load_env_image(path))


@pytest.mark.parametrize("ratio", [0.5, 1.0])
def test_sidecar_textures_build_the_jax_atlas(ratio, tmp_path):
    """``textured_cornell()`` written to a .gltf whose four texture slots
    are sidecar files (``chip_smoke.LDR_TEXTURES``: an RLE TGA with alpha,
    an RLE8 BMP, a binary P6, an LZW TIFF with predictor 2) named by their
    ``uri``: the port's atlas equals the JAX ``build_atlas``'s, which reads
    each with Pillow whatever glTF's MIME types allow."""
    for name in LDR_TEXTURES:
        (tmp_path / name).write_bytes(fixture(name))
    path = tmp_path / "textured.gltf"
    path.write_text(with_sidecar_images(scene_to_glb(textured_cornell()),
                                        list(LDR_TEXTURES)))
    assert len(json.loads(path.read_text())["images"]) == 4
    got, got_rects = G.build_atlas(G.GLTFFile.load(str(path)), ratio)
    want, want_rects = JG.build_atlas(JG.GLTFFile.load(str(path)), ratio)
    np.testing.assert_array_equal(got, want)
    assert got_rects == want_rects
    assert sum(r[2] > 0 for rects in got_rects for r in rects.values()) == 4
