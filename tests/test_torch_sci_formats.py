"""The port's IM (``utils/im.py``), SPIDER (``utils/spider.py``), FITS
(``utils/fits.py``) and McIdas (``utils/mcidas.py``) readers against
Pillow 12.1.0, which the JAX package reads LDR images with.

Every case is held array-equal to ``Image.open(...).convert("RGBA")``
(or refused where Pillow refuses) and decoded twice, with the C++ loops
(``accel/cbvh/image_scan.cpp``'s ``wpt_bit_decode``, IM's "F;n" images)
and with their plain Python versions. Pillow writes IM and SPIDER;
``tests/torch_image_cases.py`` writes every IM image type, SPIDER stacks,
FITS at every BITPIX (raw and GZIP_1) and McIdas areas. The modes Pillow
reads as "I", "I;16" and "F" reach RGBA through "L" (clipped, then
truncated: ``utils/pilmodes.py``), "YCbCr" through Pillow's tables (read
out of Pillow by ``tools/pillow_ycc.py``).
"""

import hashlib
import json
import struct

import numpy as np
import pytest
import torch
from PIL import Image

from wgpu_path_tracing_tpu.models import gltf as JG
from wgpu_path_tracing_tpu.ops import env as JENV
from wgpu_path_tracing_tpu.utils import image as JIMAGE
from wgpu_path_tracing_tpu_torch.accel import native
from wgpu_path_tracing_tpu_torch.ops import env as ENV
from wgpu_path_tracing_tpu_torch.utils import im, pilmodes, sniff
from wgpu_path_tracing_tpu_torch.utils import image as IMAGE
from tests import torch_image_cases as C

torch.set_num_threads(1)

FIXTURES = np.load(f"{C.LDR_DIR}/pillow_rgba.npz")
FILES = sorted(n for n in FIXTURES.files
               if n.endswith((".im", ".spi", ".fits", ".area")))
GRAY = C.sample_image(19, 9, 80, 1)[..., 0]
FIELD = (GRAY.astype(np.float32) - 50.0) * 1.9


def fixture(name: str) -> bytes:
    with open(f"{C.LDR_DIR}/{name}", "rb") as f:
        return f.read()



@pytest.mark.parametrize("name", FILES)
def test_committed_files_equal_pillow(name):
    np.testing.assert_array_equal(C.assert_like_pillow(fixture(name), name),
                                  FIXTURES[name])


# --- IM ---------------------------------------------------------------------


@pytest.mark.parametrize("itype", sorted(im.OPEN))
@pytest.mark.parametrize("lut", ["none", "gray", "colour"])
def test_every_im_image_type_as_pillow(itype, lut):
    """Each "Image type" of Pillow's table over seeded bytes, without a
    palette, under a gray ramp that is not linear, and under colours."""
    rng = np.random.default_rng(len(itype))
    data = rng.integers(0, 256, 4 * 8 * 13 * 7 + 9, dtype=np.uint8).tobytes()
    palette = {"none": None, "gray": bytes(255 - np.arange(256, dtype=np.uint8)) * 3,
               "colour": rng.integers(0, 256, 768, dtype=np.uint8).tobytes()}
    C.assert_as_pillow(C.write_im(itype.encode(), 13, 7, data, lut=palette[lut]))


IM_HEADERS = {
    "lf_only": lambda: C.write_im(b"Greyscale image", 19, 9, GRAY.tobytes(),
                                  newline=b"\n"),
    "no_padding": lambda: C.write_im(b"RGB image", 6, 3, bytes(range(54)),
                                     pad=False),
    "name_and_comments": lambda: C.write_im(
        b"Greyscale image", 19, 9, GRAY.tobytes(),
        extra=b"Name: a\r\nComment: one\r\nComment: two\r\n"),
    "size_comma": lambda: C.write_im(b"Greyscale image", 19, 9,
                                     GRAY.tobytes(), size=b"19,9"),
    "size_one_number": lambda: C.write_im(b"Greyscale image", 19, 9,
                                          GRAY.tobytes(), size=b"19"),
    "size_float": lambda: C.write_im(b"Greyscale image", 19, 9,
                                     GRAY.tobytes(), size=b"19.0*9"),
    "size_three": lambda: C.write_im(b"Greyscale image", 19, 9,
                                     GRAY.tobytes(), size=b"19*9*2"),
    "size_text": lambda: C.write_im(b"Greyscale image", 19, 9,
                                    GRAY.tobytes(), size=b"ab*9"),
    "unknown_type": lambda: C.write_im(b"Weird image", 19, 9, GRAY.tobytes()),
    "type_l": lambda: C.write_im(b"L", 19, 9, GRAY.tobytes()),
    "type_rgb_mode": lambda: C.write_im(b"RGB", 19, 9, GRAY.tobytes() * 3),
    "bad_line": lambda: C.write_im(b"Greyscale image", 19, 9, GRAY.tobytes(),
                                   extra=b"no colon here\r\n"),
    "long_line": lambda: C.write_im(b"Greyscale image", 19, 9, GRAY.tobytes(),
                                    extra=b"Name: " + b"x" * 120 + b"\r\n"),
    "no_known_key": lambda: b"Foo: 1\r\nBar: 2\r\n\x1a" + GRAY.tobytes(),
    "data_cut": lambda: C.write_im(b"Greyscale image", 19, 9,
                                   GRAY.tobytes()[:-3]),
    "no_ctrl_z": lambda: C.write_im(b"Greyscale image", 19, 9, b"")[:-1],
    "lut_cut": lambda: C.write_im(b"Greyscale image", 19, 9, b"",
                                  lut=bytes(500)),
    "zero_size": lambda: C.write_im(b"Greyscale image", 0, 9, b""),
}


@pytest.mark.parametrize("case", sorted(IM_HEADERS))
def test_im_headers_as_pillow(case):
    C.assert_as_pillow(IM_HEADERS[case]())


@pytest.mark.parametrize("mode", ["L", "P", "RGB", "RGBA", "1", "LA", "CMYK",
                                  "YCbCr", "I", "F"])
@pytest.mark.parametrize("size", [(1, 1), (17, 5), (64, 3)])
def test_pillow_written_im_equals_pillow(mode, size):
    img = Image.fromarray(C.sample_image(*size, 81)).convert(mode)
    C.assert_like_pillow(C.pillow_bytes(img, "IM"))


@pytest.mark.parametrize("bits", [2, 3, 5, 7, 9, 12, 15, 17, 24, 25, 31])
@pytest.mark.parametrize("w", [1, 3, 10])
def test_bit_decoder_as_pillow(bits, w):
    """Pillow's bit decoder ("L*n image", n not 8, 16 or 32): n bits a
    pixel, least significant first, each row padded to a byte whose
    leftover bits Pillow ORs into the next row's first byte."""
    data = np.random.default_rng(bits * w).integers(
        0, 256, (w * bits + 7) // 8 * 6, dtype=np.uint8).tobytes()
    C.assert_like_pillow(C.write_im(b"L*%d image" % bits, w, 6, data))


@pytest.mark.parametrize("seed", range(8))
def test_bit_decoder_loops_agree(seed):
    """``wpt_bit_decode`` and ``bits_plain`` on random streams, cut or
    whole: the same rows and status."""
    rng = np.random.default_rng(seed)
    w, h, bits = int(rng.integers(1, 40)), int(rng.integers(1, 9)), int(
        rng.integers(1, 32))
    data = rng.integers(0, 256, int(rng.integers(0, 400)),
                        dtype=np.uint8).tobytes()
    pos = int(rng.integers(0, 5))
    a, sa = native.bit_decode_native(data, pos, w, h, bits)
    b, sb = im.bits_plain(data, pos, w, h, bits)
    assert sa == sb
    if not sa:
        np.testing.assert_array_equal(a, b)


def test_large_im_bits_equals_pillows_digest():
    """The 4096x2048 "L*12" file ``chip_smoke.py`` times decodes, in C++,
    to the array whose SHA-256 Pillow gave (``pillow_sha256.json``)."""
    with open(f"{C.LDR_DIR}/pillow_sha256.json") as f:
        want = json.load(f)[C.LARGE_IM_BITS]
    got = C.decode_in(True, C.large_im_bits())
    assert hashlib.sha256(got.tobytes()).hexdigest() == want


def test_ycbcr_conversion_equals_pillow():
    """``pilmodes.ycbcr_to_rgb`` against Pillow's ``convert`` on 2^16
    random triples (``tools/pillow_ycc.py --check`` covers all 2^24)."""
    ycc = np.random.default_rng(3).integers(0, 256, (256, 256, 3),
                                             dtype=np.uint8)
    want = np.asarray(Image.fromarray(ycc, "YCbCr").convert("RGB"))
    np.testing.assert_array_equal(pilmodes.ycbcr_to_rgb(ycc), want)


@pytest.mark.parametrize("values", [[-3.7, 128.6, 300.2, 0.99],
                                    [float("nan"), float("inf"),
                                     -float("inf"), 254.9999]])
def test_float_to_gray_as_pillow(values):
    """"F" to "L": clipped, then truncated (-3.7 gives 0, 128.6 gives 128,
    300.2 gives 255), NaN 0."""
    f = np.array([values], np.float32)
    want = np.asarray(Image.fromarray(f).convert("L"))
    np.testing.assert_array_equal(pilmodes.gray8(f), want)
    if not np.isnan(f).any():
        assert pilmodes.gray8(np.array([-3.7, 128.6, 300.2], np.float32)
                              ).tolist() == [0, 128, 255]


# --- SPIDER -----------------------------------------------------------------


@pytest.mark.parametrize("big", [True, False])
@pytest.mark.parametrize("stack", [0, 1, 3])
@pytest.mark.parametrize("shape", [(9, 19), (1, 1), (2, 300)])
def test_spider_images_and_stacks_equal_pillow(big, stack, shape):
    values = (np.random.default_rng(stack).random(shape) - 0.3) * 400
    C.assert_like_pillow(C.write_spider(values.astype(np.float32), big,
                                        stack))


def _spider_header_cases() -> dict:
    base = C.write_spider(FIELD, True)

    def at(k, v):
        d = bytearray(base)
        struct.pack_into(">f", d, 4 * k, v)
        return bytes(d)

    return {"iform_3": at(4, 3.0), "iform_bad": at(4, 7.0),
            "labbyt_wrong": at(21, 100.0), "nsam_fraction": at(11, 2.5),
            "stack_image_alone": at(26, 1.0), "cut_header": base[:100],
            "data_cut": base[:-5], "nsam_negative": at(11, -4.0),
            "istack_negative": at(23, -1.0)}


SPIDER_HEADERS = _spider_header_cases()


@pytest.mark.parametrize("case", sorted(SPIDER_HEADERS))
def test_spider_headers_as_pillow(case):
    C.assert_as_pillow(SPIDER_HEADERS[case])


# --- FITS -------------------------------------------------------------------


FITS_VALUES = {8: GRAY, 16: GRAY.astype(np.int32) * 350 - 10000,
               32: GRAY.astype(np.int32) * 900 - 80000, -32: FIELD,
               -64: FIELD * 0.7}


@pytest.mark.parametrize("bitpix", sorted(FITS_VALUES))
@pytest.mark.parametrize("gzip_tile", [False, True])
def test_fits_every_bitpix_equals_pillow(bitpix, gzip_tile):
    """Each BITPIX raw (16-bit samples read little-endian, -64 as 4-byte
    floats, rows bottom-up) and GZIP_1 (the last bytes of each 4; none
    for a float image, which Pillow refuses)."""
    C.assert_as_pillow(C.write_fits(FITS_VALUES[bitpix], bitpix, gzip_tile=gzip_tile))


FITS_CASES = {
    "naxis_1": lambda: C.write_fits(GRAY[:1], 8).replace(
        b"NAXIS   =                    2", b"NAXIS   =                    1"),
    "bitpix_64": lambda: C.write_fits(GRAY, 8).replace(
        b"BITPIX  =                    8", b"BITPIX  =                   64"),
    "no_image": lambda: C.fits_cards([(b"SIMPLE", b"T"), (b"BITPIX", b"8"),
                                      (b"NAXIS", b"0")]) + bytes(2880),
    "not_simple": lambda: C.write_fits(GRAY, 8).replace(
        b"SIMPLE  =                    T", b"SIMPLE  =                    F"),
    "header_cut": lambda: C.write_fits(GRAY, 8)[:600],
    "data_cut": lambda: C.write_fits(GRAY, 8)[:2880 + 50],
    "comments": lambda: C.write_fits(GRAY, 8, extra=[
        (b"COMMENT", b"'x'"), (b"BZERO", b"0 / a note")]),
    "no_naxis2": lambda: C.write_fits(GRAY, 8).replace(b"NAXIS2", b"NAXISX"),
    "gzip_padded": lambda: C.write_fits(GRAY, 8, gzip_tile=True) + bytes(40),
    "naxis_text": lambda: C.write_fits(GRAY, 8).replace(
        b"NAXIS1  =                   19", b"NAXIS1  =                  abc"),
}


@pytest.mark.parametrize("case", sorted(FITS_CASES))
def test_fits_headers_as_pillow(case):
    C.assert_as_pillow(FITS_CASES[case]())


# --- McIdas -----------------------------------------------------------------


@pytest.mark.parametrize("unit", [1, 2, 4])
@pytest.mark.parametrize("layout", [(0, 1, 256), (3, 1, 256), (0, 2, 300),
                                    (5, 3, 260)])
def test_mcidas_areas_equal_pillow(unit, layout):
    prefix, bands, at = layout
    values = {1: GRAY, 2: GRAY.astype(np.int64) * 300,
              4: GRAY.astype(np.int64) * 1000 - 70000}[unit]
    C.assert_like_pillow(C.write_mcidas(values, unit, prefix, bands, at))


def test_mcidas_32_bit_clips():
    """"I" reaches RGBA clipped: 70,000 gives 255, -5 gives 0."""
    got = C.assert_like_pillow(C.write_mcidas(np.array([[70000, -5, 130]]),
                                              4))
    assert got[0, :, 0].tolist() == [255, 0, 130]


@pytest.mark.parametrize("case", ["unit_3", "cut_descriptor", "cut_rows",
                                  "zero_width"])
def test_mcidas_refusals_as_pillow(case):
    data = bytearray(C.write_mcidas(GRAY, 1))
    if case == "unit_3":
        struct.pack_into(">i", data, 40, 3)
    elif case == "cut_descriptor":
        data = data[:200]
    elif case == "cut_rows":
        data = data[:-4]
    else:
        struct.pack_into(">i", data, 36, 0)
    C.assert_as_pillow(bytes(data))


# --- against the JAX package, sniffing, the native library ------------------


@pytest.mark.parametrize("name", ["pillow_RGB.im", "f12_bits.im",
                                  "b4_colour_lut.im", "stack_little.spi",
                                  "gzip_bitpix16.fits", "mcidas32_bands.area"])
def test_jax_decode_image_equals_port(name):
    data = fixture(name)
    np.testing.assert_array_equal(IMAGE.decode_image_rgba(data, name),
                                  JG._decode_image(data))


@pytest.mark.parametrize("name", ["env_float.fits", "env.spi",
                                  "pillow_YCbCr.im"])
@pytest.mark.parametrize("in_cxx", [True, False])
def test_env_maps_equal_jax(name, in_cxx, tmp_path, monkeypatch):
    if not in_cxx:
        monkeypatch.setattr(native, "native_available", lambda: False)
    path = str(tmp_path / "sky.png")
    with open(path, "wb") as f:
        f.write(fixture(name))
    np.testing.assert_array_equal(IMAGE.read_png(path), JIMAGE.read_png(path))
    np.testing.assert_array_equal(ENV.load_env_image(path),
                                  JENV.load_env_image(path))


def test_signatures_and_order():
    assert list(sniff.pillow_candidates(fixture("bitpix8.fits"))) == [
        "FITS", *C.ANY_BYTES, "TGA"]
    assert list(sniff.pillow_candidates(fixture("mcidas8.area"))) == [
        "IM", "IMT", "IPTC", "MCIDAS", "PCD", "SPIDER", "TGA"]
    assert "IM" in list(sniff.pillow_candidates(fixture("pillow_L.im")))
    assert "SPIDER" in list(sniff.pillow_candidates(fixture("pillow.spi")))


def test_a_failed_native_build_raises(monkeypatch):
    def fail(cxx=None):
        raise RuntimeError("g++ failed to build the native library")

    monkeypatch.setattr(native._Lib, "handle", None)
    monkeypatch.setattr(native, "build", fail)
    monkeypatch.setattr(native, "native_available", lambda: True)
    with pytest.raises(RuntimeError, match="failed to build"):
        IMAGE.decode_image_rgba(fixture("f12_bits.im"), "f12_bits.im")
