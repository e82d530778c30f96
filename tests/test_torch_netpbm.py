"""The port's netpbm reader (``utils/netpbm.py``) against Pillow 12.1.0's
``PpmImagePlugin``, which the JAX package reads LDR images with.

Every case is held array-equal to ``Image.open(...).convert("RGBA")``.
Pillow writes P4, P5 and P6 (and Pf); ``tests/torch_image_cases.py``
writes plain files (P1-P3) with comments, any maxval and 16-bit samples.
The scaling rules are Pillow's, each pinned: 16-bit gray is clipped at
255, not scaled, and other samples go through ``round(v / maxval *
out_max)``, Python's round half to even.
"""

import struct

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from wgpu_path_tracing_tpu.ops import env as JENV
from wgpu_path_tracing_tpu.utils import image as JIMAGE
from wgpu_path_tracing_tpu_torch.ops import env as ENV
from wgpu_path_tracing_tpu_torch.utils import image as IMAGE
from tests import torch_image_cases as C

torch.set_num_threads(1)

FIXTURES = np.load(f"{C.LDR_DIR}/pillow_rgba.npz")
PNM_FILES = sorted(n for n in FIXTURES.files
                   if n.endswith((".pbm", ".pgm", ".ppm")))


def fixture(name: str) -> bytes:
    with open(f"{C.LDR_DIR}/{name}", "rb") as f:
        return f.read()


@pytest.mark.parametrize("name", PNM_FILES)
def test_committed_netpbm_files_equal_pillow(name):
    data = fixture(name)
    np.testing.assert_array_equal(C.assert_like_pillow(data, name),
                                  FIXTURES[name])


@pytest.mark.parametrize("mode", ["RGB", "L", "1", "I;16", "F"])
def test_pillow_written_netpbm_equals_pillow(mode):
    """P6, P5, P4, P5 at maxval 65535 and Pf, as Pillow writes them."""
    img = Image.fromarray(C.sample_image(19, 11, 2, 3))
    img = img.convert("L").convert("I;16") if mode == "I;16" else \
        img.convert(mode)
    C.assert_like_pillow(C.pillow_bytes(img, "PPM"))


# (magic, maxval, samples, the RGB Pillow gives for the first pixel)
PROBES = {
    "p5_16bit_clipped": (b"P5", 65535, [55746, 41743, 33497], (255, 255, 255)),
    "p5_maxval_1000_clipped": (b"P5", 1000, [500, 3, 0], (255, 255, 255)),
    "p5_maxval_1000_small": (b"P5", 1000, [0, 3, 0], (0, 0, 0)),
    "p6_16bit_rounded": (b"P6", 65535, [41743, 1000, 65535], (162, 4, 255)),
    "p6_maxval_1000": (b"P6", 1000, [300, 2, 999], (76, 1, 255)),
    "p6_maxval_7": (b"P6", 7, [1, 3, 7], (36, 109, 255)),
    "p3_maxval_1000": (b"P3", 1000, [300, 2, 999], (76, 1, 255)),
    "p2_maxval_1000_clipped": (b"P2", 1000, [500, 1, 0], (255, 255, 255)),
}


@pytest.mark.parametrize("case", sorted(PROBES))
def test_maxval_rules_equal_pillow(case):
    """Pillow's maxval rules as the probes of the sandbox's Pillow showed
    them: 16-bit gray clipped, not scaled (a map renders nearly white), RGB
    scaled by maxval with rounding (41743 gives 162 where ``>> 8`` gives
    163)."""
    magic, maxval, samples, first = PROBES[case]
    gray = magic in (b"P2", b"P5")
    values = np.array(samples).reshape(1, -1 if gray else 1,
                                       1 if gray else 3)
    values = values[..., 0] if gray else values
    data = C.write_netpbm(magic, values, maxval)
    got = C.assert_like_pillow(data)
    assert tuple(got[0, 0, :3]) == (first if not gray else (first[0],) * 3)


WRITTEN = {
    "p1_with_comments": lambda: C.write_netpbm(
        b"P1", C.sample_image(13, 5, 3, 1)[..., 0] > 100, comments=True),
    "p1_no_whitespace": lambda: b"P1\n5 2\n0101011100",
    "p2_with_comments": lambda: C.write_netpbm(
        b"P2", C.sample_image(9, 6, 4, 1)[..., 0], 255, comments=True),
    "p3_maxval_255": lambda: C.write_netpbm(b"P3", C.sample_image(7, 5, 5, 3),
                                            255, line=5),
    "p4_odd_width": lambda: C.write_netpbm(
        b"P4", C.sample_image(11, 3, 6, 1)[..., 0] > 90),
    "p6_comment_in_width": lambda: C.write_netpbm(
        b"P6", C.sample_image(12, 4, 7, 3), 255, comments=True),
    "p6_maxval_1": lambda: C.write_netpbm(
        b"P6", C.sample_image(6, 3, 8, 3) >> 7, 1),
    "p5_extra_data_ignored": lambda: C.write_netpbm(
        b"P5", C.sample_image(6, 3, 9, 1)[..., 0], 255) + b"trailing",
    "pf_little_endian": lambda: b"Pf\n3 2\n-1.0\n" + np.array(
        [0.2, 2.7, -0.7, 255.4, 300.0, np.nan], "<f4").tobytes(),
    "pf_big_endian": lambda: b"Pf\n3 1\n2.5\n" + np.array(
        [1.5, 128.9, 1e9], ">f4").tobytes(),
    "p0cmyk": lambda: b"P0CMYK\n2 1\n255\n" + bytes([5, 200, 7, 9, 0, 0, 0, 0]),
    "pycmyk_maxval_1000": lambda: b"PyCMYK\n1 1\n1000\n" + struct.pack(
        ">4H", 5, 200, 700, 1),
    "pyrgba": lambda: b"PyRGBA\n2 1\n255\n" + bytes(range(8)),
    "pyrgba_maxval_3": lambda: b"PyRGBA\n1 1\n3\n" + bytes([1, 2, 3, 0]),
    "pyp_has_no_palette": lambda: b"PyP\n2 1\n255\n" + bytes([5, 200]),
}


@pytest.mark.parametrize("case", sorted(WRITTEN))
def test_written_variants_equal_pillow(case):
    """Plain files with comments inside tokens and data, P1 digits without
    whitespace, an odd P4 width, maxval 1, trailing bytes, Pf both byte
    orders (rows bottom-up, values truncated and clipped, NaN 0), Pillow's
    CMYK and RGBA magics, and ``PyP`` with no palette (black)."""
    C.assert_like_pillow(WRITTEN[case]())


REFUSED = {
    "p2_value_over_maxval": b"P2\n2 1\n10\n3 11",
    "p2_negative_value": b"P2\n2 1\n10\n3 -1",
    "p1_bad_digit": b"P1\n3 1\n012",
    "p5_truncated": b"P5\n4 2\n255\n" + bytes(7),
    "p6_maxval_0": b"P6\n1 1\n0\n" + bytes(3),
    "p6_maxval_70000": b"P6\n1 1\n70000\n" + bytes(6),
    "p6_comment_after_maxval": b"P6\n1 1\n255#x\n\x01\x02\x03\x04",
    "token_too_long": b"P5\n12345678901 1\n255\n" + bytes(2),
    "pf_scale_0": b"Pf\n1 1\n0\n" + bytes(4),
    "width_0": b"P5\n0 1\n255\n",
    "p7_is_no_netpbm": b"P7\nWIDTH 1\n",
    "magic_glued_to_a_comment": b"P6#c\n1 1\n255\n" + bytes(3),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_what_pillow_refuses_raises_naming_the_image(case):
    data = REFUSED[case]
    assert C.pillow_refuses(data)
    C.assert_refused(data, "r.ppm")


def test_plain_data_read_in_blocks_as_pillow_reads_it():
    """Pillow reads plain data in blocks of 1 MiB: a token and a comment cut
    by a block's end are joined to the next block."""
    n = 420_000
    values = (np.arange(n) * 7919) % 256
    body = b" ".join(str(v).encode() for v in values[:n // 2])
    body += b" # a comment across the block's end " + b"x" * 300_000 + b"\n "
    body += b" ".join(str(v).encode() for v in values[n // 2:])
    data = b"P2\n700 600\n255\n" + body
    assert len(data) > 1024 * 1024
    got = C.assert_like_pillow(data)
    np.testing.assert_array_equal(got[..., 0].reshape(-1), values)


@settings(max_examples=40, deadline=None)
@given(w=st.integers(1, 30), h=st.integers(1, 12),
       magic=st.sampled_from([b"P1", b"P2", b"P3", b"P4", b"P5", b"P6"]),
       maxval=st.sampled_from([1, 15, 255, 256, 1000, 65535]),
       seed=st.integers(0, 2 ** 16))
def test_hypothesis_netpbm(w, h, magic, maxval, seed):
    rng = np.random.default_rng(seed)
    shape = (h, w, 3) if magic in (b"P3", b"P6") else (h, w)
    values = rng.integers(0, maxval + 1, shape)
    if magic in (b"P1", b"P4"):
        values = values > maxval // 2
    data = C.write_netpbm(magic, values, maxval, comments=bool(seed % 2))
    C.assert_like_pillow(data)


@pytest.mark.parametrize("name", ["rgb16.ppm", "gray16.pgm", "bits.pbm",
                                  "rgb1000_plain.ppm"])
def test_netpbm_env_map_equals_jax(name, tmp_path):
    """A 16-bit gray map comes out nearly white in both packages."""
    path = str(tmp_path / "sky.png")
    with open(path, "wb") as f:
        f.write(fixture(name))
    np.testing.assert_array_equal(IMAGE.read_png(path), JIMAGE.read_png(path))
    np.testing.assert_array_equal(ENV.load_env_image(path),
                                  JENV.load_env_image(path))
