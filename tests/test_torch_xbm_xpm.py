"""The port's XBM (``utils/xbm.py``) and XPM (``utils/xpm.py``) readers
against Pillow 12.1.0, which the JAX package reads LDR images with.

Every case is held array-equal to ``Image.open(...).convert("RGBA")``.
Both formats come after TGA in Pillow's order, and TGA has no signature:
the tests show that the TGA reader passes ``#define`` and ``/* XPM */``
headers on (leading white space included), so the files reach XBM and
XPM. Pillow writes XBM; ``tests/torch_image_cases.py`` writes the rest:
XBM with other spellings of its bytes, XPM palettes with ``None`` keys,
more than 256 colours, keys of several bytes, and pixel lines of any
length.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from wgpu_path_tracing_tpu.models import gltf as JG
from wgpu_path_tracing_tpu.ops import env as JENV
from wgpu_path_tracing_tpu.utils import image as JIMAGE
from wgpu_path_tracing_tpu_torch.ops import env as ENV
from wgpu_path_tracing_tpu_torch.utils import image as IMAGE
from wgpu_path_tracing_tpu_torch.utils import sniff, tga, xbm
from tests import torch_image_cases as C

torch.set_num_threads(1)

FIXTURES = np.load(f"{C.LDR_DIR}/pillow_rgba.npz")
FILES = sorted(n for n in FIXTURES.files if n.endswith((".xbm", ".xpm")))


def fixture(name: str) -> bytes:
    with open(f"{C.LDR_DIR}/{name}", "rb") as f:
        return f.read()


@pytest.mark.parametrize("name", FILES)
def test_committed_xbm_xpm_files_equal_pillow(name):
    np.testing.assert_array_equal(C.assert_like_pillow(fixture(name), name),
                                  FIXTURES[name])


def bits(w: int, h: int, seed: int) -> np.ndarray:
    return (C.sample_image(w, h, seed, 1)[..., 0] > 120).astype(np.uint8)


@pytest.mark.parametrize("size", [(1, 1), (8, 2), (9, 5), (33, 17),
                                  (64, 3)])
@pytest.mark.parametrize("hotspot", [None, (2, 1)])
def test_pillow_written_xbm_equals_pillow(size, hotspot):
    img = Image.fromarray(bits(*size, seed=sum(size)) * 255).convert("1")
    kw = {"hotspot": hotspot} if hotspot else {}
    C.assert_like_pillow(C.pillow_bytes(img, "XBM", **kw))


B = bits(12, 3, 1)
XBM = C.write_xbm(B)
XBM_VARIANTS = {
    "upper_case_hex": lambda: C.write_xbm(B, fmt="0x{:X}"),
    "leading_white_space": lambda: C.write_xbm(B, prefix=b"\n \t\r\n"),
    "one_byte_a_line": lambda: C.write_xbm(B, per_line=1),
    "upper_case_x_skipped": lambda: XBM.replace(b"0x", b"0X", 2).replace(
        b"};", b"0x01, 0x02, };"),
    "x_in_a_comment": lambda: XBM.replace(b"{\n", b"{ /* ox */\n"),
    "x_inside_a_byte_passed_over": lambda: XBM.replace(b"0x", b"0xxx ", 1),
    "non_hex_digits_count_0": lambda: XBM.replace(b"0x", b"0xg", 1),
    "bytes_past_the_last_row": lambda: XBM.replace(b"};", b"0xff, 0xee };"),
    "no_comma_needed": lambda: XBM.replace(b", ", b""),
    "hotspot": lambda: C.write_xbm(B, hotspot=(5, 6)),
    "cr_line_ends": lambda: XBM.replace(b"\n", b"\r\n"),
}


@pytest.mark.parametrize("case", sorted(XBM_VARIANTS))
def test_xbm_variants_equal_pillow(case):
    """Each byte found by the next lower-case ``x`` and read from the two
    characters after it (a non-hex one as 0), the search going on three
    bytes later; the first pixel in the lowest bit, a set bit white."""
    C.assert_like_pillow(XBM_VARIANTS[case]())


def test_overlapping_x_runs_choose_as_pillow():
    """A run of ``x`` bytes: each taken ``x`` covers the two after it.
    ``xbm.byte_starts`` picks by binary lifting what Pillow's decoder
    picks one at a time."""
    data = C.write_xbm(bits(40, 4, 2))
    head, _, _ = data.partition(b"{")
    for run in (b"x" * 7, b"xx0x1xxx2x", b"x0xx00xxx000"):
        C.assert_like_pillow(head + b"{ " + run * 12 + b" };")
    xs = np.flatnonzero(np.frombuffer(b"xxxxxxx.x.xxxx", np.uint8)
                        == ord("x"))
    np.testing.assert_array_equal(xbm.byte_starts(xs), [0, 3, 6, 10, 13])


def xpm(lines: list, tail: bytes = b"};\n") -> bytes:
    return b"/* XPM */\nstatic char *x[] = {\n" + b"\n".join(lines) \
        + b"\n" + tail


IDX, COLS = C.quantize(C.sample_image(9, 5, 3, 3))


def in_pixels(data: bytes, edit) -> bytes:
    """``data`` with ``edit`` applied to what follows its ``/* pixels */``
    line only."""
    head, mark, tail = data.partition(b"/* pixels */")
    return head + mark + edit(tail)


def short_first_row(pixels: bytes) -> bytes:
    """The first pixel line a key short, the last a key long."""
    lines = pixels.split(b"\n")
    lines[1] = lines[1][:3] + lines[1][4:]
    lines[-3] = lines[-3][:-2] + b'.",'
    return b"\n".join(lines)


XPM_VARIANTS = {
    "none_key_gives_index_0_alpha_32": lambda: xpm([
        b'"3 1 2 1",', b'"  c None",', b'"a c #ff0000",', b'"aaa",']),
    "two_byte_none_key": lambda: xpm([
        b'"3 1 3 2",', b'"ab c None",', b'"cd c #ff0000",',
        b'"ef c #00ff00",', b'"cdefcd",']),
    "duplicate_key_keeps_its_place": lambda: xpm([
        b'"2 1 3 1",', b'"a c #ff0000",', b'"b c #00ff00",',
        b'"a c #0000ff",', b'"ab",']),
    "none_then_colour_for_one_key": lambda: xpm([
        b'"2 1 2 1",', b'"a c None",', b'"a c #123456",', b'"aa",']),
    "rows_in_one_line": lambda: xpm([
        b'"2 2 1 1",', b'"a c #ff0000",', b'"aaaa",']),
    "long_rows_shift": lambda: in_pixels(
        C.write_xpm(IDX, C.xpm_colours(COLS)),
        lambda p: p.replace(b'",\n"', b'",\n".', 2)),
    "short_row_shifts": lambda: in_pixels(
        C.write_xpm(IDX, C.xpm_colours(COLS)), short_first_row),
    "lines_after_the_image_not_read": lambda: xpm([
        b'"2 1 1 1",', b'"a c #ff0000",', b'"aa",', b'"zz",']),
    "quotes_inside_a_line": lambda: xpm([
        b'"5 1 3 1",', b'"a c #ff0000",', b'"b c #0000ff",',
        b'"" c #00ff00",', b'"a"b"a",']),
    "other_words_before_c": lambda: xpm([
        b'"2 1 1 1",', b'"a s mine m #000000 c #2040f0",', b'"aa",']),
    "hex_of_other_lengths": lambda: xpm([
        b'"3 1 3 1",', b'"a c #fff",', b'"b c #1234567",',
        b'"c c #-1",', b'"abc",']),
    "pixels_comment_and_blank_lines": lambda: xpm([
        b'"2 2 1 1",', b'"a c #ff0000",', b"/* pixels */", b"", b'"aa",',
        b"/* pixels */", b'"aa"']),
    "header_after_other_lines": lambda: xpm([
        b"/* a comment */", b'"2 1 1 1" extra,', b'"a c #ff0000",',
        b'"aa",']),
    "more_than_256_colours_rgb": lambda: C.write_xpm(
        np.arange(12).reshape(3, 4), C.xpm_colours(
            C.sample_image(300, 1, 4, 3)[0]), bpp=2),
    "keys_of_3_bytes": lambda: C.write_xpm(IDX, C.xpm_colours(COLS), bpp=3),
    "keys_of_9_bytes": lambda: C.write_xpm(IDX, C.xpm_colours(COLS), bpp=9),
}


@pytest.mark.parametrize("case", sorted(XPM_VARIANTS))
def test_xpm_variants_equal_pillow(case):
    """The ``None`` key's bytes as alphas of the first palette entries, a
    repeated key's first place and last colour, the pixel lines one stream
    read up to the image's size, keys cut from between the first and the
    last double quote, and more than 256 colour lines an RGB image."""
    C.assert_like_pillow(XPM_VARIANTS[case]())


REFUSED = {
    "xbm_cut_short": XBM[:-40],
    "xbm_x_at_the_end": XBM.split(b"{")[0] + b"{ 0x",
    "xpm_colour_name": xpm([b'"1 1 1 1",', b'"a c red",', b'"a",']),
    "xpm_no_c_word": xpm([b'"1 1 1 1",', b'"a s sym",', b'"a",']),
    "xpm_colour_line_missing": xpm([b'"1 1 2 1",', b'"a c #000000",'],
                                   tail=b""),
    "xpm_none_key_used": xpm([b'"2 1 2 1",', b'"  c None",',
                              b'"a c #ff0000",', b'"a ",']),
    "xpm_unknown_key": xpm([b'"2 1 1 1",', b'"a c #ff0000",', b'"ab",']),
    "xpm_unknown_key_rgb": in_pixels(C.write_xpm(
        np.arange(4).reshape(1, 4), C.xpm_colours(C.sample_image(
            300, 1, 5, 3)[0]), bpp=2), lambda p: p.replace(b'"..', b'"!!')),
    "xpm_last_key_short": xpm([
        b'"3 1 2 2",', b'"aa c #ff0000",', b'"a c #00ff00",', b'"aaaaa",']),
    "xpm_rgb_with_a_none_key": C.write_xpm(
        np.arange(1, 5).reshape(1, 4), [b"None"] + C.xpm_colours(
            C.sample_image(300, 1, 6, 3)[0]), bpp=2),
    "xpm_too_few_pixels": xpm([b'"3 2 1 1",', b'"a c #ff0000",', b'"aaa",']),
    "xpm_empty_size": xpm([b'" 1 1 1",', b'"a c #ff0000",', b'"a",']),
    "xpm_keys_of_0_bytes": xpm([b'"1 1 1 0",', b'" c #ff0000",', b'"a",']),
    "xpm_bad_hex": xpm([b'"1 1 1 1",', b'"a c #zz",', b'"a",']),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_what_pillow_refuses_raises_naming_the_image(case):
    data = REFUSED[case]
    assert C.pillow_refuses(data)
    C.assert_refused(data, "r.xpm", exc=ValueError)


PASSED_ON = {
    "xbm_header_past_512_bytes": b"#define im_width 8\n#define im_height 1\n"
    + b"/*" + b" " * 600 + b"*/ static char im_bits[] = { 0x01 };",
    "xbm_no_height": b"#define im_width 8\nstatic char im_bits[] = {0x01};",
    "xbm_no_pixels": C.write_xbm(np.zeros((0, 4), np.uint8)),
    "xpm_no_header": b"/* XPM */\nstatic char *x[] = {\n};\n",
    "xpm_c_without_a_value": xpm([b'"1 1 1 1",', b'"a c",', b'"a",']),
    "xpm_no_pixels": xpm([b'"0 1 1 1",', b'"a c #ff0000",']),
}


@pytest.mark.parametrize("case", sorted(PASSED_ON))
def test_headers_pillow_passes_on_are_passed_on(case):
    data = PASSED_ON[case]
    with pytest.raises(Exception, match="cannot identify"):
        C.pillow_rgba(data)
    C.assert_refused(data, "p.xbm", exc=ValueError,
                     match="not an image Pillow can identify")


@pytest.mark.parametrize("name", ["pillow.xbm", "hotspot_leading_space.xbm",
                                  "palette.xpm", "rgb_343_colours.xpm"])
def test_tga_passes_the_headers_on(name):
    """TGA, tried before XBM and XPM on any bytes, passes these headers on
    (their second byte is no colour-map type), as Pillow's ``_open``
    does, so the walk reaches XBM or XPM."""
    data = fixture(name)
    order = list(sniff.pillow_candidates(data))
    fmt = "XBM" if name.endswith(".xbm") else "XPM"
    assert order.index("TGA") < order.index(fmt)
    assert [f for f in order if f not in ("TGA", "WEBP")][-1] == fmt
    with pytest.raises(sniff.NotThisFormat):
        tga.decode_tga_rgba(data, name)


@pytest.mark.parametrize("space", [b" ", b"\t", b"\n", b"\r\n", b"  \x0b\x0c"])
def test_leading_white_space_still_reaches_xbm(space):
    data = C.write_xbm(B, prefix=space)
    assert sniff.ACCEPT["XBM"](data[:16])
    with pytest.raises(sniff.NotThisFormat):
        tga.decode_tga_rgba(data, "w.xbm")
    C.assert_like_pillow(data)


@settings(max_examples=40, deadline=None)
@given(w=st.integers(1, 40), h=st.integers(1, 12),
       per_line=st.integers(1, 20), seed=st.integers(0, 2 ** 16))
def test_hypothesis_xbm(w, h, per_line, seed):
    C.assert_like_pillow(C.write_xbm(bits(w, h, seed), per_line=per_line))


@settings(max_examples=40, deadline=None)
@given(w=st.integers(1, 30), h=st.integers(1, 10),
       levels=st.sampled_from([2, 3, 4]), bpp=st.integers(1, 3),
       seed=st.integers(0, 2 ** 16))
def test_hypothesis_xpm(w, h, levels, bpp, seed):
    idx, cols = C.quantize(C.sample_image(w, h, seed, 3), levels)
    C.assert_like_pillow(C.write_xpm(idx, C.xpm_colours(cols), bpp=bpp))


@pytest.mark.parametrize("name", ["pillow.xbm", "none_key_space_alpha.xpm",
                                  "rgb_343_colours.xpm"])
def test_jax_decode_image_equals_port(name):
    data = fixture(name)
    np.testing.assert_array_equal(IMAGE.decode_image_rgba(data, name),
                                  JG._decode_image(data))


@pytest.mark.parametrize("name", ["hotspot_leading_space.xbm", "palette.xpm"])
def test_xbm_xpm_env_map_equals_jax(name, tmp_path):
    path = str(tmp_path / "sky.png")
    with open(path, "wb") as f:
        f.write(fixture(name))
    np.testing.assert_array_equal(IMAGE.read_png(path), JIMAGE.read_png(path))
    np.testing.assert_array_equal(ENV.load_env_image(path),
                                  JENV.load_env_image(path))
