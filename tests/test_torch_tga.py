"""The port's TGA reader (``utils/tga.py``) and the format sniffing of
``utils/image.py::decode_image_rgba`` (``utils/sniff.py``) against Pillow
12.1.0, which the JAX package reads LDR images with.

Every case is held array-equal to ``Image.open(...).convert("RGBA")``, and
decoded twice: with the C++ run-length loop (``accel/cbvh/image_scan.cpp``)
and with its plain Python version. Pillow writes raw and RLE TGA at 8, 24
and 32 bits, 8-bit colour-mapped and 16-bit gray + alpha;
``tests/torch_image_cases.py`` writes the rest (16-bit colour and colour
maps, every origin, raw packets across rows, gray images that carry a map).
TGA has no signature, so a file is read as TGA only when no format before
it in Pillow's order might take it: the table over every format Pillow can
write holds the port to Pillow's array or to an error, never another array.
"""

import io
import struct

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from wgpu_path_tracing_tpu.ops import env as JENV
from wgpu_path_tracing_tpu.utils import image as JIMAGE
from wgpu_path_tracing_tpu_torch.accel import native
from wgpu_path_tracing_tpu_torch.ops import env as ENV
from wgpu_path_tracing_tpu_torch.utils import image as IMAGE
from wgpu_path_tracing_tpu_torch.utils import sniff, tga
from tests import torch_image_cases as C

torch.set_num_threads(1)

FIXTURES = np.load(f"{C.LDR_DIR}/pillow_rgba.npz")
TGA_FILES = sorted(n for n in FIXTURES.files if n.endswith(".tga"))


def fixture(name: str) -> bytes:
    with open(f"{C.LDR_DIR}/{name}", "rb") as f:
        return f.read()


def header(itype, depth, w, h, flags=0, cmap=None, ident=b""):
    """An 18-byte TGA header (+ ID and map): ``cmap`` = (start, length,
    depth, bytes)."""
    start, length, cdepth, pal = cmap or (0, 0, 0, b"")
    return struct.pack("<BBBHHBHHHHBB", len(ident), int(cmap is not None),
                       itype, start, length, cdepth, 0, 0, w, h, depth,
                       flags) + ident + pal


@pytest.mark.parametrize("name", TGA_FILES)
def test_committed_tga_files_equal_pillow(name):
    """The files under ``tests/ldr`` decode to ``pillow_rgba.npz``, which
    Pillow here still gives."""
    data = fixture(name)
    np.testing.assert_array_equal(C.assert_like_pillow(data, name),
                                  FIXTURES[name])


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "P", "LA", "1"])
@pytest.mark.parametrize("rle", [False, True], ids=["raw", "rle"])
def test_pillow_written_tga_equals_pillow(mode, rle):
    """Pillow's own TGA writer, raw and RLE, at every mode it writes; a
    1-bit RLE file, which Pillow writes but cannot read, raises."""
    img = Image.fromarray(C.sample_image(23, 14, 3)).convert(mode)
    data = C.pillow_bytes(img, "TGA", rle=rle)
    if mode == "1" and rle:
        assert C.pillow_refuses(data)
        C.assert_refused(data, "t.tga", match="Pillow cannot decode")
    else:
        C.assert_like_pillow(data)


def a1r5g5b5(seed=4, w=19, h=9):
    return C.to_a1r5g5b5(C.sample_image(w, h, seed))


VARIANTS = {
    "16bit_bottom_left": lambda: C.write_tga(a1r5g5b5(), 2, 16),
    "16bit_rle_top_right": lambda: C.write_tga(a1r5g5b5(), 10, 16,
                                               bottom=False, mirror=True),
    "32bit_rle_bottom_right": lambda: C.write_tga(
        C.sample_image(17, 11, 5)[..., [2, 1, 0, 3]], 10, 32, mirror=True),
    "32bit_alpha_zero_everywhere": lambda: C.write_tga(
        np.concatenate([C.sample_image(9, 5, 6, 3),
                        np.zeros((5, 9, 1), np.uint8)], -1), 2, 32),
    "24bit_rle_rows_apart": lambda: C.write_tga(
        C.sample_image(31, 7, 7, 3), 10, 24, cross_rows=False),
    "24bit_rle_across_rows": lambda: C.write_tga(
        C.sample_image(3, 40, 8, 3), 10, 24),
    "cmap24_start_3": lambda: C.write_tga(
        (C.sample_image(13, 6, 9, 1) >> 3) + 1, 1, 8,
        cmap=C.sample_image(40, 1, 10, 3)[0], cmap_start=3),
    "cmap16_rle_alpha_bit": lambda: C.write_tga(
        (C.sample_image(13, 6, 9, 1) >> 4), 9, 8, cmap=a1r5g5b5(11, 16, 1)[0],
        cmap_depth=16),
    "gray_with_a_map": lambda: C.write_tga(
        C.sample_image(12, 5, 12, 1) >> 2, 3, 8,
        cmap=C.sample_image(70, 1, 13, 3)[0]),
    "gray_alpha_with_a_16bit_map": lambda: C.write_tga(
        np.stack([C.sample_image(12, 5, 12, 1)[..., 0] >> 3,
                  C.sample_image(12, 5, 14, 1)[..., 0]], -1), 11, 16,
        cmap=a1r5g5b5(15, 40, 1)[0], cmap_depth=16),
    "1bit_raw": lambda: C.write_tga(
        (C.sample_image(21, 5, 16, 1) > 128).astype(np.uint8), 3, 1),
    "id_field": lambda: C.write_tga(C.sample_image(5, 4, 17, 1), 3, 8,
                                    ident=b"texture made by a test"),
}


@pytest.mark.parametrize("case", sorted(VARIANTS))
def test_written_variants_equal_pillow(case):
    """16-bit colour (alpha 0 where its top bit is set), colour maps of 16
    and 24 bits with a start offset and indices past the map, every
    origin, raw packets across rows, gray images that carry a map (Pillow
    looks their values up in it), 1-bit raw, an ID field."""
    C.assert_like_pillow(VARIANTS[case]())


REFUSED = {
    "run_packet_across_rows": header(10, 8, 3, 2) + bytes([0x84, 7, 0, 9]),
    "rle_cut_short": header(11, 8, 3, 2) + bytes([0x82, 7]),
    "raw_cut_short": header(3, 8, 3, 2) + bytes(5),
    "rle_1bit": header(11, 1, 8, 1) + bytes([0, 0xB0]),
    "map_32bit": header(1, 8, 2, 1, cmap=(0, 2, 32, bytes(8))) + bytes(2),
    "map_on_true_colour": header(2, 24, 1, 1, cmap=(0, 1, 24, bytes(3)))
    + bytes(3),
    "map_of_300_entries": header(1, 8, 2, 1, cmap=(0, 300, 24, bytes(900)))
    + bytes(2),
    "true_colour_at_8_bits": header(2, 8, 2, 1) + bytes(2),
    "colour_mapped_without_a_map": header(1, 8, 2, 1) + bytes(2),
    "depth_15_is_no_tga": header(2, 15, 2, 1) + bytes(4),
    "map_depth_15_is_no_tga": header(1, 8, 1, 1, cmap=(0, 1, 15, bytes(2)))
    + bytes(1),
    "image_type_4_is_no_tga": header(4, 8, 2, 1) + bytes(2),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_what_pillow_refuses_raises_naming_the_image(case):
    """Pillow raises on each (a header its checks reject is passed on to
    its next formats, and none takes it); so does the port, naming the
    image."""
    data = REFUSED[case]
    assert C.pillow_refuses(data)
    C.assert_refused(data, "r.tga")


def rle_streams():
    """Run-length data of every fixture and written case, and random
    packets (some running across rows, some cut short)."""
    rng = np.random.default_rng(3)
    out = []
    for name in TGA_FILES:
        data = fixture(name)
        if data[2] & 8:
            w, h, depth = struct.unpack_from("<HHB", data, 12)
            cmap = data[1] * struct.unpack_from("<H", data, 5)[0] * (
                (data[7] + 7) // 8)
            out.append((data, 18 + data[0] + cmap, depth // 8, w, w * h))
    for _ in range(400):
        bpp, w, h = int(rng.integers(1, 5)), int(rng.integers(1, 9)), \
            int(rng.integers(1, 5))
        body = bytearray()
        while len(body) < 6 * w * h:
            k = int(rng.integers(1, 5))
            if rng.random() < 0.5:
                body += bytes([0x80 | (k - 1)]) + bytes(rng.integers(
                    0, 256, bpp, dtype=np.uint8))
            else:
                body += bytes([k - 1]) + bytes(rng.integers(
                    0, 256, bpp * k, dtype=np.uint8))
        cut = int(rng.integers(0, len(body) + 1))
        out.append((bytes(body[:cut]), 0, bpp, w, w * h))
    return out


def test_rle_loop_in_cxx_equals_python():
    """``wpt_tga_rle`` and ``tga.rle_plain`` give the same bytes and status
    on every stream, good or bad."""
    statuses = set()
    for data, pos, bpp, w, n in rle_streams():
        got, status = native.tga_rle_native(data, pos, bpp, w, n)
        want, want_status = tga.rle_plain(data, pos, bpp, w, n)
        assert status == want_status
        np.testing.assert_array_equal(got, want)
        statuses.add(status)
    assert statuses == {0, 1, 2}


@settings(max_examples=40, deadline=None)
@given(w=st.integers(1, 40), h=st.integers(1, 20),
       mode=st.sampled_from(["RGB", "RGBA", "L", "P", "LA"]),
       rle=st.booleans(), seed=st.integers(0, 2 ** 16))
def test_hypothesis_pillow_tga(w, h, mode, rle, seed):
    img = Image.fromarray(C.sample_image(w, h, seed)).convert(mode)
    C.assert_like_pillow(C.pillow_bytes(img, "TGA", rle=rle))


def save_table():
    """One small image in every mode each format of ``Image.SAVE`` writes."""
    Image.init()
    rgb = Image.fromarray(C.sample_image(32, 16, 1, 3))
    cases = []
    for fmt in sorted(Image.SAVE):
        for mode in ("RGB", "RGBA", "L", "1", "P", "I;16", "F"):
            img = rgb.convert("L").convert(mode) if mode == "I;16" \
                else rgb.convert(mode)
            buf = io.BytesIO()
            try:
                img.save(buf, fmt)
            except Exception:
                continue
            cases.append((fmt, mode, buf.getvalue()))
    return cases


@pytest.mark.parametrize("fmt", ["AVIF", "BLP", "BMP", "DDS", "DIB", "EPS",
                                 "GIF", "ICNS", "ICO", "IM", "JPEG",
                                 "JPEG2000", "MPO", "MSP", "PALM", "PCX",
                                 "PDF", "PNG", "PPM", "QOI", "SGI", "SPIDER",
                                 "TGA", "TIFF", "WEBP", "XBM"])
def test_every_format_pillow_writes_reads_as_pillow_or_raises(fmt):
    """For a small file of each format Pillow can write, in each mode it
    writes: the port returns Pillow's array, or raises naming the file;
    never another array. A format the port does not read raises naming the
    format Pillow opens it as (never read as TGA)."""
    cases = [c for c in SAVE_TABLE if c[0] == fmt]
    assert cases, f"this Pillow writes no {fmt} file"
    for _, mode, data in cases:
        try:
            with Image.open(io.BytesIO(data)) as im:
                opened = im.format
                want = np.asarray(im.convert("RGBA"))
        except Exception:
            opened, want = None, None
        try:
            got = IMAGE.decode_image_rgba(data, "s.img")
        except (ValueError, NotImplementedError) as exc:
            assert "s.img" in str(exc), exc
            if opened is not None and opened not in (
                    "BMP", "DIB", "JPEG", "MPO", "PNG", "PPM", "TGA", "TIFF",
                    "ICO", "CUR", "GIF", "WEBP", "QOI", "PCX", "DCX", "SGI",
                    "PSD", "DDS"):
                assert opened in str(exc), (fmt, mode, exc)
            continue
        assert want is not None, (fmt, mode)
        np.testing.assert_array_equal(got, want, err_msg=f"{fmt} {mode}")


SAVE_TABLE = save_table()


def test_sniffing_follows_pillows_order():
    """A true-colour TGA starts with a cursor's signature (``00 00 02 00``):
    Pillow's CUR reader finds no entries and passes it on, as do the
    formats tried on any bytes before TGA, and it is read as TGA. A TGA header that PCX's test takes (an ID field of 10 bytes)
    is PCX's, an unknown PCX mode to Pillow, which raises, and the port
    raises so. A GIF and a WebP (tried after TGA, whose header checks a
    RIFF file fails) read as Pillow reads them, and so does an XPM (tried
    after TGA, which passes its header on); a JPEG 2000 codestream whose
    SIZ names no components is passed on by Pillow's ``_open`` and by the
    port, to no format; a format still not read (AVIF) raises naming it;
    bytes no format takes raise."""
    px = C.sample_image(6, 4, 2, 3)
    data = C.write_tga(px[..., ::-1], 2, 24)
    assert data[:4] == b"\0\0\2\0"
    assert list(sniff.pillow_candidates(data)) == ["CUR", *C.ANY_BYTES,
                                                  "TGA"]
    np.testing.assert_array_equal(C.assert_like_pillow(data)[..., :3], px)
    pcx = C.write_tga(px[..., ::-1], 2, 24, ident=b"0123456789")
    assert C.pillow_refuses(pcx)
    C.assert_refused(pcx, "p.tga", ValueError, "unknown PCX mode")
    gif = C.pillow_bytes(Image.fromarray(px), "GIF")
    assert list(sniff.pillow_candidates(gif)) == ["GIF", *C.ANY_BYTES,
                                                 "TGA"]
    C.assert_like_pillow(gif)
    webp = C.pillow_bytes(Image.fromarray(px), "WEBP")
    assert list(sniff.pillow_candidates(webp)) == [*C.ANY_BYTES, "TGA",
                                                  "WEBP"]
    C.assert_like_pillow(webp)
    xpm = (b'/* XPM */\nstatic char *x[] = {\n"2 1 2 1",\n'
           b'"a c #ff0000",\n"b c #00ff00",\n"ab"\n};\n')
    assert list(sniff.pillow_candidates(xpm)) == [*C.ANY_BYTES, "TGA",
                                                 "XPM"]
    C.assert_like_pillow(xpm)
    jp2 = b"\xff\x4f\xff\x51" + bytes(40)
    assert C.pillow_refuses(jp2)
    C.assert_refused(jp2, "x.jp2", ValueError,
                     "not an image Pillow can identify")
    avif = b"\0\0\0\x1cftypavif" + bytes(40)
    C.assert_refused(avif, "x.avif", ValueError,
                     "Pillow would open this file as AVIF")
    assert C.pillow_refuses(b"\xff" * 40)
    C.assert_refused(b"\xff" * 40, "n.bin", ValueError,
                     "not an image Pillow can identify")


@pytest.mark.parametrize("name", ["albedo_rle_rgba.tga", "roughness_rle8.bmp",
                                  "rgb_lzw.tif", "rgba_packbits.tif"])
def test_a_failed_native_build_raises(monkeypatch, name):
    """Where ``g++`` is on ``PATH`` the TGA RLE, BMP RLE, LZW and PackBits
    loops run in C++; a library that fails to build raises, and the decode
    does not fall back to Python."""
    data = fixture(name)

    def fail(cxx=None):
        raise RuntimeError("g++ failed to build the native library")

    monkeypatch.setattr(native._Lib, "handle", None)
    monkeypatch.setattr(native, "build", fail)
    monkeypatch.setattr(native, "native_available", lambda: True)
    with pytest.raises(RuntimeError, match="failed to build"):
        IMAGE.decode_image_rgba(data, name)


@pytest.mark.parametrize("name", ["env_rle32.tga", "a1r5g5b5_rle_topleft.tga",
                                  "palette_rle.tga"])
def test_tga_env_map_equals_jax(name, tmp_path):
    """``load_env_image`` and ``read_png`` of a TGA map (named .png: the
    bytes decide) equal the JAX package's, which reads it with Pillow."""
    path = str(tmp_path / "sky.png")
    with open(path, "wb") as f:
        f.write(fixture(name))
    np.testing.assert_array_equal(IMAGE.read_png(path), JIMAGE.read_png(path))
    np.testing.assert_array_equal(ENV.load_env_image(path),
                                  JENV.load_env_image(path))
