"""The port's ICNS reader (``utils/icns.py``) against Pillow 12.1.0, which
the JAX package reads LDR images with.

Every case is held array-equal to ``Image.open(...).convert("RGBA")`` and
decoded twice: with the C++ channel loop (``accel/cbvh/image_scan.cpp``'s
``wpt_icns_rle``) and with its plain Python version. Pillow writes ICNS
files of PNG entries at every size; ``tests/torch_image_cases.py`` writes
the rest: raw and run-length RGB entries, masks, the ``it32`` signature,
PNG entries of other sizes and with ``tRNS``, and broken directories.
"""

import io
import zlib

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from wgpu_path_tracing_tpu.models import gltf as JG
from wgpu_path_tracing_tpu.ops import env as JENV
from wgpu_path_tracing_tpu.utils import image as JIMAGE
from wgpu_path_tracing_tpu_torch.accel import native
from wgpu_path_tracing_tpu_torch.ops import env as ENV
from wgpu_path_tracing_tpu_torch.utils import icns, sniff
from wgpu_path_tracing_tpu_torch.utils import image as IMAGE
from tests import torch_image_cases as C

torch.set_num_threads(1)

FIXTURES = np.load(f"{C.LDR_DIR}/pillow_rgba.npz")
FILES = sorted(n for n in FIXTURES.files if n.endswith(".icns"))


def fixture(name: str) -> bytes:
    with open(f"{C.LDR_DIR}/{name}", "rb") as f:
        return f.read()


def png(img, **kw) -> bytes:
    return C.pillow_bytes(img, "PNG", **kw)


@pytest.mark.parametrize("name", FILES)
def test_committed_icns_files_equal_pillow(name):
    np.testing.assert_array_equal(C.assert_like_pillow(fixture(name), name),
                                  FIXTURES[name])


def test_pillow_written_icns_equals_pillow():
    """Pillow's writer: PNG entries at every size, the 1024x1024 ``ic10``
    (512 at scale 2) the one read. Its rows are alike, so the PNG's rows
    after the first are "Up" filtered (NumPy unfilters a Paeth row a
    pixel at a time: 20 s at this size)."""
    img = np.repeat(C.sample_image(40, 1, 1), 40, 0)
    C.assert_like_pillow(C.pillow_bytes(img, "ICNS"))


RGB16 = C.sample_image(16, 16, 2, 3)
MASK16 = C.sample_image(16, 16, 3, 1)[..., 0]
RGB128 = C.sample_image(128, 128, 4, 3)
RGB128[:, 40:] = RGB128[:, 40:41]  # long runs


def short_block(entries: bytes) -> bytes:
    """A block of size 4 first: the next header is read 4 bytes on, over
    the size field, as a block of type 0x00000004 and size 8."""
    body = b"icnV\0\0\0\4\0\0\0\x08" + entries
    return b"icns" + (len(body) + 8).to_bytes(4, "big") + body


VARIANTS = {
    "is32_rle": lambda: C.write_icns([(b"is32", C.icns_rgb(RGB16))]),
    "is32_raw_with_mask": lambda: C.write_icns([
        (b"is32", C.icns_rgb(RGB16, rle=False)),
        (b"s8mk", MASK16.tobytes())]),
    "mask_before_rgb": lambda: C.write_icns([
        (b"s8mk", MASK16.tobytes()), (b"is32", C.icns_rgb(RGB16))]),
    "it32_long_runs": lambda: C.write_icns([
        (b"it32", C.icns_rgb(RGB128, it32=True))]),
    "it32_raw": lambda: C.write_icns([
        (b"it32", C.icns_rgb(RGB128, rle=False, it32=True)),
        (b"t8mk", RGB128[..., 1].tobytes())]),
    "il32_and_smaller_entries": lambda: C.write_icns([
        (b"is32", C.icns_rgb(RGB16)),
        (b"il32", C.icns_rgb(C.sample_image(32, 32, 5, 3))),
        (b"l8mk", C.sample_image(32, 32, 6, 1).tobytes())]),
    "ih32_beats_il32": lambda: C.write_icns([
        (b"il32", C.icns_rgb(C.sample_image(32, 32, 5, 3))),
        (b"ih32", C.icns_rgb(C.sample_image(48, 48, 7, 3)))]),
    "rle_reads_past_its_entry": lambda: C.write_icns([
        (b"is32", C.icns_rgb(RGB16)[:200])], filesize=216)
        + C.icns_rgb(RGB16)[200:],
    "later_entry_of_a_type_wins": lambda: C.write_icns([
        (b"is32", C.icns_rgb(RGB16[::-1])), (b"is32", C.icns_rgb(RGB16))]),
    "unknown_types_ignored": lambda: C.write_icns([
        (b"TOC ", bytes(8)), (b"icnV", bytes(4)),
        (b"is32", C.icns_rgb(RGB16))]),
    "png_entry_wins_over_rgb": lambda: C.write_icns([
        (b"is32", C.icns_rgb(RGB16)),
        (b"icp4", png(C.sample_image(16, 16, 8)))]),
    "png_gray_trns_ignored": lambda: C.write_icns([
        (b"icp4", png(MASK16, transparency=int(MASK16[0, 0])))]),
    "png_16_bit": lambda: C.write_icns([
        (b"icp4", png(Image.fromarray(MASK16.astype(np.uint16) * 300)))]),
    "png_quarter_size_ic09": lambda: C.write_icns([
        (b"ic09", png(C.sample_image(128, 128, 9)))]),
    "png_for_another_present_size": lambda: C.write_icns([
        (b"ic08", png(C.sample_image(16, 16, 10))),
        (b"is32", C.icns_rgb(RGB16))]),
    "ic09_beats_ic14_at_scale_2": lambda: C.write_icns([
        (b"ic14", png(C.sample_image(8, 8, 11))),
        (b"ic09", png(C.sample_image(16, 16, 12)))]),
    "ic10_at_scale_2": lambda: C.write_icns([
        (b"ic10", png(C.sample_image(64, 64, 13)))]),
    "block_size_below_8": lambda: short_block(C.write_icns([
        (b"is32", C.icns_rgb(RGB16))])[8:]),
    "file_size_stops_the_directory": lambda: C.write_icns([
        (b"is32", C.icns_rgb(RGB16)), (b"is32", bytes(3))], filesize=8 + 8
        + len(C.icns_rgb(RGB16))),
}


@pytest.mark.parametrize("case", sorted(VARIANTS))
def test_written_variants_equal_pillow(case):
    """Raw and run-length RGB entries with and without masks, the largest
    present size chosen as (w, h, scale) tuples, a channel read on past
    its entry, the last entry of a type, PNG entries (their ``tRNS`` not
    applied, a size that is a whole fraction of a present one), a block
    size below 8 and a file size that ends the directory early."""
    C.assert_like_pillow(VARIANTS[case]())


def j2k(kind: str) -> bytes:
    """A 16 x 16 JPEG 2000 entry written by Pillow: a J2K codestream or a
    JP2 file, in RGB, RGBA or L, or 24 x 16 (no allowed size)."""
    size = (24, 16) if kind == "wrong_size" else (16, 16)
    img = Image.fromarray(C.sample_image(*size, 14, 4))
    mode = {"rgba_jp2": "RGBA", "gray_j2k": "L"}.get(kind, "RGB")
    return C.pillow_bytes(img.convert(mode), "JPEG2000",
                          no_jp2=kind.endswith("j2k"),
                          irreversible=kind == "rgb_j2k_irreversible")


@pytest.mark.parametrize("kind", ["rgb_j2k", "rgb_jp2", "rgba_jp2",
                                  "gray_j2k", "rgb_j2k_irreversible"])
def test_jpeg2000_entry_equals_pillow(kind):
    """A JPEG 2000 entry (J2K or JP2) reads as Pillow reads it through
    OpenJPEG: opened on its own bytes, converted to RGBA."""
    C.assert_like_pillow(C.write_icns([(b"icp4", j2k(kind))]), "j.icns")


@pytest.mark.parametrize("case", ["wrong_size", "cut", "bad_signature"])
def test_jpeg2000_entry_refused_as_pillow(case):
    """Pillow refuses a JPEG 2000 entry of no allowed size, one cut short
    (OpenJPEG's broken stream) and one whose header is not JPEG 2000 (a
    ``SyntaxError`` outside ``Image.open``); so does the port."""
    entry = {"wrong_size": lambda: j2k("wrong_size"),
             "cut": lambda: j2k("rgb_jp2")[:300],
             "bad_signature": lambda: b"\x0d\x0a\x87\x0a" + bytes(40)}[case]()
    data = C.write_icns([(b"icp4", entry)])
    assert C.pillow_refuses(data)
    C.assert_refused(data, "j.icns", exc=ValueError)


REFUSED = {
    "rle_channel_overshoots": C.write_icns([(b"is32", b"\xff\x07" * 3)]),
    "rle_channel_ends_early": C.write_icns([(b"is32", b"\x7f" + bytes(
        40))]),
    "rle_literal_cut_by_the_end": C.write_icns([(b"is32", b"\xff\x01"
                                                 + b"\x7f" + bytes(90))]),
    "rle_run_value_missing": C.write_icns([(b"is32", b"\x7f" + bytes(128)
                                            + b"\xfd")]),
    "raw_rgb_cut_short": C.write_icns([(b"is32", bytes(768))])[:500],
    "it32_bad_signature": C.write_icns([(b"it32", b"\0\0\0\1"
                                         + C.icns_rgb(RGB128))]),
    "mask_alone": C.write_icns([(b"s8mk", MASK16.tobytes())]),
    "mask_cut_short": C.write_icns([(b"is32", C.icns_rgb(RGB16)),
                                    (b"s8mk", bytes(100))]),
    "png_of_no_allowed_size": C.write_icns([
        (b"icp4", png(C.sample_image(12, 12, 15)))]),
    "png_wider_than_its_slot": C.write_icns([
        (b"icp4", png(C.sample_image(32, 16, 16)))]),
    "unknown_entry_format": C.write_icns([(b"icp4", b"GIF89a" + bytes(40))]),
    "png_entry_broken": C.write_icns([(b"icp4", png(C.sample_image(
        16, 16, 17))[:60])]),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_what_pillow_refuses_raises_naming_the_image(case):
    data = REFUSED[case]
    assert C.pillow_refuses(data)
    C.assert_refused(data, "r.icns", exc=ValueError)


PASSED_ON = {
    "no_known_entry": C.write_icns([(b"TOC ", bytes(8))]),
    "block_size_0": b"icns\0\0\0\x20" + b"is32\0\0\0\0" + bytes(16),
    "file_size_past_the_data": C.write_icns([(b"is32", C.icns_rgb(RGB16))],
                                            filesize=5000),
    "header_cut_short": b"icns\0\0",
    "nothing_after_the_header": b"icns\0\0\0\x08",
}


@pytest.mark.parametrize("case", sorted(PASSED_ON))
def test_directories_pillow_passes_on_are_passed_on(case):
    data = PASSED_ON[case]
    with pytest.raises(Exception, match="cannot identify"):
        C.pillow_rgba(data)
    C.assert_refused(data, "p.icns", exc=ValueError,
                     match="not an image Pillow can identify")


def rle_streams():
    """Channel streams of every packet kind, some cut short, some whose
    counts overshoot."""
    rng = np.random.default_rng(3)
    out = []
    for _ in range(300):
        s = bytearray()
        for _ in range(int(rng.integers(1, 12))):
            b = int(rng.integers(0, 256))
            s.append(b)
            s += rng.integers(0, 256, 1 if b & 0x80 else b + 1,
                              dtype=np.uint8).tobytes()
        cut = int(rng.integers(1, len(s) + 1))
        out.append((b"ab" + bytes(s[:cut]), 2, int(rng.integers(1, 400))))
    # Counts that end on the size with the data cut short.
    return out + [(b"\x03\x01\x02", 0, 4), (b"\x81", 0, 4),
                  (b"\x00\x09\x81", 0, 5)]


def test_channel_loop_in_cxx_equals_python():
    """``wpt_icns_rle`` and ``icns.rle_plain`` give the same bytes, end
    and status on every stream."""
    statuses = set()
    for data, pos, size in rle_streams():
        got = native.icns_rle_native(data, pos, size)
        want = icns.rle_plain(data, pos, size)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]
        statuses.add(got[2])
    assert statuses == {0, 1, 2}


@settings(max_examples=30, deadline=None)
@given(size=st.sampled_from([b"is32", b"il32", b"ih32", b"it32"]),
       rle=st.booleans(), mask=st.booleans(), seed=st.integers(0, 2 ** 16))
def test_hypothesis_icns(size, rle, mask, seed):
    n = {b"is32": 16, b"il32": 32, b"ih32": 48, b"it32": 128}[size]
    img = C.sample_image(n, n, seed)
    if seed % 3 == 0:
        img[:, n // 3:] = img[:, :1]
    entries = [(size, C.icns_rgb(img[..., :3], rle=rle, it32=size == b"it32"))]
    if mask:
        kind = {b"is32": b"s8mk", b"il32": b"l8mk", b"ih32": b"h8mk",
                b"it32": b"t8mk"}[size]
        entries.append((kind, img[..., 3].tobytes()))
    C.assert_like_pillow(C.write_icns(entries))


def test_icns_is_tried_by_its_signature():
    assert list(sniff.pillow_candidates(fixture("is32_raw_s8mk.icns"))) == [
        "ICNS", *C.ANY_BYTES, "TGA"]


def test_a_failed_native_build_raises(monkeypatch):
    def fail(cxx=None):
        raise RuntimeError("g++ failed to build the native library")

    monkeypatch.setattr(native._Lib, "handle", None)
    monkeypatch.setattr(native, "build", fail)
    monkeypatch.setattr(native, "native_available", lambda: True)
    with pytest.raises(RuntimeError, match="failed to build"):
        IMAGE.decode_image_rgba(fixture("it32_rle_t8mk.icns"), "a.icns")


@pytest.mark.parametrize("name", ["it32_rle_t8mk.icns",
                                  "png_trns_ignored.icns"])
def test_jax_decode_image_equals_port(name):
    data = fixture(name)
    np.testing.assert_array_equal(IMAGE.decode_image_rgba(data, name),
                                  JG._decode_image(data))


@pytest.mark.parametrize("name", ["it32_rle_t8mk.icns",
                                  "png_half_size_ic08.icns"])
@pytest.mark.parametrize("in_cxx", [True, False])
def test_icns_env_map_equals_jax(name, in_cxx, tmp_path, monkeypatch):
    if not in_cxx:
        monkeypatch.setattr(native, "native_available", lambda: False)
    path = str(tmp_path / "sky.png")
    with open(path, "wb") as f:
        f.write(fixture(name))
    np.testing.assert_array_equal(IMAGE.read_png(path), JIMAGE.read_png(path))
    np.testing.assert_array_equal(ENV.load_env_image(path),
                                  JENV.load_env_image(path))


def idat_edit(png: bytes, how: str) -> bytes:
    """A PNG with its IDAT's CRC broken, or its zlib stream's last bytes
    (the Adler-32 checksum) cut and the chunk's length and CRC fixed."""
    at = png.index(b"IDAT")
    length = int.from_bytes(png[at - 4:at], "big")
    body = png[at + 4:at + 4 + length]
    if how == "bad_crc":
        crc = bytes(b ^ 0xFF for b in png[at + 4 + length:at + 8 + length])
    else:
        body = body[:-4]
        crc = zlib.crc32(b"IDAT" + body).to_bytes(4, "big")
    return (png[:at - 4] + len(body).to_bytes(4, "big") + b"IDAT" + body + crc
            + png[at + 8 + length:])


@pytest.mark.parametrize("how", ["bad_crc", "no_adler32"])
@pytest.mark.parametrize("inside", [False, True])
def test_png_idat_crc_and_stream_end_are_not_read(how, inside):
    """Pillow checks no IDAT's CRC and stops inflating at the last row, so
    a broken IDAT CRC or a stream cut after the last row reads, alone and
    as an ICNS entry (what the fuzzer found through ICNS)."""
    data = idat_edit(png(C.sample_image(16, 16, 18)), how)
    if inside:
        data = C.write_icns([(b"icp4", data)])
    C.assert_like_pillow(data)


def without_iend(png_bytes: bytes) -> bytes:
    return png_bytes[:png_bytes.rindex(b"IEND") - 4]


TRAILERS = {
    "truncated_unknown_chunk": (lambda p: without_iend(p) + b"\0\0\1\0abCd"
                                + bytes(20), True),
    "truncated_text_chunk": (lambda p: without_iend(p) + b"\0\0\0\x40tEXt"
                             + b"k\0v", True),
    "whole_chunk_then_iend": (lambda p: without_iend(p) + b"\0\0\0\2abCd"
                              + b"xy" + bytes(4) + p[-12:], False),
    "no_chunk_type_ends_the_walk": (lambda p: without_iend(p)
                                    + b"\0\0\1\0a-Cd" + bytes(20), False),
    "header_cut_short": (lambda p: without_iend(p) + b"\0\0\1", False),
    "truncated_chunk_after_iend": (lambda p: p + b"\0\0\1\0abCd", False),
}


@pytest.mark.parametrize("case", sorted(TRAILERS))
@pytest.mark.parametrize("inside", [False, True])
def test_png_chunks_after_the_image_are_read_as_pillow_reads_them(case,
                                                                  inside):
    """Pillow's ``load_end`` walks the chunks after the image data up to
    IEND: one whose data runs past the end raises, a header cut short or
    a type that is not four word characters ends the walk (what the
    fuzzer found through an ICNS entry cut short)."""
    edit, refused = TRAILERS[case]
    data = edit(png(C.sample_image(16, 16, 19)))
    if inside:
        data = C.write_icns([(b"icp4", data)], filesize=8 + 8 + len(data))
    assert C.pillow_refuses(data) == refused
    if refused:
        C.assert_refused(data, "t.png", exc=ValueError)
    else:
        C.assert_like_pillow(data)


def test_png_entry_trns_is_dropped():
    """What ``png_trns_ignored.icns`` shows: the PNG alone has
    transparent pixels, inside the ICNS every alpha is 255."""
    data = fixture("png_trns_ignored.icns")
    start = data.index(b"\x89PNG")
    alone = Image.open(io.BytesIO(data[start:])).convert("RGBA")
    assert np.asarray(alone)[..., 3].min() == 0
    assert (C.assert_like_pillow(data)[..., 3] == 255).all()
