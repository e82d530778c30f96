"""The port's Sun raster (``utils/sun.py``) and MSP (``utils/msp.py``)
readers against Pillow 12.1.0, which the JAX package reads LDR images
with.

Every case is held array-equal to ``Image.open(...).convert("RGBA")`` and
decoded twice: with the C++ run-length loops (``accel/cbvh/
image_scan.cpp``'s ``wpt_sun_rle`` and ``wpt_msp_rle``) and with their
plain Python versions. Pillow writes MSP version 1 (``DanM``) files and
no Sun raster; ``tests/torch_image_cases.py`` writes every Sun depth, raw
and run-length coded, with colour maps, and MSP version 2 (``LinS``)
rows, including rows that decode long or short.
"""

import struct

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
from wgpu_path_tracing_tpu_torch.utils import msp, sniff, sun
from wgpu_path_tracing_tpu_torch.utils import image as IMAGE
from tests import torch_image_cases as C

torch.set_num_threads(1)

FIXTURES = np.load(f"{C.LDR_DIR}/pillow_rgba.npz")
FILES = sorted(n for n in FIXTURES.files if n.endswith((".ras", ".msp")))


def fixture(name: str) -> bytes:
    with open(f"{C.LDR_DIR}/{name}", "rb") as f:
        return f.read()


@pytest.mark.parametrize("name", FILES)
def test_committed_sun_msp_files_equal_pillow(name):
    np.testing.assert_array_equal(C.assert_like_pillow(fixture(name), name),
                                  FIXTURES[name])


def sun_pixels(depth: int, w: int, h: int, seed: int) -> np.ndarray:
    if depth == 1:
        return C.sample_image(w, h, seed, 1)[..., 0] > 120
    if depth == 4:
        return C.sample_image(w, h, seed, 1)[..., 0] >> 4
    if depth == 8:
        return C.sample_image(w, h, seed, 1)[..., 0]
    return C.sample_image(w, h, seed, depth // 8)


@pytest.mark.parametrize("depth", [1, 4, 8, 24, 32])
@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4, 5])
@pytest.mark.parametrize("w", [1, 7, 16])
def test_every_depth_and_type_equals_pillow(depth, ftype, w):
    """Each depth in each file type, raw rows padded to 16 bits, run-length
    rows (type 2) unpadded as Pillow's decoder reads them."""
    px = sun_pixels(depth, w, 5, depth + ftype + w)
    rows = C.sun_rows(px, depth, pad=ftype != 2)
    payload = C.sun_rle(rows) if ftype == 2 else rows.tobytes()
    C.assert_like_pillow(C.write_sun(w, 5, depth, payload, ftype=ftype))


@pytest.mark.parametrize("depth", [4, 8])
@pytest.mark.parametrize("length", [0, 3, 4, 30, 767, 768, 770])
def test_colour_maps_equal_pillow(depth, length):
    """Planar maps of ``length // 3`` entries, indices past them black; a
    map of 0 bytes leaves the image gray."""
    pal = C.sample_image(256, 3, 7)[..., 0].tobytes()[:length]
    px = sun_pixels(depth, 11, 6, length)
    C.assert_like_pillow(C.write_sun(
        11, 6, depth, C.sun_rows(px, depth).tobytes(), palette=pal,
        ptype=1))


SUN_VARIANTS = {
    "rle_escape_0x80": lambda: C.write_sun(3, 2, 8, bytes(
        [0x80, 0, 1, 2, 0x80, 0, 0x80, 0, 9]), ftype=2),
    "rle_run_across_rows": lambda: C.write_sun(3, 3, 8, bytes(
        [0x80, 4, 7, 1, 2, 3, 4]), ftype=2),
    "rle_run_past_the_end": lambda: C.write_sun(3, 2, 8, bytes(
        [1, 0x80, 200, 9]), ftype=2),
    "rle_trailing_bytes": lambda: C.write_sun(2, 1, 8, bytes(
        [1, 2, 0x80]), ftype=2),
    "rle_24_bit_odd_width_padded_rows": lambda: C.write_sun(
        5, 4, 24, C.sun_rle(C.sun_rows(C.sample_image(5, 4, 8, 3), 24)),
        ftype=2),
    "raw_last_row_unpadded": lambda: C.write_sun(1, 2, 8, bytes([5, 0, 6])),
    "raw_extra_bytes": lambda: C.write_sun(2, 2, 8, bytes(range(10))),
    "palette_type_2_of_length_0": lambda: C.write_sun(
        2, 1, 8, bytes([5, 6]), ptype=2),
    "length_field_ignored": lambda: C.write_sun(2, 1, 8, bytes([5, 6]))[:16]
    + b"\0\0\0\0" + C.write_sun(2, 1, 8, bytes([5, 6]))[20:],
}


@pytest.mark.parametrize("case", sorted(SUN_VARIANTS))
def test_sun_variants_equal_pillow(case):
    C.assert_like_pillow(SUN_VARIANTS[case]())


def test_padded_rle_rows_come_out_sheared():
    """What ``bgr24_rle_padded_sheared.ras`` shows: Pillow's RLE decoder
    has no stride, so padded rows shift."""
    data = fixture("bgr24_rle_padded_sheared.ras")
    odd = C.sample_image(13, 9, 60, 3)
    got = C.assert_like_pillow(data)
    np.testing.assert_array_equal(got[0, :, :3], odd[0])
    assert not np.array_equal(got[1, :, :3], odd[1])


def msp_bits(w: int, h: int, seed: int) -> np.ndarray:
    return (C.sample_image(w, h, seed, 1)[..., 0] > 110).astype(np.uint8)


@pytest.mark.parametrize("size", [(1, 1), (8, 3), (33, 17), (70, 5)])
def test_pillow_written_msp_equals_pillow(size):
    bits = msp_bits(*size, seed=sum(size))
    C.assert_like_pillow(C.pillow_bytes(Image.fromarray(bits * 255).convert(
        "1"), "MSP"))


def lins(bits, edit=None) -> bytes:
    rows = [C.msp_lins_row(r.tobytes()) for r in np.packbits(bits, axis=1)]
    if edit:
        edit(rows)
    return C.write_msp_lins(bits, rows)


BITS = msp_bits(20, 6, 1)
MSP_VARIANTS = {
    "encoded": lambda: lins(BITS),
    "blank_rows": lambda: lins(BITS, lambda r: r.__setitem__(
        slice(1, 3), [b"", b""])),
    "long_row_shifts_the_rest": lambda: lins(BITS, lambda r: r.__setitem__(
        2, r[2] + b"\x01\x0f")),
    "short_row_shifts_the_rest": lambda: lins(BITS, lambda r: (
        r.__setitem__(2, b"\x01\xaa"), r.__setitem__(5, r[5] + b"\x02\x12"
                                                       b"\x34"))),
    "literal_count_past_the_row": lambda: lins(BITS, lambda r: r.__setitem__(
        5, b"\x09\x12\x34\x56")),
    "run_of_0": lambda: lins(BITS, lambda r: r.__setitem__(
        0, b"\x00\x00\x11" + r[0])),
    "extra_rows_of_data": lambda: lins(BITS, lambda r: r.__setitem__(
        5, r[5] + b"\x00\xff\x00")),
    "all_rows_blank": lambda: C.write_msp_lins(BITS, [b""] * 6),
}


@pytest.mark.parametrize("case", sorted(MSP_VARIANTS))
def test_msp_variants_equal_pillow(case):
    """Version-2 rows: blank rows white, rows that decode long or short
    shifting the rows after them (Pillow checks no row's length), a literal
    count past its row's end copying what the row holds."""
    C.assert_like_pillow(MSP_VARIANTS[case]())


REFUSED = {
    "sun_raw_cut_short": C.write_sun(4, 4, 8, bytes(13)),
    "sun_rle_cut_short": C.write_sun(4, 4, 8, bytes(15), ftype=2),
    "sun_rle_run_cut_short": C.write_sun(4, 1, 8, bytes([1, 0x80, 3]),
                                         ftype=2),
    "sun_map_on_24_bits": C.write_sun(2, 1, 24, bytes(8), palette=bytes(6),
                                      ptype=1),
    "sun_map_on_1_bit": C.write_sun(2, 1, 1, bytes(2), palette=bytes(6),
                                    ptype=1),
    "sun_map_of_257_entries": C.write_sun(2, 1, 8, bytes(2),
                                          palette=bytes(771), ptype=1),
    "sun_map_cut_short": C.write_sun(2, 1, 8, b"", palette=bytes(30),
                                     ptype=1)[:40],
    "msp_danm_cut_short": C.pillow_bytes(Image.fromarray(
        BITS * 255).convert("1"), "MSP")[:40],
    "msp_row_map_cut_short": lins(BITS)[:40],
    "msp_row_cut_short": lins(BITS)[:-3],
    "msp_run_cut_short": lins(BITS, lambda r: r.__setitem__(4, b"\x00\x05")),
    "msp_rows_too_short": lins(BITS, lambda r: r.__setitem__(
        5, b"\x01\x00")),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_what_pillow_refuses_raises_naming_the_image(case):
    data = REFUSED[case]
    assert C.pillow_refuses(data)
    C.assert_refused(data, "r.ras", exc=ValueError)


PASSED_ON = {
    "sun_depth_16": C.write_sun(2, 1, 16, bytes(4)),
    "sun_type_6": C.write_sun(2, 1, 8, bytes(2), ftype=6),
    "sun_map_type_2": C.write_sun(2, 1, 8, bytes(2), palette=bytes(6),
                                  ptype=2),
    "sun_map_over_1024_bytes": C.write_sun(2, 1, 8, bytes(2),
                                           palette=bytes(1026), ptype=1),
    "sun_header_cut_short": C.write_sun(2, 1, 8, b"")[:31],
    "sun_no_pixels": C.write_sun(0, 3, 8, bytes(4)),
    "msp_bad_checksum": b"DanM" + bytes(28) + b"\x01",
    "msp_header_cut_short": C.msp_header(b"LinS", 4, 4)[:30],
    "msp_no_pixels": C.msp_header(b"DanM", 0, 4) + bytes(8),
}


@pytest.mark.parametrize("case", sorted(PASSED_ON))
def test_headers_pillow_passes_on_are_passed_on(case):
    data = PASSED_ON[case]
    with pytest.raises(Exception, match="cannot identify"):
        C.pillow_rgba(data)
    C.assert_refused(data, "p.ras", exc=ValueError,
                     match="not an image Pillow can identify")


def sun_streams():
    rng = np.random.default_rng(4)
    out = []
    for _ in range(300):
        s = bytearray()
        for _ in range(int(rng.integers(1, 30))):
            b = int(rng.choice([0x80, int(rng.integers(0, 256))]))
            s.append(b)
            if b == 0x80:
                s.append(int(rng.choice([0, int(rng.integers(0, 256))])))
                s.append(int(rng.integers(0, 256)))
        cut = int(rng.integers(1, len(s) + 1))
        out.append((b"hdr" + bytes(s[:cut]), 3, int(rng.integers(1, 300))))
    return out


def test_sun_rle_in_cxx_equals_python():
    statuses = set()
    for data, pos, size in sun_streams():
        got, status = native.sun_rle_native(data, pos, size)
        want, want_status = sun.rle_plain(data, pos, size)
        assert status == want_status
        np.testing.assert_array_equal(got, want)
        statuses.add(status)
    assert statuses == {0, 1}


def msp_cases():
    rng = np.random.default_rng(5)
    out = []
    for _ in range(300):
        h = int(rng.integers(1, 8))
        rows = []
        for _ in range(h):
            r = bytearray()
            for _ in range(int(rng.integers(0, 5))):
                t = int(rng.integers(0, 12))
                r.append(t)
                r += rng.integers(0, 256, 2 if t == 0 else t,
                                  dtype=np.uint8).tobytes()
            rows.append(bytes(r[:int(rng.integers(0, len(r) + 1))]))
        data = b"".join(rows)
        data = data[:int(rng.integers(0, len(data) + 1))] \
            if rng.random() < 0.3 else data
        rowmap = np.array([len(r) for r in rows], np.int64)
        out.append((b"x" + data, 1, rowmap, int(rng.integers(1, 4)),
                    int(rng.integers(1, 40))))
    return out


def test_msp_rows_in_cxx_equal_python():
    """``wpt_msp_rle`` and ``msp.rle_plain`` give the same first bytes,
    count and status on random rows (runs cut short, rows past the
    data)."""
    statuses = set()
    for case in msp_cases():
        got = native.msp_rle_native(*case)
        want = msp.rle_plain(*case)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[2] == want[2]
        if got[2] == 0:
            assert got[1] == want[1]
        statuses.add(got[2])
    assert statuses == {0, 1, 2}


@settings(max_examples=40, deadline=None)
@given(w=st.integers(1, 40), h=st.integers(1, 12),
       depth=st.sampled_from([1, 4, 8, 24, 32]), rle=st.booleans(),
       seed=st.integers(0, 2 ** 16))
def test_hypothesis_sun(w, h, depth, rle, seed):
    rows = C.sun_rows(sun_pixels(depth, w, h, seed), depth, pad=not rle)
    payload = C.sun_rle(rows) if rle else rows.tobytes()
    data = C.write_sun(w, h, depth, payload, ftype=2 if rle else 1)
    if C.pillow_refuses(data):
        # A width of 1 with a length field of 1 or 4 passes GIMP brush's
        # test, which comes first and then fails to load.
        assert "GBR" in list(sniff.pillow_candidates(data))
        C.assert_refused(data, "h.ras", exc=ValueError)
    else:
        C.assert_like_pillow(data)


@settings(max_examples=30, deadline=None)
@given(w=st.integers(1, 60), h=st.integers(1, 10),
       seed=st.integers(0, 2 ** 16))
def test_hypothesis_msp_lins(w, h, seed):
    C.assert_like_pillow(C.write_msp_lins(msp_bits(w, h, seed)))


def test_signatures_and_order():
    assert list(sniff.pillow_candidates(fixture("bgrx32.ras"))) == [
        *C.ANY_BYTES, "SUN", "TGA"]
    assert "MSP" in list(sniff.pillow_candidates(fixture("lins.msp")))


@pytest.mark.parametrize("name", ["env_rle.ras", "lins.msp"])
def test_a_failed_native_build_raises(monkeypatch, name):
    def fail(cxx=None):
        raise RuntimeError("g++ failed to build the native library")

    monkeypatch.setattr(native._Lib, "handle", None)
    monkeypatch.setattr(native, "build", fail)
    monkeypatch.setattr(native, "native_available", lambda: True)
    with pytest.raises(RuntimeError, match="failed to build"):
        IMAGE.decode_image_rgba(fixture(name), name)


@pytest.mark.parametrize("name", ["bgr24_rle.ras", "gray8_palette_rle.ras",
                                  "pillow_danm.msp", "lins.msp"])
def test_jax_decode_image_equals_port(name):
    data = fixture(name)
    np.testing.assert_array_equal(IMAGE.decode_image_rgba(data, name),
                                  JG._decode_image(data))


@pytest.mark.parametrize("name", ["env_rle.ras", "mono1_rle.ras",
                                  "lins_blank_and_shifted.msp"])
@pytest.mark.parametrize("in_cxx", [True, False])
def test_sun_msp_env_map_equals_jax(name, in_cxx, tmp_path, monkeypatch):
    if not in_cxx:
        monkeypatch.setattr(native, "native_available", lambda: False)
    path = str(tmp_path / "sky.png")
    with open(path, "wb") as f:
        f.write(fixture(name))
    np.testing.assert_array_equal(IMAGE.read_png(path), JIMAGE.read_png(path))
    np.testing.assert_array_equal(ENV.load_env_image(path),
                                  JENV.load_env_image(path))


def test_large_sun_equals_pillows_digest():
    """The 4096x2048 RLE Sun raster ``chip_smoke.py`` makes with the test
    suite's writer decodes, in C++, to its array, whose SHA-256 is the one
    Pillow gave (``pillow_sha256.json``)."""
    import hashlib
    import json

    with open(f"{C.LDR_DIR}/pillow_sha256.json") as f:
        want = json.load(f)[C.LARGE_SUN]
    data, img = C.large_sun()
    got = C.decode_in(True, data)
    np.testing.assert_array_equal(got[..., :3], img)
    assert hashlib.sha256(got.tobytes()).hexdigest() == want
    assert struct.unpack_from(">I", data, 20)[0] == 2
