"""JPEG scans whose data stops early, read as libjpeg-turbo 3.1 (Pillow
12.1.0's) reads them, in ``utils/jpeg.py`` and in its C++ twin
``accel/cbvh/jpeg_scan.cpp``.

libjpeg reads zero bits past a marker that cuts a scan short
(``jdhuff.c``'s ``insufficient_data``): the MCU that runs out is decoded
on zeros, the rest of its restart interval is left as earlier scans left
it (zero in a sequential file: uniform gray), and only an interval whose
RSTn was found starts afresh; an interval whose data is missing behind
the marker decodes from no data. The lossless decoder checks the flag a
MCU row at a time and resets its predictors where it skips; the
arithmetic decoder reads zero bytes past a marker. Block smoothing reads
the coefficient histories from before each component's last scan in the
iMCU rows past the last scan's last good one. A file with no marker at
all after its data is refused, by Pillow and the port.

Every case is held array-equal to Pillow through ``decode_image_rgba``,
decoded with the C++ entropy decoders and with the Python ones
(``tests/torch_image_cases.py::decode_in``), and a few against the JAX
package's own reader.
"""


import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from wgpu_path_tracing_tpu.models import gltf as JG
from wgpu_path_tracing_tpu.utils import image as JIMAGE
from wgpu_path_tracing_tpu_torch.accel import native
from wgpu_path_tracing_tpu_torch.utils import image as IMAGE
from wgpu_path_tracing_tpu_torch.utils import jpeg as JPEG
from tests import torch_image_cases as C
from tests import torch_jpeg_cases as JC

torch.set_num_threads(1)

EOI = b"\xff\xd9"


def scans(data: bytes) -> list:
    """(start of each scan's entropy-coded data, the marker after it)."""
    out, pos = [], 2
    while pos + 4 <= len(data) and data[pos] == 0xFF and data[pos + 1] not in (
            0xD8, 0xD9):
        length = int.from_bytes(data[pos + 2:pos + 4], "big")
        pos += 2 + length
        if data[pos - length - 1] != 0xDA:
            continue
        end = pos
        while not (data[end] == 0xFF and data[end + 1] not in (
                0, *range(0xD0, 0xD8))):
            end += 1
        out.append((pos, end))
        pos = end
    return out


def cut(data: bytes, scan: int = -1, frac: float = 0.5, rest: str = "eoi"
        ) -> bytes:
    """``data`` with scan ``scan``'s data cut at ``frac`` of its length,
    then EOI ("eoi"), the file from the marker after that scan ("after"),
    or nothing ("none")."""
    start, end = scans(data)[scan]
    at = start + int((end - start) * frac)
    head = data[:at].rstrip(b"\xff")
    return head + {"eoi": EOI, "after": data[end:], "none": b""}[rest]


def at_restart(data: bytes, k: int, rest: str = "eoi") -> bytes:
    """``data`` cut right before its ``k``-th restart marker."""
    start, end = scans(data)[-1]
    marks = [i for i in range(start, end - 1)
             if data[i] == 0xFF and 0xD0 <= data[i + 1] <= 0xD7]
    return data[:marks[k % len(marks)]] + (EOI if rest == "eoi"
                                           else data[end:])



def photo(w: int = 64, h: int = 64, seed: int = 0) -> np.ndarray:
    return np.stack(JC.sample_planes(w, h, seed=seed), -1)


def pillow_jpeg(img, **kw) -> bytes:
    return C.pillow_bytes(Image.fromarray(img), "JPEG", **kw)


def test_cut_64x64_files_read_as_pillow_reads_them():
    """A 64x64 baseline and progressive file Pillow wrote, the last scan's
    data cut in half and closed by EOI: libjpeg's gray past the cut."""
    img = photo()
    base = cut(pillow_jpeg(img, quality=90))
    got = C.assert_like_pillow(base)
    assert got[-1, -1].tolist() == [128, 128, 128, 255]
    C.assert_like_pillow(cut(pillow_jpeg(img, progressive=True)))


SOURCES = {
    "baseline": lambda: pillow_jpeg(photo(), quality=85),
    "baseline_420_optimize": lambda: pillow_jpeg(photo(40, 36, 1), quality=70,
                                                 optimize=True, subsampling=2),
    "gray": lambda: pillow_jpeg(photo(50, 30, 2)[..., 0], quality=80),
    "restart_2": lambda: pillow_jpeg(photo(48, 40, 3),
                                     restart_marker_blocks=2),
    "progressive": lambda: pillow_jpeg(photo(56, 40, 4), progressive=True),
    "progressive_restart": lambda: pillow_jpeg(
        photo(40, 40, 5), progressive=True, restart_marker_blocks=1),
    "one_scan_a_component": lambda: JC.write_jpeg(
        JC.sample_planes(30, 20, 3, 6), [(2, 1), (1, 1), (1, 1)],
        interleaved=False, restart=3),
    "arithmetic": lambda: JC.write_jpeg(JC.sample_planes(40, 24, 3, 7),
                                        [(2, 2), (1, 1), (1, 1)],
                                        arithmetic=True, restart=2),
    "arithmetic_progressive": lambda: JC.write_jpeg(
        JC.sample_planes(32, 24, 3, 8), [(1, 1)] * 3, arithmetic=True,
        scans=JC.script_for("simple", 3)),
    "lossless": lambda: JC.write_lossless_jpeg(JC.sample_planes(30, 20, 3, 9),
                                               predictor=4),
    "lossless_restart": lambda: JC.write_lossless_jpeg(
        JC.sample_planes(30, 20, 3, 10), [(2, 2), (1, 1), (1, 1)],
        predictor=1, restart_rows=1, interleaved=False),
}


@pytest.mark.parametrize("frac", [0.0, 0.1, 0.5, 0.93])
@pytest.mark.parametrize("kind", sorted(SOURCES))
def test_last_scan_cut_then_eoi_equals_pillow(kind, frac):
    C.assert_like_pillow(cut(SOURCES[kind](), -1, frac), f"{kind}.jpg")


@pytest.mark.parametrize("scan", [0, 1, 2, 4, 6])
@pytest.mark.parametrize("rest", ["eoi", "after"])
@pytest.mark.parametrize("kind", ["progressive", "arithmetic_progressive",
                                  "one_scan_a_component", "lossless_restart"])
def test_an_earlier_scan_cut_short_equals_pillow(kind, scan, rest):
    """A scan cut inside, then EOI or the rest of the file from the marker
    after it: the later scans are read, and a progressive refinement cut
    short keeps what the earlier scans gave."""
    data = SOURCES[kind]()
    n = len(scans(data))
    C.assert_as_pillow(cut(data, scan % n, 0.4, rest), f"{kind}.jpg")


@pytest.mark.parametrize("k", [0, 1, 3])
@pytest.mark.parametrize("rest", ["eoi", "after"])
@pytest.mark.parametrize("kind", ["restart_2", "progressive_restart",
                                  "arithmetic", "lossless_restart"])
def test_whole_restart_intervals_missing_equal_pillow(kind, k, rest):
    """The data stops right before a restart marker: every later interval
    is missing (``len(segments) < need``); the first of them reads zero
    bits where the interval before ended whole."""
    C.assert_as_pillow(at_restart(SOURCES[kind](), k, rest), f"{kind}.jpg")


@pytest.mark.parametrize("script", sorted(JC.SCRIPTS))
@pytest.mark.parametrize("frac", [0.3, 0.8])
def test_block_smoothing_past_the_cut_equals_pillow(script, frac):
    """Scripts that stop early are block-smoothed; past a last scan cut
    short libjpeg smooths with the histories from before each
    component's last scan."""
    data = JC.write_jpeg(JC.sample_planes(48, 40, 3, 11),
                         [(2, 2), (1, 1), (1, 1)],
                         scans=JC.script_for(script, 3))
    C.assert_like_pillow(cut(data, -1, frac), f"{script}.jpg")


@pytest.mark.parametrize("kind", ["baseline", "progressive", "arithmetic",
                                  "lossless"])
def test_data_with_no_marker_after_it_is_refused(kind):
    """A file that ends inside its scan data, with no marker after it:
    Pillow asks for more and finds the file truncated; the port raises."""
    data = cut(SOURCES[kind](), -1, 0.5, "none")
    assert C.pillow_refuses(data)
    C.assert_refused(data, "c.jpg", ValueError, "truncated JPEG data")


@pytest.mark.parametrize("sampling", [[(1, 1)] * 3,
                                      [(2, 2), (1, 1), (1, 1)]])
def test_a_lossless_component_with_no_scan_is_refused(sampling):
    """libjpeg-turbo refuses a lossless frame that ends before every
    component had a scan (the DCT frames read such a component as 128)."""
    data = JC.write_lossless_jpeg(JC.sample_planes(20, 12, 3, 12), sampling,
                                  interleaved=False)
    start = scans(data)[1][0]
    sos = data.rfind(b"\xff\xda", 0, start)
    short = data[:data.rfind(b"\xff\xc4", 0, sos) if data.rfind(
        b"\xff\xc4", scans(data)[0][1], sos) > 0 else sos] + EOI
    assert C.pillow_refuses(short)
    C.assert_refused(short, "l.jpg", ValueError, "a lossless JPEG ends")


def test_cut_blp1_jpeg_equals_pillow():
    """A BLP1 whose JPEG mipmap stops at the file's end (Pillow closes it)
    and one cut at a marker inside."""
    img = photo(40, 24, 13)
    jpeg = pillow_jpeg(img, quality=90)
    C.assert_like_pillow(C.blp1_jpeg(cut(jpeg, -1, 0.5), 40, 24, split=300))


@pytest.mark.parametrize("frac", [0.2, 0.5, 0.7, 0.85, 0.97])
def test_cut_jpeg_in_tiff_equals_pillow(frac):
    """A JPEG-in-TIFF strip whose byte count stops early: libtiff hands
    libjpeg a fake EOI there. Inside the scan data it reads as a cut JPEG;
    inside the headers libjpeg refuses it, and so does the port."""
    rgb = C.sample_image(31, 17, 14, 3)
    data = bytearray(C.write_tiff(rgb, 8, 2, compression=7,
                                  jpeg={"tables": False}))
    at = bytes(data).index(bytes([0x17, 0x01, 4, 0, 1, 0, 0, 0]))
    count = int.from_bytes(data[at + 8:at + 12], "little")
    data[at + 8:at + 12] = int(count * frac).to_bytes(4, "little")
    C.assert_as_pillow(bytes(data), "cut.tif")
    if frac > 0.8:
        assert not C.pillow_refuses(bytes(data))


@pytest.mark.parametrize("kind", ["baseline", "progressive", "lossless"])
def test_cut_files_equal_the_jax_reader(kind, tmp_path):
    data = cut(SOURCES[kind](), -1, 0.6)
    np.testing.assert_array_equal(IMAGE.decode_image_rgba(data, "a.jpg"),
                                  JG._decode_image(data))
    path = str(tmp_path / "sky.png")
    with open(path, "wb") as f:
        f.write(data)
    np.testing.assert_array_equal(IMAGE.read_png(path), JIMAGE.read_png(path))


@pytest.mark.parametrize("kind", ["baseline", "progressive_restart",
                                  "lossless_restart"])
def test_entropy_decoders_agree_on_what_they_return(kind, monkeypatch):
    """The Python and C++ scan decoders return the same last good MCU (or
    the same skipped MCU rows) on every scan of a cut file."""
    data = cut(SOURCES[kind](), -1, 0.45)
    seen = {True: [], False: []}
    real = JPEG.decode_scan, JPEG.decode_progressive_scan, \
        JPEG.decode_lossless_scan
    real_native = native.jpeg_scan_native
    for in_cxx in (True, False):
        def record(fn, key=in_cxx):
            def wrapped(*a, **k):
                out = fn(*a, **k)
                seen[key].append(bytes(out) if isinstance(out, bytearray)
                                 else out)
                return out
            return wrapped
        with monkeypatch.context() as m:
            m.setattr(JPEG, "decode_scan", record(real[0]))
            m.setattr(JPEG, "decode_progressive_scan", record(real[1]))
            m.setattr(JPEG, "decode_lossless_scan", record(real[2]))
            m.setattr(native, "jpeg_scan_native", record(real_native))
            C.decode_in(in_cxx, data)
    assert seen[True] == seen[False] and seen[True]


@settings(max_examples=25, deadline=None)
@given(kind=st.sampled_from(sorted(SOURCES)), scan=st.integers(0, 9),
       frac=st.floats(0, 1), rest=st.sampled_from(["eoi", "after"]))
def test_hypothesis_cuts_equal_pillow(kind, scan, frac, rest):
    data = SOURCES[kind]()
    C.assert_as_pillow(cut(data, scan % len(scans(data)), frac, rest))


@pytest.mark.parametrize("at", [0.1, 0.35, 0.6, 0.85])
@pytest.mark.parametrize("kind", ["baseline", "progressive", "lossless",
                                  "one_scan_a_component"])
def test_bad_huffman_codes_read_as_libjpeg(kind, at):
    """Sixteen one bits (two stuffed 0xFF bytes) in the scan data: no code
    starts there, and libjpeg reads 17 bits and takes symbol 0 with a
    warning (``jpeg_huff_decode``), where the port once raised."""
    data = SOURCES[kind]()
    start, end = scans(data)[-1]
    i = start + int((end - start) * at)
    C.assert_as_pillow(data[:i] + b"\xff\x00\xff\x00" + data[i + 2:], f"{kind}.jpg")


@pytest.mark.parametrize("kind", ["progressive", "one_scan_a_component",
                                  "arithmetic_progressive", "lossless_restart",
                                  "baseline", "gray"])
def test_a_missing_eoi_as_pillow(kind):
    """A file whose last scan is followed by a comment and no EOI: libjpeg
    reads every scan of a multi-scan file before any output, so Pillow
    finds it truncated; a single-scan file it reads. The port does
    both."""
    data = SOURCES[kind]()
    assert data.endswith(EOI)
    cut_eoi = data[:-2] + b"\xff\xfe\x00\x04ab"
    if kind in ("baseline", "gray"):
        C.assert_like_pillow(cut_eoi, f"{kind}.jpg")
    else:
        assert C.pillow_refuses(cut_eoi)
        C.assert_refused(cut_eoi, "m.jpg", ValueError, "truncated JPEG data")


def _with_marker(data: bytes, segment: bytes, before_scan: bool) -> bytes:
    sos = data.index(b"\xff\xda")
    at = sos if before_scan else scans(data)[0][1]
    return data[:at] + segment + data[at:]


MARKERS = {
    "reserved_before_scan": (b"\xff\x84\x00\x04ab", True),
    "reserved_after_scan": (b"\xff\x84\x00\x04ab", False),
    "tem_before_scan": (b"\xff\x01", True),
    "tem_after_scan": (b"\xff\x01", False),
    "jpg_after_scan": (b"\xff\xc8\x00\x04ab", False),
    "jpgn_after_scan": (b"\xff\xf3\x00\x04ab", False),
    "dhp_after_scan": (b"\xff\xde\x00\x04ab", False),
    "junk_ff00_before_scan": (b"\xff\x00", True),
    "junk_bytes_before_scan": (b"\x12\x34", True),
    "com_after_scan": (b"\xff\xfe\x00\x05abc", False),
}


@pytest.mark.parametrize("case", sorted(MARKERS))
def test_markers_as_pillow_and_libjpeg(case):
    """Before the first scan Pillow's own marker walk skips junk and FF 00
    and passes the bytes on at a marker it does not know (below 0xC0,
    TEM too); after it libjpeg ignores TEM, skips COM and refuses JPG,
    DHP, JPGn and the reserved markers."""
    segment, before = MARKERS[case]
    C.assert_as_pillow(_with_marker(SOURCES["progressive"](), segment, before),
              f"{case}.jpg")


def _without_dht(data: bytes) -> bytes:
    out, pos = data[:2], 2
    while data[pos + 1] != 0xDA:
        length = int.from_bytes(data[pos + 2:pos + 4], "big")
        if data[pos + 1] != 0xC4:
            out += data[pos:pos + 2 + length]
        pos += 2 + length
    return out + data[pos:]


@pytest.mark.parametrize("kind", ["baseline", "gray", "restart_2"])
def test_undefined_huffman_tables_0_and_1_are_the_standard_ones(kind):
    """libjpeg-turbo supplies ISO 10918-1's K.3 tables for a scan naming
    table 0 or 1 of a class no DHT defined (``jpeg_std_huff_table``);
    Pillow's default files use exactly those."""
    data = _without_dht(SOURCES[kind]())
    assert b"\xff\xc4" not in data[:data.index(b"\xff\xda")]
    np.testing.assert_array_equal(C.assert_like_pillow(data, f"{kind}.jpg"),
                                  C.pillow_rgba(SOURCES[kind]()))


@pytest.mark.parametrize("tail", ["cut_app", "cut_dht", "second_scan",
                                  "unknown_marker"])
def test_what_follows_a_single_scan_as_pillow(tail):
    """After a single scan that held every component libjpeg's output is
    done: a segment cut short there only makes its finish wait, which
    Pillow accepts; a second scan (EOI expected) or an unknown marker is
    an error."""
    data = SOURCES["baseline"]()[:-2]
    sos = data.index(b"\xff\xda")
    dht = data.index(b"\xff\xc4")
    data += {"cut_app": b"\xff\xe3\x01\x00abc",
             "cut_dht": data[dht:dht + 9],
             "second_scan": data[sos:sos + 40],
             "unknown_marker": b"\xff\xf2\x00\x02"}[tail]
    C.assert_as_pillow(data, f"{tail}.jpg")
    assert C.pillow_refuses(data) == (tail in ("second_scan",
                                               "unknown_marker"))


@pytest.mark.parametrize("length", [0, 1])
@pytest.mark.parametrize("marker", [0xE0, 0xEE, 0xFE])
def test_an_app_or_comment_length_under_2_as_pillow(marker, length):
    """libjpeg and Pillow's marker walk read an APPn or COM segment whose
    length is under 2 as its two length bytes alone."""
    data = SOURCES["baseline"]()
    C.assert_as_pillow(data[:2] + bytes([0xFF, marker, 0, length])
                       + data[2:], "a.jpg")
