"""The port's JPEG 2000 reader (``utils/jpeg2000.py``) against Pillow
12.1.0 with OpenJPEG 2.5.4, which the JAX package reads LDR images with.

Every case is held array-equal to ``Image.open(...).convert("RGBA")`` (or
refused where Pillow refuses) and decoded twice, with the C++ code-block
decoder (``accel/cbvh/j2k_scan.cpp``'s ``wpt_j2k_t1``) and with its plain
Python version, ``t1_plain``. The committed files under ``tests/ldr``
(``j2k_*``) are Pillow's writer in every mode and under each of its
options, and ``tools/j2k_fixtures.py``'s: libopenjp2's encoder with the
code-block styles, SOP/EPH, ROI, progression changes, tile-parts and
subsampled components, and byte-level rewrites (PPT, PPM, tile-parts cut
at packet boundaries, COM/CRG/TLM, JP2 boxes). Pillow's writer also runs
here on seeded options. The files Pillow refuses raise ``ValueError``;
HTJ2K raises ``NotImplementedError``; the JAX package's atlas and map
loaders give the port's arrays. The Pillow stubs that fail to load
(BUFR, GRIB, HDF5, MPEG) are held here too.
"""

import hashlib
import io
import json
import struct
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from chip_smoke import JPEG2000_ENV_MAPS, JPEG2000_TEXTURES, with_sidecar_images
from wgpu_path_tracing_tpu.models import gltf as JG
from wgpu_path_tracing_tpu.ops import env as JENV
from wgpu_path_tracing_tpu_torch import scene_to_glb, textured_cornell
from wgpu_path_tracing_tpu_torch.accel import native
from wgpu_path_tracing_tpu_torch.models import gltf as G
from wgpu_path_tracing_tpu_torch.ops import env as ENV
from wgpu_path_tracing_tpu_torch.utils import jpeg2000 as J2K
from wgpu_path_tracing_tpu_torch.utils import sniff
from tests import torch_image_cases as C

sys.path.insert(0, f"{C.LDR_DIR}/../../tools")
import j2k_fixtures as F  # noqa: E402

torch.set_num_threads(1)

FIXTURES = np.load(f"{C.LDR_DIR}/pillow_rgba.npz")
FILES = sorted(n for n in FIXTURES.files if n.endswith((".j2k", ".jp2")))
RGB = C.sample_image(29, 23, 41, 3)


def fixture(name: str) -> bytes:
    with open(f"{C.LDR_DIR}/{name}", "rb") as f:
        return f.read()


def planes(img: np.ndarray, n: int) -> list:
    return [img[..., i].astype(np.int32) for i in range(n)]


@pytest.mark.parametrize("name", FILES)
def test_committed_files_equal_pillow(name):
    np.testing.assert_array_equal(C.assert_like_pillow(fixture(name), name),
                                  FIXTURES[name])


def test_the_fixtures_cover_every_feature():
    """Modes, wavelets, orders, tiles, tile-parts, layers, precincts,
    signed samples: each is among the committed files."""
    for part in ("_l_", "_la_", "_rgb_", "_rgba_", "_i16_", "cmyk", "pclr",
                 "sycc", "_rev", "_irr", "lrcp", "rlcp", "rpcl", "pcrl",
                 "cprl", "tiles", "tile_parts", "layers", "signed", "ppt",
                 "ppm", "sop", "roi", "poc", "sub_420", "vsc", "bypass"):
        assert any(part in n for n in FILES), part
    assert len(FILES) >= 60


@pytest.mark.parametrize("name", [C.MEDIUM_J2K_IRR, C.MEDIUM_J2K_REV])
def test_timing_pair_at_the_plain_size_equals_pillow(name):
    """The committed 512x256 pair ``chip_smoke.py`` decodes both ways, to
    the SHA-256 of Pillow's decode."""
    with open(f"{C.LDR_DIR}/pillow_sha256.json") as f:
        want = json.load(f)[name]
    for in_cxx in (True, False):
        got = C.decode_in(in_cxx, fixture(name), name)
        assert hashlib.sha256(got.tobytes()).hexdigest() == want


def test_large_timing_files_are_pillows():
    """The committed 4096x2048 maps hold what their writer makes, and
    their headers are what the card's phase expects."""
    for name, irr in ((C.LARGE_J2K_IRR, True), (C.LARGE_J2K_REV, False)):
        codec, size, mode, _ = J2K.open_header(fixture(name))
        assert (codec, size, mode) == ("jp2" if irr else "j2k",
                                       (4096, 2048), "RGB")


# --- Pillow's writer under seeded options ---------------------------------------

OPTIONS = [
    {}, {"irreversible": True}, {"no_jp2": True, "progression": "RPCL"},
    {"tile_size": (11, 9), "offset": (3, 5)},
    {"tile_size": (12, 12), "tile_offset": (2, 1), "offset": (2, 3),
     "irreversible": True},
    {"num_resolutions": 1}, {"num_resolutions": 4, "codeblock_size": (4, 4)},
    {"quality_mode": "dB", "quality_layers": [20, 30, 40]},
    {"quality_mode": "rates", "quality_layers": [80, 20, 5],
     "irreversible": True, "progression": "CPRL",
     "precinct_size": (32, 32)},
    {"mct": 0}, {"signed": True, "irreversible": True}, {"plt": True},
]


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "I;16"])
@pytest.mark.parametrize("k", range(len(OPTIONS)))
def test_pillow_written_equals_pillow(mode, k):
    """(OpenJPEG's encoder aborts on some option sets and sizes, a tile or
    band one sample wide under the 9/7: these sizes avoid that.)"""
    w, h = 9 + 2 * k, 21 - k
    img = Image.fromarray(C.sample_image(w, h, 100 + k))
    if mode == "I;16":
        img = Image.fromarray(C.sample_image(w, h, k, 1)[..., 0].astype(
            np.uint16) * 37).convert("I;16")
    else:
        img = img.convert(mode)
    C.assert_as_pillow(C.pillow_bytes(img, "JPEG2000", **OPTIONS[k]))


@pytest.mark.parametrize("w,h", [(4, 9), (9, 4), (5, 5), (6, 4)])
@pytest.mark.parametrize("irreversible", [False, True])
def test_one_sample_wide_bands(w, h, irreversible):
    """Three resolutions of images this small leave lines of one and two
    samples: OpenJPEG's 5/3 halves a lone high sample, its 9/7 leaves it;
    odd origins put it there."""
    for origin in ((0, 0), (1, 1), (3, 1)):
        data = F.opj_encode(planes(C.sample_image(w, h, 3, 3), 3), width=w,
                            height=h, origin=origin, numres=3,
                            irreversible=irreversible)
        C.assert_as_pillow(data)


@pytest.mark.parametrize("enumcs", [0, 17])
def test_gray_tiles_under_an_rgb_header(enumcs):
    """A JP2 header of three components over a one-component tiled
    codestream with an image offset: Pillow's gray-to-RGB unpacker puts a
    tile x0 bytes (not pixels) into the row."""
    gray = C.sample_image(19, 31, 5, 1)[..., 0].astype(np.int32)
    cs = F.opj_encode([gray], width=19, height=31, origin=(4, 7),
                      tile=(20, 13), colour=2)
    C.assert_like_pillow(F.jp2(cs, F.ihdr(19, 31, 3, 7) + F.colr(enumcs)))


def test_subsampled_samples_of_four_bytes():
    """20-bit components (4 bytes a sample in the tile buffer), chroma
    subsampled: Pillow's indexing over the packed buffer."""
    img = C.sample_image(22, 26, 6, 3).astype(np.int32) * 4096 + 77
    data = F.opj_encode([img[..., 0], img[::1, ::2, 1], img[::1, ::2, 2]],
                        width=22, height=26, dx=[1, 2, 2], dy=[1, 1, 1],
                        prec=20, numres=3)
    C.assert_like_pillow(data)


# --- what Pillow refuses, passes on, or cannot be read here ---------------------


def _base() -> bytes:
    return F.opj_encode(planes(RGB, 3), width=29, height=23, rates=[25, 6, 2],
                        numres=3)


def _scod(bits: int) -> bytes:
    data = bytearray(_base())
    cod = next(off for m, off, _ in F.markers(bytes(data)) if m == 0xFF52)
    data[cod + 4] |= bits
    return bytes(data)


def _swap_parts(cs: bytes) -> bytes:
    """The codestream with its first two tile-parts swapped (the first
    keeps the tile-part header, so OpenJPEG meets TPsot 1 first)."""
    sots = [off for m, off, _ in F.markers(cs) if m == 0xFF90]
    first, second = cs[sots[0]:sots[1]], cs[sots[1]:sots[2]]
    return cs[:sots[0]] + second + first + cs[sots[2]:]


REFUSED = {
    "cut_j2k_30": lambda: fixture("j2k_rgb_rev.jp2")[:300],
    "cut_j2k": lambda: _base()[:len(_base()) * 6 // 10],
    "cut_jp2": lambda: fixture("j2k_rgba_rev.jp2")[:-200],
    "eph_missing": lambda: _scod(4),
    "scod_unknown_bit": lambda: _scod(8),
    "precincts_not_given": lambda: _scod(1),
    "zppt_repeated": lambda: F.with_ppt(_base(), 3, repeat_z=True),
    "ihdr_size_differs": lambda: F.jp2(_base(), F.ihdr(29, 22, 3, 7)
                                       + F.colr(16)),
    "no_jp2h": lambda: F.box(b"jP  ", b"\r\n\x87\n") + F.box(b"ftyp", bytes(
        12)) + F.box(b"jp2c", _base()),
    "eoc_cut": lambda: _base()[:-2] + b"\xff",
    "tile_parts_out_of_order": lambda: _swap_parts(
        F.split_tile_parts(_base(), 3)),
    "psot_past_the_end": lambda: _base()[:-5],
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_refused_as_pillow(case):
    data = REFUSED[case]()
    assert C.pillow_refuses(data)
    C.assert_refused(data, "r.jp2", ValueError)


def test_missing_sop_markers_are_read():
    """COD announcing SOP markers that are not there: OpenJPEG warns and
    reads on."""
    C.assert_like_pillow(_scod(2))


def test_bytes_after_eoc_are_ignored_and_a_missing_eoc_refused():
    """OpenJPEG reads no further than EOC, and without one ends on a
    stream too short."""
    C.assert_like_pillow(_base() + b"\0\0\0")
    assert C.pillow_refuses(_base()[:-2])
    C.assert_refused(_base()[:-2], "e.j2k", ValueError)


def _marker_order(case: str) -> bytes:
    """A COC (VSC code-blocks for component 1) or QCC (other exponents)
    before or after the COD or QCD it contradicts, or a second COD."""
    base = _base()
    ms = F.markers(base)
    cod_at, cod = next((off, b) for m, off, b in ms if m == 0xFF52)
    qcd_at, qcd = next((off, b) for m, off, b in ms if m == 0xFF5C)
    coc = F.segment(0xFF53, bytes([1, cod[0] & 1]) + cod[5:8] + b"\x08"
                    + cod[9:])
    qcc = F.segment(0xFF5D, b"\x01" + qcd[:1] + bytes(x ^ 8 for x in qcd[1:]))
    after_qcd = qcd_at + 4 + len(qcd)
    return {"coc_before_cod": base[:cod_at] + coc + base[cod_at:],
            "coc_after_cod": base[:qcd_at] + coc + base[qcd_at:],
            "qcc_before_qcd": base[:qcd_at] + qcc + base[qcd_at:],
            "qcc_after_qcd": base[:after_qcd] + qcc + base[after_qcd:],
            "two_cod": base[:qcd_at] + F.segment(0xFF52, cod)
            + base[qcd_at:]}[case]


def _in_second_part(case: str) -> bytes:
    """The base cut in three tile-parts, a COD (or one with VSC
    code-blocks) or QCD in the second part's header."""
    base = _base()
    ms = F.markers(base)
    cod = next(b for m, _, b in ms if m == 0xFF52)
    qcd = next(b for m, _, b in ms if m == 0xFF5C)
    seg = {"later_cod": F.segment(0xFF52, cod),
           "later_cod_vsc": F.segment(0xFF52, cod[:8] + b"\x08" + cod[9:]),
           "later_qcd": F.segment(0xFF5C, qcd)}[case]
    parts = F.split_tile_parts(base, 3)
    sot = [off for m, off, _ in F.markers(parts) if m == 0xFF90][1]
    data = bytearray(parts[:sot + 12] + seg + parts[sot + 12:])
    psot = struct.unpack_from(">I", data, sot + 6)[0]
    struct.pack_into(">I", data, sot + 6, psot + len(seg))
    return bytes(data)


@pytest.mark.parametrize("case", ["coc_before_cod", "coc_after_cod",
                                  "qcc_before_qcd", "qcc_after_qcd",
                                  "two_cod", "later_cod", "later_cod_vsc",
                                  "later_qcd"])
def test_header_markers_apply_in_their_order(case):
    """OpenJPEG applies COD and QCD to every component, over a COC or QCC
    read before them, takes a second COD, and takes COD and QCD in a
    tile-part after the first, the last read applying to the tile."""
    make = _in_second_part if case.startswith("later") else _marker_order
    C.assert_like_pillow(make(case))


def _sot(index: int, psot: int, part: int, parts: int) -> bytes:
    return F.segment(0xFF90, struct.pack(">HIBB", index, psot, part, parts))


def _stream_end(case: str) -> bytes:
    """Codestreams whose tile data ends early or is missing."""
    base = _base()
    sot = next(off for m, off, _ in F.markers(base) if m == 0xFF90)
    tiled = F.opj_encode(planes(RGB, 3), width=29, height=23, numres=2,
                         tile=(16, 12))
    sots = [off for m, off, _ in F.markers(tiled) if m == 0xFF90]
    empty = b"\xff\x93\xff\xd9"
    return {
        "ends_on_a_sot": base[:sot + 2],
        "ends_a_byte_after_a_sot": base[:sot + 3],
        "empty_tile_of_unknown_parts": base[:sot] + _sot(0, 14, 0, 0) + empty,
        "empty_complete_tile": base[:sot] + _sot(0, 14, 0, 1) + empty,
        "second_tile_missing": tiled[:sots[1]] + tiled[sots[2]:],
        "ends_on_the_second_sot": tiled[:sots[1] + 2],
        "ends_in_a_tile_part_header": base[:sot] + _sot(0, 0, 0, 1)
        + b"\xff\x64",
    }[case]


@pytest.mark.parametrize("case", ["ends_on_a_sot", "ends_a_byte_after_a_sot",
                                  "empty_tile_of_unknown_parts",
                                  "empty_complete_tile",
                                  "second_tile_missing",
                                  "ends_on_the_second_sot",
                                  "ends_in_a_tile_part_header"])
def test_stream_ends_as_pillow(case):
    """OpenJPEG stops without error where the stream ends on a SOT's
    marker (the tiles not decoded stay black) and skips a tile with no
    data at the end; a complete tile without data, or a stream ending a
    byte later or inside a tile-part header, is refused."""
    C.assert_as_pillow(_stream_end(case))


def _bad_headers(case: str) -> bytes:
    """Packet headers and JP2 boxes OpenJPEG refuses."""
    base = _base()
    ppm = bytearray(F.with_ppm(base, 2))
    at = next(off for m, off, _ in F.markers(bytes(ppm)) if m == 0xFF60)
    ppm[at + 5:at + 9] = (struct.unpack_from(">I", ppm, at + 5)[0]
                          + 3).to_bytes(4, "big")
    sot = next(off for m, off, _ in F.markers(base) if m == 0xFF90)
    one_byte_ppt = F.segment(0xFF61, b"\x00")
    pal = np.zeros((4, 3), np.uint8)
    return {
        "eph_cut_off": _scod(4)[:-4] + b"\xff\xd9",
        "nppm_past_its_data": bytes(ppm),
        "ppt_of_one_byte": base[:sot + 12] + one_byte_ppt + base[sot + 12:],
        "cmap_before_pclr": F.jp2(base, F.ihdr(29, 23, 3, 7) + F.colr(16)
                                  + F.cmap([(0, 1, 0)]) + F.pclr(pal)),
        "two_cdef": F.jp2(base, F.ihdr(29, 23, 3, 7) + F.colr(16)
                          + F.cdef([(0, 0, 1)]) * 2),
    }[case]


@pytest.mark.parametrize("case", ["eph_cut_off", "nppm_past_its_data",
                                  "ppt_of_one_byte", "cmap_before_pclr",
                                  "two_cdef"])
def test_bad_headers_as_pillow(case):
    C.assert_as_pillow(_bad_headers(case))


PASSED_ON = {
    "no_components": b"\xff\x4f\xff\x51" + bytes(40),
    "five_components": (b"\xff\x4f\xff\x51\x00\x32" + bytes(34) + b"\x00\x05"
                        + b"\x07\x01\x01" * 5),
    "siz_cut": b"\xff\x4f\xff\x51\x00\x29\x00\x00",
    "box_of_length_zero": b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a" + bytes(8),
    "no_ihdr": (b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a"
                + F.box(b"jp2h", F.colr(16))),
}


@pytest.mark.parametrize("case", sorted(PASSED_ON))
def test_headers_pillow_passes_on(case):
    """Pillow's ``_open`` raises ``SyntaxError`` or ``struct.error``: the
    bytes go on to the next format (here none takes them)."""
    data = PASSED_ON[case]
    assert "JPEG2000" in list(sniff.pillow_candidates(data))
    with pytest.raises(sniff.NotThisFormat):
        J2K.decode_jpeg2000_rgba(data, "p.j2k")
    assert C.pillow_refuses(data)
    C.assert_refused(data, "p.j2k", ValueError,
                     "not an image Pillow can identify")


def test_jp2_cut_in_its_boxes_ends_the_search():
    """A JP2 file that ends inside its boxes: Pillow's ``BoxReader``
    raises ``OSError``, which ends ``Image.open``'s search."""
    data = fixture("j2k_rgb_rev.jp2")[:40]
    assert C.pillow_refuses(data)
    C.assert_refused(data, "c.jp2", ValueError, "Expected to read")


def test_htj2k_raises_not_implemented():
    """A CAP marker (HTJ2K, Part 15): OpenJPEG decodes it, nothing on the
    build host writes it, and the port raises naming the file."""
    base = _base()
    at = next(off for m, off, _ in F.markers(base) if m == 0xFF52)
    data = base[:at] + F.segment(0xFF50, b"\x00\x02\x00\x00\x00\x00") + \
        base[at:]
    C.assert_refused(data, "ht.j2k", NotImplementedError, "JPEG 2000 with")


def test_ht_code_block_style_raises_not_implemented():
    data = bytearray(_base())
    cod = next(off for m, off, _ in F.markers(bytes(data)) if m == 0xFF52)
    data[cod + 12] |= 0x40
    C.assert_refused(bytes(data), "ht.j2k", NotImplementedError)


# --- tiers in isolation -----------------------------------------------------------


def _blocks_equal(data: bytes) -> int:
    """Every code-block of ``data``'s first tile, decoded by ``t1_plain``
    and by ``wpt_j2k_t1``, sample for sample; returns the blocks held."""
    cs = J2K._Codestream(data)
    tcp = cs.tcps[0]
    tile = J2K._tile_geometry(cs, tcp, 0)
    J2K._read_packets(cs, tcp, tile, None)
    held = 0
    for comp in tile["comps"]:
        for res in comp["res"]:
            for band in res.bands:
                for prec in band.precincts:
                    for blk in prec[2]:
                        if not blk.segs or blk.x1 <= blk.x0:
                            continue
                        data = b"".join(blk.chunks)
                        segs, at = [], 0
                        for seg in blk.segs:
                            segs.append((at, seg[2], seg[1]))
                            at += seg[2]
                        w, h = blk.x1 - blk.x0, blk.y1 - blk.y0
                        numbps = (blk.numbps if blk.numbps < 1 << 31
                                  else blk.numbps - (1 << 32))
                        args = (w, h, band.orient, comp["tc"].cblksty,
                                numbps, comp["tc"].roishift)
                        want = J2K.t1_plain(data, *args, segs)
                        table = np.array([[*args, 0, len(segs), 0]])
                        got, status = native.j2k_t1_native(
                            data, table, np.array(segs), w * h)
                        assert status == (want is None)
                        if want is not None:
                            np.testing.assert_array_equal(
                                got.reshape(h, w), want)
                        held += 1
    return held


def test_t1_plain_equals_the_cxx_decoder_block_by_block():
    """Every code-block of a file of every style, decoded by ``t1_plain``
    and by ``wpt_j2k_t1``, sample for sample."""
    for name in ("j2k_cblk_all_styles_irr.j2k", "j2k_cblk_vsc_rev.j2k",
                 "j2k_roi_shift.j2k"):
        assert _blocks_equal(fixture(name))


def _roi_shift(shift: int, guard: int) -> bytes:
    """A 16 x 16 gray code-block of values 127-129 under RGN, its RGN shift
    byte set to ``shift`` and its QCD to exponents 0 and ``guard`` guard
    bits: the block's numbps turns negative (-8 or -7), so shifts up to 38
    pass OpenJPEG's check of 31 bit-planes."""
    img = (127 + np.random.default_rng(0).integers(0, 3, (16, 16))
           ).astype(np.int32)
    data = bytearray(F.opj_encode([img], width=16, height=16, roi=(0, 1),
                                  numres=1))
    at = {m: off for m, off, _ in F.markers(bytes(data))}
    data[at[0xFF5E] + 6] = shift
    qcd = at[0xFF5C]
    data[qcd + 4] = guard << 5
    for k in range(qcd + 5, qcd + 2 + struct.unpack_from(">H", data,
                                                          qcd + 2)[0]):
        data[k] = 0
    return bytes(data)


@pytest.mark.parametrize("shift", [20, 30, 31, 32, 33, 36, 40, 255])
@pytest.mark.parametrize("guard", [0, 1])
def test_roi_shift_of_31_or_more_as_pillow(shift, guard):
    """An RGN shift of 31 or more whose sum with a negative numbps stays
    under 31: OpenJPEG clears the block (every sample the DC level); a
    larger sum is refused. Both loops, block by block too."""
    data = _roi_shift(shift, guard)
    C.assert_as_pillow(data)
    if 31 <= shift <= 36:
        assert not C.pillow_refuses(data)
        assert (C.pillow_rgba(data)[..., :3] == 128).all()
    assert _blocks_equal(data)


def test_packet_order_visits_every_packet_once():
    cs = J2K._Codestream(fixture("j2k_poc.j2k"))
    tcp = cs.tcps[0]
    tile = J2K._tile_geometry(cs, tcp, 0)
    order = list(J2K._packet_order(tile, tcp, cs.nc))
    assert len(order) == len(set(order))
    assert tcp.pocs and order


# --- against the JAX package --------------------------------------------------------


@pytest.mark.parametrize("ratio", [1.0, 0.5])
def test_jpeg2000_sidecars_build_the_jax_atlas(ratio, tmp_path):
    """``textured_cornell()`` as a .gltf whose four textures are the
    sidecars ``chip_smoke.JPEG2000_TEXTURES``: the port's atlas equals the
    JAX ``build_atlas``'s."""
    for name in JPEG2000_TEXTURES:
        (tmp_path / name).write_bytes(fixture(name))
    path = tmp_path / "textured.gltf"
    path.write_text(with_sidecar_images(scene_to_glb(textured_cornell()),
                                        list(JPEG2000_TEXTURES)))
    assert len(json.loads(path.read_text())["images"]) == 4
    got, got_rects = G.build_atlas(G.GLTFFile.load(str(path)), ratio)
    want, want_rects = JG.build_atlas(JG.GLTFFile.load(str(path)), ratio)
    np.testing.assert_array_equal(got, want)
    assert got_rects == want_rects


@pytest.mark.parametrize("name", [n for n, _ in JPEG2000_ENV_MAPS])
@pytest.mark.parametrize("in_cxx", [True, False])
def test_env_maps_equal_jax(name, in_cxx, tmp_path, monkeypatch):
    """``load_env_image`` of the card's JP2 and J2K maps equals the JAX
    package's, with the C++ code-block decoder and with the plain one."""
    if not in_cxx:
        monkeypatch.setattr(native, "native_available", lambda: False)
    path = str(tmp_path / "sky.png")
    with open(path, "wb") as f:
        f.write(fixture(name))
    np.testing.assert_array_equal(ENV.load_env_image(path),
                                  JENV.load_env_image(path))


def test_jax_decode_image_equals_port():
    for name in ("j2k_sycc.jp2", "j2k_pclr_rgba_pa.jp2", "j2k_gray16.jp2"):
        data = fixture(name)
        np.testing.assert_array_equal(
            C.decode_in(True, data, name), JG._decode_image(data))


def test_a_failed_native_build_raises(monkeypatch):
    def fail(cxx=None):
        raise RuntimeError("g++ failed to build the native library")

    monkeypatch.setattr(native._Lib, "handle", None)
    monkeypatch.setattr(native, "build", fail)
    monkeypatch.setattr(native, "native_available", lambda: True)
    with pytest.raises(RuntimeError, match="failed to build"):
        C.decode_in(True, fixture("j2k_rgb_rev.jp2"), "x.jp2")


# --- Pillow's failing stubs ----------------------------------------------------------

STUBS = {
    "bufr": (b"BUFR" + bytes(60), "BUFR"),
    "bufr_zczc": (b"ZCZC" + bytes(60), "BUFR"),
    "grib": (b"GRIB\x00\x00\x00\x01" + bytes(60), "GRIB"),
    "hdf5": (b"\x89HDF\r\n\x1a\n" + bytes(60), "HDF5"),
    "mpeg": (b"\x00\x00\x01\xb3\x01\x00\x10" + bytes(20), "MPEG"),
}


@pytest.mark.parametrize("case", sorted(STUBS))
def test_stub_formats_fail_as_pillow(case):
    """Pillow opens each and its ``load`` raises (no handler; MPEG has no
    decoder); the port raises naming the file and the format."""
    data, fmt = STUBS[case]
    assert fmt in list(sniff.pillow_candidates(data))
    assert C.pillow_refuses(data)
    C.assert_refused(data, "s.bin", ValueError, f"an? {fmt} file")


@pytest.mark.parametrize("data", [b"\x00\x00\x01\xb3\x00\x10\x00" + bytes(9),
                                  b"\x00\x00\x01\xb3\x01"])
def test_mpeg_without_a_size_is_passed_on(data):
    """An MPEG header of no width or height, or cut before them: Pillow's
    ``_open`` passes it on (here to no format)."""
    assert C.pillow_refuses(data)
    C.assert_refused(data, "m.mpg", ValueError,
                     "not an image Pillow can identify")


def test_header_parse_matches_pillow_open():
    """``open_header`` gives Pillow's size and mode on every committed
    file."""
    for name in FILES:
        data = fixture(name)
        _, size, mode, _ = J2K.open_header(data)
        with Image.open(io.BytesIO(data)) as im:
            assert (size, mode) == (im.size, im.mode), name
