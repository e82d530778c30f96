"""TIFF's last variants in the port's reader against Pillow 12.1.0 with
libtiff 4.7.1 (which the JAX package reads LDR images with), and the
repairs of three readers found by the fuzz.

* zstd (``utils/zstd.py``, C++ ``accel/cbvh/zstd_scan.cpp``) against
  Pillow's own libzstd 1.5.7 through ctypes: ``ZSTD_decompress`` on clean
  and mutated frames, and libtiff's ``ZSTDDecode`` loop over
  ``ZSTD_decompressStream``;
* old-style JPEG (compression 6) in both layouts, built from JPEGs Pillow
  writes (``tests/torch_image_cases.py::write_ojpeg``);
* ThunderScan and CCITT RLEW (``tiff.thunder_plain`` and ``fax_plain``,
  their C++ twins), WebP-in-TIFF and SGILog refused, big-endian signed
  16-bit samples and separate planes of other modes;
* a JPEG scan that runs to the end of the file (libjpeg's refill points
  as Pillow feeds it), a JPEG-in-TIFF strip libjpeg fails after its rows,
  and the JPEG 2000 Part 2 markers.

Every file is held array-equal to ``Image.open(...).convert("RGBA")``,
decoded with the C++ loops and with their plain versions; the env map and
the atlas of such files against the JAX package's.
"""

import hashlib
import json
import struct

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from chip_smoke import (TIFF_LEFTOVER_ENV_MAPS, TIFF_LEFTOVER_TEXTURES,
                        TIFF_VARIANT_TEXTURES, with_sidecar_images)
from wgpu_path_tracing_tpu.models import gltf as JG
from wgpu_path_tracing_tpu.ops import env as JENV
from wgpu_path_tracing_tpu_torch import scene_to_glb, textured_cornell
from wgpu_path_tracing_tpu_torch.accel import native
from wgpu_path_tracing_tpu_torch.models import gltf as G
from wgpu_path_tracing_tpu_torch.ops import env as ENV
from wgpu_path_tracing_tpu_torch.utils import fax, jpeg, tiff, zstd
from tests import torch_image_cases as C
from tests import torch_jpeg_cases as J

torch.set_num_threads(1)

FIXTURES = np.load(f"{C.LDR_DIR}/pillow_rgba.npz")
LEFTOVERS = sorted(C.tiff_leftover_fixtures())
RGB = C.sample_image(48, 32, 61, 3)
GRAY = C.sample_image(33, 17, 62, 1)


def fixture(name: str) -> bytes:
    with open(f"{C.LDR_DIR}/{name}", "rb") as f:
        return f.read()


def both(data: bytes, name: str = "case") -> list:
    """The decode with the C++ loops and with the plain ones."""
    return [C.decode_in(in_cxx, data, name) for in_cxx in (True, False)]


# --- the committed files -------------------------------------------------------

@pytest.mark.parametrize("name", LEFTOVERS + ["env_zstd.tif", "env_ojpeg.tif"])
def test_committed_files_equal_pillow(name):
    data = fixture(name)
    for got in both(data, name):
        np.testing.assert_array_equal(got, FIXTURES[name])


@pytest.mark.parametrize("name", [n for n in LEFTOVERS if n.startswith((
    "zstd", "ojpeg"))])
def test_zstd_and_ojpeg_equal_the_jax_decode(name):
    """The JAX package's own texture decode (``models/gltf.py::
    _decode_image``, Pillow's RGBA) against the port's."""
    want = np.asarray(JG._decode_image(fixture(name)))
    np.testing.assert_array_equal(C.decode_in(True, fixture(name), name),
                                  want)


@pytest.mark.parametrize("name", [n for n, _ in TIFF_LEFTOVER_ENV_MAPS]
                         + ["planes_lab_lzw.tif", "thunderscan_gray4.tif",
                            "rlew.tif", "signed16_mm_zstd_pred2.tif"])
def test_env_map_equals_jax(name, tmp_path):
    path = str(tmp_path / "sky.tif")
    with open(path, "wb") as f:
        f.write(fixture(name))
    np.testing.assert_array_equal(ENV.load_env_image(path),
                                  JENV.load_env_image(path))


def test_sidecars_build_the_jax_atlas(tmp_path):
    """``textured_cornell()`` as a .gltf with the TIFF variants' and the
    leftovers' sidecars (the last two as materials 2 and 3's emissive
    maps, ``chip_smoke.py``'s box): the port's atlas equals the JAX
    ``build_atlas``'s."""
    names = list(TIFF_VARIANT_TEXTURES + TIFF_LEFTOVER_TEXTURES)
    for name in names:
        (tmp_path / name).write_bytes(fixture(name))
    path = tmp_path / "textured.gltf"
    path.write_text(with_sidecar_images(scene_to_glb(textured_cornell()),
                                        names))
    gltf = json.loads(path.read_text())
    assert [m.get("emissiveTexture") for m in gltf["materials"][1:]] == [
        {"index": 3}, {"index": 4}, {"index": 5}]
    got, got_rects = G.build_atlas(G.GLTFFile.load(str(path)), 1.0)
    want, want_rects = JG.build_atlas(JG.GLTFFile.load(str(path)), 1.0)
    np.testing.assert_array_equal(got, want)
    assert got_rects == want_rects


@pytest.mark.parametrize("name", [C.LARGE_TIFF_ZSTD, C.LARGE_TIFF_OJPEG,
                                  C.MEDIUM_TIFF_ZSTD, C.MEDIUM_TIFF_OJPEG])
def test_timing_files_equal_pillows_digest(name):
    """The card's committed timing maps decode to the arrays whose SHA-256
    Pillow gave (the 512x256 pair both ways)."""
    with open(f"{C.LDR_DIR}/pillow_sha256.json") as f:
        want = json.load(f)[name]
    decodes = both(fixture(name), name) if "512" in name else [
        C.decode_in(True, fixture(name), name)]
    for got in decodes:
        assert hashlib.sha256(got.tobytes()).hexdigest() == want


# --- zstd ---------------------------------------------------------------------------

def zstd_data(n: int, kind: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    if kind == 0:
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    if kind == 1:
        return (rng.integers(0, 4, n, dtype=np.uint8) * 40).tobytes()
    if kind == 2:
        return C.sample_image(max(1, n // 12), 4, seed, 3).tobytes()[:n]
    words = [b"zstd", b"frame", b"block", b"literal", b"sequence", b" "]
    return b"".join(words[int(i)] for i in rng.integers(0, 6, n))[:n]


def zstd_both(src: bytes, limit=None):
    """(plain, C++) results: bytes, or None where refused."""
    out = []
    for fn in (zstd.zstd_plain, native.zstd_native):
        try:
            out.append(fn(src, limit))
        except zstd.ZstdError:
            out.append(None)
    return out


@pytest.mark.parametrize("level", [-5, -1, 1, 3, 7, 12, 19, 22])
@pytest.mark.parametrize("checksum", [False, True])
def test_zstd_frames_equal_libzstd(level, checksum):
    """Frames libzstd writes at every level, with and without the content
    checksum and size, over random, low-entropy, image and text data
    (raw, RLE and compressed blocks; every literal and sequence mode)."""
    for kind in range(4):
        for n in (0, 1, 7, 300, 5000, 140000):
            data = zstd_data(n, kind, 7 * n + kind)
            frame = C.zstd_compress(data, level, checksum, content_size=bool(
                n % 2))
            assert C.libzstd_decompress(frame, len(data) + 16) == data
            assert zstd_both(frame) == [data, data]


def test_zstd_skippable_and_concatenated_frames():
    a, b = zstd_data(3000, 3, 1), zstd_data(500, 1, 2)
    skip = struct.pack("<II", 0x184D2A53, 5) + b"12345"
    src = skip + C.zstd_compress(a, 5, True) + skip + C.zstd_compress(b, -2)
    assert C.libzstd_decompress(src) == a + b
    assert zstd_both(src) == [a + b, a + b]
    # a skippable frame past the data, and data after the last frame
    for bad in (src[:-3], src + b"\x00\x01", skip[:6]):
        assert C.libzstd_decompress(bad) is None
        assert zstd_both(bad) == [None, None]


def mutations(frame: bytes, rng, n: int):
    for _ in range(n):
        b = bytearray(frame)
        for _ in range(int(rng.integers(1, 4))):
            k = int(rng.integers(0, 4))
            if k == 0 and b:
                b[int(rng.integers(len(b)))] = int(rng.integers(256))
            elif k == 1 and b:
                b[int(rng.integers(len(b)))] ^= 1 << int(rng.integers(8))
            elif k == 2:
                b = b[:int(rng.integers(len(b) + 1))]
            else:
                at = int(rng.integers(len(b) + 1))
                b[at:at] = bytes(rng.integers(0, 256, 2, dtype=np.uint8))
        yield bytes(b)


@pytest.mark.parametrize("seed", range(6))
def test_zstd_mutated_frames_as_libzstd(seed):
    """Mutated frames: the bytes ZSTD_decompress gives or its refusal, and
    what libtiff's stream loop gets with a strip's room (a strip short of
    it refused), in Python and C++; the four-stream Huffman literals as
    libzstd's fast (BMI2) decoders read them."""
    rng = np.random.default_rng(100 + seed)
    for i in range(12):
        data = zstd_data(int(rng.choice([40, 900, 4000, 25000])), i % 4,
                         seed * 50 + i)
        frame = C.zstd_compress(data, int(rng.integers(-5, 20)),
                                bool(i % 2), bool(i % 3))
        for m in mutations(frame, rng, 6):
            want = C.libzstd_decompress(m, 1 << 22)
            assert zstd_both(m) == [want, want]
            limit = len(data) - int(rng.integers(0, 3))
            stream = C.libzstd_stream(m, limit)
            got = zstd_both(m, limit)
            refused = stream is None or len(stream) < limit
            for g in got:
                assert (g is None or len(g) < limit) if refused else g == stream


@settings(max_examples=40, deadline=None)
@given(st.binary(min_size=0, max_size=3000), st.integers(-5, 19),
       st.booleans())
def test_hypothesis_zstd_round_trip(data, level, checksum):
    frame = C.zstd_compress(data, level, checksum)
    assert zstd_both(frame) == [data, data]


@settings(max_examples=60, deadline=None)
@given(st.binary(min_size=5, max_size=200))
def test_hypothesis_zstd_random_bytes_as_libzstd(tail):
    """Any bytes after a frame header's magic number and descriptor."""
    src = struct.pack("<I", zstd.MAGIC) + tail
    want = C.libzstd_decompress(src, 1 << 20)
    assert zstd_both(src) == [want, want]


def test_zstd_xxh64_vectors():
    assert zstd.xxh64(b"") == 0xEF46DB3751D8E999
    assert zstd.xxh64(b"a") == 0xD24EC4F1A98C6E5B
    assert zstd.xxh64(b"abc") == 0x44BC2CF5AD770999


@pytest.mark.parametrize("case", ["pillow_rgb", "rgb16_mm_pred2_tiles",
                                  "float_pred3", "planes_rgba", "ycbcr_22",
                                  "gray_checksum_blocks"])
def test_zstd_tiffs_equal_pillow(case):
    img = C.sample_image(45, 27, 63, 4)
    data = {
        "pillow_rgb": lambda: C.pillow_bytes(img[..., :3], "TIFF",
                                             compression="zstd"),
        "rgb16_mm_pred2_tiles": lambda: C.write_tiff(
            img[..., :3].astype(np.uint16) * 257, 16, 2, compression=50000,
            predictor=2, order=">", tile=(16, 32)),
        "float_pred3": lambda: C.write_tiff(
            C.float_gray(45, 27, 64), 32, 1, compression=50000, predictor=3,
            sample_format=3, rows_per_strip=5),
        "planes_rgba": lambda: C.write_tiff(img, 8, 2, compression=50000,
                                            planar=2, extra=(2,)),
        "ycbcr_22": lambda: C.write_tiff(C.rgb_to_ycbcr(img[..., :3]), 8, 6,
                                         compression=50000,
                                         subsampling=(2, 2), rows_per_strip=6),
        "gray_checksum_blocks": lambda: zstd_tiff_with(
            lambda raw: C.zstd_compress(raw, 19, True), img[..., 0]),
    }[case]()
    C.assert_like_pillow(data, case)


def zstd_tiff_with(codec, gray: np.ndarray) -> bytes:
    """A one-strip gray zstd TIFF whose strip is ``codec(raw bytes)``."""
    raw = np.ascontiguousarray(gray).tobytes()
    h, w = gray.shape
    return C._tiff_with_body(b"II*\0\0\0\0\0" + codec(raw), {
        256: (4, [w]), 257: (4, [h]), 258: (3, [8]), 259: (3, [50000]),
        262: (3, [1]), 273: (4, [8]), 278: (4, [h]),
        279: (4, [len(codec(raw))])})


@pytest.mark.parametrize("case", ["short_frame", "long_frame", "bad_block",
                                  "window_too_large", "skippable_first",
                                  "bad_after_the_rows"])
def test_zstd_strips_as_libtiff_reads_them(case):
    """What libtiff's stream loop reads or refuses: a frame of fewer bytes
    than the strip (refused), of more (cut), a corrupt block before the
    strip fills (refused) or after (read), a window past 2^27 (refused), a
    skippable frame first (refused)."""
    gray = C.sample_image(40, 30, 65, 1)[..., 0]
    raw = gray.tobytes()

    def raw_blocks(payload: bytes, window: int = 0x50) -> bytes:
        out = struct.pack("<IBB", zstd.MAGIC, 0, window)
        for k in range(0, len(payload), 1000):
            part = payload[k:k + 1000]
            last = int(k + 1000 >= len(payload))
            out += (last | len(part) << 3).to_bytes(3, "little") + part
        return out

    codec = {
        "short_frame": lambda r: C.zstd_compress(r[:-10]),
        "long_frame": lambda r: C.zstd_compress(r + b"\0" * 500),
        "bad_block": lambda r: raw_blocks(r)[:700] + b"\x06\xff\xff",
        "window_too_large": lambda r: raw_blocks(r, 0xB0),
        "skippable_first": lambda r: struct.pack("<II", 0x184D2A50, 0)
        + C.zstd_compress(r),
        "bad_after_the_rows": lambda r: raw_blocks(r + b"x" * 10)[:-5]
        + b"\x07\x00\x00",
    }[case]
    C.assert_as_pillow(zstd_tiff_with(codec, gray), case)


# --- old-style JPEG ---------------------------------------------------------------

OJPEG = {
    "jif_420_strips": dict(rows_per_strip=16),
    "jif_420_one_strip": dict(),
    "jif_422_tiles": dict(sampling=(2, 1), tile=(16, 16)),
    "jif_444_tiles": dict(sampling=(1, 1), tile=(16, 16)),
    "jif_q95_restart_strips": dict(rows_per_strip=8, sampling=(1, 1),
                                   quality=95),
    "tables_420_strips": dict(layout="tables", rows_per_strip=16),
    "tables_422": dict(layout="tables", sampling=(2, 1)),
    "tables_444_strips": dict(layout="tables", sampling=(1, 1),
                              rows_per_strip=8),
    "tables_420_one_tile_column": dict(layout="tables", tile=(48, 16)),
    "tables_no_spp": dict(layout="tables", spp_tag=False,
                          rows_per_strip=16),
    "jif_rgb_photometric": dict(photometric=2, sampling=(1, 1)),
    "tables_strip_cut_short": dict(layout="tables", rows_per_strip=16,
                                   cut=3),
    "tables_no_restart_interval": dict(layout="tables", restart_tag=False),
    "tables_subsampling_tag_without_interval": dict(
        layout="tables", restart_tag=False, tags={530: (3, [1, 1])}),
    "tables_coefficients": dict(layout="tables", tags={
        529: (5, [(2126, 10000), (7152, 10000), (722, 10000)]),
        532: (5, [(16, 1), (235, 1), (128, 1), (240, 1), (128, 1),
                  (240, 1)])}),
}


@pytest.mark.parametrize("case", sorted(OJPEG))
def test_ojpeg_equals_pillow(case):
    """Old-style JPEG: the JPEGInterchangeFormat layout and the table tags'
    layout, 4:2:0, 4:2:2 and 4:4:4, strips and tiles, Pillow's 3 samples
    where the count is missing, RGB photometric (YCbCr to libtiff),
    YCbCrCoefficients and ReferenceBlackWhite in the RGBA reader; a strip
    cut short (libjpeg reads zeros up to the RSTn libtiff adds), no
    restart interval, a YCbCrSubsampling tag the data was not coded at
    (decoded as the tag says)."""
    kw = dict(OJPEG[case])
    cut = kw.pop("cut", 0)
    data = C.write_ojpeg(RGB, **kw)
    if cut:
        at = data.index(struct.pack("<HHI", 279, 4, 2)) + 8
        (where,) = struct.unpack_from("<I", data, at)
        first = struct.unpack_from("<I", data, where)[0]
        data = bytearray(data)
        struct.pack_into("<I", data, where, first // cut)
        data = bytes(data)
    C.assert_like_pillow(data, case)


@pytest.mark.parametrize("layout", ["jif", "tables"])
@pytest.mark.parametrize("rows", [8, 32])
def test_ojpeg_gray_equals_pillow(layout, rows):
    C.assert_like_pillow(C.write_ojpeg(RGB[..., :1], layout=layout,
                                       photometric=1, rows_per_strip=rows))


@pytest.mark.parametrize("case", ["no_tables", "gray_no_spp",
                                  "interchange_stream_cut"])
def test_ojpeg_pillow_refuses_raises_naming_the_image(case):
    """No JPEG tables, Pillow's 3 samples over libtiff's 1, an interchange
    stream that ends inside its markers."""
    data = {
        "no_tables": lambda: C.write_tiff(RGB, 8, 6, compression=1,
                                          tags={259: (3, [6])}),
        "gray_no_spp": lambda: C.write_ojpeg(RGB[..., :1], photometric=1,
                                             spp_tag=False),
        "interchange_stream_cut": lambda: C.write_ojpeg(
            RGB, tags={514: (4, [100]), 273: (4, [10]), 279: (4, [40])}),
    }[case]()
    assert C.pillow_refuses(data)
    C.assert_refused(data, "o.tif")


@pytest.mark.parametrize("case", ["tiles_past_the_frame", "wrong_interval",
                                  "subsampling_tag_disagrees"])
def test_ojpeg_libtiff_fails_partway_raises_not_implemented(case):
    """Where libtiff's OJPEG fails partway and Pillow's RGBA reader goes on
    with whatever its buffer holds: tiles of the table layout in more than
    one column (the frame is a tile column tall), and restart markers
    libjpeg would resync (OJPEG's source fails on a resync): a restart
    interval the data was not coded at, a YCbCrSubsampling tag it was not
    coded at."""
    data = {
        "tiles_past_the_frame": lambda: C.write_ojpeg(RGB, layout="tables",
                                                      tile=(16, 16)),
        "wrong_interval": lambda: C.write_ojpeg(RGB, layout="tables",
                                                tags={515: (3, [5])}),
        "subsampling_tag_disagrees": lambda: C.write_ojpeg(
            RGB, layout="tables", tags={530: (3, [1, 1])}),
    }[case]()
    assert not C.pillow_refuses(data)
    C.assert_refused(data, "o.tif", NotImplementedError)


# --- ThunderScan and RLEW ----------------------------------------------------------

def test_thunder_loops_in_cxx_equal_python():
    rng = np.random.default_rng(66)
    for i in range(400):
        w, rows = int(rng.integers(1, 30)), int(rng.integers(1, 4))
        if i % 2:
            src = C.thunder_encode(rng.integers(0, 16, (rows, w)), seed=i)
            src = bytes(x if rng.random() > 0.05 else int(rng.integers(256))
                        for x in src)
        else:
            src = rng.integers(0, 256, int(rng.integers(0, 50)),
                               dtype=np.uint8).tobytes()
        assert tiff.thunder_plain(src, w, rows) == native.thunder_native(
            src, w, rows)


@pytest.mark.parametrize("seed", range(8))
def test_thunderscan_equals_pillow(seed):
    """Gray, WhiteIsZero and palette 4-bit ThunderScan strips, clean and
    with a byte changed (runs after odd pixels, deltas that wrap, rows
    that run out or overflow)."""
    rng = np.random.default_rng(seed)
    w, h = int(rng.integers(1, 40)), int(rng.integers(1, 20))
    px = rng.integers(0, 16, (h, w))
    if seed % 2:
        px = np.repeat(px[:, ::4], 4, axis=1)[:, :w]
    photo = (1, 0, 3)[seed % 3]
    kw = {"colormap": np.arange(48) * 1300 % 65536} if photo == 3 else {}
    data = C.write_tiff(px[..., None], 4, photo, compression=32809,
                        rows_per_strip=int(rng.integers(1, h + 1)), **kw)
    C.assert_like_pillow(data, f"thunder{seed}")
    if seed >= 4:
        b = bytearray(data)
        b[8 + int(rng.integers(0, 6))] ^= 0x41
        C.assert_as_pillow(bytes(b), f"thunder{seed}")


@pytest.mark.parametrize("case", ["tiles", "eight_bits"])
def test_thunderscan_libtiff_refuses(case):
    px = GRAY >> 4
    data = C.write_tiff(px, 4, 1, compression=32809, tile=(16, 16)) if (
        case == "tiles") else C.write_tiff(GRAY, 8, 1, compression=32809)
    assert C.pillow_refuses(data)
    C.assert_refused(data, "t.tif", ValueError)


@pytest.mark.parametrize("parity", [0, 1])
@pytest.mark.parametrize("offset_odd", [False, True])
def test_rlew_equals_pillow(parity, offset_odd):
    """RLEW rows padded to 16 bits of memory: the strip at an even or odd
    file offset, padded for either."""
    bits = (GRAY[..., 0] > 100).astype(np.uint8)
    strips = [C.rlew_encode(bits[y:y + 5], parity) for y in range(0, 17, 5)]
    body = bytearray(b"II*\0\0\0\0\0" + (b"\0" if offset_odd else b""))
    offsets = []
    for part in strips:
        offsets.append(len(body))
        body += part
    data = C._tiff_with_body(bytes(body), {
        256: (4, [33]), 257: (4, [17]), 258: (3, [1]), 259: (3, [32771]),
        262: (3, [0]), 273: (4, offsets), 278: (4, [5]),
        279: (4, [len(p) for p in strips])})
    C.assert_as_pillow(data)


def test_rlew_loops_in_cxx_equal_python():
    rng = np.random.default_rng(67)
    for i in range(200):
        w, rows = int(rng.integers(1, 70)), int(rng.integers(1, 6))
        bits = (rng.random((rows, w)) < 0.3).astype(np.uint8)
        src = C.rlew_encode(bits, i % 2)
        if i % 3 == 0:
            src = bytes(x ^ int(rng.integers(0, 2)) << int(rng.integers(8))
                        for x in src)
        runs_a = fax.fax_runs(32771, w)
        runs_b = fax.fax_runs(32771, w)
        a = fax.fax_plain(src, 32771, w, rows, i % 2, runs_a)
        b = native.fax_native(src, 32771, w, rows, i % 2, runs_b)
        np.testing.assert_array_equal(a[0], b[0])
        assert a[1] == b[1]
        np.testing.assert_array_equal(runs_a, runs_b)


# --- signed samples, separate planes, refused codecs ---------------------------

@pytest.mark.parametrize("compression,predictor", [
    (5, 1), (5, 2), (8, 1), (8, 2), (32773, 1), (50000, 1), (50000, 2)])
def test_big_endian_signed_16bit_equals_pillow(compression, predictor):
    """libtiff hands Pillow host-order samples, which it reads as big-endian:
    each value byte-swapped (then clipped to 0-255)."""
    v = (GRAY.astype(np.int64) - 120) * 97
    C.assert_like_pillow(C.write_tiff(v, 16, 1, compression=compression,
                                      order=">", sample_format=2,
                                      predictor=predictor))


PLANES = {
    "rgb16": (lambda: C.sample_image(21, 13, 70, 3).astype(np.uint16) * 257,
              16, 2, ()),
    "rgba16_associated": (lambda: C.sample_image(21, 13, 71).astype(
        np.uint16) * 257, 16, 2, (1,)),
    "cmyk16": (lambda: C.sample_image(21, 13, 72).astype(np.uint16) * 251,
               16, 5, ()),
    "la": (lambda: C.sample_image(21, 13, 73, 2), 8, 1, (2,)),
    "lab": (lambda: C.sample_image(21, 13, 74, 3), 8, 8, ()),
    "rgb_jpeg": (lambda: C.sample_image(24, 16, 75, 3), 8, 2, ()),
    "rgba_jpeg": (lambda: C.sample_image(24, 16, 76), 8, 2, (2,)),
}


@pytest.mark.parametrize("case", sorted(PLANES))
@pytest.mark.parametrize("tiles", [False, True])
def test_separate_planes_equal_pillow(case, tiles):
    """Compressed separate planes as Pillow's libtiff reader copies them
    (plane k to byte k of a 4-byte pixel): 16-bit RGB(A) and CMYK by their
    high bytes, LA losing its alpha, LAB unflipped with alpha 0, JPEG a
    component a stream."""
    make, bits, photo, extra = PLANES[case]
    comp = 7 if case.endswith("jpeg") else {0: 5, 1: 8}[len(case) % 2]
    C.assert_like_pillow(C.write_tiff(
        make(), bits, photo, compression=comp, planar=2, extra=extra,
        tile=(16, 16) if tiles else None, rows_per_strip=5), case)


@pytest.mark.parametrize("case", ["rgbx_planes", "rgb4_planes",
                                  "ycbcr_jpeg_planes", "webp", "sgilog",
                                  "sgilog24", "sgilog_logl"])
def test_what_pillow_refuses_raises_value_error(case):
    """More planes than the mode has bands, 4-bit planes, JPEG-compressed
    YCbCr planes; WebP-in-TIFF and SGILog, which Pillow fails to load."""
    rgb = C.sample_image(16, 16, 77, 4)
    data = {
        "rgbx_planes": lambda: C.write_tiff(rgb, 8, 2, compression=5,
                                            planar=2, extra=(0,)),
        "rgb4_planes": lambda: C.write_tiff(rgb[..., :3] >> 4, 4, 2,
                                            compression=5, planar=2),
        "ycbcr_jpeg_planes": lambda: C.write_tiff(
            C.rgb_to_ycbcr(rgb[..., :3]), 8, 6, compression=7, planar=2),
        "webp": lambda: C.write_tiff(rgb[..., :3], 8, 2,
                                     tags={259: (3, [50001])}),
        "sgilog": lambda: C.write_tiff(rgb[..., :3], 8, 2,
                                       tags={259: (3, [34676])}),
        "sgilog24": lambda: C.write_tiff(rgb[..., :3], 8, 2,
                                         tags={259: (3, [34677])}),
        "sgilog_logl": lambda: C.write_tiff(rgb[..., :1], 8, 32844,
                                            tags={259: (3, [34676])}),
    }[case]()
    assert C.pillow_refuses(data)
    C.assert_refused(data, "r.tif", ValueError)


# --- the three repairs of the fuzz's differences --------------------------------

def jpeg_past_its_scan(seed: int, big: bool = False, restart: int = 0,
                       gray: bool = False) -> tuple[bytes, int]:
    """A JPEG whose entropy-coded data runs on past the scan with junk and
    no EOI, and the shortest cut of it Pillow reads: (the file, that
    length)."""
    rng = np.random.default_rng(seed)
    w, h = (640, 400) if big else (int(rng.integers(8, 90)),
                                   int(rng.integers(8, 70)))
    img = C.sample_image(w, h, seed, 3)
    if big:
        img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    kw = {"quality": 92 if big else 75, "subsampling": seed % 3}
    if restart:
        kw["restart_marker_blocks"] = restart
    data = C.pillow_bytes(img[..., 0] if gray else img, "JPEG", **kw)[:-2]
    data += bytes(rng.integers(0, 255, 40, dtype=np.uint8))
    sos = data.index(b"\xff\xda")
    lo, hi = sos + 14, len(data)
    while lo < hi:
        mid = (lo + hi) // 2
        if C.pillow_refuses(data[:mid]):
            lo = mid + 1
        else:
            hi = mid
    return data, lo


@pytest.mark.parametrize("seed,big,restart,gray", [
    (1, False, 0, False), (2, False, 0, False), (3, False, 0, True),
    (4, False, 2, False), (5, False, 1, True), (6, True, 0, False),
    (7, True, 3, False), (8, False, 0, False)])
def test_jpeg_scan_to_the_end_of_the_file_as_libjpeg_reads_it(
        seed, big, restart, gray):
    """A single-scan JPEG whose data runs to the end of the file with no
    marker: read where libjpeg-turbo never refills its bit buffer past the
    last byte (57 bits at a time; the fast path's 6 bytes while 512 bytes a
    block remain; Pillow's 64 KiB blocks), refused a byte shorter."""
    data, k = jpeg_past_its_scan(seed, big, restart, gray)
    for cut in (k - 2, k - 1, k, k + 1, len(data)):
        C.assert_as_pillow(data[:cut], f"cut{cut}")
    C.assert_like_pillow(data[:k])
    assert C.pillow_refuses(data[:k - 1])


@pytest.mark.parametrize("seed", range(6))
def test_reads_whole_in_cxx_equals_python(seed, monkeypatch):
    """The refill model (``huffman_reads_whole``) and its C++ twin agree on
    every cut near the end of a scan, fast path and slow: the arguments
    taken from the reader's own call on the shortest readable cut."""
    data, k = jpeg_past_its_scan(20 + seed, restart=seed % 3)
    seen = []
    monkeypatch.setattr(native, "jpeg_reads_whole_native",
                        lambda *a: seen.append(a) or True)
    C.decode_in(True, data[:k])
    (_, start, _, _, mcus, units, fast), = seen
    monkeypatch.undo()
    for cut in range(max(start, k - 60), len(data) + 1, 3):
        ends, marker = jpeg.interval_bytes(data[:cut], start)
        args = (data[:cut], start, ends, marker, mcus, units, fast)
        assert jpeg.huffman_reads_whole(*args) == \
            native.jpeg_reads_whole_native(*args)


@pytest.mark.parametrize("seed", range(4))
def test_arithmetic_scan_to_the_end_of_the_file(seed):
    """jdarith.c cannot suspend: a scan to the end of the file is read
    only where its decoder never fetches a byte past it."""
    rng = np.random.default_rng(seed)
    planes = J.sample_planes(int(rng.integers(5, 50)),
                             int(rng.integers(5, 50)), 3, seed)
    data = J.write_jpeg(planes, [(2, 2), (1, 1), (1, 1)], arithmetic=True,
                        restart=seed % 2 * 3)[:-2]
    data += bytes(rng.integers(0, 255, 12, dtype=np.uint8))
    for cut in range(len(data) - 20, len(data) + 1):
        C.assert_as_pillow(data[:cut], f"arith{cut}")


def test_progressive_scan_to_the_end_of_the_file_is_refused():
    data = C.pillow_bytes(RGB, "JPEG", progressive=True)[:-2] + bytes(64)
    assert C.pillow_refuses(data)
    C.assert_refused(data, "p.jpg", ValueError)


def test_fuzz_tiff_jpeg_seed_1_marker_after_the_scan():
    """``--kind tiff_jpeg --seed 1``: a JPEG-in-TIFF tile whose stream has a
    marker libjpeg refuses after its scan. libtiff reports the error after
    the rows were read, and Pillow keeps them; so does the port. The same
    stream alone is refused (Pillow's JPEG reader fails on it)."""
    rgb = C.sample_image(38, 16, 81, 3)
    data = bytearray(C.write_tiff(rgb, 8, 2, compression=7, tile=(16, 16),
                                  jpeg={"tables": False}))
    eoi = data.index(b"\xff\xd9")
    data[eoi + 1] = 0x15  # the first tile's EOI made marker FF 15
    C.assert_like_pillow(bytes(data), "tile")
    stream = bytes(data[8:eoi + 2])
    assert C.pillow_refuses(stream)
    C.assert_refused(stream, "s.jpg", ValueError)


def j2k_with(segment: bytes) -> bytes:
    """The committed reversible J2K with ``segment`` put before its first
    tile-part."""
    data = fixture("j2k_cblk_all_styles_rev.j2k")
    pos = 2
    while True:
        m, n = struct.unpack(">HH", data[pos:pos + 4])
        if m == 0xFF90:
            return data[:pos] + segment + data[pos:]
        pos += 2 + n


def part2(marker: int, body: bytes) -> bytes:
    return struct.pack(">HH", marker, len(body) + 2) + body


J2K_PART2 = {
    "mct_many_records": part2(0xFF74, b"\x00\x01Created by OpenJPEG"),
    "mct_record": part2(0xFF74, b"\x00\x00" + struct.pack(">H", 0x0107)
                        + b"\x00\x00" + struct.pack(">3H", 9, 2, 300)),
    "mco_no_stage": part2(0xFF77, b"\x00"),
    "mco_one_unknown_stage": part2(0xFF77, b"\x01\x05"),
    "mco_many_stages": part2(0xFF77, b"\x02\x01\x02"),
    "mct_mcc_mco_offsets": part2(0xFF74, b"\x00\x00" + struct.pack(
        ">H", 0x0107) + b"\x00\x00" + struct.pack(">3H", 9, 2, 300))
    + part2(0xFF75, b"\x00\x00\x09\x00\x00\x00\x01\x01\x00\x03\x00\x01\x02"
            b"\x00\x03\x00\x01\x02\x00\x07\x00") + part2(0xFF77, b"\x01\x09"),
    "cbd_same_depths": part2(0xFF78, b"\x00\x03\x07\x07\x07"),
    "mct_short": part2(0xFF74, b"\x00"),
    "mct_no_data": part2(0xFF74, b"\x00\x00\x00\x01\x00"),
    "mcc_short": part2(0xFF75, b"\x00\x00\x01"),
    "mcc_unknown_mct": part2(0xFF75, b"\x00\x00\x09\x00\x00\x00\x01\x01\x00"
                             b"\x03\x00\x01\x02\x00\x03\x00\x01\x02\x00\x00"
                             b"\x04"),
    "mco_wrong_length": part2(0xFF77, b"\x01\x01\x02"),
    "cbd_wrong_count": part2(0xFF78, b"\x00\x02\x07\x07\x07"),
}


@pytest.mark.parametrize("case", sorted(J2K_PART2))
def test_j2k_part2_markers_as_openjpeg_reads_them(case):
    """``--kind j2k --seed 17`` found a COM marker turned into MCT, which
    OpenJPEG passes over with a warning. OpenJPEG's checks on MCT, MCC, MCO
    and CBD, the records it ignores, and an MCO's level shifts (0, or an
    MCC's offsets) are copied; what it refuses is refused."""
    C.assert_as_pillow(j2k_with(J2K_PART2[case]), case)


def test_j2k_cbd_changing_depths_raises_not_implemented():
    data = j2k_with(part2(0xFF78, b"\x00\x03\x05\x05\x05"))
    assert not C.pillow_refuses(data)
    C.assert_refused(data, "c.j2k", NotImplementedError)
