"""The port's PCX, DCX (``utils/pcx.py``) and SGI (``utils/sgi.py``)
readers against Pillow 12.1.0, which the JAX package reads LDR images
with.

Every case is held array-equal to ``Image.open(...).convert("RGBA")`` and
decoded twice: with the C++ run-length loops (``accel/cbvh/
image_scan.cpp``'s ``wpt_pcx_rle`` and ``wpt_sgi_rle``) and with their
plain Python versions. Pillow writes PCX in modes 1, L, P and RGB and SGI
in L, RGB and RGBA at 8 and 16 bits, raw and RLE;
``tests/torch_image_cases.py`` writes the rest: 1-bit images on 2 and 4
planes, strides the header gives wrong, gray ramp and palette trailers,
DCX directories, SGI rows that share their data or come in any order,
1-D images, 16-bit RLE.
"""

import json
import struct

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from chip_smoke import with_sidecar_images
from wgpu_path_tracing_tpu.models import gltf as JG
from wgpu_path_tracing_tpu.ops import env as JENV
from wgpu_path_tracing_tpu_torch import scene_to_glb, textured_cornell
from wgpu_path_tracing_tpu_torch.accel import native
from wgpu_path_tracing_tpu_torch.models import gltf as G
from wgpu_path_tracing_tpu_torch.ops import env as ENV
from wgpu_path_tracing_tpu_torch.utils import image as IMAGE
from wgpu_path_tracing_tpu_torch.utils import pcx, sgi
from tests import torch_image_cases as C

torch.set_num_threads(1)

FIXTURES = np.load(f"{C.LDR_DIR}/pillow_rgba.npz")
FILES = sorted(n for n in FIXTURES.files
               if n.endswith((".pcx", ".dcx", ".sgi")))
GRAY_RAMP = b"\x0c" + np.repeat(np.arange(256, dtype=np.uint8), 3).tobytes()


def fixture(name: str) -> bytes:
    with open(f"{C.LDR_DIR}/{name}", "rb") as f:
        return f.read()


@pytest.mark.parametrize("name", FILES)
def test_committed_pcx_dcx_sgi_files_equal_pillow(name):
    np.testing.assert_array_equal(C.assert_like_pillow(fixture(name), name),
                                  FIXTURES[name])


def like_pillow_or_refused(data: bytes) -> None:
    """Pillow's array both ways, or, where Pillow raises, an error both
    ways naming the file."""
    if C.pillow_refuses(data):
        C.assert_refused(data, "w.pcx")
    else:
        C.assert_like_pillow(data)


@pytest.mark.parametrize("mode", ["1", "L", "P", "RGB"])
@pytest.mark.parametrize("w", [1, 7, 23, 24])
def test_pillow_written_pcx_equals_pillow(mode, w):
    """Pillow's writer in each mode; a one-pixel-wide RGB file, whose rows
    Pillow's writer cuts short, Pillow cannot read, and the port raises."""
    img = Image.fromarray(C.sample_image(w, 9, w)).convert(mode)
    data = C.pillow_bytes(img, "PCX")
    assert C.pillow_refuses(data) == (mode == "RGB" and w == 1)
    like_pillow_or_refused(data)


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA"])
@pytest.mark.parametrize("bpc", [1, 2])
@pytest.mark.parametrize("rle", [False, True], ids=["raw", "rle"])
def test_pillow_written_sgi_equals_pillow(mode, bpc, rle):
    img = Image.fromarray(C.sample_image(23, 14, 3)).convert(mode)
    kw = {"compression": "rle"} if rle else {}
    C.assert_like_pillow(C.pillow_bytes(img, "SGI", bpc=bpc, **kw))


IDX16 = C.sample_image(21, 6, 4, 1)[..., 0] >> 4
PAL16 = C.sample_image(16, 1, 5, 3)[0].tobytes()
RGB13 = C.sample_image(13, 5, 6, 3)


def rgb_rows(img, stride):
    return np.concatenate([np.pad(img[..., c], ((0, 0), (0, stride - img.shape[
        1]))) for c in range(3)], 1)


PCX_VARIANTS = {
    "p4l_odd_header_stride": lambda: C.write_pcx(
        C.pcx_planes(IDX16, 4, 4), 21, 1, 4, palette16=PAL16, stride=5),
    "p4l_exact_stride": lambda: C.write_pcx(
        C.pcx_planes(IDX16, 4, 3), 21, 1, 4, palette16=PAL16),
    "p2l_narrow_padded_planes": lambda: C.write_pcx(
        C.pcx_planes(IDX16[:, :3] & 3, 2, 2), 3, 1, 2, palette16=PAL16,
        stride=0),
    "rgb_header_stride_odd": lambda: C.write_pcx(
        rgb_rows(RGB13, 14), 13, 8, 3, stride=13),
    "rgb_header_stride_wrong": lambda: C.write_pcx(
        rgb_rows(RGB13, 14), 13, 8, 3, stride=20),
    "gray_ramp_trailer_is_gray": lambda: C.write_pcx(
        IDX16 * 16, 21, 8, 1, trailer=GRAY_RAMP),
    "palette_trailer": lambda: C.write_pcx(
        IDX16 * 3, 21, 8, 1, trailer=b"\x0c" + C.sample_image(
            256, 1, 7, 3).tobytes()),
    "trailer_without_its_mark": lambda: C.write_pcx(
        IDX16 * 3, 21, 8, 1, trailer=b"\x0b" + C.sample_image(
            256, 1, 7, 3).tobytes()),
    "box_not_at_the_origin": lambda: C.write_pcx(
        np.packbits(IDX16 > 7, axis=1), 21, 1, 1, origin=(5, 9)),
    "dcx_first_page_of_three": lambda: C.write_dcx(
        [C.pillow_bytes(Image.fromarray(RGB13), "PCX")] * 2 + [b"x"]),
    "dcx_first_page_planar": lambda: C.write_dcx(
        [C.write_pcx(C.pcx_planes(IDX16, 4, 3), 21, 1, 4, palette16=PAL16)]),
}


@pytest.mark.parametrize("case", sorted(PCX_VARIANTS))
def test_written_pcx_variants_equal_pillow(case):
    """1-bit images on 2 and 4 planes through the header palette; strides
    the header gives otherwise (Pillow rounds its own to even then, and
    moves the planes to where its unpackers read them); a gray-ramp
    trailer keeps an 8-bit image gray, another makes it a palette one, a
    trailer without its 0x0C mark is no palette; a box off the origin; a
    DCX file's first page."""
    C.assert_like_pillow(PCX_VARIANTS[case]())


RGBA = C.sample_image(15, 9, 8)
SGI_VARIANTS = {
    "rgba_rle_shared_rows": lambda: C.write_sgi(
        np.repeat(RGBA[:3], 3, 0), 1, True, share_rows=True),
    "rgb_rle_rows_reversed": lambda: C.write_sgi(RGBA[..., :3], 1, True,
                                                 reverse_rows=True),
    "gray16_rle": lambda: C.write_sgi(
        RGBA[..., :1].astype(np.uint16) * 257 + 3, 2, True),
    "rgba16_rle": lambda: C.write_sgi(RGBA.astype(np.uint16) * 251, 2, True),
    "gray_dimension_1": lambda: C.write_sgi(RGBA[:1, :, :1], 1, False,
                                            dimension=1),
    "gray16_dimension_1_rle": lambda: C.write_sgi(
        RGBA[:1, :, :1].astype(np.uint16) << 8, 2, True, dimension=1),
    "long_runs": lambda: C.write_sgi(np.repeat(RGBA[:, :1], 300, 1), 1,
                                     True),
}


def unterminated_chain() -> bytes:
    """An RLE file whose second row's chain has no 0 count within its
    length: Pillow stops there without an error, later rows black."""
    data = bytearray(C.write_sgi(RGBA[..., :1], 1, True))
    h = RGBA.shape[0]
    starts = struct.unpack_from(f">{h}I", data, 512)
    lengths = list(struct.unpack_from(f">{h}I", data, 512 + 4 * h))
    lengths[1] -= 1  # the 0 count now lies past the row's length
    struct.pack_into(f">{h}I", data, 512 + 4 * h, *lengths)
    assert data[starts[1] + lengths[1]] == 0
    return bytes(data)


def negative_length() -> bytes:
    """A row length of 2^31 or more, a negative int to Pillow: that row
    decodes nothing and keeps the row buffer's last contents."""
    data = bytearray(C.write_sgi(RGBA[..., :3], 1, True))
    h = RGBA.shape[0]
    struct.pack_into(">I", data, 512 + 4 * (3 * h + 2), 0xFFFFFFF0)
    return bytes(data)


SGI_VARIANTS["unterminated_chain"] = unterminated_chain
SGI_VARIANTS["negative_row_length"] = negative_length


@pytest.mark.parametrize("case", sorted(SGI_VARIANTS))
def test_written_sgi_variants_equal_pillow(case):
    """RLE rows sharing their data, stored out of order; 16-bit RLE words;
    1-D gray images; runs of more than 127; a chain whose 0 count lies
    past its row's length; a row length Pillow reads as negative."""
    C.assert_like_pillow(SGI_VARIANTS[case]())


def pcx_header(bits, planes, version=5, w=4, h=2):
    return C.write_pcx(np.zeros((h, planes * ((w * bits + 7) // 8)),
                                np.uint8), w, bits, planes, version=version)


def sgi_header(bpc=1, dim=2, z=1, compression=0, w=3, h=2):
    return struct.pack(">HBBHHHH", 474, compression, bpc, dim, w, h, z).ljust(
        512, b"\0")


REFUSED = {
    "pcx_unknown_mode_8bit_4planes": pcx_header(8, 4),
    "pcx_unknown_mode_2bit": pcx_header(2, 1),
    "pcx_8bit_version_3": pcx_header(8, 1, version=3),
    "pcx_run_across_rows": C.write_pcx(np.zeros((2, 4), np.uint8), 4, 8, 1,
                                       data=b"\xc6\x07\xc2\x07"),
    "pcx_rle_cut_short": C.write_pcx(np.zeros((2, 4), np.uint8), 4, 8, 1,
                                     data=b"\xc4\x07\xc3"),
    "pcx_header_cut_short": pcx_header(8, 1)[:60],
    "dcx_without_pages": struct.pack("<II", 0x3ADE68B1, 0) + pcx_header(8, 1),
    "dcx_page_past_the_end": struct.pack("<III", 0x3ADE68B1, 999, 0),
    "sgi_unknown_mode": sgi_header(z=2),
    "sgi_3_bytes_a_sample": sgi_header(bpc=3),
    "sgi_compression_2": sgi_header(compression=2) + bytes(6),
    "sgi_raw_cut_short": sgi_header() + bytes(5),
    "sgi_raw16_cut_short": sgi_header(bpc=2) + bytes(11),
    "sgi_tables_past_the_end": sgi_header(compression=1) + bytes(15),
    "sgi_row_in_the_header": sgi_header(compression=1) + struct.pack(
        ">4I", 100, 100, 2, 2) + b"\x82\x01\x02\x00",
    "sgi_row_past_its_width": sgi_header(compression=1, h=1) + struct.pack(
        ">2I", 520, 3) + b"\x05\x07\x00",
    "sgi_header_cut_short": sgi_header()[:10],
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_what_pillow_refuses_raises_naming_the_image(case):
    data = REFUSED[case]
    assert C.pillow_refuses(data)
    C.assert_refused(data, "r.img")


def pcx_streams():
    rng = np.random.default_rng(7)
    out = []
    for _ in range(300):
        row, rows = int(rng.integers(1, 12)), int(rng.integers(1, 5))
        body = bytearray()
        while len(body) < 2 * row * rows:
            if rng.random() < 0.4:
                body += bytes([0xC0 | int(rng.integers(0, 8)),
                               int(rng.integers(0, 256))])
            else:
                body.append(int(rng.integers(0, 0xC0)))
        out.append((bytes(body[:int(rng.integers(0, len(body) + 1))]), 0,
                    row, rows))
    return out


def test_pcx_rle_in_cxx_equals_python():
    statuses = set()
    for data, pos, row, rows in pcx_streams():
        got, status = native.pcx_rle_native(data, pos, row, rows)
        want, want_status = pcx.rle_plain(data, pos, row, rows)
        assert status == want_status
        np.testing.assert_array_equal(got, want)
        statuses.add(status)
    assert statuses == {0, 1, 2}


def sgi_files():
    """RLE files with random tables and packets (16-bit too)."""
    rng = np.random.default_rng(8)
    out = []
    for _ in range(300):
        w, h = int(rng.integers(1, 8)), int(rng.integers(1, 5))
        z, bpc = int(rng.choice([1, 3, 4])), int(rng.choice([1, 2]))
        body = rng.integers(0, 256, int(rng.integers(0, 40 * h * z)),
                            dtype=np.uint8)
        counts = rng.random(len(body)) < 0.3
        body[counts] = rng.integers(0, 8, counts.sum()) | np.where(
            rng.random(counts.sum()) < 0.5, 0x80, 0)
        end = 512 + 8 * z * h + len(body)
        tables = np.concatenate([rng.integers(400, end + 3, z * h),
                                 rng.integers(0, 12, z * h)]).astype(">u4")
        data = sgi_header(bpc, 3, z, 1, w, h) + tables.tobytes() + \
            body.tobytes()
        out.append((data[:int(rng.integers(500, len(data) + 1))], w, h, z,
                    bpc))
    return out


def test_sgi_rle_in_cxx_equals_python():
    statuses = set()
    for data, w, h, z, bpc in sgi_files():
        got, status = native.sgi_rle_native(data, w, h, z, bpc)
        want, want_status = sgi.rle_plain(data, w, h, z, bpc)
        assert status == want_status
        np.testing.assert_array_equal(got, want)
        statuses.add(status)
    assert statuses == {0, 1, 2}


@settings(max_examples=30, deadline=None)
@given(w=st.integers(1, 40), h=st.integers(1, 20),
       mode=st.sampled_from(["1", "L", "P", "RGB"]),
       seed=st.integers(0, 2 ** 16))
def test_hypothesis_pillow_pcx(w, h, mode, seed):
    img = Image.fromarray(C.sample_image(w, h, seed)).convert(mode)
    like_pillow_or_refused(C.pillow_bytes(img, "PCX"))


@settings(max_examples=30, deadline=None)
@given(w=st.integers(1, 40), h=st.integers(1, 20),
       mode=st.sampled_from(["L", "RGB", "RGBA"]), bpc=st.sampled_from([1, 2]),
       rle=st.booleans(), seed=st.integers(0, 2 ** 16))
def test_hypothesis_pillow_sgi(w, h, mode, bpc, rle, seed):
    img = Image.fromarray(C.sample_image(w, h, seed)).convert(mode)
    kw = {"compression": "rle"} if rle else {}
    C.assert_like_pillow(C.pillow_bytes(img, "SGI", bpc=bpc, **kw))


@pytest.mark.parametrize("name", ["pillow_rgb.pcx", "env_rle.sgi"])
def test_a_failed_native_build_raises(monkeypatch, name):
    def fail(cxx=None):
        raise RuntimeError("g++ failed to build the native library")

    monkeypatch.setattr(native._Lib, "handle", None)
    monkeypatch.setattr(native, "build", fail)
    monkeypatch.setattr(native, "native_available", lambda: True)
    with pytest.raises(RuntimeError, match="failed to build"):
        IMAGE.decode_image_rgba(fixture(name), name)


@pytest.mark.parametrize("name", ["pillow_rgb.pcx", "pages.dcx",
                                  "env_rle.sgi", "rgba16_raw.sgi"])
def test_pcx_dcx_sgi_env_map_equals_jax(name, tmp_path):
    path = str(tmp_path / "sky.png")
    with open(path, "wb") as f:
        f.write(fixture(name))
    np.testing.assert_array_equal(ENV.load_env_image(path),
                                  JENV.load_env_image(path))


SIDECARS = ("pillow_rgb.pcx", "planes4_p4l.pcx", "pages.dcx", "rgb16_rle.sgi")


@pytest.mark.parametrize("ratio", [0.5, 1.0])
def test_pcx_dcx_sgi_sidecars_build_the_jax_atlas(ratio, tmp_path):
    for name in SIDECARS:
        (tmp_path / name).write_bytes(fixture(name))
    path = tmp_path / "textured.gltf"
    path.write_text(with_sidecar_images(scene_to_glb(textured_cornell()),
                                        list(SIDECARS)))
    assert len(json.loads(path.read_text())["images"]) == 4
    got, got_rects = G.build_atlas(G.GLTFFile.load(str(path)), ratio)
    want, want_rects = JG.build_atlas(JG.GLTFFile.load(str(path)), ratio)
    np.testing.assert_array_equal(got, want)
    assert got_rects == want_rects
