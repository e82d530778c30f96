"""The port's GIMP brush (``utils/gbr.py``), XV thumbnail
(``utils/xvthumb.py``), PIXAR (``utils/pixar.py``), IM Tools
(``utils/imt.py``), IPTC/NAA (``utils/iptc.py``), Kodak Photo CD
(``utils/pcd.py``) and FLI/FLC (``utils/fli.py``) readers, and the WMF
and EPS stubs (``utils/stubs.py``), against Pillow 12.1.0, which the JAX
package reads LDR images with.

Every case is held array-equal to ``Image.open(...).convert("RGBA")`` (or
refused where Pillow refuses) and decoded twice, with the C++ loops
(``accel/cbvh/image_scan.cpp``'s ``wpt_fli``) and with their plain
Python versions. Pillow writes none of these formats;
``tests/torch_image_cases.py`` writes them. Pillow's C ``pcd`` and
``fli`` decoders were found black-box: the Photo CD's PhotoYCC tables
read out of Pillow by ``tools/pillow_ycc.py``, the FLI chunk rules by
these cases and ``tools/ldr_fuzz.py --kind fli``. WMF and EPS open in
Pillow and fail to load on a host without a WMF handler or Ghostscript;
the port refuses them.
"""

import hashlib
import json
import struct

import numpy as np
import pytest
import torch

from chip_smoke import SCI_RARE_TEXTURES, with_sidecar_images
from wgpu_path_tracing_tpu.models import gltf as JG
from wgpu_path_tracing_tpu.ops import env as JENV
from wgpu_path_tracing_tpu.utils import image as JIMAGE
from wgpu_path_tracing_tpu_torch import scene_to_glb, textured_cornell
from wgpu_path_tracing_tpu_torch.accel import native
from wgpu_path_tracing_tpu_torch.models import gltf as G
from wgpu_path_tracing_tpu_torch.ops import env as ENV
from wgpu_path_tracing_tpu_torch.utils import fli, pcd, sniff
from wgpu_path_tracing_tpu_torch.utils import image as IMAGE
from tests import torch_image_cases as C

torch.set_num_threads(1)

FIXTURES = np.load(f"{C.LDR_DIR}/pillow_rgba.npz")
FILES = sorted(n for n in FIXTURES.files
               if n.endswith((".gbr", ".xv", ".pxr", ".imt", ".iim", ".fli",
                              ".flc")))
RGBA = C.sample_image(17, 9, 82)
GRAY = RGBA[..., 0]


def fixture(name: str) -> bytes:
    with open(f"{C.LDR_DIR}/{name}", "rb") as f:
        return f.read()



@pytest.mark.parametrize("name", FILES)
def test_committed_files_equal_pillow(name):
    np.testing.assert_array_equal(C.assert_like_pillow(fixture(name), name),
                                  FIXTURES[name])


# --- GIMP brush, XV thumbnail, PIXAR, IM Tools ---------------------------------


def _patched(data: bytes, at: int, value: int, fmt: str = ">I") -> bytes:
    out = bytearray(data)
    struct.pack_into(fmt, out, at, value)
    return bytes(out)


SMALL = {
    "gbr_v1_gray": lambda: C.write_gbr(GRAY, 1),
    "gbr_v2_rgba": lambda: C.write_gbr(RGBA, 2),
    "gbr_v2_no_comment": lambda: C.write_gbr(GRAY, 2, comment=b""),
    "gbr_header_19": lambda: _patched(C.write_gbr(GRAY, 1), 0, 19),
    "gbr_v2_header_24": lambda: _patched(C.write_gbr(GRAY, 2), 0, 24),
    "gbr_version_3": lambda: _patched(C.write_gbr(GRAY, 1), 4, 3),
    "gbr_depth_3": lambda: _patched(C.write_gbr(GRAY, 1), 16, 3),
    "gbr_bad_magic": lambda: C.write_gbr(GRAY, 2).replace(b"GIMP", b"GIMQ"),
    "gbr_cut": lambda: C.write_gbr(RGBA, 2)[:-7],
    "gbr_zero_width": lambda: _patched(C.write_gbr(GRAY, 1), 8, 0),
    "xv_plain": lambda: C.write_xvthumb(GRAY),
    "xv_no_comment": lambda: C.write_xvthumb(GRAY, comments=()),
    "xv_many_comments": lambda: C.write_xvthumb(GRAY, comments=(
        b"#a", b"#b", b"#c")),
    "xv_size_one_number": lambda: C.write_xvthumb(GRAY).replace(
        b"17 9 255", b"17"),
    "xv_size_text": lambda: C.write_xvthumb(GRAY).replace(b"17 9 255",
                                                           b"x y"),
    "xv_no_size_line": lambda: b"P7 332\n#only comments\n",
    "xv_cut": lambda: C.write_xvthumb(GRAY)[:-4],
    "pixar_rgb": lambda: C.write_pixar(RGBA[..., :3]),
    "pixar_other_mode": lambda: C.write_pixar(RGBA[..., :3], mode=(14, 1)),
    "pixar_cut_header": lambda: C.write_pixar(RGBA[..., :3])[:420],
    "pixar_cut_data": lambda: C.write_pixar(RGBA[..., :3])[:-1],
    "imt_plain": lambda: C.write_imt(GRAY),
    "imt_comments": lambda: C.write_imt(GRAY, lines=(b"* one", b"* two")),
    "imt_unknown_field": lambda: C.write_imt(GRAY, lines=(b"depth 8",)),
    "imt_no_pixel": lambda: C.write_imt(GRAY).replace(b"pixel n8\n", b""),
    "imt_bad_number": lambda: C.write_imt(GRAY).replace(b"width 17",
                                                        b"width 1x"),
    "imt_no_form_feed": lambda: C.write_imt(GRAY).replace(b"\x0c", b"\n"),
    "imt_stops_at_empty_line": lambda: C.write_imt(GRAY, lines=(b"",)),
}


@pytest.mark.parametrize("case", sorted(SMALL))
def test_small_formats_as_pillow(case):
    C.assert_as_pillow(SMALL[case](), f"{case}.img")


@pytest.mark.parametrize("shape", [(1, 1), (3, 40), (30, 2)])
@pytest.mark.parametrize("fmt", ["gbr1", "gbr4", "xv", "pixar", "imt"])
def test_small_formats_at_odd_sizes(fmt, shape):
    img = C.sample_image(shape[1], shape[0], 83)
    data = {"gbr1": lambda: C.write_gbr(img[..., 0], 1),
            "gbr4": lambda: C.write_gbr(img, 2),
            "xv": lambda: C.write_xvthumb(img[..., 0]),
            "pixar": lambda: C.write_pixar(img[..., :3]),
            "imt": lambda: C.write_imt(img[..., 0])}[fmt]()
    C.assert_like_pillow(data)


def test_xv_palette_is_3_3_2():
    idx = np.arange(256, dtype=np.uint8).reshape(16, 16)
    got = C.assert_like_pillow(C.write_xvthumb(idx))
    assert got[0, 1, :3].tolist() == [0, 0, 85]
    assert got[15, 15, :3].tolist() == [255, 255, 255]


# --- IPTC -------------------------------------------------------------------


JPEG_GRAY = C.pillow_bytes(GRAY, "JPEG", quality=85)
JPEG_RGB = C.pillow_bytes(RGBA[..., :3], "JPEG", quality=85)
IPTC = {
    "raw": lambda: C.write_iptc(GRAY.tobytes(), 17, 9),
    "raw_split": lambda: C.write_iptc(GRAY.tobytes(), 17, 9, split=40),
    "raw_split_extended_size": lambda: C.write_iptc(GRAY.tobytes(), 17, 9,
                                                    split=40, extended=4),
    "raw_long": lambda: C.write_iptc(GRAY.tobytes() + bytes(9), 17, 9),
    "raw_short": lambda: C.write_iptc(GRAY.tobytes()[:-9], 17, 9),
    "band_1_rgb": lambda: C.write_iptc(GRAY.tobytes(), 17, 9, layers=3,
                                       component=1, band=1),
    "band_3_rgb": lambda: C.write_iptc(GRAY.tobytes(), 17, 9, layers=3,
                                       component=1, band=3),
    "no_band_rgb": lambda: C.write_iptc(GRAY.tobytes(), 17, 9, layers=3,
                                        component=1),
    "band_0_cmyk": lambda: C.write_iptc(GRAY.tobytes(), 17, 9, layers=4,
                                        component=1, band=0),
    "band_2_cmyk": lambda: C.write_iptc(GRAY.tobytes(), 17, 9, layers=4,
                                        component=1, band=2),
    "band_5_cmyk": lambda: C.write_iptc(GRAY.tobytes(), 17, 9, layers=4,
                                        component=1, band=5),
    "jpeg_gray": lambda: C.write_iptc(JPEG_GRAY, 17, 9, compression=5),
    "jpeg_colour_one_layer": lambda: C.write_iptc(JPEG_RGB, 17, 9,
                                                  compression=5),
    "jpeg_gray_band": lambda: C.write_iptc(JPEG_GRAY, 17, 9, layers=3,
                                           component=1, band=2,
                                           compression=5),
    "jpeg_colour_band": lambda: C.write_iptc(JPEG_RGB, 17, 9, layers=3,
                                             component=1, band=2,
                                             compression=5),
    "png_one_layer": lambda: C.write_iptc(C.pillow_bytes(RGBA, "PNG"), 17, 9,
                                          compression=5),
    "compression_2": lambda: C.write_iptc(GRAY.tobytes(), 17, 9,
                                          compression=2),
    "two_layers": lambda: C.write_iptc(GRAY.tobytes(), 17, 9, layers=2),
    "three_layers_no_components": lambda: C.write_iptc(GRAY.tobytes(), 17, 9,
                                                       layers=3),
    "repeated_layers": lambda: C.write_iptc(GRAY.tobytes(), 17, 9,
                                            extra=C.iptc_field(3, 60, b"\1\0")),
    "no_image_data": lambda: C.write_iptc(b"", 17, 9)[:-5],
    "bad_marker": lambda: b"\x1d" + C.write_iptc(GRAY.tobytes(), 17, 9)[1:],
    "bad_record": lambda: C.write_iptc(GRAY.tobytes(), 17, 9).replace(
        b"\x1c\x01\x5a", b"\x1c\x0b\x5a", 1),
    "field_size_133": lambda: b"\x1c\x01\x5a\x85\x00" + bytes(10),
    "cut_header": lambda: b"\x1c\x01\x5a\x00",
    "zero_width": lambda: C.write_iptc(GRAY.tobytes(), 0, 9),
}


@pytest.mark.parametrize("case", sorted(IPTC))
def test_iptc_as_pillow(case):
    C.assert_as_pillow(IPTC[case](), f"{case}.iim")


# --- Photo CD -----------------------------------------------------------------


@pytest.mark.parametrize("orientation", [0, 1, 2, 3, 5, 0x83])
def test_photo_cd_every_orientation_equals_pillow(orientation):
    """The base image through Pillow's PhotoYCC tables; orientations 1 and
    3 (the low two bits) rotate it."""
    got = C.assert_like_pillow(C.photo_cd(orientation))
    assert got.shape == ((768, 512, 4) if orientation & 3 in (1, 3)
                         else (512, 768, 4))


@pytest.mark.parametrize("k", [0, 1])
def test_photo_cd_equals_pillows_digest(k):
    """``chip_smoke.py``'s Photo CD files decode to the arrays whose
    SHA-256 Pillow gave (``pillow_sha256.json``)."""
    with open(f"{C.LDR_DIR}/pillow_sha256.json") as f:
        want = json.load(f)[C.PCD_FILES[k]]
    got = IMAGE.decode_image_rgba(C.photo_cd(k), C.PCD_FILES[k])
    assert hashlib.sha256(got.tobytes()).hexdigest() == want


@pytest.mark.parametrize("case", ["cut_data", "cut_header", "not_pcd",
                                  "pcd_other_suffix"])
def test_photo_cd_refusals_as_pillow(case):
    data = C.photo_cd(0)
    data = {"cut_data": data[:-1], "cut_header": data[:2048 + 1000],
            "not_pcd": data[:2048] + b"PCX_" + data[2052:],
            "pcd_other_suffix": data[:2052] + b"XYZ" + data[2055:]}[case]
    C.assert_as_pillow(data)


def test_photoycc_tables_equal_pillow():
    """``pcd.ycc_to_rgb`` against Pillow on random blocks (``tools/
    pillow_ycc.py --check`` covers all 2^24 inputs)."""
    rng = np.random.default_rng(4)
    y = rng.integers(0, 256, (512, 768))
    cb = rng.integers(0, 256, (256, 384))
    cr = rng.integers(0, 256, (256, 384))
    want = C.pillow_rgba(C.write_pcd(y, cb, cr))
    up = lambda c: np.repeat(np.repeat(c, 2, 0), 2, 1)  # noqa: E731
    np.testing.assert_array_equal(
        pcd.ycc_to_rgb(y, up(cb), up(cr)), want[..., :3])


# --- FLI ----------------------------------------------------------------------


IDX = C.sample_image(22, 11, 84, 1)[..., 0]
LATER = IDX.copy()
LATER[2:6, 3:15] = 5
LATER[9] = 240
PAL = C.sample_image(256, 1, 85, 3)[0]
FLI = {
    "brun": lambda: C.write_fli(22, 11, [C.fli_colors(PAL), C.fli_brun(IDX)]),
    "brun_fli_colour64": lambda: C.write_fli(22, 11, [
        C.fli_colors(PAL, 11), C.fli_brun(IDX)], magic=0xAF11),
    "palette_skip": lambda: C.write_fli(22, 11, [
        C.fli_colors(PAL[:100], skip=50), C.fli_brun(IDX)]),
    "palette_past_256": lambda: C.write_fli(22, 11, [
        C.fli_colors(PAL[:200], skip=100), C.fli_brun(IDX)]),
    "no_palette": lambda: C.write_fli(22, 11, [C.fli_brun(IDX)]),
    "lc": lambda: C.write_fli(22, 11, [C.fli_brun(IDX),
                                       C.fli_lc(LATER, IDX, 2)]),
    "lc_alone": lambda: C.write_fli(22, 11, [C.fli_lc(LATER, IDX * 0)]),
    "ss2": lambda: C.write_fli(22, 11, [C.fli_brun(IDX),
                                        C.fli_ss2(LATER, IDX)]),
    "ss2_no_skips": lambda: C.write_fli(22, 11, [
        C.fli_brun(IDX), C.fli_ss2(LATER, IDX, skip_lines=False)]),
    "copy": lambda: C.write_fli(22, 11, [C.fli_chunk(16, IDX.tobytes())]),
    "copy_short": lambda: C.write_fli(22, 11, [C.fli_chunk(
        16, IDX.tobytes()[:-5])]),
    "black_last_short": lambda: C.write_fli(22, 11, [
        C.fli_brun(IDX), C.fli_chunk(13, b"")]),
    "black": lambda: C.write_fli(22, 11, [C.fli_brun(IDX),
                                          C.fli_chunk(13, bytes(4))]),
    "stamp": lambda: C.write_fli(22, 11, [C.fli_chunk(18, bytes(20)),
                                          C.fli_brun(IDX)]),
    "unknown_chunk": lambda: C.write_fli(22, 11, [C.fli_chunk(99, bytes(9))]),
    "no_chunks": lambda: C.write_fli(22, 11, []),
    "two_frames": lambda: C.write_fli(22, 11, [C.fli_brun(IDX)], frames=2,
                                      later=[[C.fli_lc(LATER, IDX)]]),
    "zero_frames": lambda: C.write_fli(22, 11, [C.fli_brun(IDX)], frames=0),
    "flags_5": lambda: _patched(C.write_fli(22, 11, [C.fli_brun(IDX)]), 14,
                                5, "<H"),
    "reserved_set": lambda: _patched(C.write_fli(22, 11, [C.fli_brun(IDX)]),
                                     50, 1, "<H"),
    "frame_cut": lambda: C.write_fli(22, 11, [C.fli_brun(IDX)])[:-9],
    "frame_size_small": lambda: _patched(C.write_fli(
        22, 11, [C.fli_brun(IDX)]), 128, 6, "<I"),
    "brun_row_short": lambda: C.write_fli(22, 11, [C.fli_chunk(
        15, C.fli_brun(IDX)[6:-30])]),
    "header_only": lambda: C.write_fli(22, 11, [])[:128],
}


@pytest.mark.parametrize("case", sorted(FLI))
def test_fli_chunks_as_pillow(case):
    C.assert_as_pillow(FLI[case](), f"{case}.flc")


@pytest.mark.parametrize("seed", range(24))
def test_fli_random_frames_as_pillow(seed):
    """The fuzzer's FLI frames (``tools/ldr_fuzz.py::rnd_fli``)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "ldr_fuzz", f"{C.LDR_DIR}/../../tools/ldr_fuzz.py")
    fuzz = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fuzz)
    C.assert_as_pillow(fuzz.rnd_fli(np.random.default_rng(seed)))


@pytest.mark.parametrize("seed", range(10))
def test_fli_loops_agree_on_corrupt_frames(seed):
    """``wpt_fli`` and ``fli_plain`` on frames with random bytes changed:
    the same status and, where it decodes, the same indices."""
    rng = np.random.default_rng(seed)
    frame = bytearray(FLI[["brun", "lc", "ss2", "copy"][seed % 4]]()[128:])
    for _ in range(int(rng.integers(1, 6))):
        frame[int(rng.integers(0, len(frame)))] = int(rng.integers(0, 256))
    a, sa = native.fli_native(bytes(frame), 22, 11)
    b, sb = fli.fli_plain(bytes(frame), 22, 11)
    assert sa == sb
    if not sa:
        np.testing.assert_array_equal(a, b)


def test_large_fli_equals_pillows_digest_both_ways():
    """The 4096x2048 FLC ``chip_smoke.py`` times decodes, in C++, to the
    array whose SHA-256 Pillow gave; at 1024x512 the Python loop gives
    the C++ loop's indices."""
    with open(f"{C.LDR_DIR}/pillow_sha256.json") as f:
        want = json.load(f)[C.LARGE_FLI]
    got = C.decode_in(True, C.large_fli())
    assert hashlib.sha256(got.tobytes()).hexdigest() == want
    small = C.large_fli(1024, 512)
    np.testing.assert_array_equal(C.decode_in(False, small),
                                  C.decode_in(True, small))


# --- WMF and EPS ----------------------------------------------------------------


def placeable_wmf(inch: int = 1440, box=(0, 0, 2880, 1440),
                  record: bytes = b"\x01\x00\t\x00") -> bytes:
    head = b"\xd7\xcd\xc6\x9a\x00\x00" + struct.pack("<4hH", *box, inch)
    return head + bytes(22 - len(head)) + record + bytes(40)


def emf(frame=(0, 0, 1000, 1000)) -> bytes:
    return (b"\x01\x00\x00\x00" + bytes(4) + struct.pack("<8i", 0, 0, 100,
                                                         50, *frame)
            + b" EMF" + bytes(40))


STUBS = {
    "wmf": lambda: placeable_wmf(),
    "wmf_inch_0": lambda: placeable_wmf(inch=0),
    "wmf_other_record": lambda: placeable_wmf(record=b"\x02\x00\t\x00"),
    "wmf_empty_box": lambda: placeable_wmf(box=(10, 10, 10, 20)),
    "wmf_cut": lambda: placeable_wmf()[:12],
    "emf": lambda: emf(),
    "emf_flat_frame": lambda: emf((0, 0, 0, 1000)),
    "eps": lambda: b"%!PS-Adobe-3.0 EPSF-3.0\n%%BoundingBox: 0 0 10 10\n"
                   b"%%EndComments\n0 0 moveto\n",
    "eps_no_bounding_box": lambda: b"%!PS-Adobe-3.0\n%%EndComments\n",
    "eps_dos_header": lambda: b"\xc5\xd0\xd3\xc6" + bytes(40),
}


@pytest.mark.parametrize("case", sorted(STUBS))
def test_wmf_and_eps_raise_where_pillow_raises(case):
    """Pillow opens these (or passes them on and finds no format) and
    raises on them here; the port raises naming the file."""
    data = STUBS[case]()
    assert C.pillow_refuses(data)
    C.assert_refused(data, "s.img")


# --- against the JAX package, sniffing ----------------------------------------


@pytest.mark.parametrize("name", ["v2_rgba.gbr", "thumb.xv", "rgb.pxr",
                                  "gray.imt", "raw_rgb_band2.iim",
                                  "brun_lc.flc", "brun_colour64.fli"])
def test_jax_decode_image_equals_port(name):
    data = fixture(name)
    np.testing.assert_array_equal(IMAGE.decode_image_rgba(data, name),
                                  JG._decode_image(data))


@pytest.mark.parametrize("name", ["brun_ss2.flc", "jpeg_l.iim", "thumb.xv"])
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


def test_photo_cd_reaches_its_reader_past_the_formats_before_it():
    assert "PCD" in list(sniff.pillow_candidates(C.photo_cd(0)))
    assert list(sniff.pillow_candidates(fixture("thumb.xv")))[-1] == "XVTHUMB"


# --- the card's box and maps, against the JAX loader -------------------------


@pytest.mark.parametrize("ratio", [1.0, 0.5])
def test_sci_rare_sidecars_build_the_jax_atlas(ratio, tmp_path):
    """``textured_cornell()`` as a .gltf whose four textures are the
    sidecars ``chip_smoke.SCI_RARE_TEXTURES`` (a YCbCr IM, a GZIP_1 FITS,
    an FLC, a GIMP brush): the port's atlas equals the JAX
    ``build_atlas``'s."""
    for name in SCI_RARE_TEXTURES:
        (tmp_path / name).write_bytes(fixture(name))
    path = tmp_path / "textured.gltf"
    path.write_text(with_sidecar_images(scene_to_glb(textured_cornell()),
                                        list(SCI_RARE_TEXTURES)))
    assert len(json.loads(path.read_text())["images"]) == 4
    got, got_rects = G.build_atlas(G.GLTFFile.load(str(path)), ratio)
    want, want_rects = JG.build_atlas(JG.GLTFFile.load(str(path)), ratio)
    np.testing.assert_array_equal(got, want)
    assert got_rects == want_rects


@pytest.mark.parametrize("name", ["env_float.fits", "env.spi"])
def test_card_env_maps_equal_jax(name, tmp_path):
    """``load_env_image`` of the card's FITS and SPIDER maps equals the JAX
    package's."""
    path = str(tmp_path / "sky.png")
    with open(path, "wb") as f:
        f.write(fixture(name))
    np.testing.assert_array_equal(ENV.load_env_image(path),
                                  JENV.load_env_image(path))
