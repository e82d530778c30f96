"""The port's JPEG reader (``utils/jpeg.py``) against Pillow, and JPEG
textures and environment maps against the JAX package, which reads them
with Pillow.

Every case is held array-equal to ``Image.open(...).convert("RGBA")``:
Pillow decodes with libjpeg-turbo at its defaults (the integer IDCT, fancy
upsampling, the fixed-point YCbCr tables, block smoothing of progressive
files that leave coefficient bits unsent), which the reader copies. Each
case is decoded twice, with the C++ entropy decoder (``accel/cbvh/
jpeg_scan.cpp``) and with its plain Python version, and both must equal
Pillow. Pillow writes 4:4:4, 4:2:2 and 4:2:0 only, sequential in one
interleaved scan or progressive in libjpeg's standard script, and CMYK;
``tests/torch_jpeg_cases.py`` writes the rest (4:4:0, 4:1:1, mixed
factors, one scan a component, 16-bit tables, Adobe RGB, YCCK and 4
components under any Adobe transform, restart intervals on any MCU count,
progressive scan scripts of any shape, scripts that stop early,
arithmetic-coded and lossless frames), which Pillow then decodes as the
reference. The arithmetic-coded and lossless cases of their own are in
``tests/test_torch_jpeg_arith.py`` and ``tests/test_torch_jpeg_lossless.py``.
"""

import io
import json

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from wgpu_path_tracing_tpu import Renderer as JRenderer
from wgpu_path_tracing_tpu import RenderConfig as JRenderConfig
from wgpu_path_tracing_tpu.models import gltf as JG
from wgpu_path_tracing_tpu.models import procedural as JP
from wgpu_path_tracing_tpu.ops import env as JENV
from wgpu_path_tracing_tpu.utils import image as JIMAGE
from chip_smoke import with_jpeg_images
from wgpu_path_tracing_tpu_torch import (
    Renderer,
    RenderConfig,
    material_test_box,
    scene_to_glb,
    textured_cornell,
)
from wgpu_path_tracing_tpu_torch.models import gltf as G
from wgpu_path_tracing_tpu_torch.ops import env as ENV
from wgpu_path_tracing_tpu_torch.utils import image as IMAGE
from wgpu_path_tracing_tpu_torch.accel import native
from wgpu_path_tracing_tpu_torch.utils import jpeg as JPEG
from wgpu_path_tracing_tpu_torch.utils.jpeg import decode_jpeg_rgba
from tests import torch_jpeg_cases as JC
from tests.test_torch_env import EnvOracle, _oracle_mean

torch.set_num_threads(1)

SIZES = [(1, 1), (7, 13), (17, 33), (100, 75), (256, 256)]
QUALITIES = (10, 75, 95, 100)
# Pillow sizes its buffer for a progressive file at 2 bytes a pixel from
# quality 95 on, and fails to write the 256^2 4:4:4 photo at 99 and above.
PROGRESSIVE_QUALITIES = (10, 75, 95, 98)


def pillow_rgba(data: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGBA"))


def pillow_jpeg(img: Image.Image, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, "JPEG", **kw)
    return buf.getvalue()


def photo(w: int, h: int, seed: int = 0) -> Image.Image:
    """Gradients, a ripple and noise: flat runs, edges and busy blocks."""
    return Image.fromarray(np.stack(JC.sample_planes(w, h, seed=seed), -1),
                           "RGB")


def decode_in(in_cxx: bool, data: bytes, name: str) -> np.ndarray:
    """``decode_jpeg_rgba`` with the C++ entropy decoder, or with its plain
    Python version (``native_available`` patched to False)."""
    with pytest.MonkeyPatch.context() as m:
        if not in_cxx:
            m.setattr(native, "native_available", lambda: False)
        return decode_jpeg_rgba(data, name)


def assert_like_pillow(data: bytes) -> None:
    """Both entropy decoders' RGBA equal to Pillow's."""
    want = pillow_rgba(data)
    for in_cxx in (True, False):
        np.testing.assert_array_equal(decode_in(in_cxx, data, "case"), want,
                                      err_msg=f"in C++: {in_cxx}")


def assert_refused_like_pillow(data: bytes, exc, match: str) -> None:
    """Pillow refuses ``data``, and both entropy decoders raise ``exc``
    matching ``match`` after the image's name."""
    with pytest.raises(Exception):
        pillow_rgba(data)
    for in_cxx in (True, False):
        with pytest.raises(exc, match=f"r.jpg: {match}"):
            decode_in(in_cxx, data, "r.jpg")


@pytest.mark.parametrize("mode", ["gray", "4:4:4", "4:2:2", "4:2:0"])
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_pillow_files_equal_pillow(size, mode):
    """Each quality, custom Huffman tables (``optimize``) and restart
    markers every 3 blocks and every MCU row."""
    img = photo(*size)
    kw = {}
    if mode == "gray":
        img = img.convert("L")
    else:
        kw["subsampling"] = ("4:4:4", "4:2:2", "4:2:0").index(mode)
    for quality in QUALITIES:
        assert_like_pillow(pillow_jpeg(img, quality=quality, **kw))
    for extra in ({"optimize": True}, {"restart_marker_blocks": 3},
                  {"restart_marker_rows": 1}):
        assert_like_pillow(pillow_jpeg(img, quality=75, **kw, **extra))


SAMPLINGS = {
    "4:4:0": [(1, 2), (1, 1), (1, 1)],
    "4:1:1": [(4, 1), (1, 1), (1, 1)],
    "4:1:0": [(1, 4), (1, 1), (1, 1)],
    "h4v2": [(4, 2), (1, 1), (1, 1)],
    "mixed": [(2, 2), (1, 1), (2, 1)],
    "mixed_v": [(2, 2), (1, 2), (2, 1)],
    "chroma_full": [(1, 1), (2, 2), (2, 2)],
    "h2v4": [(2, 4), (1, 1), (1, 1)],
    "h3": [(3, 1), (1, 1), (1, 1)],
}


@pytest.mark.parametrize("name", sorted(SAMPLINGS))
def test_every_sampling_factor_equals_pillow(name):
    """Sampling factors Pillow cannot write, at sizes no multiple of the
    MCU and at one and two samples wide (box upsampling under h2v1 and
    h2v2), in one interleaved scan and one scan a component, with restart
    intervals."""
    for w, h in [(1, 1), (2, 9), (7, 13), (17, 33), (40, 24)]:
        planes = JC.sample_planes(w, h, seed=w)
        for kw in ({}, {"restart": 1}, {"interleaved": False, "restart": 3}):
            assert_like_pillow(JC.write_jpeg(planes, SAMPLINGS[name],
                                             quality=60, **kw))


@pytest.mark.parametrize("header", ["adobe_rgb", "rgb_ids", "other_ids",
                                    "adobe_ycc", "jfif_rgb_ids"])
def test_colour_space_as_libjpeg_guesses(header):
    """RGB under an Adobe marker with transform 0, or with neither marker
    and the ids 'R', 'G', 'B'; YCbCr otherwise (a JFIF marker wins over the
    ids); 16-bit quantization tables (SOF1)."""
    kw = {"adobe_rgb": {"app": "adobe", "adobe_transform": 0},
          "rgb_ids": {"app": "none", "ids": [82, 71, 66]},
          "other_ids": {"app": "none", "ids": [5, 6, 7]},
          "adobe_ycc": {"app": "adobe", "adobe_transform": 1},
          "jfif_rgb_ids": {"ids": [82, 71, 66]}}[header]
    planes = JC.sample_planes(19, 11)
    for sampling in ([(1, 1)] * 3, [(2, 2), (1, 1), (1, 1)]):
        assert_like_pillow(JC.write_jpeg(planes, sampling, **kw))
        assert_like_pillow(JC.write_jpeg(planes, sampling, quant16=True,
                                         **kw))


def test_gray_sampling_factors_and_pillow_rgb():
    """A gray image's one component at any sampling factor (one block a
    MCU); Pillow's ``keep_rgb`` file (RGB under an Adobe marker)."""
    for w, h in [(1, 1), (9, 17), (20, 3)]:
        plane = JC.sample_planes(w, h, nc=1)
        for sampling in ([(1, 1)], [(2, 2)], [(1, 3)]):
            for kw in ({}, {"restart": 2}):
                data = JC.write_jpeg(plane, sampling, **kw)
                assert_like_pillow(data)
                assert (decode_jpeg_rgba(data)[..., 3] == 255).all()
    data = pillow_jpeg(photo(23, 9), keep_rgb=True, quality=90)
    assert b"Adobe" in data
    assert_like_pillow(data)


def test_exif_orientation_is_ignored():
    """``Image.open`` does not apply EXIF orientation, and neither does the
    reader: a file tagged "rotate 90" decodes in its stored orientation."""
    exif = Image.Exif()
    exif[0x0112] = 6
    data = pillow_jpeg(photo(12, 5), exif=exif.tobytes())
    got = decode_jpeg_rgba(data)
    assert got.shape == (5, 12, 4)
    assert_like_pillow(data)


@settings(max_examples=12, deadline=None)
@given(w=st.integers(1, 70), h=st.integers(1, 70),
       quality=st.integers(1, 100), subsampling=st.sampled_from([0, 1, 2]),
       seed=st.integers(0, 2**16))
def test_hypothesis_sizes_qualities_subsampling(w, h, quality, subsampling,
                                                seed):
    assert_like_pillow(pillow_jpeg(photo(w, h, seed), quality=quality,
                                   subsampling=subsampling))


# --- progressive, CMYK and YCCK ---------------------------------------------


@pytest.mark.parametrize("mode", ["gray", "4:4:4", "4:2:2", "4:2:0"])
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_pillow_progressive_files_equal_pillow(size, mode):
    """libjpeg's standard progressive script as Pillow writes it (the DC
    at Al 1, the luma's bands 1-5 and 6-63 at Al 2 and the chroma's at Al
    1, then the refinements), at each quality, with and without
    ``optimize``, with restart markers every 3 blocks, every block and
    every MCU row (each end-of-band run cut at a restart)."""
    img = photo(*size, seed=size[0])
    kw = {"progressive": True}
    if mode == "gray":
        img = img.convert("L")
    else:
        kw["subsampling"] = ("4:4:4", "4:2:2", "4:2:0").index(mode)
    for quality in PROGRESSIVE_QUALITIES:
        assert_like_pillow(pillow_jpeg(img, quality=quality, **kw))
    for extra in ({"optimize": True}, {"restart_marker_blocks": 3},
                  {"restart_marker_blocks": 1, "optimize": True},
                  {"restart_marker_rows": 1}):
        assert_like_pillow(pillow_jpeg(img, quality=75, **kw, **extra))


@pytest.mark.parametrize("progressive", [False, True],
                         ids=["sequential", "progressive"])
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_pillow_cmyk_equals_pillow(size, progressive):
    """Pillow's CMYK files (an Adobe marker with transform 0, the samples
    written inverted and read back as "CMYK;I"), at 1x1 sampling and with
    the first component at 2x2 (``subsampling=2``), with restart
    markers."""
    img = photo(*size, seed=3).convert("CMYK")
    for kw in ({"quality": 75}, {"quality": 95, "subsampling": 2},
               {"quality": 10}, {"restart_marker_blocks": 2}):
        assert_like_pillow(pillow_jpeg(img, progressive=progressive, **kw))


@settings(max_examples=12, deadline=None)
@given(w=st.integers(1, 70), h=st.integers(1, 70),
       quality=st.integers(1, 100), subsampling=st.sampled_from([0, 1, 2]),
       restart=st.sampled_from([0, 1, 4]), seed=st.integers(0, 2**16))
def test_hypothesis_progressive(w, h, quality, subsampling, restart, seed):
    assert_like_pillow(pillow_jpeg(photo(w, h, seed), quality=quality,
                                   subsampling=subsampling, progressive=True,
                                   restart_marker_blocks=restart))


SCRIPT_SAMPLINGS = {"gray": [(1, 1)], "4:4:4": [(1, 1)] * 3,
                    "4:2:0": [(2, 2), (1, 1), (1, 1)],
                    "mixed": [(2, 2), (1, 2), (2, 1)]}


@pytest.mark.parametrize("sampling", sorted(SCRIPT_SAMPLINGS))
@pytest.mark.parametrize("script", sorted(JC.SCRIPTS))
def test_progressive_scripts_equal_pillow(script, sampling):
    """Scan scripts Pillow cannot write (``JC.SCRIPTS``): each DC in a
    scan of its own, successive approximation of the DC (Al 2, 1, 0) and
    of the AC from Al 2, bands refined over part of their range, and
    scripts that stop after the DC or after band 1-5, which libjpeg
    block-smooths; at sizes no multiple of the MCU (40 rows leave a
    padding block row of the 4:2:0 luma that the smoothing reads), without
    restarts and with restart intervals of 1 and 5 MCUs (end-of-band runs
    cut at each restart)."""
    sampling = SCRIPT_SAMPLINGS[sampling]
    nc = len(sampling)
    for w, h in [(8, 8), (17, 33), (40, 40)]:
        planes = JC.sample_planes(w, h, nc=nc, seed=w)
        for restart in (0, 1, 5):
            assert_like_pillow(JC.write_jpeg(
                planes, sampling, quality=60, restart=restart,
                scans=JC.script_for(script, nc)))


FOUR = {"cmyk_adobe": {"app": "adobe", "adobe_transform": 0},
        "ycck": {"app": "adobe", "adobe_transform": 2},
        "adobe_transform_1": {"app": "adobe", "adobe_transform": 1},
        "no_adobe": {"app": "none"}, "jfif_no_adobe": {"app": "jfif"}}


@pytest.mark.parametrize("frame", ["sequential", "progressive"])
@pytest.mark.parametrize("header", sorted(FOUR))
def test_four_components_as_libjpeg_guesses(header, frame):
    """Four components: CMYK without an Adobe marker (a JFIF marker or
    none) and under transform 0; YCCK under transform 2 and, with
    libjpeg's warning, 1 (``jdcolor.c::ycck_cmyk_convert``); then Pillow's
    "CMYK;I" and ``cmyk2rgb``. At 1x1 sampling and with the first and last
    components at 2x2 and 2x1, in one interleaved scan, one scan a
    component and three progressive scripts, with restart intervals."""
    planes = JC.sample_planes(19, 11, nc=4)
    for sampling in ([(1, 1)] * 4, [(2, 2), (1, 1), (1, 1), (2, 1)]):
        if frame == "sequential":
            for kw in ({}, {"interleaved": False, "restart": 2},
                       {"restart": 1}):
                assert_like_pillow(JC.write_jpeg(planes, sampling,
                                                 **FOUR[header], **kw))
        else:
            for script in ("simple", "refine_al2", "dc_only"):
                assert_like_pillow(JC.write_jpeg(
                    planes, sampling, restart=3, **FOUR[header],
                    scans=JC.script_for(script, 4)))


def test_block_smoothing_only_where_bits_are_missing(monkeypatch):
    """``smoothing_ok``: off for sequential and complete progressive
    files, on for each script of ``JC.SMOOTHED``; where on, the image
    differs from the plain IDCT's (except "band_1_5", whose band 1-5 is
    exact and whose 6-9 libjpeg does not estimate without DC
    interpolation), and Pillow agrees with the smoothed one."""
    calls = []
    smooth = JPEG.smooth_blocks
    monkeypatch.setattr(JPEG, "smooth_blocks",
                        lambda coef, c, rows: calls.append(c.id)
                        or smooth(coef, c, rows))
    planes = JC.sample_planes(40, 40, seed=3)
    sampling = [(2, 2), (1, 1), (1, 1)]
    files = {name: JC.write_jpeg(planes, sampling, quality=60,
                                 scans=JC.script_for(name, 3))
             for name in JC.SCRIPTS}
    files["sequential"] = JC.write_jpeg(planes, sampling, quality=60)
    files["pillow"] = pillow_jpeg(photo(40, 40), progressive=True)
    for name, data in files.items():
        calls.clear()
        got = decode_jpeg_rgba(data, name)
        np.testing.assert_array_equal(got, pillow_rgba(data), err_msg=name)
        assert bool(calls) == (name in JC.SMOOTHED), name
        if calls:
            assert sorted(calls) == [1, 2, 3], name
            with monkeypatch.context() as m:
                m.setattr(JPEG, "smoothing_ok", lambda frame: False)
                plain = decode_jpeg_rgba(data, name)
            assert np.array_equal(plain, got) == (name == "band_1_5"), name


def test_a_failed_native_build_raises(monkeypatch):
    """Where ``g++`` is on ``PATH`` the decode takes the C++ entropy
    decoder; a library that fails to build raises, and the decode does
    not fall back to Python. Without ``g++`` it decodes in Python."""
    data = pillow_jpeg(photo(16, 8), progressive=True)

    def fail(cxx=None):
        raise RuntimeError("g++ failed to build the native library")

    monkeypatch.setattr(native._Lib, "handle", None)
    monkeypatch.setattr(native, "build", fail)
    monkeypatch.setattr(native, "native_available", lambda: True)
    with pytest.raises(RuntimeError, match="failed to build"):
        decode_jpeg_rgba(data, "x.jpg")
    monkeypatch.setattr(native, "native_available", lambda: False)
    np.testing.assert_array_equal(decode_jpeg_rgba(data, "x.jpg"),
                                  pillow_rgba(data))


def test_bad_progressive_scans_raise_naming_the_image():
    """``start_pass_phuff_decoder``'s errors raise ``ValueError`` naming
    the image: an AC scan of two components, a DC scan with Se > 0, Ss >
    Se, a refinement whose Al is not Ah - 1, Al above 13. Its warnings (an
    AC scan before any DC, a refinement out of turn) decode as Pillow
    decodes them."""
    planes = JC.sample_planes(16, 16)
    sampling = [(1, 1)] * 3
    dc = ((0, 1, 2), 0, 0, 0, 0)
    for scan in (((0, 1), 1, 63, 0, 0), ((0,), 0, 5, 0, 0),
                 ((0,), 9, 5, 0, 0), ((0,), 1, 63, 2, 0),
                 ((0,), 1, 63, 0, 14)):
        data = JC.write_jpeg(planes, sampling, scans=[dc, scan])
        with pytest.raises(ValueError, match="bad.jpg: bad progressive"):
            decode_jpeg_rgba(data, "bad.jpg")
    for scans in ([((0,), 1, 63, 0, 0), dc],
                  [((0, 1, 2), 0, 0, 0, 1), ((0,), 1, 63, 1, 0),
                   ((0, 1, 2), 0, 0, 1, 0)]):
        assert_like_pillow(JC.write_jpeg(planes, sampling, scans=scans))


def test_progressive_cmyk_and_truncated_raise_naming_the_image():
    """Cut progressive, CMYK, baseline, arithmetic-coded and lossless files
    raise ``ValueError`` naming the image through both entropy decoders;
    hierarchical and 12-bit frames ``NotImplementedError``; more than 10
    blocks a MCU, a bad progressive scan and bytes that are no JPEG
    ``ValueError``. A baseline file relabelled SOF9, SOF10 or SOF3 (its
    Huffman data read as arithmetic-coded or lossless data) goes as Pillow
    goes: SOF9 decodes to Pillow's array, SOF10 and SOF3 are refused for
    their scan's Ss..Se, by Pillow and by the port. (Progressive, CMYK,
    arithmetic-coded and lossless files decode: the cases above and
    ``tests/test_torch_jpeg_arith.py``, ``tests/test_torch_jpeg_lossless.
    py``.)"""
    img = photo(64, 64)
    planes = JC.sample_planes(64, 64)
    for data in (pillow_jpeg(img, quality=90),
                 pillow_jpeg(img, progressive=True),
                 pillow_jpeg(img.convert("CMYK")),
                 pillow_jpeg(img.convert("CMYK"), progressive=True,
                             restart_marker_blocks=2),
                 JC.write_jpeg(planes, [(2, 2), (1, 1), (1, 1)],
                               arithmetic=True, restart=3),
                 JC.write_jpeg(planes, [(1, 1)] * 3, arithmetic=True,
                               scans=JC.script_for("simple", 3)),
                 JC.write_lossless_jpeg(planes, predictor=6, restart_rows=4)):
        for cut in (len(data) // 2, len(data) - 40, 300):
            for in_cxx in (True, False):
                with pytest.raises(ValueError, match="cut.jpg: truncated"):
                    decode_in(in_cxx, data[:cut], "cut.jpg")
    data = pillow_jpeg(photo(64, 64), quality=90)
    sof = data.index(b"\xff\xc0")
    relabel = {m: data[:sof + 1] + bytes([m]) + data[sof + 2:]
               for m in (0xC9, 0xCA, 0xC3, 0xC5)}
    assert_like_pillow(relabel[0xC9])
    assert_refused_like_pillow(relabel[0xCA], ValueError,
                               "bad progressive JPEG scan")
    assert_refused_like_pillow(relabel[0xC3], ValueError,
                               "bad lossless JPEG scan")
    assert_refused_like_pillow(relabel[0xC5], NotImplementedError,
                               "hierarchical")
    twelve = bytearray(data)
    twelve[sof + 4] = 12  # the frame's sample precision
    with pytest.raises(NotImplementedError, match="b.jpg: 12-bit"):
        decode_jpeg_rgba(bytes(twelve), "b.jpg")
    with pytest.raises(ValueError, match="d.jpg: sampling factors too"):
        # 21 blocks a MCU: libjpeg refuses more than 10, and Pillow with it
        decode_jpeg_rgba(JC.write_jpeg(JC.sample_planes(16, 16),
                                       [(4, 4), (2, 2), (1, 1)]), "d.jpg")
    with pytest.raises(ValueError, match="c.jpg: not a JPEG"):
        decode_jpeg_rgba(b"\x89PNG\r\n\x1a\n", "c.jpg")


def test_lossless_jpeg_pillow_reads_raises_naming_the_image():
    """A lossless JPEG (SOF3) that ``JC.write_lossless_jpeg`` writes:
    Pillow's libjpeg-turbo decodes it to the very samples, and so does the
    port, through both entropy decoders (it raised here before lossless
    frames were decoded; the name stays)."""
    plane = JC.sample_planes(23, 17, nc=1)[0]
    data = JC.write_lossless_jpeg(plane)
    want = np.repeat(plane[..., None], 3, -1)
    np.testing.assert_array_equal(pillow_rgba(data)[..., :3], want)
    assert_like_pillow(data)
    np.testing.assert_array_equal(decode_jpeg_rgba(data, "ll.jpg")[..., :3],
                                  want)


@pytest.mark.parametrize("sampling", ["gray", "4:2:0", "4:4:4_apart"])
def test_arithmetic_jpeg_pillow_reads_raises_naming_the_image(sampling):
    """An arithmetic-coded sequential JPEG (SOF9) that ``JC.write_jpeg(
    arithmetic=True)`` writes: Pillow's libjpeg-turbo decodes it to the
    pixels of the Huffman-coded file of the same coefficients, and so does
    the port, through both entropy decoders (it raised here before
    arithmetic coding was decoded; the name stays)."""
    factors, kw = {"gray": ([(1, 1)], {}),
                   "4:2:0": ([(2, 2), (1, 1), (1, 1)], {}),
                   "4:4:4_apart": ([(1, 1)] * 3, {"interleaved": False})}[
                       sampling]
    planes = JC.sample_planes(33, 17, nc=len(factors))
    data = JC.write_jpeg(planes, factors, arithmetic=True, **kw)
    huffman = JC.write_jpeg(planes, factors, **kw)
    np.testing.assert_array_equal(pillow_rgba(data), pillow_rgba(huffman))
    assert_like_pillow(data)
    np.testing.assert_array_equal(decode_jpeg_rgba(data, "ar.jpg"),
                                  decode_jpeg_rgba(huffman, "h.jpg"))


def test_images_are_sniffed_by_their_bytes(tmp_path):
    """``decode_image_rgba`` and ``read_png`` tell PNG from JPEG by the
    signature, whatever the name says, as Pillow does; other bytes raise
    naming the file."""
    img = photo(10, 6)
    jpeg = pillow_jpeg(img, quality=80)
    path = tmp_path / "sky.png"  # a JPEG whatever its name says
    path.write_bytes(jpeg)
    with Image.open(path) as ref:
        want = np.asarray(ref.convert("RGB"), np.float32) / 255.0
    np.testing.assert_array_equal(IMAGE.read_png(str(path)), want)
    png = IMAGE.encode_png(np.asarray(img))
    np.testing.assert_array_equal(IMAGE.decode_image_rgba(png, "a.jpg"),
                                  pillow_rgba(png))
    np.testing.assert_array_equal(IMAGE.decode_image_rgba(jpeg),
                                  pillow_rgba(jpeg))
    with pytest.raises(ValueError, match="x.gif: neither a PNG nor a JPEG"):
        IMAGE.decode_image_rgba(b"GIF89a" + bytes(20), "x.gif")


# --- against the JAX package --------------------------------------------------


def kind_jpegs(kind: str) -> list:
    """Three textures of one kind: "baseline" (4:2:0, gray with custom
    tables, 4:4:4 with restart markers), "progressive" (the same three
    progressive), "cmyk" (Pillow's, sequential, progressive, and with its
    first component at 2x2 and restart markers), "ycck" (written with an
    Adobe marker of transform 2, one sequential, two progressive),
    "arithmetic" (4:2:0 SOF9 with a DAC segment, gray SOF10 block-smoothed,
    4:4:4 SOF10 with restart markers) or "lossless" (RGB, gray with a
    point transform, RGB with its first component at 2x2 and restarts)."""
    imgs = [photo(37, 21), photo(16, 16, 1), photo(9, 30, 2)]
    if kind == "arithmetic":
        return [JC.write_jpeg(JC.sample_planes(37, 21), [(2, 2), (1, 1),
                                                         (1, 1)],
                              quality=85, arithmetic=True,
                              dac={(0, 0): 0x32, (1, 1): 9}),
                JC.write_jpeg(JC.sample_planes(16, 16, nc=1, seed=1),
                              [(1, 1)], arithmetic=True,
                              scans=JC.script_for("band_1_5_al1", 1)),
                JC.write_jpeg(JC.sample_planes(9, 30, seed=2), [(1, 1)] * 3,
                              arithmetic=True, restart=1,
                              scans=JC.script_for("simple", 3))]
    if kind == "lossless":
        return [JC.write_lossless_jpeg(JC.sample_planes(37, 21),
                                       predictor=7),
                JC.write_lossless_jpeg(JC.sample_planes(16, 16, nc=1,
                                                        seed=1),
                                       predictor=5, pt=2),
                JC.write_lossless_jpeg(JC.sample_planes(9, 30, seed=2),
                                       [(2, 2), (1, 1), (1, 1)],
                                       predictor=4, restart_rows=1)]
    if kind in ("baseline", "progressive"):
        p = kind == "progressive"
        return [pillow_jpeg(imgs[0], quality=85, progressive=p),
                pillow_jpeg(imgs[1].convert("L"), optimize=True,
                            progressive=p),
                pillow_jpeg(imgs[2], subsampling=0, restart_marker_blocks=1,
                            progressive=p)]
    if kind == "cmyk":
        return [pillow_jpeg(imgs[0].convert("CMYK"), quality=85),
                pillow_jpeg(imgs[1].convert("CMYK"), progressive=True),
                pillow_jpeg(imgs[2].convert("CMYK"), subsampling=2,
                            restart_marker_blocks=1, progressive=True)]
    ycck = {"app": "adobe", "adobe_transform": 2}
    return [JC.write_jpeg(JC.sample_planes(37, 21, nc=4), [(2, 2)] + [(1, 1)]
                          * 3, quality=85, **ycck),
            JC.write_jpeg(JC.sample_planes(16, 16, nc=4, seed=1), [(1, 1)] * 4,
                          scans=JC.script_for("simple", 4), **ycck),
            JC.write_jpeg(JC.sample_planes(9, 30, nc=4, seed=2),
                          [(1, 2), (1, 1), (1, 1), (1, 1)], restart=1,
                          scans=JC.script_for("refine_al2", 4), **ycck)]


@pytest.mark.parametrize("kind,ratio", [
    *[pytest.param("baseline", r, id=str(r)) for r in (0.5, 1.0)],
    *[pytest.param(k, r, id=f"{k}-{r}") for k in ("progressive", "cmyk",
                                                  "ycck", "arithmetic",
                                                  "lossless")
      for r in (0.5, 1.0)]])
def test_jpeg_textures_build_the_jax_atlas(tmp_path, kind, ratio):
    """``textured_cornell()`` written to a .gltf whose images are JPEGs of
    one kind (``kind_jpegs``; one declared image/png, the others with no
    MIME type): the port's atlas equals the JAX ``build_atlas``'s, which
    decodes with Pillow."""
    gltf = json.loads(with_jpeg_images(scene_to_glb(textured_cornell()),
                                       kind_jpegs(kind)))
    assert len(gltf["images"]) >= 2
    gltf["images"][0]["mimeType"] = "image/png"
    path = tmp_path / "textured.gltf"
    path.write_text(json.dumps(gltf))
    got, got_rects = G.build_atlas(G.GLTFFile.load(str(path)), ratio)
    want, want_rects = JG.build_atlas(JG.GLTFFile.load(str(path)), ratio)
    np.testing.assert_array_equal(got, want)
    assert got_rects == want_rects


def env_case(tmp_path, data: bytes) -> None:
    """A JPEG map named .png: ``read_png`` and ``load_env_image`` equal
    the JAX ones (Pillow), and a 24x24, 2-spp render of the open material
    box under it, set through ``RenderConfig.env_map``, is held to the JAX
    ``Renderer`` with the bars of ``tests/test_torch_env.py``: >= 99% of
    pixels within 5e-4 of the JAX image or, where not, within 2e-3 of the
    scalar oracle's mean, at most 5 off both, the means within 1e-3."""
    path = str(tmp_path / "sky.png")
    with open(path, "wb") as f:
        f.write(data)
    np.testing.assert_array_equal(IMAGE.read_png(path), JIMAGE.read_png(path))
    env = ENV.load_env_image(path)
    np.testing.assert_array_equal(env, JENV.load_env_image(path))
    r = Renderer(RenderConfig(width=24, height=24, max_bounces=2,
                              env_map=path, env_intensity=1.5),
                 device="cpu")
    r.load_scene(material_test_box())
    buf = r.render(spp=2)
    j = JRenderer(JRenderConfig(width=24, height=24, max_bounces=2,
                                frames_per_chunk=2, env_map=path,
                                env_intensity=1.5))
    j.load_scene(JP.material_test_box())
    ref = np.asarray(j.render(spp=2))
    close = np.isclose(buf, ref, rtol=5e-4, atol=5e-4).all(-1)
    oracle = EnvOracle(material_test_box(), r.camera.as_pytree(), 24, 24,
                       env, 1.5, 0.0, max_bounces=2)
    ys, xs = np.nonzero(~close)
    off_both = [(px, py) for px, py in zip(xs, ys)
                if not np.allclose(buf[py, px], _oracle_mean(oracle, px, py, 2),
                                   rtol=2e-3, atol=2e-3)]
    report = (f"{len(xs)} of {close.size} pixels outside 5e-4 of the JAX "
              f"render, {len(off_both)} of them off the oracle too: {off_both}")
    assert close.size - len(off_both) >= 0.99 * close.size, report
    assert len(off_both) <= 5, report
    assert abs(buf.mean() / ref.mean() - 1.0) < 1e-3


def sky(kind: str) -> bytes:
    """A 32x64 noisy sky as a JPEG of ``kind``: "baseline" or "progressive"
    (Pillow, quality 80), "cmyk" (Pillow, progressive), "ycck" (written,
    progressive, with restart intervals), "arithmetic" (SOF9 4:2:0),
    "arithmetic_progressive" (SOF10 4:2:0, restart intervals) or
    "lossless" (SOF3 RGB, predictor 7)."""
    rng = np.random.default_rng(9)
    img = Image.fromarray((rng.random((32, 64, 3)) * 255).astype(np.uint8))
    if kind in ("baseline", "progressive"):
        return pillow_jpeg(img, quality=80, progressive=kind == "progressive")
    if kind == "cmyk":
        return pillow_jpeg(img.convert("CMYK"), quality=80, progressive=True)
    rgb = list(np.moveaxis(np.asarray(img), -1, 0))
    if kind == "lossless":
        return JC.write_lossless_jpeg(rgb, predictor=7)
    if kind.startswith("arithmetic"):
        scans = JC.script_for("simple", 3) if kind.endswith("ve") else None
        return JC.write_jpeg(rgb, [(2, 2), (1, 1), (1, 1)], quality=80,
                             arithmetic=True, scans=scans, restart=2)
    planes = [*rgb, JC.sample_planes(64, 32, nc=4)[3]]
    return JC.write_jpeg(planes, [(2, 2), (1, 1), (1, 1), (1, 1)], restart=2,
                         app="adobe", adobe_transform=2,
                         scans=JC.script_for("simple", 4))


def test_jpeg_env_map_equals_jax_and_renders_like_it(tmp_path):
    """``env_case`` on a baseline JPEG map."""
    env_case(tmp_path, sky("baseline"))


@pytest.mark.parametrize("kind", ["progressive", "cmyk", "ycck",
                                  "arithmetic", "arithmetic_progressive",
                                  "lossless"])
def test_jpeg_env_map_of_every_kind_equals_jax_and_renders_like_it(tmp_path,
                                                                   kind):
    """``env_case`` on a progressive, a CMYK, a YCCK, two arithmetic-coded
    and a lossless map."""
    env_case(tmp_path, sky(kind))


def test_committed_jpegs_equal_their_pillow_decode():
    """The small JPEGs under ``tests/jpeg/`` (the card's check of the reader,
    where there is no Pillow) still decode as Pillow decodes them here and
    as their ``.npz`` says."""
    from chip_smoke import JPEG_DIR, jpeg_cases

    cases = jpeg_cases()
    assert len(cases) >= 3
    for name, data, want in cases:
        np.testing.assert_array_equal(want, pillow_rgba(data), err_msg=name)
        np.testing.assert_array_equal(decode_jpeg_rgba(data, name), want,
                                      err_msg=name)
    assert JPEG_DIR.endswith("jpeg")


def test_committed_timing_jpegs_equal_their_pillow_digest():
    """The 1024^2 and 2048^2 files under ``tests/jpeg``, sequential and
    progressive, Huffman- and arithmetic-coded, and the 1024^2 lossless
    one (the card host's timing of the reader), decode to the SHA-256 of
    Pillow's decode that ``pillow_sha256.json`` holds, and Pillow here
    still decodes them so (handed each file in one block: it refuses an
    arithmetic-coded file past its first 64 KiB block otherwise,
    ``JC.pillow_whole_rgba``)."""
    import hashlib

    from chip_smoke import JPEG_DIR

    with open(f"{JPEG_DIR}/pillow_sha256.json") as f:
        digests = json.load(f)
    assert sorted(digests) == ["timing_1024.jpg", "timing_2048.jpg",
                               "timing_arith_1024.jpg",
                               "timing_arith_2048.jpg",
                               "timing_arith_progressive_1024.jpg",
                               "timing_arith_progressive_2048.jpg",
                               "timing_lossless_1024.jpg",
                               "timing_progressive_1024.jpg",
                               "timing_progressive_2048.jpg"]
    for name, digest in digests.items():
        with open(f"{JPEG_DIR}/{name}", "rb") as f:
            data = f.read()
        got = decode_jpeg_rgba(data, name)
        assert hashlib.sha256(got.tobytes()).hexdigest() == digest, name
        np.testing.assert_array_equal(got, JC.pillow_whole_rgba(data),
                                      err_msg=name)
