"""The port's BLP (``utils/blp.py``) and FTEX (``utils/ftex.py``) readers
against Pillow 12.1.0, which the JAX package reads LDR images with.

Every case is held array-equal to ``Image.open(...).convert("RGBA")`` and
decoded twice: with the C++ DXT decoder (``accel/cbvh/bcn_scan.cpp``'s
``wpt_blp_dxt``) and BC1 blocks (``wpt_bcn``), and with their plain NumPy
versions. Pillow writes BLP1 and BLP2 palette files;
``tests/torch_image_cases.py`` writes the rest: DXT1, DXT3 and DXT5 of
any size (random blocks included), BLP1 JPEG with its shared header split
anywhere, CMYK and YCCK frames, palette files with alpha, and FTEX files
(Pillow cannot write them).
"""

import hashlib
import io
import json
import struct

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from chip_smoke import LEGACY_ENV_MAPS, LEGACY_TEXTURES, with_sidecar_images
from wgpu_path_tracing_tpu.models import gltf as JG
from wgpu_path_tracing_tpu.ops import env as JENV
from wgpu_path_tracing_tpu.utils import image as JIMAGE
from wgpu_path_tracing_tpu_torch import scene_to_glb, textured_cornell
from wgpu_path_tracing_tpu_torch.accel import native
from wgpu_path_tracing_tpu_torch.models import gltf as G
from wgpu_path_tracing_tpu_torch.ops import env as ENV
from wgpu_path_tracing_tpu_torch.utils import blp, sniff
from wgpu_path_tracing_tpu_torch.utils import image as IMAGE
from tests import torch_image_cases as C

torch.set_num_threads(1)

FIXTURES = np.load(f"{C.LDR_DIR}/pillow_rgba.npz")
FILES = sorted(n for n in FIXTURES.files if n.endswith((".blp", ".ftc",
                                                        ".ftu")))
KINDS = {1: 0, 3: 1, 5: 7}  # DXT kind -> BLP2 alpha encoding


def fixture(name: str) -> bytes:
    with open(f"{C.LDR_DIR}/{name}", "rb") as f:
        return f.read()


@pytest.mark.parametrize("name", FILES)
def test_committed_blp_ftex_files_equal_pillow(name):
    np.testing.assert_array_equal(C.assert_like_pillow(fixture(name), name),
                                  FIXTURES[name])


@pytest.mark.parametrize("version", ["BLP1", "BLP2"])
@pytest.mark.parametrize("palette_mode", ["RGB", "RGBA"])
@pytest.mark.parametrize("size", [(1, 1), (17, 9), (32, 16)])
def test_pillow_written_blp_equals_pillow(version, palette_mode, size):
    """Pillow's writer (palette images only; an RGBA palette sets the
    alpha flag)."""
    img = Image.fromarray(C.sample_image(*size, seed=sum(size), channels=3))
    pal = img.convert("P", palette=Image.Palette.ADAPTIVE, colors=24)
    if palette_mode == "RGBA":
        rgb = np.asarray(pal.getpalette(), np.uint8).reshape(-1, 3)
        alpha = np.arange(0, 10 * len(rgb), 10, dtype=np.uint8)[:, None]
        pal.putpalette(np.concatenate([rgb, alpha], 1).reshape(-1).tolist(),
                       "RGBA")
    C.assert_like_pillow(C.pillow_bytes(pal, "BLP", blp_version=version))


def dxt_file(kind: int, w: int, h: int, seed: int, alpha: int = 0) -> bytes:
    size = 8 if kind == 1 else 16
    n = ((w + 3) // 4) * ((h + 3) // 4)
    return C.write_blp2(w, h, C.random_blocks(n, size, seed), alpha=alpha,
                        alpha_encoding=KINDS[kind])


@pytest.mark.parametrize("kind", [1, 3, 5])
@pytest.mark.parametrize("alpha", [0, 1])
@pytest.mark.parametrize("size", [(4, 4), (16, 8), (13, 7), (5, 21),
                                  (1, 1)])
def test_random_dxt_blocks_equal_pillow(kind, alpha, size):
    """Random blocks (DXT1's both palettes, every alpha code) at sizes
    that are and are not multiples of 4: Pillow's Python decoders, the
    sheared read-back of padded rows and, without the alpha flag, three
    bytes read of every four."""
    C.assert_like_pillow(dxt_file(kind, *size, seed=kind * 10 + alpha,
                                  alpha=alpha))


@pytest.mark.parametrize("kind", [1, 3, 5])
def test_encoded_dxt_equals_pillow(kind):
    img = C.sample_image(40, 24, kind)
    C.assert_like_pillow(C.write_blp2(40, 24, C.dxt_blocks(img, kind),
                                      alpha=1, alpha_encoding=KINDS[kind]))


def test_dxt_in_cxx_equals_python():
    """``wpt_blp_dxt`` and ``blp.dxt_plain`` give the same pixels on
    random blocks of every kind, with and without alpha."""
    for kind in (1, 3, 5):
        size = 8 if kind == 1 else 16
        data = b"xyz" + C.random_blocks(6 * 5, size, kind)
        for alpha in (False, True):
            np.testing.assert_array_equal(
                native.blp_dxt_native(data, 3, kind, alpha, 6, 5),
                blp.dxt_plain(data, 3, kind, alpha, 6, 5))


def test_dxt_is_not_the_dds_bc_decoder():
    """The same DXT1 blocks through DDS (Pillow's C ``bcn``, endpoints
    widened) and BLP2 (its Python decoder, endpoints shifted) differ."""
    blocks = C.random_blocks(16, 8, 7)
    dds = C.write_dds(16, 16, blocks, fourcc=b"DXT1", flags=C.DDPF["fourcc"])
    blp2 = C.write_blp2(16, 16, blocks, alpha=1)
    assert not np.array_equal(C.pillow_rgba(dds), C.pillow_rgba(blp2))
    C.assert_like_pillow(blp2)


JPEG = C.pillow_bytes(C.sample_image(24, 16, 3, 3), "JPEG", quality=90)


def jpeg_blp(**kw) -> bytes:
    kw.setdefault("split", 200)
    return C.blp1_jpeg(kw.pop("jpeg", JPEG), kw.pop("w", 24), kw.pop("h", 16),
                       **kw)


BLP1_JPEG = {
    "header_split_0": lambda: jpeg_blp(split=0),
    "header_split_at_sos": lambda: jpeg_blp(split=JPEG.index(b"\xff\xda")),
    "whole_jpeg_in_header": lambda: jpeg_blp(split=len(JPEG)),
    "alpha_flag_reads_bgr": lambda: jpeg_blp(alpha=1),
    "offset_past_the_header": lambda: C.write_blp1(
        24, 16, bytes(30) + JPEG[100:], compression=0,
        jpeg_header=JPEG[:100], offset=28 + 128 + 4 + 100 + 30,
        length=len(JPEG) - 100),
    "offset_inside_the_header": lambda: jpeg_blp(offset=10),
    "jpeg_larger_than_the_blp": lambda: jpeg_blp(w=20, h=9),
    "gray_jpeg": lambda: jpeg_blp(jpeg=C.pillow_bytes(
        C.sample_image(24, 16, 4, 1)[..., 0], "JPEG")),
    "cmyk_jpeg": lambda: jpeg_blp(jpeg=C.pillow_bytes(Image.fromarray(
        C.sample_image(24, 16, 5, 3)).convert("CMYK"), "JPEG")),
    "progressive_jpeg": lambda: jpeg_blp(jpeg=C.pillow_bytes(
        C.sample_image(24, 16, 6, 3), "JPEG", progressive=True)),
}


@pytest.mark.parametrize("case", sorted(BLP1_JPEG))
def test_blp1_jpeg_equals_pillow(case):
    """The shared header and the mipmap joined wherever the header ends or
    the offset points; the RGB read back as "BGR" (red and blue swapped),
    even with the alpha flag set; a JPEG larger than the BLP read as a
    stream at the BLP's width."""
    C.assert_like_pillow(BLP1_JPEG[case]())


def test_ycck_frame_is_read_as_cmyk():
    """Pillow's BLP plugin sets the JPEG mode "CMYK": a YCCK frame is not
    converted, so the BLP differs from the JPEG's own RGB (with red and
    blue swapped back), and the port follows it."""
    data = fixture("jpeg_ycck_as_cmyk_blp1.blp")
    jpeg = C.pillow_rgba(open(f"{C.LDR_DIR}/../jpeg/emissive_ycck_420.jpg",
                              "rb").read())
    want = C.assert_like_pillow(data)
    assert not np.array_equal(want[..., 2::-1], jpeg[..., :3])


@pytest.mark.parametrize("encoding", [4, 5])
@pytest.mark.parametrize("alpha", [0, 3])
def test_blp1_palette_equals_pillow(encoding, alpha):
    colours = C.sample_image(256, 1, 8)[0]
    C.assert_like_pillow(C.write_blp1(
        15, 6, C.sample_image(15, 6, 9, 1).tobytes() + b"extra",
        encoding=encoding, alpha=alpha, palette=C.blp_palette(colours)))


def test_blp2_palette_read_from_the_offset():
    colours = C.sample_image(256, 1, 10)[0]
    idx = C.sample_image(9, 7, 11, 1).tobytes()
    C.assert_like_pillow(C.write_blp2(
        9, 7, bytes(17) + idx, encoding=1, alpha=1,
        palette=C.blp_palette(colours), offset=20 + 128 + 1024 + 17,
        length=len(idx)))


FTEX = {
    "bc1_13x9": lambda: C.write_ftex(13, 9, 0, C.random_blocks(12, 8, 12)),
    "bc1_encoded": lambda: C.write_ftex(16, 8, 0, C.pillow_bytes(
        C.sample_image(16, 8, 13), "DDS", pixel_format="DXT1")[128:]),
    "rgb_at_offset_60": lambda: C.write_ftex(5, 3, 1, C.sample_image(
        5, 3, 14, 3).tobytes(), where=60),
    "negative_size_reads_to_the_end": lambda: C.write_ftex(
        5, 3, 1, C.sample_image(5, 3, 15, 3).tobytes() + b"more", size=-7),
    "size_past_the_end": lambda: C.write_ftex(
        2, 2, 1, bytes(range(12)), size=400),
    "mipmap_longer_than_the_image": lambda: C.write_ftex(
        2, 2, 0, C.random_blocks(3, 8, 16)),
}


@pytest.mark.parametrize("case", sorted(FTEX))
def test_ftex_variants_equal_pillow(case):
    C.assert_like_pillow(FTEX[case]())


REFUSED = {
    "blp2_jpeg_compression": C.write_blp2(4, 4, bytes(16), compression=0),
    "blp2_raw_bgra_encoding_3": C.write_blp2(2, 2, bytes(16), encoding=3),
    "blp2_alpha_encoding_8": C.write_blp2(4, 4, bytes(16), alpha_encoding=8),
    "blp2_palette_cut_short": C.write_blp2(4, 4, b"", palette=bytes(100)),
    "blp2_dxt_cut_short": C.write_blp2(8, 8, bytes(24)),
    "blp2_too_few_indices": C.write_blp2(4, 4, bytes(15), encoding=1),
    "blp2_offset_past_the_end": C.write_blp2(4, 4, bytes(16), encoding=1,
                                             offset=5000),
    "blp1_compression_2": C.write_blp1(2, 2, bytes(4), compression=2),
    "blp1_encoding_3": C.write_blp1(2, 2, bytes(4), encoding=3),
    "blp1_jpeg_too_small": C.blp1_jpeg(JPEG, 30, 20, split=50),
    "blp1_jpeg_garbage": C.write_blp1(4, 4, bytes(40), compression=0,
                                      jpeg_header=b"\xff\xd8\xff\xe0"),
    "blp1_jpeg_header_past_the_end": C.write_blp1(
        4, 4, b"", compression=0)[:156] + struct.pack("<I", 900),
    "blp1_tables_cut_short": C.write_blp1(2, 2, b"")[:100],
    "ftex_two_formats": C.write_ftex(2, 2, 1, bytes(12), formats=2),
    "ftex_format_2": C.write_ftex(2, 2, 2, bytes(12)),
    "ftex_format_2_no_pixels": C.write_ftex(0, 2, 2, bytes(12)),
    "ftex_no_pixels_after_the_file_is_closed": C.write_ftex(3, 0, 1,
                                                            bytes(12)),
    "ftex_negative_offset": C.write_ftex(2, 2, 1, bytes(12), where=-4),
    "ftex_rgb_cut_short": C.write_ftex(4, 4, 1, bytes(47)),
    "ftex_bc1_cut_short": C.write_ftex(8, 8, 0, bytes(31)),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_what_pillow_refuses_raises_naming_the_image(case):
    data = REFUSED[case]
    assert C.pillow_refuses(data)
    C.assert_refused(data, "r.blp", exc=ValueError)


PASSED_ON = {
    "blp2_header_cut_short": b"BLP2" + bytes(12),
    "blp1_header_cut_short": b"BLP1" + bytes(16),
    "blp2_no_pixels": C.write_blp2(0, 4, bytes(16)),
    "ftex_header_cut_short": b"FTEX" + bytes(16),
    "ftex_offset_past_the_end": b"FTEX" + struct.pack("<7i", 1, 2, 2, 1, 1,
                                                      1, 900),
}


@pytest.mark.parametrize("case", sorted(PASSED_ON))
def test_headers_pillow_passes_on_are_passed_on(case):
    """Pillow's ``_open`` raises ``struct.error`` (or its size check a
    ``SyntaxError``): no other format takes the bytes, and both raise
    that no format does."""
    data = PASSED_ON[case]
    with pytest.raises(Exception, match="cannot identify"):
        C.pillow_rgba(data)
    C.assert_refused(data, "p.blp", exc=ValueError,
                     match="not an image Pillow can identify")


def test_blp_and_ftex_are_tried_by_their_signatures():
    assert list(sniff.pillow_candidates(fixture("dxt3.blp"))) == [
        "BLP", *C.ANY_BYTES, "TGA"]
    assert list(sniff.pillow_candidates(fixture("rgb.ftu"))) == [
        "FTEX", *C.ANY_BYTES, "TGA"]


@settings(max_examples=40, deadline=None)
@given(w=st.integers(1, 30), h=st.integers(1, 30),
       kind=st.sampled_from([1, 3, 5]), alpha=st.booleans(),
       seed=st.integers(0, 2 ** 16))
def test_hypothesis_blp_dxt(w, h, kind, alpha, seed):
    C.assert_like_pillow(dxt_file(kind, w, h, seed, int(alpha)))


def test_a_failed_native_build_raises(monkeypatch):
    def fail(cxx=None):
        raise RuntimeError("g++ failed to build the native library")

    monkeypatch.setattr(native._Lib, "handle", None)
    monkeypatch.setattr(native, "build", fail)
    monkeypatch.setattr(native, "native_available", lambda: True)
    with pytest.raises(RuntimeError, match="failed to build"):
        IMAGE.decode_image_rgba(fixture("dxt3.blp"), "a.blp")


@pytest.mark.parametrize("name", ["dxt5_18x10_sheared.blp", "jpeg_blp1.blp",
                                  "palette_alpha_blp1.blp", "bc1_random.ftc",
                                  "rgb.ftu"])
def test_jax_decode_image_equals_port(name):
    """The JAX glTF loader's ``_decode_image`` (Pillow's RGBA) of a BLP or
    FTEX atlas image equals the port's."""
    data = fixture(name)
    np.testing.assert_array_equal(IMAGE.decode_image_rgba(data, name),
                                  JG._decode_image(data))


@pytest.mark.parametrize("name", ["env_dxt1.blp", "jpeg_blp1.blp", "rgb.ftu"])
@pytest.mark.parametrize("in_cxx", [True, False])
def test_blp_ftex_env_map_equals_jax(name, in_cxx, tmp_path, monkeypatch):
    """``read_png`` and ``load_env_image`` of a BLP or FTEX map (named
    .png: the bytes decide) equal the JAX package's."""
    if not in_cxx:
        monkeypatch.setattr(native, "native_available", lambda: False)
    path = str(tmp_path / "sky.png")
    with open(path, "wb") as f:
        f.write(fixture(name))
    np.testing.assert_array_equal(IMAGE.read_png(path), JIMAGE.read_png(path))
    np.testing.assert_array_equal(ENV.load_env_image(path),
                                  JENV.load_env_image(path))


@pytest.mark.parametrize("ratio", [0.5, 1.0])
def test_legacy_sidecars_build_the_jax_atlas(ratio, tmp_path):
    """``textured_cornell()`` as a .gltf whose four textures are the
    sidecars ``chip_smoke.LEGACY_TEXTURES`` (a sheared DXT5 BLP2, a BLP1
    JPEG, an it32 ICNS with its mask, an XPM): the port's atlas equals the
    JAX ``build_atlas``'s."""
    for name in LEGACY_TEXTURES:
        (tmp_path / name).write_bytes(fixture(name))
    path = tmp_path / "textured.gltf"
    path.write_text(with_sidecar_images(scene_to_glb(textured_cornell()),
                                        list(LEGACY_TEXTURES)))
    assert len(json.loads(path.read_text())["images"]) == 4
    got, got_rects = G.build_atlas(G.GLTFFile.load(str(path)), ratio)
    want, want_rects = JG.build_atlas(JG.GLTFFile.load(str(path)), ratio)
    np.testing.assert_array_equal(got, want)
    assert got_rects == want_rects


@pytest.mark.parametrize("name", [n for n, _ in LEGACY_ENV_MAPS])
def test_card_env_maps_equal_jax(name, tmp_path):
    """``load_env_image`` of the card's legacy env maps equals the JAX
    package's."""
    path = str(tmp_path / "sky.png")
    with open(path, "wb") as f:
        f.write(fixture(name))
    np.testing.assert_array_equal(ENV.load_env_image(path),
                                  JENV.load_env_image(path))


def test_large_blp_equals_pillows_digest():
    """The 4096x2048 DXT5 BLP2 timing file ``chip_smoke.py`` makes with the
    test suite's writer decodes, in C++, to the array whose SHA-256 Pillow
    gave (``pillow_sha256.json``: the card's host has no Pillow)."""
    with open(f"{C.LDR_DIR}/pillow_sha256.json") as f:
        want = json.load(f)[C.LARGE_BLP]
    got = C.decode_in(True, C.large_blp())
    assert hashlib.sha256(got.tobytes()).hexdigest() == want


def test_pillow_reads_the_dxt_stream_at_the_image_width():
    """What the sheared fixture shows: the padded block rows read back at
    the image's width, not cropped."""
    data = fixture("dxt5_18x10_sheared.blp")
    img = C.sample_image(20, 12, 48)
    blocks = C.write_blp2(20, 12, C.dxt_blocks(img, 5), alpha=8,
                          alpha_encoding=7)
    full = C.pillow_rgba(blocks)
    got = C.pillow_rgba(data)
    np.testing.assert_array_equal(got.reshape(-1, 4),
                                  full.reshape(-1, 4)[:18 * 10])
    assert not np.array_equal(got, full[:10, :18])


def test_jpeg_blp_swaps_red_and_blue():
    data = fixture("jpeg_blp1.blp")
    rgb = C.sample_image(40, 24, 42, 3)
    jpeg = C.pillow_rgba(C.pillow_bytes(rgb, "JPEG", quality=90))
    np.testing.assert_array_equal(C.pillow_rgba(data)[..., :3],
                                  jpeg[..., 2::-1])
    assert Image.open(io.BytesIO(data)).mode == "RGB"
