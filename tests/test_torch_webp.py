"""The port's WebP reader (``utils/webp.py``) against Pillow 12.1.0 with
libwebp 1.6.0, which the JAX package reads LDR images with.

Every case is held array-equal to ``Image.open(...).convert("RGBA")``, and
decoded twice: with the C++ loops (``accel/cbvh/webp_scan.cpp``) and with
their plain Python versions. The files come from Pillow's writer, from
Pillow's own libwebp driven through its advanced API
(``tests/torch_image_cases.py::libwebp_encode``: the simple loop filter,
several token partitions, segments, sharp YUV, the alpha options), and
from this suite's own VP8L and ALPH writers, which reach each VP8L
transform, every predictor mode, palette bundling, the colour cache and
each alpha filter on its own. What Pillow refuses, the port refuses.
"""

import hashlib
import io
import json
import struct

import numpy as np
import pytest
import torch
from PIL import Image

from chip_smoke import WEBP_GIF_TEXTURES, with_sidecar_images
from wgpu_path_tracing_tpu.models import gltf as JG
from wgpu_path_tracing_tpu.ops import env as JENV
from wgpu_path_tracing_tpu.utils import image as JIMAGE
from wgpu_path_tracing_tpu_torch import scene_to_glb, textured_cornell
from wgpu_path_tracing_tpu_torch.accel import native
from wgpu_path_tracing_tpu_torch.models import gltf as G
from wgpu_path_tracing_tpu_torch.ops import env as ENV
from wgpu_path_tracing_tpu_torch.utils import image as IMAGE
from wgpu_path_tracing_tpu_torch.utils import sniff, webp
from tests import torch_image_cases as C

torch.set_num_threads(1)

FIXTURES = np.load(f"{C.LDR_DIR}/pillow_rgba.npz")
WEBP_FILES = sorted(n for n in FIXTURES.files if n.endswith(".webp"))
RGBA = C.sample_image(37, 21, 1)


def fixture(name: str) -> bytes:
    with open(f"{C.LDR_DIR}/{name}", "rb") as f:
        return f.read()


def pillow_mode(data: bytes) -> str:
    with Image.open(io.BytesIO(data)) as im:
        return im.mode


@pytest.mark.parametrize("name", WEBP_FILES)
def test_committed_webp_files_equal_pillow(name):
    """The files under ``tests/ldr`` decode to ``pillow_rgba.npz``, which
    Pillow here still gives."""
    np.testing.assert_array_equal(C.assert_like_pillow(fixture(name), name),
                                  FIXTURES[name])


def test_large_lossy_webp_matches_its_digest():
    """The committed 4096x2048 lossy WebP with alpha: the C++ decode's
    SHA-256 is the committed one of Pillow's decode, which Pillow here
    still gives."""
    data = fixture(C.LARGE_WEBP)
    with open(f"{C.LDR_DIR}/pillow_sha256.json") as f:
        want = json.load(f)[C.LARGE_WEBP]
    got = C.decode_in(True, data, C.LARGE_WEBP)
    assert got.shape == (2048, 4096, 4)
    assert hashlib.sha256(got.tobytes()).hexdigest() == want
    assert hashlib.sha256(C.pillow_rgba(data).tobytes()).hexdigest() == want


TRANSFORMS = [(), ("subtract_green",), ("predictor",), ("cross_color",),
              ("subtract_green", "predictor", "cross_color"),
              ("cross_color", "predictor", "subtract_green")]


@pytest.mark.parametrize("cache", [0, 1, 6, 11])
@pytest.mark.parametrize("transforms", TRANSFORMS,
                         ids=lambda t: "+".join(t) or "none")
def test_vp8l_transforms_and_colour_cache(transforms, cache):
    """Each VP8L transform alone and all together, in either order, with
    the colour cache off or at 1, 6 and 11 bits (this suite's writer)."""
    data = C.write_vp8l(RGBA, transforms=transforms, cache=cache,
                        seed=cache, bits=2 + cache % 3)
    C.assert_like_pillow(data)


@pytest.mark.parametrize("mode", range(14))
def test_vp8l_every_predictor_mode(mode):
    """Every predictor mode, 0-13, in every tile, after subtract-green."""
    data = C.write_vp8l(C.sample_image(23, 17, mode),
                        transforms=("subtract_green", "predictor"), mode=mode)
    C.assert_like_pillow(data)


@pytest.mark.parametrize("colours", [2, 3, 4, 5, 16, 17, 256])
@pytest.mark.parametrize("cache", [0, 4])
def test_vp8l_palette_bundling(colours, cache):
    """Colour indexing at 2 colours (8 pixels a byte), 3-4 (4), 5-16 (2)
    and more (1), odd widths, with and without the colour cache and a
    predictor on the indices."""
    rng = np.random.default_rng(colours)
    pal = rng.integers(0, 256, (colours, 4)).astype(np.uint8)
    idx = np.arange(21 * 37).reshape(21, 37) % colours
    idx = np.where(rng.random(idx.shape) < 0.3, rng.integers(0, colours,
                                                             idx.shape), idx)
    img = pal[idx]
    C.assert_like_pillow(C.write_vp8l(img, transforms=("palette",),
                                      cache=cache))
    C.assert_like_pillow(C.write_vp8l(img, transforms=("palette", "predictor"),
                                      cache=cache, seed=1))


def test_alpha_is_used_bit_cleared():
    """A VP8L stream with alpha below 255 whose header clears
    ``alpha_is_used``: Pillow opens it as "RGB", so alpha is 255."""
    for data in (C.write_vp8l(RGBA, alpha_used=False,
                              transforms=("subtract_green",)),
                 C.write_vp8l(RGBA, alpha_used=False)):
        assert pillow_mode(data) == "RGB"
        got = C.assert_like_pillow(data)
        assert (got[..., 3] == 255).all() and (RGBA[..., 3] < 255).any()
        np.testing.assert_array_equal(got[..., :3], RGBA[..., :3])


@pytest.mark.parametrize("lossless", [True, False])
@pytest.mark.parametrize("method", [0, 3, 6])
@pytest.mark.parametrize("quality", [0, 50, 100])
def test_pillow_written_webp(quality, method, lossless):
    """Pillow's writer at its qualities and methods, lossy and lossless,
    RGB and RGBA."""
    for img in (RGBA, C.sample_image(40, 24, 2, 3)):
        C.assert_like_pillow(C.pillow_bytes(img, "WEBP", quality=quality,
                                            method=method, lossless=lossless))


@pytest.mark.parametrize("quality", [1.0, 20.0, 60.0, 90.0, 100.0])
@pytest.mark.parametrize("sharp", [0, 1])
def test_vp8_qualities_and_sharp_yuv(quality, sharp):
    C.assert_like_pillow(C.libwebp_encode(C.sample_image(33, 19, 5),
                                          quality=quality,
                                          use_sharp_yuv=sharp))


@pytest.mark.parametrize("size", [(1, 1), (1, 13), (13, 1), (17, 23),
                                  (2, 33), (16, 16), (31, 2)])
@pytest.mark.parametrize("lossless", [0, 1])
def test_odd_sizes(size, lossless):
    """1x1, 1xN, Nx1 and odd sizes: partial macroblocks, the fancy
    upsampler's first and last row pairs, odd widths and heights."""
    img = C.sample_image(*size, 6)
    C.assert_like_pillow(C.libwebp_encode(img, lossless=lossless))


def random_options(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return dict(
        quality=float(rng.integers(0, 101)), method=int(rng.integers(0, 7)),
        segments=int(rng.integers(1, 5)),
        sns_strength=int(rng.integers(0, 101)),
        filter_strength=int(rng.integers(0, 101)),
        filter_sharpness=int(rng.integers(0, 8)),
        filter_type=int(rng.integers(0, 2)),
        autofilter=int(rng.random() < 0.3),
        alpha_compression=int(rng.integers(0, 2)),
        alpha_filtering=int(rng.integers(0, 3)),
        alpha_quality=int(rng.integers(0, 101)),
        partitions=int(rng.integers(0, 4)),
        preprocessing=int(rng.integers(0, 3)),
        use_sharp_yuv=int(rng.integers(0, 2)))


@pytest.mark.parametrize("seed", range(16))
def test_libwebp_options_pillow_never_sets(seed):
    """Seeded random libwebp configurations: the simple loop filter (type
    0), 1-8 token partitions, 1-4 segments, filter levels and sharpness,
    the alpha options; seeded image content, alpha sometimes binary."""
    rng = np.random.default_rng(100 + seed)
    w, h = int(rng.integers(1, 48)), int(rng.integers(1, 40))
    img = C.sample_image(w, h, seed)
    if seed % 3 == 0:
        img[..., 3] = (img[..., 3] > 128) * 255
    opts = random_options(seed)
    C.assert_like_pillow(C.libwebp_encode(img, **opts), f"options {opts}")


@pytest.mark.parametrize("compressed", [False, True], ids=["raw", "vp8l"])
@pytest.mark.parametrize("filt", [0, 1, 2, 3],
                         ids=["none", "horizontal", "vertical", "gradient"])
def test_alph_filters(filt, compressed):
    """An ALPH chunk raw or VP8L-compressed under each filter."""
    lossy = C.libwebp_encode(C.sample_image(19, 11, 2), alpha_compression=0)
    alpha = C.sample_image(19, 11, 9)[..., 3]
    data = C.with_alph(lossy, C.write_alph(alpha, filt, compressed), 19, 11)
    np.testing.assert_array_equal(C.assert_like_pillow(data)[..., 3], alpha)


@pytest.mark.parametrize("option", [dict(alpha_quality=0),
                                    dict(alpha_quality=40),
                                    dict(alpha_filtering=2),
                                    dict(alpha_filtering=0),
                                    dict(alpha_compression=0,
                                         alpha_filtering=2)])
def test_libwebp_alpha_options(option):
    C.assert_like_pillow(C.libwebp_encode(RGBA, **option))


@pytest.mark.parametrize("header", [0x10, 0x20, 0x30, 0x40, 0x02, 0x03],
                         ids=["pre1", "pre2", "pre3", "reserved", "method2",
                              "method3"])
def test_alph_header_fields(header):
    """The pre-processing field 1 is read (and ignored); 2 and 3, a
    reserved bit and compression methods 2 and 3 are refused."""
    lossy = C.libwebp_encode(C.sample_image(9, 7, 2), alpha_compression=0)
    raw = C.write_alph(C.sample_image(9, 7, 3)[..., 3], 0, False)
    data = C.with_alph(lossy, bytes([header]) + raw[1:], 9, 7)
    if header == 0x10:
        C.assert_like_pillow(data)
    else:
        assert C.pillow_refuses(data)
        C.assert_refused(data, "a.webp")


def test_unknown_chunks_do_not_touch_the_pixels():
    """ICCP, EXIF and XMP chunks (Pillow does not apply the profile on
    ``convert``), and an unknown chunk after the image, leave the pixels
    as they are without them."""
    plain = C.pillow_bytes(RGBA, "WEBP")
    meta = C.pillow_bytes(RGBA, "WEBP", icc_profile=bytes(range(200)),
                          exif=b"Exif\0\0II*\0\x08\0\0\0\0\0",
                          xmp=b"<x:xmpmeta/>")
    chunks = [f for f, _ in C.riff_chunks(meta)]
    assert chunks[0] == b"VP8X" and {b"ICCP", b"EXIF", b"XMP "} <= set(chunks)
    want = C.assert_like_pillow(plain)
    np.testing.assert_array_equal(C.assert_like_pillow(meta), want)
    extra = C.riff([C.chunk(f, p) for f, p in C.riff_chunks(plain)]
                   + [C.chunk(b"ZZZZ", b"odd")])
    np.testing.assert_array_equal(C.assert_like_pillow(extra), want)


@pytest.mark.parametrize("lossless", [False, True])
def test_pillow_animation_first_frame(lossless):
    """Pillow's animated writer: the first frame, as WebPAnimDecoder
    composes it."""
    frames = [Image.fromarray(C.sample_image(37, 21, k)) for k in range(3)]
    buf = io.BytesIO()
    frames[0].save(buf, "WEBP", save_all=True, append_images=frames[1:],
                   duration=40, lossless=lossless)
    data = buf.getvalue()
    assert b"ANMF" in data
    C.assert_like_pillow(data)


@pytest.mark.parametrize("flags", [0x12, 0x02], ids=["alpha", "no_alpha"])
@pytest.mark.parametrize("lossless", [0, 1])
def test_animation_first_frame_at_an_offset(flags, lossless):
    """A first frame smaller than the canvas, at an even offset: the
    canvas is transparent black elsewhere, or (without the VP8X alpha flag,
    Pillow's "RGB") opaque black."""
    still = C.libwebp_encode(C.sample_image(9, 7, 3), lossless=lossless)
    data = C.write_animated_webp([(4, 6, still, 50, 0),
                                  (0, 0, C.libwebp_encode(
                                      C.sample_image(20, 17, 4)), 50, 2)],
                                 (20, 17), flags=flags)
    got = C.assert_like_pillow(data)
    assert (got[:6, :, :3] == 0).all()
    assert (got[:6, :, 3] == (0 if flags & 0x10 else 255)).all()


def test_anmf_size_fields_give_way_to_the_bitstream():
    """WebPDemux takes a frame's size from its bitstream, not from the
    ANMF chunk's own width and height fields."""
    still = C.libwebp_encode(C.sample_image(9, 7, 3))
    data = bytearray(C.write_animated_webp([(4, 6, still, 50, 0)], (20, 17)))
    at = data.index(b"ANMF") + 8 + 6
    data[at:at + 6] = (2).to_bytes(3, "little") + (40).to_bytes(3, "little")
    C.assert_like_pillow(bytes(data))


def _refusals() -> dict:
    good = C.pillow_bytes(RGBA, "WEBP")
    lossless = C.pillow_bytes(RGBA, "WEBP", lossless=True)
    vp8 = next(p for f, p in C.riff_chunks(C.pillow_bytes(
        C.sample_image(9, 7, 1, 3), "WEBP")) if f == b"VP8 ")
    still = C.libwebp_encode(C.sample_image(9, 7, 3))
    alph = C.write_alph(C.sample_image(9, 7, 3)[..., 3], 0, False)
    out = {
        "truncated": good[:-9],
        "riff_size_past_the_end": good[:4] + struct.pack("<I", len(good))
        + good[8:],
        "riff_size_too_small": good[:4] + struct.pack("<I", 4) + good[8:],
        "junk_inside_the_riff": good[:4] + struct.pack(
            "<I", len(good) - 2) + good[8:] + b"ABCDEF",
        "chunk_past_the_riff": C.riff([C.chunk(b"VP8 ", vp8)[:-4]]),
        "canvas_differs": C.riff([C.vp8x(10, 7, 0), C.chunk(b"VP8 ", vp8)]),
        "reserved_vp8x_flag": C.riff([C.vp8x(9, 7, 0x01),
                                      C.chunk(b"VP8 ", vp8)]),
        "alph_after_image": C.riff([C.vp8x(9, 7, 0x10), C.chunk(b"VP8 ", vp8),
                                    C.chunk(b"ALPH", alph)]),
        "vp8l_after_alph": C.riff([C.vp8x(37, 21, 0x10),
                                   C.chunk(b"ALPH", alph)] + [
            C.chunk(f, p) for f, p in C.riff_chunks(lossless)]),
        "two_images": C.riff([C.vp8x(9, 7, 0), C.chunk(b"VP8 ", vp8),
                              C.chunk(b"VP8 ", vp8)]),
        "bad_vp8_signature": C.riff([C.chunk(b"VP8 ", vp8[:3] + b"\x9d\x01\x2b"
                                             + vp8[6:])]),
        "vp8_partition_cut": C.riff([C.chunk(b"VP8 ", vp8[:16])]),
        "bad_vp8l_signature": C.riff([C.chunk(b"VP8L", b"\x2e" + next(
            p for f, p in C.riff_chunks(lossless) if f == b"VP8L")[1:])]),
        "vp8l_cut": C.riff([C.chunk(b"VP8L", next(
            p for f, p in C.riff_chunks(lossless) if f == b"VP8L")[:40])]),
        "frame_outside_canvas": C.write_animated_webp(
            [(14, 6, still, 50, 0)], (20, 17)),
        "anmf_before_anim": C.riff([C.vp8x(20, 17, 0x12), C.chunk(
            b"ANMF", bytes(16) + C.image_chunks(still))]),
        "animation_without_frames": C.riff([
            C.vp8x(20, 17, 0x12), C.chunk(b"ANIM", bytes(6))]),
    }
    return out


REFUSALS = _refusals()


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_what_pillow_refuses_the_port_refuses(case):
    """Truncated files, bad RIFF and chunk sizes, container rules
    WebPDemux enforces, bad VP8 and VP8L headers and cut bitstreams:
    Pillow raises, and so does the port (``ValueError`` naming the
    file)."""
    data = REFUSALS[case]
    assert C.pillow_refuses(data), case
    C.assert_refused(data, "r.webp")


def test_webp_reaches_its_reader_exactly_when_pillow_says_webp(monkeypatch):
    """Pillow tries WEBP after TGA: a RIFF header fails TGA's colour-map
    check (byte 1 is "I"), so the port's walk reaches the WebP reader, for
    every committed WebP file and every refusal whose first chunk Pillow's
    ``_accept`` takes; Pillow reports format "WEBP" for each it opens."""
    seen = []
    real = webp.decode_webp_rgba

    def spy(data, name="image"):
        seen.append(name)
        return real(data, name)

    monkeypatch.setattr(webp, "decode_webp_rgba", spy)
    for name in WEBP_FILES:
        data = fixture(name)
        assert list(sniff.pillow_candidates(data)) == [*C.ANY_BYTES, "TGA",
                                                      "WEBP"]
        with Image.open(io.BytesIO(data)) as im:
            assert im.format == "WEBP"
        IMAGE.decode_image_rgba(data, name)
        assert seen[-1] == name
    assert "WEBP" not in sniff.pillow_candidates(
        b"RIFF\0\0\0\0WEBPVP8Z" + bytes(20))


@pytest.mark.parametrize("seed", range(8))
def test_the_loops_agree_on_corrupt_streams(seed):
    """The C++ and Python loops on corrupt VP8 and VP8L data (a valid
    stream with bytes changed past its header): the same status and, where
    it decodes, the same planes."""
    rng = np.random.default_rng(seed)
    lossy = next(p for f, p in C.riff_chunks(C.libwebp_encode(
        C.sample_image(21, 18, seed), partitions=seed % 4)) if f == b"VP8 ")
    lossless = next(p for f, p in C.riff_chunks(C.pillow_bytes(
        C.sample_image(21, 18, seed), "WEBP", lossless=True))
        if f == b"VP8L")
    for _ in range(6):
        bad = bytearray(lossy)
        for _ in range(3):
            bad[int(rng.integers(10, len(bad)))] = int(rng.integers(0, 256))
        want = webp.vp8_plain(bytes(bad), 21, 18)
        got = native.vp8_native(bytes(bad), 21, 18)
        assert got[3] == want[3]
        if not want[3]:
            for a, b in zip(got[:3], want[:3]):
                np.testing.assert_array_equal(a, b)
        bad = bytearray(lossless)
        for _ in range(2):
            bad[int(rng.integers(5, len(bad)))] ^= 1 << int(rng.integers(0, 8))
        want = webp.vp8l_plain(bytes(bad), 40, 21, 18)
        got = native.vp8l_native(bytes(bad), 40, 21, 18)
        assert got[1] == want[1]
        if not want[1]:
            np.testing.assert_array_equal(got[0], want[0])


def test_the_upsampler_and_unfilter_loops_agree():
    """``wpt_yuv_to_rgb`` and ``wpt_alpha_unfilter`` equal their plain
    versions on random planes of odd and even sizes."""
    rng = np.random.default_rng(5)
    for w, h in ((1, 1), (7, 5), (8, 6), (33, 18)):
        Y = rng.integers(0, 256, (h + 16, w + 16), dtype=np.uint8)
        U = rng.integers(0, 256, ((h + 1) // 2 + 8, (w + 1) // 2 + 8),
                         dtype=np.uint8)
        V = rng.integers(0, 256, U.shape, dtype=np.uint8)
        np.testing.assert_array_equal(native.yuv_to_rgb_native(Y, U, V, w, h),
                                      webp.yuv_to_rgb_plain(Y, U, V, w, h))
        rows = rng.integers(0, 256, (h, w), dtype=np.uint8)
        for method in range(4):
            np.testing.assert_array_equal(
                native.alpha_unfilter_native(rows, method),
                webp.unfilter_plain(rows, method))


@pytest.mark.parametrize("name", ["lossy_alpha.webp", "lossless_rgba.webp",
                                  "animated_offset.webp"])
def test_a_failed_native_build_raises(monkeypatch, name):
    """Where ``g++`` is on ``PATH`` the WebP loops run in C++; a library
    that fails to build raises, and the decode does not fall back to
    Python."""
    def fail(cxx=None):
        raise RuntimeError("g++ failed to build the native library")

    monkeypatch.setattr(native._Lib, "handle", None)
    monkeypatch.setattr(native, "build", fail)
    monkeypatch.setattr(native, "native_available", lambda: True)
    with pytest.raises(RuntimeError, match="failed to build"):
        IMAGE.decode_image_rgba(fixture(name), name)


# --- against the JAX package --------------------------------------------------


@pytest.mark.parametrize("name", ["env_lossy.webp", "lossy_alpha.webp",
                                  "lossless_rgba.webp",
                                  "animated_offset.webp"])
@pytest.mark.parametrize("in_cxx", [True, False])
def test_webp_maps_equal_jax(name, in_cxx, tmp_path, monkeypatch):
    """``read_png`` and ``load_env_image`` of a WebP map (named .png: the
    bytes decide) equal the JAX package's, which reads it with Pillow."""
    if not in_cxx:
        monkeypatch.setattr(native, "native_available", lambda: False)
    path = str(tmp_path / "sky.png")
    with open(path, "wb") as f:
        f.write(fixture(name))
    np.testing.assert_array_equal(IMAGE.read_png(path), JIMAGE.read_png(path))
    np.testing.assert_array_equal(ENV.load_env_image(path),
                                  JENV.load_env_image(path))


@pytest.mark.parametrize("name", WEBP_FILES)
def test_texture_decode_equals_jax(name):
    """The JAX glTF loader's ``_decode_image`` (Pillow's RGBA) of each
    committed WebP file equals ``decode_image_rgba``."""
    data = fixture(name)
    np.testing.assert_array_equal(IMAGE.decode_image_rgba(data, name),
                                  JG._decode_image(data))


@pytest.mark.parametrize("ratio", [0.5, 1.0])
def test_webp_and_gif_sidecars_build_the_jax_atlas(ratio, tmp_path):
    """``textured_cornell()`` written to a .gltf whose four texture slots
    are the sidecar files ``chip_smoke.WEBP_GIF_TEXTURES`` (a lossy WebP
    with alpha, a lossless WebP, a GIF with a transparency index, a lossy
    WebP with VP8L alpha): the port's atlas equals the JAX
    ``build_atlas``'s."""
    for name in WEBP_GIF_TEXTURES:
        (tmp_path / name).write_bytes(fixture(name))
    path = tmp_path / "textured.gltf"
    path.write_text(with_sidecar_images(scene_to_glb(textured_cornell()),
                                        list(WEBP_GIF_TEXTURES)))
    got, got_rects = G.build_atlas(G.GLTFFile.load(str(path)), ratio)
    want, want_rects = JG.build_atlas(JG.GLTFFile.load(str(path)), ratio)
    np.testing.assert_array_equal(got, want)
    assert got_rects == want_rects
    assert sum(r[2] > 0 for rects in got_rects for r in rects.values()) == 4


def _cut_alpha_cases() -> dict:
    """Lossy files whose compressed ALPH stream (libwebp's own, a palette
    of a few levels: its 8-bit alpha path) lost 1 to 5 bytes."""
    rng = np.random.default_rng(31)
    out = {}
    for i in range(14):
        w, h = int(rng.integers(3, 40)), int(rng.integers(2, 24))
        img = C.sample_image(w, h, i)
        img[..., 3] = np.sort(rng.integers(0, 6, (h, w)) * 40, axis=1)
        still = C.libwebp_encode(img, alpha_compression=1,
                                 alpha_filtering=int(rng.integers(0, 3)))
        alph = next(p for f, p in C.riff_chunks(still) if f == b"ALPH")
        for cut in range(1, 6):
            out[f"{i}_{cut}"] = C.with_alph(still, alph[:-cut], w, h)
    return out


CUT_ALPHA = _cut_alpha_cases()


@pytest.mark.parametrize("case", sorted(CUT_ALPHA))
def test_alpha_overrun_on_the_8_bit_path_as_libwebp(case):
    """libwebp's 8-bit alpha path (one colour-indexing transform, no cache,
    one-symbol red, blue and alpha codes) checks the stream's end after
    each symbol and fails only where pixels are left; the last symbols
    read past the end through its 64-bit window (wrapping, then from the
    window's start). Pillow reads some of these files and refuses others;
    the port does the same, in C++ and in Python."""
    data = CUT_ALPHA[case]
    if C.pillow_refuses(data):
        C.assert_refused(data, "a.webp")
    else:
        C.assert_like_pillow(data, "a.webp")


def test_some_cut_alpha_streams_read():
    assert sum(not C.pillow_refuses(d) for d in CUT_ALPHA.values()) >= 5


@pytest.mark.parametrize("extra", [1, 2, 6])
@pytest.mark.parametrize("inside", [True, False])
def test_a_vp8x_chunk_longer_than_10_bytes_is_refused(extra, inside):
    """A ``VP8X`` chunk of more than 10 bytes, its trailing bytes inside
    the chunk or only claimed by its size: Pillow 12.1.0 fails to make
    its decoder ("could not create decoder object"), and the port
    refuses it."""
    body = bytes([0x10, 0, 0, 0]) + (36).to_bytes(3, "little") + (
        20).to_bytes(3, "little")
    still = C.write_vp8l(RGBA)
    image = [C.chunk(f, p) for f, p in C.riff_chunks(still)]
    if inside:
        data = C.riff([C.chunk(b"VP8X", body + bytes(extra))] + image)
    else:
        raw = b"VP8X" + struct.pack("<I", 10 + extra) + body + b"".join(image)
        data = b"RIFF" + struct.pack("<I", 4 + len(raw)) + b"WEBP" + raw
    assert C.pillow_refuses(data)
    C.assert_refused(data, "x.webp", ValueError, "WebPDemux refuses")
