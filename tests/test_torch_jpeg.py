"""The port's JPEG reader (``utils/jpeg.py``) against Pillow, and JPEG
textures and environment maps against the JAX package, which reads them
with Pillow.

Every baseline case is held array-equal to ``Image.open(...).convert(
"RGBA")``: Pillow decodes with libjpeg-turbo at its defaults (the integer
IDCT, fancy upsampling, the fixed-point YCbCr tables), which the reader
copies. Pillow writes 4:4:4, 4:2:2 and 4:2:0 only, in one interleaved
scan; ``tests/torch_jpeg_cases.py`` writes the rest (4:4:0, 4:1:1, mixed
factors, one scan a component, 16-bit tables, Adobe RGB, restart intervals
on any MCU count), which Pillow then decodes as the reference.
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
from wgpu_path_tracing_tpu_torch.utils.jpeg import decode_jpeg_rgba
from tests import torch_jpeg_cases as JC
from tests.test_torch_env import EnvOracle, _oracle_mean

torch.set_num_threads(1)

SIZES = [(1, 1), (7, 13), (17, 33), (100, 75), (256, 256)]
QUALITIES = (10, 75, 95, 100)


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


def assert_like_pillow(data: bytes) -> None:
    np.testing.assert_array_equal(decode_jpeg_rgba(data, "case"),
                                  pillow_rgba(data))


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


def test_progressive_cmyk_and_truncated_raise_naming_the_image():
    img = photo(16, 16)
    with pytest.raises(NotImplementedError, match="sky.jpg: progressive"):
        decode_jpeg_rgba(pillow_jpeg(img, progressive=True), "sky.jpg")
    with pytest.raises(NotImplementedError, match="ink.jpg: 4-component"):
        decode_jpeg_rgba(pillow_jpeg(img.convert("CMYK")), "ink.jpg")
    data = pillow_jpeg(photo(64, 64), quality=90)
    for cut in (len(data) // 2, len(data) - 40, 300):
        with pytest.raises(ValueError, match="cut.jpg: truncated"):
            decode_jpeg_rgba(data[:cut], "cut.jpg")
    sof = data.index(b"\xff\xc0")
    arithmetic = data[:sof + 1] + b"\xc9" + data[sof + 2:]
    with pytest.raises(NotImplementedError, match="a.jpg: arithmetic"):
        decode_jpeg_rgba(arithmetic, "a.jpg")
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


@pytest.mark.parametrize("ratio", [0.5, 1.0])
def test_jpeg_textures_build_the_jax_atlas(tmp_path, ratio):
    """``textured_cornell()`` written to a .gltf whose images are JPEGs
    (4:2:0, gray with custom tables, 4:4:4 with restart markers; one
    declared image/png, the others with no MIME type): the port's atlas
    equals the JAX ``build_atlas``'s, which decodes with Pillow."""
    jpegs = [pillow_jpeg(photo(37, 21), quality=85),
             pillow_jpeg(photo(16, 16, 1).convert("L"), optimize=True),
             pillow_jpeg(photo(9, 30, 2), subsampling=0,
                         restart_marker_blocks=1)]
    gltf = json.loads(with_jpeg_images(scene_to_glb(textured_cornell()),
                                       jpegs))
    assert len(gltf["images"]) >= 2
    gltf["images"][0]["mimeType"] = "image/png"
    path = tmp_path / "textured.gltf"
    path.write_text(json.dumps(gltf))
    got, got_rects = G.build_atlas(G.GLTFFile.load(str(path)), ratio)
    want, want_rects = JG.build_atlas(JG.GLTFFile.load(str(path)), ratio)
    np.testing.assert_array_equal(got, want)
    assert got_rects == want_rects


def test_jpeg_env_map_equals_jax_and_renders_like_it(tmp_path):
    """A JPEG map named .png: ``load_env_image`` equals the JAX one
    (Pillow), and a 24x24, 2-spp render of the open material box under it,
    set through ``RenderConfig.env_map``, is held to the JAX ``Renderer``
    with the bars of ``tests/test_torch_env.py``: >= 99% of pixels within
    5e-4 of the JAX image or, where not, within 2e-3 of the scalar
    oracle's mean, at most 5 off both, the means within 1e-3."""
    rng = np.random.default_rng(9)
    sky = (rng.random((32, 64, 3)) * 255).astype(np.uint8)
    path = str(tmp_path / "sky.png")
    with open(path, "wb") as f:
        f.write(pillow_jpeg(Image.fromarray(sky), quality=80))
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
