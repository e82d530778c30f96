"""The port's Renderer, tonemap and image output against the JAX package.

The golden fixture tests/goldens/cornell_48x48_8spp.{npz,png} was rendered
by the JAX package on XLA:CPU. The port renders the same samples with
per-operation rounding, which the scalar oracle tests/oracle.py shares and
XLA:CPU's fused multiply-adds do not (tests/test_torch_parity.py). So 166
of the 2304 pixels land outside rtol/atol 5e-4 of the golden: a last-ulp
difference flips a shadow test now and then (a shadow ray aimed at the
light must stop short of it by t_max = dist - 2e-6, a margin of a few
ulps), and a flipped test adds or drops a whole light sample. Each such
pixel is arbitrated by the oracle's own 8-frame mean: the port agrees with
it at rtol/atol 2e-3 (tests/test_parity.py's bar) on 163 of the 166, the
golden on 119. The HDR bar is therefore >= 99% of pixels within 5e-4 of
the golden or, where not, of the oracle, and at most 5 pixels off both;
the display PNG is held at the JAX suite's own bar, RMSE < 2/255.
"""

import os
import struct
import zlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from wgpu_path_tracing_tpu import Renderer as JRenderer
from wgpu_path_tracing_tpu import RenderConfig as JRenderConfig
from wgpu_path_tracing_tpu import cornell_box as jcornell_box
from wgpu_path_tracing_tpu.ops import tonemap as JTONE
from wgpu_path_tracing_tpu.utils import image as JIMAGE
from chip_smoke import plain_render
from tests.oracle import Oracle
from wgpu_path_tracing_tpu_torch import Renderer, RenderConfig, cornell_box
from wgpu_path_tracing_tpu_torch.ops import tonemap
from wgpu_path_tracing_tpu_torch.utils import image

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")


@pytest.fixture(scope="module")
def golden_render():
    r = Renderer(RenderConfig(width=48, height=48), device="cpu")
    r.load_scene(cornell_box())
    return r, r.render(spp=8)


def _oracle_mean(oracle, px, py, spp):
    """The oracle's clamped running mean of frames 0..spp-1 at one pixel,
    accumulated as render/pipeline.py does it."""
    acc = np.zeros(3, np.float32)
    for frame in range(spp):
        color = np.minimum(
            np.asarray(oracle.render_pixel(px, py, frame), np.float32),
            np.float32(2.5))
        w = np.float32(1.0) / (np.float32(frame) + np.float32(1.0))
        acc = acc * (np.float32(1.0) - w) + color * w
    return acc


def test_cornell_golden_hdr_buffer(golden_render):
    r, buf = golden_render
    golden = np.load(os.path.join(GOLDEN_DIR, "cornell_48x48_8spp.npz"))["accum"]
    assert buf.shape == golden.shape
    close = np.isclose(buf, golden, rtol=5e-4, atol=5e-4).all(-1)
    oracle = Oracle(cornell_box(), r.camera.as_pytree(), 48, 48)
    ys, xs = np.nonzero(~close)
    off_both = [(px, py) for px, py in zip(xs, ys)
                if not np.allclose(buf[py, px], _oracle_mean(oracle, px, py, 8),
                                   rtol=2e-3, atol=2e-3)]
    report = (f"{len(xs)} of {close.size} pixels outside 5e-4 of the golden, "
              f"{len(off_both)} of them off the oracle too: {off_both}")
    assert close.size - len(off_both) >= 0.99 * close.size, report
    assert len(off_both) <= 5, report
    assert abs(buf.mean() / golden.mean() - 1.0) < 1e-3


def test_cornell_golden_display_png(golden_render):
    r, _ = golden_render
    golden = JIMAGE.read_png(os.path.join(GOLDEN_DIR, "cornell_48x48_8spp.png"))
    assert image.rmse(r.image(), golden) < 2.0 / 255.0


def test_display_transform_matches_jax():
    """The AGX chain within 1e-5, including its NaNs below ~1e-4 linear."""
    rng = np.random.default_rng(0)
    hdr = np.concatenate([
        rng.uniform(0.0, 3.0, (4096, 3)),
        10.0 ** rng.uniform(-6.0, 1.0, (4096, 3)),
        np.zeros((4, 3)),
    ]).astype(np.float32)
    want = np.asarray(JTONE.display_transform(jnp.asarray(hdr)))
    got = tonemap.display_transform(torch.from_numpy(hdr)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(want).any()  # the known NaN class is exercised
    fin = ~np.isnan(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=1e-5)
    # buffer_to_srgb scrubs those NaNs, as the JAX package's does.
    a = image.buffer_to_srgb(hdr[:4096], 64, 64)
    b = JIMAGE.buffer_to_srgb(hdr[:4096], 64, 64)
    assert np.isfinite(a).all()
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_ray_counters_match_jax():
    j = JRenderer(JRenderConfig(width=32, height=32, frames_per_chunk=4))
    j.load_scene(jcornell_box())
    j.render(spp=4)
    p = Renderer(RenderConfig(width=32, height=32), device="cpu")
    p.load_scene(cornell_box())
    p.render(spp=4)
    js, ps = j.stats(), p.stats()
    for key in ("rays_closest", "rays_shadow"):
        assert abs(ps[key] / js[key] - 1.0) < 0.005, key
    assert ps["frame_index"] == 4 and ps["mrays_per_sec"] > 0


def test_progressive_reset_and_camera_moves():
    r = Renderer(RenderConfig(width=16, height=16), device="cpu")
    r.load_scene(cornell_box())
    a = r.render(spp=2)
    b = r.render(spp=2)  # accumulates frames 2..3
    assert r.frame_index == 4 and not np.array_equal(a, b)
    r.reset()
    assert r.frame_index == 0 and r.stats()["rays_total"] == 0
    np.testing.assert_array_equal(r.render(spp=2), a)  # same seeds again
    r.move_camera(0.1, 0.0, 0.0)
    assert r.frame_index == 0
    moved = r.render(spp=2)
    assert not np.array_equal(moved, a)
    r.rotate_camera(0.05, 0.0)
    assert r.frame_index == 0


def test_plain_and_kernel_paths_agree_on_cpu():
    """On the CPU the renderer's kernel wrappers run the plain versions, so
    its image equals chip_smoke.py's plain reference render bit for bit."""
    r = Renderer(RenderConfig(width=16, height=16), device="cpu")
    r.load_scene(cornell_box())
    np.testing.assert_array_equal(r.render(spp=2), plain_render(r, spp=2))


@pytest.fixture(scope="module")
def large_render():
    """cornell_box(tessellation=12): 4,898 triangles, above the dense
    intersector's 4096, so "auto" takes the walk."""
    r = Renderer(RenderConfig(width=24, height=24), device="cpu")
    r.load_scene(cornell_box(tessellation=12))
    return r, r.render(spp=2)


@pytest.mark.parametrize("tessellation, strategy", [(1, "brute"),
                                                     (12, "walk")])
def test_stats_report_the_chosen_intersector(tessellation, strategy):
    r = Renderer(RenderConfig(width=8, height=8), device="cpu")
    assert r.stats()["intersector"] is None  # no scene yet
    scene = cornell_box(tessellation=tessellation)
    r.load_scene(scene)
    assert scene.num_triangles == {1: 36, 12: 4898}[tessellation]
    assert r.stats()["intersector"] == strategy


def test_large_scene_walk_equals_brute(large_render):
    """The walk and the dense hit agree on every pixel: both round every
    operation the same way, and no razor-tie pixel shows at this size."""
    r, walk_img = large_render
    assert r.stats()["intersector"] == "walk"
    b = Renderer(RenderConfig(width=24, height=24, intersector="brute"), device="cpu")
    b.load_scene(cornell_box(tessellation=12))
    assert b.stats()["intersector"] == "brute"
    np.testing.assert_array_equal(walk_img.view(np.uint32),
                                  b.render(spp=2).view(np.uint32))
    np.testing.assert_array_equal(walk_img, plain_render(r, spp=2))


def test_large_scene_matches_jax_renderer(large_render):
    """Held to the JAX Renderer at the same settings with the golden test's
    bars: >= 99% of pixels within 5e-4 of the JAX image or, where not, of
    the scalar oracle's mean, at most 5 off both, the means within 1e-3."""
    r, buf = large_render
    j = JRenderer(JRenderConfig(width=24, height=24, frames_per_chunk=2))
    j.load_scene(jcornell_box(tessellation=12))
    ref = j.render(spp=2)
    close = np.isclose(buf, ref, rtol=5e-4, atol=5e-4).all(-1)
    oracle = Oracle(cornell_box(tessellation=12), r.camera.as_pytree(), 24, 24)
    ys, xs = np.nonzero(~close)
    off_both = [(px, py) for px, py in zip(xs, ys)
                if not np.allclose(buf[py, px], _oracle_mean(oracle, px, py, 2),
                                   rtol=2e-3, atol=2e-3)]
    report = (f"{len(xs)} of {close.size} pixels outside 5e-4 of the JAX "
              f"render, {len(off_both)} of them off the oracle too: {off_both}")
    assert close.size - len(off_both) >= 0.99 * close.size, report
    assert len(off_both) <= 5, report
    assert abs(buf.mean() / ref.mean() - 1.0) < 1e-3


def _read_png_rgb(path):
    """Decode the writer's own 8-bit RGB PNG (filter 0 rows) with zlib."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, size = 8, b"", None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        assert crc == zlib.crc32(tag + body) & 0xFFFFFFFF
        if tag == b"IHDR":
            size = struct.unpack(">II", body[:8])
        elif tag == b"IDAT":
            idat += body
        pos += 12 + length
    w, h = size
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    assert (raw[:, 0] == 0).all()
    return raw[:, 1:].reshape(h, w, 3)


def test_save_png_and_hdr(tmp_path):
    r = Renderer(RenderConfig(width=20, height=12), device="cpu")
    r.load_scene(cornell_box())
    r.render(spp=1)
    png = tmp_path / "out.png"
    r.save_png(str(png))
    want = (np.clip(r.image(), 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    np.testing.assert_array_equal(_read_png_rgb(png), want)
    # Pillow reads it the same way.
    np.testing.assert_array_equal(
        (JIMAGE.read_png(str(png)) * 255.0).round().astype(np.uint8), want)
    hdr, ref = tmp_path / "out.hdr", tmp_path / "ref.hdr"
    r.save_hdr(str(hdr))
    flipped = r._row_major().reshape(12, 20, 3)[::-1]
    JIMAGE.write_hdr(str(ref), np.nan_to_num(flipped, nan=0.0))
    assert hdr.read_bytes() == ref.read_bytes()
    # RGBE keeps 8 bits per channel under the pixel's shared exponent.
    err = np.abs(JIMAGE.read_hdr(str(hdr)) - flipped)
    assert (err <= flipped.max(-1, keepdims=True) / 128.0 + 1e-6).all()
