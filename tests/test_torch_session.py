"""The rest of the port's ``Renderer`` against the JAX package: the rng modes
end to end, frames per trace, chunks and their callbacks, unsynced renders,
resize, checkpoints (each package loads the other's), EXR, the HDR and PNG
readers, and the two procedural test scenes.

A 24x24 2-spp render in the "hash" and "stratified" modes lands within 5e-4
of the JAX ``Renderer``'s on about 96% of pixels (measured 25 and 23 of 576
beyond, the "reference" mode 24): XLA:CPU's fused multiply-adds flip a
razor-edge shadow test now and then, which adds or drops a whole light
sample and moves no RNG state. The scalar oracle that arbitrates the
reference mode (``tests/test_torch_renderer.py``) knows only that mode, so
each pixel beyond the bar is traced instead: both packages trace its frames
again and the pixel is counted in the shadow-test class where the final RNG
states agree, in the path class where they do not (measured: "hash" 25 and
0, "stratified" 21 and 2, one lane a frame whose razor-edge branch flipped;
the means within 0.05% and 0.10%).
"""

import dataclasses
import functools
import struct
import zlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from wgpu_path_tracing_tpu import Renderer as JRenderer
from wgpu_path_tracing_tpu import RenderConfig as JRenderConfig
from wgpu_path_tracing_tpu import cornell_box as jcornell_box
from wgpu_path_tracing_tpu.models import procedural as JP
from wgpu_path_tracing_tpu.models.types import pack_device_scene as jpack
from wgpu_path_tracing_tpu.ops import camera_rays as JCAM
from wgpu_path_tracing_tpu.ops import trace as JTRACE
from wgpu_path_tracing_tpu.ops.intersect import make_closest_hit as jmake_closest_hit
from wgpu_path_tracing_tpu.render.camera import Camera as JCamera
from wgpu_path_tracing_tpu.render.pipeline import camera_device as jcamera_device
from wgpu_path_tracing_tpu.utils import image as JIMAGE
from wgpu_path_tracing_tpu_torch import (
    Renderer,
    RenderConfig,
    cornell_box,
    load_jax_scene,
    random_triangles,
    single_triangle,
)
from wgpu_path_tracing_tpu_torch.models.types import pack_device_scene
from wgpu_path_tracing_tpu_torch.ops import camera_rays as PCAM
from wgpu_path_tracing_tpu_torch.ops import trace as PTRACE
from wgpu_path_tracing_tpu_torch.ops.intersect import make_closest_hit
from wgpu_path_tracing_tpu_torch.render import pipeline
from wgpu_path_tracing_tpu_torch.render.camera import Camera
from wgpu_path_tracing_tpu_torch.utils import image

torch.set_num_threads(1)


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def _renderer(size=16, **config):
    """A CPU Renderer of ``size`` (an int or (width, height)) with the
    Cornell box loaded."""
    width, height = size if isinstance(size, tuple) else (size, size)
    r = Renderer(RenderConfig(width=width, height=height, **config),
                 device="cpu")
    r.load_scene(cornell_box())
    return r


# --- the rng modes against the JAX Renderer ---------------------------------

def _final_states(mode: str, frame: int, w: int) -> np.ndarray:
    """Per lane (row-major), whether both packages' traces of ``frame`` end
    in the same RNG state."""
    sc = jcornell_box()
    jdev = jax.device_put(jpack(sc))
    jcam = jcamera_device(JCamera(width=w, height=w).as_pytree(), w, w)
    jx, jy = JCAM.pixel_grid(w, w)
    ro, rd, st = JCAM.generate_rays(jcam, jx, jy, jnp.int32(frame),
                                    use_dof=True, rng_mode=mode)
    lds = (JCAM.bounce0_lds(jx, jy, jnp.int32(frame))
           if mode == "stratified" else None)
    _, jst, _ = JTRACE.trace(jdev, jmake_closest_hit(jdev, "brute", 4096, 4),
                             ro, rd, st, max_bounces=8, do_mis=True,
                             num_lights=sc.num_lights, lds0=lds)
    scene = load_jax_scene(pack_device_scene(cornell_box()), "cpu")
    cam = pipeline.camera_device(Camera(width=w, height=w).as_pytree(), w, w)
    x, y = PCAM.pixel_grid(w, w)
    pro, prd, pst = PCAM.generate_rays(cam, x, y, frame, use_dof=True,
                                       rng_mode=mode)
    plds = PCAM.bounce0_lds(x, y, frame) if mode == "stratified" else None
    _, pst, _ = PTRACE.trace(scene, make_closest_hit(scene), pro, prd, pst,
                             num_lights=sc.num_lights, lds0=plds)
    return pst.numpy() == np.asarray(jst).astype(np.int64)


@pytest.mark.parametrize("mode", ["hash", "stratified"])
def test_rng_modes_match_jax_renderer(mode):
    w, spp = 24, 2
    j = JRenderer(JRenderConfig(width=w, height=w, frames_per_chunk=spp,
                                rng=mode))
    j.load_scene(jcornell_box())
    ref = j.render(spp=spp)
    buf = _renderer(w, rng=mode).render(spp=spp)
    close = np.isclose(buf, ref, rtol=5e-4, atol=5e-4).all(-1)
    same = np.ones(w * w, bool)
    for frame in range(spp):
        agree = _final_states(mode, frame, w)
        assert agree.mean() >= 0.99, (frame, agree.mean())
        same &= agree
    ys, xs = np.nonzero(~close)
    path_class = [(px, py) for px, py in zip(xs, ys) if not same[py * w + px]]
    report = (f"{len(xs)} of {close.size} pixels beyond 5e-4 of the JAX "
              f"render; {len(xs) - len(path_class)} in the shadow-test "
              f"class, {len(path_class)} with RNG states apart: {path_class}")
    assert len(xs) <= 0.06 * close.size, report
    assert len(path_class) <= 0.01 * close.size, report
    assert abs(buf.mean() / ref.mean() - 1.0) < 2e-3, report


# --- frames per trace ---------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _one_frame_a_trace(intersector: str) -> np.ndarray:
    r = _renderer(32, intersector=intersector, rng="stratified")
    assert r.stats()["intersector"] == intersector
    return r.render(spp=4)


@pytest.mark.parametrize("fpt", [2, 4])
@pytest.mark.parametrize("intersector", ["brute", "walk", "pairs"])
def test_frames_per_trace_gives_the_same_image(intersector, fpt):
    """F frames' rays in one trace call of F x 1,024 lanes: every lane is
    traced alone (K1, K3) or in its own frame's 1,024-ray blocks (K4), and
    the running mean runs per frame in order, so the image is the same."""
    r = _renderer(32, intersector=intersector, rng="stratified",
                  frames_per_trace=fpt)
    np.testing.assert_array_equal(_bits(r.render(spp=4)),
                                  _bits(_one_frame_a_trace(intersector)))
    assert r.frame_index == 4


def test_frames_per_trace_is_clamped_to_each_chunk():
    """frames_per_trace 4 with 6 spp in chunks of 16 traces 2 frames a
    call (gcd); render_chunk itself refuses an F that does not divide."""
    a = _renderer(frames_per_trace=4, rng="hash").render(spp=6)
    b = _renderer(rng="hash").render(spp=6)
    np.testing.assert_array_equal(_bits(a), _bits(b))
    r = _renderer()
    cam = pipeline.camera_device(r.camera.as_pytree(), 16, 16)
    with pytest.raises(ValueError, match="frames_per_trace"):
        pipeline.render_chunk(PTRACE.trace, r._closest_hit, r._scene_dev, cam,
                              torch.zeros((256, 3)), 0, n_frames=3, width=16,
                              height=16, use_dof=True, max_bounces=8,
                              do_mis=True, num_lights=2, firefly_clamp=2.5,
                              frames_per_trace=2)


# --- chunks, callbacks, unsynced renders, resize ------------------------------

def test_chunks_report_to_on_chunk_and_on_update():
    r = _renderer(frames_per_chunk=3)
    updates, chunks = [], []
    r.add_on_update(updates.append)
    img = r.render(spp=7, on_chunk=chunks.append)
    assert chunks == [3, 6, 7] and updates == [0.0, 0.0, 0.0]
    np.testing.assert_array_equal(_bits(img), _bits(_renderer().render(spp=7)))
    assert r.stats()["frame_index"] == 7


def test_unsynced_renders_fold_their_counters_in():
    """render(sync=False) returns None and keeps its counters on the device
    until stats() or the next synchronous render."""
    ref = _renderer()
    ref.render(spp=5)
    want = ref.stats()
    a = _renderer()
    assert a.render(spp=2, sync=False) is None
    assert a.render(spp=3, sync=False) is None
    got = a.stats()
    b = _renderer()
    b.render(spp=2, sync=False)
    b.render(spp=3)  # folds the unsynced frames in
    for stats in (got, b.stats()):
        for key in ("frame_index", "rays_closest", "rays_shadow"):
            assert stats[key] == want[key], key
        assert stats["mrays_per_sec"] > 0
    np.testing.assert_array_equal(_bits(a._row_major()),
                                  _bits(ref._row_major()))
    a.render(spp=1, sync=False)
    a.reset()  # drops the unsynced counters with the accumulation
    assert a.stats()["rays_total"] == 0 and a.frame_index == 0


def test_resize_restarts_at_the_new_size():
    r = _renderer()
    r.render(spp=2)
    r.resize(24, 16)
    assert r.frame_index == 0 and r.camera.aspect == 1.5
    img = r.render(spp=2)
    assert img.shape == (16, 24, 3)
    np.testing.assert_array_equal(_bits(img),
                                  _bits(_renderer((24, 16)).render(spp=2)))
    with pytest.raises(ValueError):
        r.resize(0, 16)


# --- checkpoints ----------------------------------------------------------------

@pytest.mark.parametrize("rng", ["reference", "stratified"])
def test_checkpoint_resume_is_bit_equal(tmp_path, rng):
    a = _renderer((20, 12), rng=rng)
    a.render(spp=3)
    a.save_checkpoint(str(tmp_path / "run"))  # ".npz" appended
    b = _renderer(8, rng=rng)  # the checkpoint resizes it
    b.load_checkpoint(str(tmp_path / "run.npz"))
    assert (b.config.width, b.config.height, b.frame_index) == (20, 12, 3)
    resumed = b.render(spp=2)
    straight = _renderer((20, 12), rng=rng).render(spp=5)
    np.testing.assert_array_equal(_bits(resumed), _bits(straight))


def test_checkpoints_cross_between_packages(tmp_path):
    """The port's file loads into the JAX Renderer and the JAX Renderer's
    into the port, values bit for bit; a resume from either file is the
    same render."""
    p = _renderer((16, 12), rng="stratified")
    p.camera.aperture = 0.05
    p.render(spp=2)
    p.save_checkpoint(str(tmp_path / "port.npz"))
    j = JRenderer(JRenderConfig(width=8, height=8, rng="stratified"))
    j.load_checkpoint(str(tmp_path / "port.npz"))
    assert (j.config.width, j.config.height, j.frame_index) == (16, 12, 2)
    np.testing.assert_array_equal(_bits(j._row_major(j._accum)),
                                  _bits(p._row_major()))
    assert j.camera.aperture == p.camera.aperture
    j.save_checkpoint(str(tmp_path / "jax.npz"))
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "jax.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    resumed = []
    for name in ("port.npz", "jax.npz"):
        q = _renderer((16, 12), rng="stratified")
        q.load_checkpoint(str(tmp_path / name))
        assert q.camera.aperture == np.float32(0.05)
        resumed.append(q.render(spp=2))
    np.testing.assert_array_equal(_bits(resumed[0]), _bits(resumed[1]))
    np.testing.assert_array_equal(_bits(resumed[0]), _bits(p.render(spp=2)))


# --- EXR, HDR and PNG ------------------------------------------------------------

def _hdr_image(h, w, seed=0):
    rng = np.random.default_rng(seed)
    hdr = rng.exponential(0.5, (h, w, 3)).astype(np.float32)
    hdr.reshape(-1)[::7] = 0.0
    hdr.reshape(-1)[::11] *= 1e4
    hdr.reshape(-1)[::13] *= 1e-6
    return hdr


@pytest.mark.parametrize("shape", [(1, 1), (5, 7), (12, 20)])
def test_exr_matches_the_jax_writer_and_round_trips(tmp_path, shape):
    hdr = _hdr_image(*shape)
    mine, theirs = tmp_path / "port.exr", tmp_path / "jax.exr"
    image.write_exr(str(mine), hdr)
    JIMAGE.write_exr(str(theirs), hdr)
    assert mine.read_bytes() == theirs.read_bytes()
    np.testing.assert_array_equal(_bits(image.read_exr(str(theirs))), _bits(hdr))
    np.testing.assert_array_equal(_bits(JIMAGE.read_exr(str(mine))), _bits(hdr))


def test_save_exr_writes_the_linear_buffer(tmp_path):
    r = _renderer((20, 12))
    r.render(spp=1)
    path = tmp_path / "out.exr"
    r.save_exr(str(path))
    flipped = r._row_major().reshape(12, 20, 3)[::-1]
    np.testing.assert_array_equal(_bits(image.read_exr(str(path))),
                                  _bits(np.nan_to_num(flipped, nan=0.0)))


def test_read_exr_refuses_what_it_cannot_read(tmp_path):
    path = tmp_path / "a.exr"
    image.write_exr(str(path), _hdr_image(2, 3))
    data = path.read_bytes()
    cases = {
        "magic": b"\0" + data[1:],
        # the compression attribute's value: ZIP (3)
        "compression": data.replace(b"compression\0compression\0\x01\0\0\0\0",
                                    b"compression\0compression\0\x01\0\0\0\x03"),
        # the first channel's pixel type: HALF (1)
        "half": data.replace(b"B\0\x02\0\0\0", b"B\0\x01\0\0\0", 1),
    }
    for name, bad in cases.items():
        assert bad != data, name
        path.write_bytes(bad)
        with pytest.raises(ValueError):
            image.read_exr(str(path))


def test_read_hdr_matches_jax(tmp_path):
    hdr = _hdr_image(9, 14, seed=3)
    path = tmp_path / "a.hdr"
    image.write_hdr(str(path), hdr)
    got = image.read_hdr(str(path))
    np.testing.assert_array_equal(_bits(got), _bits(JIMAGE.read_hdr(str(path))))
    # RGBE keeps 8 bits under the pixel's shared exponent.
    assert (np.abs(got - hdr) <= hdr.max(-1, keepdims=True) / 128 + 1e-30).all()
    path.write_bytes(b"P6" + path.read_bytes()[2:])
    with pytest.raises(ValueError):
        image.read_hdr(str(path))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _encode_png(pixels: np.ndarray, ctype: int, filters) -> bytes:
    """An 8-bit PNG of ``pixels`` (H, W, C) whose row y is filtered with
    ``filters[y]`` (PNG spec 9.2), split over two IDAT chunks."""
    h, w, ch = pixels.shape
    raw = pixels.reshape(h, w * ch).astype(np.int16)
    out, prior = [], np.zeros(w * ch, np.int16)
    for y in range(h):
        line = raw[y]
        left = np.concatenate([np.zeros(ch, np.int16), line[:-ch]])
        up_left = np.concatenate([np.zeros(ch, np.int16), prior[:-ch]])
        pred = {0: 0, 1: left, 2: prior, 3: (left + prior) >> 1,
                4: _paeth(left, prior, up_left)}[filters[y]]
        out.append(bytes([filters[y]])
                   + ((line - pred) & 0xFF).astype(np.uint8).tobytes())
        prior = line
    body = zlib.compress(b"".join(out))

    def chunk(tag, payload):
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))

    half = len(body) // 2
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", body[:half]) + chunk(b"IDAT", body[half:])
            + chunk(b"IEND", b""))


def _pillow_rgb(path) -> np.ndarray:
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), np.float32) / 255.0


@pytest.mark.parametrize("filters", [0, 1, 2, 3, 4, "mixed"])
@pytest.mark.parametrize("ctype, channels", [(0, 1), (2, 3), (6, 4)])
def test_read_png_matches_pillow(tmp_path, ctype, channels, filters):
    """Gray, RGB and RGBA under each of the five filter types (and all of
    them, row by row): Pillow decodes the pixels written, and the port's
    reader gives Pillow's RGB."""
    rng = np.random.default_rng(ctype * 10 + (5 if filters == "mixed"
                                               else filters))
    h, w = 9, 13
    pixels = rng.integers(0, 256, (h, w, channels), dtype=np.uint8)
    pixels[2] = pixels[1]  # runs, where Up and Sub predict exactly
    rows = [y % 5 for y in range(h)] if filters == "mixed" else [filters] * h
    path = tmp_path / "a.png"
    path.write_bytes(_encode_png(pixels, ctype, rows))
    with Image.open(path) as im:
        np.testing.assert_array_equal(np.asarray(im).reshape(h, w, channels),
                                      pixels)
    np.testing.assert_array_equal(image.read_png(str(path)),
                                  _pillow_rgb(path))


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA"])
def test_read_png_reads_pillow_files(tmp_path, mode):
    """Pillow's own encoder picks the filters; a smooth image makes it use
    more than one."""
    yy, xx = np.mgrid[0:40, 0:50]
    planes = [(xx * 5) % 256, (yy * 6) % 256, (xx + yy) % 256, 255 - xx]
    data = np.stack(planes[:len(mode)], -1).astype(np.uint8)
    path = tmp_path / "a.png"
    Image.fromarray(data[..., 0] if mode == "L" else data, mode).save(path)
    np.testing.assert_array_equal(image.read_png(str(path)),
                                  _pillow_rgb(path))


def test_read_png_round_trips_the_writer_and_refuses_the_rest(tmp_path):
    img = np.random.default_rng(4).random((6, 5, 3))
    path = tmp_path / "a.png"
    image.write_png(str(path), img)
    want = (np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8) / np.float32(255)
    np.testing.assert_array_equal(image.read_png(str(path)), want)
    # 16-bit gray and palette files read as Pillow's convert("RGB") reads
    # them, a baseline, a progressive and (relabelled) an arithmetic-coded
    # progressive JPEG as Pillow decodes them; a hierarchical JPEG and a
    # bit depth the colour type does not allow raise.
    rng = np.random.default_rng(5)
    for im in (Image.fromarray(rng.integers(0, 600, (4, 5)).astype(
            np.uint16), "I;16"),
               Image.fromarray(rng.integers(0, 256, (4, 5, 3)).astype(
                   np.uint8)).convert("P", palette=Image.ADAPTIVE, colors=7)):
        im.save(path)
        with Image.open(path) as ref:
            rgb = np.asarray(ref.convert("RGB"), np.float32) / 255.0
        np.testing.assert_array_equal(image.read_png(str(path)), rgb)
    im = Image.fromarray(rng.integers(0, 256, (4, 5, 3)).astype(np.uint8))
    im.save(path, "JPEG")
    with Image.open(path) as ref:
        rgb = np.asarray(ref.convert("RGB"), np.float32) / 255.0
    np.testing.assert_array_equal(image.read_png(str(path)), rgb)
    im.save(path, "JPEG", progressive=True)
    with Image.open(path) as ref:
        rgb = np.asarray(ref.convert("RGB"), np.float32) / 255.0
    np.testing.assert_array_equal(image.read_png(str(path)), rgb)
    data = path.read_bytes()
    sof = data.index(b"\xff\xc2")
    path.write_bytes(data[:sof + 1] + b"\xca" + data[sof + 2:])  # SOF10
    with Image.open(path) as ref:
        rgb = np.asarray(ref.convert("RGB"), np.float32) / 255.0
    np.testing.assert_array_equal(image.read_png(str(path)), rgb)
    path.write_bytes(data[:sof + 1] + b"\xc6" + data[sof + 2:])  # SOF6
    with pytest.raises(NotImplementedError, match="a.png: hierarchical"):
        image.read_png(str(path))
    Image.new("RGB", (4, 4)).save(path)
    bad = bytearray(path.read_bytes())
    bad[24] = 4  # IHDR's bit depth: 4-bit RGB does not exist
    path.write_bytes(bytes(bad))
    with pytest.raises(ValueError, match="bit depth 4"):
        image.read_png(str(path))


# --- procedural scenes and config ------------------------------------------------

@pytest.mark.parametrize("name, args", [
    ("single_triangle", ()),
    ("single_triangle", ((0.0, 0.0, -1.0), (2.0, 0.0, -1.0), (0.0, 3.0, -2.0))),
    ("random_triangles", (200, 3)),
    ("random_triangles", (1500, 5)),
])
def test_procedural_scenes_are_array_equal(name, args):
    ours = {"single_triangle": single_triangle,
            "random_triangles": random_triangles}[name](*args)
    ref = getattr(JP, name)(*args)
    for field in dataclasses.fields(ref):
        a, b = getattr(ours, field.name), getattr(ref, field.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, field.name
            np.testing.assert_array_equal(a, b, err_msg=field.name)
        else:
            assert a == b, field.name


def test_config_takes_the_rng_modes_and_frame_counts():
    for rng in ("reference", "hash", "stratified"):
        RenderConfig(rng=rng).validate()
    assert (RenderConfig().frames_per_chunk, RenderConfig().frames_per_trace) \
        == (JRenderConfig().frames_per_chunk, JRenderConfig().frames_per_trace)
    for bad in (dict(rng="sobol"), dict(frames_per_trace=0),
                dict(frames_per_chunk=0)):
        with pytest.raises(ValueError):
            RenderConfig(**bad).validate()
