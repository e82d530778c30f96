"""Multi-device rendering (``parallel/shard.py``, ``Renderer(devices=)``,
``cli.py render --multichip``) on the CPU, with the device list
``["cpu"] * k``: each entry a shard that runs on the one CPU in turn.

The sharded path folds a chunk's summed colours into the mean once, where
the single-device path folds each frame; so the two agree within float32
rounding, at ``tests/test_multichip.py``'s bar (rtol 1e-4 / atol 1e-5), and
the ray counters exactly. Against the JAX package's ``render_chunk_sharded``
(XLA:CPU fuses multiply-adds, PyTorch rounds every operation) the bar is
``tests/test_torch_renderer.py``'s: at least 99% of pixels within rtol/atol
5e-4 of the JAX image or, where not, of the scalar oracle's mean (rtol/atol
2e-3), at most 5 off both. A last-ulp difference that flips a shadow test
or a path's end changes the ray counts too, so the counters are held to
the JAX package's within 0.5%, as ``test_ray_counters_match_jax`` holds
the single-device ones (52,205 and 42,197 rays against 52,208 and 42,198
here). A checkpoint resume and a frames-per-trace batch repeat the same
operations, so they are held bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wgpu_path_tracing_tpu import Renderer as JRenderer
from wgpu_path_tracing_tpu import RenderConfig as JRenderConfig
from wgpu_path_tracing_tpu.models.procedural import cornell_box as jcornell
from wgpu_path_tracing_tpu.models.types import pack_device_scene as jpack
from wgpu_path_tracing_tpu.parallel import shard as JSH
from wgpu_path_tracing_tpu.render import pipeline as JPIPE
from tests.oracle import Oracle
from tests.test_torch_renderer import _oracle_mean
from wgpu_path_tracing_tpu_torch import (
    Camera,
    Renderer,
    RenderConfig,
    cornell_box,
    load_jax_scene,
    material_test_box,
)
from wgpu_path_tracing_tpu_torch import cli
from wgpu_path_tracing_tpu_torch.models.types import pack_device_scene
from wgpu_path_tracing_tpu_torch.ops.bounce import trace_cuda
from wgpu_path_tracing_tpu_torch.ops.intersect import make_closest_hit
from wgpu_path_tracing_tpu_torch.parallel import shard as SH
from wgpu_path_tracing_tpu_torch.render import pipeline
from wgpu_path_tracing_tpu_torch.utils.tiling import (
    inverse_permutation,
    tile_permutation,
)

# One thread a worker (ROADMAP.md C.3).
torch.set_num_threads(1)

SIZE = 64
SPP = 4
CPU = torch.device("cpu")


def _bits(a):
    return np.ascontiguousarray(a).view(np.uint32)


def _kwargs(scene, size=SIZE, n_frames=SPP, max_bounces=8):
    return dict(n_frames=n_frames, width=size, height=size, use_dof=True,
                rng_mode="reference", max_bounces=max_bounces, do_mis=True,
                num_lights=scene.num_lights, firefly_clamp=2.5)


def _cam(size):
    return pipeline.camera_device(
        Camera(width=size, height=size).as_pytree(), size, size)


def _single(scene_dev, closest_hit, cam, kw):
    """The port's single-device render of kw's frames, row-major."""
    n = kw["width"] * kw["height"]
    accum = torch.zeros((n, 3))
    _, counters = pipeline.render_chunk(trace_cuda, closest_hit, scene_dev,
                                        cam, accum, 0, **kw)
    inv = inverse_permutation(tile_permutation(kw["width"], kw["height"]))
    return accum.numpy()[inv], counters.numpy()


def _sharded(scene_dev, intersector, cam, kw, mesh, chunks=((0, None),),
             **extra):
    """``render_chunk_sharded`` of kw's frames on ``mesh``, one call a
    (frame_start, n_frames) chunk, row-major, and the summed counters."""
    scenes = SH.replicate_scene(scene_dev, mesh)
    hits = {d: make_closest_hit(s, intersector) for d, s in scenes.items()}
    n = kw["width"] * kw["height"]
    accum = SH.shard_accum(torch.zeros((n, 3)), mesh)
    total = np.zeros(2, np.int64)
    for start, frames in chunks:
        ckw = dict(kw, n_frames=frames or kw["n_frames"])
        accum, counters = SH.render_chunk_sharded(
            trace_cuda, hits, scenes, cam, accum, start, mesh=mesh, **ckw,
            **extra)
        total += counters.numpy()
    buf = SH.untile_image(SH.gather_image(accum), kw["width"], kw["height"],
                          mesh.shape["row"])
    return buf, total


@pytest.fixture(scope="module")
def flagship():
    sc = cornell_box()
    scene_dev = load_jax_scene(pack_device_scene(sc), CPU)
    kw = _kwargs(sc)
    ch = make_closest_hit(scene_dev, "brute")
    cam = _cam(SIZE)
    ref, counters = _single(scene_dev, ch, cam, kw)
    return scene_dev, cam, kw, ref, counters


@pytest.mark.parametrize("shape", [(1, 1), (1, 2), (2, 2), (2, 1), (1, 8)])
def test_sharded_matches_single_device(flagship, shape):
    scene_dev, cam, kw, ref, ref_counters = flagship
    s, r = shape
    mesh = SH.make_mesh(["cpu"] * (s * r), sample_shards=s)
    assert mesh.shape == {"sample": s, "row": r}
    assert mesh.distinct() == [CPU]
    out, counters = _sharded(scene_dev, "brute", cam, kw, mesh)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(counters, ref_counters)


def test_sharded_matches_jax_render_chunk_sharded(flagship):
    """The (2, 2) mesh against the JAX function on 4 of its 8 CPU
    devices."""
    scene_dev, cam, kw, _, _ = flagship
    out, counters = _sharded(scene_dev, "brute", cam, kw,
                             SH.make_mesh(["cpu"] * 4, sample_shards=2))
    jsc = jcornell()
    jmesh = JSH.make_mesh(jax.devices()[:4], sample_shards=2)
    jcam = JPIPE.camera_device(Camera(width=SIZE, height=SIZE).as_pytree(),
                               SIZE, SIZE)
    jout, jcounters = JSH.render_chunk_sharded(
        JSH.replicate_scene(jpack(jsc), jmesh), jcam,
        JSH.shard_accum(jnp.zeros((SIZE * SIZE, 3), jnp.float32), jmesh),
        jnp.int32(0), mesh=jmesh, intersector="brute", brute_max_tris=512,
        leaf_size=4, **kw)
    ref = JSH.untile_image(JSH.gather_image(jout), SIZE, SIZE, 2)
    close = np.isclose(out, ref, rtol=5e-4, atol=5e-4).all(-1)
    oracle = Oracle(cornell_box(), Camera(width=SIZE, height=SIZE).as_pytree(),
                    SIZE, SIZE)
    off = np.nonzero(~close)[0]
    off_both = [k for k in off if not np.allclose(
        out[k], _oracle_mean(oracle, k % SIZE, k // SIZE, SPP), rtol=2e-3,
        atol=2e-3)]
    report = (f"{len(off)} of {close.size} pixels outside 5e-4 of the JAX "
              f"render, {len(off_both)} of them off the oracle too")
    assert close.size - len(off_both) >= 0.99 * close.size, report
    assert len(off_both) <= 5, report
    assert (np.abs(counters / np.asarray(jcounters) - 1.0) < 0.005).all()


def test_frames_per_trace_equals_one_frame_a_trace(flagship):
    """Two local frames a trace call keep every frame's seeds: the same
    image bit for bit (every lane is traced alone on the dense hit), the
    same counters."""
    scene_dev, cam, kw, _, ref_counters = flagship
    mesh = SH.make_mesh(["cpu"] * 4, sample_shards=2)
    one, c1 = _sharded(scene_dev, "brute", cam, kw, mesh)
    two, c2 = _sharded(scene_dev, "brute", cam, kw, mesh, frames_per_trace=2)
    np.testing.assert_array_equal(_bits(two), _bits(one))
    np.testing.assert_array_equal(c2, ref_counters)
    np.testing.assert_array_equal(c1, ref_counters)


def test_two_chunks_equal_one_of_twice_the_frames(flagship):
    scene_dev, cam, kw, _, _ = flagship
    mesh = SH.make_mesh(["cpu"] * 4, sample_shards=2)
    two, _ = _sharded(scene_dev, "brute", cam, kw, mesh,
                      chunks=((0, SPP), (SPP, SPP)))
    ch = make_closest_hit(scene_dev, "brute")
    ref, _ = _single(scene_dev, ch, cam, dict(kw, n_frames=2 * SPP))
    np.testing.assert_allclose(two, ref, rtol=1e-4, atol=1e-5)


def test_padded_frames_weigh_nothing(flagship):
    """n_active below n_frames: the padded frames run but neither the image
    nor the counters see them."""
    scene_dev, cam, kw, _, _ = flagship
    mesh = SH.make_mesh(["cpu"] * 2, sample_shards=2)
    out, counters = _sharded(scene_dev, "brute", cam, dict(kw, n_frames=2),
                             mesh, n_active=1)
    ch = make_closest_hit(scene_dev, "brute")
    ref, ref_counters = _single(scene_dev, ch, cam, dict(kw, n_frames=1))
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(counters, ref_counters)
    with pytest.raises(ValueError, match="sample shards"):
        _sharded(scene_dev, "brute", cam, dict(kw, n_frames=3), mesh)


@pytest.mark.parametrize("intersector", ["walk", "walk_hbm"])
def test_sharded_walk(intersector):
    """The walk (K3's plain version) on ``cornell_box(tessellation=5)`` at
    32x32, 2 frames, 3 bounces, as the JAX ``walk_setup`` fixture renders
    it: the (2, 2) mesh against the single-device render."""
    sc = cornell_box(tessellation=5)
    scene_dev = load_jax_scene(pack_device_scene(sc), CPU)
    kw = _kwargs(sc, size=32, n_frames=2, max_bounces=3)
    cam = _cam(32)
    ch = make_closest_hit(scene_dev, intersector)
    assert ch.strategy == intersector
    ref, ref_counters = _single(scene_dev, ch, cam, kw)
    out, counters = _sharded(scene_dev, intersector, cam, kw,
                             SH.make_mesh(["cpu"] * 4, sample_shards=2))
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(counters, ref_counters)


def test_mesh_shapes_and_their_errors():
    assert SH.make_mesh(["cpu"] * 8).shape == {"sample": 2, "row": 4}
    assert SH.make_mesh(["cpu"] * 2).shape == {"sample": 1, "row": 2}
    assert SH.make_mesh(["cpu"] * 3).shape == {"sample": 1, "row": 3}
    with pytest.raises(ValueError, match="sample shards"):
        SH.make_mesh(["cpu"] * 3, sample_shards=2)
    with pytest.raises(ValueError):
        SH.make_mesh([])
    buf = np.arange(24 * 16 * 3, dtype=np.float32).reshape(-1, 3)
    bands = SH.tile_bands(buf, 24, 16, 4)
    np.testing.assert_array_equal(SH.untile_image(bands, 24, 16, 4), buf)


# --- the Renderer and the CLI ----------------------------------------------

def _renderers(size=32, scene=cornell_box, **config):
    """A single-device Renderer and one on a (2, 2) mesh of the CPU."""
    cfg = dict(width=size, height=size, frames_per_chunk=4, **config)
    one = Renderer(RenderConfig(**cfg), device="cpu")
    four = Renderer(RenderConfig(**cfg), device="cpu", devices=["cpu"] * 4)
    for r in (one, four):
        r.load_scene(scene())
    return one, four


def test_renderer_on_a_mesh_matches_one_device():
    one, four = _renderers()
    assert four.mesh.shape == {"sample": 2, "row": 2}
    assert four.device == CPU and one.mesh is None
    single, multi = one.render(spp=4), four.render(spp=4)
    np.testing.assert_allclose(multi, single, rtol=1e-4, atol=1e-5)
    assert one.stats()["rays_total"] == four.stats()["rays_total"]
    img = four.image()
    assert img.shape == (32, 32, 3) and np.isfinite(img).all()
    # The denoiser runs on the first device from its copy of the scene.
    np.testing.assert_allclose(four.image(denoise=True),
                               one.image(denoise=True), rtol=1e-4, atol=1e-5)
    # A padded tail: 5 frames on 2 sample shards.
    single, multi = one.render(spp=5), four.render(spp=5)
    assert one.frame_index == four.frame_index == 9
    np.testing.assert_allclose(multi, single, rtol=1e-4, atol=1e-5)
    assert one.stats()["rays_total"] == four.stats()["rays_total"]


def test_renderer_on_a_mesh_with_an_environment():
    env = np.zeros((4, 8, 3), np.float32)
    env[:2] = [0.3, 0.5, 0.9]
    env[2:] = [0.1, 0.08, 0.05]
    one, four = _renderers(scene=material_test_box, max_bounces=3)
    for r in (one, four):
        r.set_environment(env)
    multi = four.render(spp=4)
    np.testing.assert_allclose(multi, one.render(spp=4), rtol=1e-4,
                               atol=1e-5)
    assert multi.sum() > 0


def test_renderer_on_a_mesh_checkpoints(tmp_path):
    """A mesh's checkpoint is the row-major file either package loads; a
    resume on a fresh mesh equals the render in one go bit for bit."""
    _, four = _renderers()
    four.render(spp=4)
    path = str(tmp_path / "mesh.npz")
    four.save_checkpoint(path)
    j = JRenderer(JRenderConfig(width=32, height=32))
    j.load_checkpoint(path)
    np.testing.assert_array_equal(_bits(j._row_major(j._accum)),
                                  _bits(four._row_major()))
    j.save_checkpoint(str(tmp_path / "jax.npz"))
    straight = four.render(spp=4)
    for name in ("mesh.npz", "jax.npz"):
        _, again = _renderers()
        again.load_checkpoint(str(tmp_path / name))
        assert again.frame_index == 4
        np.testing.assert_array_equal(_bits(again.render(spp=4)),
                                      _bits(straight))


def test_renderer_on_a_mesh_refuses_what_it_cannot_do():
    _, four = _renderers()
    with pytest.raises(NotImplementedError, match="single-device"):
        four.render_adaptive(8)
    with pytest.raises(ValueError, match="must divide the row axis"):
        Renderer(RenderConfig(width=32, height=31), device="cpu",
                 devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="must divide the row axis"):
        four.resize(32, 31)
    # devices=True on the CPU is one device: the single-device path.
    assert Renderer(RenderConfig(width=8, height=8), device="cpu",
                    devices=True).mesh is None
    # An explicit list of one takes the sharded path.
    one = Renderer(RenderConfig(width=8, height=8), device="cpu",
                   devices=["cpu"])
    assert one.mesh.shape == {"sample": 1, "row": 1}


def test_cli_multichip(tmp_path):
    """``--multichip`` asks the Renderer for every card of --device: on the
    CPU one device, so the image is the single-device render's."""
    out = [str(tmp_path / f"{k}.png") for k in ("plain", "multi")]
    common = ["render", "cornell", "--device", "cpu", "--width", "16",
              "--height", "16", "--spp", "2", "--bounces", "2"]
    assert cli.main(common + ["-o", out[0]]) == 0
    assert cli.main(common + ["--multichip", "-o", out[1]]) == 0
    with open(out[0], "rb") as a, open(out[1], "rb") as b:
        assert a.read() == b.read()
