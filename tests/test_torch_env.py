"""Environment maps (``ops/env.py``, the miss term of ``ops/trace.py::
bounce_core``) against the JAX package's ``ops/env.py`` and ``Renderer``.

The sampler picks a texel by ``atan2`` and ``acos`` of the direction: the
port rounds each operation as PyTorch does, XLA:CPU fuses and uses its own
transcendentals, so a direction within a hair of a texel edge may land on
the neighbouring texel. Away from the edges (1e-4 of a texel) the indices
are equal exactly; at the edges at most 1% may flip (measured: none of
40,000 directions at each of three rotations differs at all). The 24x24 render with a map is held to the JAX ``Renderer``
with the golden test's bars, each pixel beyond them arbitrated by the
scalar oracle (``tests/oracle.py``) with the same map's miss term added.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from wgpu_path_tracing_tpu import Renderer as JRenderer
from wgpu_path_tracing_tpu import RenderConfig as JRenderConfig
from wgpu_path_tracing_tpu.models import procedural as JP
from wgpu_path_tracing_tpu.ops import env as JENV
from wgpu_path_tracing_tpu.ops.vec import V3 as JV3
from wgpu_path_tracing_tpu.utils import image as JIMAGE
from wgpu_path_tracing_tpu_torch import (
    Renderer,
    RenderConfig,
    cornell_box,
    material_test_box,
)
from wgpu_path_tracing_tpu_torch.ops import bounce as K2
from wgpu_path_tracing_tpu_torch.ops import env as ENV
from wgpu_path_tracing_tpu_torch.ops.vec import V3
from wgpu_path_tracing_tpu_torch.utils import image as IMAGE
from tests import oracle as ORACLE
from tests import torch_png_cases as PNG

torch.set_num_threads(1)
F = np.float32


def gradient_env(h=8, w=16):
    """tests/test_env.py's map: sky blue above, dark ground below."""
    env = np.zeros((h, w, 3), F)
    env[: h // 2] = [0.2, 0.4, 1.0]
    env[h // 2:] = [0.1, 0.05, 0.0]
    return env


def noise_env(h=64, w=128, seed=5):
    return np.random.default_rng(seed).random((h, w, 3), dtype=F) * 2.0


def unit_dirs(n, seed):
    d = np.random.default_rng(seed).normal(size=(n, 3)).astype(F)
    return d / np.linalg.norm(d, axis=1, keepdims=True)


@pytest.mark.parametrize("rotation", [0.0, 0.7, -2.5])
def test_sampler_texels_equal_jax_away_from_edges(rotation):
    h, w = 64, 128
    # Each texel's red channel is its own index: the sample names it.
    index = np.zeros((h, w, 3), F)
    index[..., 0] = np.arange(h * w, dtype=F).reshape(h, w)
    d = unit_dirs(40_000, int(abs(rotation) * 10) + 20)
    port = ENV.make_env_sampler(torch.from_numpy(index),
                                torch.tensor([1.0, rotation]))
    got = port(V3(*(torch.from_numpy(d[:, k].copy()) for k in range(3))))
    jax_s = JENV.make_env_sampler(jnp.asarray(index),
                                  jnp.asarray([1.0, rotation], jnp.float32))
    want = np.asarray(jax_s(JV3(*(jnp.asarray(d[:, k]) for k in range(3)))).x)
    got = got.x.numpy()
    # Where a direction lies in float64: its distance to a texel edge.
    u = (np.arctan2(d[:, 2].astype(np.float64), d[:, 0]) + rotation) / (
        2 * np.pi)
    u = (u - np.floor(u)) * w
    v = np.arccos(np.clip(d[:, 1].astype(np.float64), -1, 1)) / np.pi * h
    edge = (np.minimum(np.abs(u - np.round(u)), np.abs(v - np.round(v)))
            < 1e-4)
    np.testing.assert_array_equal(got[~edge], want[~edge])
    assert (got[edge] != want[edge]).sum() <= max(1, 0.01 * edge.sum())
    iy, ix = ENV.env_texel(V3(*(torch.from_numpy(d[:, k].copy())
                                for k in range(3))), h, w, rotation)
    np.testing.assert_array_equal((iy * w + ix).numpy(), got.astype(np.int64))


def test_sampler_values_and_the_placeholder():
    """tests/test_env.py::test_env_sampler_directions, and a 1x1 map is no
    map in both packages."""
    env = torch.from_numpy(gradient_env())
    sample = ENV.make_env_sampler(env, torch.tensor([2.0, 0.0]))
    zeros, ones = torch.zeros(4), torch.ones(4)
    np.testing.assert_allclose(sample(V3(zeros, ones, zeros)).z.numpy(), 2.0)
    np.testing.assert_allclose(sample(V3(zeros, -ones, zeros)).x.numpy(),
                               0.2, rtol=1e-6)
    one = np.zeros((1, 1, 3), F)
    assert ENV.make_env_sampler(torch.from_numpy(one),
                                torch.tensor([1.0, 0.0])) is None
    assert JENV.make_env_sampler(jnp.asarray(one), jnp.asarray([1.0, 0.0])) \
        is None
    assert ENV.scene_env({"env": torch.zeros(1, 1, 3)}) is None
    assert ENV.scene_env({}) is None


@pytest.mark.parametrize("kind", ["array", "hdr", "exr", "png"])
def test_load_env_image_equals_jax(kind, tmp_path):
    env = noise_env(6, 10) * 0.5
    if kind == "array":
        source = env
    elif kind == "png":
        source = str(tmp_path / "e.png")
        IMAGE.write_png(source, np.clip(env, 0, 1))
    else:
        source = str(tmp_path / f"e.{kind}")
        {"hdr": IMAGE.write_hdr, "exr": IMAGE.write_exr}[kind](source, env)
    got = ENV.load_env_image(source)
    np.testing.assert_array_equal(got, JENV.load_env_image(source))
    assert got.shape == env.shape and got.dtype == F
    if kind in ("array", "exr"):
        np.testing.assert_array_equal(got, env)
    with pytest.raises(ValueError):
        ENV.load_env_image(np.zeros((4, 4), F))


@pytest.mark.parametrize("interlace", [0, 1])
@pytest.mark.parametrize("kind", sorted(PNG.KINDS))
def test_load_env_image_png_kinds_equal_jax(kind, interlace, tmp_path):
    """An LDR map of every PNG kind (``tests/torch_png_cases.py``: palette,
    tRNS, gray + alpha, 1/2/4-bit, 16-bit, Adam7 at odd sizes and sizes
    under 8): the port's ``load_env_image`` equals the JAX one (Pillow's
    ``convert("RGB")``), and ``read_png`` equals ``convert("RGB") / 255``."""
    from PIL import Image

    for k, (h, w) in enumerate(PNG.SIZES):
        path = tmp_path / f"{kind}_{k}.png"
        path.write_bytes(PNG.case(kind, h, w, interlace, seed=10 + k))
        got = ENV.load_env_image(str(path))
        assert got.shape == (h, w, 3) and got.dtype == F
        np.testing.assert_array_equal(got, JENV.load_env_image(str(path)))
        with Image.open(path) as ref:
            want = np.asarray(ref.convert("RGB"), F) / 255.0
        np.testing.assert_array_equal(IMAGE.read_png(str(path)), want)


def test_jpeg_env_map_raises_naming_the_file(tmp_path):
    """A hierarchical JPEG map, which neither Pillow nor the port decodes
    (Huffman- and arithmetic-coded and lossless ones the port does:
    ``tests/test_torch_jpeg.py``), raises ``NotImplementedError`` naming
    the file, through ``load_env_image`` and the ``Renderer``'s config."""
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.new("RGB", (8, 4), (90, 140, 220)).save(buf, "JPEG",
                                                  progressive=True)
    data = buf.getvalue()
    sof = data.index(b"\xff\xc2")  # SOF2 -> SOF6, hierarchical progressive
    path = tmp_path / "sky.png"  # a JPEG whatever its name says
    path.write_bytes(data[:sof + 1] + b"\xc6" + data[sof + 2:])
    with pytest.raises(NotImplementedError, match="sky.png: hierarchical"):
        ENV.load_env_image(str(path))
    jpg = tmp_path / "sky.jpg"
    jpg.write_bytes(path.read_bytes())
    r = Renderer(RenderConfig(width=8, height=8, env_map=str(jpg)),
                 device="cpu")
    with pytest.raises(NotImplementedError, match="sky.jpg"):
        r.load_scene(cornell_box())


def test_disabled_map_is_bit_identical_to_no_map():
    """tests/test_env.py::test_env_disabled_is_parity: the 1x1 map traces
    the path without a map; K2's wrapper launches no ENV instantiation."""
    r = Renderer(RenderConfig(width=16, height=16, frames_per_chunk=2,
                              max_bounces=3), device="cpu")
    r.load_scene(cornell_box())
    a = r.render(spp=2)
    r.set_environment(None)
    b = r.render(spp=2)
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))
    assert ENV.scene_env(r._scene_dev) is None


def test_env_fills_misses_and_the_config_path(tmp_path):
    """tests/test_env.py::test_env_fills_misses: the same paths gain
    radiance where rays escape and lose none; ``RenderConfig.env_map``
    installs the same map at ``load_scene``."""
    cfg = dict(width=16, height=16, max_bounces=2, do_mis=False)
    r = Renderer(RenderConfig(**cfg), device="cpu")
    r.load_scene(material_test_box())
    base = r.render(spp=2)
    env = gradient_env()
    r.set_environment(env, intensity=1.0, rotation=0.3)
    lit = r.render(spp=2)
    assert (lit + 1e-5 >= base).all() and lit.sum() > base.sum() + 1.0
    path = str(tmp_path / "sky.exr")
    IMAGE.write_exr(path, env)
    c = Renderer(RenderConfig(env_map=path, env_rotation=0.3, **cfg),
                 device="cpu")
    c.load_scene(material_test_box())
    np.testing.assert_array_equal(c.render(spp=2), lit)


def test_bounce_wrapper_with_a_map_on_cpu_runs_the_plain_version():
    """On CPU tensors K2's wrapper computes its plain version with the
    miss term and launches nothing."""
    from wgpu_path_tracing_tpu_torch.models.types import (
        load_jax_scene,
        pack_device_scene,
    )

    sc = material_test_box()
    scene = load_jax_scene(pack_device_scene(sc), "cpu")
    scene.update(ENV.env_tables(noise_env(8, 16), 1.5, 0.4, "cpu"))
    n = 512
    d = torch.from_numpy(unit_dirs(n, 3).T.copy())
    rays = torch.cat([torch.zeros((3, n)) + torch.tensor([[0.0], [1.0],
                                                          [0.0]]), d])
    args = (0, rays, torch.arange(n, dtype=torch.int64) * 7919,
            torch.ones((3, n)), torch.zeros((3, n)),
            torch.ones(n, dtype=torch.bool),
            torch.full((n,), float("inf")), torch.full((n,), -1,
                                                      dtype=torch.int32),
            scene["tri_full"], scene["light_full"])
    before = K2.Counter.env
    out = K2.bounce_stage(*args, do_mis=True, num_lights=sc.num_lights,
                          env=ENV.scene_env(scene))
    assert K2.Counter.env == before
    plain = K2.bounce_stage_plain(*args, do_mis=True,
                                  num_lights=sc.num_lights,
                                  env=ENV.scene_env(scene))
    for a, b in zip(out, plain):  # dead lanes carry NaNs: compare bits
        assert torch.equal(a.contiguous().view(torch.uint8),
                           b.contiguous().view(torch.uint8))
    # Every lane missed: the result is the map times the throughput.
    sample = ENV.make_env_sampler(*ENV.scene_env(scene))(
        V3(d[0], d[1], d[2]))
    np.testing.assert_array_equal(out[3].numpy(),
                                  torch.stack(list(sample)).numpy())
    assert not out[4].any()  # a miss ends the path


class EnvOracle(ORACLE.Oracle):
    """The scalar oracle with the map's miss term (pt.wgsl's trace with a
    miss adding ``throughput * env(rd)``, as ops/trace.py does), scalar
    float32 throughout."""

    def __init__(self, scene, camera, width, height, env, intensity,
                 rotation, max_bounces):
        super().__init__(scene, camera, width, height)
        self.env, self.intensity, self.rotation = env, F(intensity), F(
            rotation)
        self.max_bounces = max_bounces

    def env_radiance(self, rd):
        d = ORACLE.normalize(rd)
        u = F(F(np.arctan2(d[2], d[0])) + self.rotation) / F(2.0 * np.pi)
        u = F(u - np.floor(u))
        v = F(np.arccos(np.clip(d[1], F(-1.0), F(1.0)))) * F(1.0 / np.pi)
        h, w = self.env.shape[0], self.env.shape[1]
        ix = min(max(int(F(u * F(w))), 0), w - 1)
        iy = min(max(int(F(v * F(h))), 0), h - 1)
        return self.env[iy, ix] * self.intensity

    def trace(self, ro, rd):
        throughput = ORACLE.vec3(1.0, 1.0, 1.0)
        result = ORACLE.vec3()
        cur_o, cur_d = ro, rd
        for bounce in range(self.max_bounces):
            hit = self.scene_intersect(cur_o, cur_d)
            if hit is None:
                result = result + throughput * self.env_radiance(cur_d)
                break
            if np.any(hit["emission"] > 0.0):
                att = F(1.0) / (F(1.0) + hit["t"] * hit["t"])
                result = result + throughput * hit["emission"] * hit[
                    "emissive_strength"] * att
                break
            if hit["transmission"] == 0.0 and hit["is_front"]:
                ls = self.sample_light(hit["position"])
                if ls["pdf"] > 0.0:
                    v = -ORACLE.normalize(cur_d)
                    bsdf, bsdf_pdf = self.eval_bsdf(
                        hit, hit["normal"], v, ls["wi"], hit["is_front"])
                    mw = self.power_heuristic(F(1.0), ls["pdf"], F(1.0),
                                              bsdf_pdf)
                    direct = (ls["intensity"] * bsdf * mw
                              / max(ls["pdf"], ORACLE.EPSILON))
                    result = result + throughput * direct
            bsdf_dir = self.sample_bsdf(hit, cur_d, hit["is_front"])
            bsdf, pdf = self.eval_bsdf(hit, hit["normal"],
                                       -ORACLE.normalize(cur_d), bsdf_dir,
                                       hit["is_front"])
            if pdf <= 0.0:
                break
            cur_o = hit["position"] + bsdf_dir * ORACLE.EPSILON
            cur_d = ORACLE.normalize(bsdf_dir)
            throughput = throughput * bsdf / max(pdf, ORACLE.EPSILON)
            if bounce > 2:
                p = F(max(throughput[0], max(throughput[1], throughput[2])))
                if self.rng.rand() > p:
                    break
                throughput = throughput / p
        return result


def _oracle_mean(oracle, px, py, spp):
    acc = np.zeros(3, F)
    for frame in range(spp):
        color = np.minimum(np.asarray(oracle.render_pixel(px, py, frame), F),
                           F(2.5))
        w = F(1.0) / (F(frame) + F(1.0))
        acc = acc * (F(1.0) - w) + color * w
    return acc


def test_env_render_matches_jax_renderer():
    """24x24, 2 spp, max_bounces 2, the open material box under a 64x128
    map turned by 0.7 rad: >= 99% of pixels within 5e-4 of the JAX image
    or, where not, within 2e-3 of the oracle's mean, at most 5 off both,
    the means within 1e-3 (the bars of tests/test_torch_renderer.py).
    Measured: 11 of 576 pixels beyond 5e-4 of the JAX image, none of them
    off the oracle."""
    env, intensity, rotation = noise_env(), 1.5, 0.7
    r = Renderer(RenderConfig(width=24, height=24, max_bounces=2),
                 device="cpu")
    r.load_scene(material_test_box())
    r.set_environment(env, intensity=intensity, rotation=rotation)
    buf = r.render(spp=2)
    j = JRenderer(JRenderConfig(width=24, height=24, max_bounces=2,
                                frames_per_chunk=2))
    j.load_scene(JP.material_test_box())
    j.set_environment(env, intensity=intensity, rotation=rotation)
    ref = np.asarray(j.render(spp=2))
    close = np.isclose(buf, ref, rtol=5e-4, atol=5e-4).all(-1)
    oracle = EnvOracle(material_test_box(), r.camera.as_pytree(), 24, 24,
                       env, intensity, rotation, max_bounces=2)
    ys, xs = np.nonzero(~close)
    off_both = [(px, py) for px, py in zip(xs, ys)
                if not np.allclose(buf[py, px], _oracle_mean(oracle, px, py, 2),
                                   rtol=2e-3, atol=2e-3)]
    report = (f"{len(xs)} of {close.size} pixels outside 5e-4 of the JAX "
              f"render, {len(off_both)} of them off the oracle too: {off_both}")
    assert close.size - len(off_both) >= 0.99 * close.size, report
    assert len(off_both) <= 5, report
    assert abs(buf.mean() / ref.mean() - 1.0) < 1e-3
    lit = buf.mean()
    r.set_environment(None)
    assert r.render(spp=2).mean() < lit  # the map added light
