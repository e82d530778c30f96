"""K7 and K8's plain versions (the binary-BVH walks) against the JAX walks
and the port's dense hit, and the scene pack's BVH tables.

The same numpy-made rays go through the port's ``closest_hit_bvh_plain``
and ``closest_hit_bvh_linked_plain`` (which the K7 and K8 wrappers run for
CPU tensors), the JAX package's ``closest_hit_bvh`` and
``closest_hit_bvh_linked`` on the CPU, and the port's dense
``closest_hit_brute``. Tolerances:

* Against the port's dense hit: the same per-operation rounding, so hits
  and misses agree exactly, and t is bit-equal wherever the winner is the
  same triangle; a winner may differ only on an exact-t tie (two triangles
  with the same t, reached in another order).
* Against the JAX walks: hits and misses agree, except where the JAX
  package's own dense hit sides with the JAX walk (a razor hit that
  XLA:CPU's fused multiply-adds decide the other way), on at most 0.5% of
  lanes; idx agrees except on a near tie (the port's t of the JAX winner
  within 1 ulp of the port's own t), and on rays that start on the walls'
  planes (every hit a razor hit, which XLA decides one way in one fusion
  and the other way in another) on 98% of the lanes both hit; t within
  rtol 1e-4 / atol 1e-5 plus 8 ulp a unit of the hit's condition number,
  as ``tests/test_torch_walk.py`` holds the wide walk to the JAX one.
* On a spine tree whose geometry keeps every hit away from a triangle's
  edges, the stack's overflow clamp and the step cap give the JAX walk's
  (t, idx) exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import left_spine
from wgpu_path_tracing_tpu.models import procedural as JP
from wgpu_path_tracing_tpu.models.types import pack_device_scene as jpack
from wgpu_path_tracing_tpu.ops.intersect import closest_hit_brute as jbrute
from wgpu_path_tracing_tpu.ops.intersect import closest_hit_bvh as jstack
from wgpu_path_tracing_tpu.ops.intersect import (
    closest_hit_bvh_linked as jlinked,
)
from wgpu_path_tracing_tpu import Renderer as JRenderer
from wgpu_path_tracing_tpu import RenderConfig as JConfig
from wgpu_path_tracing_tpu_torch import (
    Renderer,
    RenderConfig,
    cornell_box,
    load_jax_scene,
    material_test_box,
    random_triangles,
)
from wgpu_path_tracing_tpu_torch.models.types import pack_device_scene
from wgpu_path_tracing_tpu_torch.ops import intersect as I

# One thread a worker: PyTorch's OpenMP teams spin against each other under
# the suite's parallel workers.
torch.set_num_threads(1)

WALKS = ("stack", "bvh")


@pytest.fixture(scope="module")
def random_scene():
    return jpack(JP.random_triangles(1500, seed=5))


@pytest.fixture(scope="module")
def cornell_scene():
    return jpack(JP.cornell_box(tessellation=4))


def _nodes(packed):
    return np.concatenate([packed["bvh_links"], packed["bvh_meta"][:, 2:4]],
                          axis=1)


def _port(kind, packed, ro, rd, active=None, t_max=None, **kw):
    t = {k: torch.from_numpy(np.ascontiguousarray(packed[k]))
         for k in ("bvh_aabb", "bvh_meta", "tri_isect")}
    args = [torch.from_numpy(ro), torch.from_numpy(rd)]
    opt = dict(active=None if active is None else torch.from_numpy(active),
               t_max=None if t_max is None else torch.from_numpy(t_max), **kw)
    if kind == "stack":
        bt, bi = I.closest_hit_bvh(t["bvh_aabb"], t["bvh_meta"],
                                   t["tri_isect"], *args, **opt)
    else:
        bt, bi = I.closest_hit_bvh_linked(
            t["bvh_aabb"], torch.from_numpy(_nodes(packed)), t["tri_isect"],
            *args, **opt)
    return bt.numpy(), bi.numpy()


def _jax(kind, packed, ro, rd, active=None, t_max=None, **kw):
    opt = dict(active=None if active is None else jnp.asarray(active),
               t_max=None if t_max is None else jnp.asarray(t_max), **kw)
    aabb, tri = jnp.asarray(packed["bvh_aabb"]), jnp.asarray(
        packed["tri_isect"])
    if kind == "stack":
        t, i = jstack(aabb, jnp.asarray(packed["bvh_meta"]), tri,
                      jnp.asarray(ro), jnp.asarray(rd), **opt)
    else:
        t, i = jlinked(aabb, jnp.asarray(_nodes(packed)), tri,
                       jnp.asarray(ro), jnp.asarray(rd), **opt)
    return np.asarray(t), np.asarray(i)


def _brute(packed, ro, rd):
    t, i = I.closest_hit_brute(torch.from_numpy(packed["tri_isect"]),
                               torch.from_numpy(ro), torch.from_numpy(rd))
    return t.numpy(), i.numpy()


def _t_of(packed, ro, rd, idx):
    """The port's Möller-Trumbore t of triangle idx[k] for ray k."""
    tri = torch.from_numpy(packed["tri_isect"][idx])
    o, d = torch.from_numpy(ro), torch.from_numpy(rd)
    t, _, _, _ = I.moller_trumbore(*o.unbind(1), *d.unbind(1),
                                   *tri.unbind(1))
    return t.numpy()


def _condition(packed, ro, rd, idx):
    tri = packed["tri_isect"][idx].astype(np.float64)
    h = np.cross(rd.astype(np.float64), tri[:, 6:9])
    a = np.einsum("ij,ij->i", tri[:, 3:6], h)
    return (np.linalg.norm(tri[:, 3:6], axis=1) * np.linalg.norm(h, axis=1)
            / np.abs(a))


def _unit(rng, n):
    d = rng.normal(size=(n, 3))
    return d / np.linalg.norm(d, axis=1, keepdims=True)


def _aimed_rays(packed, n, seed):
    """Rays from 14 units out aimed at random triangle centroids."""
    rng = np.random.default_rng(seed)
    tri = packed["tri_isect"]
    cent = tri[:, 0:3] + (tri[:, 3:6] + tri[:, 6:9]) / 3.0
    d = _unit(rng, n)
    tgt = cent[rng.integers(0, len(tri), n)]
    return (tgt - d * 14).astype(np.float32), d.astype(np.float32)


def _random_rays(packed, n, seed):
    """Origins anywhere in the scene's bounds, directions uniform."""
    rng = np.random.default_rng(seed)
    lo, hi = packed["bvh_aabb"][0, 0:3], packed["bvh_aabb"][0, 3:6]
    return (rng.uniform(lo, hi, (n, 3)).astype(np.float32),
            _unit(rng, n).astype(np.float32))


def _plane_rays(packed, n, seed):
    """Origins on a face plane of a BVH node's box with that direction
    component exactly zero (and a third of them a second one): the slab
    test's 0/0 = NaN case, which misses the box in both packages."""
    rng = np.random.default_rng(seed)
    boxes = packed["bvh_aabb"]
    pick = boxes[rng.integers(0, len(boxes), n)]
    o = rng.uniform(pick[:, 0:3], pick[:, 3:6])
    plane = rng.integers(0, 3, n)
    side = rng.integers(0, 2, n) * 3
    o[np.arange(n), plane] = pick[np.arange(n), plane + side]
    d = rng.normal(size=(n, 3))
    d[np.arange(n), plane] = 0.0
    rows = np.arange(0, n, 3)
    d[rows, (plane[rows] + 1) % 3] = 0.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


RAYS = {
    "aimed": lambda s, c: (s, *_aimed_rays(s, 512, 1)),
    "random": lambda s, c: (c, *_random_rays(c, 512, 2)),
    "box_planes": lambda s, c: (c, *_plane_rays(c, 512, 3)),
}


PACK_SCENES = {
    "cornell_box": (cornell_box, JP.cornell_box),
    "material_test_box": (material_test_box, JP.material_test_box),
    "tessellated": (lambda: cornell_box(tessellation=3),
                    lambda: JP.cornell_box(tessellation=3)),
    "random": (lambda: random_triangles(300, seed=2),
               lambda: JP.random_triangles(300, seed=2)),
}


@pytest.mark.parametrize("name", list(PACK_SCENES))
def test_pack_holds_the_jax_bvh_tables(name):
    """bvh_aabb, bvh_meta and bvh_links are array-equal to the JAX pack's
    and reach the device as int32 and float32."""
    port = pack_device_scene(PACK_SCENES[name][0]())
    ref = jpack(PACK_SCENES[name][1]())
    for key in ("bvh_aabb", "bvh_meta", "bvh_links"):
        assert port[key].dtype == ref[key].dtype, key
        np.testing.assert_array_equal(port[key], ref[key], err_msg=key)
    dev = load_jax_scene(port, "cpu")
    assert dev["bvh_links"].dtype == dev["bvh_meta"].dtype == torch.int32
    assert dev["bvh_aabb"].dtype == torch.float32


@pytest.mark.parametrize("kind", WALKS)
@pytest.mark.parametrize("rays", list(RAYS))
def test_walk_matches_brute_and_jax(random_scene, cornell_scene, kind, rays):
    packed, ro, rd = RAYS[rays](random_scene, cornell_scene)
    t, i = _port(kind, packed, ro, rd)
    bt, bi = _brute(packed, ro, rd)
    jt, ji = _jax(kind, packed, ro, rd)
    hit = i >= 0
    assert hit.sum() >= 100
    if rays == "box_planes":
        # A box whose face plane holds the origin along a zero direction
        # component is missed (0/0 = NaN in the slab test), in both
        # packages, so the walks lose hits the dense hit finds.
        assert (hit < (bi >= 0)).sum() > 50
        assert (t >= bt).all()
    else:
        np.testing.assert_array_equal(hit, bi >= 0)
        np.testing.assert_array_equal(t[i != bi], bt[i != bi])
    same = i == bi
    np.testing.assert_array_equal(t[same].view(np.uint32),
                                  bt[same].view(np.uint32))
    np.testing.assert_array_equal(t[~hit], np.inf)
    jhit = ji >= 0
    apart = hit != jhit
    _, jbi = jbrute(jnp.asarray(packed["tri_isect"]), jnp.asarray(ro),
                    jnp.asarray(rd))
    jbi = np.asarray(jbi)
    np.testing.assert_array_equal(jhit[apart], jbi[apart] >= 0)
    assert apart.sum() <= 0.005 * len(hit)
    hit = hit & jhit
    diff = np.nonzero(hit & (i != ji))[0]
    if rays == "box_planes":
        # Origins on the walls' planes: every hit is a razor hit, which
        # XLA's fused multiply-adds decide one way in one fusion and the
        # other way in another (its dense hit and its walk disagree there
        # too).
        assert len(diff) <= 0.02 * len(hit)
    else:
        np.testing.assert_array_max_ulp(
            _t_of(packed, ro[diff], rd[diff], ji[diff]), t[diff], maxulp=1)
    hit = hit & (i == ji)
    bound = 1e-4 * np.abs(jt[hit]) + 1e-5 + 8 * np.spacing(t[hit]) * (
        _condition(packed, ro[hit], rd[hit], i[hit]))
    assert (np.abs(t[hit] - jt[hit]) <= bound).all()


@pytest.mark.parametrize("kind", WALKS)
@pytest.mark.parametrize("scene", ["random", "cornell"])
def test_any_hit_gives_the_occlusion_answer(random_scene, cornell_scene,
                                            kind, scene):
    if scene == "random":
        packed, (ro, rd) = random_scene, _aimed_rays(random_scene, 512, 4)
        lo, hi = 10.0, 18.0
    else:
        packed, (ro, rd) = cornell_scene, _random_rays(cornell_scene, 512, 5)
        lo, hi = 0.05, 2.0
    t_max = np.random.default_rng(6).uniform(lo, hi, 512).astype(np.float32)
    t, i = _port(kind, packed, ro, rd, t_max=t_max, any_hit=True)
    bt, _ = _brute(packed, ro, rd)
    occluded = bt < t_max
    assert 50 < occluded.sum() < 462
    np.testing.assert_array_equal(t < t_max, occluded)
    hit = i >= 0
    np.testing.assert_array_equal(_t_of(packed, ro[hit], rd[hit], i[hit]),
                                  t[hit])
    jt, _ = _jax(kind, packed, ro, rd, t_max=t_max, any_hit=True)
    np.testing.assert_array_equal(jt < t_max, occluded)


@pytest.mark.parametrize("kind", WALKS)
def test_inactive_lanes_miss(random_scene, kind):
    ro, rd = _aimed_rays(random_scene, 512, 7)
    active = np.arange(512) % 3 != 0
    t, i = _port(kind, random_scene, ro, rd, active=active)
    full_t, full_i = _port(kind, random_scene, ro, rd)
    np.testing.assert_array_equal(t[~active], np.inf)
    np.testing.assert_array_equal(i[~active], -1)
    np.testing.assert_array_equal(t[active], full_t[active])
    np.testing.assert_array_equal(i[active], full_i[active])
    _, ji = _jax(kind, random_scene, ro, rd, active=active)
    np.testing.assert_array_equal(ji < 0, i < 0)


def _spine_case(levels, n, seed):
    spine = left_spine(levels)
    rng = np.random.default_rng(seed)
    o = rng.uniform([-1.0, 0.2, 0.2], [levels + 1.0, 0.7, 0.7], (n, 3))
    d = rng.normal(scale=[1.0, 0.1, 0.1], size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return spine, o.astype(np.float32), d.astype(np.float32)


@pytest.mark.parametrize("depth,steps", [(2, 40), (3, 60), (5, 200),
                                         (64, 10_000)])
def test_stack_overflow_clamp_and_step_cap_match_jax(depth, steps):
    """A left spine of 12 levels keeps a right leaf a level on the stack: a
    stack of fewer entries overflows, the left child overwrites the top
    slot, a pointer past the stack reads the root again, and the walk runs
    to its step cap. The port's (t, idx) equal the JAX walk's exactly."""
    spine, ro, rd = _spine_case(12, 256, 11)
    t, i = _port("stack", spine, ro, rd, stack_depth=depth, max_steps=steps)
    jt, ji = _jax("stack", spine, ro, rd, stack_depth=depth, max_steps=steps)
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_allclose(t, jt, rtol=1e-6)
    if depth == 64:  # deep enough: the dense hit's answer
        bt, bi = _brute(spine, ro, rd)
        np.testing.assert_array_equal(i, bi)
    else:
        full_t, full_i = _port("stack", spine, ro, rd)
        assert (full_i != i).any()  # the clamp changed some answers


@pytest.mark.parametrize("steps", [1, 7, 30])
def test_linked_step_cap_matches_jax(steps):
    spine, ro, rd = _spine_case(12, 256, 12)
    t, i = _port("bvh", spine, ro, rd, max_steps=steps)
    jt, ji = _jax("bvh", spine, ro, rd, max_steps=steps)
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_allclose(t, jt, rtol=1e-6)


@pytest.mark.parametrize("kind", WALKS)
def test_leaf_size_caps_the_leaf_tests(cornell_scene, kind):
    """Only the first ``leaf_size`` triangles of a leaf are tested, as in
    the JAX walks: leaf_size 1 misses triangles the full walk finds."""
    ro, rd = _random_rays(cornell_scene, 512, 9)
    t, i = _port(kind, cornell_scene, ro, rd, leaf_size=1)
    jt, ji = _jax(kind, cornell_scene, ro, rd, leaf_size=1)
    full_t, _ = _port(kind, cornell_scene, ro, rd)
    assert (np.isinf(t) & np.isfinite(full_t)).sum() > 10
    np.testing.assert_array_equal(i < 0, ji < 0)


def test_bvh_depth_matches_jax_walk(cornell_scene):
    """K7's depth mode on the JAX package's own centre rays: the JAX depth
    walk's depths."""
    from wgpu_path_tracing_tpu.debug import modes as JM
    from wgpu_path_tracing_tpu.render import pipeline as jpipe
    from wgpu_path_tracing_tpu.render.camera import Camera as JCamera

    w = h = 24
    cam = jpipe.camera_device(JCamera(width=w, height=h, aspect=1.0)
                              .as_pytree(), w, h)
    want = np.asarray(JM.render_bvh_depth(cornell_scene, cam, w, h))[:, 0]
    ro, rd = JM._center_rays(cam, w, h)
    got = I.bvh_depth(torch.from_numpy(cornell_scene["bvh_aabb"]),
                      torch.from_numpy(cornell_scene["bvh_meta"]),
                      torch.from_numpy(np.array(ro)),
                      torch.from_numpy(np.array(rd)), 24.0).numpy()
    # The depths themselves are equal; XLA turns the division by the
    # constant 24 into a product with its reciprocal, one ulp off the IEEE
    # quotient the port keeps (ops/vec.py::div_const).
    np.testing.assert_array_equal(np.rint(got * 24), np.rint(want * 24))
    np.testing.assert_array_max_ulp(got, want, maxulp=1)
    assert got.max() > 0


@pytest.mark.parametrize("kind", WALKS)
def test_make_closest_hit_routes_and_reports(kind):
    scene = load_jax_scene(pack_device_scene(cornell_box()), "cpu")
    ch = I.make_closest_hit(scene, kind)
    assert ch.strategy == kind
    rng = np.random.default_rng(3)
    ro = np.tile([[0.0, 1.0, 0.0]], (256, 1)).astype(np.float32)
    rd = _unit(rng, 256).astype(np.float32)
    t, i = ch(torch.from_numpy(ro.T.copy()), torch.from_numpy(rd.T.copy()))
    bt, bi = _brute(pack_device_scene(cornell_box()), ro, rd)
    np.testing.assert_array_equal(t.numpy(), bt)  # inside the box: all hit
    r = Renderer(RenderConfig(width=8, height=8, intersector=kind),
                 device="cpu")
    r.load_scene(cornell_box())
    assert r.stats()["intersector"] == kind


@pytest.mark.parametrize("kind", WALKS)
def test_render_matches_brute_and_jax(kind):
    """24x24, 2 spp through the walk: equal to the dense hit's render (the
    same hits), and held to the JAX Renderer's with the golden test's bars
    (tests/test_torch_renderer.py): >= 99% of pixels within rtol/atol 5e-4
    of the JAX image or, where not, of the scalar oracle's mean (XLA:CPU's
    fused multiply-adds flip a shadow test now and then), at most 5 off
    both."""
    from tests.oracle import Oracle
    from tests.test_torch_renderer import _oracle_mean

    def port(intersector):
        r = Renderer(RenderConfig(width=24, height=24,
                                  intersector=intersector), device="cpu")
        r.load_scene(cornell_box())
        return r, r.render(spp=2)

    r, img = port(kind)
    np.testing.assert_array_equal(img, port("brute")[1])
    j = JRenderer(JConfig(width=24, height=24, intersector=kind))
    j.load_scene(JP.cornell_box())
    ref = np.asarray(j.render(spp=2))
    close = np.isclose(img, ref, rtol=5e-4, atol=5e-4).all(-1)
    oracle = Oracle(cornell_box(), r.camera.as_pytree(), 24, 24)
    ys, xs = np.nonzero(~close)
    off_both = [(px, py) for px, py in zip(xs, ys)
                if not np.allclose(img[py, px],
                                   _oracle_mean(oracle, px, py, 2),
                                   rtol=2e-3, atol=2e-3)]
    assert close.size - len(off_both) >= 0.99 * close.size, off_both
    assert len(off_both) <= 5, off_both


def test_wrappers_take_cpu_tensors_to_the_plain_version_only():
    scene = load_jax_scene(pack_device_scene(cornell_box()), "cpu")
    ro = torch.zeros((4, 3))
    rd = torch.ones((4, 3))
    for fn, table in ((I.closest_hit_bvh_cuda, scene["bvh_meta"]),
                      (I.closest_hit_bvh_linked_cuda, I.linked_nodes(
                          scene["bvh_meta"], scene["bvh_links"]))):
        with pytest.raises(ValueError, match="CUDA"):
            fn(scene["bvh_aabb"], table, scene["tri_isect"], ro, rd)
    with pytest.raises(ValueError, match="CUDA"):
        I.bvh_depth_cuda(scene["bvh_aabb"], scene["bvh_meta"], ro, rd, 24.0)
    with pytest.raises(ValueError, match="N, 3"):
        I.closest_hit_bvh(scene["bvh_aabb"], scene["bvh_meta"],
                          scene["tri_isect"], ro.T, rd.T)
