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
    stack = I.stack_tables(scene["bvh_aabb"], scene["bvh_meta"],
                           scene["tri_isect"])
    linked = I.linked_tables(scene["bvh_aabb"], I.linked_nodes(
        scene["bvh_meta"], scene["bvh_links"]), scene["tri_isect"])
    for call in (lambda: I.launch_stack(stack, ro, rd),
                 lambda: I.launch_linked(linked, ro, rd),
                 lambda: I.launch_stack_depth(stack._replace(tris=None), ro,
                                              rd, 24.0)):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    with pytest.raises(ValueError, match="N, 3"):
        I.closest_hit_bvh(scene["bvh_aabb"], scene["bvh_meta"],
                          scene["tri_isect"], ro.T, rd.T)


# K7's and K8's staged tables (ops/intersect.py stack_tables, linked_tables):
# the records hold the original tables' bits, so they unpack to them
# exactly.


def _tables(packed):
    return {k: torch.from_numpy(np.ascontiguousarray(packed[k]))
            for k in ("bvh_aabb", "bvh_meta", "bvh_links", "tri_isect")}


def _scene_of(name, random_scene, cornell_scene):
    return random_scene if name == "random" else cornell_scene


@pytest.mark.parametrize("name", ["cornell", "random"])
def test_stack_records_unpack_to_the_tables(random_scene, cornell_scene,
                                            name):
    """K7's 32-byte records give back bvh_aabb and bvh_meta array-equal,
    the builder's fields that the record drops (a leaf's children -1, an
    interior node's offset and count 0) restored from the node's kind, and
    bit 31 of the fourth word is the box's tame flag."""
    t = _tables(_scene_of(name, random_scene, cornell_scene))
    rec = I.stack_records(t["bvh_aabb"], t["bvh_meta"])
    assert rec.dtype == torch.float32 and tuple(rec.shape) == (
        t["bvh_meta"].shape[0], 8)
    bits = rec.view(torch.int32).numpy()
    aabb = np.concatenate([bits[:, 0:3], bits[:, 4:7]], axis=1)
    np.testing.assert_array_equal(aabb.view(np.float32), t["bvh_aabb"])
    a, b = bits[:, 3] & 0x7FFFFFFF, bits[:, 7]
    np.testing.assert_array_equal(bits[:, 3] < 0,
                                  I.tame_boxes(t["bvh_aabb"]).numpy())
    leaf = b < 0
    none, zero = -np.ones_like(a), np.zeros_like(a)
    meta = np.where(leaf[:, None], np.stack([none, none, a, -b], 1),
                    np.stack([a, b, zero, zero], 1))
    np.testing.assert_array_equal(meta, t["bvh_meta"].numpy())
    assert leaf.any() and (~leaf).any()


@pytest.mark.parametrize("name", ["cornell", "random"])
def test_linked_records_unpack_to_the_tables(random_scene, cornell_scene,
                                             name):
    """K8's 48-byte records give back bvh_aabb and the linked nodes [hit,
    miss, offset, count] array-equal, then the box's tame flag and a zero
    word."""
    t = _tables(_scene_of(name, random_scene, cornell_scene))
    nodes = I.linked_nodes(t["bvh_meta"], t["bvh_links"])
    rec = I.linked_records(t["bvh_aabb"], nodes)
    bits = rec.view(torch.int32).numpy()
    assert bits.shape == (nodes.shape[0], 12)
    aabb = np.concatenate([bits[:, 0:3], bits[:, 4:7]], axis=1)
    np.testing.assert_array_equal(aabb.view(np.float32), t["bvh_aabb"])
    np.testing.assert_array_equal(bits[:, [3, 7, 8, 9]], nodes.numpy())
    tame = I.tame_boxes(t["bvh_aabb"]).numpy()
    assert tame.all()  # a built scene's boxes are all tame
    np.testing.assert_array_equal(bits[:, 10], np.where(tame, I.TAME_BIT, 0))
    np.testing.assert_array_equal(bits[:, 11], 0)


@pytest.mark.parametrize("name", ["cornell", "random"])
def test_triangle_rows_equal_tri_isect(random_scene, cornell_scene, name):
    t = _tables(_scene_of(name, random_scene, cornell_scene))
    rows = I.tri_rows(t["tri_isect"])
    assert tuple(rows.shape) == (t["tri_isect"].shape[0], 12)
    np.testing.assert_array_equal(rows[:, 0:9].numpy().view(np.uint32),
                                  t["tri_isect"].numpy().view(np.uint32))
    np.testing.assert_array_equal(rows[:, 9:12].numpy(), 0.0)


@pytest.mark.parametrize("kind", WALKS)
def test_staged_tables_are_aligned(random_scene, kind):
    """Each table is contiguous, starts on a 16-byte boundary and has rows
    of a multiple of 16 bytes (32 B a K7 record, 48 B a K8 record and a
    triangle), so every record and row is a run of 16-byte loads."""
    t = _tables(random_scene)
    if kind == "stack":
        staged = I.stack_tables(t["bvh_aabb"], t["bvh_meta"], t["tri_isect"])
        width = 8
    else:
        staged = I.linked_tables(t["bvh_aabb"],
                                 I.linked_nodes(t["bvh_meta"],
                                                t["bvh_links"]),
                                 t["tri_isect"])
        width = 12
    assert staged.nodes.shape[1] == width
    for x in (staged.nodes, staged.tris):
        assert x.is_contiguous() and x.data_ptr() % 16 == 0
        assert (x.shape[1] * x.element_size()) % 16 == 0
    assert I.stack_tables(t["bvh_aabb"], t["bvh_meta"]).tris is None


def test_tame_boxes_keep_the_fast_division_exact():
    """A box is tame when each coordinate is 0, NaN or within [2^-40, 2^39]
    in magnitude; a subnormal, a tiny, a huge or an infinite coordinate
    makes it untame, whatever its sign."""
    boxes = np.zeros((9, 6), np.float32)
    boxes[:, 3:6] = 1.0
    boxes[1, 0] = np.nan
    boxes[2, 1] = -(2.0 ** -40)
    boxes[3, 5] = 2.0 ** 39
    boxes[4, 2] = 1e-40  # subnormal
    boxes[5, 4] = -(2.0 ** -41)
    boxes[6, 3] = 2.0 ** 40
    boxes[7, 0] = -np.inf
    boxes[8, 0] = -0.0
    got = I.tame_boxes(torch.from_numpy(boxes)).numpy()
    np.testing.assert_array_equal(got, [True, True, True, True, False,
                                        False, False, False, True])


@pytest.mark.parametrize("broken", ["negative_count", "negative_right",
                                    "negative_left"])
def test_stack_records_raise_on_a_table_they_cannot_hold(random_scene,
                                                         broken):
    """K7's record tells a leaf from an interior node by the sign of its
    last field and keeps the tame flag in the sign bit of its fourth: a
    count below 0, or an interior node's child below 0, would be misread,
    so staging such a table raises."""
    t = _tables(random_scene)
    meta = t["bvh_meta"].clone()
    interior = int(np.nonzero(meta[:, 3].numpy() == 0)[0][0])
    if broken == "negative_count":
        meta[interior, 3] = -1
    elif broken == "negative_right":
        meta[interior, 1] = -5
    else:
        meta[interior, 0] = -2
    with pytest.raises(ValueError, match="count >= 0"):
        I.stack_records(t["bvh_aabb"], meta)
    with pytest.raises(ValueError, match="count >= 0"):
        I.stack_tables(t["bvh_aabb"], meta, t["tri_isect"])


@pytest.mark.parametrize("kind", WALKS)
def test_make_closest_hit_stages_once_per_scene(monkeypatch, kind):
    """The closure stages its kernel's tables once, when it is made, and
    never on a call; CPU calls take the plain version over the scene's own
    tables (a card test holds the CUDA calls to the staged tables)."""
    scene = load_jax_scene(pack_device_scene(cornell_box()), "cpu")
    name = "stack_tables" if kind == "stack" else "linked_tables"
    made = []
    stage = getattr(I, name)
    monkeypatch.setattr(I, name,
                        lambda *a: made.append(stage(*a)) or made[-1])
    walk = "closest_hit_bvh" if kind == "stack" else "closest_hit_bvh_linked"
    call, plain_calls = getattr(I, walk), []

    def spy(*args, **kw):
        plain_calls.append(args[0:3])
        return call(*args, **kw)

    monkeypatch.setattr(I, walk, spy)
    ch = I.make_closest_hit(scene, kind)
    assert len(made) == 1
    rng = np.random.default_rng(8)
    packed = pack_device_scene(cornell_box())
    for _ in range(3):
        ro = np.tile([[0.0, 1.0, 0.0]], (64, 1)).astype(np.float32)
        rd = _unit(rng, 64).astype(np.float32)
        t, _ = ch(torch.from_numpy(ro.T.copy()), torch.from_numpy(rd.T.copy()))
        np.testing.assert_array_equal(t.numpy(), _brute(packed, ro, rd)[0])
    assert len(made) == 1 and len(plain_calls) == 3
    assert all(args[0] is scene["bvh_aabb"] for args in plain_calls)
    assert isinstance(made[0], I.BVH2Tables)
    ch2 = I.make_closest_hit(scene, kind)
    assert len(made) == 2 and ch2.strategy == kind


@pytest.mark.parametrize("kind", WALKS)
def test_bounce_calls_walk_in_ray_order(monkeypatch, kind):
    """On a tree of BVH2_REORDER_MIN_NODES[kind] binary nodes or more
    (lowered here to this tree's count), a call with ``reorder`` walks its rays in
    ``ray_order`` (calls of at least REORDER_MIN_LANES rays; lowered here
    to 64) and gives each ray the answer of the unsorted call, ``active``
    and ``t_max`` included; a camera call (``reorder`` False) is not
    sorted, and neither is a bounce call on a tree one node below the
    threshold."""
    scene = load_jax_scene(pack_device_scene(random_triangles(1500, seed=5)),
                           "cpu")
    nodes = scene["bvh_aabb"].shape[0]
    monkeypatch.setattr(I, "REORDER_MIN_LANES", 64)
    sorts = []
    order = I.ray_order
    monkeypatch.setattr(I, "ray_order",
                        lambda *a: sorts.append(1) or order(*a))
    monkeypatch.setitem(I.BVH2_REORDER_MIN_NODES, kind, nodes)
    ch = I.make_closest_hit(scene, kind)
    packed = pack_device_scene(random_triangles(1500, seed=5))
    ro, rd = _aimed_rays(packed, 256, 14)
    rng = np.random.default_rng(15)
    kw = dict(active=torch.from_numpy(rng.random(256) > 0.3),
              t_max=torch.from_numpy(rng.uniform(8.0, 20.0, 256).astype(
                  np.float32)))
    o, d = torch.from_numpy(ro.T.copy()), torch.from_numpy(rd.T.copy())
    bare = ch(o, d, **kw)
    assert not sorts
    got = ch(o, d, reorder=True, **kw)
    assert len(sorts) == 1
    np.testing.assert_array_equal(got[0].numpy().view(np.uint32),
                                  bare[0].numpy().view(np.uint32))
    np.testing.assert_array_equal(got[1].numpy(), bare[1].numpy())
    assert (bare[1].numpy() >= 0).sum() > 20
    monkeypatch.setitem(I.BVH2_REORDER_MIN_NODES, kind, nodes + 1)
    I.make_closest_hit(scene, kind)(o, d, reorder=True, **kw)
    assert len(sorts) == 1
