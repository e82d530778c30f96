"""The 16-wide walk and the "slice" pack: the port's collapse against the JAX
package's NumPy builder, and K3's plain version on those tables against the
JAX walk and the port's dense hit.

* The tables of ``build_wide_bvh`` at every pack ("none", "ffd", "slice")
  and width (8, 16) are array-equal (NaN bits included) to the JAX NumPy
  builder's; the JAX side's native builders are patched off, as the port's
  tests of tessellated scenes do (``ROADMAP.md`` C.11).
* The plain walk reads its width from the order table, as the JAX walk
  does. Against the JAX walk (interpret mode) on the same tables and 512
  aimed rays, and against the port's dense hit, the bars are those of
  ``tests/test_torch_walk.py``: the same hits; idx equal except on an exact
  tie (the dense hit) or a near tie judged in the port's arithmetic (the JAX
  walk, whose XLA:CPU Möller-Trumbore fuses multiply-adds); t bit-equal to
  the dense hit's on the same triangle and within rtol 1e-4 / atol 1e-5 plus
  8 ulp a unit of the hit's condition number of the JAX walk's.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_walk import CSRC, _aimed_rays, _condition, _t_of
from wgpu_path_tracing_tpu.accel import bvh8 as JB
from wgpu_path_tracing_tpu.accel import native as JNATIVE
from wgpu_path_tracing_tpu.models import procedural as JP
from wgpu_path_tracing_tpu.models.types import pack_device_scene as jpack
from wgpu_path_tracing_tpu.ops.walk import closest_hit_walk as jwalk
from wgpu_path_tracing_tpu_torch import (
    Renderer,
    RenderConfig,
    cornell_box,
    load_jax_scene,
)
from wgpu_path_tracing_tpu_torch.accel import bvh8, native
from wgpu_path_tracing_tpu_torch.ops import walk
from wgpu_path_tracing_tpu_torch.ops.intersect import (
    closest_hit_brute,
    make_closest_hit,
)

# One thread a worker (ROADMAP.md C.3).
torch.set_num_threads(1)

# The collapses the walk is held on: (pack, width).
WALKED = [("ffd", 16), ("slice", 8), ("slice", 16)]


@pytest.fixture(autouse=True)
def jax_numpy(monkeypatch):
    """The JAX builders on their NumPy paths."""
    monkeypatch.setattr(JNATIVE, "native_available", lambda: False)


def _inputs(name):
    """(aabb_min, aabb_max, meta, tri_isect) of a JAX scene's binary tree."""
    sc = (JP.random_triangles(1500, seed=5) if name == "random"
          else JP.cornell_box(tessellation=4))
    packed = jpack(sc)
    tri = packed["tri_isect"][:sc.num_triangles]
    return (sc.bvh_aabb_min, sc.bvh_aabb_max, sc.bvh_meta, tri), packed


@pytest.fixture(scope="module")
def random_inputs():
    return _inputs("random")


def _bits(a):
    return np.ascontiguousarray(a).view(np.uint32)


@pytest.mark.parametrize("width", [8, 16])
@pytest.mark.parametrize("pack", ["none", "ffd", "slice"])
@pytest.mark.parametrize("name", ["random", "cornell4"])
def test_wide_tables_equal_jax(name, pack, width):
    args, _ = _inputs(name)
    port = bvh8.build_wide_bvh(*args, pack=pack, width=width,
                               prefer_native=False)
    ref = JB.build_wide_bvh(*args, pack=pack, width=width,
                            prefer_native=False)
    assert port.width == width == ref.meta.shape[1]
    np.testing.assert_array_equal(port.meta, ref.meta)
    np.testing.assert_array_equal(port.order, ref.order)
    np.testing.assert_array_equal(_bits(port.boxes), _bits(ref.boxes))
    np.testing.assert_array_equal(_bits(port.tris), _bits(ref.tris))
    assert port.num_groups == ref.num_groups
    # Every triangle sits in exactly one slot.
    idx = port.tris.reshape(-1, bvh8.group_rows(bvh8.SUB), 128)[:, 9, :]
    np.testing.assert_array_equal(np.sort(idx[idx >= 0].astype(np.int64)),
                                  np.arange(args[3].shape[0]))


def test_wider_and_sliced_trees_are_smaller(random_inputs):
    """Width 16 has fewer wide nodes than 8; "slice" fills its groups, so
    it needs no more groups than "ffd"."""
    args, _ = random_inputs
    build = lambda **kw: bvh8.build_wide_bvh(*args, prefer_native=False,
                                             **kw)
    w8, w16 = build(width=8), build(width=16)
    assert w16.num_nodes < w8.num_nodes
    assert build(pack="slice").num_groups <= w8.num_groups
    assert bvh8.wide_depth(w16.meta) <= bvh8.wide_depth(w8.meta)


def _tables_of(inputs, pack, width):
    """The (pack, width) collapse of a scene and the packed scene carrying
    it as its walk tables."""
    args, packed = inputs
    wb = bvh8.build_wide_bvh(*args, pack=pack, width=width,
                             prefer_native=False)
    scene = dict(packed, walk_order=wb.order, walk_boxes=wb.boxes,
                 walk_tris=wb.tris)
    return wb, scene


@pytest.mark.parametrize("pack, width", WALKED)
def test_plain_walk_matches_jax_and_brute(random_inputs, pack, width):
    wb, packed = _tables_of(random_inputs, pack, width)
    tables = walk.walk_tables(load_jax_scene(packed, "cpu"))
    assert tables.width == width
    assert tables.stack == bvh8.wide_depth(wb.meta) * (width - 1) + width
    nt = packed["tri_isect"].shape[0]
    ro, rd = _aimed_rays(packed, 512, 13)
    t, i = walk.closest_hit_walk(tables, torch.from_numpy(ro.T.copy()),
                                 torch.from_numpy(rd.T.copy()), num_tris=nt)
    t, i = t.numpy(), i.numpy()
    # The port's dense hit: the same hits, exact ties the only difference.
    bt, bi = closest_hit_brute(torch.from_numpy(packed["tri_isect"]),
                               torch.from_numpy(ro), torch.from_numpy(rd))
    bt, bi = bt.numpy(), bi.numpy()
    hit = i >= 0
    assert hit.sum() >= 400
    np.testing.assert_array_equal(hit, bi >= 0)
    same = i == bi
    np.testing.assert_array_equal(_bits(t[same]), _bits(bt[same]))
    np.testing.assert_array_equal(t[~same], bt[~same])
    # The JAX walk on the same tables, in interpret mode.
    jt, ji = jwalk(jnp.asarray(wb.order), jnp.asarray(wb.boxes),
                   jnp.asarray(wb.tris), jnp.asarray(ro), jnp.asarray(rd),
                   num_tris=nt, interpret=True, bn=256)
    jt, ji = np.asarray(jt), np.asarray(ji)
    np.testing.assert_array_equal(hit, ji >= 0)
    diff = np.nonzero(hit & (i != ji))[0]
    np.testing.assert_array_max_ulp(
        _t_of(packed, ro[diff], rd[diff], ji[diff]), t[diff], maxulp=1)
    bound = 1e-4 * np.abs(jt[hit]) + 1e-5 + 8 * np.spacing(t[hit]) * (
        _condition(packed, ro[hit], rd[hit], i[hit]))
    assert (np.abs(t[hit] - jt[hit]) <= bound).all()


@pytest.mark.parametrize("pack, width", WALKED)
def test_any_hit_and_masks_on_wide_tables(random_inputs, pack, width):
    """``active``, ``t_max`` and ``any_hit`` on the width-16 and sliced
    tables give the dense hit's occlusion answers."""
    _, packed = _tables_of(random_inputs, pack, width)
    tables = walk.walk_tables(load_jax_scene(packed, "cpu"))
    ro, rd = _aimed_rays(packed, 256, 14)
    o, d = torch.from_numpy(ro.T.copy()), torch.from_numpy(rd.T.copy())
    rng = np.random.default_rng(15)
    t_max = torch.from_numpy(rng.uniform(10.0, 18.0, 256).astype(np.float32))
    active = torch.from_numpy(rng.random(256) < 0.8)
    t, i = walk.closest_hit_walk(tables, o, d, active=active, t_max=t_max,
                                 num_tris=1500, any_hit=True)
    bt, _ = closest_hit_brute(torch.from_numpy(packed["tri_isect"]),
                              torch.from_numpy(ro), torch.from_numpy(rd))
    occluded = (bt < t_max) & active
    assert 20 < int(occluded.sum()) < 236
    assert torch.equal(t < t_max, occluded)
    assert (i[~active] == -1).all()


@pytest.mark.parametrize("pack, width", WALKED)
def test_plain_walk_descends_a_deeper_tree(pack, width):
    """On ``random_triangles(8000)`` the collapses have 9 to 17 wide nodes
    on two levels: the walk descends and pops, and agrees with the dense
    hit on random rays from inside the scene up to exact ties."""
    from wgpu_path_tracing_tpu_torch import random_triangles
    from wgpu_path_tracing_tpu_torch.models.types import pack_device_scene

    sc = random_triangles(8000, seed=3)
    packed = pack_device_scene(sc)
    wb = bvh8.build_wide_bvh(sc.bvh_aabb_min, sc.bvh_aabb_max, sc.bvh_meta,
                             packed["tri_isect"][:sc.num_triangles],
                             pack=pack, width=width, prefer_native=False)
    assert wb.num_nodes > 1 and bvh8.wide_depth(wb.meta) == 2
    packed.update(walk_order=wb.order, walk_boxes=wb.boxes, walk_tris=wb.tris)
    tables = walk.walk_tables(load_jax_scene(packed, "cpu"))
    rng = np.random.default_rng(18)
    lo, hi = packed["bvh_aabb"][0, 0:3], packed["bvh_aabb"][0, 3:6]
    o = rng.uniform(lo, hi, (1024, 3)).astype(np.float32)
    d = rng.normal(size=(1024, 3)).astype(np.float32)
    t, i = walk.closest_hit_walk(tables, torch.from_numpy(o.T.copy()),
                                 torch.from_numpy(d.T.copy()), num_tris=8000)
    bt, bi = closest_hit_brute(torch.from_numpy(packed["tri_isect"]),
                               torch.from_numpy(o), torch.from_numpy(d))
    assert torch.equal(i >= 0, bi >= 0) and int((i >= 0).sum()) > 256
    same = i == bi
    assert torch.equal(t[same].view(torch.int32), bt[same].view(torch.int32))
    assert torch.equal(t[~same], bt[~same])


def test_empty_scene_at_width_16():
    empty = (np.zeros((1, 3), np.float32), np.zeros((1, 3), np.float32),
             np.zeros((1, 4), np.int32), np.zeros((0, 9), np.float32))
    for pack in ("ffd", "slice"):
        wb = bvh8.build_wide_bvh(*empty, pack=pack, width=16)
        ref = JB.build_wide_bvh(*empty, pack=pack, width=16)
        assert wb.order.shape == (1, 128) and wb.boxes.shape == (128, 8)
        np.testing.assert_array_equal(_bits(wb.boxes), _bits(ref.boxes))
        np.testing.assert_array_equal(_bits(wb.tris), _bits(ref.tris))
    scene = {"walk_order": torch.from_numpy(wb.order),
             "walk_boxes": torch.from_numpy(wb.boxes),
             "walk_tris": torch.from_numpy(wb.tris)}
    tables = walk.walk_tables(scene)
    assert tables.width == 16
    rng = np.random.default_rng(16)
    o = torch.from_numpy(rng.normal(size=(3, 64)).astype(np.float32))
    d = torch.from_numpy(rng.normal(size=(3, 64)).astype(np.float32))
    t, i = walk.closest_hit_walk(tables, o, d)
    assert torch.isinf(t).all() and (i == -1).all()


def test_make_closest_hit_walks_width_16_tables(random_inputs):
    """A scene dict carrying width-16 walk tables: ``make_closest_hit``
    takes the walk, which walks them (the route for bounce rays included),
    and agrees with the dense hit up to exact ties."""
    _, packed = _tables_of(random_inputs, "ffd", 16)
    scene = load_jax_scene(packed, "cpu")
    assert scene["walk_order"].shape[1] == 128
    ch = make_closest_hit(scene, "walk")
    assert ch.strategy == "walk"
    ro, rd = _aimed_rays(packed, 256, 17)
    o, d = torch.from_numpy(ro.T.copy()), torch.from_numpy(rd.T.copy())
    bt, bi = closest_hit_brute(scene["tri_isect"], torch.from_numpy(ro),
                               torch.from_numpy(rd))
    for reorder in (False, True):
        t, i = ch(o, d, reorder=reorder)
        same = i == bi
        assert torch.equal(i >= 0, bi >= 0)
        assert torch.equal(t[same].view(torch.int32),
                           bt[same].view(torch.int32))
        assert torch.equal(t[~same], bt[~same])


def test_kernel_wrapper_checks_the_nodes_per_width(random_inputs,
                                                   monkeypatch):
    """At width 8 a 32-bit stack entry holds the node beside the 8-bit
    mask; at 16 the team's stack holds the metas, so the int32 node ids
    are the limit. The wrapper refuses a tree with more nodes, at each
    width."""
    assert walk.MAX_NODES == {8: 1 << 24, 16: 1 << 31}
    assert walk.LAUNCHERS == {8: "wpt_walk", 16: "wpt_walk16"}
    _, packed = _tables_of(random_inputs, "ffd", 16)
    tables = walk.walk_tables(load_jax_scene(packed, "cpu"))
    monkeypatch.setattr(walk, "MAX_NODES", {8: 1 << 24, 16: 0})
    with pytest.raises(ValueError, match="wide nodes at width 16"):
        walk.closest_hit_walk_cuda(tables, torch.zeros((3, 8)),
                                   torch.ones((3, 8)))


def test_team_walk_layout_and_its_stack_limit(random_inputs):
    """K3-w16 walks a ray with TEAM lanes (``csrc/walk.cu`` kTeam), and its
    stack is a team's 16 metas and entry distances a level: the wrapper
    takes the most levels that shared memory holds at that size and
    refuses one more, before it looks at the device."""
    with open(f"{CSRC}/walk.cu") as f:
        src = f.read()
    team = int(re.search(r"constexpr int kTeam = (\d+);", src).group(1))
    assert team == walk.TEAM and walk.WIDTHS[1] % team == 0
    assert walk.STACK_BYTES == {8: 4 * walk.THREADS,
                                16: (4 + 4) * 16 * walk.THREADS // team}
    _, packed = _tables_of(random_inputs, "ffd", 16)
    tables = walk.walk_tables(load_jax_scene(packed, "cpu"))
    most = walk.SHARED_MAX // walk.STACK_BYTES[16]
    rays = (torch.zeros((3, 8)), torch.ones((3, 8)))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        walk.closest_hit_walk_cuda(tables._replace(levels=most), *rays)
    with pytest.raises(ValueError, match="stack"):
        walk.closest_hit_walk_cuda(tables._replace(levels=most + 1), *rays)


@pytest.mark.parametrize("any_hit", [False, True])
def test_plain_walk_counts_each_rays_visits(random_inputs, any_hit):
    """``ray_visits`` (the lever tool's per-ray counts) leaves the answer as
    it is; its interior and leaf counts sum to ``visits``' totals, every
    ray pops at least the root, and a pop is a visit or a cull."""
    _, packed = _tables_of(random_inputs, "ffd", 16)
    tables = walk.walk_tables(load_jax_scene(packed, "cpu"))
    ro, rd = _aimed_rays(packed, 300, 21)
    o, d = torch.from_numpy(ro.T.copy()), torch.from_numpy(rd.T.copy())
    kw = dict(t_max=torch.full((300,), 1e9), any_hit=True) if any_hit else {}
    per_ray, totals = {}, {}
    t, i = walk.closest_hit_walk_plain(tables, o, d, ray_visits=per_ray,
                                       visits=totals, **kw)
    t0, i0 = walk.closest_hit_walk_plain(tables, o, d, **kw)
    assert torch.equal(t.view(torch.int32), t0.view(torch.int32))
    assert torch.equal(i, i0)
    for key in ("interior", "leaf"):
        assert per_ray[key].shape == (300,)
        assert int(per_ray[key].sum()) == totals[key]
    assert bool((per_ray["pops"] >= 1).all())
    assert bool((per_ray["pops"] >= per_ray["interior"]
                 + per_ray["leaf"]).all())


def test_width_16_and_slice_skip_the_native_builder(random_inputs,
                                                    monkeypatch):
    """Only "none" and "ffd" at width 8 have a C++ twin; every other
    combination builds in NumPy even when the library is there."""
    args, _ = random_inputs

    def refuse(*a, **kw):
        raise AssertionError("the native collapse was called")

    monkeypatch.setattr(native, "native_available", lambda: True)
    monkeypatch.setattr(native, "build_wide_native", refuse)
    for pack, width in WALKED:
        wb = bvh8.build_wide_bvh(*args, pack=pack, width=width)
        assert wb.width == width
    with pytest.raises(AssertionError, match="native collapse"):
        bvh8.build_wide_bvh(*args, pack="ffd", width=8)
    with pytest.raises(ValueError, match="width"):
        bvh8.build_wide_bvh(*args, width=12)


def test_walk_hbm_renders_as_the_walk():
    """"walk_hbm" (the JAX package's paged walk, the resident walk's
    function) runs K3: its image equals "walk"'s on every pixel, and
    ``stats()`` names it."""
    images = {}
    for name in ("walk", "walk_hbm"):
        r = Renderer(RenderConfig(width=16, height=16, intersector=name,
                                  max_bounces=3), device="cpu")
        r.load_scene(cornell_box(tessellation=5))
        images[name] = r.render(spp=1)
        assert r.stats()["intersector"] == name
    np.testing.assert_array_equal(_bits(images["walk"]),
                                  _bits(images["walk_hbm"]))
