"""K3's plain version (the wide-BVH walk) against the JAX walk and the
port's dense hit.

The same numpy-made rays go through the port's ``closest_hit_walk_plain``
(which the K3 wrapper runs for CPU tensors), the JAX package's
``closest_hit_walk`` in interpret mode and the port's dense
``closest_hit_brute``. Tolerances:

* Against the port's dense hit: the same per-operation rounding, so hits and
  misses agree exactly, and t is bit-equal wherever the winner is the same
  triangle. A winner may differ only on an exact tie (two triangles with the
  same t, reached in another order).
* Against the JAX walk: hits and misses agree, except on at most 0.5% of
  lanes where the JAX walk misses a ray along a box face and the JAX
  package's own dense hit sides with the port; idx agrees except on
  a near tie, judged in the port's arithmetic: the port's t of JAX's
  triangle is within 1 ulp of the port's own t (two triangles meeting at
  the hit point; XLA:CPU fuses the Möller-Trumbore multiply-adds into FMAs
  and PyTorch rounds every operation, so the two order such a pair
  differently). t is within rtol 1e-4 / atol 1e-5, as tests/test_walk.py
  holds the JAX walk to brute, plus 8 ulp of t per unit of the hit's
  condition number |e1| |d x e2| / |a|: a grazing hit amplifies the
  different rounding (one aimed ray at a condition number near 4000
  differs by 2e-4 of t, and the JAX walk and the JAX brute differ there
  by 1e-4).
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import spine_rays, spine_tables
from wgpu_path_tracing_tpu.models import procedural as JP
from wgpu_path_tracing_tpu.models.types import pack_device_scene as jpack
from wgpu_path_tracing_tpu.ops.intersect import _with_bucket_reorder
from wgpu_path_tracing_tpu.ops.intersect import closest_hit_brute as jbrute
from wgpu_path_tracing_tpu.ops.walk import closest_hit_walk as jwalk
from wgpu_path_tracing_tpu_torch import cornell_box, load_jax_scene
from wgpu_path_tracing_tpu_torch.accel.bvh8 import wide_depth
from wgpu_path_tracing_tpu_torch.models.types import pack_device_scene
from wgpu_path_tracing_tpu_torch.ops import intersect, walk
from wgpu_path_tracing_tpu_torch.ops.intersect import (
    closest_hit_brute,
    make_closest_hit,
    moller_trumbore,
)

# One thread a worker: PyTorch's OpenMP teams spin against each other under
# the suite's parallel workers.
torch.set_num_threads(1)

CSRC = walk.cuda_lib.CSRC_DIR


@pytest.fixture(scope="module")
def random_scene():
    return jpack(JP.random_triangles(1500, seed=5))


@pytest.fixture(scope="module")
def cornell_scene():
    return jpack(JP.cornell_box(tessellation=4))


def _aimed_rays(packed, n, seed):
    """Rays from 14 units out aimed at random triangle centroids."""
    rng = np.random.default_rng(seed)
    tri = packed["tri_isect"]
    cent = tri[:, 0:3] + (tri[:, 3:6] + tri[:, 6:9]) / 3.0
    tgt = cent[rng.integers(0, len(tri), n)]
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (tgt - d * 14).astype(np.float32), d.astype(np.float32)


def _random_rays(packed, n, seed):
    """Origins anywhere in the scene's bounds, directions uniform."""
    rng = np.random.default_rng(seed)
    lo, hi = packed["bvh_aabb"][0, 0:3], packed["bvh_aabb"][0, 3:6]
    o = rng.uniform(lo, hi, (n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _cornell_rays(n):
    """A ring from inside the box (every ray hits) and the same ring from
    outside, pointing away (every ray misses)."""
    ang = np.linspace(0, 2 * np.pi, n // 2, endpoint=False)
    d = np.stack([np.cos(ang), 0.3 * np.sin(3 * ang), np.sin(ang)], axis=1)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o_in = np.tile([[0.0, 1.0, 0.0]], (n // 2, 1))
    o_out = 5.0 * d + [0.0, 1.0, 0.0]
    return (np.concatenate([o_in, o_out]).astype(np.float32),
            np.concatenate([d, d]).astype(np.float32))


def _axis_rays(packed, n, seed):
    """Directions with exact zero components, from origins on the min
    planes of the wide tree's child boxes (the 0 * inf case the 1e-30
    stand-in avoids). On a max plane the stand-in sees the box only at
    t <= 0, so hits on that face's edges are the walk's razor class (in the
    JAX walk as well); they are left out here."""
    rng = np.random.default_rng(seed)
    boxes = packed["walk_boxes"][:, 0:6]
    boxes = boxes[np.isfinite(boxes).all(1)]
    pick = boxes[rng.integers(0, len(boxes), n)]
    o = rng.uniform(pick[:, 0:3], pick[:, 3:6])
    plane = rng.integers(0, 3, n)
    o[np.arange(n), plane] = pick[np.arange(n), plane]
    d = rng.normal(size=(n, 3))
    d[np.arange(n), plane] = 0.0
    rows = np.arange(0, n, 3)  # a third with two zero components
    d[rows, (plane[rows] + 1) % 3] = 0.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


RAYS = {
    "aimed": lambda s, c: (s, *_aimed_rays(s, 512, 1)),
    "random": lambda s, c: (c, *_random_rays(c, 512, 2)),
    "cornell_misses": lambda s, c: (c, *_cornell_rays(512)),
    "zero_direction": lambda s, c: (c, *_axis_rays(c, 512, 3)),
}


def _tables(packed):
    return walk.walk_tables(load_jax_scene(packed, "cpu"))


def _port_walk(packed, ro, rd, **kw):
    t, i = walk.closest_hit_walk(
        _tables(packed), torch.from_numpy(ro.T.copy()),
        torch.from_numpy(rd.T.copy()),
        num_tris=packed["tri_isect"].shape[0], **kw)
    return t.numpy(), i.numpy()


def _port_brute(packed, ro, rd):
    t, i = closest_hit_brute(torch.from_numpy(packed["tri_isect"]),
                             torch.from_numpy(ro), torch.from_numpy(rd))
    return t.numpy(), i.numpy()


def _jax_walk(packed, ro, rd, **kw):
    t, i = jwalk(jnp.asarray(packed["walk_order"]),
                 jnp.asarray(packed["walk_boxes"]),
                 jnp.asarray(packed["walk_tris"]), jnp.asarray(ro),
                 jnp.asarray(rd), num_tris=packed["tri_isect"].shape[0],
                 interpret=True, bn=256, **kw)
    return np.asarray(t), np.asarray(i)


def _t_of(packed, ro, rd, idx):
    """The port's Möller-Trumbore t of triangle idx[k] for ray k."""
    tri = torch.from_numpy(packed["tri_isect"][idx])
    o, d = torch.from_numpy(ro), torch.from_numpy(rd)
    t, _, _, _ = moller_trumbore(*o.unbind(1), *d.unbind(1), *tri.unbind(1))
    return t.numpy()


def _condition(packed, ro, rd, idx):
    """|e1| |d x e2| / |a| of triangle idx[k] for ray k, in float64."""
    tri = packed["tri_isect"][idx].astype(np.float64)
    h = np.cross(rd.astype(np.float64), tri[:, 6:9])
    a = np.einsum("ij,ij->i", tri[:, 3:6], h)
    return (np.linalg.norm(tri[:, 3:6], axis=1) * np.linalg.norm(h, axis=1)
            / np.abs(a))


@pytest.mark.parametrize("kind", list(RAYS))
def test_plain_walk_matches_brute_and_jax(random_scene, cornell_scene, kind):
    packed, ro, rd = RAYS[kind](random_scene, cornell_scene)
    t, i = _port_walk(packed, ro, rd)
    bt, bi = _port_brute(packed, ro, rd)
    jt, ji = _jax_walk(packed, ro, rd)
    hit = i >= 0
    assert hit.sum() >= 100 and (~hit).sum() >= (100 if kind ==
                                                  "cornell_misses" else 0)
    # The port's dense hit: the same hits, ties the only difference.
    np.testing.assert_array_equal(hit, bi >= 0)
    same = i == bi
    np.testing.assert_array_equal(t[same].view(np.uint32),
                                  bt[same].view(np.uint32))
    np.testing.assert_array_equal(t[~same], bt[~same])
    np.testing.assert_array_equal(t[~hit], np.inf)
    # The JAX walk. Its block-shared traversal has razor misses of its own
    # (a ray along a box face): where it and the port disagree on a hit,
    # the JAX package's dense hit sides with the port.
    jhit = ji >= 0
    apart = hit != jhit
    _, jbi = jbrute(jnp.asarray(packed["tri_isect"]), jnp.asarray(ro),
                    jnp.asarray(rd))
    np.testing.assert_array_equal(hit[apart], np.asarray(jbi)[apart] >= 0)
    assert apart.sum() <= 0.005 * len(hit)
    hit = hit & jhit
    diff = np.nonzero(hit & (i != ji))[0]
    np.testing.assert_array_max_ulp(
        _t_of(packed, ro[diff], rd[diff], ji[diff]), t[diff], maxulp=1)
    t, jt = t[hit], jt[hit]
    bound = 1e-4 * np.abs(jt) + 1e-5 + 8 * np.spacing(t) * _condition(
        packed, ro[hit], rd[hit], i[hit])
    assert (np.abs(t - jt) <= bound).all()


@pytest.mark.parametrize("scene", ["random", "cornell"])
def test_any_hit_gives_the_occlusion_answer(random_scene, cornell_scene,
                                            scene):
    if scene == "random":
        packed, (ro, rd) = random_scene, _aimed_rays(random_scene, 512, 4)
        t_max = np.random.default_rng(6).uniform(10.0, 18.0, 512).astype(
            np.float32)
    else:
        packed, (ro, rd) = cornell_scene, _random_rays(cornell_scene, 512, 5)
        t_max = np.random.default_rng(6).uniform(0.05, 2.0, 512).astype(
            np.float32)
    t, i = _port_walk(packed, ro, rd, t_max=torch.from_numpy(t_max),
                      any_hit=True)
    bt, _ = _port_brute(packed, ro, rd)
    occluded = bt < t_max
    assert 50 < occluded.sum() < 462
    np.testing.assert_array_equal(t < t_max, occluded)
    # Whatever hit stopped a lane is a real hit of that triangle.
    hit = i >= 0
    np.testing.assert_array_equal(_t_of(packed, ro[hit], rd[hit], i[hit]),
                                  t[hit])
    jt, _ = _jax_walk(packed, ro, rd, t_max=jnp.asarray(t_max), any_hit=True)
    np.testing.assert_array_equal(jt < t_max, occluded)


def test_inactive_lanes_miss(random_scene):
    ro, rd = _aimed_rays(random_scene, 512, 7)
    active = np.arange(512) % 3 != 0
    t, i = _port_walk(random_scene, ro, rd, active=torch.from_numpy(active))
    full_t, full_i = _port_walk(random_scene, ro, rd)
    np.testing.assert_array_equal(t[~active], np.inf)
    np.testing.assert_array_equal(i[~active], -1)
    np.testing.assert_array_equal(t[active], full_t[active])
    np.testing.assert_array_equal(i[active], full_i[active])
    jt, ji = _jax_walk(random_scene, ro, rd, active=jnp.asarray(active))
    np.testing.assert_array_equal(ji < 0, i < 0)


def test_empty_scene_misses_everything():
    packed = pack_device_scene(cornell_box())
    empty = dict(packed)
    from wgpu_path_tracing_tpu_torch.accel.bvh8 import build_wide_bvh

    wb = build_wide_bvh(np.zeros((1, 3), np.float32),
                        np.zeros((1, 3), np.float32),
                        np.zeros((1, 4), np.int32),
                        np.zeros((0, 9), np.float32))
    empty.update(walk_order=wb.order, walk_boxes=wb.boxes, walk_tris=wb.tris)
    ro, rd = _random_rays(packed, 64, 8)
    t, i = _port_walk(empty, ro, rd)
    assert np.isinf(t).all() and (i == -1).all()


def test_stack_bound_is_depth_times_seven_plus_eight(random_scene):
    """The plain walk's stack holds 7 entries a level plus 8; the kernel's
    one a level below the root, in shared memory."""
    tables = _tables(random_scene)
    depth = wide_depth(random_scene["walk_order"][:, :8])
    assert tables.stack == 7 * depth + 8
    assert tables.levels == max(depth - 1, 1)
    assert tables.levels * 4 * walk.THREADS <= walk.SHARED_MAX
    assert tables.order.dtype == torch.int32


def test_wrapper_runs_the_plain_version_on_cpu(random_scene):
    ro, rd = _aimed_rays(random_scene, 256, 9)
    before = walk.Counter.launches
    t, i = _port_walk(random_scene, ro, rd)
    assert walk.Counter.launches == before
    tables = _tables(random_scene)
    pt, pi = walk.closest_hit_walk_plain(
        tables, torch.from_numpy(ro.T.copy()), torch.from_numpy(rd.T.copy()),
        num_tris=random_scene["tri_isect"].shape[0])
    np.testing.assert_array_equal(t, pt.numpy())
    np.testing.assert_array_equal(i, pi.numpy())


@pytest.mark.parametrize("bad", ["ray_shape", "ray_dtype", "active_dtype",
                                 "t_max_shape", "order_dtype"])
def test_wrapper_rejects_bad_inputs(random_scene, bad):
    tables = _tables(random_scene)
    ro = torch.zeros((3, 8))
    rd = torch.ones((3, 8))
    kw = {}
    if bad == "ray_shape":
        ro = torch.zeros((8, 3))
    elif bad == "ray_dtype":
        rd = rd.double()
    elif bad == "active_dtype":
        kw["active"] = torch.ones(8, dtype=torch.int32)
    elif bad == "t_max_shape":
        kw["t_max"] = torch.ones(9)
    else:
        tables = tables._replace(order=tables.order.float())
    with pytest.raises((ValueError, TypeError)):
        walk.closest_hit_walk(tables, ro, rd, **kw)


def test_cuda_wrapper_refuses_cpu_tensors(random_scene):
    with pytest.raises(ValueError):
        walk.closest_hit_walk_cuda(_tables(random_scene), torch.zeros((3, 8)),
                                   torch.ones((3, 8)))


def test_kernel_constants_match_the_tables():
    with open(f"{CSRC}/walk.cu") as f:
        src = f.read()
    with open(f"{CSRC}/isect.cuh") as f:  # the leaf layout, shared with K5
        src += f.read()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    from wgpu_path_tracing_tpu_torch.accel import bvh8

    assert const("kThreads") == walk.THREADS
    assert const("kWidth") == bvh8.WIDTH
    assert (const("kWidth"), const("kWideWidth")) == bvh8.WIDTHS
    assert const("kOctants") == bvh8.OCTANTS
    assert const("kBoxFloats") == walk.BOX_FLOATS
    assert const("kTriFloats") == walk.TRI_FLOATS
    assert const("kLanes") == bvh8.LEAF_SLOTS
    assert const("kSub") == bvh8.SUB
    assert const("kGroupRows") == bvh8.group_rows(bvh8.SUB)
    # One launcher with the stack's size before the stream; the stack lives
    # in dynamic shared memory and nowhere else.
    assert len(walk.cuda_lib.SIGNATURES["wpt_walk"]) == 14
    assert "extern __shared__ unsigned stack[];" in src
    assert "kMaxStack" not in src and "Entry stack[" not in src


def test_make_closest_hit_picks_the_walk(random_scene):
    scene = load_jax_scene(random_scene, "cpu")
    assert make_closest_hit(scene).strategy == "brute"  # 1500 <= 4096
    ch = make_closest_hit(scene, brute_max_tris=1000)
    assert ch.strategy == "walk"
    assert make_closest_hit(scene, "walk").strategy == "walk"
    assert make_closest_hit(scene, "brute", 16).strategy == "brute"
    # The walk honours active, t_max and any_hit.
    ro, rd = _aimed_rays(random_scene, 128, 10)
    ro3, rd3 = torch.from_numpy(ro.T.copy()), torch.from_numpy(rd.T.copy())
    t, i = ch(ro3, rd3, active=torch.zeros(128, dtype=torch.bool))
    assert torch.isinf(t).all() and (i == -1).all()
    t, _ = ch(ro3, rd3, t_max=torch.full((128,), 12.0), any_hit=True)
    bt, _ = _port_brute(random_scene, ro, rd)
    np.testing.assert_array_equal(t.numpy() < 12.0, bt < 12.0)


@pytest.mark.parametrize("name", ["pairs", "phased", "cluster", "bvh",
                                  "stack", "walk_hbm"])
def test_unported_intersectors_raise(random_scene, name):
    """Every intersector of the JAX package is ported and reports its name:
    the three dispatch intersectors, the two binary-BVH walks, and the paged
    walk, a TPU residency mode that the port runs as K3; an unknown name
    raises."""
    scene = load_jax_scene(random_scene, "cpu")
    assert make_closest_hit(scene, name).strategy == name
    with pytest.raises(ValueError, match="unknown intersector"):
        make_closest_hit(scene, name + "_x")


def test_a_scene_without_walk_tables_raises(random_scene):
    """Without walk tables "auto" and a forced "walk" take the pair
    dispatch; asking the walk for its tables, or for an unknown intersector,
    raises."""
    scene = load_jax_scene({k: v for k, v in random_scene.items()
                            if not k.startswith("walk_")}, "cpu")
    assert make_closest_hit(scene, brute_max_tris=1000).strategy == "pairs"
    assert make_closest_hit(scene, "walk").strategy == "pairs"
    with pytest.raises(ValueError, match="no walk tables"):
        walk.walk_tables(scene)
    with pytest.raises(ValueError):
        make_closest_hit(scene, "nonsense")


def test_forced_walk_on_the_flagship_box_equals_brute():
    packed = pack_device_scene(cornell_box())
    scene = load_jax_scene(packed, "cpu")
    ro, rd = _random_rays(packed, 512, 11)
    ro3, rd3 = torch.from_numpy(ro.T.copy()), torch.from_numpy(rd.T.copy())
    wt, wi = make_closest_hit(scene, "walk")(ro3, rd3)
    bt, bi = make_closest_hit(scene, "brute")(ro3, rd3)
    assert torch.equal(wi, bi)
    assert torch.equal(wt.view(torch.int32), bt.view(torch.int32))


def test_plain_walk_counts_its_visits(random_scene):
    """``visits`` counts the work without changing the answer: every ray
    visits the root, every hit tested a sub-cluster, and an any-hit query
    does no more work than the closest-hit one."""
    ro, rd = _aimed_rays(random_scene, 256, 11)
    tables = _tables(random_scene)
    o, d = torch.from_numpy(ro.T.copy()), torch.from_numpy(rd.T.copy())
    nt = random_scene["tri_isect"].shape[0]
    closest, any_hit = {}, {}
    t, i = walk.closest_hit_walk_plain(tables, o, d, num_tris=nt,
                                       visits=closest)
    t0, i0 = walk.closest_hit_walk_plain(tables, o, d, num_tris=nt)
    assert torch.equal(t, t0) and torch.equal(i, i0)
    walk.closest_hit_walk_plain(tables, o, d, t_max=torch.full((256,), 1e9),
                                num_tris=nt, any_hit=True, visits=any_hit)
    assert closest["interior"] >= 256
    assert closest["sub_clusters"] >= int((i >= 0).sum()) > 0
    # Only non-empty slots count: every ray tests each of the root's
    # children, and no visit counts more than its slots.
    root = int((tables.order[0, :walk.WIDTH] != 0).sum())
    assert 256 * root <= closest["children"] <= walk.WIDTH * closest["interior"]
    assert closest["sub_clusters"] <= closest["sub_boxes"]
    assert closest["sub_boxes"] <= walk.SUB * closest["leaf"]
    assert int((i >= 0).sum()) <= closest["triangles"]
    assert closest["triangles"] <= walk.SUB_W * closest["sub_clusters"]
    for key in ("interior", "leaf", "children", "sub_boxes", "sub_clusters",
                "triangles"):
        assert any_hit[key] <= closest[key], key


@pytest.mark.parametrize("name", ["random", "flagship"])
def test_leaf_records_give_back_walk_tris(random_scene, name):
    """The kernel's records, unpacked, are walk_tris' triangles, indices and
    sub-boxes bit for bit, with zero padding; they start on 16 bytes."""
    packed = (random_scene if name == "random"
              else pack_device_scene(cornell_box()))
    tables = _tables(packed)
    group = packed["walk_tris"].reshape(-1, walk.GROUP_ROWS, walk.LEAF_SLOTS)
    ng = group.shape[0]
    rec = tables.leaves.numpy()
    assert rec.shape == (ng, walk.LEAF_FLOATS) == (ng, 1664)
    assert tables.leaves.data_ptr() % 16 == 0
    boxes = rec[:, :walk.SUB * walk.BOX_FLOATS].reshape(ng, walk.SUB, 8)
    tri = rec[:, walk.SUB * walk.BOX_FLOATS:].reshape(ng, walk.LEAF_SLOTS,
                                                     12)
    bits = lambda a: np.ascontiguousarray(a).view(np.uint32)  # noqa: E731
    np.testing.assert_array_equal(bits(tri[..., 0:10]),
                                  bits(group[:, 0:10, :].transpose(0, 2, 1)))
    np.testing.assert_array_equal(bits(boxes[..., 0:6]),
                                  bits(group[:, 16:16 + walk.SUB, 0:6]))
    assert (tri[..., 10:] == 0).all() and (boxes[..., 6:] == 0).all()
    # Each group's padding slots (index -1) follow its triangles, which the
    # kernel's early stop in a sub-cluster rests on.
    idx = tri[..., 9]
    pad = idx < 0
    assert (np.sort(pad, axis=1, kind="stable") == pad).all()


def _jax_perm(packed, ro, rd):
    """The JAX package's bucket permutation: ``_with_bucket_reorder`` around
    an inner call that returns each sorted lane's number, which the wrapper
    scatters back to the lane's ray."""
    n = ro.shape[0]

    def inner(ro3, rd3, active=None, t_max=None, any_hit=False):
        lanes = jnp.arange(n, dtype=jnp.int32)
        return lanes.astype(jnp.float32), lanes

    wrapped = _with_bucket_reorder(inner, jnp.asarray(packed["bvh_aabb"][0]))
    _, perm = wrapped(jnp.asarray(ro.T), jnp.asarray(rd.T))
    return np.asarray(perm)


def _edge_rays(packed, n, seed):
    """Origins on the root box's faces and on the quantisation's bucket
    edges (min + k * extent / 4), inside and up to one extent outside the
    box, and direction components of +0.0 and -0.0."""
    rng = np.random.default_rng(seed)
    lo, hi = packed["bvh_aabb"][0, 0:3], packed["bvh_aabb"][0, 3:6]
    ext = hi - lo
    o = lo + ext * rng.integers(-4, 9, (n, 3)) / 4.0
    loose = rng.random((n, 3)) < 0.3
    o = np.where(loose, rng.uniform(lo - ext, hi + ext, (n, 3)), o)
    d = rng.normal(size=(n, 3))
    d[rng.random((n, 3)) < 0.2] = 0.0
    d[rng.random((n, 3)) < 0.1] = -0.0
    return o.astype(np.float32), d.astype(np.float32)


@pytest.mark.parametrize("kind", ["random", "edges", "cornell"])
def test_bucket_permutation_equals_jax(random_scene, cornell_scene, kind):
    """The port's stable sort by bucket key gives exactly the JAX package's
    counting-sort permutation (no lane is inactive: the JAX wrapper keys
    every lane by its ray)."""
    if kind == "random":
        packed, (ro, rd) = random_scene, _random_rays(random_scene, 4096, 12)
    elif kind == "edges":
        packed, (ro, rd) = cornell_scene, _edge_rays(cornell_scene, 4096, 13)
    else:
        packed, (ro, rd) = cornell_scene, _cornell_rays(4096)
    root = load_jax_scene(packed, "cpu")["root_box"]
    order = intersect.ray_order(torch.from_numpy(ro.T.copy()),
                                torch.from_numpy(rd.T.copy()), root)
    position = torch.empty_like(order)
    position[order] = torch.arange(len(order))
    np.testing.assert_array_equal(position.numpy(), _jax_perm(packed, ro, rd))
    keys = intersect.bucket_keys(torch.from_numpy(ro.T.copy()),
                                 torch.from_numpy(rd.T.copy()), root)
    assert 0 <= int(keys.min()) and int(keys.max()) < intersect.REORDER_BUCKETS
    assert len(keys.unique()) > (8 if kind == "cornell" else 64)


SORTED_CASES = {
    # name: (share of lanes alive or None for no mask, t_max and any_hit,
    #        reorder)
    "reorder_off": (0.5, False, False),
    "no_mask": (None, False, True),
    "alive_50": (0.5, False, True),
    "alive_5": (0.05, False, True),
    "t_max_any_hit": (0.5, True, True),
    "all_inactive": (0.0, False, True),
}


@pytest.mark.parametrize("buckets", [True, False])
@pytest.mark.parametrize("case", list(SORTED_CASES))
def test_sorted_walk_equals_bare_walk(random_scene, monkeypatch, case,
                                      buckets):
    """make_closest_hit's walk with the ray reorder equals the bare plain
    walk bit for bit, at a ragged ray count past REORDER_MIN_LANES, with
    5% and 50% of the lanes alive, none, t_max and any-hit; the walk gets
    the rays in bucket order. A small tree (``buckets`` False) is walked
    unsorted."""
    if buckets:  # the random scene's tree is below the JAX gate
        monkeypatch.setattr(intersect, "REORDER_MIN_NODES", 1)
    n = intersect.REORDER_MIN_LANES + 1
    alive, bounded, reorder = SORTED_CASES[case]
    ro, rd = _random_rays(random_scene, n, 14)
    ro3, rd3 = torch.from_numpy(ro.T.copy()), torch.from_numpy(rd.T.copy())
    rng = np.random.default_rng(15)
    kw = {}
    if alive is not None:
        kw["active"] = torch.from_numpy(rng.random(n) < alive)
    if bounded:
        kw.update(t_max=torch.from_numpy(
            rng.uniform(0.05, 2.0, n).astype(np.float32)), any_hit=True)
    scene = load_jax_scene(random_scene, "cpu")
    ch = make_closest_hit(scene, "walk")
    seen = {}
    real = walk.closest_hit_walk

    def spy(tables, o, d, active=None, t_max=None, **rest):
        seen.update(ro=o, rd=d)
        return real(tables, o, d, active, t_max, **rest)

    monkeypatch.setattr(walk, "closest_hit_walk", spy)
    t, i = ch(ro3, rd3, reorder=reorder, **kw)
    pt, pi = walk.closest_hit_walk_plain(_tables(random_scene), ro3, rd3,
                                         num_tris=1500, **kw)
    assert torch.equal(t.view(torch.int32), pt.view(torch.int32))
    assert torch.equal(i, pi)
    assert (pi >= 0).any() or case == "all_inactive"
    sorted_call = reorder and buckets
    assert (seen["rd"] is rd3) != sorted_call
    if sorted_call:
        keys = intersect.bucket_keys(seen["ro"], seen["rd"],
                                     scene["root_box"])
        assert (keys[1:] >= keys[:-1]).all()


def test_small_calls_and_camera_rays_are_not_sorted(random_scene):
    """Below REORDER_MIN_LANES, without ``reorder`` or without a root box,
    the wrapper hands the caller's tensors to the walk untouched."""
    root = load_jax_scene(random_scene, "cpu")["root_box"]
    calls = []

    def inner(ro3, rd3, active, t_max, any_hit):
        calls.append(rd3)
        return (torch.zeros(ro3.shape[1]),
                torch.zeros(ro3.shape[1], dtype=torch.int32))

    wrapped = intersect.with_ray_order(inner, root)
    n = intersect.REORDER_MIN_LANES
    for lanes, reorder in ((n - 1, True), (n, False)):
        rd3 = torch.ones((3, lanes))
        wrapped(torch.zeros((3, lanes)), rd3, reorder=reorder)
        assert calls[-1] is rd3
    rd3 = torch.ones((3, n))
    intersect.with_ray_order(inner)(torch.zeros((3, n)), rd3, reorder=True)
    assert calls[-1] is rd3
    wrapped(torch.zeros((3, n)), rd3, reorder=True)
    assert calls[-1] is not rd3


@pytest.mark.parametrize("levels", [1, 5, 10])
def test_shared_stack_follows_wide_depth(levels):
    """The kernel's stack is one entry a wide level below the root: a spine
    tree of ``levels`` + 1 levels needs ``levels`` entries a ray, which the
    wrapper sizes the launch's shared memory by; the plain walk on such a
    tree agrees with the dense hit."""
    tables, tris = spine_tables(levels, "cpu")
    depth = wide_depth(tables.order[:, :8].numpy())
    assert depth == levels + 1
    assert tables.levels == levels == walk.stack_levels(depth)
    assert tables.stack == 7 * depth + 8
    o, d = spine_rays(256, len(tris), 16, "cpu")
    t, i = walk.closest_hit_walk_plain(tables, o, d)
    bt, bi = closest_hit_brute(torch.from_numpy(tris), o.T, d.T)
    assert torch.equal(i >= 0, bi >= 0) and int((i >= 0).sum()) > 64
    same = i == bi
    assert torch.equal(t[same].view(torch.int32), bt[same].view(torch.int32))
    assert torch.equal(t[~same], bt[~same])


@pytest.mark.parametrize("bad", ["levels", "no_levels", "leaf_shape",
                                 "leaf_alignment"])
def test_kernel_wrapper_checks_its_tables(random_scene, bad):
    """Before it launches, the wrapper raises on a stack that shared memory
    cannot hold, and on leaf records of the wrong shape or alignment."""
    tables = _tables(random_scene)
    if bad == "levels":
        tables = tables._replace(
            levels=walk.SHARED_MAX // (4 * walk.THREADS) + 1)
    elif bad == "no_levels":
        tables = tables._replace(levels=0)
    elif bad == "leaf_shape":
        tables = tables._replace(leaves=tables.leaves[:, :-4].contiguous())
    else:
        flat = torch.zeros(tables.leaves.numel() + 1)
        tables = tables._replace(
            leaves=flat[1:].view(tables.leaves.shape))
    with pytest.raises(ValueError, match="stack|leaf records"):
        walk.closest_hit_walk_cuda(tables, torch.zeros((3, 8)),
                                   torch.ones((3, 8)))
