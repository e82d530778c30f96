"""The test cases of one dispatch intersector, K4 (pairs), K5 (phased) or K6
(cluster): its plain version against the JAX package's kernel and the
port's dense hit, and the ``Renderer`` with that intersector forced.

tests/test_torch_pairs.py, tests/test_torch_phased.py and
tests/test_torch_cluster.py import everything here and supply the ``kind``
fixture, so each intersector's cases are a file of their own (and a worker
of their own when the suite runs in parallel).

The same numpy-made rays go through the port's ``closest_hit_*_plain`` (which
each wrapper runs for CPU tensors), the JAX package's ``closest_hit_pairs`` /
``closest_hit_phased`` / ``closest_hit_cluster`` in interpret mode (called
directly, as the JAX package's own tests call them: its ``make_closest_hit``
wraps them in lane permutations that change which rays share a block) and
the port's dense ``closest_hit_brute``. Tolerances, those of
tests/test_torch_walk.py:

* Against the port's dense hit: the same per-operation rounding, so hits and
  misses agree exactly, and t is bit-equal wherever the winner is the same
  triangle. A winner may differ only on an exact tie (two triangles with the
  same t, reached in another order).
* Against the JAX function: hits and misses agree, except on at most 0.5% of
  lanes, where the JAX package's own dense hit must side with the port; idx
  agrees except on a near tie, judged in the port's arithmetic: the port's t
  of JAX's triangle is within 1 ulp of the port's own t (XLA:CPU fuses the
  Möller-Trumbore multiply-adds into FMAs and PyTorch rounds every
  operation, so the two order such a pair differently). t is within rtol
  1e-4 / atol 1e-5, as the JAX package's tests hold its kernels to brute,
  plus 8 ulp of t per unit of the hit's condition number
  |e1| |d x e2| / |a|.

The JAX pair and round dispatches fill the last ray block's tail with zero
directions, whose entry distance into a box around the origin is -inf; the
pair dispatch then drops the block's farthest candidates and the round
dispatch never ends. So a ray count that is no multiple of the block goes
through the JAX functions only on the Cornell box, whose floor lies in the
plane y = 0 (the entry distance is NaN there and the tail lanes enter
nothing); on the random scene it is held to the dense hit alone, and every
call of a JAX function on that scene has 1,024 rays.

What the three share (the host tables, phase 1, the selection and the
fallback) is in tests/test_torch_dispatch.py.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.oracle import Oracle
from wgpu_path_tracing_tpu import Renderer as JRenderer
from wgpu_path_tracing_tpu import RenderConfig as JRenderConfig
from wgpu_path_tracing_tpu import cornell_box as jcornell_box
from wgpu_path_tracing_tpu.models import procedural as JP
from wgpu_path_tracing_tpu.models.types import pack_device_scene as jpack
from wgpu_path_tracing_tpu.ops import cluster as JK6
from wgpu_path_tracing_tpu.ops import pairs as JK4
from wgpu_path_tracing_tpu.ops import phased as JK5
from wgpu_path_tracing_tpu.ops.intersect import closest_hit_brute as jbrute
from wgpu_path_tracing_tpu_torch import (
    Renderer,
    RenderConfig,
    cornell_box,
    load_jax_scene,
)
from wgpu_path_tracing_tpu_torch.accel import bvh8
from wgpu_path_tracing_tpu_torch.ops import (
    blocks,
    cluster,
    cuda_lib,
    pairs,
    phased,
)
from wgpu_path_tracing_tpu_torch.ops.intersect import (
    closest_hit_brute,
    make_closest_hit,
    moller_trumbore,
)

# The suite runs in several worker processes. Left alone, each would run
# PyTorch's elementwise loops on an OpenMP team of all the machine's cores,
# and the teams spin against each other: these cases took 770 s in four
# workers that way and 80 s on one thread each.
torch.set_num_threads(1)

KINDS = ("pairs", "phased", "cluster")
MODULES = {"pairs": pairs, "phased": phased, "cluster": cluster}
# Rays a block in the CPU tests' phased calls (both packages): interpret
# mode unrolls the JAX kernel's phase 1 over every sub-box of the scene.
PHASED_BN = 256


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
    """Directions with one or two exact zero components, from origins
    anywhere in the bounds: K4 and K6 divide by them (+-inf slab
    distances), K5 takes its 1e-30 stand-in."""
    o, d = _random_rays(packed, n, seed)
    rng = np.random.default_rng(seed + 100)
    axis = rng.integers(0, 3, n)
    d[np.arange(n), axis] = 0.0
    rows = np.arange(0, n, 3)
    d[rows, (axis[rows] + 1) % 3] = 0.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d.astype(np.float32)


# Ray sets: (scene, origins, directions): 1,024 rays on the random scene,
# 600 (no multiple of any block) on the Cornell box, so that the JAX
# functions compile once for each scene.
CORNELL_RAYS = 600
RAYS = {
    "aimed": lambda s, c: (s, *_aimed_rays(s, 1024, 1)),
    "random": lambda s, c: (c, *_random_rays(c, CORNELL_RAYS, 2)),
    "cornell_ragged": lambda s, c: (c, *_cornell_rays(CORNELL_RAYS)),
    "zero_direction": lambda s, c: (c, *_axis_rays(c, CORNELL_RAYS, 3)),
}


def _soa(x):
    return torch.from_numpy(np.ascontiguousarray(x.T))


def _port(kind, packed, ro, rd, plain=False, **kw):
    """The port's wrapper (or its plain version by name) on CPU tensors."""
    scene = load_jax_scene(packed, "cpu")
    nt = packed["tri_isect"].shape[0]
    for key in ("active", "t_max"):
        if key in kw:
            kw[key] = torch.from_numpy(kw[key])
    if kind == "pairs":
        fn = pairs.closest_hit_pairs_plain if plain else pairs.closest_hit_pairs
        t, i = fn(pairs.pair_tables(scene), _soa(ro), _soa(rd), num_tris=nt,
                  **kw)
    elif kind == "phased":
        fn = (phased.closest_hit_phased_plain if plain
              else phased.closest_hit_phased)
        t, i = fn(phased.phased_tables(scene["walk_tris"]), _soa(ro),
                  _soa(rd), num_tris=nt, bn=PHASED_BN, **kw)
    else:
        fn = (cluster.closest_hit_cluster_plain if plain
              else cluster.closest_hit_cluster)
        t, i = fn(cluster.cluster_tables(scene), _soa(ro), _soa(rd),
                  num_tris=nt, **kw)
    return t.numpy(), i.numpy()


def _jax(kind, packed, ro, rd, **kw):
    """The JAX package's function in interpret mode. ``active`` and
    ``t_max`` are always given (all true, all inf by default: the same
    limits as without them), so one compilation serves a scene."""
    nt = packed["tri_isect"].shape[0]
    kw.setdefault("active", np.ones(len(ro), bool))
    kw.setdefault("t_max", np.full(len(ro), np.inf, np.float32))
    kw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
          for k, v in kw.items()}
    o, d = jnp.asarray(ro), jnp.asarray(rd)
    if kind == "pairs":
        t, i = JK4.closest_hit_pairs(
            jnp.asarray(packed["pairs_super_aabb"]),
            jnp.asarray(packed["pairs_tris"]), o, d, num_tris=nt,
            interpret=True, **kw)
    elif kind == "phased":
        t, i = JK5.closest_hit_phased(
            jnp.asarray(packed["walk_tris"]), o, d, num_tris=nt,
            interpret=True, bn=PHASED_BN, **kw)
    else:
        t, i = JK6.closest_hit_cluster(
            jnp.asarray(packed["cluster_aabb"]),
            jnp.asarray(packed["cluster_tris"]), o, d, num_tris=nt,
            interpret=True, **kw)
    return np.asarray(t), np.asarray(i)


def _port_brute(packed, ro, rd):
    t, i = closest_hit_brute(torch.from_numpy(packed["tri_isect"]),
                             torch.from_numpy(ro), torch.from_numpy(rd))
    return t.numpy(), i.numpy()


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


def _assert_equals_brute(packed, ro, rd, t, i, lanes=slice(None)):
    """The same hits as the port's dense hit, ties the only difference."""
    bt, bi = _port_brute(packed, ro, rd)
    t, i, bt, bi = t[lanes], i[lanes], bt[lanes], bi[lanes]
    np.testing.assert_array_equal(i >= 0, bi >= 0)
    same = i == bi
    np.testing.assert_array_equal(t[same].view(np.uint32),
                                  bt[same].view(np.uint32))
    np.testing.assert_array_equal(t[~same], bt[~same])
    np.testing.assert_array_equal(t[i < 0], np.inf)
    assert (~same).sum() <= 0.02 * len(i)


def _assert_matches_jax(packed, ro, rd, t, i, jt, ji):
    hit, jhit = i >= 0, ji >= 0
    apart = hit != jhit
    _, jbi = jbrute(jnp.asarray(packed["tri_isect"]), jnp.asarray(ro),
                    jnp.asarray(rd))
    np.testing.assert_array_equal(hit[apart], np.asarray(jbi)[apart] >= 0)
    assert apart.sum() <= 0.005 * len(hit)
    hit = hit & jhit
    diff = np.nonzero(hit & (i != ji))[0]
    np.testing.assert_array_max_ulp(
        _t_of(packed, ro[diff], rd[diff], ji[diff]), t[diff], maxulp=1)
    assert len(diff) <= 0.02 * len(hit)
    t, jt = t[hit], jt[hit]
    bound = 1e-4 * np.abs(jt) + 1e-5 + 8 * np.spacing(t) * _condition(
        packed, ro[hit], rd[hit], i[hit])
    assert (np.abs(t - jt) <= bound).all()


@pytest.mark.parametrize("rays", list(RAYS))
def test_plain_matches_brute_and_jax(random_scene, cornell_scene, kind, rays):
    packed, ro, rd = RAYS[rays](random_scene, cornell_scene)
    t, i = _port(kind, packed, ro, rd)
    assert (i >= 0).sum() >= 100
    if rays == "cornell_ragged":
        assert (i < 0).sum() >= 100
    _assert_equals_brute(packed, ro, rd, t, i)
    _assert_matches_jax(packed, ro, rd, t, i, *_jax(kind, packed, ro, rd))


@pytest.mark.parametrize("scene", ["random", "cornell"])
def test_shadow_limit_gives_the_occlusion_answer(random_scene, cornell_scene,
                                                 kind, scene):
    """``t_max`` culls boxes, not hits, and ``any_hit`` is ignored: a hit
    below the limit is found, and whatever is reported is a real hit, so
    ``t < t_max`` is the dense hit's occlusion answer in both packages."""
    if scene == "random":  # whole blocks: the JAX functions see this scene
        packed, (ro, rd) = random_scene, _aimed_rays(random_scene, 1024, 4)
        t_max = np.random.default_rng(6).uniform(10.0, 18.0, 1024).astype(
            np.float32)
    else:
        packed, (ro, rd) = cornell_scene, _random_rays(cornell_scene,
                                                       CORNELL_RAYS, 5)
        t_max = np.random.default_rng(6).uniform(
            0.05, 2.0, CORNELL_RAYS).astype(np.float32)
    t, i = _port(kind, packed, ro, rd, t_max=t_max, any_hit=True)
    bt, _ = _port_brute(packed, ro, rd)
    occluded = bt < t_max
    assert 0.1 * len(bt) < occluded.sum() < 0.9 * len(bt)
    np.testing.assert_array_equal(t < t_max, occluded)
    hit = i >= 0
    np.testing.assert_array_equal(_t_of(packed, ro[hit], rd[hit], i[hit]),
                                  t[hit])
    # The limit never hides the closest hit where that lies below it.
    np.testing.assert_array_equal(t[occluded], bt[occluded])
    jt, _ = _jax(kind, packed, ro, rd, t_max=t_max)  # any_hit: ignored
    np.testing.assert_array_equal(jt < t_max, occluded)


def test_inactive_lanes_miss(random_scene, kind):
    ro, rd = _aimed_rays(random_scene, 1024, 7)  # whole blocks, for JAX
    active = np.arange(1024) % 3 != 0
    t, i = _port(kind, random_scene, ro, rd, active=active)
    np.testing.assert_array_equal(t[~active], np.inf)
    np.testing.assert_array_equal(i[~active], -1)
    _assert_equals_brute(random_scene, ro, rd, t, i, lanes=active)
    jt, ji = _jax(kind, random_scene, ro, rd, active=active)
    np.testing.assert_array_equal(ji < 0, i < 0)
    # Every lane inactive: nothing is a candidate.
    t, i = _port(kind, random_scene, ro, rd, active=np.zeros(1024, bool))
    assert np.isinf(t).all() and (i == -1).all()


def test_ragged_blocks_on_the_random_scene(random_scene, kind):
    """2,500 rays: three blocks of 1024 (ten of 256 for K5), the last one
    ragged, over boxes that hold the origin. Held to the dense hit only (the
    module's docstring says why)."""
    ro, rd = _aimed_rays(random_scene, 2500, 8)
    t, i = _port(kind, random_scene, ro, rd)
    assert t.shape == (2500,) and (i >= 0).sum() > 2000
    _assert_equals_brute(random_scene, ro, rd, t, i)


def _empty_tables(kind):
    if kind == "pairs":
        tris, aabb = pairs.build_pair_tables(
            np.zeros((1, 6), np.float32), np.zeros((1, 4), np.int32),
            np.zeros((0, 9), np.float32))
        return tris, aabb
    if kind == "cluster":
        return cluster.build_clusters(np.zeros((0, 9), np.float32))
    wb = bvh8.build_wide_bvh(np.zeros((1, 3), np.float32),
                             np.zeros((1, 3), np.float32),
                             np.zeros((1, 4), np.int32),
                             np.zeros((0, 9), np.float32))
    return (wb.tris,)


def test_empty_scene_misses_everything(cornell_scene, kind):
    tables = _empty_tables(kind)
    if kind == "pairs":
        ref = JK4.build_pair_tables(np.zeros((1, 6), np.float32),
                                    np.zeros((1, 4), np.int32),
                                    np.zeros((0, 9), np.float32))
    elif kind == "cluster":
        ref = JK6.build_clusters(np.zeros((0, 9), np.float32))
    else:
        ref = tables
    for a, b in zip(tables, ref):
        np.testing.assert_array_equal(a, b)
    ro, rd = _random_rays(cornell_scene, 64, 9)
    o, d = _soa(ro), _soa(rd)
    tensors = [torch.from_numpy(x) for x in tables]
    if kind == "pairs":
        t, i = pairs.closest_hit_pairs(
            pairs.PairTables(tensors[1], tensors[0]), o, d, num_tris=0)
    elif kind == "cluster":
        t, i = cluster.closest_hit_cluster(
            cluster.ClusterTables(tensors[1], tensors[0]), o, d, num_tris=0)
    else:
        t, i = phased.closest_hit_phased(phased.phased_tables(tensors[0]), o,
                                         d, num_tris=0)
    assert torch.isinf(t).all() and (i == -1).all()
    # No rays at all.
    none = torch.zeros((3, 0))
    scene = load_jax_scene(cornell_scene, "cpu")
    t, i = make_closest_hit(scene, kind)(none, none)
    assert t.shape == (0,) and i.shape == (0,)


def test_wrapper_runs_the_plain_version_on_cpu(random_scene, kind):
    ro, rd = _aimed_rays(random_scene, 256, 9)
    counter = MODULES[kind].Counter
    before = counter.launches
    t, i = _port(kind, random_scene, ro, rd)
    assert counter.launches == before
    pt, pi = _port(kind, random_scene, ro, rd, plain=True)
    np.testing.assert_array_equal(t, pt)
    np.testing.assert_array_equal(i, pi)
    assert t.dtype == np.float32 and i.dtype == np.int32


def _call(kind, scene, ro, rd, cuda=False, **kw):
    if kind == "pairs":
        fn = pairs.closest_hit_pairs_cuda if cuda else pairs.closest_hit_pairs
        return fn(pairs.pair_tables(scene), ro, rd, **kw)
    if kind == "phased":
        fn = (phased.closest_hit_phased_cuda if cuda
              else phased.closest_hit_phased)
        return fn(phased.phased_tables(scene["walk_tris"]), ro, rd, **kw)
    fn = (cluster.closest_hit_cluster_cuda if cuda
          else cluster.closest_hit_cluster)
    return fn(cluster.cluster_tables(scene), ro, rd, **kw)


@pytest.mark.parametrize("bad", ["ray_shape", "ray_dtype", "active_dtype",
                                 "t_max_shape", "table_dtype"])
def test_wrapper_rejects_bad_inputs(random_scene, kind, bad):
    scene = load_jax_scene(random_scene, "cpu")
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
        key = {"pairs": "pairs_tris", "phased": "walk_tris",
               "cluster": "cluster_tris"}[kind]
        scene = dict(scene, **{key: scene[key].double()})
    with pytest.raises((ValueError, TypeError)):
        _call(kind, scene, ro, rd, **kw)


def test_cuda_wrapper_refuses_cpu_tensors(random_scene, kind):
    scene = load_jax_scene(random_scene, "cpu")
    with pytest.raises(ValueError):
        _call(kind, scene, torch.zeros((3, 8)), torch.ones((3, 8)), cuda=True)
    if kind == "phased":
        with pytest.raises(ValueError, match="multiple of 32"):
            phased.closest_hit_phased(phased.phased_tables(scene["walk_tris"]),
                                      torch.zeros((3, 8)),
                                      torch.ones((3, 8)), bn=100)


def test_kernel_constants_match_the_tables(kind):
    with open(f"{cuda_lib.CSRC_DIR}/{kind}.cu") as f:
        src = f.read()
    with open(f"{cuda_lib.CSRC_DIR}/isect.cuh") as f:
        src += f.read()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert f"wpt_{kind}" in cuda_lib.SIGNATURES
    assert '#include "isect.cuh"' in src
    if kind == "pairs":
        assert const("kBlock") == pairs.BN
        assert const("kK") == pairs.PAIRS_K
        assert const("kGroup") == pairs.PAIRS_GROUP
        assert const("kCols") == pairs.PAIRS_COLS
    elif kind == "cluster":
        assert const("kBlock") == cluster.BN
        assert const("kMaxK") == cluster.CLUSTER_K
        assert const("kRound") == cluster.ROUND
    else:
        assert const("kLanes") == bvh8.LEAF_SLOTS
        assert const("kSub") == bvh8.SUB
        assert const("kGroupRows") == phased.GROUP_ROWS
        assert const("kSubRow") == phased.SUB_ROW
        assert phased.BN % phased.WARP == 0


def test_plain_version_counts_its_work(random_scene, kind):
    """``visits`` counts the work without changing the answer, and a shadow
    limit never adds work."""
    ro, rd = _aimed_rays(random_scene, 512, 11)
    t0, i0 = _port(kind, random_scene, ro, rd, plain=True)
    full, limited = {}, {}
    t, i = _port(kind, random_scene, ro, rd, plain=True, visits=full)
    np.testing.assert_array_equal(t, t0)
    np.testing.assert_array_equal(i, i0)
    _port(kind, random_scene, ro, rd, plain=True, visits=limited,
          t_max=np.full(512, 12.0, np.float32))
    hits = int((i >= 0).sum())
    assert hits > 400
    assert full["triangle_tests"] >= hits
    for key, n in limited.items():
        assert n <= full[key], key
    if kind == "pairs":
        bn = pairs.BN
        assert full["blocks"] == 1 and full["supers"] == 5
        assert 1 <= full["tiles"] <= full["pairs"] <= 5
        assert full["slab_tests"] == full["pairs"] * pairs.PAIRS_GROUP * bn
        assert full["triangle_tests"] == full["clusters"] * pairs.PAIRS_K * bn
        assert full["clusters"] <= full["pairs"] * pairs.PAIRS_GROUP
    elif kind == "phased":
        groups = random_scene["walk_tris"].shape[0] // phased.GROUP_ROWS
        assert full["blocks"] == 2
        assert full["sub_boxes"] == 2 * groups * bvh8.SUB
        assert full["sub_clusters"] <= full["sub_boxes"]
        assert full["triangle_tests"] <= (full["sub_clusters"] * phased.SUB_W
                                          * PHASED_BN)
    else:
        k = 64  # pack_device_scene's cluster_k
        assert full["blocks"] == 1 and full["boxes"] == 24
        assert full["clusters"] <= 24
        assert full["triangle_tests"] == full["clusters"] * k * cluster.BN
        assert full["rounds"] == -(-full["clusters"] // cluster.ROUND)


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


RENDER_TESSELLATION = 4  # 578 triangles: ten clusters, two super tiles


@pytest.fixture(scope="module")
def walk_render():
    r = Renderer(RenderConfig(width=24, height=24, intersector="walk"),
                 device="cpu")
    r.load_scene(cornell_box(tessellation=RENDER_TESSELLATION))
    return r.render(spp=2)


def test_renderer_with_a_forced_intersector(walk_render, kind):
    """The slice as a whole: 24x24 x 2 spp through the forced intersector
    equals the walk's image (the same rounding, and no razor tie shows at
    this size), and is held to the JAX Renderer with the same
    ``intersector=`` by the bars tests/test_torch_renderer.py has for the
    walk: >= 99% of pixels within 5e-4 of the JAX image or, where not, of
    the scalar oracle's mean, at most 5 off both. The means are within 2e-3
    (1e-3 there, on 4,898 triangles): on this 578-triangle box the few
    pixels where a last-ulp difference flips a shadow test, each arbitrated
    by the oracle above, move the 2-spp mean by 1.3e-3."""
    r = Renderer(RenderConfig(width=24, height=24, intersector=kind),
                 device="cpu")
    r.load_scene(cornell_box(tessellation=RENDER_TESSELLATION))
    assert r.stats()["intersector"] == kind
    buf = r.render(spp=2)
    assert np.isfinite(buf).all()
    np.testing.assert_array_equal(buf.view(np.uint32),
                                  walk_render.view(np.uint32))
    j = JRenderer(JRenderConfig(width=24, height=24, frames_per_chunk=2,
                                intersector=kind))
    j.load_scene(jcornell_box(tessellation=RENDER_TESSELLATION))
    ref = j.render(spp=2)
    close = np.isclose(buf, ref, rtol=5e-4, atol=5e-4).all(-1)
    oracle = Oracle(cornell_box(tessellation=RENDER_TESSELLATION),
                    r.camera.as_pytree(), 24, 24)
    ys, xs = np.nonzero(~close)
    off_both = [(px, py) for px, py in zip(xs, ys)
                if not np.allclose(buf[py, px], _oracle_mean(oracle, px, py, 2),
                                   rtol=2e-3, atol=2e-3)]
    report = (f"{len(xs)} of {close.size} pixels outside 5e-4 of the JAX "
              f"render, {len(off_both)} of them off the oracle too: {off_both}")
    assert close.size - len(off_both) >= 0.99 * close.size, report
    assert len(off_both) <= 5, report
    assert abs(buf.mean() / ref.mean() - 1.0) < 2e-3
