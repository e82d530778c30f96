"""The JAX package's ray order in front of the pair dispatch, and phase 1 of
K4 and K6.

K4 votes by block of 1,024 consecutive lanes and breaks ties in visit
order, so the lanes it is handed are part of its function. The JAX package's
``make_closest_hit`` wraps its pair dispatch in ``_with_tail_compaction``:
a sparse call is packed into the smallest tier of n/2, n/8, n/32 or n/128
lanes (at least 2,048) that holds its live lanes, and bounce rays are
bucket-sorted. ``ops/intersect.py::with_tail_compaction`` is the port's
copy, and every route of the port's ``make_closest_hit`` to K4 goes
through it.

* The lanes: an inner call that records what it is handed and returns each
  slot's number, wrapped by both packages (the JAX wrapper under
  ``jax.disable_jit``, so that its ``lax.cond`` ladder runs the one branch
  it takes on concrete arrays), must see the same rays, ``active`` and
  ``t_max`` and give the same scattered result: every tier the sizes reach,
  the skipped tiers, the whole call sorted and bare, ``use_reorder`` off,
  no ``active``, and calls below 16,384 lanes. The same through the port's
  ``make_closest_hit`` for every route to K4, with K4 recorded in place.
* The whole route: the port's plain K4 behind its wrapper against the JAX
  package's route in interpret mode, with the tolerance of
  ``tests/torch_dispatch_cases.py::_assert_matches_jax`` (XLA:CPU fuses
  multiply-adds; PyTorch rounds every operation).
* Phase 1's kernel wrapper refuses CPU tensors and checks shapes; K6's
  float4 rows hold ``cluster_tris`` value for value.

Every ray count handed to a JAX intersector is a multiple of 1,024.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.register_assert_rewrite("tests.torch_dispatch_cases")

from tests.torch_dispatch_cases import (  # noqa: E402
    _aimed_rays,
    _assert_equals_brute,
    _assert_matches_jax,
    _soa,
    random_scene,  # noqa: F401  (a fixture)
)
from wgpu_path_tracing_tpu.ops.intersect import (  # noqa: E402
    _with_tail_compaction,
)
from wgpu_path_tracing_tpu.ops.intersect import (  # noqa: E402
    make_closest_hit as jmake_closest_hit,
)
from wgpu_path_tracing_tpu_torch import load_jax_scene  # noqa: E402
from wgpu_path_tracing_tpu_torch.models.types import WALK_KEYS  # noqa: E402
from wgpu_path_tracing_tpu_torch.ops import (  # noqa: E402
    blocks,
    cluster,
    intersect,
    pairs,
)

# One thread a worker process (ROADMAP C.3).
torch.set_num_threads(1)

ROOT = np.array([-1.0, -1.0, -1.0, 1.0, 1.0, 1.0], np.float32)


def _rays(n, seed):
    """Origins in and around ROOT, directions of every octant."""
    rng = np.random.default_rng(seed)
    ro = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    return ro, rd


def _mask(n, live, seed):
    active = np.zeros(n, bool)
    active[np.random.default_rng(seed).choice(n, live, replace=False)] = True
    return active


def _jax_lanes(ro, rd, active, t_max, use_reorder, reorder):
    """What the JAX package's ``_with_tail_compaction`` hands an inner call
    that returns each slot's number, and what it returns."""
    seen = []

    def inner(ro3, rd3, active=None, t_max=None, any_hit=False):
        seen.append([None if x is None else np.asarray(x)
                     for x in (ro3, rd3, active, t_max)])
        lanes = jnp.arange(ro3.shape[1], dtype=jnp.int32)
        return lanes.astype(jnp.float32), lanes

    wrapped = _with_tail_compaction(inner, jnp.asarray(ROOT),
                                    use_reorder=use_reorder)
    with jax.disable_jit():
        t, i = wrapped(
            jnp.asarray(ro.T), jnp.asarray(rd.T),
            active=None if active is None else jnp.asarray(active),
            t_max=None if t_max is None else jnp.asarray(t_max),
            reorder=reorder)
    return seen, np.asarray(t), np.asarray(i)


def _recorder(seen):
    """An inner call of the port's signature that records what it is handed
    and returns each slot's number."""

    def inner(ro3, rd3, active=None, t_max=None, any_hit=False):
        seen.append([None if x is None else x.numpy()
                     for x in (ro3, rd3, active, t_max)])
        lanes = torch.arange(ro3.shape[1], dtype=torch.int32)
        return lanes.float(), lanes

    return inner


def _port_call(fn, ro, rd, active, t_max, reorder):
    t, i = fn(_soa(ro), _soa(rd),
              active=None if active is None else torch.from_numpy(active),
              t_max=None if t_max is None else torch.from_numpy(t_max),
              reorder=reorder)
    return t.numpy(), i.numpy()


def _assert_same_lanes(port_seen, jax_seen, port_out, jax_out):
    assert len(port_seen) == len(jax_seen) == 1
    for name, p, j in zip(("ro3", "rd3", "active", "t_max"), port_seen[0],
                          jax_seen[0]):
        assert (p is None) == (j is None), name
        if p is not None:
            np.testing.assert_array_equal(p, j, err_msg=name)
    for p, j in zip(port_out, jax_out):
        np.testing.assert_array_equal(p, j)


# (n, live lanes or None for no ``active``, use_reorder, reorder, t_max):
# the lanes the inner call gets.
LANE_CASES = {
    "half_tier_sorted": (16384, 8000, True, True, True),  # 8,192
    "half_tier_camera_flag": (16384, 8192, True, False, False),  # 8,192
    "eighth_tier": (16384, 2000, True, True, True),  # 2,048
    "eighth_tier_unsorted": (16384, 2000, False, True, True),  # 2,048
    "below_skipped_tiers": (16384, 100, True, True, False),  # 2,048
    "no_live_lane": (16384, 0, True, True, True),  # 2,048, fill only
    "full_sorted": (16384, 9000, True, True, True),  # 16,384
    "full_bare": (16384, 9000, True, False, True),  # 16,384
    "full_without_reorder": (16384, 9000, False, True, False),  # 16,384
    "n32k_half_tier": (32768, 16000, True, True, False),  # 16,384
    "n32k_eighth_tier": (32768, 3000, True, True, True),  # 4,096
    "n32k_skipped_tiers": (32768, 500, True, False, True),  # 4,096
    "n32k_full": (32768, 20000, True, True, True),  # 32,768
    "no_active": (16384, None, True, True, True),  # as it is
    "below_min_lanes": (8192, 100, True, True, True),  # as it is
}


@pytest.mark.parametrize("case", list(LANE_CASES))
def test_compaction_hands_the_jax_lanes(case):
    n, live, use_reorder, reorder, with_t_max = LANE_CASES[case]
    ro, rd = _rays(n, 1)
    active = None if live is None else _mask(n, live, 2)
    t_max = (np.random.default_rng(3).uniform(0.5, 5.0, n).astype(np.float32)
             if with_t_max else None)
    jax_seen, jt, ji = _jax_lanes(ro, rd, active, t_max, use_reorder,
                                  reorder)
    seen = []
    wrapped = intersect.with_tail_compaction(
        _recorder(seen), torch.from_numpy(ROOT), use_reorder)
    out = _port_call(wrapped, ro, rd, active, t_max, reorder)
    _assert_same_lanes(seen, jax_seen, out, (jt, ji))
    lanes = seen[0][0].shape[1]
    tier = (None if live is None or n < intersect.REORDER_MIN_LANES
            else intersect.compaction_tier(live, n))
    assert lanes == (n if tier is None else tier)
    if tier is not None:  # the compaction's dead lanes: (inf, -1)
        assert np.isinf(out[0][~active]).all()
        assert (out[1][~active] == -1).all()


@pytest.mark.parametrize("live, n, want", [
    (8192, 16384, 8192), (8193, 16384, None), (2048, 16384, 2048),
    (0, 16384, 2048), (4096, 32768, 4096), (1024, 32768, 4096),
    (2048, 262144, 2048), (2049, 262144, 8192), (131073, 262144, None),
])
def test_compaction_tier(live, n, want):
    """The smallest tier n // div (div in 2, 8, 32, 128) of at least 2,048
    lanes that holds the live lanes."""
    assert intersect.compaction_tier(live, n) == want


def _no_walk(scene):
    return {k: v for k, v in scene.items() if k not in WALK_KEYS}


@pytest.mark.parametrize("intersector, walk_tables", [
    ("pairs", False), ("auto", False), ("walk", False), ("phased", False),
    ("pairs", True),
])
def test_every_route_to_k4_hands_it_the_jax_lanes(random_scene, monkeypatch,
                                                  intersector, walk_tables):
    """``make_closest_hit``'s routes to K4 hand it the lanes the JAX
    package's pair route hands its kernel: a bounce call at 16,384 lanes
    with a fifth of them alive (the n/2 tier, sorted). With the walk tables
    of this small tree (9 wide nodes) the order is off, as the JAX
    package's ``big_tree`` has it; without them it is on."""
    scene = load_jax_scene(random_scene, "cpu")
    if not walk_tables:
        scene = _no_walk(scene)
    seen = []
    monkeypatch.setattr(pairs, "closest_hit_pairs",
                        lambda tables, ro3, rd3, active, t_max, num_tris,
                        any_hit: _recorder(seen)(ro3, rd3, active, t_max))
    ch = intersect.make_closest_hit(scene, intersector, 64)
    assert ch.strategy == "pairs"
    n = 16384
    ro, rd = _rays(n, 4)
    active = _mask(n, 3000, 5)
    t_max = np.full(n, np.inf, np.float32)
    out = _port_call(ch, ro, rd, active, t_max, True)
    root = random_scene["bvh_aabb"][0].copy()
    jax_seen = []

    def jinner(ro3, rd3, active=None, t_max=None, any_hit=False):
        jax_seen.append([None if x is None else np.asarray(x)
                         for x in (ro3, rd3, active, t_max)])
        lanes = jnp.arange(ro3.shape[1], dtype=jnp.int32)
        return lanes.astype(jnp.float32), lanes

    with jax.disable_jit():
        jt, ji = _with_tail_compaction(
            jinner, jnp.asarray(root), use_reorder=not walk_tables)(
                jnp.asarray(ro.T), jnp.asarray(rd.T),
                active=jnp.asarray(active), t_max=jnp.asarray(t_max),
                reorder=True)
    _assert_same_lanes(seen, jax_seen, out, (np.asarray(jt), np.asarray(ji)))
    assert seen[0][0].shape[1] == 8192


@pytest.mark.parametrize("walk_tables, min_nodes, want", [
    (False, 128, True), (True, 128, False), (True, 9, True),
])
def test_pairs_reorder_follows_big_tree(random_scene, monkeypatch,
                                        walk_tables, min_nodes, want):
    """``use_reorder`` of the pair route: always without walk tables, else
    on trees of at least REORDER_MIN_NODES wide nodes (this tree has 9)."""
    scene = load_jax_scene(random_scene, "cpu")
    if not walk_tables:
        scene = _no_walk(scene)
    monkeypatch.setattr(intersect, "REORDER_MIN_NODES", min_nodes)
    assert intersect.pairs_reorder(scene) is want


@pytest.mark.parametrize("live", [0.4, 0.08])
def test_pair_route_matches_the_jax_route(random_scene, live):
    """The port's plain K4 behind ``with_tail_compaction`` against the JAX
    package's pair route in interpret mode, both without walk tables (so
    both sort), on 16,384 aimed bounce rays: 40% alive takes the n/2 tier,
    8% the n/8 tier."""
    packed = random_scene
    n = 16384
    ro, rd = _aimed_rays(packed, n, 21)
    active = np.random.default_rng(22).random(n) < live
    scene = _no_walk(load_jax_scene(packed, "cpu"))
    ch = intersect.make_closest_hit(scene, "pairs")
    t, i = _port_call(ch, ro, rd, active, None, True)
    jscene = {k: jnp.asarray(v) for k, v in packed.items()
              if isinstance(v, np.ndarray) and not k.startswith("walk_")}
    jch = jmake_closest_hit(jscene, "pairs", 64, 4)
    jt, ji = jch(jnp.asarray(ro.T), jnp.asarray(rd.T),
                 active=jnp.asarray(active), reorder=True)
    jt, ji = np.asarray(jt), np.asarray(ji)
    assert (i >= 0).sum() >= 0.2 * live * n
    assert np.isinf(t[~active]).all() and (i[~active] == -1).all()
    np.testing.assert_array_equal(jt[~active], np.inf)
    lanes = np.nonzero(active)[0]
    _assert_equals_brute(packed, ro[lanes], rd[lanes], t[lanes], i[lanes])
    _assert_matches_jax(packed, ro[lanes], rd[lanes], t[lanes], i[lanes],
                        jt[lanes], ji[lanes])


@pytest.mark.parametrize("name", ["random", "cornell"])
def test_cluster_rows_hold_cluster_tris(random_scene, name):
    """K6's float4 rows: each triangle of ``cluster_tris`` value for value,
    then three zeros; ``cluster_tables`` makes them once a scene."""
    if name == "random":
        packed = random_scene
    else:
        from wgpu_path_tracing_tpu_torch import cornell_box
        from wgpu_path_tracing_tpu_torch.models.types import (
            pack_device_scene,
        )
        packed = pack_device_scene(cornell_box(tessellation=4))
    tables = cluster.cluster_tables(load_jax_scene(packed, "cpu"))
    rows = tables.rows.numpy()
    assert rows.shape == (packed["cluster_tris"].shape[0], cluster.ROW_FLOATS)
    assert tables.rows.data_ptr() % 16 == 0
    bits = lambda a: np.ascontiguousarray(a).view(np.uint32)  # noqa: E731
    np.testing.assert_array_equal(bits(rows[:, 0:9]),
                                  bits(packed["cluster_tris"]))
    assert (rows[:, 9:] == 0).all()


def test_block_entry_cuda_refuses_cpu_tensors(random_scene):
    scene = load_jax_scene(random_scene, "cpu")
    ro, rd = _aimed_rays(random_scene, 256, 3)
    lim0 = blocks.ray_limit(None, None, 256, torch.device("cpu"))
    rays = blocks.pad_blocks(_soa(ro), _soa(rd), lim0, 128)
    with pytest.raises(ValueError, match="CUDA"):
        blocks.block_entry_cuda(scene["pairs_super_aabb"], *rays)


@pytest.mark.parametrize("bad", ["rows", "aabb_cols", "lim_shape",
                                 "ray_dtype"])
def test_block_entry_cuda_checks_shapes(random_scene, bad):
    """Shape and type errors raise before any device check or launch."""
    aabb = torch.zeros((5, 6))
    o = [torch.zeros((2, 128)) for _ in range(3)]
    d = [torch.ones((2, 128)) for _ in range(3)]
    lim = torch.zeros((2, 128))
    if bad == "rows":
        o = o[:2]
    elif bad == "aabb_cols":
        aabb = torch.zeros((5, 4))
    elif bad == "lim_shape":
        lim = torch.zeros((2, 64))
    else:
        d[1] = d[1].double()
    with pytest.raises((ValueError, TypeError)):
        blocks.block_entry_cuda(aabb, o, d, lim)


def test_wrappers_take_block_entry_on_cpu(random_scene):
    """``entry_table`` is ``block_entry`` for CPU tensors, and the lists the
    wrappers make from it are the plain versions' lists; no phase-1 launch
    is counted."""
    scene = load_jax_scene(random_scene, "cpu")
    ro, rd = _aimed_rays(random_scene, 2048, 8)
    lim0 = blocks.ray_limit(None, None, 2048, torch.device("cpu"))
    rays = blocks.pad_blocks(_soa(ro), _soa(rd), lim0, pairs.BN)
    before = blocks.Counter.launches
    for aabb in (scene["pairs_super_aabb"], scene["cluster_aabb"]):
        want = blocks.block_entry(aabb, *rays)
        np.testing.assert_array_equal(blocks.entry_table(aabb, *rays), want)
    got = pairs.pair_list(scene["pairs_super_aabb"], *rays)
    want = pairs.sorted_pairs(blocks.block_entry(scene["pairs_super_aabb"],
                                                 *rays))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    got = cluster.candidates(scene["cluster_aabb"], *rays)
    want = cluster.pick_order(blocks.block_entry(scene["cluster_aabb"],
                                                 *rays))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert blocks.Counter.launches == before
