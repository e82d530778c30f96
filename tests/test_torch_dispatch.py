"""What the dispatch intersectors K4 (pairs), K5 (phased) and K6 (cluster)
share: the host tables against the JAX package's, phase 1 and the pick
orders, ``make_closest_hit``'s selection, and the fallback that takes a
scene without walk tables through the pair dispatch. Each intersector's own
cases are in tests/test_torch_pairs.py, tests/test_torch_phased.py and
tests/test_torch_cluster.py (bodies in tests/torch_dispatch_cases.py).
"""

import numpy as np
import pytest
import torch

pytest.register_assert_rewrite("tests.torch_dispatch_cases")

from tests.torch_dispatch_cases import (  # noqa: E402
    KINDS,
    _aimed_rays,
    _port_brute,
    _soa,
    random_scene,  # noqa: F401  (a fixture)
)
from wgpu_path_tracing_tpu.models import procedural as JP  # noqa: E402
from wgpu_path_tracing_tpu.models.types import (  # noqa: E402
    pack_device_scene as jpack,
)
from wgpu_path_tracing_tpu.ops import cluster as JK6  # noqa: E402
from wgpu_path_tracing_tpu.ops import pairs as JK4  # noqa: E402
from wgpu_path_tracing_tpu.ops import phased as JK5  # noqa: E402
from wgpu_path_tracing_tpu_torch import (  # noqa: E402
    Renderer,
    RenderConfig,
    cornell_box,
    load_jax_scene,
)
from wgpu_path_tracing_tpu_torch.accel import bvh8  # noqa: E402
from wgpu_path_tracing_tpu_torch.models.types import (  # noqa: E402
    pack_device_scene,
)
from wgpu_path_tracing_tpu_torch.ops import (  # noqa: E402
    blocks,
    cluster,
    pairs,
    phased,
)
from wgpu_path_tracing_tpu_torch.ops.intersect import (  # noqa: E402
    make_closest_hit,
)


TABLE_SCENES = {
    "random": lambda: JP.random_triangles(1500, seed=5),
    "cornell4": lambda: JP.cornell_box(tessellation=4),
    "material_test_box": JP.material_test_box,
}


@pytest.mark.parametrize("name", list(TABLE_SCENES))
def test_host_tables_equal_jax(name):
    """``build_pair_tables`` and ``build_clusters`` on the JAX package's own
    BVH arrays, array-equal (NaN padding boxes included), and the tables a
    packed scene uploads."""
    ref = jpack(TABLE_SCENES[name]())
    t = ref["tri_isect"].shape[0]
    tris, aabb = pairs.build_pair_tables(ref["bvh_aabb"], ref["bvh_meta"],
                                         ref["tri_isect"][:t])
    np.testing.assert_array_equal(tris, ref["pairs_tris"])
    np.testing.assert_array_equal(aabb, ref["pairs_super_aabb"])
    assert tris.dtype == aabb.dtype == np.float32
    assert tris.shape[0] == aabb.shape[0] * pairs.TILE_ROWS
    for k in (64, 128):
        want = JK6.build_clusters(ref["tri_isect"], k=k)
        got = cluster.build_clusters(ref["tri_isect"], k=k)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        cluster.build_clusters(ref["tri_isect"], k=64)[0],
        ref["cluster_tris"])
    scene = load_jax_scene(ref, "cpu")
    for key in pairs.PAIRS_KEYS + cluster.CLUSTER_KEYS:
        assert scene[key].dtype == torch.float32 and scene[key].is_contiguous()
        np.testing.assert_array_equal(scene[key].numpy(), ref[key])
    assert (pairs.PAIRS_K, pairs.PAIRS_GROUP, pairs.BN) == (
        JK4.PAIRS_K, JK4.PAIRS_GROUP, JK4.BN)
    assert (cluster.CLUSTER_K, cluster.BN) == (JK6.CLUSTER_K, JK6.BN)
    assert phased.BN == JK5.BN


def test_port_packs_the_same_dispatch_tables():
    """The port's own ``pack_device_scene`` (its NumPy BVH) against the JAX
    package's, on a box above one cluster and one super tile."""
    port = pack_device_scene(cornell_box(tessellation=6))
    ref = jpack(JP.cornell_box(tessellation=6))
    for key in pairs.PAIRS_KEYS + cluster.CLUSTER_KEYS:
        assert port[key].dtype == ref[key].dtype == np.float32
        np.testing.assert_array_equal(port[key], ref[key], err_msg=key)
    assert port["pairs_super_aabb"].shape[0] > 1


def test_block_entry_and_the_pick_orders(random_scene):
    """Phase 1 against a direct evaluation, and the two pick orders."""
    scene = load_jax_scene(random_scene, "cpu")
    ro, rd = _aimed_rays(random_scene, 300, 12)
    lim0 = blocks.ray_limit(None, None, 300, torch.device("cpu"))
    o, d, lim = blocks.pad_blocks(_soa(ro), _soa(rd), lim0, 128)
    assert lim.shape == (3, 128) and torch.isneginf(lim[2, 44:]).all()
    aabb = scene["cluster_aabb"]
    entry = blocks.block_entry(aabb, o, d, lim)
    assert entry.shape == (3, aabb.shape[0])
    box = aabb.numpy().astype(np.float64)
    po = np.concatenate([ro, np.zeros((84, 3))]).astype(np.float64)
    pd = np.concatenate([rd, np.ones((84, 3))]).astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        t1 = (box[None, :, 0:3] - po[:, None]) / pd[:, None]
        t2 = (box[None, :, 3:6] - po[:, None]) / pd[:, None]
    tn = np.minimum(t1, t2).max(-1)
    tf = np.maximum(t1, t2).min(-1)
    live = np.arange(384) < 300
    hit = (tf >= tn) & (tf >= 0) & live[:, None]
    want = np.where(hit, tn, np.inf).reshape(3, 128, -1).min(1)
    np.testing.assert_array_equal(np.isinf(entry.numpy()), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(entry.numpy()[fin], want[fin], rtol=1e-5)
    order, cids = cluster.candidates(aabb, o, d, lim)
    assert (order[:, 1:] >= order[:, :-1]).all()
    np.testing.assert_array_equal(torch.gather(entry, 1, cids), order)
    pcids, counts = pairs.pair_list(scene["pairs_super_aabb"], o, d, lim)
    assert pcids.shape == (3, 5) and counts.dtype == torch.int64
    assert ((0 < counts) & (counts <= 5)).all()


def test_make_closest_hit_follows_the_jax_selection(random_scene):
    scene = load_jax_scene(random_scene, "cpu")
    no_walk = {k: v for k, v in scene.items() if not k.startswith("walk_")}
    picks = {
        # intersector: (with walk tables, without), above brute_max_tris
        "auto": ("walk", "pairs"),
        "walk": ("walk", "pairs"),
        "pairs": ("pairs", "pairs"),
        "phased": ("phased", "pairs"),
        "cluster": ("cluster", "cluster"),
        "brute": ("brute", "brute"),
    }
    for name, (with_walk, without) in picks.items():
        assert make_closest_hit(scene, name, 1000).strategy == with_walk, name
        assert make_closest_hit(no_walk, name, 1000).strategy == without, name
    # At or below brute_max_tris only "auto" takes the dense hit.
    assert make_closest_hit(scene, "auto").strategy == "brute"
    assert make_closest_hit(scene, "pairs").strategy == "pairs"
    # Each honours active and t_max.
    ro, rd = _aimed_rays(random_scene, 128, 10)
    bt, _ = _port_brute(random_scene, ro, rd)
    for name in KINDS:
        ch = make_closest_hit(scene, name)
        t, i = ch(_soa(ro), _soa(rd), active=torch.zeros(128, dtype=torch.bool))
        assert torch.isinf(t).all() and (i == -1).all()
        t, _ = ch(_soa(ro), _soa(rd), t_max=torch.full((128,), 12.0),
                  any_hit=True)
        np.testing.assert_array_equal(t.numpy() < 12.0, bt < 12.0)


def test_a_scene_without_walk_tables_renders_through_pairs(monkeypatch):
    """The fallback: a wide tree too deep for the walk's stack leaves the
    scene without walk tables, and "auto" then takes the pair dispatch and
    draws the image a forced "pairs" draws."""
    forced = Renderer(RenderConfig(width=16, height=16, intersector="pairs",
                                   brute_force_max_tris=16), device="cpu")
    forced.load_scene(cornell_box(tessellation=2))
    want = forced.render(spp=2)

    def too_deep(*args, **kwargs):
        raise bvh8.WideBVHDepthError("pathologically deep (simulated)")

    monkeypatch.setattr(bvh8, "build_wide_bvh", too_deep)
    for name in ("auto", "walk", "phased"):
        r = Renderer(RenderConfig(width=16, height=16, intersector=name,
                                  brute_force_max_tris=16), device="cpu")
        with pytest.warns(UserWarning, match="walk tables skipped"):
            r.load_scene(cornell_box(tessellation=2))
        assert r.stats()["intersector"] == "pairs", name
        np.testing.assert_array_equal(r.render(spp=2), want)
