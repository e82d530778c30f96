"""The routes the JAX package's large scenes take in the port (its bench
config 7: ``cornell_box(tessellation=150, 243, 345)``, 0.77M to 4M
triangles, rendered by ``chip_smoke.py``'s ``big`` phase on the card), and
the limits on those routes, reached here on small tables: "auto" takes the
wide-BVH walk (K3) above ``brute_force_max_tris`` whenever the scene has
walk tables, at any size, and the pair dispatch (K4) for a scene without
them; each limit of K3's wrapper raises with its message before a launch.
No test here builds more than a few thousand triangles.
"""

import warnings

import numpy as np
import pytest
import torch

from wgpu_path_tracing_tpu_torch import (
    Renderer,
    RenderConfig,
    cornell_box,
    load_jax_scene,
)
from wgpu_path_tracing_tpu_torch.accel import bvh8
from wgpu_path_tracing_tpu_torch.models.types import WALK_KEYS, pack_device_scene
from wgpu_path_tracing_tpu_torch.ops import walk
from wgpu_path_tracing_tpu_torch.ops.intersect import make_closest_hit

torch.set_num_threads(1)

TESSELLATION = 4
LOWERED = 64  # brute_force_max_tris below the box's triangle count


@pytest.fixture(scope="module")
def box():
    scene = cornell_box(tessellation=TESSELLATION)
    return scene, load_jax_scene(pack_device_scene(scene), "cpu")


def test_auto_takes_the_walk_above_the_threshold_at_any_size(box):
    scene_np, scene = box
    assert scene_np.num_triangles > LOWERED
    assert make_closest_hit(scene, "auto", LOWERED).strategy == "walk"
    assert make_closest_hit(scene, "auto",
                            scene_np.num_triangles).strategy == "brute"
    r = Renderer(RenderConfig(width=8, height=8,
                              brute_force_max_tris=LOWERED), device="cpu")
    r.load_scene(scene_np)
    assert r.stats()["intersector"] == "walk"
    assert np.isfinite(r.render(spp=1)).all()


def test_auto_takes_the_pair_dispatch_without_walk_tables(box):
    _, scene = box
    bare = {k: v for k, v in scene.items() if k not in WALK_KEYS}
    for intersector in ("auto", "walk", "phased", "pairs"):
        assert make_closest_hit(bare, intersector,
                                LOWERED).strategy == "pairs"
    assert make_closest_hit(scene, "pairs", LOWERED).strategy == "pairs"


def test_a_tree_too_deep_for_the_stack_bound_goes_to_the_pairs(
        box, monkeypatch):
    """``accel/bvh8.py::_check_stack_depth`` on a small table: with the
    bound lowered below this box's need, ``pack_device_scene`` warns and
    packs no walk tables, and "auto" renders through the pair dispatch to
    the walk's image (the two are bit-equal here)."""
    scene_np, _ = box
    walk_r = Renderer(RenderConfig(width=16, height=16,
                                   brute_force_max_tris=LOWERED),
                      device="cpu")
    walk_r.load_scene(scene_np)
    want = walk_r.render(spp=1)
    monkeypatch.setattr(bvh8, "MAX_STACK", 8)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        packed = pack_device_scene(scene_np)
    assert not any(k in packed for k in WALK_KEYS)
    assert any("walk tables skipped" in str(w.message)
               and "MAX_STACK=8" in str(w.message) for w in rec)
    r = Renderer(RenderConfig(width=16, height=16,
                              brute_force_max_tris=LOWERED), device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        r.load_scene(scene_np)
    assert r.stats()["intersector"] == "pairs"
    np.testing.assert_array_equal(r.render(spp=1), want)


@pytest.mark.parametrize("limit", ["nodes", "levels", "no_levels",
                                   "leaf_shape", "order_alignment",
                                   "boxes_alignment"])
def test_each_kernel_table_limit_raises_with_its_message(box, limit,
                                                          monkeypatch):
    """``ops/walk.py::_check_kernel_tables`` at width 8, each limit on this
    small box's tables: the wide nodes K3 can address (MAX_NODES, lowered
    here to one below the box's count), the stack levels shared memory
    holds, the leaf records' shape and the 16-byte alignment of the tables
    the kernel loads as vectors."""
    _, scene = box
    tables = walk.walk_tables(scene)
    assert tables.width == 8
    walk._check_kernel_tables(tables)  # the box itself passes
    nodes = tables.order.shape[0]
    most = walk.SHARED_MAX // walk.STACK_BYTES[8]
    if limit == "nodes":
        monkeypatch.setattr(walk, "MAX_NODES", {8: nodes - 1, 16: 1 << 31})
        message = f"K3 takes at most {nodes - 1} wide nodes at width 8"
    elif limit in ("levels", "no_levels"):
        levels = most + 1 if limit == "levels" else 0
        tables = tables._replace(levels=levels)
        message = (f"the wide BVH needs {levels} stack entries a ray; K3's "
                   f"shared memory holds 1 to {most} at width 8")
    elif limit == "leaf_shape":
        tables = tables._replace(leaves=tables.leaves[:, :-4].contiguous())
        message = "the leaf records must be a"
    else:
        name = {"order_alignment": "order", "boxes_alignment": "boxes"}[limit]
        x = getattr(tables, name)
        flat = torch.zeros(x.numel() + 1, dtype=x.dtype)
        tables = tables._replace(**{name: flat[1:].view(x.shape)})
        message = f"the walk_{name} must be contiguous from a 16-byte"
    with pytest.raises(ValueError, match=message.replace("(", r"\(")):
        walk._check_kernel_tables(tables)
    with pytest.raises(ValueError, match="K3|stack|leaf records|16-byte"):
        walk.closest_hit_walk_cuda(tables, torch.zeros((3, 8)),
                                   torch.ones((3, 8)))



def test_the_plain_pair_dispatch_takes_a_super_tile_whole():
    """``ops/pairs.py::_dispatch_plain`` takes a rank's super tile whole
    (member boxes and Möller-Trumbore at once, then each member's update in
    order). Held here to the member-by-member loop it replaced, written out
    as the kernel runs it (``csrc/pairs.cu``): the same hits, bit for bit,
    and the same work counts, on a random scene's rays with and without an
    active mask and ``t_max``."""
    import math

    from wgpu_path_tracing_tpu_torch.models.procedural import random_triangles
    from wgpu_path_tracing_tpu_torch.ops import blocks, pairs
    from wgpu_path_tracing_tpu_torch.ops.intersect import moller_trumbore

    def member_by_member(tris, cids, counts, o, d, lim):
        nb, bn = lim.shape
        best_t = torch.full((nb, bn), math.inf)
        best_i = torch.full((nb, bn), -1, dtype=torch.int32)
        rows = torch.arange(pairs.PAIRS_K)
        work = {"triangle_tests": 0, "clusters": 0}
        for b in range(nb):
            ray = [x[b:b + 1] for x in (*o, *d)]
            for rank in range(int(counts[b])):
                for s in range(pairs.PAIRS_GROUP):
                    r0 = int(cids[b, rank]) * pairs.TILE_ROWS + s * pairs.PAIRS_K
                    limit = torch.minimum(best_t[b:b + 1], lim[b:b + 1])
                    _, enter = blocks.slab_entry_div(tris[r0, 9:15], *ray,
                                                     limit)
                    if not bool(enter.any()):
                        continue
                    work["clusters"] += 1
                    work["triangle_tests"] += pairs.PAIRS_K * bn
                    tri = tris[r0 + rows]  # (K, 16)
                    t, _, _, valid = moller_trumbore(
                        *(x[:, None, :] for x in ray),
                        *(tri[None, :, c, None] for c in range(9)))
                    t = torch.where(valid, t, math.inf)[0]  # (K, bn)
                    min_t = t.min(dim=0).values
                    min_row = torch.where(t == min_t, rows[:, None],
                                          1 << 30).min(dim=0).values
                    better = min_t < best_t[b]
                    best_t[b] = torch.where(better, min_t, best_t[b])
                    best_i[b] = torch.where(
                        better, int(tri[0, 15]) + min_row.to(torch.int32),
                        best_i[b])
        return best_t, best_i, work

    scene = load_jax_scene(pack_device_scene(random_triangles(900, seed=3)),
                           "cpu")
    tables = pairs.pair_tables(scene)
    rng = np.random.default_rng(4)
    n = pairs.BN + 300
    o = torch.from_numpy(rng.uniform(-0.8, 0.8, (3, n)).astype(np.float32))
    d = torch.from_numpy(rng.normal(size=(3, n)).astype(np.float32))
    d = d / d.norm(dim=0)
    active = torch.from_numpy(rng.random(n) < 0.7)
    t_max = torch.from_numpy(rng.uniform(0.05, 2.0, n).astype(np.float32))
    for kw in ({}, {"active": active, "t_max": t_max}):
        lim0 = blocks.ray_limit(kw.get("active"), kw.get("t_max"), n, "cpu")
        ob, db, lim = blocks.pad_blocks(o, d, lim0, pairs.BN)
        cids, counts = pairs.sorted_pairs(
            blocks.block_entry(tables.super_aabb, ob, db, lim))
        visits = {}
        got_t, got_i = pairs._dispatch_plain(tables.tris, cids, counts, ob,
                                             db, lim, visits)
        want_t, want_i, work = member_by_member(tables.tris, cids, counts,
                                                ob, db, lim)
        assert torch.equal(got_t.view(torch.int32), want_t.view(torch.int32))
        assert torch.equal(got_i, want_i) and int((got_i >= 0).sum()) > 20
        assert visits["clusters"] == work["clusters"] > 0
        assert visits["triangle_tests"] == work["triangle_tests"]
