"""The CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA card and skip without one. tests/conftest.py
imports JAX; where JAX is not installed, run them with:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

On the card, K1 (csrc/dense_hit.cu), K2 (csrc/bounce.cu, untextured and
in both texture modes, with and without its bounce-0 LDS instantiation,
with and without its environment map's ENV instantiation),
K3 (csrc/walk.cu, at width 8 and 16, and on the "slice" pack's tables;
at 16 a team of lanes a ray, also at ragged counts, on a deep tree and an
empty one), K4 (csrc/pairs.cu), K5 (csrc/phased.cu, also on
ragged counts, sparse and dead lanes, past one gate window, at other
block sizes and with unordered slots), K6
(csrc/cluster.cu), the phase 1 of K4 and K6 (csrc/blocks.cu, up to the
sign of a zero), K7 and K8 (csrc/bvh2.cu: the binary-BVH walks over their
staged records, K7 also in its depth mode and with an overflowing stack;
their division against ``/``, a zero numerator's sign aside) and K9
(csrc/atrous.cu, each level of the denoiser, and steps past the image's
size) must equal the plain versions bit for bit: both
round every float32 operation the same way (the kernels are built with
-fmad=false and IEEE division and square root). So must the Renderer's
"stack" and "bvh" renders, its debug views, ``denoise`` and
``render_adaptive`` their plain paths, and a render on a (2, 2) mesh of
the card (``devices=``) the plain path of the same sharded render; that
render is held to the single-device one at rtol 1e-4 / atol 1e-5 (the
sharded fold sums a chunk first), its counters exactly.
"""

import dataclasses

import numpy as np
import pytest
import torch

from chip_smoke import (
    ADVERSARIAL,
    DISPATCH,
    adversarial_case,
    div_apart,
    div_operands,
    left_spine,
    plain_adaptive,
    plain_debug,
    plain_denoise,
    env_map,
    with_env,
    lane_mix_box,
    lane_mix_rays,
    plain_closest_hit,
    plain_render,
    plain_sharded,
    scene_of,
    spine_rays,
    spine_tables,
    textured_material_box,
    tri_isect_of,
)
from wgpu_path_tracing_tpu_torch import (
    Renderer,
    RenderConfig,
    cornell_box,
    gallery_atrium,
    load_jax_scene,
    load_model,
    material_test_box,
    random_triangles,
    scene_to_glb,
    textured_cornell,
)
from wgpu_path_tracing_tpu_torch.accel import bvh8
from wgpu_path_tracing_tpu_torch.models.types import pack_device_scene
from wgpu_path_tracing_tpu_torch.ops import blocks as BLOCKS
from wgpu_path_tracing_tpu_torch.ops import bounce as K2
from wgpu_path_tracing_tpu_torch.ops import camera_rays as CAM
from wgpu_path_tracing_tpu_torch.ops import dense_hit as K1
from wgpu_path_tracing_tpu_torch.ops import intersect as INTERSECT
from wgpu_path_tracing_tpu_torch.ops import trace as TRACE
from wgpu_path_tracing_tpu_torch.ops import cluster as K6
from wgpu_path_tracing_tpu_torch.ops import denoise as K9
from wgpu_path_tracing_tpu_torch.ops import pairs as K4
from wgpu_path_tracing_tpu_torch.ops import phased as K5
from wgpu_path_tracing_tpu_torch.ops import walk as K3
from wgpu_path_tracing_tpu_torch.render.camera import Camera
from wgpu_path_tracing_tpu_torch.render.pipeline import camera_device

pytestmark = pytest.mark.cuda
W = H = 64


def spot_cornell(make_box=cornell_box):
    """The Cornell box plus a down-facing spot light (light type 3), as the
    JAX package's Pallas bounce test builds it. ``make_box`` is either
    package's ``cornell_box``."""
    sc = make_box()
    n = sc.num_lights
    aux = np.zeros((n + 1, 5), np.float32)
    aux[-1] = [0.0, -1.0, 0.0, 9.75, -8.56]
    return dataclasses.replace(
        sc,
        light_position=np.concatenate(
            [sc.light_position, [[0.0, 1.9, 0.0]]]).astype(np.float32),
        light_type=np.concatenate([sc.light_type, [3]]).astype(np.int32),
        light_color=np.concatenate(
            [sc.light_color, [[1.0, 0.8, 0.6]]]).astype(np.float32),
        light_intensity=np.concatenate(
            [sc.light_intensity, [30000.0]]).astype(np.float32),
        light_tri=np.concatenate([sc.light_tri, [0]]).astype(np.int32),
        light_aux=aux,
    )


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _bits(x):
    return x.contiguous().view(torch.uint8)


def _rays(scene_fn, dev, frame=0):
    sc = scene_fn()
    scene = load_jax_scene(pack_device_scene(sc), dev)
    cam = camera_device(Camera(width=W, height=H).as_pytree(), W, H)
    x, y = CAM.pixel_grid(W, H, device=dev)
    ro, rd, state = CAM.generate_rays(cam, x, y, frame, use_dof=True)
    return sc, scene, torch.cat([ro, rd]).contiguous(), state


@pytest.mark.parametrize("scene_fn", [cornell_box, material_test_box])
def test_dense_hit_kernel_equals_plain(dev, scene_fn):
    _, scene, rays, _ = _rays(scene_fn, dev)
    before = K1.Counter.launches
    t, idx = K1.closest_hit_dense(scene["tri_isect"], rays)
    torch.cuda.synchronize()
    assert K1.Counter.launches == before + 1
    pt, pi = K1.closest_hit_dense_plain(scene["tri_isect"], rays)
    assert torch.equal(_bits(t), _bits(pt)) and torch.equal(idx, pi)


@pytest.mark.parametrize("do_mis", [True, False])
@pytest.mark.parametrize("scene_fn",
                         [cornell_box, material_test_box, spot_cornell])
def test_bounce_kernel_equals_plain(dev, scene_fn, do_mis):
    sc, scene, rays, state = _rays(scene_fn, dev, frame=3)
    n = rays.shape[1]
    thr = torch.ones((3, n), device=dev)
    res = torch.zeros((3, n), device=dev)
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    for b in range(4):
        t, idx = K1.closest_hit_dense_plain(scene["tri_isect"], rays)
        args = (b, rays, state, thr, res, alive, t, idx, scene["tri_full"],
                scene["light_full"])
        kw = dict(do_mis=do_mis, num_lights=sc.num_lights)
        kout = K2.bounce_stage_cuda(*args, **kw)
        pout = K2.bounce_stage_plain(*args, **kw)
        torch.cuda.synchronize()
        for k, p in zip(kout, pout):
            assert torch.equal(_bits(k), _bits(p)), f"bounce {b}"
        rays, state, thr, res, alive = pout[:5]


def coprime_textured():
    """The 256^2 congruent textured box with a 255^2 pbr rect: no fat
    canvas (its LCM grid is past the budget), so K2 samples per slot."""
    sc = textured_cornell(atlas_size=256, congruent=True)
    sc.mat_pbr_rect[0] = [0, 0, 255, 255]
    return sc


@pytest.mark.parametrize("scene_fn, mode", [
    (textured_cornell, "fat"),
    (lambda: textured_cornell(atlas_size=512, congruent=True), "fat"),
    (coprime_textured, "per_slot"),
])
def test_bounce_textured_kernel_equals_plain(dev, scene_fn, mode):
    """Textured K2 on all ten outputs, every lane (dead lanes included:
    they shade row 0 with inf/NaN barycentrics), bounces 0..3."""
    sc, scene, rays, state = _rays(scene_fn, dev, frame=3)
    atlas, slots = TRACE.scene_atlas(scene)
    assert K2.texture_mode(atlas) == mode
    n = rays.shape[1]
    thr = torch.ones((3, n), device=dev)
    res = torch.zeros((3, n), device=dev)
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    for b in range(4):
        t, idx = K1.closest_hit_dense_plain(scene["tri_isect"], rays)
        args = (b, rays, state, thr, res, alive, t, idx, scene["tri_full"],
                scene["light_full"])
        kw = dict(do_mis=True, num_lights=sc.num_lights, atlas=atlas,
                  slots_used=slots)
        before = K2.Counter.by_mode[mode]
        kout = K2.bounce_stage_cuda(*args, **kw)
        torch.cuda.synchronize()
        assert K2.Counter.by_mode[mode] == before + 1
        pout = K2.bounce_stage_plain(*args, **kw)
        for k, p in zip(kout, pout):
            assert torch.equal(_bits(k), _bits(p)), f"bounce {b}"
        rays, state, thr, res, alive = pout[:5]


def test_renderer_textured_path_equals_plain_path(dev):
    r = Renderer(RenderConfig(width=W, height=H), device="cuda")
    r.load_scene(textured_cornell())
    assert r.stats()["texture"] == "fat"
    before = K2.Counter.by_mode["fat"]
    kernel = r.render(spp=2)
    assert K2.Counter.by_mode["fat"] == before + 2 * r.config.max_bounces
    plain = plain_render(r, spp=2)
    assert K2.Counter.by_mode["fat"] == before + 2 * r.config.max_bounces
    assert np.isfinite(kernel).all()
    np.testing.assert_array_equal(kernel.view(np.uint32),
                                  plain.view(np.uint32))


def test_renderer_kernel_path_equals_plain_path(dev):
    r = Renderer(RenderConfig(width=W, height=H), device="cuda")
    r.load_scene(cornell_box())
    kernel = r.render(spp=2)
    launches = (K1.Counter.launches, K2.Counter.launches)
    plain = plain_render(r, spp=2)
    assert (K1.Counter.launches, K2.Counter.launches) == launches
    assert np.isfinite(kernel).all()
    np.testing.assert_array_equal(kernel.view(np.uint32),
                                  plain.view(np.uint32))


@pytest.mark.parametrize("mode", ["closest", "active", "any_hit"])
def test_walk_kernel_equals_plain(dev, mode):
    """K3 on the 4,898-triangle box: camera rays, and their bounce-1 and
    shadow rays from one plain bounce."""
    sc = cornell_box(tessellation=12)
    scene = load_jax_scene(pack_device_scene(sc), dev)
    tables = K3.walk_tables(scene)
    cam = camera_device(Camera(width=W, height=H).as_pytree(), W, H)
    x, y = CAM.pixel_grid(W, H, device=dev)
    ro, rd, state = CAM.generate_rays(cam, x, y, 1, use_dof=True)
    rays = torch.cat([ro, rd]).contiguous()
    n = rays.shape[1]
    t, idx = K3.closest_hit_walk_plain(tables, ro, rd)
    outs = K2.bounce_stage_plain(
        0, rays, state, torch.ones((3, n), device=dev),
        torch.zeros((3, n), device=dev),
        torch.ones((n,), dtype=torch.bool, device=dev), t, idx,
        scene["tri_full"], scene["light_full"], do_mis=True,
        num_lights=sc.num_lights)
    nt = scene["tri_isect"].shape[0]
    for r in (rays, outs[0], outs[5]):
        o, d = r[0:3].contiguous(), r[3:6].contiguous()
        kw = dict(num_tris=nt)
        if mode == "active":
            kw["active"] = outs[4] if r is outs[0] else outs[7]
        elif mode == "any_hit":
            kw.update(active=outs[7], t_max=outs[6], any_hit=True)
        before = K3.Counter.launches
        kt, ki = K3.closest_hit_walk(tables, o, d, **kw)
        torch.cuda.synchronize()
        assert K3.Counter.launches == before + 1
        pt, pi = K3.closest_hit_walk_plain(tables, o, d, **kw)
        assert torch.equal(_bits(kt), _bits(pt)) and torch.equal(ki, pi)
        assert (ki >= 0).any()


def _walk_case(tables, o, d, kw):
    """K3 against its plain version on one ray set, bit for bit; one
    launch, none for no rays."""
    before = K3.Counter.launches
    kt, ki = K3.closest_hit_walk(tables, o, d, **kw)
    torch.cuda.synchronize()
    assert K3.Counter.launches == before + (o.shape[1] > 0)
    pt, pi = K3.closest_hit_walk_plain(tables, o, d, **kw)
    assert torch.equal(_bits(kt), _bits(pt)) and torch.equal(ki, pi)
    return ki


def _masks(n, mode, dev, seed):
    """No mask, a mask with t_max, or that with any_hit."""
    rng = np.random.default_rng(seed)
    if mode == "closest":
        return {}
    kw = dict(active=torch.from_numpy(rng.random(n) < 0.7).to(dev),
              t_max=torch.from_numpy(
                  rng.uniform(0.05, 2.0, n).astype(np.float32)).to(dev))
    return kw if mode == "masked" else dict(kw, any_hit=True)


@pytest.mark.parametrize("mode", ["closest", "masked", "any_hit"])
@pytest.mark.parametrize("n", [1000, 16385])
def test_walk_kernel_on_random_triangles(dev, n, mode):
    """K3 on random_triangles(1500) from random origins in every direction,
    at a ray count that fills no block and one past REORDER_MIN_LANES."""
    packed = pack_device_scene(random_triangles(1500, seed=5))
    tables = K3.walk_tables(load_jax_scene(packed, dev))
    rng = np.random.default_rng(n)
    lo, hi = packed["bvh_aabb"][0, 0:3], packed["bvh_aabb"][0, 3:6]
    o = torch.from_numpy(rng.uniform(lo, hi, (n, 3)).T.astype(np.float32))
    d = torch.from_numpy(rng.normal(size=(3, n)).astype(np.float32))
    ki = _walk_case(tables, o.contiguous().to(dev), d.to(dev),
                    dict(_masks(n, mode, dev, 1), num_tris=1500))
    assert (ki >= 0).any()


@pytest.mark.parametrize("mode", ["closest", "masked", "any_hit"])
def test_walk_kernel_on_a_deep_tree(dev, mode):
    """A spine tree of 11 wide levels: 10 stack entries a ray in shared
    memory, more than the large box's 4."""
    tables, tris = spine_tables(10, dev)
    assert tables.levels == 10
    o, d = spine_rays(4096, len(tris), 2, dev)
    ki = _walk_case(tables, o, d, _masks(4096, mode, dev, 3))
    assert (ki >= 0).any()


@pytest.mark.parametrize("mode", ["closest", "masked", "any_hit"])
@pytest.mark.parametrize("pack, width", [("ffd", 16), ("slice", 8),
                                         ("slice", 16)])
def test_wide_walk_kernel_equals_plain(dev, pack, width, mode):
    """K3 at width 16 (``wpt_walk16``) and on the "slice" pack's tables, on
    random_triangles(8000) (two wide levels) from random origins in every
    direction at a ray count that fills no block."""
    sc = random_triangles(8000, seed=3)
    packed = pack_device_scene(sc)
    wb = bvh8.build_wide_bvh(sc.bvh_aabb_min, sc.bvh_aabb_max, sc.bvh_meta,
                             packed["tri_isect"][:sc.num_triangles],
                             pack=pack, width=width, prefer_native=False)
    packed.update(walk_order=wb.order, walk_boxes=wb.boxes, walk_tris=wb.tris)
    tables = K3.walk_tables(load_jax_scene(packed, dev))
    assert tables.width == width
    n = 16385
    rng = np.random.default_rng(width)
    lo, hi = packed["bvh_aabb"][0, 0:3], packed["bvh_aabb"][0, 3:6]
    o = torch.from_numpy(rng.uniform(lo, hi, (n, 3)).T.astype(np.float32))
    d = torch.from_numpy(rng.normal(size=(3, n)).astype(np.float32))
    before = K3.Counter.wide
    ki = _walk_case(tables, o.contiguous().to(dev), d.to(dev),
                    dict(_masks(n, mode, dev, 5), num_tris=8000))
    assert K3.Counter.wide == before + (width == 16)
    assert (ki >= 0).any()


def _w16_tables(sc, dev):
    """``sc`` collapsed at width 16, as K3-w16 walks it."""
    packed = pack_device_scene(sc)
    wb = bvh8.build_wide_bvh(sc.bvh_aabb_min, sc.bvh_aabb_max, sc.bvh_meta,
                             packed["tri_isect"][:sc.num_triangles],
                             pack="ffd", width=16, prefer_native=False)
    packed.update(walk_order=wb.order, walk_boxes=wb.boxes, walk_tris=wb.tris)
    tables = K3.walk_tables(load_jax_scene(packed, dev))
    assert tables.width == 16
    return tables, packed


@pytest.mark.parametrize("mode", ["closest", "masked", "any_hit"])
@pytest.mark.parametrize("n", [1, 15, 17, 33, 3000])
def test_team_walk_at_ragged_ray_counts(dev, n, mode):
    """K3-w16 walks a ray with a team of lanes, a block holding
    ``THREADS // TEAM`` rays: counts that fill no block, one ray, a block
    and a ray, and a few thousand, on random_triangles(3000) from random
    origins in every direction."""
    tables, packed = _w16_tables(random_triangles(3000, seed=n), dev)
    rng = np.random.default_rng(n + 7)
    lo, hi = packed["bvh_aabb"][0, 0:3], packed["bvh_aabb"][0, 3:6]
    o = torch.from_numpy(rng.uniform(lo, hi, (n, 3)).T.astype(np.float32))
    d = torch.from_numpy(rng.normal(size=(3, n)).astype(np.float32))
    before = K3.Counter.wide
    _walk_case(tables, o.contiguous().to(dev), d.to(dev),
               dict(_masks(n, mode, dev, n), num_tris=3000))
    assert K3.Counter.wide == before + 1


@pytest.mark.parametrize("mode", ["closest", "masked", "any_hit"])
def test_team_walk_on_a_deep_tree(dev, mode):
    """A spine collapsed at width 16 into 15 wide levels: 14 stack entries
    a team in shared memory."""
    tables, tris = spine_tables(30, dev, width=16)
    assert tables.width == 16 and tables.levels == 14
    o, d = spine_rays(4096, len(tris), 4, dev)
    ki = _walk_case(tables, o, d, _masks(4096, mode, dev, 6))
    assert (ki >= 0).any()


def test_team_walk_on_an_empty_scene(dev):
    """A width-16 tree over no triangle: every lane misses."""
    wb = bvh8.build_wide_bvh(np.zeros((1, 3), np.float32),
                             np.zeros((1, 3), np.float32),
                             np.zeros((1, 4), np.int32),
                             np.zeros((0, 9), np.float32), width=16)
    packed = dict(pack_device_scene(cornell_box()), walk_order=wb.order,
                  walk_boxes=wb.boxes, walk_tris=wb.tris)
    tables = K3.walk_tables(load_jax_scene(packed, dev))
    assert tables.width == 16
    rng = np.random.default_rng(9)
    o = torch.from_numpy(rng.uniform(-1, 1, (3, 100)).astype(np.float32))
    d = torch.from_numpy(rng.normal(size=(3, 100)).astype(np.float32))
    ki = _walk_case(tables, o.to(dev), d.to(dev), {})
    assert bool((ki == -1).all())


def test_renderer_on_a_mesh_of_the_card(dev):
    """``devices=["cuda:0"] * 4``: a (2, 2) mesh of shards that run on the
    one card in turn. The image equals the plain path of the same sharded
    render bit for bit, and the single-device render within rtol 1e-4 /
    atol 1e-5; the counters equal; K1 runs for each shard's frames."""
    cfg = dict(width=W, height=H, frames_per_chunk=4)
    one = Renderer(RenderConfig(**cfg), device="cuda")
    four = Renderer(RenderConfig(**cfg), device="cuda",
                    devices=["cuda:0"] * 4)
    assert four.mesh.shape == {"sample": 2, "row": 2}
    for r in (one, four):
        r.load_scene(cornell_box())
    single = one.render(spp=4)
    before = K1.Counter.launches
    multi = four.render(spp=4)
    assert K1.Counter.launches == before + 2 * 8 * 4 * 2  # 4 frames x 2 rows
    np.testing.assert_allclose(multi, single, rtol=1e-4, atol=1e-5)
    for key in ("rays_closest", "rays_shadow"):
        assert four.stats()[key] == one.stats()[key]
    np.testing.assert_array_equal(multi.view(np.uint32),
                                  plain_sharded(four, 4).view(np.uint32))


def test_walk_kernel_on_no_rays(dev):
    tables = K3.walk_tables(load_jax_scene(pack_device_scene(
        cornell_box(tessellation=4)), dev))
    empty = torch.zeros((3, 0), device=dev)
    _walk_case(tables, empty, empty, {})


def test_sorted_walk_equals_bare_kernel(dev, monkeypatch):
    """make_closest_hit's walk with reorder=True (rays in bucket order)
    against the bare kernel at 128x128 on the 4,898-triangle box:
    bounce-1 rays, 5% of them, and the bounce's shadow rays. The sort is
    forced on this tree, which is below the JAX gate."""
    monkeypatch.setattr(INTERSECT, "REORDER_MIN_NODES", 1)
    sc = cornell_box(tessellation=12)
    scene = load_jax_scene(pack_device_scene(sc), dev)
    tables = K3.walk_tables(scene)
    size = 128
    cam = camera_device(Camera(width=size, height=size).as_pytree(), size,
                        size)
    x, y = CAM.pixel_grid(size, size, device=dev)
    ro, rd, state = CAM.generate_rays(cam, x, y, 1, use_dof=True)
    rays = torch.cat([ro, rd]).contiguous()
    n = rays.shape[1]
    assert n >= INTERSECT.REORDER_MIN_LANES
    nt = scene["tri_isect"].shape[0]
    t, idx = K3.closest_hit_walk(tables, ro, rd, num_tris=nt)
    outs = K2.bounce_stage_plain(
        0, rays, state, torch.ones((3, n), device=dev),
        torch.zeros((3, n), device=dev),
        torch.ones((n,), dtype=torch.bool, device=dev), t, idx,
        scene["tri_full"], scene["light_full"], do_mis=True,
        num_lights=sc.num_lights)
    late = outs[4] & torch.from_numpy(
        np.random.default_rng(4).random(n) < 0.05).to(dev)
    ch = INTERSECT.make_closest_hit(scene, "walk")
    for r, kw in ((outs[0], dict(active=outs[4])),
                  (outs[0], dict(active=late)),
                  (outs[5], dict(active=outs[7], t_max=outs[6],
                                 any_hit=True))):
        o, d = r[0:3], r[3:6]
        before = K3.Counter.launches
        st, si = ch(o, d, reorder=True, **kw)
        torch.cuda.synchronize()
        assert K3.Counter.launches == before + 1
        bt, bi = K3.closest_hit_walk(tables, o, d, num_tris=nt, **kw)
        assert torch.equal(_bits(st), _bits(bt)) and torch.equal(si, bi)
        assert (si >= 0).any()


def test_renderer_walk_path_equals_plain_path(dev):
    r = Renderer(RenderConfig(width=W, height=H), device="cuda")
    r.load_scene(cornell_box(tessellation=12))
    assert r.stats()["intersector"] == "walk"
    before = K3.Counter.launches
    kernel = r.render(spp=1)
    assert K3.Counter.launches == before + 2 * r.config.max_bounces
    plain = plain_render(r, spp=1)
    assert K3.Counter.launches == before + 2 * r.config.max_bounces
    np.testing.assert_array_equal(kernel.view(np.uint32),
                                  plain.view(np.uint32))


@pytest.mark.parametrize("mode", ["closest", "active", "any_hit"])
@pytest.mark.parametrize("kind", list(DISPATCH))
def test_dispatch_kernel_equals_plain(dev, kind, mode):
    """K4, K5 and K6 on the 4,898-triangle box: camera rays (4,096: four
    blocks of K4 and K6, two of K5), and their bounce-1 and shadow rays
    from one plain bounce; then a ray count that fills no block."""
    module, kernel, plain, get_tables = DISPATCH[kind]
    sc = cornell_box(tessellation=12)
    scene = load_jax_scene(pack_device_scene(sc), dev)
    tables = get_tables(scene)
    cam = camera_device(Camera(width=W, height=H).as_pytree(), W, H)
    x, y = CAM.pixel_grid(W, H, device=dev)
    ro, rd, state = CAM.generate_rays(cam, x, y, 1, use_dof=True)
    rays = torch.cat([ro, rd]).contiguous()
    n = rays.shape[1]
    t, idx = K3.closest_hit_walk_plain(K3.walk_tables(scene), ro, rd)
    outs = K2.bounce_stage_plain(
        0, rays, state, torch.ones((3, n), device=dev),
        torch.zeros((3, n), device=dev),
        torch.ones((n,), dtype=torch.bool, device=dev), t, idx,
        scene["tri_full"], scene["light_full"], do_mis=True,
        num_lights=sc.num_lights)
    nt = scene["tri_isect"].shape[0]
    for r in (rays, outs[0], outs[5], rays[:, :1500]):
        o, d = r[0:3].contiguous(), r[3:6].contiguous()
        m = o.shape[1]
        kw = dict(num_tris=nt)
        if mode == "active":
            kw["active"] = (outs[4] if r is outs[0] else outs[7])[:m]
        elif mode == "any_hit":
            kw.update(active=outs[7][:m], t_max=outs[6][:m], any_hit=True)
        before = module.Counter.launches
        kt, ki = kernel(tables, o, d, **kw)
        torch.cuda.synchronize()
        assert module.Counter.launches == before + 1
        pt, pi = plain(tables, o, d, **kw)
        assert torch.equal(_bits(kt), _bits(pt)) and torch.equal(ki, pi)
        assert (ki >= 0).any()


def _bounce_sets(dev, size):
    """The 4,898-triangle box at ``size`` x ``size``: its scene, and its
    bounce-1 rays, their alive mask, a late-bounce mask of about 5% of them,
    and their shadow rays with mask and t_max, from one plain bounce."""
    sc = cornell_box(tessellation=12)
    scene = load_jax_scene(pack_device_scene(sc), dev)
    cam = camera_device(Camera(width=size, height=size).as_pytree(), size,
                        size)
    x, y = CAM.pixel_grid(size, size, device=dev)
    ro, rd, state = CAM.generate_rays(cam, x, y, 1, use_dof=True)
    rays = torch.cat([ro, rd]).contiguous()
    n = rays.shape[1]
    t, idx = K3.closest_hit_walk_plain(K3.walk_tables(scene), ro, rd)
    outs = K2.bounce_stage_plain(
        0, rays, state, torch.ones((3, n), device=dev),
        torch.zeros((3, n), device=dev),
        torch.ones((n,), dtype=torch.bool, device=dev), t, idx,
        scene["tri_full"], scene["light_full"], do_mis=True,
        num_lights=sc.num_lights)
    late = outs[4] & torch.from_numpy(
        np.random.default_rng(5).random(n) < 0.05).to(dev)
    return scene, rays, outs, late


@pytest.mark.parametrize("bn", [1024, 100, 2048])
def test_block_entry_kernel_equals_plain(dev, bn):
    """Phase 1's kernel against block_entry (-0 == +0) on camera, bounce-1
    and shadow rays of the 4,898-triangle box, against its super boxes and
    its cluster boxes, at a ray count that fills no block."""
    scene, rays, outs, _ = _bounce_sets(dev, W)
    for r, active, t_max in ((rays, None, None), (outs[0], outs[4], None),
                             (outs[5], outs[7], outs[6])):
        m = r.shape[1] - 37
        o, d = r[0:3, :m].contiguous(), r[3:6, :m].contiguous()
        lim0 = BLOCKS.ray_limit(None if active is None else active[:m],
                                None if t_max is None else t_max[:m], m, dev)
        padded = BLOCKS.pad_blocks(o, d, lim0, bn)
        for aabb in (scene["pairs_super_aabb"], scene["cluster_aabb"]):
            before = BLOCKS.Counter.launches
            got = BLOCKS.block_entry_cuda(aabb, *padded)
            torch.cuda.synchronize()
            assert BLOCKS.Counter.launches == before + 1
            want = BLOCKS.block_entry(aabb, *padded)
            assert torch.equal(got, want)
            assert (want < torch.inf).any()
            for a, b in zip(K4.sorted_pairs(got), K4.sorted_pairs(want)):
                assert torch.equal(a, b)


def test_pair_route_kernel_equals_plain(dev, monkeypatch):
    """K4 behind make_closest_hit's with_tail_compaction, against the plain
    version behind the same wrapper, at 128x128 (16,384 lanes, the sort
    forced on this tree): bounce-1 rays (the whole call sorted), a
    late-bounce mask of 5% (the n/8 tier, sorted), the shadow rays, and a
    call with no live lane (the n/8 tier, fill lanes only)."""
    monkeypatch.setattr(INTERSECT, "REORDER_MIN_NODES", 1)
    scene, _, outs, late = _bounce_sets(dev, 128)
    kernel = INTERSECT.make_closest_hit(scene, "pairs")
    plain = plain_closest_hit(scene, "pairs")
    none = torch.zeros_like(late)
    for r, kw in ((outs[0], dict(active=outs[4])),
                  (outs[0], dict(active=late)),
                  (outs[5], dict(active=outs[7], t_max=outs[6],
                                 any_hit=True)),
                  (outs[0], dict(active=none))):
        o, d = r[0:3], r[3:6]
        before = K4.Counter.launches, BLOCKS.Counter.launches
        kt, ki = kernel(o, d, reorder=True, **kw)
        torch.cuda.synchronize()
        assert (K4.Counter.launches, BLOCKS.Counter.launches) == (
            before[0] + 1, before[1] + 1)
        pt, pi = plain(o, d, reorder=True, **kw)
        assert torch.equal(_bits(kt), _bits(pt)) and torch.equal(ki, pi)
        assert (ki >= 0).any() or not kw["active"].any()


@pytest.mark.parametrize("n", [200000, 100000, 40000, 3000])
def test_pairs_kernel_at_every_split(dev, n):
    """K4 against its plain version at ray counts whose blocks take each
    split of a block's rows over a CTA cluster (on an H100 at two CTAs an
    SM: 196 blocks one CTA each, 98 blocks two, 40 four, 3 eight), random
    rays over the 4,898-triangle box with 30% of them alive and a random
    t_max on half of those."""
    packed = pack_device_scene(cornell_box(tessellation=12))
    scene = load_jax_scene(packed, dev)
    tables = K4.pair_tables(scene)
    rng = np.random.default_rng(n)
    root = packed["bvh_aabb"][0]
    lo, hi = root[0:3, None], root[3:6, None]
    o = torch.from_numpy(rng.uniform(lo, hi, (3, n)).astype(np.float32))
    d = torch.from_numpy(rng.normal(size=(3, n)).astype(np.float32))
    active = torch.from_numpy(rng.random(n) < 0.3)
    t_max = torch.from_numpy(np.where(
        rng.random(n) < 0.5, rng.uniform(0.1, 3.0, n), np.inf).astype(
            np.float32))
    o, d, active, t_max = (x.to(dev) for x in (o, d, active, t_max))
    nt = scene["tri_isect"].shape[0]
    kt, ki = K4.closest_hit_pairs(tables, o, d, active, t_max, num_tris=nt)
    torch.cuda.synchronize()
    pt, pi = K4.closest_hit_pairs_plain(tables, o, d, active, t_max,
                                        num_tris=nt)
    assert torch.equal(_bits(kt), _bits(pt)) and torch.equal(ki, pi)
    assert (ki >= 0).sum() > 0.05 * n


def test_cluster_kernel_on_sparse_lanes(dev):
    """K6 against its plain version on the late-bounce mask (5% alive: the
    dead lanes skip their tests) and on a ray count that fills no block."""
    scene, _, outs, late = _bounce_sets(dev, W)
    tables = K6.cluster_tables(scene)
    nt = scene["tri_isect"].shape[0]
    for m in (outs[0].shape[1], 1500):
        o, d = outs[0][0:3, :m].contiguous(), outs[0][3:6, :m].contiguous()
        kt, ki = K6.closest_hit_cluster(tables, o, d, late[:m], num_tris=nt)
        torch.cuda.synchronize()
        pt, pi = K6.closest_hit_cluster_plain(tables, o, d, late[:m],
                                              num_tris=nt)
        assert torch.equal(_bits(kt), _bits(pt)) and torch.equal(ki, pi)
        assert (ki >= 0).any()


def _phased_case(tables, o, d, **kw):
    """K5 against its plain version, bit for bit; one launch."""
    before = K5.Counter.launches
    kt, ki = K5.closest_hit_phased(tables, o, d, **kw)
    torch.cuda.synchronize()
    assert K5.Counter.launches == before + 1
    pt, pi = K5.closest_hit_phased_plain(tables, o, d, **kw)
    assert torch.equal(_bits(kt), _bits(pt)) and torch.equal(ki, pi)
    return pi


def _random_dispatch_rays(packed, n, dev):
    """``n`` rays from anywhere in the box's bounds, 30% of them alive and
    half of those with a random t_max."""
    rng = np.random.default_rng(n)
    root = packed["bvh_aabb"][0]
    o = rng.uniform(root[0:3, None], root[3:6, None], (3, n))
    d = rng.normal(size=(3, n))
    active = rng.random(n) < 0.3
    t_max = np.where(rng.random(n) < 0.5, rng.uniform(0.1, 3.0, n), np.inf)
    return (torch.from_numpy(o.astype(np.float32)).to(dev),
            torch.from_numpy(d.astype(np.float32)).to(dev),
            torch.from_numpy(active).to(dev),
            torch.from_numpy(t_max.astype(np.float32)).to(dev))


@pytest.mark.parametrize("n", [1, 31, 2047, 2049, 5000, 16385])
def test_phased_kernel_on_ragged_counts(dev, n):
    """Ray counts that fill no block (the tail lanes vote for nothing and
    the last CTA is partly past the rays), with sparse lanes and limits."""
    packed = pack_device_scene(cornell_box(tessellation=12))
    scene = load_jax_scene(packed, dev)
    tables = K5.phased_tables(scene["walk_tris"])
    o, d, active, t_max = _random_dispatch_rays(packed, n, dev)
    nt = scene["tri_isect"].shape[0]
    _phased_case(tables, o, d, active=active, t_max=t_max, num_tris=nt)
    pi = _phased_case(tables, o, d, num_tris=nt)
    assert (pi >= 0).any()


def test_phased_kernel_on_sparse_and_dead_lanes(dev):
    """The late-bounce mask (5% alive: live lanes packed onto a CTA's first
    threads) and a call with no live lane (every CTA leaves at once)."""
    scene, _, outs, late = _bounce_sets(dev, W)
    tables = K5.phased_tables(scene["walk_tris"])
    nt = scene["tri_isect"].shape[0]
    o, d = outs[0][0:3].contiguous(), outs[0][3:6].contiguous()
    pi = _phased_case(tables, o, d, active=late, num_tris=nt)
    assert (pi >= 0).any()
    pi = _phased_case(tables, o, d, active=torch.zeros_like(late),
                      num_tris=nt)
    assert (pi == -1).all()


def test_phased_kernel_past_one_gate_window(dev):
    """cornell_box(tessellation=16): 95 leaf groups, 1,520 sub-clusters, more
    than one window (1,024) of the test kernel's gate list and six CTAs of
    the gate kernel a ray block; camera, bounce-1 and shadow rays."""
    sc = cornell_box(tessellation=16)
    scene = load_jax_scene(pack_device_scene(sc), dev)
    tables = K5.phased_tables(scene["walk_tris"])
    assert scene["walk_tris"].shape[0] // K5.GROUP_ROWS > 64
    cam = camera_device(Camera(width=W, height=H).as_pytree(), W, H)
    x, y = CAM.pixel_grid(W, H, device=dev)
    ro, rd, state = CAM.generate_rays(cam, x, y, 1, use_dof=True)
    n = ro.shape[1]
    t, idx = K3.closest_hit_walk_plain(K3.walk_tables(scene), ro, rd)
    outs = K2.bounce_stage_plain(
        0, torch.cat([ro, rd]).contiguous(), state,
        torch.ones((3, n), device=dev), torch.zeros((3, n), device=dev),
        torch.ones((n,), dtype=torch.bool, device=dev), t, idx,
        scene["tri_full"], scene["light_full"], do_mis=True,
        num_lights=sc.num_lights)
    nt = scene["tri_isect"].shape[0]
    assert (_phased_case(tables, ro, rd, num_tris=nt) >= 0).any()
    b = outs[0]
    _phased_case(tables, b[0:3].contiguous(), b[3:6].contiguous(),
                 active=outs[4], num_tris=nt)
    sh = outs[5]
    _phased_case(tables, sh[0:3].contiguous(), sh[3:6].contiguous(),
                 active=outs[7], t_max=outs[6], num_tris=nt)


@pytest.mark.parametrize("bn", [32, 96, 256])
def test_phased_kernel_at_other_block_sizes(dev, bn):
    """Blocks of 32, 96 and 256 rays: the test kernel's CTA shrinks to the
    largest power of two that divides the block (32, 32, 256)."""
    packed = pack_device_scene(cornell_box(tessellation=12))
    scene = load_jax_scene(packed, dev)
    tables = K5.phased_tables(scene["walk_tris"])
    o, d, active, t_max = _random_dispatch_rays(packed, 3000, dev)
    _phased_case(tables, o, d, active=active, t_max=t_max, bn=bn)


def test_phased_kernel_with_unordered_slots(dev):
    """Slots shuffled inside each sub-cluster, with a duplicate of slot 0's
    triangle under a higher index (exact-t ties): the tables fail
    slots_ascending and the kernel's index-comparing instantiation runs."""
    packed = pack_device_scene(cornell_box(tessellation=12))
    tris = torch.from_numpy(packed["walk_tris"]).clone()
    groups = tris.view(-1, K5.GROUP_ROWS, 128)
    rng = np.random.default_rng(3)
    for g in range(groups.shape[0]):
        for c in range(16):
            k = np.arange(8 * c, 8 * c + 8)
            if groups[g, 9, k[0]] < 0 or groups[g, 9, k[1]] < 0:
                continue
            groups[g, 0:9, k[1]] = groups[g, 0:9, k[0]]
            groups[g, 9, k[1]] = groups[g, 9, k[0]] + 100000.0
            groups[g, 0:10, k] = groups[g, 0:10, rng.permutation(k)]
    tables = K5.phased_tables(tris.to(dev))
    assert not tables.ordered
    o, d, active, t_max = _random_dispatch_rays(packed, 5000, dev)
    assert (_phased_case(tables, o, d) >= 0).any()


@pytest.mark.parametrize("kind", list(DISPATCH))
def test_renderer_dispatch_path_equals_plain_path(dev, kind):
    r = Renderer(RenderConfig(width=W, height=H, intersector=kind),
                 device="cuda")
    r.load_scene(cornell_box(tessellation=12))
    assert r.stats()["intersector"] == kind
    counter = DISPATCH[kind][0].Counter
    before = counter.launches
    kernel = r.render(spp=1)
    assert counter.launches == before + 2 * r.config.max_bounces
    plain = plain_render(r, spp=1)
    assert counter.launches == before + 2 * r.config.max_bounces
    np.testing.assert_array_equal(kernel.view(np.uint32),
                                  plain.view(np.uint32))


@pytest.mark.parametrize("scene_fn, mode", [
    (cornell_box, "none"),
    (textured_cornell, "fat"),
    (coprime_textured, "per_slot"),
])
def test_bounce_lds_kernel_equals_plain(dev, scene_fn, mode):
    """K2's LDS instantiation on the stratified camera rays, at bounce 0 in
    each texture mode, on all ten outputs; at bounce 1 the lds operand is
    ignored and the plain instantiation runs."""
    sc = scene_fn()
    scene = load_jax_scene(pack_device_scene(sc), dev)
    atlas, slots = TRACE.scene_atlas(scene)
    assert K2.texture_mode(atlas) == mode
    cam = camera_device(Camera(width=W, height=H).as_pytree(), W, H)
    x, y = CAM.pixel_grid(W, H, device=dev)
    ro, rd, state = CAM.generate_rays(cam, x, y, 3, use_dof=True,
                                      rng_mode="stratified")
    lds = CAM.bounce0_lds(x, y, 3)
    rays = torch.cat([ro, rd]).contiguous()
    n = rays.shape[1]
    thr = torch.ones((3, n), device=dev)
    res = torch.zeros((3, n), device=dev)
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    kw = dict(do_mis=True, num_lights=sc.num_lights, atlas=atlas,
              slots_used=slots)
    for b in range(2):
        t, idx = K1.closest_hit_dense_plain(scene["tri_isect"], rays)
        args = (b, rays, state, thr, res, alive, t, idx, scene["tri_full"],
                scene["light_full"])
        before = K2.Counter.lds
        kout = K2.bounce_stage_cuda(*args, **kw, lds=lds)
        torch.cuda.synchronize()
        assert K2.Counter.lds == before + (b == 0)
        pout = K2.bounce_stage_plain(*args, **kw, lds=lds)
        for k, p in zip(kout, pout):
            assert torch.equal(_bits(k), _bits(p)), f"bounce {b}"
        rays, state, thr, res, alive = pout[:5]


@pytest.mark.parametrize("rng", ["hash", "stratified"])
def test_renderer_rng_modes_equal_plain_path(dev, rng):
    r = Renderer(RenderConfig(width=W, height=H, rng=rng), device="cuda")
    r.load_scene(cornell_box())
    before = K2.Counter.lds
    kernel = r.render(spp=2)
    assert K2.Counter.lds == before + (2 if rng == "stratified" else 0)
    plain = plain_render(r, spp=2)
    assert np.isfinite(kernel).all()
    np.testing.assert_array_equal(kernel.view(np.uint32),
                                  plain.view(np.uint32))


def test_renderer_frames_per_trace_equals_one_frame_a_trace(dev):
    images = []
    for fpt in (1, 2):
        r = Renderer(RenderConfig(width=W, height=H, rng="stratified",
                                  frames_per_trace=fpt), device="cuda")
        r.load_scene(cornell_box())
        before = K1.Counter.launches
        images.append(r.render(spp=4))
        assert K1.Counter.launches == before + 2 * r.config.max_bounces * 4 // fpt
    np.testing.assert_array_equal(images[0].view(np.uint32),
                                  images[1].view(np.uint32))


def _dense_case(tri, ro, rd):
    """K1 over rows (3, N) against its plain version, bit for bit; one
    launch."""
    before = K1.Counter.launches
    t, idx = K1.closest_hit_dense_rows(tri, ro, rd)
    torch.cuda.synchronize()
    assert K1.Counter.launches == before + 1
    pt, pi = K1.closest_hit_dense_plain(tri, torch.cat([ro, rd]))
    assert torch.equal(_bits(t), _bits(pt)) and torch.equal(idx, pi)
    return idx


@pytest.mark.parametrize("name", ADVERSARIAL)
def test_dense_hit_kernel_on_adversarial_rays(dev, name):
    """K1's early exits on Möller-Trumbore's razor edges, ties, degenerate
    directions and ragged counts (chip_smoke.py::adversarial_case)."""
    v0, v1, v2, ro, rd = adversarial_case(name)
    tri = torch.from_numpy(tri_isect_of(v0, v1, v2)).to(dev)
    _dense_case(tri, torch.from_numpy(ro.T.copy()).to(dev),
                torch.from_numpy(rd.T.copy()).to(dev))


@pytest.mark.parametrize("n", [1, 129, 255, 257, 383, 16385, 300001])
def test_dense_hit_kernel_on_ragged_counts(dev, n):
    """Ray counts that are no multiple of the rays a thread or a block, and
    one past a wave of blocks, on the Cornell box from inside it."""
    scene = load_jax_scene(pack_device_scene(cornell_box()), dev)
    rng = np.random.default_rng(n)
    ro = rng.uniform([-0.95, 0.05, -0.95], [0.95, 1.95, 0.95], (n, 3))
    rd = rng.normal(size=(n, 3))
    idx = _dense_case(scene["tri_isect"],
                      torch.from_numpy(ro.T.astype(np.float32)).to(dev),
                      torch.from_numpy(rd.T.astype(np.float32)).to(dev))
    assert (idx >= 0).float().mean() > 0.5


def test_dense_hit_kernel_takes_row_views(dev):
    """The two-pointer form over the rows of one (6, N) buffer, as
    trace_cuda holds them, and over many triangles (several shared tiles),
    equals the (6, N) form and the plain version."""
    tris = pack_device_scene(cornell_box(tessellation=6))["tri_isect"]
    tri = torch.from_numpy(tris).to(dev)
    assert tri.shape[0] > 1024
    _, _, rays, _ = _rays(cornell_box, dev)
    _dense_case(tri, rays[0:3], rays[3:6])
    t, idx = K1.closest_hit_dense(tri, rays)
    pt, pi = K1.closest_hit_dense_rows(tri, rays[0:3], rays[3:6])
    assert torch.equal(_bits(t), _bits(pt)) and torch.equal(idx, pi)


@pytest.mark.parametrize("lds", [False, True])
@pytest.mark.parametrize("mode", ["none", "per_slot", "fat"])
def test_bounce_kernel_on_the_lane_mix(dev, mode, lds):
    """K2 in each of its six instantiations on the lane mix
    (chip_smoke.py::lane_mix_box: every lobe, light type and lane class,
    from random rays), bounces 0..3, all ten outputs, every lane."""
    if mode == "none":
        sc = lane_mix_box(material_test_box)
    else:
        sc = lane_mix_box(textured_material_box)
    scene = scene_of(sc, dev, drop_fat=mode == "per_slot")
    atlas, slots = TRACE.scene_atlas(scene)
    assert K2.texture_mode(atlas) == mode
    n = 4096
    start = lane_mix_rays(n, seed=2)
    ro, rd, state, alive = (torch.from_numpy(x).to(dev) for x in start)
    rays = torch.cat([ro, rd]).contiguous()
    lds_rows = torch.from_numpy(np.random.default_rng(3).random(
        (3, n), dtype=np.float32)).to(dev) if lds else None
    thr = torch.ones((3, n), device=dev)
    res = torch.zeros((3, n), device=dev)
    kw = dict(do_mis=True, num_lights=sc.num_lights, atlas=atlas,
              slots_used=slots, lds=lds_rows)
    for b in range(4):
        t, idx = K1.closest_hit_dense_plain(scene["tri_isect"], rays)
        args = (b, rays, state, thr, res, alive, t, idx, scene["tri_full"],
                scene["light_full"])
        before = (K2.Counter.by_mode[mode], K2.Counter.lds)
        kout = K2.bounce_stage_cuda(*args, **kw)
        torch.cuda.synchronize()
        assert (K2.Counter.by_mode[mode], K2.Counter.lds) == (
            before[0] + 1, before[1] + (lds and b == 0))
        pout = K2.bounce_stage_plain(*args, **kw)
        for k, p in zip(kout, pout):
            assert torch.equal(_bits(k), _bits(p)), f"bounce {b}"
        rays, state, thr, res, alive = pout[:5]


@pytest.mark.parametrize("lds", [False, True])
@pytest.mark.parametrize("mode", ["none", "per_slot", "fat"])
def test_bounce_env_kernel_equals_plain(dev, mode, lds):
    """K2's ENV instantiation (the environment map's miss term) in each
    texture mode, with and without LDS at bounce 0, on the open material
    box's camera rays (many misses), bounces 0..3, all ten outputs."""
    sc = material_test_box() if mode == "none" else textured_material_box()
    scene = scene_of(sc, dev, drop_fat=mode == "per_slot")
    atlas, slots = TRACE.scene_atlas(scene)
    assert K2.texture_mode(atlas) == mode
    env = with_env(scene, dev)
    cam = camera_device(Camera(width=W, height=H).as_pytree(), W, H)
    x, y = CAM.pixel_grid(W, H, device=dev)
    ro, rd, state = CAM.generate_rays(cam, x, y, 3, use_dof=True)
    rays = torch.cat([ro, rd]).contiguous()
    n = rays.shape[1]
    thr = torch.ones((3, n), device=dev)
    res = torch.zeros((3, n), device=dev)
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    kw = dict(do_mis=True, num_lights=sc.num_lights, atlas=atlas,
              slots_used=slots, env=env,
              lds=CAM.bounce0_lds(x, y, 3) if lds else None)
    missed = 0
    for b in range(4):
        t, idx = K1.closest_hit_dense_plain(scene["tri_isect"], rays)
        missed += int((alive & (idx < 0)).sum())
        args = (b, rays, state, thr, res, alive, t, idx, scene["tri_full"],
                scene["light_full"])
        before = K2.Counter.env
        kout = K2.bounce_stage_cuda(*args, **kw)
        torch.cuda.synchronize()
        assert K2.Counter.env == before + 1
        pout = K2.bounce_stage_plain(*args, **kw)
        for k, p in zip(kout, pout):
            assert torch.equal(_bits(k), _bits(p)), f"bounce {b}"
        rays, state, thr, res, alive = pout[:5]
    assert missed > 0


def test_renderer_env_path_equals_plain_path(dev):
    r = Renderer(RenderConfig(width=W, height=H), device="cuda")
    r.load_scene(material_test_box())
    r.set_environment(env_map(), intensity=1.5, rotation=0.7)
    before = K2.Counter.env
    kernel = r.render(spp=2)
    assert K2.Counter.env == before + 2 * r.config.max_bounces
    plain = plain_render(r, spp=2)
    assert K2.Counter.env == before + 2 * r.config.max_bounces
    np.testing.assert_array_equal(kernel.view(np.uint32),
                                  plain.view(np.uint32))
    r.set_environment(None)  # the 1x1 map: no ENV launch
    r.render(spp=1)
    assert K2.Counter.env == before + 2 * r.config.max_bounces


def test_renderer_gltf_path_equals_plain_path(dev, tmp_path):
    path = tmp_path / "atrium.glb"
    path.write_bytes(scene_to_glb(gallery_atrium(detail=1)))
    r = Renderer(RenderConfig(width=W, height=H), device="cuda")
    r.load_model(str(path))
    assert r.stats()["intersector"] == "walk"
    assert r.stats()["texture"] == "fat"
    before = (K3.Counter.launches, K2.Counter.by_mode["fat"])
    kernel = r.render(spp=1)
    assert (K3.Counter.launches, K2.Counter.by_mode["fat"]) == (
        before[0] + 2 * r.config.max_bounces,
        before[1] + r.config.max_bounces)
    plain = plain_render(r, spp=1)
    np.testing.assert_array_equal(kernel.view(np.uint32),
                                  plain.view(np.uint32))
    assert load_model(str(path)).num_triangles == r.scene.num_triangles


def _walk_cases(scene, rays, dev):
    """Camera rays, the bounce-1 rays of a plain bounce (a third of them
    dead) and shadow rays with t_max and any_hit."""
    n = rays.shape[1]
    rng = np.random.default_rng(4)
    o, d = rays[0:3].T, rays[3:6].T
    alive = torch.from_numpy(rng.random(n) > 0.33).to(dev)
    t_max = torch.from_numpy(rng.uniform(0.2, 3.0, n).astype(
        np.float32)).to(dev)
    d2 = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32)).to(dev)
    d2 = d2 / d2.norm(dim=1, keepdim=True)
    t, _ = K1.closest_hit_dense_plain(scene["tri_isect"], rays)
    hit_o = torch.where(torch.isfinite(t)[:, None], o + d * t[:, None], o)
    return [(o, d, {}), (hit_o.contiguous(), d2.contiguous(),
                         {"active": alive}),
            (hit_o.contiguous(), d2.contiguous(),
             {"active": alive, "t_max": t_max, "any_hit": True})]


def _bvh_walk_cases(scene, rays, dev):
    """``_walk_cases``, then the bounce rays with ``active`` and ``t_max``
    (closest hit below t_max) and the camera rays with a leaf size below
    the tree's (2 of up to 4 triangles a leaf)."""
    cases = _walk_cases(scene, rays, dev)
    o2, d2, kw = cases[2]
    return cases + [(o2, d2, {"active": kw["active"], "t_max": kw["t_max"]}),
                    (cases[0][0], cases[0][1], {"leaf_size": 2})]


@pytest.mark.parametrize("kind", ["stack", "bvh"])
@pytest.mark.parametrize("scene_fn", [cornell_box,
                                      lambda: cornell_box(tessellation=6)])
def test_bvh_walk_kernels_equal_plain(dev, kind, scene_fn):
    """K7 and K8 through the wrapper that stages their tables on the call
    (the first case) and through the launcher over tables staged once (the
    others) against their plain versions, and K7's depth mode on the
    camera rays against its plain version, both ways."""
    _, scene, rays, _ = _rays(scene_fn, dev)
    aabb, tri = scene["bvh_aabb"], scene["tri_isect"]
    if kind == "stack":
        table, counter = scene["bvh_meta"], INTERSECT.StackCounter
        cuda, plain = (INTERSECT.closest_hit_bvh_cuda,
                       INTERSECT.closest_hit_bvh_plain)
        staged = INTERSECT.stack_tables(aabb, table, tri)
        launch = INTERSECT.launch_stack
    else:
        table = INTERSECT.linked_nodes(scene["bvh_meta"], scene["bvh_links"])
        counter = INTERSECT.LinkedCounter
        cuda, plain = (INTERSECT.closest_hit_bvh_linked_cuda,
                       INTERSECT.closest_hit_bvh_linked_plain)
        staged = INTERSECT.linked_tables(aabb, table, tri)
        launch = INTERSECT.launch_linked
    for case, (o, d, kw) in enumerate(_bvh_walk_cases(scene, rays, dev)):
        before = counter.launches
        if case == 0:
            kt, ki = cuda(aabb, table, tri, o, d, **kw)
        else:
            kt, ki = launch(staged, o, d, **kw)
        torch.cuda.synchronize()
        assert counter.launches == before + 1
        pt, pi = plain(aabb, table, tri, o, d, **kw)
        assert torch.equal(_bits(kt), _bits(pt)) and torch.equal(ki, pi), kw
    if kind == "stack":
        o, d = rays[0:3].T, rays[3:6].T
        pd = INTERSECT.bvh_depth_plain(aabb, table, o, d, 24.0)
        kd = INTERSECT.bvh_depth_cuda(aabb, table, o, d, 24.0)
        assert torch.equal(_bits(kd), _bits(pd))
        kd = INTERSECT.launch_stack_depth(staged._replace(tris=None), o, d,
                                          24.0)
        assert torch.equal(_bits(kd), _bits(pd))


@pytest.mark.parametrize("kind", ["stack", "bvh"])
def test_make_closest_hit_launches_over_its_staged_tables(dev, monkeypatch,
                                                          kind):
    """Every CUDA call of the "stack" and "bvh" closures launches its kernel
    over the one set of tables staged when the closure was made."""
    name = "launch_stack" if kind == "stack" else "launch_linked"
    launch, seen = getattr(INTERSECT, name), []
    monkeypatch.setattr(INTERSECT, name, lambda tables, *a, **kw: (
        seen.append(tables) or launch(tables, *a, **kw)))
    _, scene, rays, _ = _rays(cornell_box, dev)
    ch = INTERSECT.make_closest_hit(scene, kind)
    plain = plain_closest_hit(scene, kind)
    for o, d, kw in _walk_cases(scene, rays, dev):
        kt, ki = ch(o.T, d.T, **kw)
        pt, pi = plain(o.T, d.T, **kw)
        assert torch.equal(_bits(kt), _bits(pt)) and torch.equal(ki, pi), kw
    assert len(seen) == 3 and all(x is seen[0] for x in seen)
    assert isinstance(seen[0], INTERSECT.BVH2Tables)


@pytest.mark.parametrize("depth,steps", [(1, 30), (2, 40), (3, 60),
                                         (64, 10_000)])
def test_stack_kernel_overflow_and_step_cap_equal_plain(dev, depth, steps):
    """K7 and its depth mode on a left spine that overflows a stack of
    fewer than 12 entries, to a step cap, against their plain versions;
    and K8 to the same step cap."""
    spine = {k: torch.from_numpy(v).to(dev)
             for k, v in left_spine(12).items()}
    o, d = spine_rays(4096, 13, 2, dev)
    o, d = o.T.contiguous(), d.T.contiguous()
    args = (spine["bvh_aabb"], spine["bvh_meta"], spine["tri_isect"], o, d)
    kt, ki = INTERSECT.closest_hit_bvh_cuda(*args, stack_depth=depth,
                                            max_steps=steps)
    pt, pi = INTERSECT.closest_hit_bvh_plain(*args, stack_depth=depth,
                                             max_steps=steps)
    assert torch.equal(_bits(kt), _bits(pt)) and torch.equal(ki, pi)
    kd = INTERSECT.bvh_depth_cuda(spine["bvh_aabb"], spine["bvh_meta"], o, d,
                                  24.0, depth, steps)
    pd = INTERSECT.bvh_depth_plain(spine["bvh_aabb"], spine["bvh_meta"], o,
                                   d, 24.0, depth, steps)
    assert torch.equal(_bits(kd), _bits(pd))
    nodes = INTERSECT.linked_nodes(spine["bvh_meta"], spine["bvh_links"])
    largs = (spine["bvh_aabb"], nodes, spine["tri_isect"], o, d)
    kt, ki = INTERSECT.closest_hit_bvh_linked_cuda(*largs, max_steps=steps)
    pt, pi = INTERSECT.closest_hit_bvh_linked_plain(*largs, max_steps=steps)
    assert torch.equal(_bits(kt), _bits(pt)) and torch.equal(ki, pi)


def test_bvh_division_equals_ieee_division(dev):
    """K7's and K8's division (csrc/bvh2.cu div_by: the reciprocal once a
    divisor, the quotient's FMAs a plane, __fdiv_rn outside its window)
    against ``/`` in the same file and PyTorch's division, bit for bit, on
    2^24 random bit patterns, the special operands and their neighbours
    against each other and against random patterns, and 2^22 pairs inside
    the fast window (chip_smoke.div_operands). The one freedom the source
    states: a zero numerator over a divisor of the window gives +0 where
    ``/`` may give -0 (the walks only compare their quotients)."""
    a, d = div_operands(1 << 24, 1, dev)
    assert a.numel() > (1 << 24) + (1 << 22)
    got, ieee = INTERSECT.bvh2_div(a, d)
    assert div_apart(a, d, got, ieee) == 0
    assert div_apart(a, d, got, a / d) == 0
    nan = torch.isnan(ieee)
    assert torch.equal(got[nan].view(torch.int32),
                       ieee[nan].view(torch.int32))
    signs = got.view(torch.int32) != ieee.view(torch.int32)
    assert bool((a[signs] == 0).all()) and bool((got[signs] == 0).all())


def test_atrous_kernel_equals_plain_at_every_level(dev):
    rng = np.random.default_rng(0)
    h, w = 96, 80
    color = torch.from_numpy(rng.random((h, w, 3), dtype=np.float32)
                             * 2).to(dev)
    normal = torch.from_numpy(rng.normal(size=(h, w, 3)).astype(
        np.float32)).to(dev)
    normal = normal / normal.norm(dim=-1, keepdim=True)
    depth = torch.from_numpy(rng.uniform(1, 5, (h, w)).astype(
        np.float32)).to(dev)
    found = torch.from_numpy(rng.random((h, w)) > 0.2).to(dev)
    var = torch.from_numpy(rng.random((h, w), dtype=np.float32)
                           * 0.1).to(dev)
    normal[~found] = 0.0
    depth[~found] = 0.0
    for i in range(5):
        before = K9.Counter.launches
        kc, kv = K9.atrous_level(color, normal, depth, found, var, 1 << i)
        torch.cuda.synchronize()
        assert K9.Counter.launches == before + 1
        pc, pv = K9.atrous_level_plain(color, normal, depth, found, var,
                                       1 << i)
        assert torch.equal(_bits(kc), _bits(pc)), i
        assert torch.equal(_bits(kv), _bits(pv)), i
        color, var = pc, pv


@pytest.mark.parametrize("step", [1, 2, 4, 8, 16, 64])
@pytest.mark.parametrize("h, w", [(37, 53), (512, 512)])
def test_atrous_kernel_equals_plain_at_every_step(dev, h, w, step):
    """K9's tiles of the decimated grid at the denoiser's steps and past
    the image's size (64 > 37, 53: a pixel a residue, every tap clamped),
    on a ragged and a full-size image."""
    rng = np.random.default_rng(h + step)
    color = torch.from_numpy(rng.random((h, w, 3), dtype=np.float32)
                             * 3).to(dev)
    normal = torch.from_numpy(rng.normal(size=(h, w, 3)).astype(
        np.float32)).to(dev)
    normal = normal / normal.norm(dim=-1, keepdim=True)
    depth = torch.from_numpy(rng.uniform(1, 5, (h, w)).astype(
        np.float32)).to(dev)
    found = torch.from_numpy(rng.random((h, w)) > 0.2).to(dev)
    var = torch.from_numpy(rng.random((h, w), dtype=np.float32)
                           * 0.1).to(dev)
    normal[~found] = 0.0
    depth[~found] = 0.0
    before = K9.Counter.launches
    kc, kv = K9.atrous_level(color, normal, depth, found, var, step)
    torch.cuda.synchronize()
    assert K9.Counter.launches == before + 1
    pc, pv = K9.atrous_level_plain(color, normal, depth, found, var, step)
    assert torch.equal(_bits(kc), _bits(pc))
    assert torch.equal(_bits(kv), _bits(pv))


@pytest.mark.parametrize("kind", ["stack", "bvh"])
def test_renderer_binary_bvh_paths_equal_plain_path(dev, kind):
    r = Renderer(RenderConfig(width=W, height=H, intersector=kind),
                 device="cuda")
    r.load_scene(cornell_box())
    assert r.stats()["intersector"] == kind
    counter = (INTERSECT.StackCounter if kind == "stack"
               else INTERSECT.LinkedCounter)
    before = counter.launches
    kernel = r.render(spp=2)
    assert counter.launches == before + 4 * r.config.max_bounces
    np.testing.assert_array_equal(kernel.view(np.uint32),
                                  plain_render(r, spp=2).view(np.uint32))


@pytest.mark.parametrize("kind", ["stack", "bvh"])
def test_renderer_binary_bvh_ray_order_equals_plain_path(dev, monkeypatch,
                                                         kind):
    """A 128x128 render (REORDER_MIN_LANES rays a call) through "stack" and
    "bvh" at two bounces, on ``cornell_box(tessellation=30)`` (30,602
    triangles, 19,603 binary nodes: at least BVH2_REORDER_MIN_NODES for
    both): bounce 1's closest-hit and shadow calls walk their rays in
    ``ray_order``, and the image equals the plain path's (every ray walked
    alone, in lane order) bit for bit."""
    sorts = []
    order = INTERSECT.ray_order
    monkeypatch.setattr(INTERSECT, "ray_order",
                        lambda *a: sorts.append(1) or order(*a))
    size = 128
    r = Renderer(RenderConfig(width=size, height=size, intersector=kind,
                              max_bounces=2), device="cuda")
    r.load_scene(cornell_box(tessellation=30))
    assert size * size >= INTERSECT.REORDER_MIN_LANES
    assert (r._scene_dev["bvh_aabb"].shape[0]
            >= INTERSECT.BVH2_REORDER_MIN_NODES[kind])
    counter = (INTERSECT.StackCounter if kind == "stack"
               else INTERSECT.LinkedCounter)
    before = counter.launches
    kernel = r.render(spp=1)
    assert counter.launches == before + 4
    assert len(sorts) == 2
    np.testing.assert_array_equal(kernel.view(np.uint32),
                                  plain_render(r, spp=1).view(np.uint32))


@pytest.mark.parametrize("mode", ["normal", "bvh_depth"])
def test_renderer_debug_views_equal_plain_path(dev, mode):
    r = Renderer(RenderConfig(width=W, height=H, mode=mode), device="cuda")
    r.load_scene(cornell_box())
    before = (K1.Counter.launches, INTERSECT.StackCounter.depth)
    view = r.render(spp=1)
    after = (K1.Counter.launches, INTERSECT.StackCounter.depth)
    assert after == ((before[0] + 1, before[1]) if mode == "normal"
                     else (before[0], before[1] + 1))
    np.testing.assert_array_equal(view.view(np.uint32),
                                  plain_debug(r).view(np.uint32))


def test_renderer_denoise_equals_plain_path(dev):
    r = Renderer(RenderConfig(width=W, height=H), device="cuda")
    r.load_scene(cornell_box())
    r.render(spp=4)
    before = K9.Counter.launches
    got = r.denoise()
    assert K9.Counter.launches == before + 5
    np.testing.assert_array_equal(got.view(np.uint32),
                                  plain_denoise(r).view(np.uint32))


def test_renderer_adaptive_equals_plain_path(dev):
    r = Renderer(RenderConfig(width=W, height=H), device="cuda")
    r.load_scene(cornell_box())
    got = r.render_adaptive(8)
    np.testing.assert_array_equal(got.view(np.uint32),
                                  plain_adaptive(r, 8).view(np.uint32))


@pytest.mark.parametrize("kernel", ["pallas", "xla"])
def test_renderer_bounce_kernels_equal_auto(dev, kernel):
    """``RenderConfig.bounce_kernel``: "pallas" runs K2 as "auto" does,
    "xla" the plain bounce loop with no K2 launch; the images are equal on
    every pixel."""
    images = {}
    for name in ("auto", kernel):
        r = Renderer(RenderConfig(width=W, height=H, bounce_kernel=name),
                     device="cuda")
        r.load_scene(material_test_box())
        before = K2.Counter.launches
        images[name] = r.render(spp=2)
        k2 = K2.Counter.launches - before
        assert k2 == (0 if name == "xla" else 2 * r.config.max_bounces)
    np.testing.assert_array_equal(images[kernel].view(np.uint32),
                                  images["auto"].view(np.uint32))


def _jpeg_box_equals_plain(tmp_path, names) -> None:
    """``textured_cornell(tessellation=12)`` in a glTF whose textures are
    the committed JPEGs ``names`` (``tests/jpeg``), through ``load_model``:
    the walk and K2 on the fat canvas, equal to its plain path on every
    pixel."""
    from chip_smoke import jpeg_cases, with_jpeg_images

    path = tmp_path / "jpeg_textured.gltf"
    textures = {name: data for name, data, _ in jpeg_cases()}
    path.write_text(with_jpeg_images(
        scene_to_glb(textured_cornell(tessellation=12)),
        [textures[name] for name in names]))
    r = Renderer(RenderConfig(width=W, height=H), device="cuda")
    r.load_model(str(path))
    assert r.stats()["intersector"] == "walk"
    assert r.stats()["texture"] == "fat"
    np.testing.assert_array_equal(r.render(spp=1).view(np.uint32),
                                  plain_render(r, spp=1).view(np.uint32))


def test_renderer_jpeg_textured_scene_equals_plain_path(dev, tmp_path):
    """The progressive, CMYK and YCCK textures of ``chip_smoke.py``'s
    JPEG-textured box (``_jpeg_box_equals_plain``)."""
    from chip_smoke import JPEG_TEXTURES

    _jpeg_box_equals_plain(tmp_path, JPEG_TEXTURES)


def test_renderer_arithmetic_jpeg_textured_scene_equals_plain_path(
        dev, tmp_path):
    """The arithmetic-coded (SOF9, SOF10) and lossless (SOF3) textures of
    ``chip_smoke.py``'s second JPEG-textured box, through K3 and K2-fat
    (``_jpeg_box_equals_plain``)."""
    from chip_smoke import JPEG_TEXTURES_ARITH

    _jpeg_box_equals_plain(tmp_path, JPEG_TEXTURES_ARITH)


def test_renderer_ldr_textured_scene_equals_plain_path(dev, tmp_path):
    """``chip_smoke.py``'s LDR-textured box: ``textured_cornell(
    tessellation=12)`` in a glTF whose four texture slots are sidecar files
    (an RLE TGA with alpha, an RLE8 BMP, a binary P6, an LZW TIFF with
    predictor 2), through ``load_model``: the walk and K2 in the scene's
    texture mode, equal to its plain path on every pixel."""
    from chip_smoke import LDR_TEXTURES, ldr_cases, with_sidecar_images

    files = {name: data for name, data, _ in ldr_cases()}
    for name in LDR_TEXTURES:
        (tmp_path / name).write_bytes(files[name])
    path = tmp_path / "ldr_textured.gltf"
    path.write_text(with_sidecar_images(
        scene_to_glb(textured_cornell(tessellation=12)), list(LDR_TEXTURES)))
    r = Renderer(RenderConfig(width=W, height=H), device="cuda")
    r.load_model(str(path))
    mode = r.stats()["texture"]
    assert r.stats()["intersector"] == "walk" and mode in ("fat", "per_slot")
    before = (K3.Counter.launches, K2.Counter.by_mode[mode])
    kernel = r.render(spp=1)
    assert (K3.Counter.launches, K2.Counter.by_mode[mode]) == (
        before[0] + 2 * r.config.max_bounces,
        before[1] + r.config.max_bounces)
    np.testing.assert_array_equal(kernel.view(np.uint32),
                                  plain_render(r, spp=1).view(np.uint32))


@pytest.mark.parametrize("name", ["env_rle32.tga", "env_rgb16.tif"])
def test_renderer_ldr_env_map_equals_plain_path(dev, name):
    """The material box under ``chip_smoke.py``'s RLE 32-bit TGA map and
    16-bit RGB TIFF map (``RenderConfig.env_map``): K2's ENV instantiation
    at every bounce, the image equal to the plain path's."""
    from chip_smoke import LDR_DIR

    r = Renderer(RenderConfig(width=W, height=H,
                              env_map=f"{LDR_DIR}/{name}", env_intensity=1.5),
                 device="cuda")
    r.load_scene(material_test_box())
    before = K2.Counter.env
    kernel = r.render(spp=2)
    assert K2.Counter.env == before + 2 * r.config.max_bounces
    np.testing.assert_array_equal(kernel.view(np.uint32),
                                  plain_render(r, spp=2).view(np.uint32))


def test_renderer_webp_gif_textured_scene_equals_plain_path(
        dev, tmp_path, monkeypatch):
    """``chip_smoke.py``'s WebP/GIF-textured box (a lossy WebP with alpha,
    a lossless WebP, a GIF with a transparency index, a lossy WebP with
    VP8L-compressed alpha as sidecar textures) through ``load_model`` and
    the CUDA bounce: the C++ decoders taken (``native_available()`` is true
    on the card's host, and each WebP and GIF loop is called), the walk and
    K2 in the scene's texture mode, equal to its plain path on every
    pixel."""
    from chip_smoke import WEBP_GIF_TEXTURES, ldr_cases, with_sidecar_images
    from wgpu_path_tracing_tpu_torch.accel import native

    assert native.native_available()
    calls = {}
    for fn in ("vp8_native", "vp8l_native", "yuv_to_rgb_native",
               "alpha_unfilter_native", "gif_lzw_native"):
        real = getattr(native, fn)

        def counted(*args, _real=real, _fn=fn):
            calls[_fn] = calls.get(_fn, 0) + 1
            return _real(*args)

        monkeypatch.setattr(native, fn, counted)
    files = {name: data for name, data, _ in ldr_cases()}
    for name in WEBP_GIF_TEXTURES:
        (tmp_path / name).write_bytes(files[name])
    path = tmp_path / "webp_gif_textured.gltf"
    path.write_text(with_sidecar_images(
        scene_to_glb(textured_cornell(tessellation=12)),
        list(WEBP_GIF_TEXTURES)))
    r = Renderer(RenderConfig(width=W, height=H), device="cuda")
    r.load_model(str(path))
    assert set(calls) == {"vp8_native", "vp8l_native", "yuv_to_rgb_native",
                          "alpha_unfilter_native", "gif_lzw_native"}, calls
    mode = r.stats()["texture"]
    assert r.stats()["intersector"] == "walk" and mode in ("fat", "per_slot")
    before = (K3.Counter.launches, K2.Counter.by_mode[mode])
    kernel = r.render(spp=1)
    assert (K3.Counter.launches, K2.Counter.by_mode[mode]) == (
        before[0] + 2 * r.config.max_bounces,
        before[1] + r.config.max_bounces)
    np.testing.assert_array_equal(kernel.view(np.uint32),
                                  plain_render(r, spp=1).view(np.uint32))


@pytest.mark.parametrize("name", ["env_lossy.webp", "env.gif"])
def test_renderer_webp_gif_env_map_equals_plain_path(dev, name):
    """The material box under ``chip_smoke.py``'s lossy WebP map and GIF
    map: K2's ENV instantiation at every bounce, the image equal to the
    plain path's."""
    from chip_smoke import LDR_DIR

    r = Renderer(RenderConfig(width=W, height=H,
                              env_map=f"{LDR_DIR}/{name}", env_intensity=1.5),
                 device="cuda")
    r.load_scene(material_test_box())
    before = K2.Counter.env
    kernel = r.render(spp=2)
    assert K2.Counter.env == before + 2 * r.config.max_bounces
    np.testing.assert_array_equal(kernel.view(np.uint32),
                                  plain_render(r, spp=2).view(np.uint32))


def test_renderer_tiff_variant_textured_scene_equals_plain_path(
        dev, tmp_path, monkeypatch):
    """``chip_smoke.py``'s TIFF-variant-textured box (JPEG-in-TIFF YCbCr
    tiles, BigTIFF LZW RGBA, float gray with the floating-point predictor,
    G4 as sidecar textures) through ``load_model`` and the CUDA bounce: the
    C++ LZW, CCITT and JPEG loops taken, the walk and K2 in the scene's
    texture mode, equal to its plain path on every pixel."""
    from chip_smoke import TIFF_VARIANT_TEXTURES, ldr_cases, with_sidecar_images
    from wgpu_path_tracing_tpu_torch.accel import native

    assert native.native_available()
    calls = {}
    for fn in ("lzw_native", "fax_native", "jpeg_scan_native"):
        real = getattr(native, fn)

        def counted(*args, _real=real, _fn=fn):
            calls[_fn] = calls.get(_fn, 0) + 1
            return _real(*args)

        monkeypatch.setattr(native, fn, counted)
    files = {name: data for name, data, _ in ldr_cases()}
    for name in TIFF_VARIANT_TEXTURES:
        (tmp_path / name).write_bytes(files[name])
    path = tmp_path / "tiff_variant_textured.gltf"
    path.write_text(with_sidecar_images(
        scene_to_glb(textured_cornell(tessellation=12)),
        list(TIFF_VARIANT_TEXTURES)))
    r = Renderer(RenderConfig(width=W, height=H), device="cuda")
    r.load_model(str(path))
    assert set(calls) == {"lzw_native", "fax_native", "jpeg_scan_native"}, (
        calls)
    mode = r.stats()["texture"]
    assert r.stats()["intersector"] == "walk" and mode in ("fat", "per_slot")
    before = (K3.Counter.launches, K2.Counter.by_mode[mode])
    kernel = r.render(spp=1)
    assert (K3.Counter.launches, K2.Counter.by_mode[mode]) == (
        before[0] + 2 * r.config.max_bounces,
        before[1] + r.config.max_bounces)
    np.testing.assert_array_equal(kernel.view(np.uint32),
                                  plain_render(r, spp=1).view(np.uint32))


@pytest.mark.parametrize("name", ["env_jpeg_ycbcr.tif", "env_float.tif"])
def test_renderer_tiff_variant_env_map_equals_plain_path(dev, name):
    """The material box under ``chip_smoke.py``'s JPEG-in-TIFF YCbCr map
    and float TIFF map: K2's ENV instantiation at every bounce, the image
    equal to the plain path's."""
    from chip_smoke import LDR_DIR

    r = Renderer(RenderConfig(width=W, height=H,
                              env_map=f"{LDR_DIR}/{name}", env_intensity=1.5),
                 device="cuda")
    r.load_scene(material_test_box())
    before = K2.Counter.env
    kernel = r.render(spp=2)
    assert K2.Counter.env == before + 2 * r.config.max_bounces
    np.testing.assert_array_equal(kernel.view(np.uint32),
                                  plain_render(r, spp=2).view(np.uint32))


def test_renderer_asset_textured_scene_equals_plain_path(
        dev, tmp_path, monkeypatch):
    """``chip_smoke.py``'s asset-textured box (BC7 DDS, BC1 DDS with 1-bit
    alpha, PackBits PSD, QOI as sidecar textures) through ``load_model``
    and the CUDA bounce: the C++ block, PackBits and QOI loops taken, the
    walk and K2 in the scene's texture mode, equal to its plain path on
    every pixel."""
    from chip_smoke import ASSET_TEXTURES, ldr_cases, with_sidecar_images
    from wgpu_path_tracing_tpu_torch.accel import native

    assert native.native_available()
    calls = {}
    for fn in ("bcn_native", "packbits_rows_native", "qoi_native"):
        real = getattr(native, fn)

        def counted(*args, _real=real, _fn=fn):
            calls[_fn] = calls.get(_fn, 0) + 1
            return _real(*args)

        monkeypatch.setattr(native, fn, counted)
    files = {name: data for name, data, _ in ldr_cases()}
    for name in ASSET_TEXTURES:
        (tmp_path / name).write_bytes(files[name])
    path = tmp_path / "asset_textured.gltf"
    path.write_text(with_sidecar_images(
        scene_to_glb(textured_cornell(tessellation=12)),
        list(ASSET_TEXTURES)))
    r = Renderer(RenderConfig(width=W, height=H), device="cuda")
    r.load_model(str(path))
    assert set(calls) == {"bcn_native", "packbits_rows_native",
                          "qoi_native"}, calls
    mode = r.stats()["texture"]
    assert r.stats()["intersector"] == "walk" and mode in ("fat", "per_slot")
    before = (K3.Counter.launches, K2.Counter.by_mode[mode])
    kernel = r.render(spp=1)
    assert (K3.Counter.launches, K2.Counter.by_mode[mode]) == (
        before[0] + 2 * r.config.max_bounces,
        before[1] + r.config.max_bounces)
    np.testing.assert_array_equal(kernel.view(np.uint32),
                                  plain_render(r, spp=1).view(np.uint32))


@pytest.mark.parametrize("name", ["env_bc1.dds", "env_rle.sgi"])
def test_renderer_asset_env_map_equals_plain_path(dev, name):
    """The material box under ``chip_smoke.py``'s BC1 DDS map and RLE SGI
    map: K2's ENV instantiation at every bounce, the image equal to the
    plain path's."""
    from chip_smoke import LDR_DIR

    r = Renderer(RenderConfig(width=W, height=H,
                              env_map=f"{LDR_DIR}/{name}", env_intensity=1.5),
                 device="cuda")
    r.load_scene(material_test_box())
    before = K2.Counter.env
    kernel = r.render(spp=2)
    assert K2.Counter.env == before + 2 * r.config.max_bounces
    np.testing.assert_array_equal(kernel.view(np.uint32),
                                  plain_render(r, spp=2).view(np.uint32))


def test_renderer_legacy_textured_scene_equals_plain_path(
        dev, tmp_path, monkeypatch):
    """``chip_smoke.py``'s legacy-textured box (a sheared DXT5 BLP2, a BLP1
    JPEG, a run-length it32 ICNS with its mask, an XPM as sidecar
    textures) through ``load_model`` and the CUDA bounce: the C++ DXT and
    ICNS loops taken, the walk and K2 in the scene's texture mode, equal
    to its plain path on every pixel."""
    from chip_smoke import LEGACY_TEXTURES, ldr_cases, with_sidecar_images
    from wgpu_path_tracing_tpu_torch.accel import native

    assert native.native_available()
    calls = {}
    for fn in ("blp_dxt_native", "icns_rle_native"):
        real = getattr(native, fn)

        def counted(*args, _real=real, _fn=fn):
            calls[_fn] = calls.get(_fn, 0) + 1
            return _real(*args)

        monkeypatch.setattr(native, fn, counted)
    files = {name: data for name, data, _ in ldr_cases()}
    for name in LEGACY_TEXTURES:
        (tmp_path / name).write_bytes(files[name])
    path = tmp_path / "legacy_textured.gltf"
    path.write_text(with_sidecar_images(
        scene_to_glb(textured_cornell(tessellation=12)),
        list(LEGACY_TEXTURES)))
    r = Renderer(RenderConfig(width=W, height=H), device="cuda")
    r.load_model(str(path))
    assert set(calls) == {"blp_dxt_native", "icns_rle_native"}, calls
    mode = r.stats()["texture"]
    assert r.stats()["intersector"] == "walk" and mode in ("fat", "per_slot")
    before = (K3.Counter.launches, K2.Counter.by_mode[mode])
    kernel = r.render(spp=1)
    assert (K3.Counter.launches, K2.Counter.by_mode[mode]) == (
        before[0] + 2 * r.config.max_bounces,
        before[1] + r.config.max_bounces)
    np.testing.assert_array_equal(kernel.view(np.uint32),
                                  plain_render(r, spp=1).view(np.uint32))


@pytest.mark.parametrize("name", ["env_rle.ras", "env_dxt1.blp"])
def test_renderer_legacy_env_map_equals_plain_path(dev, name):
    """The material box under ``chip_smoke.py``'s RLE Sun raster map and
    DXT1 BLP2 map: K2's ENV instantiation at every bounce, the image equal
    to the plain path's."""
    from chip_smoke import LDR_DIR

    r = Renderer(RenderConfig(width=W, height=H,
                              env_map=f"{LDR_DIR}/{name}", env_intensity=1.5),
                 device="cuda")
    r.load_scene(material_test_box())
    before = K2.Counter.env
    kernel = r.render(spp=2)
    assert K2.Counter.env == before + 2 * r.config.max_bounces
    np.testing.assert_array_equal(kernel.view(np.uint32),
                                  plain_render(r, spp=2).view(np.uint32))


def test_renderer_sci_rare_textured_scene_equals_plain_path(
        dev, tmp_path, monkeypatch):
    """``chip_smoke.py``'s box of scientific and rare formats (a YCbCr IM,
    a GZIP_1 FITS, an FLC, a GIMP brush as sidecar textures) through
    ``load_model`` and the CUDA bounce: the C++ FLI loop taken, the walk
    and K2 in the scene's texture mode, equal to its plain path on every
    pixel."""
    from chip_smoke import SCI_RARE_TEXTURES, ldr_cases, with_sidecar_images
    from wgpu_path_tracing_tpu_torch.accel import native

    assert native.native_available()
    calls = {}
    real = native.fli_native

    def counted(*args):
        calls["fli_native"] = calls.get("fli_native", 0) + 1
        return real(*args)

    monkeypatch.setattr(native, "fli_native", counted)
    files = {name: data for name, data, _ in ldr_cases()}
    for name in SCI_RARE_TEXTURES:
        (tmp_path / name).write_bytes(files[name])
    path = tmp_path / "sci_rare_textured.gltf"
    path.write_text(with_sidecar_images(
        scene_to_glb(textured_cornell(tessellation=12)),
        list(SCI_RARE_TEXTURES)))
    r = Renderer(RenderConfig(width=W, height=H), device="cuda")
    r.load_model(str(path))
    assert calls == {"fli_native": 1}, calls
    mode = r.stats()["texture"]
    assert r.stats()["intersector"] == "walk" and mode in ("fat", "per_slot")
    before = (K3.Counter.launches, K2.Counter.by_mode[mode])
    kernel = r.render(spp=1)
    assert (K3.Counter.launches, K2.Counter.by_mode[mode]) == (
        before[0] + 2 * r.config.max_bounces,
        before[1] + r.config.max_bounces)
    np.testing.assert_array_equal(kernel.view(np.uint32),
                                  plain_render(r, spp=1).view(np.uint32))


@pytest.mark.parametrize("name", ["env_float.fits", "env.spi"])
def test_renderer_sci_rare_env_map_equals_plain_path(dev, name):
    """The material box under ``chip_smoke.py``'s float FITS map and SPIDER
    map: K2's ENV instantiation at every bounce, the image equal to the
    plain path's."""
    from chip_smoke import LDR_DIR

    r = Renderer(RenderConfig(width=W, height=H,
                              env_map=f"{LDR_DIR}/{name}", env_intensity=1.5),
                 device="cuda")
    r.load_scene(material_test_box())
    before = K2.Counter.env
    kernel = r.render(spp=2)
    assert K2.Counter.env == before + 2 * r.config.max_bounces
    np.testing.assert_array_equal(kernel.view(np.uint32),
                                  plain_render(r, spp=2).view(np.uint32))


def test_large_sci_rare_files_decode_to_pillows_digests_here(dev):
    """The 4096x2048 FLC and IM bit-decoder image and the Photo CD files
    made by the test writers decode on the card's host to the SHA-256 of
    Pillow's decode, with the C++ loops."""
    import hashlib
    import json

    from chip_smoke import LDR_DIR, decode_both, image_cases

    cases = image_cases()
    with open(f"{LDR_DIR}/pillow_sha256.json") as f:
        digests = json.load(f)
    made = {cases.LARGE_FLI: cases.large_fli(),
            cases.LARGE_IM_BITS: cases.large_im_bits()}
    made.update({n: cases.photo_cd(k) for k, n in enumerate(cases.PCD_FILES)})
    for name, data in made.items():
        ((rgba, _),) = decode_both(data, name, python=False)
        assert hashlib.sha256(rgba.tobytes()).hexdigest() == digests[name], name


def test_renderer_jpeg2000_textured_scene_equals_plain_path(
        dev, tmp_path, monkeypatch):
    """``chip_smoke.py``'s JPEG 2000 box (a reversible RGBA JP2, a tiled
    irreversible J2K, a 12-bit gray J2K and a palette JP2 as sidecar
    textures) through ``load_model`` and the CUDA bounce: the C++
    code-block decoder taken for each texture, the walk and K2 in the
    scene's texture mode, equal to its plain path on every pixel."""
    from chip_smoke import JPEG2000_TEXTURES, ldr_cases, with_sidecar_images
    from wgpu_path_tracing_tpu_torch.accel import native

    assert native.native_available()
    calls = {}
    real = native.j2k_t1_native

    def counted(*args):
        calls["j2k_t1_native"] = calls.get("j2k_t1_native", 0) + 1
        return real(*args)

    monkeypatch.setattr(native, "j2k_t1_native", counted)
    files = {name: data for name, data, _ in ldr_cases()}
    for name in JPEG2000_TEXTURES:
        (tmp_path / name).write_bytes(files[name])
    path = tmp_path / "jpeg2000_textured.gltf"
    path.write_text(with_sidecar_images(
        scene_to_glb(textured_cornell(tessellation=12)),
        list(JPEG2000_TEXTURES)))
    r = Renderer(RenderConfig(width=W, height=H), device="cuda")
    r.load_model(str(path))
    assert calls.get("j2k_t1_native", 0) >= len(JPEG2000_TEXTURES), calls
    mode = r.stats()["texture"]
    assert r.stats()["intersector"] == "walk" and mode in ("fat", "per_slot")
    before = (K3.Counter.launches, K2.Counter.by_mode[mode])
    kernel = r.render(spp=1)
    assert (K3.Counter.launches, K2.Counter.by_mode[mode]) == (
        before[0] + 2 * r.config.max_bounces,
        before[1] + r.config.max_bounces)
    np.testing.assert_array_equal(kernel.view(np.uint32),
                                  plain_render(r, spp=1).view(np.uint32))


@pytest.mark.parametrize("name", ["env.jp2", "env_rpcl.j2k"])
def test_renderer_jpeg2000_env_map_equals_plain_path(dev, name):
    """The material box under ``chip_smoke.py``'s irreversible JP2 map and
    reversible RPCL J2K map: K2's ENV instantiation at every bounce, the
    image equal to the plain path's."""
    from chip_smoke import LDR_DIR

    r = Renderer(RenderConfig(width=W, height=H,
                              env_map=f"{LDR_DIR}/{name}", env_intensity=1.5),
                 device="cuda")
    r.load_scene(material_test_box())
    before = K2.Counter.env
    kernel = r.render(spp=2)
    assert K2.Counter.env == before + 2 * r.config.max_bounces
    np.testing.assert_array_equal(kernel.view(np.uint32),
                                  plain_render(r, spp=2).view(np.uint32))


def test_large_jpeg2000_files_decode_to_pillows_digests_here(dev):
    """The committed 4096x2048 JP2 and J2K maps decode on the card's host
    to the SHA-256 of Pillow's decode with the C++ code-block decoder."""
    import hashlib
    import json

    from chip_smoke import LDR_DIR, decode_both, image_cases

    cases = image_cases()
    with open(f"{LDR_DIR}/pillow_sha256.json") as f:
        digests = json.load(f)
    for name in (cases.LARGE_J2K_IRR, cases.LARGE_J2K_REV):
        with open(f"{LDR_DIR}/{name}", "rb") as f:
            ((rgba, _),) = decode_both(f.read(), name, python=False)
        assert hashlib.sha256(rgba.tobytes()).hexdigest() == digests[name], name


def test_committed_ldr_files_decode_to_their_pillow_arrays_here(dev):
    """The files under ``tests/ldr`` decode on the card's host (no Pillow)
    to ``pillow_rgba.npz``, with the C++ loops and with the Python ones."""
    from chip_smoke import decode_both, ldr_cases

    cases = ldr_cases()
    assert len(cases) >= 40
    for name, data, want in cases:
        for rgba, _ in decode_both(data, name):
            np.testing.assert_array_equal(rgba, want, err_msg=name)
