"""The "hash" and "stratified" rng modes and K2's bounce-0 low-discrepancy
override, against the JAX package on the CPU.

The same numpy-made inputs go through the JAX function and the port's.
Integer results (hash seeds, RNG states) must be bit-equal. ``r2_point`` and
``bounce0_lds`` are bit-equal too: the port multiplies the frame by the
float32 constant and adds the product to the rotation as two rounded
operations, and XLA:CPU, which could contract ``u0 + f * R2_A1`` into one
fused multiply-add and so move a value by one ulp before the ``floor``, was
measured not to, eagerly or under ``jit``: the bound found is 0 ulp. Rays
keep ``tests/test_torch_rng.py``'s bar (rtol/atol 1e-6: XLA:CPU fuses the
pinhole direction's multiply-adds), the bounce ``tests/test_torch_bounce.py``'s
(razor-edge branches flip on at most 0.5% of lanes). The property tests are
the port's copies of ``tests/test_sampling.py``'s for the stratified mode.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from wgpu_path_tracing_tpu.models.procedural import cornell_box as jcornell_box
from wgpu_path_tracing_tpu.models.procedural import (
    material_test_box as jmaterial_test_box,
)
from wgpu_path_tracing_tpu.models.types import pack_device_scene as jpack
from wgpu_path_tracing_tpu.models.types import texture_slots_used
from wgpu_path_tracing_tpu.ops import bsdf as JBSDF
from wgpu_path_tracing_tpu.ops import camera_rays as JCAM
from wgpu_path_tracing_tpu.ops import rng as JRNG
from wgpu_path_tracing_tpu.ops.intersect import make_closest_hit as jmake_closest_hit
from wgpu_path_tracing_tpu.ops.pallas_bounce import (
    bounce_stage_pallas,
    prepare_tables,
    trace_pallas,
)
from wgpu_path_tracing_tpu.ops.shade import Hit as JHit
from wgpu_path_tracing_tpu.ops.vec import V3 as JV3
from wgpu_path_tracing_tpu.render.camera import Camera as JCamera
from wgpu_path_tracing_tpu.render.pipeline import camera_device as jcamera_device
from wgpu_path_tracing_tpu_torch import Renderer, RenderConfig, cornell_box
from wgpu_path_tracing_tpu_torch import load_jax_scene
from wgpu_path_tracing_tpu_torch.ops import bounce as K2
from wgpu_path_tracing_tpu_torch.ops import bsdf as PBSDF
from wgpu_path_tracing_tpu_torch.ops import camera_rays as PCAM
from wgpu_path_tracing_tpu_torch.ops import rng as PRNG
from wgpu_path_tracing_tpu_torch.ops import trace as TRACE
from wgpu_path_tracing_tpu_torch.ops.intersect import make_closest_hit
from wgpu_path_tracing_tpu_torch.ops.shade import Hit as PHit
from wgpu_path_tracing_tpu_torch.ops.vec import V3 as PV3
from wgpu_path_tracing_tpu_torch.render.camera import Camera
from wgpu_path_tracing_tpu_torch.render.pipeline import camera_device

from tests.test_torch_cuda import spot_cornell

torch.set_num_threads(1)

FRAMES = (0, 1, 4095, 4096, 100000)  # R2_CYCLE folds 4096 onto 0
W = H = 32  # 1024 rays: one Pallas block


def _pixels(seed, n=4096):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 4096, n).astype(np.int32)
    y = rng.integers(0, 4096, n).astype(np.int32)
    return x, y


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def _t(x, dtype=None):
    a = np.asarray(x)
    return torch.from_numpy(a.astype(dtype) if dtype else a.copy())


@pytest.mark.parametrize("frame", FRAMES)
def test_hash_seed_matches_jax(frame):
    x, y = _pixels(frame)
    for stream in range(8):
        want = np.asarray(JRNG.hash_seed(jnp.asarray(x), jnp.asarray(y),
                                         jnp.int32(frame), stream=stream))
        got = PRNG.hash_seed(torch.from_numpy(x), torch.from_numpy(y), frame,
                             stream).numpy()
        np.testing.assert_array_equal(got, want.astype(np.int64))
        assert got.min() >= 0 and got.max() < 2**32


@pytest.mark.parametrize("frame", FRAMES)
def test_r2_point_matches_jax(frame):
    """Bit-equal to the JAX function run eagerly and under jit (the frame
    traced, as inside the JAX render loop)."""
    x, y = _pixels(frame + 1)
    for stream in (1, 3, 6):
        jitted = jax.jit(lambda a, b, f, s=stream: JRNG.r2_point(a, b, f, s))
        got = PRNG.r2_point(torch.from_numpy(x), torch.from_numpy(y), frame,
                            stream)
        for want in (JRNG.r2_point(jnp.asarray(x), jnp.asarray(y),
                                   jnp.int32(frame), stream),
                     jitted(jnp.asarray(x), jnp.asarray(y), jnp.int32(frame))):
            for g, w in zip(got, want):
                assert g.dtype == torch.float32
                np.testing.assert_array_equal(_bits(g), _bits(w))
                assert (g >= 0).all() and (g < 1).all()


@pytest.mark.parametrize("frame", (0, 3, 4097))
def test_bounce0_lds_matches_jax(frame):
    x, y = _pixels(frame + 2)
    want = JCAM.bounce0_lds(jnp.asarray(x), jnp.asarray(y), jnp.int32(frame))
    got = PCAM.bounce0_lds(torch.from_numpy(x), torch.from_numpy(y), frame)
    assert got.shape == (3, x.shape[0]) and got.dtype == torch.float32
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("use_dof", [False, True])
@pytest.mark.parametrize("rng_mode", ["reference", "hash", "stratified"])
def test_generate_rays_modes_match_jax(rng_mode, use_dof):
    w, h, frame = 40, 24, 3
    jcam = JCamera(width=w, height=h, aspect=w / h)
    cam = Camera(width=w, height=h, aspect=w / h)
    jcam.aperture = cam.aperture = 0.05  # wide, so the lens offsets show
    jx, jy = JCAM.pixel_grid(w, h)
    jro, jrd, jst = JCAM.generate_rays(
        jcamera_device(jcam.as_pytree(), w, h), jx, jy, jnp.int32(frame),
        use_dof=use_dof, rng_mode=rng_mode)
    px, py = PCAM.pixel_grid(w, h)
    pro, prd, pst = PCAM.generate_rays(camera_device(cam.as_pytree(), w, h),
                                       px, py, frame, use_dof=use_dof,
                                       rng_mode=rng_mode)
    np.testing.assert_array_equal(pst.numpy(), np.asarray(jst).astype(np.int64))
    # rtol 1e-6: XLA:CPU's fused multiply-adds against per-op rounding.
    np.testing.assert_allclose(pro.numpy().T, np.asarray(jro), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(prd.numpy().T, np.asarray(jrd), rtol=1e-6,
                               atol=1e-6)
    if rng_mode == "stratified":
        # The PCG state is the hash seed, untouched by the R2 draws.
        np.testing.assert_array_equal(
            pst.numpy(), PRNG.hash_seed(px, py, frame).numpy())


def _hits(n, seed):
    """Random hit records over all three lobes (diffuse, metal, glass),
    front and back faces, and the same for both packages."""
    rng = np.random.default_rng(seed)
    f32 = np.float32

    def unit(k):
        v = rng.normal(size=(3, k)).astype(f32)
        return (v / np.linalg.norm(v, axis=0)).astype(f32)

    kind = rng.integers(0, 3, n)
    metallic = np.where(kind == 1, rng.uniform(0.3, 1.0, n), 0.0).astype(f32)
    transmission = np.where(kind == 2, 1.0, 0.0).astype(f32)
    fields = dict(
        t=np.ones(n, f32), found=np.ones(n, bool),
        position=rng.uniform(-1, 1, (3, n)).astype(f32), normal=unit(n),
        albedo=rng.uniform(0.1, 0.9, (3, n)).astype(f32),
        alpha=np.ones(n, f32),
        roughness=rng.uniform(0.04, 1.0, n).astype(f32), metallic=metallic,
        transmission=transmission, ior=np.full(n, 1.5, f32),
        emission=np.zeros((3, n), f32), emissive_strength=np.ones(n, f32),
        uv_u=np.zeros(n, f32), uv_v=np.zeros(n, f32),
        is_front=rng.random(n) < 0.7)
    rd = unit(n)
    jhit = JHit(**{k: (JV3(*map(jnp.asarray, v)) if np.ndim(v) == 2
                       else jnp.asarray(v)) for k, v in fields.items()})
    phit = PHit(**{k: (PV3(*map(torch.from_numpy, v)) if np.ndim(v) == 2
                       else torch.from_numpy(v)) for k, v in fields.items()})
    return jhit, phit, rd


@pytest.mark.parametrize("gate", ["lanes", True, False])
def test_sample_bsdf_override_matches_jax(gate):
    """The override replaces the three main draws where the gate holds; the
    state advances as without it (the Fresnel draw follows the lobe the
    override picks). Directions within rtol/atol 1e-4 on all but 0.5% of
    lanes: jnp.sin/cos and torch.sin/cos differ by an ulp on a few percent
    of float32 inputs, and refraction near the critical angle amplifies
    it."""
    n = 4096
    jhit, phit, rd = _hits(n, 7)
    rng = np.random.default_rng(8)
    state = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    mask = rng.random(n) < 0.9
    lds = rng.random((3, n), dtype=np.float32)
    g = rng.random(n) < 0.5 if gate == "lanes" else gate
    jdir, jst = JBSDF.sample_bsdf(
        jhit, JV3(*map(jnp.asarray, rd)), jhit.is_front, jnp.asarray(state),
        jnp.asarray(mask), override=(jnp.asarray(g), *map(jnp.asarray, lds)))
    pg = torch.from_numpy(np.asarray(g)) if gate == "lanes" else g
    pdir, pst = PBSDF.sample_bsdf(
        phit, PV3(*map(torch.from_numpy, rd)), phit.is_front,
        torch.from_numpy(state.astype(np.int64)), torch.from_numpy(mask),
        override=(pg, *map(torch.from_numpy, lds)))
    np.testing.assert_array_equal(pst.numpy(), np.asarray(jst).astype(np.int64))
    got = np.stack([pdir.x.numpy(), pdir.y.numpy(), pdir.z.numpy()])
    want = np.stack([np.asarray(jdir.x), np.asarray(jdir.y),
                     np.asarray(jdir.z)])
    close = np.isclose(got, want, rtol=1e-4, atol=1e-4).all(0)
    assert (~close).sum() <= 0.005 * n, f"{(~close).sum()} lanes differ"
    # Without the override the directions move where the gate holds.
    plain, _ = PBSDF.sample_bsdf(
        phit, PV3(*map(torch.from_numpy, rd)), phit.is_front,
        torch.from_numpy(state.astype(np.int64)), torch.from_numpy(mask))
    moved = (plain.x.numpy() != got[0]) | (plain.y.numpy() != got[1])
    gated = np.broadcast_to(np.asarray(g), (n,))
    assert not moved[~gated].any()
    if gated.any():
        assert moved[gated].mean() > 0.9


SCENES = {"cornell": jcornell_box, "material": jmaterial_test_box,
          "spot": lambda: spot_cornell(jcornell_box)}


def _stratified_rays(frame=0):
    """The stratified camera rays of a 32x32 frame and its LDS rows (JAX)."""
    cam = jcamera_device(JCamera(width=W, height=H).as_pytree(), W, H)
    x, y = JCAM.pixel_grid(W, H)
    ro, rd, state = JCAM.generate_rays(cam, x, y, jnp.int32(frame),
                                       use_dof=True, rng_mode="stratified")
    return ro, rd, state, JCAM.bounce0_lds(x, y, jnp.int32(frame))


@pytest.mark.parametrize("do_mis", [True, False])
@pytest.mark.parametrize("scene_name", ["cornell", "material", "spot"])
def test_bounce_with_lds_matches_pallas_interpret(scene_name, do_mis):
    """K2's plain version with ``lds`` against the Pallas bounce kernel's
    ``lds`` operand in interpret mode, at bounces 0 (the override) and 1
    (ignored), at ``tests/test_torch_bounce.py``'s bars."""
    sc = SCENES[scene_name]()
    packed = jpack(sc)
    dev = jax.device_put(packed)
    slots = texture_slots_used(packed["tri_full"])
    tri_table, light_table, _, _, _, tri_cols = prepare_tables(dev, slots)
    port = load_jax_scene(packed, "cpu")
    ro, rd, state, lds = _stratified_rays()
    n = W * H
    rays = jnp.concatenate([ro.T, rd.T], axis=0)
    state = state[None, :].astype(jnp.uint32)
    thr = jnp.ones((3, n), jnp.float32)
    res = jnp.zeros((3, n), jnp.float32)
    alive = jnp.ones((1, n), jnp.int32)
    closest_hit = jmake_closest_hit(dev, "brute", 4096, 4)
    plds = _t(lds)
    for b in range(2):
        t, idx = closest_hit(rays[0:3], rays[3:6])
        jout = bounce_stage_pallas(
            b, rays, state, thr, res, alive, t[None, :], idx[None, :],
            tri_table, light_table, None, None, lds, do_mis=do_mis,
            num_lights=sc.num_lights, slots_used=slots, interpret=True,
            tri_cols=tri_cols)
        args = (b, _t(rays), _t(state[0], np.int64), _t(thr), _t(res),
                _t(alive[0] != 0), _t(t), _t(idx), port["tri_full"],
                port["light_full"])
        kw = dict(do_mis=do_mis, num_lights=sc.num_lights)
        pout = K2.bounce_stage_plain(*args, **kw, lds=plds)
        j = [np.asarray(a)[0] if a.shape[0] == 1 else np.asarray(a)
             for a in jout]
        p = [a.numpy() for a in pout]
        same = p[1] == j[1].astype(np.int64)
        assert same.mean() >= 0.995, f"bounce {b}: state agrees on {same.mean()}"
        assert (p[4] == (j[4] != 0)).mean() >= 0.995
        assert ((p[7] == (j[7] != 0)) | ~same).all()
        live = same & p[7]
        for k, lanes in ((0, same), (2, same), (3, same), (8, same),
                         (9, same), (5, live), (6, live)):
            close = np.isclose(p[k].reshape(-1, n)[:, lanes],
                               j[k].reshape(-1, n)[:, lanes], rtol=1e-4,
                               atol=1e-4).all(0)
            assert (~close).sum() <= 0.002 * n, (
                f"output {k}, bounce {b}: {(~close).sum()} lanes differ")
        # The override acts at bounce 0 only.
        without = K2.bounce_stage_plain(*args, **kw)
        moved = (without[0] != pout[0]).any(0)
        assert bool(moved.any()) == (b == 0)
        rays, state, thr, res, alive = jout[:5]


def test_trace_lds0_matches_trace_pallas():
    """The plain trace with ``lds0`` against ``trace_pallas(lds0=)`` in
    interpret mode over 8 bounces, beside the same pair without ``lds0``:
    final states equal on >= 99.5% of lanes (a flipped razor-edge branch
    changes the rest of that path). Radiance is within rtol/atol 1e-4 on
    only about 96% of the lanes whose state agrees, with or without the
    override (measured 96.3% and 95.5% on this frame): XLA:CPU's fused
    multiply-adds move a shadow ray's t by an ulp, and a shadow test
    aimed t_max = dist - 2e-6 short of the light flips now and then,
    adding or dropping a light sample; a flipped test moves no RNG state.
    So the bar is that the override adds no disagreement beyond that class:
    its share of close lanes is at most 0.5% below the share without it,
    and the clamped means agree within 2e-3."""
    sc = jcornell_box()
    packed = jpack(sc)
    dev = jax.device_put(packed)
    port = load_jax_scene(packed, "cpu")
    ro, rd, state, lds = _stratified_rays(frame=2)
    ch = jmake_closest_hit(dev, "brute", 4096, 4)
    share = {}
    for name, rows in (("lds", lds), ("none", None)):
        jrad, jst, _ = trace_pallas(dev, ch, ro, rd, state, max_bounces=8,
                                    do_mis=True, num_lights=sc.num_lights,
                                    interpret=True, lds0=rows)
        prad, pst, _ = TRACE.trace(
            port, make_closest_hit(port), _t(ro.T), _t(rd.T),
            _t(state, np.int64), max_bounces=8, num_lights=sc.num_lights,
            lds0=None if rows is None else _t(rows))
        jrad, prad = np.asarray(jrad), prad.numpy().T
        same = pst.numpy() == np.asarray(jst).astype(np.int64)
        assert same.mean() >= 0.995, (name, same.mean())
        share[name] = np.isclose(prad[same], jrad[same], rtol=1e-4,
                                 atol=1e-4).all(-1).mean()
        pm, jm = np.minimum(prad, 2.5).mean(), np.minimum(jrad, 2.5).mean()
        assert abs(pm / jm - 1.0) < 2e-3, (name, pm, jm)
    assert share["lds"] >= share["none"] - 0.005, share


def test_trace_cuda_loop_with_lds_equals_plain_trace_on_cpu():
    """``trace_cuda`` hands ``lds0`` to K2 at bounce 0 only; on CPU tensors
    it runs the plain versions and equals ``trace`` bit for bit."""
    scene = load_jax_scene(jpack(jcornell_box()), "cpu")
    cam = camera_device(Camera(width=W, height=H).as_pytree(), W, H)
    x, y = PCAM.pixel_grid(W, H)
    ro, rd, state = PCAM.generate_rays(cam, x, y, 5, use_dof=True,
                                       rng_mode="stratified")
    lds = PCAM.bounce0_lds(x, y, 5)
    ch = make_closest_hit(scene)
    before = (K2.Counter.launches, K2.Counter.lds)
    a = K2.trace_cuda(scene, ch, ro, rd, state, num_lights=2, lds0=lds)
    b = TRACE.trace(scene, ch, ro, rd, state, num_lights=2, lds0=lds)
    c = TRACE.trace(scene, ch, ro, rd, state, num_lights=2)
    assert (K2.Counter.launches, K2.Counter.lds) == before
    for got, want in zip(a, b):
        assert torch.equal(got, want)
    assert not torch.equal(a[0], c[0])  # the override engaged


def test_bounce_stage_wrapper_takes_lds_on_cpu():
    """The wrapper runs the plain version on CPU tensors, lds included, and
    the CUDA entry refuses them."""
    scene = load_jax_scene(jpack(jcornell_box()), "cpu")
    rng = np.random.default_rng(3)
    n = 256
    rays = torch.from_numpy(np.concatenate(
        [rng.uniform(-0.5, 0.5, (3, n)) + [[0], [1], [0]],
         rng.normal(size=(3, n))]).astype(np.float32))
    t, idx = make_closest_hit(scene)(rays[0:3], rays[3:6])
    args = (0, rays, torch.from_numpy(rng.integers(0, 2**32, n)),
            torch.ones((3, n)), torch.zeros((3, n)),
            torch.ones(n, dtype=torch.bool), t, idx, scene["tri_full"],
            scene["light_full"])
    lds = torch.from_numpy(rng.random((3, n), dtype=np.float32))
    kw = dict(do_mis=True, num_lights=2)
    got = K2.bounce_stage(*args, **kw, lds=lds)
    want = K2.bounce_stage_plain(*args, **kw, lds=lds)
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.uint8), w.view(torch.uint8))
    with pytest.raises(ValueError):
        K2.bounce_stage_cuda(*args, **kw, lds=lds)


# --- the port's copies of tests/test_sampling.py's stratified-mode tests ----

def test_r2_stratified_sequence():
    """R2 points lie in [0, 1), step by the R2 constants from frame to frame,
    are rotated differently per pixel, and their frame mean converges
    faster than the reference PCG stream's."""
    x = torch.arange(8, dtype=torch.int32)
    y = torch.arange(8, dtype=torch.int32) * 3
    pts = np.array([np.stack([p.numpy() for p in PRNG.r2_point(x, y, f, 1)])
                    for f in range(256)])  # (frames, 2, pixels)
    assert (pts >= 0.0).all() and (pts < 1.0).all()
    du = (pts[1:, 0] - pts[:-1, 0]) % 1.0
    dv = (pts[1:, 1] - pts[:-1, 1]) % 1.0
    assert np.abs(du - PRNG.R2_A1).max() < 1e-4
    assert np.abs(dv - PRNG.R2_A2).max() < 1e-4
    assert len(np.unique(pts[0, 0].round(6))) == 8
    err_r2 = np.abs(pts.mean(axis=0) - 0.5).max()
    pcg = []
    for f in range(256):
        u, st = PRNG.rand(PRNG.seed_pixel(x, y, f))
        v, _ = PRNG.rand(st)
        pcg.append(np.stack([u.numpy(), v.numpy()]))
    err_pcg = np.abs(np.mean(pcg, axis=0) - 0.5).max()
    assert err_r2 < err_pcg / 2.0, (err_r2, err_pcg)


def _render(rng, spp=4, size=16):
    r = Renderer(RenderConfig(width=size, height=size, rng=rng), device="cpu")
    r.load_scene(cornell_box())
    return r.render(spp=spp)


def test_stratified_and_hash_modes_render():
    """Each mode renders NaN-free and gives its own image; the reference
    image is the one rng="reference" always gave (frames 0..3 of the PCG
    seeds), whatever the other modes did in between."""
    imgs = {mode: _render(mode) for mode in ("reference", "hash",
                                             "stratified")}
    for img in imgs.values():
        assert np.isfinite(img).all() and img.max() > 0
    assert np.abs(imgs["reference"] - imgs["stratified"]).max() > 0.0
    assert np.abs(imgs["reference"] - imgs["hash"]).max() > 0.0
    assert np.abs(imgs["hash"] - imgs["stratified"]).max() > 0.0
    np.testing.assert_array_equal(_render("reference"), imgs["reference"])


def test_bounce0_lds_override(monkeypatch):
    """The LDS rows lie in [0, 1) and step the lobe by the golden ratio;
    the stratified render is deterministic, and TRACE_BOUNCE0_LDS = False
    turns the override off (the image changes, so it engaged)."""
    x = torch.arange(64, dtype=torch.int32)
    y = torch.arange(64, dtype=torch.int32) * 7
    for f in (0, 3, 1000):
        lds = PCAM.bounce0_lds(x, y, f).numpy()
        assert lds.shape == (3, 64)
        assert (lds >= 0.0).all() and (lds < 1.0).all()
    l0 = PCAM.bounce0_lds(x, y, 0).numpy()[0]
    l1 = PCAM.bounce0_lds(x, y, 1).numpy()[0]
    assert np.abs((l1 - l0) % 1.0 - PCAM._PHI1).max() < 1e-4
    on1 = _render("stratified")
    np.testing.assert_array_equal(_render("stratified"), on1)
    monkeypatch.setattr(PCAM, "TRACE_BOUNCE0_LDS", False)
    off = _render("stratified")
    assert np.isfinite(off).all() and np.abs(on1 - off).max() > 0.0
