"""The textured slice of the port against the JAX package and the oracle.

Texel choice is held exactly wherever the uv arithmetic is exact: texel-
centre uvs on power-of-two rects, integer tiling offsets and NaN uvs give
the same texels in both packages, bit for bit. Where the uv comes from
barycentric interpolation, XLA:CPU contracts multiply-adds into FMAs and
PyTorch rounds each operation, so a uv that lands within rounding of a
texel boundary can pick the neighbouring texel ("texel-boundary lanes").
Such lanes are identified by the port's own texel coordinate lying within
1e-3 of an integer, and their count is bounded; every other lane agrees
within the FMA tolerance of tests/test_torch_bounce.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import atlas_bytes, plain_render
from tests.oracle import Oracle
from wgpu_path_tracing_tpu import Renderer as JRenderer
from wgpu_path_tracing_tpu import RenderConfig as JRenderConfig
from wgpu_path_tracing_tpu.models import gltf as JGLTF
from wgpu_path_tracing_tpu.models.procedural import (
    textured_cornell as jtextured_cornell,
)
from wgpu_path_tracing_tpu.models.types import pack_device_scene as jpack
from wgpu_path_tracing_tpu.models.types import texture_slots_used
from wgpu_path_tracing_tpu.ops import camera_rays as JCAM
from wgpu_path_tracing_tpu.ops import shade as JSHADE
from wgpu_path_tracing_tpu.ops import vec as JVEC
from wgpu_path_tracing_tpu.ops.intersect import make_closest_hit as jmake_closest_hit
from wgpu_path_tracing_tpu.ops.pallas_bounce import (
    _gather_texels,
    bounce_stage_pallas,
    prepare_tables,
)
from wgpu_path_tracing_tpu.render.camera import Camera as JCamera
from wgpu_path_tracing_tpu.render.pipeline import camera_device as jcamera_device
from wgpu_path_tracing_tpu_torch import (
    Camera,
    Renderer,
    RenderConfig,
    cornell_box,
    load_jax_scene,
    textured_cornell,
)
from wgpu_path_tracing_tpu_torch.models import types as T
from wgpu_path_tracing_tpu_torch.models.potpack import potpack
from wgpu_path_tracing_tpu_torch.ops import bounce as K2
from wgpu_path_tracing_tpu_torch.ops import camera_rays as CAM
from wgpu_path_tracing_tpu_torch.ops import shade as SHADE
from wgpu_path_tracing_tpu_torch.ops import trace as TRACE
from wgpu_path_tracing_tpu_torch.ops.intersect import make_closest_hit
from wgpu_path_tracing_tpu_torch.ops.vec import V3
from wgpu_path_tracing_tpu_torch.render.pipeline import camera_device

from tests.test_torch_renderer import _oracle_mean


# ---- scenes: the same mutation applied to either package's textured box ----

def _coprime(make):
    """256^2 congruent box whose 255^2 pbr rect blows the LCM budget: no fat
    canvas, so the port samples per slot (the per-slot main-path scene)."""
    sc = make(atlas_size=256, congruent=True)
    sc.mat_pbr_rect[0] = [0, 0, 255, 255]
    return sc


def _small_per_slot(make):
    """32^2 atlas whose 15^2 pbr rect against the 16^2 albedo needs a
    240^2 LCM canvas, past FAT_VMEM_TEXELS: the JAX package samples it per
    slot inside its kernel, and bakes nothing."""
    sc = make(congruent=True)
    sc.mat_pbr_rect[0] = [16, 0, 15, 15]
    return sc


def _nondivisible(make):
    sc = make(atlas_size=256)
    sc.mat_pbr_rect[0] = [128, 0, 96, 96]
    return sc


def _neg_uv(make):
    sc = make(atlas_size=256, congruent=True)
    sc.tri_uv0[0] = [-0.25, 0.5]
    return sc


def _all_neg_uv(make):
    """Every material's uv0 shifted below zero: every map set's grid
    extends, so negative uv fractions read the baked backward band."""
    sc = make(atlas_size=256, congruent=True)
    sc.tri_uv0[:] = np.asarray(sc.tri_uv0) - 1.0
    return sc


def _tiled(make):
    sc = make(atlas_size=256, congruent=True)
    for uv in (sc.tri_uv0, sc.tri_uv1, sc.tri_uv2):
        uv[:] = np.asarray(uv) * 3.0
    return sc


FAT_CASES = {
    "default": lambda m: m(),
    "32_congruent": lambda m: m(atlas_size=32, congruent=True),
    "128_congruent": lambda m: m(atlas_size=128, congruent=True),
    "256": lambda m: m(atlas_size=256),
    "256_congruent": lambda m: m(atlas_size=256, congruent=True),
    "nondivisible_96": _nondivisible,
    "coprime_255": _coprime,
    "negative_uv": _neg_uv,
    "tiled_x3": _tiled,
}
FAT_ABSENT = {"coprime_255"}


def _pair(case):
    return FAT_CASES[case](textured_cornell), FAT_CASES[case](jtextured_cornell)


# ---- potpack ---------------------------------------------------------------

@pytest.mark.parametrize("seed", range(6))
def test_potpack_matches_jax(seed):
    """Same positions and canvas as the JAX package's potpack (its native
    twin where that builds) and its Python packer; int dims stay int."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 40))
    if seed % 2 == 0:
        dims = [(int(w), int(h)) for w, h in rng.integers(1, 300, (n, 2))]
    else:
        dims = [(float(w), float(h)) for w, h in rng.uniform(1, 300, (n, 2))]
    boxes = [{"w": w, "h": h} for w, h in dims]
    got = potpack(boxes)
    for ref_fn in (JGLTF.potpack, JGLTF.potpack_python):
        ref_boxes = [{"w": w, "h": h} for w, h in dims]
        want = ref_fn(ref_boxes)
        assert tuple(got) == tuple(want)
        for a, b in zip(boxes, ref_boxes):
            assert (a["x"], a["y"]) == (b["x"], b["y"])
    if seed % 2 == 0:
        assert all(isinstance(v, int) for v in got)
        assert all(isinstance(b[k], int) for b in boxes for k in "xy")


# ---- the fat-atlas bake ----------------------------------------------------

@pytest.mark.parametrize("case", list(FAT_CASES))
def test_fat_tables_equal_jax(case):
    port_sc, jax_sc = _pair(case)
    port, ref = T.pack_device_scene(port_sc), jpack(jax_sc)
    present = "atlas_fat" in ref
    assert present == (case not in FAT_ABSENT)
    for key in T.FAT_KEYS:
        assert (key in port) == present, key
        if present:
            assert port[key].dtype == ref[key].dtype, key
            np.testing.assert_array_equal(port[key], ref[key], err_msg=key)
    for key in ("atlas", "tri_full"):
        np.testing.assert_array_equal(port[key], ref[key], err_msg=key)


def test_pack_asserts_bf16_exact_atlas():
    scene = textured_cornell()
    scene.atlas = scene.atlas.copy()
    scene.atlas[0, 0, 0] = np.float32(0.1234567)  # not bf16-representable
    with pytest.raises(ValueError, match="bf16-exact"):
        T.pack_device_scene(scene)


# ---- the samplers ----------------------------------------------------------

def _sampler_inputs(kind, n=256, seed=7):
    """Texel-centre uvs of a 128-grid (exact on every power-of-two rect),
    optionally offset by integers (tiled, or negative), or NaN on a third
    of the lanes."""
    rng = np.random.default_rng(seed)
    uu = (rng.integers(0, 128, n) + 0.5) / 128
    vv = (rng.integers(0, 128, n) + 0.5) / 128
    if kind == "tiled":
        uu, vv = uu + rng.integers(0, 4, n), vv + rng.integers(0, 4, n)
    elif kind == "negative":
        uu, vv = uu + rng.integers(-3, 4, n), vv + rng.integers(-3, 4, n)
    uu, vv = uu.astype(np.float32), vv.astype(np.float32)
    if kind == "nan":
        uu[::3] = np.nan
        vv[1::3] = np.nan
    return rng, uu, vv


@pytest.mark.parametrize("mode", ["per_slot", "fat"])
@pytest.mark.parametrize("kind", ["centre", "tiled", "negative", "nan"])
def test_samplers_equal_jax(mode, kind):
    packed = T.pack_device_scene(_all_neg_uv(textured_cornell))
    jpacked = jpack(_all_neg_uv(jtextured_cornell))
    scene = load_jax_scene(packed, "cpu")
    rng, uu, vv = _sampler_inputs(kind)
    idx = rng.integers(0, packed["tri_full"].shape[0], uu.shape[0])
    row = scene["tri_full"][torch.from_numpy(idx)]
    jrow = jnp.asarray(jpacked["tri_full"][idx])

    def get(c):
        return row[:, c]

    def jget(c):
        return jrow[:, c]

    u, v = torch.from_numpy(uu), torch.from_numpy(vv)
    if mode == "fat":
        got = SHADE.sample_atlas_fat(scene["atlas_fat"],
                                     scene["atlas_fat_rects"], get, u, v)
        want = JSHADE.sample_atlas_fat(
            jnp.asarray(jpacked["atlas_fat"]),
            jnp.asarray(jpacked["atlas_fat_rects"]), jget, jnp.asarray(uu),
            jnp.asarray(vv))
    else:
        got, want = [], []
        for k in range(4):
            col = SHADE.SLOT_RECT_COLS[k]
            got.append(SHADE.sample_atlas(
                scene["atlas"], [get(col + i) for i in range(4)], u, v,
                SHADE.SLOT_FALLBACKS[k]))
            want.append(JSHADE.sample_atlas(
                jnp.asarray(jpacked["atlas"]),
                [jget(col + i) for i in range(4)], jnp.asarray(uu),
                jnp.asarray(vv), JSHADE.SLOT_FALLBACKS[k]))
    for k in range(4):
        for c in range(4):
            np.testing.assert_array_equal(got[k][c].numpy(),
                                          np.asarray(want[k][c]),
                                          err_msg=f"slot {k} channel {c}")
    if kind == "nan":
        # NaN coordinates give index 0 on every axis, never INT_MIN.
        bad = torch.tensor([np.nan, -np.inf, np.inf, -3.5, 7.9])
        assert SHADE.texel_index(bad, 8).tolist() == [0, 0, 7, 0, 7]


# ---- hit attributes --------------------------------------------------------

def _hit_lanes(tri_full: np.ndarray, n=512, seed=2):
    """Rays aimed at random interior points of random triangles."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, tri_full.shape[0], n).astype(np.int32)
    row = tri_full[idx].astype(np.float64)
    b = rng.dirichlet((1.0, 1.0, 1.0), n)
    p = (row[:, T.TF_V0:T.TF_V0 + 3] * b[:, :1]
         + row[:, T.TF_V1:T.TF_V1 + 3] * b[:, 1:2]
         + row[:, T.TF_V2:T.TF_V2 + 3] * b[:, 2:3])
    rd = rng.normal(size=(n, 3))
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    t = rng.uniform(0.5, 3.0, n)
    ro = p - rd * t[:, None]
    f32 = np.float32
    return idx, ro.T.astype(f32), rd.T.astype(f32), t.astype(f32)


HIT_FIELDS = ("position", "normal", "albedo", "alpha", "roughness",
              "metallic", "transmission", "ior", "emission",
              "emissive_strength", "uv_u", "uv_v")


def _hit_columns(hit):
    out = {}
    for name in HIT_FIELDS:
        value = getattr(hit, name)
        parts = value if isinstance(value, tuple) else (value,)
        out[name] = np.stack([np.asarray(p) for p in parts])
    return out


def _boundary_lanes(tri_full, idx, uv_u, uv_v, atlas_hw):
    """Lanes whose texel coordinate on some mapped slot lies within 1e-3 of
    an integer (the texel-boundary class)."""
    rows = tri_full[idx]
    fu, fv = np.fmod(uv_u, 1.0), np.fmod(uv_v, 1.0)
    near = np.zeros(idx.shape[0], bool)
    for col in SHADE.SLOT_RECT_COLS:
        rx, ry, rw, rh = (rows[:, col + i] for i in range(4))
        for a, lim in ((rx + fu * rw, atlas_hw[1]), (ry + fv * rh, atlas_hw[0])):
            edge = np.abs(a - np.round(a)) < 1e-3
            near |= edge & (rw > 0) & (rh > 0) & (a > 0) & (a < lim)
    return near


HIT_CASES = {"per_slot": (lambda m: m(), False),
             "fat": (lambda m: m(), True),
             "fat_256": (lambda m: m(atlas_size=256, congruent=True), True)}


@pytest.mark.parametrize("case", list(HIT_CASES))
def test_hit_attributes_textured_match_jax(case):
    """512 lanes aimed into triangles: every Hit field within rtol 1e-4 /
    atol 1e-5 (XLA:CPU's FMAs move the last ulps, amplified through the
    normal map's three normalizations) except on texel-boundary lanes,
    of which there may be at most 2. Measured: no texel-boundary lane; the
    normal differs by one ulp on 1-2 lanes, every other field bit-equal."""
    make, fat = HIT_CASES[case]
    packed = T.pack_device_scene(make(textured_cornell))
    jpacked = jpack(make(jtextured_cornell))
    slots = texture_slots_used(jpacked["tri_full"])
    scene = load_jax_scene(packed, "cpu")
    idx, ro, rd, t = _hit_lanes(packed["tri_full"])
    found = np.ones(idx.shape, bool)
    atlas = TRACE.scene_atlas(scene)[0] if fat else scene["atlas"]
    assert isinstance(atlas, tuple) == fat
    hit = SHADE.hit_attributes_from_cols(
        SHADE.fetch_rows(scene["tri_full"], torch.from_numpy(idx)),
        V3(*torch.from_numpy(ro)), V3(*torch.from_numpy(rd)),
        torch.from_numpy(t), torch.from_numpy(found), atlas=atlas,
        slots_used=slots)
    jatlas = jnp.asarray(jpacked["atlas"])
    if fat:
        jatlas = ("fat", jnp.asarray(jpacked["atlas_fat"]),
                  jnp.asarray(jpacked["atlas_fat_rects"]))
    jrow = jnp.asarray(jpacked["tri_full"][idx])
    jhit = JSHADE.hit_attributes_from_cols(
        lambda c: jrow[:, c], JVEC.V3(*jnp.asarray(ro)),
        JVEC.V3(*jnp.asarray(rd)), jnp.asarray(t), jnp.asarray(found),
        atlas=jatlas, slots_used=slots)
    got, want = _hit_columns(hit), _hit_columns(jhit)
    off = np.zeros(idx.shape, bool)
    for name in HIT_FIELDS:
        off |= ~np.isclose(got[name], want[name], rtol=1e-4,
                           atol=1e-5).all(0)
    hw = packed["atlas"].shape[:2]
    boundary = _boundary_lanes(packed["tri_full"], idx, got["uv_u"][0],
                               got["uv_v"][0], hw)
    assert not (off & ~boundary).any(), np.nonzero(off & ~boundary)
    assert off.sum() <= 2, f"{off.sum()} texel-boundary lanes"
    # The maps really engage: textured albedo differs from the base colour.
    base = packed["tri_full"][idx, T.TF_BASE_COLOR]
    assert (got["albedo"][0] != base).mean() > 0.1


@pytest.mark.parametrize("mode", ["per_slot", "fat"])
def test_slot_gating_hit_exact(mode):
    """The port's own slot gating: with every slot on, the Hit equals the
    gated one bit for bit (an unused slot's all-empty rects sample exactly
    its fallback)."""
    scene = load_jax_scene(T.pack_device_scene(textured_cornell()), "cpu")
    slots = scene["texture_slots_used"]  # worked out once, at upload
    assert slots == T.texture_slots_used(scene["tri_full"].numpy())
    assert slots == (True, True, False, True)  # the gate engages
    idx, ro, rd, t = _hit_lanes(scene["tri_full"].numpy(), seed=5)
    atlas = TRACE.scene_atlas(scene)[0] if mode == "fat" else scene["atlas"]

    def fields(slots_used):
        hit = SHADE.hit_attributes_from_cols(
            SHADE.fetch_rows(scene["tri_full"], torch.from_numpy(idx)),
            V3(*torch.from_numpy(ro)), V3(*torch.from_numpy(rd)),
            torch.from_numpy(t), torch.ones(idx.shape, dtype=torch.bool),
            atlas=atlas, slots_used=slots_used)
        return _hit_columns(hit)

    a, b = fields((True, True, True, True)), fields(slots)
    for name in HIT_FIELDS:
        np.testing.assert_array_equal(a[name].view(np.uint32),
                                      b[name].view(np.uint32), err_msg=name)


# ---- K2's plain version against the JAX Pallas bounce in interpret mode ----

BOUNCE_CASES = {
    # JAX mode: in-kernel fat canvas, in-kernel per-slot, external + fat.
    "in_kernel_fat": (lambda m: m(), "fat", "fat"),
    "in_kernel_per_slot": (_small_per_slot, False, "per_slot"),
    "external_fat": (lambda m: m(atlas_size=256, congruent=True), "ext",
                     "fat"),
}
W = H = 32  # 1024 rays: one Pallas block


def _t(x, dtype=None):
    a = np.asarray(x)
    return torch.from_numpy(a.astype(dtype) if dtype else a.copy())


@pytest.mark.parametrize("case", list(BOUNCE_CASES))
def test_bounce_matches_pallas_interpret(case):
    """Bounces 0..2 at 1,024 lanes, with the bars of
    tests/test_torch_bounce.py: state and alive on >= 99.5% of lanes,
    floats within rtol/atol 1e-4 on all but 0.2% of the agreeing lanes."""
    make, jmode, port_mode = BOUNCE_CASES[case]
    sc = make(jtextured_cornell)
    packed = jpack(sc)
    dev = jax.device_put(packed)
    slots = texture_slots_used(packed["tri_full"])
    tri_table, light_table, atlas_table, atlas_hw, fat_rects, tri_cols = (
        prepare_tables(dev, slots))
    assert atlas_hw[2] == jmode
    port = load_jax_scene(T.pack_device_scene(make(textured_cornell)), "cpu")
    atlas, port_slots = TRACE.scene_atlas(port)
    assert K2.texture_mode(atlas) == port_mode
    assert port_slots == slots

    cam = jcamera_device(JCamera(width=W, height=H).as_pytree(), W, H)
    x, y = JCAM.pixel_grid(W, H)
    ro, rd, state = JCAM.generate_rays(cam, x, y, jnp.int32(0), use_dof=True)
    n = W * H
    rays = jnp.concatenate([ro.T, rd.T], axis=0)
    state = state[None, :].astype(jnp.uint32)
    thr = jnp.ones((3, n), jnp.float32)
    res = jnp.zeros((3, n), jnp.float32)
    alive = jnp.ones((1, n), jnp.int32)
    closest_hit = jmake_closest_hit(dev, "brute", 4096, 4)

    for b in range(3):
        t, idx = closest_hit(rays[0:3], rays[3:6])
        operand = atlas_table
        if jmode == "ext":
            operand = _gather_texels(dev, idx, rays[0:3], rays[3:6], slots)
        jout = bounce_stage_pallas(
            b, rays, state, thr, res, alive, t[None, :], idx[None, :],
            tri_table, light_table, operand, fat_rects, do_mis=True,
            num_lights=sc.num_lights, atlas_hw=atlas_hw, slots_used=slots,
            interpret=True, tri_cols=tri_cols)
        pout = K2.bounce_stage_plain(
            b, _t(rays), _t(state[0], np.int64), _t(thr), _t(res),
            _t(alive[0] != 0), _t(t), _t(idx), port["tri_full"],
            port["light_full"], do_mis=True, num_lights=sc.num_lights,
            atlas=atlas, slots_used=slots)
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
        rays, state, thr, res, alive = jout[:5]
        shadow_t, _ = closest_hit(jout[5][0:3], jout[5][3:6])
        take = ((jout[7][0] != 0) & ~(shadow_t < jout[6][0])
                & (jout[9][0] > 0.0))
        res = res + jnp.where(take[None, :], jout[8], 0.0)


@pytest.mark.parametrize("mode", ["per_slot", "fat"])
def test_wrapper_runs_the_plain_version_on_cpu(mode):
    scene = load_jax_scene(T.pack_device_scene(textured_cornell()), "cpu")
    atlas = TRACE.scene_atlas(scene)[0] if mode == "fat" else scene["atlas"]
    rng = np.random.default_rng(0)
    n = 256
    rays = torch.from_numpy(np.concatenate(
        [rng.uniform(-0.5, 0.5, (3, n)) + [[0], [1], [0]],
         rng.normal(size=(3, n))]).astype(np.float32))
    t, idx = make_closest_hit(scene)(rays[0:3], rays[3:6])
    args = (0, rays, torch.from_numpy(rng.integers(0, 2**32, n)),
            torch.ones((3, n)), torch.zeros((3, n)),
            torch.ones(n, dtype=torch.bool), t, idx, scene["tri_full"],
            scene["light_full"])
    kw = dict(do_mis=True, num_lights=2, atlas=atlas,
              slots_used=(True, True, False, True))
    before = (K2.Counter.launches, dict(K2.Counter.by_mode))
    got = K2.bounce_stage(*args, **kw)
    want = K2.bounce_stage_plain(*args, **kw)
    assert (K2.Counter.launches, K2.Counter.by_mode) == before
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.uint8), w.view(torch.uint8))
    with pytest.raises(ValueError):
        K2.bounce_stage_cuda(*args, **kw)


@pytest.mark.parametrize("name", ["textured_cornell", "atlas_512_congruent",
                                  "coprime_256"])
def test_k2_bound_counts_each_texel_read_once(name):
    """chip_smoke.py's K2 bound counts the atlas bytes that a bounce's hit
    lanes read: each distinct texel (16 B) or fat-canvas row (64 B) once,
    for the slots the scene uses, and the fat match table. Held against
    the samplers themselves, given a table whose texels hold their own
    flat index (plus 10, clear of the fallbacks' 0.5 and 1)."""
    make, mode = RENDER_SCENES[name]
    scene = load_jax_scene(T.pack_device_scene(make()), "cpu")
    atlas, slots = TRACE.scene_atlas(scene)
    assert K2.texture_mode(atlas) == mode
    w = 32
    camera = Camera(width=w, height=w, aspect=1.0)
    x, y = CAM.pixel_grid(w, w)
    ro, rd, state = CAM.generate_rays(camera_device(camera.as_pytree(), w, w),
                                      x, y, 0, use_dof=True)
    n = w * w
    t, idx = make_closest_hit(scene)(ro, rd)
    alive = torch.ones(n, dtype=torch.bool)
    alive[::7] = False  # a dead lane reads nothing
    args = (0, torch.cat([ro, rd]), state, torch.ones((3, n)),
            torch.zeros((3, n)), alive, t, idx, scene["tri_full"],
            scene["light_full"])
    found = alive & (idx >= 0)
    get = SHADE.fetch_rows(scene["tri_full"], torch.clamp_min(idx, 0))
    *_, uv_u, uv_v = SHADE.barycentrics_from_cols(get, V3(*ro), V3(*rd))
    table = atlas[1] if mode == "fat" else atlas
    numbered = torch.zeros_like(table)
    numbered[..., 0::4] = (torch.arange(table.shape[0] * table.shape[1])
                           .reshape(table.shape[:2] + (1,)) + 10.0)
    if mode == "fat":
        values = [q[0] for q in SHADE.sample_atlas_fat(numbered, atlas[2], get,
                                                       uv_u, uv_v)]
    else:
        values = [SHADE.sample_atlas(
            numbered, [get(SHADE.SLOT_RECT_COLS[k] + i) for i in range(4)],
            uv_u, uv_v, SHADE.SLOT_FALLBACKS[k])[0] for k in range(4)]
    read = torch.cat([v[found] for k, v in enumerate(values) if slots[k]])
    read = read[read >= 10.0].unique().numel()
    assert read > 0
    want = (read * 64 + atlas[2].numel() * 4 if mode == "fat"
            else read * 16)
    assert atlas_bytes(args, atlas, slots) == want
    assert want < table.numel() * 4 + (atlas[2].numel() * 4
                                       if mode == "fat" else 0)


# ---- the whole slice -------------------------------------------------------

ORACLE_SIZE = 24


@pytest.mark.parametrize("mode", ["per_slot", "fat"])
def test_textured_trace_matches_oracle(mode):
    """All 576 pixels of frame 1 of ``textured_cornell()`` at 1 spp against
    the scalar oracle, which samples per slot: no RNG-state mismatch and at
    most one radiance outlier (rtol/atol 2e-3). Measured: 0 and 0 in both
    forms, on frames 0 and 1."""
    w = ORACLE_SIZE
    scene_np = textured_cornell()
    camera = Camera(width=w, height=w, aspect=1.0)
    oracle = Oracle(scene_np, camera.as_pytree(), w, w)
    scene = load_jax_scene(T.pack_device_scene(scene_np), "cpu")
    if mode == "per_slot":
        for key in T.FAT_KEYS:
            del scene[key]
    assert K2.texture_mode(TRACE.scene_atlas(scene)[0]) == mode
    x, y = CAM.pixel_grid(w, w)
    ro, rd, state = CAM.generate_rays(camera_device(camera.as_pytree(), w, w),
                                      x, y, 1, use_dof=True)
    radiance, end_state, _ = TRACE.trace(
        scene, make_closest_hit(scene), ro, rd, state, max_bounces=8,
        do_mis=True, num_lights=scene_np.num_lights)
    radiance, end_state = radiance.T.numpy(), end_state.numpy()
    states = values = 0
    for py in range(w):
        for px in range(w):
            lane = py * w + px
            expected = oracle.render_pixel(px, py, 1)
            if int(end_state[lane]) != int(oracle.rng.state):
                states += 1
            elif not np.allclose(np.minimum(radiance[lane], 2.5), expected,
                                 rtol=2e-3, atol=2e-3):
                values += 1
    assert states == 0, f"{states} RNG schedules diverged"
    assert values <= 1, f"{values} radiances diverged"


RENDER_SCENES = {
    "textured_cornell": (lambda: textured_cornell(), "fat"),
    "atlas_512_congruent": (
        lambda: textured_cornell(atlas_size=512, congruent=True), "fat"),
    "coprime_256": (lambda: _coprime(textured_cornell), "per_slot"),
    "untextured": (cornell_box, "none"),
}


@pytest.mark.parametrize("name", list(RENDER_SCENES))
def test_renderer_renders_textured_scenes(name):
    make, mode = RENDER_SCENES[name]
    r = Renderer(RenderConfig(width=16, height=16), device="cpu")
    assert r.stats()["texture"] is None  # no scene yet
    r.load_scene(make())
    assert r.stats()["texture"] == mode
    before = (K2.Counter.launches, dict(K2.Counter.by_mode))
    img = r.render(spp=1)
    assert (K2.Counter.launches, K2.Counter.by_mode) == before
    assert img.shape == (16, 16, 3) and np.isfinite(img).all()
    assert img.max() > 0
    np.testing.assert_array_equal(img.view(np.uint32),
                                  plain_render(r, spp=1).view(np.uint32))


def test_textured_renderer_matches_jax_renderer():
    """The port's Renderer against the JAX Renderer on ``textured_cornell()``
    at 24x24, 2 spp, with the golden test's bars: >= 99% of pixels within
    5e-4 of the JAX image or, where not, of the scalar oracle's mean, at
    most 5 off both, the means within 1e-3."""
    r = Renderer(RenderConfig(width=24, height=24), device="cpu")
    r.load_scene(textured_cornell())
    buf = r.render(spp=2)
    j = JRenderer(JRenderConfig(width=24, height=24, frames_per_chunk=2))
    j.load_scene(jtextured_cornell())
    ref = j.render(spp=2)
    close = np.isclose(buf, ref, rtol=5e-4, atol=5e-4).all(-1)
    oracle = Oracle(textured_cornell(), r.camera.as_pytree(), 24, 24)
    ys, xs = np.nonzero(~close)
    off_both = [(px, py) for px, py in zip(xs, ys)
                if not np.allclose(buf[py, px], _oracle_mean(oracle, px, py, 2),
                                   rtol=2e-3, atol=2e-3)]
    report = (f"{len(xs)} of {close.size} pixels outside 5e-4 of the JAX "
              f"render, {len(off_both)} of them off the oracle too: {off_both}")
    assert close.size - len(off_both) >= 0.99 * close.size, report
    assert len(off_both) <= 5, report
    assert abs(buf.mean() / ref.mean() - 1.0) < 1e-3


def test_textured_scene_through_the_walk():
    """A textured scene above ``brute_force_max_tris`` takes the walk and
    samples its atlas there: its image equals the dense hit's."""
    walk = Renderer(RenderConfig(width=16, height=16, brute_force_max_tris=16),
                    device="cpu")
    walk.load_scene(textured_cornell())
    assert walk.stats()["intersector"] == "walk"
    assert walk.stats()["texture"] == "fat"
    dense = Renderer(RenderConfig(width=16, height=16), device="cpu")
    dense.load_scene(textured_cornell())
    assert dense.stats()["intersector"] == "brute"
    np.testing.assert_array_equal(walk.render(spp=2).view(np.uint32),
                                  dense.render(spp=2).view(np.uint32))
