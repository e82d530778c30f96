"""Scene data structures (host NumPy) and their upload to torch tensors.

A copy of the JAX package's ``models/types.py`` restricted to what the
port renders: the column maps, ``SceneArrays``, ``texture_slots_used``, the
fat-atlas bake and ``pack_device_scene`` for the ``tri_isect``,
``tri_full``, ``light_full``, ``atlas``, ``atlas_fat``, ``atlas_fat_rects``,
``bvh_aabb`` and wide-BVH walk tables. The NumPy code is kept identical so
the packed tables are bit-equal to the reference's.

Host side, the scene is plain-NumPy SoA (``SceneArrays``), mirroring the CPU
structs of the reference (gpu.ts:10-65 — TriangleCPU / MaterialCPU /
LightCPU / SceneData) but columnar rather than array-of-objects.

Device side (``DeviceScene``), arrays are packed into a handful of wide f32
tables so each hot-loop gather fetches one row:

* ``tri_isect``  (T, 9)  = [v0, e1, e2]           — intersection only
  (edges precomputed; pt.wgsl:128-129 derives them per test)
* ``tri_shade``  (T, 28) = [v0,v1,v2,n0,n1,n2,uv0,uv1,uv2,mat] — fetched once
  per bounce for the winning triangle (pt.wgsl:28-39 Triangle layout)
* ``materials``  (M, 26) = [baseColor(3), metallic, roughness, emission(3),
  emissiveStrength, ior, transmission, albedoRect(4), normalRect(4),
  pbrRect(4), emissiveRect(4)]                    — pt.wgsl:14-26 Material
* ``lights``     (L, 9)  = [position(3), type, color(3), intensity, triIndex]
  — pt.wgsl:45-51 Light (directional stores direction in position,
  gpu.ts:212)
* ``bvh_aabb``   (B, 6) f32 and ``bvh_meta`` (B, 4) i32 = [left, right,
  triangleOffset, triangleCount]                  — pt.wgsl:67-78 BVHNode
* ``walk_order`` (Nn, 64) i32, ``walk_boxes`` (Nn*64, 8) f32 and
  ``walk_tris`` (Ng*32, 128) f32 — the wide-BVH tables of the BVH walk
  (``accel/bvh8.py``, ``ops/walk.py``)
* ``atlas``      (Ah, Aw, 4) f32 — rgba16float atlas texture equivalent
  (renderer.ts:246-253); rects are in pixels (atlas.ts:25-30)
* ``atlas_fat``  (FH, FW, 16) f32 and ``atlas_fat_rects`` (S, 20) f32 — the
  fat canvas (one 16-channel texel row serves all four texture slots) and
  its map-set match table; present only when ``_build_fat_atlas`` bakes
  them

Atlas rect coordinates are stored as f32 inside the material rows (pixel
coordinates are exactly representable), so one material gather fetches
everything.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np

from wgpu_path_tracing_tpu_torch.accel import bvh8

LIGHT_TYPE_EMISSIVE = 0  # pt.wgsl:41
LIGHT_TYPE_DIRECTIONAL = 1  # pt.wgsl:42
LIGHT_TYPE_POINT = 2  # pt.wgsl:43
# Extension: KHR_lights_punctual "spot". The reference warns-and-skips spots
# (gpu.ts:234-236); this framework renders them when the loader is invoked
# with enable_spot_lights=True (default keeps parity: warn + skip).
LIGHT_TYPE_SPOT = 3

# Column offsets within the packed material row (DeviceScene.materials).
MAT_BASE_COLOR = 0  # 3
MAT_METALLIC = 3
MAT_ROUGHNESS = 4
MAT_EMISSION = 5  # 3
MAT_EMISSIVE_STRENGTH = 8
MAT_IOR = 9
MAT_TRANSMISSION = 10
MAT_ALBEDO_RECT = 11  # 4: x, y, w, h (pixels)
MAT_NORMAL_RECT = 15  # 4
MAT_PBR_RECT = 19  # 4
MAT_EMISSIVE_RECT = 23  # 4
MAT_COLS = 27

# Column offsets within the packed triangle shade row (DeviceScene.tri_shade).
TRI_V0 = 0  # 3
TRI_V1 = 3  # 3
TRI_V2 = 6  # 3
TRI_N0 = 9  # 3
TRI_N1 = 12  # 3
TRI_N2 = 15  # 3
TRI_UV0 = 18  # 2
TRI_UV1 = 20  # 2
TRI_UV2 = 22  # 2
TRI_MAT = 24
TRI_COLS = 25

# Column offsets within the packed light row (DeviceScene.lights).
LGT_POSITION = 0  # 3
LGT_TYPE = 3
LGT_COLOR = 4  # 3
LGT_INTENSITY = 7
LGT_TRI = 8
LGT_COLS = 9

# DeviceScene.tri_full — triangle row with its material DENORMALIZED in, so
# one row fetch per bounce yields every shading attribute (the reference
# instead chases Triangle.materialIndex -> materials[] per hit,
# pt.wgsl:199-213; joining host-side turns two dynamic lookups into one).
TF_V0 = 0  # 3
TF_V1 = 3  # 3
TF_V2 = 6  # 3
TF_N0 = 9  # 3
TF_N1 = 12  # 3
TF_N2 = 15  # 3
TF_UV0 = 18  # 2
TF_UV1 = 20  # 2
TF_UV2 = 22  # 2
TF_MAT = 24
TF_BASE_COLOR = 25  # 3
TF_METALLIC = 28
TF_ROUGHNESS = 29
TF_EMISSION = 30  # 3
TF_EMISSIVE_STRENGTH = 33
TF_IOR = 34
TF_TRANSMISSION = 35
TF_ALBEDO_RECT = 36  # 4
TF_NORMAL_RECT = 40  # 4
TF_PBR_RECT = 44  # 4
TF_EMISSIVE_RECT = 48  # 4
TF_COLS = 52

# DeviceScene.light_full — light row with its emissive triangle's geometry
# denormalized in (sampleLight fetches triangles[light.triangleIndex],
# pt.wgsl:441-454; joining host-side removes that dynamic lookup).
LF_POSITION = 0  # 3
LF_TYPE = 3
LF_COLOR = 4  # 3
LF_INTENSITY = 7
LF_TRI = 8
LF_V0 = 9  # 3
LF_V1 = 12  # 3
LF_V2 = 15  # 3
LF_N0 = 18  # 3
LF_N1 = 21  # 3
LF_N2 = 24  # 3
LF_COLS = 27
# Spot lights carry no emissive triangle, so their rows reuse the triangle
# columns: LF_V0 slot holds the world-space spot direction and LF_V1/+1 the
# precomputed angular-attenuation scale/offset (glTF KHR_lights_punctual:
# scale = 1/max(1e-3, cos(inner) - cos(outer)), offset = -cos(outer)*scale).
LF_SPOT_DIR = LF_V0  # 3
LF_SPOT_SCALE = LF_V1
LF_SPOT_OFFSET = LF_V1 + 1


@dataclasses.dataclass
class SceneArrays:
    """Host-side columnar scene (all NumPy).

    Triangle order is the BVH-sorted order (buildBVH reorders triangles in
    place — bvh.ts:53-157, and emissive lights are extracted AFTER the
    reorder so light.triangleIndex refers to sorted positions, gpu.ts:119-138).
    """

    # Triangles (T, ...)
    tri_v0: np.ndarray
    tri_v1: np.ndarray
    tri_v2: np.ndarray
    tri_n0: np.ndarray
    tri_n1: np.ndarray
    tri_n2: np.ndarray
    tri_uv0: np.ndarray
    tri_uv1: np.ndarray
    tri_uv2: np.ndarray
    tri_mat: np.ndarray  # (T,) int32

    # Materials (M, ...)
    mat_base_color: np.ndarray  # (M, 3)
    mat_metallic: np.ndarray  # (M,)
    mat_roughness: np.ndarray
    mat_emission: np.ndarray  # (M, 3)
    mat_emissive_strength: np.ndarray
    mat_ior: np.ndarray
    mat_transmission: np.ndarray
    mat_albedo_rect: np.ndarray  # (M, 4) int32 pixels
    mat_normal_rect: np.ndarray
    mat_pbr_rect: np.ndarray
    mat_emissive_rect: np.ndarray

    # Lights (L, ...)
    light_position: np.ndarray  # (L, 3)
    light_type: np.ndarray  # (L,) int32
    light_color: np.ndarray  # (L, 3)
    light_intensity: np.ndarray  # (L,)
    light_tri: np.ndarray  # (L,) int32

    # BVH (B, ...)
    bvh_aabb_min: np.ndarray  # (B, 3)
    bvh_aabb_max: np.ndarray  # (B, 3)
    bvh_meta: np.ndarray  # (B, 4) int32: left, right, offset, count

    # Texture atlas (Ah, Aw, 4) float32, or None if the scene is untextured.
    atlas: np.ndarray | None = None

    # Spot-light extension (None when no spots): (L, 5) float32 rows of
    # [dir_x, dir_y, dir_z, angle_scale, angle_offset]; meaningful only on
    # rows whose light_type == LIGHT_TYPE_SPOT.
    light_aux: np.ndarray | None = None

    @property
    def num_triangles(self) -> int:
        return int(self.tri_v0.shape[0])

    @property
    def num_materials(self) -> int:
        return int(self.mat_base_color.shape[0])

    @property
    def num_lights(self) -> int:
        return int(self.light_position.shape[0])

    def validate(self) -> "SceneArrays":
        t, m = self.num_triangles, self.num_materials
        assert self.tri_mat.shape == (t,)
        assert t == 0 or (self.tri_mat.min() >= 0 and self.tri_mat.max() < m)
        for rect in (
            self.mat_albedo_rect,
            self.mat_normal_rect,
            self.mat_pbr_rect,
            self.mat_emissive_rect,
        ):
            assert rect.shape == (m, 4)
        lt = self.light_tri
        assert lt.shape == (self.num_lights,)
        assert self.bvh_meta.shape[1] == 4
        return self


def texture_slots_used(tri_full) -> tuple[bool, bool, bool, bool]:
    """Static per-scene texture-slot usage: (albedo, pbr, emissive, normal).

    A slot is used iff ANY triangle's atlas rect has nonzero width. A
    zero-width rect samples its fallback exactly (pt.wgsl:112-120 via the
    ``missing`` guard in ops/shade.py), so statically skipping the fetch
    for a scene-wide-unused slot is exact at the Hit level — it just saves
    the one-hot select + column sweep in the Pallas bounce (and the gather
    in the XLA path). (Full-trace radiance can still move by ulps: fewer
    ops shift XLA fusion/FMA placement, the documented RR-flip class —
    tests/test_textures.py checks the contract where it is exact.) Must be
    called on the HOST-side packed table (NumPy), not a tracer."""
    tf = np.asarray(tri_full)

    def used(base: int) -> bool:
        return bool((tf[:, base + 2] > 0).any())

    return (
        used(TF_ALBEDO_RECT),
        used(TF_PBR_RECT),
        used(TF_EMISSIVE_RECT),
        used(TF_NORMAL_RECT),
    )


# Fat-atlas canvas budget: sum of packed LCM grids, in texels (one texel
# = 16 f32 = 64 B, so 4M texels = 256 MB). Map sets with wildly coprime
# slot dims (e.g. 255 vs 256 -> 65280-wide LCM grid) blow this and fall
# back to the per-slot sampling.
FAT_ATLAS_MAX_TEXELS = 4 << 20
# Bound on the number of baked map sets (the match table's rows).
FAT_ATLAS_MAX_SETS = 256

# The JAX package's TPU bounce-kernel budgets (its ops/pallas_bounce.py:
# 60-79), copied as plain data. They decide WHETHER the JAX package bakes a
# fat canvas for a small atlas, and the port bakes exactly when it does, so
# both packages pick the same texels (texel choice feeds Russian roulette,
# so a different choice would split RNG streams). They say nothing about
# what the card needs: there a texel is one direct load in either mode.
UNTILED_ATLAS_TEXELS = 128 * 128
FAT_VMEM_TEXELS = 128 * 64
FAT_KERNEL_MAX_SETS = 8


def _build_fat_atlas(scene: "SceneArrays", atlas: np.ndarray):
    """Pre-bake the fat-atlas canvas (the JAX package's
    ``models/types.py::_build_fat_atlas``, same NumPy code).

    Every distinct material MAP SET (its 4-slot rect tuple) gets a VIRTUAL
    rect on a standalone canvas whose grid is the componentwise LCM of the
    mapped slots' dims, each texel row carrying all four slots' texels at
    the same uv, so one row load serves every slot. Unmapped slots hold
    the slot fallback constant (``ops/shade.py::SLOT_FALLBACKS``).

    The LCM grid reproduces the per-slot texel choice for every slot: slot
    k with kw | lw bakes nearest-downsampled onto the grid, and for uv
    fraction f the grid cell i = floor(f*lw) satisfies
    floor(f*kw) == i // (lw//kw) (integer floor identity), except the
    texel-boundary ulp class (floor(kx + f*kw) and floor(fx + f*lw) can
    round across an integer on boundary-epsilon uvs). A map set whose
    triangles carry a negative vertex uv on an axis gets a DOUBLED grid on
    that axis (interior origin at +lw/+lh) whose backward band holds the
    texels the sign-preserving %-wrap reads for f in (-1, 0).

    Returns (canvas (FH, FW, 16) f32, rects (S, 20) f32) — rects rows are
    [16 atlas-rect values in SLOT_RECT_COLS order | fx, fy, lw, lh] — or
    None (per-slot sampling) unless all rects are in bounds, the canvas
    and set-count budgets hold, and, for a small atlas (within
    UNTILED_ATLAS_TEXELS), the canvas and set count also fit
    FAT_VMEM_TEXELS and FAT_KERNEL_MAX_SETS.
    """
    import math

    h, w = int(atlas.shape[0]), int(atlas.shape[1])
    if scene.num_triangles == 0:
        return None
    rect_tables = (scene.mat_albedo_rect, scene.mat_pbr_rect,
                   scene.mat_emissive_rect, scene.mat_normal_rect)
    mats = np.unique(np.asarray(scene.tri_mat, np.int64))
    # One entry per DISTINCT map set: materials sharing all four rects
    # share texels, hence one virtual rect.
    sets: dict = {}
    mat_set_key: dict = {}
    for m in mats:
        rs = tuple(tuple(int(v) for v in tab[m]) for tab in rect_tables)
        nonempty = [r for r in rs if r[2] > 0 and r[3] > 0]
        if not nonempty:
            continue
        mat_set_key[int(m)] = rs
        for (rx, ry, rw, rh) in nonempty:
            if rx < 0 or ry < 0 or rx + rw > w or ry + rh > h:
                return None
        if rs not in sets:
            lw = math.lcm(*(r[2] for r in nonempty))
            lh = math.lcm(*(r[3] for r in nonempty))
            sets[rs] = {"w": lw, "h": lh, "x": 0, "y": 0,
                        "lw": lw, "lh": lh, "ox": 0, "oy": 0}
    if not sets:
        return None
    if len(sets) > FAT_ATLAS_MAX_SETS:
        return None
    # Per-set negative-uv flags (per axis): a negative VERTEX uv on any
    # triangle of the set's materials doubles the set's grid on that axis
    # and shifts the interior origin (fmod keeps runtime f in (-1, 1), so
    # one backward band always suffices).
    tri_mat_arr = np.asarray(scene.tri_mat)
    uvs = (np.asarray(scene.tri_uv0), np.asarray(scene.tri_uv1),
           np.asarray(scene.tri_uv2))
    for m, rs in mat_set_key.items():
        tris = tri_mat_arr == m
        if not tris.any():
            continue
        box = sets[rs]
        for uv in uvs:
            sel = uv[tris]
            if (sel[:, 0] < 0.0).any() and not box["ox"]:
                box["ox"] = box["lw"]
                box["w"] = 2 * box["lw"]
            if (sel[:, 1] < 0.0).any() and not box["oy"]:
                box["oy"] = box["lh"]
                box["h"] = 2 * box["lh"]
    # Pack the (possibly extended) grids onto one canvas (the packer the
    # texture atlas itself uses; mutates x/y in place).
    from wgpu_path_tracing_tpu_torch.models.potpack import potpack

    boxes = list(sets.values())
    fw, fh = potpack(boxes)
    if fw * fh > FAT_ATLAS_MAX_TEXELS:
        return None
    if h * w <= UNTILED_ATLAS_TEXELS and (
        fw * fh > FAT_VMEM_TEXELS or len(sets) > FAT_KERNEL_MAX_SETS
    ):
        # Small atlas whose fat form the JAX package's in-kernel sampler
        # cannot take: it bakes nothing and samples per slot, so the port
        # does the same.
        return None
    from wgpu_path_tracing_tpu_torch.ops.shade import SLOT_FALLBACKS

    fat = np.empty((fh, fw, 16), np.float32)
    fat[:] = np.array([c for fb in SLOT_FALLBACKS for c in fb], np.float32)
    rect_rows = np.zeros((len(sets), 20), np.float32)
    for s, (rs, box) in enumerate(sets.items()):
        lw, lh, ox, oy = box["lw"], box["lh"], box["ox"], box["oy"]
        # Interior origin: the [0, 1) uv band starts ox/oy cells into the
        # allocated box; the backward band (negative uvs) occupies
        # [-ox, 0) x [-oy, 0) relative cells.
        fx, fy = box["x"] + ox, box["y"] + oy
        rect_rows[s, :16] = [v for r in rs for v in r]
        rect_rows[s, 16:] = (fx, fy, lw, lh)
        for k, (kx, ky, kw, kh) in enumerate(rs):
            if kw > 0 and kh > 0:
                # Grid cell j (relative to the interior origin, j in
                # [-ox, lw)) carries the per-slot texel the reference's
                # index math reads for uv fraction f = j/lw:
                # clip(kx + j // (lw//kw), 0, w-1).
                jj = np.arange(-ox, lw)
                ii = np.arange(-oy, lh)
                ix = np.clip(kx + jj // (lw // kw), 0, w - 1)
                iy = np.clip(ky + ii // (lh // kh), 0, h - 1)
                fat[fy - oy:fy + lh, fx - ox:fx + lw, 4 * k:4 * k + 4] = (
                    atlas[np.ix_(iy, ix)]
                )
    return fat, rect_rows


def check_bf16_exact(atlas: np.ndarray) -> None:
    """Raise unless every atlas texel is a bfloat16-representable float32
    (its low 16 bits are zero), the invariant the JAX package asserts at
    packing time: scenes are built through ``models/assemble.py::
    finalize_scene``, which rounds the atlas with ``quantize_atlas``."""
    bits = np.ascontiguousarray(np.asarray(atlas, np.float32)).view(np.uint32)
    if (bits & 0xFFFF).any():
        raise ValueError(
            "pack_device_scene: atlas texels are not bf16-exact — build "
            "scenes through models/assemble.py::finalize_scene (which "
            "quantizes the atlas) or pre-quantize before packing")


def pack_device_scene(scene: SceneArrays, cluster_k: int = 64):
    """Build the packed device tables as NumPy arrays.

    Returns a dict with tri_isect, tri_full, light_full, atlas, the binary
    BVH's bvh_aabb, bvh_meta and bvh_links (``accel/bvh.py::build_links``:
    the hit and miss links of the linked walk, -1 filled), the dispatch intersectors' tables cluster_tris and cluster_aabb
    (``ops/cluster.py::build_clusters``, ``cluster_k`` triangles a cluster)
    and pairs_tris and pairs_super_aabb (``ops/pairs.py::
    build_pair_tables``), the walk tables walk_order, walk_boxes and
    walk_tris, and the fat-atlas tables atlas_fat and atlas_fat_rects. The
    walk tables are omitted when the wide tree is too deep for the walk's
    stack bound (``accel/bvh8.py::WideBVHDepthError``; the pair dispatch
    then takes the scene), and the fat tables unless ``_build_fat_atlas``
    bakes them, both exactly as in the JAX package. Raises ValueError for an
    atlas that is not bf16-exact.
    """
    from wgpu_path_tracing_tpu_torch.accel.bvh import build_links
    from wgpu_path_tracing_tpu_torch.ops.cluster import build_clusters
    from wgpu_path_tracing_tpu_torch.ops.pairs import build_pair_tables

    t = scene.num_triangles
    tri_isect = np.zeros((max(t, 1), 9), np.float32)
    tri_shade = np.zeros((max(t, 1), TRI_COLS), np.float32)
    if t:
        tri_isect[:t, 0:3] = scene.tri_v0
        tri_isect[:t, 3:6] = scene.tri_v1 - scene.tri_v0  # e1
        tri_isect[:t, 6:9] = scene.tri_v2 - scene.tri_v0  # e2
        tri_shade[:t, TRI_V0 : TRI_V0 + 3] = scene.tri_v0
        tri_shade[:t, TRI_V1 : TRI_V1 + 3] = scene.tri_v1
        tri_shade[:t, TRI_V2 : TRI_V2 + 3] = scene.tri_v2
        tri_shade[:t, TRI_N0 : TRI_N0 + 3] = scene.tri_n0
        tri_shade[:t, TRI_N1 : TRI_N1 + 3] = scene.tri_n1
        tri_shade[:t, TRI_N2 : TRI_N2 + 3] = scene.tri_n2
        tri_shade[:t, TRI_UV0 : TRI_UV0 + 2] = scene.tri_uv0
        tri_shade[:t, TRI_UV1 : TRI_UV1 + 2] = scene.tri_uv1
        tri_shade[:t, TRI_UV2 : TRI_UV2 + 2] = scene.tri_uv2
        tri_shade[:t, TRI_MAT] = scene.tri_mat.astype(np.float32)

    m = scene.num_materials
    materials = np.zeros((max(m, 1), MAT_COLS), np.float32)
    if m:
        materials[:m, MAT_BASE_COLOR : MAT_BASE_COLOR + 3] = scene.mat_base_color
        materials[:m, MAT_METALLIC] = scene.mat_metallic
        materials[:m, MAT_ROUGHNESS] = scene.mat_roughness
        materials[:m, MAT_EMISSION : MAT_EMISSION + 3] = scene.mat_emission
        materials[:m, MAT_EMISSIVE_STRENGTH] = scene.mat_emissive_strength
        materials[:m, MAT_IOR] = scene.mat_ior
        materials[:m, MAT_TRANSMISSION] = scene.mat_transmission
        materials[:m, MAT_ALBEDO_RECT : MAT_ALBEDO_RECT + 4] = scene.mat_albedo_rect
        materials[:m, MAT_NORMAL_RECT : MAT_NORMAL_RECT + 4] = scene.mat_normal_rect
        materials[:m, MAT_PBR_RECT : MAT_PBR_RECT + 4] = scene.mat_pbr_rect
        materials[:m, MAT_EMISSIVE_RECT : MAT_EMISSIVE_RECT + 4] = (
            scene.mat_emissive_rect
        )

    n_lights = scene.num_lights
    lights = np.zeros((max(n_lights, 1), LGT_COLS), np.float32)
    if n_lights:
        lights[:n_lights, LGT_POSITION : LGT_POSITION + 3] = scene.light_position
        lights[:n_lights, LGT_TYPE] = scene.light_type.astype(np.float32)
        lights[:n_lights, LGT_COLOR : LGT_COLOR + 3] = scene.light_color
        lights[:n_lights, LGT_INTENSITY] = scene.light_intensity
        lights[:n_lights, LGT_TRI] = scene.light_tri.astype(np.float32)

    b = scene.bvh_meta.shape[0]
    bvh_aabb = np.zeros((max(b, 1), 6), np.float32)
    bvh_meta = np.zeros((max(b, 1), 4), np.int32)
    bvh_links = np.full((max(b, 1), 2), -1, np.int32)
    if b:
        bvh_aabb[:b, 0:3] = scene.bvh_aabb_min
        bvh_aabb[:b, 3:6] = scene.bvh_aabb_max
        bvh_meta[:b] = scene.bvh_meta.astype(np.int32)
        bvh_links[:b] = build_links(bvh_meta[:b])

    atlas = scene.atlas
    if atlas is None:
        atlas = np.zeros((1, 1, 4), np.float32)

    # Denormalized join tables (see TF_* / LF_* column maps above).
    tri_full = np.zeros((max(t, 1), TF_COLS), np.float32)
    tri_full[:, :TRI_COLS] = tri_shade
    if t:
        mat_of_tri = scene.tri_mat.astype(np.int32)
        tri_full[:t, TF_BASE_COLOR:] = materials[mat_of_tri]

    n_l = max(n_lights, 1)
    light_full = np.zeros((n_l, LF_COLS), np.float32)
    light_full[:, :LGT_COLS] = lights
    if n_lights and t:
        ltri = np.clip(scene.light_tri.astype(np.int32), 0, t - 1)
        light_full[:n_lights, LF_V0 : LF_V0 + 3] = tri_shade[ltri, TRI_V0 : TRI_V0 + 3]
        light_full[:n_lights, LF_V1 : LF_V1 + 3] = tri_shade[ltri, TRI_V1 : TRI_V1 + 3]
        light_full[:n_lights, LF_V2 : LF_V2 + 3] = tri_shade[ltri, TRI_V2 : TRI_V2 + 3]
        light_full[:n_lights, LF_N0 : LF_N0 + 3] = tri_shade[ltri, TRI_N0 : TRI_N0 + 3]
        light_full[:n_lights, LF_N1 : LF_N1 + 3] = tri_shade[ltri, TRI_N1 : TRI_N1 + 3]
        light_full[:n_lights, LF_N2 : LF_N2 + 3] = tri_shade[ltri, TRI_N2 : TRI_N2 + 3]
    if n_lights and scene.light_aux is not None:
        spot = scene.light_type == LIGHT_TYPE_SPOT
        if spot.any():
            aux = np.asarray(scene.light_aux, np.float32)
            light_full[:n_lights][spot, LF_SPOT_DIR : LF_SPOT_DIR + 3] = aux[spot, 0:3]
            light_full[:n_lights][spot, LF_SPOT_SCALE] = aux[spot, 3]
            light_full[:n_lights][spot, LF_SPOT_OFFSET] = aux[spot, 4]

    # Cluster tables for the dispatch intersectors: the pair dispatch
    # (subtree clusters grouped into super tiles) and the round dispatch
    # (a fixed-stride cut).
    cluster_tris, cluster_aabb = build_clusters(tri_isect, k=cluster_k)
    pairs_tris, pairs_super_aabb = build_pair_tables(
        bvh_aabb[:max(b, 1)], bvh_meta[:max(b, 1)], tri_isect[:t])

    # Wide-BVH tables for the BVH walk (ops/walk.py). A pathologically deep
    # tree omits them, and the pair dispatch then takes the scene.
    try:
        wide = bvh8.build_wide_bvh(
            scene.bvh_aabb_min if b else np.zeros((1, 3), np.float32),
            scene.bvh_aabb_max if b else np.zeros((1, 3), np.float32),
            bvh_meta[:b] if b else np.zeros((1, 4), np.int32),
            tri_isect[:t],
        )
    except bvh8.WideBVHDepthError as e:
        warnings.warn(f"walk tables skipped: {e}", stacklevel=2)
        wide = None

    check_bf16_exact(atlas)
    fat_atlas = _build_fat_atlas(scene, np.asarray(atlas, np.float32))

    return {
        "tri_isect": tri_isect,
        "tri_full": tri_full,
        "light_full": light_full,
        "atlas": np.asarray(atlas, np.float32),
        "bvh_aabb": bvh_aabb,
        "bvh_meta": bvh_meta,
        "bvh_links": bvh_links,
        "cluster_tris": cluster_tris,
        "cluster_aabb": cluster_aabb,
        "pairs_tris": pairs_tris,
        "pairs_super_aabb": pairs_super_aabb,
        **(
            {
                "walk_order": wide.order,
                "walk_boxes": wide.boxes,
                "walk_tris": wide.tris,
            }
            if wide is not None
            else {}
        ),
        **(
            {"atlas_fat": fat_atlas[0], "atlas_fat_rects": fat_atlas[1]}
            if fat_atlas is not None
            else {}
        ),
    }


# The walk tables; a packed scene holds all three or none. The same for the
# fat-atlas tables.
WALK_KEYS = ("walk_order", "walk_boxes", "walk_tris")
FAT_KEYS = ("atlas_fat", "atlas_fat_rects")
OPTIONAL_KEYS = WALK_KEYS + FAT_KEYS
# The tables the torch path reads, in the layout both packages share, and
# the dtype each is uploaded as.
DEVICE_KEYS = {
    "tri_isect": np.float32,
    "tri_full": np.float32,
    "light_full": np.float32,
    "atlas": np.float32,
    "cluster_tris": np.float32,
    "cluster_aabb": np.float32,
    "pairs_tris": np.float32,
    "pairs_super_aabb": np.float32,
    "bvh_aabb": np.float32,
    "bvh_meta": np.int32,
    "bvh_links": np.int32,
    "walk_order": np.int32,
    "walk_boxes": np.float32,
    "walk_tris": np.float32,
    "atlas_fat": np.float32,
    "atlas_fat_rects": np.float32,
}


def load_jax_scene(packed: dict, device) -> dict:
    """Upload a packed scene (``pack_device_scene`` output of either package,
    as NumPy arrays) to contiguous tensors on ``device``, each in its
    ``DEVICE_KEYS`` dtype (``walk_order``, ``bvh_meta`` and ``bvh_links``
    stay int32), and beside them
    ``"texture_slots_used"``, the scene's ``texture_slots_used`` tuple,
    worked out once here from the host-side table, and ``"root_box"``, row 0
    of ``bvh_aabb`` (the scene's root box [min3 | max3], which the walk's ray
    reorder quantises origins over, ``ops/intersect.py::bucket_keys``).

    Only the keys in ``DEVICE_KEYS`` are read, and the walk and fat-atlas
    tables only where the scene has them; the JAX package's extra tables
    (materials, lights, env) are ignored. Raises if CUDA is asked for and
    absent: there is no silent CPU fallback.
    """
    import torch

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but CUDA is not available")
    out = {}
    for key, dtype in DEVICE_KEYS.items():
        if key in OPTIONAL_KEYS and key not in packed:
            continue
        arr = np.ascontiguousarray(np.asarray(packed[key], dtype))
        out[key] = torch.from_numpy(arr).to(device)
    out["texture_slots_used"] = texture_slots_used(packed["tri_full"])
    out["root_box"] = torch.from_numpy(np.ascontiguousarray(
        packed["bvh_aabb"][0, 0:6], np.float32)).to(device)
    return out
