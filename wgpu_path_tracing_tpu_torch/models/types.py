"""Scene data structures (host NumPy) and their upload to torch tensors.

A copy of the JAX package's ``models/types.py`` restricted to what the
port renders: the column maps, ``SceneArrays``, ``texture_slots_used`` and
``pack_device_scene`` for the ``tri_isect``, ``tri_full``, ``light_full``,
``atlas``, ``bvh_aabb`` and wide-BVH walk tables. The NumPy code is kept
identical so the packed tables are bit-equal to the reference's.

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


def pack_device_scene(scene: SceneArrays):
    """Build the packed device tables as NumPy arrays.

    Returns a dict with tri_isect, tri_full, light_full, atlas, bvh_aabb
    and the walk tables walk_order, walk_boxes and walk_tris. The walk
    tables are omitted when the wide tree is too deep for the walk's stack
    bound (``accel/bvh8.py::WideBVHDepthError``), as in the JAX package.
    The other large-scene tables (BVH links, clusters, pairs) and the
    texture tables are not built: no intersector or sampler of this package
    reads them yet.
    """
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
    if b:
        bvh_aabb[:b, 0:3] = scene.bvh_aabb_min
        bvh_aabb[:b, 3:6] = scene.bvh_aabb_max
        bvh_meta[:b] = scene.bvh_meta.astype(np.int32)

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

    # Wide-BVH tables for the BVH walk (ops/walk.py). A pathologically deep
    # tree omits them, and the walk then refuses the scene.
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

    return {
        "tri_isect": tri_isect,
        "tri_full": tri_full,
        "light_full": light_full,
        "atlas": np.asarray(atlas, np.float32),
        "bvh_aabb": bvh_aabb,
        **(
            {
                "walk_order": wide.order,
                "walk_boxes": wide.boxes,
                "walk_tris": wide.tris,
            }
            if wide is not None
            else {}
        ),
    }


# The walk tables; a packed scene holds all three or none.
WALK_KEYS = ("walk_order", "walk_boxes", "walk_tris")
# The tables the torch path reads, in the layout both packages share, and
# the dtype each is uploaded as.
DEVICE_KEYS = {
    "tri_isect": np.float32,
    "tri_full": np.float32,
    "light_full": np.float32,
    "atlas": np.float32,
    "walk_order": np.int32,
    "walk_boxes": np.float32,
    "walk_tris": np.float32,
}


def load_jax_scene(packed: dict, device) -> dict:
    """Upload a packed scene (``pack_device_scene`` output of either package,
    as NumPy arrays) to contiguous tensors on ``device``, each in its
    ``DEVICE_KEYS`` dtype (``walk_order`` stays int32).

    Only the keys in ``DEVICE_KEYS`` are read, and the walk tables only
    where the scene has them; the JAX package's extra tables (BVH,
    clusters, pairs, env) are ignored. Raises if CUDA is asked for and
    absent: there is no silent CPU fallback.
    """
    import torch

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but CUDA is not available")
    out = {}
    for key, dtype in DEVICE_KEYS.items():
        if key in WALK_KEYS and key not in packed:
            continue
        arr = np.ascontiguousarray(np.asarray(packed[key], dtype))
        out[key] = torch.from_numpy(arr).to(device)
    return out
