"""Scene finalization: triangles + materials + explicit lights -> SceneArrays.

Mirrors the tail of the reference's ``prepareScene`` (gpu.ts:105-150):

1. build the BVH, which reorders the triangle array in place
   (gpu.ts:119 -> bvh.ts:53): the native library's SAH build and one fused
   gather of the triangle columns when ``accel/native.py`` has a compiler,
   else the NumPy build and a gather a column (the same arrays),
2. extract one emissive light per triangle whose material has
   ``length(emission) > 0`` — AFTER the reorder, so ``triangleIndex`` refers
   to sorted positions (gpu.ts:121-138); the light's color is the material's
   emission and its intensity the emissive strength.
"""

from __future__ import annotations

import numpy as np

from wgpu_path_tracing_tpu_torch.accel import native
from wgpu_path_tracing_tpu_torch.models.types import (
    LIGHT_TYPE_EMISSIVE,
    SceneArrays,
)


def quantize_atlas(atlas: np.ndarray) -> np.ndarray:
    """Round atlas texels to bfloat16-representable float32 values (round to
    nearest, ties to even), as the reference does at this choke point, so
    texel values stay bit-equal between the two packages. Written with
    integer bit operations on finite values; no bfloat16 library needed."""
    a = np.ascontiguousarray(np.asarray(atlas, np.float32))
    bits = a.view(np.uint32).astype(np.uint64)
    rounded = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return rounded.astype(np.uint32).view(np.float32).reshape(a.shape)


def finalize_scene(
    tri_v0: np.ndarray,
    tri_v1: np.ndarray,
    tri_v2: np.ndarray,
    tri_n0: np.ndarray,
    tri_n1: np.ndarray,
    tri_n2: np.ndarray,
    tri_uv0: np.ndarray,
    tri_uv1: np.ndarray,
    tri_uv2: np.ndarray,
    tri_mat: np.ndarray,
    mat_base_color: np.ndarray,
    mat_metallic: np.ndarray,
    mat_roughness: np.ndarray,
    mat_emission: np.ndarray,
    mat_emissive_strength: np.ndarray,
    mat_ior: np.ndarray,
    mat_transmission: np.ndarray,
    mat_albedo_rect: np.ndarray | None = None,
    mat_normal_rect: np.ndarray | None = None,
    mat_pbr_rect: np.ndarray | None = None,
    mat_emissive_rect: np.ndarray | None = None,
    light_position: np.ndarray | None = None,
    light_type: np.ndarray | None = None,
    light_color: np.ndarray | None = None,
    light_intensity: np.ndarray | None = None,
    light_aux: np.ndarray | None = None,
    atlas: np.ndarray | None = None,
    max_leaf_size: int = 4,
    num_bins: int = 12,
) -> SceneArrays:
    f32 = np.float32
    num_tris = int(np.asarray(tri_v0).shape[0])
    num_mats = int(np.asarray(mat_base_color).shape[0])

    if atlas is not None:
        atlas = quantize_atlas(atlas)

    bvh = native.build_bvh(tri_v0, tri_v1, tri_v2, max_leaf_size, num_bins)
    order = bvh.order

    def reorder(a):
        a = np.asarray(a, f32)
        return a[order] if num_tris else a

    if num_tris and native.native_available():
        (tri_v0, tri_v1, tri_v2, tri_n0, tri_n1, tri_n2, tri_uv0, tri_uv1,
         tri_uv2, tri_mat) = native.reorder_tris_native(
            order, tri_v0, tri_v1, tri_v2, tri_n0, tri_n1, tri_n2, tri_uv0,
            tri_uv1, tri_uv2, tri_mat)
    else:
        tri_v0 = reorder(tri_v0)
        tri_v1 = reorder(tri_v1)
        tri_v2 = reorder(tri_v2)
        tri_n0 = reorder(tri_n0)
        tri_n1 = reorder(tri_n1)
        tri_n2 = reorder(tri_n2)
        tri_uv0 = reorder(tri_uv0)
        tri_uv1 = reorder(tri_uv1)
        tri_uv2 = reorder(tri_uv2)
        tri_mat = np.asarray(tri_mat, np.int32)[order] if num_tris else (
            np.asarray(tri_mat, np.int32))

    # Explicit (KHR punctual) lights collected during node processing.
    lp = [] if light_position is None else list(np.asarray(light_position, f32))
    lt = [] if light_type is None else list(np.asarray(light_type, np.int32))
    lc = [] if light_color is None else list(np.asarray(light_color, f32))
    li = [] if light_intensity is None else list(np.asarray(light_intensity, f32))
    ltri = [0] * len(lp)
    laux = (
        [np.zeros(5, f32)] * len(lp)
        if light_aux is None
        else list(np.asarray(light_aux, f32).reshape(len(lp), 5))
    )

    # Emissive triangle lights, extracted after the BVH reorder
    # (gpu.ts:121-138: condition is length(material.emission) > 0).
    mat_emission = np.asarray(mat_emission, f32).reshape(num_mats, 3)
    mat_emissive_strength = np.asarray(mat_emissive_strength, f32)
    emissive_mat = np.linalg.norm(mat_emission, axis=1) > 0.0
    for i in range(num_tris):
        m = int(tri_mat[i])
        if emissive_mat[m]:
            lp.append(np.zeros(3, f32))
            lt.append(LIGHT_TYPE_EMISSIVE)
            lc.append(mat_emission[m])
            li.append(mat_emissive_strength[m])
            ltri.append(i)
            laux.append(np.zeros(5, f32))

    def rect(r):
        # One FRESH zero array per slot: callers mutate these in place
        # (models/procedural.py::textured_cornell), and a shared default
        # would alias every slot to the same storage — writing an albedo
        # rect would conjure identical pbr/emissive/normal maps.
        if r is None:
            return np.zeros((num_mats, 4), np.int32)
        return np.asarray(r, np.int32).reshape(num_mats, 4)

    return SceneArrays(
        tri_v0=tri_v0,
        tri_v1=tri_v1,
        tri_v2=tri_v2,
        tri_n0=tri_n0,
        tri_n1=tri_n1,
        tri_n2=tri_n2,
        tri_uv0=tri_uv0,
        tri_uv1=tri_uv1,
        tri_uv2=tri_uv2,
        tri_mat=tri_mat,
        mat_base_color=np.asarray(mat_base_color, f32).reshape(num_mats, 3),
        mat_metallic=np.asarray(mat_metallic, f32),
        mat_roughness=np.asarray(mat_roughness, f32),
        mat_emission=mat_emission,
        mat_emissive_strength=mat_emissive_strength,
        mat_ior=np.asarray(mat_ior, f32),
        mat_transmission=np.asarray(mat_transmission, f32),
        mat_albedo_rect=rect(mat_albedo_rect),
        mat_normal_rect=rect(mat_normal_rect),
        mat_pbr_rect=rect(mat_pbr_rect),
        mat_emissive_rect=rect(mat_emissive_rect),
        light_position=np.asarray(lp, f32).reshape(len(lp), 3),
        light_type=np.asarray(lt, np.int32),
        light_color=np.asarray(lc, f32).reshape(len(lc), 3),
        light_intensity=np.asarray(li, f32),
        light_tri=np.asarray(ltri, np.int32),
        light_aux=np.asarray(laux, f32).reshape(len(laux), 5),
        bvh_aabb_min=bvh.aabb_min,
        bvh_aabb_max=bvh.aabb_max,
        bvh_meta=bvh.meta,
        atlas=atlas,
    ).validate()
