"""Procedural test scenes.

The reference ships sample scenes as .glb files (public/models/, SURVEY.md §4)
and its default scene is a Cornell box (renderer.ts:544 loads
``/models/cornell.glb``, which is stripped from the mirror). This module
builds an equivalent Cornell box procedurally so the framework has a
self-contained default/benchmark scene, framed for the reference's default
camera at (0, 1, 2.8) looking down -Z with fov pi/3 (renderer.ts:137-149).

Also provides ``material_test_box``, which covers every BSDF lobe and light
type the renderer shades, ``textured_cornell``, the box with a synthetic
texture atlas, and ``single_triangle`` and ``random_triangles`` for
intersection tests.
"""

from __future__ import annotations

import numpy as np

from wgpu_path_tracing_tpu_torch.models.assemble import (
    finalize_scene,
    quantize_atlas,
)
from wgpu_path_tracing_tpu_torch.models.types import SceneArrays


def _quad(p0, p1, p2, p3, tess: int = 1):
    """CCW triangles for quad p0-p1-p2-p3 (normal by right-hand rule),
    optionally tessellated into a tess x tess grid (2·tess² triangles).

    Vectorized since round 5 — the old per-cell Python loops cost 99 s
    for the bench's 4M-tri scene — but BIT-IDENTICAL to them: every f64
    expression keeps the scalar code's exact association
    ((p·(1-u))·(1-v), the left-assoc 4-term sum, i/tess division), and
    the (i-major, j, tri-pair) emission order is preserved, so BVH
    builds, goldens, and parity streams are unchanged
    (tests/test_procedural_vec.py pins equality against the scalar
    reference). Returns (tris (K, 3, 3) f64, uvs (K, 3, 2) f64, n) —
    rows iterate exactly like the old per-triangle tuples."""
    p0, p1, p2, p3 = (np.asarray(p, np.float64) for p in (p0, p1, p2, p3))
    n = np.cross(p1 - p0, p3 - p0)
    n = n / np.linalg.norm(n)
    e = np.arange(tess + 1, dtype=np.float64) / tess
    u0 = e[:-1][:, None, None]  # (tess, 1, 1) — i-major
    u1 = e[1:][:, None, None]
    v0 = e[:-1][None, :, None]  # (1, tess, 1)
    v1 = e[1:][None, :, None]

    def pt(u, v):
        # Same association as the scalar original: (p*(1-u))*(1-v) etc.,
        # summed left to right.
        t0 = (p0 * (1.0 - u)) * (1.0 - v)
        t1 = (p1 * u) * (1.0 - v)
        t2 = (p2 * u) * v
        t3 = (p3 * (1.0 - u)) * v
        return ((t0 + t1) + t2) + t3  # (tess, tess, 3)

    a = pt(u0, v0)
    b = pt(u1, v0)
    c = pt(u1, v1)
    d = pt(u0, v1)
    tris = np.stack(
        [np.stack([a, b, c], axis=2), np.stack([a, c, d], axis=2)], axis=2
    ).reshape(-1, 3, 3)  # (i, j, pair) order == the old append order

    def uv(u, v):
        return np.stack(
            [np.broadcast_to(u[..., 0], (tess, tess)),
             np.broadcast_to(v[..., 0], (tess, tess))], axis=-1)

    ua, ub, uc, ud = uv(u0, v0), uv(u1, v0), uv(u1, v1), uv(u0, v1)
    uvs = np.stack(
        [np.stack([ua, ub, uc], axis=2), np.stack([ua, uc, ud], axis=2)],
        axis=2,
    ).reshape(-1, 3, 2)
    return tris, uvs, n


def _box(center, size, yaw=0.0, tess: int = 1):
    """Axis-aligned box rotated by ``yaw`` about +Y, outward normals."""
    cx, cy, cz = center
    sx, sy, sz = (s / 2 for s in size)
    c, s = np.cos(yaw), np.sin(yaw)

    def rot(p):
        x, y, z = p
        return (cx + c * x + s * z, cy + y, cz - s * x + c * z)

    # corners: (+-sx, +-sy, +-sz)
    faces = [
        # +X
        ((sx, -sy, sz), (sx, -sy, -sz), (sx, sy, -sz), (sx, sy, sz)),
        # -X
        ((-sx, -sy, -sz), (-sx, -sy, sz), (-sx, sy, sz), (-sx, sy, -sz)),
        # +Y
        ((-sx, sy, sz), (sx, sy, sz), (sx, sy, -sz), (-sx, sy, -sz)),
        # -Y
        ((-sx, -sy, -sz), (sx, -sy, -sz), (sx, -sy, sz), (-sx, -sy, sz)),
        # +Z
        ((-sx, -sy, sz), (sx, -sy, sz), (sx, sy, sz), (-sx, sy, sz)),
        # -Z
        ((sx, -sy, -sz), (-sx, -sy, -sz), (-sx, sy, -sz), (sx, sy, -sz)),
    ]
    out = []
    for f in faces:
        out.append(_quad(*(rot(p) for p in f), tess=tess))
    return out


def cornell_box(
    light_emission=(1.0, 0.9, 0.7),
    light_strength: float = 5.0,
    max_leaf_size: int = 4,
    num_bins: int = 12,
    tessellation: int = 1,
) -> SceneArrays:
    """A classic Cornell box: white floor/ceiling/back, red left wall, green
    right wall, one emissive ceiling quad, one tall and one short box.

    Interior spans x in [-1, 1], y in [0, 2], z in [-1, 1]; the open side
    faces +Z toward the default camera.
    """
    quads = []  # (quad, material_index)

    white, red, green = 0, 1, 2
    light_mat, tall_mat, short_mat = 3, 0, 0

    ts = tessellation
    # floor (+Y normal)
    quads.append((_quad((-1, 0, 1), (1, 0, 1), (1, 0, -1), (-1, 0, -1), ts), white))
    # ceiling (-Y normal)
    quads.append((_quad((-1, 2, -1), (1, 2, -1), (1, 2, 1), (-1, 2, 1), ts), white))
    # back wall (+Z normal)
    quads.append((_quad((-1, 0, -1), (1, 0, -1), (1, 2, -1), (-1, 2, -1), ts), white))
    # left wall (+X normal, red)
    quads.append((_quad((-1, 0, 1), (-1, 0, -1), (-1, 2, -1), (-1, 2, 1), ts), red))
    # right wall (-X normal, green)
    quads.append((_quad((1, 0, -1), (1, 0, 1), (1, 2, 1), (1, 2, -1), ts), green))
    # light quad just below the ceiling (-Y normal)
    ly = 1.98
    quads.append(
        (_quad((-0.3, ly, -0.3), (0.3, ly, -0.3), (0.3, ly, 0.3), (-0.3, ly, 0.3)),
         light_mat)
    )

    # Boxes
    for face in _box((-0.4, 0.6, -0.35), (0.55, 1.2, 0.55), yaw=np.radians(18),
                     tess=ts):
        quads.append((face, tall_mat))
    for face in _box((0.45, 0.3, 0.3), (0.55, 0.6, 0.55), yaw=np.radians(-17),
                     tess=ts):
        quads.append((face, short_mat))

    # Concatenated assembly (bench scenes reach 4M tris; per-triangle
    # Python appends cost minutes there). Values and order match the old
    # append loop exactly: _quad returns (K, 3, 3)/(K, 3, 2) rows in the
    # same emission order, and the f64 -> f32 cast happens at the same
    # single point (np.array(..., f32) == .astype(f32) rounding).
    T = np.concatenate([np.asarray(t) for (t, u, n), m in quads])
    U = np.concatenate([np.asarray(u) for (t, u, n), m in quads])
    v0, v1, v2 = T[:, 0], T[:, 1], T[:, 2]
    uv0, uv1, uv2 = U[:, 0], U[:, 1], U[:, 2]
    n0 = np.concatenate(
        [np.broadcast_to(n, (len(t), 3)) for (t, u, n), m in quads])
    n1 = n2 = n0
    mat = np.concatenate(
        [np.full(len(t), m, np.int32) for (t, u, n), m in quads])

    f32 = np.float32
    # Materials: diffuse walls use metallic 0, roughness 1
    # (gpu.ts:358-421 material assembly; emission via emissiveFactor +
    # KHR_materials_emissive_strength).
    base = np.array(
        [[0.73, 0.73, 0.73], [0.65, 0.05, 0.05], [0.12, 0.45, 0.15], [0.0, 0.0, 0.0]],
        f32,
    )
    metallic = np.array([0.0, 0.0, 0.0, 0.0], f32)
    roughness = np.array([1.0, 1.0, 1.0, 1.0], f32)
    emission = np.array(
        [[0, 0, 0], [0, 0, 0], [0, 0, 0], list(light_emission)], f32
    )
    estrength = np.array([0.0, 0.0, 0.0, light_strength], f32)
    ior = np.array([1.5] * 4, f32)
    transmission = np.array([0.0] * 4, f32)

    return finalize_scene(
        np.array(v0, f32), np.array(v1, f32), np.array(v2, f32),
        np.array(n0, f32), np.array(n1, f32), np.array(n2, f32),
        np.array(uv0, f32), np.array(uv1, f32), np.array(uv2, f32),
        np.array(mat, np.int32),
        base, metallic, roughness, emission, estrength, ior, transmission,
        max_leaf_size=max_leaf_size, num_bins=num_bins,
    )


def material_test_box(max_leaf_size: int = 4, num_bins: int = 12) -> SceneArrays:
    """Cornell variant exercising every BSDF lobe and light type: metallic
    tall box (GGX specular), glass short box (transmission + IOR), diffuse
    walls, plus a point light and a directional light alongside the emissive
    quad — used by parity tests to cover pt.wgsl:498-620's branches and all
    three sampleLight cases (pt.wgsl:385-486)."""
    quads = []
    white, red, green, light_mat, metal, glass = 0, 1, 2, 3, 4, 5

    quads.append((_quad((-1, 0, 1), (1, 0, 1), (1, 0, -1), (-1, 0, -1)), white))
    quads.append((_quad((-1, 2, -1), (1, 2, -1), (1, 2, 1), (-1, 2, 1)), white))
    quads.append((_quad((-1, 0, -1), (1, 0, -1), (1, 2, -1), (-1, 2, -1)), white))
    quads.append((_quad((-1, 0, 1), (-1, 0, -1), (-1, 2, -1), (-1, 2, 1)), red))
    quads.append((_quad((1, 0, -1), (1, 0, 1), (1, 2, 1), (1, 2, -1)), green))
    ly = 1.98
    quads.append(
        (_quad((-0.3, ly, -0.3), (0.3, ly, -0.3), (0.3, ly, 0.3), (-0.3, ly, 0.3)),
         light_mat)
    )
    for face in _box((-0.4, 0.6, -0.35), (0.55, 1.2, 0.55), yaw=np.radians(18)):
        quads.append((face, metal))
    for face in _box((0.45, 0.3, 0.3), (0.55, 0.6, 0.55), yaw=np.radians(-17)):
        quads.append((face, glass))

    v0, v1, v2, n0, n1, n2, uv0, uv1, uv2, mat = [], [], [], [], [], [], [], [], [], []
    for (tris, uvs, n), m in quads:
        for (a, b, c), (ua, ub, uc) in zip(tris, uvs):
            v0.append(a); v1.append(b); v2.append(c)
            n0.append(n); n1.append(n); n2.append(n)
            uv0.append(ua); uv1.append(ub); uv2.append(uc)
            mat.append(m)

    f32 = np.float32
    base = np.array(
        [[0.73, 0.73, 0.73], [0.65, 0.05, 0.05], [0.12, 0.45, 0.15],
         [0.0, 0.0, 0.0], [0.9, 0.85, 0.7], [1.0, 1.0, 1.0]], f32,
    )
    metallic = np.array([0.0, 0.0, 0.0, 0.0, 1.0, 0.0], f32)
    roughness = np.array([1.0, 1.0, 1.0, 1.0, 0.2, 0.05], f32)
    emission = np.zeros((6, 3), f32)
    emission[3] = (1.0, 0.9, 0.7)
    estrength = np.array([0, 0, 0, 4.0, 0, 0], f32)
    ior = np.full(6, 1.5, f32)
    transmission = np.array([0, 0, 0, 0, 0, 1.0], f32)

    return finalize_scene(
        np.array(v0, f32), np.array(v1, f32), np.array(v2, f32),
        np.array(n0, f32), np.array(n1, f32), np.array(n2, f32),
        np.array(uv0, f32), np.array(uv1, f32), np.array(uv2, f32),
        np.array(mat, np.int32),
        base, metallic, roughness, emission, estrength, ior, transmission,
        light_position=np.array([[0.0, 1.8, 0.5], [-0.3, -1.0, -0.4]], f32),
        light_type=np.array([2, 1], np.int32),  # point, directional
        light_color=np.array([[1.0, 0.9, 0.8], [0.6, 0.7, 1.0]], f32),
        light_intensity=np.array([0.8, 0.5], f32),
        max_leaf_size=max_leaf_size, num_bins=num_bins,
    )


def single_triangle(
    v0=(-1.0, -1.0, -3.0),
    v1=(1.0, -1.0, -3.0),
    v2=(0.0, 1.0, -3.0),
) -> SceneArrays:
    """One diffuse triangle, for intersection tests."""
    f32 = np.float32
    n = np.cross(np.subtract(v1, v0), np.subtract(v2, v0))
    n = (n / np.linalg.norm(n)).astype(f32)
    return finalize_scene(
        np.array([v0], f32), np.array([v1], f32), np.array([v2], f32),
        np.array([n], f32), np.array([n], f32), np.array([n], f32),
        np.zeros((1, 2), f32), np.zeros((1, 2), f32), np.zeros((1, 2), f32),
        np.zeros(1, np.int32),
        np.array([[0.8, 0.8, 0.8]], f32),
        np.zeros(1, f32), np.ones(1, f32),
        np.zeros((1, 3), f32), np.zeros(1, f32),
        np.full(1, 1.5, f32), np.zeros(1, f32),
    )


def random_triangles(
    n: int, seed: int = 0, extent: float = 10.0, tri_size: float = 0.5
) -> SceneArrays:
    """A cloud of ``n`` random diffuse triangles, the first one emissive,
    for traversal stress tests and large-scene measurements."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    base = rng.uniform(-extent, extent, (n, 3))
    v0 = base
    v1 = base + rng.uniform(-tri_size, tri_size, (n, 3))
    v2 = base + rng.uniform(-tri_size, tri_size, (n, 3))
    nrm = np.cross(v1 - v0, v2 - v0)
    ln = np.linalg.norm(nrm, axis=1, keepdims=True)
    ln[ln == 0] = 1
    nrm = nrm / ln
    uv = rng.uniform(0, 1, (n, 2))
    mats = np.zeros(n, np.int32)
    mats[0] = 1  # one emissive triangle
    return finalize_scene(
        v0.astype(f32), v1.astype(f32), v2.astype(f32),
        nrm.astype(f32), nrm.astype(f32), nrm.astype(f32),
        uv.astype(f32), uv.astype(f32), uv.astype(f32),
        mats,
        np.array([[0.7, 0.7, 0.7], [0, 0, 0]], f32),
        np.zeros(2, f32), np.ones(2, f32),
        np.array([[0, 0, 0], [1, 1, 1]], f32), np.array([0.0, 4.0], f32),
        np.full(2, 1.5, f32), np.zeros(2, f32),
    )


def textured_cornell(tessellation: int = 1, atlas_size: int = 32,
                     congruent: bool = False) -> SceneArrays:
    """Cornell box with a synthetic texture atlas (the reference's surviving
    sample scenes ship no textures — sponza.glb is stripped): checkerboard
    albedo + random rough/metal PBR map on the white material, perturbed
    normal map on the red wall. Exercises the full atlas-fetch path of
    pt.wgsl:112-120/pt.wgsl:159-230 (the JAX bench's config 3; config 6 is
    ``atlas_size=512, congruent=True``).

    ``atlas_size`` scales the atlas and the material rects with it, with
    per-texel detail at the full resolution. ``congruent`` gives albedo,
    PBR and normal maps one resolution (a/2 square each), the common case
    of real glTF materials."""
    scene = cornell_box(tessellation=tessellation)
    rng = np.random.default_rng(3)
    a = atlas_size
    atlas = np.zeros((a, a, 4), np.float32)
    atlas[..., 3] = 1.0
    h2, q = a // 2, a // 4
    # albedo checker at (0, 0, a/2, a/2), 4-texel cells at every size so
    # big atlases carry real high-frequency content
    yy, xx = np.mgrid[0:h2, 0:h2]
    checker = ((xx // 4 + yy // 4) % 2).astype(np.float32)
    atlas[0:h2, 0:h2, 0] = 0.2 + 0.6 * checker
    atlas[0:h2, 0:h2, 1] = 0.8 - 0.5 * checker
    atlas[0:h2, 0:h2, 2] = 0.4
    if congruent:
        atlas[0:h2, h2:a, 1] = rng.uniform(0.2, 1.0, (h2, h2)).astype(
            np.float32)
        atlas[0:h2, h2:a, 2] = rng.uniform(0.0, 1.0, (h2, h2)).astype(
            np.float32)
        nm = rng.uniform(0.3, 0.7, (h2, h2, 2)).astype(np.float32)
        atlas[h2:a, 0:h2, 0] = nm[..., 0]
        atlas[h2:a, 0:h2, 1] = nm[..., 1]
        atlas[h2:a, 0:h2, 2] = 1.0
        scene.mat_albedo_rect[0] = [0, 0, h2, h2]
        scene.mat_pbr_rect[0] = [h2, 0, h2, h2]
        scene.mat_normal_rect[1] = [0, h2, h2, h2]
        scene.atlas = quantize_atlas(atlas)
        return scene
    # pbr map at (a/2, 0, a/4, a/4): g = roughness, b = metallic
    atlas[0:q, h2:h2 + q, 1] = rng.uniform(0.2, 1.0, (q, q)).astype(np.float32)
    atlas[0:q, h2:h2 + q, 2] = rng.uniform(0.0, 1.0, (q, q)).astype(np.float32)
    # normal map at (a/2, a/4, a/4, a/4): perturbed tangent normals
    nm = rng.uniform(0.3, 0.7, (q, q, 2)).astype(np.float32)
    atlas[q:h2, h2:h2 + q, 0] = nm[..., 0]
    atlas[q:h2, h2:h2 + q, 1] = nm[..., 1]
    atlas[q:h2, h2:h2 + q, 2] = 1.0

    scene.mat_albedo_rect[0] = [0, 0, h2, h2]
    scene.mat_pbr_rect[0] = [h2, 0, q, q]
    scene.mat_normal_rect[1] = [h2, q, q, q]
    scene.atlas = quantize_atlas(atlas)
    return scene
