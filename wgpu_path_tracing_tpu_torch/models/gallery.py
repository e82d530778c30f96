"""The gallery scene: a sponza-class procedural atrium.

The counterpart of the JAX package's ``models/gallery.py``. The reference's
production demo scene (sponza.glb: many materials, many textures, 100k+
triangles; renderer.ts:544's scene list) is not in this repository, so
this module builds a scene of the same class procedurally: a colonnaded
atrium, a dozen materials over seven texture map sets (albedo, PBR and
normal maps at mixed resolutions on one 512^2 atlas), about 116k triangles
at ``detail=3``, an emissive skylight and two sconce panels. It runs the
path such a scene runs: the wide-BVH walk (past the dense intersector's
limit), the fat texture canvas with its LCM grids (several map sets at
mixed resolutions), and NEE against several area lights.

Nothing is copied from an asset: geometry and textures are procedural
(seeded NumPy), and array-equal to the JAX package's.
"""

from __future__ import annotations

import numpy as np

from wgpu_path_tracing_tpu_torch.models.assemble import (
    finalize_scene,
    quantize_atlas,
)
from wgpu_path_tracing_tpu_torch.models.procedural import _box, _quad
from wgpu_path_tracing_tpu_torch.models.types import SceneArrays


def _cylinder(center, radius, y0, y1, sides, vsegs, u_tiles=3.0):
    """Open cylinder with smooth per-vertex normals; u wraps ``u_tiles``
    times around the circumference (tiled uvs ride the fat atlas)."""
    cx, cy, cz = center
    tris, nrms, uvs = [], [], []
    ang = np.linspace(0.0, 2 * np.pi, sides + 1)
    ys = np.linspace(y0, y1, vsegs + 1)
    for i in range(sides):
        a0, a1 = ang[i], ang[i + 1]
        n0 = (np.cos(a0), 0.0, np.sin(a0))
        n1 = (np.cos(a1), 0.0, np.sin(a1))
        p0 = (cx + radius * n0[0], 0.0, cz + radius * n0[2])
        p1 = (cx + radius * n1[0], 0.0, cz + radius * n1[2])
        u0 = u_tiles * i / sides
        u1 = u_tiles * (i + 1) / sides
        for j in range(vsegs):
            yl, yh = ys[j], ys[j + 1]
            vl = (j) / vsegs
            vh = (j + 1) / vsegs
            a = (p0[0], yl + cy, p0[2])
            b = (p1[0], yl + cy, p1[2])
            c = (p1[0], yh + cy, p1[2])
            d = (p0[0], yh + cy, p0[2])
            tris.append((a, b, c))
            nrms.append((n0, n1, n1))
            uvs.append(((u0, vl), (u1, vl), (u1, vh)))
            tris.append((a, c, d))
            nrms.append((n0, n1, n0))
            uvs.append(((u0, vl), (u1, vh), (u0, vh)))
    return tris, nrms, uvs


def _noise2(rng, size, octaves=4):
    """Cheap value-noise texture in [0, 1] (seeded, tileable enough)."""
    out = np.zeros((size, size), np.float64)
    amp = 1.0
    total = 0.0
    for o in range(octaves):
        cells = 4 << o
        grid = rng.random((cells, cells))
        big = np.kron(grid, np.ones((size // cells, size // cells)))
        out += amp * big[:size, :size]
        total += amp
        amp *= 0.5
    out /= total
    # soften the blockiness with one box blur
    p = np.pad(out, 1, mode="wrap")
    out = sum(
        p[dy:dy + size, dx:dx + size] for dy in range(3) for dx in range(3)
    ) / 9.0
    return out.astype(np.float32)


def _build_atlas(rng):
    """512^2 atlas: distinct albedo/PBR/normal rects per material family,
    mixed resolutions (so the fat bake exercises the LCM grids)."""
    a = 512
    atlas = np.zeros((a, a, 4), np.float32)
    atlas[..., 3] = 1.0
    rects = {}

    def put(name, x, y, w, h, rgb):
        atlas[y:y + h, x:x + w, 0] = rgb[0]
        atlas[y:y + h, x:x + w, 1] = rgb[1]
        atlas[y:y + h, x:x + w, 2] = rgb[2]
        rects[name] = [x, y, w, h]

    # floor tiles 128^2: marble checker with grout lines
    t = 128
    yy, xx = np.mgrid[0:t, 0:t]
    tile = ((xx // 16 + yy // 16) % 2).astype(np.float32)
    grout = ((xx % 16 < 1) | (yy % 16 < 1)).astype(np.float32)
    n = _noise2(rng, t)
    fl = 0.55 + 0.25 * tile + 0.15 * n
    fl = fl * (1.0 - 0.65 * grout)
    put("floor_alb", 0, 0, t, t, (fl, fl * 0.96, fl * 0.9))
    # floor pbr 64^2 (g=roughness, b=metallic): polished tiles, rough grout
    p = 64
    yy, xx = np.mgrid[0:p, 0:p]
    groutp = ((xx % 8 < 1) | (yy % 8 < 1)).astype(np.float32)
    put("floor_pbr", 128, 0, p, p,
        (np.zeros((p, p), np.float32), 0.25 + 0.7 * groutp,
         np.zeros((p, p), np.float32)))

    # brick wall 128^2 albedo + 128^2 normal map
    yy, xx = np.mgrid[0:t, 0:t]
    row = yy // 16
    bx = (xx + (row % 2) * 8) % 16
    mortar = ((bx < 1) | (yy % 16 < 1)).astype(np.float32)
    bn = _noise2(rng, t)
    br = (0.45 + 0.25 * bn) * (1 - mortar) + 0.62 * mortar
    put("brick_alb", 0, 128, t, t, (br, br * 0.55, br * 0.42))
    # normal map: mortar grooves tilt the normal (r, g around 0.5)
    gx = np.clip(0.5 + 0.35 * (np.roll(mortar, 1, 1) - np.roll(mortar, -1, 1)),
                 0.0, 1.0)
    gy = np.clip(0.5 + 0.35 * (np.roll(mortar, 1, 0) - np.roll(mortar, -1, 0)),
                 0.0, 1.0)
    put("brick_nrm", 128, 128, t, t, (gx, gy, np.ones((t, t), np.float32)))

    # column marble 128^2 albedo + 64^2 pbr
    m = _noise2(rng, t, octaves=5)
    veins = 0.5 + 0.5 * np.cos(12.0 * m * np.pi)
    col = 0.78 - 0.22 * veins * veins
    put("marble_alb", 256, 0, t, t, (col, col, col * 0.95))
    put("marble_pbr", 256, 128, p, p,
        (np.zeros((p, p), np.float32),
         (0.15 + 0.2 * _noise2(rng, p)).astype(np.float32),
         np.zeros((p, p), np.float32)))

    # wood beams 64^2
    yy, xx = np.mgrid[0:p, 0:p]
    wn = _noise2(rng, p)
    ring = 0.5 + 0.5 * np.sin(yy / 3.0 + 6.0 * wn)
    wd = 0.32 + 0.18 * ring
    put("wood_alb", 384, 0, p, p, (wd, wd * 0.6, wd * 0.35))

    # three banner fabrics 64^2 each (diagonal weave + emblem stripe)
    for i, (name, rgb) in enumerate(
        (("banner_r", (0.62, 0.10, 0.10)),
         ("banner_g", (0.12, 0.45, 0.16)),
         ("banner_b", (0.12, 0.2, 0.55)))):
        yy, xx = np.mgrid[0:p, 0:p]
        weave = 0.85 + 0.15 * (((xx + yy) // 2) % 2)
        stripe = ((yy > 24) & (yy < 40)).astype(np.float32)
        rch = (rgb[0] * weave) * (1 - stripe) + 0.8 * stripe
        gch = (rgb[1] * weave) * (1 - stripe) + 0.7 * stripe
        bch = (rgb[2] * weave) * (1 - stripe) + 0.3 * stripe
        put(name, 384, 64 + 64 * i, p, p, (rch, gch, bch))

    return quantize_atlas(atlas), rects


def gallery_atrium(detail: int = 3, max_leaf_size: int = 4,
                   num_bins: int = 12) -> SceneArrays:
    """The sponza-stand-in: colonnaded atrium, ~116k tris at detail=3.

    Interior spans x in [-6, 6], y in [0, 8], z in [-14, 4]; view down -Z
    from around (0, 2.2, 3). 12 materials over 7 texture map sets;
    emissive skylight strip + two sconce panels (NEE-driven lighting,
    miss -> black parity preserved)."""
    rng = np.random.default_rng(42)
    atlas, rects = _build_atlas(rng)

    MAT_FLOOR, MAT_BRICK, MAT_MARBLE, MAT_WOOD = 0, 1, 2, 3
    MAT_BAN_R, MAT_BAN_G, MAT_BAN_B = 4, 5, 6
    MAT_TRIM, MAT_LIGHT, MAT_SCONCE, MAT_DARK, MAT_BRASS = 7, 8, 9, 10, 11

    quads = []  # (quad-tuple, mat)
    cyls = []   # (cyl-tuple, mat)

    ts = 10 * detail
    X, Y, Z0, Z1 = 6.0, 8.0, -14.0, 4.0
    # floor / ceiling
    quads.append((_quad((-X, 0, Z1), (X, 0, Z1), (X, 0, Z0), (-X, 0, Z0),
                        3 * ts), MAT_FLOOR))
    quads.append((_quad((-X, Y, Z0), (X, Y, Z0), (X, Y, Z1), (-X, Y, Z1),
                        2 * ts), MAT_TRIM))
    # outer walls (brick), inward normals
    quads.append((_quad((-X, 0, Z0), (X, 0, Z0), (X, Y, Z0), (-X, Y, Z0),
                        2 * ts), MAT_BRICK))  # back
    quads.append((_quad((X, 0, Z1), (-X, 0, Z1), (-X, Y, Z1), (X, Y, Z1),
                        ts), MAT_BRICK))      # behind camera
    quads.append((_quad((-X, 0, Z1), (-X, 0, Z0), (-X, Y, Z0), (-X, Y, Z1),
                        2 * ts), MAT_BRICK))  # left
    quads.append((_quad((X, 0, Z0), (X, 0, Z1), (X, Y, Z1), (X, Y, Z0),
                        2 * ts), MAT_BRICK))  # right
    # skylight strip (emissive, just under the ceiling)
    ly = Y - 0.02
    quads.append((_quad((-1.6, ly, -11.5), (1.6, ly, -11.5),
                        (1.6, ly, 1.5), (-1.6, ly, 1.5)), MAT_LIGHT))
    # two sconce panels on the side walls
    quads.append((_quad((-X + 0.02, 3.0, -4.0), (-X + 0.02, 3.0, -6.0),
                        (-X + 0.02, 4.2, -6.0), (-X + 0.02, 4.2, -4.0)),
                  MAT_SCONCE))
    quads.append((_quad((X - 0.02, 3.0, -8.0), (X - 0.02, 3.0, -6.0),
                        (X - 0.02, 4.2, -6.0), (X - 0.02, 4.2, -8.0)),
                  MAT_SCONCE))

    # colonnade: two rows of columns with bases and capitals
    sides, vsegs = 12 * detail, 24 * detail
    zs = np.linspace(-12.0, 2.0, 6)
    for zc in zs:
        for xc in (-3.4, 3.4):
            cyls.append((_cylinder((xc, 0.5, zc), 0.45, 0.0, 5.0,
                                   sides, vsegs), MAT_MARBLE))
            for face in _box((xc, 0.25, zc), (1.3, 0.5, 1.3),
                             tess=detail):
                quads.append((face, MAT_TRIM))
            for face in _box((xc, 5.75, zc), (1.2, 0.5, 1.2),
                             tess=detail):
                quads.append((face, MAT_TRIM))

    # architrave beams along each row + cross beams (wood)
    for xc in (-3.4, 3.4):
        for face in _box((xc, 6.3, -5.0), (0.9, 0.6, 15.0),
                         tess=2 * detail):
            quads.append((face, MAT_WOOD))
    for zc in zs:
        for face in _box((0.0, 6.9, zc), (12.0, 0.45, 0.5),
                         tess=2 * detail):
            quads.append((face, MAT_WOOD))

    # hanging banners between columns (alternating colors)
    banner_mats = [MAT_BAN_R, MAT_BAN_G, MAT_BAN_B]
    for i, zc in enumerate(zs[:-1]):
        zm = (zc + zs[i + 1]) / 2
        for side, xc in ((0, -3.35), (1, 3.35)):
            m = banner_mats[(i + side) % 3]
            x0 = xc + (0.5 if xc < 0 else -0.5)
            quads.append((_quad((x0, 5.6, zm - 0.8), (x0, 5.6, zm + 0.8),
                                (x0, 2.8, zm + 0.8), (x0, 2.8, zm - 0.8),
                                2 * detail), m))

    # brass planters (untextured metallic) along the center line
    for zc in (-10.0, -6.0, -2.0):
        for face in _box((0.0, 0.35, zc), (0.9, 0.7, 0.9),
                         tess=detail):
            quads.append((face, MAT_BRASS))
        for face in _box((0.0, 0.85, zc), (0.6, 0.3, 0.6), tess=detail):
            quads.append((face, MAT_DARK))

    v0, v1, v2, n0, n1, n2, uv0, uv1, uv2, mat = ([] for _ in range(10))
    for (tris, uvs, n), m in quads:
        for (a, b, c), (ua, ub, uc) in zip(tris, uvs):
            v0.append(a); v1.append(b); v2.append(c)
            n0.append(n); n1.append(n); n2.append(n)
            uv0.append(ua); uv1.append(ub); uv2.append(uc)
            mat.append(m)
    for (tris, nrms, uvs), m in cyls:
        for (a, b, c), (na, nb, nc), (ua, ub, uc) in zip(tris, nrms, uvs):
            v0.append(a); v1.append(b); v2.append(c)
            n0.append(na); n1.append(nb); n2.append(nc)
            uv0.append(ua); uv1.append(ub); uv2.append(uc)
            mat.append(m)

    f32 = np.float32
    M = 12
    base = np.ones((M, 3), f32)
    base[MAT_FLOOR] = (1.0, 1.0, 1.0)     # texture carries the color
    base[MAT_BRICK] = (1.0, 1.0, 1.0)
    base[MAT_MARBLE] = (1.0, 1.0, 1.0)
    base[MAT_WOOD] = (1.0, 1.0, 1.0)
    base[MAT_BAN_R] = (1.0, 1.0, 1.0)
    base[MAT_BAN_G] = (1.0, 1.0, 1.0)
    base[MAT_BAN_B] = (1.0, 1.0, 1.0)
    base[MAT_TRIM] = (0.62, 0.6, 0.55)
    base[MAT_LIGHT] = (0.0, 0.0, 0.0)
    base[MAT_SCONCE] = (0.0, 0.0, 0.0)
    base[MAT_DARK] = (0.15, 0.3, 0.12)    # planter foliage block
    base[MAT_BRASS] = (0.85, 0.65, 0.3)
    metallic = np.zeros(M, f32)
    metallic[MAT_BRASS] = 1.0
    roughness = np.ones(M, f32)
    roughness[MAT_MARBLE] = 0.35
    roughness[MAT_FLOOR] = 0.4
    roughness[MAT_BRASS] = 0.3
    emission = np.zeros((M, 3), f32)
    emission[MAT_LIGHT] = (1.0, 0.95, 0.85)
    emission[MAT_SCONCE] = (1.0, 0.75, 0.45)
    estrength = np.zeros(M, f32)
    estrength[MAT_LIGHT] = 9.0
    estrength[MAT_SCONCE] = 5.0
    ior = np.full(M, 1.5, f32)
    transmission = np.zeros(M, f32)

    scene = finalize_scene(
        np.array(v0, f32), np.array(v1, f32), np.array(v2, f32),
        np.array(n0, f32), np.array(n1, f32), np.array(n2, f32),
        np.array(uv0, f32), np.array(uv1, f32), np.array(uv2, f32),
        np.array(mat, np.int32),
        base, metallic, roughness, emission, estrength, ior, transmission,
        max_leaf_size=max_leaf_size, num_bins=num_bins,
    )
    scene.mat_albedo_rect[MAT_FLOOR] = rects["floor_alb"]
    scene.mat_pbr_rect[MAT_FLOOR] = rects["floor_pbr"]
    scene.mat_albedo_rect[MAT_BRICK] = rects["brick_alb"]
    scene.mat_normal_rect[MAT_BRICK] = rects["brick_nrm"]
    scene.mat_albedo_rect[MAT_MARBLE] = rects["marble_alb"]
    scene.mat_pbr_rect[MAT_MARBLE] = rects["marble_pbr"]
    scene.mat_albedo_rect[MAT_WOOD] = rects["wood_alb"]
    scene.mat_albedo_rect[MAT_BAN_R] = rects["banner_r"]
    scene.mat_albedo_rect[MAT_BAN_G] = rects["banner_g"]
    scene.mat_albedo_rect[MAT_BAN_B] = rects["banner_b"]
    scene.atlas = atlas
    return scene
