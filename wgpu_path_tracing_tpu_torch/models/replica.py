"""A reconstruction of the reference's default scene, cornell.glb.

The counterpart of the JAX package's ``models/replica.py``. The reference
renders cornell.glb by default (renderer.ts:544), a file that is not in
this repository; its 512-spp image survives (docs/img/cornell_512spp.png,
README.md:11). The JAX package rebuilt the scene from two anchors, and
this module builds the same arrays:

* the room as cornell2.glb has it: x, z in [-1, 1], y in [0, 2], red wall
  at +x, green at -x, white elsewhere, a 0.5 x 0.5 emissive quad at y =
  1.98;
* the objects, placed by eye from the image and then fitted to it: a tall
  white pedestal with a glass sphere, a mirror cube with a small glass
  sphere, a small chrome sphere, a figurine (a stepped octagonal plinth, a
  body and a barrel head with a procedural wood texture) and an engraved
  "?" decal on the pedestal, and Suzanne, read from a monkey.glb file.

No monkey.glb is in this repository: ``cornell_replica`` adds Suzanne only
when ``monkey_path`` names a file that exists, and otherwise builds the
scene without it, as the JAX package does when its file is missing.
Because the placement is estimated, an error against the reference's
image measures the reconstruction, not the renderer.
"""

from __future__ import annotations

import os

import numpy as np

from wgpu_path_tracing_tpu_torch.models.assemble import finalize_scene
from wgpu_path_tracing_tpu_torch.models.procedural import _box, _quad
from wgpu_path_tracing_tpu_torch.models.types import SceneArrays

# The camera fitted to the reference image's light quad (the quad's known
# world corners against its pixel box give the eye's height and depth);
# the reference's default (0, 1, 2.8) frames a larger room than this one.
REPLICA_CAMERA_POSITION = (0.0, 1.086, 2.40)


def icosphere(center, radius: float, subdivisions: int = 3):
    """Subdivided icosahedron with smooth (spherical) vertex normals.

    Returns (v0, v1, v2, n0, n1, n2) arrays; ~20*4^s triangles.
    """
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [
            (-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0),
            (0, -1, t), (0, 1, t), (0, -1, -t), (0, 1, -t),
            (t, 0, -1), (t, 0, 1), (-t, 0, -1), (-t, 0, 1),
        ],
        np.float64,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = [
        (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
        (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
        (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
        (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1),
    ]
    verts = [tuple(v) for v in verts]

    def midpoint(a, b, cache):
        key = (min(a, b), max(a, b))
        if key not in cache:
            m = np.add(verts[a], verts[b]) / 2.0
            m /= np.linalg.norm(m)
            cache[key] = len(verts)
            verts.append(tuple(m))
        return cache[key]

    for _ in range(subdivisions):
        cache: dict = {}
        new_faces = []
        for a, b, c in faces:
            ab = midpoint(a, b, cache)
            bc = midpoint(b, c, cache)
            ca = midpoint(c, a, cache)
            new_faces += [(a, ab, ca), (ab, b, bc), (ca, bc, c), (ab, bc, ca)]
        faces = new_faces

    v = np.asarray(verts, np.float64)
    f = np.asarray(faces, np.int64)
    p = v[f]  # (F, 3 verts, 3)
    n = p  # unit sphere: normal == position
    p = p * radius + np.asarray(center, np.float64)
    return (
        p[:, 0], p[:, 1], p[:, 2],
        n[:, 0], n[:, 1], n[:, 2],
    )


def _load_monkey(path: str, center, scale: float, yaw: float = 0.0):
    """Suzanne from a monkey.glb file, recentred, scaled and turned."""
    from wgpu_path_tracing_tpu_torch.models.gltf import load_model

    s = load_model(path)
    # Keep only the monkey mesh (drop the room it ships inside, if any):
    # pick the material with the most triangles among sub-5k meshes (walls
    # are few large quads; a hypothetical dense room mesh is excluded).
    counts = np.bincount(s.tri_mat, minlength=s.num_materials)
    eligible = np.where(counts < 5000, counts, -1)
    mat = int(np.argmax(eligible if eligible.max() > 0 else counts))
    sel = s.tri_mat == mat
    v = [s.tri_v0[sel], s.tri_v1[sel], s.tri_v2[sel]]
    n = [s.tri_n0[sel], s.tri_n1[sel], s.tri_n2[sel]]
    allv = np.concatenate(v)
    lo, hi = allv.min(0), allv.max(0)
    mid = (lo + hi) / 2
    mid[1] = lo[1]  # rest on the floor
    sc = scale / max(hi - lo)
    c, sn = np.cos(yaw), np.sin(yaw)
    rot = np.array([[c, 0, sn], [0, 1, 0], [-sn, 0, c]], np.float64)

    def xf(p):
        return ((p - mid) * sc) @ rot.T + np.asarray(center, np.float64)

    def xfn(p):
        return p @ rot.T

    return [xf(x) for x in v], [xfn(x) for x in n]


# Placement and material parameters, the JAX package's fitted values
# (its tools/replica_fit.py fitted them to the reference's image).
REPLICA_PARAMS: dict[str, float] = {
    # Fitted by tools/replica_fit.py (coordinate-descent passes against
    # the golden, later ones at higher fidelity with shrinking steps:
    # three at 192^2, then bounded passes at 256^2/48spp after splitting
    # the figurine body/head materials and adding the procedural wood
    # texture, then two seeded passes after the doll/decal/octagonal-base
    # restructure — whose hand-set params measured 0.1104 official before
    # fitting): official 512^2/256spp RMSE 0.164 (hand-placed) ->
    # 0.1040 -> 0.0953 -> 0.0946. Geometry intent unchanged; values are
    # the fitted optimum under the BOUNDS in tools/replica_fit.py (added
    # after an unbounded fit twice tried to delete the chrome ball).
    "ped_cx": -0.43925, "ped_cz": -0.184, "ped_w": 0.3775, "ped_h": 0.8673,
    "ped_d": 0.3, "ped_yaw": 4.0,
    "glass1_r": 0.229,
    "cube_cx": 0.5155, "cube_cz": -0.5185, "cube_s": 0.4815,
    "cube_yaw": 53.69375,
    "glass2_r": 0.06935,
    # The golden's chrome ball is a sharp mirror sphere; the bounded fit
    # settles at the 0.04 bound floor (the hand-measured 0.07 read off
    # the zoomed golden measured WORSE officially — the floor keeps the
    # ball visible while matching the golden's small floor highlight).
    "chrome_cx": 0.0259875, "chrome_cz": 0.075, "chrome_r": 0.04,
    "fig_cx": 0.73885, "fig_cz": 0.381875, "fig_base_w": 0.489,
    "fig_base_h": 0.092, "fig_base_d": 0.886, "fig_body_r": 0.175575,
    "fig_head_r": 0.191,
    # Figurine body vertical stretch (legs/arms ride body_r/body_sy with
    # fixed proportions); the fit relaxed the hand-set egg (1.15) back to
    # a sphere.
    "body_sy": 1.0,
    # Engraved "?" decal on the pedestal's front face (thin outline in
    # the golden): line darkness (0 = no decal).
    "q_amp": 0.22,
    "monkey_cx": -0.6512, "monkey_cz": 0.47685, "monkey_s": 0.271875,
    "monkey_yaw": 8.0,
    "light_strength": 24.24,
    "brown_r": 0.376, "brown_g": 0.1388, "brown_b": 0.0,
    "base_r": 0.345, "base_g": 0.47, "base_b": 0.4375,
    # Figurine body (grey-green in the golden, distinct from the brown
    # barrel head — visible in the side-by-side).
    "body_r": 0.4375, "body_g": 0.105, "body_b": 0.105,
    # Procedural wood texture on the barrel HEAD (the real texture is
    # stripped with the blob; the golden shows stave grain, dark hoops,
    # and a dark text band) — parameters are continuous so the fit's
    # coordinate descent can tune them; all-zero amps = flat brown.
    "wood_stave_amp": 0.06,   # vertical stave-grain contrast
    "wood_ring_amp": 0.15,    # dark hoop rings near top/bottom
    "wood_band_dark": 0.45,   # darkness of the central text band
    "wood_band_y": 0.45,      # band center in sphere-v
    "wood_band_h": 0.16,      # band height in sphere-v
    "wood_band_g": 0.12,      # band green tint (the carved text)
}


def _wood_atlas(p: dict, size: int = 64) -> np.ndarray:
    """(size, size, 4) linear-RGBA barrel-wood albedo from REPLICA_PARAMS.

    Smooth functions of the fitted parameters only (no randomness), so
    the golden-fit coordinate descent sees a continuous objective."""
    f32 = np.float32
    vv, uu = np.mgrid[0:size, 0:size].astype(np.float64) / size
    shade = 1.0 - p["wood_stave_amp"] * (0.5 + 0.5 * np.sin(
        2.0 * np.pi * 8.0 * uu))
    for ring_v in (0.12, 0.88):
        shade = shade - p["wood_ring_amp"] * np.exp(
            -((vv - ring_v) / 0.05) ** 2)
    band = 1.0 / (1.0 + np.exp(-(vv - (p["wood_band_y"]
                                       - p["wood_band_h"] / 2)) / 0.02))
    band = band * (1.0 / (1.0 + np.exp(
        (vv - (p["wood_band_y"] + p["wood_band_h"] / 2)) / 0.02)))
    shade = shade * (1.0 - p["wood_band_dark"] * band)
    base = np.array([p["brown_r"], p["brown_g"], p["brown_b"]], np.float64)
    rgb = base[None, None, :] * np.clip(shade, 0.03, 1.0)[..., None]
    rgb[..., 1] = rgb[..., 1] + p["wood_band_g"] * band * shade
    atlas = np.empty((size, size, 4), f32)
    atlas[..., 0:3] = np.clip(rgb, 0.0, 1.0)
    atlas[..., 3] = 1.0
    return atlas


def _decal_atlas(p: dict, tw: int = 64, th: int = 128) -> np.ndarray:
    """(th, tw, 4) albedo decal for the pedestal's FRONT face: the golden
    shows a thin engraved "?" outline (ball-ended hook, short stem with a
    ball, dot below) spanning most of the face width. Modeled as a thin
    darkened line (strength p["q_amp"]); geometry follows the golden's
    glyph, distances computed in world units so the line stays round on
    the non-square face. Row 0 = face bottom (v = 0), matching
    sample_atlas's iy = ry + v*rh."""
    W, H = p["ped_w"], p["ped_h"]
    # Control points measured off the zoomed golden, as (u, y-from-top)
    # face fractions -> world (x, y-up).
    def pt(u, yf):
        return np.array([u * W, (1.0 - yf) * H], np.float64)

    a = pt(0.24, 0.19)   # hook's ball tip (lower left of the loop)
    t = pt(0.52, 0.10)   # loop top
    r = pt(0.76, 0.38)   # loop's right descent
    b = pt(0.60, 0.60)   # stem end (ball)
    d = pt(0.615, 0.72)  # the dot
    # Circumcircle through a, t, r for the main loop.
    ax, ay = a; tx, ty = t; rx, ry = r
    den = 2.0 * (ax * (ty - ry) + tx * (ry - ay) + rx * (ay - ty))
    ux = ((ax**2 + ay**2) * (ty - ry) + (tx**2 + ty**2) * (ry - ay)
          + (rx**2 + ry**2) * (ay - ty)) / den
    uy = ((ax**2 + ay**2) * (rx - tx) + (tx**2 + ty**2) * (ax - rx)
          + (rx**2 + ry**2) * (tx - ax)) / den
    c = np.array([ux, uy])
    rad = np.linalg.norm(a - c)
    ang = lambda q: np.arctan2(q[1] - uy, q[0] - ux)
    aa, at, ar = ang(a), ang(t), ang(r)
    # Sweep a -> t -> r in the direction that passes t (counterclockwise
    # here because a is left, t top, r right: go up-and-over).
    def unwrap(frm, to, ccw):
        while ccw and to < frm:
            to += 2 * np.pi
        while not ccw and to > frm:
            to -= 2 * np.pi
        return to

    ccw = unwrap(aa, at, True) <= unwrap(aa, ar, True)
    at_u = unwrap(aa, at, ccw)
    ar_u = unwrap(at_u, ar, ccw)
    angs = np.linspace(aa, ar_u, 40)
    loop = np.stack([ux + rad * np.cos(angs), uy + rad * np.sin(angs)], 1)
    # Tail: quadratic Bezier from r toward b, leaving tangentially.
    tangent = loop[-1] - loop[-2]
    tangent = tangent / (np.linalg.norm(tangent) + 1e-12)
    c1 = r + tangent * 0.45 * np.linalg.norm(b - r)
    s = np.linspace(0.0, 1.0, 20)[:, None]
    tail = (1 - s) ** 2 * r + 2 * s * (1 - s) * c1 + s**2 * b
    path = np.concatenate([loop, tail], 0)

    ix = (np.arange(tw) + 0.5) / tw * W
    iy = (np.arange(th) + 0.5) / th * H
    X, Y = np.meshgrid(ix, iy)  # (th, tw)
    dist = np.full((th, tw), 1e9)
    for q0, q1 in zip(path[:-1], path[1:]):
        e = q1 - q0
        ee = float(e @ e) + 1e-18
        tt = np.clip(((X - q0[0]) * e[0] + (Y - q0[1]) * e[1]) / ee, 0, 1)
        dist = np.minimum(
            dist, np.hypot(X - (q0[0] + tt * e[0]), Y - (q0[1] + tt * e[1]))
        )
    lw = 0.0075  # line half-width, world units (thin engraved outline)
    dark = 1.0 / (1.0 + np.exp((dist - lw) / (0.35 * lw)))
    # Ball terminals and the dot: discs of ~2.2x / 2.6x the line width.
    for center, mul in ((a, 2.2), (b, 2.2), (d, 2.6)):
        dd = np.hypot(X - center[0], Y - center[1])
        dark = np.maximum(
            dark, 1.0 / (1.0 + np.exp((dd - mul * lw) / (0.35 * lw)))
        )
    atlas = np.empty((th, tw, 4), np.float32)
    atlas[..., 0:3] = np.clip(1.0 - p["q_amp"] * dark, 0.0, 1.0)[..., None]
    atlas[..., 3] = 1.0
    return atlas


def _oct_prism(cx, cz, rx, rz, total_h, yaw, tiers=((1.0, 0.42),
                                                    (0.84, 0.33),
                                                    (0.68, 0.25))):
    """Stepped octagonal plinth (the golden figurine's base): ``tiers`` is
    ((radius_scale, height_frac), ...) bottom-up; each tier is an 8-sided
    prism with a flat top cap (fan), flat outward side normals, raised by
    a hair above the tier below to avoid coplanar razor ties. Returns a
    list of (v0, v1, v2, n) triangles."""
    c, s = np.cos(yaw), np.sin(yaw)
    tris = []
    y0 = 0.0
    for scale, frac in tiers:
        h = total_h * frac
        angs = np.radians(22.5 + 45.0 * np.arange(8))
        ring = []
        for th_ in angs:
            x, z = rx * scale * np.cos(th_), rz * scale * np.sin(th_)
            ring.append((cx + c * x + s * z, cz - s * x + c * z))
        lo, hi = y0 + 1e-4, y0 + h
        for k in range(8):
            (x0, z0), (x1, z1) = ring[k], ring[(k + 1) % 8]
            n = np.array([z1 - z0, 0.0, -(x1 - x0)], np.float64)
            n /= np.linalg.norm(n)
            mid = np.array([(x0 + x1) / 2 - cx, 0.0, (z0 + z1) / 2 - cz])
            if float(n @ mid) < 0:
                n = -n
            a_, b_ = (x0, lo, z0), (x1, lo, z1)
            c_, d_ = (x1, hi, z1), (x0, hi, z0)
            tris.append((a_, b_, c_, n))
            tris.append((a_, c_, d_, n))
        top_n = np.array([0.0, 1.0, 0.0])
        for k in range(1, 7):
            tris.append((
                (ring[0][0], hi, ring[0][1]),
                (ring[k][0], hi, ring[k][1]),
                (ring[k + 1][0], hi, ring[k + 1][1]),
                top_n,
            ))
        y0 += h
    # Enforce winding so the geometric normal (cross(e1, e2), what
    # is_front tests) agrees with the stated flat normal.
    fixed = []
    for a_, b_, c_, n in tris:
        a_, b_, c_ = (np.asarray(q, np.float64) for q in (a_, b_, c_))
        if float(np.cross(b_ - a_, c_ - a_) @ n) < 0:
            b_, c_ = c_, b_
        fixed.append((a_, b_, c_, np.asarray(n, np.float64)))
    return fixed


def cornell_replica(
    include_monkey: bool = True,
    pad_to: int | None = None,
    max_leaf_size: int = 4,
    num_bins: int = 12,
    overrides: dict[str, float] | None = None,
    monkey_path: str | None = None,
) -> SceneArrays:
    """The cornell.glb reconstruction (see the module docstring).

    ``pad_to``: append degenerate (zero-area) triangles up to this count.
    ``overrides`` replaces entries of ``REPLICA_PARAMS``. Suzanne comes
    from ``monkey_path`` when ``include_monkey`` is set and that file
    exists; otherwise the scene has no Suzanne.
    """
    p = dict(REPLICA_PARAMS)
    if overrides:
        unknown = set(overrides) - set(p)
        if unknown:
            raise KeyError(f"unknown replica params: {sorted(unknown)}")
        p.update(overrides)
    (WHITE, RED, GREEN, LIGHT, GLASS, MIRROR, CHROME, MAGENTA, BROWN,
     BASEGREEN, BODY, PEDQ) = range(12)

    quads = []
    # Room (cornell2.glb parity): floor, ceiling, back; red +x, green -x.
    quads.append((_quad((-1, 0, 1), (1, 0, 1), (1, 0, -1), (-1, 0, -1)), WHITE))
    quads.append((_quad((-1, 2, -1), (1, 2, -1), (1, 2, 1), (-1, 2, 1)), WHITE))
    quads.append((_quad((-1, 0, -1), (1, 0, -1), (1, 2, -1), (-1, 2, -1)), WHITE))
    quads.append((_quad((1, 0, -1), (1, 0, 1), (1, 2, 1), (1, 2, -1)), RED))
    quads.append((_quad((-1, 0, 1), (-1, 0, -1), (-1, 2, -1), (-1, 2, 1)), GREEN))
    ly = 1.98
    quads.append(
        (_quad((-0.25, ly, -0.25), (0.25, ly, -0.25), (0.25, ly, 0.25),
               (-0.25, ly, 0.25)), LIGHT)
    )
    # Pedestal (tall white box) + glass sphere on top. The FRONT (+Z)
    # face carries the engraved-"?" decal material (uv-mapped below);
    # _box face order puts +Z at index 4.
    ped_faces = _box(
        (p["ped_cx"], p["ped_h"] / 2, p["ped_cz"]),
        (p["ped_w"], p["ped_h"], p["ped_d"]),
        yaw=np.radians(p["ped_yaw"]),
    )
    for i, face in enumerate(ped_faces):
        quads.append((face, PEDQ if i == 4 else WHITE))
    # Mirror cube (yawed enough that its visible faces reflect the coloured
    # walls, as in the golden) + white sphere resting on its rear-left top.
    for face in _box(
        (p["cube_cx"], p["cube_s"] / 2, p["cube_cz"]),
        (p["cube_s"], p["cube_s"], p["cube_s"]),
        yaw=np.radians(p["cube_yaw"]),
    ):
        quads.append((face, MIRROR))
    v0l, v1l, v2l, n0l, n1l, n2l, mat = [], [], [], [], [], [], []
    uv_patches = []  # (start_index, per-tri corner uvs) applied below

    def add_quads():
        for (tris, quv, n), m in quads:
            if m == PEDQ:
                uv_patches.append((len(v0l), quv))
            for (a, b, c), _ in zip(tris, quv):
                v0l.append(a); v1l.append(b); v2l.append(c)
                n0l.append(n); n1l.append(n); n2l.append(n)
                mat.append(m)

    def add_sphere(center, radius, m, sub=3):
        a0, a1, a2, b0, b1, b2 = icosphere(center, radius, sub)
        v0l.extend(a0); v1l.extend(a1); v2l.extend(a2)
        n0l.extend(b0); n1l.extend(b1); n2l.extend(b2)
        mat.extend([m] * len(a0))

    def add_ellipsoid(center, radius, ysc, m, sub=2):
        """Unit icosphere scaled (r, r*ysc, r): normals transform by the
        inverse scale (nx, ny/ysc, nz), renormalized."""
        a0, a1, a2, b0, b1, b2 = icosphere((0.0, 0.0, 0.0), 1.0, sub)
        ctr = np.asarray(center, np.float64)
        sc = np.array([radius, radius * ysc, radius], np.float64)
        inv = np.array([1.0, 1.0 / ysc, 1.0], np.float64)
        vlists, nlists = (v0l, v1l, v2l), (n0l, n1l, n2l)
        for vl, nl, vs, ns in zip(vlists, nlists, (a0, a1, a2), (b0, b1, b2)):
            vl.extend(vs * sc + ctr)
            nn = ns * inv
            nl.extend(nn / np.linalg.norm(nn, axis=1, keepdims=True))
        mat.extend([m] * len(a0))

    add_quads()
    # Figurine base: the golden shows a stepped dark-green OCTAGONAL
    # plinth (elongated in z), not a box.
    for a_, b_, c_, n_ in _oct_prism(
        p["fig_cx"], p["fig_cz"],
        p["fig_base_w"] * 0.62, p["fig_base_d"] * 0.62,
        p["fig_base_h"], np.radians(-10),
    ):
        v0l.append(a_); v1l.append(b_); v2l.append(c_)
        n0l.append(n_); n1l.append(n_); n2l.append(n_)
        mat.append(BASEGREEN)
    # Glass on pedestal top; glass on the mirror cube's rear-left top
    # corner (offsets relative to the cube keep it seated under fitting).
    add_sphere(
        (p["ped_cx"], p["ped_h"] + p["glass1_r"], p["ped_cz"]),
        p["glass1_r"], GLASS,
    )
    add_sphere(
        (p["cube_cx"] - 0.11, p["cube_s"] + p["glass2_r"], p["cube_cz"] - 0.12),
        p["glass2_r"], GLASS,
    )
    add_sphere(
        (p["chrome_cx"], p["chrome_r"], p["chrome_cz"]), p["chrome_r"], CHROME
    )
    # Figurine stand-in over the green base: the golden shows a DOLL —
    # short legs, an egg-shaped body with hanging arms, and a brown
    # wooden barrel HEAD (its carved text is unreproducible — the texture
    # is stripped with the blob). Legs/arms ride body_r/body_sy with
    # fixed proportions; body and head carry separate fitted materials.
    br, sy = p["fig_body_r"], p["body_sy"]
    leg_r, leg_sy = 0.33 * br, 1.5
    leg_cy = p["fig_base_h"] + leg_r * leg_sy * 0.92
    for sx_ in (-1.0, 1.0):
        add_ellipsoid(
            (p["fig_cx"] + sx_ * 0.42 * br, leg_cy, p["fig_cz"]),
            leg_r, leg_sy, BODY,
        )
    leg_top = leg_cy + leg_r * leg_sy
    body_cy = leg_top + br * sy - 0.35 * br
    add_ellipsoid((p["fig_cx"], body_cy, p["fig_cz"]), br, sy, BODY)
    for sx_ in (-1.0, 1.0):
        add_ellipsoid(
            (p["fig_cx"] + sx_ * 0.97 * br, body_cy + 0.30 * br * sy,
             p["fig_cz"]),
            0.27 * br, 1.5, BODY,
        )
    head_center = (
        p["fig_cx"],
        body_cy + br * sy + p["fig_head_r"] * 0.46,
        p["fig_cz"],
    )
    head_start = len(v0l)
    add_sphere(head_center, p["fig_head_r"], BROWN, sub=2)
    head_count = len(v0l) - head_start
    if include_monkey and monkey_path and os.path.exists(monkey_path):
        try:
            vs, ns = _load_monkey(
                monkey_path, (p["monkey_cx"], 0.0, p["monkey_cz"]),
                p["monkey_s"],
                yaw=np.radians(p["monkey_yaw"]),
            )
            v0l.extend(vs[0]); v1l.extend(vs[1]); v2l.extend(vs[2])
            n0l.extend(ns[0]); n1l.extend(ns[1]); n2l.extend(ns[2])
            mat.extend([MAGENTA] * len(vs[0]))
        except Exception:
            pass

    f32 = np.float32
    count = len(v0l)
    if pad_to is not None and pad_to > count:
        pad = pad_to - count
        z = np.zeros((pad, 3), f32)
        v0l.extend(z); v1l.extend(z); v2l.extend(z)
        n0l.extend(z); n1l.extend(z); n2l.extend(z)
        mat.extend([WHITE] * pad)

    n = len(v0l)
    # Uvs: spherical on the barrel head, planar on the pedestal's decal
    # face (every other material is unmapped, so its uvs never sample).
    # Head u from the azimuth with the wrap seam on the -z
    # (away-from-camera) side, v from height.
    uvs = [np.zeros((n, 2), f32) for _ in range(3)]
    cx, cy, cz = head_center
    r_head = p["fig_head_r"]
    for corner, verts in zip(uvs, (v0l, v1l, v2l)):
        vv = np.asarray(verts[head_start:head_start + head_count],
                        np.float64)
        u = np.arctan2(vv[:, 0] - cx, vv[:, 2] - cz) / (2 * np.pi) + 0.5
        v = np.clip((vv[:, 1] - cy) / (2 * r_head) + 0.5, 0.0, 1.0)
        corner[head_start:head_start + head_count, 0] = u
        corner[head_start:head_start + head_count, 1] = v
    for start, quv in uv_patches:
        for i, tri_uv in enumerate(quv):
            for corner, (uu, vv_) in zip(uvs, tri_uv):
                corner[start + i] = (uu, vv_)
    wood = _wood_atlas(p)
    decal = _decal_atlas(p)
    atlas = np.ones((128, 128, 4), np.float32)
    atlas[0:64, 0:64] = wood
    atlas[0:128, 64:128] = decal
    albedo_rect = np.zeros((12, 4), np.int32)
    albedo_rect[BROWN] = [0, 0, 64, 64]
    albedo_rect[PEDQ] = [64, 0, 64, 128]
    base = np.array(
        [
            [0.8, 0.8, 0.8],       # white (cornell2 mat0)
            [0.8, 0.0, 0.062],     # red (cornell2 mat1)
            [0.0, 0.801, 0.054],   # green (cornell2 mat2)
            [0.8, 0.8, 0.8],       # light (cornell2 mat3)
            [1.0, 1.0, 1.0],       # glass
            [0.9, 0.9, 0.9],       # mirror
            [0.9, 0.9, 0.9],       # chrome
            [0.85, 0.04, 0.35],    # magenta suzanne
            [p["brown_r"], p["brown_g"], p["brown_b"]],  # figurine head wood
            [p["base_r"], p["base_g"], p["base_b"]],     # figurine base
            [p["body_r"], p["body_g"], p["body_b"]],     # figurine body
            [0.8, 0.8, 0.8],       # pedestal decal face (white + "?")
        ],
        f32,
    )
    metallic = np.array([0, 0, 0, 0, 0, 1, 1, 0, 0, 0, 0, 0], f32)
    # Chrome at 0.03: the golden's ball reflects the walls/light SHARP.
    roughness = np.array(
        [0.5, 0.5, 0.5, 0.5, 0.05, 0.05, 0.03, 0.4, 0.45, 0.4, 0.45, 0.5],
        f32,
    )
    emission = np.zeros((12, 3), f32)
    emission[LIGHT] = 1.0
    estrength = np.array(
        [1, 1, 1, p["light_strength"], 1, 1, 1, 1, 1, 1, 1, 1], f32
    )
    ior = np.full(12, 1.5, f32)
    transmission = np.array([0, 0, 0, 0, 1.0, 0, 0, 0, 0, 0, 0, 0], f32)

    return finalize_scene(
        np.asarray(v0l, f32), np.asarray(v1l, f32), np.asarray(v2l, f32),
        np.asarray(n0l, f32), np.asarray(n1l, f32), np.asarray(n2l, f32),
        uvs[0], uvs[1], uvs[2],
        np.asarray(mat, np.int32),
        base, metallic, roughness, emission, estrength, ior, transmission,
        mat_albedo_rect=albedo_rect,
        atlas=atlas,
        max_leaf_size=max_leaf_size, num_bins=num_bins,
    )
