"""Hit attributes of the winning triangle (pt.wgsl:157-227).

The counterpart of the JAX package's ``ops/shade.py``: the winner's
denormalized ``tri_full`` row (models/types.py TF_* layout) is fetched with
a plain index gather, ``table[idx]`` (exact, no one-hot matmul), and the
barycentrics are recomputed with the traversal's Möller-Trumbore
expressions. Textures: barycentric uv interpolation, texture-atlas fetches
with per-slot fallbacks (pt.wgsl:112-120 getTextureColor), the UV-derivative
tangent basis and the conditional normal map (applied only when the sampled
texel differs from the flat default (0.5, 0.5, 1), pt.wgsl:216-226).

The atlas takes one of three forms: ``None`` (untextured: every slot takes
its fallback, as a zero-width atlas rect does in the reference), the
``(H, W, 4)`` atlas tensor (per-slot sampling, ``sample_atlas``), or
``("fat", canvas, rects)`` (one fat-canvas row serves all four slots,
``sample_atlas_fat``). The CUDA bounce kernel (``csrc/bounce.cu``) repeats
these expressions per thread, so the two agree bit for bit on the card.
"""

from __future__ import annotations

import typing

import torch

from wgpu_path_tracing_tpu_torch.models import types as T
from wgpu_path_tracing_tpu_torch.ops import vec
from wgpu_path_tracing_tpu_torch.ops.vec import V3


class Hit(typing.NamedTuple):
    t: torch.Tensor
    found: torch.Tensor
    position: V3
    normal: V3
    albedo: V3
    alpha: torch.Tensor
    roughness: torch.Tensor
    metallic: torch.Tensor
    transmission: torch.Tensor
    ior: torch.Tensor
    emission: V3
    emissive_strength: torch.Tensor
    uv_u: torch.Tensor
    uv_v: torch.Tensor
    is_front: torch.Tensor


def fetch_rows(table: torch.Tensor, idx: torch.Tensor):
    """Column accessor over the rows ``table[idx]`` (an exact gather)."""
    rows = table[idx.long()]
    return lambda c: rows[:, c]


# Texture-slot order shared by both samplers: (albedo, pbr, emissive,
# normal) — the channel order of the fat canvas (4 channels a slot).
SLOT_RECT_COLS = (T.TF_ALBEDO_RECT, T.TF_PBR_RECT, T.TF_EMISSIVE_RECT,
                  T.TF_NORMAL_RECT)
SLOT_FALLBACKS = ((1.0, 1.0, 1.0, 1.0), (1.0, 1.0, 1.0, 1.0),
                  (1.0, 1.0, 1.0, 1.0), (0.5, 0.5, 1.0, 1.0))


def texel_index(a: torch.Tensor, size: int) -> torch.Tensor:
    """The integer texel coordinate of ``a`` on an axis of ``size`` texels:
    clipped to [0, size - 1] and truncated. A NaN coordinate (a lane whose
    barycentrics are inf or NaN, as on a dead lane reading row 0) maps to 0
    explicitly: ``torch.clamp`` keeps a NaN and its integer conversion is
    INT_MIN on x86, where CUDA's ``cvt.rzi`` and XLA give 0."""
    a = torch.where(torch.isnan(a), torch.zeros_like(a), a)
    return torch.clamp(a, 0.0, float(size - 1)).long()


def atlas_texel(rect, u, v, h: int, w: int) -> torch.Tensor:
    """The flat index (row * w + column) of the texel that the rect
    [x, y, w, h] (4 lane tensors, in pixels) gives lane uvs ``u``, ``v`` on
    an atlas of h x w texels: pt.wgsl:112-120's index math."""
    rx, ry, rw, rh = rect
    ax = rx + torch.fmod(u, 1.0) * rw
    ay = ry + torch.fmod(v, 1.0) * rh
    return texel_index(ay, h) * w + texel_index(ax, w)


def sample_atlas(atlas, rect, u, v, fallback):
    """getTextureColor (pt.wgsl:112-120).

    atlas: (H, W, 4); rect: 4 lane tensors [x, y, w, h] in pixels; u, v:
    lane uvs. Nearest-neighbour mip-0 load; WGSL ``%`` is sign-preserving
    fmod, so negative uvs index backwards; the f32->u32 conversion
    saturates at 0. A zero-width or zero-height rect takes ``fallback``.
    Returns [r, g, b, a].
    """
    texel = atlas.reshape(-1, 4)[atlas_texel(rect, u, v, atlas.shape[0],
                                             atlas.shape[1])]  # (N, 4)
    missing = (rect[2] == 0.0) | (rect[3] == 0.0)
    return [torch.where(missing, fallback[c], texel[:, c]) for c in range(4)]


def fat_rect(fat_rects, get):
    """A lane's virtual rect [x, y, w, h] on the fat canvas, found by
    matching its 16 atlas-rect values against the (S, 20) match table
    ``fat_rects`` (the last matching set wins; none gives 0, 0, 0, 0), and
    each slot's ``missing`` mask, in SLOT order."""
    rects = [[get(c + i) for i in range(4)] for c in SLOT_RECT_COLS]
    missing = [(r[2] == 0.0) | (r[3] == 0.0) for r in rects]
    vals = torch.stack([rects[k][i] for k in range(4) for i in range(4)],
                       dim=1)  # (N, 16)
    zero = torch.zeros_like(vals[:, 0])
    fx = fy = vw = vh = zero
    for s in range(fat_rects.shape[0]):
        m = (vals == fat_rects[s, :16]).all(dim=1)
        fx = torch.where(m, fat_rects[s, 16], fx)
        fy = torch.where(m, fat_rects[s, 17], fy)
        vw = torch.where(m, fat_rects[s, 18], vw)
        vh = torch.where(m, fat_rects[s, 19], vh)
    return [fx, fy, vw, vh], missing


def sample_atlas_fat(fat, fat_rects, get, uv_u, uv_v):
    """All four texture slots from ONE fat-canvas row.

    ``fat`` (FH, FW, 16) is the canvas ``models/types.py::_build_fat_atlas``
    bakes: every distinct material map set owns a virtual rect on it, each
    texel row carrying the four slots' texels at the same uv. A lane's
    virtual rect is found by matching its 16 atlas-rect values against the
    (S, 20) match table ``fat_rects``; the last matching set wins, and a
    lane matching none (an untextured material) reads canvas row 0 and
    takes every slot's fallback through its ``missing`` mask.

    Texel choice matches ``sample_atlas`` for every slot except the
    texel-boundary ulp class (floor(kx + f*kw) vs floor(fx + f*lw) //
    (lw//kw) can round across an integer on boundary-epsilon uvs).

    Returns the four [r, g, b, a] quads in SLOT order.
    """
    vrect, missing = fat_rect(fat_rects, get)
    # The index math of sample_atlas (pt.wgsl:112-120) on the virtual rect.
    row = fat.reshape(-1, 16)[atlas_texel(vrect, uv_u, uv_v, fat.shape[0],
                                          fat.shape[1])]  # (N, 16)
    return [
        [torch.where(missing[k], SLOT_FALLBACKS[k][c], row[:, 4 * k + c])
         for c in range(4)]
        for k in range(4)
    ]


def barycentrics_from_cols(get, ro: V3, rd: V3):
    """pt.wgsl:128-156. Returns (e1, e2, u, v, w, uv_u, uv_v)."""
    v0 = V3(get(T.TF_V0), get(T.TF_V0 + 1), get(T.TF_V0 + 2))
    v1 = V3(get(T.TF_V1), get(T.TF_V1 + 1), get(T.TF_V1 + 2))
    v2 = V3(get(T.TF_V2), get(T.TF_V2 + 1), get(T.TF_V2 + 2))
    e1 = v1 - v0
    e2 = v2 - v0
    hvec = vec.cross(rd, e2)
    a = vec.dot(e1, hvec)
    f = torch.reciprocal(a)
    s = ro - v0
    u = f * vec.dot(s, hvec)
    q = vec.cross(s, e1)
    v = f * vec.dot(rd, q)
    w = 1.0 - u - v
    uv_u = get(T.TF_UV0) * w + get(T.TF_UV1) * u + get(T.TF_UV2) * v
    uv_v = (get(T.TF_UV0 + 1) * w + get(T.TF_UV1 + 1) * u
            + get(T.TF_UV2 + 1) * v)
    return e1, e2, u, v, w, uv_u, uv_v


def hit_attributes_from_cols(get, ro: V3, rd: V3, t, found, atlas=None,
                             slots_used=(True, True, True, True)) -> Hit:
    """The Hit from a row accessor ``get(col) -> (N,) tensor``.

    ``atlas`` is None, the (H, W, 4) atlas or ``("fat", canvas, rects)``.
    ``slots_used`` is the scene-wide (albedo, pbr, emissive, normal) mask
    of ``models/types.py::texture_slots_used``: a slot no material maps
    takes its fallback without a fetch, which is exactly what sampling its
    all-empty rects gives."""
    n0 = V3(get(T.TF_N0), get(T.TF_N0 + 1), get(T.TF_N0 + 2))
    n1 = V3(get(T.TF_N1), get(T.TF_N1 + 1), get(T.TF_N1 + 2))
    n2 = V3(get(T.TF_N2), get(T.TF_N2 + 1), get(T.TF_N2 + 2))
    e1, e2, u, v, w, uv_u, uv_v = barycentrics_from_cols(get, ro, rd)
    position = ro + rd * t
    geom_normal = vec.normalize(vec.cross(e1, e2))
    interp_normal = vec.normalize(n0 * w + n1 * u + n2 * v)
    is_front = vec.dot(geom_normal, rd) < 0.0  # pt.wgsl:196-197

    base_color = V3(get(T.TF_BASE_COLOR), get(T.TF_BASE_COLOR + 1),
                    get(T.TF_BASE_COLOR + 2))
    metallic_f = get(T.TF_METALLIC)
    roughness_f = get(T.TF_ROUGHNESS)
    emission_f = V3(get(T.TF_EMISSION), get(T.TF_EMISSION + 1),
                    get(T.TF_EMISSION + 2))
    albedo, alpha = base_color, torch.ones_like(u)
    metallic = metallic_f
    roughness = torch.clamp_min(roughness_f, 0.04)  # pt.wgsl:208
    emission = emission_f
    normal = interp_normal

    if atlas is not None:
        if isinstance(atlas, tuple):
            _, fat, fat_rects = atlas
            quads = sample_atlas_fat(fat, fat_rects, get, uv_u, uv_v)

            def slot(k):
                return quads[k]
        else:

            def slot(k):
                rect = [get(SLOT_RECT_COLS[k] + i) for i in range(4)]
                return sample_atlas(atlas, rect, uv_u, uv_v,
                                    SLOT_FALLBACKS[k])

        if slots_used[0]:
            av = slot(0)
            albedo = V3(av[0], av[1], av[2]) * base_color
            alpha = av[3]
        if slots_used[1]:
            pv = slot(1)
            metallic = pv[2] * metallic_f
            roughness = torch.clamp_min(pv[1] * roughness_f, 0.04)
        if slots_used[2]:
            ev = slot(2)
            emission = V3(ev[0], ev[1], ev[2]) * emission_f
        if slots_used[3]:
            # Tangent basis from UV derivatives (pt.wgsl:176-189). No
            # degenerate-UV guard, as in the reference: the NaN basis is
            # consumed only where a normal-map texel is actually applied.
            duv1u = get(T.TF_UV1) - get(T.TF_UV0)
            duv1v = get(T.TF_UV1 + 1) - get(T.TF_UV0 + 1)
            duv2u = get(T.TF_UV2) - get(T.TF_UV0)
            duv2v = get(T.TF_UV2 + 1) - get(T.TF_UV0 + 1)
            r = torch.reciprocal(duv1u * duv2v - duv1v * duv2u)
            tangent = vec.normalize((e1 * duv2v - e2 * duv1v) * r)
            tn = interp_normal
            tvec = vec.normalize(tangent - tn * vec.dot(tn, tangent))
            bvec = vec.normalize(vec.cross(tn, tvec))
            nm = slot(3)
            use_nm = (nm[0] != 0.5) | (nm[1] != 0.5) | (nm[2] != 1.0)
            world_normal = vec.normalize(
                tvec * (nm[0] * 2.0 - 1.0)
                + bvec * (nm[1] * 2.0 - 1.0)
                + tn * (nm[2] * 2.0 - 1.0))
            normal = vec.where(use_nm, world_normal, interp_normal)

    return Hit(
        t=t,
        found=found,
        position=position,
        normal=normal,
        albedo=albedo,
        alpha=alpha,
        roughness=roughness,
        metallic=metallic,
        transmission=get(T.TF_TRANSMISSION),
        ior=get(T.TF_IOR),
        emission=emission,
        emissive_strength=get(T.TF_EMISSIVE_STRENGTH),
        uv_u=uv_u,
        uv_v=uv_v,
        is_front=is_front,
    )


def hit_attributes(scene: dict, ro3, rd3, t, idx, slots_used=None) -> Hit:
    """The Hit of (3, N) rays' closest hits (t, idx) in an uploaded scene,
    as the JAX package's ``hit_attributes``: each winner's ``tri_full`` row
    (row 0 on a miss, ``found`` False there), the atlas in the form
    ``ops/trace.py::scene_atlas`` picks, and the scene's texture-slot mask
    or ``slots_used``."""
    from wgpu_path_tracing_tpu_torch.ops.trace import scene_atlas

    atlas, scene_slots = scene_atlas(scene)
    get = fetch_rows(scene["tri_full"], torch.clamp_min(idx, 0))
    return hit_attributes_from_cols(
        get, vec.from_rows(ro3, 0), vec.from_rows(rd3, 0), t, idx >= 0,
        atlas, scene_slots if slots_used is None else slots_used)
