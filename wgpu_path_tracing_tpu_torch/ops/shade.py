"""Hit attributes of the winning triangle, untextured (pt.wgsl:157-227).

The counterpart of the JAX package's ``ops/shade.py`` on its untextured path:
the winner's denormalized ``tri_full`` row (models/types.py TF_* layout) is
fetched with a plain index gather, ``table[idx]`` (exact, no one-hot matmul),
and the barycentrics are recomputed with the traversal's Möller-Trumbore
expressions. Every texture slot takes its fallback, as a zero-width atlas
rect does in the reference.
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
    roughness: torch.Tensor
    metallic: torch.Tensor
    transmission: torch.Tensor
    ior: torch.Tensor
    emission: V3
    emissive_strength: torch.Tensor
    is_front: torch.Tensor


def fetch_rows(table: torch.Tensor, idx: torch.Tensor):
    """Column accessor over the rows ``table[idx]`` (an exact gather)."""
    rows = table[idx.long()]
    return lambda c: rows[:, c]


def barycentrics_from_cols(get, ro: V3, rd: V3):
    """pt.wgsl:128-156. Returns (e1, e2, u, v, w)."""
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
    return e1, e2, u, v, w


def hit_attributes_from_cols(get, ro: V3, rd: V3, t, found) -> Hit:
    """Untextured Hit from a row accessor ``get(col) -> (N,) tensor``."""
    n0 = V3(get(T.TF_N0), get(T.TF_N0 + 1), get(T.TF_N0 + 2))
    n1 = V3(get(T.TF_N1), get(T.TF_N1 + 1), get(T.TF_N1 + 2))
    n2 = V3(get(T.TF_N2), get(T.TF_N2 + 1), get(T.TF_N2 + 2))
    e1, e2, u, v, w = barycentrics_from_cols(get, ro, rd)
    position = ro + rd * t
    geom_normal = vec.normalize(vec.cross(e1, e2))
    interp_normal = vec.normalize(n0 * w + n1 * u + n2 * v)
    is_front = vec.dot(geom_normal, rd) < 0.0  # pt.wgsl:196-197
    return Hit(
        t=t,
        found=found,
        position=position,
        normal=interp_normal,
        albedo=V3(get(T.TF_BASE_COLOR), get(T.TF_BASE_COLOR + 1),
                  get(T.TF_BASE_COLOR + 2)),
        roughness=torch.clamp_min(get(T.TF_ROUGHNESS), 0.04),  # pt.wgsl:208
        metallic=get(T.TF_METALLIC),
        transmission=get(T.TF_TRANSMISSION),
        ior=get(T.TF_IOR),
        emission=V3(get(T.TF_EMISSION), get(T.TF_EMISSION + 1),
                    get(T.TF_EMISSION + 2)),
        emissive_strength=get(T.TF_EMISSIVE_STRENGTH),
        is_front=is_front,
    )
