"""Next-event-estimation light sampling (pt.wgsl:374-489) over SoA lanes.

The counterpart of the JAX package's ``ops/lights.py::sample_light_from_fetch``
for every light type the ``light_full`` table encodes: a uniform light pick
via randInt; directional (pdf 1/N x 1000, pt.wgsl:385-406); point, ignored
beyond distance 100 with inverse-square falloff (pdf 1/N x 10000,
pt.wgsl:407-438); the spot extension (point times the KHR_lights_punctual
cone falloff); emissive triangles sampled uniformly by area with a
solid-angle pdf and no distance falloff (pt.wgsl:439-486). The shadow ray is
returned, not traced: the caller resolves occlusion.
"""

from __future__ import annotations

import math
import typing

import numpy as np
import torch

from wgpu_path_tracing_tpu_torch.models import types as T
from wgpu_path_tracing_tpu_torch.ops import rng as RNG
from wgpu_path_tracing_tpu_torch.ops import vec
from wgpu_path_tracing_tpu_torch.ops.vec import V3

EPSILON = 1e-6


class LightSample(typing.NamedTuple):
    intensity: V3
    wi: V3
    pdf: torch.Tensor
    shadow_origin: V3
    shadow_t_max: torch.Tensor  # inf on directional lanes
    shadow_mask: torch.Tensor  # lanes that need the shadow query


def sample_light_from_fetch(fetch, hit_position: V3, state, mask,
                            num_lights: int):
    """``fetch(idx)(col)`` returns ``light_full`` columns for per-lane light
    indices. The pick advances every lane in ``mask``; the two triangle
    draws advance only lanes that picked an emissive light."""
    count = max(num_lights, 1)
    idx, state = RNG.rand_int(state, 0, count - 1, mask)
    get = fetch(idx)

    ltype = get(T.LF_TYPE).to(torch.int32)
    lcolor = V3(get(T.LF_COLOR), get(T.LF_COLOR + 1), get(T.LF_COLOR + 2))
    lint = get(T.LF_INTENSITY)
    lpos = V3(get(T.LF_POSITION), get(T.LF_POSITION + 1), get(T.LF_POSITION + 2))

    is_dir = ltype == T.LIGHT_TYPE_DIRECTIONAL
    is_spot = ltype == T.LIGHT_TYPE_SPOT
    is_point = (ltype == T.LIGHT_TYPE_POINT) | is_spot
    is_emis = ltype == T.LIGHT_TYPE_EMISSIVE

    r1, state = RNG.rand(state, mask & is_emis)
    r2, state = RNG.rand(state, mask & is_emis)

    wi_dir = vec.normalize(-lpos)

    to_light_p = lpos - hit_position
    dist_p = vec.length(to_light_p)
    point_far = is_point & (dist_p > 100.0)
    wi_point = to_light_p * torch.reciprocal(torch.clamp_min(dist_p, 1e-30))

    v0 = V3(get(T.LF_V0), get(T.LF_V0 + 1), get(T.LF_V0 + 2))
    v1 = V3(get(T.LF_V1), get(T.LF_V1 + 1), get(T.LF_V1 + 2))
    v2 = V3(get(T.LF_V2), get(T.LF_V2 + 1), get(T.LF_V2 + 2))
    n0 = V3(get(T.LF_N0), get(T.LF_N0 + 1), get(T.LF_N0 + 2))
    n1 = V3(get(T.LF_N1), get(T.LF_N1 + 1), get(T.LF_N1 + 2))
    n2 = V3(get(T.LF_N2), get(T.LF_N2 + 1), get(T.LF_N2 + 2))
    sq = torch.sqrt(r1)
    su = 1.0 - sq
    sv = r2 * sq
    sw = 1.0 - su - sv
    light_pos = v0 * sw + v1 * su + v2 * sv
    lnormal = vec.normalize(n0 * sw + n1 * su + n2 * sv)
    to_light_e = light_pos - hit_position
    dist_e = vec.length(to_light_e)
    wi_emis = to_light_e * torch.reciprocal(torch.clamp_min(dist_e, 1e-30))

    wi = vec.where(is_dir, wi_dir, vec.where(is_point, wi_point, wi_emis))
    dist = torch.where(is_point, dist_p, dist_e)

    inv_n = np.float32(1.0) / np.float32(count)
    pdf_dir = float(inv_n * np.float32(1000.0))  # pt.wgsl:406
    pdf_point = float(inv_n * np.float32(10000.0))  # pt.wgsl:438
    e1 = v1 - v0
    e2 = v2 - v0
    area = vec.length(vec.cross(e1, e2)) * 0.5
    cos_theta = torch.abs(vec.dot(lnormal, -wi))
    # Zero-area rows (the padding row of a lightless scene) give pdf 0.
    inv_area = torch.where(area > 0.0,
                           torch.reciprocal(torch.clamp_min(area, 1e-30)), 0.0)
    pdf_emis = float(inv_n) * inv_area * (
        dist_e * dist_e / torch.clamp_min(cos_theta, EPSILON))

    int_dir = lcolor * lint
    att = torch.reciprocal(dist_p * dist_p)
    spot_dir = V3(get(T.LF_SPOT_DIR), get(T.LF_SPOT_DIR + 1),
                  get(T.LF_SPOT_DIR + 2))
    cd = vec.dot(spot_dir, -wi_point)
    spot_t = torch.clamp(cd * get(T.LF_SPOT_SCALE) + get(T.LF_SPOT_OFFSET),
                         0.0, 1.0)
    att = att * torch.where(is_spot, spot_t * spot_t, 1.0)
    int_point = lcolor * (lint * att)
    int_emis = lcolor * lint

    pdf = torch.where(is_dir, pdf_dir, torch.where(is_point, pdf_point, pdf_emis))
    intensity = vec.where(is_dir, int_dir,
                          vec.where(is_point, int_point, int_emis))

    dead = point_far | ~mask
    pdf = torch.where(dead, 0.0, pdf)
    intensity = vec.where(dead, vec.zeros_like(pdf), intensity)

    shadow_mask = mask & ~point_far
    shadow_origin = hit_position + wi * EPSILON
    t_max = torch.where(is_dir, math.inf, dist - EPSILON * 2.0)
    return (
        LightSample(intensity=intensity, wi=wi, pdf=pdf,
                    shadow_origin=shadow_origin, shadow_t_max=t_max,
                    shadow_mask=shadow_mask),
        state,
    )
