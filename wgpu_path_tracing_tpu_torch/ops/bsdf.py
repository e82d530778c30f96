"""BSDF evaluation and sampling over SoA lanes.

The counterpart of the JAX package's ``ops/bsdf.py``, with the same
reference quirks: metallic/roughness GGX with Smith geometry and
Fresnel-Schlick (pt.wgsl:316-345), cosine and GGX half-vector sampling
(pt.wgsl:299-364), the constructTBN frame (pt.wgsl:624-634), lobe-select
sampling whose Fresnel draw happens only where refraction is possible
(pt.wgsl:498-546), and an evaluation whose transmission lobe returns the
lobe probability as its pdf and whose pdf is floored at EPSILON
(pt.wgsl:548-614). Every lane computes every lobe and selects.
"""

from __future__ import annotations

import torch

from wgpu_path_tracing_tpu_torch.ops import rng as RNG
from wgpu_path_tracing_tpu_torch.ops import vec
from wgpu_path_tracing_tpu_torch.ops.vec import V3, div_const

PI = 3.14159265359  # pt.wgsl:3
EPSILON = 1e-6


def reflect(e: V3, n: V3) -> V3:
    """WGSL reflect(e, n) = e - 2*dot(e, n)*n."""
    return e - n * (2.0 * vec.dot(e, n))


def refract(e: V3, n: V3, eta) -> V3:
    """WGSL refract(e, n, eta); the zero vector when k < 0."""
    cos_i = vec.dot(n, e)
    k = 1.0 - eta * eta * (1.0 - cos_i * cos_i)
    out = e * eta - n * (eta * cos_i + torch.sqrt(torch.clamp_min(k, 0.0)))
    return vec.where(k < 0.0, vec.zeros_like(k), out)


def construct_tbn(n: V3):
    """constructTBN (pt.wgsl:624-634): (T, B, N)."""
    use_y = torch.abs(n.x) > 0.9
    zeros = torch.zeros_like(n.x)
    ones = torch.ones_like(n.x)
    t0 = V3(torch.where(use_y, zeros, ones), torch.where(use_y, ones, zeros),
            zeros)
    b = vec.normalize(vec.cross(n, t0))
    t = vec.normalize(vec.cross(b, n))
    return t, b, n


def distribution_ggx(n: V3, h: V3, roughness):
    """pt.wgsl:316-325."""
    a = roughness * roughness
    a2 = a * a
    ndoth = torch.clamp_min(vec.dot(n, h), 0.0)
    denom = ndoth * ndoth * (a2 - 1.0) + 1.0
    return torch.clamp_min(a2 / (PI * denom * denom), 0.0)


def geometry_schlick_ggx(ndotv, roughness):
    """pt.wgsl:328-332."""
    r = roughness + 1.0
    k = div_const(r * r, 8.0)
    return ndotv / (ndotv * (1.0 - k) + k)


def geometry_smith(n: V3, v: V3, l: V3, roughness):
    """pt.wgsl:334-340."""
    ndotv = torch.clamp_min(vec.dot(n, v), 0.0)
    ndotl = torch.clamp_min(vec.dot(n, l), 0.0)
    return geometry_schlick_ggx(ndotv, roughness) * geometry_schlick_ggx(
        ndotl, roughness)


def _pow5(x):
    """x**5 as the JAX package's multiply chain."""
    x2 = x * x
    return x2 * x2 * x


def fresnel_schlick(cos_theta, f0: V3) -> V3:
    """pt.wgsl:343-345."""
    p = _pow5(1.0 - cos_theta)
    return V3(f0.x + (1.0 - f0.x) * p, f0.y + (1.0 - f0.y) * p,
              f0.z + (1.0 - f0.z) * p)


def reflectance(cos_theta, eta):
    """Schlick dielectric reflectance (pt.wgsl:616-620)."""
    r0 = (1.0 - eta) / (1.0 + eta)
    r0 = r0 * r0
    return r0 + (1.0 - r0) * _pow5(1.0 - cos_theta)


def cosine_direction(normal: V3, r1, r2) -> V3:
    """randomCosineDirection in the normal frame (pt.wgsl:299-307)."""
    z = torch.sqrt(1.0 - r2)
    phi = 2.0 * PI * r1
    sq = torch.sqrt(r2)
    x = torch.cos(phi) * sq
    y = torch.sin(phi) * sq
    t, b, n = construct_tbn(normal)
    return t * x + b * y + n * z


def sample_ggx_normal(normal: V3, roughness, r1, r2) -> V3:
    """sampleGGXNormal (pt.wgsl:348-364)."""
    a = roughness * roughness
    phi = 2.0 * PI * r1
    cos_t = torch.sqrt((1.0 - r2) / (1.0 + (a * a - 1.0) * r2))
    sin_t = torch.sqrt(1.0 - cos_t * cos_t)
    lx = sin_t * torch.cos(phi)
    ly = sin_t * torch.sin(phi)
    t, b, n = construct_tbn(normal)
    return vec.normalize(t * lx + b * ly + n * cos_t)


def eval_bsdf(hit, normal: V3, v: V3, l: V3, front):
    """evalBSDF (pt.wgsl:548-614). Returns (bsdf V3, pdf)."""
    h = vec.normalize(v + l)
    ndotl = torch.clamp_min(vec.dot(normal, l), 0.0)
    ndotv = torch.clamp_min(vec.dot(normal, v), 0.0)
    ndoth = torch.clamp_min(vec.dot(normal, h), 0.0)
    vdoth = torch.clamp_min(vec.dot(v, h), 0.0)

    m = hit.metallic
    f0 = V3((1.0 - m) * 0.04 + hit.albedo.x * m,
            (1.0 - m) * 0.04 + hit.albedo.y * m,
            (1.0 - m) * 0.04 + hit.albedo.z * m)
    f = fresnel_schlick(vdoth, f0)
    g = geometry_smith(normal, v, l, hit.roughness)
    d = distribution_ggx(normal, h, hit.roughness)

    kd_scale = 1.0 - hit.transmission
    spec_scale = (g * d) / torch.clamp_min(4.0 * ndotv * ndotl, EPSILON)
    diffuse = V3(div_const((1.0 - f.x) * kd_scale * hit.albedo.x, PI),
                 div_const((1.0 - f.y) * kd_scale * hit.albedo.y, PI),
                 div_const((1.0 - f.z) * kd_scale * hit.albedo.z, PI))
    specular = f * spec_scale

    bsdf_r = (diffuse + specular) * ndotl
    diffuse_prob = (1.0 - m) * (1.0 - hit.transmission)
    specular_prob = m
    diffuse_pdf = div_const(ndotl, PI)
    specular_pdf = d * ndoth / (4.0 * vdoth)
    pdf_r = diffuse_prob * diffuse_pdf + specular_prob * specular_pdf

    eta = torch.where(front, torch.reciprocal(hit.ior), hit.ior)
    cos_theta = vec.dot(normal, v)
    f_trans = reflectance(torch.abs(cos_theta), eta)
    bsdf_t = hit.albedo * (1.0 - f_trans)
    pdf_t = (1.0 - m) * hit.transmission

    is_trans = hit.transmission > 0.0
    bsdf = vec.where(is_trans, bsdf_t, bsdf_r)
    pdf = torch.where(is_trans, pdf_t, pdf_r)
    return bsdf, torch.clamp_min(pdf, EPSILON)


def sample_bsdf(hit, rd: V3, front, state, mask, override=None):
    """sampleBSDF (pt.wgsl:498-546). Returns (direction V3, new state).

    Draws on lanes in ``mask``: lobe select, two direction draws, and the
    Fresnel draw only on transmission lanes that can refract.

    ``override`` (rng="stratified", bounce 0): a (gate, lobe, r1, r2) tuple.
    Where ``gate`` (a bool or a bool tensor) holds, the three main draws'
    values are replaced; the state advances exactly as without it, so the
    Fresnel draw, Russian roulette and later bounces keep their stream."""
    v = -vec.normalize(rd)
    diffuse_prob = (1.0 - hit.metallic) * (1.0 - hit.transmission)
    specular_prob = hit.metallic

    r, state = RNG.rand(state, mask)
    r1, state = RNG.rand(state, mask)
    r2, state = RNG.rand(state, mask)
    if override is not None:
        gate, o_r, o_r1, o_r2 = override
        if isinstance(gate, torch.Tensor):
            r = torch.where(gate, o_r, r)
            r1 = torch.where(gate, o_r1, r1)
            r2 = torch.where(gate, o_r2, r2)
        elif gate:
            r, r1, r2 = o_r, o_r1, o_r2

    lobe_d = r < diffuse_prob
    lobe_s = (~lobe_d) & (r < diffuse_prob + specular_prob)
    lobe_t = (~lobe_d) & (~lobe_s)

    dir_d = cosine_direction(hit.normal, r1, r2)

    rough = torch.clamp_min(hit.roughness, 0.04)  # pt.wgsl:518
    h_s = sample_ggx_normal(hit.normal, rough, r1, r2)
    dir_s = reflect(-v, h_s)

    eta = torch.where(front, torch.reciprocal(hit.ior), hit.ior)
    n_t = vec.where(front, h_s, -h_s)
    cos_theta = vec.dot(n_t, v)
    sin_theta = torch.sqrt(torch.clamp_min(1.0 - cos_theta * cos_theta, 0.0))
    cannot_refract = eta * sin_theta > 1.0
    f = reflectance(torch.abs(cos_theta), eta)
    r3, state = RNG.rand(state, mask & lobe_t & ~cannot_refract)
    do_reflect = cannot_refract | (r3 < f)
    dir_t = vec.where(do_reflect, reflect(-v, n_t), refract(-v, n_t, eta))

    direction = vec.where(lobe_d, dir_d, vec.where(lobe_s, dir_s, dir_t))
    return direction, state


def power_heuristic(f_pdf, g_pdf):
    """MIS power heuristic with unit sample counts (pt.wgsl:492-496)."""
    f2 = f_pdf * f_pdf
    return f2 / (f2 + g_pdf * g_pdf)
