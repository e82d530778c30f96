"""The bounce loop (pt.wgsl:638-709), plain PyTorch.

The counterpart of the JAX package's ``ops/trace.py``, with a Python loop in
place of ``lax.scan``:

* miss: the lane dies (black background, pt.wgsl:646-649), picking up
  the scene's environment map first where it has one (``ops/env.py``, the
  JAX package's extension),
* emissive hit: contribution x 1/(1+t^2), then the path ends
  (pt.wgsl:652-658),
* NEE only when MIS is on and the hit is front-facing and not transmissive
  (pt.wgsl:661), power-heuristic weighted (pt.wgsl:666-675),
* BSDF sampling and throughput update (pt.wgsl:680-696),
* Russian roulette from bounce 3 on the largest throughput component
  (pt.wgsl:699-705).

``bounce_core`` is the shading stage between the closest hit and the shadow
query; the CUDA bounce kernel (``csrc/bounce.cu``) runs the same steps per
thread in the same order. Textured scenes sample their atlas in the form
``scene_atlas`` picks, as the JAX package's ``trace`` does. RNG draws
happen in the reference's order with masked advancement, so every lane's
stream matches random.wgsl.
"""

from __future__ import annotations

import math
import typing

import torch

from wgpu_path_tracing_tpu_torch.ops import bsdf as BSDF
from wgpu_path_tracing_tpu_torch.ops import env as ENV
from wgpu_path_tracing_tpu_torch.ops import lights as LIGHTS
from wgpu_path_tracing_tpu_torch.ops import rng as RNG
from wgpu_path_tracing_tpu_torch.ops import shade as SHADE
from wgpu_path_tracing_tpu_torch.ops import vec
from wgpu_path_tracing_tpu_torch.ops.vec import V3

EPSILON = 1e-6


class BounceState(typing.NamedTuple):
    ro: V3
    rd: V3
    throughput: V3
    result: V3
    alive: torch.Tensor  # bool
    state: torch.Tensor  # int64 rng state


class ShadowQuery(typing.NamedTuple):
    origin: V3
    direction: V3
    t_max: torch.Tensor
    mask: torch.Tensor  # bool
    direct: V3  # premultiplied contribution, pending occlusion
    pdf: torch.Tensor


def bounce_core(st: BounceState, t, idx, bounce_idx: int, *, fetch_tri,
                fetch_light, do_mis: bool, num_lights: int, atlas=None,
                slots_used=(True, True, True, True), bsdf_override=None,
                env=None) -> tuple[BounceState, ShadowQuery]:
    """One bounce's shading. ``fetch_tri(idx)`` / ``fetch_light(idx)`` return
    column accessors over the ``tri_full`` / ``light_full`` rows; ``atlas``
    and ``slots_used`` are ``ops/shade.py::hit_attributes_from_cols``'s;
    ``bsdf_override`` is ``ops/bsdf.py::sample_bsdf``'s ``override``;
    ``env`` an ``rd -> V3`` radiance sampler (``ops/env.py::
    make_env_sampler``) added on a miss after the emissive term, or None."""
    found = st.alive & (idx >= 0)
    safe = torch.clamp_min(idx, 0)
    hit = SHADE.hit_attributes_from_cols(fetch_tri(safe), st.ro, st.rd, t,
                                         found, atlas=atlas,
                                         slots_used=slots_used)

    emissive = found & vec.any_positive(hit.emission)
    atten = hit.emissive_strength / (1.0 + t * t)
    zero3 = vec.zeros_like(t)
    result = st.result + vec.where(
        emissive, st.throughput * hit.emission * atten, zero3)
    if env is not None:
        missed = st.alive & (idx < 0)
        result = result + vec.where(missed, st.throughput * env(st.rd), zero3)

    cont = found & ~emissive

    state = st.state
    if do_mis:
        nee = cont & (hit.transmission == 0.0) & hit.is_front
        ls, state = LIGHTS.sample_light_from_fetch(
            fetch_light, hit.position, state, nee, num_lights)
        v = -vec.normalize(st.rd)
        f_light, pdf_light_bsdf = BSDF.eval_bsdf(hit, hit.normal, v, ls.wi,
                                                 hit.is_front)
        mis_w = BSDF.power_heuristic(ls.pdf, pdf_light_bsdf)
        scale = mis_w / torch.clamp_min(ls.pdf, EPSILON)
        direct = st.throughput * ls.intensity * f_light * scale
        direct = vec.where(nee & (ls.pdf > 0.0), direct, zero3)
        shadow = ShadowQuery(origin=ls.shadow_origin, direction=ls.wi,
                             t_max=ls.shadow_t_max, mask=ls.shadow_mask,
                             direct=direct, pdf=ls.pdf)
    else:
        shadow = ShadowQuery(zero3, zero3, torch.full_like(t, math.inf),
                             torch.zeros_like(found), zero3, zero3.x)

    new_dir, state = BSDF.sample_bsdf(hit, st.rd, hit.is_front, state, cont,
                                      override=bsdf_override)
    f_val, pdf = BSDF.eval_bsdf(hit, hit.normal, -vec.normalize(st.rd),
                                new_dir, hit.is_front)
    ok = cont & (pdf > 0.0)

    ro = vec.where(ok, hit.position + new_dir * EPSILON, st.ro)
    rd = vec.where(ok, vec.normalize(new_dir), st.rd)
    inv_pdf = torch.reciprocal(torch.clamp_min(pdf, EPSILON))
    throughput = vec.where(ok, st.throughput * f_val * inv_pdf, st.throughput)
    alive = ok

    rr = alive & (bounce_idx > 2)
    u, state = RNG.rand(state, rr)
    p = vec.maxcomp(throughput)
    die = rr & (u > p)
    throughput = vec.where(rr & ~die, throughput * torch.reciprocal(p),
                           throughput)
    alive = alive & ~die

    return (
        BounceState(ro=ro, rd=rd, throughput=throughput, result=result,
                    alive=alive, state=state),
        shadow,
    )


def resolve_shadow(result: V3, shadow: ShadowQuery, shadow_t) -> V3:
    """Fold the NEE contribution in where the shadow ray is unoccluded
    (occluded iff the hit t < t_max; a miss reports t = inf)."""
    occluded = shadow_t < shadow.t_max
    take = shadow.mask & ~occluded & (shadow.pdf > 0.0)
    return result + vec.where(take, shadow.direct, vec.zeros_like(shadow_t))


def scene_atlas(scene: dict):
    """(atlas, slots_used): the atlas form the bounce samples, chosen as
    the JAX package's ``trace`` chooses it (None for an untextured scene,
    whose atlas is a 1x1 placeholder; ``("fat", canvas, rects)`` when
    ``pack_device_scene`` baked a fat canvas; else the (H, W, 4) atlas,
    sampled per slot), and the scene's texture-slot mask, which
    ``models/types.py::load_jax_scene`` stores."""
    atlas, slots = scene["atlas"], scene["texture_slots_used"]
    if atlas.shape[0] <= 1 and atlas.shape[1] <= 1:
        return None, slots
    if "atlas_fat" in scene:
        return ("fat", scene["atlas_fat"], scene["atlas_fat_rects"]), slots
    return atlas, slots


def trace(scene: dict, closest_hit, ro, rd, state, *, max_bounces: int = 8,
          do_mis: bool = True, num_lights: int = 0, lds0=None):
    """Trace a batch of rays with the plain ``bounce_core``.

    ro, rd: (3, N); state: (N,) int64. ``closest_hit(ro3, rd3, ...)`` comes
    from ``ops/intersect.py::make_closest_hit``. ``lds0`` (rng="stratified"):
    (3, N) float32 rows [lobe, r1, r2] that replace the first bounce's three
    main BSDF draws (``ops/camera_rays.py::bounce0_lds``). A scene dict that
    carries a real environment map (``ops/env.py::scene_env``) lights the
    misses. Returns (radiance (3, N), final state, counters (2,) int64
    [closest rays, shadow rays])."""
    n = ro.shape[1]
    atlas, slots_used = scene_atlas(scene)
    env_map = ENV.scene_env(scene)
    env = None if env_map is None else ENV.make_env_sampler(*env_map)
    one = torch.ones((n,), dtype=torch.float32, device=ro.device)
    zero = torch.zeros_like(one)
    st = BounceState(ro=vec.from_rows(ro, 0), rd=vec.from_rows(rd, 0),
                     throughput=V3(one, one, one),
                     result=V3(zero, zero, zero),
                     alive=torch.ones((n,), dtype=torch.bool, device=ro.device),
                     state=state)
    counters = torch.zeros((2,), dtype=torch.int64, device=ro.device)

    def fetch_tri(idx):
        return SHADE.fetch_rows(scene["tri_full"], idx)

    def fetch_light(idx):
        return SHADE.fetch_rows(scene["light_full"], idx)

    for bounce_idx in range(max_bounces):
        reorder = bounce_idx > 0  # incoherent rays: the walk sorts them
        t, idx = closest_hit(vec.stack_rows(st.ro), vec.stack_rows(st.rd),
                             active=st.alive, reorder=reorder)
        counters[0] += st.alive.sum()
        override = None
        if lds0 is not None:
            override = (bounce_idx == 0, lds0[0], lds0[1], lds0[2])
        st, shadow = bounce_core(st, t, idx, bounce_idx, fetch_tri=fetch_tri,
                                 fetch_light=fetch_light, do_mis=do_mis,
                                 num_lights=num_lights, atlas=atlas,
                                 slots_used=slots_used, bsdf_override=override,
                                 env=env)
        if do_mis:
            counters[1] += shadow.mask.sum()
            shadow_t, _ = closest_hit(vec.stack_rows(shadow.origin),
                                      vec.stack_rows(shadow.direction),
                                      active=shadow.mask, t_max=shadow.t_max,
                                      any_hit=True, reorder=reorder)
            st = st._replace(result=resolve_shadow(st.result, shadow, shadow_t))
    return vec.stack_rows(st.result), st.state, counters
