"""K2: the bounce megakernel, its plain version, and the loop that drives it.

The counterpart of the JAX package's ``ops/pallas_bounce.py``
(``bounce_stage_pallas`` / ``trace_pallas``), untextured or textured, with
the bounce-0 low-discrepancy override of rng="stratified". ``bounce_stage``
takes one bounce's SoA state and returns the same ten arrays as
``bounce_stage_pallas``:

    in:  rays (6, N) f32, state (N,) int64, throughput (3, N), result (3, N),
         alive (N,) bool, t (N,) f32, idx (N,) int32,
         tri_full (T, 52) f32, light_full (L, 27) f32,
         atlas: None, the (H, W, 4) f32 atlas (per-slot sampling) or
         ("fat", canvas (FH, FW, 16) f32, rects (S, 20) f32),
         slots_used: the scene's 4 texture-slot flags,
         lds: None or (3, N) f32 rows [lobe, r1, r2] that replace the BSDF
         sample's three main draws at bounce 0 (ignored at other bounces),
         env: None or (map (H, W, 3) f32, params (2,) f32 [intensity,
         rotation]): the environment map that lights the misses
    out: next rays (6, N), state, throughput, result, alive,
         shadow rays (6, N), shadow t_max (N,), shadow mask (N,) bool,
         direct (3, N), pdf (N,)

The atlas forms replace the TPU kernel's three texture modes (in-VMEM
per-slot, in-VMEM fat, and "external", where XLA gathers the texels before
the kernel): on the card a texel is one load, so the fat canvas, when the
scene has one, and the per-slot atlas otherwise are read inside the kernel.
The TPU kernel's ``has_lds`` operand is one more template flag: the host
knows the bounce, so the LDS instantiation launches at bounce 0 only and the
other bounces run the kernel without it. An environment map is a third
flag, ``ENV``: the JAX package lights misses on its XLA bounce only (its
Pallas kernel has no map), so here the miss term of ``ops/trace.py::
bounce_core`` (``ops/env.py``) runs inside K2 where a scene has a map, and
scenes without one run the instruction stream they ran before.

On a CUDA tensor it launches ``csrc/bounce.cu``; on a CPU tensor it runs
``bounce_stage_plain`` (``ops/trace.py::bounce_core`` over the same arrays).
"""

from __future__ import annotations

import torch

from wgpu_path_tracing_tpu_torch.models import types as T
from wgpu_path_tracing_tpu_torch.ops import cuda_lib
from wgpu_path_tracing_tpu_torch.ops import env as ENV
from wgpu_path_tracing_tpu_torch.ops import shade as SHADE
from wgpu_path_tracing_tpu_torch.ops import trace as TRACE
from wgpu_path_tracing_tpu_torch.ops import vec


class Counter:
    """Launches of the K2 kernel in this process, in all (``launches``), by
    texture mode (``by_mode``: "none", "per_slot", "fat"), and those of them
    that ran the bounce-0 LDS instantiation (``lds``) and the environment
    map's (``env``)."""

    launches = 0
    by_mode = {"none": 0, "per_slot": 0, "fat": 0}
    lds = 0
    env = 0

    @classmethod
    def reset(cls) -> None:
        cls.launches = 0
        cls.by_mode = dict.fromkeys(cls.by_mode, 0)
        cls.lds = 0
        cls.env = 0


# csrc/bounce.cu's TexMode values.
TEX_MODES = {"none": 0, "per_slot": 1, "fat": 2}


def texture_mode(atlas) -> str:
    """"none", "per_slot" or "fat" for an atlas operand."""
    if atlas is None:
        return "none"
    return "fat" if isinstance(atlas, tuple) else "per_slot"


def bounce_stage_plain(bounce_idx: int, rays, state, throughput, result,
                       alive, t, idx, tri_full, light_full, *, do_mis: bool,
                       num_lights: int, atlas=None,
                       slots_used=(True, True, True, True), lds=None,
                       env=None):
    """Plain PyTorch K2 on any device."""
    override = None
    if lds is not None:
        override = (int(bounce_idx) == 0, lds[0], lds[1], lds[2])
    st = TRACE.BounceState(
        ro=vec.from_rows(rays, 0), rd=vec.from_rows(rays, 3),
        throughput=vec.from_rows(throughput, 0),
        result=vec.from_rows(result, 0), alive=alive, state=state)
    new, shadow = TRACE.bounce_core(
        st, t, idx, int(bounce_idx),
        fetch_tri=lambda i: SHADE.fetch_rows(tri_full, i),
        fetch_light=lambda i: SHADE.fetch_rows(light_full, i),
        do_mis=do_mis, num_lights=num_lights, atlas=atlas,
        slots_used=slots_used, bsdf_override=override,
        env=None if env is None else ENV.make_env_sampler(*env))
    return [
        torch.cat([vec.stack_rows(new.ro), vec.stack_rows(new.rd)]),
        new.state,
        vec.stack_rows(new.throughput),
        vec.stack_rows(new.result),
        new.alive,
        torch.cat([vec.stack_rows(shadow.origin),
                   vec.stack_rows(shadow.direction)]),
        shadow.t_max,
        shadow.mask,
        vec.stack_rows(shadow.direct),
        shadow.pdf,
    ]


_SPEC = (  # name, rows (0 = 1-D), dtype
    ("rays", 6, torch.float32), ("state", 0, torch.int64),
    ("throughput", 3, torch.float32), ("result", 3, torch.float32),
    ("alive", 0, torch.bool), ("t", 0, torch.float32), ("idx", 0, torch.int32),
)


def _check_table(name, x, dev, shape):
    """A contiguous float32 table on ``dev`` whose shape matches ``shape``
    (None for any size), aligned for the kernel's 16-byte loads."""
    if (x.dim() != len(shape)
            or any(s is not None and s != d for s, d in zip(shape, x.shape))
            or x.dtype != torch.float32 or x.device != dev
            or not x.is_contiguous() or x.data_ptr() % 16):
        dims = ", ".join("*" if d is None else str(d) for d in shape)
        raise ValueError(f"{name}: expected contiguous ({dims}) float32 on "
                         f"{dev}, got {tuple(x.shape)} {x.dtype} on "
                         f"{x.device}")


def _atlas_args(atlas, dev):
    """(mode, atlas, h, w, rects, n_sets) arguments of the C launcher."""
    mode = texture_mode(atlas)
    if mode == "none":
        return TEX_MODES[mode], None, 0, 0, None, 0
    if mode == "fat":
        tag, canvas, rects = atlas
        if tag != "fat":
            raise ValueError(f"unknown atlas form {tag!r}")
        _check_table("atlas_fat", canvas, dev, (None, None, 16))
        _check_table("atlas_fat_rects", rects, dev, (None, 20))
        if not 1 <= rects.shape[0] <= T.FAT_ATLAS_MAX_SETS:
            raise ValueError(f"atlas_fat_rects: {rects.shape[0]} sets, "
                             f"expected 1..{T.FAT_ATLAS_MAX_SETS}")
        return (TEX_MODES[mode], canvas.data_ptr(), canvas.shape[0],
                canvas.shape[1], rects.data_ptr(), rects.shape[0])
    _check_table("atlas", atlas, dev, (None, None, 4))
    return (TEX_MODES[mode], atlas.data_ptr(), atlas.shape[0],
            atlas.shape[1], None, 0)


def bounce_stage_cuda(bounce_idx: int, rays, state, throughput, result, alive,
                      t, idx, tri_full, light_full, *, do_mis: bool,
                      num_lights: int, atlas=None,
                      slots_used=(True, True, True, True), lds=None,
                      env=None):
    """Launch K2 on the current stream (no synchronisation): the LDS
    instantiation when ``lds`` is given at bounce 0, else the plain one;
    the ``ENV`` instantiation when ``env`` holds a real map."""
    n = rays.shape[1]
    dev = rays.device
    if dev.type != "cuda":
        raise ValueError("bounce_stage_cuda needs CUDA tensors")
    for (name, rows, dtype), x in zip(
            _SPEC, (rays, state, throughput, result, alive, t, idx)):
        shape = (rows, n) if rows else (n,)
        if tuple(x.shape) != shape or x.dtype != dtype:
            raise ValueError(f"{name}: expected {shape} {dtype}, got "
                             f"{tuple(x.shape)} {x.dtype}")
        if x.device != dev or not x.is_contiguous():
            raise ValueError(f"{name}: must be contiguous on {dev}")
    # The kernel reads tri_full's rows as 16-byte loads.
    _check_table("tri_full", tri_full, dev, (None, T.TF_COLS))
    if (light_full.dim() != 2 or light_full.shape[1] != T.LF_COLS
            or light_full.dtype != torch.float32 or light_full.device != dev
            or not light_full.is_contiguous()):
        raise ValueError(f"light_full: expected contiguous (rows, "
                         f"{T.LF_COLS}) float32 on {dev}")
    if light_full.shape[0] < max(num_lights, 1):
        raise ValueError("light_full has fewer rows than num_lights")
    if len(slots_used) != 4:
        raise ValueError("slots_used: expected 4 flags")
    tex = _atlas_args(atlas, dev)
    slots = sum(1 << k for k, used in enumerate(slots_used) if used)
    use_lds = lds is not None and int(bounce_idx) == 0
    if use_lds and (tuple(lds.shape) != (3, n) or lds.dtype != torch.float32
                    or lds.device != dev or not lds.is_contiguous()):
        raise ValueError(f"lds: expected contiguous (3, {n}) float32 on "
                         f"{dev}, got {tuple(lds.shape)} {lds.dtype} on "
                         f"{lds.device}")
    env_args = (None, 0, 0, None)
    if env is not None and ENV.has_env(env[0]):
        env_map, env_params = env
        if (env_map.dim() != 3 or env_map.shape[2] != 3
                or env_map.dtype != torch.float32 or env_map.device != dev
                or not env_map.is_contiguous()):
            raise ValueError(f"env: expected a contiguous (H, W, 3) float32 "
                             f"map on {dev}, got {tuple(env_map.shape)} "
                             f"{env_map.dtype} on {env_map.device}")
        if (tuple(env_params.shape) != (2,)
                or env_params.dtype != torch.float32
                or env_params.device != dev):
            raise ValueError(f"env params: expected (2,) float32 on {dev}")
        env_args = (env_map.data_ptr(), env_map.shape[0], env_map.shape[1],
                    env_params.data_ptr())

    def empty(rows, dtype):
        return torch.empty((rows, n) if rows else (n,), dtype=dtype, device=dev)

    outs = [empty(6, torch.float32), empty(0, torch.int64),
            empty(3, torch.float32), empty(3, torch.float32),
            empty(0, torch.bool), empty(6, torch.float32),
            empty(0, torch.float32), empty(0, torch.bool),
            empty(3, torch.float32), empty(0, torch.float32)]
    if n == 0:
        return outs
    err = cuda_lib.lib().wpt_bounce(
        int(bounce_idx), rays.data_ptr(), state.data_ptr(),
        throughput.data_ptr(), result.data_ptr(), alive.data_ptr(),
        t.data_ptr(), idx.data_ptr(), tri_full.data_ptr(),
        light_full.data_ptr(), int(num_lights),
        int(bool(do_mis)), *tex, slots, lds.data_ptr() if use_lds else None,
        *env_args, *(o.data_ptr() for o in outs), n,
        cuda_lib.stream_ptr(rays))
    cuda_lib.check(err, "wpt_bounce")
    Counter.launches += 1
    Counter.by_mode[texture_mode(atlas)] += 1
    Counter.lds += int(use_lds)
    Counter.env += int(env_args[0] is not None)
    return outs


def bounce_stage(bounce_idx: int, rays, state, throughput, result, alive, t,
                 idx, tri_full, light_full, *, do_mis: bool, num_lights: int,
                 atlas=None, slots_used=(True, True, True, True), lds=None,
                 env=None):
    """K2 wrapper: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors."""
    fn = {"cuda": bounce_stage_cuda, "cpu": bounce_stage_plain}.get(
        rays.device.type)
    if fn is None:
        raise ValueError(f"unsupported device {rays.device}")
    return fn(bounce_idx, rays, state, throughput, result, alive, t, idx,
              tri_full, light_full, do_mis=do_mis, num_lights=num_lights,
              atlas=atlas, slots_used=slots_used, lds=lds, env=env)


def trace_cuda(scene: dict, closest_hit, ro, rd, state, *,
               max_bounces: int = 8, do_mis: bool = True, num_lights: int = 0,
               lds0=None):
    """The bounce loop over the K2 wrapper (``trace_pallas``'s shape): per
    bounce a closest hit, K2, a shadow query and ``resolve_shadow``. Same
    signature, semantics and RNG streams as ``ops/trace.py::trace``, the
    atlas form, the environment map and ``lds0`` included
    (``ops/trace.py::scene_atlas``, ``ops/env.py::scene_env``); K2 gets
    ``lds0`` at bounce 0 only. On CPU tensors the wrappers run their plain
    versions."""
    n = ro.shape[1]
    atlas, slots_used = TRACE.scene_atlas(scene)
    env = ENV.scene_env(scene)
    dev = ro.device
    rays = torch.cat([ro, rd]).contiguous()
    thr = torch.ones((3, n), dtype=torch.float32, device=dev)
    res = torch.zeros((3, n), dtype=torch.float32, device=dev)
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    counters = torch.zeros((2,), dtype=torch.int64, device=dev)
    for bounce_idx in range(max_bounces):
        reorder = bounce_idx > 0  # incoherent rays: the walk sorts them
        t, idx = closest_hit(rays[0:3], rays[3:6], active=alive,
                             reorder=reorder)
        counters[0] += alive.sum()
        (rays, state, thr, res, alive, srays, stmax, smask, sdirect,
         spdf) = bounce_stage(bounce_idx, rays, state, thr, res, alive, t, idx,
                              scene["tri_full"], scene["light_full"],
                              do_mis=do_mis, num_lights=num_lights,
                              atlas=atlas, slots_used=slots_used,
                              lds=lds0 if bounce_idx == 0 else None, env=env)
        if do_mis:
            counters[1] += smask.sum()
            shadow_t, _ = closest_hit(srays[0:3], srays[3:6], active=smask,
                                      t_max=stmax, any_hit=True,
                                      reorder=reorder)
            shadow = TRACE.ShadowQuery(
                origin=vec.from_rows(srays, 0),
                direction=vec.from_rows(srays, 3), t_max=stmax, mask=smask,
                direct=vec.from_rows(sdirect, 0), pdf=spdf)
            res = vec.stack_rows(
                TRACE.resolve_shadow(vec.from_rows(res, 0), shadow, shadow_t))
    return res, state, counters
