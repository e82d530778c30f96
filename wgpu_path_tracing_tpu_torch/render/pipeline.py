"""Progressive render pipeline (renderer.ts:415-454).

The counterpart of the JAX package's ``render/pipeline.py::render_chunk``:
each frame is one sample per pixel, traced, clamped (pt.wgsl:751) and folded
into an HDR running mean (pt.wgsl:753-761: mix(prev, color, 1/(frame+1)); at
frame 0 the weight is 1, the reference's overwrite). The buffer keeps the
32x32 tile lane order of ``utils/tiling.py``, as the JAX package's does.
Ray counters are int64 on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from wgpu_path_tracing_tpu_torch.ops import camera_rays as CAM
from wgpu_path_tracing_tpu_torch.ops import trace as TRACE
from wgpu_path_tracing_tpu_torch.ops.bounce import trace_cuda
from wgpu_path_tracing_tpu_torch.render.config import BOUNCE_KERNELS
from wgpu_path_tracing_tpu_torch.utils.tiling import tile_permutation


def camera_device(cam: dict, width: int, height: int) -> dict:
    """The camera dict plus the image size as float32."""
    out = dict(cam)
    out["width_f"] = np.float32(width)
    out["height_f"] = np.float32(height)
    return out


def make_trace_fn(bounce_kernel: str, device):
    """The bounce loop that ``RenderConfig.bounce_kernel`` names, for
    scenes on ``device`` (the JAX package's ``make_trace_fn``):

    * "auto" and "pallas": ``ops/bounce.py::trace_cuda``, K2 on a CUDA
      device. On the CPU it runs K2's plain version: under "pallas" that
      is the port's counterpart of the JAX package's interpret mode (the
      caller asked for the CPU), not a fallback;
    * "xla": ``ops/trace.py::trace``, the plain bounce, on either device
      (no K2 launch).

    An environment map changes nothing here: K2 has its ``ENV``
    instantiation, so "pallas" stays K2, where the JAX package's Pallas
    megakernel has no environment term and its "pallas" falls back to XLA
    with a warning. The intersector is the caller's choice either way."""
    if bounce_kernel not in BOUNCE_KERNELS:
        raise ValueError(f"bounce_kernel={bounce_kernel!r}: expected one of "
                         f"{BOUNCE_KERNELS}")
    if torch.device(device).type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return TRACE.trace if bounce_kernel == "xla" else trace_cuda


def tile_pixels(width: int, height: int, device):
    """Pixel coords (x, y) in tile lane order."""
    x, y = CAM.pixel_grid(width, height, device=device)
    perm = torch.as_tensor(tile_permutation(width, height), device=device)
    return x[perm], y[perm]


def _lanes(parts):
    """Per-frame lane tensors joined along the lanes (no copy for one)."""
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)


def render_chunk(trace_fn, closest_hit, scene: dict, cam: dict,
                 accum: torch.Tensor, frame_start: int, *, n_frames: int,
                 width: int, height: int, use_dof: bool, max_bounces: int,
                 do_mis: bool, num_lights: int, firefly_clamp: float,
                 rng_mode: str = "reference", frames_per_trace: int = 1,
                 m2: torch.Tensor | None = None):
    """Accumulate ``n_frames`` 1-spp frames from ``frame_start`` into
    ``accum`` ((N, 3) float32, tile lane order), in place; with ``m2``
    (the same shape) fold each frame's clamped colour squared into that
    running mean too, with the same weights (adaptive sampling's warmup,
    ``render/adaptive.py``), which leaves ``accum`` as it would be. The
    bounce loop samples the scene's atlas in the form
    ``ops/trace.py::scene_atlas`` picks.

    ``trace_fn`` is the bounce loop and ``closest_hit`` the intersector it
    calls: the renderer passes the loop ``make_trace_fn`` picks for its
    ``bounce_kernel`` and the intersector ``ops/intersect.py::
    make_closest_hit`` picked (K1, K3, K4, K5 or K6), which run their
    kernels on CUDA tensors and their plain versions on CPU tensors.

    ``rng_mode`` seeds and jitters the camera rays
    (``ops/camera_rays.py::generate_rays``); under "stratified" (and
    ``TRACE_BOUNCE0_LDS``) the first bounce's BSDF draws come from
    ``bounce0_lds``. ``frames_per_trace`` (F, dividing ``n_frames``) puts F
    frames' rays into one trace call of F x N lanes, their LDS rows
    concatenated along the lanes, and applies the running mean per frame in
    order: every lane is traced alone, and K4's and K6's ray blocks (1,024)
    and K5's (2,048) divide N at the image sizes they serve, so the image
    equals F = 1's except the razor-tie class: the pair route packs and
    sorts a call of 16,384 lanes or more across the frames, and K4 settles
    an exact-t tie in its blocks' visit order.
    Returns (accum, counters (2,) int64 [closest rays, shadow rays])."""
    fpt = int(frames_per_trace)
    if fpt < 1 or n_frames % fpt:
        raise ValueError(f"frames_per_trace={fpt} must be >= 1 and divide "
                         f"n_frames={n_frames}")
    dev = accum.device
    x, y = tile_pixels(width, height, dev)
    n = x.shape[0]
    # NEE against zero lights would sample the padding row.
    do_mis = bool(do_mis) and num_lights > 0
    lds_active = rng_mode == "stratified" and CAM.TRACE_BOUNCE0_LDS
    counters = torch.zeros((2,), dtype=torch.int64, device=dev)
    clamp = float(np.float32(firefly_clamp))
    for base in range(frame_start, frame_start + n_frames, fpt):
        frames = range(base, base + fpt)
        parts = [CAM.generate_rays(cam, x, y, f, use_dof=use_dof,
                                   rng_mode=rng_mode) for f in frames]
        ro, rd, state = (_lanes(p) for p in zip(*parts))
        lds0 = None
        if lds_active:
            lds0 = _lanes([CAM.bounce0_lds(x, y, f) for f in frames])
        radiance, _, stats = trace_fn(scene, closest_hit, ro, rd, state,
                                      max_bounces=max_bounces, do_mis=do_mis,
                                      num_lights=num_lights, lds0=lds0)
        counters += stats
        for i, frame in enumerate(frames):
            color = torch.clamp_max(radiance[:, i * n:(i + 1) * n].T, clamp)
            w = np.float32(1.0) / (np.float32(frame) + np.float32(1.0))
            accum.mul_(float(np.float32(1.0) - w)).add_(color * float(w))
            if m2 is not None:
                m2.mul_(float(np.float32(1.0) - w)).add_(color * color
                                                         * float(w))
    return accum, counters
