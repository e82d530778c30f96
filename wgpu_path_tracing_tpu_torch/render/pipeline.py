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
from wgpu_path_tracing_tpu_torch.utils.tiling import tile_permutation


def camera_device(cam: dict, width: int, height: int) -> dict:
    """The camera dict plus the image size as float32."""
    out = dict(cam)
    out["width_f"] = np.float32(width)
    out["height_f"] = np.float32(height)
    return out


def tile_pixels(width: int, height: int, device):
    """Pixel coords (x, y) in tile lane order."""
    x, y = CAM.pixel_grid(width, height, device=device)
    perm = torch.as_tensor(tile_permutation(width, height), device=device)
    return x[perm], y[perm]


def render_chunk(trace_fn, closest_hit, scene: dict, cam: dict,
                 accum: torch.Tensor, frame_start: int, *, n_frames: int,
                 width: int, height: int, use_dof: bool, max_bounces: int,
                 do_mis: bool, num_lights: int, firefly_clamp: float):
    """Accumulate ``n_frames`` 1-spp frames from ``frame_start`` into
    ``accum`` ((N, 3) float32, tile lane order), in place. The bounce loop
    samples the scene's atlas in the form ``ops/trace.py::scene_atlas``
    picks.

    ``trace_fn`` is the bounce loop and ``closest_hit`` the intersector it
    calls: the renderer passes ``ops/bounce.py::trace_cuda`` and
    ``ops/intersect.py::make_closest_hit``'s dense hit or walk, which run
    K2 and K1 or K3 on CUDA tensors and their plain versions on CPU
    tensors.
    Returns (accum, counters (2,) int64 [closest rays, shadow rays])."""
    dev = accum.device
    x, y = tile_pixels(width, height, dev)
    # NEE against zero lights would sample the padding row.
    do_mis = bool(do_mis) and num_lights > 0
    counters = torch.zeros((2,), dtype=torch.int64, device=dev)
    clamp = float(np.float32(firefly_clamp))
    for frame in range(frame_start, frame_start + n_frames):
        ro, rd, state = CAM.generate_rays(cam, x, y, frame, use_dof=use_dof)
        radiance, _, stats = trace_fn(scene, closest_hit, ro, rd, state,
                                      max_bounces=max_bounces, do_mis=do_mis,
                                      num_lights=num_lights)
        counters += stats
        color = torch.clamp_max(radiance.T, clamp)
        w = np.float32(1.0) / (np.float32(frame) + np.float32(1.0))
        accum.mul_(float(np.float32(1.0) - w)).add_(color * float(w))
    return accum, counters
