"""Debug render modes: the counterparts of the JAX package's
``debug/modes.py``, ports of the reference's swap-in diagnostic kernels.

* ``render_bvh_depth`` (pt_bvh.wgsl:98-156): a grayscale heat map of the
  largest stack depth each pixel's ray reaches in the binary BVH, divided
  by MAX_DEPTH = 24 (pt_bvh.wgsl:3); the rays are unjittered pixel centres.
  It runs K7, the stack walk, in its depth mode (``ops/intersect.py::
  bvh_depth``): the kernel on the card, its plain version on the CPU.
* ``render_normal`` (pt_debug.wgsl:305-344): the primary hit's shading
  normal as a colour ((n + 1) / 2) on front hits, solid red on back hits,
  black on misses. The scene's intersector finds the hits (its kernel on
  the card), the plain PyTorch hit attributes shade them, as the JAX
  package runs XLA there.

Both return the raw (N, 3) row-major buffer (row 0 the bottom of the view)
and bypass the tonemap, as the reference does: the values are already
display-referred.
"""

from __future__ import annotations

import numpy as np
import torch

from wgpu_path_tracing_tpu_torch.ops import camera_rays as CAM
from wgpu_path_tracing_tpu_torch.ops import intersect as ISECT
from wgpu_path_tracing_tpu_torch.ops import shade as SHADE
from wgpu_path_tracing_tpu_torch.ops.vec import div_const

MAX_DEPTH = 24  # pt_bvh.wgsl:3


def _center_rays(cam, width: int, height: int, device=None):
    """Unjittered primary rays through the pixel centres, row-major
    (pt_bvh.wgsl:143-153), as the JAX ``_center_rays``: the direction
    forward + (u right tan(fov/2) aspect + v up tan(fov/2)), normalized.
    Returns (ro, rd) as (3, N) float32 rows."""
    f32 = np.float32
    x, y = CAM.pixel_grid(width, height, device=device)
    px = x.to(torch.float32) + 0.5
    py = y.to(torch.float32) + 0.5
    u = div_const(px, float(cam["width_f"])) * 2.0 - 1.0
    v = div_const(py, float(cam["height_f"])) * 2.0 - 1.0
    tan_half = np.tan(f32(cam["fov"]) * f32(0.5), dtype=f32)
    tan_aspect = float(f32(tan_half * f32(cam["aspect"])))

    def col(name):
        return torch.as_tensor(np.asarray(cam[name], f32),
                               device=device)[:, None]

    rd = col("forward") + ((u[None, :] * col("right")) * tan_aspect
                           + (v[None, :] * col("up")) * float(tan_half))
    rd = rd / torch.sqrt(rd[0] * rd[0] + rd[1] * rd[1] + rd[2] * rd[2])
    ro = col("position").expand_as(rd)
    return ro.contiguous(), rd.contiguous()


def render_bvh_depth(scene, cam, width: int, height: int,
                     stack_depth: int = ISECT.STACK_DEPTH):
    """The largest post-pop stack pointer of each pixel centre's walk
    through the binary BVH (``scene["bvh_aabb"]``, ``scene["bvh_meta"]``),
    over MAX_DEPTH, as an (N, 3) gray buffer."""
    ro3, rd3 = _center_rays(cam, width, height, scene["bvh_aabb"].device)
    depth = ISECT.bvh_depth(scene["bvh_aabb"], scene["bvh_meta"], ro3.T,
                            rd3.T, float(MAX_DEPTH), stack_depth)
    return torch.stack([depth, depth, depth], dim=-1)


def render_normal(scene, cam, width: int, height: int, *,
                  intersector: str = "auto", brute_max_tris: int = 512,
                  leaf_size: int = 4, slots_used=None, closest_hit=None):
    """The normal and back-face view of the pixel centres' primary hits, an
    (N, 3) buffer. The intersector is ``make_closest_hit``'s choice for
    ``intersector``, ``brute_max_tris`` and ``leaf_size``, or
    ``closest_hit`` where given; ``slots_used`` (None: the scene's mask)
    gates the texture fetches as in the main path (the normal-map slot
    moves what this view shows)."""
    ro3, rd3 = _center_rays(cam, width, height, scene["tri_isect"].device)
    if closest_hit is None:
        closest_hit = ISECT.make_closest_hit(scene, intersector,
                                             brute_max_tris, leaf_size)
    t, idx = closest_hit(ro3, rd3)
    hit = SHADE.hit_attributes(scene, ro3, rd3, t, idx, slots_used)
    nrm = hit.normal
    normal_color = torch.stack([(nrm.x + 1.0) * 0.5, (nrm.y + 1.0) * 0.5,
                                (nrm.z + 1.0) * 0.5], dim=-1)
    red = torch.tensor([1.0, 0.0, 0.0], dtype=torch.float32,
                       device=normal_color.device)
    color = torch.where(hit.is_front[:, None], normal_color, red)
    return torch.where(hit.found[:, None], color, 0.0)
