"""Primary ray generation (pt.wgsl:713-750), reference rng.

Same semantics as the JAX package's ``ops/camera_rays.py``: per-pixel PCG
seed, jittered pixel position, pinhole direction, and a thin-lens offset when
the aperture is above zero (two more draws per pixel). Buffer row 0 is the
BOTTOM of the view; the PNG writer flips.

Rays come out SoA: ``ro`` and ``rd`` are (3, N) float32, ``state`` (N,) int64.
"""

from __future__ import annotations

import numpy as np
import torch

from wgpu_path_tracing_tpu_torch.ops import rng as RNG
from wgpu_path_tracing_tpu_torch.ops.vec import div_const

PI = 3.14159265359


def pixel_grid(width: int, height: int, device=None):
    """Integer pixel coords of a (height, width) image, flattened row-major
    (buffer index = y * width + x, pt.wgsl:753)."""
    y, x = torch.meshgrid(
        torch.arange(height, dtype=torch.int32, device=device),
        torch.arange(width, dtype=torch.int32, device=device),
        indexing="ij",
    )
    return x.reshape(-1), y.reshape(-1)


def _normalize_rows(v: torch.Tensor) -> torch.Tensor:
    """(3, N) rows divided by their length (a true division, as the JAX
    package's ``_normalize``)."""
    n = torch.sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2])
    return v / n


def generate_rays(cam: dict, x: torch.Tensor, y: torch.Tensor, frame: int, *,
                  use_dof: bool):
    """cam: ``Camera.as_pytree()`` plus float ``width_f``/``height_f``.
    Returns (ro (3, N), rd (3, N), state (N,) int64)."""
    dev = x.device
    state = RNG.seed_pixel(x, y, frame)
    jx, state = RNG.rand(state)
    jy, state = RNG.rand(state)
    px = x.to(torch.float32) + jx
    py = y.to(torch.float32) + jy

    u = div_const(px, float(cam["width_f"])) * 2.0 - 1.0
    v = div_const(py, float(cam["height_f"])) * 2.0 - 1.0

    f32 = np.float32
    tan_half = np.tan(f32(cam["fov"]) * f32(0.5), dtype=f32)
    tan_aspect = float(f32(tan_half * f32(cam["aspect"])))

    def col(name):
        return torch.as_tensor(np.asarray(cam[name], f32), device=dev)[:, None]

    pos, fwd, right, up = col("position"), col("forward"), col("right"), col("up")
    rd = _normalize_rows(
        fwd + (u[None, :] * right) * tan_aspect
        + (v[None, :] * up) * float(tan_half)
    )
    ro = pos.expand_as(rd)

    if use_dof:
        focal = pos + rd * float(f32(cam["focus_distance"]))
        r, state = RNG.rand(state)
        theta, state = RNG.rand(state)
        rr = torch.sqrt(r) * float(f32(cam["aperture"]))
        ang = theta * (2.0 * PI)
        offset = right * (rr * torch.cos(ang))[None, :] + up * (
            rr * torch.sin(ang))[None, :]
        ro = ro + offset
        rd = _normalize_rows(focal - ro)

    return ro.contiguous(), rd.contiguous(), state
