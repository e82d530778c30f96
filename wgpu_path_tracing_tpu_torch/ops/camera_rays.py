"""Primary ray generation (pt.wgsl:713-750) in the three rng modes.

Same semantics as the JAX package's ``ops/camera_rays.py``: per-pixel seed,
jittered pixel position, pinhole direction, and a thin-lens offset when the
aperture is above zero. The seed is ``seed_pixel`` in "reference" mode and
``hash_seed`` in "hash" and "stratified"; "stratified" takes the jitter and
the lens disc from R2 points (streams 1-2 and 3-4) and leaves the PCG state
as seeded. ``bounce0_lds`` gives the "stratified" mode's first-bounce BSDF
draws (streams 5 and 6-7). Buffer row 0 is the BOTTOM of the view; the PNG
writer flips.

Rays come out SoA: ``ro`` and ``rd`` are (3, N) float32, ``state`` (N,) int64.
"""

from __future__ import annotations

import numpy as np
import torch

from wgpu_path_tracing_tpu_torch.ops import rng as RNG
from wgpu_path_tracing_tpu_torch.ops.vec import div_const

PI = 3.14159265359

# rng="stratified" also draws the first bounce's lobe pick and direction
# from low-discrepancy sequences (``bounce0_lds``); the PCG state advances
# as before. A module switch, as in the JAX package, so a test can turn it
# off.
TRACE_BOUNCE0_LDS = True

_PHI1 = 0.6180339887498949  # golden ratio conjugate: the 1-D sequence


def pixel_grid(width: int, height: int, device=None, row_offset: int = 0):
    """Integer pixel coords of a (height, width) image, flattened row-major
    (buffer index = y * width + x, pt.wgsl:753). ``row_offset`` shifts y,
    so a row shard of a larger image (``parallel/shard.py``) seeds its
    pixels by their global rows."""
    y, x = torch.meshgrid(
        torch.arange(height, dtype=torch.int32, device=device) + row_offset,
        torch.arange(width, dtype=torch.int32, device=device),
        indexing="ij",
    )
    return x.reshape(-1), y.reshape(-1)


def _normalize_rows(v: torch.Tensor) -> torch.Tensor:
    """(3, N) rows divided by their length (a true division, as the JAX
    package's ``_normalize``)."""
    n = torch.sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2])
    return v / n


def bounce0_lds(x: torch.Tensor, y: torch.Tensor, frame: int) -> torch.Tensor:
    """(3, N) float32 rows [lobe, r1, r2] in [0, 1): the lobe pick from a
    per-pixel-rotated golden-ratio sequence (stream 5), the direction pair
    from the R2 point of streams 6-7 (JAX ``ops/camera_rays.py:41-59``)."""
    lobe = RNG.frac_step(RNG.rotation(x, y, 5), frame, _PHI1)
    r1, r2 = RNG.r2_point(x, y, frame, stream=6)
    return torch.stack([lobe, r1, r2])


def generate_rays(cam: dict, x: torch.Tensor, y: torch.Tensor, frame: int, *,
                  use_dof: bool, rng_mode: str = "reference"):
    """cam: ``Camera.as_pytree()`` plus float ``width_f``/``height_f``.
    Returns (ro (3, N), rd (3, N), state (N,) int64)."""
    dev = x.device
    if rng_mode == "reference":
        state = RNG.seed_pixel(x, y, frame)
    else:
        state = RNG.hash_seed(x, y, frame)
    if rng_mode == "stratified":
        jx, jy = RNG.r2_point(x, y, frame, stream=1)
    else:
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
        if rng_mode == "stratified":
            r, theta = RNG.r2_point(x, y, frame, stream=3)
        else:
            r, state = RNG.rand(state)
            theta, state = RNG.rand(state)
        rr = torch.sqrt(r) * float(f32(cam["aperture"]))
        ang = theta * (2.0 * PI)
        offset = right * (rr * torch.cos(ang))[None, :] + up * (
            rr * torch.sin(ang))[None, :]
        ro = ro + offset
        rd = _normalize_rows(focal - ro)

    return ro.contiguous(), rd.contiguous(), state
