"""Environment lighting: an equirectangular map that rays leaving the scene
pick up, the JAX package's extension over the reference's miss -> black
(pt.wgsl:646-649), which stays the default.

The counterpart of the JAX package's ``ops/env.py``. ``make_env_sampler`` is
the plain version of the miss term that K2 (``csrc/bounce.cu``, its ``ENV``
instantiation) computes on the card, in the same order: the nearest texel
(the reference's textureLoad convention, pt.wgsl:119) of the normalized
direction's azimuth (``atan2``, turned by the rotation) and polar angle
(``acos``). The map adds only on a miss: NEE and MIS are untouched, so a
map never changes the radiance of rays that hit geometry. A 1x1 map means
"no map".
"""

from __future__ import annotations

import numpy as np
import torch

from wgpu_path_tracing_tpu_torch.ops import vec
from wgpu_path_tracing_tpu_torch.ops.vec import V3

TWO_PI = float(np.float32(2.0 * np.pi))
INV_PI = float(np.float32(1.0 / np.pi))


def has_env(env) -> bool:
    """Whether an (H, W, 3) map is a real one (either side above 1)."""
    return env is not None and (env.shape[0] > 1 or env.shape[1] > 1)


def scene_env(scene: dict):
    """(map, params) of a scene dict that carries a real map, else None.
    ``params`` is the (2,) float32 tensor [intensity, rotation in
    radians]."""
    env = scene.get("env")
    return (env, scene["env_params"]) if has_env(env) else None


def env_tables(env: np.ndarray, intensity: float, rotation: float,
               device) -> dict:
    """The scene-dict entries of a map: ``env`` (H, W, 3) and
    ``env_params`` [intensity, rotation], float32 on ``device``."""
    return {
        "env": torch.as_tensor(np.ascontiguousarray(env, np.float32),
                               device=device),
        "env_params": torch.tensor([intensity, rotation], dtype=torch.float32,
                                   device=device),
    }


def env_texel(rd: V3, h: int, w: int, rotation):
    """(iy, ix) int64: the texel of an (h, w) equirect map that direction
    ``rd`` reads (the plain version of ``csrc/bounce.cu::env_texel``)."""
    d = vec.normalize(rd)
    u = vec.div_const(torch.atan2(d.z, d.x) + rotation, TWO_PI)
    u = u - torch.floor(u)  # wrap to [0, 1)
    v = torch.acos(torch.clamp(d.y, -1.0, 1.0)) * INV_PI
    ix = torch.clamp((u * w).to(torch.int32), 0, w - 1)
    iy = torch.clamp((v * h).to(torch.int32), 0, h - 1)
    return iy.long(), ix.long()


def make_env_sampler(env, params):
    """``rd -> V3`` radiance of an equirect map, or None for the 1x1
    placeholder. env: (H, W, 3) float32; params: (2,) [intensity,
    rotation]."""
    if not has_env(env):
        return None
    h, w = env.shape[0], env.shape[1]
    intensity, rotation = params[0], params[1]

    def sample(rd: V3) -> V3:
        iy, ix = env_texel(rd, h, w, rotation)
        texel = env[iy, ix]  # (N, 3)
        return V3(texel[..., 0] * intensity, texel[..., 1] * intensity,
                  texel[..., 2] * intensity)

    return sample


def load_env_image(source) -> np.ndarray:
    """An environment image as (H, W, 3) float32 linear radiance.

    ``source``: a NumPy array (used as it is), a Radiance .hdr, an
    uncompressed float OpenEXR (.exr, as ``utils/image.py::read_exr``
    takes it), or a PNG or a sequential or progressive JPEG
    (``utils/image.py::read_png``, told apart by their bytes), decoded from sRGB with gamma 2.2 (the
    reference's texture convention, atlas.ts:143-147)."""
    from wgpu_path_tracing_tpu_torch.utils import image

    if isinstance(source, np.ndarray):
        arr = np.asarray(source, np.float32)
        if arr.ndim != 3 or arr.shape[2] < 3:
            raise ValueError(
                f"environment array must be (H, W, >=3); got {arr.shape}")
        return np.ascontiguousarray(arr[:, :, :3])
    lower = str(source).lower()
    if lower.endswith(".hdr"):
        return image.read_hdr(source)
    if lower.endswith(".exr"):
        return image.read_exr(source)
    ldr = image.read_png(source)
    return np.power(ldr[:, :, :3], 2.2, dtype=np.float32)
