"""K1: the dense closest-hit kernel and its plain version.

The counterpart of the JAX package's ``ops/pallas_kernels.py``
(``closest_hit_brute_pallas_soa``). ``closest_hit_dense`` takes SoA rays
(6, N) [origin; direction] and ``tri_isect`` (T, 9) [v0, e1, e2] and returns
(t (N,) float32, idx (N,) int32), a miss being (inf, -1) and ties going to
the lowest index.

On a CUDA tensor it launches ``csrc/dense_hit.cu``; on a CPU tensor it runs
``closest_hit_dense_plain``. There is no fallback between the two: a CUDA
input that the kernel cannot take raises.
"""

from __future__ import annotations

import torch

from wgpu_path_tracing_tpu_torch.ops import cuda_lib
from wgpu_path_tracing_tpu_torch.ops.intersect import closest_hit_brute


class Counter:
    """Launches of the K1 kernel in this process."""

    launches = 0


def closest_hit_dense_plain(tri_isect: torch.Tensor, rays: torch.Tensor):
    """Plain PyTorch K1 on any device: rays (6, N), tri_isect (T, 9)."""
    return closest_hit_brute(tri_isect, rays[0:3].T, rays[3:6].T)


def _check(tri_isect: torch.Tensor, rays: torch.Tensor) -> None:
    if rays.dim() != 2 or rays.shape[0] != 6:
        raise ValueError(f"rays must be (6, N), got {tuple(rays.shape)}")
    if tri_isect.dim() != 2 or tri_isect.shape[1] != 9:
        raise ValueError(f"tri_isect must be (T, 9), got {tuple(tri_isect.shape)}")
    for name, x in (("rays", rays), ("tri_isect", tri_isect)):
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
    if rays.device != tri_isect.device:
        raise ValueError("rays and tri_isect are on different devices")


def closest_hit_dense_cuda(tri_isect: torch.Tensor, rays: torch.Tensor):
    """Launch K1 on the current stream (no synchronisation)."""
    _check(tri_isect, rays)
    if rays.device.type != "cuda":
        raise ValueError("closest_hit_dense_cuda needs CUDA tensors")
    if not (rays.is_contiguous() and tri_isect.is_contiguous()):
        raise ValueError("K1 takes contiguous rays and tri_isect")
    n = rays.shape[1]
    t = torch.empty((n,), dtype=torch.float32, device=rays.device)
    idx = torch.empty((n,), dtype=torch.int32, device=rays.device)
    if n == 0:
        return t, idx
    err = cuda_lib.lib().wpt_dense_hit(
        rays.data_ptr(), tri_isect.data_ptr(), t.data_ptr(), idx.data_ptr(),
        n, tri_isect.shape[0], cuda_lib.stream_ptr(rays))
    cuda_lib.check(err, "wpt_dense_hit")
    Counter.launches += 1
    return t, idx


def closest_hit_dense(tri_isect: torch.Tensor, rays: torch.Tensor):
    """K1 wrapper: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors."""
    if rays.device.type == "cuda":
        return closest_hit_dense_cuda(tri_isect, rays.contiguous())
    _check(tri_isect, rays)
    if rays.device.type != "cpu":
        raise ValueError(f"unsupported device {rays.device}")
    return closest_hit_dense_plain(tri_isect, rays)
