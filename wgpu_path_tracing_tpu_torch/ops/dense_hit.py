"""K1: the dense closest-hit kernel and its plain version.

The counterpart of the JAX package's ``ops/pallas_kernels.py``
(``closest_hit_brute_pallas_soa``). ``closest_hit_dense`` takes SoA rays
(6, N) [origin; direction] and ``tri_isect`` (T, 9) [v0, e1, e2] and returns
(t (N,) float32, idx (N,) int32), a miss being (inf, -1) and ties going to
the lowest index. ``closest_hit_dense_rows`` takes the origin rows (3, N)
and the direction rows (3, N) apart, as the bounce loops hold them: the
kernel reads the two row blocks through two pointers, so the rows of one
(6, N) buffer go in without a copy.

On a CUDA tensor it launches ``csrc/dense_hit.cu``; on a CPU tensor it runs
the plain version. There is no fallback between the two: a CUDA input that
the kernel cannot take raises.
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


def _check(tri_isect: torch.Tensor, ro3: torch.Tensor,
           rd3: torch.Tensor) -> None:
    for name, x in (("ro3", ro3), ("rd3", rd3)):
        if x.dim() != 2 or x.shape[0] != 3:
            raise ValueError(f"{name} must be (3, N), got {tuple(x.shape)}")
    if ro3.shape != rd3.shape:
        raise ValueError(f"ro3 {tuple(ro3.shape)} and rd3 "
                         f"{tuple(rd3.shape)} differ")
    if tri_isect.dim() != 2 or tri_isect.shape[1] != 9:
        raise ValueError(f"tri_isect must be (T, 9), got {tuple(tri_isect.shape)}")
    for name, x in (("ro3", ro3), ("rd3", rd3), ("tri_isect", tri_isect)):
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if x.device != tri_isect.device:
            raise ValueError("the rays and tri_isect are on different devices")


def _check_rays(rays: torch.Tensor) -> None:
    if rays.dim() != 2 or rays.shape[0] != 6:
        raise ValueError(f"rays must be (6, N), got {tuple(rays.shape)}")


def closest_hit_dense_rows_cuda(tri_isect: torch.Tensor, ro3: torch.Tensor,
                                rd3: torch.Tensor):
    """Launch K1 on the current stream (no synchronisation) over contiguous
    origin and direction rows (3, N), which may be row slices of one
    buffer."""
    _check(tri_isect, ro3, rd3)
    if ro3.device.type != "cuda":
        raise ValueError("closest_hit_dense_rows_cuda needs CUDA tensors")
    if not (ro3.is_contiguous() and rd3.is_contiguous()
            and tri_isect.is_contiguous()):
        raise ValueError("K1 takes contiguous ro3, rd3 and tri_isect")
    n = ro3.shape[1]
    t = torch.empty((n,), dtype=torch.float32, device=ro3.device)
    idx = torch.empty((n,), dtype=torch.int32, device=ro3.device)
    if n == 0:
        return t, idx
    err = cuda_lib.lib().wpt_dense_hit(
        ro3.data_ptr(), rd3.data_ptr(), tri_isect.data_ptr(), t.data_ptr(),
        idx.data_ptr(), n, tri_isect.shape[0], cuda_lib.stream_ptr(ro3))
    cuda_lib.check(err, "wpt_dense_hit")
    Counter.launches += 1
    return t, idx


def closest_hit_dense_cuda(tri_isect: torch.Tensor, rays: torch.Tensor):
    """Launch K1 over contiguous (6, N) rays: their origin and direction
    rows, without a copy."""
    _check_rays(rays)
    return closest_hit_dense_rows_cuda(tri_isect, rays[0:3], rays[3:6])


def closest_hit_dense_rows(tri_isect: torch.Tensor, ro3: torch.Tensor,
                           rd3: torch.Tensor):
    """K1 wrapper over origin and direction rows (3, N): the CUDA kernel
    for CUDA tensors (rows that are not contiguous are copied first), the
    plain version for CPU tensors."""
    if ro3.device.type == "cuda":
        return closest_hit_dense_rows_cuda(tri_isect, ro3.contiguous(),
                                           rd3.contiguous())
    _check(tri_isect, ro3, rd3)
    if ro3.device.type != "cpu":
        raise ValueError(f"unsupported device {ro3.device}")
    return closest_hit_brute(tri_isect, ro3.T, rd3.T)


def closest_hit_dense(tri_isect: torch.Tensor, rays: torch.Tensor):
    """K1 wrapper over (6, N) rays: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    _check_rays(rays)
    return closest_hit_dense_rows(tri_isect, rays[0:3], rays[3:6])
