"""Ray blocks: what the dispatch intersectors K4, K5 and K6 share.

The pair dispatch (``ops/pairs.py``), the phased dispatch (``ops/phased.py``)
and the round dispatch (``ops/cluster.py``) gate their work on a *block* of
``bn`` consecutive rays: a tile of triangles is tested for every lane of the
block when any lane of the block enters its box. The block is therefore part
of each function's definition (a lane that does not enter a box can still
score a hit in it through rounding, and on exact-t ties the first visited
triangle wins), and the helpers here fix it in one place:

* ``ray_limit``: the call-entry limit, ``t_max`` (or inf) on an active lane
  and -inf on an inactive one;
* ``pad_blocks``: the rays cut into (nb, bn) blocks; the last block is
  filled with lanes that enter nothing (origin 0, direction 1, limit -inf);
* ``slab_entry_div``: the box entry test with true division by the
  direction, as K4 and K6 have it (a zero component gives +-inf or NaN, and
  NaN boxes reject every lane); ``torch.minimum``/``torch.maximum``
  propagate NaN as the JAX package's ``jnp.minimum``/``jnp.maximum`` do;
* ``block_entry``: phase 1 of K4 and K6, every ray against every box,
  reduced per block to the nearest entry distance (inf: no lane enters);
  ``block_entry_cuda`` is its kernel (``csrc/blocks.cu``), and
  ``entry_table`` what K4's and K6's wrappers call: the kernel on CUDA
  tensors, ``block_entry`` on CPU tensors;
* ``count_work``: the ``visits`` counts of the plain versions;
* ``finish``: the epilogue (``idx >= num_tris`` and non-finite ``t`` become
  misses, inactive lanes return (inf, -1)).
"""

from __future__ import annotations

import math

import torch

from wgpu_path_tracing_tpu_torch.ops import cuda_lib

# Elements of the largest temporary a chunked sweep may make.
SWEEP_ELEMENTS = 1 << 23


class Counter:
    """Launches of the phase-1 kernel in this process."""

    launches = 0


def ray_limit(active, t_max, n: int, dev) -> torch.Tensor:
    limit = (torch.full((n,), math.inf, dtype=torch.float32, device=dev)
             if t_max is None else t_max)
    if active is None:
        return limit
    return torch.where(active, limit, -math.inf)


def finish(t, idx, active, num_tris):
    if num_tris is not None:
        idx = torch.where(idx >= num_tris, -1, idx)
    idx = torch.where(torch.isfinite(t), idx, -1)
    if active is not None:
        t = torch.where(active, t, math.inf)
        idx = torch.where(active, idx, -1)
    return t, idx


def count_work(visits: dict, **work) -> None:
    """Add ``work`` to the ``visits`` counts a plain version keeps."""
    for key, n in work.items():
        visits[key] = visits.get(key, 0) + int(n)


def check_rays(ro3, rd3, active, t_max, *tables) -> None:
    """Raise unless the rays are (3, N) float32, ``active`` (N,) bool,
    ``t_max`` (N,) float32, and everything lies on one device."""
    for name, x in (("ro3", ro3), ("rd3", rd3)):
        if x.dim() != 2 or x.shape[0] != 3:
            raise ValueError(f"{name} must be (3, N), got {tuple(x.shape)}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
    n = ro3.shape[1]
    if rd3.shape[1] != n:
        raise ValueError("ro3 and rd3 hold different ray counts")
    if active is not None and (active.dtype != torch.bool
                               or tuple(active.shape) != (n,)):
        raise ValueError("active must be a (N,) bool tensor")
    if t_max is not None and (t_max.dtype != torch.float32
                              or tuple(t_max.shape) != (n,)):
        raise ValueError("t_max must be a (N,) float32 tensor")
    devices = {x.device for x in (ro3, rd3, active, t_max, *tables)
               if x is not None}
    if len(devices) != 1:
        raise ValueError("the rays and the scene tables are on different "
                         "devices")


def check_table(name: str, x, cols: int) -> None:
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != cols:
        raise ValueError(f"{name} must be (rows, {cols}) float32, got "
                         f"{tuple(x.shape)} {x.dtype}")


def pad_blocks(ro3, rd3, lim0, bn: int):
    """(o, d, lim): three (nb, bn) origin rows, three direction rows and the
    (nb, bn) limits, the tail lanes of the last block filled with origin 0,
    direction 1 and limit -inf."""
    pad = (-ro3.shape[1]) % bn
    if pad:
        ro3 = torch.nn.functional.pad(ro3, (0, pad))
        rd3 = torch.nn.functional.pad(rd3, (0, pad), value=1.0)
        lim0 = torch.nn.functional.pad(lim0, (0, pad), value=-math.inf)
    o = [ro3[a].reshape(-1, bn) for a in range(3)]
    d = [rd3[a].reshape(-1, bn) for a in range(3)]
    return o, d, lim0.reshape(-1, bn)


def slab_entry_div(box, ox, oy, oz, dx, dy, dz, lim):
    """Entry test of boxes (..., 6) [min3 | max3] against rays broadcast to
    the boxes' leading shape, dividing by the direction. Returns
    (tn, enter)."""
    t1x = (box[..., 0] - ox) / dx
    t2x = (box[..., 3] - ox) / dx
    t1y = (box[..., 1] - oy) / dy
    t2y = (box[..., 4] - oy) / dy
    t1z = (box[..., 2] - oz) / dz
    t2z = (box[..., 5] - oz) / dz
    tn = torch.maximum(
        torch.maximum(torch.minimum(t1x, t2x), torch.minimum(t1y, t2y)),
        torch.minimum(t1z, t2z))
    tf = torch.minimum(
        torch.minimum(torch.maximum(t1x, t2x), torch.maximum(t1y, t2y)),
        torch.maximum(t1z, t2z))
    enter = (tf >= tn) & (tf >= 0.0) & (tn <= lim)
    return tn, enter


def sweep_chunk(lanes: int, rows_per_item: int = 1) -> int:
    """Items a chunk of a sweep may hold so that its (lanes, rows) temporary
    stays within ``SWEEP_ELEMENTS``."""
    return max(1, SWEEP_ELEMENTS // max(1, lanes * rows_per_item))


def block_entry(aabb, o, d, lim) -> torch.Tensor:
    """Phase 1 of K4 and K6: every lane of every block against every box of
    ``aabb`` (C, 6); returns (nb, C), each block's least entry distance into
    each box over the lanes that enter it, inf where none does."""
    nb, bn = lim.shape
    c = aabb.shape[0]
    out = torch.empty((nb, c), dtype=torch.float32, device=lim.device)
    ray = [x[:, :, None] for x in (*o, *d)]
    step = sweep_chunk(nb * bn)
    for lo in range(0, c, step):
        tn, enter = slab_entry_div(aabb[None, None, lo:lo + step], *ray,
                                   lim[:, :, None])
        out[:, lo:lo + step] = torch.where(enter, tn, math.inf).amin(dim=1)
    return out


def block_entry_cuda(aabb, o, d, lim) -> torch.Tensor:
    """``block_entry`` on the card (``csrc/blocks.cu``, on the current stream,
    no synchronisation): one thread block a ray block, no chunks and no
    temporaries. The same (nb, C) table, except that a least entry of zero
    may come out as -0 where ``block_entry`` gives +0; the table is only
    compared and sorted, where -0 == +0."""
    rows = (*o, *d, lim)
    if len(rows) != 7:
        raise ValueError("block_entry_cuda takes three origin rows, three "
                         "direction rows and the limits")
    if any(x.device.type != "cuda" or x.device != lim.device
           for x in (aabb, *rows)):
        raise ValueError("block_entry_cuda needs CUDA tensors on one device")
    check_table("aabb", aabb, 6)
    if lim.dim() != 2 or any(x.dtype != torch.float32
                             or x.shape != lim.shape for x in rows):
        raise ValueError("the rays and limits must be (nb, bn) float32, got "
                         f"{[tuple(x.shape) for x in rows]}")
    nb, bn = lim.shape
    c = aabb.shape[0]
    out = torch.empty((nb, c), dtype=torch.float32, device=lim.device)
    if nb == 0 or c == 0:
        return out
    aabb = aabb.contiguous()
    rows = [x.contiguous() for x in rows]
    err = cuda_lib.lib().wpt_block_entry(
        aabb.data_ptr(), *(x.data_ptr() for x in rows), out.data_ptr(), nb,
        bn, c, cuda_lib.stream_ptr(lim))
    cuda_lib.check(err, "wpt_block_entry")
    Counter.launches += 1
    return out


def entry_table(aabb, o, d, lim) -> torch.Tensor:
    """Phase 1 as K4's and K6's wrappers take it: the kernel for CUDA
    tensors, ``block_entry`` for CPU tensors."""
    if lim.device.type == "cuda":
        return block_entry_cuda(aabb, o, d, lim)
    return block_entry(aabb, o, d, lim)
