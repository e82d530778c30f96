"""K5: the phased flat group dispatch, its plain version and its wrapper.

The counterpart of the JAX package's ``ops/phased.py``
(``closest_hit_phased``, kernel ``_phased_kernel``). It reads the walk's leaf
table ``walk_tris`` (``accel/bvh8.py``) and ignores the hierarchy: rays are
SoA (3, N) origins and directions, the result is (t (N,) float32,
idx (N,) int32), a miss being (inf, -1).

* Phase 1: every leaf sub-cluster box (rows 16..31 of each group, lanes
  0..5) is gated for each block of ``bn`` rays: the gate is set when any
  lane of the block enters the box under its *call-entry* limit (``t_max``
  or inf on an active lane, -inf on an inactive one). The entry test is the
  walk's, ``ops/walk.py::slab_entry``, with its 1e-30 stand-in for a zero
  direction component. Nothing tightens the limits along the way.
* Phase 2: in ascending group order, then ascending sub-cluster order, each
  gated sub-cluster runs Möller-Trumbore over its 8 slots for every lane of
  the block (least t, ties to the lowest triangle index; padding slots have
  index -1) and replaces the lane's best on a strict ``<``.

``any_hit`` is accepted and ignored, as in the JAX package. Its TPU
machinery (the gate bits packed into SMEM words, the unrolled group loop and
the group padding both need) is not carried over. The tail lanes of the last
block enter nothing.

On a CUDA tensor ``closest_hit_phased`` launches ``csrc/phased.cu`` (a gate
kernel, then a test kernel); on a CPU tensor it runs
``closest_hit_phased_plain``. There is no fallback between the two.
"""

from __future__ import annotations

import math

import torch

from wgpu_path_tracing_tpu_torch.accel.bvh8 import LEAF_SLOTS, SUB, group_rows
from wgpu_path_tracing_tpu_torch.ops import blocks, cuda_lib
from wgpu_path_tracing_tpu_torch.ops.intersect import moller_trumbore
from wgpu_path_tracing_tpu_torch.ops.walk import TINY, slab_entry

BN = 2048  # rays in a block
GROUP_ROWS = group_rows(SUB)
SUB_W = LEAF_SLOTS // SUB
SUB_ROW = 16  # first sub-cluster box row of a group
WARP = 32  # csrc/phased.cu votes by warp, so a block holds whole warps


class Counter:
    """Launches of the K5 kernels (one gate and one test kernel a call) in
    this process."""

    launches = 0


def _check(walk_tris, ro3, rd3, active, t_max, bn: int) -> None:
    blocks.check_rays(ro3, rd3, active, t_max, walk_tris)
    blocks.check_table("walk_tris", walk_tris, LEAF_SLOTS)
    if walk_tris.shape[0] % GROUP_ROWS:
        raise ValueError(f"walk_tris must hold {GROUP_ROWS} rows a group")
    if bn <= 0 or bn % WARP:
        raise ValueError(f"bn must be a positive multiple of {WARP}")


def sub_gates(groups, o, d, lim) -> torch.Tensor:
    """Phase 1: (nb, Ng, SUB) bool, set where any lane of the block enters
    the sub-cluster's box under its call-entry limit."""
    nb, bn = lim.shape
    ng = groups.shape[0]
    inv = [torch.reciprocal(torch.where(x == 0.0, TINY, x)) for x in d]
    ray = [x[:, None, None, :] for x in (*o, *inv)]
    boxes = groups[:, SUB_ROW:SUB_ROW + SUB, 0:6]  # (Ng, SUB, 6)
    gates = torch.empty((nb, ng, SUB), dtype=torch.bool, device=lim.device)
    step = blocks.sweep_chunk(nb * bn, SUB)
    for lo in range(0, ng, step):
        _, enter = slab_entry(boxes[None, lo:lo + step, :, None, :], *ray,
                              lim[:, None, None, :])
        gates[:, lo:lo + step] = enter.any(dim=3)
    return gates


def closest_hit_phased_plain(walk_tris, ro3, rd3, active=None, t_max=None,
                             num_tris: int | None = None,
                             any_hit: bool = False, bn: int = BN,
                             visits: dict | None = None):
    """Plain PyTorch K5 on any device: a group at a time, over the blocks
    that a gate of the group is set for, every sub-cluster of the group
    tested and the ungated ones masked out. ``visits``, where given, gains
    the work the kernel does: the "blocks" of ``bn`` rays, the "sub_boxes"
    gated in phase 1 (one slab test for each lane of the block), the
    "sub_clusters" whose gate is set and their "triangle_tests" (a test for
    each filled slot and each lane of the block)."""
    del any_hit
    dev = ro3.device
    n = ro3.shape[1]
    lim0 = blocks.ray_limit(active, t_max, n, dev)
    o, d, lim = blocks.pad_blocks(ro3, rd3, lim0, bn)
    nb = lim.shape[0]
    groups = walk_tris.view(-1, GROUP_ROWS, LEAF_SLOTS)
    gates = sub_gates(groups, o, d, lim)
    if visits is not None:
        filled = (groups[:, 9].view(-1, SUB, SUB_W) >= 0.0).sum(dim=2)
        visits.update(
            blocks=nb, sub_boxes=nb * groups.shape[0] * SUB,
            sub_clusters=int(gates.sum()),
            triangle_tests=int((gates * filled[None]).sum()) * bn)
    best_t = torch.full((nb, bn), math.inf, dtype=torch.float32, device=dev)
    best_i = torch.full((nb, bn), -1, dtype=torch.int32, device=dev)
    subs = torch.arange(SUB, device=dev)
    for g in range(groups.shape[0]):
        gate = gates[:, g]
        sel = torch.nonzero(gate.any(dim=1)).squeeze(1)
        if sel.numel() == 0:
            continue
        tri = groups[g, 0:10].view(10, SUB, SUB_W, 1)
        t, _, _, valid = moller_trumbore(
            *(x[sel][:, None, None, :] for x in (*o, *d)), *tri[0:9])
        gidx = tri[9]
        valid = valid & (gidx >= 0.0)
        t = torch.where(valid, t, math.inf)
        sub_t = t.min(dim=2).values  # (g, SUB, bn)
        sub_i = torch.where(t == sub_t[:, :, None], gidx, math.inf).min(
            dim=2).values
        # The sub-clusters merge in ascending order with a strict <: the
        # group's winner is the least t, ties to the lowest sub-cluster.
        sub_t = torch.where(gate[sel][:, :, None], sub_t, math.inf)
        min_t = sub_t.min(dim=1).values
        first = torch.where(sub_t == min_t[:, None], subs[None, :, None],
                            SUB).min(dim=1).values
        min_i = sub_i.gather(1, first[:, None]).squeeze(1)
        cur = best_t[sel]
        better = min_t < cur
        best_t[sel] = torch.where(better, min_t, cur)
        best_i[sel] = torch.where(better, min_i.to(torch.int32), best_i[sel])
    return blocks.finish(best_t.reshape(-1)[:n], best_i.reshape(-1)[:n],
                         active, num_tris)


def closest_hit_phased_cuda(walk_tris, ro3, rd3, active=None, t_max=None,
                            num_tris: int | None = None,
                            any_hit: bool = False, bn: int = BN):
    """Launch K5's two kernels on the current stream (no synchronisation):
    the gates of every (block, sub-cluster) into a byte table, then one
    thread a ray through the gated sub-clusters."""
    del any_hit
    _check(walk_tris, ro3, rd3, active, t_max, bn)
    if ro3.device.type != "cuda":
        raise ValueError("closest_hit_phased_cuda needs CUDA tensors")
    n = ro3.shape[1]
    dev = ro3.device
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    idx = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return t, idx
    ro3, rd3 = ro3.contiguous(), rd3.contiguous()
    walk_tris = walk_tris.contiguous()
    lim0 = blocks.ray_limit(active, t_max, n, dev).contiguous()
    active = None if active is None else active.contiguous()
    ng = walk_tris.shape[0] // GROUP_ROWS
    nb = -(-n // bn)
    gates = torch.zeros((nb, ng * SUB), dtype=torch.uint8, device=dev)
    err = cuda_lib.lib().wpt_phased(
        walk_tris.data_ptr(), ro3.data_ptr(), rd3.data_ptr(),
        lim0.data_ptr(), None if active is None else active.data_ptr(),
        gates.data_ptr(), t.data_ptr(), idx.data_ptr(), n, bn, ng,
        -1 if num_tris is None else int(num_tris), cuda_lib.stream_ptr(ro3))
    cuda_lib.check(err, "wpt_phased")
    Counter.launches += 1
    return t, idx


def closest_hit_phased(walk_tris, ro3, rd3, active=None, t_max=None,
                       num_tris: int | None = None, any_hit: bool = False,
                       bn: int = BN):
    """K5 wrapper: the CUDA kernels for CUDA tensors, the plain version for
    CPU tensors."""
    if ro3.device.type == "cuda":
        return closest_hit_phased_cuda(walk_tris, ro3, rd3, active, t_max,
                                       num_tris, any_hit, bn)
    _check(walk_tris, ro3, rd3, active, t_max, bn)
    if ro3.device.type != "cpu":
        raise ValueError(f"unsupported device {ro3.device}")
    return closest_hit_phased_plain(walk_tris, ro3, rd3, active, t_max,
                                    num_tris, any_hit, bn)
