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

The kernel (``csrc/phased.cu``) reads ``PhasedTables``, made once a scene
by ``phased_tables``: the leaf groups as the walk's 16-byte records
(``ops/walk.py::leaf_records``) and whether every sub-cluster holds its
triangles in ascending index order (``slots_ascending``), which lets it
drop the index compare of the tie rule. Its gate tests each group's union
box (``group_union``, ``union_may_enter``) before the group's sub-boxes;
``gate_scheme`` is that scheme in PyTorch, with the slab tests it needs.

On a CUDA tensor ``closest_hit_phased`` launches ``csrc/phased.cu`` (a gate
kernel, then a test kernel); on a CPU tensor it runs
``closest_hit_phased_plain``, which reads ``PhasedTables.tris`` only. There
is no fallback between the two.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from wgpu_path_tracing_tpu_torch.accel.bvh8 import LEAF_SLOTS, SUB, group_rows
from wgpu_path_tracing_tpu_torch.ops import blocks, cuda_lib
from wgpu_path_tracing_tpu_torch.ops.intersect import moller_trumbore
from wgpu_path_tracing_tpu_torch.ops.walk import (
    LEAF_FLOATS,
    TINY,
    leaf_records,
    slab_entry,
)

BN = 2048  # rays in a block
GROUP_ROWS = group_rows(SUB)
SUB_W = LEAF_SLOTS // SUB
SUB_ROW = 16  # first sub-cluster box row of a group
WARP = 32  # csrc/phased.cu votes by warp, so a block holds whole warps
GATE_GROUPS = 16  # leaf groups a CTA of csrc/phased.cu's gate kernel
MAX_GRID_Y = 65535  # CUDA's limit on a grid's second dimension


class Counter:
    """Launches of the K5 kernels (one gate and one test kernel a call) in
    this process."""

    launches = 0


class PhasedTables(NamedTuple):
    tris: torch.Tensor  # walk_tris (Ng * 32, 128) float32
    leaves: torch.Tensor  # (Ng, LEAF_FLOATS) float32, leaf_records(tris)
    ordered: bool  # slots_ascending(tris).all()


def slots_ascending(walk_tris) -> torch.Tensor:
    """(Ng, SUB) bool: the sub-cluster's filled slots (index >= 0) hold
    non-decreasing triangle indices in slot order, and its padding slots
    have zero edges (so their determinant is 0 or NaN and no ray hits them).
    Where every sub-cluster passes, one strict ``<`` over the slots in order
    picks the least t with ties to the lowest index, the plain version's
    rule, without comparing indices."""
    groups = walk_tris.view(-1, GROUP_ROWS, LEAF_SLOTS)
    idx = groups[:, 9].reshape(-1, SUB, SUB_W)
    filled = idx >= 0.0
    seen = torch.where(filled, idx, -math.inf).cummax(dim=2).values
    before = torch.cat([torch.full_like(seen[..., :1], -math.inf),
                        seen[..., :-1]], dim=2)
    ordered = (~filled | (before <= idx)).all(dim=2)
    edges = groups[:, 3:9].reshape(-1, 6, SUB, SUB_W)
    still = (filled[:, None] | (edges == 0.0)).all(dim=1).all(dim=2)
    return ordered & still


def phased_tables(walk_tris) -> PhasedTables:
    """The kernel's tables of a scene's ``walk_tris``, made once a scene."""
    return PhasedTables(walk_tris, leaf_records(walk_tris),
                        bool(slots_ascending(walk_tris).all()))


def _check(walk_tris, ro3, rd3, active, t_max, bn: int) -> None:
    blocks.check_rays(ro3, rd3, active, t_max, walk_tris)
    blocks.check_table("walk_tris", walk_tris, LEAF_SLOTS)
    if walk_tris.shape[0] % GROUP_ROWS:
        raise ValueError(f"walk_tris must hold {GROUP_ROWS} rows a group")
    if bn <= 0 or bn % WARP:
        raise ValueError(f"bn must be a positive multiple of {WARP}")


def group_union(groups):
    """Each group's union box, (Ng, 6) [lo3 | hi3]: the least and greatest
    corner coordinate over its filled sub-boxes (those without a NaN
    bound), exactly (inf, -inf: no filled sub-box); and the (Ng, SUB) mask
    of filled sub-boxes."""
    boxes = groups[:, SUB_ROW:SUB_ROW + SUB, 0:6]
    filled = ~torch.isnan(boxes).any(dim=2)
    lo = torch.minimum(boxes[..., 0:3], boxes[..., 3:6])
    hi = torch.maximum(boxes[..., 0:3], boxes[..., 3:6])
    lo = torch.where(filled[..., None], lo, math.inf).amin(dim=1)
    hi = torch.where(filled[..., None], hi, -math.inf).amax(dim=1)
    return torch.cat([lo, hi], dim=1), filled


def union_may_enter(box, ox, oy, oz, ix, iy, iz, lim):
    """The gate's group pre-test: ``slab_entry``'s terms, failing only on a
    comparison that fails for certain, so a NaN term (0 x inf: the origin on
    a plane of the box and 1/d infinite) passes. A ray that enters a
    sub-box under ``lim`` passes its group's union box: each term
    (x - o) * (1/d) is monotone in the plane x, so the union's entry is no
    later and its exit no earlier, or a term is NaN."""
    t1x = (box[..., 0] - ox) * ix
    t2x = (box[..., 3] - ox) * ix
    t1y = (box[..., 1] - oy) * iy
    t2y = (box[..., 4] - oy) * iy
    t1z = (box[..., 2] - oz) * iz
    t2z = (box[..., 5] - oz) * iz
    tn = torch.maximum(
        torch.maximum(torch.minimum(t1x, t2x), torch.minimum(t1y, t2y)),
        torch.minimum(t1z, t2z))
    tf = torch.minimum(
        torch.minimum(torch.maximum(t1x, t2x), torch.maximum(t1y, t2y)),
        torch.maximum(t1z, t2z))
    return ~(tf < tn) & ~(tf < 0.0) & ~(tn > lim)


def _lanes_tested(enter: torch.Tensor) -> torch.Tensor:
    """Tests a sweep over the last dimension makes, lane by lane, up to the
    first lane that enters (all of them where none does)."""
    first = enter.to(torch.uint8).argmax(dim=-1) + 1
    return torch.where(enter.any(dim=-1), first, enter.shape[-1])


def _inverse(d):
    return [torch.reciprocal(torch.where(x == 0.0, TINY, x)) for x in d]


def gate_scheme(groups, o, d, lim):
    """The gate kernel's scheme on rays cut into blocks (``pad_blocks``):
    each group's union box first (groups with a filled sub-box), then the
    filled sub-boxes of the groups that a lane of the block may enter,
    against the lanes that may enter the union only (a lane that fails it
    enters no sub-box of the group). Returns (the gates, (nb, Ng, SUB) bool,
    the slab tests the scheme needs on these rays, each sweep stopping at
    the first lane that enters)."""
    nb, bn = lim.shape
    ng = groups.shape[0]
    union, filled = group_union(groups)
    inv = _inverse(d)
    ray = [x[:, None, :] for x in (*o, *inv)]  # (nb, 1, bn)
    sub_ray = [x[:, None, None, :] for x in (*o, *inv)]
    gates = torch.empty((nb, ng, SUB), dtype=torch.bool, device=lim.device)
    tests = 0
    step = blocks.sweep_chunk(nb * bn, SUB)
    for lo in range(0, ng, step):
        hi = min(lo + step, ng)
        may = union_may_enter(union[None, lo:hi, None, :], *ray,
                              lim[:, None, :])  # (nb, groups, bn)
        entered = may.any(dim=2)
        has = filled[lo:hi].any(dim=1)
        tests += int((_lanes_tested(may) * has).sum())
        boxes = groups[lo:hi, SUB_ROW:SUB_ROW + SUB, 0:6]
        _, enter = slab_entry(boxes[None, :, :, None, :], *sub_ray,
                              lim[:, None, None, :])
        swept = entered[:, :, None] & filled[None, lo:hi]
        # The lanes that may enter the union, up to the sweep's last lane.
        upto = may.to(torch.int32).cumsum(dim=2).gather(
            2, _lanes_tested(enter) - 1)
        tests += int((upto * swept).sum())
        gates[:, lo:hi] = enter.any(dim=3) & swept
    return gates, tests


def sub_gates(groups, o, d, lim) -> torch.Tensor:
    """Phase 1: (nb, Ng, SUB) bool, set where any lane of the block enters
    the sub-cluster's box under its call-entry limit."""
    nb, bn = lim.shape
    ng = groups.shape[0]
    ray = [x[:, None, None, :] for x in (*o, *_inverse(d))]
    boxes = groups[:, SUB_ROW:SUB_ROW + SUB, 0:6]  # (Ng, SUB, 6)
    gates = torch.empty((nb, ng, SUB), dtype=torch.bool, device=lim.device)
    step = blocks.sweep_chunk(nb * bn, SUB)
    for lo in range(0, ng, step):
        _, enter = slab_entry(boxes[None, lo:lo + step, :, None, :], *ray,
                              lim[:, None, None, :])
        gates[:, lo:lo + step] = enter.any(dim=3)
    return gates


def closest_hit_phased_plain(tables: PhasedTables, ro3, rd3, active=None,
                             t_max=None,
                             num_tris: int | None = None,
                             any_hit: bool = False, bn: int = BN,
                             visits: dict | None = None):
    """Plain PyTorch K5 on any device: a group at a time, over the blocks
    that a gate of the group is set for, every sub-cluster of the group
    tested and the ungated ones masked out. ``visits``, where given, gains
    the work the kernel
    does: the "blocks" of ``bn`` rays, the "sub_boxes" gated in phase 1
    (one slab test for each lane of the block; "filled_sub_boxes" of them
    hold a triangle), the "sub_clusters" whose gate is set and their
    "triangle_tests" (a test for each filled slot and each lane of the
    block; "live_triangle_tests" for each live lane only)."""
    del any_hit
    walk_tris = tables.tris
    dev = ro3.device
    n = ro3.shape[1]
    lim0 = blocks.ray_limit(active, t_max, n, dev)
    o, d, lim = blocks.pad_blocks(ro3, rd3, lim0, bn)
    nb = lim.shape[0]
    groups = walk_tris.view(-1, GROUP_ROWS, LEAF_SLOTS)
    gates = sub_gates(groups, o, d, lim)
    if visits is not None:
        filled = (groups[:, 9].view(-1, SUB, SUB_W) >= 0.0).sum(dim=2)
        live = torch.ones((n,), dtype=torch.bool, device=dev)
        if active is not None:
            live = active
        live = torch.nn.functional.pad(live, (0, nb * bn - n)).view(nb, bn)
        slots = (gates * filled[None]).sum(dim=(1, 2))
        visits.update(
            blocks=nb, sub_boxes=nb * groups.shape[0] * SUB,
            filled_sub_boxes=nb * int((filled > 0).sum()),
            sub_clusters=int(gates.sum()),
            triangle_tests=int(slots.sum()) * bn,
            live_triangle_tests=int((slots * live.sum(dim=1)).sum()))
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


def closest_hit_phased_cuda(tables: PhasedTables, ro3, rd3, active=None,
                            t_max=None, num_tris: int | None = None,
                            any_hit: bool = False, bn: int = BN):
    """Launch K5's two kernels on the current stream (no synchronisation):
    the gates of every (block, sub-cluster) into a byte table, then one
    thread a ray through the gated sub-clusters."""
    del any_hit
    walk_tris = tables.tris
    _check(walk_tris, ro3, rd3, active, t_max, bn)
    if ro3.device.type != "cuda":
        raise ValueError("closest_hit_phased_cuda needs CUDA tensors")
    leaves = tables.leaves
    ng = walk_tris.shape[0] // GROUP_ROWS
    if (leaves.dtype != torch.float32
            or tuple(leaves.shape) != (ng, LEAF_FLOATS)
            or not leaves.is_contiguous() or leaves.device != ro3.device
            or leaves.data_ptr() % 16):
        raise ValueError(f"the leaf records must be ({ng}, {LEAF_FLOATS}) "
                         "contiguous, 16-byte aligned float32 on the rays' "
                         "device")
    if -(-ng // GATE_GROUPS) > MAX_GRID_Y:
        raise ValueError(f"{ng} leaf groups: the gate kernel's grid holds at "
                         f"most {MAX_GRID_Y * GATE_GROUPS}")
    n = ro3.shape[1]
    dev = ro3.device
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    idx = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return t, idx
    ro3, rd3 = ro3.contiguous(), rd3.contiguous()
    lim0 = blocks.ray_limit(active, t_max, n, dev).contiguous()
    active = None if active is None else active.contiguous()
    nb = -(-n // bn)
    # Every byte is written by the gate kernel.
    gates = torch.empty((nb, ng * SUB), dtype=torch.uint8, device=dev)
    err = cuda_lib.lib().wpt_phased(
        leaves.data_ptr(), ro3.data_ptr(), rd3.data_ptr(), lim0.data_ptr(),
        None if active is None else active.data_ptr(), gates.data_ptr(),
        t.data_ptr(), idx.data_ptr(), n, bn, ng,
        -1 if num_tris is None else int(num_tris), int(tables.ordered),
        cuda_lib.stream_ptr(ro3))
    cuda_lib.check(err, "wpt_phased")
    Counter.launches += 1
    return t, idx


def closest_hit_phased(tables: PhasedTables, ro3, rd3, active=None,
                       t_max=None, num_tris: int | None = None,
                       any_hit: bool = False, bn: int = BN):
    """K5 wrapper: the CUDA kernels for CUDA tensors, the plain version for
    CPU tensors. ``tables``: ``phased_tables(walk_tris)``, made once a
    scene."""
    if ro3.device.type == "cuda":
        return closest_hit_phased_cuda(tables, ro3, rd3, active, t_max,
                                       num_tris, any_hit, bn)
    _check(tables.tris, ro3, rd3, active, t_max, bn)
    if ro3.device.type != "cpu":
        raise ValueError(f"unsupported device {ro3.device}")
    return closest_hit_phased_plain(tables, ro3, rd3, active, t_max,
                                    num_tris, any_hit, bn)
