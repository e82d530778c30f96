"""K3: the wide-BVH walk, its plain version, and its wrapper.

The counterpart of the JAX package's ``ops/walk.py`` (``closest_hit_walk``,
kernel ``_walk_kernel``). Closest or any hit through the wide BVH tables of
``accel/bvh8.py``; rays are SoA (3, N) origins and directions, the result
is (t (N,) float32, idx (N,) int32), a miss being (inf, -1). The fan-out W
comes from the order table, ``walk_order.shape[1] // 8``, as the JAX walk
infers it: 8 for the default collapse, 16 for ``build_wide_bvh(width=16)``.

Per ray, both versions here follow the same steps, term for term:

* Limit: ``t_max`` (or inf) on an active lane, -inf on an inactive one.
* Reciprocal: a direction component ``d == 0`` becomes 1e-30 before
  ``1/d``, so a ray on a slab plane gives no 0 * inf = NaN.
* The octant is the ray's own three direction sign bits (bit a set when
  d[a] < 0). An interior node's children come from ``walk_order[n, oct*W +
  k]`` with their boxes at rows ``(n*8 + oct)*W + k`` of ``walk_boxes``;
  empty slots (meta 0) are skipped. Slots 0..W-1 are pushed in order, so
  slot W-1, the nearest along the octant, pops first (the JAX kernel's push
  loop).
* A child is entered when ``tf >= tn and tf >= 0 and tn <= limit``, with
  NaN-propagating min and max as ``torch.minimum``/``torch.maximum`` have;
  its stack entry keeps its entry distance ``tn``. A popped entry whose
  ``tn`` is above the live limit is dropped.
* A leaf group's 16 sub-cluster boxes are tested against the limit at the
  visit's start; each entered sub-cluster runs Möller-Trumbore
  (``ops/intersect.py::moller_trumbore``) over its 8 slots. Inside a
  sub-cluster the winner is the least t, ties to the lowest index; across
  sub-clusters and visits the best is replaced on a strict ``<``. After the
  visit the live limit becomes ``min(best t, limit)``; with ``any_hit`` a
  lane whose best t is below its limit stops instead.
* The output clears ``idx >= num_tris``, non-finite t and inactive lanes.

The JAX kernel walks one shared stack per block of rays in the block's
majority octant, so its visit order differs; results differ only in the
exact-tie and one-ulp box-edge class that ``ops/intersect.py`` of the JAX
package documents. Its TPU machinery (SMEM/VMEM residency, the paged slab
ring, ``pops`` batching, the quantised stack keys, the canonical/permutation
encoding) is not carried over.

The kernel reads the leaf groups as the records of ``leaf_records`` (one
more device table, copied from ``walk_tris`` once a scene by
``walk_tables``) and keeps one stack entry a tree level in shared memory,
``WalkTables.levels`` of them a ray (``csrc/walk.cu``, one kernel a width:
``wpt_walk`` at 8 walks a ray a thread, with a 4-byte entry ``node << 8 |
mask``; ``wpt_walk16`` at 16 walks a ray with a team of TEAM lanes, whose
entry is the 16 slots' metas and entry distances, 128 bytes). The plain
version reads ``walk_tris`` as the JAX package lays it out, with a stack of
one entry a pushed child.

On a CUDA tensor ``closest_hit_walk`` launches ``csrc/walk.cu``; on a CPU
tensor it runs ``closest_hit_walk_plain``. There is no fallback between the
two.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from wgpu_path_tracing_tpu_torch.accel.bvh8 import (
    LEAF_SLOTS,
    OCTANTS,
    SUB,
    WIDTH,
    WIDTHS,
    group_rows,
    wide_depth,
)
from wgpu_path_tracing_tpu_torch.models.types import WALK_KEYS
from wgpu_path_tracing_tpu_torch.ops import cuda_lib
from wgpu_path_tracing_tpu_torch.ops.blocks import count_work as _count
from wgpu_path_tracing_tpu_torch.ops.blocks import finish as _finish
from wgpu_path_tracing_tpu_torch.ops.blocks import ray_limit as _limit
from wgpu_path_tracing_tpu_torch.ops.intersect import moller_trumbore

GROUP_ROWS = group_rows(SUB)
SUB_W = LEAF_SLOTS // SUB
TINY = 1e-30  # stands in for a zero direction component before 1/d
# The kernel's records (csrc/walk.cu): a box [min3, max3, 0, 0] and a
# triangle [v0, e1, e2, index, 0, 0]; a leaf group is its SUB sub-box
# records, then its LEAF_SLOTS triangle records.
BOX_FLOATS = 8
TRI_FLOATS = 12
LEAF_FLOATS = SUB * BOX_FLOATS + LEAF_SLOTS * TRI_FLOATS
# Threads a block (csrc/walk.cu kThreads), the lanes that walk one ray at
# width 16 (kTeam), and the shared memory one block may hold on the H100:
# the stack's entries must fit, STACK_BYTES a tree level a block (at width
# 8 one 4-byte entry, node << 8 | mask, a thread; at 16 a team's 16 metas
# and 16 entry distances, 4 bytes each, a ray).
THREADS = 256
TEAM = 16
SHARED_MAX = 232_448
STACK_BYTES = {8: 4 * THREADS, 16: 8 * WIDTHS[1] * (THREADS // TEAM)}
# The kernel's entry point for each width, and the nodes it can address:
# at width 8 the node ids that fit beside the 8-bit mask in a 32-bit stack
# entry; at 16 the int32 ids of walk_order (the stack holds the metas).
LAUNCHERS = {8: "wpt_walk", 16: "wpt_walk16"}
MAX_NODES = {8: 1 << 24, 16: 1 << 31}


class Counter:
    """Launches of the K3 kernel in this process, and those of them at
    width 16 (``wpt_walk16``)."""

    launches = 0
    wide = 0


class WalkTables(NamedTuple):
    order: torch.Tensor  # (Nn, 8 * W) int32
    boxes: torch.Tensor  # (Nn * 8 * W, 8) float32
    tris: torch.Tensor  # (Ng * 32, 128) float32
    stack: int  # the plain version's stack entries a ray
    leaves: torch.Tensor  # (Ng, LEAF_FLOATS) float32, leaf_records(tris)
    levels: int  # the kernel's stack entries a ray

    @property
    def width(self) -> int:
        """The tree's fan-out W, from the order table."""
        return self.order.shape[1] // OCTANTS


def leaf_records(tris: torch.Tensor) -> torch.Tensor:
    """The leaf groups of ``walk_tris`` as the kernel's 16-byte-aligned
    records, by plain copies: per group its SUB sub-boxes [min3, max3, 0, 0],
    then its LEAF_SLOTS triangles [v0, e1, e2, index, 0, 0] in slot order."""
    group = tris.view(-1, GROUP_ROWS, LEAF_SLOTS)
    ng = group.shape[0]
    out = torch.zeros((ng, LEAF_FLOATS), dtype=tris.dtype, device=tris.device)
    boxes = out[:, :SUB * BOX_FLOATS].view(ng, SUB, BOX_FLOATS)
    boxes[..., 0:6] = group[:, 16:16 + SUB, 0:6]
    tri = out[:, SUB * BOX_FLOATS:].view(ng, LEAF_SLOTS, TRI_FLOATS)
    tri[..., 0:10] = group[:, 0:10, :].transpose(1, 2)
    return out


def stack_levels(depth: int) -> int:
    """The kernel's stack entries a ray for a wide tree of ``depth``
    interior levels: the node being walked stays in registers, and an entry
    is its ancestor's, so fewer than ``depth`` (one at least, the buffer's
    floor)."""
    return max(depth - 1, 1)


def walk_tables(scene: dict) -> WalkTables:
    """The walk tables of an uploaded scene, the kernel's leaf records and
    the two stack bounds: the plain version's one-pop DFS leaves at most
    W - 1 entries per interior level, plus the W children of the node being
    visited; the kernel keeps one entry a level."""
    missing = [k for k in WALK_KEYS if k not in scene]
    if missing:
        raise ValueError(
            "the scene has no walk tables (its wide BVH is too deep for the "
            "walk's stack): make_closest_hit takes such a scene through the "
            "pair dispatch (ops/pairs.py)")
    order = scene["walk_order"]
    width = order.shape[1] // OCTANTS
    depth = wide_depth(order[:, :width].cpu().numpy())
    return WalkTables(order, scene["walk_boxes"], scene["walk_tris"],
                      depth * (width - 1) + width,
                      leaf_records(scene["walk_tris"]), stack_levels(depth))


def slab_entry(box, ox, oy, oz, ix, iy, iz, lim):
    """Entry test of boxes (..., 6) [min3 | max3] against rays broadcast to
    the boxes' leading shape. Returns (tn, enter)."""
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
    enter = (tf >= tn) & (tf >= 0.0) & (tn <= lim)
    return tn, enter


def closest_hit_walk_plain(tables: WalkTables, ro3, rd3, active=None,
                           t_max=None, num_tris: int | None = None,
                           any_hit: bool = False, visits: dict | None = None,
                           ray_visits: dict | None = None):
    """Plain PyTorch K3 on any device: one DFS stack per ray, as (N, S)
    tensors, and a loop that pops one entry on every lane with work until
    no lane has any. ``ray_visits``, where given, gains each ray's own
    counts as (N,) int64 tensors: "pops" (stack entries taken, the kernel's
    loop steps, culled ones too), "interior" and "leaf" visits. ``visits``,
    where given, gains the work the walk did,
    summed over the rays: "interior" and "leaf" visits, the "children"
    slab-tested on interior visits (non-empty slots), the "sub_boxes"
    gated on leaf visits (sub-clusters that hold a triangle), the
    "sub_clusters" entered, and the "triangles" of the entered
    sub-clusters (one Möller-Trumbore test each); the kernel does the same
    work, visit for visit, besides Möller-Trumbore on an entered
    sub-cluster's empty slots."""
    dev = ro3.device
    n = ro3.shape[1]
    lim0 = _limit(active, t_max, n, dev)
    o = [ro3[a] for a in range(3)]
    d = [rd3[a] for a in range(3)]
    inv = [torch.reciprocal(torch.where(x == 0.0, TINY, x)) for x in d]
    octant = ((d[0] < 0.0).long() + 2 * (d[1] < 0.0).long()
              + 4 * (d[2] < 0.0).long())
    best_t = torch.full((n,), math.inf, dtype=torch.float32, device=dev)
    best_i = torch.full((n,), -1, dtype=torch.int32, device=dev)
    lim = lim0.clone()  # the live limit
    stack_node = torch.zeros((n, tables.stack), dtype=torch.int32,
                             device=dev)
    stack_tn = torch.zeros((n, tables.stack), dtype=torch.float32,
                           device=dev)
    sp = torch.ones((n,), dtype=torch.long, device=dev)  # the root, tn 0
    width = tables.width
    slots = torch.arange(width, device=dev)
    if ray_visits is not None:
        for key in ("pops", "interior", "leaf"):
            ray_visits.setdefault(key, torch.zeros(n, dtype=torch.long,
                                                   device=dev))
    if visits is not None:  # triangles each sub-cluster holds, (Ng, SUB)
        filled = (tables.tris.view(-1, GROUP_ROWS, LEAF_SLOTS)[:, 9]
                  .view(-1, SUB, SUB_W) >= 0.0).sum(dim=2)

    while True:
        lanes = torch.nonzero(sp > 0).squeeze(1)
        if lanes.numel() == 0:
            break
        top = sp[lanes] - 1
        sp[lanes] = top
        node = stack_node[lanes, top]
        keep = ~(stack_tn[lanes, top] > lim[lanes])
        if ray_visits is not None:
            ray_visits["pops"][lanes] += 1
        lanes, node = lanes[keep], node[keep]
        inner = node >= 0

        # Interior visits: test the W children, push the entered ones.
        il, m = lanes[inner], node[inner].long()
        oc = octant[il]
        metas = tables.order[m[:, None], oc[:, None] * width + slots]
        box = tables.boxes[((m * OCTANTS + oc) * width)[:, None] + slots, 0:6]
        ray = [x[il][:, None] for x in o + inv]
        tn, enter = slab_entry(box, *ray, lim[il][:, None])
        full = metas != 0
        push = enter & full
        pos = sp[il][:, None] + torch.cumsum(push, dim=1) - 1
        rows = il[:, None].expand_as(push)[push]
        stack_node[rows, pos[push]] = metas[push]
        stack_tn[rows, pos[push]] = tn[push]
        sp[il] += push.sum(dim=1)

        # Leaf visits: gate the sub-clusters, then Möller-Trumbore on the
        # entered ones, one (lane, sub-cluster) pair per row.
        ll = lanes[~inner]
        group = -node[~inner].long() - 1
        if ray_visits is not None:
            ray_visits["interior"][il] += 1
            ray_visits["leaf"][ll] += 1
        if visits is not None:
            _count(visits, interior=il.numel(), leaf=ll.numel(),
                   children=full.sum(), sub_boxes=(filled[group] > 0).sum())
        if ll.numel() == 0:
            continue
        base = group * GROUP_ROWS
        sub = torch.arange(SUB, device=dev)
        sb = tables.tris[(base[:, None] + 16 + sub)[..., None],
                         torch.arange(6, device=dev)]
        ray = [x[ll][:, None] for x in o + inv]
        _, gate = slab_entry(sb, *ray, lim[ll][:, None])
        r, c = torch.nonzero(gate, as_tuple=True)  # by lane, then by c
        if visits is not None:
            _count(visits, sub_clusters=r.numel(),
                   triangles=filled[group[r], c].sum())
        lane = ll[r]
        cols = c[:, None] * SUB_W + slots[:SUB_W]
        rows10 = base[r][:, None, None] + torch.arange(10, device=dev)[:, None]
        tri = tables.tris[rows10, cols[:, None, :]]  # (P, 10, SUB_W)
        ray = [x[lane][:, None] for x in o + d]
        t, _, _, valid = moller_trumbore(*ray, *tri[:, 0:9].unbind(1))
        gidx = tri[:, 9]
        valid = valid & (gidx >= 0.0)
        t = torch.where(valid, t, math.inf)
        sub_t = t.min(dim=1).values
        sub_i = torch.where(t == sub_t[:, None], gidx, math.inf).min(
            dim=1).values
        # The sub-clusters merge in ascending c with a strict <: the
        # visit's winner is the least t, ties to the lowest c.
        k = ll.numel()
        vis_t = torch.full((k,), math.inf, device=dev).scatter_reduce(
            0, r, sub_t, "amin")
        first_c = torch.where(sub_t == vis_t[r], c, SUB)
        win_c = torch.full((k,), SUB, dtype=c.dtype, device=dev).scatter_reduce(
            0, r, first_c, "amin")
        win = (c == win_c[r]) & (sub_t == vis_t[r])
        wl, wt, wi = lane[win], sub_t[win], sub_i[win]
        better = wt < best_t[wl]
        best_t[wl[better]] = wt[better]
        best_i[wl[better]] = wi[better].to(torch.int32)
        if any_hit:
            sp[ll[best_t[ll] < lim0[ll]]] = 0
        else:
            lim[ll] = torch.minimum(best_t[ll], lim0[ll])

    return _finish(best_t, best_i, active, num_tris)



def _check(tables: WalkTables, ro3, rd3, active, t_max) -> None:
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
    order, boxes, tris = tables.order, tables.boxes, tables.tris
    if (order.dtype != torch.int32 or order.dim() != 2
            or order.shape[1] not in [OCTANTS * w for w in WIDTHS]):
        raise ValueError(f"walk_order must be (Nn, 8 * W) int32, W in "
                         f"{WIDTHS}")
    if (boxes.dtype != torch.float32 or tuple(boxes.shape)
            != (order.shape[0] * order.shape[1], 8)):
        raise ValueError("walk_boxes must be (Nn * 8 * W, 8) float32")
    if (tris.dtype != torch.float32 or tris.dim() != 2
            or tris.shape[1] != LEAF_SLOTS or tris.shape[0] % GROUP_ROWS):
        raise ValueError("walk_tris must be (Ng * 32, 128) float32")
    devices = {x.device for x in (ro3, rd3, order, boxes, tris, active, t_max)
               if x is not None}
    if len(devices) != 1:
        raise ValueError("the rays and the walk tables are on different "
                         "devices")


def _check_kernel_tables(tables: WalkTables) -> None:
    """What the kernel reads beyond the plain version: the leaf records
    (their shape), walk_order, walk_boxes and the records contiguous from 16
    bytes on (the kernel loads them as int4 and float4), the node ids it
    can address (``MAX_NODES``: at width 8 beside the 8-bit mask in a
    32-bit stack entry, 2^24; at width 16 int32's, the team's stack holding
    the metas), and the stack in shared memory."""
    leaves, ng = tables.leaves, tables.tris.shape[0] // GROUP_ROWS
    if (leaves.dtype != torch.float32
            or tuple(leaves.shape) != (ng, LEAF_FLOATS)):
        raise ValueError(f"the leaf records must be a ({ng}, {LEAF_FLOATS}) "
                         "float32 tensor (leaf_records)")
    for name, x in (("leaf records", leaves), ("walk_order", tables.order),
                    ("walk_boxes", tables.boxes)):
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"the {name} must be contiguous from a 16-byte "
                             "boundary")
    limit = MAX_NODES[tables.width]
    if tables.order.shape[0] > limit:
        raise ValueError(f"K3 takes at most {limit} wide nodes at width "
                         f"{tables.width}")
    most = SHARED_MAX // STACK_BYTES[tables.width]
    if not 1 <= tables.levels <= most:
        raise ValueError(
            f"the wide BVH needs {tables.levels} stack entries a ray; K3's "
            f"shared memory holds 1 to {most} at width {tables.width}")


def closest_hit_walk_cuda(tables: WalkTables, ro3, rd3, active=None,
                          t_max=None, num_tris: int | None = None,
                          any_hit: bool = False):
    """Launch K3, the instantiation of the tables' width, on the current
    stream (no synchronisation)."""
    _check(tables, ro3, rd3, active, t_max)
    _check_kernel_tables(tables)
    if ro3.device.type != "cuda":
        raise ValueError("closest_hit_walk_cuda needs CUDA tensors")
    args = [tables.order, tables.boxes, tables.leaves, ro3.contiguous(),
            rd3.contiguous()]
    for x in (active, t_max):
        args.append(None if x is None else x.contiguous())
    n = ro3.shape[1]
    t = torch.empty((n,), dtype=torch.float32, device=ro3.device)
    idx = torch.empty((n,), dtype=torch.int32, device=ro3.device)
    if n == 0:
        return t, idx
    launcher = LAUNCHERS[tables.width]
    err = getattr(cuda_lib.lib(), launcher)(
        *(None if x is None else x.data_ptr() for x in args),
        t.data_ptr(), idx.data_ptr(), n,
        -1 if num_tris is None else int(num_tris), int(bool(any_hit)),
        tables.levels, cuda_lib.stream_ptr(ro3))
    cuda_lib.check(err, launcher)
    Counter.launches += 1
    Counter.wide += int(tables.width == 16)
    return t, idx


def closest_hit_walk(tables: WalkTables, ro3, rd3, active=None, t_max=None,
                     num_tris: int | None = None, any_hit: bool = False):
    """K3 wrapper: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors."""
    if ro3.device.type == "cuda":
        return closest_hit_walk_cuda(tables, ro3, rd3, active, t_max,
                                     num_tris, any_hit)
    _check(tables, ro3, rd3, active, t_max)
    if ro3.device.type != "cpu":
        raise ValueError(f"unsupported device {ro3.device}")
    return closest_hit_walk_plain(tables, ro3, rd3, active, t_max, num_tris,
                                  any_hit)
