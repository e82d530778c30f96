"""Ray-triangle intersection and the choice of intersector.

The counterpart of the JAX package's ``ops/intersect.py``:

* the dense closest hit: Möller-Trumbore with EPSILON = 1e-6
  (pt.wgsl:123-157) over triangles packed as [v0, e1, e2] rows, every ray
  against every triangle; ties go to the lowest triangle index, as the
  reference's strict ``hit.t < closest.t`` gives (pt.wgsl:275). The
  expressions follow ``ops/pallas_kernels.py::_brute_kernel`` term by term
  (the kernel K1 in ``csrc/dense_hit.cu`` does too);
* the two walks of the binary BVH, ``closest_hit_bvh`` (a fixed stack per
  ray, K7) and ``closest_hit_bvh_linked`` (stackless, over the hit and miss
  links, K8), and K7's depth mode ``bvh_depth`` (the debug heat map). Each
  has a plain version, the JAX ``lax.while_loop`` as a Python loop, and a
  CUDA kernel in ``csrc/bvh2.cu``;
* ``make_closest_hit``, which picks one of these or the wide-BVH walk and
  the dispatch intersectors of ``ops/walk.py``, ``ops/pairs.py``,
  ``ops/phased.py`` and ``ops/cluster.py``.

A miss is (t = inf, idx = -1). On the card each kernel and its plain version
agree bit for bit: the kernels round every operation as PyTorch does.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from wgpu_path_tracing_tpu_torch.ops import cuda_lib
from wgpu_path_tracing_tpu_torch.ops.blocks import count_work

EPSILON = 1e-6  # pt.wgsl:4


def moller_trumbore(ox, oy, oz, dx, dy, dz, v0x, v0y, v0z, e1x, e1y, e1z,
                    e2x, e2y, e2z):
    """Broadcasting Möller-Trumbore. Returns (t, u, v, valid)."""
    hx = dy * e2z - dz * e2y
    hy = dz * e2x - dx * e2z
    hz = dx * e2y - dy * e2x
    a = e1x * hx + e1y * hy + e1z * hz
    f = torch.reciprocal(a)
    sx = ox - v0x
    sy = oy - v0y
    sz = oz - v0z
    u = f * (sx * hx + sy * hy + sz * hz)
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = f * (dx * qx + dy * qy + dz * qz)
    t = f * (e2x * qx + e2y * qy + e2z * qz)
    valid = (
        (torch.abs(a) >= EPSILON)
        & (u >= 0.0)
        & (u <= 1.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > EPSILON)
    )
    return t, u, v, valid


def closest_hit_brute(tri_isect: torch.Tensor, ro: torch.Tensor,
                      rd: torch.Tensor, chunk: int = 256):
    """Dense closest hit. tri_isect: (T, 9); ro, rd: (N, 3) as in the JAX
    package (any strides). Sweeps triangle chunks to bound the (N, chunk)
    working set. Returns (t (N,) float32, idx (N,) int32)."""
    n = ro.shape[0]
    num_tris = tri_isect.shape[0]
    dev = ro.device
    best_t = torch.full((n,), math.inf, dtype=torch.float32, device=dev)
    best_idx = torch.full((n,), -1, dtype=torch.int32, device=dev)
    o = [ro[:, k, None] for k in range(3)]
    d = [rd[:, k, None] for k in range(3)]
    for base in range(0, num_tris, chunk):
        tri = tri_isect[base:base + chunk]
        cols = [tri[None, :, k] for k in range(9)]
        t, _, _, valid = moller_trumbore(*o, *d, *cols)
        t = torch.where(valid, t, math.inf)
        c_t = t.min(dim=1).values
        rows = torch.arange(tri.shape[0], dtype=torch.int32, device=dev)
        c_idx = torch.where(t == c_t[:, None], rows[None, :],
                            tri.shape[0]).min(dim=1).values
        better = c_t < best_t
        best_t = torch.where(better, c_t, best_t)
        best_idx = torch.where(better, base + c_idx, best_idx)
    return best_t, best_idx


def slab_test(ro, rd, box_min, box_max):
    """Slab AABB test (pt.wgsl:234-245) of (N, 3) rays against (N, 3) box
    corners, dividing by the direction as the JAX package's ``slab_test``
    does: a zero component gives +-inf or NaN, and ``torch.minimum``,
    ``torch.amax`` and their kin carry NaN through, so such a lane's hit is
    false. Returns (hit, t_near)."""
    t1 = (box_min - ro) / rd
    t2 = (box_max - ro) / rd
    t_near = torch.amax(torch.minimum(t1, t2), dim=-1)
    t_far = torch.amin(torch.maximum(t1, t2), dim=-1)
    return (t_far >= t_near) & (t_far >= 0.0), t_near


# The binary-BVH walks' defaults (the JAX package's): the reference's stack
# of 64 entries (pt.wgsl:249), the leaf size of the build (bvh.ts:86), and
# the loops' step caps.
STACK_DEPTH = 64
LEAF_SIZE = 4
STACK_MAX_STEPS = 1_000_000
LINKED_MAX_STEPS = 4_000_000
INT32_MIN = -(1 << 31)


class StackCounter:
    """Launches of K7, the stack walk, in this process; ``depth`` counts
    those of them that ran its depth mode."""

    launches = 0
    depth = 0


class LinkedCounter:
    """Launches of K8, the linked walk, in this process."""

    launches = 0


def _rows(idx, size: int):
    """Row indices as XLA's gather takes them: a negative index counts from
    the end, then the index is clamped into [0, size)."""
    idx = idx.long()
    return torch.clamp(torch.where(idx < 0, idx + size, idx), 0, size - 1)


def _leaf_tests(tri_isect, ro, rd, meta_off, count, do_leaf, best_t,
                best_i, leaf_size: int):
    """The JAX walks' leaf loop on the lanes of ``ro``/``rd``: triangles
    ``meta_off + i`` for i < min(count, leaf_size), in order, each kept on
    a strict ``<``. The ``leaf_size`` tests run as one broadcast; the
    sequential updates keep the first of the least valid t's, where it is
    below ``best_t``, which is what this reduction keeps. Returns the
    updated (best_t, best_i)."""
    if leaf_size <= 0:
        return best_t, best_i
    nt = tri_isect.shape[0]
    slot = torch.arange(leaf_size, device=ro.device)
    do = do_leaf[:, None] & (slot < count[:, None])
    tri = torch.where(do, meta_off[:, None] + slot.to(meta_off.dtype), 0)
    tdata = tri_isect[_rows(tri, nt)]  # (L, leaf_size, 9)
    o = [x[:, None] for x in ro.unbind(1)]
    d = [x[:, None] for x in rd.unbind(1)]
    t, _, _, valid = moller_trumbore(*o, *d, *tdata.unbind(2))
    t = torch.where(do & valid, t, math.inf)
    t_min = t.min(dim=1).values
    first = torch.where(t == t_min[:, None], slot, leaf_size).min(dim=1)
    better = t_min < best_t
    win = torch.gather(tri, 1, torch.clamp_max(first.values, leaf_size - 1)
                       [:, None])[:, 0]
    return (torch.where(better, t_min, best_t),
            torch.where(better, win, best_i))


# The plain walks step the lanes that had work at their last compaction,
# masked as the JAX loops mask every lane, and compact (one host sync)
# every COMPACT_EVERY steps.
COMPACT_EVERY = 16


def _stack_step(stack, sp, lanes, has, push, spm1, meta):
    """A step's stack update on ``lanes`` as the JAX walk makes it: the
    popped slot takes the right child (dropped when the slot lies past the
    stack), then slot min(spm1 + 1, depth - 1) the left child, so at a full
    stack the left child overwrites the right; on the lanes that had work
    (``has``) the pointer moves to spm1 + 2 on a push, to spm1 otherwise."""
    depth = stack.shape[1]
    slot2 = torch.clamp_max(spm1 + 1, depth - 1)
    right = push & (spm1 < depth)
    stack[lanes[right], spm1[right]] = meta[right, 1]
    stack[lanes[push], slot2[push]] = meta[push, 0]
    sp[lanes] = torch.where(has, torch.where(push, spm1 + 2, spm1), sp[lanes])


def _pop(stack, sp, lanes):
    """(has, spm1, node) of ``lanes``: whether the lane has work, the
    post-pop pointer max(sp - 1, 0), and the node at it: INT32_MIN for a
    slot past the stack (``jnp.take_along_axis`` fills an out-of-bounds
    read so; ``_rows`` then reads row 0), 0 on a lane without work."""
    depth = stack.shape[1]
    sp_l = sp[lanes]
    has = sp_l > 0
    spm1 = torch.clamp_min(sp_l - 1, 0)
    node = stack[lanes, torch.clamp_max(spm1, depth - 1)]
    node = torch.where(spm1 < depth, node, INT32_MIN)
    return has, spm1, torch.where(has, node, 0)


class _Work:
    """The ``visits`` counts of a plain walk, summed on the device and read
    once at the end."""

    def __init__(self, visits: dict | None, dev):
        self.visits = visits
        self.nodes = torch.zeros((), dtype=torch.long, device=dev)
        self.triangles = torch.zeros((), dtype=torch.long, device=dev)

    def add(self, visited, count=None, leaf=None, leaf_size: int = 0):
        if self.visits is None:
            return
        self.nodes += visited.sum()
        if count is not None:
            self.triangles += (torch.clamp(count, 0, leaf_size)
                               * leaf).sum()

    def done(self, triangles: bool = True) -> None:
        if self.visits is not None:
            count_work(self.visits, nodes=self.nodes)
            if triangles:
                count_work(self.visits, triangles=self.triangles)


def closest_hit_bvh_plain(bvh_aabb, bvh_meta, tri_isect, ro, rd, active=None,
                          t_max=None, leaf_size: int = LEAF_SIZE,
                          stack_depth: int = STACK_DEPTH,
                          any_hit: bool = False,
                          max_steps: int = STACK_MAX_STEPS,
                          visits: dict | None = None):
    """Plain PyTorch K7: the JAX ``closest_hit_bvh`` with its
    ``lax.while_loop`` as a Python loop that steps every lane with a
    non-empty stack once an iteration.

    bvh_aabb (B, 6) [min, max]; bvh_meta (B, 4) int32 [left, right, offset,
    count]; tri_isect (T, 9); ro, rd (N, 3); active (N,) bool; t_max (N,)
    float32. A popped node whose box the ray enters at or below min(best t,
    t_max) is processed: a leaf tests its first ``leaf_size`` triangles, an
    interior node pushes its right, then its left child (left pops first).
    ``any_hit`` empties a lane's stack once its best t is below t_max (or
    inf). ``max_steps`` caps the iterations. ``visits``, where given, gains
    the "nodes" slab-tested and the "triangles" tested. Returns (t (N,),
    idx (N,) int32), the raw best: inf and -1 where nothing was hit."""
    n = ro.shape[0]
    dev = ro.device
    nb = bvh_aabb.shape[0]
    best_t = torch.full((n,), math.inf, dtype=torch.float32, device=dev)
    best_i = torch.full((n,), -1, dtype=torch.int32, device=dev)
    stack = torch.zeros((n, stack_depth), dtype=torch.int32, device=dev)
    sp = torch.ones((n,), dtype=torch.long, device=dev)
    if active is not None:
        sp = torch.where(active, sp, 0)
    work = _Work(visits, dev)
    steps = 0
    while steps < max_steps:
        if steps % COMPACT_EVERY == 0:
            lanes = torch.nonzero(sp > 0).squeeze(1)
            if lanes.numel() == 0:
                break
            o, d = ro[lanes], rd[lanes]
            tm = None if t_max is None else t_max[lanes]
        has, spm1, node = _pop(stack, sp, lanes)
        rows = _rows(node, nb)
        box = bvh_aabb[rows]
        hit, t_near = slab_test(o, d, box[:, 0:3], box[:, 3:6])
        bt = best_t[lanes]
        limit = bt if tm is None else torch.minimum(bt, tm)
        process = has & hit & (t_near <= limit)
        meta = bvh_meta[rows]
        count = meta[:, 3]
        is_leaf = count > 0
        bt, bi = _leaf_tests(tri_isect, o, d, meta[:, 2], count,
                             process & is_leaf, bt, best_i[lanes], leaf_size)
        best_t[lanes], best_i[lanes] = bt, bi
        work.add(has, count, process & is_leaf, leaf_size)
        _stack_step(stack, sp, lanes, has, process & ~is_leaf, spm1, meta)
        if any_hit:
            found = bt < (math.inf if tm is None else tm)
            sp[lanes] = torch.where(found, 0, sp[lanes])
        steps += 1
    work.done()
    return best_t, best_i


def bvh_depth_plain(bvh_aabb, bvh_meta, ro, rd, norm: float,
                    stack_depth: int = STACK_DEPTH,
                    max_steps: int = STACK_MAX_STEPS,
                    visits: dict | None = None):
    """Plain PyTorch K7 in its depth mode: the JAX ``render_bvh_depth``
    walk (pt_bvh.wgsl:98-130) over (N, 3) rays, every lane from the root.
    No culling and no triangle tests: an interior node whose box the ray
    enters pushes its children, and each step keeps the running max of the
    post-pop pointer. Returns that max divided by ``norm`` (an IEEE
    division, ``ops/vec.py::div_const``). ``max_steps`` caps the
    iterations, a guard the JAX loop lacks (it has no cap: a stack that
    overflowed on a hit root would never empty there)."""
    from wgpu_path_tracing_tpu_torch.ops.vec import div_const

    n = ro.shape[0]
    dev = ro.device
    nb = bvh_aabb.shape[0]
    max_depth = torch.zeros((n,), dtype=torch.float32, device=dev)
    stack = torch.zeros((n, stack_depth), dtype=torch.int32, device=dev)
    sp = torch.ones((n,), dtype=torch.long, device=dev)
    work = _Work(visits, dev)
    steps = 0
    while steps < max_steps:
        if steps % COMPACT_EVERY == 0:
            lanes = torch.nonzero(sp > 0).squeeze(1)
            if lanes.numel() == 0:
                break
            o, d = ro[lanes], rd[lanes]
        has, spm1, node = _pop(stack, sp, lanes)
        md = max_depth[lanes]
        max_depth[lanes] = torch.where(
            has, torch.maximum(md, spm1.to(torch.float32)), md)
        rows = _rows(node, nb)
        box = bvh_aabb[rows]
        hit, _ = slab_test(o, d, box[:, 0:3], box[:, 3:6])
        meta = bvh_meta[rows]
        work.add(has)
        _stack_step(stack, sp, lanes, has, has & hit & (meta[:, 3] == 0),
                    spm1, meta)
        steps += 1
    work.done(triangles=False)
    return div_const(max_depth, norm)


def closest_hit_bvh_linked_plain(bvh_aabb, bvh_nodes, tri_isect, ro, rd,
                                 active=None, t_max=None,
                                 leaf_size: int = LEAF_SIZE,
                                 any_hit: bool = False,
                                 max_steps: int = LINKED_MAX_STEPS,
                                 visits: dict | None = None):
    """Plain PyTorch K8: the JAX ``closest_hit_bvh_linked`` (stackless:
    each ray holds only its node) with its ``lax.while_loop`` as a Python
    loop. bvh_nodes (B, 4) int32 [hit link, miss link, offset, count]
    (``linked_nodes``); a node of -1 ends a lane. A node whose box the ray
    enters at or below min(best t, t_max) tests its first ``leaf_size``
    triangles when it is a leaf and follows its hit link, else its miss
    link. The other arguments, ``visits`` and the result are
    ``closest_hit_bvh_plain``'s."""
    n = ro.shape[0]
    dev = ro.device
    nb = bvh_aabb.shape[0]
    best_t = torch.full((n,), math.inf, dtype=torch.float32, device=dev)
    best_i = torch.full((n,), -1, dtype=torch.int32, device=dev)
    node = torch.zeros((n,), dtype=torch.int32, device=dev)
    if active is not None:
        node = torch.where(active, node, -1)
    work = _Work(visits, dev)
    steps = 0
    while steps < max_steps:
        if steps % COMPACT_EVERY == 0:
            lanes = torch.nonzero(node >= 0).squeeze(1)
            if lanes.numel() == 0:
                break
            o, d = ro[lanes], rd[lanes]
            tm = None if t_max is None else t_max[lanes]
        cur = node[lanes]
        valid = cur >= 0
        rows = _rows(torch.clamp_min(cur, 0), nb)
        box = bvh_aabb[rows]
        hit, t_near = slab_test(o, d, box[:, 0:3], box[:, 3:6])
        bt = best_t[lanes]
        limit = bt if tm is None else torch.minimum(bt, tm)
        box_hit = valid & hit & (t_near <= limit)
        meta = bvh_nodes[rows]
        count = meta[:, 3]
        do_leaf = box_hit & (count > 0)
        bt, bi = _leaf_tests(tri_isect, o, d, meta[:, 2], count, do_leaf, bt,
                             best_i[lanes], leaf_size)
        best_t[lanes], best_i[lanes] = bt, bi
        work.add(valid, count, do_leaf, leaf_size)
        nxt = torch.where(valid, torch.where(box_hit, meta[:, 0],
                                             meta[:, 1]), -1)
        if any_hit:
            nxt = torch.where(bt < (math.inf if tm is None else tm), -1, nxt)
        node[lanes] = nxt
        steps += 1
    work.done()
    return best_t, best_i


def linked_nodes(bvh_meta, bvh_links):
    """The linked walk's (B, 4) int32 rows [hit, miss, offset, count], as
    the JAX package's ``make_closest_hit`` concatenates them."""
    return torch.cat([bvh_links, bvh_meta[:, 2:4]], dim=1).contiguous()


class BVH2Tables(NamedTuple):
    """K7's or K8's tables as its kernel reads them, staged once a scene
    (``stack_tables``, ``linked_tables``): one record a node, float32 rows
    whose integer fields hold int32 bits, and the triangles as 48-byte
    rows (``tri_rows``), None in K7's depth mode."""

    nodes: torch.Tensor
    tris: torch.Tensor | None


def tri_rows(tri_isect):
    """(T, 12) float32: the (T, 9) [v0, e1, e2] rows padded with three
    zeros, in the same order, so that a triangle is three 16-byte loads."""
    return torch.nn.functional.pad(tri_isect, (0, 3)).contiguous()


# The flag of a tame box in its record (bit 31 of a 32-bit word).
TAME_BIT = -(1 << 31)


def tame_boxes(bvh_aabb):
    """(B,) bool: each of the box's six coordinates is 0, NaN, or has a
    magnitude in [2^-40, 2^39]. A step of K7 or K8 from a tame ray into a
    tame box divides on its fast path (``csrc/bvh2.cu``)."""
    m = bvh_aabb.abs()
    ok = (m == 0) | torch.isnan(m) | ((m >= 2.0 ** -40) & (m <= 2.0 ** 39))
    return ok.all(dim=1)


def stack_records(bvh_aabb, bvh_meta):
    """K7's (B, 8) records, 32 bytes a node: [min3, left, max3, right] for
    an interior node (count 0), [min3, offset, max3, -count] for a leaf, so
    the sign of the last field tells them apart, with TAME_BIT set in the
    fourth word of a ``tame_boxes`` box. That needs count >= 0 on every
    node, a left and right child >= 0 on every interior node and an offset
    >= 0 on every leaf; a table without them raises ValueError (one host
    sync)."""
    left, right, off, count = bvh_meta.unbind(1)
    interior = count == 0
    first = torch.where(interior, left, off)
    if bool(((count < 0) | (first < 0) | (interior & (right < 0))).any()):
        raise ValueError("K7's records need count >= 0 on every node, "
                         "children >= 0 on every interior node and an "
                         "offset >= 0 on every leaf")
    rec = torch.empty((bvh_meta.shape[0], 8), dtype=torch.int32,
                      device=bvh_meta.device)
    rec[:, 0:3] = bvh_aabb[:, 0:3].view(torch.int32)
    rec[:, 3] = torch.where(tame_boxes(bvh_aabb), first | TAME_BIT, first)
    rec[:, 4:7] = bvh_aabb[:, 3:6].view(torch.int32)
    rec[:, 7] = torch.where(interior, right, -count)
    return rec.view(torch.float32)


def linked_records(bvh_aabb, bvh_nodes):
    """K8's (B, 12) records, 48 bytes a node: [min3, hit, max3, miss,
    offset, count, TAME_BIT on a ``tame_boxes`` box else 0, 0] from the box
    and ``linked_nodes``' row."""
    rec = torch.zeros((bvh_nodes.shape[0], 12), dtype=torch.int32,
                      device=bvh_nodes.device)
    rec[:, 0:3] = bvh_aabb[:, 0:3].view(torch.int32)
    rec[:, 3] = bvh_nodes[:, 0]
    rec[:, 4:7] = bvh_aabb[:, 3:6].view(torch.int32)
    rec[:, 7] = bvh_nodes[:, 1]
    rec[:, 8:10] = bvh_nodes[:, 2:4]
    rec[:, 10] = torch.where(tame_boxes(bvh_aabb), TAME_BIT, 0)
    return rec.view(torch.float32)


def stack_tables(bvh_aabb, bvh_meta, tri_isect=None) -> BVH2Tables:
    """K7's staged tables, on the tables' device; ``tri_isect`` None for
    the depth mode."""
    return BVH2Tables(stack_records(bvh_aabb, bvh_meta),
                      None if tri_isect is None else tri_rows(tri_isect))


def linked_tables(bvh_aabb, bvh_nodes, tri_isect) -> BVH2Tables:
    """K8's staged tables, on the tables' device."""
    return BVH2Tables(linked_records(bvh_aabb, bvh_nodes),
                      tri_rows(tri_isect))


def _check_rays(ro, rd, active, t_max) -> None:
    n = ro.shape[0]
    for name, x in (("ro", ro), ("rd", rd)):
        if x.dim() != 2 or tuple(x.shape) != (n, 3):
            raise ValueError(f"{name} must be (N, 3), got {tuple(x.shape)}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
    if active is not None and (active.dtype != torch.bool
                               or tuple(active.shape) != (n,)):
        raise ValueError("active must be a (N,) bool tensor")
    if t_max is not None and (t_max.dtype != torch.float32
                              or tuple(t_max.shape) != (n,)):
        raise ValueError("t_max must be a (N,) float32 tensor")


def _check_bvh(bvh_aabb, nodes, tri_isect, ro, rd, active, t_max) -> None:
    _check_rays(ro, rd, active, t_max)
    if bvh_aabb.dtype != torch.float32 or bvh_aabb.dim() != 2 or (
            bvh_aabb.shape[1] != 6):
        raise ValueError("bvh_aabb must be (B, 6) float32")
    if nodes.dtype != torch.int32 or tuple(nodes.shape) != (
            bvh_aabb.shape[0], 4):
        raise ValueError("the node table must be (B, 4) int32")
    if tri_isect is not None and (tri_isect.dtype != torch.float32
                                  or tri_isect.dim() != 2
                                  or tri_isect.shape[1] != 9):
        raise ValueError("tri_isect must be (T, 9) float32")
    devices = {x.device for x in (bvh_aabb, nodes, tri_isect, ro, rd, active,
                                  t_max) if x is not None}
    if len(devices) != 1:
        raise ValueError("the rays and the BVH tables are on different "
                         "devices")


def _need_cuda(ro) -> None:
    if ro.device.type != "cuda":
        raise ValueError("the K7 and K8 launchers need CUDA tensors")


def _launch_args(tables: BVH2Tables, width: int, ro, rd, active, t_max,
                 max_steps: int):
    """The tensors (to keep alive over the launch), pointers and step cap
    that both kernels of ``csrc/bvh2.cu`` take: the staged tables
    (``width`` floats a node record, 12 a triangle row; contiguous, 16-byte
    aligned, on the rays' device), the rays as (3, N) rows, ``max_steps``
    held to int32."""
    _check_rays(ro, rd, active, t_max)
    _need_cuda(ro)
    for name, x, cols in (("node records", tables.nodes, width),
                          ("triangle rows", tables.tris, 12)):
        if x is None:
            continue
        if (x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != cols
                or x.device != ro.device):
            raise ValueError(f"the staged {name} must be (rows, {cols}) "
                             f"float32 on {ro.device}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"the staged {name} must be contiguous and "
                             "start on a 16-byte boundary")
    for x in (active, t_max):
        if x is not None and x.device != ro.device:
            raise ValueError("the rays and their masks are on different "
                             "devices")
    keep = [tables.nodes, tables.tris, ro.T.contiguous(), rd.T.contiguous(),
            None if active is None else active.contiguous(),
            None if t_max is None else t_max.contiguous()]
    ptrs = [None if x is None else x.data_ptr() for x in keep]
    steps = max(0, min(int(max_steps), (1 << 31) - 1))
    return keep, ptrs, steps


def _stack_launch(tables, ro, rd, active, t_max, leaf_size, stack_depth,
                  any_hit, max_steps, norm):
    if not 1 <= stack_depth <= cuda_lib.BVH_MAX_STACK:
        raise ValueError(f"K7 keeps 1 to {cuda_lib.BVH_MAX_STACK} stack "
                         f"entries a ray, not {stack_depth}")
    if (norm is None) == (tables.tris is None):
        raise ValueError("K7's closest hit takes triangle rows, its depth "
                         "mode none")
    keep, ptrs, steps = _launch_args(tables, 8, ro, rd, active, t_max,
                                     max_steps)
    n = ro.shape[0]
    dev = ro.device
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    idx = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return t, idx
    err = cuda_lib.lib().wpt_bvh_stack(
        *ptrs, t.data_ptr(), idx.data_ptr(), n, tables.nodes.shape[0],
        0 if tables.tris is None else tables.tris.shape[0], int(leaf_size),
        int(stack_depth), int(bool(any_hit)), steps,
        int(norm is not None), 1.0 if norm is None else float(norm),
        cuda_lib.stream_ptr(ro))
    cuda_lib.check(err, "wpt_bvh_stack")
    StackCounter.launches += 1
    if norm is not None:
        StackCounter.depth += 1
    return t, idx


def launch_stack(tables: BVH2Tables, ro, rd, active=None, t_max=None,
                 leaf_size: int = LEAF_SIZE, stack_depth: int = STACK_DEPTH,
                 any_hit: bool = False, max_steps: int = STACK_MAX_STEPS):
    """Launch K7 (``csrc/bvh2.cu``) on the current stream over ``tables``
    (``stack_tables``), the one form of the tree it reads; rays and result
    as ``closest_hit_bvh_plain``'s. CUDA tensors only."""
    return _stack_launch(tables, ro, rd, active, t_max, leaf_size,
                         stack_depth, any_hit, max_steps, None)


def launch_stack_depth(tables: BVH2Tables, ro, rd, norm: float,
                       stack_depth: int = STACK_DEPTH,
                       max_steps: int = STACK_MAX_STEPS):
    """Launch K7 in its depth mode on the current stream over ``tables``
    (``stack_tables`` without triangles); returns the normalized depth
    (N,)."""
    depth, _ = _stack_launch(tables, ro, rd, None, None, 0, stack_depth,
                             False, max_steps, norm)
    return depth


def launch_linked(tables: BVH2Tables, ro, rd, active=None, t_max=None,
                  leaf_size: int = LEAF_SIZE, any_hit: bool = False,
                  max_steps: int = LINKED_MAX_STEPS):
    """Launch K8 (``csrc/bvh2.cu``) on the current stream over ``tables``
    (``linked_tables``); the rest as ``launch_stack``."""
    if tables.tris is None:
        raise ValueError("K8 takes triangle rows")
    keep, ptrs, steps = _launch_args(tables, 12, ro, rd, active, t_max,
                                     max_steps)
    n = ro.shape[0]
    t = torch.empty((n,), dtype=torch.float32, device=ro.device)
    idx = torch.empty((n,), dtype=torch.int32, device=ro.device)
    if n == 0:
        return t, idx
    err = cuda_lib.lib().wpt_bvh_linked(
        *ptrs, t.data_ptr(), idx.data_ptr(), n, tables.nodes.shape[0],
        tables.tris.shape[0], int(leaf_size), int(bool(any_hit)), steps,
        cuda_lib.stream_ptr(ro))
    cuda_lib.check(err, "wpt_bvh_linked")
    LinkedCounter.launches += 1
    return t, idx


def closest_hit_bvh_cuda(bvh_aabb, bvh_meta, tri_isect, ro, rd, active=None,
                         t_max=None, leaf_size: int = LEAF_SIZE,
                         stack_depth: int = STACK_DEPTH,
                         any_hit: bool = False,
                         max_steps: int = STACK_MAX_STEPS):
    """Stage K7's tables (``stack_tables``) and launch it on the current
    stream."""
    _check_bvh(bvh_aabb, bvh_meta, tri_isect, ro, rd, active, t_max)
    return launch_stack(stack_tables(bvh_aabb, bvh_meta, tri_isect), ro, rd,
                        active, t_max, leaf_size, stack_depth, any_hit,
                        max_steps)


def bvh_depth_cuda(bvh_aabb, bvh_meta, ro, rd, norm: float,
                   stack_depth: int = STACK_DEPTH,
                   max_steps: int = STACK_MAX_STEPS):
    """Stage K7's records and launch its depth mode on the current stream;
    returns the normalized depth (N,)."""
    _check_bvh(bvh_aabb, bvh_meta, None, ro, rd, None, None)
    return launch_stack_depth(stack_tables(bvh_aabb, bvh_meta), ro, rd, norm,
                              stack_depth, max_steps)


def closest_hit_bvh_linked_cuda(bvh_aabb, bvh_nodes, tri_isect, ro, rd,
                                active=None, t_max=None,
                                leaf_size: int = LEAF_SIZE,
                                any_hit: bool = False,
                                max_steps: int = LINKED_MAX_STEPS):
    """Stage K8's tables (``linked_tables``) and launch it on the current
    stream."""
    _check_bvh(bvh_aabb, bvh_nodes, tri_isect, ro, rd, active, t_max)
    return launch_linked(linked_tables(bvh_aabb, bvh_nodes, tri_isect), ro,
                         rd, active, t_max, leaf_size, any_hit, max_steps)


def bvh2_div(a, d):
    """K7's and K8's division (``csrc/bvh2.cu`` div_by) on float32 CUDA
    tensors of one shape, for its card test. Returns (div_by's quotients,
    ``a / d`` as the same file computes it)."""
    _need_cuda(a)
    if a.dtype != torch.float32 or d.dtype != torch.float32 or (
            a.shape != d.shape):
        raise ValueError("a and d must be float32 tensors of one shape")
    a, d = a.contiguous(), d.contiguous()
    out, ieee = torch.empty_like(a), torch.empty_like(a)
    if a.numel():
        cuda_lib.check(cuda_lib.lib().wpt_bvh_div(
            a.data_ptr(), d.data_ptr(), out.data_ptr(), ieee.data_ptr(),
            a.numel(), cuda_lib.stream_ptr(a)), "wpt_bvh_div")
    return out, ieee


def _plain_on_cpu(x) -> None:
    if x.device.type != "cpu":
        raise ValueError(f"unsupported device {x.device}")


def closest_hit_bvh(bvh_aabb, bvh_meta, tri_isect, ro, rd, active=None,
                    t_max=None, leaf_size: int = LEAF_SIZE,
                    stack_depth: int = STACK_DEPTH, any_hit: bool = False,
                    max_steps: int = STACK_MAX_STEPS):
    """The JAX ``closest_hit_bvh`` (the per-ray fixed stack, pt.wgsl:248-296):
    K7 on CUDA tensors (its tables staged on the call), its plain version
    on CPU tensors. Arguments and result as ``closest_hit_bvh_plain``'s."""
    if ro.device.type == "cuda":
        return closest_hit_bvh_cuda(bvh_aabb, bvh_meta, tri_isect, ro, rd,
                                    active, t_max, leaf_size, stack_depth,
                                    any_hit, max_steps)
    _check_bvh(bvh_aabb, bvh_meta, tri_isect, ro, rd, active, t_max)
    _plain_on_cpu(ro)
    return closest_hit_bvh_plain(bvh_aabb, bvh_meta, tri_isect, ro, rd,
                                 active, t_max, leaf_size, stack_depth,
                                 any_hit, max_steps)


def bvh_depth(bvh_aabb, bvh_meta, ro, rd, norm: float,
              stack_depth: int = STACK_DEPTH,
              max_steps: int = STACK_MAX_STEPS):
    """K7's depth mode (``bvh_depth_plain``) on (N, 3) rays: the kernel on
    CUDA tensors (its records staged on the call), the plain version on CPU
    tensors."""
    if ro.device.type == "cuda":
        return bvh_depth_cuda(bvh_aabb, bvh_meta, ro, rd, norm, stack_depth,
                              max_steps)
    _check_bvh(bvh_aabb, bvh_meta, None, ro, rd, None, None)
    _plain_on_cpu(ro)
    return bvh_depth_plain(bvh_aabb, bvh_meta, ro, rd, norm, stack_depth,
                           max_steps)


def closest_hit_bvh_linked(bvh_aabb, bvh_nodes, tri_isect, ro, rd,
                           active=None, t_max=None,
                           leaf_size: int = LEAF_SIZE, any_hit: bool = False,
                           max_steps: int = LINKED_MAX_STEPS):
    """The JAX ``closest_hit_bvh_linked`` (stackless, over the hit and miss
    links): K8 on CUDA tensors (its tables staged on the call), its plain
    version on CPU tensors. Arguments and result as
    ``closest_hit_bvh_linked_plain``'s."""
    if ro.device.type == "cuda":
        return closest_hit_bvh_linked_cuda(bvh_aabb, bvh_nodes, tri_isect,
                                           ro, rd, active, t_max, leaf_size,
                                           any_hit, max_steps)
    _check_bvh(bvh_aabb, bvh_nodes, tri_isect, ro, rd, active, t_max)
    _plain_on_cpu(ro)
    return closest_hit_bvh_linked_plain(bvh_aabb, bvh_nodes, tri_isect, ro,
                                        rd, active, t_max, leaf_size, any_hit,
                                        max_steps)


# The JAX package's ray reorder (ops/intersect.py there): a bucket key of
# the direction octant and REORDER_POS_BITS Morton bits an axis of the
# origin in the scene's root box (8 * 8**bits buckets), taken on trees of at
# least REORDER_MIN_NODES wide nodes, on calls of at least REORDER_MIN_LANES
# rays (the JAX package's COMPACT_MIN_LANES, below which its wrapper calls
# the intersector as it is). The walk takes the order alone
# (``with_ray_order``): its tail compaction, which packs the live lanes
# ahead of the dead ones, made the large box's render 3.6% slower there on
# the H100 (PERF.md section 6). The pair dispatch takes both
# (``with_tail_compaction``), because it computes another function on
# another lane order: its vote is over a block of consecutive lanes.
REORDER_POS_BITS = 2
REORDER_BUCKETS = 8 * 8 ** REORDER_POS_BITS
REORDER_MIN_NODES = 128
REORDER_MIN_LANES = 16384
# The binary-BVH walks' own thresholds, in binary nodes: the sort, gathers
# and scatters cost about 0.14 ms a 262,144-ray call on the H100, and on
# the bounce-1 rays of boxes of 33 to 66,523 binary nodes the order paid K7
# from 12,835 nodes (even at 8,943) and K8 from 19,603 (0.99x at 12,835;
# PERF.md).
BVH2_REORDER_MIN_NODES = {"stack": 12_000, "bvh": 19_000}
# The compaction's tiers (the JAX package's COMPACT_DIVS and
# COMPACT_TIER_MIN_LANES): n // div lanes, a tier of fewer than
# COMPACT_TIER_MIN_LANES being skipped.
COMPACT_DIVS = (2, 8, 32, 128)
COMPACT_TIER_MIN_LANES = 2048


def bucket_keys(ro3, rd3, root_box):
    """The JAX package's ``_with_bucket_reorder`` key of each ray: three
    octant bits (bit a set when d[a] < 0), then REORDER_POS_BITS Morton bits
    an axis of the origin quantised over ``root_box`` [min3 | max3], most
    significant first, x before y before z. Its arithmetic: the extent is
    max(max - min, 1e-6), the float-to-int cast truncates toward zero, then
    the clip. Returns (N,) int32 in [0, REORDER_BUCKETS)."""
    bits = REORDER_POS_BITS
    q = (1 << bits) - 1
    lo = root_box[0:3, None]
    ext = torch.clamp_min(root_box[3:6, None] - lo, 1e-6)
    c = torch.clamp(((ro3 - lo) / ext * (q + 1)).to(torch.int32), 0, q)
    neg = (rd3 < 0.0).to(torch.int32)
    key = neg[0] + 2 * neg[1] + 4 * neg[2]
    for b in range(bits):
        for a in range(3):
            key = (key << 1) | ((c[a] >> (bits - 1 - b)) & 1)
    return key


def ray_order(ro3, rd3, root_box):
    """The lane order of the sorted walk: one stable sort of the rays by
    ``bucket_keys``; lane j of the sorted call holds ray ``order[j]``. The
    same permutation as the JAX package's one-hot counting sort, made
    without a host sync."""
    return torch.argsort(bucket_keys(ro3, rd3, root_box), stable=True)


def sorted_call(inner, ro3, rd3, active, t_max, any_hit, root_box):
    """``inner`` on the rays in ``ray_order``: rays, ``active`` and
    ``t_max`` gathered into the sorted lanes, (t, idx) scattered back to
    each ray's own lane."""
    order = ray_order(ro3, rd3, root_box)

    def take(x):
        return None if x is None else x.index_select(-1, order)

    t, idx = inner(take(ro3), take(rd3), take(active), take(t_max), any_hit)
    return (torch.empty_like(t).index_copy_(0, order, t),
            torch.empty_like(idx).index_copy_(0, order, idx))


def with_ray_order(inner, root_box=None):
    """Wrap a closest hit so that bounce rays (``reorder=True``) are walked
    in ``ray_order`` (``sorted_call``). Each ray is walked alone, so the
    answer does not depend on the order. Calls without ``root_box``, of
    fewer than REORDER_MIN_LANES rays, or with ``reorder`` False (camera
    rays and bounce 0's shadow rays) go straight to ``inner``."""

    def wrapped(ro3, rd3, active=None, t_max=None, any_hit=False,
                reorder=False):
        if (root_box is None or not reorder
                or ro3.shape[1] < REORDER_MIN_LANES):
            return inner(ro3, rd3, active, t_max, any_hit)
        return sorted_call(inner, ro3, rd3, active, t_max, any_hit, root_box)

    return wrapped


def compaction_tier(live: int, n: int):
    """The lanes of the smallest tier n // div (``COMPACT_DIVS``, tiers of
    fewer than COMPACT_TIER_MIN_LANES skipped) that holds ``live`` lanes,
    or None when none does."""
    for div in sorted(COMPACT_DIVS, reverse=True):
        k = n // div
        if k >= COMPACT_TIER_MIN_LANES and live <= k:
            return k
    return None


def with_tail_compaction(inner, root_box, use_reorder: bool = True):
    """Wrap a closest hit as the JAX package's ``_with_tail_compaction``
    wraps its pair dispatch, handing ``inner`` exactly the lanes that it
    hands it:

    * a call without ``active``, or of fewer than REORDER_MIN_LANES rays,
      goes to ``inner`` as it is, whatever ``reorder`` says;
    * a call whose live lanes fit a tier (``compaction_tier``) goes to
      ``inner`` on that tier's k lanes: the live rays in ascending order,
      then fill lanes that carry ray 0's origin, direction and ``t_max``
      with ``active`` False (``jnp.nonzero(active, size=k,
      fill_value=n)``); with ``use_reorder`` the k lanes, fill lanes
      included, are sorted by ``ray_order`` first. This does not depend on
      ``reorder``: a sparse shadow call of bounce 0 is compacted too. The
      results are scattered back, and a dead lane gets (inf, -1);
    * any other call is sorted whole when ``reorder`` and ``use_reorder``
      are both set, and goes to ``inner`` as it is otherwise.

    The live count picks the tier, so the wrapper reads it on the host once
    a call: one synchronisation a call on this route (``torch.nonzero``),
    which a CUDA graph of the bounce loop would have to lift.
    ``use_reorder`` follows the JAX package's ``big_tree``: set for a scene
    without walk tables, and for one with at least REORDER_MIN_NODES wide
    nodes."""

    def inner_sorted(ro3, rd3, active, t_max, any_hit):
        if not use_reorder:
            return inner(ro3, rd3, active, t_max, any_hit)
        return sorted_call(inner, ro3, rd3, active, t_max, any_hit, root_box)

    def wrapped(ro3, rd3, active=None, t_max=None, any_hit=False,
                reorder=False):
        n = ro3.shape[1]
        if active is None or n < REORDER_MIN_LANES:
            return inner(ro3, rd3, active, t_max, any_hit)
        lanes = torch.nonzero(active).squeeze(1)  # ascending; a host sync
        k = compaction_tier(lanes.numel(), n)
        if k is None:
            call = inner_sorted if reorder else inner
            return call(ro3, rd3, active, t_max, any_hit)
        live = lanes.numel()
        slots = torch.zeros((k,), dtype=lanes.dtype, device=lanes.device)
        slots[:live] = lanes  # the fill lanes take ray 0
        valid = torch.arange(k, device=lanes.device) < live
        t_k, i_k = inner_sorted(
            ro3.index_select(1, slots), rd3.index_select(1, slots), valid,
            None if t_max is None else t_max.index_select(0, slots),
            any_hit)
        t = torch.full((n,), math.inf, dtype=t_k.dtype, device=t_k.device)
        idx = torch.full((n,), -1, dtype=i_k.dtype, device=i_k.device)
        return (t.index_copy_(0, lanes, t_k[:live]),
                idx.index_copy_(0, lanes, i_k[:live]))

    return wrapped


# The intersectors, the JAX package's names.
INTERSECTORS = ("auto", "brute", "walk", "walk_hbm", "pairs", "phased",
                "cluster", "bvh", "stack")


def check_intersector(intersector: str) -> None:
    """Raise ValueError for a name that is not an intersector."""
    if intersector not in INTERSECTORS:
        raise ValueError(f"unknown intersector {intersector!r}")


def pairs_reorder(scene: dict) -> bool:
    """``use_reorder`` of the pair route (the JAX package's ``big_tree``):
    set for a scene without walk tables, else for a tree of at least
    REORDER_MIN_NODES wide nodes."""
    from wgpu_path_tracing_tpu_torch.models.types import WALK_KEYS

    if not all(key in scene for key in WALK_KEYS):
        return True
    return scene["walk_order"].shape[0] >= REORDER_MIN_NODES


def make_closest_hit(scene: dict, intersector: str = "auto",
                     brute_max_tris: int = 4096, leaf_size: int = LEAF_SIZE):
    """Pick the intersection strategy for this scene, as the JAX package's
    ``make_closest_hit`` does, without its TPU residency budgets.

    * "auto": the dense intersector (K1) at or below ``brute_max_tris``
      triangles; above, the wide-BVH walk (K3) when the scene has walk
      tables, else the pair dispatch (K4). A scene has no walk tables when
      its wide tree is too deep for the walk's stack.
    * "brute": K1. "pairs": K4. "cluster": the round dispatch (K6).
    * "stack": the binary BVH walked with a fixed stack per ray (K7,
      ``closest_hit_bvh``); "bvh": the same tree walked over its hit and
      miss links (K8, ``closest_hit_bvh_linked``). Both test at most
      ``leaf_size`` triangles a leaf, as the JAX package's do. "auto" takes
      neither: the JAX package's choice of the linked walk for large scenes
      on its CPU backend is a habit of a TPU's host, not the card's.
      Their kernels' tables (``stack_tables``, ``linked_tables``) are
      staged here, once a scene, on the scene's device, and CUDA calls
      launch the kernel over them (``launch_stack``, ``launch_linked``);
      CPU calls take the plain version over the scene's own tables.
    * "walk": K3, or quietly K4 for a scene without walk tables.
      "walk_hbm", the JAX package's paged walk, computes the resident
      walk's function bit for bit; the port runs it as "walk" (K3) and
      reports "walk_hbm". The TPU's VMEM capacity check that the JAX
      package makes for it has no counterpart on the card.
    * "phased": the phased group dispatch (K5), which reads the walk's leaf
      table; without walk tables it falls through to K4, as in the JAX
      package.

    An unknown intersector raises (``check_intersector``).

    The dense hit goes through the K1 wrapper over origin and direction
    rows (``ops/dense_hit.py::closest_hit_dense_rows``: no copy) and,
    as in the JAX package's dense branch, accepts and ignores ``active``,
    ``t_max`` and ``any_hit``: every ray is tested and the closest hit
    returned, which gives the same occlusion answers. The others go through
    their wrappers (``ops/walk.py``, ``ops/pairs.py``, ``ops/phased.py``,
    ``ops/cluster.py``) and honour ``active`` and ``t_max``; the walk and
    the two binary-BVH walks stop early on ``any_hit``. Each wrapper runs
    its CUDA kernel on CUDA tensors and its plain version on CPU tensors.

    ``reorder`` marks incoherent rays (the bounce loops pass ``bounce_idx >
    0``, as the JAX package's do). Every strategy takes it. The walk, on a
    tree of REORDER_MIN_NODES wide nodes or more, and the binary-BVH walks,
    on one of BVH2_REORDER_MIN_NODES[intersector] binary nodes or more,
    walk such a call's rays in ``ray_order`` (``with_ray_order``). Every route to the pair
    dispatch ("pairs", and "auto", "walk" and "phased" without walk
    tables) goes through ``with_tail_compaction``, as the JAX package's
    does: sparse calls on a compacted tier, bounce rays sorted.

    Returns closest_hit(ro3, rd3, active=None, t_max=None, any_hit=False,
    reorder=False) over SoA (3, N) origins and directions; its ``strategy``
    attribute is "brute", "walk", "walk_hbm", "pairs", "phased",
    "cluster", "stack" or "bvh".
    """
    from wgpu_path_tracing_tpu_torch.models.types import WALK_KEYS
    from wgpu_path_tracing_tpu_torch.ops import (
        cluster,
        dense_hit,
        pairs,
        phased,
        walk,
    )

    check_intersector(intersector)
    num_tris = scene["tri_isect"].shape[0]
    have_walk = all(key in scene for key in WALK_KEYS)
    if intersector in ("stack", "bvh"):
        aabb, tri = scene["bvh_aabb"], scene["tri_isect"]
        if intersector == "stack":
            meta = scene["bvh_meta"]
            staged, launch = stack_tables(aabb, meta, tri), launch_stack

            def plain(ro, rd, active, t_max, any_hit):
                return closest_hit_bvh(aabb, meta, tri, ro, rd, active,
                                       t_max, leaf_size, any_hit=any_hit)
        else:
            nodes = linked_nodes(scene["bvh_meta"], scene["bvh_links"])
            staged, launch = linked_tables(aabb, nodes, tri), launch_linked

            def plain(ro, rd, active, t_max, any_hit):
                return closest_hit_bvh_linked(aabb, nodes, tri, ro, rd,
                                              active, t_max, leaf_size,
                                              any_hit=any_hit)

        def bvh_hit(ro3, rd3, active=None, t_max=None, any_hit=False):
            if ro3.device.type == "cuda":
                return launch(staged, ro3.T, rd3.T, active, t_max, leaf_size,
                              any_hit=any_hit)
            return plain(ro3.T, rd3.T, active, t_max, any_hit)

        big = aabb.shape[0] >= BVH2_REORDER_MIN_NODES[intersector]
        closest_hit = with_ray_order(bvh_hit,
                                     scene["root_box"] if big else None)
        strategy = intersector
    elif intersector == "brute" or (intersector == "auto"
                                  and num_tris <= brute_max_tris):
        tri = scene["tri_isect"]

        def closest_hit(ro3, rd3, active=None, t_max=None, any_hit=False,
                        reorder=False):
            del active, t_max, any_hit, reorder
            return dense_hit.closest_hit_dense_rows(tri, ro3, rd3)

        strategy = "brute"
    elif intersector == "phased" and have_walk:
        tables = phased.phased_tables(scene["walk_tris"])

        def closest_hit(ro3, rd3, active=None, t_max=None, any_hit=False,
                        reorder=False):
            del reorder
            return phased.closest_hit_phased(tables, ro3, rd3, active,
                                             t_max, num_tris=num_tris,
                                             any_hit=any_hit)

        strategy = "phased"
    elif intersector == "cluster":
        tables = cluster.cluster_tables(scene)

        def closest_hit(ro3, rd3, active=None, t_max=None, any_hit=False,
                        reorder=False):
            del reorder
            return cluster.closest_hit_cluster(tables, ro3, rd3, active,
                                               t_max, num_tris=num_tris,
                                               any_hit=any_hit)

        strategy = "cluster"
    elif intersector in ("auto", "walk", "walk_hbm") and have_walk:
        tables = walk.walk_tables(scene)

        def walk_hit(ro3, rd3, active=None, t_max=None, any_hit=False):
            return walk.closest_hit_walk(tables, ro3, rd3, active, t_max,
                                         num_tris=num_tris, any_hit=any_hit)

        big = tables.order.shape[0] >= REORDER_MIN_NODES
        closest_hit = with_ray_order(walk_hit,
                                     scene["root_box"] if big else None)
        strategy = "walk_hbm" if intersector == "walk_hbm" else "walk"
    else:
        tables = pairs.pair_tables(scene)

        def pairs_hit(ro3, rd3, active=None, t_max=None, any_hit=False):
            return pairs.closest_hit_pairs(tables, ro3, rd3, active, t_max,
                                           num_tris=num_tris,
                                           any_hit=any_hit)

        closest_hit = with_tail_compaction(pairs_hit, scene["root_box"],
                                           pairs_reorder(scene))
        strategy = "pairs"
    closest_hit.strategy = strategy
    return closest_hit
