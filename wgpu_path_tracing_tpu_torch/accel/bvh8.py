"""Wide (8- or 16-ary) BVH collapse for the BVH walk (``ops/walk.py``, K3).

A NumPy copy of the JAX package's ``accel/bvh8.py``: widths 8 and 16 and
the "none", "ffd" and "slice" leaf packs. The tables are array-equal to the
original's (``tests/test_torch_bvh8.py``, ``tests/test_torch_wide16.py``),
so both packages walk the same tree.

The binary SAH tree (``accel/bvh.py``) is collapsed into a ``width``-wide
hierarchy (W below; 8 by default) whose leaves are groups of <= LEAF_SLOTS
triangles:

* ``meta`` (Nn, W) int32: child slot encoding. > 0 interior child (wide
  node id), < 0 leaf (group ``g = -m - 1``), == 0 empty (its box is NaN;
  node 0 is the root and is never anyone's child).
* ``boxes`` (Nn * 8 * W, 8) f32: per (node, ray-direction octant) a W-row
  slab at ``(n*8 + oct) * W``. Row k is the k-th child in push order, its
  bounds on lanes 0..5 (minx..maxz); empty-child rows hold NaN. Push order
  is far-to-near along the octant's sign vector (octant bit a = 1 when
  d[a] < 0), so a LIFO stack that pushes slots 0..W-1 pops the nearest
  child first.
* ``order`` (Nn, 8 * W) int32: ``order[n, oct*W + k]`` is the meta of the
  k-th pushed child (0 = empty slot). The walk reads W from its shape.
* ``tris`` (Ng * group_rows(SUB), 128) f32: per leaf group a slab of
  LEAF_SLOTS triangle slots on lanes. Rows 0-8 hold [v0, e1, e2], row 9 the
  global triangle index (-1 on padding slots), rows 16..16+SUB the
  sub-cluster AABBs (sub-cluster c at row 16 + c, bounds on lanes 0..5,
  NaN when the sub-cluster holds no triangle). Each sub-cluster box gates
  Möller-Trumbore over its LEAF_SLOTS // SUB slots.

``build_wide_bvh`` runs the C++ twin (``accel/cbvh/wide_collapse.cpp``,
bound by ``accel/native.py``) for the "none" and "ffd" packs at width 8
when the library has a compiler; this NumPy path is its plain version, and
``tests/test_torch_native.py`` holds the two bit-identical. The "slice"
pack and width 16 (the JAX package's experimental collapses) have no C++
twin there or here: they take this NumPy path.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np

from wgpu_path_tracing_tpu_torch.accel import native
from wgpu_path_tracing_tpu_torch.accel.bvh import subtree_ranges

WIDTH = 8
WIDTHS = (8, 16)  # the collapses K3 walks (csrc/walk.cu instantiations)
PACKS = ("none", "ffd", "slice")
OCTANTS = 8  # per-ray-direction-sign slab replicas (3 sign bits)
LEAF_SLOTS = 128  # triangle slots per leaf group
SUB = 16  # sub-clusters per leaf group, the Möller-Trumbore gating unit
MAX_STACK = 512  # the JAX walk kernel's DFS stack entries


def pops_for_tree(num_wide_nodes: int) -> int:
    """Stack entries the JAX walk kernel pops per loop iteration (2 for
    every tree); the build-time stack-depth guard uses it, as the JAX
    package's does, so both packages omit the walk tables for the same
    trees."""
    return 2


class WideBVHDepthError(ValueError):
    """Wide tree too deep for the walk kernel's DFS stack bound."""


def wide_depth(wmeta: np.ndarray) -> int:
    """Interior levels on the longest root-to-leaf path (root = 1).

    Fixpoint sweep: each pass propagates child depths one level, so it
    settles within one pass per level."""
    nn = wmeta.shape[0]
    kids = np.clip(wmeta, 0, None)  # (nn, width); 0 is never a real child
    interior = wmeta > 0
    depth = np.ones(nn, np.int64)
    for _ in range(nn + 1):
        kd = np.where(interior, depth[kids], 0).max(axis=1)
        new = np.maximum(depth, 1 + np.where(kd > 0, kd, 0))
        if (new == depth).all():
            break
        depth = new
    return int(depth[0])


def _check_stack_depth(wmeta: np.ndarray) -> None:
    """The JAX walk kernel's stack holds MAX_STACK entries; a K-pop DFS
    leaves at most (WIDTH-1)*K lingering entries per interior level plus
    the WIDTH*K pushes in flight, so the wide-tree depth bounds the worst
    case."""
    width = wmeta.shape[1]
    depth = wide_depth(wmeta)
    pops = pops_for_tree(wmeta.shape[0])
    need = pops * (depth * (width - 1) + width)
    if need > MAX_STACK:
        raise WideBVHDepthError(
            f"wide-BVH depth {depth} needs a {need}-entry DFS "
            f"stack > MAX_STACK={MAX_STACK} at pops={pops}; this tree "
            "is pathologically deep (degenerate SAH spine) — "
            "pack_device_scene catches this and omits the walk tables"
        )


def group_rows(sub: int) -> int:
    """Rows of one leaf-group slab: rows 0-9 (components + index) padded
    to 16, then ``sub`` sub-box rows padded to a multiple of 8."""
    return 16 + -(-sub // 8) * 8


@dataclasses.dataclass
class WideBVH:
    meta: np.ndarray  # (Nn, W) int32
    order: np.ndarray  # (Nn, 8 * W) int32: per-octant ordered child metas
    boxes: np.ndarray  # (Nn * 8 * W, 8) f32: per-octant ordered slabs
    tris: np.ndarray  # (Ng * group_rows(SUB), 128) f32

    @property
    def width(self) -> int:
        return int(self.meta.shape[1])

    @property
    def num_nodes(self) -> int:
        return int(self.meta.shape[0])

    @property
    def num_groups(self) -> int:
        return int(self.tris.shape[0]) // group_rows(SUB)


def build_wide_bvh(
    aabb_min: np.ndarray,
    aabb_max: np.ndarray,
    meta: np.ndarray,
    tri_isect: np.ndarray,
    pack: str = "ffd",
    prefer_native: bool = True,
    width: int = WIDTH,
) -> WideBVH:
    """Collapse the binary BVH into the walk's wide tables.

    ``tri_isect``: (T, 9) [v0, e1, e2] rows in BVH (DFS) triangle order;
    leaf groups copy them into lane-major slabs. ``pack`` selects how small
    sibling subtrees share leaf groups: "none" = one subtree per group,
    "ffd" = first-fit-decreasing bin-pack on subtree boundaries (the
    default; fuller groups, fewer group visits), "slice" = the smalls'
    triangle ranges concatenated in DFS order and cut at exact LEAF_SLOTS
    boundaries (full groups; a group's box from its own triangles).
    ``width`` (8 or 16) is the interior fan-out: 16 halves the interior
    levels at twice the slab rows a visit. ``prefer_native`` takes the C++
    collapse for "none" and "ffd" at width 8 when
    ``native.native_available()``; False, no compiler, or any other
    combination, this NumPy path (the same tables).
    """
    if pack not in PACKS:
        raise ValueError(f"pack={pack!r}: expected one of {PACKS}")
    if width not in WIDTHS:
        raise ValueError(f"width={width}: expected one of {WIDTHS}")
    leaf_slots, sub = LEAF_SLOTS, SUB
    t = int(tri_isect.shape[0])
    grows = group_rows(sub)
    if (t > 0 and prefer_native and pack in ("none", "ffd")
            and width == WIDTH and native.native_available()):
        wm, wo, wb, wt = native.build_wide_native(
            aabb_min, aabb_max, meta, tri_isect, leaf_slots, sub, grows,
            pack=pack)
        _check_stack_depth(wm)
        return WideBVH(meta=wm, order=wo, boxes=wb, tris=wt)
    if t == 0:
        # Degenerate: one node, all children empty.
        m = np.zeros((1, width), np.int32)
        b = np.full((OCTANTS * width, 8), np.nan, np.float32)
        tris = np.zeros((grows, leaf_slots), np.float32)
        tris[9, :] = -1.0
        order = np.zeros((1, OCTANTS * width), np.int32)
        return WideBVH(meta=m, order=order, boxes=b, tris=tris)

    lo, hi = subtree_ranges(meta)
    is_leaf = meta[:, 3] > 0

    wide_meta: list[np.ndarray] = []
    wide_boxes: list[np.ndarray] = []
    # Per leaf group: list of (lo, count) tri ranges (a group may pack
    # several small sibling subtrees, see _pack_bins).
    groups: list[list[tuple[int, int]]] = []

    def count(b: int) -> int:
        return int(hi[b] - lo[b])

    def emit_group(glo: int, gcnt: int) -> int:
        gid = len(groups)
        groups.append([(glo, gcnt)])
        return -(gid + 1)

    def emit_group_multi(members: list[int]) -> int:
        gid = len(groups)
        groups.append(
            [(int(lo[e]), count(e)) for e in sorted(members, key=lambda e: lo[e])]
        )
        return -(gid + 1)

    def emit_group_ranges(ranges: list[tuple[int, int]]) -> int:
        gid = len(groups)
        groups.append(list(ranges))
        return -(gid + 1)

    def alloc_node() -> int:
        wide_meta.append(np.zeros(width, np.int32))
        wide_boxes.append(np.full((width, 6), np.nan, np.float32))
        return len(wide_meta) - 1

    def _pack_bins(smalls: list[int]) -> list[list[int]]:
        """First-fit-decreasing bin-pack of small subtrees into
        leaf_slots-capacity groups. Input order breaks count ties, so the
        result is deterministic."""
        order = sorted(range(len(smalls)), key=lambda i: (-count(smalls[i]), i))
        bins: list[list[int]] = []
        room: list[int] = []
        for i in order:
            e = smalls[i]
            c = count(e)
            placed = False
            for k in range(len(bins)):
                if room[k] >= c:
                    bins[k].append(e)
                    room[k] -= c
                    placed = True
                    break
            if not placed:
                bins.append([e])
                room.append(leaf_slots - c)
        return bins

    def build(b: int) -> int:
        """Wide node for binary subtree b (count(b) may exceed leaf_slots,
        or b may be an oversized binary leaf)."""
        nid = alloc_node()
        if is_leaf[b] and count(b) > leaf_slots:
            # Oversized binary leaf: chunk it. Chunks share b's box.
            chunks = [
                (base, min(leaf_slots, int(hi[b]) - base))
                for base in range(int(lo[b]), int(hi[b]), leaf_slots)
            ]
            slots: list[tuple[int, np.ndarray]] = []
            for base, cnt in chunks[: width - 1]:
                slots.append((emit_group(base, cnt), _box_of(b)))
            rest = chunks[width - 1 :]
            if len(rest) == 1:
                slots.append((emit_group(*rest[0]), _box_of(b)))
            elif rest:
                # Too many chunks for one node: chain via a pseudo subtree.
                slots.append((build_chunks(rest, b), _box_of(b)))
            _fill(nid, slots)
            return nid

        # Collect sub-roots by repeatedly expanding the largest
        # still-oversized interior element; an expansion is kept while the
        # packed slot demand (oversized elems + bin-packed smalls) fits
        # the node.
        elems = [b]

        def slot_demand(es: list[int]) -> int:
            smalls = [e for e in es if count(e) <= leaf_slots]
            overs = len(es) - len(smalls)
            if pack == "slice":
                total = sum(count(e) for e in smalls)
                return overs + -(-total // leaf_slots)
            if pack == "ffd":
                return overs + len(_pack_bins(smalls))
            return overs + len(smalls)

        while True:
            cand = [
                e for e in elems if not is_leaf[e] and count(e) > leaf_slots
            ]
            if not cand:
                break
            e = max(cand, key=count)
            trial = list(elems)
            i = trial.index(e)
            trial[i : i + 1] = [int(meta[e, 0]), int(meta[e, 1])]
            if slot_demand(trial) > width:
                break
            elems = trial

        smalls = [e for e in elems if count(e) <= leaf_slots]
        slots = []
        if pack == "slice" and smalls:
            # The smalls' triangle ranges in DFS order, cut at exact
            # leaf_slots boundaries (a subtree may split across groups).
            runs = [(int(lo[e]), count(e))
                    for e in sorted(smalls, key=lambda e: lo[e])]
            cur: list[tuple[int, int]] = []
            room = leaf_slots
            for glo, gcnt in runs:
                while gcnt > 0:
                    take = min(room, gcnt)
                    cur.append((glo, take))
                    glo += take
                    gcnt -= take
                    room -= take
                    if room == 0:
                        slots.append((emit_group_ranges(cur),
                                      _box_of_ranges(cur)))
                        cur, room = [], leaf_slots
            if cur:
                slots.append((emit_group_ranges(cur), _box_of_ranges(cur)))
        elif pack == "ffd":
            for members in _pack_bins(smalls):
                box = _union_box(members)
                if len(members) == 1:
                    slots.append(
                        (emit_group(int(lo[members[0]]), count(members[0])),
                         box)
                    )
                else:
                    slots.append((emit_group_multi(members), box))
        else:
            # pack="none": one subtree per slot, interleaved in elems
            # order (group and node ids are allocation order).
            for e in elems:
                if count(e) <= leaf_slots:
                    slots.append(
                        (emit_group(int(lo[e]), count(e)), _box_of(e))
                    )
                else:
                    slots.append((build(e), _box_of(e)))
            _fill(nid, slots)
            return nid
        for e in elems:
            if count(e) > leaf_slots:
                slots.append((build(e), _box_of(e)))
        _fill(nid, slots)
        return nid

    def build_chunks(chunks: list[tuple[int, int]], box_node: int) -> int:
        nid = alloc_node()
        slots = []
        for base, cnt in chunks[: width - 1]:
            slots.append((emit_group(base, cnt), _box_of(box_node)))
        rest = chunks[width - 1 :]
        if len(rest) == 1:
            slots.append((emit_group(*rest[0]), _box_of(box_node)))
        elif rest:
            slots.append((build_chunks(rest, box_node), _box_of(box_node)))
        _fill(nid, slots)
        return nid

    def _box_of(b: int) -> np.ndarray:
        return np.concatenate([aabb_min[b], aabb_max[b]]).astype(np.float32)

    def _union_box(members: list[int]) -> np.ndarray:
        mins = aabb_min[members].min(axis=0)
        maxs = aabb_max[members].max(axis=0)
        return np.concatenate([mins, maxs]).astype(np.float32)

    tri_f = np.asarray(tri_isect, np.float32)

    def _box_of_ranges(ranges: list[tuple[int, int]]) -> np.ndarray:
        rows = np.concatenate([tri_f[glo:glo + c] for glo, c in ranges])
        v0 = rows[:, 0:3]
        allv = np.concatenate([v0, v0 + rows[:, 3:6], v0 + rows[:, 6:9]])
        return np.concatenate([allv.min(axis=0),
                               allv.max(axis=0)]).astype(np.float32)

    def _fill(nid: int, slots: list[tuple[int, np.ndarray]]) -> None:
        assert len(slots) <= width
        for c, (m, box) in enumerate(slots):
            wide_meta[nid][c] = m
            wide_boxes[nid][c] = box

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10000))
    try:
        root = build(0)
    finally:
        sys.setrecursionlimit(old_limit)
    assert root == 0

    nn = len(wide_meta)
    meta_arr = np.stack(wide_meta).astype(np.int32)  # (Nn, width)
    boxes_arr = np.zeros((nn * OCTANTS * width, 8), np.float32)
    order_arr = np.zeros((nn, OCTANTS * width), np.int32)
    for n in range(nn):
        wb = wide_boxes[n]  # (width, 6) child-major, NaN on empty slots
        center = (wb[:, 0:3] + wb[:, 3:6]) * 0.5  # NaN on empties
        for oct_ in range(OCTANTS):
            sign = np.where(
                [oct_ & 1, oct_ & 2, oct_ & 4], -1.0, 1.0
            )  # ray-direction signs for this octant
            key = center @ sign
            key = np.where(np.isnan(key), -np.inf, key)  # empties last
            # Push order far-to-near along the ray: descending center.sign.
            perm = np.argsort(-key, kind="stable")
            order_arr[n, oct_ * width : (oct_ + 1) * width] = meta_arr[
                n, perm
            ]
            r0 = (n * OCTANTS + oct_) * width
            boxes_arr[r0 : r0 + width, 0:6] = wb[perm]

    # Leaf slabs: slots beyond a group's count pad with rejecting rows.
    ng = len(groups)
    tris = np.zeros((ng * grows, leaf_slots), np.float32)
    tri = tri_f
    sub_w = leaf_slots // sub
    for g, ranges in enumerate(groups):
        r0 = g * grows
        rows = np.concatenate(
            [tri[glo : glo + gcnt] for glo, gcnt in ranges], axis=0
        )  # (cnt, 9)
        gcnt = rows.shape[0]
        tris[r0 : r0 + 9, :gcnt] = rows.T
        tris[r0 + 9, :gcnt] = np.concatenate(
            [np.arange(glo, glo + gcnt_, dtype=np.float32)
             for glo, gcnt_ in ranges]
        )
        tris[r0 + 9, gcnt:] = -1.0
        # Sub-cluster AABBs from triangle vertices (v0, v0+e1, v0+e2):
        # sub s at row r0 + 16 + s, bounds on lanes 0..5.
        for s in range(sub):
            a, b2 = s * sub_w, min((s + 1) * sub_w, gcnt)
            if a >= gcnt:
                tris[r0 + 16 + s, 0:6] = np.nan
                continue
            v0 = rows[a:b2, 0:3]
            v1 = v0 + rows[a:b2, 3:6]
            v2 = v0 + rows[a:b2, 6:9]
            allv = np.concatenate([v0, v1, v2], axis=0)
            tris[r0 + 16 + s, 0:3] = allv.min(axis=0)
            tris[r0 + 16 + s, 3:6] = allv.max(axis=0)

    _check_stack_depth(meta_arr)
    return WideBVH(meta=meta_arr, order=order_arr, boxes=boxes_arr, tris=tris)
