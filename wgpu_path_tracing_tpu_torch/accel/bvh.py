"""SAH BVH builder (host-side, vectorized NumPy).

Reimplements the semantics of the reference builder (bvh.ts:53-229):

* iterative explicit work queue, LIFO (bvh.ts:80-81: ``workQueue.pop()``),
  left task pushed before right (bvh.ts:141-151) so the right child is
  processed first,
* leaf when ``count <= max_leaf_size`` (default 4, bvh.ts:86),
* split axis = max-extent axis of the subrange AABB with the reference's
  strict-greater tie-breaking (aabb.ts:52-66: x only if strictly greater than
  both y and z, then y, else z),
* triangles sorted in place along the axis by centroid ``(v0+v1+v2)/3``
  (bvh.ts:100-102, 167-169),
* SAH over ``num_bins`` count-ratio candidate splits — object-median binning
  by count, NOT spatial bins (bvh.ts:173-202:
  ``splitIndex = start + floor(num * i / bins)``), cost =
  ``TRAVERSAL_COST + (SA_L·n_L + SA_R·n_R) · INTERSECTION_TEST_COST`` with
  costs 1 and 2 (bvh.ts:206-228),
* flat node array: children appended in (left, right) order; interior nodes
  have ``triangleCount == 0`` (bvh.ts:113-138); node 0 is the root.

Differences from the reference (permitted — host-side, output-equivalent):
prefix/suffix AABB sweeps make all candidate costs O(n) instead of re-scanning
per candidate, and the sort is NumPy stable argsort over an index permutation
(the reference's partial quicksort, arr.ts:1-109, is unstable; ordering among
equal centroids is unspecified there).

Returns the node arrays plus the triangle permutation so the caller can
reorder the actual triangle storage (the reference reorders in place and
extracts emissive lights AFTER the reorder, gpu.ts:119-138).
"""

from __future__ import annotations

import dataclasses

import numpy as np

TRAVERSAL_COST = 1.0  # bvh.ts:206
INTERSECTION_TEST_COST = 2.0  # bvh.ts:209


@dataclasses.dataclass
class BVH:
    aabb_min: np.ndarray  # (B, 3) f32
    aabb_max: np.ndarray  # (B, 3) f32
    meta: np.ndarray  # (B, 4) i32: left, right, triangleOffset, triangleCount
    order: np.ndarray  # (T,) permutation: new position i holds old triangle order[i]

    @property
    def num_nodes(self) -> int:
        return int(self.meta.shape[0])

    def max_depth(self) -> int:
        """Tree depth (root = 1); bounds the traversal stack."""
        depth = 0
        stack = [(0, 1)]
        while stack:
            node, d = stack.pop()
            depth = max(depth, d)
            if self.meta[node, 3] == 0:
                stack.append((self.meta[node, 0], d + 1))
                stack.append((self.meta[node, 1], d + 1))
        return depth


def _surface_area(mn: np.ndarray, mx: np.ndarray) -> np.ndarray:
    d = mx - mn
    return 2.0 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 2] * d[..., 0])


def build_links(meta: np.ndarray) -> np.ndarray:
    """Thread the BVH for stackless traversal: (B, 2) i32 [hit, miss] links.

    ``hit``  = next node when this node's AABB is hit (first child for
    interior nodes; for leaves, same as miss), ``miss`` = next node when it
    is missed or its subtree is done. -1 terminates.

    The thread order is left-first depth-first — exactly the visit order of
    the reference's explicit stack (pt.wgsl:281-287 pushes right then left,
    so left pops first), so closest-hit tie-breaking is identical while the
    TPU traversal needs no per-ray stack (and so no scatters).
    """
    b = meta.shape[0]
    hit = np.full(b, -1, np.int32)
    miss = np.full(b, -1, np.int32)
    # Iterative DFS carrying the "next node after my subtree" continuation.
    stack = [(0, -1)]
    while stack:
        node, cont = stack.pop()
        miss[node] = cont
        left, right, _off, count = meta[node]
        if count > 0:  # leaf
            hit[node] = cont
        else:
            hit[node] = left
            # visit left subtree first, then right, then cont
            stack.append((right, cont))
            stack.append((left, right))
    return np.stack([hit, miss], axis=1).astype(np.int32)


def build_bvh(
    v0: np.ndarray,
    v1: np.ndarray,
    v2: np.ndarray,
    max_leaf_size: int = 4,
    num_bins: int = 12,
) -> BVH:
    num_tris = int(v0.shape[0])
    if num_tris == 0:
        # Degenerate empty scene: single empty leaf.
        return BVH(
            aabb_min=np.zeros((1, 3), np.float32),
            aabb_max=np.zeros((1, 3), np.float32),
            meta=np.array([[-1, -1, 0, 0]], np.int32),
            order=np.zeros((0,), np.int64),
        )

    v0 = np.asarray(v0, np.float64)
    v1 = np.asarray(v1, np.float64)
    v2 = np.asarray(v2, np.float64)
    tri_min = np.minimum(np.minimum(v0, v1), v2)
    tri_max = np.maximum(np.maximum(v0, v1), v2)
    # Sort keys in f32 to match the reference's f32 centroid ordering
    # (bvh.ts:95-102): centroids that tie in f32 but differ in f64 would
    # otherwise order differently and build a structurally different (still
    # valid) tree. AABB sweeps stay f64 (exact min/max).
    centroid = ((v0 + v1 + v2) / 3.0).astype(np.float32)

    order = np.arange(num_tris)

    # Node storage (grown geometrically).
    node_min: list[np.ndarray] = []
    node_max: list[np.ndarray] = []
    node_meta: list[list[int]] = []

    root_min = tri_min.min(axis=0)
    root_max = tri_max.max(axis=0)
    node_min.append(root_min)
    node_max.append(root_max)
    node_meta.append([-1, -1, 0, num_tris])

    # LIFO work queue, matching bvh.ts:74-81.
    queue: list[tuple[int, int, int]] = [(0, 0, num_tris)]

    while queue:
        node_idx, start, end = queue.pop()
        n = end - start

        if n <= max_leaf_size:
            node_meta[node_idx] = [-1, -1, start, n]
            continue

        idx = order[start:end]
        sub_min = tri_min[idx].min(axis=0)
        sub_max = tri_max[idx].max(axis=0)
        ext = sub_max - sub_min
        # aabb.ts:52-66 tie-breaking: strictly-greater else fall through to z.
        if ext[0] > ext[1] and ext[0] > ext[2]:
            axis = 0
        elif ext[1] > ext[0] and ext[1] > ext[2]:
            axis = 1
        else:
            axis = 2

        perm = np.argsort(centroid[idx, axis], kind="stable")
        idx = idx[perm]
        order[start:end] = idx

        smin = tri_min[idx]
        smax = tri_max[idx]
        prefix_min = np.minimum.accumulate(smin, axis=0)
        prefix_max = np.maximum.accumulate(smax, axis=0)
        suffix_min = np.minimum.accumulate(smin[::-1], axis=0)[::-1]
        suffix_max = np.maximum.accumulate(smax[::-1], axis=0)[::-1]

        # Candidate splits at count ratios i/num_bins (bvh.ts:185-199).
        best_cost = np.inf
        best_s = 0  # bvh.ts:182: bestSplitIndex initialised to startIndex
        for i in range(1, num_bins):
            s = int(n * i // num_bins)
            if s == 0 or s == n:
                continue
            left_area = _surface_area(prefix_min[s - 1], prefix_max[s - 1])
            right_area = _surface_area(suffix_min[s], suffix_max[s])
            cost = TRAVERSAL_COST + (
                left_area * s + right_area * (n - s)
            ) * INTERSECTION_TEST_COST
            if cost < best_cost:
                best_cost = cost
                best_s = s

        split = start + best_s
        # All candidates degenerate cannot happen for n > max_leaf_size >= 1
        # with num_bins >= 2, but guard to avoid an infinite loop.
        if best_s == 0:
            split = start + n // 2
            best_s = n // 2

        left_idx = len(node_meta)
        right_idx = left_idx + 1
        node_min.append(prefix_min[best_s - 1])
        node_max.append(prefix_max[best_s - 1])
        node_meta.append([-1, -1, start, best_s])
        node_min.append(suffix_min[best_s])
        node_max.append(suffix_max[best_s])
        node_meta.append([-1, -1, split, n - best_s])

        node_meta[node_idx] = [left_idx, right_idx, 0, 0]

        # Push left then right; right is popped (processed) first
        # (bvh.ts:141-151 with the LIFO pop at bvh.ts:81).
        queue.append((left_idx, start, split))
        queue.append((right_idx, split, end))

    return BVH(
        aabb_min=np.asarray(node_min, np.float32),
        aabb_max=np.asarray(node_max, np.float32),
        meta=np.asarray(node_meta, np.int32),
        order=order,
    )


def subtree_ranges(meta: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-node triangle range [lo, hi) covered by each subtree.

    Triangles are stored in DFS order (the builder reorders them in place,
    bvh.ts:53-157), so every subtree covers a contiguous range. Children are
    always appended after their parent, so a reverse index sweep sees
    children before parents.
    """
    b = meta.shape[0]
    lo = np.zeros(b, np.int64)
    hi = np.zeros(b, np.int64)
    leaf = meta[:, 3] > 0
    lo[leaf] = meta[leaf, 2]
    hi[leaf] = meta[leaf, 2] + meta[leaf, 3]
    for i in range(b - 1, -1, -1):
        if not leaf[i] and meta[i, 0] >= 0:
            l, r = meta[i, 0], meta[i, 1]
            lo[i] = min(lo[l], lo[r])
            hi[i] = max(hi[l], hi[r])
    return lo, hi


def cut_subtree_clusters(meta: np.ndarray, max_tris: int) -> list[tuple[int, int, int]]:
    """Cut the tree into maximal subtrees holding <= max_tris triangles.

    Returns [(node, lo, count)] in ascending-triangle (DFS) order. Unlike a
    fixed-stride cut of the sorted triangle array, each cluster inherits its
    subtree's tight SAH box — fixed-stride cuts that straddle subtree
    boundaries produce fat boxes spanning unrelated geometry (measured: half
    of the stride-64 clusters on the tessellated Cornell had an extent over
    a quarter of the scene, tripling per-ray candidate counts).
    """
    lo, hi = subtree_ranges(meta)
    out: list[tuple[int, int, int]] = []
    stack = [0]
    while stack:
        n = stack.pop()
        cnt = int(hi[n] - lo[n])
        if cnt <= max_tris or meta[n, 3] > 0:
            # A single LEAF can exceed max_tris when the tree was built with
            # max_leaf_size > max_tris; emit it as consecutive max_tris-sized
            # chunks (each keeps the leaf's box — conservative but valid).
            for base in range(int(lo[n]), int(hi[n]), max_tris):
                out.append((n, base, min(max_tris, int(hi[n]) - base)))
            continue
        # left first (ascending triangle ranges): push right, pop left.
        stack.append(int(meta[n, 1]))
        stack.append(int(meta[n, 0]))
    return out
