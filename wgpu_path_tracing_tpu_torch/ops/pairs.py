"""K4: the entry-sorted pair dispatch over subtree clusters, its host
tables, its plain version and its wrapper.

The counterpart of the JAX package's ``ops/pairs.py`` (``closest_hit_pairs``,
kernel ``_pair_kernel``): the large-scene intersector that needs no bounded
tree depth, and the one ``make_closest_hit`` falls back to when a scene has
no walk tables. Rays are SoA (3, N) origins and directions, the result is
(t (N,) float32, idx (N,) int32), a miss being (inf, -1).

* BUILD (host, ``build_pair_tables``): the BVH is cut into maximal subtrees
  of at most ``PAIRS_K`` triangles (``accel/bvh.py::cut_subtree_clusters``);
  ``PAIRS_GROUP`` consecutive clusters form a super tile of
  ``PAIRS_GROUP * PAIRS_K`` rows ``[v0, e1, e2 | cluster AABB | base idx]``.
* PHASE 1 (``ops/blocks.py::block_entry``, on the card its kernel
  ``csrc/blocks.cu``): every ray against every super AABB, reduced per
  block of ``BN`` rays to the nearest entry distance.
* PAIR LIST (``pair_list``, ``sorted_pairs``): each block's candidates in
  ascending entry distance, the super index breaking ties (a stable sort).
* DISPATCH (the kernel, or ``_dispatch_plain``): each block walks its list
  in order and carries its lanes' best (t, idx). For each of a super's
  member clusters it tests the cluster's box against the live limits
  ``min(best t, limit)``, and when any lane of the block enters, runs
  Möller-Trumbore over the cluster's rows for every lane of the block. In a
  cluster the winner is the least t, ties to the lowest row; it replaces the
  best on a strict ``<``.

``any_hit`` is accepted and ignored, as in the JAX package: the limits cull
shadow rays, and the closest hit answers the occlusion question.

What the JAX package has for its TPU only is not carried over: the dispatch
windows and their seeding flags, the scalar prefetch, the chunked phase-1
scan. What the JAX package puts in front of its pair dispatch, the tail
compaction and the bucket order of bounce rays, is
``ops/intersect.py::with_tail_compaction``, which ``make_closest_hit`` wraps
around every route to K4. One difference in a case the JAX package gets wrong: it fills the
last block's tail with zero directions, whose entry distance into a box
around the origin is -inf, and then counts only finite entries while the
sort puts -inf first, so each such block loses its farthest candidates.
Here the tail lanes enter nothing, and every entry below inf is a candidate.

On a CUDA tensor ``closest_hit_pairs`` launches ``csrc/pairs.cu``; on a CPU
tensor it runs ``closest_hit_pairs_plain``. There is no fallback between the
two.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from wgpu_path_tracing_tpu_torch.accel.bvh import cut_subtree_clusters
from wgpu_path_tracing_tpu_torch.ops import blocks, cuda_lib
from wgpu_path_tracing_tpu_torch.ops.intersect import moller_trumbore

PAIRS_K = 64  # most triangles a (subtree) cluster holds
PAIRS_GROUP = 8  # clusters in a super tile
PAIRS_COLS = 16  # [v0, e1, e2 | cluster AABB | base index]
TILE_ROWS = PAIRS_GROUP * PAIRS_K
BN = 1024  # rays in a block (csrc/pairs.cu kBlock)
PAIRS_KEYS = ("pairs_tris", "pairs_super_aabb")


class Counter:
    """Launches of the K4 kernel in this process."""

    launches = 0


class PairTables(NamedTuple):
    super_aabb: torch.Tensor  # (Cs, 6) float32
    tris: torch.Tensor  # (Cs * TILE_ROWS, 16) float32


def build_pair_tables(bvh_aabb, bvh_meta, tri_isect,
                      k: int = PAIRS_K, group: int = PAIRS_GROUP):
    """Host: subtree clusters -> (pairs_tris (Cs*group*k, 16),
    pairs_super_aabb (Cs, 6)).

    Row layout: cols 0:9 = [v0, e1, e2] (zero rows reject in Möller-Trumbore
    through a == 0); cols 9:15 = the owning cluster's AABB on each of its
    rows; col 15 = the cluster's base triangle index (exact in float32 below
    2^24). Padding clusters carry a NaN AABB: every slab comparison is then
    false, so no lane enters them (an (inf, -inf) box would give tn = -inf,
    tf = inf, and enter).
    """
    t = tri_isect.shape[0]
    if t == 0:
        tris = np.zeros((group * k, PAIRS_COLS), np.float32)
        tris[:, 9:15] = np.nan
        aabb = np.full((1, 6), np.nan, np.float32)  # no ray ever enters
        return tris, aabb

    clusters = cut_subtree_clusters(bvh_meta, k)
    c = len(clusters)
    cs = -(-c // group)
    tris = np.zeros((cs * group * k, PAIRS_COLS), np.float32)
    tris[:, 9:15] = np.nan
    super_aabb = np.zeros((cs, 6), np.float32)
    super_aabb[:, 0:3] = np.inf
    super_aabb[:, 3:6] = -np.inf
    for ci, (node, lo, cnt) in enumerate(clusters):
        assert cnt <= k, (cnt, k)  # cut_subtree_clusters splits large leaves
        base = ci * k
        tris[base:base + cnt, 0:9] = tri_isect[lo:lo + cnt]
        tris[base:base + k, 9:12] = bvh_aabb[node, 0:3]
        tris[base:base + k, 12:15] = bvh_aabb[node, 3:6]
        tris[base:base + k, 15] = np.float32(lo)
        s = ci // group
        super_aabb[s, 0:3] = np.minimum(super_aabb[s, 0:3], bvh_aabb[node, 0:3])
        super_aabb[s, 3:6] = np.maximum(super_aabb[s, 3:6], bvh_aabb[node, 3:6])
    return tris, super_aabb


def pair_tables(scene: dict) -> PairTables:
    """The pair tables of an uploaded scene."""
    missing = [k for k in PAIRS_KEYS if k not in scene]
    if missing:
        raise ValueError(f"the scene has no pair tables ({missing}): pack it "
                       "with pack_device_scene and upload it with "
                       "load_jax_scene")
    return PairTables(scene["pairs_super_aabb"], scene["pairs_tris"])


def pair_list(super_aabb, o, d, lim):
    """Phase 1 and the pair list, as the kernel's wrapper makes them: phase
    1 by ``blocks.entry_table`` (the kernel on CUDA tensors), then
    ``sorted_pairs``."""
    return sorted_pairs(blocks.entry_table(super_aabb, o, d, lim))


def sorted_pairs(block_tn):
    """The pair list of phase 1's (nb, Cs) table: (cids (nb, Cs) int64, each
    block's super tiles in ascending entry distance, ties to the lower
    index; counts (nb,) int64, how many of them the block enters)."""
    cids = torch.sort(block_tn, dim=1, stable=True).indices
    return cids, (block_tn < math.inf).sum(dim=1)


def _check(tables: PairTables, ro3, rd3, active, t_max) -> None:
    blocks.check_rays(ro3, rd3, active, t_max, *tables)
    blocks.check_table("pairs_super_aabb", tables.super_aabb, 6)
    blocks.check_table("pairs_tris", tables.tris, PAIRS_COLS)
    if tables.tris.shape[0] != tables.super_aabb.shape[0] * TILE_ROWS:
        raise ValueError(f"pairs_tris must hold {TILE_ROWS} rows for each row "
                         "of pairs_super_aabb")


def _dispatch_plain(tris, cids, counts, o, d, lim, visits):
    """Every block through its pair list. The blocks are put in descending
    order of their counts, so the blocks that still have a pair at rank r
    are the first m of them, and m is known on the host after the one copy
    of ``counts``. A rank's super tile is taken whole: its member boxes'
    entry distances and Möller-Trumbore over its rows come first, for the
    blocks where some lane enters some member within the limits the rank
    starts with (a superset of those that enter one as the limits shrink:
    ``torch.nonzero``, one host sync a rank); then the members, in order,
    each test their boxes against the live limits and hand their least t
    to the blocks that enter, as the kernel does member by member."""
    dev = lim.device
    nb, bn = lim.shape
    host_counts = counts.cpu()
    order = torch.argsort(host_counts, descending=True, stable=True)
    left = host_counts[order]
    order = order.to(dev)
    o = [x[order] for x in o]
    d = [x[order] for x in d]
    lim, cids = lim[order], cids[order]
    best_t = torch.full((nb, bn), math.inf, dtype=torch.float32, device=dev)
    best_i = torch.full((nb, bn), -1, dtype=torch.int32, device=dev)
    rows = torch.arange(PAIRS_K, device=dev)
    members = torch.arange(PAIRS_GROUP, device=dev) * PAIRS_K
    entered = torch.zeros((), dtype=torch.int64, device=dev)
    for rank in range(int(left[0]) if nb else 0):
        m = int((left > rank).sum())
        # Each block's tile's member rows: (m, PAIRS_GROUP).
        r0 = (cids[:m, rank] * TILE_ROWS)[:, None] + members
        ray = [x[:m] for x in (*o, *d)]
        tn, box_ok = blocks.slab_entry_div(
            tris[r0, 9:15][:, :, None, :], *(x[:, None, :] for x in ray),
            math.inf)  # (m, PAIRS_GROUP, bn)
        start = torch.minimum(best_t[:m], lim[:m])[:, None, :]
        sel = torch.nonzero((box_ok & (tn <= start)).flatten(1).any(dim=1))
        sel = sel.squeeze(1)
        if sel.numel() == 0:
            continue
        tri = tris[r0[sel][:, :, None] + rows]  # (g, PAIRS_GROUP, K, 16)
        t, _, _, valid = moller_trumbore(
            *(x[sel][:, None, None, :] for x in ray),
            *(tri[..., c, None] for c in range(9)))
        t = torch.where(valid, t, math.inf)
        min_t = t.min(dim=2).values  # (g, PAIRS_GROUP, bn)
        min_row = torch.where(t == min_t[:, :, None], rows[:, None],
                              1 << 30).min(dim=2).values
        idx = tri[:, :, 0, 15].to(torch.int32)[..., None] + min_row.to(
            torch.int32)
        bt, bi, bl = best_t[sel], best_i[sel], lim[sel]
        tn, box_ok = tn[sel], box_ok[sel]
        for s in range(PAIRS_GROUP):
            limit = torch.minimum(bt, bl)
            take = (box_ok[:, s] & (tn[:, s] <= limit)).any(dim=1)
            entered += take.sum()
            better = (min_t[:, s] < bt) & take[:, None]
            bt = torch.where(better, min_t[:, s], bt)
            bi = torch.where(better, idx[:, s], bi)
        best_t[sel], best_i[sel] = bt, bi
    if visits is not None:
        # Each member's box against every lane of each block at its rank;
        # Möller-Trumbore for every lane of the entered ones; the distinct
        # super tiles the lists name.
        n_entered = int(entered)
        named = cids[torch.arange(cids.shape[1], device=dev)[None, :]
                     < counts[order][:, None]]
        blocks.count_work(visits,
                          slab_tests=PAIRS_GROUP * bn * int(host_counts.sum()),
                          triangle_tests=n_entered * PAIRS_K * bn,
                          clusters=n_entered, pairs=int(host_counts.sum()),
                          tiles=torch.unique(named).numel())
    out_t, out_i = torch.empty_like(best_t), torch.empty_like(best_i)
    out_t[order], out_i[order] = best_t, best_i
    return out_t, out_i


def closest_hit_pairs_plain(tables: PairTables, ro3, rd3, active=None,
                            t_max=None, num_tris: int | None = None,
                            any_hit: bool = False,
                            visits: dict | None = None):
    """Plain PyTorch K4 on any device. ``visits``, where given, gains the
    work the call did: the "blocks" of ``BN`` rays and the "supers" each is
    swept against in phase 1, the (block, super) "pairs" dispatched and the
    distinct "tiles" among them, the "slab_tests" of member-cluster boxes
    (one for each lane of the block), the member "clusters" entered and
    their "triangle_tests" (``PAIRS_K`` rows for each lane of the block);
    the kernel does the same work, pair for pair."""
    del any_hit
    n = ro3.shape[1]
    lim0 = blocks.ray_limit(active, t_max, n, ro3.device)
    o, d, lim = blocks.pad_blocks(ro3, rd3, lim0, BN)
    cids, counts = sorted_pairs(
        blocks.block_entry(tables.super_aabb, o, d, lim))
    if visits is not None:
        blocks.count_work(visits, blocks=lim.shape[0], supers=cids.shape[1])
    t, idx = _dispatch_plain(tables.tris, cids, counts, o, d, lim, visits)
    return blocks.finish(t.reshape(-1)[:n], idx.reshape(-1)[:n], active,
                         num_tris)


def closest_hit_pairs_cuda(tables: PairTables, ro3, rd3, active=None,
                           t_max=None, num_tris: int | None = None,
                           any_hit: bool = False):
    """Phase 1's kernel and the pair list's sort, then K4 on the current
    stream (no synchronisation): one thread block for each block of ``BN``
    rays."""
    del any_hit
    _check(tables, ro3, rd3, active, t_max)
    if ro3.device.type != "cuda":
        raise ValueError("closest_hit_pairs_cuda needs CUDA tensors")
    n = ro3.shape[1]
    dev = ro3.device
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    idx = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return t, idx
    ro3, rd3 = ro3.contiguous(), rd3.contiguous()
    lim0 = blocks.ray_limit(active, t_max, n, dev).contiguous()
    cids, counts = pair_list(tables.super_aabb,
                             *blocks.pad_blocks(ro3, rd3, lim0, BN))
    cids, counts = cids.contiguous(), counts.contiguous()
    tris = tables.tris.contiguous()
    if tris.data_ptr() % 16:
        raise ValueError("K4 reads pairs_tris as float4 rows: it must be "
                         "16-byte aligned")
    active = None if active is None else active.contiguous()
    err = cuda_lib.lib().wpt_pairs(
        tris.data_ptr(), cids.data_ptr(), counts.data_ptr(), ro3.data_ptr(),
        rd3.data_ptr(), lim0.data_ptr(),
        None if active is None else active.data_ptr(), t.data_ptr(),
        idx.data_ptr(), n, cids.shape[1],
        -1 if num_tris is None else int(num_tris), cuda_lib.stream_ptr(ro3))
    cuda_lib.check(err, "wpt_pairs")
    Counter.launches += 1
    return t, idx


def closest_hit_pairs(tables: PairTables, ro3, rd3, active=None, t_max=None,
                      num_tris: int | None = None, any_hit: bool = False):
    """K4 wrapper: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors."""
    if ro3.device.type == "cuda":
        return closest_hit_pairs_cuda(tables, ro3, rd3, active, t_max,
                                      num_tris, any_hit)
    _check(tables, ro3, rd3, active, t_max)
    if ro3.device.type != "cpu":
        raise ValueError(f"unsupported device {ro3.device}")
    return closest_hit_pairs_plain(tables, ro3, rd3, active, t_max, num_tris,
                                   any_hit)
