"""K6: the round dispatch over fixed-stride clusters, its host tables, its
plain version and its wrapper.

The counterpart of the JAX package's ``ops/cluster.py``
(``closest_hit_cluster``, kernel ``_round_kernel``), which the pair dispatch
superseded there and which stays selectable for comparison. Rays are SoA
(3, N) origins and directions, the result is (t (N,) float32,
idx (N,) int32), a miss being (inf, -1).

* BUILD (host, ``build_clusters``): the BVH-sorted triangle table is cut
  into clusters of ``CLUSTER_K`` consecutive triangles, each with its AABB.
* PHASE 1 (``ops/blocks.py::block_entry``, on the card its kernel
  ``csrc/blocks.cu``): every ray against every cluster AABB, reduced per
  block of ``BN`` rays to the nearest entry distance.
* ROUNDS (the kernel, or the plain loop): each block takes its candidates in
  ascending entry distance, the lower cluster index first on ties (the JAX
  package's repeated ``argmin``; here a stable sort), ``ROUND`` of them a
  round. At the start of a round the candidates whose entry distance is
  above the block's largest live limit ``min(best t, limit)`` are dropped
  for good. A taken cluster runs Möller-Trumbore over all its rows for every
  lane of the block, with no gate of its own; the least t (ties to the
  lowest row) replaces the lane's best on a strict ``<``.

``any_hit`` is accepted and ignored, as in the JAX package; ``max_rounds``
(0: until no block has a candidate) is its debug knob. The JAX package's
(blocks, 8) grid and its scalar prefetch are not carried over. One
difference in a case the JAX package does not survive: it fills the last
block's tail with zero directions, whose entry distance into a box around
the origin is -inf, and a block with such an entry never takes a candidate
there while the loop waits for it. Here the tail lanes enter nothing, and
every entry below inf is a candidate.

The kernel reads the triangles as ``cluster_rows``, three 16-byte rows a
triangle, a copy of ``cluster_tris`` that ``cluster_tables`` makes once a
scene; the plain version reads ``cluster_tris``. The JAX package puts no ray
order in front of this dispatch, and neither does the port.

On a CUDA tensor ``closest_hit_cluster`` launches ``csrc/cluster.cu``; on a
CPU tensor it runs ``closest_hit_cluster_plain``. There is no fallback
between the two.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from wgpu_path_tracing_tpu_torch.ops import blocks, cuda_lib
from wgpu_path_tracing_tpu_torch.ops.intersect import moller_trumbore

CLUSTER_K = 128  # triangles in a cluster (csrc/cluster.cu kMaxK)
BN = 1024  # rays in a block (csrc/cluster.cu kBlock)
ROUND = 8  # candidates a block takes between two culls
ROW_FLOATS = 12  # a triangle of cluster_rows: [v0, e1, e2, 0, 0, 0]
CLUSTER_KEYS = ("cluster_tris", "cluster_aabb")


class Counter:
    """Launches of the K6 kernel in this process."""

    launches = 0


class ClusterTables(NamedTuple):
    aabb: torch.Tensor  # (C, 6) float32
    tris: torch.Tensor  # (C * k, 9) float32
    rows: torch.Tensor | None = None  # (C * k, 12) float32, cluster_rows


def build_clusters(tri_isect: np.ndarray, k: int = CLUSTER_K):
    """Host: cut the BVH-sorted (T, 9) [v0, e1, e2] table into clusters.

    Returns (cluster_tris (C*k, 9) float32 zero-padded, cluster_aabb (C, 6)
    float32). Padding triangles are all zero, which Möller-Trumbore rejects
    through a == 0.
    """
    t = tri_isect.shape[0]
    c = max(1, -(-t // k))
    tris = np.zeros((c * k, 9), np.float32)
    tris[:t] = tri_isect
    aabb = np.zeros((c, 6), np.float32)
    v0 = tri_isect[:, 0:3]
    p1 = v0 + tri_isect[:, 3:6]
    p2 = v0 + tri_isect[:, 6:9]
    for i in range(c):
        lo, hi = i * k, min((i + 1) * k, t)
        if lo >= t:
            aabb[i, 0:3] = np.inf  # empty cluster: never hit
            aabb[i, 3:6] = -np.inf
            continue
        pts = np.concatenate([v0[lo:hi], p1[lo:hi], p2[lo:hi]])
        aabb[i, 0:3] = pts.min(axis=0)
        aabb[i, 3:6] = pts.max(axis=0)
    return tris, aabb


def cluster_rows(tris: torch.Tensor) -> torch.Tensor:
    """``cluster_tris`` as the kernel reads it, by plain copies: each
    triangle [v0, e1, e2] followed by three zeros, so that it is three
    16-byte rows."""
    out = torch.zeros((tris.shape[0], ROW_FLOATS), dtype=tris.dtype,
                      device=tris.device)
    out[:, 0:9] = tris
    return out


def cluster_tables(scene: dict) -> ClusterTables:
    """The cluster tables of an uploaded scene, with the kernel's rows."""
    missing = [k for k in CLUSTER_KEYS if k not in scene]
    if missing:
        raise ValueError(f"the scene has no cluster tables ({missing}): pack "
                         "it with pack_device_scene and upload it with "
                         "load_jax_scene")
    tris = scene["cluster_tris"]
    return ClusterTables(scene["cluster_aabb"], tris, cluster_rows(tris))


def candidates(aabb, o, d, lim):
    """Phase 1 and the pick order, as the kernel's wrapper makes them: phase
    1 by ``blocks.entry_table`` (the kernel on CUDA tensors), then
    ``pick_order``."""
    return pick_order(blocks.entry_table(aabb, o, d, lim))


def pick_order(entry):
    """The pick order of phase 1's (nb, C) table: (entry (nb, C) float32
    ascending, cids (nb, C) int64), each block's clusters by entry distance,
    ties to the lower index; inf entries are no candidates."""
    return tuple(torch.sort(entry, dim=1, stable=True))


def _check(tables: ClusterTables, ro3, rd3, active, t_max) -> int:
    """Raises on bad inputs; returns the clusters' size k."""
    blocks.check_rays(ro3, rd3, active, t_max, *tables)
    blocks.check_table("cluster_aabb", tables.aabb, 6)
    blocks.check_table("cluster_tris", tables.tris, 9)
    if tables.rows is not None:
        blocks.check_table("cluster rows", tables.rows, ROW_FLOATS)
        if tables.rows.shape[0] != tables.tris.shape[0]:
            raise ValueError("the cluster rows must hold a row for each row "
                             "of cluster_tris")
    c = tables.aabb.shape[0]
    if c == 0 or tables.tris.shape[0] % c:
        raise ValueError("cluster_tris must hold the same number of rows "
                         "for each row of cluster_aabb")
    return tables.tris.shape[0] // c


def closest_hit_cluster_plain(tables: ClusterTables, ro3, rd3, active=None,
                              t_max=None, num_tris: int | None = None,
                              any_hit: bool = False, max_rounds: int = 0,
                              visits: dict | None = None):
    """Plain PyTorch K6 on any device: the blocks go through their rounds in
    step, and ``torch.nonzero`` picks the blocks that still take a candidate.
    ``visits``, where given, gains the work the call did: the "blocks" of
    ``BN`` rays and the "boxes" each is swept against in phase 1, the
    "clusters" taken over all blocks, their "triangle_tests" (k rows for
    each lane of the block) and the "rounds" of the busiest block; the
    kernel does the same work, cluster for cluster."""
    del any_hit
    dev = ro3.device
    n = ro3.shape[1]
    k = tables.tris.shape[0] // tables.aabb.shape[0]
    lim0 = blocks.ray_limit(active, t_max, n, dev)
    o, d, lim = blocks.pad_blocks(ro3, rd3, lim0, BN)
    nb, c = lim.shape[0], tables.aabb.shape[0]
    entry, cids = pick_order(blocks.block_entry(tables.aabb, o, d, lim))
    if visits is not None:
        blocks.count_work(visits, blocks=nb, boxes=c)
    best_t = torch.full((nb, BN), math.inf, dtype=torch.float32, device=dev)
    best_i = torch.full((nb, BN), -1, dtype=torch.int32, device=dev)
    rows = torch.arange(k, device=dev)
    ray = (*o, *d)
    rounds = -(-c // ROUND)
    for rnd in range(min(rounds, max_rounds) if max_rounds else rounds):
        # The candidates a block may still take: those at or below its
        # largest live limit, a prefix of its ascending list.
        block_limit = torch.minimum(best_t, lim).amax(dim=1)
        avail = ((entry <= block_limit[:, None])
                 & (entry < math.inf)).sum(dim=1)
        for p in range(rnd * ROUND, min((rnd + 1) * ROUND, c)):
            sel = torch.nonzero(avail > p).squeeze(1)
            if sel.numel() == 0:
                # No block has a candidate at p; the limits only fall, so
                # none has one in a later round either.
                return _finish(best_t, best_i, n, active, num_tris)
            if visits is not None:
                blocks.count_work(visits, clusters=sel.numel(),
                       triangle_tests=sel.numel() * k * BN)
                visits["rounds"] = rnd + 1
            cid = cids[sel, p]
            tri = tables.tris[(cid * k)[:, None] + rows]  # (g, k, 9)
            t, _, _, valid = moller_trumbore(
                *(x[sel][:, None, :] for x in ray),
                *(tri[:, :, col, None] for col in range(9)))
            t = torch.where(valid, t, math.inf)
            min_t = t.min(dim=1).values
            min_row = torch.where(t == min_t[:, None], rows[None, :, None],
                                  1 << 30).min(dim=1).values
            cur = best_t[sel]
            better = min_t < cur
            best_t[sel] = torch.where(better, min_t, cur)
            best_i[sel] = torch.where(
                better, (cid * k)[:, None].to(torch.int32)
                + min_row.to(torch.int32), best_i[sel])
    return _finish(best_t, best_i, n, active, num_tris)


def _finish(best_t, best_i, n: int, active, num_tris):
    return blocks.finish(best_t.reshape(-1)[:n], best_i.reshape(-1)[:n],
                         active, num_tris)



def closest_hit_cluster_cuda(tables: ClusterTables, ro3, rd3, active=None,
                             t_max=None, num_tris: int | None = None,
                             any_hit: bool = False, max_rounds: int = 0):
    """Phase 1's kernel and the pick order's sort, then K6 on the current
    stream (no synchronisation): one thread block for each block of ``BN``
    rays, through all its rounds, reading ``tables.rows``."""
    del any_hit
    k = _check(tables, ro3, rd3, active, t_max)
    if ro3.device.type != "cuda":
        raise ValueError("closest_hit_cluster_cuda needs CUDA tensors")
    if k > CLUSTER_K:
        raise ValueError(f"K6 stages clusters of at most {CLUSTER_K} "
                         f"triangles; the table has {k}")
    n = ro3.shape[1]
    dev = ro3.device
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    idx = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return t, idx
    ro3, rd3 = ro3.contiguous(), rd3.contiguous()
    lim0 = blocks.ray_limit(active, t_max, n, dev).contiguous()
    entry, cids = candidates(tables.aabb,
                             *blocks.pad_blocks(ro3, rd3, lim0, BN))
    entry, cids = entry.contiguous(), cids.contiguous()
    if tables.rows is None:
        raise ValueError("K6 reads the cluster rows: make the tables with "
                         "cluster_tables")
    rows = tables.rows.contiguous()
    if rows.data_ptr() % 16:
        raise ValueError("K6 reads the cluster rows as float4: they must be "
                         "16-byte aligned")
    active = None if active is None else active.contiguous()
    err = cuda_lib.lib().wpt_cluster(
        rows.data_ptr(), entry.data_ptr(), cids.data_ptr(), ro3.data_ptr(),
        rd3.data_ptr(), lim0.data_ptr(),
        None if active is None else active.data_ptr(), t.data_ptr(),
        idx.data_ptr(), n, cids.shape[1], k, int(max_rounds),
        -1 if num_tris is None else int(num_tris), cuda_lib.stream_ptr(ro3))
    cuda_lib.check(err, "wpt_cluster")
    Counter.launches += 1
    return t, idx


def closest_hit_cluster(tables: ClusterTables, ro3, rd3, active=None,
                        t_max=None, num_tris: int | None = None,
                        any_hit: bool = False, max_rounds: int = 0):
    """K6 wrapper: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors."""
    if ro3.device.type == "cuda":
        return closest_hit_cluster_cuda(tables, ro3, rd3, active, t_max,
                                        num_tris, any_hit, max_rounds)
    _check(tables, ro3, rd3, active, t_max)
    if ro3.device.type != "cpu":
        raise ValueError(f"unsupported device {ro3.device}")
    return closest_hit_cluster_plain(tables, ro3, rd3, active, t_max,
                                     num_tris, any_hit, max_rounds)
