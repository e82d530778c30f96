"""Dense ray-triangle intersection, plain PyTorch.

The counterpart of the dense half of the JAX package's ``ops/intersect.py``:
Möller-Trumbore with EPSILON = 1e-6 (pt.wgsl:123-157) over triangles packed
as [v0, e1, e2] rows, every ray against every triangle. A miss is
(t = inf, idx = -1); ties go to the lowest triangle index, as the reference's
strict ``hit.t < closest.t`` gives (pt.wgsl:275).

The expressions follow ``ops/pallas_kernels.py::_brute_kernel`` term by term
(the kernel in ``csrc/dense_hit.cu`` does too), so on the card the kernel and
this plain version agree bit for bit.
"""

from __future__ import annotations

import math

import torch

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


# Intersectors the port runs, and the JAX package's others with what is
# still to be ported for each.
INTERSECTORS = ("auto", "brute", "walk", "pairs", "phased", "cluster")
UNPORTED_INTERSECTORS = {
    "bvh": "the linked-BVH walk (ops/intersect.py::closest_hit_bvh_linked)",
    "stack": "the per-ray stack walk (ops/intersect.py::closest_hit_bvh)",
    "walk_hbm": "the paged walk (K3's TPU residency mode; 'walk' takes every "
                "scene here)",
}


def check_intersector(intersector: str) -> None:
    """Raise for an intersector the port does not run: NotImplementedError
    naming what is still to be ported, or ValueError for an unknown name."""
    if intersector in INTERSECTORS:
        return
    if intersector in UNPORTED_INTERSECTORS:
        raise NotImplementedError(
            f"intersector={intersector!r} is not ported: "
            f"{UNPORTED_INTERSECTORS[intersector]} of the JAX package")
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
                     brute_max_tris: int = 4096):
    """Pick the intersection strategy for this scene, as the JAX package's
    ``make_closest_hit`` does, without its TPU residency budgets.

    * "auto": the dense intersector (K1) at or below ``brute_max_tris``
      triangles; above, the wide-BVH walk (K3) when the scene has walk
      tables, else the pair dispatch (K4). A scene has no walk tables when
      its wide tree is too deep for the walk's stack.
    * "brute": K1. "pairs": K4. "cluster": the round dispatch (K6).
    * "walk": K3, or quietly K4 for a scene without walk tables.
    * "phased": the phased group dispatch (K5), which reads the walk's leaf
      table; without walk tables it falls through to K4, as in the JAX
      package.

    Any other intersector raises (``check_intersector``).

    The dense hit goes through the K1 wrapper over origin and direction
    rows (``ops/dense_hit.py::closest_hit_dense_rows``: no copy) and,
    as in the JAX package's dense branch, accepts and ignores ``active``,
    ``t_max`` and ``any_hit``: every ray is tested and the closest hit
    returned, which gives the same occlusion answers. The others go through
    their wrappers (``ops/walk.py``, ``ops/pairs.py``, ``ops/phased.py``,
    ``ops/cluster.py``) and honour ``active`` and ``t_max``; only the walk
    stops early on ``any_hit``. Each wrapper runs its CUDA kernel on CUDA
    tensors and its plain version on CPU tensors.

    ``reorder`` marks incoherent rays (the bounce loops pass ``bounce_idx >
    0``, as the JAX package's do). Every strategy takes it. The walk, on a
    tree of REORDER_MIN_NODES wide nodes or more, walks such a call's rays
    in ``ray_order`` (``with_ray_order``). Every route to the pair dispatch
    ("pairs", and "auto", "walk" and "phased" without walk tables) goes
    through ``with_tail_compaction``, as the JAX package's does: sparse
    calls on a compacted tier, bounce rays sorted.

    Returns closest_hit(ro3, rd3, active=None, t_max=None, any_hit=False,
    reorder=False) over SoA (3, N) origins and directions; its ``strategy``
    attribute is "brute", "walk", "pairs", "phased" or "cluster".
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
    if intersector == "brute" or (intersector == "auto"
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
    elif intersector in ("auto", "walk") and have_walk:
        tables = walk.walk_tables(scene)

        def walk_hit(ro3, rd3, active=None, t_max=None, any_hit=False):
            return walk.closest_hit_walk(tables, ro3, rd3, active, t_max,
                                         num_tris=num_tris, any_hit=any_hit)

        big = tables.order.shape[0] >= REORDER_MIN_NODES
        closest_hit = with_ray_order(walk_hit,
                                     scene["root_box"] if big else None)
        strategy = "walk"
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
