"""K5, the phased dispatch: its plain version against the JAX package's kernel
in interpret mode and the port's dense hit, and the ``Renderer`` with
``intersector="phased"``. The cases, shared by the three dispatch
intersectors, are in tests/torch_dispatch_cases.py with their tolerances.

Below them, the rules the kernel (csrc/phased.cu) rests on, each exact, on
the CPU: the leaf records it reads equal ``walk_tris`` field by field; the
check that lets it drop the index compare (``slots_ascending``); the union
pre-test of its gate never drops a sub-box gate (a hypothesis property over
adversarial rays and boxes); and a PyTorch emulation of its gate scheme and
its reduction order (a strict ``<`` slot by slot over the gated
sub-clusters in ascending order, live lanes only) returns exactly
``closest_hit_phased_plain``'s (t, idx).
"""

import math
import re

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

pytest.register_assert_rewrite("tests.torch_dispatch_cases")

from tests.torch_dispatch_cases import *  # noqa: E402,F401,F403
from tests.torch_dispatch_cases import (  # noqa: E402
    PHASED_BN,
    RAYS,
    _aimed_rays,
    _soa,
)
from wgpu_path_tracing_tpu_torch import (  # noqa: E402
    cornell_box,
    load_jax_scene,
    random_triangles,
)
from wgpu_path_tracing_tpu_torch.accel import bvh8  # noqa: E402
from wgpu_path_tracing_tpu_torch.models.types import (  # noqa: E402
    pack_device_scene,
)
from wgpu_path_tracing_tpu_torch.ops import (  # noqa: E402
    blocks,
    cuda_lib,
    phased,
    walk,
)
from wgpu_path_tracing_tpu_torch.ops.intersect import (  # noqa: E402
    make_closest_hit,
    moller_trumbore,
)
from wgpu_path_tracing_tpu_torch.ops.walk import slab_entry  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture
def kind():
    return "phased"


# --- The kernel's records and its tie rule --------------------------------

SCENES = {
    "random": lambda: random_triangles(1500, seed=5),
    "cornell_4": lambda: cornell_box(tessellation=4),
    "cornell_16": lambda: cornell_box(tessellation=16),  # 95 groups
}


@pytest.fixture(scope="module", params=list(SCENES))
def walk_tris(request):
    return torch.from_numpy(pack_device_scene(SCENES[request.param]())[
        "walk_tris"])


def test_records_equal_the_plain_layout(walk_tris):
    """Each group's record: its 16 sub-boxes [min3, max3, 0, 0], then its
    128 triangles [v0, e1, e2, index, 0, 0], bit for bit (NaN boxes too)."""
    tables = phased.phased_tables(walk_tris)
    groups = walk_tris.view(-1, phased.GROUP_ROWS, bvh8.LEAF_SLOTS)
    ng = groups.shape[0]
    assert tables.tris is walk_tris
    assert tables.leaves.shape == (ng, walk.LEAF_FLOATS)
    assert tables.leaves.is_contiguous()
    rec = tables.leaves
    box = rec[:, :bvh8.SUB * walk.BOX_FLOATS].view(ng, bvh8.SUB,
                                                   walk.BOX_FLOATS)
    tri = rec[:, bvh8.SUB * walk.BOX_FLOATS:].view(ng, bvh8.LEAF_SLOTS,
                                                   walk.TRI_FLOATS)

    def bits(x):
        return x.contiguous().view(torch.int32)

    want_box = groups[:, phased.SUB_ROW:phased.SUB_ROW + bvh8.SUB, 0:6]
    assert torch.equal(bits(box[..., 0:6]), bits(want_box))
    assert (box[..., 6:8] == 0.0).all()
    for row in range(10):  # v0, e1, e2 by component, then the index
        assert torch.equal(bits(tri[..., row]), bits(groups[:, row, :]))
    assert (tri[..., 10:12] == 0.0).all()


def test_packed_scenes_keep_their_slots_ascending(walk_tris):
    """The packer fills each sub-cluster with ascending triangle indices and
    pads with zero rows: every sub-cluster passes, so the kernel takes its
    ordered instantiation on every scene it packs."""
    ok = phased.slots_ascending(walk_tris)
    assert ok.shape == (walk_tris.shape[0] // phased.GROUP_ROWS, bvh8.SUB)
    assert ok.all()
    assert phased.phased_tables(walk_tris).ordered


def _one_group(indices):
    """A hand-built group: slot k of sub-cluster 0 holds ``indices[k]``
    (-1: padding, zero rows), every other slot padding."""
    tris = np.zeros((phased.GROUP_ROWS, bvh8.LEAF_SLOTS), np.float32)
    tris[9] = -1.0
    for k, i in enumerate(indices):
        tris[9, k] = i
        if i >= 0:
            tris[0:9, k] = [0, 0, k, 1, 0, 0, 0, 1, 0]
    tris[phased.SUB_ROW:, 0:6] = np.nan
    return torch.from_numpy(tris)


@pytest.mark.parametrize("indices, passes", [
    ([4, 5, 6, 7, 8, 9, 10, 11], True),
    ([4, 5, -1, 7, -1, -1, 12, -1], True),  # padding between filled slots
    ([4, 4, 5], True),  # the same triangle twice: the same t either way
    ([5, 4, 6], False),  # swapped: a tie would go to 5, not 4
    ([7, -1, 3], False),  # descending across a padding slot
])
def test_slots_ascending_rejects_descending_indices(indices, passes):
    ok = phased.slots_ascending(_one_group(indices))
    assert bool(ok[0, 0]) == passes
    assert ok[0, 1:].all()  # all-padding sub-clusters pass


def test_slots_ascending_rejects_a_padding_slot_with_edges():
    """A padding slot with a nonzero edge could be hit by a kernel that
    compares no indices, so its sub-cluster fails, and that one alone."""
    tris = _one_group([1, 2, -1])
    tris[4, 2] = 1.0  # e1.y of the padding slot 2
    tris[9, 8] = 30.0  # sub-cluster 1: one filled slot
    ok = phased.slots_ascending(tris)
    assert not ok[0, 0] and ok[0, 1:].all()
    assert not phased.phased_tables(tris).ordered


def test_kernel_constants_match_the_records():
    with open(f"{cuda_lib.CSRC_DIR}/phased.cu") as f:
        src = f.read()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kBoxFloats") == walk.BOX_FLOATS
    assert const("kTriFloats") == walk.TRI_FLOATS
    assert const("kGateWarps") == phased.GATE_GROUPS
    assert const("kMaxThreads") % phased.WARP == 0
    assert "kOrdered" in src and "mt_early" in src and "copy_async16" in src


# --- The gate's union pre-test ---------------------------------------------

def _inverse(d):
    return torch.reciprocal(torch.where(d == 0.0, 1e-30, d))


def _never_drops(boxes, o, d, lim):
    """For rays (R, 3) and one group's sub-boxes (16, 6): every ray that
    enters a sub-box (the plain slab test) passes the group's union
    pre-test. Returns how many (ray, sub-box) entries there were."""
    groups = torch.zeros((1, phased.GROUP_ROWS, bvh8.LEAF_SLOTS))
    groups[0, phased.SUB_ROW:phased.SUB_ROW + bvh8.SUB, 0:6] = boxes
    union, filled = phased.group_union(groups)
    inv = _inverse(d)
    ray = [x[:, None] for x in (*o.unbind(1), *inv.unbind(1))]
    _, enter = slab_entry(boxes[None], *ray, lim[:, None])  # (R, 16)
    may = phased.union_may_enter(union[0], *[x[:, 0] for x in ray], lim)
    assert not (enter & ~may[:, None]).any()
    assert not (enter & ~filled[0][None]).any()  # NaN boxes: no entry
    return int(enter.sum())


F32 = st.floats(-8.0, 8.0, width=32, allow_subnormal=False)
SPECIAL_D = st.sampled_from([0.0, -0.0, 1e-40, -1e-40, 1e-38, -3e-39,
                             1e-30, 1e30, -1e30, 1.0, -1.0])
LIMITS = st.sampled_from([-math.inf, math.inf, 0.0, 1e-6, 0.5, 3.0])


@st.composite
def _group_and_rays(draw, ray_kind):
    boxes = np.full((bvh8.SUB, 6), np.nan, np.float32)
    for c in range(bvh8.SUB):
        if draw(st.booleans()):
            lo = [draw(F32) for _ in range(3)]
            size = [draw(st.sampled_from([0.0, 1e-6, 0.25, 2.0]))
                    for _ in range(3)]
            hi = [a + s for a, s in zip(lo, size)]
            if draw(st.integers(0, 7)) == 0:  # an inverted box
                lo, hi = hi, lo
            boxes[c] = lo + hi
    filled = boxes[~np.isnan(boxes).any(axis=1)]
    corners = (filled.reshape(-1) if len(filled)
               else np.zeros(6, np.float32))
    rays = []
    for _ in range(draw(st.integers(1, 12))):
        o = [draw(F32) for _ in range(3)]
        d = [draw(F32) for _ in range(3)]
        if ray_kind in ("plane_origins", "razor"):
            # Origins on the planes of the sub-boxes and their union.
            for a in range(3):
                if draw(st.booleans()):
                    o[a] = float(draw(st.sampled_from(list(corners))))
        if len(filled) and draw(st.booleans()):
            # Aimed at a point of a filled sub-box.
            b = filled[draw(st.integers(0, len(filled) - 1))]
            f = [draw(st.floats(0.0, 1.0)) for _ in range(3)]
            d = [float(b[a] + f[a] * (b[a + 3] - b[a]) - o[a])
                 for a in range(3)]
        if ray_kind in ("zero_dirs", "subnormal_dirs", "razor"):
            for a in range(3):
                if draw(st.booleans()):
                    d[a] = draw(SPECIAL_D)
        if ray_kind == "razor":
            # Aimed at a corner of a sub-box: the ray grazes its edges.
            tgt = np.asarray(draw(st.sampled_from(
                [tuple(b[[i, j, k]]) for b in filled for i in (0, 3)
                 for j in (1, 4) for k in (2, 5)] or [(0.0, 0.0, 0.0)])))
            d = list(np.asarray(tgt, np.float32) - np.asarray(o, np.float32))
        rays.append((o, d, draw(LIMITS)))
    o = torch.tensor([r[0] for r in rays], dtype=torch.float32)
    d = torch.tensor([r[1] for r in rays], dtype=torch.float32)
    lim = torch.tensor([r[2] for r in rays], dtype=torch.float32)
    return torch.from_numpy(boxes), o, d, lim


@pytest.mark.parametrize("ray_kind", ["random", "plane_origins", "zero_dirs",
                                      "subnormal_dirs", "razor"])
def test_union_pre_test_never_drops_a_sub_box_gate(ray_kind):
    """Origins on the planes of the boxes, zero and subnormal direction
    components (whose reciprocal is 1e30 or inf), rays aimed at box
    corners, limits of -inf, 0, finite and inf, empty (NaN), flat and
    inverted sub-boxes: a ray that enters a sub-box always passes the union
    pre-test."""
    entered = []

    @settings(max_examples=150, deadline=None, derandomize=True,
              database=None,
              suppress_health_check=list(HealthCheck))
    @given(_group_and_rays(ray_kind))
    def check(case):
        entered.append(_never_drops(*case))

    check()
    assert sum(entered) > 0  # the property was exercised


def test_union_pre_test_passes_a_nan_term():
    """Why the pre-test passes on NaN: a ray from the union's min corner with
    subnormal direction components (1/d = inf) gives 0 x inf = NaN on the
    union's planes, so the plain slab test of the union fails, while it
    enters a sub-box that lies wholly ahead (every term +inf, limit inf)."""
    boxes = torch.full((bvh8.SUB, 6), math.nan)
    boxes[0] = torch.tensor([0.0, 0.0, 0.0, 0.5, 0.5, 0.5])
    boxes[1] = torch.tensor([1.0, 1.0, 1.0, 2.0, 2.0, 2.0])
    o = torch.zeros((1, 3))
    d = torch.full((1, 3), 1e-40)
    lim = torch.tensor([math.inf])
    assert _never_drops(boxes, o, d, lim) == 1  # box 0 has NaN terms too
    groups = torch.zeros((1, phased.GROUP_ROWS, bvh8.LEAF_SLOTS))
    groups[0, phased.SUB_ROW:phased.SUB_ROW + bvh8.SUB, 0:6] = boxes
    union, _ = phased.group_union(groups)
    _, exact = slab_entry(union[0], *o[0], *_inverse(d[0]), lim[0])
    assert not exact  # the exact test would drop sub-box 1's gate


def test_group_union_spans_its_filled_sub_boxes(walk_tris):
    groups = walk_tris.view(-1, phased.GROUP_ROWS, bvh8.LEAF_SLOTS)
    union, filled = phased.group_union(groups)
    boxes = groups[:, phased.SUB_ROW:phased.SUB_ROW + bvh8.SUB, 0:6]
    assert torch.equal(filled, ~torch.isnan(boxes).any(dim=2))
    has = filled.any(dim=1)
    for g in torch.nonzero(has).squeeze(1).tolist():
        b = boxes[g][filled[g]]
        assert torch.equal(union[g, 0:3], b[:, 0:3].amin(dim=0))
        assert torch.equal(union[g, 3:6], b[:, 3:6].amax(dim=0))
    assert torch.isinf(union[~has]).all()


# --- The kernel's gate scheme and reduction order, emulated ---------------

def _emulate(tables, ro3, rd3, active=None, t_max=None, num_tris=None,
             bn=PHASED_BN, ordered=None):
    """csrc/phased.cu in PyTorch: the gates by ``gate_scheme`` (union boxes
    first); then, for each live lane of a block, the block's gated
    sub-clusters in ascending order, their slots in order, Möller-Trumbore
    with the kernel's early exits (NaN where it fails), and a strict ``<``
    slot by slot (``ordered``) or the index-comparing sub-cluster rule."""
    ordered = tables.ordered if ordered is None else ordered
    n = ro3.shape[1]
    lim0 = blocks.ray_limit(active, t_max, n, ro3.device)
    o, d, lim = blocks.pad_blocks(ro3, rd3, lim0, bn)
    groups = tables.tris.view(-1, phased.GROUP_ROWS, bvh8.LEAF_SLOTS)
    gates, _ = phased.gate_scheme(groups, o, d, lim)
    rec = tables.leaves[:, bvh8.SUB * walk.BOX_FLOATS:].reshape(
        -1, bvh8.SUB, phased.SUB_W, walk.TRI_FLOATS)
    live = torch.ones(n, dtype=torch.bool) if active is None else active
    live = torch.nn.functional.pad(live, (0, o[0].numel() - n)).view(-1, bn)
    best_t = torch.full(lim.shape, math.inf)
    best_i = torch.full(lim.shape, -1, dtype=torch.int32)
    for b in range(lim.shape[0]):
        lanes = torch.nonzero(live[b]).squeeze(1)
        ray = [x[b, lanes] for x in (*o, *d)]
        bt = torch.full((len(lanes),), math.inf)
        bi = torch.full((len(lanes),), -1, dtype=torch.int32)
        for g, c in torch.nonzero(gates[b]).tolist():  # ascending
            row = rec[g, c]  # (8, 12)
            t, _, _, valid = moller_trumbore(
                *ray, *(row[:, a, None] for a in range(9)))
            t = torch.where(valid, t, math.nan)  # mt_early's miss
            gidx = row[:, 9]
            if ordered:
                for k in range(phased.SUB_W):
                    better = t[k] < bt
                    bt = torch.where(better, t[k], bt)
                    bi = torch.where(better, int(gidx[k]), bi)
                continue
            st_ = torch.full_like(bt, math.inf)
            si = torch.full_like(bi, 2**31 - 1)
            for k in range(phased.SUB_W):
                if gidx[k] < 0:
                    continue
                better = (t[k] < st_) | ((t[k] == st_) & (int(gidx[k]) < si))
                st_ = torch.where(better, t[k], st_)
                si = torch.where(better, int(gidx[k]), si)
            better = st_ < bt
            bt = torch.where(better, st_, bt)
            bi = torch.where(better, si, bi)
        best_t[b, lanes] = bt
        best_i[b, lanes] = bi
    return blocks.finish(best_t.reshape(-1)[:n], best_i.reshape(-1)[:n],
                         active, num_tris)


def _same(a, b):
    assert torch.equal(a[0].view(torch.int32), b[0].view(torch.int32))
    assert torch.equal(a[1], b[1])


@pytest.mark.parametrize("rays", list(RAYS))
def test_gate_scheme_equals_the_sub_box_gates(random_scene, cornell_scene,
                                              rays):
    packed, ro, rd = RAYS[rays](random_scene, cornell_scene)
    scene = load_jax_scene(packed, "cpu")
    groups = scene["walk_tris"].view(-1, phased.GROUP_ROWS, bvh8.LEAF_SLOTS)
    n = len(ro)
    o, d, lim = blocks.pad_blocks(_soa(ro), _soa(rd),
                                  blocks.ray_limit(None, None, n, "cpu"),
                                  PHASED_BN)
    gates, tests = phased.gate_scheme(groups, o, d, lim)
    want = phased.sub_gates(groups, o, d, lim)
    assert torch.equal(gates, want) and want.any()
    filled = int(phased.group_union(groups)[1].sum())
    groups_filled = int(phased.group_union(groups)[1].any(dim=1).sum())
    assert 0 < tests <= lim.numel() * (filled + groups_filled)


@pytest.fixture(scope="module")
def mid_scene():
    return load_jax_scene(pack_device_scene(SCENES["cornell_16"]()), "cpu")


def _coherent_rays(scene, nb, bn, seed):
    """``nb`` blocks of ``bn`` rays, each block from one origin in front of
    the box toward one triangle's centroid, jittered by 0.01: coherent as
    camera rays are, so a block enters few groups' union boxes."""
    rng = np.random.default_rng(seed)
    tri = scene["tri_isect"].numpy()
    cent = tri[:, 0:3] + (tri[:, 3:6] + tri[:, 6:9]) / 3.0
    tgt = np.repeat(cent[rng.integers(0, len(tri), nb)], bn, axis=0)
    tgt += rng.uniform(-0.01, 0.01, tgt.shape)
    o = np.repeat(rng.uniform([-0.5, 0.5, 3.0], [0.5, 1.5, 4.0], (nb, 3)),
                  bn, axis=0)
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return _soa(o.astype(np.float32)), _soa(d.astype(np.float32))


@pytest.mark.parametrize("bn", [32, 256])
def test_gate_scheme_skips_unentered_groups_exactly(mid_scene, bn):
    """Coherent blocks on the 95-group box: the scheme's gates equal the
    plain sub-box gates, and the union pre-test spares most slab tests."""
    groups = mid_scene["walk_tris"].view(-1, phased.GROUP_ROWS,
                                         bvh8.LEAF_SLOTS)
    o, d = _coherent_rays(mid_scene, 12, bn, bn)
    n = o.shape[1]
    o, d, lim = blocks.pad_blocks(o, d, blocks.ray_limit(None, None, n,
                                                         "cpu"), bn)
    gates, tests = phased.gate_scheme(groups, o, d, lim)
    want = phased.sub_gates(groups, o, d, lim)
    assert torch.equal(gates, want) and want.any()
    filled = int(phased.group_union(groups)[1].sum())
    assert tests < 0.5 * lim.numel() * filled


@pytest.mark.parametrize("rays", list(RAYS))
def test_emulated_kernel_equals_plain(random_scene, cornell_scene, rays):
    packed, ro, rd = RAYS[rays](random_scene, cornell_scene)
    scene = load_jax_scene(packed, "cpu")
    tables = phased.phased_tables(scene["walk_tris"])
    nt = packed["tri_isect"].shape[0]
    o, d = _soa(ro), _soa(rd)
    want = phased.closest_hit_phased_plain(tables, o, d, num_tris=nt,
                                           bn=PHASED_BN)
    assert (want[1] >= 0).sum() >= 100
    _same(_emulate(tables, o, d, num_tris=nt), want)


@pytest.mark.parametrize("case", ["sparse", "shadow", "ragged", "all_dead"])
def test_emulated_kernel_on_masks_and_ragged_counts(random_scene, case):
    """A late-bounce mask of 5% live lanes, shadow limits, 2,500 rays (the
    last block ragged) and a call with no live lane."""
    scene = load_jax_scene(random_scene, "cpu")
    tables = phased.phased_tables(scene["walk_tris"])
    nt = random_scene["tri_isect"].shape[0]
    n = 2500 if case == "ragged" else 1024
    ro, rd = _aimed_rays(random_scene, n, 12)
    rng = np.random.default_rng(13)
    kw = {}
    if case == "sparse":
        kw["active"] = torch.from_numpy(rng.random(n) < 0.05)
    elif case == "shadow":
        kw["active"] = torch.from_numpy(rng.random(n) < 0.8)
        kw["t_max"] = torch.from_numpy(
            rng.uniform(10.0, 18.0, n).astype(np.float32))
    elif case == "all_dead":
        kw["active"] = torch.zeros(n, dtype=torch.bool)
    o, d = _soa(ro), _soa(rd)
    want = phased.closest_hit_phased_plain(tables, o, d, num_tris=nt,
                                           bn=PHASED_BN, **kw)
    _same(_emulate(tables, o, d, num_tris=nt, **kw), want)
    if case == "all_dead":
        assert (want[1] == -1).all()
    else:
        assert (want[1] >= 0).any()


def test_emulated_index_compare_on_unordered_slots(random_scene):
    """Slots shuffled inside each sub-cluster (indices out of order) and
    duplicated triangles (exact-t ties): the table fails
    ``slots_ascending``, and the kernel's index-comparing instantiation
    still returns the plain version's (t, idx); the ordered rule would not."""
    tris = torch.from_numpy(random_scene["walk_tris"]).clone()
    groups = tris.view(-1, phased.GROUP_ROWS, bvh8.LEAF_SLOTS)
    rng = np.random.default_rng(3)
    for g in range(groups.shape[0]):
        for c in range(bvh8.SUB):
            k = np.arange(c * phased.SUB_W, (c + 1) * phased.SUB_W)
            if groups[g, 9, k[0]] < 0 or groups[g, 9, k[1]] < 0:
                continue
            # Slot 1 repeats slot 0's triangle under a higher index: ties.
            groups[g, 0:9, k[1]] = groups[g, 0:9, k[0]]
            groups[g, 9, k[1]] = groups[g, 9, k[0]] + 100000.0
            groups[g, 0:10, k] = groups[g, 0:10, rng.permutation(k)]
    tables = phased.phased_tables(tris)
    assert not tables.ordered
    ro, rd = _aimed_rays(random_scene, 1024, 14)
    o, d = _soa(ro), _soa(rd)
    want = phased.closest_hit_phased_plain(tables, o, d, bn=PHASED_BN)
    _same(_emulate(tables, o, d), want)
    fast = _emulate(tables, o, d, ordered=True)
    assert not torch.equal(fast[1], want[1])


def test_visits_count_filled_boxes_and_live_lanes(random_scene):
    scene = load_jax_scene(random_scene, "cpu")
    ro, rd = _aimed_rays(random_scene, 1024, 15)
    active = torch.from_numpy(np.arange(1024) % 4 != 0)
    tables = phased.phased_tables(scene["walk_tris"])
    full, masked = {}, {}
    phased.closest_hit_phased_plain(tables, _soa(ro), _soa(rd),
                                    bn=PHASED_BN, visits=full)
    phased.closest_hit_phased_plain(tables, _soa(ro), _soa(rd), active,
                                    bn=PHASED_BN, visits=masked)
    groups = scene["walk_tris"].view(-1, phased.GROUP_ROWS, bvh8.LEAF_SLOTS)
    filled = int(phased.group_union(groups)[1].sum())
    assert full["filled_sub_boxes"] == full["blocks"] * filled
    assert full["filled_sub_boxes"] < full["sub_boxes"]
    assert full["live_triangle_tests"] == full["triangle_tests"]
    # Inactive lanes gate nothing here and test nothing.
    assert masked["live_triangle_tests"] <= 0.75 * masked["triangle_tests"]


def test_make_closest_hit_makes_the_tables_once(random_scene, monkeypatch):
    made = []
    real = phased.phased_tables

    def counted(walk_tris):
        made.append(1)
        return real(walk_tris)

    monkeypatch.setattr(phased, "phased_tables", counted)
    scene = load_jax_scene(random_scene, "cpu")
    hit = make_closest_hit(scene, "phased")
    ro, rd = _aimed_rays(random_scene, 64, 17)
    for _ in range(3):
        hit(_soa(ro), _soa(rd))
    assert hit.strategy == "phased" and len(made) == 1
