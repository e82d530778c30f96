"""``frames_per_trace`` on the pair route where the frames' lanes meet in
one call of REORDER_MIN_LANES (16,384) rays or more (ROADMAP.md C.10).

At 96x96 one frame is 9,216 lanes, so F = 1 never reaches the pair
route's tail compaction and bucket order (``ops/intersect.py::
with_tail_compaction``), and F = 2 (18,432 lanes a call) does: on the open
material box at 4 bounces two of its sparse calls go to K4's plain version
on the n/2 tier, its two frames' live lanes packed together, and, for a
scene without walk tables, every call from bounce 1 on is sorted by the
JAX package's bucket key. K4 votes over blocks of 1,024 consecutive lanes,
so the blocks differ between F = 1 and F = 2; the test shows that the image
does not: every lane's nearest hit is the same whatever its block.
"""

import numpy as np
import pytest
import torch

from wgpu_path_tracing_tpu_torch import (
    Renderer,
    RenderConfig,
    material_test_box,
)
from wgpu_path_tracing_tpu_torch.accel import bvh8
from wgpu_path_tracing_tpu_torch.ops import intersect as INTERSECT

torch.set_num_threads(1)
SIZE = 96


@pytest.mark.parametrize("walk_tables", [True, False])
def test_pair_route_image_is_the_same_for_every_frames_per_trace(
        walk_tables, monkeypatch):
    if not walk_tables:  # "pairs" then sorts its compacted lanes too
        def too_deep(*args, **kwargs):
            raise bvh8.WideBVHDepthError("too deep (simulated)")

        monkeypatch.setattr(bvh8, "build_wide_bvh", too_deep)
    route = {"compacted": [], "sorted": 0}
    tier = INTERSECT.compaction_tier
    sort = INTERSECT.sorted_call

    def spy_tier(live, n):
        k = tier(live, n)
        route["compacted"].append((n, k))
        return k

    def spy_sort(*args, **kwargs):
        route["sorted"] += 1
        return sort(*args, **kwargs)

    monkeypatch.setattr(INTERSECT, "compaction_tier", spy_tier)
    monkeypatch.setattr(INTERSECT, "sorted_call", spy_sort)
    images = {}
    for fpt in (1, 2):
        route["compacted"].clear()
        route["sorted"] = 0
        r = Renderer(RenderConfig(width=SIZE, height=SIZE, max_bounces=4,
                                  intersector="pairs",
                                  frames_per_trace=fpt), device="cpu")
        if walk_tables:
            r.load_scene(material_test_box())
        else:
            with pytest.warns(UserWarning, match="walk tables skipped"):
                r.load_scene(material_test_box())
        assert r.stats()["intersector"] == "pairs"
        images[fpt] = r.render(spp=2)
        tiers = [k for n, k in route["compacted"] if k is not None]
        if fpt == 1:
            assert route["compacted"] == [] and route["sorted"] == 0
        else:
            assert all(n == 2 * SIZE * SIZE for n, _ in route["compacted"])
            assert tiers, "F = 2 took no compaction tier"
            assert (route["sorted"] > 0) == (not walk_tables)
    np.testing.assert_array_equal(images[1].view(np.uint32),
                                  images[2].view(np.uint32))
