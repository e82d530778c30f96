"""Axis-aligned bounding box: a copy of the JAX package's ``utils/aabb.py``
(src/utils/aabb.ts:1-67).

The SAH build (``accel/bvh.py``) uses vectorized prefix and suffix sweeps;
this object form is for host-side tooling.
"""

from __future__ import annotations

import numpy as np

AXIS_X, AXIS_Y, AXIS_Z = 0, 1, 2


class AABB:
    def __init__(self, box_min, box_max):
        self.min = np.asarray(box_min, np.float64).copy()
        self.max = np.asarray(box_max, np.float64).copy()

    def merge(self, other: "AABB") -> "AABB":
        """aabb.ts:17-30: the union box (a new one)."""
        return AABB(np.minimum(self.min, other.min),
                    np.maximum(self.max, other.max))

    def expand(self, point) -> None:
        """aabb.ts:32-43: grow in place to hold a point."""
        point = np.asarray(point, np.float64)
        self.min = np.minimum(self.min, point)
        self.max = np.maximum(self.max, point)

    def surface_area(self) -> float:
        """aabb.ts:45-50."""
        d = self.max - self.min
        return float(2.0 * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0]))

    def max_extent_axis(self) -> int:
        """aabb.ts:52-66: x only if strictly greater than y and z, then y,
        else z."""
        d = self.max - self.min
        if d[0] > d[1] and d[0] > d[2]:
            return AXIS_X
        if d[1] > d[0] and d[1] > d[2]:
            return AXIS_Y
        return AXIS_Z
