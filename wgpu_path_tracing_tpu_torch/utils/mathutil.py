"""Small math helpers: a copy of the JAX package's ``utils/mathutil.py``
(src/utils/math.ts:1-20, which the reference ships but its render path
never imports). Each takes scalars and arrays alike."""

from __future__ import annotations

import numpy as np


def clamp(value, lo, hi):
    return np.minimum(np.maximum(value, lo), hi)


def lerp(a, b, t):
    return a + (b - a) * t


def smoothstep(edge0, edge1, x):
    t = clamp((x - edge0) / (edge1 - edge0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def to_radians(degrees):
    return degrees * (np.pi / 180.0)


def to_degrees(radians):
    return radians * (180.0 / np.pi)
