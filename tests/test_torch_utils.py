"""The port's NumPy copies of the JAX package's ``utils/arr.py``,
``utils/aabb.py`` and ``utils/mathutil.py``: the cases of the JAX
tests/test_arr.py (the reference's src/spec/arr.test.ts, five cases, and
aabb.ts) and tests/test_utils.py::test_mathutil_parity, each also against
the JAX function on the same inputs, exactly (both are NumPy or pure
Python, in float64)."""

import numpy as np
import pytest
import torch

from wgpu_path_tracing_tpu.utils import aabb as JAABB
from wgpu_path_tracing_tpu.utils import arr as JARR
from wgpu_path_tracing_tpu.utils import mathutil as JMATH
from wgpu_path_tracing_tpu_torch.utils import mathutil
from wgpu_path_tracing_tpu_torch.utils.aabb import AABB, AXIS_X, AXIS_Y, AXIS_Z
from wgpu_path_tracing_tpu_torch.utils.arr import sort_array_partially

torch.set_num_threads(1)

SORT_CASES = {
    # name: (array, start, end, comparator, expected)
    "subrange": ([5, 3, 8, 1, 9, 2, 7], 1, 5, lambda a, b: a - b,
                 [5, 1, 3, 8, 9, 2, 7]),
    "duplicates": ([4, 2, 2, 4, 1, 1], 0, 6, lambda a, b: a - b,
                   [1, 1, 2, 2, 4, 4]),
    "single_element": ([3, 1, 2], 1, 2, lambda a, b: a - b, [3, 1, 2]),
    "custom_comparator": (["bb", "a", "ccc"], 0, 3,
                          lambda a, b: len(b) - len(a), ["ccc", "bb", "a"]),
    "default_order": ([2.5, -1.0, 7.0, 0.0], 0, 4, None,
                      [-1.0, 0.0, 2.5, 7.0]),
}


@pytest.mark.parametrize("name", sorted(SORT_CASES))
def test_sort_array_partially(name):
    arr, start, end, compare, expected = SORT_CASES[name]
    got, ref = list(arr), list(arr)
    sort_array_partially(got, start, end, compare)
    JARR.sort_array_partially(ref, start, end, compare)
    assert got == expected == ref


@pytest.mark.parametrize("start,end", [(2, 2), (-1, 2), (0, 4)])
def test_invalid_indices_throw(start, end):
    for fn in (sort_array_partially, JARR.sort_array_partially):
        with pytest.raises(ValueError, match="Invalid indices"):
            fn([1, 2, 3], start, end, lambda a, b: a - b)


def test_aabb_merge_expand_area_axis():
    a = AABB([0, 0, 0], [1, 2, 3])
    b = AABB([-1, 1, 0], [0.5, 3, 1])
    m = a.merge(b)
    np.testing.assert_array_equal(m.min, [-1, 0, 0])
    np.testing.assert_array_equal(m.max, [1, 3, 3])
    a.expand([5, -5, 0])
    np.testing.assert_array_equal(a.min, [0, -5, 0])
    np.testing.assert_array_equal(a.max, [5, 2, 3])
    box = AABB([0, 0, 0], [2, 3, 4])
    assert box.surface_area() == 2 * (2 * 3 + 3 * 4 + 4 * 2)
    assert box.max_extent_axis() == AXIS_Z
    assert AABB([0, 0, 0], [5, 1, 1]).max_extent_axis() == AXIS_X
    assert AABB([0, 0, 0], [1, 5, 1]).max_extent_axis() == AXIS_Y
    # ties fall through to Z (aabb.ts:52-66)
    assert AABB([0, 0, 0], [1, 1, 1]).max_extent_axis() == AXIS_Z


def test_aabb_equals_jax_on_random_boxes():
    rng = np.random.default_rng(4)
    for _ in range(50):
        lo = rng.normal(size=(2, 3))
        hi = lo + rng.uniform(0, 3, size=(2, 3)).round(1)  # ties happen
        point = rng.normal(scale=4, size=3)
        a, b = AABB(lo[0], hi[0]), AABB(lo[1], hi[1])
        ja, jb = JAABB.AABB(lo[0], hi[0]), JAABB.AABB(lo[1], hi[1])
        m, jm = a.merge(b), ja.merge(jb)
        np.testing.assert_array_equal(m.min, jm.min)
        np.testing.assert_array_equal(m.max, jm.max)
        a.expand(point)
        ja.expand(point)
        assert a.surface_area() == ja.surface_area()
        assert a.max_extent_axis() == ja.max_extent_axis()
        assert b.max_extent_axis() == jb.max_extent_axis()


def test_mathutil_parity():
    # src/utils/math.ts:1-20 semantics
    assert mathutil.clamp(5, 0, 3) == 3
    assert mathutil.lerp(0.0, 10.0, 0.25) == 2.5
    assert mathutil.smoothstep(0, 1, 0.5) == 0.5
    assert abs(mathutil.to_radians(180) - np.pi) < 1e-12
    assert abs(mathutil.to_degrees(np.pi) - 180) < 1e-12
    np.testing.assert_allclose(
        mathutil.smoothstep(0, 1, np.array([-1.0, 2.0])), [0.0, 1.0])


@pytest.mark.parametrize("name", ["clamp", "lerp", "smoothstep",
                                  "to_radians", "to_degrees"])
def test_mathutil_equals_jax(name):
    rng = np.random.default_rng(9)
    x = rng.normal(scale=3, size=64)
    args = {"clamp": (x, -1.0, 2.0), "lerp": (x, x[::-1], 0.3),
            "smoothstep": (-0.5, 1.5, x), "to_radians": (x * 90,),
            "to_degrees": (x,)}[name]
    np.testing.assert_array_equal(getattr(mathutil, name)(*args),
                                  getattr(JMATH, name)(*args))
