"""In-place partial sort: a copy of the JAX package's ``utils/arr.py``
(src/utils/arr.ts:1-109).

The reference's BVH build sorts the [start, end) range of its triangle
array along the split axis with a hand-written quicksort
(sortArrayPartially, whose one unit test is src/spec/arr.test.ts). The SAH
build here (``accel/bvh.py``) sorts index permutations with NumPy; this
function keeps the reference's API, the throw on invalid indices included,
for host-side tooling.
"""

from __future__ import annotations

import functools


def sort_array_partially(arr, start: int, end: int, compare=None) -> None:
    """Sort ``arr[start:end]`` in place. ``compare(a, b)`` returns < 0, 0
    or > 0, as a JavaScript comparator does. Invalid indices raise
    ``ValueError`` (arr.ts:7-10)."""
    if start < 0 or end > len(arr) or start >= end:
        raise ValueError(f"Invalid indices: start={start}, end={end}")
    key = None if compare is None else functools.cmp_to_key(compare)
    arr[start:end] = sorted(arr[start:end], key=key)
