"""Tile-coherent ray ordering.

The reference dispatches 16x16 workgroups over the image (pt.wgsl:712,
renderer.ts:426-429), so its GPU warps are spatially coherent. Our flat
row-major ray batches put 1024-lane blocks on 2-pixel-tall strips spanning
the whole image width — terrible spatial coherence for the cluster-dispatch
intersector (a block's cluster working set is the union of its rays').

``tile_permutation`` reorders the flat pixel index so consecutive lanes form
square tiles (default 32x32 = 1024 = one intersection block). The
accumulation buffer lives in tile order on device; un-permute only when the
image leaves the device. RNG seeds depend on pixel (x, y), not lane order,
so results are identical to row-major rendering.
"""

from __future__ import annotations

import numpy as np


def tile_permutation(width: int, height: int, tile: int = 32) -> np.ndarray:
    """perm[k] = row-major flat index of the k-th tile-ordered pixel.

    Edge tiles are smaller; every pixel appears exactly once.
    """
    idx = np.arange(width * height, dtype=np.int64).reshape(height, width)
    out = []
    for ty in range(0, height, tile):
        for tx in range(0, width, tile):
            out.append(idx[ty : ty + tile, tx : tx + tile].reshape(-1))
    return np.concatenate(out)


def inverse_permutation(perm: np.ndarray) -> np.ndarray:
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm), dtype=perm.dtype)
    return inv
