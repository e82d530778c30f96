"""CIELab to sRGB as Pillow converts an image of mode "LAB".

Pillow's ``convert`` of "LAB" to "RGB" or "RGBA" is a LittleCMS transform
from its built-in Lab profile (D50, version 2) to its built-in sRGB
profile at perceptual intent, 8 bits a sample in and out. LittleCMS
optimizes that transform into one 33x33x33 grid of 16-bit RGB samples
(``OptimizeByResampling``, with its white fix-up) and evaluates it by
tetrahedral interpolation (``TetrahedralInterp16``); each 8-bit input is
widened as v * 257, each output narrowed as (v * 65281 + 2^23) >> 24.
Pillow holds a* and b* as signed bytes, so they go in with their top bit
flipped (as LittleCMS's unsigned encoding).

``lab_clut.npz`` holds that grid as LittleCMS 2.17 (the one Pillow
12.1.0 ships) computes it, read out of the optimized transform by
``tools/lab_clut.py``; this module is the interpolation, array-equal to
Pillow on every one of the 2^24 inputs (``tools/lab_clut.py --check``).
"""

from __future__ import annotations

import os

import numpy as np

CLUT_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "lab_clut.npz")
GRID = 33


def clut() -> np.ndarray:
    """The (33, 33, 33, 3) uint16 grid, L* slowest, b* fastest."""
    with np.load(CLUT_PATH) as f:
        return f["clut"]


def _interp(wide: np.ndarray, table: np.ndarray) -> np.ndarray:
    """TetrahedralInterp16 of (N, 3) int64 inputs (0-65535) -> (N, 3)
    int64 outputs: the corner below, then the three corners along the axes
    in order of the fractions, largest first (ties give the same sum)."""
    n = GRID
    f = wide * (n - 1)
    f = f + (f + 0x7FFF) // 0xFFFF  # _cmsToFixedDomain
    lo, rest = f >> 16, f & 0xFFFF
    stride = np.array([3 * n * n, 3 * n, 3])  # L*, a*, b*
    step = np.where(wide == 0xFFFF, 0, stride)  # no step past the last node
    base = (lo * stride).sum(1)
    order = np.argsort(-rest, axis=1, kind="stable")
    r = np.take_along_axis(rest, order, 1)
    s = np.take_along_axis(step, order, 1)
    v1 = base + s[:, 0]
    v2 = v1 + s[:, 1]
    v3 = v2 + s[:, 2]
    flat = table.reshape(-1).astype(np.int64)
    out = np.empty_like(wide)
    for ch in range(3):
        c0, c1, c2, c3 = (flat[v + ch] for v in (base, v1, v2, v3))
        total = ((c1 - c0) * r[:, 0] + (c2 - c1) * r[:, 1]
                 + (c3 - c2) * r[:, 2] + 0x8001)
        out[:, ch] = (c0 + ((total + (total >> 16)) >> 16)) & 0xFFFF
    return out


def lab_to_rgb(lab: np.ndarray, chunk: int = 1 << 20) -> np.ndarray:
    """(..., 3) uint8 L*, a*, b* as Pillow's "LAB" holds them (a* and b*
    signed) -> (..., 3) uint8 sRGB, what ``convert("RGB")`` gives."""
    flat = lab.reshape(-1, 3).astype(np.int64)
    flat[:, 1:] ^= 128
    table = clut()
    out = np.empty(flat.shape, np.uint8)
    for i in range(0, len(flat), chunk):
        wide = _interp(flat[i:i + chunk] * 257, table)
        out[i:i + chunk] = (wide * 65281 + (1 << 23)) >> 24
    return out.reshape(lab.shape)
