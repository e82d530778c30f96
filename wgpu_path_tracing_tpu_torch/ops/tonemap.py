"""Display transform: exposure -> AGX -> look -> EOTF -> gamma.

The counterpart of the JAX package's ``ops/tonemap.py`` (blit.wgsl:43-155),
kept exactly, including its NaNs: the log2 of a non-positive inset value and
the power 2.2 of a negative outset value give NaN for linear inputs below
about 1e-4, which ``utils/image.py::buffer_to_srgb`` scrubs.

The 3x3 colour matrices are applied as explicit sums of products, so no
matrix-multiply path (and no TF32) is involved.
"""

from __future__ import annotations

import numpy as np
import torch

EXPOSURE = 1.0  # blit.wgsl:43

# Columns as written in blit.wgsl:68-72, transposed so v @ M.T == WGSL M * v.
_AGX_MAT = np.array(
    [
        [0.842479062253094, 0.0423282422610123, 0.0423756549057051],
        [0.0784335999999992, 0.878468636469772, 0.0784336],
        [0.0792237451477643, 0.0791661274605434, 0.879142973793104],
    ]
).T.astype(np.float32)

_AGX_MAT_INV = np.array(
    [
        [1.19687900512017, -0.0528968517574562, -0.0529716355144438],
        [-0.0980208811401368, 1.15190312990417, -0.0980434501171241],
        [-0.0990297440797205, -0.0989611768448433, 1.15107367264116],
    ]
).T.astype(np.float32)

_MIN_EV = -12.47393  # blit.wgsl:74
_MAX_EV = 4.026069  # blit.wgsl:75

_LUMA = np.array([0.2126, 0.7152, 0.0722], np.float32)  # blit.wgsl:103


def _apply(val: torch.Tensor, m: np.ndarray) -> torch.Tensor:
    """``val @ m.T`` over the last axis of size 3."""
    cols = [val[..., 0] * float(m[j, 0]) + val[..., 1] * float(m[j, 1])
            + val[..., 2] * float(m[j, 2]) for j in range(3)]
    return torch.stack(cols, dim=-1)


def _agx_contrast(x):
    """6th-order sigmoid approximation (blit.wgsl:54-65)."""
    x2 = x * x
    x4 = x2 * x2
    return (15.5 * x4 * x2 - 40.14 * x4 * x + 31.96 * x4 - 6.868 * x2 * x
            + 0.4298 * x2 + 0.1191 * x - 0.00232)


def agx(val):
    """blit.wgsl:67-86."""
    result = _apply(val, _AGX_MAT)
    result = torch.clamp(torch.log2(result), _MIN_EV, _MAX_EV)
    result = (result - _MIN_EV) / (_MAX_EV - _MIN_EV)
    return _agx_contrast(result)


def agx_look(val):
    """blit.wgsl:102-114: slope/power 1, saturation 1."""
    luma = (val[..., 0] * float(_LUMA[0]) + val[..., 1] * float(_LUMA[1])
            + val[..., 2] * float(_LUMA[2]))[..., None]
    return luma + 1.0 * (val - luma)


def agx_eotf(val):
    """blit.wgsl:88-100."""
    return torch.pow(_apply(val, _AGX_MAT_INV), 2.2)


def tone_mapping(color, exposure: float = EXPOSURE):
    """blit.wgsl:133-145."""
    mapped = color * float(np.exp2(np.float32(exposure)))
    return agx_eotf(agx_look(agx(mapped)))


def display_transform(color: torch.Tensor, exposure: float = EXPOSURE):
    """The full fragment chain (blit.wgsl:147-155): tonemap then gamma."""
    return torch.pow(tone_mapping(color, exposure), 1.0 / 2.2)
