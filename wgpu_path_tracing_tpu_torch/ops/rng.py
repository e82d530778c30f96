"""Per-ray random numbers: random.wgsl's PCG, reference mode.

The same semantics as the JAX package's ``ops/rng.py`` in ``"reference"``
mode:

* seed = x + y * 1000 + frame * 100000 (random.wgsl:3-5),
* rand(): state = state * 747796405 + 2891336453;
  word = ((state >> ((state >> 28) + 4)) ^ state) * 277803737;
  word = (word >> 22) ^ word; value = f32(word) / f32(4294967295), where the
  divisor rounds to 2^32, so rand() can return exactly 1.0,
* rand_int(lo, hi) = lo + i32(rand() * f32(hi - lo + 1)), clamped to hi,
* masked advancement: a draw advances the state only on lanes in ``mask``.

PyTorch's CPU backend has no uint32 ``+`` or ``>>``, so the state is an
int64 tensor holding values in [0, 2^32) and every step masks to 32 bits;
no product exceeds 2^63. The word converts to float32 with one
round-to-nearest, which gives the bits the JAX package gets from its 16-bit
halves.
"""

from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
MUL = 747796405
INC = 2891336453
XSH = 277803737

# f32(4294967295u) rounds to 4294967296.0: 1 / that is exactly 2^-32.
INV = float(np.float32(np.float32(1.0) / np.float32(4294967295.0)))


def seed_pixel(x: torch.Tensor, y: torch.Tensor, frame: int) -> torch.Tensor:
    """initRNG (random.wgsl:3-5) as an int64 state in [0, 2^32)."""
    x = x.to(torch.int64)
    y = y.to(torch.int64)
    return (x + y * 1000 + int(frame) * 100000) & MASK32


def _pcg(state: torch.Tensor):
    state = (state * MUL + INC) & MASK32
    shift = (state >> 28) + 4
    word = (((state >> shift) ^ state) * XSH) & MASK32
    word = (word >> 22) ^ word
    return state, word


def rand(state: torch.Tensor, mask: torch.Tensor | None = None):
    """Returns (value in [0, 1], new_state); the state moves only where
    ``mask`` holds."""
    new_state, word = _pcg(state)
    value = word.to(torch.float32) * INV
    if mask is not None:
        new_state = torch.where(mask, new_state, state)
    return value, new_state


def rand_int(state: torch.Tensor, lo: int, hi: int,
             mask: torch.Tensor | None = None):
    """randInt(lo, hi) inclusive (random.wgsl:14-16), clamped to ``hi`` for
    the rand() == 1.0 edge."""
    value, new_state = rand(state, mask)
    span = float(np.float32(hi - lo + 1))
    idx = lo + (value * span).to(torch.int32)
    idx = torch.clamp_max(idx, hi)
    return idx, new_state
