"""Per-ray random numbers: random.wgsl's PCG and the "hash" and
"stratified" seeds.

The same semantics as the JAX package's ``ops/rng.py``:

* seed = x + y * 1000 + frame * 100000 (random.wgsl:3-5),
* rand(): state = state * 747796405 + 2891336453;
  word = ((state >> ((state >> 28) + 4)) ^ state) * 277803737;
  word = (word >> 22) ^ word; value = f32(word) / f32(4294967295), where the
  divisor rounds to 2^32, so rand() can return exactly 1.0,
* rand_int(lo, hi) = lo + i32(rand() * f32(hi - lo + 1)), clamped to hi,
* masked advancement: a draw advances the state only on lanes in ``mask``,
* ``hash_seed``: two PCG output rounds over x + y * 9781 + frame * 6271 +
  stream * 26699 (the "hash" mode's seed, and the rotations of the R2 points),
* ``r2_point``: the R2 low-discrepancy sequence frac(u0 + f * R2_A), f the
  frame modulo ``R2_CYCLE``, rotated per pixel by two ``hash_seed`` streams
  (the "stratified" mode's pixel jitter and lens disc).

PyTorch's CPU backend has no uint32 ``+`` or ``>>``, so the state is an
int64 tensor holding values in [0, 2^32) and every step masks to 32 bits;
no product exceeds 2^63. The word converts to float32 with one
round-to-nearest, which gives the bits the JAX package gets from its 16-bit
halves.

``r2_point`` multiplies the frame by the float32 constant on the host and adds
the product to the rotation: two rounded operations, as PyTorch runs them on
either device. XLA:CPU could contract ``u0 + f * R2_A1`` into one fused
multiply-add and so differ by one ulp before the ``floor``; measured, it
does not, and the JAX package's values are bit-equal
(``tests/test_torch_sampling.py``).
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


def hash_seed(x: torch.Tensor, y: torch.Tensor, frame: int,
              stream: int = 0) -> torch.Tensor:
    """The "hash" rng mode's seed (JAX ``ops/rng.py:128-143``): a uint32
    held in int64. ``stream * 26699`` wraps modulo 2^32 before the add."""
    v = (x.to(torch.int64) + y.to(torch.int64) * 9781
         + (int(frame) & MASK32) * 6271
         + ((int(stream) & MASK32) * 26699 & MASK32)) & MASK32
    for _ in range(2):
        _, v = _pcg(v)
    return v


# R2 additive low-discrepancy sequence (inverse powers of the plastic
# constant): frame k's point is frac(k * (R2_A1, R2_A2)).
R2_A1 = 0.7548776662466927
R2_A2 = 0.5698402909980532
R2_CYCLE = 4096  # frames fold modulo this; float32 frac() loses bits past it


def frac_step(u0: torch.Tensor, frame: int, a: float) -> torch.Tensor:
    """frac(u0 + f * a), f = frame mod R2_CYCLE: the float32 product on the
    host, then the sum, each rounded once."""
    step = np.float32(int(frame) & (R2_CYCLE - 1)) * np.float32(a)
    u = u0 + float(step)
    return u - torch.floor(u)


def rotation(x: torch.Tensor, y: torch.Tensor, stream: int) -> torch.Tensor:
    """A pixel's Cranley-Patterson offset in [0, 1): ``hash_seed`` at frame
    0 times 2^-32 (``INV``)."""
    return hash_seed(x, y, 0, stream).to(torch.float32) * INV


def r2_point(x: torch.Tensor, y: torch.Tensor, frame: int, stream: int = 0):
    """The R2 point of (pixel, frame) in [0, 1)^2, rotated per pixel by the
    ``hash_seed`` streams ``stream`` and ``stream + 1``."""
    return (frac_step(rotation(x, y, stream), frame, R2_A1),
            frac_step(rotation(x, y, stream + 1), frame, R2_A2))
