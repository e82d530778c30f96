"""SoA vec3 helpers over (N,) tensors.

A vec3 is a ``V3`` of three lane tensors, as in the JAX package's
``ops/vec.py``. Every helper spells out its arithmetic in one fixed order
(left-associated sums, products rounded before sums), because the CUDA bounce
kernel repeats the same order per thread and its results must equal these
plain versions bit for bit.
"""

from __future__ import annotations

import typing

import torch


class V3(typing.NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    def __add__(self, o):
        if isinstance(o, V3):
            return V3(self.x + o.x, self.y + o.y, self.z + o.z)
        return V3(self.x + o, self.y + o, self.z + o)

    def __sub__(self, o):
        if isinstance(o, V3):
            return V3(self.x - o.x, self.y - o.y, self.z - o.z)
        return V3(self.x - o, self.y - o, self.z - o)

    def __mul__(self, o):
        if isinstance(o, V3):
            return V3(self.x * o.x, self.y * o.y, self.z * o.z)
        return V3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __neg__(self):
        return V3(-self.x, -self.y, -self.z)


def div_const(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` rounded as an IEEE division. PyTorch's CUDA division by a
    Python scalar multiplies by its reciprocal instead; a 0-d tensor divisor
    on the same device keeps the true quotient, as the kernels compute it."""
    return x / x.new_full((), c)


def dot(a: V3, b: V3):
    return a.x * b.x + a.y * b.y + a.z * b.z


def cross(a: V3, b: V3) -> V3:
    return V3(
        a.y * b.z - a.z * b.y,
        a.z * b.x - a.x * b.z,
        a.x * b.y - a.y * b.x,
    )


def length(a: V3):
    return torch.sqrt(dot(a, a))


def normalize(a: V3) -> V3:
    inv = torch.reciprocal(length(a))
    return V3(a.x * inv, a.y * inv, a.z * inv)


def where(mask, a: V3, b: V3) -> V3:
    return V3(
        torch.where(mask, a.x, b.x),
        torch.where(mask, a.y, b.y),
        torch.where(mask, a.z, b.z),
    )


def zeros_like(t: torch.Tensor) -> V3:
    z = torch.zeros_like(t)
    return V3(z, z, z)


def maxcomp(a: V3):
    return torch.maximum(torch.maximum(a.x, a.y), a.z)


def any_positive(a: V3):
    return (a.x > 0.0) | (a.y > 0.0) | (a.z > 0.0)


def from_rows(arr: torch.Tensor, base: int) -> V3:
    """Three consecutive rows of a (C, N) SoA table as a V3."""
    return V3(arr[base], arr[base + 1], arr[base + 2])


def stack_rows(v: V3) -> torch.Tensor:
    """(3, N) SoA tensor."""
    return torch.stack([v.x, v.y, v.z], dim=0)
