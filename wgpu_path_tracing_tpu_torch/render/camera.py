"""Camera model and fly-controls.

Mirrors the reference's camera struct and interaction semantics:

* fields and defaults — renderer.ts:136-150 / gpu.ts:38-50 (CameraCPU):
  position (0, 1, 2.8), forward (0,0,-1), right (1,0,0), up (0,1,0),
  fov pi/3, focusDistance 5.0, aperture 0.001.
* ``move`` — renderer.ts:152-169 (moveCamera): position += basis-weighted
  (forward, right, up) deltas.
* ``rotate`` — renderer.ts:171-201 (rotateCamera): yaw about world Y, pitch
  clamped to ±89% of pi/2, right/up re-derived from forward × worldUp.

The camera is host-side state (NumPy); ``as_pytree`` converts it to a dict of
float32 NumPy values, the form the ray generator reads.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


def _normalize(v: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(v)
    return v / n if n > 0 else v


@dataclasses.dataclass
class Camera:
    position: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.0, 1.0, 2.8], np.float32)
    )
    forward: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.0, 0.0, -1.0], np.float32)
    )
    right: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([1.0, 0.0, 0.0], np.float32)
    )
    up: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.0, 1.0, 0.0], np.float32)
    )
    fov: float = math.pi / 3
    aspect: float = 1.0
    width: int = 512
    height: int = 512
    aperture: float = 0.001
    focus_distance: float = 5.0

    def move(self, forward: float, right: float, up: float) -> None:
        """renderer.ts:152-169 — translate along the camera basis."""
        movement = (
            forward * self.forward + right * self.right + up * self.up
        ).astype(np.float32)
        self.position = (self.position + movement).astype(np.float32)

    def rotate(self, yaw: float, pitch: float) -> None:
        """renderer.ts:171-201 — yaw about world Y; pitch clamped ±89%·(pi/2)."""
        current_pitch = math.asin(float(np.clip(self.forward[1], -1.0, 1.0)))
        new_pitch = max(
            min(current_pitch + pitch, (math.pi / 2) * 0.99),
            (-math.pi / 2) * 0.99,
        )
        pitch_delta = new_pitch - current_pitch

        cy, sy = math.cos(yaw), math.sin(yaw)
        rot_y = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], np.float64)
        cp, sp = math.cos(pitch_delta), math.sin(pitch_delta)
        rot_x = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]], np.float64)
        rotation = rot_y @ rot_x

        self.forward = _normalize(rotation @ self.forward.astype(np.float64)).astype(
            np.float32
        )
        world_up = np.array([0.0, 1.0, 0.0], np.float32)
        self.right = _normalize(np.cross(self.forward, world_up)).astype(np.float32)
        self.up = _normalize(np.cross(self.right, self.forward)).astype(np.float32)

    def resize(self, width: int, height: int) -> None:
        """renderer.ts:496-503 — update dims and aspect."""
        self.width = width
        self.height = height
        self.aspect = width / height

    def as_pytree(self) -> dict:
        """Camera parameters as float32 NumPy values."""
        return {
            "position": np.asarray(self.position, np.float32),
            "forward": np.asarray(self.forward, np.float32),
            "right": np.asarray(self.right, np.float32),
            "up": np.asarray(self.up, np.float32),
            "fov": np.float32(self.fov),
            "aspect": np.float32(self.aspect),
            "aperture": np.float32(self.aperture),
            "focus_distance": np.float32(self.focus_distance),
        }
