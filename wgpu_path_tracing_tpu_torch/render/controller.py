"""Headless fly-camera controller: the counterpart of the JAX package's
``render/controller.py`` (controller.ts).

The reference maps browser input events to camera motion each frame
(controller.ts:136-170: WASD + space/shift/q translation at MOVE_SPEED = 2.0
units/s, pointer look at ROTATE_SPEED = pi/18 rad/s per accumulated pixel).
Headless, the same state machine is driven by calls: feed key presses and
releases and pointer moves, then call ``update(dt)`` once a frame. Motion
goes through ``Renderer.move_camera`` and ``Renderer.rotate_camera``, which
restart the accumulation, as the reference's does.

    c = Controller(renderer)
    c.key_down("w"); c.update(1 / 60); c.key_up("w")
    c.mouse_move(12.0, -3.0); c.update(1 / 60)
    c.pinch(40.0)   # two-finger dolly, applied at once
"""

from __future__ import annotations

import math

MOVE_SPEED = 2.0  # controller.ts:3
ROTATE_SPEED = math.pi / 18  # controller.ts:4
PINCH_DOLLY_SCALE = 0.001  # controller.ts:96-97 (deltaDistance * 0.001)


class Controller:
    def __init__(self, renderer):
        self.renderer = renderer
        self._pressed: dict[str, bool] = {}
        self._mouse_dx = 0.0
        self._mouse_dy = 0.0

    # --- event feeds (the headless stand-ins for DOM listeners) -----------
    def key_down(self, key: str) -> None:
        self._pressed[key] = True

    def key_up(self, key: str) -> None:
        self._pressed[key] = False

    def mouse_move(self, dx: float, dy: float) -> None:
        """Accumulate pointer deltas (controller.ts:41-48)."""
        self._mouse_dx += dx
        self._mouse_dy += dy

    def touch_move(self, dx: float, dy: float) -> None:
        """One-finger touch look: the mouse's accumulation
        (controller.ts:69-84)."""
        self.mouse_move(dx, dy)

    def pinch(self, delta_distance: float) -> None:
        """Two-finger pinch dolly (controller.ts:85-101): the change in
        finger separation, in pixels, times PINCH_DOLLY_SCALE, moves the
        camera forward at once (the reference applies it in the touch
        handler, not in the per-frame update)."""
        if delta_distance != 0.0:
            self.renderer.move_camera(delta_distance * PINCH_DOLLY_SCALE,
                                      0.0, 0.0)

    # --- per-frame integration (controller.ts:136-170) ---------------------
    def update(self, delta_time: float) -> None:
        r = self.renderer
        step = MOVE_SPEED * delta_time
        if self._pressed.get("w"):
            r.move_camera(step, 0.0, 0.0)
        if self._pressed.get("s"):
            r.move_camera(-step, 0.0, 0.0)
        if self._pressed.get("a"):
            r.move_camera(0.0, -step, 0.0)
        if self._pressed.get("d"):
            r.move_camera(0.0, step, 0.0)
        if self._pressed.get(" "):
            r.move_camera(0.0, 0.0, step)
        if self._pressed.get("Shift") or self._pressed.get("q"):
            r.move_camera(0.0, 0.0, -step)

        if self._mouse_dx != 0.0 or self._mouse_dy != 0.0:
            r.rotate_camera(self._mouse_dx * -ROTATE_SPEED * delta_time,
                            self._mouse_dy * -ROTATE_SPEED * delta_time)
            self._mouse_dx = 0.0
            self._mouse_dy = 0.0
