"""Rectangle packing for texture canvases (mapbox/potpack, atlas.ts:60).

``potpack_python`` is a copy of the JAX package's: sort by height, fill a
roughly square strip, split free spaces. ``potpack`` runs its C++ twin
(``accel/cbvh/potpack.cpp``, bit-identical) when the native library has a
compiler. Integer dims keep integer results either way (the fat-atlas
canvas uses them as an array shape).
"""

from __future__ import annotations

import math

import numpy as np

from wgpu_path_tracing_tpu_torch.accel import native


def potpack(boxes: list[dict]) -> tuple[int, int]:
    """Pack boxes ``{"w", "h"}`` in place (sets each box's ``x`` and ``y``).
    Returns the (width, height) of the packed canvas: ``potpack_python``'s
    positions and canvas, through the native library when it has a
    compiler."""
    if not (boxes and native.native_available()):
        return potpack_python(boxes)
    xy, w, h = native.potpack_native(
        np.array([[b["w"], b["h"]] for b in boxes], np.float64))
    # Integer dims pack exactly in float64; give them back as ints.
    as_int = all(isinstance(b["w"], int) and isinstance(b["h"], int)
                 for b in boxes)
    cast = int if as_int else float
    for box, (x, y) in zip(boxes, xy):
        box["x"], box["y"] = cast(x), cast(y)
    return cast(w), cast(h)


def potpack_python(boxes: list[dict]) -> tuple[int, int]:
    """The Python packer, ``potpack``'s plain version."""
    area = sum(b["w"] * b["h"] for b in boxes)
    max_width = max((b["w"] for b in boxes), default=0)
    order = sorted(range(len(boxes)), key=lambda i: -boxes[i]["h"])
    start_width = max(math.ceil(math.sqrt(area / 0.95)), max_width)
    spaces = [{"x": 0, "y": 0, "w": start_width, "h": float("inf")}]
    width = height = 0
    for bi in order:
        box = boxes[bi]
        for i in range(len(spaces) - 1, -1, -1):
            space = spaces[i]
            if box["w"] > space["w"] or box["h"] > space["h"]:
                continue
            box["x"] = space["x"]
            box["y"] = space["y"]
            height = max(height, box["y"] + box["h"])
            width = max(width, box["x"] + box["w"])
            if box["w"] == space["w"] and box["h"] == space["h"]:
                spaces[i] = spaces[-1]
                spaces.pop()
            elif box["h"] == space["h"]:
                space["x"] += box["w"]
                space["w"] -= box["w"]
            elif box["w"] == space["w"]:
                space["y"] += box["h"]
                space["h"] -= box["h"]
            else:
                spaces.append(
                    {
                        "x": space["x"] + box["w"],
                        "y": space["y"],
                        "w": space["w"] - box["w"],
                        "h": box["h"],
                    }
                )
                space["y"] += box["h"]
                space["h"] -= box["h"]
            break
    return width, height
