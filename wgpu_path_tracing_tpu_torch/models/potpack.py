"""Rectangle packing for texture canvases (mapbox/potpack, atlas.ts:60).

A copy of the JAX package's ``models/gltf.py::potpack_python``: sort by
height, fill a roughly square strip, split free spaces. The JAX package
dispatches to a native twin held bit-identical to this packer, so both give
the same positions. Integer dims keep integer arithmetic throughout (the
fat-atlas canvas uses the result as an array shape).
"""

from __future__ import annotations

import math


def potpack(boxes: list[dict]) -> tuple[int, int]:
    """Pack boxes ``{"w", "h"}`` in place (sets each box's ``x`` and ``y``).
    Returns the (width, height) of the packed canvas."""
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
