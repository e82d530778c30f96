"""IM Tools images in NumPy, the pixels Pillow gives.

Pillow's ``ImtImagePlugin`` reads text lines (``width n``, ``height n``,
``pixel n8``, comments after "*") in buffers of 100 bytes until a form
feed, and the raw gray image ("L", rows top-down) right after it. A line
it cannot read, one longer than 100 bytes or an empty one ends the
header; a number it cannot read ends Pillow's search (``ValueError``).
A header without a mode or a size passes the bytes on; one without the
form feed is an image Pillow cannot load.
"""

from __future__ import annotations

import re

import numpy as np

from wgpu_path_tracing_tpu_torch.utils.pilmodes import gray_rgba, raw_rows
from wgpu_path_tracing_tpu_torch.utils.sniff import NotThisFormat, bomb_check

FIELD = re.compile(rb"([a-z]*) ([^ \r\n]*)")


def decode_imt_rgba(data: bytes, name: str = "image") -> np.ndarray:
    """IM Tools bytes -> (H, W, 4) uint8 RGBA, what Pillow's
    ``Image.open(...).convert("RGBA")`` returns."""
    buffer, pos = data[:100], min(len(data), 100)
    if b"\n" not in buffer:
        raise NotThisFormat(f"{name}: not an IM Tools file")
    w = h = 0
    gray = False
    start = None
    while True:
        if buffer:
            s, buffer = buffer[:1], buffer[1:]
        else:
            s, pos = data[pos:pos + 1], pos + 1
        if not s:
            break
        if s == b"\x0c":
            start = pos - len(buffer)
            break
        if b"\n" not in buffer:
            more = data[pos:pos + 100]
            buffer += more
            pos += len(more)
        lines = buffer.split(b"\n")
        s += lines.pop(0)
        buffer = b"\n".join(lines)
        if len(s) == 1 or len(s) > 100:
            break
        if s[0] == ord(b"*"):
            continue
        m = FIELD.match(s)
        if not m:
            break
        k, v = m.group(1, 2)
        try:
            if k == b"width":
                w = int(v)
            elif k == b"height":
                h = int(v)
        except ValueError:
            raise ValueError(f"{name}: bad IM Tools field {s[:40]!r}") from None
        if k == b"pixel" and v == b"n8":
            gray = True
    if not gray or w <= 0 or h <= 0:
        raise NotThisFormat(f"{name}: an IM Tools header without a mode or "
                            "a size")
    bomb_check(w, h, name)
    if start is None:
        raise ValueError(f"{name}: an IM Tools header without a form feed "
                         "(Pillow: cannot load this image)")
    return gray_rgba(raw_rows(data, start, h, w, w, False, name))
