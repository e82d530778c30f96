"""XV thumbnails in NumPy, the pixels Pillow gives.

Pillow's ``XVThumbImagePlugin`` takes a file that starts "P7 332", skips
the rest of that line and the comment lines ("#") after it, reads the
width and height from the next line, and reads that many palette indices
(mode "P") through the fixed 3-3-2 palette: red ``r * 255 // 7``, green
``g * 255 // 7``, blue ``b * 255 // 3``. Running out of lines passes the
bytes on; a size line that is not two numbers ends Pillow's search.
"""

from __future__ import annotations

import numpy as np

from wgpu_path_tracing_tpu_torch.utils.pilmodes import raw_rows
from wgpu_path_tracing_tpu_torch.utils.sniff import NotThisFormat, bomb_check

MAGIC = b"P7 332"
_i = np.arange(256)
PALETTE = np.stack([(_i >> 5) * 255 // 7, ((_i >> 2) & 7) * 255 // 7,
                    (_i & 3) * 255 // 3], -1).astype(np.uint8)


def _readline(data: bytes, pos: int) -> tuple[bytes, int]:
    end = data.find(b"\n", pos)
    end = len(data) if end < 0 else end + 1
    return data[pos:end], end


def decode_xvthumb_rgba(data: bytes, name: str = "image") -> np.ndarray:
    """XV thumbnail bytes -> (H, W, 4) uint8 RGBA, what Pillow's
    ``Image.open(...).convert("RGBA")`` returns."""
    if not data.startswith(MAGIC):
        raise NotThisFormat(f"{name}: not an XV thumbnail file")
    _, pos = _readline(data, 6)
    while True:
        s, pos = _readline(data, pos)
        if not s:
            raise NotThisFormat(f"{name}: the XV thumbnail ends before its "
                                "size")
        if s[0] != 35:  # not a '#' comment
            break
    fields = s.strip().split(maxsplit=2)[:2]
    try:
        w, h = (int(v) for v in fields)
    except ValueError:
        raise ValueError(f"{name}: bad XV thumbnail size line "
                         f"{s[:40]!r}") from None
    if w <= 0 or h <= 0:
        raise NotThisFormat(f"{name}: an XV thumbnail of no pixels")
    bomb_check(w, h, name)
    idx = raw_rows(data, pos, h, w, w, False, name)
    out = np.full((h, w, 4), 255, np.uint8)
    out[..., :3] = PALETTE[idx]
    return out
