"""X11 bitmap (XBM) decoding in NumPy, the pixels Pillow gives.

Pillow's ``XbmImagePlugin`` matches its header pattern (``#define``
lines of the width and the height, optionally of a hot spot, then
anything up to ``_bits[]``) against the first 512 bytes only, and decodes
what follows with its C ``xbm`` decoder; this module reads what it reads,
to the same bytes:

* from the end of the match, each byte is found by the next lower-case
  ``x``, and is the two characters after it read as hexadecimal digits, a
  character that is no digit counting 0; the search goes on three bytes
  after that ``x``, so an ``x`` inside those two characters is passed
  over, and anything else (``0X``, commas, comments) is skipped;
* rows are ``(width + 7) // 8`` bytes, the first pixel in the lowest bit,
  and a set bit is white (Pillow's writer stores white pixels as set
  bits); bytes past the last row are not read, and a stream that ends
  before it raises.

Bytes the pattern does not match in the first 512 (a header that reaches
``_bits[]`` past them, too) and an image of no pixels are passed on to
Pillow's next formats (``NotThisFormat``), as Pillow's ``SyntaxError``
passes them on. The hex is parsed in NumPy, a search over all the ``x``
bytes at once.
"""

from __future__ import annotations

import re

import numpy as np

from wgpu_path_tracing_tpu_torch.utils.sniff import NotThisFormat, bomb_check

HEADER = re.compile(
    rb"\s*#define[ \t]+.*_width[ \t]+(?P<width>[0-9]+)[\r\n]+"
    b"#define[ \t]+.*_height[ \t]+(?P<height>[0-9]+)[\r\n]+"
    b"(?P<hotspot>"
    b"#define[ \t]+[^_]*_x_hot[ \t]+(?P<xhot>[0-9]+)[\r\n]+"
    b"#define[ \t]+[^_]*_y_hot[ \t]+(?P<yhot>[0-9]+)[\r\n]+"
    b")?"
    rb"[\000-\377]*_bits\[]")
# Pillow's HEX(): a hexadecimal digit's value, 0 for any other byte.
HEX = np.zeros(256, np.uint8)
for _digits, _base in ((b"0123456789", 0), (b"abcdef", 10), (b"ABCDEF", 10)):
    HEX[np.frombuffer(_digits, np.uint8)] = _base + np.arange(len(_digits))


def byte_starts(xs: np.ndarray) -> np.ndarray:
    """The ``x`` positions (sorted) the decoder takes: the first, then each
    next one at least three bytes on. Where two ``x`` lie closer, the
    choice is found by binary lifting over "the next one three on"."""
    if len(xs) < 2 or (np.diff(xs) >= 3).all():
        return xs
    nxt = np.searchsorted(xs, xs + 3)
    jumps = [np.append(nxt, len(xs))]
    while (1 << len(jumps)) < len(xs):
        j = jumps[-1]
        jumps.append(j[j])
    idx = np.arange(len(xs))
    cur = np.zeros(len(xs), np.int64)
    for j in reversed(jumps):
        step = j[cur]
        cur = np.where(step <= idx, step, cur)
    return xs[cur == idx]


def decode_xbm_rgba(data: bytes, name: str = "image") -> np.ndarray:
    """XBM bytes -> (H, W, 4) uint8 RGBA, what Pillow's
    ``Image.open(...).convert("RGBA")`` returns."""
    m = HEADER.match(data[:512])
    if not m:
        raise NotThisFormat(f"{name}: not an XBM header")
    w, h = int(m.group("width")), int(m.group("height"))
    if w == 0 or h == 0:
        raise NotThisFormat(f"{name}: an XBM image of no pixels")
    bomb_check(w, h, name)
    row_bytes = (w + 7) // 8
    size = h * row_bytes
    buf = np.frombuffer(data, np.uint8)
    xs = np.flatnonzero(buf[m.end():] == ord("x")) + m.end()
    xs = byte_starts(xs[xs + 2 < len(buf)])
    if len(xs) < size:
        raise ValueError(f"{name}: image file is truncated (the XBM data "
                         f"holds {len(xs)} of {size} bytes)")
    xs = xs[:size]
    stream = (HEX[buf[xs + 1]] << 4) | HEX[buf[xs + 2]]
    bits = np.unpackbits(stream.reshape(h, row_bytes), axis=1,
                         bitorder="little")[:, :w]
    out = np.full((h, w, 4), 255, np.uint8)
    out[..., :3] = (bits * 255).astype(np.uint8)[..., None]
    return out
