"""X11 pixmap (XPM) decoding in NumPy, the pixels Pillow gives.

Pillow's ``XpmImagePlugin`` reads the file line by line; this module reads
what it reads, to the same bytes:

* after the first 9 bytes (``/* XPM */``), the first line that starts
  ``"w h colours bpp`` (each a run of digits, maybe empty, which Pillow's
  ``int`` then refuses) gives the size, the count of colour lines and the
  key's length ``bpp``;
* each colour line (right-stripped) has its key at bytes 1 to ``bpp`` and,
  in what lies between the key and its last two bytes, the first ``c``
  word followed by a value: ``#rrggbb`` (any hexadecimal number Python's
  ``int`` reads, its low 24 bits) or ``None``; a colour name, a missing
  ``c`` word or a line past the file's end raise; a ``c`` word with
  nothing after it is passed on to the next format (Pillow's
  ``IndexError``). A repeated key keeps its first place with its last
  colour;
* up to 256 colour lines give a palette image: the keys in order of first
  appearance, ``None`` keys left out. The ``None`` key's own bytes become
  ``info["transparency"]``, which ``convert("RGBA")`` reads as alphas of
  the first palette entries (a key " " gives index 0 alpha 32); a pixel
  that uses the ``None`` key raises (Pillow's ``tuple.index``). More than
  256 give an RGB image, which ``convert("RGBA")`` refuses when a key is
  ``None`` (bytes where it wants a colour), and a pixel of an unknown key
  raises;
* the pixel lines follow; of each, what lies between its first and last
  double quote is cut into keys of ``bpp`` bytes (the last maybe shorter),
  one pixel each, and the pixels are one stream: a short or long line
  shifts the rows after it. Lines are read until the stream holds the
  image, so lines after that are never looked at; a stream that ends
  first raises.

Bytes with no header line and an image of no pixels are passed on to
Pillow's next formats (``NotThisFormat``). The key lookup is vectorised:
each distinct key is looked up once.
"""

from __future__ import annotations

import re

import numpy as np

from wgpu_path_tracing_tpu_torch.utils.sniff import NotThisFormat, bomb_check

HEADER = re.compile(b'"([0-9]*) ([0-9]*) ([0-9]*) ([0-9]*)')


def _lines(data: bytes, pos: int):
    """``readline`` from ``pos``: (line, the position after it)."""
    while pos < len(data):
        end = data.find(b"\n", pos)
        end = len(data) if end < 0 else end + 1
        yield data[pos:end], end
        pos = end


def _colour(line: bytes, bpp: int, name: str):
    """(key, colour bytes or None for ``None``) of a colour line."""
    line = line.rstrip()
    key = line[1:bpp + 1]
    words = line[bpp + 1:-2].split()
    for i in range(0, len(words), 2):
        if words[i] == b"c":
            if i + 1 >= len(words):
                raise NotThisFormat(f"{name}: an XPM colour with no value")
            value = words[i + 1]
            if value == b"None":
                return key, None
            if value.startswith(b"#"):
                try:
                    v = int(value[1:], 16)
                except ValueError:
                    raise ValueError(f"{name}: bad XPM colour {value!r}"
                                     ) from None
                return key, bytes([(v >> 16) & 255, (v >> 8) & 255, v & 255])
            raise ValueError(f"{name}: XPM colour {value!r} (Pillow reads "
                             "only #rrggbb and None: cannot read this XPM "
                             "file)")
    raise ValueError(f"{name}: an XPM colour line with no colour (cannot "
                     "read this XPM file)")


def _keys(payloads: list, bpp: int) -> tuple[np.ndarray, list]:
    """The pixel keys of the quoted payloads, as (an index of each pixel
    into the distinct keys, the distinct keys as bytes)."""
    full, tails, where = [], [], []
    count = 0
    for p in payloads:
        n = len(p) // bpp * bpp
        full.append(p[:n])
        count += n // bpp
        if n < len(p):
            tails.append(p[n:])
            where.append(count)
            count += 1
    keyed = np.frombuffer(b"".join(full), np.uint8).reshape(-1, bpp)
    rows = np.zeros((count, bpp + 1), np.uint8)
    mask = np.ones(count, bool)
    mask[where] = False
    rows[mask, :bpp] = keyed
    rows[mask, bpp] = bpp
    for at, tail in zip(where, tails):
        rows[at, :len(tail)] = np.frombuffer(tail, np.uint8)
        rows[at, bpp] = len(tail)
    distinct, inverse = np.unique(rows, axis=0, return_inverse=True)
    keys = [bytes(r[:r[bpp]]) for r in distinct]
    return inverse.reshape(-1), keys


def decode_xpm_rgba(data: bytes, name: str = "image") -> np.ndarray:
    """XPM bytes -> (H, W, 4) uint8 RGBA, what Pillow's
    ``Image.open(...).convert("RGBA")`` returns."""
    if not data.startswith(b"/* XPM */"):
        raise NotThisFormat(f"{name}: not an XPM file")
    lines = _lines(data, 9)
    for line, pos in lines:
        m = HEADER.match(line)
        if m:
            break
    else:
        raise NotThisFormat(f"{name}: broken XPM file (no header line)")
    try:
        w, h, ncolours, bpp = (int(g) for g in m.groups())
    except ValueError:
        raise ValueError(f"{name}: an XPM header value is empty") from None
    palette, transparency = {}, None
    for _ in range(ncolours):
        line, pos = next(lines, (b"", pos))
        key, colour = _colour(line, bpp, name)
        if colour is None:
            transparency = key
        else:
            palette[key] = colour
    if w == 0 or h == 0:
        raise NotThisFormat(f"{name}: an XPM image of no pixels")
    bomb_check(w, h, name)
    pixels = w * h
    if bpp == 0:
        raise ValueError(f"{name}: XPM keys of 0 bytes (Pillow: range() arg "
                         "3 must not be zero)")
    payloads, count = [], 0
    for line, _ in _lines(data, pos):
        if count >= pixels:
            break
        quoted = line.split(b'"')
        payload = b'"'.join(quoted[1:-1])
        payloads.append(payload)
        count += -(-len(payload) // bpp)
    if count < pixels:
        raise ValueError(f"{name}: the XPM pixel lines hold {count} of "
                         f"{pixels} pixels (Pillow: not enough image data)")
    index, keys = _keys(payloads, bpp)
    rgb = ncolours > 256
    order = list(palette)
    table = np.zeros((len(keys), 3), np.uint8)
    missing = np.zeros(len(keys), bool)
    for k, key in enumerate(keys):
        if key in palette:
            table[k] = np.frombuffer(palette[key], np.uint8)
        else:
            missing[k] = True
    if missing[index].any():
        bad = keys[index[np.flatnonzero(missing[index])[0]]]
        raise ValueError(f"{name}: XPM pixel key {bad!r} is not in the "
                         "palette")
    index = index[:pixels]
    out = np.full((h, w, 4), 255, np.uint8)
    out[..., :3] = table[index].reshape(h, w, 3)
    if transparency is not None:
        if rgb:
            raise ValueError(f"{name}: an RGB XPM with a None key (Pillow's "
                             "convert wants a colour as its transparency)")
        alphas = np.full(len(keys), 255, np.uint8)
        slot = np.array([order.index(k) for k in keys], np.int64)
        hit = slot < len(transparency)
        alphas[hit] = np.frombuffer(transparency, np.uint8)[slot[hit]]
        out[..., 3] = alphas[index].reshape(h, w)
    return out
