"""FITS images in NumPy, the pixels Pillow gives.

Pillow's ``FitsImagePlugin`` reads 80-byte header cards up to ``END``,
skips to the next 2,880-byte block and reads the first header that has an
image: the primary one (``NAXIS`` > 0), or a ``BINTABLE`` extension with
``ZIMAGE = T`` and ``ZCMPTYPE = 'GZIP_1  '``, whose ``Z``-prefixed cards
give the image. It reads what it reads, quirks and all:

* ``BITPIX`` 8, 16, 32, -32 and -64 give modes "L", "I;16", "I", "F" and
  "F", and the raw data is unpacked in that mode's own raw mode: 16-bit
  samples little-endian ("I;16"), 32-bit ones native (little-endian), and
  a -64 image as 4-byte floats, whatever FITS's big-endian 8-byte values
  say; rows run bottom-up (the tile's ``ystep`` -1); ``NAXIS`` 1 is a
  column of one pixel a row;
* ``GZIP_1``: the rest of the file from the table's end inflated as gzip
  members (``gzip.decompress``, trailing bytes other than another member
  raise), 4 bytes a pixel of which the last ``min(BITPIX // 8, 4)`` are
  kept (none for a float image), rows bottom-up, then unpacked in the
  mode's raw mode;
* a header whose first card is not ``SIMPLE = T`` passes the bytes on
  (``NotThisFormat``); a header with no image raises ("No image data"),
  another ``BITPIX`` leaves no mode, which passes the bytes on too.

"I;16", "I" and "F" reach RGBA through "L" (``pilmodes.gray8``).
"""

from __future__ import annotations

import gzip
import math
import zlib

import numpy as np

from wgpu_path_tracing_tpu_torch.utils.pilmodes import gray8, gray_rgba, raw_rows
from wgpu_path_tracing_tpu_torch.utils.sniff import NotThisFormat, bomb_check

# BITPIX -> (Pillow's mode, the dtype of its raw mode, bytes a pixel).
MODES = {8: ("L", "u1", 1), 16: ("I;16", "<u2", 2), 32: ("I", "<i4", 4),
         -32: ("F", "<f4", 4), -64: ("F", "<f4", 4)}


def _int(v: bytes, name: str) -> int:
    try:
        return int(v)
    except ValueError:
        raise ValueError(f"{name}: a FITS card is not an integer "
                         f"({v[:20]!r})") from None


def _size(headers: dict, prefix: bytes, name: str):
    naxis = _int(headers[prefix + b"NAXIS"], name)
    if naxis == 0:
        return None
    if naxis == 1:
        return 1, _int(headers[prefix + b"NAXIS1"], name)
    return (_int(headers[prefix + b"NAXIS1"], name),
            _int(headers[prefix + b"NAXIS2"], name))


def _parse(headers: dict, name: str):
    """``_parse_headers``: (decoder, offset, size, BITPIX), or None where
    the header has no image."""
    prefix, decoder, offset = b"", "raw", 0
    try:
        if (headers.get(b"XTENSION") == b"'BINTABLE'"
                and headers.get(b"ZIMAGE") == b"T"
                and headers[b"ZCMPTYPE"] == b"'GZIP_1  '"):
            w, h = _size(headers, b"", name) or (0, 0)
            offset = w * h * (_int(headers[b"BITPIX"], name) // 8)
            prefix, decoder = b"Z", "fits_gzip"
        size = _size(headers, prefix, name)
        if not size:
            return None
        bits = _int(headers[prefix + b"BITPIX"], name)
    except KeyError as exc:  # in _open: the bytes pass on
        raise NotThisFormat(f"{name}: a FITS header lacks {exc}") from None
    return decoder, offset, size, bits


def decode_fits_rgba(data: bytes, name: str = "image") -> np.ndarray:
    """FITS bytes -> (H, W, 4) uint8 RGBA, what Pillow's
    ``Image.open(...).convert("RGBA")`` returns."""
    headers: dict = {}
    in_header = False
    found = None
    pos = 0
    while True:
        card = data[pos:pos + 80]
        pos += len(card)
        if not card:
            raise ValueError(f"{name}: truncated FITS file")
        keyword = card[:8].strip()
        if keyword in (b"SIMPLE", b"XTENSION"):
            in_header = True
        elif headers and not in_header:
            break
        elif keyword == b"END":
            pos = math.ceil(pos / 2880) * 2880
            if not found:
                found = _parse(headers, name)
            in_header = False
            continue
        if found:
            continue
        value = card[8:].split(b"/")[0].strip()
        if value.startswith(b"="):
            value = value[1:].strip()
        if not headers and (not keyword.startswith(b"SIMPLE")
                            or value != b"T"):
            raise NotThisFormat(f"{name}: not a FITS file")
        headers[keyword] = value
    if not found:
        raise ValueError(f"{name}: no image data in the FITS file")
    decoder, offset, (w, h), bits = found
    offset += pos - 80
    if bits not in MODES or w <= 0 or h <= 0:
        raise NotThisFormat(f"{name}: a FITS image Pillow gives no mode or "
                            f"size (BITPIX {bits}, {w}x{h})")
    bomb_check(w, h, name)
    _, dtype, unit = MODES[bits]
    if decoder == "raw":
        rows = raw_rows(data, offset, h, unit * w, unit * w, True, name)
    else:
        try:
            value = gzip.decompress(data[max(offset, 0):])
        except (OSError, EOFError, zlib.error) as exc:
            raise ValueError(f"{name}: bad GZIP_1 FITS data ({exc})") from None
        keep = min(bits // 8, 4)
        cells = np.frombuffer(value[:4 * w * h], np.uint8)
        if len(cells) < 4 * w * h or keep <= 0:
            raise ValueError(f"{name}: not enough image data in the "
                             "GZIP_1 FITS data")
        rows = cells.reshape(h, w, 4)[:, :, 4 - keep:].reshape(h, w * keep)
        rows = rows[::-1]
    values = np.ascontiguousarray(rows).view(np.dtype(dtype)).reshape(h, w)
    return gray_rgba(gray8(values))
