"""Microsoft Paint (MSP) decoding in NumPy, the pixels Pillow gives.

Pillow's ``MspImagePlugin`` reads the 32-byte header (16 little-endian
words whose XOR must be 0; width and height at bytes 4 and 6) and a 1-bit
image, a set bit white; this module reads what it reads, to the same
bytes:

* ``DanM`` (version 1) files: raw rows of ``(width + 7) // 8`` bytes after
  the header; data that ends before the last row raises;
* ``LinS`` (version 2) files: a row map of one little-endian word a row
  (each row's coded length), then the rows, each read whole and decoded
  by Pillow's Python ``MspDecoder``: a 0 byte starts a run (a count, then
  the value), any other byte is a count of literal bytes. A row of length
  0 is a blank row of 0xFF (white). Pillow checks no row's output against
  the width: the decoded bytes are one stream, so a row that decodes long
  or short shifts every row after it, and only a stream too short for the
  image raises; a literal count past the row's end copies what the row
  holds. A row map or a row that runs past the data, and a run cut short
  by its row's end, raise.

A header cut short, a checksum that is not 0 and an image of no pixels are
passed on to Pillow's next formats (``NotThisFormat``), as Pillow's
``SyntaxError`` passes them on.

The ``LinS`` loop is ``rle_plain`` here, the plain version of
``accel/cbvh/image_scan.cpp``'s ``wpt_msp_rle``, which the native library
runs wherever ``accel.native.native_available()``.
"""

from __future__ import annotations

import numpy as np

from wgpu_path_tracing_tpu_torch.utils.sniff import NotThisFormat, bomb_check

RLE_STATUS = {1: "a row runs past the end of the data",
              2: "a run is cut short by the end of its row"}


def rle_plain(data: bytes, pos: int, rowmap: np.ndarray, blank: int,
              size: int) -> tuple[np.ndarray, int, int]:
    """Pillow's ``MspDecoder`` rows from ``pos`` -> (the first ``size``
    bytes of the stream they make, zero-filled past its end; the bytes the
    rows make; status 0 or a key of RLE_STATUS)."""
    out = bytearray()
    n = len(data)
    for length in rowmap.tolist():
        if length == 0:
            out += b"\xff" * blank
            continue
        if pos + length > n:
            return _first(out, size), len(out), 1
        row = data[pos:pos + length]
        i = 0
        while i < length:
            t = row[i]
            i += 1
            if t == 0:
                if i + 2 > length:
                    return _first(out, size), len(out), 2
                out += row[i + 1:i + 2] * row[i]
                i += 2
            else:
                out += row[i:i + t]
                i += t
        pos += length
    return _first(out, size), len(out), 0


def _first(out: bytearray, size: int) -> np.ndarray:
    return np.frombuffer(bytes(out[:size]).ljust(size, b"\0"), np.uint8)


def decode_msp_rgba(data: bytes, name: str = "image") -> np.ndarray:
    """MSP bytes -> (H, W, 4) uint8 RGBA, what Pillow's
    ``Image.open(...).convert("RGBA")`` returns."""
    from wgpu_path_tracing_tpu_torch.accel import native

    if len(data) < 32 or not data.startswith((b"DanM", b"LinS")):
        raise NotThisFormat(f"{name}: not an MSP header")
    words = np.frombuffer(data, "<u2", count=16)
    if np.bitwise_xor.reduce(words) != 0:
        raise NotThisFormat(f"{name}: bad MSP checksum")
    w, h = int(words[2]), int(words[3])
    if w == 0 or h == 0:
        raise NotThisFormat(f"{name}: an MSP image of no pixels")
    bomb_check(w, h, name)
    row_bytes = (w + 7) // 8
    size = h * row_bytes
    if data.startswith(b"DanM"):
        if 32 + size > len(data):
            raise ValueError(f"{name}: image file is truncated (the MSP "
                             "rows end early)")
        stream = np.frombuffer(data, np.uint8, count=size, offset=32)
    else:
        if 32 + 2 * h > len(data):
            raise ValueError(f"{name}: truncated MSP file in the row map")
        rowmap = np.frombuffer(data, "<u2", count=h, offset=32)
        args = (data, 32 + 2 * h, rowmap, row_bytes, size)
        if native.native_available():
            stream, made, status = native.msp_rle_native(*args)
        else:
            stream, made, status = rle_plain(*args)
        if status:
            raise ValueError(f"{name}: corrupted MSP file ("
                             f"{RLE_STATUS[status]})")
        if made < size:
            raise ValueError(f"{name}: the MSP rows decode to {made} bytes, "
                             f"{size} wanted (Pillow: not enough image data)")
    bits = np.unpackbits(stream.reshape(h, row_bytes), axis=1)[:, :w]
    out = np.full((h, w, 4), 255, np.uint8)
    out[..., :3] = (bits * 255).astype(np.uint8)[..., None]
    return out
