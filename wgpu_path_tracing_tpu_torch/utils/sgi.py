"""SGI image decoding in NumPy, the pixels Pillow gives.

Pillow's ``SgiImagePlugin`` reads the 512-byte header and either reads the
channels as raw planes (compression 0) or decodes them with its C
``sgi_rle`` decoder (compression 1); this module reads what it reads, to
the same bytes:

* the modes of ``SgiImagePlugin.MODES``: one channel (gray; dimension 1 or
  2), three (RGB) or four (RGBA), each at 8 or 16 bits; 16-bit samples
  keep their high byte; rows are stored bottom-up;
* raw planes follow the header one after another; data that ends before
  the last plane raises;
* RLE: a table of each row's start and a table of each row's length (one
  entry a row a channel, big-endian, counted from the file's start), then
  the rows, each a chain of packets: a count byte (a 16-bit word at 16
  bits) whose top bit copies the next ``count & 0x7F`` samples and whose
  clear top bit repeats the next sample that often, up to a count of 0.
  Pillow's checks, copied: a row that starts inside the header, reads
  past the file or writes past its width raises (its length in the
  table only bounds its count of packets); the tables must fit in the
  file; a row whose chain has not ended by its last counted packet ends
  the decode there without an error, the rows after it left black; each
  row starts from what the previous row of its channel left in the row
  buffer;
* a compression byte other than 0 and 1 gives Pillow no data to read, and
  its ``load`` raises "cannot load this image": so does this module.

A header whose first fields are cut short is passed on to Pillow's next
formats (``NotThisFormat``); a mode Pillow does not list raises
``ValueError`` naming the image (Pillow's ``ValueError`` ends its search).

The RLE loop is ``rle_plain`` here, the plain version of
``accel/cbvh/image_scan.cpp``'s ``wpt_sgi_rle``, which the native library
runs wherever ``accel.native.native_available()``.
"""

from __future__ import annotations

import struct

import numpy as np

from wgpu_path_tracing_tpu_torch.utils.sniff import NotThisFormat, bomb_check

# (bytes a sample, dimension, channels) -> Pillow's mode.
MODES = {(1, 1, 1): "L", (1, 2, 1): "L", (2, 1, 1): "L", (2, 2, 1): "L",
         (1, 3, 3): "RGB", (2, 3, 3): "RGB", (1, 3, 4): "RGBA",
         (2, 3, 4): "RGBA"}
HEADER = 512
RLE_STATUS = {1: "the RLE tables do not fit in the file",
              2: "an RLE row lies outside the file or overruns its width"}


def _expand_row(data: bytes, pos: int, n: int, row: bytearray, ch: int,
                z: int, bpc: int, w: int, last: int) -> int:
    """One channel of one RLE row into ``row`` (samples interleaved ``z``
    apart, ``bpc`` bytes each): Pillow's ``expandrow``/``expandrow2`` with
    ``n`` the row's length and ``last`` the file's last byte. Returns 0, 1
    (the chain had not ended: stop the decode) or -1 (an overrun)."""
    x = 0
    dst = ch * bpc
    step = z * bpc
    while n > 0:
        if pos + bpc - 1 > last:
            return -1
        pixel = data[pos + bpc - 1]
        pos += bpc
        if n == 1 and pixel != 0:
            return 1
        count = pixel & 0x7F
        if not count:
            return 0
        if x + count > w:
            return -1
        x += count
        if pixel & 0x80:
            if pos + bpc * count > last:
                return -1
            for _ in range(count):
                row[dst:dst + bpc] = data[pos:pos + bpc]
                pos += bpc
                dst += step
        else:
            if (pos + 2 if bpc == 2 else pos) > last:
                return -1
            sample = data[pos:pos + bpc]
            for _ in range(count):
                row[dst:dst + bpc] = sample
                dst += step
            pos += bpc
        n -= 1
    return 0


def rle_plain(data: bytes, w: int, h: int, z: int,
              bpc: int) -> tuple[np.ndarray, int]:
    """Pillow's ``ImagingSgiRleDecode`` -> ((h, w * z * bpc) uint8 rows in
    stored order, bottom row first, interleaved samples; status): 0 (rows
    past a chain that had not ended stay zero), or a key of RLE_STATUS."""
    size = len(data) - HEADER
    rows = np.zeros((h, w * z * bpc), np.uint8)
    tablen = z * h
    if size < 8 * tablen:
        return rows, 1
    tables = np.frombuffer(data, ">u4", count=2 * tablen, offset=HEADER)
    start, length = tables[:tablen], tables[tablen:]
    row = bytearray(w * z * bpc)
    last = len(data) - 1
    for y in range(h):
        for ch in range(z):
            off = int(start[y + ch * h])
            n = int(length[y + ch * h])
            if off < HEADER:
                return rows, 2
            # Pillow passes the length on as a signed int (a negative one
            # decodes nothing) and checks it against nothing.
            n = n - (1 << 32) if n >= 1 << 31 else n
            status = _expand_row(data, off, n, row, ch, z, bpc, w, last)
            if status == -1:
                return rows, 2
            if status == 1:
                return rows, 0
        rows[y] = np.frombuffer(bytes(row), np.uint8)
    return rows, 0


def rle_decode(data: bytes, w: int, h: int, z: int, bpc: int,
               name: str) -> np.ndarray:
    """``rle_plain``'s rows, in C++ wherever the native library builds
    (``accel.native.sgi_rle_native``); a failure raises naming the image."""
    from wgpu_path_tracing_tpu_torch.accel import native

    if native.native_available():
        rows, status = native.sgi_rle_native(data, w, h, z, bpc)
    else:
        rows, status = rle_plain(data, w, h, z, bpc)
    if status:
        raise ValueError(f"{name}: {RLE_STATUS[status]}")
    return rows


def decode_sgi_rgba(data: bytes, name: str = "image") -> np.ndarray:
    """SGI bytes -> (H, W, 4) uint8 RGBA, what Pillow's
    ``Image.open(...).convert("RGBA")`` returns."""
    if len(data) < 12:
        raise NotThisFormat(f"{name}: not an SGI header")
    compression, bpc = data[2], data[3]
    dimension, w, h, z = struct.unpack_from(">4H", data, 4)
    mode = MODES.get((bpc, dimension, z))
    if mode is None:
        raise ValueError(f"{name}: unsupported SGI image mode (bytes a "
                         f"sample {bpc}, dimension {dimension}, channels "
                         f"{z}); Pillow refuses it")
    if w == 0 or h == 0:
        raise NotThisFormat(f"{name}: an SGI image of no pixels")
    bomb_check(w, h, name)
    if compression == 0:
        need = HEADER + w * h * z * bpc
        if len(data) < need:
            raise ValueError(f"{name}: the SGI data is truncated")
        planes = np.frombuffer(data, np.uint8, count=need - HEADER,
                               offset=HEADER).reshape(z, h, w, bpc)
        px = np.moveaxis(planes[..., 0], 0, -1)  # the high byte at 16 bits
    elif compression == 1:
        rows = rle_decode(data, w, h, z, bpc, name)
        px = rows.reshape(h, w, z, bpc)[..., 0]
    else:
        raise ValueError(f"{name}: SGI compression {compression} (Pillow: "
                         "cannot load this image)")
    px = px[::-1]
    out = np.full((h, w, 4), 255, np.uint8)
    if z == 1:
        out[..., :3] = px
    else:
        out[..., :z] = px
    return out
