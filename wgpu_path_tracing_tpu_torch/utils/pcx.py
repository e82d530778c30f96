"""PCX and DCX decoding in NumPy, the pixels Pillow gives.

Pillow's ``PcxImagePlugin`` reads the 128-byte header and decodes the
run-length data from byte 128 with its C ``pcx`` decoder; this module
reads what it reads, to the same bytes:

* 1 bit on one plane (mode "1": a set bit is white); 1 bit on 2 or 4
  planes as a palette image of 4 or 16 colours, each row's planes one
  after another (``P;2L``/``P;4L``), looked up in the header's 16-entry
  palette; 8 bits on one plane of a version-5 file, gray unless the file
  ends in a 769-byte trailer (``0x0C`` and 768 bytes) that is not the
  linear gray ramp, which makes it a palette image; 8 bits on three planes
  as RGB, each row's planes one after another (``RGB;L``);
* each row holds ``planes * stride`` bytes, with ``stride = ceil(w * bits
  / 8)`` rounded up to even only where the header's own differs (Pillow's
  fix of CVE-2020-35653); where the planes lie further apart than its
  unpackers read them (``ceil(w / 8)`` bytes on bit planes, ``w`` bytes
  on byte planes), Pillow's decoder moves each plane after the first
  down before it unpacks the row, as done here;
* the run-length data: a byte with its two top bits set repeats the next
  byte ``b & 0x3F`` times, any other byte is itself; a run that crosses the
  end of a row, or data that ends before the last row, raises; what follows
  the last row is ignored.

A header whose box is empty or that is cut short is passed on to Pillow's
next formats (``NotThisFormat``); other bit and plane counts are Pillow's
"unknown PCX mode", an error that ends its search, and raise
``ValueError`` naming the image, as does a version-5 8-bit gray file
shorter than the 769-byte trailer when it is read from a path (Pillow
seeks before the file's start there; from bytes it reads the file as
gray, and so does this module).

DCX is a directory of PCX pages: Pillow opens its first page.

The run-length loop is ``rle_plain`` here, the plain version of
``accel/cbvh/image_scan.cpp``'s ``wpt_pcx_rle``, which the native library
runs wherever ``accel.native.native_available()``.
"""

from __future__ import annotations

import struct

import numpy as np

from wgpu_path_tracing_tpu_torch.utils.sniff import NotThisFormat, bomb_check

RLE_STATUS = {1: "the run-length data is truncated",
              2: "a run crosses the end of a row (buffer overrun)"}
DCX_MAGIC = 0x3ADE68B1


def rle_plain(data: bytes, pos: int, row_bytes: int,
              rows: int) -> tuple[np.ndarray, int]:
    """PCX run-length data from ``pos`` -> ((rows, row_bytes) uint8,
    status): 0, or a key of RLE_STATUS."""
    out = bytearray(rows * row_bytes)
    total = rows * row_bytes
    at = 0
    x = 0
    end = len(data)
    while at < total:
        if pos >= end:
            return np.frombuffer(bytes(out), np.uint8).reshape(rows, -1), 1
        b = data[pos]
        if b & 0xC0 == 0xC0:
            if pos + 1 >= end:
                return np.frombuffer(bytes(out), np.uint8).reshape(rows, -1), 1
            n = b & 0x3F
            if x + n > row_bytes:
                return np.frombuffer(bytes(out), np.uint8).reshape(rows, -1), 2
            out[at:at + n] = bytes([data[pos + 1]]) * n
            at += n
            x += n
            pos += 2
        else:
            out[at] = b
            at += 1
            x += 1
            pos += 1
        if x == row_bytes:
            x = 0
    return np.frombuffer(bytes(out), np.uint8).reshape(rows, -1), 0


def rle_decode(data: bytes, pos: int, row_bytes: int, rows: int,
               name: str) -> np.ndarray:
    """``rle_plain``'s rows, in C++ wherever the native library builds
    (``accel.native.pcx_rle_native``); a failure raises naming the image."""
    from wgpu_path_tracing_tpu_torch.accel import native

    if native.native_available():
        out, status = native.pcx_rle_native(data, pos, row_bytes, rows)
    else:
        out, status = rle_plain(data, pos, row_bytes, rows)
    if status:
        raise ValueError(f"{name}: {RLE_STATUS[status]}")
    return out


def _planes_apart(rows: np.ndarray, w: int, planes: int,
                  bits: int) -> np.ndarray:
    """Pillow's move of each plane after the first to its unpacker's
    distance: ``ceil(w / 8)`` bytes on 2 and 4 bit planes, else ``w``
    bytes where a row holds ``n // w`` planes ``n // (n // w)`` apart."""
    n = rows.shape[1]
    if bits == 1 and planes in (2, 4):
        size, bands, stride = (w + 7) // 8, planes, n // planes
    else:
        size, bands = w, n // w
        stride = n // bands if bands else 0
    if stride <= size:
        return rows
    rows = rows.copy()
    for i in range(1, bands):
        rows[:, i * size:(i + 1) * size] = rows[:, i * stride:i * stride + size]
    return rows


def _bit_planes(rows: np.ndarray, w: int, planes: int) -> np.ndarray:
    """``P;2L``/``P;4L``: plane k's bit of each pixel, planes
    ``ceil(w / 8)`` bytes apart from the row's start, weighted 2^k."""
    s = (w + 7) // 8
    idx = np.zeros((rows.shape[0], w), np.uint8)
    for k in range(planes):
        bits = np.unpackbits(rows[:, k * s:(k + 1) * s], axis=1)[:, :w]
        idx |= bits << k
    return idx


def _page(data: bytes, at: int, name: str) -> np.ndarray:
    """The PCX image whose header starts at ``at`` (0, or a DCX page)."""
    s = data[at:at + 68]
    if len(s) < 68 or s[0] != 10 or s[1] not in (0, 2, 3, 5):
        raise NotThisFormat(f"{name}: not a PCX header")
    x0, y0, x1, y1 = struct.unpack_from("<4H", s, 4)
    if x1 + 1 <= x0 or y1 + 1 <= y0:
        raise NotThisFormat(f"{name}: bad PCX image size")
    version, bits, planes = s[1], s[3], s[65]
    (provided,) = struct.unpack_from("<H", s, 66)
    w, h = x1 + 1 - x0, y1 + 1 - y0
    palette = None
    if bits == 1 and planes == 1:
        mode = "1"
    elif bits == 1 and planes in (2, 4):
        mode = "P;L"
        palette = np.frombuffer(s[16:64], np.uint8).reshape(16, 3)
    elif version == 5 and bits == 8 and planes == 1:
        mode = "L"
        trailer = data[max(len(data) - 769, 0):]
        if len(trailer) == 769 and trailer[0] == 12:
            pal = np.frombuffer(trailer[1:], np.uint8).reshape(256, 3)
            if not (pal == np.arange(256, dtype=np.uint8)[:, None]).all():
                mode, palette = "P", pal
    elif version == 5 and bits == 8 and planes == 3:
        mode = "RGB"
    else:
        raise ValueError(f"{name}: unknown PCX mode ({bits} bits on "
                         f"{planes} planes, version {version}); Pillow "
                         "refuses it")
    bomb_check(w, h, name)
    stride = (w * bits + 7) // 8
    if provided != stride:
        stride += stride % 2
    rows = _planes_apart(rle_decode(data, at + 128, planes * stride, h, name),
                         w, planes, bits)
    out = np.full((h, w, 4), 255, np.uint8)
    if mode == "1":
        out[..., :3] = (np.unpackbits(rows[:, :(w + 7) // 8], axis=1)[:, :w]
                        * 255)[..., None]
    elif mode == "P;L":
        table = np.zeros((256, 3), np.uint8)
        table[:16] = palette
        out[..., :3] = table[_bit_planes(rows, w, planes)]
    elif mode == "L":
        out[..., :3] = rows[:, :w, None]
    elif mode == "P":
        out[..., :3] = palette[rows[:, :w]]
    else:
        out[..., :3] = np.stack([rows[:, :w], rows[:, w:2 * w],
                                 rows[:, 2 * w:3 * w]], -1)
    return out


def decode_pcx_rgba(data: bytes, name: str = "image") -> np.ndarray:
    """PCX bytes -> (H, W, 4) uint8 RGBA, what Pillow's
    ``Image.open(...).convert("RGBA")`` returns."""
    return _page(data, 0, name)


def decode_dcx_rgba(data: bytes, name: str = "image") -> np.ndarray:
    """DCX bytes -> the first page's (H, W, 4) uint8 RGBA, as Pillow opens
    it: the directory of page offsets read up to its first 0 (a directory
    cut short is passed on), an empty one an error."""
    if len(data) < 8 or struct.unpack_from("<I", data)[0] != DCX_MAGIC:
        raise NotThisFormat(f"{name}: not a DCX header")
    offsets = []
    for i in range(1024):
        if len(data) < 8 + 4 * i:
            raise NotThisFormat(f"{name}: the DCX directory is cut short")
        (offset,) = struct.unpack_from("<I", data, 4 + 4 * i)
        if not offset:
            break
        offsets.append(offset)
    if not offsets:
        raise ValueError(f"{name}: a DCX file without pages (Pillow: "
                         "attempt to seek outside sequence)")
    return _page(data, offsets[0], name)
