"""Photoshop (PSD) decoding in NumPy, the pixels Pillow gives.

Pillow's ``PsdImagePlugin`` opens a PSD file as its merged image (the
"image data" section at the file's end), not its layers; this module
reads what it reads, to the same bytes:

* the modes of ``PsdImagePlugin.MODES`` at 8 bits (and bitmap at 1):
  bitmap (a set bit is white, the reverse of Photoshop's convention),
  gray, duotone and multichannel as gray, indexed, RGB, CMYK and Lab;
  16- and 32-bit files are Pillow's ``KeyError`` and raise;
* RGB with exactly four channels is RGBA; with five or more it stays RGB;
  a mode with fewer channels than it needs raises;
* an indexed image's palette is the colour-mode data when it is 768 bytes
  long, 256 reds, then greens, then blues; without it Pillow's image has
  a black palette;
* CMYK planes are stored inverted and go through Pillow's ``cmyk2rgb``;
  Lab (a* and b* stored with 128 added) goes through Pillow's LittleCMS
  transform (``utils/lab.py``), whose alpha is the fourth byte of
  Pillow's "LAB" pixels, which the planes leave 0: a Lab PSD converts to
  alpha 0 everywhere;
* raw data (compression 0) holds each channel's plane after the last;
  PackBits data (compression 1) starts with a 16-bit byte count for each
  row of each channel, which places the channels; each channel is then
  decoded as one stream of packets from its start, a packet that runs
  past the end of a row dropping its rest (Pillow's ``PackDecode.c``),
  and data that ends before the last row raises; ZIP data (2 and 3) gives
  Pillow nothing to read, and raises.

A header, section length or byte-count table cut short is passed on to
Pillow's next formats (``NotThisFormat``), as Pillow's ``_open`` passes it.

The PackBits loop is ``packbits_rows_plain`` here, the plain version of
``accel/cbvh/image_scan.cpp``'s ``wpt_packbits_rows``, which the native
library runs wherever ``accel.native.native_available()``. (libtiff's
PackBits, ``wpt_packbits``, carries a run on across rows and is another
decode.)
"""

from __future__ import annotations

import struct

import numpy as np

from wgpu_path_tracing_tpu_torch.utils.sniff import NotThisFormat, bomb_check

# (colour mode, bits) -> (Pillow's mode, channels it needs).
MODES = {(0, 1): ("1", 1), (0, 8): ("L", 1), (1, 8): ("L", 1),
         (2, 8): ("P", 1), (3, 8): ("RGB", 3), (4, 8): ("CMYK", 4),
         (7, 8): ("L", 1), (8, 8): ("L", 1), (9, 8): ("LAB", 3)}


def packbits_rows_plain(data: bytes, pos: int, row_bytes: int,
                        rows: int) -> tuple[np.ndarray, int]:
    """Pillow's PackBits decoder from ``pos`` -> ((rows, row_bytes) uint8,
    status): 0, or 1 where the data ends before the last row. A packet
    that runs past the end of a row writes up to it and drops the rest."""
    out = bytearray(rows * row_bytes)
    total = rows * row_bytes
    at = 0
    x = 0
    end = len(data)
    while at < total:
        if pos >= end:
            return np.frombuffer(bytes(out), np.uint8).reshape(rows, -1), 1
        b = data[pos]
        if b == 0x80:
            pos += 1
            continue
        if b & 0x80:
            if pos + 2 > end:
                return np.frombuffer(bytes(out), np.uint8).reshape(rows, -1), 1
            n = min(257 - b, row_bytes - x)
            out[at:at + n] = bytes([data[pos + 1]]) * n
            pos += 2
        else:
            if pos + b + 2 > end:
                return np.frombuffer(bytes(out), np.uint8).reshape(rows, -1), 1
            n = min(b + 1, row_bytes - x)
            out[at:at + n] = data[pos + 1:pos + 1 + n]
            pos += b + 2
        at += n
        x += n
        if x == row_bytes:
            x = 0
    return np.frombuffer(bytes(out), np.uint8).reshape(rows, -1), 0


def packbits_rows(data: bytes, pos: int, row_bytes: int, rows: int,
                  name: str) -> np.ndarray:
    """``packbits_rows_plain``'s rows, in C++ wherever the native library
    builds (``accel.native.packbits_rows_native``); data that ends early
    raises naming the image."""
    from wgpu_path_tracing_tpu_torch.accel import native

    if native.native_available():
        out, status = native.packbits_rows_native(data, pos, row_bytes, rows)
    else:
        out, status = packbits_rows_plain(data, pos, row_bytes, rows)
    if status:
        raise ValueError(f"{name}: the PackBits data is truncated")
    return out


class _Reader:
    """A file position as Python's ``read`` and ``seek`` move it: a read
    returns what is left up to the end, a seek may pass it."""

    def __init__(self, data: bytes, pos: int):
        self.data, self.pos = data, pos

    def read(self, n: int) -> bytes:
        out = self.data[self.pos:self.pos + n] if self.pos <= len(
            self.data) else b""
        self.pos += len(out)
        return out

    def u32(self, name: str) -> int:
        s = self.read(4)
        if len(s) < 4:
            raise NotThisFormat(f"{name}: a PSD section length is cut short")
        return struct.unpack(">I", s)[0]


def _skip_resources(f: _Reader, size: int, name: str) -> None:
    """The image resource blocks, walked as Pillow walks them."""
    end = f.pos + size
    while f.pos < end:
        f.read(4)
        if len(f.read(2)) < 2:
            raise NotThisFormat(f"{name}: a PSD resource is cut short")
        n = f.read(1)
        if not n:
            raise NotThisFormat(f"{name}: a PSD resource is cut short")
        label = f.read(n[0])
        if not len(label) & 1:
            f.read(1)
        block = f.read(f.u32(name))
        if len(block) & 1:
            f.read(1)


def _palette(color_data: bytes | None) -> np.ndarray:
    """(256, 3) uint8: the planar 768-byte colour-mode data, or, without
    it, the black palette Pillow's loaded "P" image then has."""
    if color_data is None:
        return np.zeros((256, 3), np.uint8)
    return np.frombuffer(color_data, np.uint8).reshape(3, 256).T


def decode_psd_rgba(data: bytes, name: str = "image") -> np.ndarray:
    """PSD bytes -> the merged image's (H, W, 4) uint8 RGBA, what Pillow's
    ``Image.open(...).convert("RGBA")`` returns."""
    from wgpu_path_tracing_tpu_torch.utils.jpeg import pillow_cmyk_to_rgb
    from wgpu_path_tracing_tpu_torch.utils.lab import lab_to_rgb

    if len(data) < 26 or not data.startswith(b"8BPS") or \
            struct.unpack_from(">H", data, 4)[0] != 1:
        raise NotThisFormat(f"{name}: not a PSD header")
    psd_channels, h, w, bits, psd_mode = struct.unpack_from(">HIIHH", data, 12)
    if (psd_mode, bits) not in MODES:
        raise ValueError(f"{name}: a PSD file of colour mode {psd_mode} at "
                         f"{bits} bits; Pillow refuses it")
    mode, channels = MODES[(psd_mode, bits)]
    if channels > psd_channels:
        raise ValueError(f"{name}: a {mode} PSD file of {psd_channels} "
                         "channels (Pillow: not enough channels)")
    if mode == "RGB" and psd_channels == 4:
        mode, channels = "RGBA", 4
    f = _Reader(data, 26)
    size = f.u32(name)
    color_data = f.read(size) if size else b""
    color_data = color_data if mode == "P" and size == 768 else None
    size = f.u32(name)
    if size:
        _skip_resources(f, size, name)
    size = f.u32(name)
    if size:
        end = f.pos + size
        f.u32(name)
        f.pos = end
    head = f.read(2)
    if len(head) < 2:
        raise NotThisFormat(f"{name}: the PSD image data is cut short")
    (compression,) = struct.unpack(">H", head)
    row_bytes = (w + 7) // 8 if mode == "1" else w
    if compression == 1:
        counts = f.read(2 * channels * h)
        if len(counts) < 2 * channels * h:
            raise NotThisFormat(f"{name}: the PSD byte counts are cut short")
        counts = np.frombuffer(counts, ">u2").astype(np.int64)
        starts = f.pos + np.concatenate(
            [[0], np.cumsum(counts.reshape(channels, h).sum(1))])[:channels]
    if w == 0 or h == 0:
        raise NotThisFormat(f"{name}: a PSD image of no pixels")
    bomb_check(w, h, name)
    planes = []
    for c in range(channels):
        if compression == 0:
            at = f.pos + c * w * h
            if at + row_bytes * h > len(data):
                raise ValueError(f"{name}: the PSD image data is truncated")
            planes.append(np.frombuffer(data, np.uint8, count=row_bytes * h,
                                        offset=at).reshape(h, row_bytes))
        elif compression == 1:
            planes.append(packbits_rows(data, int(starts[c]), row_bytes, h,
                                        name))
        else:
            raise ValueError(f"{name}: PSD compression {compression} (Pillow: "
                             "cannot load this image)")
    out = np.full((h, w, 4), 255, np.uint8)
    if mode == "1":
        out[..., :3] = (np.unpackbits(planes[0], axis=1)[:, :w] * 255)[
            ..., None]
    elif mode == "L":
        out[..., :3] = planes[0][..., None]
    elif mode == "P":
        out[..., :3] = _palette(color_data)[planes[0]]
    elif mode in ("RGB", "RGBA"):
        out[..., :channels] = np.stack(planes, -1)
    elif mode == "CMYK":
        out[..., :3] = pillow_cmyk_to_rgb(255 - np.stack(planes, -1))
    else:  # Lab: a* and b* stored unsigned, Pillow's "LAB" holds them signed
        out[..., :3] = lab_to_rgb(np.stack(planes, -1) ^ np.array(
            [0, 128, 128], np.uint8))
        out[..., 3] = 0  # the fourth byte of Pillow's pixels, never set
    return out
