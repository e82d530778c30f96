"""Blizzard Mipmap (BLP) decoding in NumPy, the pixels Pillow gives.

Pillow's ``BlpImagePlugin`` opens a BLP1 or BLP2 header and decodes the
first mipmap in Python at load; this module reads what it reads, to the
same bytes:

* the header: BLP1 (compression, alpha as a 32-bit flag, size, encoding,
  subtype) or BLP2 (compression, encoding, alpha flag and alpha encoding
  as signed bytes, mipmap flag, size); a nonzero alpha flag makes the
  image RGBA, else RGB. Then 16 mipmap offsets and 16 lengths, and the
  256-entry BGRA palette (BLP2 always, BLP1 for its palette encodings),
  each read whole or raising;
* BLP1 JPEG (compression 0): the shared header of its stated length
  after the tables, joined to the first mipmap's bytes (read from the
  mipmap's offset, or from the header's end where that lies later),
  decoded by ``utils/jpeg.py`` with a four-component frame taken as CMYK
  whatever its Adobe transform says (Pillow sets the JPEG mode "CMYK", so
  a YCCK frame goes unconverted); its RGB bytes are
  read back as raw "BGR", swapping red and blue, and as a stream of the
  BLP's size (the JPEG's own size may differ; too few bytes raise);
* palette images (BLP1 encodings 4 and 5 read on right after the palette,
  BLP2 encoding 1 from the first offset): each byte an index, the
  palette's own alpha where the image is RGBA;
* BLP2 DXT (encoding 2): DXT1, DXT3 and DXT5 (alpha encodings 0, 1 and
  7) through Pillow's Python decoders, not the C ``bcn`` one of
  ``utils/bcn.py``: 5:6:5 endpoints shifted into the top bits without
  widening; the thirds and halves rounded down; DXT1's 3-colour palette
  (with transparent black) where c0 <= c1, DXT3 and DXT5 always on 4
  colours; DXT1 emits alpha only when the alpha flag is set, DXT3 and
  DXT5 always. Every block row is decoded whole and the pixels joined
  into one stream, which Pillow reads back row by row at the image's own
  width and its mode's bytes a pixel: a width that is no multiple of 4
  comes out sheared, and a DXT3 or DXT5 image without the alpha flag is
  read three bytes at a time out of four;
* any other compression, encoding or alpha encoding raises ``ValueError``
  (Pillow's ``BLPFormatError``, a ``NotImplementedError``, which ends its
  search), as does data that ends early.

A header cut short and an image of no pixels are passed on to Pillow's
next formats (``NotThisFormat``). The DXT decoders run in C++
(``accel/cbvh/bcn_scan.cpp``, ``wpt_blp_dxt``) wherever
``accel.native.native_available()``; ``dxt_plain`` here is their plain
version, vectorised over the blocks.
"""

from __future__ import annotations

import struct

import numpy as np

from wgpu_path_tracing_tpu_torch.utils import bcn
from wgpu_path_tracing_tpu_torch.utils.sniff import NotThisFormat, bomb_check

DXT_KINDS = {0: 1, 1: 3, 7: 5}  # alpha encoding -> DXT kind
_PIX = np.arange(16)


def _shifted565(c: np.ndarray) -> np.ndarray:
    return np.stack([((c >> 11) & 0x1F) << 3, ((c >> 5) & 0x3F) << 2,
                     (c & 0x1F) << 3], -1)


def _colours(blocks: np.ndarray, dxt1: bool) -> np.ndarray:
    """(n, 8) colour blocks -> (n, 16, 4) RGBA as Pillow's BLP decoders
    make them."""
    b = blocks.astype(np.int64)
    c0 = b[:, 0] | b[:, 1] << 8
    c1 = b[:, 2] | b[:, 3] << 8
    lut = b[:, 4] | b[:, 5] << 8 | b[:, 6] << 16 | b[:, 7] << 24
    p0, p1 = _shifted565(c0), _shifted565(c1)
    four = (c0 > c1) | (not dxt1)
    pal = np.zeros((len(b), 4, 4), np.int64)
    pal[:, 0, :3], pal[:, 1, :3] = p0, p1
    pal[:, :3, 3] = 255
    pal[:, 2, :3] = np.where(four[:, None], (2 * p0 + p1) // 3,
                             (p0 + p1) // 2)
    pal[:, 3, :3] = np.where(four[:, None], (2 * p1 + p0) // 3, 0)
    pal[:, 3, 3] = np.where(four, 255, 0)
    idx = (lut[:, None] >> (2 * _PIX)) & 3
    return np.take_along_axis(pal, idx[..., None], 1).astype(np.uint8)


def dxt_plain(data: bytes, pos: int, kind: int, alpha: bool, bw: int,
              bh: int) -> np.ndarray:
    """Pillow's ``decode_dxt1/3/5`` of ``bw`` x ``bh`` blocks from ``pos``
    -> (4 bh, 4 bw, 3 or 4) pixels, every block whole."""
    size = 8 if kind == 1 else 16
    blocks = np.frombuffer(data, np.uint8, count=bw * bh * size,
                           offset=pos).reshape(-1, size)
    if kind == 1:
        px = _colours(blocks, True)
    else:
        px = _colours(blocks[:, 8:], False)
        if kind == 3:
            px[..., 3] = np.stack([blocks[:, :8] & 15, blocks[:, :8] >> 4],
                                  -1).reshape(-1, 16) * 17
        else:
            px[..., 3] = bcn.alpha_ramp(blocks[:, :8])
    bpp = 3 if kind == 1 and not alpha else 4
    return px[..., :bpp].reshape(bh, bw, 4, 4, bpp).transpose(
        0, 2, 1, 3, 4).reshape(4 * bh, 4 * bw, bpp)


def _read(data: bytes, pos: int, count: int, name: str) -> bytes:
    """``ImageFile._safe_read``: ``count`` bytes or raise."""
    if count <= 0:
        return b""
    if pos + count > len(data):
        raise ValueError(f"{name}: truncated BLP file (a read of {count} "
                         f"bytes at {pos} runs past the data)")
    return data[pos:pos + count]


def _palette(data: bytes, pos: int, name: str) -> np.ndarray:
    """The 256 BGRA entries at ``pos`` as (256, 4) RGBA."""
    bgra = np.frombuffer(_read(data, pos, 1024, name), np.uint8)
    return bgra.reshape(256, 4)[:, [2, 1, 0, 3]]


def _stream(px: np.ndarray, w: int, h: int, ch: int, name: str
            ) -> np.ndarray:
    """``set_as_raw``: the first h x w x ch bytes of a pixel stream."""
    flat = px.reshape(-1)
    if len(flat) < w * h * ch:
        raise ValueError(f"{name}: the BLP mipmap decodes to {len(flat)} "
                         f"bytes, {w * h * ch} wanted (Pillow: not enough "
                         "image data)")
    return flat[:w * h * ch].reshape(h, w, ch)


def _jpeg(data: bytes, tables: tuple, w: int, h: int, name: str
          ) -> np.ndarray:
    """BLP1 JPEG: the (h, w, 3) RGB of Pillow's raw "BGR" read-back."""
    from wgpu_path_tracing_tpu_torch.utils.jpeg import decode_jpeg_rgba

    offsets, lengths = tables
    (header_size,) = struct.unpack("<I", _read(data, 156, 4, name))
    header = _read(data, 160, header_size, name)
    pos = 160 + max(header_size, 0)
    _read(data, pos, offsets[0] - pos, name)
    pos = max(pos, offsets[0])
    body = _read(data, pos, lengths[0], name)
    try:
        rgba = decode_jpeg_rgba(header + body, name, as_cmyk=True)
    except NotThisFormat as exc:
        raise ValueError(str(exc)) from None
    return _stream(rgba[..., :3], w, h, 3, name)[..., ::-1]


def decode_blp_rgba(data: bytes, name: str = "image") -> np.ndarray:
    """BLP bytes -> (H, W, 4) uint8 RGBA, what Pillow's
    ``Image.open(...).convert("RGBA")`` returns."""
    from wgpu_path_tracing_tpu_torch.accel import native

    blp1 = data.startswith(b"BLP1")
    if len(data) < (24 if blp1 else 20) or not data.startswith(
            (b"BLP1", b"BLP2")):
        raise NotThisFormat(f"{name}: the BLP header is cut short")
    (compression,) = struct.unpack_from("<i", data, 4)
    if blp1:
        alpha = struct.unpack_from("<I", data, 8)[0] != 0
        w, h, encoding = struct.unpack_from("<IIi", data, 12)
        start = 28
    else:
        encoding, flag, alpha_encoding = struct.unpack_from("<3b", data, 8)
        alpha = flag != 0
        w, h = struct.unpack_from("<II", data, 12)
        start = 20
    if w == 0 or h == 0:
        raise NotThisFormat(f"{name}: a BLP image of no pixels")
    bomb_check(w, h, name)
    ch = 4 if alpha else 3
    tables = (struct.unpack("<16I", _read(data, start, 64, name)),
              struct.unpack("<16I", _read(data, start + 64, 64, name)))
    offsets, lengths = tables
    out = np.full((h, w, 4), 255, np.uint8)
    if blp1:
        if compression == 0:
            out[..., :3] = _jpeg(data, tables, w, h, name)
            return out
        if compression != 1:
            raise ValueError(f"{name}: unsupported BLP compression "
                             f"{compression} (Pillow's BLPFormatError)")
        if encoding not in (4, 5):
            raise ValueError(f"{name}: unsupported BLP encoding {encoding} "
                             "(Pillow's BLPFormatError)")
        palette = _palette(data, 156, name)
        index = np.frombuffer(_read(data, 1180, lengths[0], name), np.uint8)
    else:
        palette = _palette(data, 148, name)
        if compression != 1:
            raise ValueError(f"{name}: unknown BLP compression {compression} "
                             "(Pillow's BLPFormatError)")
        if encoding == 1:
            index = np.frombuffer(_read(data, offsets[0], lengths[0], name),
                                  np.uint8)
        elif encoding == 2:
            kind = DXT_KINDS.get(alpha_encoding)
            if kind is None:
                raise ValueError(f"{name}: unsupported BLP alpha encoding "
                                 f"{alpha_encoding} (Pillow's "
                                 "BLPFormatError)")
            bw, bh = (w + 3) // 4, (h + 3) // 4
            _read(data, offsets[0], bw * bh * (8 if kind == 1 else 16), name)
            dxt = native.blp_dxt_native if native.native_available() \
                else dxt_plain
            px = dxt(data, offsets[0], kind, alpha, bw, bh)
            out[..., :ch] = _stream(px, w, h, ch, name)
            return out
        else:
            raise ValueError(f"{name}: unknown BLP encoding {encoding} "
                             "(Pillow's BLPFormatError)")
    out[..., :ch] = _stream(palette[index][:, :ch], w, h, ch, name)
    return out
