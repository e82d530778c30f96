"""DirectDraw Surface (DDS) decoding, the pixels Pillow gives.

Pillow's ``DdsImagePlugin`` reads the 128-byte header (and the 20-byte DX10
header after it) and the first surface; this module reads what it reads,
to the same bytes:

* uncompressed RGB(A) through the header's bit masks (Pillow's
  ``DdsRgbDecoder``): each pixel's ``bitcount // 8`` bytes as a
  little-endian value, each channel ``(v & mask) >> (trailing zeros of
  mask)`` scaled to 8 bits as ``int(v / (mask >> zeros) * 255)`` in double
  precision, a zero mask giving 0; data that ends early reads as zeros;
* 8-bit luminance, 16-bit luminance with alpha, 8-bit palette indices into
  the 1,024-byte RGBA palette after the header, and DX10 R8G8B8A8
  (typeless, unorm or sRGB, the bytes as they are);
* the block-compressed formats of ``utils/bcn.py``: DXT1 (BC1), DXT3
  (BC2), DXT5 (BC3), ATI1/BC4U and DX10 BC4 (gray), ATI2/BC5U, BC5S and
  DX10 BC5 unorm/typeless/snorm (RGB), DX10 BC6H unsigned and signed
  (RGB), DX10 BC7 typeless/unorm/sRGB;
* Pillow's ``load_seek`` does nothing, so the pixel data starts where the
  headers (and the palette) end, whatever else the header says; data that
  ends before the last pixel or block raises (except through masks).

A header size other than 124 or a header cut short raises ``ValueError``
naming the image, as does a pixel format Pillow does not implement (its
``OSError`` and ``NotImplementedError`` end its search); a file too short
for the header size or the DX10 format is passed on to Pillow's next
formats (``NotThisFormat``), as is an image of no pixels.

The block decoders run in C++ (``accel/cbvh/bcn_scan.cpp``, ``wpt_bcn``)
wherever ``accel.native.native_available()``, else in NumPy
(``bcn.decode_plain``).
"""

from __future__ import annotations

import struct

import numpy as np

from wgpu_path_tracing_tpu_torch.utils import bcn
from wgpu_path_tracing_tpu_torch.utils.sniff import NotThisFormat, bomb_check

DDPF_ALPHAPIXELS, DDPF_FOURCC, DDPF_PALETTEINDEXED8 = 0x1, 0x4, 0x20
DDPF_RGB, DDPF_LUMINANCE = 0x40, 0x20000
FOURCC = {b"DXT1": "BC1", b"DXT3": "BC2", b"DXT5": "BC3", b"BC4U": "BC4",
          b"ATI1": "BC4", b"BC5S": "BC5S", b"BC5U": "BC5", b"ATI2": "BC5"}
# DXGI formats Pillow reads -> a block format, or "RGBA" for raw bytes.
DXGI = {70: "BC1", 71: "BC1", 73: "BC2", 74: "BC2", 76: "BC3", 77: "BC3",
        79: "BC4", 80: "BC4", 82: "BC5", 83: "BC5", 84: "BC5S", 95: "BC6H",
        96: "BC6HS", 97: "BC7", 98: "BC7", 99: "BC7", 27: "RGBA", 28: "RGBA",
        29: "RGBA"}


def _mask_channels(data: bytes, pos: int, w: int, h: int, bitcount: int,
                   masks: tuple) -> np.ndarray:
    """Pillow's ``DdsRgbDecoder``: (h, w, len(masks)) uint8."""
    n = w * h
    size = bitcount // 8
    value = np.zeros(n, np.int64)
    starts = pos + np.arange(n, dtype=np.int64) * size
    buf = np.frombuffer(data, np.uint8)
    for k in range(min(size, 4)):  # the masks see the low 32 bits only
        at = starts + k
        byte = np.where(at < len(buf), buf[np.minimum(at, len(buf) - 1)], 0)
        value |= byte.astype(np.int64) << (8 * k)
    out = np.zeros((n, len(masks)), np.uint8)
    for i, mask in enumerate(masks):
        if not mask:
            continue
        shift = (mask & -mask).bit_length() - 1
        total = mask >> shift
        out[:, i] = ((value & mask) >> shift) / total * 255
    return out.reshape(h, w, -1)


def _raw(data: bytes, pos: int, count: int, name: str) -> np.ndarray:
    if pos + count > len(data):
        raise ValueError(f"{name}: image file is truncated")
    return np.frombuffer(data, np.uint8, count=count, offset=pos)


def decode_blocks(data: bytes, pos: int, fmt: str, w: int, h: int,
                  name: str) -> np.ndarray:
    """The (h, w, channels) pixels of ``fmt``'s blocks from ``pos``, in
    C++ wherever the native library builds; data that ends before the last
    block raises naming the image."""
    from wgpu_path_tracing_tpu_torch.accel import native

    size = bcn.DECODERS[fmt][0]
    if pos + ((w + 3) // 4) * ((h + 3) // 4) * size > len(data):
        raise ValueError(f"{name}: image file is truncated (the {fmt} "
                         "blocks end early)")
    if native.native_available():
        return native.bcn_native(data, pos, fmt, w, h)
    return bcn.decode_plain(data, pos, fmt, w, h)


def decode_dds_rgba(data: bytes, name: str = "image") -> np.ndarray:
    """DDS bytes -> (H, W, 4) uint8 RGBA, what Pillow's
    ``Image.open(...).convert("RGBA")`` returns."""
    if len(data) < 8 or not data.startswith(b"DDS "):
        raise NotThisFormat(f"{name}: not a DDS header")
    (header_size,) = struct.unpack_from("<I", data, 4)
    if header_size != 124:
        raise ValueError(f"{name}: unsupported DDS header size "
                         f"{header_size} (Pillow refuses it)")
    if len(data) < 128:
        raise ValueError(f"{name}: incomplete DDS header "
                         f"({len(data) - 8} bytes)")
    h, w = struct.unpack_from("<II", data, 12)
    pfflags, fourcc, bitcount = struct.unpack_from("<I4sI", data, 80)
    pos = 128
    fmt = palette = masks = None
    if pfflags & DDPF_RGB:
        count = 4 if pfflags & DDPF_ALPHAPIXELS else 3
        masks = struct.unpack_from(f"<{count}I", data, 92)
    elif pfflags & DDPF_LUMINANCE:
        if bitcount == 8:
            fmt = "L"
        elif bitcount == 16 and pfflags & DDPF_ALPHAPIXELS:
            fmt = "LA"
        else:
            raise ValueError(f"{name}: unsupported DDS luminance bit count "
                             f"{bitcount}")
    elif pfflags & DDPF_PALETTEINDEXED8:
        fmt = "P"
        palette = data[pos:pos + 1024]
        pos += len(palette)
    elif pfflags & DDPF_FOURCC:
        if fourcc == b"DX10":
            if len(data) < 132:
                raise NotThisFormat(f"{name}: the DX10 header is cut short")
            (dxgi,) = struct.unpack_from("<I", data, 128)
            pos = min(148, len(data))
            fmt = DXGI.get(dxgi)
            if fmt is None:
                raise ValueError(f"{name}: DXGI format {dxgi}, which Pillow "
                                 "does not implement")
        else:
            fmt = FOURCC.get(fourcc)
            if fmt is None:
                raise ValueError(f"{name}: DDS pixel format {fourcc!r}, "
                                 "which Pillow does not implement")
    else:
        raise ValueError(f"{name}: unknown DDS pixel format flags {pfflags}, "
                         "which Pillow does not implement")
    if w == 0 or h == 0:
        raise NotThisFormat(f"{name}: a DDS image of no pixels")
    bomb_check(w, h, name)
    out = np.full((h, w, 4), 255, np.uint8)
    if masks is not None:
        out[..., :len(masks)] = _mask_channels(data, pos, w, h, bitcount,
                                               masks)
    elif fmt == "L":
        out[..., :3] = _raw(data, pos, w * h, name).reshape(h, w, 1)
    elif fmt == "LA":
        px = _raw(data, pos, 2 * w * h, name).reshape(h, w, 2)
        out[..., :3] = px[..., :1]
        out[..., 3] = px[..., 1]
    elif fmt == "P":
        table = np.zeros((256, 4), np.uint8)
        table[:, 3] = 255
        entries = np.frombuffer(palette[:len(palette) // 4 * 4], np.uint8)
        table[:len(entries) // 4] = entries.reshape(-1, 4)
        out = table[_raw(data, pos, w * h, name).reshape(h, w)]
    elif fmt == "RGBA":
        out = _raw(data, pos, 4 * w * h, name).reshape(h, w, 4).copy()
    else:
        px = decode_blocks(data, pos, fmt, w, h, name)
        if px.shape[-1] == 1:
            out[..., :3] = px
        else:
            out[..., :px.shape[-1]] = px
    return out
