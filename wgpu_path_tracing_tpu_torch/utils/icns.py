"""Apple icon (ICNS) decoding in NumPy, the pixels Pillow gives.

Pillow's ``IcnsImagePlugin`` reads the directory of typed blocks and
loads the largest icon; this module reads what it reads, to the same
bytes:

* the blocks from byte 8 while their offsets stay below the header's file
  size, each an 8-byte header (type, size with the header) and its data; a
  later block of a type replaces an earlier one. A block size of 0, or a
  directory that runs past the data, is passed on to the next format;
* the icon is the largest of the sizes any of whose types is present
  (``SIZES``, compared as (width, height, scale) tuples, so (512, 512, 1)
  beats (256, 256, 2)); with none, the bytes are passed on;
* every present type of that size is read, in ``SIZES`` order: a PNG
  entry (through ``decode_png_rgba``, from the entry to the file's end);
  ``it32`` (after a 4-byte zero signature), ``ih32``, ``il32`` and
  ``is32`` as raw RGB where the entry is exactly 3 bytes a pixel, else as
  three run-length channels one after another (a byte b >= 0x80 repeats
  the next byte b - 125 times, a byte b < 0x80 copies the next b + 1),
  read on past the entry's end, a channel whose counts do not end on its
  size or whose data runs out raising; the ``t8mk``, ``h8mk``, ``l8mk``
  and ``s8mk`` masks, one byte a pixel, as its alpha;
* a PNG entry wins over the RGB ones. Pillow takes its pixels but not its
  ``info``, so its ``tRNS`` chunk is not applied, and Pillow's ``size``
  setter then refuses a PNG whose size is no whole fraction of a present
  size (it checks ``w // pw`` against ``h / ph``). Without a PNG entry
  the RGB entry is needed (a lone mask raises); without a mask alpha is
  255;
* a JPEG 2000 entry (a J2K codestream or a JP2 file, the entry's own
  bytes) is read by ``utils/jpeg2000.py`` as ``Jpeg2KImageFile`` opens
  it outside ``Image.open`` (an error in its header raises rather than
  passing the bytes on), converted to RGBA and held to the same size
  check as a PNG entry; another entry format raises ``ValueError``.

The run-length loop is ``rle_plain`` here, the plain version of
``accel/cbvh/image_scan.cpp``'s ``wpt_icns_rle``, which the native library
runs wherever ``accel.native.native_available()``.
"""

from __future__ import annotations

import struct

import numpy as np

from wgpu_path_tracing_tpu_torch.utils.sniff import NotThisFormat, bomb_check

# (width, height, scale) -> the entry types of that size and their kind,
# in IcnsFile.SIZES's order.
SIZES = {
    (512, 512, 2): ((b"ic10", "png"),),
    (512, 512, 1): ((b"ic09", "png"),),
    (256, 256, 2): ((b"ic14", "png"),),
    (256, 256, 1): ((b"ic08", "png"),),
    (128, 128, 2): ((b"ic13", "png"),),
    (128, 128, 1): ((b"ic07", "png"), (b"it32", "32t"), (b"t8mk", "mask")),
    (64, 64, 1): ((b"icp6", "png"),),
    (32, 32, 2): ((b"ic12", "png"),),
    (48, 48, 1): ((b"ih32", "32"), (b"h8mk", "mask")),
    (32, 32, 1): ((b"icp5", "png"), (b"il32", "32"), (b"l8mk", "mask")),
    (16, 16, 2): ((b"ic11", "png"),),
    (16, 16, 1): ((b"icp4", "png"), (b"is32", "32"), (b"s8mk", "mask")),
}
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
JP2_SIGNATURES = (b"\xff\x4f\xff\x51", b"\x0d\x0a\x87\x0a")
JP2_BOX = b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a"
RLE_STATUS = {1: "a channel's run lengths do not end on its size",
              2: "a channel's data ends early"}


def rle_plain(data: bytes, pos: int, size: int
              ) -> tuple[np.ndarray, int, int]:
    """One channel of Pillow's ``read_32`` from ``pos`` -> (``size``
    bytes, zero-filled past what was read; where it ended; status 0 or a
    key of RLE_STATUS)."""
    out = bytearray()
    left = size
    n = len(data)
    while left > 0:
        if pos >= n:
            break
        b = data[pos]
        pos += 1
        if b & 0x80:
            k = b - 125
            out += data[pos:pos + 1] * k
            pos += 1 if pos < n else 0
        else:
            k = b + 1
            out += data[pos:pos + k]
            pos = min(pos + k, n)
        left -= k
    status = 1 if left != 0 else 2 if len(out) < size else 0
    arr = np.frombuffer(bytes(out[:size]).ljust(size, b"\0"), np.uint8)
    return arr, pos, status


def directory(data: bytes, name: str) -> dict:
    """{entry type: (start, length)} of the block directory."""
    if len(data) < 8:
        raise NotThisFormat(f"{name}: the ICNS header is cut short")
    (filesize,) = struct.unpack_from(">I", data, 4)
    entries = {}
    pos = 8
    while pos < filesize:
        if pos + 8 > len(data):
            raise NotThisFormat(f"{name}: the ICNS directory runs past the "
                                "data")
        kind = data[pos:pos + 4]
        (size,) = struct.unpack_from(">I", data, pos + 4)
        if size == 0:
            raise NotThisFormat(f"{name}: invalid ICNS block header")
        entries[kind] = (pos + 8, size - 8)
        pos += size
    return entries


def _rgb(data: bytes, start: int, length: int, n: int, name: str
         ) -> np.ndarray:
    """An ``*32`` entry's (n, 3) pixels: raw, or three RLE channels."""
    from wgpu_path_tracing_tpu_torch.accel import native

    if length == 3 * n:
        if start + length > len(data):
            raise ValueError(f"{name}: an ICNS RGB entry ends early (buffer "
                             "is not large enough)")
        return np.frombuffer(data, np.uint8, count=length,
                             offset=start).reshape(n, 3)
    rle = native.icns_rle_native if native.native_available() else rle_plain
    out = np.empty((n, 3), np.uint8)
    pos = start
    for band in range(3):
        out[:, band], pos, status = rle(data, pos, n)
        if status:
            raise ValueError(f"{name}: ICNS RGB entry channel {band}: "
                             f"{RLE_STATUS[status]}")
    return out


def _png(data: bytes, start: int, sizes: list, name: str) -> np.ndarray:
    from wgpu_path_tracing_tpu_torch.utils.image import decode_png_rgba

    try:
        rgba = decode_png_rgba(data[start:], name, transparency=False)
    except struct.error:
        raise ValueError(f"{name}: an ICNS PNG entry is cut short") from None
    return _allowed(rgba, sizes, "PNG", name)


def _jpeg2000(data: bytes, start: int, length: int, sizes: list,
              name: str) -> np.ndarray:
    """A JPEG 2000 entry: its own bytes opened as ``Jpeg2KImageFile``
    opens them (outside ``Image.open``, so every error raises), then
    converted to RGBA."""
    from wgpu_path_tracing_tpu_torch.utils.jpeg2000 import (
        decode_jpeg2000_rgba)

    entry = data[start:] if length < 0 else data[start:start + length]
    try:
        rgba = decode_jpeg2000_rgba(entry, name)
    except NotThisFormat as exc:
        raise ValueError(str(exc)) from None
    return _allowed(rgba, sizes, "JPEG 2000", name)


def _allowed(rgba: np.ndarray, sizes: list, kind: str,
             name: str) -> np.ndarray:
    """Pillow's ``size`` setter on an entry's image."""
    ph, pw = rgba.shape[:2]
    for w, h, scale in sizes:
        if (h * scale) / ph == (w * scale) // pw:
            return rgba
    raise ValueError(f"{name}: an ICNS {kind} entry of {pw}x{ph} (Pillow: "
                     "this is not one of the allowed sizes of this image)")


def decode_icns_rgba(data: bytes, name: str = "image") -> np.ndarray:
    """ICNS bytes -> (H, W, 4) uint8 RGBA, what Pillow's
    ``Image.open(...).convert("RGBA")`` returns."""
    if not data.startswith(b"icns"):
        raise NotThisFormat(f"{name}: not an ICNS file")
    entries = directory(data, name)
    sizes = [size for size, kinds in SIZES.items()
             if any(kind in entries for kind, _ in kinds)]
    if not sizes:
        raise NotThisFormat(f"{name}: no 32-bit icon resources found")
    best = max(sizes)
    w, h = best[0] * best[2], best[1] * best[2]
    bomb_check(w, h, name)
    channels = {}
    for kind, reader in SIZES[best]:
        if kind not in entries:
            continue
        start, length = entries[kind]
        if reader == "png":
            sig = data[start:start + 12]
            if sig.startswith(PNG_SIGNATURE):
                channels["RGBA"] = _png(data, start, sizes, name)
            elif sig.startswith(JP2_SIGNATURES) or sig == JP2_BOX:
                channels["RGBA"] = _jpeg2000(data, start, length, sizes,
                                             name)
            else:
                raise ValueError(f"{name}: unsupported ICNS entry format")
        elif reader == "mask":
            if start + w * h > len(data):
                raise ValueError(f"{name}: an ICNS mask ends early (buffer "
                                 "is not large enough)")
            channels["A"] = np.frombuffer(data, np.uint8, count=w * h,
                                          offset=start)
        else:
            if reader == "32t":
                if data[start:start + 4] != bytes(4):
                    raise ValueError(f"{name}: unknown ICNS it32 signature, "
                                     "expecting 0x00000000")
                start, length = start + 4, length - 4
            channels["RGB"] = _rgb(data, start, length, w * h, name)
    if "RGBA" in channels:
        return channels["RGBA"]
    if "RGB" not in channels:
        raise ValueError(f"{name}: an ICNS mask with no RGB entry of its "
                         "size")
    out = np.full((h * w, 4), 255, np.uint8)
    out[:, :3] = channels["RGB"]
    if "A" in channels:
        out[:, 3] = channels["A"]
    return out.reshape(h, w, 4)
