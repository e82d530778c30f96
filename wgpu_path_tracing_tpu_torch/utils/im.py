"""IFUNC Image Memory (IM) files in NumPy, the pixels Pillow gives.

Pillow's ``ImImagePlugin`` reads a text header of ``key: value`` lines
(up to a NUL or ^Z, each at most 100 bytes; at least one known key, or
the bytes pass on), then skips to the ^Z that ends it; the first image
follows (a file may hold several). What it reads, quirks and all:

* "Image type" picks the mode and raw mode from ``OPEN`` (a value not
  there is taken as the mode itself, which only "L" survives); "Image
  size" is "w*h" (one number, which Pillow cannot index, passes the bytes
  on); every raw tile runs bottom-up (``ystep`` -1);
* the raw modes: "1" (a set bit white), "L", "P;2" and "P;4" (packed
  indices, high bits first), "RGB", the line-interleaved ";L" modes (a
  row of each band in turn: "RGB;L", "LA;L", "RGBA;L", "RGBX;L",
  "CMYK;L", "YCbCr;L", "PA;L"), "RGB;T" (whole planes, green, red and
  blue), "F;8", "F;8S", "F;16", "F;16S", "F;32" (unsigned), "F;32F",
  "I;16", "I;16L", "I;16B", "I;32" and "I;32S"; "F;n" for other n goes
  through Pillow's bit decoder (``bits_plain``: n bits a pixel, least
  significant first, rows padded to bytes, whose leftover bits Pillow ORs
  into the next row's first byte);
* a "Lut" line: 768 bytes of planar palette follow the ^Z (the image
  after them); a gray ramp that is not linear changes nothing (Pillow
  keeps it as an attribute it never uses), other colours turn "L" and
  "P" into "P" read as 8-bit indices (even a packed "P;2" or "P;4"), and
  "LA" and "PA" into "PA"; without a colour palette a "P" image is black
  (its palette is all zero) and "PA;L" under mode "LA" has no unpacker.

"I", "I;16" and "F" reach RGBA through "L" (``pilmodes.gray8``);
"YCbCr" through Pillow's fixed-point tables (``pilmodes.ycbcr_to_rgb``).
The bit decoder's loop has a C++ twin, ``accel/cbvh/image_scan.cpp``'s
``wpt_bit_decode``, taken wherever ``accel.native.native_available()``.
"""

from __future__ import annotations

import re

import numpy as np

from wgpu_path_tracing_tpu_torch.utils.pilmodes import (gray8, gray_rgba,
                                                        raw_rows,
                                                        ycbcr_to_rgb)
from wgpu_path_tracing_tpu_torch.utils.sniff import NotThisFormat, bomb_check

OPEN = {
    "0 1 image": ("1", "1"), "L 1 image": ("1", "1"),
    "Greyscale image": ("L", "L"), "Grayscale image": ("L", "L"),
    "RGB image": ("RGB", "RGB;L"), "RLB image": ("RGB", "RLB"),
    "RYB image": ("RGB", "RLB"), "B1 image": ("1", "1"),
    "B2 image": ("P", "P;2"), "B4 image": ("P", "P;4"),
    "X 24 image": ("RGB", "RGB"), "L 32 S image": ("I", "I;32"),
    "L 32 F image": ("F", "F;32"), "RGB3 image": ("RGB", "RGB;T"),
    "RYB3 image": ("RGB", "RYB;T"), "LA image": ("LA", "LA;L"),
    "PA image": ("LA", "PA;L"), "RGBA image": ("RGBA", "RGBA;L"),
    "RGBX image": ("RGB", "RGBX;L"), "CMYK image": ("CMYK", "CMYK;L"),
    "YCC image": ("YCbCr", "YCbCr;L"),
}
for _i in ["8", "8S", "16", "16S", "32", "32F"]:
    OPEN[f"L {_i} image"] = ("F", f"F;{_i}")
    OPEN[f"L*{_i} image"] = ("F", f"F;{_i}")
for _i in ["16", "16L", "16B"]:
    OPEN[f"L {_i} image"] = (f"I;{_i}", f"I;{_i}")
    OPEN[f"L*{_i} image"] = (f"I;{_i}", f"I;{_i}")
OPEN["L 32S image"] = ("I", "I;32S")
OPEN["L*32S image"] = ("I", "I;32S")
for _j in range(2, 33):
    OPEN[f"L*{_j} image"] = ("F", f"F;{_j}")

TAGS = {"Comment", "Date", "Digitalization equipment",
        "File size (no of images)", "Lut", "Name", "Scale (x,y)",
        "Image size (x*y)", "Image type"}
SPLIT = re.compile(rb"^([A-Za-z][^:]*):[ \t]*(.*)[ \t]*$")

# The (mode, raw mode) pairs Pillow decodes ("RLB" and "PA;L" under "LA"
# have no unpacker).
DECODED = (set(OPEN.values()) | {("L", "L"), ("P", "P"), ("PA", "PA;L")}) - {
    ("RGB", "RLB"), ("LA", "PA;L")}
# Raw modes of one value a pixel: (bytes, NumPy dtype).
SCALAR = {"L": (1, "u1"), "F;8": (1, "u1"), "F;8S": (1, "i1"),
          "F;16": (2, "<u2"), "F;16S": (2, "<i2"), "F;32": (4, "<u4"),
          "F;32F": (4, "<f4"), "I;16": (2, "<u2"), "I;16L": (2, "<u2"),
          "I;16B": (2, ">u2"), "I;32": (4, "<i4"), "I;32S": (4, "<i4")}
# Line-interleaved raw modes: the bands a row holds, then the mode's.
INTERLEAVED = {"RGB;L": 3, "LA;L": 2, "PA;L": 2, "RGBA;L": 4, "RGBX;L": 4,
               "CMYK;L": 4, "YCbCr;L": 3}


def bits_plain(data: bytes, pos: int, w: int, h: int,
               bits: int) -> tuple[np.ndarray, int]:
    """Pillow's ``ImagingBitDecode`` at (bits, pad 8, fill 3, unsigned,
    bottom-up) from ``pos`` -> ((h, w) float32 rows, top row first,
    status): 0, or 1 where the data ends first (then the rows read so far
    and zeros). The plain version of ``image_scan.cpp``'s
    ``wpt_bit_decode``."""
    out = np.zeros(w * h, np.float32)
    mask = (1 << bits) - 1
    buf = count = 0
    x, y = 0, h - 1
    vals = []
    for at in range(pos, len(data)):
        byte = data[at]
        buf |= byte << count
        count += 8
        while count >= bits:
            vals.append(buf & mask)
            if count > 32:
                buf = byte >> (8 - (count - bits))
            else:
                buf >>= bits
            count -= bits
            x += 1
            if x >= w:
                out[y * w:(y + 1) * w] = vals
                vals = []
                y -= 1
                if y < 0:
                    return out.reshape(h, w), 0
                x = 0
                count = 0
    return out.reshape(h, w), 1


def _bits(data: bytes, pos: int, w: int, h: int, bits: int,
          name: str) -> np.ndarray:
    from wgpu_path_tracing_tpu_torch.accel import native

    if native.native_available():
        out, status = native.bit_decode_native(data, pos, w, h, bits)
    else:
        out, status = bits_plain(data, pos, w, h, bits)
    if status:
        raise ValueError(f"{name}: image file is truncated (the IM bit data "
                         "ends early)")
    return out


def _number(t: str):
    """``ImImagePlugin.number``: an int, else a float."""
    try:
        return int(t)
    except ValueError:
        return float(t)


def _header(data: bytes, name: str):
    """``_open``'s header loop: (info, raw mode, the offset after the
    ^Z)."""
    if b"\n" not in data[:100]:
        raise NotThisFormat(f"{name}: not an IM file")
    info = {"Image type": "L", "Image size (x*y)": (512, 512)}
    rawmode, n, pos = "L", 0, 0
    s = b""
    while True:
        s = data[pos:pos + 1]
        pos += len(s)
        if s == b"\r":
            continue
        if not s or s in (b"\0", b"\x1a"):
            break
        end = data.find(b"\n", pos)
        end = len(data) if end < 0 else end + 1
        s, pos = s + data[pos:end], end
        if len(s) > 100:
            raise NotThisFormat(f"{name}: not an IM file (a long line)")
        s = s[:-2] if s.endswith(b"\r\n") else s[:-1] if s.endswith(
            b"\n") else s
        m = SPLIT.match(s)
        if not m:
            raise NotThisFormat(f"{name}: syntax error in IM header")
        k, v = (g.decode("latin-1", "replace") for g in m.group(1, 2))
        if k in ("File size (no of images)", "Scale (x,y)",
                 "Image size (x*y)"):
            try:
                v = tuple(_number(t) for t in v.replace("*", ",").split(","))
            except ValueError:
                raise ValueError(f"{name}: a number in the IM header Pillow "
                                 f"cannot read ({v[:40]!r})") from None
            v = v[0] if len(v) == 1 else v
        elif k == "Image type" and v in OPEN:
            v, rawmode = OPEN[v]
        info[k] = v
        n += k in TAGS
    if not n:
        raise NotThisFormat(f"{name}: not an IM file (no known key)")
    while s and not s.startswith(b"\x1a"):
        s = data[pos:pos + 1]
        pos += len(s)
    if not s:
        raise NotThisFormat(f"{name}: IM file truncated (no ^Z)")
    return info, rawmode, pos


def decode_im_rgba(data: bytes, name: str = "image") -> np.ndarray:
    """IM bytes -> (H, W, 4) uint8 RGBA of the first image, what Pillow's
    ``Image.open(...).convert("RGBA")`` returns."""
    from wgpu_path_tracing_tpu_torch.utils.jpeg import pillow_cmyk_to_rgb

    info, rawmode, pos = _header(data, name)
    size, mode = info["Image size (x*y)"], info["Image type"]
    if not isinstance(size, tuple):
        raise NotThisFormat(f"{name}: an IM size of one number")
    if len(size) != 2 or not all(isinstance(v, int) for v in size):
        raise ValueError(f"{name}: an IM size Pillow cannot make an image "
                         f"of ({size})")
    w, h = size
    if w <= 0 or h <= 0:
        raise NotThisFormat(f"{name}: an IM image of no pixels")
    palette = None
    if "Lut" in info:
        lut = data[pos:pos + 768]
        if len(lut) < 768:
            raise NotThisFormat(f"{name}: the IM palette is cut short")
        pos += 768
        p = np.frombuffer(lut, np.uint8).reshape(3, 256)
        grey = bool((p[0] == p[1]).all() and (p[1] == p[2]).all())
        if mode in ("L", "LA", "P", "PA") and not grey:
            palette = p.T
            if mode in ("L", "P"):
                mode = rawmode = "P"
            else:
                mode, rawmode = "PA", "PA;L"
    if (mode, rawmode) not in DECODED:
        raise ValueError(f"{name}: IM raw mode {rawmode!r} under mode "
                         f"{mode!r} (Pillow: unknown raw mode or "
                         "unrecognized image mode)")
    bomb_check(w, h, name)
    if rawmode.startswith("F;") and rawmode[2:].isdigit() and int(
            rawmode[2:]) not in (8, 16, 32):
        return gray_rgba(gray8(_bits(data, pos, w, h, int(rawmode[2:]),
                                     name)))
    if rawmode in ("RGB;T", "RYB;T"):  # green, red and blue planes
        planes = [raw_rows(data, pos + k * w * h, h, w, w, True, name)
                  for k in range(3)]
        rgb = np.stack([planes[1], planes[0], planes[2]], -1)
        return np.concatenate([rgb, np.full((h, w, 1), 255, np.uint8)], -1)
    out = np.full((h, w, 4), 255, np.uint8)
    if rawmode == "1":
        rows = raw_rows(data, pos, h, (w + 7) // 8, (w + 7) // 8, True, name)
        out[..., :3] = (np.unpackbits(rows, axis=1)[:, :w] * 255)[..., None]
        return out
    if rawmode in ("P;2", "P;4"):
        bits = int(rawmode[2])
        rows = raw_rows(data, pos, h, (w * bits + 7) // 8, (w * bits + 7) // 8,
                        True, name)
        out[..., :3] = 0  # no palette: every entry black
        return out
    if rawmode in SCALAR:
        unit, dtype = SCALAR[rawmode]
        rows = raw_rows(data, pos, h, unit * w, unit * w, True, name)
        v = np.ascontiguousarray(rows).view(np.dtype(dtype)).reshape(h, w)
        return gray_rgba(v if rawmode == "L" else gray8(v))
    if rawmode == "P":
        idx = raw_rows(data, pos, h, w, w, True, name)
        out[..., :3] = 0 if palette is None else palette[idx]
        return out
    if rawmode == "RGB":
        out[..., :3] = raw_rows(data, pos, h, 3 * w, 3 * w, True,
                                name).reshape(h, w, 3)
        return out
    bands = INTERLEAVED[rawmode]
    # a row of each band in turn
    px = raw_rows(data, pos, h, bands * w, bands * w, True, name).reshape(
        h, bands, w).transpose(0, 2, 1)
    if rawmode == "LA;L":
        out[..., :3] = px[..., :1]
        out[..., 3] = px[..., 1]
    elif rawmode == "PA;L":
        out[..., :3] = palette[px[..., 0]]
        out[..., 3] = px[..., 1]
    elif rawmode == "CMYK;L":
        out[..., :3] = pillow_cmyk_to_rgb(px.astype(np.int64))
    elif rawmode == "YCbCr;L":
        out[..., :3] = ycbcr_to_rgb(px)
    else:
        out[..., :3] = px[..., :3]
        if rawmode == "RGBA;L":
            out[..., 3] = px[..., 3]
    return out
