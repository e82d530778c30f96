"""IPTC/NAA image files in NumPy, the pixels Pillow gives.

Pillow's ``IptcImagePlugin`` walks the file's fields (0x1C, record,
dataset, a 15-bit size or, above 0x8000, a size in the next bytes) up to
the first image-data field (8, 10), keeping the others: (3, 60) the
layers and whether there are components, (3, 20) and (3, 30) the width
and height, (3, 120) the compression (1 raw, 5 JPEG), (3, 65) the band
(1-based; 0 reaches the last band). A field header it cannot read passes
the bytes on, and so does a mode it cannot name (one layer without
components is "L", three or four with them "RGB" or "CMYK") or a field
it reads as a list (a repeated one). ``load`` joins the data of the
image-data fields, wraps raw data as a P5 PGM of the header's size
(``utils/netpbm.py``) and opens that, or the joined data as it is
(``decode_image_rgba``: a JPEG through ``utils/jpeg.py``). With a band
the image (it must be "L": raw, or a one-component JPEG) is merged into
that band of the mode, every other band 0; without one, the opened image
is the result whatever its mode.
"""

from __future__ import annotations

import struct

import numpy as np

from wgpu_path_tracing_tpu_torch.utils.sniff import NotThisFormat, bomb_check


def _field(data: bytes, pos: int, name: str, opening: bool):
    """``field()`` at ``pos``: ((record, dataset) or None, size, the
    position of the data)."""
    s = data[pos:pos + 5]
    pos += len(s)
    if not s.strip(b"\x00"):
        return None, 0, pos
    err = NotThisFormat if opening else ValueError
    if len(s) < 4 or s[0] != 0x1C or s[1] not in (1, 2, 3, 4, 5, 6, 7, 8, 9,
                                                  240):
        raise err(f"{name}: invalid IPTC/NAA field")
    size = s[3]
    if size > 132:
        raise ValueError(f"{name}: illegal field length in IPTC/NAA file")
    if size == 128:
        size = 0
    elif size > 128:
        n = size - 128
        size = int.from_bytes((b"\0\0\0\0" + data[pos:pos + n])[-4:], "big")
        pos += min(n, len(data) - pos)
    elif len(s) < 5:
        raise err(f"{name}: an IPTC/NAA field header cut short")
    else:
        size = struct.unpack_from(">H", s, 3)[0]
    return (s[1], s[2]), size, pos


def _int(info: dict, key: tuple, name: str) -> int:
    v = info.get(key)
    if key not in info:  # a KeyError in _open: the bytes pass on
        raise NotThisFormat(f"{name}: the IPTC/NAA file lacks field {key}")
    if not isinstance(v, bytes):
        raise NotThisFormat(f"{name}: IPTC/NAA field {key} Pillow cannot "
                            "read as a number")
    return int.from_bytes((b"\0\0\0\0" + v)[-4:], "big")


def decode_iptc_rgba(data: bytes, name: str = "image") -> np.ndarray:
    """IPTC/NAA bytes -> (H, W, 4) uint8 RGBA, what Pillow's
    ``Image.open(...).convert("RGBA")`` returns."""
    from wgpu_path_tracing_tpu_torch.utils import netpbm
    from wgpu_path_tracing_tpu_torch.utils.image import decode_image_rgba
    from wgpu_path_tracing_tpu_torch.utils.jpeg import pillow_cmyk_to_rgb

    info: dict = {}
    pos = 0
    while True:
        offset = pos
        tag, size, pos = _field(data, pos, name, True)
        if not tag or tag == (8, 10):
            break
        value = data[pos:pos + size] if size else None
        pos += size if size else 0
        if tag in info:
            old = info[tag]
            info[tag] = old + [value] if isinstance(old, list) else [old,
                                                                      value]
        else:
            info[tag] = value
    if (3, 60) not in info:
        raise NotThisFormat(f"{name}: the IPTC/NAA file lacks field (3, 60)")
    try:
        layers, component = info[(3, 60)][0], info[(3, 60)][1]
    except (TypeError, IndexError):
        raise NotThisFormat(f"{name}: an IPTC/NAA field (3, 60) Pillow "
                            "cannot read") from None
    band = None
    mode = ""
    if layers == 1 and not component:
        mode = "L"
    else:
        if layers == 3 and component:
            mode = "RGB"
        elif layers == 4 and component:
            mode = "CMYK"
        band = 0
        if (3, 65) in info:
            try:
                band = info[(3, 65)][0] - 1
            except (TypeError, IndexError):
                raise NotThisFormat(f"{name}: an IPTC/NAA field (3, 65) "
                                    "Pillow cannot read") from None
    w, h = _int(info, (3, 20), name), _int(info, (3, 30), name)
    compression = {1: "raw", 5: "jpeg"}.get(_int(info, (3, 120), name))
    if compression is None:
        raise ValueError(f"{name}: unknown IPTC image compression")
    if not mode or w <= 0 or h <= 0:
        raise NotThisFormat(f"{name}: an IPTC/NAA file Pillow gives no mode "
                            "or size")
    bomb_check(w, h, name)
    if tag != (8, 10):
        raise ValueError(f"{name}: an IPTC/NAA file without image data "
                         "(Pillow: cannot load this image)")
    chunks = [b"P5\n%d %d\n255\n" % (w, h)] if compression == "raw" else []
    pos = offset
    while True:
        tag, size, pos = _field(data, pos, name, False)
        if tag != (8, 10):
            break
        chunks.append(data[pos:pos + size])
        pos += size
    embedded = b"".join(chunks)
    if band is None:
        return decode_image_rgba(embedded, name)
    if compression == "raw":
        gray = netpbm.decode_netpbm_rgba(embedded, name)[..., 0]
    elif embedded[:3] == b"\xff\xd8\xff" and _jpeg_components(embedded) == 1:
        gray = decode_image_rgba(embedded, name)[..., 0]
    else:
        raise ValueError(f"{name}: an IPTC/NAA band that is not a gray image "
                         "(Pillow: mode mismatch)")
    nbands = len(mode)
    if not -nbands <= band < nbands:
        raise ValueError(f"{name}: IPTC/NAA band {band + 1} of a {mode} "
                         "image (Pillow: list index out of range)")
    planes = [np.zeros_like(gray)] * nbands
    planes[band] = gray
    px = np.stack(planes, -1)
    out = np.full(gray.shape + (4,), 255, np.uint8)
    out[..., :3] = px if mode == "RGB" else pillow_cmyk_to_rgb(
        px.astype(np.int64))
    return out


def _jpeg_components(data: bytes) -> int:
    """The component count of a JPEG's frame header (0 where none)."""
    pos = 2
    while pos + 4 <= len(data) and data[pos] == 0xFF:
        marker = data[pos + 1]
        length = struct.unpack_from(">H", data, pos + 2)[0]
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            return data[pos + 9] if pos + 9 < len(data) else 0
        pos += 2 + length
    return 0
