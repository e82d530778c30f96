"""Autodesk FLI/FLC animations in NumPy, the first frame as Pillow gives it.

Pillow's ``FliImagePlugin`` checks the 128-byte header (magic 0xAF11 or
0xAF12, flags 0 or 3, reserved bytes zero; else the bytes pass on), reads
the first frame's palette chunk in ``_open`` (COLOR_256, type 4, or
COLOR_64, type 11, whose values it shifts left by 2 and keeps the low 8
bits of; the palette is a gray ramp where there is none; a chunk header
it cannot read passes the bytes on), and decodes the frame at byte 128
with its C ``fli`` decoder, found black-box (``fli_plain``):

* the frame is read whole (its size's bytes, one pad byte excused); a
  frame that is not 0xF1FA, an unknown chunk, a chunk whose advance is 0
  or runs past the frame, or packets that run past the data raise;
* BRUN (15): each row a count byte, then packets of a count (negative:
  that many literal bytes, positive: one byte repeated); a packet past
  the row's end stops the row, and a row not filled raises;
* LC (12): the first row and the row count, each row a packet count,
  then packets of a skip, a count (negative: one byte repeated, positive:
  literal bytes); a packet past the row stops it, rows left raise;
* SS2 (7): the line count, each line's words: flag words skip lines
  (0xC000 and up) or set the last pixel (0x8000 and up), then packets of
  a skip and a count of byte pairs (negative: one pair repeated); a
  packet past the row stops the line, lines left raise;
* COPY (16): the raw frame, which must fit in the frame's data; BLACK
  (13): zeros; COLOR (4, 11) and PSTAMP (18): skipped.

The image starts at index 0 everywhere. The chunk loop has a C++ twin,
``accel/cbvh/image_scan.cpp``'s ``wpt_fli``, taken wherever
``accel.native.native_available()``.
"""

from __future__ import annotations

import numpy as np

from wgpu_path_tracing_tpu_torch.utils.sniff import NotThisFormat, bomb_check

# fli_plain's statuses: 0 a frame decoded, 1 bad data (Pillow's OVERRUN,
# UNKNOWN or BROKEN), 2 not enough data for the frame.
STATUS = {1: "bad FLI frame data", 2: "image file is truncated (the FLI "
          "frame ends early)"}


def _i16(b, at: int) -> int:
    return b[at] | (b[at + 1] << 8)


def _i32(b, at: int) -> int:
    v = b[at] | (b[at + 1] << 8) | (b[at + 2] << 16) | (b[at + 3] << 24)
    return v - (1 << 32) if v >= 1 << 31 else v


def fli_plain(buf: bytes, w: int, h: int) -> tuple[np.ndarray, int]:
    """Pillow's ``ImagingFliDecode`` on one frame's bytes -> ((h, w)
    uint8 indices, status). The plain version of ``image_scan.cpp``'s
    ``wpt_fli``."""
    im = np.zeros((h, w), np.uint8)
    n = len(buf)
    if n < 4:
        return im, 2
    framesize = _i32(buf, 0)
    if n + (n % 2) < framesize:
        return im, 2
    if n < 8 or _i16(buf, 4) != 0xF1FA:
        return im, 1
    chunks = _i16(buf, 6)
    ptr, left = 16, n - 16
    for _ in range(chunks):
        if left < 10:
            return im, 1
        data = ptr + 6
        end = ptr + left  # ERR_IF_DATA_OOB: data + offset > ptr + bytes
        kind = _i16(buf, ptr + 4)
        if kind in (4, 11, 18):
            pass
        elif kind == 7:  # SS2
            lines = _i16(buf, data)
            data += 2
            y = l_done = 0
            while l_done < lines and y < h:
                if data + 2 > end:
                    return im, 1
                packets = _i16(buf, data)
                data += 2
                while packets & 0x8000:
                    if packets & 0x4000:
                        y += 65536 - packets
                        if y >= h:
                            return im, 1
                    else:
                        im[y, w - 1] = packets & 0xFF
                    if data + 2 > end:
                        return im, 1
                    packets = _i16(buf, data)
                    data += 2
                x = p = 0
                while p < packets:
                    if data + 2 > end:
                        return im, 1
                    x += buf[data]
                    if buf[data + 1] >= 128:
                        if data + 4 > end:
                            return im, 1
                        i = 256 - buf[data + 1]
                        if x + 2 * i > w:
                            break
                        im[y, x:x + 2 * i] = np.tile(
                            np.frombuffer(buf, np.uint8, 2, data + 2), i)
                        x += 2 * i
                        data += 4
                    else:
                        i = 2 * buf[data + 1]
                        if x + i > w:
                            break
                        if data + 2 + i > end:
                            return im, 1
                        im[y, x:x + i] = np.frombuffer(buf, np.uint8, i,
                                                       data + 2)
                        data += 2 + i
                        x += i
                    p += 1
                if p < packets:
                    break
                l_done += 1
                y += 1
            if l_done < lines:
                return im, 1
        elif kind == 12:  # LC
            y = _i16(buf, data)
            ymax = y + _i16(buf, data + 2)
            data += 4
            while y < ymax and y < h:
                if data + 1 > end:
                    return im, 1
                packets = buf[data]
                data += 1
                x = p = 0
                while p < packets:
                    if data + 2 > end:
                        return im, 1
                    x += buf[data]
                    if buf[data + 1] & 0x80:
                        i = 256 - buf[data + 1]
                        if x + i > w:
                            break
                        if data + 3 > end:
                            return im, 1
                        im[y, x:x + i] = buf[data + 2]
                        data += 3
                    else:
                        i = buf[data + 1]
                        if x + i > w:
                            break
                        if data + 2 + i > end:
                            return im, 1
                        im[y, x:x + i] = np.frombuffer(buf, np.uint8, i,
                                                       data + 2)
                        data += i + 2
                    p += 1
                    x += i
                if p < packets:
                    break
                y += 1
            if y < ymax:
                return im, 1
        elif kind == 13:  # BLACK
            im[:] = 0
        elif kind == 15:  # BRUN
            for y in range(h):
                data += 1  # the packet count, ignored
                x = 0
                while x < w:
                    if data + 2 > end:
                        return im, 1
                    c = buf[data]
                    if c & 0x80:
                        i = 256 - c
                        if x + i > w:
                            break
                        if data + i + 1 > end:
                            return im, 1
                        im[y, x:x + i] = np.frombuffer(buf, np.uint8, i,
                                                       data + 1)
                        data += i + 1
                    else:
                        i = c
                        if x + i > w:
                            break
                        im[y, x:x + i] = buf[data + 1]
                        data += 2
                    x += i
                if x != w:
                    return im, 1
        elif kind == 16:  # COPY
            if data + w * h > end:
                return im, 2
            im[:] = np.frombuffer(buf, np.uint8, w * h, data).reshape(h, w)
        else:
            return im, 1
        advance = _i32(buf, ptr)
        if advance == 0 or advance < 0 or advance > left:
            return im, 1
        ptr += advance
        left -= advance
    return im, 0


def _frame(buf: bytes, w: int, h: int, name: str) -> np.ndarray:
    from wgpu_path_tracing_tpu_torch.accel import native

    if native.native_available():
        im, status = native.fli_native(buf, w, h)
    else:
        im, status = fli_plain(buf, w, h)
    if status:
        raise ValueError(f"{name}: {STATUS[status]}")
    return im


def _palette(data: bytes, pos: int, shift: int, palette: np.ndarray,
             name: str) -> None:
    """``_palette``: packets of a skip and a count (0: 256) of RGB
    triples, each value shifted left by ``shift``, its low 8 bits kept."""
    if pos + 2 > len(data):
        raise NotThisFormat(f"{name}: an FLI colour chunk cut short")
    i = 0
    pos += 2
    for _ in range(_i16(data, pos - 2)):
        s = data[pos:pos + 2]
        pos += len(s)
        if len(s) < 2:
            raise NotThisFormat(f"{name}: an FLI colour packet cut short")
        i += s[0]
        n = s[1] or 256
        rgb = data[pos:pos + 3 * n]
        pos += len(rgb)
        if len(rgb) % 3 or (rgb and i + len(rgb) // 3 > 256):
            raise NotThisFormat(f"{name}: an FLI colour packet Pillow "
                                "cannot read")
        vals = (np.frombuffer(rgb, np.uint8).astype(np.int64) << shift) & 255
        palette[i:i + len(rgb) // 3] = vals.reshape(-1, 3)
        i += len(rgb) // 3


def decode_fli_rgba(data: bytes, name: str = "image") -> np.ndarray:
    """FLI/FLC bytes -> (H, W, 4) uint8 RGBA of the first frame, what
    Pillow's ``Image.open(...).convert("RGBA")`` returns."""
    s = data[:128]
    if not (len(s) >= 16 and _i16(s, 4) in (0xAF11, 0xAF12)
            and _i16(s, 14) in (0, 3) and s[20:22] == b"\0\0"
            and s[42:80] == bytes(38) and s[88:] == bytes(40)):
        raise NotThisFormat(f"{name}: not an FLI/FLC file")
    frames, w, h = _i16(s, 6), _i16(s, 8), _i16(s, 10)
    palette = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)
    head = data[128:144]
    if len(head) < 6:
        raise NotThisFormat(f"{name}: the FLI frame header is cut short")
    pos = 144
    if _i16(head, 4) == 0xF100:  # a prefix chunk, skipped
        pos = 128 + (_i32(head, 0) & 0xFFFFFFFF)
        head = data[pos:pos + 16]
        pos += len(head)
        if len(head) < 6:
            raise NotThisFormat(f"{name}: the FLI frame header is cut short")
    if _i16(head, 4) == 0xF1FA:
        size = None
        for _ in range(_i16(head, 6)):
            if size is not None:  # a seek from here, clamped at 0
                pos = max(0, pos + size - 6)
            sub = data[pos:pos + 6]
            pos += len(sub)
            if len(sub) < 6:
                raise NotThisFormat(f"{name}: an FLI chunk header cut short")
            kind = _i16(sub, 4)
            if kind in (4, 11):
                _palette(data, pos, 2 if kind == 11 else 0, palette, name)
                break
            size = _i32(sub, 0) & 0xFFFFFFFF
            if not size:
                break
    size_bytes = data[128:132]
    if frames == 0 or len(size_bytes) < 4:  # EOFError, struct.error
        raise NotThisFormat(f"{name}: the FLI frame size is cut short")
    if w == 0 or h == 0:
        raise NotThisFormat(f"{name}: an FLI file of no pixels")
    bomb_check(w, h, name)
    framesize = _i32(size_bytes, 0) & 0xFFFFFFFF
    if framesize < 8:
        raise ValueError(f"{name}: image file is truncated (an FLI frame "
                         f"size of {framesize})")
    im = _frame(data[128:128 + framesize], w, h, name)
    out = np.full((h, w, 4), 255, np.uint8)
    out[..., :3] = palette[im]
    return out
