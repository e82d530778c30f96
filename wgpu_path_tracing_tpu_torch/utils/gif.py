"""GIF decoding in NumPy, the first frame as Pillow gives it.

The JAX package opens LDR environment maps and textures with Pillow
(``Image.open(...).convert("RGBA")``). For a GIF that is the first frame
as Pillow 12.1.0's ``GifImagePlugin`` loads it; this module reads it to
the same bytes:

* the screen descriptor and the blocks before the first image as
  ``_open`` and ``_seek(0)`` walk them: extensions (the graphic control
  extension's transparency index is kept; comments and application blocks
  skipped), stray bytes skipped one at a time, and the first image
  descriptor, whose extent grows the image where it passes the logical
  screen;
* the mode: "P" with the local palette, else the global one, and "L" when
  there is none or it is the identity gray ramp (then an index is its own
  gray, past the ramp too); in "P" an index past the palette's entries is
  black; a local gray ramp under a global palette still takes the global
  one (Pillow puts it on the "L" image), and then a transparency index
  makes ``convert("RGBA")`` raise;
* outside the frame's extent the image holds the transparency index if
  there is one, else index 0; ``convert("RGBA")`` makes that index's
  alpha 0 (its RGB the palette's);
* the LZW data as Pillow's ``GifDecode.c`` reads it (``lzw_plain``):
  codes LSB first across sub-blocks (a zero-length sub-block does not end
  the data), a literal past 255 (minimum code sizes 9-12) kept as its low
  byte, the code size growing to 12 bits as its table fills and the
  table staying full without a clear code, rows in interlace order (0::8,
  4::8, 2::4, 1::2), the decode ending at the frame's last pixel.

The LZW loop has a C++ twin, ``accel/cbvh/image_scan.cpp``'s
``wpt_gif_lzw``, which ``decode_gif_rgba`` takes wherever
``accel.native.native_available()``. Where Pillow's ``_open`` would pass
the bytes on to its next format (the screen, an extension or the image
descriptor cut short, or no image before the trailer: ``ImageFile`` turns
those errors into ``SyntaxError``) this module raises ``NotThisFormat``;
what Pillow refuses on load (a data stream that ends before the frame's
last pixel or an end code before it, a code past the table, a minimum
code size over 12, an empty frame) raises ``ValueError`` naming the
image.
"""

from __future__ import annotations

import struct

import numpy as np

from wgpu_path_tracing_tpu_torch.utils.sniff import NotThisFormat, bomb_check

LZW_STATUS = {1: "broken LZW data", 2: "the LZW data ends before the "
              "frame's last pixel (image file is truncated)",
              3: "an LZW minimum code size over 12"}


def lzw_plain(data: bytes, bits: int, width: int, height: int,
              interlace: bool) -> tuple[np.ndarray, int, int]:
    """Pillow's ``ImagingGifDecode`` of the data after an image's minimum
    code size byte -> ((height, width) uint8 indices, pixels written,
    status): 0 when the frame's last pixel is written, else a key of
    LZW_STATUS (an end code before it counts as data that ends)."""
    out = np.zeros(height * width, np.uint8)
    if bits < 0 or bits > 12:
        return out.reshape(height, width), 0, 3
    clear, end = 1 << bits, (1 << bits) + 1
    step, il = (8, 1) if interlace else (1, 0)
    data_tab = [0] * 4096
    link = [0] * 4096
    n = len(data)
    pos = blocksize = bitbuffer = bitcount = 0
    x = y = written = 0
    state = 1
    nxt = codesize = codemask = lastcode = lastdata = 0
    pending: list = []
    while True:
        if state == 1:
            nxt = clear + 2
            codesize = bits + 1
            codemask = (1 << codesize) - 1
            pending = []
            state = 2
        if pending:
            string = pending
            pending = []
        else:
            while bitcount < codesize:
                if blocksize > 0:
                    bitbuffer |= data[pos] << bitcount
                    pos += 1
                    blocksize -= 1
                    bitcount += 8
                else:
                    if pos >= n or n - pos < data[pos] + 1:
                        return out.reshape(height, width), written, 2
                    blocksize = data[pos]
                    pos += 1
            c = bitbuffer & codemask
            bitbuffer >>= codesize
            bitcount -= codesize
            if c == clear:
                if state != 2:
                    state = 1
                continue
            if c == end:
                return out.reshape(height, width), written, 2
            if state == 2:
                if c > clear:
                    return out.reshape(height, width), written, 1
                lastdata, lastcode = c & 0xFF, c  # Pillow keeps a byte
                state = 3
            else:
                thiscode = c
                if c > nxt:
                    return out.reshape(height, width), written, 1
                stack = []
                if c == nxt:
                    stack.append(lastdata)
                    c = lastcode
                while c >= clear:
                    if len(stack) >= 4096 or c >= 4096:
                        return out.reshape(height, width), written, 1
                    stack.append(data_tab[c])
                    c = link[c]
                lastdata = c & 0xFF
                if nxt < 4096:
                    data_tab[nxt] = c & 0xFF
                    link[nxt] = lastcode
                    if nxt == codemask and codesize < 12:
                        codesize += 1
                        codemask = (1 << codesize) - 1
                    nxt += 1
                lastcode = thiscode
                pending = stack[::-1]
            string = [lastdata]
        if y >= height:
            return out.reshape(height, width), written, 1
        for v in string:
            out[y * width + x] = v
            written += 1
            x += 1
            if x >= width:
                x = 0
                y += step
                while y >= height:
                    if il == 1:
                        y, il = 4, 2
                    elif il == 2:
                        step, y, il = 4, 2, 3
                    elif il == 3:
                        step, y, il = 2, 1, 0
                    else:
                        return out.reshape(height, width), written, 0


def _lzw(data: bytes, bits: int, width: int, height: int, interlace: bool):
    from wgpu_path_tracing_tpu_torch.accel import native

    if native.native_available():
        return native.gif_lzw_native(data, bits, width, height, interlace)
    return lzw_plain(data, bits, width, height, interlace)


def _i16(b: bytes, at: int) -> int:
    if len(b) < at + 2:
        raise NotThisFormat("struct.error")
    return struct.unpack_from("<H", b, at)[0]


def _byte(b: bytes, at: int) -> int:
    if len(b) <= at:
        raise NotThisFormat("IndexError")
    return b[at]


def _palette_needed(p: bytes) -> bool:
    """``GifImageFile._is_palette_needed``, its chained comparison's
    IndexError on a cut triple included."""
    for i in range(0, len(p), 3):
        k = i // 3
        if k != p[i]:
            return True
        if _byte(p, i + 1) != p[i]:
            return True
        if _byte(p, i + 2) != p[i + 1]:
            return True
    return False


class _Reader:
    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos

    def read(self, n: int) -> bytes:
        out = self.data[self.pos:self.pos + n]
        self.pos += len(out)
        return out

    def block(self) -> bytes | None:
        """``GifImageFile.data``: one sub-block, or None at its end."""
        s = self.read(1)
        if s and s[0]:
            return self.read(s[0])
        return None


def decode_gif_rgba(data: bytes, name: str = "image") -> np.ndarray:
    """GIF bytes -> (H, W, 4) uint8 RGBA of the first frame, what Pillow's
    ``Image.open(...).convert("RGBA")`` returns."""
    f = _Reader(data)
    s = f.read(13)
    size = [_i16(s, 6), _i16(s, 8)]
    flags = _byte(s, 10)
    global_palette = None
    if flags & 128:
        _byte(s, 11)
        p = f.read(3 << ((flags & 7) + 1))
        if _palette_needed(p):
            global_palette = p
    # _seek(0): the blocks up to the first image descriptor.
    s = f.read(1)
    if not s or s == b";":
        raise NotThisFormat("no more images in GIF file")
    transparency = None
    interlace = None
    palette = None
    while True:
        if not s:
            s = f.read(1)
        if not s or s == b";":
            break
        if s == b"!":
            s = f.read(1)
            block = f.block()
            label = _byte(s, 0)
            if label == 249 and block is not None:
                gflags = _byte(block, 0)
                if gflags & 1:
                    transparency = _byte(block, 3)
                _i16(block, 1)
            elif label == 254:
                while block:
                    block = f.block()
                s = b""
                continue
            elif label == 255 and block is not None:
                if block.startswith(b"NETSCAPE2.0"):
                    f.block()
            while f.block():
                pass
        elif s == b",":
            s = f.read(9)
            x0, y0 = _i16(s, 0), _i16(s, 2)
            x1, y1 = x0 + _i16(s, 4), y0 + _i16(s, 6)
            if x1 > size[0] or y1 > size[1]:
                size = [max(x1, size[0]), max(y1, size[1])]
                bomb_check(size[0], size[1], name)
            extent = (x0, y0, x1, y1)
            lflags = _byte(s, 8)
            interlace = bool(lflags & 64)
            if lflags & 128:
                p = f.read(3 << ((lflags & 7) + 1))
                palette = p if _palette_needed(p) else False
            bits = _byte(f.read(1), 0)
            offset = f.pos
            break
        s = b""
    if interlace is None:
        raise NotThisFormat("image not found in GIF frame")
    bomb_check(size[0], size[1], name)
    w, h = size
    frame_palette = palette if palette is not None else global_palette
    x0, y0, x1, y1 = extent
    if x1 <= x0 or y1 <= y0:
        raise ValueError(f"{name}: the GIF frame is empty (tile cannot "
                         "extend outside image)")
    idx = np.full((h, w), 0 if transparency is None else transparency,
                  np.uint8)
    frame, _, status = _lzw(data[offset:], bits, x1 - x0, y1 - y0, interlace)
    if status:
        raise ValueError(f"{name}: {LZW_STATUS[status]}")
    idx[y0:y1, x0:x1] = frame
    if palette is False and global_palette is not None:
        # Mode "L", but Pillow still puts the global palette on the image
        # (which makes it "P"), and then refuses a transparency index.
        if transparency is not None:
            raise ValueError(f"{name}: conversion from P to RGBA not "
                             "supported in convert_transparent")
        frame_palette = global_palette
    table = np.zeros((256, 4), np.uint8)
    table[:, 3] = 255
    if frame_palette:
        pal = np.frombuffer(frame_palette, np.uint8)
        pal = pal[:len(pal) // 3 * 3].reshape(-1, 3)[:256]
        table[:len(pal), :3] = pal
    else:
        table[:, :3] = np.arange(256, dtype=np.uint8)[:, None]
    if transparency is not None:
        table[transparency, 3] = 0
    return table[idx]
