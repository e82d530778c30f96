"""WebP decoding in Python, the pixels Pillow gives.

The JAX package opens LDR environment maps and textures with Pillow
(``Image.open(...).convert("RGBA")``), whose WebP plugin hands the whole
file to libwebp's ``WebPAnimDecoder`` (libwebp 1.6.0 in Pillow 12.1.0).
This module reads what that reads, to the same bytes:

* the container as ``WebPDemux`` checks it: a ``RIFF``/``WEBP`` file
  whose first chunk is ``VP8 ``, ``VP8L`` or ``VP8X``; every chunk inside
  the RIFF size, a ``VP8X`` canvas that a still image fills exactly, an
  ``ALPH`` chunk only right before a ``VP8 `` one, unknown chunks
  (``ICCP``, ``EXIF``, ``XMP ``, ...) skipped, and an animation's frames
  (``ANIM``, ``ANMF``) each inside the canvas;
* the first frame as ``WebPAnimDecoder`` composes it: the frame at its
  offset on a canvas that is transparent black elsewhere;
* Pillow's mode, from ``WebPGetFeatures``: "RGBA" when the file has alpha
  (the ``VP8X`` alpha flag or, for a lossless image, the ``VP8L`` header's
  ``alpha_is_used`` bit, or an ``ALPH`` chunk), else "RGB", whose
  ``convert("RGBA")`` makes alpha 255 whatever the stream holds;
* VP8L, the lossless format: prefix codes (simple and normal code-length
  codes, held to libwebp's rule that a code is complete or has one
  symbol), the meta prefix-code image, LZ77 backward references with the
  120-entry distance map, the colour cache, and the predictor (modes
  0-13), cross-colour, subtract-green and colour-indexing transforms;
* VP8, the lossy format of RFC 6386, key frames as libwebp reconstructs
  them (``vp8_plain``): segments, the coefficient tokens, the 16x16, 4x4
  and chroma intra modes with libwebp's edge values, its inverse
  transforms (the full 4x4 one in 16-bit arithmetic, as its SSE2 version
  computes), and both loop filters in its order; then libwebp's "fancy"
  chroma upsampling and fixed-point YUV->RGB (``yuv_to_rgb_plain``);
* ``ALPH``: raw or VP8L-compressed (green only, no header), with the
  horizontal, vertical and gradient unfilters (``unfilter_plain``); a
  compressed stream that takes libwebp's 8-bit alpha path may read past
  its end with its last pixels, as libwebp lets it.

The sequential loops have C++ twins in ``accel/cbvh/webp_scan.cpp``, which
``decode_webp_rgba`` takes wherever ``accel.native.native_available()``:
``vp8l_plain``, ``vp8_plain``, ``yuv_to_rgb_plain`` and ``unfilter_plain``
here are their plain versions, the same numbers. What libwebp refuses (or
``WebPDemux`` rejects) raises ``ValueError`` naming the image; so does a
``VP8X`` chunk of any other size than 10 bytes, which Pillow 12.1.0 fails
to make a decoder for ("could not create decoder object").
"""

from __future__ import annotations

import struct

import numpy as np

from wgpu_path_tracing_tpu_torch.utils import webp_tables as T
from wgpu_path_tracing_tpu_torch.utils.sniff import bomb_check

# Status codes of the decoding loops (shared with webp_scan.cpp).
STATUS = {1: "bad VP8L bitstream", 2: "VP8L data ends early",
          3: "VP8 data ends early (premature end of a partition)",
          4: "bad VP8 frame header"}

MAX_CHUNK_PAYLOAD = 0xFFFFFFFF - 8 - 1
ALPHA_FLAG, ANIMATION_FLAG = 0x10, 0x02
ALL_VALID_FLAGS = 0x3E


class _Bad(Exception):
    """A loop's failure, carrying its status code."""

    def __init__(self, status: int):
        super().__init__(status)
        self.status = status


# --- VP8L --------------------------------------------------------------------

NUM_LITERAL, NUM_LENGTH, NUM_DISTANCE = 256, 24, 40
CODE_LENGTH_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12,
                     13, 14, 15)
HASH_MUL = 0x1E35A7BD


class _LBits:
    """VP8L's LSB-first bit reader; bits past the end read as zeros and
    ``over()`` says whether libwebp's reader would have flagged the end of
    the stream (more bits read than the data holds, or than its 64-bit
    window when the data is shorter)."""

    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos
        self.limit = max(8 * len(data), 64)

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        p = self.pos
        v = int.from_bytes(self.data[p >> 3:(p >> 3) + 4], "little") >> (p & 7)
        self.pos = p + n
        return v & ((1 << n) - 1)

    def sym(self, code) -> int:
        table, bits = code
        if bits == 0:
            return table
        p = self.pos
        v = int.from_bytes(self.data[p >> 3:(p >> 3) + 3], "little") >> (p & 7)
        e = table[v & ((1 << bits) - 1)]
        self.pos = p + (e & 15)
        return e >> 4

    def over(self) -> bool:
        return self.pos > self.limit


def _reverse(code: int, n: int) -> int:
    r = 0
    for _ in range(n):
        r = (r << 1) | (code & 1)
        code >>= 1
    return r


def build_code(lengths) -> tuple:
    """A prefix code from its code lengths, as libwebp's
    ``BuildHuffmanTable`` accepts them: lengths of at most 15, not all
    zero, and either one symbol (read with 0 bits) or a complete code.
    Returns (symbol, 0) for one symbol, else (table, bits): the table maps
    the next ``bits`` stream bits to ``symbol << 4 | length``."""
    lengths = list(lengths)
    count = [0] * 16
    for n in lengths:
        if n > 15:
            raise _Bad(1)
        count[n] += 1
    used = len(lengths) - count[0]
    if used == 0:
        raise _Bad(1)
    if used == 1:
        return next(s for s, n in enumerate(lengths) if n), 0
    if sum(count[n] << (15 - n) for n in range(1, 16)) != 1 << 15:
        raise _Bad(1)
    bits = max(n for n in range(16) if count[n])
    table = [0] * (1 << bits)
    code = 0
    for n in range(1, bits + 1):
        for s, sn in enumerate(lengths):
            if sn == n:
                r = _reverse(code, n)
                table[r::1 << n] = [(s << 4) | n] * (1 << (bits - n))
                code += 1
        code <<= 1
    return table, bits


def _read_code(br: _LBits, alphabet: int) -> tuple:
    """One prefix code (``ReadHuffmanCode``)."""
    lengths = [0] * max(alphabet, 256)
    if br.read(1):  # simple code: one or two symbols of length 1
        two = br.read(1)
        lengths[br.read(8 if br.read(1) else 1)] = 1
        if two:
            lengths[br.read(8)] = 1
        lengths = lengths[:alphabet]
    else:
        cl = [0] * 19
        for i in range(br.read(4) + 4):
            cl[CODE_LENGTH_ORDER[i]] = br.read(3)
        lcode = build_code(cl)
        if br.read(1):
            max_symbol = 2 + br.read(2 + 2 * br.read(3))
            if max_symbol > alphabet:
                raise _Bad(1)
        else:
            max_symbol = alphabet
        lengths = [0] * alphabet
        s, prev = 0, 8
        while s < alphabet:
            if max_symbol == 0:
                break
            max_symbol -= 1
            c = br.sym(lcode)
            if c < 16:
                lengths[s] = c
                s += 1
                if c:
                    prev = c
            else:
                extra, offset = ((2, 3), (3, 3), (7, 11))[c - 16]
                rep = br.read(extra) + offset
                if s + rep > alphabet:
                    raise _Bad(1)
                lengths[s:s + rep] = [prev if c == 16 else 0] * rep
                s += rep
    if br.over():
        raise _Bad(2)
    return build_code(lengths)


def _subsample(size: int, bits: int) -> int:
    return (size + (1 << bits) - 1) >> bits


def _copy_value(symbol: int, br: _LBits) -> int:
    """A length or distance prefix symbol and its extra bits -> value."""
    if symbol < 4:
        return symbol + 1
    extra = (symbol - 2) >> 1
    return ((2 + (symbol & 1)) << extra) + br.read(extra) + 1


def _plane_distance(xsize: int, code: int) -> int:
    if code > 120:
        return code - 120
    v = int(T.CODE_TO_PLANE[code - 1])
    dist = (v >> 4) * xsize + 8 - (v & 15)
    return dist if dist >= 1 else 1


def _decode_stream(br: _LBits, xsize: int, ysize: int, level0: bool,
                   alpha: bool = False):
    """``DecodeImageStream``: (ARGB pixels as a flat list, transforms),
    the transforms (level 0 only) in the order read. An ``ALPH`` stream
    (``alpha``) of one colour-indexing transform, no colour cache and
    one-symbol red, blue and alpha codes is decoded as libwebp's 8-bit
    alpha path decodes it (``DecodeAlphaData``): the end of the stream is
    checked after each symbol and is an error only where pixels are
    left, so an overrun that comes with the last pixels reads."""
    transforms = []
    seen = 0
    if level0:
        while br.read(1):
            kind = br.read(2)
            if seen & (1 << kind):
                raise _Bad(1)
            seen |= 1 << kind
            if kind in (0, 1):
                bits = br.read(3) + 2
                data, _ = _decode_stream(br, _subsample(xsize, bits),
                                         _subsample(ysize, bits), False)
                transforms.append((kind, xsize, bits, data))
            elif kind == 3:
                n = br.read(8) + 1
                bits = 0 if n > 16 else 1 if n > 4 else 2 if n > 2 else 3
                data, _ = _decode_stream(br, n, 1, False)
                # ExpandColorMap: byte-wise deltas, black past the colours.
                raw = np.asarray(data, np.uint32).view(np.uint8)
                full = np.zeros(4 << (8 >> bits), np.uint8)
                full[:4 * n] = np.cumsum(raw.reshape(n, 4).astype(np.int64),
                                         0).reshape(-1) & 0xFF
                transforms.append((kind, xsize, bits, full.view(np.uint32)))
                xsize = _subsample(xsize, bits)
            else:
                transforms.append((kind, xsize, 0, None))
    cache_bits = 0
    if br.read(1):
        cache_bits = br.read(4)
        if not 1 <= cache_bits <= 11:
            raise _Bad(1)
    hbits, himage, hxsize = 0, None, 0
    groups_n = 1
    if level0 and br.read(1):
        hbits = br.read(3) + 2
        hxsize = _subsample(xsize, hbits)
        data, _ = _decode_stream(br, hxsize, _subsample(ysize, hbits), False)
        himage = [(p >> 8) & 0xFFFF for p in data]
        groups_n = max(himage) + 1
    alphabets = (NUM_LITERAL + NUM_LENGTH + ((1 << cache_bits) if cache_bits
                                              else 0), 256, 256, 256,
                 NUM_DISTANCE)
    groups = [tuple(_read_code(br, a) for a in alphabets)
              for _ in range(groups_n)]
    eight = (alpha and level0 and [t[0] for t in transforms] == [3]
             and not cache_bits
             and all(g[1][1] == g[2][1] == g[3][1] == 0 for g in groups))
    pixels = _decode_pixels(br, xsize, ysize, groups, hbits, himage, hxsize,
                            cache_bits, eight)
    if br.over() and not eight:
        raise _Bad(2)
    return pixels, transforms


def _decode_pixels(br, xsize, ysize, groups, hbits, himage, hxsize,
                   cache_bits, eight: bool = False) -> list:
    """``DecodeImageData``: literals, backward references and colour cache
    hits into ``xsize * ysize`` ARGB values (``eight``: ``DecodeAlphaData``,
    ``_decode_alpha8``)."""
    if eight:
        return _decode_alpha8(br, xsize, ysize, groups, hbits, himage, hxsize)
    total = xsize * ysize
    out = [0] * total
    cache = [0] * (1 << cache_bits) if cache_bits else None
    shift = 32 - cache_bits
    cached = 0
    pos = x = y = 0
    group = groups[0]
    while pos < total:
        if himage is not None:
            group = groups[himage[(y >> hbits) * hxsize + (x >> hbits)]]
        code = br.sym(group[0])
        if code < NUM_LITERAL:
            red = br.sym(group[1])
            blue = br.sym(group[2])
            alpha = br.sym(group[3])
            out[pos] = (alpha << 24) | (red << 16) | (code << 8) | blue
            pos += 1
            x += 1
        elif code < NUM_LITERAL + NUM_LENGTH:
            length = _copy_value(code - NUM_LITERAL, br)
            dist = _plane_distance(xsize, _copy_value(br.sym(group[4]), br))
            if br.over():
                raise _Bad(2)
            if dist > pos or total - pos < length:
                raise _Bad(1)
            for i in range(pos, pos + length):
                out[i] = out[i - dist]
            pos += length
            x += length
        else:
            while cached < pos:
                v = out[cached]
                cache[((v * HASH_MUL) & 0xFFFFFFFF) >> shift] = v
                cached += 1
            out[pos] = cache[code - NUM_LITERAL - NUM_LENGTH]
            pos += 1
            x += 1
        while x >= xsize:
            x -= xsize
            y += 1
    return out


class _TailBits(_LBits):
    """libwebp's ``VP8LBitReader`` as it reads past its data: its 64-bit
    window holds the last bytes (``base`` is the window's first bit), a
    read at 64 bits or more into the window wraps (``val_ >> (bit_pos_ &
    63)``, the second table level of a long code apart), and once a byte shift finds the stream over (``ShiftBytes``,
    in ``VP8LReadBits`` and ``VP8LFillBitWindow``) it sets ``eos`` and
    reads again from the window's start; ``VP8LReadBits`` then gives 0.
    Before the window holds the last bytes, its reads are ``_LBits``'s."""

    def __init__(self, br: _LBits):
        super().__init__(br.data, br.pos)
        self.base = self.limit - 64
        self.eos = False

    def _at(self, ahead: int = 0) -> int:
        p = self.pos + ahead - self.base
        return self.pos + ahead if p < 64 else self.base + (p & 63)

    def _peek(self, q: int) -> int:
        return int.from_bytes(self.data[q >> 3:(q >> 3) + 4], "little") >> (
            q & 7)

    def shift(self) -> None:
        if self.pos > self.limit:
            self.eos = True
            self.pos = self.base

    def read(self, n: int) -> int:
        if self.eos:
            self.pos = self.base
            return 0
        v = self._peek(self._at())
        self.pos += n
        self.shift()
        return v & ((1 << n) - 1)

    def sym(self, code) -> int:
        table, bits = code
        if bits == 0:
            return table
        # ReadSymbol's two table levels: 8 bits, then the rest 8 bits on,
        # each prefetched (and wrapped) on its own
        v = (self._peek(self._at()) & 0xFF) | (self._peek(self._at(8)) << 8)
        e = table[v & ((1 << bits) - 1)]
        self.pos += e & 15
        return e >> 4


def _decode_alpha8(br, xsize, ysize, groups, hbits, himage, hxsize) -> list:
    """``DecodeAlphaData``, libwebp's 8-bit path for an ``ALPH`` stream: the
    green symbols and backward references read through ``_TailBits``, the
    end of the stream checked after each symbol (the loop stops there),
    an error only where pixels are left."""
    total = xsize * ysize
    out = [0] * total
    tb = _TailBits(br)
    pos = x = y = 0
    group = groups[0]
    while pos < total and not tb.eos:
        tb.shift()  # VP8LFillBitWindow
        if himage is not None:
            group = groups[himage[(y >> hbits) * hxsize + (x >> hbits)]]
        code = tb.sym(group[0])
        if code < NUM_LITERAL:
            out[pos] = ((group[3][0] << 24) | (group[1][0] << 16)
                        | (code << 8) | group[2][0])
            pos += 1
            x += 1
        elif code < NUM_LITERAL + NUM_LENGTH:
            length = _copy_value(code - NUM_LITERAL, tb)
            dsym = tb.sym(group[4])
            tb.shift()
            dist = _plane_distance(xsize, _copy_value(dsym, tb))
            if dist > pos or total - pos < length:
                raise _Bad(1)
            for i in range(pos, pos + length):
                out[i] = out[i - dist]
            pos += length
            x += length
        else:
            raise _Bad(1)
        while x >= xsize:
            x -= xsize
            y += 1
        tb.eos = tb.eos or tb.over()
    if tb.eos and pos < total:
        raise _Bad(2)
    br.pos = tb.pos
    return out


def _add_argb(a: int, b: int) -> int:
    return ((((a & 0xFF00FF00) + (b & 0xFF00FF00)) & 0xFF00FF00)
            | (((a & 0x00FF00FF) + (b & 0x00FF00FF)) & 0x00FF00FF))


def _avg2(a: int, b: int) -> int:
    return (((a ^ b) & 0xFEFEFEFE) >> 1) + (a & b)


def _clip255(v: int) -> int:
    return 0 if v < 0 else 255 if v > 255 else v


def _predict(mode: int, left: int, top: int, tl: int, tr: int) -> int:
    """VP8L predictor ``mode`` (0-13; 14 and 15 act as 0) of one pixel."""
    if mode == 1:
        return left
    if mode == 2:
        return top
    if mode == 3:
        return tr
    if mode == 4:
        return tl
    if mode == 5:
        return _avg2(_avg2(left, tr), top)
    if mode == 6:
        return _avg2(left, tl)
    if mode == 7:
        return _avg2(left, top)
    if mode == 8:
        return _avg2(tl, top)
    if mode == 9:
        return _avg2(top, tr)
    if mode == 10:
        return _avg2(_avg2(left, tl), _avg2(top, tr))
    if mode == 11:
        pa_minus_pb = 0
        for s in (24, 16, 8, 0):
            a, b, c = (top >> s) & 0xFF, (left >> s) & 0xFF, (tl >> s) & 0xFF
            pa_minus_pb += abs(b - c) - abs(a - c)
        return top if pa_minus_pb <= 0 else left
    if mode == 12:
        v = 0
        for s in (24, 16, 8, 0):
            v |= _clip255(((left >> s) & 0xFF) + ((top >> s) & 0xFF)
                          - ((tl >> s) & 0xFF)) << s
        return v
    if mode == 13:
        avg = _avg2(left, top)
        v = 0
        for s in (24, 16, 8, 0):
            a, b = (avg >> s) & 0xFF, (tl >> s) & 0xFF
            d = a - b
            d = -((-d) >> 1) if d < 0 else d >> 1  # C division, toward zero
            v |= _clip255(a + d) << s
        return v
    return 0xFF000000


def _inverse_predictor(pix: list, width: int, height: int, bits: int,
                       modes: list) -> list:
    out = [0] * (width * height)
    for y in range(height):
        row = y * width
        for x in range(width):
            i = row + x
            if y == 0:
                pred = 0xFF000000 if x == 0 else out[i - 1]
            elif x == 0:
                pred = out[i - width]
            else:
                mode = (modes[(y >> bits) * _subsample(width, bits)
                              + (x >> bits)] >> 8) & 15
                pred = _predict(mode, out[i - 1], out[i - width],
                                out[i - width - 1], out[i - width + 1])
            out[i] = _add_argb(pix[i], pred)
    return out


def _inverse_transforms(pix: list, transforms: list,
                        height: int) -> np.ndarray:
    """The transforms undone, last read first -> (height, width) uint32."""
    cur = pix
    for kind, xsize, bits, data in reversed(transforms):
        if kind == 0:
            cur = _inverse_predictor(list(map(int, cur)), xsize, height, bits,
                                     list(data))
            continue
        a = np.asarray(cur, np.uint32).reshape(height, -1)
        if kind == 2:
            g = (a >> 8) & 0xFF
            a = ((a & 0xFF00FF00) | ((((a >> 16) + g) & 0xFF) << 16)
                 | ((a + g) & 0xFF))
        elif kind == 1:
            m = np.asarray(data, np.uint32).reshape(
                _subsample(height, bits), -1)
            m = np.repeat(np.repeat(m, 1 << bits, 0), 1 << bits, 1)
            m = m[:height, :xsize]
            s8 = lambda v: (v.astype(np.int32) & 0xFF) ^ 0x80  # noqa: E731
            g2r, g2b, r2b = (s8(m) - 128, s8(m >> 8) - 128, s8(m >> 16) - 128)
            green = s8(a >> 8) - 128
            red = ((a >> 16) & 0xFF).astype(np.int32)
            red = (red + ((g2r * green) >> 5)) & 0xFF
            blue = (a & 0xFF).astype(np.int32) + ((g2b * green) >> 5)
            blue = (blue + ((r2b * (((red ^ 0x80) & 0xFF) - 128)) >> 5)) & 0xFF
            a = ((a & 0xFF00FF00) | (red.astype(np.uint32) << 16)
                 | blue.astype(np.uint32))
        else:
            idx = (a >> 8) & 0xFF
            if bits:
                per = 1 << bits
                bpp = 8 >> bits
                shifts = (np.arange(per, dtype=np.uint32) * bpp)
                idx = ((idx[:, :, None] >> shifts) & ((1 << bpp) - 1))
                idx = idx.reshape(height, -1)[:, :xsize]
            a = np.asarray(data, np.uint32)[idx]
        cur = a.reshape(-1)
    return np.asarray(cur, np.uint32).reshape(height, -1)


def vp8l_plain(data: bytes, pos: int, width: int, height: int,
               alpha: bool = False) -> tuple[np.ndarray, int]:
    """A VP8L image stream from bit ``pos`` of ``data`` (after the 5-byte
    header of a ``VP8L`` chunk, or the whole of a compressed ``ALPH``
    payload, ``alpha``) -> ((height, width) uint32 ARGB, status): 0, or a
    key of STATUS. The plain version of ``webp_scan.cpp``'s ``wpt_vp8l``."""
    br = _LBits(data, pos)
    try:
        pix, transforms = _decode_stream(br, width, height, True, alpha)
        return _inverse_transforms(pix, transforms, height), 0
    except _Bad as bad:
        return np.zeros((height, width), np.uint32), bad.status


# --- VP8 ---------------------------------------------------------------------

ZIGZAG = (0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15)
BANDS = (0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0)
CAT_PROBS = ((173, 148, 140), (176, 155, 140, 135),
             (180, 157, 141, 134, 130),
             (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129))
# libwebp's ten 4x4 modes, and the 16x16 and chroma modes among them.
B_DC, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU = range(10)


class _BoolDecoder:
    """RFC 6386's boolean decoder, as libwebp's ``VP8GetBit`` runs it
    (``range_`` kept as range - 1, bytes loaded as needed); ``eof`` is
    libwebp's flag: set when a bit is wanted with every byte used."""

    def __init__(self, data: bytes, start: int, end: int):
        self.data = data
        self.pos = start
        self.end = end
        self.value = 0
        self.bits = -8
        self.range = 254
        self.eof = False

    def bit(self, prob: int) -> int:
        rng = self.range
        if self.bits < 0:
            if self.pos < self.end:
                self.value = (self.value << 8) | self.data[self.pos]
                self.pos += 1
                self.bits += 8
            elif not self.eof:
                self.value <<= 8
                self.bits += 8
                self.eof = True
            else:
                self.bits = 0
        split = (rng * prob) >> 8
        if (self.value >> self.bits) > split:
            rng -= split
            self.value -= (split + 1) << self.bits
            bit = 1
        else:
            rng = split + 1
            bit = 0
        shift = 7 ^ (rng.bit_length() - 1)
        self.range = (rng << shift) - 1
        self.bits -= shift
        return bit

    def value_bits(self, n: int) -> int:
        v = 0
        while n > 0:
            n -= 1
            v |= self.bit(0x80) << n
        return v

    def signed_value(self, n: int) -> int:
        v = self.value_bits(n)
        return -v if self.bit(0x80) else v


def _w16(v: int) -> int:
    return ((v + 0x8000) & 0xFFFF) - 0x8000


def _clip8(v: int) -> int:
    return 0 if v < 0 else 255 if v > 255 else v


def _mul1(a: int) -> int:
    return ((a * 20091) >> 16) + a


def _mul2(a: int) -> int:
    return (a * 35468) >> 16


def _rotate(x: int, y: int) -> tuple[int, int]:
    """(MUL(x, K2) - MUL(y, K1), MUL(x, K1) + MUL(y, K2)) as
    ``Transform_SSE2`` computes them: ``_mm_mulhi_epi16`` by k1 = 20091
    and k2 = -30068 (K - 65536), plus x and y, each sum in 16 bits."""
    c = _w16(_w16(x - y) + _w16(((x * -30068) >> 16) - ((y * 20091) >> 16)))
    d = _w16(_w16(x + y) + _w16(((x * 20091) >> 16) + ((y * -30068) >> 16)))
    return c, d


def _idct_full(c: list, buf: list, at: int, stride: int) -> None:
    """libwebp's ``Transform_SSE2`` of one 4x4 block: every sum in 16-bit
    arithmetic (the C version's int sums agree unless they overflow),
    added to the prediction with unsigned saturation."""
    tmp = [0] * 16
    for i in range(4):
        i0, i1, i2, i3 = c[i], c[4 + i], c[8 + i], c[12 + i]
        a, b = _w16(i0 + i2), _w16(i0 - i2)
        cc, d = _rotate(i1, i3)
        tmp[4 * i], tmp[4 * i + 1] = _w16(a + d), _w16(b + cc)
        tmp[4 * i + 2], tmp[4 * i + 3] = _w16(b - cc), _w16(a - d)
    for i in range(4):
        t0, t1, t2, t3 = tmp[i], tmp[4 + i], tmp[8 + i], tmp[12 + i]
        dc = _w16(t0 + 4)
        a, b = _w16(dc + t2), _w16(dc - t2)
        cc, d = _rotate(t1, t3)
        row = at + i * stride
        for x, v in enumerate((_w16(a + d), _w16(b + cc), _w16(b - cc),
                               _w16(a - d))):
            buf[row + x] = _clip8(_w16(buf[row + x] + (v >> 3)))


def _idct_ac3(c: list, buf: list, at: int, stride: int) -> None:
    """libwebp's ``TransformAC3_C`` (coefficients 0, 1 and 4 only)."""
    a = c[0] + 4
    c4, d4 = _mul2(c[4]), _mul1(c[4])
    c1, d1 = _mul2(c[1]), _mul1(c[1])
    for y, dc in enumerate((a + d4, a + c4, a - c4, a - d4)):
        row = at + y * stride
        for x, v in enumerate((dc + d1, dc + c1, dc - c1, dc - d1)):
            buf[row + x] = _clip8(buf[row + x] + (v >> 3))


def _idct_dc(c: list, buf: list, at: int, stride: int) -> None:
    dc = (c[0] + 4) >> 3
    for y in range(4):
        row = at + y * stride
        for x in range(4):
            buf[row + x] = _clip8(buf[row + x] + dc)


def _wht(dc: list) -> list:
    """``TransformWHT_C``: the 16 luma DCs of an i16 macroblock (int16)."""
    tmp = [0] * 16
    out = [0] * 16
    for i in range(4):
        a0, a1 = dc[i] + dc[12 + i], dc[4 + i] + dc[8 + i]
        a2, a3 = dc[4 + i] - dc[8 + i], dc[i] - dc[12 + i]
        tmp[i], tmp[8 + i] = a0 + a1, a0 - a1
        tmp[4 + i], tmp[12 + i] = a3 + a2, a3 - a2
    for i in range(4):
        d = tmp[4 * i] + 3
        a0, a1 = d + tmp[4 * i + 3], tmp[4 * i + 1] + tmp[4 * i + 2]
        a2, a3 = tmp[4 * i + 1] - tmp[4 * i + 2], d - tmp[4 * i + 3]
        out[4 * i:4 * i + 4] = [_w16((a0 + a1) >> 3), _w16((a3 + a2) >> 3),
                                _w16((a0 - a1) >> 3), _w16((a3 - a2) >> 3)]
    return out


def _get_coeffs(br: _BoolDecoder, probs, typ: int, ctx: int, dq: tuple,
                n: int, out: list) -> int:
    """``GetCoeffs``: one block's tokens into ``out`` (natural order,
    dequantized, int16); returns libwebp's count (the position after the
    last non-zero token, or 16 after a run of zeros to the end)."""
    p = probs[typ][BANDS[n]][ctx]
    while n < 16:
        if not br.bit(p[0]):
            return n
        while not br.bit(p[1]):
            n += 1
            p = probs[typ][BANDS[n]][0]
            if n == 16:
                return 16
        nxt = probs[typ][BANDS[n + 1]]
        if not br.bit(p[2]):
            v = 1
            p = nxt[1]
        else:
            if not br.bit(p[3]):
                v = 2 if not br.bit(p[4]) else 3 + br.bit(p[5])
            elif not br.bit(p[6]):
                if not br.bit(p[7]):
                    v = 5 + br.bit(159)
                else:
                    v = 7 + 2 * br.bit(165)
                    v += br.bit(145)
            else:
                bit1 = br.bit(p[8])
                bit0 = br.bit(p[9 + bit1])
                cat = 2 * bit1 + bit0
                v = 0
                for prob in CAT_PROBS[cat]:
                    v += v + br.bit(prob)
                v += 3 + (8 << cat)
            p = nxt[2]
        sign = br.bit(0x80)
        out[ZIGZAG[n]] = _w16((-v if sign else v) * dq[n > 0])
        n += 1
    return 16


def _nz_code(nz: int, dc_nonzero: bool) -> int:
    return 3 if nz > 3 else 2 if nz > 1 else int(dc_nonzero)


def _transform(code: int, c: list, buf: list, at: int, stride: int) -> None:
    if code == 3:
        _idct_full(c, buf, at, stride)
    elif code == 2:
        _idct_ac3(c, buf, at, stride)
    elif code == 1:
        _idct_dc(c, buf, at, stride)


def _avg3(a, b, c):
    return (a + 2 * b + c + 2) >> 2


def _avg2b(a, b):
    return (a + b + 1) >> 1


def _pred4(mode: int, w: list, at: int, s: int) -> None:
    """One of libwebp's ten 4x4 luma predictions, in place at ``at`` of the
    work buffer ``w`` (row stride ``s``)."""
    top = [w[at - s + i] for i in range(-1, 8)]  # X, A..H
    X, A, B, C, D, E, F, G, H = top
    I, J, K, L = (w[at - 1 + k * s] for k in range(4))

    def put(x, y, v):
        w[at + y * s + x] = v

    if mode == B_DC:
        dc = (4 + A + B + C + D + I + J + K + L) >> 3
        for y in range(4):
            for x in range(4):
                put(x, y, dc)
    elif mode == B_TM:
        for y, left in enumerate((I, J, K, L)):
            for x, t in enumerate((A, B, C, D)):
                put(x, y, _clip8(t + left - X))
    elif mode == B_VE:
        vals = (_avg3(X, A, B), _avg3(A, B, C), _avg3(B, C, D), _avg3(C, D, E))
        for y in range(4):
            for x in range(4):
                put(x, y, vals[x])
    elif mode == B_HE:
        vals = (_avg3(X, I, J), _avg3(I, J, K), _avg3(J, K, L), _avg3(K, L, L))
        for y in range(4):
            for x in range(4):
                put(x, y, vals[y])
    elif mode == B_RD:
        d = {(0, 3): _avg3(J, K, L), (1, 3): _avg3(I, J, K),
             (0, 2): _avg3(I, J, K), (2, 3): _avg3(X, I, J),
             (1, 2): _avg3(X, I, J), (0, 1): _avg3(X, I, J)}
        for x, y in ((3, 3), (2, 2), (1, 1), (0, 0)):
            d[x, y] = _avg3(A, X, I)
        for x, y in ((3, 2), (2, 1), (1, 0)):
            d[x, y] = _avg3(B, A, X)
        for x, y in ((3, 1), (2, 0)):
            d[x, y] = _avg3(C, B, A)
        d[3, 0] = _avg3(D, C, B)
        for (x, y), v in d.items():
            put(x, y, v)
    elif mode == B_VR:
        d = {}
        d[0, 0] = d[1, 2] = _avg2b(X, A)
        d[1, 0] = d[2, 2] = _avg2b(A, B)
        d[2, 0] = d[3, 2] = _avg2b(B, C)
        d[3, 0] = _avg2b(C, D)
        d[0, 3] = _avg3(K, J, I)
        d[0, 2] = _avg3(J, I, X)
        d[0, 1] = d[1, 3] = _avg3(I, X, A)
        d[1, 1] = d[2, 3] = _avg3(X, A, B)
        d[2, 1] = d[3, 3] = _avg3(A, B, C)
        d[3, 1] = _avg3(B, C, D)
        for (x, y), v in d.items():
            put(x, y, v)
    elif mode == B_LD:
        vals = (_avg3(A, B, C), _avg3(B, C, D), _avg3(C, D, E), _avg3(D, E, F),
                _avg3(E, F, G), _avg3(F, G, H), _avg3(G, H, H))
        for y in range(4):
            for x in range(4):
                put(x, y, vals[x + y])
    elif mode == B_VL:
        d = {}
        d[0, 0] = _avg2b(A, B)
        d[1, 0] = d[0, 2] = _avg2b(B, C)
        d[2, 0] = d[1, 2] = _avg2b(C, D)
        d[3, 0] = d[2, 2] = _avg2b(D, E)
        d[0, 1] = _avg3(A, B, C)
        d[1, 1] = d[0, 3] = _avg3(B, C, D)
        d[2, 1] = d[1, 3] = _avg3(C, D, E)
        d[3, 1] = d[2, 3] = _avg3(D, E, F)
        d[3, 2] = _avg3(E, F, G)
        d[3, 3] = _avg3(F, G, H)
        for (x, y), v in d.items():
            put(x, y, v)
    elif mode == B_HD:
        d = {}
        d[0, 0] = d[2, 1] = _avg2b(I, X)
        d[0, 1] = d[2, 2] = _avg2b(J, I)
        d[0, 2] = d[2, 3] = _avg2b(K, J)
        d[0, 3] = _avg2b(L, K)
        d[3, 0] = _avg3(A, B, C)
        d[2, 0] = _avg3(X, A, B)
        d[1, 0] = d[3, 1] = _avg3(I, X, A)
        d[1, 1] = d[3, 2] = _avg3(J, I, X)
        d[1, 2] = d[3, 3] = _avg3(K, J, I)
        d[1, 3] = _avg3(L, K, J)
        for (x, y), v in d.items():
            put(x, y, v)
    else:  # B_HU
        d = {}
        d[0, 0] = _avg2b(I, J)
        d[2, 0] = d[0, 1] = _avg2b(J, K)
        d[2, 1] = d[0, 2] = _avg2b(K, L)
        d[1, 0] = _avg3(I, J, K)
        d[3, 0] = d[1, 1] = _avg3(J, K, L)
        d[3, 1] = d[1, 2] = _avg3(K, L, L)
        for x, y in ((3, 2), (2, 2), (0, 3), (1, 3), (2, 3), (3, 3)):
            d[x, y] = L
        for (x, y), v in d.items():
            put(x, y, v)


def _pred_block(mode: int, size: int, w: list, at: int, s: int, mb_x: int,
                mb_y: int) -> None:
    """A 16x16 luma or 8x8 chroma prediction (DC with libwebp's edge
    variants, TM, V, H) in place."""
    top = [w[at - s + i] for i in range(size)]
    left = [w[at - 1 + k * s] for k in range(size)]
    if mode == B_DC:
        shift = 4 if size == 16 else 3
        if mb_x > 0 and mb_y > 0:
            dc = (sum(top) + sum(left) + size) >> (shift + 1)
        elif mb_y > 0:
            dc = (sum(top) + (size >> 1)) >> shift
        elif mb_x > 0:
            dc = (sum(left) + (size >> 1)) >> shift
        else:
            dc = 0x80
        rows = [[dc] * size] * size
    elif mode == B_TM:
        tl = w[at - s - 1]
        rows = [[_clip8(t + lv - tl) for t in top] for lv in left]
    elif mode == B_VE:
        rows = [top] * size
    else:
        rows = [[lv] * size for lv in left]
    for y in range(size):
        w[at + y * s:at + y * s + size] = rows[y]


def _parse_header(br: _BoolDecoder) -> dict:
    """The frame header of RFC 6386 9.3-9.11 as libwebp parses it."""
    h = {"segment": False, "update_map": False, "absolute": True,
         "quant": [0] * 4, "filter_seg": [0] * 4, "seg_probs": [255] * 3}
    br.bit(0x80)  # colour space
    br.bit(0x80)  # clamping type (libwebp always clamps)
    if br.bit(0x80):
        h["segment"] = True
        h["update_map"] = bool(br.bit(0x80))
        if br.bit(0x80):
            h["absolute"] = bool(br.bit(0x80))
            h["quant"] = [br.signed_value(7) if br.bit(0x80) else 0
                          for _ in range(4)]
            h["filter_seg"] = [br.signed_value(6) if br.bit(0x80) else 0
                               for _ in range(4)]
        if h["update_map"]:
            h["seg_probs"] = [br.value_bits(8) if br.bit(0x80) else 255
                              for _ in range(3)]
    if br.eof:
        raise _Bad(4)
    h["simple"] = br.bit(0x80)
    h["level"] = br.value_bits(6)
    h["sharpness"] = br.value_bits(3)
    h["ref_delta"], h["mode_delta"] = [0] * 4, [0] * 4
    h["use_delta"] = br.bit(0x80)
    if h["use_delta"] and br.bit(0x80):
        for key in ("ref_delta", "mode_delta"):
            for i in range(4):
                if br.bit(0x80):
                    h[key][i] = br.signed_value(6)
    if br.eof:
        raise _Bad(4)
    h["filter_type"] = 0 if h["level"] == 0 else 1 if h["simple"] else 2
    return h


def _quant(br: _BoolDecoder, h: dict) -> list:
    """``VP8ParseQuant``: (y1, y2, uv) (dc, ac) factors per segment."""
    base = br.value_bits(7)
    deltas = [br.signed_value(4) if br.bit(0x80) else 0 for _ in range(5)]
    dqy1_dc, dqy2_dc, dqy2_ac, dquv_dc, dquv_ac = deltas
    clip = lambda v, m: 0 if v < 0 else m if v > m else v  # noqa: E731
    out = []
    for s in range(4):
        if h["segment"]:
            q = h["quant"][s] + (0 if h["absolute"] else base)
        else:
            q = base
        y2ac = (int(T.AC_TABLE[clip(q + dqy2_ac, 127)]) * 101581) >> 16
        out.append(((int(T.DC_TABLE[clip(q + dqy1_dc, 127)]),
                     int(T.AC_TABLE[clip(q, 127)])),
                    (int(T.DC_TABLE[clip(q + dqy2_dc, 127)]) * 2,
                     max(y2ac, 8)),
                    (int(T.DC_TABLE[clip(q + dquv_dc, 117)]),
                     int(T.AC_TABLE[clip(q + dquv_ac, 127)]))))
        if not h["segment"]:
            return out * 4
    return out


def _filter_strengths(h: dict) -> list:
    """``PrecomputeFilterStrengths``: per segment and i4x4, (limit,
    interior limit, hev threshold)."""
    out = []
    for s in range(4):
        if h["segment"]:
            base = h["filter_seg"][s] + (0 if h["absolute"] else h["level"])
        else:
            base = h["level"]
        pair = []
        for i4 in (0, 1):
            level = base
            if h["use_delta"]:
                level += h["ref_delta"][0]
                if i4:
                    level += h["mode_delta"][0]
            level = 0 if level < 0 else 63 if level > 63 else level
            if level > 0:
                ilevel = level
                if h["sharpness"] > 0:
                    ilevel >>= 2 if h["sharpness"] > 4 else 1
                    ilevel = min(ilevel, 9 - h["sharpness"])
                ilevel = max(ilevel, 1)
                pair.append((2 * level + ilevel, ilevel,
                             2 if level >= 40 else 1 if level >= 15 else 0))
            else:
                pair.append((0, 0, 0))
        out.append(pair)
    return out


def _sclip1(v):
    return -128 if v < -128 else 127 if v > 127 else v


def _sclip2(v):
    return -16 if v < -16 else 15 if v > 15 else v


def _filter_edge(px: list, at: int, step: int, limit: int, ilimit: int,
                 hev: int, kind: int) -> None:
    """One line across an edge: ``kind`` 0 simple, 4 inner (DoFilter4), 6
    macroblock (DoFilter6), as libwebp's C loop filters compute them."""
    p1, p0, q0, q1 = px[at - 2 * step], px[at - step], px[at], px[at + step]
    thresh2 = 2 * limit + 1
    if 4 * abs(p0 - q0) + abs(p1 - q1) > thresh2:
        return
    if kind:
        p3, p2 = px[at - 4 * step], px[at - 3 * step]
        q2, q3 = px[at + 2 * step], px[at + 3 * step]
        if (abs(p3 - p2) > ilimit or abs(p2 - p1) > ilimit
                or abs(p1 - p0) > ilimit or abs(q3 - q2) > ilimit
                or abs(q2 - q1) > ilimit or abs(q1 - q0) > ilimit):
            return
        if not (abs(p1 - p0) > hev or abs(q1 - q0) > hev):
            if kind == 4:
                a = 3 * (q0 - p0)
                a1, a2 = _sclip2((a + 4) >> 3), _sclip2((a + 3) >> 3)
                a3 = (a1 + 1) >> 1
                px[at - 2 * step] = _clip8(p1 + a3)
                px[at - step] = _clip8(p0 + a2)
                px[at] = _clip8(q0 - a1)
                px[at + step] = _clip8(q1 - a3)
            else:
                a = _sclip1(3 * (q0 - p0) + _sclip1(p1 - q1))
                a1, a2, a3 = ((27 * a + 63) >> 7, (18 * a + 63) >> 7,
                              (9 * a + 63) >> 7)
                px[at - 3 * step] = _clip8(p2 + a3)
                px[at - 2 * step] = _clip8(p1 + a2)
                px[at - step] = _clip8(p0 + a1)
                px[at] = _clip8(q0 - a1)
                px[at + step] = _clip8(q1 - a2)
                px[at + 2 * step] = _clip8(q2 - a3)
            return
    a = 3 * (q0 - p0) + _sclip1(p1 - q1)
    a1, a2 = _sclip2((a + 4) >> 3), _sclip2((a + 3) >> 3)
    px[at - step] = _clip8(p0 + a2)
    px[at] = _clip8(q0 - a1)


def _loop_filter(planes, strides, finfo, mb_w, mb_h, ftype) -> None:
    """``DoFilter`` over every macroblock in raster order: left edge, inner
    vertical edges, top edge, inner horizontal edges; luma, then (normal
    filter only) chroma."""
    for mb_y in range(mb_h):
        for mb_x in range(mb_w):
            limit, ilevel, hev, inner = finfo[mb_y * mb_w + mb_x]
            if limit == 0:
                continue
            for p, (px, s) in enumerate(zip(planes, strides)):
                if p and ftype == 1:
                    break
                size = 16 if p == 0 else 8
                base = mb_y * size * s + mb_x * size
                simple = ftype == 1
                # vertical edges (filtering across columns)
                edges = []
                if mb_x > 0:
                    edges.append((0, limit + 4, 0 if simple else 6))
                if inner:
                    edges += [(x, limit, 0 if simple else 4)
                              for x in ((4, 8, 12) if size == 16 else (4,))]
                for x, lim, kind in edges:
                    for i in range(size):
                        _filter_edge(px, base + i * s + x, 1, lim, ilevel,
                                     hev, kind)
                edges = []
                if mb_y > 0:
                    edges.append((0, limit + 4, 0 if simple else 6))
                if inner:
                    edges += [(y, limit, 0 if simple else 4)
                              for y in ((4, 8, 12) if size == 16 else (4,))]
                for y, lim, kind in edges:
                    for i in range(size):
                        _filter_edge(px, base + y * s + i, s, lim, ilevel,
                                     hev, kind)


def vp8_plain(data: bytes, width: int, height: int
              ) -> tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """A VP8 key frame (the ``VP8 `` chunk's payload, its padding byte
    included) -> (Y, U, V) uint8 planes of whole macroblocks, and a status:
    0, or a key of STATUS. The plain version of ``webp_scan.cpp``'s
    ``wpt_vp8``; ``decode_vp8_frame`` has checked the 10-byte frame tag."""
    mb_w, mb_h = (width + 15) >> 4, (height + 15) >> 4
    ys, uvs = 16 * mb_w, 8 * mb_w
    Y = [0] * (ys * 16 * mb_h)
    U = [0] * (uvs * 8 * mb_h)
    V = [0] * (uvs * 8 * mb_h)

    def fail(status):
        return (np.zeros((16 * mb_h, ys), np.uint8),
                np.zeros((8 * mb_h, uvs), np.uint8),
                np.zeros((8 * mb_h, uvs), np.uint8), status)

    n = len(data)
    first = (data[0] | (data[1] << 8) | (data[2] << 16)) >> 5
    if first > n - 10:
        return fail(3)
    br = _BoolDecoder(data, 10, 10 + first)
    try:
        h = _parse_header(br)
    except _Bad as bad:
        return fail(bad.status)
    # Token partitions (ParsePartitions).
    parts_n = 1 << br.value_bits(2)
    rest = 10 + first
    size = n - rest
    if size < 3 * (parts_n - 1):
        return fail(3)
    start = rest + 3 * (parts_n - 1)
    left = size - 3 * (parts_n - 1)
    parts = []
    for p in range(parts_n - 1):
        ps = data[rest + 3 * p] | (data[rest + 3 * p + 1] << 8) | (
            data[rest + 3 * p + 2] << 16)
        ps = min(ps, left)
        parts.append(_BoolDecoder(data, start, start + ps))
        start += ps
        left -= ps
    parts.append(_BoolDecoder(data, start, n))
    if start >= n:
        return fail(3)
    dq = _quant(br, h)
    br.bit(0x80)  # refresh entropy probs: ignored
    probs = [[[[0] * 11 for _ in range(3)] for _ in range(8)]
             for _ in range(4)]
    for t in range(4):
        for b in range(8):
            for c in range(3):
                for p in range(11):
                    probs[t][b][c][p] = (br.value_bits(8) if br.bit(
                        int(T.COEFF_UPDATE[t, b, c, p]))
                        else int(T.COEFF_PROBA0[t, b, c, p]))
    use_skip = br.bit(0x80)
    skip_p = br.value_bits(8) if use_skip else 0
    fstr = _filter_strengths(h)
    bmodes = T.BMODES_PROBA.tolist()

    intra_t = [B_DC] * (4 * mb_w)
    nz_top = [0] * mb_w  # per macroblock: luma bits 0-3, u 4-5, v 6-7
    nz_dc_top = [0] * mb_w
    top_y = [[127] * 16 for _ in range(mb_w)]
    top_u = [[127] * 8 for _ in range(mb_w)]
    top_v = [[127] * 8 for _ in range(mb_w)]
    finfo = []
    S = 21  # work buffer: row 0 the top edge, column 0 the left edge
    CS = 9
    for mb_y in range(mb_h):
        # Intra modes of the row (partition 0).
        modes = []
        intra_l = [B_DC] * 4
        for mb_x in range(mb_w):
            if h["update_map"]:
                sp = h["seg_probs"]
                seg = (br.bit(sp[1]) if not br.bit(sp[0])
                       else br.bit(sp[2]) + 2)
            else:
                seg = 0
            skip = br.bit(skip_p) if use_skip else 0
            i4 = not br.bit(145)
            top = intra_t[4 * mb_x:4 * mb_x + 4]
            if not i4:
                ymode = ((B_TM if br.bit(128) else B_HE) if br.bit(156)
                         else (B_VE if br.bit(163) else B_DC))
                imodes = [ymode]
                top = [ymode] * 4
                intra_l = [ymode] * 4
            else:
                imodes = []
                for y in range(4):
                    ym = intra_l[y]
                    for x in range(4):
                        prob = bmodes[top[x]][ym]
                        if not br.bit(prob[0]):
                            ym = B_DC
                        elif not br.bit(prob[1]):
                            ym = B_TM
                        elif not br.bit(prob[2]):
                            ym = B_VE
                        elif not br.bit(prob[3]):
                            ym = (B_HE if not br.bit(prob[4]) else
                                  B_RD if not br.bit(prob[5]) else B_VR)
                        elif not br.bit(prob[6]):
                            ym = B_LD
                        elif not br.bit(prob[7]):
                            ym = B_VL
                        else:
                            ym = B_HD if not br.bit(prob[8]) else B_HU
                        top[x] = ym
                    imodes += top
                    intra_l[y] = ym
            intra_t[4 * mb_x:4 * mb_x + 4] = top
            uvmode = (B_DC if not br.bit(142) else B_VE if not br.bit(114)
                      else B_TM if br.bit(183) else B_HE)
            modes.append((seg, skip, i4, imodes, uvmode))
        if br.eof:
            return fail(3)
        # Tokens and reconstruction of the row.
        tb = parts[mb_y & (parts_n - 1)]
        nz_left, nz_dc_left = 0, 0
        wy = [0] * (S * 17)
        wu = [0] * (CS * 9)
        wv = [0] * (CS * 9)
        for mb_x in range(mb_w):
            seg, skip, i4, imodes, uvmode = modes[mb_x]
            q = dq[seg]
            coeffs = [[0] * 16 for _ in range(24)]
            nzy = nzuv = 0
            codes = [0] * 24
            if not (use_skip and skip):
                first_c = 0
                if not i4:
                    dc = [0] * 16
                    ctx = nz_dc_top[mb_x] + nz_dc_left
                    nz = _get_coeffs(tb, probs, 1, ctx, q[1], 0, dc)
                    nz_dc_top[mb_x] = nz_dc_left = int(nz > 0)
                    if nz > 1:
                        dcs = _wht(dc)
                    else:
                        dcs = [_w16((dc[0] + 3) >> 3)] * 16
                    for i in range(16):
                        coeffs[i][0] = dcs[i]
                    first_c, typ = 1, 0
                else:
                    typ = 3
                tnz = nz_top[mb_x] & 0x0F
                lnz = nz_left & 0x0F
                for y in range(4):
                    lb = (lnz >> y) & 1
                    for x in range(4):
                        ctx = lb + ((tnz >> x) & 1)
                        blk = coeffs[4 * y + x]
                        nz = _get_coeffs(tb, probs, typ, ctx, q[0], first_c,
                                         blk)
                        lb = int(nz > first_c)
                        tnz = (tnz & ~(1 << x)) | (lb << x)
                        codes[4 * y + x] = _nz_code(nz, blk[0] != 0)
                    lnz = (lnz & ~(1 << y)) | (lb << y)
                nzy = any(codes[:16])
                out_t, out_l = tnz, lnz
                for ch in (0, 1):
                    tnz = (nz_top[mb_x] >> (4 + 2 * ch)) & 3
                    lnz = (nz_left >> (4 + 2 * ch)) & 3
                    for y in range(2):
                        lb = (lnz >> y) & 1
                        for x in range(2):
                            ctx = lb + ((tnz >> x) & 1)
                            k = 16 + 4 * ch + 2 * y + x
                            nz = _get_coeffs(tb, probs, 2, ctx, q[2], 0,
                                             coeffs[k])
                            lb = int(nz > 0)
                            tnz = (tnz & ~(1 << x)) | (lb << x)
                            codes[k] = _nz_code(nz, coeffs[k][0] != 0)
                        lnz = (lnz & ~(1 << y)) | (lb << y)
                    out_t |= tnz << (4 + 2 * ch)
                    out_l |= lnz << (4 + 2 * ch)
                nzuv = any(codes[16:])
                nz_top[mb_x], nz_left = out_t, out_l
                not_skipped = bool(nzy or nzuv)
            else:
                nz_top[mb_x] = nz_left = 0
                if not i4:
                    nz_dc_top[mb_x] = nz_dc_left = 0
                not_skipped = False
            if h["filter_type"]:
                limit, ilevel, hev = fstr[seg][int(i4)]
                finfo.append((limit, ilevel, hev, int(i4) | not_skipped))
            # Work buffer edges (ReconstructRow).
            if mb_x == 0:
                for r in range(1, 17):
                    wy[r * S] = 129
                for r in range(1, 9):
                    wu[r * CS] = wv[r * CS] = 129
                corner = 129 if mb_y > 0 else 127
                wy[0] = wu[0] = wv[0] = corner
            else:
                for r in range(17):
                    wy[r * S] = wy[r * S + 16]
                for r in range(9):
                    wu[r * CS] = wu[r * CS + 8]
                    wv[r * CS] = wv[r * CS + 8]
            wy[1:17] = top_y[mb_x]
            wu[1:9] = top_u[mb_x]
            wv[1:9] = top_v[mb_x]
            if mb_y == 0:
                wy[17:21] = [127] * 4
            elif mb_x == mb_w - 1:
                wy[17:21] = [top_y[mb_x][15]] * 4
            else:
                wy[17:21] = top_y[mb_x + 1][:4]
            if i4:
                for r in (4, 8, 12):
                    wy[r * S + 17:r * S + 21] = wy[17:21]
                for k in range(16):
                    at = (1 + 4 * (k >> 2)) * S + 1 + 4 * (k & 3)
                    _pred4(imodes[k], wy, at, S)
                    _transform(codes[k], coeffs[k], wy, at, S)
            else:
                _pred_block(imodes[0], 16, wy, S + 1, S, mb_x, mb_y)
                for k in range(16):
                    at = (1 + 4 * (k >> 2)) * S + 1 + 4 * (k & 3)
                    _transform(codes[k], coeffs[k], wy, at, S)
            for wbuf, base in ((wu, 16), (wv, 20)):
                _pred_block(uvmode, 8, wbuf, CS + 1, CS, mb_x, mb_y)
                # DoUVTransform: all four blocks by the full transform if
                # any has AC coefficients, else by the DC-only one.
                uv = codes[base:base + 4]
                if any(uv):
                    code = 3 if max(uv) >= 2 else 1
                    for k in range(4):
                        at = (1 + 4 * (k >> 1)) * CS + 1 + 4 * (k & 1)
                        _transform(code, coeffs[base + k], wbuf, at, CS)
            if mb_y < mb_h - 1:
                top_y[mb_x] = wy[16 * S + 1:16 * S + 17]
                top_u[mb_x] = wu[8 * CS + 1:8 * CS + 9]
                top_v[mb_x] = wv[8 * CS + 1:8 * CS + 9]
            for r in range(16):
                o = (mb_y * 16 + r) * ys + mb_x * 16
                Y[o:o + 16] = wy[(r + 1) * S + 1:(r + 1) * S + 17]
            for r in range(8):
                o = (mb_y * 8 + r) * uvs + mb_x * 8
                U[o:o + 8] = wu[(r + 1) * CS + 1:(r + 1) * CS + 9]
                V[o:o + 8] = wv[(r + 1) * CS + 1:(r + 1) * CS + 9]
            if tb.eof:
                return fail(3)
    if h["filter_type"]:
        _loop_filter((Y, U, V), (ys, uvs, uvs), finfo, mb_w, mb_h,
                     h["filter_type"])
    return (np.asarray(Y, np.uint8).reshape(16 * mb_h, ys),
            np.asarray(U, np.uint8).reshape(8 * mb_h, uvs),
            np.asarray(V, np.uint8).reshape(8 * mb_h, uvs), 0)


def _upsample_line(top: np.ndarray, cur: np.ndarray, width: int,
                   bottom: bool) -> np.ndarray:
    """libwebp's ``UpsampleRgbaLinePair`` chroma for one output line from
    the chroma rows above (``top``) and below (``cur``) it: (width,)."""
    t = top.astype(np.int32)
    c = cur.astype(np.int32)
    out = np.empty(width, np.int32)
    near, far = (c, t) if bottom else (t, c)
    out[0] = (3 * near[0] + far[0] + 2) >> 2
    pairs = (width - 1) >> 1
    if pairs:
        tl, tt = t[:pairs], t[1:pairs + 1]
        ll, uv = c[:pairs], c[1:pairs + 1]
        avg = tl + tt + ll + uv + 8
        d12 = (avg + 2 * (tt + ll)) >> 3
        d03 = (avg + 2 * (tl + uv)) >> 3
        if bottom:
            out[1:2 * pairs:2] = (d03 + ll) >> 1
            out[2:2 * pairs + 1:2] = (d12 + uv) >> 1
        else:
            out[1:2 * pairs:2] = (d12 + tl) >> 1
            out[2:2 * pairs + 1:2] = (d03 + tt) >> 1
    if not width & 1:
        out[width - 1] = (3 * near[pairs] + far[pairs] + 2) >> 2
    return out


def _upsample(plane: np.ndarray, width: int, height: int) -> np.ndarray:
    """A chroma plane to (height, width) as ``EmitFancyRGB`` pairs its
    rows: row 0 from chroma row 0 alone, rows 2k-1 and 2k from chroma rows
    k-1 and k, and the last row of an even height from the last chroma
    row alone."""
    out = np.empty((height, width), np.int32)
    for y in range(height):
        if y == 0 or (height % 2 == 0 and y == height - 1):
            r = 0 if y == 0 else height // 2 - 1
            out[y] = _upsample_line(plane[r], plane[r], width, False)
        elif y & 1:
            out[y] = _upsample_line(plane[(y - 1) // 2], plane[(y + 1) // 2],
                                    width, False)
        else:
            out[y] = _upsample_line(plane[y // 2 - 1], plane[y // 2], width,
                                    True)
    return out


def yuv_to_rgb_plain(Y: np.ndarray, U: np.ndarray, V: np.ndarray,
                     width: int, height: int) -> np.ndarray:
    """Decoded planes -> (height, width, 3) uint8 RGB: libwebp's fancy
    upsampling of U and V, then ``VP8YUVToR/G/B`` in its fixed point
    (``MultHi``, then ``VP8Clip8`` of 6 fraction bits). The plain version
    of ``webp_scan.cpp``'s ``wpt_yuv_to_rgb``."""
    u = _upsample(U, width, height)
    v = _upsample(V, width, height)
    y = Y[:height, :width].astype(np.int32)

    def mult_hi(a, k):
        return (a * k) >> 8

    def clip8(a):
        return np.where((a & ~((256 << 6) - 1)) == 0, a >> 6,
                        np.where(a < 0, 0, 255))

    yy = mult_hi(y, 19077)
    r = clip8(yy + mult_hi(v, 26149) - 14234)
    g = clip8(yy - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708)
    b = clip8(yy + mult_hi(u, 33050) - 17685)
    return np.stack([r, g, b], -1).astype(np.uint8)


def unfilter_plain(rows: np.ndarray, method: int) -> np.ndarray:
    """An alpha plane's filtered values (height, width) uint8 -> the alpha:
    ``method`` 0 none, 1 horizontal, 2 vertical, 3 gradient, as libwebp's
    ``WebPUnfilters`` undo them row by row. The plain version of
    ``webp_scan.cpp``'s ``wpt_alpha_unfilter``."""
    if method == 0:
        return rows.copy()
    h, w = rows.shape
    out = np.zeros((h, w), np.uint8)
    prev = None
    for y in range(h):
        line = rows[y].astype(np.int32)
        dst = [0] * w
        if prev is None or method == 1:
            pred = 0 if prev is None else int(prev[0])
            for x in range(w):
                pred = (pred + int(line[x])) & 0xFF
                dst[x] = pred
        elif method == 2:
            dst = list((prev.astype(np.int32) + line) & 0xFF)
        else:
            top = tl = left = int(prev[0])
            for x in range(w):
                top = int(prev[x])
                g = left + top - tl
                g = 0 if g < 0 else 255 if g > 255 else g
                left = (int(line[x]) + g) & 0xFF
                tl = top
                dst[x] = left
        out[y] = dst
        prev = out[y]
    return out


# --- the native twins -------------------------------------------------------


def _vp8l(data: bytes, pos: int, width: int, height: int,
          alpha: bool = False):
    from wgpu_path_tracing_tpu_torch.accel import native

    if native.native_available():
        return native.vp8l_native(data, pos, width, height, alpha)
    return vp8l_plain(data, pos, width, height, alpha)


def _vp8(data: bytes, width: int, height: int):
    from wgpu_path_tracing_tpu_torch.accel import native

    if native.native_available():
        return native.vp8_native(data, width, height)
    return vp8_plain(data, width, height)


def _to_rgb(Y, U, V, width, height):
    from wgpu_path_tracing_tpu_torch.accel import native

    if native.native_available():
        return native.yuv_to_rgb_native(Y, U, V, width, height)
    return yuv_to_rgb_plain(Y, U, V, width, height)


def _unfilter(rows, method):
    from wgpu_path_tracing_tpu_torch.accel import native

    if native.native_available():
        return native.alpha_unfilter_native(rows, method)
    return unfilter_plain(rows, method)


# --- frames ------------------------------------------------------------------


def vp8_info(payload: bytes, size: int) -> tuple[int, int] | None:
    """``VP8GetInfo``: (width, height) of a key frame whose 10-byte tag
    passes libwebp's checks against the chunk's ``size``, else None."""
    if len(payload) < 10 or payload[3:6] != b"\x9d\x01\x2a":
        return None
    bits = payload[0] | (payload[1] << 8) | (payload[2] << 16)
    w = (payload[6] | (payload[7] << 8)) & 0x3FFF
    h = (payload[8] | (payload[9] << 8)) & 0x3FFF
    if (bits & 1 or ((bits >> 1) & 7) > 3 or not (bits >> 4) & 1
            or (bits >> 5) >= size or w == 0 or h == 0):
        return None
    return w, h


def vp8l_info(payload: bytes) -> tuple[int, int, int] | None:
    """``VP8LGetInfo``: (width, height, alpha_is_used) of a VP8L header
    whose signature and version pass, else None."""
    if len(payload) < 5 or payload[0] != 0x2F or payload[4] >> 5:
        return None
    v = int.from_bytes(payload[1:5], "little")
    return (v & 0x3FFF) + 1, ((v >> 14) & 0x3FFF) + 1, (v >> 28) & 1


def decode_vp8l_frame(payload: bytes, name: str) -> np.ndarray:
    """A ``VP8L`` chunk's payload -> (H, W, 4) uint8 RGBA."""
    info = vp8l_info(payload)
    if info is None:
        raise ValueError(f"{name}: bad VP8L header")
    w, h, _ = info
    argb, status = _vp8l(payload, 40, w, h)
    if status:
        raise ValueError(f"{name}: {STATUS[status]}")
    a = argb.reshape(h, w)
    return np.stack([(a >> 16) & 0xFF, (a >> 8) & 0xFF, a & 0xFF, a >> 24],
                    -1).astype(np.uint8)


def decode_alpha(alph: bytes, width: int, height: int, name: str
                 ) -> np.ndarray:
    """An ``ALPH`` payload -> (height, width) uint8 alpha (``ALPHInit``,
    ``ALPHDecode``)."""
    if len(alph) <= 1:
        raise ValueError(f"{name}: empty ALPH chunk")
    method, filt, pre, rsrv = (alph[0] & 3, (alph[0] >> 2) & 3,
                               (alph[0] >> 4) & 3, alph[0] >> 6)
    if method > 1 or pre > 1 or rsrv:
        raise ValueError(f"{name}: bad ALPH header ({alph[0]:#04x})")
    body = alph[1:]
    if method == 0:
        if len(body) < width * height:
            raise ValueError(f"{name}: the ALPH data is too short")
        rows = np.frombuffer(body, np.uint8, width * height).reshape(
            height, width)
    else:
        argb, status = _vp8l(body, 0, width, height, alpha=True)
        if status:
            raise ValueError(f"{name}: alpha: {STATUS[status]}")
        rows = ((argb >> 8) & 0xFF).astype(np.uint8).reshape(height, width)
    return _unfilter(rows, filt)


def decode_vp8_frame(payload: bytes, size: int, alph: bytes | None,
                     name: str) -> np.ndarray:
    """A ``VP8 `` chunk's payload (and its ``ALPH`` payload, if any) ->
    (H, W, 4) uint8 RGBA, as ``WebPDecode`` writes MODE_RGBA."""
    info = vp8_info(payload, size)
    if info is None:
        raise ValueError(f"{name}: bad VP8 frame header")
    w, h = info
    Y, U, V, status = _vp8(payload, w, h)
    if status:
        raise ValueError(f"{name}: {STATUS[status]}")
    rgba = np.empty((h, w, 4), np.uint8)
    rgba[..., :3] = _to_rgb(Y, U, V, w, h)
    rgba[..., 3] = 255 if alph is None else decode_alpha(alph, w, h, name)
    return rgba


# --- the container -----------------------------------------------------------


def _u24(b: bytes, at: int) -> int:
    return b[at] | (b[at + 1] << 8) | (b[at + 2] << 16)


def _features(kind: bytes, payload: bytes, size: int):
    """``WebPGetFeatures`` of one image chunk: (width, height, has_alpha),
    or None where it fails."""
    if kind == b"VP8L":
        return vp8l_info(payload)
    info = vp8_info(payload, size)
    return None if info is None else (*info, 0)


def _store_frame(buf: bytes, at: int, end: int, frame: dict) -> int:
    """``StoreFrame``: the ALPH and image chunks of one frame from ``at``;
    returns where parsing goes on. Raises ValueError on a parse error."""
    alpha_n = image_n = 0
    if end - at < 8:
        raise ValueError("need more data")
    while True:
        fourcc = buf[at:at + 4]
        size = struct.unpack_from("<I", buf, at + 4)[0]
        if size > MAX_CHUNK_PAYLOAD:
            raise ValueError("bad chunk size")
        padded = size + (size & 1)
        if padded > end - at - 8:
            raise ValueError("a chunk passes the RIFF size")
        body = buf[at + 8:at + 8 + padded]
        if fourcc == b"ALPH" and alpha_n == 0:
            alpha_n = 1
            frame["alpha"] = (at, body)
            frame["num"] = True
        elif fourcc in (b"VP8 ", b"VP8L") and not (
                fourcc == b"VP8L" and alpha_n) and image_n == 0:
            feat = _features(fourcc, body, size)
            if feat is None:
                raise ValueError("bad image chunk")
            image_n = 1
            frame["image"] = (at, fourcc, body, size)
            frame["size"] = feat[:2]
            frame["has_alpha"] = frame.get("has_alpha", 0) | feat[2]
            frame["num"] = True
        elif fourcc == b"VP8L" and alpha_n:
            raise ValueError("VP8L after ALPH")
        else:
            return at
        at += 8 + padded
        if at == end:
            return at
        if end - at < 8:
            raise ValueError("need more data")


def parse_container(data: bytes) -> dict:
    """``WebPDemux`` of a whole file, its checks copied: the canvas, the
    VP8X flags and the frames (offsets, sizes, chunks). Raises ValueError
    where libwebp's demuxer fails."""
    if len(data) < 20 or data[:4] != b"RIFF" or data[8:12] != b"WEBP":
        raise ValueError("not a RIFF WEBP file")
    riff = struct.unpack_from("<I", data, 4)[0]
    if riff < 8 or riff > MAX_CHUNK_PAYLOAD:
        raise ValueError("bad RIFF size")
    end = riff + 8
    if len(data) < end:
        raise ValueError("the file is shorter than its RIFF size")
    buf = data[:end]
    first = buf[12:16]
    frames = []
    flags = 0
    if first in (b"VP8 ", b"VP8L"):
        frame: dict = {"x": 0, "y": 0}
        _store_frame(buf, 12, end, frame)
        if "image" not in frame:
            raise ValueError("no image")
        frame.pop("alpha", None)  # no ALPHA flag: alpha is dropped
        frames.append(frame)
        canvas = frame["size"]
        flags = ALPHA_FLAG if frame["has_alpha"] else 0
        return {"canvas": canvas, "flags": flags, "frames": frames,
                "extended": False}
    # VP8X: Pillow's decoder refuses any other size than 10
    vsize = struct.unpack_from("<I", buf, 16)[0]
    if vsize != 10 or end - 20 < 10:
        raise ValueError("bad VP8X chunk")
    flags = buf[20]
    canvas = (1 + _u24(buf, 24), 1 + _u24(buf, 27))
    if canvas[0] * canvas[1] >= 1 << 32:
        raise ValueError("canvas too large")
    at = 30
    if end - at < 8:
        raise ValueError("no chunk after VP8X")
    anim = bool(flags & ANIMATION_FLAG)
    anim_chunks = 0
    while True:
        fourcc = buf[at:at + 4]
        size = struct.unpack_from("<I", buf, at + 4)[0]
        if size > MAX_CHUNK_PAYLOAD:
            raise ValueError("bad chunk size")
        padded = size + (size & 1)
        if padded > end - at - 8:
            raise ValueError("a chunk passes the RIFF size")
        if fourcc == b"VP8X":
            raise ValueError("a second VP8X chunk")
        if fourcc in (b"ALPH", b"VP8 ", b"VP8L"):
            if anim_chunks or anim or frames:
                raise ValueError("an image chunk outside a frame")
            frame = {"x": 0, "y": 0}
            at = _store_frame(buf, at, end, frame)
            if "image" in frame or "alpha" in frame:
                if not flags & ALPHA_FLAG:
                    frame.pop("alpha", None)
                frames.append(frame)
        elif fourcc == b"ANIM":
            if padded < 6:
                raise ValueError("bad ANIM chunk")
            anim_chunks += 1
            at += 8 + padded
        elif fourcc == b"ANMF":
            if not anim_chunks:
                raise ValueError("ANMF before ANIM")
            if padded < 16 or end - at - 8 < 16:
                raise ValueError("bad ANMF chunk")
            body_at = at + 8
            frame = {"x": 2 * _u24(buf, body_at),
                     "y": 2 * _u24(buf, body_at + 3),
                     "anmf_size": (1 + _u24(buf, body_at + 6),
                                   1 + _u24(buf, body_at + 9))}
            if frame["anmf_size"][0] * frame["anmf_size"][1] >= 1 << 32:
                raise ValueError("frame too large")
            start = body_at + 16
            if end - start < 8 or end - start < padded - 16:
                raise ValueError("need more data")
            at = _store_frame(buf, start, end, frame)
            if at - start > padded - 16:
                raise ValueError("frame chunks pass their ANMF")
            if anim and frame.get("num"):
                if frames and "image" not in frames[-1]:
                    raise ValueError("incomplete frame")
                frames.append(frame)
        else:
            at += 8 + padded
        if at == end:
            break
        if end - at < 8:
            raise ValueError("need more data")
    if flags & ~ALL_VALID_FLAGS or not frames:
        raise ValueError("bad VP8X flags or no frame")
    for i, frame in enumerate(frames):
        if not anim and i > 0:
            raise ValueError("frames in a still image")
        if "image" not in frame:
            raise ValueError("a frame without an image")
        if "alpha" in frame and frame["alpha"][0] > frame["image"][0]:
            raise ValueError("ALPH after the image")
        w, h = frame["size"]
        if anim:
            # StoreFrame takes the bitstream's size over ANMF's own fields.
            if frame["x"] + w > canvas[0] or frame["y"] + h > canvas[1]:
                raise ValueError("frame outside the canvas")
        elif (w, h) != canvas:
            raise ValueError("image size differs from the canvas")
    return {"canvas": canvas, "flags": flags, "frames": frames,
            "extended": True}


def _has_alpha(data: bytes, info: dict) -> bool:
    """``WebPGetFeatures(...).has_alpha`` of the whole file (Pillow's mode:
    "RGBA" if set, else "RGB")."""
    if not info["extended"]:
        return bool(info["flags"] & ALPHA_FLAG)
    if info["flags"] & ANIMATION_FLAG:
        return bool(info["flags"] & ALPHA_FLAG)
    frame = info["frames"][0]
    # ParseOptionalChunks sees every ALPH chunk before the image.
    found = False
    at = 30
    while at < frame["image"][0]:
        if data[at:at + 4] == b"ALPH":
            found = True
        size = struct.unpack_from("<I", data, at + 4)[0]
        at += 8 + size + (size & 1)
    if frame["image"][1] == b"VP8L":
        return bool(vp8l_info(frame["image"][2])[2]) or found
    return bool(info["flags"] & ALPHA_FLAG) or found


def decode_webp_rgba(data: bytes, name: str = "image") -> np.ndarray:
    """WebP bytes -> (H, W, 4) uint8 RGBA, what Pillow's
    ``Image.open(...).convert("RGBA")`` returns: the first frame on its
    canvas, in Pillow's mode."""
    try:
        info = parse_container(data)
    except ValueError as exc:
        raise ValueError(f"{name}: WebPDemux refuses the file ({exc})"
                         ) from None
    cw, ch = info["canvas"]
    bomb_check(cw, ch, name)
    frame = info["frames"][0]
    _, fourcc, body, size = frame["image"]
    if fourcc == b"VP8L":
        rgba = decode_vp8l_frame(body, name)
    else:
        alph = frame.get("alpha")
        rgba = decode_vp8_frame(body, size, None if alph is None else
                                _alph_payload(data, alph[0]), name)
    canvas = np.zeros((ch, cw, 4), np.uint8)
    fh, fw = rgba.shape[:2]
    canvas[frame["y"]:frame["y"] + fh, frame["x"]:frame["x"] + fw] = rgba
    if not _has_alpha(data, info):
        canvas[..., 3] = 255
    return canvas


def _alph_payload(data: bytes, at: int) -> bytes:
    """An ALPH chunk's payload as ``WebPDecode`` sees it (its pad byte
    excluded: the chunk's own size)."""
    size = struct.unpack_from("<I", data, at + 4)[0]
    return data[at + 8:at + 8 + size]
