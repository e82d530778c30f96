"""JPEG decoding in NumPy, the pixels Pillow gives.

The JAX package reads JPEG textures and LDR environment maps with Pillow
(``Image.open(...).convert("RGBA")``), which decodes with libjpeg-turbo at
its defaults. This module decodes the same files to the same bytes:

* frames: baseline and extended sequential Huffman (SOF0, SOF1),
  progressive Huffman (SOF2), lossless Huffman (SOF3) and sequential and
  progressive arithmetic-coded (SOF9, SOF10) at 8 bits, one scan or
  several, interleaved or not, with restart intervals (DRI, RSTn), several
  DQT, DHT and DAC segments, any size. Progressive scans follow
  ``jdphuff.c`` and ``jdarith.c``: DC first and refinement, AC first and
  AC refinement, any scan script libjpeg accepts (its warnings change
  nothing, its errors raise); arithmetic-coded data that proves bad leaves
  the rest of its restart interval undecoded, as ``jdarith.c`` does;
* lossless frames as ``jdlhuff.c``, ``jddiffct.c`` and ``jdlossls.c``
  decode them: predictors 1-7, the point transform, differences mod 2^16,
  the prediction restarting at the first row of the iMCU row a restart
  falls in, restart intervals of whole MCU rows only, replication for
  upsampling, and no colour conversion (three components are RGB unless a
  JFIF or Adobe marker says YCbCr, which libjpeg-turbo refuses, as it
  refuses YCCK);
* components: 1 (gray, replicated, alpha 255), 3: YCbCr, or RGB where an
  Adobe marker says transform 0 (or, with neither a JFIF nor an Adobe
  marker, the component ids are 'R', 'G', 'B'), as libjpeg guesses; or 4:
  CMYK without an Adobe marker or under transform 0, YCCK under any other
  transform (``jdcolor.c``'s ``ycck_cmyk_convert``), then Pillow's
  "CMYK;I" inversion and its ``cmyk2rgb``;
* every sampling factor libjpeg accepts (integer ratios to the largest);
* libjpeg-turbo's default arithmetic: the integer IDCT (``JDCT_ISLOW``:
  CONST_BITS 13, PASS1_BITS 2) as its SIMD version computes it in 16-bit
  lanes (``idct_islow``), ``jdsample.c``'s fancy (triangle) upsampling for
  h2v1, h1v2 and h2v2 with its alternating rounding bias (box replication
  for a component two samples wide or less under h2v1 and h2v2, and for
  other ratios), ``jdcolor.c``'s fixed-point YCbCr tables, and
  ``jdcoefct.c``'s block smoothing (libjpeg-turbo 2.1 and later:
  coefficients 1-9 estimated from a 5x5 neighbourhood of DC values) where
  a progressive file, Huffman- or arithmetic-coded, leaves bits of those
  coefficients unsent.

EXIF orientation is ignored, as ``Image.open`` ignores it. Hierarchical,
arithmetic-coded lossless and other than 8-bit files, DNL heights and
fractional sampling ratios raise ``NotImplementedError`` naming the image,
as Pillow refuses them; truncated or malformed data raises ``ValueError``
naming it. Pillow also refuses an arithmetic-coded file whose data runs
past its first 64 KiB read (libjpeg's arithmetic decoder cannot wait for
more input); this module reads it, as Pillow does when handed the whole
file at once.

The entropy decode is serial. ``decode_scan`` (sequential), the four
progressive MCU decoders, ``decode_arith_scan`` and
``decode_lossless_scan`` walk the bits (or the binary decisions) in
Python; they, and ``undifference``, are the plain version of
``accel/cbvh/jpeg_scan.cpp``, which the native library runs wherever
``accel.native.native_available()`` (``g++`` on ``PATH``; a failed build
raises). A host without ``g++`` decodes in Python, several times slower on
a progressive or arithmetic-coded file. The IDCT, the smoothing, the
upsampling and the colour conversion are whole-array NumPy.
"""

from __future__ import annotations

import functools
import re
import struct
from array import array

import numpy as np

SOI, EOI, SOS, DQT, DHT, DRI, DNL = 0xD8, 0xD9, 0xDA, 0xDB, 0xC4, 0xDD, 0xDC
DAC = 0xCC
# The frames libjpeg-turbo decodes: (progressive, arithmetic, lossless).
SOF_KINDS = {0xC0: (False, False, False), 0xC1: (False, False, False),
             0xC2: (True, False, False), 0xC3: (False, False, True),
             0xC9: (False, True, False), 0xCA: (True, True, False)}
# The frames it refuses (Pillow with it): hierarchical ones, and
# arithmetic-coded lossless ones, for which it has no decoder.
SOF_UNSUPPORTED = {
    0xC5: "hierarchical", 0xC6: "hierarchical progressive",
    0xC7: "hierarchical lossless", 0xCB: "arithmetic-coded lossless",
    0xCD: "arithmetic-coded hierarchical",
    0xCE: "arithmetic-coded hierarchical progressive",
    0xCF: "arithmetic-coded hierarchical lossless"}

# The standard Huffman tables (ISO 10918-1 K.3) that libjpeg-turbo's
# jpeg_std_huff_table supplies for a scan naming table 0 or 1 of a class
# no DHT defined: {(class, id): (code counts, symbols)}.
STD_HUFFMAN = {
    (0, 0): ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0),
             bytes(range(12))),
    (0, 1): ((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0),
             bytes(range(12))),
    (1, 0): ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125), bytes.fromhex(
        "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
        "2433627282090a161718191a25262728292a3435363738393a43444546474849"
        "4a535455565758595a636465666768696a737475767778797a83848586878889"
        "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
        "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
        "f9fa")),
    (1, 1): ((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119), bytes.fromhex(
        "000102031104052131061241510761711322328108144291a1b1c109233352f0"
        "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
        "494a535455565758595a636465666768696a737475767778797a828384858687"
        "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
        "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
        "f9fa")),
}


def _table(huff: dict, key: tuple):
    """The Huffman table ``key`` names, the standard one for an undefined
    table 0 or 1 (kept, as libjpeg keeps it), or None."""
    if key not in huff and key in STD_HUFFMAN:
        huff[key] = HuffmanTable(*STD_HUFFMAN[key])
    return huff.get(key)


# Markers libjpeg's read_markers refuses (JPG, DHP, EXP, JPGn), as it does
# the reserved ones below 0xC0 other than TEM.
UNKNOWN_MARKERS = frozenset((0xC8, 0xDE, 0xDF, *range(0xF0, 0xFE)))

# jpeg_natural_order (jutils.c): the natural position of each zigzag
# index, with 16 extra entries of 63 that a corrupt run lands on, as
# libjpeg's table has them.
_ZIGZAG = np.zeros((8, 8), np.int64)
_k = 0
for _s in range(15):
    _cells = [(i, _s - i) for i in range(8) if 0 <= _s - i < 8]
    for _i, _j in (_cells if _s % 2 else _cells[::-1]):
        _ZIGZAG[_i, _j] = _k
        _k += 1
NATURAL_ORDER = tuple(int(x) for x in np.argsort(_ZIGZAG.reshape(-1))) + (
    63,) * 16

# jidctint.c's fixed-point constants (CONST_BITS = 13).
CONST_BITS, PASS1_BITS = 13, 2
FIX_0_298631336, FIX_0_390180644, FIX_0_541196100 = 2446, 3196, 4433
FIX_0_765366865, FIX_0_899976223, FIX_1_175875602 = 6270, 7373, 9633
FIX_1_501321110, FIX_1_847759065, FIX_1_961570560 = 12299, 15137, 16069
FIX_2_053119869, FIX_2_562915447, FIX_3_072711026 = 16819, 20995, 25172


def _ycc_tables():
    """jdcolor.c ``build_ycc_rgb_table``: SCALEBITS 16."""
    one_half = 1 << 15
    x = np.arange(256, dtype=np.int64) - 128

    def fix(v):
        return int(v * 65536 + 0.5)

    cr_r = (fix(1.40200) * x + one_half) >> 16
    cb_b = (fix(1.77200) * x + one_half) >> 16
    cr_g = -fix(0.71414) * x
    cb_g = -fix(0.34414) * x + one_half
    return cr_r, cb_b, cr_g, cb_g


_CR_R, _CB_B, _CR_G, _CB_G = _ycc_tables()


class HuffmanTable:
    """A DHT table as lookups on the next 16 bits: ``lookup`` (int32, for
    the C++ decoder) and ``code`` give (code length << 8 | symbol) for any
    code, and 17 << 8 | 0 where no code starts: libjpeg reads a bad code's
    17 bits and takes symbol 0 (``jpeg_huff_decode``'s warning); ``dc`` (bits consumed, difference) and
    ``ac`` (bits consumed, zero run, coefficient; run -1 at the end of
    block, 16 and no coefficient at a run of 16 zeros) resolve a code and
    its extra bits together where they fit in the 16 bits, and give 0 bits
    elsewhere. The Python lists are made at first use: a progressive file
    carries a table or two a scan, and the C++ decoder reads ``lookup``
    only."""

    def __init__(self, counts, symbols):
        lengths = np.repeat(np.arange(1, 17), counts)
        symbols = np.frombuffer(bytes(symbols), np.uint8).astype(np.int64)
        if len(symbols) != len(lengths):
            raise ValueError("a Huffman table's symbol count does not match "
                             "its code lengths")
        codes, code = [], 0
        for n in counts:  # canonical codes (Annex C)
            codes.extend(range(code, code + n))
            code = (code + n) << 1
        if any(c >= (1 << int(n)) for c, n in zip(codes, lengths)):
            raise ValueError("a Huffman table's codes overflow 16 bits")
        code_len = np.zeros(1 << 16, np.int64)
        code_sym = np.zeros(1 << 16, np.int64)
        for c, n, sym in zip(codes, lengths.tolist(), symbols.tolist()):
            lo = c << (16 - n)
            code_len[lo:lo + (1 << (16 - n))] = n
            code_sym[lo:lo + (1 << (16 - n))] = sym
        code_len[code_len == 0] = 17  # a bad code: 17 bits, symbol 0
        self.lookup = (code_len << 8 | code_sym).astype(np.int32)
        self.max_symbol = int(symbols.max(initial=0))

    @functools.cached_property
    def code(self) -> list:
        return self.lookup.tolist()

    def _resolved(self):
        code_len = self.lookup.astype(np.int64) >> 8
        code_sym = self.lookup.astype(np.int64) & 255
        pattern = np.arange(1 << 16, dtype=np.int64)
        size = code_sym & 15
        total = code_len + size
        fits = (code_len > 0) & (total <= 16)
        raw = (pattern >> np.maximum(16 - total, 0)) & ((1 << size) - 1)
        value = np.where(raw < (1 << np.maximum(size - 1, 0)),
                         raw - (1 << size) + 1, raw)
        value = np.where(size == 0, 0, value)
        used = np.where(fits, total, 0)
        return code_sym, size, used, value

    @functools.cached_property
    def dc(self) -> list:
        _, _, used, value = self._resolved()
        return list(zip(used.tolist(), value.tolist()))

    @functools.cached_property
    def ac(self) -> list:
        code_sym, size, used, value = self._resolved()
        run = code_sym >> 4
        run = np.where(size > 0, run, np.where(run == 15, 16, -1))
        return list(zip(used.tolist(), run.tolist(), value.tolist()))


class Component:
    """A frame component: its id, sampling factors, quantization table
    index, its block grid (the MCU-padded grid for interleaved scans), its
    coefficients, natural order, int32, and, in a progressive frame, the
    point transform (Al) each zigzag coefficient was last sent at (-1:
    never), libjpeg's ``coef_bits``."""

    def __init__(self, cid, h, v, tq):
        self.id, self.h, self.v, self.tq = cid, h, v, tq
        self.quant = None  # latched at the component's first scan
        self.coef = None
        self.coef_bits = [-1] * 64
        self.prev_bits = [-1] * 64


def _extend(v: int, s: int) -> int:
    return v - (1 << s) + 1 if v < (1 << (s - 1)) else v


def _windows(segment: bytes) -> list:
    """32-bit big-endian windows of ``segment`` at every byte, zero-padded
    past its end: bit p's window is windows[p >> 3]."""
    a = np.frombuffer(segment + b"\0" * 8, np.uint8).astype(np.uint32)
    n = len(segment) + 4
    w = (a[0:n] << 24) | (a[1:n + 1] << 16) | (a[2:n + 2] << 8) | a[3:n + 3]
    return w.tolist()


# More zero windows for a reader that ran past its interval's bytes: more
# than one MCU of ten blocks reads (64 codes of at most 33 bits a block).
_ZERO_TAIL = [0] * 4096


def restart_intervals(segments: list, restart: int, n_mcus: int):
    """(MCUs an interval, each restart interval's bytes): ``None`` for an
    interval whose data is missing, where the scan's data ends at another
    marker before its RSTn. libjpeg then finds that marker where the RSTn
    should be, leaves it for later (``jpeg_resync_to_restart``'s action
    3), and decodes the interval from no data."""
    interval = restart or n_mcus
    need = (n_mcus + interval - 1) // interval
    return interval, [segments[i] if i < len(segments) else None
                      for i in range(need)]


def decode_scan(segments: list, units: list, restart: int, n_mcus: int
                ) -> int:
    """The entropy-coded data of one scan into its components'
    coefficients. ``segments``: the unstuffed bytes between restart
    markers; ``units``: for each data unit of an MCU in order, (component,
    DC table, AC table, list of block offsets a MCU, blocks a MCU row
    stride and MCUs a row) as ``_scan_units`` makes them; ``restart``: MCUs
    a restart interval (0: none); ``n_mcus``: the scan's MCU count.

    Data that ends early reads as libjpeg-turbo reads it (``jdhuff.c``'s
    ``insufficient_data``): the MCU that runs past its interval's bytes is
    decoded on zero bits, the interval's later MCUs are left as they are,
    and an interval whose RSTn was found starts afresh, while one whose
    data is missing does not (its first MCU reads zero bits where the last
    interval ended whole). Returns libjpeg's ``last_good_iMCU_row`` as an
    MCU: the last MCU that began with the flag clear."""
    zz = NATURAL_ORDER
    interval, parts = restart_intervals(segments, restart, n_mcus)
    mcus_row = units[0][5]
    short, last_good = False, -1
    for seg_i, seg in enumerate(parts):
        first = seg_i * interval
        if short and seg is None:
            continue
        if not short:
            last_good = first
        short = False
        seg = seg or b""
        end = 8 * len(seg)
        win = _windows(seg)
        p = 0
        preds = {}
        m = first
        stop = min(first + interval, n_mcus)
        while m < stop:
            p0, preds0 = p, dict(preds)
            try:
                my, mx = divmod(m, mcus_row)
                for comp, dct, act, offsets, row_stride, _ in units:
                    coef = comp.coef
                    pred = preds.get(comp, 0)
                    origin = my * row_stride
                    for off in offsets:
                        base = (origin + off + mx * comp.mcu_w) * 64
                        # DC
                        n, diff = dct.dc[(win[p >> 3] >> (16 - (p & 7)))
                                         & 0xFFFF]
                        if n:
                            p += n
                        else:
                            e = dct.code[(win[p >> 3] >> (16 - (p & 7)))
                                         & 0xFFFF]
                            p += e >> 8
                            s = e & 15
                            diff = 0
                            if s:
                                diff = _extend((win[p >> 3] >> (32 - (p & 7)
                                                                 - s))
                                               & ((1 << s) - 1), s)
                                p += s
                        pred += diff
                        coef[base] = pred
                        # AC
                        k = 1
                        ac, code = act.ac, act.code
                        while k < 64:
                            n, run, val = ac[(win[p >> 3] >> (16 - (p & 7)))
                                             & 0xFFFF]
                            if not n:
                                e = code[(win[p >> 3] >> (16 - (p & 7)))
                                         & 0xFFFF]
                                p += e >> 8
                                rs = e & 255
                                s = rs & 15
                                if s:
                                    run = rs >> 4
                                    val = _extend(
                                        (win[p >> 3] >> (32 - (p & 7) - s))
                                        & ((1 << s) - 1), s)
                                    p += s
                                else:
                                    run, val = (16 if rs >> 4 == 15 else -1), 0
                            else:
                                p += n
                            if val:
                                k += run
                                coef[base + zz[k]] = val
                                k += 1
                            elif run < 0:
                                break
                            else:
                                k += 16
                    preds[comp] = pred
            except IndexError:  # past the zeros: redo the MCU on more
                win.extend(_ZERO_TAIL)
                p, preds = p0, preds0
                continue
            if p > end:
                short = True
                break
            m += 1
            if m < stop:
                last_good = m
    return last_good


def _wrap16(v):
    """``v`` (an int or an integer array) as a 16-bit lane, libjpeg's JCOEF
    (int16), holds it."""
    return ((v + 32768) & 0xFFFF) - 32768


class _Reader:
    """The bits of one restart interval's unstuffed bytes, read at bit
    ``p``; past the end they are zeros (a read past the windows raises
    ``IndexError``, and the caller adds more)."""

    __slots__ = ("win", "p", "name")

    def __init__(self, segment: bytes, name: str):
        self.win, self.p, self.name = _windows(segment), 0, name

    def bits(self, n: int) -> int:
        p = self.p
        self.p = p + n
        return (self.win[p >> 3] >> (32 - (p & 7) - n)) & ((1 << n) - 1)

    def symbol(self, table: HuffmanTable) -> int:
        p = self.p
        e = table.code[(self.win[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
        self.p = p + (e >> 8)
        return e & 255


class _Progress:
    """What a progressive scan carries from MCU to MCU within a restart
    interval: the DC predictors (by component) and the end-of-band run."""

    __slots__ = ("preds", "eobrun")

    def __init__(self):
        self.preds, self.eobrun = {}, 0


def decode_mcu_DC_first(rd: _Reader, blocks: list, st: _Progress,
                        al: int) -> None:
    """``jdphuff.c::decode_mcu_DC_first``: each block's DC difference,
    added to its component's predictor and stored shifted by ``Al``.
    ``blocks``: (coefficients, offset of the block's first coefficient,
    component, DC table, AC table) of each block of the MCU."""
    for coef, base, comp, dct, _ in blocks:
        s = rd.symbol(dct)
        diff = _extend(rd.bits(s), s) if s else 0
        pred = st.preds.get(comp, 0) + diff
        st.preds[comp] = pred
        coef[base] = _wrap16(pred << al)


def decode_mcu_DC_refine(rd: _Reader, blocks: list, al: int) -> None:
    """``decode_mcu_DC_refine``: one bit a block, OR-ed in at ``1 << Al``."""
    p1 = 1 << al
    for coef, base, *_ in blocks:
        if rd.bits(1):
            coef[base] |= p1


def decode_mcu_AC_first(rd: _Reader, block: tuple, st: _Progress, ss: int,
                        se: int, al: int) -> None:
    """``decode_mcu_AC_first``: the band ``Ss..Se`` of one block, each
    coefficient shifted by ``Al``; EOBr opens a run of blocks whose band
    is all zero, this one included: 2^r plus the value of the next r
    bits."""
    if st.eobrun:
        st.eobrun -= 1
        return
    coef, base, _, _, act = block
    zz = NATURAL_ORDER
    k = ss
    while k <= se:
        rs = rd.symbol(act)
        r, s = rs >> 4, rs & 15
        if s:
            k += r
            coef[base + zz[k]] = _wrap16(_extend(rd.bits(s), s) << al)
        elif r == 15:
            k += 15
        else:
            run = 1 << r
            if r:
                run += rd.bits(r)
            st.eobrun = run - 1
            break
        k += 1


def decode_mcu_AC_refine(rd: _Reader, block: tuple, st: _Progress, ss: int,
                         se: int, al: int) -> None:
    """``decode_mcu_AC_refine``: a correction bit for each coefficient of
    the band that already has a history, and each newly nonzero one, +-(1
    << Al), placed after its run of zero-history positions; inside an
    end-of-band run only the correction bits."""
    coef, base, _, _, act = block
    zz = NATURAL_ORDER
    p1, m1 = 1 << al, -1 << al
    k = ss
    if not st.eobrun:
        while k <= se:
            rs = rd.symbol(act)
            r, s = rs >> 4, rs & 15
            if s:  # a symbol of size other than 1 is a warning only
                s = p1 if rd.bits(1) else m1
            elif r != 15:
                st.eobrun = 1 << r
                if r:
                    st.eobrun += rd.bits(r)
                break
            while True:  # jdphuff.c's do-while over the band
                pos = base + zz[k]
                v = coef[pos]
                if v:
                    if rd.bits(1) and not v & p1:
                        coef[pos] = _wrap16(v + (p1 if v >= 0 else m1))
                else:
                    r -= 1
                    if r < 0:
                        break
                k += 1
                if k > se:
                    break
            if s:
                coef[base + zz[k]] = s
            k += 1
    if st.eobrun:
        while k <= se:
            pos = base + zz[k]
            v = coef[pos]
            if v and rd.bits(1) and not v & p1:
                coef[pos] = _wrap16(v + (p1 if v >= 0 else m1))
            k += 1
        st.eobrun -= 1


def decode_progressive_scan(segments: list, units: list, restart: int,
                            n_mcus: int, ss: int, se: int, ah: int, al: int,
                            name: str) -> int:
    """One progressive scan's entropy-coded data into its components'
    coefficients, MCU by MCU through the decoder its ``Ss``/``Ah`` pick;
    ``segments``, ``units``, ``restart`` and ``n_mcus`` as ``decode_scan``
    takes them. Each restart interval starts with the predictors at 0 and
    no end-of-band run. Data that ends early reads as ``decode_scan``
    reads it (``jdphuff.c``): the MCUs left undecoded keep what earlier
    scans gave them. Returns the last MCU that began with libjpeg's
    out-of-data flag clear."""
    interval, parts = restart_intervals(segments, restart, n_mcus)
    mcus_row = units[0][5]
    short, last_good = False, -1
    for seg_i, seg in enumerate(parts):
        first = seg_i * interval
        if short and seg is None:
            continue
        if not short:
            last_good = first
        short = False
        seg = seg or b""
        rd, st = _Reader(seg, name), _Progress()
        m = first
        stop = min(first + interval, n_mcus)
        while m < stop:
            my, mx = divmod(m, mcus_row)
            blocks = [(comp.coef,
                       (my * row_stride + off + mx * comp.mcu_w) * 64,
                       comp, dct, act)
                      for comp, dct, act, offsets, row_stride, _ in units
                      for off in offsets]
            p0, preds0, eob0 = rd.p, dict(st.preds), st.eobrun
            if ss and ah:  # a refinement changes what it reads: keep it
                coef, base = blocks[0][:2]
                saved = coef[base:base + 64]
            try:
                if ss == 0 and ah == 0:
                    decode_mcu_DC_first(rd, blocks, st, al)
                elif ss == 0:
                    decode_mcu_DC_refine(rd, blocks, al)
                elif ah == 0:
                    decode_mcu_AC_first(rd, blocks[0], st, ss, se, al)
                else:
                    decode_mcu_AC_refine(rd, blocks[0], st, ss, se, al)
            except IndexError:  # past the zeros: redo the MCU on more
                rd.win.extend(_ZERO_TAIL)
                rd.p, st.preds, st.eobrun = p0, preds0, eob0
                if ss and ah:
                    coef[base:base + 64] = saved
                continue
            if rd.p > 8 * len(seg):
                short = True
                break
            m += 1
            if m < stop:
                last_good = m
    return last_good


# ISO 10918-1 Table D.2 as jaricom.c packs it: Qe << 16 | Next_Index_MPS
# << 8 | Switch_MPS << 7 | Next_Index_LPS; entry 113 is the fixed bin's
# state (Qe 0.5, never moving).
ARITAB = (
    0x5a1d0181, 0x2586020e, 0x11140310, 0x080b0412, 0x03d80514, 0x01da0617,
    0x00e50719, 0x006f081c, 0x0036091e, 0x001a0a21, 0x000d0b23, 0x00060c09,
    0x00030d0a, 0x00010d0c, 0x5a7f0f8f, 0x3f251024, 0x2cf21126, 0x207c1227,
    0x17b91328, 0x1182142a, 0x0cef152b, 0x09a1162d, 0x072f172e, 0x055c1830,
    0x04061931, 0x03031a33, 0x02401b34, 0x01b11c36, 0x01441d38, 0x00f51e39,
    0x00b71f3b, 0x008a203c, 0x0068213e, 0x004e223f, 0x003b2320, 0x002c0921,
    0x5ae125a5, 0x484c2640, 0x3a0d2741, 0x2ef12843, 0x261f2944, 0x1f332a45,
    0x19a82b46, 0x15182c48, 0x11772d49, 0x0e742e4a, 0x0bfb2f4b, 0x09f8304d,
    0x0861314e, 0x0706324f, 0x05cd3330, 0x04de3432, 0x040f3532, 0x03633633,
    0x02d43734, 0x025c3835, 0x01f83936, 0x01a43a37, 0x01603b38, 0x01253c39,
    0x00f63d3a, 0x00cb3e3b, 0x00ab3f3d, 0x008f203d, 0x5b1241c1, 0x4d044250,
    0x412c4351, 0x37d84452, 0x2fe84553, 0x293c4654, 0x23794756, 0x1edf4857,
    0x1aa94957, 0x174e4a48, 0x14244b48, 0x119c4c4a, 0x0f6b4d4a, 0x0d514e4b,
    0x0bb64f4d, 0x0a40304d, 0x583251d0, 0x4d1c5258, 0x438e5359, 0x3bdd545a,
    0x34ee555b, 0x2eae565c, 0x299a575d, 0x25164756, 0x557059d8, 0x4ca95a5f,
    0x44d95b60, 0x3e225c61, 0x38245d63, 0x32b45e63, 0x2e17565d, 0x56a860df,
    0x4f466165, 0x47e56266, 0x41cf6367, 0x3c3d6468, 0x375e5d63, 0x52316669,
    0x4c0f676a, 0x4639686b, 0x415e6367, 0x56276ae9, 0x50e76b6c, 0x4b85676d,
    0x55976d6e, 0x504f6b6f, 0x5a106fee, 0x55226d70, 0x59eb6ff0, 0x5a1d7171,
)


class _QM:
    """``jdarith.c``'s decoder over one restart interval's unstuffed bytes:
    the C and A registers, the bit counter (-16 before the first two bytes,
    -1 once the data proved bad: the interval's remaining MCUs are then
    left as they are), zeros past the last byte, and the interval's
    statistics: 64 bins a DC table, 256 an AC table, all 0 at the start,
    the fixed bin, each component's last DC value and DC context."""

    __slots__ = ("data", "pos", "c", "a", "ct", "dc", "ac", "fixed", "last",
                 "ctx")

    def __init__(self, segment: bytes):
        self.data, self.pos = segment, 0
        self.c, self.a, self.ct = 0, 0, -16
        self.dc, self.ac = {}, {}
        self.fixed = bytearray([113])
        self.last, self.ctx = {}, {}

    def decode(self, st: bytearray, i: int) -> int:
        """``arith_decode``: one binary decision in bin ``st[i]``, with the
        bin's state moved as Table D.2 says."""
        a, c, ct = self.a, self.c, self.ct
        while a < 0x8000:
            ct -= 1
            if ct < 0:
                pos = self.pos
                c = (c << 8) | (self.data[pos] if pos < len(self.data) else 0)
                self.pos = pos + 1
                ct += 8
                if ct < 0:
                    ct += 1
                    if ct == 0:
                        a = 0x8000  # the two first bytes are in
            a <<= 1
        sv = st[i]
        qe = ARITAB[sv & 0x7F]
        nl, nm, qe = qe & 0xFF, (qe >> 8) & 0xFF, qe >> 16
        a -= qe
        temp = a << ct
        if c >= temp:
            c -= temp
            if a < qe:
                a = qe
                st[i] = (sv & 0x80) ^ nm
            else:
                a = qe
                st[i] = (sv & 0x80) ^ nl
                sv ^= 0x80
        elif a < 0x8000:
            if a < qe:
                st[i] = (sv & 0x80) ^ nl
                sv ^= 0x80
            else:
                st[i] = (sv & 0x80) ^ nm
        self.a, self.c, self.ct = a, c, ct
        return sv >> 7


def _arith_dc(qm: _QM, comp, tbl: int, cond: dict) -> bool:
    """Figures F.19-F.24 as ``jdarith.c`` reads a DC difference into the
    component's last value (mod 2^16), the context its magnitude sets
    against the table's L and U. False where the magnitude overflows."""
    stats = qm.dc.setdefault(tbl, bytearray(64))
    s0 = qm.ctx.get(comp, 0)
    if not qm.decode(stats, s0):
        qm.ctx[comp] = 0
        return True
    sign = qm.decode(stats, s0 + 1)
    st = s0 + 2 + sign
    m = qm.decode(stats, st)
    if m:
        st = 20
        while qm.decode(stats, st):
            m <<= 1
            if m == 0x8000:
                return False
            st += 1
    lo, hi = cond["dc"][tbl]
    if m < (1 << lo) >> 1:
        qm.ctx[comp] = 0
    elif m > (1 << hi) >> 1:
        qm.ctx[comp] = 12 + sign * 4
    else:
        qm.ctx[comp] = 4 + sign * 4
    v = m
    st += 14
    m >>= 1
    while m:
        if qm.decode(stats, st):
            v |= m
        m >>= 1
    v += 1
    qm.last[comp] = (qm.last.get(comp, 0) + (-v if sign else v)) & 0xFFFF
    return True


def _arith_ac_value(qm: _QM, stats: bytearray, st: int, k: int, kx: int):
    """A nonzero AC coefficient's sign (the fixed bin) and value, its
    magnitude bins from 189 up to Kx and from 217 past it; None where the
    magnitude overflows."""
    sign = qm.decode(qm.fixed, 0)
    st += 2
    m = qm.decode(stats, st)
    if m and qm.decode(stats, st):
        m <<= 1
        st = 189 if k <= kx else 217
        while qm.decode(stats, st):
            m <<= 1
            if m == 0x8000:
                return None
            st += 1
    v = m
    st += 14
    m >>= 1
    while m:
        if qm.decode(stats, st):
            v |= m
        m >>= 1
    v += 1
    return -v if sign else v


def arith_mcu_sequential(qm: _QM, blocks: list, cond: dict) -> None:
    """``jdarith.c::decode_mcu``: each block's DC difference, then its AC
    coefficients 1..63 up to the end-of-block decision."""
    zz = NATURAL_ORDER
    for coef, base, comp, dtbl, atbl in blocks:
        if not _arith_dc(qm, comp, dtbl, cond):
            qm.ct = -1
            return
        coef[base] = _wrap16(qm.last.get(comp, 0))
        stats = qm.ac.setdefault(atbl, bytearray(256))
        kx = cond["ac"][atbl]
        k = 1
        while k <= 63:
            st = 3 * (k - 1)
            if qm.decode(stats, st):
                break
            while not qm.decode(stats, st + 1):
                st += 3
                k += 1
                if k > 63:
                    qm.ct = -1
                    return
            v = _arith_ac_value(qm, stats, st, k, kx)
            if v is None:
                qm.ct = -1
                return
            coef[base + zz[k]] = _wrap16(v)
            k += 1


def arith_mcu_DC_first(qm: _QM, blocks: list, cond: dict, al: int) -> None:
    """``decode_mcu_DC_first``: each block's DC, shifted by ``Al``."""
    for coef, base, comp, dtbl, _ in blocks:
        if not _arith_dc(qm, comp, dtbl, cond):
            qm.ct = -1
            return
        coef[base] = _wrap16(qm.last.get(comp, 0) << al)


def arith_mcu_DC_refine(qm: _QM, blocks: list, al: int) -> None:
    """``decode_mcu_DC_refine``: one bit a block from the fixed bin."""
    for coef, base, *_ in blocks:
        if qm.decode(qm.fixed, 0):
            coef[base] |= 1 << al


def arith_mcu_AC_first(qm: _QM, block: tuple, cond: dict, ss: int, se: int,
                       al: int) -> None:
    """``decode_mcu_AC_first``: the band ``Ss..Se`` of one block, each
    coefficient shifted by ``Al``."""
    coef, base, _, _, atbl = block
    zz = NATURAL_ORDER
    stats = qm.ac.setdefault(atbl, bytearray(256))
    kx = cond["ac"][atbl]
    k = ss
    while k <= se:
        st = 3 * (k - 1)
        if qm.decode(stats, st):
            break
        while not qm.decode(stats, st + 1):
            st += 3
            k += 1
            if k > se:
                qm.ct = -1
                return
        v = _arith_ac_value(qm, stats, st, k, kx)
        if v is None:
            qm.ct = -1
            return
        coef[base + zz[k]] = _wrap16(v << al)
        k += 1


def arith_mcu_AC_refine(qm: _QM, block: tuple, ss: int, se: int,
                        al: int) -> None:
    """``decode_mcu_AC_refine``: past the last coefficient the earlier
    scans made nonzero (EOBx) an end-of-band decision at each position;
    a known nonzero coefficient takes a correction bit (+-(1 << Al) away
    from zero), a zero one may become +-(1 << Al)."""
    coef, base, _, _, atbl = block
    zz = NATURAL_ORDER
    stats = qm.ac.setdefault(atbl, bytearray(256))
    p1, m1 = 1 << al, -1 << al
    kex = se
    while kex > 0 and not coef[base + zz[kex]]:
        kex -= 1
    k = ss
    while k <= se:
        st = 3 * (k - 1)
        if k > kex and qm.decode(stats, st):
            break
        while True:
            pos = base + zz[k]
            v = coef[pos]
            if v:
                if qm.decode(stats, st + 2):
                    coef[pos] = _wrap16(v + (m1 if v < 0 else p1))
                break
            if qm.decode(stats, st + 1):
                coef[pos] = m1 if qm.decode(qm.fixed, 0) else p1
                break
            st += 3
            k += 1
            if k > se:
                qm.ct = -1
                return
        k += 1


def decode_arith_scan(segments: list, units: list, restart: int, n_mcus: int,
                      mode: int, ss: int, se: int, al: int, cond: dict
                      ) -> int:
    """One arithmetic-coded scan (SOF9, SOF10) into its components'
    coefficients: ``segments``, ``units`` (with table numbers for tables),
    ``restart`` and ``n_mcus`` as ``decode_scan`` takes them, ``mode`` as
    ``accel.native.jpeg_scan_native`` numbers them, ``cond`` the DAC
    conditioning ({"dc": [(L, U)] * 16, "ac": [Kx] * 16}). Each restart
    interval starts the coder, the statistics and the predictors anew. Bad
    data does not raise: as ``jdarith.c`` warns and leaves the rest of the
    interval undecoded, so does this. Data that ends early is no error
    either: past a marker the coder reads zero bytes, also through the
    intervals whose data is missing. Returns the bytes the last interval's
    coder read (those past its end too)."""
    interval, parts = restart_intervals(segments, restart, n_mcus)
    mcus_row = units[0][5]
    qm = _QM(b"")
    for seg_i, seg in enumerate(parts):
        qm = _QM(seg or b"")
        first = seg_i * interval
        for m in range(first, min(first + interval, n_mcus)):
            if qm.ct == -1 and mode != 2:
                break
            my, mx = divmod(m, mcus_row)
            blocks = [(comp.coef,
                       (my * row_stride + off + mx * comp.mcu_w) * 64,
                       comp, dtbl, atbl)
                      for comp, dtbl, atbl, offsets, row_stride, _ in units
                      for off in offsets]
            if mode == 0:
                arith_mcu_sequential(qm, blocks, cond)
            elif mode == 1:
                arith_mcu_DC_first(qm, blocks, cond, al)
            elif mode == 2:
                arith_mcu_DC_refine(qm, blocks, al)
            elif mode == 3:
                arith_mcu_AC_first(qm, blocks[0], cond, ss, se, al)
            else:
                arith_mcu_AC_refine(qm, blocks[0], ss, se, al)
    return qm.pos


def decode_lossless_scan(segments: list, units: list, restart: int,
                         n_mcus: int, name: str) -> bytearray:
    """The Huffman-coded differences of one lossless scan (SOF3,
    ``jdlhuff.c``) into its components' sample grids (``comp.coef``, one
    int32 a sample): ``segments``, ``units`` and ``restart`` as
    ``decode_scan`` takes them, each data unit one sample; category 16 is
    32768 with no extra bits. Data that ends early reads as ``jdlhuff.c``
    reads it, an MCU row at a time: the row that runs past its interval's
    bytes is decoded to its end on zero bits, and each later row of the
    interval is left at zero differences and resets the predictors
    (returned: a flag for each MCU row so skipped)."""
    interval, parts = restart_intervals(segments, restart, n_mcus)
    mcus_row = units[0][5]
    skipped = bytearray(-(-n_mcus // mcus_row))
    short = False
    for seg_i, seg in enumerate(parts):
        if seg is not None:
            short = False
        seg = seg or b""
        rd = _Reader(seg, name)
        m = seg_i * interval
        stop = min(m + interval, n_mcus)
        while m < stop:
            my, mx = divmod(m, mcus_row)
            if mx == 0 and short:
                skipped[my] = 1
                m += mcus_row
                continue
            p0 = rd.p
            try:
                for comp, dct, _, offsets, row_stride, _ in units:
                    for off in offsets:
                        s = rd.symbol(dct)
                        comp.coef[my * row_stride + off + mx * comp.mcu_w] = (
                            32768 if s == 16 else
                            _extend(rd.bits(s), s) if s else 0)
            except IndexError:  # past the zeros: redo the MCU on more
                rd.win.extend(_ZERO_TAIL)
                rd.p = p0
                continue
            m += 1
            if mx == mcus_row - 1:
                short = rd.p > 8 * len(seg)
    return skipped


def lossless_first_rows(c, interleaved: bool, restart: int,
                        mcus_row: int, skipped=None) -> np.ndarray:
    """Which of component ``c``'s sample rows ``jdlossls.c`` undifferences
    as a first row (the sample to the left, 2^(7 - Pt) first) in a scan:
    the first row of each iMCU row (``c.v`` rows) in whose MCU rows the
    scan starts, a restart interval does, or (``skipped``, a flag an MCU
    row) the decoder found its data gone. An interleaved scan's MCU row
    is an iMCU row; a scan of one component has ``c.v`` MCU rows an iMCU
    row, so a restart inside one takes effect at its first row, as
    libjpeg-turbo undifferences an iMCU row once all of it is decoded."""
    rows = np.arange(c.height)
    per = restart // mcus_row if restart else 0
    if interleaved:
        mcu_rows = rows // c.v
    else:
        mcu_rows = rows
    reset = (mcu_rows % per == 0) if per else (mcu_rows == 0)
    if skipped is not None:
        reset |= np.frombuffer(bytes(skipped), np.uint8)[mcu_rows] != 0
    imcu = rows // c.v
    hit = np.zeros(imcu[-1] + 1, bool)
    np.logical_or.at(hit, imcu, reset)
    return (rows % c.v == 0) & hit[imcu]


def undifference(diff: np.ndarray, first_rows: np.ndarray, psv: int,
                 pt: int) -> np.ndarray:
    """``jdlossls.c`` on one component's (H, W) differences: each sample
    its difference plus its prediction, mod 2^16 (a first row from the
    left, 2^(7 - Pt) first; other rows from the sample above first, then
    by predictor ``psv`` of Ra, Rb, Rc), then shifted left by the point
    transform ``pt`` and cut to 8 bits as libjpeg's JSAMPLE holds it."""
    d = diff.astype(np.int64)
    h, w = d.shape
    x = np.zeros((h, w), np.int64)
    for r in range(h):
        if first_rows[r]:
            x[r] = (np.cumsum(d[r]) + (1 << (7 - pt))) & 0xFFFF
            continue
        b = x[r - 1]
        x0 = (d[r, 0] + b[0]) & 0xFFFF
        if psv in (1, 4, 5):
            step = d[r, 1:] + {1: 0, 4: b[1:] - b[:-1],
                               5: (b[1:] - b[:-1]) >> 1}[psv]
            x[r, 0] = x0
            x[r, 1:] = (x0 + np.cumsum(step)) & 0xFFFF
        elif psv in (2, 3):
            x[r, 0] = x0
            x[r, 1:] = (d[r, 1:] + (b[1:] if psv == 2 else b[:-1])) & 0xFFFF
        else:
            row, dr, bl = [int(x0)], d[r].tolist(), b.tolist()
            for i in range(1, w):
                ra, rb, rc = row[-1], bl[i], bl[i - 1]
                pred = rb + ((ra - rc) >> 1) if psv == 6 else (ra + rb) >> 1
                row.append((dr[i] + pred) & 0xFFFF)
            x[r] = row
    return ((x << pt) & 0xFF).astype(np.uint8)


def _scan_units(comps: list, frame: dict):
    """Each data unit of one MCU of a scan over ``comps``: (component, its
    block offsets in the component's grid (row * grid width + column),
    the grid's blocks a MCU row, MCUs a row) and the scan's MCU count. An
    interleaved scan's MCU holds h x v blocks of each component; a scan of
    one component walks its blocks one by one over the component's own
    extent (ceil(downsampled size / 8))."""
    if len(comps) == 1:
        c = comps[0]
        unit = frame["block"]
        bw, bh = -(-c.width // unit), -(-c.height // unit)
        c.mcu_w = 1
        return [(c, [0], c.grid_w, bw)], bw * bh
    mx, my = frame["mcus_x"], frame["mcus_y"]
    if sum(c.h * c.v for c in comps) > 10:  # D_MAX_BLOCKS_IN_MCU
        raise ValueError("sampling factors too large for an interleaved "
                         "scan (more than 10 blocks a MCU)")
    units = []
    for c in comps:
        c.mcu_w = c.h
        offsets = [v * c.grid_w + h for v in range(c.v) for h in range(c.h)]
        units.append((c, offsets, c.v * c.grid_w, mx))
    return units, mx * my


def _entropy_segments(data: bytes, pos: int, name: str):
    """The scan data from ``pos`` to the next marker other than RSTn, split
    at the restart markers and unstuffed (FF 00 -> FF). Returns (segments,
    the position of that marker, or ``len(data)`` for data that runs to
    the end of the file with no marker)."""
    end = pos
    while True:
        j = data.find(b"\xff", end)
        if j < 0 or j + 1 >= len(data):
            j = len(data)
            break
        nb = data[j + 1]
        if nb == 0x00 or 0xD0 <= nb <= 0xD7:
            end = j + 2
        elif nb == 0xFF:  # fill bytes before a marker
            end = j + 1
        else:
            break
    scan = data[pos:j]
    parts = re.split(rb"\xff[\xd0-\xd7]", scan)
    return [p.replace(b"\xff\x00", b"\xff") for p in parts], j


# Pillow hands libjpeg a file in blocks of ImageFile.MAXBLOCK bytes, one
# more each time libjpeg suspends for data; jdhuff.c fills its bit buffer
# to MIN_GET_BITS (57 bits on a 64-bit host) and takes its fast path only
# with BUFSIZE (512) bytes a block of the MCU in the buffer.
MAXBLOCK = 65536
MIN_GET_BITS = 57
FAST_BYTES = 512


def interval_bytes(data: bytes, start: int) -> tuple:
    """The entropy-coded bytes from ``start`` up to the next marker or the
    end of the file, as libjpeg fetches them: (each data byte's end in the
    file, FF 00 taking two; the end of the marker after them, or -1 where
    the data runs to the end of the file). A lone FF at the end is a byte
    whose end lies past the file."""
    ends, i, n = [], start, len(data)
    while i < n:
        if data[i] != 0xFF:
            ends.append(i + 1)
            i += 1
            continue
        j = i + 1
        while j < n and data[j] == 0xFF:
            j += 1
        if j >= n:
            ends.append(n + 1)
            return ends, -1
        if data[j] == 0:
            ends.append(j + 1)
            i = j + 1
            continue
        return ends, j + 1
    return ends, -1


def _reads_whole(data, pos, segments, units, restart, n_mcus,
                 in_cxx: bool) -> bool:
    """Whether libjpeg-turbo, fed as Pillow feeds it, decodes a sequential
    Huffman scan whose data runs to the end of the file: the last restart
    interval is the one that can ask for more (every earlier one ends at
    its RSTn), and an interval missing at the end always does."""
    interval = restart or n_mcus
    need = (n_mcus + interval - 1) // interval
    if len(segments) < need:
        return False
    start = pos
    if need > 1:
        marks = [m.end() for m in re.finditer(rb"\xff+[\xd0-\xd7]",
                                              data[pos:])]
        start = pos + marks[need - 2]
    ends, marker = interval_bytes(data, start)
    mcus = n_mcus - (need - 1) * interval
    if in_cxx:
        from wgpu_path_tracing_tpu_torch.accel.native import (
            jpeg_reads_whole_native)

        return jpeg_reads_whole_native(data, start, ends, marker, mcus, units,
                                       restart == 0)
    return huffman_reads_whole(data, start, ends, marker, mcus, units,
                               restart == 0)


class _Suspend(Exception):
    """libjpeg's source is out of data: ``decode_mcu`` suspends."""


class _Marker(Exception):
    """The bit reader reached the marker after the data."""


def huffman_reads_whole(data: bytes, start: int, ends: list, marker: int,
                        mcus: int, units: list, fast: bool) -> bool:
    """Whether libjpeg-turbo decodes ``mcus`` MCUs of sequential Huffman
    data from ``start`` (the restart interval that runs to the end of the
    file; ``ends`` and ``marker`` from ``interval_bytes``) without asking
    for a byte past the end, fed as Pillow feeds it: blocks of MAXBLOCK
    bytes, one more each time ``decode_mcu`` suspends (the MCU then decoded
    again from its start). The slow path fills the bit buffer to
    MIN_GET_BITS bits whenever a code's 8-bit lookahead, a long code's first
    9 bits or next bit, or a coefficient's extra bits are short; the fast
    path (``fast``: no restart interval; FAST_BYTES bytes a block of the
    MCU in the buffer) reads 6 bytes whenever 16 bits or fewer are left,
    and hands the MCU to the slow path at a marker (or FF FF). Once the
    marker after the data is read, libjpeg reads zeros and never suspends
    again. ``units`` as ``decode_scan`` takes them."""
    n = len(data)
    avail = min(n, -(-start // MAXBLOCK) * MAXBLOCK)
    nb = len(ends)
    prev = [start] + ends[:-1]
    ub = bytes(data[q] for q, _ in zip(prev, ends))  # FF 00 is FF
    win = _windows(ub) + _ZERO_TAIL
    plain = [e - q <= 2 for e, q in zip(ends, prev)]  # not FF FF .. 00
    blocks = [(dct.code, act.code) for _, dct, act, offsets, _, _ in units
              for _ in offsets]
    need_fast = FAST_BYTES * len(blocks)
    u = left = p = 0  # bytes fetched, bits held, bits consumed

    def fill():
        """jpeg_fill_bit_buffer: up to MIN_GET_BITS bits."""
        nonlocal u, left
        while left < MIN_GET_BITS:
            if u == nb:
                if marker < 0 or marker > avail:
                    raise _Suspend
                raise _Marker
            if ends[u] > avail:
                raise _Suspend
            u += 1
            left += 8

    def fast_fill():
        """FILL_BIT_BUFFER_FAST: 6 bytes when 16 bits or fewer are held."""
        nonlocal u, left
        if left <= 16:
            if u + 6 > nb or not all(plain[u:u + 6]):
                raise _Marker  # decode_mcu_fast backs out
            u += 6
            left += 48

    def take(n_bits: int, slow: bool, check: int) -> None:
        nonlocal left, p
        if slow and left < check:
            fill()
        left -= n_bits
        p += n_bits

    def symbol(table, slow: bool) -> int:
        """HUFF_DECODE (slow: the 8-bit lookahead, then jpeg_huff_decode's
        9 bits and one at a time) or HUFF_DECODE_FAST."""
        if not slow:
            fast_fill()
        elif left < 8:
            fill()
        e = table[(win[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
        length = e >> 8
        if not slow or length <= 8:
            take(length, False, 0)
        else:
            take(9, True, 9)
            for _ in range(length - 9):
                take(1, True, 1)
        return e & 255

    def mcu(slow: bool) -> None:
        for dct, act in blocks:
            s = symbol(dct, slow)
            if s:
                if not slow:
                    fast_fill()
                take(s, slow, s)
            k = 1
            while k < 64:
                rs = symbol(act, slow)
                r, s = rs >> 4, rs & 15
                if s:
                    if not slow:
                        fast_fill()
                    take(s, slow, s)
                    k += r + 1
                elif r == 15:
                    k += 16
                else:
                    break

    for _ in range(mcus):
        state = (u, left, p)
        slow_only = not fast
        while True:
            slow = slow_only or avail - (ends[u - 1] if u else start) < \
                need_fast
            try:
                mcu(slow)
                break
            except _Suspend:
                if avail >= n:
                    return False
                avail = min(n, avail + MAXBLOCK)
            except _Marker:
                if slow:
                    return True
                slow_only = True
            u, left, p = state
    return True


def _idct_1d(x):
    """jidctint.c's butterfly on eight int64 arrays of 16-bit values (one
    pass, before the descale): returns the eight outputs in order. The
    four sums libjpeg-turbo's SIMD IDCT forms in 16-bit lanes (in0 +- in4,
    in7 + in3, in5 + in1) wrap as there; its products and the other sums
    are exact in 32 bits, as here."""
    z2, z3 = x[2], x[6]
    z1 = (z2 + z3) * FIX_0_541196100
    tmp2 = z1 + z3 * -FIX_1_847759065
    tmp3 = z1 + z2 * FIX_0_765366865
    tmp0 = _wrap16(x[0] + x[4]) << CONST_BITS
    tmp1 = _wrap16(x[0] - x[4]) << CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x[7], x[5], x[3], x[1]
    z1, z2 = t0 + t3, t1 + t2
    z3, z4 = _wrap16(t0 + t2), _wrap16(t1 + t3)
    z5 = (z3 + z4) * FIX_1_175875602
    t0 = t0 * FIX_0_298631336
    t1 = t1 * FIX_2_053119869
    t2 = t2 * FIX_3_072711026
    t3 = t3 * FIX_1_501321110
    z1 = z1 * -FIX_0_899976223
    z2 = z2 * -FIX_2_562915447
    z3 = z3 * -FIX_1_961570560 + z5
    z4 = z4 * -FIX_0_390180644 + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4
    return (tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
            tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)


def _descale(x, n):
    """A 32-bit lane's rounded right shift: the sum wraps mod 2^32 first."""
    return ((x + (1 << (n - 1)) + (1 << 31)) & 0xFFFFFFFF) - (1 << 31) >> n


def idct_islow(coef: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """``jpeg_idct_islow`` on (N, 64) natural-order coefficients (int16, as
    libjpeg's JCOEF holds them) with a natural-order quantization table:
    (N, 8, 8) uint8 samples, as libjpeg-turbo's SIMD version
    (``jsimd_idct_islow``, SSE2 and AVX2) computes them, which Pillow
    runs: each product coefficient x step and the workspace are 16-bit
    (the columns pass keeps PASS1_BITS extra bits and saturates; a block
    with no AC coefficient in rows 1-7 takes the shortcut DC << PASS1_BITS,
    which wraps), the rows pass descales by CONST_BITS + PASS1_BITS + 3 and
    saturates to -128..127 before the 128 is added. On the values real
    images give this is ``jidctint.c``'s C code bit for bit; only corrupt
    data, whose coefficients overflow 16 bits on the way, tells them
    apart."""
    c = coef.reshape(-1, 64)
    blocks = _wrap16(c.astype(np.int64) * quant.astype(np.int64)).reshape(
        -1, 8, 8)
    cols = _idct_1d([blocks[:, k, :] for k in range(8)])
    ws = np.clip(np.stack([_descale(v, CONST_BITS - PASS1_BITS)
                           for v in cols], axis=1), -32768, 32767)
    dc_only = ~c[:, 8:].any(axis=1)
    ws[dc_only] = _wrap16(blocks[dc_only, 0, :] << PASS1_BITS)[:, None, :]
    rows = _idct_1d([ws[:, :, k] for k in range(8)])
    out = np.stack([_descale(r, CONST_BITS + PASS1_BITS + 3) for r in rows],
                   axis=2)
    return (np.clip(out, -128, 127) + 128).astype(np.uint8)


def _edge(a, axis, first):
    """``a`` shifted by one along ``axis``, its edge repeated: the previous
    sample (``first``) or the next."""
    n = a.shape[axis]
    idx = np.concatenate([[0], np.arange(n - 1)]) if first else np.concatenate(
        [np.arange(1, n), [n - 1]])
    return np.take(a, idx, axis=axis)


def _interleave(even, odd, axis):
    out = np.stack([even, odd], axis=axis + 1)
    shape = list(even.shape)
    shape[axis] *= 2
    return out.reshape(shape)


def upsample(plane: np.ndarray, hr: int, vr: int,
             fancy: bool = True) -> np.ndarray:
    """``jdsample.c`` at libjpeg-turbo's defaults on a component plane
    cropped to its downsampled size: fancy h2v1 and h2v2 (where the plane
    is more than two samples wide), fancy h1v2, box replication otherwise
    and wherever ``fancy`` is False; edges repeat the last real sample, as
    libjpeg's context rows do."""
    c = plane.astype(np.int64)
    w = c.shape[1]
    if (hr, vr) == (1, 1):
        return c
    if not fancy:
        return np.repeat(np.repeat(c, vr, axis=0), hr, axis=1)
    if (hr, vr) == (2, 1) and w > 2:
        three = 3 * c
        return _interleave((three + _edge(c, 1, True) + 1) >> 2,
                           (three + _edge(c, 1, False) + 2) >> 2, 1)
    if (hr, vr) == (1, 2):
        three = 3 * c
        return _interleave((three + _edge(c, 0, True) + 1) >> 2,
                           (three + _edge(c, 0, False) + 2) >> 2, 0)
    if (hr, vr) == (2, 2) and w > 2:
        three = 3 * c
        colsum = _interleave(three + _edge(c, 0, True),
                             three + _edge(c, 0, False), 0)
        three = 3 * colsum
        return _interleave((three + _edge(colsum, 1, True) + 8) >> 4,
                           (three + _edge(colsum, 1, False) + 7) >> 4, 1)
    return np.repeat(np.repeat(c, vr, axis=0), hr, axis=1)


def _parse_dht(seg: bytes, tables: dict, name: str) -> None:
    i = 0
    while i < len(seg):
        if i + 17 > len(seg):
            raise ValueError(f"{name}: bad DHT segment")
        tc, th = seg[i] >> 4, seg[i] & 15
        counts = list(seg[i + 1:i + 17])
        total = sum(counts)
        if tc > 1 or th > 3 or total > 256 or i + 17 + total > len(seg):
            raise ValueError(f"{name}: bad DHT segment")
        tables[(tc, th)] = HuffmanTable(counts, seg[i + 17:i + 17 + total])
        i += 17 + total


def _parse_dqt(seg: bytes, tables: dict, name: str) -> None:
    i = 0
    while i < len(seg):
        pq, tq = seg[i] >> 4, seg[i] & 15
        size = 64 * (2 if pq else 1)
        if pq > 1 or tq > 3 or i + 1 + size > len(seg):
            raise ValueError(f"{name}: bad DQT segment")
        zz = np.frombuffer(seg[i + 1:i + 1 + size], ">u2" if pq else np.uint8)
        natural = np.zeros(64, np.int64)
        natural[list(NATURAL_ORDER[:64])] = zz
        tables[tq] = natural
        i += 1 + size


def _parse_dac(seg: bytes, cond: dict, name: str) -> None:
    """``jdmarker.c::get_dac``: (Tc << 4 | Tb, value) pairs, a DC table's
    value U << 4 | L (L <= U), an AC table's Kx."""
    if len(seg) % 2:
        raise ValueError(f"{name}: bad DAC segment")
    for i in range(0, len(seg), 2):
        index, val = seg[i], seg[i + 1]
        if index >= 32 or (index < 16 and (val & 15) > (val >> 4)):
            raise ValueError(f"{name}: bad DAC segment")
        if index >= 16:
            cond["ac"][index - 16] = val
        else:
            cond["dc"][index] = (val & 15, val >> 4)


def _parse_sof(seg: bytes, name: str, kind: tuple) -> dict:
    if len(seg) < 6:
        raise ValueError(f"{name}: bad SOF segment")
    precision, height, width, nc = struct.unpack(">BHHB", seg[:6])
    if precision != 8:
        raise NotImplementedError(f"{name}: {precision}-bit JPEG samples are "
                                  "not supported (8-bit only)")
    if height == 0 or width == 0:
        raise NotImplementedError(f"{name}: a JPEG whose height comes in a "
                                  "DNL marker is not supported")
    if nc not in (1, 3, 4) or len(seg) != 6 + 3 * nc:  # libjpeg: bad length
        raise ValueError(f"{name}: a JPEG of {nc} components is not "
                         "supported")
    comps = []
    for k in range(nc):
        cid, hv, tq = seg[6 + 3 * k:9 + 3 * k]
        h, v = hv >> 4, hv & 15
        if not (1 <= h <= 4 and 1 <= v <= 4) or tq > 3:
            raise ValueError(f"{name}: bad sampling factors or table index")
        comps.append(Component(cid, h, v, tq))
    hmax = max(c.h for c in comps)
    vmax = max(c.v for c in comps)
    for c in comps:
        if hmax % c.h or vmax % c.v:
            raise NotImplementedError(f"{name}: fractional sampling ratios "
                                      "are not supported")
    progressive, arithmetic, lossless = kind
    unit = 1 if lossless else 8  # a lossless data unit is one sample
    mcus_x = -(-width // (unit * hmax))
    mcus_y = -(-height // (unit * vmax))
    for c in comps:
        c.width = -(-width * c.h // hmax)
        c.height = -(-height * c.v // vmax)
        c.grid_w, c.grid_h = mcus_x * c.h, mcus_y * c.v
        c.coef = array("i", bytes(4 * c.grid_w * c.grid_h * unit * unit))
        c.samples = None
    return {"width": width, "height": height, "comps": comps,
            "hmax": hmax, "vmax": vmax, "mcus_x": mcus_x, "mcus_y": mcus_y,
            "progressive": progressive, "arithmetic": arithmetic,
            "lossless": lossless, "block": unit, "scans": 0,
            "last_good": mcus_y}


def decode_jpeg_rgba(data: bytes, name: str = "image",
                     as_cmyk: bool = False) -> np.ndarray:
    """JPEG bytes -> (H, W, 4) uint8 RGBA, what Pillow's
    ``Image.open(...).convert("RGBA")`` returns for the files the module
    docstring lists; others raise naming ``name``. With ``as_cmyk`` a
    four-component frame is taken as CMYK whatever its Adobe transform
    says, so a YCCK frame is not converted: Pillow's BLP plugin sets the
    JPEG mode "CMYK", which libjpeg then trusts. A marker that Pillow's
    walk does not know before the first scan passes the bytes on
    (``sniff.NotThisFormat``)."""
    return _to_rgba(*_read_frame(data, name, True), name, as_cmyk)


def decode_jpeg_samples(data: bytes, name: str, ycbcr: bool
                        ) -> tuple[dict, np.ndarray]:
    """A JPEG stream as libtiff has libjpeg decode it inside a TIFF ->
    (its frame, (H, W, components) uint8 samples, upsampled): converted
    from YCbCr to RGB where ``ycbcr`` (libtiff's JPEGCOLORMODE_RGB, three
    components), else as they are (JCS_UNKNOWN: no colour conversion)."""
    frame = _read_frame(data, name, False)[0]
    planes = _planes(frame)
    if ycbcr and len(planes) == 3:
        return frame, _ycc_to_rgb(*planes)
    return frame, np.stack(planes, -1)


def decode_jpeg_raw(data: bytes, name: str) -> tuple[dict, list]:
    """A JPEG stream as libjpeg's ``jpeg_read_raw_data`` gives it (libtiff's
    old-style JPEG codec asks for it): (its frame, each component's
    samples at its own sampling, whole blocks, no upsampling or colour
    conversion)."""
    frame = _read_frame(data, name, False)[0]
    smooth = smoothing_ok(frame)
    return frame, [_component_plane(c, frame, smooth, crop=False)
                   for c in frame["comps"]]


def _read_frame(data: bytes, name: str, standalone: bool = False) -> tuple:
    """Parse and entropy-decode a JPEG: (frame, JFIF marker seen, Adobe
    marker seen, Adobe transform)."""
    from wgpu_path_tracing_tpu_torch.accel import native

    in_cxx = native.native_available()
    data = bytes(data)
    if data[:3] != b"\xff\xd8\xff":
        raise ValueError(f"{name}: not a JPEG file")
    pos = 2
    frame = None
    huff, quant = {}, {}
    cond = {"dc": [(0, 1)] * 16, "ac": [5] * 16}  # DAC's defaults
    restart = 0
    jfif = adobe = False
    transform = None
    scans = 0
    multi = False
    while True:
        # The next marker, past any fill bytes.
        while pos < len(data) and data[pos] != 0xFF:
            pos += 1
        while pos < len(data) and data[pos] == 0xFF:
            pos += 1
        if pos >= len(data):
            if scans and not multi:
                break  # no EOI after a single scan, as Pillow tolerates
            raise ValueError(f"{name}: truncated JPEG data (no "
                             f"{'EOI after its scans' if scans else 'scan'}"
                             ")")
        marker = data[pos]
        pos += 1
        if marker == EOI:
            break
        if marker == 0x00:  # FF 00 outside a scan: junk to libjpeg
            continue
        if marker < 0xC0 and not scans:
            from wgpu_path_tracing_tpu_torch.utils.sniff import NotThisFormat

            # Pillow's own marker walk up to the first scan knows no
            # marker below 0xC0 (TEM and the reserved ones): it passes
            # the bytes on
            raise (NotThisFormat if standalone else ValueError)(
                f"{name}: no JPEG marker found (FF {marker:02X})")
        if marker == SOI or 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue
        if marker < 0xC0 or marker in UNKNOWN_MARKERS:
            raise ValueError(f"{name}: unsupported JPEG marker FF "
                             f"{marker:02X} (libjpeg refuses it)")
        if pos + 2 > len(data) or len(data) - pos < struct.unpack(
                ">H", data[pos:pos + 2])[0]:
            if scans and not multi:
                break  # libjpeg's finish waits on it; Pillow has its rows
            raise ValueError(f"{name}: truncated JPEG data")
        (length,) = struct.unpack(">H", data[pos:pos + 2])
        seg = data[pos + 2:pos + length]
        if length < 2 and (0xE0 <= marker <= 0xEF or marker == 0xFE):
            pos += 2  # an APPn or COM length under 2: no payload to skip
            continue
        if length < 2:
            raise ValueError(f"{name}: truncated JPEG data")
        pos += length
        if marker in SOF_UNSUPPORTED:
            raise NotImplementedError(
                f"{name}: {SOF_UNSUPPORTED[marker]} JPEG images are not "
                "supported (libjpeg-turbo decodes none)")
        if marker in SOF_KINDS:
            if frame is not None:
                raise ValueError(f"{name}: two frames in one JPEG")
            frame = _parse_sof(seg, name, SOF_KINDS[marker])
        elif marker == DHT:
            _parse_dht(seg, huff, name)
        elif marker == DAC:
            _parse_dac(seg, cond, name)
        elif marker == DQT:
            _parse_dqt(seg, quant, name)
        elif marker == DRI:
            if len(seg) < 2:
                raise ValueError(f"{name}: bad DRI segment")
            (restart,) = struct.unpack(">H", seg[:2])
        elif marker == 0xE0 and len(seg) >= 14 and seg[:5] == b"JFIF\0":
            jfif = True
        elif marker == 0xEE and len(seg) >= 12 and seg[:5] == b"Adobe":
            adobe, transform = True, seg[11]
        elif marker == DNL:
            raise NotImplementedError(f"{name}: DNL markers are not "
                                      "supported")
        elif marker == SOS:
            if frame is None:
                raise ValueError(f"{name}: a scan before the frame header")
            if scans and not multi:
                raise ValueError(f"{name}: a second scan in a single-scan "
                                 "JPEG (libjpeg: EOI expected)")
            pos = _read_scan(data, pos, seg, frame, huff, quant, cond,
                             restart, name, in_cxx)
            if not scans:
                # libjpeg's has_multiple_scans: it reads every scan, up to
                # EOI, before any output, and Pillow finds the file
                # truncated where EOI is missing
                multi = frame["progressive"] or seg[0] < len(frame["comps"])
            scans += 1
            if not multi and not standalone:
                # In a TIFF, libjpeg reads what follows a single scan only
                # after the rows (libtiff's finish_decompress): an error
                # there leaves them read, and Pillow keeps them.
                break

    if frame is None or not scans:
        raise ValueError(f"{name}: no image data in the JPEG")
    if frame["lossless"] and any(c.samples is None for c in frame["comps"]):
        raise ValueError(f"{name}: a lossless JPEG ends before every "
                         "component's scan (libjpeg-turbo refuses it)")
    return frame, jfif, adobe, transform


def _check_progression(comps, ss, se, ah, al, scan: int, name) -> None:
    """``jdphuff.c::start_pass_phuff_decoder``'s checks: a DC scan has Se =
    0, an AC scan one component and Ss <= Se < 64, a refinement Al = Ah -
    1, Al <= 13; these raise. Then the histories of coefficients min(Ss,
    1)..max(Se, 9) are kept as they were before this scan (all 0 in the
    file's first scan: libjpeg-turbo's ``prev_coef_bits``, which block
    smoothing reads past a scan cut short), and each coefficient's history
    in the band is set to Al; a history that does not match Ah
    (``JWRN_BOGUS_PROGRESSION``) is a warning there and changes nothing
    here."""
    if ss == 0:
        bad = se != 0
    else:
        bad = ss > se or se >= 64 or len(comps) != 1
    if (ah and al != ah - 1) or al > 13 or bad:
        raise ValueError(f"{name}: bad progressive JPEG scan (Ss={ss}, "
                         f"Se={se}, Ah={ah}, Al={al})")
    for c in comps:
        lo, hi = min(ss, 1), max(se, 9) + 1
        c.prev_bits[lo:hi] = c.coef_bits[lo:hi] if scan > 1 else [0] * (
            hi - lo)
        c.coef_bits[ss:se + 1] = [al] * (se + 1 - ss)


def _read_lossless_scan(data, pos, comps, keys, frame, huff, restart, psv,
                        se, ah, pt, name, in_cxx: bool) -> int:
    """A lossless scan (``jdlossls.c``, ``jddiffct.c``, ``jdlhuff.c``):
    its checks (predictor 1-7, Se and Ah 0, Pt below 8, a restart interval
    of whole MCU rows), its differences, then each component's samples
    undifferenced into ``c.samples``. Returns the position of the marker
    after it."""
    if not 1 <= psv <= 7 or se or ah or pt >= 8:
        raise ValueError(f"{name}: bad lossless JPEG scan (predictor {psv},"
                         f" Se={se}, Ah={ah}, Pt={pt})")
    try:
        units, n_mcus = _scan_units(comps, frame)
    except ValueError as exc:
        raise ValueError(f"{name}: {exc}") from None
    mcus_row = units[0][3]
    if restart % mcus_row:
        raise ValueError(f"{name}: a lossless JPEG's restart interval "
                         f"({restart}) is not a whole number of MCU rows "
                         f"({mcus_row} MCUs)")
    tables = []
    for (key_dc, _), c in zip(keys, comps):
        if _table(huff, key_dc) is None:
            raise ValueError(f"{name}: a scan uses an undefined Huffman "
                             "table")
        if huff[key_dc].max_symbol > 16:
            raise ValueError(f"{name}: bad Huffman table (a lossless symbol "
                             "above 16)")
        tables.append(huff[key_dc])
        c.coef = array("i", bytes(4 * c.grid_w * c.grid_h))
    segments, end = _entropy_segments(data, pos, name)
    if end == len(data):
        # jdlhuff.c's refills are not modelled: a lossless scan that runs
        # to the end of the file is refused, as libjpeg mostly waits there
        raise ValueError(f"{name}: truncated JPEG data (no marker after the "
                         "scan)")
    units = [(c, t, None, offs, stride, row)
             for (c, offs, stride, row), t in zip(units, tables)]
    if in_cxx:
        from wgpu_path_tracing_tpu_torch.accel import native

        skipped = native.jpeg_scan_native(segments, units, restart, n_mcus,
                                          5, 0, 0, 0, unit=1)
    else:
        skipped = decode_lossless_scan(segments, units, restart, n_mcus, name)
    for c in comps:
        first = lossless_first_rows(c, len(comps) > 1, restart, mcus_row,
                                    skipped)
        diff = np.frombuffer(c.coef, np.int32).reshape(
            c.grid_h, c.grid_w)[:c.height, :c.width]
        if in_cxx:
            c.samples = native.jpeg_undifference_native(diff, first, psv, pt)
        else:
            c.samples = undifference(diff, first, psv, pt)
    return end


def _read_scan(data, pos, seg, frame, huff, quant, cond, restart, name,
               in_cxx: bool) -> int:
    """One SOS: its header, then its entropy-coded data (through
    ``accel/cbvh/jpeg_scan.cpp`` where ``in_cxx``); returns the
    position of the marker after it. A sequential Huffman scan needs both
    tables of each component (its Ss, Se, Ah and Al are ignored, as
    libjpeg ignores them with a warning); a progressive DC first scan the
    DC tables, an AC scan its AC table, a DC refinement none. Arithmetic
    coding needs no table segment: its statistics start at 0, conditioned
    as the DAC segments so far say (``cond``). A lossless scan reads its
    predictor from Ss and its point transform from Al."""
    ns = seg[0] if seg else 0
    if not 1 <= ns <= 4 or len(seg) != 4 + 2 * ns:  # libjpeg: bad length
        raise ValueError(f"{name}: bad SOS segment")
    ss, se, ahl = seg[1 + 2 * ns], seg[2 + 2 * ns], seg[3 + 2 * ns]
    ah, al = ahl >> 4, ahl & 15
    progressive = frame["progressive"]
    needs_dc = not progressive or (ss == 0 and ah == 0)
    needs_ac = not progressive or ss != 0
    by_id = {c.id: c for c in frame["comps"]}
    comps, keys = [], []
    for k in range(ns):
        cid, tables = seg[1 + 2 * k], seg[2 + 2 * k]
        if cid not in by_id or by_id[cid] in comps:
            raise ValueError(f"{name}: a scan names an unknown component, or "
                             "one twice (libjpeg: invalid component ID)")
        comps.append(by_id[cid])
        keys.append(((0, tables >> 4), (1, tables & 15)))
    if frame["lossless"]:
        return _read_lossless_scan(data, pos, comps, keys, frame, huff,
                                   restart, ss, se, ah, al, name, in_cxx)
    # libjpeg's order: the MCU's size, the quantization tables, the
    # progression, the Huffman tables.
    try:
        units, n_mcus = _scan_units(comps, frame)
    except ValueError as exc:
        raise ValueError(f"{name}: {exc}") from None
    for c in comps:
        if c.quant is None:
            if c.tq not in quant:
                raise ValueError(f"{name}: a component uses an undefined "
                                 "quantization table")
            c.quant = quant[c.tq]  # latched, as libjpeg does
    frame["scans"] += 1
    if progressive:
        _check_progression(comps, ss, se, ah, al, frame["scans"], name)
    mode = 0 if not progressive else (
        (1 if ah == 0 else 2) if ss == 0 else (3 if ah == 0 else 4))
    if frame["arithmetic"]:
        segments, end = _entropy_segments(data, pos, name)
        units = [(c, key_dc[1], key_ac[1], offs, stride, row)
                 for (c, offs, stride, row), (key_dc, key_ac)
                 in zip(units, keys)]
        if in_cxx:
            from wgpu_path_tracing_tpu_torch.accel.native import (
                jpeg_arith_scan_native)

            read = jpeg_arith_scan_native(segments, units, restart, n_mcus,
                                          mode, ss, se, al, cond)
        else:
            read = decode_arith_scan(segments, units, restart, n_mcus, mode,
                                     ss, se, al, cond)
        if end == len(data):
            # jdarith.c cannot suspend: it fails if it reads past the end
            # (a last FF wants the byte after it)
            need = restart_intervals(segments, restart, n_mcus)[1]
            have = len(segments[-1]) - (data[-1] == 0xFF)
            if progressive or len(segments) < len(need) or read > have:
                raise ValueError(f"{name}: truncated JPEG data (no marker "
                                 "after the scan)")
        return end
    dcs, acs = [], []
    for key_dc, key_ac in keys:
        if (needs_dc and _table(huff, key_dc) is None) or (
                needs_ac and _table(huff, key_ac) is None):
            raise ValueError(f"{name}: a scan uses an undefined Huffman "
                             "table")
        if needs_dc and huff[key_dc].max_symbol > 15:
            raise ValueError(f"{name}: bad Huffman table (a DC symbol above "
                             "15)")
        dcs.append(huff[key_dc] if needs_dc else None)
        acs.append(huff[key_ac] if needs_ac else None)
    segments, end = _entropy_segments(data, pos, name)
    units = [(c, dc, ac, offs, stride, row)
             for (c, offs, stride, row), dc, ac in zip(units, dcs, acs)]
    if end == len(data) and (progressive or not _reads_whole(
            data, pos, segments, units, restart, n_mcus, in_cxx)):
        raise ValueError(f"{name}: truncated JPEG data (no marker after the "
                         "scan, and libjpeg waits for more)")
    if in_cxx:
        from wgpu_path_tracing_tpu_torch.accel.native import jpeg_scan_native

        last_good = jpeg_scan_native(segments, units, restart, n_mcus, mode,
                                     ss, se, al)
    elif progressive:
        last_good = decode_progressive_scan(segments, units, restart, n_mcus,
                                            ss, se, ah, al, name)
    else:
        last_good = decode_scan(segments, units, restart, n_mcus)
    # libjpeg's last_good_iMCU_row: an interleaved scan's MCU row is an
    # iMCU row, a scan of one component has v block rows an iMCU row.
    my = last_good // units[0][5]
    frame["last_good"] = my if len(comps) > 1 else my // comps[0].v
    return end


# Natural positions of zigzag coefficients 1..9, the ones block smoothing
# estimates (jdcoefct.c's Q01_POS, Q10_POS, Q20_POS, Q11_POS, Q02_POS,
# Q03_POS, Q12_POS, Q21_POS, Q30_POS).
SMOOTH_POS = tuple(NATURAL_ORDER[1:10])


def smoothing_ok(frame: dict) -> bool:
    """``jdcoefct.c::smoothing_ok`` on the finished file: a progressive
    frame whose every component has its quantization table latched, with
    the DC and the nine smoothed coefficients' steps nonzero, and some DC
    bits sent, where some component's coefficients 1..9 still lack bits."""
    if not frame["progressive"]:
        return False
    useful = False
    for c in frame["comps"]:
        if c.quant is None or c.coef_bits[0] < 0:
            return False
        if any(int(c.quant[p]) == 0 for p in (0,) + SMOOTH_POS):
            return False
        useful = useful or any(b != 0 for b in c.coef_bits[1:10])
    return useful


def _estimate(num, q: int, al: int):
    """jdcoefct.c's rounded estimate ``num / (q << 8)`` for a coefficient
    whose history is ``al``: the magnitude capped below 1 << Al where Al >
    0, the sign of ``num``."""
    mag = ((q << 7) + np.abs(num)) // (q << 8)
    if al > 0:
        mag = np.minimum(mag, (1 << al) - 1)
    return np.where(num >= 0, mag, -mag)


def smooth_blocks(coef: np.ndarray, c, rows_total: int,
                  bits: list | None = None) -> np.ndarray:
    """``jdcoefct.c::decompress_smooth_data`` (libjpeg-turbo 2.1 and later)
    on component ``c``'s (grid_h, grid_w, 64) natural-order coefficients,
    int16 values: a copy whose real blocks have coefficients 1..9
    estimated where still zero and not known exact, from the DC values of
    the 5x5 blocks around each (where no AC coefficient 1..9 was ever sent,
    a Gaussian-like kernel, and the DC itself replaced; else the extension
    of ISO 10918-1 K.8 to 5x5). Columns beyond the component's last real
    one repeat it; the rows above and below are picked as libjpeg picks
    them per iMCU row (``block_rows`` is the last iMCU row's real count
    there, so a row's second neighbour below can be a padding row of the
    grid). ``rows_total``: the frame's iMCU rows; ``bits``: the
    coefficients' histories (``c.coef_bits`` where not given)."""
    bits = c.coef_bits if bits is None else bits
    wib, hib, v = -(-c.width // 8), -(-c.height // 8), c.v
    q = [int(c.quant[0])] + [int(c.quant[p]) for p in SMOOTH_POS]
    dc = coef[..., 0].astype(np.int64)
    r_abs = np.arange(hib)
    imcu, b = r_abs // v, r_abs % v
    last = hib % v or v
    block_rows = np.where(imcu < rows_total - 1, v, last)
    ibr = imcu * block_rows + b
    ibrs = block_rows * rows_total
    prev = np.where(ibr > 0, r_abs - 1, r_abs)
    prev2 = np.where(ibr > 1, r_abs - 2, prev)
    nxt = np.where(ibr < ibrs - 1, r_abs + 1, r_abs)
    nxt2 = np.where(ibr < ibrs - 2, r_abs + 2, nxt)
    cols = np.arange(wib)
    D = [None]  # D[1..25]: jdcoefct.c's DC01..DC25, row by row
    for rows in (prev2, prev, r_abs, nxt, nxt2):
        for d in (-2, -1, 0, 1, 2):
            D.append(dc[rows[:, None], np.clip(cols + d, 0, wib - 1)[None]])
    change_dc = all(x == -1 for x in bits[1:10])
    ws = coef[:hib, :wib].astype(np.int64)
    q00 = q[0]
    if change_dc:
        nums = [
            -D[1] - D[2] + D[4] + D[5] - 3 * D[6] + 13 * D[7] - 13 * D[9]
            + 3 * D[10] - 3 * D[11] + 38 * D[12] - 38 * D[14] + 3 * D[15]
            - 3 * D[16] + 13 * D[17] - 13 * D[19] + 3 * D[20] - D[21]
            - D[22] + D[24] + D[25],
            -D[1] - 3 * D[2] - 3 * D[3] - 3 * D[4] - D[5] - D[6] + 13 * D[7]
            + 38 * D[8] + 13 * D[9] - D[10] + D[16] - 13 * D[17]
            - 38 * D[18] - 13 * D[19] + D[20] + D[21] + 3 * D[22]
            + 3 * D[23] + 3 * D[24] + D[25],
            D[3] + 2 * D[7] + 7 * D[8] + 2 * D[9] - 5 * D[12] - 14 * D[13]
            - 5 * D[14] + 2 * D[17] + 7 * D[18] + 2 * D[19] + D[23],
            -D[1] + D[5] + 9 * D[7] - 9 * D[9] - 9 * D[17] + 9 * D[19]
            + D[21] - D[25],
            2 * D[7] - 5 * D[8] + 2 * D[9] + D[11] + 7 * D[12] - 14 * D[13]
            + 7 * D[14] + D[15] + 2 * D[17] - 5 * D[18] + 2 * D[19],
            D[7] - D[9] + 2 * D[12] - 2 * D[14] + D[17] - D[19],
            D[7] - 3 * D[8] + D[9] - D[17] + 3 * D[18] - D[19],
            D[7] - D[9] - 3 * D[12] + 3 * D[14] + D[17] - D[19],
            D[7] + 2 * D[8] + D[9] - D[17] - 2 * D[18] - D[19]]
    else:
        nums = [
            -7 * D[11] + 50 * D[12] - 50 * D[14] + 7 * D[15],
            -7 * D[3] + 50 * D[8] - 50 * D[18] + 7 * D[23],
            -D[3] + 13 * D[8] - 24 * D[13] + 13 * D[18] - D[23],
            D[10] + D[16] - 10 * D[17] + 10 * D[19] - D[2] - D[20] + D[22]
            - D[24] + D[4] - D[6] + 10 * D[7] - 10 * D[9],
            -D[11] + 13 * D[12] - 24 * D[13] + 13 * D[14] - D[15]]
    for k, num in enumerate(nums, start=1):
        pos, al = SMOOTH_POS[k - 1], bits[k]
        if al == 0:
            continue
        cur = ws[..., pos]
        ws[..., pos] = np.where(cur == 0, _estimate(q00 * num, q[k], al), cur)
    if change_dc:
        num = q00 * (
            -2 * D[1] - 6 * D[2] - 8 * D[3] - 6 * D[4] - 2 * D[5] - 6 * D[6]
            + 6 * D[7] + 42 * D[8] + 6 * D[9] - 6 * D[10] - 8 * D[11]
            + 42 * D[12] + 152 * D[13] + 42 * D[14] - 8 * D[15] - 6 * D[16]
            + 6 * D[17] + 42 * D[18] + 6 * D[19] - 6 * D[20] - 2 * D[21]
            - 6 * D[22] - 8 * D[23] - 6 * D[24] - 2 * D[25])
        ws[..., 0] = _estimate(num, q00, 0)
    out = coef.copy()
    out[:hib, :wib] = ((ws + 32768) & 0xFFFF) - 32768  # JCOEF wraps
    return out


def _component_plane(c, frame: dict, smooth: bool,
                     crop: bool = True) -> np.ndarray:
    """The component's samples, its block grid (block-smoothed where
    ``smooth``) through ``idct_islow``, cropped to its downsampled size. A
    component no scan named has no quantization table: libjpeg's IDCT then
    multiplies by zeros, a plane of 128. A lossless frame's samples come
    undifferenced from its scans (``_read_frame`` refuses a lossless frame
    with a component no scan named)."""
    if frame["lossless"]:
        return c.samples
    coef = np.frombuffer(c.coef, np.int32).astype(np.int16)  # JCOEF wraps
    coef = coef.reshape(c.grid_h, c.grid_w, 64)
    if smooth:
        rows, good = frame["mcus_y"], frame["last_good"]
        out = smooth_blocks(coef, c, rows)
        if good < rows - 1:
            # jdcoefct.c: past the last scan's last good iMCU row the
            # histories are those from before each component's last scan
            # (all -1 where the file has one scan).
            prev = c.prev_bits if frame["scans"] > 1 else [-1] * 64
            past = (np.arange(c.grid_h) // c.v > good)[:, None, None]
            out = np.where(past, smooth_blocks(coef, c, rows, prev), out)
        coef = out
    quant = c.quant if c.quant is not None else np.zeros(64, np.int64)
    blocks = idct_islow(coef.reshape(-1, 64), quant)
    plane = blocks.reshape(c.grid_h, c.grid_w, 8, 8).transpose(
        0, 2, 1, 3).reshape(c.grid_h * 8, c.grid_w * 8)
    return plane[:c.height, :c.width] if crop else plane


def _muldiv255(a, b):
    """Pillow's ``MULDIV255``: a * b / 255, rounded, in integers."""
    t = a * b + 128
    return ((t >> 8) + t) >> 8


def pillow_cmyk_to_rgb(cmyk: np.ndarray) -> np.ndarray:
    """Pillow's ``cmyk2rgb`` (Convert.c) on (..., 4) CMYK samples as Pillow
    holds them: each of R, G, B is ``255 - K`` less ``MULDIV255`` of its
    ink and ``255 - K``."""
    x = np.asarray(cmyk).astype(np.int64)
    nk = 255 - x[..., 3:4]
    return np.clip(nk - _muldiv255(x[..., :3], nk), 0, 255).astype(np.uint8)


def _planes(frame) -> list:
    """Each component's samples, upsampled to the frame's size. libjpeg-turbo
    upsamples a lossless frame by replication only (its fancy upsampling
    needs DCT blocks of more than one sample)."""
    w, h = frame["width"], frame["height"]
    smooth = smoothing_ok(frame)
    return [upsample(_component_plane(c, frame, smooth),
                     frame["hmax"] // c.h, frame["vmax"] // c.v,
                     fancy=not frame["lossless"])[:h, :w]
            for c in frame["comps"]]


def _ycc_to_rgb(y, cb, cr) -> np.ndarray:
    """libjpeg's YCbCr -> RGB (jdcolor.c's tables): (H, W, 3) uint8."""
    out = np.empty(y.shape + (3,), np.uint8)
    out[..., 0] = np.clip(y + _CR_R[cr], 0, 255)
    out[..., 1] = np.clip(y + ((_CB_G[cb] + _CR_G[cr]) >> 16), 0, 255)
    out[..., 2] = np.clip(y + _CB_B[cb], 0, 255)
    return out


def _to_rgba(frame, jfif, adobe, transform, name,
             as_cmyk: bool = False) -> np.ndarray:
    w, h = frame["width"], frame["height"]
    comps = frame["comps"]
    planes = _planes(frame)
    out = np.full((h, w, 4), 255, np.uint8)
    if len(comps) == 1:
        out[..., :3] = planes[0][..., None]
        return out
    if len(comps) == 4:
        # jdapimin.c default_decompress_parms: CMYK without an Adobe
        # marker or under transform 0, YCCK under 2 (and, with a warning,
        # any other transform).
        c, m, y, k = planes
        ycck = adobe and transform != 0 and not as_cmyk
        if ycck and frame["lossless"]:
            raise NotImplementedError(
                f"{name}: a lossless YCCK JPEG is not supported (libjpeg-turbo"
                " converts no colour space of a lossless frame)")
        if ycck:  # jdcolor.c ycck_cmyk_convert
            c, m, y = (np.clip(255 - (c + _CR_R[y]), 0, 255),
                       np.clip(255 - (c + ((_CB_G[m] + _CR_G[y]) >> 16)), 0,
                               255),
                       np.clip(255 - (c + _CB_B[m]), 0, 255))
        # Pillow reads the samples as "CMYK;I" (each inverted), then
        # converts with cmyk2rgb.
        out[..., :3] = pillow_cmyk_to_rgb(255 - np.stack([c, m, y, k], -1))
        return out
    # libjpeg's guess of the colour space (jdapimin.c
    # default_decompress_parms).
    # A lossless frame with neither marker is RGB whatever its ids (and
    # libjpeg-turbo converts no colour space of a lossless frame).
    if jfif:
        rgb = False
    elif adobe:
        rgb = transform == 0
    else:
        rgb = frame["lossless"] or [c.id for c in comps] == [82, 71, 66]
    if not rgb and frame["lossless"]:
        raise NotImplementedError(
            f"{name}: a lossless YCbCr JPEG is not supported (libjpeg-turbo "
            "converts no colour space of a lossless frame)")
    if rgb:
        for k in range(3):
            out[..., k] = planes[k]
        return out
    out[..., :3] = _ycc_to_rgb(*planes)
    return out
