"""Baseline JPEG decoding in NumPy, the pixels Pillow gives.

The JAX package reads JPEG textures and LDR environment maps with Pillow
(``Image.open(...).convert("RGBA")``), which decodes with libjpeg-turbo at
its defaults. This module decodes the same files to the same bytes:

* frames: baseline and extended sequential Huffman (SOF0, SOF1) at 8 bits,
  one scan or several, interleaved or not, with restart intervals (DRI,
  RSTn), several DQT and DHT segments, any size;
* components: 1 (gray, replicated, alpha 255) or 3: YCbCr, or RGB where an
  Adobe marker says transform 0 (or, with neither a JFIF nor an Adobe
  marker, the component ids are 'R', 'G', 'B'), as libjpeg guesses;
* every sampling factor libjpeg accepts (integer ratios to the largest);
* libjpeg-turbo's default arithmetic: ``jidctint.c``'s integer IDCT
  (``JDCT_ISLOW``: CONST_BITS 13, PASS1_BITS 2, its range-limit table),
  ``jdsample.c``'s fancy (triangle) upsampling for h2v1, h1v2 and h2v2
  with its alternating rounding bias (box replication for a component two
  samples wide or less under h2v1 and h2v2, and for other ratios), and
  ``jdcolor.c``'s fixed-point YCbCr tables. libjpeg-turbo's SIMD paths
  give these routines' results bit for bit.

EXIF orientation is ignored, as ``Image.open`` ignores it. Progressive,
arithmetic-coded, lossless, hierarchical and 12-bit files, and 4-component
(CMYK, YCCK) ones, raise ``NotImplementedError`` naming the image;
truncated or malformed data raises ``ValueError`` naming it.

The entropy decode is serial: ``decode_scan`` walks the bits in Python
over lookup tables that resolve a code and its extra bits at once. The
IDCT, the upsampling and the colour conversion are whole-array NumPy.
"""

from __future__ import annotations

import re
import struct
from array import array

import numpy as np

SOI, EOI, SOS, DQT, DHT, DRI, DNL = 0xD8, 0xD9, 0xDA, 0xDB, 0xC4, 0xDD, 0xDC
SOF_SEQUENTIAL = (0xC0, 0xC1)
SOF_UNSUPPORTED = {
    0xC2: "progressive", 0xC3: "lossless", 0xC5: "hierarchical",
    0xC6: "hierarchical progressive", 0xC7: "hierarchical lossless",
    0xC9: "arithmetic-coded", 0xCA: "arithmetic-coded progressive",
    0xCB: "arithmetic-coded lossless", 0xCD: "arithmetic-coded hierarchical",
    0xCE: "arithmetic-coded hierarchical progressive",
    0xCF: "arithmetic-coded hierarchical lossless"}

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


def _idct_range_limit() -> np.ndarray:
    """``IDCT_range_limit`` (jdmaster.c ``prepare_range_limit_table``): the
    sample for a centred IDCT output x is table[x & 1023]: x + 128 for x in
    [-128, 127], 255 above up to 511, 0 below down to -512, wrapping past
    that as libjpeg's table does."""
    x = np.arange(1024)
    out = np.where(x < 128, x + 128, 0)
    out = np.where((x >= 128) & (x < 512), 255, out)
    out = np.where(x >= 896, x - 896, out)
    return out.astype(np.uint8)


_RANGE_LIMIT = _idct_range_limit()


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
    """A DHT table as three 65,536-entry lookups on the next 16 bits:
    ``code`` gives (code length, symbol) for any code, 0 where no code
    starts; ``dc`` (bits consumed, difference) and ``ac`` (bits consumed,
    zero run, coefficient; run -1 at the end of block, 16 and no
    coefficient at a run of 16 zeros) resolve a code and its extra bits
    together where they fit in the 16 bits, and give 0 bits elsewhere."""

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
        self.code = (code_len << 8 | code_sym).tolist()
        pattern = np.arange(1 << 16, dtype=np.int64)
        size = code_sym & 15
        total = code_len + size
        fits = (code_len > 0) & (total <= 16)
        raw = (pattern >> np.maximum(16 - total, 0)) & ((1 << size) - 1)
        value = np.where(raw < (1 << np.maximum(size - 1, 0)),
                         raw - (1 << size) + 1, raw)
        value = np.where(size == 0, 0, value)
        used = np.where(fits, total, 0)
        self.dc = list(zip(used.tolist(), value.tolist()))
        run = code_sym >> 4
        run = np.where(size > 0, run, np.where(run == 15, 16, -1))
        self.ac = list(zip(used.tolist(), run.tolist(), value.tolist()))


class Component:
    """A frame component: its id, sampling factors, quantization table
    index, its block grid (the MCU-padded grid for interleaved scans) and
    its coefficients, natural order, int32."""

    def __init__(self, cid, h, v, tq):
        self.id, self.h, self.v, self.tq = cid, h, v, tq
        self.quant = None  # latched at the component's first scan
        self.coef = None


def _extend(v: int, s: int) -> int:
    return v - (1 << s) + 1 if v < (1 << (s - 1)) else v


def _windows(segment: bytes) -> list:
    """32-bit big-endian windows of ``segment`` at every byte, zero-padded
    past its end: bit p's window is windows[p >> 3]."""
    a = np.frombuffer(segment + b"\0" * 8, np.uint8).astype(np.uint32)
    n = len(segment) + 4
    w = (a[0:n] << 24) | (a[1:n + 1] << 16) | (a[2:n + 2] << 8) | a[3:n + 3]
    return w.tolist()


def decode_scan(segments: list, units: list, restart: int, n_mcus: int,
                name: str) -> None:
    """The entropy-coded data of one scan into its components'
    coefficients. ``segments``: the unstuffed bytes between restart
    markers; ``units``: for each data unit of an MCU in order, (component,
    DC table, AC table, list of block offsets a MCU, blocks a MCU row
    stride and MCUs a row) as ``_scan_units`` makes them; ``restart``: MCUs
    a restart interval (0: none); ``n_mcus``: the scan's MCU count."""
    zz = NATURAL_ORDER
    interval = restart or n_mcus
    need = (n_mcus + interval - 1) // interval
    if len(segments) < need:
        raise ValueError(f"{name}: truncated JPEG data ({len(segments)} of "
                         f"{need} restart intervals)")
    mcus_row = units[0][5]
    for seg_i in range(need):
        win = _windows(segments[seg_i])
        p = 0
        preds = {}
        first = seg_i * interval
        try:
            for m in range(first, min(first + interval, n_mcus)):
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
                            if not e:
                                raise ValueError(f"{name}: bad Huffman code")
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
                                if not e:
                                    raise ValueError(
                                        f"{name}: bad Huffman code")
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
        except IndexError:
            raise ValueError(f"{name}: truncated JPEG data") from None
        if p > 8 * len(segments[seg_i]):
            raise ValueError(f"{name}: truncated JPEG data")


def _scan_units(comps: list, frame: dict):
    """Each data unit of one MCU of a scan over ``comps``: (component, its
    block offsets in the component's grid (row * grid width + column),
    the grid's blocks a MCU row, MCUs a row) and the scan's MCU count. An
    interleaved scan's MCU holds h x v blocks of each component; a scan of
    one component walks its blocks one by one over the component's own
    extent (ceil(downsampled size / 8))."""
    if len(comps) == 1:
        c = comps[0]
        bw, bh = -(-c.width // 8), -(-c.height // 8)
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
    the position of that marker)."""
    end = pos
    while True:
        j = data.find(b"\xff", end)
        if j < 0 or j + 1 >= len(data):
            raise ValueError(f"{name}: truncated JPEG data (no marker after "
                             "the scan)")
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


def _idct_1d(x):
    """jidctint.c's butterfly on eight int64 arrays (one pass, before the
    descale): returns the eight outputs in order."""
    z2, z3 = x[2], x[6]
    z1 = (z2 + z3) * FIX_0_541196100
    tmp2 = z1 + z3 * -FIX_1_847759065
    tmp3 = z1 + z2 * FIX_0_765366865
    tmp0 = (x[0] + x[4]) << CONST_BITS
    tmp1 = (x[0] - x[4]) << CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
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
    return (x + (1 << (n - 1))) >> n


def idct_islow(coef: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """``jpeg_idct_islow`` on (N, 64) natural-order coefficients (int16, as
    libjpeg's JCOEF holds them) with a natural-order quantization table:
    (N, 8, 8) uint8 samples. The columns pass keeps PASS1_BITS extra bits
    (int, as libjpeg's workspace), the rows pass descales by CONST_BITS +
    PASS1_BITS + 3 and range-limits through ``_RANGE_LIMIT``. libjpeg's
    shortcuts for all-zero AC columns and rows give the same values."""
    blocks = (coef.astype(np.int64) * quant.astype(np.int64)).reshape(
        -1, 8, 8)
    cols = _idct_1d([blocks[:, k, :] for k in range(8)])
    ws = np.stack([_descale(c, CONST_BITS - PASS1_BITS) for c in cols],
                  axis=1)
    rows = _idct_1d([ws[:, :, k] for k in range(8)])
    out = np.stack([_descale(r, CONST_BITS + PASS1_BITS + 3) for r in rows],
                   axis=2)
    return _RANGE_LIMIT[out & 1023]


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


def upsample(plane: np.ndarray, hr: int, vr: int) -> np.ndarray:
    """``jdsample.c`` at libjpeg-turbo's defaults on a component plane
    cropped to its downsampled size: fancy h2v1 and h2v2 (where the plane
    is more than two samples wide), fancy h1v2, box replication otherwise;
    edges repeat the last real sample, as libjpeg's context rows do."""
    c = plane.astype(np.int64)
    w = c.shape[1]
    if (hr, vr) == (1, 1):
        return c
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


def _parse_sof(seg: bytes, name: str) -> dict:
    if len(seg) < 6:
        raise ValueError(f"{name}: bad SOF segment")
    precision, height, width, nc = struct.unpack(">BHHB", seg[:6])
    if precision != 8:
        raise NotImplementedError(f"{name}: {precision}-bit JPEG samples are "
                                  "not supported (8-bit only)")
    if height == 0 or width == 0:
        raise NotImplementedError(f"{name}: a JPEG whose height comes in a "
                                  "DNL marker is not supported")
    if nc == 4:
        raise NotImplementedError(f"{name}: 4-component (CMYK or YCCK) JPEG "
                                  "images are not supported")
    if nc not in (1, 3) or len(seg) < 6 + 3 * nc:
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
    mcus_x, mcus_y = -(-width // (8 * hmax)), -(-height // (8 * vmax))
    for c in comps:
        c.width = -(-width * c.h // hmax)
        c.height = -(-height * c.v // vmax)
        c.grid_w, c.grid_h = mcus_x * c.h, mcus_y * c.v
        c.coef = array("i", bytes(4 * c.grid_w * c.grid_h * 64))
    return {"width": width, "height": height, "comps": comps,
            "hmax": hmax, "vmax": vmax, "mcus_x": mcus_x, "mcus_y": mcus_y}


def decode_jpeg_rgba(data: bytes, name: str = "image") -> np.ndarray:
    """JPEG bytes -> (H, W, 4) uint8 RGBA, what Pillow's
    ``Image.open(...).convert("RGBA")`` returns for the files the module
    docstring lists; others raise naming ``name``."""
    data = bytes(data)
    if data[:3] != b"\xff\xd8\xff":
        raise ValueError(f"{name}: not a JPEG file")
    pos = 2
    frame = None
    huff, quant = {}, {}
    restart = 0
    jfif = adobe = False
    transform = None
    scans = 0
    while True:
        # The next marker, past any fill bytes.
        while pos < len(data) and data[pos] != 0xFF:
            pos += 1
        while pos < len(data) and data[pos] == 0xFF:
            pos += 1
        if pos >= len(data):
            if scans:
                break  # no EOI after a whole scan, as libjpeg tolerates
            raise ValueError(f"{name}: truncated JPEG data (no scan)")
        marker = data[pos]
        pos += 1
        if marker == EOI:
            break
        if marker == SOI or 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue
        if pos + 2 > len(data):
            raise ValueError(f"{name}: truncated JPEG data")
        (length,) = struct.unpack(">H", data[pos:pos + 2])
        seg = data[pos + 2:pos + length]
        if length < 2 or len(seg) != length - 2:
            raise ValueError(f"{name}: truncated JPEG data")
        pos += length
        if marker in SOF_UNSUPPORTED:
            raise NotImplementedError(
                f"{name}: {SOF_UNSUPPORTED[marker]} JPEG images are not "
                "supported (baseline and extended sequential Huffman only)")
        if marker in SOF_SEQUENTIAL:
            if frame is not None:
                raise ValueError(f"{name}: two frames in one JPEG")
            frame = _parse_sof(seg, name)
        elif marker == DHT:
            _parse_dht(seg, huff, name)
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
            pos = _read_scan(data, pos, seg, frame, huff, quant, restart,
                             name)
            scans += 1
    if frame is None or not scans:
        raise ValueError(f"{name}: no image data in the JPEG")
    return _to_rgba(frame, jfif, adobe, transform, name)


def _read_scan(data, pos, seg, frame, huff, quant, restart, name) -> int:
    """One SOS: its header, then its entropy-coded data; returns the
    position of the marker after it."""
    ns = seg[0] if seg else 0
    if not 1 <= ns <= 4 or len(seg) < 4 + 2 * ns:
        raise ValueError(f"{name}: bad SOS segment")
    by_id = {c.id: c for c in frame["comps"]}
    comps, dcs, acs = [], [], []
    for k in range(ns):
        cid, tables = seg[1 + 2 * k], seg[2 + 2 * k]
        if cid not in by_id:
            raise ValueError(f"{name}: a scan names an unknown component")
        c = by_id[cid]
        key_dc, key_ac = (0, tables >> 4), (1, tables & 15)
        if key_dc not in huff or key_ac not in huff:
            raise ValueError(f"{name}: a scan uses an undefined Huffman "
                             "table")
        if c.quant is None:
            if c.tq not in quant:
                raise ValueError(f"{name}: a component uses an undefined "
                                 "quantization table")
            c.quant = quant[c.tq]  # latched, as libjpeg does
        comps.append(c)
        dcs.append(huff[key_dc])
        acs.append(huff[key_ac])
    ss, se, ahl = seg[1 + 2 * ns], seg[2 + 2 * ns], seg[3 + 2 * ns]
    if (ss, se, ahl) != (0, 63, 0):
        raise NotImplementedError(f"{name}: progressive JPEG scans are not "
                                  "supported")
    try:
        units, n_mcus = _scan_units(comps, frame)
    except ValueError as exc:
        raise ValueError(f"{name}: {exc}") from None
    segments, end = _entropy_segments(data, pos, name)
    decode_scan(segments, [(c, dc, ac, offs, stride, row)
                           for (c, offs, stride, row), dc, ac
                           in zip(units, dcs, acs)],
                restart, n_mcus, name)
    return end


def _component_plane(c) -> np.ndarray:
    """The component's samples, its block grid through ``idct_islow``,
    cropped to its downsampled size."""
    coef = np.frombuffer(c.coef, np.int32).astype(np.int16)  # JCOEF wraps
    if c.quant is None:
        raise ValueError("a component has no scan")
    blocks = idct_islow(coef.reshape(-1, 64), c.quant)
    plane = blocks.reshape(c.grid_h, c.grid_w, 8, 8).transpose(
        0, 2, 1, 3).reshape(c.grid_h * 8, c.grid_w * 8)
    return plane[:c.height, :c.width]


def _to_rgba(frame, jfif, adobe, transform, name) -> np.ndarray:
    w, h = frame["width"], frame["height"]
    comps = frame["comps"]
    try:
        planes = [upsample(_component_plane(c), frame["hmax"] // c.h,
                           frame["vmax"] // c.v)[:h, :w] for c in comps]
    except ValueError as exc:
        raise ValueError(f"{name}: {exc}") from None
    out = np.full((h, w, 4), 255, np.uint8)
    if len(comps) == 1:
        out[..., :3] = planes[0][..., None]
        return out
    # libjpeg's guess of the colour space (jdapimin.c
    # default_decompress_parms).
    if jfif:
        rgb = False
    elif adobe:
        rgb = transform == 0
    else:
        rgb = [c.id for c in comps] == [82, 71, 66]
    if rgb:
        for k in range(3):
            out[..., k] = planes[k]
        return out
    y, cb, cr = planes
    out[..., 0] = np.clip(y + _CR_R[cr], 0, 255)
    out[..., 1] = np.clip(y + ((_CB_G[cb] + _CR_G[cr]) >> 16), 0, 255)
    out[..., 2] = np.clip(y + _CB_B[cb], 0, 255)
    return out
