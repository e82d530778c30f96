"""Block-compressed (BC1-BC7) texture decoding in NumPy, the pixels
Pillow's C ``bcn`` decoder gives.

Each decoder takes the blocks of one format, (n, 8) or (n, 16) uint8, and
returns their pixels, (n, 16, channels) uint8 in row order within each
4x4 block, vectorised over the blocks (BC6H and BC7 over the blocks of one
mode at a time). The arithmetic is Pillow 12.1.0's, held to it on random
blocks (``tests/test_torch_dds.py``), where it departs from the
specifications too:

* BC1: 5- and 6-bit endpoints widened by repeating their top bits; the
  4-colour palette at (2a + b) / 3 and (a + 2b) / 3, truncated; where
  ``c0 <= c1`` the 3-colour palette with (a + b) / 2 and transparent
  black; BC2 and BC3 colour blocks always take the 4-colour palette;
* BC2: 4-bit alpha as ``a * 17``; BC3/BC4/BC5: the 8- and 6-value ramps
  truncated, the 6-value one ending in 0 and 255; signed BC5 adds 128 to
  each endpoint and then ramps as unsigned; BC5's blue is 0, signed
  BC5's 128;
* BC6H: the 14 modes' endpoint packings, deltas and sign extension,
  unquantized to 16 bits, interpolated, scaled by 31/64 (31/32 signed)
  into a half float, then clamped to [0, 1] and truncated as
  ``(uint8)(f * 255.0f)``; reserved modes are black. In signed blocks
  with deltas, the endpoints the deltas make are masked to the endpoint
  width and not sign-extended again (so they read as positive);
* BC7: the 8 modes with their partitions, anchors, p-bits, rotation and
  index selection, endpoints widened by repeating their top bits and
  interpolated as ``((64 - w) a + w b + 32) >> 6``; the reserved mode (a
  first byte of 0) is (0, 0, 0, 255), where the specification says
  (0, 0, 0, 0).

``accel/cbvh/bcn_scan.cpp`` is the same decoders a block at a time in C++
(``wpt_bcn``), which the DDS reader runs wherever
``accel.native.native_available()``; these are their plain versions.
"""

from __future__ import annotations

import re

import numpy as np

# BC7 (and BC6H) two-subset partitions: bit i is pixel i's subset.
SUBSETS2 = np.array([
    0xcccc, 0x8888, 0xeeee, 0xecc8, 0xc880, 0xfeec, 0xfec8, 0xec80,
    0xc800, 0xffec, 0xfe80, 0xe800, 0xffe8, 0xff00, 0xfff0, 0xf000,
    0xf710, 0x008e, 0x7100, 0x08ce, 0x008c, 0x7310, 0x3100, 0x8cce,
    0x088c, 0x3110, 0x6666, 0x366c, 0x17e8, 0x0ff0, 0x718e, 0x399c,
    0xaaaa, 0xf0f0, 0x5a5a, 0x33cc, 0x3c3c, 0x55aa, 0x9696, 0xa55a,
    0x73ce, 0x13c8, 0x324c, 0x3bdc, 0x6996, 0xc33c, 0x9966, 0x0660,
    0x0272, 0x04e4, 0x4e40, 0x2720, 0xc936, 0x936c, 0x39c6, 0x639c,
    0x9336, 0x9cc6, 0x817e, 0xe718, 0xccf0, 0x0fcc, 0x7744, 0xee22],
    np.int64)
# Three-subset partitions: bits 2i and 2i + 1 are pixel i's subset.
SUBSETS3 = np.array([
    0xaa685050, 0x6a5a5040, 0x5a5a4200, 0x5450a0a8, 0xa5a50000, 0xa0a05050,
    0x5555a0a0, 0x5a5a5050, 0xaa550000, 0xaa555500, 0xaaaa5500, 0x90909090,
    0x94949494, 0xa4a4a4a4, 0xa9a59450, 0x2a0a4250, 0xa5945040, 0x0a425054,
    0xa5a5a500, 0x55a0a0a0, 0xa8a85454, 0x6a6a4040, 0xa4a45000, 0x1a1a0500,
    0x0050a4a4, 0xaaa59090, 0x14696914, 0x69691400, 0xa08585a0, 0xaa821414,
    0x50a4a450, 0x6a5a0200, 0xa9a58000, 0x5090a0a8, 0xa8a09050, 0x24242424,
    0x00aa5500, 0x24924924, 0x24499224, 0x50a50a50, 0x500aa550, 0xaaaa4444,
    0x66660000, 0xa5a0a5a0, 0x50a050a0, 0x69286928, 0x44aaaa44, 0x66666600,
    0xaa444444, 0x54a854a8, 0x95809580, 0x96969600, 0xa85454a8, 0x80959580,
    0xaa141414, 0x96960000, 0xaaaa1414, 0xa05050a0, 0xa0a5a5a0, 0x96000000,
    0x40804080, 0xa9a8a9a8, 0xaaaaaa44, 0x2a4a5254], np.int64)
# The anchor pixel of the second subset of each two-subset partition.
ANCHOR2 = np.array([
    15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
    15, 2, 8, 2, 2, 8, 8, 15, 2, 8, 2, 2, 8, 8, 2, 2,
    15, 15, 6, 8, 2, 8, 15, 15, 2, 8, 2, 2, 2, 15, 15, 6,
    6, 2, 6, 8, 15, 15, 2, 2, 15, 15, 15, 15, 15, 2, 2, 15], np.int64)
# The anchor pixels of the second and third subsets of each three-subset
# partition.
ANCHOR3 = np.array([
    [3, 15], [3, 8], [8, 15], [3, 15], [8, 15], [3, 15], [3, 15], [8, 15],
    [8, 15], [8, 15], [6, 15], [6, 15], [6, 15], [5, 15], [3, 15], [3, 8],
    [3, 15], [3, 8], [8, 15], [3, 15], [3, 15], [3, 8], [6, 15], [8, 10],
    [3, 5], [8, 15], [6, 8], [6, 10], [8, 15], [5, 15], [10, 15], [8, 15],
    [8, 15], [3, 15], [3, 15], [5, 10], [6, 10], [8, 10], [8, 9], [10, 15],
    [6, 15], [3, 15], [8, 15], [5, 15], [3, 15], [6, 15], [6, 15], [8, 15],
    [3, 15], [3, 15], [5, 15], [5, 15], [5, 15], [8, 15], [5, 15], [10, 15],
    [5, 15], [10, 15], [8, 15], [13, 15], [3, 15], [12, 15], [3, 15], [3, 8]],
    np.int64)
WEIGHTS = {2: np.array([0, 21, 43, 64]),
           3: np.array([0, 9, 18, 27, 37, 46, 55, 64]),
           4: np.array([0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55,
                        60, 64])}
_PIX = np.arange(16)


def subsets(ns: int, partition: np.ndarray) -> np.ndarray:
    """(n, 16) subset of each pixel under each block's partition."""
    if ns == 2:
        return (SUBSETS2[partition][:, None] >> _PIX) & 1
    if ns == 3:
        return (SUBSETS3[partition][:, None] >> (2 * _PIX)) & 3
    return np.zeros((len(partition), 16), np.int64)


def anchors(ns: int, partition: np.ndarray) -> np.ndarray:
    """(n, 16) bool: the pixels whose index has one bit fewer (pixel 0 and
    each later subset's anchor)."""
    out = np.zeros((len(partition), 16), bool)
    out[:, 0] = True
    rows = np.arange(len(partition))
    if ns == 2:
        out[rows, ANCHOR2[partition]] = True
    elif ns == 3:
        out[rows, ANCHOR3[partition, 0]] = True
        out[rows, ANCHOR3[partition, 1]] = True
    return out


def _bits(blocks: np.ndarray) -> np.ndarray:
    """(n, 16) bytes -> (n, 128) int64 bits, least significant first."""
    return np.unpackbits(blocks, axis=1, bitorder="little").astype(np.int64)


def _field(bits: np.ndarray, pos: int, count: int) -> np.ndarray:
    """Each block's ``count``-bit field at bit ``pos``."""
    return (bits[:, pos:pos + count] << np.arange(count)).sum(1)


def _indices(bits: np.ndarray, start: int, widths: np.ndarray) -> np.ndarray:
    """(n, 16) indices of ``widths`` (n, 16) bits each, packed from bit
    ``start`` in pixel order."""
    offsets = start + np.concatenate(
        [np.zeros((len(bits), 1), np.int64), np.cumsum(widths, 1)[:, :-1]], 1)
    out = np.zeros(widths.shape, np.int64)
    for j in range(int(widths.max(initial=0))):
        col = np.minimum(offsets + j, 127)
        bit = np.take_along_axis(bits, col, 1)
        out |= np.where(j < widths, bit << j, 0)
    return out


# --- BC1-BC5 -------------------------------------------------------------


def _565(c: np.ndarray) -> np.ndarray:
    r = (c & 0xF800) >> 8
    g = (c & 0x7E0) >> 3
    b = (c & 0x1F) << 3
    return np.stack([r | r >> 5, g | g >> 6, b | b >> 5], -1)


def bc1_colour(blocks: np.ndarray, separate_alpha: bool) -> np.ndarray:
    """(n, 8) BC1 colour blocks -> (n, 16, 4) RGBA."""
    b = blocks.astype(np.int64)
    c0 = b[:, 0] | b[:, 1] << 8
    c1 = b[:, 2] | b[:, 3] << 8
    lut = b[:, 4] | b[:, 5] << 8 | b[:, 6] << 16 | b[:, 7] << 24
    p0, p1 = _565(c0), _565(c1)
    four = (c0 > c1) | separate_alpha
    pal = np.zeros((len(b), 4, 4), np.int64)
    pal[:, 0, :3], pal[:, 1, :3] = p0, p1
    pal[:, :2, 3] = 255
    pal[:, 2, :3] = np.where(four[:, None], (2 * p0 + p1) // 3, (p0 + p1) // 2)
    pal[:, 2, 3] = 255
    pal[:, 3, :3] = np.where(four[:, None], (p0 + 2 * p1) // 3, 0)
    pal[:, 3, 3] = np.where(four, 255, 0)
    idx = (lut[:, None] >> (2 * _PIX)) & 3
    return np.take_along_axis(pal, idx[..., None], 1).astype(np.uint8)


def alpha_ramp(blocks: np.ndarray, signed: bool = False) -> np.ndarray:
    """(n, 8) BC3-alpha / BC4 blocks -> (n, 16) values."""
    b = blocks.astype(np.int64)
    a0, a1 = b[:, 0], b[:, 1]
    if signed:
        a0, a1 = (a0 ^ 0x80), (a1 ^ 0x80)  # int8 + 128
    lut = sum(b[:, 2 + k] << (8 * k) for k in range(6))
    eight = a0 > a1
    ramp = np.zeros((len(b), 8), np.int64)
    ramp[:, 0], ramp[:, 1] = a0, a1
    for k in range(1, 7):
        ramp[:, 1 + k] = np.where(eight, ((7 - k) * a0 + k * a1) // 7,
                                  ((5 - k) * a0 + k * a1) // 5 if k < 5
                                  else (0 if k == 5 else 255))
    idx = (lut[:, None] >> (3 * _PIX)) & 7
    return np.take_along_axis(ramp, idx, 1).astype(np.uint8)


def decode_bc1(blocks):
    return bc1_colour(blocks, False)


def decode_bc2(blocks):
    out = bc1_colour(blocks[:, 8:], True)
    nib = np.stack([blocks[:, :8] & 15, blocks[:, :8] >> 4], -1).reshape(-1, 16)
    out[..., 3] = nib * 17
    return out


def decode_bc3(blocks):
    out = bc1_colour(blocks[:, 8:], True)
    out[..., 3] = alpha_ramp(blocks[:, :8])
    return out


def decode_bc4(blocks):
    return alpha_ramp(blocks)[..., None]


def decode_bc5(blocks, signed: bool = False):
    out = np.full((len(blocks), 16, 3), 128 if signed else 0, np.uint8)
    out[..., 0] = alpha_ramp(blocks[:, :8], signed)
    out[..., 1] = alpha_ramp(blocks[:, 8:], signed)
    return out


# --- BC6H ---------------------------------------------------------------

# (subsets, transformed, partition bits, endpoint bits, delta bits r, g, b)
BC6_MODES = ((2, 1, 5, 10, 5, 5, 5), (2, 1, 5, 7, 6, 6, 6),
             (2, 1, 5, 11, 5, 4, 4), (2, 1, 5, 11, 4, 5, 4),
             (2, 1, 5, 11, 4, 4, 5), (2, 1, 5, 9, 5, 5, 5),
             (2, 1, 5, 8, 6, 5, 5), (2, 1, 5, 8, 5, 6, 5),
             (2, 1, 5, 8, 5, 5, 6), (2, 0, 5, 6, 6, 6, 6),
             (1, 0, 0, 10, 10, 10, 10), (1, 1, 0, 11, 9, 9, 9),
             (1, 1, 0, 12, 8, 8, 8), (1, 1, 0, 16, 4, 4, 4))
# Each mode's endpoint bits in stream order (the BC6H specification's
# table): a field [hi:lo] is stored lo first, a reversed one [lo:hi] hi
# first.
BC6_LAYOUTS = (
    "g2[4] b2[4] b3[4] r0[9:0] g0[9:0] b0[9:0] r1[4:0] g3[4] g2[3:0] g1[4:0] "
    "b3[0] g3[3:0] b1[4:0] b3[1] b2[3:0] r2[4:0] b3[2] r3[4:0] b3[3]",
    "g2[5] g3[4] g3[5] r0[6:0] b3[0] b3[1] b2[4] g0[6:0] b2[5] b3[2] g2[4] "
    "b0[6:0] b3[3] b3[5] b3[4] r1[5:0] g2[3:0] g1[5:0] g3[3:0] b1[5:0] "
    "b2[3:0] r2[5:0] r3[5:0]",
    "r0[9:0] g0[9:0] b0[9:0] r1[4:0] r0[10] g2[3:0] g1[3:0] g0[10] b3[0] "
    "g3[3:0] b1[3:0] b0[10] b3[1] b2[3:0] r2[4:0] b3[2] r3[4:0] b3[3]",
    "r0[9:0] g0[9:0] b0[9:0] r1[3:0] r0[10] g3[4] g2[3:0] g1[4:0] g0[10] "
    "g3[3:0] b1[3:0] b0[10] b3[1] b2[3:0] r2[3:0] b3[0] b3[2] r3[3:0] g2[4] "
    "b3[3]",
    "r0[9:0] g0[9:0] b0[9:0] r1[3:0] r0[10] b2[4] g2[3:0] g1[3:0] g0[10] "
    "b3[0] g3[3:0] b1[4:0] b0[10] b2[3:0] r2[3:0] b3[1] b3[2] r3[3:0] b3[4] "
    "b3[3]",
    "r0[8:0] b2[4] g0[8:0] g2[4] b0[8:0] b3[4] r1[4:0] g3[4] g2[3:0] g1[4:0] "
    "b3[0] g3[3:0] b1[4:0] b3[1] b2[3:0] r2[4:0] b3[2] r3[4:0] b3[3]",
    "r0[7:0] g3[4] b2[4] g0[7:0] b3[2] g2[4] b0[7:0] b3[3] b3[4] r1[5:0] "
    "g2[3:0] g1[4:0] b3[0] g3[3:0] b1[4:0] b3[1] b2[3:0] r2[5:0] r3[5:0]",
    "r0[7:0] b3[0] b2[4] g0[7:0] g2[5] g2[4] b0[7:0] g3[5] b3[4] r1[4:0] "
    "g3[4] g2[3:0] g1[5:0] g3[3:0] b1[4:0] b3[1] b2[3:0] r2[4:0] b3[2] "
    "r3[4:0] b3[3]",
    "r0[7:0] b3[1] b2[4] g0[7:0] b2[5] g2[4] b0[7:0] b3[5] b3[4] r1[4:0] "
    "g3[4] g2[3:0] g1[4:0] b3[0] g3[3:0] b1[5:0] b2[3:0] r2[4:0] b3[2] "
    "r3[4:0] b3[3]",
    "r0[5:0] g3[4] b3[0] b3[1] b2[4] g0[5:0] g2[5] b2[5] b3[2] g2[4] b0[5:0] "
    "g3[5] b3[3] b3[5] b3[4] r1[5:0] g2[3:0] g1[5:0] g3[3:0] b1[5:0] "
    "b2[3:0] r2[5:0] r3[5:0]",
    "r0[9:0] g0[9:0] b0[9:0] r1[9:0] g1[9:0] b1[9:0]",
    "r0[9:0] g0[9:0] b0[9:0] r1[8:0] r0[10] g1[8:0] g0[10] b1[8:0] b0[10]",
    "r0[9:0] g0[9:0] b0[9:0] r1[7:0] r0[10:11] g1[7:0] g0[10:11] b1[7:0] "
    "b0[10:11]",
    "r0[9:0] g0[9:0] b0[9:0] r1[3:0] r0[10:15] g1[3:0] g0[10:15] b1[3:0] "
    "b0[10:15]")


def _packing(layout: str) -> np.ndarray:
    """A layout -> (bits, 2) int64 rows of (endpoint 0-11, bit)."""
    rows = []
    for ch, e, hi, lo in re.findall(r"([rgb])(\d)\[(\d+)(?::(\d+))?\]",
                                    layout):
        hi = int(hi)
        lo = hi if lo == "" else int(lo)
        end = 3 * int(e) + "rgb".index(ch)
        step = 1 if hi >= lo else -1
        rows += [(end, b) for b in range(lo, hi + step, step)]
    return np.array(rows, np.int64)


BC6_PACKINGS = tuple(_packing(s) for s in BC6_LAYOUTS)


def bc6_mode(first: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(n,) first bytes -> (mode 0-13, or -1 for a reserved one; the bit
    after the mode)."""
    m = first.astype(np.int64) & 0x1F
    low = m & 3
    mode = np.where(low < 2, low, np.where(low == 2, 2 + (m >> 2),
                                           10 + (m >> 2)))
    return np.where(mode >= 14, -1, mode), np.where(low < 2, 2, 5)


def _extend(v: np.ndarray, prec: int) -> np.ndarray:
    """Pillow's ``bc6_sign_extend``: the value as a 16-bit unsigned one."""
    neg = (v >> (prec - 1)) & 1
    return np.where(neg == 1, v | (-1 << prec), v) & 0xFFFF


def _unquantize(v: np.ndarray, prec: int, signed: bool) -> np.ndarray:
    if not signed:
        if prec >= 15:
            return v
        return np.where(v == 0, 0, np.where(
            v == (1 << prec) - 1, 0xFFFF, ((v << 15) + 0x4000) >> (prec - 1)))
    x = np.where(v >= 0x8000, v - 0x10000, v)
    if prec >= 16:
        return x
    mag = np.abs(x)
    q = np.where(mag >= (1 << (prec - 1)) - 1, 0x7FFF,
                 ((mag << 15) + 0x4000) >> (prec - 1))
    q = np.where(mag == 0, 0, q)
    return np.where(x < 0, -q, q)


def _half_to_u8(v: np.ndarray, signed: bool) -> np.ndarray:
    """An interpolated value -> Pillow's ``bc6_clamp(bc6_finalize(v))``."""
    if signed:
        half = np.where(v < 0, 0x8000 | ((-v) * 31 // 32), v * 31 // 32)
    else:
        half = v * 31 // 64
    f = half.astype(np.uint16).view(np.float16).astype(np.float32)
    scaled = np.clip(f, 0, 1) * np.float32(255.0)
    return np.where(f > 1, 255, np.where(f < 0, 0, scaled.astype(np.int64)))


def decode_bc6(blocks: np.ndarray, signed: bool = False) -> np.ndarray:
    """(n, 16) BC6H blocks -> (n, 16, 3) RGB."""
    out = np.zeros((len(blocks), 16, 3), np.uint8)
    modes, starts = bc6_mode(blocks[:, 0])
    bits = _bits(blocks)
    for mode in range(14):
        sel = np.flatnonzero(modes == mode)
        if len(sel) == 0:
            continue
        ns, tr, pb, epb, rb, gb, bb = BC6_MODES[mode]
        b = bits[sel]
        start = int(starts[sel[0]])
        pack = BC6_PACKINGS[mode]
        e = np.zeros((len(sel), 12), np.int64)
        for k, (end, bit) in enumerate(pack):
            e[:, end] |= b[:, start + k] << bit
        pos = start + len(pack)
        partition = _field(b, pos, pb)
        pos += pb
        numep = 12 if ns == 2 else 6
        if signed:
            e[:, :3] = _extend(e[:, :3], epb)
        if signed or tr:
            for i in range(3, numep, 3):
                for c, prec in enumerate((rb, gb, bb)):
                    e[:, i + c] = _extend(e[:, i + c], prec)
        if tr:
            mask = (1 << epb) - 1
            for i in range(3, numep, 3):
                e[:, i:i + 3] = (e[:, i:i + 3] + e[:, :3]) & mask
        u = _unquantize(e[:, :numep], epb, signed)
        ib = 3 if ns == 2 else 4
        widths = ib - anchors(ns, partition)
        idx = _indices(b, pos, widths)
        w = WEIGHTS[ib][idx]
        s = 6 * subsets(ns, partition)
        e0 = np.take_along_axis(u, (s[..., None] + np.arange(3)).reshape(
            len(sel), -1), 1).reshape(len(sel), 16, 3)
        e1 = np.take_along_axis(u, (s[..., None] + 3 + np.arange(3)).reshape(
            len(sel), -1), 1).reshape(len(sel), 16, 3)
        v = (e0 * (64 - w[..., None]) + e1 * w[..., None]) >> 6
        out[sel] = _half_to_u8(v, signed)
    return out


# --- BC7 ----------------------------------------------------------------

# (subsets, partition bits, rotation bits, index-selection bits, colour
# bits, alpha bits, p-bit an endpoint, p-bit a subset, index bits, second
# index bits)
BC7_MODES = ((3, 4, 0, 0, 4, 0, 1, 0, 3, 0), (2, 6, 0, 0, 6, 0, 0, 1, 3, 0),
             (3, 6, 0, 0, 5, 0, 0, 0, 2, 0), (2, 6, 0, 0, 7, 0, 1, 0, 2, 0),
             (1, 0, 2, 1, 5, 6, 0, 0, 2, 3), (1, 0, 2, 0, 7, 8, 0, 0, 2, 2),
             (1, 0, 0, 0, 7, 7, 1, 0, 4, 0), (2, 6, 0, 0, 5, 5, 1, 0, 2, 0))


def bc7_mode(first: np.ndarray) -> np.ndarray:
    """(n,) first bytes -> the mode (the lowest set bit), -1 for 0."""
    f = first.astype(np.int64)
    low = f & -f
    return np.where(f == 0, -1, np.log2(np.maximum(low, 1)).astype(np.int64))


def _expand(v: np.ndarray, bits: int) -> np.ndarray:
    v = (v << (8 - bits)) & 0xFF
    return v | (v >> bits)


def decode_bc7(blocks: np.ndarray) -> np.ndarray:
    """(n, 16) BC7 blocks -> (n, 16, 4) RGBA."""
    out = np.zeros((len(blocks), 16, 4), np.uint8)
    out[..., 3] = 255  # the reserved mode
    modes = bc7_mode(blocks[:, 0])
    bits = _bits(blocks)
    for mode in range(8):
        sel = np.flatnonzero(modes == mode)
        if len(sel) == 0:
            continue
        ns, pb, rb, isb, cb, ab, epb, spb, ib, ib2 = BC7_MODES[mode]
        b = bits[sel]
        n = len(sel)
        pos = mode + 1
        partition = _field(b, pos, pb)
        pos += pb
        rotation = _field(b, pos, rb)
        pos += rb
        index_sel = _field(b, pos, isb)
        pos += isb
        numep = 2 * ns
        e = np.zeros((n, numep, 4), np.int64)
        for c in range(3):
            for i in range(numep):
                e[:, i, c] = _field(b, pos, cb)
                pos += cb
        for i in range(numep):
            if ab:
                e[:, i, 3] = _field(b, pos, ab)
                pos += ab
            else:
                e[:, i, 3] = 255
        chans = 4 if ab else 3
        if epb:
            cb, ab = cb + 1, ab + 1 if ab else 0
            for i in range(numep):
                e[:, i, :chans] = e[:, i, :chans] << 1 | b[:, pos, None]
                pos += 1
        if spb:
            cb, ab = cb + 1, ab + 1 if ab else 0
            for i in range(0, numep, 2):
                e[:, i:i + 2, :chans] = (e[:, i:i + 2, :chans] << 1
                                         | b[:, pos, None, None])
                pos += 1
        e[..., :3] = _expand(e[..., :3], cb)
        if ab:
            e[..., 3] = _expand(e[..., 3], ab)
        widths = ib - anchors(ns, partition)
        ci = _indices(b, pos, widths)
        cw = WEIGHTS[ib][ci]
        if ab and ib2:
            widths2 = np.full((n, 16), ib2)
            widths2[:, 0] -= 1
            ai = _indices(b, pos + 16 * ib - ns, widths2)
            aw = WEIGHTS[ib2][ai]
            swap = index_sel[:, None] == 1
            wc, wa = np.where(swap, aw, cw), np.where(swap, cw, aw)
        else:
            wc = wa = cw
        s = 2 * subsets(ns, partition)
        rows = np.arange(n)[:, None]
        e0, e1 = e[rows, s], e[rows, s + 1]
        px = np.empty((n, 16, 4), np.int64)
        px[..., :3] = ((64 - wc[..., None]) * e0[..., :3]
                       + wc[..., None] * e1[..., :3] + 32) >> 6
        px[..., 3] = ((64 - wa) * e0[..., 3] + wa * e1[..., 3] + 32) >> 6
        for r in (1, 2, 3):
            hit = rotation == r
            if hit.any():
                sub = px[hit]
                sub[..., [r - 1, 3]] = sub[..., [3, r - 1]]
                px[hit] = sub
        out[sel] = px
    return out


DECODERS = {"BC1": (8, decode_bc1), "BC2": (16, decode_bc2),
            "BC3": (16, decode_bc3), "BC4": (8, decode_bc4),
            "BC5": (16, decode_bc5),
            "BC5S": (16, lambda b: decode_bc5(b, True)),
            "BC6H": (16, decode_bc6),
            "BC6HS": (16, lambda b: decode_bc6(b, True)),
            "BC7": (16, decode_bc7)}


def decode_plain(data: bytes, pos: int, fmt: str, w: int, h: int
                 ) -> np.ndarray:
    """The blocks of a ``w`` x ``h`` image of ``fmt`` from ``pos`` ->
    (h, w, channels) uint8, the blocks in row order, each clipped to the
    image (the caller has checked that the data holds them)."""
    size, decode = DECODERS[fmt]
    bw, bh = (w + 3) // 4, (h + 3) // 4
    blocks = np.frombuffer(data, np.uint8, count=bw * bh * size,
                           offset=pos).reshape(-1, size)
    chunk = 1 << 16
    px = np.concatenate([decode(blocks[i:i + chunk])
                         for i in range(0, len(blocks), chunk)])
    c = px.shape[-1]
    img = px.reshape(bh, bw, 4, 4, c).transpose(0, 2, 1, 3, 4).reshape(
        4 * bh, 4 * bw, c)
    return img[:h, :w]
