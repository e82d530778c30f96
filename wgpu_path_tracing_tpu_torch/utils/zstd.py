"""Zstandard frame decoding (RFC 8878) in plain Python, the bytes libzstd
1.5.7 gives: the plain version of ``accel/cbvh/zstd_scan.cpp``'s
``wpt_zstd``, which the native library runs wherever
``accel.native.native_available()``. Python 3.12 has no ``zstd`` module,
and the port imports no third-party one.

``decompress(src)`` is ``ZSTD_decompress``: every frame of ``src`` in turn
(skippable frames passed over), each checked as libzstd checks it: the
frame header (reserved bit, dictionary ID, window log), each block's
type and size, the literals section (raw, RLE, Huffman-coded in one or
four streams, or treeless on the previous block's table; Huffman weights
given directly or FSE-coded), the sequences section (predefined, RLE,
FSE and repeat modes for each of the three codes, with the RFC's default
distributions), the repeat offsets, every match against the frame's
output so far, each bitstream ending exactly where its data does, the
frame content size and the XXH64 content checksum.

``decompress(src, limit)`` is what libtiff's ``ZSTDDecode`` gets out of
``ZSTD_decompressStream`` for a strip of ``limit`` bytes: the first frame
only; a frame whose content size is known, at most ``limit`` and whose
blocks are all in ``src`` decoded in one go with every check; any other
decoded block by block (a window of more than 2^27 + 1 bytes refused, a
block larger than the frame's largest refused, an empty block passed
over, the part of a raw block the data holds passed on, output past a
known content size refused where the decoder's buffer is that size),
stopping after the first block whose output does not fit (the blocks and
checksum after it are never read) or where the data ends. The result is
cut to ``limit`` bytes; a short result is the caller's to refuse.

Huffman literals are decoded as libzstd's single-symbol decoder (X1) or
double-symbol decoder (X2) would, whichever ``HUF_selectDecoder`` picks:
the two differ only on a stream whose last code runs past its start,
which X2 accepts.
"""

from __future__ import annotations

import struct

MAGIC = 0xFD2FB528
SKIPPABLE_START, SKIPPABLE_MASK = 0x184D2A50, 0xFFFFFFF0
BLOCK_SIZE_MAX = 1 << 17
WINDOWLOG_MAX = 31
STREAM_WINDOW_MAX = (1 << 27) + 1  # ZSTD_d_windowLogMax's default
HUF_TABLELOG_MAX = 12

# Literal length, match length and offset codes: (baseline, extra bits).
LL_CODES = [(i, 0) for i in range(16)] + [
    (16, 1), (18, 1), (20, 1), (22, 1), (24, 2), (28, 2), (32, 3), (40, 3),
    (48, 4), (64, 6), (128, 7), (256, 8), (512, 9), (1024, 10), (2048, 11),
    (4096, 12), (8192, 13), (16384, 14), (32768, 15), (65536, 16)]
ML_CODES = [(i + 3, 0) for i in range(32)] + [
    (35, 1), (37, 1), (39, 1), (41, 1), (43, 2), (47, 2), (51, 3), (59, 3),
    (67, 4), (83, 4), (99, 5), (131, 7), (259, 8), (515, 9), (1027, 10),
    (2051, 11), (4099, 12), (8195, 13), (16387, 14), (32771, 15),
    (65539, 16)]
OF_CODES = [(1 << i, i) for i in range(32)]
# (default distribution, its accuracy log, largest code, largest log).
LL_DEFAULT = ([4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2,
               2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1], 6, 35, 9)
ML_DEFAULT = ([1, 4, 3, 2, 2, 2, 2, 2, 2] + [1] * 37 + [-1] * 7, 6, 52, 9)
OF_DEFAULT = ([1, 1, 1, 1, 1, 1, 2, 2, 2] + [1] * 15 + [-1] * 5, 5, 31, 8)

# HUF_selectDecoder's timings: (table, decode256) for X1 and X2 by ratio.
ALGO_TIME = ((None, None), (None, None),
             ((150, 216), (381, 119)), ((170, 205), (514, 112)),
             ((177, 199), (539, 110)), ((197, 194), (644, 107)),
             ((221, 192), (735, 107)), ((256, 189), (881, 106)),
             ((359, 188), (1167, 109)), ((582, 187), (1570, 114)),
             ((688, 187), (1712, 122)), ((825, 186), (1965, 136)),
             ((976, 185), (2131, 150)), ((1180, 186), (2070, 175)),
             ((1377, 185), (1731, 202)), ((1412, 185), (1695, 202)))

M64 = (1 << 64) - 1
P1, P2, P3 = 11400714785074694791, 14029467366897019727, 1609587929392839161
P4, P5 = 9650029242287828579, 2870177450012600261


class ZstdError(ValueError):
    """Data libzstd refuses."""


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & M64


def _round(acc: int, lane: int) -> int:
    return _rotl((acc + lane * P2) & M64, 31) * P1 & M64


def xxh64(data: bytes, seed: int = 0) -> int:
    """XXH64 of ``data`` (the content checksum keeps its low 32 bits)."""
    n, i = len(data), 0
    if n >= 32:
        v = [(seed + P1 + P2) & M64, (seed + P2) & M64, seed,
             (seed - P1) & M64]
        for i in range(0, n - 31, 32):
            lanes = struct.unpack_from("<4Q", data, i)
            v = [_round(a, b) for a, b in zip(v, lanes)]
        i = (n // 32) * 32
        h = (_rotl(v[0], 1) + _rotl(v[1], 7) + _rotl(v[2], 12)
             + _rotl(v[3], 18)) & M64
        for a in v:
            h = ((h ^ _round(0, a)) * P1 + P4) & M64
    else:
        h = (seed + P5) & M64
    h = (h + n) & M64
    while i + 8 <= n:
        (lane,) = struct.unpack_from("<Q", data, i)
        h = (_rotl(h ^ _round(0, lane), 27) * P1 + P4) & M64
        i += 8
    if i + 4 <= n:
        (lane,) = struct.unpack_from("<I", data, i)
        h = (_rotl(h ^ (lane * P1 & M64), 23) * P2 + P3) & M64
        i += 4
    while i < n:
        h = _rotl(h ^ (data[i] * P5 & M64), 11) * P1 & M64
        i += 1
    h = (h ^ (h >> 33)) * P2 & M64
    h = (h ^ (h >> 29)) * P3 & M64
    return h ^ (h >> 32)


class _Back:
    """A backward bitstream (RFC 8878 4.1.1): read from the bit under the
    last byte's highest set bit down to bit 0 of the first byte; bits past
    the start read as 0 and leave ``left`` negative."""

    def __init__(self, data: bytes):
        if not data or data[-1] == 0:
            raise ZstdError("a bitstream without its end mark")
        self.data = data
        self.left = 8 * (len(data) - 1) + data[-1].bit_length() - 1

    def peek(self, n: int) -> int:
        p = self.left - n
        if p >= 0:
            chunk = int.from_bytes(self.data[p >> 3:(p + n + 7) >> 3],
                                  "little")
            return (chunk >> (p & 7)) & ((1 << n) - 1)
        top = p + n
        if top <= 0:
            return 0
        chunk = int.from_bytes(self.data[:(top + 7) >> 3], "little")
        return (chunk & ((1 << top) - 1)) << -p

    def read(self, n: int) -> int:
        v = self.peek(n) if n else 0
        self.left -= n
        return v


def _read_ncount(src: bytes, pos: int, end: int, max_symbol: int) -> tuple:
    """FSE_readNCount on ``src[pos:end]``: (normalized counts, accuracy
    log, bytes read), libzstd's bit walk copied (a header of fewer than 8
    bytes read from a zero-padded copy)."""
    size = end - pos
    if size < 8:
        buf = src[pos:end] + bytes(8 - size)
        counts, log, used = _read_ncount(buf, 0, 8, max_symbol)
        if used > size:
            raise ZstdError("an FSE table description past its data")
        return counts, log, used
    ip, iend = pos, end
    counts = [0] * (max_symbol + 1)
    max1 = max_symbol + 1

    def word(at):
        return int.from_bytes(src[at:at + 4], "little")

    bits = word(ip)
    nb = (bits & 15) + 5
    if nb > 15:
        raise ZstdError("an FSE accuracy log too large")
    log = nb
    bits >>= 4
    count_bits = 4
    remaining = (1 << nb) + 1
    threshold = 1 << nb
    nb += 1
    charnum, previous0 = 0, False

    def advance(ip, count_bits):
        if ip <= iend - 7 or ip + (count_bits >> 3) <= iend - 4:
            return ip + (count_bits >> 3), count_bits & 7
        count_bits -= 8 * (iend - 4 - ip)
        return iend - 4, count_bits & 31

    while True:
        if previous0:
            x = (~bits & 0xFFFFFFFF) | 0x80000000
            repeats = ((x & -x).bit_length() - 1) >> 1
            while repeats >= 12:
                charnum += 36
                if ip <= iend - 7:
                    ip += 3
                else:
                    count_bits = (count_bits - 8 * (iend - 7 - ip)) & 31
                    ip = iend - 4
                bits = word(ip) >> count_bits
                x = (~bits & 0xFFFFFFFF) | 0x80000000
                repeats = ((x & -x).bit_length() - 1) >> 1
            charnum += 3 * repeats
            bits >>= 2 * repeats
            count_bits += 2 * repeats
            charnum += bits & 3
            count_bits += 2
            if charnum >= max1:
                break
            ip, count_bits = advance(ip, count_bits)
            bits = word(ip) >> count_bits
        mx = (2 * threshold - 1) - remaining
        if (bits & (threshold - 1)) < mx:
            count = bits & (threshold - 1)
            count_bits += nb - 1
        else:
            count = bits & (2 * threshold - 1)
            if count >= threshold:
                count -= mx
            count_bits += nb
        count -= 1
        remaining -= count if count >= 0 else -count
        counts[charnum] = count
        charnum += 1
        previous0 = count == 0
        if remaining < threshold:
            if remaining <= 1:
                break
            nb = remaining.bit_length()
            threshold = 1 << (nb - 1)
        if charnum >= max1:
            break
        ip, count_bits = advance(ip, count_bits)
        bits = word(ip) >> count_bits
    if remaining != 1:
        raise ZstdError("an FSE table description whose counts do not sum")
    if charnum > max1:
        raise ZstdError("an FSE table description of too many symbols")
    if count_bits > 32:
        raise ZstdError("an FSE table description past its data")
    return counts[:charnum], log, ip + ((count_bits + 7) >> 3) - pos


def _fse_table(counts: list, log: int) -> list:
    """The FSE decoding table: (symbol, bits to read, baseline) a state."""
    size = 1 << log
    high = size - 1
    table = [0] * size
    nxt = []
    for s, c in enumerate(counts):
        if c == -1:
            table[high] = s
            high -= 1
            nxt.append(1)
        else:
            nxt.append(c)
    step = (size >> 1) + (size >> 3) + 3
    pos = 0
    for s, c in enumerate(counts):
        for _ in range(max(c, 0)):
            table[pos] = s
            pos = (pos + step) & (size - 1)
            while pos > high:
                pos = (pos + step) & (size - 1)
    out = []
    for s in table:
        x = nxt[s]
        nxt[s] += 1
        nb = log - (x.bit_length() - 1)
        out.append((s, nb, (x << nb) - size))
    return out


def _huf_weights(src: bytes, pos: int, end: int) -> tuple[list, int]:
    """HUF_readStats: (each symbol's weight, the last one implied; bytes
    read)."""
    if pos >= end:
        raise ZstdError("no Huffman tree description")
    head = src[pos]
    if head >= 128:
        n = head - 127
        size = (n + 1) // 2
        if size + 1 > end - pos:
            raise ZstdError("a Huffman tree description past its data")
        weights = []
        for i in range(n):
            b = src[pos + 1 + i // 2]
            weights.append(b >> 4 if i % 2 == 0 else b & 15)
    else:
        size = head
        if size + 1 > end - pos:
            raise ZstdError("a Huffman tree description past its data")
        weights = _fse_weights(src, pos + 1, pos + 1 + size)
    rank = [0] * (HUF_TABLELOG_MAX + 2)
    total = 0
    for w in weights:
        if w > HUF_TABLELOG_MAX:
            raise ZstdError("a Huffman weight too large")
        rank[w] += 1
        total += (1 << w) >> 1
    if total == 0:
        raise ZstdError("Huffman weights that are all 0")
    log = total.bit_length()
    if log > HUF_TABLELOG_MAX:
        raise ZstdError("a Huffman table too deep")
    rest = (1 << log) - total
    last = rest.bit_length()
    if 1 << (last - 1) != rest:
        raise ZstdError("Huffman weights that leave no power of two")
    weights.append(last)
    rank[last] += 1
    if rank[1] < 2 or rank[1] & 1:
        raise ZstdError("Huffman weights with an odd count of weight 1")
    return weights, size + 1


def _fse_weights(src: bytes, pos: int, end: int) -> list:
    """FSE_decompress_wksp of Huffman weights (accuracy log at most 6, at
    most 255 weights), two states taking turns until the stream runs
    out."""
    counts, log, used = _read_ncount(src, pos, end, 255)
    if log > 6:
        raise ZstdError("an FSE accuracy log too large for Huffman weights")
    table = _fse_table(counts, log)
    bs = _Back(src[pos + used:end])
    s1 = bs.read(log)
    s2 = bs.read(log)
    out = []
    while True:
        if len(out) > 253:
            raise ZstdError("too many Huffman weights")
        sym, nb, base = table[s1]
        out.append(sym)
        s1 = base + bs.read(nb)
        if bs.left < 0:
            out.append(table[s2][0])
            break
        if len(out) > 253:
            raise ZstdError("too many Huffman weights")
        sym, nb, base = table[s2]
        out.append(sym)
        s2 = base + bs.read(nb)
        if bs.left < 0:
            out.append(table[s1][0])
            break
    return out


def _huf_table(weights: list, x2: bool) -> tuple:
    """HUF_readDTableX1: (symbol, code length) for each value of the next
    ``log`` bits; with the table log and whether libzstd built the
    double-symbol table (X2) for it."""
    log = (sum((1 << w) >> 1 for w in weights)).bit_length() - 1
    start, nxt = {}, 0
    for w in range(1, log + 1):
        start[w] = nxt
        nxt += sum(1 for x in weights if x == w) << (w - 1)
    table = [None] * (1 << log)
    for s, w in enumerate(weights):
        if w:
            n = (1 << w) >> 1
            table[start[w]:start[w] + n] = [(s, log + 1 - w)] * n
            start[w] += n
    return table, log, x2


def _select_x2(dst_size: int, src_size: int) -> bool:
    """HUF_selectDecoder: whether libzstd decodes four streams with the
    double-symbol decoder."""
    q = 15 if src_size >= dst_size else src_size * 16 // dst_size
    t1, t2 = ALGO_TIME[q]
    if t1 is None:
        return False
    d256 = dst_size >> 8
    time0 = t1[0] + t1[1] * d256
    time1 = t2[0] + t2[1] * d256
    return time1 + (time1 >> 5) < time0


def _x2_entry(table: list, log: int, target: int, v: int) -> tuple:
    """The double-symbol table's entry for the next ``target`` bits ``v``:
    (first symbol, its length, second symbol and its length or None): a
    second symbol when its whole code fits in the bits left."""
    s1, l1 = table[v >> (target - log)]
    rem = target - l1
    v2 = v & ((1 << rem) - 1)
    s2, l2 = table[v2 >> (rem - log) if rem >= log else v2 << (log - rem)]
    return s1, l1, ((s2, l2) if l2 <= rem else None)


def _huf_stream(data: bytes, count: int, huf: tuple) -> bytes:
    """``count`` symbols of one Huffman stream, which must end exactly
    where its data does. The double-symbol decoder decodes a pair where its
    entry holds one and leaves the last symbol to HUF_decodeLastSymbolX2,
    which lets a pair's bits run past the start (and, at the start, peeks
    the first 8 bytes' top bits)."""
    table, log, x2 = huf
    bs = _Back(data)
    out = bytearray()
    if not x2:
        for _ in range(count):
            sym, nb = table[bs.peek(log)]
            out.append(sym)
            bs.left -= nb
    else:
        target = max(log, 11)
        i = 0
        while i <= count - 2:
            s1, l1, second = _x2_entry(table, log, target, bs.peek(target))
            out.append(s1)
            if second is None:
                bs.left -= l1
                i += 1
            else:
                out.append(second[0])
                bs.left -= l1 + second[1]
                i += 2
        if i < count:
            v = (bs.peek(target) if bs.left else int.from_bytes(
                data[:8].ljust(8, b"\0"), "little") >> (64 - target))
            s1, l1, second = _x2_entry(table, log, target, v)
            out.append(s1)
            if second is None:
                bs.left -= l1
            elif bs.left > 0:
                bs.left = max(bs.left - l1 - second[1], 0)
    if bs.left != 0:
        raise ZstdError("a Huffman stream that does not end with its data")
    return bytes(out)


def _fast_peek(mem: bytes, r: int) -> int:
    """The 11 bits under bit ``r`` of ``mem`` (zeros below bit 0), as the
    fast decoders' registers hold them; at or below bit 0 the register
    stays on the first 8 bytes and its shift wraps (bitsConsumed & 63)."""
    if r <= 0:
        r = (r - 1) % 64 + 1
    p = r - 11
    if p >= 0:
        return (int.from_bytes(mem[p >> 3:(r + 7) >> 3], "little")
                >> (p & 7)) & 0x7FF
    return (int.from_bytes(mem[:(r + 7) >> 3], "little")
            & ((1 << r) - 1)) << -p


def _huf_fast(mem: bytes, lens: list, lit: int, huf: tuple) -> bytes:
    """libzstd's fast four-stream decoders (HUF_decompress4X1/X2_usingDTable
    _internal_fast, taken on a CPU with BMI2 when the table log is at most
    11, each stream has 8 bytes or more and the fourth has a symbol): each
    stream read backward through memory, past its start into the streams
    before it, 5 lookups a stream a round until stream 0 nears the start of
    ``mem`` (the jump table's) or the output nears its end, then each
    stream finished alone. No stream need end where its data does; a
    stream whose reads went more than 8 bytes below its start is
    refused."""
    table, log, x2 = huf
    seg = (lit + 3) // 4
    counts = [seg, seg, seg, lit - 3 * seg]
    starts = [6, 6 + lens[0], 6 + lens[0] + lens[1],
              6 + lens[0] + lens[1] + lens[2]]
    ends = [a + n for a, n in zip(starts, lens)]
    r = [8 * e - (8 - mem[e - 1].bit_length() + 1 if mem[e - 1] else 0)
         for e in ends]
    ip = [e - 8 for e in ends]
    outs = [bytearray() for _ in range(4)]

    def entry(k):
        v = _fast_peek(mem, r[k])
        if not x2:
            sym, nb = table[v >> (11 - log)]
            return (sym,), nb
        s1, l1, second = _x2_entry(table, log, 11, v)
        if second is None:
            return (s1,), l1
        return (s1, second[0]), l1 + second[1]

    while True:
        if x2:
            iters = min([ip[0] // 7] + [(counts[k] - len(outs[k])) // 10
                                        for k in range(4)])
        else:
            iters = min((counts[3] - len(outs[3])) // 5, ip[0] // 7)
        if iters == 0 or any(ip[k] < ip[k - 1] for k in (1, 2, 3)):
            break
        olimit = len(outs[3]) + 5 * iters
        while len(outs[3]) < olimit:
            for k in range(4):
                for _ in range(5):
                    syms, nb = entry(k)
                    outs[k] += bytes(syms)
                    r[k] -= nb
                ip[k] = -((64 - r[k]) // 8)  # ceil((r - 64) / 8)
    for k in range(4):
        if ip[k] < starts[k] - 8:
            raise ZstdError("a Huffman stream read past its start")
        while len(outs[k]) < counts[k]:
            syms, nb = entry(k)
            left = counts[k] - len(outs[k])
            outs[k] += bytes(syms[:left])
            r[k] -= nb
    return b"".join(outs)


class _Short(ZstdError):
    """The data ends before the frame does (a stream decoder waits)."""


class _Frame:
    """The decoding state of one frame (libzstd's DCtx between blocks)."""

    def __init__(self, window: int):
        self.block_max = min(window, BLOCK_SIZE_MAX)
        self.huf = None  # the last Huffman table (treeless literals)
        self.tables = {"ll": None, "of": None, "ml": None}
        self.rep = [1, 4, 8]
        self.out = bytearray()
        self.cap = None  # a stream decoder's buffer, where it is the size


def _literals(f: _Frame, src: bytes, pos: int, end: int) -> tuple:
    """ZSTD_decodeLiteralsBlock: (literals, bytes read)."""
    size = end - pos
    if size < 2:
        raise ZstdError("a compressed block too small")
    b0 = src[pos]
    kind, fmt = b0 & 3, (b0 >> 2) & 3
    if kind in (0, 1):
        head = (1, 2, 1, 3)[fmt]
        if size < head + (kind == 1 and head > 1):
            raise ZstdError("a literals header past its block")
        lit = int.from_bytes(src[pos:pos + head], "little") >> (
            3 if head == 1 else 4)
        if lit > f.block_max:
            raise ZstdError("too many literals")
        if kind == 0:
            if head + lit > size:
                raise ZstdError("raw literals past their block")
            return src[pos + head:pos + head + lit], head + lit
        return bytes([src[pos + head]]) * lit, head + 1
    if size < 5:
        raise ZstdError("a compressed literals header past its block")
    h = int.from_bytes(src[pos:pos + 5], "little")
    single = fmt == 0
    if fmt in (0, 1):
        head, lit, csize = 3, (h >> 4) & 0x3FF, (h >> 14) & 0x3FF
    elif fmt == 2:
        head, lit, csize = 4, (h >> 4) & 0x3FFF, (h >> 18) & 0x3FFF
    else:
        head, lit, csize = 5, (h >> 4) & 0x3FFFF, (h >> 22) & 0x3FFFF
    if lit > f.block_max:
        raise ZstdError("too many literals")
    if not single and lit < 6:
        raise ZstdError("too few literals for four streams")
    if csize + head > size:
        raise ZstdError("compressed literals past their block")
    at, stop = pos + head, pos + head + csize
    if kind == 3:
        if f.huf is None:
            raise ZstdError("treeless literals without a previous table")
        huf = f.huf
    else:
        weights, used = _huf_weights(src, at, stop)
        at += used
        if at >= stop:
            raise ZstdError("Huffman literals without their streams")
        huf = _huf_table(weights, not single and _select_x2(lit, csize))
    if single:
        lits = _huf_stream(src[at:stop], lit, huf)
    else:
        if stop - at < 10:
            raise ZstdError("four Huffman streams in fewer than 10 bytes")
        s1, s2, s3 = struct.unpack_from("<3H", src, at)
        s4 = (stop - at) - 6 - s1 - s2 - s3
        if s4 < 0:
            raise ZstdError("Huffman streams past their data")
        seg = (lit + 3) // 4
        if huf[1] <= 11 and min(s1, s2, s3, s4) >= 8 and 3 * seg < lit:
            f.huf = huf
            return _huf_fast(src[at:stop], [s1, s2, s3, s4], lit,
                             huf), head + csize
        at += 6
        parts = []
        for n, count in ((s1, seg), (s2, seg), (s3, seg),
                         (s4, lit - 3 * seg)):
            parts.append(_huf_stream(src[at:at + n], count, huf))
            at += n
        lits = b"".join(parts)
    f.huf = huf
    return lits, head + csize


def _seq_table(f: _Frame, key: str, mode: int, src: bytes, pos: int,
               end: int, default) -> int:
    """ZSTD_buildSeqTable: sets the code's table; returns bytes read."""
    counts, log, largest, max_log = default
    codes = {"ll": LL_CODES, "of": OF_CODES, "ml": ML_CODES}[key]
    if mode == 0:
        table, used = _fse_table(counts, log), 0
    elif mode == 1:
        if pos >= end:
            raise ZstdError("an RLE code past its block")
        if src[pos] > largest:
            raise ZstdError("an RLE code too large")
        table, used = [(src[pos], 0, 0)], 1
    elif mode == 3:
        if f.tables[key] is None:
            raise ZstdError("a repeated table before any table")
        return 0
    else:
        n, log2, used = _read_ncount(src, pos, end, largest)
        if log2 > max_log:
            raise ZstdError("an FSE accuracy log too large")
        table = _fse_table(n, log2)
    f.tables[key] = [(codes[s][0], codes[s][1], nb, base)
                     for s, nb, base in table]
    return used


def _sequences(f: _Frame, lits: bytes, src: bytes, pos: int,
               end: int) -> bytes:
    """ZSTD_decodeSeqHeaders and ZSTD_decompressSequences: the block's
    output (``f.out`` is the frame's output before it)."""
    if end - pos < 1:
        raise ZstdError("no sequences section")
    n = src[pos]
    pos += 1
    if n > 0x7F:
        if n == 0xFF:
            if pos + 2 > end:
                raise ZstdError("a sequence count past its block")
            n = src[pos] + (src[pos + 1] << 8) + 0x7F00
            pos += 2
        else:
            if pos >= end:
                raise ZstdError("a sequence count past its block")
            n = ((n - 0x80) << 8) + src[pos]
            pos += 1
    if n == 0:
        if pos != end:
            raise ZstdError("data after a sequences section of none")
        return bytes(lits)
    if pos + 1 > end:
        raise ZstdError("no symbol compression modes")
    modes = src[pos]
    if modes & 3:
        raise ZstdError("reserved bits set in the symbol compression modes")
    pos += 1
    for key, mode, default in (("ll", modes >> 6, LL_DEFAULT),
                               ("of", (modes >> 4) & 3, OF_DEFAULT),
                               ("ml", (modes >> 2) & 3, ML_DEFAULT)):
        pos += _seq_table(f, key, mode, src, pos, end, default)
    bs = _Back(src[pos:end])
    ll_t, of_t, ml_t = f.tables["ll"], f.tables["of"], f.tables["ml"]
    sl = bs.read(len(ll_t).bit_length() - 1)
    so = bs.read(len(of_t).bit_length() - 1)
    sm = bs.read(len(ml_t).bit_length() - 1)
    out = f.out
    start = len(out)
    rep = f.rep
    lp = 0
    try:
        for k in range(n):
            ll_base, ll_bits, ll_nb, ll_next = ll_t[sl]
            of_base, of_bits, of_nb, of_next = of_t[so]
            ml_base, ml_bits, ml_nb, ml_next = ml_t[sm]
            value = of_base + bs.read(of_bits)
            ml = ml_base + bs.read(ml_bits)
            ll = ll_base + bs.read(ll_bits)
            if of_bits > 1:
                offset = value - 3
                rep[2], rep[1], rep[0] = rep[1], rep[0], offset
            elif of_bits == 0:
                ll0 = int(ll_base == 0)
                offset = rep[ll0]
                rep[1] = rep[1 - ll0]
                rep[0] = offset
            else:
                idx = value - 1 + (ll_base == 0)  # 1, 2 or 3
                temp = rep[0] - 1 if idx == 3 else rep[idx]
                if temp == 0:
                    temp = -1  # libzstd: "0 is not valid"
                if idx != 1:
                    rep[2] = rep[1]
                rep[1] = rep[0]
                rep[0] = offset = temp
            if k != n - 1:
                sl = ll_next + bs.read(ll_nb)
                sm = ml_next + bs.read(ml_nb)
                so = of_next + bs.read(of_nb)
            if lp + ll > len(lits):
                raise ZstdError("a sequence past the literals")
            out += lits[lp:lp + ll]
            lp += ll
            if offset <= 0 or offset > len(out):
                raise ZstdError("a match before the start of the frame")
            at = len(out) - offset
            if offset >= ml:
                out += out[at:at + ml]
            else:
                out += (out[at:] * -(-ml // offset))[:ml]
        if bs.left != 0:
            raise ZstdError("a sequences stream that does not end with its "
                            "data")
        out += lits[lp:]
        return bytes(out[start:])
    finally:
        del out[start:]


def _frame_header(src: bytes, pos: int) -> tuple:
    """(header size, content size or None, window size, checksum flag)."""
    n = len(src) - pos
    if n < 5:
        raise _Short("a frame header past the data")
    fhd = src[pos + 4]
    fcs_flag, single = fhd >> 6, (fhd >> 5) & 1
    dict_size = (0, 1, 2, 4)[fhd & 3]
    fcs_size = (single, 2, 4, 8)[fcs_flag]
    size = 5 + (not single) + dict_size + fcs_size
    if n < size:
        raise _Short("a frame header past the data")
    if fhd & 8:
        raise ZstdError("the frame header's reserved bit is set")
    at = pos + 5
    window = 0
    if not single:
        wd = src[at]
        at += 1
        wlog = 10 + (wd >> 3)
        if wlog > WINDOWLOG_MAX:
            raise ZstdError("a frame window too large")
        window = (1 << wlog) + ((1 << wlog) >> 3) * (wd & 7)
    dict_id = int.from_bytes(src[at:at + dict_size], "little")
    at += dict_size
    fcs = None
    if fcs_size:
        fcs = int.from_bytes(src[at:at + fcs_size], "little")
        fcs += 256 if fcs_size == 2 else 0
    if single:
        window = fcs
    return size, fcs, window, bool(fhd & 4), dict_id


def _frame_blocks(src: bytes, pos: int, block_max: int | None = None):
    """(block type, last, block size, where its data starts) of each block
    header from ``pos``, checked as ZSTD_getcBlockSize checks it, until
    the last block. A stream decoder (``block_max`` given) also refuses a
    block larger than ``block_max``, passes on the part of a raw block that
    the data holds, then waits."""
    while True:
        if len(src) - pos < 3:
            raise _Short("a block header past the data")
        h = int.from_bytes(src[pos:pos + 3], "little")
        last, kind, size = h & 1, (h >> 1) & 3, h >> 3
        if kind == 3:
            raise ZstdError("a block of the reserved type")
        csize = 1 if kind == 1 else size
        if block_max is not None and csize > block_max:
            raise ZstdError("a block larger than the frame's largest")
        if csize > len(src) - pos - 3:
            if block_max is not None and kind == 0:
                yield kind, 0, len(src) - pos - 3, pos + 3
            raise _Short("a block past the data")
        yield kind, last, size, pos + 3
        pos += 3 + csize
        if last:
            return


def _frame_size(src: bytes, pos: int) -> int | None:
    """ZSTD_findFrameCompressedSize: the frame's bytes, or None."""
    try:
        size, _, _, check, _ = _frame_header(src, pos)
        end = pos + size
        for kind, _, bsize, at in _frame_blocks(src, pos + size):
            end = at + (1 if kind == 1 else bsize)
        end += 4 * check
    except ZstdError:
        return None
    return end - pos if end <= len(src) else None


def _decode_frame(src: bytes, pos: int, limit: int | None) -> tuple:
    """One frame from ``pos``: (its output, the position after it). With
    ``limit``, as ZSTD_decompressStream with ``limit`` bytes of room: stops
    after the first block whose output passes it, or where the data
    ends."""
    if limit is None and len(src) - pos < 9:
        raise ZstdError("a frame too small")
    size, fcs, window, check, dict_id = _frame_header(src, pos)
    if limit is None and len(src) - pos < size + 3:
        raise ZstdError("a frame too small")
    if limit is not None:
        if fcs is not None and fcs <= limit and _frame_size(src, pos):
            return _decode_frame(src, pos, None)
        if window > STREAM_WINDOW_MAX:
            raise ZstdError("a frame window larger than the stream decoder "
                            "takes")
    if dict_id:
        raise ZstdError("a frame that needs a dictionary")
    f = _Frame(window)
    # The stream decoder's buffer: a window and two blocks, or the content
    # size where that is less (then a block past it does not fit).
    if limit is not None and fcs is not None and fcs <= (
            max(window, 1024) + 2 * f.block_max + 64):
        f.cap = fcs
    try:
        return _frame_body(f, src, pos + size, limit, fcs, check)
    except _Short:
        if limit is None:
            raise
        return bytes(f.out), len(src)


def _frame_body(f: _Frame, src: bytes, pos: int, limit: int | None,
                fcs: int | None, check: bool) -> tuple:
    """The blocks and checksum of a frame from ``pos``. A stream decoder
    (``limit`` given) passes over an empty raw or compressed block, with
    no content size check after an empty last block, and refuses a block
    whose output passes the frame's largest."""
    stream = limit is not None
    for kind, last, bsize, at in _frame_blocks(
            src, pos, f.block_max if stream else None):
        empty = stream and kind != 1 and bsize == 0
        if kind == 0 or empty:
            block = src[at:at + bsize]
            pos = at + bsize
        elif kind == 1:
            block = bytes([src[at]]) * bsize
            pos = at + 1
        else:
            if bsize > f.block_max:
                raise ZstdError("a compressed block too large")
            lits, used = _literals(f, src, at, at + bsize)
            block = _sequences(f, lits, src, at + used, at + bsize)
            pos = at + bsize
        if stream and len(block) > f.block_max:
            raise ZstdError("a block larger than the frame's largest")
        if f.cap is not None and len(f.out) + len(block) > f.cap:
            raise ZstdError("a block past the stream decoder's buffer")
        room = None if limit is None else limit - len(f.out)
        f.out += block
        if last and fcs is not None and not empty and len(f.out) != fcs:
            raise ZstdError("a frame whose content size is not its header's")
        if room is not None and len(block) > room:
            return bytes(f.out), pos
    if not stream and fcs is not None and len(f.out) != fcs:
        raise ZstdError("a frame whose content size is not its header's")
    if check:
        if len(src) - pos < 4:
            raise _Short("a frame without its checksum")
        (want,) = struct.unpack_from("<I", src, pos)
        if want != xxh64(bytes(f.out)) & 0xFFFFFFFF:
            raise ZstdError("a frame whose checksum is wrong")
        pos += 4
    return bytes(f.out), pos


def zstd_plain(src: bytes, limit: int | None = None) -> bytes:
    """``decompress`` in Python (the plain version)."""
    src = bytes(src)
    if limit is not None:
        if len(src) < 4:
            return b""
        (magic,) = struct.unpack_from("<I", src)
        if magic & SKIPPABLE_MASK == SKIPPABLE_START:
            return b""
        if magic != MAGIC:
            raise ZstdError("not a Zstandard frame")
        try:
            return _decode_frame(src, 0, limit)[0][:limit]
        except _Short:
            return b""
    out, pos = [], 0
    while len(src) - pos >= 5:
        (magic,) = struct.unpack_from("<I", src, pos)
        if magic & SKIPPABLE_MASK == SKIPPABLE_START:
            if len(src) - pos < 8:
                raise ZstdError("a skippable frame past the data")
            (n,) = struct.unpack_from("<I", src, pos + 4)
            if n + 8 > len(src) - pos:
                raise ZstdError("a skippable frame past the data")
            pos += 8 + n
            continue
        if magic != MAGIC:
            raise ZstdError("not a Zstandard frame")
        frame, pos = _decode_frame(src, pos, None)
        out.append(frame)
    if pos != len(src):
        raise ZstdError("data after the last frame")
    return b"".join(out)


def decompress(src: bytes, limit: int | None = None) -> bytes:
    """Zstandard data -> its bytes, in C++ wherever the native library
    builds; raises ``ZstdError`` where libzstd refuses the data (see the
    module docstring for ``limit``)."""
    from wgpu_path_tracing_tpu_torch.accel import native

    if native.native_available():
        return native.zstd_native(src, limit)
    return zstd_plain(src, limit)
