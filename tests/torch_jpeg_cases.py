"""A small JPEG writer for the decoder's tests: the files Pillow cannot
write (4:4:0, 4:1:1 and mixed sampling factors, one scan per component,
16-bit quantization tables, an Adobe RGB marker or only component ids,
restart intervals on any MCU count, 4 components under any Adobe transform
or none, progressive scan scripts of any shape), arithmetic-coded
sequential and progressive files (SOF9, SOF10) with restart intervals and
any DAC conditioning, lossless files (SOF3) with every predictor and point
transform, and arithmetic-coded lossless ones (SOF11). Each file is decoded by
Pillow and by ``utils/jpeg.py``; only the decoders are compared, so this
writer's own arithmetic (a float DCT, box downsampling) need not match any
encoder's.

A sequential file uses the standard Huffman tables (ISO 10918-1 Annex
K.3), read from the DHT segments of a file Pillow writes without
``optimize``. A progressive file (``scans=``) is coded as libjpeg's
``jcphuff.c`` codes it, end-of-band runs and buffered correction bits
included, with tables made for each scan from its symbol counts
(``jchuff.c::jpeg_gen_optimal_table``), since the standard AC tables have
no EOBn symbols.
"""

from __future__ import annotations

import io
import os
import struct

import numpy as np
from PIL import Image, ImageFile


def _markers(data: bytes):
    """(marker, segment) of each marker segment before the first scan."""
    pos = 2
    while pos < len(data):
        marker = data[pos + 1]
        (length,) = struct.unpack(">H", data[pos + 2:pos + 4])
        yield marker, data[pos + 4:pos + 2 + length]
        if marker == 0xDA:
            return
        pos += 2 + length


def standard_tables() -> dict:
    """{(class, id): (counts, symbols)} of Pillow's default file."""
    buf = io.BytesIO()
    Image.new("RGB", (16, 16), (1, 2, 3)).save(buf, "JPEG")
    out = {}
    for marker, seg in _markers(buf.getvalue()):
        i = 0
        while marker == 0xC4 and i < len(seg):
            counts = list(seg[i + 1:i + 17])
            n = sum(counts)
            out[(seg[i] >> 4, seg[i] & 15)] = (counts,
                                               list(seg[i + 17:i + 17 + n]))
            i += 17 + n
    return out


def _codes(counts, symbols) -> dict:
    table, code, k = {}, 0, 0
    for length, n in enumerate(counts, start=1):
        for _ in range(n):
            table[symbols[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return table


class _Bits:
    def __init__(self):
        self.out = bytearray()
        self.acc = self.n = 0

    def put(self, value: int, length: int) -> None:
        for i in range(length - 1, -1, -1):
            self.acc = self.acc << 1 | (value >> i) & 1
            self.n += 1
            if self.n == 8:
                self.out.append(self.acc)
                if self.acc == 0xFF:
                    self.out.append(0)
                self.acc = self.n = 0

    def flush(self) -> bytes:
        if self.n:  # pad with 1 bits
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)
        out, self.out = bytes(self.out), bytearray()
        return out


_ZZ = np.zeros(64, np.int64)  # natural index of each zigzag index
_k = 0
for _s in range(15):
    _cells = [(i, _s - i) for i in range(8) if 0 <= _s - i < 8]
    for _i, _j in (_cells if _s % 2 else _cells[::-1]):
        _ZZ[_k] = _i * 8 + _j
        _k += 1

_DCT = np.array([[np.sqrt((1 if u == 0 else 2) / 8)
                  * np.cos((2 * x + 1) * u * np.pi / 16)
                  for x in range(8)] for u in range(8)])


def _quant(quality: int, chroma: bool) -> np.ndarray:
    """A natural-order quantization table scaled as libjpeg scales the
    Annex K tables' flat approximation (a ramp here: any table will do)."""
    base = (16 + 6 * np.add.outer(np.arange(8), np.arange(8))).reshape(-1)
    if chroma:
        base = base + 8
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((base * scale + 50) // 100, 1, 255).astype(np.int64)


def _category(v: int) -> int:
    return int(abs(v)).bit_length()


def write_jpeg(planes, sampling, *, quality: int = 75, ids=None,
               restart: int = 0, interleaved: bool = True,
               quant16: bool = False, app: str = "jfif",
               adobe_transform: int = 1, scans=None,
               arithmetic: bool = False, dac=None) -> bytes:
    """A JPEG of the full-size uint8 ``planes`` (1, 3 or 4, each (H, W))
    with ``sampling`` [(h, v)] a component; ``ids`` the component ids (1,
    2, 3... by default); ``restart`` MCUs a restart interval;
    ``interleaved`` False writes one scan a component; ``quant16`` writes
    16-bit quantization tables; ``app`` "jfif", "adobe" (with
    ``adobe_transform``) or "none". ``scans``, a progressive script
    [(component indices, Ss, Se, Ah, Al)], writes a progressive frame
    (SOF2) of those scans instead of a sequential one; ``arithmetic``
    codes the file with ``jcarith.c``'s QM coder instead of Huffman tables
    (SOF9, or SOF10 with ``scans``), at the conditioning ``dac`` gives
    ({(0, table): U << 4 | L, (1, table): Kx}, written as a DAC segment;
    L = 0, U = 1, Kx = 5 elsewhere)."""
    planes = [np.asarray(p, np.float64) for p in planes]
    nc = len(planes)
    h, w = planes[0].shape
    ids = ids or list(range(1, nc + 1))
    hmax = max(s[0] for s in sampling)
    vmax = max(s[1] for s in sampling)
    mx, my = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    tables = standard_tables()
    codes = {key: _codes(*val) for key, val in tables.items()}
    quants = [_quant(quality, False), _quant(quality, True)]

    # Each component's block grid of quantized zigzag coefficients.
    grids = []
    for c, (hs, vs) in enumerate(sampling):
        cw, ch = -(-w * hs // hmax), -(-h * vs // vmax)
        fy, fx = vmax // vs, hmax // hs
        pad = np.pad(planes[c], ((0, ch * fy - h), (0, cw * fx - w)),
                     mode="edge")
        small = pad.reshape(ch, fy, cw, fx).mean(axis=(1, 3))
        gw, gh = mx * hs, my * vs
        small = np.pad(small, ((0, gh * 8 - ch), (0, gw * 8 - cw)),
                       mode="edge") - 128.0
        blocks = small.reshape(gh, 8, gw, 8).transpose(0, 2, 1, 3)
        coef = np.einsum("ux,abxy,vy->abuv", _DCT, blocks, _DCT)
        q = quants[min(c, 1)].reshape(8, 8)
        grids.append((np.round(coef / q).astype(np.int64).reshape(
            gh, gw, 64)[..., _ZZ], cw, ch))

    out = bytearray(b"\xff\xd8")

    def segment(marker: int, body: bytes) -> None:
        out.extend(struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body)

    if app == "jfif":
        segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    elif app == "adobe":
        segment(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00"
                + bytes([adobe_transform]))
    for t, q in enumerate(quants[:min(nc, 2)]):
        qz = q[_ZZ]
        segment(0xDB, bytes([0x10 | t]) + qz.astype(">u2").tobytes()
                if quant16 else bytes([t]) + qz.astype(np.uint8).tobytes())
    sof = struct.pack(">BHHB", 8, h, w, nc) + b"".join(
        bytes([ids[c], sampling[c][0] << 4 | sampling[c][1], min(c, 1)])
        for c in range(nc))
    if arithmetic:
        segment(0xCA if scans is not None else 0xC9, sof)
        if dac:
            segment(0xCC, b"".join(bytes([tc << 4 | tb, v])
                                   for (tc, tb), v in sorted(dac.items())))
        if restart:
            segment(0xDD, struct.pack(">H", restart))
        if scans is None:
            scans = [(tuple(range(nc)), 0, 63, 0, 0)] if interleaved else [
                ((c,), 0, 63, 0, 0) for c in range(nc)]
            progressive = False
        else:
            progressive = True
        for comps, ss, se, ah, al in scans:
            segment(0xDA, bytes([len(comps)]) + b"".join(
                bytes([ids[c], min(c, 1) << 4 | min(c, 1)]) for c in comps)
                + bytes([ss, se, ah << 4 | al]))
            out.extend(_arith_scan((comps, ss, se, ah, al), progressive,
                                   grids, sampling, restart, mx, my,
                                   dac or {}))
        out.extend(b"\xff\xd9")
        return bytes(out)
    if scans is not None:
        segment(0xC2, sof)
        if restart:
            segment(0xDD, struct.pack(">H", restart))
        for scan in scans:
            _progressive_scan(out, segment, scan, grids, sampling, ids,
                              restart, mx, my)
        out.extend(b"\xff\xd9")
        return bytes(out)
    segment(0xC1 if quant16 else 0xC0, sof)
    for (tc, th), (counts, symbols) in tables.items():
        segment(0xC4, bytes([tc << 4 | th]) + bytes(counts) + bytes(symbols))
    if restart:
        segment(0xDD, struct.pack(">H", restart))

    def encode_block(bits, zz, pred, t):
        dc_codes, ac_codes = codes[(0, t)], codes[(1, t)]
        diff = int(zz[0]) - pred
        s = _category(diff)
        bits.put(*dc_codes[s])
        if s:
            bits.put(diff if diff > 0 else diff + (1 << s) - 1, s)
        run = 0
        for k in range(1, 64):
            v = int(zz[k])
            if v == 0:
                run += 1
                continue
            while run > 15:
                bits.put(*ac_codes[0xF0])
                run -= 16
            s = _category(v)
            bits.put(*ac_codes[run << 4 | s])
            bits.put(v if v > 0 else v + (1 << s) - 1, s)
            run = 0
        if run:
            bits.put(*ac_codes[0x00])
        return int(zz[0])

    scans = [list(range(nc))] if interleaved else [[c] for c in range(nc)]
    for comps in scans:
        segment(0xDA, bytes([len(comps)]) + b"".join(
            bytes([ids[c], min(c, 1) << 4 | min(c, 1)]) for c in comps)
            + b"\x00\x3f\x00")
        mcus = _mcus(comps, grids, sampling, mx, my)
        bits, preds = _Bits(), {}
        for m, mcu in enumerate(mcus):
            if restart and m and m % restart == 0:
                out.extend(bits.flush())
                out.extend(bytes([0xFF, 0xD0 + (m // restart - 1) % 8]))
                preds = {}
            for c, cells in mcu:
                for by, bx in cells:
                    preds[c] = encode_block(bits, grids[c][0][by, bx],
                                            preds.get(c, 0), min(c, 1))
        out.extend(bits.flush())
    out.extend(b"\xff\xd9")
    return bytes(out)


def _mcus(comps, grids, sampling, mx, my, block: int = 8) -> list:
    """The MCUs of a scan over ``comps``: for each, [(component, [(row,
    column) of each of its data units])]. A scan of one component walks
    its own extent unit by unit (``block`` samples a unit: 8 for DCT
    blocks, 1 for lossless samples), an interleaved one the frame's MCU
    grid."""
    if len(comps) == 1:
        _, cw, ch = grids[comps[0]]
        return [[(comps[0], [(by, bx)])] for by in range(-(-ch // block))
                for bx in range(-(-cw // block))]
    return [[(c, [(y * sampling[c][1] + v, x * sampling[c][0] + u)
                  for v in range(sampling[c][1])
                  for u in range(sampling[c][0])]) for c in comps]
            for y in range(my) for x in range(mx)]


def optimal_table(freq) -> tuple:
    """``jchuff.c::jpeg_gen_optimal_table``: (counts, symbols) of a Huffman
    table for symbol counts ``freq`` (256), codes at most 16 bits, no code
    all ones."""
    freq = list(freq) + [1]  # the reserved symbol 256
    codesize, others = [0] * 257, [-1] * 257
    while True:
        c1 = c2 = -1
        v = 1 << 62
        for i in range(257):
            if freq[i] and freq[i] <= v:
                v, c1 = freq[i], i
        v = 1 << 62
        for i in range(257):
            if freq[i] and freq[i] <= v and i != c1:
                v, c2 = freq[i], i
        if c2 < 0:
            break
        freq[c1] += freq[c2]
        freq[c2] = 0
        codesize[c1] += 1
        while others[c1] >= 0:
            c1 = others[c1]
            codesize[c1] += 1
        others[c1] = c2
        codesize[c2] += 1
        while others[c2] >= 0:
            c2 = others[c2]
            codesize[c2] += 1
    bits = [0] * 33
    for size in codesize:
        if size:
            bits[size] += 1
    for i in range(32, 16, -1):
        while bits[i] > 0:
            j = i - 2
            while bits[j] == 0:
                j -= 1
            bits[i] -= 2
            bits[i - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1
    i = 16
    while bits[i] == 0:
        i -= 1
    bits[i] -= 1
    symbols = [j for size in range(1, 33) for j in range(256)
               if codesize[j] == size]
    return bits[1:17], symbols


MAX_CORR_BITS = 1000  # jcphuff.c: the correction-bit buffer


def _progressive_scan(out, segment, scan, grids, sampling, ids, restart, mx,
                      my) -> None:
    """One progressive scan, coded as ``jcphuff.c`` codes it: its DHT
    segment (tables from its own symbol counts), its SOS, its data."""
    comps, ss, se, ah, al = scan
    table_of = {c: min(c, 1) for c in comps}
    mcus = _mcus(comps, grids, sampling, mx, my)
    events = []  # ("s", table key, symbol), ("b", value, bits), ("r", n)
    state = {"eobrun": 0, "be": [], "preds": {}}
    key_ac = (1, table_of[comps[0]])

    def emit_eobrun():
        run = state["eobrun"]
        if run:
            nbits = run.bit_length() - 1
            events.append(("s", key_ac, nbits << 4))
            if nbits:
                events.append(("b", run & ((1 << nbits) - 1), nbits))
            state["eobrun"] = 0
            events.extend(("b", bit, 1) for bit in state["be"])
            state["be"] = []

    def dc_first(c, zz):
        t = int(zz[0]) >> al
        diff = t - state["preds"].get(c, 0)
        state["preds"][c] = t
        s = _category(diff)
        events.append(("s", (0, table_of[c]), s))
        if s:
            events.append(("b", diff if diff > 0 else diff + (1 << s) - 1,
                           s))

    def ac_first(zz):
        r = 0
        for k in range(ss, se + 1):
            v = int(zz[k])
            t = abs(v) >> al
            if t == 0:
                r += 1
                continue
            emit_eobrun()
            while r > 15:
                events.append(("s", key_ac, 0xF0))
                r -= 16
            nbits = t.bit_length()
            events.append(("s", key_ac, (r << 4) + nbits))
            events.append(("b", (t if v > 0 else ~t) & ((1 << nbits) - 1),
                           nbits))
            r = 0
        if r:
            state["eobrun"] += 1
            if state["eobrun"] == 0x7FFF:
                emit_eobrun()

    def ac_refine(zz):
        absval = {k: abs(int(zz[k])) >> al for k in range(ss, se + 1)}
        eob = max([k for k, t in absval.items() if t == 1], default=0)
        r, br = 0, []
        for k in range(ss, se + 1):
            t = absval[k]
            if t == 0:
                r += 1
                continue
            while r > 15 and k <= eob:
                emit_eobrun()
                events.append(("s", key_ac, 0xF0))
                r -= 16
                events.extend(("b", bit, 1) for bit in br)
                br = []
            if t > 1:
                br.append(t & 1)
                continue
            emit_eobrun()
            events.append(("s", key_ac, (r << 4) + 1))
            events.append(("b", 1 if zz[k] > 0 else 0, 1))
            events.extend(("b", bit, 1) for bit in br)
            br, r = [], 0
        if r or br:
            state["eobrun"] += 1
            state["be"] += br
            if (state["eobrun"] == 0x7FFF
                    or len(state["be"]) > MAX_CORR_BITS - 64 + 1):
                emit_eobrun()

    for m, mcu in enumerate(mcus):
        if restart and m and m % restart == 0:
            emit_eobrun()
            events.append(("r", (m // restart - 1) % 8, 0))
            state["preds"] = {}
        for c, cells in mcu:
            for by, bx in cells:
                zz = grids[c][0][by, bx]
                if ss == 0 and ah == 0:
                    dc_first(c, zz)
                elif ss == 0:
                    events.append(("b", (int(zz[0]) >> al) & 1, 1))
                elif ah == 0:
                    ac_first(zz)
                else:
                    ac_refine(zz)
    emit_eobrun()
    freqs = {}
    for kind, key, sym in events:
        if kind == "s":
            freqs.setdefault(key, [0] * 256)[sym] += 1
    tables = {key: optimal_table(f) for key, f in sorted(freqs.items())}
    if tables:
        segment(0xC4, b"".join(bytes([tc << 4 | th]) + bytes(counts)
                               + bytes(symbols)
                               for (tc, th), (counts, symbols)
                               in tables.items()))
    codes = {key: _codes(*val) for key, val in tables.items()}
    segment(0xDA, bytes([len(comps)]) + b"".join(
        bytes([ids[c], table_of[c] << 4 | table_of[c]]) for c in comps)
        + bytes([ss, se, ah << 4 | al]))
    bits = _Bits()
    for kind, a, b in events:
        if kind == "s":
            bits.put(*codes[a][b])
        elif kind == "b":
            bits.put(a, b)
        else:
            out.extend(bits.flush())
            out.extend(bytes([0xFF, 0xD0 + a]))
    out.extend(bits.flush())


def lossless_predict(x, psv: int, pt: int, first_rows) -> np.ndarray:
    """ISO 10918-1 Annex H's prediction of each sample of the (H, W) int
    plane ``x`` (already shifted right by the point transform ``pt``) under
    predictor ``psv``: rows flagged in ``first_rows`` use the sample to the
    left (2^(7 - pt) for their first), the first column the sample above,
    the rest Ra, Rb, Rc as ``psv`` combines them."""
    x = np.asarray(x, np.int64)
    h, w = x.shape
    pred = np.zeros_like(x)
    for r in range(h):
        if first_rows[r]:
            pred[r, 0] = 1 << (7 - pt)
            pred[r, 1:] = x[r, :-1]
            continue
        ra, rb, rc = x[r, :-1], x[r - 1, 1:], x[r - 1, :-1]
        pred[r, 0] = x[r - 1, 0]
        pred[r, 1:] = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc,
                       5: ra + ((rb - rc) >> 1), 6: rb + ((ra - rc) >> 1),
                       7: (ra + rb) >> 1}[psv]
    return pred


def _diff_bits(d: int) -> tuple:
    """A lossless difference (mod 2^16, -32767..32768) as its category
    (16 for 32768, which has no extra bits) and its extra bits."""
    d = ((d + 32767) & 0xFFFF) - 32767
    s = 16 if d == 32768 else _category(d)
    return s, (d if d > 0 else d + (1 << s) - 1) if 0 < s < 16 else 0


def write_lossless_jpeg(planes, sampling=None, *, predictor: int = 1,
                        pt: int = 0, restart_rows: int = 0,
                        interleaved: bool = True, app: str = "none",
                        adobe_transform: int = 1, ids=None, diffs=None,
                        arithmetic: bool = False) -> bytes:
    """A lossless JPEG (SOF3, ISO 10918-1 Annex H) of the uint8 ``planes``
    (one (H, W) plane, or a list of 1, 3 or 4) at ``sampling`` [(h, v)] a
    component (box-averaged, rounded down), with ``predictor`` 1-7 and the
    point transform ``pt``, restart intervals of ``restart_rows`` MCU rows,
    one scan or (``interleaved`` False) one a component, ``app`` and
    ``ids`` as ``write_jpeg`` takes them, one Huffman table a component
    class (made from the scan's categories). ``diffs``, a list of int
    arrays over each component's MCU-padded sample grid, replaces the
    coded differences (any value mod 2^16, 32768 as category 16).
    ``arithmetic`` writes an arithmetic-coded lossless frame (SOF11) with
    the same differences in the QM coder, after Annex H's model (each
    difference coded as a DC difference is, its context from the classes
    of the differences to the left and above)."""
    if np.ndim(planes) == 2:
        planes = [planes]
    planes = [np.asarray(p, np.int64) for p in planes]
    nc = len(planes)
    h, w = planes[0].shape
    sampling = sampling or [(1, 1)] * nc
    ids = ids or list(range(1, nc + 1))
    hmax = max(f[0] for f in sampling)
    vmax = max(f[1] for f in sampling)
    mx, my = -(-w // hmax), -(-h // vmax)
    scans = [tuple(range(nc))] if interleaved else [(c,) for c in range(nc)]
    grids = []
    for c, (hs, vs) in enumerate(sampling):
        cw, ch = -(-w * hs // hmax), -(-h * vs // vmax)
        fy, fx = vmax // vs, hmax // hs
        pad = np.pad(planes[c], ((0, ch * fy - h), (0, cw * fx - w)),
                     mode="edge")
        small = pad.reshape(ch, fy, cw, fx).sum(axis=(1, 3)) // (fy * fx)
        grids.append((small >> pt, cw, ch))
    out = bytearray(b"\xff\xd8")

    def segment(marker: int, body: bytes) -> None:
        out.extend(struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body)

    if app == "jfif":
        segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    elif app == "adobe":
        segment(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00"
                + bytes([adobe_transform]))
    segment(0xCB if arithmetic else 0xC3, struct.pack(">BHHB", 8, h, w, nc)
            + b"".join(bytes([ids[c], sampling[c][0] << 4 | sampling[c][1],
                              0]) for c in range(nc)))
    for comps in scans:
        mcus_row = (mx if len(comps) > 1 else grids[comps[0]][1])
        restart = restart_rows * mcus_row
        if restart:
            segment(0xDD, struct.pack(">H", restart))
        # Each component's differences over its MCU-padded grid, the
        # prediction starting anew at the scan and at each restart.
        coded = {}
        for c in comps:
            x, cw, ch = grids[c]
            hs, vs = sampling[c]
            rows = np.arange(ch)
            if len(comps) > 1:
                first = (rows % vs == 0) & ((rows // vs) % max(restart_rows,
                                                               1) == 0)
                if not restart_rows:
                    first = rows == 0
                gw, gh = mx * hs, my * vs
            else:
                first = (rows % max(restart_rows, 1) == 0) if restart_rows \
                    else rows == 0
                gw, gh = cw, ch
            d = np.zeros((gh, gw), np.int64)
            d[:ch, :cw] = x - lossless_predict(x, predictor, pt, first)
            coded[c] = d if diffs is None else np.asarray(diffs[c], np.int64)
        mcus = _mcus(comps, [(coded[c], grids[c][1], grids[c][2])
                             if c in coded else None for c in range(nc)],
                     sampling, mx, my, block=1)
        if arithmetic:
            tables = b""
        else:
            freq = {}
            for c in comps:
                f = freq.setdefault(min(c, 1), [0] * 256)
                for v in coded[c].reshape(-1).tolist():
                    f[_diff_bits(v)[0]] += 1
            tables = {t: optimal_table(f) for t, f in sorted(freq.items())}
            segment(0xC4, b"".join(bytes([t]) + bytes(counts) + bytes(syms)
                                   for t, (counts, syms) in tables.items()))
            codes = {t: _codes(*v) for t, v in tables.items()}
        segment(0xDA, bytes([len(comps)]) + b"".join(
            bytes([ids[c], min(c, 1) << 4]) for c in comps)
            + bytes([predictor, 0, pt]))
        if arithmetic:
            out.extend(_arith_lossless(mcus, coded, restart))
            continue
        bits = _Bits()
        for m, mcu in enumerate(mcus):
            if restart and m and m % restart == 0:
                out.extend(bits.flush())
                out.extend(bytes([0xFF, 0xD0 + (m // restart - 1) % 8]))
            for c, cells in mcu:
                for y, x in cells:
                    s, extra = _diff_bits(int(coded[c][y, x]))
                    bits.put(*codes[min(c, 1)][s])
                    if 0 < s < 16:
                        bits.put(extra, s)
        out.extend(bits.flush())
    out.extend(b"\xff\xd9")
    return bytes(out)


def _arith_lossless(mcus, coded, restart) -> bytes:
    """The differences of a lossless scan in the QM coder after ISO
    10918-1 H.1.4.3: each coded as a DC difference is (F.1.4.4.1), the
    bins of its first decisions picked by the classes (zero, small and
    large positive and negative, at L = 0 and U = 1) of the differences
    coded to its left (Da) and above (Db) in its component, 5 x 5 contexts
    of four bins, the magnitude bins from 100 (Db small) or 129 (Db
    large)."""
    def klass(d):
        if d == 0:
            return 0
        big = abs(d) > 2
        return (3 if big else 1) + (d < 0)

    out = bytearray()
    ar, stats = _Arith(), [0] * 158
    for m, mcu in enumerate(mcus):
        if restart and m and m % restart == 0:
            out.extend(ar.finish())
            out.extend(bytes([0xFF, 0xD0 + (m // restart - 1) % 8]))
            ar, stats = _Arith(), [0] * 158
        for c, cells in mcu:
            d = coded[c]
            for y, x in cells:
                v = ((int(d[y, x]) + 32767) & 0xFFFF) - 32767
                da = int(d[y, x - 1]) if x else 0
                db = int(d[y - 1, x]) if y else 0
                s0 = 4 * (5 * klass(da) + klass(db))
                if v == 0:
                    ar.encode(stats, s0, 0)
                    continue
                ar.encode(stats, s0, 1)
                ar.encode(stats, s0 + 1, 0 if v > 0 else 1)
                st = s0 + 2 + (v < 0)
                v = abs(v) - 1
                x1 = 129 if klass(db) > 2 else 100
                mm = 0
                if v:
                    ar.encode(stats, st, 1)
                    mm, v2, st = 1, v >> 1, x1
                    while v2:
                        ar.encode(stats, st, 1)
                        mm <<= 1
                        st += 1
                        v2 >>= 1
                ar.encode(stats, st, 0)
                st += 14
                mm >>= 1
                while mm:
                    ar.encode(stats, st, 1 if mm & v else 0)
                    mm >>= 1
    out.extend(ar.finish())
    return bytes(out)


# ISO 10918-1 Table D.2, the arithmetic coder's probability states, packed
# as libjpeg's jaricom.c packs them: Qe << 16 | Next_Index_MPS << 8 |
# Switch_MPS << 7 | Next_Index_LPS; the last, 113, is the fixed 0.5 state.
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


class _Arith:
    """``jcarith.c``'s QM coder: ``encode`` one binary decision in a
    statistics bin (a list and an index), ``finish`` the scan's bytes
    (0xFF stuffed)."""

    def __init__(self):
        self.out = bytearray()
        self.a, self.c, self.ct = 0x10000, 0, 11
        self.sc = self.zc = 0
        self.buffer = -1

    def _zeros(self):
        self.out.extend(bytes(self.zc))
        self.zc = 0

    def _put(self, b):
        self.out.append(b)
        if b == 0xFF:
            self.out.append(0)

    def _flush_stacked(self):
        if self.buffer == 0:
            self.zc += 1
        elif self.buffer >= 0:
            self._zeros()
            self.out.append(self.buffer)
        if self.sc:
            self._zeros()
            self.out.extend(b"\xff\x00" * self.sc)
            self.sc = 0

    def _carry(self):
        if self.buffer >= 0:
            self._zeros()
            self._put(self.buffer + 1)
        self.zc += self.sc
        self.sc = 0

    def encode(self, st, i, val):
        sv = st[i]
        qe = ARITAB[sv & 0x7F]
        nl, nm, qe = qe & 0xFF, (qe >> 8) & 0xFF, qe >> 16
        self.a -= qe
        if val != sv >> 7:  # the less probable symbol
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nl
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nm
        while True:  # renormalization and output (D.1.5)
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    self._carry()
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    self._flush_stacked()
                    self.buffer = temp & 0xFF
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                return

    def finish(self) -> bytes:
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            self._carry()
        else:
            self._flush_stacked()
        if self.c & 0x7FFF800:
            self._zeros()
            self._put((self.c >> 19) & 0xFF)
            if self.c & 0x7F800:
                self._put((self.c >> 11) & 0xFF)
        return bytes(self.out)


class _ArithCoder:
    """``jcarith.c``'s statistics and encoders over one restart interval
    of one scan: the DC and AC bins of each table (64 and 256, all 0 at
    the start), the fixed bin, each component's DC predictor and context,
    and the conditioning ``dac`` gives."""

    def __init__(self, dac: dict):
        self.ar, self.dac = _Arith(), dac
        self.dc, self.ac = {}, {}
        self.fixed = [113]
        self.ctx, self.last = {}, {}

    def _magnitude(self, stats, st, v, x1, ac):
        """Figures F.8 and F.9: ``v`` (a magnitude less 1) as its category
        in bin ``st`` and from ``x1`` on (an AC coefficient's second
        decision stays in ``st``), then its bits below the leading one."""
        ar = self.ar
        m = 0
        if v:
            ar.encode(stats, st, 1)
            m, v2 = 1, v >> 1
            if ac and v2:
                ar.encode(stats, st, 1)
                m, v2 = 2, v2 >> 1
            st = x1 if (m > 1 or not ac) else st
            while v2:
                ar.encode(stats, st, 1)
                m <<= 1
                st += 1
                v2 >>= 1
        ar.encode(stats, st, 0)
        st += 14
        mag = m
        m >>= 1
        while m:
            ar.encode(stats, st, 1 if m & v else 0)
            m >>= 1
        return mag

    def dc_value(self, comp, tbl, value):
        """``encode_mcu``'s DC part (and ``encode_mcu_DC_first``'s, on the
        shifted value): the difference from the component's last value in
        the bins its context picks, the context from the magnitude."""
        ar = self.ar
        stats = self.dc.setdefault(tbl, [0] * 64)
        s0 = self.ctx.get(comp, 0)
        v = value - self.last.get(comp, 0)
        if v == 0:
            ar.encode(stats, s0, 0)
            self.ctx[comp] = 0
            return
        self.last[comp] = value
        ar.encode(stats, s0, 1)
        ar.encode(stats, s0 + 1, 0 if v > 0 else 1)
        st, ctx, v = (s0 + 2, 4, v) if v > 0 else (s0 + 3, 8, -v)
        m = self._magnitude(stats, st, v - 1, 20, ac=False)
        lo, hi = self.dac.get((0, tbl), 0x10) & 15, self.dac.get((0, tbl),
                                                                0x10) >> 4
        if m < (1 << lo) >> 1:
            ctx = 0
        elif m > (1 << hi) >> 1:
            ctx += 8
        self.ctx[comp] = ctx

    def ac_band(self, tbl, zz, ss, se, al, ah=None):
        """``encode_mcu``'s AC part (``ss`` 1, ``se`` 63, ``al`` 0),
        ``encode_mcu_AC_first`` or, with ``ah``, ``encode_mcu_AC_refine``
        on one block's zigzag coefficients."""
        ar = self.ar
        stats = self.ac.setdefault(tbl, [0] * 256)
        kx = self.dac.get((1, tbl), 5)
        t = (np.abs(zz) >> al).tolist()
        ke = next((k for k in range(se, 0, -1) if t[k]), 0)
        kex = 0
        if ah is not None:
            kex = next((k for k in range(ke, 0, -1)
                        if abs(int(zz[k])) >> ah), 0)
        k = ss
        while k <= ke:
            st = 3 * (k - 1)
            if k > kex:
                ar.encode(stats, st, 0)  # not the end of the band
            while True:
                if t[k]:
                    if ah is not None and t[k] >> 1:  # known nonzero
                        ar.encode(stats, st + 2, t[k] & 1)
                    else:
                        ar.encode(stats, st + 1, 1)
                        ar.encode(self.fixed, 0, 0 if zz[k] > 0 else 1)
                        if ah is None:
                            self._magnitude(stats, st + 2, t[k] - 1,
                                            189 if k <= kx else 217, ac=True)
                    break
                ar.encode(stats, st + 1, 0)
                st += 3
                k += 1
            k += 1
        if k <= se:
            ar.encode(stats, 3 * (k - 1), 1)


def _arith_scan(scan, progressive, grids, sampling, restart, mx, my,
                dac) -> bytes:
    """One scan's entropy-coded bytes as ``jcarith.c`` writes them, the
    statistics, predictors and coder started anew after each RSTn."""
    comps, ss, se, ah, al = scan
    out = bytearray()
    coder = _ArithCoder(dac)
    for m, mcu in enumerate(_mcus(comps, grids, sampling, mx, my)):
        if restart and m and m % restart == 0:
            out.extend(coder.ar.finish())
            out.extend(bytes([0xFF, 0xD0 + (m // restart - 1) % 8]))
            coder = _ArithCoder(dac)
        for c, cells in mcu:
            for by, bx in cells:
                zz = grids[c][0][by, bx]
                tbl = min(c, 1)
                if not progressive:
                    coder.dc_value(c, tbl, int(zz[0]))
                    coder.ac_band(tbl, zz, 1, 63, 0)
                elif ss == 0 and ah == 0:
                    coder.dc_value(c, tbl, int(zz[0]) >> al)
                elif ss == 0:
                    coder.ar.encode(coder.fixed, 0, (int(zz[0]) >> al) & 1)
                elif ah == 0:
                    coder.ac_band(tbl, zz, ss, se, al)
                else:
                    coder.ac_band(tbl, zz, ss, se, al, ah)
    out.extend(coder.ar.finish())
    return bytes(out)


# Scan scripts [(components, Ss, Se, Ah, Al)] for three components.
SCRIPTS = {
    # jcparam.c jpeg_simple_progression's YCbCr script, as Pillow writes it
    "simple": [((0, 1, 2), 0, 0, 0, 1), ((0,), 1, 5, 0, 2),
               ((2,), 1, 63, 0, 1), ((1,), 1, 63, 0, 1),
               ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1),
               ((0, 1, 2), 0, 0, 1, 0), ((2,), 1, 63, 1, 0),
               ((1,), 1, 63, 1, 0), ((0,), 1, 63, 1, 0)],
    # spectral selection only, the DC of each component in a scan of its own
    "dc_apart": [((0,), 0, 0, 0, 0), ((2,), 0, 0, 0, 0), ((1,), 0, 0, 0, 0),
                 ((0,), 1, 2, 0, 0), ((0,), 3, 63, 0, 0),
                 ((1,), 1, 63, 0, 0), ((2,), 1, 63, 0, 0)],
    # DC in three passes (Al 2, 1, 0), the AC refined from Al 2
    "refine_al2": [((0, 1, 2), 0, 0, 0, 2), ((0, 1, 2), 0, 0, 2, 1),
                   ((0, 1, 2), 0, 0, 1, 0), ((0,), 1, 63, 0, 2),
                   ((1,), 1, 9, 0, 2), ((1,), 10, 63, 0, 1),
                   ((2,), 1, 63, 0, 0), ((0,), 1, 63, 2, 1),
                   ((1,), 1, 9, 2, 1), ((0,), 1, 63, 1, 0),
                   ((1,), 1, 63, 1, 0)],
    # the chroma DC interleaved, the luma's apart and refined
    "pairs": [((0,), 0, 0, 0, 1), ((1, 2), 0, 0, 0, 0), ((0,), 0, 0, 1, 0),
              ((0,), 1, 63, 0, 1), ((0,), 1, 63, 1, 0), ((1,), 1, 63, 0, 0),
              ((2,), 1, 63, 0, 0)],
    # stopped early: block smoothing estimates the missing coefficients
    "dc_only": [((0, 1, 2), 0, 0, 0, 0)],
    "dc_al1": [((0, 1, 2), 0, 0, 0, 1)],
    "band_1_5": [((0, 1, 2), 0, 0, 0, 0), ((0,), 1, 5, 0, 0),
                 ((1,), 1, 5, 0, 0), ((2,), 1, 5, 0, 0)],
    "band_1_5_al1": [((0, 1, 2), 0, 0, 0, 1), ((0,), 1, 5, 0, 1),
                     ((1,), 1, 63, 0, 0), ((2,), 1, 2, 0, 2)],
    "luma_dc_only": [((0, 1, 2), 0, 0, 0, 0), ((1,), 1, 63, 0, 0),
                     ((2,), 1, 63, 0, 0)],
    "simple_no_refine": [((0, 1, 2), 0, 0, 0, 1), ((0,), 1, 5, 0, 2),
                         ((2,), 1, 63, 0, 1), ((1,), 1, 63, 0, 1),
                         ((0,), 6, 63, 0, 2)],
    # each DC in a scan of its own (padding blocks stay zero), then stopped
    "dc_apart_band": [((0,), 0, 0, 0, 1), ((1,), 0, 0, 0, 0),
                      ((2,), 0, 0, 0, 0), ((0,), 1, 5, 0, 1)],
}
SMOOTHED = ("dc_only", "dc_al1", "band_1_5", "band_1_5_al1", "luma_dc_only",
            "simple_no_refine", "dc_apart_band")


def script_for(name: str, nc: int) -> list:
    """``SCRIPTS[name]`` for ``nc`` components: component indices past the
    last are dropped (1: the gray image's own scans), a fourth component
    joins the interleaved DC scans and gets the luma's AC scans."""
    out = []
    for comps, ss, se, ah, al in SCRIPTS[name]:
        comps = tuple(c for c in comps if c < nc)
        if not comps:
            continue
        joins = nc == 4 and ss == 0 and 0 in comps and len(comps) > 1
        out.append((comps + (3,) if joins else comps, ss, se, ah, al))
        if nc == 4 and 0 in comps and not joins:
            out.append(((3,), ss, se, ah, al))
    return out


def sample_planes(w: int, h: int, nc: int = 3, seed: int = 0,
                  noise: int = 30):
    """Smooth gradients with noise: edges and flat runs for the decoder."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    planes = [(xx * 7 + yy * 3) % 256, (xx * 2 + 255 - yy * 5) % 256,
              128 + 100 * np.sin(xx / 3.0) * np.cos(yy / 5.0),
              (xx * yy) % 200 + 30]
    return [np.clip(p + rng.integers(-noise, noise, p.shape), 0, 255).astype(
        np.uint8) for p in planes[:nc]]


def pillow_whole_rgba(data: bytes) -> np.ndarray:
    """Pillow's ``convert("RGBA")`` of JPEG bytes handed to libjpeg in one
    block. Pillow reads a file in blocks of ``ImageFile.MAXBLOCK`` (64
    KiB) and libjpeg's arithmetic decoder cannot wait for the next one
    (``JERR_CANT_SUSPEND``), so Pillow refuses an arithmetic-coded file
    whose data runs past its first block; in one block it decodes it. Any
    other file decodes the same either way."""
    with Image.open(io.BytesIO(data)) as ref:
        ref.decodermaxblock = max(len(data), ImageFile.MAXBLOCK)
        return np.asarray(ref.convert("RGBA"))


def write_fixtures(directory: str) -> None:
    """The JPEGs under ``tests/jpeg`` that ``chip_smoke.py`` checks the
    reader with on the card's host, which has no Pillow, with their Pillow
    decode in ``pillow_rgba.npz``: four small sequential ones (4:2:0;
    4:4:4; 4:2:2 with restart markers; gray with custom Huffman tables);
    the textures of the card's JPEG-textured box (a progressive 4:2:0 one,
    a progressive CMYK one, a sequential CMYK one with restart markers, a
    YCCK one and a progressive YCCK one, these two from ``write_jpeg``); a
    block-smoothed one (a script stopped after band 1-5 at Al 1); a
    progressive 64x128 environment map; the textures of the card's second
    JPEG-textured box: an arithmetic-coded 4:2:0 one with a DAC segment and
    restart markers (SOF9), an arithmetic-coded progressive 4:2:0 one whose
    script stops after band 1-5 at Al 1 (SOF10, block-smoothed), a gray
    lossless one (SOF3, predictor 4, point transform 1, restarts) and an
    RGB one (predictor 7, 2x1 sampled first component); and an
    arithmetic-coded progressive 64x128 environment map. Then 1024^2 and
    2048^2 4:2:0 files, sequential at quality 75 and progressive at
    quality 90, each Huffman- and arithmetic-coded, and a 1024^2 RGB
    lossless file of a smooth image (predictor 4; at 2048^2 it would pass 2
    MB), timed there, with the SHA-256 of their Pillow decode in
    ``pillow_sha256.json``. Run ``python -m tests.torch_jpeg_cases`` from
    the repository's root to write them anew (about two minutes)."""
    import hashlib
    import json

    def photo(w, h, seed, noise=30):
        return Image.fromarray(np.stack(sample_planes(w, h, seed=seed,
                                                      noise=noise), -1))

    def smooth(n, seed, noise=6.0):
        rng = np.random.default_rng(seed)
        yy, xx = np.mgrid[0:n, 0:n] / n
        base = np.stack([np.sin(xx * 20) * 0.5 + 0.5,
                         np.cos(yy * 13 + xx * 5) * 0.5 + 0.5, xx * yy],
                        -1) * 255
        if noise:
            base = base + rng.normal(0, noise, base.shape)
        return Image.fromarray(np.clip(base, 0, 255).astype(np.uint8))

    def planes(im):
        return list(np.moveaxis(np.asarray(im), -1, 0))

    def decode(data):
        return pillow_whole_rgba(data)

    def put(name, data):
        with open(os.path.join(directory, name), "wb") as f:
            f.write(data)
        return decode(data)

    def save(name, im, **kw):
        buf = io.BytesIO()
        im.save(buf, "JPEG", **kw)
        return put(name, buf.getvalue())

    sky = smooth(128, 12).resize((128, 64))
    small = {
        "albedo_420.jpg": save("albedo_420.jpg", photo(48, 40, 1, 20),
                               quality=85, subsampling=2),
        "pbr_444.jpg": save("pbr_444.jpg", photo(32, 32, 2, 40), quality=90,
                            subsampling=0),
        "normal_422_restart.jpg": save(
            "normal_422_restart.jpg", photo(40, 24, 3, 10), quality=75,
            subsampling=1, restart_marker_blocks=2),
        "emissive_gray_optimized.jpg": save(
            "emissive_gray_optimized.jpg", photo(24, 24, 4).convert("L"),
            quality=80, optimize=True),
        "albedo_progressive_420.jpg": save(
            "albedo_progressive_420.jpg", photo(48, 40, 7, 20), quality=85,
            subsampling=2, progressive=True),
        "pbr_cmyk_progressive.jpg": save(
            "pbr_cmyk_progressive.jpg", photo(32, 32, 8, 40).convert("CMYK"),
            quality=90, progressive=True),
        "normal_cmyk_restart.jpg": save(
            "normal_cmyk_restart.jpg", photo(40, 24, 9, 10).convert("CMYK"),
            quality=75, restart_marker_blocks=2),
        "emissive_ycck_420.jpg": put("emissive_ycck_420.jpg", write_jpeg(
            sample_planes(24, 24, nc=4, seed=10),
            [(2, 2), (1, 1), (1, 1), (1, 1)], quality=80, app="adobe",
            adobe_transform=2)),
        "roughness_ycck_progressive.jpg": put(
            "roughness_ycck_progressive.jpg", write_jpeg(
                sample_planes(36, 20, nc=4, seed=13),
                [(2, 1), (1, 1), (1, 1), (2, 1)], quality=70, restart=3,
                app="adobe", adobe_transform=2,
                scans=script_for("refine_al2", 4))),
        "albedo_smoothed.jpg": put("albedo_smoothed.jpg", write_jpeg(
            sample_planes(40, 40, seed=11), [(2, 2), (1, 1), (1, 1)],
            quality=70, scans=script_for("band_1_5_al1", 3))),
        "env_progressive.jpg": save("env_progressive.jpg", sky, quality=90,
                                    progressive=True),
        "albedo_arith_restart.jpg": put("albedo_arith_restart.jpg", write_jpeg(
            sample_planes(48, 40, seed=14), [(2, 2), (1, 1), (1, 1)],
            quality=85, arithmetic=True, restart=3,
            dac={(0, 0): 0x21, (1, 0): 3, (0, 1): 0x10, (1, 1): 8})),
        "pbr_arith_progressive_smoothed.jpg": put(
            "pbr_arith_progressive_smoothed.jpg", write_jpeg(
                sample_planes(40, 40, seed=15), [(2, 2), (1, 1), (1, 1)],
                quality=70, arithmetic=True, restart=2,
                scans=script_for("band_1_5_al1", 3))),
        "roughness_lossless_gray.jpg": put(
            "roughness_lossless_gray.jpg", write_lossless_jpeg(
                sample_planes(36, 20, nc=1, seed=16), predictor=4, pt=1,
                restart_rows=2)),
        "normal_lossless_rgb.jpg": put(
            "normal_lossless_rgb.jpg", write_lossless_jpeg(
                sample_planes(40, 24, seed=17), [(2, 1), (1, 1), (1, 1)],
                predictor=7, restart_rows=1)),
        "env_arith_progressive.jpg": put(
            "env_arith_progressive.jpg", write_jpeg(
                planes(sky), [(2, 2), (1, 1), (1, 1)], quality=90,
                arithmetic=True, scans=script_for("simple", 3))),
    }
    np.savez_compressed(os.path.join(directory, "pillow_rgba.npz"), **small)
    digests = {}
    def digest(name, rgba):
        digests[name] = hashlib.sha256(
            np.ascontiguousarray(rgba).tobytes()).hexdigest()

    for n, seed in ((1024, 5), (2048, 6)):
        for name, kw in ((f"timing_{n}.jpg", {"quality": 75}),
                         (f"timing_progressive_{n}.jpg",
                          {"quality": 90, "progressive": True})):
            digest(name, save(name, smooth(n, seed), subsampling=2, **kw))
        for name, kw in ((f"timing_arith_{n}.jpg", {"quality": 75}),
                         (f"timing_arith_progressive_{n}.jpg",
                          {"quality": 90, "scans": script_for("simple", 3)})):
            digest(name, put(name, write_jpeg(
                planes(smooth(n, seed)), [(2, 2), (1, 1), (1, 1)],
                arithmetic=True, **kw)))
    digest("timing_lossless_1024.jpg", put(
        "timing_lossless_1024.jpg", write_lossless_jpeg(
            planes(smooth(1024, 5, noise=0)), predictor=4)))
    with open(os.path.join(directory, "pillow_sha256.json"), "w") as f:
        json.dump(digests, f, indent=1)


if __name__ == "__main__":
    write_fixtures(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "jpeg"))
