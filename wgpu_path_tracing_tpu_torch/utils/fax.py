"""CCITT fax decoding of TIFF strips and tiles as libtiff's ``tif_fax3.c``
decodes them, in plain Python: the plain version of ``accel/cbvh/
fax_scan.cpp``'s ``wpt_fax``, which the native library runs wherever
``accel.native.native_available()``.

Four codings (TIFF compression 2, 3, 4 and 32771):

* modified Huffman (2): each row one-dimensional, the bits to the next
  byte boundary dropped after it (libtiff's ``Fax3DecodeRLE``);
* T.4 (3): an EOL before each row (searched for, so fill bits and missing
  EOLs pass), then a one-dimensional row, or with ``T4Options`` bit 0 a tag
  bit choosing one- or two-dimensional coding (``Fax3Decode1D``,
  ``Fax3Decode2D``);
* T.6 (4): every row two-dimensional against the one above, up to EOFB
  (``Fax4Decode``);
* RLEW (32771): modified Huffman, each row padded to a 16-bit boundary:
  the bits held dropped to a multiple of 16, and with none held a byte
  skipped where the next one lies at an odd address (libtiff reads the
  strip where it lies in the file's image, so ``options`` gives the parity
  of the strip's file offset).

The decoder keeps libtiff's run arrays and its repairs: a bad code word
ends the row, whose runs are then cleaned up to the row's width
(``CLEANUP_RUNS``), and decoding goes on; data that runs out pads with
zeros a code at a time and ends the strip. The bits come first to last
from the most significant bit of each byte (fill order 2 is undone by the
caller). The tables are T.4's codes as ``mkg3states`` lays them out,
indexed by the next 7, 12 or 13 bits, least significant first.
"""

from __future__ import annotations

import numpy as np

# Table states (libtiff's tif_fax3.h).
S_NULL, S_PASS, S_HORIZ, S_V0, S_VR, S_VL, S_EXT = 0, 1, 2, 3, 4, 5, 6
S_TERMW, S_TERMB, S_MAKEUPW, S_MAKEUPB, S_MAKEUP, S_EOL = 7, 8, 9, 10, 11, 12
# Status of a strip: 0 decoded (libtiff returns 1); 1 the data ran out
# before the last row, or a T.6 strip ended (EOFB) before it: libtiff then
# leaves the rows after unwritten, which Pillow shows as whatever its
# buffer held, so the port does not read the strip; 2 a run array would
# overflow, or a T.6 strip ended on its first row (libtiff returns -1 and
# Pillow refuses the file).
FAX_STATUS = {1: "CCITT data that ends before the strip's last row",
              2: "bad CCITT data (libtiff refuses the strip)"}

_WHITE_TERM = (
    "00110101 000111 0111 1000 1011 1100 1110 1111 10011 10100 00111 01000 "
    "001000 000011 110100 110101 101010 101011 0100111 0001100 0001000 "
    "0010111 0000011 0000100 0101000 0101011 0010011 0100100 0011000 "
    "00000010 00000011 00011010 00011011 00010010 00010011 00010100 "
    "00010101 00010110 00010111 00101000 00101001 00101010 00101011 "
    "00101100 00101101 00000100 00000101 00001010 00001011 01010010 "
    "01010011 01010100 01010101 00100100 00100101 01011000 01011001 "
    "01011010 01011011 01001010 01001011 00110010 00110011 00110100").split()
_WHITE_MAKEUP = (
    "11011 10010 010111 0110111 00110110 00110111 01100100 01100101 "
    "01101000 01100111 011001100 011001101 011010010 011010011 011010100 "
    "011010101 011010110 011010111 011011000 011011001 011011010 "
    "011011011 010011000 010011001 010011010 011000 010011011").split()
_BLACK_TERM = (
    "0000110111 010 11 10 011 0011 0010 00011 000101 000100 0000100 "
    "0000101 0000111 00000100 00000111 000011000 0000010111 0000011000 "
    "0000001000 00001100111 00001101000 00001101100 00000110111 "
    "00000101000 00000010111 00000011000 000011001010 000011001011 "
    "000011001100 000011001101 000001101000 000001101001 000001101010 "
    "000001101011 000011010010 000011010011 000011010100 000011010101 "
    "000011010110 000011010111 000001101100 000001101101 000011011010 "
    "000011011011 000001010100 000001010101 000001010110 000001010111 "
    "000001100100 000001100101 000001010010 000001010011 000000100100 "
    "000000110111 000000111000 000000100111 000000101000 000001011000 "
    "000001011001 000000101011 000000101100 000001011010 000001100110 "
    "000001100111").split()
_BLACK_MAKEUP = (
    "0000001111 000011001000 000011001001 000001011011 000000110011 "
    "000000110100 000000110101 0000001101100 0000001101101 0000001001010 "
    "0000001001011 0000001001100 0000001001101 0000001110010 "
    "0000001110011 0000001110100 0000001110101 0000001110110 "
    "0000001110111 0000001010010 0000001010011 0000001010100 "
    "0000001010101 0000001011010 0000001011011 0000001100100 "
    "0000001100101").split()
_EXT_MAKEUP = (
    "00000001000 00000001100 00000001101 000000010010 000000010011 "
    "000000010100 000000010101 000000010110 000000010111 000000011100 "
    "000000011101 000000011110 000000011111").split()


def _table(bits: int, codes: list) -> np.ndarray:
    """(2^bits, 3) int32 rows (state, width, param): each code's entry at
    every index whose low bits are the code, first bit lowest."""
    t = np.zeros((1 << bits, 3), np.int32)
    for code, state, param in codes:
        n = len(code)
        value = sum(int(c) << i for i, c in enumerate(code))
        t[value + (np.arange(1 << (bits - n)) << n)] = (state, n, param)
    return t


def _run_codes(term, makeup, term_state, makeup_state) -> list:
    return ([(c, term_state, i) for i, c in enumerate(term)]
            + [(c, makeup_state, 64 * (i + 1)) for i, c in enumerate(makeup)]
            + [(c, S_MAKEUP, 1792 + 64 * i) for i, c in enumerate(_EXT_MAKEUP)]
            + [("0" * 11, S_EOL, 0)])


MAIN_TABLE = _table(7, [("1", S_V0, 0), ("011", S_VR, 1), ("000011", S_VR, 2),
                        ("0000011", S_VR, 3), ("010", S_VL, 1),
                        ("000010", S_VL, 2), ("0000010", S_VL, 3),
                        ("001", S_HORIZ, 0), ("0001", S_PASS, 0),
                        ("0000001", S_EXT, 0), ("0000000", S_EOL, 0)])
WHITE_TABLE = _table(12, _run_codes(_WHITE_TERM, _WHITE_MAKEUP, S_TERMW,
                                    S_MAKEUPW))
BLACK_TABLE = _table(13, _run_codes(_BLACK_TERM, _BLACK_MAKEUP, S_TERMB,
                                    S_MAKEUPB))
_REVERSE = [int(f"{i:08b}"[::-1], 2) for i in range(256)]


class _Overflow(Exception):
    """libtiff's "Buffer overflow": the decode returns -1."""


class _EOF(Exception):
    """No bits left where a code is needed."""


class _State:
    """The decoder's registers (``DECLARE_STATE``): the bit accumulator,
    least significant bit first, and the row's runs."""

    def __init__(self, src: bytes, lastx: int, runs: list):
        self.src, self.cp = src, 0
        self.acc = self.avail = 0
        self.lastx = lastx
        self.nruns = (len(runs) - 1) // 2
        # libtiff's one run array: the current row's runs from co, the
        # reference row's from ro (each strip starts at 0 and nruns).
        self.runs, self.co, self.ro = runs, 0, self.nruns
        self.eol = 0
        self.a0 = self.run = self.pa = 0

    def need(self, n: int, two: bool = True) -> None:
        """NeedBits8 (one byte at most) or NeedBits16 (two); at the end
        of the data, pad with zeros unless no bit is left (raise _EOF)."""
        if self.avail >= n:
            return
        if self.cp >= len(self.src):
            if self.avail == 0:
                raise _EOF
            self.avail = n
            return
        self.acc |= _REVERSE[self.src[self.cp]] << self.avail
        self.cp += 1
        self.avail += 8
        if two and self.avail < n:
            if self.cp >= len(self.src):
                self.avail = n
            else:
                self.acc |= _REVERSE[self.src[self.cp]] << self.avail
                self.cp += 1
                self.avail += 8

    def get(self, n: int) -> int:
        return self.acc & ((1 << n) - 1)

    def clr(self, n: int) -> None:
        self.avail -= n
        self.acc >>= n

    def lookup(self, table: np.ndarray, bits: int, two: bool = True):
        self.need(bits, two)
        state, width, param = table[self.get(bits)]
        self.clr(int(width))
        return int(state), int(param)

    def setvalue(self, x: int) -> None:
        if self.pa >= self.nruns:
            raise _Overflow
        self.runs[self.co + self.pa] = self.run + x
        self.pa += 1
        self.a0 += x
        self.run = 0

    def cleanup(self) -> None:
        """CLEANUP_RUNS: close the row at lastx, whatever its runs say."""
        if self.run:
            self.setvalue(0)
        if self.a0 != self.lastx:
            while self.a0 > self.lastx and self.pa > 0:
                self.pa -= 1
                self.a0 -= self.runs[self.co + self.pa]
            if self.a0 < self.lastx:
                if self.a0 < 0:
                    self.a0 = 0
                if self.pa & 1:
                    self.setvalue(0)
                self.setvalue(self.lastx - self.a0)
            elif self.a0 > self.lastx:
                self.setvalue(self.lastx)
                self.setvalue(0)

    def sync_eol(self) -> None:
        """SYNC_EOL: find the EOL (11 zeros) unless one was just read,
        skip zero bytes and zeros up to its 1."""
        if self.eol == 0:
            while True:
                self.need(11)
                if self.get(11) == 0:
                    break
                self.clr(1)
        while True:
            self.need(8, False)
            if self.get(8):
                break
            self.clr(8)
        while self.get(1) == 0:
            self.clr(1)
        self.clr(1)
        self.eol = 0

    def expand_1d(self) -> bool:
        """EXPAND1D: white and black runs to the row's end; False where the
        data ran out (the runs then cleaned up)."""
        try:
            while True:
                for table, bits, term in ((WHITE_TABLE, 12, S_TERMW),
                                          (BLACK_TABLE, 13, S_TERMB)):
                    while True:
                        state, param = self.lookup(table, bits)
                        if state == S_EOL:
                            self.eol = 1
                            self.cleanup()
                            return True
                        if state == term:
                            self.setvalue(param)
                            break
                        if state in (S_MAKEUPW, S_MAKEUPB, S_MAKEUP):
                            self.a0 += param
                            self.run += param
                            continue
                        self.cleanup()  # unexpected code: end the row
                        return True
                    if self.a0 >= self.lastx:
                        self.cleanup()
                        return True
                cur = self.co + self.pa
                if self.runs[cur - 1] == 0 and self.runs[cur - 2] == 0:
                    self.pa -= 2
        except _EOF:
            self.cleanup()
            return False

    def _horizontal_run(self, colour: int) -> bool:
        """One run of a horizontal mode code; False on a bad code."""
        table, bits, term = ((WHITE_TABLE, 12, S_TERMW) if colour == 0
                             else (BLACK_TABLE, 13, S_TERMB))
        while True:
            state, param = self.lookup(table, bits)
            if state == term:
                self.setvalue(param)
                return True
            if state in (S_MAKEUP, S_MAKEUPW if colour == 0 else S_MAKEUPB):
                self.a0 += param
                self.run += param
                continue
            return False

    def expand_2d(self) -> bool:
        """EXPAND2D: the row against the reference runs; False where the
        data ran out."""
        runs, ro, lastx, nruns = self.runs, self.ro, self.lastx, self.nruns
        pb = 0
        b1 = runs[ro]
        pb += 1

        def check_b1():
            nonlocal b1, pb
            if self.pa != 0:
                while b1 <= self.a0 and b1 < lastx:
                    if pb + 1 >= nruns:
                        raise _Overflow
                    b1 += runs[ro + pb] + runs[ro + pb + 1]
                    pb += 2

        try:
            while self.a0 < lastx:
                if self.pa >= nruns:
                    raise _Overflow
                state, param = self.lookup(MAIN_TABLE, 7, False)
                if state == S_PASS:
                    check_b1()
                    if pb + 1 >= nruns:
                        raise _Overflow
                    b1 += runs[ro + pb]
                    pb += 1
                    self.run += b1 - self.a0
                    self.a0 = b1
                    b1 += runs[ro + pb]
                    pb += 1
                elif state == S_HORIZ:
                    first = self.pa & 1
                    if not (self._horizontal_run(first)
                            and self._horizontal_run(1 - first)):
                        break  # unexpected code: end the row
                    check_b1()
                elif state in (S_V0, S_VR):
                    check_b1()
                    self.setvalue(b1 - self.a0 + (param if state == S_VR
                                                  else 0))
                    if pb >= nruns:
                        raise _Overflow
                    b1 += runs[ro + pb]
                    pb += 1
                elif state == S_VL:
                    check_b1()
                    if b1 < self.a0 + param:
                        break  # unexpected: end the row
                    self.setvalue(b1 - self.a0 - param)
                    if pb == 0:
                        raise _Overflow  # libtiff would read before the runs
                    pb -= 1
                    b1 -= runs[ro + pb]
                elif state == S_EXT:
                    runs[self.co + self.pa] = lastx - self.a0
                    self.pa += 1
                    break
                else:  # S_EOL
                    runs[self.co + self.pa] = lastx - self.a0
                    self.pa += 1
                    self.need(4, False)
                    self.clr(4)
                    self.eol = 1
                    break
            else:
                if self.run:
                    if self.run + self.a0 < lastx:
                        # expect a final V0
                        self.need(1, False)
                        if self.get(1):
                            self.clr(1)
                            self.setvalue(0)
                    else:
                        self.setvalue(0)
        except _EOF:
            self.cleanup()
            return False
        self.cleanup()
        return True


def _fill(out: np.ndarray, row: int, runs: list, start: int, n: int,
          lastx: int) -> None:
    """_TIFFFax3fillruns: the n runs from ``runs[start]`` (white, black,
    ...) into row ``row`` of the 0/1 samples, each cut to the row's width
    (as libtiff cuts the run array too)."""
    if n & 1:
        runs[start + n] = 0
        n += 1
    x = 0
    line = out[row]
    for j in range(start, start + n):
        r = runs[j] & 0xFFFFFFFF  # libtiff's runs are unsigned
        if x + r > lastx or r > lastx:
            r = runs[j] = lastx - x
        if r:
            line[x:x + r] = (j - start) & 1
            x += r


def fax_runs(compression: int, lastx: int, options: int = 0) -> np.ndarray:
    """libtiff's run array for a page ``lastx`` pixels wide, zeroed (one
    entry more for a fill past its end): it lives across the strips and
    tiles of a page, so a strip's bad data reads runs an earlier strip
    left."""
    two_d = compression == 4 or (compression == 3 and options & 1)
    nruns = -(-(lastx + 1) // 32) * 32 * (2 if two_d else 1)
    return np.zeros(2 * nruns + 1, np.int64)


def fax_plain(src: bytes, compression: int, lastx: int, rows: int,
              options: int = 0, runs: np.ndarray | None = None
              ) -> tuple[np.ndarray, int]:
    """One strip or tile of ``rows`` rows of ``lastx`` pixels ->
    ((rows, lastx) uint8 0/1 samples, status 0 or a key of FAX_STATUS).
    ``options`` is T4Options (bit 0: two-dimensional rows), or for RLEW the
    parity of the strip's file offset; ``runs`` the
    page's run array (``fax_runs``), updated in place. The rows not decoded
    stay 0."""
    if runs is None:
        runs = fax_runs(compression, lastx, options)
    two_d = compression == 4 or (compression == 3 and options & 1)
    st = _State(src, lastx, runs.tolist())
    out = np.zeros((rows, lastx), np.uint8)
    try:
        return out, _decode(st, out, compression, two_d, rows, lastx,
                            options)
    finally:
        runs[:] = st.runs


def _decode(st: _State, out: np.ndarray, compression: int, two_d: bool,
            rows: int, lastx: int, options: int) -> int:
    """The strip's rows into ``out``: its status."""
    if two_d:
        st.runs[st.ro], st.runs[st.ro + 1] = lastx, 0
    try:
        for line in range(rows):
            st.a0 = st.run = st.pa = 0
            if compression == 4:
                ok = st.expand_2d()
                if not ok or st.eol:
                    # EOFB or the end of the data: libtiff fills this row
                    # and fails the strip only on its first row.
                    _fill(out, line, st.runs, st.co, st.pa, lastx)
                    return 1 if line else 2
            elif compression == 3:
                try:
                    st.sync_eol()
                    if two_d:
                        st.need(1, False)
                        one_d = st.get(1)
                        st.clr(1)
                except _EOF:
                    st.cleanup()
                    _fill(out, line, st.runs, st.co, st.pa, lastx)
                    return 1
                ok = st.expand_1d() if not two_d or one_d else st.expand_2d()
                if not ok:
                    _fill(out, line, st.runs, st.co, st.pa, lastx)
                    return 1
            elif not st.expand_1d():
                _fill(out, line, st.runs, st.co, st.pa, lastx)
                return 1
            _fill(out, line, st.runs, st.co, st.pa, lastx)
            if compression == 2:
                st.clr(st.avail & 7)  # to the byte boundary
            elif compression == 32771:
                # to a 16-bit boundary of the bits held, then of memory
                st.clr(st.avail & 15)
                if st.avail == 0 and (options + st.cp) & 1:
                    st.cp += 1
            if two_d:
                if compression == 4 or st.pa < st.nruns:
                    if st.pa >= st.nruns:
                        raise _Overflow
                    st.runs[st.co + st.pa] = 0  # an imaginary change
                    st.pa += 1
                st.co, st.ro = st.ro, st.co
    except _Overflow:
        return 2
    return 0
