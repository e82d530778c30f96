"""JPEG 2000 decoding in NumPy, the pixels Pillow 12.1.0 gives through
OpenJPEG 2.5.4.

Pillow opens J2K codestreams and JP2 files with ``Jpeg2KImagePlugin`` and
decodes them tile by tile through OpenJPEG, then unpacks each tile into its
mode in ``Jpeg2KDecode.c``. This module reads the same bytes to the same
pixels, all three found black-box:

* Pillow's ``_open`` (``open_header``): the mode and size from SIZ, or
  from the JP2 header boxes (``ihdr``, ``colr``, ``pclr``, ``res``), read
  by a port of its ``BoxReader``, and the comment. Where ``_open`` raises
  ``SyntaxError`` or an error ``Image.open`` treats alike, the bytes are
  passed on (``NotThisFormat``); any other error ends the search.
* OpenJPEG's codestream decoder in its strict mode (``_Codestream``,
  ``_decode_tile``): the main and tile-part headers, the packets of every
  progression order and progression change, the inclusion and zero
  bit-plane tag trees, the code-blocks' MQ and raw passes with every
  code-block style (``t1_plain``, which ``accel/cbvh/j2k_scan.cpp``'s
  ``wpt_j2k_t1`` runs wherever ``accel.native.native_available()``), ROI
  max-shift, dequantisation, the 5/3 wavelet in integers and the 9/7 in
  float32 with OpenJPEG's lifting steps (one NumPy operation for each of
  its SSE operations, so every rounding is the same), the RCT and ICT,
  the level shift, ``lrintf`` and the clamp. The JP2 wrapper's
  ``jp2c`` box holds the codestream; OpenJPEG's tile interface, which
  Pillow uses, applies no palette, channel definition or colour
  conversion.
* Pillow's unpackers: each tile's samples packed as OpenJPEG hands them
  over (1, 2 or 4 bytes a sample, truncated), read back with Pillow's
  shifts and offsets and its indexing of subsampled components, into
  "L", "LA", "I;16", "RGB", "RGBA", "CMYK", "P" or "PA", sYCC through
  Pillow's YCbCr tables; then ``convert("RGBA")``.

What OpenJPEG refuses (a cut file, a bad marker, a segment past its
tile-part) raises ``ValueError`` naming the file, as Pillow raises
``OSError``. HTJ2K code-blocks (Part 15) raise ``NotImplementedError``
naming the file: nothing on the build host writes them. The Part 2
markers (MCT, MCC, MCO, CBD) are read as OpenJPEG reads them, its checks
and its warnings included (an MCO sets the level shifts); a custom
component transform in COD and a CBD that changes a component's depth
raise ``NotImplementedError``.
"""

from __future__ import annotations

import io
import os
import struct

import numpy as np

from wgpu_path_tracing_tpu_torch.utils.sniff import NotThisFormat, bomb_check

J2K_SIG = b"\xff\x4f\xff\x51"
JP2_SIG = b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a"
BROKEN = "broken data stream when reading image file"


class _Broken(Exception):
    """OpenJPEG or Pillow's decoder gives up (Pillow's OSError)."""


class _Unsupported(Exception):
    """A feature no file on the build host exercises."""


# --- Pillow's _open ---------------------------------------------------------


class _BoxReader:
    """Pillow's ``Jpeg2KImagePlugin.BoxReader``, line for line."""

    def __init__(self, fp, length: int = -1) -> None:
        self.fp = fp
        self.has_length = length >= 0
        self.length = length
        self.remaining_in_box = -1

    def _can_read(self, num_bytes: int) -> bool:
        if self.has_length and self.fp.tell() + num_bytes > self.length:
            return False
        if self.remaining_in_box >= 0:
            return num_bytes <= self.remaining_in_box
        return True

    def _read_bytes(self, num_bytes: int) -> bytes:
        if not self._can_read(num_bytes):
            raise SyntaxError("Not enough data in header")
        data = self.fp.read(num_bytes)
        if len(data) < num_bytes:
            raise OSError(f"Expected to read {num_bytes} bytes but only got "
                          f"{len(data)}.")
        if self.remaining_in_box > 0:
            self.remaining_in_box -= num_bytes
        return data

    def read_fields(self, fmt: str) -> tuple:
        return struct.unpack(fmt, self._read_bytes(struct.calcsize(fmt)))

    def read_boxes(self) -> "_BoxReader":
        size = self.remaining_in_box
        data = self._read_bytes(size)
        return _BoxReader(io.BytesIO(data), size)

    def has_next_box(self) -> bool:
        if self.has_length:
            return self.fp.tell() + self.remaining_in_box < self.length
        return True

    def next_box_type(self) -> bytes:
        if self.remaining_in_box > 0:
            self.fp.seek(self.remaining_in_box, os.SEEK_CUR)
        self.remaining_in_box = -1
        lbox, tbox = self.read_fields(">I4s")
        if lbox == 1:
            lbox = self.read_fields(">Q")[0]
            hlen = 16
        else:
            hlen = 8
        if lbox < hlen or not self._can_read(lbox - hlen):
            raise SyntaxError("Invalid header length")
        self.remaining_in_box = lbox - hlen
        return tbox


class _Palette:
    """The part of Pillow's ``ImagePalette`` that ``_parse_jp2_header``
    and ``load`` use: ``getcolor`` (a colour seen before keeps its index;
    the index of a new one counts the palette's bytes in colours of the
    mode's length, whatever the length of the colours given) and the
    bytes."""

    def __init__(self, mode: str) -> None:
        self.mode = mode
        self.palette = bytearray()
        self.colors: dict = {}

    def getcolor(self, color: tuple) -> int:
        if self.mode == "RGB":
            if len(color) == 4:
                if color[3] != 255:
                    raise ValueError("cannot add non-opaque RGBA color to "
                                     "RGB palette")
                color = color[:3]
        elif self.mode == "RGBA":
            if len(color) == 3:
                color += (255,)
        if color in self.colors:
            return self.colors[color]
        n = len(self.mode)
        index = len(self.palette) // n
        if index >= 256:
            raise ValueError("cannot allocate more than 256 colors")
        self.colors[color] = index
        if index * n < len(self.palette):
            self.palette = (self.palette[:index * n] + bytes(color)
                            + self.palette[index * n + n:])
        else:
            self.palette += bytes(color)
        return index

    def rgba(self) -> np.ndarray:
        """(256, 4) uint8: Pillow's palette after ``putpalette`` (an index
        past the entries it was given reads opaque black, found by
        test)."""
        out = np.zeros((256, 4), np.uint8)
        out[:, 3] = 255
        bits = 32 if self.mode == "RGBA" else 24
        size = len(self.palette) * 8 // bits
        if size > 256:
            raise ValueError("invalid palette size")
        step = bits // 8
        raw = np.frombuffer(bytes(self.palette[:size * step]), np.uint8)
        out[:size, :step] = raw.reshape(size, step)
        return out


def _parse_codestream(fp) -> tuple:
    hdr = fp.read(2)
    lsiz = struct.unpack_from(">H", hdr)[0]
    siz = hdr + fp.read(lsiz - 2)
    (lsiz, rsiz, xsiz, ysiz, xosiz, yosiz, _, _, _, _,
     csiz) = struct.unpack_from(">HHIIIIIIIIH", siz)
    size = (xsiz - xosiz, ysiz - yosiz)
    if csiz == 1:
        ssiz = struct.unpack_from(">B", siz, 38)
        mode = "I;16" if (ssiz[0] & 0x7F) + 1 > 8 else "L"
    elif csiz == 2:
        mode = "LA"
    elif csiz == 3:
        mode = "RGB"
    elif csiz == 4:
        mode = "RGBA"
    else:
        raise SyntaxError("unable to determine J2K image mode")
    return size, mode


def _parse_jp2_header(fp) -> tuple:
    reader = _BoxReader(fp)
    header = None
    while reader.has_next_box():
        tbox = reader.next_box_type()
        if tbox == b"jp2h":
            header = reader.read_boxes()
            break
        elif tbox == b"ftyp":
            reader.read_fields(">4s")
    assert header is not None
    size = mode = nc = None
    palette = None
    while header.has_next_box():
        tbox = header.next_box_type()
        if tbox == b"ihdr":
            height, width, nc, bpc = header.read_fields(">IIHB")
            size = (width, height)
            if nc == 1 and (bpc & 0x7F) > 8:
                mode = "I;16"
            elif nc == 1:
                mode = "L"
            elif nc == 2:
                mode = "LA"
            elif nc == 3:
                mode = "RGB"
            elif nc == 4:
                mode = "RGBA"
        elif tbox == b"colr" and nc == 4:
            meth, _, _, enumcs = header.read_fields(">BBBI")
            if meth == 1 and enumcs == 12:
                mode = "CMYK"
        elif tbox == b"pclr" and mode in ("L", "LA"):
            ne, npc = header.read_fields(">HB")
            max_bitdepth = max([0, *header.read_fields(">" + "B" * npc)])
            if max_bitdepth <= 8:
                palette = _Palette("RGBA" if npc == 4 else "RGB")
                for _ in range(ne):
                    palette.getcolor(tuple(header.read_fields(">" + "B" * npc)))
                mode = "P" if mode == "L" else "PA"
        elif tbox == b"res ":
            res = header.read_boxes()
            while res.has_next_box():
                if res.next_box_type() == b"resc":
                    res.read_fields(">HHHHBB")
                    break
    if size is None or mode is None:
        raise SyntaxError("Malformed JP2 header")
    return size, mode, palette


def _parse_comment(fp) -> None:
    while True:
        marker = fp.read(2)
        if not marker:
            break
        typ = marker[1]
        if typ in (0x90, 0xD9):
            break
        hdr = fp.read(2)
        length = struct.unpack_from(">H", hdr)[0]
        if typ == 0x64:
            fp.read(length - 2)
            break
        fp.seek(length - 2, os.SEEK_CUR)


def open_header(data: bytes) -> tuple:
    """Pillow's ``Jpeg2KImageFile._open`` on ``data`` -> (codec, (width,
    height), mode, palette or None), raising what it raises."""
    fp = io.BytesIO(data)
    sig = fp.read(4)
    palette = None
    if sig == J2K_SIG:
        codec = "j2k"
        size, mode = _parse_codestream(fp)
        _parse_comment(fp)
    else:
        sig = sig + fp.read(8)
        if sig != JP2_SIG:
            raise SyntaxError("not a JPEG 2000 file")
        codec = "jp2"
        size, mode, palette = _parse_jp2_header(fp)
        if fp.read(12).endswith(b"jp2c\xff\x4f\xff\x51"):
            length = struct.unpack_from(">H", fp.read(2))[0]
            fp.seek(length - 2, os.SEEK_CUR)
            _parse_comment(fp)
    if size[0] <= 0 or size[1] <= 0:
        raise SyntaxError("an image of no pixels")
    return codec, size, mode, palette


# Errors Image.open turns into "try the next format".
_PASS_ON = (SyntaxError, IndexError, TypeError, KeyError, EOFError,
            struct.error)


# --- the codestream -----------------------------------------------------------

SOC, SOT, SOD, EOC = 0xFF4F, 0xFF90, 0xFF93, 0xFFD9
SIZ, COD, COC, QCD, QCC, RGN, POC = (0xFF51, 0xFF52, 0xFF53, 0xFF5C, 0xFF5D,
                                     0xFF5E, 0xFF5F)
PPM, PPT, TLM, PLM, PLT, CRG, COM = (0xFF60, 0xFF61, 0xFF55, 0xFF57, 0xFF58,
                                     0xFF63, 0xFF64)
CAP, CPF, SOP = 0xFF50, 0xFF59, 0xFF91
# Part 2 markers OpenJPEG reads (MCT, MCC, MCO, CBD).
PART2 = (0xFF74, 0xFF75, 0xFF77, 0xFF78)
# OpenJPEG's marker table: where each marker may stand (main header,
# tile-part header).
_MAIN, _TILE = 1, 2
MARKERS = {SOT: _MAIN | _TILE, COD: _MAIN | _TILE, COC: _MAIN | _TILE,
           RGN: _MAIN | _TILE, QCD: _MAIN | _TILE, QCC: _MAIN | _TILE,
           POC: _MAIN | _TILE, SIZ: 0, TLM: _MAIN, PLM: _MAIN, PLT: _TILE,
           PPM: _MAIN, PPT: _TILE, SOP: 0, CRG: _MAIN,
           COM: _MAIN | _TILE, CAP: _MAIN, CPF: _MAIN,
           0xFF74: _MAIN | _TILE, 0xFF75: _MAIN | _TILE,
           0xFF77: _MAIN | _TILE, 0xFF78: _MAIN}
# Code-block styles.
LAZY, RESET, TERMALL, VSC, PTERM, SEGSYM, HT = 1, 2, 4, 8, 16, 32, 64


class _Comp:
    """A component's coding style and quantisation (OpenJPEG's tccp)."""

    __slots__ = ("numres", "cblkw", "cblkh", "cblksty", "qmfbid", "prcw",
                 "prch", "csty", "qntsty", "numgbits", "stepsizes",
                 "roishift")

    def copy(self) -> "_Comp":
        c = _Comp()
        for k in self.__slots__:
            v = getattr(self, k)
            setattr(c, k, list(v) if isinstance(v, list) else v)
        return c


class _Tcp:
    """A tile's coding parameters (OpenJPEG's tcp)."""

    def __init__(self, ncomp: int) -> None:
        self.csty = 0
        self.prg = 0
        self.numlayers = 0
        self.mct = 0
        self.comps = []
        for _ in range(ncomp):
            c = _Comp()
            c.numres, c.cblkw, c.cblkh, c.cblksty, c.qmfbid = 0, 0, 0, 0, 0
            c.prcw, c.prch, c.csty = [], [], 0
            c.qntsty, c.numgbits, c.stepsizes, c.roishift = 0, 0, [], 0
            self.comps.append(c)
        self.index = 0
        self.pocs = []
        self.dc_shift = None  # an MCO's level shifts (None: each default)
        self.mct_records = {}  # MCT: index -> (element type, data)
        self.mcc_records = []  # MCC: [index, components, deco, offsets]
        self.ppt = {}
        self.data = []
        self.parts_seen = 0
        self.nparts = 0

    def copy(self) -> "_Tcp":
        t = _Tcp(0)
        t.csty, t.prg, t.numlayers, t.mct = (self.csty, self.prg,
                                             self.numlayers, self.mct)
        t.comps = [c.copy() for c in self.comps]
        t.pocs = list(self.pocs)
        t.dc_shift = None if self.dc_shift is None else list(self.dc_shift)
        t.mct_records = dict(self.mct_records)
        t.mcc_records = [list(r) for r in self.mcc_records]
        return t


def _u16(b, at):
    return (b[at] << 8) | b[at + 1]


def _u32(b, at):
    return struct.unpack_from(">I", b, at)[0]


class _Codestream:
    """A codestream's headers and its tiles' data, read as OpenJPEG 2.5.4
    reads them (strict mode)."""

    def __init__(self, cs: bytes) -> None:
        self.cs = cs
        self.ppm = {}
        self.have_ppm = False
        if cs[:2] != b"\xff\x4f":
            raise _Broken("expected a SOC marker")
        pos = 2
        state = "siz"
        seen = set()
        while True:
            marker, pos = self._marker(pos)
            if marker == SOT:
                break
            if state == "siz" and marker != SIZ:
                raise _Broken("expected a SIZ marker")
            body, pos = self._segment(pos)
            if marker == SIZ:
                if state != "siz":
                    raise _Broken("SIZ marker out of place")
                self._siz(body)
                state = "main"
            else:
                if not MARKERS.get(marker, 0) & _MAIN:
                    raise _Broken(f"marker {marker:04x} out of place")
                self._header_marker(marker, body, self.default)
            seen.add(marker)
        for need in (COD, QCD):
            if need not in seen:
                raise _Broken("required marker not found in main header")
        if self.have_ppm:
            self.ppm_data = self._merge_ppm()
        self.main_end = pos - 2
        self._read_tiles(pos - 2)

    # -- marker plumbing --

    def _marker(self, pos: int) -> tuple:
        if pos + 2 > len(self.cs):
            raise _Broken("stream too short")
        m = _u16(self.cs, pos)
        pos += 2
        if m < 0xFF00:
            raise _Broken(f"a marker was expected at {pos - 2}")
        if m not in MARKERS and m not in (SIZ, SOT, SOD, EOC):
            # OpenJPEG skips an unknown marker by scanning two bytes at a
            # time for a known one.
            while True:
                if pos + 2 > len(self.cs):
                    raise _Broken("stream too short")
                m = _u16(self.cs, pos)
                pos += 2
                if m >= 0xFF00 and (m in MARKERS or m in (SIZ, SOT, SOD,
                                                           EOC)):
                    break
        return m, pos

    def _segment(self, pos: int) -> tuple:
        if pos + 2 > len(self.cs):
            raise _Broken("stream too short")
        n = _u16(self.cs, pos)
        if n < 2:
            raise _Broken("invalid marker size")
        if pos + n > len(self.cs):
            raise _Broken("stream too short")
        return self.cs[pos + 2:pos + n], pos + n

    # -- SIZ --

    def _siz(self, b: bytes) -> None:
        if len(b) < 36:
            raise _Broken("error with SIZ marker size")
        (self.rsiz, self.x1, self.y1, self.x0, self.y0, self.tdx, self.tdy,
         self.tx0, self.ty0, nc) = struct.unpack_from(">HIIIIIIIIH", b)
        if len(b) != 36 + 3 * nc or nc == 0:
            raise _Broken("error with SIZ marker size")
        if (self.x0 >= self.x1 or self.y0 >= self.y1 or self.tdx == 0
                or self.tdy == 0):
            raise _Broken("error with SIZ marker: bad image or tile size")
        if (self.tx0 > self.x0 or self.ty0 > self.y0
                or self.tx0 + self.tdx <= self.x0
                or self.ty0 + self.tdy <= self.y0):
            raise _Broken("error with SIZ marker: bad tile offset")
        if nc > 16384:
            raise _Broken("error with SIZ marker: too many components")
        self.prec, self.sgnd, self.dx, self.dy = [], [], [], []
        for i in range(nc):
            ssiz, xr, yr = b[36 + 3 * i], b[37 + 3 * i], b[38 + 3 * i]
            prec = (ssiz & 0x7F) + 1
            if prec > 31:
                raise _Broken("OpenJPEG reads components of up to 31 bits")
            if xr == 0 or yr == 0:
                raise _Broken("invalid component subsampling")
            self.prec.append(prec)
            self.sgnd.append(ssiz >> 7)
            self.dx.append(xr)
            self.dy.append(yr)
        self.nc = nc
        self.tw = -(-(self.x1 - self.tx0) // self.tdx)
        self.th = -(-(self.y1 - self.ty0) // self.tdy)
        if self.tw == 0 or self.th == 0 or self.tw * self.th > 65535:
            raise _Broken("invalid number of tiles")
        self.default = _Tcp(nc)
        self.tcps = {}

    # -- COD, COC, QCD, QCC, RGN, POC --

    def _spcod(self, b: bytes, at: int, comp: _Comp, csty: int) -> int:
        if len(b) < at + 5:
            raise _Broken("error reading SPCod/SPCoc element")
        nl, xcb, ycb, sty, tr = b[at:at + 5]
        if nl > 32:
            raise _Broken("number of resolutions too high")
        comp.numres = nl + 1
        comp.cblkw, comp.cblkh = xcb + 2, ycb + 2
        if xcb > 8 or ycb > 8 or xcb + ycb > 8:
            raise _Broken("error reading SPCod/SPCoc: bad code-block size")
        if sty & HT or (sty & 0x80):
            raise _Unsupported("HTJ2K (Part 15) code-blocks")
        comp.cblksty = sty
        if tr > 1:
            raise _Broken("bad wavelet transform")
        comp.qmfbid = tr
        at += 5
        comp.csty = csty
        if csty & 1:
            if len(b) < at + comp.numres:
                raise _Broken("error reading SPCod/SPCoc element")
            comp.prcw = [v & 15 for v in b[at:at + comp.numres]]
            comp.prch = [v >> 4 for v in b[at:at + comp.numres]]
            for r in range(1, comp.numres):
                if comp.prcw[r] == 0 or comp.prch[r] == 0:
                    raise _Broken("invalid precinct size")
            at += comp.numres
        else:
            comp.prcw = [15] * comp.numres
            comp.prch = [15] * comp.numres
        return at

    def _sqcd(self, b: bytes, at: int, comp: _Comp) -> int:
        if len(b) < at + 1:
            raise _Broken("error reading SQcd or SQcc element")
        sq = b[at]
        at += 1
        comp.qntsty = sq & 31
        comp.numgbits = sq >> 5
        rest = len(b) - at
        if comp.qntsty == 1:
            nbands = 1
        elif comp.qntsty == 0:
            nbands = rest
        else:
            nbands = rest // 2
        steps = []
        for i in range(min(nbands, 97)):
            if comp.qntsty == 0:
                steps.append((b[at] >> 3, 0))
                at += 1
            else:
                if at + 2 > len(b):
                    raise _Broken("error reading SQcd or SQcc element")
                v = _u16(b, at)
                steps.append((v >> 11, v & 0x7FF))
                at += 2
        if nbands > 97:
            at = len(b)
        if comp.qntsty == 1:
            e0, m0 = steps[0] if steps else (0, 0)
            steps = [(max(e0 - (i - 1) // 3, 0) if i else e0, m0)
                     for i in range(97)]
        comp.stepsizes = steps + [(0, 0)] * (97 - len(steps))
        return at

    def _comp_index(self, b: bytes) -> tuple:
        if self.nc <= 256:
            return b[0], 1
        return _u16(b, 0), 2

    def _header_marker(self, m: int, b: bytes, tcp: _Tcp) -> None:
        if m == COD:
            if len(b) < 5:
                raise _Broken("error reading COD marker")
            tcp.csty = b[0]
            if tcp.csty & ~7:
                raise _Broken("unknown Scod value in COD marker")
            if b[1] > 4:
                raise _Broken("unknown progression order in COD marker")
            tcp.prg = b[1]
            tcp.numlayers = _u16(b, 2)
            if tcp.numlayers == 0:
                raise _Broken("number of layers must be positive")
            tcp.mct = b[4]
            if tcp.mct > 1:
                raise _Unsupported("multiple component transforms (Part 2)")
            c0 = _Comp()
            at = self._spcod(b, 5, c0, tcp.csty)
            if at != len(b):
                raise _Broken("error reading COD marker")
            # OpenJPEG copies COD to every component, over a COC read
            # before it (found by test).
            for c in tcp.comps:
                for k in ("numres", "cblkw", "cblkh", "cblksty", "qmfbid",
                          "prcw", "prch", "csty"):
                    setattr(c, k, getattr(c0, k))
        elif m == COC:
            if len(b) < 2:
                raise _Broken("error reading COC marker")
            ci, n = self._comp_index(b)
            if ci >= self.nc:
                raise _Broken("error reading COC marker (bad component)")
            comp = tcp.comps[ci]
            at = self._spcod(b, n + 1, comp, b[n])
            if at != len(b):
                raise _Broken("error reading COC marker")
        elif m == QCD:
            c0 = _Comp()
            at = self._sqcd(b, 0, c0)
            if at != len(b):
                raise _Broken("error reading QCD marker")
            for c in tcp.comps:  # and QCD over a QCC before it
                c.qntsty, c.numgbits = c0.qntsty, c0.numgbits
                c.stepsizes = list(c0.stepsizes)
        elif m == QCC:
            if len(b) < 1:
                raise _Broken("error reading QCC marker")
            ci, n = self._comp_index(b)
            if ci >= self.nc:
                raise _Broken("invalid component number in QCC")
            at = self._sqcd(b, n, tcp.comps[ci])
            if at != len(b):
                raise _Broken("error reading QCC marker")
        elif m == RGN:
            n = 1 if self.nc <= 256 else 2
            if len(b) != n + 2:
                raise _Broken("error reading RGN marker")
            ci = b[0] if n == 1 else _u16(b, 0)
            if ci >= self.nc:
                raise _Broken("bad component number in RGN")
            tcp.comps[ci].roishift = b[n + 1]  # OpenJPEG ignores Srgn
        elif m == POC:
            n = 1 if self.nc <= 256 else 2
            size = 5 + 2 * n
            if len(b) < size or len(b) % size:
                raise _Broken("error reading POC marker")
            at = 0
            while at < len(b):
                r0 = b[at]
                c0 = b[at + 1] if n == 1 else _u16(b, at + 1)
                l1 = min(_u16(b, at + 1 + n), tcp.numlayers)
                r1 = b[at + 3 + n]
                c1 = b[at + 4 + n] if n == 1 else _u16(b, at + 4 + n)
                prg = b[at + 4 + 2 * n]
                tcp.pocs.append((prg, r0, min(c1, self.nc), l1, r1, c0))
                at += size
        elif m == PPM:
            if len(b) < 2:
                raise _Broken("error reading PPM marker")
            if b[0] in self.ppm:
                raise _Broken("Zppm already read")
            self.ppm[b[0]] = b[1:]
            self.have_ppm = True
        elif m == PPT:
            if self.have_ppm:
                raise _Broken("PPT marker in a codestream with PPM")
            if len(b) < 2:
                raise _Broken("error reading PPT marker")
            if b[0] in tcp.ppt:
                raise _Broken("Zppt already read")
            tcp.ppt[b[0]] = b[1:]
        elif m == CAP:
            raise _Unsupported("a CAP marker (HTJ2K, Part 15)")
        elif m in PART2:
            self._part2_marker(m, b, tcp)
        elif m == SIZ:
            raise _Broken("SIZ marker out of place")
        # TLM, PLM, PLT, CRG, COM, CPF: read and unused.

    def _part2_marker(self, m: int, b: bytes, tcp: _Tcp) -> None:
        """OpenJPEG's readers of the Part 2 markers (opj_j2k_read_mct,
        _mcc, _mco, _cbd): what it refuses raises, what it passes over with
        a warning is passed over, and what it keeps is kept. An MCO sets
        every component's level shift to 0 (or to its MCC's offsets); the
        decorrelation matrix counts only under COD's custom transform,
        which raises. A CBD that changes a component's depth or sign
        raises ``_Unsupported``."""
        n = len(b)
        if m == 0xFF74:  # MCT
            if n < 2:
                raise _Broken("error reading MCT marker")
            if _u16(b, 0) != 0:
                return  # "cannot take in charge mct data within multiple"
            if n <= 6:
                raise _Broken("error reading MCT marker")
            imct = _u16(b, 2)
            if _u16(b, 4) != 0:
                # OpenJPEG has already reset the record: only its index
                # and types stay, with no data.
                tcp.mct_records[imct & 0xFF] = ((imct >> 10) & 3, b"")
                return
            tcp.mct_records[imct & 0xFF] = ((imct >> 10) & 3, b[6:])
        elif m == 0xFF75:  # MCC
            if n < 2:
                raise _Broken("error reading MCC marker")
            if _u16(b, 0) != 0:
                return
            if n < 7:
                raise _Broken("error reading MCC marker")
            index = b[2]
            record = next((r for r in tcp.mcc_records if r[0] == index),
                          None)
            new = record is None
            if new:
                record = [index, 0, None, None]
            if _u16(b, 3) != 0:
                return
            collections = _u16(b, 5)
            if collections > 1:
                return
            left, at = n - 7, 7
            for _ in range(collections):
                if left < 3:
                    raise _Broken("error reading MCC marker")
                if b[at] != 1:
                    return
                ncomp = _u16(b, at + 1)
                at, left = at + 3, left - 3
                size = 1 + (ncomp >> 15)
                record[1] = ncomp & 0x7FFF
                if left < size * record[1] + 2:
                    raise _Broken("error reading MCC marker")
                left -= size * record[1] + 2
                for j in range(record[1]):
                    if int.from_bytes(b[at:at + size], "big") != j:
                        return
                    at += size
                ncomp2 = _u16(b, at)
                at += 2
                size = 1 + (ncomp2 >> 15)
                if ncomp2 & 0x7FFF != record[1]:
                    return
                if left < size * record[1] + 3:
                    raise _Broken("error reading MCC marker")
                left -= size * record[1] + 3
                for j in range(record[1]):
                    if int.from_bytes(b[at:at + size], "big") != j:
                        return
                    at += size
                tmp = int.from_bytes(b[at:at + 3], "big")
                at += 3
                record[2] = record[3] = None
                for slot, idx in ((2, tmp & 0xFF), (3, (tmp >> 8) & 0xFF)):
                    if idx:
                        if idx not in tcp.mct_records:
                            raise _Broken("error reading MCC marker")
                        record[slot] = idx
            if left != 0:
                raise _Broken("error reading MCC marker")
            if new:
                tcp.mcc_records.append(record)
        elif m == 0xFF77:  # MCO
            if n < 1:
                raise _Broken("error reading MCO marker")
            stages = b[0]
            if stages > 1:
                return
            if n != stages + 1:
                raise _Broken("error reading MCO marker")
            tcp.dc_shift = [0] * self.nc
            if stages and tcp.mcc_records and tcp.mcc_records[0][0] == b[1] \
                    and tcp.mcc_records[0][1] == self.nc:
                # opj_j2k_add_mct, which looks at the first record only
                _, _, deco, offs = tcp.mcc_records[0]
                if deco is not None:
                    kind, data = tcp.mct_records[deco]
                    if len(data) != (2, 4, 4, 8)[kind] * self.nc * self.nc:
                        raise _Broken("bad MCT decorrelation array")
                if offs is not None:
                    kind, data = tcp.mct_records[offs]
                    size = (2, 4, 4, 8)[kind]
                    if len(data) != size * self.nc:
                        raise _Broken("bad MCT offset array")
                    code = (">H", ">I", ">f", ">d")[kind]
                    vals = [struct.unpack_from(code, data, size * i)[0]
                            for i in range(self.nc)]
                    tcp.dc_shift = [_offset_int32(v) for v in vals]
        else:  # CBD
            if n != self.nc + 2 or _u16(b, 0) != self.nc:
                raise _Broken("error reading CBD marker")
            for i in range(self.nc):
                prec, sgnd = (b[2 + i] & 0x7F) + 1, b[2 + i] >> 7
                if prec > 31:
                    raise _Broken("invalid component precision in CBD")
                if (prec, sgnd) != (self.prec[i], self.sgnd[i]):
                    raise _Unsupported("a CBD marker that changes a "
                                       "component's depth")

    def _merge_ppm(self) -> bytes:
        out = bytearray()
        remaining = 0
        for z in sorted(self.ppm):
            d = self.ppm[z]
            if remaining >= len(d):
                remaining -= len(d)
                out += d
                continue
            out += d[:remaining]
            d = d[remaining:]
            remaining = 0
            while d:
                if len(d) < 4:
                    raise _Broken("not enough bytes to read Nppm")
                n = _u32(d, 0)
                d = d[4:]
                if len(d) >= n:
                    out += d[:n]
                    d = d[n:]
                else:
                    out += d
                    remaining = n - len(d)
                    d = b""
        if remaining:
            raise _Broken("corrupted PPM markers")
        return bytes(out)

    # -- tiles --

    def _read_tiles(self, pos: int) -> None:
        """Each tile-part: its SOT, its header markers, its data (a Psot of
        0 runs to the EOC closing the stream); tiles decode in the order
        their last part completes them."""
        cs = self.cs
        self.order = []
        while True:
            if pos + 2 > len(cs):
                raise _Broken("stream too short (no EOC)")
            m = _u16(cs, pos)
            if m == EOC:
                break
            if m != SOT:
                raise _Broken(f"expected a SOT marker at {pos}")
            if pos + 2 == len(cs):
                break  # the stream ends on a SOT's marker: OpenJPEG stops
            body, after = self._segment(pos + 2)
            if len(body) != 8:
                raise _Broken("error reading SOT marker")
            isot, psot, tpsot, tnsot = struct.unpack(">HIBB", body)
            if isot >= self.tw * self.th:
                raise _Broken("tile index beyond the number of tiles")
            tcp = self.tcps.get(isot)
            first = tcp is None
            if first:
                tcp = self.default.copy()
                tcp.index = isot
                self.tcps[isot] = tcp
            if tcp.nparts and tpsot >= tcp.nparts:
                raise _Broken("TPsot not valid regards to the number of "
                              "tile-parts")
            if tpsot != tcp.parts_seen:
                raise _Broken("invalid tile part index")
            tcp.parts_seen += 1
            if tnsot:
                tcp.nparts = tnsot
            last_in_stream = psot == 0
            pos = after
            while True:
                m, pos = self._marker(pos)
                if m == SOD:
                    break
                if m == SOT or m == EOC:
                    raise _Broken("tile-part header ends without SOD")
                if not MARKERS.get(m, 0) & _TILE:
                    raise _Broken(f"marker {m:04x} out of place in a "
                                  "tile-part header")
                body, pos = self._segment(pos)
                self._header_marker(m, body, tcp)
            start = pos
            if last_in_stream:
                end = len(cs) - 2
                if end < start:
                    raise _Broken("stream too short")
            else:
                end = after - 12 + psot
                if end < start:
                    raise _Broken("Psot smaller than the tile-part header")
                if end > len(cs):
                    raise _Broken("tile part length size inconsistent with "
                                  "stream length")
            tcp.data.append(cs[start:end])
            pos = end
            if tcp.nparts and tcp.parts_seen == tcp.nparts:
                if not any(tcp.data):
                    raise _Broken("a complete tile without data")
                self.order.append(isot)
        # At the end the tiles not yet complete decode in index order, but
        # for those without data, which stay black (found by test).
        self.order += sorted(i for i, t in self.tcps.items()
                             if i not in self.order and any(t.data))


# --- tier 2 -------------------------------------------------------------------


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class _Bio:
    """OpenJPEG's bit reader of packet headers (``opj_bio``): a byte after
    0xFF gives 7 bits; past the end, zero bits."""

    __slots__ = ("d", "pos", "end", "buf", "ct")

    def __init__(self, d: bytes, pos: int, end: int) -> None:
        self.d, self.pos, self.end = d, pos, end
        self.buf = 0
        self.ct = 0

    def bit(self) -> int:
        if self.ct == 0:
            self.buf = (self.buf << 8) & 0xFFFF
            self.ct = 7 if self.buf == 0xFF00 else 8
            if self.pos < self.end:
                self.buf |= self.d[self.pos]
                self.pos += 1
        self.ct -= 1
        return (self.buf >> self.ct) & 1

    def read(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit()
        return v

    def inalign(self) -> None:
        if (self.buf & 0xFF) == 0xFF:
            self.buf = (self.buf << 8) & 0xFFFF
            self.ct = 7 if self.buf == 0xFF00 else 8
            if self.pos < self.end:
                self.buf |= self.d[self.pos]
                self.pos += 1
        self.ct = 0


class _TagTree:
    """OpenJPEG's tag tree (``opj_tgt``) over a w x h grid of leaves."""

    def __init__(self, w: int, h: int) -> None:
        sizes = []
        lw, lh = w, h
        n = 0
        while True:
            sizes.append((lw, lh))
            n += lw * lh
            if lw * lh <= 1:
                break
            lw, lh = (lw + 1) // 2, (lh + 1) // 2
        self.value = [999] * n
        self.low = [0] * n
        self.parent = [-1] * n
        base = 0
        for lvl in range(len(sizes) - 1):
            lw, lh = sizes[lvl]
            nw, _ = sizes[lvl + 1]
            nbase = base + lw * lh
            for j in range(lh):
                for i in range(lw):
                    self.parent[base + j * lw + i] = (nbase + (j >> 1) * nw
                                                      + (i >> 1))
            base = nbase

    def decode(self, bio: _Bio, leaf: int, threshold: int) -> int:
        stack = []
        node = leaf
        while self.parent[node] >= 0:
            stack.append(node)
            node = self.parent[node]
        low = 0
        value, lows = self.value, self.low
        while True:
            if low > lows[node]:
                lows[node] = low
            else:
                low = lows[node]
            while low < threshold and low < value[node]:
                if bio.bit():
                    value[node] = low
                else:
                    low += 1
            lows[node] = low
            if not stack:
                break
            node = stack.pop()
        return 1 if value[node] < threshold else 0


class _Block:
    """A code-block's place and its tier-2 state."""

    __slots__ = ("x0", "y0", "x1", "y1", "numbps", "numlenbits", "segs",
                 "chunks")

    def __init__(self, x0, y0, x1, y1) -> None:
        self.x0, self.y0, self.x1, self.y1 = x0, y0, x1, y1
        self.numbps = 0
        self.numlenbits = 0
        self.segs = []      # [maxpasses, numpasses, len, newpasses, newlen]
        self.chunks = []


class _Band:
    __slots__ = ("orient", "x0", "y0", "x1", "y1", "numbps", "stepsize",
                 "precincts")


class _Res:
    __slots__ = ("x0", "y0", "x1", "y1", "pdx", "pdy", "pw", "ph", "bands")


def _tile_geometry(cs: _Codestream, tcp: _Tcp, index: int) -> dict:
    """OpenJPEG's tcd tile: resolutions, bands, precincts and code-blocks
    of every component."""
    p, q = index % cs.tw, index // cs.tw
    tx0 = max(cs.tx0 + p * cs.tdx, cs.x0)
    ty0 = max(cs.ty0 + q * cs.tdy, cs.y0)
    tx1 = min(cs.tx0 + (p + 1) * cs.tdx, cs.x1)
    ty1 = min(cs.ty0 + (q + 1) * cs.tdy, cs.y1)
    comps = []
    for c in range(cs.nc):
        tc = tcp.comps[c]
        if tc.numres == 0:
            raise _Broken("a component without coding style")
        dx, dy = cs.dx[c], cs.dy[c]
        cx0, cy0 = _cdiv(tx0, dx), _cdiv(ty0, dy)
        cx1, cy1 = _cdiv(tx1, dx), _cdiv(ty1, dy)
        numres = tc.numres
        ress = []
        for r in range(numres):
            lvl = numres - 1 - r
            res = _Res()
            res.x0 = _cdiv(cx0, 1 << lvl)
            res.y0 = _cdiv(cy0, 1 << lvl)
            res.x1 = _cdiv(cx1, 1 << lvl)
            res.y1 = _cdiv(cy1, 1 << lvl)
            pdx, pdy = tc.prcw[r], tc.prch[r]
            res.pdx, res.pdy = pdx, pdy
            px0 = (res.x0 >> pdx) << pdx
            py0 = (res.y0 >> pdy) << pdy
            px1 = _cdiv(res.x1, 1 << pdx) << pdx
            py1 = _cdiv(res.y1, 1 << pdy) << pdy
            res.pw = 0 if res.x0 == res.x1 else (px1 - px0) >> pdx
            res.ph = 0 if res.y0 == res.y1 else (py1 - py0) >> pdy
            if res.pw * res.ph > (1 << 28):
                raise _Broken("too many precincts")
            if r == 0:
                cbgx, cbgy, cbgw, cbgh = px0, py0, pdx, pdy
                orients = (0,)
            else:
                cbgx, cbgy = _cdiv(px0, 2), _cdiv(py0, 2)
                cbgw, cbgh = pdx - 1, pdy - 1
                orients = (1, 2, 3)
            cbw = min(tc.cblkw, cbgw)
            cbh = min(tc.cblkh, cbgh)
            res.bands = []
            for orient in orients:
                band = _Band()
                band.orient = orient
                if r == 0:
                    nb = lvl
                    xob = yob = 0
                else:
                    nb = lvl + 1
                    xob, yob = orient & 1, orient >> 1
                band.x0 = _cdiv(cx0 - (xob << (nb - 1) if nb else 0), 1 << nb)
                band.y0 = _cdiv(cy0 - (yob << (nb - 1) if nb else 0), 1 << nb)
                band.x1 = _cdiv(cx1 - (xob << (nb - 1) if nb else 0), 1 << nb)
                band.y1 = _cdiv(cy1 - (yob << (nb - 1) if nb else 0), 1 << nb)
                si = 0 if r == 0 else 3 * (r - 1) + orient
                expn, mant = tc.stepsizes[si]
                # BUG_WEIRD_TWO_INVK: no band gain for the 9/7 decoder.
                gain = (0 if tc.qmfbid == 0 else
                        (0, 1, 1, 2)[orient])
                rb = cs.prec[c] + gain
                band.stepsize = np.float32((1.0 + mant / 2048.0)
                                           * 2.0 ** (rb - expn))
                band.numbps = expn + tc.numgbits - 1
                band.precincts = []
                for pi in range(res.pw * res.ph):
                    bx0 = cbgx + (pi % res.pw) * (1 << cbgw)
                    by0 = cbgy + (pi // res.pw) * (1 << cbgh)
                    x0 = max(bx0, band.x0)
                    y0 = max(by0, band.y0)
                    x1 = min(bx0 + (1 << cbgw), band.x1)
                    y1 = min(by0 + (1 << cbgh), band.y1)
                    gx0 = (x0 >> cbw) << cbw
                    gy0 = (y0 >> cbh) << cbh
                    gx1 = _cdiv(x1, 1 << cbw) << cbw
                    gy1 = _cdiv(y1, 1 << cbh) << cbh
                    cw = max(0, (gx1 - gx0) >> cbw)
                    ch = max(0, (gy1 - gy0) >> cbh)
                    blocks = []
                    for j in range(ch):
                        for i in range(cw):
                            bx = gx0 + i * (1 << cbw)
                            by = gy0 + j * (1 << cbh)
                            blocks.append(_Block(
                                max(bx, x0), max(by, y0),
                                min(bx + (1 << cbw), x1),
                                min(by + (1 << cbh), y1)))
                    band.precincts.append([cw, ch, blocks, None, None])
                res.bands.append(band)
            ress.append(res)
        comps.append({"x0": cx0, "y0": cy0, "x1": cx1, "y1": cy1,
                      "dx": dx, "dy": dy, "res": ress, "tc": tc})
    return {"x0": tx0, "y0": ty0, "x1": tx1, "y1": ty1, "comps": comps}


def _packet_order(tile: dict, tcp: _Tcp, ncomp: int):
    """(layer, resolution, component, precinct) of each packet in reading
    order: OpenJPEG's ``opj_pi_next`` over the progression, or over each
    progression change in turn, each packet once."""
    comps = tile["comps"]
    maxres = max(c["tc"].numres for c in comps)
    if tcp.pocs:
        pocs = tcp.pocs
    else:
        pocs = [(tcp.prg, 0, ncomp, tcp.numlayers, maxres, 0)]
    include = set()
    tx0, ty0, tx1, ty1 = tile["x0"], tile["y0"], tile["x1"], tile["y1"]

    def precinct_at(c, r, x, y):
        comp = comps[c]
        res = comp["res"][r]
        lvl = comp["tc"].numres - 1 - r
        dx, dy = comp["dx"], comp["dy"]
        trx0 = _cdiv(tx0, dx << lvl)
        try0 = _cdiv(ty0, dy << lvl)
        trx1 = _cdiv(tx1, dx << lvl)
        try1 = _cdiv(ty1, dy << lvl)
        rpx, rpy = res.pdx + lvl, res.pdy + lvl
        if rpx >= 31 or rpy >= 31:
            return None
        if not (y % (dy << rpy) == 0
                or (y == ty0 and ((try0 << lvl) % (1 << rpy)))):
            return None
        if not (x % (dx << rpx) == 0
                or (x == tx0 and ((trx0 << lvl) % (1 << rpx)))):
            return None
        if res.pw == 0 or res.ph == 0:
            return None
        if trx0 == trx1 or try0 == try1:
            return None
        prci = (_cdiv(x, dx << lvl) >> res.pdx) - (trx0 >> res.pdx)
        prcj = (_cdiv(y, dy << lvl) >> res.pdy) - (try0 >> res.pdy)
        return prci + prcj * res.pw

    def steps(comp_list):
        sx = sy = 0
        for c in comp_list:
            comp = comps[c]
            n = comp["tc"].numres
            for r in range(n):
                res = comp["res"][r]
                ex, ey = res.pdx + n - 1 - r, res.pdy + n - 1 - r
                if ex < 32:
                    v = comp["dx"] << ex
                    sx = v if not sx else min(sx, v)
                if ey < 32:
                    v = comp["dy"] << ey
                    sy = v if not sy else min(sy, v)
        return sx, sy

    def positions(sx, sy):
        y = ty0
        while y < ty1:
            x = tx0
            while x < tx1:
                yield x, y
                x += sx - (x % sx)
            y += sy - (y % sy)

    for prg, r0, c1, l1, r1, c0 in pocs:
        if c0 >= ncomp or c1 > ncomp:
            if prg >= 2:
                raise _Broken("invalid compno0/compno1")
        if prg == 0 or prg == 1:
            outer = ((lay, r) for lay in range(0, l1) for r in range(r0, r1)) \
                if prg == 0 else ((lay, r) for r in range(r0, r1)
                                  for lay in range(0, l1))
            for lay, r in outer:
                for c in range(c0, c1):
                    if r >= comps[c]["tc"].numres:
                        continue
                    res = comps[c]["res"][r]
                    for pr in range(res.pw * res.ph):
                        key = (lay, r, c, pr)
                        if key not in include:
                            include.add(key)
                            yield key
        elif prg == 2:  # RPCL
            sx, sy = steps(range(ncomp))
            if not sx or not sy:
                continue
            for r in range(r0, r1):
                for x, y in positions(sx, sy):
                    for c in range(c0, c1):
                        if r >= comps[c]["tc"].numres:
                            continue
                        pr = precinct_at(c, r, x, y)
                        if pr is None:
                            continue
                        for lay in range(0, l1):
                            key = (lay, r, c, pr)
                            if key not in include:
                                include.add(key)
                                yield key
        elif prg == 3:  # PCRL
            sx, sy = steps(range(ncomp))
            if not sx or not sy:
                continue
            for x, y in positions(sx, sy):
                for c in range(c0, c1):
                    for r in range(r0, min(r1, comps[c]["tc"].numres)):
                        pr = precinct_at(c, r, x, y)
                        if pr is None:
                            continue
                        for lay in range(0, l1):
                            key = (lay, r, c, pr)
                            if key not in include:
                                include.add(key)
                                yield key
        elif prg == 4:  # CPRL
            for c in range(c0, c1):
                sx, sy = steps([c])
                if not sx or not sy:
                    break
                for x, y in positions(sx, sy):
                    for r in range(r0, min(r1, comps[c]["tc"].numres)):
                        pr = precinct_at(c, r, x, y)
                        if pr is None:
                            continue
                        for lay in range(0, l1):
                            key = (lay, r, c, pr)
                            if key not in include:
                                include.add(key)
                                yield key


def _init_seg(block: _Block, cblksty: int, first: bool) -> None:
    if cblksty & TERMALL:
        maxp = 1
    elif cblksty & LAZY:
        if first:
            maxp = 10
        else:
            maxp = 2 if block.segs[-1][0] in (1, 10) else 1
    else:
        maxp = 109
    block.segs.append([maxp, 0, 0, 0, 0])


def _read_packets(cs: _Codestream, tcp: _Tcp, tile: dict, ppm: list,
                  spans: list | None = None) -> None:
    """Tier 2: every packet's header and data, into the code-blocks'
    segments. ``spans``, where given, gets each packet's (start, end of
    header, end) in the tile's data."""
    data = b"".join(tcp.data)
    pos, end = 0, len(data)
    if cs.have_ppm:
        hdr, hpos = ppm[0], ppm[1]
        hend = len(hdr)
    elif tcp.ppt:
        hdr = b"".join(tcp.ppt[z] for z in sorted(tcp.ppt))
        hpos, hend = 0, len(hdr)
    else:
        hdr = None
    sop, eph = tcp.csty & 2, tcp.csty & 4
    for lay, r, c, pr in _packet_order(tile, tcp, cs.nc):
        comp = tile["comps"][c]
        tc = comp["tc"]
        res = comp["res"][r]
        packet_start = pos
        if sop:
            if end - pos >= 6 and data[pos] == 0xFF and data[pos + 1] == 0x91:
                pos += 6
        if hdr is None:
            bio = _Bio(data, pos, end)
        else:
            bio = _Bio(hdr, hpos, hend)
        present = bio.bit()
        included = []
        if present:
            for band in res.bands:
                if band.x0 >= band.x1 or band.y0 >= band.y1:
                    continue
                prec = band.precincts[pr]
                cw, ch, blocks = prec[0], prec[1], prec[2]
                if prec[3] is None:
                    prec[3] = _TagTree(cw, ch)
                    prec[4] = _TagTree(cw, ch)
                for bi, blk in enumerate(blocks):
                    if not blk.segs:
                        inc = prec[3].decode(bio, bi, lay + 1)
                    else:
                        inc = bio.bit()
                    if not inc:
                        continue
                    if not blk.segs:
                        i = 0
                        while not prec[4].decode(bio, bi, i):
                            i += 1
                        blk.numbps = (band.numbps + 1 - i) & 0xFFFFFFFF
                        blk.numlenbits = 3
                    # number of passes
                    if not bio.bit():
                        n = 1
                    elif not bio.bit():
                        n = 2
                    else:
                        v = bio.read(2)
                        if v != 3:
                            n = 3 + v
                        else:
                            v = bio.read(5)
                            n = 6 + v if v != 31 else 37 + bio.read(7)
                    inc_bits = 0
                    while bio.bit():
                        inc_bits += 1
                    blk.numlenbits += inc_bits
                    if not blk.segs:
                        _init_seg(blk, tc.cblksty, True)
                        new_from = 0
                    else:
                        new_from = len(blk.segs) - 1
                        if blk.segs[-1][1] == blk.segs[-1][0]:
                            _init_seg(blk, tc.cblksty, False)
                            new_from += 1
                    segno = new_from
                    left = n
                    while True:
                        seg = blk.segs[segno]
                        seg[3] = min(seg[0] - seg[1], left)
                        nbits = blk.numlenbits + (seg[3].bit_length() - 1)
                        if nbits > 32:
                            raise _Broken("invalid bit number in packet "
                                          "header")
                        seg[4] = bio.read(nbits)
                        left -= seg[3]
                        if left <= 0:
                            break
                        _init_seg(blk, tc.cblksty, False)
                        segno += 1
                    included.append((blk, new_from, segno))
        bio.inalign()
        if hdr is None:
            pos = bio.pos
            if eph:
                if end - pos < 2 or data[pos] != 0xFF or data[pos + 1] != 0x92:
                    raise _Broken("expected EPH marker")
                pos += 2
            header_end = pos
        else:
            hpos = bio.pos
            if eph:
                if (hend - hpos < 2 or hdr[hpos] != 0xFF
                        or hdr[hpos + 1] != 0x92):
                    raise _Broken("expected EPH marker")
                hpos += 2
            header_end = pos
        for blk, s0, s1 in included:
            for segno in range(s0, s1 + 1):
                seg = blk.segs[segno]
                if pos + seg[4] > end:
                    raise _Broken("read: segment too long")
                blk.chunks.append(data[pos:pos + seg[4]])
                pos += seg[4]
                seg[2] += seg[4]
                seg[1] += seg[3]
        if spans is not None:
            spans.append((packet_start, header_end, pos))
    if cs.have_ppm:
        ppm[1] = hpos


# --- tier 1 -------------------------------------------------------------------

# The MQ coder's states: (Qe, next if MPS, next if LPS, switch).
MQ_STATES = (
    (0x5601, 1, 1, 1), (0x3401, 2, 6, 0), (0x1801, 3, 9, 0),
    (0x0AC1, 4, 12, 0), (0x0521, 5, 29, 0), (0x0221, 38, 33, 0),
    (0x5601, 7, 6, 1), (0x5401, 8, 14, 0), (0x4801, 9, 14, 0),
    (0x3801, 10, 14, 0), (0x3001, 11, 17, 0), (0x2401, 12, 18, 0),
    (0x1C01, 13, 20, 0), (0x1601, 29, 21, 0), (0x5601, 15, 14, 1),
    (0x5401, 16, 14, 0), (0x5101, 17, 15, 0), (0x4801, 18, 16, 0),
    (0x3801, 19, 17, 0), (0x3401, 20, 18, 0), (0x3001, 21, 19, 0),
    (0x2801, 22, 19, 0), (0x2401, 23, 20, 0), (0x2201, 24, 21, 0),
    (0x1C01, 25, 22, 0), (0x1801, 26, 23, 0), (0x1601, 27, 24, 0),
    (0x1401, 28, 25, 0), (0x1201, 29, 26, 0), (0x1101, 30, 27, 0),
    (0x0AC1, 31, 28, 0), (0x09C1, 32, 29, 0), (0x08A1, 33, 30, 0),
    (0x0521, 34, 31, 0), (0x0441, 35, 32, 0), (0x02A1, 36, 33, 0),
    (0x0221, 37, 34, 0), (0x0141, 38, 35, 0), (0x0111, 39, 36, 0),
    (0x0085, 40, 37, 0), (0x0049, 41, 38, 0), (0x0025, 42, 39, 0),
    (0x0015, 43, 40, 0), (0x0009, 44, 41, 0), (0x0005, 45, 42, 0),
    (0x0001, 45, 43, 0), (0x5601, 46, 46, 0))
CTX_AGG, CTX_UNI = 17, 18


def _zc_table() -> list:
    """[orient][h][v][d] -> zero-coding context 0..8."""
    out = []
    for orient in range(4):
        t = [[[0] * 5 for _ in range(3)] for _ in range(3)]
        for h in range(3):
            for v in range(3):
                for d in range(5):
                    if orient == 3:
                        hv = h + v
                        if d == 0:
                            n = 0 if hv == 0 else 1 if hv == 1 else 2
                        elif d == 1:
                            n = 3 if hv == 0 else 4 if hv == 1 else 5
                        elif d == 2:
                            n = 6 if hv == 0 else 7
                        else:
                            n = 8
                    else:
                        a, b = (v, h) if orient == 1 else (h, v)
                        if a == 0:
                            if b == 0:
                                n = 0 if d == 0 else 1 if d == 1 else 2
                            else:
                                n = 3 if b == 1 else 4
                        elif a == 1:
                            n = (5 if d == 0 else 6) if b == 0 else 7
                        else:
                            n = 8
                    t[h][v][d] = n
        out.append(t)
    return out


ZC = _zc_table()
# (hc + 1, vc + 1) -> (sign context, xor bit).
SC = {(2, 2): (13, 0), (2, 1): (12, 0), (2, 0): (11, 0), (1, 2): (10, 0),
      (1, 1): (9, 0), (1, 0): (10, 1), (0, 2): (11, 1), (0, 1): (12, 1),
      (0, 0): (13, 1)}


class _MQ:
    """The MQ decoder of ISO 15444-1 C.3 over one segment, and the raw
    (bypass) bit reader, as OpenJPEG runs them (two 0xFF bytes stand after
    the segment)."""

    __slots__ = ("d", "bp", "a", "c", "ct", "st", "mps")

    def __init__(self, st: list, mps: list) -> None:
        self.st, self.mps = st, mps

    def init(self, seg: bytes) -> None:
        self.d = seg + b"\xff\xff"
        self.bp = 0
        self.c = (0xFF << 16) if not seg else (self.d[0] << 16)
        self._bytein()
        self.c = (self.c << 7) & 0xFFFFFFFF
        self.ct -= 7
        self.a = 0x8000

    def raw_init(self, seg: bytes) -> None:
        self.d = seg + b"\xff\xff"
        self.bp = 0
        self.c = 0
        self.ct = 0

    def _bytein(self) -> None:
        d, bp = self.d, self.bp
        nxt = d[bp + 1] if bp + 1 < len(d) else 0xFF
        if d[bp] == 0xFF:
            if nxt > 0x8F:
                self.c += 0xFF00
                self.ct = 8
            else:
                self.bp = bp + 1
                self.c += nxt << 9
                self.ct = 7
        else:
            self.bp = bp + 1
            self.c += nxt << 8
            self.ct = 8

    def decode(self, cx: int) -> int:
        st = self.st[cx]
        qe, nmps, nlps, sw = MQ_STATES[st]
        self.a -= qe
        if (self.c >> 16) < qe:
            if self.a < qe:
                d = self.mps[cx]
                self.st[cx] = nmps
            else:
                d = 1 - self.mps[cx]
                if sw:
                    self.mps[cx] = 1 - self.mps[cx]
                self.st[cx] = nlps
            self.a = qe
        else:
            self.c -= qe << 16
            if self.a & 0x8000:
                return self.mps[cx]
            if self.a < qe:
                d = 1 - self.mps[cx]
                if sw:
                    self.mps[cx] = 1 - self.mps[cx]
                self.st[cx] = nlps
            else:
                d = self.mps[cx]
                self.st[cx] = nmps
        while True:
            if self.ct == 0:
                self._bytein()
            self.a <<= 1
            self.c = (self.c << 1) & 0xFFFFFFFF
            self.ct -= 1
            if self.a & 0x8000:
                break
        return d

    def raw(self) -> int:
        if self.ct == 0:
            if self.c == 0xFF:
                if self.d[self.bp] > 0x8F:
                    self.c = 0xFF
                    self.ct = 8
                else:
                    self.c = self.d[self.bp]
                    self.bp += 1
                    self.ct = 7
            else:
                self.c = self.d[self.bp]
                self.bp += 1
                self.ct = 8
        self.ct -= 1
        return (self.c >> self.ct) & 1


def _reset(st: list, mps: list) -> None:
    for i in range(19):
        st[i] = 0
        mps[i] = 0
    st[CTX_UNI] = 46
    st[CTX_AGG] = 3
    st[0] = 4


def t1_plain(data: bytes, w: int, h: int, orient: int, style: int,
             numbps: int, roishift: int, segs: list) -> np.ndarray:
    """One code-block's tier-1 decode, OpenJPEG's ``opj_t1_decode_cblk``:
    (h, w) int32 of twice the magnitudes plus the half step, signed.
    ``segs`` is [(start, length, passes)] into ``data``. Returns None
    where OpenJPEG gives up (31 bit-planes or more)."""
    bpno = (roishift + numbps) & 0xFFFFFFFF
    if bpno >= 1 << 31:
        bpno -= 1 << 32
    if bpno >= 31:
        return None
    W = w + 2
    size = W * (h + 2)
    sig = [0] * size
    neg = [0] * size
    pi = [0] * size
    mu = [0] * size
    val = [0] * size
    st = [0] * 19
    mps = [0] * 19
    _reset(st, mps)
    mq = _MQ(st, mps)
    zc = ZC[orient]
    vsc = style & VSC
    passtype = 2
    stripes = [(y0, min(4, h - y0)) for y0 in range(0, h, 4)]

    def nbh(k: int, last: bool) -> tuple:
        hh = sig[k - 1] + sig[k + 1]
        if last and vsc:
            vv = sig[k - W]
            dd = sig[k - W - 1] + sig[k - W + 1]
        else:
            vv = sig[k - W] + sig[k + W]
            dd = (sig[k - W - 1] + sig[k - W + 1] + sig[k + W - 1]
                  + sig[k + W + 1])
        return hh, vv, dd

    def sign(k: int, last: bool, bit) -> int:
        def contrib(j):
            return 0 if not sig[j] else (-1 if neg[j] else 1)
        hc = max(-1, min(1, contrib(k - 1) + contrib(k + 1)))
        vc = contrib(k - W) + (0 if (last and vsc) else contrib(k + W))
        vc = max(-1, min(1, vc))
        cx, xb = SC[(hc + 1, vc + 1)]
        return bit(cx) ^ xb

    for s_start, s_len, s_passes in segs:
        seg = data[s_start:s_start + s_len]
        raw = (bpno <= numbps - 4 and passtype < 2 and (style & LAZY))
        if raw:
            mq.raw_init(seg)
        else:
            mq.init(seg)
        for _ in range(s_passes):
            if bpno < 1:
                break
            one = 1 << bpno
            half = one >> 1
            oph = one | half
            if passtype == 0:  # significance propagation
                for y0, n in stripes:
                    for x in range(w):
                        for ci in range(n):
                            k = (y0 + ci + 1) * W + x + 1
                            if sig[k] or pi[k]:
                                continue
                            last = ci == 3
                            hh, vv, dd = nbh(k, last)
                            if hh + vv + dd == 0:
                                continue
                            if raw:
                                if mq.raw():
                                    s = mq.raw()
                                    val[k] = -oph if s else oph
                                    sig[k], neg[k] = 1, s
                            elif mq.decode(zc[hh][vv][dd]):
                                s = sign(k, last, mq.decode)
                                val[k] = -oph if s else oph
                                sig[k], neg[k] = 1, s
                            pi[k] = 1
            elif passtype == 1:  # magnitude refinement
                for y0, n in stripes:
                    for x in range(w):
                        for ci in range(n):
                            k = (y0 + ci + 1) * W + x + 1
                            if not sig[k] or pi[k]:
                                continue
                            if raw:
                                v = mq.raw()
                            else:
                                if mu[k]:
                                    cx = 16
                                else:
                                    hh, vv, dd = nbh(k, ci == 3)
                                    cx = 15 if hh + vv + dd else 14
                                v = mq.decode(cx)
                            val[k] += half if (v ^ (val[k] < 0)) else -half
                            mu[k] = 1
            else:  # cleanup
                for y0, n in stripes:
                    for x in range(w):
                        ci = 0
                        if n == 4:
                            ks = [(y0 + r + 1) * W + x + 1 for r in range(4)]
                            empty = True
                            for r in range(4):
                                k = ks[r]
                                if sig[k] or pi[k] or sum(nbh(k, r == 3)):
                                    empty = False
                                    break
                            if empty:
                                if not mq.decode(CTX_AGG):
                                    continue
                                ci = (mq.decode(CTX_UNI) << 1)
                                ci |= mq.decode(CTX_UNI)
                                k = ks[ci]
                                s = sign(k, ci == 3, mq.decode)
                                val[k] = -oph if s else oph
                                sig[k], neg[k] = 1, s
                                ci += 1
                        for r in range(ci, n):
                            k = (y0 + r + 1) * W + x + 1
                            if sig[k] or pi[k]:
                                continue
                            hh, vv, dd = nbh(k, r == 3)
                            if mq.decode(zc[hh][vv][dd]):
                                s = sign(k, r == 3, mq.decode)
                                val[k] = -oph if s else oph
                                sig[k], neg[k] = 1, s
                for k in range(size):
                    pi[k] = 0
                if style & SEGSYM:
                    for _ in range(4):
                        mq.decode(CTX_UNI)
            if (style & RESET) and not raw:
                _reset(st, mps)
            passtype += 1
            if passtype == 3:
                passtype = 0
                bpno -= 1
    out = np.array(val, np.int64).reshape(h + 2, W)[1:h + 1, 1:w + 1]
    if roishift >= 31:
        # OpenJPEG clears the block (it passes the bit-plane check above
        # where the block's numbps is negative).
        out = np.zeros_like(out)
    elif roishift:
        thresh = 1 << roishift
        mag = np.abs(out)
        shifted = np.where(mag >= thresh, mag >> roishift, mag)
        out = np.where(out < 0, -shifted, shifted)
    return out.astype(np.int32)


def _t1_blocks(data: bytes, table: np.ndarray, segs: np.ndarray,
               total: int) -> tuple:
    """Every code-block of a tile through ``t1_plain`` or its C++ twin:
    ``table`` rows (w, h, orient, style, numbps, roishift, first segment,
    segments, output offset); returns the int32 samples and a status (0,
    or 1 where OpenJPEG gives up)."""
    from wgpu_path_tracing_tpu_torch.accel import native

    if native.native_available():
        return native.j2k_t1_native(data, table, segs, total)
    out = np.zeros(total, np.int32)
    for row in table:
        w, h, orient, style, numbps, roi, s0, ns, off = (int(v) for v in row)
        got = t1_plain(data, w, h, orient, style, numbps, roi,
                       [tuple(int(v) for v in s) for s in segs[s0:s0 + ns]])
        if got is None:
            return out, 1
        out[off:off + w * h] = got.reshape(-1)
    return out, 0


# --- reconstruction -----------------------------------------------------------

K = np.float32(1.230174105)
TWO_INVK = np.float32(1.625732422)
# -delta, -gamma, -beta, -alpha of OpenJPEG's 9/7 lifting.
LIFT = (np.float32(-0.443506852), np.float32(-0.882911075),
        np.float32(0.052980118), np.float32(1.586134342))


def _ax(a: np.ndarray, axis: int, s) -> np.ndarray:
    return a[s] if axis == 0 else a[:, s]


def _step97(w: np.ndarray, l: np.ndarray, c: np.float32, ahead: int,
            axis: int) -> None:
    """One of OpenJPEG's ``opj_v8dwt_decode_step2``: w[i] += (l[i - 1] +
    l[i]) * c (``ahead`` 0) or (l[i] + l[i + 1]) * c (``ahead`` 1) along
    ``axis``, the missing neighbour at either end mirrored (OpenJPEG's
    c + c times the one neighbour is the same float)."""
    n, m = w.shape[axis], l.shape[axis]
    if n == 0 or m == 0:
        return
    if ahead == 0:
        t = _ax(l, axis, slice(0, 1)) + _ax(l, axis, slice(0, 1))
        t *= c
        _ax(w, axis, slice(0, 1))[...] += t
        k = min(n, m)
        if k > 1:
            t = _ax(l, axis, slice(0, k - 1)) + _ax(l, axis, slice(1, k))
            t *= c
            _ax(w, axis, slice(1, k))[...] += t
        if n > m:
            t = _ax(l, axis, slice(m - 1, m)) + _ax(l, axis, slice(m - 1, m))
            t *= c
            _ax(w, axis, slice(m, m + 1))[...] += t
    else:
        k = min(n, m - 1)
        if k > 0:
            t = _ax(l, axis, slice(0, k)) + _ax(l, axis, slice(1, k + 1))
            t *= c
            _ax(w, axis, slice(0, k))[...] += t
        if n > k:
            t = _ax(l, axis, slice(k, k + 1)) + _ax(l, axis, slice(k, k + 1))
            t *= c
            _ax(w, axis, slice(k, k + 1))[...] += t


def _lift97(low: np.ndarray, high: np.ndarray, cas: int, axis: int) -> None:
    """OpenJPEG's ``opj_v8dwt_decode`` along ``axis`` of the low and high
    halves, in place, float32 operation for operation."""
    sn, dn = low.shape[axis], high.shape[axis]
    if cas == 0 and not (dn > 0 or sn > 1):
        return
    if cas == 1 and not (sn > 0 or dn > 1):
        return
    low *= K
    high *= TWO_INVK
    la, ha = (0, 1) if cas == 0 else (1, 0)
    _step97(low, high, LIFT[0], la, axis)
    _step97(high, low, LIFT[1], ha, axis)
    _step97(low, high, LIFT[2], la, axis)
    _step97(high, low, LIFT[3], ha, axis)


def _lift53(low: np.ndarray, high: np.ndarray, cas: int,
            axis: int) -> tuple:
    """OpenJPEG's 5/3 synthesis along ``axis`` -> the even and odd
    samples (int32, wrapping as its int arithmetic does)."""
    sn, dn = low.shape[axis], high.shape[axis]
    n = sn + dn

    def sl(a, i, j):
        return _ax(a, axis, slice(i, j))

    if cas == 0:
        if n == 1:
            return low, high
        # even[i] = low[i] - ((high[i-1] + high[i] + 2) >> 2), mirrored.
        even = np.empty_like(low)
        sl(even, 0, 1)[...] = sl(low, 0, 1) - ((sl(high, 0, 1) * 2 + 2) >> 2)
        k = min(sn, dn)
        if k > 1:
            sl(even, 1, k)[...] = sl(low, 1, k) - (
                (sl(high, 0, k - 1) + sl(high, 1, k) + 2) >> 2)
        if sn > dn:
            sl(even, dn, dn + 1)[...] = sl(low, dn, dn + 1) - (
                (sl(high, dn - 1, dn) * 2 + 2) >> 2)
        # odd[i] = high[i] + ((even[i] + even[i+1]) >> 1), mirrored.
        odd = np.empty_like(high)
        k = min(dn, sn - 1)
        if k > 0:
            sl(odd, 0, k)[...] = sl(high, 0, k) + (
                (sl(even, 0, k) + sl(even, 1, k + 1)) >> 1)
        if dn > k:
            sl(odd, k, k + 1)[...] = sl(high, k, k + 1) + sl(even, k, k + 1)
        return even, odd
    if n == 1:
        return np.where(high < 0, -((-high) >> 1), high >> 1), low
    # the lows (odd positions) first, then the highs.
    odd = np.empty_like(low)
    k = min(sn, dn - 1)
    if k > 0:
        sl(odd, 0, k)[...] = sl(low, 0, k) - (
            (sl(high, 0, k) + sl(high, 1, k + 1) + 2) >> 2)
    if sn > k:
        sl(odd, k, k + 1)[...] = sl(low, k, k + 1) - (
            (sl(high, k, k + 1) * 2 + 2) >> 2)
    even = np.empty_like(high)
    sl(even, 0, 1)[...] = sl(high, 0, 1) + sl(odd, 0, 1)
    k = min(dn, sn)
    if k > 1:
        sl(even, 1, k)[...] = sl(high, 1, k) + (
            (sl(odd, 0, k - 1) + sl(odd, 1, k)) >> 1)
    if dn > sn:
        sl(even, sn, sn + 1)[...] = sl(high, sn, sn + 1) + sl(odd, sn - 1, sn)
    return even, odd


def _idwt(a: np.ndarray, comp: dict, reversible: bool) -> np.ndarray:
    """The inverse DWT of a tile-component laid out as OpenJPEG lays it
    (each level's low band top left), level by level, rows then columns."""
    ress = comp["res"]
    for r in range(1, len(ress)):
        prev, res = ress[r - 1], ress[r]
        sw, sh = prev.x1 - prev.x0, prev.y1 - prev.y0
        rw, rh = res.x1 - res.x0, res.y1 - res.y0
        if not rw or not rh:
            continue
        for axis, (sn, n, cas) in ((1, (sw, rw, res.x0 & 1)),
                                   (0, (sh, rh, res.y0 & 1))):
            part = a[:rh, :rw]
            low = _ax(part, axis, slice(0, sn)).copy()
            high = _ax(part, axis, slice(sn, n)).copy()
            if reversible:
                even, odd = _lift53(low, high, cas, axis)
            else:
                _lift97(low, high, cas, axis)
                even, odd = (low, high) if cas == 0 else (high, low)
            _ax(part, axis, slice(0, n, 2))[...] = even
            _ax(part, axis, slice(1, n, 2))[...] = odd
    return a


def _decode_tile(cs: _Codestream, tcp: _Tcp, index: int, ppm: list) -> tuple:
    """One tile -> (tile rectangle, [int32 (h, w) per component])."""
    tile = _tile_geometry(cs, tcp, index)
    _read_packets(cs, tcp, tile, ppm)
    # Gather the code-blocks for tier 1.
    rows, segrows, chunks, places = [], [], [], []
    dpos = 0
    total = 0
    for c, comp in enumerate(tile["comps"]):
        tc = comp["tc"]
        for r, res in enumerate(comp["res"]):
            for b, band in enumerate(res.bands):
                for prec in band.precincts:
                    for blk in prec[2]:
                        w, h = blk.x1 - blk.x0, blk.y1 - blk.y0
                        if w <= 0 or h <= 0 or not blk.segs:
                            continue
                        first = len(segrows)
                        start = dpos
                        blob = b"".join(blk.chunks)
                        chunks.append(blob)
                        for seg in blk.segs:
                            if seg[1] == 0 and seg[2] == 0:
                                continue
                            segrows.append((start, seg[2], seg[1]))
                            start += seg[2]
                        dpos += len(blob)
                        rows.append((w, h, band.orient, tc.cblksty,
                                     blk.numbps if blk.numbps < 1 << 31
                                     else blk.numbps - (1 << 32),
                                     tc.roishift, first,
                                     len(segrows) - first, total))
                        places.append((c, r, b, blk))
                        total += w * h
    table = np.array(rows, np.int64).reshape(-1, 9)
    segs = np.array(segrows, np.int64).reshape(-1, 3)
    samples, status = _t1_blocks(b"".join(chunks), table, segs, total)
    if status:
        raise _Broken("a code-block OpenJPEG does not decode")
    # Dequantise: the reversible path halves (C's division, to zero), the
    # irreversible one multiplies by half the band's step in float32.
    sizes = table[:, 0] * table[:, 1]
    rev = np.array([tile["comps"][c]["tc"].qmfbid == 1
                    for c, _, _, _ in places], bool)
    steps = np.array([tile["comps"][c]["res"][r].bands[b].stepsize
                      for c, r, b, _ in places], np.float32)
    halved = scaled = None
    if rev.any():
        halved = np.where(samples < 0, -((-samples) >> 1), samples >> 1)
    if not rev.all():
        scaled = samples.astype(np.float32) * np.repeat(
            np.float32(0.5) * steps, sizes)
    out = []
    for c, comp in enumerate(tile["comps"]):
        w = comp["x1"] - comp["x0"]
        h = comp["y1"] - comp["y0"]
        reversible = comp["tc"].qmfbid == 1
        out.append(np.zeros((max(h, 0), max(w, 0)),
                            np.int32 if reversible else np.float32))
    for i, ((c, r, b, blk), row) in enumerate(zip(places, rows)):
        comp = tile["comps"][c]
        band = comp["res"][r].bands[b]
        w, h, off = row[0], row[1], row[8]
        x = blk.x0 - band.x0
        y = blk.y0 - band.y0
        if band.orient & 1:
            pr = comp["res"][r - 1]
            x += pr.x1 - pr.x0
        if band.orient & 2:
            pr = comp["res"][r - 1]
            y += pr.y1 - pr.y0
        src = halved if rev[i] else scaled
        out[c][y:y + h, x:x + w] = src[off:off + w * h].reshape(h, w)
    for c, comp in enumerate(tile["comps"]):
        if out[c].size:
            _idwt(out[c], comp, comp["tc"].qmfbid == 1)
    # The component transform.
    if tcp.mct == 1 and cs.nc >= 3:
        s = [out[i].shape for i in range(3)]
        if s[0] == s[1] == s[2]:
            q = [tile["comps"][i]["tc"].qmfbid for i in range(3)]
            if q[0] != q[1] or q[0] != q[2]:
                raise _Unsupported("a component transform over components "
                                   "of different wavelets")
            if q[0] == 1:
                y, u, v = out[0], out[1], out[2]
                g = y - ((u + v) >> 2)
                out[0], out[1], out[2] = v + g, g, u + g
            else:
                y, u, v = out[0], out[1], out[2]
                r = y + v * np.float32(1.402)
                g = y - u * np.float32(0.34413)
                g = g - v * np.float32(0.71414)
                b = y + u * np.float32(1.772)
                out[0], out[1], out[2] = r, g, b
    # Level shift, rounding and clamp.
    final = []
    for c, comp in enumerate(tile["comps"]):
        prec, sgnd = cs.prec[c], cs.sgnd[c]
        lo = -(1 << (prec - 1)) if sgnd else 0
        hi = (1 << (prec - 1)) - 1 if sgnd else (1 << prec) - 1
        shift = 0 if sgnd else 1 << (prec - 1)
        if tcp.dc_shift is not None:
            shift = tcp.dc_shift[c]
        a = out[c]
        if comp["tc"].qmfbid == 1:
            v = np.clip(a + np.int32(shift), lo, hi)
        else:
            with np.errstate(invalid="ignore"):
                v = np.clip(np.rint(a).astype(np.float64) + shift, lo, hi)
                v = np.where(np.isnan(v), lo, v)
            v = v.astype(np.int32)
        final.append(v.astype(np.int32, copy=False))
    return tile, final


def _offset_int32(v) -> int:
    """An MCT offset as OpenJPEG reads it into an int32: a 16- or 32-bit
    unsigned value cast, a float truncated (C's conversion)."""
    if isinstance(v, float):
        if v != v or abs(v) >= 2 ** 63:
            return -(2 ** 31)  # x86's conversion of what does not fit
        v = int(v)
    return ((v + 2 ** 31) % 2 ** 32) - 2 ** 31


# --- Pillow's unpackers ---------------------------------------------------------

# (mode, colour space, components) -> (unpacker, subsampling allowed); the
# colour spaces: 0 unspecified, 1 sRGB, 2 gray, 3 sYCC, 4 eYCC, 5 CMYK.
UNPACKERS = {
    ("L", 2, 1): ("gray_l", False), ("P", 1, 1): ("gray_l", False),
    ("PA", 1, 2): ("graya_la", False), ("I;16", 2, 1): ("gray_i", False),
    ("LA", 2, 2): ("graya_la", False), ("RGB", 2, 1): ("gray_rgb", False),
    ("RGB", 2, 2): ("gray_rgb", False), ("RGB", 1, 3): ("srgb_rgb", True),
    ("RGB", 3, 3): ("sycc_rgb", True), ("RGB", 1, 4): ("srgb_rgb", True),
    ("RGB", 3, 4): ("sycc_rgb", True), ("RGBA", 2, 1): ("gray_rgb", False),
    ("RGBA", 2, 2): ("graya_la", False), ("RGBA", 1, 3): ("srgb_rgb", True),
    ("RGBA", 3, 3): ("sycc_rgb", True), ("RGBA", 1, 4): ("srgba_rgba", True),
    ("RGBA", 3, 4): ("sycca_rgba", True), ("CMYK", 5, 4): ("srgba_rgba", True),
    ("RGBA", 2, 4): ("srgba_rgba", True),
}


def _csiz(prec: int) -> int:
    n = (prec + 7) >> 3
    return 4 if n == 3 else n


def _shift(x: np.ndarray, n: int) -> np.ndarray:
    """Pillow's ``j2ku_shift`` on unsigned 32-bit words."""
    return x >> np.uint32(-n) if n < 0 else x << np.uint32(n)


class _Canvas:
    """Pillow's image of the mode being decoded, 4 bytes a pixel ("L",
    "P" and "I;16" use band 0)."""

    def __init__(self, mode: str, w: int, h: int) -> None:
        self.mode = mode
        self.px = np.zeros((h, w, 4), np.uint16)


def _pack(cs: _Codestream, comps: list, tw: int, th: int) -> np.ndarray:
    """The tile buffer OpenJPEG fills: each component's samples truncated
    to 1, 2 or 4 bytes, one component after another, in a zeroed buffer of
    the larger of that and w * h * the sample sizes (Pillow's; what its
    unpackers read past the samples is zero, found by test)."""
    parts = []
    for c, a in enumerate(comps):
        size = _csiz(cs.prec[c])
        dt = {1: np.uint8, 2: "<u2", 4: "<u4"}[size]
        parts.append(a.view(np.uint32).astype(dt).reshape(-1)
                     .view(np.uint8))
    data = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
    buf = np.zeros(max(len(data), tw * th * sum(_csiz(p) for p in cs.prec)),
                   np.uint8)
    buf[:len(data)] = data
    return buf


def _words(buf: np.ndarray, start: int, idx: np.ndarray, size: int):
    """Little-endian words of ``size`` bytes at byte ``start + size *
    idx``."""
    at = start + size * idx
    v = buf[at].astype(np.uint32)
    for k in range(1, size):
        v |= buf[at + k].astype(np.uint32) << np.uint32(8 * k)
    return v


def _unpack(cs: _Codestream, tile: dict, comps: list, canvas: _Canvas,
            name: str, colour: int) -> None:
    key = (canvas.mode, colour, cs.nc)
    if key not in UNPACKERS:
        raise _Broken("no unpacker for this mode and colour space")
    kind, subsampling = UNPACKERS[key]
    if not subsampling and any(d != 1 for d in cs.dx + cs.dy):
        raise _Broken("subsampled components")
    x0, y0 = tile["x0"] - cs.x0, tile["y0"] - cs.y0
    w, h = tile["x1"] - tile["x0"], tile["y1"] - tile["y0"]
    if (w <= 0 or h <= 0 or x0 + w > canvas.px.shape[1]
            or y0 + h > canvas.px.shape[0]):
        raise _Broken("tile outside the image")
    plain = all(d == 1 for d in cs.dx + cs.dy)
    buf = None if plain else _pack(cs, comps, w, h)

    def word(c, start, idx, size):
        """Pillow's read of component c (at byte ``start`` of the tile
        buffer): without subsampling, the component's own samples."""
        if plain:
            v = comps[c].view(np.uint32)
            return v if size == 4 else v & np.uint32((1 << (8 * size)) - 1)
        return _words(buf, start, idx, size)

    def params(c):
        prec = cs.prec[c]
        shift = (16 if kind == "gray_i" else 8) - prec
        off = (1 << (prec - 1)) if cs.sgnd[c] else 0
        if shift < 0:
            off += 1 << (-shift - 1)
        return shift, np.uint32(off), _csiz(prec)

    ys = np.arange(h)[:, None]
    xs = np.arange(w)[None, :]
    dst = canvas.px[y0:y0 + h, x0:x0 + w]
    if kind in ("gray_l", "gray_i", "gray_rgb"):
        shift, off, size = params(0)
        v = _shift(off + word(0, 0, ys * w + xs, size), shift)
        v = v & np.uint32(0xFFFF if kind == "gray_i" else 0xFF)
        if kind == "gray_rgb":
            # Pillow's gray-to-RGB unpacker starts a tile's row x0 bytes,
            # not pixels, into the image's row (found by test).
            quad = np.repeat(v[..., None], 4, -1)
            quad[..., 3] = 255
            rows = canvas.px.reshape(canvas.px.shape[0], -1)
            rows[y0:y0 + h, x0:x0 + 4 * w] = quad.reshape(h, 4 * w)
            return
        dst[..., 0] = v
        dst[..., 1] = v
        dst[..., 2] = v
        dst[..., 3] = 255
    elif kind == "graya_la":
        shift, off, size = params(0)
        ashift, aoff, asize = params(1)
        v = _shift(off + word(0, 0, ys * w + xs, size), shift) & 0xFF
        a = _shift(aoff + word(1, size * w * h, ys * w + xs, asize),
                   ashift) & np.uint32(0xFF)
        dst[..., 0] = v
        dst[..., 1] = v
        dst[..., 2] = v
        dst[..., 3] = a
    else:
        n = 3 if kind in ("srgb_rgb", "sycc_rgb") else 4
        start = 0
        for c in range(n):
            shift, off, size = params(c)
            dx, dy = cs.dx[c], cs.dy[c]
            idx = (ys // dy) * (w // dx) + xs // dx
            dst[..., c] = _shift(off + word(c, start, idx, size),
                                 shift) & np.uint32(0xFF)
            start += size * (w // dx) * (h // dy)
        if n == 3:
            dst[..., 3] = 255
        if kind in ("sycc_rgb", "sycca_rgba"):
            from wgpu_path_tracing_tpu_torch.utils.pilmodes import ycbcr_to_rgb

            dst[..., :3] = ycbcr_to_rgb(dst[..., :3].astype(np.uint8))


def _to_rgba(canvas: _Canvas, palette) -> np.ndarray:
    from wgpu_path_tracing_tpu_torch.utils.jpeg import pillow_cmyk_to_rgb

    px = canvas.px
    mode = canvas.mode
    out = np.empty(px.shape[:2] + (4,), np.uint8)
    if mode == "I;16":
        v = np.minimum(px[..., 0], 255).astype(np.uint8)
        out[..., :3] = v[..., None]
        out[..., 3] = 255
    elif mode in ("L", "RGB"):
        out[..., :3] = px[..., :3]
        out[..., 3] = 255
    elif mode in ("LA", "RGBA"):
        out[...] = px
    elif mode == "CMYK":
        out[..., :3] = pillow_cmyk_to_rgb(px)
        out[..., 3] = 255
    else:  # P, PA
        out[...] = palette.rgba()[px[..., 0]]
        if mode == "PA":
            out[..., 3] = px[..., 3]
    return out


# --- JP2 ----------------------------------------------------------------------

def _jp2_codestream(data: bytes) -> tuple:
    """OpenJPEG's JP2 box walk -> (codestream bytes, colour space, the
    ihdr box's (width, height))."""
    pos = 0
    n = len(data)
    state = 0
    size = (0, 0)
    enumcs = None
    colour_seen = cmap_seen = cdef_seen = False
    npc = None
    have_ihdr = False
    while True:
        if pos + 8 > n:
            raise _Broken("no jp2c box")
        lbox = _u32(data, pos)
        tbox = data[pos + 4:pos + 8]
        hlen = 8
        if lbox == 1:
            if pos + 16 > n:
                raise _Broken("cannot handle box sizes higher than 2^32")
            lbox = struct.unpack_from(">Q", data, pos + 8)[0]
            hlen = 16
        elif lbox == 0:
            lbox = n - pos
        if lbox < hlen:
            raise _Broken("box length is inconsistent")
        body = data[pos + hlen:pos + lbox]
        if state == 0:
            if tbox != b"jP  ":
                raise _Broken("the signature box must be first")
            state = 1
        elif state == 1:
            if tbox != b"ftyp":
                raise _Broken("the ftyp box must be second")
            state = 2
        elif tbox == b"jp2h":
            at = 0
            while at + 8 <= len(body):
                sl = _u32(body, at)
                st = body[at + 4:at + 8]
                if sl < 8 or at + sl > len(body):
                    raise _Broken("bad box in the JP2 header")
                sb = body[at + 8:at + sl]
                if st == b"ihdr":
                    if len(sb) != 14 or not 1 <= _u16(sb, 8) <= 16384:
                        raise _Broken("bad ihdr box")
                    have_ihdr = True
                    size = (_u32(sb, 4), _u32(sb, 0))
                elif st == b"colr" and not colour_seen:
                    if len(sb) < 3:
                        raise _Broken("bad colr box")
                    colour_seen = True
                    if sb[0] == 1:
                        if len(sb) < 7:
                            raise _Broken("bad colr box")
                        enumcs = _u32(sb, 3)
                elif st == b"pclr":
                    if len(sb) < 3 or npc is not None:
                        raise _Broken("bad or second pclr box")
                    ne, npc = _u16(sb, 0), sb[2]
                    if ne == 0 or ne > 1024 or npc == 0:
                        raise _Broken("invalid pclr box")
                    widths = [min(((b & 0x7F) + 8) >> 3, 4)
                              for b in sb[3:3 + npc]]
                    if len(sb) < 3 + npc + ne * sum(widths):
                        raise _Broken("pclr box too short")
                elif st == b"cmap":
                    if npc is None or cmap_seen or len(sb) < 4 * npc:
                        raise _Broken("a cmap box before pclr, a second one "
                                      "or one too short")
                    cmap_seen = True
                elif st == b"cdef":
                    if (cdef_seen or len(sb) < 2 or _u16(sb, 0) == 0
                            or len(sb) < 2 + 6 * _u16(sb, 0)):
                        raise _Broken("a second or bad cdef box")
                    cdef_seen = True
                at += sl
            if not have_ihdr:
                raise _Broken("no ihdr box in jp2h")
            state = 3
        elif tbox == b"jp2c":
            if state != 3:
                raise _Broken("the jp2h box must come before jp2c")
            # An unknown or missing space is read as none named.
            colour = {16: 1, 17: 2, 18: 3, 24: 4, 12: 5}.get(enumcs, 0)
            return data[pos + hlen:pos + lbox], colour, size
        pos += lbox


# --- the reader ---------------------------------------------------------------


def decode_jpeg2000_rgba(data: bytes, name: str = "image") -> np.ndarray:
    """JPEG 2000 bytes (a J2K codestream or a JP2 file) -> (H, W, 4)
    uint8 RGBA, what Pillow's ``Image.open(...).convert("RGBA")``
    returns."""
    try:
        codec, size, mode, palette = open_header(data)
    except _PASS_ON as exc:
        raise NotThisFormat(f"{name}: {exc}") from None
    except Exception as exc:  # OSError, AssertionError, ValueError
        raise ValueError(f"{name}: {exc}") from None
    bomb_check(size[0], size[1], name)
    try:
        return _decode(data, codec, size, mode, palette, name)
    except _Broken:
        raise ValueError(f"{name}: {BROKEN}") from None
    except _Unsupported as exc:
        raise NotImplementedError(f"{name}: JPEG 2000 with {exc}, which "
                                  "this package does not read") from None


def _decode(data: bytes, codec: str, size: tuple, mode: str, palette,
            name: str) -> np.ndarray:
    if codec == "jp2":
        cs_bytes, colour, ihdr = _jp2_codestream(data)
    else:
        cs_bytes, colour, ihdr = data, 0, (0, 0)
    cs = _Codestream(cs_bytes)
    if ihdr[0] and ihdr[1] and ihdr != (cs.x1 - cs.x0, cs.y1 - cs.y0):
        raise _Broken("error with SIZ marker: IHDR vs. SIZ size")
    if cs.nc > 4:
        raise _Broken("more components than Pillow takes")
    if colour == 0:
        # A codestream names no colour space: three components or more,
        # the first not subsampled and the second or third subsampled,
        # read as sYCC; else one or two as gray and three or four as sRGB
        # (found by test).
        if (cs.nc >= 3 and (cs.dx[0], cs.dy[0]) == (1, 1)
                and any((cs.dx[i], cs.dy[i]) != (1, 1) for i in (1, 2))):
            colour = 3
        else:
            colour = 2 if cs.nc <= 2 else 1
    canvas = _Canvas(mode, size[0], size[1])
    ppm = [cs.ppm_data, 0] if cs.have_ppm else None
    for index in cs.order:
        tile, comps = _decode_tile(cs, cs.tcps[index], index, ppm)
        _unpack(cs, tile, comps, canvas, name, colour)
    return _to_rgba(canvas, palette)
