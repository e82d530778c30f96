"""Write JPEG 2000 files that Pillow's encoder cannot: through the encoder of
Pillow's own libopenjp2 (OpenJPEG 2.5.4), driven with ctypes, and by
rewriting the bytes of encoded files.

    python tools/j2k_fixtures.py [--check]

``opj_encode`` sets the fields of ``opj_cparameters_t`` that Pillow's
``save`` never sets: the code-block styles (BYPASS, RESET, TERMALL, VSC,
PTERM, SEGSYM), SOP and EPH markers, ROI max-shift, progression changes
(POC), tile-parts and per-component subsampling. No OpenJPEG header is
on the build host, so the offsets below were found black-box:
``opj_set_default_encoder_parameters`` zeroes 18720 bytes and writes
numresolution 6 and the 64 x 64 code-block at byte 5600, roi_compno -1 at
5620 and subsampling 1, 1 then -1, -1 at 18196, which fixes every offset
from the start of the struct (the 32 ``opj_poc_t`` of 148 bytes at 56) to
its end (``tp_on`` at 18696). ``--check`` prints those bytes and, for
each fixture, the markers that show it holds what was asked for (COD's
code-block style byte, SOP and EPH, RGN, POC, the tile-parts).

The rewrites (``with_ppt``, ``with_ppm``, ``split_tile_parts``,
``insert_markers``, ``jp2``) move packet headers into PPT or PPM marker
segments, cut a tile into tile-parts at packet boundaries, add COM and
CRG segments, and wrap a codestream in JP2 boxes (``pclr``/``cmap``,
``cdef``, ``colr``, ``res``); the packet boundaries come from
``utils/jpeg2000.py``'s tier-2 reader.
"""

from __future__ import annotations

import ctypes
import glob
import os
import struct
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

PARAMS_SIZE = 18720
OFF = {"tile_size_on": 0, "cp_tx0": 4, "cp_ty0": 8, "cp_tdx": 12,
       "cp_tdy": 16, "cp_disto_alloc": 20, "csty": 48, "prog_order": 52,
       "POC": 56, "numpocs": 4792, "tcp_numlayers": 4796,
       "tcp_rates": 4800, "numresolution": 5600, "cblockw_init": 5604,
       "cblockh_init": 5608, "mode": 5612, "irreversible": 5616,
       "roi_compno": 5620, "roi_shift": 5624, "res_spec": 5628,
       "prcw_init": 5632,
       "prch_init": 5764, "image_offset_x0": 18188,
       "subsampling_dx": 18196, "tp_on": 18696, "tp_flag": 18697,
       "tcp_mct": 18698}
POC_SIZE = 148
PROGRESSIONS = {"LRCP": 0, "RLCP": 1, "RPCL": 2, "PCRL": 3, "CPRL": 4}


def _lib() -> ctypes.CDLL:
    import PIL

    root = os.path.dirname(os.path.dirname(PIL.__file__))
    path = glob.glob(os.path.join(root, "pillow.libs", "libopenjp2-*"))[0]
    lib = ctypes.CDLL(path)
    lib.opj_create_compress.restype = ctypes.c_void_p
    lib.opj_image_create.restype = ctypes.c_void_p
    lib.opj_stream_create_default_file_stream.restype = ctypes.c_void_p
    for name in ("opj_setup_encoder", "opj_start_compress", "opj_encode",
                 "opj_end_compress", "opj_encoder_set_extra_options"):
        getattr(lib, name).restype = ctypes.c_int
    return lib


class _Cmpt(ctypes.Structure):
    _fields_ = [(n, ctypes.c_uint32) for n in
                ("dx", "dy", "w", "h", "x0", "y0", "prec", "bpp", "sgnd")]


class _Comp(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_uint32) for n in
                 ("dx", "dy", "w", "h", "x0", "y0", "prec", "bpp", "sgnd",
                  "resno_decoded", "factor")]
                + [("data", ctypes.POINTER(ctypes.c_int32)),
                   ("alpha", ctypes.c_uint16)])


class _Image(ctypes.Structure):
    _fields_ = [("x0", ctypes.c_uint32), ("y0", ctypes.c_uint32),
                ("x1", ctypes.c_uint32), ("y1", ctypes.c_uint32),
                ("numcomps", ctypes.c_uint32), ("color_space", ctypes.c_int),
                ("comps", ctypes.POINTER(_Comp))]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def opj_encode(planes: list, *, width: int, height: int, jp2: bool = False,
               dx=None, dy=None, prec: int = 8, sgnd: bool = False,
               origin=(0, 0), colour: int = 1, irreversible: bool = False,
               numres: int = 3, cblk=(64, 64), mode: int = 0, csty: int = 0,
               prog: str = "LRCP", rates=None, roi=None, pocs=(),
               tile=None, tile_origin=(0, 0), tp_flag: str | None = None,
               mct: int = 0, precincts=None, extra=()) -> bytes:
    """Encode ``planes`` (one 2-D int array per component, each at its
    subsampled size) with libopenjp2 -> the J2K (or JP2) bytes.
    ``pocs`` are (resno0, compno0, layno1, resno1, compno1, progression)
    of the first tile."""
    lib = _lib()
    n = len(planes)
    dx = dx or [1] * n
    dy = dy or [1] * n
    x0, y0 = origin
    x1, y1 = x0 + width, y0 + height
    cm = (_Cmpt * n)()
    for i in range(n):
        cm[i].dx, cm[i].dy = dx[i], dy[i]
        cm[i].x0, cm[i].y0 = _cdiv(x0, dx[i]), _cdiv(y0, dy[i])
        cm[i].w = _cdiv(x1, dx[i]) - cm[i].x0
        cm[i].h = _cdiv(y1, dy[i]) - cm[i].y0
        cm[i].prec = cm[i].bpp = prec
        cm[i].sgnd = int(sgnd)
        assert planes[i].shape == (cm[i].h, cm[i].w), (planes[i].shape,
                                                       cm[i].h, cm[i].w)
    img = ctypes.cast(lib.opj_image_create(n, cm, colour),
                      ctypes.POINTER(_Image))
    img.contents.x0, img.contents.y0 = x0, y0
    img.contents.x1, img.contents.y1 = x1, y1
    for i in range(n):
        flat = np.ascontiguousarray(planes[i], np.int32).reshape(-1)
        ctypes.memmove(img.contents.comps[i].data, flat.ctypes.data,
                       flat.nbytes)
    p = ctypes.create_string_buffer(PARAMS_SIZE)
    lib.opj_set_default_encoder_parameters(p)

    def put(name, value, fmt="<i", at=0):
        struct.pack_into(fmt, p, OFF[name] + at, value)

    put("numresolution", numres)
    put("cblockw_init", cblk[0])
    put("cblockh_init", cblk[1])
    put("mode", mode)
    put("irreversible", int(irreversible))
    put("csty", csty | (1 if precincts else 0))
    put("prog_order", PROGRESSIONS[prog])
    put("tcp_mct", mct, "<B")
    if precincts:
        put("res_spec", len(precincts))
        for i, (pw, ph) in enumerate(precincts):
            put("prcw_init", pw, at=4 * i)
            put("prch_init", ph, at=4 * i)
    layers = list(rates) if rates else [0.0]
    put("tcp_numlayers", len(layers))
    for i, r in enumerate(layers):
        put("tcp_rates", float(r), "<f", 4 * i)
    put("cp_disto_alloc", 1)
    if roi:
        put("roi_compno", roi[0])
        put("roi_shift", roi[1])
    if tile:
        put("tile_size_on", 1)
        put("cp_tx0", tile_origin[0])
        put("cp_ty0", tile_origin[1])
        put("cp_tdx", tile[0])
        put("cp_tdy", tile[1])
    if tp_flag:
        put("tp_on", 1, "<B")
        put("tp_flag", ord(tp_flag), "<B")
    for k, (r0, c0, l1, r1, c1, prg) in enumerate(pocs):
        base = OFF["POC"] + POC_SIZE * k
        struct.pack_into("<5I", p, base, r0, c0, l1, r1, c1)
        struct.pack_into("<i", p, base + 32, PROGRESSIONS[prg])
        struct.pack_into("<I", p, base + 48, 1)
    put("numpocs", len(pocs))
    codec = lib.opj_create_compress(2 if jp2 else 0)
    ok = lib.opj_setup_encoder(ctypes.c_void_p(codec), p, img)
    if extra:
        arr = (ctypes.c_char_p * (len(extra) + 1))(
            *[e.encode() for e in extra], None)
        ok = ok and lib.opj_encoder_set_extra_options(
            ctypes.c_void_p(codec), arr)
    if not ok:
        raise RuntimeError("opj_setup_encoder failed")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "out")
        stream = lib.opj_stream_create_default_file_stream(path.encode(), 0)
        ok = (lib.opj_start_compress(ctypes.c_void_p(codec), img,
                                     ctypes.c_void_p(stream))
              and lib.opj_encode(ctypes.c_void_p(codec),
                                 ctypes.c_void_p(stream))
              and lib.opj_end_compress(ctypes.c_void_p(codec),
                                       ctypes.c_void_p(stream)))
        lib.opj_stream_destroy(ctypes.c_void_p(stream))
        lib.opj_destroy_codec(ctypes.c_void_p(codec))
        lib.opj_image_destroy(img)
        if not ok:
            raise RuntimeError("opj_encode failed")
        with open(path, "rb") as f:
            return f.read()


# --- codestream surgery -------------------------------------------------------


def markers(cs: bytes) -> list:
    """[(marker, offset, segment bytes)] of the main and tile-part
    headers (the data after each SOD skipped by its tile-part's Psot)."""
    out = []
    pos = 2
    out.append((0xFF4F, 0, b""))
    tile_start = None
    while pos + 2 <= len(cs):
        m = struct.unpack_from(">H", cs, pos)[0]
        if m == 0xFFD9:
            out.append((m, pos, b""))
            break
        if m == 0xFF93:
            out.append((m, pos, b""))
            psot = struct.unpack_from(">I", cs, tile_start + 6)[0]
            pos = tile_start + psot if psot else len(cs) - 2
            continue
        n = struct.unpack_from(">H", cs, pos + 2)[0]
        if m == 0xFF90:
            tile_start = pos
        out.append((m, pos, cs[pos + 4:pos + 2 + n]))
        pos += 2 + n
    return out


def segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">HH", marker, len(body) + 2) + body


def _single_tile(cs: bytes) -> tuple:
    """(main header, tile-part header markers, tile data, packet spans) of
    a one-tile, one-tile-part codestream."""
    from wgpu_path_tracing_tpu_torch.utils import jpeg2000 as J

    c = J._Codestream(cs)
    assert len(c.tcps) == 1 and len(c.tcps[0].data) == 1
    tcp = c.tcps[0]
    main = cs[:c.main_end]
    sot = c.main_end
    pos = sot + 12
    hdr = b""
    while struct.unpack_from(">H", cs, pos)[0] != 0xFF93:
        n = struct.unpack_from(">H", cs, pos + 2)[0]
        hdr += cs[pos:pos + 2 + n]
        pos += 2 + n
    data = tcp.data[0]
    tile = J._tile_geometry(c, tcp, 0)
    spans = []
    J._read_packets(c, tcp, tile, None, spans)
    return main, hdr, data, spans


def _sot(index: int, psot: int, part: int, parts: int) -> bytes:
    return segment(0xFF90, struct.pack(">HIBB", index, psot, part, parts))


def split_tile_parts(cs: bytes, cuts: int, tnsot: bool = True) -> bytes:
    """The one tile cut into ``cuts`` tile-parts at packet boundaries."""
    main, hdr, data, spans = _single_tile(cs)
    bounds = [spans[int(round(i * len(spans) / cuts))][0]
              for i in range(cuts)] + [len(data)]
    out = main
    for k in range(cuts):
        body = data[bounds[k]:bounds[k + 1]]
        h = hdr if k == 0 else b""
        psot = 12 + len(h) + 2 + len(body)
        out += _sot(0, psot, k, cuts if tnsot else 0) + h + b"\xff\x93" + body
    return out + b"\xff\xd9"


def with_ppt(cs: bytes, parts: int = 1, repeat_z: bool = False) -> bytes:
    """Every packet header moved into PPT segments (of at most 200 bytes
    each, to have several Zppt), in ``parts`` tile-parts; their Zppt count
    on from part to part, or (``repeat_z``, which OpenJPEG refuses) start
    again at 0 in each."""
    main, hdr, data, spans = _single_tile(cs)
    bounds = [int(round(i * len(spans) / parts)) for i in range(parts + 1)]
    out = main
    z0 = 0
    for k in range(parts):
        sp = spans[bounds[k]:bounds[k + 1]]
        heads = b"".join(data[s:h] for s, h, _ in sp)
        body = b"".join(data[h:e] for _, h, e in sp)
        starts = range(0, max(len(heads), 1), 200)
        ppt = b"".join(segment(0xFF61, bytes([z0 + z]) + heads[i:i + 200])
                       for z, i in enumerate(starts))
        z0 = 0 if repeat_z else z0 + len(starts)
        h = (hdr if k == 0 else b"") + ppt
        psot = 12 + len(h) + 2 + len(body)
        out += _sot(0, psot, k, parts) + h + b"\xff\x93" + body
    return out + b"\xff\xd9"


def with_ppm(cs: bytes, parts: int = 2) -> bytes:
    """Every packet header moved into the main header's PPM segments, in
    ``parts`` tile-parts (an Nppm for each), split across two Zppm."""
    main, hdr, data, spans = _single_tile(cs)
    bounds = [int(round(i * len(spans) / parts)) for i in range(parts + 1)]
    ippm = b""
    tail = b""
    for k in range(parts):
        sp = spans[bounds[k]:bounds[k + 1]]
        heads = b"".join(data[s:h] for s, h, _ in sp)
        ippm += struct.pack(">I", len(heads)) + heads
        body = b"".join(data[h:e] for _, h, e in sp)
        h = hdr if k == 0 else b""
        tail += (_sot(0, 12 + len(h) + 2 + len(body), k, parts) + h
                 + b"\xff\x93" + body)
    half = len(ippm) // 2
    ppm = (segment(0xFF60, b"\x00" + ippm[:half])
           + segment(0xFF60, b"\x01" + ippm[half:]))
    return main + ppm + tail + b"\xff\xd9"


def insert_markers(cs: bytes, extra: bytes) -> bytes:
    """``extra`` marker segments at the end of the main header."""
    first_sot = next(off for m, off, _ in markers(cs) if m == 0xFF90)
    return cs[:first_sot] + extra + cs[first_sot:]


def with_sop(cs: bytes, eph: bool = False) -> bytes:
    """SOP before each packet (and EPH after each header), COD's Scod
    telling so."""
    main, hdr, data, spans = _single_tile(cs)
    cod = next(off for m, off, _ in markers(cs) if m == 0xFF52)
    main = bytearray(main)
    main[cod + 4] |= 2 | (4 if eph else 0)
    body = b""
    for k, (s, h, e) in enumerate(spans):
        body += segment(0xFF91, struct.pack(">H", k & 0xFFFF))
        body += data[s:h] + (b"\xff\x92" if eph else b"") + data[h:e]
    return (bytes(main) + _sot(0, 12 + len(hdr) + 2 + len(body), 0, 1) + hdr
            + b"\xff\x93" + body + b"\xff\xd9")


# --- JP2 boxes ----------------------------------------------------------------


def box(kind: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", 8 + len(payload)) + kind + payload


def ihdr(w: int, h: int, nc: int, bpc: int) -> bytes:
    return box(b"ihdr", struct.pack(">IIHBBBB", h, w, nc, bpc, 7, 0, 0))


def colr(enumcs: int) -> bytes:
    return box(b"colr", struct.pack(">BBBI", 1, 0, 0, enumcs))


def pclr(entries: np.ndarray, depth: int = 8) -> bytes:
    ne, npc = entries.shape
    return box(b"pclr", struct.pack(">HB", ne, npc)
               + bytes([depth - 1] * npc) + entries.astype(np.uint8).tobytes())


def cmap(channels: list) -> bytes:
    return box(b"cmap", b"".join(struct.pack(">HBB", c, t, p)
                                 for c, t, p in channels))


def cdef(defs: list) -> bytes:
    return box(b"cdef", struct.pack(">H", len(defs)) + b"".join(
        struct.pack(">HHH", *d) for d in defs))


def res(num: int = 3, den: int = 1, exp: int = 4) -> bytes:
    return box(b"res ", box(b"resc", struct.pack(">HHHHBB", num, den, num,
                                                 den, exp, exp)))


def jp2(cs: bytes, header: bytes) -> bytes:
    """A JP2 file: signature, ftyp, a jp2h of ``header`` boxes, jp2c."""
    return (box(b"jP  ", b"\r\n\x87\n")
            + box(b"ftyp", b"jp2 " + bytes(4) + b"jp2 ")
            + box(b"jp2h", header) + box(b"jp2c", cs))


# --- the fixtures ---------------------------------------------------------------


def _planes(rgba: np.ndarray, n: int) -> list:
    return [rgba[..., i].astype(np.int32) for i in range(n)]


def fixtures() -> dict:
    """{file name: bytes} of the JPEG 2000 files under ``tests/ldr`` that
    Pillow's ``save`` cannot write."""
    from tests.torch_image_cases import sample_image

    rgb = sample_image(29, 23, 41, 3)
    out = {}
    wh = {"width": 29, "height": 23}
    for name, mode in (("bypass", 1), ("reset", 2), ("termall", 4),
                       ("vsc", 8), ("pterm", 16), ("segsym", 32),
                       ("all_styles", 63), ("bypass_termall", 5)):
        for irr in (False, True):
            out[f"cblk_{name}_{'irr' if irr else 'rev'}.j2k"] = opj_encode(
                _planes(rgb, 3), **wh, mode=mode, irreversible=irr,
                cblk=(16, 8), rates=[30, 8, 2], numres=3)
    out["sop_eph.j2k"] = opj_encode(_planes(rgb, 3), **wh, csty=6,
                                    rates=[20, 4], numres=3, cblk=(8, 8))
    out["roi_shift.j2k"] = opj_encode(_planes(rgb, 3), **wh, roi=(0, 7),
                                      rates=[20], numres=3)
    out["roi_irr.j2k"] = opj_encode(_planes(rgb, 3), **wh, roi=(1, 5),
                                    irreversible=True, numres=4)
    out["poc.j2k"] = opj_encode(
        _planes(rgb, 3), **wh, rates=[30, 10, 3], numres=4,
        prog="LRCP", pocs=[(0, 0, 2, 2, 3, "RLCP"), (0, 0, 3, 4, 3, "CPRL")],
        precincts=[(16, 16)] * 4)
    out["tile_parts_r.j2k"] = opj_encode(
        _planes(rgb, 3), **wh, tile=(16, 12), tile_origin=(0, 0),
        tp_flag="R", numres=3, rates=[20, 5])
    out["tile_parts_c.j2k"] = opj_encode(
        _planes(rgb, 3), **wh, tile=(16, 12), tp_flag="C", numres=3)
    # Subsampled chroma: 4:2:0 and 4:2:2 of the sample's channels.
    y = rgb[..., 0].astype(np.int32)
    cb = rgb[::2, ::2, 1].astype(np.int32)
    cr = rgb[::2, ::2, 2].astype(np.int32)
    out["sub_420.j2k"] = opj_encode([y, cb, cr], width=29, height=23,
                                    dx=[1, 2, 2], dy=[1, 2, 2], numres=3)
    out["sub_422_offset.jp2"] = opj_encode(
        [rgb[1:, :28, 0].astype(np.int32),
         rgb[1:, :28:2, 1].astype(np.int32),
         rgb[1:, :28:2, 2].astype(np.int32)],
        width=28, height=22, origin=(2, 1), dx=[1, 2, 2], dy=[1, 1, 1],
        numres=2, jp2=True)
    # Precision and sign.
    out["gray12.j2k"] = opj_encode(
        [(rgb[..., 0].astype(np.int32) * 16 + 7)], **wh, prec=12,
        colour=2, rates=[10, 2])
    out["gray4.j2k"] = opj_encode([rgb[..., 1].astype(np.int32) >> 4],
                                  **wh, prec=4, colour=2)
    out["signed12_rgb.j2k"] = opj_encode(
        [rgb[..., i].astype(np.int32) * 16 - 2048 for i in range(3)], **wh,
        prec=12, sgnd=True, irreversible=True)
    out["gray16.jp2"] = opj_encode(
        [rgb[..., 2].astype(np.int32) * 257], **wh, prec=16, colour=2,
        jp2=True)
    # Rewrites of a Pillow-like one-tile codestream.
    base = opj_encode(_planes(rgb, 3), **wh, rates=[25, 6, 2], numres=3,
                      cblk=(8, 8), precincts=[(8, 8), (8, 8), (16, 16)])
    out["ppt.j2k"] = with_ppt(base, 1)
    out["ppt_parts.j2k"] = with_ppt(base, 3)
    out["ppm.j2k"] = with_ppm(base, 3)
    out["parts_no_tnsot.j2k"] = split_tile_parts(base, 4, tnsot=False)
    out["parts_packets.j2k"] = split_tile_parts(base, 5)
    out["sop_rewrite.j2k"] = with_sop(base, eph=True)
    crg = segment(0xFF63, struct.pack(">6H", 0, 0, 100, 200, 3, 4))
    com = segment(0xFF64, struct.pack(">H", 1) + b"written by a test")
    out["com_crg_tlm.j2k"] = insert_markers(
        opj_encode(_planes(rgb, 3), **wh, numres=3, tile=(16, 16),
                   extra=("TLM=YES", "PLT=YES")), crg + com)
    # JP2 boxes over codestreams.
    gray = sample_image(29, 23, 42, 1)[..., 0]
    idx = (gray >> 3).astype(np.int32)
    pal = sample_image(32, 1, 43, 3)[0]
    pal[5] = pal[3]   # a repeated colour (Pillow's getcolor merges it)
    cs_idx = opj_encode([idx], **wh, prec=8, colour=1)
    out["pclr_cmap.jp2"] = jp2(cs_idx, ihdr(29, 23, 1, 7) + colr(16)
                               + pclr(pal) + cmap([(0, 1, i) for i in
                                                   range(3)]))
    pal4 = np.concatenate([pal, np.arange(32, dtype=np.uint8)[:, None] * 8],
                          1)
    cs_idx_a = opj_encode([idx, gray.astype(np.int32)], **wh, colour=1)
    out["pclr_rgba_pa.jp2"] = jp2(cs_idx_a, ihdr(29, 23, 2, 7) + colr(16)
                                  + pclr(pal4) + cmap([(0, 1, i) for i in
                                                       range(4)]))
    rgba = sample_image(29, 23, 44, 4)
    cs4 = opj_encode(_planes(rgba, 4), **wh, colour=1)
    out["cdef_swapped.jp2"] = jp2(cs4, ihdr(29, 23, 4, 7) + colr(16)
                                  + cdef([(0, 0, 3), (1, 0, 2), (2, 0, 1),
                                          (3, 1, 0)]))
    out["cmyk.jp2"] = jp2(cs4, ihdr(29, 23, 4, 7) + colr(12))
    out["sycc.jp2"] = jp2(opj_encode(_planes(rgb, 3), **wh, colour=3),
                          ihdr(29, 23, 3, 7) + colr(18))
    out["sycc_alpha.jp2"] = jp2(cs4, ihdr(29, 23, 4, 7) + colr(18))
    out["gray_enumcs17_res.jp2"] = jp2(
        opj_encode([gray.astype(np.int32)], **wh, colour=2),
        ihdr(29, 23, 1, 7) + colr(17) + res())
    return out


def check() -> None:
    from wgpu_path_tracing_tpu_torch.utils import jpeg2000 as J

    lib = _lib()
    p = ctypes.create_string_buffer(b"\xab" * 65536, 65536)
    lib.opj_set_default_encoder_parameters(p)
    raw = p.raw
    print("bytes zeroed:", max(i for i in range(65536) if raw[i] != 0xAB) + 1)
    print("numresolution, cblockw, cblockh:",
          struct.unpack_from("<3i", raw, OFF["numresolution"]),
          "roi_compno:", struct.unpack_from("<i", raw, OFF["roi_compno"]),
          "subsampling, formats:",
          struct.unpack_from("<4i", raw, OFF["subsampling_dx"]))
    for name, data in sorted(fixtures().items()):
        cs = data if data.startswith(J.J2K_SIG) else J._jp2_codestream(data)[0]
        ms = markers(cs)
        cod = next(b for m, _, b in ms if m == 0xFF52)
        parts = [struct.unpack(">HIBB", b) for m, _, b in ms if m == 0xFF90]
        kinds = sorted({f"{m:04X}" for m, _, _ in ms})
        print(f"{name}: {len(data)} bytes, Scod {cod[0]:#x}, prog {cod[1]}, "
              f"layers {struct.unpack_from('>H', cod, 2)[0]}, cblk style "
              f"{cod[8]:#x}, wavelet {cod[9]}, tile-parts "
              f"{[(i, tp, tn) for i, _, tp, tn in parts][:6]}, "
              f"markers {kinds}")


if __name__ == "__main__":
    if "--check" in sys.argv:
        check()
    else:
        for name, data in sorted(fixtures().items()):
            print(name, len(data))
