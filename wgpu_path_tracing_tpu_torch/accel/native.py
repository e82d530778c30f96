"""The native C++ scene-prep library (``accel/cbvh/*.cpp``), built with g++
and bound with ``ctypes``.

The counterpart of the JAX package's ``accel/native.py``. Eleven sources,
each the twin of a NumPy or Python path of this package and bit-identical
to it (``tests/test_torch_native.py``, ``tests/test_torch_jpeg.py``):

* ``bvh_builder.cpp``: the SAH build of ``accel/bvh.py::build_bvh``;
* ``wide_collapse.cpp``: the 8-wide collapse of ``accel/bvh8.py::
  build_wide_bvh`` (packs "none" and "ffd");
* ``flatten.cpp``: the glTF corner transform and gather of ``models/gltf.py::
  flatten_corners``, and the triangle reorder of ``models/assemble.py::
  finalize_scene``;
* ``potpack.cpp``: ``models/potpack.py::potpack_python``;
* ``jpeg_scan.cpp``: the entropy decode of a JPEG scan, ``utils/jpeg.py::
  decode_scan`` and its progressive MCU decoders, ``decode_arith_scan``
  and ``decode_lossless_scan``, a lossless component's ``undifference``,
  and ``huffman_reads_whole`` (whether libjpeg decodes a scan that runs to
  the end of the file without asking for more);
* ``image_scan.cpp``: the per-packet loops of the LDR readers,
  ``utils/tga.py::rle_plain``, ``utils/bmp.py::rle_plain``,
  ``utils/tiff.py::packbits_plain`` and ``lzw_plain`` (new- and old-style
  codes), ``utils/gif.py::lzw_plain``, ``utils/qoi.py::ops_plain``,
  ``utils/pcx.py::rle_plain``, ``utils/sgi.py::rle_plain``,
  ``utils/psd.py::packbits_rows_plain``, ``utils/sun.py::rle_plain``,
  ``utils/msp.py::rle_plain``, ``utils/icns.py::rle_plain``,
  ``utils/fli.py::fli_plain``, ``utils/im.py::bits_plain`` and
  ``utils/tiff.py::thunder_plain``;
* ``bcn_scan.cpp``: the BC1-BC7 block decoders of ``utils/bcn.py``, and
  the BLP reader's DXT1/3/5 decoder, ``utils/blp.py::dxt_plain``;
* ``fax_scan.cpp``: the CCITT decoders of ``utils/fax.py::fax_plain``;
* ``webp_scan.cpp``: the WebP decoding loops, ``utils/webp.py::
  vp8l_plain``, ``vp8_plain``, ``yuv_to_rgb_plain`` and
  ``unfilter_plain``;
* ``j2k_scan.cpp``: the JPEG 2000 code-block decoder (MQ and raw passes),
  ``utils/jpeg2000.py::t1_plain``;
* ``zstd_scan.cpp``: the Zstandard frame decoder, ``utils/zstd.py::
  zstd_plain``.

Two things differ from the JAX package's copies, and each keeps the port's
trees the NumPy build's. The SAH build sorts on float32 centroid keys, as
``accel/bvh.py`` does (the JAX copy sorts on double keys). The library is
built with ``-O3 -ffp-contract=off`` and neither ``-march=native`` nor
``-ffast-math``, so no multiply-add is fused where NumPy rounds twice.

The build happens at first use, into ``build/native/`` beside the package
(git-ignored), under a name that hashes the sources and the flags, through
a file unique to the process that ``os.replace`` moves into place, so that
processes that build at once each load a whole library. Without ``g++`` on
``PATH``, ``native_available()`` is False and the loaders take the NumPy
paths; with it, a compile, load or symbol that fails raises with the
compiler's report.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

import numpy as np

from wgpu_path_tracing_tpu_torch.accel.bvh import BVH, build_bvh as build_bvh_numpy

SRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cbvh")
SOURCES = ("bvh_builder.cpp", "wide_collapse.cpp", "flatten.cpp",
           "potpack.cpp", "jpeg_scan.cpp", "image_scan.cpp", "webp_scan.cpp",
           "fax_scan.cpp", "bcn_scan.cpp", "j2k_scan.cpp", "zstd_scan.cpp")
PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "native")
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-ffp-contract=off")

_F32P = ctypes.POINTER(ctypes.c_float)
_F64P = ctypes.POINTER(ctypes.c_double)
_I32P = ctypes.POINTER(ctypes.c_int32)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_U32P = ctypes.POINTER(ctypes.c_uint32)
_I64P = ctypes.POINTER(ctypes.c_int64)
_I32 = ctypes.c_int32
_I64 = ctypes.c_int64
_PTRS = ctypes.POINTER(ctypes.c_void_p)

# C signatures of the exported functions; each returns an int64.
SIGNATURES = {
    # v0, v1, v2, tris, max leaf size, bins, out aabb min, max, meta, order
    "wpt_build_bvh": [_F32P, _F32P, _F32P, _I64, _I32, _I32,
                      _F32P, _F32P, _I32P, _I64P],
    # meta, nodes, tris, leaf slots, pack, out node count, group count
    "wpt_wide_counts": [_I32P, _I64, _I64, _I32, _I32, _I64P, _I64P],
    # aabb min, max, meta, nodes, tri_isect, tris, leaf slots, sub, group
    # rows, lanes, pack, out meta, order, boxes, tris, node and group counts
    "wpt_build_wide": [_F32P, _F32P, _I32P, _I64, _F32P, _I64, _I32, _I32,
                       _I32, _I32, _I32, _I32P, _I32P, _F32P, _F32P, _I64,
                       _I64],
    # pos, nrm, verts, world, normal matrix, idx, tris, identity, out v0,
    # v1, v2, n0, n1, n2
    "wpt_flatten": [_F32P, _F32P, _I64, _F64P, _F64P, _I64P, _I64, _I32,
                    *[_F32P] * 6],
    # order, n, the nine float columns and the material column in, then out
    "wpt_reorder_tris": [_I64P, _I64, *[_F32P] * 9, _I32P, *[_F32P] * 9,
                         _I32P],
    # wh, n, out xy, out (width, height)
    "wpt_potpack": [_F64P, _I64, _F64P, _F64P],
    # data, segment starts, segments, segments present, mode, Ss, Se, Al,
    # MCUs, MCUs an interval, MCUs a row, values a data unit, blocks an MCU,
    # each block's slot, offset, row stride, MCU width, DC and AC table;
    # coefficient grids, tables, out last good MCU, out skipped MCU rows
    "wpt_jpeg_scan": [ctypes.c_char_p, _I64P, _I64, _I64, _I32, _I32, _I32,
                      _I32, _I64, _I64, _I64, _I32, _I32, _I32P, _I64P,
                      _I64P, _I64P, _I32P, _I32P, _PTRS, _PTRS, _I64P, _U8P],
    # as wpt_jpeg_scan without the unit, with table numbers, then each
    # table's L, U and Kx; coefficient grids
    "wpt_jpeg_arith_scan": [ctypes.c_char_p, _I64P, _I64, _I32, _I32, _I32,
                            _I32, _I64, _I64, _I64, _I32, _I32P, _I64P,
                            _I64P, _I64P, _I32P, _I32P, _U8P, _U8P, _U8P,
                            _PTRS],
    # data, its length, the interval's start, its data bytes' ends, their
    # count, the marker's end, MCUs, blocks an MCU, each block's DC and AC
    # table, the tables, fast path allowed
    "wpt_jpeg_reads_whole": [ctypes.c_char_p, _I64, _I64, _I64P, _I64, _I64,
                             _I64, _I32, _I32P, _I32P, _PTRS, _I32],
    # differences, row stride, width, height, first rows, predictor, Pt,
    # out samples
    "wpt_jpeg_undifference": [_I32P, _I64, _I64, _I64, _U8P, _I32, _I32,
                              _U8P],
    # data, its length, start, bytes a pixel, width, pixels, out
    "wpt_tga_rle": [ctypes.c_char_p, _I64, _I64, _I32, _I64, _I64, _U8P],
    # data, its length, start, RLE4, width, pixels, out, out status
    "wpt_bmp_rle": [ctypes.c_char_p, _I64, _I64, _I32, _I64, _I64, _U8P,
                    _I64P],
    # data, its length, bytes wanted, out
    "wpt_packbits": [ctypes.c_char_p, _I64, _I64, _U8P],
    # data, its length, bytes wanted, old-style codes, out, out bytes written
    "wpt_lzw": [ctypes.c_char_p, _I64, _I64, _I32, _U8P, _I64P],
    # data, its length, compression (2, 3, 4), width, rows, T4Options, the
    # page's run array and its length, out (rows x width 0/1 samples)
    "wpt_fax": [ctypes.c_char_p, _I64, _I32, _I64, _I64, _I32, _I64P, _I64,
                _U8P],
    # data, its length, minimum code size, width, height, interlaced, out
    # (the frame's indices), out pixels written
    "wpt_gif_lzw": [ctypes.c_char_p, _I64, _I32, _I64, _I64, _I32, _U8P,
                    _I64P],
    # data, its length, start bit, width, height, an ALPH stream, distance
    # map, out ARGB
    "wpt_vp8l": [ctypes.c_char_p, _I64, _I64, _I32, _I32, _I32, _U8P, _U32P],
    # data, its length, width, height, DC and AC quantizer tables, default
    # and update coefficient probabilities, B_PRED probabilities, out Y, U,
    # V (whole macroblocks)
    "wpt_vp8": [ctypes.c_char_p, _I64, _I32, _I32, _I32P, _I32P, _U8P, _U8P,
                _U8P, _U8P, _U8P, _U8P],
    # Y, its row stride, U, V, their row stride, width, height, out RGB
    "wpt_yuv_to_rgb": [_U8P, _I64, _U8P, _U8P, _I64, _I32, _I32, _U8P],
    # filtered alpha, width, height, filter method, out alpha
    "wpt_alpha_unfilter": [_U8P, _I32, _I32, _I32, _U8P],
    # data, its length, start, pixels, out RGBA
    "wpt_qoi": [ctypes.c_char_p, _I64, _I64, _I64, _U8P],
    # data, its length, start, bytes a row, rows, out
    "wpt_pcx_rle": [ctypes.c_char_p, _I64, _I64, _I64, _I64, _U8P],
    # data, its length, width, height, channels, bytes a sample, out rows
    "wpt_sgi_rle": [ctypes.c_char_p, _I64, _I64, _I64, _I32, _I32, _U8P],
    # data, its length, start, bytes a row, rows, out
    "wpt_packbits_rows": [ctypes.c_char_p, _I64, _I64, _I64, _I64, _U8P],
    # data, its length, start, format (BCN_CODES), width, height, out
    "wpt_bcn": [ctypes.c_char_p, _I64, _I64, _I32, _I64, _I64, _U8P],
    # data, its length, start, DXT kind (1, 3, 5), alpha, blocks a row,
    # block rows, out
    "wpt_blp_dxt": [ctypes.c_char_p, _I64, _I64, _I32, _I32, _I64, _I64,
                    _U8P],
    # data, its length, start, bytes wanted, out
    "wpt_sun_rle": [ctypes.c_char_p, _I64, _I64, _I64, _U8P],
    # data, its length, start, row map, rows, blank row bytes, out size,
    # out, out bytes written
    "wpt_msp_rle": [ctypes.c_char_p, _I64, _I64, _I64P, _I64, _I64, _I64,
                    _U8P, _I64P],
    # data, its length, start, bytes wanted, out, out end
    "wpt_icns_rle": [ctypes.c_char_p, _I64, _I64, _I64, _U8P, _I64P],
    # one frame's bytes, their length, width, height, out indices
    "wpt_fli": [ctypes.c_char_p, _I64, _I64, _I64, _U8P],
    # data, its length, start, width, height, bits a pixel, out floats
    "wpt_bit_decode": [ctypes.c_char_p, _I64, _I64, _I64, _I64, _I32,
                       _F32P],
    # code-block data, its length, the blocks' table, blocks, segments, out
    # samples
    "wpt_j2k_t1": [ctypes.c_char_p, _I64, _I64P, _I64, _I64P, _I32P],
    # data, its length, width, rows, out (rows of (width + 1) // 2 bytes)
    "wpt_thunder": [ctypes.c_char_p, _I64, _I64, _I64, _U8P],
    # data, its length, the stream decoder's room (-1: every frame), out,
    # its capacity, out bytes written (or needed)
    "wpt_zstd": [ctypes.c_char_p, _I64, _I64, _U8P, _I64, _I64P],
}
# utils/bcn.py's formats -> (wpt_bcn's code, bytes a pixel).
BCN_CODES = {"BC1": (1, 4), "BC2": (2, 4), "BC3": (3, 4), "BC4": (4, 1),
             "BC5": (5, 3), "BC5S": (6, 3), "BC6H": (7, 3), "BC6HS": (8, 3),
             "BC7": (9, 4)}
PACK_CODES = {"none": 0, "ffd": 1}


class _Lib:
    handle: ctypes.CDLL | None = None
    lock = threading.Lock()


def compiler() -> str | None:
    """The C++ compiler the library is built with, or None."""
    return shutil.which("g++")


def native_available() -> bool:
    """Whether the loaders build with the library: True when ``g++`` is on
    ``PATH``. Whether it then compiles and loads is ``lib()``'s to say, and
    it raises if not."""
    return compiler() is not None


def library_path() -> str:
    """Where the library of these sources and flags is (or will be)."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(SRC_DIR, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"libwpt_native_{h.hexdigest()[:16]}.so")


def build(cxx: str | None = None) -> str:
    """Compile the library into ``BUILD_DIR`` unless it is there; returns
    its path. The output goes to a file unique to this process, then
    ``os.replace`` moves it into place. Raises with g++'s report when the
    compile fails."""
    out = library_path()
    if os.path.exists(out):
        return out
    cxx = cxx or compiler()
    if cxx is None:
        raise RuntimeError("g++ not found: the native scene-prep library "
                           "needs a C++ compiler on PATH")
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=".native_", suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [cxx, *CXX_FLAGS, "-o", tmp,
             *[os.path.join(SRC_DIR, name) for name in SOURCES]],
            capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed to build the native scene-prep "
                               f"library ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def lib() -> ctypes.CDLL:
    """The loaded library (built on first call), every symbol bound."""
    with _Lib.lock:
        if _Lib.handle is None:
            handle = ctypes.CDLL(build())
            for name, argtypes in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = _I64
            _Lib.handle = handle
        return _Lib.handle


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctype)


def build_bvh_native(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray,
                     max_leaf_size: int = 4, num_bins: int = 12) -> BVH:
    """The SAH build of ``accel/bvh.py::build_bvh`` in C++; the same
    ``BVH``, bit for bit."""
    num_tris = int(np.asarray(v0).shape[0])
    if num_tris == 0:
        return build_bvh_numpy(v0, v1, v2, max_leaf_size, num_bins)
    v0, v1, v2 = (np.ascontiguousarray(v, np.float32).reshape(num_tris, 3)
                  for v in (v0, v1, v2))
    max_nodes = 2 * num_tris + 1
    aabb_min = np.empty((max_nodes, 3), np.float32)
    aabb_max = np.empty((max_nodes, 3), np.float32)
    meta = np.empty((max_nodes, 4), np.int32)
    order = np.empty((num_tris,), np.int64)
    count = lib().wpt_build_bvh(
        _ptr(v0, _F32P), _ptr(v1, _F32P), _ptr(v2, _F32P), num_tris,
        max_leaf_size, num_bins, _ptr(aabb_min, _F32P),
        _ptr(aabb_max, _F32P), _ptr(meta, _I32P), _ptr(order, _I64P))
    if count <= 0:
        raise RuntimeError(f"native BVH build failed (rc={count})")
    return BVH(aabb_min=aabb_min[:count].copy(),
               aabb_max=aabb_max[:count].copy(),
               meta=meta[:count].copy(), order=order)


def build_bvh(v0, v1, v2, max_leaf_size: int = 4, num_bins: int = 12) -> BVH:
    """The SAH build: the library's when ``native_available()``, else the
    NumPy build's (the same tree)."""
    if native_available():
        return build_bvh_native(v0, v1, v2, max_leaf_size, num_bins)
    return build_bvh_numpy(v0, v1, v2, max_leaf_size, num_bins)


def build_wide_native(aabb_min: np.ndarray, aabb_max: np.ndarray,
                      meta: np.ndarray, tri_isect: np.ndarray,
                      leaf_slots: int, sub: int, grows: int,
                      pack: str = "ffd"):
    """The 8-wide collapse of ``accel/bvh8.py::build_wide_bvh`` in C++:
    (meta, order, boxes, tris), bit for bit the NumPy collapse's for the
    packs "none" and "ffd". A count pass sizes the tables, the emit pass
    fills them."""
    if pack not in PACK_CODES:
        raise ValueError(f"native collapse does not implement pack={pack!r}")
    pack_i = PACK_CODES[pack]
    t, b = int(tri_isect.shape[0]), int(meta.shape[0])
    if t <= 0 or b <= 0:
        raise ValueError("native collapse needs a tree and triangles")
    meta_c = np.ascontiguousarray(meta, np.int32)
    amin_c = np.ascontiguousarray(aabb_min, np.float32)
    amax_c = np.ascontiguousarray(aabb_max, np.float32)
    tri_c = np.ascontiguousarray(tri_isect, np.float32)
    library = lib()
    nn, ng = _I64(), _I64()
    rc = library.wpt_wide_counts(_ptr(meta_c, _I32P), b, t, leaf_slots,
                                 pack_i, ctypes.byref(nn), ctypes.byref(ng))
    if rc != 0:
        raise RuntimeError(f"native wide count failed (rc={rc})")
    nn, ng = nn.value, ng.value
    lanes = max(leaf_slots, 128)
    wmeta = np.empty((nn, 8), np.int32)
    worder = np.empty((nn, 64), np.int32)
    wboxes = np.empty((nn * 64, 8), np.float32)
    wtris = np.empty((ng * grows, lanes), np.float32)
    rc = library.wpt_build_wide(
        _ptr(amin_c, _F32P), _ptr(amax_c, _F32P), _ptr(meta_c, _I32P), b,
        _ptr(tri_c, _F32P), t, leaf_slots, sub, grows, lanes, pack_i,
        _ptr(wmeta, _I32P), _ptr(worder, _I32P), _ptr(wboxes, _F32P),
        _ptr(wtris, _F32P), nn, ng)
    if rc != 0:
        raise RuntimeError(f"native wide collapse failed (rc={rc})")
    return wmeta, worder, wboxes, wtris


def potpack_native(wh: np.ndarray) -> tuple[np.ndarray, float, float]:
    """``models/potpack.py::potpack_python`` in C++. ``wh``: (n, 2) float64
    box (w, h) in list order. Returns (xy (n, 2) float64, width, height)."""
    wh = np.ascontiguousarray(wh, np.float64).reshape(-1, 2)
    xy = np.zeros((wh.shape[0], 2), np.float64)
    dims = np.zeros((2,), np.float64)
    rc = lib().wpt_potpack(_ptr(wh, _F64P), wh.shape[0], _ptr(xy, _F64P),
                           _ptr(dims, _F64P))
    if rc != 0:
        raise RuntimeError(f"native potpack failed (rc={rc})")
    return xy, float(dims[0]), float(dims[1])


def flatten_native(pos, nrm, world, normal_mat, idx):
    """A primitive's world transform, normal renormalization and corner
    gather in one pass (``flatten.cpp``). ``pos``/``nrm``: (n_verts, 3)
    float32; ``world``: (4, 4) float64; ``normal_mat``: its inverse
    transpose, (4, 4) or (3, 3); ``idx``: (3k,) corner indices. Returns the
    six (k, 3) float32 corner arrays (v0, v1, v2, n0, n1, n2) of
    ``models/gltf.py::flatten_corners``, bit for bit. An index out of
    range raises."""
    pos = np.ascontiguousarray(pos, np.float32)
    nrm = np.ascontiguousarray(nrm, np.float32)
    world = np.ascontiguousarray(world, np.float64)
    nmat = np.ascontiguousarray(np.asarray(normal_mat, np.float64)[0:3, 0:3])
    idx = np.ascontiguousarray(idx, np.int64).reshape(-1)
    k = idx.shape[0] // 3
    identity = int(np.array_equal(world, np.eye(4)))
    outs = [np.empty((k, 3), np.float32) for _ in range(6)]
    rc = lib().wpt_flatten(
        _ptr(pos, _F32P), _ptr(nrm, _F32P), pos.shape[0], _ptr(world, _F64P),
        _ptr(nmat, _F64P), _ptr(idx, _I64P), k, identity,
        *[_ptr(o, _F32P) for o in outs])
    if rc != 0:
        raise RuntimeError(f"native flatten failed (rc={rc}): a corner index "
                           "is out of range")
    return tuple(outs)


def reorder_tris_native(order, v0, v1, v2, n0, n1, n2, u0, u1, u2, mat):
    """The nine triangle columns and the material column gathered in BVH
    ``order`` in one pass (``flatten.cpp``): a permutation, equal to the
    per-array NumPy gathers of ``models/assemble.py::finalize_scene``."""
    order = np.ascontiguousarray(order, np.int64)
    n = order.shape[0]
    ins3 = [np.ascontiguousarray(a, np.float32).reshape(n, 3)
            for a in (v0, v1, v2, n0, n1, n2)]
    ins2 = [np.ascontiguousarray(a, np.float32).reshape(n, 2)
            for a in (u0, u1, u2)]
    mi = np.ascontiguousarray(mat, np.int32).reshape(n)
    outs3 = [np.empty((n, 3), np.float32) for _ in range(6)]
    outs2 = [np.empty((n, 2), np.float32) for _ in range(3)]
    mo = np.empty((n,), np.int32)
    rc = lib().wpt_reorder_tris(
        _ptr(order, _I64P), n, *[_ptr(a, _F32P) for a in ins3 + ins2],
        _ptr(mi, _I32P), *[_ptr(a, _F32P) for a in outs3 + outs2],
        _ptr(mo, _I32P))
    if rc != 0:
        raise RuntimeError(f"native reorder failed (rc={rc}): the order is "
                           "not a permutation of the triangles")
    return (*outs3, *outs2, mo)


def _scan_layout(segments: list, units: list, restart: int, n_mcus: int,
                 table_index):
    """What both scan decoders take: the restart intervals' bytes and
    starts (a missing interval empty), the interval's MCUs, the
    components, and each block's slot, offset, row stride, MCU width, DC
    and AC table (``table_index`` of each unit's table, -1 for none)."""
    interval = restart or n_mcus
    need = (n_mcus + interval - 1) // interval
    segments = segments[:need] + [b""] * (need - len(segments))
    starts = np.zeros(need + 1, np.int64)
    starts[1:] = np.cumsum([len(s) for s in segments])
    comps, blocks = [], []
    for comp, dct, act, offsets, row_stride, _ in units:
        if comp not in comps:
            comps.append(comp)
        slot = comps.index(comp)
        dc, ac = table_index(dct), table_index(act)
        blocks += [(slot, o, row_stride, comp.mcu_w, dc, ac) for o in offsets]
    cols = list(zip(*blocks))
    slot, dc_tab, ac_tab = (np.asarray(cols[i], np.int32) for i in (0, 4, 5))
    off, stride, mcu_w = (np.asarray(cols[i], np.int64) for i in (1, 2, 3))
    coef_ptrs = (ctypes.c_void_p * len(comps))(
        *[c.coef.buffer_info()[0] for c in comps])
    return (b"".join(segments), _ptr(starts, _I64P), need, interval,
            units[0][5], len(blocks), _ptr(slot, _I32P), _ptr(off, _I64P),
            _ptr(stride, _I64P), _ptr(mcu_w, _I64P), _ptr(dc_tab, _I32P),
            _ptr(ac_tab, _I32P), ctypes.cast(coef_ptrs, _PTRS),
            (starts, slot, off, stride, mcu_w, dc_tab, ac_tab, coef_ptrs))


def jpeg_scan_native(segments: list, units: list, restart: int, n_mcus: int,
                     mode: int, ss: int, se: int, al: int, unit: int = 64
                     ) -> None:
    """One Huffman-coded JPEG scan's entropy decode in C++
    (``jpeg_scan.cpp``), into the components' coefficient arrays in place:
    ``segments``, ``units``, ``restart`` and ``n_mcus`` as ``utils/jpeg.py::
    decode_scan`` takes them; ``mode`` 0 sequential, 1 DC first, 2 DC
    refinement, 3 AC first, 4 AC refinement, 5 lossless differences
    (``unit`` 1: one value a data unit). The same values as the Python
    decoders, and what they return (the last MCU begun with libjpeg's
    out-of-data flag clear; in mode 5 the flags of the MCU rows skipped).
    As in libjpeg, no data is an error: a bad code or a cut reads on as
    ``jpeg_scan.cpp`` says."""
    tables = []

    def index(t):
        if t is None:
            return -1
        for i, y in enumerate(tables):
            if y is t:
                return i
        tables.append(t)
        return len(tables) - 1

    (data, starts, need, interval, mcus_row, n_blocks, slot, off, stride,
     mcu_w, dc_tab, ac_tab, coefs, _keep) = _scan_layout(
         segments, units, restart, n_mcus, index)
    lookups = [t.lookup for t in tables]
    table_ptrs = (ctypes.c_void_p * max(len(lookups), 1))(
        *[t.ctypes.data for t in lookups])
    last_good = np.zeros(1, np.int64)
    skipped = np.zeros(-(-n_mcus // mcus_row), np.uint8)
    lib().wpt_jpeg_scan(
        data, starts, need, min(len(segments), need), mode, ss, se, al,
        n_mcus, interval, mcus_row, unit, n_blocks, slot, off, stride, mcu_w,
        dc_tab, ac_tab, coefs, ctypes.cast(table_ptrs, _PTRS),
        _ptr(last_good, _I64P), _ptr(skipped, _U8P))
    return bytearray(skipped.tobytes()) if mode == 5 else int(last_good[0])


def jpeg_arith_scan_native(segments: list, units: list, restart: int,
                           n_mcus: int, mode: int, ss: int, se: int, al: int,
                           cond: dict) -> int:
    """One arithmetic-coded JPEG scan's decode in C++ (``jpeg_scan.cpp``),
    into the components' coefficient arrays in place, as ``utils/jpeg.py::
    decode_arith_scan`` takes its arguments (units carry table numbers, and
    ``cond`` the DAC conditioning); the same coefficients, and the same
    count of bytes the last interval read."""
    (data, starts, need, interval, mcus_row, n_blocks, slot, off, stride,
     mcu_w, dc_tab, ac_tab, coefs, _keep) = _scan_layout(
         segments, units, restart, n_mcus, lambda t: -1 if t is None else t)
    lo = np.asarray([lu[0] for lu in cond["dc"]], np.uint8)
    hi = np.asarray([lu[1] for lu in cond["dc"]], np.uint8)
    kx = np.asarray(cond["ac"], np.uint8)
    return lib().wpt_jpeg_arith_scan(
        data, starts, need, mode, ss, se, al, n_mcus, interval, mcus_row,
        n_blocks, slot, off, stride, mcu_w, dc_tab, ac_tab, _ptr(lo, _U8P),
        _ptr(hi, _U8P), _ptr(kx, _U8P), coefs)


def jpeg_reads_whole_native(data: bytes, start: int, ends: list,
                            marker: int, mcus: int, units: list,
                            fast: bool) -> bool:
    """``utils/jpeg.py::huffman_reads_whole`` in C++ (``jpeg_scan.cpp``):
    the same answer."""
    tables, dc, ac = [], [], []
    for _, dct, act, offsets, _, _ in units:
        for _ in offsets:
            for t, out in ((dct, dc), (act, ac)):
                if not any(t is y for y in tables):
                    tables.append(t)
                out.append(next(i for i, y in enumerate(tables) if y is t))
    lookups = [t.lookup for t in tables]
    ptrs = (ctypes.c_void_p * len(lookups))(*[t.ctypes.data for t in lookups])
    ends_a = np.asarray(ends, np.int64)
    dc_a, ac_a = np.asarray(dc, np.int32), np.asarray(ac, np.int32)
    return bool(lib().wpt_jpeg_reads_whole(
        data, len(data), start, _ptr(ends_a, _I64P), len(ends), marker, mcus,
        len(dc), _ptr(dc_a, _I32P), _ptr(ac_a, _I32P),
        ctypes.cast(ptrs, _PTRS), int(fast)))


def jpeg_undifference_native(diff: np.ndarray, first_rows: np.ndarray,
                             psv: int, pt: int) -> np.ndarray:
    """``utils/jpeg.py::undifference`` in C++: a lossless component's
    (H, W) uint8 samples from its int32 differences (a row-strided view
    of its sample grid), equal to the Python one."""
    h, w = diff.shape
    if diff.strides[1] != 4:
        diff = np.ascontiguousarray(diff)
    first = np.ascontiguousarray(first_rows, np.uint8)
    out = np.empty((h, w), np.uint8)
    lib().wpt_jpeg_undifference(
        diff.ctypes.data_as(_I32P), diff.strides[0] // 4, w, h,
        _ptr(first, _U8P), psv, pt, _ptr(out, _U8P))
    return out


def tga_rle_native(data: bytes, pos: int, bpp: int, width: int,
                   pixels: int) -> tuple[np.ndarray, int]:
    """``utils/tga.py::rle_plain`` in C++ (``image_scan.cpp``): the same
    bytes and status."""
    out = np.zeros(pixels * bpp, np.uint8)
    status = lib().wpt_tga_rle(data, len(data), pos, bpp, width, pixels,
                               _ptr(out, _U8P))
    return out, int(status)


def bmp_rle_native(data: bytes, pos: int, rle4: bool, width: int,
                   count: int) -> tuple[bytes, int]:
    """``utils/bmp.py::rle_plain`` in C++ (``image_scan.cpp``): the same
    bytes and status."""
    out = np.empty(count, np.uint8)
    status = np.zeros(1, np.int64)
    n = lib().wpt_bmp_rle(data, len(data), pos, int(rle4), width, count,
                          _ptr(out, _U8P), _ptr(status, _I64P))
    return out[:n].tobytes(), int(status[0])


def packbits_native(src: bytes, size: int) -> tuple[bytes, int]:
    """``utils/tiff.py::packbits_plain`` in C++ (``image_scan.cpp``)."""
    out = np.empty(size, np.uint8)
    n = lib().wpt_packbits(src, len(src), size, _ptr(out, _U8P))
    return out[:n].tobytes(), 0 if n == size else 2


def lzw_native(src: bytes, size: int, old_style: bool = False
               ) -> tuple[bytes, int]:
    """``utils/tiff.py::lzw_plain`` in C++ (``image_scan.cpp``)."""
    out = np.empty(size, np.uint8)
    written = np.zeros(1, np.int64)
    status = lib().wpt_lzw(src, len(src), size, int(old_style),
                           _ptr(out, _U8P), _ptr(written, _I64P))
    return out[:int(written[0])].tobytes(), int(status)


def fax_native(src: bytes, compression: int, width: int, rows: int,
               options: int = 0, runs: np.ndarray | None = None
               ) -> tuple[np.ndarray, int]:
    """``utils/fax.py::fax_plain`` in C++ (``fax_scan.cpp``); ``runs``, the
    page's run array, updated in place."""
    from wgpu_path_tracing_tpu_torch.utils.fax import fax_runs

    if runs is None:
        runs = fax_runs(compression, width, options)
    if runs.dtype != np.int64 or not runs.flags.c_contiguous or \
            runs.shape != fax_runs(compression, width, options).shape:
        raise ValueError("fax_native needs fax_runs's array for this page")
    out = np.empty((rows, width), np.uint8)
    status = lib().wpt_fax(src, len(src), compression, width, rows, options,
                           _ptr(runs, _I64P), len(runs), _ptr(out, _U8P))
    return out, int(status)


def gif_lzw_native(data: bytes, bits: int, width: int, height: int,
                   interlace: bool) -> tuple[np.ndarray, int, int]:
    """``utils/gif.py::lzw_plain`` in C++ (``image_scan.cpp``): the same
    indices, pixels written and status."""
    out = np.zeros((height, width), np.uint8)
    written = np.zeros(1, np.int64)
    status = lib().wpt_gif_lzw(data, len(data), bits, width, height,
                               int(interlace), _ptr(out, _U8P),
                               _ptr(written, _I64P))
    return out, int(written[0]), int(status)


def vp8l_native(data: bytes, pos: int, width: int, height: int,
                alpha: bool = False) -> tuple[np.ndarray, int]:
    """``utils/webp.py::vp8l_plain`` in C++ (``webp_scan.cpp``)."""
    from wgpu_path_tracing_tpu_torch.utils import webp_tables as T

    out = np.zeros((height, width), np.uint32)
    status = lib().wpt_vp8l(data, len(data), pos, width, height, int(alpha),
                            _ptr(np.ascontiguousarray(T.CODE_TO_PLANE), _U8P),
                            _ptr(out, _U32P))
    return out, int(status)


def vp8_native(data: bytes, width: int, height: int):
    """``utils/webp.py::vp8_plain`` in C++ (``webp_scan.cpp``): (Y, U, V,
    status)."""
    from wgpu_path_tracing_tpu_torch.utils import webp_tables as T

    mb_w, mb_h = (width + 15) >> 4, (height + 15) >> 4
    Y = np.zeros((16 * mb_h, 16 * mb_w), np.uint8)
    U = np.zeros((8 * mb_h, 8 * mb_w), np.uint8)
    V = np.zeros((8 * mb_h, 8 * mb_w), np.uint8)
    tables = [np.ascontiguousarray(t) for t in (
        T.DC_TABLE, T.AC_TABLE, T.COEFF_PROBA0, T.COEFF_UPDATE,
        T.BMODES_PROBA)]
    status = lib().wpt_vp8(data, len(data), width, height,
                           _ptr(tables[0], _I32P), _ptr(tables[1], _I32P),
                           *[_ptr(t, _U8P) for t in tables[2:]],
                           _ptr(Y, _U8P), _ptr(U, _U8P), _ptr(V, _U8P))
    return Y, U, V, int(status)


def yuv_to_rgb_native(Y: np.ndarray, U: np.ndarray, V: np.ndarray,
                      width: int, height: int) -> np.ndarray:
    """``utils/webp.py::yuv_to_rgb_plain`` in C++ (``webp_scan.cpp``)."""
    Y, U, V = (np.ascontiguousarray(p, np.uint8) for p in (Y, U, V))
    out = np.empty((height, width, 3), np.uint8)
    lib().wpt_yuv_to_rgb(_ptr(Y, _U8P), Y.shape[1], _ptr(U, _U8P),
                         _ptr(V, _U8P), U.shape[1], width, height,
                         _ptr(out, _U8P))
    return out


def alpha_unfilter_native(rows: np.ndarray, method: int) -> np.ndarray:
    """``utils/webp.py::unfilter_plain`` in C++ (``webp_scan.cpp``)."""
    rows = np.ascontiguousarray(rows, np.uint8)
    h, w = rows.shape
    out = np.empty((h, w), np.uint8)
    lib().wpt_alpha_unfilter(_ptr(rows, _U8P), w, h, method, _ptr(out, _U8P))
    return out


def qoi_native(data: bytes, pos: int, pixels: int) -> tuple[np.ndarray, int]:
    """``utils/qoi.py::ops_plain`` in C++ (``image_scan.cpp``)."""
    out = np.zeros((pixels, 4), np.uint8)
    status = lib().wpt_qoi(data, len(data), pos, pixels, _ptr(out, _U8P))
    return out, int(status)


def pcx_rle_native(data: bytes, pos: int, row_bytes: int, rows: int
                   ) -> tuple[np.ndarray, int]:
    """``utils/pcx.py::rle_plain`` in C++ (``image_scan.cpp``)."""
    out = np.zeros((rows, row_bytes), np.uint8)
    status = lib().wpt_pcx_rle(data, len(data), pos, row_bytes, rows,
                               _ptr(out, _U8P))
    return out, int(status)


def sgi_rle_native(data: bytes, w: int, h: int, z: int, bpc: int
                   ) -> tuple[np.ndarray, int]:
    """``utils/sgi.py::rle_plain`` in C++ (``image_scan.cpp``)."""
    out = np.zeros((h, w * z * bpc), np.uint8)
    status = lib().wpt_sgi_rle(data, len(data), w, h, z, bpc,
                               _ptr(out, _U8P))
    return out, int(status)


def packbits_rows_native(data: bytes, pos: int, row_bytes: int, rows: int
                         ) -> tuple[np.ndarray, int]:
    """``utils/psd.py::packbits_rows_plain`` in C++ (``image_scan.cpp``)."""
    out = np.zeros((rows, row_bytes), np.uint8)
    status = lib().wpt_packbits_rows(data, len(data), pos, row_bytes, rows,
                                     _ptr(out, _U8P))
    return out, int(status)


def bcn_native(data: bytes, pos: int, fmt: str, w: int, h: int
               ) -> np.ndarray:
    """``utils/bcn.py::decode_plain`` in C++ (``bcn_scan.cpp``): the
    (h, w, channels) pixels of ``fmt``'s blocks from ``pos``."""
    code, chans = BCN_CODES[fmt]
    out = np.empty((h, w, chans), np.uint8)
    if lib().wpt_bcn(data, len(data), pos, code, w, h, _ptr(out, _U8P)):
        raise ValueError(f"the {fmt} blocks end before the image does")
    return out


def blp_dxt_native(data: bytes, pos: int, kind: int, alpha: bool, bw: int,
                   bh: int) -> np.ndarray:
    """``utils/blp.py::dxt_plain`` in C++ (``bcn_scan.cpp``): the
    (4 bh, 4 bw, 3 or 4) pixels of ``bw`` x ``bh`` DXT``kind`` blocks."""
    bpp = 3 if kind == 1 and not alpha else 4
    out = np.empty((4 * bh, 4 * bw, bpp), np.uint8)
    if lib().wpt_blp_dxt(data, len(data), pos, kind, int(alpha), bw, bh,
                         _ptr(out, _U8P)):
        raise ValueError(f"the DXT{kind} blocks end before the image does")
    return out


def sun_rle_native(data: bytes, pos: int, size: int
                   ) -> tuple[np.ndarray, int]:
    """``utils/sun.py::rle_plain`` in C++ (``image_scan.cpp``)."""
    out = np.zeros(size, np.uint8)
    status = lib().wpt_sun_rle(data, len(data), pos, size, _ptr(out, _U8P))
    return out, int(status)


def msp_rle_native(data: bytes, pos: int, rowmap: np.ndarray, blank: int,
                   size: int) -> tuple[np.ndarray, int, int]:
    """``utils/msp.py::rle_plain`` in C++ (``image_scan.cpp``)."""
    rowmap = np.ascontiguousarray(rowmap, np.int64)
    out = np.zeros(size, np.uint8)
    written = np.zeros(1, np.int64)
    status = lib().wpt_msp_rle(data, len(data), pos, _ptr(rowmap, _I64P),
                               len(rowmap), blank, size, _ptr(out, _U8P),
                               _ptr(written, _I64P))
    return out, int(written[0]), int(status)


def icns_rle_native(data: bytes, pos: int, size: int
                    ) -> tuple[np.ndarray, int, int]:
    """``utils/icns.py::rle_plain`` in C++ (``image_scan.cpp``)."""
    out = np.zeros(size, np.uint8)
    end = np.zeros(1, np.int64)
    status = lib().wpt_icns_rle(data, len(data), pos, size, _ptr(out, _U8P),
                                _ptr(end, _I64P))
    return out, int(end[0]), int(status)


def fli_native(buf: bytes, w: int, h: int) -> tuple[np.ndarray, int]:
    """``utils/fli.py::fli_plain`` in C++ (``image_scan.cpp``): one
    frame's (h, w) indices and the status."""
    out = np.zeros((h, w), np.uint8)
    status = lib().wpt_fli(buf, len(buf), w, h, _ptr(out, _U8P))
    return out, int(status)


def bit_decode_native(data: bytes, pos: int, w: int, h: int, bits: int
                      ) -> tuple[np.ndarray, int]:
    """``utils/im.py::bits_plain`` in C++ (``image_scan.cpp``): (h, w)
    float32 rows, top row first, and the status."""
    out = np.zeros((h, w), np.float32)
    status = lib().wpt_bit_decode(data, len(data), pos, w, h, bits,
                                  _ptr(out, _F32P))
    return out, int(status)


def j2k_t1_native(data: bytes, table: np.ndarray, segs: np.ndarray,
                  total: int) -> tuple[np.ndarray, int]:
    """``utils/jpeg2000.py::t1_plain`` over every code-block of a tile in
    C++ (``j2k_scan.cpp``): the int32 samples and the status."""
    out = np.zeros(total, np.int32)
    table = np.ascontiguousarray(table, np.int64)
    segs = np.ascontiguousarray(segs, np.int64).reshape(-1, 3)
    if not len(table):
        return out, 0
    status = lib().wpt_j2k_t1(data, len(data), _ptr(table, _I64P),
                              len(table), _ptr(segs, _I64P), _ptr(out, _I32P))
    return out, int(status)


def thunder_native(src: bytes, width: int, rows: int) -> tuple[bytes, int]:
    """``utils/tiff.py::thunder_plain`` in C++ (``image_scan.cpp``): the same
    bytes and status."""
    out = np.zeros(rows * ((width + 1) // 2) + 1, np.uint8)
    status = lib().wpt_thunder(src, len(src), width, rows, _ptr(out, _U8P))
    return out[:-1].tobytes(), int(status)


def zstd_native(src: bytes, limit: int | None = None) -> bytes:
    """``utils/zstd.py::zstd_plain`` in C++ (``zstd_scan.cpp``): the same
    bytes, or ``ZstdError`` where it refuses the data."""
    from wgpu_path_tracing_tpu_torch.utils.zstd import ZstdError

    src = bytes(src)
    cap = limit if limit is not None else 4 * len(src) + 4096
    while True:
        out = np.empty(max(cap, 1), np.uint8)
        got = np.zeros(1, np.int64)
        status = lib().wpt_zstd(src, len(src), -1 if limit is None else limit,
                                _ptr(out, _U8P), cap, _ptr(got, _I64P))
        if status == 1:
            raise ZstdError("Zstandard data that libzstd refuses")
        if status == 0:
            return out[:int(got[0])].tobytes()
        cap = int(got[0])
