"""WMF, EMF, EPS, BUFR, GRIB, HDF5 and MPEG: formats Pillow opens and
cannot load on this host.

Pillow opens a Windows metafile (placeable WMF or EMF) with a stub that
loads only through a handler, which it has on Windows alone, and an EPS
file with a plugin that loads through Ghostscript. Where neither is
there, ``Image.open`` succeeds and ``load`` raises, and so does the JAX
package's reader; these readers raise ``ValueError`` naming the file and
the reason. Bytes WMF's ``_open`` passes on (a header cut short, no
known record, a box of no size) go on to Pillow's next formats
(``NotThisFormat``). Every byte string EPS's
``_accept`` takes ends with an error in Pillow (its ``_open`` fails, and
no format after it takes such a start, or its ``load`` needs
Ghostscript), so the EPS reader raises at once.

BUFR, GRIB and HDF5 are Pillow's stub plugins: ``_open`` takes whatever
their ``_accept`` took as a 1 x 1 "F" image and ``load`` needs a handler
that a program must register (none is), so each raises at once. MPEG's
``_open`` reads a width and a height of 12 bits each after the start
code: a file too short for them, or a size of no pixels, goes on to the
next format; any other has no tile, and ``load`` raises ("cannot load
this image").
"""

from __future__ import annotations

import struct

import numpy as np

from wgpu_path_tracing_tpu_torch.utils.sniff import NotThisFormat


def decode_wmf_rgba(data: bytes, name: str = "image") -> np.ndarray:
    """Raise as Pillow does on WMF or EMF bytes (or pass them on)."""
    if data.startswith(b"\xd7\xcd\xc6\x9a\x00\x00"):
        if len(data) < 16:
            raise NotThisFormat(f"{name}: a placeable WMF header cut short")
        x0, y0, x1, y1, inch = struct.unpack_from("<4hH", data, 6)
        if inch == 0:
            raise ValueError(f"{name}: invalid WMF inch (Pillow refuses it)")
        if data[22:26] != b"\x01\x00\t\x00":
            raise NotThisFormat(f"{name}: unsupported WMF file format")
        size = ((x1 - x0) * 72 // inch, (y1 - y0) * 72 // inch)
    elif data.startswith(b"\x01\x00\x00\x00") and data[40:44] == b" EMF":
        x0, y0, x1, y1, f0, f1, f2, f3 = struct.unpack_from("<8i", data, 8)
        if f2 == f0 or f3 == f1:
            raise ValueError(f"{name}: an EMF frame of no extent (Pillow "
                             "divides by it)")
        size = (x1 - x0, y1 - y0)
    else:
        raise NotThisFormat(f"{name}: not a WMF or EMF file")
    if size[0] <= 0 or size[1] <= 0:
        raise NotThisFormat(f"{name}: a Windows metafile of no size")
    raise ValueError(f"{name}: a Windows metafile, which Pillow loads only "
                     "through a WMF handler (Windows), so the JAX package "
                     "cannot read it either")


def decode_eps_rgba(data: bytes, name: str = "image") -> np.ndarray:
    """Raise as Pillow does on EPS bytes."""
    raise ValueError(f"{name}: an EPS file, which Pillow loads only through "
                     "Ghostscript (none on the host), so the JAX package "
                     "cannot read it either")


def _stub(kind: str, name: str):
    raise ValueError(f"{name}: a {kind} file, which Pillow loads only "
                     f"through a {kind} handler (none is registered), so the "
                     "JAX package cannot read it either")


def decode_bufr_rgba(data: bytes, name: str = "image") -> np.ndarray:
    """Raise as Pillow's ``load`` does on BUFR bytes."""
    _stub("BUFR", name)


def decode_grib_rgba(data: bytes, name: str = "image") -> np.ndarray:
    """Raise as Pillow's ``load`` does on GRIB bytes."""
    _stub("GRIB", name)


def decode_hdf5_rgba(data: bytes, name: str = "image") -> np.ndarray:
    """Raise as Pillow's ``load`` does on HDF5 bytes."""
    _stub("HDF5", name)


def decode_mpeg_rgba(data: bytes, name: str = "image") -> np.ndarray:
    """Raise as Pillow does on MPEG bytes (or pass them on)."""
    if len(data) < 7:
        raise NotThisFormat(f"{name}: an MPEG header cut short")
    bits = int.from_bytes(data[4:7], "big")
    if bits >> 12 == 0 or bits & 0xFFF == 0:
        raise NotThisFormat(f"{name}: an MPEG picture of no size")
    raise ValueError(f"{name}: an MPEG file, which Pillow opens without "
                     "decoding it (cannot load this image), so the JAX "
                     "package cannot read it either")
