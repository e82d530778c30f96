"""WMF, EMF and EPS: formats Pillow opens and cannot load on this host.

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
