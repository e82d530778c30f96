"""Netpbm (PBM, PGM, PPM, PFM) decoding in NumPy, the pixels Pillow gives.

The JAX package opens LDR environment maps and textures with Pillow
(``Image.open(...).convert("RGBA")``); ``PpmImagePlugin`` (12.1.0) reads
the magics ``P1``-``P6``, ``Pf`` and its own ``P0CMYK``, ``PyP``,
``PyRGBA`` and ``PyCMYK``. This module reads every one of them to the same
bytes, with Pillow's rules:

* the header: the magic up to 6 bytes or a whitespace; then tokens of at
  most 10 bytes split by whitespace, where ``#`` starts a comment that runs
  to a CR or LF, anywhere, even inside a token; a token is read by
  Python's ``int()`` (``float()`` for Pf's scale); the data starts one byte
  after the last token;
* ``maxval`` 1-65535; a gray image with ``maxval`` above 255 is 32-bit
  (mode "I"), which ``convert`` clips at 255: a 16-bit gray map is nearly
  white. Every other sample is scaled to ``out_max`` (255, or 65535 for
  such gray) as ``round(v / maxval * out_max)``, Python's round half to
  even, capped at ``out_max``; ``maxval`` 255 (and 65535 for binary gray)
  is read as it is;
* plain (ASCII) files: comments anywhere in the data, a value above
  ``maxval`` or negative raises, and P1's digits need no whitespace;
  ``0`` is white, ``1`` black, as in P4's bits;
* Pf: 32-bit floats, rows bottom-up, little-endian under a negative scale,
  each truncated toward zero and clipped to 0-255 (NaN is 0); CMYK through
  Pillow's ``cmyk2rgb``; ``PyP`` has no palette (black).

Bytes Pillow refuses raise ``ValueError`` naming the image; a magic it
does not know raises ``NotThisFormat``, on which ``utils/image.py::
decode_image_rgba`` goes on to Pillow's next format.
"""

from __future__ import annotations

import numpy as np

from wgpu_path_tracing_tpu_torch.utils.sniff import NotThisFormat, bomb_check

WHITESPACE = b"\x20\x09\x0a\x0b\x0c\x0d"
MODES = {b"P1": "1", b"P2": "L", b"P3": "RGB", b"P4": "1", b"P5": "L",
         b"P6": "RGB", b"P0CMYK": "CMYK", b"Pf": "F", b"PyP": "P",
         b"PyRGBA": "RGBA", b"PyCMYK": "CMYK"}
BANDS = {"L": 1, "I": 1, "RGB": 3, "RGBA": 4, "CMYK": 4, "P": 1}


class _Reader:
    """A byte cursor with PpmImageFile's ``_read_magic`` and
    ``_read_token``."""

    def __init__(self, data: bytes, name: str):
        self.data, self.pos, self.name = data, 0, name

    def read1(self) -> bytes:
        c = self.data[self.pos:self.pos + 1]
        self.pos += len(c)
        return c

    def magic(self) -> bytes:
        out = b""
        for _ in range(6):
            c = self.read1()
            if not c or c in WHITESPACE:
                break
            out += c
        return out

    def token(self) -> bytes:
        tok = b""
        while len(tok) <= 10:
            c = self.read1()
            if not c:
                break
            if c in WHITESPACE:
                if not tok:
                    continue
                break
            if c == b"#":
                while self.read1() not in b"\r\n":
                    pass
                continue
            tok += c
        if not tok:
            raise ValueError(f"{self.name}: reached the end of the file while "
                             "reading the netpbm header")
        if len(tok) > 10:
            raise ValueError(f"{self.name}: a netpbm header token is too long")
        return tok

    def number(self, parse=int):
        tok = self.token()
        try:
            return parse(tok)
        except ValueError:
            raise ValueError(f"{self.name}: netpbm header token {tok!r} is not "
                             "a number") from None


SAFEBLOCK = 1024 * 1024  # PpmPlainDecoder reads the data in such blocks


def _comment_end(block: bytes, start: int = 0) -> int:
    """PpmPlainDecoder._find_comment_end, as it is."""
    a = block.find(b"\n", start)
    b = block.find(b"\r", start)
    return min(a, b) if a * b > 0 else max(a, b)


def _plain_blocks(body: bytes):
    """PpmPlainDecoder's blocks of the data with comments removed; a
    comment may run on into the next block."""
    spans = False
    for at in range(0, len(body), SAFEBLOCK):
        block = body[at:at + SAFEBLOCK]
        if spans:
            end = _comment_end(block)
            if end == -1:
                continue
            block = block[end + 1:]
        spans = False
        while True:
            start = block.find(b"#")
            if start == -1:
                break
            end = _comment_end(block, start)
            if end != -1:
                block = block[:start] + block[end + 1:]
            else:
                block, spans = block[:start], True
                break
        yield block


def _plain_bits(body: bytes, count: int, name: str) -> np.ndarray:
    """P1's digits, whitespace between them optional: 0 white (255), 1
    black (0); every digit of a block read is checked."""
    data = b""
    for block in _plain_blocks(body):
        digits = b"".join(block.split())
        if digits.translate(None, b"01"):
            raise ValueError(f"{name}: invalid token in a plain PBM")
        data = (data + digits)[:count]
        if len(data) == count:
            break
    if len(data) < count:
        raise ValueError(f"{name}: not enough image data")
    return np.where(np.frombuffer(data, np.uint8) == ord("0"),
                    255, 0).astype(np.int64)


def _scale(values: np.ndarray, maxval: int, out_max: int) -> np.ndarray:
    """Python's ``round(v / maxval * out_max)`` on float64, half to even."""
    return np.rint(values.astype(np.float64) / maxval * out_max).astype(np.int64)


def _plain_samples(body: bytes, count: int, maxval: int, out_max: int,
                   name: str) -> np.ndarray:
    """PpmPlainDecoder._decode_blocks: decimal tokens of at most 10 bytes,
    a token cut by a block's end joined to the next block's start."""
    values: list[int] = []
    half = b""
    blocks = list(_plain_blocks(body)) + [None]
    for block in blocks:
        if block is None:
            if not half:
                break
            block = b" "
        if half:
            block, half = half + block, b""
        tokens = block.split()
        if block and not block[-1:].isspace():
            half = tokens.pop()
            if len(half) > 10:
                raise ValueError(f"{name}: token too long in the data")
        for tok in tokens:
            if len(tok) > 10:
                raise ValueError(f"{name}: token too long in the data")
            v = int(tok)
            if v < 0:
                raise ValueError(f"{name}: channel value is negative: {v}")
            if v > maxval:
                raise ValueError(f"{name}: channel value too large for this "
                                 f"mode: {v}")
            values.append(v)
            if len(values) == count:
                return _scale(np.asarray(values, np.int64), maxval, out_max)
    raise ValueError(f"{name}: not enough image data")


def _binary_samples(data: bytes, count: int, maxval: int, out_max: int,
                    name: str) -> np.ndarray:
    """PpmDecoder: 1 or 2 big-endian bytes a sample, scaled and capped."""
    dtype = np.uint8 if maxval < 256 else np.dtype(">u2")
    size = np.dtype(dtype).itemsize
    if len(data) < count * size:
        raise ValueError(f"{name}: not enough image data")
    raw = np.frombuffer(data, dtype, count=count)
    return np.minimum(_scale(raw, maxval, out_max), out_max)


def _to_rgba(mode: str, samples: np.ndarray, h: int, w: int) -> np.ndarray:
    """Samples (h * w * bands) in ``mode`` -> RGBA as ``convert`` gives."""
    from wgpu_path_tracing_tpu_torch.utils.jpeg import pillow_cmyk_to_rgb

    out = np.full((h, w, 4), 255, np.uint8)
    if mode == "P":  # no palette: every entry black
        out[..., :3] = 0
        return out
    s = samples.reshape(h, w, -1)
    if mode in ("1", "L", "I"):
        out[..., :3] = np.clip(s, 0, 255).astype(np.uint8)
    elif mode == "RGB":
        out[..., :3] = s
    elif mode == "RGBA":
        out[...] = s
    else:  # CMYK
        out[..., :3] = pillow_cmyk_to_rgb(s.astype(np.uint8))
    return out


def decode_netpbm_rgba(data: bytes, name: str = "image") -> np.ndarray:
    """Netpbm bytes -> (H, W, 4) uint8 RGBA, what Pillow's
    ``Image.open(...).convert("RGBA")`` returns."""
    r = _Reader(data, name)
    magic = r.magic()
    if magic not in MODES:
        raise NotThisFormat(f"{name}: {magic!r} is not a netpbm magic")
    mode = MODES[magic]
    w, h = r.number(), r.number()
    if w <= 0 or h <= 0:
        raise ValueError(f"{name}: netpbm size {w}x{h} is empty")
    bomb_check(w, h, name)
    if mode == "1":
        n = w * h
        if magic == b"P1":
            bits = _plain_bits(data[r.pos:], n, name)
        else:
            stride = (w + 7) // 8
            if len(data) - r.pos < stride * h:
                raise ValueError(f"{name}: the PBM data is truncated")
            rows = np.frombuffer(data, np.uint8, count=stride * h,
                                 offset=r.pos).reshape(h, stride)
            bits = np.where(np.unpackbits(rows, axis=1)[:, :w], 0, 255)
        return _to_rgba("1", bits.astype(np.int64), h, w)
    if mode == "F":
        scale = r.number(float)
        if scale == 0.0 or not np.isfinite(scale):
            raise ValueError(f"{name}: the PFM scale must be finite and "
                             "non-zero")
        dtype = np.dtype("<f4" if scale < 0 else ">f4")
        if len(data) - r.pos < 4 * w * h:
            raise ValueError(f"{name}: the PFM data is truncated")
        f = np.frombuffer(data, dtype, count=w * h, offset=r.pos)
        f = f.reshape(h, w)[::-1].astype(np.float64)
        with np.errstate(invalid="ignore"):
            v = np.where(np.isnan(f), 0, np.clip(np.trunc(f), 0, 255))
        return _to_rgba("L", v.astype(np.int64), h, w)
    maxval = r.number()
    if not 0 < maxval < 65536:
        raise ValueError(f"{name}: netpbm maxval must be greater than 0 and "
                         "less than 65536")
    if maxval > 255 and mode == "L":
        mode = "I"
    out_max = 65535 if mode == "I" else 255
    count = w * h * BANDS[mode]
    body = data[r.pos:]
    if magic in (b"P2", b"P3"):
        samples = _plain_samples(body, count, maxval, out_max, name)
    elif maxval == 255 or (maxval == 65535 and mode == "I"):
        dtype = np.uint8 if maxval == 255 else np.dtype(">u2")
        if len(body) < count * np.dtype(dtype).itemsize:
            raise ValueError(f"{name}: the netpbm data is truncated")
        samples = np.frombuffer(body, dtype, count=count).astype(np.int64)
    else:
        samples = _binary_samples(body, count, maxval, out_max, name)
    return _to_rgba(mode, samples, h, w)
