"""A small baseline JPEG writer for the decoder's tests: the files Pillow
cannot write (4:4:0, 4:1:1 and mixed sampling factors, one scan per
component, 16-bit quantization tables, an Adobe RGB marker or only
component ids, restart intervals on any MCU count). Each file is decoded by
Pillow and by ``utils/jpeg.py``; only the decoders are compared, so this
writer's own arithmetic (a float DCT, box downsampling) need not match any
encoder's.

The Huffman tables are the standard ones (ISO 10918-1 Annex K.3), read
from the DHT segments of a file Pillow writes without ``optimize``.
"""

from __future__ import annotations

import io
import os
import struct

import numpy as np
from PIL import Image


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
               adobe_transform: int = 1) -> bytes:
    """A baseline JPEG of the full-size uint8 ``planes`` (1 or 3, each
    (H, W)) with ``sampling`` [(h, v)] a component; ``ids`` the component
    ids (1, 2, 3 by default); ``restart`` MCUs a restart interval;
    ``interleaved`` False writes one scan a component; ``quant16`` writes
    16-bit quantization tables; ``app`` "jfif", "adobe" (with
    ``adobe_transform``) or "none"."""
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
        if len(comps) == 1:
            grid, cw, ch = grids[comps[0]]
            bw, bh = -(-cw // 8), -(-ch // 8)
            mcus = [[(comps[0], [(by, bx)])] for by in range(bh)
                    for bx in range(bw)]
        else:
            mcus = [[(c, [(y * sampling[c][1] + v, x * sampling[c][0] + u)
                          for v in range(sampling[c][1])
                          for u in range(sampling[c][0])]) for c in comps]
                    for y in range(my) for x in range(mx)]
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


def sample_planes(w: int, h: int, nc: int = 3, seed: int = 0,
                  noise: int = 30):
    """Smooth gradients with noise: edges and flat runs for the decoder."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    planes = [(xx * 7 + yy * 3) % 256, (xx * 2 + 255 - yy * 5) % 256,
              128 + 100 * np.sin(xx / 3.0) * np.cos(yy / 5.0)]
    return [np.clip(p + rng.integers(-noise, noise, p.shape), 0, 255).astype(
        np.uint8) for p in planes[:nc]]


def write_fixtures(directory: str) -> None:
    """The JPEGs under ``tests/jpeg`` that ``chip_smoke.py`` checks the
    reader with on the card's host, which has no Pillow: four small ones
    (4:2:0; 4:4:4; 4:2:2 with restart markers; gray with custom Huffman
    tables) with their Pillow decode in ``pillow_rgba.npz``, and a 1024^2
    and a 2048^2 4:2:0 file, timed there, with the SHA-256 of their Pillow
    decode in ``pillow_sha256.json``. Run ``python -m
    tests.torch_jpeg_cases`` from the repository's root to write them
    anew."""
    import hashlib
    import json

    def photo(w, h, seed, noise=30):
        return Image.fromarray(np.stack(sample_planes(w, h, seed=seed,
                                                      noise=noise), -1))

    def smooth(n, seed):
        rng = np.random.default_rng(seed)
        yy, xx = np.mgrid[0:n, 0:n] / n
        base = np.stack([np.sin(xx * 20) * 0.5 + 0.5,
                         np.cos(yy * 13 + xx * 5) * 0.5 + 0.5, xx * yy],
                        -1) * 255
        return Image.fromarray(np.clip(base + rng.normal(0, 6, base.shape),
                                       0, 255).astype(np.uint8))

    def save(name, im, **kw):
        buf = io.BytesIO()
        im.save(buf, "JPEG", **kw)
        with open(os.path.join(directory, name), "wb") as f:
            f.write(buf.getvalue())
        with Image.open(buf) as ref:
            return np.asarray(ref.convert("RGBA"))

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
    }
    np.savez_compressed(os.path.join(directory, "pillow_rgba.npz"), **small)
    digests = {}
    for n, seed in ((1024, 5), (2048, 6)):
        name = f"timing_{n}.jpg"
        rgba = save(name, smooth(n, seed), quality=75, subsampling=2)
        digests[name] = hashlib.sha256(
            np.ascontiguousarray(rgba).tobytes()).hexdigest()
    with open(os.path.join(directory, "pillow_sha256.json"), "w") as f:
        json.dump(digests, f, indent=1)


if __name__ == "__main__":
    write_fixtures(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "jpeg"))
