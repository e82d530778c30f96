"""Read Pillow's two YCC conversions out of Pillow, black-box, or check the
port's copies of them against Pillow on every input.

    python tools/pillow_ycc.py            # write wgpu_path_tracing_tpu_torch/utils/pillow_ycc.npz
    python tools/pillow_ycc.py --check    # both conversions against Pillow, 2^24 inputs each

* ``convert`` of mode "YCbCr" to "RGB" (``ConvertYCbCr.c``): r = y +
  t_r[cr], g = y + t_g[cb, cr], b = y + t_b[cb], each clipped to 0..255,
  where the tables are Pillow's fixed-point products shifted down (the
  green one is a sum of two products shifted together, so it is kept
  whole, 256 x 256). They are read from Pillow's output at luma values
  that leave each sum unclipped.
* the PhotoYCC unpacker of Pillow's Kodak Photo CD decoder ("YCC;P"):
  r = L[y] + CR[cr], g = L[y] + GR[cr] + GB[cb], b = L[y] + CB[cb], each
  clipped. Photo CD files made here (every (y, cr), (y, cb) and (cb, cr)
  pair) give the sums where unclipped, and the five tables are solved
  from them (CR[137] = GB[156] = 0 fixes the split).

``--check`` decodes 2^24 pixels of each through Pillow and through
``utils/pilmodes.py`` and ``utils/pcd.py``. Needs Pillow; the port reads
only the written file.
"""

from __future__ import annotations

import argparse
import io
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from PIL import Image  # noqa: E402

OUT = os.path.join(REPO, "wgpu_path_tracing_tpu_torch", "utils",
                   "pillow_ycc.npz")


def pillow_ycbcr(y, cb, cr) -> np.ndarray:
    """Pillow's RGB of flat uint8 arrays of Y, Cb, Cr."""
    n = len(y)
    px = np.stack([y, cb, cr], -1).astype(np.uint8).reshape(1, n, 3)
    return np.asarray(Image.fromarray(px, "YCbCr").convert("RGB"))[0]


def ycbcr_tables() -> dict:
    cb, cr = (a.reshape(-1) for a in np.meshgrid(np.arange(256),
                                                 np.arange(256),
                                                 indexing="ij"))
    t = {k: np.full(cb.shape, np.iinfo(np.int16).min, np.int64)
         for k in "rgb"}
    for luma in (128, 40, 215, 5, 250):
        out = pillow_ycbcr(np.full(cb.shape, luma), cb, cr).astype(np.int64)
        for k, ch in zip("rgb", range(3)):
            ok = (out[:, ch] > 0) & (out[:, ch] < 255)
            new = ok & (t[k] == np.iinfo(np.int16).min)
            t[k][new] = out[new, ch] - luma
    g = t["g"].reshape(256, 256)
    r, b = t["r"].reshape(256, 256), t["b"].reshape(256, 256)
    assert (r == r[:1]).all() and (b == b[:, :1]).all(), "not separable"
    return {"t_r": r[0].astype(np.int16), "t_b": b[:, 0].astype(np.int16),
            "t_g": g.astype(np.int16)}


def pcd_file(y1, y2, cb, cr, orientation: int = 0) -> bytes:
    """A Photo CD base image: per line pair (256 of them), a row of 768
    lumas, another, then 384 Cb and 384 Cr samples."""
    head = bytearray(96 * 2048)
    head[2048:2055] = b"PCD_IPI"
    head[2048 + 1538] = orientation
    body = np.concatenate([np.asarray(a, np.uint8).reshape(256, -1)
                           for a in (y1, y2, cb, cr)], 1)
    return bytes(head) + body.tobytes()


def pillow_pcd(blocks_y, blocks_cb, blocks_cr) -> np.ndarray:
    """Pillow's RGB of 98,304 2x2 blocks: (98304, 4) lumas and a chroma
    pair each -> (98304, 4, 3)."""
    by = np.asarray(blocks_y).reshape(256, 384, 2, 2)  # pair, x, line, dx
    y1 = by[:, :, 0].reshape(256, 768)
    y2 = by[:, :, 1].reshape(256, 768)
    data = pcd_file(y1, y2, np.reshape(blocks_cb, (256, 384)),
                    np.reshape(blocks_cr, (256, 384)))
    with Image.open(io.BytesIO(data)) as im:
        rgb = np.asarray(im.convert("RGB"))
    return rgb.reshape(256, 2, 384, 2, 3).transpose(0, 2, 1, 3, 4).reshape(
        -1, 4, 3)


def _solve(pairs: np.ndarray, vals: np.ndarray, n: int, anchor: tuple):
    """Integer tables a[0..n) and b[0..n) with a[i] + b[j] = v on every
    unclipped sample (i, j, v), b[anchor[0]] = anchor[1]."""
    a = np.full(n, np.nan)
    b = np.full(n, np.nan)
    b[anchor[0]] = anchor[1]
    for _ in range(64):
        known_b = ~np.isnan(b[pairs[:, 1]])
        a[pairs[known_b, 0]] = vals[known_b] - b[pairs[known_b, 1]]
        known_a = ~np.isnan(a[pairs[:, 0]])
        b[pairs[known_a, 1]] = vals[known_a] - a[pairs[known_a, 0]]
        if not np.isnan(a).any() and not np.isnan(b).any():
            break
    ok = ~np.isnan(a[pairs[:, 0]]) & ~np.isnan(b[pairs[:, 1]])
    assert (a[pairs[ok, 0]] + b[pairs[ok, 1]] == vals[ok]).all(), \
        "not additive"
    return a, b


def pcd_tables() -> dict:
    k = np.arange(98304)
    c = k % 256
    ys = (4 * ((k // 256) % 64))[:, None] + np.arange(4)
    samples = {}
    for which in ("cr", "cb"):
        out = pillow_pcd(ys, c if which == "cb" else np.full_like(c, 156),
                         c if which == "cr" else np.full_like(c, 137))
        ch = 0 if which == "cr" else 2
        v = out[:16384, :, ch].reshape(-1).astype(np.int64)
        pairs = np.stack([ys[:16384].reshape(-1),
                          np.repeat(c[:16384], 4)], -1)
        ok = (v > 0) & (v < 255)
        samples[which] = (pairs[ok], v[ok])
    L, CR = _solve(*samples["cr"], 256, (137, 0))
    L2, CB = _solve(*samples["cb"], 256, (156, L[0] - L[0]))
    shift = L2 - L
    assert np.nanstd(shift) == 0, "the two solves disagree on L"
    CB = CB + np.nanmean(shift)
    # green: L[y] + GR[cr] + GB[cb] over every (cb, cr) pair, four lumas
    cb = k % 256
    cr = (k // 256) % 256
    g = np.zeros((98304, 4), np.int64)
    lumas = np.array([20, 70, 120, 170])
    out = pillow_pcd(np.tile(lumas, (98304, 1)), cb, cr)
    g = out[:65536, :, 1].astype(np.int64)
    s = g - L[lumas][None].astype(np.int64)
    ok = (g > 0) & (g < 255)
    pairs = np.repeat(np.stack([cr[:65536], cb[:65536]], -1), 4, 0)
    GR, GB = _solve(pairs[ok.reshape(-1)], s.reshape(-1)[ok.reshape(-1)],
                    256, (156, 0))
    tables = {"L": L, "CR": CR, "CB": CB, "GR": GR, "GB": GB}
    for key, t in tables.items():
        # entries no unclipped sample fixed: any value that keeps the sum
        # clipped does; take the nearest fixed neighbour's
        idx = np.arange(256)
        good = ~np.isnan(t)
        tables[key] = np.interp(idx, idx[good], t[good]).round().astype(
            np.int16)
    return tables


def check() -> int:
    from wgpu_path_tracing_tpu_torch.utils import pcd, pilmodes

    bad = 0
    everything = np.arange(1 << 24)
    for start in range(0, 1 << 24, 1 << 20):
        v = everything[start:start + (1 << 20)]
        y, cb, cr = v >> 16, (v >> 8) & 255, v & 255
        want = pillow_ycbcr(y, cb, cr)
        got = pilmodes.ycbcr_to_rgb(np.stack([y, cb, cr], -1).astype(
            np.uint8))
        bad += int((want != got).any(-1).sum())
    print("YCbCr -> RGB mismatches:", bad)
    bad_pcd = 0
    blocks = (1 << 24) // 4
    for start in range(0, blocks, 98304):
        k = np.arange(start, min(start + 98304, blocks))
        if len(k) < 98304:
            k = np.concatenate([k, np.zeros(98304 - len(k), np.int64)])
        cbcr = k // 64
        ys = (4 * (k % 64))[:, None] + np.arange(4)
        cb, cr = cbcr % 256, cbcr // 256
        want = pillow_pcd(ys, cb, cr)
        got = pcd.ycc_to_rgb(ys.astype(np.uint8), np.repeat(
            cb[:, None], 4, 1).astype(np.uint8), np.repeat(
            cr[:, None], 4, 1).astype(np.uint8))
        bad_pcd += int((want != got).any(-1).sum())
    print("PhotoYCC -> RGB mismatches:", bad_pcd)
    return 1 if bad or bad_pcd else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true")
    args = ap.parse_args(argv)
    if args.check:
        return check()
    tables = ycbcr_tables()
    tables.update({"pcd_" + k: v for k, v in pcd_tables().items()})
    np.savez_compressed(OUT, **tables)
    print("wrote", OUT, {k: v.shape for k, v in tables.items()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
