"""Kodak Photo CD images in NumPy, the pixels Pillow gives.

Pillow's ``PcdImagePlugin`` takes a file whose bytes 2,048 on start with
"PCD_" (and holds 1,539 of them: the orientation byte is the last), and
reads the 768x512 base image at 96 x 2,048 through its C ``pcd`` decoder,
found black-box: each of 256 line pairs is 2,304 bytes, a row of 768
lumas, the next row's 768, then 384 Cb and 384 Cr samples, each chroma
pair shared by a 2x2 block; data that ends before the last pair raises.
The PhotoYCC unpacker ("YCC;P") converts with Pillow's tables (``r =
L[y] + CR[cr]``, ``g = L[y] + GR[cr] + GB[cb]``, ``b = L[y] + CB[cb]``,
each clipped; read out of Pillow by ``tools/pillow_ycc.py``). The
orientation's low bits 1 and 3 rotate the image by 90 and 270 degrees
(``load_end``'s ``rotate(..., expand=True)``: 512x768).
"""

from __future__ import annotations

import numpy as np

from wgpu_path_tracing_tpu_torch.utils.pilmodes import ycc_tables
from wgpu_path_tracing_tpu_torch.utils.sniff import NotThisFormat

W, H = 768, 512
DATA = 96 * 2048
PAIR = 3 * W


def ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """uint8 PhotoYCC samples (one shape) -> (..., 3) uint8 RGB."""
    t = ycc_tables()
    lum = t["pcd_L"][y]
    rgb = np.stack([lum + t["pcd_CR"][cr], lum + t["pcd_GR"][cr]
                    + t["pcd_GB"][cb], lum + t["pcd_CB"][cb]], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def decode_pcd_rgba(data: bytes, name: str = "image") -> np.ndarray:
    """Photo CD bytes -> (H, W, 4) uint8 RGBA, what Pillow's
    ``Image.open(...).convert("RGBA")`` returns."""
    if data[2048:2052] != b"PCD_" or len(data) < 2048 + 1539:
        raise NotThisFormat(f"{name}: not a Photo CD file")
    orientation = data[2048 + 1538] & 3
    if len(data) < DATA + (H // 2) * PAIR:
        raise ValueError(f"{name}: image file is truncated (the Photo CD "
                         "base image ends early)")
    pairs = np.frombuffer(data, np.uint8, (H // 2) * PAIR, DATA).reshape(
        H // 2, PAIR)
    y = pairs[:, :2 * W].reshape(H, W)
    cb = np.repeat(np.repeat(pairs[:, 2 * W:2 * W + W // 2], 2, 0), 2, 1)
    cr = np.repeat(np.repeat(pairs[:, 2 * W + W // 2:], 2, 0), 2, 1)
    out = np.full((H, W, 4), 255, np.uint8)
    out[..., :3] = ycc_to_rgb(y, cb, cr)
    if orientation in (1, 3):
        out = np.ascontiguousarray(np.rot90(out, 1 if orientation == 1 else 3))
    return out
