"""The port's BMP, DIB, ICO and CUR reader (``utils/bmp.py``) against
Pillow 12.1.0, which the JAX package reads LDR images with.

Every case is held array-equal to ``Image.open(...).convert("RGBA")``, and
decoded twice: with the C++ RLE8/RLE4 loop (``accel/cbvh/image_scan.cpp``)
and with its plain Python version. Pillow writes 1, 8 and 24-bit BMP and
DIB and icons with PNG frames; ``tests/torch_image_cases.py`` writes the
rest: RLE8 and RLE4 with their escapes, OS/2 and V2-V5 headers, bit
fields, 16 and 32 bits, top-down rows, short and gray palettes, icons with
BMP frames and AND masks, cursors. Pillow's own quirks are copied, each
pinned by a case: the delta escape that skips two bytes before its steps,
the odd absolute RLE4 run that drops its last pixel, palettes of gray
ramps dropped, 32-bit alpha only where masks or a cursor at byte 22 say
so, icons that open their largest frame of the least colour depth.
"""

import struct

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from wgpu_path_tracing_tpu.ops import env as JENV
from wgpu_path_tracing_tpu_torch.accel import native
from wgpu_path_tracing_tpu_torch.ops import env as ENV
from wgpu_path_tracing_tpu_torch.utils import bmp
from tests import torch_image_cases as C

torch.set_num_threads(1)

FIXTURES = np.load(f"{C.LDR_DIR}/pillow_rgba.npz")
BMP_FILES = sorted(n for n in FIXTURES.files
                   if n.endswith((".bmp", ".dib", ".ico", ".cur")))


def fixture(name: str) -> bytes:
    with open(f"{C.LDR_DIR}/{name}", "rb") as f:
        return f.read()


@pytest.mark.parametrize("name", BMP_FILES)
def test_committed_bmp_files_equal_pillow(name):
    data = fixture(name)
    np.testing.assert_array_equal(C.assert_like_pillow(data, name),
                                  FIXTURES[name])


@pytest.mark.parametrize("fmt", ["BMP", "DIB"])
@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "P", "1"])
def test_pillow_written_bmp_equals_pillow(fmt, mode):
    """Pillow writes RGBA as 32-bit BGRX and reads it back without alpha."""
    img = Image.fromarray(C.sample_image(21, 13, 2)).convert(mode)
    got = C.assert_like_pillow(C.pillow_bytes(img, fmt))
    if mode == "RGBA":
        assert (got[..., 3] == 255).all()


PAL16 = C.sample_image(16, 1, 5, 3)[0]
IDX = (C.sample_image(10, 6, 6, 1)[..., 0] >> 4).astype(np.uint8)
RGB = C.sample_image(10, 6, 7, 3)


def os2_offset_quirk() -> bytes:
    """An OS/2 file whose data offset names the palette's start: Pillow
    moves it on by four bytes an entry though OS/2 entries take three."""
    data = C.write_bmp(IDX, 4, header=12, palette=PAL16,
                       data_offset=14 + 12 + 64)
    return data[:10] + struct.pack("<I", 26) + data[14:]


def rle(idx, code, stream, **kw):
    return C.write_bmp(idx, 8 if code == 1 else 4, compression=code,
                       palette=kw.pop("palette", PAL16), rle_data=stream, **kw)


WRITTEN = {
    "rle8": lambda: rle(IDX, 1, C.rle8_rows(IDX[::-1])),
    "rle8_no_absolute_runs": lambda: rle(IDX, 1, C.rle8_rows(IDX[::-1],
                                                               False)),
    "rle8_top_down": lambda: rle(IDX, 1, C.rle8_rows(IDX), top_down=True),
    "rle4": lambda: rle(IDX, 2, C.rle4_rows(IDX[::-1])),
    # 2 pixels of 5, a delta that skips 9 9 and moves 1 right, end of line,
    # a row of 7s, end of bitmap.
    "rle8_delta_escape": lambda: rle(
        np.zeros((2, 4), np.uint8), 1,
        bytes([2, 5, 0, 2, 9, 9, 1, 0, 0, 0, 4, 7, 0, 1])),
    # An absolute run of 3 in RLE4 reads one byte (two pixels), then the
    # 16-bit alignment skips a byte; a run clipped at the row's end.
    "rle4_odd_absolute_run": lambda: rle(
        np.zeros((1, 4), np.uint8), 2,
        bytes([0, 3, 0x12, 0x30, 2, 0x45, 0, 0, 0, 1])),
    "rle8_gray_palette": lambda: rle(
        IDX, 1, C.rle8_rows(IDX[::-1]),
        palette=np.repeat(np.arange(16, dtype=np.uint8)[:, None], 3, 1)),
    "os2_palette8": lambda: C.write_bmp(IDX, 8, header=12, palette=PAL16),
    "os2_rgb24": lambda: C.write_bmp(RGB[..., ::-1], 24, header=12),
    "os2_offset_quirk": os2_offset_quirk,
    "header64_rgb24": lambda: C.write_bmp(RGB[..., ::-1], 24, header=64),
    "top_down_rgb24": lambda: C.write_bmp(RGB[..., ::-1], 24, top_down=True),
    "rgb555_raw": lambda: C.write_bmp(
        C.to_a1r5g5b5(C.sample_image(10, 6, 8)) & 0x7F, 16),
    "bitfields555": lambda: C.write_bmp(
        C.to_a1r5g5b5(C.sample_image(10, 6, 8)), 16, compression=3,
        masks=(0x7C00, 0x3E0, 0x1F)),
    "bitfields24": lambda: C.write_bmp(RGB[..., ::-1], 24, compression=3,
                                       masks=(0xFF0000, 0xFF00, 0xFF)),
    "v3_alpha_mask": lambda: C.write_bmp(
        C.sample_image(10, 6, 9)[..., [2, 1, 0, 3]], 32, header=56,
        compression=3, masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000)),
    "v2_bgrx": lambda: C.write_bmp(
        C.sample_image(10, 6, 9)[..., [2, 1, 0, 3]], 32, header=52,
        compression=3, masks=(0xFF0000, 0xFF00, 0xFF)),
    "raw32_drops_alpha": lambda: C.write_bmp(
        C.sample_image(10, 6, 9)[..., [2, 1, 0, 3]], 32),
    "short_palette8": lambda: C.write_bmp(IDX, 8, palette=PAL16[:3]),
    "palette1_colours": lambda: C.write_bmp(
        (IDX > 7).astype(np.uint8), 1, palette=PAL16[:2]),
    "palette1_black_white": lambda: C.write_bmp(
        (IDX > 7).astype(np.uint8), 1,
        palette=np.array([[0, 0, 0], [255, 255, 255]], np.uint8)),
    # A black-and-white palette on 8-bit data: Pillow reads the bytes'
    # bits as a 1-bit image.
    "palette8_black_white": lambda: C.write_bmp(
        IDX * 17, 8, palette=np.array([[0, 0, 0], [255, 255, 255]], np.uint8)),
    # A 16-entry gray ramp on 4-bit data: Pillow reads one byte a pixel.
    "palette4_gray_ramp": lambda: C.write_bmp(
        IDX[:, :4], 4, palette=np.repeat(np.arange(16, dtype=np.uint8)[:, None],
                                         3, 1)),
    "last_row_padding_missing": lambda: C.write_bmp(RGB[:, :3, ::-1], 24)[:-3],
}


@pytest.mark.parametrize("case", sorted(WRITTEN))
def test_written_variants_equal_pillow(case):
    C.assert_like_pillow(WRITTEN[case]())


@pytest.mark.parametrize("masks", [m for b, m in bmp.MASK_MODES if b == 32],
                         ids=lambda m: "_".join(f"{v:x}" for v in m))
def test_every_32bit_mask_layout_equals_pillow(masks):
    """The eight 32-bit ``BI_BITFIELDS`` layouts Pillow knows, in a V5
    header (the all-zero masks read as BGRA)."""
    px = C.sample_image(9, 5, 10)
    C.assert_like_pillow(C.write_bmp(px, 32, header=124, compression=3,
                                     masks=masks))


def icon(frames, cursor=False):
    return C.write_icon(frames, cursor)


ICONS = {
    "pillow_png_frames": lambda: C.pillow_bytes(
        Image.fromarray(C.sample_image(48, 48, 11)), "ICO",
        sizes=[(16, 16), (48, 48), (32, 32)]),
    "pillow_bmp_frames": lambda: C.pillow_bytes(
        Image.fromarray(C.sample_image(32, 32, 12)), "ICO",
        sizes=[(16, 16), (32, 32)], bitmap_format="bmp"),
    "bmp24_and_mask": lambda: icon([(C.icon_dib(C.sample_image(12, 12, 13),
                                                24), 12, 12, 0, 24, 1)]),
    "palette4_and_mask": lambda: icon([(C.icon_dib(
        C.sample_image(8, 8, 14), 4, PAL16, IDX[:, :8].repeat(2, 0)[:8]),
        8, 8, 16, 4, 1)]),
    # Of two frames of one size, Pillow opens the one of less depth.
    "least_depth_of_the_largest": lambda: icon([
        (C.icon_dib(C.sample_image(16, 16, 15), 32), 16, 16, 0, 32, 1),
        (C.icon_dib(C.sample_image(16, 16, 16), 24), 16, 16, 0, 24, 1),
        (C.icon_dib(C.sample_image(8, 8, 17), 32), 8, 8, 0, 32, 1)]),
    # The directory says 32 bits over a 24-bit frame: alpha from every
    # fourth byte from the pixel data on, as Pillow takes it (into the
    # next frame).
    "directory_32_over_24": lambda: icon([
        (C.icon_dib(C.sample_image(16, 16, 18), 24), 16, 16, 0, 32, 1),
        (C.icon_dib(C.sample_image(8, 8, 19), 32), 8, 8, 0, 32, 1)]),
    "directory_0_over_32": lambda: icon([(C.icon_dib(
        C.sample_image(8, 8, 19), 32), 8, 8, 0, 0, 1)]),
    "png_frame": lambda: icon([(C.pillow_bytes(C.sample_image(8, 6, 20),
                                               "PNG"), 8, 6, 0, 32, 1)]),
    # A cursor at byte 22 keeps its 32-bit alpha; it opens its first entry
    # unless a later one is both wider and taller.
    "cursor_at_22": lambda: icon([(C.icon_dib(C.sample_image(16, 16, 21),
                                              32), 16, 16, 0, 1, 2)], True),
    "cursor_wider_and_taller": lambda: icon([
        (C.icon_dib(C.sample_image(8, 8, 22), 32), 8, 8, 0, 1, 1),
        (C.icon_dib(C.sample_image(16, 8, 23), 24), 16, 8, 0, 1, 1),
        (C.icon_dib(C.sample_image(12, 12, 24), 32), 12, 12, 0, 1, 1)],
        True),
}


@pytest.mark.parametrize("case", sorted(ICONS))
def test_icons_and_cursors_equal_pillow(case):
    C.assert_like_pillow(ICONS[case]())


def refused_cases():
    px = C.sample_image(4, 2, 25)
    base = C.write_bmp(px[..., :3], 24)

    def with_compression(code):
        data = bytearray(base)
        data[30:34] = struct.pack("<I", code)
        return bytes(data)

    return {
        "bi_jpeg": with_compression(4),
        "bi_png": with_compression(5),
        "bi_alphabitfields": with_compression(6),
        "unknown_masks": C.write_bmp(px, 32, compression=3, masks=(1, 2, 3)),
        "depth_2": bytes(base[:28]) + struct.pack("<H", 2) + bytes(base[30:]),
        "header_of_20_bytes": bytes(base[:14]) + struct.pack("<I", 20)
        + bytes(base[18:]),
        "rle_on_24_bits": C.write_bmp(px[..., :3], 24, compression=1,
                                      rle_data=bytes([8, 1, 0, 1])),
        "rle_in_mode_1": rle(np.zeros((1, 4), np.uint8), 1, bytes([4, 1, 0, 1]),
                             palette=np.array([[0, 0, 0], [255] * 3], np.uint8)),
        "rle_ends_early": rle(IDX, 1, bytes([4, 1, 0, 0, 0, 1])),
        "rle_delta_cut_short": rle(IDX, 1, bytes([4, 1, 0, 2, 0, 0])),
        "palette_of_300": C.write_bmp(IDX, 8, palette=np.tile(PAL16, (19, 1))[
            :300]),
        "data_truncated": base[:-8],
    }


REFUSED = refused_cases()


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_what_pillow_refuses_raises_naming_the_image(case):
    """BI_JPEG and BI_PNG (Pillow 12.1.0 opens neither), BI_ALPHABITFIELDS
    (not in its table), unknown masks and depths, RLE outside 8-bit
    palettes, data that stops short."""
    data = REFUSED[case]
    assert C.pillow_refuses(data)
    C.assert_refused(data, "r.bmp")


def rle_streams():
    rng = np.random.default_rng(4)
    out = []
    for name in ("roughness_rle8.bmp", "rle4.bmp"):
        data = fixture(name)
        bm = bmp.parse_bitmap(data, 14, struct.unpack_from("<I", data, 10)[0],
                              name)
        out.append((data, bm.offset, bm.rle4, bm.width, bm.width * bm.height))
    # A delta escape whose steps are cut short.
    out.append((bytes([1, 3, 0, 2, 5, 5, 1]), 0, False, 4, 8))
    for _ in range(600):
        n = int(rng.integers(0, 60))
        body = bytes(int(v) % 4 if i % 2 == 0 and rng.random() < 0.6 else int(v)
                     for i, v in enumerate(rng.integers(0, 256, n)))
        w = int(rng.integers(1, 12))
        out.append((body, int(rng.integers(0, 2)), bool(rng.random() < 0.5),
                    w, w * int(rng.integers(1, 5))))
    return out


def test_rle_loop_in_cxx_equals_python():
    """``wpt_bmp_rle`` and ``bmp.rle_plain`` give the same bytes and status
    on every stream, good or bad."""
    statuses, lengths = set(), set()
    for data, pos, rle4, w, count in rle_streams():
        got = native.bmp_rle_native(data, pos, rle4, w, count)
        assert got == bmp.rle_plain(data, pos, rle4, w, count)
        statuses.add(got[1])
        lengths.add(len(got[0]) == count)
    assert statuses == {0, 1} and lengths == {True, False}


@settings(max_examples=40, deadline=None)
@given(w=st.integers(1, 40), h=st.integers(1, 20),
       mode=st.sampled_from(["RGB", "L", "P", "1"]),
       fmt=st.sampled_from(["BMP", "DIB"]), seed=st.integers(0, 2 ** 16))
def test_hypothesis_pillow_bmp(w, h, mode, fmt, seed):
    img = Image.fromarray(C.sample_image(w, h, seed)).convert(mode)
    C.assert_like_pillow(C.pillow_bytes(img, fmt))


@pytest.mark.parametrize("name", ["rgb24.bmp", "roughness_rle8.bmp",
                                  "icon.ico", "pointer.cur"])
def test_bmp_env_map_equals_jax(name, tmp_path):
    path = str(tmp_path / "sky.png")
    with open(path, "wb") as f:
        f.write(fixture(name))
    np.testing.assert_array_equal(ENV.load_env_image(path),
                                  JENV.load_env_image(path))
