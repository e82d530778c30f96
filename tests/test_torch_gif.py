"""The port's GIF reader (``utils/gif.py``) against Pillow 12.1.0, which
the JAX package reads LDR images with: the first frame, as Pillow's
``GifImagePlugin`` loads it and ``convert("RGBA")`` converts it.

Every case is held array-equal to ``Image.open(...).convert("RGBA")``, and
decoded twice: with the C++ LZW loop (``accel/cbvh/image_scan.cpp``'s
``wpt_gif_lzw``) and with its plain Python version. The files come from
Pillow's writer and from this suite's (``tests/torch_image_cases.py::
write_gif``), which reaches every minimum code size, interlace, local and
global palettes, the identity gray ramp, indices past the palette, frame
offsets inside and past the logical screen, and a table that fills to 12
bits without a clear code. What Pillow refuses, the port refuses.
"""

import io

import numpy as np
import pytest
import torch
from PIL import Image

from wgpu_path_tracing_tpu.models import gltf as JG
from wgpu_path_tracing_tpu.ops import env as JENV
from wgpu_path_tracing_tpu.utils import image as JIMAGE
from wgpu_path_tracing_tpu_torch.accel import native
from wgpu_path_tracing_tpu_torch.ops import env as ENV
from wgpu_path_tracing_tpu_torch.utils import gif
from wgpu_path_tracing_tpu_torch.utils import image as IMAGE
from tests import torch_image_cases as C

torch.set_num_threads(1)

FIXTURES = np.load(f"{C.LDR_DIR}/pillow_rgba.npz")
GIF_FILES = sorted(n for n in FIXTURES.files if n.endswith(".gif"))
IDX = (C.sample_image(13, 11, 3, 1)[..., 0] >> 4).astype(np.uint8)
PALETTE = C.sample_image(16, 1, 4, 3)[0]


def fixture(name: str) -> bytes:
    with open(f"{C.LDR_DIR}/{name}", "rb") as f:
        return f.read()


def pillow_mode(data: bytes) -> str:
    with Image.open(io.BytesIO(data)) as im:
        return im.mode


@pytest.mark.parametrize("name", GIF_FILES)
def test_committed_gif_files_equal_pillow(name):
    """The files under ``tests/ldr`` decode to ``pillow_rgba.npz``, which
    Pillow here still gives."""
    np.testing.assert_array_equal(C.assert_like_pillow(fixture(name), name),
                                  FIXTURES[name])


@pytest.mark.parametrize("bits", range(13))
def test_every_minimum_code_size(bits):
    """Minimum code sizes 0-12 (at 0 and 1 Pillow's table never widens, so
    the codes are literal; at 9-12 the indices are bytes under wide
    codes)."""
    top = 1 if bits == 0 else 1 << min(bits, 8)
    rng = np.random.default_rng(bits)
    idx = rng.integers(0, top, (9, 14)).astype(np.uint8)
    idx[:3] = idx[0, 0]  # runs, for table entries
    want = C.assert_like_pillow(C.write_gif(idx, bits=bits,
                                            global_palette=C.sample_image(
                                                256, 1, 5, 3)[0]))
    assert want.shape == (9, 14, 4)


def pack_codes(codes: list, width: int) -> bytes:
    acc = n = 0
    out = bytearray()
    for c in codes:
        acc |= c << n
        n += width
        while n >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            n -= 8
    return C._sub_blocks(bytes(out) + (bytes([acc]) if n else b""))


def test_wide_literals_keep_their_low_byte():
    """At minimum code size 9 a literal may pass 255: Pillow keeps its low
    byte (491 is 235), in the pixel and in the table entry it starts."""
    head = C.write_gif(np.zeros((1, 3), np.uint8), bits=9)[:13 + 10]
    data = head + b"\x09" + pack_codes([512, 491, 300, 514, 513], 10) + b";"
    got = C.assert_like_pillow(data)
    assert got[0, :, 0].tolist() == [235, 44, 235]


def test_a_full_table_without_a_clear_code():
    """4,096 random bytes fill the table (codes of 12 bits, no clear code):
    the decode goes on with it full."""
    rng = np.random.default_rng(14)
    idx = rng.integers(0, 256, (64, 64)).astype(np.uint8)
    stats: dict = {}
    C.gif_lzw(idx.reshape(-1), 8, stats=stats)
    assert stats["width"] == 12 and stats["codes"] > 4096 - 258 + 1
    C.assert_like_pillow(C.write_gif(idx, bits=8, global_palette=rng.integers(
        0, 256, (256, 3))))


@pytest.mark.parametrize("height", [1, 2, 3, 4, 5, 8, 9, 17, 33])
def test_interlace(height):
    """Interlaced rows (0::8, 4::8, 2::4, 1::2) at heights that end in each
    pass."""
    idx = (C.sample_image(7, height, height, 1)[..., 0] >> 4).astype(np.uint8)
    got = C.assert_like_pillow(C.write_gif(idx, interlace=True,
                                           global_palette=PALETTE))
    np.testing.assert_array_equal(got[..., :3], PALETTE[idx])


def test_local_palette_over_global():
    got = C.assert_like_pillow(C.write_gif(IDX, global_palette=PALETTE[::-1],
                                           local_palette=PALETTE))
    np.testing.assert_array_equal(got[..., :3], PALETTE[IDX])


RAMP = np.repeat(np.arange(8, dtype=np.uint8)[:, None], 3, 1)


@pytest.mark.parametrize("where", ["global", "local"])
def test_identity_gray_ramp_is_mode_l(where):
    """A palette that is the identity gray ramp makes the mode "L": an
    index is its own gray, past the ramp too (a 2-entry ramp gives 5 for
    index 5)."""
    idx = np.array([[0, 1, 5, 2, 9, 200]], np.uint8)
    kw = {f"{where}_palette": RAMP[:2]}
    data = C.write_gif(idx, bits=8, **kw)
    assert pillow_mode(data) == "L"
    got = C.assert_like_pillow(data)
    np.testing.assert_array_equal(got[0, :, 0], idx[0])
    assert (got[..., 3] == 255).all()


def test_no_palette_is_mode_l():
    data = C.write_gif(IDX)
    assert pillow_mode(data) == "L"
    np.testing.assert_array_equal(C.assert_like_pillow(data)[..., 0], IDX)


def test_local_gray_ramp_under_a_global_palette():
    """A local identity ramp makes the mode "L", but Pillow still puts the
    global palette on the image: the indices look up the global palette,
    and with a transparency index ``convert("RGBA")`` raises."""
    data = C.write_gif(IDX, global_palette=PALETTE, local_palette=RAMP[:2])
    assert pillow_mode(data) == "L"
    np.testing.assert_array_equal(C.assert_like_pillow(data)[..., :3],
                                  PALETTE[IDX])
    refused = C.write_gif(IDX, global_palette=PALETTE, local_palette=RAMP[:2],
                          transparency=3)
    assert C.pillow_refuses(refused)
    C.assert_refused(refused, "t.gif")


def test_indices_past_the_palette_are_black():
    """In mode "P" an index past the palette's entries is opaque black (a
    2-entry palette, indices 2 and 5)."""
    idx = np.array([[0, 1, 2, 5]], np.uint8)
    data = C.write_gif(idx, bits=3, global_palette=PALETTE[:2])
    assert pillow_mode(data) == "P"
    got = C.assert_like_pillow(data)
    assert got[0, 2].tolist() == [0, 0, 0, 255] == got[0, 3].tolist()


@pytest.mark.parametrize("index", [0, 3, 15, 200])
@pytest.mark.parametrize("palette", [True, False], ids=["p", "l"])
def test_transparency_index(index, palette):
    """The graphic control extension's transparency makes that index's
    alpha 0 under ``convert("RGBA")``; its RGB is the palette's (or the
    index's gray, or black past the palette)."""
    idx = IDX.copy()
    idx[0, :4] = index
    data = C.write_gif(idx, bits=8, transparency=index,
                       global_palette=PALETTE if palette else None)
    got = C.assert_like_pillow(data)
    assert (got[..., 3] == np.where(idx == index, 0, 255)).all()


@pytest.mark.parametrize("transparency", [None, 7])
def test_frame_inside_the_screen(transparency):
    """Outside the frame's extent the image holds the transparency index
    if there is one, else index 0."""
    data = C.write_gif(IDX, screen=(30, 20), offset=(9, 4),
                       global_palette=PALETTE, transparency=transparency)
    got = C.assert_like_pillow(data)
    fill = 0 if transparency is None else transparency
    assert got.shape == (20, 30, 4)
    np.testing.assert_array_equal(got[0, 0, :3], PALETTE[fill])
    assert got[0, 0, 3] == (255 if transparency is None else 0)


@pytest.mark.parametrize("offset", [(5, 0), (0, 7), (20, 30)])
def test_frame_past_the_screen_grows_the_image(offset):
    data = C.write_gif(IDX, screen=(10, 8), offset=offset,
                       global_palette=PALETTE)
    got = C.assert_like_pillow(data)
    assert got.shape == (max(8, offset[1] + 11), max(10, offset[0] + 13), 4)


@pytest.mark.parametrize("interlace", [False, True])
@pytest.mark.parametrize("mode", ["P", "L", "RGB", "1", "LA", "RGBA"])
def test_pillow_written_gif(mode, interlace):
    img = Image.fromarray(C.sample_image(23, 14, 7)).convert(mode)
    C.assert_like_pillow(C.pillow_bytes(img, "GIF", interlace=interlace))


def test_pillow_animation_first_frame():
    frames = [Image.fromarray(C.sample_image(21, 13, k, 3)).convert("P")
              for k in range(3)]
    buf = io.BytesIO()
    frames[0].save(buf, "GIF", save_all=True, append_images=frames[1:],
                   duration=40, loop=0, transparency=2, disposal=2)
    C.assert_like_pillow(buf.getvalue())


@pytest.mark.parametrize("extension", [
    b"!\xfe\x05hello\x03abc\x00",  # comments
    b"!\xff\x0bNETSCAPE2.0\x03\x01\x05\x00\x00",  # looping
    b"!\xf9\x04\x00\x0a\x00\x07\x00",  # control without transparency
    b"\x00\x07!\x01\x03abc\x00",  # stray bytes, a plain-text extension
], ids=["comment", "netscape", "control", "stray"])
def test_extensions_before_the_frame(extension):
    C.assert_like_pillow(C.write_gif(IDX, global_palette=PALETTE,
                                     extensions=extension))


# The minimum code size byte of ``write_gif(..., global_palette=PALETTE)``
# with no extension: after the header, 16 palette entries and the image
# descriptor.
CODE_SIZE_AT = 13 + 3 * 16 + 10


def test_a_zero_length_sub_block_does_not_end_the_data():
    data = C.write_gif(IDX, global_palette=PALETTE)
    at = CODE_SIZE_AT + 1
    patched = data[:at] + b"\x00" + data[at:]
    C.assert_like_pillow(patched)


def _refusals() -> dict:
    good = C.write_gif(IDX, global_palette=PALETTE, interlace=True)
    at = CODE_SIZE_AT
    return {
        "truncated_lzw": good[:-8],
        "end_code_early": good[:at + 1] + C.gif_lzw(IDX[:5].reshape(-1),
                                                    good[at]) + b";",
        "code_past_the_table": good[:at + 1] + bytes([2, 0xFF, 0xFF, 0])
        + b";",
        "code_size_13": good[:at] + b"\x0d" + good[at + 1:],
        "zero_size_frame": C.write_gif(np.zeros((0, 4), np.uint8),
                                       screen=(4, 4), global_palette=PALETTE),
        "no_image": b"GIF89a" + bytes(20),
        "trailer_only": C.write_gif(IDX, global_palette=PALETTE)[:13 + 48]
        + b";",
        "header_cut": b"GIF89a\x04\x00",
        # After an extension's first sub-block Pillow reads sub-blocks to
        # a terminator: an empty extension has none left, so it takes the
        # image descriptor's "," as a block size.
        "empty_extension": C.write_gif(IDX, global_palette=PALETTE,
                                       extensions=b"!\x01\x00"),
        "descriptor_cut": good[:at - 4],
    }


REFUSALS = _refusals()


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_what_pillow_refuses_the_port_refuses(case):
    """Truncated LZW data, an end code before the last pixel, a code past
    the table, a code size over 12, an empty frame, no image, a header or
    descriptor cut short: Pillow raises, and so does the port (``ValueError``
    naming the file; "not an image Pillow can identify" where Pillow's
    ``_open`` passes the bytes on and no later format takes them)."""
    data = REFUSALS[case]
    assert C.pillow_refuses(data), case
    C.assert_refused(data, "r.gif")


@pytest.mark.parametrize("seed", range(10))
def test_the_lzw_loops_agree_on_random_data(seed):
    """``wpt_gif_lzw`` and ``lzw_plain`` on random code streams (every code
    size, interlaced or not): the same indices, pixels written and
    status."""
    rng = np.random.default_rng(seed)
    bits = int(rng.integers(0, 13))
    w, h = int(rng.integers(1, 30)), int(rng.integers(1, 30))
    body = rng.integers(0, 256, int(rng.integers(0, 400)), dtype=np.uint8)
    if seed % 2:
        top = max(1, 1 << min(bits, 8))
        body = np.frombuffer(C.gif_lzw(rng.integers(0, top, w * h), bits),
                             np.uint8)
    data = body.tobytes()
    for interlace in (False, True):
        want = gif.lzw_plain(data, bits, w, h, interlace)
        got = native.gif_lzw_native(data, bits, w, h, interlace)
        assert got[1:] == want[1:]
        np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.parametrize("name", ["transparent.gif", "interlaced_local.gif"])
def test_a_failed_native_build_raises(monkeypatch, name):
    """Where ``g++`` is on ``PATH`` the LZW loop runs in C++; a library that
    fails to build raises, and the decode does not fall back to Python."""
    def fail(cxx=None):
        raise RuntimeError("g++ failed to build the native library")

    monkeypatch.setattr(native._Lib, "handle", None)
    monkeypatch.setattr(native, "build", fail)
    monkeypatch.setattr(native, "native_available", lambda: True)
    with pytest.raises(RuntimeError, match="failed to build"):
        IMAGE.decode_image_rgba(fixture(name), name)


# --- against the JAX package --------------------------------------------------


@pytest.mark.parametrize("name", ["env.gif", "transparent.gif",
                                  "interlaced_local.gif",
                                  "gray_ramp_past.gif"])
@pytest.mark.parametrize("in_cxx", [True, False])
def test_gif_maps_equal_jax(name, in_cxx, tmp_path, monkeypatch):
    """``read_png`` and ``load_env_image`` of a GIF map (named .png: the
    bytes decide) equal the JAX package's, which reads it with Pillow."""
    if not in_cxx:
        monkeypatch.setattr(native, "native_available", lambda: False)
    path = str(tmp_path / "sky.png")
    with open(path, "wb") as f:
        f.write(fixture(name))
    np.testing.assert_array_equal(IMAGE.read_png(path), JIMAGE.read_png(path))
    np.testing.assert_array_equal(ENV.load_env_image(path),
                                  JENV.load_env_image(path))


@pytest.mark.parametrize("name", GIF_FILES)
def test_texture_decode_equals_jax(name):
    """The JAX glTF loader's ``_decode_image`` (Pillow's RGBA) of each
    committed GIF equals ``decode_image_rgba``."""
    data = fixture(name)
    np.testing.assert_array_equal(IMAGE.decode_image_rgba(data, name),
                                  JG._decode_image(data))
