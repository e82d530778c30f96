"""The port's Photoshop reader (``utils/psd.py``) against Pillow 12.1.0,
which the JAX package reads LDR images with: the merged image of every
colour mode Pillow opens, raw and PackBits.

Pillow cannot write PSD, so ``tests/torch_image_cases.py`` writes every
case: bitmap, gray, duotone, multichannel, indexed (with and without its
palette), RGB with 3, 4 and 5 channels, CMYK and Lab, with resource
blocks and layer sections before the image data. Every case is held
array-equal to ``Image.open(...).convert("RGBA")`` and decoded twice:
with the C++ PackBits loop (``accel/cbvh/image_scan.cpp``'s
``wpt_packbits_rows``) and with its plain Python version.
"""

import struct

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from wgpu_path_tracing_tpu.ops import env as JENV
from wgpu_path_tracing_tpu.utils import image as JIMAGE
from wgpu_path_tracing_tpu_torch.accel import native
from wgpu_path_tracing_tpu_torch.ops import env as ENV
from wgpu_path_tracing_tpu_torch.utils import image as IMAGE
from wgpu_path_tracing_tpu_torch.utils import psd
from tests import torch_image_cases as C

torch.set_num_threads(1)

FIXTURES = np.load(f"{C.LDR_DIR}/pillow_rgba.npz")
PSD_FILES = sorted(n for n in FIXTURES.files if n.endswith(".psd"))
IMG = C.sample_image(23, 13, 31)
BITS = np.packbits(C.sample_image(23, 13, 32, 1)[..., 0] > 120, axis=1)


def fixture(name: str) -> bytes:
    with open(f"{C.LDR_DIR}/{name}", "rb") as f:
        return f.read()


@pytest.mark.parametrize("name", PSD_FILES)
def test_committed_psd_files_equal_pillow(name):
    np.testing.assert_array_equal(C.assert_like_pillow(fixture(name), name),
                                  FIXTURES[name])


def planes(channels: int) -> np.ndarray:
    img = np.concatenate([IMG, IMG[..., ::-1]], -1)[..., :channels]
    return np.moveaxis(img, -1, 0)


# colour mode -> (channels written, bits)
MODES = {"bitmap": (0, 1, 1), "gray": (1, 1, 8), "gray_with_alpha": (1, 2, 8),
         "indexed": (2, 1, 8), "rgb": (3, 3, 8), "rgba": (3, 4, 8),
         "rgb_5_channels": (3, 5, 8), "cmyk": (4, 4, 8),
         "cmyk_5_channels": (4, 5, 8), "multichannel": (7, 3, 8),
         "duotone": (8, 1, 8), "lab": (9, 3, 8), "lab_with_alpha": (9, 4, 8),
         "gray_mode_0": (0, 1, 8)}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("compression", [0, 1], ids=["raw", "packbits"])
def test_every_mode_equals_pillow(mode, compression):
    """Each colour mode Pillow reads, raw and PackBits: bitmap's set bits
    white, CMYK planes inverted, Lab through LittleCMS with alpha 0, RGB
    with four channels RGBA and with five RGB, extra channels unread."""
    ps_mode, c, bits = MODES[mode]
    data = C.write_psd(BITS[None] if bits == 1 else planes(c), ps_mode,
                       bits=bits, compression=compression, width=23,
                       colour_data=C.sample_image(256, 3, 33, 1).tobytes()
                       if mode == "indexed" else b"")
    C.assert_like_pillow(data)


def header(mode=3, bits=8, channels=3, w=2, h=2) -> bytes:
    return b"8BPS" + struct.pack(">H6xHIIHH", 1, channels, h, w, bits, mode)


SECTIONS = struct.pack(">III", 0, 0, 0)


def rows_with_packets_across(n: int) -> bytes:
    """PackBits rows whose last packet runs past the row's end."""
    row = bytes([255 - 13, 7]) + bytes([20]) + bytes(range(21))
    return row * n


def gray_packbits(w: int, h: int, stream: bytes, counts=None) -> bytes:
    """A gray PackBits PSD of the given stream (the counts as given, else
    the stream's length over the rows)."""
    counts = counts or [len(stream) // h] * h
    return header(1, channels=1, w=w, h=h) + SECTIONS + struct.pack(
        f">H{h}H", 1, *counts) + stream


VARIANTS = {
    "indexed_without_palette": lambda: C.write_psd(planes(1), 2),
    "indexed_short_colour_data": lambda: C.write_psd(
        planes(1), 2, compression=1, colour_data=bytes(300)),
    "resources_odd_names_and_data": lambda: C.write_psd(
        planes(3), 3, resources=C.psd_resource(1005, b"ab", b"xyz")
        + C.psd_resource(1039, b"", bytes(5)) + C.psd_resource(
            1060, b"xml", b"<x/>")),
    "layer_section_skipped": lambda: C.write_psd(
        planes(4), 3, compression=1, layers=struct.pack(">I", 12)
        + bytes(12)),
    "empty_layer_info": lambda: C.write_psd(planes(1), 1,
                                            layers=bytes(8)),
    "nop_packets": lambda: gray_packbits(
        3, 2, bytes([0x80, 2, 1, 2, 3, 0x80, 0xFE, 9])),
    "packets_across_rows": lambda: gray_packbits(
        21, 4, rows_with_packets_across(4)),
    "counts_that_lie": lambda: gray_packbits(
        21, 4, rows_with_packets_across(4), [1, 2, 3, 4]),
    "channels_sharing_counts": lambda: C.write_psd(
        planes(3), 3, compression=1)[:-1] + b"\x00\x80",
    "bitmap_odd_width": lambda: C.write_psd(
        np.packbits(C.sample_image(13, 5, 34, 1)[..., 0] > 90, axis=1)[None],
        0, bits=1, width=13, compression=1),
}


@pytest.mark.parametrize("case", sorted(VARIANTS))
def test_written_variants_equal_pillow(case):
    """An indexed image without its 768-byte palette (black, as Pillow
    loads it); resource blocks with odd names and data; a layer section
    skipped by its length; PackBits no-op packets, packets that run past a
    row's end (their rest dropped), row counts that do not match the rows
    (only their sums place the channels), channels decoded as one stream
    from where the counts place them; bitmap at an odd width."""
    C.assert_like_pillow(VARIANTS[case]())


REFUSED = {
    "16_bits": C.write_psd(planes(3).astype(np.uint8), 3, bits=16),
    "mode_5": header(5) + SECTIONS + bytes(2 + 12),
    "too_few_channels": header(4, channels=3) + SECTIONS + bytes(2 + 16),
    "zip_compression": header() + SECTIONS + b"\x00\x02" + bytes(12),
    "raw_cut_short": header() + SECTIONS + b"\x00\x00" + bytes(11),
    "packbits_cut_short": header(1, channels=1) + SECTIONS
    + struct.pack(">HHH", 1, 2, 2) + b"\x01\x05",
    "counts_cut_short": header() + SECTIONS + b"\x00\x01" + bytes(5),
    "sections_cut_short": header() + b"\0\0\0\0\0\0",
    "resource_cut_short": header() + struct.pack(">II", 0, 10) + b"8BIM\x03",
    "version_2": header()[:4] + b"\0\2" + header()[6:] + SECTIONS,
    "zero_width": header(w=0) + SECTIONS + b"\0\0",
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_what_pillow_refuses_raises_naming_the_image(case):
    data = REFUSED[case]
    assert C.pillow_refuses(data)
    C.assert_refused(data, "r.psd")


def packbits_streams():
    rng = np.random.default_rng(9)
    out = []
    for _ in range(400):
        row, rows = int(rng.integers(1, 20)), int(rng.integers(1, 5))
        body = bytearray()
        while len(body) < 2 * row * rows:
            k = int(rng.integers(0, 256))
            body.append(k)
            if k < 128:
                body += rng.integers(0, 256, k + 1, dtype=np.uint8).tobytes()
            elif k != 128:
                body.append(int(rng.integers(0, 256)))
        out.append((bytes(body[:int(rng.integers(0, len(body) + 1))]), 0,
                    row, rows))
    return out


def test_packbits_rows_in_cxx_equals_python():
    statuses = set()
    for data, pos, row, rows in packbits_streams():
        got, status = native.packbits_rows_native(data, pos, row, rows)
        want, want_status = psd.packbits_rows_plain(data, pos, row, rows)
        assert status == want_status
        np.testing.assert_array_equal(got, want)
        statuses.add(status)
    assert statuses == {0, 1}


@settings(max_examples=40, deadline=None)
@given(w=st.integers(1, 40), h=st.integers(1, 20),
       mode=st.sampled_from(sorted(MODES)), compression=st.sampled_from([0,
                                                                         1]),
       seed=st.integers(0, 2 ** 16))
def test_hypothesis_psd(w, h, mode, compression, seed):
    ps_mode, c, bits = MODES[mode]
    img = np.moveaxis(np.resize(C.sample_image(w, h, seed), (h, w, c)), -1, 0)
    if bits == 1:
        img = np.packbits(img[:1] > 100, axis=2)
    data = C.write_psd(img, ps_mode, bits=bits, width=w,
                       compression=compression)
    if C.pillow_refuses(data):  # PackBits counts of channels Pillow skips
        need = {0: 1, 1: 1, 2: 1, 3: 3, 4: 4, 7: 1, 8: 1, 9: 3}[ps_mode]
        assert compression == 1 and c > need
        C.assert_refused(data, "h.psd")
    else:
        C.assert_like_pillow(data)


def test_a_failed_native_build_raises(monkeypatch):
    def fail(cxx=None):
        raise RuntimeError("g++ failed to build the native library")

    monkeypatch.setattr(native._Lib, "handle", None)
    monkeypatch.setattr(native, "build", fail)
    monkeypatch.setattr(native, "native_available", lambda: True)
    with pytest.raises(RuntimeError, match="failed to build"):
        IMAGE.decode_image_rgba(fixture("rgba_packbits.psd"), "a.psd")


@pytest.mark.parametrize("name", ["rgba_packbits.psd", "cmyk_packbits.psd",
                                  "lab_raw.psd", "indexed_packbits.psd"])
@pytest.mark.parametrize("in_cxx", [True, False])
def test_psd_env_map_equals_jax(name, in_cxx, tmp_path, monkeypatch):
    if not in_cxx:
        monkeypatch.setattr(native, "native_available", lambda: False)
    path = str(tmp_path / "sky.png")
    with open(path, "wb") as f:
        f.write(fixture(name))
    np.testing.assert_array_equal(IMAGE.read_png(path), JIMAGE.read_png(path))
    np.testing.assert_array_equal(ENV.load_env_image(path),
                                  JENV.load_env_image(path))


def test_large_psd_equals_its_array():
    """A 1024x512 PackBits RGBA PSD made by the test suite's writer (as
    ``chip_smoke.py`` makes its timing files) decodes to the array it was
    made from, both ways."""
    data, img = C.large_psd(1024, 512)
    for in_cxx in (True, False):
        np.testing.assert_array_equal(C.decode_in(in_cxx, data), img)
