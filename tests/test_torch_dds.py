"""The port's DDS reader (``utils/dds.py``) and its block decoders
(``utils/bcn.py``, ``accel/cbvh/bcn_scan.cpp``) against Pillow 12.1.0,
which the JAX package reads LDR images with.

Pillow's C ``bcn`` decoder is not in this repository as source, so each
block format is held to it black-box: tens of thousands of random blocks
(any 16 bytes are a valid BC6H or BC7 block) decode to Pillow's pixels,
in NumPy and in C++. Pillow writes DXT1, DXT3, DXT5, BC2, BC3, BC5 and
uncompressed RGB, RGBA, L and LA; ``tests/torch_image_cases.py`` writes
the other pixel formats (masks, palettes, DX10 R8G8B8A8, ATI1/ATI2, BC4,
signed BC5, BC6H, BC7 in mode 6 and random) and the refused ones.
"""

import hashlib
import json

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from chip_smoke import ASSET_ENV_MAPS, ASSET_TEXTURES, with_sidecar_images
from wgpu_path_tracing_tpu.models import gltf as JG
from wgpu_path_tracing_tpu.ops import env as JENV
from wgpu_path_tracing_tpu.utils import image as JIMAGE
from wgpu_path_tracing_tpu_torch import scene_to_glb, textured_cornell
from wgpu_path_tracing_tpu_torch.accel import native
from wgpu_path_tracing_tpu_torch.models import gltf as G
from wgpu_path_tracing_tpu_torch.ops import env as ENV
from wgpu_path_tracing_tpu_torch.utils import bcn
from wgpu_path_tracing_tpu_torch.utils import image as IMAGE
from tests import torch_image_cases as C

torch.set_num_threads(1)

FIXTURES = np.load(f"{C.LDR_DIR}/pillow_rgba.npz")
DDS_FILES = sorted(n for n in FIXTURES.files if n.endswith(".dds"))
FOURCC = {"BC1": b"DXT1", "BC2": b"DXT3", "BC3": b"DXT5"}
DXGI = {"BC4": 80, "BC5": 83, "BC5S": 84, "BC6H": 95, "BC6HS": 96, "BC7": 98}


def fixture(name: str) -> bytes:
    with open(f"{C.LDR_DIR}/{name}", "rb") as f:
        return f.read()


def block_file(fmt: str, blocks: bytes, w: int, h: int) -> bytes:
    if fmt in FOURCC:
        return C.write_dds(w, h, blocks, fourcc=FOURCC[fmt],
                           flags=C.DDPF["fourcc"])
    return C.write_dds(w, h, blocks, dxgi=DXGI[fmt])


@pytest.mark.parametrize("name", DDS_FILES)
def test_committed_dds_files_equal_pillow(name):
    np.testing.assert_array_equal(C.assert_like_pillow(fixture(name), name),
                                  FIXTURES[name])


@pytest.mark.parametrize("fmt,count", [
    ("BC1", 20000), ("BC2", 8000), ("BC3", 8000), ("BC4", 20000),
    ("BC5", 8000), ("BC5S", 20000), ("BC6H", 24576), ("BC6HS", 24576),
    ("BC7", 24576)])
def test_random_blocks_equal_pillow(fmt, count):
    """Random blocks (BC6H's mode bits spread over all 32 codes, reserved
    ones included) decode to Pillow's pixels in NumPy and in C++: BC1's
    3-colour mode, the alpha ramps, signed BC5 and its blue of 128, every
    BC6H mode unsigned and signed, every BC7 mode with its partitions,
    anchors, p-bits, rotation and the reserved mode's (0, 0, 0, 255)."""
    size = bcn.DECODERS[fmt][0]
    blocks = C.random_blocks(count, size, count + len(fmt), fmt)
    w, h = 4 * 128, 4 * (count // 128)
    data = block_file(fmt, blocks, w, h)
    want = C.pillow_rgba(data)
    pos = len(data) - len(blocks)
    ours = bcn.decode_plain(data, pos, fmt, w, h)
    c = ours.shape[-1]
    np.testing.assert_array_equal(ours, want[..., :c] if c > 1 else
                                  want[..., :1])
    np.testing.assert_array_equal(native.bcn_native(data, pos, fmt, w, h),
                                  ours)


@pytest.mark.parametrize("fmt", sorted(bcn.DECODERS))
@pytest.mark.parametrize("size", [(1, 1), (5, 3), (17, 13), (4, 9)])
def test_clipped_blocks_equal_pillow(fmt, size):
    """Images whose sides are no multiple of 4: each block clipped."""
    w, h = size
    n = ((w + 3) // 4) * ((h + 3) // 4)
    C.assert_like_pillow(block_file(fmt, C.random_blocks(
        n, bcn.DECODERS[fmt][0], w * 31 + h, fmt), w, h))


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA"])
@pytest.mark.parametrize("pixel_format", [None, "DXT1", "DXT3", "DXT5",
                                          "BC2", "BC3", "BC5"])
def test_pillow_written_dds_equals_pillow(mode, pixel_format):
    """Pillow's writer, uncompressed and in each block format it writes
    (BC5 from RGB only)."""
    img = Image.fromarray(C.sample_image(23, 14, 3)).convert(mode)
    try:
        data = C.pillow_bytes(img, "DDS", **(
            {"pixel_format": pixel_format} if pixel_format else {}))
    except OSError:
        assert pixel_format == "BC5" and mode != "RGB" or (
            pixel_format and mode in ("L", "LA"))
        return
    C.assert_like_pillow(data)


RGBA = C.sample_image(9, 7, 21)
VARIANTS = {
    "masks_bgr24": lambda: C.write_dds(9, 7, RGBA[..., 2::-1].tobytes(),
                                       flags=C.DDPF["rgb"], bitcount=24,
                                       masks=(0xFF0000, 0xFF00, 0xFF, 0)),
    "masks_a1r5g5b5": lambda: C.write_dds(
        9, 7, C.to_a1r5g5b5(RGBA).tobytes(), flags=0x41, bitcount=16,
        masks=(0x7C00, 0x3E0, 0x1F, 0x8000)),
    "masks_r10g10b10a2": lambda: C.write_dds(
        9, 7, RGBA.tobytes(), flags=0x41, bitcount=32,
        masks=(0x3FF, 0xFFC00, 0x3FF00000, 0xC0000000)),
    "masks_zero_and_odd": lambda: C.write_dds(
        9, 7, RGBA.tobytes(), flags=0x41, bitcount=32,
        masks=(0, 0b101, 0xF0F0, 0x80000000)),
    "masks_data_cut_short": lambda: C.write_dds(
        9, 7, RGBA.tobytes()[:100], flags=0x40, bitcount=32,
        masks=(0xFF, 0xFF00, 0xFF0000, 0)),
    "masks_under_8_bits": lambda: C.write_dds(
        9, 7, b"", flags=0x40, bitcount=4, masks=(0xF, 0, 0, 0)),
    "luminance_8": lambda: C.write_dds(9, 7, RGBA[..., 0].tobytes(),
                                       flags=C.DDPF["luminance"], bitcount=8),
    "palette_rgba": lambda: C.write_dds(
        9, 7, C.sample_image(256, 1, 22).tobytes() + RGBA[..., 1].tobytes(),
        flags=C.DDPF["palette"], bitcount=8),
    "dx10_r8g8b8a8_typeless": lambda: C.write_dds(9, 7, RGBA.tobytes(),
                                                  dxgi=27),
    "ati2": lambda: C.write_dds(8, 8, C.random_blocks(4, 16, 23),
                                fourcc=b"ATI2", flags=C.DDPF["fourcc"]),
    "bc4u": lambda: C.write_dds(8, 8, C.random_blocks(4, 8, 24),
                                fourcc=b"BC4U", flags=C.DDPF["fourcc"]),
    "dx10_bc1_typeless": lambda: C.write_dds(8, 4, C.random_blocks(2, 8, 25),
                                             dxgi=70),
    "dx10_bc3_unorm": lambda: C.write_dds(8, 4, C.random_blocks(
        2, 16, 26), dxgi=77),
    "dx10_bc7_srgb_mode6": lambda: C.write_dds(8, 8, C.bc7_mode6(
        C.sample_image(8, 8, 27)), dxgi=99),
    "blocks_then_more_data": lambda: C.write_dds(
        4, 4, C.random_blocks(3, 16, 28), dxgi=98),
    "rgb_flag_wins_over_fourcc": lambda: C.write_dds(
        2, 2, bytes(range(16)), flags=0x44, fourcc=b"DXT1", bitcount=32,
        masks=(0xFF, 0xFF00, 0xFF0000, 0)),
}


@pytest.mark.parametrize("case", sorted(VARIANTS))
def test_written_variants_equal_pillow(case):
    """Masks of any width and position (a zero mask 0, data that ends
    early read as zeros); luminance, palette and R8G8B8A8 data; each
    FourCC and DX10 code of a block format; data past the last block; the
    RGB flag taking precedence over a FourCC."""
    C.assert_like_pillow(VARIANTS[case]())


REFUSED = {
    "header_size_100": C.write_dds(4, 4, bytes(16), header_size=100,
                                   dxgi=98),
    "header_cut_short": C.write_dds(4, 4, b"", dxgi=98)[:60],
    "bc7_blocks_cut_short": C.write_dds(8, 8, bytes(50), dxgi=98),
    "dxt1_blocks_cut_short": C.write_dds(4, 4, bytes(7), fourcc=b"DXT1",
                                         flags=C.DDPF["fourcc"]),
    "luminance_cut_short": C.write_dds(4, 4, bytes(15), flags=0x20000,
                                       bitcount=8),
    "luminance_16_without_alpha": C.write_dds(4, 4, bytes(32), flags=0x20000,
                                              bitcount=16),
    "palette_data_cut_short": C.write_dds(4, 4, bytes(1030), flags=0x20,
                                          bitcount=8),
    "dxgi_bc1_srgb": C.write_dds(4, 4, bytes(8), dxgi=72),
    "dxgi_bc4_snorm": C.write_dds(4, 4, bytes(8), dxgi=81),
    "dxgi_float": C.write_dds(4, 4, bytes(256), dxgi=2),
    "fourcc_bc4s": C.write_dds(4, 4, bytes(8), fourcc=b"BC4S",
                               flags=C.DDPF["fourcc"]),
    "fourcc_dxt2": C.write_dds(4, 4, bytes(16), fourcc=b"DXT2",
                               flags=C.DDPF["fourcc"]),
    "no_format_flags": C.write_dds(4, 4, bytes(64)),
    "dx10_header_cut_short": C.write_dds(4, 4, b"", dxgi=98)[:130],
    "zero_height": C.write_dds(4, 0, bytes(16), dxgi=98),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_what_pillow_refuses_raises_naming_the_image(case):
    data = REFUSED[case]
    assert C.pillow_refuses(data)
    C.assert_refused(data, "r.dds")


@settings(max_examples=40, deadline=None)
@given(w=st.integers(1, 40), h=st.integers(1, 20),
       fmt=st.sampled_from(sorted(bcn.DECODERS)), seed=st.integers(0, 2 ** 16))
def test_hypothesis_dds_blocks(w, h, fmt, seed):
    n = ((w + 3) // 4) * ((h + 3) // 4)
    C.assert_like_pillow(block_file(fmt, C.random_blocks(
        n, bcn.DECODERS[fmt][0], seed, fmt), w, h))


def test_a_failed_native_build_raises(monkeypatch):
    def fail(cxx=None):
        raise RuntimeError("g++ failed to build the native library")

    monkeypatch.setattr(native._Lib, "handle", None)
    monkeypatch.setattr(native, "build", fail)
    monkeypatch.setattr(native, "native_available", lambda: True)
    with pytest.raises(RuntimeError, match="failed to build"):
        IMAGE.decode_image_rgba(fixture("bc7_mode6.dds"), "a.dds")


@pytest.mark.parametrize("name", [n for n, _ in ASSET_ENV_MAPS]
                         + ["bc7_mode6.dds", "bc6h_uf16.dds"])
@pytest.mark.parametrize("in_cxx", [True, False])
def test_dds_env_map_equals_jax(name, in_cxx, tmp_path, monkeypatch):
    """``read_png`` and ``load_env_image`` of the card's env maps (a BC1
    DDS and an RLE SGI) and of BC7 and BC6H maps (named .png: the bytes
    decide) equal the JAX package's."""
    if not in_cxx:
        monkeypatch.setattr(native, "native_available", lambda: False)
    path = str(tmp_path / "sky.png")
    with open(path, "wb") as f:
        f.write(fixture(name))
    np.testing.assert_array_equal(IMAGE.read_png(path), JIMAGE.read_png(path))
    np.testing.assert_array_equal(ENV.load_env_image(path),
                                  JENV.load_env_image(path))


@pytest.mark.parametrize("ratio", [0.5, 1.0])
def test_asset_sidecars_build_the_jax_atlas(ratio, tmp_path):
    """``textured_cornell()`` as a .gltf whose four textures are the
    sidecars ``chip_smoke.ASSET_TEXTURES`` (BC7 DDS, BC1 DDS with 1-bit
    alpha, PackBits PSD, QOI): the port's atlas equals the JAX
    ``build_atlas``'s."""
    for name in ASSET_TEXTURES:
        (tmp_path / name).write_bytes(fixture(name))
    path = tmp_path / "textured.gltf"
    path.write_text(with_sidecar_images(scene_to_glb(textured_cornell()),
                                        list(ASSET_TEXTURES)))
    assert len(json.loads(path.read_text())["images"]) == 4
    got, got_rects = G.build_atlas(G.GLTFFile.load(str(path)), ratio)
    want, want_rects = JG.build_atlas(JG.GLTFFile.load(str(path)), ratio)
    np.testing.assert_array_equal(got, want)
    assert got_rects == want_rects


def test_large_bc7_equals_pillows_digest():
    """The 4096x2048 BC7 timing file ``chip_smoke.py`` makes with the test
    suite's writer decodes, in C++, to the array whose SHA-256 Pillow gave
    (``pillow_sha256.json``: the card's host has no Pillow)."""
    with open(f"{C.LDR_DIR}/pillow_sha256.json") as f:
        want = json.load(f)[C.LARGE_BC7]
    got = C.decode_in(True, C.large_bc7())
    assert hashlib.sha256(got.tobytes()).hexdigest() == want
