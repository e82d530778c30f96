"""The port's QOI reader (``utils/qoi.py``) against Pillow 12.1.0, whose own
Python decoder the JAX package reads QOI files with.

Every case is held array-equal to ``Image.open(...).convert("RGBA")`` and
decoded twice: with the C++ op loop (``accel/cbvh/image_scan.cpp``'s
``wpt_qoi``) and with its plain Python version. Pillow writes RGB and
RGBA; ``tests/torch_image_cases.py`` writes op streams that show where
Pillow's decoder departs from the specification (alpha moved and hashed in
a 3-channel file, the index's empty slots, runs past the end, other
channel counts, no end marker).
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from wgpu_path_tracing_tpu.ops import env as JENV
from wgpu_path_tracing_tpu.utils import image as JIMAGE
from wgpu_path_tracing_tpu_torch.accel import native
from wgpu_path_tracing_tpu_torch.ops import env as ENV
from wgpu_path_tracing_tpu_torch.utils import image as IMAGE
from wgpu_path_tracing_tpu_torch.utils import gbr, qoi, sniff
from tests import torch_image_cases as C

torch.set_num_threads(1)

FIXTURES = np.load(f"{C.LDR_DIR}/pillow_rgba.npz")
QOI_FILES = sorted(n for n in FIXTURES.files if n.endswith(".qoi"))


def fixture(name: str) -> bytes:
    with open(f"{C.LDR_DIR}/{name}", "rb") as f:
        return f.read()


@pytest.mark.parametrize("name", QOI_FILES)
def test_committed_qoi_files_equal_pillow(name):
    np.testing.assert_array_equal(C.assert_like_pillow(fixture(name), name),
                                  FIXTURES[name])


@pytest.mark.parametrize("mode", ["RGB", "RGBA"])
@pytest.mark.parametrize("size", [(1, 1), (23, 14), (64, 3), (5, 70)])
def test_pillow_written_qoi_equals_pillow(mode, size):
    img = Image.fromarray(C.sample_image(*size, seed=sum(size))).convert(mode)
    C.assert_like_pillow(C.pillow_bytes(img, "QOI"))


def noise(w, h, seed, levels=4):
    """Pixels from a few levels a channel: index hits, diffs and runs."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, levels, (h, w, 4)) * (255 // (levels - 1))
            ).astype(np.uint8)


VARIANTS = {
    "encoded_rgba_noise": lambda: C.write_qoi(
        19, 11, C.qoi_ops(noise(19, 11, 1))),
    "encoded_rgb_as_3_channels": lambda: C.write_qoi(
        17, 9, C.qoi_ops(C.sample_image(17, 9, 2), 3), channels=3),
    "rgba_ops_in_a_3_channel_file": lambda: C.write_qoi(
        13, 7, C.qoi_ops(noise(13, 7, 3)), channels=3),
    "channels_byte_0_reads_rgba": lambda: C.write_qoi(
        9, 5, C.qoi_ops(noise(9, 5, 4)), channels=0),
    "channels_byte_5_reads_rgba": lambda: C.write_qoi(
        9, 5, C.qoi_ops(noise(9, 5, 5)), channels=5),
    "index_of_empty_slots": lambda: C.write_qoi(
        8, 2, bytes(range(0, 64, 4))),
    "run_past_the_end": lambda: C.write_qoi(5, 3, bytes([0x55, 0xC0 | 61])),
    "no_end_marker_colourspace_1": lambda: C.write_qoi(
        6, 4, C.qoi_ops(noise(6, 4, 6)), colourspace=1, end=b""),
    "long_runs_and_luma": lambda: C.write_qoi(
        200, 3, C.qoi_ops(np.repeat(C.sample_image(4, 3, 7), 50, 1))),
    "width_1_as_gbr_prefix": lambda: C.write_qoi(
        1, 30, C.qoi_ops(C.sample_image(1, 30, 8))),
}


@pytest.mark.parametrize("case", sorted(VARIANTS))
def test_written_variants_equal_pillow(case):
    """Op streams of every op; an ``OP_RGBA`` in a 3-channel file moves
    the alpha that later ops and the hash carry; an index slot never
    written reads (0, 0, 0, 0); a run may pass the last pixel; a channels
    byte other than 3 is RGBA; the colour-space byte and the end marker go
    unread. A QOI file of width 1 or 2 passes GIMP brush's test, whose
    ``_open`` then passes it on."""
    data = VARIANTS[case]()
    if case == "width_1_as_gbr_prefix":
        assert sniff.ACCEPT["GBR"](data[:16])
        assert "GBR" in list(sniff.pillow_candidates(data))
        with pytest.raises(sniff.NotThisFormat):
            gbr.decode_gbr_rgba(data, case)
    C.assert_like_pillow(data)


REFUSED = {
    "ops_end_early": C.write_qoi(4, 4, bytes([0x55, 0xC0 | 3])),
    "rgb_op_cut_short": C.write_qoi(2, 1, b"\xfe\x01\x02", end=b""),
    "rgba_op_cut_short": C.write_qoi(2, 1, b"\xff\x01\x02\x03", end=b""),
    "luma_cut_short": C.write_qoi(2, 1, b"\x80", end=b""),
    "header_only": C.write_qoi(3, 3, b"", end=b""),
    "header_cut_short": b"qoif\0\0\0\3\0\0",
    "zero_width": C.write_qoi(0, 3, b"\x55" * 4),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_what_pillow_refuses_raises_naming_the_image(case):
    data = REFUSED[case]
    assert C.pillow_refuses(data)
    C.assert_refused(data, "r.qoi")


def op_streams():
    """Random op streams (ops of every kind, some cut short)."""
    rng = np.random.default_rng(5)
    out = [(fixture(n), 14, int(np.prod(FIXTURES[n].shape[:2])))
           for n in QOI_FILES]
    for _ in range(300):
        ops = bytearray()
        for _ in range(int(rng.integers(1, 40))):
            b = int(rng.integers(0, 256))
            ops.append(b)
            ops += rng.integers(0, 256, {0xFE: 3, 0xFF: 4}.get(
                b, 1 if b >> 6 == 2 else 0), dtype=np.uint8).tobytes()
        out.append((bytes(ops[:int(rng.integers(1, len(ops) + 1))]), 0,
                    int(rng.integers(1, 80))))
    return out


def test_op_loop_in_cxx_equals_python():
    """``wpt_qoi`` and ``qoi.ops_plain`` give the same pixels and status
    on every stream."""
    statuses = set()
    for data, pos, n in op_streams():
        got, status = native.qoi_native(data, pos, n)
        want, want_status = qoi.ops_plain(data, pos, n)
        assert status == want_status
        np.testing.assert_array_equal(got, want)
        statuses.add(status)
    assert statuses == {0, 1}


@settings(max_examples=40, deadline=None)
@given(w=st.integers(1, 40), h=st.integers(1, 20),
       mode=st.sampled_from(["RGB", "RGBA"]), levels=st.sampled_from([2, 4,
                                                                      256]),
       seed=st.integers(0, 2 ** 16))
def test_hypothesis_pillow_qoi(w, h, mode, levels, seed):
    img = C.sample_image(w, h, seed) if levels == 256 else noise(w, h, seed,
                                                                 levels)
    C.assert_like_pillow(C.pillow_bytes(Image.fromarray(img).convert(mode),
                                        "QOI"))


def test_a_failed_native_build_raises(monkeypatch):
    """Where ``g++`` is on ``PATH`` the op loop runs in C++; a library
    that fails to build raises, and the decode does not fall back."""
    def fail(cxx=None):
        raise RuntimeError("g++ failed to build the native library")

    monkeypatch.setattr(native._Lib, "handle", None)
    monkeypatch.setattr(native, "build", fail)
    monkeypatch.setattr(native, "native_available", lambda: True)
    with pytest.raises(RuntimeError, match="failed to build"):
        IMAGE.decode_image_rgba(fixture("pillow_rgba.qoi"), "a.qoi")


@pytest.mark.parametrize("name", ["env.qoi", "pillow_rgba.qoi"])
@pytest.mark.parametrize("in_cxx", [True, False])
def test_qoi_env_map_equals_jax(name, in_cxx, tmp_path, monkeypatch):
    """``read_png`` and ``load_env_image`` of a QOI map (named .png: the
    bytes decide) equal the JAX package's, which reads it with Pillow."""
    if not in_cxx:
        monkeypatch.setattr(native, "native_available", lambda: False)
    path = str(tmp_path / "sky.png")
    with open(path, "wb") as f:
        f.write(fixture(name))
    np.testing.assert_array_equal(IMAGE.read_png(path), JIMAGE.read_png(path))
    np.testing.assert_array_equal(ENV.load_env_image(path),
                                  JENV.load_env_image(path))
