"""The port's arithmetic-coded JPEG decoding (SOF9 sequential, SOF10
progressive: ``utils/jpeg.py::decode_arith_scan`` and its C++ twin
``accel/cbvh/jpeg_scan.cpp::wpt_jpeg_arith_scan``) against Pillow, whose
libjpeg-turbo decodes them with ``jdarith.c``.

Pillow writes no arithmetic-coded file; ``tests/torch_jpeg_cases.py``
codes them as ``jcarith.c`` does (the QM coder, its statistics bins, DAC
conditioning, restart intervals, progressive scripts). Every case is
decoded by both entropy decoders and held array-equal to Pillow's
``convert("RGBA")``; where a file's coefficients are also written with
Huffman tables, Pillow gives both files the same pixels.
"""

import io
import struct

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from tests import torch_jpeg_cases as JC
from tests.test_torch_jpeg import (
    FOUR,
    SAMPLINGS,
    SCRIPT_SAMPLINGS,
    assert_like_pillow,
    decode_in,
    pillow_rgba,
)
from wgpu_path_tracing_tpu_torch.utils import jpeg as JPEG

torch.set_num_threads(1)

SEQUENTIAL = {"gray": [(1, 1)], "4:4:4": [(1, 1)] * 3,
              "4:2:2": [(2, 1), (1, 1), (1, 1)],
              "4:2:0": [(2, 2), (1, 1), (1, 1)], **SAMPLINGS}


@pytest.mark.parametrize("name", sorted(SEQUENTIAL))
def test_arithmetic_sequential_equals_pillow(name):
    """SOF9 at every sampling factor libjpeg accepts, at sizes no multiple
    of the MCU and one and two samples wide, in one interleaved scan and
    one scan a component, with restart intervals of 1 and 3 MCUs; Pillow
    gives the Huffman-coded file of the same coefficients the same
    pixels."""
    sampling = SEQUENTIAL[name]
    for w, h in [(1, 1), (2, 9), (17, 33), (40, 24)]:
        planes = JC.sample_planes(w, h, nc=len(sampling), seed=w)
        for kw in ({}, {"restart": 1}, {"interleaved": False, "restart": 3}):
            data = JC.write_jpeg(planes, sampling, quality=60,
                                 arithmetic=True, **kw)
            assert_like_pillow(data)
        np.testing.assert_array_equal(
            pillow_rgba(data),
            pillow_rgba(JC.write_jpeg(planes, sampling, quality=60, **kw)))


@pytest.mark.parametrize("sampling", sorted(SCRIPT_SAMPLINGS))
@pytest.mark.parametrize("script", sorted(JC.SCRIPTS))
def test_arithmetic_progressive_scripts_equal_pillow(script, sampling):
    """SOF10 under every script of ``JC.SCRIPTS`` (``jcarith.c``'s four
    progressive encoders: DC first and refinement, AC first with Kx
    conditioning, AC refinement with its EOBx), at sizes no multiple of the
    MCU, without restarts and with intervals of 1 and 5 MCUs; the scripts
    that stop early are block-smoothed as Huffman files are."""
    sampling = SCRIPT_SAMPLINGS[sampling]
    nc = len(sampling)
    for w, h in [(8, 8), (17, 33), (40, 40)]:
        planes = JC.sample_planes(w, h, nc=nc, seed=w)
        for restart in (0, 1, 5):
            assert_like_pillow(JC.write_jpeg(
                planes, sampling, quality=60, restart=restart,
                arithmetic=True, scans=JC.script_for(script, nc)))


DACS = {"L1_U2": {(0, 0): 0x21, (0, 1): 0x21},
        "L0_U0": {(0, 0): 0x00, (0, 1): 0x00},
        "L15_U15": {(0, 0): 0xFF, (0, 1): 0xFF},
        "L3_U9_chroma": {(0, 1): 0x93},
        "K1": {(1, 0): 1, (1, 1): 1},
        "K0": {(1, 0): 0, (1, 1): 0},
        "K63": {(1, 0): 63, (1, 1): 63},
        "K255_L5_U12": {(1, 0): 255, (0, 0): 0xC5, (1, 1): 20}}


@pytest.mark.parametrize("dac", sorted(DACS))
def test_dac_conditioning_equals_pillow(dac):
    """A DAC segment's conditioning (``jdmarker.c::get_dac``): the DC
    bounds L and U pick each difference's context, Kx the AC magnitude
    bins; in sequential and progressive files, with restarts."""
    planes = JC.sample_planes(31, 22, seed=4)
    sampling = [(2, 2), (1, 1), (1, 1)]
    for kw in ({}, {"restart": 2},
               {"scans": JC.script_for("refine_al2", 3), "restart": 3}):
        assert_like_pillow(JC.write_jpeg(planes, sampling, quality=80,
                                         arithmetic=True, dac=DACS[dac],
                                         **kw))


HEADERS = {"adobe_rgb": {"app": "adobe", "adobe_transform": 0},
           "rgb_ids": {"app": "none", "ids": [82, 71, 66]},
           "other_ids": {"app": "none", "ids": [5, 6, 7]},
           "jfif_rgb_ids": {"ids": [82, 71, 66]}}


@pytest.mark.parametrize("header", sorted(HEADERS) + sorted(
    f"four_{k}" for k in FOUR))
def test_arithmetic_colour_spaces_as_libjpeg_guesses(header):
    """Three components as RGB or YCbCr and four as CMYK or YCCK, as
    libjpeg guesses from the markers and ids, in sequential and
    progressive arithmetic-coded files."""
    nc = 4 if header.startswith("four_") else 3
    kw = FOUR[header[5:]] if nc == 4 else HEADERS[header]
    planes = JC.sample_planes(19, 11, nc=nc)
    for sampling in ([(1, 1)] * nc, [(2, 2)] + [(1, 1)] * (nc - 1)):
        assert_like_pillow(JC.write_jpeg(planes, sampling, arithmetic=True,
                                         restart=2, **kw))
        assert_like_pillow(JC.write_jpeg(planes, sampling, arithmetic=True,
                                         scans=JC.script_for("simple", nc),
                                         **kw))


def test_arithmetic_block_smoothing_as_huffman(monkeypatch):
    """``smoothing_ok`` does not depend on the entropy coder: each script
    of ``JC.SCRIPTS`` smooths the same components of the arithmetic-coded
    file as of the Huffman-coded one (those of ``JC.SMOOTHED``), and
    Pillow agrees with each."""
    calls = []
    smooth = JPEG.smooth_blocks
    monkeypatch.setattr(JPEG, "smooth_blocks",
                        lambda coef, c, rows: calls.append(c.id)
                        or smooth(coef, c, rows))
    planes = JC.sample_planes(40, 40, seed=3)
    sampling = [(2, 2), (1, 1), (1, 1)]
    for name in JC.SCRIPTS:
        seen = []
        for arithmetic in (False, True):
            data = JC.write_jpeg(planes, sampling, quality=60,
                                 arithmetic=arithmetic,
                                 scans=JC.script_for(name, 3))
            calls.clear()
            np.testing.assert_array_equal(JPEG.decode_jpeg_rgba(data, name),
                                          pillow_rgba(data), err_msg=name)
            seen.append(sorted(calls))
        assert seen[0] == seen[1], name
        assert bool(seen[1]) == (name in JC.SMOOTHED), name


@pytest.mark.parametrize("kind", ["sequential", "progressive"])
def test_corrupt_arithmetic_data_decodes_as_pillow(kind):
    """Bytes of the entropy-coded data changed at random (never to or
    after 0xFF, which would make a marker): libjpeg warns where a
    magnitude or a run overflows and leaves the rest of the restart
    interval undecoded, Pillow returns the image, and both decoders give
    Pillow's array."""
    rng = np.random.default_rng(7 if kind == "sequential" else 8)
    scans = JC.script_for("simple", 3) if kind == "progressive" else None
    data = JC.write_jpeg(JC.sample_planes(40, 24), [(2, 2), (1, 1), (1, 1)],
                         arithmetic=True, restart=4, scans=scans)
    coded = entropy_coded_bytes(data)
    for _ in range(8):
        bad = bytearray(data)
        for p in rng.choice(coded, 4):
            if 0xFF not in (bad[p - 1], bad[p]):
                bad[p] = int(rng.integers(0, 255))
        assert_like_pillow(bytes(bad))


def entropy_coded_bytes(data: bytes) -> np.ndarray:
    """The positions of every scan's entropy-coded bytes (after each SOS
    segment, up to the next marker other than RSTn)."""
    out, pos = [], 2
    while pos < len(data):
        marker = data[pos + 1]
        if marker == 0xD9:
            break
        (length,) = struct.unpack(">H", data[pos + 2:pos + 4])
        pos += 2 + length
        if marker != 0xDA:
            continue
        end = pos
        while not (data[end] == 0xFF and data[end + 1] not in (
                0x00, *range(0xD0, 0xD8))):
            end += 1
        out.extend(range(pos, end))
        pos = end
    return np.asarray(out)


def test_pillow_refuses_large_arithmetic_files_the_port_reads():
    """Pillow hands libjpeg a file in blocks of 64 KiB, and ``jdarith.c``
    cannot wait for the next block: Pillow refuses an arithmetic-coded
    file whose data runs past the first (so the JAX package reads none).
    Handed the whole file in one block it decodes it, and the port gives
    that array through both decoders; a Huffman file is the same either
    way."""
    planes = JC.sample_planes(200, 200, noise=60)
    data = JC.write_jpeg(planes, [(1, 1)] * 3, quality=95, arithmetic=True)
    assert len(data) > 65536
    with pytest.raises(OSError):
        pillow_rgba(data)
    want = JC.pillow_whole_rgba(data)
    for in_cxx in (True, False):
        np.testing.assert_array_equal(decode_in(in_cxx, data, "big.jpg"),
                                      want)
    huffman = JC.write_jpeg(planes, [(1, 1)] * 3, quality=95)
    np.testing.assert_array_equal(JC.pillow_whole_rgba(huffman),
                                  pillow_rgba(huffman))
    np.testing.assert_array_equal(want, pillow_rgba(huffman))


@settings(max_examples=10, deadline=None)
@given(w=st.integers(1, 48), h=st.integers(1, 48),
       sampling=st.sampled_from(sorted(SCRIPT_SAMPLINGS)),
       script=st.sampled_from([None] + sorted(JC.SCRIPTS)),
       restart=st.sampled_from([0, 1, 3]), quality=st.integers(5, 100),
       k=st.integers(0, 63), seed=st.integers(0, 2**16))
def test_hypothesis_arithmetic(w, h, sampling, script, restart, quality, k,
                               seed):
    """Sizes, sampling factors, restart intervals, scripts (None:
    sequential) and an AC conditioning Kx, each file decoded by C++ and by
    Python and held to Pillow."""
    factors = SCRIPT_SAMPLINGS[sampling]
    nc = len(factors)
    scans = JC.script_for(script, nc) if script else None
    assert_like_pillow(JC.write_jpeg(
        JC.sample_planes(w, h, nc=nc, seed=seed), factors, quality=quality,
        restart=restart, arithmetic=True, scans=scans,
        dac={(1, 0): k, (1, 1): k}))


def test_arithmetic_sof10_needs_no_table_segment():
    """An arithmetic-coded file has no DHT segment (its statistics start
    at 0), and table numbers past 3 are legal there: both decoders equal
    Pillow on a file whose scans name DC and AC tables 9 and 14."""
    planes = JC.sample_planes(21, 13)
    data = JC.write_jpeg(planes, [(2, 1), (1, 1), (1, 1)], arithmetic=True,
                         dac={(0, 0): 0x10, (1, 0): 7})
    assert b"\xff\xc4" not in data
    sos = data.index(b"\xff\xda")
    bad = bytearray(data)
    for k in range(3):  # each component's Td, Ta
        bad[sos + 6 + 2 * k] = 0x9E
    # The DAC segment conditions tables 0; tables 9 and 14 keep the
    # defaults, so the data decodes as a different image, as in Pillow.
    assert_like_pillow(bytes(bad))
    assert Image.open(io.BytesIO(bytes(bad))).mode == "RGB"
