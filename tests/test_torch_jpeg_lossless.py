"""The port's lossless JPEG decoding (SOF3: ``utils/jpeg.py::
decode_lossless_scan``, ``lossless_first_rows`` and ``undifference``, with
their C++ twins in ``accel/cbvh/jpeg_scan.cpp``) against Pillow, whose
libjpeg-turbo decodes them (``jdlhuff.c``, ``jddiffct.c``,
``jdlossls.c``); and the frames Pillow refuses, which the port refuses
too, naming the image.

Pillow writes no lossless file; ``tests/torch_jpeg_cases.py::
write_lossless_jpeg`` codes them as ISO 10918-1 Annex H says. Every case
is decoded by both entropy decoders and held array-equal to Pillow's
``convert("RGBA")``.
"""

import struct

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from tests import torch_jpeg_cases as JC
from tests.test_torch_jpeg import (
    SAMPLINGS,
    assert_like_pillow,
    assert_refused_like_pillow,
    pillow_jpeg,
    pillow_rgba,
    photo,
)

torch.set_num_threads(1)

LAYOUTS = {"gray": ([(1, 1)], True), "rgb": ([(1, 1)] * 3, True),
           "rgb_420": ([(2, 2), (1, 1), (1, 1)], True),
           "rgb_mixed_apart": ([(1, 2), (1, 1), (2, 1)], False),
           "rgb_apart": ([(1, 1)] * 3, False)}


@pytest.mark.parametrize("pt", [0, 3])
@pytest.mark.parametrize("predictor", range(1, 8))
def test_lossless_predictors_equal_pillow(predictor, pt):
    """Predictors 1-7 (Annex H: the first row from the left, 2^(7 - Pt)
    first, the first column from above) and the point transform's shift
    on output, gray and RGB, interleaved and one scan a component, with
    restart intervals of 1 and 2 MCU rows (the prediction restarts), at
    sizes no multiple of the MCU. Where nothing is sampled down, the
    image is the source shifted by Pt."""
    for w, h in [(1, 1), (7, 5), (23, 17)]:
        for name, (sampling, interleaved) in LAYOUTS.items():
            planes = JC.sample_planes(w, h, nc=len(sampling), seed=w + h)
            for rows in (0, 1, 2):
                data = JC.write_lossless_jpeg(
                    planes, sampling, predictor=predictor, pt=pt,
                    restart_rows=rows, interleaved=interleaved)
                assert_like_pillow(data)
            if all(f == (1, 1) for f in sampling):
                got = pillow_rgba(data)[..., :len(sampling)]
                want = np.stack(planes, -1) >> pt << pt
                np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("name", sorted(SAMPLINGS))
def test_lossless_sampling_factors_equal_pillow(name):
    """Every sampling factor libjpeg accepts, upsampled by replication (its
    fancy upsampling needs DCT blocks), in one interleaved scan and one
    scan a component, with restarts."""
    for w, h in [(1, 1), (2, 9), (17, 33)]:
        planes = JC.sample_planes(w, h, seed=w)
        for kw in ({}, {"restart_rows": 1},
                   {"interleaved": False, "restart_rows": 2}):
            assert_like_pillow(JC.write_lossless_jpeg(
                planes, SAMPLINGS[name], predictor=5, **kw))


LOSSLESS_HEADERS = {
    # libjpeg-turbo guesses RGB for a lossless frame without markers,
    # whatever its ids, and decodes CMYK as it is
    "ids_123": ({"app": "none"}, None), "rgb_ids": (
        {"app": "none", "ids": [82, 71, 66]}, None),
    "other_ids": ({"app": "none", "ids": [5, 6, 7]}, None),
    "adobe_rgb": ({"app": "adobe", "adobe_transform": 0}, None),
    "cmyk": ({"app": "none"}, None),
    "cmyk_adobe": ({"app": "adobe", "adobe_transform": 0}, None),
    "cmyk_jfif": ({"app": "jfif"}, None),
    # a guess of YCbCr or YCCK asks for a colour conversion, which
    # libjpeg-turbo does not do on a lossless frame
    "jfif": ({"app": "jfif"}, "a lossless YCbCr JPEG"),
    "adobe_ycc": ({"app": "adobe", "adobe_transform": 1},
                  "a lossless YCbCr JPEG"),
    "adobe_transform_2": ({"app": "adobe", "adobe_transform": 2},
                          "a lossless YCbCr JPEG"),
    "ycck": ({"app": "adobe", "adobe_transform": 2},
             "a lossless YCCK JPEG")}


@pytest.mark.parametrize("header", sorted(LOSSLESS_HEADERS))
def test_lossless_colour_space_as_libjpeg_guesses(header):
    """Three and four components under each header: decoded as RGB or
    CMYK (Pillow's "CMYK;I" under an Adobe marker), equal to Pillow; or,
    where libjpeg would convert YCbCr or YCCK, refused by Pillow and by
    the port."""
    kw, refused = LOSSLESS_HEADERS[header]
    nc = 4 if header.startswith(("cmyk", "ycck")) else 3
    planes = JC.sample_planes(19, 11, nc=nc)
    for sampling in ([(1, 1)] * nc, [(2, 2)] + [(1, 1)] * (nc - 1)):
        data = JC.write_lossless_jpeg(planes, sampling, predictor=1, **kw)
        if refused:
            assert_refused_like_pillow(data, NotImplementedError, refused)
        else:
            assert_like_pillow(data)


@pytest.mark.parametrize("predictor", [1, 4, 6, 7])
def test_lossless_differences_wrap_mod_2_16(predictor):
    """Differences of any value, 32768 (category 16, no extra bits)
    among them, over the MCU-padded grid: each sample is its difference
    plus its prediction mod 2^16, shifted by Pt and cut to 8 bits, as
    ``jdlossls.c`` and Pillow have it."""
    rng = np.random.default_rng(predictor)
    planes = JC.sample_planes(13, 9)
    for pt, sampling in ((0, [(1, 1)] * 3), (5, [(2, 1), (1, 1), (1, 1)])):
        grids = [(9, 14), (9, 7), (9, 7)] if pt else [(9, 13)] * 3
        diffs = [rng.integers(-40000, 40000, g) for g in grids]
        for d in diffs:
            d[rng.random(d.shape) < 0.1] = 32768
        assert_like_pillow(JC.write_lossless_jpeg(
            planes, sampling, predictor=predictor, pt=pt, diffs=diffs,
            restart_rows=3))


@pytest.mark.parametrize("factors", [(1, 2), (1, 3), (2, 2), (1, 4)])
def test_lossless_restart_inside_an_imcu_row_as_libjpeg(factors):
    """One component sampled v > 1 in a scan of its own, restarting every
    row: libjpeg-turbo decodes an iMCU row's v rows before it
    undifferences them, so a restart inside one takes effect at its first
    row, not at the row it falls on. The source is not what comes back,
    and the port gives what Pillow gives."""
    plane = JC.sample_planes(23, 17, nc=1)[0]
    for rows in (1, 3):
        data = JC.write_lossless_jpeg([plane], [factors], predictor=4,
                                      restart_rows=rows)
        assert_like_pillow(data)
    assert not np.array_equal(pillow_rgba(
        JC.write_lossless_jpeg([plane], [factors], predictor=4,
                               restart_rows=1))[..., 0], plane)


def _with_dri(data: bytes, interval: int) -> bytes:
    i = data.index(b"\xff\xdd")
    return data[:i + 4] + struct.pack(">H", interval) + data[i + 6:]


def _scan_params(data: bytes, ss: int, se: int, ahal: int) -> bytes:
    j = data.index(b"\xff\xda")
    k = j + 5 + 2 * data[j + 4]
    return data[:k] + bytes([ss, se, ahal]) + data[k + 3:]


def _relabel(data: bytes, old: int, new: int) -> bytes:
    i = data.index(bytes([0xFF, old]))
    return data[:i + 1] + bytes([new]) + data[i + 2:]


def _sof_byte(data: bytes, marker: int, offset: int, value: int) -> bytes:
    i = data.index(bytes([0xFF, marker]))
    out = bytearray(data)
    out[i + offset] = value
    return bytes(out)


def _refused_cases() -> dict:
    """{case: (bytes, exception, message)} of frames Pillow refuses."""
    baseline = pillow_jpeg(photo(24, 16), quality=90)
    planes = JC.sample_planes(13, 9)
    lossless = JC.write_lossless_jpeg(planes, restart_rows=1)
    gray = JC.write_lossless_jpeg(JC.sample_planes(8, 8, nc=1))
    h3 = JC.write_jpeg(JC.sample_planes(16, 16), [(3, 1), (1, 1), (1, 1)])
    # the second component sampled 2 against 3: a fractional ratio
    frac = {kind: _sof_byte(data, m, 14, 0x21) for kind, data, m in (
        ("huffman", h3, 0xC0),
        ("arithmetic", JC.write_jpeg(JC.sample_planes(16, 16),
                                     [(3, 1), (1, 1), (1, 1)],
                                     arithmetic=True), 0xC9),
        ("lossless", JC.write_lossless_jpeg(JC.sample_planes(16, 16),
                                            [(3, 1), (1, 1), (1, 1)]),
         0xC3))}
    dht = gray.index(b"\xff\xc4")
    n_sym = sum(gray[dht + 5:dht + 21])
    symbol_17 = bytearray(gray)
    symbol_17[dht + 21 + n_sym - 1] = 17
    out = {
        "sof11_arithmetic_lossless": (
            JC.write_lossless_jpeg(planes, arithmetic=True,
                                   restart_rows=2),
            NotImplementedError, "arithmetic-coded lossless"),
        "12_bit": (_sof_byte(baseline, 0xC0, 4, 12), NotImplementedError,
                   "12-bit"),
        "12_bit_lossless": (_sof_byte(gray, 0xC3, 4, 12),
                            NotImplementedError, "12-bit"),
        "16_bit_lossless": (_sof_byte(gray, 0xC3, 4, 16),
                            NotImplementedError, "16-bit"),
        "dnl_height": (_sof_byte(_sof_byte(baseline, 0xC0, 5, 0), 0xC0, 6,
                                 0), NotImplementedError, "a JPEG whose "
                       "height comes in a DNL marker"),
        "lossless_restart_not_whole_rows": (
            _with_dri(lossless, 14), ValueError, "a lossless JPEG's restart"
            " interval"),
        "lossless_predictor_0": (_scan_params(lossless, 0, 0, 0),
                                 ValueError, "bad lossless JPEG scan"),
        "lossless_predictor_8": (_scan_params(lossless, 8, 0, 0),
                                 ValueError, "bad lossless JPEG scan"),
        "lossless_se_1": (_scan_params(lossless, 1, 1, 0), ValueError,
                          "bad lossless JPEG scan"),
        "lossless_ah_1": (_scan_params(lossless, 1, 0, 0x10), ValueError,
                          "bad lossless JPEG scan"),
        "lossless_pt_8": (_scan_params(lossless, 1, 0, 8), ValueError,
                          "bad lossless JPEG scan"),
        "lossless_symbol_17": (bytes(symbol_17), ValueError,
                               "bad Huffman table"),
        "dac_l_above_u": (JC.write_jpeg(JC.sample_planes(16, 16, nc=1),
                                        [(1, 1)], arithmetic=True,
                                        dac={(0, 0): 0x23}),
                          ValueError, "bad DAC segment"),
    }
    for marker, what in ((0xC5, "hierarchical"), (0xC6, "hierarchical "
                                                 "progressive"),
                         (0xC7, "hierarchical lossless"),
                         (0xCD, "arithmetic-coded hierarchical"),
                         (0xCE, "arithmetic-coded hierarchical progressive"),
                         (0xCF, "arithmetic-coded hierarchical lossless")):
        out[f"sof_{marker:x}"] = (_relabel(baseline, 0xC0, marker),
                                  NotImplementedError, what)
    for kind, data in frac.items():
        out[f"fractional_{kind}"] = (data, NotImplementedError,
                                     "fractional sampling ratios")
    return out


REFUSED = sorted(_refused_cases())


@pytest.mark.parametrize("case", REFUSED)
def test_frames_pillow_refuses_raise_naming_the_image(case):
    """What stays a raise, each where Pillow refuses the same bytes:
    arithmetic-coded lossless frames (SOF11, well formed by the writer's QM
    coder; libjpeg-turbo has no decoder for them), hierarchical frames
    (SOF5-7, SOF13-15), samples of other than 8 bits, a height left to a
    DNL marker, fractional sampling ratios in every frame kind, and
    lossless scans libjpeg-turbo rejects (a restart interval of no whole
    MCU rows, a predictor outside 1-7, Se or Ah not 0, Pt of 8, a
    Huffman symbol above 16); a DAC segment with L above U."""
    data, exc, match = _refused_cases()[case]
    assert_refused_like_pillow(data, exc, match)


@settings(max_examples=12, deadline=None)
@given(w=st.integers(1, 40), h=st.integers(1, 40),
       layout=st.sampled_from(sorted(LAYOUTS)), predictor=st.integers(1, 7),
       pt=st.integers(0, 7), rows=st.integers(0, 3),
       seed=st.integers(0, 2**16))
def test_hypothesis_lossless(w, h, layout, predictor, pt, rows, seed):
    """Sizes, layouts, predictors, point transforms and restart intervals,
    each file decoded by C++ and by Python and held to Pillow."""
    sampling, interleaved = LAYOUTS[layout]
    assert_like_pillow(JC.write_lossless_jpeg(
        JC.sample_planes(w, h, nc=len(sampling), seed=seed), sampling,
        predictor=predictor, pt=pt, restart_rows=rows,
        interleaved=interleaved))
