"""The denoiser (``ops/denoise.py``) against the JAX package's, and the
properties ``tests/test_denoise.py`` pins there, on the port.

Each filter level runs ``atrous_level_plain`` here (K9's plain version).
Tolerances against the JAX functions on the same numpy inputs:

* ``atrous_filter`` and ``denoise_image``: rtol 3e-5, atol 1e-6. XLA:CPU's
  ``pow`` and ``exp`` differ from PyTorch's CPU ones by a few ulp, and it
  fuses multiply-adds where PyTorch rounds each operation: a weight one ulp
  off moves a filtered colour by about 1e-6 of itself a level (measured
  7e-6 after five levels);
* ``variance_blend``: rtol 1e-6, atol 1e-7 (XLA fuses a few of its
  products and sums into multiply-adds: a few ulp);
* ``primary_aovs``: rtol/atol 1e-5, except on edge pixels where the two
  packages' centre rays meet different triangles (at most 8 of 1,024);
  there the scalar oracle (``tests/oracle.py``) on the port's own ray gives
  the port's guides.
"""

import numpy as np
import pytest
import torch

from tests.oracle import Oracle
from wgpu_path_tracing_tpu import Renderer as JRenderer
from wgpu_path_tracing_tpu import RenderConfig as JConfig
from wgpu_path_tracing_tpu.models import procedural as JP
from wgpu_path_tracing_tpu.ops import denoise as JD
import wgpu_path_tracing_tpu_torch as P
from wgpu_path_tracing_tpu_torch.debug import modes as M
from wgpu_path_tracing_tpu_torch.ops import denoise as D
from wgpu_path_tracing_tpu_torch.render.pipeline import camera_device

# One thread a worker: PyTorch's OpenMP teams spin against each other under
# the suite's parallel workers.
torch.set_num_threads(1)

RTOL, ATOL = 3e-5, 1e-6


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _flat_guides(h, w, found=True):
    normal = np.zeros((h, w, 3), np.float32)
    normal[..., 2] = 1.0
    depth = np.ones((h, w), np.float32)
    fnd = np.full((h, w), found, bool)
    return normal, depth, fnd


def _filter(color, normal, depth, fnd, **kw):
    return D.atrous_filter(T(color), T(normal), T(depth), T(fnd),
                           **kw).numpy()


def _random_case(seed, h=40, w=48):
    """Noisy colour, two normal planes, random depths and 15% misses
    (zero normal and depth), as a render's guides carry them."""
    rng = np.random.default_rng(seed)
    color = (rng.random((h, w, 3)) * 1.5).astype(np.float32)
    normal = rng.normal(size=(h, w, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    normal[:, : w // 2] = [0.0, 0.0, 1.0]
    depth = rng.uniform(1.0, 4.0, (h, w)).astype(np.float32)
    found = rng.random((h, w)) > 0.15
    normal[~found] = 0.0
    depth[~found] = 0.0
    return color, normal, depth, found


# --- the JAX suite's properties (tests/test_denoise.py) on the port ----------

def test_constant_preserved():
    h = w = 32
    color = np.full((h, w, 3), 0.37, np.float32)
    out = _filter(color, *_flat_guides(h, w))
    np.testing.assert_allclose(out, color, atol=1e-5)


def test_flat_noise_reduced():
    h = w = 48
    rng = np.random.default_rng(7)
    truth = np.full((h, w, 3), 0.5, np.float32)
    noisy = truth + rng.normal(0, 0.2, truth.shape).astype(np.float32)
    out = _filter(noisy, *_flat_guides(h, w))
    rmse_in = float(np.sqrt(np.mean((noisy - truth) ** 2)))
    rmse_out = float(np.sqrt(np.mean((out - truth) ** 2)))
    assert rmse_out < rmse_in / 3.0, (rmse_in, rmse_out)


def test_normal_edge_preserved():
    h = w = 48
    rng = np.random.default_rng(3)
    truth = np.zeros((h, w, 3), np.float32)
    truth[:, : w // 2] = 1.0
    truth[:, w // 2:] = 0.1
    noisy = truth + rng.normal(0, 0.1, truth.shape).astype(np.float32)
    normal, depth, fnd = _flat_guides(h, w)
    normal[:, w // 2:] = [1.0, 0.0, 0.0]
    out = _filter(noisy, normal, depth, fnd)
    left = out[:, : w // 2].mean(axis=(0, 1))
    right = out[:, w // 2:].mean(axis=(0, 1))
    assert np.all(np.abs(left - 1.0) < 0.05), left
    assert np.all(np.abs(right - 0.1) < 0.05), right
    assert out[:, w // 2 - 1].mean() > 0.8
    assert out[:, w // 2].mean() < 0.3


def test_miss_segment_isolated():
    h = w = 32
    rng = np.random.default_rng(11)
    color = np.zeros((h, w, 3), np.float32)
    color[: h // 2] = 0.5 + rng.normal(0, 0.2, (h // 2, w, 3)).astype(
        np.float32)
    normal, depth, fnd = _flat_guides(h, w)
    fnd[h // 2:] = False
    normal[h // 2:] = 0.0
    depth[h // 2:] = 0.0
    out = _filter(color, normal, depth, fnd)
    np.testing.assert_allclose(out[h // 2:], 0.0, atol=1e-7)
    assert abs(out[: h // 2].mean() - 0.5) < 0.05


def test_demodulation_keeps_texture():
    h = w = 48
    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[:h, :w]
    checker = np.where(((yy // 8 + xx // 8) % 2) == 0, 0.8, 0.2).astype(
        np.float32)
    albedo = np.repeat(checker[..., None], 3, axis=-1)
    illum = np.full((h, w, 3), 0.6, np.float32)
    noisy = albedo * (illum + rng.normal(0, 0.15, illum.shape).astype(
        np.float32))
    normal, depth, fnd = _flat_guides(h, w)
    aovs = {"albedo": albedo.reshape(-1, 3), "normal": normal.reshape(-1, 3),
            "depth": depth.reshape(-1), "found": fnd.reshape(-1)}
    out = D.denoise_image(noisy, aovs, device="cpu")
    truth = albedo * illum
    rmse_in = float(np.sqrt(np.mean((noisy - truth) ** 2)))
    rmse_out = float(np.sqrt(np.mean((out - truth) ** 2)))
    assert rmse_out < rmse_in / 2.5, (rmse_in, rmse_out)
    assert out[4, 4].mean() / max(out[4, 12].mean(), 1e-6) > 3.0


def test_variance_blend_asymptotics():
    rng = np.random.default_rng(5)
    h = w = 32
    truth = np.full((h, w, 3), 0.5, np.float32)
    noisy = truth + rng.normal(0, 0.2, truth.shape).astype(np.float32)
    out = D.variance_blend(T(noisy), T(truth)).numpy()
    err_blend = float(np.abs(out - truth).mean())
    err_raw = float(np.abs(noisy - truth).mean())
    assert err_blend < 0.25 * err_raw, (err_blend, err_raw)
    yy = np.linspace(0, 1, h, dtype=np.float32)[:, None, None]
    biased = truth + 0.1 * yy
    out2 = D.variance_blend(T(truth), T(biased)).numpy()
    assert float(np.abs(out2 - truth).mean()) < 0.02
    out3 = D.variance_blend(T(truth), T(biased), 1.0, 0.0).numpy()
    np.testing.assert_allclose(out3, biased, atol=1e-6)


# --- against the JAX functions on the same inputs ----------------------------

@pytest.mark.parametrize("levels", [1, 3, 5])
def test_atrous_filter_matches_jax(levels):
    case = _random_case(levels)
    want = np.asarray(JD.atrous_filter(*case, levels=levels))
    np.testing.assert_allclose(_filter(*case, levels=levels), want,
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("sigmas", [dict(sigma_normal=64.0),
                                    dict(sigma_depth=0.5),
                                    dict(sigma_lum=2.0)])
def test_atrous_filter_sigmas_match_jax(sigmas):
    case = _random_case(9)
    want = np.asarray(JD.atrous_filter(*case, **sigmas))
    np.testing.assert_allclose(_filter(*case, **sigmas), want, rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("k_cap", [1.0, 0.2, 0.0])
def test_variance_blend_matches_jax(k_cap):
    color, *_ = _random_case(4)
    filt = (color * 0.9 + 0.01).astype(np.float32)
    want = np.asarray(JD.variance_blend(color, filt, 1.0, k_cap))
    np.testing.assert_allclose(
        D.variance_blend(T(color), T(filt), 1.0, k_cap).numpy(), want,
        rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("blend,spp", [(True, None), (True, 64),
                                       (False, None)])
def test_denoise_image_matches_jax(blend, spp):
    color, normal, depth, found = _random_case(6)
    h, w, _ = color.shape
    rng = np.random.default_rng(8)
    aovs = {"albedo": rng.uniform(0, 1, (h * w, 3)).astype(np.float32),
            "normal": normal.reshape(-1, 3), "depth": depth.reshape(-1),
            "found": found.reshape(-1)}
    want = JD.denoise_image(color, aovs, blend=blend, spp=spp)
    got = D.denoise_image(color, aovs, blend=blend, spp=spp,
                          device="cpu")
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL * 10)


def test_denoise_image_runs_on_the_card_by_default(monkeypatch):
    """NumPy guides and no ``device``: ``denoise_image`` asks for the card,
    as every entry point of the port does, and raises where there is none
    instead of running on the CPU."""
    color, normal, depth, found = _random_case(6)
    h, w, _ = color.shape
    aovs = {"albedo": np.ones((h * w, 3), np.float32),
            "normal": normal.reshape(-1, 3), "depth": depth.reshape(-1),
            "found": found.reshape(-1)}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="'cuda'.*not available"):
        D.denoise_image(color, aovs)
    assert D.denoise_image(color, aovs, device="cpu").shape == (h, w, 3)


@pytest.mark.parametrize("p", [1, 2, 8])
def test_pad2_is_an_edge_pad(p):
    a = np.random.default_rng(p).random((5, 7, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        D._pad2(T(a), p).numpy(),
        np.pad(a, [(p, p), (p, p), (0, 0)], mode="edge"))


def test_filter_is_its_levels_and_uses_no_convolution(monkeypatch):
    """``atrous_filter`` is the variance seed and ``levels`` calls of the
    level at spacings 1, 2, 4, ...; it reaches no convolution (cuDNN would
    take float32 as TF32)."""
    def refuse(*args, **kwargs):
        raise AssertionError("a convolution")

    for name in ("conv2d", "conv1d", "conv3d"):
        monkeypatch.setattr(torch.nn.functional, name, refuse)
    steps = []

    def level(*args, **kw):
        steps.append(args[5])
        return D.atrous_level_plain(*args, **kw)

    case = [T(x) for x in _random_case(2)]
    out = D.atrous_filter(*case, levels=3, level=level)
    assert steps == [1, 2, 4]
    np.testing.assert_array_equal(out.numpy(),
                                  D.atrous_filter(*case, levels=3).numpy())


def test_level_wrappers_take_cpu_tensors_to_the_plain_version_only():
    case = [T(x) for x in _random_case(3)]
    var = torch.zeros(case[2].shape)
    with pytest.raises(ValueError, match="CUDA"):
        D.atrous_level_cuda(*case, var, 1)
    with pytest.raises(ValueError, match="found"):
        D.atrous_level(case[0], case[1], case[2], case[3].float(), var, 1)


def _oracle_guides(oracle, ro, rd):
    hit = oracle.scene_intersect(ro, rd)
    if hit is None:
        return False, np.ones(3), np.zeros(3), 0.0
    alb = hit["albedo"] + hit["emission"] * hit["emissive_strength"]
    return True, alb, hit["normal"], hit["t"]


@pytest.mark.parametrize("name,lens,aperture",
                         [("cornell_box", 0, 0.0), ("cornell_box", 3, 0.1),
                          ("textured_cornell", 0, 0.0),
                          ("material_test_box", 2, 0.05)])
def test_primary_aovs_match_jax(name, lens, aperture):
    w = h = 32
    j = JRenderer(JConfig(width=w, height=h))
    j.load_scene(getattr(JP, name)())
    j.camera.aperture = aperture
    p = P.Renderer(P.RenderConfig(width=w, height=h), device="cpu")
    p.load_scene(getattr(P, name)())
    p.camera.aperture = aperture
    want = j.aovs(lens_samples=lens)
    got = p.aovs(lens_samples=lens)
    apart = np.asarray(want["found"]) != got["found"].numpy()
    for key in ("albedo", "normal", "depth"):
        a, b = np.asarray(want[key]), got[key].numpy()
        off = ~np.isclose(a, b, rtol=1e-5, atol=1e-5)
        apart |= off if off.ndim == 1 else off.any(-1)
    assert apart.sum() <= 8, np.nonzero(apart)
    if apart.any():
        assert lens == 0  # the centre rays meet another triangle there
        ro, rd = M._center_rays(camera_device(p.camera.as_pytree(), w, h),
                                w, h)
        oracle = Oracle(getattr(P, name)(), p.camera.as_pytree(), w, h)
        for k in np.nonzero(apart)[0]:
            f, alb, nrm, t = _oracle_guides(oracle, ro[:, k].numpy(),
                                            rd[:, k].numpy())
            assert bool(got["found"][k]) == f
            np.testing.assert_allclose(got["albedo"][k].numpy(), alb,
                                       atol=1e-5)
            np.testing.assert_allclose(got["normal"][k].numpy(),
                                       nrm if f else 0.0, atol=1e-5)
            np.testing.assert_allclose(float(got["depth"][k]), t, rtol=1e-5)


@pytest.fixture(scope="module")
def cornell_renderer():
    r = P.Renderer(P.RenderConfig(width=32, height=32, frames_per_chunk=2),
                   device="cpu")
    r.load_scene(P.cornell_box())
    r.render(spp=2, fetch=False)
    return r


def test_renderer_aovs(cornell_renderer):
    aovs = cornell_renderer.aovs()
    n = 32 * 32
    assert np.asarray(aovs["albedo"]).shape == (n, 3)
    assert np.asarray(aovs["normal"]).shape == (n, 3)
    assert np.asarray(aovs["depth"]).shape == (n,)
    fnd = np.asarray(aovs["found"])
    assert fnd.shape == (n,) and fnd.mean() > 0.5
    nn = np.linalg.norm(np.asarray(aovs["normal"]), axis=-1)
    np.testing.assert_allclose(nn[fnd], 1.0, atol=1e-3)
    assert (np.asarray(aovs["depth"])[fnd] > 0).all()


def test_renderer_denoise_leaves_default_path_intact(cornell_renderer):
    r = cornell_renderer
    raw_before = r.image()
    dn = r.image(denoise=True)
    assert dn.shape == raw_before.shape and np.isfinite(dn).all()
    np.testing.assert_array_equal(raw_before, r.image())
    tv = lambda im: float(np.abs(np.diff(im, axis=0)).mean()  # noqa: E731
                          + np.abs(np.diff(im, axis=1)).mean())
    assert tv(dn) < tv(raw_before)


def test_renderer_denoise_matches_jax(cornell_renderer):
    """``Renderer.denoise`` filters the accumulation with the renderer's
    own guides and spp = frame_index: the JAX ``denoise_image`` given the
    same buffer, guides and spp agrees within the filter's bar, and the
    JAX Renderer's own ``denoise`` has the same mean within 0.5% (its
    guides differ on the edge pixels of test_primary_aovs_match_jax, and
    the dilated taps carry that to their neighbours)."""
    r = cornell_renderer
    hdr = r._row_major().reshape(32, 32, 3)
    got = r.denoise()
    aovs = {k: v.numpy() for k, v in r.aovs().items()}
    np.testing.assert_allclose(got, JD.denoise_image(hdr, aovs, spp=2),
                               rtol=RTOL, atol=ATOL * 10)
    j = JRenderer(JConfig(width=32, height=32, frames_per_chunk=2))
    j.load_scene(JP.cornell_box())
    j.render(spp=2, fetch=False)
    assert abs(got.mean() / j.denoise(hdr).mean() - 1.0) < 5e-3


def test_save_png_with_denoise(cornell_renderer, tmp_path):
    from wgpu_path_tracing_tpu_torch.utils import image

    path = str(tmp_path / "dn.png")
    cornell_renderer.save_png(path, denoise=True)
    with open(path, "rb") as f:
        data = f.read()
    assert data == image.encode_png(cornell_renderer.image(denoise=True))
