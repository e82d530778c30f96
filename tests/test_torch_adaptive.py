"""Adaptive sampling (``render/adaptive.py``) against the JAX package's, and
the properties ``tests/test_adaptive.py`` pins there, on the port.

The frames run through the port's plain bounce loop and dense hit here.
Tolerances:

* the warmup's ``accum`` equals ``render_chunk``'s on the same frames bit
  for bit (the same expressions, the JAX docstring's "radiance bit-equal");
* the host helpers (``_score_from_moments``, ``_display_sigma_score``,
  ``_blurred``) on identical numpy inputs: rtol 1e-4 / atol 1e-6 (the AGX
  display transform's pow, log and exp are XLA's on one side and PyTorch's
  on the other, a few ulp apart, which the transform's steep slope near
  the display's black floor makes up to 4e-5 of a score); the selection
  they feed, exactly;
* rendered samples against the JAX Renderer's with the golden test's bars
  (``tests/test_torch_renderer.py``): within rtol/atol 5e-4 or, where not,
  of the scalar oracle's samples (XLA:CPU's fused multiply-adds flip a
  shadow test now and then), at most 5 lanes off both; sample counts
  exactly;
* ``render_adaptive`` whole with a partial selection: ray counts within
  0.1% and means within 0.5% of the JAX image, and 75% of pixels within
  1e-3. The scores come from renders that differ in the flipped samples
  above, so pixels whose scores nearly tie are picked differently, and each
  such pick moves a pixel's sample count.
"""

import numpy as np
import pytest
import torch

from tests.oracle import Oracle
from wgpu_path_tracing_tpu import Renderer as JRenderer
from wgpu_path_tracing_tpu import RenderConfig as JConfig
from wgpu_path_tracing_tpu.models import procedural as JP
from wgpu_path_tracing_tpu.render import adaptive as JA
from wgpu_path_tracing_tpu.render import pipeline as jpipe
import wgpu_path_tracing_tpu_torch as P
from wgpu_path_tracing_tpu_torch.ops import trace as TRACE
from wgpu_path_tracing_tpu_torch.render import adaptive as A
from wgpu_path_tracing_tpu_torch.render import pipeline
from wgpu_path_tracing_tpu_torch.utils.tiling import tile_permutation

# One thread a worker: PyTorch's OpenMP teams spin against each other under
# the suite's parallel workers.
torch.set_num_threads(1)


def _mk(width=32, height=32, aperture=0.001, chunk=4, **cfg):
    r = P.Renderer(P.RenderConfig(width=width, height=height,
                                  frames_per_chunk=chunk, **cfg),
                   device="cpu")
    r.load_scene(P.cornell_box())
    r.camera.aperture = aperture
    return r


def _jmk(width=32, height=32, aperture=0.001, chunk=4, **cfg):
    r = JRenderer(JConfig(width=width, height=height, frames_per_chunk=chunk,
                          **cfg))
    r.load_scene(JP.cornell_box())
    r.camera.aperture = aperture
    return r


# --- the JAX suite's properties (tests/test_adaptive.py) on the port ---------

def test_all_selected_matches_uniform():
    img_a = _mk().render_adaptive(8)
    ru = _mk()
    ru.render(8, fetch=False)
    img_u = ru._row_major().reshape(32, 32, 3)
    np.testing.assert_allclose(img_a, img_u, atol=2e-5)


def test_budget_accounting_and_determinism():
    ra = _mk()
    img1 = ra.render_adaptive(8)
    rays1 = int(ra._counters.sum())
    img2 = _mk().render_adaptive(8)
    np.testing.assert_array_equal(img1, img2)
    ru = _mk()
    ru.render(8, fetch=False)
    rays_u = int(ru._counters.sum())
    assert abs(rays1 - rays_u) / rays_u < 0.35, (rays1, rays_u)


def test_warmup_only_short_budget():
    r = _mk()
    img = r.render_adaptive(2)
    assert img.shape == (32, 32, 3)
    assert np.isfinite(img).all()
    assert r.frame_index == 2


def test_adaptive_beats_uniform_on_concentrated_noise():
    def mk():
        r = _mk(64, 64, aperture=0.25, chunk=16)
        r.camera.position = np.array([0.0, 1.0, 7.0], np.float32)
        return r

    golden_r = mk()
    golden_r.render(192, fetch=False)
    golden = golden_r._row_major().reshape(64, 64, 3)
    ru = mk()
    ru.render(12, fetch=False)
    uni = ru._row_major().reshape(64, 64, 3)
    ada = mk().render_adaptive(12)
    rmse_u = float(np.sqrt(np.mean((uni - golden) ** 2)))
    rmse_a = float(np.sqrt(np.mean((ada - golden) ** 2)))
    assert rmse_a < 0.95 * rmse_u, (rmse_a, rmse_u)


# --- against the JAX functions -----------------------------------------------

def _oracle_samples(oracle, lanes, frames, w, h):
    """The oracle's clamped samples of tile lanes ``lanes`` at ``frames``:
    (len(frames), len(lanes), 3)."""
    perm = tile_permutation(w, h)
    out = np.zeros((len(frames), len(lanes), 3), np.float32)
    for k, lane in enumerate(lanes):
        y, x = divmod(int(perm[lane]), w)
        for f, frame in enumerate(frames):
            out[f, k] = np.minimum(np.asarray(oracle.render_pixel(
                x, y, frame), np.float32), np.float32(2.5))
    return out


def _held(got, want, oracle_value):
    """The golden test's bar on (lanes, 3) arrays: each lane within 5e-4 of
    the JAX value or, where not, within 2e-3 of ``oracle_value(lanes)``; at
    most 5 lanes off both and 99% on one."""
    close = np.isclose(got, want, rtol=5e-4, atol=5e-4).all(-1)
    lanes = np.nonzero(~close)[0]
    if len(lanes):
        off = ~np.isclose(got[lanes], oracle_value(lanes), rtol=2e-3,
                          atol=2e-3).all(-1)
        off_both = lanes[off]
    else:
        off_both = lanes
    assert len(off_both) <= 5, off_both
    assert len(got) - len(off_both) >= 0.99 * len(got)


def _common(r):
    cfg = r.config
    return dict(use_dof=float(r.camera.aperture) > 0.0, rng_mode=cfg.rng,
                max_bounces=cfg.max_bounces, do_mis=cfg.do_mis,
                num_lights=r.scene.num_lights,
                firefly_clamp=cfg.firefly_clamp)


def _jcommon(r):
    cfg = r.config
    return dict(use_dof=float(r.camera.aperture) > 0.0, rng_mode=cfg.rng,
                max_bounces=cfg.max_bounces, do_mis=cfg.do_mis,
                num_lights=r.scene.num_lights,
                firefly_clamp=cfg.firefly_clamp, intersector=cfg.intersector,
                brute_max_tris=cfg.brute_force_max_tris,
                leaf_size=cfg.max_leaf_size)


@pytest.mark.parametrize("rng", ["reference", "hash", "stratified"])
def test_warmup_accum_is_render_chunks_and_m2_the_squared_mean(rng):
    """``render_chunk_m2``'s accum is ``render_chunk``'s bit for bit, and
    its m2 is the running mean of each frame's clamped colour squared,
    folded with the same weights, bit for bit."""
    w = h = 24
    frames = 3
    r = _mk(w, h, rng=rng)
    cam = pipeline.camera_device(r.camera.as_pytree(), w, h)
    accum, m2 = torch.zeros((w * h, 3)), torch.zeros((w * h, 3))
    A.render_chunk_m2(TRACE.trace, r._closest_hit, r._scene_dev, cam, accum,
                      m2, 0, n_frames=frames, width=w, height=h,
                      **_common(r))
    ref = torch.zeros((w * h, 3))
    pipeline.render_chunk(TRACE.trace, r._closest_hit, r._scene_dev, cam,
                          ref, 0, n_frames=frames, width=w, height=h,
                          **_common(r))
    np.testing.assert_array_equal(accum.numpy().view(np.uint32),
                                  ref.numpy().view(np.uint32))
    # m2 by hand: each frame's clamped colour, traced alone.
    from wgpu_path_tracing_tpu_torch.ops import camera_rays as CAM

    x, y = pipeline.tile_pixels(w, h, "cpu")
    c = _common(r)
    want = torch.zeros((w * h, 3))
    for f in range(frames):
        ro, rd, state = CAM.generate_rays(cam, x, y, f, use_dof=c["use_dof"],
                                          rng_mode=rng)
        lds0 = CAM.bounce0_lds(x, y, f) if rng == "stratified" else None
        radiance, _, _ = TRACE.trace(
            r._scene_dev, r._closest_hit, ro, rd, state,
            max_bounces=c["max_bounces"], do_mis=c["do_mis"],
            num_lights=c["num_lights"], lds0=lds0)
        color = torch.clamp_max(radiance.T, float(np.float32(2.5)))
        wt = np.float32(1.0) / (np.float32(f) + np.float32(1.0))
        want.mul_(float(np.float32(1.0) - wt)).add_(color * color * float(wt))
    np.testing.assert_array_equal(m2.numpy().view(np.uint32),
                                  want.numpy().view(np.uint32))
    assert (m2.numpy() + 1e-6 >= accum.numpy() ** 2 * (1 - 1e-5)).all()


def test_warmup_matches_jax():
    """The warmup's accum and m2 against the JAX ``render_chunk_m2`` on the
    same frames (rng "reference", which the oracle knows), under the golden
    test's bars."""
    w = h = 24
    frames = 3
    r = _mk(w, h)
    cam = pipeline.camera_device(r.camera.as_pytree(), w, h)
    accum, m2 = torch.zeros((w * h, 3)), torch.zeros((w * h, 3))
    A.render_chunk_m2(TRACE.trace, r._closest_hit, r._scene_dev, cam, accum,
                      m2, 0, n_frames=frames, width=w, height=h,
                      **_common(r))
    j = _jmk(w, h)
    jcam = jpipe.camera_device(j.camera.as_pytree(), w, h)
    z = np.zeros((w * h, 3), np.float32)
    ja, jm2, _ = JA.render_chunk_m2(j._scene_dev, jcam, z, z.copy(), 0,
                                    n_frames=frames, width=w, height=h,
                                    **_jcommon(j))
    oracle = Oracle(P.cornell_box(), r.camera.as_pytree(), w, h)

    def samples(lanes):
        return _oracle_samples(oracle, lanes, range(frames), w, h)

    _held(accum.numpy(), np.asarray(ja), lambda l: samples(l).mean(0))
    _held(m2.numpy(), np.asarray(jm2), lambda l: (samples(l) ** 2).mean(0))


@pytest.mark.parametrize("seed", [0, 1])
def test_render_chunk_subset_matches_jax(seed):
    """One fixed numpy-made selection of 1,024 lanes of a 48x48 frame
    (a multiple of 1,024, as every JAX call here must be), two rounds from
    frame 4: the same lanes, the same counts, the same sample sums."""
    w = h = 48
    n, k, frame0, rounds = w * h, 1024, 4, 2
    sel = np.random.default_rng(seed).choice(n, k, replace=False)
    perm = tile_permutation(w, h)
    x_t = (perm % w).astype(np.int32)
    y_t = (perm // w).astype(np.int32)
    r = _mk(w, h)
    cam = pipeline.camera_device(r.camera.as_pytree(), w, h)
    s1, s2 = torch.zeros((n, 3)), torch.zeros((n, 3))
    cnt = torch.zeros((n,), dtype=torch.int32)
    _, _, _, counters = A.render_chunk_subset(
        TRACE.trace, r._closest_hit, r._scene_dev, cam, s1, s2, cnt,
        torch.from_numpy(x_t[sel]), torch.from_numpy(y_t[sel]),
        torch.from_numpy(sel), frame0, n_frames=rounds, **_common(r))
    j = _jmk(w, h)
    jcam = jpipe.camera_device(j.camera.as_pytree(), w, h)
    z = np.zeros((n, 3), np.float32)
    js1, js2, jcnt, jcounters = JA.render_chunk_subset(
        j._scene_dev, jcam, z, z.copy(), np.zeros(n, np.int32), x_t[sel],
        y_t[sel], sel.astype(np.int32), frame0, n_frames=rounds,
        **_jcommon(j))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))
    np.testing.assert_array_equal(np.nonzero(cnt.numpy())[0], np.sort(sel))
    assert abs(int(counters.sum()) / int(np.asarray(jcounters).sum())
               - 1) < 0.01
    oracle = Oracle(P.cornell_box(), r.camera.as_pytree(), w, h)
    frames = range(frame0, frame0 + rounds)

    def oracle_sum(lanes):
        return _oracle_samples(oracle, sel[lanes], frames, w, h).sum(0)

    _held(s1.numpy()[sel], np.asarray(js1)[sel], oracle_sum)


def _moments(seed, n=1024):
    rng = np.random.default_rng(seed)
    mean = rng.uniform(0.0, 1.5, (n, 3)).astype(np.float32)
    mean[::17] = 0.0  # converged misses
    ex2 = (mean * mean + rng.uniform(0.0, 0.3, (n, 3))).astype(np.float32)
    ex2[::17] = 0.0
    return mean, ex2


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_score_from_moments_matches_jax(seed):
    mean, ex2 = _moments(seed)
    counts = np.random.default_rng(seed).integers(2, 9, len(mean))
    got = A._score_from_moments(mean, ex2, counts)
    want = JA._score_from_moments(mean, ex2, counts)
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    assert (got[::17] == 0).all() and (got > 0).mean() > 0.8


@pytest.mark.parametrize("seed", [3, 4])
def test_display_sigma_score_matches_jax(seed):
    mean, ex2 = _moments(seed)
    sigma = np.sqrt(np.maximum(ex2 - mean * mean, 0)).astype(np.float32)
    np.testing.assert_allclose(A._display_sigma_score(mean, sigma),
                               JA._display_sigma_score(mean, sigma),
                               rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("w,h", [(32, 32), (48, 40)])
def test_blurred_score_and_selection(w, h):
    """The 3x3 smoothing in image space (edge-replicated, zero scores kept
    zero) against scipy's box filter, and the selection the JAX code makes
    from it, on identical inputs."""
    from scipy.ndimage import uniform_filter

    rng = np.random.default_rng(w)
    score = rng.random(w * h).astype(np.float32)
    score[rng.random(w * h) < 0.2] = 0.0
    got = A._blurred(score, w, h)
    perm = tile_permutation(w, h)
    img = np.empty(w * h, np.float32)
    img[perm] = score
    box = uniform_filter(img.reshape(h, w).astype(np.float64), 3,
                         mode="nearest").reshape(-1)
    want = np.where(img > 0, box, 0.0)[perm]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert ((got == 0) == (score == 0)).all()
    k = 2048 if w * h > 2048 else w * h // 2
    pred = got / (2 + rng.integers(0, 3, w * h))
    sel = np.argpartition(pred, w * h - k)[w * h - k:]
    assert set(sel) == set(np.argsort(pred, kind="stable")[w * h - k:])


def test_render_adaptive_all_selected_matches_jax():
    """32x32 (fewer lanes than LANE_QUANTUM: every round takes every
    pixel), 8 spp: the JAX Renderer's image under the golden test's bars,
    the oracle's 8-frame mean arbitrating."""
    got = _mk().render_adaptive(8)
    want = np.asarray(_jmk().render_adaptive(8))
    r = _mk()
    oracle = Oracle(P.cornell_box(), r.camera.as_pytree(), 32, 32)
    perm = tile_permutation(32, 32)
    inv = np.argsort(perm)

    def oracle_mean(pixels):
        return _oracle_samples(oracle, inv[pixels], range(8), 32, 32).mean(0)

    _held(got.reshape(-1, 3), want.reshape(-1, 3), oracle_mean)


def test_render_adaptive_partial_selection_matches_jax():
    """64x64 (4,096 lanes, rounds of 2,048) at 8 spp under a wide aperture:
    the statistical bars of the module docstring."""
    ra, ja = _mk(64, 64, aperture=0.25), _jmk(64, 64, aperture=0.25)
    got = ra.render_adaptive(8)
    want = np.asarray(ja.render_adaptive(8))
    assert ra.frame_index == ja.frame_index == 4
    rays, jrays = int(ra._counters.sum()), int(np.asarray(ja._counters).sum())
    assert abs(rays / jrays - 1) < 1e-3, (rays, jrays)
    assert abs(got.mean() / want.mean() - 1) < 5e-3
    close = np.isclose(got, want, rtol=0, atol=1e-3).all(-1)
    assert close.mean() >= 0.75, close.mean()


@pytest.mark.parametrize("intersector", ["pairs", "cluster", "stack"])
def test_ragged_rounds_on_other_intersectors_equal_the_dense_hit(intersector):
    """40x40 = 1,600 lanes: every round is a ragged call (no multiple of
    the dispatch intersectors' 1,024-lane blocks). The image equals the
    dense hit's on every pixel (the port's intersectors find the same
    hits); the JAX functions are not called at such a count."""
    got = _mk(40, 40, intersector=intersector).render_adaptive(6)
    np.testing.assert_array_equal(got, _mk(40, 40).render_adaptive(6))
