"""The port's PCG and camera rays against the JAX package's.

Inputs are made with numpy from a seed and given to both. Integer results
(RNG states, draws turned into indices) must be bit-equal; rand() values are
bit-equal too, since both convert one uint32 word with one rounding. Ray
origins and directions are held within rtol 1e-6: XLA:CPU contracts the
multiply-adds of the pinhole direction and its normalisation into FMAs,
while PyTorch rounds every operation.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from wgpu_path_tracing_tpu.ops import camera_rays as JCAM
from wgpu_path_tracing_tpu.ops import rng as JRNG
from wgpu_path_tracing_tpu.render.camera import Camera as JCamera
from wgpu_path_tracing_tpu.render.pipeline import camera_device as jcamera_device
from wgpu_path_tracing_tpu.utils.tiling import tile_permutation as jtile_permutation
from wgpu_path_tracing_tpu_torch.ops import camera_rays as PCAM
from wgpu_path_tracing_tpu_torch.ops import rng as PRNG
from wgpu_path_tracing_tpu_torch.render.camera import Camera
from wgpu_path_tracing_tpu_torch.render.pipeline import camera_device
from wgpu_path_tracing_tpu_torch.utils.tiling import tile_permutation

# PCG states whose next draw is exactly 1.0 (the output word rounds up to
# 2^32 in float32), found by exhaustive search over [0, 2^27).
ONE_STATES = (60418823, 73275989)


def _states(seed, n=4096):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    return np.concatenate([s, np.array(ONE_STATES, np.uint32),
                           np.array([0, 2**32 - 1], np.uint32)])


def test_seed_pixel_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 4096, 1000).astype(np.int32)
    y = rng.integers(0, 4096, 1000).astype(np.int32)
    for frame in (0, 1, 5, 40000):  # 40000 * 100000 wraps past 2^32
        want = np.asarray(JRNG.seed_pixel(jnp.asarray(x), jnp.asarray(y),
                                          frame)).astype(np.int64)
        got = PRNG.seed_pixel(torch.from_numpy(x), torch.from_numpy(y),
                              frame).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [1, 2])
def test_rand_matches_jax_bit_for_bit(seed):
    s = _states(seed)
    mask = np.random.default_rng(seed + 100).random(s.shape[0]) < 0.5
    jv, js = JRNG.rand(jnp.asarray(s), jnp.asarray(mask))
    pv, ps = PRNG.rand(torch.from_numpy(s.astype(np.int64)),
                       torch.from_numpy(mask))
    np.testing.assert_array_equal(pv.numpy().view(np.uint32),
                                  np.asarray(jv).view(np.uint32))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js).astype(np.int64))


def test_rand_one_edge():
    """rand() returns exactly 1.0 for these states, in both packages, and
    rand_int clamps that draw to hi."""
    s = np.array(ONE_STATES, np.uint32)
    pv, _ = PRNG.rand(torch.from_numpy(s.astype(np.int64)))
    jv, _ = JRNG.rand(jnp.asarray(s))
    assert pv.tolist() == [1.0, 1.0] == np.asarray(jv).tolist()
    idx, _ = PRNG.rand_int(torch.from_numpy(s.astype(np.int64)), 0, 4)
    assert idx.tolist() == [4, 4]


@pytest.mark.parametrize("hi", [0, 1, 2, 6])
def test_rand_int_matches_jax(hi):
    s = _states(hi + 10)
    mask = np.random.default_rng(hi).random(s.shape[0]) < 0.7
    ji, js = JRNG.rand_int(jnp.asarray(s), 0, hi, jnp.asarray(mask))
    pi, ps = PRNG.rand_int(torch.from_numpy(s.astype(np.int64)), 0, hi,
                           torch.from_numpy(mask))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js).astype(np.int64))
    assert int(pi.max()) <= hi


def test_pixel_grid_and_tiles_match_jax():
    for w, h in ((32, 32), (48, 48), (40, 24)):
        jx, jy = JCAM.pixel_grid(w, h)
        px, py = PCAM.pixel_grid(w, h)
        np.testing.assert_array_equal(px.numpy(), np.asarray(jx))
        np.testing.assert_array_equal(py.numpy(), np.asarray(jy))
        np.testing.assert_array_equal(tile_permutation(w, h),
                                      jtile_permutation(w, h))


@pytest.mark.parametrize("use_dof", [False, True])
@pytest.mark.parametrize("frame", [0, 3])
def test_generate_rays_matches_jax(use_dof, frame):
    w, h = 40, 24
    jcam = JCamera(width=w, height=h, aspect=w / h)
    jcam.aperture = 0.05  # a wide lens, so the DoF offsets are not tiny
    cam = Camera(width=w, height=h, aspect=w / h)
    cam.aperture = 0.05
    jx, jy = JCAM.pixel_grid(w, h)
    jro, jrd, jst = JCAM.generate_rays(
        jcamera_device(jcam.as_pytree(), w, h), jx, jy, jnp.int32(frame),
        use_dof=use_dof)
    px, py = PCAM.pixel_grid(w, h)
    pro, prd, pst = PCAM.generate_rays(camera_device(cam.as_pytree(), w, h),
                                       px, py, frame, use_dof=use_dof)
    np.testing.assert_array_equal(pst.numpy(), np.asarray(jst).astype(np.int64))
    # rtol 1e-6: XLA:CPU's fused multiply-adds against per-op rounding.
    np.testing.assert_allclose(pro.numpy().T, np.asarray(jro), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(prd.numpy().T, np.asarray(jrd), rtol=1e-6,
                               atol=1e-6)
