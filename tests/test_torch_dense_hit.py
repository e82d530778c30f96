"""K1's plain version (the dense closest hit) against the JAX package's.

The same numpy-made rays go through the port's ``closest_hit_brute`` (which
the K1 wrapper runs for CPU tensors), the JAX ``closest_hit_brute`` and the
Pallas kernel ``closest_hit_brute_pallas_soa`` in interpret mode. Winner
indices must agree; ``t`` is held within rtol 1e-5 where they do, because
XLA:CPU fuses the Möller-Trumbore multiply-adds into FMAs and PyTorch rounds
every operation, which moves ``t`` by many ulps on grazing hits and can flip
a winner between two triangles that tie to within those ulps.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from wgpu_path_tracing_tpu.models.procedural import cornell_box as jcornell_box
from wgpu_path_tracing_tpu.models.types import pack_device_scene as jpack
from wgpu_path_tracing_tpu.ops import camera_rays as JCAM
from wgpu_path_tracing_tpu.ops.intersect import closest_hit_brute as jbrute
from wgpu_path_tracing_tpu.ops.pallas_kernels import closest_hit_brute_pallas_soa
from wgpu_path_tracing_tpu.render.camera import Camera as JCamera
from wgpu_path_tracing_tpu.render.pipeline import camera_device as jcamera_device
from wgpu_path_tracing_tpu_torch import cornell_box, load_jax_scene
from wgpu_path_tracing_tpu_torch.ops import dense_hit
from wgpu_path_tracing_tpu_torch.ops.intersect import (
    closest_hit_brute,
    make_closest_hit,
)


@pytest.fixture(scope="module")
def tri_isect():
    return np.asarray(jpack(jcornell_box())["tri_isect"], np.float32)


def _all_three(tri, ro, rd):
    """(port, jax, pallas-interpret) results as numpy (t, idx) pairs."""
    pt, pi = closest_hit_brute(torch.from_numpy(tri), torch.from_numpy(ro),
                               torch.from_numpy(rd))
    jt, ji = jbrute(jnp.asarray(tri), jnp.asarray(ro), jnp.asarray(rd))
    rays = jnp.concatenate([jnp.asarray(ro).T, jnp.asarray(rd).T], axis=0)
    kt, ki = closest_hit_brute_pallas_soa(jnp.asarray(tri), rays,
                                          interpret=True)
    return ((pt.numpy(), pi.numpy()), (np.asarray(jt), np.asarray(ji)),
            (np.asarray(kt), np.asarray(ki)))


def test_cornell_camera_rays_agree_on_every_lane(tri_isect):
    w = h = 32
    cam = jcamera_device(JCamera(width=w, height=h).as_pytree(), w, h)
    x, y = JCAM.pixel_grid(w, h)
    ro, rd, _ = JCAM.generate_rays(cam, x, y, jnp.int32(0), use_dof=True)
    ro, rd = np.asarray(ro), np.asarray(rd)
    (pt, pi), *refs = _all_three(tri_isect, ro, rd)
    assert (pi >= 0).mean() > 0.9
    for t, idx in refs:
        np.testing.assert_array_equal(pi, idx)
        np.testing.assert_allclose(pt, t, rtol=1e-5)


def test_random_interior_rays(tri_isect):
    """Rays from inside the box in every direction, grazing hits included.
    idx agrees on >= 99.8% of lanes and t within rtol 1e-5 where it does.
    Every lane where it does not is a tie: a ray through the edge two
    triangles share, whose two t agree to rtol 1e-5, and the port's t there
    is the scalar oracle's (tests/oracle.py rounds per operation, as PyTorch
    does). These ties are 0.11% of lanes at this seed."""
    from tests.oracle import Oracle

    rng = np.random.default_rng(7)
    n = 8192
    ro = rng.uniform([-0.95, 0.05, -0.95], [0.95, 1.95, 0.95],
                     (n, 3)).astype(np.float32)
    rd = rng.normal(size=(n, 3))
    rd = (rd / np.linalg.norm(rd, axis=1, keepdims=True)).astype(np.float32)
    (pt, pi), *refs = _all_three(tri_isect, ro, rd)
    oracle = Oracle(jcornell_box(), None, 1, 1)
    for t, idx in refs:
        same = pi == idx
        assert same.mean() >= 0.998, f"idx agrees on {same.mean():.5f}"
        # atol 1e-7: a hit 1e-3 from the origin loses relative precision
        # to the ulps (6e-8) of the coordinates it is computed from.
        np.testing.assert_allclose(pt[same], t[same], rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(pt[~same], t[~same], rtol=1e-5, atol=1e-7)
        for lane in np.nonzero(~same)[0]:
            hit = oracle.scene_intersect(ro[lane], rd[lane])
            assert hit is not None and hit["t"] == pt[lane]


def test_duplicate_triangle_takes_the_lower_index():
    tri = np.array([[0, 0, -1, 1, 0, 0, 0, 1, 0]] * 3, np.float32)
    tri[0] = [5, 5, 5, 1, 0, 0, 0, 1, 0]  # elsewhere: row 1 and 2 tie
    ro = np.array([[0.25, 0.25, 0.0], [3.0, 3.0, 0.0]], np.float32)
    rd = np.array([[0.0, 0.0, -1.0], [0.0, 0.0, -1.0]], np.float32)
    (pt, pi), *refs = _all_three(tri, ro, rd)
    assert pi.tolist() == [1, -1]
    assert pt[0] == np.float32(1.0) and pt[1] == np.inf
    for t, idx in refs:
        np.testing.assert_array_equal(pi, idx)
        np.testing.assert_array_equal(pt, t)


@pytest.mark.parametrize("chunk", [1, 5, 16])
def test_chunking_does_not_change_the_winner(tri_isect, chunk):
    """Ties across chunk boundaries keep the lowest index (strict <)."""
    tri = np.concatenate([tri_isect, tri_isect])  # every hit ties twice
    rng = np.random.default_rng(chunk)
    ro = rng.uniform(-0.9, 0.9, (512, 3)).astype(np.float32) + [0, 1, 0]
    rd = rng.normal(size=(512, 3)).astype(np.float32)
    ref_t, ref_i = closest_hit_brute(torch.from_numpy(tri),
                                     torch.from_numpy(ro.astype(np.float32)),
                                     torch.from_numpy(rd))
    t, i = closest_hit_brute(torch.from_numpy(tri),
                             torch.from_numpy(ro.astype(np.float32)),
                             torch.from_numpy(rd), chunk=chunk)
    assert (ref_i < tri_isect.shape[0]).all()
    np.testing.assert_array_equal(i.numpy(), ref_i.numpy())
    np.testing.assert_array_equal(t.numpy(), ref_t.numpy())


def test_wrapper_runs_the_plain_version_on_cpu(tri_isect):
    """On CPU tensors the K1 wrapper is the plain version, and it launches
    nothing."""
    rng = np.random.default_rng(3)
    rays = torch.from_numpy(rng.normal(size=(6, 300)).astype(np.float32))
    tri = torch.from_numpy(tri_isect)
    before = dense_hit.Counter.launches
    t, idx = dense_hit.closest_hit_dense(tri, rays)
    pt, pi = dense_hit.closest_hit_dense_plain(tri, rays)
    assert dense_hit.Counter.launches == before
    assert t.dtype == torch.float32 and idx.dtype == torch.int32
    assert torch.equal(t, pt) and torch.equal(idx, pi)


@pytest.mark.parametrize("bad", ["shape", "dtype", "tri"])
def test_wrapper_rejects_bad_inputs(tri_isect, bad):
    tri = torch.from_numpy(tri_isect)
    rays = torch.zeros((6, 8))
    if bad == "shape":
        rays = torch.zeros((3, 8))
    elif bad == "dtype":
        rays = rays.double()
    else:
        tri = tri[:, :6]
    with pytest.raises((ValueError, TypeError)):
        dense_hit.closest_hit_dense(tri, rays)


def test_cuda_wrapper_refuses_cpu_tensors(tri_isect):
    with pytest.raises(ValueError):
        dense_hit.closest_hit_dense_cuda(torch.from_numpy(tri_isect),
                                         torch.zeros((6, 8)))


def test_make_closest_hit_dense_only():
    scene = load_jax_scene(jpack(jcornell_box()), "cpu")
    ch = make_closest_hit(scene)
    assert ch.strategy == "brute"
    # Above brute_max_tris "auto" takes the walk, or the pair dispatch for
    # a scene without walk tables.
    assert make_closest_hit(scene, brute_max_tris=16).strategy == "walk"
    no_walk = {k: v for k, v in scene.items() if not k.startswith("walk_")}
    assert make_closest_hit(no_walk, brute_max_tris=16).strategy == "pairs"
    assert make_closest_hit(no_walk, intersector="brute",
                            brute_max_tris=16).strategy == "brute"
    with pytest.raises(NotImplementedError):
        make_closest_hit(scene, intersector="stack")
    # active / t_max / any_hit are accepted and ignored, as in the JAX
    # package's dense branch.
    rng = np.random.default_rng(0)
    ro = torch.from_numpy(rng.uniform(-0.5, 0.5, (3, 64)).astype(np.float32))
    rd = torch.from_numpy(rng.normal(size=(3, 64)).astype(np.float32))
    t0, i0 = ch(ro, rd)
    t1, i1 = ch(ro, rd, active=torch.zeros(64, dtype=torch.bool),
                t_max=torch.zeros(64), any_hit=True)
    assert torch.equal(t0, t1) and torch.equal(i0, i1)
    assert cornell_box().num_triangles == scene["tri_isect"].shape[0]
