"""The debug views (``debug/modes.py``) against the JAX package's.

``RenderConfig(mode="bvh_depth")`` walks the binary BVH from each pixel
centre with K7's depth mode (its plain version here) and ``mode="normal"``
shades the primary hits with the plain hit attributes. Tolerances:

* centre rays: within 2e-7 of the JAX ones (XLA:CPU fuses the direction's
  products and sums into multiply-adds; PyTorch rounds each);
* the depth view: equal to the JAX view on every pixel within 1 ulp (XLA
  multiplies by the reciprocal of 24 where the port divides), the depths
  themselves (the view times 24) exactly;
* the normal view: within 1e-5 of the JAX view, except on a few edge
  pixels where the two packages' rays meet different triangles; there the
  scalar oracle (``tests/oracle.py``) on the port's own ray gives the port's
  colour.
"""

import numpy as np
import pytest
import torch

from tests.oracle import Oracle
from wgpu_path_tracing_tpu import Renderer as JRenderer
from wgpu_path_tracing_tpu import RenderConfig as JConfig
from wgpu_path_tracing_tpu.debug import modes as JM
from wgpu_path_tracing_tpu.models import procedural as JP
from wgpu_path_tracing_tpu.render import pipeline as jpipe
import wgpu_path_tracing_tpu_torch as P
from wgpu_path_tracing_tpu_torch.debug import modes as M
from wgpu_path_tracing_tpu_torch.render.pipeline import camera_device

# One thread a worker: PyTorch's OpenMP teams spin against each other under
# the suite's parallel workers.
torch.set_num_threads(1)

SCENES = ("cornell_box", "material_test_box", "textured_cornell")
SIZES = ((24, 24), (48, 40))


def _views(name, mode, w, h):
    j = JRenderer(JConfig(width=w, height=h, mode=mode))
    j.load_scene(getattr(JP, name)())
    p = P.Renderer(P.RenderConfig(width=w, height=h, mode=mode),
                   device="cpu")
    p.load_scene(getattr(P, name)())
    return p, p.render(spp=1), np.asarray(j.render(spp=1))


@pytest.mark.parametrize("w,h", [(24, 24), (32, 24), (40, 48)])
def test_center_rays_match_jax(w, h):
    cam = P.Camera(width=w, height=h, aspect=w / h)
    ro, rd = M._center_rays(camera_device(cam.as_pytree(), w, h), w, h)
    jro, jrd = JM._center_rays(jpipe.camera_device(cam.as_pytree(), w, h),
                               w, h)
    np.testing.assert_array_equal(ro.T.numpy(), np.asarray(jro))
    np.testing.assert_allclose(rd.T.numpy(), np.asarray(jrd), rtol=0,
                               atol=2e-7)


@pytest.mark.parametrize("name", SCENES)
@pytest.mark.parametrize("w,h", SIZES)
def test_bvh_depth_view_matches_jax(name, w, h):
    _, got, want = _views(name, "bvh_depth", w, h)
    assert got.shape == want.shape == (h, w, 3)
    np.testing.assert_array_equal(np.rint(got * 24), np.rint(want * 24))
    np.testing.assert_array_max_ulp(got, want, maxulp=1)
    assert got.max() > 0
    np.testing.assert_array_equal(got[..., 0], got[..., 2])


@pytest.mark.parametrize("name", SCENES)
@pytest.mark.parametrize("w,h", SIZES)
def test_normal_view_matches_jax(name, w, h):
    p, got, want = _views(name, "normal", w, h)
    apart = ~np.isclose(got, want, rtol=0, atol=1e-5).all(-1)
    assert apart.sum() <= 3, np.nonzero(apart)
    cam = camera_device(p.camera.as_pytree(), w, h)
    ro, rd = M._center_rays(cam, w, h)
    oracle = Oracle(getattr(P, name)(), p.camera.as_pytree(), w, h)
    for py, px in zip(*np.nonzero(apart)):
        k = py * w + px
        hit = oracle.scene_intersect(ro[:, k].numpy(), rd[:, k].numpy())
        if hit is None:
            color = np.zeros(3, np.float32)
        elif hit["is_front"]:
            color = (np.asarray(hit["normal"], np.float32) + 1.0) * 0.5
        else:
            color = np.array([1.0, 0.0, 0.0], np.float32)
        np.testing.assert_allclose(got[py, px], color, atol=1e-5)


@pytest.mark.parametrize("mode", ["normal", "bvh_depth"])
def test_debug_modes(mode):
    """The JAX package's test_debug_modes property on the port."""
    r = P.Renderer(P.RenderConfig(width=16, height=16, mode=mode),
                   device="cpu")
    r.load_scene(P.cornell_box())
    img = r.render_debug()
    assert img.shape == (16, 16, 3)
    assert np.isfinite(img).all()
    assert img.max() > 0


@pytest.mark.parametrize("mode", ["normal", "bvh_depth"])
def test_render_returns_the_debug_view(mode):
    """``render`` in a debug mode returns the view and accumulates
    nothing."""
    r = P.Renderer(P.RenderConfig(width=16, height=16, mode=mode),
                   device="cpu")
    r.load_scene(P.cornell_box())
    img = r.render(spp=4)
    np.testing.assert_array_equal(img, r.render_debug())
    assert r.frame_index == 0 and r.stats()["rays_total"] == 0


@pytest.mark.parametrize("intersector", ["walk", "stack", "bvh", "pairs"])
def test_normal_view_is_the_same_through_every_intersector(intersector):
    """The intersectors find the same primary hits (the same per-operation
    rounding), so the view is equal to the dense hit's on every pixel."""
    def view(name):
        r = P.Renderer(P.RenderConfig(width=32, height=32, mode="normal",
                                      intersector=name), device="cpu")
        r.load_scene(P.cornell_box(tessellation=2))
        return r.render(spp=1)

    np.testing.assert_array_equal(view(intersector), view("brute"))


def test_depth_view_counts_stack_entries():
    """Every depth is a whole post-pop stack pointer, at most the tree's
    depth, and the root's children are reached from every pixel inside."""
    r = P.Renderer(P.RenderConfig(width=24, height=24, mode="bvh_depth"),
                   device="cpu")
    r.load_scene(P.cornell_box())
    k = r.render(spp=1)[..., 0] * M.MAX_DEPTH
    np.testing.assert_array_equal(k, np.rint(k))
    meta = r.scene.bvh_meta
    assert 1 <= k.min() and k.max() <= len(meta)


def test_mode_is_checked():
    for mode in ("pt", "bvh_depth", "normal"):
        P.RenderConfig(mode=mode).validate()
    with pytest.raises(ValueError, match="mode"):
        P.RenderConfig(mode="albedo").validate()
