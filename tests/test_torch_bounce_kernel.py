"""``RenderConfig.bounce_kernel`` (``render/pipeline.py::make_trace_fn``)
against the JAX package's field of the same name.

"auto" and "pallas" run K2's wrapper (``ops/bounce.py::trace_cuda``),
which on CPU tensors runs K2's plain version; "xla" runs the plain bounce
loop (``ops/trace.py::trace``). On the CPU the three are the same
arithmetic in the same order, so their images are bit-equal; the JAX
package's "xla" render is held with the bars of
``tests/test_torch_renderer.py`` (its FMAs round differently,
``tests/test_torch_parity.py``).
"""

import dataclasses

import numpy as np
import pytest
import torch

from wgpu_path_tracing_tpu import Renderer as JRenderer
from wgpu_path_tracing_tpu import RenderConfig as JRenderConfig
from wgpu_path_tracing_tpu import cornell_box as jcornell_box
from tests.oracle import Oracle
from tests.test_torch_renderer import _oracle_mean
from wgpu_path_tracing_tpu_torch import Renderer, RenderConfig, cornell_box
from wgpu_path_tracing_tpu_torch.ops import bounce as K2
from wgpu_path_tracing_tpu_torch.ops import trace as TRACE
from wgpu_path_tracing_tpu_torch.render import adaptive
from wgpu_path_tracing_tpu_torch.render import pipeline
from wgpu_path_tracing_tpu_torch.render.config import BOUNCE_KERNELS

torch.set_num_threads(1)

KERNELS = ("auto", "pallas", "xla")


@pytest.fixture(scope="module")
def renders():
    out = {}
    for kernel in KERNELS:
        r = Renderer(RenderConfig(width=24, height=24, bounce_kernel=kernel),
                     device="cpu")
        r.load_scene(cornell_box())
        out[kernel] = (r, r.render(spp=2))
    return out


@pytest.mark.parametrize("kernel", ["pallas", "xla"])
def test_bounce_kernels_render_bit_equal_on_cpu(renders, kernel):
    _, auto = renders["auto"]
    r, img = renders[kernel]
    np.testing.assert_array_equal(img.view(np.uint32), auto.view(np.uint32))
    assert r.stats()["rays_total"] == renders["auto"][0].stats()["rays_total"]


@pytest.mark.parametrize("kernel", KERNELS)
def test_each_bounce_kernel_matches_the_jax_xla_render(renders, kernel):
    """>= 99% of pixels within 5e-4 of the JAX ``bounce_kernel="xla"``
    image or, where not, within 2e-3 of the scalar oracle's mean; at most
    5 pixels off both; the means within 1e-3."""
    r, buf = renders[kernel]
    j = JRenderer(JRenderConfig(width=24, height=24, frames_per_chunk=2,
                                bounce_kernel="xla"))
    j.load_scene(jcornell_box())
    ref = np.asarray(j.render(spp=2))
    close = np.isclose(buf, ref, rtol=5e-4, atol=5e-4).all(-1)
    oracle = Oracle(cornell_box(), r.camera.as_pytree(), 24, 24)
    ys, xs = np.nonzero(~close)
    off_both = [(px, py) for px, py in zip(xs, ys)
                if not np.allclose(buf[py, px], _oracle_mean(oracle, px, py, 2),
                                   rtol=2e-3, atol=2e-3)]
    report = (f"{len(xs)} of {close.size} pixels outside 5e-4 of the JAX "
              f"render, {len(off_both)} of them off the oracle too: {off_both}")
    assert close.size - len(off_both) >= 0.99 * close.size, report
    assert len(off_both) <= 5, report
    assert abs(buf.mean() / ref.mean() - 1.0) < 1e-3


def test_a_bad_bounce_kernel_raises():
    assert BOUNCE_KERNELS == ("auto", "pallas", "xla")
    with pytest.raises(ValueError, match="bounce_kernel='mosaic'"):
        RenderConfig(bounce_kernel="mosaic").validate()
    with pytest.raises(ValueError, match="bounce_kernel"):
        Renderer(RenderConfig(bounce_kernel="cuda"), device="cpu")
    with pytest.raises(ValueError, match="bounce_kernel='triton'"):
        pipeline.make_trace_fn("triton", "cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        pipeline.make_trace_fn("auto", "meta")


def test_make_trace_fn_picks_the_loop():
    for device in ("cpu", "cuda"):  # no card needed: nothing runs
        assert pipeline.make_trace_fn("xla", device) is TRACE.trace
        assert pipeline.make_trace_fn("auto", device) is K2.trace_cuda
        assert pipeline.make_trace_fn("pallas", device) is K2.trace_cuda


def test_a_jax_config_constructs_the_port_config():
    """Every field of the JAX ``RenderConfig``, the four the JAX package
    reads nowhere else included, constructs the port's, with the JAX
    defaults."""
    jax_cfg = JRenderConfig(width=40, height=30, bounce_kernel="xla",
                            max_frames=64, move_speed=3.5, dtype="float32",
                            intersector="pairs", rng="hash")
    cfg = RenderConfig(**dataclasses.asdict(jax_cfg)).validate()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jax_cfg)
    defaults = RenderConfig()
    for f in dataclasses.fields(JRenderConfig):
        assert getattr(defaults, f.name) == getattr(JRenderConfig(), f.name)


@pytest.fixture
def counted_loops(monkeypatch):
    """Counts of calls to the two bounce loops, wherever the renderer, the
    sharded path and adaptive sampling reach them."""
    calls = {"xla": 0, "kernel": 0}

    def counting(key, fn):
        def wrapped(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(TRACE, "trace", counting("xla", TRACE.trace))
    monkeypatch.setattr(pipeline, "trace_cuda",
                        counting("kernel", pipeline.trace_cuda))
    return calls


@pytest.mark.parametrize("kernel", KERNELS)
def test_the_sharded_renderer_calls_the_chosen_loop(counted_loops, kernel):
    """A (2, 2) mesh on the CPU: every shard's trace goes through the loop
    ``bounce_kernel`` names (the JAX package's tests/test_multichip.py:133
    passes the field the same way), and the image is the same either
    way."""
    r = Renderer(RenderConfig(width=16, height=16, bounce_kernel=kernel),
                 device="cpu", devices=["cpu"] * 4)
    r.load_scene(cornell_box())
    img = r.render(spp=2)
    used = "xla" if kernel == "xla" else "kernel"
    assert counted_loops[used] >= 4 and counted_loops[
        {"xla": "kernel", "kernel": "xla"}[used]] == 0
    ref = Renderer(RenderConfig(width=16, height=16), device="cpu",
                   devices=["cpu"] * 4)
    ref.load_scene(cornell_box())
    np.testing.assert_array_equal(img, ref.render(spp=2))


@pytest.mark.parametrize("kernel", ["auto", "xla"])
def test_render_adaptive_calls_the_chosen_loop(counted_loops, kernel):
    r = Renderer(RenderConfig(width=16, height=16, max_bounces=2,
                              bounce_kernel=kernel), device="cpu")
    r.load_scene(cornell_box())
    img = adaptive.render_adaptive(r, 6)
    used = "xla" if kernel == "xla" else "kernel"
    assert counted_loops[used] >= 4
    assert counted_loops[{"xla": "kernel", "kernel": "xla"}[used]] == 0
    assert img.shape == (16, 16, 3) and np.isfinite(img).all()
