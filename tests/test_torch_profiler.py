"""The pass profiler and the frame meter (``utils/profiler.py``) against the
JAX package's, and the ``Renderer``'s side of them: a "path-trace-pass"
sample and frame ticks each chunk, a "blit-pass" section in ``image()``,
``stats()["passes"]`` and ``stats()["frames"]``, and no device sync unless a
section is given ``sync=``.

The same samples go into both profilers, so their statistics are equal
exactly (both sum the same Python floats in the same order).
"""

import numpy as np
import pytest
import torch

from wgpu_path_tracing_tpu.utils import profiler as JPROF
from wgpu_path_tracing_tpu_torch import Renderer, RenderConfig, cornell_box
from wgpu_path_tracing_tpu_torch.utils import profiler as PROF

torch.set_num_threads(1)


@pytest.mark.parametrize("window, samples", [
    (3, (0.010, 0.020, 0.030, 0.040)),  # the JAX test's window drop
    (100, tuple(np.random.default_rng(1).random(250) * 0.05)),
    (1, (0.5,)),
])
def test_pass_profiler_stats_equal_jax(window, samples):
    port, jax_p = PROF.PassProfiler(window=window), JPROF.PassProfiler(
        window=window)
    for label in ("a", "b"):
        for s in samples:
            port.add(label, s)
            jax_p.add(label, s)
    assert port.stats() == jax_p.stats()
    st = port.stats()["a"]
    assert st["count"] == min(window, len(samples))
    if window == 3:  # tests/test_utils.py::test_pass_profiler_stats
        assert abs(st["avg_ms"] - 30.0) < 1e-9
        assert st["min_ms"] == 20.0 and st["max_ms"] == 40.0


def test_frame_meter_matches_jax():
    port, jax_m = PROF.FrameMeter(), JPROF.FrameMeter()
    assert port.stats() == jax_m.stats()  # no frames yet: zeros
    for m in (port, jax_m):
        m.tick()
        m.tick()
        m.tick()
    for st in (port.stats(), jax_m.stats()):  # tests/test_utils.py
        assert st["fps"] > 0 and st["frame_ms"] >= 0
        assert st["min_ms"] <= st["frame_ms"] <= st["max_ms"]
    assert set(port.stats()) == set(jax_m.stats())
    assert PROF.mrays_per_sec(3_000_000, 1.5) == JPROF.mrays_per_sec(
        3_000_000, 1.5)
    assert PROF.mrays_per_sec(10, 0.0) == JPROF.mrays_per_sec(10, 0.0)


def test_section_syncs_only_when_given(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: calls.append(a))
    p = PROF.PassProfiler()
    with p.section("queued"):
        torch.ones(4).sum()
    with p.section("cpu", sync=torch.ones(4)):
        pass
    with p.section("many", sync=[torch.ones(2), torch.zeros(3)]):
        pass
    assert calls == []  # nothing on a CUDA device to wait for
    assert {k: v["count"] for k, v in p.stats().items()} == {
        "queued": 1, "cpu": 1, "many": 1}


def test_trace_annotation_names_a_profiler_range():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with PROF.trace_annotation("path-trace-pass"):
            torch.ones(8).sum()
    assert "path-trace-pass" in {e.key for e in prof.key_averages()}


def test_renderer_passes_and_frames(monkeypatch):
    r = Renderer(RenderConfig(width=16, height=16, max_bounces=2,
                              frames_per_chunk=2), device="cpu")
    r.load_scene(cornell_box())
    st = r.stats()
    assert st["passes"] == {} and st["frames"]["fps"] == 0.0
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: calls.append(a))
    assert r.render(spp=5, sync=False) is None  # chunks of 2, 2 and 1
    assert calls == []
    passes = r.stats()["passes"]
    assert list(passes) == ["path-trace-pass"]
    assert passes["path-trace-pass"]["count"] == 3
    assert r.stats()["frames"]["fps"] > 0  # 5 ticks, 4 frame times
    r.image()
    r.image()
    assert r.stats()["passes"]["blit-pass"]["count"] == 2
    assert r.stats()["passes"]["path-trace-pass"]["count"] == 3
