#!/usr/bin/env python3
"""Drive the PyTorch port's flagship render once on one CUDA card.

Run from the root of a checkout, with no arguments: ``python3 chip_smoke.py``.
It builds the hand-written kernels from ``wgpu_path_tracing_tpu_torch/csrc``
and runs these phases, one line of output each:

1. device: the card's name and power limit, as nvidia-smi reports them;
2. build: nvcc builds the kernels (the seconds, and ptxas' register report);
3. K1 vs plain: the dense closest hit on the 512x512 Cornell camera rays,
   their bounce-1 rays and their bounce-0 shadow rays; ``t`` must be
   bit-equal and ``idx`` equal on every lane;
4. K2 vs plain: the bounce shading at 512x512, bounces 0..2, on
   ``cornell_box()`` and ``material_test_box()``; state, alive and mask
   bit-equal, the float outputs bit-equal or within 2 ulp on at most 0.01%
   of lanes;
5. oracle: the 24x24 Cornell render through the kernels against the scalar
   oracle ``tests/oracle.py`` on 14 pixels at frames 0, 1 and 5: no RNG-state
   mismatch and at most one radiance outlier (rtol/atol 2e-3);
6. main path: ``Renderer(RenderConfig(width=512, height=512), device="cuda")``,
   ``load_scene(cornell_box())``, ``render(spp=64)``; the kernels' launch
   counts in that run, the image finite and equal to the plain path's image
   of the same frames (the phase-4 bound), the wall time and Mrays/s; then
   the same box with ``intersector="walk"`` forced for a few spp, and the
   count of pixels where its image differs from the K1 path's;
7. K3 vs plain: the wide-BVH walk on ``cornell_box(tessellation=55)``
   (102,852 triangles) at 512x512: the camera rays, the bounce-1 rays of
   one plain bounce and that bounce's shadow rays (``t_max``, ``any_hit``);
   ``t`` and ``idx`` bit-equal on every lane; K3 against K1 on the
   closest-hit rays (lanes that differ, and whether each is an exact-t
   tie); K2 against its plain version at bounce 0 of that scene;
8. large-scene path: ``Renderer(RenderConfig(width=512, height=512))``,
   ``load_scene(cornell_box(tessellation=55))`` (``stats()["intersector"]``
   must be "walk"), ``render(spp=8)``; the launch counts, the build
   seconds, the cold render and the median of repeated renders in Mrays/s,
   and the cold render's image against the plain path's on every pixel.

Then one JSON line of per-kernel numbers, and last the line
``{"ok": true, "device": {...}}``. Any failure raises: the exit code is not
0 and the ok line is not printed. Without CUDA, or outside a checkout of the
repository, it fails the same way.

``--profile PATH`` also writes a ``torch.profiler`` table of four
main-path frames to PATH, and of four large-scene frames to PATH with
``_large`` before its extension, and prints the device's busy share.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

from wgpu_path_tracing_tpu_torch import (  # noqa: E402
    Camera,
    Renderer,
    RenderConfig,
    cornell_box,
    load_jax_scene,
    material_test_box,
)
from wgpu_path_tracing_tpu_torch.models.types import pack_device_scene  # noqa: E402
from wgpu_path_tracing_tpu_torch.ops import bounce as K2  # noqa: E402
from wgpu_path_tracing_tpu_torch.ops import cuda_lib  # noqa: E402
from wgpu_path_tracing_tpu_torch.ops import dense_hit as K1  # noqa: E402
from wgpu_path_tracing_tpu_torch.ops import trace as TRACE  # noqa: E402
from wgpu_path_tracing_tpu_torch.ops import vec  # noqa: E402
from wgpu_path_tracing_tpu_torch.ops import walk as K3  # noqa: E402
from wgpu_path_tracing_tpu_torch.ops.camera_rays import (  # noqa: E402
    generate_rays,
    pixel_grid,
)
from wgpu_path_tracing_tpu_torch.ops.intersect import make_closest_hit  # noqa: E402
from wgpu_path_tracing_tpu_torch.render.pipeline import (  # noqa: E402
    camera_device,
    render_chunk,
    tile_pixels,
)
from wgpu_path_tracing_tpu_torch.utils.tiling import (  # noqa: E402
    inverse_permutation,
    tile_permutation,
)

SIZE = 512
SPP = 64
REPEATS = 7
MAX_BOUNCES = 8
# The large-scene path (the JAX package's bench config 5, "large-100k").
LARGE_TESSELLATION = 55
LARGE_SPP = 8
FORCED_WALK_SPP = 4  # the flagship box through the walk
# Phase-4 bound for float outputs that are not bit-equal.
MAX_ULP = 2
MAX_ULP_LANE_SHARE = 1e-4
# tests/test_parity.py's sample pixels and bars (24x24 image).
ORACLE_SIZE = 24
SAMPLE_PIXELS = [
    (0, 0), (23, 0), (0, 23), (23, 23), (12, 12), (6, 12), (18, 12),
    (12, 20), (12, 4), (3, 18), (20, 6), (9, 9), (15, 15), (4, 4),
]


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def ordered(x: torch.Tensor) -> torch.Tensor:
    """float32 bits as int64 that order like the floats (for ulp counts)."""
    b = x.contiguous().view(torch.int32).to(torch.int64)
    return torch.where(b < 0, -(b & 0x7FFFFFFF), b)


def compare(kernel: torch.Tensor, plain: torch.Tensor):
    """(lanes whose bits differ, max ulp distance, max |difference| over
    finite values) for (N,) or (rows, N) tensors."""
    if kernel.dtype != torch.float32:
        diff = (kernel != plain).reshape(-1, kernel.shape[-1]).any(0)
        return int(diff.sum()), 0, 0.0
    ulp = (ordered(kernel) - ordered(plain)).abs().reshape(
        -1, kernel.shape[-1]).amax(0)
    fin = torch.isfinite(kernel) & torch.isfinite(plain)
    err = torch.where(fin, (kernel - plain).abs(), torch.zeros_like(kernel))
    return int((ulp != 0).sum()), int(ulp.max()), float(err.max())


def within_bound(lanes: int, max_ulp: int, n: int, exact: bool) -> bool:
    if lanes == 0:
        return True
    return (not exact and max_ulp <= MAX_ULP
            and lanes <= MAX_ULP_LANE_SHARE * n)


def _events_ms(run, reps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int = 20) -> float:
    """Device milliseconds per call: ``reps`` calls captured into one CUDA
    graph and replayed between two CUDA events, so the host's launch
    overhead is not in the number."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return _events_ms(graph.replay, reps)


def eager_ms(fn, reps: int = 20) -> float:
    """Milliseconds per call as the main path makes them (launched one by
    one from Python), by CUDA events."""
    fn()
    torch.cuda.synchronize()
    return _events_ms(lambda: [fn() for _ in range(reps)], reps)


def time_pair(kernel_fn, plain_fn):
    """Kernel and plain version, each timed twice in the order plain,
    kernel, kernel, plain. Returns (device ms, eager ms) pairs
    ((kernel, plain), (kernel, plain))."""
    out = []
    for timer in (device_ms, eager_ms):
        p1, k1, k2, p2 = (timer(plain_fn), timer(kernel_fn),
                          timer(kernel_fn), timer(plain_fn))
        out.append(((k1 + k2) / 2, (p1 + p2) / 2))
    return out


def flagship_rays(scene_np, dev):
    """Frame-0 camera rays of the flagship camera, in the main path's tile
    lane order."""
    scene = load_jax_scene(pack_device_scene(scene_np), dev)
    camera = Camera(width=SIZE, height=SIZE, aspect=1.0)
    cam = camera_device(camera.as_pytree(), SIZE, SIZE)
    x, y = tile_pixels(SIZE, SIZE, dev)
    ro, rd, state = generate_rays(cam, x, y, 0,
                                  use_dof=float(camera.aperture) > 0.0)
    return scene, torch.cat([ro, rd]).contiguous(), state


def phase_k1(dev, report):
    scene_np = cornell_box()
    scene, rays, state = flagship_rays(scene_np, dev)
    tri = scene["tri_isect"]
    n = rays.shape[1]
    t, idx = K1.closest_hit_dense_plain(tri, rays)
    outs = K2.bounce_stage_plain(
        0, rays, state, torch.ones((3, n), device=dev),
        torch.zeros((3, n), device=dev),
        torch.ones((n,), dtype=torch.bool, device=dev), t, idx,
        scene["tri_full"], scene["light_full"], do_mis=True,
        num_lights=scene_np.num_lights)
    worst = 0.0
    for name, r in (("camera", rays), ("bounce-1", outs[0]),
                    ("shadow-0", outs[5])):
        r = r.contiguous()
        tk, ik = K1.closest_hit_dense_cuda(tri, r)
        tp, ip = K1.closest_hit_dense_plain(tri, r)
        t_lanes, t_ulp, t_err = compare(tk, tp)
        i_lanes = int((ik != ip).sum())
        say("k1", f"{name} rays: {n} lanes, t differs on {t_lanes} "
            f"(max {t_ulp} ulp), idx differs on {i_lanes}")
        if t_lanes or i_lanes:
            raise AssertionError(f"K1 disagrees with its plain version on "
                                 f"the {name} rays")
        worst = max(worst, t_err)
    (ms, plain_ms), (eager, plain_eager) = time_pair(
        lambda: K1.closest_hit_dense_cuda(tri, rays),
        lambda: K1.closest_hit_dense_plain(tri, rays))
    say("k1", f"time at {n} rays x {tri.shape[0]} tris: device {ms:.4f} ms "
        f"(plain {plain_ms:.4f} ms); launched from Python {eager:.4f} ms "
        f"(plain {plain_eager:.4f} ms)")
    report["k1"] = {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


K2_OUTPUTS = ("rays", "state", "throughput", "result", "alive", "shadow_rays",
              "shadow_t_max", "shadow_mask", "direct", "pdf")
K2_EXACT = {"state", "alive", "shadow_mask"}


def phase_k2(dev, report):
    worst = 0.0
    timed = None
    for scene_fn in (cornell_box, material_test_box):
        scene_np = scene_fn()
        scene, rays, state = flagship_rays(scene_np, dev)
        n = rays.shape[1]
        thr = torch.ones((3, n), device=dev)
        res = torch.zeros((3, n), device=dev)
        alive = torch.ones((n,), dtype=torch.bool, device=dev)
        for b in range(3):
            t, idx = K1.closest_hit_dense_plain(scene["tri_isect"], rays)
            args = (b, rays, state, thr, res, alive, t, idx,
                    scene["tri_full"], scene["light_full"])
            kw = dict(do_mis=True, num_lights=scene_np.num_lights)
            kout = K2.bounce_stage_cuda(*args, **kw)
            pout = K2.bounce_stage_plain(*args, **kw)
            parts = []
            for name, k, p in zip(K2_OUTPUTS, kout, pout):
                lanes, ulp, err = compare(k, p)
                worst = max(worst, err)
                if lanes:
                    parts.append(f"{name} {lanes} lanes/{ulp} ulp")
                if not within_bound(lanes, ulp, n, name in K2_EXACT):
                    raise AssertionError(
                        f"K2 {name} disagrees with its plain version on "
                        f"{scene_fn.__name__} bounce {b}: {lanes} lanes, "
                        f"max {ulp} ulp")
            say("k2", f"{scene_fn.__name__} bounce {b}: {n} lanes, "
                f"{int(alive.sum())} alive; "
                + ("bit-equal" if not parts else "; ".join(parts)))
            if timed is None:
                timed = args, kw
            (rays, state, thr, res, alive, srays, stmax, smask, sdirect,
             spdf) = pout
            shadow_t, _ = K1.closest_hit_dense_plain(scene["tri_isect"],
                                                     srays.contiguous())
            shadow = TRACE.ShadowQuery(
                origin=vec.from_rows(srays, 0),
                direction=vec.from_rows(srays, 3), t_max=stmax, mask=smask,
                direct=vec.from_rows(sdirect, 0), pdf=spdf)
            res = vec.stack_rows(TRACE.resolve_shadow(
                vec.from_rows(res, 0), shadow, shadow_t))
    args, kw = timed
    (ms, plain_ms), (eager, plain_eager) = time_pair(
        lambda: K2.bounce_stage_cuda(*args, **kw),
        lambda: K2.bounce_stage_plain(*args, **kw))
    say("k2", f"time at cornell_box bounce 0, {args[1].shape[1]} rays: "
        f"device {ms:.4f} ms (plain {plain_ms:.4f} ms); launched from "
        f"Python {eager:.4f} ms (plain {plain_eager:.4f} ms)")
    report["k2"] = {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


def load_oracle():
    """tests/oracle.py by path: an installed package named ``tests`` may
    shadow the repository's directory."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "scalar_oracle", os.path.join(REPO, "tests", "oracle.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.Oracle


def phase_oracle(dev):
    Oracle = load_oracle()
    scene_np = cornell_box()
    w = ORACLE_SIZE
    camera = Camera(width=w, height=w, aspect=1.0)
    oracle = Oracle(scene_np, camera.as_pytree(), w, w)
    scene = load_jax_scene(pack_device_scene(scene_np), dev)
    cam = camera_device(camera.as_pytree(), w, w)
    x, y = pixel_grid(w, w, device=dev)
    closest_hit = make_closest_hit(scene)
    for frame in (0, 1, 5):
        ro, rd, state = generate_rays(cam, x, y, frame,
                                      use_dof=float(camera.aperture) > 0.0)
        radiance, end_state, _ = K2.trace_cuda(
            scene, closest_hit, ro, rd, state, max_bounces=MAX_BOUNCES,
            do_mis=True, num_lights=scene_np.num_lights)
        radiance = radiance.T.cpu().numpy()
        end_state = end_state.cpu().numpy()
        states = outliers = 0
        for px, py in SAMPLE_PIXELS:
            lane = py * w + px
            expected = oracle.render_pixel(px, py, frame)
            states += int(end_state[lane]) != int(oracle.rng.state)
            got = np.minimum(radiance[lane], np.float32(2.5))
            outliers += not np.allclose(got, expected, rtol=2e-3, atol=2e-3)
        say("oracle", f"frame {frame}: {len(SAMPLE_PIXELS)} pixels, "
            f"{states} RNG-state mismatches, {outliers} radiance outliers")
        if states or outliers > 1:
            raise AssertionError(f"the kernel path disagrees with the scalar "
                                 f"oracle at frame {frame}")


def plain_render(r: Renderer, spp: int) -> np.ndarray:
    """The frames ``r.render(spp)`` draws after a reset, through the plain
    versions on ``r``'s device: ``ops/trace.py``'s bounce loop and the plain
    dense hit or walk (as ``r`` picked), so no kernel launches. Returns
    (H, W, 3) like ``render``."""
    cfg, dev = r.config, r.device
    scene = load_jax_scene(pack_device_scene(r.scene), dev)
    tri = scene["tri_isect"]
    if r.stats()["intersector"] == "walk":
        tables = K3.walk_tables(scene)

        def closest_hit(ro3, rd3, active=None, t_max=None, any_hit=False):
            return K3.closest_hit_walk_plain(
                tables, ro3, rd3, active, t_max, num_tris=tri.shape[0],
                any_hit=any_hit)
    else:

        def closest_hit(ro3, rd3, active=None, t_max=None, any_hit=False):
            return K1.closest_hit_dense_plain(tri, torch.cat([ro3, rd3]))

    accum = torch.zeros((cfg.width * cfg.height, 3), device=dev)
    render_chunk(TRACE.trace, closest_hit, scene,
                 camera_device(r.camera.as_pytree(), cfg.width, cfg.height),
                 accum, 0, n_frames=spp, width=cfg.width, height=cfg.height,
                 use_dof=float(r.camera.aperture) > 0.0,
                 max_bounces=cfg.max_bounces, do_mis=cfg.do_mis,
                 num_lights=r.scene.num_lights,
                 firefly_clamp=cfg.firefly_clamp)
    row_major = inverse_permutation(tile_permutation(cfg.width, cfg.height))
    return accum.cpu().numpy()[row_major].reshape(cfg.height, cfg.width, 3)


COUNTERS = {"k1": K1.Counter, "k2": K2.Counter, "k3": K3.Counter}


def counted_render(r: Renderer, spp: int, report: dict, path: str,
                   expect: dict):
    """``r.render(spp)`` with every launch count set to 0 just before and
    read just after; the counts must equal ``expect``. Returns (image,
    wall seconds)."""
    torch.cuda.synchronize()
    for counter in COUNTERS.values():
        counter.launches = 0
    t0 = time.perf_counter()
    hdr = r.render(spp=spp)
    secs = time.perf_counter() - t0
    counts = {k: c.launches for k, c in COUNTERS.items()}
    say(path, f"{r.config.width}x{r.config.height} x {spp} spp: launches "
        + ", ".join(f"{k.upper()} {v}" for k, v in counts.items()))
    if counts != expect:
        raise AssertionError(f"{path}: expected launches {expect}")
    for k, v in counts.items():
        report.setdefault(k, {}).setdefault("launches_by_path", {})[path] = v
    if hdr.shape != (r.config.height, r.config.width, 3) or not np.isfinite(
            hdr).all():
        raise AssertionError(f"{path}: the image is not finite or has the "
                             "wrong shape")
    return hdr, secs


def phase_main(dev, smi, report, profile: str | None):
    r = Renderer(RenderConfig(width=SIZE, height=SIZE), device="cuda")
    r.load_scene(cornell_box())
    if r.stats()["intersector"] != "brute":
        raise AssertionError("the flagship box must take the dense hit (K1)")
    hdr, secs = counted_render(
        r, SPP, report, "main", {"k1": 2 * MAX_BOUNCES * SPP,
                                 "k2": MAX_BOUNCES * SPP, "k3": 0})
    report["k1"]["launches"] = report["k1"]["launches_by_path"]["main"]
    report["k2"]["launches"] = report["k2"]["launches_by_path"]["main"]
    stats = r.stats()
    mrays = stats["rays_total"] / secs / 1e6
    say("main", f"wall {secs:.3f} s, {stats['rays_total']} rays "
        f"({stats['rays_closest']} closest + {stats['rays_shadow']} shadow), "
        f"{mrays:.3f} Mrays/s on {smi}")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "cornell.png")
        r.save_png(path)
        say("main", f"PNG {os.path.getsize(path)} bytes, mean display "
            f"value {float(r.image().mean()):.4f}")

    launched = {k: c.launches for k, c in COUNTERS.items()}
    t0 = time.perf_counter()
    hdr_plain = plain_render(r, SPP)
    plain_secs = time.perf_counter() - t0
    if {k: c.launches for k, c in COUNTERS.items()} != launched:
        raise AssertionError("the plain path launched a kernel")
    lanes, ulp, err = compare(torch.from_numpy(hdr.reshape(-1, 3).T.copy()),
                              torch.from_numpy(hdr_plain.reshape(-1, 3).T.copy()))
    say("main", f"plain path: wall {plain_secs:.3f} s; its image differs "
        f"from the kernels' on {lanes} of {SIZE * SIZE} pixels "
        f"(max {ulp} ulp, max abs {err:.3g})")
    if not within_bound(lanes, ulp, SIZE * SIZE, exact=False):
        raise AssertionError("the kernel path's image disagrees with the "
                             "plain path's")
    # The wall clock of one render moves with the host (eager launches from
    # Python): time REPEATS more renders of the same frames.
    walls = []
    for _ in range(REPEATS):
        r.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r.render(spp=SPP, fetch=False)
        walls.append(time.perf_counter() - t0)
    q1, med, q3 = np.percentile(walls, [25, 50, 75])
    say("main", f"{REPEATS} more renders of the same {SPP} spp: wall median "
        f"{med:.4f} s (quartiles {q1:.4f}, {q3:.4f}; min {min(walls):.4f}, "
        f"max {max(walls):.4f}), {stats['rays_total'] / med / 1e6:.3f} "
        f"Mrays/s at the median on {smi}")
    report["main"] = {"seconds": secs, "mrays_per_sec": mrays,
                      "repeat_median_seconds": float(med),
                      "repeat_seconds": walls, "plain_seconds": plain_secs}
    if profile:
        profile_frames(r, profile, "main")

    # The same box through the walk (K3 forced), against the K1 path.
    w = Renderer(RenderConfig(width=SIZE, height=SIZE, intersector="walk"),
                 device="cuda")
    w.load_scene(cornell_box())
    if w.stats()["intersector"] != "walk":
        raise AssertionError("intersector='walk' did not take the walk")
    walk_hdr, _ = counted_render(
        w, FORCED_WALK_SPP, report, "forced_walk",
        {"k1": 0, "k2": MAX_BOUNCES * FORCED_WALK_SPP,
         "k3": 2 * MAX_BOUNCES * FORCED_WALK_SPP})
    r.reset()
    dense_hdr = r.render(spp=FORCED_WALK_SPP)
    pixels = int((walk_hdr != dense_hdr).any(-1).sum())
    say("main", f"the flagship box through K3 ({FORCED_WALK_SPP} spp): its "
        f"image differs from the K1 path's on {pixels} of {SIZE * SIZE} "
        "pixels")
    report["main"]["forced_walk_pixels_differing"] = pixels
    if pixels > 0.001 * SIZE * SIZE:
        raise AssertionError("the walk and the dense hit disagree on more "
                             "than 0.1% of the flagship's pixels")


def phase_k3(dev, report):
    scene_np = cornell_box(tessellation=LARGE_TESSELLATION)
    t0 = time.perf_counter()
    scene, rays, state = flagship_rays(scene_np, dev)
    say("k3", f"{scene_np.num_triangles} triangles; packed and uploaded in "
        f"{time.perf_counter() - t0:.2f} s")
    tables = K3.walk_tables(scene)
    tri = scene["tri_isect"]
    nt = tri.shape[0]
    n = rays.shape[1]
    say("k3", f"wide BVH: {tables.order.shape[0]} nodes, "
        f"{tables.tris.shape[0] // K3.GROUP_ROWS} leaf groups, stack "
        f"{tables.stack} of {K3.STACK_MAX} entries")
    t, idx = K3.closest_hit_walk_plain(tables, rays[0:3], rays[3:6],
                                       num_tris=nt)
    args = (0, rays, state, torch.ones((3, n), device=dev),
            torch.zeros((3, n), device=dev),
            torch.ones((n,), dtype=torch.bool, device=dev), t, idx,
            scene["tri_full"], scene["light_full"])
    kw = dict(do_mis=True, num_lights=scene_np.num_lights)
    kout = K2.bounce_stage_cuda(*args, **kw)
    pout = K2.bounce_stage_plain(*args, **kw)
    parts = []
    for name, k, p in zip(K2_OUTPUTS, kout, pout):
        lanes, ulp, err = compare(k, p)
        report["k2"]["max_abs_err"] = max(report["k2"]["max_abs_err"], err)
        if lanes:
            parts.append(f"{name} {lanes} lanes/{ulp} ulp")
        if not within_bound(lanes, ulp, n, name in K2_EXACT):
            raise AssertionError(f"K2 {name} disagrees with its plain version "
                                 f"on the large box: {lanes} lanes, max {ulp} "
                                 "ulp")
    say("k2", f"cornell_box(tessellation={LARGE_TESSELLATION}) bounce 0: {n} "
        "lanes; " + ("bit-equal" if not parts else "; ".join(parts)))

    bounce, alive = pout[0].contiguous(), pout[4]
    shadow, smask, stmax = pout[5].contiguous(), pout[7], pout[6]
    cases = [("camera", rays, {}),
             ("bounce-1", bounce, {"active": alive}),
             ("shadow-0", shadow, {"active": smask, "t_max": stmax,
                                   "any_hit": True})]
    worst = 0.0
    for name, r, extra in cases:
        o, d = r[0:3], r[3:6]
        kt, ki = K3.closest_hit_walk(tables, o, d, num_tris=nt, **extra)
        pt, pi = K3.closest_hit_walk_plain(tables, o, d, num_tris=nt, **extra)
        t_lanes, t_ulp, t_err = compare(kt, pt)
        i_lanes = int((ki != pi).sum())
        say("k3", f"{name} rays: {n} lanes ({int((pi >= 0).sum())} hits), t "
            f"differs on {t_lanes} (max {t_ulp} ulp), idx differs on "
            f"{i_lanes}")
        if t_lanes or i_lanes:
            raise AssertionError(f"K3 disagrees with its plain version on the "
                                 f"{name} rays")
        worst = max(worst, t_err)
        if name == "shadow-0":
            continue
        # K3 against the dense K1 on the same closest-hit rays.
        dt, di = K1.closest_hit_dense_cuda(tri, r.contiguous())
        if "active" in extra:
            dt = torch.where(extra["active"], dt, torch.inf)
            di = torch.where(extra["active"], di, -1)
        idx_apart = ki != di
        t_apart = kt != dt
        ties = not bool(t_apart.any())  # idx differs only where t is equal
        say("k3", f"{name} rays against K1: idx differs on "
            f"{int(idx_apart.sum())} lanes, t on {int(t_apart.sum())}; every "
            f"difference an exact-t tie: {'yes' if ties else 'no'}")
        if int((idx_apart | t_apart).sum()) > 0.01 * n:
            raise AssertionError(f"K3 and K1 disagree on more than 1% of the "
                                 f"{name} rays")
    o, d = rays[0:3], rays[3:6]
    ms = device_ms(lambda: K3.closest_hit_walk(tables, o, d, num_tris=nt))
    eager = eager_ms(lambda: K3.closest_hit_walk(tables, o, d, num_tris=nt))
    plain = eager_ms(lambda: K3.closest_hit_walk_plain(tables, o, d,
                                                       num_tris=nt), reps=2)
    bo, bd = bounce[0:3], bounce[3:6]
    bounce_ms = device_ms(lambda: K3.closest_hit_walk(
        tables, bo, bd, active=alive, num_tris=nt))
    say("k3", f"time at {n} camera rays x {nt} tris: device {ms:.4f} ms "
        f"(plain {plain:.4f} ms, launched from Python, which the plain "
        f"walk's per-iteration host syncs need); launched from Python "
        f"{eager:.4f} ms; bounce-1 rays: device {bounce_ms:.4f} ms")
    report.setdefault("k3", {}).update(
        max_abs_err=worst, ms=ms, plain_ms=plain, bounce_ms=bounce_ms)


def phase_large(dev, smi, report, profile: str | None):
    t0 = time.perf_counter()
    scene_np = cornell_box(tessellation=LARGE_TESSELLATION)
    sah = time.perf_counter() - t0
    r = Renderer(RenderConfig(width=SIZE, height=SIZE), device="cuda")
    t0 = time.perf_counter()
    r.load_scene(scene_np)
    torch.cuda.synchronize()
    build = time.perf_counter() - t0
    if r.stats()["intersector"] != "walk":
        raise AssertionError("the large box must take the walk (K3)")
    say("large", f"{scene_np.num_triangles} triangles: the scene and its "
        f"SAH BVH {sah:.2f} s, load_scene (wide collapse, packing, upload) "
        f"{build:.2f} s; intersector {r.stats()['intersector']!r}")
    hdr, secs = counted_render(
        r, LARGE_SPP, report, "large",
        {"k1": 0, "k2": MAX_BOUNCES * LARGE_SPP,
         "k3": 2 * MAX_BOUNCES * LARGE_SPP})
    report["k3"]["launches"] = report["k3"]["launches_by_path"]["large"]
    stats = r.stats()
    rays = stats["rays_total"]
    say("large", f"cold render: wall {secs:.3f} s, {rays} rays "
        f"({stats['rays_closest']} closest + {stats['rays_shadow']} "
        f"shadow), {rays / secs / 1e6:.3f} Mrays/s on {smi}")
    walls = []
    for _ in range(REPEATS):
        r.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r.render(spp=LARGE_SPP, fetch=False)
        walls.append(time.perf_counter() - t0)
    q1, med, q3 = np.percentile(walls, [25, 50, 75])
    say("large", f"{REPEATS} more renders of the same {LARGE_SPP} spp: wall "
        f"median {med:.4f} s (quartiles {q1:.4f}, {q3:.4f}; min "
        f"{min(walls):.4f}, max {max(walls):.4f}), {rays / med / 1e6:.3f} "
        f"Mrays/s at the median ({rays / q3 / 1e6:.3f} and "
        f"{rays / q1 / 1e6:.3f} at the quartiles) on {smi}")
    launched = {k: c.launches for k, c in COUNTERS.items()}
    t0 = time.perf_counter()
    hdr_plain = plain_render(r, LARGE_SPP)
    plain_secs = time.perf_counter() - t0
    if {k: c.launches for k, c in COUNTERS.items()} != launched:
        raise AssertionError("the plain path launched a kernel")
    pixels = int((hdr.view(np.uint32) != hdr_plain.view(np.uint32))
                 .any(-1).sum())
    say("large", f"plain path ({SIZE}x{SIZE} x {LARGE_SPP} spp): wall "
        f"{plain_secs:.3f} s; its image differs from the kernels' on "
        f"{pixels} of {SIZE * SIZE} pixels")
    if pixels:
        raise AssertionError("the large scene's kernel-path image differs "
                             "from the plain path's")
    if profile:
        root, ext = os.path.splitext(profile)
        profile_frames(r, f"{root}_large{ext}", "large")
    report["large"] = {"triangles": scene_np.num_triangles,
                       "sah_seconds": sah, "build_seconds": build,
                       "seconds": secs,
                       "mrays_per_sec": rays / secs / 1e6,
                       "repeat_median_seconds": float(med),
                       "repeat_quartile_seconds": [float(q1), float(q3)],
                       "repeat_seconds": walls,
                       "plain_seconds": plain_secs}


def short(kernel_name: str) -> str:
    """A device event's name without namespaces, arguments and templates."""
    name = kernel_name.replace("(anonymous namespace)::", "")
    return name.split("(")[0].split("<")[0][:48]


def profile_frames(r: Renderer, path: str, phase: str) -> None:
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    frames = 4
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch_profile(activities=activities):  # the tracer's start-up
        r.render(spp=1, fetch=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r.render(spp=frames, fetch=False)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with torch_profile(activities=activities) as prof:
        r.render(spp=frames, fetch=False)
        torch.cuda.synchronize()
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in device) / 1e3
    by_name: dict = {}
    for e in device:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(prof.key_averages().table(sort_by="self_cuda_time_total",
                                          row_limit=60))
    say(phase, f"profile of {frames} frames: wall {wall_ms:.3f} ms unprofiled, "
        f"device busy {busy_ms:.3f} ms in {len(device)} device events "
        f"({100 * busy_ms / wall_ms:.1f}% of the wall); top: "
        + ", ".join(f"{short(name)} {us / 1e3:.3f} ms" for name, us in top))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", metavar="PATH",
                        help="also write torch.profiler tables of four "
                        "main-path and four large-scene frames to PATH and "
                        "PATH with _large before its extension")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    say("device", f"{name}; nvidia-smi: {smi}; torch {torch.__version__} "
        f"CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    cuda_lib.lib()
    say("build", f"nvcc built {len(cuda_lib.SIGNATURES)} launchers in "
        f"{time.perf_counter() - t0:.2f} s")
    for line in cuda_lib.build_log().splitlines():
        if "registers" in line or "spill" in line:
            say("build", line.strip())

    report: dict = {}
    phase_k1(dev, report)
    phase_k2(dev, report)
    phase_oracle(dev)
    phase_main(dev, smi, report, args.profile)
    phase_k3(dev, report)
    phase_large(dev, smi, report, args.profile)

    pkg = "wgpu_path_tracing_tpu_torch"
    ref = "wgpu_path_tracing_tpu/ops"
    kernels = [
        {"name": "dense_hit", "route": "cuda", "source": f"{pkg}/csrc/dense_hit.cu",
         "replaces": f"{ref}/pallas_kernels.py:38", **report["k1"]},
        {"name": "bounce", "route": "cuda", "source": f"{pkg}/csrc/bounce.cu",
         "replaces": f"{ref}/pallas_bounce.py:412", **report["k2"]},
        {"name": "walk", "route": "cuda", "source": f"{pkg}/csrc/walk.cu",
         "replaces": f"{ref}/walk.py:177", **report["k3"]},
    ]
    print(json.dumps({"kernels": kernels, "main": report["main"],
                      "large": report["large"], "nvidia_smi": smi}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
