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
   of the same frames (the phase-4 bound), the wall time and Mrays/s.

Then one JSON line of per-kernel numbers, and last the line
``{"ok": true, "device": {...}}``. Any failure raises: the exit code is not
0 and the ok line is not printed. Without CUDA, or outside a checkout of the
repository, it fails the same way.

``--profile PATH`` also writes a ``torch.profiler`` table of four
main-path frames to PATH and prints the device's busy share.
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
    dense hit, so no kernel launches. Returns (H, W, 3) like ``render``."""
    cfg, dev = r.config, r.device
    scene = load_jax_scene(pack_device_scene(r.scene), dev)
    tri = scene["tri_isect"]

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


def phase_main(dev, smi, report, profile: str | None):
    r = Renderer(RenderConfig(width=SIZE, height=SIZE), device="cuda")
    r.load_scene(cornell_box())
    torch.cuda.synchronize()
    K1.Counter.launches = 0
    K2.Counter.launches = 0
    t0 = time.perf_counter()
    hdr = r.render(spp=SPP)
    secs = time.perf_counter() - t0
    k1, k2 = K1.Counter.launches, K2.Counter.launches
    report["k1"]["launches"], report["k2"]["launches"] = k1, k2
    stats = r.stats()
    mrays = stats["rays_total"] / secs / 1e6
    say("main", f"{SIZE}x{SIZE} x {SPP} spp: K1 launched {k1} times, "
        f"K2 {k2} times")
    if k1 != 2 * MAX_BOUNCES * SPP or k2 != MAX_BOUNCES * SPP:
        raise AssertionError(f"expected K1 {2 * MAX_BOUNCES * SPP} and K2 "
                             f"{MAX_BOUNCES * SPP} launches")
    if hdr.shape != (SIZE, SIZE, 3) or not np.isfinite(hdr).all():
        raise AssertionError("the image is not finite or has the wrong shape")
    say("main", f"wall {secs:.3f} s, {stats['rays_total']} rays "
        f"({stats['rays_closest']} closest + {stats['rays_shadow']} shadow), "
        f"{mrays:.3f} Mrays/s on {smi}")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "cornell.png")
        r.save_png(path)
        say("main", f"PNG {os.path.getsize(path)} bytes, mean display "
            f"value {float(r.image().mean()):.4f}")

    t0 = time.perf_counter()
    hdr_plain = plain_render(r, SPP)
    plain_secs = time.perf_counter() - t0
    if (K1.Counter.launches, K2.Counter.launches) != (k1, k2):
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
        profile_frames(r, profile)


def short(kernel_name: str) -> str:
    """A device event's name without namespaces, arguments and templates."""
    name = kernel_name.replace("(anonymous namespace)::", "")
    return name.split("(")[0].split("<")[0][:48]


def profile_frames(r: Renderer, path: str) -> None:
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
    say("profile", f"{frames} frames: wall {wall_ms:.3f} ms unprofiled, "
        f"device busy {busy_ms:.3f} ms in {len(device)} device events "
        f"({100 * busy_ms / wall_ms:.1f}% of the wall); top: "
        + ", ".join(f"{short(name)} {us / 1e3:.3f} ms" for name, us in top))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", metavar="PATH",
                        help="also write a torch.profiler table of four "
                        "main-path frames to PATH")
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

    pkg = "wgpu_path_tracing_tpu_torch"
    ref = "wgpu_path_tracing_tpu/ops"
    kernels = [
        {"name": "dense_hit", "route": "cuda", "source": f"{pkg}/csrc/dense_hit.cu",
         "replaces": f"{ref}/pallas_kernels.py:38", **report["k1"]},
        {"name": "bounce", "route": "cuda", "source": f"{pkg}/csrc/bounce.cu",
         "replaces": f"{ref}/pallas_bounce.py:412", **report["k2"]},
    ]
    print(json.dumps({"kernels": kernels, "main": report["main"],
                      "nvidia_smi": smi}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
