"""Time K3-w16 (csrc/walk.cu, ``wpt_walk16``) and K9 (csrc/atrous.cu)
against the parent's kernels, in turns, in one process on one card, and
measure what bounds the 16-wide walk: each ray's visits and the idle share
of a lockstep group of rays.

    python tools/walk16_levers.py --parent DIR [--variant NAME=DIR ...]
        [--reps 20] [--out FILE]
    python tools/walk16_levers.py --stats-only [--out FILE]

DIR holds the parent commit's ``csrc`` (its ``walk.cu``, ``atrous.cu`` and
``isect.cuh``), for example ``git archive <parent>
wgpu_path_tracing_tpu_torch/csrc | tar -x -C build/parent``. Each
``--variant`` names another ``csrc`` directory whose two sources keep this
tree's C signatures (an edited copy of this tree's, to time one lever).
Each source of each directory is built into its own library with
``ops/cuda_lib.py``'s flags, all at once.

Part 1, the visits (alone with ``--stats-only``): the large box
(``chip_smoke.large_sets``) collapsed at width 16 as phase ``wide16``
collapses it; the plain walk's counts taken per ray (``ray_visits``) on the
camera rays, the bounce-1 rays in the order the wrapper walks them
(``ops/intersect.py::ray_order``) and the shadow-0 rays. For each set:
pops (the kernel's loop steps), interior and leaf visits a ray (mean, p50,
p99), and the idle share of a lockstep group of G consecutive rays, 1 -
sum(steps) / (G x max steps) summed over the groups, at G = 32 (one ray a
thread), 4 (a team of 8 lanes a ray) and 2 (a team of 16).

Part 2, K3-w16: on the same sets (bounce-1 also bare), this tree's and each
variant's kernel must give the parent's bits on every lane, and the parent
the plain version's; then the parent, this tree, the variants and width-8
K3 (this tree's ``wpt_walk`` on the scene's own tables) are timed
(``chip_smoke.device_ms``, a CUDA graph of ``--reps`` calls) in that order
and back again.

Part 3, K9: the flagship's ``denoise()`` inputs at each of its five levels
(steps 1..16, 512x512), and the last level's inputs at steps 32 and 64:
every kernel must equal ``atrous_level_plain`` bit for bit, then each is
timed in turns as in part 2.

Prints ptxas' report of each build, one line a measurement and the card's
name and power limit; ``--out`` also writes them as JSON.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke as CS  # noqa: E402
from wgpu_path_tracing_tpu_torch import (  # noqa: E402
    Renderer,
    RenderConfig,
    cornell_box,
)
from wgpu_path_tracing_tpu_torch.accel import bvh8  # noqa: E402
from wgpu_path_tracing_tpu_torch.ops import cuda_lib  # noqa: E402
from wgpu_path_tracing_tpu_torch.ops import denoise as K9  # noqa: E402
from wgpu_path_tracing_tpu_torch.ops import walk as K3  # noqa: E402
from wgpu_path_tracing_tpu_torch.ops.intersect import ray_order  # noqa: E402

SOURCES = ("walk.cu", "atrous.cu")
SIGS = {name: cuda_lib.SIGNATURES[name]
        for name in ("wpt_walk", "wpt_walk16", "wpt_atrous_level")}
# Lockstep groups of part 1: rays a warp at one ray a thread, a team of 8
# lanes and a team of 16.
GROUPS = (32, 4, 2)
# Part 3's extra steps, on the last level's inputs.
EXTRA_STEPS = (32, 64)


def build(tmp: str, sources: dict) -> dict:
    """Each directory's two libraries, built in parallel from ``sources``
    (name -> csrc directory); returns name -> {source: CDLL}."""
    nvcc = cuda_lib._nvcc()
    procs = {}
    for name, csrc in sources.items():
        for src in SOURCES:
            out = os.path.join(tmp, f"{name}_{src[:-3]}.so")
            procs[name, src] = (out, subprocess.Popen(
                [nvcc, *cuda_lib.NVCC_FLAGS, "-shared", "-o", out,
                 os.path.join(csrc, src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs: dict = {}
    for (name, src), (out, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name} {src}:\n{log}")
        for line in CS.kernel_resources(log):
            print(f"ptxas {name}: {line}", flush=True)
        lib = ctypes.CDLL(out)
        for fn, argtypes in SIGS.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        libs.setdefault(name, {})[src] = lib
    return libs


def ptr(x) -> int | None:
    return None if x is None else x.data_ptr()


def walk_call(lib, fn: str, tables, o, d, nt: int, active=None, t_max=None,
              any_hit=False):
    """One launch of ``fn`` (``wpt_walk16`` or ``wpt_walk``) from ``lib``,
    with ``ops/walk.py``'s arguments."""
    n = o.shape[1]
    t = torch.empty((n,), dtype=torch.float32, device=o.device)
    idx = torch.empty((n,), dtype=torch.int32, device=o.device)
    err = getattr(lib, fn)(
        ptr(tables.order), ptr(tables.boxes), ptr(tables.leaves), ptr(o),
        ptr(d), ptr(active), ptr(t_max), ptr(t), ptr(idx), n, nt,
        int(any_hit), tables.levels, cuda_lib.stream_ptr(o))
    cuda_lib.check(err, fn)
    return t, idx


def atrous_call(lib, args, kw, step: int):
    color, normal, depth, found, var = args
    h, w = depth.shape
    out = torch.empty_like(color)
    out_var = torch.empty_like(var)
    err = lib.wpt_atrous_level(
        ptr(color), ptr(normal), ptr(depth), ptr(found), ptr(var), ptr(out),
        ptr(out_var), h, w, step, float(kw["sigma_normal"]),
        float(kw["sigma_depth"]), float(kw["sigma_lum"]),
        cuda_lib.stream_ptr(color))
    cuda_lib.check(err, "wpt_atrous_level")
    return out, out_var


def bits(x):
    return x.contiguous().view(torch.int32)


def same(a, b) -> bool:
    return all(torch.equal(bits(x), bits(y)) if x.dtype == torch.float32
               else torch.equal(x, y) for x, y in zip(a, b))


def idle_share(steps: torch.Tensor, g: int) -> float:
    """1 - sum(steps) / (g x max steps), summed over consecutive groups of
    ``g`` rays (a short last group padded with rays of no step)."""
    s = steps.to(torch.float64)
    pad = (-s.numel()) % g
    s = torch.cat([s, s.new_zeros(pad)]).view(-1, g)
    lanes = float(s.amax(dim=1).sum()) * g
    return 1.0 - float(s.sum()) / lanes if lanes else 0.0


def wide_sets(dev) -> dict:
    """The large box, its width-16 tables, and the ray sets of parts 1 and
    2: name -> (o, d, keywords); "bounce-1 sorted" holds the bounce-1 rays
    in ``ray_order``."""
    large = CS.large_sets(dev)
    scene_np, scene = large["scene_np"], large["scene"]
    nt = scene_np.num_triangles
    tri = scene["tri_isect"].cpu().numpy()[:nt]
    wb = bvh8.build_wide_bvh(scene_np.bvh_aabb_min, scene_np.bvh_aabb_max,
                             scene_np.bvh_meta, tri, pack="ffd", width=16,
                             prefer_native=False)
    sets: dict = {}
    for name, r, extra in large["cases"]:
        sets[name] = (r[0:3].contiguous(), r[3:6].contiguous(), extra)
        if name == "bounce-1":
            order = ray_order(r[0:3], r[3:6], scene["root_box"])
            sets["order"] = order
            sets["bounce-1 sorted"] = (
                r[0:3].index_select(1, order).contiguous(),
                r[3:6].index_select(1, order).contiguous(),
                {k: v.index_select(0, order) for k, v in extra.items()})
    order = sets.pop("order")
    return {"nt": nt, "w16": CS.wide_tables(wb, dev), "w8": large["tables"],
            "sets": sets, "order": order, "nodes": wb.num_nodes,
            "depth": bvh8.wide_depth(wb.meta)}


def visit_stats(wide: dict, smi: str) -> tuple:
    """Part 1; returns (set -> statistics, set -> the plain (t, idx))."""
    out, plain = {}, {}
    tables = wide["w16"]
    for name, (o, d, extra) in wide["sets"].items():
        if name == "bounce-1":
            continue  # the same rays as "bounce-1 sorted", in another order
        per_ray: dict = {}
        plain[name] = K3.closest_hit_walk_plain(
            tables, o, d, num_tris=wide["nt"], ray_visits=per_ray, **extra)
        entry = {}
        for key, v in per_ray.items():
            x = v.to(torch.float64)
            entry[key] = {"mean": float(x.mean()),
                          "p50": float(torch.quantile(x, 0.5)),
                          "p99": float(torch.quantile(x, 0.99)),
                          "max": float(x.max())}
        entry["idle_share"] = {g: idle_share(per_ray["pops"], g)
                               for g in GROUPS}
        out[name] = entry
        if name == "bounce-1 sorted":  # the bare rays' answer, unsorted
            t, idx = plain[name]
            plain["bounce-1"] = (
                torch.empty_like(t).index_copy_(0, wide["order"], t),
                torch.empty_like(idx).index_copy_(0, wide["order"], idx))
        print(f"visits, {name} ({o.shape[1]} rays, width-16 tree of "
              f"{wide['nodes']} nodes, depth {wide['depth']}): "
              + "; ".join(f"{k} mean {e['mean']:.2f} p50 {e['p50']:.0f} "
                          f"p99 {e['p99']:.0f} max {e['max']:.0f}"
                          for k, e in entry.items() if k != "idle_share")
              + "; lockstep idle share of the pops, " + ", ".join(
                  f"{g} rays a group {s:.4f}"
                  for g, s in entry["idle_share"].items())
              + f" (on {smi})", flush=True)
    return out, plain


def walk_times(libs: dict, wide: dict, plain: dict, reps: int,
               smi: str) -> dict:
    """Part 2; returns set -> ms by kernel."""
    names = list(libs)
    nt, w16, w8 = wide["nt"], wide["w16"], wide["w8"]
    out = {}
    for name, (o, d, extra) in wide["sets"].items():
        def run(v, o=o, d=d, extra=extra):
            if v == "w8":
                return walk_call(libs["tree"]["walk.cu"], "wpt_walk", w8, o,
                                 d, nt, **extra)
            return walk_call(libs[v]["walk.cu"], "wpt_walk16", w16, o, d, nt,
                             **extra)

        ref = run("parent")
        torch.cuda.synchronize()
        want = plain.get(name)
        if want is not None and not same(ref, want):
            raise AssertionError(f"the parent's K3-w16 differs from the "
                                 f"plain version on the {name} rays")
        for v in names[1:]:
            if not same(run(v), ref):
                raise AssertionError(f"{v}'s K3-w16 differs from the "
                                     f"parent's on the {name} rays")
        times = {v: [] for v in names + ["w8"]}
        for v in names + ["w8"] + ["w8"] + names[::-1]:
            times[v].append(CS.device_ms(lambda v=v: run(v), reps))
        out[name] = times
        print(f"K3-w16, {name} rays: every kernel equal to the parent's on "
              f"all {o.shape[1]} lanes; device ms a call, in turns: "
              + "; ".join(f"{v} {' / '.join(f'{t:.4f}' for t in ts)}"
                          for v, ts in times.items()) + f" on {smi}",
              flush=True)
    return out


def denoise_levels(dev) -> list:
    """The flagship's ``denoise()`` levels: (args, keywords, step) each,
    then the last level's inputs at EXTRA_STEPS."""
    r = Renderer(RenderConfig(width=CS.SIZE, height=CS.SIZE), device="cuda")
    r.load_scene(cornell_box())
    r.render(spp=CS.SPP)
    levels = []

    def keep(*args, **kw):
        levels.append((tuple(x.contiguous() for x in args[:5]), kw,
                       int(args[5])))
        return K9.atrous_level_plain(*args, **kw)

    r.denoise(level=keep)
    args, kw, _ = levels[-1]
    levels += [(args, kw, step) for step in EXTRA_STEPS]
    return levels


def atrous_times(libs: dict, dev, reps: int, smi: str) -> dict:
    """Part 3; returns step -> ms by kernel."""
    names = list(libs)
    out = {}
    for args, kw, step in denoise_levels(dev):
        want = K9.atrous_level_plain(*args, step, **kw)
        for v in names:
            if not same(atrous_call(libs[v]["atrous.cu"], args, kw, step),
                        want):
                raise AssertionError(f"{v}'s K9 differs from the plain "
                                     f"version at step {step}")
        times = {v: [] for v in names}
        for v in names + names[::-1]:
            times[v].append(CS.device_ms(
                lambda v=v: atrous_call(libs[v]["atrous.cu"], args, kw,
                                        step), reps))
        out[step] = times
        print(f"K9, step {step} ({CS.SIZE}x{CS.SIZE}): every kernel equal "
              "to the plain version on every pixel; device ms a call, in "
              "turns: " + "; ".join(
                  f"{v} {' / '.join(f'{t:.4f}' for t in ts)}"
                  for v, ts in times.items()) + f" on {smi}", flush=True)
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent",
                        help="the parent commit's csrc directory")
    parser.add_argument("--stats-only", action="store_true",
                        help="measure the visits alone (part 1)")
    parser.add_argument("--variant", action="append", default=[],
                        metavar="NAME=DIR",
                        help="another csrc directory of this tree's format")
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--out", help="also write the results as JSON")
    args = parser.parse_args()
    if not args.stats_only and not args.parent:
        parser.error("--parent is needed unless --stats-only")
    if not torch.cuda.is_available():
        raise SystemExit("walk16_levers: CUDA is not available")
    dev = torch.device("cuda")
    smi = CS.nvidia_smi()
    print(f"device: {smi}", flush=True)
    results: dict = {"nvidia_smi": smi}
    with tempfile.TemporaryDirectory() as tmp:
        libs = {}
        if not args.stats_only:
            sources = {"parent": args.parent, "tree": cuda_lib.CSRC_DIR}
            for spec in args.variant:
                name, _, csrc = spec.partition("=")
                if not csrc or name in sources or name == "w8":
                    raise SystemExit(f"walk16_levers: bad --variant {spec!r}")
                sources[name] = csrc
            libs = build(tmp, sources)
        wide = wide_sets(dev)
        results["visits"], plain = visit_stats(wide, smi)
        if libs:
            results["walk_ms"] = walk_times(libs, wide, plain, args.reps,
                                            smi)
            del wide, plain
            results["atrous_ms"] = atrous_times(libs, dev, args.reps, smi)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
