"""Time K7 and K8 (csrc/bvh2.cu) against the parent's kernels, in turns, in
one process on one card, and time the binary walks' ray order on trees of
several sizes.

    python tools/bvh2_levers.py --parent DIR [--variant NAME=DIR ...]
        [--tessellations 3,6,...,55] [--reps 20] [--out FILE]
    python tools/bvh2_levers.py --order-only [--tessellations ...]

DIR holds the parent commit's ``csrc`` (its ``bvh2.cu`` and ``isect.cuh``),
for example ``git archive <parent> wgpu_path_tracing_tpu_torch/csrc | tar
-x -C build/parent``. Each ``--variant`` names another ``csrc`` directory
whose ``bvh2.cu`` takes this tree's tables and C signatures (an edited copy
of this tree's, to time one lever). Each kernel is built from its one
source into its own library with ``ops/cuda_lib.py``'s flags, all at once.

Part 1, the kernels: on the large box's (``chip_smoke.large_sets``)
camera, bounce-1 and shadow-0 rays, K7 and K8 of this tree, of the parent
and of each variant, and K7's depth mode on the debug view's pixel centres,
must give the parent's bits on every lane, and the parent the plain
version's; then each is timed (``chip_smoke.device_ms``, a CUDA graph of
``--reps`` calls) in the order parent, this tree, the variants, and back
again. Each set's bound is ``chip_smoke``'s (``bvh2_bound``,
``bvh2_depth_bound``), from the plain versions' visits.

Part 2, the ray order (alone with ``--order-only``): on ``cornell_box()``
and ``cornell_box(tessellation=t)`` for t in ``--tessellations``, the
bounce-1 rays of the 512x512 camera (``chip_smoke.ray_cases``), through
``make_closest_hit``'s "stack" and "bvh" closures with the ray order's
node threshold lowered to 1: the call with ``reorder`` (sorted, gathered,
walked, scattered back) against the same call without, timed bare,
sorted, sorted, bare; the two must give the same bits.

Prints one line a measurement and the card's name and power limit;
``--out`` also writes them as JSON.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke as CS  # noqa: E402
from wgpu_path_tracing_tpu_torch import cornell_box  # noqa: E402
from wgpu_path_tracing_tpu_torch.debug import modes as DEBUG  # noqa: E402
from wgpu_path_tracing_tpu_torch.ops import cuda_lib  # noqa: E402
from wgpu_path_tracing_tpu_torch.ops import intersect as I  # noqa: E402

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# The parent's C signatures (its ops/cuda_lib.py) and this tree's.
PARENT_SIGS = {
    "wpt_bvh_stack": [_P] * 9 + [_I] * 8 + [_F, _P],
    "wpt_bvh_linked": [_P] * 9 + [_I] * 6 + [_P],
}
SIGS = {name: cuda_lib.SIGNATURES[name]
        for name in ("wpt_bvh_stack", "wpt_bvh_linked")}
# Part 2's boxes besides cornell_box() by default: 308 to 102,852
# triangles, 207 to 66,523 binary nodes.
ORDER_TESSELLATIONS = "3,6,10,16,20,24,30,36,40,48,55"


def build(tmp: str, sources: dict) -> dict:
    """Each kernel's library, built in parallel from ``sources`` (name ->
    csrc directory); returns name -> CDLL."""
    nvcc = cuda_lib._nvcc()
    procs = {}
    for name, csrc in sources.items():
        out = os.path.join(tmp, f"{name}.so")
        procs[name] = (out, subprocess.Popen(
            [nvcc, *cuda_lib.NVCC_FLAGS, "-shared", "-o", out,
             os.path.join(csrc, "bvh2.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (out, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        for line in CS.kernel_resources(log):
            print(f"ptxas {name}: {line}", flush=True)
        lib = ctypes.CDLL(out)
        for fn, argtypes in (PARENT_SIGS if name == "parent"
                             else SIGS).items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def ptr(x) -> int | None:
    return None if x is None else x.data_ptr()


class Walks:
    """Launchers of each kernel over the large box's tables: the parent's
    over the original tables, the others over this tree's staged ones."""

    def __init__(self, scene: dict):
        self.aabb = scene["bvh_aabb"].contiguous()
        self.meta = scene["bvh_meta"].contiguous()
        self.links = I.linked_nodes(scene["bvh_meta"], scene["bvh_links"])
        self.tri = scene["tri_isect"].contiguous()
        self.stack = I.stack_tables(self.aabb, self.meta, self.tri)
        self.linked = I.linked_tables(self.aabb, self.links, self.tri)

    def call(self, lib, parent: bool, kind: str, o, d, active=None,
             t_max=None, any_hit=False, depth_norm=None):
        n = o.shape[1]
        t = torch.empty((n,), dtype=torch.float32, device=o.device)
        idx = torch.empty((n,), dtype=torch.int32, device=o.device)
        rays = [ptr(o), ptr(d), ptr(active), ptr(t_max), ptr(t), ptr(idx)]
        stream = cuda_lib.stream_ptr(o)
        depth = depth_norm is not None
        if kind == "stack":
            head = ([ptr(self.aabb), ptr(self.meta),
                     None if depth else ptr(self.tri)] if parent else
                    [ptr(self.stack.nodes),
                     None if depth else ptr(self.stack.tris)])
            err = lib.wpt_bvh_stack(
                *head, *rays, n, self.aabb.shape[0], self.tri.shape[0],
                I.LEAF_SIZE, I.STACK_DEPTH, int(any_hit), I.STACK_MAX_STEPS,
                int(depth), 1.0 if depth_norm is None else depth_norm,
                stream)
        else:
            head = ([ptr(self.aabb), ptr(self.links), ptr(self.tri)]
                    if parent else
                    [ptr(self.linked.nodes), ptr(self.linked.tris)])
            err = lib.wpt_bvh_linked(
                *head, *rays, n, self.aabb.shape[0], self.tri.shape[0],
                I.LEAF_SIZE, int(any_hit), I.LINKED_MAX_STEPS, stream)
        cuda_lib.check(err, kind)
        return t, idx


def bits(x):
    return x.contiguous().view(torch.int32)


def kernels(libs: dict, large: dict, dev, reps: int, smi: str) -> dict:
    """Part 1 (the module's docstring); returns set -> measurements."""
    scene = large["scene"]
    walks = Walks(scene)
    r = CS.renderer_of(large["scene_np"])
    ro3, rd3 = DEBUG._center_rays(r._camera(), CS.SIZE, CS.SIZE, dev)
    norm = float(DEBUG.MAX_DEPTH)
    sets = [(kind, name, ray[0:3].contiguous(), ray[3:6].contiguous(),
             extra) for kind in ("stack", "bvh")
            for name, ray, extra in large["cases"]]
    sets.append(("depth", "centres", ro3.contiguous(), rd3.contiguous(), {}))
    names = list(libs)
    out = {}
    for kind, name, o, d, extra in sets:
        walk = "stack" if kind == "depth" else kind
        kw = dict(extra, depth_norm=norm if kind == "depth" else None)

        def run(v):
            return walks.call(libs[v], v == "parent", walk, o, d, **kw)

        ref = run("parent")
        for v in names[1:]:
            got = run(v)
            torch.cuda.synchronize()
            if not (torch.equal(bits(got[0]), bits(ref[0]))
                    and (kind == "depth" or torch.equal(got[1], ref[1]))):
                raise AssertionError(f"{v} differs from the parent on "
                                     f"{kind} {name}")
        visits = {}
        t0 = time.perf_counter()
        if kind == "depth":
            plain = I.bvh_depth_plain(walks.aabb, walks.meta, o.T, d.T, norm,
                                      visits=visits)
            same = torch.equal(bits(plain), bits(ref[0]))
            b = CS.bvh2_depth_bound(visits, scene, o.shape[1])
        else:
            plain_fn = (I.closest_hit_bvh_plain if kind == "stack"
                        else I.closest_hit_bvh_linked_plain)
            table = walks.meta if kind == "stack" else walks.links
            pt, pi = plain_fn(walks.aabb, table, walks.tri, o.T, d.T,
                              visits=visits, **extra)
            same = (torch.equal(bits(pt), bits(ref[0]))
                    and torch.equal(pi, ref[1]))
            b = CS.bvh2_bound(visits, scene, o.shape[1])
        if not same:
            raise AssertionError(f"the parent differs from the plain "
                                 f"version on {kind} {name}")
        plain_s = time.perf_counter() - t0
        times = {v: [] for v in names}
        for v in names + names[::-1]:
            times[v].append(CS.device_ms(lambda v=v: run(v), reps))
        out[f"{kind} {name}"] = {"ms": times, **b, "plain_s": plain_s,
                                 "nodes_per_ray": visits["nodes"]
                                 / o.shape[1]}
        print(f"{kind} {name}: bound {b['bound_ms']:.4f} ms "
              f"({b['bound_by']}), {visits['nodes'] / o.shape[1]:.1f} nodes "
              f"a ray; every kernel equal to the parent and the plain "
              f"version; " + "; ".join(f"{v} {min(ts):.4f}-{max(ts):.4f}"
                                       for v, ts in times.items())
              + f" ms on {smi}", flush=True)
    return out


def bounce_rays(scene_np, dev) -> tuple:
    """``scene_np`` on the card and the bounce-1 rays of its 512x512
    camera (hits from K7), with their ``active`` mask."""
    scene, rays, state = CS.flagship_rays(scene_np, dev)
    staged = I.stack_tables(scene["bvh_aabb"], scene["bvh_meta"],
                            scene["tri_isect"])
    t, idx = I.launch_stack(staged, rays[0:3].T, rays[3:6].T)
    _, _, _, cases = CS.ray_cases(scene_np, scene, rays, state, t, idx)
    name, ray, extra = cases[1]
    assert name == "bounce-1"
    return scene, ray[0:3].contiguous(), ray[3:6].contiguous(), extra


def ray_order(dev, tessellations, reps: int, smi: str) -> dict:
    """Part 2 (the module's docstring); returns box -> measurements."""
    I.BVH2_REORDER_MIN_NODES = {"stack": 1, "bvh": 1}
    boxes = [("cornell", cornell_box())]
    boxes += [(f"tessellation={t}", CS.tessellated_box(t)[0])
              for t in tessellations]
    out = {}
    for label, scene_np in boxes:
        scene, o, d, extra = bounce_rays(scene_np, dev)
        nodes = scene["bvh_aabb"].shape[0]
        entry = {"nodes": nodes, "triangles": scene_np.num_triangles}
        for kind in ("stack", "bvh"):
            ch = I.make_closest_hit(scene, kind)
            bare = ch(o, d, **extra)
            got = ch(o, d, reorder=True, **extra)
            if not (torch.equal(bits(got[0]), bits(bare[0]))
                    and torch.equal(got[1], bare[1])):
                raise AssertionError(f"{kind} on {label}: the sorted call "
                                     "differs from the bare one")
            times = {"bare": [], "sorted": []}
            for which in ("bare", "sorted", "sorted", "bare"):
                times[which].append(CS.device_ms(
                    lambda w=which: ch(o, d, reorder=w == "sorted", **extra),
                    reps))
            entry[kind] = times
            print(f"ray order, {kind}, {label} ({nodes} binary nodes, "
                  f"{scene_np.num_triangles} triangles), bounce-1: bare "
                  f"{min(times['bare']):.4f}-{max(times['bare']):.4f}, "
                  f"sorted {min(times['sorted']):.4f}-"
                  f"{max(times['sorted']):.4f} ms; the same bits; on {smi}",
                  flush=True)
        out[label] = entry
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent",
                        help="the parent commit's csrc directory")
    parser.add_argument("--order-only", action="store_true",
                        help="time the ray order alone (part 2)")
    parser.add_argument("--tessellations", default=ORDER_TESSELLATIONS,
                        help="part 2's boxes, comma-separated")
    parser.add_argument("--variant", action="append", default=[],
                        metavar="NAME=DIR",
                        help="another csrc directory of this tree's format")
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--out", help="also write the results as JSON")
    args = parser.parse_args()
    if not args.order_only and not args.parent:
        parser.error("--parent is needed unless --order-only")
    tessellations = [int(t) for t in args.tessellations.split(",") if t]
    if not torch.cuda.is_available():
        raise SystemExit("bvh2_levers: CUDA is not available")
    dev = torch.device("cuda")
    smi = CS.nvidia_smi()
    print(f"device: {smi}", flush=True)
    results = {"nvidia_smi": smi}
    if not args.order_only:
        sources = {"parent": args.parent, "tree": cuda_lib.CSRC_DIR}
        for spec in args.variant:
            name, _, csrc = spec.partition("=")
            if not csrc or name in sources:
                raise SystemExit(f"bvh2_levers: bad --variant {spec!r}")
            sources[name] = csrc
        with tempfile.TemporaryDirectory() as tmp:
            libs = build(tmp, sources)
            large = CS.large_sets(dev)
            results["sets"] = kernels(libs, large, dev, args.reps, smi)
    results["ray_order"] = ray_order(dev, tessellations, args.reps, smi)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
