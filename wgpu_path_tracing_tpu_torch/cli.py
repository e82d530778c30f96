"""Command-line interface: the counterpart of the JAX package's ``cli.py``.

The reference's entry points are browser interactions (drag-drop a .glb,
fly camera, live stats: App.tsx:12-34, controller.ts); headless they are
subcommands:

    python -m wgpu_path_tracing_tpu_torch.cli render scene.glb --spp 512 \\
        --width 512 --height 512 -o out.png
    python -m wgpu_path_tracing_tpu_torch.cli render cornell --mode normal
    python -m wgpu_path_tracing_tpu_torch.cli view cornell --port 8080
    python -m wgpu_path_tracing_tpu_torch.cli info scene.glb
    python -m wgpu_path_tracing_tpu_torch.cli export atrium -o atrium.glb

``render`` takes a .glb or .gltf path or a built-in scene ("cornell",
"cornell-replica", "atrium"); it checkpoints and resumes (--checkpoint,
--resume), previews every chunk (--preview), samples adaptively
(--adaptive), denoises (--denoise), writes the linear radiance (--hdr,
--exr), and takes the environment map, spot-light, rng, debug-view and
camera flags of the JAX package's CLI (the camera defaults are the
reference's, renderer.ts:136-150).

Where it differs from the JAX package's CLI:

* ``--device`` (default "cuda") picks the ``Renderer``'s device, the
  counterpart of the JAX package's platform choice; "cpu" runs each
  kernel's plain PyTorch version (the tests pass it).
* ``--multichip`` renders over every card of ``--device``
  (``Renderer(devices=True)``, ``parallel/shard.py``); with one card it is
  the single-device render.
* There is no ``bench`` subcommand yet: it waits for the port's benchmark.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import numpy as np

INTERSECTORS = ("auto", "brute", "walk", "walk_hbm", "pairs", "phased",
                "cluster", "stack", "bvh")
DEFAULT_CAM_POS = [0.0, 1.0, 2.8]  # renderer.ts:136-150


def _add_camera_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--cam-pos", type=float, nargs=3, default=DEFAULT_CAM_POS,
                   metavar=("X", "Y", "Z"))
    p.add_argument("--cam-yaw", type=float, default=0.0,
                   help="yaw in degrees applied to the default forward "
                        "(0, 0, -1)")
    p.add_argument("--cam-pitch", type=float, default=0.0,
                   help="pitch in degrees")
    p.add_argument("--fov", type=float, default=60.0,
                   help="vertical fov, degrees")
    p.add_argument("--aperture", type=float, default=0.001)
    p.add_argument("--focus-distance", type=float, default=5.0)


def _add_render_args(p: argparse.ArgumentParser, modes: tuple) -> None:
    """The flags ``render`` and ``view`` share."""
    p.add_argument("scene", help=".glb/.gltf path, or 'cornell', "
                   "'cornell-replica' (models/replica.py) or 'atrium' "
                   "(models/gallery.py)")
    p.add_argument("--tessellation", type=int, default=1,
                   help="subdivide the built-in cornell quads NxN")
    p.add_argument("--bounces", type=int, default=8)
    p.add_argument("--no-mis", action="store_true",
                   help="disable NEE+MIS (pt.wgsl:636 DO_MIS)")
    p.add_argument("--frames-per-trace", type=int, default=1,
                   dest="frames_per_trace",
                   help="samples batched into one trace call (see "
                        "RenderConfig)")
    p.add_argument("--mode", choices=modes, default="pt")
    p.add_argument("--rng", choices=("reference", "hash", "stratified"),
                   default="reference")
    p.add_argument("--intersector", choices=INTERSECTORS, default="auto")
    p.add_argument("--env-map", default=None, metavar="PATH",
                   help="equirect environment map (.hdr, uncompressed "
                        "float .exr, or PNG); default: misses are black, "
                        "as in the reference")
    p.add_argument("--env-intensity", type=float, default=1.0)
    p.add_argument("--env-rotation", type=float, default=0.0,
                   help="environment yaw in degrees")
    p.add_argument("--spot-lights", action="store_true",
                   help="render KHR spot lights (the reference warns and "
                        "skips them, gpu.ts:234-236)")
    p.add_argument("--device", default="cuda",
                   help="the Renderer's device: 'cuda' (the kernels) or "
                        "'cpu' (their plain versions)")
    _add_camera_args(p)


def _build_renderer(args):
    from wgpu_path_tracing_tpu_torch import Camera, Renderer, RenderConfig

    cfg = RenderConfig(
        width=args.width,
        height=args.height,
        max_bounces=args.bounces,
        do_mis=not args.no_mis,
        frames_per_chunk=args.chunk,
        frames_per_trace=args.frames_per_trace,
        mode=args.mode,
        rng=args.rng,
        intersector=args.intersector,
        spot_lights=args.spot_lights,
        env_map=args.env_map,
        env_intensity=args.env_intensity,
        env_rotation=math.radians(args.env_rotation),
    )
    cam = Camera(
        width=args.width,
        height=args.height,
        aspect=args.width / args.height,
        fov=math.radians(args.fov),
        aperture=args.aperture,
        focus_distance=args.focus_distance,
    )
    cam.position = np.asarray(args.cam_pos, np.float32)
    r = Renderer(cfg, cam, device=args.device,
                 devices=True if getattr(args, "multichip", False) else None)
    if args.cam_yaw or args.cam_pitch:
        r.camera.rotate(math.radians(args.cam_yaw),
                        math.radians(args.cam_pitch))
    return r


def _load_scene_arg(r, args) -> None:
    """A .glb path or a named built-in; "cornell-replica" and "atrium" also
    place the camera for their scene unless --cam-pos was given."""
    from wgpu_path_tracing_tpu_torch import (
        cornell_box,
        cornell_replica,
        gallery_atrium,
    )
    from wgpu_path_tracing_tpu_torch.models.replica import (
        REPLICA_CAMERA_POSITION,
    )

    default_cam = list(args.cam_pos) == DEFAULT_CAM_POS
    if args.scene == "cornell":
        r.load_scene(cornell_box(tessellation=args.tessellation))
    elif args.scene == "cornell-replica":
        r.load_scene(cornell_replica())
        if default_cam:
            r.camera.position = np.asarray(REPLICA_CAMERA_POSITION,
                                           np.float32)
    elif args.scene == "atrium":
        r.load_scene(gallery_atrium())
        if default_cam:
            r.camera.position = np.asarray([0.0, 2.4, 3.0], np.float32)
    else:
        r.load_model(args.scene)


def cmd_render(args) -> int:
    from wgpu_path_tracing_tpu_torch.utils.image import (
        buffer_to_srgb,
        write_png,
    )

    r = _build_renderer(args)
    _load_scene_arg(r, args)

    if args.resume and args.checkpoint:
        try:
            r.load_checkpoint(args.checkpoint)
            print(f"resumed at {r.frame_index} spp", file=sys.stderr)
        except FileNotFoundError:
            pass

    if args.mode != "pt":
        write_png(args.output, np.clip(r.render_debug(), 0, 1)[::-1])
        print(f"wrote {args.output} ({args.mode} mode)")
        return 0

    t0 = time.perf_counter()
    # A bare --preview writes the preview over the output path.
    preview_path = args.output if args.preview == "" else args.preview

    def on_chunk(frames):
        if args.verbose:
            print(f"  {frames} spp ({time.perf_counter() - t0:.1f}s)",
                  file=sys.stderr)
        if preview_path:
            # The reference blits the accumulation every frame
            # (renderer.ts:434-448); headless, the tonemapped image on disk
            # is refreshed every chunk.
            r.save_png(preview_path, denoise=args.denoise)

    remaining = args.spp - (r.frame_index if args.resume else 0)
    adaptive_hdr = None
    if args.adaptive and remaining > 0:
        adaptive_hdr = r.render_adaptive(remaining)
    elif remaining > 0:
        r.render(remaining,
                 on_chunk=on_chunk if (args.verbose or preview_path) else None,
                 fetch=False)  # save_png below pulls the buffer once
    if adaptive_hdr is not None:
        if args.denoise:
            adaptive_hdr = r.denoise(hdr=adaptive_hdr)
        write_png(args.output, buffer_to_srgb(
            adaptive_hdr.reshape(-1, 3), r.config.width, r.config.height,
            r.config.exposure))
    else:
        r.save_png(args.output, denoise=args.denoise)
    if args.hdr:
        r.save_hdr(args.hdr)
    if args.exr:
        r.save_exr(args.exr)
    if args.checkpoint:
        r.save_checkpoint(args.checkpoint)
    s = r.stats()
    print(f"wrote {args.output}: {r.frame_index} spp, "
          f"{s['last_render_seconds']:.2f}s, {s['mrays_per_sec']:.1f} Mrays/s "
          f"on {s['device']}")
    return 0


def cmd_view(args) -> int:
    from wgpu_path_tracing_tpu_torch.viewer import ViewerServer

    r = _build_renderer(args)
    _load_scene_arg(r, args)
    server = ViewerServer(r, port=args.port, frames_per_update=args.chunk)
    print(f"viewer at http://localhost:{server.port}", file=sys.stderr)
    try:
        server.run_loop(max_seconds=args.seconds)
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
    return 0


def cmd_info(args) -> int:
    from wgpu_path_tracing_tpu_torch import cornell_box, load_model
    from wgpu_path_tracing_tpu_torch.accel.bvh import BVH

    s = cornell_box() if args.scene == "cornell" else load_model(args.scene)
    bvh = BVH(s.bvh_aabb_min, s.bvh_aabb_max, s.bvh_meta,
              np.arange(s.num_triangles))
    leaf = s.bvh_meta[:, 3] > 0
    print(json.dumps({
        "triangles": s.num_triangles,
        "materials": s.num_materials,
        "lights": s.num_lights,
        "light_types": {
            "emissive": int((s.light_type == 0).sum()),
            "directional": int((s.light_type == 1).sum()),
            "point": int((s.light_type == 2).sum()),
            "spot": int((s.light_type == 3).sum()),
        },
        "bvh_nodes": int(s.bvh_meta.shape[0]),
        "bvh_leaves": int(leaf.sum()),
        "bvh_max_depth": bvh.max_depth(),
        "atlas": None if s.atlas is None else list(s.atlas.shape),
        "transmission_materials": int((s.mat_transmission > 0).sum()),
    }, indent=2))
    return 0


EXPORT_SCENES = ("cornell", "cornell-replica", "textured", "material-box",
                 "atrium")


def cmd_export(args) -> int:
    """Write a named built-in scene as a binary .glb (models/export.py)."""
    from wgpu_path_tracing_tpu_torch import (
        cornell_box,
        cornell_replica,
        gallery_atrium,
        material_test_box,
        scene_to_glb,
        textured_cornell,
    )

    makers = {
        "cornell": lambda: cornell_box(tessellation=args.tessellation),
        "cornell-replica": cornell_replica,
        "textured": textured_cornell,
        "material-box": material_test_box,
        "atrium": gallery_atrium,
    }
    if args.scene not in makers:
        print(f"unknown scene: {args.scene!r} (expected "
              f"{' | '.join(EXPORT_SCENES)})")
        return 2
    scene = makers[args.scene]()
    blob = scene_to_glb(scene)
    with open(args.output, "wb") as f:
        f.write(blob)
    print(f"wrote {args.output}: {len(blob)} bytes, "
          f"{scene.num_triangles} tris, {scene.num_lights} lights")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="wgpu_path_tracing_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    pr = sub.add_parser("render", help="path-trace a scene to a PNG")
    _add_render_args(pr, ("pt", "normal", "bvh_depth"))
    pr.add_argument("-o", "--output", default="out.png")
    pr.add_argument("--spp", type=int, default=64)
    pr.add_argument("--width", type=int, default=512)
    pr.add_argument("--height", type=int, default=512)
    pr.add_argument("--chunk", type=int, default=16,
                    help="samples per render chunk")
    pr.add_argument("--preview", nargs="?", const="", default=None,
                    metavar="PATH",
                    help="write the tonemapped PNG after every chunk "
                         "(default: the output path), like the reference's "
                         "per-frame blit")
    pr.add_argument("--adaptive", action="store_true",
                    help="adaptive sampling (render/adaptive.py): a uniform "
                         "warmup, then the budget goes to the noisiest "
                         "pixels")
    pr.add_argument("--denoise", action="store_true",
                    help="edge-avoiding a-trous denoise of the PNG "
                         "(ops/denoise.py; --hdr/--exr and checkpoints stay "
                         "raw)")
    pr.add_argument("--hdr", metavar="PATH",
                    help="also write the linear radiance as Radiance .hdr")
    pr.add_argument("--exr", metavar="PATH",
                    help="also write the linear radiance as OpenEXR (f32)")
    pr.add_argument("--checkpoint", help="npz accumulation checkpoint path")
    pr.add_argument("--resume", action="store_true")
    pr.add_argument("-v", "--verbose", action="store_true")
    pr.add_argument("--multichip", action="store_true",
                    help="shard the render over every card of --device "
                         "(parallel/shard.py)")
    pr.set_defaults(func=cmd_render)

    pv = sub.add_parser("view", help="live progressive viewer (HTTP) with a "
                        "fly camera")
    _add_render_args(pv, ("pt",))
    pv.add_argument("--port", type=int, default=8080)
    pv.add_argument("--width", type=int, default=256)
    pv.add_argument("--height", type=int, default=256)
    pv.add_argument("--chunk", type=int, default=4,
                    help="samples rendered per viewer tick")
    pv.add_argument("--seconds", type=float, default=None,
                    help="stop after N seconds (default: run until Ctrl-C)")
    pv.set_defaults(func=cmd_view)

    pi = sub.add_parser("info", help="scene statistics (triangles, BVH, "
                        "lights)")
    pi.add_argument("scene", help="'cornell' or a .glb/.gltf path")
    pi.set_defaults(func=cmd_info)

    pe = sub.add_parser("export", help="write a built-in scene as .glb "
                        "(models/export.py)")
    pe.add_argument("scene", help=" | ".join(EXPORT_SCENES))
    pe.add_argument("-o", "--output", required=True)
    pe.add_argument("--tessellation", type=int, default=1,
                    help="subdivide cornell quads (tris scale ~t^2)")
    pe.set_defaults(func=cmd_export)

    args = parser.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
