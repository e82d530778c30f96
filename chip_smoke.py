#!/usr/bin/env python3
"""Drive the PyTorch port's flagship render once on one CUDA card.

Run from the root of a checkout, with no arguments: ``python3 chip_smoke.py``.
It builds the hand-written kernels from ``wgpu_path_tracing_tpu_torch/csrc``
and runs these phases, one line of output each:

1. device: the card's name and power limit, as nvidia-smi reports them;
2. build: nvcc builds the kernels (the seconds, and each compiled
   function's registers, stack frame and spills from ptxas' report);
3. K1 vs plain: the dense closest hit on the 512x512 Cornell camera rays,
   their bounce-1 rays and their bounce-0 shadow rays, and on the
   adversarial classes (``adversarial_case``: edges, vertices, u + v = 1,
   |a| and t at EPSILON, ties, parallel and degenerate directions, ragged
   counts); ``t`` must be bit-equal and ``idx`` equal on every lane; the
   time on each of the three ray sets;
4. K2 vs plain: the bounce shading at 512x512, bounces 0..2, on
   ``cornell_box()``, ``material_test_box()`` and the lane mix
   (``lane_mix_box``, random rays: every lobe, light type and lane class);
   state, alive and mask bit-equal, the float outputs bit-equal or within 2
   ulp on at most 0.01% of lanes; the time at bounce 0 of each; then
   textured K2 under the same bound on ``textured_cornell()``,
   ``textured_cornell(atlas_size=512, congruent=True)`` (fat canvas), the
   256^2 congruent box with a 255^2 pbr rect (no canvas: per slot) and
   ``textured_material_box()`` in both modes, with each one's time and
   texture-slot mask;
5. oracle: the 24x24 Cornell render through the kernels against the scalar
   oracle ``tests/oracle.py`` on 14 pixels at frames 0, 1 and 5: no RNG-state
   mismatch and at most one radiance outlier (rtol/atol 2e-3); then the same
   for ``textured_cornell()`` in both texture modes (the oracle samples per
   slot);
6. main path: ``Renderer(RenderConfig(width=512, height=512), device="cuda")``,
   ``load_scene(cornell_box())``, ``render(spp=64)``; the kernels' launch
   counts in that run, the image finite and equal to the plain path's image
   of the same frames on every pixel, the wall time and Mrays/s; then
   the same box with ``intersector="walk"`` forced for a few spp, and the
   count of pixels where its image differs from the K1 path's; the
   flagship at 64x64 x 8 spp under ``bounce_kernel="auto"``, ``"pallas"``
   and ``"xla"`` (K2 launches 64, 64 and 0), the three images equal on
   every pixel; then the
   textured path: the three textured boxes of phase 4 through the same
   entry points, each 512x512 x 64 spp (``stats()["texture"]`` must read
   "fat", "fat" and "per_slot"), their launch counts, cold and repeated
   Mrays/s, and each image against its plain path's on every pixel;
7. K3 vs plain: the wide-BVH walk on ``cornell_box(tessellation=55)``
   (102,852 triangles) at 512x512: the camera rays, the bounce-1 rays of
   one plain bounce and that bounce's shadow rays (``t_max``, ``any_hit``);
   ``t`` and ``idx`` bit-equal on every lane; K3 against K1 on the
   closest-hit rays (lanes that differ, and whether each is an exact-t
   tie); K3 on an 11-level spine tree (``spine_tables``) against its plain
   version; the sorted walk (``make_closest_hit`` with ``reorder=True``)
   against the bare kernel on the bounce-1 rays, a late-bounce mask of 5%
   of them and the shadow rays, bit for bit; each ray set's time bare,
   sorted and of the sort alone, and the bounds on the camera and bounce-1
   rays; K2 against its plain version at bounce 0 of that scene;
8. large-scene path: ``Renderer(RenderConfig(width=512, height=512))``,
   ``load_scene(cornell_box(tessellation=55))`` (``stats()["intersector"]``
   must be "walk"), ``render(spp=8)``; the launch counts, the build
   seconds, the cold render and the median of repeated renders in Mrays/s,
   and a 1-spp render's image against the plain path's on every pixel;
9. K4, K5, K6 vs plain: the pair dispatch and the round dispatch on the same
   102,852-triangle box and the same three ray sets as phase 7, the phased
   dispatch on ``cornell_box(tessellation=16)`` (8,706 triangles: its flat
   sweep gates every sub-cluster for every ray block, so it is the JAX
   package's choice for mid-size trees only); K4 also on the bounce-1 rays
   and a late-bounce mask of them (5% alive) as ``make_closest_hit``'s
   pair route hands them to it (``with_tail_compaction``: a compaction tier
   and the bucket order), K6 on the late-bounce mask as it is, and K5 on
   the late-bounce mask, on a ray count that fills no block and on the
   large box's camera rays, with each set's device time split between its
   gate and test kernels (``torch.profiler``) and its union-box gate scheme
   (``K5.gate_scheme``) equal to the sub-box gates; ``t``
   and ``idx`` bit-equal to the plain version on every lane of every set,
   and the whole route equal to the bare kernel's result scattered back;
   phase 1's kernel (``csrc/blocks.cu``) equal to ``block_entry`` on every
   set of K4 and K6 (-0 == +0) and its lists to the plain lists; each
   against K3 and K1 on the bare closest-hit rays (lanes that differ, and
   whether each is an exact-t tie); each set's time (the wrapper's whole
   call; phase 1 and the sort alone; the route's whole call where it has
   one) beside its bound, counted from the plain version's ``visits`` on
   the rays as the kernel receives them;
10. dispatch paths: the large box through ``intersector="pairs"`` at 8 spp
   (launch counts, cold and repeated Mrays/s) and its 1-spp image against
   the plain path's (the plain versions behind the same
   ``with_tail_compaction``); the same box packed with the wide build made
   to fail, which ``intersector="auto"`` must take through the pair
   dispatch to the same image; ``"phased"`` (the 8,706-triangle box) and ``"cluster"`` (the
   large box) at 2 spp, and the first frame of each against its plain
   path's;
11. rng modes: K2's bounce-0 LDS instantiation against its plain version at
   512x512 on ``cornell_box()``, ``material_test_box()``, and
   ``textured_cornell()`` and ``textured_material_box()`` each sampled per
   slot and from the fat canvas (the phase-4 bound), with its time beside
   the launch without LDS on each;
   ``Renderer(RenderConfig(width=512, height=512, rng="stratified"))``
   on the Cornell box at 64 spp (launch counts: 64 of the LDS
   instantiation, one a frame; cold and repeated Mrays/s; the image against
   the plain path's of the same frames on every pixel) and ``rng="hash"`` at
   8 spp the same way; ``frames_per_trace=2`` against 1 on the stratified
   flagship (8 spp) and on the large box through the walk (2 spp), equal on
   every pixel; a stratified checkpoint (4 spp, save, load into a fresh
   ``Renderer``, 4 more) equal on every pixel to 8 spp in one go.
12. scene loading (``gltf``): ``gallery_atrium(detail=3)`` (116,430
   triangles, 12 materials, 7 texture map sets) written to a .glb by
   ``scene_to_glb``, then ``Renderer(RenderConfig(width=512, height=512))``,
   ``load_model(path)`` and ``render(spp=8)``: the load's parts in seconds
   (parse, atlas, the whole ``load_model``, the SAH build, packing, upload,
   ``Renderer.load_model``), ``stats()["intersector"]`` "walk" and
   ``stats()["texture"]`` what the scene loaded directly reads, its arrays
   equal to a second round trip's, the launch counts (K3 and K2 in that
   texture mode), cold and repeated Mrays/s, a 1-spp image against the
   plain path's on every pixel, ``stats()["passes"]`` and
   ``stats()["frames"]``; then ``load_model_async`` of the same file while
   ``cornell_box()`` renders 3 chunks: the atrium installed at the second
   chunk's start with the mean restarted there (its two chunks equal to a
   fresh render of the same frames), and a failed async load raising from
   its future and at the next render; then the JPEG reader on this host:
   the small JPEGs under ``tests/jpeg`` (sequential, progressive, CMYK,
   YCCK, block-smoothed, arithmetic-coded, lossless) array-equal to their
   Pillow decode (``pillow_rgba.npz``), each decode's seconds, the 1024^2
   and 2048^2 4:2:0 files' decode seconds, sequential and progressive,
   Huffman- and arithmetic-coded, and the 1024^2 lossless file's (their
   SHA-256 against Pillow's, each within 5 s), the seconds of
   ``JPEG_PYTHON_TIMED`` through the plain Python entropy decoder, and
   ``textured_cornell(tessellation=12)`` twice, with the progressive,
   CMYK and YCCK JPEGs as its textures and with the arithmetic-coded and
   lossless ones, each written to a .gltf and loaded by ``load_model``
   (the walk, the fat canvas), 512x512 x 8 spp with its launches, and its
   1-spp image against the plain path's;
13. environment map (``env``): K2's ENV instantiation against its plain
   version at bounces 0..2 on ``material_test_box()`` (open: many rays
   miss), ``textured_cornell()`` and ``textured_material_box()`` each
   sampled from the fat canvas and per slot, and the lane mix, each under
   a numpy-made 64x128 map with intensity 1.5 and rotation 0.7 rad, and
   with LDS rows at bounce 0 (the phase-4 bound); its time on each at
   bounce 0, beside the same launch without the map and K2 without a map
   on the Cornell box; then the material box at 512x512 x 64 spp through
   ``set_environment``: launch counts (512 of the ENV instantiation), cold
   and repeated Mrays/s, the image against the plain path's on every pixel,
   and its renders in turns with the same box's without the map;
   then the material box at 512x512 x 8 spp under each committed
   progressive JPEG map, Huffman- and arithmetic-coded
   (``RenderConfig.env_map``): its launches (K1, K2, K2's ENV
   instantiation) and its image against the plain path's;
14. binary-BVH walks (``bvh2``): their division (``csrc/bvh2.cu`` div_by)
   against ``/`` bit for bit (a zero numerator's sign aside, ``div_apart``)
   on 2^24 random bit patterns, the special operands and 2^22 pairs in and
   around its fast window (``div_operands``); the ptxas report of K7 and
   K8 (registers, stack frame, spills); K7 (the stack walk) and K8 (the
   linked walk), over their records staged once, against their plain
   versions on the large box's camera, bounce-1 and shadow rays (an active
   mask, ``t_max``, ``any_hit``), bit for bit, and against K3 (lanes that
   differ, and whether each is an exact-t tie; the shadow rays' occlusion
   answers), each set's time beside its bound (from the plain versions'
   node and triangle counts);
15. debug views (``debug``): ``mode="bvh_depth"`` and ``mode="normal"`` at
   512x512 on ``cornell_box()`` and the large box, each equal to its plain
   path on every pixel (K7's depth mode timed on the large box, beside its
   bound); 1-spp Cornell renders through ``"stack"`` and ``"bvh"`` (launch
   counts), each equal to its plain path and, but for exact-t ties (at
   most 1% of pixels), to the K1 path's image; 128x128 renders of
   ``cornell_box(tessellation=30)`` (19,603 binary nodes) through both at
   two bounces, bounce 1's calls in ray order (``BVH2_REORDER_MIN_NODES``),
   each equal to its plain path;
16. denoising (``denoise``): the flagship at 64 spp, then ``aovs()``,
   ``denoise()`` (launch counts: the guides' K1 and five K9) and
   ``image(denoise=True)``; K9 against its plain version at every level on
   the path's own inputs, bit for bit; the whole ``denoise()`` against its
   plain path; ptxas' report of K9; K9's time a level (each step) beside
   its bound, the plain level's, the whole filter's and ``denoise()``'s
   wall;
17. adaptive sampling (``adaptive``): ``render_adaptive(64)`` on the
   flagship (launch counts, wall, Mrays/s; its ``render_adaptive(16)``
   image against its plain path on every pixel) and
   ``render_adaptive(8)`` on the large box through the walk (launch counts,
   wall, Mrays/s); the walk's adaptive image held to its plain path on
   ``cornell_box(tessellation=16)`` at 256x256, 3 spp, 2 bounces (the
   large box's plain walk takes about 30 s a frame);
18. native scene prep (``native``): the C++ library of ``accel/native.py``
   (built with g++) against the NumPy paths on ``cornell_box(
   tessellation=55)`` and ``gallery_atrium(detail=3)``: the SAH build, the
   wide collapse (packs "none" and "ffd"), the triangle reorder, the glTF
   flatten and potpack (the atrium's atlas and fat canvas), bit for bit
   (the wide boxes' NaN bits included), each timed both ways; the two
   scenes built both ways and the atrium's ``Renderer.load_model`` from a
   .glb both ways, the same arrays, with their seconds;
19. the command line and the viewer (``cli``): ``python -m
   wgpu_path_tracing_tpu_torch.cli render`` of the flagship (64 spp) and of
   the atrium from a .glb (8 spp) as two subprocesses, each PNG equal on
   every pixel to an in-process ``Renderer``'s; ``cli.main`` in this
   process with its launches counted; ``--checkpoint`` and ``--resume``
   (32 + 32 spp) equal to 64 spp in one go; ``info`` and ``export``; the
   HTTP viewer at 256x256: ``w`` pressed over HTTP moves the camera and
   restarts the accumulation (that tick's launches counted),
   ``/frame.png`` decodes, ``/stats`` reads, ticks a second and
   ``motion_to_frame_ms``, and the atrium's bytes POSTed to ``/load``
   installed at a chunk boundary with the mean restarted;
20. the 16-wide walk (``wide16``, run after phase 7 on its large box): the
   width-16 ("ffd") and the width-8 "slice" collapses of the large box built
   in NumPy (seconds, nodes, groups, depth beside the "ffd" tree's);
   ptxas' report of K3-w16 (``wpt_walk16``, a team of lanes a ray); K3-w16,
   and K3 on the slice tables,
   against their plain versions on phase 7's camera, bounce-1 and shadow-0
   rays, bit for bit, and against width-8 K3 (lanes that differ, and
   whether each is an exact-t tie); device ms a call of the three trees in
   turns; K3-w16's bound on each ray set; a 192x192 x 1-spp render of the
   large box through ``make_closest_hit`` on the width-16 tables (K3-w16
   launches counted) against its plain path on every pixel;
21. multi-device rendering (``shard``): ``Renderer(devices=["cuda"] * k,
   sample_shards=s)`` on the 1x1, 1x2 and 2x2 meshes of the one card (each
   entry a shard that runs there in turn), the flagship at 64 spp: the
   launches (K1 1,024 / 2,048 / 2,048), each image equal to its plain
   path's (``render_chunk_sharded`` with the plain versions) on every pixel
   and within rtol 1e-4 / atol 1e-5 of the single-device image, the
   counters equal, the cold render and the median of repeats in Mrays/s in
   turns with the single-device renderer; then on the 2x2 mesh the large
   box through the walk (8 spp), ``rng="stratified"`` (8 spp, also against
   its plain path), a checkpoint resume (4 + 4 spp against 8 in one go,
   bit for bit) and a padded tail (5 spp); ``cli.main render cornell
   --multichip`` against the ``Renderer``'s PNG; and ``devices=True`` on
   this host (one card: the single-device path);
22. the JAX package's large scenes (``big``, its bench config 7):
   ``cornell_box(tessellation=150, 243, 345)``, 765,002, 2,007,668 and
   4,046,852 triangles, through the ``Renderer`` on the routes of
   ``BIG_ROUTES`` (765k and 2M under "auto" at 128x128, 8 spp,
   ``frames_per_trace=8``; 2M under "pairs" at 2 spp; 4M under "pairs"
   and under "auto" at 64x64, 1 spp): the strategy each took, the scene's
   and ``load_scene``'s seconds, the launches, peak device memory and the
   median of 3 renders after a warm-up in Mrays/s; at each size K2, K3 and
   K4 (the kernels of its routes) on 16,384-ray subsets of the 512x512
   camera rays, their bounce-1 rays and shadow-0 rays against their plain
   versions, bit for bit, and K3's and K4's device ms a call of 262,144
   rays beside the bound from the plain visits, scaled; at 765k and 2M the
   walk route's 64x64, 1-spp, 1-bounce image against the plain path's.

Then one JSON line of per-kernel numbers (each kernel's time beside its
bound: the larger of the bytes it must move over the card's memory rate and
its operations over the float32 rate), and last the line
``{"ok": true, "device": {...}}``. Any failure raises: the exit code is not
0 and the ok line is not printed. Without CUDA, or outside a checkout of the
repository, it fails the same way.

``--profile PATH`` also writes a ``torch.profiler`` table of four
main-path frames to PATH, of four textured-flagship frames, of four
large-scene frames, of four frames of the large scene through the pair
dispatch, of four stratified flagship frames, of four frames of the loaded
atrium and of four env-box frames to PATH with ``_textured``, ``_large``,
``_pairs``, ``_stratified``, ``_gltf`` and ``_env`` before its extension,
and prints the device's busy share and the ``torch.cat`` calls a frame;
and of one flagship ``denoise()`` and one flagship ``render_adaptive(64)``
with ``_denoise`` and ``_adaptive``.

``--phases NAME,...`` runs only the named phases (``--help`` names them),
for iterating on the card; without it every phase runs. ``--phases
gltf,env`` runs the scene-loading and environment-map phases alone
(about 65 s after the build); ``--phases bvh2,debug,denoise,adaptive`` the
phases of the binary-BVH walks, the debug views, the denoiser and adaptive
sampling; ``--phases native,cli`` the scene-prep library and the command
line (about 60 s after the build); ``--phases wide16,shard`` the 16-wide
walk and multi-device rendering; ``--phases big`` the large scenes (about
230 s).
"""

from __future__ import annotations

import argparse
import base64
import dataclasses
import hashlib
import functools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import warnings

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

from wgpu_path_tracing_tpu_torch import (  # noqa: E402
    Camera,
    Renderer,
    RenderConfig,
    cornell_box,
    gallery_atrium,
    load_jax_scene,
    load_model,
    material_test_box,
    scene_to_glb,
    textured_cornell,
)
from wgpu_path_tracing_tpu_torch.models.types import (  # noqa: E402
    FAT_KEYS,
    pack_device_scene,
)
from wgpu_path_tracing_tpu_torch import cli as CLI  # noqa: E402
from wgpu_path_tracing_tpu_torch.accel import bvh8, native  # noqa: E402
from wgpu_path_tracing_tpu_torch.accel.bvh import build_bvh  # noqa: E402
from wgpu_path_tracing_tpu_torch.models.gltf import (  # noqa: E402
    GLTFFile,
    build_atlas,
)
from wgpu_path_tracing_tpu_torch.ops import blocks as BLOCKS  # noqa: E402
from wgpu_path_tracing_tpu_torch.ops import bounce as K2  # noqa: E402
from wgpu_path_tracing_tpu_torch.ops import cluster as K6  # noqa: E402
from wgpu_path_tracing_tpu_torch.ops import cuda_lib  # noqa: E402
from wgpu_path_tracing_tpu_torch.ops import dense_hit as K1  # noqa: E402
from wgpu_path_tracing_tpu_torch.ops import denoise as K9  # noqa: E402
from wgpu_path_tracing_tpu_torch.ops import env as ENV  # noqa: E402
from wgpu_path_tracing_tpu_torch.ops import intersect as ISECT  # noqa: E402
from wgpu_path_tracing_tpu_torch.ops import pairs as K4  # noqa: E402
from wgpu_path_tracing_tpu_torch.ops import phased as K5  # noqa: E402
from wgpu_path_tracing_tpu_torch.ops import shade as SHADE  # noqa: E402
from wgpu_path_tracing_tpu_torch.ops import trace as TRACE  # noqa: E402
from wgpu_path_tracing_tpu_torch.ops import vec  # noqa: E402
from wgpu_path_tracing_tpu_torch.ops import walk as K3  # noqa: E402
from wgpu_path_tracing_tpu_torch.ops.camera_rays import (  # noqa: E402
    bounce0_lds,
    generate_rays,
    pixel_grid,
)
from wgpu_path_tracing_tpu_torch.ops.intersect import (  # noqa: E402
    REORDER_BUCKETS,
    make_closest_hit,
    pairs_reorder,
    with_ray_order,
    with_tail_compaction,
)
from wgpu_path_tracing_tpu_torch.debug import modes as DEBUG  # noqa: E402
from wgpu_path_tracing_tpu_torch.parallel import shard as SH  # noqa: E402
from wgpu_path_tracing_tpu_torch.render import adaptive as ADAPTIVE  # noqa: E402
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
LARGE_PLAIN_SPP = 1  # frames of the large box's plain-path comparison
# The dispatch intersectors: K4 and K6 on the large box, K5 on a mid-size one.
PHASED_TESSELLATION = 16
# The binary walks' ray-ordered renders: 19,603 binary nodes, at least
# ops/intersect.py BVH2_REORDER_MIN_NODES for K7 and K8.
ORDERED_TESSELLATION = 30
DISPATCH_SPP = 2  # the "phased" and "cluster" renders
DISPATCH_PLAIN_SPP = 1  # frames of their plain-path comparisons
FORCED_WALK_SPP = 4  # the flagship box through the walk
# The flagship under each RenderConfig.bounce_kernel.
BOUNCE_KERNEL_SIZE = 64
BOUNCE_KERNEL_SPP = 8
# The rng modes: the stratified flagship renders SPP frames (its plain path
# too); "hash", frames_per_trace and the checkpoint fewer.
HASH_SPP = 8
FPT_SPP = 8  # the stratified flagship at frames_per_trace 2 against 1
FPT_LARGE_SPP = 2  # the large box through the walk, the same
CKPT_SPP = 4  # rendered before the checkpoint and after the resume
# Scene loading: the atrium at full detail (about 116k triangles) written to
# a .glb and read back; its render, the plain path's frames and the async
# load's.
GLTF_DETAIL = 3
GLTF_SPP = 8
GLTF_PLAIN_SPP = 1
ASYNC_CHUNK = 16  # frames_per_chunk of the async load's render
# The environment map: a numpy-made 64x128 equirect map, its intensity and
# a rotation that is not 0.
ENV_SHAPE = (64, 128)
ENV_INTENSITY = 1.5
ENV_ROTATION = 0.7
# Phase-4 bound for float outputs that are not bit-equal.
MAX_ULP = 2
MAX_ULP_LANE_SHARE = 1e-4
# The card's peaks (NVIDIA's H100 SXM data sheet, at 700 W): float32 outside
# the tensor cores, and device memory.
PEAK_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# Operations each kernel does, counted from its source, each add, multiply,
# divide, square root, sine, cosine, min, max and compare once: a
# Möller-Trumbore ray-triangle test (K1, K3's leaves), a ray-box slab test
# (K3), and an upper estimate of one ray's bounce shading (K2; the textured
# modes add the uv, the samplers' index math and the normal map's basis).
MT_OPS = 55
SLAB_OPS = 25
K2_OPS = {"none": 900, "per_slot": 1100, "fat": 1100}
# A missed lane's environment term (normalize, atan2, acos, the texel's
# index, intensity and throughput products).
ENV_OPS = 80


@functools.lru_cache(maxsize=None)
def tessellated_box(tessellation: int):
    """``cornell_box(tessellation=...)``, built once (its SAH BVH takes
    seconds at 102,852 triangles); the second value is the seconds it took."""
    t0 = time.perf_counter()
    scene = cornell_box(tessellation=tessellation)
    return scene, time.perf_counter() - t0


def coprime_textured():
    """The 256^2 congruent textured box with a 255^2 pbr rect: its LCM grid
    (65,280 texels a side) is past the fat canvas's budget, so no canvas is
    baked and K2 samples the atlas per slot."""
    sc = textured_cornell(atlas_size=256, congruent=True)
    sc.mat_pbr_rect[0] = [0, 0, 255, 255]
    return sc


# The textured path's scenes: (path name, scene, K2's texture mode). The
# first two are the JAX bench's configs 3 and 6.
TEXTURED = (
    ("textured", textured_cornell, "fat"),
    ("textured_512", lambda: textured_cornell(atlas_size=512, congruent=True),
     "fat"),
    ("textured_per_slot", coprime_textured, "per_slot"),
)


def textured_material_box(make_box=material_test_box,
                          make_textured=textured_cornell):
    """``material_test_box()`` with ``textured_cornell()``'s atlas and maps
    (albedo and pbr on the white material, the normal map on the red one):
    K2's texture modes on lanes that diverge across lobes and light types.
    Either package's two functions may be passed."""
    sc, tex = make_box(), make_textured()
    sc.atlas = tex.atlas
    for key in ("mat_albedo_rect", "mat_pbr_rect", "mat_normal_rect",
                "mat_emissive_rect"):
        getattr(sc, key)[0:2] = getattr(tex, key)[0:2]
    return sc


# The lights K2 branches on: (type, position, color, intensity, spot
# direction, scale and offset or None). "point_far" is past the 100 at
# which a point light is ignored.
LANE_MIX_LIGHTS = {
    "directional": (1, (-0.3, -1.0, -0.4), (0.6, 0.7, 1.0), 0.5, None),
    "spot": (3, (0.0, 1.9, 0.0), (1.0, 0.8, 0.6), 3.0,
             (0.0, -1.0, 0.0, 9.75, -8.56)),
    "point_near": (2, (0.0, 1.8, 0.5), (1.0, 0.9, 0.8), 0.8, None),
    "point_far": (2, (0.0, 150.0, 0.0), (1.0, 1.0, 1.0), 1e4, None),
}
LANE_MIX_CASES = ("all", "emissive", *LANE_MIX_LIGHTS)


def lane_mix_box(make_box, lights: str = "all"):
    """``make_box()`` (a procedural scene of either package) with every case
    K2 branches on, lane by lane. Three materials are appended and given to
    some of the non-emissive triangles: a smooth metal (roughness 0.01,
    below the 0.04 floor), a blend of all three lobes (metallic 0.4,
    transmission 0.5) and a dense glass (ior 2.4: total internal reflection
    at a wide range of angles). The scene keeps its emissive triangles as
    lights and takes ``lights``: one of ``LANE_MIX_LIGHTS`` beside them,
    "emissive" for none, "all" for every one."""
    sc = make_box()
    f32 = np.float32
    extra = {
        "mat_base_color": [[0.95, 0.93, 0.88], [0.8, 0.6, 0.4], [1, 1, 1]],
        "mat_metallic": [1.0, 0.4, 0.0], "mat_roughness": [0.01, 0.3, 0.01],
        "mat_emission": [[0, 0, 0]] * 3, "mat_emissive_strength": [0.0] * 3,
        "mat_ior": [1.5, 1.3, 2.4], "mat_transmission": [0.0, 0.5, 1.0]}
    m = len(sc.mat_metallic)
    fields = {k: np.concatenate([getattr(sc, k), np.asarray(v, f32)])
              for k, v in extra.items()}
    for k in ("mat_albedo_rect", "mat_pbr_rect", "mat_normal_rect",
              "mat_emissive_rect"):
        rect = getattr(sc, k)
        fields[k] = np.concatenate([rect, np.zeros((3, 4), rect.dtype)])
    mat = sc.tri_mat.copy()
    emits = (sc.mat_emission[mat] > 0).any(1)
    k = np.arange(len(mat))
    for new, pick in ((m, k % 6 == 1), (m + 1, k % 6 == 2),
                      (m + 2, k % 12 == 3)):
        mat[pick & ~emits] = new
    keep = sc.light_type == 0
    if lights == "all":
        names = list(LANE_MIX_LIGHTS)
    else:
        names = [] if lights == "emissive" else [lights]
    add = [LANE_MIX_LIGHTS[name] for name in names]
    aux = np.zeros((len(add), 5), f32)
    for j, light in enumerate(add):
        if light[4] is not None:
            aux[j] = light[4]
    old_aux = (np.zeros((int(keep.sum()), 5), f32) if sc.light_aux is None
               else np.asarray(sc.light_aux, f32)[keep])
    return dataclasses.replace(
        sc, tri_mat=mat.astype(np.int32), **fields,
        light_position=np.concatenate(
            [sc.light_position[keep], np.array([a[1] for a in add], f32)
             .reshape(-1, 3)]).astype(f32),
        light_type=np.concatenate(
            [sc.light_type[keep], [a[0] for a in add]]).astype(np.int32),
        light_color=np.concatenate(
            [sc.light_color[keep], np.array([a[2] for a in add], f32)
             .reshape(-1, 3)]).astype(f32),
        light_intensity=np.concatenate(
            [sc.light_intensity[keep], [a[3] for a in add]]).astype(f32),
        light_tri=np.concatenate(
            [sc.light_tri[keep], np.zeros(len(add))]).astype(np.int32),
        light_aux=np.concatenate([old_aux, aux]))


def lane_mix_rays(n: int, seed: int = 0):
    """Rays for ``lane_mix_box``, made with numpy: origins anywhere inside
    the box (inside its glass too), directions uniform on the sphere (out
    through the open front: misses), random PCG states and 10% of the lanes
    dead. Returns ro, rd (3, n) float32, state (n,) int64, alive (n,)
    bool."""
    rng = np.random.default_rng(seed)
    ro = rng.uniform([-0.95, 0.05, -0.95], [0.95, 1.95, 0.95], (n, 3))
    rd = _unit(rng, n)
    return (ro.T.astype(np.float32).copy(), rd.T.astype(np.float32).copy(),
            rng.integers(0, 2 ** 32, n).astype(np.int64),
            rng.random(n) >= 0.1)


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


def nbytes(*tensors) -> int:
    return sum(x.numel() * x.element_size() for x in tensors if x is not None)


def bound(bytes_moved: int, ops: float) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the float32 rate. No single PyTorch
    call computes any of these kernels' functions, so ``library_ms`` is
    null."""
    by_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    by_ops = ops / PEAK_FLOPS * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "library_ms": None}


def atlas_bytes(args, atlas, slots) -> int:
    """The atlas bytes K2 must read at the bounce of ``args``: each distinct
    texel that a hit lane samples for a slot its material maps (and the
    scene uses), once: 16 bytes a texel of the (H, W, 4) atlas, 64 a row of
    the fat canvas, and the fat canvas's match table once."""
    rays, alive, idx, tri_full = args[1], args[5], args[7], args[8]
    found = alive & (idx >= 0)
    get = SHADE.fetch_rows(tri_full, torch.clamp_min(idx, 0))
    *_, uv_u, uv_v = SHADE.barycentrics_from_cols(
        get, vec.from_rows(rays, 0), vec.from_rows(rays, 3))
    if isinstance(atlas, tuple):
        _, canvas, rects = atlas
        vrect, missing = SHADE.fat_rect(rects, get)
        mapped = torch.zeros_like(found)
        for k in range(4):
            if slots[k]:
                mapped |= ~missing[k]
        rows = SHADE.atlas_texel(vrect, uv_u, uv_v, canvas.shape[0],
                                 canvas.shape[1])[found & mapped]
        return rows.unique().numel() * 64 + nbytes(rects)
    texels = []
    for k in range(4):
        if not slots[k]:
            continue
        rect = [get(SHADE.SLOT_RECT_COLS[k] + i) for i in range(4)]
        take = found & (rect[2] != 0.0) & (rect[3] != 0.0)
        texels.append(SHADE.atlas_texel(rect, uv_u, uv_v, atlas.shape[0],
                                        atlas.shape[1])[take])
    return torch.cat(texels).unique().numel() * 16


def env_misses(args, env) -> tuple:
    """(missed lanes, the distinct texels of the environment map they
    read) at the bounce of ``args``: a missed lane reads one texel."""
    rays, alive, idx = args[1], args[5], args[7]
    missed = alive & (idx < 0)
    env_map, params = env
    iy, ix = ENV.env_texel(vec.from_rows(rays, 3), env_map.shape[0],
                           env_map.shape[1], params[1])
    texels = (iy * env_map.shape[1] + ix)[missed].unique().numel()
    return int(missed.sum()), texels


def k2_bound(args, outs, mode: str, atlas=None, slots=None,
             env=None) -> dict:
    """K2's bound: the ray state and the tables once, the atlas texels
    that ``atlas_bytes`` counts, the environment map's texels that the
    missed lanes read (12 B each, and the two params), every output once;
    ``K2_OPS`` a ray and ``ENV_OPS`` a missed lane."""
    moved = nbytes(*args[1:], *outs)
    if atlas is not None:
        moved += atlas_bytes(args, atlas, slots)
    ops = K2_OPS[mode] * args[1].shape[1]
    if env is not None:
        missed, texels = env_misses(args, env)
        moved += texels * 12 + nbytes(env[1])
        ops += ENV_OPS * missed
    return bound(moved, ops)


def scene_of(scene_np, dev, drop_fat: bool = False) -> dict:
    """``scene_np`` packed and uploaded; ``drop_fat`` leaves its fat canvas
    out, so that K2 samples a textured scene per slot."""
    packed = pack_device_scene(scene_np)
    if drop_fat:
        packed = {k: v for k, v in packed.items() if k not in FAT_KEYS}
    return load_jax_scene(packed, dev)


def flagship_rays(scene_np, dev, drop_fat: bool = False):
    """Frame-0 camera rays of the flagship camera, in the main path's tile
    lane order."""
    scene = scene_of(scene_np, dev, drop_fat)
    camera = Camera(width=SIZE, height=SIZE, aspect=1.0)
    cam = camera_device(camera.as_pytree(), SIZE, SIZE)
    x, y = tile_pixels(SIZE, SIZE, dev)
    ro, rd, state = generate_rays(cam, x, y, 0,
                                  use_dof=float(camera.aperture) > 0.0)
    return scene, torch.cat([ro, rd]).contiguous(), state


# K1's adversarial ray classes (``adversarial_case``): the razor edges of
# Möller-Trumbore's tests, ties, degenerate directions and ragged counts.
EPS32 = np.float32(1e-6)  # EPSILON as float32, where |a| and t are tested
ADVERSARIAL = ("edges_vertices", "sum_one", "det_epsilon", "t_epsilon",
               "duplicates", "parallel", "special_dirs", "ragged_1",
               "ragged_255", "ragged_257")


def _ulps(x: np.float32, k: int) -> np.float32:
    """Positive ``x`` moved by ``k`` float32 ulps."""
    bits = np.array([x], np.float32).view(np.int32) + np.int32(k)
    return bits.view(np.float32)[0]


def _squares(k: int):
    """``k`` unit squares in the plane z = 0 at x = 2s, each split along its
    diagonal x + y = 1 into two triangles that share it: (v0, v1, v2) with
    dyadic coordinates, so that a ray with dyadic origin and direction gets
    u, v and t exactly (u + v is exactly 1 on the diagonal of both)."""
    v0, v1, v2 = [], [], []
    for s in range(k):
        x = 2.0 * s
        v0 += [(x, 0, 0), (x + 1, 1, 0)]
        v1 += [(x + 1, 0, 0), (x, 1, 0)]
        v2 += [(x, 1, 0), (x + 1, 0, 0)]
    return tuple(np.array(v, np.float32) for v in (v0, v1, v2))


def _unit(rng, n):
    d = rng.normal(size=(n, 3))
    return d / np.linalg.norm(d, axis=1, keepdims=True)


def adversarial_case(name: str, seed: int = 0):
    """K1's adversarial class ``name`` (one of ``ADVERSARIAL``), made from a
    seed with numpy: (v0, v1, v2) (T, 3) float32 triangle vertices and
    (ro, rd) (N, 3) float32 rays. ``tri_isect_of`` packs the triangles as
    ``pack_device_scene`` does."""
    if name not in ADVERSARIAL:
        raise ValueError(f"unknown adversarial class {name!r}")
    rng = np.random.default_rng(seed)
    f32 = np.float32
    if name == "edges_vertices":
        # Random triangles; rays aimed at a vertex or at a point of an edge
        # (u = 0, v = 0 or u + v = 1), the point rounded to float32.
        v = rng.uniform(-1.0, 1.0, (3, 16, 3)).astype(f32)
        n = 512
        k = rng.integers(0, 16, n)
        w = rng.uniform(0.0, 1.0, n)
        corner = rng.integers(0, 3, n)
        kind = rng.integers(0, 4, n)
        uu = np.select([kind == 0, kind == 1, kind == 2],
                       [0.0 * w, w, w], (corner == 1) * 1.0)
        vv = np.select([kind == 0, kind == 1, kind == 2],
                       [w, 0.0 * w, 1.0 - w], (corner == 2) * 1.0)
        e1 = v[1].astype(np.float64) - v[0]
        e2 = v[2].astype(np.float64) - v[0]
        p = v[0][k] + e1[k] * uu[:, None] + e2[k] * vv[:, None]
        d = _unit(rng, n)
        o = p - d * rng.uniform(0.5, 2.0, (n, 1))
        return v[0], v[1], v[2], o.astype(f32), d.astype(f32)
    if name in ("sum_one", "det_epsilon", "t_epsilon"):
        v0, v1, v2 = _squares(4)
        n = 512
        sq = 2.0 * rng.integers(0, 4, n)
        if name == "sum_one":
            # Dyadic targets on the shared diagonal, on the outer edges, at
            # the vertices and next to them; dyadic slanted directions.
            j = rng.integers(0, 17, n) / 16.0
            kind = rng.integers(0, 5, n)
            tx = np.select([kind == 0, kind == 1, kind == 2, kind == 3],
                           [j, 0 * j, j, np.round(j)], j + 1.0 / 64)
            ty = np.select([kind == 0, kind == 1, kind == 2, kind == 3],
                           [1.0 - j, j, 0 * j, 0 * j], 1.0 - j)
            a = rng.integers(-2, 3, (n, 2)) / 4.0
            h = rng.choice([0.5, 1.0, 2.0], n)
            d = np.stack([a[:, 0], a[:, 1], -np.ones(n)], 1)
            o = np.stack([sq + tx - a[:, 0] * h, ty - a[:, 1] * h, h], 1)
            return v0, v1, v2, o.astype(f32), d.astype(f32)
        if name == "det_epsilon":
            # |a| = |d.z| exactly on these triangles: d.z within 3 ulps of
            # EPSILON either way, from either side of the plane.
            dz = np.array([_ulps(EPS32, k) for k in rng.integers(-3, 4, n)],
                          f32)
            side = rng.choice([-1.0, 1.0], n).astype(f32)
            t = rng.uniform(0.1, 1.0, n)
            hit = rng.uniform(0.0, 1.0, (n, 2))
            dxy = rng.uniform(-0.5, 0.5, (n, 2))
            d = np.stack([dxy[:, 0], dxy[:, 1], -side * dz], 1)
            o = np.stack([sq + hit[:, 0] - dxy[:, 0] * t,
                          hit[:, 1] - dxy[:, 1] * t, side * dz * t], 1)
            return v0, v1, v2, o.astype(f32), d.astype(f32)
        # t_epsilon: t = the origin's height exactly, within 3 ulps of
        # EPSILON, at 0 and -0.0, and a little above and below.
        heights = np.array([_ulps(EPS32, k) for k in range(-3, 4)]
                           + [0.0, -0.0, 2e-6, 5e-7, 1e-7, -1e-6], f32)
        z = heights[rng.integers(0, len(heights), n)]
        j = rng.integers(0, 33, (n, 2)) / 32.0
        a = rng.integers(-2, 3, (n, 2)) / 4.0
        d = np.stack([a[:, 0], a[:, 1], -np.ones(n)], 1).astype(f32)
        o = np.stack([(sq + j[:, 0]).astype(f32), j[:, 1].astype(f32), z], 1)
        return v0, v1, v2, o.astype(f32), d
    if name == "duplicates":
        # Six triangles, each at three indices: every hit ties thrice.
        base = rng.uniform(-1.0, 1.0, (3, 6, 3)).astype(f32)
        order = rng.permutation(np.tile(np.arange(6), 3))
        v = base[:, order]
        n = 512
        k = rng.integers(0, 6, n)
        w = rng.dirichlet([1.0, 1.0, 1.0], n)
        p = (base[0][k] * w[:, :1] + base[1][k] * w[:, 1:2]
             + base[2][k] * w[:, 2:])
        d = _unit(rng, n)
        o = p - d * rng.uniform(0.5, 2.0, (n, 1))
        return v[0], v[1], v[2], o.astype(f32), d.astype(f32)
    if name == "parallel":
        # Directions in the plane of a triangle: exactly (z = 0 squares,
        # d.z = 0, a = 0) and as near as float32 rounds (random triangles).
        sv0, sv1, sv2 = _squares(2)
        rv = rng.uniform(-1.0, 1.0, (3, 8, 3)).astype(f32)
        v0 = np.concatenate([sv0, rv[0]])
        v1 = np.concatenate([sv1, rv[1]])
        v2 = np.concatenate([sv2, rv[2]])
        n = 256
        o1 = np.stack([rng.uniform(-0.5, 4.5, n), rng.uniform(-0.5, 1.5, n),
                       rng.choice([0.0, -0.0, 1e-7], n)], 1)
        d1 = np.concatenate([rng.normal(size=(n, 2)), np.zeros((n, 1))], 1)
        k = rng.integers(0, 8, n)
        e1 = rv[1][k].astype(np.float64) - rv[0][k]
        e2 = rv[2][k].astype(np.float64) - rv[0][k]
        d2 = e1 * rng.normal(size=(n, 1)) + e2 * rng.normal(size=(n, 1))
        w = rng.dirichlet([1.0, 1.0, 1.0], n)
        o2 = rv[0][k] + e1 * w[:, :1] + e2 * w[:, 1:2] - d2 * 0.5
        return (v0, v1, v2, np.concatenate([o1, o2]).astype(f32),
                np.concatenate([d1, d2]).astype(f32))
    # The Cornell box's triangles from inside the box.
    sc = cornell_box()
    v0, v1, v2 = sc.tri_v0, sc.tri_v1, sc.tri_v2
    n = {"special_dirs": 512, "ragged_1": 1, "ragged_255": 255,
         "ragged_257": 257}[name]
    o = rng.uniform([-0.95, 0.05, -0.95], [0.95, 1.95, 0.95], (n, 3))
    d = _unit(rng, n)
    if name == "special_dirs":
        # Direction components 0, -0.0, +-inf and NaN, alone and together.
        specials = np.array([0.0, -0.0, np.inf, -np.inf, np.nan])
        pick = rng.random((n, 3)) < 0.4
        d = np.where(pick, specials[rng.integers(0, 5, (n, 3))], d)
    return v0, v1, v2, o.astype(f32), d.astype(f32)


def tri_isect_of(v0, v1, v2) -> np.ndarray:
    """(T, 9) [v0, e1, e2] as ``pack_device_scene`` packs it (the edges
    rounded to float32)."""
    return np.concatenate([v0, v1 - v0, v2 - v0], axis=1).astype(np.float32)


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
    sets = (("camera", rays), ("bounce-1", outs[0].contiguous()),
            ("shadow-0", outs[5].contiguous()))
    for name, r in sets:
        tk, ik = K1.closest_hit_dense_cuda(tri, r)
        tp, ip = K1.closest_hit_dense_plain(tri, r)
        t_lanes, t_ulp, t_err = compare(tk, tp)
        i_lanes = int((ik != ip).sum())
        say("k1", f"{name} rays: {n} lanes ({int((ip >= 0).sum())} hits), t "
            f"differs on {t_lanes} (max {t_ulp} ulp), idx differs on "
            f"{i_lanes}")
        if t_lanes or i_lanes:
            raise AssertionError(f"K1 disagrees with its plain version on "
                                 f"the {name} rays")
        worst = max(worst, t_err)
    lanes = 0
    for name in ADVERSARIAL:
        v0, v1, v2, o, d = adversarial_case(name)
        atri = torch.from_numpy(tri_isect_of(v0, v1, v2)).to(dev)
        arays = torch.from_numpy(np.concatenate([o.T, d.T])).contiguous().to(
            dev)
        tk, ik = K1.closest_hit_dense_cuda(atri, arays)
        tp, ip = K1.closest_hit_dense_plain(atri, arays)
        if compare(tk, tp)[0] or int((ik != ip).sum()):
            raise AssertionError(f"K1 disagrees with its plain version on the "
                                 f"adversarial class {name}")
        lanes += o.shape[0]
    say("k1", f"{len(ADVERSARIAL)} adversarial classes ({', '.join(ADVERSARIAL)}"
        f"; {lanes} rays): t and idx bit-equal on every lane")
    (ms, plain_ms), (eager, plain_eager) = time_pair(
        lambda: K1.closest_hit_dense_cuda(tri, rays),
        lambda: K1.closest_hit_dense_plain(tri, rays))
    say("k1", f"time at {n} camera rays x {tri.shape[0]} tris: device "
        f"{ms:.4f} ms (plain {plain_ms:.4f} ms); launched from Python "
        f"{eager:.4f} ms (plain {plain_eager:.4f} ms)")
    by_rays = {}
    for name, r in sets:
        by_rays[name] = device_ms(lambda: K1.closest_hit_dense_cuda(tri, r))
    b = bound(nbytes(tri, rays) + 8 * n, MT_OPS * n * tri.shape[0])
    say("k1", "device ms by ray set: " + ", ".join(
        f"{name} {v:.4f}" for name, v in by_rays.items())
        + f"; bound {b['bound_ms']:.4f} ms ({b['bound_by']}) on each")
    report["k1"] = {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
                    "ms_by_rays": by_rays, **b}


K2_OUTPUTS = ("rays", "state", "throughput", "result", "alive", "shadow_rays",
              "shadow_t_max", "shadow_mask", "direct", "pdf")
K2_EXACT = {"state", "alive", "shadow_mask"}


def check_k2(kout, pout, n: int, where: str, report_key: dict) -> str:
    """K2's ten outputs against its plain version's under the phase-4
    bound; raises on a disagreement. Returns the summary of the lanes that
    differ."""
    parts = []
    for name, k, p in zip(K2_OUTPUTS, kout, pout):
        lanes, ulp, err = compare(k, p)
        report_key["max_abs_err"] = max(report_key.get("max_abs_err", 0.0),
                                        err)
        if lanes:
            parts.append(f"{name} {lanes} lanes/{ulp} ulp")
        if not within_bound(lanes, ulp, n, name in K2_EXACT):
            raise AssertionError(f"K2 {name} disagrees with its plain version "
                                 f"on {where}: {lanes} lanes, max {ulp} ulp")
    return "bit-equal" if not parts else "; ".join(parts)


def k2_bounces(scene_np, label: str, dev, report_key: dict, start=None,
               drop_fat: bool = False, env: bool = False):
    """K2 against its plain version at bounces 0..2 of the flagship camera
    rays on ``scene_np``, or of ``start`` (``lane_mix_rays``' rays, states
    and alive lanes), the plain bounce carrying the rays on. ``drop_fat``
    samples a textured scene per slot; ``env`` lights the misses with
    ``env_map()`` (K2's ``ENV`` instantiation). Returns the bounce-0
    arguments and kernel outputs, the keywords, and the scene."""
    if start is None:
        scene, rays, state = flagship_rays(scene_np, dev, drop_fat)
        alive = torch.ones((rays.shape[1],), dtype=torch.bool, device=dev)
    else:
        scene = scene_of(scene_np, dev, drop_fat)
        ro, rd, state, alive = (torch.from_numpy(x).to(dev) for x in start)
        rays = torch.cat([ro, rd]).contiguous()
    atlas, slots = TRACE.scene_atlas(scene)
    n = rays.shape[1]
    thr = torch.ones((3, n), device=dev)
    res = torch.zeros((3, n), device=dev)
    kw = dict(do_mis=True, num_lights=scene_np.num_lights, atlas=atlas,
              slots_used=slots)
    if env:
        kw["env"] = with_env(scene, dev)
    timed = None
    for b in range(3):
        t, idx = K1.closest_hit_dense_plain(scene["tri_isect"], rays)
        args = (b, rays, state, thr, res, alive, t, idx,
                scene["tri_full"], scene["light_full"])
        kout = K2.bounce_stage_cuda(*args, **kw)
        pout = K2.bounce_stage_plain(*args, **kw)
        summary = check_k2(kout, pout, n, f"{label} bounce {b}", report_key)
        if env:
            summary = (f"{env_misses(args, kw['env'])[0]} missed (the map "
                       "lit); " + summary)
        say("env" if env else "k2", f"{label} bounce {b}: {n} lanes, "
            f"{int(alive.sum())} alive; " + summary)
        if timed is None:
            timed = args, kout
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
    return (*timed, kw, scene)


def phase_k2(dev, report):
    """K2 untextured on the Cornell box (every lane diffuse, every light
    emissive), ``material_test_box()`` (lanes that diverge across lobes and
    light types) and the lane mix (``lane_mix_box``: every lobe, light type
    and lane class, from random rays); its time at bounce 0 of each."""
    key = report["k2"] = {}
    lane_mix = ("lane_mix", lambda: lane_mix_box(material_test_box),
                lane_mix_rays(SIZE * SIZE, 1))
    timed = None
    for label, scene_fn, start in (("cornell_box", cornell_box, None),
                                   ("material_test_box", material_test_box,
                                    None), lane_mix):
        args, outs, kw, _ = k2_bounces(scene_fn(), label, dev, key, start)
        key.setdefault("ms_by_scene", {})[label] = device_ms(
            lambda: K2.bounce_stage_cuda(*args, **kw))
        timed = timed or (args, outs, kw)
    args, outs, kw = timed
    (ms, plain_ms), (eager, plain_eager) = time_pair(
        lambda: K2.bounce_stage_cuda(*args, **kw),
        lambda: K2.bounce_stage_plain(*args, **kw))
    say("k2", f"time at cornell_box bounce 0, {args[1].shape[1]} rays: "
        f"device {ms:.4f} ms (plain {plain_ms:.4f} ms); launched from "
        f"Python {eager:.4f} ms (plain {plain_eager:.4f} ms); device ms at "
        "bounce 0 by scene: " + ", ".join(
            f"{k} {v:.4f}" for k, v in key["ms_by_scene"].items()))
    key.update(ms=ms, plain_ms=plain_ms, **k2_bound(args, outs, "none"))


def phase_k2_tex(dev, report):
    """Textured K2 on the three textured boxes and on
    ``textured_material_box()`` in both modes; each mode's time is taken on
    the first scene that runs it."""
    for path, scene_fn, mode in TEXTURED + (
            ("textured_material", textured_material_box, "fat"),
            ("textured_material_per_slot", textured_material_box,
             "per_slot")):
        key = report.setdefault(f"k2_{mode}", {})
        args, outs, kw, scene = k2_bounces(
            scene_fn(), path, dev, key,
            drop_fat=path == "textured_material_per_slot")
        atlas = kw["atlas"]
        if K2.texture_mode(atlas) != mode:
            raise AssertionError(f"{path}: K2 samples {K2.texture_mode(atlas)}"
                                 f", expected {mode}")
        (ms, plain_ms), (eager, plain_eager) = time_pair(
            lambda: K2.bounce_stage_cuda(*args, **kw),
            lambda: K2.bounce_stage_plain(*args, **kw))
        b = k2_bound(args, outs, mode, atlas, kw["slots_used"])
        mask = "".join("1" if u else "0" for u in kw["slots_used"])
        shape = (tuple(atlas[1].shape) if isinstance(atlas, tuple)
                 else tuple(atlas.shape))
        say("k2", f"{path} ({mode}, table {shape}, slots_used {mask} = "
            "albedo/pbr/emissive/normal): time at bounce 0, "
            f"{args[1].shape[1]} rays: device {ms:.4f} ms (plain "
            f"{plain_ms:.4f} ms); launched from Python {eager:.4f} ms "
            f"(plain {plain_eager:.4f} ms); bound {b['bound_ms']:.4f} ms "
            f"({b['bound_by']})")
        key.setdefault("ms_by_scene", {})[path] = ms
        key.setdefault("plain_ms_by_scene", {})[path] = plain_ms
        key.setdefault("slots_used", {})[path] = mask
        key.setdefault("bound_ms_by_scene", {})[path] = b["bound_ms"]
        if "ms" not in key:
            key.update(ms=ms, plain_ms=plain_ms, **b)
        if mode == "fat":
            per_slot_instead(args, outs, kw, scene, path, key)


def per_slot_instead(args, outs, kw, scene, path: str, key: dict):
    """A fat scene's bounce 0 sampled per slot, as it would be without its
    canvas: the lanes whose outputs differ from the fat mode's (the
    texel-boundary class) and both modes' device ms, timed in the order
    fat, per slot, per slot, fat."""
    n = args[1].shape[1]
    slot_kw = dict(kw, atlas=scene["atlas"])
    slot_out = K2.bounce_stage_cuda(*args, **slot_kw)
    differ = torch.zeros((n,), dtype=torch.bool, device=args[1].device)
    for a, b in zip(slot_out, outs):
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        differ |= (a != b).reshape(-1, n).any(0)
    (slot_ms, fat_ms), _ = time_pair(
        lambda: K2.bounce_stage_cuda(*args, **slot_kw),
        lambda: K2.bounce_stage_cuda(*args, **kw))
    lanes = int(differ.sum())
    say("k2", f"{path} sampled per slot instead: device {slot_ms:.4f} ms "
        f"against fat {fat_ms:.4f} ms; outputs differ from the fat mode's "
        f"on {lanes} of {n} lanes")
    key.setdefault("per_slot_instead", {})[path] = {
        "ms": slot_ms, "fat_ms": fat_ms, "lanes_differing": lanes}


def load_oracle():
    """tests/oracle.py by path: an installed package named ``tests`` may
    shadow the repository's directory."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "scalar_oracle", os.path.join(REPO, "tests", "oracle.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.Oracle


def oracle_frames(scene_np, label: str, dev, drop_fat: bool = False):
    """The 24x24 render of ``scene_np`` through the kernels against the
    scalar oracle on the sample pixels at frames 0, 1 and 5. ``drop_fat``
    samples a textured scene per slot, as the oracle does, instead of from
    its fat canvas."""
    Oracle = load_oracle()
    w = ORACLE_SIZE
    camera = Camera(width=w, height=w, aspect=1.0)
    oracle = Oracle(scene_np, camera.as_pytree(), w, w)
    packed = pack_device_scene(scene_np)
    if drop_fat:
        packed = {k: v for k, v in packed.items() if k not in FAT_KEYS}
    scene = load_jax_scene(packed, dev)
    mode = K2.texture_mode(TRACE.scene_atlas(scene)[0])
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
        states, outliers = [], 0
        for px, py in SAMPLE_PIXELS:
            lane = py * w + px
            expected = oracle.render_pixel(px, py, frame)
            if int(end_state[lane]) != int(oracle.rng.state):
                states.append((px, py))
            got = np.minimum(radiance[lane], np.float32(2.5))
            outliers += not np.allclose(got, expected, rtol=2e-3, atol=2e-3)
        say("oracle", f"{label} ({mode}) frame {frame}: {len(SAMPLE_PIXELS)} "
            f"pixels, {len(states)} RNG-state mismatches"
            + (f" at {states}" if states else "")
            + f", {outliers} radiance outliers")
        if states or outliers > 1:
            raise AssertionError(f"the kernel path disagrees with the scalar "
                                 f"oracle on {label} at frame {frame}")


def phase_oracle(dev):
    oracle_frames(cornell_box(), "cornell_box", dev)
    oracle_frames(textured_cornell(), "textured_cornell", dev)
    oracle_frames(textured_cornell(), "textured_cornell", dev, drop_fat=True)


DISPATCH = {
    # kind: (module, the kernel wrapper, the plain version, its tables)
    "pairs": (K4, K4.closest_hit_pairs, K4.closest_hit_pairs_plain,
              K4.pair_tables),
    "phased": (K5, K5.closest_hit_phased, K5.closest_hit_phased_plain,
               lambda scene: K5.phased_tables(scene["walk_tris"])),
    "cluster": (K6, K6.closest_hit_cluster, K6.closest_hit_cluster_plain,
                K6.cluster_tables),
}


def plain_closest_hit(scene: dict, strategy: str):
    """The plain version of the intersector ``make_closest_hit`` reports as
    ``strategy``, with its signature. ``reorder`` is read by the pair
    dispatch alone, through the same ``with_tail_compaction`` as the
    kernel's route, since its blocks are part of its function; the other
    plain versions walk each ray alone, in lane order."""
    tri = scene["tri_isect"]
    nt = tri.shape[0]
    if strategy == "brute":
        def closest_hit(ro3, rd3, active=None, t_max=None, any_hit=False,
                        reorder=False):
            return K1.closest_hit_dense_plain(tri, torch.cat([ro3, rd3]))

        return closest_hit
    if strategy in ("stack", "bvh"):
        aabb = scene["bvh_aabb"]
        if strategy == "stack":
            plain, table = ISECT.closest_hit_bvh_plain, scene["bvh_meta"]
        else:
            plain = ISECT.closest_hit_bvh_linked_plain
            table = ISECT.linked_nodes(scene["bvh_meta"], scene["bvh_links"])

        def closest_hit(ro3, rd3, active=None, t_max=None, any_hit=False,
                        reorder=False):
            return plain(aabb, table, tri, ro3.T, rd3.T, active, t_max,
                         any_hit=any_hit)

        return closest_hit
    if strategy in ("walk", "walk_hbm"):
        plain, tables = K3.closest_hit_walk_plain, K3.walk_tables(scene)
    else:
        _, _, plain, get_tables = DISPATCH[strategy]
        tables = get_tables(scene)

    def inner(ro3, rd3, active=None, t_max=None, any_hit=False):
        return plain(tables, ro3, rd3, active, t_max, num_tris=nt,
                     any_hit=any_hit)

    if strategy == "pairs":
        return with_tail_compaction(inner, scene["root_box"],
                                    pairs_reorder(scene))

    def closest_hit(ro3, rd3, active=None, t_max=None, any_hit=False,
                    reorder=False):
        return inner(ro3, rd3, active, t_max, any_hit)

    return closest_hit


def plain_render(r: Renderer, spp: int, repack: bool = True) -> np.ndarray:
    """The frames ``r.render(spp)`` draws after a reset, through the plain
    versions on ``r``'s device: ``ops/trace.py``'s bounce loop and the plain
    version of the intersector ``r`` picked, so no kernel launches, with
    ``r``'s environment map where it has one. The scene is packed and
    uploaded anew, or with ``repack=False`` (scenes of millions of
    triangles, whose packing takes seconds) taken as ``r`` uploaded it.
    Returns (H, W, 3) like ``render``."""
    cfg, dev = r.config, r.device
    scene = (load_jax_scene(pack_device_scene(r.scene), dev) if repack
             else dict(r._scene_dev))
    for key in ("env", "env_params"):  # the environment map, where set
        if key in r._scene_dev:
            scene[key] = r._scene_dev[key]
    closest_hit = plain_closest_hit(scene, r.stats()["intersector"])
    accum = torch.zeros((cfg.width * cfg.height, 3), device=dev)
    render_chunk(TRACE.trace, closest_hit, scene,
                 camera_device(r.camera.as_pytree(), cfg.width, cfg.height),
                 accum, 0, n_frames=spp, width=cfg.width, height=cfg.height,
                 use_dof=float(r.camera.aperture) > 0.0,
                 max_bounces=cfg.max_bounces, do_mis=cfg.do_mis,
                 num_lights=r.scene.num_lights,
                 firefly_clamp=cfg.firefly_clamp, rng_mode=cfg.rng)
    row_major = inverse_permutation(tile_permutation(cfg.width, cfg.height))
    return accum.cpu().numpy()[row_major].reshape(cfg.height, cfg.width, 3)


def plain_debug(r: Renderer, visits: dict | None = None) -> np.ndarray:
    """The debug view ``r.render_debug()`` makes, through the plain
    versions on ``r``'s device: K7's depth mode (whose node visits
    ``visits``, where given, gains), or the plain version of the
    intersector ``r`` picked under the plain hit attributes."""
    cfg = r.config
    scene, cam = r._scene_dev, r._camera()
    if cfg.mode == "bvh_depth":
        ro3, rd3 = DEBUG._center_rays(cam, cfg.width, cfg.height, r.device)
        depth = ISECT.bvh_depth_plain(scene["bvh_aabb"], scene["bvh_meta"],
                                      ro3.T, rd3.T, float(DEBUG.MAX_DEPTH),
                                      visits=visits)
        buf = torch.stack([depth, depth, depth], dim=-1)
    else:
        buf = DEBUG.render_normal(scene, cam, cfg.width, cfg.height,
                                  closest_hit=plain_closest_hit(
                                      scene, r.stats()["intersector"]))
    return buf.cpu().numpy().reshape(cfg.height, cfg.width, 3)


def plain_denoise(r: Renderer, hdr: np.ndarray | None = None) -> np.ndarray:
    """``r.denoise(hdr)`` through the plain versions on ``r``'s device: the
    guides through the plain intersector, each filter level through
    ``atrous_level_plain``."""
    cfg = r.config
    if hdr is None:
        hdr = r._row_major().reshape(cfg.height, cfg.width, 3)
    aovs = K9.primary_aovs(r._scene_dev, r._camera(), cfg.width, cfg.height,
                           closest_hit=plain_closest_hit(
                               r._scene_dev, r.stats()["intersector"]))
    return K9.denoise_image(hdr, aovs, spp=r.frame_index,
                            level=K9.atrous_level_plain)


def plain_adaptive(r: Renderer, spp: int) -> np.ndarray:
    """``render_adaptive(spp)`` after a reset, through the plain bounce loop
    and the plain version of ``r``'s intersector (the accumulation's first
    frame overwrites what was there)."""
    r.reset()
    return r.render_adaptive(spp, trace_fn=TRACE.trace,
                             closest_hit=plain_closest_hit(
                                 r._scene_dev, r.stats()["intersector"]))


def reset_counts() -> None:
    K1.Counter.launches = 0
    K2.Counter.reset()
    K3.Counter.launches = K3.Counter.wide = 0
    K4.Counter.launches = 0
    BLOCKS.Counter.launches = 0
    K5.Counter.launches = 0
    K6.Counter.launches = 0
    ISECT.StackCounter.launches = ISECT.StackCounter.depth = 0
    ISECT.LinkedCounter.launches = 0
    K9.Counter.launches = 0


def launch_counts() -> dict:
    """Launches per kernel: K1, K2 by texture mode ("k2" untextured), those
    of them that ran K2's LDS instantiation and its ENV one, K3 (and those
    of them at width 16), K4, K5 (a gate and a test kernel count as one),
    K6, the phase-1 kernel of K4 and K6, K7 (and those of them in its depth
    mode), K8 and K9."""
    return {"k1": K1.Counter.launches, "k2": K2.Counter.by_mode["none"],
            "k2_per_slot": K2.Counter.by_mode["per_slot"],
            "k2_fat": K2.Counter.by_mode["fat"], "k2_lds": K2.Counter.lds,
            "k2_env": K2.Counter.env,
            "k3": K3.Counter.launches, "k3_w16": K3.Counter.wide,
            "k4": K4.Counter.launches, "k5": K5.Counter.launches,
            "k6": K6.Counter.launches,
            "block_entry": BLOCKS.Counter.launches,
            "k7": ISECT.StackCounter.launches,
            "k7_depth": ISECT.StackCounter.depth,
            "k8": ISECT.LinkedCounter.launches, "k9": K9.Counter.launches}


def expect(**counts) -> dict:
    return {k: counts.get(k, 0) for k in launch_counts()}


def counted_render(r: Renderer, spp: int, report: dict, path: str,
                   expected: dict):
    """``r.render(spp)`` with every launch count set to 0 just before and
    read just after; the counts must equal ``expected``. Returns (image,
    wall seconds)."""
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    hdr = r.render(spp=spp)
    secs = time.perf_counter() - t0
    counts = launch_counts()
    say(path, f"{r.config.width}x{r.config.height} x {spp} spp: launches "
        + ", ".join(f"{k.upper()} {v}" for k, v in counts.items()))
    if counts != expected:
        raise AssertionError(f"{path}: expected launches {expected}")
    for k, v in counts.items():
        report.setdefault(k, {}).setdefault("launches_by_path", {})[path] = v
    if hdr.shape != (r.config.height, r.config.width, 3) or not np.isfinite(
            hdr).all():
        raise AssertionError(f"{path}: the image is not finite or has the "
                             "wrong shape")
    return hdr, secs


def repeat_renders(r: Renderer, spp: int, rays: int, path: str, smi: str,
                   repeats: int = REPEATS):
    """``repeats`` more renders of the same frames (the wall clock of one
    render moves with the host); returns (median, quartiles, walls)."""
    walls = []
    for _ in range(repeats):
        r.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r.render(spp=spp, fetch=False)
        walls.append(time.perf_counter() - t0)
    q1, med, q3 = np.percentile(walls, [25, 50, 75])
    say(path, f"{repeats} more renders of the same {spp} spp: wall median "
        f"{med:.4f} s (quartiles {q1:.4f}, {q3:.4f}; min {min(walls):.4f}, "
        f"max {max(walls):.4f}), {rays / med / 1e6:.3f} Mrays/s at the median "
        f"({rays / q3 / 1e6:.3f} and {rays / q1 / 1e6:.3f} at the quartiles) "
        f"on {smi}")
    return float(med), [float(q1), float(q3)], walls


def pixels_differing(a: np.ndarray, b: np.ndarray) -> int:
    """Pixels of two (H, W, 3) float32 images whose bits differ."""
    return int((a.view(np.uint32) != b.view(np.uint32)).any(-1).sum())


def checked_plain(r: Renderer, spp: int, hdr: np.ndarray, path: str,
                  repack: bool = True):
    """The plain path's image of the same frames (``plain_render``) against
    the kernels', which must be equal on every pixel; returns the plain
    wall seconds."""
    launched = launch_counts()
    t0 = time.perf_counter()
    hdr_plain = plain_render(r, spp, repack)
    plain_secs = time.perf_counter() - t0
    if launch_counts() != launched:
        raise AssertionError("the plain path launched a kernel")
    pixels = pixels_differing(hdr, hdr_plain)
    w, h = r.config.width, r.config.height
    say(path, f"plain path ({w}x{h} x {spp} spp): wall {plain_secs:.3f} s; "
        f"its image differs from the kernels' on {pixels} of {w * h} pixels")
    if pixels:
        raise AssertionError(f"{path}: the kernel path's image differs from "
                             "the plain path's")
    return plain_secs


def phase_main(dev, smi, report, profile: str | None):
    r = Renderer(RenderConfig(width=SIZE, height=SIZE), device="cuda")
    r.load_scene(cornell_box())
    if r.stats()["intersector"] != "brute":
        raise AssertionError("the flagship box must take the dense hit (K1)")
    hdr, secs = counted_render(
        r, SPP, report, "main", expect(k1=2 * MAX_BOUNCES * SPP,
                                       k2=MAX_BOUNCES * SPP))
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

    plain_secs = checked_plain(r, SPP, hdr, "main")
    med, quartiles, walls = repeat_renders(r, SPP, stats["rays_total"],
                                           "main", smi)
    report["main"] = {"seconds": secs, "mrays_per_sec": mrays,
                      "repeat_median_seconds": med,
                      "repeat_quartile_seconds": quartiles,
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
        expect(k2=MAX_BOUNCES * FORCED_WALK_SPP,
               k3=2 * MAX_BOUNCES * FORCED_WALK_SPP))
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

    # The bounce loop by name (RenderConfig.bounce_kernel): "pallas" is K2
    # as "auto" is, "xla" the plain bounce loop with no K2 launch; the
    # three images equal on every pixel.
    images = {}
    for kernel in ("auto", "pallas", "xla"):
        b = Renderer(RenderConfig(width=BOUNCE_KERNEL_SIZE,
                                  height=BOUNCE_KERNEL_SIZE,
                                  bounce_kernel=kernel), device="cuda")
        b.load_scene(cornell_box())
        images[kernel], _ = counted_render(
            b, BOUNCE_KERNEL_SPP, report, f"bounce_kernel_{kernel}",
            expect(k1=2 * MAX_BOUNCES * BOUNCE_KERNEL_SPP,
                   k2=0 if kernel == "xla" else MAX_BOUNCES
                   * BOUNCE_KERNEL_SPP))
    for kernel in ("pallas", "xla"):
        same_image(images[kernel], images["auto"],
                   f"bounce_kernel={kernel!r} at {BOUNCE_KERNEL_SIZE}x"
                   f"{BOUNCE_KERNEL_SIZE} x {BOUNCE_KERNEL_SPP} spp against "
                   "'auto'", "main")


def phase_textured(dev, smi, report, profile: str | None):
    """The textured boxes through the main path's entry points: each
    ``Renderer(RenderConfig(width=512, height=512))``, ``load_scene``,
    ``render(spp=64)``, with K2 in the scene's texture mode."""
    for path, scene_fn, mode in TEXTURED:
        r = Renderer(RenderConfig(width=SIZE, height=SIZE), device="cuda")
        t0 = time.perf_counter()
        r.load_scene(scene_fn())
        torch.cuda.synchronize()
        load = time.perf_counter() - t0
        stats = r.stats()
        say(path, f"load_scene {load:.3f} s; intersector "
            f"{stats['intersector']!r}, texture {stats['texture']!r}")
        if stats["texture"] != mode or stats["intersector"] != "brute":
            raise AssertionError(f"{path}: expected K1 and texture {mode!r}")
        hdr, secs = counted_render(
            r, SPP, report, path,
            expect(k1=2 * MAX_BOUNCES * SPP,
                   **{f"k2_{mode}": MAX_BOUNCES * SPP}))
        key = report[f"k2_{mode}"]
        key.setdefault("launches", key["launches_by_path"][path])
        stats = r.stats()
        rays = stats["rays_total"]
        say(path, f"cold render: wall {secs:.3f} s, {rays} rays "
            f"({stats['rays_closest']} closest + {stats['rays_shadow']} "
            f"shadow), {rays / secs / 1e6:.3f} Mrays/s on {smi}")
        plain_secs = checked_plain(r, SPP, hdr, path)
        med, quartiles, walls = repeat_renders(r, SPP, rays, path, smi)
        report[path] = {"texture": mode, "load_seconds": load,
                        "seconds": secs, "mrays_per_sec": rays / secs / 1e6,
                        "repeat_median_seconds": med,
                        "repeat_quartile_seconds": quartiles,
                        "repeat_seconds": walls, "plain_seconds": plain_secs,
                        "mean_hdr": float(hdr.mean())}
        if profile and path == "textured":
            root, ext = os.path.splitext(profile)
            profile_frames(r, f"{root}_textured{ext}", path)


def ray_cases(scene_np, scene, rays, state, t, idx):
    """The three ray sets a kernel is held to its plain version on: the
    camera rays, the bounce-1 rays of one plain bounce from their hits
    (t, idx) and that bounce's shadow rays (``t_max``, ``any_hit``).
    Returns (K2's arguments, keywords and plain outputs, the cases)."""
    n = rays.shape[1]
    dev = rays.device
    args = (0, rays, state, torch.ones((3, n), device=dev),
            torch.zeros((3, n), device=dev),
            torch.ones((n,), dtype=torch.bool, device=dev), t, idx,
            scene["tri_full"], scene["light_full"])
    kw = dict(do_mis=True, num_lights=scene_np.num_lights)
    pout = K2.bounce_stage_plain(*args, **kw)
    bounce, alive = pout[0].contiguous(), pout[4]
    shadow, smask, stmax = pout[5].contiguous(), pout[7], pout[6]
    cases = [("camera", rays, {}),
             ("bounce-1", bounce, {"active": alive}),
             ("shadow-0", shadow, {"active": smask, "t_max": stmax,
                                   "any_hit": True})]
    return args, kw, pout, cases


def spine_tables(levels: int, dev, width: int = 8) -> tuple:
    """Walk tables of a binary spine, collapsed with ``pack="none"`` at
    ``width``: binary node 2k holds triangle k as its left leaf and the rest
    of the spine as its right child, so each wide node takes width - 1
    single-triangle leaves and the tree at width 8 has ``levels`` interior
    levels or more (at 16 about half as many). Triangle k lies at x = k.
    Returns (the walk tables, the (T, 9) [v0, e1, e2] triangles)."""
    spine = 7 * levels + 128  # a subtree of <= 128 triangles is one group
    tris = np.zeros((spine + 1, 9), np.float32)
    tris[:, 0] = np.arange(spine + 1)
    tris[:, 3:6] = [0.5, 1.0, 0.0]
    tris[:, 6:9] = [0.3, 0.0, 1.0]
    lo = tris[:, 0:3]
    hi = lo + np.maximum(tris[:, 3:6], tris[:, 6:9])
    meta, amin, amax = [], [], []
    for k in range(spine):  # interior node 2k, leaf 2k + 1
        meta += [[2 * k + 1, 2 * k + 2, 0, 0], [-1, -1, k, 1]]
        amin += [lo[k:].min(0), lo[k]]
        amax += [hi[k:].max(0), hi[k]]
    meta.append([-1, -1, spine, 1])
    amin.append(lo[spine])
    amax.append(hi[spine])
    wide = bvh8.build_wide_bvh(np.array(amin), np.array(amax),
                               np.array(meta, np.int32), tris, pack="none",
                               width=width)
    scene = {"walk_order": torch.from_numpy(wide.order).to(dev),
             "walk_boxes": torch.from_numpy(wide.boxes).to(dev),
             "walk_tris": torch.from_numpy(wide.tris).to(dev)}
    return K3.walk_tables(scene), tris


def left_spine(levels: int) -> dict:
    """A binary BVH as deep as ``levels``: interior node 2k has the rest of
    the spine as its LEFT child (node 2k + 2) and triangle k as its right
    leaf (node 2k + 1), so the left-first stack walk keeps one right leaf a
    level on its stack and overflows a stack of fewer than ``levels``
    entries. Triangle k lies at x = k, as ``spine_tables``' do. Returns the
    NumPy tables ``bvh_aabb`` (B, 6), ``bvh_meta`` (B, 4), ``bvh_links``
    and ``tri_isect`` (levels + 1, 9)."""
    from wgpu_path_tracing_tpu_torch.accel.bvh import build_links

    tris = np.zeros((levels + 1, 9), np.float32)
    tris[:, 0] = np.arange(levels + 1)
    tris[:, 3:6] = [0.5, 1.0, 0.0]
    tris[:, 6:9] = [0.3, 0.0, 1.0]
    lo = tris[:, 0:3]
    hi = lo + np.maximum(tris[:, 3:6], tris[:, 6:9])
    meta, box = [], []
    for k in range(levels):
        meta += [[2 * k + 2, 2 * k + 1, 0, 0], [-1, -1, k, 1]]
        box += [np.concatenate([lo[k:].min(0), hi[k:].max(0)]),
                np.concatenate([lo[k], hi[k]])]
    meta.append([-1, -1, levels, 1])
    box.append(np.concatenate([lo[levels], hi[levels]]))
    meta = np.array(meta, np.int32)
    return {"bvh_aabb": np.array(box, np.float32), "bvh_meta": meta,
            "bvh_links": build_links(meta), "tri_isect": tris}


def spine_rays(n: int, spine: int, seed: int, dev):
    """Rays from anywhere along the spine's length, mostly along +-x, so
    they cross the triangles' planes and walk deep into the tree."""
    rng = np.random.default_rng(seed)
    o = rng.uniform([-1.0, 0.1, 0.1], [spine + 1.0, 0.9, 0.9], (n, 3))
    d = rng.normal(scale=[1.0, 0.2, 0.2], size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (torch.from_numpy(o.T.astype(np.float32)).contiguous().to(dev),
            torch.from_numpy(d.T.astype(np.float32)).contiguous().to(dev))


def same_hits(a, b, what: str) -> None:
    """Two (t, idx) results, bit for bit on every lane."""
    t_lanes, _, _ = compare(a[0], b[0])
    i_lanes = int((a[1] != b[1]).sum())
    if t_lanes or i_lanes:
        raise AssertionError(f"{what}: t differs on {t_lanes} lanes, idx on "
                             f"{i_lanes}")


def walk_bound(visits: dict, tables, n: int) -> tuple:
    """K3's bound on ``n`` rays, at the tables' width W: the rays and (t,
    idx) once, the three tables once, and the work these rays need by the
    plain walk's count: a slab test for each non-empty child of an interior
    visit (up to W) and for each sub-cluster of a leaf visit that holds a
    triangle, and a Möller-Trumbore test for each triangle of an entered
    sub-cluster."""
    ops = (SLAB_OPS * (visits["children"] + visits["sub_boxes"])
           + MT_OPS * visits["triangles"])
    moved = 6 * 4 * n + nbytes(tables.order, tables.boxes, tables.tris) + 8 * n
    return bound(moved, ops), ops


def large_sets(dev) -> dict:
    """The large box (``cornell_box(tessellation=55)``), packed and
    uploaded, its walk tables, its camera rays and the three ray cases of
    ``ray_cases`` (from the plain walk's hits), and a late-bounce mask of
    the bounce-1 rays, about 5% of them alive: what phases k3 and dispatch
    share."""
    scene_np, _ = tessellated_box(LARGE_TESSELLATION)
    t0 = time.perf_counter()
    scene, rays, state = flagship_rays(scene_np, dev)
    say("large", f"{scene_np.num_triangles} triangles; packed and uploaded "
        f"in {time.perf_counter() - t0:.2f} s")
    tables = K3.walk_tables(scene)
    t, idx = K3.closest_hit_walk_plain(tables, rays[0:3], rays[3:6],
                                       num_tris=scene["tri_isect"].shape[0])
    k2_case = ray_cases(scene_np, scene, rays, state, t, idx)
    cases = k2_case[3]
    late = cases[1][2]["active"] & torch.from_numpy(
        np.random.default_rng(7).random(rays.shape[1]) < 0.05).to(dev)
    return {"scene_np": scene_np, "scene": scene, "tables": tables,
            "rays": rays, "k2_case": k2_case[:3], "cases": cases,
            "late": late}


def phase_k3(dev, report, large: dict):
    """K3 on the large box (``large_sets``)."""
    scene, tables = large["scene"], large["tables"]
    rays, cases, late = large["rays"], large["cases"], large["late"]
    args, kw, pout = large["k2_case"]
    tri = scene["tri_isect"]
    nt = tri.shape[0]
    n = rays.shape[1]
    say("k3", f"wide BVH: {tables.order.shape[0]} nodes, "
        f"{tables.tris.shape[0] // K3.GROUP_ROWS} leaf groups; the kernel's "
        f"stack {tables.levels} entries a ray in shared memory "
        f"({tables.levels * 4 * K3.THREADS} B a block; the plain walk's "
        f"{tables.stack}); leaf records {nbytes(tables.leaves)} B against "
        f"walk_tris' {nbytes(tables.tris)} B")
    kout = K2.bounce_stage_cuda(*args, **kw)
    summary = check_k2(kout, pout, n, "the large box",
                       report.setdefault("k2", {}))
    say("k2", f"cornell_box(tessellation={LARGE_TESSELLATION}) bounce 0: {n} "
        "lanes; " + summary)
    bounce, alive = cases[1][1], cases[1][2]["active"]
    worst, visits = 0.0, {}
    for name, r, extra in cases:
        o, d = r[0:3], r[3:6]
        kt, ki = K3.closest_hit_walk(tables, o, d, num_tris=nt, **extra)
        visits[name] = {}
        pt, pi = K3.closest_hit_walk_plain(tables, o, d, num_tris=nt,
                                           visits=visits[name], **extra)
        t_lanes, t_ulp, t_err = compare(kt, pt)
        i_lanes = int((ki != pi).sum())
        say("k3", f"{name} rays: {n} lanes ({int((pi >= 0).sum())} hits), t "
            f"differs on {t_lanes} (max {t_ulp} ulp), idx differs on "
            f"{i_lanes}; a ray (the plain walk's count): "
            + ", ".join(f"{visits[name][k] / n:.2f} {k.replace('_', '-')}"
                        for k in ("interior", "leaf", "children", "sub_boxes",
                                  "sub_clusters", "triangles")))
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
    # A tree deeper than the large box's: the shared stack at 9 and more
    # entries a ray.
    spine, spine_tris = spine_tables(10, dev)
    so, sd = spine_rays(4096, len(spine_tris), 1, dev)
    same_hits(K3.closest_hit_walk(spine, so, sd),
              K3.closest_hit_walk_plain(spine, so, sd), "K3 on the spine")
    say("k3", f"a spine of {len(spine_tris)} triangles, "
        f"{spine.order.shape[0]} wide nodes, stack {spine.levels} entries a "
        "ray: 4096 random rays equal the plain walk's on every lane")

    # The sorted walk: bounce rays in bucket order, against the bare kernel,
    # on bounce-1 rays, a late-bounce mask (5% of them alive) and the
    # bounce's shadow rays.
    closest_hit = make_closest_hit(scene)
    shadow, sextra = cases[2][1], cases[2][2]
    sorted_cases = [("bounce-1", bounce, {"active": alive}),
                    ("late-bounce", bounce, {"active": late}),
                    ("shadow-0", shadow, sextra)]
    for name, r, extra in sorted_cases:
        o, d = r[0:3], r[3:6]
        same_hits(closest_hit(o, d, reorder=True, **extra),
                  K3.closest_hit_walk(tables, o, d, num_tris=nt, **extra),
                  f"the sorted walk on the {name} rays")
    say("k3", f"sorted walk (make_closest_hit, reorder=True: "
        f"{REORDER_BUCKETS} buckets) equals the bare kernel "
        f"on every lane of the bounce-1, late-bounce ({int(late.sum())} "
        f"alive) and shadow-0 rays")

    # Times: the bare kernel and the sorted walk (whole calls) on each ray
    # set, and the sort's share alone (the wrapper around an inner call that
    # launches nothing).
    machinery = with_ray_order(
        lambda ro3, rd3, active, t_max, any_hit: (
            ro3[0], torch.zeros_like(ro3[0], dtype=torch.int32)),
        scene["root_box"])
    times = {}
    for name, r, extra in [("camera", rays, {})] + sorted_cases:
        o, d = r[0:3], r[3:6]
        times[name] = {
            "bare": device_ms(lambda: K3.closest_hit_walk(
                tables, o, d, num_tris=nt, **extra)),
            "sorted": device_ms(lambda: closest_hit(o, d, reorder=True,
                                                    **extra)),
            "sort": device_ms(lambda: machinery(o, d, reorder=True,
                                                **extra))}
    o, d = rays[0:3], rays[3:6]
    eager = eager_ms(lambda: K3.closest_hit_walk(tables, o, d, num_tris=nt))
    plain = eager_ms(lambda: K3.closest_hit_walk_plain(tables, o, d,
                                                       num_tris=nt), reps=2)
    ms, bounce_ms = times["camera"]["bare"], times["bounce-1"]["bare"]
    say("k3", f"time at {n} camera rays x {nt} tris: device {ms:.4f} ms "
        f"(plain {plain:.4f} ms, launched from Python, which the plain "
        f"walk's per-iteration host syncs need); launched from Python "
        f"{eager:.4f} ms; bounce-1 rays: device {bounce_ms:.4f} ms")
    for name, tm in times.items():
        say("k3", f"{name} rays: bare kernel {tm['bare']:.4f} ms, sorted walk "
            f"{tm['sorted']:.4f} ms (whole call), of which the sort, gathers "
            f"and scatters {tm['sort']:.4f} ms")
    b, ops = walk_bound(visits["camera"], tables, n)
    bb, bops = walk_bound(visits["bounce-1"], tables, n)
    say("k3", f"bound at {n} camera rays: {b['bound_ms']:.4f} ms "
        f"({b['bound_by']}; {ops / 1e9:.3f} Gop); bounce-1 rays: "
        f"{bb['bound_ms']:.4f} ms ({bb['bound_by']}; {bops / 1e9:.3f} Gop)")
    report.setdefault("k3", {}).update(
        max_abs_err=worst, ms=ms, plain_ms=plain, bounce_ms=bounce_ms,
        bounce_bound_ms=bb["bound_ms"], sorted_ms=times,
        visits_per_ray={name: {k: v / n for k, v in vis.items()}
                        for name, vis in visits.items()}, **b)


def dispatch_bound(kind: str, visits: dict, scene: dict, tables, n: int,
                   old: bool = False):
    """A dispatch intersector's bound on ``n`` rays from its plain version's
    ``visits``: the rays and (t, idx) once, the table rows the call reads
    once (K4: the distinct super tiles its pairs name, and the super boxes;
    K5: its leaf records; K6: the whole table), and the slab and
    Möller-Trumbore tests the plain version counted (phase 1's sweep
    included). K5's gate counts the filled sub-boxes only, or the slab tests
    its gate scheme needs on these rays where that is fewer
    (``K5.gate_scheme``), and its triangle tests the live lanes' only; with
    ``old``, the coarser count: every sub-box and every lane of a block,
    against ``walk_tris``."""
    moved = 6 * 4 * n + 8 * n
    tests = visits["triangle_tests"]
    if kind == "pairs":
        bn = K4.BN
        moved += (visits["tiles"] * K4.TILE_ROWS * K4.PAIRS_COLS * 4
                  + nbytes(tables.super_aabb))
        slabs = visits["blocks"] * bn * visits["supers"] + visits["slab_tests"]
    elif kind == "phased" and old:
        moved += nbytes(tables.tris)
        slabs = visits["sub_boxes"] * K5.BN
    elif kind == "phased":
        moved += nbytes(tables.leaves)
        slabs = min(visits["filled_sub_boxes"] * K5.BN,
                    visits["gate_slab_tests"])
        tests = visits["live_triangle_tests"]
    else:
        moved += nbytes(tables.aabb, tables.tris)
        slabs = visits["blocks"] * K6.BN * visits["boxes"]
    ops = SLAB_OPS * slabs + MT_OPS * tests
    return bound(moved, ops), ops


def route_lanes(scene: dict, o, d, extra: dict):
    """The rays ``make_closest_hit``'s pair route hands K4 for a bounce call
    (``reorder=True``): the origins, directions and keywords that
    ``with_tail_compaction`` passes on (compacted, sorted)."""
    got = []

    def record(ro3, rd3, active=None, t_max=None, any_hit=False):
        got.append((ro3, rd3, active, t_max))
        m = ro3.shape[1]
        return (torch.full((m,), torch.inf, device=ro3.device),
                torch.full((m,), -1, dtype=torch.int32, device=ro3.device))

    with_tail_compaction(record, scene["root_box"], pairs_reorder(scene))(
        o, d, reorder=True, **extra)
    ro3, rd3, active, t_max = got[0]
    kw = {"active": active}
    if t_max is not None:
        kw["t_max"] = t_max
    if "any_hit" in extra:
        kw["any_hit"] = extra["any_hit"]
    return ro3.contiguous(), rd3.contiguous(), kw


def dispatch_sets(kind: str, shared: dict):
    """The ray sets a dispatch intersector is held to its plain version on:
    (name, rays (6, N), keywords, whether the set goes through the pair
    route's wrapper). Every kind takes the camera, bounce-1 and shadow-0
    rays as they are; K4 also the bounce-1 rays, a mid-bounce mask of them
    (about 36% alive: the n/2 tier) and a late-bounce mask (about 5%: the
    n/8 tier) through
    ``with_tail_compaction``, K6 the late-bounce mask as it is (K6 gets
    no ray order, as in the JAX package), and K5 the late-bounce mask and
    a ray count that fills no block (the camera rays but the last 1,037)."""
    cases = [(name, r, extra, False) for name, r, extra in shared["cases"]]
    bounce, bextra = cases[1][1], cases[1][2]
    if kind == "phased":
        cam = cases[0][1]
        cases += [("late-bounce", bounce, {"active": shared["late"]}, False),
                  ("ragged", cam[:, :cam.shape[1] - 1037], {}, False)]
    if kind == "pairs":
        mid = bextra["active"] & torch.from_numpy(
            np.random.default_rng(8).random(bounce.shape[1]) < 0.4).to(
                bounce.device)
        cases += [("bounce-1 sorted", bounce, bextra, True),
                  ("mid-bounce", bounce, {"active": mid}, True),
                  ("late-bounce", bounce, {"active": shared["late"]}, True)]
    elif kind == "cluster":
        cases.append(("late-bounce", bounce, {"active": shared["late"]},
                      False))
    return cases


def check_phase1(kind: str, tables, o, d, kw: dict, what: str) -> dict:
    """The phase-1 kernel against ``block_entry`` on the rays as K4 or K6
    receives them (-0 == +0), and the lists made from each, equal; the
    device ms of the kernel, of ``block_entry`` and of phase 1 and the sort
    as the wrapper makes them."""
    bn, lists, boxes = ((K4.BN, K4.pair_list, tables.super_aabb)
                        if kind == "pairs"
                        else (K6.BN, K6.candidates, tables.aabb))
    order = K4.sorted_pairs if kind == "pairs" else K6.pick_order
    lim0 = BLOCKS.ray_limit(kw.get("active"), kw.get("t_max"), o.shape[1],
                            o.device)
    rays = BLOCKS.pad_blocks(o, d, lim0, bn)
    ke = BLOCKS.block_entry_cuda(boxes, *rays)
    pe = BLOCKS.block_entry(boxes, *rays)
    torch.cuda.synchronize()
    signs = int(((ke == 0) & (torch.signbit(ke) != torch.signbit(pe))).sum())
    if not torch.equal(ke, pe):
        raise AssertionError(f"the phase-1 kernel disagrees with block_entry "
                             f"on the {what} rays")
    if not all(torch.equal(a, b) for a, b in zip(order(ke), order(pe))):
        raise AssertionError(f"the phase-1 kernel's {kind} lists differ from "
                             f"the plain ones on the {what} rays")
    nb, c = ke.shape
    out = {"blocks": nb, "boxes": c, "zero_signs_differing": signs,
           "entries": int((pe < torch.inf).sum()),
           "phase1_ms": device_ms(lambda: BLOCKS.block_entry_cuda(boxes,
                                                                  *rays),
                                  reps=5),
           "phase1_plain_ms": device_ms(lambda: BLOCKS.block_entry(boxes,
                                                                   *rays),
                                        reps=5),
           "lists_ms": device_ms(lambda: lists(boxes, *rays), reps=5)}
    b = bound(nbytes(*rays[0], *rays[1], rays[2], boxes, ke),
              SLAB_OPS * nb * bn * c)
    out.update(phase1_bound_ms=b["bound_ms"], phase1_bound_by=b["bound_by"])
    return out


PHASE1_KEYS = ("phase1_ms", "phase1_plain_ms", "phase1_bound_ms", "blocks",
               "boxes", "entries", "zero_signs_differing")


def check_dispatch(kind: str, shared: dict, report: dict):
    """One dispatch intersector against its plain version, bit for bit, on
    its ray sets (``dispatch_sets``; the sets through the pair route's
    wrapper on the lanes it hands K4, and the whole wrapped call against
    the bare kernel's result scattered back); phase 1 (K4, K6) against
    ``block_entry``; against K3 and K1 on the bare closest-hit rays; each
    timed set beside its bound."""
    key = {"pairs": "k4", "phased": "k5", "cluster": "k6"}[kind]
    _, kernel, plain, get_tables = DISPATCH[kind]
    scene, walk_tables = shared["scene"], shared["tables"]
    tables = get_tables(scene)
    tri = scene["tri_isect"]
    nt = tri.shape[0]
    n = shared["cases"][0][1].shape[1]
    route = make_closest_hit(scene, "pairs") if kind == "pairs" else None
    worst, sets = 0.0, {}
    for name, r, extra, wrapped in dispatch_sets(kind, shared):
        o, d = r[0:3], r[3:6]
        if wrapped:
            ko, kd, kw = route_lanes(scene, o, d, extra)
        else:
            ko, kd, kw = o, d, extra
        m = ko.shape[1]
        kt, ki = kernel(tables, ko, kd, num_tris=nt, **kw)
        torch.cuda.synchronize()
        visits = {}
        pt, pi = plain(tables, ko, kd, num_tris=nt, visits=visits, **kw)
        if kind == "phased":
            visits["gate_slab_tests"] = phased_gate_scheme(tables, ko, kd, kw,
                                                           name)
        t_lanes, t_ulp, t_err = compare(kt, pt)
        i_lanes = int((ki != pi).sum())
        live = "all" if kw.get("active") is None else int(kw["active"].sum())
        say(key, f"{name} rays: {m} lanes ({live} alive, "
            f"{int((pi >= 0).sum())} hits), t differs on {t_lanes} (max "
            f"{t_ulp} ulp), idx differs on {i_lanes}; the plain version's "
            f"count: {visits}")
        if t_lanes or i_lanes:
            raise AssertionError(f"{key.upper()} disagrees with its plain "
                                 f"version on the {name} rays")
        worst = max(worst, t_err)
        entry = {"lanes": m, "visits": visits}
        if wrapped:
            # The whole route: the kernel through the wrapper equals the
            # bare kernel's result on the lanes above, scattered back.
            wt, wi = route(o, d, reorder=True, **extra)
            st, si = with_tail_compaction(
                lambda *args, **kwargs: (kt, ki), scene["root_box"],
                pairs_reorder(scene))(o, d, reorder=True, **extra)
            same_hits((wt, wi), (st, si), f"K4's route on the {name} rays")
            entry["wrapper_ms"] = eager_ms(
                lambda: route(o, d, reorder=True, **extra), reps=5)
        if kind != "phased":
            entry.update(check_phase1(kind, tables, ko, kd, kw, name))
        else:
            entry["split_ms"] = kernel_split(
                lambda: kernel(tables, ko, kd, num_tris=nt, **kw))
            say(key, f"{name} rays: device ms a call by kernel "
                "(torch.profiler): " + ", ".join(
                    f"{k} {v:.4f}" for k, v in entry["split_ms"].items()))
        if name not in ("shadow-0", "ragged"):
            entry["ms"] = device_ms(
                lambda: kernel(tables, ko, kd, num_tris=nt, **kw), reps=5)
            b, ops = dispatch_bound(kind, visits, scene, tables, m)
            entry.update(bound_ms=b["bound_ms"], bound_by=b["bound_by"],
                         gop=ops / 1e9)
            if kind == "phased":
                old, old_ops = dispatch_bound(kind, visits, scene, tables, m,
                                              old=True)
                entry.update(old_bound_ms=old["bound_ms"],
                             old_gop=old_ops / 1e9)
                say(key, f"{name} rays: bound counting every sub-box and "
                    f"every lane "
                    f"{old['bound_ms']:.4f} ms ({old_ops / 1e9:.3f} Gop), "
                    f"now {b['bound_ms']:.4f} ms")
            say(key, f"{name} rays: device {entry['ms']:.4f} ms"
                + (" (the wrapper's whole call: phase 1, the sort, the "
                   "kernel)" if kind != "phased" else "")
                + (f", phase 1 and the sort {entry['lists_ms']:.4f} ms "
                   f"(phase 1's kernel {entry['phase1_ms']:.4f} ms, "
                   f"block_entry {entry['phase1_plain_ms']:.4f} ms; "
                   f"{entry['zero_signs_differing']} zero signs differ)"
                   if "lists_ms" in entry else "")
                + (f"; through make_closest_hit (compaction, order, host "
                   f"sync; launched from Python) {entry['wrapper_ms']:.4f} "
                   "ms" if wrapped else "")
                + f"; bound {b['bound_ms']:.4f} ms ({b['bound_by']}; "
                f"{ops / 1e9:.3f} Gop)")
        sets[name] = entry
        if wrapped or name in ("shadow-0", "late-bounce", "ragged"):
            continue
        active = extra.get("active")
        wt, wi = K3.closest_hit_walk(walk_tables, o, d, num_tris=nt, **extra)
        dt, di = K1.closest_hit_dense_cuda(tri, r.contiguous())
        if active is not None:
            dt = torch.where(active, dt, torch.inf)
            di = torch.where(active, di, -1)
        for other, ot, oi in (("K3", wt, wi), ("K1", dt, di)):
            idx_apart, t_apart = ki != oi, kt != ot
            ties = not bool(t_apart.any())
            say(key, f"{name} rays against {other}: idx differs on "
                f"{int(idx_apart.sum())} lanes, t on {int(t_apart.sum())}; "
                "every difference an exact-t tie: "
                f"{'yes' if ties else 'no'}")
            if int((idx_apart | t_apart).sum()) > 0.01 * n:
                raise AssertionError(f"{key.upper()} and {other} disagree on "
                                     f"more than 1% of the {name} rays")
    cam = shared["cases"][0][1]
    o, d = cam[0:3], cam[3:6]
    plain_ms = eager_ms(lambda: plain(tables, o, d, num_tris=nt), reps=1)
    cam_set, bounce_set = sets["camera"], sets["bounce-1"]
    say(key, f"time at {n} camera rays x {nt} tris: device "
        f"{cam_set['ms']:.4f} ms (plain {plain_ms:.4f} ms, launched from "
        f"Python with its host syncs), bound {cam_set['bound_ms']:.4f} "
        f"ms; bounce-1 rays: device {bounce_set['ms']:.4f} ms, bound "
        f"{bounce_set['bound_ms']:.4f} ms")
    report.setdefault(key, {}).update(
        max_abs_err=worst, ms=cam_set["ms"], plain_ms=plain_ms,
        bounce_ms=bounce_set["ms"],
        bounce_bound_ms=bounce_set["bound_ms"],
        split_ms={k: v["split_ms"] for k, v in sets.items()
                  if "split_ms" in v} or None,
        lists_ms={k: v["lists_ms"] for k, v in sets.items()
                  if "lists_ms" in v} or None,
        triangles=nt, sets=sets, bound_ms=cam_set["bound_ms"],
        bound_by=cam_set["bound_by"], library_ms=None)
    if kind == "phased":
        # The coarser bound (every sub-box, every lane), beside.
        report[key].update(old_bound_ms=cam_set["old_bound_ms"],
                           bounce_old_bound_ms=bounce_set["old_bound_ms"])
    if kind == "pairs":
        # The phase-1 kernel's entry: its time and bound on K4's camera
        # rays; every set above held it to block_entry.
        report.setdefault("block_entry", {}).update(
            max_abs_err=0.0, ms=cam_set["phase1_ms"],
            plain_ms=cam_set["phase1_plain_ms"],
            bound_ms=cam_set["phase1_bound_ms"],
            bound_by=cam_set["phase1_bound_by"], library_ms=None,
            by_set={k: {f: v[f] for f in PHASE1_KEYS}
                    for k, v in sets.items() if "phase1_ms" in v})
    elif kind == "cluster":
        report.setdefault("block_entry", {})["k6_by_set"] = {
            k: {f: v[f] for f in PHASE1_KEYS}
            for k, v in sets.items() if "phase1_ms" in v}


def phased_gate_scheme(tables, o, d, kw: dict, what: str) -> int:
    """K5's gate scheme (``K5.gate_scheme``: union boxes first) on the rays
    as the kernel receives them: its gates must equal the plain version's
    sub-box gates; returns the slab tests it needs."""
    lim0 = BLOCKS.ray_limit(kw.get("active"), kw.get("t_max"), o.shape[1],
                            o.device)
    rays = BLOCKS.pad_blocks(o, d, lim0, K5.BN)
    groups = tables.tris.view(-1, K5.GROUP_ROWS, K5.LEAF_SLOTS)
    gates, tests = K5.gate_scheme(groups, *rays)
    if not torch.equal(gates, K5.sub_gates(groups, *rays)):
        raise AssertionError(f"K5's union-box gate scheme drops or adds a "
                             f"gate on the {what} rays")
    return tests


def check_phased_large(large: dict, report: dict) -> None:
    """K5 against its plain version, bit for bit, on the large box's camera
    rays (1,084 leaf groups: the test kernel's gate windows and the gate
    kernel's grid at that size), with its time."""
    scene, rays = large["scene"], large["cases"][0][1]
    tables = K5.phased_tables(scene["walk_tris"])
    nt = scene["tri_isect"].shape[0]
    o, d = rays[0:3], rays[3:6]
    kt, ki = K5.closest_hit_phased(tables, o, d, num_tris=nt)
    torch.cuda.synchronize()
    pt, pi = K5.closest_hit_phased_plain(tables, o, d, num_tris=nt)
    same_hits((kt, ki), (pt, pi), "K5 on the large box's camera rays")
    ms = device_ms(lambda: K5.closest_hit_phased(tables, o, d, num_tris=nt),
                   reps=5)
    groups = tables.tris.shape[0] // K5.GROUP_ROWS
    say("k5", f"large box ({nt} triangles, {groups} leaf groups, ordered "
        f"slots: {tables.ordered}), camera rays: t and idx equal the plain "
        f"version's on every lane; device {ms:.4f} ms")
    report.setdefault("k5", {})["large_camera"] = {
        "triangles": nt, "groups": groups, "ms": ms,
        "hits": int((pi >= 0).sum())}


def phase_dispatch(dev, report, large: dict):
    """K4 and K6 on the large box (``large_sets``), K5 on the mid-size box
    and on the large box's camera rays."""
    check_dispatch("pairs", large, report)
    check_dispatch("cluster", large, report)
    check_phased_large(large, report)
    scene_np, _ = tessellated_box(PHASED_TESSELLATION)
    scene, rays, state = flagship_rays(scene_np, dev)
    tables = K3.walk_tables(scene)
    nt = scene["tri_isect"].shape[0]
    say("k5", f"cornell_box(tessellation={PHASED_TESSELLATION}): {nt} "
        f"triangles, {tables.tris.shape[0] // K3.GROUP_ROWS} leaf groups")
    t, idx = K3.closest_hit_walk(tables, rays[0:3], rays[3:6], num_tris=nt)
    _, _, _, cases = ray_cases(scene_np, scene, rays, state, t, idx)
    late = cases[1][2]["active"] & torch.from_numpy(
        np.random.default_rng(7).random(rays.shape[1]) < 0.05).to(dev)
    check_dispatch("phased", {"scene": scene, "tables": tables,
                              "cases": cases, "late": late}, report)


def forced_renderer(intersector: str, scene_np, strategy: str) -> Renderer:
    r = Renderer(RenderConfig(width=SIZE, height=SIZE,
                              intersector=intersector), device="cuda")
    r.load_scene(scene_np)
    if r.stats()["intersector"] != strategy:
        raise AssertionError(f"intersector={intersector!r} took "
                             f"{r.stats()['intersector']!r}, expected "
                             f"{strategy!r}")
    return r


def phase_dispatch_paths(dev, smi, report, profile: str | None = None):
    """The dispatch intersectors through the ``Renderer``."""
    large, _ = tessellated_box(LARGE_TESSELLATION)
    r = forced_renderer("pairs", large, "pairs")
    hdr, secs = counted_render(
        r, LARGE_SPP, report, "pairs",
        expect(k2=MAX_BOUNCES * LARGE_SPP, k4=2 * MAX_BOUNCES * LARGE_SPP,
               block_entry=2 * MAX_BOUNCES * LARGE_SPP))
    for key in ("k4", "block_entry"):
        report[key]["launches"] = report[key]["launches_by_path"]["pairs"]
    stats = r.stats()
    rays = stats["rays_total"]
    say("pairs", f"cold render: wall {secs:.3f} s, {rays} rays "
        f"({stats['rays_closest']} closest + {stats['rays_shadow']} shadow), "
        f"{rays / secs / 1e6:.3f} Mrays/s on {smi}")
    med, quartiles, walls = repeat_renders(r, LARGE_SPP, rays, "pairs", smi)
    r.reset()
    one = r.render(spp=LARGE_PLAIN_SPP)
    plain_secs = checked_plain(r, LARGE_PLAIN_SPP, one, "pairs")
    if profile:
        root, ext = os.path.splitext(profile)
        profile_frames(r, f"{root}_pairs{ext}", "pairs")
    report["pairs"] = {"triangles": large.num_triangles, "seconds": secs,
                       "mrays_per_sec": rays / secs / 1e6,
                       "repeat_median_seconds": med,
                       "repeat_quartile_seconds": quartiles,
                       "repeat_seconds": walls, "plain_seconds": plain_secs}

    # The fallback: the same box without walk tables under "auto".
    def too_deep(*args, **kwargs):
        raise bvh8.WideBVHDepthError("pathologically deep (simulated)")

    build, bvh8.build_wide_bvh = bvh8.build_wide_bvh, too_deep
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            f = forced_renderer("auto", large, "pairs")
    finally:
        bvh8.build_wide_bvh = build
    fallback, _ = counted_render(
        f, LARGE_PLAIN_SPP, report, "pairs_fallback",
        expect(k2=MAX_BOUNCES * LARGE_PLAIN_SPP,
               k4=2 * MAX_BOUNCES * LARGE_PLAIN_SPP,
               block_entry=2 * MAX_BOUNCES * LARGE_PLAIN_SPP))
    pixels = pixels_differing(fallback, one)
    say("pairs", "the same box without walk tables under intersector='auto' "
        f"took {f.stats()['intersector']!r}; its image differs from the "
        f"forced run's on {pixels} of {SIZE * SIZE} pixels")
    if pixels:
        raise AssertionError("the fallback's image differs from the forced "
                             "pair dispatch's")
    report["pairs"]["fallback_pixels_differing"] = pixels

    mid, _ = tessellated_box(PHASED_TESSELLATION)
    for kind, key, scene_np in (("phased", "k5", mid), ("cluster", "k6",
                                                        large)):
        r = forced_renderer(kind, scene_np, kind)
        calls = 2 * MAX_BOUNCES * DISPATCH_SPP
        _, secs = counted_render(
            r, DISPATCH_SPP, report, kind,
            expect(k2=MAX_BOUNCES * DISPATCH_SPP, **{key: calls},
                   block_entry=calls if kind == "cluster" else 0))
        report[key]["launches"] = report[key]["launches_by_path"][kind]
        rays = r.stats()["rays_total"]
        say(kind, f"{scene_np.num_triangles} triangles, cold render: wall "
            f"{secs:.3f} s, {rays} rays, {rays / secs / 1e6:.3f} Mrays/s on "
            f"{smi}")
        r.reset()
        one = r.render(spp=DISPATCH_PLAIN_SPP)
        plain_secs = checked_plain(r, DISPATCH_PLAIN_SPP, one, kind)
        report[kind] = {"triangles": scene_np.num_triangles, "seconds": secs,
                        "mrays_per_sec": rays / secs / 1e6,
                        "plain_seconds": plain_secs}


# The JAX package's bench config 7 (bench.py:381-431): the tessellated box
# at 765,002, 2,007,668 and 4,046,852 triangles, each route as (label,
# tessellation, intersector, the strategy it must report, image size, spp,
# frames_per_chunk, frames_per_trace).
BIG_ROUTES = (
    ("765k", 150, "auto", "walk", 128, 8, 8, 8),
    ("2M", 243, "auto", "walk", 128, 8, 8, 8),
    ("2M_pairs", 243, "pairs", "pairs", 128, 2, 2, 2),
    ("4M_pairs", 345, "pairs", "pairs", 64, 1, 1, 1),
    ("4M", 345, "auto", "walk", 64, 1, 1, 1),
)
BIG_REPEATS = 3
# The whole-image check of the walk routes at 765k and 2M: 64x64, 1 spp,
# 1 bounce (the camera and shadow-0 calls: the plain walk takes 5-10 s a
# call of bounce rays there, which the subsets hold instead).
BIG_PLAIN_TESSELLATIONS = (150, 243)
BIG_PLAIN_SIZE = 64
BIG_PLAIN_BOUNCES = 1
BIG_RAYS = SIZE  # the kernels' timed calls: 512 x 512 camera rays
BIG_SUBSET_BLOCKS = 16  # of 1,024 lanes, evenly spaced: 16,384 rays
BIG_TIME_REPS = 3


def big_subset(n: int, dev) -> torch.Tensor:
    """BIG_SUBSET_BLOCKS whole blocks of 1,024 lanes (K4's ray block),
    evenly spaced over ``n`` lanes: the rays each kernel is held to its
    plain version on, whose plain visit counts scale to the full call."""
    step = n // (BIG_SUBSET_BLOCKS * K4.BN)
    starts = torch.arange(BIG_SUBSET_BLOCKS, device=dev) * step * K4.BN
    return (starts[:, None] + torch.arange(K4.BN, device=dev)).reshape(-1)


def scaled(visits: dict, factor: float) -> dict:
    return {k: v * factor for k, v in visits.items()}


def big_kernels(label: str, r: Renderer, keys: set, report: dict) -> dict:
    """K2 and the kernels ``keys`` names ("k3", "k4") on the 512x512 camera
    rays of ``r``'s scene, their bounce-1 rays (K2 on the camera hits) and
    that bounce's shadow rays: each on a 16,384-ray subset
    (``big_subset``) against its plain version, bit for bit (K2 under the
    phase-4 bound), and K3's and K4's device ms a call (a CUDA graph)
    beside the bound from the plain version's visits on the subset, scaled
    to the call (K4's distinct super tiles capped at the table's). K3 takes
    the rays as they are, K4 its bounce-1 and shadow-0 rays as the main
    path's pair route hands them (``route_lanes``: sorted, on a compaction
    tier)."""
    scene = r._scene_dev
    nt = scene["tri_isect"].shape[0]
    camera = Camera(width=BIG_RAYS, height=BIG_RAYS, aspect=1.0)
    cam = camera_device(camera.as_pytree(), BIG_RAYS, BIG_RAYS)
    x, y = tile_pixels(BIG_RAYS, BIG_RAYS, r.device)
    ro, rd, state = generate_rays(cam, x, y, 0,
                                  use_dof=float(camera.aperture) > 0.0)
    rays = torch.cat([ro, rd]).contiguous()
    n = rays.shape[1]
    kinds = {}
    if "k3" in keys:
        kinds["k3"] = (K3.walk_tables(scene), K3.closest_hit_walk,
                       K3.closest_hit_walk_plain)
    if "k4" in keys:
        kinds["k4"] = (K4.pair_tables(scene), K4.closest_hit_pairs,
                       K4.closest_hit_pairs_plain)
    tables, kernel, _ = next(iter(kinds.values()))
    t, idx = kernel(tables, rays[0:3], rays[3:6], num_tris=nt)
    # K2 on the camera hits: the bounce-1 and shadow-0 rays of the whole
    # call, and its subset against the plain version.
    sub = big_subset(n, r.device)
    ones = torch.ones((3, n), device=r.device)
    args = (0, rays, state, ones, torch.zeros_like(ones),
            torch.ones((n,), dtype=torch.bool, device=r.device), t, idx,
            scene["tri_full"], scene["light_full"])
    kw = dict(do_mis=True, num_lights=r.scene.num_lights)
    kout = K2.bounce_stage_cuda(*args, **kw)
    sub_args = tuple(a[..., sub] if torch.is_tensor(a) and a.shape[-1] == n
                     else a for a in args)
    summary = check_k2(tuple(o[..., sub] for o in kout),
                       K2.bounce_stage_plain(*sub_args, **kw), sub.numel(),
                       f"the {label} box", report.setdefault("k2", {}))
    say("big", f"{label}: K2 at bounce 0 on {sub.numel()} of {n} camera "
        f"hits against its plain version: {summary}")
    sets = [("camera", rays, {}),
            ("bounce-1", kout[0], {"active": kout[4]}),
            ("shadow-0", kout[5], {"active": kout[7], "t_max": kout[6],
                                   "any_hit": True})]
    out = {}
    for key, (tables, kernel, plain) in kinds.items():
        for name, rr, extra in sets:
            o, d = rr[0:3].contiguous(), rr[3:6].contiguous()
            if key == "k4" and name != "camera":
                o, d, extra = route_lanes(scene, o, d, extra)
            m = o.shape[1]
            sub = big_subset(m, r.device)
            sub_extra = {k: (v[sub] if torch.is_tensor(v) else v)
                         for k, v in extra.items()}
            so, sd = o[:, sub].contiguous(), d[:, sub].contiguous()
            visits = {}
            t0 = time.perf_counter()
            want = plain(tables, so, sd, num_tris=nt, visits=visits,
                         **sub_extra)
            plain_secs = time.perf_counter() - t0
            same_hits(kernel(tables, so, sd, num_tris=nt, **sub_extra), want,
                      f"{key.upper()} on the {label} box's {name} subset")
            ms = device_ms(lambda: kernel(tables, o, d, num_tris=nt, **extra),
                           reps=BIG_TIME_REPS)
            full = scaled(visits, m / sub.numel())
            if key == "k3":
                b, ops = walk_bound(full, tables, m)
            else:
                full["tiles"] = min(full["tiles"], tables.super_aabb.shape[0])
                b, ops = dispatch_bound("pairs", full, scene, tables, m)
            entry = out.setdefault(key, {})[name] = {
                "rays": m, "ms": ms, "gops": ops / 1e9, **b,
                "plain_seconds_subset": plain_secs,
                "hits_subset": int((want[1] >= 0).sum()),
                "visits_per_ray": {v: c / sub.numel()
                                   for v, c in visits.items()}}
            say("big", f"{label}: {key.upper()} on {sub.numel()} of the {m} "
                f"{name} rays equals its plain version on every lane "
                f"({entry['hits_subset']} hits; plain {plain_secs:.2f} s); "
                f"device {ms:.4f} ms a call of {m}, bound "
                f"{entry['bound_ms']:.4f} ms ({entry['bound_by']}, "
                f"{entry['gops']:.2f} Gop)")
    return out


def phase_big(dev, smi, report):
    """The JAX package's large scenes (``BIG_ROUTES``) through the
    ``Renderer``: each route's strategy, set-up seconds (the scene with its
    C++ SAH build, then ``load_scene``: wide collapse, packing, upload),
    peak device memory, launches, a warm-up and the median of BIG_REPEATS
    renders in Mrays/s; at each size the kernels of its routes against
    their plain versions (``big_kernels``); at 765k and 2M the walk route's
    64x64, 1-spp, 1-bounce image against the plain path's."""
    out = report.setdefault("big", {})
    checked, built = set(), {}
    for (label, tess, intersector, strategy, size, spp, fpc,
         fpt) in BIG_ROUTES:
        if tess not in built:  # each box built once, for its routes
            built.clear()
            t0 = time.perf_counter()
            built[tess] = cornell_box(tessellation=tess)
            scene_s = time.perf_counter() - t0
        scene_np = built[tess]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        r = Renderer(RenderConfig(width=size, height=size,
                                  frames_per_chunk=fpc, frames_per_trace=fpt,
                                  intersector=intersector), device="cuda")
        _, load_s = timed(lambda: r.load_scene(scene_np))
        got = r.stats()["intersector"]
        say("big", f"{label}: {scene_np.num_triangles} triangles; "
            f"cornell_box (mesh and C++ SAH build) {scene_s:.2f} s, "
            f"load_scene (wide collapse, packing, upload) {load_s:.2f} s; "
            f"intersector={intersector!r} took {got!r}")
        if got != strategy:
            raise AssertionError(f"{label}: expected {strategy!r}")
        calls = spp // fpt
        kernel = {"walk": {"k3": 2 * MAX_BOUNCES * calls},
                  "pairs": {"k4": 2 * MAX_BOUNCES * calls,
                            "block_entry": 2 * MAX_BOUNCES * calls}}[got]
        _, secs = counted_render(r, spp, report, f"big_{label}",
                                 expect(k2=MAX_BOUNCES * calls, **kernel))
        rays = r.stats()["rays_total"]
        med, quartiles, walls = repeat_renders(r, spp, rays, f"big_{label}",
                                               smi, repeats=BIG_REPEATS)
        peak = torch.cuda.max_memory_allocated()
        say("big", f"{label}: warm-up {secs:.3f} s; {rays} rays a render, "
            f"{rays / med / 1e6:.4f} Mrays/s at the median; peak device "
            f"memory {peak / 2**30:.3f} GiB on {smi}")
        out[label] = {"triangles": scene_np.num_triangles, "intersector": got,
                      "size": size, "spp": spp, "frames_per_trace": fpt,
                      "scene_seconds": scene_s, "load_scene_seconds": load_s,
                      "warmup_seconds": secs, "rays": rays,
                      "repeat_seconds": walls, "repeat_median_seconds": med,
                      "mrays_per_sec": rays / med / 1e6,
                      "peak_device_bytes": peak}
        if tess not in checked:  # the kernels of every route at this size
            checked.add(tess)
            keys = {{"walk": "k3", "pairs": "k4"}[route[3]]
                    for route in BIG_ROUTES if route[1] == tess}
            out[label]["kernels"] = kernels = big_kernels(label, r, keys,
                                                          report)
            for key, sets in kernels.items():
                report.setdefault(key, {}).setdefault("big", {})[label] = {
                    name: {k: e[k] for k in ("rays", "ms", "bound_ms",
                                             "bound_by")}
                    for name, e in sets.items()}
        if tess in BIG_PLAIN_TESSELLATIONS and got == "walk":
            # The whole image at BIG_PLAIN_SIZE, 1 spp and BIG_PLAIN_BOUNCES
            # bounces: the plain walk syncs the host once a stack pop.
            r.resize(BIG_PLAIN_SIZE, BIG_PLAIN_SIZE)
            r.config.max_bounces = BIG_PLAIN_BOUNCES
            hdr = r.render(spp=1)
            out[label]["plain_seconds"] = checked_plain(
                r, 1, hdr, f"big_{label}", repack=False)
        del r
    torch.cuda.empty_cache()


def phase_large(dev, smi, report, profile: str | None):
    scene_np, sah = tessellated_box(LARGE_TESSELLATION)
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
        expect(k2=MAX_BOUNCES * LARGE_SPP, k3=2 * MAX_BOUNCES * LARGE_SPP))
    report["k3"]["launches"] = report["k3"]["launches_by_path"]["large"]
    stats = r.stats()
    rays = stats["rays_total"]
    say("large", f"cold render: wall {secs:.3f} s, {rays} rays "
        f"({stats['rays_closest']} closest + {stats['rays_shadow']} "
        f"shadow), {rays / secs / 1e6:.3f} Mrays/s on {smi}")
    med, quartiles, walls = repeat_renders(r, LARGE_SPP, rays, "large", smi)
    # The plain walk syncs the host once per stack pop (about 30 s a frame
    # here), so the image comparison takes the first LARGE_PLAIN_SPP frame.
    r.reset()
    hdr = r.render(spp=LARGE_PLAIN_SPP)
    plain_secs = checked_plain(r, LARGE_PLAIN_SPP, hdr, "large")
    if profile:
        root, ext = os.path.splitext(profile)
        profile_frames(r, f"{root}_large{ext}", "large")
    report["large"] = {"triangles": scene_np.num_triangles,
                       "sah_seconds": sah, "build_seconds": build,
                       "seconds": secs,
                       "mrays_per_sec": rays / secs / 1e6,
                       "repeat_median_seconds": med,
                       "repeat_quartile_seconds": quartiles,
                       "repeat_seconds": walls,
                       "plain_seconds": plain_secs}


def lds_case(scene_np, dev, drop_fat: bool = False, frame: int = 0):
    """Bounce 0 of the stratified flagship camera at ``frame`` on
    ``scene_np``: K2's arguments (hits from the plain dense hit), keywords
    and the LDS rows. ``drop_fat`` samples a textured scene per slot."""
    scene = scene_of(scene_np, dev, drop_fat)
    camera = Camera(width=SIZE, height=SIZE, aspect=1.0)
    cam = camera_device(camera.as_pytree(), SIZE, SIZE)
    x, y = tile_pixels(SIZE, SIZE, dev)
    ro, rd, state = generate_rays(cam, x, y, frame,
                                  use_dof=float(camera.aperture) > 0.0,
                                  rng_mode="stratified")
    rays = torch.cat([ro, rd]).contiguous()
    n = rays.shape[1]
    t, idx = K1.closest_hit_dense_plain(scene["tri_isect"], rays)
    args = (0, rays, state, torch.ones((3, n), device=dev),
            torch.zeros((3, n), device=dev),
            torch.ones((n,), dtype=torch.bool, device=dev), t, idx,
            scene["tri_full"], scene["light_full"])
    atlas, slots = TRACE.scene_atlas(scene)
    kw = dict(do_mis=True, num_lights=scene_np.num_lights, atlas=atlas,
              slots_used=slots)
    return args, kw, bounce0_lds(x, y, frame)


def phase_k2_lds(dev, report):
    """K2's LDS instantiation against its plain version (the phase-4 bound)
    on the Cornell box, the material box, and the textured box and the
    textured material box each sampled per slot and from its fat canvas;
    how many lanes the override moves; its time beside the launch without
    LDS on the same inputs, on each."""
    key = report.setdefault("k2_lds", {})
    timed = None
    for label, scene_np, drop_fat in (
            ("cornell_box", cornell_box(), False),
            ("material_test_box", material_test_box(), False),
            ("textured_cornell", textured_cornell(), True),
            ("textured_cornell", textured_cornell(), False),
            ("textured_material_box", textured_material_box(), True),
            ("textured_material_box", textured_material_box(), False)):
        args, kw, lds = lds_case(scene_np, dev, drop_fat)
        n = args[1].shape[1]
        before = K2.Counter.lds
        kout = K2.bounce_stage_cuda(*args, **kw, lds=lds)
        torch.cuda.synchronize()
        if K2.Counter.lds != before + 1:
            raise AssertionError("bounce 0 with lds did not launch the LDS "
                                 "instantiation")
        pout = K2.bounce_stage_plain(*args, **kw, lds=lds)
        summary = check_k2(kout, pout, n, f"{label} with LDS", key)
        without = K2.bounce_stage_cuda(*args, **kw)
        moved = int((kout[0] != without[0]).any(0).sum())
        states = int((kout[1] != without[1]).sum())
        mode = K2.texture_mode(kw["atlas"])
        say("k2_lds", f"{label} ({mode}) bounce 0, rng 'stratified': {n} "
            f"lanes; against the plain version: {summary}; the override "
            f"moves the next ray on {moved} lanes, the state on {states} "
            "(the Fresnel draw follows the lobe)")
        if not moved:
            raise AssertionError(f"{label}: the LDS override did not engage")
        lds_ms = device_ms(lambda: K2.bounce_stage_cuda(*args, **kw, lds=lds))
        bare_ms = device_ms(lambda: K2.bounce_stage_cuda(*args, **kw))
        say("k2_lds", f"{label} ({mode}): device {lds_ms:.4f} ms with LDS, "
            f"{bare_ms:.4f} ms without")
        key.setdefault("ms_by_scene", {})[f"{label} ({mode})"] = {
            "lds": lds_ms, "no_lds": bare_ms}
        timed = timed or (args, kw, lds, kout)
    args, kw, lds, kout = timed
    (ms, plain_ms), (eager, plain_eager) = time_pair(
        lambda: K2.bounce_stage_cuda(*args, **kw, lds=lds),
        lambda: K2.bounce_stage_plain(*args, **kw, lds=lds))
    no_lds_ms = device_ms(lambda: K2.bounce_stage_cuda(*args, **kw))
    b = bound(nbytes(*args[1:], lds, *kout), K2_OPS["none"] * args[1].shape[1])
    say("k2_lds", f"time at cornell_box bounce 0, {args[1].shape[1]} rays: "
        f"device {ms:.4f} ms (without LDS {no_lds_ms:.4f} ms; plain "
        f"{plain_ms:.4f} ms); launched from Python {eager:.4f} ms (plain "
        f"{plain_eager:.4f} ms); bound {b['bound_ms']:.4f} ms "
        f"({b['bound_by']})")
    key.update(ms=ms, plain_ms=plain_ms, no_lds_ms=no_lds_ms, **b)


def same_image(a: np.ndarray, b: np.ndarray, what: str,
               phase: str = "rng") -> int:
    """Raises unless ``a`` and ``b`` are equal on every pixel."""
    pixels = pixels_differing(a, b)
    say(phase, f"{what}: differs on {pixels} of {a.shape[0] * a.shape[1]} "
        "pixels")
    if pixels:
        raise AssertionError(f"{what}: the images differ")
    return pixels


def rng_renderer(rng: str, scene_np, **config) -> Renderer:
    r = Renderer(RenderConfig(width=SIZE, height=SIZE, rng=rng, **config),
                 device="cuda")
    r.load_scene(scene_np)
    return r


def phase_rng_paths(dev, smi, report, profile: str | None):
    """The rng modes through the ``Renderer``: the stratified flagship (K2's
    LDS instantiation once a frame), "hash", frames_per_trace and a
    checkpoint."""
    r = rng_renderer("stratified", cornell_box())
    hdr, secs = counted_render(
        r, SPP, report, "stratified",
        expect(k1=2 * MAX_BOUNCES * SPP, k2=MAX_BOUNCES * SPP, k2_lds=SPP))
    report["k2_lds"]["launches"] = report["k2_lds"]["launches_by_path"][
        "stratified"]
    rays = r.stats()["rays_total"]
    say("stratified", f"cold render: wall {secs:.3f} s, {rays} rays, "
        f"{rays / secs / 1e6:.3f} Mrays/s on {smi}")
    plain_secs = checked_plain(r, SPP, hdr, "stratified")
    med, quartiles, walls = repeat_renders(r, SPP, rays, "stratified", smi)
    report["stratified"] = {"seconds": secs, "mrays_per_sec": rays / secs / 1e6,
                            "repeat_median_seconds": med,
                            "repeat_quartile_seconds": quartiles,
                            "repeat_seconds": walls,
                            "plain_seconds": plain_secs,
                            "mean_hdr": float(hdr.mean())}
    if profile:
        root, ext = os.path.splitext(profile)
        profile_frames(r, f"{root}_stratified{ext}", "stratified")

    h = rng_renderer("hash", cornell_box())
    hash_hdr, hash_secs = counted_render(
        h, HASH_SPP, report, "hash",
        expect(k1=2 * MAX_BOUNCES * HASH_SPP, k2=MAX_BOUNCES * HASH_SPP))
    hash_rays = h.stats()["rays_total"]
    say("hash", f"cold render: wall {hash_secs:.3f} s, {hash_rays} rays, "
        f"{hash_rays / hash_secs / 1e6:.3f} Mrays/s on {smi}")
    report["hash"] = {"seconds": hash_secs,
                      "mrays_per_sec": hash_rays / hash_secs / 1e6,
                      "plain_seconds": checked_plain(h, HASH_SPP, hash_hdr,
                                                     "hash")}

    # frames_per_trace: F frames' rays in one trace call, the same image.
    r.reset()
    one = r.render(spp=FPT_SPP)
    f2 = rng_renderer("stratified", cornell_box(), frames_per_trace=2)
    two, _ = counted_render(
        f2, FPT_SPP, report, "stratified_f2",
        expect(k1=MAX_BOUNCES * FPT_SPP, k2=MAX_BOUNCES * FPT_SPP // 2,
               k2_lds=FPT_SPP // 2))
    fpt = {"flagship_pixels_differing": same_image(
        one, two, f"the stratified flagship at frames_per_trace 2 against 1 "
        f"({FPT_SPP} spp)")}
    large, _ = tessellated_box(LARGE_TESSELLATION)
    l1 = rng_renderer("reference", large)
    one = l1.render(spp=FPT_LARGE_SPP)
    del l1
    l2 = rng_renderer("reference", large, frames_per_trace=2)
    if l2.stats()["intersector"] != "walk":
        raise AssertionError("the large box must take the walk (K3)")
    two, _ = counted_render(
        l2, FPT_LARGE_SPP, report, "large_f2",
        expect(k2=MAX_BOUNCES * FPT_LARGE_SPP // 2,
               k3=MAX_BOUNCES * FPT_LARGE_SPP))
    fpt["large_pixels_differing"] = same_image(
        one, two, f"the large box through K3 at frames_per_trace 2 against 1 "
        f"({FPT_LARGE_SPP} spp)")
    report["frames_per_trace"] = fpt

    # A checkpoint: CKPT_SPP frames, saved, loaded into a fresh Renderer,
    # CKPT_SPP more, against 2 * CKPT_SPP frames in one go.
    c = rng_renderer("stratified", cornell_box())
    c.render(spp=CKPT_SPP)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "run.npz")
        c.save_checkpoint(path)
        d = rng_renderer("stratified", cornell_box())
        d.load_checkpoint(path)
    resumed = d.render(spp=CKPT_SPP)
    r.reset()
    straight = r.render(spp=2 * CKPT_SPP)
    report["checkpoint"] = {"frame_index": d.frame_index,
                            "pixels_differing": same_image(
        resumed, straight, f"a stratified render resumed from a checkpoint "
        f"at {CKPT_SPP} spp against {2 * CKPT_SPP} spp in one go")}


# --- scene loading and the environment map ---------------------------------


def env_map() -> np.ndarray:
    """A numpy-made (64, 128, 3) equirect map: a sky gradient over a dark
    ground, with seeded noise so that neighbouring texels differ."""
    h, w = ENV_SHAPE
    rng = np.random.default_rng(11)
    v = (np.arange(h, dtype=np.float32)[:, None] + 0.5) / h
    sky = np.stack([0.3 + 0.5 * v, 0.5 + 0.3 * v, 1.2 - 0.6 * v], -1)
    ground = np.array([0.12, 0.08, 0.05], np.float32)
    env = np.where(v[..., None] < 0.5, sky, ground) * np.ones((h, w, 1))
    env = env + 0.2 * rng.random((h, w, 3))
    return np.ascontiguousarray(env, np.float32)


def with_env(scene: dict, dev):
    """Install ``env_map()`` in a scene dict; returns K2's ``env``
    operand (map, params)."""
    scene.update(ENV.env_tables(env_map(), ENV_INTENSITY, ENV_ROTATION, dev))
    return ENV.scene_env(scene)


JPEG_DIR = os.path.join(REPO, "tests", "jpeg")
# The JPEG-textured scene: textured_cornell(tessellation=12), 4,898
# triangles (the walk), its images replaced by the committed progressive,
# CMYK and YCCK JPEGs, at the flagship's width.
JPEG_TESSELLATION = 12
JPEG_SIZE = SIZE
JPEG_SPP = 8
# The largest file's decode on the card's host must stay within this.
JPEG_DECODE_BOUND_S = 5.0
# Timed through the plain Python entropy decoder too: the Huffman files at
# 2048^2, the arithmetic-coded and lossless ones at 1024^2 (a binary
# decision a step in Python).
JPEG_PYTHON_TIMED = ("timing_2048.jpg", "timing_progressive_2048.jpg",
                     "timing_arith_1024.jpg",
                     "timing_arith_progressive_1024.jpg",
                     "timing_lossless_1024.jpg")
JPEG_TEXTURES = ("albedo_progressive_420.jpg", "pbr_cmyk_progressive.jpg",
                 "normal_cmyk_restart.jpg", "emissive_ycck_420.jpg",
                 "roughness_ycck_progressive.jpg")
# The second JPEG-textured box: arithmetic-coded (SOF9 with a DAC segment
# and restarts, SOF10 block-smoothed) and lossless (SOF3 RGB and gray)
# textures.
JPEG_TEXTURES_ARITH = ("albedo_arith_restart.jpg",
                       "pbr_arith_progressive_smoothed.jpg",
                       "normal_lossless_rgb.jpg",
                       "roughness_lossless_gray.jpg")
# The env box under committed progressive JPEG maps (Huffman- and
# arithmetic-coded), read through RenderConfig.env_map.
JPEG_ENV = "env_progressive.jpg"
JPEG_ENV_ARITH = "env_arith_progressive.jpg"
JPEG_ENV_SPP = 8


def jpeg_cases() -> list:
    """(name, bytes, Pillow's RGBA) of each small JPEG under ``tests/jpeg``,
    whose Pillow decode ``pillow_rgba.npz`` holds."""
    want = np.load(os.path.join(JPEG_DIR, "pillow_rgba.npz"))
    out = []
    for name in sorted(want.files):
        with open(os.path.join(JPEG_DIR, name), "rb") as f:
            out.append((name, f.read(), want[name]))
    return out


def with_jpeg_images(glb: bytes, jpegs: list) -> str:
    """The .gltf text of the .glb ``glb`` with its buffer as a data URI and
    image i's bytes replaced by ``jpegs[i % len(jpegs)]`` (a data URI with
    no ``mimeType``: the loaders sniff the bytes)."""
    def uri(mime: str, data: bytes) -> str:
        return f"data:{mime};base64," + base64.b64encode(data).decode()

    gf = GLTFFile._parse_glb(glb, "")
    gltf = dict(gf.gltf)
    gltf["buffers"] = [{"byteLength": len(gf.buffers[0]),
                        "uri": uri("application/octet-stream",
                                   gf.buffers[0])}]
    gltf["images"] = [{"uri": uri("image/jpeg", jpegs[i % len(jpegs)])}
                      for i in range(len(gltf.get("images", [])))]
    return json.dumps(gltf)


def timed(fn):
    """(fn(), its wall seconds to a device sync)."""
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def same_arrays(a, b, what: str) -> None:
    """Raises unless two ``SceneArrays`` hold equal arrays."""
    diff = [f.name for f in dataclasses.fields(a)
            if not np.array_equal(np.asarray(getattr(a, f.name)),
                                  np.asarray(getattr(b, f.name)))]
    if diff:
        raise AssertionError(f"{what}: arrays differ: {diff}")


def phase_gltf(dev, smi, report, profile: str | None):
    """The atrium (``gallery_atrium(detail=3)``, about 116k triangles, 12
    materials, 7 texture map sets) written to a .glb by ``scene_to_glb`` and
    rendered through ``Renderer.load_model``: the load's parts, the walk
    (K3) and K2 in the direct scene's texture mode, the arrays against a
    second round trip, a 1-spp image against the plain path's, then
    ``load_model_async`` staged into a render of ``cornell_box()``."""
    atrium, build = timed(lambda: gallery_atrium(detail=GLTF_DETAIL))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "atrium.glb")
        data, export = timed(lambda: scene_to_glb(atrium))
        with open(path, "wb") as f:
            f.write(data)
        say("gltf", f"gallery_atrium(detail={GLTF_DETAIL}): "
            f"{atrium.num_triangles} triangles, {atrium.num_materials} "
            f"materials, {atrium.num_lights} lights, built in {build:.3f} s; "
            f"scene_to_glb {len(data)} bytes in {export:.3f} s")
        # The load's parts, each alone: parse, atlas, the whole load_model
        # (parse, atlas, flatten, SAH build), the SAH build alone, pack and
        # upload.
        gf, parse = timed(lambda: GLTFFile.load(path))
        (atlas, _), atlas_s = timed(lambda: build_atlas(gf))
        loaded, model_s = timed(lambda: load_model(path))
        _, sah = timed(lambda: native.build_bvh(
            loaded.tri_v0, loaded.tri_v1, loaded.tri_v2))
        packed, pack = timed(lambda: pack_device_scene(loaded))
        _, upload = timed(lambda: load_jax_scene(packed, dev))
        r = Renderer(RenderConfig(width=SIZE, height=SIZE), device="cuda")
        _, load = timed(lambda: r.load_model(path))
        loads = {"parse": parse, "atlas": atlas_s, "load_model": model_s,
                 "sah_build": sah, "pack": pack, "upload": upload,
                 "renderer_load_model": load}
        say("gltf", "load seconds: " + ", ".join(
            f"{k} {v:.3f}" for k, v in loads.items())
            + f" (atlas {tuple(atlas.shape)})")
        direct = Renderer(RenderConfig(width=SIZE, height=SIZE),
                          device="cuda")
        direct.load_scene(atrium)
        stats, want = r.stats(), direct.stats()["texture"]
        del direct
        say("gltf", f"intersector {stats['intersector']!r}, texture "
            f"{stats['texture']!r} (the direct scene's: {want!r})")
        if stats["intersector"] != "walk" or stats["texture"] != want:
            raise AssertionError("the loaded atrium must take the walk (K3) "
                                 "and the direct scene's texture mode")
        # A second round trip of the atrium, written and read anew.
        again = os.path.join(tmp, "again.glb")
        with open(again, "wb") as f:
            f.write(scene_to_glb(atrium))
        same_arrays(r.scene, load_model(again), "a second round trip")
        say("gltf", "the loaded arrays equal a second round trip's")

        mode = {"none": "k2", "per_slot": "k2_per_slot", "fat": "k2_fat"}[
            want]
        hdr, secs = counted_render(
            r, GLTF_SPP, report, "gltf",
            expect(k3=2 * MAX_BOUNCES * GLTF_SPP,
                   **{mode: MAX_BOUNCES * GLTF_SPP}))
        rays = r.stats()["rays_total"]
        say("gltf", f"cold render: wall {secs:.3f} s, {rays} rays, "
            f"{rays / secs / 1e6:.3f} Mrays/s on {smi}")
        med, quartiles, walls = repeat_renders(r, GLTF_SPP, rays, "gltf", smi)
        r.reset()
        one = r.render(spp=GLTF_PLAIN_SPP)
        plain_secs = checked_plain(r, GLTF_PLAIN_SPP, one, "gltf")
        say("gltf", f"mean display value {float(r.image().mean()):.4f}")
        if profile:
            root, ext = os.path.splitext(profile)
            profile_frames(r, f"{root}_gltf{ext}", "gltf")
        stats = r.stats()
        say("gltf", f"passes {json.dumps(stats['passes'])}; frames "
            f"{json.dumps(stats['frames'])}")
        report["gltf"] = {
            "triangles": atrium.num_triangles, "glb_bytes": len(data),
            "texture": want, "load_seconds": loads, "seconds": secs,
            "mrays_per_sec": rays / secs / 1e6,
            "repeat_median_seconds": med,
            "repeat_quartile_seconds": quartiles, "repeat_seconds": walls,
            "plain_seconds": plain_secs, "passes": stats["passes"],
            "frames": stats["frames"], "mean_hdr": float(hdr.mean())}

        # load_model_async while the Cornell box renders: the first chunk's
        # callback lets the load start and waits for it, so the staged scene
        # is installed at the next chunk boundary, and the mean restarts
        # there.
        a = Renderer(RenderConfig(width=SIZE, height=SIZE,
                                  frames_per_chunk=ASYNC_CHUNK),
                     device="cuda")
        a.load_scene(cornell_box())
        # The worker reads the file once the first chunk is done, so the
        # scene is staged between the first and the second chunk.
        first_chunk = threading.Event()
        read_model = a._read_model

        def gated_read(p):
            if not first_chunk.wait(timeout=600):
                raise TimeoutError("the first chunk never finished")
            return read_model(p)

        a._read_model = gated_read
        future = a.load_model_async(path)
        seen = []

        def on_chunk(frame):
            seen.append((frame, a.scene.num_triangles))
            if len(seen) == 1:
                first_chunk.set()
                future.result()

        hdr_async = a.render(spp=3 * ASYNC_CHUNK, on_chunk=on_chunk)
        say("gltf", f"load_model_async during a render of 3 chunks: (frame "
            f"index, triangles) after each chunk {seen}")
        if (seen[0][1] != 36 or seen[1] != (ASYNC_CHUNK, atrium.num_triangles)
                or a.frame_index != 2 * ASYNC_CHUNK):
            raise AssertionError("the staged scene was not installed at the "
                                 "chunk boundary with the mean restarted")
        r.reset()
        same_image(hdr_async, r.render(spp=2 * ASYNC_CHUNK),
                   "the async-installed atrium's 2 chunks against a fresh "
                   "render of the same frames", "gltf")
        bad = a.load_model_async(os.path.join(tmp, "missing.glb"))
        if not isinstance(bad.exception(), FileNotFoundError):
            raise AssertionError("a failed async load must raise from its "
                                 "future")
        try:
            a.render(spp=1)
        except RuntimeError as exc:
            say("gltf", f"a failed async load raises from its future and at "
                f"the next render: {exc}")
        else:
            raise AssertionError("a failed async load must raise at the next "
                                 "render")
        report["gltf"]["async_chunks"] = seen
        report["gltf"]["jpeg"] = jpeg_scene(tmp, smi, report)


def jpeg_scene(tmp: str, smi: str, report: dict) -> dict:
    """The JPEG reader on this host: every committed small JPEG (sequential,
    progressive, CMYK, YCCK, block-smoothed, arithmetic-coded, lossless)
    against its Pillow decode, array-equal, and the timing files' decode
    seconds (1024^2 and 2048^2 sequential and progressive, Huffman- and
    arithmetic-coded; 1024^2 lossless), each decode's SHA-256 against
    Pillow's; then ``textured_cornell(tessellation=JPEG_TESSELLATION)``
    through ``load_model`` of a .gltf at JPEG_SIZE^2, twice: with the
    progressive, CMYK and YCCK JPEGs as its textures, then with the
    arithmetic-coded and lossless ones. Each: K3 and K2 on the fat canvas,
    and a 1-spp image against the plain path's."""
    from wgpu_path_tracing_tpu_torch.utils.jpeg import decode_jpeg_rgba

    cases = jpeg_cases()
    decode_s = {}
    for name, data, want in cases:
        t0 = time.perf_counter()
        got = decode_jpeg_rgba(data, name)
        decode_s[name] = time.perf_counter() - t0
        if not np.array_equal(got, want):
            raise AssertionError(f"{name}: the decode differs from Pillow's")
    say("gltf", f"{len(cases)} committed JPEGs decode array-equal to "
        "Pillow's: " + ", ".join(f"{n} {decode_s[n]:.4f} s"
                                 for n, _, _ in cases) + f" on {smi}")
    with open(os.path.join(JPEG_DIR, "pillow_sha256.json")) as f:
        digests = json.load(f)
    for name, digest in sorted(digests.items()):
        with open(os.path.join(JPEG_DIR, name), "rb") as f:
            data = f.read()
        t0 = time.perf_counter()
        rgba = decode_jpeg_rgba(data, name)
        decode_s[name] = time.perf_counter() - t0
        if hashlib.sha256(rgba.tobytes()).hexdigest() != digest:
            raise AssertionError(f"{name}: the decode differs from Pillow's")
        say("gltf", f"{name} ({rgba.shape[1]}x{rgba.shape[0]}, {len(data)} "
            f"bytes): decoded in {decode_s[name]:.3f} s on this host, equal "
            f"to Pillow's decode (SHA-256), on {smi}")
    slow = {n: t for n, t in decode_s.items()
            if n.startswith("timing_") and t > JPEG_DECODE_BOUND_S}
    if slow:
        raise AssertionError(f"decodes over {JPEG_DECODE_BOUND_S} s: {slow}")
    # The plain Python entropy decoder on JPEG_PYTHON_TIMED, for the
    # record: the C++ one runs in front of it because this one comes close
    # to the bound on progressive Huffman files and passes it on
    # arithmetic-coded ones.
    python_s = {}
    for name in JPEG_PYTHON_TIMED:
        with open(os.path.join(JPEG_DIR, name), "rb") as f:
            data = f.read()
        real = native.native_available
        native.native_available = lambda: False
        try:
            t0 = time.perf_counter()
            rgba = decode_jpeg_rgba(data, name)
            python_s[name] = time.perf_counter() - t0
        finally:
            native.native_available = real
        if hashlib.sha256(rgba.tobytes()).hexdigest() != digests[name]:
            raise AssertionError(f"{name}: the Python decode differs from "
                                 "Pillow's")
        say("gltf", f"{name}: the plain Python entropy decoder took "
            f"{python_s[name]:.3f} s on this host (C++ {decode_s[name]:.3f} "
            f"s; bound {JPEG_DECODE_BOUND_S} s), equal to Pillow's, on {smi}")
    textures = {name: data for name, data, _ in cases}
    out = {"decode_seconds": decode_s, "python_decode_seconds": python_s}
    out.update(jpeg_box(tmp, textures, JPEG_TEXTURES, "gltf_jpeg", smi,
                        report))
    out["arith"] = jpeg_box(tmp, textures, JPEG_TEXTURES_ARITH,
                            "gltf_jpeg_arith", smi, report)
    return out


def jpeg_box(tmp: str, textures: dict, names: tuple, path_name: str,
             smi: str, report: dict) -> dict:
    """``textured_cornell(tessellation=JPEG_TESSELLATION)`` with the
    committed JPEGs ``names`` as its textures, through ``load_model`` of a
    .gltf, at JPEG_SIZE^2 x JPEG_SPP: K3 and K2 on the fat canvas counted
    under ``path_name``, and a 1-spp image against the plain path's."""
    path = os.path.join(tmp, f"{path_name}.gltf")
    scene_np = textured_cornell(tessellation=JPEG_TESSELLATION)
    with open(path, "w") as f:
        f.write(with_jpeg_images(scene_to_glb(scene_np),
                                 [textures[n] for n in names]))
    r = Renderer(RenderConfig(width=JPEG_SIZE, height=JPEG_SIZE),
                 device="cuda")
    _, load = timed(lambda: r.load_model(path))
    stats = r.stats()
    say("gltf", f"the JPEG-textured box ({r.scene.num_triangles} triangles, "
        f"textures {', '.join(names)}, atlas "
        f"{tuple(r.scene.atlas.shape)}): load_model {load:.3f} s, "
        f"intersector {stats['intersector']!r}, texture {stats['texture']!r}")
    if stats["intersector"] != "walk" or stats["texture"] != "fat":
        raise AssertionError("the JPEG-textured box must take the walk (K3) "
                             "and the fat canvas")
    _, secs = counted_render(
        r, JPEG_SPP, report, path_name,
        expect(k3=2 * MAX_BOUNCES * JPEG_SPP, k2_fat=MAX_BOUNCES * JPEG_SPP))
    rays = r.stats()["rays_total"]
    say("gltf", f"JPEG-textured box ({path_name}) {JPEG_SIZE}x{JPEG_SIZE} x "
        f"{JPEG_SPP} spp: wall {secs:.3f} s, {rays / secs / 1e6:.3f} Mrays/s "
        f"on {smi}")
    r.reset()
    one = r.render(spp=1)
    plain_secs = checked_plain(r, 1, one, path_name)
    return {"textures": list(names), "load_model_seconds": load,
            "size": JPEG_SIZE, "seconds": secs,
            "mrays_per_sec": rays / secs / 1e6, "plain_seconds": plain_secs}


def jpeg_env_box(smi: str, report: dict, name: str = JPEG_ENV,
                 path_name: str = "env_jpeg") -> dict:
    """The material box at SIZE^2 under the committed JPEG map ``name``
    (``RenderConfig.env_map``, read by ``load_env_image``): K1, K2 and K2's
    ENV instantiation launched as expected (counted under ``path_name``),
    and the image equal to the plain path's on every pixel."""
    path = os.path.join(JPEG_DIR, name)
    env, read_s = timed(lambda: ENV.load_env_image(path))
    r = Renderer(RenderConfig(width=SIZE, height=SIZE, env_map=path,
                              env_intensity=ENV_INTENSITY), device="cuda")
    _, load = timed(lambda: r.load_scene(material_test_box()))
    hdr, secs = counted_render(
        r, JPEG_ENV_SPP, report, path_name,
        expect(k1=2 * MAX_BOUNCES * JPEG_ENV_SPP, k2=MAX_BOUNCES * JPEG_ENV_SPP,
               k2_env=MAX_BOUNCES * JPEG_ENV_SPP))
    rays = r.stats()["rays_total"]
    say("env", f"the material box under {name} (map {env.shape}, read "
        f"in {read_s:.4f} s; load_scene {load:.3f} s) {SIZE}x{SIZE} x "
        f"{JPEG_ENV_SPP} spp: wall {secs:.3f} s, {rays / secs / 1e6:.3f} "
        f"Mrays/s on {smi}")
    plain_secs = checked_plain(r, JPEG_ENV_SPP, hdr, path_name)
    return {"map": name, "read_seconds": read_s,
            "load_scene_seconds": load, "seconds": secs,
            "mrays_per_sec": rays / secs / 1e6, "plain_seconds": plain_secs,
            "mean_hdr": float(hdr.mean())}


def phase_env(dev, smi, report, profile: str | None):
    """K2's ENV instantiation against its plain version at bounces 0..2 on
    the open material box, the textured box in both texture modes, the
    textured material box in both and the lane mix, and with LDS at bounce
    0; K2 without a map on the Cornell box; then the material box at 64 spp
    through ``set_environment``, its image against the plain path's."""
    key = report.setdefault("k2_env", {})
    lane_mix = lambda: lane_mix_box(material_test_box)  # noqa: E731
    cases = (("material_test_box", material_test_box, None, False),
             ("textured_cornell", textured_cornell, None, False),
             ("textured_cornell", textured_cornell, None, True),
             ("textured_material_box", textured_material_box, None, False),
             ("textured_material_box", textured_material_box, None, True),
             ("lane_mix", lane_mix, lane_mix_rays(SIZE * SIZE, 2), False))
    for label, scene_fn, start, drop_fat in cases:
        before = K2.Counter.env
        args, outs, kw, scene = k2_bounces(scene_fn(), label, dev, key, start,
                                           drop_fat=drop_fat, env=True)
        torch.cuda.synchronize()
        if K2.Counter.env != before + 3:
            raise AssertionError("K2 with a map did not launch its ENV "
                                 "instantiation")
        mode = K2.texture_mode(kw["atlas"])
        b = k2_bound(args, outs, mode, kw["atlas"], kw["slots_used"],
                     kw["env"])
        ms = device_ms(lambda: K2.bounce_stage_cuda(*args, **kw))
        key.setdefault("ms_by_scene", {})[f"{label} ({mode})"] = ms
        key.setdefault("bound_ms_by_scene", {})[f"{label} ({mode})"] = (
            b["bound_ms"])
        if label == "material_test_box":
            (ms, plain_ms), (eager, plain_eager) = time_pair(
                lambda: K2.bounce_stage_cuda(*args, **kw),
                lambda: K2.bounce_stage_plain(*args, **kw))
            without = {k: v for k, v in kw.items() if k != "env"}
            no_env_ms = device_ms(
                lambda: K2.bounce_stage_cuda(*args, **without))
            missed, texels = env_misses(args, kw["env"])
            say("env", f"time at material_test_box bounce 0, "
                f"{args[1].shape[1]} rays ({missed} missed, {texels} "
                f"texels read): device {ms:.4f} ms (without the map "
                f"{no_env_ms:.4f} ms; plain {plain_ms:.4f} ms); launched "
                f"from Python {eager:.4f} ms (plain {plain_eager:.4f} ms); "
                f"bound {b['bound_ms']:.4f} ms ({b['bound_by']})")
            key.update(ms=ms, plain_ms=plain_ms, no_env_ms=no_env_ms, **b)
        # Bounce 0 with LDS rows (the stratified camera's, random rows for
        # the lane mix): K2 with both flags.
        n = args[1].shape[1]
        lds = (bounce0_lds(*tile_pixels(SIZE, SIZE, dev), 0) if start is None
               else torch.from_numpy(np.random.default_rng(5).random(
                   (3, n), dtype=np.float32)).to(dev))
        before = K2.Counter.lds
        kout = K2.bounce_stage_cuda(*args, **kw, lds=lds)
        torch.cuda.synchronize()
        if K2.Counter.lds != before + 1:
            raise AssertionError("bounce 0 with lds did not launch the LDS "
                                 "instantiation")
        pout = K2.bounce_stage_plain(*args, **kw, lds=lds)
        say("env", f"{label} ({mode}) bounce 0 with LDS: "
            + check_k2(kout, pout, n, f"{label} with LDS and the map", key))
    # K2 without the map on the Cornell box at bounce 0: the instruction
    # stream scenes without a map run.
    args, outs, kw, _ = k2_bounces(cornell_box(), "cornell_box", dev, {})
    key["cornell_no_env_ms"] = device_ms(
        lambda: K2.bounce_stage_cuda(*args, **kw))
    say("env", f"K2 without a map, cornell_box bounce 0: device "
        f"{key['cornell_no_env_ms']:.4f} ms")

    r = Renderer(RenderConfig(width=SIZE, height=SIZE), device="cuda")
    r.load_scene(material_test_box())
    r.set_environment(env_map(), intensity=ENV_INTENSITY,
                      rotation=ENV_ROTATION)
    hdr, secs = counted_render(
        r, SPP, report, "env",
        expect(k1=2 * MAX_BOUNCES * SPP, k2=MAX_BOUNCES * SPP,
               k2_env=MAX_BOUNCES * SPP))
    key["launches"] = report["k2_env"]["launches_by_path"]["env"]
    rays = r.stats()["rays_total"]
    say("env", f"cold render: wall {secs:.3f} s, {rays} rays, "
        f"{rays / secs / 1e6:.3f} Mrays/s on {smi}")
    plain_secs = checked_plain(r, SPP, hdr, "env")
    med, quartiles, walls = repeat_renders(r, SPP, rays, "env", smi)
    # The same box without the map, in turns with the map's renders, so
    # that the host's speed moves both alike (the map changes no path).
    bare = Renderer(RenderConfig(width=SIZE, height=SIZE), device="cuda")
    bare.load_scene(material_test_box())
    bare.render(spp=SPP)
    turns = {"no_map": [], "map": []}
    for _ in range(REPEATS):
        for key, renderer in (("no_map", bare), ("map", r)):
            renderer.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            renderer.render(spp=SPP, fetch=False)
            turns[key].append(time.perf_counter() - t0)
    medians = {k: float(np.median(v)) for k, v in turns.items()}
    say("env", f"in turns, {REPEATS} renders each: wall median "
        + ", ".join(f"{k} {v:.4f} s ({rays / v / 1e6:.3f} Mrays/s)"
                    for k, v in medians.items()) + f" on {smi}")
    report["env"] = {"seconds": secs, "mrays_per_sec": rays / secs / 1e6,
                     "repeat_median_seconds": med,
                     "repeat_quartile_seconds": quartiles,
                     "repeat_seconds": walls, "plain_seconds": plain_secs,
                     "turns_seconds": turns, "mean_hdr": float(hdr.mean())}
    if profile:
        root, ext = os.path.splitext(profile)
        profile_frames(r, f"{root}_env{ext}", "env")
    report["env"]["jpeg"] = jpeg_env_box(smi, report)
    report["env"]["jpeg_arith"] = jpeg_env_box(smi, report, JPEG_ENV_ARITH,
                                               "env_jpeg_arith")


def bvh2_bound(visits: dict, scene: dict, n: int) -> dict:
    """K7's or K8's bound on ``n`` rays from its plain version's ``visits``:
    the rays and (t, idx) once, the node rows (box, meta or links) and the
    triangle rows once, a slab test a visited node and a Möller-Trumbore
    test a tested triangle."""
    moved = 6 * 4 * n + 8 * n + nbytes(scene["bvh_aabb"], scene["bvh_meta"],
                                       scene["tri_isect"])
    ops = SLAB_OPS * visits["nodes"] + MT_OPS * visits.get("triangles", 0)
    return bound(moved, ops)


def bvh2_depth_bound(visits: dict, scene: dict, n: int) -> dict:
    """K7's depth-mode bound on ``n`` rays from its plain version's
    ``visits``: the rays and the depth once, the box and meta rows once, a
    slab test a visited node."""
    moved = 6 * 4 * n + 4 * n + nbytes(scene["bvh_aabb"], scene["bvh_meta"])
    return bound(moved, SLAB_OPS * visits["nodes"])


BVH2_KERNELS = {
    # kind: (report key, counter, the launcher over the staged tables, plain
    # version, node table, the staging of the kernel's tables)
    "stack": ("k7", ISECT.StackCounter, ISECT.launch_stack,
              ISECT.closest_hit_bvh_plain,
              lambda scene: scene["bvh_meta"], ISECT.stack_tables),
    "bvh": ("k8", ISECT.LinkedCounter, ISECT.launch_linked,
            ISECT.closest_hit_bvh_linked_plain,
            lambda scene: ISECT.linked_nodes(scene["bvh_meta"],
                                             scene["bvh_links"]),
            ISECT.linked_tables),
}


def _f32(bits: np.ndarray) -> np.ndarray:
    return bits.astype(np.uint32).view(np.float32)


def div_operands(n: int, seed: int, dev):
    """Operand pairs (a, d) for K7's and K8's division: ``n`` pairs of
    random float32 bit patterns (every exponent, NaN and infinity
    included); every pair of the special operands (+-0, +-inf, NaN, the
    smallest and largest subnormals, FLT_MIN, FLT_MAX, 1, the fast
    window's edges 2^-64, 2^-63, 2^+-40, 2^+-41 and 2^39, and each one's
    neighbours) and each special against 4,096 random patterns; and n // 4
    pairs in and around the fast window (``csrc/bvh2.cu`` div_by: |a| in
    [2^-63, 2^40], |d| in [2^-40, 2^40]), normal operands with exponents
    in [-65, 42] and [-42, 42]. Returns two (M,) float32 tensors on
    ``dev``."""
    rng = np.random.default_rng(seed)
    base = np.array([0x00000000, 0x7F800000, 0x7FC00000, 0x00000001,
                     0x007FFFFF, 0x00800000, 0x7F7FFFFF, 0x3F800000,
                     0x53800000, 0x2B800000, 0x54000000, 0x2B000000,
                     0x20000000, 0x1F800000, 0x53000000],
                    np.int64)
    near = np.concatenate([base - 1, base, base + 1])
    near = near[(near >= 0) & (near <= 0x7FFFFFFF)]
    special = np.unique(np.concatenate([near, near | 0x80000000]))
    sa, sd = np.meshgrid(special, special)
    noise = rng.integers(0, 1 << 32, (2, 4096), dtype=np.int64)
    wide = rng.integers(0, 1 << 32, (2, n), dtype=np.int64)
    m = n // 4
    exps = np.stack([rng.integers(127 - 65, 127 + 43, m, dtype=np.int64),
                     rng.integers(127 - 42, 127 + 43, m, dtype=np.int64)])
    window = ((exps << 23) | rng.integers(0, 1 << 23, (2, m), dtype=np.int64)
              | (rng.integers(0, 2, (2, m), dtype=np.int64) << 31))
    a = np.concatenate([wide[0], sa.ravel(), np.repeat(special, 4096),
                        np.tile(noise[0], len(special)), window[0]])
    d = np.concatenate([wide[1], sd.ravel(), np.tile(noise[1], len(special)),
                        np.repeat(special, 4096), window[1]])
    return (torch.from_numpy(_f32(a)).to(dev),
            torch.from_numpy(_f32(d)).to(dev))


def div_apart(a, d, got, want) -> int:
    """Pairs where K7's and K8's division ``got`` differs from ``want``
    (``/``) beyond what ``csrc/bvh2.cu`` allows: a zero numerator over a
    divisor of the fast window (|d| in [2^-40, 2^40]) may give the other
    zero sign (+0 always), which the walks only compare. NaN is held to
    NaN, not to its bits."""
    bits = lambda x: x.view(torch.int32)  # noqa: E731
    same = (bits(got) == bits(want)) | (torch.isnan(got)
                                          & torch.isnan(want))
    m = d.abs()
    zero = ((a == 0) & (m >= 2.0 ** -40) & (m <= 2.0 ** 40) & (got == 0)
            & (want == 0))
    return int((~(same | zero)).sum())


def check_bvh2_div(dev) -> tuple:
    """K7's and K8's division against the same file's ``/`` (bit for bit)
    and PyTorch's division (NaN against NaN), each a zero numerator's sign
    aside (``div_apart``), on ``div_operands``; returns (pairs, the pairs
    whose zero sign differs from ``/``'s)."""
    a, d = div_operands(1 << 24, 0, dev)
    got, ieee = ISECT.bvh2_div(a, d)
    apart, apart_torch = div_apart(a, d, got, ieee), div_apart(a, d, got,
                                                               a / d)
    if apart or apart_torch:
        raise AssertionError(f"div_by differs from / on {apart} pairs and "
                             f"from PyTorch's division on {apart_torch}")
    signs = int((got.view(torch.int32) != ieee.view(torch.int32)).sum())
    return a.numel(), signs


def phase_bvh2(dev, report, large: dict):
    """K7 and K8 on the large box's camera, bounce-1 and shadow rays
    (``large_sets``), against their plain versions bit for bit and against
    K3; each set's time beside its bound. K7's depth mode is held by phase
    ``debug``."""
    scene, rays, cases = large["scene"], large["rays"], large["cases"]
    tri, aabb = scene["tri_isect"], scene["bvh_aabb"]
    nt, n = tri.shape[0], rays.shape[1]
    walk_tables = K3.walk_tables(scene)
    pairs, signs = check_bvh2_div(aabb.device)
    say("bvh2", f"div_by equal to / and to PyTorch's division on {pairs} "
        f"operand pairs, bit for bit but for {signs} zero numerators' signs")
    for line in kernel_resources(cuda_lib.build_log()):
        if "stack_kernel" in line or "linked_kernel" in line:
            say("bvh2", f"ptxas: {line}")
    say("bvh2", f"binary BVH: {aabb.shape[0]} nodes over {nt} triangles")
    for kind, (key, counter, cuda, plain, table_of,
               stage) in BVH2_KERNELS.items():
        table = table_of(scene)
        staged = stage(aabb, table, tri)
        worst, times = 0.0, {}
        for name, r, extra in cases:
            o, d = r[0:3].T, r[3:6].T
            before = counter.launches
            kt, ki = cuda(staged, o, d, **extra)
            torch.cuda.synchronize()
            if counter.launches != before + 1:
                raise AssertionError(f"{kind}: the wrapper did not launch")
            visits = {}
            t0 = time.perf_counter()
            pt, pi = plain(aabb, table, tri, o, d, visits=visits, **extra)
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t0
            t_lanes, t_ulp, t_err = compare(kt, pt)
            i_lanes = int((ki != pi).sum())
            worst = max(worst, t_err)
            if t_lanes or i_lanes:
                raise AssertionError(
                    f"{key} ({kind}) disagrees with its plain version on the "
                    f"{name} rays: t on {t_lanes}, idx on {i_lanes} lanes")
            # Against K3 on the same rays (K3 clears idx past the triangle
            # count; the walks return the raw best, which is never past).
            wt, wi = K3.closest_hit_walk(walk_tables, r[0:3], r[3:6],
                                         num_tris=nt, **extra)
            if extra.get("any_hit"):
                # Shadow rays start on the walls, whose planes hold BVH box
                # faces: a zero direction component there is the slab
                # test's 0/0 = NaN (a missed box) in the binary walks and
                # the 1e-30 stand-in in K3, so a few answers may differ.
                occl = (kt < extra["t_max"]) != (wt < extra["t_max"])
                apart_note = (f"occlusion answers differ from K3's on "
                              f"{int(occl.sum())} lanes")
                if int(occl.sum()) > 0.01 * n:
                    raise AssertionError(f"{kind}: the shadow answers differ "
                                         "from K3's on more than 1% of lanes")
            else:
                idx_apart = ki != wi
                t_apart = kt != wt
                apart_note = (f"against K3 idx differs on "
                              f"{int(idx_apart.sum())} lanes, t on "
                              f"{int(t_apart.sum())}; every difference an "
                              f"exact-t tie: "
                              f"{'yes' if not bool(t_apart.any()) else 'no'}")
                if int((idx_apart | t_apart).sum()) > 0.01 * n:
                    raise AssertionError(f"{kind} and K3 disagree on more "
                                         f"than 1% of the {name} rays")
            ms = device_ms(lambda: cuda(staged, o, d, **extra))
            b = bvh2_bound(visits, scene, n)
            times[name] = {"ms": ms, "plain_s": plain_s, **b,
                           "nodes_per_ray": visits["nodes"] / n,
                           "triangles_per_ray": visits["triangles"] / n}
            say("bvh2", f"{key} ({kind}) {name} rays: {n} lanes "
                f"({int((pi >= 0).sum())} hits) equal to the plain version "
                f"on every lane; {visits['nodes'] / n:.1f} nodes and "
                f"{visits['triangles'] / n:.1f} triangles a ray; "
                f"{apart_note}; "
                f"device {ms:.4f} ms, bound {b['bound_ms']:.4f} ms "
                f"({b['bound_by']}); plain {plain_s * 1e3:.1f} ms")
        cam = times["camera"]
        report.setdefault(key, {}).update(
            max_abs_err=worst, ms=cam["ms"], plain_ms=cam["plain_s"] * 1e3,
            bound_ms=cam["bound_ms"], bound_by=cam["bound_by"],
            library_ms=None, sets=times)


def renderer_of(scene_np, **config) -> Renderer:
    """A 512x512 Renderer on the card with ``scene_np`` loaded."""
    r = Renderer(RenderConfig(width=SIZE, height=SIZE, **config),
                 device="cuda")
    r.load_scene(scene_np)
    return r


def phase_debug(dev, smi, report, large: dict):
    """The two debug views on the Cornell box and the large box, each
    against its plain path; 1-spp Cornell renders through "stack" and
    "bvh" against their plain paths and the K1 path; the same walks in ray
    order on a box of ORDERED_TESSELLATION against their plain paths."""
    out = report.setdefault("debug", {})
    for label, scene_np, hit in (("cornell", cornell_box(), "k1"),
                                 ("large", large["scene_np"], "k3")):
        r = renderer_of(scene_np)
        for mode, counts in (("bvh_depth", dict(k7=1, k7_depth=1)),
                             ("normal", {hit: 1})):
            r.config.mode = mode
            path = f"debug_{mode}_{label}"
            view, secs = counted_render(r, 1, report, path, expect(**counts))
            visits = {}
            t0 = time.perf_counter()
            plain = plain_debug(r, visits)
            plain_secs = time.perf_counter() - t0
            same_image(view, plain, f"{mode} view of the {label} box against "
                       f"its plain path ({plain_secs:.2f} s)", "debug")
            out[path] = {"seconds": secs, "plain_seconds": plain_secs,
                         "mean": float(view.mean())}
            if mode == "bvh_depth" and label == "large":
                scene = r._scene_dev
                ro3, rd3 = DEBUG._center_rays(r._camera(), SIZE, SIZE, dev)
                staged = ISECT.stack_tables(scene["bvh_aabb"],
                                            scene["bvh_meta"])
                ms = device_ms(lambda: ISECT.launch_stack_depth(
                    staged, ro3.T, rd3.T, float(DEBUG.MAX_DEPTH)))
                b = bvh2_depth_bound(visits, scene, SIZE * SIZE)
                say("debug", f"K7's depth mode on the large box's pixel "
                    f"centres: {visits['nodes'] / SIZE ** 2:.1f} nodes a "
                    f"ray; device {ms:.4f} ms, bound {b['bound_ms']:.4f} ms "
                    f"({b['bound_by']})")
                report["k7"].update(depth_mode_ms=ms,
                                    depth_mode_bound_ms=b["bound_ms"])
    brute = renderer_of(cornell_box())
    k1_image = brute.render(spp=1)
    for kind, key in (("stack", "k7"), ("bvh", "k8")):
        r = renderer_of(cornell_box(), intersector=kind)
        if r.stats()["intersector"] != kind:
            raise AssertionError(f"intersector={kind!r} was not taken")
        path = f"render_{kind}"
        hdr, secs = counted_render(
            r, 1, report, path,
            expect(k2=MAX_BOUNCES, **{key: 2 * MAX_BOUNCES}))
        report[key]["launches"] = report[key]["launches_by_path"][path]
        plain_secs = checked_plain(r, 1, hdr, "debug")
        apart = pixels_differing(hdr, k1_image)
        say("debug", f"{kind} render, 1 spp: wall {secs:.3f} s; differs from "
            f"the K1 path's image on {apart} pixels")
        if apart > 0.01 * SIZE * SIZE:
            raise AssertionError(f"the {kind} render differs from the K1 "
                                 "render on more than 1% of its pixels")
        out[path] = {"seconds": secs, "plain_seconds": plain_secs,
                     "pixels_apart_from_k1": apart}
    # The binary walks' ray order (BVH2_REORDER_MIN_NODES) on a box of
    # ORDERED_TESSELLATION at 128x128, REORDER_MIN_LANES rays a call, and
    # two bounces: bounce 1's closest-hit and shadow calls sorted, the image
    # the plain path's (each ray walked alone, in lane order).
    size, order, sorts = 128, ISECT.ray_order, []
    ISECT.ray_order = lambda *a: sorts.append(1) or order(*a)
    try:
        for kind, key in (("stack", "k7"), ("bvh", "k8")):
            r = Renderer(RenderConfig(width=size, height=size,
                                      intersector=kind, max_bounces=2),
                         device="cuda")
            r.load_scene(tessellated_box(ORDERED_TESSELLATION)[0])
            nodes = r._scene_dev["bvh_aabb"].shape[0]
            if nodes < ISECT.BVH2_REORDER_MIN_NODES[kind]:
                raise AssertionError(f"{nodes} binary nodes: below the "
                                     "ray order's threshold")
            sorts.clear()
            path = f"render_{kind}_ordered"
            hdr, secs = counted_render(r, 1, report, path,
                                       expect(k2=2, **{key: 4}))
            if len(sorts) != 2:
                raise AssertionError(f"{path}: {len(sorts)} calls sorted, "
                                     "not bounce 1's two")
            plain_secs = checked_plain(r, 1, hdr, "debug")
            say("debug", f"{kind} render of the {nodes}-node box, 1 spp, 2 "
                f"bounces: wall {secs:.3f} s, bounce 1's two calls in ray "
                "order")
            out[path] = {"seconds": secs, "plain_seconds": plain_secs,
                         "nodes": nodes}
    finally:
        ISECT.ray_order = order


# K9's work a pixel a level: 25 taps of 44 operations (the normal dot
# product and its clamp, pow, the depth and luminance terms with their two
# exps, the weight's products, the three sums) and 15 of its own (the centre
# luminance, sig_l, the two normalizations); bytes: colour, normal, depth,
# variance and found read once, colour and variance written once.
ATROUS_OPS = 25 * 44 + 15
ATROUS_BYTES = 12 + 12 + 4 + 4 + 1 + 12 + 4


def phase_denoise(dev, smi, report, profile: str | None = None):
    """The flagship at 64 spp, then ``aovs()``, ``denoise()`` and
    ``image(denoise=True)``: K9 against its plain version at every level on
    the path's own inputs, the whole ``denoise()`` against the plain path,
    and the times."""
    r = Renderer(RenderConfig(width=SIZE, height=SIZE), device="cuda")
    r.load_scene(cornell_box())
    r.render(spp=SPP)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    aovs = r.aovs()
    torch.cuda.synchronize()
    aov_secs = time.perf_counter() - t0
    found = float(aovs["found"].float().mean())
    dn, secs = timed(lambda: r.denoise())
    counts = launch_counts()
    say("denoise", f"aovs() {aov_secs * 1e3:.1f} ms ({100 * found:.1f}% of "
        f"pixels hit); denoise() wall {secs * 1e3:.1f} ms; launches "
        + ", ".join(f"{k.upper()} {v}" for k, v in counts.items() if v))
    if counts != expect(k1=2, k9=5):
        raise AssertionError("denoise: expected two dense hits (the AOV "
                             "passes of aovs() and of denoise) and 5 K9 "
                             "launches")
    report.setdefault("k9", {})["launches"] = 5
    if dn.shape != (SIZE, SIZE, 3) or not np.isfinite(dn).all():
        raise AssertionError("denoise: the image is not finite")
    img = r.image(denoise=True)
    raw = r.image()
    if not np.isfinite(img).all() or img.shape != raw.shape:
        raise AssertionError("image(denoise=True) is not a finite image")

    # Every level of the path: the kernel against the plain version on the
    # same inputs, and each level's inputs kept for the times.
    levels, worst = [], 0.0

    def checking_level(*args, **kw):
        nonlocal worst
        kout = K9.atrous_level_cuda(*args, **kw)
        pout = K9.atrous_level_plain(*args, **kw)
        torch.cuda.synchronize()
        for k, p, what in zip(kout, pout, ("colour", "variance")):
            lanes, ulp, err = compare(k.reshape(-1), p.reshape(-1))
            if lanes:
                raise AssertionError(f"K9 level {len(levels)}: the {what} "
                                     f"differs on {lanes} values "
                                     f"({ulp} ulp)")
            worst = max(worst, err)
        levels.append((args, kw))
        return kout

    same_image(r.denoise(level=checking_level), dn,
               "denoise() with each level checked against denoise()",
               "denoise")
    say("denoise", f"K9 equals its plain version at all {len(levels)} levels "
        "(colour and variance, bit for bit)")
    t0 = time.perf_counter()
    plain = plain_denoise(r)
    plain_secs = time.perf_counter() - t0
    same_image(dn, plain, f"denoise() against the plain path "
               f"({plain_secs:.2f} s)", "denoise")
    level_ms = [device_ms(lambda a=a, k=k: K9.atrous_level_cuda(*a, **k))
                for a, k in levels]
    plain_level_ms = [eager_ms(lambda a=a, k=k: K9.atrous_level_plain(*a, **k),
                               reps=3) for a, k in levels]
    args, kw = levels[0]
    filt = lambda level: K9.atrous_filter(  # noqa: E731
        *args[:4], level=level, **kw)
    filter_ms = eager_ms(lambda: filt(K9.atrous_level))
    plain_filter_ms = eager_ms(lambda: filt(K9.atrous_level_plain), reps=3)
    n = SIZE * SIZE
    b = bound(ATROUS_BYTES * n, ATROUS_OPS * n)
    for line in kernel_resources(cuda_lib.build_log()):
        if "atrous_level_kernel" in line:
            say("denoise", f"ptxas: {line}")
            report["k9"]["ptxas"] = line
    say("denoise", "K9 device ms by level (step 1..16): "
        + ", ".join(f"{ms:.4f}" for ms in level_ms)
        + f"; bound {b['bound_ms']:.4f} ms a level ({b['bound_by']}); plain "
        "level " + ", ".join(f"{ms:.2f}" for ms in plain_level_ms)
        + f" ms; the whole filter {filter_ms:.3f} ms (plain "
        f"{plain_filter_ms:.2f} ms) launched from Python; denoise() wall "
        f"{secs * 1e3:.1f} ms on {smi}")
    report["k9"].update(max_abs_err=worst, ms=float(np.median(level_ms)),
                        plain_ms=float(np.median(plain_level_ms)),
                        level_ms=level_ms, plain_level_ms=plain_level_ms,
                        **b)
    report["denoise"] = {"aovs_seconds": aov_secs, "denoise_seconds": secs,
                         "filter_ms": filter_ms,
                         "plain_filter_ms": plain_filter_ms,
                         "plain_denoise_seconds": plain_secs,
                         "mean_raw": float(raw.mean()),
                         "mean_denoised": float(img.mean())}
    if profile:
        root, ext = os.path.splitext(profile)
        report["denoise"]["profile"] = profile_call(
            r.denoise, f"{root}_denoise{ext}", "denoise")


ADAPTIVE_SPP = 64
ADAPTIVE_LARGE_SPP = 8
# The flagship's adaptive image held to its plain path at this budget (the
# plain path of 64 spp takes about 30 s: 160 plain traces).
ADAPTIVE_PLAIN_SPP = 16
# The walk's adaptive render held to its plain path: the 8,706-triangle box
# (the large box's plain walk takes about 30 s a frame) at 256x256, 3 spp
# (2 warmup frames and 4 rounds of 16,384 lanes, which the walk sorts), 2
# bounces (the plain walk syncs the host once a stack pop).
ADAPTIVE_PLAIN_WALK = (PHASED_TESSELLATION, 256, 3, 2)


def adaptive_launches(spp: int, n: int) -> tuple:
    """(traces, rounds) of ``render_adaptive(spp)`` at ``n`` pixels with
    the default fractions."""
    n0 = max(2, int(round(spp * 0.5)))
    k = min(n, max(ADAPTIVE.LANE_QUANTUM, -(-int(round(n * 0.25))
                                             // ADAPTIVE.LANE_QUANTUM)
                   * ADAPTIVE.LANE_QUANTUM))
    rounds = int(round((spp - n0) * n / k))
    return n0 + rounds, rounds


ADAPTIVE_REPEATS = 2


def counted_adaptive(r: Renderer, spp: int, report: dict, path: str,
                     expected: dict):
    """``r.render_adaptive(spp)`` after a reset, with every launch count
    set to 0 just before and read just after (they must equal
    ``expected``), then ADAPTIVE_REPEATS more; returns (image, the first
    wall seconds, its rays, the median wall of the repeats)."""
    r.reset()
    torch.cuda.synchronize()
    reset_counts()
    rays0 = int(r._counters.sum())
    hdr, secs = timed(lambda: r.render_adaptive(spp))
    counts = launch_counts()
    rays = int(r._counters.sum()) - rays0
    say(path, f"render_adaptive({spp}) at {r.config.width}x"
        f"{r.config.height}: wall {secs:.3f} s, {rays} rays, "
        f"{rays / secs / 1e6:.3f} Mrays/s; launches "
        + ", ".join(f"{k.upper()} {v}" for k, v in counts.items() if v))
    if counts != expected:
        raise AssertionError(f"{path}: expected launches {expected}")
    if not np.isfinite(hdr).all():
        raise AssertionError(f"{path}: the image is not finite")
    walls = []
    for _ in range(ADAPTIVE_REPEATS):
        r.reset()
        walls.append(timed(lambda: r.render_adaptive(spp))[1])
    med = float(np.median(walls))
    say(path, f"{ADAPTIVE_REPEATS} more: wall median {med:.3f} s (min "
        f"{min(walls):.3f}, max {max(walls):.3f}), {rays / med / 1e6:.3f} "
        "Mrays/s at the median")
    return hdr, secs, rays, med


def phase_adaptive(dev, smi, report, large: dict,
                   profile: str | None = None):
    """``render_adaptive`` on the flagship (64 spp) and on the large box
    through the walk (8 spp): launch counts, wall and Mrays/s, the
    flagship's image against its plain path, and the walk's against its
    plain path on the cut of ``ADAPTIVE_PLAIN_WALK``."""
    out = report.setdefault("adaptive", {})
    n = SIZE * SIZE
    traces, rounds = adaptive_launches(ADAPTIVE_SPP, n)
    r = Renderer(RenderConfig(width=SIZE, height=SIZE), device="cuda")
    r.load_scene(cornell_box())
    hdr, secs, rays, med = counted_adaptive(
        r, ADAPTIVE_SPP, report, "adaptive",
        expect(k1=2 * MAX_BOUNCES * traces, k2=MAX_BOUNCES * traces))
    _, plain_rounds = adaptive_launches(ADAPTIVE_PLAIN_SPP, n)
    r.reset()
    hdr = r.render_adaptive(ADAPTIVE_PLAIN_SPP)
    t0 = time.perf_counter()
    plain = plain_adaptive(r, ADAPTIVE_PLAIN_SPP)
    plain_secs = time.perf_counter() - t0
    same_image(hdr, plain, f"the flagship's render_adaptive("
               f"{ADAPTIVE_PLAIN_SPP}) ({plain_rounds} rounds) against its "
               f"plain path ({plain_secs:.1f} s)", "adaptive")
    out["flagship"] = {"spp": ADAPTIVE_SPP, "rounds": rounds,
                       "seconds": secs, "rays": rays,
                       "mrays_per_sec": rays / secs / 1e6,
                       "repeat_median_seconds": med,
                       "plain_spp": ADAPTIVE_PLAIN_SPP,
                       "plain_seconds": plain_secs}
    if profile:
        root, ext = os.path.splitext(profile)

        def again():
            r.reset()
            r.render_adaptive(ADAPTIVE_SPP)

        out["flagship"]["profile"] = profile_call(
            again, f"{root}_adaptive{ext}", "adaptive")
    r = renderer_of(large["scene_np"])
    traces, rounds = adaptive_launches(ADAPTIVE_LARGE_SPP, n)
    hdr, secs, rays, med = counted_adaptive(
        r, ADAPTIVE_LARGE_SPP, report, "adaptive_large",
        expect(k3=2 * MAX_BOUNCES * traces, k2=MAX_BOUNCES * traces))
    out["large"] = {"spp": ADAPTIVE_LARGE_SPP, "rounds": rounds,
                    "seconds": secs, "rays": rays,
                    "mrays_per_sec": rays / secs / 1e6,
                    "repeat_median_seconds": med}
    tess, size, spp, bounces = ADAPTIVE_PLAIN_WALK
    r = Renderer(RenderConfig(width=size, height=size, max_bounces=bounces),
                 device="cuda")
    r.load_scene(tessellated_box(tess)[0])
    if r.stats()["intersector"] != "walk":
        raise AssertionError("the mid-size box must take the walk")
    got = r.render_adaptive(spp)
    t0 = time.perf_counter()
    plain = plain_adaptive(r, spp)
    plain_secs = time.perf_counter() - t0
    same_image(got, plain, f"cornell_box(tessellation={tess}) adaptive at "
               f"{size}x{size}, {spp} spp, {bounces} bounces, through the "
               f"walk, against its plain path ({plain_secs:.1f} s)",
               "adaptive")
    out["walk_plain_check"] = {"tessellation": tess, "size": size,
                               "spp": spp, "max_bounces": bounces,
                               "plain_seconds": plain_secs}

# The native scene-prep library and the command line: the scenes whose set-up
# the library shortens, the CLI's renders and the viewer's ticks.
CLI_SPP = 64  # the flagship through the CLI (and 32 + 32 through a resume)
CLI_ATRIUM_SPP = 8
VIEWER_SIZE = 256
VIEWER_FRAMES = 4  # frames a viewer tick
VIEWER_TICKS = 20  # ticks timed for the viewer's fps


@functools.lru_cache(maxsize=None)
def atrium_glb() -> tuple:
    """(``gallery_atrium(detail=GLTF_DETAIL)``, its .glb bytes), made once."""
    atrium = gallery_atrium(detail=GLTF_DETAIL)
    return atrium, scene_to_glb(atrium)


class numpy_paths:
    """Within the block the package sees no C++ compiler, so every loader
    takes its NumPy path."""

    def __enter__(self):
        self.compiler = native.compiler
        native.compiler = lambda: None
        if native.native_available():
            raise AssertionError("the NumPy paths were not forced")

    def __exit__(self, *exc):
        native.compiler = self.compiler


def bits_equal(a, b) -> bool:
    """Equal shapes and bits (NaN-aware for float32)."""
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == np.float32:
        a, b = a.view(np.uint32), b.view(np.uint32)
    return bool(np.array_equal(a, b))


def both_ways(what: str, lib_fn, numpy_fn, fields, out: dict, smi: str):
    """``lib_fn()`` against ``numpy_fn()``: each timed once, their results'
    ``fields`` (attribute names, or indices of a tuple) bit-equal."""
    got, lib_s = timed(lib_fn)
    want, numpy_s = timed(numpy_fn)
    pick = ((lambda x, f: x[f]) if isinstance(fields[0], int)
            else (lambda x, f: getattr(x, f)))
    differ = [f for f in fields if not bits_equal(pick(got, f), pick(want, f))]
    say("native", f"{what}: library {lib_s:.4f} s, NumPy {numpy_s:.4f} s "
        f"({numpy_s / lib_s:.1f}x), " + (f"DIFFER in {differ}" if differ
                                         else "bit-equal") + f" on {smi}")
    if differ:
        raise AssertionError(f"{what}: the library and NumPy differ")
    out[what] = {"library_s": lib_s, "numpy_s": numpy_s}
    return got


def phase_native(dev, smi, report):
    """The C++ scene-prep library against the NumPy paths, bit for bit, on
    the large box and the atrium: the SAH build, the wide collapse, the
    triangle reorder, potpack (the atrium's atlas and fat canvas), each
    timed both ways; the whole scene builds and the atrium's
    ``Renderer.load_model`` from a .glb both ways."""
    if not native.native_available():
        raise AssertionError("no g++ on PATH: the native library cannot build")
    _, build_s = timed(native.lib)
    out = report.setdefault("native", {"build_s": build_s})
    say("native", f"g++ built {os.path.basename(native.library_path())} in "
        f"{build_s:.2f} s ({' '.join(native.CXX_FLAGS)})")
    large, _ = tessellated_box(LARGE_TESSELLATION)
    atrium, glb = atrium_glb()
    for label, scene, remake in (
            ("large box", large,
             lambda: cornell_box(tessellation=LARGE_TESSELLATION)),
            ("atrium", atrium, lambda: gallery_atrium(detail=GLTF_DETAIL))):
        n = scene.num_triangles
        v = (scene.tri_v0, scene.tri_v1, scene.tri_v2)
        tree = both_ways(f"{label} SAH build, {n} triangles",
                         lambda: native.build_bvh_native(*v),
                         lambda: build_bvh(*v),
                         ("aabb_min", "aabb_max", "meta", "order"), out, smi)
        tri = tri_isect_of(*(np.asarray(a)[tree.order] for a in v))
        for pack in ("none", "ffd"):
            both_ways(f"{label} wide collapse ({pack})",
                      lambda: bvh8.build_wide_bvh(
                          tree.aabb_min, tree.aabb_max, tree.meta, tri,
                          pack=pack),
                      lambda: bvh8.build_wide_bvh(
                          tree.aabb_min, tree.aabb_max, tree.meta, tri,
                          pack=pack, prefer_native=False),
                      ("meta", "order", "boxes", "tris"), out, smi)
        cols = (scene.tri_v0, scene.tri_v1, scene.tri_v2, scene.tri_n0,
                scene.tri_n1, scene.tri_n2, scene.tri_uv0, scene.tri_uv1,
                scene.tri_uv2, scene.tri_mat)
        perm = np.random.default_rng(3).permutation(n)
        both_ways(f"{label} triangle reorder",
                  lambda: native.reorder_tris_native(perm, *cols),
                  lambda: tuple(np.asarray(c)[perm] for c in cols),
                  tuple(range(10)), out, smi)
        with numpy_paths():
            plain, numpy_s = timed(remake)
        fresh, lib_s = timed(remake)
        same_arrays(fresh, plain, f"the {label} built both ways")
        say("native", f"{label} scene build: library {lib_s:.3f} s, NumPy "
            f"{numpy_s:.3f} s, the same arrays on {smi}")
        out[f"{label} scene build"] = {"library_s": lib_s,
                                       "numpy_s": numpy_s}

    # The glTF flatten under a node that is not the identity (the atrium's
    # nodes are): the float64 transform, renormalization and gather.
    from wgpu_path_tracing_tpu_torch.models import gltf as GLTF

    rng = np.random.default_rng(11)
    pos = rng.uniform(-50, 50, (4096, 3)).astype(np.float32)
    nrm = rng.normal(0, 1, (4096, 3)).astype(np.float32)
    nrm[::97] = 0.0
    world = np.eye(4)
    world[0:3, 0:3] = rng.normal(0, 1, (3, 3)) + np.eye(3) * 2.0
    world[0:3, 3] = rng.uniform(-5, 5, 3)
    args = (pos, nrm, world, np.linalg.inv(world).T,
            rng.integers(0, 4096, 3 * 6000))
    both_ways("flatten of 6,000 triangles under a transformed node",
              lambda: native.flatten_native(*args),
              lambda: GLTF.flatten_corners(*args), tuple(range(6)), out, smi)

    # potpack on the boxes the atrium's load packs: the atlas's and the fat
    # canvas's, recorded as the loader hands them over.
    from wgpu_path_tracing_tpu_torch.models import potpack as POTPACK

    recorded = []

    def recording(boxes):
        recorded.append([{"w": b["w"], "h": b["h"]} for b in boxes])
        return real(boxes)

    real = POTPACK.potpack
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "atrium.glb")
        with open(path, "wb") as f:
            f.write(glb)
        GLTF.potpack = POTPACK.potpack = recording
        try:
            pack_device_scene(load_model(path))
        finally:
            GLTF.potpack = POTPACK.potpack = real
        for k, boxes in enumerate(recorded):
            wh = np.array([[b["w"], b["h"]] for b in boxes], np.float64)

            def python():
                copies = [dict(b) for b in boxes]
                dims = POTPACK.potpack_python(copies)
                return (np.array([[b["x"], b["y"]] for b in copies],
                                 np.float64), *map(float, dims))

            both_ways(f"atrium potpack {k} ({len(boxes)} boxes)",
                      lambda: native.potpack_native(wh), python, (0, 1, 2),
                      out, smi)

        # The atrium's whole Renderer.load_model from the .glb, both ways.
        loads = {}
        for way in ("library", "NumPy"):
            r = Renderer(RenderConfig(width=SIZE, height=SIZE),
                         device="cuda")
            if way == "NumPy":
                with numpy_paths():
                    _, loads[way] = timed(lambda: r.load_model(path))
                same_arrays(r.scene, loaded, "the atrium loaded both ways")
            else:
                _, loads[way] = timed(lambda: r.load_model(path))
                loaded = r.scene
            del r
        say("native", f"atrium Renderer.load_model from a .glb "
            f"({len(glb)} bytes): library {loads['library']:.3f} s, NumPy "
            f"{loads['NumPy']:.3f} s, the same arrays on {smi}")
        out["atrium Renderer.load_model"] = {"library_s": loads["library"],
                                             "numpy_s": loads["NumPy"]}


def counted_call(fn, report: dict, path: str, expected: dict):
    """``fn()`` with every launch count set to 0 just before and read just
    after; the counts must equal ``expected``. Returns (result, wall
    seconds to a device sync)."""
    torch.cuda.synchronize()
    reset_counts()
    result, secs = timed(fn)
    counts = launch_counts()
    say(path, "launches " + ", ".join(f"{k.upper()} {v}"
                                      for k, v in counts.items() if v))
    if counts != expected:
        raise AssertionError(f"{path}: expected launches {expected}, got "
                             f"{counts}")
    for k, v in counts.items():
        report.setdefault(k, {}).setdefault("launches_by_path", {})[path] = v
    return result, secs


def cli_main(*argv) -> str:
    """``cli.main(argv)`` in this process; returns what it printed."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = CLI.main(list(argv))
    if rc != 0:
        raise AssertionError(f"cli {' '.join(argv)} exited {rc}")
    return buf.getvalue()


def cli_renderer(scene_np=None, path=None) -> Renderer:
    """The ``Renderer`` the CLI builds by default (512x512, its camera)."""
    cam = Camera(width=SIZE, height=SIZE, aspect=1.0, fov=math.radians(60.0),
                 aperture=0.001, focus_distance=5.0)
    r = Renderer(RenderConfig(width=SIZE, height=SIZE), cam, device="cuda")
    if path is None:
        r.load_scene(scene_np)
    else:
        r.load_model(path)
    return r


def same_png(a: str, b: str, what: str) -> None:
    from wgpu_path_tracing_tpu_torch.utils.image import read_png

    same_image(read_png(a), read_png(b), what, "cli")


def http(url: str, data: bytes | None = None, method: str = "GET") -> bytes:
    import urllib.request

    req = urllib.request.Request(url, data=data, method=method)
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.read()


def phase_cli(dev, smi, report):
    """The command line as subprocesses (the flagship at 64 spp, the atrium
    from a .glb at 8 spp), each PNG against an in-process ``Renderer``'s;
    ``cli.main`` in this process with the launches counted; a checkpoint and
    resume; ``info`` and ``export``; the HTTP viewer on the Cornell box:
    a key press over HTTP moves the camera and restarts the accumulation,
    the frame decodes, the stats read, a POSTed .glb is installed at a
    chunk boundary; its fps and motion-to-frame time."""
    from wgpu_path_tracing_tpu_torch.utils.image import decode_png_rgba
    from wgpu_path_tracing_tpu_torch.viewer import ViewerServer

    out = report.setdefault("cli", {})
    atrium, glb = atrium_glb()
    with tempfile.TemporaryDirectory() as tmp:
        atrium_path = os.path.join(tmp, "atrium.glb")
        with open(atrium_path, "wb") as f:
            f.write(glb)
        at = lambda name: os.path.join(tmp, name)  # noqa: E731
        # The two subprocesses at once.
        env = dict(os.environ, PYTHONPATH=REPO)
        cmds = {"cornell": ["cornell", "--spp", str(CLI_SPP)],
                "atrium": [atrium_path, "--spp", str(CLI_ATRIUM_SPP)]}
        t0 = time.perf_counter()
        procs = {k: subprocess.Popen(
            [sys.executable, "-m", "wgpu_path_tracing_tpu_torch.cli",
             "render", *args, "-o", at(f"{k}_sub.png")], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for k, args in cmds.items()}
        try:
            runs = {k: p.communicate(timeout=600) for k, p in procs.items()}
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
        sub_s = time.perf_counter() - t0
        for k, p in procs.items():
            if p.returncode != 0:
                raise AssertionError(f"cli render {k} exited {p.returncode}:"
                                     f"\n{runs[k][1][-4000:]}")
            say("cli", f"python -m wgpu_path_tracing_tpu_torch.cli render "
                f"{' '.join(cmds[k])}: {runs[k][0].strip()}")
        say("cli", f"both subprocesses in {sub_s:.2f} s of wall (processes "
            f"started together) on {smi}")

        # The flagship: cli.main in this process, launches counted; an
        # in-process Renderer; the subprocess's PNG; all equal.
        _, secs = counted_call(
            lambda: cli_main("render", "cornell", "--spp", str(CLI_SPP),
                             "-o", at("cornell_main.png")),
            report, "cli_cornell", expect(k1=2 * MAX_BOUNCES * CLI_SPP,
                                          k2=MAX_BOUNCES * CLI_SPP))
        r = cli_renderer(cornell_box())
        r.render(spp=CLI_SPP)
        r.save_png(at("cornell_renderer.png"))
        same_png(at("cornell_sub.png"), at("cornell_renderer.png"),
                 "the CLI subprocess's flagship PNG against the Renderer's")
        same_png(at("cornell_main.png"), at("cornell_renderer.png"),
                 "cli.main's flagship PNG against the Renderer's")
        say("cli", f"cli.main render cornell, {CLI_SPP} spp: wall {secs:.3f} "
            f"s (scene, kernels' load, render, PNG) on {smi}")
        out["cornell"] = {"spp": CLI_SPP, "subprocesses_s": sub_s,
                          "main_s": secs}

        # The atrium from the .glb, the same way.
        r = cli_renderer(path=atrium_path)
        mode = {"none": "k2", "per_slot": "k2_per_slot", "fat": "k2_fat"}[
            r.stats()["texture"]]
        counted_call(lambda: r.render(spp=CLI_ATRIUM_SPP), report,
                     "cli_atrium_renderer",
                     expect(k3=2 * MAX_BOUNCES * CLI_ATRIUM_SPP,
                            **{mode: MAX_BOUNCES * CLI_ATRIUM_SPP}))
        r.save_png(at("atrium_renderer.png"))
        del r
        same_png(at("atrium_sub.png"), at("atrium_renderer.png"),
                 "the CLI subprocess's atrium PNG against the Renderer's")

        # A checkpoint after 32 spp and a resume to 64: the 64-spp image.
        half = CLI_SPP // 2
        cli_main("render", "cornell", "--spp", str(half), "--checkpoint",
                 at("run.npz"), "-o", at("half.png"))
        cli_main("render", "cornell", "--spp", str(CLI_SPP), "--checkpoint",
                 at("run.npz"), "--resume", "-o", at("resumed.png"))
        same_png(at("resumed.png"), at("cornell_renderer.png"),
                 f"cli --checkpoint ({half} spp) and --resume (to {CLI_SPP}) "
                 f"against {CLI_SPP} spp in one go")

        info = json.loads(cli_main("info", atrium_path))
        if info["triangles"] != atrium.num_triangles:
            raise AssertionError("cli info: wrong triangle count")
        said = cli_main("export", "cornell", "-o", at("cornell.glb"))
        if load_model(at("cornell.glb")).num_triangles != 36:
            raise AssertionError("cli export: the .glb does not load back")
        say("cli", f"info: {info['triangles']} triangles, {info['bvh_nodes']} "
            f"BVH nodes, atlas {info['atlas']}; export: {said.strip()}")

        # The viewer on the Cornell box.
        v = Renderer(RenderConfig(width=VIEWER_SIZE, height=VIEWER_SIZE),
                     device="cuda")
        v.load_scene(cornell_box())
        server = ViewerServer(v, port=0, frames_per_update=VIEWER_FRAMES)
        try:
            base = f"http://127.0.0.1:{server.port}"
            server.step(1 / 60)
            server.step(1 / 60)
            pos0 = v.camera.position.copy()
            http(f"{base}/key?k=w&down=1")
            counted_call(lambda: server.step(1 / 60), report, "viewer",
                         expect(k1=2 * MAX_BOUNCES * VIEWER_FRAMES,
                                k2=MAX_BOUNCES * VIEWER_FRAMES))
            http(f"{base}/key?k=w&down=0")
            if np.allclose(v.camera.position, pos0) or (
                    v.frame_index != VIEWER_FRAMES):
                raise AssertionError("the viewer's w key did not move the "
                                     "camera and restart the accumulation")
            server.step(1 / 60)
            frame = decode_png_rgba(http(f"{base}/frame.png"), "frame.png")
            stats = json.loads(http(f"{base}/stats"))
            if frame.shape != (VIEWER_SIZE, VIEWER_SIZE, 4) or (
                    stats["spp"] != 2 * VIEWER_FRAMES):
                raise AssertionError(f"viewer frame {frame.shape}, stats "
                                     f"{stats}")
            say("cli", f"viewer: w moved the camera {pos0} -> "
                f"{v.camera.position}, accumulation restarted; "
                f"/frame.png {frame.shape}, /stats {stats}")
            # Ticks timed at rest, then one motion's time to its frame.
            t0 = time.perf_counter()
            for _ in range(VIEWER_TICKS):
                server.step(1 / 60)
            tick_s = (time.perf_counter() - t0) / VIEWER_TICKS
            http(f"{base}/look?dx=8&dy=0")
            server.step(1 / 60)
            stats = json.loads(http(f"{base}/stats"))
            say("cli", f"viewer {VIEWER_SIZE}x{VIEWER_SIZE}, {VIEWER_FRAMES} "
                f"frames a tick: {1 / tick_s:.2f} ticks/s "
                f"({VIEWER_FRAMES / tick_s:.1f} frames/s), frame meter "
                f"{stats['fps']:.1f} fps, motion_to_frame_ms "
                f"{stats['motion_to_frame_ms']:.3f} on {smi}")
            out["viewer"] = {"size": VIEWER_SIZE, "frames_a_tick":
                             VIEWER_FRAMES, "tick_s": tick_s,
                             "fps": stats["fps"],
                             "motion_to_frame_ms":
                                 stats["motion_to_frame_ms"]}

            # POST the atrium's bytes: staged off the render thread, then
            # installed at a render's chunk boundary, the mean restarted.
            server.step(1 / 60)
            server.step(1 / 60)
            before = v.frame_index  # 3 ticks since the look restarted it
            if http(f"{base}/load", glb, "POST") != b"staged":
                raise AssertionError("POST /load did not stage the scene")
            t0 = time.perf_counter()
            server.step(1 / 60)
            server.loads[-1].result(timeout=300)
            while v.scene.num_triangles != atrium.num_triangles:
                server.step(1 / 60)
            swap_s = time.perf_counter() - t0
            if v.frame_index >= before or v.frame_index % VIEWER_FRAMES:
                raise AssertionError("the POSTed atrium was not installed at "
                                     "a chunk boundary with the mean "
                                     "restarted")
            say("cli", f"viewer: POST /load of the atrium ({len(glb)} bytes) "
                f"installed at a chunk boundary {swap_s:.3f} s after the "
                f"POST (frame index {before} -> {v.frame_index}) on {smi}")
            out["viewer"]["swap_s"] = swap_s
        finally:
            server.stop()


# --- multi-device rendering and the 16-wide walk ---------------------------

# The meshes of phase ``shard``, (name, sample shards, row shards), each
# entry of the device list a shard that runs on the one card in turn; the
# spp of its other renders.
SHARD_MESHES = (("1x1", 1, 1), ("1x2", 1, 2), ("2x2", 2, 2))
SHARD_LARGE_SPP = 8
SHARD_RNG_SPP = 8
SHARD_TAIL_SPP = 5  # not a multiple of the sample axis: a padded chunk
SHARD_CLI_SPP = 8
SHARD_REPEATS = 5  # renders of each mesh, in turns with one device's
# Phase ``wide16``: the size of its 1-spp render (the plain walk at 512x512
# takes about 30 s a frame).
WIDE16_SIZE = 192


def mesh_renderer(sample: int, rows: int, scene_np, **config) -> Renderer:
    """A 512x512 ``Renderer`` on a (sample, rows) mesh of the card."""
    r = Renderer(RenderConfig(width=SIZE, height=SIZE, **config),
                 device="cuda", devices=["cuda"] * (sample * rows),
                 sample_shards=sample)
    r.load_scene(scene_np)
    return r


def shard_frames(r: Renderer, spp: int) -> int:
    """The frames ``r.render(spp)`` runs over all the shards of its mesh:
    each chunk as ``round_chunk`` rounds it, on every row shard."""
    total, remaining = 0, spp
    while remaining > 0:
        n_frames, chunk = SH.round_chunk(
            min(r.config.frames_per_chunk, remaining), r.mesh.shape["sample"])
        total += n_frames * r.mesh.shape["row"]
        remaining -= chunk
    return total


def plain_sharded(r: Renderer, spp: int) -> np.ndarray:
    """The frames ``r.render(spp)`` draws on its mesh after a reset, through
    ``render_chunk_sharded`` with the plain bounce loop and the plain
    version of ``r``'s intersector, in the renderer's chunks. Returns
    (H, W, 3) like ``render``."""
    cfg, mesh = r.config, r.mesh
    scene = load_jax_scene(pack_device_scene(r.scene), r.device)
    for key in ("env", "env_params"):  # the environment map, where set
        if key in r._scene_dev:
            scene[key] = r._scene_dev[key]
    scenes = SH.replicate_scene(scene, mesh)
    hits = {d: plain_closest_hit(s, r.stats()["intersector"])
            for d, s in scenes.items()}
    accum = SH.shard_accum(torch.zeros((cfg.width * cfg.height, 3)), mesh)
    frame, remaining = 0, spp
    while remaining > 0:
        chunk = min(cfg.frames_per_chunk, remaining)
        fpt = math.gcd(cfg.frames_per_trace, chunk)
        n_frames, chunk = SH.round_chunk(chunk, mesh.shape["sample"])
        SH.render_chunk_sharded(
            TRACE.trace, hits, scenes, r._camera(), accum, frame, mesh=mesh,
            n_frames=n_frames, n_active=chunk, frames_per_trace=fpt,
            width=cfg.width, height=cfg.height,
            use_dof=float(r.camera.aperture) > 0.0,
            max_bounces=cfg.max_bounces, do_mis=cfg.do_mis,
            num_lights=r.scene.num_lights, firefly_clamp=cfg.firefly_clamp,
            rng_mode=cfg.rng)
        frame += chunk
        remaining -= chunk
    buf = SH.untile_image(SH.gather_image(accum), cfg.width, cfg.height,
                          mesh.shape["row"])
    return buf.reshape(cfg.height, cfg.width, 3)


def against_single(hdr, ref, stats, ref_stats, what: str) -> int:
    """A sharded image against the single-device one at the JAX package's
    bar (rtol 1e-4 / atol 1e-5): the pixels outside it, which must be none;
    the ray counters must be equal."""
    off = int((~np.isclose(hdr, ref, rtol=1e-4, atol=1e-5)).any(-1).sum())
    rays = (stats["rays_closest"], stats["rays_shadow"])
    ref_rays = (ref_stats["rays_closest"], ref_stats["rays_shadow"])
    say("shard", f"{what}: {off} pixels outside rtol 1e-4 / atol 1e-5 of "
        f"the single-device image, {pixels_differing(hdr, ref)} not "
        f"bit-equal; rays {rays}, single device {ref_rays}")
    if off or rays != ref_rays:
        raise AssertionError(f"{what}: not the single-device render")
    return off


def phase_shard(dev, smi, report):
    """``Renderer(devices=...)`` on meshes of the one card: the flagship on
    the 1x1, 1x2 and 2x2 meshes at 64 spp (launches, each image against its
    plain path's and the single-device image, the counters, cold and
    repeated Mrays/s in turns with the single-device renderer); then on the
    2x2 mesh the large box through the walk, the stratified flagship, a
    checkpoint resume and a padded tail chunk; ``cli.main render
    --multichip``; and ``devices=True`` on this host's cards."""
    out = report.setdefault("shard", {})
    single = Renderer(RenderConfig(width=SIZE, height=SIZE), device="cuda")
    single.load_scene(cornell_box())
    ref = single.render(spp=SPP)
    ref_stats = single.stats()
    rays = ref_stats["rays_total"]
    for name, sample, rows in SHARD_MESHES:
        r = mesh_renderer(sample, rows, cornell_box())
        frames = shard_frames(r, SPP)
        hdr, secs = counted_render(
            r, SPP, report, f"shard_{name}",
            expect(k1=2 * MAX_BOUNCES * frames, k2=MAX_BOUNCES * frames))
        off = against_single(hdr, ref, r.stats(), ref_stats,
                             f"{name} mesh, flagship {SPP} spp")
        t0 = time.perf_counter()
        plain = plain_sharded(r, SPP)
        plain_s = time.perf_counter() - t0
        same_image(hdr, plain, f"{name} mesh against its plain path "
                   f"({plain_s:.3f} s)", "shard")
        walls = {"single": [], "mesh": []}
        for _ in range(SHARD_REPEATS):  # in turns: single, mesh
            for key, rr in (("single", single), ("mesh", r)):
                rr.reset()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                rr.render(spp=SPP, fetch=False)
                walls[key].append(time.perf_counter() - t0)
        med = {k: float(np.median(v)) for k, v in walls.items()}
        say("shard", f"{name} mesh: cold render {secs:.4f} s, "
            f"{rays / secs / 1e6:.3f} Mrays/s; {SHARD_REPEATS} renders in "
            f"turns with one device, medians {med['mesh']:.4f} s "
            f"({rays / med['mesh'] / 1e6:.3f} Mrays/s) against "
            f"{med['single']:.4f} s ({rays / med['single'] / 1e6:.3f}): "
            f"{med['mesh'] / med['single']:.3f}x the single device's wall "
            f"on {smi}")
        out[name] = {"launches_k1": 2 * MAX_BOUNCES * frames,
                     "pixels_outside_bar": off, "seconds": secs,
                     "mrays_per_sec": rays / secs / 1e6,
                     "repeat_median_seconds": med["mesh"],
                     "single_median_seconds": med["single"],
                     "repeat_seconds": walls["mesh"],
                     "single_seconds": walls["single"],
                     "wall_ratio": med["mesh"] / med["single"],
                     "plain_seconds": plain_s}
        del r

    # The large box through the walk, on the 2x2 mesh.
    large, _ = tessellated_box(LARGE_TESSELLATION)
    one = Renderer(RenderConfig(width=SIZE, height=SIZE), device="cuda")
    one.load_scene(large)
    large_ref = one.render(spp=SHARD_LARGE_SPP)
    large_stats = one.stats()
    del one
    r = mesh_renderer(2, 2, large)
    if r.stats()["intersector"] != "walk":
        raise AssertionError("the large box must take the walk (K3)")
    frames = shard_frames(r, SHARD_LARGE_SPP)
    hdr, secs = counted_render(
        r, SHARD_LARGE_SPP, report, "shard_large",
        expect(k2=MAX_BOUNCES * frames, k3=2 * MAX_BOUNCES * frames))
    against_single(hdr, large_ref, r.stats(), large_stats,
                   f"2x2 mesh, the large box through the walk, "
                   f"{SHARD_LARGE_SPP} spp")
    out["large_2x2"] = {"seconds": secs, "mrays_per_sec":
                        r.stats()["rays_total"] / secs / 1e6}
    del r

    # rng="stratified" on the 2x2 mesh: K2's LDS instantiation once a shard
    # frame.
    one = rng_renderer("stratified", cornell_box())
    strat_ref = one.render(spp=SHARD_RNG_SPP)
    r = mesh_renderer(2, 2, cornell_box(), rng="stratified")
    frames = shard_frames(r, SHARD_RNG_SPP)
    hdr, _ = counted_render(
        r, SHARD_RNG_SPP, report, "shard_stratified",
        expect(k1=2 * MAX_BOUNCES * frames, k2=MAX_BOUNCES * frames,
               k2_lds=frames))
    against_single(hdr, strat_ref, r.stats(), one.stats(),
                   f"2x2 mesh, stratified flagship, {SHARD_RNG_SPP} spp")
    same_image(hdr, plain_sharded(r, SHARD_RNG_SPP),
               "the stratified 2x2 mesh against its plain path", "shard")
    del r, one

    # A checkpoint on the 2x2 mesh: CKPT_SPP frames, saved, loaded into a
    # fresh mesh renderer, CKPT_SPP more; against 2 * CKPT_SPP frames in one
    # go in the same chunks.
    c = mesh_renderer(2, 2, cornell_box(), frames_per_chunk=CKPT_SPP)
    c.render(spp=CKPT_SPP)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "mesh.npz")
        c.save_checkpoint(path)
        d = mesh_renderer(2, 2, cornell_box(), frames_per_chunk=CKPT_SPP)
        d.load_checkpoint(path)
    resumed = d.render(spp=CKPT_SPP)
    c.reset()
    same_image(resumed, c.render(spp=2 * CKPT_SPP),
               f"a 2x2 mesh render resumed from a checkpoint at {CKPT_SPP} "
               f"spp against {2 * CKPT_SPP} spp in one go", "shard")
    del c, d

    # A padded tail: SHARD_TAIL_SPP frames on two sample shards.
    one = Renderer(RenderConfig(width=SIZE, height=SIZE), device="cuda")
    one.load_scene(cornell_box())
    tail_ref = one.render(spp=SHARD_TAIL_SPP)
    r = mesh_renderer(2, 2, cornell_box())
    frames = shard_frames(r, SHARD_TAIL_SPP)
    hdr, _ = counted_render(
        r, SHARD_TAIL_SPP, report, "shard_tail",
        expect(k1=2 * MAX_BOUNCES * frames, k2=MAX_BOUNCES * frames))
    if r.frame_index != SHARD_TAIL_SPP:
        raise AssertionError("the padded tail did not land on the spp")
    against_single(hdr, tail_ref, r.stats(), one.stats(),
                   f"2x2 mesh, {SHARD_TAIL_SPP} spp ({frames} shard frames, "
                   "the padded ones weighing 0)")
    del r, one

    # The command line's --multichip, and devices=True on this host.
    with tempfile.TemporaryDirectory() as tmp:
        png = os.path.join(tmp, "multichip.png")
        cli_main("render", "cornell", "--spp", str(SHARD_CLI_SPP),
                 "--multichip", "-o", png)
        c = cli_renderer(cornell_box())
        c.render(spp=SHARD_CLI_SPP)
        c.save_png(os.path.join(tmp, "renderer.png"))
        same_png(png, os.path.join(tmp, "renderer.png"),
                 "cli render --multichip's PNG against the Renderer's")
    cards = torch.cuda.device_count()
    every = Renderer(RenderConfig(width=SIZE, height=SIZE), device="cuda",
                     devices=True)
    shape = None if every.mesh is None else every.mesh.shape
    say("shard", f"{cards} card(s): devices=True takes "
        f"{'the single-device path' if shape is None else shape}")
    if (shape is None) != (cards == 1):
        raise AssertionError("devices=True must take the single-device path "
                             "on one card and a mesh on more")
    out["cards"] = cards


def wide_tables(wb, dev):
    """``build_wide_bvh``'s tables uploaded as the walk reads them."""
    return K3.walk_tables({
        "walk_order": torch.from_numpy(wb.order).to(dev),
        "walk_boxes": torch.from_numpy(wb.boxes).to(dev),
        "walk_tris": torch.from_numpy(wb.tris).to(dev)})


def phase_wide16(dev, smi, report, large: dict):
    """The 16-wide walk on the large box (``large_sets``): the width-16
    ("ffd") and the width-8 "slice" collapses built in NumPy; K3-w16, and
    K3 on the slice tables, against their plain versions on the camera,
    bounce-1 and shadow-0 rays, bit for bit, and against width-8 K3 on the
    scene's own tables; their times, the bound; a 1-spp render through
    ``make_closest_hit`` on the width-16 tables against its plain path."""
    scene_np, scene, w8 = large["scene_np"], large["scene"], large["tables"]
    nt = scene_np.num_triangles
    tri = scene["tri_isect"].cpu().numpy()[:nt]
    for line in kernel_resources(cuda_lib.build_log()):
        if "team_walk_kernel" in line:
            say("wide16", f"ptxas: {line}; a team of {K3.TEAM} lanes a ray, "
                f"its stack {K3.STACK_BYTES[16]} B of dynamic shared memory "
                "a tree level a block")
            report.setdefault("k3_w16", {})["ptxas"] = line
    args = (scene_np.bvh_aabb_min, scene_np.bvh_aabb_max, scene_np.bvh_meta,
            tri)
    trees = {}
    for name, pack, width in (("ffd-8", "ffd", 8), ("ffd-16", "ffd", 16),
                              ("slice-8", "slice", 8)):
        t0 = time.perf_counter()
        wb = bvh8.build_wide_bvh(*args, pack=pack, width=width,
                                 prefer_native=False)
        secs = time.perf_counter() - t0
        trees[name] = wb
        say("wide16", f"{name} collapse in NumPy: {secs:.3f} s, "
            f"{wb.num_nodes} wide nodes, {wb.num_groups} leaf groups, depth "
            f"{bvh8.wide_depth(wb.meta)}")
        report.setdefault("wide16", {})[name] = {
            "numpy_seconds": secs, "nodes": wb.num_nodes,
            "groups": wb.num_groups, "depth": bvh8.wide_depth(wb.meta)}
    if not np.array_equal(trees["ffd-8"].order, w8.order.cpu().numpy()):
        raise AssertionError("the NumPy ffd collapse is not the scene's")
    tables = {"w16": wide_tables(trees["ffd-16"], dev),
              "slice": wide_tables(trees["slice-8"], dev), "w8": w8}
    n = large["rays"].shape[1]
    visits = {}
    for key in ("w16", "slice"):
        tb = tables[key]
        for name, r, extra in large["cases"]:
            o, d = r[0:3], r[3:6]
            before = K3.Counter.wide
            kt, ki = K3.closest_hit_walk(tb, o, d, num_tris=nt, **extra)
            if K3.Counter.wide - before != int(key == "w16"):
                raise AssertionError("the launch went to the wrong width")
            visits[key, name] = {}
            pt, pi = K3.closest_hit_walk_plain(tb, o, d, num_tris=nt,
                                               visits=visits[key, name],
                                               **extra)
            same_hits((kt, ki), (pt, pi), f"K3 ({key}) on the {name} rays")
            wt, wi = K3.closest_hit_walk(w8, o, d, num_tris=nt, **extra)
            if "any_hit" in extra:
                # Any hit below the limit answers: the occlusion answers
                # must agree, not the hit found.
                apart = (kt < extra["t_max"]) != (wt < extra["t_max"])
                agree = f"{int(apart.sum())} occlusion answers differ"
                bad = bool(apart.any())
            else:
                apart = (ki != wi) | (kt != wt)
                agree = (f"{int(apart.sum())} lanes differ, every one an "
                         f"exact-t tie: "
                         f"{'no' if bool((kt != wt).any()) else 'yes'}")
                bad = int(apart.sum()) > 0.01 * n
            say("wide16", f"{key} tables, {name} rays: K3 equals its plain "
                f"version on all {n} lanes ({int((pi >= 0).sum())} hits); "
                f"against width-8 K3 {agree}; a ray: "
                + ", ".join(f"{visits[key, name][k] / n:.2f} {k}"
                            for k in ("interior", "leaf", "children",
                                      "triangles")))
            if bad:
                raise AssertionError(f"{key} and width-8 K3 disagree on the "
                                     f"{name} rays")
    # Device ms a call, the three trees in turns, in one process.
    times = {}
    for name, r, extra in large["cases"]:
        o, d = r[0:3], r[3:6]
        for key in ("w8", "w16", "slice", "w16", "w8"):
            ms = device_ms(lambda: K3.closest_hit_walk(
                tables[key], o, d, num_tris=nt, **extra))
            times.setdefault(name, {}).setdefault(key, []).append(ms)
        say("wide16", f"{name} rays, device ms a call (CUDA graph replay): "
            + ", ".join(f"{key} {' / '.join(f'{v:.4f}' for v in vs)}"
                        for key, vs in times[name].items()))
    o, d = large["rays"][0:3], large["rays"][3:6]
    plain = eager_ms(lambda: K3.closest_hit_walk_plain(tables["w16"], o, d,
                                                       num_tris=nt), reps=1)
    for name, _, _ in large["cases"]:
        nb, ops = walk_bound(visits["w16", name], tables["w16"], n)
        say("wide16", f"K3-w16 bound at {n} {name} rays: "
            f"{nb['bound_ms']:.4f} ms ({nb['bound_by']}; {ops / 1e9:.3f} "
            f"Gop)")
    b, _ = walk_bound(visits["w16", "camera"], tables["w16"], n)
    say("wide16", f"K3-w16 plain at {n} camera rays: {plain:.4f} ms on "
        f"{smi}")

    # A 1-spp render through make_closest_hit on the width-16 tables.
    s16 = dict(scene, walk_order=tables["w16"].order,
               walk_boxes=tables["w16"].boxes, walk_tris=tables["w16"].tris)
    closest_hit = make_closest_hit(s16, "walk")
    cam = camera_device(Camera(width=WIDE16_SIZE, height=WIDE16_SIZE)
                        .as_pytree(), WIDE16_SIZE, WIDE16_SIZE)
    kw = dict(n_frames=1, width=WIDE16_SIZE, height=WIDE16_SIZE,
              use_dof=True, max_bounces=MAX_BOUNCES, do_mis=True,
              num_lights=scene_np.num_lights, firefly_clamp=2.5)
    images = []
    torch.cuda.synchronize()
    reset_counts()
    for trace_fn, ch in ((K2.trace_cuda, closest_hit),
                         (TRACE.trace, plain_closest_hit(s16, "walk"))):
        accum = torch.zeros((WIDE16_SIZE * WIDE16_SIZE, 3), device=dev)
        render_chunk(trace_fn, ch, s16, cam, accum, 0, **kw)
        images.append(accum.cpu().numpy())
        if trace_fn is K2.trace_cuda:
            counts = launch_counts()
    if counts != expect(k2=MAX_BOUNCES, k3=2 * MAX_BOUNCES,
                        k3_w16=2 * MAX_BOUNCES):
        raise AssertionError(f"wide16 render: launches {counts}")
    report.setdefault("k3_w16", {})["launches_by_path"] = {
        "wide16": counts["k3_w16"]}
    same_image(images[0].reshape(WIDE16_SIZE, WIDE16_SIZE, 3),
               images[1].reshape(WIDE16_SIZE, WIDE16_SIZE, 3),
               f"{WIDE16_SIZE}x{WIDE16_SIZE} x 1 spp of the large box "
               "through make_closest_hit on the width-16 tables (K3-w16 "
               f"{counts['k3_w16']} launches) against its plain path",
               "wide16")
    cam_ms = times["camera"]
    report["k3_w16"].update(
        launches=counts["k3_w16"], max_abs_err=0.0,
        ms=float(np.mean(cam_ms["w16"])), plain_ms=plain,
        w8_ms=float(np.mean(cam_ms["w8"])),
        slice_ms=float(np.mean(cam_ms["slice"])), times_ms=times,
        visits_per_ray={f"{k}/{name}": {kk: v / n for kk, v in vis.items()}
                        for (k, name), vis in visits.items()}, **b)


def short(kernel_name: str) -> str:
    """A device event's name without namespaces, arguments and templates."""
    name = kernel_name.replace("(anonymous namespace)::", "")
    return name.split("(")[0].split("<")[0][:48]


def kernel_split(fn, reps: int = 5) -> dict:
    """Device ms a call of ``fn`` spends in each kernel it launches, by the
    kernel's short name, from ``torch.profiler``'s device events over
    ``reps`` calls (after one profiled warm-up call: the tracer's
    start-up)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch_profile(activities=activities):
        fn()
        torch.cuda.synchronize()
    with torch_profile(activities=activities) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = short(e.name)
            by_name[name] = (by_name.get(name, 0.0)
                             + e.time_range.elapsed_us() / 1e3 / reps)
    return by_name


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
    cats = sum(e.name == "aten::cat" for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CPU)
    cat_ms = sum(us for name, us in by_name.items() if "CatArray" in name) / 1e3
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(prof.key_averages().table(sort_by="self_cuda_time_total",
                                          row_limit=60))
    say(phase, f"profile of {frames} frames: wall {wall_ms:.3f} ms unprofiled, "
        f"device busy {busy_ms:.3f} ms in {len(device)} device events "
        f"({100 * busy_ms / wall_ms:.1f}% of the wall); torch.cat "
        f"{cats / frames:g} calls a frame, {cat_ms:.3f} ms of device time; "
        "top: " + ", ".join(f"{short(name)} {us / 1e3:.3f} ms"
                            for name, us in top))


def profile_call(fn, path: str, phase: str) -> dict:
    """``torch.profiler``'s table of one call of ``fn`` to ``path``: its
    wall unprofiled, the device's busy time and share of it, and the four
    kernels with the most device time."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch_profile(activities=activities):  # the tracer's start-up
        fn()
        torch.cuda.synchronize()
    _, wall = timed(fn)
    with torch_profile(activities=activities) as prof:
        fn()
        torch.cuda.synchronize()
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in device) / 1e3
    by_name: dict = {}
    for e in device:
        by_name[short(e.name)] = (by_name.get(short(e.name), 0.0)
                                  + e.time_range.elapsed_us() / 1e3)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(prof.key_averages().table(sort_by="self_cuda_time_total",
                                          row_limit=60))
    say(phase, f"profile of one call: wall {wall * 1e3:.3f} ms unprofiled, "
        f"device busy {busy_ms:.3f} ms in {len(device)} device events "
        f"({100 * busy_ms / (wall * 1e3):.1f}% of the wall); top: "
        + ", ".join(f"{name} {ms:.3f} ms" for name, ms in top))
    return {"wall_ms": wall * 1e3, "busy_ms": busy_ms,
            "device_events": len(device), "top": top}


# The phases in their order; "k3" and "dispatch" share the large box's
# scene and rays (``large_sets``).
PHASES = ("k1", "k2", "k2_tex", "oracle", "main", "textured", "k3", "wide16",
          "large", "dispatch", "dispatch_paths", "big", "k2_lds",
          "rng_paths", "gltf", "env", "bvh2", "debug", "denoise", "adaptive",
          "native", "cli", "shard")
# The phases that share the large box (``large_sets``).
LARGE_USERS = ("k3", "dispatch", "bvh2", "debug", "adaptive", "wide16")
# The keys every kernel's entry in the kernels line carries.
KERNEL_KEYS = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
               "bound_by", "library_ms")


def kernels_line(report: dict, complete: bool) -> list:
    """Every kernel's entry; with ``complete`` each must carry
    ``KERNEL_KEYS`` (a run of some phases keeps the entries it filled)."""
    pkg = "wgpu_path_tracing_tpu_torch"
    ref = "wgpu_path_tracing_tpu/ops"
    bounce = f"{pkg}/csrc/bounce.cu"
    kernels = [
        {"name": "dense_hit", "route": "cuda", "source": f"{pkg}/csrc/dense_hit.cu",
         "replaces": f"{ref}/pallas_kernels.py:38", **report.get("k1", {})},
        {"name": "bounce", "route": "cuda", "source": bounce,
         "replaces": f"{ref}/pallas_bounce.py:412", **report.get("k2", {})},
        # Textured K2: one kernel, two texture modes, each replacing the TPU
        # kernel's sampler and the "external" texel pre-gather
        # (_gather_texels, pallas_bounce.py:358) of its mode.
        {"name": "bounce_tex_slot", "route": "cuda", "source": bounce,
         "replaces": f"{ref}/pallas_bounce.py:258",
         "also_replaces": f"{ref}/pallas_bounce.py:358",
         **report.get("k2_per_slot", {})},
        {"name": "bounce_tex_fat", "route": "cuda", "source": bounce,
         "replaces": f"{ref}/pallas_bounce.py:288",
         "also_replaces": f"{ref}/pallas_bounce.py:358",
         **report.get("k2_fat", {})},
        # K2's bounce-0 LDS instantiation (the TPU kernel's has_lds operand).
        {"name": "bounce_lds", "route": "cuda", "source": bounce,
         "replaces": f"{ref}/pallas_bounce.py:440", **report.get("k2_lds", {})},
        # K2's ENV instantiation: the miss term that the JAX package runs in
        # XLA only (ops/trace.py:104-108), sampled by ops/env.py:26.
        {"name": "bounce_env", "route": "cuda", "source": bounce,
         "replaces": f"{ref}/trace.py:104", "also_replaces": f"{ref}/env.py:26",
         **report.get("k2_env", {})},
        {"name": "walk", "route": "cuda", "source": f"{pkg}/csrc/walk.cu",
         "replaces": f"{ref}/walk.py:177", **report.get("k3", {})},
        # K3's width-16 instantiation: the same TPU kernel at the width
        # closest_hit_walk infers from the order table (walk.py:684).
        {"name": "walk_w16", "route": "cuda", "source": f"{pkg}/csrc/walk.cu",
         "replaces": f"{ref}/walk.py:177", "also_replaces": f"{ref}/walk.py:684",
         **report.get("k3_w16", {})},
        {"name": "pairs", "route": "cuda", "source": f"{pkg}/csrc/pairs.cu",
         "replaces": f"{ref}/pairs.py:108", **report.get("k4", {})},
        # Phase 1 of K4 and K6: the XLA scans ahead of the two TPU kernels.
        {"name": "block_entry", "route": "cuda",
         "source": f"{pkg}/csrc/blocks.cu",
         "replaces": f"{ref}/pairs.py:307",
         "also_replaces": f"{ref}/cluster.py:239",
         **report.get("block_entry", {})},
        {"name": "phased", "route": "cuda", "source": f"{pkg}/csrc/phased.cu",
         "replaces": f"{ref}/phased.py:70", **report.get("k5", {})},
        {"name": "cluster", "route": "cuda",
         "source": f"{pkg}/csrc/cluster.cu",
         "replaces": f"{ref}/cluster.py:73", **report.get("k6", {})},
        # K7-K9 replace functions the JAX package leaves to XLA: the two
        # binary-BVH walks (K7's depth mode the debug view's walk too) and
        # one level of the denoiser's filter.
        {"name": "bvh_stack", "route": "cuda", "source": f"{pkg}/csrc/bvh2.cu",
         "replaces": f"{ref}/intersect.py:136",
         "also_replaces": "wgpu_path_tracing_tpu/debug/modes.py:46",
         **report.get("k7", {})},
        {"name": "bvh_linked", "route": "cuda",
         "source": f"{pkg}/csrc/bvh2.cu",
         "replaces": f"{ref}/intersect.py:233", **report.get("k8", {})},
        {"name": "atrous", "route": "cuda", "source": f"{pkg}/csrc/atrous.cu",
         "replaces": f"{ref}/denoise.py:177", **report.get("k9", {})},
    ]
    full = [k for k in kernels if all(key in k for key in KERNEL_KEYS)]
    if complete and len(full) != len(kernels):
        missing = [k["name"] for k in kernels if k not in full]
        raise AssertionError(f"kernels without all their numbers: {missing}")
    return full


def kernel_resources(log: str) -> list:
    """One line a compiled function from ptxas' ``-v`` report: its name
    (demangled where ``c++filt`` is at hand), registers, stack frame,
    spill bytes and static shared memory."""
    entries, current = {}, None
    for line in log.splitlines():
        if "Function properties for " in line:
            current = line.split("Function properties for ")[1].strip()
            entries.setdefault(current, {})
        elif current and "bytes stack frame" in line:
            nums = [int(w) for w in line.replace(",", " ").split()
                    if w.isdigit()]
            entries[current].update(stack=nums[0], spill_stores=nums[1],
                                    spill_loads=nums[2])
        elif current and re.search(r"Used \d+ registers", line):
            entries[current]["registers"] = int(
                re.search(r"Used (\d+) registers", line).group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            entries[current]["smem"] = int(smem.group(1)) if smem else 0
    names = list(entries)
    demangle = shutil.which("c++filt")
    if demangle and names:
        out = subprocess.run([demangle], input="\n".join(names),
                             capture_output=True, text=True, timeout=60)
        if out.returncode == 0 and len(out.stdout.splitlines()) == len(names):
            names = out.stdout.splitlines()
    return [f"{name.replace('(anonymous namespace)::', '')}: "
            f"{e.get('registers', '-')} registers, {e.get('stack', '-')} B "
            f"stack frame, {e.get('spill_stores', '-')} B spill stores, "
            f"{e.get('spill_loads', '-')} B spill loads, "
            f"{e.get('smem', '-')} B static shared memory"
            for name, e in zip(names, entries.values())]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", metavar="PATH",
                        help="also write torch.profiler tables of four "
                        "main-path, textured-flagship, large-scene, "
                        "pair-dispatch, stratified, loaded-atrium and env-box "
                        "frames to PATH and PATH with _textured, _large, "
                        "_pairs, _stratified, _gltf and _env before its "
                        "extension")
    parser.add_argument("--phases", metavar="NAME,...",
                        help="run only these phases, of: " + ", ".join(PHASES))
    args = parser.parse_args()
    wanted = PHASES if args.phases is None else tuple(args.phases.split(","))
    unknown = set(wanted) - set(PHASES)
    if unknown:
        raise SystemExit(f"chip_smoke: unknown phases {sorted(unknown)}")
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
    for line in kernel_resources(cuda_lib.build_log()):
        say("build", line)

    report: dict = {}
    profile = args.profile
    large: dict = {}

    def large_box() -> dict:
        # Built once, for LARGE_USERS; dropped after the last of them.
        if not large:
            large.update(large_sets(dev))
        return large

    phases = {
        "k1": lambda: phase_k1(dev, report),
        "k2": lambda: phase_k2(dev, report),
        "k2_tex": lambda: phase_k2_tex(dev, report),
        "oracle": lambda: phase_oracle(dev),
        "main": lambda: phase_main(dev, smi, report, profile),
        "textured": lambda: phase_textured(dev, smi, report, profile),
        "k3": lambda: phase_k3(dev, report, large_box()),
        "large": lambda: phase_large(dev, smi, report, profile),
        "dispatch": lambda: phase_dispatch(dev, report, large_box()),
        "dispatch_paths": lambda: phase_dispatch_paths(dev, smi, report,
                                                       profile),
        "big": lambda: phase_big(dev, smi, report),
        "k2_lds": lambda: phase_k2_lds(dev, report),
        "rng_paths": lambda: phase_rng_paths(dev, smi, report, profile),
        "gltf": lambda: phase_gltf(dev, smi, report, profile),
        "env": lambda: phase_env(dev, smi, report, profile),
        "bvh2": lambda: phase_bvh2(dev, report, large_box()),
        "debug": lambda: phase_debug(dev, smi, report, large_box()),
        "denoise": lambda: phase_denoise(dev, smi, report, profile),
        "adaptive": lambda: phase_adaptive(dev, smi, report, large_box(),
                                           profile),
        "native": lambda: phase_native(dev, smi, report),
        "cli": lambda: phase_cli(dev, smi, report),
        "shard": lambda: phase_shard(dev, smi, report),
        "wide16": lambda: phase_wide16(dev, smi, report, large_box()),
    }
    t_start = time.perf_counter()
    last_large = [p for p in PHASES if p in wanted and p in LARGE_USERS]
    for phase in PHASES:
        if phase not in wanted:
            continue
        t_phase = time.perf_counter()
        phases[phase]()
        if last_large and phase == last_large[-1]:
            large.clear()
        say("done", f"phase {phase} in {time.perf_counter() - t_phase:.1f} s")

    kernels = kernels_line(report, complete=wanted == PHASES)
    say("done", f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    paths = ("main", *(path for path, _, _ in TEXTURED), "large", *DISPATCH,
             "big",
             "stratified", "hash", "frames_per_trace", "checkpoint", "gltf",
             "env", "debug", "denoise", "adaptive", "native", "cli", "shard",
             "wide16")
    print(json.dumps({"kernels": kernels,
                      **{path: report[path] for path in paths
                         if path in report},
                      "nvidia_smi": smi}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
