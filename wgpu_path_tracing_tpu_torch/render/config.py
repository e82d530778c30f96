"""Runtime configuration.

The reference path tracer hardcodes these as shader constants; the JAX
package promoted them to ``RenderConfig`` (``wgpu_path_tracing_tpu/render/
config.py``). This is the same object restricted to what the torch port
renders: untextured and textured scenes (the atlas sampled per slot or from
the fat canvas, as the scene's packing decides), glTF files, environment
maps, the three rng modes, the debug views, the dense hit, the wide-BVH
walk, the three dispatch intersectors and the two binary-BVH walks. The
device is the ``Renderer``'s argument (the card by default):

* ``max_bounces`` — pt.wgsl:5 (MAX_BOUNCES = 8)
* ``do_mis`` — pt.wgsl:636 (DO_MIS = true)
* ``firefly_clamp`` — pt.wgsl:751 (min(trace(ray), vec3f(2.5)))
* ``exposure`` — blit.wgsl:43 (applied as x exp2(EXPOSURE))
* ``texture_pixel_ratio`` — atlas.ts:10 (each glTF texture scaled by 0.5
  into the atlas)
* ``spot_lights`` — read KHR spot lights from glTF files instead of the
  reference's warning and skip (gpu.ts:234-236); off, as there
* ``max_leaf_size`` / ``num_bins`` — bvh.ts:42-45 (the SAH build's
  BuildOptions, 4 and 12), for scenes that ``load_model`` builds
* ``env_map`` / ``env_intensity`` / ``env_rotation`` — the JAX package's
  environment map (``ops/env.py``): a .hdr, .exr or PNG path that
  ``load_scene`` installs, its scale and its yaw in radians; None keeps the
  reference's black background (pt.wgsl:646-649). On the card K2's ``ENV``
  instantiation adds the map's texel on a miss
* ``rng`` — "reference" (random.wgsl's per-pixel PCG, with its seed
  collisions past 1000 pixels a row), "hash" (the same draws from a
  well-mixed seed) or "stratified" (the hash seed, plus R2 low-discrepancy
  points for the pixel jitter and the lens disc and, at bounce 0, for the
  BSDF's lobe pick and direction: K2's LDS instantiation)
* ``intersector`` — "auto", "brute", "walk", "walk_hbm", "pairs",
  "phased", "cluster", "stack" or "bvh". "auto" takes the dense intersector (K1) for
  scenes of at most ``brute_force_max_tris`` triangles; above, the wide-BVH
  walk (K3), or the pair dispatch (K4) for a scene whose wide tree is too
  deep for the walk. The others force one: "pairs" K4, "phased" the phased
  group dispatch (K5), "cluster" the round dispatch (K6), "stack" the
  binary BVH with a stack per ray (K7), "bvh" the same tree over its hit
  and miss links (K8); "walk" and "phased" fall to K4 for a scene without
  walk tables. "walk_hbm", the JAX package's paged walk (a TPU residency
  mode with the resident walk's results), runs as "walk" and reports its
  own name.
* ``mode`` — "pt" (the path tracer), or one of the debug views of
  ``debug/modes.py``: "bvh_depth" (the binary BVH's stack depth a pixel,
  K7's depth mode) or "normal" (the primary hit's shading normal).
  ``Renderer.render`` returns the debug view in their place.
* ``frames_per_chunk`` — frames a ``render`` call draws between two
  ``on_chunk`` reports
* ``frames_per_trace`` — frames whose rays go into one trace call (F x the
  pixel count of lanes); the image is bit-identical to F = 1's except the
  razor-tie class, as the JAX package words it: on the pair route a call of
  16,384 lanes or more packs and sorts the F frames' lanes together, and
  K4 settles an exact-t tie in its 1,024-lane blocks' visit order
  (``tests/test_torch_fpt.py`` shows F = 2 equal to 1 where it does so).
  The renderer clamps it per chunk with gcd, so any spp works.

* ``bounce_kernel`` — the bounce loop (``render/pipeline.py::
  make_trace_fn``): "auto" and "pallas" run K2 (``ops/bounce.py::
  trace_cuda``) on the card and its plain version on the CPU; "xla" runs
  the plain bounce (``ops/trace.py::trace``) on either device. Under an
  environment map "pallas" stays K2 (its ``ENV`` instantiation), where the
  JAX package falls back to XLA with a warning.

``max_frames``, ``move_speed``, ``rotate_speed`` and ``dtype`` are the JAX
package's fields that nothing outside its config reads; they are here so
that ``RenderConfig(**dataclasses.asdict(jax_config))`` constructs, and
nothing here reads them either (``render/controller.py`` moves at its own
MOVE_SPEED and ROTATE_SPEED, as the JAX package's does).
"""

from __future__ import annotations

import dataclasses
import math

from wgpu_path_tracing_tpu_torch.ops.intersect import check_intersector

RNG_MODES = ("reference", "hash", "stratified")
MODES = ("pt", "bvh_depth", "normal")
BOUNCE_KERNELS = ("auto", "pallas", "xla")


@dataclasses.dataclass
class RenderConfig:
    width: int = 512
    height: int = 512

    max_bounces: int = 8
    do_mis: bool = True
    firefly_clamp: float = 2.5
    exposure: float = 1.0
    max_frames: int = -1  # renderer.ts:16; read nowhere

    # Scene ingestion (atlas.ts, gpu.ts) and the BVH build (bvh.ts).
    texture_pixel_ratio: float = 0.5
    spot_lights: bool = False
    max_leaf_size: int = 4
    num_bins: int = 12

    # controller.ts:3-4; read nowhere (render/controller.py has its own).
    move_speed: float = 2.0
    rotate_speed: float = math.pi / 18

    # The environment map (ops/env.py); None: misses are black.
    env_map: str | None = None
    env_intensity: float = 1.0
    env_rotation: float = 0.0

    rng: str = "reference"
    intersector: str = "auto"
    bounce_kernel: str = "auto"
    brute_force_max_tris: int = 4096
    frames_per_chunk: int = 16
    frames_per_trace: int = 1
    dtype: str = "float32"  # read nowhere

    # The debug views (ports of pt_bvh.wgsl and pt_debug.wgsl).
    mode: str = "pt"

    def validate(self) -> "RenderConfig":
        if self.width <= 0 or self.height <= 0:
            raise ValueError(f"bad image size {self.width}x{self.height}")
        if self.rng not in RNG_MODES:
            raise ValueError(f"rng={self.rng!r}: expected one of {RNG_MODES}")
        if self.frames_per_chunk < 1 or self.frames_per_trace < 1:
            raise ValueError("frames_per_chunk and frames_per_trace must be "
                             ">= 1")
        check_intersector(self.intersector)
        if self.bounce_kernel not in BOUNCE_KERNELS:
            raise ValueError(f"bounce_kernel={self.bounce_kernel!r}: expected "
                             f"one of {BOUNCE_KERNELS}")
        if self.mode not in MODES:
            raise ValueError(f"mode={self.mode!r}: expected one of {MODES}")
        return self
