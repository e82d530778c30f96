"""Runtime configuration.

The reference path tracer hardcodes these as shader constants; the JAX
package promoted them to ``RenderConfig`` (``wgpu_path_tracing_tpu/render/
config.py``). This is the same object restricted to what the torch port
renders: untextured and textured scenes (the atlas sampled per slot or from
the fat canvas, as the scene's packing decides), reference rng, the dense
hit, the wide-BVH walk and the three dispatch intersectors. The device is
the ``Renderer``'s argument (the card by default):

* ``max_bounces`` — pt.wgsl:5 (MAX_BOUNCES = 8)
* ``do_mis`` — pt.wgsl:636 (DO_MIS = true)
* ``firefly_clamp`` — pt.wgsl:751 (min(trace(ray), vec3f(2.5)))
* ``exposure`` — blit.wgsl:43 (applied as x exp2(EXPOSURE))
* ``rng`` — only "reference" (random.wgsl's per-pixel PCG) is ported
* ``intersector`` — "auto", "brute", "walk", "pairs", "phased" or
  "cluster". "auto" takes the dense intersector (K1) for scenes of at most
  ``brute_force_max_tris`` triangles; above, the wide-BVH walk (K3), or the
  pair dispatch (K4) for a scene whose wide tree is too deep for the walk.
  The others force one: "pairs" K4, "phased" the phased group dispatch (K5),
  "cluster" the round dispatch (K6); "walk" and "phased" fall to K4 for a
  scene without walk tables. The JAX package's "bvh", "stack" and
  "walk_hbm" are not ported and raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses

from wgpu_path_tracing_tpu_torch.ops.intersect import check_intersector


@dataclasses.dataclass
class RenderConfig:
    width: int = 512
    height: int = 512

    max_bounces: int = 8
    do_mis: bool = True
    firefly_clamp: float = 2.5
    exposure: float = 1.0

    rng: str = "reference"
    intersector: str = "auto"
    brute_force_max_tris: int = 4096

    def validate(self) -> "RenderConfig":
        if self.width <= 0 or self.height <= 0:
            raise ValueError(f"bad image size {self.width}x{self.height}")
        if self.rng != "reference":
            raise NotImplementedError(
                f"rng={self.rng!r}: only the 'reference' PCG stream is ported")
        check_intersector(self.intersector)
        return self
