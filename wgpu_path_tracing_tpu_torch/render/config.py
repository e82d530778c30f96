"""Runtime configuration.

The reference path tracer hardcodes these as shader constants; the JAX
package promoted them to ``RenderConfig`` (``wgpu_path_tracing_tpu/render/
config.py``). This is the same object restricted to what the torch port
renders; the device is the ``Renderer``'s argument:

* ``max_bounces`` — pt.wgsl:5 (MAX_BOUNCES = 8)
* ``do_mis`` — pt.wgsl:636 (DO_MIS = true)
* ``firefly_clamp`` — pt.wgsl:751 (min(trace(ray), vec3f(2.5)))
* ``exposure`` — blit.wgsl:43 (applied as x exp2(EXPOSURE))
* ``rng`` — only "reference" (random.wgsl's per-pixel PCG) is ported
* ``intersector`` — "auto" or "brute": the dense intersector, for scenes of
  at most ``brute_force_max_tris`` triangles
"""

from __future__ import annotations

import dataclasses


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
        if self.intersector not in ("auto", "brute"):
            raise NotImplementedError(
                f"intersector={self.intersector!r}: only the dense intersector "
                "is ported")
        return self
