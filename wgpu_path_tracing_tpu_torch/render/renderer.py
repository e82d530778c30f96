"""Renderer: the headless counterpart of the reference's class Renderer
(renderer.ts:18-511) and of the JAX package's ``render/renderer.py``.

    r = Renderer(RenderConfig(width=512, height=512))   # device="cuda"
    r.load_scene(textured_cornell())
    hdr = r.render(spp=64)        # progressive; r.reset(), r.move_camera()
    r.save_png("out.png"); r.stats()

A plain class, no ``nn.Module``: there are no weights. The HDR buffer and the
scene tables live on ``device``, the card unless the caller asks for
``device="cpu"``. On "cuda" the frame runs the hand-written kernels K1
(dense closest hit), K3 (wide-BVH walk), K4 (pair dispatch), K5 (phased
dispatch) or K6 (round dispatch), as ``RenderConfig.intersector`` picks for
the scene (``stats()["intersector"]`` says which), and K2 (bounce, untextured or sampling the scene's
texture atlas per slot or from its fat canvas); on "cpu" their plain
PyTorch versions. Asking for "cuda" without a card raises.

Not ported here: glTF loading, async load, denoising, adaptive sampling,
debug modes, environment maps, multi-device rendering.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from wgpu_path_tracing_tpu_torch.models.types import (
    SceneArrays,
    load_jax_scene,
    pack_device_scene,
)
from wgpu_path_tracing_tpu_torch.ops.bounce import texture_mode, trace_cuda
from wgpu_path_tracing_tpu_torch.ops.intersect import make_closest_hit
from wgpu_path_tracing_tpu_torch.ops.trace import scene_atlas
from wgpu_path_tracing_tpu_torch.render import pipeline
from wgpu_path_tracing_tpu_torch.render.camera import Camera
from wgpu_path_tracing_tpu_torch.render.config import RenderConfig
from wgpu_path_tracing_tpu_torch.utils import image as imageio
from wgpu_path_tracing_tpu_torch.utils.tiling import (
    inverse_permutation,
    tile_permutation,
)


def resolve_device(device) -> torch.device:
    """The torch device for a config; "cuda" without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device='cuda' requested but CUDA is not available")
        # No matmul is on the render path; keep full float32 should one come.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev


class Renderer:
    def __init__(self, config: RenderConfig | None = None,
                 camera: Camera | None = None, device="cuda"):
        self.config = (config or RenderConfig()).validate()
        self.device = resolve_device(device)
        self.camera = camera or Camera(
            width=self.config.width, height=self.config.height,
            aspect=self.config.width / self.config.height)
        self.scene: SceneArrays | None = None
        self._scene_dev: dict | None = None
        self._closest_hit = None
        self._accum: torch.Tensor | None = None
        self.frame_index = 0
        self._counters = np.zeros(2, np.int64)
        self._last_counters = np.zeros(2, np.int64)
        self._last_render_seconds = 0.0

    # --- scene ---------------------------------------------------------------
    def load_scene(self, scene: SceneArrays) -> None:
        scene_dev = load_jax_scene(pack_device_scene(scene), self.device)
        self._closest_hit = make_closest_hit(
            scene_dev, self.config.intersector,
            self.config.brute_force_max_tris)
        self.scene, self._scene_dev = scene, scene_dev
        self.reset()

    # --- interaction (renderer.ts:152-201) -----------------------------------
    def move_camera(self, forward: float, right: float, up: float) -> None:
        self.camera.move(forward, right, up)
        self.reset()

    def rotate_camera(self, yaw: float, pitch: float) -> None:
        self.camera.rotate(yaw, pitch)
        self.reset()

    def reset(self) -> None:
        """resetOutputBuffer (renderer.ts:357-366): restart accumulation."""
        self.frame_index = 0
        self._counters = np.zeros(2, np.int64)

    # --- rendering -----------------------------------------------------------
    def _ensure_accum(self) -> None:
        n = self.config.width * self.config.height
        if self._accum is None or self._accum.shape[0] != n:
            self._accum = torch.zeros((n, 3), dtype=torch.float32,
                                      device=self.device)

    def render(self, spp: int, fetch: bool = True):
        """Accumulate ``spp`` more samples per pixel. Returns the HDR buffer
        as (H, W, 3) NumPy (row 0 = bottom of the view), or None with
        ``fetch=False``."""
        if self._scene_dev is None:
            raise RuntimeError("No scene loaded — call load_scene first")
        cfg = self.config
        self._ensure_accum()
        cam = pipeline.camera_device(self.camera.as_pytree(), cfg.width,
                                     cfg.height)
        t0 = time.perf_counter()
        _, counters = pipeline.render_chunk(
            trace_cuda, self._closest_hit, self._scene_dev, cam, self._accum,
            self.frame_index,
            n_frames=spp, width=cfg.width, height=cfg.height,
            use_dof=float(self.camera.aperture) > 0.0,
            max_bounces=cfg.max_bounces, do_mis=cfg.do_mis,
            num_lights=self.scene.num_lights,
            firefly_clamp=cfg.firefly_clamp)
        # The counter read waits for the device, so the wall clock is honest.
        self._last_counters = counters.cpu().numpy().astype(np.int64)
        self._last_render_seconds = time.perf_counter() - t0
        self._counters = self._counters + self._last_counters
        self.frame_index += spp
        if not fetch:
            return None
        return self._row_major().reshape(cfg.height, cfg.width, 3)

    def _row_major(self) -> np.ndarray:
        """The tile-ordered buffer as row-major (N, 3) NumPy."""
        perm = tile_permutation(self.config.width, self.config.height)
        return self._accum.cpu().numpy()[inverse_permutation(perm)]

    # --- output --------------------------------------------------------------
    def image(self) -> np.ndarray:
        """Tonemapped display image (H, W, 3) in [0, 1], top row first."""
        if self._accum is None:
            raise RuntimeError("Nothing rendered yet")
        return imageio.buffer_to_srgb(self._row_major(), self.config.width,
                                      self.config.height, self.config.exposure)

    def save_png(self, path: str) -> None:
        imageio.write_png(path, self.image())

    def save_hdr(self, path: str) -> None:
        """The LINEAR accumulation as Radiance RGBE .hdr (no tonemap)."""
        if self._accum is None:
            raise RuntimeError("Nothing rendered yet")
        hdr = self._row_major().reshape(self.config.height, self.config.width, 3)
        imageio.write_hdr(path, np.nan_to_num(hdr[::-1], nan=0.0))

    def stats(self) -> dict:
        closest, shadow = (int(c) for c in self._counters)
        last_total = int(self._last_counters.sum())
        secs = max(self._last_render_seconds, 1e-9)
        return {
            "frame_index": self.frame_index,
            "device": str(self.device),
            "intersector": getattr(self._closest_hit, "strategy", None),
            # How K2 samples the scene's atlas: "none", "per_slot" or "fat".
            "texture": (None if self._scene_dev is None
                        else texture_mode(scene_atlas(self._scene_dev)[0])),
            "rays_closest": closest,
            "rays_shadow": shadow,
            "rays_total": closest + shadow,
            "last_render_seconds": self._last_render_seconds,
            "mrays_per_sec": last_total / secs / 1e6 if last_total else 0.0,
        }
