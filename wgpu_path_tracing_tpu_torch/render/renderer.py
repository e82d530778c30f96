"""Renderer: the headless counterpart of the reference's class Renderer
(renderer.ts:18-511) and of the JAX package's ``render/renderer.py``.

    r = Renderer(RenderConfig(width=512, height=512))   # device="cuda"
    r.load_scene(textured_cornell())   # or r.load_model("scene.glb")
    hdr = r.render(spp=64)        # progressive; r.reset(), r.move_camera()
    r.save_png("out.png"); r.save_exr("out.exr"); r.stats()
    r.save_checkpoint("run.npz")  # the JAX package's keys; load_checkpoint
    r.set_environment(env_rgb, intensity=1.0, rotation=0.5)  # lit misses
    future = r.load_model_async("next.glb")  # staged, installed by render
    img = r.image(denoise=True)   # à-trous filter on a copy (ops/denoise.py)
    hdr = r.render_adaptive(64)   # adaptive sampling (render/adaptive.py)
    Renderer(RenderConfig(mode="normal"))   # or "bvh_depth": the debug views
    Renderer(cfg, devices=True)   # every card; or devices=["cuda:0", ...]

A plain class, no ``nn.Module``: there are no weights. The HDR buffer and the
scene tables live on ``device``, the card unless the caller asks for
``device="cpu"``. On "cuda" the frame runs the hand-written kernels K1
(dense closest hit), K3 (wide-BVH walk), K4 (pair dispatch), K5 (phased
dispatch), K6 (round dispatch), K7 (the binary BVH's stack walk) or K8 (its
linked walk), as ``RenderConfig.intersector`` picks for the scene
(``stats()["intersector"]`` says which), and K2 (bounce, untextured or
sampling the scene's texture atlas per slot or from its fat canvas; with rng="stratified" its LDS instantiation at bounce 0; with an
environment map its ENV instantiation); on "cpu" their plain PyTorch
versions. Asking for "cuda" without a card raises.

``render`` draws ``frames_per_chunk`` frames at a time, calling the
``add_on_update`` callbacks before and ``on_chunk`` after each chunk, and
``frames_per_trace`` frames a trace call. ``render(sync=False)`` returns
once the frames are queued; the ray counters stay on the device until
``stats()`` or the next synchronous render reads them. ``profiler``
(``utils/profiler.py``) times each chunk's dispatch a frame
("path-trace-pass", on the host clock: no sync) and ``image()``
("blit-pass"), ``frame_meter`` ticks a frame; ``stats()["passes"]`` and
``stats()["frames"]`` report them.

``load_model_async`` reads a glTF file on a worker thread while the caller
renders on; ``render`` installs the staged scene at its next chunk
boundary (restarting the mean there). A failed load raises from the
returned future and from the next ``poll_pending_scene`` (so the next
``render``), once.

The JAX package's extensions: ``denoise`` (and ``aovs``,
``image(denoise=True)``, ``save_png(denoise=True)``) filters a copy of the
linear accumulation with the edge-avoiding à-trous filter, whose levels are
kernel K9 on the card (``ops/denoise.py``); ``render_adaptive`` spends a
budget of samples on the noisiest pixels after a uniform warmup
(``render/adaptive.py``); ``RenderConfig(mode="normal")`` and
``mode="bvh_depth"`` make ``render`` return a debug view
(``debug/modes.py``; the depth view runs K7 in its depth mode).

``devices`` renders over a ("sample", "row") mesh (``parallel/shard.py``):
``True`` takes every card (or the CPU with ``device="cpu"``) and keeps the
single-device path when there is one; an explicit list always takes the
sharded path, even a list of one (the sharding tax), and may name a device
more than once (each entry a shard that runs there in turn). The scene is
copied to each distinct device, the accumulation is held as row bands, and
``self.device`` is the mesh's first device, where ``aovs``, ``denoise``
and ``render_debug`` run from its copy of the scene, as in the JAX package.
``render_adaptive`` refuses a mesh.
"""

from __future__ import annotations

import concurrent.futures
import math
import threading
import time

import numpy as np
import torch

from wgpu_path_tracing_tpu_torch.models.gltf import load_model
from wgpu_path_tracing_tpu_torch.models.types import (
    SceneArrays,
    load_jax_scene,
    pack_device_scene,
)
from wgpu_path_tracing_tpu_torch.ops import env as ENV
from wgpu_path_tracing_tpu_torch.ops.bounce import texture_mode
from wgpu_path_tracing_tpu_torch.ops.intersect import make_closest_hit
from wgpu_path_tracing_tpu_torch.ops.trace import scene_atlas
from wgpu_path_tracing_tpu_torch.parallel import shard as SH
from wgpu_path_tracing_tpu_torch.render import pipeline
from wgpu_path_tracing_tpu_torch.render.camera import Camera
from wgpu_path_tracing_tpu_torch.render.config import RenderConfig
from wgpu_path_tracing_tpu_torch.utils import image as imageio
from wgpu_path_tracing_tpu_torch.utils.profiler import FrameMeter, PassProfiler
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
                 camera: Camera | None = None, device="cuda", devices=None,
                 sample_shards: int | None = None):
        """``devices``: render over a ("sample", "row") mesh
        (``parallel/shard.py``), a list of devices or True for every card
        of ``device``'s type; ``sample_shards`` the mesh's sample axis
        (``make_mesh``'s default when None). Default: one device."""
        self.config = (config or RenderConfig()).validate()
        self.device = resolve_device(device)
        self.mesh: SH.Mesh | None = None
        if devices is not None and devices is not False:
            every = devices is True
            if every:
                count = (torch.cuda.device_count()
                         if self.device.type == "cuda" else 1)
                devices = ([torch.device("cuda", i) for i in range(count)]
                           if self.device.type == "cuda" else [self.device])
            if len(devices) > 1 or not every:
                self.mesh = SH.make_mesh([resolve_device(d) for d in devices],
                                         sample_shards=sample_shards)
                self.device = self.mesh.devices[0][0]
                self._check_rows(self.config.height)
        self.camera = camera or Camera(
            width=self.config.width, height=self.config.height,
            aspect=self.config.width / self.config.height)
        self.scene: SceneArrays | None = None
        # The scene and its closest hit on each device that renders: the
        # one device, or each distinct device of the mesh. _scene_dev and
        # _closest_hit are the first device's.
        self._scenes: dict = {}
        self._closest_hits: dict = {}
        self._scene_dev: dict | None = None
        self._closest_hit = None
        # The HDR buffer: one tensor, or the mesh's row bands.
        self._accum: torch.Tensor | list | None = None
        self.frame_index = 0
        self._counters = np.zeros(2, np.int64)
        self._last_counters = np.zeros(2, np.int64)
        self._last_render_seconds = 0.0
        # Counters of render(sync=False) calls, summed on the device, and
        # the wall clock's start of that unsynced run.
        self._deferred: torch.Tensor | None = None
        self._deferred_t0: float | None = None
        self._on_update = []
        # load_model_async's staging slot and its failure, guarded by the
        # lock: the worker thread fills them, the render thread empties them.
        self._pending_lock = threading.Lock()
        self._pending_scene: SceneArrays | None = None
        self._pending_error: Exception | None = None
        # Pass timings and the frame meter (profiler.ts, fps-meter.tsx; the
        # labels are renderer.ts:422, 443's).
        self.profiler = PassProfiler()
        self.frame_meter = FrameMeter()

    def _check_rows(self, height: int) -> None:
        rows = self.mesh.shape["row"]
        if height % rows:
            raise ValueError(f"height {height} must divide the row axis "
                             f"{rows}")

    # --- scene ---------------------------------------------------------------
    def load_scene(self, scene: SceneArrays) -> None:
        """Pack and upload ``scene`` (to each distinct device of the mesh);
        with ``config.env_map`` set, read that map and install it. Restarts
        accumulation."""
        scene_dev = load_jax_scene(pack_device_scene(scene), self.device)
        if self.config.env_map is not None:
            scene_dev.update(ENV.env_tables(
                ENV.load_env_image(self.config.env_map),
                self.config.env_intensity, self.config.env_rotation,
                self.device))
        scenes = ({self.device: scene_dev} if self.mesh is None
                  else SH.replicate_scene(scene_dev, self.mesh))
        self._closest_hits = {
            dev: make_closest_hit(s, self.config.intersector,
                                  self.config.brute_force_max_tris,
                                  self.config.max_leaf_size)
            for dev, s in scenes.items()}
        self.scene, self._scenes = scene, scenes
        self._scene_dev = scenes[self.device]
        self._closest_hit = self._closest_hits[self.device]
        self.reset()

    def set_environment(self, source, intensity: float = 1.0,
                        rotation: float = 0.0) -> None:
        """Install, or clear with ``source=None``, an equirectangular
        environment map that lights the misses (the JAX package's extension
        over the reference's black background, pt.wgsl:646-649).
        ``source``: an (H, W, 3) array or a .hdr, .exr or PNG path;
        ``rotation`` in radians. Restarts accumulation."""
        if self._scene_dev is None:
            raise RuntimeError("Load a scene first")
        env = (np.zeros((1, 1, 3), np.float32) if source is None
               else ENV.load_env_image(source))
        for dev, scene in self._scenes.items():
            scene.update(ENV.env_tables(env, intensity, rotation, dev))
        self.reset()

    def _read_model(self, path: str) -> SceneArrays:
        cfg = self.config
        return load_model(path, texture_pixel_ratio=cfg.texture_pixel_ratio,
                          max_leaf_size=cfg.max_leaf_size,
                          num_bins=cfg.num_bins,
                          enable_spot_lights=cfg.spot_lights)

    def load_model(self, path: str) -> None:
        """Load a .glb or .gltf file (loader.ts:19-46, gpu.ts:67-150)."""
        self.load_scene(self._read_model(path))

    def load_model_async(self, path: str) -> concurrent.futures.Future:
        """Read a glTF file on a worker thread, the headless form of the
        reference's Web Worker hand-off (loader.ts:23-37): parse, atlas and
        BVH build run while the caller renders the current scene. The
        scene is staged, not installed: a ``render`` in progress installs
        it at its next chunk boundary (and restarts the mean there), so no
        sample of the new scene is folded into the old scene's mean; else
        the next ``render`` or ``poll_pending_scene`` does. Returns a
        future of the scene, which raises if the load fails; the failure is
        also raised by the next ``poll_pending_scene``."""
        def job():
            try:
                scene = self._read_model(path)
            except Exception as exc:
                with self._pending_lock:
                    self._pending_error = exc
                raise
            with self._pending_lock:
                self._pending_scene = scene
            return scene

        executor = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        future = executor.submit(job)
        executor.shutdown(wait=False)
        return future

    def poll_pending_scene(self) -> bool:
        """Install a scene staged by ``load_model_async``, if any; returns
        whether one was installed. A staged failure raises here, once.
        ``render`` calls it at its start and at every chunk boundary."""
        with self._pending_lock:
            scene, self._pending_scene = self._pending_scene, None
            error, self._pending_error = self._pending_error, None
        if error is not None:
            raise RuntimeError(f"load_model_async failed: {error!r}") from error
        if scene is None:
            return False
        self.load_scene(scene)
        return True

    # --- interaction (renderer.ts:152-201, 496-510) --------------------------
    def add_on_update(self, callback) -> None:
        """``callback(0.0)`` runs before every chunk of a ``render``."""
        self._on_update.append(callback)

    def move_camera(self, forward: float, right: float, up: float) -> None:
        self.camera.move(forward, right, up)
        self.reset()

    def rotate_camera(self, yaw: float, pitch: float) -> None:
        self.camera.rotate(yaw, pitch)
        self.reset()

    def resize(self, width: int, height: int) -> None:
        """New image size: the camera's aspect follows, accumulation
        restarts."""
        if self.mesh is not None:
            self._check_rows(height)
        self.config.width = width
        self.config.height = height
        self.config.validate()
        self.camera.resize(width, height)
        self._accum = None
        self.reset()

    def reset(self) -> None:
        """resetOutputBuffer (renderer.ts:357-366): restart accumulation."""
        self.frame_index = 0
        self._counters = np.zeros(2, np.int64)
        self._deferred = None
        self._deferred_t0 = None

    def _sync_deferred(self) -> None:
        """Fold the counters of ``render(sync=False)`` calls into the totals.
        The unsynced run counts as the last render: its wall clock spans its
        first dispatch to this read, which waits for the device."""
        if self._deferred is None:
            return
        add = self._deferred.cpu().numpy().astype(np.int64)
        self._deferred = None
        self._last_counters = add
        self._counters = self._counters + add
        self._last_render_seconds = time.perf_counter() - self._deferred_t0
        self._deferred_t0 = None

    # --- rendering -----------------------------------------------------------
    def _ensure_accum(self) -> None:
        n = self.config.width * self.config.height
        if self.mesh is not None:
            if (self._accum is None
                    or sum(band.shape[0] for band in self._accum) != n):
                self._accum = SH.shard_accum(
                    torch.zeros((n, 3), dtype=torch.float32), self.mesh)
        elif self._accum is None or self._accum.shape[0] != n:
            self._accum = torch.zeros((n, 3), dtype=torch.float32,
                                      device=self.device)

    def _sync(self) -> None:
        """Wait for every card the renderer runs on."""
        devs = [self.device] if self.mesh is None else self.mesh.distinct()
        for dev in devs:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def render(self, spp: int, on_chunk=None, fetch: bool = True,
               sync: bool = True):
        """Accumulate ``spp`` more samples per pixel, ``frames_per_chunk``
        frames at a time; ``on_chunk(frame_index)`` after each chunk sees
        its frames done. Returns the HDR buffer as (H, W, 3) NumPy (row 0 =
        bottom of the view), or None with ``fetch=False`` or ``sync=False``.

        The ray counters are read once at the end, which waits for the
        device, so the wall clock is honest. ``sync=False`` skips that read
        (and the image): the call returns when the frames are queued, and
        the counters fold in at ``stats()`` or the next synchronous render,
        which then report the whole unsynced run.

        A scene staged by ``load_model_async`` is installed at the start and
        at each chunk boundary. With ``config.mode`` a debug view, returns
        ``render_debug()`` instead."""
        self.poll_pending_scene()
        if self._scene_dev is None:
            raise RuntimeError("No scene loaded — call load_model or "
                               "load_scene first")
        cfg = self.config
        if cfg.mode != "pt":
            return self.render_debug()
        self._ensure_accum()
        cam = self._camera()
        t0 = time.perf_counter()
        counters = torch.zeros((2,), dtype=torch.int64, device=self.device)
        trace_fn = pipeline.make_trace_fn(cfg.bounce_kernel, self.device)
        remaining = spp
        while remaining > 0:
            self.poll_pending_scene()
            for task in self._on_update:
                task(0.0)
            chunk = min(cfg.frames_per_chunk, remaining)
            chunk_t0 = time.perf_counter()
            # gcd keeps a tail chunk divisible, so any spp works.
            fpt = math.gcd(cfg.frames_per_trace, chunk)
            common = dict(
                width=cfg.width, height=cfg.height,
                use_dof=float(self.camera.aperture) > 0.0,
                max_bounces=cfg.max_bounces, do_mis=cfg.do_mis,
                num_lights=self.scene.num_lights,
                firefly_clamp=cfg.firefly_clamp, rng_mode=cfg.rng)
            if self.mesh is None:
                _, chunk_counters = pipeline.render_chunk(
                    trace_fn, self._closest_hit, self._scene_dev, cam,
                    self._accum, self.frame_index, n_frames=chunk,
                    frames_per_trace=fpt, **common)
            else:
                n_frames, chunk = SH.round_chunk(chunk,
                                                 self.mesh.shape["sample"])
                _, chunk_counters = SH.render_chunk_sharded(
                    trace_fn, self._closest_hits, self._scenes, cam,
                    self._accum, self.frame_index, mesh=self.mesh,
                    n_frames=n_frames, n_active=chunk, frames_per_trace=fpt,
                    **common)
            counters += chunk_counters
            if on_chunk is not None:
                self._sync()  # the callback sees its frames done
            self.profiler.add("path-trace-pass",
                              (time.perf_counter() - chunk_t0) / chunk)
            for _ in range(chunk):
                self.frame_meter.tick()
            self.frame_index += chunk
            remaining -= chunk
            if on_chunk is not None:
                on_chunk(self.frame_index)
        if not sync:
            if self._deferred is None:
                self._deferred, self._deferred_t0 = counters, t0
            else:
                self._deferred += counters
            self._last_render_seconds = time.perf_counter() - t0
            return None
        start = t0
        if self._deferred is not None:
            # A synchronous render folds the unsynced run in and reports
            # from its first dispatch.
            counters += self._deferred
            start = self._deferred_t0
            self._deferred, self._deferred_t0 = None, None
        self._last_counters = counters.cpu().numpy().astype(np.int64)
        self._last_render_seconds = time.perf_counter() - start
        self._counters = self._counters + self._last_counters
        if not fetch:
            return None
        return self._row_major().reshape(cfg.height, cfg.width, 3)

    def _row_major(self, accum: torch.Tensor | None = None) -> np.ndarray:
        """A tile-ordered (N, 3) buffer, the accumulation by default (on a
        mesh, its row bands), as row-major NumPy."""
        cfg = self.config
        if accum is None and self.mesh is not None:
            return SH.untile_image(SH.gather_image(self._accum), cfg.width,
                                   cfg.height, self.mesh.shape["row"])
        perm = tile_permutation(cfg.width, cfg.height)
        buf = self._accum if accum is None else accum
        return buf.cpu().numpy()[inverse_permutation(perm)]

    def _tile_order(self, accum: np.ndarray):
        """A row-major (N, 3) buffer as the accumulation: tile-ordered on
        the device, or the mesh's row bands."""
        cfg = self.config
        if self.mesh is None:
            perm = tile_permutation(cfg.width, cfg.height)
            return torch.as_tensor(accum[perm], device=self.device)
        bands = SH.tile_bands(accum, cfg.width, cfg.height,
                              self.mesh.shape["row"])
        return SH.shard_accum(torch.from_numpy(bands), self.mesh)

    def _camera(self) -> dict:
        """The camera's parameters with the image size, as the frame takes
        them."""
        return pipeline.camera_device(self.camera.as_pytree(),
                                      self.config.width, self.config.height)

    def render_debug(self) -> np.ndarray:
        """The debug view ``config.mode`` names ("bvh_depth" or "normal",
        ``debug/modes.py``) of the current camera, as (H, W, 3) NumPy, row 0
        the bottom of the view."""
        from wgpu_path_tracing_tpu_torch.debug import modes

        cfg = self.config
        if cfg.mode == "bvh_depth":
            buf = modes.render_bvh_depth(self._scene_dev, self._camera(),
                                         cfg.width, cfg.height)
        else:
            buf = modes.render_normal(self._scene_dev, self._camera(),
                                      cfg.width, cfg.height,
                                      closest_hit=self._closest_hit)
        return buf.cpu().numpy().reshape(cfg.height, cfg.width, 3)

    def _hdr(self) -> np.ndarray:
        """The linear accumulation as (H, W, 3), top row first, NaN as 0."""
        if self._accum is None:
            raise RuntimeError("Nothing rendered yet")
        hdr = self._row_major().reshape(self.config.height, self.config.width, 3)
        return np.nan_to_num(hdr[::-1], nan=0.0)

    # --- checkpoint / resume -------------------------------------------------
    # The JAX package's .npz keys, so that each package loads the other's.
    @staticmethod
    def _ckpt_path(path: str) -> str:
        return path if path.endswith(".npz") else path + ".npz"

    def save_checkpoint(self, path: str) -> None:
        """The accumulation (row-major), the frame index, the image size and
        the camera, in one .npz."""
        if self._accum is None:
            raise RuntimeError("Nothing to checkpoint")
        cam = self.camera
        np.savez(self._ckpt_path(path), accum=self._row_major(),
                 frame_index=self.frame_index, width=self.config.width,
                 height=self.config.height, camera_position=cam.position,
                 camera_forward=cam.forward, camera_right=cam.right,
                 camera_up=cam.up, camera_fov=cam.fov,
                 camera_aperture=cam.aperture,
                 camera_focus_distance=cam.focus_distance)

    def load_checkpoint(self, path: str) -> None:
        """Resume from ``save_checkpoint``'s file (either package's): the
        next ``render`` continues at its frame index, with the same seeds."""
        with np.load(self._ckpt_path(path)) as data:
            w, h = int(data["width"]), int(data["height"])
            if (w, h) != (self.config.width, self.config.height):
                self.resize(w, h)
            cam = self.camera
            for key in ("position", "forward", "right", "up"):
                setattr(cam, key, data[f"camera_{key}"].astype(np.float32))
            cam.fov = float(data["camera_fov"])
            cam.aperture = float(data["camera_aperture"])
            cam.focus_distance = float(data["camera_focus_distance"])
            accum = np.asarray(data["accum"], np.float32).reshape(-1, 3)
            self._accum = self._tile_order(accum)
            self.frame_index = int(data["frame_index"])

    # --- denoising and adaptive sampling (the JAX package's extensions) ----
    def aovs(self, lens_samples: int | None = None) -> dict:
        """The denoiser's primary-hit guides (``ops/denoise.py::
        primary_aovs``) through the scene's intersector: row-major tensors
        on the renderer's device, ``albedo`` and ``normal`` (N, 3),
        ``depth`` and ``found`` (N,). ``lens_samples`` None or 0: pinhole
        centre rays; K > 0: averaged over K thin-lens samples."""
        if self._scene_dev is None:
            raise RuntimeError("No scene loaded")
        from wgpu_path_tracing_tpu_torch.ops import denoise as DN

        cfg = self.config
        return DN.primary_aovs(self._scene_dev, self._camera(), cfg.width,
                               cfg.height, lens_samples=int(lens_samples or 0),
                               rng_mode=cfg.rng,
                               closest_hit=self._closest_hit)

    def denoise(self, hdr: np.ndarray | None = None, **params) -> np.ndarray:
        """The à-trous denoise (``ops/denoise.py::denoise_image``, guided by
        ``aovs()``) of the linear accumulation, or of ``hdr`` (H, W, 3),
        e.g. a ``render_adaptive`` result. Returns a new (H, W, 3) array;
        the accumulation is untouched. ``params`` go to ``denoise_image``
        (``spp`` defaults to ``frame_index``)."""
        if hdr is None:
            if self._accum is None:
                raise RuntimeError("Nothing rendered yet")
            hdr = self._row_major().reshape(self.config.height,
                                            self.config.width, 3)
        from wgpu_path_tracing_tpu_torch.ops import denoise as DN

        params.setdefault("spp", self.frame_index)
        return DN.denoise_image(hdr, self.aovs(), **params)

    def render_adaptive(self, spp: int, **kw) -> np.ndarray:
        """Adaptive sampling (``render/adaptive.py::render_adaptive``):
        about ``spp`` frames of ray budget, concentrated on the noisiest
        pixels after a uniform warmup. Returns the combined (H, W, 3) HDR
        image; the accumulation keeps the warmup only."""
        from wgpu_path_tracing_tpu_torch.render import adaptive

        return adaptive.render_adaptive(self, spp, **kw)

    # --- output --------------------------------------------------------------
    def image(self, denoise: bool = False) -> np.ndarray:
        """Tonemapped display image (H, W, 3) in [0, 1], top row first;
        ``denoise=True`` filters a copy of the HDR buffer first."""
        if self._accum is None:
            raise RuntimeError("Nothing rendered yet")
        with self.profiler.section("blit-pass"):
            hdr = (self.denoise().reshape(-1, 3) if denoise
                   else self._row_major())
            return imageio.buffer_to_srgb(hdr, self.config.width,
                                          self.config.height,
                                          self.config.exposure)

    def save_png(self, path: str, denoise: bool = False) -> None:
        imageio.write_png(path, self.image(denoise=denoise))

    def save_hdr(self, path: str) -> None:
        """The LINEAR accumulation as Radiance RGBE .hdr (no tonemap)."""
        imageio.write_hdr(path, self._hdr())

    def save_exr(self, path: str) -> None:
        """The LINEAR accumulation as an uncompressed float32 OpenEXR: the
        same buffer as ``save_hdr``, exact instead of RGBE-quantized."""
        imageio.write_exr(path, self._hdr())

    def stats(self) -> dict:
        self._sync_deferred()
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
            "passes": self.profiler.stats(),
            "frames": self.frame_meter.stats(),
        }
