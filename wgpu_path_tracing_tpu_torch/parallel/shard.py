"""Multi-device rendering: the counterpart of the JAX package's
``parallel/shard.py``, with one controller and no collective library.

The JAX package lays a ("sample", "row") mesh over its chips: the scene is
replicated to every chip, the image is cut into row bands along "row" (the
RNG seeds use global pixel coordinates, so a sharded render equals the
single-device one), the frames of a chunk are dealt round robin along
"sample", and one ``psum`` over "sample" a chunk merges the shards' sums.

Here the mesh is an explicit grid of ``torch.device``s and this process
drives every shard: each shard's frames run on its device through the same
kernels as a single-device render, and the "psum" is the shards' sums added
on the row's first device in sample order (tensor adds and ``.to(device)``
copies), which is deterministic. A device may appear more than once: each
entry is then a shard that runs on that device in turn, which is how a
(2, 2) mesh runs on one card (the JAX tests' counterpart is XLA's
``--xla_force_host_platform_device_count``).

The arithmetic is the JAX ``render_chunk_sharded``'s, not the single-device
pipeline's per-frame running mean: a shard keeps the sum of its clamped
colours, the chunk mean is the summed sums over the chunk's active frames,
and the chunk folds into the accumulation once. So a sharded render, even
on a (1, 1) mesh, matches the single-device render within float32 rounding
(rtol 1e-4 / atol 1e-5, as ``tests/test_multichip.py`` holds the JAX one),
not bit for bit.

The accumulation is a list of row bands, band ``r`` on the device of shard
(0, r), each in the tile order of its own ``local_rows`` x ``width`` band
(``untile_image`` turns them back into one row-major image).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import numpy as np
import torch

from wgpu_path_tracing_tpu_torch.ops import camera_rays as CAM
from wgpu_path_tracing_tpu_torch.ops.vec import div_const
from wgpu_path_tracing_tpu_torch.utils.tiling import (
    inverse_permutation,
    tile_permutation,
)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (sample, row) grid of devices: ``devices[s][r]`` runs shard
    (s, r)."""

    devices: tuple

    @property
    def shape(self) -> dict:
        return {"sample": len(self.devices), "row": len(self.devices[0])}

    def distinct(self) -> list:
        """The mesh's devices, each once, in the order they first appear
        (row by row of the sample axis)."""
        out = []
        for row in self.devices:
            for dev in row:
                if dev not in out:
                    out.append(dev)
        return out


def _indexed(device) -> torch.device:
    """``device`` as a torch device; "cuda" without an index is the current
    card, so that two names of one card are one device."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(devices, sample_shards: int | None = None) -> Mesh:
    """A (sample, row) mesh over ``devices`` (torch devices or their names).

    With n devices and ``sample_shards`` s (default: 2 when n is even and
    above 2, else 1), the mesh is (s, n // s), filled row-major as the JAX
    package's ``np.reshape`` fills it."""
    devs = [_indexed(d) for d in devices]
    n = len(devs)
    if n == 0:
        raise ValueError("a mesh needs at least one device")
    if sample_shards is None:
        sample_shards = 2 if (n > 2 and n % 2 == 0) else 1
    if sample_shards < 1 or n % sample_shards:
        raise ValueError(f"{n} devices do not divide into {sample_shards} "
                         "sample shards")
    rows = n // sample_shards
    return Mesh(tuple(tuple(devs[s * rows:(s + 1) * rows])
                      for s in range(sample_shards)))


def replicate_scene(scene: dict, mesh: Mesh) -> dict:
    """One copy of the uploaded scene dict for each distinct device of the
    mesh, keyed by device; shards on the same device share it. A tensor
    already on a device is not copied for it."""
    return {dev: {k: v.to(dev) if isinstance(v, torch.Tensor) else v
                  for k, v in scene.items()}
            for dev in mesh.distinct()}


def shard_accum(accum: torch.Tensor, mesh: Mesh) -> list:
    """The (H*W, 3) accumulation cut into one row band a row shard, band r
    on the device of shard (0, r). The buffer must already be in the band
    layout (each band tile-ordered in itself, ``Renderer._tile_order``)."""
    rows = mesh.shape["row"]
    if accum.shape[0] % rows:
        raise ValueError(f"{accum.shape[0]} pixels do not divide into "
                         f"{rows} row bands")
    return [band.to(dev).contiguous()
            for band, dev in zip(accum.chunk(rows), mesh.devices[0])]


def round_chunk(chunk: int, sample_shards: int) -> tuple:
    """(n_frames, n_active) of a chunk of ``chunk`` frames on a sample axis
    of ``sample_shards``: a chunk of at least that many frames rounds down
    to a multiple of it (no frame is wasted), a shorter one (a final
    remainder) is padded up with frames of weight 0. ``Renderer.render``
    chunks so, and draws exactly the spp it is asked for."""
    if chunk >= sample_shards:
        chunk -= chunk % sample_shards
    return chunk + (-chunk) % sample_shards, chunk


def on_device(dev: torch.device):
    """Make ``dev`` the current card while a shard launches its kernels
    (the kernels launch on the current device); nothing for the CPU."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def render_chunk_sharded(trace_fn, closest_hit_by_device: dict, scenes: dict,
                         cam: dict, accum: list, frame_start: int, *,
                         mesh: Mesh, n_frames: int, width: int, height: int,
                         use_dof: bool, max_bounces: int, do_mis: bool,
                         num_lights: int, firefly_clamp: float,
                         rng_mode: str = "reference",
                         n_active: int | None = None,
                         frames_per_trace: int = 1):
    """The sharded counterpart of ``render/pipeline.py::render_chunk``,
    with the JAX ``render_chunk_sharded``'s arithmetic.

    ``scenes`` and ``closest_hit_by_device`` map each distinct device of
    the mesh to its copy of the scene (``replicate_scene``) and the closest
    hit built on it (``ops/intersect.py::make_closest_hit``); ``trace_fn``
    is the bounce loop (``render/pipeline.py::make_trace_fn``'s for the
    renderer's ``bounce_kernel``: ``ops/bounce.py::trace_cuda``, or
    ``ops/trace.py::trace`` under "xla" and for the plain path). ``accum`` is the list of row bands
    (``shard_accum``); it is updated in place and returned.

    Renders ``n_frames`` 1-spp frames, a multiple of the sample axis s: a
    shard's local frame j is the chunk's frame ``j * s + s_idx``, its lanes
    the pixels of its row band with global rows (so global seeds). Frames
    at or past ``n_active`` (default ``n_frames``) run but weigh 0, so a
    caller lands on an exact spp. ``frames_per_trace`` batches
    ``gcd(frames_per_trace, n_frames // s)`` local frames into one trace
    call, 1 on a chunk with such padded frames. Each shard sums its clamped
    colours; the shards of a row are summed in sample order on the row's
    device; the chunk mean, ``sum / n_active``, folds into the band as
    ``accum * (1 - t) + mean * t`` with ``t = n_active / (frame_start +
    n_active)``. Returns (accum, counters (2,) int64 on the first device:
    the active frames' closest-hit and shadow rays over every shard)."""
    ns, nr = mesh.shape["sample"], mesh.shape["row"]
    if n_frames % ns:
        raise ValueError(f"n_frames={n_frames} must divide into {ns} sample "
                         "shards")
    if height % nr:
        raise ValueError(f"height {height} must divide the row axis {nr}")
    if n_active is None:
        n_active = n_frames
    if not 0 < n_active <= n_frames:
        raise ValueError(f"n_active={n_active} must be in 1..{n_frames}")
    local_frames = n_frames // ns
    local_rows = height // nr
    fpt = math.gcd(max(1, int(frames_per_trace)), local_frames)
    if n_active != n_frames:
        fpt = 1
    # NEE against zero lights would sample the padding row.
    do_mis = bool(do_mis) and num_lights > 0
    lds_active = rng_mode == "stratified" and CAM.TRACE_BOUNCE0_LDS
    clamp = float(np.float32(firefly_clamp))
    perm = tile_permutation(width, local_rows)

    shards = []  # (s, r, device, x, y, local sum, counters)
    for s_idx in range(ns):
        for r_idx in range(nr):
            dev = mesh.devices[s_idx][r_idx]
            with on_device(dev):
                x, y = CAM.pixel_grid(width, local_rows, device=dev,
                                      row_offset=r_idx * local_rows)
                p = torch.as_tensor(perm, device=dev)
                shards.append((s_idx, r_idx, dev, x[p], y[p],
                               torch.zeros((local_rows * width, 3),
                                           dtype=torch.float32, device=dev),
                               torch.zeros((2,), dtype=torch.int64,
                                           device=dev)))
    n_loc = local_rows * width

    # Frame steps outer and shards inner, so that shards on different cards
    # queue their work side by side; each shard's result is independent of
    # the order.
    for k in range(local_frames // fpt):
        for s_idx, _, dev, x, y, local_sum, counters in shards:
            in_chunk = [(k * fpt + i) * ns + s_idx for i in range(fpt)]
            frames = [frame_start + c for c in in_chunk]
            with on_device(dev):
                parts = [CAM.generate_rays(cam, x, y, f, use_dof=use_dof,
                                           rng_mode=rng_mode) for f in frames]
                ro, rd, state = (p[0] if fpt == 1 else torch.cat(p, dim=-1)
                                 for p in zip(*parts))
                lds0 = None
                if lds_active:
                    ldss = [CAM.bounce0_lds(x, y, f) for f in frames]
                    lds0 = ldss[0] if fpt == 1 else torch.cat(ldss, dim=1)
                radiance, _, stats = trace_fn(
                    scenes[dev], closest_hit_by_device[dev], ro, rd, state,
                    max_bounces=max_bounces, do_mis=do_mis,
                    num_lights=num_lights, lds0=lds0)
                # fpt > 1 only on chunks without padded frames, whose
                # batched counters cover exactly the contributing frames.
                if fpt > 1 or in_chunk[0] < n_active:
                    counters += stats
                for i, c in enumerate(in_chunk):
                    color = torch.clamp_max(
                        radiance[:, i * n_loc:(i + 1) * n_loc].T, clamp)
                    # A padded frame adds 0 * colour, as the JAX sum does.
                    local_sum += color if c < n_active else color * 0.0

    first = mesh.devices[0][0]
    total = torch.zeros((2,), dtype=torch.int64, device=first)
    one_t = np.float32(n_active) / (np.float32(frame_start)
                                    + np.float32(n_active))
    keep = float(np.float32(1.0) - one_t)
    for r_idx in range(nr):
        row = [sh for sh in shards if sh[1] == r_idx]  # in sample order
        band = accum[r_idx]
        chunk_sum = row[0][5].to(band.device)
        for sh in row[1:]:
            chunk_sum = chunk_sum + sh[5].to(band.device)
        chunk_mean = div_const(chunk_sum, float(n_active))  # IEEE, as JAX
        band.mul_(keep).add_(chunk_mean * float(one_t))
    for sh in shards:
        total += sh[6].to(first)
    return accum, total


def gather_image(accum: list) -> np.ndarray:
    """The row bands as one (H*W, 3) NumPy buffer, band by band."""
    return np.concatenate([band.cpu().numpy() for band in accum])


def untile_image(buf: np.ndarray, width: int, height: int,
                 row_shards: int) -> np.ndarray:
    """A buffer of row bands, each tile-ordered in itself, as row-major
    (H*W, 3)."""
    local_rows = height // row_shards
    inv = inverse_permutation(tile_permutation(width, local_rows))
    out = buf.reshape(row_shards, local_rows * width, 3)[:, inv]
    return out.reshape(height * width, 3)


def tile_bands(buf: np.ndarray, width: int, height: int,
               row_shards: int) -> np.ndarray:
    """``untile_image``'s inverse: a row-major (H*W, 3) buffer as row
    bands, each tile-ordered in itself."""
    local_rows = height // row_shards
    perm = tile_permutation(width, local_rows)
    out = buf.reshape(row_shards, local_rows * width, 3)[:, perm]
    return out.reshape(height * width, 3)
