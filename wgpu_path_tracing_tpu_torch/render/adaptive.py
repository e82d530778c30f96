"""Adaptive sampling (the JAX package's opt-in extension): spend rays where
the noise is.

The counterpart of the JAX package's ``render/adaptive.py``, whose module
docstring gives the scheme and its measurements:

1. a uniform warmup through ``render_chunk_m2``: ``render/pipeline.py::
   render_chunk``'s frames, seeds, tile lane order and running mean, plus
   the running mean of the clamped colour squared, so that E[x^2] - E[x]^2
   estimates each pixel's variance; its ``accum`` is bit-equal to
   ``render_chunk``'s on the same frames;
2. a display-space error score a pixel (``_score_from_moments``: the
   linear sigma pushed through the AGX display transform, on the
   renderer's device), smoothed 3x3;
3. rounds over the K noisiest pixels (K = select_frac N rounded up to a
   multiple of LANE_QUANTUM, at most N), chosen by marginal MSE gain
   (score / n_i) with ``np.argpartition``; each round traces one more
   sample for the K lanes (``render_chunk_subset``) and adds it into side
   buffers (sum, sum of squares, count); every ``refresh_every`` rounds the
   score is recomputed from the combined moments;
4. the image: (warmup mean x n0 + extra sum) / (n0 + extra count).

The frames run through the ``trace_fn`` and ``closest_hit`` given (the
renderer's: the bounce loop of its ``bounce_kernel``, ``ops/bounce.py::
trace_cuda`` under "auto", with the scene's intersector, so the kernels on
the card; the plain versions on the CPU). The selection is
host-side NumPy, as in the JAX package. A subset round traces K lanes, a
count that need not fill a ray block: the port's intersectors take any
count. The selected lanes are distinct, so the side buffers' ``index_add_``
adds each lane once and the result does not depend on the order of adds.
"""

from __future__ import annotations

import numpy as np
import torch

from wgpu_path_tracing_tpu_torch.ops import camera_rays as CAM
from wgpu_path_tracing_tpu_torch.render import pipeline
from wgpu_path_tracing_tpu_torch.utils.tiling import (
    inverse_permutation,
    tile_permutation,
)

# Subset lane counts are rounded up to a multiple of this.
LANE_QUANTUM = 2048


def render_chunk_m2(trace_fn, closest_hit, scene: dict, cam: dict,
                    accum: torch.Tensor, m2: torch.Tensor, frame_start: int,
                    **kw):
    """``render_chunk`` (``render/pipeline.py``, its keywords, one frame a
    trace) that also folds each frame's clamped colour squared into the
    running mean ``m2``: after n frames ``m2 - accum**2`` is each pixel's
    variance a channel. Both in place. Returns (accum, m2, counters)."""
    accum, counters = pipeline.render_chunk(
        trace_fn, closest_hit, scene, cam, accum, frame_start, m2=m2, **kw)
    return accum, m2, counters


def render_chunk_subset(trace_fn, closest_hit, scene: dict, cam: dict,
                        extra_sum: torch.Tensor, extra_sum2: torch.Tensor,
                        extra_count: torch.Tensor, x: torch.Tensor,
                        y: torch.Tensor, lane_idx: torch.Tensor,
                        frame_start: int, *, n_frames: int, use_dof: bool,
                        max_bounces: int, do_mis: bool, num_lights: int,
                        firefly_clamp: float, rng_mode: str = "reference"):
    """``n_frames`` one-sample rounds for the K pixels (x, y), each added
    into the (N, 3), (N, 3) and (N,) side buffers at ``lane_idx`` (sum, sum
    of squares, count), in place. The seeds come from the frame counter as
    in ``render_chunk``, so a pixel's extra samples are those a longer
    uniform render would have drawn. Returns (extra_sum, extra_sum2,
    extra_count, counters (2,) int64)."""
    dev = extra_sum.device
    do_mis = bool(do_mis) and num_lights > 0
    lds_active = rng_mode == "stratified" and CAM.TRACE_BOUNCE0_LDS
    counters = torch.zeros((2,), dtype=torch.int64, device=dev)
    clamp = float(np.float32(firefly_clamp))
    lanes = lane_idx.long()
    one = torch.ones_like(lanes, dtype=extra_count.dtype)
    for frame in range(frame_start, frame_start + n_frames):
        ro, rd, state = CAM.generate_rays(cam, x, y, frame, use_dof=use_dof,
                                          rng_mode=rng_mode)
        lds0 = CAM.bounce0_lds(x, y, frame) if lds_active else None
        radiance, _, stats = trace_fn(scene, closest_hit, ro, rd, state,
                                      max_bounces=max_bounces, do_mis=do_mis,
                                      num_lights=num_lights, lds0=lds0)
        color = torch.clamp_max(radiance.T, clamp)
        extra_sum.index_add_(0, lanes, color)
        extra_sum2.index_add_(0, lanes, color * color)
        extra_count.index_add_(0, lanes, one)
        counters += stats
    return extra_sum, extra_sum2, extra_count, counters


def _display_sigma_score(mean_lin: np.ndarray, sigma_lin: np.ndarray,
                         device="cpu") -> np.ndarray:
    """A lane's display-space sigma: |T(mu + sigma) - T(mu - sigma)| / 2
    summed over the channels, T the AGX display transform, which runs on
    ``device`` (the JAX package runs it on its default device); both
    interval ends are clamped at 1e-3, below which the transform NaNs."""
    from wgpu_path_tracing_tpu_torch.ops.tonemap import display_transform

    floor = np.float32(1e-3)

    def display(x):
        x = np.ascontiguousarray(np.maximum(x, floor), np.float32)
        return display_transform(torch.from_numpy(x).to(device)).cpu().numpy()

    hi = display(mean_lin + sigma_lin)
    lo = display(mean_lin - sigma_lin)
    return np.nan_to_num(np.abs(hi - lo).sum(axis=-1) * 0.5)


def _score_from_moments(mean_lin, ex2_lin, n_samples,
                        device="cpu") -> np.ndarray:
    """The display-space sigma score from (mean, E[x^2]) buffers of
    ``n_samples`` draws, with the n / (n - 1) small-sample correction."""
    var = np.maximum(ex2_lin - mean_lin * mean_lin, 0.0)
    n = np.asarray(n_samples, np.float64).reshape(-1, 1)
    var = var * (n / np.maximum(n - 1.0, 1.0))
    return _display_sigma_score(mean_lin, np.sqrt(var).astype(np.float32),
                                device)


def _blurred(score: np.ndarray, width: int, height: int) -> np.ndarray:
    """The lane-ordered score smoothed 3x3 in image space (edge-replicated);
    a zero score stays zero (converged or missed pixels take no ray)."""
    perm = tile_permutation(width, height)
    img_score = score[inverse_permutation(perm)].reshape(height, width)
    pad = np.pad(img_score, 1, mode="edge")
    sm = sum(pad[dy:dy + height, dx:dx + width]
             for dy in range(3) for dx in range(3)) / 9.0
    return np.where(img_score.reshape(-1) > 0.0, sm.reshape(-1), 0.0)[perm]


def render_adaptive(renderer, spp: int, *, warmup_frac: float = 0.5,
                    select_frac: float = 0.25, reselect_every: int = 1,
                    refresh_every: int = 4, trace_fn=None,
                    closest_hit=None) -> np.ndarray:
    """Render about ``spp`` frames of ray budget adaptively on ``renderer``
    (a ``Renderer`` with a scene); returns the combined HDR image
    (H, W, 3), row 0 the bottom (as ``render``). The renderer's own
    accumulation keeps the uniform warmup only; continuing with ``render``
    would reuse frame seeds the rounds consumed (the JAX package's
    documented limitation). ``trace_fn`` and ``closest_hit`` (default: the
    bounce loop of the renderer's ``bounce_kernel``, ``render/pipeline.py::
    make_trace_fn``, and the renderer's intersector) are the frame's bounce
    loop and intersector, as ``render_chunk`` takes them. A renderer on a mesh (``devices=``)
    raises ``NotImplementedError``, as the JAX package's does."""
    if renderer.mesh is not None:
        raise NotImplementedError(
            "adaptive sampling runs single-device (warmup may be sharded "
            "in a future round)")
    cfg = renderer.config
    w, h = cfg.width, cfg.height
    n = w * h
    n0 = max(2, int(round(spp * warmup_frac)))
    if spp <= n0:
        renderer.render(spp, fetch=False)
        return renderer._row_major().reshape(h, w, 3)

    if trace_fn is None:
        trace_fn = pipeline.make_trace_fn(cfg.bounce_kernel, renderer.device)
    if closest_hit is None:
        closest_hit = renderer._closest_hit
    scene = renderer._scene_dev
    dev = renderer.device
    cam = renderer._camera()
    common = dict(use_dof=float(renderer.camera.aperture) > 0.0,
                  rng_mode=cfg.rng, max_bounces=cfg.max_bounces,
                  do_mis=cfg.do_mis, num_lights=renderer.scene.num_lights,
                  firefly_clamp=cfg.firefly_clamp)

    # 1. The uniform warmup, in the renderer's chunks.
    renderer._ensure_accum()
    accum = renderer._accum
    m2 = torch.zeros_like(accum)
    warm = torch.zeros((2,), dtype=torch.int64, device=dev)
    remaining = n0
    while remaining > 0:
        chunk = min(cfg.frames_per_chunk, remaining)
        _, _, c = render_chunk_m2(trace_fn, closest_hit, scene, cam, accum,
                                  m2, renderer.frame_index, n_frames=chunk,
                                  width=w, height=h, **common)
        warm += c
        renderer.frame_index += chunk
        remaining -= chunk
    warm = warm.cpu().numpy().astype(np.int64)
    renderer._counters = renderer._counters + warm
    renderer._last_counters = warm
    base = accum.cpu().numpy()
    m2_h = m2.cpu().numpy()

    # 2. The display-space score a lane, smoothed.
    score = _blurred(_score_from_moments(base, m2_h, np.full(n, n0), dev),
                     w, h)

    # 3. Subset rounds of k lanes.
    k = int(round(n * select_frac))
    k = max(LANE_QUANTUM, ((k + LANE_QUANTUM - 1) // LANE_QUANTUM)
            * LANE_QUANTUM)
    k = min(k, n)
    rounds_total = int(round((spp - n0) * n / k))
    if rounds_total == 0:
        return renderer._row_major().reshape(h, w, 3)
    perm = tile_permutation(w, h)
    x_rm, y_rm = np.divmod(np.arange(n, dtype=np.int64), w)[::-1]
    x_t = x_rm[perm].astype(np.int32)
    y_t = y_rm[perm].astype(np.int32)

    extra_sum = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    extra_sum2 = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    extra_count = torch.zeros((n,), dtype=torch.int32, device=dev)
    extra_count_host = np.zeros(n, np.int64)
    counters = torch.zeros((2,), dtype=torch.int64, device=dev)
    frame, done, rounds_done = n0, 0, 0
    while done < rounds_total:
        if refresh_every and rounds_done and rounds_done % refresh_every == 0:
            # The score again, from the combined warmup and extra moments.
            n_i = (n0 + extra_count_host).astype(np.float64)
            s1 = extra_sum.cpu().numpy()
            s2 = extra_sum2.cpu().numpy()
            mean_c = ((base * n0 + s1) / n_i[:, None]).astype(np.float32)
            ex2_c = ((m2_h * n0 + s2) / n_i[:, None]).astype(np.float32)
            score = _blurred(_score_from_moments(mean_c, ex2_c, n_i, dev),
                             w, h)
        # The marginal MSE gain of one more sample ranks the lanes.
        pred = score / (n0 + extra_count_host)
        sel = np.argpartition(pred, n - k)[n - k:]
        r_n = min(reselect_every, rounds_total - done)
        _, _, _, c = render_chunk_subset(
            trace_fn, closest_hit, scene, cam, extra_sum, extra_sum2,
            extra_count, torch.from_numpy(x_t[sel]).to(dev),
            torch.from_numpy(y_t[sel]).to(dev),
            torch.from_numpy(sel.astype(np.int64)).to(dev), frame,
            n_frames=r_n, **common)
        extra_count_host[sel] += r_n
        counters += c
        frame += r_n
        done += r_n
        rounds_done += 1

    renderer._counters = renderer._counters + counters.cpu().numpy()

    # 4. Combine on the device, one read.
    denom = float(np.float32(n0)) + extra_count.to(torch.float32)
    combined = (accum * float(np.float32(n0)) + extra_sum) / denom[:, None]
    return renderer._row_major(combined).reshape(h, w, 3)
