"""Edge-avoiding à-trous denoiser (the JAX package's opt-in extension).

The counterpart of the JAX package's ``ops/denoise.py``: primary-hit guide
buffers (``primary_aovs``: albedo, shading normal, depth, found), an
edge-avoiding à-trous wavelet filter (Dammertz et al. 2010) with the
SVGF-style variance-normalized luminance weight (``atrous_filter``), the
per-pixel raw/filtered mix (``variance_blend``) and the albedo-demodulated
whole (``denoise_image``). The default output path never calls anything
here; ``Renderer.denoise``, ``image(denoise=True)`` and
``save_png(denoise=True)`` do, on a copy of the accumulation.

Each level of the filter is K9 (``csrc/atrous.cu``) on CUDA tensors and its
plain version ``atrous_level_plain`` on CPU tensors; the two agree bit for
bit on the card. The plain version is shifted slices of edge-replicated
pads, never a convolution (cuDNN convolves float32 in TF32 by default). The
variance seed, the blend and the guides run as plain PyTorch on either
device, as the JAX package runs them in XLA. Every division of a tensor by
a constant goes through ``ops/vec.py::div_const`` (PyTorch's CUDA division
by a Python scalar multiplies by the reciprocal).
"""

from __future__ import annotations

import numpy as np
import torch

from wgpu_path_tracing_tpu_torch.ops import cuda_lib
from wgpu_path_tracing_tpu_torch.ops import shade as SHADE
from wgpu_path_tracing_tpu_torch.ops.intersect import make_closest_hit
from wgpu_path_tracing_tpu_torch.ops.vec import div_const

# 1D B3-spline kernel of the à-trous construction (Dammertz et al. §3).
_B3 = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)
# Its 5x5 outer product as float32 values (exact: k / 256).
_H_K = np.outer(_B3, _B3).astype(np.float32)
# The 3x3 box of the spatial moments, 1/9 rounded to float32.
_NINTH = float(np.float32(1.0) / np.float32(9.0))

# Demodulation floor: illumination = color / max(albedo_guide, this).
DEMOD_EPS = 0.02


class Counter:
    """Launches of K9 in this process (one a filter level)."""

    launches = 0


def _hit_aovs(scene, closest_hit, ro3, rd3, slots_used):
    """(found, albedo (N, 3), normal (N, 3), t) of the primary hits of the
    (3, N) rays: the scene's intersector, then the plain hit attributes."""
    t, idx = closest_hit(ro3, rd3)
    hit = SHADE.hit_attributes(scene, ro3, rd3, t, idx, slots_used)
    s = hit.emissive_strength
    alb = torch.stack([hit.albedo.x + hit.emission.x * s,
                       hit.albedo.y + hit.emission.y * s,
                       hit.albedo.z + hit.emission.z * s], dim=-1)
    nrm = torch.stack([hit.normal.x, hit.normal.y, hit.normal.z], dim=-1)
    return hit.found, alb, nrm, hit.t


def primary_aovs(scene, cam, width: int, height: int, *,
                 intersector: str = "auto", brute_max_tris: int = 512,
                 leaf_size: int = 4, slots_used=None, lens_samples: int = 0,
                 rng_mode: str = "reference", closest_hit=None):
    """Primary-hit guide buffers on the scene's device, as the JAX
    ``primary_aovs``: row-major (N = width * height) ``albedo`` (N, 3)
    (base colour plus emission x strength; 1 on a miss), ``normal`` (N, 3)
    (the shading normal, 0 on a miss), ``depth`` (N,) (t, 0 on a miss) and
    ``found`` (N,) bool.

    ``lens_samples == 0``: pinhole centre rays (``debug/modes.py::
    _center_rays``). ``lens_samples = K > 0``: averaged over the jittered
    thin-lens rays of frames 0..K-1 of ``rng_mode``; the mean normal is
    renormalized, depth averages over the samples that hit, ``found`` is
    the majority of lens coverage.

    ``closest_hit`` (the ``make_closest_hit`` signature) replaces the
    intersector that ``intersector``, ``brute_max_tris`` and ``leaf_size``
    pick; ``slots_used`` None takes the scene's texture-slot mask."""
    from wgpu_path_tracing_tpu_torch.debug.modes import _center_rays
    from wgpu_path_tracing_tpu_torch.ops import camera_rays as CAM

    if closest_hit is None:
        closest_hit = make_closest_hit(scene, intersector, brute_max_tris,
                                       leaf_size)
    dev = scene["tri_isect"].device
    if lens_samples <= 0:
        ro3, rd3 = _center_rays(cam, width, height, dev)
        f, alb, nrm, t = _hit_aovs(scene, closest_hit, ro3, rd3, slots_used)
        fm = f[:, None]
        return {"albedo": torch.where(fm, alb, 1.0),
                "normal": torch.where(fm, nrm, 0.0),
                "depth": torch.where(f, t, 0.0), "found": f}

    x, y = CAM.pixel_grid(width, height, device=dev)
    n = x.shape[0]
    s_alb = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    s_nrm = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    s_dep = torch.zeros((n,), dtype=torch.float32, device=dev)
    s_hits = torch.zeros((n,), dtype=torch.float32, device=dev)
    for k in range(lens_samples):
        ro3, rd3, _ = CAM.generate_rays(cam, x, y, k, use_dof=True,
                                        rng_mode=rng_mode)
        f, alb, nrm, t = _hit_aovs(scene, closest_hit, ro3, rd3, slots_used)
        fm = f[:, None]
        s_alb = s_alb + torch.where(fm, alb, 1.0)  # misses: white
        s_nrm = s_nrm + torch.where(fm, nrm, 0.0)
        s_dep = s_dep + torch.where(f, t, 0.0)
        s_hits = s_hits + f.to(torch.float32)
    ks = float(np.float32(lens_samples))
    hits = torch.clamp_min(s_hits, 1.0)
    nrm_mean = s_nrm / hits[:, None]
    nlen = torch.sqrt(nrm_mean[:, 0] * nrm_mean[:, 0]
                      + nrm_mean[:, 1] * nrm_mean[:, 1]
                      + nrm_mean[:, 2] * nrm_mean[:, 2])[:, None]
    nrm_unit = torch.where(nlen > 1e-6,
                           nrm_mean / torch.clamp_min(nlen, 1e-6), 0.0)
    found = s_hits * 2.0 > ks  # majority lens coverage
    return {"albedo": div_const(s_alb, ks),
            "normal": torch.where(found[:, None], nrm_unit, 0.0),
            "depth": torch.where(found, s_dep / hits, 0.0), "found": found}


def _pad2(img, p: int):
    """Edge-replicate pad of the two leading (H, W) axes."""
    h, w = img.shape[0], img.shape[1]
    dev = img.device
    rows = torch.clamp(torch.arange(-p, h + p, device=dev), 0, h - 1)
    cols = torch.clamp(torch.arange(-p, w + p, device=dev), 0, w - 1)
    return img[rows][:, cols]


def _luminance(c):
    return 0.2126 * c[..., 0] + 0.7152 * c[..., 1] + 0.0722 * c[..., 2]


def _box_moments(lum, *others):
    """The 3x3 box means of ``lum``, of ``lum`` squared and of each of
    ``others`` over edge-replicated pads, in the JAX package's tap order."""
    h, w = lum.shape
    pads = [_pad2(x, 1) for x in (lum, *others)]
    m1 = torch.zeros_like(lum)
    m2 = torch.zeros_like(lum)
    rest = [torch.zeros_like(lum) for _ in others]
    for dy in range(3):
        for dx in range(3):
            sl = pads[0][dy:dy + h, dx:dx + w]
            m1 = m1 + _NINTH * sl
            m2 = m2 + _NINTH * sl * sl
            for k, pad in enumerate(pads[1:]):
                rest[k] = rest[k] + _NINTH * pad[dy:dy + h, dx:dx + w]
    return m1, m2, rest


def atrous_level_plain(color, normal, depth, found, var, step: int, *,
                       sigma_normal: float = 128.0, sigma_depth: float = 1.0,
                       sigma_lum: float = 4.0):
    """Plain PyTorch K9: one level of ``atrous_filter`` at tap spacing
    ``step`` (the JAX loop's body, ``ops/denoise.py:217-263`` there).
    color, normal (H, W, 3); depth, var (H, W) float32; found (H, W) bool.
    Returns (the level's colour, its propagated variance)."""
    h, w = depth.shape
    p = 2 * step
    cp, np_, zp = _pad2(color, p), _pad2(normal, p), _pad2(depth, p)
    fp, vp = _pad2(found, p), _pad2(var, p)
    lum_c = _luminance(color)
    sig_l = sigma_lum * torch.sqrt(var) + 1e-4
    acc = torch.zeros_like(color)
    acc_v = torch.zeros_like(var)
    wsum = torch.zeros_like(lum_c)
    for ty in range(5):
        for tx in range(5):
            oy = p + (ty - 2) * step
            ox = p + (tx - 2) * step
            cq = cp[oy:oy + h, ox:ox + w]
            nq = np_[oy:oy + h, ox:ox + w]
            zq = zp[oy:oy + h, ox:ox + w]
            fq = fp[oy:oy + h, ox:ox + w]
            vq = vp[oy:oy + h, ox:ox + w]
            ndot = torch.clamp_min(normal[..., 0] * nq[..., 0]
                                   + normal[..., 1] * nq[..., 1]
                                   + normal[..., 2] * nq[..., 2], 0.0)
            w_n = torch.pow(ndot, sigma_normal)
            zmax = torch.clamp_min(torch.maximum(depth, zq), 1e-4)
            dz = (depth - zq) / (sigma_depth * zmax)
            w_z = torch.exp(-dz * dz)
            dl = torch.abs(lum_c - _luminance(cq))
            w_l = torch.exp(-dl / sig_l)
            w_seg = (found == fq).to(torch.float32)
            both_miss = ~found & ~fq
            w_edge = torch.where(both_miss, 1.0, w_n * w_z)
            wt = float(_H_K[ty, tx]) * w_seg * w_edge * w_l
            acc = acc + wt[..., None] * cq
            acc_v = acc_v + wt * wt * vq
            wsum = wsum + wt
    out = acc / torch.clamp_min(wsum, 1e-8)[..., None]
    return out, acc_v / torch.clamp_min(wsum * wsum, 1e-12)


def _check_level(color, normal, depth, found, var) -> None:
    h, w = depth.shape
    for name, x, shape, dtype in (
            ("color", color, (h, w, 3), torch.float32),
            ("normal", normal, (h, w, 3), torch.float32),
            ("var", var, (h, w), torch.float32),
            ("found", found, (h, w), torch.bool)):
        if tuple(x.shape) != shape or x.dtype != dtype:
            raise ValueError(f"{name} must be {shape} {dtype}, got "
                             f"{tuple(x.shape)} {x.dtype}")
    if depth.dtype != torch.float32:
        raise ValueError("depth must be float32")
    if len({x.device for x in (color, normal, depth, found, var)}) != 1:
        raise ValueError("the filter's inputs are on different devices")


def atrous_level_cuda(color, normal, depth, found, var, step: int, *,
                      sigma_normal: float = 128.0, sigma_depth: float = 1.0,
                      sigma_lum: float = 4.0):
    """Launch K9 (``csrc/atrous.cu``) on the current stream: a block a
    16x16 tile of the pixels that share one residue (y mod step, x mod
    step), its halo staged in shared memory once."""
    _check_level(color, normal, depth, found, var)
    if color.device.type != "cuda":
        raise ValueError("atrous_level_cuda needs CUDA tensors")
    if int(step) < 1:
        raise ValueError(f"the tap spacing must be 1 or more, got {step}")
    h, w = depth.shape
    keep = [x.contiguous() for x in (color, normal, depth, found, var)]
    out = torch.empty_like(keep[0])
    out_var = torch.empty_like(keep[4])
    if h * w == 0:
        return out, out_var
    err = cuda_lib.lib().wpt_atrous_level(
        *(x.data_ptr() for x in keep), out.data_ptr(), out_var.data_ptr(),
        h, w, int(step), float(sigma_normal), float(sigma_depth),
        float(sigma_lum), cuda_lib.stream_ptr(color))
    cuda_lib.check(err, "wpt_atrous_level")
    Counter.launches += 1
    return out, out_var


def atrous_level(color, normal, depth, found, var, step: int, **sigmas):
    """One filter level: K9 on CUDA tensors, its plain version on CPU
    tensors."""
    if color.device.type == "cuda":
        return atrous_level_cuda(color, normal, depth, found, var, step,
                                 **sigmas)
    _check_level(color, normal, depth, found, var)
    if color.device.type != "cpu":
        raise ValueError(f"unsupported device {color.device}")
    return atrous_level_plain(color, normal, depth, found, var, step,
                              **sigmas)


def atrous_filter(color, normal, depth, found, *, levels: int = 5,
                  sigma_normal: float = 128.0, sigma_depth: float = 1.0,
                  sigma_lum: float = 4.0, level=atrous_level):
    """Edge-avoiding à-trous filter of a linear (H, W, 3) image, as the
    JAX ``atrous_filter``: per level ``i`` the 5x5 B3 stencil dilated to
    spacing 2**i, tap weights max(0, n_p . n_q) ** sigma_normal,
    exp(-(dz / (sigma_depth max(z_p, z_q)))**2),
    exp(-|l_p - l_q| / (sigma_lum sqrt(var_p) + 1e-4)) and found_p ==
    found_q (misses smooth freely among themselves); the variance seeded
    from the 3x3 luminance moments and propagated with squared weights.
    ``level`` runs one level (``atrous_level``: K9 or its plain version by
    device; ``atrous_level_plain`` runs the plain version on any device).
    Returns the filtered (H, W, 3) image."""
    lum = _luminance(color)
    m1, m2, _ = _box_moments(lum)
    var = torch.clamp_min(m2 - m1 * m1, 0.0)
    out = color
    for i in range(levels):
        out, var = level(out, normal, depth, found, var, 1 << i,
                         sigma_normal=sigma_normal, sigma_depth=sigma_depth,
                         sigma_lum=sigma_lum)
    return out


def variance_blend(raw, filt, strength: float = 1.0, k_cap: float = 1.0):
    """Per-pixel raw/filtered blend, as the JAX ``variance_blend``:
    ``filt + k (raw - filt)`` with k = clip(1 - strength sigma^2 / d^2, 0,
    k_cap), sigma^2 the raw image's 3x3 spatial luminance variance and d^2
    the 3x3 mean of the squared luminance difference."""
    lr = _luminance(raw)
    lf = _luminance(filt)
    m1, m2, (d2,) = _box_moments(lr, (lf - lr) * (lf - lr))
    var = torch.clamp_min(m2 - m1 * m1, 0.0)
    k = torch.clamp(1.0 - strength * var / torch.clamp_min(d2, 1e-12), 0.0,
                    float(np.float32(k_cap)))
    return filt + k[..., None] * (raw - filt)


def denoise_image(color_hwc, aovs: dict, *, levels: int = 5,
                  sigma_normal: float = 128.0, sigma_depth: float = 1.0,
                  sigma_lum: float = 4.0, blend: bool = True,
                  spp: int | None = None, device=None,
                  level=atrous_level) -> np.ndarray:
    """Denoise a linear HDR (H, W, 3) NumPy buffer with primary-hit guides
    (``primary_aovs``, or arrays of the same shapes): illumination = colour
    / max(albedo, DEMOD_EPS) is filtered, then remodulated; ``blend`` mixes
    raw and filtered per pixel (``variance_blend``), the raw weight capped
    at spp / (spp + 128) when ``spp`` is given. Runs on ``device``, by
    default the guides' device, and for NumPy guides the card, as every
    entry point of the package does: "cuda" without a card raises, and
    ``device="cpu"`` runs on the CPU. ``level`` as in ``atrous_filter``.
    Returns (H, W, 3) float32 NumPy."""
    h, w, _ = color_hwc.shape
    if device is None:
        guide = aovs["normal"]
        device = guide.device if isinstance(guide, torch.Tensor) else "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("denoise_image: device 'cuda' (the default for "
                           "NumPy guides) but CUDA is not available; pass "
                           "device='cpu' to run on the CPU")

    def put(x, dtype, shape):
        return torch.as_tensor(np.asarray(x) if not isinstance(
            x, torch.Tensor) else x).to(device, dtype).reshape(shape)

    alb = put(aovs["albedo"], torch.float32, (h, w, 3))
    nrm = put(aovs["normal"], torch.float32, (h, w, 3)).contiguous()
    dep = put(aovs["depth"], torch.float32, (h, w)).contiguous()
    fnd = put(aovs["found"], torch.bool, (h, w)).contiguous()
    guide = torch.clamp_min(alb, DEMOD_EPS)
    raw = put(np.asarray(color_hwc, np.float32), torch.float32, (h, w, 3))
    filt = atrous_filter(raw / guide, nrm, dep, fnd, levels=levels,
                         sigma_normal=sigma_normal, sigma_depth=sigma_depth,
                         sigma_lum=sigma_lum, level=level) * guide
    if blend:
        k_cap = 1.0 if not spp else spp / (spp + 128.0)
        filt = variance_blend(raw, filt, 1.0, k_cap)
    return filt.cpu().numpy()

