"""K2's plain version (the bounce shading) against the JAX package's Pallas
bounce kernel in interpret mode.

At every bounce both get identical inputs: the rays, RNG states, throughput,
result and hits that the JAX side carries into that bounce. RNG states and
alive flags must agree on all but 0.5% of lanes: XLA:CPU contracts
multiply-adds into FMAs where PyTorch rounds each operation, and a last-ulp
difference flips a razor-edge branch (Russian roulette, lobe choice, total
internal reflection) now and then. Where the state agrees, the float outputs
agree within rtol/atol 1e-4 on all but 0.2% of those lanes: near the
critical angle, refraction's sqrt(k) with k close to 0 turns a one-ulp
difference of sin/cos (jnp.sin and torch.sin differ on about 5% of float32
inputs) into a 1e-3 relative change of the new direction, as on one glass
lane of ``material_test_box`` at bounce 3.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wgpu_path_tracing_tpu.models.procedural import cornell_box as jcornell_box
from wgpu_path_tracing_tpu.models.procedural import (
    material_test_box as jmaterial_test_box,
)
from wgpu_path_tracing_tpu.models.types import pack_device_scene as jpack
from wgpu_path_tracing_tpu.models.types import texture_slots_used
from wgpu_path_tracing_tpu.ops import camera_rays as JCAM
from wgpu_path_tracing_tpu.ops.intersect import make_closest_hit as jmake_closest_hit
from wgpu_path_tracing_tpu.ops.pallas_bounce import (
    bounce_stage_pallas,
    prepare_tables,
)
from wgpu_path_tracing_tpu.render.camera import Camera as JCamera
from wgpu_path_tracing_tpu.render.pipeline import camera_device as jcamera_device
from wgpu_path_tracing_tpu_torch import load_jax_scene
from wgpu_path_tracing_tpu_torch.models import types as T
from wgpu_path_tracing_tpu_torch.ops import bounce as K2
from wgpu_path_tracing_tpu_torch.ops import camera_rays as PCAM
from wgpu_path_tracing_tpu_torch.ops import trace as TRACE
from wgpu_path_tracing_tpu_torch.ops.intersect import make_closest_hit
from wgpu_path_tracing_tpu_torch.render.camera import Camera
from wgpu_path_tracing_tpu_torch.render.pipeline import camera_device

from chip_smoke import (
    LANE_MIX_CASES,
    LANE_MIX_LIGHTS,
    lane_mix_box,
    lane_mix_rays,
)
from tests.test_torch_cuda import spot_cornell

torch.set_num_threads(1)

W = H = 32  # 1024 rays: one Pallas block


SCENES = {"cornell": jcornell_box, "material": jmaterial_test_box,
          "spot": lambda: spot_cornell(jcornell_box)}


def _t(x, dtype=None):
    a = np.asarray(x)
    return torch.from_numpy(a.astype(dtype) if dtype else a.copy())


def _against_pallas(sc, rays, state, alive, do_mis, bounces=4, share=0.002):
    """``bounces`` bounces of the Pallas kernel in interpret mode and of
    K2's plain version from the same inputs at each bounce (the JAX side's),
    held to the bars in the module's docstring, the float outputs on all
    but ``share`` of the lanes. rays (6, N), state (1, N) uint32 and alive
    (1, N) int32 are JAX arrays. Returns each bounce's (t, idx, JAX
    outputs)."""
    packed = jpack(sc)
    dev = jax.device_put(packed)
    slots = texture_slots_used(packed["tri_full"])
    tri_table, light_table, _, _, _, tri_cols = prepare_tables(dev, slots)
    port = load_jax_scene(packed, "cpu")
    n = rays.shape[1]
    thr = jnp.ones((3, n), jnp.float32)
    res = jnp.zeros((3, n), jnp.float32)
    closest_hit = jmake_closest_hit(dev, "brute", 4096, 4)
    outs = []
    for b in range(bounces):
        t, idx = closest_hit(rays[0:3], rays[3:6])
        jout = bounce_stage_pallas(
            b, rays, state, thr, res, alive, t[None, :], idx[None, :],
            tri_table, light_table, do_mis=do_mis, num_lights=sc.num_lights,
            slots_used=slots, interpret=True, tri_cols=tri_cols)
        pout = K2.bounce_stage_plain(
            b, _t(rays), _t(state[0], np.int64), _t(thr), _t(res),
            _t(alive[0] != 0), _t(t), _t(idx), port["tri_full"],
            port["light_full"], do_mis=do_mis, num_lights=sc.num_lights)
        # One-row outputs are (1, N) on the JAX side, (N,) in the port.
        j = [np.asarray(a)[0] if a.shape[0] == 1 else np.asarray(a)
             for a in jout]
        p = [a.numpy() for a in pout]

        same = p[1] == j[1].astype(np.int64)
        assert same.mean() >= 0.995, f"bounce {b}: state agrees on {same.mean()}"
        assert (p[4] == (j[4] != 0)).mean() >= 0.995
        assert ((p[7] == (j[7] != 0)) | ~same).all()
        # rays, throughput, result, direct, pdf; the shadow ray and its
        # t_max mean something only where the query is live.
        live = same & p[7]
        for k, lanes in ((0, same), (2, same), (3, same), (8, same),
                         (9, same), (5, live), (6, live)):
            close = np.isclose(p[k].reshape(-1, n)[:, lanes],
                               j[k].reshape(-1, n)[:, lanes], rtol=1e-4,
                               atol=1e-4).all(0)
            assert (~close).sum() <= share * n, (
                f"output {k}, bounce {b}: {(~close).sum()} lanes differ")
        outs.append((t, idx, jout))

        rays, state, thr, res, alive = jout[:5]
        if do_mis:
            shadow_t, _ = closest_hit(jout[5][0:3], jout[5][3:6])
            take = ((jout[7][0] != 0) & ~(shadow_t < jout[6][0])
                    & (jout[9][0] > 0.0))
            res = res + jnp.where(take[None, :], jout[8], 0.0)
    return outs


@pytest.mark.parametrize("do_mis", [True, False])
@pytest.mark.parametrize("scene_name", ["cornell", "material", "spot"])
def test_bounce_matches_pallas_interpret(scene_name, do_mis):
    sc = SCENES[scene_name]()
    cam = jcamera_device(JCamera(width=W, height=H).as_pytree(), W, H)
    x, y = JCAM.pixel_grid(W, H)
    ro, rd, state = JCAM.generate_rays(cam, x, y, jnp.int32(0), use_dof=True)
    rays = jnp.concatenate([ro.T, rd.T], axis=0)
    _against_pallas(sc, rays, state[None, :].astype(jnp.uint32),
                    jnp.ones((1, W * H), jnp.int32), do_mis)


@pytest.mark.parametrize("lights", LANE_MIX_CASES)
def test_bounce_lane_mix_matches_pallas_interpret(lights):
    """K2's plain version against the Pallas bounce on the lane mix
    (``chip_smoke.py::lane_mix_box``): per-lane diffuse, metal, smooth
    metal, three-lobe and glass materials hit from both sides, dead and
    missed lanes, under each light type alone and all together.

    The float outputs are held on all but 0.5% of the lanes (0.2% on the
    camera rays above): the smooth metal samples GGX at the 0.04 roughness
    floor, where cos_t = sqrt((1 - r2) / (1 + (a^2 - 1) r2)) cancels as r2
    nears 1, and the dense glass refracts near its critical angle at every
    bounce, so XLA:CPU's fused multiply-adds move the next ray or the
    throughput by more than 1e-4 on up to 3 of 1,024 lanes (seeds 3-11, all
    six cases, four bounces), smooth-metal and dense-glass lanes only. The
    RNG states agree on every lane there."""
    sc = lane_mix_box(jmaterial_test_box, lights)
    n = W * H
    ro, rd, state, alive = lane_mix_rays(n, seed=len(lights))
    outs = _against_pallas(
        sc, jnp.asarray(np.concatenate([ro, rd])),
        jnp.asarray(state.astype(np.uint32))[None, :],
        jnp.asarray(alive.astype(np.int32))[None, :], do_mis=True,
        share=0.005)
    # The lane classes are there: at bounce 0, dead lanes, misses, and live
    # hits on every material, glass from both sides (back faces of the ior
    # 2.4 glass reflect totally past 25 degrees); every light type is drawn.
    t, idx, jout = outs[0]
    idx = np.asarray(idx)
    hit = alive & (idx >= 0)
    assert (~alive).sum() > 50 and (alive & (idx < 0)).sum() > 50
    mats = sc.tri_mat[idx[hit]]
    assert set(np.unique(mats)) >= set(range(len(sc.mat_metallic))) - {1, 3}
    tri = np.asarray(jpack(sc)["tri_isect"])[idx[hit]]
    normal = np.cross(tri[:, 3:6], tri[:, 6:9])
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    cos_i = (normal * rd.T[hit]).sum(1)
    back = cos_i > 0
    glass = sc.mat_transmission[mats] == 1.0
    assert (glass & back).sum() > 5 and (glass & ~back).sum() > 5
    # From inside, 5 degrees past the critical angle: no refraction for any
    # half-vector the 0.04 roughness floor samples near the normal.
    past = np.sin(np.arccos(np.clip(cos_i, 0.0, 1.0))) > np.sin(
        np.arcsin(1.0 / sc.mat_ior[mats]) + np.radians(5.0))
    assert (glass & back & past).sum() > 0
    assert sc.num_lights == 2 + (len(LANE_MIX_LIGHTS) if lights == "all"
                                 else lights != "emissive")


@pytest.mark.parametrize("scene_name", ["cornell", "material"])
def test_trace_cuda_loop_equals_plain_trace_on_cpu(scene_name):
    """The kernel-driving loop (``trace_cuda``) with its wrappers on CPU
    tensors runs the plain versions, and equals ``trace`` bit for bit."""
    sc = SCENES[scene_name]()
    scene = load_jax_scene(jpack(sc), "cpu")
    cam = camera_device(Camera(width=W, height=H).as_pytree(), W, H)
    x, y = PCAM.pixel_grid(W, H)
    ro, rd, state = PCAM.generate_rays(cam, x, y, 2, use_dof=True)
    before = (K2.Counter.launches,)
    a = K2.trace_cuda(scene, make_closest_hit(scene), ro, rd, state,
                      num_lights=sc.num_lights)
    b = TRACE.trace(scene, make_closest_hit(scene), ro, rd,
                    state, num_lights=sc.num_lights)
    assert (K2.Counter.launches,) == before
    for got, want in zip(a, b):
        assert torch.equal(got, want)


def test_wrapper_runs_the_plain_version_on_cpu():
    sc = jcornell_box()
    scene = load_jax_scene(jpack(sc), "cpu")
    rng = np.random.default_rng(0)
    n = 256
    rays = torch.from_numpy(np.concatenate(
        [rng.uniform(-0.5, 0.5, (3, n)) + [[0], [1], [0]],
         rng.normal(size=(3, n))]).astype(np.float32))
    t, idx = make_closest_hit(scene)(rays[0:3], rays[3:6])
    args = (1, rays, torch.from_numpy(rng.integers(0, 2**32, n)),
            torch.ones((3, n)), torch.zeros((3, n)),
            torch.ones(n, dtype=torch.bool), t, idx, scene["tri_full"],
            scene["light_full"])
    before = K2.Counter.launches
    got = K2.bounce_stage(*args, do_mis=True, num_lights=sc.num_lights)
    want = K2.bounce_stage_plain(*args, do_mis=True, num_lights=sc.num_lights)
    assert K2.Counter.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.uint8), w.view(torch.uint8))
    with pytest.raises(ValueError):
        K2.bounce_stage_cuda(*args, do_mis=True, num_lights=sc.num_lights)


def test_kernel_column_map_matches_types():
    """csrc/bounce.cu spells the tri_full / light_full column maps out; they
    must equal models/types.py's."""
    src = os.path.join(os.path.dirname(K2.__file__), "..", "csrc", "bounce.cu")
    with open(src) as f:
        consts = dict(re.findall(
            r"constexpr int ((?:TF|LF|LIGHT_TYPE)_\w+) = (\d+);", f.read()))
    assert len(consts) >= 30
    for name, value in consts.items():
        assert getattr(T, name) == int(value), name
