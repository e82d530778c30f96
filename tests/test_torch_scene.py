"""The port's host side against the JAX package's, and its import rules.

The port carries its own copies of the numpy scene code (every module of
the JAX package imports jax, and the port must run without it). These tests
keep the copies bit-equal to the originals, and keep the port free of jax,
Pillow and ml_dtypes.
"""

import dataclasses
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from wgpu_path_tracing_tpu.models import procedural as JP
from wgpu_path_tracing_tpu.models.types import pack_device_scene as jpack
from wgpu_path_tracing_tpu_torch import (
    Renderer,
    RenderConfig,
    cornell_box,
    load_jax_scene,
    material_test_box,
    textured_cornell,
)
from wgpu_path_tracing_tpu_torch.models.types import (
    DEVICE_KEYS,
    OPTIONAL_KEYS,
    pack_device_scene,
)
from wgpu_path_tracing_tpu_torch.accel import bvh8

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "wgpu_path_tracing_tpu_torch")

SCENES = [(cornell_box, JP.cornell_box),
          (material_test_box, JP.material_test_box),
          (lambda: cornell_box(tessellation=3), lambda: JP.cornell_box(
              tessellation=3)),
          (textured_cornell, JP.textured_cornell)]


@pytest.mark.parametrize("k", range(len(SCENES)))
def test_scene_arrays_equal_jax(k):
    """Every SceneArrays field, BVH order included, is bit-equal."""
    port, ref = SCENES[k][0](), SCENES[k][1]()
    for field in dataclasses.fields(ref):
        a, b = getattr(port, field.name), getattr(ref, field.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, field.name
            np.testing.assert_array_equal(a, b, err_msg=field.name)
        else:
            assert a == b, field.name


@pytest.mark.parametrize("k", range(len(SCENES)))
def test_packed_tables_equal_jax(k):
    port = pack_device_scene(SCENES[k][0]())
    ref = jpack(SCENES[k][1]())
    for key in DEVICE_KEYS:
        assert (key in port) == (key in ref), key
        if key in OPTIONAL_KEYS and key not in ref:
            continue
        assert port[key].dtype == ref[key].dtype, key
        np.testing.assert_array_equal(port[key], ref[key], err_msg=key)


def test_load_jax_scene_uploads_the_same_tables():
    for make_ref, make_port, fat, slots in (
            (JP.cornell_box, cornell_box, False, (False,) * 4),
            (JP.textured_cornell, textured_cornell, True,
             (True, True, False, True))):
        a = load_jax_scene(jpack(make_ref()), "cpu")
        b = load_jax_scene(pack_device_scene(make_port()), "cpu")
        # The JAX-only tables are left behind; only a textured scene whose
        # packing baked a fat canvas uploads it. The texture-slot mask is
        # worked out once, at upload, and the root box is bvh_aabb's row 0.
        want = set(DEVICE_KEYS) - (set() if fat else {"atlas_fat",
                                                     "atlas_fat_rects"})
        assert set(a) == set(b) == want | {"texture_slots_used", "root_box"}
        assert a["texture_slots_used"] == b["texture_slots_used"] == slots
        assert torch.equal(a["root_box"],
                           torch.from_numpy(jpack(make_ref())["bvh_aabb"][0]))
        assert torch.equal(a["root_box"], b["root_box"])
        for key in want:
            dtype = DEVICE_KEYS[key]
            assert a[key].dtype == torch.from_numpy(np.zeros(1, dtype)).dtype
            assert a[key].is_contiguous()
            # walk_boxes holds NaN on empty child slots.
            assert torch.equal(a[key].view(torch.uint8),
                               b[key].view(torch.uint8)), key
        assert a["walk_order"].dtype == torch.int32


def test_port_imports_no_jax_and_renders_on_cpu():
    """A process where jax, Pillow and ml_dtypes cannot be imported imports
    the port and renders 16x16 at 1 spp on the CPU."""
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'PIL', 'ml_dtypes'):\n"
        "    sys.modules[m] = None\n"
        "import numpy as np\n"
        "from wgpu_path_tracing_tpu_torch import Renderer, RenderConfig, "
        "cornell_box\n"
        "r = Renderer(RenderConfig(width=16, height=16), device='cpu')\n"
        "r.load_scene(cornell_box())\n"
        "img = r.render(spp=1)\n"
        "assert img.shape == (16, 16, 3) and np.isfinite(img).all()\n"
        "assert r.stats()['rays_closest'] > 0\n"
        "assert not any(m == 'wgpu_path_tracing_tpu' or "
        "m.startswith('wgpu_path_tracing_tpu.') for m in sys.modules)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_sources_import_no_jax_pillow_or_reference_package():
    pattern = re.compile(
        r"import jax|from jax|wgpu_path_tracing_tpu\.|from PIL|import PIL"
        r"|ml_dtypes")
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PKG):
        files += [os.path.join(root, n) for n in names
                  if n.endswith((".py", ".cu", ".cuh"))]
    offenders = []
    for path in files:
        with open(path) as f:
            for no, line in enumerate(f, 1):
                if pattern.search(line):
                    offenders.append(f"{path}:{no}: {line.strip()}")
    assert not offenders, "\n".join(offenders)


def test_cuda_without_a_card_raises():
    """No silent CPU fallback: asking for CUDA without it raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError):
        Renderer(RenderConfig(width=8, height=8), device="cuda")
    with pytest.raises(RuntimeError):
        load_jax_scene(pack_device_scene(cornell_box()), "cuda")


def test_unported_paths_raise(monkeypatch):
    # The rng modes are ported; only the JAX package's three are taken.
    for rng in ("hash", "stratified"):
        RenderConfig(rng=rng).validate()
    with pytest.raises(ValueError):
        RenderConfig(rng="sobol").validate()
    # Every intersector of the JAX package is taken, "walk_hbm" (its paged
    # walk, which the port runs as K3) included.
    for name in ("auto", "brute", "walk", "walk_hbm", "pairs", "phased",
                 "cluster", "bvh", "stack"):
        RenderConfig(intersector=name).validate()
    with pytest.raises(ValueError):
        RenderConfig(intersector="nonsense").validate()
    # A scene above brute_force_max_tris without walk tables (a wide tree
    # too deep for the walk's stack) renders through the pair dispatch K4.
    def too_deep(*args, **kwargs):
        raise bvh8.WideBVHDepthError("pathologically deep (simulated)")

    monkeypatch.setattr(bvh8, "build_wide_bvh", too_deep)
    r = Renderer(RenderConfig(width=8, height=8, brute_force_max_tris=16),
                 device="cpu")
    with pytest.warns(UserWarning, match="walk tables skipped"):
        r.load_scene(cornell_box())
    assert r.stats()["intersector"] == "pairs"
    img = r.render(spp=1)
    assert img.shape == (8, 8, 3) and np.isfinite(img).all() and img.max() > 0
    monkeypatch.undo()
    # Textured scenes are ported: a 4x4 atlas loads and samples its canvas.
    textured = cornell_box()
    textured.atlas = np.ones((4, 4, 4), np.float32)
    textured.mat_albedo_rect[0] = [0, 0, 2, 2]
    r = Renderer(RenderConfig(width=8, height=8), device="cpu")
    r.load_scene(textured)
    assert r.stats()["texture"] in ("per_slot", "fat")


def test_quantize_atlas_matches_jax():
    """The port rounds atlas texels to bfloat16 values with integer bit
    operations; the JAX package does it with ml_dtypes. Same bits."""
    from wgpu_path_tracing_tpu.models.assemble import quantize_atlas as jq
    from wgpu_path_tracing_tpu_torch.models.assemble import quantize_atlas

    rng = np.random.default_rng(5)
    a = rng.uniform(0.0, 1.0, (64, 64, 4)).astype(np.float32)
    # Exact ties (low 16 bits 0x8000) round to even in both. Finite values
    # only, as texels are: the two treat NaN payloads differently.
    ties = (rng.integers(0, 0x7F00, 256, dtype=np.uint32) << 16) | 0x8000
    a.reshape(-1)[:256] = ties.view(np.float32)
    np.testing.assert_array_equal(quantize_atlas(a).view(np.uint32),
                                  jq(a).view(np.uint32))
