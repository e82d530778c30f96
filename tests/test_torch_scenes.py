"""The gallery atrium (``models/gallery.py``) and the cornell.glb replica
(``models/replica.py``) against the JAX package's: the same seeds and
parameters give array-equal ``SceneArrays`` (atlas and BVH included) and
packed tables. The JAX scenes are built on the JAX package's NumPy paths,
the ones the port copies (tests/test_torch_gltf.py says why).

No monkey.glb is in the repository: Suzanne is held by a stand-in file,
a ``scene_to_glb`` export, read by both packages.
"""

import dataclasses

import numpy as np
import pytest
import torch

from wgpu_path_tracing_tpu.accel import native as JNATIVE
from wgpu_path_tracing_tpu.models import export as JEXPORT
from wgpu_path_tracing_tpu.models import gallery as JGALLERY
from wgpu_path_tracing_tpu.models import gltf as JG
from wgpu_path_tracing_tpu.models import procedural as JP
from wgpu_path_tracing_tpu.models import replica as JREPLICA
from wgpu_path_tracing_tpu.models.types import pack_device_scene as jpack
from wgpu_path_tracing_tpu_torch import (
    Renderer,
    RenderConfig,
    cornell_replica,
    gallery_atrium,
)
from wgpu_path_tracing_tpu_torch.models import replica as REPLICA
from wgpu_path_tracing_tpu_torch.models.types import pack_device_scene

torch.set_num_threads(1)


@pytest.fixture
def jax_numpy(monkeypatch):
    monkeypatch.setattr(JNATIVE, "native_available", lambda: False)
    monkeypatch.setattr(JG, "native_available", lambda: False)


def assert_same_scene(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if x is None or y is None:
            assert x is None and y is None, f.name
            continue
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=f.name)


@pytest.fixture(scope="module")
def atrium():
    return gallery_atrium(detail=1)


def test_gallery_atrium_equals_jax(atrium, jax_numpy):
    assert_same_scene(atrium, JGALLERY.gallery_atrium(detail=1))
    assert atrium.num_triangles > 5000 and atrium.num_lights >= 3


def test_gallery_packs_the_fat_canvas_as_jax(atrium, jax_numpy):
    """tests/test_gallery.py: several map sets at mixed resolutions on one
    fat canvas; every table the port packs equals the JAX package's."""
    packed = pack_device_scene(atrium)
    assert "atlas_fat" in packed and packed["atlas_fat_rects"].shape[0] >= 5
    dims = np.asarray(packed["atlas_fat_rects"])[:, 18:20]
    assert len({tuple(d) for d in dims.tolist()}) > 1
    ref = jpack(JGALLERY.gallery_atrium(detail=1))
    for key, val in packed.items():
        if key in ref:
            np.testing.assert_array_equal(np.asarray(val),
                                          np.asarray(ref[key]), err_msg=key)


def test_gallery_renders(atrium):
    r = Renderer(RenderConfig(width=12, height=12, max_bounces=2),
                 device="cpu")
    r.load_scene(atrium)
    r.camera.position = np.array([0.0, 2.4, 3.0], np.float32)
    img = r.render(spp=1)
    assert r.stats()["intersector"] == "walk"
    assert r.stats()["texture"] == "fat"
    assert np.isfinite(img).all() and float(img.max()) > 0.0


@pytest.mark.parametrize("subdivisions", [0, 1, 2, 3])
def test_icosphere_equals_jax(subdivisions):
    got = REPLICA.icosphere((1.0, 2.0, 3.0), 0.5, subdivisions)
    want = JREPLICA.icosphere((1.0, 2.0, 3.0), 0.5, subdivisions)
    assert len(got[0]) == 20 * 4 ** subdivisions
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kw", [
    {}, {"pad_to": 8192}, {"overrides": {"ped_h": 0.7, "q_amp": 0.4}},
    {"max_leaf_size": 2, "num_bins": 8}], ids=["default", "pad_to",
                                               "overrides", "bvh_options"])
def test_cornell_replica_equals_jax(kw, jax_numpy):
    """The replica without Suzanne: the JAX package's file is absent here,
    so both take the missing-file branch."""
    got = cornell_replica(**kw)
    assert_same_scene(got, JREPLICA.cornell_replica(include_monkey=False,
                                                    **kw))
    if "pad_to" in kw:
        assert got.num_triangles == 8192
    assert got.num_lights == 2 and (got.mat_transmission > 0).sum() == 1


def test_cornell_replica_unknown_override_raises():
    with pytest.raises(KeyError):
        cornell_replica(overrides={"no_such_param": 1.0})


def test_cornell_replica_with_a_monkey_file(tmp_path, monkeypatch,
                                            jax_numpy):
    """Suzanne from a file: a stand-in .glb (a small sphere scene) read by
    both packages' ``_load_monkey``, recentred, scaled and turned alike."""
    stand_in = JP.cornell_box(tessellation=2)
    path = tmp_path / "monkey.glb"
    path.write_bytes(JEXPORT.scene_to_glb(stand_in))
    monkeypatch.setattr(JREPLICA, "MONKEY_GLB", str(path))
    got = cornell_replica(monkey_path=str(path))
    assert_same_scene(got, JREPLICA.cornell_replica())
    assert got.num_triangles > cornell_replica().num_triangles
    missing = cornell_replica(monkey_path=str(tmp_path / "none.glb"))
    assert_same_scene(missing, cornell_replica())
