"""The port's wide-BVH collapse (accel/bvh8.py) against the JAX package's.

Both packages must walk the same tree: ``build_wide_bvh`` and the walk
tables of ``pack_device_scene`` are array-equal (NaN boxes included) to the
JAX package's NumPy collapse, for the "none" and "ffd" packs, and the JAX
package's packed dict uploads through ``load_jax_scene`` with its integer
table still integer.
"""

import dataclasses

import numpy as np
import pytest
import torch

from wgpu_path_tracing_tpu.accel import bvh8 as JB
from wgpu_path_tracing_tpu.models import procedural as JP
from wgpu_path_tracing_tpu.models.types import pack_device_scene as jpack
from wgpu_path_tracing_tpu_torch import cornell_box, load_jax_scene
from wgpu_path_tracing_tpu_torch.accel import bvh8, native
from wgpu_path_tracing_tpu_torch.models.procedural import material_test_box
from wgpu_path_tracing_tpu_torch.models.types import (
    SceneArrays,
    pack_device_scene,
)

WALK = ("walk_order", "walk_boxes", "walk_tris")


def port_scene(jax_scene):
    """A JAX package SceneArrays as the port's (the fields are NumPy)."""
    return SceneArrays(**{f.name: getattr(jax_scene, f.name)
                          for f in dataclasses.fields(jax_scene)})


def _tree_inputs(name):
    """(aabb_min, aabb_max, meta, tri_isect) of a binary tree."""
    if name == "empty":
        return (np.zeros((1, 3), np.float32), np.zeros((1, 3), np.float32),
                np.zeros((1, 4), np.int32), np.zeros((0, 9), np.float32))
    if name == "oversized_leaf":
        # A root whose left child is a 200-triangle leaf (chunked past
        # LEAF_SLOTS) and whose right child is a small leaf.
        meta = np.array([[1, 2, 0, 0], [-1, -1, 0, 200], [-1, -1, 200, 10]],
                        np.int32)
        amin = np.array([[0, 0, 0], [0, 0, 0], [2, 2, 2]], np.float32)
        amax = np.array([[3, 3, 3], [1, 1, 1], [3, 3, 3]], np.float32)
        tri = np.random.default_rng(3).normal(size=(210, 9)).astype(np.float32)
        return amin, amax, meta, tri
    sc = (JP.random_triangles(1500, seed=5) if name == "random"
          else JP.cornell_box(tessellation=4))
    tri = jpack(sc)["tri_isect"][:sc.num_triangles]
    return sc.bvh_aabb_min, sc.bvh_aabb_max, sc.bvh_meta, tri


def _bits(a):
    return np.ascontiguousarray(a).view(np.uint32)


@pytest.mark.parametrize("pack", ["none", "ffd"])
@pytest.mark.parametrize("name", ["random", "cornell4", "empty",
                                  "oversized_leaf"])
def test_wide_tables_equal_jax(name, pack):
    args = _tree_inputs(name)
    port = bvh8.build_wide_bvh(*args, pack=pack)
    ref = JB.build_wide_bvh(*args, pack=pack, prefer_native=False)
    np.testing.assert_array_equal(port.meta, ref.meta)
    np.testing.assert_array_equal(port.order, ref.order)
    np.testing.assert_array_equal(_bits(port.boxes), _bits(ref.boxes))
    np.testing.assert_array_equal(_bits(port.tris), _bits(ref.tris))
    assert port.num_nodes == ref.num_nodes
    assert port.num_groups == ref.num_groups


@pytest.mark.parametrize("pack", ["none", "ffd"])
def test_every_triangle_sits_in_one_slot(pack):
    args = _tree_inputs("random")
    wb = bvh8.build_wide_bvh(*args, pack=pack)
    idx = wb.tris.reshape(-1, bvh8.group_rows(bvh8.SUB), 128)[:, 9, :]
    got = np.sort(idx[idx >= 0].astype(np.int64))
    np.testing.assert_array_equal(got, np.arange(args[3].shape[0]))
    # Padding slots carry index -1 and sit only after a group's triangles.
    assert ((idx >= 0) | (idx == -1)).all()


SCENES = {
    "cornell": (cornell_box, JP.cornell_box),
    "cornell4": (lambda: cornell_box(tessellation=4),
                 lambda: JP.cornell_box(tessellation=4)),
    "material": (material_test_box, JP.material_test_box),
    "random": (lambda: port_scene(JP.random_triangles(1500, seed=5)),
               lambda: JP.random_triangles(1500, seed=5)),
}


@pytest.mark.parametrize("name", list(SCENES))
def test_packed_walk_tables_equal_jax(name):
    port = pack_device_scene(SCENES[name][0]())
    ref = jpack(SCENES[name][1]())
    for key in (*WALK, "bvh_aabb"):
        assert port[key].dtype == ref[key].dtype, key
        np.testing.assert_array_equal(_bits(port[key]), _bits(ref[key]),
                                      err_msg=key)


def test_jax_packed_scene_uploads_with_integer_order():
    ref = jpack(JP.cornell_box(tessellation=4))
    scene = load_jax_scene(ref, "cpu")
    assert scene["walk_order"].dtype == torch.int32
    assert scene["walk_boxes"].dtype == torch.float32
    assert scene["walk_tris"].dtype == torch.float32
    for key in WALK:
        assert scene[key].is_contiguous()
        np.testing.assert_array_equal(_bits(scene[key].numpy()),
                                      _bits(ref[key]))
    # A dict without walk tables uploads without them.
    bare = load_jax_scene({k: v for k, v in ref.items() if k not in WALK},
                          "cpu")
    assert not set(WALK) & set(bare)


def test_stack_depth_guard(monkeypatch):
    """A wide tree deeper than the JAX walk's stack bound is refused, as in
    the JAX package, and pack_device_scene then omits the walk tables."""
    nn = 100  # an interior chain of depth 100
    wmeta = np.zeros((nn, 8), np.int32)
    for i in range(nn - 1):
        wmeta[i, 0] = i + 1
        wmeta[i, 1] = -(i + 1)
    assert bvh8.wide_depth(wmeta) == nn
    with pytest.raises(bvh8.WideBVHDepthError, match="pathologically deep"):
        bvh8._check_stack_depth(wmeta)
    with pytest.raises(JB.WideBVHDepthError):
        JB._check_stack_depth(wmeta)

    def too_deep(*args, **kwargs):
        raise bvh8.WideBVHDepthError("pathologically deep (simulated)")

    monkeypatch.setattr(bvh8, "build_wide_bvh", too_deep)
    with pytest.warns(UserWarning, match="walk tables skipped"):
        packed = pack_device_scene(cornell_box())
    assert not set(WALK) & set(packed)


def test_only_the_ported_packs_are_taken(monkeypatch):
    """Every pack and width of the JAX package is ported: "slice" and width
    16, which have no C++ twin, build in NumPy even with the library there
    (array-equal to the JAX builder, tests/test_torch_wide16.py); an
    unknown pack or width raises."""
    args = _tree_inputs("cornell4")

    def refuse(*a, **kw):
        raise AssertionError("the native collapse was called")

    monkeypatch.setattr(native, "native_available", lambda: True)
    monkeypatch.setattr(native, "build_wide_native", refuse)
    for pack, width in (("slice", 8), ("ffd", 16), ("none", 16)):
        wb = bvh8.build_wide_bvh(*args, pack=pack, width=width)
        ref = JB.build_wide_bvh(*args, pack=pack, width=width,
                                prefer_native=False)
        np.testing.assert_array_equal(wb.order, ref.order)
    with pytest.raises(ValueError, match="pack"):
        bvh8.build_wide_bvh(*args, pack="bins")
    with pytest.raises(ValueError, match="width"):
        bvh8.build_wide_bvh(*args, width=4)
