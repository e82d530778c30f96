"""The port's native scene-prep library (accel/native.py, accel/cbvh/*.cpp)
against the port's NumPy paths, bit for bit, and against the JAX
package's NumPy functions.

The library stands in for four NumPy paths: the SAH build
(``accel/bvh.py::build_bvh``), the wide collapse
(``accel/bvh8.py::build_wide_bvh(prefer_native=False)``), the glTF flatten
(``models/gltf.py::flatten_corners``) with the triangle reorder of
``finalize_scene``, and ``models/potpack.py::potpack_python``. Each must give
the same arrays, NaN bits of the wide boxes included. The JAX package's own
C++ SAH build is no reference: it sorts on double centroid keys and its
-march=native build contracts multiply-adds, and it builds another tree on
tessellated scenes. The JAX side is held to its NumPy functions only.

A compile that fails while g++ is present raises (no quiet NumPy), and two
processes that build at once both load a whole library.
"""

import copy
import os
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

from wgpu_path_tracing_tpu.accel import bvh as JBVH
from wgpu_path_tracing_tpu.accel import bvh8 as JB8
from wgpu_path_tracing_tpu.models import gltf as JG
from wgpu_path_tracing_tpu_torch import cornell_box, scene_to_glb
from wgpu_path_tracing_tpu_torch import textured_cornell
from wgpu_path_tracing_tpu_torch.accel import bvh as BVH
from wgpu_path_tracing_tpu_torch.accel import bvh8, native
from wgpu_path_tracing_tpu_torch.models import gltf
from wgpu_path_tracing_tpu_torch.models.potpack import potpack, potpack_python
from wgpu_path_tracing_tpu_torch.models.procedural import material_test_box

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANDOM_SIZES = (1, 4, 5, 37, 1000, 20000)  # the JAX tests/test_cbvh.py list
BVH_FIELDS = ("aabb_min", "aabb_max", "meta", "order")


@pytest.fixture(scope="module", autouse=True)
def library():
    """The library must build here: g++ is on PATH."""
    assert native.native_available(), "g++ is not on PATH"
    return native.lib()


def random_tris(n, seed):
    """The JAX tests/test_cbvh.py triangles."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    v1 = base + rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    v2 = base + rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    return base, v1, v2


def tied_centroids():
    """32 triangles along x whose x centroids tie in pairs in float32 and
    differ in float64: the first of each pair sits one float32 ulp above
    the tie, the second one below, so a sort on float64 keys swaps every
    pair and a stable sort on float32 keys keeps them."""
    v0, v1, v2 = [], [], []
    for i in range(16):
        x = np.float32(1.0 + i)
        for other in (np.nextafter(x, np.float32(np.inf)),
                      np.nextafter(x, np.float32(-np.inf))):
            v0.append([x, 0.0, 0.0])
            v1.append([x, 1.0, 0.0])
            v2.append([other, 0.0, 1.0])
    return tuple(np.asarray(v, np.float32) for v in (v0, v1, v2))


def tri_inputs(name):
    if name.startswith("random"):
        n = int(name[len("random"):])
        return random_tris(n, seed=n)
    if name == "cornell20":
        s = cornell_box(tessellation=20)
        return s.tri_v0, s.tri_v1, s.tri_v2
    return tied_centroids()


TRI_SETS = [f"random{n}" for n in RANDOM_SIZES] + ["cornell20", "ties"]


def assert_same_bvh(a, b):
    for field in BVH_FIELDS:
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field),
                                      err_msg=field)


@pytest.mark.parametrize("name", TRI_SETS)
def test_sah_build_equals_numpy(name):
    v = tri_inputs(name)
    assert_same_bvh(native.build_bvh_native(*v), BVH.build_bvh(*v))


@pytest.mark.parametrize("name", TRI_SETS)
def test_sah_build_equals_jax_numpy(name):
    v = tri_inputs(name)
    assert_same_bvh(native.build_bvh_native(*v), JBVH.build_bvh(*v))


def test_tied_centroids_keep_input_order():
    """The ties matter: the float64-key order of the JAX package's C++ SAH
    build differs from the float32-key order, which the library keeps."""
    v0, v1, v2 = tied_centroids()
    cx64 = (v0[:, 0].astype(np.float64) + v1[:, 0] + v2[:, 0]) / 3.0
    cx32 = cx64.astype(np.float32)
    assert len(np.unique(cx32)) == 16 and len(np.unique(cx64)) == 32
    assert not np.array_equal(np.argsort(cx64, kind="stable"),
                              np.argsort(cx32, kind="stable"))
    got = native.build_bvh_native(v0, v1, v2)
    np.testing.assert_array_equal(got.order, np.arange(32))


def wide_inputs(name):
    v = tri_inputs(name)
    tree = BVH.build_bvh(*v)
    tv = [np.asarray(a, np.float32)[tree.order] for a in v]
    tri = np.concatenate([tv[0], tv[1] - tv[0], tv[2] - tv[0]], axis=1)
    return tree.aabb_min, tree.aabb_max, tree.meta, tri


def assert_same_wide(a, b):
    for field in ("meta", "order", "boxes", "tris"):
        x, y = getattr(a, field), getattr(b, field)
        if x.dtype == np.float32:  # NaN-aware: the bits
            x, y = x.view(np.uint32), y.view(np.uint32)
        np.testing.assert_array_equal(x, y, err_msg=field)


@pytest.mark.parametrize("pack", ["none", "ffd"])
@pytest.mark.parametrize("name", ["random1000", "random20000", "cornell20"])
def test_wide_collapse_equals_numpy_and_jax(name, pack):
    args = wide_inputs(name)
    got = bvh8.build_wide_bvh(*args, pack=pack)
    assert_same_wide(got, bvh8.build_wide_bvh(*args, pack=pack,
                                              prefer_native=False))
    assert_same_wide(got, JB8.build_wide_bvh(*args, pack=pack,
                                             prefer_native=False))


def pack_boxes(seed, ints):
    rng = random.Random(seed)
    if ints:
        return [{"w": rng.randrange(1, 300), "h": rng.randrange(1, 300),
                 "x": 0, "y": 0} for _ in range(rng.randrange(1, 60))]
    return [{"w": rng.randrange(2, 600) * 0.5, "h": rng.randrange(2, 600) * 0.5,
             "x": 0, "y": 0} for _ in range(rng.randrange(1, 60))]


@pytest.mark.parametrize("ints", [True, False])
def test_potpack_equals_python_and_jax(ints):
    for seed in range(20):
        boxes = pack_boxes(seed, ints)
        got, py, jax_py = (copy.deepcopy(boxes) for _ in range(3))
        dims = potpack(got)
        assert dims == potpack_python(py) == JG.potpack_python(jax_py)
        for g, p, j in zip(got, py, jax_py):
            assert (g["x"], g["y"]) == (p["x"], p["y"]) == (j["x"], j["y"])
            if ints:
                assert type(g["x"]) is int and type(g["y"]) is int
        if ints:
            assert all(type(d) is int for d in dims)


def flatten_inputs(identity):
    """The JAX tests/test_flatten_native.py primitive: 4,096 vertices, 6,000
    triangles, zero normals every 97th vertex."""
    rng = np.random.default_rng(11)
    nv, k = 4096, 6000
    pos = rng.uniform(-50, 50, (nv, 3)).astype(np.float32)
    nrm = rng.normal(0, 1, (nv, 3)).astype(np.float32)
    nrm[::97] = 0.0
    idx = rng.integers(0, nv, 3 * k).astype(np.int64)
    world = np.eye(4)
    if not identity:
        world[0:3, 0:3] = rng.normal(0, 1, (3, 3)) + np.eye(3) * 2.0
        world[0:3, 3] = rng.uniform(-5, 5, 3)
    return pos, nrm, world, np.linalg.inv(world).T, idx


@pytest.mark.parametrize("identity", [True, False])
def test_flatten_equals_numpy(identity):
    args = flatten_inputs(identity)
    got = native.flatten_native(*args)
    want = gltf.flatten_corners(*args)
    for name, a, b in zip(("v0", "v1", "v2", "n0", "n1", "n2"), got, want):
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32),
                                      err_msg=name)


def test_flatten_rejects_an_index_out_of_range():
    with pytest.raises(RuntimeError, match="out of range"):
        native.flatten_native(np.zeros((4, 3), np.float32),
                              np.ones((4, 3), np.float32), np.eye(4),
                              np.eye(4), np.array([0, 1, 9], np.int64))


def test_reorder_equals_numpy():
    rng = np.random.default_rng(12)
    n = 5000
    order = rng.permutation(n).astype(np.int64)
    cols3 = [rng.normal(0, 1, (n, 3)).astype(np.float32) for _ in range(6)]
    cols2 = [rng.normal(0, 1, (n, 2)).astype(np.float32) for _ in range(3)]
    mat = rng.integers(0, 17, n).astype(np.int32)
    got = native.reorder_tris_native(order, *cols3, *cols2, mat)
    for a, b in zip(cols3 + cols2 + [mat], got):
        np.testing.assert_array_equal(a[order], b)


@pytest.mark.parametrize("make", [textured_cornell, material_test_box],
                         ids=["textured_cornell", "material_test_box"])
def test_load_model_equals_the_numpy_loaders(make, tmp_path, monkeypatch):
    """A whole glTF load through the library (flatten, potpack, SAH build,
    reorder) against the same load with no compiler (every NumPy path)."""
    path = str(tmp_path / "scene.glb")
    with open(path, "wb") as f:
        f.write(scene_to_glb(make()))
    got = gltf.load_model(path)
    monkeypatch.setattr(native, "compiler", lambda: None)
    assert not native.native_available()
    want = gltf.load_model(path)
    for field in got.__dataclass_fields__:
        a, b = getattr(got, field), getattr(want, field)
        if a is None or b is None:
            assert a is b, field
        else:
            np.testing.assert_array_equal(a, b, err_msg=field)


def test_no_compiler_takes_the_numpy_build(monkeypatch):
    v = random_tris(300, seed=3)
    monkeypatch.setattr(native, "compiler", lambda: None)
    monkeypatch.setattr(native, "build_bvh_native", None)  # must not run
    assert_same_bvh(native.build_bvh(*v), BVH.build_bvh(*v))


def test_a_failed_compile_raises(tmp_path, monkeypatch):
    """g++ present, the sources broken: the build raises with g++'s report,
    and a loader that needs the library raises too."""
    src = tmp_path / "cbvh"
    src.mkdir()
    for name in native.SOURCES:
        text = open(os.path.join(native.SRC_DIR, name)).read()
        if name == "bvh_builder.cpp":
            text += "\nthis is not C++;\n"
        (src / name).write_text(text)
    monkeypatch.setattr(native, "SRC_DIR", str(src))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native._Lib, "handle", None)
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*not C\\+\\+"):
        native.build()
    assert not os.listdir(tmp_path / "build")  # no half-written library
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build_bvh(*random_tris(10, seed=1))


def test_two_processes_build_at_once(tmp_path):
    """Two processes build the library into one empty directory at once;
    each loads a whole library and builds the same tree."""
    script = (
        "import sys\n"
        "import numpy as np\n"
        "from wgpu_path_tracing_tpu_torch.accel import native\n"
        "native.BUILD_DIR = sys.argv[1]\n"
        "rng = np.random.default_rng(0)\n"
        "v = [rng.normal(size=(500, 3)).astype(np.float32) for _ in range(3)]\n"
        "print(native.build_bvh_native(*v).meta.sum())\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    build_dir = str(tmp_path / "build")
    procs = [subprocess.Popen([sys.executable, "-c", script, build_dir],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env) for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    assert outs[0][0] == outs[1][0]
    libs = os.listdir(build_dir)
    assert libs == [os.path.basename(native.library_path())], libs
