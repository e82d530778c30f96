"""The port's glTF loader (``models/gltf.py``) and its Pillow stand-ins
(``utils/image.py::decode_png_rgba``, ``resize_bilinear_u8``) against the
JAX package's loader and Pillow, and the ``Renderer``'s ``load_model``,
``load_model_async`` and ``poll_pending_scene``.

The repository holds no .glb file, so the loader is held against round
trips through ``scene_to_glb``: one file, read by the JAX loader and by the
port's, must give equal ``SceneArrays``, every array exactly, the atlas and
the BVH included. The JAX loader runs on its NumPy paths (``jax_numpy``):
the SAH build, flatten, potpack and reorder that its native library is the
twin of and that the port copies. Its native SAH build is not the same
tree as the NumPy one on the atrium (12,942 triangles: 8,589 nodes against
8,601), so the native one is no reference for the port.
"""

import base64
import dataclasses
import io
import json
import struct
import threading
import warnings

import numpy as np
import pytest
import torch
from PIL import Image

from wgpu_path_tracing_tpu.accel import native as JNATIVE
from wgpu_path_tracing_tpu.models import export as JEXPORT
from wgpu_path_tracing_tpu.models import gallery as JGALLERY
from wgpu_path_tracing_tpu.models import gltf as JG
from wgpu_path_tracing_tpu.models import procedural as JP
from wgpu_path_tracing_tpu_torch import (
    Renderer,
    RenderConfig,
    cornell_box,
    gallery_atrium,
    material_test_box,
    scene_to_glb,
    single_triangle,
    textured_cornell,
)
from wgpu_path_tracing_tpu_torch.models import gltf as G
from wgpu_path_tracing_tpu_torch.utils import image as IMAGE
from tests import torch_png_cases as PNG

torch.set_num_threads(1)


@pytest.fixture
def jax_numpy(monkeypatch):
    """The JAX loader on its NumPy paths (see the module docstring)."""
    monkeypatch.setattr(JNATIVE, "native_available", lambda: False)
    monkeypatch.setattr(JG, "native_available", lambda: False)


def assert_same_scene(a, b):
    """Every array of two ``SceneArrays`` equal, exactly."""
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if x is None or y is None:
            assert x is None and y is None, f.name
            continue
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=f.name)


def _write(tmp_path, name, data: bytes) -> str:
    path = tmp_path / name
    path.write_bytes(data)
    return str(path)


# --- the Pillow stand-ins ----------------------------------------------------


def _pillow_png(im: Image.Image) -> bytes:
    buf = io.BytesIO()
    kw = {}
    if "transparency" in im.info:
        kw["transparency"] = im.info["transparency"]
    im.save(buf, "PNG", **kw)
    return buf.getvalue()


@pytest.mark.parametrize("mode, trns", [
    ("L", False), ("L", True), ("LA", False), ("RGB", False), ("RGB", True),
    ("RGBA", False), ("P", False), ("P", True)])
def test_decode_png_rgba_equals_pillow(mode, trns):
    """Colour types 0, 4, 2, 6 and 3 (with ``tRNS`` where the type takes
    one: a gray value, an RGB colour, per-palette-entry alphas), odd
    sizes: what ``Image.open(...).convert("RGBA")`` returns."""
    rng = np.random.default_rng(len(mode) * 7 + trns)
    h, w = 13, 17
    if mode == "P":
        rgb = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        im = Image.fromarray(rgb).convert("P", palette=Image.ADAPTIVE,
                                          colors=40)
        if trns:
            im.info["transparency"] = bytes(
                rng.integers(0, 256, 30, dtype=np.uint8))
    else:
        arr = rng.integers(0, 256, (h, w, len(mode)), dtype=np.uint8)
        if trns:
            arr[1, 2] = arr[0, 0]  # the transparent value, twice
        im = Image.fromarray(arr[..., 0] if mode == "L" else arr, mode)
        if trns:
            key = arr[0, 0]
            im.info["transparency"] = (int(key[0]) if mode == "L"
                                       else tuple(int(v) for v in key))
    data = _pillow_png(im)
    with Image.open(io.BytesIO(data)) as ref:
        want = np.asarray(ref.convert("RGBA"))
    np.testing.assert_array_equal(IMAGE.decode_png_rgba(data), want)


@pytest.mark.parametrize("interlace", [0, 1])
@pytest.mark.parametrize("kind", sorted(PNG.KINDS))
def test_decode_png_rgba_reads_every_kind_as_pillow(kind, interlace):
    """Every bit depth of every colour type, with tRNS where the type takes
    one, Adam7 or not, each row under another filter type, at odd sizes and
    sizes under 8 (empty Adam7 passes): what ``Image.open(...).convert(
    "RGBA")`` returns; and ``convert("RGB")`` is its RGB on each."""
    for k, (h, w) in enumerate(PNG.SIZES):
        data = PNG.case(kind, h, w, interlace, seed=k)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # Pillow on tRNS palettes
            with Image.open(io.BytesIO(data)) as ref:
                want = np.asarray(ref.convert("RGBA"))
                rgb = np.asarray(ref.convert("RGB"))
        np.testing.assert_array_equal(IMAGE.decode_png_rgba(data), want,
                                      err_msg=f"{kind} {h}x{w}")
        np.testing.assert_array_equal(rgb, want[..., :3])


def test_decode_png_rgba_refuses_what_it_cannot_read():
    """16-bit (Pillow's "I;16", clipped at 255) and Adam7-interlaced PNGs
    decode as Pillow decodes them; a bit depth the colour type does not
    allow raises, and JPEG bytes (``decode_image_rgba`` reads them) are no
    PNG."""
    rng = np.random.default_rng(11)
    sixteen = rng.integers(0, 600, (3, 4)).astype(np.uint16)
    data = _pillow_png(Image.fromarray(sixteen, "I;16"))
    with Image.open(io.BytesIO(data)) as ref:
        assert ref.mode == "I;16"
        np.testing.assert_array_equal(IMAGE.decode_png_rgba(data),
                                      np.asarray(ref.convert("RGBA")))
    rgb = rng.integers(0, 256, (11, 6, 3))
    data = PNG.write_png(rgb, 8, 2, interlace=1)
    with Image.open(io.BytesIO(data)) as ref:
        np.testing.assert_array_equal(IMAGE.decode_png_rgba(data),
                                      np.asarray(ref.convert("RGBA")))
    bad = bytearray(PNG.write_png(rgb, 8, 2))
    bad[24] = 4  # IHDR's bit depth: 4-bit RGB does not exist
    with pytest.raises(ValueError, match="bit depth 4, colour type 2"):
        IMAGE.decode_png_rgba(bytes(bad))
    buf = io.BytesIO()
    Image.new("RGB", (8, 8), (200, 10, 10)).save(buf, "JPEG")
    with pytest.raises(ValueError, match="wall.jpg: not a PNG"):
        IMAGE.decode_png_rgba(buf.getvalue(), "wall.jpg")


@pytest.mark.parametrize("ratio", [0.5, 1.0, 0.25, 0.37, 2.0])
@pytest.mark.parametrize("alpha", ["opaque", "random", "binary"])
def test_resize_bilinear_u8_equals_pillow(ratio, alpha):
    """Odd sizes, the atlas's 0.5 and 1, other ratios down and up, each
    with opaque, random and 0/255 alpha (Pillow premultiplies RGBA)."""
    rng = np.random.default_rng(int(ratio * 100) + len(alpha))
    for _ in range(3):
        h, w = (int(v) for v in rng.integers(1, 60, 2))
        img = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
        if alpha == "opaque":
            img[..., 3] = 255
        elif alpha == "binary":
            img[..., 3] = rng.choice([0, 255], (h, w))
        size = (max(1, int(w * ratio)), max(1, int(h * ratio)))
        want = np.asarray(Image.fromarray(img).resize(size, Image.BILINEAR))
        np.testing.assert_array_equal(IMAGE.resize_bilinear_u8(img, size),
                                      want)


def test_encode_png_takes_rgba_and_rgb_bytes():
    rng = np.random.default_rng(3)
    for ch in (3, 4):
        img = rng.integers(0, 256, (7, 9, ch), dtype=np.uint8)
        with Image.open(io.BytesIO(IMAGE.encode_png(img))) as im:
            np.testing.assert_array_equal(np.asarray(im), img)
        assert IMAGE.decode_png_rgba(IMAGE.encode_png(img))[..., :ch].tolist(
        ) == img.tolist()


# --- GLTFFile, transforms, materials -----------------------------------------


def _sparse_gltf(tmp_path) -> str:
    """tests/test_gltf.py::test_sparse_accessor_decode's document: a sparse
    overlay on a base view, and one on no view (zeros)."""
    base = [(float(i), 0.0, 0.0) for i in range(5)]
    buf = b"".join(struct.pack("<3f", *p) for p in base)
    buf += struct.pack("<2H", 1, 3)
    buf += struct.pack("<3f", 9, 9, 9) + struct.pack("<3f", 7, 7, 7)
    sparse = {"count": 2,
              "indices": {"bufferView": 1, "componentType": 5123},
              "values": {"bufferView": 2}}
    gltf = {
        "asset": {"version": "2.0"},
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 5,
             "type": "VEC3", "sparse": sparse},
            {"componentType": 5126, "count": 5, "type": "VEC3",
             "sparse": sparse},
        ],
        "bufferViews": [
            {"buffer": 0, "byteOffset": 0, "byteLength": 60},
            {"buffer": 0, "byteOffset": 60, "byteLength": 4},
            {"buffer": 0, "byteOffset": 64, "byteLength": 24},
        ],
        "buffers": [{"byteLength": len(buf),
                     "uri": "data:application/octet-stream;base64,"
                            + base64.b64encode(buf).decode()}],
    }
    return _write(tmp_path, "sparse.gltf", json.dumps(gltf).encode())


def test_sparse_accessors_equal_jax(tmp_path):
    path = _sparse_gltf(tmp_path)
    port, ref = G.GLTFFile.load(path), JG.GLTFFile.load(path)
    for i in range(2):
        np.testing.assert_array_equal(port.accessor(i), ref.accessor(i))
    want = np.zeros((5, 3), np.float32)
    want[1], want[3] = 9, 7
    np.testing.assert_array_equal(port.accessor(1), want)


def test_interleaved_and_normalized_accessors_equal_jax(tmp_path):
    """A byteStride view holding uint8 and int16 components side by side,
    read raw and normalized (uint8 / 255, int16 / 32767 floored at -1)."""
    rng = np.random.default_rng(9)
    rows = 6
    u8 = rng.integers(0, 256, (rows, 4), dtype=np.uint8)
    i16 = rng.integers(-32768, 32768, (rows, 2), dtype=np.int16)
    buf = b"".join(u8[r].tobytes() + i16[r].tobytes() for r in range(rows))
    view = {"buffer": 0, "byteOffset": 0, "byteLength": len(buf),
            "byteStride": 8}
    gltf = {
        "asset": {"version": "2.0"},
        "accessors": [
            {"bufferView": 0, "componentType": 5121, "count": rows,
             "type": "VEC4"},
            {"bufferView": 0, "componentType": 5121, "count": rows,
             "type": "VEC4", "normalized": True},
            {"bufferView": 0, "byteOffset": 4, "componentType": 5122,
             "count": rows, "type": "VEC2", "normalized": True},
        ],
        "bufferViews": [view],
        "buffers": [{"byteLength": len(buf),
                     "uri": "data:application/octet-stream;base64,"
                            + base64.b64encode(buf).decode()}],
    }
    path = _write(tmp_path, "mixed.gltf", json.dumps(gltf).encode())
    port, ref = G.GLTFFile.load(path), JG.GLTFFile.load(path)
    np.testing.assert_array_equal(port.accessor(0), u8)
    for i in range(3):
        a, b = port.accessor(i), ref.accessor(i)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_sidecar_uris_and_bad_files(tmp_path):
    """tests/test_gltf.py::test_external_sidecar_uris: a sidecar .bin and
    image with percent-encoded names; a missing image is None; a file that
    is neither GLB nor JSON raises."""
    buf = struct.pack("<3f", 1.0, 2.0, 3.0)
    (tmp_path / "mesh data.bin").write_bytes(buf)
    png = IMAGE.encode_png(np.zeros((2, 2, 4), np.uint8))
    (tmp_path / "tex image.png").write_bytes(png)
    gltf = {"asset": {"version": "2.0"},
            "accessors": [{"bufferView": 0, "componentType": 5126,
                           "count": 1, "type": "VEC3"}],
            "bufferViews": [{"buffer": 0, "byteLength": len(buf)}],
            "buffers": [{"byteLength": len(buf), "uri": "mesh%20data.bin"}],
            "images": [{"uri": "tex%20image.png"}, {"uri": "missing.png"}]}
    path = _write(tmp_path, "sidecar.gltf", json.dumps(gltf).encode())
    f = G.GLTFFile.load(path)
    np.testing.assert_array_equal(f.accessor(0),
                                  JG.GLTFFile.load(path).accessor(0))
    assert f.image_bytes(0) == png and f.image_bytes(1) is None
    bad = _write(tmp_path, "bad.glb", b"\x00" * 64)
    with pytest.raises(Exception):
        G.GLTFFile.load(bad)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_node_transforms_equal_jax(seed):
    """T * R * S and column-major matrices, quaternions both ways, and the
    parent-chain walk over a random node tree."""
    rng = np.random.default_rng(seed)
    nodes = []
    for i in range(6):
        q = rng.normal(size=4)
        node = {"translation": list(rng.normal(size=3)),
                "rotation": list(q / np.linalg.norm(q)),
                "scale": list(rng.uniform(0.5, 2.0, 3))}
        if i == 3:
            node = {"matrix": list(rng.normal(size=16))}
        nodes.append(node)
    nodes[0]["children"] = [1, 2]
    nodes[2]["children"] = [3]
    nodes[3]["children"] = [4]
    gltf = {"nodes": nodes}
    for node in nodes:
        np.testing.assert_array_equal(G._node_local_matrix(node),
                                      JG._node_local_matrix(node))
    for a, b in zip(G._world_matrices(gltf), JG._world_matrices(gltf)):
        np.testing.assert_array_equal(a, b)
    for node in nodes:
        if "rotation" in node:
            m = G._quat_to_mat3(node["rotation"])
            np.testing.assert_array_equal(m, JG._quat_to_mat3(node["rotation"]))
            np.testing.assert_array_equal(G._mat3_to_quat(m),
                                          JG._mat3_to_quat(m))
    # tests/test_gltf.py::test_node_trs_order: scale first, then rotate.
    m = G._node_local_matrix({"translation": [1.0, 0.0, 0.0],
                              "rotation": [0.0, 0.0, 0.7071068, 0.7071068],
                              "scale": [2.0, 1.0, 1.0]})
    np.testing.assert_allclose((m @ [1.0, 0.0, 0.0, 1.0])[:3], [1, 2, 0],
                               atol=1e-6)


@pytest.mark.parametrize("mat", [
    None, {},
    {"pbrMetallicRoughness": {"baseColorFactor": [0.5, 0.25, 1.0, 1.0],
                              "metallicFactor": 0.3},
     "emissiveFactor": [1.0, 2.0, 3.0],
     "extensions": {
         "KHR_materials_emissive_strength": {"emissiveStrength": 7.5},
         "KHR_materials_ior": {"ior": 1.31},
         "KHR_materials_transmission": {"transmissionFactor": 0.9}}},
], ids=["none", "empty", "khr"])
def test_build_material_equals_jax(mat):
    rects = {"albedo": [1, 2, 3, 4]}
    assert G._build_material(mat, None) == JG._build_material(mat, None)
    if mat is not None:
        assert G._build_material(mat, rects) == JG._build_material(mat, rects)


# --- load_model: round trips read by both loaders ----------------------------


def spot_box(pkg=None):
    """``material_test_box`` with its lights replaced by one spot light
    (tests/test_export_glb.py::test_roundtrip_spot_light's)."""
    ref = (pkg or material_test_box)()
    ref.light_type = np.array([3], np.int32)
    ref.light_position = np.array([[0.2, 1.5, 0.3]], np.float32)
    ref.light_color = np.array([[1.0, 0.9, 0.8]], np.float32)
    ref.light_intensity = np.array([7.0], np.float32)
    d = np.array([0.3, -0.9, 0.1])
    d /= np.linalg.norm(d)
    cos_i, cos_o = np.cos(0.2), np.cos(0.5)
    scale = 1.0 / (cos_i - cos_o)
    ref.light_aux = np.array([[d[0], d[1], d[2], scale, -cos_o * scale]],
                             np.float32)
    return ref


ROUND_TRIPS = {
    "cornell_box": (cornell_box, JP.cornell_box),
    "material_test_box": (material_test_box, JP.material_test_box),
    "textured_cornell": (textured_cornell, JP.textured_cornell),
    "spot_light": (spot_box, lambda: spot_box(JP.material_test_box)),
    "gallery_atrium": (lambda: gallery_atrium(detail=1),
                       lambda: JGALLERY.gallery_atrium(detail=1)),
}


@pytest.mark.parametrize("name", list(ROUND_TRIPS))
def test_load_model_equals_jax_loader(name, tmp_path, jax_numpy):
    """The port's GLB of each scene, read by both loaders: equal arrays.
    The JAX exporter's GLB of the same scene, read by the port's loader,
    gives the same arrays too (the PNG bytes differ, the pixels do not)."""
    make, jmake = ROUND_TRIPS[name]
    path = _write(tmp_path, "port.glb", scene_to_glb(make()))
    kw = dict(enable_spot_lights=name == "spot_light")
    got = G.load_model(path, **kw)
    assert_same_scene(got, JG.load_model(path, **kw))
    jpath = _write(tmp_path, "jax.glb", JEXPORT.scene_to_glb(jmake()))
    assert_same_scene(got, G.load_model(jpath, **kw))
    if name in ("textured_cornell", "gallery_atrium"):
        assert got.atlas.shape[0] > 1
        assert (got.mat_albedo_rect[:, 2] > 0).any()


def test_load_model_options_equal_jax(tmp_path, jax_numpy):
    """``texture_pixel_ratio`` 1 and a shallower BVH build; spot lights off
    warn and skip, as in the reference."""
    path = _write(tmp_path, "t.glb", scene_to_glb(textured_cornell()))
    kw = dict(texture_pixel_ratio=1.0, max_leaf_size=2, num_bins=8)
    assert_same_scene(G.load_model(path, **kw), JG.load_model(path, **kw))
    spot = _write(tmp_path, "s.glb", scene_to_glb(spot_box()))
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        got = G.load_model(spot)
    assert any("Unsupported light type: spot" in str(w.message) for w in rec)
    assert (got.light_type != 3).all()
    assert_same_scene(got, JG.load_model(spot))


def _quad_gltf(tmp_path, image: dict | None = None, indexed=True) -> str:
    """One quad; ``image`` (a glTF image entry) becomes its base colour
    texture."""
    pos = np.array([(-1, 0, -1), (1, 0, -1), (1, 0, 1), (-1, 0, 1)],
                   np.float32)
    nrm = np.tile(np.array([0, 1, 0], np.float32), (4, 1))
    idx = np.array([0, 2, 1, 0, 3, 2], np.uint16)
    buf = pos.tobytes() + nrm.tobytes() + idx.tobytes() + b"\0\0"
    prim = {"attributes": {"POSITION": 0, "NORMAL": 1}, "material": 0}
    if indexed:
        prim["indices"] = 2
    gltf = {
        "asset": {"version": "2.0"},
        "scenes": [{"nodes": [0]}], "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": [prim]}],
        "materials": [{"pbrMetallicRoughness": {}}],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 4,
             "type": "VEC3"},
            {"bufferView": 1, "componentType": 5126, "count": 4,
             "type": "VEC3"},
            {"bufferView": 2, "componentType": 5123, "count": 6,
             "type": "SCALAR"}],
        "bufferViews": [
            {"buffer": 0, "byteOffset": 0, "byteLength": 48},
            {"buffer": 0, "byteOffset": 48, "byteLength": 48},
            {"buffer": 0, "byteOffset": 96, "byteLength": 12}],
        "buffers": [{"byteLength": len(buf),
                     "uri": "data:application/octet-stream;base64,"
                            + base64.b64encode(buf).decode()}],
    }
    if image is not None:
        gltf["images"] = [image]
        gltf["textures"] = [{"source": 0}]
        gltf["materials"][0]["pbrMetallicRoughness"]["baseColorTexture"] = {
            "index": 0}
    return _write(tmp_path, "quad.gltf", json.dumps(gltf).encode())


def test_jpeg_texture_raises_naming_the_image(tmp_path, jax_numpy):
    """Baseline, progressive and CMYK JPEG textures, and the last relabelled
    arithmetic-coded progressive (SOF10: its data read as arithmetic-coded,
    which Pillow decodes), load as the JAX loader (Pillow) loads them; a
    hierarchical one, which neither decodes, raises naming the image,
    declared image/jpeg or not (the bytes decide)."""
    green = Image.new("RGB", (8, 8), (10, 200, 10))
    for img, kw in ((green, {}), (green, {"progressive": True}),
                    (green.convert("CMYK"), {"progressive": True})):
        buf = io.BytesIO()
        img.save(buf, "JPEG", **kw)
        uri = ("data:image/jpeg;base64,"
               + base64.b64encode(buf.getvalue()).decode())
        path = _quad_gltf(tmp_path, {"uri": uri, "name": "grass"})
        assert_same_scene(G.load_model(path), JG.load_model(path))
    data = buf.getvalue()
    sof = data.index(b"\xff\xc2")
    for marker in (b"\xca", b"\xc6"):  # SOF10; SOF6, hierarchical
        other = data[:sof + 1] + marker + data[sof + 2:]
        uri = "data:image/jpeg;base64," + base64.b64encode(other).decode()
        if marker == b"\xca":
            path = _quad_gltf(tmp_path, {"uri": uri, "name": "grass"})
            assert_same_scene(G.load_model(path), JG.load_model(path))
            continue
        for image in ({"uri": uri, "mimeType": "image/jpeg", "name": "grass"},
                      {"uri": uri, "name": "grass"}):  # by MIME type, bytes
            path = _quad_gltf(tmp_path, image)
            with pytest.raises(NotImplementedError,
                               match="grass.*: hierarchical"):
                G.load_model(path)


def test_png_texture_in_a_gltf_and_no_index(tmp_path, jax_numpy):
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (9, 14, 4), dtype=np.uint8)
    uri = "data:image/png;base64," + base64.b64encode(
        IMAGE.encode_png(img)).decode()
    path = _quad_gltf(tmp_path, {"uri": uri, "mimeType": "image/png"})
    got = G.load_model(path)
    assert got.atlas.shape == (8, 8, 4)  # 7x4.5 packed, rounded up to 2^k
    assert_same_scene(got, JG.load_model(path))
    with pytest.raises(ValueError, match="No index found"):
        G.load_model(_quad_gltf(tmp_path, indexed=False))


# --- the Renderer ------------------------------------------------------------


def test_renderer_load_model_reads_the_config(tmp_path):
    path = _write(tmp_path, "s.glb", scene_to_glb(spot_box()))
    r = Renderer(RenderConfig(width=8, height=8, spot_lights=True,
                              texture_pixel_ratio=1.0), device="cpu")
    r.load_model(path)
    assert (r.scene.light_type == 3).sum() == 1
    assert_same_scene(r.scene, G.load_model(path, enable_spot_lights=True,
                                            texture_pixel_ratio=1.0))


def test_load_model_async_stages_and_installs(tmp_path):
    """The staged scene is installed at the next chunk boundary of a
    render in progress, and the mean restarts there: the two chunks after
    it equal a fresh render of the loaded scene."""
    path = _write(tmp_path, "m.glb", scene_to_glb(material_test_box()))
    cfg = RenderConfig(width=12, height=12, max_bounces=2,
                       frames_per_chunk=2)
    r = Renderer(cfg, device="cpu")
    r.load_scene(single_triangle())
    # The worker reads the file only once the first chunk is done, so the
    # scene is staged between the first and the second chunk on every run.
    first_chunk_done = threading.Event()
    read_model = r._read_model

    def gated_read(p):
        if not first_chunk_done.wait(timeout=120):
            raise TimeoutError("the first chunk never finished")
        return read_model(p)

    r._read_model = gated_read
    future = r.load_model_async(path)
    seen = []

    def on_chunk(frame):
        seen.append((frame, r.scene.num_triangles))
        if len(seen) == 1:
            first_chunk_done.set()
            future.result()  # the worker finishes before the next chunk

    img = r.render(spp=6, on_chunk=on_chunk)
    assert seen == [(2, 1), (2, 36), (4, 36)]
    assert r.frame_index == 4 and future.done()
    assert r.poll_pending_scene() is False  # nothing staged any more
    fresh = Renderer(cfg, device="cpu")
    fresh.load_scene(future.result())
    np.testing.assert_array_equal(img, fresh.render(spp=4))


def test_failed_async_load_raises(tmp_path):
    r = Renderer(RenderConfig(width=8, height=8, max_bounces=1),
                 device="cpu")
    r.load_scene(cornell_box())
    future = r.load_model_async(str(tmp_path / "missing.glb"))
    assert isinstance(future.exception(timeout=60), FileNotFoundError)
    with pytest.raises(RuntimeError, match="load_model_async failed"):
        r.render(spp=1)
    assert r.render(spp=1).shape == (8, 8, 3)  # raised once
    assert r.scene.num_triangles == 36
