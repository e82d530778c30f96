"""The port's GLB exporter (``models/export.py::scene_to_glb``) against the
JAX package's: the same glTF document and the same binary payload, up to
the PNG encoding of the textures (the port writes its own stdlib PNG where
the JAX package uses Pillow: other bytes, the same pixels); and the round
trips of tests/test_export_glb.py through the port's loader. The JAX
scenes are built on the JAX package's NumPy SAH build, the one the port
copies (tests/test_torch_gltf.py says why).
"""

import io
import json
import struct

import numpy as np
import pytest
import torch
from PIL import Image

from wgpu_path_tracing_tpu.accel import native as JNATIVE
from wgpu_path_tracing_tpu.models import export as JEXPORT
from wgpu_path_tracing_tpu.models import gallery as JGALLERY
from wgpu_path_tracing_tpu.models import procedural as JP
from wgpu_path_tracing_tpu_torch import (
    cornell_box,
    gallery_atrium,
    load_model,
    material_test_box,
    scene_to_glb,
    textured_cornell,
)

torch.set_num_threads(1)


def parse_glb(data: bytes):
    """(JSON document, BIN chunk) of GLB bytes."""
    magic, version, length = struct.unpack_from("<III", data, 0)
    assert (magic, version, length) == (0x46546C67, 2, len(data))
    jlen, jtype = struct.unpack_from("<II", data, 12)
    assert jtype == 0x4E4F534A and jlen % 4 == 0
    doc = json.loads(data[20:20 + jlen])
    blen, btype = struct.unpack_from("<II", data, 20 + jlen)
    assert btype == 0x004E4942
    return doc, data[28 + jlen:28 + jlen + blen]


def views(doc, blob):
    return [blob[v["byteOffset"]:v["byteOffset"] + v["byteLength"]]
            for v in doc["bufferViews"]]


def pixels(png: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(png)) as im:
        return np.asarray(im.convert("RGBA"))


SCENES = {
    "cornell_box": (cornell_box, JP.cornell_box),
    "material_test_box": (material_test_box, JP.material_test_box),
    "textured_cornell": (textured_cornell, JP.textured_cornell),
    "gallery_atrium": (lambda: gallery_atrium(detail=1),
                       lambda: JGALLERY.gallery_atrium(detail=1)),
}


@pytest.mark.parametrize("name", list(SCENES))
def test_glb_equals_the_jax_exporters(name, monkeypatch):
    """Both exporters on the same scene (the port's and the JAX package's
    copies, array-equal): the same document but for the image views'
    lengths and what follows them, the same accessor and index payloads,
    and PNG images of the same pixels."""
    monkeypatch.setattr(JNATIVE, "native_available", lambda: False)
    make, jmake = SCENES[name]
    doc, blob = parse_glb(scene_to_glb(make()))
    jdoc, jblob = parse_glb(JEXPORT.scene_to_glb(jmake()))
    for key in set(doc) | set(jdoc):
        if key not in ("asset", "bufferViews", "buffers"):
            assert doc[key] == jdoc[key], key
    image_views = {img["bufferView"] for img in doc.get("images", [])}
    assert len(doc["bufferViews"]) == len(jdoc["bufferViews"])
    for i, (a, b) in enumerate(zip(views(doc, blob), views(jdoc, jblob))):
        if i in image_views:
            np.testing.assert_array_equal(pixels(a), pixels(b))
        else:
            assert a == b, f"bufferView {i}"
    assert bool(image_views) == (name in ("textured_cornell",
                                          "gallery_atrium"))


def _sorted_tris(s):
    tr = np.concatenate([s.tri_v0, s.tri_v1, s.tri_v2], axis=1)
    order = np.lexsort(tr.T[::-1])
    return tr[order], order


def _roundtrip(scene, tmp_path, **kw):
    path = tmp_path / "rt.glb"
    path.write_bytes(scene_to_glb(scene))
    return load_model(str(path), **kw)


@pytest.mark.parametrize("make", [cornell_box, material_test_box])
def test_roundtrip_geometry_and_materials(make, tmp_path):
    """tests/test_export_glb.py's round trip through the port: positions
    and uvs bit for bit, normals up to the loader's renormalization,
    material parameters exact."""
    ref = make()
    got = _roundtrip(ref, tmp_path)
    ka, oa = _sorted_tris(ref)
    kb, ob = _sorted_tris(got)
    np.testing.assert_array_equal(ka, kb)
    for c in ("n", "uv"):
        a = np.concatenate([getattr(ref, f"tri_{c}{k}") for k in range(3)],
                           axis=1)[oa]
        b = np.concatenate([getattr(got, f"tri_{c}{k}") for k in range(3)],
                           axis=1)[ob]
        np.testing.assert_allclose(a, b, atol=1e-6 if c == "n" else 0)
    ma, mb = ref.tri_mat[oa], got.tri_mat[ob]
    for f in ("mat_base_color", "mat_metallic", "mat_roughness", "mat_ior",
              "mat_transmission"):
        np.testing.assert_array_equal(getattr(ref, f)[ma],
                                      getattr(got, f)[mb])
    np.testing.assert_allclose(
        ref.mat_emission[ma] * ref.mat_emissive_strength[ma, None],
        got.mat_emission[mb] * got.mat_emissive_strength[mb, None],
        rtol=1e-6)


def test_roundtrip_lights_and_hdr_emission(tmp_path):
    """Point and directional lights come back (a directional's direction
    normalized, as a glTF rotation makes it); an emission above 1 folds
    into KHR_materials_emissive_strength and keeps its radiance."""
    ref = material_test_box()
    got = _roundtrip(ref, tmp_path)

    def rows(s):
        pos = np.asarray(s.light_position, np.float64).copy()
        types = np.asarray(s.light_type)
        for i in np.nonzero(types == 1)[0]:
            pos[i] /= np.linalg.norm(pos[i])
        r = np.concatenate([types[:, None], pos, s.light_color,
                            s.light_intensity[:, None]], axis=1)
        return r[np.lexsort(r.T[::-1])]

    np.testing.assert_allclose(rows(ref), rows(got), atol=1e-6)
    hdr = cornell_box()
    lit = int(np.nonzero(hdr.mat_emission.max(axis=1) > 0)[0][0])
    hdr.mat_emission[lit] = (5.0, 4.0, 3.0)
    hdr.mat_emissive_strength[lit] = 1.0
    back = _roundtrip(hdr, tmp_path)
    assert (back.mat_emission <= 1.0 + 1e-9).all()
    ma = hdr.tri_mat[_sorted_tris(hdr)[1]]
    mb = back.tri_mat[_sorted_tris(back)[1]]
    np.testing.assert_allclose(
        hdr.mat_emission[ma] * hdr.mat_emissive_strength[ma, None],
        back.mat_emission[mb] * back.mat_emissive_strength[mb, None],
        rtol=1e-6)


def test_roundtrip_textures_keep_every_mapped_slot(tmp_path):
    sc = gallery_atrium(detail=1)
    got = _roundtrip(sc, tmp_path)
    assert got.num_triangles == sc.num_triangles
    for slot in ("albedo", "pbr", "normal"):
        rect = f"mat_{slot}_rect"
        np.testing.assert_array_equal(getattr(got, rect)[:, 2] > 0,
                                      getattr(sc, rect)[:, 2] > 0)
    assert abs(float(got.atlas[..., 3].mean()) - 1.0) < 1e-3  # opaque
