"""Export ``SceneArrays`` to a binary .glb, the inverse of
``models/gltf.py::load_model``.

The counterpart of the JAX package's ``models/export.py`` (the reference
reads .glb scenes, loader.ts:19-46, and has no exporter). Any procedural
scene can be written out and read back through the whole glTF path: the
loader's round-trip tests and the load measurements of ``chip_smoke.py``
use it.

Geometry goes out a material at a time as indexed primitives with
duplicated corner vertices (float32 positions, normals and uvs, uint32
indices) under one identity node, so ``load_model``'s world transform is
exact and positions round-trip bit for bit. Materials carry the PBR factors
and the KHR ior, transmission and emissive-strength extensions that
``load_model`` reads; punctual lights go out as KHR_lights_punctual nodes.
Each material's atlas rects are cut out of ``SceneArrays.atlas`` and
embedded as RGBA PNG images (``utils/image.py::encode_png``, where the JAX
package uses Pillow: the bytes differ, the pixels do not).
"""

from __future__ import annotations

import json
import struct

import numpy as np

from wgpu_path_tracing_tpu_torch.utils.image import encode_png


def _align4(b: bytes, pad: bytes) -> bytes:
    return b + pad * ((-len(b)) % 4)


def scene_to_glb(scene) -> bytes:
    """SceneArrays -> .glb bytes (one buffer, one mesh, one identity node)."""
    tri_mat = np.asarray(scene.tri_mat, np.int32)
    n_mats = int(scene.mat_base_color.shape[0])

    bin_parts: list[bytes] = []
    buffer_views: list[dict] = []
    accessors: list[dict] = []
    offset = 0

    def add_blob(arr: np.ndarray, target: int | None) -> int:
        nonlocal offset
        raw = arr if isinstance(arr, bytes) else np.ascontiguousarray(
            arr).tobytes()
        padded = _align4(raw, b"\x00")
        bin_parts.append(padded)
        # byteLength is the UNPADDED payload (image decoders read exactly
        # this many bytes); the alignment zeros live between views.
        view = {"buffer": 0, "byteOffset": offset, "byteLength": len(raw)}
        if target is not None:
            view["target"] = target
        buffer_views.append(view)
        offset += len(padded)
        return len(buffer_views) - 1

    def add_accessor(arr: np.ndarray, ctype: int, type_: str,
                     target: int) -> int:
        view = add_blob(arr, target)
        acc = {"bufferView": view, "componentType": ctype,
               "count": int(arr.shape[0]), "type": type_}
        if type_ == "VEC3" and ctype == 5126:
            acc["min"] = [float(x) for x in arr.min(axis=0)]
            acc["max"] = [float(x) for x in arr.max(axis=0)]
        accessors.append(acc)
        return len(accessors) - 1

    # Textures: each material's nonzero atlas rects, cropped out of the
    # atlas and embedded as PNG images, which the loader's build_atlas
    # reads back through its per-material image path. Albedo crops are
    # sRGB-encoded (the loader applies the reference's 8-bit gamma-2.2
    # decode, atlas.ts:143-149); other slots go out as 8-bit values. The
    # texels re-quantize through two 8-bit steps and the loader's resize
    # by texture_pixel_ratio: a normal asset's round trip, not the exact
    # geometry one.
    atlas = getattr(scene, "atlas", None)
    textured = atlas is not None and (atlas.shape[0] > 1
                                      or atlas.shape[1] > 1)
    images_json: list[dict] = []
    textures_json: list[dict] = []
    tex_cache: dict = {}

    def add_texture(rect, srgb: bool) -> int | None:
        rx, ry, rw, rh = (int(v) for v in rect)
        if rw <= 0 or rh <= 0 or not textured:
            return None
        key = (rx, ry, rw, rh, srgb)
        if key in tex_cache:
            return tex_cache[key]
        crop = np.clip(np.asarray(atlas, np.float32)[ry:ry + rh,
                                                     rx:rx + rw], 0.0, 1.0)
        if srgb:
            crop = crop.copy()
            crop[..., 0:3] = np.power(crop[..., 0:3], 1.0 / 2.2)
        u8 = np.clip(np.rint(crop * 255.0), 0, 255).astype(np.uint8)
        view = add_blob(encode_png(u8), None)
        images_json.append({"bufferView": view, "mimeType": "image/png",
                            "name": f"tex_{rx}_{ry}"})
        textures_json.append({"source": len(images_json) - 1})
        tex_cache[key] = len(textures_json) - 1
        return tex_cache[key]

    primitives = []
    materials_json = []
    for m in range(n_mats):
        sel = np.nonzero(tri_mat == m)[0]
        base = np.asarray(scene.mat_base_color[m], np.float64)
        rough = float(scene.mat_roughness[m])
        metal = float(scene.mat_metallic[m])
        emis = np.asarray(scene.mat_emission[m], np.float64)
        es = float(scene.mat_emissive_strength[m])
        peak = float(emis.max()) if emis.size else 0.0
        if peak > 1.0:
            # emissiveFactor is clamped to [0, 1] by the spec; fold the
            # overflow into KHR_materials_emissive_strength, so that the
            # round trip keeps the radiance (the loader reads emission x
            # strength, models/gltf.py::_build_material).
            emis = emis / peak
            es = es * peak
        mat_json = {
            "name": f"mat{m}",
            "pbrMetallicRoughness": {
                "baseColorFactor": [*map(float, base), 1.0],
                "metallicFactor": metal,
                "roughnessFactor": rough,
            },
            "emissiveFactor": [*map(float, np.clip(emis, 0.0, 1.0))],
        }
        if textured:
            ti = add_texture(scene.mat_albedo_rect[m], srgb=True)
            if ti is not None:
                mat_json["pbrMetallicRoughness"]["baseColorTexture"] = {
                    "index": ti}
            ti = add_texture(scene.mat_pbr_rect[m], srgb=False)
            if ti is not None:
                mat_json["pbrMetallicRoughness"][
                    "metallicRoughnessTexture"] = {"index": ti}
            ti = add_texture(scene.mat_normal_rect[m], srgb=False)
            if ti is not None:
                mat_json["normalTexture"] = {"index": ti}
            ti = add_texture(scene.mat_emissive_rect[m], srgb=False)
            if ti is not None:
                mat_json["emissiveTexture"] = {"index": ti}
        ext = {}
        if es != 1.0:
            ext["KHR_materials_emissive_strength"] = {"emissiveStrength": es}
        ior = float(scene.mat_ior[m])
        if ior != 1.5:
            ext["KHR_materials_ior"] = {"ior": ior}
        tr = float(scene.mat_transmission[m])
        if tr != 0.0:
            ext["KHR_materials_transmission"] = {"transmissionFactor": tr}
        if ext:
            mat_json["extensions"] = ext
        materials_json.append(mat_json)
        if sel.size == 0:
            continue
        # Duplicated corner vertices: (3k,) layout [v0 x k, v1 x k, v2 x k]
        # concatenated per corner keeps the slicing vectorized.
        pos = np.concatenate(
            [scene.tri_v0[sel], scene.tri_v1[sel], scene.tri_v2[sel]],
        ).astype(np.float32)
        nrm = np.concatenate(
            [scene.tri_n0[sel], scene.tri_n1[sel], scene.tri_n2[sel]],
        ).astype(np.float32)
        uv = np.concatenate(
            [scene.tri_uv0[sel], scene.tri_uv1[sel], scene.tri_uv2[sel]],
        ).astype(np.float32)
        k = sel.size
        idx = (np.arange(3 * k, dtype=np.uint32)
               .reshape(3, k).T.reshape(-1))  # (v0_i, v1_i, v2_i) triples
        prim = {
            "attributes": {
                "POSITION": add_accessor(pos, 5126, "VEC3", 34962),
                "NORMAL": add_accessor(nrm, 5126, "VEC3", 34962),
                "TEXCOORD_0": add_accessor(uv, 5126, "VEC2", 34962),
            },
            "indices": add_accessor(idx, 5125, "SCALAR", 34963),
            "material": m,
        }
        primitives.append(prim)

    nodes = [{"mesh": 0, "name": "scene"}]
    scene_nodes = [0]
    lights_json = []
    lt = np.asarray(getattr(scene, "light_type", np.zeros(0, np.int32)))
    # Emissive area lights re-derive from materials on load; only punctual
    # lights (type 1 directional / 2 point / 3 spot) need explicit nodes.
    for li in range(lt.shape[0]):
        t = int(lt[li])
        if t not in (1, 2, 3):
            continue
        color = [float(c) for c in scene.light_color[li]]
        inten = float(scene.light_intensity[li])
        pos = [float(c) for c in scene.light_position[li]]
        node: dict = {"name": f"light{li}",
                      "extensions": {"KHR_lights_punctual":
                                     {"light": len(lights_json)}}}
        if t == 1:
            # light_position holds a directional light's direction (the
            # world-rotated (0, 0, -1), models/gltf.py); build a rotation
            # that sends (0, 0, -1) onto it.
            d = np.asarray(pos, np.float64)
            d /= max(np.linalg.norm(d), 1e-12)
            z = np.array([0.0, 0.0, -1.0])
            v = np.cross(z, d)
            c = float(z @ d)
            if np.linalg.norm(v) < 1e-12:
                mat = np.diag([1.0, 1.0, 1.0] if c > 0 else [1.0, -1.0, -1.0])
            else:
                vx = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]],
                               [-v[1], v[0], 0]])
                mat = np.eye(3) + vx + vx @ vx / (1.0 + c)
            m4 = np.eye(4)
            m4[0:3, 0:3] = mat
            node["matrix"] = [float(x) for x in m4.T.reshape(-1)]
            lights_json.append({"type": "directional", "color": color,
                                "intensity": inten})
        elif t == 2:
            node["translation"] = pos
            lights_json.append({"type": "point", "color": color,
                                "intensity": inten})
        else:
            aux = np.asarray(scene.light_aux[li], np.float64)
            d = aux[0:3] / max(np.linalg.norm(aux[0:3]), 1e-12)
            scale, noff = float(aux[3]), float(aux[4])
            cos_o = -noff / scale
            cos_i = min(1.0, cos_o + 1.0 / scale)
            z = np.array([0.0, 0.0, -1.0])
            v = np.cross(z, d)
            c = float(z @ d)
            if np.linalg.norm(v) < 1e-12:
                mat = np.diag([1.0, 1.0, 1.0] if c > 0 else [1.0, -1.0, -1.0])
            else:
                vx = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]],
                               [-v[1], v[0], 0]])
                mat = np.eye(3) + vx + vx @ vx / (1.0 + c)
            m4 = np.eye(4)
            m4[0:3, 0:3] = mat
            m4[0:3, 3] = pos
            node["matrix"] = [float(x) for x in m4.T.reshape(-1)]
            lights_json.append({
                "type": "spot", "color": color, "intensity": inten,
                "spot": {"innerConeAngle": float(np.arccos(cos_i)),
                         "outerConeAngle": float(np.arccos(cos_o))}})
        nodes.append(node)
        scene_nodes.append(len(nodes) - 1)

    bin_chunk = b"".join(bin_parts)
    gltf = {
        "asset": {"version": "2.0", "generator": "wgpu_path_tracing_tpu_torch"},
        "scene": 0,
        "scenes": [{"nodes": scene_nodes}],
        "nodes": nodes,
        "meshes": [{"primitives": primitives}],
        "materials": materials_json,
        "accessors": accessors,
        "bufferViews": buffer_views,
        "buffers": [{"byteLength": len(bin_chunk)}],
    }
    if images_json:
        gltf["images"] = images_json
        gltf["textures"] = textures_json
    if lights_json:
        gltf["extensions"] = {"KHR_lights_punctual": {"lights": lights_json}}
        gltf["extensionsUsed"] = ["KHR_lights_punctual"]

    json_chunk = _align4(json.dumps(gltf, separators=(",", ":")).encode(),
                         b" ")
    total = 12 + 8 + len(json_chunk) + 8 + len(bin_chunk)
    out = [struct.pack("<III", 0x46546C67, 2, total),
           struct.pack("<II", len(json_chunk), 0x4E4F534A), json_chunk,
           struct.pack("<II", len(bin_chunk), 0x004E4942), bin_chunk]
    return b"".join(out)


