"""glTF 2.0 scene loading (.glb and .gltf), host side, NumPy.

The counterpart of the JAX package's ``models/gltf.py``, which replaces the
reference's loaders.gl parse, scene flatten and texture atlas
(loader.ts:13-46, gpu.ts:67-150, atlas.ts:32-184). The semantics are the
reference's, as the JAX package keeps them:

* world matrices by a parent-chain walk over all nodes of the file, not
  only the scene's roots (gpu.ts:77-103); a node's local matrix is its
  ``matrix`` if present, else T * R * S (gpu.ts:152-192);
* KHR_lights_punctual: a directional light stores the world-rotated
  (0, 0, -1) in ``position`` (gpu.ts:209-221), a point light its world
  origin (gpu.ts:222-233); a spot light, past the reference, only with
  ``enable_spot_lights``; other types warn and are skipped (gpu.ts:234-236);
* mesh primitives: positions by the world matrix, normals by the
  transposed inverse, normalized (gpu.ts:247-274), in float64 and cast
  back before the corner gathers; a primitive without indices raises "No
  index found" (gpu.ts:307-309); missing TEXCOORD_0 gives zero uvs
  (gpu.ts:310);
* one material a primitive, duplicates included (gpu.ts:285-291), with
  buildMaterial's defaults (gpu.ts:358-421);
* the texture atlas (atlas.ts): four slots a material, each image scaled
  by ``texture_pixel_ratio`` (0.5, atlas.ts:10) with a bilinear filter,
  packed by potpack into a power-of-two square (atlas.ts:64-67) on a black
  opaque background; albedo decoded from sRGB with gamma 2.2 on the 8-bit
  values (atlas.ts:143-149), the other slots copied; texels are byte / 255;
* the BVH build, triangle reorder and emissive-light extraction of
  ``models/assemble.py::finalize_scene`` (gpu.ts:119-138).

The JAX package decodes and scales images with Pillow, a sidecar file by
its ``uri`` whatever its ``mimeType``; here ``utils/image.py::
decode_image_rgba`` (PNG; sequential, progressive and lossless JPEG,
Huffman- or arithmetic-coded, in gray, YCbCr, RGB, CMYK and YCCK through
``utils/jpeg.py``; TGA, BMP with DIB, ICO and CUR, netpbm, baseline
TIFF, WebP and GIF through ``utils/tga.py``, ``bmp.py``, ``netpbm.py``,
``tiff.py``, ``webp.py`` and ``gif.py``; the format found by the bytes in
Pillow's order) and ``resize_bilinear_u8`` compute what Pillow computes,
so the atlas is array-equal. A variant Pillow opens that this package
does not read (a 12-bit or hierarchical JPEG, JPEG-in-TIFF, ...) raises
``NotImplementedError``, and a format it does not read (AVIF, QOI, ...)
``ValueError``, naming the image. With a compiler,
``accel/native.py``'s library transforms and gathers each primitive's
corners in one pass (``flatten_native``) and packs the atlas
(``potpack_native``); the NumPy code here is their plain version, the same
arrays bit for bit.
"""

from __future__ import annotations

import base64
import json
import math
import os
import struct
import warnings
from urllib.parse import unquote

import numpy as np

from wgpu_path_tracing_tpu_torch.accel import native
from wgpu_path_tracing_tpu_torch.models.assemble import finalize_scene
from wgpu_path_tracing_tpu_torch.models.potpack import potpack
from wgpu_path_tracing_tpu_torch.models.types import SceneArrays
from wgpu_path_tracing_tpu_torch.utils.image import (
    decode_image_rgba,
    resize_bilinear_u8,
)

GLB_MAGIC = 0x46546C67
CHUNK_JSON = 0x4E4F534A
CHUNK_BIN = 0x004E4942

_COMPONENT_DTYPES = {
    5120: np.int8,
    5121: np.uint8,
    5122: np.int16,
    5123: np.uint16,
    5125: np.uint32,
    5126: np.float32,
}
_NUM_COMPONENTS = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT2": 4,
                   "MAT3": 9, "MAT4": 16}


class GLTFFile:
    """A parsed glTF document with its binary buffers resolved."""

    def __init__(self, gltf: dict, buffers: list[bytes], base_dir: str = ""):
        self.gltf = gltf
        self.buffers = buffers
        # External uris (.gltf sidecar buffers and images) resolve against
        # the file's directory, as loaders.gl's baseUri does.
        self.base_dir = base_dir

    @classmethod
    def load(cls, path: str) -> "GLTFFile":
        with open(path, "rb") as f:
            data = f.read()
        base_dir = os.path.dirname(path)
        if len(data) >= 12 and struct.unpack_from("<I", data, 0)[0] == GLB_MAGIC:
            return cls._parse_glb(data, base_dir)
        gltf = json.loads(data)
        return cls(gltf, cls._load_buffers(gltf, None, base_dir), base_dir)

    @classmethod
    def _parse_glb(cls, data: bytes, base_dir: str) -> "GLTFFile":
        magic, version, _length = struct.unpack_from("<III", data, 0)
        if magic != GLB_MAGIC:
            raise ValueError("not a GLB file (bad magic)")
        if version != 2:
            raise ValueError(f"Unsupported GLB version {version}")
        offset, gltf, bin_chunk = 12, None, b""
        while offset + 8 <= len(data):
            chunk_len, chunk_type = struct.unpack_from("<II", data, offset)
            offset += 8
            chunk = data[offset:offset + chunk_len]
            offset += chunk_len
            if chunk_type == CHUNK_JSON:
                gltf = json.loads(chunk)
            elif chunk_type == CHUNK_BIN:
                bin_chunk = chunk
        if gltf is None:
            raise ValueError("GLB has no JSON chunk")
        return cls(gltf, cls._load_buffers(gltf, bin_chunk, base_dir),
                   base_dir)

    @staticmethod
    def _load_buffers(gltf: dict, glb_bin: bytes | None, base_dir: str):
        """Each buffer's bytes: the GLB's BIN chunk for a buffer without a
        uri, a ``data:`` uri decoded, or a sidecar file (percent-decoded
        name, relative to the document)."""
        buffers = []
        for buf in gltf.get("buffers", []):
            uri = buf.get("uri")
            if uri is None:
                buffers.append(glb_bin or b"")
            elif uri.startswith("data:"):
                buffers.append(base64.b64decode(uri.split(",", 1)[1]))
            else:
                with open(os.path.join(base_dir, unquote(uri)), "rb") as f:
                    buffers.append(f.read())
        return buffers

    def _read_view(self, view_idx: int, extra_offset: int, count: int,
                   n: int, dtype: np.dtype) -> np.ndarray:
        """(count, n) elements of ``dtype`` from a bufferView, honouring its
        byteStride (interleaved views)."""
        bv = self.gltf["bufferViews"][view_idx]
        buf = self.buffers[bv.get("buffer", 0)]
        offset = bv.get("byteOffset", 0) + extra_offset
        stride = bv.get("byteStride") or dtype.itemsize * n
        return np.ndarray(shape=(count, n), dtype=dtype, buffer=buf,
                          offset=offset,
                          strides=(stride, dtype.itemsize)).copy()

    def accessor(self, idx: int) -> np.ndarray:
        """Accessor ``idx`` as a (count, n) array: interleaved, normalized
        and sparse accessors decoded. Sparse substitution (glTF 2.0
        §3.6.2.3: ``indices`` pick rows of the base view, zeros without
        one, that ``values`` overwrite) comes before normalization."""
        acc = self.gltf["accessors"][idx]
        n = _NUM_COMPONENTS[acc["type"]]
        dtype = np.dtype(_COMPONENT_DTYPES[acc["componentType"]])
        count = acc["count"]
        if "bufferView" in acc:
            arr = self._read_view(acc["bufferView"], acc.get("byteOffset", 0),
                                  count, n, dtype)
        else:
            arr = np.zeros((count, n), dtype)
        if "sparse" in acc:
            sp = acc["sparse"]
            sidx = sp["indices"]
            idx_dtype = np.dtype(_COMPONENT_DTYPES[sidx["componentType"]])
            rows = self._read_view(sidx["bufferView"],
                                   sidx.get("byteOffset", 0), sp["count"], 1,
                                   idx_dtype).reshape(-1).astype(np.int64)
            arr[rows] = self._read_view(sp["values"]["bufferView"],
                                        sp["values"].get("byteOffset", 0),
                                        sp["count"], n, dtype)
        if acc.get("normalized"):
            if dtype == np.uint8:
                arr = arr.astype(np.float32) / 255.0
            elif dtype == np.uint16:
                arr = arr.astype(np.float32) / 65535.0
            elif dtype == np.int8:
                arr = np.maximum(arr.astype(np.float32) / 127.0, -1.0)
            elif dtype == np.int16:
                arr = np.maximum(arr.astype(np.float32) / 32767.0, -1.0)
        return arr

    def image_bytes(self, image_idx: int) -> bytes | None:
        """Image ``image_idx``'s encoded bytes (from a bufferView, a
        ``data:`` uri or a sidecar file); None when its file is missing."""
        img = self.gltf["images"][image_idx]
        if "bufferView" in img:
            bv = self.gltf["bufferViews"][img["bufferView"]]
            buf = self.buffers[bv.get("buffer", 0)]
            off = bv.get("byteOffset", 0)
            return buf[off:off + bv["byteLength"]]
        uri = img.get("uri")
        if uri and uri.startswith("data:"):
            return base64.b64decode(uri.split(",", 1)[1])
        if uri:
            path = os.path.join(self.base_dir, unquote(uri))
            if os.path.exists(path):
                with open(path, "rb") as f:
                    return f.read()
        return None

    def image_name(self, image_idx: int) -> str:
        """How an error names image ``image_idx``: its name, uri or index,
        and its MIME type where given."""
        img = self.gltf["images"][image_idx]
        label = img.get("name") or img.get("uri", "")[:64] or "unnamed"
        mime = img.get("mimeType")
        return (f"image {image_idx} ({label}"
                + (f", {mime})" if mime else ")"))


# --- transforms (gpu.ts:152-192, column vectors) ------------------------------


def _quat_to_mat3(q) -> np.ndarray:
    x, y, z, w = (float(v) for v in q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ], np.float64)


def _mat3_to_quat(m: np.ndarray):
    """The rotation quaternion of a matrix by the trace method (as
    wgpu-matrix's quat.fromMat: the upper 3x3 is taken for a rotation, and
    a scaled one goes as wrong as in the reference)."""
    trace = m[0, 0] + m[1, 1] + m[2, 2]
    if trace > 0.0:
        root = math.sqrt(trace + 1.0)
        w = 0.5 * root
        root = 0.5 / root
        return np.array([(m[2, 1] - m[1, 2]) * root,
                         (m[0, 2] - m[2, 0]) * root,
                         (m[1, 0] - m[0, 1]) * root, w])
    i = 0
    if m[1, 1] > m[0, 0]:
        i = 1
    if m[2, 2] > m[i, i]:
        i = 2
    j = (i + 1) % 3
    k = (i + 2) % 3
    root = math.sqrt(m[i, i] - m[j, j] - m[k, k] + 1.0)
    q = np.zeros(4)
    q[i] = 0.5 * root
    root = 0.5 / root
    q[3] = (m[k, j] - m[j, k]) * root
    q[j] = (m[j, i] + m[i, j]) * root
    q[k] = (m[k, i] + m[i, k]) * root
    return q


def _node_local_matrix(node: dict) -> np.ndarray:
    if "matrix" in node:  # glTF matrices are column-major
        return np.asarray(node["matrix"], np.float64).reshape(4, 4, order="F")
    m = np.eye(4)
    if "translation" in node:
        t = np.eye(4)
        t[0:3, 3] = node["translation"]
        m = m @ t
    if "rotation" in node:
        r = np.eye(4)
        r[0:3, 0:3] = _quat_to_mat3(node["rotation"])
        m = m @ r
    if "scale" in node:
        m = m @ np.diag(list(node["scale"]) + [1.0])
    return m


def _world_matrices(gltf: dict) -> list[np.ndarray]:
    """Each node's world matrix by its parent chain (gpu.ts:77-103)."""
    nodes = gltf.get("nodes", [])
    parent = {}
    for i, node in enumerate(nodes):
        for child in node.get("children", []):
            parent[child] = i
    out = []
    for i, node in enumerate(nodes):
        world = _node_local_matrix(node)
        cur = i
        while cur in parent:
            cur = parent[cur]
            world = _node_local_matrix(nodes[cur]) @ world
        out.append(world)
    return out


# --- the texture atlas (atlas.ts) ---------------------------------------------

SLOTS = ("albedo", "normal", "pbr", "emissive")


def _decode_image(gf: GLTFFile, src: int, data: bytes) -> np.ndarray:
    """(H, W, 4) uint8 RGBA of an image's bytes, the format found by the
    bytes as Pillow finds it (the ``mimeType`` is not read, as Pillow does
    not read it); errors name the image."""
    return decode_image_rgba(data, gf.image_name(src))


def build_atlas(gf: GLTFFile, texture_pixel_ratio: float = 0.5):
    """Pack the four texture slots of every material (atlas.ts:32-94).

    Returns (atlas float32 (S, S, 4) or None, rects) where ``rects[m]``
    maps each slot to [x, y, w, h] in pixels (zeros when the slot has no
    texture)."""
    gltf = gf.gltf
    materials = gltf.get("materials", [])
    textures = gltf.get("textures", [])

    def tex_image_index(tex_info):
        if not tex_info:
            return None
        return textures[tex_info["index"]].get("source")

    boxes, rects = [], []
    decoded: dict[int, np.ndarray | None] = {}
    for mat in materials:
        pbr = mat.get("pbrMetallicRoughness", {})
        slot_sources = {
            "albedo": tex_image_index(pbr.get("baseColorTexture")),
            "normal": tex_image_index(mat.get("normalTexture")),
            "pbr": tex_image_index(pbr.get("metallicRoughnessTexture")),
            "emissive": tex_image_index(mat.get("emissiveTexture")),
        }
        mat_rects = {}
        for slot in SLOTS:
            src = slot_sources[slot]
            if src is not None and src not in decoded:
                data = gf.image_bytes(src)
                decoded[src] = (None if data is None
                                else _decode_image(gf, src, data))
            img = None if src is None else decoded[src]
            if img is None:
                mat_rects[slot] = None
                continue
            box = {"w": img.shape[1] * texture_pixel_ratio,
                   "h": img.shape[0] * texture_pixel_ratio, "x": 0, "y": 0,
                   "src": src, "albedo": slot == "albedo"}
            boxes.append(box)
            mat_rects[slot] = box
        rects.append(mat_rects)

    if not boxes:
        return None, [{s: [0, 0, 0, 0] for s in SLOTS} for _ in materials]

    w, h = potpack(boxes)
    size = max(1, 2 ** math.ceil(math.log2(max(w, h))))  # atlas.ts:64-67
    atlas = np.zeros((size, size, 4), np.float32)
    atlas[..., 3] = 1.0  # black opaque background (atlas.ts:106-107)
    for box in boxes:
        bw, bh = int(box["w"]), int(box["h"])
        if bw == 0 or bh == 0:
            continue
        resized = resize_bilinear_u8(decoded[box["src"]], (bw, bh))
        if box["albedo"]:
            # sRGB -> linear, gamma 2.2, on the 8-bit values (the canvas
            # round trip of atlas.ts:143-149).
            rgb = resized[..., 0:3].astype(np.float64) / 255.0
            rgb = np.clip(np.rint(np.power(rgb, 2.2) * 255.0), 0, 255)
            resized = resized.copy()
            resized[..., 0:3] = rgb.astype(np.uint8)
        x, y = int(box["x"]), int(box["y"])
        atlas[y:y + bh, x:x + bw] = resized.astype(np.float32) / 255.0

    out_rects = []
    for mat_rects in rects:
        out_rects.append({
            slot: ([0, 0, 0, 0] if mat_rects[slot] is None else
                   [int(mat_rects[slot][k]) for k in ("x", "y", "w", "h")])
            for slot in SLOTS})
    return atlas, out_rects


# --- materials (gpu.ts:358-421) -----------------------------------------------


def _build_material(mat: dict | None, mat_rects: dict | None):
    zero_rect = [0, 0, 0, 0]
    if mat is None:
        return dict(base_color=[1.0, 1.0, 1.0], metallic=0.0, roughness=0.1,
                    emission=[0.0, 0.0, 0.0], emissive_strength=0.0, ior=1.5,
                    transmission=0.0, albedo_rect=zero_rect,
                    normal_rect=zero_rect, pbr_rect=zero_rect,
                    emissive_rect=zero_rect)
    pbr = mat.get("pbrMetallicRoughness", {})
    base = pbr.get("baseColorFactor", [1.0, 1.0, 1.0, 1.0])
    ext = mat.get("extensions", {})
    rects = mat_rects or {}
    return dict(
        base_color=list(base[0:3]),
        metallic=pbr.get("metallicFactor", 1.0),
        roughness=pbr.get("roughnessFactor", 1.0),
        emission=list(mat.get("emissiveFactor", [0.0, 0.0, 0.0])),
        emissive_strength=ext.get("KHR_materials_emissive_strength", {}).get(
            "emissiveStrength", 1.0),
        ior=ext.get("KHR_materials_ior", {}).get("ior", 1.5),
        transmission=ext.get("KHR_materials_transmission", {}).get(
            "transmissionFactor", 0.0),
        albedo_rect=rects.get("albedo", zero_rect),
        normal_rect=rects.get("normal", zero_rect),
        pbr_rect=rects.get("pbr", zero_rect),
        emissive_rect=rects.get("emissive", zero_rect),
    )


# --- the entry point (loader.ts:19-46, gpu.ts:67-150) -----------------------


def _light_rotation(world: np.ndarray) -> np.ndarray:
    """The world-rotated (0, 0, -1) of a light node."""
    rot = _quat_to_mat3(_mat3_to_quat(world[0:3, 0:3]))
    return rot @ np.array([0.0, 0.0, -1.0])


def _add_light(lights: dict, light: dict, world: np.ndarray,
               enable_spot_lights: bool) -> None:
    """Append a KHR_lights_punctual light (gpu.ts:205-237) to ``lights``."""
    color = light.get("color", [1.0, 1.0, 1.0])
    intensity = light.get("intensity", 1.0)
    origin = (world @ np.array([0.0, 0.0, 0.0, 1.0]))[0:3]
    if light["type"] == "directional":
        entry = (_light_rotation(world), 1, np.zeros(5))
    elif light["type"] == "point":
        entry = (origin, 2, np.zeros(5))
    elif light["type"] == "spot" and enable_spot_lights:
        # Past the reference, which warns and skips: the direction is the
        # world-rotated (0, 0, -1), the squared angular falloff a scale
        # and an offset.
        spot = light.get("spot", {})
        inner = float(spot.get("innerConeAngle", 0.0))
        outer = float(spot.get("outerConeAngle", np.pi / 4.0))
        cos_i, cos_o = np.cos(inner), np.cos(outer)
        scale = 1.0 / max(1e-3, cos_i - cos_o)
        entry = (origin, 3, np.concatenate([_light_rotation(world),
                                            [scale, -cos_o * scale]]))
    else:
        warnings.warn(f"Unsupported light type: {light['type']}")
        return
    position, kind, aux = entry
    lights["position"].append(position)
    lights["type"].append(kind)
    lights["color"].append(color)
    lights["intensity"].append(intensity)
    lights["aux"].append(aux)


def flatten_corners(pos32: np.ndarray, nrm32: np.ndarray, world: np.ndarray,
                    normal_mat: np.ndarray, idx: np.ndarray):
    """The corners of triangles ``idx`` (3k corner indices) in world space:
    (v0, v1, v2, n0, n1, n2), each (k, 3) float32 (gpu.ts:247-274).
    Transforms in float64, cast to float32 before the gathers (the cast
    commutes with the gather); an identity node skips the float64 round
    trip of the positions. This is the plain version of
    ``native.flatten_native``."""
    if np.array_equal(world, np.eye(4)):
        wpos = np.ascontiguousarray(pos32, np.float32)
        nrm64 = nrm32.astype(np.float64)
    else:
        pos = pos32.astype(np.float64)
        wpos = (pos @ world[0:3, 0:3].T + world[0:3, 3]).astype(np.float32)
        nrm64 = nrm32.astype(np.float64) @ normal_mat[0:3, 0:3].T
    ln = np.linalg.norm(nrm64, axis=1, keepdims=True)
    ln[ln == 0] = 1.0
    wnrm = (nrm64 / ln).astype(np.float32)
    i0, i1, i2 = idx[0::3], idx[1::3], idx[2::3]
    return wpos[i0], wpos[i1], wpos[i2], wnrm[i0], wnrm[i1], wnrm[i2]


def _primitive_corners(gf: GLTFFile, prim: dict, world: np.ndarray,
                       normal_mat: np.ndarray):
    """A primitive's triangle corners in world space: (v0, v1, v2, n0, n1,
    n2, uv0, uv1, uv2); the positions and normals by the native library
    when it has a compiler, else by ``flatten_corners`` (the same
    arrays)."""
    attrs = prim["attributes"]
    if "indices" not in prim:
        raise ValueError("No index found")  # gpu.ts:307-309
    pos32 = gf.accessor(attrs["POSITION"])
    nrm32 = gf.accessor(attrs["NORMAL"])
    idx = gf.accessor(prim["indices"]).reshape(-1).astype(np.int64)
    if "TEXCOORD_0" in attrs:
        uv = gf.accessor(attrs["TEXCOORD_0"]).astype(np.float32)
    else:
        uv = np.zeros((pos32.shape[0], 2), np.float32)  # gpu.ts:310
    flatten = (native.flatten_native if idx.size and native.native_available()
               else flatten_corners)
    return (*flatten(pos32, nrm32, world, normal_mat, idx),
            uv[idx[0::3]], uv[idx[1::3]], uv[idx[2::3]])


def load_model(path: str, texture_pixel_ratio: float = 0.5,
               max_leaf_size: int = 4, num_bins: int = 12,
               enable_spot_lights: bool = False) -> SceneArrays:
    """Read a .glb or .gltf file into ``SceneArrays`` (the reference's
    loader.ts:19-46 and gpu.ts:67-150)."""
    gf = GLTFFile.load(path)
    gltf = gf.gltf
    atlas, rects = build_atlas(gf, texture_pixel_ratio)
    khr_lights = gltf.get("extensions", {}).get(
        "KHR_lights_punctual", {}).get("lights", [])
    worlds = _world_matrices(gltf)

    corners = [[] for _ in range(9)]  # v0 v1 v2 n0 n1 n2 uv0 uv1 uv2
    tri_mat, materials = [], []
    lights = {k: [] for k in ("position", "type", "color", "intensity",
                              "aux")}
    for node_idx, node in enumerate(gltf.get("nodes", [])):
        world = worlds[node_idx]
        light_idx = node.get("extensions", {}).get(
            "KHR_lights_punctual", {}).get("light")
        if light_idx is not None:
            _add_light(lights, khr_lights[light_idx], world,
                       enable_spot_lights)
        if "mesh" not in node:  # gpu.ts:239-298
            continue
        normal_mat = np.linalg.inv(world).T
        for prim in gltf["meshes"][node["mesh"]].get("primitives", []):
            parts = _primitive_corners(gf, prim, world, normal_mat)
            for acc, part in zip(corners, parts):
                acc.append(part)
            mat_idx = prim.get("material")
            gmat = None if mat_idx is None else gltf["materials"][mat_idx]
            grects = None if mat_idx is None else rects[mat_idx]
            materials.append(_build_material(gmat, grects))
            tri_mat.append(np.full(len(parts[0]), len(materials) - 1,
                                   np.int32))

    f32 = np.float32
    if tri_mat:
        cols = [np.concatenate(c, axis=0).astype(f32) for c in corners]
        tmat = np.concatenate(tri_mat, axis=0)
    else:
        cols = [np.zeros((0, 3 if k < 6 else 2), f32) for k in range(9)]
        tmat = np.zeros((0,), np.int32)
    if not materials:
        materials.append(_build_material(None, None))

    def mats(key, dtype=f32):
        return np.array([m[key] for m in materials], dtype)

    return finalize_scene(
        *cols, tmat,
        mats("base_color"), mats("metallic"), mats("roughness"),
        mats("emission"), mats("emissive_strength"), mats("ior"),
        mats("transmission"),
        mat_albedo_rect=mats("albedo_rect", np.int32),
        mat_normal_rect=mats("normal_rect", np.int32),
        mat_pbr_rect=mats("pbr_rect", np.int32),
        mat_emissive_rect=mats("emissive_rect", np.int32),
        light_position=np.array(lights["position"], f32).reshape(-1, 3),
        light_type=np.array(lights["type"], np.int32),
        light_color=np.array(lights["color"], f32).reshape(-1, 3),
        light_intensity=np.array(lights["intensity"], f32),
        light_aux=np.array(lights["aux"], f32).reshape(-1, 5),
        atlas=atlas, max_leaf_size=max_leaf_size, num_bins=num_bins,
    )
