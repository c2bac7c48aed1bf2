"""Binary glTF 2.0 (.glb) scene export/import.

The reference exported scenes through trimesh (hive/pipeline.py:921-936); this
is a self-contained writer producing the same renderer-facing contract: one
node per frame mesh (named ``000000``, ``000001``, ...), textured primitives
with a baseColorTexture, or vertex-coloured primitives for TSDF meshes. A
reader is included for round-trip tests and for re-ingesting exported scenes.
Textures are PNG or JPEG, written and read with the port's own codecs
(:mod:`hive_tpu_torch.image_codecs`, ``hive_tpu_torch.io.decode_png``): the
JAX package's counterpart, ``hive_tpu/meshing/gltf.py``, uses Pillow.
"""

from __future__ import annotations

import json
import shutil
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from hive_tpu_torch.image_codecs import decode_jpeg, encode_jpeg, encode_png
from hive_tpu_torch.io import decode_png
from hive_tpu_torch.meshing.mesh import Scene, TriangleMesh

_GLB_MAGIC = 0x46546C67  # 'glTF'
_CHUNK_JSON = 0x4E4F534A
_CHUNK_BIN = 0x004E4942

_BYTE = 5120
_UBYTE = 5121
_SHORT = 5122
_USHORT = 5123
_UINT = 5125
_FLOAT = 5126

_ARRAY_BUFFER = 34962
_ELEMENT_ARRAY_BUFFER = 34963


class _BufferBuilder:
    def __init__(self):
        self.chunks: List[bytes] = []
        self.offset = 0
        self.views: List[dict] = []

    def add_view(self, data: bytes, target: Optional[int] = None,
                 byte_stride: Optional[int] = None) -> int:
        # glTF requires 4-byte alignment for bufferView offsets.
        padding = (-self.offset) % 4
        if padding:
            self.chunks.append(b"\x00" * padding)
            self.offset += padding

        view = {"buffer": 0, "byteOffset": self.offset, "byteLength": len(data)}
        if target is not None:
            view["target"] = target
        if byte_stride is not None:
            view["byteStride"] = byte_stride

        self.views.append(view)
        self.chunks.append(data)
        self.offset += len(data)

        return len(self.views) - 1

    def tobytes(self) -> bytes:
        blob = b"".join(self.chunks)
        padding = (-len(blob)) % 4
        return blob + b"\x00" * padding


def _split_faces_for_uint16(faces: np.ndarray,
                            window: int = 60000) -> Optional[List[Tuple]]:
    """Partition faces into groups whose vertex sets fit uint16 indices.

    Faces are grouped by ``min_vertex_id // window``; each group's vertex set
    is its referenced ids (sorted), with faces re-indexed locally. Relies on
    welded vertices being sorted spatially (extraction emits them that way),
    so groups only exceed the window by boundary-straddling faces. Returns
    None when any group still exceeds uint16 range (degenerate connectivity —
    caller falls back to one uint32 primitive).
    """
    group_of = faces.min(axis=1) // window
    groups = []

    for g in np.unique(group_of):
        f_g = faces[group_of == g]
        vertex_ids = np.unique(f_g)
        if len(vertex_ids) >= 65536:
            return None
        local = np.searchsorted(vertex_ids, f_g)
        groups.append((vertex_ids, local))

    return groups


def export_scene(scene: Scene, output_path: str, quantize: bool = False):
    """Write a :class:`Scene` as a binary glTF file.

    With ``quantize=True`` vertex attributes are stored quantized under the
    standard ``KHR_mesh_quantization`` extension (supported by conforming
    renderers, e.g. three.js): positions as normalized uint16 on a UNIFORM
    per-mesh grid (the node carries the dequantizing translation + scale —
    uniform so normals need no inverse-transpose correction), normals as
    normalized int8, UVs as normalized uint16, and face indices as uint16
    whenever the mesh has < 65536 vertices. This is the native fallback for
    the reference's draco_transcoder stage (ref hive/pipeline.py:938-980)
    when the external binary is unavailable.
    """
    builder = _BufferBuilder()
    accessors: List[dict] = []
    meshes: List[dict] = []
    nodes: List[dict] = []
    materials: List[dict] = []
    images: List[dict] = []
    textures: List[dict] = []
    samplers: List[dict] = []

    def add_accessor(view: int, component_type: int, count: int, accessor_type: str,
                     normalized: bool = False, minmax: Optional[Tuple] = None) -> int:
        accessor = {"bufferView": view, "componentType": component_type,
                    "count": count, "type": accessor_type}
        if normalized:
            accessor["normalized"] = True
        if minmax is not None:
            accessor["min"], accessor["max"] = minmax

        accessors.append(accessor)
        return len(accessors) - 1

    for name, mesh in scene.geometry.items():
        if mesh.is_empty:
            continue

        positions = np.ascontiguousarray(mesh.vertices, dtype=np.float32)
        faces = np.ascontiguousarray(mesh.faces, dtype=np.int64)
        node_transform = {}

        # ---- per-vertex attribute arrays (quantized or raw), built once ----
        if quantize:
            lo = positions.min(axis=0)
            extent = float(max(positions.max(axis=0) - lo)) or 1.0
            q = np.round((positions - lo) / extent * 65535.0)
            pos_arr = np.zeros((len(q), 4), dtype=np.uint16)  # stride pads to 8B
            pos_arr[:, :3] = np.clip(q, 0, 65535)
            # Dequantize: p = translation + scale * (stored / 65535).
            node_transform = {"translation": lo.astype(float).tolist(),
                              "scale": [extent] * 3}
        else:
            pos_arr = positions

        normals_arr = None
        if mesh.vertex_normals is not None:
            normals = np.ascontiguousarray(mesh.vertex_normals, dtype=np.float32)
            if quantize:
                normals_arr = np.zeros((len(normals), 4), dtype=np.int8)  # 4B
                normals_arr[:, :3] = np.clip(np.round(normals * 127.0), -127, 127)
            else:
                normals_arr = normals

        rgba = None
        if mesh.vertex_colors is not None:
            rgba = mesh.vertex_colors
            if rgba.shape[1] == 3:
                rgba = np.concatenate(
                    [rgba, np.full((len(rgba), 1), 255, dtype=rgba.dtype)], axis=-1)
            rgba = np.ascontiguousarray(rgba, dtype=np.uint8)

        uv_arr = None
        if mesh.uv is not None and mesh.texture is not None:
            # Mesh UVs use a bottom-left origin (matching the reference's
            # internal convention, hive/pipeline.py:866); glTF uses top-left.
            uv = np.ascontiguousarray(mesh.uv, dtype=np.float32).copy()
            uv[:, 1] = 1.0 - uv[:, 1]
            if quantize:
                uv_arr = np.clip(np.round(uv * 65535.0), 0, 65535).astype(np.uint16)
            else:
                uv_arr = uv

        # ---- one material per mesh, shared by all its primitives ----------
        material_index = None
        if uv_arr is not None:
            # The primary export stays lossless PNG. The compressed
            # (quantize) encoding also tries JPEG q92 — spec-core, ~3-6x
            # smaller than PNG on camera crops (which dominate foreground
            # mesh size) — and keeps whichever is smaller per texture (PNG
            # wins on flat synthetic content). A payload cached by load_glb
            # (same texture array object) skips the PNG re-encode entirely.
            texture = np.asarray(mesh.texture).astype(np.uint8)
            cached = getattr(mesh, "_texture_payload", None)

            if cached is not None and cached[2] is mesh.texture:
                payload, mime = cached[0], cached[1]
            else:
                payload, mime = encode_png(texture), "image/png"

            # JPEG cannot carry alpha; only offer it for RGB textures — and
            # never re-encode an already-JPEG cached payload: a fresh q92
            # encode of decoded JPEG pixels is usually byte-smaller (double
            # compression), so the size test would accept another
            # generation of loss on every quantize pass.
            is_rgb = texture.ndim == 3 and texture.shape[2] == 3
            if quantize and is_rgb and mime != "image/jpeg":
                jpeg = encode_jpeg(texture, quality=92)
                if len(jpeg) < len(payload):
                    payload, mime = jpeg, "image/jpeg"

            img_view = builder.add_view(payload)

            images.append({"bufferView": img_view, "mimeType": mime})

            if not samplers:
                samplers.append({"magFilter": 9729, "minFilter": 9729,
                                 "wrapS": 33071, "wrapT": 33071})

            textures.append({"sampler": 0, "source": len(images) - 1})
            materials.append({
                "pbrMetallicRoughness": {
                    "baseColorTexture": {"index": len(textures) - 1},
                    "metallicFactor": 0.0,
                    "roughnessFactor": 1.0,
                },
                "name": f"{name}_material",
            })
            material_index = len(materials) - 1
        elif rgba is not None:
            materials.append({
                "pbrMetallicRoughness": {"metallicFactor": 0.0, "roughnessFactor": 1.0},
                "name": f"{name}_material",
            })
            material_index = len(materials) - 1

        def emit_primitive(vsel, local_faces) -> dict:
            """One glTF primitive over vertex subset ``vsel`` (None = all)."""
            def rows(a):
                return a if vsel is None else np.ascontiguousarray(a[vsel])

            p = rows(pos_arr)
            if quantize:
                pos_view = builder.add_view(p.tobytes(), target=_ARRAY_BUFFER,
                                            byte_stride=8)
                pos_acc = add_accessor(pos_view, _USHORT, len(p), "VEC3",
                                       normalized=True,
                                       minmax=(p[:, :3].min(axis=0).tolist(),
                                               p[:, :3].max(axis=0).tolist()))
            else:
                pos_view = builder.add_view(p.tobytes(), target=_ARRAY_BUFFER)
                pos_acc = add_accessor(pos_view, _FLOAT, len(p), "VEC3",
                                       minmax=(p.min(axis=0).tolist(),
                                               p.max(axis=0).tolist()))

            if quantize and len(p) < 65536:
                flat = np.ascontiguousarray(local_faces.reshape(-1), dtype=np.uint16)
                idx_view = builder.add_view(flat.tobytes(),
                                            target=_ELEMENT_ARRAY_BUFFER)
                idx_acc = add_accessor(idx_view, _USHORT, len(flat), "SCALAR")
            else:
                flat = np.ascontiguousarray(local_faces.reshape(-1), dtype=np.uint32)
                idx_view = builder.add_view(flat.tobytes(),
                                            target=_ELEMENT_ARRAY_BUFFER)
                idx_acc = add_accessor(idx_view, _UINT, len(flat), "SCALAR")

            attributes = {"POSITION": pos_acc}
            primitive = {"attributes": attributes, "indices": idx_acc, "mode": 4}

            if normals_arr is not None:
                n = rows(normals_arr)
                if quantize:
                    norm_view = builder.add_view(n.tobytes(), target=_ARRAY_BUFFER,
                                                 byte_stride=4)
                    attributes["NORMAL"] = add_accessor(norm_view, _BYTE, len(n),
                                                        "VEC3", normalized=True)
                else:
                    norm_view = builder.add_view(n.tobytes(), target=_ARRAY_BUFFER)
                    attributes["NORMAL"] = add_accessor(norm_view, _FLOAT,
                                                        len(n), "VEC3")

            if rgba is not None:
                c = rows(rgba)
                col_view = builder.add_view(c.tobytes(), target=_ARRAY_BUFFER)
                attributes["COLOR_0"] = add_accessor(col_view, _UBYTE, len(c),
                                                     "VEC4", normalized=True)

            if uv_arr is not None:
                u = rows(uv_arr)
                uv_view = builder.add_view(u.tobytes(), target=_ARRAY_BUFFER)
                attributes["TEXCOORD_0"] = add_accessor(
                    uv_view, _USHORT if quantize else _FLOAT, len(u), "VEC2",
                    normalized=quantize)

            if material_index is not None:
                primitive["material"] = material_index

            return primitive

        # Large quantized meshes split into < 65536-vertex primitives so the
        # (size-dominating) indices also drop to uint16. Vertices are welded
        # in sorted spatial order by extraction, so in-order face windows
        # duplicate only the few boundary-straddling vertices.
        groups = (_split_faces_for_uint16(faces)
                  if quantize and len(positions) >= 65536 else None)

        if groups is None:
            primitives = [emit_primitive(None, faces)]
        else:
            primitives = [emit_primitive(vids, local) for vids, local in groups]

        meshes.append({"primitives": primitives, "name": name})
        nodes.append({"mesh": len(meshes) - 1, "name": name, **node_transform})

    gltf: Dict = {
        "asset": {"version": "2.0", "generator": "hive_tpu_torch"},
        "scene": 0,
        "scenes": [{"nodes": list(range(len(nodes)))}],
        "nodes": nodes,
        "meshes": meshes,
        "accessors": accessors,
        "bufferViews": builder.views,
        "buffers": [{"byteLength": len(builder.tobytes())}],
    }

    if quantize:
        gltf["extensionsUsed"] = ["KHR_mesh_quantization"]
        gltf["extensionsRequired"] = ["KHR_mesh_quantization"]

    if materials:
        gltf["materials"] = materials
    if images:
        gltf["images"] = images
        gltf["textures"] = textures
        gltf["samplers"] = samplers

    if scene.camera_focal is not None and scene.camera_resolution is not None:
        width, height = scene.camera_resolution
        fy = scene.camera_focal[1]
        gltf["cameras"] = [{
            "type": "perspective",
            "perspective": {"yfov": float(2.0 * np.arctan(height / (2.0 * fy))),
                            "aspectRatio": float(width / height), "znear": 0.01},
        }]

    json_blob = json.dumps(gltf, separators=(",", ":")).encode("utf-8")
    json_blob += b" " * ((-len(json_blob)) % 4)
    bin_blob = builder.tobytes()

    total = 12 + 8 + len(json_blob) + 8 + len(bin_blob)

    with open(output_path, "wb") as fh:
        fh.write(struct.pack("<III", _GLB_MAGIC, 2, total))
        fh.write(struct.pack("<II", len(json_blob), _CHUNK_JSON))
        fh.write(json_blob)
        fh.write(struct.pack("<II", len(bin_blob), _CHUNK_BIN))
        fh.write(bin_blob)


_COMPONENT_DTYPES = {5120: np.int8, 5121: np.uint8, 5122: np.int16,
                     5123: np.uint16, 5125: np.uint32, 5126: np.float32}
_TYPE_WIDTHS = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}


def _read_glb_json(path: str) -> dict:
    """Parse just the JSON chunk of a .glb."""
    with open(path, "rb") as fh:
        magic, _, _ = struct.unpack("<III", fh.read(12))
        if magic != _GLB_MAGIC:
            raise ValueError(f"{path} is not a binary glTF file")
        json_len, chunk_type = struct.unpack("<II", fh.read(8))
        assert chunk_type == _CHUNK_JSON
        return json.loads(fh.read(json_len))


def _patch_glb_json(path: str, updates: dict) -> None:
    """Rewrite a .glb with extra top-level glTF JSON keys, bin chunk intact."""
    with open(path, "rb") as fh:
        magic, version, _ = struct.unpack("<III", fh.read(12))
        json_len, chunk_type = struct.unpack("<II", fh.read(8))
        assert chunk_type == _CHUNK_JSON
        gltf = json.loads(fh.read(json_len))
        rest = fh.read()

    gltf.update(updates)
    json_blob = json.dumps(gltf, separators=(",", ":")).encode("utf-8")
    json_blob += b" " * ((-len(json_blob)) % 4)

    with open(path, "wb") as fh:
        fh.write(struct.pack("<III", magic, version,
                             12 + 8 + len(json_blob) + len(rest)))
        fh.write(struct.pack("<II", len(json_blob), _CHUNK_JSON))
        fh.write(json_blob)
        fh.write(rest)


def _decode_texture(image_bytes: bytes) -> np.ndarray:
    """A PNG or JPEG texture, told apart by its signature, as (H, W, 3) RGB."""
    if image_bytes[:8] == b"\x89PNG\r\n\x1a\n":
        texture = decode_png(image_bytes)
    elif image_bytes[:2] == b"\xff\xd8":
        texture = decode_jpeg(image_bytes)
    else:
        raise ValueError("a glTF texture must be a PNG or a JPEG image")
    if texture.ndim == 2:
        texture = np.repeat(texture[..., None], 3, axis=-1)
    return texture


def load_glb(path: str) -> Scene:
    """Read a .glb file written by :func:`export_scene` (or any simple glTF)."""
    with open(path, "rb") as fh:
        magic, version, _ = struct.unpack("<III", fh.read(12))
        if magic != _GLB_MAGIC:
            raise ValueError(f"{path} is not a binary glTF file")

        json_len, chunk_type = struct.unpack("<II", fh.read(8))
        assert chunk_type == _CHUNK_JSON
        gltf = json.loads(fh.read(json_len))

        binary = b""
        rest = fh.read(8)
        if rest:
            bin_len, chunk_type = struct.unpack("<II", rest)
            assert chunk_type == _CHUNK_BIN
            binary = fh.read(bin_len)

    def read_accessor(index: int) -> np.ndarray:
        accessor = gltf["accessors"][index]
        view = gltf["bufferViews"][accessor["bufferView"]]
        dtype = _COMPONENT_DTYPES[accessor["componentType"]]
        width = _TYPE_WIDTHS[accessor["type"]]
        count = accessor["count"]

        start = view.get("byteOffset", 0) + accessor.get("byteOffset", 0)
        itemsize = np.dtype(dtype).itemsize
        stride_elems = view.get("byteStride", width * itemsize) // itemsize

        data = np.frombuffer(binary, dtype=dtype,
                             count=(count - 1) * stride_elems + width,
                             offset=start)
        if stride_elems != width:  # quantized attributes pad to 4B elements
            # The final element carries only ``width`` components; pad the
            # tail so the strided reshape is rectangular.
            full = np.zeros(count * stride_elems, dtype=dtype)
            full[:data.size] = data
            data = full.reshape(count, stride_elems)[:, :width].reshape(-1)

        data = data.reshape(count, width) if width > 1 else data

        if accessor.get("normalized") and not np.issubdtype(dtype, np.floating):
            info = np.iinfo(dtype)
            denom = float(info.max)
            data = data.astype(np.float32) / denom
            if info.min < 0:
                data = np.maximum(data, -1.0)

        return data

    # Only KHR_mesh_quantization exports get their node translation/scale
    # baked into vertices (that transform exists purely to dequantize, see
    # export_scene). Foreign files with real node transforms (which may also
    # rotate — not modelled here) keep their local-space geometry untouched,
    # as before.
    is_quantized = "KHR_mesh_quantization" in gltf.get("extensionsRequired", [])

    def dequantized_positions(attributes: dict, node: dict) -> np.ndarray:
        positions = read_accessor(attributes["POSITION"]).astype(np.float32)
        if is_quantized and "scale" in node:
            positions = positions * np.asarray(node["scale"], np.float32)
        if is_quantized and "translation" in node:
            positions = positions + np.asarray(node["translation"], np.float32)
        return positions

    scene = Scene()

    for node in gltf.get("nodes", []):
        if "mesh" not in node:
            continue

        mesh_spec = gltf["meshes"][node["mesh"]]

        # Merge all primitives (quantized exports split big meshes into
        # < 65536-vertex primitives so indices fit uint16).
        all_vertices, all_faces = [], []
        all_normals, all_colors, all_uv = [], [], []
        texture = None
        texture_payload = None
        vertex_offset = 0

        for primitive in mesh_spec["primitives"]:
            attributes = primitive["attributes"]

            vertices = dequantized_positions(attributes, node)
            faces = read_accessor(primitive["indices"]).reshape(-1, 3)
            all_vertices.append(vertices)
            all_faces.append(faces.astype(np.int64) + vertex_offset)
            vertex_offset += len(vertices)

            if "NORMAL" in attributes:
                normals = read_accessor(attributes["NORMAL"]).astype(np.float32)
                norm = np.linalg.norm(normals, axis=-1, keepdims=True)
                all_normals.append(normals / np.maximum(norm, 1e-12))

            if "COLOR_0" in attributes:
                colors = read_accessor(attributes["COLOR_0"])
                if colors.dtype != np.uint8:  # normalized accessor -> u8
                    colors = np.round(colors * 255.0)
                all_colors.append(colors.astype(np.uint8))

            if "TEXCOORD_0" in attributes:
                uv = read_accessor(attributes["TEXCOORD_0"]).astype(np.float32).copy()
                uv[:, 1] = 1.0 - uv[:, 1]
                all_uv.append(uv)

                if texture is None and "material" in primitive:
                    material = gltf["materials"][primitive["material"]]
                    texture_index = (material["pbrMetallicRoughness"]
                                     ["baseColorTexture"]["index"])
                    image_index = gltf["textures"][texture_index]["source"]
                    image_spec = gltf["images"][image_index]
                    image_view = gltf["bufferViews"][image_spec["bufferView"]]

                    start = image_view.get("byteOffset", 0)
                    image_bytes = binary[start:start + image_view["byteLength"]]
                    texture = _decode_texture(image_bytes)
                    texture_payload = (image_bytes, image_spec["mimeType"],
                                       texture)

        mesh = TriangleMesh(vertices=np.concatenate(all_vertices),
                            faces=np.concatenate(all_faces))
        # Optional attributes attach only when EVERY primitive carried them:
        # a partial concatenation silently aligns primitive 1's normals to
        # primitive 0's vertices (and update_faces later indexes the short
        # array with a full-length mask) — dropping the attribute is the
        # safe reading of such a foreign glb (review finding, r5).
        num_primitives = len(all_vertices)
        if len(all_normals) == num_primitives and all_normals:
            mesh.vertex_normals = np.concatenate(all_normals)
        if len(all_colors) == num_primitives and all_colors:
            mesh.vertex_colors = np.concatenate(all_colors)
        if len(all_uv) == num_primitives and all_uv:
            mesh.uv = np.concatenate(all_uv)
            mesh.texture = texture
            if texture is not None:
                # Lets a quantized re-export pass the still-encoded payload
                # through instead of re-encoding PNG (slow on one core).
                mesh._texture_payload = texture_payload

        scene.add_geometry(mesh, node_name=node.get("name", f"node_{len(scene.geometry)}"))

    return scene


def write_gzip_sibling(path: str) -> int:
    """Write ``<path>.gz`` (gzip -9, deterministic: zero mtime, no name) and
    return its size in bytes.

    The transfer-side half of the native compression fallback: the in-tree
    viewer server (``hive_tpu_torch.viewer``) serves ``X.glb`` from
    ``X.glb.gz`` with
    ``Content-Encoding: gzip`` when the client accepts it (every browser
    does, decoding transparently) — so over the wire the quantized fallback
    reaches the external draco_transcoder's compression class
    (ref hive/pipeline.py:938-980) with zero client-side requirements.
    Any plain static file server can do the same (nginx gzip_static).
    """
    import gzip
    import os

    gz_path = path + ".gz"
    with open(path, "rb") as src, open(gz_path, "wb") as out:
        with gzip.GzipFile(filename="", mode="wb", fileobj=out,
                           compresslevel=9, mtime=0) as gz:
            shutil.copyfileobj(src, gz)
    return os.path.getsize(gz_path)


def quantize_glb(path: str, output_path: Optional[str] = None) -> Tuple[int, int]:
    """Re-encode a .glb with quantized vertex attributes (KHR_mesh_quantization).

    The native fallback for the reference's external draco_transcoder
    compression stage (ref hive/pipeline.py:938-980): positions uint16 on a
    uniform grid, normals int8, UVs uint16, uint16 indices for small meshes.
    Lossy only below the export's practical precision (sub-0.1 mm positions
    at room scale, ~0.5° normals).

    :return: (bytes before, bytes after).
    """
    import os

    size_before = os.path.getsize(path)
    # Scene-level glTF entries our Scene container doesn't model (cameras)
    # must survive the re-encode verbatim.
    preserved = {key: value
                 for key, value in _read_glb_json(path).items()
                 if key in ("cameras",)}

    scene = load_glb(path)
    export_scene(scene, output_path or path, quantize=True)

    if preserved:
        _patch_glb_json(output_path or path, preserved)

    return size_before, os.path.getsize(output_path or path)
