"""Minimal PLY mesh reader/writer (ascii + binary little-endian).

Counterpart of ``hive_tpu/meshing/ply.py`` (``load_ply`` :28, ``save_ply``
:173): reads BundleFusion's ``mesh.ply`` and provides a debug-dump format.
"""

from __future__ import annotations

import struct
from typing import Optional

import numpy as np

from hive_tpu_torch.meshing.mesh import TriangleMesh

_PLY_TYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def load_ply(path: str) -> TriangleMesh:
    with open(path, "rb") as fh:
        if fh.readline().strip() != b"ply":
            raise ValueError(f"{path} is not a PLY file")

        fmt = None
        elements = []  # list of (name, count, [(prop_name, dtype)|('list', idx_t, val_t, name)])
        current = None

        while True:
            raw = fh.readline()
            if not raw:  # EOF before end_header
                raise ValueError(f"{path}: truncated PLY header "
                                 f"(no end_header)")
            line = raw.decode("ascii").strip()

            if line == "end_header":
                break
            parts = line.split()
            if not parts:  # some exporters emit blank header lines
                continue

            if parts[0] == "format":
                fmt = parts[1]
            elif parts[0] == "element":
                current = (parts[1], int(parts[2]), [])
                elements.append(current)
            elif parts[0] == "property":
                if current is None:
                    raise ValueError(f"{path}: 'property' before any "
                                     f"'element' in the PLY header")
                if parts[1] == "list":
                    current[2].append(("list", _PLY_TYPES[parts[2]],
                                       _PLY_TYPES[parts[3]], parts[4]))
                else:
                    current[2].append((parts[2], _PLY_TYPES[parts[1]]))

        if fmt not in ("ascii", "binary_little_endian"):
            raise NotImplementedError(f"Unsupported PLY format: {fmt}")

        data = {}

        for name, count, props in elements:
            has_list = any(p[0] == "list" for p in props)

            if not has_list:
                if fmt == "ascii":
                    rows = [fh.readline().split() for _ in range(count)]
                    arr = np.array(rows, dtype=np.float64)
                    record = {p[0]: arr[:, i] for i, p in enumerate(props)}
                else:
                    dtype = np.dtype([(p[0], "<" + p[1]) for p in props])
                    arr = np.frombuffer(fh.read(dtype.itemsize * count), dtype=dtype)
                    record = {p[0]: arr[p[0]] for p in props}

                data[name] = record
            else:
                # Assume a single homogeneous list property (face vertex indices).
                faces = []

                if fmt == "ascii":
                    for _ in range(count):
                        values = fh.readline().split()
                        n = int(values[0])
                        faces.append([int(v) for v in values[1:1 + n]])
                else:
                    # The binary decoders below assume the list property is
                    # the element's ONLY property — extra scalars (e.g.
                    # Poisson's per-face quality) would silently shift every
                    # record and produce garbage faces (the ASCII branch
                    # handles them).
                    if len(props) != 1:
                        raise NotImplementedError(
                            f"{path}: binary face elements with properties "
                            f"besides the index list are not supported "
                            f"(got {[p[-1] for p in props]})")
                    _, idx_t, val_t, _ = next(p for p in props if p[0] == "list")
                    idx_size = int(idx_t[1])
                    val_size = int(val_t[1])
                    idx_code = {"u1": "B", "i1": "b", "u2": "H", "i2": "h",
                                "u4": "I", "i4": "i"}[idx_t]

                    # Bulk-read the remainder, decode in memory, and seek
                    # back past the unconsumed tail — per-face fh.read calls
                    # cost minutes at multi-million faces on this host.
                    blob = fh.read()
                    offset = 0

                    # Uniform-triangle fast path (what save_ply and
                    # BundleFusion write): one structured-dtype decode.
                    record_size = idx_size + 3 * val_size
                    if (count and len(blob) >= record_size * count):
                        tri_dtype = np.dtype([("n", "<" + idx_t),
                                              ("v", "<" + val_t, (3,))])
                        records = np.frombuffer(blob, dtype=tri_dtype,
                                                count=count)
                        if np.all(records["n"] == 3):
                            faces = records["v"].astype(np.int64)
                            offset = record_size * count

                    if count and len(faces) == 0:  # mixed polygon sizes
                        for _ in range(count):
                            (n,) = struct.unpack_from("<" + idx_code, blob,
                                                      offset)
                            offset += idx_size
                            values = np.frombuffer(blob, dtype="<" + val_t,
                                                   count=n, offset=offset)
                            offset += val_size * n
                            faces.append(values.tolist())

                    fh.seek(offset - len(blob), 1)

                data[name] = {"vertex_indices": faces}

    vertex = data.get("vertex", {})
    positions = np.stack([vertex["x"], vertex["y"], vertex["z"]], axis=-1).astype(np.float32)

    colors: Optional[np.ndarray] = None
    if "red" in vertex:
        colors = np.stack([vertex["red"], vertex["green"], vertex["blue"]],
                          axis=-1).astype(np.uint8)

    normals: Optional[np.ndarray] = None
    if "nx" in vertex:
        normals = np.stack([vertex["nx"], vertex["ny"], vertex["nz"]],
                           axis=-1).astype(np.float32)

    face_lists = data.get("face", {}).get("vertex_indices", [])

    if isinstance(face_lists, np.ndarray):  # uniform-triangle fast path
        faces = face_lists
    else:
        triangles = []
        for poly in face_lists:
            # Fan-triangulate polygons with more than 3 vertices.
            for i in range(1, len(poly) - 1):
                triangles.append([poly[0], poly[i], poly[i + 1]])

        faces = (np.asarray(triangles, dtype=np.int64) if triangles
                 else np.zeros((0, 3), np.int64))

    return TriangleMesh(vertices=positions, faces=faces,
                        vertex_colors=colors, vertex_normals=normals)


def save_ply(path: str, mesh: TriangleMesh):
    """Write a binary little-endian PLY with optional vertex colours/normals."""
    has_colors = mesh.vertex_colors is not None
    has_normals = mesh.vertex_normals is not None

    with open(path, "wb") as fh:
        header = ["ply", "format binary_little_endian 1.0",
                  f"element vertex {mesh.num_vertices}",
                  "property float x", "property float y", "property float z"]

        if has_normals:
            header += ["property float nx", "property float ny", "property float nz"]
        if has_colors:
            header += ["property uchar red", "property uchar green", "property uchar blue"]

        header += [f"element face {mesh.num_faces}",
                   "property list uchar int vertex_indices", "end_header"]
        fh.write(("\n".join(header) + "\n").encode("ascii"))

        fields = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
        if has_normals:
            fields += [("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4")]
        if has_colors:
            fields += [("red", "u1"), ("green", "u1"), ("blue", "u1")]

        vertex_data = np.zeros(mesh.num_vertices, dtype=np.dtype(fields))
        vertex_data["x"] = mesh.vertices[:, 0]
        vertex_data["y"] = mesh.vertices[:, 1]
        vertex_data["z"] = mesh.vertices[:, 2]

        if has_normals:
            vertex_data["nx"] = mesh.vertex_normals[:, 0]
            vertex_data["ny"] = mesh.vertex_normals[:, 1]
            vertex_data["nz"] = mesh.vertex_normals[:, 2]

        if has_colors:
            rgb = mesh.vertex_colors[:, :3]
            vertex_data["red"] = rgb[:, 0]
            vertex_data["green"] = rgb[:, 1]
            vertex_data["blue"] = rgb[:, 2]

        fh.write(vertex_data.tobytes())

        face_data = np.zeros(mesh.num_faces,
                             dtype=np.dtype([("n", "u1"), ("idx", "<i4", (3,))]))
        face_data["n"] = 3
        face_data["idx"] = mesh.faces.astype(np.int32)
        fh.write(face_data.tobytes())
