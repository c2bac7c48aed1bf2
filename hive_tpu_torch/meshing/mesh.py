"""Lightweight triangle-mesh and scene containers.

The reference leaned on trimesh for mesh storage, transforms and export
(hive/pipeline.py throughout); this framework owns its mesh representation so
the device pipeline can hand meshes around as plain arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class TriangleMesh:
    """A triangle mesh with optional vertex colours or a single texture.

    ``vertices`` (N, 3) float; ``faces`` (M, 3) int; optional ``vertex_colors``
    (N, 3|4) uint8, ``vertex_normals`` (N, 3) float, ``uv`` (N, 2) float in
    [0, 1] with ``texture`` (H, W, 3) uint8.
    """

    vertices: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros((0, 3), np.float32))
    faces: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros((0, 3), np.int64))
    vertex_colors: Optional[np.ndarray] = None
    vertex_normals: Optional[np.ndarray] = None
    uv: Optional[np.ndarray] = None
    texture: Optional[np.ndarray] = None

    @property
    def is_empty(self) -> bool:
        return len(self.faces) == 0

    @property
    def num_vertices(self) -> int:
        return len(self.vertices)

    @property
    def num_faces(self) -> int:
        return len(self.faces)

    @property
    def bounds(self) -> Optional[np.ndarray]:
        """(2, 3) min/max corner, or None when empty."""
        if len(self.vertices) == 0:
            return None

        return np.stack([self.vertices.min(axis=0), self.vertices.max(axis=0)])

    def copy(self) -> "TriangleMesh":
        return TriangleMesh(
            vertices=self.vertices.copy(),
            faces=self.faces.copy(),
            vertex_colors=None if self.vertex_colors is None else self.vertex_colors.copy(),
            vertex_normals=None if self.vertex_normals is None else self.vertex_normals.copy(),
            uv=None if self.uv is None else self.uv.copy(),
            texture=None if self.texture is None else self.texture.copy(),
        )

    def apply_transform(self, transform: np.ndarray) -> "TriangleMesh":
        """Apply a 4x4 homogeneous transform in place (returns self)."""
        if len(self.vertices):
            self.vertices = self.vertices @ transform[:3, :3].T + transform[:3, 3]

            if self.vertex_normals is not None:
                # Normals transform by the INVERSE-TRANSPOSE of the linear
                # part (equal to the rotation itself only for rigid
                # transforms): applying the raw linear part tilts normals
                # TOWARD a stretched axis instead of away under non-uniform
                # scale/shear (review finding, r5). Renormalised below;
                # singular transforms keep the old normals.
                linear = transform[:3, :3]
                try:
                    normal_matrix = np.linalg.inv(linear).T
                except np.linalg.LinAlgError:
                    normal_matrix = None
                if normal_matrix is not None:
                    normals = self.vertex_normals @ normal_matrix.T
                    norms = np.linalg.norm(normals, axis=-1, keepdims=True)
                    self.vertex_normals = normals / np.maximum(norms, 1e-12)

        if np.linalg.det(transform[:3, :3]) < 0 and len(self.faces):
            # A reflection flips winding; reverse faces to keep outward orientation.
            self.faces = self.faces[:, ::-1].copy()

        return self

    def apply_translation(self, offset) -> "TriangleMesh":
        self.vertices = self.vertices + np.asarray(offset, dtype=self.vertices.dtype)
        return self

    def compute_vertex_normals(self) -> np.ndarray:
        """Area-weighted vertex normals (stored and returned)."""
        tri = self.vertices[self.faces]
        face_normals = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])

        # Segment-sum via bincount (np.add.at is an order of magnitude slower
        # on meshes with millions of faces).
        idx = self.faces.reshape(-1)
        rep = np.repeat(face_normals, 3, axis=0)
        normals = np.stack(
            [np.bincount(idx, weights=rep[:, c], minlength=len(self.vertices))
             for c in range(3)], axis=-1)

        lengths = np.linalg.norm(normals, axis=-1, keepdims=True)
        self.vertex_normals = (normals / np.maximum(lengths, 1e-12)).astype(np.float32)
        return self.vertex_normals

    def update_faces(self, face_mask: np.ndarray) -> "TriangleMesh":
        """Keep only the masked faces and drop now-unreferenced vertices (in place)."""
        faces = self.faces[face_mask]

        used = np.zeros(len(self.vertices), dtype=bool)
        used[faces.reshape(-1)] = True
        remap = np.cumsum(used) - 1

        self.vertices = self.vertices[used]
        self.faces = remap[faces]

        for attr in ("vertex_colors", "vertex_normals", "uv"):
            value = getattr(self, attr)
            if value is not None:
                setattr(self, attr, value[used])

        return self


class Scene:
    """A named collection of meshes with a shared camera (glTF-exportable).

    Mirrors the trimesh.Scene role in the reference (hive/pipeline.py:636-648).
    """

    def __init__(self, camera_resolution: Optional[Tuple[int, int]] = None,
                 camera_focal: Optional[Tuple[float, float]] = None):
        self.camera_resolution = camera_resolution
        self.camera_focal = camera_focal
        self.geometry: Dict[str, TriangleMesh] = {}

    def add_geometry(self, mesh: TriangleMesh, node_name: str):
        self.geometry[node_name] = mesh

    def copy(self) -> "Scene":
        scene = Scene(camera_resolution=self.camera_resolution, camera_focal=self.camera_focal)
        scene.geometry = {name: mesh.copy() for name, mesh in self.geometry.items()}
        return scene

    @property
    def node_names(self) -> List[str]:
        return list(self.geometry.keys())

    @property
    def bounds(self) -> Optional[np.ndarray]:
        all_bounds = [m.bounds for m in self.geometry.values() if m.bounds is not None]

        if not all_bounds:
            return None

        stacked = np.stack(all_bounds)
        return np.stack([stacked[:, 0].min(axis=0), stacked[:, 1].max(axis=0)])

    def apply_transform(self, transform: np.ndarray) -> "Scene":
        for mesh in self.geometry.values():
            mesh.apply_transform(transform)
        return self

    def apply_translation(self, offset) -> "Scene":
        for mesh in self.geometry.values():
            mesh.apply_translation(offset)
        return self

    def count_triangles(self) -> Tuple[int, int]:
        """(total triangle count, number of non-empty meshes)."""
        total = 0
        num_meshes = 0

        for mesh in self.geometry.values():
            if not mesh.is_empty:
                total += mesh.num_faces
                num_meshes += 1

        return total, num_meshes
