"""2D Delaunay triangulation + face filtering for per-frame depth meshes.

Counterpart of ``hive_tpu/meshing/triangulate.py`` (``triangulate_points``
:16, ``triangulate_grid`` :31, ``filter_faces`` :91): host numpy and scipy,
line for line, so both packages give the same faces.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import Delaunay

from hive_tpu_torch.options import MeshFilteringOptions
from hive_tpu_torch.utils import validate_shape


def triangulate_points(points2d: np.ndarray) -> np.ndarray:
    """Delaunay-triangulate 2D (pixel) points into face indices.

    The winding order is reversed so that faces viewed from the camera are
    front-facing under back-face culling (hive/pipeline.py:664-665 behaviour).

    :param points2d: (N, 2) image-space points.
    :return: (M, 3) face vertex indices.
    """
    validate_shape(points2d, "points", expected_shape=(None, 2))

    simplices = Delaunay(points2d).simplices
    return np.asarray(simplices)[:, ::-1]


def triangulate_grid(valid_mask: np.ndarray, depth: np.ndarray,
                     options: MeshFilteringOptions):
    """Triangulate the valid pixels of a mask directly on the pixel grid.

    Each 2x2 quad of valid pixels emits two triangles whose edges satisfy the
    depth-discontinuity threshold — fully vectorised, no O(N log N) host
    triangulation per object. On hole-free regions this matches Delaunay +
    face filtering; the divergence is isolated invalid pixels: every quad
    needs all four corners valid, so a single bad depth pixel punches a
    one-pixel hole, while Delaunay at the default ``max_pixel_distance=2``
    can bridge it with a 2-px edge. Choose ``--triangulation delaunay`` for
    depth maps with salt-and-pepper dropouts.

    :param valid_mask: (H, W) bool pixels to mesh.
    :param depth: (H, W) float depth map.
    :return: (points2d (N, 2) int [u, v], faces (M, 3) into points2d,
        masked_depth (N,)) — same contract as the Delaunay path.
    """
    h, w = valid_mask.shape

    v_idx, u_idx = np.nonzero(valid_mask)
    points2d = np.stack([u_idx, v_idx], axis=-1)
    masked_depth = depth[valid_mask]

    index_map = np.full((h, w), -1, dtype=np.int64)
    index_map[v_idx, u_idx] = np.arange(len(v_idx))

    a = index_map[:-1, :-1]
    b = index_map[:-1, 1:]
    c = index_map[1:, :-1]
    d = index_map[1:, 1:]

    quad_ok = (a >= 0) & (b >= 0) & (c >= 0) & (d >= 0)

    da = depth[:-1, :-1]
    db = depth[:-1, 1:]
    dc = depth[1:, :-1]
    dd = depth[1:, 1:]

    t = options.max_depth_distance

    def edge_ok(x, y):
        return np.abs(x - y) <= t

    # Every triangle uses the quad diagonal (length sqrt(2) pixels): a budget
    # below that cannot connect anything.
    if options.max_pixel_distance < np.sqrt(2.0):
        return points2d, np.zeros((0, 3), dtype=np.int64), masked_depth

    # Triangle 1: (a, d, b); triangle 2: (a, c, d) — winding chosen to match
    # the reversed-Delaunay convention (front faces toward the camera).
    tri1_ok = quad_ok & edge_ok(da, dd) & edge_ok(dd, db) & edge_ok(da, db)
    tri2_ok = quad_ok & edge_ok(da, dc) & edge_ok(dc, dd) & edge_ok(da, dd)

    faces1 = np.stack([a[tri1_ok], d[tri1_ok], b[tri1_ok]], axis=-1)
    faces2 = np.stack([a[tri2_ok], c[tri2_ok], d[tri2_ok]], axis=-1)

    return points2d, np.concatenate([faces1, faces2]), masked_depth


def filter_faces(points2d: np.ndarray, depth: np.ndarray, faces: np.ndarray,
                 options: MeshFilteringOptions) -> np.ndarray:
    """Drop faces that connect distant vertices.

    A face survives iff every edge is short both in image space
    (<= max_pixel_distance) and in depth (<= max_depth_distance) — this
    removes the stretched "rubber sheet" triangles across depth
    discontinuities (hive/pipeline.py:669-694 behaviour).
    """
    validate_shape(points2d, "points2d", expected_shape=(None, 2))
    validate_shape(depth, "depth", expected_shape=(points2d.shape[0],))
    validate_shape(faces, "faces", expected_shape=(None, 3))

    a = faces[:, [0, 2, 0]]
    b = faces[:, [1, 1, 2]]

    pixel_distances = np.linalg.norm(points2d[a] - points2d[b], axis=-1)
    depth_distances = np.abs(depth[a] - depth[b])

    valid = ((pixel_distances <= options.max_pixel_distance)
             & (depth_distances <= options.max_depth_distance)).all(axis=1)

    return faces[valid]
