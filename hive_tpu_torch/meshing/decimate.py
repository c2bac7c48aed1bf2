"""Mesh decimation: native QEM edge collapse with a clustering fallback.

Counterpart of ``hive_tpu/meshing/decimate.py`` (``decimate_mesh`` :17,
``_decimate_clustering`` :69). The QEM collapser is the JAX package's
``qem_decimate.cpp``, copied into ``hive_tpu_torch/native/src`` and built
with the same flags.
"""

from __future__ import annotations

import ctypes
import logging
from typing import Tuple

import numpy as np

from hive_tpu_torch.native import get_native_lib


def decimate_mesh(vertices: np.ndarray, faces: np.ndarray, target_faces: int,
                  max_error: float = 0.001) -> Tuple[np.ndarray, np.ndarray]:
    """Simplify a mesh to approximately ``target_faces`` triangles.

    Uses the native quadric-error-metric collapser when available; otherwise a
    vertex-clustering fallback (lower quality, still bounded output size).

    :param vertices: (N, 3) float vertices.
    :param faces: (M, 3) int face indices.
    :param target_faces: Desired triangle count (-1 disables decimation).
    :param max_error: Maximum quadric error allowed per collapse.
    :return: (vertices, faces) of the simplified mesh.
    """
    if target_faces < 0 or len(faces) <= target_faces:
        return vertices, faces

    lib = get_native_lib()

    if lib is not None:
        return _decimate_native(lib, vertices, faces, target_faces, max_error)

    logging.warning("Native decimation unavailable; using vertex-clustering fallback.")
    return _decimate_clustering(vertices, faces, target_faces)


def _decimate_native(lib, vertices, faces, target_faces, max_error):
    verts64 = np.ascontiguousarray(vertices, dtype=np.float64)
    faces32 = np.ascontiguousarray(faces, dtype=np.int32)

    out_verts = np.empty_like(verts64)
    out_faces = np.empty_like(faces32)
    out_nv = ctypes.c_int(0)
    out_nf = ctypes.c_int(0)

    status = lib.hive_qem_decimate(
        verts64.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(verts64),
        faces32.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), len(faces32),
        int(target_faces), float(max_error),
        out_verts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.byref(out_nv),
        out_faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        ctypes.byref(out_nf),
    )

    if status != 0:
        logging.warning("Native decimation failed; returning the input mesh.")
        return vertices, faces

    return (out_verts[:out_nv.value].astype(vertices.dtype),
            out_faces[:out_nf.value].astype(faces.dtype))


def _decimate_clustering(vertices, faces, target_faces):
    """Grid-based vertex clustering: merge vertices per cell, drop degenerates.

    Chooses the grid resolution by bisection to land near the target count.
    """
    bounds_min = vertices.min(axis=0)
    extent = np.maximum(vertices.max(axis=0) - bounds_min, 1e-9)

    def cluster(cells_per_axis: int):
        cell = extent / cells_per_axis
        keys = np.floor((vertices - bounds_min) / cell).astype(np.int64)
        keys = np.minimum(keys, cells_per_axis - 1)
        flat = (keys[:, 0] * cells_per_axis + keys[:, 1]) * cells_per_axis + keys[:, 2]

        unique, inverse = np.unique(flat, return_inverse=True)

        new_vertices = np.zeros((len(unique), 3), dtype=np.float64)
        counts = np.bincount(inverse)
        for axis in range(3):
            new_vertices[:, axis] = np.bincount(inverse, weights=vertices[:, axis]) / counts

        new_faces = inverse[faces]
        ok = ((new_faces[:, 0] != new_faces[:, 1])
              & (new_faces[:, 1] != new_faces[:, 2])
              & (new_faces[:, 0] != new_faces[:, 2]))

        return new_vertices.astype(vertices.dtype), new_faces[ok]

    lo, hi = 2, 256
    # Fallback is the COARSEST grid: when every resolution (even 2^3
    # cells) exceeds the target, the bounded-output contract demands the
    # fewest-faces result.
    best = cluster(lo)
    if len(best[1]) <= target_faces:
        # The coarsest already fits; bisect upward for the largest fitting
        # resolution (closest to the target from below).
        while lo < hi:
            mid = (lo + hi) // 2
            candidate = cluster(mid)

            if len(candidate[1]) > target_faces:
                hi = mid
            else:
                best = candidate
                lo = mid + 1

    return best
