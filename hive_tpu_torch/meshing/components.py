"""Connected-component analysis for floater removal.

Counterpart of ``hive_tpu/meshing/components.py``
(``face_connected_components`` :17, ``cleanup_with_connected_components``
:45): scipy.sparse.csgraph over the face-adjacency graph (faces are adjacent
iff they share an edge).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import connected_components as _cc


def face_connected_components(faces: np.ndarray) -> Tuple[int, np.ndarray]:
    """Label faces by connected component (edge-shared adjacency).

    :param faces: (M, 3) triangle vertex indices.
    :return: (number of components, (M,) component label per face).
    """
    m = len(faces)

    if m == 0:
        return 0, np.zeros(0, dtype=np.int64)

    # Each face contributes 3 (sorted) edges; faces sharing an edge are linked.
    edges = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
    edges = np.sort(edges, axis=-1)
    face_ids = np.tile(np.arange(m), 3)

    order = np.lexsort((edges[:, 1], edges[:, 0]))
    edges_sorted = edges[order]
    faces_sorted = face_ids[order]

    same_as_next = (edges_sorted[:-1] == edges_sorted[1:]).all(axis=-1)
    a = faces_sorted[:-1][same_as_next]
    b = faces_sorted[1:][same_as_next]

    graph = coo_matrix((np.ones(len(a), dtype=np.int8), (a, b)), shape=(m, m))
    return _cc(graph, directed=False)


def cleanup_with_connected_components(vertices: np.ndarray, faces: np.ndarray,
                                      is_object: bool = True,
                                      min_components: int = 5) -> Tuple[np.ndarray, np.ndarray]:
    """Drop floating mesh fragments.

    For objects, keep only the largest component; for background geometry,
    keep every component with at least ``min_components`` faces — the same
    policy as the reference (hive/pipeline.py:740-779).

    :return: (vertices, faces) with unreferenced vertices removed.
    """
    if len(faces) == 0:
        return vertices, faces

    num_components, labels = face_connected_components(faces)
    sizes = np.bincount(labels, minlength=num_components)

    if is_object:
        # Components below min_components are discarded BEFORE picking the
        # largest (reference filters with min_len first, hive/pipeline.py:761
        # — a noise blob smaller than the threshold yields an empty mesh).
        if sizes.max() < min_components:
            return np.zeros((0, 3), vertices.dtype), np.zeros((0, 3), faces.dtype)
        keep = labels == np.argmax(sizes)
    else:
        keep = sizes[labels] >= min_components

    kept_faces = faces[keep]

    used = np.zeros(len(vertices), dtype=bool)
    used[kept_faces.reshape(-1)] = True
    remap = np.cumsum(used) - 1

    return vertices[used], remap[kept_faces]
