"""Texture cropping, UV assignment and atlas packing for per-frame meshes.

Counterpart of ``hive_tpu/meshing/texture.py`` (``get_mesh_texture_and_uv``
:18, ``pack_textures`` :50). UVs are stored with a bottom-left origin; the
glTF exporter flips to the top-left convention on write.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from hive_tpu_torch.geometric import world2image
from hive_tpu_torch.utils import validate_camera_parameter_shapes, validate_shape


def get_mesh_texture_and_uv(vertices: np.ndarray, image: np.ndarray, camera_matrix: np.ndarray,
                            rotation: np.ndarray = np.eye(3),
                            translation: np.ndarray = np.zeros((3, 1)),
                            scale_factor: float = 1.0) -> Tuple[np.ndarray, np.ndarray]:
    """Project vertices into the frame, crop the covering image region and
    return it with per-vertex (pixel-space) UV coordinates.

    :return: (cropped texture (h, w, 3), uv (N, 2) in *cropped pixel* units —
        atlas packing normalises them later).
    """
    validate_shape(vertices, "vertices", expected_shape=(None, 3))
    validate_shape(image, "image", expected_shape=(None, None, 3))
    validate_camera_parameter_shapes(camera_matrix, rotation, translation)

    uv, _ = world2image(vertices, camera_matrix, rotation, translation, scale_factor,
                        dtype=np.float64)

    rounded_min = np.round(uv.min(axis=0)).astype(int)
    rounded_max = np.round(uv.max(axis=0)).astype(int) + 1

    min_u, min_v = np.clip(rounded_min, 0, [image.shape[1], image.shape[0]])
    max_u, max_v = np.clip(rounded_max, 0, [image.shape[1], image.shape[0]])

    texture = image[min_v:max_v, min_u:max_u, :].copy()
    # UVs are relative to the CLIPPED crop origin — vertices can reproject
    # outside the frame after decimation/billboard moves them, and
    # subtracting the unclipped min would shift every UV off the crop.
    uv = uv - np.asarray([min_u, min_v], dtype=uv.dtype)

    return texture, uv


def pack_textures(textures: List[np.ndarray], uvs: List[np.ndarray],
                  n_rows: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """Pack per-object texture crops into one atlas; normalise UVs into [0, 1].

    Row-major shelf packing (same layout as the reference's `_pack_textures`,
    hive/pipeline.py:810-868). Returned V coordinates use a bottom-left origin.

    :return: (atlas (H, W, 3) uint8, stacked normalised UVs (sum N_i, 2)).
    """
    n_columns = len(textures) // n_rows + 1

    uvs = [uv.astype(np.float64).copy() for uv in uvs]
    row_images = []
    canvas_w = 0
    canvas_h = 0

    for row in range(n_rows):
        entries = [i for i in (row * n_columns + j for j in range(n_columns))
                   if i < len(textures)]

        if not entries:
            continue

        row_h = max(textures[i].shape[0] for i in entries)
        row_w = sum(textures[i].shape[1] for i in entries)
        row_image = np.zeros((row_h, row_w, 3), dtype=np.uint8)

        moving_w = 0
        for i in entries:
            h, w = textures[i].shape[:2]
            row_image[:h, moving_w:moving_w + w, :] = textures[i][..., :3]
            uvs[i][:, 0] += moving_w
            uvs[i][:, 1] += canvas_h
            moving_w += w

        canvas_w = max(canvas_w, row_w)
        canvas_h += row_h
        row_images.append(row_image)

    atlas = np.zeros((canvas_h, canvas_w, 3), dtype=np.uint8)
    moving_h = 0
    for row_image in row_images:
        h, w = row_image.shape[:2]
        atlas[moving_h:moving_h + h, :w, :] = row_image
        moving_h += h

    packed_uv = np.concatenate(uvs) if uvs else np.zeros((0, 2))
    packed_uv[:, 0] /= max(canvas_w, 1)
    packed_uv[:, 1] = 1.0 - packed_uv[:, 1] / max(canvas_h, 1)

    return atlas, packed_uv
