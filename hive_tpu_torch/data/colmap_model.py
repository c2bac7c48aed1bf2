"""Reader and writer for COLMAP sparse reconstruction models (.bin) and
dense-stereo depth maps.

Counterpart of ``hive_tpu/data/colmap_model.py``: the same camera, image and
point records, readers and writers, so a model written by either package
is byte for byte the model the other writes. An independent implementation
of the documented COLMAP model format (https://colmap.github.io/format.html);
host numpy, nothing here runs on the card.
"""

from __future__ import annotations

import dataclasses
import os
import struct
from typing import Dict, Tuple

import numpy as np

# COLMAP camera model ids → (name, number of parameters).
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}


@dataclasses.dataclass(frozen=True)
class ColmapCamera:
    camera_id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclasses.dataclass(frozen=True)
class ColmapImage:
    image_id: int
    qvec: np.ndarray  # scalar-FIRST quaternion (w, x, y, z), as stored by COLMAP
    tvec: np.ndarray
    camera_id: int
    name: str
    xys: np.ndarray
    point3d_ids: np.ndarray

    def rotation_matrix(self) -> np.ndarray:
        """World-to-camera rotation from COLMAP's scalar-first quaternion."""
        w, x, y, z = self.qvec / np.linalg.norm(self.qvec)
        return np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ])

    # Alias matching the COLMAP scripts' method name, for familiarity.
    qvec2rotmat = rotation_matrix


@dataclasses.dataclass(frozen=True)
class ColmapPoint3D:
    point3d_id: int
    xyz: np.ndarray
    rgb: np.ndarray
    error: float


def _read(fh, fmt: str):
    size = struct.calcsize(fmt)
    return struct.unpack(fmt, fh.read(size))


def read_cameras_bin(path: str) -> Dict[int, ColmapCamera]:
    cameras = {}

    with open(path, "rb") as fh:
        (num_cameras,) = _read(fh, "<Q")

        for _ in range(num_cameras):
            camera_id, model_id, width, height = _read(fh, "<iiQQ")
            model_name, num_params = CAMERA_MODELS[model_id]
            params = np.array(_read(fh, f"<{num_params}d"))
            cameras[camera_id] = ColmapCamera(camera_id=camera_id, model=model_name,
                                              width=int(width), height=int(height),
                                              params=params)

    return cameras


def read_images_bin(path: str) -> Dict[int, ColmapImage]:
    images = {}

    with open(path, "rb") as fh:
        (num_images,) = _read(fh, "<Q")

        for _ in range(num_images):
            image_id = _read(fh, "<i")[0]
            qvec = np.array(_read(fh, "<4d"))
            tvec = np.array(_read(fh, "<3d"))
            (camera_id,) = _read(fh, "<i")

            name_bytes = b""
            while (ch := fh.read(1)) != b"\x00":
                name_bytes += ch

            (num_points2d,) = _read(fh, "<Q")
            data = np.frombuffer(fh.read(24 * num_points2d),
                                 dtype=[("x", "<f8"), ("y", "<f8"), ("id", "<i8")])

            images[image_id] = ColmapImage(
                image_id=image_id, qvec=qvec, tvec=tvec, camera_id=camera_id,
                name=name_bytes.decode("utf-8"),
                xys=np.stack([data["x"], data["y"]], axis=-1),
                point3d_ids=data["id"].copy(),
            )

    return images


def read_points3d_bin(path: str) -> Dict[int, ColmapPoint3D]:
    points = {}

    with open(path, "rb") as fh:
        (num_points,) = _read(fh, "<Q")

        for _ in range(num_points):
            (point3d_id,) = _read(fh, "<Q")
            xyz = np.array(_read(fh, "<3d"))
            rgb = np.array(_read(fh, "<3B"))
            (error,) = _read(fh, "<d")
            (track_length,) = _read(fh, "<Q")
            fh.read(8 * track_length)  # (image_id, point2d_idx) pairs, unused here

            points[point3d_id] = ColmapPoint3D(point3d_id=int(point3d_id), xyz=xyz,
                                               rgb=rgb, error=float(error))

    return points


def read_model(path: str) -> Tuple[dict, dict, dict]:
    """Read a binary COLMAP sparse model directory → (cameras, images, points3d)."""
    cameras = read_cameras_bin(os.path.join(path, "cameras.bin"))
    images = read_images_bin(os.path.join(path, "images.bin"))
    points3d = read_points3d_bin(os.path.join(path, "points3D.bin"))

    return cameras, images, points3d


def read_colmap_depth_map(path: str) -> np.ndarray:
    """Read a COLMAP dense-stereo depth map (`.bin` with `w&h&c&` text header).

    Equivalent of the reference's ``read_dense.read_array``
    (used at hive/io.py:47,507-521).
    """
    with open(path, "rb") as fh:
        header = b""
        amp_count = 0

        while amp_count < 3:
            ch = fh.read(1)
            if not ch:
                raise ValueError(f"Malformed COLMAP depth map header in {path}")
            header += ch
            if ch == b"&":
                amp_count += 1

        width, height, channels = (int(part) for part in header.decode().split("&")[:3])
        data = np.frombuffer(fh.read(), dtype=np.float32)

    # COLMAP stores the array in column-major (width, height, channels) layout;
    # equivalently, channel-major (C, H, W) row-major blocks.
    array = data.reshape((channels, height, width)).transpose(1, 2, 0)

    return np.squeeze(array)


def write_cameras_bin(path: str, cameras: Dict[int, ColmapCamera]):
    """Write cameras.bin (used by tests to create synthetic models)."""
    name_to_id = {name: model_id for model_id, (name, _) in CAMERA_MODELS.items()}

    with open(path, "wb") as fh:
        fh.write(struct.pack("<Q", len(cameras)))

        for cam in cameras.values():
            model_id = name_to_id[cam.model]
            fh.write(struct.pack("<iiQQ", cam.camera_id, model_id, cam.width, cam.height))
            fh.write(struct.pack(f"<{len(cam.params)}d", *cam.params))


def write_images_bin(path: str, images: Dict[int, ColmapImage]):
    with open(path, "wb") as fh:
        fh.write(struct.pack("<Q", len(images)))

        for img in images.values():
            fh.write(struct.pack("<i", img.image_id))
            fh.write(struct.pack("<4d", *img.qvec))
            fh.write(struct.pack("<3d", *img.tvec))
            fh.write(struct.pack("<i", img.camera_id))
            fh.write(img.name.encode("utf-8") + b"\x00")
            fh.write(struct.pack("<Q", len(img.point3d_ids)))
            for (x, y), pid in zip(img.xys, img.point3d_ids):
                fh.write(struct.pack("<ddq", x, y, pid))


def write_points3d_bin(path: str, points: Dict[int, ColmapPoint3D]):
    with open(path, "wb") as fh:
        fh.write(struct.pack("<Q", len(points)))

        for pt in points.values():
            fh.write(struct.pack("<Q", pt.point3d_id))
            fh.write(struct.pack("<3d", *pt.xyz))
            fh.write(struct.pack("<3B", *pt.rgb))
            fh.write(struct.pack("<d", pt.error))
            fh.write(struct.pack("<Q", 0))  # empty track


def write_model(path: str, cameras: dict, images: dict, points3d: dict):
    write_cameras_bin(os.path.join(path, "cameras.bin"), cameras)
    write_images_bin(os.path.join(path, "images.bin"), images)
    write_points3d_bin(os.path.join(path, "points3D.bin"), points3d)
