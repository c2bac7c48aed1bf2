"""HyperNeRF dataset loader (dataset.json / scene.json / camera jsons).

Counterpart of ``hive_tpu/data/hypernerf.py``: the Nerfies/HyperNeRF
capture format, per-frame camera JSONs with orientation, position and focal
data plus a train/val split, for reconstruct-then-render evaluation. Images
are read with the port's own PNG decoder (Pillow's pixels).
"""

from __future__ import annotations

import json
import os
from os.path import join as pjoin
from typing import Dict, List, Optional, Tuple

import numpy as np

from hive_tpu_torch.geometric import Trajectory
from hive_tpu_torch.io import load_image


class HyperNeRFCamera:
    """One Nerfies/HyperNeRF camera (camera/<id>.json)."""

    def __init__(self, data: dict):
        # Orientation is world-to-camera; position is the camera origin in world.
        self.orientation = np.asarray(data["orientation"], dtype=np.float64)
        self.position = np.asarray(data["position"], dtype=np.float64)
        self.focal_length = float(data["focal_length"])
        self.principal_point = np.asarray(data["principal_point"], dtype=np.float64)
        self.image_size = tuple(int(v) for v in data["image_size"])  # (width, height)
        self.skew = float(data.get("skew", 0.0))
        self.pixel_aspect_ratio = float(data.get("pixel_aspect_ratio", 1.0))
        self.radial_distortion = np.asarray(data.get("radial_distortion", [0, 0, 0]),
                                            dtype=np.float64)

    @property
    def camera_matrix(self) -> np.ndarray:
        fx = self.focal_length
        fy = self.focal_length * self.pixel_aspect_ratio
        cx, cy = self.principal_point
        return np.array([[fx, self.skew, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]])

    @property
    def world_to_camera(self) -> np.ndarray:
        M = np.eye(4)
        M[:3, :3] = self.orientation
        M[:3, 3] = -self.orientation @ self.position
        return M


class HyperNeRFDataset:
    """Loader for a HyperNeRF capture folder."""

    def __init__(self, base_path: str, image_scale: int = 2):
        """
        :param base_path: Folder with dataset.json, scene.json, camera/, rgb/.
        :param image_scale: Which rgb/<scale>x image pyramid level to use.
        """
        self.base_path = base_path
        self.image_scale = image_scale

        with open(pjoin(base_path, "dataset.json")) as fh:
            dataset_info = json.load(fh)

        self.all_ids: List[str] = dataset_info["ids"]
        self.train_ids: List[str] = dataset_info.get("train_ids", self.all_ids)
        self.val_ids: List[str] = dataset_info.get("val_ids", [])

        with open(pjoin(base_path, "scene.json")) as fh:
            scene_info = json.load(fh)

        self.scene_center = np.asarray(scene_info.get("center", [0, 0, 0]))
        self.scene_scale = float(scene_info.get("scale", 1.0))
        self.near = float(scene_info.get("near", 0.01))
        self.far = float(scene_info.get("far", 10.0))

        self.metadata: Dict[str, dict] = {}
        metadata_path = pjoin(base_path, "metadata.json")
        if os.path.isfile(metadata_path):
            with open(metadata_path) as fh:
                self.metadata = json.load(fh)

        self.cameras = {item_id: self._load_camera(item_id) for item_id in self.all_ids}

    def _load_camera(self, item_id: str) -> HyperNeRFCamera:
        with open(pjoin(self.base_path, "camera", f"{item_id}.json")) as fh:
            camera = HyperNeRFCamera(json.load(fh))

        if self.image_scale != 1:
            scale = 1.0 / self.image_scale
            camera.focal_length *= scale
            camera.principal_point = camera.principal_point * scale
            camera.image_size = (int(camera.image_size[0] * scale),
                                 int(camera.image_size[1] * scale))

        return camera

    @property
    def num_frames(self) -> int:
        return len(self.all_ids)

    def get_image_path(self, item_id: str) -> str:
        return pjoin(self.base_path, "rgb", f"{self.image_scale}x", f"{item_id}.png")

    def get_image(self, item_id: str) -> np.ndarray:
        return load_image(self.get_image_path(item_id))

    def get_trajectory(self, ids: Optional[List[str]] = None) -> Trajectory:
        """World-to-camera trajectory over the given (or all) frame ids."""
        ids = ids if ids is not None else self.all_ids
        matrices = np.stack([self.cameras[i].world_to_camera for i in ids])
        return Trajectory.from_homogenous_transforms(matrices)

    def train_val_split(self) -> Tuple[List[str], List[str]]:
        return list(self.train_ids), list(self.val_ids)
