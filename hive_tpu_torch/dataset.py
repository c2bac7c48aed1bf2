"""CMU Panoptic (Kinoptic) dataset loader.

Counterpart of ``hive_tpu/dataset.py``: a standalone loader for
multi-Kinect CMU Panoptic captures (http://domedb.perception.cs.cmu.edu):
sync tables, calibration files, the packed raw-uint16 depth stream, and the
Kinect-local -> world transform. Not wired into the main pipeline, but
usable for multi-view experiments; ``metrics.mifd`` scores its frames on
the card.

This module is host I/O, like ``io.py``'s frame readers: colour frames are
decoded by ``io.load_image`` (the port's libjpeg-turbo ISLOW decoder, the
same pixels as ``cv2.imread`` followed by BGR -> RGB), depth frames are read
by seeking into ``depthdata.dat``, and the geometry stays float64 numpy.

Expected layout (per the dataset's getData_kinoptic.sh + hdImgsExtractor.sh):
    <base>/synctables_<name>.json, ksynctables_<name>.json
    <base>/calibration_<name>.json, kcalibration_<name>.json
    <base>/kinectImgs/50_<node>/50_<node>_<frame>.jpg
    <base>/kinect_shared_depth/KINECTNODE<node>/depthdata.dat
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Dict, Tuple

import numpy as np

from hive_tpu_torch.io import load_image


class SyncStream:
    """One stream's frame indices + universal timestamps."""

    def __init__(self, data: dict):
        self.index = np.asarray(data["index"], dtype=np.uint16)
        self.universal_time = np.asarray(data["univ_time"], dtype=np.float32)


class SyncTable:
    """The top-level VGA/HD sync table."""

    def __init__(self, path: str):
        with open(path) as fh:
            data = json.load(fh)

        self.vga = SyncStream(data["vga"])
        self.hd = SyncStream(data["hd"])


class KinectSyncTable:
    """Per-Kinect-node colour/depth sync streams."""

    def __init__(self, path: str):
        with open(path) as fh:
            data = json.load(fh)

        kinect = data["kinect"]
        self.color: Dict[str, SyncStream] = {
            name: SyncStream(node) for name, node in kinect["color"].items()}
        self.depth: Dict[str, SyncStream] = {
            name: SyncStream(node) for name, node in kinect["depth"].items()}


class KinectSensorCalibration:
    """Intrinsics/extrinsics for one Kinect's colour + depth sensors."""

    def __init__(self, data: dict):
        self.K_depth = np.asarray(data["K_depth"], dtype=np.float32)
        self.M_depth = np.asarray(data["M_depth"], dtype=np.float32)
        self.dist_coefficients_depth = np.asarray(data["distCoeffs_depth"], dtype=np.float32)
        self.depth_width = int(data["depth_width"])
        self.depth_height = int(data["depth_height"])

        self.K_color = np.asarray(data["K_color"], dtype=np.float32)
        self.M_color = np.asarray(data["M_color"], dtype=np.float32)
        self.dist_coefficients_color = np.asarray(data["distCoeffs_color"], dtype=np.float32)
        self.color_width = int(data["color_width"])
        self.color_height = int(data["color_height"])

        self.color_time_offset = int(data["color_time_offset"])
        self.depth_time_offset = int(data["depth_time_offset"])
        self.M_world2sensor = np.asarray(data["M_world2sensor"])
        self.dome_center = np.asarray(data["domeCenter"], dtype=np.float32)


class KinectCalibration:
    """All Kinect sensors' calibration (1-indexed by node)."""

    def __init__(self, data: dict):
        self.calib_data_source = data["calibDataSource"]
        self.panoptic_calib_data_source = data["panopticCalibDataSource"]
        self.sensors = {i + 1: KinectSensorCalibration(sensor)
                        for i, sensor in enumerate(data["sensors"])}
        self.M_world2vga = data["M_world2vga"]

    def __getitem__(self, kinect_node: int) -> KinectSensorCalibration:
        return self.sensors[kinect_node]


class PanopticCamera:
    """One camera entry of the dome calibration."""

    def __init__(self, data: dict):
        self.name = str(data["name"])
        self.type = str(data["type"])
        # Stored as (width, height); we keep (height, width).
        self.resolution = (int(data["resolution"][1]), int(data["resolution"][0]))
        self.panel = int(data["panel"])
        self.node = int(data["node"])
        self.K = np.asarray(data["K"], dtype=np.float32)
        self.dist_coefficient = np.asarray(data["distCoef"], dtype=np.float32)
        self.R = np.asarray(data["R"], dtype=np.float32)
        self.t = np.asarray(data["t"], dtype=np.float32)


class PanopticCalibration:
    def __init__(self, data: dict):
        self.calib_data_source = data["calibDataSource"]
        self.cameras = {cam["name"]: PanopticCamera(cam) for cam in data["cameras"]}

    def __getitem__(self, node_name: str) -> PanopticCamera:
        return self.cameras[node_name]


class CMUPanopticDataset:
    """Loader for CMU Panoptic captures with Kinect (Kinoptic) sensor data."""

    depth_parent_folder = "kinect_shared_depth"
    depth_filename = "depthdata.dat"
    depth_to_meters = 1.0 / 1000.0
    depth_frame_width = 512
    depth_frame_height = 424
    depth_dtype = np.uint16

    image_folder = "kinectImgs"

    # Kinect colour/depth hardware timing bounds (ms) used for sync validation.
    MAX_DEPTH_COLOR_GAP_MS = 6.25
    MAX_COLOR_DISTANCE_MS = 30.0
    MAX_DEPTH_DISTANCE_MS = 17.0

    def __init__(self, base_path: str):
        self.base_path = base_path
        self.dataset_name = Path(base_path).name

        self.sync_table = SyncTable(self._path(f"synctables_{self.dataset_name}.json"))
        self.kinect_sync_table = KinectSyncTable(
            self._path(f"ksynctables_{self.dataset_name}.json"))

        with open(self._path(f"calibration_{self.dataset_name}.json")) as fh:
            self.camera_calibration = PanopticCalibration(json.load(fh))

        with open(self._path(f"kcalibration_{self.dataset_name}.json")) as fh:
            self.kinect_calibration = KinectCalibration(json.load(fh))

    def _path(self, *parts) -> str:
        return os.path.join(self.base_path, *parts)

    @staticmethod
    def depth_node_name(kinect_node: int) -> str:
        return f"KINECTNODE{kinect_node}"

    @staticmethod
    def image_node_name(kinect_node: int) -> str:
        return f"50_{kinect_node:02d}"

    @staticmethod
    def _check_node(kinect_node: int):
        if not 1 <= kinect_node <= 10:
            raise ValueError("CMU Panoptic Kinect nodes are numbered 1-10.")

    # -- images ---------------------------------------------------------------
    def get_image_path(self, kinect_node: int, index: int) -> str:
        self._check_node(kinect_node)
        return self._path(self.image_folder, self.image_node_name(kinect_node),
                          f"50_{kinect_node:02d}_{index:08d}.jpg")

    def get_image(self, kinect_node: int, index: int) -> np.ndarray:
        """RGB frame (H, W, 3) uint8 for a Kinect node (a grey JPEG is
        repeated over three channels, as ``cv2.imread`` returns it)."""
        image = load_image(self.get_image_path(kinect_node, index))
        if image.ndim == 2:
            image = np.repeat(image[..., None], 3, axis=-1)
        return image

    # -- depth ----------------------------------------------------------------
    def get_depth_path(self, kinect_node: int) -> str:
        self._check_node(kinect_node)
        return self._path(self.depth_parent_folder, self.depth_node_name(kinect_node),
                          self.depth_filename)

    def get_depth_map(self, kinect_node: int, index: int) -> np.ndarray:
        """Depth map (H, W) in metres, float64 (uint16 millimetres times a
        Python float), read by seeking into the packed raw stream (frames
        are contiguous uint16 little-endian)."""
        bytes_per_frame = 2 * self.depth_frame_height * self.depth_frame_width

        with open(self.get_depth_path(kinect_node), "rb") as fh:
            fh.seek(index * bytes_per_frame)
            raw = fh.read(bytes_per_frame)

        depth = np.frombuffer(raw, dtype=self.depth_dtype).reshape(
            (self.depth_frame_height, self.depth_frame_width))

        # The stream stores mirrored rows; flip horizontally to match RGB.
        depth = depth[:, ::-1].copy()

        return depth * self.depth_to_meters

    # -- synchronisation ------------------------------------------------------
    def get_synced_frame_data(self, frame_index: int,
                              kinect_node: int) -> Tuple[np.ndarray, np.ndarray]:
        """The (colour frame, depth map) pair for an HD frame index, validated
        against the Kinect hardware timing tolerances."""
        universal_time = self.sync_table.hd.universal_time[frame_index]
        node_name = self.depth_node_name(kinect_node)

        color_sync = self.kinect_sync_table.color[node_name]
        color_index = int(np.argmin(np.abs(
            universal_time - color_sync.universal_time - self.MAX_DEPTH_COLOR_GAP_MS)))
        color_distance = abs(universal_time - color_sync.universal_time[color_index])

        depth_sync = self.kinect_sync_table.depth[node_name]
        depth_index = int(np.argmin(np.abs(universal_time - depth_sync.universal_time)))
        depth_distance = abs(universal_time - depth_sync.universal_time[depth_index])

        depth_color_gap = abs(depth_sync.universal_time[depth_index]
                              - color_sync.universal_time[color_index])

        if depth_color_gap > self.MAX_DEPTH_COLOR_GAP_MS:
            raise RuntimeError(f"Frame {frame_index:,d}: depth/colour timestamps differ "
                               f"by {depth_color_gap:,.2f}.")

        if color_distance > self.MAX_COLOR_DISTANCE_MS \
                or depth_distance > self.MAX_DEPTH_DISTANCE_MS:
            raise RuntimeError(f"Frame {frame_index:,d}: the synced Kinect streams are "
                               f"too far apart in time.")

        # Fetch the frames the sync search selected: the Kinect streams
        # drift from the HD index whenever frames drop. The JPEG filename
        # carries the colour stream's own frame number (its sync `index`
        # value), while depthdata.dat stores received frames contiguously,
        # so the depth seek position is the ROW in the depth sync stream.
        color_frame_number = int(color_sync.index[color_index])

        return (self.get_image(kinect_node=kinect_node, index=color_frame_number),
                self.get_depth_map(kinect_node=kinect_node, index=depth_index))

    # -- geometry -------------------------------------------------------------
    def kinect_to_world_coordinates(self, kinect_node: int) -> np.ndarray:
        """The 4x4 transform taking Kinect-local 3D points to dome world space
        (colour-sensor extrinsics + the cm->m dome scale convention), float64
        host numpy."""
        panoptic = self.camera_calibration[self.image_node_name(kinect_node)]
        kinect = self.kinect_calibration[kinect_node]

        world_to_color = np.eye(4, dtype=np.float32)
        world_to_color[:3, :3] = panoptic.R
        world_to_color[:3, 3] = panoptic.t.reshape(3)
        color_to_world = np.linalg.inv(world_to_color)

        # The dome calibration is in centimetres for x/y.
        scale = np.eye(4)
        scale[0, 0] = scale[1, 1] = 100.0

        local_to_color = np.linalg.inv(kinect.M_color)

        return color_to_world @ scale @ local_to_color
