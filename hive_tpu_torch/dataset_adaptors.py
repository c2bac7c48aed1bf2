"""Dataset adaptors: convert TUM and Unreal RGB-D inputs into the HIVE
dataset format.

Counterpart of ``hive_tpu/dataset_adaptors.py``: ``create_folder`` (:44),
``DatasetAdaptor`` (:50-230) with ``convert``, the cache check and the
folder set-up, ``TUMAdaptor`` (:467-581), ``UnrealAdaptor`` (:584-643) and
``get_dataset`` (:1054-1097), with the same sniffing order, ``profiling``
keys and output files. RGB frames are written as quality-75 4:2:0 JPEGs and
depth as 16-bit PNGs through :mod:`hive_tpu_torch.image_codecs`, where the
JAX package writes them through imageio and Pillow: the JPEG bytes are
Pillow's. The instance masks come from the person segmenter on the card
(Mask R-CNN or the U-Net with weights in ``$WEIGHTS_PATH``, else motion);
with ``--estimate_depth`` the depth maps come from DPT-Hybrid on the card
(``estimate_depth_dpt``, counterpart of :1018-1051). With
``--inpainting_mode`` the frames are inpainted behind the dilated masks
(``DatasetAdaptor._inpaint_frame_data``, counterpart of :392-464): TELEA on
the host, LaMa on the card; those frames are written as the reference's
``cv2.imwrite`` writes them (JPEG at quality 95, PNG). With
``--estimate_pose`` a COLMAP binary estimates the intrinsics and trajectory
on the frames (``_estimate_camera_parameters``, counterpart of :237-296),
scaled to metres by the median ratio of the depth maps to COLMAP's
(``_get_scaled_colmap_camera_params``, :331-390); without a COLMAP binary,
by PnP odometry on the card (``_estimate_camera_parameters_native``,
counterpart of :296-329, through :mod:`hive_tpu_torch.sfm`).

Not ported yet, refused with their ROADMAP item: StrayScanner and plain
video inputs (Queue 1 item 9b).
"""

from __future__ import annotations

import logging
import os
import shutil
from abc import ABC
from os.path import join as pjoin
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from hive_tpu_torch.custom_types import File
from hive_tpu_torch.geometric import Trajectory
from hive_tpu_torch.image_codecs import CV2_JPEG_QUALITY, write_image
from hive_tpu_torch.image_processing import TELEA_RADIUS, dilate_ids, inpaint_telea
from hive_tpu_torch.io import (COLMAPProcessor, Dataset, DatasetMetadata, HiveDataset,
                               ImageFolderDataset, InvalidDatasetFormatError, create_masks,
                               load_image, make_depth_map_transform)
from hive_tpu_torch.models.dpt import DPTDepthEstimator
from hive_tpu_torch.models.lama import lama_inpaint_folder
from hive_tpu_torch.options import (BackgroundMeshOptions, COLMAPOptions, InpaintingMode,
                                    PipelineOptions, StorageOptions)
from hive_tpu_torch.ops.resize import keep_aspect_multiple_of
from hive_tpu_torch.sensor import KinectSensor
from hive_tpu_torch.utils import not_ported, timed_block, tqdm_imap


def create_folder(*args, exist_ok: bool = False) -> str:
    path = pjoin(*args)
    os.makedirs(path, exist_ok=exist_ok)
    return str(path)


class DatasetAdaptor(Dataset, ABC):
    """Converts an input dataset into the HIVE format (rgb/depth/mask folders,
    camera files, metadata) — the dataset-creation pipeline."""

    def __init__(self, base_path: File, output_path: File, num_frames: int = -1,
                 frame_step: int = 1, colmap_options: COLMAPOptions = COLMAPOptions()):
        super().__init__(base_path=base_path)

        # realpath comparison: a trailing slash, './' prefix, or symlink
        # spelling of the same directory must not slip past this guard —
        # convert(no_cache=True) rmtree's output_path, which would DELETE
        # the user's input dataset.
        if os.path.realpath(str(output_path)) == os.path.realpath(str(base_path)):
            raise RuntimeError(
                "A dataset adaptor must write to a different folder than it reads from.")

        self.output_path = output_path
        self.num_frames = num_frames
        self.frame_step = frame_step
        self.colmap_options = colmap_options

    # -- per-format API -------------------------------------------------------
    def get_full_num_frames(self) -> int:
        """Number of frames in the non-truncated dataset."""
        raise NotImplementedError

    def get_metadata(self, estimate_pose: bool, estimate_depth: bool) -> DatasetMetadata:
        raise NotImplementedError

    def get_camera_matrix(self) -> np.ndarray:
        """Ground-truth (3, 3) intrinsics, if the format provides them."""
        raise NotImplementedError

    def get_pose(self, index: int) -> np.ndarray:
        """Ground-truth pose 7-vector for a frame, if the format provides it."""
        raise NotImplementedError

    def get_camera_trajectory(self) -> Trajectory:
        return Trajectory(np.vstack([self.get_pose(i) for i in range(self.num_frames)]))

    def get_frame(self, index: int) -> np.ndarray:
        """The RGB frame at ``index``."""
        raise NotImplementedError

    def get_depth_map(self, index: int) -> np.ndarray:
        """Ground-truth uint16 millimetre depth at ``index``, if provided."""
        raise NotImplementedError

    def _resolve_num_frames(self, num_frames: int):
        """Clamp the requested frame count to what the dataset actually has."""
        full = self.get_full_num_frames()
        self.num_frames = full if num_frames == -1 else min(num_frames, full)

    # -- bulk copies ----------------------------------------------------------
    def copy_frames(self, output_path: str, num_frames: int = -1, file_extension: str = "png"):
        num_frames = self.num_frames if num_frames == -1 else num_frames

        def copy_image(index: int):
            write_image(pjoin(output_path, HiveDataset.index_to_filename(index, file_extension)),
                        self.get_frame(index))

        tqdm_imap(copy_image, range(num_frames))

    def copy_depth_maps(self, output_path: str):
        def copy_image(index: int):
            write_image(pjoin(output_path, HiveDataset.index_to_filename(index)),
                        self.get_depth_map(index))

        tqdm_imap(copy_image, range(self.num_frames))

    # -- conversion pipeline --------------------------------------------------
    def convert(self, estimate_pose: bool, estimate_depth: bool,
                inpainting_mode: InpaintingMode, static_camera: bool = False,
                no_cache: bool = False, profiling: Optional[dict] = None,
                device=None) -> HiveDataset:
        """Create the HIVE dataset: metadata → frames → masks → depth →
        camera parameters → optional inpainting.

        :param device: where the instance masks, estimated depth maps and
            LaMa's inpainting are computed; default ``cuda:0``.
        """
        if no_cache and os.path.exists(self.output_path):
            logging.warning(f"`no_cache` requested — deleting the cached conversion at "
                            f"{self.output_path}.")
            shutil.rmtree(self.output_path)
        elif cached := self._try_get_cached_dataset(estimate_pose, estimate_depth):
            logging.info(f"Reusing the cached converted dataset at {self.output_path}.")
            return cached

        logging.info(f"Converting {self.base_path} -> {self.output_path} (HIVE format).")

        image_folder, depth_folder, mask_folder = self._setup_folders(exist_ok=not no_cache)

        with timed_block("Writing dataset metadata.", profiling,
                         ["timing", "load_dataset", "create_metadata"]):
            metadata = self.get_metadata(estimate_pose, estimate_depth)
            metadata.save(pjoin(str(self.output_path), HiveDataset.metadata_filename))

        with timed_block("Copying RGB frames.", profiling,
                         ["timing", "load_dataset", "copy_frames"]):
            self.copy_frames(image_folder, file_extension="jpg")

        with timed_block(None, profiling,
                         ["timing", "load_dataset", "create_instance_segmentation_masks"]):
            create_masks(ImageFolderDataset(image_folder), mask_folder=mask_folder,
                         device=device)

        with timed_block(None, profiling, ["timing", "load_dataset", "get_depth_maps"]):
            if estimate_depth:
                logging.info("Estimating depth maps.")
                estimate_depth_dpt(ImageFolderDataset(image_folder), depth_folder, device=device)
            else:
                logging.info("Copying depth maps.")
                self.copy_depth_maps(depth_folder)

        with timed_block(None, profiling, ["timing", "load_dataset", "get_camera_parameters"]):
            if static_camera:
                # The DPT depth model was trained on Kinect data, so the Kinect
                # intrinsics are the sensible static-camera default.
                camera = KinectSensor.get_camera_matrix()

                if metadata.height > metadata.width:
                    camera = camera.transpose()

                camera_matrix = camera.scale((metadata.height, metadata.width)).matrix
                camera_trajectory = Trajectory(
                    np.tile([0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0], (metadata.num_frames, 1)))
            elif estimate_pose:
                debug_folder = pjoin(str(self.output_path), "debug")
                camera_matrix, camera_trajectory = self._estimate_camera_parameters(
                    debug_folder, depth_folder, metadata, device=device)
            else:
                camera_matrix = self.get_camera_matrix()
                camera_trajectory = self.get_camera_trajectory()

            np.savetxt(pjoin(str(self.output_path), HiveDataset.camera_matrix_filename),
                       camera_matrix)
            camera_trajectory.save(
                pjoin(str(self.output_path), HiveDataset.camera_trajectory_filename))

        with timed_block(None, profiling, ["timing", "load_dataset", "inpainting"]):
            self._inpaint_frame_data(inpainting_mode, device=device)

        logging.info(f"Converted dataset ready at {self.output_path}.")
        return HiveDataset(self.output_path)

    def _try_get_cached_dataset(self, estimate_pose: bool,
                                estimate_depth: bool) -> Optional[HiveDataset]:
        """Reuse a previous conversion iff folder structure, frame counts and
        metadata all match."""
        if not HiveDataset.is_valid_folder_structure(self.output_path):
            return None

        dataset = HiveDataset(self.output_path)

        num_frames = len(os.listdir(dataset.path_to_rgb_frames))
        num_depth_maps = len(os.listdir(dataset.path_to_depth_maps))
        same_num_frames = self.num_frames in (num_frames, num_depth_maps)
        same_trajectory_length = len(dataset.camera_trajectory) == self.num_frames
        same_metadata = dataset.metadata == self.get_metadata(estimate_pose, estimate_depth)

        if same_num_frames and same_trajectory_length and same_metadata:
            return dataset

        return None

    @staticmethod
    def _get_frame_subset(num_frames: int, frame_step: int):
        """All frame indices + the frame_step subsample (always keeping the
        last frame so interpolation has both endpoints)."""
        frames = list(range(num_frames))
        subset = frames[::frame_step]

        if subset[-1] != frames[-1]:
            subset.append(frames[-1])

        return frames, subset

    # -- pose estimation ------------------------------------------------------
    def _estimate_camera_parameters(self, output_folder: str, output_depth_folder: str,
                                    metadata: DatasetMetadata,
                                    device=None) -> Tuple[np.ndarray, Trajectory]:
        """Estimate intrinsics + trajectory with COLMAP on a frame subset,
        then scale to metres and re-densify.

        Falls back to PnP odometry against the depth maps
        (:mod:`hive_tpu_torch.sfm`) when the COLMAP binary is unavailable,
        as ``hive_tpu`` does.

        :param device: where COLMAP's exclusion masks are segmented, or the
            odometry runs; default ``cuda:0``.
        """
        if not os.path.isfile(self.colmap_options.binary_path):
            logging.warning(f"COLMAP binary not found at "
                            f"{self.colmap_options.binary_path}; using the native "
                            f"PnP-odometry pose estimator instead.")
            return self._estimate_camera_parameters_native(output_depth_folder, metadata,
                                                           device=device)

        if os.path.exists(output_folder):
            shutil.rmtree(output_folder)

        colmap_folder = create_folder(output_folder, "colmap")
        colmap_rgb_path = create_folder(colmap_folder, "rgb")
        colmap_workspace_path = create_folder(colmap_folder, "workspace")

        frames, frames_subset = self._get_frame_subset(self.num_frames, self.frame_step)

        logging.info("Staging RGB frames for the COLMAP run...")
        self.copy_frames(colmap_rgb_path, self.num_frames, file_extension="jpg")

        if self.frame_step > 1:
            # Keep only the subset, renumbered densely for COLMAP.
            for index in set(frames).difference(frames_subset):
                os.remove(pjoin(colmap_rgb_path,
                                HiveDataset.index_to_filename(index, "jpg")))

            for dst_index, src_index in enumerate(frames_subset):
                shutil.move(
                    pjoin(colmap_rgb_path,
                          HiveDataset.index_to_filename(src_index, "jpg")),
                    pjoin(colmap_rgb_path,
                          HiveDataset.index_to_filename(dst_index, "jpg")))

        logging.info("Starting the COLMAP reconstruction (this can take a long time)...")
        processor = COLMAPProcessor(image_path=colmap_rgb_path,
                                    workspace_path=colmap_workspace_path,
                                    colmap_options=self.colmap_options)
        processor.run(device=device)

        camera_matrix, camera_poses_scaled = self._get_scaled_colmap_camera_params(
            processor, output_depth_folder, metadata, frames_subset)

        if self.frame_step > 1:
            pose_mapping = {frame_index: pose for frame_index, pose
                            in zip(frames_subset, camera_poses_scaled)}
            camera_poses_scaled = Trajectory.create_by_interpolating(
                pose_mapping, frame_count=self.num_frames)

        camera_poses_scaled = Trajectory(camera_poses_scaled[:self.num_frames])
        return camera_matrix, camera_poses_scaled.normalise()

    def _estimate_camera_parameters_native(self, output_depth_folder: str,
                                           metadata: DatasetMetadata,
                                           device=None) -> Tuple[np.ndarray, Trajectory]:
        """Pose estimation without external binaries: PnP odometry against
        the (estimated) depth maps, on ``device``. Intrinsics use the Kinect
        prior scaled to the frame size, the static-camera path's prior."""
        from hive_tpu_torch.sfm import estimate_camera_poses_native

        camera = KinectSensor.get_camera_matrix()

        if metadata.height > metadata.width:
            camera = camera.transpose()

        camera_matrix = camera.scale((metadata.height, metadata.width)).matrix

        rgb_folder = pjoin(str(self.output_path), HiveDataset.rgb_folder)
        mask_folder = pjoin(str(self.output_path), HiveDataset.mask_folder)

        rgb_dataset = ImageFolderDataset(rgb_folder)
        mask_dataset = ImageFolderDataset(mask_folder)

        depth_transform = make_depth_map_transform(
            HiveDataset.depth_scaling_factor, metadata.max_depth)
        depth_dataset = ImageFolderDataset(output_depth_folder, transform=depth_transform)

        n = min(self.num_frames, len(rgb_dataset), len(depth_dataset))

        rgb_frames = tqdm_imap(rgb_dataset.__getitem__, range(n), show_progress=False)
        depth_maps = tqdm_imap(depth_dataset.__getitem__, range(n), show_progress=False)
        masks = tqdm_imap(mask_dataset.__getitem__, range(n), show_progress=False)

        trajectory = estimate_camera_poses_native(
            rgb_frames, depth_maps, camera_matrix, masks=masks,
            frame_step=self.frame_step, device=device)

        return camera_matrix, trajectory.normalise()

    def _get_scaled_colmap_camera_params(self, processor: COLMAPProcessor,
                                         output_depth_folder: str,
                                         metadata: DatasetMetadata,
                                         frames_subset: List[int]) -> Tuple[np.ndarray, Trajectory]:
        """Scale COLMAP's arbitrary-unit poses to metric using the median
        ratio of the dataset's depth to COLMAP's."""
        logging.info("Scaling COLMAP poses to metric depth...")
        camera_matrix, camera_poses = processor.load_camera_params()

        if processor.colmap_options.dense:
            colmap_depth = processor.get_dense_depth_maps(
                resize_to=(metadata.height, metadata.width))
        else:
            colmap_depth = processor.get_sparse_depth_maps(camera_matrix, camera_poses)

        transform = make_depth_map_transform(HiveDataset.depth_scaling_factor,
                                             metadata.max_depth)
        depth_dataset = ImageFolderDataset(output_depth_folder, transform=transform)
        subset = [i for i in frames_subset if i < len(depth_dataset)]
        est_depth = np.asarray(tqdm_imap(depth_dataset.__getitem__, subset))
        if len(colmap_depth) != len(est_depth):
            # Misaligned frames would scale every pose wrongly.
            raise ValueError(
                f"COLMAP produced {len(colmap_depth)} dense depth maps but "
                f"{len(est_depth)} frames were estimated — cannot pair "
                f"frames for metric pose scaling")

        nonzero = (colmap_depth > 0.0) & (est_depth > 0.0)

        if not nonzero.any():
            logging.warning("No pixel has both COLMAP and estimated depth — "
                            "cannot recover metric scale; keeping COLMAP's "
                            "arbitrary scale (factor 1.0).")
            scaling_factor = 1.0
        else:
            scaling_factor = float(
                np.median(est_depth[nonzero] / colmap_depth[nonzero]))
        logging.info(f"Depth scale: {scaling_factor:.4f}")

        scaled = camera_poses.copy()
        scaled.values[:, 4:] *= scaling_factor

        if processor.colmap_options.dense:
            colmap_depth_output = create_folder(Path(output_depth_folder).parent,
                                                "colmap_depth", exist_ok=True)

            def save_depth(args):
                index, depth_map = args
                write_image(pjoin(colmap_depth_output, HiveDataset.index_to_filename(index)),
                            (1000 * scaling_factor * depth_map).astype(np.uint16))

            tqdm_imap(save_depth, list(zip(subset, colmap_depth)))

        return camera_matrix, scaled

    def _inpaint_frame_data(self, mode: InpaintingMode, device=None):
        """Inpaint RGB frames and depth maps behind the dilated instance
        masks, into the ``*_inpainted`` folders, as ``hive_tpu`` does: the
        masks dilated (21 x 21 window) into ``mask_inpainted/``, RGB by
        TELEA or LaMa, depth by TELEA or LaMa's depth branch (TELEA on the
        ``/ 256`` image), then the masks there blacked out: inpainted data
        holds no dynamic object."""
        if mode == InpaintingMode.Off:
            return

        logging.info("Inpainting masked frame regions.")

        rgb_path = pjoin(str(self.output_path), HiveDataset.rgb_folder)
        depth_path = pjoin(str(self.output_path), HiveDataset.depth_folder)
        mask_path = pjoin(str(self.output_path), HiveDataset.mask_folder)

        rgb_filenames = sorted(os.listdir(rgb_path))
        depth_filenames = sorted(os.listdir(depth_path))
        mask_filenames = sorted(os.listdir(mask_path))

        inpainted_rgb_path = create_folder(self.output_path, HiveDataset.inpainted_rgb_folder,
                                           exist_ok=True)
        inpainted_depth_path = create_folder(self.output_path,
                                             HiveDataset.inpainted_depth_folder, exist_ok=True)
        inpainted_mask_path = create_folder(self.output_path,
                                            HiveDataset.inpainted_mask_folder, exist_ok=True)

        def create_mask(mask_filename):
            mask = load_image(pjoin(mask_path, mask_filename))
            write_image(pjoin(inpainted_mask_path, mask_filename), dilate_ids(mask))

        def inpaint_with_telea(input_path, output_path, image_filename):
            mask = load_image(pjoin(inpainted_mask_path, f"{Path(image_filename).stem}.png"))
            image = load_image(pjoin(input_path, image_filename))
            write_image(pjoin(output_path, image_filename),
                        inpaint_telea(image, mask, TELEA_RADIUS), CV2_JPEG_QUALITY)

        logging.info("Creating inpainting masks (dilated object masks)...")
        tqdm_imap(create_mask, mask_filenames)

        if InpaintingMode.CV2_Image in mode:
            logging.info("Inpainting RGB frames with TELEA...")
            tqdm_imap(lambda f: inpaint_with_telea(rgb_path, inpainted_rgb_path, f),
                      rgb_filenames)
        elif InpaintingMode.Lama_Image in mode:
            logging.info("Inpainting RGB frames with LaMa...")
            lama_inpaint_folder(image_dir=rgb_path, mask_dir=inpainted_mask_path,
                                output_dir=inpainted_rgb_path, device=device)
        else:
            raise RuntimeError(f"Inpainting mode {mode} names no image inpainter "
                               f"(and is not {InpaintingMode.Off}).")

        if InpaintingMode.CV2_Depth in mode:
            logging.info("Inpainting depth maps with TELEA...")
            tqdm_imap(lambda f: inpaint_with_telea(depth_path, inpainted_depth_path, f),
                      depth_filenames)
        elif InpaintingMode.Lama_Depth in mode:
            logging.info("Inpainting depth maps with LaMa...")
            lama_inpaint_folder(image_dir=depth_path, mask_dir=inpainted_mask_path,
                                output_dir=inpainted_depth_path, depth=True, device=device)
        else:
            raise RuntimeError(f"Inpainting mode should be {InpaintingMode.Off} or name a "
                               f"depth-inpainting backend.")

        def write_black_mask(filename):
            mask = load_image(pjoin(inpainted_mask_path, filename))
            write_image(pjoin(inpainted_mask_path, filename), np.zeros(mask.shape, np.uint8))

        tqdm_imap(write_black_mask, mask_filenames)

    def _setup_folders(self, exist_ok: bool = False) -> Tuple[str, str, str]:
        if not exist_ok and os.path.isdir(self.output_path):
            raise RuntimeError(f"Output path {self.output_path} exists already — "
                               f"pick another output path or pass `--no_cache` to replace it.")

        os.makedirs(self.output_path, exist_ok=exist_ok)

        return (create_folder(self.output_path, HiveDataset.rgb_folder, exist_ok=exist_ok),
                create_folder(self.output_path, HiveDataset.depth_folder, exist_ok=exist_ok),
                create_folder(self.output_path, HiveDataset.mask_folder, exist_ok=exist_ok))


class TUMAdaptor(DatasetAdaptor):
    """Ingests TUM RGB-D sequences (timestamped rgb/depth/groundtruth lists).

    Format docs: https://cvg.cit.tum.de/data/datasets/rgbd-dataset/file_formats
    """

    fx, fy = 580.0, 580.0
    cx, cy = 319.5, 239.5
    width, height = 640, 480
    fps = 30.0

    intrinsic_matrix = np.array([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]])

    pose_path = "groundtruth.txt"
    rgb_files_path = "rgb.txt"
    depth_map_files_path = "depth.txt"

    required_files = [pose_path, rgb_files_path, depth_map_files_path]
    required_folders = ["rgb", "depth"]

    def __init__(self, base_path: File, output_path: File, num_frames: int = -1,
                 frame_step: int = 1, colmap_options: COLMAPOptions = COLMAPOptions(),
                 is_16_bit: bool = True):
        super().__init__(base_path=base_path, output_path=output_path, num_frames=num_frames,
                         frame_step=frame_step, colmap_options=colmap_options)

        self.is_16_bit = is_16_bit
        # 16-bit PNGs store depth in units of 1/5000 m; 32-bit floats are meters.
        self.depth_scale_factor = 1.0 / 5000.0 if is_16_bit else 1.0

        (self.image_filenames, self.depth_filenames,
         self.camera_trajectory) = self._get_synced_frame_data()

        self._resolve_num_frames(num_frames)

        # TUM poses are cam-to-world; the pipeline wants world-to-cam, with the
        # scene upright (the dataset's convention leaves it rotated 90° about
        # x).
        self.camera_trajectory = self.camera_trajectory.normalise_position().inverse()

        rotation = np.eye(4)
        rotation[1, 1] = 0.0
        rotation[1, 2] = 1.0
        rotation[2, 1] = -1.0
        rotation[2, 2] = 0.0  # -90° about x
        self.camera_trajectory = self.camera_trajectory.apply(rotation)

    def _get_synced_frame_data(self):
        """Associate RGB frames, depth maps and poses by nearest timestamp.

        The Kinect's three streams are unsynchronised; depth timestamps anchor
        the association.
        """

        def load_list(path):
            timestamps, payloads = [], []

            with open(pjoin(str(self.base_path), path)) as fh:
                for line in fh:
                    line = line.strip()

                    if not line or line.startswith("#"):
                        continue

                    parts = line.split(" ")
                    timestamps.append(float(parts[0]))
                    payloads.append(parts[1:])

            return np.asarray(timestamps), payloads

        image_ts, image_rows = load_list(self.rgb_files_path)
        depth_ts, depth_rows = load_list(self.depth_map_files_path)
        pose_ts, pose_rows = load_list(self.pose_path)

        def nearest(query_ts, anchor_ts):
            deltas = np.abs(query_ts.reshape(-1, 1) - anchor_ts.reshape(1, -1))
            return deltas.argmin(axis=0)

        image_indices = nearest(image_ts, depth_ts)
        image_filenames = [Path(image_rows[i][0]).name for i in image_indices]
        depth_filenames = [Path(row[0]).name for row in depth_rows]

        pose_indices = nearest(pose_ts, depth_ts)
        poses = []
        for i in pose_indices:
            tx, ty, tz, qx, qy, qz, qw = map(float, pose_rows[i])
            poses.append((qx, qy, qz, qw, tx, ty, tz))

        return image_filenames, depth_filenames, Trajectory(np.asarray(poses))

    def get_full_num_frames(self) -> int:
        return len(self.image_filenames)

    def get_metadata(self, estimate_pose: bool, estimate_depth: bool) -> DatasetMetadata:
        return DatasetMetadata(
            num_frames=self.num_frames, frame_step=self.frame_step, fps=self.fps,
            width=self.width, height=self.height,
            estimate_pose=estimate_pose, estimate_depth=estimate_depth,
            depth_mask_dilation_iterations=BackgroundMeshOptions().depth_mask_dilation_iterations,
            depth_scale=HiveDataset.depth_scaling_factor, colmap_options=self.colmap_options)

    def get_camera_matrix(self) -> np.ndarray:
        return self.intrinsic_matrix

    def get_pose(self, index: int) -> np.ndarray:
        return self.camera_trajectory[index]

    def get_frame(self, index: int) -> np.ndarray:
        return load_image(pjoin(str(self.base_path), "rgb", self.image_filenames[index]))

    def get_depth_map(self, index: int) -> np.ndarray:
        depth = load_image(pjoin(str(self.base_path), "depth", self.depth_filenames[index]))
        meters = depth * self.depth_scale_factor
        return (1000 * meters).astype(np.uint16)


class UnrealAdaptor(DatasetAdaptor):
    """Ingests synthetic captures from Unreal Engine / UnrealCV."""

    metadata_filename = "info.json"
    camera_matrix_filename = "camera.txt"
    camera_trajectory_filename = "trajectory.txt"

    required_files = [metadata_filename, camera_matrix_filename, camera_trajectory_filename]

    rgb_folder = "colour"
    depth_folder = "depth"
    required_folders = [rgb_folder, depth_folder]

    depth_scale_factor = 1.0 / 1000.0

    def __init__(self, base_path: File, output_path: File, num_frames: int = -1,
                 frame_step: int = 1, colmap_options: COLMAPOptions = COLMAPOptions()):
        super().__init__(base_path=base_path, output_path=output_path, num_frames=num_frames,
                         frame_step=frame_step, colmap_options=colmap_options)

        import json

        with open(pjoin(str(base_path), self.metadata_filename)) as fh:
            self.info = json.load(fh)

        self.camera_matrix = np.loadtxt(pjoin(str(base_path), self.camera_matrix_filename))

        trajectory = np.loadtxt(pjoin(str(base_path), self.camera_trajectory_filename))
        self.camera_trajectory = Trajectory(trajectory).inverse().normalise()

        self._resolve_num_frames(num_frames)

    def get_full_num_frames(self) -> int:
        return int(self.info["num_frames"])

    def get_metadata(self, estimate_pose: bool, estimate_depth: bool) -> DatasetMetadata:
        return DatasetMetadata(
            num_frames=self.num_frames,
            fps=float(self.info.get("fps", 30.0)),
            width=int(self.info["width"]), height=int(self.info["height"]),
            estimate_pose=estimate_pose, estimate_depth=estimate_depth,
            depth_mask_dilation_iterations=BackgroundMeshOptions().depth_mask_dilation_iterations,
            depth_scale=self.depth_scale_factor, frame_step=self.frame_step,
            colmap_options=self.colmap_options)

    def get_camera_matrix(self) -> np.ndarray:
        return self.camera_matrix

    def get_pose(self, index: int) -> np.ndarray:
        return self.camera_trajectory[index]

    def get_frame(self, index: int) -> np.ndarray:
        return load_image(pjoin(str(self.base_path), self.rgb_folder,
                                HiveDataset.index_to_filename(index)))

    def get_depth_map(self, index: int) -> np.ndarray:
        depth = load_image(pjoin(str(self.base_path), self.depth_folder,
                                 HiveDataset.index_to_filename(index)))
        return depth.astype(np.uint16)  # already millimetres


class StrayScannerAdaptor(DatasetAdaptor):
    """A 'Stray Scanner' capture (iOS LiDAR): recognised, not converted yet.
    Its video decode needs a decoder the card's machine lacks (ROADMAP.md
    Queue 1 item 9b)."""

    required_files = ["rgb.mp4", "camera_matrix.csv", "odometry.csv"]
    required_folders = ["depth", "confidence"]

    def __init__(self, base_path: File, *args, **kwargs):
        raise not_ported(f"Converting the StrayScanner capture {base_path}", "Queue 1 item 9b")


class VideoAdaptor(DatasetAdaptor):
    """A plain RGB video (.mp4, or a folder holding one): recognised, not
    converted yet (ROADMAP.md Queue 1 item 9b)."""

    def __init__(self, base_path: File, *args, **kwargs):
        raise not_ported(f"Converting the video {base_path}", "Queue 1 item 9b")

    @classmethod
    def _validate_dataset(cls, base_path):
        if os.path.isfile(base_path) and Path(base_path).suffix == ".mp4":
            return

        if os.path.isdir(base_path):
            files = [f for f in os.listdir(base_path)
                     if os.path.isfile(pjoin(str(base_path), f))]

            if not files:
                raise InvalidDatasetFormatError(f"Nothing to load: {base_path} has no files.")

            if not any(Path(f).suffix == ".mp4" for f in files):
                raise InvalidDatasetFormatError(
                    f"The folder {base_path} contains no .mp4 video.")
        else:
            raise InvalidDatasetFormatError(f"Dataset folder {base_path} is missing.")


def estimate_depth_dpt(rgb_dataset: ImageFolderDataset, output_path: str, device=None):
    """Estimate metric depth for every frame with DPT-Hybrid, in batches of
    8, and write it as uint16 millimetre PNGs named ``{index:06d}.png``.

    The net size keeps the source's aspect ('minimal' resize to a multiple
    of 32 near 480 x 640), one size for the whole sequence.

    :param device: where the network runs; default ``cuda:0``.
    """
    os.makedirs(output_path, exist_ok=True)
    estimator = DPTDepthEstimator(keep_aspect_multiple_of(rgb_dataset[0].shape[:2]), device)

    index = 0
    for batch in rgb_dataset.batches(8):
        for depth in estimator.predict_batch(batch):  # (H, W) metres
            write_image(pjoin(output_path, f"{index:06d}.png"),
                        (depth * 1000.0).astype(np.uint16))
            index += 1


def get_dataset(storage_options: StorageOptions,
                colmap_options: COLMAPOptions = COLMAPOptions(),
                pipeline_options: PipelineOptions = PipelineOptions(),
                profiling: Optional[dict] = None, device=None) -> HiveDataset:
    """Load a HIVE dataset, converting from a recognised input format if needed.

    Format sniffing order is ``hive_tpu``'s: HIVE cache → TUM → Unreal →
    StrayScanner → plain video.

    :param device: where the instance masks and estimated depth maps are
        computed; default ``cuda:0``.
    """
    dataset_path = storage_options.dataset_path
    output_path = storage_options.output_path

    if not storage_options.no_cache and HiveDataset.is_valid_folder_structure(output_path):
        return HiveDataset(output_path)

    base_kwargs = dict(base_path=dataset_path, output_path=output_path,
                       num_frames=pipeline_options.num_frames,
                       frame_step=pipeline_options.frame_step,
                       colmap_options=colmap_options)

    if TUMAdaptor.is_valid_folder_structure(dataset_path):
        adaptor = TUMAdaptor(**base_kwargs)
    elif UnrealAdaptor.is_valid_folder_structure(dataset_path):
        adaptor = UnrealAdaptor(**base_kwargs)
    elif StrayScannerAdaptor.is_valid_folder_structure(dataset_path):
        adaptor = StrayScannerAdaptor(**base_kwargs)
    elif VideoAdaptor.is_valid_folder_structure(dataset_path):
        adaptor = VideoAdaptor(**base_kwargs)
    elif not os.path.isdir(dataset_path):
        raise RuntimeError(f"{dataset_path} is unreadable or not a directory.")
    else:
        raise RuntimeError(f"The folder {dataset_path} matches no known dataset layout "
                           f"(TUM, Unreal, StrayScanner, video, or HIVE).")

    return adaptor.convert(estimate_pose=pipeline_options.estimate_pose,
                           estimate_depth=pipeline_options.estimate_depth,
                           inpainting_mode=pipeline_options.inpainting_mode,
                           static_camera=pipeline_options.static_camera,
                           no_cache=storage_options.no_cache, profiling=profiling,
                           device=device)
