"""Dataset adaptors: convert TUM, Unreal, StrayScanner and plain-video
inputs into the HIVE dataset format.

Counterpart of ``hive_tpu/dataset_adaptors.py``: ``create_folder`` (:44),
``DatasetAdaptor`` (:50-230) with ``convert``, the cache check and the
folder set-up, ``TUMAdaptor`` (:467-581), ``UnrealAdaptor`` (:584-643),
``VideoAdaptorBase`` (:646-787), ``VideoAdaptor`` (:790-847),
``DeviceOrientation`` (:850-882), ``StrayScannerAdaptor`` (:885-1015) and
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

Videos (a plain ``.mp4``, a StrayScanner capture's ``rgb.mp4``) are read
by :class:`hive_tpu_torch.video.capture.VideoCapture` as ``cv2.VideoCapture``
reads them: H.264 (I, P and B slices, CAVLC or CABAC, the 8x8 transform,
scaling matrices and weighted prediction, as phones, Stray Scanner and
x264 write them; fields, MBAFF and the rest of ROADMAP.md Queue 1 items
9f-4 and 9f are refused by name), HEVC Main profile I, P and B pictures
(``hvc1`` / ``hev1``, as phones and x265 write them; a change of picture
size or an output order that leaves POCs unsorted, 9c-2b, the coding tools of 9c-3, and
Main 10 and the range extensions, 9c-4, are refused by name),
Motion JPEG and MPEG-4 Part 2 (what cv2's own writer makes) in MP4, each
decoded on the host for every device; rotated and resized on the device
(``image_processing.rotate`` / ``resize_linear_u8``, cv2's bytes) and
written as ``cv2.imwrite`` writes JPEGs (quality 95). StrayScanner depth is
rotated and resized as float32 as cv2 does it
(``maskrcnn.resize_linear_f32``).
"""

from __future__ import annotations

import enum
import logging
import os
import shutil
from abc import ABC
from os.path import join as pjoin
from pathlib import Path
from typing import List, Optional, Tuple, Union

import numpy as np

from hive_tpu_torch.custom_types import File, Size
from hive_tpu_torch.geometric import CameraMatrix, Trajectory
from hive_tpu_torch.image_codecs import CV2_JPEG_QUALITY, write_image
from hive_tpu_torch.image_processing import (ROTATE_90_CLOCKWISE, ROTATE_90_COUNTERCLOCKWISE,
                                             ROTATE_180, TELEA_RADIUS,
                                             calculate_target_resolution, dilate_ids,
                                             inpaint_telea, resize_linear_u8, rotate)
from hive_tpu_torch.io import (COLMAPProcessor, Dataset, DatasetMetadata, HiveDataset,
                               ImageFolderDataset, InvalidDatasetFormatError, create_masks,
                               load_image, make_depth_map_transform)
from hive_tpu_torch.models.dpt import DPTDepthEstimator
from hive_tpu_torch.models.lama import lama_inpaint_folder
from hive_tpu_torch.models.maskrcnn import resize_linear_f32
from hive_tpu_torch.options import (BackgroundMeshOptions, COLMAPOptions, InpaintingMode,
                                    PipelineOptions, StorageOptions)
from hive_tpu_torch.ops.resize import keep_aspect_multiple_of
from hive_tpu_torch.sensor import KinectSensor
from hive_tpu_torch.utils import timed_block, tqdm_imap
from hive_tpu_torch.video.capture import VideoCapture


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


class VideoAdaptorBase(DatasetAdaptor, ABC):
    """Shared machinery for video-file-backed datasets. The video is read
    by :class:`hive_tpu_torch.video.capture.VideoCapture` on ``device``:
    demuxed and decoded on the host (H.264, HEVC, Motion JPEG and MPEG-4 Part
    2 alike, one path for every device; the wanted pictures' planes moved to
    the device); converted to BGR, rotated and resized on the device; only
    the final uint8 frames reach the host, to be encoded.

    :param device: where the frames are converted, rotated and resized;
        default ``cuda:0``. An H.264 or HEVC stream outside the decoded
        subset is refused when the capture opens, naming the feature and its
        ROADMAP.md Queue 1 item (H.264: 9f-4 for fields and MBAFF, 9f for the
        rest; HEVC: 9c-2b for a change of picture size or unsorted output, 9c-3
        for scaling lists, tiles, WPP and dependent slices, 9c-4 for Main
        10 and the range extensions).
    """

    def __init__(self, base_path: File, output_path: File, video_path: Union[str, Path],
                 num_frames: int = -1, frame_step: int = 1,
                 colmap_options: COLMAPOptions = COLMAPOptions(),
                 resize_to: Optional[Union[int, Size]] = None, device=None):
        super().__init__(base_path=base_path, output_path=output_path, num_frames=num_frames,
                         frame_step=frame_step, colmap_options=colmap_options)

        self.video_path = str(video_path)
        self.capture = VideoCapture(self.video_path, device)
        self.device = self.capture.device

        self._resolve_num_frames(num_frames)

        self.source_width = self.capture.width
        self.source_height = self.capture.height
        self.fps = float(self.capture.fps) or 30.0

        if resize_to is not None:
            self.target_height, self.target_width = calculate_target_resolution(
                (self.source_height, self.source_width),
                resize_to if isinstance(resize_to, int) else tuple(resize_to))
        else:
            self.target_height, self.target_width = self.source_height, self.source_width

        if (self.target_height, self.target_width) != (self.source_height, self.source_width):
            logging.info(f"Frames will be resized {self.source_width}x{self.source_height} -> "
                         f"{self.target_width}x{self.target_height} (w x h).")

    def _count_frames(self) -> int:
        """The frame count a ``cv2.VideoCapture.grab()`` loop finds: the
        demuxer's frames in display order, the edit list applied."""
        return self.capture.frame_count

    def get_full_num_frames(self) -> int:
        return self._count_frames()

    def get_metadata(self, estimate_pose: bool, estimate_depth: bool) -> DatasetMetadata:
        return DatasetMetadata(
            num_frames=self.num_frames, fps=self.fps,
            width=self.target_width, height=self.target_height,
            frame_step=self.frame_step, estimate_pose=estimate_pose,
            estimate_depth=estimate_depth,
            depth_mask_dilation_iterations=BackgroundMeshOptions().depth_mask_dilation_iterations,
            depth_scale=HiveDataset.depth_scaling_factor, colmap_options=self.colmap_options)

    def get_frame(self, index: int) -> np.ndarray:
        """The RGB frame at ``index``, decoded from the sync sample before
        it and resized on the device."""
        if not 0 <= index < self.capture.frame_count:
            raise RuntimeError(f"Failed to decode frame index {index} (0-based) of "
                               f"{self.video_path}.")
        frame = resize_linear_u8(self.capture.frame(index), self.target_width,
                                 self.target_height)
        return frame.flip(-1).cpu().numpy()

    def copy_frames(self, output_path: str, num_frames: int = -1, file_extension: str = "png"):
        num_frames = self.num_frames if num_frames == -1 else num_frames
        self.extract_video(self.video_path, output_path, num_frames,
                           target_resolution=(self.target_height, self.target_width),
                           file_extension=file_extension, device=self.device)

    @staticmethod
    def extract_video(path_to_video: str, output_path: str, num_frames: int = -1,
                      target_resolution: Optional[Tuple[int, int]] = None,
                      rotation: Optional[int] = None, file_extension: str = "png", device=None):
        """Write the video's frames as ``{index:06d}.{file_extension}``, as
        ``cv2.imwrite`` writes them (JPEG at quality 95): decode stays
        sequential and each frame is rotated and resized on ``device``
        (default ``cuda:0``); the encode and write run on worker threads, at
        most 4 x workers frames in flight."""
        from concurrent.futures import ThreadPoolExecutor

        capture = VideoCapture(path_to_video, device)

        def write(index, bgr):
            write_image(pjoin(output_path, f"{index:06d}.{file_extension}"),
                        np.ascontiguousarray(bgr[..., ::-1]), CV2_JPEG_QUALITY)

        count = capture.frame_count if num_frames == -1 else min(num_frames, capture.frame_count)
        workers = os.cpu_count() or 1
        # Decode outruns the encodes, and each queued frame pins its pixels:
        # draining the oldest future once 4 x workers are in flight bounds
        # memory at O(workers) frames while keeping every worker busy.
        max_in_flight = 4 * workers
        futures = []
        index = 0
        with ThreadPoolExecutor(max_workers=workers) as pool:
            for frame in capture.frames(0, count):
                if rotation is not None:
                    frame = rotate(frame, rotation)
                if target_resolution is not None:
                    height, width = target_resolution
                    frame = resize_linear_u8(frame, width, height)
                futures.append(pool.submit(write, index, frame.cpu().numpy()))
                if len(futures) >= max_in_flight:
                    futures.pop(0).result()
                index += 1

            for future in futures:
                future.result()

        if num_frames != -1 and index < num_frames:
            raise RuntimeError(f"Video {path_to_video} only yielded {index} frames "
                               f"({num_frames} requested).")


class VideoAdaptor(VideoAdaptorBase):
    """Ingests a plain RGB video (.mp4, or the first .mp4 of a folder);
    depth and pose must be estimated."""

    _no_ground_truth_error_message = (
        "Plain video inputs carry no ground-truth poses or depth; pass "
        "'--estimate_pose' and '--estimate_depth' so both are estimated.")

    def __init__(self, base_path: File, output_path: File, num_frames: int = -1,
                 frame_step: int = 1, colmap_options: COLMAPOptions = COLMAPOptions(),
                 resize_to: Optional[Union[int, Size]] = None, device=None):
        path = Path(base_path)

        if os.path.isfile(path):
            video_path = str(path)
            base_path = str(path.parent)
        else:
            # Sorted, so that the chosen video does not depend on the file system.
            mp4s = sorted(f for f in os.listdir(path) if f.endswith(".mp4"))
            if not mp4s:
                raise InvalidDatasetFormatError(f"No .mp4 file found in {path}.")
            video_path = pjoin(str(path), mp4s[0])

        super().__init__(base_path=base_path, output_path=output_path, video_path=video_path,
                         num_frames=num_frames, frame_step=frame_step,
                         colmap_options=colmap_options, resize_to=resize_to, device=device)

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

    def get_camera_matrix(self) -> np.ndarray:
        raise NotImplementedError(self._no_ground_truth_error_message)

    def get_pose(self, index: int) -> np.ndarray:
        raise NotImplementedError(self._no_ground_truth_error_message)

    def get_camera_trajectory(self) -> Trajectory:
        raise NotImplementedError(self._no_ground_truth_error_message)

    def get_depth_map(self, index: int) -> np.ndarray:
        raise NotImplementedError(self._no_ground_truth_error_message)


class DeviceOrientation(enum.Enum):
    """Capture-device orientation inferred from the first pose's roll."""

    Landscape = enum.auto()         # no rotation needed
    Portrait = enum.auto()          # rotate 90° CW
    LandscapeReverse = enum.auto()  # rotate 180°
    PortraitReverse = enum.auto()   # rotate 90° CCW

    @classmethod
    def from_angle(cls, angle: float, degrees: bool = False) -> "DeviceOrientation":
        if not degrees:
            angle = np.rad2deg(angle)

        if abs(angle) <= 45:
            return cls.Landscape
        if -135 <= angle < -45:
            return cls.Portrait
        if 45 < angle <= 135:
            return cls.PortraitReverse
        if 135 < abs(angle) <= 180:
            return cls.LandscapeReverse

        raise ValueError(f"Roll angle {angle} lies outside [-180, 180]"
                         + ("." if degrees else " (after radians-to-degrees conversion)."))

    @classmethod
    def to_opencv_rotation(cls, orientation: "DeviceOrientation") -> Optional[int]:
        """The ``cv2.rotate`` code (:func:`image_processing.rotate`) that
        turns a frame upright."""
        return {
            cls.Portrait: ROTATE_90_CLOCKWISE,
            cls.LandscapeReverse: ROTATE_180,
            cls.PortraitReverse: ROTATE_90_COUNTERCLOCKWISE,
        }.get(orientation)


class StrayScannerAdaptor(VideoAdaptorBase):
    """Ingests 'Stray Scanner' captures from iOS LiDAR devices: ``rgb.mp4``,
    uint16 millimetre depth and 0-2 confidence PNGs at the LiDAR's size,
    ``camera_matrix.csv`` and ``odometry.csv``."""

    video_filename = "rgb.mp4"
    camera_matrix_filename = "camera_matrix.csv"
    camera_trajectory_filename = "odometry.csv"
    required_files = [video_filename, camera_matrix_filename, camera_trajectory_filename]

    depth_folder = "depth"
    confidence_map_folder = "confidence"
    required_folders = [depth_folder, confidence_map_folder]

    depth_confidence_levels = (0, 1, 2)
    valid_depth_map_types = {np.dtype("uint16"), np.dtype("uint32"), np.dtype("uint64"),
                             np.dtype("int32"), np.dtype("int64")}

    def __init__(self, base_path: File, output_path: File, num_frames: int = -1,
                 frame_step: int = 1, colmap_options: COLMAPOptions = COLMAPOptions(),
                 resize_to: Optional[Union[int, Size]] = None,
                 depth_confidence_filter_level: int = 0, fix_orientation: bool = True,
                 device=None):
        video_path = pjoin(str(base_path), StrayScannerAdaptor.video_filename)

        super().__init__(base_path=base_path, output_path=output_path, video_path=video_path,
                         num_frames=num_frames, frame_step=frame_step,
                         colmap_options=colmap_options, resize_to=resize_to, device=device)

        if depth_confidence_filter_level not in self.depth_confidence_levels:
            raise ValueError(f"Confidence filter must be one of: "
                             f"{self.depth_confidence_levels}.")

        self.depth_confidence_filter_level = depth_confidence_filter_level
        self.fix_orientation = fix_orientation

        (self.device_orientation,
         self.camera_trajectory) = self._get_device_orientation_and_trajectory()

        if self.device_orientation in (DeviceOrientation.Portrait,
                                       DeviceOrientation.PortraitReverse):
            # A 90° frame rotation swaps width and height.
            self.target_height, self.target_width = self.target_width, self.target_height

    def _get_device_orientation_and_trajectory(self) -> Tuple[DeviceOrientation, Trajectory]:
        from scipy.spatial.transform import Rotation

        trajectory = self._load_camera_trajectory()

        if self.fix_orientation:
            # The orientation is read off the raw first pose (normalisation
            # resets rotations).
            roll = Rotation.from_quat(trajectory.rotations[0]).as_euler("xyz")[-1]
            orientation = DeviceOrientation.from_angle(roll)
        else:
            orientation = DeviceOrientation.Landscape

        if orientation != DeviceOrientation.Landscape:
            angle = {DeviceOrientation.LandscapeReverse: 180,
                     DeviceOrientation.Portrait: -90,
                     DeviceOrientation.PortraitReverse: 90}[orientation]

            rotation = np.eye(4)
            rotation[:3, :3] = Rotation.from_euler("z", angle, degrees=True).as_matrix()
            trajectory = trajectory.apply(rotation)

        trajectory = trajectory.normalise_position().inverse()

        # Scenes from this adaptor end up upside down without this final 180°
        # about x.
        flip = np.eye(4)
        flip[1, 1] = -1.0
        flip[2, 2] = -1.0
        trajectory = trajectory.apply(flip)

        return orientation, trajectory

    def _load_camera_trajectory(self) -> Trajectory:
        # odometry.csv rows: timestamp, frame, tx, ty, tz, qx, qy, qz, qw.
        raw = np.loadtxt(pjoin(str(self.base_path), self.camera_trajectory_filename),
                         delimiter=",", skiprows=1)

        poses = np.zeros((len(raw), 7))
        poses[:, :4] = raw[:, 5:9]  # qx qy qz qw
        poses[:, 4:] = raw[:, 2:5]  # tx ty tz

        return Trajectory(poses)

    def get_camera_matrix(self) -> np.ndarray:
        raw = np.loadtxt(pjoin(str(self.base_path), self.camera_matrix_filename),
                         delimiter=",")

        camera = CameraMatrix(fx=raw[0, 0], fy=raw[1, 1], cx=raw[0, 2], cy=raw[1, 2],
                              width=self.source_width, height=self.source_height)

        return camera.scale((self.target_height, self.target_width)).matrix

    def get_pose(self, index: int) -> np.ndarray:
        return self.camera_trajectory[index]

    def copy_frames(self, output_path: str, num_frames: int = -1, file_extension: str = "png"):
        num_frames = self.num_frames if num_frames == -1 else num_frames
        self.extract_video(self.video_path, output_path, num_frames,
                           target_resolution=(self.target_height, self.target_width),
                           rotation=DeviceOrientation.to_opencv_rotation(self.device_orientation),
                           file_extension=file_extension, device=self.device)

    def get_depth_map(self, index: int) -> np.ndarray:
        filename = HiveDataset.index_to_filename(index)
        depth_map = load_image(pjoin(str(self.base_path), self.depth_folder, filename))

        if depth_map.dtype not in self.valid_depth_map_types:
            raise RuntimeError(f"Depth maps must be one of {self.valid_depth_map_types}; "
                               f"this one is {depth_map.dtype}.")

        confidence = load_image(pjoin(str(self.base_path), self.confidence_map_folder,
                                      filename))
        depth_map = depth_map.copy()
        depth_map[confidence < self.depth_confidence_filter_level] = 0

        # Rotate before resizing so orientation fixes land correctly.
        if (rotation := DeviceOrientation.to_opencv_rotation(self.device_orientation)) \
                is not None:
            depth_map = rotate(depth_map, rotation)

        resized = resize_linear_f32(depth_map.astype(np.float32), self.target_width,
                                    self.target_height)

        return np.round(resized).astype(depth_map.dtype)


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
                resize_to: Optional[Union[int, Size]] = 640,
                depth_confidence_filter_level: int = 0,
                profiling: Optional[dict] = None, device=None) -> HiveDataset:
    """Load a HIVE dataset, converting from a recognised input format if needed.

    Format sniffing order is ``hive_tpu``'s: HIVE cache → TUM → Unreal →
    StrayScanner → plain video. ``resize_to`` (the long side, or a (height,
    width)) and ``depth_confidence_filter_level`` apply to video inputs; a
    StrayScanner capture's orientation is fixed from its odometry unless
    the poses are estimated.

    :param device: where the video frames are decoded and resized and the
        instance masks and estimated depth maps computed; default
        ``cuda:0``.
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
        adaptor = StrayScannerAdaptor(
            **base_kwargs, resize_to=resize_to,
            depth_confidence_filter_level=depth_confidence_filter_level,
            fix_orientation=not pipeline_options.estimate_pose, device=device)
    elif VideoAdaptor.is_valid_folder_structure(dataset_path):
        adaptor = VideoAdaptor(resize_to=resize_to, device=device, **base_kwargs)
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
