"""End-to-end pipeline: RGB-D sequence → fg.glb + bg.glb + metadata.

Counterpart of ``hive_tpu/pipeline.py``: ``run`` with its dataset
conversion (``adaptor=`` or the input's format sniffed, :176-187) and the
foreground stage overlapping the background stage (:195-250), the TSDF,
RGBD and BundleFusion background methods, per-frame foreground meshing
(``_create_scene``, ``process_frame``, ``_mesh_single_frame``, :372-599),
``_center_scenes`` with ``--align_scene`` and the BundleFusion alignment,
the export with its draco or quantize compression (:806-904), the WebXR
copy, ``profiling.json`` with its per-frame roll-ups (:1045-1096) and
``--webxr_run_server`` (:293-314, the viewer in ``hive_tpu_torch.viewer``). The
conversion's masks and the background's TSDF fusion run on the card; the
foreground stays host numpy, scipy and native C++ in worker threads, as in
the JAX package, after foreground trajectory smoothing
(``--fts_num_epochs``, :360-368) on the card, with the stages then run
one after the other. The CLI flags are the JAX package's option groups
(its parser leaves the smoothing group out; this one registers it);
options whose stages are not ported yet raise ``NotImplementedError``
naming the ROADMAP item that ports them.
"""

from __future__ import annotations

import argparse
import datetime
import json
import logging
import os
import resource
import shutil
import subprocess
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from os.path import join as pjoin
from pathlib import Path
from typing import Any, List, Optional, Tuple, Union

import numpy as np
import torch

from hive_tpu_torch import get_device
from hive_tpu_torch.geometric import get_pose_components, point_cloud_from_depth
from hive_tpu_torch.image_processing import dilate_mask
from hive_tpu_torch.io import HiveDataset, temporary_trajectory
from hive_tpu_torch.meshing.components import cleanup_with_connected_components
from hive_tpu_torch.meshing.decimate import decimate_mesh
from hive_tpu_torch.meshing.gltf import export_scene, quantize_glb, write_gzip_sibling
from hive_tpu_torch.meshing.mesh import Scene, TriangleMesh
from hive_tpu_torch.meshing.texture import get_mesh_texture_and_uv, pack_textures
from hive_tpu_torch.meshing.triangulate import (filter_faces, triangulate_grid,
                                                triangulate_points)
from hive_tpu_torch.options import (BackgroundMeshOptions, COLMAPOptions,
                                    ForegroundTrajectorySmoothingOptions,
                                    MaskDilationOptions, MeshDecimationOptions,
                                    MeshFilteringOptions, MeshReconstructionMethod,
                                    PipelineOptions, StorageOptions, WebXROptions)
from hive_tpu_torch.parallel.runtime import configure, set_runtime_mesh
from hive_tpu_torch.utils import (format_bytes, get_key_path, set_key_path,
                                  setup_logger, timed_block, tqdm_imap)


class Pipeline:
    """Converts an RGB-D sequence with known poses into a 3D mesh video."""

    mesh_folder = "mesh"
    bundle_fusion_folder = "bundle_fusion"

    def __init__(self, options: PipelineOptions, storage_options: StorageOptions,
                 decimation_options=MeshDecimationOptions(),
                 dilation_options=MaskDilationOptions(),
                 filtering_options=MeshFilteringOptions(),
                 colmap_options=COLMAPOptions(),
                 static_mesh_options=BackgroundMeshOptions(),
                 webxr_options=WebXROptions(),
                 fts_options=ForegroundTrajectorySmoothingOptions(),
                 device=None):
        """:param device: ``"cpu"`` or a CUDA device; default ``cuda:0``."""
        self.options = options
        self.storage_options = storage_options
        self.colmap_options = colmap_options
        self.decimation_options = decimation_options
        self.dilation_options = dilation_options
        self.filtering_options = filtering_options
        self.background_mesh_options = static_mesh_options
        self.webxr_options = webxr_options
        self.fts_options = fts_options
        self.device = get_device(device)

        self.profiling: dict = {}

        setup_logger(self.options.log_file)

    @staticmethod
    def from_command_line(argv=None, device=None) -> "Pipeline":
        parser = argparse.ArgumentParser(
            "HIVE", description="Turn an RGB-D sequence with camera poses into a "
                                "free-viewpoint 3D mesh video.")
        PipelineOptions.add_args(parser)
        StorageOptions.add_args(parser)
        MaskDilationOptions.add_args(parser)
        MeshFilteringOptions.add_args(parser)
        MeshDecimationOptions.add_args(parser)
        COLMAPOptions.add_args(parser)
        BackgroundMeshOptions.add_args(parser)
        WebXROptions.add_args(parser)
        # hive_tpu's parser leaves this group out, so its CLI rejects
        # --fts_num_epochs; here the flags reach the pipeline.
        ForegroundTrajectorySmoothingOptions.add_args(parser)

        args = parser.parse_args(argv)
        logging.debug(args)

        return Pipeline(
            options=PipelineOptions.from_args(args),
            storage_options=StorageOptions.from_args(args),
            decimation_options=MeshDecimationOptions.from_args(args),
            dilation_options=MaskDilationOptions.from_args(args),
            filtering_options=MeshFilteringOptions.from_args(args),
            colmap_options=COLMAPOptions.from_args(args),
            static_mesh_options=BackgroundMeshOptions.from_args(args),
            webxr_options=WebXROptions.from_args(args),
            fts_options=ForegroundTrajectorySmoothingOptions.from_args(args),
            device=device,
        )

    # -- properties ----------------------------------------------------------
    @property
    def num_frames(self) -> int:
        return self.options.num_frames

    @property
    def estimate_pose(self) -> bool:
        return self.options.estimate_pose

    @property
    def estimate_depth(self) -> bool:
        return self.options.estimate_depth

    @property
    def mesh_path(self) -> str:
        return pjoin(str(self.storage_options.output_path), self.mesh_folder)

    @contextmanager
    def timed_block(self, log_msg: Optional[str], key_path: list):
        with timed_block(log_msg=log_msg, profiling=self.profiling, key_path=key_path) as timer:
            yield timer

    # -- main entry ----------------------------------------------------------
    def run(self, dataset: Optional[HiveDataset] = None, adaptor=None, compress: bool = True):
        """Run the pipeline.

        :param dataset: Use this dataset instead of loading from CLI options.
        :param adaptor: Use this dataset adaptor instead of auto-detection.
        :param compress: Whether to compress the exported meshes.
        """
        # Multi-device runtime: the stages that split (TSDF integration and
        # extraction, DPT batches, pose correspondences) pick this mesh up.
        # A count the machine cannot give is refused here, before anything
        # is read or written; the mesh is cleared when the run ends.
        configure(self.options.num_devices, device=self.device)
        try:
            self._run(dataset, adaptor, compress)
        finally:
            set_runtime_mesh(None)

    def _run(self, dataset: Optional[HiveDataset], adaptor, compress: bool):
        start_time = time.time()
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)

        with self.timed_block("Loading dataset...", ["timing", "load_dataset", "total"]):
            if adaptor is not None:
                dataset = adaptor.convert(estimate_pose=self.options.estimate_pose,
                                          estimate_depth=self.options.estimate_depth,
                                          inpainting_mode=self.options.inpainting_mode,
                                          static_camera=self.options.static_camera,
                                          no_cache=self.storage_options.no_cache,
                                          profiling=self.profiling, device=self.device)
            elif dataset is None:
                dataset = self.get_dataset()

            if self.num_frames == -1:
                self.options.num_frames = dataset.num_frames
            else:
                self.options.num_frames = min(self.num_frames, dataset.num_frames)

        # Foreground meshing is host work (numpy, scipy and the native
        # decimator release the GIL); the background stage mostly waits on
        # the card. They run concurrently, each with its own wall-clock
        # timer (their sum can exceed the run's wall time), EXCEPT under
        # foreground trajectory smoothing: it swaps the dataset's trajectory
        # (temporary_trajectory), which the background integration reads.
        overlap = self.fts_options.num_epochs <= 0
        set_key_path(self.profiling, ["timing", "stages_overlapped"], overlap)

        def foreground_job():
            with self.timed_block("Meshing the dynamic foreground...",
                                  ["timing", "foreground_reconstruction", "total"]):
                return self._create_foreground_scene(dataset)

        def background_job():
            with self.timed_block("Reconstructing the static background...",
                                  ["timing", "background_reconstruction", "total"]):
                return self._create_background_scene(dataset)

        if overlap:
            overlap_pool = ThreadPoolExecutor(max_workers=1)
            foreground_future = overlap_pool.submit(foreground_job)

            try:
                background_scene = background_job()
            except BaseException:
                # Surface the background error now instead of blocking on the
                # rest of the foreground stage, and don't drop a concurrent
                # foreground failure: a running job can't be cancelled, so log
                # it whenever it finishes.
                def _log_foreground_failure(future):
                    if not future.cancelled() and future.exception() is not None:
                        logging.error("Foreground stage also failed: "
                                      f"{future.exception()!r}")

                foreground_future.add_done_callback(_log_foreground_failure)
                overlap_pool.shutdown(wait=False, cancel_futures=True)
                raise

            foreground_scene = foreground_future.result()
            overlap_pool.shutdown()
        else:
            background_scene = background_job()
            foreground_scene = foreground_job()

        with self.timed_block("Recentring the foreground/background scenes...",
                              ["timing", "scene_centering"]):
            foreground_scene, background_scene = self._center_scenes(
                dataset, foreground_scene, background_scene)

        with self.timed_block("Saving meshes to disk...", ["timing", "mesh_export"]):
            foreground_scene_path, background_scene_path = self._write_meshes_to_disk(
                mesh_path=self.mesh_path,
                foreground_scene=foreground_scene,
                background_scene=background_scene,
                overwrite_ok=self.storage_options.overwrite_ok,
            )

        with self.timed_block("Compressing the exported meshes...", ["timing", "mesh_compression", "total"]):
            with self.timed_block(None, ["timing", "mesh_compression", "foreground"]):
                if compress:
                    self._compress_mesh(foreground_scene_path)

            with self.timed_block(None, ["timing", "mesh_compression", "background"]):
                if compress:
                    self._compress_mesh(background_scene_path)

        with self.timed_block(
                f"Copying mesh video into the WebXR player folder "
                f"{self.webxr_options.webxr_path}...", ["timing", "webxr_export"]):
            self._export_video_webxr(self.mesh_path, fg_scene_name="fg", bg_scene_name="bg",
                                     metadata=self._get_webxr_metadata(dataset),
                                     export_name=self._get_dataset_name(dataset))

        elapsed_time_seconds = time.time() - start_time

        self._print_summary(foreground_scene, background_scene,
                            foreground_scene_path, background_scene_path,
                            elapsed_time_seconds)

        self._write_profiling_data(path=pjoin(str(dataset.base_path), "profiling.json"))

        logging.info(f"Start the viewer (python -m hive_tpu_torch.viewer --webxr_path "
                     f"{self.webxr_options.webxr_path}) and go to this URL: "
                     f"{self.webxr_options.webxr_url}?video={self._get_dataset_name(dataset)}")

        if self.webxr_options.webxr_run_server:
            self._run_viewer()

    def _run_viewer(self):
        """``--webxr_run_server``: ``npm run start`` in an external renderer's
        checkout (``--webxr_source_path`` with ``node_modules``), else the
        in-tree player on the port of ``--webxr_url``. As in ``hive_tpu``, a
        URL without a scheme (``localhost:9000``) parses to no port, so the
        server then binds 8080."""
        if os.path.isdir(pjoin(self.webxr_options.webxr_source_path, "node_modules")):
            subprocess.run(["npm", "run", "start"], cwd=self.webxr_options.webxr_source_path)
            return

        from urllib.parse import urlsplit

        from hive_tpu_torch.viewer import main as viewer_main

        try:
            port = urlsplit(self.webxr_options.webxr_url).port
        except ValueError:
            port = None
        viewer_main(["--webxr_path", self.webxr_options.webxr_path,
                     "--port", str(port or 8080)])

    def get_dataset(self) -> HiveDataset:
        """The HIVE-format dataset named on the command line. As in
        ``hive_tpu``, a converted dataset is looked up at ``--output_path``;
        otherwise ``--dataset_path`` is converted into it (TUM, Unreal,
        StrayScanner and video inputs; video frames scaled to a long side of
        640 unless ``--disable_scaling``)."""
        from hive_tpu_torch.dataset_adaptors import get_dataset

        resize_to = None if self.options.disable_scaling else 640
        return get_dataset(self.storage_options, self.colmap_options, self.options,
                           resize_to=resize_to, profiling=self.profiling, device=self.device)

    # -- device stats ---------------------------------------------------------
    def _get_peak_device_memory(self) -> dict:
        """Peak device memory in bytes (torch's caching allocator)."""
        if self.device.type != "cuda":
            return {"allocated": 0, "reserved": 0}
        return {"allocated": int(torch.cuda.max_memory_allocated(self.device)),
                "reserved": int(torch.cuda.max_memory_reserved(self.device))}

    # -- scene creation -------------------------------------------------------
    def _create_background_scene(self, dataset: HiveDataset) -> Scene:
        if self.background_mesh_options.reconstruction_method == MeshReconstructionMethod.RGBD:
            return self._create_scene(dataset, num_frames=self.num_frames,
                                      include_background=True, background_only=True)

        background_scene = self._create_empty_scene(dataset)
        static_mesh = self.create_static_mesh(dataset, num_frames=self.num_frames,
                                              options=self.background_mesh_options,
                                              profiling=self.profiling,
                                              device=self.device)

        # The renderer expects sRGB for vertex-coloured meshes (three.js does
        # not convert vertex colours automatically; it does for textures).
        if static_mesh.vertex_colors is not None:
            rgb = static_mesh.vertex_colors[:, :3].astype(np.float64)
            static_mesh.vertex_colors[:, :3] = (255 * np.power(rgb / 255, 2.2)).astype(np.uint8)

        background_scene.add_geometry(static_mesh, node_name="000000")
        return background_scene

    def _create_foreground_scene(self, dataset: HiveDataset) -> Scene:
        if self.options.background_only:
            return self._create_empty_scene(dataset)

        if self.fts_options.num_epochs > 0:
            from hive_tpu_torch.pose_optimisation import ForegroundPoseOptimiser

            smoothed = ForegroundPoseOptimiser(
                dataset, learning_rate=self.fts_options.learning_rate,
                num_epochs=self.fts_options.num_epochs, device=self.device).run()

            with temporary_trajectory(dataset, smoothed):
                return self._create_scene(dataset, num_frames=self.num_frames)

        return self._create_scene(dataset, num_frames=self.num_frames)

    def _create_scene(self, dataset: HiveDataset, num_frames: int,
                      include_background: bool = False, background_only: bool = False) -> Scene:
        """Mesh each frame (per dynamic object) into a Scene.

        Host-side, as in the JAX package: per-object vertex counts are
        dynamic, so triangulation, filtering, decimation and texturing run
        on CPU threads, one frame per worker. Nothing here runs on the card.
        """
        if num_frames == -1:
            num_frames = dataset.num_frames

        if background_only:
            rgb_dataset = dataset.bg_rgb_dataset
            depth_dataset = dataset.bg_depth_dataset
        else:
            rgb_dataset = dataset.rgb_dataset
            depth_dataset = dataset.depth_dataset

        mask_dataset = dataset.mask_dataset
        camera_matrix = dataset.camera_matrix

        scene = self._create_empty_scene(dataset)
        poses = dataset.camera_trajectory.to_homogenous_transforms()

        def process_frame(index: int) -> TriangleMesh:
            return self._mesh_single_frame(
                index=index,
                rgb=rgb_dataset[index],
                depth=depth_dataset[index],
                mask_encoded=mask_dataset[index],
                pose=poses[index],
                camera_matrix=camera_matrix,
                include_background=include_background,
                background_only=background_only,
                has_inpainted_frame_data=dataset.has_inpainted_frame_data,
                profile=True,
            )

        if background_only:
            frames = dataset.select_key_frames(
                threshold=self.background_mesh_options.key_frame_threshold)
        else:
            frames = list(range(num_frames))

        logging.info("Building per-frame meshes...")
        meshes = tqdm_imap(process_frame, frames)

        for i, mesh in zip(frames, meshes):
            if not mesh.is_empty:
                scene.add_geometry(mesh, node_name=f"{i:06d}")

        return scene

    def process_frame(self, dataset: HiveDataset, index: int, background_only: bool = False,
                      include_background: bool = False,
                      enable_cc_analysis: bool = True) -> TriangleMesh:
        """Mesh a single frame without profiling (for experiments)."""
        if background_only:
            rgb_dataset = dataset.bg_rgb_dataset
            depth_dataset = dataset.bg_depth_dataset
        else:
            rgb_dataset = dataset.rgb_dataset
            depth_dataset = dataset.depth_dataset

        pose = dataset.camera_trajectory.to_homogenous_transforms()[index]

        return self._mesh_single_frame(
            index=index, rgb=rgb_dataset[index], depth=depth_dataset[index],
            mask_encoded=dataset.mask_dataset[index], pose=pose,
            camera_matrix=dataset.camera_matrix, include_background=include_background,
            background_only=background_only,
            has_inpainted_frame_data=dataset.has_inpainted_frame_data,
            profile=False, enable_cc_analysis=enable_cc_analysis)

    def _mesh_single_frame(self, index: int, rgb, depth, mask_encoded, pose, camera_matrix,
                           include_background: bool, background_only: bool,
                           has_inpainted_frame_data: bool, profile: bool,
                           enable_cc_analysis: bool = True) -> TriangleMesh:
        frame_vertices = np.zeros((0, 3))
        frame_faces = np.zeros((0, 3), dtype=np.int64)
        uv_atlas: List[np.ndarray] = []
        texture_atlas: List[np.ndarray] = []
        vertex_count = 0

        rgb = np.ascontiguousarray(rgb[:, :, :3])
        rotation, translation = get_pose_components(pose)

        profiling = self.profiling if profile else None

        mask_start = 0 if include_background else 1
        mask_end = 1 if background_only else int(mask_encoded.max()) + 1

        for object_id in range(mask_start, mask_end):
            with timed_block(None, profiling,
                             ["timing", "foreground_reconstruction", "binary_mask_creation",
                              index, object_id]):
                is_object = object_id > 0

                if is_object:
                    mask = dilate_mask(mask_encoded == object_id, self.dilation_options)
                else:
                    mask = (np.ones_like(mask_encoded, dtype=bool)
                            if has_inpainted_frame_data else mask_encoded == 0)

                coverage_ratio = mask.mean()

                if coverage_ratio < 0.01 and not self.options.disable_coverage_constraint:
                    logging.debug(f"Object #{object_id}, frame {index + 1}: mask coverage below "
                                  f"the 1% floor — skipped.")
                    continue

            with timed_block(None, profiling,
                             ["timing", "foreground_reconstruction", "per_object_mesh", "total",
                              index, object_id]):
                vertices = point_cloud_from_depth(depth, mask, camera_matrix,
                                                  rotation, translation)

                if len(vertices) < 9:
                    logging.debug(f"Object #{object_id}, frame {index + 1}: only {len(vertices)} "
                                  f"vertices — too few to mesh, skipped.")
                    continue

                valid_pixels = mask & (depth > 0.0)
                use_grid = self.filtering_options.triangulation == "grid"

                with timed_block(None, profiling,
                                 ["timing", "foreground_reconstruction", "per_object_mesh",
                                  "face_triangulation", index, object_id]):
                    if use_grid:
                        points2d, faces, masked_depth = triangulate_grid(
                            valid_pixels, depth, self.filtering_options)
                    else:
                        v, u = valid_pixels.nonzero()
                        points2d = np.stack([u, v], axis=-1)
                        masked_depth = depth[valid_pixels]
                        faces = triangulate_points(points2d)

            with timed_block(None, profiling,
                             ["timing", "foreground_reconstruction", "face_filtering",
                              index, object_id]):
                if not use_grid:
                    faces = filter_faces(points2d, masked_depth, faces,
                                         self.filtering_options)

                if len(faces) < 1:
                    logging.debug(f"Object #{object_id}, frame {index + 1}: triangulation produced "
                                  f"{len(faces)} faces — skipped.")
                    continue

            with timed_block(None, profiling,
                             ["timing", "foreground_reconstruction", "mesh_decimation",
                              index, object_id]):
                if profile:
                    set_key_path(self.profiling,
                                 ["mesh_decimation", "vertex_count", "before", index, object_id],
                                 len(vertices))
                    set_key_path(self.profiling,
                                 ["mesh_decimation", "face_count", "before", index, object_id],
                                 len(faces))

                target = (self.decimation_options.num_faces_object if is_object
                          else self.decimation_options.num_faces_background)
                vertices, faces = decimate_mesh(vertices, faces, target,
                                                self.decimation_options.max_error)

                if profile:
                    set_key_path(self.profiling,
                                 ["mesh_decimation", "vertex_count", "after", index, object_id],
                                 len(vertices))
                    set_key_path(self.profiling,
                                 ["mesh_decimation", "face_count", "after", index, object_id],
                                 len(faces))

            with timed_block(None, profiling,
                             ["timing", "foreground_reconstruction", "floater_removal",
                              index, object_id]):
                if enable_cc_analysis:
                    vertices, faces = cleanup_with_connected_components(
                        vertices, faces, is_object,
                        min_components=self.filtering_options.min_num_components)

            if len(vertices) == 0 or len(faces) == 0:
                # Floater removal legitimately empties a noise object whose
                # largest component is under min_num_components: skip just
                # this object.
                logging.debug(f"Object {object_id} of frame {index} is empty "
                              f"after filtering; skipping.")
                continue

            with timed_block(None, profiling,
                             ["timing", "foreground_reconstruction", "billboard",
                              index, object_id]):
                if is_object and self.options.billboard:
                    # Flatten the object to its median camera-space depth.
                    # World -> camera is x_cam = R v + t (the codebase
                    # convention, geometric.world2image).
                    camera_space = rotation @ vertices.T + translation
                    camera_space[2, :] = np.median(camera_space[2, :])
                    vertices = (rotation.T @ (camera_space - translation)).T

            with timed_block(None, profiling,
                             ["timing", "foreground_reconstruction", "texturing",
                              index, object_id]):
                texture, uv = get_mesh_texture_and_uv(vertices, rgb, camera_matrix,
                                                      rotation, translation)
                texture_atlas.append(texture)
                uv_atlas.append(uv)

                frame_vertices = np.vstack((frame_vertices, vertices))
                frame_faces = np.vstack((frame_faces, faces + vertex_count))
                vertex_count += len(vertices)

        with timed_block(None, profiling,
                         ["timing", "foreground_reconstruction", "texture_atlas_packing", index]):
            if len(texture_atlas) == 0:
                logging.debug(f"Frame #{index + 1} produced an empty mesh.")
                return TriangleMesh()

            packed_texture, packed_uv = pack_textures(texture_atlas, uv_atlas, n_rows=1)

            return TriangleMesh(vertices=frame_vertices.astype(np.float32),
                                faces=frame_faces.astype(np.int64),
                                uv=packed_uv.astype(np.float32),
                                texture=packed_texture)

    @staticmethod
    def _create_empty_scene(dataset: HiveDataset) -> Scene:
        return Scene(camera_resolution=(dataset.frame_width, dataset.frame_height),
                     camera_focal=(dataset.fx, dataset.fy))

    # -- static mesh ----------------------------------------------------------
    @classmethod
    def create_static_mesh(cls, dataset: HiveDataset, num_frames: int = -1,
                           options=BackgroundMeshOptions(),
                           frame_set: Optional[List[int]] = None,
                           profiling: Optional[dict] = None,
                           device=None) -> TriangleMesh:
        """Reconstruct the static background mesh: TSDF fusion on the card,
        or the external BundleFusion binary."""
        from hive_tpu_torch.fusion import bundle_fusion, tsdf_fusion

        if num_frames < 1:
            num_frames = dataset.num_frames

        if frame_set is None:
            with timed_block(None, profiling, ["timing", "background_reconstruction",
                                               "key_frame_selection"]):
                frame_set = dataset.select_key_frames(
                    threshold=options.key_frame_threshold,
                    frame_step=options.key_frame_step)

        if frame_set is not None and len(frame_set) < 1:
            raise RuntimeError("`frame_set`, if not `None`, must have at least one element.")

        if options.reconstruction_method == MeshReconstructionMethod.BundleFusion:
            return bundle_fusion(cls.bundle_fusion_folder, dataset, options, num_frames)

        if options.reconstruction_method == MeshReconstructionMethod.TSDFFusion:
            return tsdf_fusion(dataset, options, num_frames, frame_set=frame_set,
                               profiling=profiling, device=device)

        raise RuntimeError(f"No reconstruction backend for method "
                           f"{options.reconstruction_method}.")

    # -- scene post-processing ------------------------------------------------
    def _center_scenes(self, dataset: HiveDataset, foreground_scene: Scene,
                       background_scene: Scene) -> Tuple[Scene, Scene]:
        """Center the scenes at the origin, upright for the renderer."""
        foreground_scene = foreground_scene.copy()
        background_scene = background_scene.copy()

        if self.background_mesh_options.reconstruction_method \
                == MeshReconstructionMethod.BundleFusion:
            background_scene = self._align_bundle_fusion_reconstruction(dataset,
                                                                        background_scene)

        # 180° z-rotation flips the scene the right way up for the renderer.
        rotate_upright = np.eye(4, dtype=np.float32)
        rotate_upright[0, 0] = -1.0
        rotate_upright[1, 1] = -1.0

        foreground_scene.apply_transform(rotate_upright)
        background_scene.apply_transform(rotate_upright)

        if self.options.align_scene:
            transform = self._ground_plane_alignment(background_scene)
            foreground_scene.apply_transform(transform)
            background_scene.apply_transform(transform)

        scene_bounds = self._get_scene_bounds(foreground_scene, background_scene)
        if scene_bounds is None:  # both scenes empty: nothing to center
            return foreground_scene, background_scene
        scene_centroid = np.mean(scene_bounds, axis=0)

        offset = np.array([-scene_centroid[0], -scene_bounds[0, 1], -scene_bounds[0, 2]])

        translation = np.eye(4, dtype=np.float32)
        translation[:3, 3] = offset

        foreground_scene.apply_transform(translation)
        background_scene.apply_transform(translation)

        return foreground_scene, background_scene

    @staticmethod
    def _ground_plane_alignment(background_scene: Scene) -> np.ndarray:
        """Estimate a transform that levels the scene with the ground plane.

        PCA of the background vertices gives the dominant plane; the smallest
        principal axis is rotated onto +y (``hive_tpu``'s
        ``Pipeline._ground_plane_alignment``, line for line).
        """
        all_vertices = [mesh.vertices for mesh in background_scene.geometry.values()
                        if len(mesh.vertices)]

        if not all_vertices:
            return np.eye(4)

        points = np.concatenate(all_vertices)
        centroid = points.mean(axis=0)
        _, _, vt = np.linalg.svd(points - centroid, full_matrices=False)

        up = vt[2]  # normal of the dominant plane
        if up[1] < 0:
            up = -up

        target = np.array([0.0, 1.0, 0.0])
        axis = np.cross(up, target)
        s = np.linalg.norm(axis)
        c = float(up @ target)

        if s < 1e-8:
            return np.eye(4)

        axis = axis / s
        K = np.array([[0, -axis[2], axis[1]],
                      [axis[2], 0, -axis[0]],
                      [-axis[1], axis[0], 0]])
        R = np.eye(3) + s * K + (1 - c) * (K @ K)

        transform = np.eye(4)
        transform[:3, :3] = R
        return transform

    def _align_bundle_fusion_reconstruction(self, dataset: HiveDataset, scene: Scene) -> Scene:
        """Undo BundleFusion's mirroring/rotation so its mesh lines up with the
        foreground (the constants of ``hive_tpu``'s
        ``Pipeline._align_bundle_fusion_reconstruction``)."""
        from scipy.spatial.transform import Rotation

        # +-inf init, tightened by observations: a zeros init would always
        # include the origin, biasing the centroid toward 0 for scenes
        # strictly one side of an axis.
        pcd_bounds = np.stack([np.full(3, np.inf), np.full(3, -np.inf)])
        poses = dataset.camera_trajectory.to_homogenous_transforms()

        for i in range(min(self.num_frames, dataset.num_frames)):
            depth_map = dataset.depth_dataset[i]
            mask = dataset.mask_dataset[i] == 0
            rotation, translation = get_pose_components(poses[i])

            points3d = point_cloud_from_depth(depth_map, mask, dataset.camera_matrix,
                                              rotation, translation)

            if len(points3d):
                pcd_bounds[0] = np.minimum(pcd_bounds[0], points3d.min(axis=0))
                pcd_bounds[1] = np.maximum(pcd_bounds[1], points3d.max(axis=0))

        if not np.isfinite(pcd_bounds).all():  # no valid points at all
            pcd_bounds = np.zeros((2, 3))
        pcd_centroid = pcd_bounds.mean(axis=0)

        aligned = scene.copy()
        aligned.apply_transform(np.diag([-1.0, 1.0, 1.0, 1.0]))

        scene_bounds = scene.bounds
        scene_centroid = (scene_bounds.mean(axis=0) if scene_bounds is not None
                          else np.zeros(3))

        transform = np.eye(4)
        transform[:3, :3] = Rotation.from_euler("xyz", [105.0, 0.0, -5.0],
                                                degrees=True).as_matrix()
        transform[:3, 3] = scene_centroid - pcd_centroid
        aligned.apply_transform(transform)
        aligned.apply_translation([1.25, 2.0, 1.0])  # empirical vertical offset fix

        return aligned

    @staticmethod
    def _get_scene_bounds(foreground_scene: Scene, background_scene: Scene) -> Optional[np.ndarray]:
        """Union of the scene bounds; either scene may be empty (bounds
        None)."""
        fg_bounds = foreground_scene.bounds
        bg_bounds = background_scene.bounds

        if fg_bounds is None:
            return bg_bounds
        if bg_bounds is None:
            return fg_bounds

        return np.stack([np.minimum(fg_bounds[0], bg_bounds[0]),
                         np.maximum(fg_bounds[1], bg_bounds[1])])

    # -- export ---------------------------------------------------------------
    @classmethod
    def _write_meshes_to_disk(cls, mesh_path: str, foreground_scene: Scene,
                              background_scene: Scene,
                              overwrite_ok: bool = False) -> Tuple[str, str]:
        os.makedirs(mesh_path, exist_ok=overwrite_ok)
        fg_path = cls._write_mesh_to_disk(mesh_path, "fg", foreground_scene)
        bg_path = cls._write_mesh_to_disk(mesh_path, "bg", background_scene)
        return fg_path, bg_path

    @classmethod
    def _write_mesh_to_disk(cls, base_folder: str, scene_name: str, scene: Scene) -> str:
        output_path = pjoin(base_folder, f"{scene_name}.glb")
        # Siblings a previous run may have left describe the OLD mesh.
        viewer_sibling = Path(output_path).with_suffix(".viewer.glb")
        for stale in (viewer_sibling, Path(output_path + ".gz"),
                      Path(str(viewer_sibling) + ".gz")):
            stale.unlink(missing_ok=True)
        export_scene(scene, output_path)
        logging.info(f"Mesh data written to {output_path}")
        return output_path

    def _compress_mesh(self, path_to_glb: str):
        """Compress a .glb: external draco_transcoder when available, else a
        native quantized re-encode (KHR_mesh_quantization — any conforming
        renderer decodes it). The ``method`` recorded in ``profiling.json``
        says which route ran. A failed compression keeps the uncompressed
        mesh and records no stats for it."""
        src_path = Path(path_to_glb)
        tmp_path = src_path.parent / f"{src_path.stem}_tmp{src_path.suffix}"

        if shutil.which("draco_transcoder") is not None:
            method = "draco"
            command = ["draco_transcoder", "-i", str(src_path), "-o", str(tmp_path)]

            with subprocess.Popen(command, stdout=subprocess.PIPE, bufsize=1,
                                  universal_newlines=True) as p:
                for line in p.stdout:
                    logging.debug(line.rstrip("\n"))

            if (return_code := p.wait()) != 0:
                logging.warning(f"draco_transcoder failed (exit status {return_code}).")
                # Same cleanup as the quantization-failure path: a partial
                # tmp write must not linger in the user-facing mesh folder.
                tmp_path.unlink(missing_ok=True)
                return

            # The dependency-free in-tree viewer decodes
            # KHR_mesh_quantization but not KHR_draco_mesh_compression, so
            # keep a quantized sibling for it (the WebXR export prefers it;
            # the canonical draco .glb stays for external renderers), plus
            # a pre-gzipped copy the viewer server ships over the wire.

            viewer_path = src_path.with_suffix(".viewer.glb")
            try:
                quantize_glb(str(src_path), str(viewer_path))
                write_gzip_sibling(str(viewer_path))
            except Exception as exc:
                logging.warning("Could not produce the in-tree-viewer copy "
                                f"of {src_path} ({exc!r}); the viewer cannot "
                                "play draco-compressed meshes.")
        else:
            method = "quantization"
            logging.info("draco_transcoder not found on PATH; compressing with "
                         "native vertex quantization (KHR_mesh_quantization).")

            try:
                quantize_glb(str(src_path), str(tmp_path))
            except Exception as exc:
                # Same degradation contract as a failed draco transcode: keep
                # the uncompressed mesh, never abort a finished reconstruction.
                logging.warning(f"Native mesh compression failed ({exc!r}); "
                                "keeping the uncompressed mesh.")
                tmp_path.unlink(missing_ok=True)
                return

        size_before = os.path.getsize(src_path)
        size_after = os.path.getsize(tmp_path)

        data_saving = 1 - size_after / size_before
        compression_ratio = size_before / size_after

        shutil.move(tmp_path, src_path)

        stats = {
            "uncompressed_file_size": size_before,
            "compressed_file_size": size_after,
            "data_saving": data_saving,
            "compression_ratio": compression_ratio,
            "method": method,
        }

        if method == "quantization":
            # Transfer-side half of the native fallback: a deterministic
            # pre-gzipped sibling the viewer server ships with
            # Content-Encoding: gzip (browsers decode transparently), while
            # the on-disk .glb stays a plain conforming KHR_mesh_quantization
            # file.
            try:
                gzip_size = write_gzip_sibling(str(src_path))
            except OSError as exc:
                logging.warning(f"Could not write {src_path}.gz ({exc!r}).")
            else:
                stats["gzip_file_size"] = gzip_size
                stats["gzip_transfer_ratio"] = size_before / gzip_size

        logging.info(f"Compressed {src_path} with {method} successfully "
                     f"({format_bytes(size_before)} before, {format_bytes(size_after)} after, "
                     f"{data_saving * 100:.2f}% data saving, "
                     f"ratio {compression_ratio:.2f}:1"
                     + (f"; wire ratio {stats['gzip_transfer_ratio']:.2f}:1 "
                        f"via the gzip sibling"
                        if "gzip_file_size" in stats else "") + ").")

        name = {"fg": "foreground", "bg": "background"}.get(src_path.stem, src_path.stem)

        set_key_path(self.profiling, ["mesh_compression", name], stats)

    @staticmethod
    def _get_dataset_name(dataset: HiveDataset) -> str:
        return Path(str(dataset.base_path)).name

    def _get_webxr_metadata(self, dataset: HiveDataset) -> dict:
        return dict(
            fps=dataset.fps,
            fov_y=int(dataset.fov_y),
            num_frames=self.num_frames,
            use_vertex_colour_for_bg=(self.background_mesh_options.reconstruction_method
                                      != MeshReconstructionMethod.RGBD),
            add_ground_plane=self.webxr_options.webxr_add_ground_plane,
            add_sky_box=self.webxr_options.webxr_add_sky_box,
        )

    def _export_video_webxr(self, mesh_path: str, fg_scene_name: str, bg_scene_name: str,
                            metadata: dict, export_name: str) -> str:
        webxr_output_path = pjoin(self.webxr_options.webxr_path, export_name)
        os.makedirs(webxr_output_path, exist_ok=True)

        metadata_filename = "metadata.json"
        metadata_path = pjoin(mesh_path, metadata_filename)

        with open(metadata_path, "w") as f:
            json.dump(metadata, f)

        for filename in (metadata_filename, f"{fg_scene_name}.glb", f"{bg_scene_name}.glb"):
            # Prefer the quantized in-tree-viewer sibling a draco transcode
            # leaves behind — the viewer that serves this folder cannot
            # decode KHR_draco (see _compress_mesh).
            viewer_copy = pjoin(mesh_path, filename.removesuffix(".glb") + ".viewer.glb")
            src = viewer_copy if (filename.endswith(".glb")
                                  and os.path.isfile(viewer_copy)) else pjoin(mesh_path, filename)
            shutil.copy(src, pjoin(webxr_output_path, filename))
            # Ship the pre-gzipped copy alongside, and drop a stale one.
            dest_gz = pjoin(webxr_output_path, filename + ".gz")
            if os.path.isfile(src + ".gz"):
                shutil.copy(src + ".gz", dest_gz)
            else:
                Path(dest_gz).unlink(missing_ok=True)

        logging.info(f"WebXR assets written to {webxr_output_path}")
        return webxr_output_path

    # -- summary / profiling --------------------------------------------------
    def _print_summary(self, foreground_scene: Scene, background_scene: Scene,
                       foreground_scene_path: str, background_scene_path: str,
                       elapsed_time_seconds: float):
        fg_num_tris, num_fg_frames = foreground_scene.count_triangles()
        bg_num_tris, num_bg_frames = background_scene.count_triangles()

        total_num_tris = fg_num_tris + bg_num_tris
        fg_tris_per_frame = fg_num_tris / num_fg_frames if num_fg_frames > 0 else 0
        bg_tris_per_frame = bg_num_tris / num_bg_frames if num_bg_frames > 0 else 0
        tris_per_frame = fg_tris_per_frame + bg_tris_per_frame

        fg_file_size = os.path.getsize(foreground_scene_path)
        bg_file_size = os.path.getsize(background_scene_path)
        total_file_size = fg_file_size + bg_file_size

        fg_size_per_frame = fg_file_size // num_fg_frames if num_fg_frames > 0 else 0
        bg_size_per_frame = bg_file_size // num_bg_frames if num_bg_frames > 0 else 0
        size_per_frame = fg_size_per_frame + bg_size_per_frame

        elapsed = datetime.timedelta(seconds=elapsed_time_seconds)
        per_frame = datetime.timedelta(seconds=elapsed_time_seconds / max(self.num_frames, 1))

        self.profiling["frame_count"] = {
            "total": self.num_frames,
            "foreground": num_fg_frames,
            "background": num_bg_frames,
        }
        self.profiling["elapsed_time"] = {
            "total": elapsed.total_seconds(),
            "per_frame": per_frame.total_seconds(),
        }
        self.profiling["file_size"] = {
            "total": total_file_size,
            "per_frame": size_per_frame,
            "foreground": {"total": fg_file_size, "per_frame": fg_size_per_frame},
            "background": {"total": bg_file_size, "per_frame": bg_size_per_frame},
        }

        self.profiling["peak_vram_usage"] = self._get_peak_device_memory()
        self.profiling["device"] = (torch.cuda.get_device_name(self.device)
                                    if self.device.type == "cuda" else "cpu")

        try:
            # ru_maxrss is kilobytes on Linux.
            self.profiling["peak_ram_usage"] = \
                resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1000
        except OSError:
            logging.error(traceback.format_exc())
            self.profiling["peak_ram_usage"] = 0

        self.profiling["mesh_tri_count"] = {
            "total": total_num_tris,
            "per_frame": tris_per_frame,
            "foreground": {"total": fg_num_tris, "per_frame": fg_tris_per_frame},
            "background": {"total": bg_num_tris, "per_frame": bg_tris_per_frame},
        }

        vram = self.profiling["peak_vram_usage"]

        logging.info("#" + "=" * 78 + "#")
        logging.info("#" + " " * 36 + "Summary" + " " * 35 + "#")
        logging.info("#" + "=" * 78 + "#")
        logging.info(f"{self.num_frames} frames done ({num_fg_frames} fg / "
                     f"{num_bg_frames} bg) in {elapsed} - {per_frame} each.")
        logging.info(f"    Triangles (all meshes): {total_num_tris:>9,d} "
                     f"- {tris_per_frame:,.1f}/frame")
        logging.info(f"        foreground: {fg_num_tris:>9,d} "
                     f"- {fg_tris_per_frame:,.1f}/frame")
        logging.info(f"        background: {bg_num_tris:>9,d} "
                     f"- {bg_tris_per_frame:,.1f}/frame")
        logging.info(f"    On-disk mesh size: {format_bytes(total_file_size)} "
                     f"- {format_bytes(size_per_frame)}/frame")
        logging.info(f"        foreground: {format_bytes(fg_file_size)} "
                     f"- {format_bytes(fg_size_per_frame)}/frame")
        logging.info(f"        background: {format_bytes(bg_file_size)} "
                     f"- {format_bytes(bg_size_per_frame)}/frame")
        logging.info(f"Peak Device Memory Usage: {format_bytes(vram['allocated'])} "
                     f"({vram['allocated']:,d} Bytes)")

    def _write_profiling_data(self, path: str):
        """Write ``profiling.json``, with the per-frame, per-object
        foreground timings and decimation counts rolled up into
        count/total/mean."""
        profiling = self._calculate_profiling_statistics(self.profiling)

        with open(path, "w") as f:
            json.dump(profiling, f)

    def _calculate_profiling_statistics(self, profiling: dict) -> dict:
        """Roll per-frame/per-object timing trees up into count/total/mean.

        Output schema matches ``hive_tpu``'s ``profiling.json``, the
        benchmark contract consumed by the experiments harness.
        """
        key_paths = [
            ["timing", "foreground_reconstruction", "binary_mask_creation"],
            ["timing", "foreground_reconstruction", "per_object_mesh", "total"],
            ["timing", "foreground_reconstruction", "per_object_mesh", "face_triangulation"],
            ["timing", "foreground_reconstruction", "face_filtering"],
            ["timing", "foreground_reconstruction", "mesh_decimation"],
            ["timing", "foreground_reconstruction", "floater_removal"],
            ["timing", "foreground_reconstruction", "billboard"],
            ["timing", "foreground_reconstruction", "texturing"],
            ["timing", "foreground_reconstruction", "texture_atlas_packing"],
            ["mesh_decimation", "vertex_count", "before"],
            ["mesh_decimation", "vertex_count", "after"],
            ["mesh_decimation", "face_count", "before"],
            ["mesh_decimation", "face_count", "after"],
        ]

        result = profiling.copy()

        for key_path in key_paths:
            try:
                entry = get_key_path(result, key_path)
            except KeyError:
                continue

            count, total = self._traverse_dictionary(entry)
            set_key_path(result, key_path, {
                "count": count,
                "total": total,
                "mean": total / count if count > 0 else 0.0,
            })

        return result

    def _traverse_dictionary(self, node: Union[dict, Any], count: int = 0, total: float = 0):
        if isinstance(node, (float, int)):
            return 1, node

        if not isinstance(node, dict):
            return count, total

        for key in node:
            sub_count, sub_total = self._traverse_dictionary(node[key])
            count += sub_count
            total += sub_total

        return count, total


def main(argv=None):
    Pipeline.from_command_line(argv).run()


if __name__ == "__main__":
    main()
