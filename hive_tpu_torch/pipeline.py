"""End-to-end pipeline: RGB-D sequence → bg.glb + metadata, on the card.

Counterpart of ``hive_tpu/pipeline.py``'s background path: ``run``,
``_create_background_scene``, ``create_static_mesh``, ``_center_scenes``
(non-BundleFusion branch), ``_write_meshes_to_disk``,
``_compress_with_draco`` (the quantize branch), the WebXR export and
``profiling.json``. The CLI flag roster is the JAX package's; options whose
stages are not ported yet raise ``NotImplementedError`` naming the ROADMAP
item that ports them.
"""

from __future__ import annotations

import argparse
import datetime
import json
import logging
import os
import resource
import shutil
import time
import traceback
from contextlib import contextmanager
from os.path import join as pjoin
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
import torch

from hive_tpu_torch import get_device
from hive_tpu_torch.io import HiveDataset
from hive_tpu_torch.meshing.gltf import export_scene
from hive_tpu_torch.meshing.mesh import Scene, TriangleMesh
from hive_tpu_torch.options import (BackgroundMeshOptions, COLMAPOptions,
                                    ForegroundTrajectorySmoothingOptions, InpaintingMode,
                                    MaskDilationOptions, MeshDecimationOptions,
                                    MeshFilteringOptions, MeshReconstructionMethod,
                                    PipelineOptions, StorageOptions, WebXROptions)
from hive_tpu_torch.utils import format_bytes, set_key_path, setup_logger, timed_block


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported to hive_tpu_torch yet "
                               f"(ROADMAP.md {item}); use hive_tpu for it.")


class Pipeline:
    """Converts an RGB-D sequence with known poses into a 3D mesh video
    (background reconstruction in this slice)."""

    mesh_folder = "mesh"

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
            device=device,
        )

    # -- properties ----------------------------------------------------------
    @property
    def num_frames(self) -> int:
        return self.options.num_frames

    @property
    def mesh_path(self) -> str:
        return pjoin(str(self.storage_options.output_path), self.mesh_folder)

    @contextmanager
    def timed_block(self, log_msg: Optional[str], key_path: list):
        with timed_block(log_msg=log_msg, profiling=self.profiling, key_path=key_path) as timer:
            yield timer

    def _check_ported(self):
        """Refuse the options whose stages this slice does not port."""
        if not self.options.background_only:
            raise _not_ported("Foreground meshing (run with --background_only)",
                              "Queue 1 item 8")
        if self.options.estimate_pose:
            raise _not_ported("--estimate_pose", "Queue 1 item 12")
        if self.options.estimate_depth:
            raise _not_ported("--estimate_depth", "Queue 1 item 10")
        if self.options.inpainting_mode != InpaintingMode.Off:
            raise _not_ported("--inpainting_mode", "Queue 1 item 11")
        if self.options.num_devices != 1:
            raise _not_ported("--num_devices", "Queue 1 item 14")
        if self.options.align_scene:
            raise _not_ported("--align_scene", "Queue 1 item 8")
        if self.fts_options.num_epochs > 0:
            raise _not_ported("Foreground trajectory smoothing", "Queue 1 item 12")
        if self.background_mesh_options.reconstruction_method \
                != MeshReconstructionMethod.TSDFFusion:
            raise _not_ported(f"--mesh_reconstruction_method "
                              f"{self.background_mesh_options.reconstruction_method.name}",
                              "Queue 1 item 8")
        if self.webxr_options.webxr_run_server:
            raise _not_ported("--webxr_run_server (the viewer)", "Queue 1 item 14")

    # -- main entry ----------------------------------------------------------
    def run(self, dataset: Optional[HiveDataset] = None, compress: bool = True):
        """Run the pipeline.

        :param dataset: Use this dataset instead of loading from CLI options.
        :param compress: Whether to compress the exported meshes.
        """
        self._check_ported()
        start_time = time.time()
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)

        with self.timed_block("Loading dataset...", ["timing", "load_dataset", "total"]):
            if dataset is None:
                dataset = self.get_dataset()

            if self.num_frames == -1:
                self.options.num_frames = dataset.num_frames
            else:
                self.options.num_frames = min(self.num_frames, dataset.num_frames)

        # The foreground stage is empty under --background_only; the stages
        # run one after the other.
        set_key_path(self.profiling, ["timing", "stages_overlapped"], False)

        with self.timed_block("Reconstructing the static background...",
                              ["timing", "background_reconstruction", "total"]):
            background_scene = self._create_background_scene(dataset)

        with self.timed_block("Meshing the dynamic foreground...",
                              ["timing", "foreground_reconstruction", "total"]):
            foreground_scene = self._create_empty_scene(dataset)

        with self.timed_block("Recentring the foreground/background scenes...",
                              ["timing", "scene_centering"]):
            foreground_scene, background_scene = self._center_scenes(
                foreground_scene, background_scene)

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

    def get_dataset(self) -> HiveDataset:
        """The HIVE-format dataset named on the command line. As in
        ``hive_tpu``, a converted dataset is looked up at ``--output_path``;
        converting other formats (TUM, Unreal, StrayScanner, video) is not
        ported yet."""
        output_path = self.storage_options.output_path
        if not self.storage_options.no_cache and HiveDataset.is_valid_folder_structure(output_path):
            return HiveDataset(output_path)
        raise _not_ported(f"Converting {self.storage_options.dataset_path} "
                          f"(no HIVE-format dataset at {output_path})",
                          "Queue 1 item 9")

    # -- device stats ---------------------------------------------------------
    def _get_peak_device_memory(self) -> dict:
        """Peak device memory in bytes (torch's caching allocator)."""
        if self.device.type != "cuda":
            return {"allocated": 0, "reserved": 0}
        return {"allocated": int(torch.cuda.max_memory_allocated(self.device)),
                "reserved": int(torch.cuda.max_memory_reserved(self.device))}

    # -- scene creation -------------------------------------------------------
    def _create_background_scene(self, dataset: HiveDataset) -> Scene:
        background_scene = self._create_empty_scene(dataset)
        static_mesh = self.create_static_mesh(dataset, num_frames=self.num_frames,
                                              options=self.background_mesh_options,
                                              profiling=self.profiling,
                                              device=self.device)

        # The renderer expects sRGB for vertex-coloured meshes.
        if static_mesh.vertex_colors is not None:
            rgb = static_mesh.vertex_colors[:, :3].astype(np.float64)
            static_mesh.vertex_colors[:, :3] = (255 * np.power(rgb / 255, 2.2)).astype(np.uint8)

        background_scene.add_geometry(static_mesh, node_name="000000")
        return background_scene

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
        """Reconstruct the static background mesh by TSDF fusion."""
        from hive_tpu_torch.fusion import tsdf_fusion

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

        if options.reconstruction_method != MeshReconstructionMethod.TSDFFusion:
            raise _not_ported(f"Reconstruction method {options.reconstruction_method.name}",
                              "Queue 1 item 8")

        return tsdf_fusion(dataset, options, num_frames, frame_set=frame_set,
                           profiling=profiling, device=device)

    # -- scene post-processing ------------------------------------------------
    def _center_scenes(self, foreground_scene: Scene,
                       background_scene: Scene) -> Tuple[Scene, Scene]:
        """Center the scenes at the origin, upright for the renderer."""
        foreground_scene = foreground_scene.copy()
        background_scene = background_scene.copy()

        # 180° z-rotation flips the scene the right way up for the renderer.
        rotate_upright = np.eye(4, dtype=np.float32)
        rotate_upright[0, 0] = -1.0
        rotate_upright[1, 1] = -1.0

        foreground_scene.apply_transform(rotate_upright)
        background_scene.apply_transform(rotate_upright)

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
    def _get_scene_bounds(foreground_scene: Scene, background_scene: Scene) -> Optional[np.ndarray]:
        """Union of the scene bounds; either scene may be empty."""
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
        """Compress a .glb with the native quantized re-encode
        (KHR_mesh_quantization) plus a pre-gzipped sibling: the JAX package's
        fallback when ``draco_transcoder`` is absent. The draco route is not
        ported yet (ROADMAP.md Queue 1 item 8)."""
        from hive_tpu_torch.meshing.gltf import quantize_glb, write_gzip_sibling

        src_path = Path(path_to_glb)
        tmp_path = src_path.parent / f"{src_path.stem}_tmp{src_path.suffix}"
        method = "quantization"

        try:
            quantize_glb(str(src_path), str(tmp_path))
        except Exception as exc:
            # Keep the uncompressed mesh, never abort a finished reconstruction.
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

        try:
            gzip_size = write_gzip_sibling(str(src_path))
        except OSError as exc:
            logging.warning(f"Could not write {src_path}.gz ({exc!r}).")
        else:
            stats["gzip_file_size"] = gzip_size
            stats["gzip_transfer_ratio"] = size_before / gzip_size

        logging.info(f"Compressed {src_path} with {method} "
                     f"({format_bytes(size_before)} before, {format_bytes(size_after)} after, "
                     f"ratio {compression_ratio:.2f}:1).")

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
            src = pjoin(mesh_path, filename)
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
        logging.info(f"    On-disk mesh size: {format_bytes(total_file_size)} "
                     f"- {format_bytes(size_per_frame)}/frame")
        logging.info(f"Peak Device Memory Usage: {format_bytes(vram['allocated'])} "
                     f"({vram['allocated']:,d} Bytes)")

    def _write_profiling_data(self, path: str):
        """Write ``profiling.json``. The JAX package also rolls per-frame
        foreground timings up into count/total/mean; the background path
        records none, so its file is written as collected."""
        with open(path, "w") as f:
            json.dump(self.profiling, f)


def main(argv=None):
    Pipeline.from_command_line(argv).run()


if __name__ == "__main__":
    main()
