"""The configuration/flag system.

The public CLI contract (flag names, defaults, JSON round-trips) matches the
reference (hive/options.py:44-689) so that existing HIVE invocations work
unchanged; the implementation is dataclass-based.
"""

from __future__ import annotations

import argparse
import dataclasses
import enum
from typing import Dict, List, Optional

import numpy as np

from hive_tpu_torch.custom_types import File


class Options:
    """Option groups know how to (a) register CLI flags and (b) build themselves
    from a parsed namespace. Groups are plain dataclasses otherwise."""

    @staticmethod
    def add_args(parser: argparse.ArgumentParser):
        raise NotImplementedError

    @staticmethod
    def from_args(args: argparse.Namespace) -> "Options":
        raise NotImplementedError


@dataclasses.dataclass
class StorageOptions(Options):
    """Input/output locations and cache behaviour. (ref hive/options.py:70-104)"""

    dataset_path: File
    output_path: File
    overwrite_ok: bool = False
    no_cache: bool = False

    @staticmethod
    def add_args(parser: argparse.ArgumentParser):
        group = parser.add_argument_group("Storage Options")
        group.add_argument("--dataset_path", type=str, required=True,
                           help="Root folder of the input dataset (holds the rgb/ and depth/ subfolders).")
        group.add_argument("--output_path", type=str, required=True,
                           help="Directory where all outputs are written.")
        group.add_argument("--overwrite_ok", action="store_true",
                           help="Allow clobbering any mesh data already present in the "
                                "output/export directories.")
        group.add_argument("--no_cache", action="store_true",
                           help="Ignore any cached datasets/results and recompute from scratch.")

    @staticmethod
    def from_args(args) -> "StorageOptions":
        return StorageOptions(dataset_path=args.dataset_path, output_path=args.output_path,
                              overwrite_ok=args.overwrite_ok, no_cache=args.no_cache)


@dataclasses.dataclass
class COLMAPOptions(Options):
    """Settings for the (optional, external) COLMAP SfM tool. (ref hive/options.py:107-207)"""

    QUALITY_CHOICES = ("low", "medium", "high", "extreme")

    is_single_camera: bool = True
    single_camera_per_folder: bool = False
    dense: bool = False
    quality: str = "low"
    binary_path: str = "/usr/local/bin/colmap"
    vocab_path: str = "~/.cache/colmap/vocab.bin"

    def __post_init__(self):
        if self.quality not in COLMAPOptions.QUALITY_CHOICES:
            raise ValueError(f"Quality must be one of {COLMAPOptions.QUALITY_CHOICES}, "
                             f"got {self.quality}.")

    @staticmethod
    def add_args(parser: argparse.ArgumentParser):
        group = parser.add_argument_group("COLMAP Options")
        group.add_argument("--multiple_cameras", action="store_true",
                           help="Set when the footage comes from several camera devices, or from one "
                                "device whose per-frame settings (e.g. focal length) vary.")
        group.add_argument("--single_camera_per_folder", action="store_true",
                           help="Tell COLMAP the frames are organised into per-camera sub-folders "
                                "(e.g. stereo rigs).")
        group.add_argument("--dense", action="store_true", help="Also run COLMAP dense reconstruction.")
        group.add_argument("--quality", type=str, default="low",
                           choices=COLMAPOptions.QUALITY_CHOICES,
                           help="COLMAP reconstruction quality preset.")
        group.add_argument("--binary_path", type=str, default="/usr/local/bin/colmap",
                           help="Location of the COLMAP executable.")
        group.add_argument("--vocab_path", type=str, default="~/.cache/colmap/vocab.bin",
                           help="Location of the COLMAP vocabulary-tree file (~ is the "
                                "user's home).")

    @staticmethod
    def from_args(args: argparse.Namespace) -> "COLMAPOptions":
        return COLMAPOptions(is_single_camera=not args.multiple_cameras,
                             single_camera_per_folder=args.single_camera_per_folder,
                             dense=args.dense, quality=args.quality,
                             binary_path=args.binary_path, vocab_path=args.vocab_path)

    def copy(self) -> "COLMAPOptions":
        return dataclasses.replace(self)

    def to_json(self) -> dict:
        return dict(binary_path=self.binary_path, vocab_path=self.vocab_path,
                    is_single_camera=self.is_single_camera,
                    single_camera_per_folder=self.single_camera_per_folder,
                    dense=self.dense, quality=self.quality)

    @classmethod
    def from_json(cls, json_dict: dict) -> "COLMAPOptions":
        return COLMAPOptions(
            binary_path=str(json_dict["binary_path"]),
            vocab_path=str(json_dict["vocab_path"]),
            is_single_camera=bool(json_dict["is_single_camera"]),
            # Default keeps datasets created before this key existed loadable.
            single_camera_per_folder=bool(json_dict.get("single_camera_per_folder", False)),
            dense=bool(json_dict["dense"]),
            quality=str(json_dict["quality"]),
        )


@dataclasses.dataclass
class MeshDecimationOptions(Options):
    """Targets for mesh simplification. (ref hive/options.py:210-242)"""

    num_faces_background: int = 2 ** 14
    num_faces_object: int = 2 ** 10
    max_error: float = 0.001

    @staticmethod
    def add_args(parser: argparse.ArgumentParser):
        group = parser.add_argument_group("Mesh decimation")
        group.add_argument("--num_faces_background", type=int, default=2 ** 14,
                           help="Decimation face budget for the background mesh.")
        group.add_argument("--num_faces_object", type=int, default=2 ** 10,
                           help="Decimation face budget for each foreground object mesh.")
        group.add_argument("--decimation_max_error", type=float, default=0.001,
                           help="Maximum quadric error allowed when collapsing an edge.")

    @staticmethod
    def from_args(args) -> "MeshDecimationOptions":
        return MeshDecimationOptions(num_faces_background=args.num_faces_background,
                                     num_faces_object=args.num_faces_object,
                                     max_error=args.decimation_max_error)


@dataclasses.dataclass
class MaskDilationOptions(Options):
    """Mask dilation settings for :func:`hive_tpu_torch.image_processing.dilate_mask`.
    (ref hive/options.py:245-268)"""

    num_iterations: int = 0
    filter_size: int = 3

    @property
    def filter(self) -> np.ndarray:
        # A rectangular structuring element, equivalent to
        # cv2.getStructuringElement(cv2.MORPH_RECT, (filter_size, filter_size)).
        return np.ones((self.filter_size, self.filter_size), dtype=np.uint8)

    @staticmethod
    def add_args(parser: argparse.ArgumentParser):
        group = parser.add_argument_group("Mask dilation")
        group.add_argument("--dilate_mask_iter", type=int, default=0,
                           help="How many dilation passes to apply to the object masks; larger values "
                                "grow the masks, 0 leaves them untouched.")

    @staticmethod
    def from_args(args) -> "MaskDilationOptions":
        return MaskDilationOptions(num_iterations=args.dilate_mask_iter)


@dataclasses.dataclass
class MeshFilteringOptions(Options):
    """Face-filtering thresholds. (ref hive/options.py:271-306)"""

    max_pixel_distance: float = 2
    max_depth_distance: float = 0.1
    min_num_components: float = 5
    triangulation: str = "grid"

    @staticmethod
    def add_args(parser: argparse.ArgumentParser):
        group = parser.add_argument_group("Mesh filtering")
        group.add_argument("--max_depth_dist", type=float, default=0.1,
                           help="Faces whose vertices differ in depth by more than this are filtered out.")
        group.add_argument("--max_pixel_dist", type=float, default=2,
                           help="Faces whose vertices are further apart than this (in pixels) are filtered out.")
        group.add_argument("--min_num_components", type=float, default=5,
                           help="Mesh fragments with fewer connected faces than this are culled as floaters.")
        group.add_argument("--triangulation", type=str, default="grid",
                           choices=["grid", "delaunay"],
                           help="Per-frame depth meshing strategy: vectorised pixel-grid "
                                "quads (default; matches Delaunay + filtering on hole-free "
                                "regions but drops faces bridging isolated invalid pixels) "
                                "or Delaunay triangulation.")

    @staticmethod
    def from_args(args) -> "MeshFilteringOptions":
        return MeshFilteringOptions(max_pixel_distance=args.max_pixel_dist,
                                    max_depth_distance=args.max_depth_dist,
                                    min_num_components=args.min_num_components,
                                    triangulation=args.triangulation)


class MeshReconstructionMethod(enum.Enum):
    """Background-mesh reconstruction algorithms. (ref hive/options.py:310-350)"""

    TSDFFusion = enum.auto()
    BundleFusion = enum.auto()
    RGBD = enum.auto()

    @classmethod
    def get_cli_names(cls) -> Dict["MeshReconstructionMethod", str]:
        return {cls.TSDFFusion: "tsdf_fusion", cls.BundleFusion: "bundle_fusion", cls.RGBD: "rgbd"}

    def get_cli_name(self) -> str:
        return self.get_cli_names()[self]

    @classmethod
    def get_choices(cls) -> Dict[str, "MeshReconstructionMethod"]:
        return {name: method for method, name in cls.get_cli_names().items()}

    @classmethod
    def from_string(cls, name: str) -> "MeshReconstructionMethod":
        choices = cls.get_choices()

        if name.lower() in choices:
            return choices[name.lower()]

        raise RuntimeError(f"Unknown reconstruction method {name!r}; choose one of {list(choices)}")


@dataclasses.dataclass
class BackgroundMeshOptions(Options):
    """Static background reconstruction settings. (ref hive/options.py:353-439)"""

    reconstruction_method: MeshReconstructionMethod = MeshReconstructionMethod.TSDFFusion
    depth_mask_dilation_iterations: int = 10
    sdf_volume_size: float = 5.0
    sdf_voxel_size: float = 0.005
    sdf_max_voxels: Optional[int] = 320_000_000
    key_frame_threshold: float = 0.3
    key_frame_step: int = 30

    SUPPORTED_RECONSTRUCTION_METHODS = (MeshReconstructionMethod.TSDFFusion,
                                        MeshReconstructionMethod.BundleFusion,
                                        MeshReconstructionMethod.RGBD)

    def __post_init__(self):
        if self.reconstruction_method not in self.SUPPORTED_RECONSTRUCTION_METHODS:
            raise ValueError(f"Reconstruction method must be one of "
                             f"{[m.name for m in self.SUPPORTED_RECONSTRUCTION_METHODS]}, "
                             f"got {self.reconstruction_method}.")

        if not (isinstance(self.depth_mask_dilation_iterations, int)
                and self.depth_mask_dilation_iterations >= 0):
            raise ValueError("depth_mask_dilation_iterations must be a non-negative integer.")

        if self.sdf_volume_size <= 0.0 or self.sdf_voxel_size <= 0.0:
            raise ValueError("SDF volume/voxel sizes must be positive.")

        if self.sdf_max_voxels is not None and self.sdf_max_voxels <= 0:
            raise ValueError("sdf_max_voxels must be a positive integer or None.")

        if not (0.0 <= self.key_frame_threshold <= 1.0):
            raise ValueError(f"The key-frame threshold {self.key_frame_threshold} is outside "
                             f"the valid range [0, 1].")

        if not (isinstance(self.key_frame_step, int) and self.key_frame_step > 1):
            raise ValueError(f"Key frame step must be an integer > 1, got {self.key_frame_step}.")

    @staticmethod
    def add_args(parser: argparse.ArgumentParser):
        group = parser.add_argument_group("Static Mesh Options")
        group.add_argument("--mesh_reconstruction_method", type=str, default="tsdf_fusion",
                           choices=[m.get_cli_name()
                                    for m in BackgroundMeshOptions.SUPPORTED_RECONSTRUCTION_METHODS],
                           help="Algorithm used to reconstruct the static background mesh.")
        group.add_argument("--depth_mask_dilation_iterations", type=int, default=10,
                           help="Dilation passes applied to the dynamic-object masks before they mask "
                                "the depth maps.")
        group.add_argument("--sdf_volume_size", type=float, default=5.0,
                           help="Edge length of the SDF volume in metres; ignored by `tsdf_fusion`, "
                                "which derives the volume bounds from the input frames.")
        group.add_argument("--sdf_voxel_size", type=float, default=0.005,
                           help="Edge length of one SDF voxel, in metres.")
        group.add_argument("--sdf_max_voxels", type=int, default=320_000_000,
                           help="Voxel-count budget for `tsdf_fusion`: when the scene would exceed it, "
                                "the voxel size is grown until the volume fits.")
        group.add_argument("--key_frame_threshold", type=float, default=0.3,
                           help="Frames whose view overlap with the chosen key frames exceeds this "
                                "ratio are dropped from the key-frame set.")
        group.add_argument("--key_frame_step", type=int, default=30,
                           help="Stride between frames considered for key-frame selection.")

    @staticmethod
    def from_args(args: argparse.Namespace) -> "BackgroundMeshOptions":
        return BackgroundMeshOptions(
            reconstruction_method=MeshReconstructionMethod.from_string(args.mesh_reconstruction_method),
            depth_mask_dilation_iterations=args.depth_mask_dilation_iterations,
            sdf_volume_size=args.sdf_volume_size,
            sdf_voxel_size=args.sdf_voxel_size,
            sdf_max_voxels=args.sdf_max_voxels,
            key_frame_threshold=args.key_frame_threshold,
            key_frame_step=int(args.key_frame_step),
        )


@dataclasses.dataclass
class ForegroundTrajectorySmoothingOptions(Options):
    """Settings for the foreground-trajectory smoothing optimiser. (ref hive/options.py:442-466)"""

    learning_rate: float = 1e-5
    num_epochs: int = 0

    @staticmethod
    def add_args(parser: argparse.ArgumentParser):
        group = parser.add_argument_group("Foreground trajectory smoothing")
        group.add_argument("--fts_learning_rate", type=float, default=1e-5,
                           help="Per-epoch step size used while smoothing the trajectory.")
        group.add_argument("--fts_num_epochs", type=int, default=0,
                           help="Smoothing iteration count; 0 turns foreground trajectory smoothing off.")

    @staticmethod
    def from_args(args: argparse.Namespace) -> "ForegroundTrajectorySmoothingOptions":
        return ForegroundTrajectorySmoothingOptions(learning_rate=args.fts_learning_rate,
                                                    num_epochs=args.fts_num_epochs)


@dataclasses.dataclass
class WebXROptions(Options):
    """WebXR export/renderer settings. (ref hive/options.py:469-527)"""

    webxr_source_path: str = "third_party/HIVE_Renderer"
    webxr_path: str = "third_party/HIVE_Renderer/docs/video"
    webxr_url: str = "http://localhost:8080"
    webxr_add_ground_plane: bool = False
    webxr_add_sky_box: bool = False
    webxr_run_server: bool = False

    @staticmethod
    def add_args(parser: argparse.ArgumentParser):
        group = parser.add_argument_group("WebXR")
        group.add_argument("--webxr_source_path", type=str, default="third_party/HIVE_Renderer",
                           help="Checkout location of the renderer source tree.")
        group.add_argument("--webxr_path", type=str, default="third_party/HIVE_Renderer/docs/video",
                           help="Destination directory for the exported 3D-video files.")
        group.add_argument("--webxr_url", type=str, default="http://localhost:8080",
                           help="URL at which the WebXR 3D-video player is served.")
        group.add_argument("--webxr_add_ground_plane", action="store_true",
                           help="Have the renderer draw a white ground plane under the scene.")
        group.add_argument("--webxr_add_sky_box", action="store_true",
                           help="Have the renderer draw a sky cube map behind the scene.")
        group.add_argument("--webxr_run_server", action="store_true",
                           help="Launch the viewer web server automatically after export.")

    @staticmethod
    def from_args(args: argparse.Namespace) -> "WebXROptions":
        return WebXROptions(webxr_source_path=args.webxr_source_path, webxr_path=args.webxr_path,
                            webxr_url=args.webxr_url,
                            webxr_add_ground_plane=args.webxr_add_ground_plane,
                            webxr_add_sky_box=args.webxr_add_sky_box,
                            webxr_run_server=args.webxr_run_server)

    def copy(self) -> "WebXROptions":
        return dataclasses.replace(self)


class InpaintingMode(enum.Flag):
    """Which inpainting backend to use for RGB and depth. The CLI uses the integer
    codes 0-4 (ref hive/options.py:530-582)."""

    Off = 0
    CV2_Image = enum.auto()
    CV2_Depth = enum.auto()
    Lama_Image = enum.auto()
    Lama_Depth = enum.auto()

    CV2_Image_Depth = CV2_Image | CV2_Depth
    Lama_Image_CV2_Depth = Lama_Image | CV2_Depth
    CV2_Image_Lama_Depth = CV2_Image | Lama_Depth
    Lama_Image_Depth = Lama_Image | Lama_Depth

    @classmethod
    def get_modes(cls) -> List["InpaintingMode"]:
        return [cls.Off, cls.CV2_Image_Depth, cls.Lama_Image_CV2_Depth,
                cls.CV2_Image_Lama_Depth, cls.Lama_Image_Depth]

    def to_integer(self) -> int:
        try:
            return self.get_modes().index(self)
        except ValueError:
            raise RuntimeError(f"{self!r} is a combined flag without its own integer code; "
                               f"codes exist only for {self.get_modes()}.")

    @classmethod
    def from_integer(cls, value: int) -> "InpaintingMode":
        modes = cls.get_modes()

        if 0 <= value < len(modes):
            return modes[value]

        raise RuntimeError(f"Unrecognised integer value {value} for {cls.__name__}, "
                           f"expected one of {list(range(len(modes)))}.")

    @classmethod
    def get_name(cls, value: int) -> str:
        return cls.from_integer(value).name

    @classmethod
    def get_modes_as_integer(cls) -> List[int]:
        return list(range(len(cls.get_modes())))


@dataclasses.dataclass
class PipelineOptions(Options):
    """Core pipeline behaviour flags. (ref hive/options.py:585-689)"""

    num_frames: int = -1
    frame_step: int = 15
    estimate_pose: bool = False
    estimate_depth: bool = False
    background_only: bool = False
    static_camera: bool = False
    align_scene: bool = False
    inpainting_mode: InpaintingMode = InpaintingMode.Off
    billboard: bool = False
    disable_scaling: bool = False
    disable_coverage_constraint: bool = False
    log_file: str = "logs.log"
    num_devices: int = 1

    @staticmethod
    def add_args(parser: argparse.ArgumentParser):
        group = parser.add_argument_group("Pipeline")
        group.add_argument("--num_frames", type=int, default=-1,
                           help="Cap on the number of frames processed; -1 (default) means every frame.")
        group.add_argument("--frame_step", type=int, default=15,
                           help="Stride for the frames fed to COLMAP and the pose optimiser: 1 uses "
                                "every frame, n > 1 takes every n-th frame.")
        group.add_argument("--estimate_pose", action="store_true",
                           help="Estimate the camera parameters with COLMAP instead of reading the "
                                "dataset's ground-truth values.")
        group.add_argument("--estimate_depth", action="store_true",
                           help="Estimate depth maps with the depth network instead of reading the "
                                "dataset's ground-truth depth.")
        group.add_argument("--background_only", action="store_true",
                           help="Reconstruct only the static background and skip the foreground stage.")
        group.add_argument("--static_camera", action="store_true",
                           help="Treat the capture as coming from a fixed (non-moving) camera.")
        group.add_argument("--align_scene", action="store_true",
                           help="Level the scene against the detected ground plane - useful when the "
                                "capture device was tilted up/down and the result sits askew in "
                                "the renderer.")
        group.add_argument("--inpainting_mode", type=int, default=0,
                           choices=InpaintingMode.get_modes_as_integer(),
                           help="Inpainting backend selection (integer code). "
                                + ", ".join(f"{m.to_integer()}={m.name}"
                                            for m in InpaintingMode.get_modes()))
        group.add_argument("--billboard", action="store_true",
                           help="Flatten each foreground object onto a billboard - a workaround for "
                                "estimated depth that stretches people into distorted meshes with "
                                "missing limbs.")
        group.add_argument("--disable_scaling", action="store_true",
                           help="Keep the input sequence at its native resolution instead of "
                                "rescaling it to VGA (640x480).")
        group.add_argument("--disable_coverage_constraint", action="store_true",
                           help="By default foreground objects covering under 1%% of the frame are "
                                "skipped; set this to reconstruct them regardless.")
        group.add_argument("--log_file", type=str, default="logs.log",
                           help="File the run log is written to.")
        group.add_argument("--num_devices", type=int, default=1,
                           help="Number of accelerator devices to run over (TSDF "
                                "integration, depth inference and pose optimisation "
                                "shard over a device mesh). 1 (default) = "
                                "single-device; -1 = all local devices.")

    @staticmethod
    def from_args(args: argparse.Namespace) -> "PipelineOptions":
        return PipelineOptions(num_frames=args.num_frames, frame_step=args.frame_step,
                               estimate_pose=args.estimate_pose, estimate_depth=args.estimate_depth,
                               background_only=args.background_only, static_camera=args.static_camera,
                               align_scene=args.align_scene,
                               inpainting_mode=InpaintingMode.from_integer(args.inpainting_mode),
                               billboard=args.billboard, disable_scaling=args.disable_scaling,
                               disable_coverage_constraint=args.disable_coverage_constraint,
                               log_file=args.log_file, num_devices=args.num_devices)

    def copy(self) -> "PipelineOptions":
        return dataclasses.replace(self)
