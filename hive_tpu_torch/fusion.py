"""Static background reconstruction: TSDF fusion on the card.

Counterpart of ``hive_tpu/fusion.py`` ``adjust_voxel_size`` (:30),
``tsdf_fusion`` (:91), and the code that configures and runs the external
BundleFusion binary (``BundleFusionConfig`` :264, ``get_bundle_fusion_path``
:361, ``bundle_fusion`` :370). Under a runtime mesh (``--num_devices``) the
sparse volume's block rows split over its devices
(:mod:`hive_tpu_torch.parallel.fusion`), with the same mesh as result.
"""

from __future__ import annotations

import logging
import os
import re
import subprocess
from collections import OrderedDict
from os.path import join as pjoin
from typing import List, Optional, Tuple

import numpy as np
import torch

from hive_tpu_torch import get_device
from hive_tpu_torch.image_processing import dilate_mask
from hive_tpu_torch.io import HiveDataset
from hive_tpu_torch.meshing.mesh import TriangleMesh
from hive_tpu_torch.meshing.ply import load_ply
from hive_tpu_torch.options import (BackgroundMeshOptions, MaskDilationOptions,
                                    MeshReconstructionMethod)
from hive_tpu_torch.ops.tsdf import TSDFVolume, estimate_volume_bounds_from_max_depths
from hive_tpu_torch.parallel.fusion import (get_mesh_sharded, integrate_frames_sharded,
                                            shard_sparse_state)
from hive_tpu_torch.parallel.runtime import runtime_mesh
from hive_tpu_torch.utils import timed_block, tqdm_imap


def adjust_voxel_size(dataset: HiveDataset, options: BackgroundMeshOptions,
                      frame_set: List[int]) -> Tuple[float, np.ndarray]:
    """Estimate scene bounds from view frusta and grow the voxel size to keep
    the voxel count under ``options.sdf_max_voxels``."""
    logging.info("Deriving the voxel-volume bounds from the view frusta...")

    # TSDF fusion needs cam-to-world poses; dataset trajectories are world-to-cam.
    cam_to_world = dataset.camera_trajectory.inverse().to_homogenous_transforms()

    # Only each frame's MAX depth reaches the frustum union: one frame at a
    # time keeps this stage O(1 frame) in host memory.
    frame_list = list(frame_set)
    max_depths = np.asarray(tqdm_imap(
        lambda i: float(np.max(dataset.bg_depth_dataset[i])), frame_list,
        show_progress=False), dtype=np.float32)
    poses = cam_to_world[frame_list]

    vol_bnds = estimate_volume_bounds_from_max_depths(
        max_depths, dataset.camera_matrix, poses)

    extent = vol_bnds[:, 1] - vol_bnds[:, 0]
    voxel_count = np.ceil(np.prod(extent / options.sdf_voxel_size))

    # The 12-voxel truncation margin (6 per side, added below) is part of the
    # final volume, so the budget fit solves prod(extent + 12 v) <= budget *
    # v^3 by a few fixed-point rounds.
    if options.sdf_max_voxels and voxel_count > options.sdf_max_voxels:
        voxel_size = float((np.prod(extent) / options.sdf_max_voxels)
                           ** (1.0 / 3.0))
        for _ in range(8):
            padded = extent + 12.0 * voxel_size
            voxel_size = float((np.prod(padded) / options.sdf_max_voxels)
                               ** (1.0 / 3.0))
        logging.info(f"Voxel size grown to {voxel_size:.3f} m: at "
                     f"{options.sdf_voxel_size} m the scene would need {voxel_count:,.0f} "
                     f"voxels, past the {options.sdf_max_voxels:,d} budget.")
    else:
        voxel_size = options.sdf_voxel_size

    # Pad by the truncation margin so surfaces at the frustum's far plane
    # still get voxels behind them.
    margin = 6.0 * voxel_size
    vol_bnds = vol_bnds.copy()
    vol_bnds[:, 0] -= margin
    vol_bnds[:, 1] += margin

    return voxel_size, vol_bnds


def tsdf_fusion(dataset: HiveDataset, options: BackgroundMeshOptions = BackgroundMeshOptions(),
                num_frames: int = -1, frame_set: Optional[List[int]] = None,
                frames_per_batch: int = 32, use_sparse: bool = True,
                profiling: Optional[dict] = None, device=None) -> TriangleMesh:
    """Reconstruct the static background by fusing masked RGB-D frames into a
    TSDF volume and extracting the isosurface.

    :param dataset: An RGB-D dataset with known camera parameters.
    :param options: Voxel volume + mask dilation configuration.
    :param num_frames: Limit on frames used (-1 = all).
    :param frame_set: Explicit frame indices to fuse (overrides num_frames).
    :param frames_per_batch: Frames per ``integrate_frames`` call. Free-space
        weights are applied once per call, so this also fixes the order of
        the fp32 updates (the JAX package's batches).
    :param device: ``"cpu"`` or a CUDA device; default ``cuda:0``.
    :return: The reconstructed vertex-coloured triangle mesh.
    """
    device = get_device(device)
    if num_frames == -1:
        num_frames = dataset.num_frames

    if frame_set is None:
        frame_set = list(range(num_frames))
    else:
        frame_set = list(frame_set)

    mask_dilation_options = MaskDilationOptions(
        num_iterations=options.depth_mask_dilation_iterations)

    def stage(name):
        return timed_block(None, profiling,
                           ["timing", "background_reconstruction", name])

    mesh = runtime_mesh()

    def sync():
        for d in dict.fromkeys([device, *(mesh.devices if mesh is not None else ())]):
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    with stage("voxel_sizing"):
        voxel_size, volume_bounds = adjust_voxel_size(dataset=dataset, options=options,
                                                      frame_set=frame_set)

    logging.info("Allocating the TSDF voxel volume...")

    # Above ~100M voxels the state is stored in bf16 (fp32 accumulate).
    est_dims = np.ceil((volume_bounds[:, 1] - volume_bounds[:, 0]) / voxel_size)
    dtype = torch.bfloat16 if float(np.prod(est_dims)) > 1e8 else torch.float32

    with stage("volume_init"):
        if use_sparse:
            from hive_tpu_torch.ops.tsdf_sparse import SparseTSDFVolume

            volume = SparseTSDFVolume(volume_bounds, voxel_size=voxel_size,
                                      dtype=dtype, device=device)
        else:
            volume = TSDFVolume(volume_bounds, voxel_size=voxel_size,
                                dtype=dtype, device=device)
        sync()

    # Multi-device runtime: split the sparse volume's block rows over the
    # mesh, each device integrating its own slab (bit-identical to one
    # device: blocks are independent, no collectives).
    if mesh is not None and use_sparse:
        if volume.num_blocks % mesh.size == 0:
            shard_sparse_state(volume, mesh)
            logging.info(f"Sparse TSDF volume sharded over {mesh.size} devices "
                         f"({volume.num_blocks} blocks, block-cyclic).")
        else:
            logging.warning(
                f"Cannot shard the TSDF volume: {volume.num_blocks} blocks "
                f"do not divide over {mesh.size} devices; running single-device.")
            mesh = None
    else:
        mesh = None

    logging.info(f"Voxel volume dims {volume.dims} "
                 f"({volume.num_voxels:,d} voxels at {voxel_size:.4f} m, {dtype})")
    if profiling is not None:
        profiling.setdefault("background_volume", {}).update(
            num_voxels=volume.num_voxels, voxel_size=voxel_size,
            dtype=str(dtype).removeprefix("torch."))

    cam_to_world = dataset.camera_trajectory.inverse().to_homogenous_transforms()
    has_inpainted = dataset.has_inpainted_frame_data

    logging.info("Fusing frames...")

    def load_frame(i: int):
        color = dataset.bg_rgb_dataset[i]
        depth = dataset.bg_depth_dataset[i]

        if not has_inpainted:
            # Mask out dynamic objects (dilated) so they leave no floaters
            # in the static mesh.
            mask = dilate_mask(dataset.mask_dataset[i], mask_dilation_options)
            depth = depth.copy()
            depth[mask] = 0.0

        return color[..., :3], depth

    batches = [frame_set[start:start + frames_per_batch]
               for start in range(0, len(frame_set), frames_per_batch)]

    with stage("integration"):
        for batch in batches:
            frames = tqdm_imap(load_frame, batch, show_progress=False)
            colors = np.stack([np.ascontiguousarray(f[0][..., :3], dtype=np.uint8)
                               for f in frames])
            depths = np.stack([f[1] for f in frames]).astype(np.float32, copy=False)
            inputs = dict(colors=torch.from_numpy(colors).to(device),
                          depths=torch.from_numpy(depths).to(device),
                          camera_matrix=dataset.camera_matrix,
                          cam_to_world_poses=cam_to_world[batch])
            if mesh is not None:
                integrate_frames_sharded(volume, mesh, **inputs)
            else:
                volume.integrate_frames(**inputs)
        sync()

    logging.info("Extracting mesh...")
    with stage("mesh_extraction"):
        if mesh is not None:
            # Device-parallel emission over the mesh, byte-identical to
            # get_mesh.
            verts, faces, norms, colors = get_mesh_sharded(volume, mesh)
        else:
            verts, faces, norms, colors = volume.get_mesh()

    return TriangleMesh(vertices=verts, faces=faces, vertex_colors=colors,
                        vertex_normals=norms)


class BundleFusionConfig:
    """Parser/writer for BundleFusion's ``key = value;`` config format.

    File-format compatible with ``hive_tpu.fusion.BundleFusionConfig`` so
    generated configs drive the stock BundleFusion binary.
    """

    _DELIMITER_PATTERN = re.compile(r"[;#]|(//)")

    def __init__(self, **kwargs):
        self.config_dict = OrderedDict(**kwargs)

    def __getitem__(self, key):
        return self.config_dict[key]

    def __setitem__(self, key, value):
        if key in self.config_dict and type(value) is not type(self.config_dict[key]):
            logging.warning(f'Config entry "{key}" changes type: '
                            f"{type(self.config_dict[key]).__name__} -> "
                            f"{type(value).__name__}.")

        self.config_dict[key] = value

    @staticmethod
    def load(f) -> "BundleFusionConfig":
        if isinstance(f, str):
            with open(f) as fp:
                return BundleFusionConfig._parse(fp)

        return BundleFusionConfig._parse(f)

    @staticmethod
    def _convert_value(text: str):
        if text.startswith('"') and text.endswith('"'):
            return text.strip('"')
        if text == "true":
            return True
        if text == "false":
            return False
        if text.endswith("f"):
            return float(text[:-1])
        return int(text)

    @classmethod
    def _parse(cls, fp) -> "BundleFusionConfig":
        config = OrderedDict()

        for line in fp:
            line = line.strip()

            if match := re.search(cls._DELIMITER_PATTERN, line):
                line = line[:match.start()]

            if "=" not in line:
                continue

            name, _, values = line.partition("=")
            name = name.strip()
            values = values.strip()

            if not name or not values:
                continue

            parts = values.split(" ")
            config[name] = ([cls._convert_value(part) for part in parts]
                            if len(parts) > 1 else cls._convert_value(values))

        return BundleFusionConfig(**config)

    @staticmethod
    def _to_string(value) -> str:
        if isinstance(value, list):
            return " ".join(BundleFusionConfig._to_string(item) for item in value)
        if isinstance(value, bool):
            return str(value).lower()
        if isinstance(value, float):
            return f"{value}f"
        if isinstance(value, int):
            return str(value)
        if isinstance(value, str):
            return f'"{value}"'

        raise ValueError(f"The type '{type(value)}' is not supported for serialisation. "
                         f"Supported types are list, float, int, bool and str.")

    def save(self, f):
        if isinstance(f, str):
            with open(f, "w") as fp:
                self._write(fp)
        else:
            self._write(f)

    def _write(self, fp):
        for name, value in self.config_dict.items():
            fp.write(f"{name} = {self._to_string(value)};\n")


def get_bundle_fusion_path() -> str:
    try:
        return os.environ["BUNDLE_FUSION_PATH"]
    except KeyError:
        logging.error("BUNDLE_FUSION_PATH is not set in the environment; point it "
                      "at the folder holding BundleFusion's default config files.")
        raise


def bundle_fusion(output_folder: str, dataset: HiveDataset,
                  options: BackgroundMeshOptions = BackgroundMeshOptions(
                      MeshReconstructionMethod.BundleFusion),
                  num_frames: int = -1) -> TriangleMesh:
    """Run the external BundleFusion binary on a dataset and load its mesh.

    Same contract as ``hive_tpu.fusion.bundle_fusion``: configures
    intrinsics/voxel parameters, runs the binary (``BUNDLE_FUSION_BIN``), loads
    `mesh.ply` and undoes BundleFusion's x-axis reflection. Runs on the host;
    the card does nothing here.
    """
    if num_frames == -1:
        num_frames = dataset.num_frames

    frame_set = list(range(num_frames))
    bundle_fusion_path = get_bundle_fusion_path()

    logging.info("Masking dynamic objects out of the depth maps for BundleFusion...")
    dataset.create_masked_depth(
        MaskDilationOptions(num_iterations=options.depth_mask_dilation_iterations))

    dataset_path = os.path.abspath(dataset.base_path)
    output_path = pjoin(dataset_path, output_folder)
    os.makedirs(output_path, exist_ok=True)

    voxel_size, volume_bounds = adjust_voxel_size(dataset=dataset, options=options,
                                                  frame_set=frame_set)
    max_distance = float(np.ceil(np.max(volume_bounds[:, 1] - volume_bounds[:, 0])))

    logging.info("Writing the BundleFusion config files...")
    config = BundleFusionConfig.load(pjoin(bundle_fusion_path, "zParametersDefault.txt"))
    config["s_SDFMaxIntegrationDistance"] = max_distance
    config["s_SDFVoxelSize"] = float(voxel_size)
    config["s_cameraIntrinsicFx"] = int(dataset.fx)
    config["s_cameraIntrinsicFy"] = int(dataset.fy)
    config["s_cameraIntrinsicCx"] = int(dataset.cx)
    config["s_cameraIntrinsicCy"] = int(dataset.cy)
    config["s_generateMeshDir"] = output_path
    config_output_path = pjoin(output_path, "bundleFusionConfig.txt")
    config.save(config_output_path)

    bundling_config = BundleFusionConfig.load(
        pjoin(bundle_fusion_path, "zParametersBundlingDefault.txt"))
    submap_size = bundling_config["s_submapSize"]
    # `+ submap_size` avoids off-by-one errors in BundleFusion's submap logic.
    bundling_config["s_maxNumImages"] = (num_frames + submap_size) // submap_size
    bundling_config_output_path = pjoin(output_path, "bundleFusionBundlingConfig.txt")
    bundling_config.save(bundling_config_output_path)

    if dataset.has_inpainted_frame_data:
        rgb_folder = dataset.inpainted_rgb_folder
        depth_folder = dataset.inpainted_depth_folder
    else:
        rgb_folder = dataset.rgb_folder
        depth_folder = dataset.masked_depth_folder

    cmd = [os.environ["BUNDLE_FUSION_BIN"], config_output_path, bundling_config_output_path,
           dataset_path, rgb_folder, depth_folder]
    log_path = pjoin(output_path, "log.txt")
    logging.info(f"Launching BundleFusion: {' '.join(cmd)}")

    with subprocess.Popen(cmd, stdout=subprocess.PIPE, bufsize=1,
                          universal_newlines=True) as p, open(log_path, "w") as log_file:
        for line in p.stdout:
            log_file.write(line)

    if p.returncode != 0:
        raise RuntimeError(f"BundleFusion exited with an error; see its log at "
                           f"{os.path.abspath(log_path)}.")

    mesh = load_ply(pjoin(output_path, "mesh.ply"))

    # BundleFusion meshes come out reflected along the x-axis; reflect back.
    mesh.apply_transform(np.diag([-1.0, 1.0, 1.0, 1.0]))

    return mesh
