"""Static background reconstruction: TSDF fusion on the card.

Counterpart of ``hive_tpu/fusion.py`` ``adjust_voxel_size`` (:30) and
``tsdf_fusion`` (:91). BundleFusion and multi-device sharding are not part
of this slice.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Tuple

import numpy as np
import torch

from hive_tpu_torch import get_device
from hive_tpu_torch.image_processing import dilate_mask
from hive_tpu_torch.io import HiveDataset
from hive_tpu_torch.meshing.mesh import TriangleMesh
from hive_tpu_torch.options import BackgroundMeshOptions, MaskDilationOptions
from hive_tpu_torch.ops.tsdf import TSDFVolume, estimate_volume_bounds_from_max_depths
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

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

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
            volume.integrate_frames(
                colors=torch.from_numpy(colors).to(device),
                depths=torch.from_numpy(depths).to(device),
                camera_matrix=dataset.camera_matrix,
                cam_to_world_poses=cam_to_world[batch])
        sync()

    logging.info("Extracting mesh...")
    with stage("mesh_extraction"):
        verts, faces, norms, colors = volume.get_mesh()

    return TriangleMesh(vertices=verts, faces=faces, vertex_colors=colors,
                        vertex_normals=norms)
