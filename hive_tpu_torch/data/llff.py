"""LLFF dataset loader (images + poses_bounds.npy) for render-vs-photo
evaluation.

Counterpart of ``hive_tpu/data/llff.py``: LLFF captures hold several posed
photos of a static scene; the pipeline reconstructs from a subset and
renders the held-out views (``meshing/render.py``, on the card) to score
them with SSIM, PSNR, LPIPS and MIFD. Images are read and written with the
port's own codecs (Pillow's pixels and PNG bytes) instead of imageio.

LLFF format: ``images/`` (or ``images_N`` downsampled variants) and
``poses_bounds.npy`` with one row per image: a flattened 3x5 matrix
[R | t | (h, w, f)^T] followed by (near, far) depth bounds. LLFF's camera
axes are [down, right, backwards]; they become the pipeline's [right,
down, forwards] (x right, y down, z forward) world-to-camera poses.
"""

from __future__ import annotations

import os
from os.path import join as pjoin
from typing import List, Optional, Tuple

import numpy as np

from hive_tpu_torch.geometric import Trajectory
from hive_tpu_torch.io import load_image


class LLFFDataset:
    """Loader for an LLFF-format capture."""

    def __init__(self, base_path: str, factor: Optional[int] = None):
        """
        :param base_path: The capture folder (contains poses_bounds.npy).
        :param factor: Optional downsample factor (uses `images_<factor>` if
            present).
        """
        self.base_path = base_path

        poses_bounds = np.load(pjoin(base_path, "poses_bounds.npy"))
        poses = poses_bounds[:, :15].reshape(-1, 3, 5)
        self.bounds = poses_bounds[:, 15:]

        self.hwf = poses[0, :, 4]

        image_folder = "images"
        if factor and os.path.isdir(pjoin(base_path, f"images_{factor}")):
            image_folder = f"images_{factor}"
            self.hwf = self.hwf / factor

        self.image_folder = pjoin(base_path, image_folder)
        self.image_filenames = sorted(
            name for name in os.listdir(self.image_folder)
            if name.lower().endswith((".jpg", ".jpeg", ".png")))

        if len(self.image_filenames) != len(poses):
            raise RuntimeError(f"LLFF pose count ({len(poses)}) does not match image "
                               f"count ({len(self.image_filenames)}).")

        self.cam_to_world = self._convert_poses(poses)

    @staticmethod
    def _convert_poses(poses: np.ndarray) -> np.ndarray:
        """LLFF [down, right, back] camera axes -> [right, down, forward]."""
        converted = np.zeros((len(poses), 4, 4))
        converted[:, 3, 3] = 1.0

        for i, pose in enumerate(poses):
            R = pose[:, :3]
            t = pose[:, 3]

            # Column swap: (down, right, back) -> (right, down, forward).
            R = np.stack([R[:, 1], R[:, 0], -R[:, 2]], axis=-1)

            converted[i, :3, :3] = R
            converted[i, :3, 3] = t

        return converted

    @property
    def num_images(self) -> int:
        return len(self.image_filenames)

    @property
    def camera_matrix(self) -> np.ndarray:
        height, width, focal = self.hwf
        return np.array([[focal, 0.0, width / 2.0],
                         [0.0, focal, height / 2.0],
                         [0.0, 0.0, 1.0]])

    def get_image(self, index: int) -> np.ndarray:
        return load_image(pjoin(self.image_folder, self.image_filenames[index]))

    def get_trajectory(self) -> Trajectory:
        """World-to-camera trajectory over all images."""
        world_to_cam = np.linalg.inv(self.cam_to_world)
        return Trajectory.from_homogenous_transforms(world_to_cam)

    def train_test_split(self, holdout_every: int = 8) -> Tuple[List[int], List[int]]:
        """LLFF convention: every 8th view is held out for evaluation."""
        test = list(range(0, self.num_images, holdout_every))
        train = [i for i in range(self.num_images) if i not in test]
        return train, test


def evaluate_renders(mesh_or_scene, llff: LLFFDataset, view_indices: List[int],
                     output_folder: Optional[str] = None, device=None) -> dict:
    """Render held-out LLFF views of a reconstruction and score them.

    :param device: where the renders, LPIPS and MIFD run; default ``cuda:0``.
    :return: per-view and mean SSIM/PSNR/LPIPS/MIFD.
    """
    from hive_tpu_torch import get_device
    from hive_tpu_torch.geometric import get_pose_components
    from hive_tpu_torch.image_codecs import write_image
    from hive_tpu_torch.meshing.mesh import Scene
    from hive_tpu_torch.meshing.render import render_mesh, render_scene
    from hive_tpu_torch.metrics import lpips, metric_skip_notes, mifd, psnr, ssim

    device = get_device(device)
    if output_folder:
        os.makedirs(output_folder, exist_ok=True)

    world_to_cam = np.linalg.inv(llff.cam_to_world)
    K = llff.camera_matrix
    height, width = int(llff.hwf[0]), int(llff.hwf[1])

    results = {"ssim": [], "psnr": [], "lpips": [], "mifd": []}

    for view in view_indices:
        R, t = get_pose_components(world_to_cam[view])

        render = render_scene if isinstance(mesh_or_scene, Scene) else render_mesh
        rendered, _ = render(mesh_or_scene, K, R, t, width, height, device=device)

        photo = llff.get_image(view)[:height, :width, :3]

        results["ssim"].append(ssim(photo, rendered))
        results["psnr"].append(psnr(photo, rendered))
        results["lpips"].append(lpips(photo, rendered, device=device))
        results["mifd"].append(mifd(photo, rendered, device=device))

        if output_folder:
            write_image(pjoin(output_folder, f"render_{view:03d}.png"), rendered)

    def safe_mean(values):
        finite = [v for v in values if np.isfinite(v)]
        return float(np.mean(finite)) if finite else float("nan")

    skipped = metric_skip_notes(results, device)
    results["mean"] = {metric: safe_mean(values) for metric, values in results.items()}
    if skipped:
        # Artifacts say why a column is empty (e.g. LPIPS without weights).
        results["skipped"] = skipped

    return results
