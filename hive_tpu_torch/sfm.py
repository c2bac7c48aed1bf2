"""Camera poses without COLMAP: depth-assisted PnP visual odometry on the
device.

Counterpart of ``hive_tpu/sfm.py``, which runs it with OpenCV on the host.
For each consecutive pair of frames (i, j): SIFT features
(:mod:`hive_tpu_torch.ops.sift`), exact k-NN matching with Lowe's ratio
(:mod:`hive_tpu_torch.ops.matching`), frame i's matches lifted to 3-D with
its depth map, and RANSAC PnP for frame j's pose relative to frame i
(:mod:`hive_tpu_torch.ops.pnp`). The relative poses chain into a metric
world-to-camera trajectory with frame 0 at the identity. The dataset
adaptors use it for ``--estimate_pose`` when no COLMAP binary is found.
"""

from __future__ import annotations

import logging
from typing import Optional, Sequence

import numpy as np
import torch

from hive_tpu_torch import get_device
from hive_tpu_torch.geometric import Trajectory, pose_mat2vec
from hive_tpu_torch.ops import matching, pnp, sift


RANSAC_SEED = 0


def _as_tensor(array, device) -> torch.Tensor:
    tensor = array if torch.is_tensor(array) else torch.from_numpy(np.ascontiguousarray(array))
    return tensor.to(device)


class PnPOdometry:
    """Frame-to-frame metric odometry from RGB + depth.

    For each consecutive pair (i, j): match SIFT features, lift frame i's
    matches to 3-D with its depth map, and solve RANSAC PnP for frame j's
    pose relative to frame i. Relative poses chain into world-to-camera
    poses with frame 0 as the identity.

    :param device: where features, matches and poses are computed; default
        ``cuda:0``. Each pair's RANSAC samples come from a generator seeded
        with RANSAC_SEED.
    """

    def __init__(self, camera_matrix: np.ndarray, min_matches: int = 20,
                 max_features: int = 2048, ratio_threshold: float = 0.75,
                 pnp_reprojection_error: float = 4.0, device=None):
        self.camera_matrix = np.asarray(camera_matrix, dtype=np.float64)
        self.min_matches = min_matches
        self.max_features = max_features
        self.ratio_threshold = ratio_threshold
        self.pnp_reprojection_error = pnp_reprojection_error
        self.device = get_device(device)
        self._K = torch.from_numpy(self.camera_matrix).to(self.device)

    # -- feature helpers ------------------------------------------------------
    def _detect(self, gray, mask=None) -> sift.SiftFeatures:
        """SIFT on a uint8 grey frame; ``mask`` (nonzero = dynamic object)
        excludes moving things from the features."""
        sift_mask = None
        if mask is not None:
            mask = _as_tensor(mask, self.device)
            sift_mask = torch.where(mask > 0, 0, 255).to(torch.uint8)
        return sift.detect_and_compute(_as_tensor(gray, self.device), sift_mask,
                                       nfeatures=self.max_features)

    def _match(self, desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
        """(M, 2) (query, train) indices passing ``m < ratio * n``."""
        return matching.match_descriptors(desc_a, desc_b, self.ratio_threshold, strict=True)

    def _generator(self) -> torch.Generator:
        generator = torch.Generator(device=self.device)
        generator.manual_seed(RANSAC_SEED)
        return generator

    # -- relative pose --------------------------------------------------------
    def relative_pose(self, gray_i, depth_i, gray_j, mask_i=None, mask_j=None,
                      features_i: Optional[sift.SiftFeatures] = None,
                      features_j: Optional[sift.SiftFeatures] = None) -> Optional[np.ndarray]:
        """World-to-camera transform of frame j in frame i's camera frame.

        :param features_i/features_j: optional precomputed SIFT features of
            the two frames (each frame is detected once by
            :meth:`estimate_trajectory`).
        :return: (4, 4) float64 matrix, or None when the pair cannot be
            solved.
        """
        features_i = features_i if features_i is not None else self._detect(gray_i, mask_i)
        features_j = features_j if features_j is not None else self._detect(gray_j, mask_j)

        matches = self._match(features_i.descriptors, features_j.descriptors)
        if len(matches) < self.min_matches:
            return None

        depth = _as_tensor(depth_i, self.device)
        h, w = depth.shape
        uv_i = features_i.xy[matches[:, 0]]
        uv_j = features_j.xy[matches[:, 1]]
        # Python's round() is half-to-even, and so is torch.round.
        ui, vi = torch.round(uv_i[:, 0]).long(), torch.round(uv_i[:, 1]).long()
        inside = (ui >= 0) & (ui < w) & (vi >= 0) & (vi < h)
        z = depth[vi.clamp(0, h - 1), ui.clamp(0, w - 1)].double()
        keep = inside & (z > 0)
        if int(keep.sum()) < self.min_matches:
            return None

        K = self._K
        u, v, z = uv_i[keep, 0].double(), uv_i[keep, 1].double(), z[keep]
        object_points = torch.stack([(u - K[0, 2]) * z / K[0, 0],
                                     (v - K[1, 2]) * z / K[1, 1], z], dim=1)
        image_points = uv_j[keep].double()

        ok, rvec, tvec, inliers = pnp.solve_pnp_ransac(
            object_points, image_points, K, reprojection_error=self.pnp_reprojection_error,
            generator=self._generator())
        if not ok or len(inliers) < self.min_matches // 2:
            return None

        # Refine on the inliers.
        rvec, tvec = pnp.refine_pose(object_points[inliers], image_points[inliers], K,
                                     rvec, tvec)
        M = np.eye(4)
        M[:3, :3] = pnp.rodrigues_to_matrix(rvec).cpu().numpy()
        M[:3, 3] = tvec.cpu().numpy()
        return M

    # -- trajectory -----------------------------------------------------------
    def estimate_trajectory(self, grays: Sequence, depths: Sequence,
                            masks: Optional[Sequence] = None) -> Trajectory:
        """Chain consecutive relative poses into a world-to-camera
        trajectory.

        Pairs that fail to solve fall back to the previous relative motion
        (constant-velocity assumption), keeping the trajectory complete.
        """
        num_frames = len(grays)
        if masks is None:
            masks = [None] * num_frames

        logging.info("Estimating frame-to-frame poses (PnP odometry)...")
        # One SIFT pass per frame (interior frames are in two pairs).
        features = [self._detect(grays[i], masks[i]) for i in range(num_frames)]
        relative = [self.relative_pose(grays[i], depths[i], grays[i + 1],
                                       features_i=features[i], features_j=features[i + 1])
                    for i in range(num_frames - 1)]

        poses = [np.eye(4)]
        last_motion = np.eye(4)
        failures = 0
        for rel in relative:
            if rel is None:
                rel = last_motion
                failures += 1
            else:
                last_motion = rel
            poses.append(rel @ poses[-1])

        if failures:
            logging.warning(f"PnP odometry failed for {failures}/{num_frames - 1} pairs "
                            f"(used constant-velocity fallback).")

        values = np.stack([pose_mat2vec(p) for p in poses])
        return Trajectory(values)


def estimate_camera_poses_native(rgb_frames: Sequence[np.ndarray],
                                 depth_maps_m: Sequence[np.ndarray],
                                 camera_matrix: np.ndarray,
                                 masks: Optional[Sequence[np.ndarray]] = None,
                                 frame_step: int = 1, device=None) -> Trajectory:
    """Odometry over a frame subset, then slerp re-densification.

    :param rgb_frames: uint8 RGB frames.
    :param depth_maps_m: depth maps in metres (0 = invalid).
    :param camera_matrix: (3, 3) intrinsics.
    :param masks: optional dynamic-object masks (nonzero = dynamic).
    :param frame_step: subsample stride for pose solving; the frames
        between interpolate.
    :param device: where the odometry runs; default ``cuda:0``.
    :return: the (N, 7) world-to-camera trajectory, first frame = identity.
    """
    num_frames = len(rgb_frames)
    if num_frames == 0:
        raise ValueError("estimate_camera_poses_native needs at least one "
                         "frame (got an empty sequence)")
    device = get_device(device)

    subset = list(range(0, num_frames, frame_step))
    if subset[-1] != num_frames - 1:
        subset.append(num_frames - 1)

    def grey(i):
        frame = np.asarray(rgb_frames[i])
        if frame.dtype != np.uint8:
            raise ValueError(f"estimate_camera_poses_native takes uint8 RGB frames; "
                             f"got {frame.dtype}")
        return sift.rgb_to_grey(_as_tensor(frame, device))

    odometry = PnPOdometry(camera_matrix, device=device)
    subset_trajectory = odometry.estimate_trajectory(
        [grey(i) for i in subset],
        [_as_tensor(np.asarray(depth_maps_m[i]), device) for i in subset],
        None if masks is None else [masks[i] for i in subset])

    if frame_step == 1:
        return subset_trajectory

    pose_mapping = {frame: subset_trajectory[k] for k, frame in enumerate(subset)}
    return Trajectory.create_by_interpolating(pose_mapping, frame_count=num_frames)
