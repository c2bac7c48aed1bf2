"""Host-facing geometry API: camera trajectories, pose algebra and projection.

Capability parity with reference hive/geometric.py (pose_vec2mat:34,
pose_mat2vec:52, get_pose_components:66, add/subtract_pose:81/91,
point_cloud_from_depth:107, world2image:155, image2world:183, Quaternion:209,
Trajectory:302 with its plot, CameraMatrix:652), re-designed so that:

* small host-side helpers stay NumPy (no device dispatch overhead for tiny
  point sets used during meshing);
* batched trajectory algebra is vectorised over all frames at once (the
  reference loops per frame for RPE and interpolation);
* :class:`Quaternion` is torch-backed and shares its math with
  :mod:`hive_tpu_torch.core.transforms`.

Conventions: scalar-last quaternions; pose 7-vector = [qx qy qz qw tx ty tz];
poses are world-to-camera (p_cam = R p_world + t).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from hive_tpu_torch.core import transforms as T
from hive_tpu_torch.custom_types import File, Size
from hive_tpu_torch.utils import validate_camera_parameter_shapes, validate_shape


# ---------------------------------------------------------------------------
# Pose 7-vector helpers (NumPy, host side).
# ---------------------------------------------------------------------------



def pose_vec2mat(pose: np.ndarray) -> np.ndarray:
    """Pose 7-vector [q, t] → 4x4 homogeneous matrix."""
    validate_shape(pose, "pose", expected_shape=(7,))

    q = pose[:4] / np.linalg.norm(pose[:4])
    x, y, z, w = q
    R = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])

    M = np.eye(4)
    M[:3, :3] = R
    M[:3, 3] = pose[4:]
    return M


def pose_mat2vec(pose: np.ndarray) -> np.ndarray:
    """4x4 homogeneous matrix → pose 7-vector [q, t] (scalar-last quat).

    Host-side scipy on purpose: this is a scalar setup helper called from
    conversion/IO loops, where a device op per call would only add latency.
    """
    from scipy.spatial.transform import Rotation

    validate_shape(pose, "pose", expected_shape=(4, 4))

    q = Rotation.from_matrix(np.asarray(pose[:3, :3], dtype=np.float64)).as_quat()
    return np.hstack((q, pose[:3, 3]))


def get_pose_components(pose: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Split a 4x4 pose into its (3, 3) rotation and (3, 1) translation."""
    validate_shape(pose, "pose", (4, 4))
    return pose[:3, :3], pose[:3, 3:]


def get_identity_pose() -> np.ndarray:
    """The identity pose 7-vector."""
    return np.asarray([0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0])


def _mats_to_pose_vectors(mats: np.ndarray) -> np.ndarray:
    """(N, 4, 4) homogeneous matrices → (N, 7) pose vectors (host scipy,
    batched — the per-pose pose_mat2vec in a loop pays scipy setup N times)."""
    from scipy.spatial.transform import Rotation

    q = Rotation.from_matrix(np.asarray(mats[:, :3, :3], dtype=np.float64)).as_quat()
    return np.hstack([q, mats[:, :3, 3]])


def _np_quat_slerp(q0: np.ndarray, q1: np.ndarray, t) -> np.ndarray:
    """Host-numpy spherical interpolation, mirroring
    :func:`hive_tpu_torch.core.transforms.quat_slerp` (short arc, lerp fallback
    when nearly parallel)."""
    q0 = q0 / np.linalg.norm(q0, axis=-1, keepdims=True)
    q1 = q1 / np.linalg.norm(q1, axis=-1, keepdims=True)

    dot = np.sum(q0 * q1, axis=-1, keepdims=True)
    q1 = np.where(dot < 0.0, -q1, q1)
    dot = np.clip(np.abs(dot), -1.0, 1.0)

    theta = np.arccos(dot)
    sin_theta = np.sin(theta)

    near = sin_theta < 1e-6
    safe = np.where(near, 1.0, sin_theta)
    w0 = np.where(near, 1.0 - t, np.sin((1.0 - t) * theta) / safe)
    w1 = np.where(near, t, np.sin(t * theta) / safe)

    out = w0 * q0 + w1 * q1
    return out / np.linalg.norm(out, axis=-1, keepdims=True)


def add_pose(pose_a: np.ndarray, pose_b: np.ndarray) -> np.ndarray:
    """Accumulate two poses (apply ``a`` then ``b``)."""
    return pose_mat2vec(pose_vec2mat(pose_b) @ pose_vec2mat(pose_a))


def subtract_pose(pose_a: np.ndarray, pose_b: np.ndarray) -> np.ndarray:
    """Relative pose ``a - b``."""
    return pose_mat2vec(np.linalg.inv(pose_vec2mat(pose_b)) @ pose_vec2mat(pose_a))


# ---------------------------------------------------------------------------
# Projection / unprojection (NumPy, host side).
# ---------------------------------------------------------------------------

def world2image(points: np.ndarray, K: np.ndarray, R: np.ndarray = np.eye(3),
                t: np.ndarray = np.zeros((3, 1)), scale_factor: float = 1.0,
                dtype=np.int32) -> Tuple[np.ndarray, np.ndarray]:
    """Project (N, 3) world points into image space.

    :return: ((N, 2) pixel coordinates, (N,) depths).
    """
    validate_shape(points, "points", expected_shape=(None, 3))
    validate_camera_parameter_shapes(K, R, t)

    cam = points @ R.T + t.reshape(1, 3)
    uvw = cam @ K.T
    depth = uvw[:, 2]
    pixels = uvw[:, :2] / depth[:, None] / scale_factor

    if np.issubdtype(dtype, np.integer):
        pixels = np.round(pixels)

    return pixels.astype(dtype), depth


def image2world(points: np.ndarray, depth: np.ndarray, K: np.ndarray,
                R: np.ndarray = np.eye(3), t: np.ndarray = np.zeros((3, 1)),
                scale_factor: float = 1.0) -> np.ndarray:
    """Lift (N, 2) pixel coordinates with (N,) depths to (N, 3) world points."""
    validate_shape(points, "points", expected_shape=(None, 2))
    validate_shape(depth, "depth", expected_shape=(points.shape[0],))
    validate_camera_parameter_shapes(K, R, t)

    uv1 = np.concatenate([points * scale_factor, np.ones((len(points), 1))], axis=-1)
    cam = depth[:, None] * (uv1 @ np.linalg.inv(K).T)
    return (cam - t.reshape(1, 3)) @ R


def point_cloud_from_depth(depth: np.ndarray, mask: np.ndarray, K: np.ndarray,
                           R: np.ndarray = np.eye(3),
                           t: np.ndarray = np.zeros((3, 1))) -> np.ndarray:
    """Unproject the masked, valid (depth > 0) pixels of a depth map.

    :return: the (N, 3) world-space point cloud.
    """
    valid = mask & (depth > 0.0)
    v, u = valid.nonzero()
    points2d = np.stack([u, v], axis=-1).astype(np.float64)

    return image2world(points2d, depth[valid], K, R, t)


def point_cloud_from_rgbd(rgb: np.ndarray, depth: np.ndarray, mask: np.ndarray,
                          K: np.ndarray, R: np.ndarray = np.eye(3),
                          t: np.ndarray = np.zeros((3, 1))) -> Tuple[np.ndarray, np.ndarray]:
    """Like :func:`point_cloud_from_depth` but also returns (N, 4) RGBA colours."""
    valid = mask & (depth > 0.0)
    v, u = valid.nonzero()
    points2d = np.stack([u, v], axis=-1).astype(np.float64)

    points = image2world(points2d, depth[valid], K, R, t)
    colour = np.zeros((len(points), 4), dtype=rgb.dtype)
    colour[:, :3] = rgb[valid]
    colour[:, 3] = 255
    return points, colour


# ---------------------------------------------------------------------------
# Quaternion — torch-backed.
# ---------------------------------------------------------------------------

class Quaternion:
    """Batch of quaternions stored as a (4, N) array (rows: x, y, z, w).

    Mirrors the reference's torch Quaternion API (hive/geometric.py:209-299).
    """

    def __init__(self, values):
        values = torch.as_tensor(values)

        if values.ndim != 2 or values.shape[0] != 4:
            raise ValueError(f"Quaternion batches must be (4, N) — rows "
                             f"x, y, z, w; got {values.shape}.")

        self.values = values

    @property
    def x(self):
        return self.values[0]

    @property
    def y(self):
        return self.values[1]

    @property
    def z(self):
        return self.values[2]

    @property
    def w(self):
        return self.values[3]

    def __mul__(self, other: "Quaternion") -> "Quaternion":
        if not isinstance(other, Quaternion):
            raise TypeError(f"{type(self).__name__} * {type(other)} is not defined")
        return Quaternion(T.quat_multiply(self.values.T, other.values.T).T)

    def __rmul__(self, other):
        return self.__mul__(other)

    @staticmethod
    def multiply(q1: "Quaternion", q2: "Quaternion") -> "Quaternion":
        return q1 * q2

    def conjugate(self) -> "Quaternion":
        return Quaternion(T.quat_conjugate(self.values.T).T)

    def inverse(self) -> "Quaternion":
        return self.conjugate()

    def normalise(self) -> "Quaternion":
        return Quaternion(T.quat_normalize(self.values.T).T)

    def apply(self, v) -> torch.Tensor:
        """Rotate (3, N) vectors by this quaternion batch; returns (3, N)."""
        v = torch.as_tensor(v, dtype=self.values.dtype, device=self.values.device)
        if v.ndim != 2 or v.shape[0] != 3:
            raise ValueError(f"vectors must be (3, N); got {tuple(v.shape)}")
        return T.quat_rotate(self.values.T, v.T).T

    def __repr__(self):
        return f"{type(self).__name__}({self.values!r})"


# ---------------------------------------------------------------------------
# Trajectory — a sequence of camera poses.
# ---------------------------------------------------------------------------

class Trajectory:
    """An (N, 7) sequence of camera poses with vectorised algebra.

    Pose layout per row: scalar-last quaternion then XYZ position. All
    operations are batched over frames in one shot (host numpy).
    """

    def __init__(self, values: Optional[np.ndarray] = None):
        if values is not None:
            validate_shape(values, "values", (None, 7))

        self.values = values

    # -- container protocol -------------------------------------------------
    def __len__(self):
        return len(self.values)

    def __getitem__(self, index):
        return self.values[index]

    def __setitem__(self, index, value):
        self.values[index] = value

    def __iter__(self):
        return iter(self.values)

    @property
    def rotations(self) -> np.ndarray:
        return self.values[:, :4]

    @property
    def positions(self) -> np.ndarray:
        return self.values[:, 4:]

    @property
    def shape(self) -> tuple:
        return self.values.shape

    def copy(self) -> "Trajectory":
        return Trajectory(self.values.copy())

    # -- persistence (format-compatible with the reference) -----------------
    def save(self, f: File):
        np.savetxt(f, self.values)

    @classmethod
    def load(cls, f: File) -> "Trajectory":
        values = np.loadtxt(f, dtype=np.float32)

        if values.ndim == 1:
            values = values.reshape((1, -1))

        return Trajectory(values)

    # -- conversions --------------------------------------------------------
    def to_homogenous_transforms(self) -> np.ndarray:
        """(N, 7) → (N, 4, 4), batched. Pure numpy: these conversions run in
        host-side setup paths (dataset loading, voxel sizing)."""
        q = self.values[:, :4]
        q = q / np.linalg.norm(q, axis=-1, keepdims=True)
        x, y, z, w = q[:, 0], q[:, 1], q[:, 2], q[:, 3]

        n = len(self.values)
        m = np.zeros((n, 4, 4), dtype=np.float64)
        m[:, 0, 0] = 1.0 - 2.0 * (y * y + z * z)
        m[:, 0, 1] = 2.0 * (x * y - w * z)
        m[:, 0, 2] = 2.0 * (x * z + w * y)
        m[:, 1, 0] = 2.0 * (x * y + w * z)
        m[:, 1, 1] = 1.0 - 2.0 * (x * x + z * z)
        m[:, 1, 2] = 2.0 * (y * z - w * x)
        m[:, 2, 0] = 2.0 * (x * z - w * y)
        m[:, 2, 1] = 2.0 * (y * z + w * x)
        m[:, 2, 2] = 1.0 - 2.0 * (x * x + y * y)
        m[:, :3, 3] = self.values[:, 4:]
        m[:, 3, 3] = 1.0
        return m

    @staticmethod
    def from_homogenous_transforms(camera_trajectory: np.ndarray) -> "Trajectory":
        """(N, 4, 4) → (N, 7), batched (host numpy — see
        to_homogenous_transforms)."""
        from scipy.spatial.transform import Rotation

        validate_shape(camera_trajectory, "camera_trajectory", (None, 4, 4))
        camera_trajectory = np.asarray(camera_trajectory, dtype=np.float64)
        quats = Rotation.from_matrix(camera_trajectory[:, :3, :3]).as_quat()
        return Trajectory(np.concatenate([quats, camera_trajectory[:, :3, 3]],
                                         axis=-1))

    def array(self, device="cpu") -> torch.Tensor:
        """The trajectory as a float32 tensor on ``device``."""
        return torch.as_tensor(np.asarray(self.values, np.float32), device=device)

    # Compatibility alias with the reference API (`.tensor()` returned torch).
    tensor = array

    # -- algebra ------------------------------------------------------------
    def normalise(self) -> "Trajectory":
        """Re-express the trajectory so the first pose is the identity.

        Host numpy on purpose: dataset set-up calls this, where a device op
        would only add latency (the same rule as pose_mat2vec above).
        """
        m = self.to_homogenous_transforms()
        rebased = np.linalg.inv(m[0]) @ m
        values = _mats_to_pose_vectors(rebased)
        values[0] = get_identity_pose()
        return Trajectory(values)

    def normalise_position(self) -> "Trajectory":
        """Translate the trajectory so the first position is the origin
        (rotation left untouched). Host numpy — see :meth:`normalise`."""
        first = np.array(self.values[0], copy=True)
        first[:4] = [0.0, 0.0, 0.0, 1.0]
        m = self.to_homogenous_transforms()
        rebased = np.linalg.inv(pose_vec2mat(first)) @ m
        return Trajectory(_mats_to_pose_vectors(rebased))

    def inverse(self) -> "Trajectory":
        """Per-pose rigid inverse (world-to-cam ↔ cam-to-world); host numpy
        (see to_homogenous_transforms)."""
        m = self.to_homogenous_transforms()
        r_inv = np.swapaxes(m[:, :3, :3], 1, 2)
        t_inv = -np.einsum("nij,nj->ni", r_inv, m[:, :3, 3])

        q = self.values[:, :4]
        q = q / np.linalg.norm(q, axis=-1, keepdims=True)
        q_inv = np.concatenate([-q[:, :3], q[:, 3:4]], axis=-1)
        return Trajectory(np.concatenate([q_inv, t_inv], axis=-1))

    def apply(self, transform: np.ndarray) -> "Trajectory":
        """Right-multiply every pose by a 4x4 transform (``P_i @ M``)."""
        matrices = self.to_homogenous_transforms() @ transform
        return Trajectory.from_homogenous_transforms(matrices)

    def scale_trajectory(self, scale_factor: float) -> "Trajectory":
        """Scale the translation components."""
        scaled = self.values.copy()
        scaled[:, -3:] *= scale_factor
        return Trajectory(scaled)

    # -- metrics ------------------------------------------------------------
    def calculate_ate(self, other: "Trajectory") -> np.ndarray:
        """Absolute trajectory error (per-frame alignment residual) vs another
        trajectory, with the reference's scalar scale alignment
        (hive/geometric.py:444-461)."""
        if len(self) != len(other):
            raise RuntimeError(
                f"Trajectory lengths differ: {len(self)} vs {len(other)}.")

        a = self.normalise().positions
        b = other.normalise().positions

        scale = np.sum(a * b) / np.sum(np.square(b))
        return b * scale - a

    def calculate_rpe(self, other: "Trajectory") -> Tuple[np.ndarray, np.ndarray]:
        """Relative pose error vs another trajectory.

        :return: (rotational error [rad], translational error [m]) per frame
            pair — vectorised over all N-1 consecutive pairs (the reference
            loops in Python, hive/geometric.py:482-492).
        """
        if len(self) != len(other):
            raise RuntimeError(
                f"Trajectory lengths differ: {len(self)} vs {len(other)}.")

        gt = self.normalise().to_homogenous_transforms()
        pred = other.normalise().to_homogenous_transforms()

        rel_est = np.linalg.inv(pred[:-1]) @ pred[1:]
        rel_gt = np.linalg.inv(gt[:-1]) @ gt[1:]
        rel_err = np.linalg.inv(rel_gt) @ rel_est

        trans_err = np.linalg.norm(rel_err[:, :3, 3], axis=-1)
        traces = np.trace(rel_err[:, :3, :3], axis1=-2, axis2=-1)
        rot_err = np.arccos(np.clip((traces - 1.0) / 2.0, -1.0, 1.0))

        return rot_err, trans_err

    # -- interpolation ------------------------------------------------------
    @staticmethod
    def create_by_interpolating(poses: Dict[int, np.ndarray], frame_count: int) -> "Trajectory":
        """Densify a sparse {frame_index: pose} mapping via slerp + lerp.

        (ref hive/geometric.py:610-648.)
        """
        if 0 not in poses:
            raise RuntimeError(
                "Trajectory interpolation needs a pose at frame 0 to anchor the start.")

        if frame_count - 1 not in poses:
            raise RuntimeError(
                "Trajectory interpolation needs a pose at the final frame to anchor the end.")

        known = np.array(sorted(poses.keys()))
        # For every output frame, its bracketing known frames and blend factor.
        seg = np.searchsorted(known, np.arange(frame_count), side="right") - 1
        seg = np.clip(seg, 0, len(known) - 2)
        lo, hi = known[seg], known[seg + 1]
        alpha = (np.arange(frame_count) - lo) / np.maximum(hi - lo, 1)

        pose_lo = np.stack([poses[i] for i in lo])
        pose_hi = np.stack([poses[i] for i in hi])

        # Host numpy slerp (same math as core.transforms.quat_slerp): this
        # runs inside dataset-loading set-up on a handful of 7-vectors.
        q = _np_quat_slerp(pose_lo[:, :4], pose_hi[:, :4], alpha[:, None])
        t = pose_lo[:, 4:] * (1.0 - alpha[:, None]) + pose_hi[:, 4:] * alpha[:, None]

        values = np.concatenate([q, t], axis=-1)
        # Known frames keep their exact poses.
        for i in known:
            values[i] = poses[i]

        return Trajectory(values)

    # -- plotting -----------------------------------------------------------
    def plot(self, output_path: str):
        """Plot the camera positions on the XY and XZ planes into
        ``output_path``."""
        positions = self.normalise().positions
        self._save_plot(positions, None, output_path)

    def plot_comparison(self, other: "Trajectory", output_path: str):
        """Overlay this trajectory (ground truth) and another (estimate) in
        ``output_path``."""
        if len(self) != len(other):
            raise RuntimeError(
                f"Trajectory lengths differ: {len(self)} vs {len(other)}.")

        self._save_plot(self.normalise().positions, other.normalise().positions, output_path)

    @staticmethod
    def _save_plot(gt: np.ndarray, pred: Optional[np.ndarray], output_path: str):
        from matplotlib import pyplot as plt

        _, (ax1, ax2) = plt.subplots(1, 2, figsize=(12.8, 4.8))
        Trajectory._plot_positions(gt, pred, ax1, "y")
        Trajectory._plot_positions(gt, pred, ax2, "z")
        plt.tight_layout()
        plt.savefig(output_path, dpi=90)
        plt.close()

    @staticmethod
    def _plot_positions(gt: np.ndarray, pred: Optional[np.ndarray], axis, secondary: str):
        idx = {"y": 1, "z": 2}[secondary]
        axis.plot(gt[:, 0], gt[:, idx], "-", color="black",
                  label="ground truth" if pred is not None else None)

        if pred is not None:
            axis.plot(pred[:, 0], pred[:, idx], "-", color="blue", label="estimated")
            axis.legend()

        axis.set_xlabel("x [m]")
        axis.set_ylabel(f"{secondary} [m]")
        axis.set_title(f"Trajectory, X{secondary.upper()} plane")


# ---------------------------------------------------------------------------
# CameraMatrix — pinhole intrinsics.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CameraMatrix:
    """A 3x3 pinhole camera intrinsics matrix. (ref hive/geometric.py:651-737)"""

    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int

    @property
    def fov_y(self) -> float:
        return 2.0 * np.arctan(self.height / (2.0 * self.fy))

    @property
    def aspect_ratio(self) -> float:
        return self.width / self.height

    @property
    def matrix(self) -> np.ndarray:
        return np.array([
            [self.fx, 0.0, self.cx],
            [0.0, self.fy, self.cy],
            [0.0, 0.0, 1.0],
        ])

    def transpose(self) -> "CameraMatrix":
        """Swap x/y components (landscape ↔ portrait)."""
        return CameraMatrix(fx=self.fy, fy=self.fx, cx=self.cy, cy=self.cx,
                            width=self.height, height=self.width)

    def scale(self, target_size: Size) -> "CameraMatrix":
        """Rescale intrinsics for a new (height, width) resolution."""
        target_height, target_width = target_size
        sx = target_width / self.width
        sy = target_height / self.height
        return CameraMatrix(fx=self.fx * sx, fy=self.fy * sy,
                            cx=self.cx * sx, cy=self.cy * sy,
                            width=target_width, height=target_height)

    @classmethod
    def from_matrix(cls, matrix: np.ndarray, size: Size) -> "CameraMatrix":
        validate_shape(matrix, "matrix", (3, 3))
        height, width = size
        return CameraMatrix(fx=matrix[0, 0], fy=matrix[1, 1],
                            cx=matrix[0, 2], cy=matrix[1, 2],
                            width=width, height=height)
