"""Batched geometry transforms (quaternion/SE(3) algebra, camera projection)."""

from hive_tpu_torch.core.transforms import (
    quat_normalize,
    quat_conjugate,
    quat_multiply,
    quat_rotate,
    quat_to_matrix,
    matrix_to_quat,
    quat_slerp,
    pose_to_matrix,
    matrix_to_pose,
    pose_inverse,
    pose_compose,
    unproject_depth_map,
    project_points,
    unproject_pixels,
)
