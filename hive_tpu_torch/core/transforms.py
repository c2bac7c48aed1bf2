"""Batched geometry: quaternions, SE(3) poses and pinhole projection.

Counterpart of ``hive_tpu/core/transforms.py``; every function operates on
batches (leading axes ...) of torch tensors on any device.

Conventions (identical to the reference):
* quaternions are scalar-last ``[x, y, z, w]``;
* a pose 7-vector is ``[qx, qy, qz, qw, tx, ty, tz]``;
* poses are world-to-camera: ``p_cam = R @ p_world + t``;
* projection: ``uvw = K @ (R @ p + t)``; unprojection: ``p = R^T (d K^{-1} u - t)``.

Matmuls run in full fp32: the package turns TF32 off at import
(``hive_tpu_torch/__init__.py``), matching the JAX package's HIGHEST pin.
"""

from __future__ import annotations

import torch


# ---------------------------------------------------------------------------
# Quaternions — shape (..., 4), scalar last.
# ---------------------------------------------------------------------------

def quat_identity(device=None) -> torch.Tensor:
    return torch.tensor([0.0, 0.0, 0.0, 1.0], device=device)


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Normalise to a unit quaternion along the last axis."""
    norm = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return q / torch.clamp(norm, min=eps)


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    """(-x, -y, -z, w): the inverse rotation for unit quaternions."""
    return q * torch.tensor([-1.0, -1.0, -1.0, 1.0], dtype=q.dtype, device=q.device)


def quat_multiply(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product q1 ⊗ q2 (composition: rotate by q2 then q1)."""
    x1, y1, z1, w1 = torch.unbind(q1, dim=-1)
    x2, y2, z2, w2 = torch.unbind(q2, dim=-1)

    return torch.stack([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 + y1 * w2 + z1 * x2 - x1 * z2,
        w1 * z2 + z1 * w2 + x1 * y2 - y1 * x2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ], dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors ``v`` (..., 3) by unit quaternions ``q`` (..., 4), in
    the expanded form ``v + 2 w (u × v) + 2 u × (u × v)``."""
    u = q[..., :3]
    w = q[..., 3:4]
    u, v = torch.broadcast_tensors(u, v)
    uv = torch.linalg.cross(u, v, dim=-1)
    return v + 2.0 * (w * uv + torch.linalg.cross(u, uv, dim=-1))


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (..., 4) → rotation matrix (..., 3, 3)."""
    x, y, z, w = torch.unbind(q, dim=-1)

    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z

    m = torch.stack([
        1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy),
        2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx),
        2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy),
    ], dim=-1)

    return m.reshape(*q.shape[:-1], 3, 3)


def matrix_to_quat(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) → unit quaternion (..., 4), scalar last.

    Branchless Shepperd's method: the four candidate quaternions are computed
    and the numerically stable one is selected per batch element.
    """
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]

    qw2 = 1.0 + m00 + m11 + m22
    qx2 = 1.0 + m00 - m11 - m22
    qy2 = 1.0 - m00 + m11 - m22
    qz2 = 1.0 - m00 - m11 + m22

    cand_w = torch.stack([m21 - m12, m02 - m20, m10 - m01, qw2], dim=-1)
    cand_x = torch.stack([qx2, m10 + m01, m02 + m20, m21 - m12], dim=-1)
    cand_y = torch.stack([m10 + m01, qy2, m21 + m12, m02 - m20], dim=-1)
    cand_z = torch.stack([m02 + m20, m21 + m12, qz2, m10 - m01], dim=-1)

    four_sq = torch.stack([qx2, qy2, qz2, qw2], dim=-1)
    best = torch.argmax(four_sq, dim=-1)

    cands = torch.stack([cand_x, cand_y, cand_z, cand_w], dim=-2)  # (..., 4, 4)
    index = best[..., None, None].expand(*best.shape, 1, 4)
    q = torch.gather(cands, -2, index)[..., 0, :]

    q = quat_normalize(q)
    # Canonicalise sign (w >= 0) so round-trips are deterministic.
    return q * torch.where(q[..., 3:4] < 0.0, -1.0, 1.0)


def quat_slerp(q0: torch.Tensor, q1: torch.Tensor, t) -> torch.Tensor:
    """Spherical interpolation between unit quaternions, batched over ``t``;
    falls back to lerp when the quaternions are nearly parallel."""
    t = torch.as_tensor(t, dtype=q0.dtype, device=q0.device)
    dot = torch.sum(q0 * q1, dim=-1, keepdim=True)
    q1 = torch.where(dot < 0.0, -q1, q1)  # take the short arc
    dot = torch.clamp(torch.abs(dot), -1.0, 1.0)

    theta = torch.arccos(dot)
    sin_theta = torch.sin(theta)

    near = sin_theta < 1e-6
    safe = torch.where(near, torch.ones_like(sin_theta), sin_theta)
    w0 = torch.where(near, 1.0 - t, torch.sin((1.0 - t) * theta) / safe)
    w1 = torch.where(near, t, torch.sin(t * theta) / safe)

    return quat_normalize(w0 * q0 + w1 * q1)


# ---------------------------------------------------------------------------
# SE(3) poses — 7-vectors (..., 7) or homogeneous matrices (..., 4, 4).
# ---------------------------------------------------------------------------

def pose_to_matrix(pose: torch.Tensor) -> torch.Tensor:
    """Pose 7-vector (..., 7) → homogeneous matrix (..., 4, 4)."""
    R = quat_to_matrix(quat_normalize(pose[..., :4]))
    t = pose[..., 4:]

    top = torch.cat([R, t[..., :, None]], dim=-1)                   # (..., 3, 4)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=pose.dtype,
                          device=pose.device).expand(*pose.shape[:-1], 1, 4)

    return torch.cat([top, bottom], dim=-2)


def matrix_to_pose(m: torch.Tensor) -> torch.Tensor:
    """Homogeneous matrix (..., 4, 4) → pose 7-vector (..., 7)."""
    q = matrix_to_quat(m[..., :3, :3])
    t = m[..., :3, 3]
    return torch.cat([q, t], dim=-1)


def pose_inverse(pose: torch.Tensor) -> torch.Tensor:
    """Inverse of a rigid pose: (q, t) → (q*, -q* t)."""
    q_inv = quat_conjugate(quat_normalize(pose[..., :4]))
    t_inv = -quat_rotate(q_inv, pose[..., 4:])
    return torch.cat([q_inv, t_inv], dim=-1)


def pose_compose(pose_a: torch.Tensor, pose_b: torch.Tensor) -> torch.Tensor:
    """Compose rigid poses: the result applies ``b`` first, then ``a``
    (matrix form ``A @ B``)."""
    qa, ta = quat_normalize(pose_a[..., :4]), pose_a[..., 4:]
    qb, tb = quat_normalize(pose_b[..., :4]), pose_b[..., 4:]

    q = quat_multiply(qa, qb)
    t = quat_rotate(qa, tb) + ta
    return torch.cat([q, t], dim=-1)


def pose_relative(pose_a: torch.Tensor, pose_b: torch.Tensor) -> torch.Tensor:
    """Relative pose ``b^{-1} @ a``."""
    return pose_compose(pose_inverse(pose_b), pose_a)


# ---------------------------------------------------------------------------
# Pinhole camera projection.
# ---------------------------------------------------------------------------

def project_points(points: torch.Tensor, K: torch.Tensor, R: torch.Tensor,
                   t: torch.Tensor, scale_factor: float = 1.0):
    """World points (..., 3) → pixel coordinates (..., 2) and depths (...,)."""
    cam = points @ R.T + t.reshape(3)
    uvw = cam @ K.T
    depth = uvw[..., 2]
    uv = uvw[..., :2] / (depth[..., None] * scale_factor)
    return uv, depth


def unproject_pixels(points2d: torch.Tensor, depth: torch.Tensor, K: torch.Tensor,
                     R: torch.Tensor, t: torch.Tensor,
                     scale_factor: float = 1.0) -> torch.Tensor:
    """Pixel coordinates (..., 2) + depths (...,) → world points (..., 3)."""
    ones = torch.ones_like(depth)
    uv1 = torch.stack([points2d[..., 0] * scale_factor,
                       points2d[..., 1] * scale_factor, ones], dim=-1)
    K_inv = torch.linalg.inv(K)
    cam = depth[..., None] * (uv1 @ K_inv.T)
    return (cam - t.reshape(3)) @ R  # (R^T)^T = R on the right


def unproject_depth_map(depth: torch.Tensor, K: torch.Tensor, R: torch.Tensor,
                        t: torch.Tensor, *, height: int, width: int) -> torch.Tensor:
    """Dense unprojection of an (H, W) depth map → (H, W, 3) world points."""
    vs, us = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=depth.device),
        torch.arange(width, dtype=torch.float32, device=depth.device),
        indexing="ij")
    uv = torch.stack([us, vs], dim=-1)
    return unproject_pixels(uv, depth, K, R, t)


def view_frustum_points(depth: torch.Tensor, K: torch.Tensor,
                        cam_to_world: torch.Tensor) -> torch.Tensor:
    """The 5 world-space corner points of a camera's view frustum: the camera
    origin and the 4 far-plane corners at the depth map's max depth."""
    h, w = depth.shape
    max_depth = torch.max(depth)

    uv1 = torch.tensor([[0.0, 0.0, 1.0], [w, 0.0, 1.0], [w, h, 1.0],
                        [0.0, h, 1.0]], dtype=K.dtype, device=K.device)
    rays = uv1 @ torch.linalg.inv(K).T
    far = rays * max_depth

    pts_cam = torch.cat([torch.zeros((1, 3), dtype=K.dtype, device=K.device), far])
    return pts_cam @ cam_to_world[:3, :3].T + cam_to_world[:3, 3]
